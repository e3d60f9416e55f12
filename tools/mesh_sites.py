#!/usr/bin/env python3
"""One rank's collective result bytes over the model axis in a dry-run
cell (`launch/dryrun.py`: a rank of the shape-only (16, 16) mesh on meta
tensors, computed on the CPU), by where they are issued: the last two
model functions on the stack and the collectives' own lines.  The cell's
sequence length may be cut: the activations' bytes grow with it alike,
so their shares hold for the whole cell.  Run it on a checkout, with
the arch, the cell and the sequence length:

    python tools/mesh_sites.py . xlstm-350m train_4k 256
"""

import collections
import math
import sys
import tempfile
import traceback


def main(argv) -> None:
    root, arch, cell, seq = argv[0], argv[1], argv[2], int(argv[3])
    sys.path.insert(0, root + "/src")
    from repro_torch.launch import collectives, dryrun, steps

    steps.SHAPE_CELLS[cell] = dict(steps.SHAPE_CELLS[cell], seq=seq)
    sites = collections.Counter()
    record = collectives.Comm._record

    def counted(self, op, shape, dtype, axes):
        if "model" in axes:
            stack = traceback.extract_stack()[:-1]
            site = [f.name for f in stack if "/models/" in f.filename][-2:]
            site += [f"collectives:{f.lineno} {f.name}" for f in stack
                     if f.filename.endswith("collectives.py")][-2:]
            sites[(op, " < ".join(reversed(site)))] += (
                math.prod(shape) * dtype.itemsize)
        return record(self, op, shape, dtype, axes)

    collectives.Comm._record = counted
    with tempfile.TemporaryDirectory() as out:
        dryrun.run_cell(arch, cell, "single", out, "sites")
    total = sum(sites.values())
    print(f"{arch} {cell} at seq {seq}: {total:,} bytes over the model "
          f"axis")
    for (op, site), b in sites.most_common():
        print(f"  {b / total:6.3f} {b:>14,} {op}: {site}")


if __name__ == "__main__":
    main(sys.argv[1:])
