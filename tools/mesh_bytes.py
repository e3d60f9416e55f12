#!/usr/bin/env python3
"""A decode step's collective result bytes for one rank of a shape-only
(2, 4) mesh, by op and axis, for chip_smoke's serve_lm_mesh models at
full width with their depth cut (computed on the CPU on meta tensors,
through the dry run's `cell_inputs` and the collectives' dry mode; no
card, no process group).  Run it on a checkout, with the cache length
(prompt plus tokens):

    python tools/mesh_bytes.py . 132
"""

import dataclasses
import sys

MODELS = (("yi-9b", 2), ("qwen2-moe-a2.7b", 1), ("xlstm-350m", 4),
          ("jamba-1.5-large-398b", 1))


def main(argv) -> None:
    root, seq = argv[0], int(argv[1])
    sys.path.insert(0, root + "/src")
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, mesh as mesh_mod

    for arch, layers in MODELS:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        mesh = mesh_mod.AbstractMesh((2, 4), ("data", "model"))
        fn, args, _, _ = dryrun.cell_inputs(cfg, "decode", seq, 8, mesh)
        fn.comm.axis_bytes.clear()
        with dryrun.shape_only_paths():
            fn(*args)
        ab = dict(fn.comm.axis_bytes)
        print(arch, f"{sum(ab.values()) / 1e6:.3f} MB:",
              {k: round(v / 1e6, 3) for k, v in sorted(ab.items())})


if __name__ == "__main__":
    main(sys.argv[1:])
