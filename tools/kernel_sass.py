#!/usr/bin/env python3
"""What the compiler made of K3-K6 in a checkout: for every instance of
the BN and MRF kernel templates, ptxas' registers, stack and spill bytes
(`nvcc -Xptxas -v`, the build's log), and from `cuobjdump -sass` its
instruction count and its loops (instructions, global and shared loads
and stores, bit operations); then, for each launch at the main paths'
shapes, the instance it runs, its threads, shared memory and blocks, and
the blocks and warps an SM holds at once (occupancy from registers,
threads and shared memory, H100 limits).

    python3 tools/kernel_sass.py <tree> [--sass-out DIR]

`<tree>` is a checkout (the repository root, or a `git archive` of a
commit unpacked into a directory that `.gitignore` lists); its own
sources are built into its own `build/`, and its own launch rules give
the launches.  Prints one JSON line per instance and per launch, tagged
with the tree.  `--sass-out` writes each library's whole SASS listing
there.  Needs nvcc (not a card).
"""

import importlib.util
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# H100 SXM per SM: threads, blocks, 32-bit registers (allocated 256 a
# warp), shared memory (233,472 bytes, 1 KB of it reserved per block)
SM_THREADS, SM_BLOCKS, SM_REGS, REG_UNIT = 2048, 32, 65536, 256
SM_SMEM, BLOCK_RESERVED = 233472, 1024
LUT = 16
CHAINS = 1024


def _chip_smoke():
    """This repository's chip_smoke (its ptxas and instance-name parsers),
    whatever the tree."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def occupancy(regs: int, threads: int, smem: int) -> dict:
    """Blocks and warps an SM holds at once for a launch of `threads`
    threads and `smem` dynamic shared-memory bytes a block, and what
    limits it."""
    warps = math.ceil(threads / 32)
    per_warp = math.ceil(regs * 32 / REG_UNIT) * REG_UNIT
    limits = {
        "blocks": SM_BLOCKS,
        "threads": SM_THREADS // (warps * 32),
        "registers": (SM_REGS // per_warp) // warps,
        "shared_memory": SM_SMEM // (smem + BLOCK_RESERVED),
    }
    blocks = min(limits.values())
    return {"blocks_per_sm": blocks, "warps_per_sm": blocks * warps,
            "limited_by": min(limits, key=limits.get)}


def sass_functions(sass: str) -> dict:
    """Mangled function name -> its instructions as (address, opcode,
    operands)."""
    funcs, cur = {}, None
    instr = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)([^;]*);")
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = instr.search(ln) if cur is not None else None
        if m:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def counts(body) -> dict:
    ops = [op.split(".")[0] for _, op, _ in body]
    return {
        "instructions": len(ops),
        "ldg": sum(o == "LDG" for o in ops),
        "lds": sum(o == "LDS" for o in ops),
        "sts": sum(o == "STS" for o in ops),
        "stg": sum(o == "STG" for o in ops),
        "ld_generic": sum(o == "LD" for o in ops),
        "local": sum(o in ("LDL", "STL") for o in ops),
        "bit_ops": sum(o in ("LOP3", "SHF", "PRMT") for o in ops),
        "branches": sum(o == "BRA" for o in ops),
    }


def loops(body) -> list:
    """Each backward branch's span (its target up to the branch), with
    the counts of its instructions, innermost (shortest) first."""
    out = []
    for addr, op, args in body:
        t = re.search(r"(0x[0-9a-f]+)", args)
        if not op.startswith("BRA") or not t:
            continue
        start = int(t.group(1), 16)
        if start > addr:
            continue
        span = [x for x in body if start <= x[0] <= addr]
        out.append({"from": start, "to": addr, **counts(span)})
    return sorted(out, key=lambda lp: lp["instructions"])


def launches():
    """The main paths' launches by the checkout's own rules: (label,
    instance, threads, dynamic shared bytes, blocks).  A checkout with
    lane kernels (`lanes_launch`) runs K3 and K4 in them and K5/K6 in
    `bn_rounds_kernel<VCAP>`/`mrf_half_step_kernel<VCAP>`; an older one
    ran every mode in those two templates, the mode their last argument."""
    from repro_torch.core import bayesnet as bnet
    from repro_torch.core.graphs import GridMRF, bn_repository_replica
    from repro_torch.kernels import bn_gibbs, mrf_gibbs

    lanes = hasattr(bn_gibbs, "lanes_launch")
    out = []
    for name, q in (("pigs", 8), ("pigs", 1), ("hailfinder", 2)):
        cbn = bnet.compile_bayesnet(bn_repository_replica(name),
                                    device="cpu")
        fr = bn_gibbs.build_fused_rounds(cbn.groups)
        n = cbn.n_nodes
        vcap = next(c for c in (4, 8, 16, 32, 128) if cbn.max_card + 1 <= c)
        label = f"k3_lanes {name} {q}x{CHAINS}"
        if lanes:
            ln = bn_gibbs.lanes_launch(cbn, fr, q, CHAINS)
            out.append((label, ln["kernel"], ln["threads"], ln["smem"],
                        ln["blocks"]))
        else:
            cpc = min(bn_gibbs.chains_per_block(q * CHAINS, n, LUT), CHAINS)
            out.append((label, f"bn_rounds_kernel<{vcap}, 2>", 256,
                        4 * (cpc * n + LUT), q * -(-CHAINS // cpc)))
        if q != 1:
            continue
        if not lanes:
            cpc = bn_gibbs.chains_per_block(CHAINS, n, LUT)
            out.append((f"k3 {name} {CHAINS}",
                        f"bn_rounds_kernel<{vcap}, 0>", 256,
                        4 * (cpc * n + LUT), -(-CHAINS // cpc)))
        # a (2 chain x 4 node positions) mesh: 512 chains a chain position
        cpc = bn_gibbs.chains_per_block(4 * CHAINS, n, LUT)
        k5 = f"bn_rounds_kernel<{vcap}>" if lanes else \
            f"bn_rounds_kernel<{vcap}, 1>"
        out.append((f"k5 {name} (2, 4) mesh, a round", k5, 256,
                    4 * (cpc * n + LUT), 8 * -(-(CHAINS // 2) // cpc)))
    for name, (h, w, v) in (("penguin", (64, 64, 4)), ("art", (48, 48, 8))):
        grid = GridMRF(h, w, v, theta=1.2, h=2.0)
        vcap = next(c for c in (4, 8, 16, 32, 128) if v + 1 <= c)
        rows = mrf_gibbs.tile_rows(w, LUT)
        for q in (2, 1):
            label = (f"k4_lanes {name} 2x{CHAINS}" if q == 2 else
                     f"k4 {name} {CHAINS}")
            if lanes:
                ln = mrf_gibbs.lanes_launch(grid, q, CHAINS)
                out.append((label, ln["kernel"], ln["threads"], ln["smem"],
                            ln["blocks"]))
            else:
                mode = 2 if q == 2 else 0
                out.append((label, f"mrf_half_step_kernel<{vcap}, {mode}>",
                            256, 4 * ((2 * rows + 2) * w + LUT),
                            q * CHAINS * -(-h // rows)))
        r6 = min(rows, h // 4)
        k6 = f"mrf_half_step_kernel<{vcap}>" if lanes else \
            f"mrf_half_step_kernel<{vcap}, 1>"
        out.append((f"k6 {name} (2, 4) mesh", k6, 256,
                    4 * ((2 * r6 + 2) * w + LUT),
                    CHAINS * 4 * -(-(h // 4) // r6)))
    return out


def main(argv) -> int:
    tree = argv[0]
    sass_out = None
    if "--sass-out" in argv:
        sass_out = Path(argv[argv.index("--sass-out") + 1])
        sass_out.mkdir(parents=True, exist_ok=True)
    cs = _chip_smoke()
    sys.path.insert(0, tree + "/src")
    from repro_torch.kernels import _lib

    _lib.build(("bn_gibbs", "mrf_gibbs"))
    bin_dir = Path(_lib.nvcc()).parent
    registers = {}
    for lib in ("bn_gibbs", "mrf_gibbs"):
        ptx = {e["function"]: e for e in cs.template_instances(
            (_lib.BUILD_DIR / f"{lib}.log").read_text())}
        sass = subprocess.run(
            [str(bin_dir / "cuobjdump"), "-sass",
             str(_lib.library_path(lib))],
            capture_output=True, text=True, timeout=300, check=True).stdout
        if sass_out is not None:
            (sass_out / f"{lib}.sass").write_text(sass)
        for mangled, body in sass_functions(sass).items():
            name = cs.instance_name(mangled)
            if name is None:
                continue
            row = {"tree": tree, "library": lib, **ptx.get(name, {}),
                   "function": name, **counts(body), "loops": loops(body)}
            registers[name] = row.get("registers")
            print(json.dumps(row), flush=True)
    for label, kernel, threads, smem, blocks in launches():
        regs = registers.get(kernel)
        print(json.dumps({
            "tree": tree, "launch": label, "instance": kernel,
            "threads": threads, "smem_bytes": smem, "blocks": blocks,
            "registers": regs,
            **(occupancy(regs, threads, smem) if regs else {}),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
