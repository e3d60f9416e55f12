#!/usr/bin/env python3
"""Where the lane kernels' time goes: builds source variants of K3's and
K4's lane kernels from a checkout and times each at the runtime's bucket
shapes (pigs 8 x 1,024, 1 x 1,024, hailfinder 2 x 1,024; Penguin and Art
2 x 1,024), the device time a launch (torch.profiler, the mean of the
recorded launches), twice in turns.

    python3 tools/lane_variants.py <tree>

Variants, each a text substitution in a copy of the tree's
`src/repro_torch/kernels/csrc/` (the checkout itself is not touched):

  * `base`: the sources as they are;
  * `nowalk`: each row's or site's KY walk (and so its threefry calls)
    replaced by the argmax of its weights: the gather or energies, the
    weights and the stores alone, so base - nowalk is the draw's share;
  * `planewalk`: the lane entries' draw walks with `aia::plane_walk`, the
    general walk K1 takes, in place of `exact_walk`.

and, on the `base` build, the launch shapes the wrappers choose against
the others they could take (`LAYOUTS`: chains a block, warps a block and
the arena's staging for K3; chains and rows a block for K4).  The labels
of `nowalk` are not the sampler's; only the times mean anything.  Prints
one JSON line per variant (or layout), case and turn.  Needs a CUDA
device and nvcc.
"""

import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

VARIANTS = {
    "base": {},
    "nowalk": {
        "bn_gibbs.cu": [(
            "  return aia::plane_draw<CAP>(w, n, a.precision, a.total_steps, "
            "words);",
            "  return aia::argmax_fallback<CAP>(w, n);")],
        "mrf_gibbs.cu": [(
            "  return aia::plane_draw<CAP>(w, n, a.precision, a.total_steps, "
            "words);",
            "  return aia::argmax_fallback<CAP>(w, n);")],
    },
    "planewalk": {
        "aia_common.cuh": [(
            "  bool done;\n  int label = exact_walk<NW, pow2_width(CAP < 32 ? "
            "CAP : 32)>(\n      column, pr.rej, words, precision, total_steps,"
            " done);",
            "  bool done;\n  int bits, rejs;\n  int label = plane_walk<NW, "
            "pow2_width(CAP < 32 ? CAP : 32)>(\n      column, pr.rej, words, "
            "precision, total_steps, bits, rejs, done);")],
    },
}

# launch shapes: module constants of the tree's wrappers, by kernel
LAYOUTS = {
    "k3_lanes": [
        {"_LANE_CHAINS": (32, 16, 8, 4), "_LANE_WARPS": 16,
         "_LANE_STAGE": 100 * 1024},
        {"_LANE_CHAINS": (16, 8, 4)}, {"_LANE_CHAINS": (8, 4)},
        {"_LANE_WARPS": 8}, {"_LANE_STAGE": 0}],
    "k4_lanes": [
        {"_LANE_CHAINS": (2, 1), "_LANE_ROWS": 16},
        {"_LANE_CHAINS": (8, 4, 2, 1)}, {"_LANE_ROWS": 32},
        {"_LANE_CHAINS": (8, 4, 2, 1), "_LANE_ROWS": 32}],
}


def build(tree: Path, lib_mod) -> dict:
    """Each variant's copy of the sources under the tree's build/, both
    libraries built by nvcc in parallel with the port's flags."""
    csrc = tree / "src/repro_torch/kernels/csrc"
    procs, dirs = {}, {}
    for name, patches in VARIANTS.items():
        d = tree / "build" / "lane_variants" / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in csrc.iterdir():
            text = f.read_text()
            for old, new in patches.get(f.name, []):
                if old not in text:
                    raise SystemExit(f"{name}: {f.name} lacks the text to "
                                     "substitute")
                text = text.replace(old, new)
            (d / f.name).write_text(text)
        dirs[name] = d
        for lib in ("bn_gibbs", "mrf_gibbs"):
            cmd = [lib_mod.nvcc(), *lib_mod.NVCC_FLAGS, "-o",
                   str(d / f"lib{lib}.so"), str(d / f"{lib}.cu")]
            procs[(name, lib)] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    for (name, lib), proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} {lib}: nvcc failed\n{out[-4000:]}")
    return dirs


def main(tree_arg: str) -> int:
    tree = Path(tree_arg).resolve()
    sys.path.insert(0, str(tree / "src"))
    import torch

    mod_spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(cs)
    from repro_torch import prng
    from repro_torch.core import bayesnet as bnet
    from repro_torch.core import mrf as mrf_mod
    from repro_torch.core.graphs import bn_repository_replica
    from repro_torch.kernels import _lib, bn_gibbs, mrf_gibbs

    if not torch.cuda.is_available():
        raise SystemExit("lane_variants: no CUDA device")
    dirs = build(tree, _lib)
    dev = torch.device("cuda")
    tab, spec = cs.exp_lut(dev)
    cases = []
    for name, q in (("pigs", 8), ("pigs", 1), ("hailfinder", 2)):
        cbn = bnet.compile_bayesnet(bn_repository_replica(name), device=dev)
        fr = bn_gibbs.build_fused_rounds(cbn.groups)
        vals = torch.cat([bnet.init_chain_values(cbn, prng.key(20 + i),
                                                 1024)[0] for i in range(q)])
        kt = prng.key_tensor([prng.key(30 + i) for i in range(q)], dev)
        p = bn_gibbs.sweep_params(cbn, "lut_ky")
        cases.append((f"k3_lanes {name} {q}x1024",
                      lambda c=cbn, f=fr, v=vals, k=kt, p=p:
                      bn_gibbs.bn_sweep_lanes(c, f, v, k, "lut_ky", p)))
    for name in ("penguin", "art"):
        mrf, _, _ = cs._mrf_model(torch, name)
        hh, ww, v = mrf.height, mrf.width, mrf.n_labels
        evs = torch.stack([torch.as_tensor(mrf_mod.make_denoising_problem(
            hh, ww, v, 0.25, seed=s)[1]) for s in range(2)]).to(dev)
        labels = prng.randint(prng.key(1), (2 * 1024, hh, ww), 0, v, dev)
        p = mrf_gibbs.half_step_params(mrf)
        kt = prng.key_tensor([prng.key(40 + i) for i in range(2)], dev)
        cases.append((f"k4_lanes {name} 2x1024",
                      lambda m=mrf, lab=labels, e=evs, k=kt, p=p:
                      mrf_gibbs.mrf_half_step_lanes(m, lab, e, k, 0, tab,
                                                    spec, p)))
    card = cs.nvidia_smi()

    def load(d):
        _lib._LOADED.clear()
        for lib in ("bn_gibbs", "mrf_gibbs"):
            handle = ctypes.CDLL(str(d / f"lib{lib}.so"))
            handle.aia_error_string.argtypes = [ctypes.c_int]
            handle.aia_error_string.restype = ctypes.c_char_p
            _lib._LOADED[lib] = handle

    def emit(turn, variant, label, fn):
        kernel = "bn_lanes_kernel" if label.startswith("k3") else \
            "mrf_lanes_kernel"
        print(json.dumps({
            "tree": tree_arg, "card": card, "turn": turn,
            "variant": variant, "case": label,
            "device_ms": cs.device_ms(torch, fn, 50, kernel)}), flush=True)

    modules = {"k3_lanes": bn_gibbs, "k4_lanes": mrf_gibbs}
    for turn in range(2):
        for name, d in dirs.items():
            load(d)
            for label, fn in cases:
                emit(turn, name, label, fn)
        load(dirs["base"])
        for kernel, layouts in LAYOUTS.items():
            mod = modules[kernel]
            default = {k: getattr(mod, k) for k in layouts[0]}
            for layout in layouts:
                for k, v in {**default, **layout}.items():
                    setattr(mod, k, v)
                for label, fn in cases:
                    if label.startswith(kernel):
                        emit(turn, json.dumps(layout), label, fn)
            for k, v in default.items():
                setattr(mod, k, v)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
