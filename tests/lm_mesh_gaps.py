#!/usr/bin/env python3
"""A reduced model's (2, 4) meshed train step against the bound of
`tests/test_torch_lm_mesh.py` (`one_process_bound`): each gradient's
and updated leaf's gap from the port's one-process step as a share of
its bound (above 1: past it), the largest of each first.  For every
updated leaf past its bound it then reads the elements past the bound:
how many there are, how many of them had gradients of opposite signs in
the meshed and the one-process step, and, at the largest gap, the
gradient on the four sides (the port's mesh and one process, the
reference's (2, 4) step and its unsharded one) over the leaf's gradient
scale, AdamW's first-step factor there on each side (|g'| / (|g'| +
eps) of the clipped gradient g': the update is lr times it, so it moves
with g where |g'| is near eps), and the reference's own gap there.

It runs the reference's steps in a subprocess (`run_reference`), the
port's one process here and its 8 gloo ranks as (2, 4), on the weights
of `jax.random.PRNGKey(seed)` (the tests use 1).  On the CPU, from the
repository root:

    JAX_PLATFORMS=cpu python tests/lm_mesh_gaps.py jamba-1.5-large-398b
    JAX_PLATFORMS=cpu python tests/lm_mesh_gaps.py jamba-1.5-large-398b \
        --seed 2

With `--float64` it runs only the port's meshed step against its one
process, both in float64 (`_float64`), and prints the largest gaps over
each quantity's scale: where the meshed step computes what one process
computes, they are float64 rounding (yi-9b, qwen2-moe and jamba: the
xLSTM's float32 states do not run in float64).
"""

import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_lm_mesh as lm_mesh  # noqa: E402
import torch_rank_cases as cases  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402


_OPT_CFG = cases.lm_opt_cfg
_FLOAT = torch.Tensor.float


def _float64(cfg):
    """cfg in float64, with AdamW's moments and the model code's
    `.float()` reads (float32 for 16-bit activations) kept in float64: a
    meshed step then differs from one process by float64 rounding
    alone."""
    torch.Tensor.float = lambda t, *a, **k: (
        t if t.dtype == torch.float64 else _FLOAT(t, *a, **k))
    cases.lm_opt_cfg = lambda: dataclasses.replace(_OPT_CFG(),
                                                   moment_dtype="float64")
    return dataclasses.replace(cfg, dtype="float64", param_dtype="float64")


def train(rank, mesh, arch, tree, wide=False):
    cfg = cases.lm_cfg(arch)
    cfg = _float64(cfg) if wide else cfg
    model = convert.lm_params_from_reference(tree, cfg, "cpu", train=True)
    return cases.lm_train(cfg, model.double() if wide else model,
                          cases.lm_inputs(cfg.vocab), mesh)


def float64_gaps(arch: str, seed: int) -> None:
    """The (2, 4) step against one process, both in float64: the largest
    gaps over each quantity's scale."""
    tree = lm_mesh._weights(arch, seed)
    one = train(0, None, arch, tree, True)
    meshed = mesh_mod.spawn(train, 8, backend="gloo", device="cpu",
                            timeout_s=600, mesh_shape=(2, 4),
                            args=(arch, tree, True))[0]
    rows = sorted(((float((meshed[part][k].double() - v.double()).abs().max()
                          / (float(v.double().abs().max()) or 1.0)), part, k)
                   for part in ("grads", "leaves")
                   for k, v in one[part].items()), reverse=True)
    print(f"{arch} seed {seed}, float64: gap / scale, largest first "
          f"(the loss {float(meshed['loss'])!r} against "
          f"{float(one['loss'])!r})")
    for gap, part, k in rows[:6]:
        print(f"  {gap:.3e} {part} {k}")


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree, np.float64)


def _sides(res, cfg, port: bool) -> dict:
    """{part/path: array} of a step's gradients and updated leaves."""
    out = {}
    for part in ("grads", "leaves"):
        tree = convert.lm_tree_from_port(res[part], cfg) if port else res[
            part]
        out.update({part + k: v for k, v in _walk(tree)})
    return out


def main(argv) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch", choices=cases.LM_ARCHS)
    ap.add_argument("--seed", type=int, default=lm_mesh.WEIGHT_SEED)
    ap.add_argument("--float64", action="store_true",
                    help="only the port's meshed step against its one "
                    "process, both in float64")
    args = ap.parse_args(argv)
    if args.float64:
        return float64_gaps(args.arch, args.seed)
    cfg = cases.lm_cfg(args.arch)
    tree = lm_mesh._weights(args.arch, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        ref = lm_mesh.run_reference(Path(tmp) / "reference.pkl",
                                    (args.arch,), args.seed)
    ref = ref["steps"][args.arch]
    single = cases.lm_train(cfg, convert.lm_params_from_reference(
        tree, cfg, "cpu", train=True), cases.lm_inputs(cfg.vocab))
    meshed = mesh_mod.spawn(train, 8, backend="gloo", device="cpu",
                            timeout_s=600, mesh_shape=(2, 4),
                            args=(args.arch, tree))[0]
    opt = cases.lm_opt_cfg()

    def factor(g, res):  # AdamW's first step: lr g' / (|g'| + eps)
        g = abs(g) * min(1.0, opt.clip_norm / float(res["grad_norm"]))
        return g / (g + opt.eps)

    got, one = _sides(meshed, cfg, True), _sides(single, cfg, True)
    r_mesh, r_one = _sides(ref["mesh"], cfg, False), _sides(
        ref["single"], cfg, False)
    bounds = {k: lm_mesh.one_process_bound(k, r_mesh[k], r_one[k])
              for k in got}
    shares = sorted(((np.abs(got[k] - one[k]).max() / bounds[k], k)
                     for k in got), reverse=True)
    for part in ("grads", "leaves"):
        print(f"{args.arch} seed {args.seed}: {part}, gap / bound, largest "
              f"first")
        for share, k in [x for x in shares if x[1].startswith(part)][:6]:
            print(f"  {share:.3f} {k}")
    for share, k in shares:
        if share <= 1 or not k.startswith("leaves/"):
            continue
        g = "grads/" + k[len("leaves/"):]
        gap = np.abs(got[k] - one[k])
        past = gap > bounds[k]
        flip = past & (np.sign(got[g]) != np.sign(one[g]))
        i = np.unravel_index(np.argmax(gap), gap.shape)
        scale = np.abs(r_one[g]).max()
        print(f"{k}: {int(past.sum())} of {gap.size} elements past the "
              f"bound {bounds[k]:.4g}, {int(flip.sum())} of them with "
              f"gradients of opposite signs; largest gap {gap[i]:.4g} at "
              f"{tuple(int(j) for j in i)}, the reference's gap there "
              f"{abs(r_mesh[k][i] - r_one[k][i]):.4g}; gradient there / "
              f"the leaf's gradient scale {scale:.4g}: mesh "
              f"{got[g][i] / scale:.4g}, one process {one[g][i] / scale:.4g},"
              f" reference mesh {r_mesh[g][i] / scale:.4g}, reference "
              f"unsharded {r_one[g][i] / scale:.4g}")
        print(f"  largest |gradient| / scale among them: "
              f"{np.abs(one[g][past]).max() / scale:.4g}; AdamW's factor "
              f"at the largest gap: mesh {factor(got[g][i], meshed):.4g}, "
              f"one process {factor(one[g][i], single):.4g}, reference "
              f"mesh {factor(r_mesh[g][i], ref['mesh']):.4g}, reference "
              f"unsharded {factor(r_one[g][i], ref['single']):.4g}")


if __name__ == "__main__":
    main(sys.argv[1:])
