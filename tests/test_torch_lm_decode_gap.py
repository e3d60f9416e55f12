#!/usr/bin/env python3
"""Decode against forward, for the reference and the port on the same
weights and tokens, at a config's full width on the CPU.

Both packages get the reference's `init_model` tree (the port's copy made
by `convert.lm_params_from_reference`) and the same random tokens
(`--rows` x `--total`).  Each side prefills the first `--prompt` tokens,
decodes teacher-forced up to position `--total - 2`, and runs one forward
over all `--total` tokens: the gap is the largest |decode - forward| of the
logits at position `--total - 2`, over the largest |logit| of the forward.
The reference runs its jitted `make_prefill_step`/`make_serve_step` and a
jitted `forward`; the port its `prefill`/`decode_step`/`forward`.  Also
printed: the port's logits against the reference's (decode and forward),
and how often the two sides' argmax agree.

At a full width it takes about half a minute (xlstm-350m) and is run by
hand; from the repository root

    PYTHONPATH=src JAX_PLATFORMS=cpu \\
        python tests/test_torch_lm_decode_gap.py --arch xlstm-350m --rows 8

prints one JSON line.  The test below runs it at `reduced()` in float32,
where every gap is rounding in the last bits.

`--teacher-force` says instead where the two sides part, on the same
weights and the first `--total` tokens: each block gets the reference's
input to it (its jitted blocks run in turn) and both sides' outputs are
compared; with `--ops` (xLSTM), also each op inside the first mLSTM and
sLSTM blocks from the reference's normed input: the projections, the
recurrent core on the reference's own projections (so that only the
core's arithmetic differs), the core on each side's own, and the mixer's
output.  Each comparison gives the largest difference over the
reference's largest |value| ("rel"), the share of elements that differ,
and the share that differ by more than one bf16 step of the reference's
element.  About 40 s at xlstm-350m's width with 2 rows of 128:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm_decode_gap.py \
        --teacher-force --ops --total 128
"""

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as r_configs
from repro.launch import steps as r_steps
from repro.models import layers as r_layers
from repro.models import transformer as r_tfm
from repro.models import xlstm as r_xlstm
from repro_torch import configs as t_configs
from repro_torch import convert
from repro_torch.models import transformer as t_tfm
from repro_torch.models import xlstm as t_xlstm


def _gap(dec: np.ndarray, fwd: np.ndarray) -> dict:
    scale = float(np.abs(fwd).max())
    err = float(np.abs(dec - fwd).max())
    return {"max_abs": err, "scale": scale, "rel": err / scale,
            "same_argmax": float((dec.argmax(-1) == fwd.argmax(-1)).mean())}


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _torch(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(_f32(a))).to(dtype)


def _step_gap(got, want) -> dict:
    """rel, the share of elements that differ, and the share that differ
    by more than one bf16 step of the reference's element (its exponent's
    step 2^(e - 7), floored at 2^-20 of the largest |value|)."""
    got, want = _f32(got), _f32(want)
    scale = float(np.abs(want).max())
    diff = np.abs(got - want)
    e = np.floor(np.log2(np.maximum(np.abs(want), scale * 2.0 ** -20)))
    return {"rel": float(diff.max()) / scale,
            "share_differ": float((diff > 0).mean()),
            "share_over_one_bf16_step": float((diff > 2.0 ** (e - 7)).mean())}


def _mlstm_core_ref(q, k, v, li, lf, cfg):
    """The reference's chunk loop (its `mlstm_apply` without the
    projections), (B, S, d) out."""
    b, _, s, _ = q.shape
    st, hs, lc = r_xlstm.init_mlstm_state(cfg, b), [], t_xlstm.chunk_len(s)
    for c0 in range(0, s, lc):
        sl = slice(c0, c0 + lc)
        h, st = r_xlstm._mlstm_chunk(st, q[:, :, sl], k[:, :, sl],
                                     v[:, :, sl], li[:, :, sl], lf[:, :, sl])
        hs.append(h)
    return jnp.moveaxis(jnp.concatenate(hs, axis=2), 1, 2).reshape(b, s, -1)


def _mlstm_core_port(q, k, v, li, lf, cfg):
    b, _, s, _ = q.shape
    st, hs = t_xlstm.init_mlstm_state(cfg, b, q.device), []
    lc = t_xlstm.chunk_len(s)
    for c0 in range(0, s, lc):
        sl = slice(c0, c0 + lc)
        h, st = t_xlstm.mlstm_chunk(st, q[:, :, sl], k[:, :, sl],
                                    v[:, :, sl], li[:, :, sl], lf[:, :, sl])
        hs.append(h)
    return torch.cat(hs, dim=2).transpose(1, 2).reshape(b, s, -1)


def _slstm_core_ref(p, pre, cfg):
    def step(st, pre_t):
        h, st = r_xlstm.slstm_step(pre_t, p["r"], st)
        return st, h

    _, hs = jax.lax.scan(step, r_xlstm.init_slstm_state(cfg, pre.shape[0]),
                         jnp.moveaxis(pre, 1, 0))
    return jnp.moveaxis(hs, 0, 1).reshape(*pre.shape[:2], -1)


def _slstm_core_port(p, pre, cfg):
    st, hs = t_xlstm.init_slstm_state(cfg, pre.shape[0], pre.device), []
    for t in range(pre.shape[1]):
        h, st = t_xlstm.slstm_step(pre[:, t], p["r"], st)
        hs.append(h)
    return torch.stack(hs, dim=1).reshape(*pre.shape[:2], -1)


def _xlstm_ops(kind, tag, rp, tp, h, r_cfg, t_cfg) -> dict:
    """Op by op inside one xLSTM mixer from the reference's normed input
    `h`: the projections, the core on the reference's projections and on
    each side's own, the mixer's output."""
    th, rows = _torch(h, t_cfg.act_dtype), {}
    if kind == "mlstm":
        want = jax.jit(lambda p, h: r_xlstm._mlstm_qkv_gates(p, h, r_cfg))(
            rp, h)
        got = t_xlstm._mlstm_qkv_gates(tp, th, t_cfg)
        for n, g, w in zip(("q", "k", "v", "li", "lf"), got, want):
            rows[f"{tag} {n}"] = _step_gap(g, w)
        core_r = jax.jit(lambda *a: _mlstm_core_ref(*a, r_cfg))(*want)
        core_own = _mlstm_core_port(*got, t_cfg)
        core_same = _mlstm_core_port(*map(_torch, want), t_cfg)
        r_apply, t_apply = r_xlstm.mlstm_apply, t_xlstm.mlstm_apply
    else:
        dt = jnp.dtype(r_cfg.dtype)
        want = jax.jit(lambda p, h: (jnp.einsum(
            "bsd,dghk->bsghk", h, p["w_in"].astype(dt))
            + p["b"].astype(dt)).astype(jnp.float32))(rp, h)
        got = t_xlstm._slstm_pre(tp, th, t_cfg)
        rows[f"{tag} W x + b"] = _step_gap(got, want)
        core_r = jax.jit(lambda p, x: _slstm_core_ref(p, x, r_cfg))(rp, want)
        core_own = _slstm_core_port(tp, got, t_cfg)
        core_same = _slstm_core_port(tp, _torch(want), t_cfg)
        r_apply, t_apply = r_xlstm.slstm_apply, t_xlstm.slstm_apply
    rows[f"{tag} core on the reference's projections"] = _step_gap(
        core_same, core_r)
    rows[f"{tag} core on each side's own"] = _step_gap(core_own, core_r)
    out_r, _ = jax.jit(lambda p, h: r_apply(p, h, r_cfg))(rp, h)
    rows[f"{tag} mixer output"] = _step_gap(t_apply(tp, th, t_cfg)[0], out_r)
    return rows


@torch.no_grad()
def teacher_force(params, model, r_cfg, t_cfg, toks, ops: bool) -> dict:
    """Each block's output from the reference's input to it, both sides;
    with `ops`, the first mLSTM and sLSTM blocks op by op."""
    s = toks.shape[1]
    pos, tpos = jnp.arange(s, dtype=jnp.int32), torch.arange(s)
    x = jax.jit(lambda p, t: r_tfm.embed_inputs(p, r_cfg, {"tokens": t}))(
        params, jnp.asarray(toks))
    period = len(r_cfg.pattern)
    firsts = {r_cfg.pattern.index(k): k for k in ("mlstm", "slstm")
              if ops and k in r_cfg.pattern}
    out = {"blocks": [], "ops": {}}
    for i in range(r_cfg.n_layers):
        slot = i % period
        bp = jax.tree.map(lambda a: a[i // period],
                          params["super"][f"b{slot}"])
        tb = model["blocks"][i]
        if i in firsts:
            h = jax.jit(lambda p, x: r_layers.rms_norm(
                x, p["norm1"], r_cfg.norm_eps))(bp, x)
            out["ops"].update(_xlstm_ops(
                firsts[i], f"block {i} ({firsts[i]})", bp["core"],
                tb["core"], h, r_cfg, t_cfg))
        want = jax.jit(lambda p, x, slot=slot: r_tfm.block_apply(
            p, x, r_cfg, slot, pos)[0])(bp, x)
        got, _ = t_tfm.block_apply(tb, _torch(x, t_cfg.act_dtype), t_cfg,
                                   slot, tpos.to(torch.int32))
        out["blocks"].append(_step_gap(got, want))
        x = want
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--rows", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--total", type=int, default=160)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--teacher-force", action="store_true")
    ap.add_argument("--ops", action="store_true")
    args = ap.parse_args(argv)

    r_cfg = r_configs.get_config(args.arch)
    t_cfg = t_configs.get_config(args.arch)
    if args.reduced:
        r_cfg, t_cfg = r_cfg.reduced(), t_cfg.reduced()
    r_cfg = dataclasses.replace(r_cfg, dtype=args.dtype)
    t_cfg = dataclasses.replace(t_cfg, dtype=args.dtype)
    t0 = time.perf_counter()
    params = r_tfm.init_model(jax.random.PRNGKey(args.seed), r_cfg)
    tree = jax.tree.map(np.asarray, params)
    model = convert.lm_params_from_reference(tree, t_cfg, "cpu")
    del tree
    toks = np.random.default_rng(args.seed + 1).integers(
        0, r_cfg.vocab, (args.rows, args.total)).astype(np.int32)
    head = {"arch": args.arch, "reduced": args.reduced, "dtype": args.dtype,
            "rows": args.rows, "total": args.total, "seed": args.seed}
    if args.teacher_force:
        out = {**head, **teacher_force(params, model, r_cfg, t_cfg, toks,
                                       args.ops),
               "wall_s": time.perf_counter() - t0}
        print(json.dumps(out))
        return out
    p0, last = args.prompt, args.total - 2
    steps = last - p0 + 1  # decode positions p0 .. total - 2

    # the reference: jitted prefill, decode steps and forward
    _, r_caches = r_steps.make_prefill_step(r_cfg, None)(
        params, {"tokens": jnp.asarray(toks[:, :p0])})
    r_caches = r_tfm.grow_attn_caches(r_caches, r_cfg, steps)
    r_step = r_steps.make_serve_step(r_cfg, None, sampler="greedy")
    for pos in range(p0, last + 1):
        _, r_dec, r_caches = r_step(
            params, jnp.asarray(toks[:, pos:pos + 1]), r_caches,
            jnp.asarray(pos, jnp.int32), jax.random.key(0))
    r_dec = np.asarray(r_dec, np.float32)
    del r_caches
    r_fwd = np.asarray(jax.jit(lambda p, t: r_tfm.forward(
        p, r_cfg, {"tokens": t})[0][:, last])(params, jnp.asarray(toks)),
        np.float32)
    del params

    # the port, on the same weights and tokens
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        _, caches = t_tfm.prefill(model, t_cfg, {"tokens": tt[:, :p0]})
        caches = t_tfm.grow_attn_caches(caches, t_cfg, steps)
        for pos in range(p0, last + 1):
            t_dec, caches = t_tfm.decode_step(model, t_cfg,
                                              tt[:, pos:pos + 1], caches, pos)
        del caches
        t_fwd, _ = t_tfm.forward(model, t_cfg, {"tokens": tt})
    t_dec, t_fwd = t_dec.float().numpy(), t_fwd[:, last].float().numpy()

    out = {**head, "prompt": p0,
           "params": sum(t.numel() for t in model.parameters()),
           "reference_decode_vs_forward": _gap(r_dec, r_fwd),
           "port_decode_vs_forward": _gap(t_dec, t_fwd),
           "port_vs_reference_decode": _gap(t_dec, r_dec),
           "port_vs_reference_forward": _gap(t_fwd, r_fwd),
           "wall_s": time.perf_counter() - t0}
    print(json.dumps(out))
    return out


def test_decode_gap_script_at_reduced_width_float32():
    out = main(["--arch", "xlstm-350m", "--reduced", "--dtype", "float32",
                "--rows", "2", "--prompt", "8", "--total", "12"])
    for name in ("reference_decode_vs_forward", "port_decode_vs_forward",
                 "port_vs_reference_decode", "port_vs_reference_forward"):
        assert out[name]["rel"] < 1e-5, (name, out[name])
        assert out[name]["same_argmax"] == 1.0


def test_teacher_force_at_reduced_width_float32():
    """The teacher-forced comparison at xlstm-350m reduced in float32:
    every block and every op of the first mLSTM and sLSTM blocks within
    1e-5 of the reference's largest |value|."""
    out = main(["--arch", "xlstm-350m", "--reduced", "--dtype", "float32",
                "--rows", "2", "--total", "16", "--teacher-force", "--ops"])
    assert len(out["blocks"]) == 8 and len(out["ops"]) == 12
    for row in [*out["blocks"], *out["ops"].values()]:
        assert row["rel"] < 1e-5, out


if __name__ == "__main__":
    main()
