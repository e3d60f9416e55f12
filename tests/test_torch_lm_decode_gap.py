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
from repro.models import transformer as r_tfm
from repro_torch import configs as t_configs
from repro_torch import convert
from repro_torch.models import transformer as t_tfm


def _gap(dec: np.ndarray, fwd: np.ndarray) -> dict:
    scale = float(np.abs(fwd).max())
    err = float(np.abs(dec - fwd).max())
    return {"max_abs": err, "scale": scale, "rel": err / scale,
            "same_argmax": float((dec.argmax(-1) == fwd.argmax(-1)).mean())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--rows", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--total", type=int, default=160)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true")
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

    out = {"arch": args.arch, "reduced": args.reduced, "dtype": args.dtype,
           "rows": args.rows, "prompt": p0, "total": args.total,
           "seed": args.seed,
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


if __name__ == "__main__":
    main()
