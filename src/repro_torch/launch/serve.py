"""Batched serving driver: prefill a batch of prompts, then decode with the
paper's normalization-free KY token sampler (C1+C2) inside the step.

Port of `repro/launch/serve.py`.  On the card, the token draw runs K2
once and K1 once per tree level for every token.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \\
        --batch 8 --prompt-len 128 --gen 32 --sampler ky
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \\
        --reduced --device cpu --batch 2 --prompt-len 8 --gen 4
    PYTHONPATH=src torchrun --nproc-per-node 8 -m \\
        repro_torch.launch.serve --arch yi-9b --reduced --device cpu \\
        --mesh 2x4 --backend gloo --batch 8 --prompt-len 8 --gen 4

With `--mesh DxM` (under `torchrun`) every rank holds its shard of the
weights and caches and serves its rows of the batch; every rank draws
the whole batch's tokens, and rank 0 prints.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.core.interp import build_exp_weight_lut
from repro_torch.launch import sharding
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.sampling import sample_tokens


def _timed(fn, dev: torch.device):
    """(fn(), its seconds): CUDA events around the call on the card, whose
    queue is empty when it starts, so the time counts the host's launches
    and the card's work; the host clock on the CPU."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


@torch.inference_mode()
def generate(cfg, params, prompts, gen_len, sampler="ky", mesh=None,
             features=None, key=None, logits_out=None, comms_out=None):
    """prompts (B, S0) int -> (B, S0 + gen_len) int32 tokens (the prompt
    echoed, then the sampled continuation).  Returns (tokens, seconds of
    each decode step after the first token).

    The first token is drawn from the prefill's logits with `key` itself;
    each later step splits `key, sub = split(key)` and draws with `sub`, at
    position total0 + t (total0: prompt plus frontend positions).

    With a `mesh`, `params` is a `sharding.distribute`d model and the
    prefill and decode steps run through the meshed factories (batch and
    caches bound as the reference's `_generate` binds them); every rank
    returns the whole tokens.  `logits_out`, a list, receives the logits
    (B, V) each token was drawn from; `comms_out`, a dict, the meshed
    prefill's and decode step's `collectives.Comm` ("prefill",
    "decode"), which count their collectives by op and axis."""
    key = key if key is not None else prng.key(0)
    dev = prompts.device
    b, s0 = prompts.shape
    prompts = prompts.to(torch.int32)
    batch = {"tokens": prompts}
    if cfg.frontend:
        batch["features"] = features
    total0 = s0 + (cfg.frontend_len if cfg.frontend else 0)

    prefill_fn = steps_lib.make_prefill_step(cfg, mesh)
    if mesh is not None:  # bind the batch specs; the stored caches come
        # grown by decode's headroom, each rank its shard
        prefill_fn = prefill_fn(batch, extra=gen_len)
        if comms_out is not None:
            comms_out["prefill"] = prefill_fn.comm
    logits, caches = prefill_fn(params, batch)
    if mesh is None:
        caches = tfm.grow_attn_caches(caches, cfg, gen_len)

    # one LUT-exp table for every token (a new table's copy to the card
    # waits for the card's stream)
    kw = {}
    if sampler == "ky":
        kw["exp_table"], kw["exp_spec"] = build_exp_weight_lut(device=dev)
    serve_fn = steps_lib.make_serve_step(cfg, mesh, sampler=sampler, **kw)
    if mesh is not None:
        serve_fn, _ = serve_fn(caches, b)  # bind the cache specs + batch
        if comms_out is not None:
            comms_out["decode"] = serve_fn.comm
    tok = sample_tokens(logits, key, sampler, **kw)[:, None]
    out = [prompts, tok]
    times = []
    for t in range(gen_len - 1):
        if logits_out is not None:
            logits_out.append(logits)
        key, sub = prng.split(key)
        (tok_next, logits, caches), sec = _timed(
            lambda: serve_fn(params, tok, caches, total0 + t, sub), dev)
        times.append(sec)
        tok = tok_next[:, None]
        out.append(tok)
    if logits_out is not None:
        logits_out.append(logits)
    return torch.cat(out, dim=1), times


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--sampler", default="ky",
                    choices=["ky", "gumbel", "greedy"])
    ap.add_argument("--device", default=device_mod.DEFAULT,
                    help="cuda (default) or cpu (the plain torch twins)")
    ap.add_argument("--mesh", default="",
                    help="DxM: a (data, model) mesh of D*M ranks (under "
                    "torchrun); '' or 1x1 alone: one device")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="the ranks' transport with --mesh")
    args = ap.parse_args(argv)

    from repro_torch.launch import train as train_lib

    train_lib.mesh_shape(args.mesh)  # a malformed spec raises first
    dev, mesh = train_lib.join_mesh(args.mesh, args.backend, args.device)
    try:
        return _serve(args, dev, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _serve(args, dev, mesh):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = tfm.init_model(cfg, seed=0, device=dev)
    if mesh is not None:
        params = sharding.distribute(
            mesh, params, sharding.param_specs(mesh, cfg, params), cfg=cfg)
    rng = np.random.default_rng(0)
    prompts = torch.tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)
    features = None
    if cfg.frontend:
        features = torch.tensor(rng.normal(
            0, 1, (args.batch, cfg.frontend_len, tfm.FRONTEND_DIM)
        ), dtype=torch.float32, device=dev)

    toks, times = generate(cfg, params, prompts, args.gen,
                           sampler=args.sampler, mesh=mesh,
                           features=features)
    if mesh is not None and int(os.environ["RANK"]) != 0:
        return toks
    # the first timed step includes the kernels' first use (build and
    # load); with --gen too short to leave any steady-state step, report
    # n/a rather than a bogus 0.0
    tput = f"{args.batch / np.mean(times[1:]):.1f} tok/s" \
        if len(times) > 1 else "n/a"
    print(f"[serve] arch={cfg.name} sampler={args.sampler} "
          f"generated {tuple(toks.shape)} tokens; "
          f"decode throughput {tput} (batch {args.batch})")
    print("[serve] sample row:", toks[0, : args.prompt_len + 8].cpu().numpy())
    return toks


if __name__ == "__main__":
    main()
