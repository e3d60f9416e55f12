"""Trainer, on one device or over a mesh of ranks.

Port of `repro/launch/train.py`:

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \\
        --reduced --steps 200 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \\
        --reduced --device cpu --steps 4
    PYTHONPATH=src torchrun --nproc-per-node 8 -m \\
        repro_torch.launch.train --arch yi-9b --reduced --device cpu \\
        --mesh 2x4 --backend gloo --steps 4

* any registered --arch (full, or --reduced smoke geometry), a training
  model from a seed (`init_model(..., train=True)`), AdamW, batches from
  `SyntheticLM` (a pure function of the step: no pipeline state);
* atomic rotated checkpoints every --ckpt-every steps (params, AdamW
  moments and step), and `--resume` from the latest one;
* preemption-safe: SIGTERM/SIGINT take a final checkpoint before exit;
* `--deterministic` runs under `torch.use_deterministic_algorithms`, so
  that a resumed run repeats an uninterrupted one bit for bit on the card
  too (on the CPU it does regardless);
* `--metrics-out` writes every step's exact loss, grad norm and lr as
  JSON lines.

`--mesh DxM` trains over a (D, M) = ("data", "model") mesh of D*M ranks
started by `torchrun` (or `launch.mesh.spawn`), each joining with
`--backend` (gloo moves host memory and lets ranks share a card or run
on the CPU; nccl needs a card a rank): the parameters and AdamW moments
are distributed by the reference's sharding rules
(`launch/sharding.py`), each batch is placed on the mesh
(`data.place_batch`), checkpoints are written whole by rank 0 and
`--resume` re-shards them onto the current mesh, whatever mesh wrote
them.  '' or 1x1 outside a world is one device.  The reference's
`--compress` is parsed there but never reaches its collectives, which
the port keeps in `optim/compression.py`; the port has no such flag.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import signal
import sys
import time

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM, place_batch, to_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw


def build(cfg, opt_cfg, device, mesh=None, batch_shape=None, params=None):
    """(params, their leaves by name, opt_state, step_fn, batch
    shardings).  The model is `params` (a training model), or one built
    from seed 0 on `device`.  On a mesh it is distributed, the moments
    made as each rank's zeros, `step_fn` bound to `batch_shape`, and the
    shardings are `place_batch`'s (None on one device)."""
    if params is None:
        params = tfm.init_model(cfg, seed=0, device=device, train=True)
    if mesh is None:
        leaves = tfm.train_leaves(params, cfg)
        opt_state = adamw.init(leaves, opt_cfg)
        step_fn = steps_lib.make_train_step(cfg, None, opt_cfg)
        return params, leaves, opt_state, step_fn, None
    with_batch, specs = steps_lib.make_train_step(cfg, mesh, opt_cfg)
    step_fn, bspecs = with_batch(batch_shape)
    params = sharding.distribute(mesh, params, specs["params"], cfg=cfg)
    leaves = tfm.train_leaves(params, cfg)
    return (params, leaves, moments(mesh, leaves, opt_cfg), step_fn,
            sharding.to_named(mesh, bspecs))


def moments(mesh, leaves: dict, opt_cfg) -> dict:
    """AdamW's state of distributed leaves: each rank's zero moments of
    its shards, laid out as the leaves are, and a replicated step."""
    local = adamw.init({n: sharding.local(p) for n, p in leaves.items()},
                       opt_cfg)
    state = {part: {n: sharding.shard_like(leaves[n], t)
                    for n, t in local[part].items()}
             for part in ("m", "v")}
    state["step"] = sharding.shard_leaf(mesh, local["step"], ())
    return state


def mesh_shape(spec: str) -> tuple[int, int] | None:
    """--mesh's (D, M), None for ''; anything but DxM raises."""
    if spec == "":
        return None
    m = re.fullmatch(r"([1-9][0-9]*)x([1-9][0-9]*)", spec)
    if m is None:
        raise ValueError(f"--mesh {spec!r}: DxM (e.g. 2x4), or '' for one "
                         "device")
    return int(m.group(1)), int(m.group(2))


def join_mesh(spec: str, backend: str, device: str):
    """(the rank's device, the (data, model) mesh) of --mesh; (the
    device, None) for one device.  A mesh of several ranks needs a world
    (`torchrun` sets RANK and WORLD_SIZE) of exactly its size."""
    shape = mesh_shape(spec)
    in_world = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if shape is None or (math.prod(shape) == 1 and not in_world):
        return device_mod.resolve(device), None
    if not in_world:
        raise ValueError(
            f"--mesh {spec} needs a world of {math.prod(shape)} ranks: run "
            f"under torchrun --nproc-per-node {math.prod(shape)}")
    world = int(os.environ["WORLD_SIZE"])
    if world != math.prod(shape):  # before joining: no rank waits
        raise ValueError(f"--mesh {spec} holds {math.prod(shape)} ranks; "
                         f"the world has {world}")
    dev = mesh_lib.init_ranks(backend, device=torch.device(device).type)
    return dev, mesh_lib.make_mesh(shape, ("data", "model"),
                                   device_type=dev.type)


def _restore_into(cfg, tree: dict, by_path: dict) -> None:
    """A checkpoint's host arrays (`restore` without `like`) written into
    a tree (on the current mesh: each rank its block), each leaf checked
    against its shape and rounded to its type."""
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.models import layers

    layers.accumulate_in_float32()
    for path, leaf in _flatten(tree):
        arr = by_path[path]
        want = sharding.port_shape(cfg, path.split("/")[-1], leaf.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{path}: stored {tuple(arr.shape)}, expected "
                             f"{want}")
        sharding.load_whole(leaf, arr)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--mesh", default="",
                    help="DxM: a (data, model) mesh of D*M ranks (under "
                    "torchrun); '' or 1x1 alone: one device")
    ap.add_argument("--backend", default="gloo", choices=mesh_lib.BACKENDS,
                    help="the ranks' transport with --mesh")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=device_mod.DEFAULT,
                    help="cuda (default) or cpu")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True)")
    ap.add_argument("--metrics-out", default="",
                    help="write each step's loss, grad_norm and lr here "
                    "(JSON lines, exact floats)")
    args = ap.parse_args(argv)

    mesh_shape(args.mesh)  # a malformed spec raises before anything runs
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    dev, mesh = join_mesh(args.mesh, args.backend, args.device)
    try:
        return _train(args, dev, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(args, dev, mesh):
    rank0 = mesh is None or int(os.environ["RANK"]) == 0
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt_cfg = adamw.AdamWConfig(
        lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps,
        moment_dtype=steps_lib.default_opt_cfg(cfg).moment_dtype,
    )
    data = SyntheticLM(cfg.vocab, args.seq, args.global_batch)
    params, leaves, opt_state, step_fn, bshard = build(
        cfg, opt_cfg, dev, mesh, make_frontend_batch(cfg, args,
                                                     data.batch(0)))

    start_step = 0
    if args.resume and args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:  # onto the current mesh, whichever wrote it
            manifest, by_path = ckpt.restore(args.ckpt_dir, last)
            _restore_into(cfg, {"params": leaves, "opt": opt_state}, by_path)
            start_step = manifest["step"]
            if rank0:
                print(f"[train] resumed from step {start_step}")

    stop = {"now": False}

    def _sig(_sig, _frm):
        stop["now"] = True

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)

    def save(step):
        if not args.ckpt_dir:
            return
        tree = {"params": leaves, "opt": opt_state}
        ckpt.save(args.ckpt_dir, step, tree, extra={"arch": cfg.name},
                  cfg=cfg)
        if rank0:
            ckpt.rotate(args.ckpt_dir, args.keep)

    out = open(args.metrics_out, "a") if args.metrics_out and rank0 \
        else None
    try:
        t0 = time.time()
        losses = []
        for step in range(start_step, args.steps):
            host = make_frontend_batch(cfg, args, data.batch(step))
            batch = (to_device(host, dev) if bshard is None
                     else place_batch(host, bshard, dev))
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if out is not None:
                out.write(json.dumps({"step": step, **{
                    k: float(v) for k, v in metrics.items()}}) + "\n")
            if rank0 and (step % args.log_every == 0
                          or step == args.steps - 1):
                loss = float(metrics["loss"])
                losses.append(loss)
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"({time.time() - t0:.1f}s)", flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                save(step + 1)
            if stop["now"]:
                print("[train] preemption signal: checkpoint + exit")
                save(step + 1)
                sys.exit(0)
    finally:
        if out is not None:
            out.close()
    save(args.steps)
    if losses:
        print(f"[train] done: first/last logged loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


def make_frontend_batch(cfg, args, b):
    """A frontend arch's batch: its tokens cut to leave the frontend's
    positions, and stub features from a fixed seed."""
    if not cfg.frontend:
        return b
    rng = np.random.default_rng(1234)
    s_f = cfg.frontend_len
    b = dict(b)
    b["tokens"] = b["tokens"][:, : args.seq - s_f]
    b["features"] = rng.normal(
        0, 1, (args.global_batch, s_f, tfm.FRONTEND_DIM)
    ).astype(np.float32)
    return b


if __name__ == "__main__":
    main()
