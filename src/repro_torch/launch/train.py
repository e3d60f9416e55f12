"""Single-card trainer.

Port of `repro/launch/train.py` for one device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \\
        --reduced --steps 200 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \\
        --reduced --device cpu --steps 4

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

`--mesh` takes only '' or 1x1: training over a mesh of ranks waits for
the LM mesh (ROADMAP §1 item 2).  The reference's `--compress` is parsed
there but never reaches its collectives, which the port keeps in
`optim/compression.py`.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw


def build(cfg, opt_cfg, device):
    """(params, their leaves by name, opt_state, step_fn)."""
    params = tfm.init_model(cfg, seed=0, device=device, train=True)
    leaves = tfm.train_leaves(params, cfg)
    opt_state = adamw.init(leaves, opt_cfg)
    step_fn = steps_lib.make_train_step(cfg, None, opt_cfg)
    return params, leaves, opt_state, step_fn


def _mesh(spec: str) -> None:
    if spec not in ("", "1x1"):
        raise NotImplementedError(
            f"--mesh {spec}: training over a mesh of ranks waits for the "
            "LM mesh (ROADMAP §1 item 2; the sampler's runs over ranks "
            "already); pass '' or 1x1")


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
                    help="'' or 1x1 (one device); larger meshes are not "
                    "ported")
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

    _mesh(args.mesh)
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    dev = device_mod.resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt_cfg = adamw.AdamWConfig(
        lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps,
        moment_dtype=steps_lib.default_opt_cfg(cfg).moment_dtype,
    )
    data = SyntheticLM(cfg.vocab, args.seq, args.global_batch)
    params, leaves, opt_state, step_fn = build(cfg, opt_cfg, dev)

    start_step = 0
    if args.resume and args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            like = {"params": leaves, "opt": opt_state}
            manifest, tree = ckpt.restore(args.ckpt_dir, last, like)
            with torch.no_grad():
                for name, leaf in leaves.items():
                    leaf.copy_(tree["params"][name])
                for part in ("m", "v"):
                    for name, t in opt_state[part].items():
                        t.copy_(tree["opt"][part][name])
                opt_state["step"].copy_(tree["opt"]["step"])
            start_step = manifest["step"]
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
        ckpt.save(args.ckpt_dir, step, tree, extra={"arch": cfg.name})
        ckpt.rotate(args.ckpt_dir, args.keep)

    def make_frontend_batch(b):
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

    out = open(args.metrics_out, "a") if args.metrics_out else None
    try:
        t0 = time.time()
        losses = []
        for step in range(start_step, args.steps):
            batch = to_device(make_frontend_batch(data.batch(step)), dev)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if out is not None:
                out.write(json.dumps({"step": step, **{
                    k: float(v) for k, v in metrics.items()}}) + "\n")
            if step % args.log_every == 0 or step == args.steps - 1:
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


if __name__ == "__main__":
    main()
