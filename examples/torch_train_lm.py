"""End-to-end LM training on the PyTorch/CUDA port: train a small
llama-family model for a few hundred steps on the synthetic corpus, with
checkpoint/restart, as `examples/train_lm.py` does on the reference.

    PYTHONPATH=src python examples/torch_train_lm.py --size 10m --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --size 2m --steps 60 \\
        --device cpu --mesh 1x2

`--mesh DxM` spawns D*M ranks (`launch.mesh.spawn`) as a ("data",
"model") mesh, each running the trainer on it (`launch.train.train_rank`):
NCCL with a card a rank on the card, gloo on the CPU.  It runs on the
card by default and raises without one.  The ~100M configuration is the
end-to-end target; the 2m and 10m sizes run the identical code path (the
step function, sharding rules, checkpointing and data pipeline do not
depend on size).
"""

import argparse
import dataclasses
import os
import tempfile

from repro_torch import device as device_mod
from repro_torch.configs import get_config
from repro_torch.configs.base import _REGISTRY
from repro_torch.launch import train as train_mod

SIZES = {
    # name: (layers, d_model, heads, kv, d_ff, vocab)  ~params
    "2m": (2, 128, 4, 2, 512, 2048),  # CI smoke
    "10m": (6, 320, 5, 5, 1280, 8192),  # ~13M
    "100m": (12, 640, 10, 5, 2560, 50304),  # ~123M
}


def lm_config(size: str):
    l, d, h, kv, ff, v = SIZES[size]
    base = get_config("yi-9b")
    return dataclasses.replace(
        base, name=f"lm-{size}", n_layers=l, d_model=d, n_heads=h,
        n_kv_heads=kv, head_dim=d // h, d_ff=ff, vocab=v,
    )


def train_rank(rank, device_mesh, cfg, argv):
    """One rank of `--mesh`: the size's config registered in this
    process, then the trainer over the spawned mesh."""
    _REGISTRY[cfg.name] = lambda c=cfg: c
    return train_mod.train_rank(rank, device_mesh, argv)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="10m", choices=sorted(SIZES))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--mesh", default="")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "lm_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=device_mod.DEFAULT,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    cfg = lm_config(args.size)
    print(f"[train_lm] {cfg.name}: {cfg.n_params()/1e6:.1f}M params, "
          f"{args.steps} steps @ seq {args.seq} batch {args.batch}")
    # register so the generic trainer can look it up
    _REGISTRY[cfg.name] = lambda c=cfg: c

    argv = [
        "--arch", cfg.name, "--steps", str(args.steps),
        "--seq", str(args.seq), "--global-batch", str(args.batch),
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50",
        "--log-every", "10", "--device", dev.type,
    ]
    if args.resume:
        argv += ["--resume"]
    shape = train_mod.mesh_shape(args.mesh)
    if shape is None:
        losses = train_mod.main(argv)
    else:
        from repro_torch.launch import mesh as mesh_lib

        losses = mesh_lib.spawn(
            train_rank, shape[0] * shape[1],
            backend="nccl" if dev.type == "cuda" else "gloo",
            device=dev.type, mesh_shape=shape, timeout_s=3600,
            args=(cfg, argv))[0]
    assert losses[-1] < losses[0] - 0.3, "loss did not decrease"
    print("[train_lm] loss decreased — OK")


if __name__ == "__main__":
    main()
