"""Batched LM serving on the PyTorch/CUDA port with the paper's
normalization-free KY token sampler, as `examples/serve_lm.py` does on
the reference.

Prefills a batch of prompts, then decodes tokens with, per step:
logits -> LUT-exp integer weights (C2, K2) -> hierarchical rejection-KY
(C1, K1) — no softmax anywhere in the sampling path.  Compares against
gumbel-max and greedy on the same weights.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch musicgen-medium
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

It runs on the card by default and raises without one.
"""

import argparse

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.launch.serve import generate
from repro_torch.models import transformer as tfm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="musicgen-medium")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=device_mod.DEFAULT,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    cfg = get_config(args.arch).reduced()
    params = tfm.init_model(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)
    features = None
    if cfg.frontend:
        features = torch.as_tensor(rng.normal(
            0, 1, (args.batch, cfg.frontend_len, tfm.FRONTEND_DIM)
        ), dtype=torch.float32, device=dev)

    for sampler in ("ky", "gumbel", "greedy"):
        toks, times = generate(
            cfg, params, prompts, args.gen, sampler=sampler,
            features=features, key=prng.key(7),
        )
        assert toks.shape == (args.batch, args.prompt_len + args.gen)
        tput = args.batch / np.mean(times[1:]) if len(times) > 1 else 0
        uniq = len(np.unique(toks[:, args.prompt_len:].cpu().numpy()))
        print(f"[serve_lm] {sampler:7s}: {tput:8.1f} tok/s, "
              f"{uniq:4d} distinct generated tokens "
              f"(batch {args.batch} x {args.gen})")
    print("OK")


if __name__ == "__main__":
    main()
