#!/usr/bin/env python3
"""Two bf16 measurements of the port's LM serving path on the card; each
prints one JSON line with the card's name and power limit.

`gap`: decode against forward at a config's full width (default
xlstm-350m), the port's own seeded weights, `--rows` rows of random tokens
over `--total` positions: a prefill of `--prompt`, decode steps up to
position `--total - 2`, and a forward over all `--total`; the gap is the
largest |decode - forward| at that position over the forward's largest
|logit|.  Measured on the card with cuBLAS's reduced-precision bf16
reductions allowed (PyTorch's default) and disallowed, and for the same
weights and tokens on the CPU.  (tests/test_torch_lm_decode_gap.py reads
the same gap for the reference and the port on the CPU.)

`rounding`: a decode step of yi-9b at full width (8 rows after a
128-token prefill, greedy), timed with the FFN's roundings as XLA rounds
the reference (`layers.silu`, `layers.add_rms_norm`) and with
`torch.nn.functional.silu` and the residual sum rounded before its norm,
in turns (ABBA, `--rounds` times) in one process on one model; also the
kernels a step launches in each form.

    python tools/lm_bf16.py gap --arch xlstm-350m
    python tools/lm_bf16.py rounding
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _gap(model, cfg, toks: torch.Tensor, prompt: int) -> dict:
    last = toks.shape[1] - 2
    with torch.no_grad():
        _, caches = tfm.prefill(model, cfg, {"tokens": toks[:, :prompt]})
        caches = tfm.grow_attn_caches(caches, cfg, last - prompt + 1)
        for pos in range(prompt, last + 1):
            dec, caches = tfm.decode_step(model, cfg, toks[:, pos:pos + 1],
                                          caches, pos)
        del caches
        fwd = tfm.forward(model, cfg, {"tokens": toks})[0][:, last]
    scale = float(fwd.abs().max())
    err = float((dec - fwd).abs().max())
    return {"max_abs": err, "scale": scale, "rel": err / scale,
            "same_argmax": float((dec.argmax(-1) == fwd.argmax(-1))
                                 .float().mean())}


def gap(args) -> dict:
    cfg = get_config(args.arch)
    dev = torch.device("cuda")
    model = tfm.init_model(cfg, seed=args.seed, device=dev)
    toks = torch.from_numpy(np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab, (args.rows, args.total)).astype(np.int32))
    matmul = torch.backends.cuda.matmul
    out = {"phase": "gap", "card": card(), "arch": cfg.name,
           "dtype": cfg.dtype, "rows": args.rows, "prompt": args.prompt,
           "total": args.total, "seed": args.seed}
    for allow in (True, False):
        matmul.allow_bf16_reduced_precision_reduction = allow
        out[f"card_reduced_precision_reduction_{allow}"] = _gap(
            model, cfg, toks.to(dev), args.prompt)
    matmul.allow_bf16_reduced_precision_reduction = True
    t0 = time.perf_counter()
    out["cpu"] = _gap(model.to("cpu"), cfg, toks, args.prompt)
    out["cpu_s"] = time.perf_counter() - t0
    return out


def _plain_mlp(p, x, cfg):
    gate = torch.nn.functional.silu(x @ p["wg"])
    return (gate * (x @ p["wu"])) @ p["wd"]


def _plain_add_rms_norm(x, y, w, eps):
    s = x + y
    return s, layers.rms_norm(s, w, eps)


def _kernels(fn) -> int:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def rounding(args) -> dict:
    cfg = get_config("yi-9b")
    dev = torch.device("cuda")
    model = tfm.init_model(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (8, 129), generator=g, device=dev,
                         dtype=torch.int32)
    with torch.no_grad():
        _, caches = tfm.prefill(model, cfg, {"tokens": toks[:, :128]})
    caches = tfm.grow_attn_caches(caches, cfg, 1)
    tok = toks[:, 128:]
    forms = {"xla": (layers.mlp_apply, layers.add_rms_norm),
             "plain": (_plain_mlp, _plain_add_rms_norm)}

    def use(form):
        layers.mlp_apply, layers.add_rms_norm = forms[form]

    def step():
        with torch.no_grad():
            return tfm.decode_step(model, cfg, tok, caches, 128)

    def time_steps() -> list:
        step()
        out = []
        for _ in range(args.steps):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            step()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return out

    ms = {f: [] for f in forms}
    kernels = {}
    for _ in range(args.rounds):
        for form in ("xla", "plain", "plain", "xla"):
            use(form)
            ms[form].append(statistics.median(time_steps()))
    for form in forms:
        use(form)
        kernels[form] = _kernels(step)
    use("xla")
    return {"phase": "rounding", "card": card(), "arch": cfg.name,
            "batch": 8, "pos": 128, "steps_per_turn": args.steps,
            "decode_ms_medians_per_turn": ms,
            "decode_ms": {f: statistics.median(v) for f, v in ms.items()},
            "kernels_per_step": kernels}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("gap", "rounding"))
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--total", type=int, default=160)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(json.dumps({"gap": gap, "rounding": rounding}[args.what](args)),
          flush=True)


if __name__ == "__main__":
    main()
