"""The port's training step on the card against the same step on the CPU
(plain PyTorch both; this file imports no JAX, so it runs where JAX is
absent).  Skips where there is no CUDA device; on the card:

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 -m pytest -q -m cuda \\
        tests/test_torch_train_card.py
"""

import copy
import dataclasses

import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.launch import steps as t_steps
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tfm
from repro_torch.optim import adamw

# float32 on both sides: cuBLAS's and the CPU's float32 sums differ in the
# last bits: the loss within 1e-5 of itself, each leaf's gradient within
# GRAD_RTOL of its own largest |g|.  xlstm-350m's exponential gates
# amplify those differences: 4.3e-5 to 8.0e-4 at weights seeds 3-8 (the
# script at the end), held at 1e-3.  The mLSTM input-gate bias `bi`,
# whose gradient is a cancellation of terms of its gate weight's size
# (tests/test_torch_train.py), read 0.2% to 10.4% of its own largest |g|
# there (seed 3, the test's, the most), held at 0.25: a zeroed gradient
# reads 1.  The update: AdamW from the same gradients on both sides, every
# leaf within 1e-6 of its largest |value| plus 1e-4 of lr (a first step
# moves an element by about lr).
LOSS_RTOL, GRAD_RTOL, BI_RTOL = 1e-5, 1e-4, 0.25
GRAD_RTOL_BY_ARCH = {"xlstm-350m": 1e-3}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_and_cpu(arch: str, seed: int, dev) -> dict:
    """A reduced float32 training model on the card and on the CPU from
    the same weights (`seed`) and `SyntheticLM` batch (`seed` - 2):
    `train_loss` and every leaf's gradient; AdamW's update of every leaf
    from the same (the CPU's) gradients; then one `make_train_step`
    step's metrics."""
    cfg = dataclasses.replace(t_configs.get_config(arch).reduced(),
                              dtype="float32")
    cpu = t_tfm.init_model(cfg, seed=seed, device="cpu", train=True)
    card = copy.deepcopy(cpu).to(dev)
    batch = SyntheticLM(cfg.vocab, 32, 2, seed=seed - 2).batch(0)
    opt = adamw.AdamWConfig(warmup_steps=4, total_steps=10)
    step = t_steps.make_train_step(cfg, None, opt)
    sides = (("cpu", cpu, "cpu"), ("card", card, dev))
    out = {}
    for name, model, d in sides:
        leaves = t_tfm.train_leaves(model, cfg)
        loss = t_tfm.train_loss(model, cfg, to_device(batch, d))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out[name] = {"loss": float(loss.detach()),
                     "grads": {n: g.cpu() for n, g in zip(leaves, grads)}}
    for name, model, d in sides:
        leaves = t_tfm.train_leaves(model, cfg)
        _, _, metrics = adamw.update(
            leaves, {n: g.to(d) for n, g in out["cpu"]["grads"].items()},
            adamw.init(leaves, opt), opt, decays=t_tfm.decays)
        out[name]["lr_update"] = float(metrics["lr"])
        out[name]["params"] = {n: p.detach().to("cpu", copy=True)
                               for n, p in leaves.items()}
        _, _, metrics = step(model, adamw.init(leaves, opt),
                             to_device(batch, d))
        out[name].update({k: float(v) for k, v in metrics.items()})
    return out


def _gaps(out: dict) -> dict:
    """Card against CPU: each gradient's largest gap over its own largest
    |g|; each updated leaf's largest gap over its limit, 1e-6 of its
    largest |value| plus 1e-4 of lr."""
    cpu_, card_ = out["cpu"], out["card"]
    lr = cpu_["lr_update"]
    gap = lambda a, b: float((a - b).abs().max())
    return {"grads": {n: gap(card_["grads"][n], w) / float(w.abs().max())
                      for n, w in cpu_["grads"].items()},
            "params": {n: gap(card_["params"][n], w)
                       / (1e-6 * float(w.abs().max()) + 1e-4 * lr)
                       for n, w in cpu_["params"].items()}}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-9b", "qwen2-moe-a2.7b", "xlstm-350m"])
def test_reduced_train_step_on_the_card_matches_the_cpu(arch):
    """`_card_and_cpu` at weights seed 3: the loss, every gradient, every
    leaf AdamW updates from the same gradients, and the step's loss,
    grad norm and lr, within the limits above."""
    out = _card_and_cpu(arch, 3, _card())
    cpu_, card_ = out["cpu"], out["card"]
    rtol = GRAD_RTOL_BY_ARCH.get(arch, GRAD_RTOL)
    assert abs(card_["loss"] - cpu_["loss"]) <= LOSS_RTOL * cpu_["loss"]
    gaps = _gaps(out)
    for n, gap in gaps["grads"].items():
        assert gap <= (BI_RTOL if n.endswith(".bi") else rtol), (n, gap)
    for n, share in gaps["params"].items():
        assert share <= 1.0, (n, share)
    for k in ("loss", "grad_norm"):
        assert abs(card_[k] - cpu_[k]) <= rtol * cpu_[k], k
    assert card_["lr"] == cpu_["lr"]


@pytest.mark.cuda
def test_flash_backward_on_the_card_matches_the_cpu():
    """The flash backward at yi-9b's head geometry (GQA 32/4 of 128),
    S = 512 in KV chunks of 128, float32: dq, dk, dv on the card within
    1e-5 of each gradient's largest |g| on the CPU."""
    dev = _card()
    g = torch.Generator().manual_seed(0)
    shapes = ((1, 512, 32, 128), (1, 512, 4, 128), (1, 512, 4, 128))
    q, k, v = (torch.randn(s, generator=g) * 0.3 for s in shapes)
    dout = torch.randn(shapes[0], generator=g)
    grads = {}
    for d in ("cpu", dev):
        xs = [t.detach().to(d).requires_grad_(True) for t in (q, k, v)]
        out = t_layers.flash_attention(*xs, 0, 0, 128, 128)
        grads[str(d)] = torch.autograd.grad(out, xs, dout.to(d))
    for a, b in zip(grads["cpu"], grads[str(dev)]):
        err = float((b.cpu() - a).abs().max())
        assert err <= 1e-5 * float(a.abs().max())


if __name__ == "__main__":
    # the readings the limits above were set from, on the card:
    #   PYTHONPATH=src python3 tests/test_torch_train_card.py [seeds]
    import json
    import sys

    dev = _card()
    for arch in ("yi-9b", "qwen2-moe-a2.7b", "xlstm-350m"):
        for seed in range(3, 3 + int((sys.argv[1:] or [6])[0])):
            out = _card_and_cpu(arch, seed, dev)
            g = _gaps(out)
            rest = {n: v for n, v in g["grads"].items()
                    if not n.endswith(".bi")}
            worst = max(rest, key=rest.get)
            print(json.dumps({
                "arch": arch, "seed": seed, "worst_grad_leaf": worst,
                "worst_grad": rest[worst],
                "bi": max((v for n, v in g["grads"].items()
                           if n.endswith(".bi")), default=None),
                "params_share_of_limit": max(g["params"].values()),
                **{k: abs(out["card"][k] - out["cpu"][k]) / out["cpu"][k]
                   for k in ("loss", "grad_norm")},
                "lr_equal": out["card"]["lr"] == out["cpu"]["lr"]}),
                flush=True)
