"""AdamW with global-norm clipping and a linear-warmup, cosine-decay
schedule, on tensors keyed by name.

Port of `repro/optim/adamw.py`.  The arithmetic is the reference's, op for
op in float32: Python constants enter as float32 0-dim tensors (a jnp
weak-typed constant is rounded to the array's type; PyTorch on CUDA
divides by a Python scalar in neither of the two ways), and each sum and
product is taken in the reference's order.  `update` works in place on
the parameters and the moments (the reference donates both) and returns
them.  Moments may be held in bf16 (`moment_dtype`); they are updated in
float32 and rounded back, as the reference rounds them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a float32 0-dim tensor on `like`'s device."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio; step an integer
    tensor, the learning rate a float32 0-dim tensor."""
    c = lambda x: _f32(x, step)
    step = step.float()
    warm = torch.minimum(step / c(max(cfg.warmup_steps, 1)), c(1.0))
    frac = torch.clamp((step - c(cfg.warmup_steps))
                       / c(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = c(0.5) * (c(1.0) + torch.cos(c(math.pi) * frac))
    return (c(cfg.lr) * warm
            * (c(cfg.min_lr_ratio) + c(1 - cfg.min_lr_ratio) * cos))


def init(params: dict[str, torch.Tensor], cfg: AdamWConfig) -> dict:
    """{"m", "v": zeros like each parameter in `moment_dtype`, "step": an
    int32 0-dim tensor at 0}, on the parameters' device."""
    mdt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    dev = next(iter(params.values())).device
    return {"m": {n: zeros(p) for n, p in params.items()},
            "v": {n: zeros(p) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads, reduce=None) -> torch.Tensor:
    """sqrt of the float32 sum of squares, the leaves' totals added one
    after another in the order given (the reference's leaf order where
    the caller keeps it: `transformer.train_leaves`).  Over the shards of
    a mesh, `reduce` maps the vector of the rank's per-leaf totals to the
    leaves' global totals (`launch/collectives.Comm.reduce_sumsq`: each
    distinct shard counted once) before they are added."""
    sums = [g.float().square().sum() for g in grads]
    if reduce is not None:
        sums = reduce(torch.stack(sums)).unbind()
    total = None
    for sq in sums:
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def update(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
           state: dict, cfg: AdamWConfig,
           decays: Callable[[str, torch.Tensor], bool], reduce_sumsq=None):
    """One AdamW step, in place: (params, state, {"grad_norm", "lr"}).
    `decays(name, leaf)` says which leaves take weight decay.  The
    reference decays its leaves of two or more axes; a model's caller
    passes the rule that picks the same leaves in its own layout
    (`transformer.decays` for the LM's unstacked block leaves).

    On a mesh, params, grads and moments are the rank's shards, each
    updated in place in the reference's per-leaf op order, and
    `reduce_sumsq` makes the gradient norm the global one
    (`global_norm`)."""
    state["step"].add_(1)
    step = state["step"]
    c = lambda x: _f32(x, step)
    gnorm = global_norm([grads[n] for n in params], reduce_sumsq)
    scale = torch.minimum(c(1.0), c(cfg.clip_norm)
                          / torch.maximum(gnorm, c(1e-9)))
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = c(1.0) - torch.pow(c(b1), step.float())
    bc2 = c(1.0) - torch.pow(c(b2), step.float())
    k = {"b1": c(b1), "b2": c(b2), "1-b1": c(1 - b1), "1-b2": c(1 - b2),
         "eps": c(cfg.eps)}
    shrink = c(1.0) - lr * c(cfg.weight_decay)
    for name, p in params.items():
        _update_leaf(p, grads[name], state["m"][name], state["v"][name],
                     scale, lr, bc1, bc2, k,
                     shrink if decays(name, p) else None)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _update_leaf(p, g, m, v, scale, lr, bc1, bc2, k, shrink) -> None:
    """The reference's `upd` on one leaf, written into p, m and v:
    g *= scale; m = b1 m + (1 - b1) g; v = b2 v + ((1 - b2) g) g;
    p = p (1 - lr decay) - lr (m / bc1) / (sqrt(v / bc2) + eps), each op
    rounded to float32 (p * 1 skipped where there is no decay)."""
    g = g.float() * scale
    m32 = m if m.dtype == torch.float32 else m.float()
    v32 = v if v.dtype == torch.float32 else v.float()
    m32.mul_(k["b1"]).add_(k["1-b1"] * g)
    v32.mul_(k["b2"]).add_((k["1-b2"] * g).mul_(g))
    delta = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(k["eps"]))
    p32 = p if p.dtype == torch.float32 else p.float()
    if shrink is not None:
        p32.mul_(shrink)
    p32.sub_(delta.mul_(lr))
    for held, work in ((p, p32), (m, m32), (v, v32)):
        if work is not held:
            held.copy_(work)
