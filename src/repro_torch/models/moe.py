"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch.

Port of `repro/models/moe.py` for one device:

  1. router logits -> softmax -> top-k (probs renormalised over the k);
  2. the (tokens x k) assignments are sorted by expert id and packed into
     an (E, C, d) buffer of capacity C = ceil4(int(ceil(T*k/E) * 1.25))
     (at least 4); an assignment past its expert's C slots is dropped and
     its token keeps its residual stream (Switch-style);
  3. every expert's SwiGLU over all C of its slots, empty ones included,
     as one grouped product over the expert axis;
  4. each token's k results, times their routing weights, added in the
     activation type in ascending expert order;
  5. the shared expert, if any, densely over every token.

Dispatch is per batch row during training and prefill; a decode step with
more than one row routes the whole batch as one group (the reference's
`s == 1 and b > 1` branch).  The switch load-balancing loss, which only
training reads, is computed when the caller asks for it.

On a mesh of ranks (`set_moe_mesh`, which `launch/steps.py` calls) a rank
holds its batch rows.  Groups are batch rows in training and prefill, so
a rank routes them as the whole batch would; a decode step's one group is
the whole batch, so the rank gathers the batch's (B, 1, d) inputs over
the data-parallel ranks, routes them all and keeps its rows.  The switch
loss's means are the global batch's: the per-expert sums are summed over
the dp ranks (differentiably) before the product.  With the block's
`ModelSplit` (`tp`) the experts' hidden dim is split over the model
axis: routing, the dispatch buffer and the fixed-order combine run alike
on every model rank, the three grouped products over the rank's f
columns of every expert, and the combined partial outputs are summed
over the axis (float32 partials for 16-bit activations, combined in
float32: nothing is rounded before the sum).  The sum sits after the
combine, where the tensor is the tokens' (B, S, d), not the (E*C, d)
slots' (k times the capacity factor larger): so the routing weights,
whose gradients are then partial, enter the region with the dispatched
tokens, and the router's input does not, so that the router and the
switch loss see whole gradients.  The shared experts run through
`layers.mlp_apply` on their own split.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import layers
from repro_torch.models.layers import Params

# The mesh of the LM steps (set by launch.steps for a meshed step; None on
# one device): the data-parallel axes, the model axis and its size, and
# the rank's `launch/collectives.Comm`.
_MESH_CTX: dict = {"dp": None, "tp": None, "tp_size": 1, "comm": None}


def set_moe_mesh(dp_axes, tp_axis, tp_size: int, comm=None) -> None:
    _MESH_CTX.update(dp=dp_axes, tp=tp_axis, tp_size=int(tp_size),
                     comm=comm)


def clear_moe_mesh() -> None:
    _MESH_CTX.update(dp=None, tp=None, tp_size=1, comm=None)


@contextlib.contextmanager
def moe_mesh(dp_axes, tp_axis, tp_size: int, comm=None):
    """`set_moe_mesh` for the body of a meshed step, the context before it
    restored after (a one-device call in the same process must not find
    a mesh's Comm)."""
    saved = dict(_MESH_CTX)
    set_moe_mesh(dp_axes, tp_axis, tp_size, comm)
    try:
        yield
    finally:
        _MESH_CTX.update(saved)


def _split_rows():
    """The mesh's Comm when this rank's batch rows are a dp shard of the
    batch (else None)."""
    comm = _MESH_CTX["comm"]
    if comm is None or comm.dp_size == 1 or not comm.rows:
        return None
    return comm


def init_moe(gen, cfg: ModelConfig, moe: MoEConfig, device) -> Params:
    d, e, f = cfg.d_model, moe.n_experts, moe.d_expert
    dt = cfg.act_dtype
    p = {
        "router": layers.init_dense(gen, d, (e,), dt, device),
        "wg": _expert_stack(gen, e, d, f, dt, device),
        "wu": _expert_stack(gen, e, d, f, dt, device),
        "wd": _expert_stack(gen, e, f, d, dt, device),
    }
    if moe.d_shared:
        p["shared"] = layers.init_mlp(gen, cfg, device, d_ff=moe.d_shared)
    return Params(**p)


def _expert_stack(gen, e: int, in_dim: int, out_dim: int, dtype, device):
    """(E, in_dim, out_dim): each expert's matrix drawn by `init_dense`
    and cast one expert at a time (the float32 peak is one expert's)."""
    if device.type == "meta":
        return torch.empty((e, in_dim, out_dim), dtype=dtype, device=device)
    out = torch.empty((e, in_dim, out_dim), dtype=dtype, device=device)
    for i in range(e):
        out[i] = layers.init_dense(gen, in_dim, (out_dim,), dtype, device)
    return out


def capacity(tokens: int, moe: MoEConfig) -> int:
    """Slots per expert for a group of `tokens`: the reference's integer
    arithmetic, ceil(T*k/E) * capacity_factor truncated, rounded up to a
    multiple of 4, at least 4."""
    cap = int(-(-tokens * moe.top_k // moe.n_experts) * moe.capacity_factor)
    return max(4, -(-cap // 4) * 4)


class Routing(NamedTuple):
    """A group's routing.  `probs` (G, S, E): the router's float32
    softmax; `top_i`, `top_p` (G, S, k): the chosen experts and their
    renormalised float32 probabilities; then over the G rows' S*k
    assignments sorted by expert (stable): `order` the sort, `stok` each
    one's token, `sw` its weight in the activation type, `slot` its row
    of the (E*C) buffer (E*C when dropped), `keep` whether it holds one;
    `cap` is C."""
    probs: torch.Tensor
    top_i: torch.Tensor
    top_p: torch.Tensor
    order: torch.Tensor
    stok: torch.Tensor
    sw: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    cap: int


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values, as `jax.lax.top_k` orders them."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x: torch.Tensor, router: torch.Tensor, moe: MoEConfig) -> Routing:
    """Routing of x (G, S, d) in groups of S tokens (moe.py:117-142 of the
    reference)."""
    g, s, _ = x.shape
    e, k = moe.n_experts, moe.top_k
    probs = torch.softmax((x @ router.to(x.dtype)).float(), dim=-1)
    top_p, top_i = top_k(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    n = s * k
    cap = capacity(s, moe)
    flat_e = top_i.reshape(g, n)
    flat_w = top_p.reshape(g, n).to(x.dtype)
    flat_tok = torch.arange(s, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    sw = torch.gather(flat_w, 1, order)
    stok = flat_tok[order]
    # position within the expert's run: index less the run's first index
    first = torch.searchsorted(se, se, side="left")
    pos = torch.arange(n, device=x.device) - first
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, torch.full_like(se, e * cap))
    return Routing(probs, top_i, top_p, order, stok, sw, slot, keep, cap)


def groups(x: torch.Tensor) -> torch.Tensor:
    """The groups `moe_apply` routes x (B, S, d) in: each row, or, in a
    decode step over several rows (S = 1, B > 1), the batch as one group
    (1, B, d)."""
    b, s, _ = x.shape
    return x.transpose(0, 1) if s == 1 and b > 1 else x


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
              moe: MoEConfig, *, aux: bool = False, tp=None):
    """x (B, S, d) -> (B, S, d), routed in `groups(x)`; with `aux`, the
    pair (y, the switch load-balancing loss, a float32 scalar).  `tp`: the
    block's `ModelSplit` on a mesh, or None."""
    b, s, _ = x.shape
    comm = _split_rows()
    experts = None if tp is None else tp.of("ffn")
    if s == 1 and comm is not None:  # a decode step routes the whole batch
        y, r = _moe_groups(p, groups(comm.gather_rows(x)), moe, experts)
        y = comm.own_rows(y.transpose(0, 1))
    else:
        y, r = _moe_groups(p, groups(x), moe, experts)
        if s == 1 and b > 1:
            y = y.transpose(0, 1)
    if experts is not None:
        y = experts.leave(y, x.dtype)
    if "shared" in p:
        shared = None if tp is None else tp.of("shared")
        y = y + (layers.mlp_apply(p["shared"], x, cfg) if shared is None
                 else layers.mlp_apply(p["shared"], x, cfg, shared))
    return (y, aux_loss(r, moe)) if aux else y


def aux_loss(r: Routing, moe: MoEConfig) -> torch.Tensor:
    """The reference's switch loss (moe.py:121-126) in float32 over the
    group axes (G, S): the share of tokens that chose each expert (among
    its k) times the expert's mean router probability, summed, times
    `router_aux_weight * E`."""
    e = moe.n_experts
    experts = torch.arange(e, device=r.top_i.device)
    chose = (r.top_i[..., None] == experts).any(2).float()
    comm = _split_rows()
    if comm is None:
        density, mean_p = chose.mean((0, 1)), r.probs.mean((0, 1))
    else:  # the global batch's means: sums over the dp ranks, then / n
        n = chose.shape[0] * chose.shape[1] * comm.dp_size
        sums = comm.dp_sum(torch.stack([chose.sum((0, 1)),
                                        r.probs.sum((0, 1))]))
        density, mean_p = sums[0] / n, sums[1] / n
    return moe.router_aux_weight * e * (density * mean_p).sum()


def _moe_groups(p: Params, x: torch.Tensor, moe: MoEConfig, tp=None):
    """Routed experts over x (G, S, d) in groups of S tokens: (y, the
    routing); with `tp`, y is the rank's partial sum over its f columns
    (float32 for 16-bit activations)."""
    g, s, d = x.shape
    e, k = moe.n_experts, moe.top_k
    r = route(x, p["router"], moe)
    ec = e * r.cap
    rows = torch.arange(g, device=x.device)[:, None]
    sw = r.sw
    if tp is not None:
        x, sw = tp.enter(x), tp.enter(sw)

    # dispatch: a buffer of E*C + 1 rows, the last the dropped ones' sink
    buf = x.new_zeros((g, ec + 1, d))
    buf[rows, r.slot] = x[rows, r.stok]
    h = buf[:, :ec].reshape(g, e, r.cap, d)
    dt = x.dtype
    gate = layers.silu(torch.einsum("becd,edf->becf", h, p["wg"].to(dt)))
    up = torch.einsum("becd,edf->becf", h, p["wu"].to(dt))
    if tp is None:
        out_e = torch.einsum("becf,efd->becd", gate * up, p["wd"].to(dt))
    else:
        out_e = tp.product(gate * up, p["wd"].to(dt))

    # combine: back to the unsorted (token, j) layout, each token's k
    # results summed left to right in ascending expert order (the order
    # of the reference's scatter-add over expert-sorted assignments)
    flat_out = out_e.reshape(g, ec, d)
    got = flat_out[rows, torch.clamp(r.slot, max=ec - 1)]
    live = (r.keep & (r.sw > 0)).to(x.dtype)
    got = got * live[..., None] * sw[..., None]
    unsorted = torch.empty_like(got)
    unsorted[rows, r.order] = got
    unsorted = unsorted.view(g, s, k, d)
    by_expert = torch.argsort(r.top_i, dim=-1)
    unsorted = torch.gather(unsorted, 2,
                            by_expert[..., None].expand(-1, -1, -1, d))
    y = unsorted[:, :, 0]
    for j in range(1, k):
        y = y + unsorted[:, :, j]
    return y, r
