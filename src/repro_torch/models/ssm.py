"""Mamba selective-SSM block (Jamba's sequence mixer).

Port of `repro/models/ssm.py`.  The reference chunks its training and
prefill scan (`CHUNK` positions a `lax.scan` step) to bound live memory
under remat; the recurrence inside is the same step in position order,
so here training and prefill run a loop over positions of that step
(autograd differentiates it: each step makes new tensors), and decode is
the same step at S = 1.

Types follow the reference: the projections and the causal convolution
in the activation type (the convolution a sum over its `ssm_conv`
shifted slices, j ascending); `dt_bias` held in the parameter type and
added in float32; `a_log`, `d_skip` and the recurrent state float32.
The state is `{"conv": (B, K-1, d_inner) act, "ssm": (B, d_inner, n)
float32}`; `mamba_decode` updates it in place.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.layers import Params


def init_mamba(gen, cfg: ModelConfig, device) -> Params:
    d, di, n, r, kc = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                       cfg.ssm_conv)
    dt = cfg.act_dtype
    pdt = getattr(torch, cfg.param_dtype)
    a = torch.arange(1, n + 1, dtype=torch.float32, device=device).expand(
        di, n)
    if device.type == "meta":
        conv_w = torch.empty((kc, di), dtype=dt, device=device)
    else:
        conv_w = (torch.randn((kc, di), generator=gen, dtype=torch.float32,
                              device=device) / math.sqrt(kc)).to(dt)
    return Params(
        in_proj=layers.init_dense(gen, d, (2 * di,), dt, device),
        conv_w=conv_w,
        conv_b=torch.zeros(di, dtype=dt, device=device),
        x_proj=layers.init_dense(gen, di, (r + 2 * n,), dt, device),
        dt_proj=layers.init_dense(gen, r, (di,), dt, device),
        dt_bias=torch.full((di,), -4.6, dtype=pdt, device=device),
        a_log=torch.log(a).contiguous(),
        d_skip=torch.ones(di, dtype=torch.float32, device=device),
        out_proj=layers.init_dense(gen, di, (d,), dt, device),
    )


def init_mamba_state(cfg: ModelConfig, batch: int, device,
                     d_inner: int | None = None) -> dict:
    """The zero state; `d_inner` channels (a model rank's block, all of
    them by default)."""
    di = cfg.d_inner if d_inner is None else d_inner
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di),
                            dtype=cfg.act_dtype, device=device),
        "ssm": torch.zeros((batch, di, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


def ssm_step(h, x_t, dt_t, b_t, c_t, a):
    """One recurrence step.  h (B, di, n) float32; x_t (B, di), b_t, c_t
    (B, n) in the activation type; dt_t (B, di) float32; a (di, n)
    negative float32.  Returns (h_new, y_t (B, di) float32)."""
    da = torch.exp(dt_t[..., None] * a[None])
    drive = (dt_t * x_t.float())[..., None] * b_t.float()[:, None, :]
    h = h * da + drive
    return h, (h * c_t.float()[:, None, :]).sum(-1)


def scan(h, xs, dts, bs, cs, a):
    """`ssm_step` over the positions of xs (B, S, di): (the state after
    them, ys (B, S, di) float32).  A dry run swaps this loop for spans of
    positions (`launch/dryrun.shape_only_paths`)."""
    ys = []
    for t in range(xs.shape[1]):
        h, y = ssm_step(h, xs[:, t], dts[:, t], bs[:, t], cs[:, t], a)
        ys.append(y)
    return h, torch.stack(ys, dim=1)


def _rank_channels(xz: torch.Tensor, tp):
    """A model rank's d_inner channels of x and of z from its stored
    columns of in_proj's product: in_proj (d, 2 di) splits by column, so
    with the axis of n ranks, rank q holds blocks 2q and 2q + 1 of the
    2n blocks of di / n columns (x's blocks first, then z's), and
    computes on x's block q and z's block n + q (one exchange)."""
    n = tp.size
    xz = tp.exchange(xz, [(2 * q, 2 * q + 1) for q in range(n)],
                     [(q, n + q) for q in range(n)])
    w = xz.shape[-1] // 2
    return xz[..., :w], xz[..., w:]


def _pre_scan(p: Params, x: torch.Tensor, cfg: ModelConfig, conv_tail,
              tp=None):
    """in_proj, the causal depthwise convolution over the carried-in tail
    (B, K-1, di) and the new positions, silu, and the parameter
    projections.  Returns (xs, xs unrounded in float32, dts, bs, cs, z,
    new_tail).  With `tp`, of the rank's channels: x_proj's row-split
    product is summed over the model axis (and re-entered: each rank
    reads dt, B and C for its own channels)."""
    di, n, r, kc = cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    s = x.shape[1]
    xz = x @ layers.act(p["in_proj"], cfg)
    if tp is None:
        xs, z = xz[..., :di], xz[..., di:]
    else:
        xs, z = _rank_channels(xz, tp)
    ext = torch.cat([conv_tail, xs], dim=1)  # (B, K-1+S, di)
    new_tail = ext[:, ext.shape[1] - (kc - 1):]
    conv_w = layers.act(p["conv_w"], cfg)
    conv = sum(conv_w[j] * ext[:, j:j + s] for j in range(kc))
    conv = conv + layers.act(p["conv_b"], cfg)
    # silu's last product unrounded: XLA fuses it into the float32 skip
    # term `d_skip * xs` (its bf16 -> float32 convert pair removed), and
    # rounds it to the activation type where xs is stored for the rest
    xs_f32 = conv.float() * layers.sigmoid(conv).float()
    xs = xs_f32.to(conv.dtype)
    if tp is None:
        dbl = xs @ layers.act(p["x_proj"], cfg)
    else:
        dbl = tp.enter(tp.leave(tp.product(xs, layers.act(p["x_proj"],
                                                          cfg)), xs.dtype))
    dt_r, b, c = dbl[..., :r], dbl[..., r:r + n], dbl[..., r + n:]
    dts = torch.nn.functional.softplus((dt_r @ layers.act(p["dt_proj"], cfg))
                                       .float()
                                       + p["dt_bias"].float())
    return xs, xs_f32, dts, b, c, z, new_tail


def _out(p: Params, ys: torch.Tensor, xs_f32, z, cfg: ModelConfig, tp=None):
    y = (ys + p["d_skip"] * xs_f32).to(cfg.act_dtype) * layers.silu(z)
    if tp is None:
        return y @ layers.act(p["out_proj"], cfg)
    return tp.leave(tp.product(y, layers.act(p["out_proj"], cfg)), y.dtype)


def mamba_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, state=None,
                tp=None):
    """Training / prefill: x (B, S, d) -> (y (B, S, d), the state after
    S).  With `tp` (the block's `collectives.ModelSplit`), the rank's
    d_inner channels: conv, scan and state of those channels, the two
    products that contract d_inner (x_proj's, out_proj's) summed over
    the model axis."""
    if tp is not None:
        x = tp.enter(x)
    if state is None:
        state = init_mamba_state(cfg, x.shape[0], x.device,
                                 p["conv_b"].shape[0])
    xs, xs_f32, dts, bs, cs, z, tail = _pre_scan(p, x, cfg, state["conv"],
                                                 tp)
    h, ys = scan(state["ssm"], xs, dts, bs, cs, -torch.exp(p["a_log"]))
    out = _out(p, ys, xs_f32, z, cfg, tp)
    return out, {"conv": tail.contiguous(), "ssm": h}


def mamba_decode(p: Params, x: torch.Tensor, state: dict,
                 cfg: ModelConfig, tp=None):
    """x (B, 1, d) -> (y (B, 1, d), state), the state updated in place
    (with `tp`, the rank's channels of it)."""
    if tp is not None:
        x = tp.enter(x)
    xs, xs_f32, dts, bs, cs, z, tail = _pre_scan(p, x, cfg, state["conv"],
                                                 tp)
    a = -torch.exp(p["a_log"])
    h, y = ssm_step(state["ssm"], xs[:, 0], dts[:, 0], bs[:, 0], cs[:, 0], a)
    out = _out(p, y[:, None], xs_f32, z, cfg, tp)
    state["conv"].copy_(tail)
    state["ssm"].copy_(h)
    return out, state
