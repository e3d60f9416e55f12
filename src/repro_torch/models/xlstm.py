"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel prefill) and
sLSTM (scalar memory, sequential) [arXiv:2405.04517].

Port of `repro/models/xlstm.py`.  mLSTM training and prefill run the
chunkwise form (intra-chunk quadratic attention with log-gate decays,
inter-chunk (C, n, m) state, stabilised in log space) with the
reference's chunk length: `MLSTM_CHUNK`, halved until it divides S.  The
chunkwise form and the exact step round differently, so each path takes
the form the reference takes: chunks for training and prefill, the step
for decode.  sLSTM runs its step over the positions, its recurrent `r`
read in float32.  Training and prefill make new tensors at every chunk
and position, so autograd differentiates them.

Layout: the reference's (d, H, hd) `wq`/`wk`/`wv` and (d, 4, H, hd)
`w_in` are held as the matrices (d, H * hd) and (d, 4 * H * hd) of the
same contractions; weights are read through `layers.act`, the
reference's cast to the activation type at each use.  The decode
functions update their state in place.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.layers import Params

MLSTM_CHUNK = 64
NEG = -1e30

_logsig = torch.nn.functional.logsigmoid


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen, cfg: ModelConfig, device) -> Params:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    dt = cfg.act_dtype
    return Params(
        wq=layers.init_dense(gen, d, (h * hd,), dt, device),
        wk=layers.init_dense(gen, d, (h * hd,), dt, device),
        wv=layers.init_dense(gen, d, (h * hd,), dt, device),
        wi=layers.init_dense(gen, d, (h,), dt, device),
        wf=layers.init_dense(gen, d, (h,), dt, device),
        bi=torch.zeros(h, dtype=dt, device=device),
        bf=torch.full((h,), 3.0, dtype=dt, device=device),  # forget open
        wo_gate=layers.init_dense(gen, d, (d,), dt, device),
        out=layers.init_dense(gen, d, (d,), dt, device),
    )


def init_mlstm_state(cfg: ModelConfig, batch: int, device) -> dict:
    h, hd = cfg.n_heads, cfg.hd
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, h, hd, hd), **f32),
            "n": torch.zeros((batch, h, hd), **f32),
            "m": torch.full((batch, h), NEG, **f32)}


def _mlstm_qkv_gates(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) -> q, k, v (B, H, S, hd) and the log input and forget
    gates (B, H, S), all float32."""
    b, s, _ = x.shape
    heads = lambda t: t.view(b, s, cfg.n_heads, -1).float().transpose(1, 2)
    w = lambda name: layers.act(p[name], cfg)
    q = x @ w("wq")
    k = (x @ w("wk")) / math.sqrt(cfg.hd)
    v = x @ w("wv")
    # the bias adds unrounded: XLA drops their round trip through the
    # activation type before the float32 gate math
    li = (x @ w("wi")).float() + w("bi").float()
    lf = _logsig((x @ w("wf")).float() + w("bf").float())
    return heads(q), heads(k), heads(v), li.transpose(1, 2), lf.transpose(
        1, 2)


def mlstm_step(q_t, k_t, v_t, li_t, lf_t, state: dict):
    """The exact single-position recurrence.  q_t, k_t, v_t (B, H, hd);
    li_t, lf_t (B, H).  Returns (h_t (B, H, hd), the new state)."""
    c, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf_t + m, li_t)
    i_p = torch.exp(li_t - m_new)
    f_p = torch.exp(lf_t + m - m_new)
    c = f_p[..., None, None] * c + i_p[..., None, None] * (
        v_t[..., :, None] * k_t[..., None, :])  # (B, H, hd_v, hd_k)
    n = f_p[..., None] * n + i_p[..., None] * k_t
    num = torch.einsum("bhvk,bhk->bhv", c, q_t)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n, q_t).abs(),
                        torch.exp(-m_new))
    return num / den[..., None], {"C": c, "n": n, "m": m_new}


def mlstm_chunk(state: dict, q, k, v, li, lf):
    """The chunkwise-parallel form over one chunk.  q, k, v (B, H, L, hd);
    li, lf (B, H, L).  Returns (h (B, H, L, hd), the state at its end)."""
    c_in, n_in, m_in = state["C"], state["n"], state["m"]
    b_cum = torch.cumsum(lf, dim=-1)  # inclusive: b_t
    g_total = b_cum[..., -1]

    a_s = li - b_cum
    m_intra = b_cum + torch.cummax(a_s, dim=-1).values  # max over s <= t
    m_inter = m_in[..., None] + b_cum
    m_t = torch.maximum(m_intra, m_inter)

    # intra-chunk: D_ts = exp(li_s + b_t - b_s - m_t) for s <= t
    dmat = (li[..., None, :] + b_cum[..., :, None] - b_cum[..., None, :]
            - m_t[..., :, None])
    ls = li.shape[-1]
    causal = torch.ones((ls, ls), dtype=torch.bool, device=li.device).tril()
    dexp = torch.exp(torch.where(causal, dmat, NEG))
    qk = torch.einsum("bhld,bhsd->bhls", q, k)
    h_intra = torch.einsum("bhls,bhsd->bhld", qk * dexp, v)
    n_intra = torch.einsum("bhls,bhsd->bhld", dexp, k)

    # inter-chunk contribution
    w_inter = torch.exp(m_in[..., None] + b_cum - m_t)
    h_inter = torch.einsum("bhvk,bhlk->bhlv", c_in, q) * w_inter[..., None]
    n_inter = n_in[..., None, :] * w_inter[..., None]

    n_vec = n_intra + n_inter
    den = torch.maximum(torch.einsum("bhlk,bhlk->bhl", n_vec, q).abs(),
                        torch.exp(-m_t))
    h_out = (h_intra + h_inter) / den[..., None]

    # the state at the chunk's end
    m_out = torch.maximum(g_total + m_in,
                          (li + g_total[..., None] - b_cum).amax(-1))
    w_c = torch.exp(li + g_total[..., None] - b_cum - m_out[..., None])
    carry = torch.exp(g_total + m_in - m_out)
    c_out = carry[..., None, None] * c_in + torch.einsum(
        "bhl,bhlv,bhlk->bhvk", w_c, v, k)
    n_out = carry[..., None] * n_in + torch.einsum("bhl,bhlk->bhk", w_c, k)
    return h_out, {"C": c_out, "n": n_out, "m": m_out}


def chunk_len(s: int) -> int:
    """The reference's chunk: MLSTM_CHUNK, halved until it divides s."""
    lc = MLSTM_CHUNK
    while s % lc:
        lc //= 2
    return lc


def mlstm_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, state=None):
    """Training / prefill: x (B, S, d) -> (y (B, S, d), the state after
    S)."""
    b, s, d = x.shape
    if state is None:
        state = init_mlstm_state(cfg, b, x.device)
    q, k, v, li, lf = _mlstm_qkv_gates(p, x, cfg)
    lc = chunk_len(s)
    hs = []
    for c0 in range(0, s, lc):
        sl = slice(c0, c0 + lc)
        h, state = mlstm_chunk(state, q[:, :, sl], k[:, :, sl], v[:, :, sl],
                               li[:, :, sl], lf[:, :, sl])
        hs.append(h)
    h = torch.cat(hs, dim=2).transpose(1, 2).reshape(b, s, d)
    return _mlstm_out(p, x, h, cfg), state


def _mlstm_out(p: Params, x, h, cfg: ModelConfig):
    h = headwise_rms(h, cfg).to(cfg.act_dtype)
    o = layers.sigmoid(x @ layers.act(p["wo_gate"], cfg))
    return (h * o) @ layers.act(p["out"], cfg)


def headwise_rms(h: torch.Tensor, cfg: ModelConfig, eps: float = 1e-6):
    """(B, S, d) -> RMS-normalised per head, float32."""
    b, s, d = h.shape
    hh = h.reshape(b, s, cfg.n_heads, cfg.hd).float()
    hh = hh * torch.rsqrt((hh * hh).mean(-1, keepdim=True) + eps)
    return hh.reshape(b, s, d)


def _update(state: dict, new: dict) -> dict:
    for name, t in new.items():
        state[name].copy_(t)
    return state


def mlstm_decode(p: Params, x: torch.Tensor, state: dict, cfg: ModelConfig):
    """x (B, 1, d) -> (y (B, 1, d), state), the state updated in place."""
    q, k, v, li, lf = _mlstm_qkv_gates(p, x, cfg)
    h_t, new = mlstm_step(q[:, :, 0], k[:, :, 0], v[:, :, 0], li[:, :, 0],
                          lf[:, :, 0], state)
    h = h_t.reshape(x.shape[0], 1, -1)
    return _mlstm_out(p, x, h, cfg), _update(state, new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen, cfg: ModelConfig, device) -> Params:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    dt = cfg.act_dtype
    pdt = getattr(torch, cfg.param_dtype)
    if device.type == "meta":
        r = torch.empty((h, hd, 4, hd), dtype=torch.float32, device=device)
    else:  # drawn in the parameter type, used in float32
        r = (torch.randn((h, hd, 4, hd), generator=gen, dtype=torch.float32,
                         device=device) / math.sqrt(hd)).to(pdt).float()
    b = torch.zeros((4, h * hd), dtype=dt, device=device)
    b[1] = 3.0  # forget-gate bias
    return Params(
        w_in=layers.init_dense(gen, d, (4 * h * hd,), dt, device),
        r=r,
        b=b.reshape(-1),
        out=layers.init_dense(gen, d, (d,), dt, device),
    )


def init_slstm_state(cfg: ModelConfig, batch: int, device) -> dict:
    shape = (batch, cfg.n_heads, cfg.hd)
    z = lambda: torch.zeros(shape, dtype=torch.float32, device=device)
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full(shape, NEG, dtype=torch.float32, device=device)}


def slstm_step(pre_x_t: torch.Tensor, r: torch.Tensor, state: dict):
    """pre_x_t (B, 4, H, hd) = W x_t + b, float32; r (H, hd, 4, hd), read
    in float32.  Returns (h_t (B, H, hd), the new state)."""
    c, n, h_prev, m = state["c"], state["n"], state["h"], state["m"]
    pre = pre_x_t + torch.einsum("bhk,hkgj->bghj", h_prev, r.float())
    li, fraw, zraw, oraw = pre[:, 0], pre[:, 1], pre[:, 2], pre[:, 3]
    lf = _logsig(fraw)
    m_new = torch.maximum(lf + m, li)
    i_p = torch.exp(li - m_new)
    f_p = torch.exp(lf + m - m_new)
    c = f_p * c + i_p * torch.tanh(zraw)
    n = f_p * n + i_p
    h_t = torch.sigmoid(oraw) * c / torch.clamp(n, min=1e-6)
    return h_t, {"c": c, "n": n, "h": h_t, "m": m_new}


def _slstm_pre(p: Params, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    pre = ((x @ layers.act(p["w_in"], cfg)).float()
           + layers.act(p["b"], cfg).float())  # unrounded, as XLA
    return pre.view(b, s, 4, cfg.n_heads, cfg.hd)


def _slstm_out(p: Params, h: torch.Tensor, cfg: ModelConfig):
    return headwise_rms(h, cfg).to(cfg.act_dtype) @ layers.act(p["out"], cfg)


def slstm_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, state=None):
    """Training / prefill: x (B, S, d) -> (y (B, S, d), the state after
    S)."""
    b, s, d = x.shape
    if state is None:
        state = init_slstm_state(cfg, b, x.device)
    pre = _slstm_pre(p, x, cfg)
    hs = []
    for t in range(s):
        h_t, state = slstm_step(pre[:, t], p["r"], state)
        hs.append(h_t)
    h = torch.stack(hs, dim=1).reshape(b, s, d)
    return _slstm_out(p, h, cfg), state


def slstm_decode(p: Params, x: torch.Tensor, state: dict, cfg: ModelConfig):
    """x (B, 1, d) -> (y (B, 1, d), state), the state updated in place."""
    h_t, new = slstm_step(_slstm_pre(p, x, cfg)[:, 0], p["r"], state)
    return (_slstm_out(p, h_t.reshape(x.shape[0], 1, -1), cfg),
            _update(state, new))
