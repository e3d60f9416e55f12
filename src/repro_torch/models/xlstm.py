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


def init_mlstm_state(cfg: ModelConfig, batch: int, device,
                     heads: int | None = None) -> dict:
    h, hd = cfg.n_heads if heads is None else heads, cfg.hd
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, h, hd, hd), **f32),
            "n": torch.zeros((batch, h, hd), **f32),
            "m": torch.full((batch, h), NEG, **f32)}


def _mlstm_heads(p: Params, cfg: ModelConfig, tp):
    """The rank's heads [h0, h1) where `wq`, `wk` and `wv` hold only them
    (the rules split the heads over the model axis), else None."""
    if tp is None or p["wq"].shape[1] == cfg.n_heads * cfg.hd:
        return None
    return tp.block(cfg.n_heads)


def _mlstm_qkv_gates(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     heads=None):
    """x (B, S, d) -> q, k, v (B, H, S, hd) and the log input and forget
    gates (B, H, S), all float32: H the heads `wq`, `wk`, `wv` hold; the
    gates of every head, or of heads [h0, h1) = `heads`."""
    b, s, _ = x.shape
    split = lambda t: t.view(b, s, -1, cfg.hd).float().transpose(1, 2)
    w = lambda name: layers.act(p[name], cfg)
    q = x @ w("wq")
    k = (x @ w("wk")) / math.sqrt(cfg.hd)
    v = x @ w("wv")
    # the bias adds unrounded: XLA drops their round trip through the
    # activation type before the float32 gate math.  Every head's gates,
    # then the rank's: a product of fewer columns may sum in another order
    li = (x @ w("wi")).float() + w("bi").float()
    lf = _logsig((x @ w("wf")).float() + w("bf").float())
    if heads is not None:
        li, lf = li[..., heads[0]:heads[1]], lf[..., heads[0]:heads[1]]
    return split(q), split(k), split(v), li.transpose(1, 2), lf.transpose(
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


def mlstm_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, state=None,
                tp=None):
    """Training / prefill: x (B, S, d) -> (y (B, S, d), the state after
    S).  With `tp` (the block's `collectives.ModelSplit`), the rank's
    heads where the rules split them (their q, k, v, gates, chunks and
    state; every head on every rank otherwise) and its output columns
    (`_mlstm_out`); the state is then of those heads
    (`mlstm_stored` lays it out as the cache is stored)."""
    b, s, d = x.shape
    if tp is not None:
        x = tp.enter(x)
    heads = _mlstm_heads(p, cfg, tp)
    if state is None:
        state = init_mlstm_state(cfg, b, x.device,
                                 None if heads is None
                                 else heads[1] - heads[0])
    q, k, v, li, lf = _mlstm_qkv_gates(p, x, cfg, heads)
    lc = chunk_len(s)
    hs = []
    for c0 in range(0, s, lc):
        sl = slice(c0, c0 + lc)
        h, state = mlstm_chunk(state, q[:, :, sl], k[:, :, sl], v[:, :, sl],
                               li[:, :, sl], lf[:, :, sl])
        hs.append(h)
    h = torch.cat(hs, dim=2).transpose(1, 2).reshape(b, s, -1)
    return _mlstm_out(p, x, h, cfg, tp), state


def _mlstm_out(p: Params, x, h, cfg: ModelConfig, tp=None):
    """The gated, normed output.  With `tp`, `wo_gate` and `out` hold the
    rank's columns of d: h of every head is cut to those columns (h of
    the rank's heads is those columns), h * o of the columns gathered
    over the model axis (2 B S d bytes in bf16), then the rank's output
    columns gathered (as many), which moves fewer bytes than summing
    row-split partial products in float32 (4 B S d) and keeps `out`'s
    gather at the rank's share."""
    h = headwise_rms(h, cfg).to(cfg.act_dtype)
    if tp is not None and h.shape[-1] == cfg.d_model:
        c0, c1 = tp.block(cfg.d_model)
        h = h[..., c0:c1]
    o = layers.sigmoid(x @ layers.act(p["wo_gate"], cfg))
    if tp is None:
        return (h * o) @ layers.act(p["out"], cfg)
    ho = tp.enter(tp.gather_last(h * o))
    return tp.gather_last(ho @ layers.act(p["out"], cfg))


def headwise_rms(h: torch.Tensor, cfg: ModelConfig, eps: float = 1e-6):
    """(B, S, d) -> RMS-normalised per head, float32."""
    b, s, d = h.shape
    hh = h.reshape(b, s, -1, cfg.hd).float()
    hh = hh * torch.rsqrt((hh * hh).mean(-1, keepdim=True) + eps)
    return hh.reshape(b, s, d)


def _update(state: dict, new: dict) -> dict:
    for name, t in new.items():
        state[name].copy_(t)
    return state


def mlstm_decode(p: Params, x: torch.Tensor, state: dict, cfg: ModelConfig,
                 tp=None):
    """x (B, 1, d) -> (y (B, 1, d), state), the state updated in place.
    With `tp`, every head's q, k and v (gathered over the model axis
    where the rank computes its heads' only) and gates; the step runs on
    the state as the rank stores it (`_mlstm_step_split` on its head-dim
    block, or the one-device step where the state is stored whole), and
    its output columns follow (`_mlstm_out`)."""
    if tp is not None:
        x = tp.enter(x)
    q, k, v, li, lf = _mlstm_qkv_gates(p, x, cfg)
    if _mlstm_heads(p, cfg, tp) is not None:
        q, k, v = tp.gather(torch.stack([q, k, v]), 2)
    q, k, v, li, lf = q[:, :, 0], k[:, :, 0], v[:, :, 0], li[:, :, 0], \
        lf[:, :, 0]
    if tp is None or state["n"].shape[-1] == cfg.hd:
        h_t, new = mlstm_step(q, k, v, li, lf, state)
    else:
        h_t, new = _mlstm_step_split(q, k, v, li, lf, state, tp, cfg)
    h = h_t.reshape(x.shape[0], 1, -1)
    return _mlstm_out(p, x, h, cfg, tp), _update(state, new)


def _mlstm_step_split(q_t, k_t, v_t, li_t, lf_t, state: dict, tp,
                      cfg: ModelConfig):
    """`mlstm_step` on a state whose key dim (C's last, n's) is split over
    the model axis: the rank updates its block of C and n, and the
    readout's two contractions over that dim (C q, n . q) are summed over
    the axis, (B, H, hd + 1) a step; m is whole on every rank."""
    k0, k1 = tp.block(cfg.hd)
    kq, kk = q_t[..., k0:k1], k_t[..., k0:k1]
    c, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf_t + m, li_t)
    i_p = torch.exp(li_t - m_new)
    f_p = torch.exp(lf_t + m - m_new)
    c = f_p[..., None, None] * c + i_p[..., None, None] * (
        v_t[..., :, None] * kk[..., None, :])
    n = f_p[..., None] * n + i_p[..., None] * kk
    part = torch.cat([torch.einsum("bhvk,bhk->bhv", c, kq),
                      torch.einsum("bhk,bhk->bh", n, kq)[..., None]], -1)
    tot = tp.leave(part, torch.float32)
    den = torch.maximum(tot[..., -1].abs(), torch.exp(-m_new))
    return tot[..., :-1] / den[..., None], {"C": c, "n": n, "m": m_new}


def mlstm_stored(state: dict, cfg: ModelConfig, tp) -> dict:
    """An mLSTM state from `mlstm_apply` with `tp` as the rank stores it
    (`sharding.cache_specs`): C's and n's key-dim block where the head
    dim divides the model axis, else whole; m whole.  A state of the
    rank's heads moves by one exchange a leaf (C, n: each rank sends each
    other its heads' block of that rank's key dims), or is gathered
    whole where the head dim does not divide."""
    size, hd = tp.size, cfg.hd
    if state["m"].shape[1] == cfg.n_heads:  # every head: cut
        if hd % size:
            return state
        k0, k1 = tp.block(hd)
        return {"C": state["C"][..., k0:k1].contiguous(),
                "n": state["n"][..., k0:k1].contiguous(), "m": state["m"]}
    m = tp.gather(state["m"], 1)
    if hd % size:
        return {"C": tp.gather(state["C"], 1), "n": tp.gather(state["n"], 1),
                "m": m}
    # global key-dim blocks of hd / size, numbered head-major: rank q
    # holds its heads' blocks and takes block q of every head
    hr = state["m"].shape[1]
    have = [tuple(range(q * hr * size, (q + 1) * hr * size))
            for q in range(size)]
    want = [tuple(h * size + q for h in range(cfg.n_heads))
            for q in range(size)]
    b = state["m"].shape[0]
    c = state["C"].transpose(1, 2).reshape(b, hd, hr * hd)
    c = tp.exchange(c, have, want).view(b, hd, cfg.n_heads, hd // size)
    n = tp.exchange(state["n"].reshape(b, hr * hd), have, want)
    return {"C": c.transpose(1, 2).contiguous(),
            "n": n.view(b, cfg.n_heads, hd // size), "m": m}


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


def init_slstm_state(cfg: ModelConfig, batch: int, device,
                     hd: int | None = None) -> dict:
    shape = (batch, cfg.n_heads, cfg.hd if hd is None else hd)
    z = lambda: torch.zeros(shape, dtype=torch.float32, device=device)
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full(shape, NEG, dtype=torch.float32, device=device)}


def slstm_step(pre_x_t: torch.Tensor, r: torch.Tensor, state: dict,
               tp=None):
    """pre_x_t (B, 4, H, hd) = W x_t + b, float32; r (H, hd, 4, hd), read
    in float32.  Returns (h_t (B, H, hd), the new state).  With the head
    dims split over the model axis (`tp`; the state and pre_x_t the
    rank's block, r the pair `_slstm_r` gives), h_prev's blocks are
    gathered over the axis (B d float32 a position) and the rank's block
    of the recurrent term is the whole contraction over them, as one
    device computes it (`_SplitRecurrence`)."""
    c, n, h_prev, m = state["c"], state["n"], state["h"], state["m"]
    if isinstance(r, tuple):  # (by output dims, stored rows): `_slstm_r`
        rec = _SplitRecurrence.apply(h_prev, r[0].float(), r[1].float(),
                                     tp)
    else:
        rec = torch.einsum("bhk,hkgj->bghj", h_prev, r.float())
    pre = pre_x_t + rec
    # each gate dense: the CPU's vectorized transcendentals then take
    # every element of a rank's narrow block as they take the whole's
    li, fraw, zraw, oraw = (g.contiguous() for g in pre.unbind(1))
    lf = _logsig(fraw)
    m_new = torch.maximum(lf + m, li)
    i_p = torch.exp(li - m_new)
    f_p = torch.exp(lf + m - m_new)
    c = f_p * c + i_p * torch.tanh(zraw)
    n = f_p * n + i_p
    h_t = torch.sigmoid(oraw) * c / torch.clamp(n, min=1e-6)
    return h_t, {"c": c, "n": n, "h": h_t, "m": m_new}


class _SplitRecurrence(torch.autograd.Function):
    """The rank's block of the recurrent term h_prev r over its output head
    dims: forward, h_prev's blocks (B, H, hd / n) gathered over the model
    axis and contracted whole with the rank's r (H, hd, 4, hd / n).
    Backward, the term's gradient blocks gathered (4 B d a position) and
    contracted whole with r's rows the rank stores, which gives its block
    of h_prev's gradient as one device computes it: the recurrence
    carries a rounding difference on to every later position, so it
    sums no partial terms over the axis.  r's gradient is the rank's own
    columns' (an exchange takes it to the stored rows)."""

    @staticmethod
    def forward(ctx, h_prev, r, rows, tp):
        h = tp.gather(h_prev, 2)
        ctx.tp = tp
        ctx.save_for_backward(h, r, rows)
        return torch.einsum("bhk,hkgj->bghj", h, r)

    @staticmethod
    def backward(ctx, g):
        h, r, rows = ctx.saved_tensors
        whole = ctx.tp.gather(g.contiguous(), 3)
        return (torch.einsum("bghj,hkgj->bhk", whole, rows),
                torch.einsum("bhk,bghj->hkgj", h, g), None, None)


def _rank_r(r: torch.Tensor, cfg: ModelConfig, tp) -> torch.Tensor:
    """The rank's recurrent weights by output head dim, (H, hd, 4, hd / n),
    from its stored block of input head dims (H, hd / n, 4, hd): one
    exchange of the rank's share (the rules split r's rows; the step
    contracts them whole).  Blocks are numbered (input block, output
    block); rank q holds (q, *) and takes (*, q)."""
    size, m = tp.size, cfg.hd // tp.size
    h = cfg.n_heads
    t = r.reshape(h, m, 4, size, m).permute(0, 2, 3, 1, 4).reshape(
        h, 4, size * m * m)
    t = tp.exchange(t, [tuple(q * size + j for j in range(size))
                        for q in range(size)],
                    [tuple(k * size + q for k in range(size))
                     for q in range(size)])
    return t.reshape(h, 4, size, m, m).permute(0, 2, 3, 1, 4).reshape(
        h, cfg.hd, 4, m)


def slstm_scan(pre: torch.Tensor, r: torch.Tensor, state: dict, tp=None):
    """`slstm_step` over the positions of pre (B, S, 4, H, hd): (h (B, S,
    H, hd), the state after them).  A dry run swaps this loop for spans
    of positions (`launch/dryrun.shape_only_paths`)."""
    hs = []
    for t in range(pre.shape[1]):
        h_t, state = slstm_step(pre[:, t], r, state, tp)
        hs.append(h_t)
    return torch.stack(hs, dim=1), state


def _slstm_pre(p: Params, x: torch.Tensor, cfg: ModelConfig, tp=None):
    """W x + b (B, S, 4, H, hd), float32; with `tp`, of the rank's block
    of the head dims (`w_in`'s columns)."""
    b, s, _ = x.shape
    bias = layers.act(p["b"], cfg)
    w = layers.act(p["w_in"], cfg)
    if tp is None:
        wx = x @ w
    else:
        j0, j1 = tp.block(cfg.hd)
        bias = bias.view(4, cfg.n_heads, cfg.hd)[..., j0:j1].reshape(-1)
        wx = tp.columns(x, w)
    pre = wx.float() + bias.float()  # unrounded, as XLA
    return pre.view(b, s, 4, cfg.n_heads, -1)


def _slstm_out(p: Params, h: torch.Tensor, cfg: ModelConfig, tp=None):
    """h (B, S, H, hd) normed per head, times `out`.  With `tp`, h's
    head-dim blocks are gathered over the model axis (4 B S d bytes:
    float32, the norm reads it unrounded) and the rank's output columns
    (`out`'s) gathered after (2 B S d in bf16)."""
    b, s = h.shape[:2]
    if tp is not None:
        h = tp.gather_last(h)
    hn = headwise_rms(h.reshape(b, s, -1), cfg).to(cfg.act_dtype)
    if tp is None:
        return hn @ layers.act(p["out"], cfg)
    return tp.gather_last(tp.columns(hn, layers.act(p["out"], cfg)))


def slstm_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, state=None,
                tp=None):
    """Training / prefill: x (B, S, d) -> (y (B, S, d), the state after
    S).  With `tp` (the block's `collectives.ModelSplit`: the rules split
    the head dims over the model axis), the rank's block of the head dims
    (`w_in`'s, r's output dims, the state's) and its output columns.
    Every contraction over the split dims is taken whole, forward and
    backward (`ModelSplit.columns`, `_SplitRecurrence`): the recurrence
    carries a rounding difference on to every later position, so the
    mixer computes as one device does, and x's gradient is whole on
    every rank (x enters no region)."""
    b, s, d = x.shape
    pre = _slstm_pre(p, x, cfg, tp)
    if state is None:
        state = init_slstm_state(cfg, b, x.device, pre.shape[-1])
    h, state = slstm_scan(pre, _slstm_r(p, cfg, tp), state, tp)
    return _slstm_out(p, h, cfg, tp), state


def _slstm_r(p: Params, cfg: ModelConfig, tp):
    """r as the step reads it: with `tp`, (the rank's output head dims,
    its stored rows), else r itself."""
    if tp is None:
        return p["r"]
    return _rank_r(p["r"], cfg, tp), p["r"]


def slstm_decode(p: Params, x: torch.Tensor, state: dict, cfg: ModelConfig,
                 tp=None):
    """x (B, 1, d) -> (y (B, 1, d), state), the state updated in place
    (with `tp`, as `slstm_apply` splits it)."""
    h_t, new = slstm_step(_slstm_pre(p, x, cfg, tp)[:, 0],
                          _slstm_r(p, cfg, tp), state, tp)
    return _slstm_out(p, h_t[:, None], cfg, tp), _update(state, new)
