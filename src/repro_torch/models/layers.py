"""Transformer substrate: RMSNorm, RoPE, flash attention (plain torch, online
softmax over KV chunks, with its hand-written backward), GQA attention
blocks (train/prefill and decode), SwiGLU.

Port of `repro/models/layers.py`.  Attention is not a Pallas kernel in the
reference: it is a jnp `custom_vjp`, and it stays plain torch here, a
`torch.autograd.Function`, as do the projections.  The port follows the
reference's algorithm (the same chunked online softmax, float32 scores,
running max and sum, the same casts; the backward recomputing each
chunk's probabilities from the saved log-sum-exp), so that the tests can
hold it tightly against the reference.

Weights live in `Params` modules, read as `p["wq"]` and `"bq" in p`, the
reference's dict idiom.  Layout: the reference keeps `wq` as (d, H, hd)
and `wo` as (H, hd, d); here they are the 2-D matrices (d, H * hd) and
(H * hd, d) of the same contraction, so each projection is one matmul.
Every weight is read through `act(w, cfg)`, the reference's cast to the
activation type at each use (`.astype(dt)`).  A serving model holds those
weights once in that type, so the cast is the tensor itself; a training
model holds them in the parameter type (`transformer.init_model(...,
train=True)`), and the cast's gradient reaches the leaf in that type.
The norm weights are read in float32, as the reference reads them.

On a mesh (`launch/collectives.py`) attention and the MLP take `tp`, the
block's `ModelSplit` over the model axis, or None: the weights are then
the rank's heads or columns (`wq`, `bq` and `wo`'s rows by query head,
`wk`/`wv`/`bk`/`bv` by KV head or whole when the KV heads do not divide
the axis, `wg`/`wu` by column and `wd` by row), the input enters the
region and the partial output of the row-split product (float32 for
16-bit activations) leaves it summed over the axis.  Decode attention
takes `seq`, a `collectives.SeqSplit`, where the cache is split by
sequence over the ranks: it attends over the rank's slots and merges
the ranks' partial softmaxes.  With `tp` and `seq` None every op is the
one-device op.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from typing import NamedTuple

from repro_torch.configs.base import ModelConfig

NEG_INF = -1e30


class Params(nn.Module):
    """Named weights and sub-trees of one part of a model: tensors become
    parameters, frozen (`requires_grad=False`) until a training build sets
    them trainable; modules become sub-modules.  Read as `p["wq"]`; `"bq"
    in p` says whether an optional weight exists."""

    def __init__(self, **entries):
        super().__init__()
        for name, value in entries.items():
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def init_dense(gen: torch.Generator | None, in_dim: int,
               out_shape: tuple[int, ...], dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """A float32 normal (in_dim, *out_shape) draw times 1/sqrt(in_dim), cast
    to `dtype` (the reference's `init_dense`, with a torch generator: the
    two packages' random streams differ, so tests hand both the same
    weights through `convert.lm_params_from_reference`).  On the `meta`
    device, an empty tensor of the shape."""
    shape = (in_dim, *out_shape)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def accumulate_in_float32() -> None:
    """Have cuBLAS reduce 16-bit products in float32, as the reference's
    XLA dots accumulate.  PyTorch's default lets a split-K GEMM reduce its
    partial sums in bf16; on the card that doubled xlstm-350m's bf16
    decode-against-forward gap (10.4% of the largest |logit| against 4.5%,
    `tools/lm_bf16.py gap` on an H100 80GB HBM3 at 700 W).  The setting is
    the process's; the LM builders make it."""
    matmul = torch.backends.cuda.matmul
    matmul.allow_bf16_reduced_precision_reduction = False
    matmul.allow_fp16_reduced_precision_reduction = False


def act(w: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A weight in the activation type, the reference's `.astype(dt)` at
    each use: the tensor itself where it is held in that type (a serving
    model: no copy, no launch), a cast otherwise (a training leaf in the
    parameter type, whose gradient the cast converts back to it)."""
    return w.to(cfg.act_dtype)


def embed_rows(w: torch.Tensor, tokens: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Rows `tokens` of embedding table `w` in the activation type,
    looked up in the wider of the table's type and the activation type:
    the forward is the same either way, and the gradient sums a token's
    repeats in that type (a bf16 sum over a Zipf batch's repeats of its
    commonest tokens loses a tenth of their gradient)."""
    if w.dtype.itemsize >= cfg.act_dtype.itemsize:
        return act(w[tokens], cfg)
    return act(w, cfg)[tokens]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def add_rms_norm(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                 eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(x + y, rms_norm(x + y)) with the norm taken of the sum unrounded
    in float32, as XLA computes the reference's residual add and the norm
    after it in one fusion (the sum's round trip through the activation
    type removed), the returned sum rounded to x's type."""
    s = x.float() + y.float()
    h = s * torch.rsqrt((s * s).mean(-1, keepdim=True) + eps)
    return s.to(x.dtype), (h * w.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x (..., S, H, D), positions (..., S) -> rotated x (half-split layout),
    computed in float32."""
    d_half = x.shape[-1] // 2
    exponent = -torch.arange(0, d_half, dtype=torch.float32,
                             device=x.device) / d_half
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
                                 device=x.device), exponent)
    angles = positions[..., None].float() * freqs  # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1f, x2f = x[..., :d_half].float(), x[..., d_half:].float()
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# flash attention (plain torch): a loop over KV chunks with online softmax
# ---------------------------------------------------------------------------


def _pick_chunk(s: int, target: int) -> int:
    """Largest power-of-two divisor of s, capped at target."""
    c = 1
    while c < target and s % (2 * c) == 0:
        c *= 2
    return c if s % c == 0 else s


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D), already scaled & roped
    k: torch.Tensor,  # (B, Skv, KVH, D)
    v: torch.Tensor,  # (B, Skv, KVH, D)
    q_offset: int = 0,  # absolute position of q[0]
    window: int = 0,  # >0: chunked-local attention (same-chunk mask)
    q_chunk: int = 512,
    kv_chunk: int = 512,
) -> torch.Tensor:
    """Online-softmax attention with the reference's hand-written
    backward: a loop over KV chunks carrying the float32 running max, sum
    and output, so the (Sq, Skv) scores never exist whole.  The query
    heads are grouped over the KV heads (group-major), as the reference's
    (kvh, g) reshape groups them.

    It runs as `_FlashAttention`: autograd never records the chunk loop
    (which would keep O(Skv / kv_chunk) copies of the carries); the
    residuals are q, k, v, the output and the log-sum-exp, and the
    backward recomputes each chunk's probabilities from them.  Where no
    gradient is wanted, no graph is built and the residuals are dropped
    when the call returns."""
    return _FlashAttention.apply(q, k, v, q_offset, window, q_chunk,
                                 kv_chunk)


class _FlashAttention(torch.autograd.Function):
    """The reference's `flash_attention` `custom_vjp`: `_flash_fwd` saves
    (q, k, v, out, lse), `_flash_bwd` differentiates chunk by chunk."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, window, q_chunk, kv_chunk):
        out, lse = _flash_fwd_impl(q, k, v, q_offset, window, q_chunk,
                                   kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.geom = (q_offset, window, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _flash_bwd(*ctx.saved_tensors, dout, *ctx.geom)
        return dq, dk, dv, None, None, None, None


def _flash_geom(q, k, q_chunk, kv_chunk):
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qc = _pick_chunk(sq, min(q_chunk, sq))
    kc = _pick_chunk(skv, min(kv_chunk, skv))
    return b, sq, h, d, skv, kvh, g, qc, kc


def _mask_for(q_pos, k_pos, window):
    """q_pos (nq, qc), k_pos (kc,) -> (nq, qc, kc) bool."""
    mask = q_pos[:, :, None] >= k_pos[None, None, :]
    if window:
        mask &= (q_pos[:, :, None] // window) == (k_pos[None, None, :]
                                                  // window)
    return mask


def _flash_fwd_impl(q, k, v, q_offset, window, q_chunk, kv_chunk):
    b, sq, h, d, skv, kvh, g, qc, kc = _flash_geom(q, k, q_chunk, kv_chunk)
    nq, nk = sq // qc, skv // kc
    dev = q.device
    # float32 operands: the reference's products of the working type with
    # float32 accumulation and output (preferred_element_type=float32)
    qr = q.reshape(b, nq, qc, kvh, g, d).float()
    kr = k.reshape(b, nk, kc, kvh, d).float()
    vr = v.reshape(b, nk, kc, kvh, d)
    q_pos = q_offset + torch.arange(sq, device=dev).reshape(nq, qc)
    m = torch.full((b, nq, qc, kvh, g), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, nq, qc, kvh, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, nq, qc, kvh, g, d), dtype=torch.float32,
                      device=dev)
    for j in range(nk):
        k_c, v_c = kr[:, j], vr[:, j]
        kpos = torch.arange(j * kc, (j + 1) * kc, device=dev)
        s = torch.einsum("bnqhgd,bkhd->bnqhgk", qr, k_c)
        mask = _mask_for(q_pos, kpos, window)
        s = torch.where(mask[None, :, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bnqhgk,bkhd->bnqhgd", p.to(v.dtype).float(),
                          v_c.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    lse = m + torch.log(torch.clamp(l, min=1e-30))  # (b, nq, qc, kvh, g)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, h, d).to(q.dtype), lse


def _flash_bwd(q, k, v, out, lse, dout, q_offset, window, q_chunk,
               kv_chunk):
    """(dq, dk, dv) in the inputs' types: the reference's `_flash_bwd`.
    delta = sum(dout * out) per query; per KV chunk the exact
    probabilities p = exp(s - lse), ds = p * (dp - delta); dq accumulates
    in float32 across the chunks, dk and dv are each chunk's own.  The
    reference repeats each KV head over its group and sums the group in
    the repeat's transpose; here the grouped products sum it inside the
    einsum (a reordering of float32 sums)."""
    b, sq, h, d, skv, kvh, g, qc, kc = _flash_geom(q, k, q_chunk, kv_chunk)
    nq, nk = sq // qc, skv // kc
    dev = q.device
    qr = q.reshape(b, nq, qc, kvh, g, d).float()
    kr = k.reshape(b, nk, kc, kvh, d).float()
    vr = v.reshape(b, nk, kc, kvh, d).float()
    dor = dout.reshape(b, nq, qc, kvh, g, d).float()
    our = out.reshape(b, nq, qc, kvh, g, d).float()
    q_pos = q_offset + torch.arange(sq, device=dev).reshape(nq, qc)
    delta = (dor * our).sum(-1)  # (b, nq, qc, kvh, g)
    dq = torch.zeros((b, nq, qc, kvh, g, d), dtype=torch.float32,
                     device=dev)
    dks, dvs = [], []
    for j in range(nk):
        k_c, v_c = kr[:, j], vr[:, j]
        kpos = torch.arange(j * kc, (j + 1) * kc, device=dev)
        s = torch.einsum("bnqhgd,bkhd->bnqhgk", qr, k_c)
        mask = _mask_for(q_pos, kpos, window)
        s = torch.where(mask[None, :, :, None, None, :], s, NEG_INF)
        p = torch.exp(s - lse[..., None])  # exact probabilities
        dp = torch.einsum("bnqhgd,bkhd->bnqhgk", dor, v_c)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bnqhgk,bkhd->bnqhgd", ds, k_c)
        dks.append(torch.einsum("bnqhgk,bnqhgd->bkhd", ds, qr))
        dvs.append(torch.einsum("bnqhgk,bnqhgd->bkhd", p, dor))
    dk = torch.stack(dks, dim=1).reshape(b, skv, kvh, d).to(k.dtype)
    dv = torch.stack(dvs, dim=1).reshape(b, skv, kvh, d).to(v.dtype)
    return dq.reshape(b, sq, h, d).to(q.dtype), dk, dv


def attention_reference(q, k, v, *, q_offset=0, window=0):
    """Naive oracle for flash_attention (test use only)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qr = q.reshape(b, sq, kvh, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k).float()
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    mask = q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= (q_pos[:, None] // window) == (k_pos[None, :] // window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return o.reshape(b, sq, h, d)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------


def head_geometry(cfg: ModelConfig, device="cpu"):
    """(hp, kvp, g_pad, q_head_mask) — the reference's padded-head layout.

    With attn_pad_heads set, query heads are padded group-major (each KV
    group gains pad slots) so GQA group assignment is unchanged; pad heads
    are masked to zero after attention, keeping the math identical to the
    unpadded architecture.  The mask is a bool tensor on `device`."""
    h, kvh, pad = cfg.n_heads, cfg.n_kv_heads, cfg.attn_pad_heads
    if not pad or pad == h:
        return h, kvh, h // kvh, None
    if kvh == h:  # MHA: pad q and kv together
        return pad, pad, 1, torch.arange(pad, device=device) < h
    if pad % kvh:
        raise ValueError("attn_pad_heads must preserve KV grouping")
    g, g_pad = h // kvh, pad // kvh
    return pad, kvh, g_pad, (torch.arange(pad, device=device) % g_pad) < g


def init_attention(gen, cfg: ModelConfig, device: torch.device) -> Params:
    d, hd = cfg.d_model, cfg.hd
    hp, kvp, _, _ = head_geometry(cfg)
    dt = cfg.act_dtype
    p = {
        "wq": init_dense(gen, d, (hp * hd,), dt, device),
        "wk": init_dense(gen, d, (kvp * hd,), dt, device),
        "wv": init_dense(gen, d, (kvp * hd,), dt, device),
        "wo": init_dense(gen, hp * hd, (d,), dt, device),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", hp), ("bk", kvp), ("bv", kvp)):
            p[name] = torch.zeros(heads * hd, dtype=dt, device=device)
    return Params(**p)


class RankHeads(NamedTuple):
    """A model rank's attention heads in the padded group-major layout:
    query heads [q0, q1) and the KV heads [kv0, kv1) their groups read.
    `kv_split`: wk/wv hold exactly those KV heads (the KV heads divide
    the model axis), else they are whole and the rank slices them.
    `kv_index`: None when the query heads are whole groups of those KV
    heads (the grouped flash loop reads them as they are), else each
    query head's KV head (local), for a K/V read per query head.
    `qmask`: the pad-head mask of [q0, q1), or None."""
    q0: int
    q1: int
    kv0: int
    kv1: int
    kv_split: bool
    kv_index: torch.Tensor | None
    qmask: torch.Tensor | None


def _kv_range(hp: int, g_pad: int, size: int, index: int):
    q0, q1 = index * hp // size, (index + 1) * hp // size
    return q0, q1, q0 // g_pad, (q1 - 1) // g_pad + 1


def rank_heads(cfg: ModelConfig, tp, device="cpu") -> RankHeads:
    """The heads of model rank `tp.index` of `tp.size` (`tp` a
    `collectives.ModelSplit`)."""
    hp, kvp, g_pad, qmask = head_geometry(cfg, device)
    q0, q1, kv0, kv1 = _kv_range(hp, g_pad, tp.size, tp.index)
    local = [q // g_pad - kv0 for q in range(q0, q1)]
    m, n = q1 - q0, kv1 - kv0
    grouped = m % n == 0 and local == [j // (m // n) for j in range(m)]
    return RankHeads(q0, q1, kv0, kv1, kvp % tp.size == 0,
                     None if grouped else torch.tensor(local, device=device),
                     None if qmask is None else qmask[q0:q1])


def whole_kv(cache: dict, cfg: ModelConfig, tp) -> dict:
    """K/V {"k", "v"} (..., kv heads, hd) of this rank's KV heads as every
    KV head, gathered over the model axis (one gather of both): the
    ranks' blocks when the KV heads divide the axis, else each head from
    the first rank that computed it (blocks padded to the largest)."""
    hp, kvp, g_pad, _ = head_geometry(cfg)
    kv = torch.stack([cache["k"], cache["v"]])
    dim = kv.ndim - 2
    if kvp % tp.size == 0:
        kv = tp.gather(kv, dim)
        return {"k": kv[0], "v": kv[1]}
    ranges = [_kv_range(hp, g_pad, tp.size, r)[2:] for r in range(tp.size)]
    n = max(b - a for a, b in ranges)
    pad = [0, 0] * (kv.ndim - 1 - dim) + [0, n - kv.shape[dim]]
    kv = tp.gather(torch.nn.functional.pad(kv, pad), dim)
    src = [next(r * n + h - a for r, (a, b) in enumerate(ranges) if a <= h < b)
           for h in range(kvp)]
    kv = kv.index_select(dim, torch.tensor(src, device=kv.device))
    return {"k": kv[0], "v": kv[1]}


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
         heads: RankHeads | None = None):
    b, s, _ = x.shape
    hd = cfg.hd
    wk, wv = p["wk"], p["wv"]
    bias = "bq" in p
    if bias:
        bk, bv = p["bk"], p["bv"]
    if heads is not None and not heads.kv_split:  # whole: the rank's heads
        cols = slice(heads.kv0 * hd, heads.kv1 * hd)
        wk, wv = wk[:, cols], wv[:, cols]
        if bias:
            bk, bv = bk[cols], bv[cols]
    q, k, v = (x @ act(p["wq"], cfg), x @ act(wk, cfg), x @ act(wv, cfg))
    if bias:
        q, k, v = (q + act(p["bq"], cfg), k + act(bk, cfg),
                   v + act(bv, cfg))
    return (q.view(b, s, -1, hd), k.view(b, s, -1, hd),
            v.view(b, s, -1, hd))


def _rank_kv(k: torch.Tensor, v: torch.Tensor, heads: RankHeads | None):
    """K/V as the rank's query heads read them: the heads themselves, or
    one per query head (`heads.kv_index`)."""
    if heads is None or heads.kv_index is None:
        return k, v
    return k[:, :, heads.kv_index], v[:, :, heads.kv_index]


def _scale_queries(q: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """q * 1/sqrt(hd), the constant in q's type first, as jnp rounds a
    weakly typed Python float to the array's type."""
    return q * torch.full((), 1.0 / math.sqrt(cfg.hd), dtype=q.dtype,
                          device=q.device)


def attention_apply(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    *,
    kind: str,
    positions: torch.Tensor,  # (S,)
    q_offset: int = 0,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """Training / prefill path.  Returns (out, cache) — cache holds the
    roped k and raw v for decode continuation (with `tp`, of the rank's
    KV heads: `whole_kv` gathers them).  K/V are not repeated to the
    query heads as the reference repeats them for its tensor-parallel
    mesh: the grouped flash loop reads each KV head once and computes the
    same products."""
    heads = None
    if tp is not None:
        heads = rank_heads(cfg, tp, x.device)
        x = tp.enter(x)
    q, k, v = _qkv(p, x, cfg, heads)
    if kind == "attn_chunked" or cfg.rope_on_global:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = _scale_queries(q, cfg)
    window = cfg.chunk_size if kind == "attn_chunked" else 0
    qmask = (head_geometry(cfg, x.device)[3] if heads is None
             else heads.qmask)
    o = flash_attention(q, *_rank_kv(k, v, heads), q_offset, window)
    if qmask is not None:
        o = o * qmask[None, None, :, None].to(o.dtype)
    b, s = x.shape[:2]
    o = o.reshape(b, s, -1)
    if tp is None:
        return o @ act(p["wo"], cfg), {"k": k, "v": v}
    return tp.leave(tp.product(o, act(p["wo"], cfg)), o.dtype), {"k": k,
                                                                 "v": v}


def attention_decode(
    p: Params,
    x: torch.Tensor,  # (B, 1, d)
    cache: dict,  # {"k","v": (B, S_max, KVH, D)}
    pos: int,  # absolute position of the new token
    cfg: ModelConfig,
    *,
    kind: str,
    tp=None,
    seq=None,
) -> tuple[torch.Tensor, dict]:
    """One new token against the cache.  The cache is written in place at
    `pos` (`pos % window` for `attn_chunked`), where the reference returns
    an updated copy (its step donates the old one); the masked direct
    attention then runs over the whole cache.  With `tp` the cache holds
    every KV head: the new token's K/V of the rank's heads are gathered
    over the model axis into it, and the rank attends over its heads.
    With `seq` (a `collectives.SeqSplit`) the cache holds the rank's
    block of slots: `_decode_seq_split`."""
    heads = None
    if tp is not None:
        heads = rank_heads(cfg, tp, x.device)
        x = tp.enter(x)
    q, k, v = _qkv(p, x, cfg, heads)
    if kind == "attn_chunked" or cfg.rope_on_global:
        pos_arr = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        q = rope(q, pos_arr, cfg.rope_theta)
        k = rope(k, pos_arr, cfg.rope_theta)
    q = _scale_queries(q, cfg)

    ck, cv = cache["k"], cache["v"]
    s_max = ck.shape[1] if seq is None else seq.total
    slot = pos % s_max if kind == "attn_chunked" else pos
    if not 0 <= slot < s_max:
        raise ValueError(f"position {pos} is outside the cache of {s_max}")
    if heads is not None:
        new = whole_kv({"k": k, "v": v}, cfg, tp)
        k, v = new["k"], new["v"]
    if seq is not None:
        return _decode_seq_split(p, q, k, v, cache, pos, slot, cfg,
                                 kind=kind, tp=tp, seq=seq,
                                 heads=heads), cache
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]

    if heads is None:
        qmask = head_geometry(cfg, x.device)[3]
    else:
        qmask = heads.qmask
        ck, cv = _rank_kv(ck[:, :, heads.kv0:heads.kv1],
                          cv[:, :, heads.kv0:heads.kv1], heads)
    b, _, h, d = q.shape
    kvh = ck.shape[2]
    g = h // kvh
    qr = q.reshape(b, kvh, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qr.float(), ck.float())
    mask = _decode_mask(torch.arange(s_max, device=x.device), pos, s_max,
                        cfg, kind)
    s = torch.where(mask[None, None, None, :], s, NEG_INF)
    pattn = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhgk,bkhd->bhgd", pattn, cv)
    if qmask is not None:
        o = o * qmask.reshape(kvh, g, 1).to(o.dtype)[None]
    o = o.reshape(b, 1, h * d)
    if tp is None:
        return o @ act(p["wo"], cfg), cache
    return tp.leave(tp.product(o, act(p["wo"], cfg)), o.dtype), cache


def _decode_mask(k_idx: torch.Tensor, pos: int, s_max: int,
                 cfg: ModelConfig, kind: str) -> torch.Tensor:
    """Which cache slots `k_idx` (absolute) the query at `pos` reads."""
    if kind == "attn_chunked":
        # ring cache of one window; valid entries share the query's chunk
        k_pos = pos - ((pos - k_idx) % s_max)
        return (k_pos >= 0) & (k_pos // cfg.chunk_size
                               == pos // cfg.chunk_size)
    return k_idx <= pos


def _decode_seq_split(p, q, k, v, cache, pos, slot, cfg, *, kind, tp, seq,
                      heads):
    """Decode attention over a cache split by sequence (flash-decoding):
    the rank that holds `slot` writes the new K/V (every KV head); every
    rank scores every query head (gathered over the model axis) against
    its slots, masked by their absolute indices, and the ranks' (max,
    sum of exponentials) pairs merge by log-sum-exp (`seq.merge`).  The
    probabilities are then the softmax's, exp(s - max) / sum, rounded to
    the activation type as one device rounds them; their partial
    products with the rank's V sum over the ranks (`seq.sum`).  A rank
    then applies its rows of `wo` to its own heads, as prefill does."""
    ck, cv = cache["k"], cache["v"]
    n = ck.shape[1]
    if seq.start <= slot < seq.start + n:
        ck[:, slot - seq.start] = k[:, 0]
        cv[:, slot - seq.start] = v[:, 0]
    if tp is not None:
        q = tp.gather(q, 2)  # every query head, in the padded order
    b, _, h, d = q.shape
    kvh = ck.shape[2]
    g = h // kvh
    s = torch.einsum("bhgd,bkhd->bhgk", q.reshape(b, kvh, g, d).float(),
                     ck.float())
    mask = _decode_mask(seq.start + torch.arange(n, device=q.device), pos,
                        seq.total, cfg, kind)[None, None, None, :]
    m = s.masked_fill(~mask, NEG_INF).amax(-1)
    e = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    m, l = seq.merge(m, e.sum(-1))
    pattn = (torch.where(mask, torch.exp(s - m[..., None]), 0.0)
             / l[..., None]).to(q.dtype)
    o = seq.sum(torch.einsum("bhgk,bkhd->bhgd", pattn.float(), cv.float()),
                q.dtype)
    qmask = head_geometry(cfg, q.device)[3]
    if qmask is not None:
        o = o * qmask.reshape(kvh, g, 1).to(o.dtype)[None]
    o = o.reshape(b, 1, h * d)
    if tp is None:
        return o @ act(p["wo"], cfg)
    o = o[..., heads.q0 * d:heads.q1 * d]
    return tp.leave(tp.product(o, act(p["wo"], cfg)), o.dtype)


def init_attn_cache(cfg: ModelConfig, batch: int, s_max: int, kind: str,
                    device: torch.device) -> dict:
    if kind == "attn_chunked":
        s_max = min(s_max, cfg.chunk_size)
    kvp = head_geometry(cfg)[1]
    shape = (batch, s_max, kvp, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.act_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.act_dtype, device=device),
    }


def ring_from_prefill(kv: torch.Tensor, w: int, axis: int = 1
                      ) -> torch.Tensor:
    """Arrange the last min(S, w) prefilled K/V entries into the ring-cache
    slot order used by attention_decode (slot = pos % w)."""
    s = kv.shape[axis]
    if s <= w:
        shape = list(kv.shape)
        shape[axis] = w - s
        return torch.cat([kv, kv.new_zeros(shape)], dim=axis)
    tail = kv.narrow(axis, s - w, w)
    return torch.roll(tail, shifts=(s - w) % w, dims=axis)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg: ModelConfig, device: torch.device,
             d_ff: int | None = None) -> Params:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    dt = cfg.act_dtype
    return Params(
        wg=init_dense(gen, d, (ff,), dt, device),
        wu=init_dense(gen, d, (ff,), dt, device),
        wd=init_dense(gen, ff, (d,), dt, device),
    )


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)) with each op rounded to x's type: the form XLA
    gives `jax.nn.sigmoid` (its logistic expanded into exp, add and
    divide in the operand's type), not a sigmoid rounded once."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), `jax.nn.silu`, rounded as XLA rounds it."""
    return x * sigmoid(x)


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
              tp=None) -> torch.Tensor:
    """SwiGLU; with `tp`, over the rank's columns of d_ff, the partial
    output summed over the model axis."""
    if tp is not None:
        x = tp.enter(x)
    gate = silu(x @ act(p["wg"], cfg))
    h = gate * (x @ act(p["wu"], cfg))
    if tp is None:
        return h @ act(p["wd"], cfg)
    return tp.leave(tp.product(h, act(p["wd"], cfg)), h.dtype)
