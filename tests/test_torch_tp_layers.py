"""The tensor-parallel layers (`layers.attention_apply`,
`attention_decode`, `mlp_apply`, `moe.moe_apply` with `tp`) in one
process: every model rank's slice run in turn through a stand-in of
`collectives.ModelSplit` whose sums are left to the test, the ranks'
partial outputs and input gradients summed, against the one-device layer
(float32, within 1e-5 of each quantity's scale).

The head geometries cover the configs' cases and one none of them has:
KV heads split with their query groups (yi-9b, qwen2-moe on (2, 4)),
KV heads replicated with each rank's query heads inside one group
(yi-9b on (16, 16), reduced yi-9b on (2, 4)), padded heads (llama4's
group-major pad slots, musicgen's padded MHA), and a rank whose query
heads straddle two groups (a K/V head read per query head).  The decode
caches gathered to every KV head (`layers.whole_kv`) equal the
one-device K/V.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch.launch import collectives
from repro_torch.models import layers, moe

RTOL = 1e-5


class SimSplit(collectives.ModelSplit):
    """Rank `index` of `size` along a model axis simulated in one process:
    entering and leaving are the identity (the test sums the ranks'
    partial products and gradients); `gather` concatenates the tensors
    `peers` holds for every rank, each padded as the caller padded its
    own."""

    def __init__(self, size: int, index: int, peers=None):
        self.size, self.index = size, index
        self.parts = frozenset({"core", "ffn", "shared"})
        self.peers = peers

    def enter(self, t):
        return t

    def leave(self, t, dtype=None):
        return t

    def gather(self, t, dim):
        n = t.shape[dim]
        out = []
        for p in self.peers:
            pad = [0, 0] * (p.ndim - 1 - dim) + [0, n - p.shape[dim]]
            out.append(torch.nn.functional.pad(p, pad))
        return torch.cat(out, dim)


def _cfg(heads, kv, pad=0):
    return dataclasses.replace(
        t_configs.get_config("yi-9b").reduced(), dtype="float32",
        n_heads=heads, n_kv_heads=kv, attn_pad_heads=pad, qkv_bias=True)


# (query heads, KV heads, padded heads, model axis)
GEOMETRIES = {
    "kv_split": (8, 4, 0, 4),
    "kv_replicated": (8, 2, 0, 4),
    "padded_gqa": (6, 2, 8, 4),
    "padded_mha": (3, 3, 4, 2),
    "straddling_groups": (12, 3, 0, 4),
}


def _attention_weights(cfg, gen) -> dict:
    """An attention's leaves as a dict (the layers read a `Params` or a
    dict alike; a dict keeps their autograd history), biases not zero."""
    p = dict(layers.init_attention(gen, cfg, torch.device("cpu"))
             .named_parameters())
    p = {n: t.detach().clone() for n, t in p.items()}
    for b in ("bq", "bk", "bv"):
        p[b] = torch.randn(p[b].shape, generator=gen) * 0.1
    return p


def _rank_attention(p: dict, cfg, tp) -> dict:
    """The rank's leaves as `Plan.block` gives them: wq, bq and wo's rows
    by query head; wk, wv, bk, bv by KV head where the KV heads divide the
    axis, else whole."""
    heads = layers.rank_heads(cfg, tp)
    hd = cfg.hd
    q = slice(heads.q0 * hd, heads.q1 * hd)
    kv = slice(heads.kv0 * hd, heads.kv1 * hd) if heads.kv_split \
        else slice(None)
    return dict(wq=p["wq"][:, q], wk=p["wk"][:, kv], wv=p["wv"][:, kv],
                wo=p["wo"][q], bq=p["bq"][q], bk=p["bk"][kv], bv=p["bv"][kv])


def _close(got, want):
    scale = float(want.abs().max()) or 1.0
    assert float((got - want).abs().max()) <= RTOL * scale


@pytest.mark.parametrize("kind", ["attn", "attn_chunked"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_attention_ranks_sum_to_the_one_device_layer(geometry, kind):
    heads, kv, pad, size = GEOMETRIES[geometry]
    cfg = _cfg(heads, kv, pad)
    if kind == "attn_chunked":
        cfg = dataclasses.replace(cfg, chunk_size=4)
    gen = torch.Generator().manual_seed(0)
    p = _attention_weights(cfg, gen)
    b, s = 2, 8
    x = torch.randn((b, s, cfg.d_model), generator=gen)
    pos = torch.arange(s, dtype=torch.int32)
    dy = torch.randn((b, s, cfg.d_model), generator=gen)

    leaves = {n: t.clone().requires_grad_(True) for n, t in p.items()}
    xw = x.clone().requires_grad_(True)
    want, want_cache = layers.attention_apply(leaves, xw, cfg, kind=kind,
                                              positions=pos)
    want.backward(dy)

    out, dx, caches = 0, 0, []
    grads = {n: torch.zeros_like(t) for n, t in leaves.items()}
    for r in range(size):
        tp = SimSplit(size, r)
        whole = {n: t.detach().clone().requires_grad_(True)
                 for n, t in leaves.items()}
        xr = x.clone().requires_grad_(True)
        got, cache = layers.attention_apply(
            _rank_attention(whole, cfg, tp), xr, cfg, kind=kind,
            positions=pos, tp=tp)
        got.backward(dy)
        out, dx = out + got.detach(), dx + xr.grad
        for n in grads:
            grads[n] += whole[n].grad
        caches.append(torch.stack([cache["k"], cache["v"]]).detach())
    _close(out, want.detach())
    _close(dx, xw.grad)
    for n, t in leaves.items():
        _close(grads[n], t.grad)
    for r in range(size):
        got = layers.whole_kv({"k": caches[r][0], "v": caches[r][1]}, cfg,
                              SimSplit(size, r, caches))
        for n in ("k", "v"):
            _close(got[n], want_cache[n].detach())


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_attention_decode_ranks_sum_to_the_one_device_step(geometry):
    """One decode step against a filled cache: each rank's new K/V of its
    heads written into the whole-heads cache through `whole_kv`, its
    partial output summed."""
    heads, kv, pad, size = GEOMETRIES[geometry]
    cfg = _cfg(heads, kv, pad)
    gen = torch.Generator().manual_seed(1)
    p = _attention_weights(cfg, gen)
    b, s0, s_max = 2, 6, 8
    prompt = torch.randn((b, s0, cfg.d_model), generator=gen)
    x = torch.randn((b, 1, cfg.d_model), generator=gen)
    _, kv0 = layers.attention_apply(p, prompt, cfg, kind="attn",
                                    positions=torch.arange(s0))
    cache = {n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, s_max - s0))
             for n, t in kv0.items()}
    want, want_cache = layers.attention_decode(
        p, x, {n: t.clone() for n, t in cache.items()}, s0, cfg,
        kind="attn")

    # every rank's new K/V of its own heads (K rotated to the position,
    # as each rank rotates its own before the gather)
    news = []
    for r in range(size):
        tp = SimSplit(size, r)
        _, k, v = layers._qkv(_rank_attention(p, cfg, tp), x, cfg,
                              layers.rank_heads(cfg, tp))
        if cfg.rope_on_global:
            k = layers.rope(k, torch.full((1,), s0, dtype=torch.int32),
                            cfg.rope_theta)
        news.append(torch.stack([k, v]))
    out = 0
    for r in range(size):
        tp = SimSplit(size, r, news)
        mine = {n: t.clone() for n, t in cache.items()}
        got, mine = layers.attention_decode(
            _rank_attention(p, cfg, tp), x, mine, s0, cfg, kind="attn",
            tp=tp)
        out = out + got
        for n in ("k", "v"):
            _close(mine[n], want_cache[n])
    _close(out, want)


def test_mlp_ranks_sum_to_the_one_device_layer():
    cfg = _cfg(4, 2)
    gen = torch.Generator().manual_seed(2)
    p = layers.init_mlp(gen, cfg, torch.device("cpu"))
    x = torch.randn((2, 8, cfg.d_model), generator=gen)
    want = layers.mlp_apply(p, x, cfg)
    size, ff = 4, cfg.d_ff
    out = 0
    for r in range(size):
        tp = SimSplit(size, r)
        a, b = tp.block(ff)
        out = out + layers.mlp_apply(
            dict(wg=p["wg"][:, a:b], wu=p["wu"][:, a:b], wd=p["wd"][a:b]),
            x, cfg, tp)
    _close(out, want)


@pytest.mark.parametrize("shape", [(2, 8), (8, 1)])
def test_moe_ranks_sum_to_the_one_device_layer(shape):
    """Reduced qwen2-moe's experts (f 64) and shared expert over four
    model ranks: routing, dispatch and combine alike on every rank, the
    rank's f columns of every expert; the routed and shared partial sums
    add to the one-device output, and the input's and the router's
    gradients summed over the ranks (the router's own: it is outside the
    region) are the one-device ones."""
    cfg = dataclasses.replace(
        t_configs.get_config("qwen2-moe-a2.7b").reduced(), dtype="float32")
    mcfg = cfg.moe_for(0)
    gen = torch.Generator().manual_seed(3)
    p = moe.init_moe(gen, cfg, mcfg, torch.device("cpu"))
    x = torch.randn((*shape, cfg.d_model), generator=gen)
    dy = torch.randn(x.shape, generator=gen)
    router = p["router"].detach().clone().requires_grad_(True)
    xw = x.clone().requires_grad_(True)
    one = dict(router=router, wg=p["wg"], wu=p["wu"], wd=p["wd"],
               shared=p["shared"])
    want = moe.moe_apply(one, xw, cfg, mcfg)
    want.backward(dy)

    size = 4
    out, dx, drouter = 0, 0, 0
    for r in range(size):
        tp = SimSplit(size, r)
        a, b = tp.block(mcfg.d_expert)
        c, d = tp.block(mcfg.d_shared)
        rr = p["router"].detach().clone().requires_grad_(True)
        xr = x.clone().requires_grad_(True)
        shared = dict(wg=p["shared"]["wg"][:, c:d],
                      wu=p["shared"]["wu"][:, c:d],
                      wd=p["shared"]["wd"][c:d])
        got = moe.moe_apply(dict(router=rr, wg=p["wg"][:, :, a:b],
                                 wu=p["wu"][:, :, a:b], wd=p["wd"][:, a:b],
                                 shared=shared),
                            xr, cfg, mcfg, tp=tp)
        got.backward(dy)
        out, dx, drouter = out + got.detach(), dx + xr.grad, drouter + rr.grad
    _close(out, want.detach())
    _close(dx, xw.grad)
    _close(drouter, router.grad)


def test_a_16_bit_partial_product_is_float32_with_the_16_bit_backward():
    """`ModelSplit.product` of bf16 operands: the float32 product (no
    rounding before the ranks' sum), and as gradients the bf16 product's
    own, for a dense weight and for the experts' stacked weights."""
    tp = SimSplit(2, 0)
    gen = torch.Generator().manual_seed(4)
    for a_shape, w_shape, eq in (((2, 3, 16), (16, 8), "bsk,kn->bsn"),
                                 ((2, 4, 3, 16), (4, 16, 8),
                                  "becf,efd->becd")):
        a = torch.randn(a_shape, generator=gen).bfloat16()
        w = torch.randn(w_shape, generator=gen).bfloat16()
        g = torch.randn((*a_shape[:-1], w_shape[-1]), generator=gen)
        a1, w1 = a.clone().requires_grad_(), w.clone().requires_grad_()
        out = tp.product(a1, w1)
        assert out.dtype == torch.float32
        want = torch.einsum(eq, a.float(), w.float())
        assert float((out.detach() - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
        out.backward(g)
        a2, w2 = a.clone().requires_grad_(), w.clone().requires_grad_()
        torch.einsum(eq, a2, w2).backward(g.bfloat16())
        for got, ref in ((a1.grad, a2.grad), (w1.grad, w2.grad)):
            assert got.dtype == torch.bfloat16
            assert float((got.float() - ref.float()).abs().max()) <= \
                1e-2 * float(ref.float().abs().max())

