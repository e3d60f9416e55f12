"""The tensor-parallel layers (`layers.attention_apply`,
`attention_decode`, `mlp_apply`, `moe.moe_apply` with `tp`) in one
process: every model rank's slice run in turn through a stand-in of
`collectives.ModelSplit` whose sums are left to the test, the ranks'
partial outputs and input gradients summed, against the one-device layer
(float32, within 1e-5 of each quantity's scale).

The recurrent mixers (`ssm.mamba_apply`/`mamba_decode`,
`xlstm.mlstm_*`, `xlstm.slstm_*`) and decode attention over a cache
split by sequence (`collectives.SeqSplit`) exchange values between the
ranks mid-layer, so their ranks run at once, one thread each, on the
real `ModelSplit` and its autograd functions over a model axis whose
collectives meet at a barrier (`ThreadComm`): every rank's output and
input gradient, the split leaves' gradients put together and the whole
leaves' summed over the ranks, and the states' blocks against the
one-device layer's.

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

import concurrent.futures
import dataclasses
import threading

import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch.launch import collectives
from repro_torch.models import layers, moe, ssm, xlstm

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



# ---------------------------------------------------------------------------
# mixers whose ranks exchange values mid-layer: one thread a rank
# ---------------------------------------------------------------------------


class _Hub:
    """Where a model axis's threads meet: each collective hands in one
    value a rank and reads every rank's (a barrier on each side)."""

    def __init__(self, size: int):
        self.size = size
        self.barrier = threading.Barrier(size, timeout=120)
        self.slots = [None] * size

    def meet(self, r: int, value):
        self.slots[r] = value
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


class ThreadComm:
    """The collectives of model rank `index` of a `_Hub`'s axis, as
    `collectives.Comm` offers them to `ModelSplit` and `SeqSplit`: the
    sums add the ranks' terms in rank order."""

    def __init__(self, hub: _Hub, index: int):
        self.hub, self.tp, self.dp = hub, "model", ()
        self.sizes, self.coords = {"model": hub.size}, {"model": index}

    def _meet(self, value):
        return self.hub.meet(self.coords["model"], value)

    def all_reduce(self, t, axes):
        parts = self._meet(t)
        out = parts[0]
        for q in parts[1:]:
            out = out + q
        return out

    def all_gather(self, t, dim, axes):
        return torch.cat(self._meet(t), dim)

    def all_to_all(self, parts, shapes, axis):
        sent = self._meet(parts)
        r = self.coords["model"]
        return [sent[q][r].reshape(shapes[q]) for q in range(self.hub.size)]


def _on_ranks(size: int, fn) -> list:
    """fn(tp) on `size` threads, tp rank r's `ModelSplit` (its "core"
    part) over a `ThreadComm`; every rank's result, in rank order."""
    hub = _Hub(size)

    def run(r):
        try:
            return fn(collectives.ModelSplit(ThreadComm(hub, r), {"core"}))
        except BaseException:
            hub.barrier.abort()
            raise

    with concurrent.futures.ThreadPoolExecutor(size) as pool:
        return [f.result() for f in [pool.submit(run, r)
                                     for r in range(size)]]


def _leaves(p) -> dict:
    return {n: t.detach().clone() for n, t in dict(
        p.named_parameters() if hasattr(p, "named_parameters") else p
    ).items()}


def _blocks(t, dim, size):
    return list(t.chunk(size, dim))


# the mLSTM input-gate bias: the output is invariant to a shift of every
# input-gate logit, so its gradient is a cancelling sum of large terms
# (tests/test_torch_train.py BI_RTOL)
CANCEL_RTOL = {"bi": 0.1}


def _check_ranks(results, want_out, want_dx, want_grads, cut, whole):
    """Every rank's output and input gradient against the one-device
    layer's; each leaf in `cut` ({name: dim}) put together from the
    ranks' blocks, each in `whole` summed over the ranks."""
    for r in results:
        _close(r["out"], want_out)
        _close(r["dx"], want_dx)
    for n, dim in cut.items():
        _close(torch.cat([r["grads"][n] for r in results], dim),
               want_grads[n])
    for n in whole:
        got, want = sum(r["grads"][n] for r in results), want_grads[n]
        scale = float(want.abs().max()) or 1.0
        assert float((got - want).abs().max()) <= CANCEL_RTOL.get(
            n, RTOL) * scale, n


def _mamba_cfg():
    return dataclasses.replace(
        t_configs.get_config("jamba-1.5-large-398b").reduced(),
        dtype="float32")


# Mamba leaves split by the rules: (dim, of the 2 d_inner columns)
_MAMBA_CUT = {"conv_w": 1, "conv_b": 0, "x_proj": 0, "dt_proj": 1,
              "dt_bias": 0, "a_log": 0, "d_skip": 0, "out_proj": 0}


def _mamba_rank(p: dict, tp) -> dict:
    out = {n: _blocks(t, _MAMBA_CUT[n], tp.size)[tp.index]
           for n, t in p.items() if n in _MAMBA_CUT}
    out["in_proj"] = _blocks(p["in_proj"], 1, tp.size)[tp.index]
    return out


@pytest.mark.parametrize("size", [2, 4])
def test_mamba_ranks_match_the_one_device_mixer(size):
    """Reduced jamba's Mamba mixer (d_inner 128) over 2 and 4 ranks, each
    its d_inner channels: in_proj's column blocks exchanged into each
    rank's x and z channels, x_proj's and out_proj's row-split products
    summed; forward, backward, the prefill state's channel blocks, and
    one decode step from them."""
    cfg = _mamba_cfg()
    gen = torch.Generator().manual_seed(5)
    p = _leaves(ssm.init_mamba(gen, cfg, torch.device("cpu")))
    p["dt_bias"] = torch.randn(p["dt_bias"].shape, generator=gen) - 4.0
    b, s = 2, 6
    x = torch.randn((b, s, cfg.d_model), generator=gen)
    x1 = torch.randn((b, 1, cfg.d_model), generator=gen)
    dy = torch.randn(x.shape, generator=gen)
    one = {n: t.clone().requires_grad_(True) for n, t in p.items()}
    xw = x.clone().requires_grad_(True)
    want, state = ssm.mamba_apply(one, xw, cfg)
    want.backward(dy)
    state = {n: t.detach() for n, t in state.items()}
    want_dec, want_state = ssm.mamba_decode(
        p, x1, {n: t.clone() for n, t in state.items()}, cfg)

    def rank(tp):
        leaves = {n: t.clone().requires_grad_(True)
                  for n, t in _mamba_rank(p, tp).items()}
        xr = x.clone().requires_grad_(True)
        out, st = ssm.mamba_apply(leaves, xr, cfg, tp=tp)
        out.backward(dy)
        mine = {"conv": _blocks(state["conv"], 2, tp.size)[tp.index].clone(),
                "ssm": _blocks(state["ssm"], 1, tp.size)[tp.index].clone()}
        with torch.no_grad():
            dec, mine = ssm.mamba_decode(_mamba_rank(p, tp), x1, mine, cfg,
                                         tp=tp)
        return {"out": out.detach(), "dx": xr.grad, "state": st,
                "grads": {n: t.grad for n, t in leaves.items()},
                "dec": dec, "dec_state": mine}

    res = _on_ranks(size, rank)
    _check_ranks(res, want.detach(), xw.grad,
                 {n: t.grad for n, t in one.items()},
                 dict(_MAMBA_CUT, in_proj=1), ())
    for n, dim in (("conv", 2), ("ssm", 1)):
        _close(torch.cat([r["state"][n].detach() for r in res], dim),
               state[n])
        _close(torch.cat([r["dec_state"][n] for r in res], dim),
               want_state[n])
    for r in res:
        _close(r["dec"], want_dec)


def _xlstm_cfg(d=None):
    cfg = dataclasses.replace(t_configs.get_config("xlstm-350m").reduced(),
                              dtype="float32")
    return cfg if d is None else dataclasses.replace(cfg, d_model=d,
                                                     head_dim=d // cfg.n_heads)


@pytest.mark.parametrize("size", [4, 8])
def test_mlstm_ranks_match_the_one_device_mixer(size):
    """Reduced xlstm's mLSTM (4 heads of 16) over 4 ranks, a head each,
    and over 8, where the heads do not split and every rank runs every
    head: the rank's output columns of wo_gate and out; forward,
    backward, the prefill state as the rank stores it (C's and n's
    key-dim block, m whole: `xlstm.mlstm_stored`), and one decode step
    on it (the readout's sums over the split key dim)."""
    cfg = _xlstm_cfg()
    gen = torch.Generator().manual_seed(6)
    p = _leaves(xlstm.init_mlstm(gen, cfg, torch.device("cpu")))
    p["bi"] = torch.randn(p["bi"].shape, generator=gen)
    b, s = 2, 8
    x = torch.randn((b, s, cfg.d_model), generator=gen)
    x1 = torch.randn((b, 1, cfg.d_model), generator=gen)
    dy = torch.randn(x.shape, generator=gen)
    one = {n: t.clone().requires_grad_(True) for n, t in p.items()}
    xw = x.clone().requires_grad_(True)
    want, state = xlstm.mlstm_apply(one, xw, cfg)
    want.backward(dy)
    state = {n: t.detach() for n, t in state.items()}
    want_dec, want_state = xlstm.mlstm_decode(
        p, x1, {n: t.clone() for n, t in state.items()}, cfg)
    heads = cfg.n_heads % size == 0
    cut = {"wo_gate": 1, "out": 1}
    if heads:
        cut.update(wq=1, wk=1, wv=1)

    def stored(st, tp):
        k = lambda t: _blocks(t, -1, tp.size)[tp.index].clone()
        return {"C": k(st["C"]), "n": k(st["n"]), "m": st["m"].clone()}

    def rank(tp):
        mine = {n: (_blocks(t, cut[n], tp.size)[tp.index] if n in cut else t)
                for n, t in p.items()}
        leaves = {n: t.clone().requires_grad_(True) for n, t in mine.items()}
        xr = x.clone().requires_grad_(True)
        out, st = xlstm.mlstm_apply(leaves, xr, cfg, tp=tp)
        out.backward(dy)
        with torch.no_grad():
            st = xlstm.mlstm_stored({n: t.detach() for n, t in st.items()},
                                    cfg, tp)
            dec, dst = xlstm.mlstm_decode(mine, x1, stored(state, tp), cfg,
                                          tp=tp)
        return {"out": out.detach(), "dx": xr.grad, "state": st,
                "grads": {n: t.grad for n, t in leaves.items()},
                "dec": dec, "dec_state": dst, "want": stored(want_state, tp),
                "prefill": stored(state, tp)}

    res = _on_ranks(size, rank)
    _check_ranks(res, want.detach(), xw.grad,
                 {n: t.grad for n, t in one.items()}, cut,
                 [n for n in p if n not in cut])
    for r in res:
        _close(r["dec"], want_dec)
        for n in ("C", "n", "m"):
            _close(r["state"][n], r["prefill"][n])
            _close(r["dec_state"][n], r["want"][n])


@pytest.mark.parametrize("size", [4, 8])
def test_slstm_ranks_match_the_one_device_mixer(size):
    """Reduced xlstm's sLSTM (head dim 16) over 4 and 8 ranks: each rank
    its head dims of w_in and of the state and r's stored rows, exchanged
    for its output dims, h gathered every position, and its output
    columns of `out`.  Every contraction over the split dims is taken
    whole: forward, backward (every rank's input gradient whole, no sum),
    the state's blocks and one decode step."""
    cfg = _xlstm_cfg()
    hd, h = cfg.hd, cfg.n_heads
    gen = torch.Generator().manual_seed(7)
    p = _leaves(xlstm.init_slstm(gen, cfg, torch.device("cpu")))
    p["b"] = torch.randn(p["b"].shape, generator=gen)
    b, s = 2, 5
    x = torch.randn((b, s, cfg.d_model), generator=gen)
    x1 = torch.randn((b, 1, cfg.d_model), generator=gen)
    dy = torch.randn(x.shape, generator=gen)
    one = {n: t.clone().requires_grad_(True) for n, t in p.items()}
    xw = x.clone().requires_grad_(True)
    want, state = xlstm.slstm_apply(one, xw, cfg)
    want.backward(dy)
    state = {n: t.detach() for n, t in state.items()}
    want_dec, want_state = xlstm.slstm_decode(
        p, x1, {n: t.clone() for n, t in state.items()}, cfg)

    def rank(tp):
        j = _blocks(torch.arange(hd), 0, tp.size)[tp.index]
        mine = {"b": p["b"], "out": _blocks(p["out"], 1, tp.size)[tp.index],
                "w_in": p["w_in"].view(-1, 4, h, hd)[..., j].reshape(
                    cfg.d_model, -1),
                "r": p["r"][:, j]}
        leaves = {n: t.clone().requires_grad_(True) for n, t in mine.items()}
        xr = x.clone().requires_grad_(True)
        out, st = xlstm.slstm_apply(leaves, xr, cfg, tp=tp)
        out.backward(dy)
        with torch.no_grad():
            dec, dst = xlstm.slstm_decode(
                mine, x1, {n: t[..., j].clone() for n, t in state.items()},
                cfg, tp=tp)
        grads = {n: t.grad for n, t in leaves.items()}
        full = {n: torch.zeros_like(p[n]) for n in ("w_in", "r")}
        full["w_in"].view(-1, 4, h, hd)[..., j] = grads["w_in"].view(
            cfg.d_model, 4, h, -1)
        full["r"][:, j] = grads["r"]
        grads.update(full)
        return {"out": out.detach(), "dx": xr.grad, "j": j, "grads": grads,
                "state": {n: t.detach() for n, t in st.items()},
                "dec": dec, "dec_state": dst}

    res = _on_ranks(size, rank)
    _check_ranks(res, want.detach(), xw.grad,
                 {n: t.grad for n, t in one.items()}, {"out": 1},
                 ["b", "w_in", "r"])
    for r in res:
        _close(r["dec"], want_dec)
        for n in ("c", "n", "h", "m"):
            _close(r["state"][n], state[n][..., r["j"]])
            _close(r["dec_state"][n], want_state[n][..., r["j"]])


# (kind, cache slots, position of the new token, model axis)
SEQ_CASES = {
    "attn_divides": ("attn", 8, 2, 4),
    "attn_late": ("attn", 8, 7, 2),
    "attn_does_not_divide": ("attn", 9, 5, 4),
    "ring_divides": ("attn_chunked", 4, 6, 4),
    "ring_does_not_divide": ("attn_chunked", 6, 9, 4),
}


@pytest.mark.parametrize("geometry", ["kv_split", "kv_replicated",
                                      "padded_gqa", "straddling_groups"])
@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_decode_attention_over_a_sequence_split_cache(case, geometry):
    """One decode step with every rank's heads, the cache split by
    sequence (each rank its block of slots, `collectives.SeqSplit`)
    where the length divides the axis and whole on every rank where it
    does not (the rules' layouts): every rank's output and its block of
    the written cache equal the one-device step's.  Shards holding no
    valid slot (an early position, a ring's other window) add nothing."""
    kind, s_max, pos, size = SEQ_CASES[case]
    heads, kv, pad, _ = GEOMETRIES[geometry]
    cfg = _cfg(heads, kv, pad)
    if kind == "attn_chunked":
        cfg = dataclasses.replace(cfg, chunk_size=s_max)
    gen = torch.Generator().manual_seed(8)
    p = _attention_weights(cfg, gen)
    b = 2
    kvp = layers.head_geometry(cfg)[1]
    cache = {n: torch.randn((b, s_max, kvp, cfg.hd), generator=gen)
             for n in ("k", "v")}
    x = torch.randn((b, 1, cfg.d_model), generator=gen)
    want, want_cache = layers.attention_decode(
        p, x, {n: t.clone() for n, t in cache.items()}, pos, cfg, kind=kind)
    split = s_max % size == 0

    def rank(tp):
        n = s_max // size
        lo = tp.index * n if split else 0
        mine = {k: (t[:, lo:lo + n] if split else t).clone()
                for k, t in cache.items()}
        seq = collectives.SeqSplit(tp.comm, ("model",), lo, s_max) \
            if split else None
        out, mine = layers.attention_decode(
            _rank_attention(p, cfg, tp), x, mine, pos, cfg, kind=kind,
            tp=tp, seq=seq)
        return {"out": out, "cache": mine, "lo": lo}

    for r in _on_ranks(size, rank):
        _close(r["out"], want)
        for n in ("k", "v"):
            got = r["cache"][n]
            _close(got, want_cache[n][:, r["lo"]:r["lo"] + got.shape[1]])
