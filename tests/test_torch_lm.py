"""The port's LM serving path (`repro_torch.configs`, `.models`,
`.launch.steps`, `.launch.serve`) against the reference's, at `reduced()`
sizes of all ten configs: dense (GQA, qkv bias, audio and vision
frontends), MoE (qwen2-moe, llama4-scout with chunked attention), the
Mamba/attention/MoE hybrid (jamba) and xLSTM.

Both packages get the same weights: the reference's `init_model` tree,
carried across by `convert.lm_params_from_reference`.  Tolerances:

  * float32 (`dataclasses.replace(cfg, dtype="float32")`): atol 1e-4 on
    logits of magnitude ~3 (measured differences ~3e-6: XLA's and torch's
    sums, pow, cos and sin round differently in the last bit);
  * bfloat16: atol 0.15, the reference's own bound for bf16 activations
    taken in two execution orders (tests/test_models_smoke.py); with an
    MoE FFN, on the rows whose routing the MoE routing rule clears;
  * the token sampler, given the same float32 logits, bit for bit
    (tests/test_torch_token_sampling.py); across the two models' logits a
    token is held exactly wherever the two sides' integer LUT weights are
    equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.launch import serve as r_serve
from repro.launch import steps as r_steps
from repro.models import layers as r_layers
from repro.models import moe as r_moe
from repro.models import transformer as r_tfm
from repro_torch import configs as t_configs
from repro_torch import convert, prng
from repro_torch.kernels import ops as t_ops
from repro_torch.core.interp import build_exp_weight_lut
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models import sampling as t_sampling
from repro_torch.models import transformer as t_tfm

ARCHS = sorted(r_configs.list_archs())
ATOL = {"float32": 1e-4, "bfloat16": 0.15}
B, S0 = 2, 8


@pytest.fixture(autouse=True)
def _no_reference_moe_mesh(monkeypatch):
    """The reference's MoE reads its sharding axes from a module global
    that its mesh step factories set and never clear; a test in the same
    process that built a meshed step would leave them set, and the
    unmeshed reference calls here would then ask for a mesh."""
    monkeypatch.setattr(r_moe, "_MESH_CTX",
                        {"dp": None, "tp": None, "tp_size": 1})


def _cfgs(arch: str, dtype: str, **kw):
    return (dataclasses.replace(r_configs.get_config(arch).reduced(),
                                dtype=dtype, **kw),
            dataclasses.replace(t_configs.get_config(arch).reduced(),
                                dtype=dtype, **kw))


def _setup(arch: str, dtype: str, seed: int = 1, **kw):
    """Configs of both packages (reduced, fields `kw` replaced), the
    reference's weights and the port's model holding them, and a batch of
    prompts (and frontend features)."""
    r_cfg, t_cfg = _cfgs(arch, dtype, **kw)
    params = r_tfm.init_model(jax.random.PRNGKey(seed), r_cfg)
    tree = jax.tree.map(np.asarray, params)
    model = convert.lm_params_from_reference(tree, t_cfg, "cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, r_cfg.vocab, (B, S0)).astype(np.int32)
    r_batch, t_batch = {"tokens": jnp.asarray(toks)}, {
        "tokens": torch.from_numpy(toks)}
    if r_cfg.frontend:
        f = rng.normal(0, 1, (B, r_cfg.frontend_len, t_tfm.FRONTEND_DIM)
                       ).astype(np.float32)
        r_batch["features"], t_batch["features"] = (jnp.asarray(f),
                                                    torch.from_numpy(f))
    return r_cfg, t_cfg, params, tree, model, r_batch, t_batch


def _close(got: torch.Tensor, want, atol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _same_leaves(port: t_layers.Params, ref: dict, i: int):
    """Every leaf of a reference sub-tree (superblock i of its stacked
    leaves) equals the port's, the head-split matrices reshaped back."""
    for name, want in ref.items():
        if isinstance(want, dict):
            _same_leaves(port[name], want, i)
        else:
            np.testing.assert_array_equal(
                _np(port[name]).reshape(want.shape[1:]),
                np.asarray(want[i], np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_from_reference_round_trips(arch):
    """The converted model has `init_model`'s names, shapes and types, and
    every reference leaf comes back from it (layer i = slot i % period of
    superblock i // period; the head-split matrices reshaped back)."""
    _, t_cfg, _, tree, model, _, _ = _setup(arch, "float32")
    fresh = t_tfm.init_model(t_cfg, seed=0, device="cpu")
    shapes = {n: (tuple(p.shape), p.dtype)
              for n, p in fresh.named_parameters()}
    assert {n: (tuple(p.shape), p.dtype)
            for n, p in model.named_parameters()} == shapes
    assert not any(p.requires_grad for p in model.parameters())
    period = len(t_cfg.pattern)
    for i, blk in enumerate(model["blocks"]):
        ref = tree["super"][f"b{i % period}"]
        assert ("ffn" in blk) == ("ffn" in ref)
        _same_leaves(blk, ref, i // period)
    for name in ("embed", "head", "final_norm", "frontend_proj"):
        assert (name in model) == (name in tree)
        if name in tree:
            np.testing.assert_array_equal(model[name].numpy(), tree[name])


def _n_params_left_out(cfg) -> int:
    """What `ModelConfig.n_params()` leaves out of a model's weights (or
    counts over): the final norm, the frontend projection, per block the
    padded heads and qkv biases, Mamba's second and third (d_inner,)
    vectors, the xLSTM mixers' exact sizes against its approximate
    5 d^2 + 3 d, and a second norm it counts where a block has no FFN."""
    d, hd, h = cfg.d_model, cfg.hd, cfg.n_heads
    hp, kvp, _, _ = t_layers.head_geometry(cfg)
    extra = d + (t_tfm.FRONTEND_DIM * d if cfg.frontend else 0)
    approx_xlstm = 5 * d * d + 3 * d
    for slot, kind in enumerate(cfg.pattern):
        blk = 0
        if kind in t_tfm.ATTN_KINDS:
            blk = d * hd * (2 * (hp - h) + 2 * (kvp - cfg.n_kv_heads))
            blk += hd * (hp + 2 * kvp) if cfg.qkv_bias else 0
        elif kind == "mamba":
            blk = 2 * cfg.d_inner
        elif kind == "mlstm":
            blk = (3 * d * h * hd + 2 * d * h + 2 * h + 2 * d * d
                   - approx_xlstm)
        elif kind == "slstm":
            blk = 4 * d * h * hd + 4 * h * hd * hd + 4 * h * hd + d * d \
                - approx_xlstm
        if cfg.moe_for(slot) is None and not cfg.d_ff:
            blk -= d
        extra += cfg.n_super * blk
    return extra


FLOAT32_LEAVES = ("a_log", "d_skip", ".r")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_model_on_meta_has_n_params(arch):
    """At full width, on the `meta` device (shapes only): `n_params()` plus
    what it leaves out; every weight in bf16 but the float32 ones (norms,
    Mamba's `a_log` and `d_skip`, sLSTM's `r`) and Mamba's `dt_bias`, in
    the parameter type."""
    cfg = t_configs.get_config(arch)
    model = t_tfm.init_model(cfg, device="meta")
    count = sum(p.numel() for p in model.parameters())
    assert count == cfg.n_params() + _n_params_left_out(cfg)
    for n, p in model.named_parameters():
        if "norm" in n or n.endswith(FLOAT32_LEAVES):
            assert p.dtype == torch.float32, n
        elif n.endswith("dt_bias"):
            assert p.dtype == getattr(torch, cfg.param_dtype), n
        else:
            assert p.dtype == torch.bfloat16, n
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    if arch == "yi-9b":
        assert count == 8_829_407_232 and nbytes < 17.7e9
    if arch == "qwen2-moe-a2.7b":  # the MoE that one 80 GB card holds
        assert count == 14_315_735_040 and nbytes < 28.7e9


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (2, 7, 4, 16)).astype(np.float32)
    w = rng.normal(1, 0.1, 16).astype(np.float32)
    _close(t_layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           r_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5), 1e-6)
    pos = np.array([0, 1, 5, 100, 4095, 31000, 65535], np.int32)
    for theta in (1e4, 1e6):
        _close(t_layers.rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta),
               r_layers.rope(jnp.asarray(x), jnp.asarray(pos), theta), 1e-4)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = t_layers.rms_norm(xb, torch.from_numpy(w), 1e-5)
    assert got.dtype == torch.bfloat16
    _close(got, r_layers.rms_norm(jnp.asarray(xb.float().numpy(),
                                              jnp.bfloat16),
                                  jnp.asarray(w), 1e-5).astype(jnp.float32),
           0.07)


def _ref_ffn_entry(x, y, w, cfg):
    """The reference block's residual add and the norm after it, jitted
    together as in its block (XLA fuses the sum into the norm)."""
    s = x + y
    return s, r_layers.rms_norm(s, w, cfg.norm_eps)


@pytest.mark.parametrize("part", ["mlp_apply", "add_rms_norm"])
def test_ffn_rounds_as_the_reference_bfloat16(part):
    """yi-9b's dense FFN at reduced() in bf16, bit for bit against the
    reference's jitted lines: `mlp_apply` with `layers.silu` (XLA expands
    the logistic into exp, add and divide, each rounded to bf16;
    `torch.nn.functional.silu` rounds once and differs in 64% of the
    outputs) and `add_rms_norm` (the norm of the unrounded residual sum;
    the sum rounded before its norm differs in 22%)."""
    r_cfg, t_cfg = _cfgs("yi-9b", "bfloat16")
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 16, r_cfg.d_model)).astype(np.float32)
    rx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    if part == "mlp_apply":
        p = r_layers.init_mlp(jax.random.PRNGKey(3), r_cfg)
        want = [jax.jit(lambda p, x: r_layers.mlp_apply(p, x, r_cfg))(p, rx)]
        tp = t_layers.Params(**{k: torch.tensor(np.asarray(
            v, np.float32)).bfloat16() for k, v in p.items()})
        got = [t_layers.mlp_apply(tp, tx, t_cfg)]
    else:
        y = rng.normal(0, 1, x.shape).astype(np.float32)
        w = rng.normal(1, 0.1, r_cfg.d_model).astype(np.float32)
        want = jax.jit(lambda x, y, w: _ref_ffn_entry(x, y, w, r_cfg))(
            rx, jnp.asarray(y, jnp.bfloat16), jnp.asarray(w))
        got = t_layers.add_rms_norm(tx, torch.from_numpy(y).bfloat16(),
                                    torch.from_numpy(w), t_cfg.norm_eps)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(
            w_.astype(jnp.float32)))


@pytest.mark.parametrize(
    "b,sq,skv,h,kvh,d,off,win",
    [
        (2, 64, 64, 8, 2, 16, 0, 0),
        (1, 128, 128, 4, 4, 32, 0, 32),  # chunked-local
        (2, 1, 96, 8, 2, 16, 95, 0),  # decode-shaped, q_offset
        (1, 48, 48, 6, 3, 8, 0, 0),  # non-power-of-two
        (1, 256, 256, 2, 1, 8, 0, 64),
    ],
)
def test_flash_forward_matches_reference(b, sq, skv, h, kvh, d, off, win):
    """The online-softmax forward against the reference's flash forward and
    the port's naive oracle (float32, atol 2e-5 as the reference holds its
    own), windowed and not, with q_offset and GQA."""
    rng = np.random.default_rng(sq + win)
    q, k, v = (rng.normal(0, 1, s).astype(np.float32)
               for s in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d)))
    want = r_layers.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), off, win, 32, 32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = t_layers.flash_attention(tq, tk, tv, off, win, 32, 32)
    _close(got, want, 2e-5)
    _close(t_layers.attention_reference(tq, tk, tv, q_offset=off,
                                        window=win), want, 2e-5)


@pytest.mark.parametrize("arch", ["yi-9b", "codeqwen1.5-7b"])
@pytest.mark.parametrize("kind", ["attn", "attn_chunked"])
def test_attention_apply_and_decode_match_reference(arch, kind):
    """One attention block: the prefill path (output and the roped cache)
    and three decode steps against the grown cache, float32; chunked
    attention on a 6-token window (ring cache, same-window mask)."""
    r_cfg, t_cfg = _cfgs(arch, "float32")
    r_cfg = dataclasses.replace(r_cfg, chunk_size=6)
    t_cfg = dataclasses.replace(t_cfg, chunk_size=6)
    tree = jax.tree.map(np.asarray,
                        r_layers.init_attention(jax.random.PRNGKey(3), r_cfg))
    stacked = {"super": {"b0": {"core": {k: v[None] for k, v in tree.items()},
                                "norm1": np.ones((1, r_cfg.d_model))}},
               "embed": np.zeros((r_cfg.vocab, r_cfg.d_model)),
               "final_norm": np.ones(r_cfg.d_model),
               "head": np.zeros((r_cfg.d_model, r_cfg.vocab))}
    one = dataclasses.replace(t_cfg, n_layers=1, d_ff=0)
    p = convert.lm_params_from_reference(stacked, one, "cpu")["blocks"][0][
        "core"]
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (B, 10, r_cfg.d_model)).astype(np.float32)
    pos = np.arange(10, dtype=np.int32)
    want, r_cache = r_layers.attention_apply(
        tree, jnp.asarray(x), r_cfg, kind=kind, positions=jnp.asarray(pos))
    got, t_cache = t_layers.attention_apply(
        p, torch.from_numpy(x), t_cfg, kind=kind,
        positions=torch.from_numpy(pos))
    _close(got, want, 1e-4)
    for name in ("k", "v"):
        _close(t_cache[name], r_cache[name], 1e-5)
    if kind == "attn_chunked":
        r_cache = {n: r_layers.ring_from_prefill(c, 6) for n, c in
                   r_cache.items()}
        t_cache = {n: t_layers.ring_from_prefill(c, 6) for n, c in
                   t_cache.items()}
    else:
        r_cache = {n: jnp.pad(c, ((0, 0), (0, 3), (0, 0), (0, 0)))
                   for n, c in r_cache.items()}
        t_cache = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 3))
                   for n, c in t_cache.items()}
    for t in range(10, 13):
        xt = rng.normal(0, 1, (B, 1, r_cfg.d_model)).astype(np.float32)
        want, r_cache = r_layers.attention_decode(
            tree, jnp.asarray(xt), r_cache, jnp.asarray(t, jnp.int32), r_cfg,
            kind=kind)
        got, t_cache = t_layers.attention_decode(
            p, torch.from_numpy(xt), t_cache, t, t_cfg, kind=kind)
        _close(got, want, 1e-4)
        for name in ("k", "v"):
            _close(t_cache[name], r_cache[name], 1e-5)


# ---------------------------------------------------------------------------
# the model's steps
# ---------------------------------------------------------------------------


# musicgen's padded heads (MHA, 24 -> 32 at full width; reduced() drops
# the padding, so it is put back: 4 -> 8) and a GQA padding of yi's (4
# query heads over 2 KV heads -> 8, each group gaining 2 pad slots)
PADDED = {"musicgen-medium+pad": ("musicgen-medium", 8),
          "yi-9b+pad": ("yi-9b", 8)}


def _record_router_logits(monkeypatch):
    """Both packages' router logits (B, S, E) at every MoE call, in call
    order: the reference's sent out of its jitted steps by a debug
    callback (a decode step's one group of B tokens read back per row)."""
    ref, port = [], []
    orig_r, orig_t = r_moe.moe_apply, t_moe.moe_apply
    group = []

    def ref_wrap(p, x, cfg, moe):
        b, s, _ = x.shape
        if s == 1 and b > 1:  # the reference recurses on the batch's group
            group.append(True)
            try:
                return orig_r(p, x, cfg, moe)
            finally:
                group.pop()
        logits = jnp.einsum("bsd,de->bse", x, p["router"].astype(
            cfg.act_dtype))
        swap = bool(group)
        jax.debug.callback(lambda lg: ref.append(np.asarray(
            lg, np.float32).swapaxes(0, 1) if swap else np.asarray(
                lg, np.float32)), logits, ordered=True)
        return orig_r(p, x, cfg, moe)

    def port_wrap(p, x, cfg, moe):
        port.append((x @ p["router"]).float().numpy())
        return orig_t(p, x, cfg, moe)

    monkeypatch.setattr(r_moe, "moe_apply", ref_wrap)
    monkeypatch.setattr(t_moe, "moe_apply", port_wrap)
    return ref, port


def _bf16_tie(logits: np.ndarray, k: int) -> np.ndarray:
    """Whether each token's k-th and (k+1)-th router logits (bf16 numbers)
    are at most one bf16 step apart at the k-th: the smallest rounding
    difference in the logits can swap them (tests/test_torch_moe.py holds
    the same rule)."""
    srt = -np.sort(-logits, -1)
    step = 2.0 ** (np.floor(np.log2(np.abs(srt[..., k - 1]))) - 7)
    return srt[..., k - 1] - srt[..., k] <= step


def _diverged_rows(ref, port, k: int, rows: set) -> set:
    """The MoE routing rule.  Batch rows whose top-k expert set differs
    from the reference's at some call join `rows`; at a row's first such
    call, each differing token's reference router logits hold a bf16 tie
    between the k-th and (k+1)-th (`_bf16_tie`): the flip is the
    activations' rounding, not a routing fault."""
    jax.effects_barrier()
    assert len(ref) == len(port)
    for lr, lt in zip(ref, port):
        assert lr.shape == lt.shape
        pick = lambda lg: np.sort(np.argsort(-lg, -1, kind="stable")[
            ..., :k], -1)
        differ = (pick(lr) != pick(lt)).any(-1)  # (B, S)
        tie = _bf16_tie(lr, k)
        for b in sorted(set(np.nonzero(differ)[0]) - rows):
            assert tie[b][differ[b]].all(), (b, np.nonzero(differ[b]))
            rows.add(int(b))
    ref.clear()
    port.clear()
    return rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS + list(PADDED))
def test_prefill_and_decode_match_the_reference_steps(arch, dtype,
                                                      monkeypatch):
    """The port's prefill and three decode steps against the reference's
    jitted `make_prefill_step` and `make_serve_step`, teacher-forced on the
    same tokens: the logits within ATOL[dtype], recurrent states carried
    as caches.  With an MoE FFN the routing rule applies: a row whose
    expert choice differs from the reference's (bf16 drift at a margin
    the rule checks) is held no further; every step holds at least one."""
    kw = {}
    if arch in PADDED:
        arch, kw["attn_pad_heads"] = PADDED[arch]
    r_cfg, t_cfg, params, _, model, r_batch, t_batch = _setup(arch, dtype,
                                                              **kw)
    rec = _record_router_logits(monkeypatch) if r_cfg.moe else None
    diverged = set()

    def held(t_logits, r_logits):
        if rec is not None:
            _diverged_rows(*rec, r_cfg.moe.top_k, diverged)
        keep = [b for b in range(B) if b not in diverged]
        assert keep, "every row's routing flipped"
        _close(t_logits[keep], np.asarray(r_logits)[keep], ATOL[dtype])

    r_logits, r_caches = r_steps.make_prefill_step(r_cfg, None)(params,
                                                                r_batch)
    t_logits, t_caches = t_steps.make_prefill_step(t_cfg)(model, t_batch)
    held(t_logits, r_logits)
    r_caches = r_tfm.grow_attn_caches(r_caches, r_cfg, 3)
    t_caches = t_tfm.grow_attn_caches(t_caches, t_cfg, 3)
    r_step = r_steps.make_serve_step(r_cfg, None, sampler="greedy")
    t_step = t_steps.make_serve_step(t_cfg, sampler="greedy")
    total0 = S0 + (r_cfg.frontend_len if r_cfg.frontend else 0)
    rng = np.random.default_rng(5)
    for t in range(3):
        tok = rng.integers(0, r_cfg.vocab, (B, 1)).astype(np.int32)
        r_tok, r_logits, r_caches = r_step(
            params, jnp.asarray(tok), r_caches,
            jnp.asarray(total0 + t, jnp.int32), jax.random.key(0))
        t_tok, t_logits, t_caches = t_step(model, torch.from_numpy(tok),
                                           t_caches, total0 + t, prng.key(0))
        held(t_logits, r_logits)
        assert t_logits.dtype == torch.float32 and t_tok.dtype == torch.int32
    if dtype == "float32":
        assert not diverged


def _record_drops(monkeypatch, b: int) -> torch.Tensor:
    """A (b,) tensor that gains, at every call of the port's `moe_apply`,
    the assignments it drops at capacity per batch row: `route` over the
    groups it routes, each dropped assignment counted at its token's row."""
    dropped = torch.zeros(b, dtype=torch.int64)
    orig = t_moe.moe_apply

    def wrap(p, x, cfg, moe):
        g = t_moe.groups(x)
        r = t_moe.route(g, p["router"], moe)
        d = torch.zeros(g.shape[:2], dtype=torch.int64).scatter_add_(
            1, r.stok, (~r.keep).long())
        dropped.add_((d.transpose(0, 1) if g is not x else d).sum(-1))
        return orig(p, x, cfg, moe)

    monkeypatch.setattr(t_moe, "moe_apply", wrap)
    return dropped


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-350m"])
def test_prefill_then_decode_is_prefill_over_one_more(arch, monkeypatch):
    """Prefill over S tokens then a decode step at position S gives the
    logits a prefill over the S + 1 tokens gives at its last position
    (float32): Mamba's step continues its scan, mLSTM's exact step its
    chunkwise form (S + 1 = 9 runs chunks of one), sLSTM's step its loop.
    MoE rows that dropped an assignment at capacity in either run (the
    capacities of a 9-token row and of a decode group differ) are not
    held; at least one row is."""
    cfg = dataclasses.replace(t_configs.get_config(arch).reduced(),
                              dtype="float32")
    model = t_tfm.init_model(cfg, seed=4, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, (B, S0 + 1)).astype(np.int32))
    dropped = _record_drops(monkeypatch, B)
    whole, _ = t_tfm.prefill(model, cfg, {"tokens": toks})
    _, caches = t_tfm.prefill(model, cfg, {"tokens": toks[:, :S0]})
    caches = t_tfm.grow_attn_caches(caches, cfg, 1)
    step, _ = t_tfm.decode_step(model, cfg, toks[:, S0:], caches, S0)
    keep = dropped == 0
    assert keep.any()
    _close(step[keep], whole[keep].numpy(), ATOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_forward(dtype):
    """Decode with a growing cache reproduces the teacher-forced forward's
    logits (the reference's test_full_attn_decode_matches_forward)."""
    _, cfg = _cfgs("yi-9b", dtype)
    model = t_tfm.init_model(cfg, seed=2, device="cpu")
    s = 12
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (B, s)).astype(np.int32))
    logits, _ = t_tfm.forward(model, cfg, {"tokens": toks})
    caches = t_tfm.init_decode_caches(cfg, B, s, device="cpu")
    dec = []
    for t in range(s):
        lg, caches = t_tfm.decode_step(model, cfg, toks[:, t:t + 1], caches,
                                       t)
        dec.append(lg)
    _close(torch.stack(dec, dim=1), logits.numpy(), ATOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_ky_gives_the_reference_tokens(arch):
    """`generate(..., sampler="ky")` at float32 with the reference's weights
    and key gives the reference's tokens.  The two models' logits differ in
    the last bits, which moves an integer LUT weight where the lerp lands
    on a rounding boundary: every step is replayed teacher-forced on the
    reference's tokens, and wherever the two sides' weights are equal the
    port's draw equals the reference's token; a step whose weights differ
    (by 1, at such a boundary) is shown by those weights, and the free-
    running tokens are held equal up to it."""
    gen = 6
    r_cfg, t_cfg, params, _, model, r_batch, t_batch = _setup(arch,
                                                              "float32")
    jk = jax.random.key(11)
    key = convert.key_from_reference(np.asarray(jax.random.key_data(jk)))
    want, _ = r_serve.generate(r_cfg, params, r_batch["tokens"], gen,
                               sampler="ky", features=r_batch.get(
                                   "features"), key=jk)
    want = np.array(want)
    got, times = t_serve.generate(t_cfg, model, t_batch["tokens"], gen,
                                  sampler="ky",
                                  features=t_batch.get("features"), key=key)
    assert got.shape == want.shape and got.dtype == torch.int32
    assert len(times) == gen - 1

    tab, spec = build_exp_weight_lut(device="cpu")
    r_logits, r_caches = r_steps.make_prefill_step(r_cfg, None)(params,
                                                                r_batch)
    t_logits, t_caches = t_steps.make_prefill_step(t_cfg)(model, t_batch)
    r_caches = r_tfm.grow_attn_caches(r_caches, r_cfg, gen)
    t_caches = t_tfm.grow_attn_caches(t_caches, t_cfg, gen)
    r_step = r_steps.make_serve_step(r_cfg, None, sampler="ky")
    total0 = S0 + (r_cfg.frontend_len if r_cfg.frontend else 0)
    straddles = []
    k = key
    for t in range(gen):
        if t:
            k, sub = prng.split(k)
            prev = want[:, S0 + t - 1:S0 + t]
            r_tok, r_logits, r_caches = r_step(
                params, jnp.asarray(prev), r_caches,
                jnp.asarray(total0 + t - 1, jnp.int32),
                jax.random.wrap_key_data(jnp.asarray(
                    [sub.k1, sub.k2], jnp.uint32)))
            np.testing.assert_array_equal(np.asarray(r_tok), want[:, S0 + t])
            t_logits, t_caches = t_tfm.decode_step(
                model, t_cfg, torch.from_numpy(prev), t_caches,
                total0 + t - 1)
        else:
            sub = k
        _close(t_logits, r_logits, ATOL["float32"])
        w_r = t_ops.lut_exp_weights(torch.from_numpy(np.array(r_logits)),
                                    tab, spec)
        w_t = t_ops.lut_exp_weights(t_logits, tab, spec)
        if torch.equal(w_r, w_t):
            drawn = t_sampling.ky_token_sample(t_logits, sub,
                                               exp_table=tab, exp_spec=spec)
            np.testing.assert_array_equal(drawn.numpy(), want[:, S0 + t])
        else:
            assert int((w_r - w_t).abs().max()) == 1, (t, w_r, w_t)
            straddles.append(t)
    agree = S0 + (straddles[0] if straddles else gen)
    np.testing.assert_array_equal(got.numpy()[:, :agree], want[:, :agree])
    assert len(straddles) < gen, straddles


# ---------------------------------------------------------------------------
# the CLI, and what is not ported
# ---------------------------------------------------------------------------


def test_serve_cli_runs_on_the_cpu(capsys):
    toks = t_serve.main(["--arch", "yi-9b", "--reduced", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "6", "--gen", "3",
                         "--sampler", "ky"])
    out = capsys.readouterr().out
    assert toks.shape == (2, 9)
    assert "arch=yi-9b-smoke sampler=ky" in out and "tok/s" in out
    assert int(toks.min()) >= 0 and int(toks.max()) < 256


def test_main_reports_na_throughput_for_short_gen(capsys):
    """--gen 1 leaves no steady-state decode step to time: n/a, not 0.0."""
    t_serve.main(["--arch", "musicgen-medium", "--reduced", "--device",
                  "cpu", "--batch", "2", "--prompt-len", "6", "--gen", "1",
                  "--sampler", "greedy"])
    out = capsys.readouterr().out
    assert "decode throughput n/a" in out
    assert "0.0 tok/s" not in out


def test_a_mesh_raises():
    """What is not a mesh, a --mesh spec that is not DxM, and a mesh of
    several ranks outside a world of its size raise ValueError before
    anything runs (the meshes themselves: test_torch_lm_mesh.py)."""
    cfg = t_configs.get_config("yi-9b").reduced()
    mesh = object()
    with pytest.raises(ValueError, match="not a mesh"):
        t_steps.make_prefill_step(cfg, mesh)
    with pytest.raises(ValueError, match="not a mesh"):
        t_steps.make_serve_step(cfg, mesh)
    model = t_tfm.init_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="not a mesh"):
        t_serve.generate(cfg, model, torch.zeros((1, 4), dtype=torch.int32),
                         2, mesh=mesh)
    common = ["--arch", "yi-9b", "--reduced", "--device", "cpu"]
    with pytest.raises(ValueError, match="DxM"):
        t_serve.main(common + ["--mesh", "2by4"])
    with pytest.raises(ValueError, match="world of 8 ranks"):
        t_serve.main(common + ["--mesh", "2x4"])


def test_lm_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults would run")
    cfg = t_configs.get_config("yi-9b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_tfm.init_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_tfm.init_decode_caches(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_serve.main(["--arch", "yi-9b", "--reduced"])


def test_configs_are_the_references():
    """The ten configs, their counts and reduced variants, field by field;
    `act_dtype` is a torch dtype."""
    assert t_configs.list_archs() == r_configs.list_archs()
    for arch in t_configs.list_archs():
        r, t = r_configs.get_config(arch), t_configs.get_config(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
        assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(
            r.reduced())
        assert (t.n_params(), t.n_active_params(), t.hd) == (
            r.n_params(), r.n_active_params(), r.hd)
        assert t.act_dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-9b", "qwen2-moe-a2.7b", "xlstm-350m",
                                  "jamba-1.5-large-398b"])
def test_reduced_serve_on_the_card_matches_the_cpu(arch):
    """A reduced model at float32 on the card (dense, MoE, xLSTM, the
    hybrid): prefill and decode logits within the float32 tolerance of
    the CPU's, and every step's tokens equal to the twin's draw on the
    card's logits copied to the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    _, cfg = _cfgs(arch, "float32")
    cpu = t_tfm.init_model(cfg, seed=3, device="cpu")
    dev = torch.device("cuda")
    card = t_tfm.init_model(cfg, seed=3, device="cpu").to(dev)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (B, S0)).astype(np.int32))
    lc, cc = t_tfm.prefill(cpu, cfg, {"tokens": toks})
    lg, cg = t_tfm.prefill(card, cfg, {"tokens": toks.to(dev)})
    _close(lg.cpu(), lc.numpy(), ATOL["float32"])
    cg = t_tfm.grow_attn_caches(cg, cfg, 4)
    cc = t_tfm.grow_attn_caches(cc, cfg, 4)
    step = t_steps.make_serve_step(cfg, sampler="ky")
    tok = toks[:, -1:].to(dev)
    for t in range(4):
        key = prng.key(t)
        nxt, logits, cg = step(card, tok, cg, S0 + t, key)
        lc, cc = t_tfm.decode_step(cpu, cfg, tok.cpu(), cc, S0 + t)
        _close(logits.cpu(), lc.numpy(), ATOL["float32"])
        want = t_sampling.ky_token_sample(logits.cpu(), key)
        assert torch.equal(nxt.cpu(), want)
        tok = nxt[:, None]
