"""The port's LM serving path (`repro_torch.configs`, `.models`,
`.launch.steps`, `.launch.serve`) against the reference's, at `reduced()`
sizes of yi-9b (GQA), codeqwen1.5-7b (qkv bias), musicgen-medium (audio
frontend) and internvl2-76b (vision frontend).

Both packages get the same weights: the reference's `init_model` tree,
carried across by `convert.lm_params_from_reference`.  Tolerances:

  * float32 (`dataclasses.replace(cfg, dtype="float32")`): atol 1e-4 on
    logits of magnitude ~3 (measured differences ~3e-6: XLA's and torch's
    sums, pow, cos and sin round differently in the last bit);
  * bfloat16: atol 0.15, the reference's own bound for bf16 activations
    taken in two execution orders (tests/test_models_smoke.py);
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
from repro.models import transformer as r_tfm
from repro_torch import configs as t_configs
from repro_torch import convert, prng
from repro_torch.kernels import ops as t_ops
from repro_torch.core.interp import build_exp_weight_lut
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.models import layers as t_layers
from repro_torch.models import sampling as t_sampling
from repro_torch.models import transformer as t_tfm

ARCHS = ["yi-9b", "codeqwen1.5-7b", "musicgen-medium", "internvl2-76b"]
DENSE_FULL = ["yi-9b", "codeqwen1.5-7b", "musicgen-medium", "internvl2-76b",
              "mistral-large-123b", "qwen2-72b"]
NOT_PORTED = ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e",
              "jamba-1.5-large-398b", "xlstm-350m"]
ATOL = {"float32": 1e-4, "bfloat16": 0.15}
B, S0 = 2, 8


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
        for name, want in ref["core"].items():
            np.testing.assert_array_equal(
                blk["core"][name].numpy().reshape(want.shape[1:]),
                want[i // period])
        for name, want in ref["ffn"].items():
            np.testing.assert_array_equal(blk["ffn"][name].numpy(),
                                          want[i // period])
        for name in ("norm1", "norm2"):
            np.testing.assert_array_equal(blk[name].numpy(),
                                          ref[name][i // period])
    for name in ("embed", "head", "final_norm", "frontend_proj"):
        assert (name in model) == (name in tree)
        if name in tree:
            np.testing.assert_array_equal(model[name].numpy(), tree[name])


@pytest.mark.parametrize("arch", DENSE_FULL)
def test_full_width_model_on_meta_has_n_params(arch):
    """At full width, on the `meta` device (shapes only): `n_params()` plus
    what it leaves out, the final norm, the qkv biases, the frontend
    projection and the padded heads."""
    cfg = t_configs.get_config(arch)
    model = t_tfm.init_model(cfg, device="meta")
    count = sum(p.numel() for p in model.parameters())
    hp, kvp, _, _ = t_layers.head_geometry(cfg)
    pad = cfg.n_layers * cfg.d_model * cfg.hd * (
        2 * (hp - cfg.n_heads) + 2 * (kvp - cfg.n_kv_heads))
    front = t_tfm.FRONTEND_DIM * cfg.d_model if cfg.frontend else 0
    bias = cfg.n_layers * cfg.hd * (hp + 2 * kvp) if cfg.qkv_bias else 0
    assert count == cfg.n_params() + cfg.d_model + pad + front + bias
    assert all(p.dtype == torch.bfloat16 for n, p in model.named_parameters()
               if "norm" not in n)
    if arch == "yi-9b":
        assert count == 8_829_407_232
        assert sum(p.numel() * p.element_size()
                   for p in model.parameters()) < 17.7e9


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS + list(PADDED))
def test_prefill_and_decode_match_the_reference_steps(arch, dtype):
    """The port's prefill and three decode steps against the reference's
    jitted `make_prefill_step` and `make_serve_step`, teacher-forced on the
    same tokens: the logits within ATOL[dtype]."""
    kw = {}
    if arch in PADDED:
        arch, kw["attn_pad_heads"] = PADDED[arch]
    r_cfg, t_cfg, params, _, model, r_batch, t_batch = _setup(arch, dtype,
                                                              **kw)
    r_logits, r_caches = r_steps.make_prefill_step(r_cfg, None)(params,
                                                                r_batch)
    t_logits, t_caches = t_steps.make_prefill_step(t_cfg)(model, t_batch)
    _close(t_logits, r_logits, ATOL[dtype])
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
        _close(t_logits, r_logits, ATOL[dtype])
        assert t_logits.dtype == torch.float32 and t_tok.dtype == torch.int32


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


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_unported_blocks_raise(arch):
    cfg = t_configs.get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_tfm.init_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_tfm.init_decode_caches(cfg, 1, 4, device="cpu")


def test_a_mesh_raises():
    cfg = t_configs.get_config("yi-9b").reduced()
    mesh = object()
    with pytest.raises(NotImplementedError, match="item 4"):
        t_steps.make_prefill_step(cfg, mesh)
    with pytest.raises(NotImplementedError, match="item 4"):
        t_steps.make_serve_step(cfg, mesh)
    model = t_tfm.init_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 4"):
        t_serve.generate(cfg, model, torch.zeros((1, 4), dtype=torch.int32),
                         2, mesh=mesh)


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
def test_reduced_serve_on_the_card_matches_the_cpu():
    """yi-9b reduced at float32 on the card: prefill and decode logits
    within the float32 tolerance of the CPU's, and every step's tokens
    equal to the twin's draw on the card's logits copied to the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    _, cfg = _cfgs("yi-9b", "float32")
    cpu = t_tfm.init_model(cfg, seed=3, device="cpu")
    dev = torch.device("cuda")
    card = t_tfm.init_model(cfg, seed=3, device="cpu").to(dev)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (B, S0)).astype(np.int32))
    lc, cc = t_tfm.prefill(cpu, cfg, {"tokens": toks})
    lg, cg = t_tfm.prefill(card, cfg, {"tokens": toks.to(dev)})
    _close(lg.cpu(), lc.numpy(), ATOL["float32"])
    cg = t_tfm.grow_attn_caches(cg, cfg, 4)
    step = t_steps.make_serve_step(cfg, sampler="ky")
    tok = toks[:, -1:].to(dev)
    for t in range(4):
        key = prng.key(t)
        nxt, logits, cg = step(card, tok, cg, S0 + t, key)
        want = t_sampling.ky_token_sample(logits.cpu(), key)
        assert torch.equal(nxt.cpu(), want)
        tok = nxt[:, None]
