"""The port's token samplers (`repro_torch.models.sampling`) against the
reference's (`repro.models.sampling`).

  * `ky_token_sample` is bit-equal to `jax.jit(ky_token_sample)` of the
    reference on the same float32 logits and key, at V = 256, 2048 and
    64,000 (1, 2 and 3 tree levels), B = 1 and 5, several seeds, on normal
    logits and on logits holding bf16 values (as the model's head gives
    them: many ties);
  * K1's twin at 128 bins (the tree levels' width, past the reference
    Pallas kernel's 127) equals the reference's `ky_sample_ref` at the
    levels' precisions 17, 24 and 30, edge rows included;
  * the reference's statistical checks (tests/test_token_sampling.py) hold
    on the port, at the reference's tolerances;
  * gumbel is held statistically, greedy exactly.

CUDA-marked tests hold K1 at 128 bins and the sampler on the card against
the twins, with K2 launched once and K1 once per level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ky as r_ky
from repro.models import sampling as r_sampling
from repro_torch import convert, prng
from repro_torch.core import ky as t_ky
from repro_torch.kernels import interp_lut, ky_sampler
from repro_torch.models import sampling as t_sampling

REF_KY = jax.jit(r_sampling.ky_token_sample)


def _key(seed: int):
    """A reference key and the same key for the port."""
    jk = jax.random.key(seed)
    return jk, convert.key_from_reference(np.asarray(jax.random.key_data(jk)))


def _logits(kind: str, b: int, v: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(1000 * seed + v + b)
    x = rng.normal(0, 3, (b, v)).astype(np.float32)
    if kind == "bf16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


# ---------------------------------------------------------------------------
# bit-equality with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["normal", "bf16"])
@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("v", [256, 2048, 64000])
def test_ky_token_sample_is_bit_equal_to_the_jitted_reference(v, b, kind):
    for seed in (0, 1, 2):
        logits = _logits(kind, b, v, seed)
        jk, key = _key(seed)
        want = np.asarray(REF_KY(jnp.asarray(logits), jk))
        got = t_sampling.ky_token_sample(torch.from_numpy(logits), key)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_levels_and_precisions_follow_the_vocab(monkeypatch):
    """64,000 = 500 x 128: three levels (64,000 -> 512 -> 128) drawn at
    precisions 30, 24 and 17, each one 128-bin draw of (B, 128)."""
    seen = []
    real = ky_sampler.ky_sample_keyed

    def spy(weights, key, **kw):
        seen.append((tuple(weights.shape), kw["n_bins"], kw["precision"]))
        return real(weights, key, **kw)

    logits = torch.from_numpy(_logits("normal", 3, 64000, 0))
    monkeypatch.setattr(ky_sampler, "ky_sample_keyed", spy)
    t_sampling.ky_token_sample(logits, prng.key(0))
    assert seen == [((3, 128), 128, 30), ((3, 128), 128, 24),
                    ((3, 128), 128, 17)]
    assert [t_sampling.level_precision(li) for li in range(4)] == [
        17, 24, 30, 30]


def _edge_rows(rows: int, p: int, seed: int) -> np.ndarray:
    """(rows, 128) weights in [0, 256) with edge rows first: all zero,
    one-hot, negative, all below -1, multiples of 2^p, a sum above 2^p, a
    sum wrapping int32, all -1, and a level's sums of 8-bit weights."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 256, (rows, 128)).astype(np.int64)
    w[0] = 0
    w[1] = 0
    w[1, 127] = 255
    w[2] = rng.integers(-300, 50, 128)
    w[3] = rng.integers(-1000, -1, 128)
    w[4] = 1 << p
    w[5] = 0
    w[5, 0] = 1 << p
    w[6] = (1 << p) // 2 + rng.integers(0, 1000, 128)
    w[7] = 2**31 - 1
    w[8] = -1
    w[9] = rng.integers(0, 255 * 128, 128)
    return w.astype(np.int32)


@pytest.mark.parametrize("precision", [17, 24, 30])
def test_k1_twin_at_128_bins_equals_ky_sample_ref(precision):
    """The twin (what K1's wrappers run on CPU tensors) at 128 bins against
    the reference's plain walk: labels and stats, bit for bit, the
    bit-exhaustion fallback (max_retries=1) included."""
    for max_retries in (8, 1):
        w = _edge_rows(70, precision, precision)
        n_words = ky_sampler.n_words_for(precision, max_retries)
        words = np.random.default_rng(precision + max_retries).integers(
            0, 2**32, (70, n_words), dtype=np.uint64).astype(np.uint32)
        lab_r, st_r = r_ky.ky_sample_ref(
            jnp.asarray(w), jnp.asarray(words), n_bins=128,
            precision=precision, max_retries=max_retries)
        lab_t, st_t = ky_sampler.ky_sample_kernel(
            torch.from_numpy(w), torch.from_numpy(words.view(np.int32)),
            n_bins=128, precision=precision, max_retries=max_retries)
        np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_r))
        for name in ("bits_used", "rejections", "fallback"):
            np.testing.assert_array_equal(st_t[name].numpy(),
                                          np.asarray(st_r[name]))
        if max_retries == 1:
            # the fallback is the plain argmax: no padding lane at 128
            fb = st_t["fallback"].numpy()
            assert fb.any()
            np.testing.assert_array_equal(
                lab_t.numpy()[fb], w[fb].argmax(-1))


def test_k1_takes_128_bins_and_refuses_129():
    w = torch.zeros((2, 129), dtype=torch.int32)
    with pytest.raises(ValueError):
        ky_sampler.ky_sample_keyed(w, prng.key(0), n_bins=129)
    with pytest.raises(ValueError):
        t_sampling.ops.ky_sample(w, prng.key(0))
    lab = t_sampling.ops.ky_sample(w[:, :128].contiguous(), prng.key(0))
    assert lab.shape == (2,)


# ---------------------------------------------------------------------------
# the reference's statistical checks, on the port
# ---------------------------------------------------------------------------


def _draw(logits_row: np.ndarray, b: int, key: prng.Key,
          chunk: int = 1000) -> np.ndarray:
    """`b` draws from one row of logits, `chunk` rows per call with keys
    split from `key` (the twins' float64 lerp of one call over b x V
    would take gigabytes at the largest vocab)."""
    out = []
    keys = prng.split(key, -(-b // chunk))
    for i, k in enumerate(keys):
        n = min(chunk, b - i * chunk)
        rows = torch.from_numpy(np.tile(logits_row, (n, 1)))
        out.append(t_sampling.ky_token_sample(rows, k).numpy())
    return np.concatenate(out)


@pytest.mark.parametrize("v", [50, 2048, 50304])
def test_ky_matches_target_distribution(v):
    """The hierarchical (128-ary) draw is exact for the quantized weights:
    8 supported tokens, 8,000 draws, TV against softmax below 0.03."""
    rng = np.random.default_rng(v)
    logits_row = np.full(v, -40.0, np.float32)
    support = rng.choice(v, size=8, replace=False)
    logits_row[support] = rng.uniform(0, 3, 8)
    b = 8000
    toks = _draw(logits_row, b, prng.key(0))
    assert np.isin(toks, support).all()
    p = np.exp(logits_row[support] - logits_row[support].max())
    p /= p.sum()
    emp = np.array([(toks == s).mean() for s in support])
    assert 0.5 * np.abs(emp - p).sum() < 0.03


def test_ky_vs_gumbel_statistical_agreement():
    """KY (8-bit quantized weights) and gumbel-max agree up to multinomial
    noise and the 8-bit quantization bias, at the reference's bounds."""
    v, b = 1000, 20000
    logits_row = np.random.default_rng(0).normal(0, 2, v).astype(np.float32)
    t_ky_draws = _draw(logits_row, b, prng.key(1), chunk=5000)
    t_gb = t_sampling.gumbel_token_sample(
        torch.from_numpy(np.tile(logits_row, (b, 1))), prng.key(2)).numpy()
    h_ky = np.bincount(t_ky_draws, minlength=v) / b
    h_gb = np.bincount(t_gb, minlength=v) / b
    p = np.exp(logits_row - logits_row.max())
    p /= p.sum()
    noise = 0.5 * np.sqrt(2 / np.pi) * np.sqrt(p * (1 - p) / b).sum()
    assert 0.5 * np.abs(h_gb - p).sum() < 2.0 * noise
    assert 0.5 * np.abs(h_ky - p).sum() < 2.0 * noise + 0.03
    assert 0.5 * np.abs(h_ky - h_gb).sum() < 3.0 * noise + 0.03


def test_peaked_distribution_deterministic():
    v = 4096
    logits_row = np.full(v, -100.0, np.float32)
    logits_row[1234] = 10.0
    logits = torch.from_numpy(np.tile(logits_row, (64, 1)))
    assert (t_sampling.ky_token_sample(logits, prng.key(3)) == 1234).all()
    assert (t_sampling.greedy_token(logits) == 1234).all()


def test_per_row_distributions_differ():
    """Each batch row samples from its own logits (no cross-row leakage)."""
    v = 300
    l0 = np.full(v, -50.0, np.float32)
    l1 = l0.copy()
    l0[7] = 5.0
    l1[200] = 5.0
    logits = torch.from_numpy(np.stack([l0, l1] * 32))
    toks = t_sampling.sample_tokens(logits, prng.key(4), "ky").numpy()
    assert (toks[0::2] == 7).all() and (toks[1::2] == 200).all()


def test_token_ids_in_range():
    for v in (129, 16384, 202048):
        logits = torch.from_numpy(
            np.random.default_rng(v % 7).normal(0, 1, (16, v))
            .astype(np.float32))
        toks = t_sampling.ky_token_sample(logits, prng.key(5)).numpy()
        assert ((toks >= 0) & (toks < v)).all()


# ---------------------------------------------------------------------------
# gumbel and greedy
# ---------------------------------------------------------------------------


def test_gumbel_matches_softmax():
    """Gumbel-max on the port's bit-exact uniform draw (torch's logs may
    differ from XLA's in the last bit): the empirical law of 20,000 draws
    within 2x the multinomial noise of softmax, as the reference's test
    bounds its own."""
    v, b = 300, 20000
    logits_row = np.random.default_rng(3).normal(0, 1.5, v).astype(
        np.float32)
    toks = t_sampling.gumbel_token_sample(
        torch.from_numpy(np.tile(logits_row, (b, 1))), prng.key(6)).numpy()
    p = np.exp(logits_row - logits_row.max())
    p /= p.sum()
    noise = 0.5 * np.sqrt(2 / np.pi) * np.sqrt(p * (1 - p) / b).sum()
    assert 0.5 * np.abs(np.bincount(toks, minlength=v) / b - p).sum() \
        < 2.0 * noise


@pytest.mark.parametrize("kind", ["normal", "bf16"])
def test_greedy_equals_the_reference(kind):
    """The first index of the largest logit, ties (bf16 values) included."""
    logits = _logits(kind, 16, 2048, 4)
    logits[3, 100] = logits[3, 200] = logits[3].max() + 1.0
    want = np.asarray(r_sampling.greedy_token(jnp.asarray(logits)))
    got = t_sampling.greedy_token(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[3] == 100
    got = t_sampling.sample_tokens(torch.from_numpy(logits), prng.key(0),
                                   "greedy")
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        t_sampling.sample_tokens(torch.from_numpy(logits), prng.key(0),
                                 "top_p")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")


@pytest.mark.cuda
def test_k1_at_128_bins_matches_the_twin_on_the_card():
    """Both K1 entries at 128 bins against the twin, precisions 17, 24 and
    30, both budgets, 4,099 rows (a ragged last warp), edge rows first."""
    _require_card()
    dev = torch.device("cuda")
    for precision in (17, 24, 30):
        for max_retries in (8, 1):
            w = torch.from_numpy(_edge_rows(4099, precision, 7)).to(dev)
            key = prng.key(precision + max_retries)
            kw = dict(n_bins=128, precision=precision,
                      max_retries=max_retries)
            words = t_ky.random_words(
                key, (w.shape[0],),
                ky_sampler.n_words_for(precision, max_retries), dev)
            lab_t, st_t = ky_sampler.ky_sample_kernel_ref(w, words, **kw)
            for lab, st in (ky_sampler.ky_sample_kernel(w, words, **kw),
                            ky_sampler.ky_sample_keyed(w, key, **kw)):
                assert torch.equal(lab, lab_t)
                for name in ("bits_used", "rejections", "fallback"):
                    assert torch.equal(st[name], st_t[name])


@pytest.mark.cuda
def test_token_sampler_on_the_card_matches_the_twin(monkeypatch):
    """`ky_token_sample` on CUDA logits: the twin's tokens on the same
    logits copied to the host, with one K2 launch and one K1 launch per
    level, and no word made in plain torch."""
    _require_card()

    def words_made(*args, **kwargs):
        raise AssertionError("the draw's words were made in plain torch")

    for v, levels in ((256, 2), (2048, 2), (64000, 3)):
        logits = _logits("bf16", 8, v, 5)
        want = t_sampling.ky_token_sample(torch.from_numpy(logits),
                                          prng.key(v))
        k1 = ky_sampler.ky_sample_kernel.launches
        k2 = interp_lut.interp_kernel.launches
        with monkeypatch.context() as m:
            m.setattr(prng, "_raw_bits", words_made)
            got = t_sampling.ky_token_sample(
                torch.from_numpy(logits).cuda(), prng.key(v))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
        assert ky_sampler.ky_sample_kernel.launches == k1 + levels
        assert interp_lut.interp_kernel.launches == k2 + 1
