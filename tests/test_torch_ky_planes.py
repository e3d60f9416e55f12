"""K1's plane walk (`csrc/ky_sampler.cu`) held against the reference.

The CUDA kernel cannot run on the CPU, so its arithmetic is written out
here as a small numpy model, step for step as the kernel takes it:
`prepare` (the clamped sum wrapped in int32, the uniform row, k and the
rejection bin), the planes of scaled weights over the bins only (the
32 x 32 bit transpose of rows wider than 8 bins, one 32-bit word per 32
bins; columns formed from the weights for narrower rows), the rejection
bin held apart, the (d+1)-th set bit of the accepting level, and the
argmax fallback.  The model is held bit for bit against the reference's
Pallas `ky_sample_kernel` (interpret mode), its `core.ky.ky_sample_ref`
and the port's twin, at 1-127 bins, precision 16 and 21, on rows that are
all zero, one-hot, negative, all below -1, multiples of 2^p, summing above
2^p or wrapping in int32, and with `max_retries=1`, where bits run out.
At 128 bins (the token sampler's tree levels), which the Pallas kernel
does not take, the model is held against `ky_sample_ref` and the twin at
the levels' precisions 17, 24 and 30.
The keyed entry's counters are held against the reference's
`ops.ky_sample`; a CUDA-marked test holds both entries of the kernel
against the twin on the card.  Tolerance: bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ky as r_ky
from repro.kernels import ky_sampler as r_ks
from repro.kernels import ops as r_ops
from repro_torch import convert, prng
from repro_torch.core import ky as t_ky
from repro_torch.kernels import ky_sampler as t_ks
from repro_torch.kernels import ops as t_ops

WIDTHS = [1, 2, 3, 4, 15, 16, 31, 32, 33, 63, 64, 65, 127]
MAX_BINS = 128  # K1's widest row: the rejection bin is held apart
PRECISIONS = [16, 21]
M32 = 0xFFFFFFFF
LANES_MAX = 8  # rows up to this many bins take the register layout

# ---------------------------------------------------------------------------
# numpy model of csrc/ky_sampler.cu
# ---------------------------------------------------------------------------


def _i32(x: int) -> int:
    x &= M32
    return x - (1 << 32) if x >> 31 else x


def _popc(x: int) -> int:
    return bin(x).count("1")


def transpose32(a):
    """`transpose32`: a[i] (bin i) -> a[b] (bit b of every bin)."""
    a = list(a)
    for j, m in ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F),
                 (2, 0x33333333), (1, 0x55555555)):
        for k in range(32):
            if k & j:
                continue
            t = ((a[k] >> j) ^ a[k + j]) & m
            a[k + j] ^= t
            a[k] = (a[k] ^ (t << j)) & M32
    return a


def nth_set_bit(x: int, n: int, width: int = 32) -> int:
    """`nth_set_bit<width>`: the position of the set bit of rank n (from
    0) of x < 2^width."""
    pos = 0
    w = width // 2
    while w:
        c = _popc(x & ((1 << w) - 1))
        if n >= c:
            n -= c
            x >>= w
            pos += w
        w //= 2
    return pos


def prepare(w, p):
    """`prepare` and `scaled`: the scaled bins (uint32) and the rejection
    bin (int32)."""
    s = 0
    for v in w:
        s = (s + max(int(v), 0)) & M32
    uniform = _i32(s) <= 0
    if uniform:
        s = len(w)
    k = max((1 << p) // s, 1)
    m = [((1 if uniform else max(int(v), 0)) * k) & M32 for v in w]
    return m, _i32((1 << p) - k * s)


def level_bit(level: int, p: int) -> int:
    return p - 1 - level if level < p else 31


def planes_of(m, p):
    """The p + 1 planes (slot p - 1 - b holds bit b, slot p the sign) of
    `ky_planes_kernel`, each a list of one word per 32 bins."""
    nw = -(-len(m) // 32)
    planes = [[0] * nw for _ in range(p + 1)]
    for j in range(nw):
        a = transpose32([m[32 * j + i] if 32 * j + i < len(m) else 0
                         for i in range(32)])
        for b in range(32):
            if b < p:
                planes[p - 1 - b][j] = a[b]
            elif b == 31:
                planes[p][j] = a[b]
    return planes


def plane_walk(column, rej, word_of, p, total_steps, width):
    """`plane_walk<NW, width>`: (label or -1, bits, rejections, done)."""
    d = level = bits = rejs = 0
    word = 0
    for t in range(total_steps):
        if t % 32 == 0:
            word = word_of(t // 32)
        d = _i32(2 * d + ((word >> (t % 32)) & 1))
        bits += 1
        if d < 0:
            return 0, bits, rejs, True
        b = level_bit(level, p)
        col = column(level, b)
        c = sum(_popc(x) for x in col)
        if c > d:
            r = d
            for j, x in enumerate(col):
                if r < _popc(x):
                    return (32 * j + nth_set_bit(x, r, width), bits, rejs,
                            True)
                r -= _popc(x)
        total = c + ((rej >> b) & 1)
        if total > d:
            rejs += 1
            d = level = 0
        else:
            d -= total
            level += 1
    return -1, bits, rejs, False


def argmax_fallback(w) -> int:
    """The first bin of the largest weight, or lane n_bins (the Pallas
    kernel's -1 padding) when every weight is below -1 and the row has a
    padding lane."""
    mx, amax = int(w[0]), 0
    for i, v in enumerate(w):
        if v > mx:
            mx, amax = int(v), i
    return len(w) if mx < -1 and len(w) < MAX_BINS else amax


def model_draw(weights, words, p, max_retries):
    """(labels, bits_used, rejections, fallback) of every row, int32."""
    out = []
    for w, row_words in zip(weights, words):
        m, rej = prepare(w, p)
        n = len(w)
        if n <= LANES_MAX:  # ky_lanes_kernel<CAP>, CAP = 4 or 8
            width = 4 if n <= 4 else 8

            def column(level, b):
                return [sum(((m[i] >> b) & 1) << i for i in range(n))]
        else:
            width, planes = 32, planes_of(m, p)

            def column(level, b):
                return planes[min(level, p)]
        label, bits, rejs, done = plane_walk(
            column, rej, lambda j: int(row_words[j]) & M32, p,
            p * max_retries, width)
        out.append((label if done else argmax_fallback(w), bits, rejs,
                    int(not done)))
    return np.array(out, np.int32).T


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def edge_rows(n, p, rows=48, seed=0):
    """Random weights in [0, 256) with the edge rows first."""
    rng = np.random.default_rng(seed + 131 * n + p)
    w = rng.integers(0, 256, (rows, n)).astype(np.int64)
    w[0] = 0  # all zero: uniform
    w[1] = 0
    w[1, n - 1] = 255  # one-hot
    w[2] = rng.integers(-300, 50, n)  # some negative
    w[3] = rng.integers(-1000, -1, n)  # all below -1
    w[4] = 1 << p  # multiples of 2^p: the walk passes level p - 1
    w[5] = 0
    w[5, 0] = 1 << p
    w[6] = (1 << p) // 2 + rng.integers(0, 1000, n)  # sum above 2^p
    w[7] = 2**31 - 1  # the int32 sum wraps
    w[8] = -1
    return w.astype(np.int32)


def random_words(rows, n_words, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (rows, n_words), dtype=np.uint64).astype(
        np.uint32)


def reference_kernel(w, words, n, p, max_retries):
    wp = np.zeros((w.shape[0], 128), np.int32)
    wp[:, :n] = w
    lab, st = r_ks.ky_sample_kernel(jnp.asarray(wp), jnp.asarray(words),
                                    n_bins=n, precision=p,
                                    max_retries=max_retries, interpret=True)
    return np.stack([np.asarray(lab), np.asarray(st["bits_used"]),
                     np.asarray(st["rejections"]),
                     np.asarray(st["fallback"]).astype(np.int32)])


def _stack(labels, stats):
    return np.stack([labels.cpu().numpy(), stats["bits_used"].cpu().numpy(),
                     stats["rejections"].cpu().numpy(),
                     stats["fallback"].cpu().numpy().astype(np.int32)])


# ---------------------------------------------------------------------------
# the model's parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transpose32_gives_the_bit_planes(seed):
    a = [int(x) for x in np.random.default_rng(seed).integers(
        0, 2**32, 32, dtype=np.uint64)]
    t = transpose32(a)
    for b in range(32):
        assert t[b] == sum(((a[i] >> b) & 1) << i for i in range(32))


def test_nth_set_bit_and_the_row_index_multiply():
    rng = np.random.default_rng(4)
    for width in (4, 8, 32):
        for x in [int(v) for v in rng.integers(1, 2**width, 200,
                                                dtype=np.uint64)]:
            pos = [i for i in range(width) if x >> i & 1]
            assert [nth_set_bit(x, r, width)
                    for r in range(len(pos))] == pos
    # the staging copy's f / n_bins = (f * ceil(2^20 / n_bins)) >> 20 for
    # every element f of a warp's 32 rows
    for n in range(1, MAX_BINS + 1):
        magic = ((1 << 20) + n - 1) // n
        f = np.arange(32 * n, dtype=np.int64)
        np.testing.assert_array_equal((f * magic) >> 20, f // n)


@pytest.mark.parametrize("n_bins", [9, 32, 33, 127, 128])
def test_planes_hold_every_column_the_walk_reads(n_bins):
    """The stored planes equal the reference's column `(m >> (p-1-level))
    & 1` over the bins at every level, levels past p - 1 (the sign fill of
    a negative shift) included."""
    for p in PRECISIONS:
        w = edge_rows(n_bins, p)
        for row in w:
            m, _ = prepare(row, p)
            planes = planes_of(m, p)
            ext = np.array([_i32(x) for x in m], np.int64)
            for level in range(p + 3):
                sh = p - 1 - level
                col = (ext >> sh) & 1 if sh >= 0 else (ext < 0).astype(int)
                words = [sum(int(col[i]) << (i - 32 * j)
                             for i in range(32 * j, min(32 * j + 32, n_bins)))
                         for j in range(len(planes[0]))]
                assert planes[min(level, p)] == words


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("n_bins", WIDTHS)
def test_plane_walk_matches_reference(n_bins, precision):
    for max_retries in (8, 1):
        w = edge_rows(n_bins, precision)
        words = random_words(w.shape[0], -(-precision * max_retries // 32),
                             seed=n_bins + max_retries)
        want = reference_kernel(w, words, n_bins, precision, max_retries)
        got = model_draw(w, words, precision, max_retries)
        np.testing.assert_array_equal(got, want)
        # the port's twin, and the reference's plain walk, whose fallback
        # is the argmax over the raw weights without the -1 padding
        twin = t_ks.ky_sample_kernel(
            torch.from_numpy(w), torch.from_numpy(words.view(np.int32)),
            n_bins=n_bins, precision=precision, max_retries=max_retries)
        np.testing.assert_array_equal(_stack(*twin), want)
        lab, st = r_ky.ky_sample_ref(jnp.asarray(w), jnp.asarray(words),
                                     n_bins=n_bins, precision=precision,
                                     max_retries=max_retries)
        plain = np.stack([np.asarray(lab), np.asarray(st["bits_used"]),
                          np.asarray(st["rejections"]),
                          np.asarray(st["fallback"]).astype(np.int32)])
        np.testing.assert_array_equal(plain[1:], want[1:])
        same = ~((want[3] == 1) & (w.max(-1) < -1))
        np.testing.assert_array_equal(plain[0][same], want[0][same])
        if max_retries == 1 and n_bins == 1:
            # an all-below--1 row out of bits falls back to lane n_bins
            assert want[0][3] == 1 and want[3][3] == 1


@pytest.mark.parametrize("precision", [17, 24, 30])
def test_plane_walk_at_128_bins_matches_ky_sample_ref(precision):
    """128 bins fill the four plane words of `ky_planes_kernel<4>`; the
    model equals the reference's plain walk (whose fallback is the argmax
    the model takes at 128 bins) and the port's twin, bit for bit."""
    for max_retries in (8, 1):
        w = edge_rows(MAX_BINS, precision)
        words = random_words(w.shape[0], -(-precision * max_retries // 32),
                             seed=precision + max_retries)
        lab, st = r_ky.ky_sample_ref(jnp.asarray(w), jnp.asarray(words),
                                     n_bins=MAX_BINS, precision=precision,
                                     max_retries=max_retries)
        want = np.stack([np.asarray(lab), np.asarray(st["bits_used"]),
                         np.asarray(st["rejections"]),
                         np.asarray(st["fallback"]).astype(np.int32)])
        np.testing.assert_array_equal(
            model_draw(w, words, precision, max_retries), want)
        twin = t_ks.ky_sample_kernel(
            torch.from_numpy(w), torch.from_numpy(words.view(np.int32)),
            n_bins=MAX_BINS, precision=precision, max_retries=max_retries)
        np.testing.assert_array_equal(_stack(*twin), want)
        fb = want[3] == 1  # out of bits: the plain argmax, no -1 lane
        np.testing.assert_array_equal(want[0][fb], np.argmax(w[fb], -1))


# ---------------------------------------------------------------------------
# the keyed entry
# ---------------------------------------------------------------------------


def test_keyed_counters_are_the_rows_places_in_the_stream():
    """`FromKey` hashes row r's word j at counter r * n_words + j: the words
    of `random_words(key, (B,), n_words)`."""
    key = prng.key(77)
    for precision, max_retries in ((16, 8), (21, 8), (16, 1), (30, 3)):
        n_words = t_ks.n_words_for(precision, max_retries)
        full = t_ky.random_words(key, (37,), n_words, "cpu")
        for r in (0, 1, 36):
            np.testing.assert_array_equal(
                t_ops.device_bits(key, n_words, r * n_words, "cpu").numpy(),
                full[r].numpy())


@pytest.mark.parametrize("n_bins", [3, 9, 32, 65, 127])
def test_keyed_entry_matches_reference_ops(n_bins):
    """`ky_sample_keyed(w, key)` on CPU tensors against the reference's
    `ops.ky_sample(w, key, interpret=True)`: the same words from the same
    key, the same draw and stats."""
    w = edge_rows(n_bins, 16, rows=70, seed=9)
    jk = jax.random.key(n_bins)
    lab_r, st_r = r_ops.ky_sample(jnp.asarray(w), jk, interpret=True,
                                  return_stats=True)
    key = convert.key_from_reference(np.asarray(jax.random.key_data(jk)))
    launches = t_ks.ky_sample_kernel.launches
    got = _stack(*t_ks.ky_sample_keyed(torch.from_numpy(w), key,
                                       n_bins=n_bins))
    want = np.stack([np.asarray(lab_r), np.asarray(st_r["bits_used"]),
                     np.asarray(st_r["rejections"]),
                     np.asarray(st_r["fallback"]).astype(np.int32)])
    np.testing.assert_array_equal(got, want)
    assert t_ks.ky_sample_kernel.launches == launches  # the twin ran
    words = t_ky.random_words(key, (w.shape[0],), 4, "cpu")
    np.testing.assert_array_equal(
        model_draw(w, words.numpy().view(np.uint32), 16, 8), want)


def test_keyed_entry_refuses_what_the_kernel_does_not_take():
    w = torch.ones((4, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        t_ks.ky_sample_keyed(w, 7, n_bins=3)
    with pytest.raises(ValueError):
        t_ks.ky_sample_keyed(w, prng.key(0), n_bins=3, precision=31)
    with pytest.raises(ValueError):
        t_ks.ky_sample_keyed(w, prng.key(0), n_bins=4)
    with pytest.raises(ValueError):
        t_ks.ky_sample_keyed(w.float(), prng.key(0), n_bins=3)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_k1_entries_match_the_twin_on_the_card(monkeypatch):
    """Both entries of the kernel against the twin at every width (128
    included), both precisions and both budgets, on 4,099 rows (a ragged last warp and
    block) with the edge rows first; and `ops.ky_sample` draws with no
    word made in plain torch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    dev = torch.device("cuda")
    for n_bins in WIDTHS + [MAX_BINS]:
        for precision in PRECISIONS:
            for max_retries in (8, 1):
                w = torch.from_numpy(edge_rows(n_bins, precision,
                                               rows=4099)).to(dev)
                key = prng.key(n_bins * 100 + precision + max_retries)
                kw = dict(n_bins=n_bins, precision=precision,
                          max_retries=max_retries)
                words = t_ky.random_words(
                    key, (w.shape[0],), t_ks.n_words_for(precision,
                                                         max_retries), dev)
                want = _stack(*t_ks.ky_sample_kernel_ref(w, words, **kw))
                got = _stack(*t_ks.ky_sample_kernel(w, words, **kw))
                np.testing.assert_array_equal(got, want)
                got = _stack(*t_ks.ky_sample_keyed(w, key, **kw))
                np.testing.assert_array_equal(got, want)

    def words_made(*args, **kwargs):
        raise AssertionError("the draw's words were made in plain torch")

    w = torch.from_numpy(edge_rows(32, 16, rows=1000)).to(dev)
    want = t_ks.ky_sample_kernel_ref(
        w, t_ky.random_words(prng.key(3), (1000,), 4, dev), n_bins=32)[0]
    launches = t_ks.ky_sample_kernel.launches
    with monkeypatch.context() as m:
        m.setattr(prng, "_raw_bits", words_made)
        got = t_ops.ky_sample(w, prng.key(3))
    torch.cuda.synchronize()
    assert t_ks.ky_sample_kernel.launches == launches + 1
    assert torch.equal(got, want)
