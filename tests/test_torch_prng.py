"""The port's threefry2x32 (`repro_torch.prng`) against `jax.random`, bit
for bit: key derivation from seeds, split, uint32 bits and int32 randint
on a grid of seeds and shapes (partitionable mode, jax's default)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch import convert, prng

SEEDS = [0, 1, 42, 123456789, 2**32 - 1, -7]


def _data(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_match_jax(seed):
    k, jk = prng.key(seed), jax.random.key(seed)
    assert [k.k1, k.k2] == _data(jk).tolist()
    for num in (2, 3, 7):
        got = [[s.k1, s.k2] for s in prng.split(k, num)]
        assert got == _data(jax.random.split(jk, num)).tolist()
    # split chains: the per-sweep / per-round pattern of the Gibbs loops
    for _ in range(3):
        k, sub = prng.split(k)
        jk, jsub = jax.random.split(jk)
        assert [sub.k1, sub.k2] == _data(jsub).tolist()
    assert convert.key_from_reference(_data(jk)) == k


@pytest.mark.parametrize("shape", [(1,), (5,), (3, 4), (2, 3, 5), (257, 4)])
@pytest.mark.parametrize("seed", [0, 9, 2**31 + 5])
def test_bits_match_jax(seed, shape):
    got = prng.bits(prng.key(seed), shape, "cpu").numpy()
    want = np.asarray(jax.random.bits(jax.random.key(seed), shape, jnp.uint32))
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want)


@pytest.mark.parametrize("seed", [0, 3, 77])
def test_randint_matches_jax_per_node_maxval(seed):
    """The chain-init draw: per-node maxval broadcast over chains."""
    cards = np.array([2, 3, 11, 1, 5, 7, 4, 127], np.int32)
    k, jk = prng.key(seed), jax.random.key(seed)
    got = prng.randint(k, (9, cards.size), 0, np.maximum(cards, 1)[None],
                       "cpu").numpy()
    want = jax.random.randint(jk, (9, cards.size), 0,
                              jnp.maximum(jnp.asarray(cards)[None], 1),
                              jnp.int32)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("lo,hi", [(0, 1), (-1000, 2**31 - 1), (5, 5),
                                   (-3, 17)])
def test_randint_matches_jax_scalar_bounds(lo, hi):
    got = prng.randint(prng.key(4), (64,), lo, hi, "cpu").numpy()
    want = jax.random.randint(jax.random.key(4), (64,), lo, hi, jnp.int32)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_only_the_partitionable_mode_is_ported():
    with pytest.raises(NotImplementedError):
        prng.key(0, partitionable=False)
    with pytest.raises(ValueError):
        prng.Key(0, 2**32)


def _zoo_max_rounds():
    from repro_torch.core import bayesnet, graphs

    return max(
        len(bayesnet.compile_bayesnet(graphs.bn_repository_replica(n),
                                      device="cpu").groups)
        for n in graphs.bn_repository_names())


@pytest.mark.parametrize("seed", [0, 5, 2**32 - 3])
def test_round_keys_are_the_hash_of_counter_pair_zero_r(seed):
    """K3 derives round r's key inside the kernel as the threefry hash of
    the counter pair (0, r) under the sweep key: that is `split(key, R)[r]`
    for every R > r, here up to past the zoo's largest round count, and
    jax's own split."""
    from repro_torch.kernels import bn_gibbs

    k = prng.key(seed)
    r_max = _zoo_max_rounds() + 8
    for num in range(1, r_max + 1):
        keys = prng.split(k, num)
        for r in range(num):
            assert bn_gibbs.round_key(k, r) == keys[r]
    want = _data(jax.random.split(jax.random.key(seed), r_max)).tolist()
    assert [[bn_gibbs.round_key(k, r).k1, bn_gibbs.round_key(k, r).k2]
            for r in range(r_max)] == want


@pytest.mark.parametrize("start,n", [(0, 300), (7, 50), (1000, 4)])
def test_device_bits_plain_version_is_the_bits_stream(start, n):
    """`ops.device_bits` (the kernels' generator's test entry) on the CPU:
    word start + i of `prng.bits`, and so of `jax.random.bits`."""
    from repro_torch.kernels import ops

    k = prng.key(21)
    got = ops.device_bits(k, n, start, "cpu").numpy()
    want = np.asarray(jax.random.bits(jax.random.key(21), (start + n,),
                                      jnp.uint32))[start:]
    np.testing.assert_array_equal(got.view(np.uint32), want)


@pytest.mark.cuda
def test_device_bits_match_prng_bits_on_the_card():
    """`aia::jax_word`, the device function K3 and K4 hash their words
    with, against `prng.bits` on the card, also across the 2^32 counter
    boundary (high counter word non-zero)."""
    import torch

    from repro_torch.kernels import ops

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    for seed in (0, 77, 2**32 - 1):
        k = prng.key(seed)
        got = ops.device_bits(k, 1 << 20, 0, "cuda")
        assert torch.equal(got, prng.bits(k, (1 << 20,), "cuda"))
        start = (1 << 32) - 1000
        got = ops.device_bits(k, 2000, start, "cuda")
        assert torch.equal(got.cpu(), ops.device_bits(k, 2000, start, "cpu"))


@pytest.mark.parametrize("start,n", [(0, 40), (13, 25), (2**32 - 5, 10)])
def test_bits_from_a_start_counter(start, n):
    """`prng.bits(..., start=s)` is words s .. s + n - 1 of the key's
    stream: b1 ^ b2 of the hash of the counter pair (i >> 32, i & MASK),
    also across the 2^32 boundary, and the stream's slice where jax can
    make it."""
    k = prng.key(9)
    got = prng.bits(k, (n,), "cpu", start=start).numpy().view(np.uint32)
    idx = np.arange(start, start + n, dtype=np.int64)
    b1, b2 = prng.threefry2x32(k.k1, k.k2, idx >> 32, idx & prng.MASK)
    np.testing.assert_array_equal(got, (b1 ^ b2).astype(np.uint32))
    if start < 2**20:
        want = np.asarray(jax.random.bits(jax.random.key(9), (start + n,),
                                          jnp.uint32))[start:]
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        prng.bits(k, (n,), "cpu", start=-1)
