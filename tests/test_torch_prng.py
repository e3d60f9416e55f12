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
