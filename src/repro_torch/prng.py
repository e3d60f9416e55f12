"""JAX's default PRNG (threefry2x32, partitionable mode) in torch.

Every random number of the reference comes from `jax.random`: the packed KY
words are `jax.random.bits(key, shape, uint32)` (`core/ky.py`
`random_words`), keys are split once per sweep and once per round, and
chains start from `jax.random.randint`.  Reproducing those streams exactly
is what lets the port be held against the reference bit for bit rather
than only in distribution.

A `Key` is two uint32 words kept as Python ints on the host: splitting a
key is a handful of integer operations, and keeping it off the device
means a sweep never waits on the card to learn its next key.  `bits`,
`uniform`, `gumbel` and `randint` run on the device they are given.
uint32 arithmetic is done in int64 masked to 32 bits (torch's uint32
support is partial), and words are returned as int32 tensors holding the
uint32 bit patterns, for which `(w >> s) & 1` is still exact.

Only the partitionable mode is implemented (`jax_threefry_partitionable`,
the default of jax 0.9): split counts with a two-word iota and bits are
`b1 ^ b2` of one threefry call.  Seeds follow jax with x64 disabled:
`key(s)` is `(0, s mod 2**32)`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import device as device_mod

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


@dataclasses.dataclass(frozen=True)
class Key:
    """A threefry2x32 key: the two uint32 words `jax.random.key_data`
    returns, as Python ints."""

    k1: int
    k2: int

    def __post_init__(self):
        for w in (self.k1, self.k2):
            if not 0 <= w <= MASK:
                raise ValueError(f"key word {w} is not a uint32")


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds), elementwise over `x1`, `x2`.

    Works on int64 torch tensors and int64 numpy arrays alike, with every
    value in [0, 2**32); the keys are ints or arrays of the same kind.
    Follows `jax._src.prng._threefry2x32_lowering` step for step."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x1 + ks[0]) & MASK
    y0 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + y0) & MASK
            y0 = _rotl(y0, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        y0 = (y0 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, y0


def key(seed: int, *, partitionable: bool = True) -> Key:
    """`jax.random.key(seed)` (threefry2x32, x64 disabled)."""
    if not partitionable:
        raise NotImplementedError(
            "only jax's partitionable threefry mode is ported "
            "(jax_threefry_partitionable=True, the jax 0.9 default)"
        )
    return Key(0, int(seed) & MASK)


def split(k: Key, num: int = 2) -> tuple[Key, ...]:
    """`jax.random.split(k, num)`: `num` new keys, computed on the host."""
    counts = np.arange(num, dtype=np.int64)
    b1, b2 = threefry2x32(k.k1, k.k2, counts >> 32, counts & MASK)
    return tuple(Key(int(a), int(b)) for a, b in zip(b1, b2))


def key_array(keys) -> np.ndarray:
    """Keys -> a (Q, 2) int64 array of their words, the form `split_many`
    splits."""
    return np.array([(k.k1, k.k2) for k in keys], np.int64).reshape(-1, 2)


def keys_of(words) -> list[Key]:
    """(Q, 2) key words -> Q `Key`s: a numpy array of uint32 values, or a
    `key_tensor` (int32 bit patterns, on any device)."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    arr = np.asarray(words).astype(np.int64) & MASK
    return [Key(int(a), int(b)) for a, b in arr.reshape(-1, 2)]


def key_tensor(words, device="cuda") -> torch.Tensor:
    """Key words ((..., 2) numpy array of uint32 values, or a list of
    `Key`s) -> an int32 tensor of their bit patterns on `device`: the key
    arrays the kernels' lane entries read, one row per query.  The copy
    to a card does not wait for the work queued there: the words come from
    pageable memory, which the copy stages before it returns, and the
    kernels that read them run after it on the same stream."""
    if not isinstance(words, np.ndarray):
        words = key_array(words)
    bits = np.ascontiguousarray(words.astype(np.uint32).view(np.int32))
    return torch.from_numpy(bits).to(device_mod.resolve(device),
                                     non_blocking=True)


def split_many(keys: np.ndarray, num: int = 2) -> np.ndarray:
    """`split` over Q keys in one numpy call: (Q, 2) key words -> (Q, num,
    2), row q being `split(Key(*keys[q]), num)`.  A batch of Q chains
    splits its sweep keys with one call instead of Q."""
    keys = np.asarray(keys, np.int64).reshape(-1, 2)
    counts = np.arange(num, dtype=np.int64)[None]
    b1, b2 = threefry2x32(keys[:, :1], keys[:, 1:], counts >> 32,
                          counts & MASK)
    return np.stack([b1, b2], axis=-1)


def fold_in(k: Key, data: int) -> Key:
    """`jax.random.fold_in(k, data)` for a uint32 `data`: the threefry hash
    of the counter pair `(0, data)` (jax's `threefry_seed` of a 32-bit
    value) under `k`.  The legacy sharded engines fold the mesh position
    into the key with it."""
    data = int(data)
    if not 0 <= data <= MASK:
        raise ValueError(f"fold_in data {data} is not a uint32")
    a, b = threefry2x32(k.k1, k.k2, 0, data)
    return Key(int(a), int(b))


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor of the same bit patterns."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def _raw_bits(k: Key, shape: tuple[int, ...], device,
              start: int = 0) -> torch.Tensor:
    """uint32 words of `jax.random.bits(k, shape, uint32)` as int64, or with
    `start` the words start .. of the same stream (counter i + start for
    element i).  Every tensor of random numbers is made here;
    `_raw_bits.calls` counts the calls, so a run can show that its kernels
    made their words themselves (K3 and K4 hash theirs inside the
    kernel)."""
    _raw_bits.calls += 1
    n = math.prod(shape)
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k.k1, k.k2, idx >> 32, idx & MASK)
    return (b1 ^ b2).reshape(shape)


_raw_bits.calls = 0


def bits(k: Key, shape, device="cuda", start: int = 0) -> torch.Tensor:
    """`jax.random.bits(k, shape, jnp.uint32)` as an int32 tensor of the
    same bit patterns, computed on `device`; with `start`, the words from
    counter `start` on of the same stream."""
    if start < 0:
        raise ValueError(f"counter {start} is not a uint64")
    return to_int32(_raw_bits(k, tuple(shape), device_mod.resolve(device),
                              start))


def uniform(
    k: Key, shape, minval: float = 0.0, maxval: float = 1.0, device="cuda"
) -> torch.Tensor:
    """`jax.random.uniform(k, shape, jnp.float32, minval, maxval)`, bit for
    bit: the top 23 bits of each word become the mantissa of a float in
    [1, 2), minus one, scaled to [minval, maxval) and floored at minval."""
    shape = tuple(shape)
    raw = _raw_bits(k, shape, device_mod.resolve(device))
    floats = to_int32((raw >> 9) | 0x3F800000).view(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=floats.device)
    lo = torch.full((), minval, dtype=torch.float32, device=floats.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, (floats - one) * (hi - lo) + lo)


def gumbel(k: Key, shape, device="cuda") -> torch.Tensor:
    """`jax.random.gumbel(k, shape, jnp.float32)` (its default low-range
    mode): -log(-log(u)) with u uniform in [tiny, 1).  The uniform draw is
    bit-exact; the logs are torch's, which may differ from XLA's in the last
    bit, so the noise is held to the reference in distribution."""
    u = uniform(k, shape, float(torch.finfo(torch.float32).tiny), 1.0, device)
    return -torch.log(-torch.log(u))


def randint(
    k: Key, shape, minval, maxval, device="cuda"
) -> torch.Tensor:
    """`jax.random.randint(k, shape, minval, maxval, jnp.int32)`.

    `minval`/`maxval` are ints or int tensors broadcastable to `shape`
    (the reference passes a per-node maxval).  Same two-word remainder
    construction as `jax._src.random._randint`, in uint32 arithmetic."""
    shape = tuple(shape)
    device = device_mod.resolve(device)
    lo_i = torch.as_tensor(minval, dtype=torch.int64, device=device)
    hi_i = torch.as_tensor(maxval, dtype=torch.int64, device=device)
    i32 = torch.iinfo(torch.int32)
    lo_i = lo_i.clamp(i32.min, i32.max)
    hi_i = hi_i.clamp(i32.min, i32.max)
    k1, k2 = split(k)
    higher = _raw_bits(k1, shape, device)
    lower = _raw_bits(k2, shape, device)
    span = (hi_i - lo_i) & MASK
    span = torch.where(hi_i <= lo_i, torch.ones_like(span), span)
    mult = (1 << 16) % span
    mult = ((mult * mult) & MASK) % span
    off = (((higher % span) * mult) & MASK)
    off = ((off + lower % span) & MASK) % span
    return to_int32((lo_i + off) & MASK)
