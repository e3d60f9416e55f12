"""K1: one exact rejection-Knuth-Yao draw per row (paper C1), CUDA kernel.

Replaces the reference's Pallas kernel `ky_sample_kernel`
(src/repro/kernels/ky_sampler.py:159, body `_ky_kernel` :140, helpers
`preprocess_lanes` :58, `ddg_walk` :74, `argmax_fallback` :128).  The CUDA
source is `csrc/ky_sampler.cu`.

Bound on the H100: bytes (weights in, four ints out per row, and the words
when they are read).  The TPU's lane cumsum, a triangular MXU matmul over
128 lanes, becomes a bit plane per DDG level over the row's bins: a
popcount, and the (d+1)-th set bit on the level that accepts, with the
rejection bin held apart.  Rows of up to 8 bins form each level's plane
from registers; wider rows are copied into shared memory with coalesced
loads and transposed into planes once (see the source's header).

Two entries launch the one kernel body, both counted in
`ky_sample_kernel.launches`:

  * `ky_sample_kernel(weights, words)` reads (B, n_words) words, the
    reference kernel's signature;
  * `ky_sample_keyed(weights, key)` hashes row r's word j, counter
    r * n_words + j of `key`'s stream (`random_words(key, (B,), n_words)`),
    when its walk reaches it: the draw request's path (`ops.ky_sample`).

The TPU kernel takes weights padded to 128 lanes, one of them free for the
rejection bin, so at most 127 bins; here `weights` is (B, n_bins), the
lane padding being a TPU layout, and the rejection bin is held apart, so
a row may have 128 bins (the token sampler's tree levels).  The twin is
the plain early-exit walk of `core/ky.py` on n_bins + 1 lanes (the padded
lanes are zero and change no sum) with the kernel's argmax fallback,
which at 128 bins, with no padding lane, is `core.ky.ky_sample_ref`'s
plain argmax.
"""

from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core import ky as ky_core
from repro_torch.kernels import _lib

# K3-K6 walk n_bins + 1 register lanes (bins and the rejection bin), so
# they take at most LANES - 1 bins; K1 holds its rejection bin apart and
# takes up to LANES
LANES = 128
MAX_PRECISION = 30  # 2^precision and the row sums stay in int32


def n_words_for(precision: int, max_retries: int) -> int:
    """Words a row's walk may read: one bit per step, precision x
    max_retries steps."""
    return -(-precision * max_retries // 32)


def argmax_fallback(
    w: torch.Tensor, labels: torch.Tensor, done: torch.Tensor, n_bins: int
) -> torch.Tensor:
    """Bit-exhaustion fallback: the first lane of the largest raw weight.
    The reference kernel's lanes n_bins..127 hold -1, so rows whose weights
    are all below -1 fall back to lane n_bins; a row of 128 bins has no
    such lane and takes the plain argmax, as `ky_sample_ref` does."""
    w = w[:, :n_bins]
    amax = torch.argmax(w, dim=-1).to(torch.int32)
    if n_bins < LANES:
        below = w.amax(-1) < -1
        amax = torch.where(below, torch.full_like(amax, n_bins), amax)
    return torch.where(done, labels, amax)


def _check_weights(weights, n_bins, precision, max_retries) -> int:
    if weights.dim() != 2 or weights.shape[1] != n_bins:
        raise ValueError(f"weights must be (B, n_bins={n_bins})")
    if not 1 <= n_bins <= LANES:
        raise ValueError(f"n_bins {n_bins} is not in 1..{LANES}")
    if weights.dtype != torch.int32:
        raise ValueError("weights are an int32 tensor")
    if not 1 <= precision <= MAX_PRECISION:
        raise ValueError(f"precision {precision} is not in 1..{MAX_PRECISION}")
    if max_retries < 1:
        raise ValueError(f"max_retries {max_retries} < 1")
    return precision * max_retries


def _check(weights, words, n_bins, precision, max_retries):
    total_steps = _check_weights(weights, n_bins, precision, max_retries)
    if words.dtype != torch.int32:
        raise ValueError("words are an int32 tensor")
    if words.dim() != 2 or words.shape[0] != weights.shape[0]:
        raise ValueError("words must be (B, n_words)")
    if words.shape[1] * 32 < total_steps:
        raise ValueError(
            f"not enough random bits: {words.shape[1]} words < "
            f"{total_steps} steps"
        )
    return total_steps


def ky_sample_kernel_ref(
    weights: torch.Tensor, words: torch.Tensor, *, n_bins: int,
    precision: int = 16, max_retries: int = 8,
):
    """Plain torch twin of K1: (labels (B,), stats dict)."""
    _check(weights, words, n_bins, precision, max_retries)
    labels, stats = ky_core.ky_sample_fast(
        weights, words, n_bins=n_bins, precision=precision,
        max_retries=max_retries,
    )
    done = ~stats["fallback"]
    return argmax_fallback(weights, labels, done, n_bins), stats


def _launch(entry: str, weights, source, source_types, n_words, n_bins,
            precision, total_steps):
    """Launch `entry` (the words' source first, then the shapes) and count
    it; an empty batch launches nothing."""
    b = weights.shape[0]
    outs = torch.empty((4, b), dtype=torch.int32, device=weights.device)
    if b:
        fn = _lib.function(
            "ky_sampler", entry,
            [_lib.PTR, *source_types, _lib.INT, _lib.INT, _lib.INT,
             _lib.INT, _lib.INT, _lib.PTR, _lib.PTR, _lib.PTR, _lib.PTR,
             _lib.PTR],
        )
        with torch.cuda.device(weights.device):
            code = fn(weights.data_ptr(), *source, b, n_bins, n_words,
                      precision, total_steps, outs[0].data_ptr(),
                      outs[1].data_ptr(), outs[2].data_ptr(),
                      outs[3].data_ptr(), _lib.stream_of(weights))
        _lib.check("ky_sampler", code, entry)
        ky_sample_kernel.launches += 1
    return outs[0], {
        "bits_used": outs[1], "rejections": outs[2],
        "fallback": outs[3] != 0,
    }


def ky_sample_kernel(
    weights: torch.Tensor, words: torch.Tensor, *, n_bins: int,
    precision: int = 16, max_retries: int = 8,
):
    """One draw per row of (B, n_bins) int32 weights from (B, n_words)
    packed words: the CUDA kernel for CUDA tensors (counted in
    `ky_sample_kernel.launches`), the twin for CPU tensors."""
    total_steps = _check(weights, words, n_bins, precision, max_retries)
    if weights.device.type == "cpu":
        return ky_sample_kernel_ref(weights, words, n_bins=n_bins,
                                    precision=precision,
                                    max_retries=max_retries)
    _lib.require_cuda("ky_sample_kernel", weights, words)
    return _launch("aia_ky_sample", weights, [words.data_ptr()], [_lib.PTR],
                   words.shape[1], n_bins, precision, total_steps)


ky_sample_kernel.launches = 0


def ky_sample_keyed(
    weights: torch.Tensor, key: prng.Key, *, n_bins: int,
    precision: int = 16, max_retries: int = 8,
):
    """`ky_sample_kernel(weights, random_words(key, (B,), n_words))`, with
    the words hashed inside the kernel, only those each row's walk reaches:
    the CUDA kernel for CUDA tensors (counted in
    `ky_sample_kernel.launches`), the twin on the key's words for CPU
    tensors."""
    if not isinstance(key, prng.Key):
        raise TypeError(f"key must be a prng.Key, got {type(key).__name__}")
    total_steps = _check_weights(weights, n_bins, precision, max_retries)
    n_words = n_words_for(precision, max_retries)
    if weights.device.type == "cpu":
        words = ky_core.random_words(key, (weights.shape[0],), n_words,
                                     weights.device)
        return ky_sample_kernel_ref(weights, words, n_bins=n_bins,
                                    precision=precision,
                                    max_retries=max_retries)
    _lib.require_cuda("ky_sample_keyed", weights)
    return _launch("aia_ky_sample_keyed", weights, [key.k1, key.k2],
                   [_lib.UINT, _lib.UINT], n_words, n_bins, precision,
                   total_steps)
