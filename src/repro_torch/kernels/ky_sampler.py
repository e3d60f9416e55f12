"""K1: one exact rejection-Knuth-Yao draw per row (paper C1), CUDA kernel.

Replaces the reference's Pallas kernel `ky_sample_kernel`
(src/repro/kernels/ky_sampler.py:159, body `_ky_kernel` :140, helpers
`preprocess_lanes` :58, `ddg_walk` :74, `argmax_fallback` :128).  The CUDA
source is `csrc/ky_sampler.cu`; the device functions it shares with K3 are
in `csrc/aia_common.cuh`.

Bound on the H100: bytes (weights and words in, four ints out per row).
The TPU's lane cumsum, a triangular MXU matmul over 128 lanes, becomes a
running sum over the row's n_bins + 1 lanes in one thread's registers, and
the lock-step early-exit loop becomes each thread's own exit.

The TPU kernel takes weights padded to 128 lanes; here `weights` is
(B, n_bins), the lane padding being a TPU layout.  The twin is the plain
early-exit walk of `core/ky.py` on n_bins + 1 lanes (the padded lanes are
zero and change no sum) with the kernel's argmax fallback.
"""

from __future__ import annotations

import torch

from repro_torch.core import ky as ky_core
from repro_torch.kernels import _lib

LANES = 128  # the widest alphabet the KY kernels take is LANES - 1 bins


def argmax_fallback(
    w: torch.Tensor, labels: torch.Tensor, done: torch.Tensor, n_bins: int
) -> torch.Tensor:
    """Bit-exhaustion fallback: the first lane of the largest raw weight.
    The reference's lanes n_bins..127 hold -1, so rows whose weights are
    all below -1 fall back to lane n_bins."""
    w = w[:, :n_bins]
    amax = torch.argmax(w, dim=-1).to(torch.int32)
    below = w.amax(-1) < -1
    amax = torch.where(below, torch.full_like(amax, n_bins), amax)
    return torch.where(done, labels, amax)


def _check(weights, words, n_bins, precision, max_retries):
    if weights.dim() != 2 or weights.shape[1] != n_bins:
        raise ValueError(f"weights must be (B, n_bins={n_bins})")
    if not 1 <= n_bins < LANES:
        raise ValueError(f"n_bins {n_bins} needs a free rejection lane")
    if weights.dtype != torch.int32 or words.dtype != torch.int32:
        raise ValueError("weights and words are int32 tensors")
    total_steps = precision * max_retries
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
    b = weights.shape[0]
    outs = torch.empty((4, b), dtype=torch.int32, device=weights.device)
    fn = _lib.function(
        "ky_sampler", "aia_ky_sample",
        [_lib.PTR, _lib.PTR, _lib.INT, _lib.INT, _lib.INT, _lib.INT, _lib.INT,
         _lib.PTR, _lib.PTR, _lib.PTR, _lib.PTR, _lib.PTR],
    )
    with torch.cuda.device(weights.device):
        code = fn(weights.data_ptr(), words.data_ptr(), b, n_bins,
                  words.shape[1], precision, total_steps, outs[0].data_ptr(),
                  outs[1].data_ptr(), outs[2].data_ptr(), outs[3].data_ptr(),
                  _lib.stream_of(weights))
    _lib.check("ky_sampler", code, "ky_sample_kernel")
    ky_sample_kernel.launches += 1
    return outs[0], {
        "bits_used": outs[1], "rejections": outs[2],
        "fallback": outs[3] != 0,
    }


ky_sample_kernel.launches = 0
