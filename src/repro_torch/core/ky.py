"""Rejection-based Knuth-Yao (KY) discrete sampling — algorithmic core.

Port of `repro/core/ky.py` (paper C1, Sec. III-C) as plain torch functions
on integer weight vectors:

  * a distribution is non-negative integer weights ``m_i`` with
    ``P_i = m_i / sum(m)`` — no normalization is ever performed;
  * preprocessing appends a *rejection bin* ``rej = 2^W - S`` so the
    extended weights sum to an exact power of two (Eqns. 8-9);
  * the DDG walk consumes one random bit per tree level and terminates in
    O(H) expected bits; hitting the rejection bin restarts the walk.

Everything is integer arithmetic, so the port is bit-exact with the
reference given the same packed words.  Words are int32 tensors holding
uint32 bit patterns (`prng.bits`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import prng

# Default tree precision W: extended weights sum to exactly 2^W.
DEFAULT_PRECISION = 16


class KYState(NamedTuple):
    """Per-sample DDG-walk state (all (B,) int32 unless noted)."""

    d: torch.Tensor  # distance within current tree level
    level: torch.Tensor  # current tree level, 0-indexed from the MSB
    label: torch.Tensor  # sampled bin, -1 while walking
    done: torch.Tensor  # bool
    bits_used: torch.Tensor  # random bits consumed so far
    rejections: torch.Tensor  # number of rejection-restarts


def scale_to_fill(
    m: torch.Tensor, precision: int = DEFAULT_PRECISION
) -> torch.Tensor:
    """Multiply integer weights by floor(2^W / S) (shrinks the rejection
    bin without changing the distribution)."""
    s = torch.clamp(m.sum(-1, keepdim=True, dtype=torch.int32), min=1)
    k = torch.clamp(
        torch.div(torch.full_like(s, 1 << precision), s,
                  rounding_mode="floor"),
        min=1,
    )
    return m * k


def extend_with_rejection(
    m: torch.Tensor, precision: int = DEFAULT_PRECISION
) -> torch.Tensor:
    """Append the rejection bin: m' = [m_0..m_{N-1}, 2^W - S]  (Eqn. 9)."""
    s = m.sum(-1, keepdim=True, dtype=torch.int32)
    return torch.cat([m, (1 << precision) - s], dim=-1)


def ddg_matrix(m_ext: torch.Tensor,
               precision: int = DEFAULT_PRECISION) -> torch.Tensor:
    """Binary DDG matrix M[..., i, j] = bit (precision - 1 - j) of m'_i
    (Eqn. 10 analogue): column j lists the bins that end at tree level j.
    Only tests and documentation read it; the walk takes its columns on
    the fly with shifts (`ddg_column`)."""
    shifts = precision - 1 - torch.arange(precision, dtype=m_ext.dtype,
                                          device=m_ext.device)
    return (m_ext[..., :, None] >> shifts) & 1


def ddg_column(
    m_ext: torch.Tensor, level: torch.Tensor, precision: int
) -> torch.Tensor:
    """Column `level` of the DDG matrix, per-sample level. m_ext (B, N+1)."""
    shift = precision - 1 - level
    return (m_ext >> shift[..., None]) & 1


def walk_step(
    m_ext: torch.Tensor, bit: torch.Tensor, state: KYState, n_bins: int,
    precision: int,
) -> KYState:
    """One DDG level for a batch of samples (the paper's per-cycle datapath):
    d <- 2d + bit, subtract terminal-leaf counts (cumsum), the first
    crossing is the label; the rejection bin restarts."""
    active = ~state.done
    d = torch.where(active, 2 * state.d + bit, state.d)
    col = ddg_column(m_ext, state.level, precision)
    c = torch.cumsum(col, dim=-1, dtype=torch.int32)
    total = c[..., -1]
    hit = c > d[..., None]
    terminated = active & (total > d)
    idx = torch.argmax(hit.to(torch.int32), dim=-1).to(torch.int32)
    is_rej = idx >= n_bins
    accept = terminated & ~is_rej
    reject = terminated & is_rej
    cont = active & ~terminated
    zero = torch.zeros_like(d)
    return KYState(
        d=torch.where(reject, zero, torch.where(cont, d - total, d)),
        level=torch.where(
            reject, zero, torch.where(cont, state.level + 1, state.level)
        ),
        label=torch.where(accept, idx, state.label),
        done=state.done | accept,
        bits_used=state.bits_used + active.to(torch.int32),
        rejections=state.rejections + reject.to(torch.int32),
    )


def bit_at(words: torch.Tensor, t: int) -> torch.Tensor:
    """Bit t of packed uint32 words (B, n_words) held as int32 patterns."""
    return (words[..., t // 32] >> (t % 32)) & 1


def init_state(batch_shape, device) -> KYState:
    z = torch.zeros(batch_shape, dtype=torch.int32, device=device)
    return KYState(
        d=z, level=z, label=z - 1,
        done=torch.zeros(batch_shape, dtype=torch.bool, device=device),
        bits_used=z, rejections=z,
    )


def random_words(
    key: prng.Key, batch_shape, n_words: int, device="cuda"
) -> torch.Tensor:
    """Packed uniform random bits: `jax.random.bits(key, shape, uint32)`."""
    return prng.bits(key, tuple(batch_shape) + (n_words,), device)


def prepare(
    m: torch.Tensor, precision: int = DEFAULT_PRECISION
) -> torch.Tensor:
    """Full preprocessing: clamp -> scale-to-fill -> rejection-extend."""
    m = torch.clamp(m.to(torch.int32), min=0)
    s = m.sum(-1, keepdim=True, dtype=torch.int32)
    m = torch.where(s > 0, m, torch.ones_like(m))
    m = scale_to_fill(m, precision)
    return extend_with_rejection(m, precision)


def quantize_probs(p: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Float probabilities/potentials -> integer weights; max(p) maps to
    2^bits - 1.  The division is a tensor division (not `top / t`, which
    torch computes as a reciprocal times `top`)."""
    top = (1 << bits) - 1
    pmax = torch.clamp(p.amax(-1, keepdim=True), min=1e-30)
    scale = torch.full_like(pmax, float(top)) / pmax
    return torch.clamp(torch.round(p * scale), 0, top).to(torch.int32)


def _check_words(words: torch.Tensor, total_steps: int) -> None:
    if words.shape[-1] * 32 < total_steps:
        # raised, not asserted: the walk must never read past the stream
        raise ValueError(
            f"not enough random bits: {words.shape[-1]} words < "
            f"{total_steps} steps"
        )


def _finish(weights, st: KYState):
    fallback = torch.argmax(weights, dim=-1).to(torch.int32)
    labels = torch.where(st.done, st.label, fallback)
    return labels, {
        "bits_used": st.bits_used,
        "rejections": st.rejections,
        "fallback": ~st.done,
    }


def ky_sample_ref(
    weights: torch.Tensor,
    words: torch.Tensor,
    *,
    n_bins: int,
    precision: int = DEFAULT_PRECISION,
    max_retries: int = 8,
):
    """Reference batched rejection-KY walk (fully masked, fixed trip count).

    weights: (B, N) int32 raw weights (N == n_bins); words: (B, n_words)
    with n_words*32 >= precision*max_retries.  Returns (labels (B,) int32,
    stats dict), deterministic given `words`."""
    m_ext = prepare(weights, precision)
    total_steps = precision * max_retries
    _check_words(words, total_steps)
    st = init_state(weights.shape[:-1], weights.device)
    for t in range(total_steps):
        st = walk_step(m_ext, bit_at(words, t), st, n_bins, precision)
    return _finish(weights, st)


def ky_sample_fast(
    weights: torch.Tensor,
    words: torch.Tensor,
    *,
    n_bins: int,
    precision: int = DEFAULT_PRECISION,
    max_retries: int = 8,
):
    """Early-exit variant of `ky_sample_ref`: identical outputs, but the
    loop stops once every sample has terminated (expected O(H) steps)."""
    m_ext = prepare(weights, precision)
    total_steps = precision * max_retries
    _check_words(words, total_steps)
    st = init_state(weights.shape[:-1], weights.device)
    for t in range(total_steps):
        if bool(st.done.all()):
            break
        st = walk_step(m_ext, bit_at(words, t), st, n_bins, precision)
    return _finish(weights, st)
