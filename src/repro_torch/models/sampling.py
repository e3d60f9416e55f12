"""Token sampling — the paper's technique as a first-class serving feature.

Port of `repro/models/sampling.py`.  `ky` mode is the AIA pipeline C2->C1
applied to LM logits:

    logits -> max-subtract -> LUT-exp (16-entry, 8-bit integer weights)
           -> hierarchical rejection-KY draw (128-ary tree over the vocab)

No softmax and no normalization: the draw is exact for the quantized
weights, and the integer group sums are exact, so the hierarchical
decomposition P(group) P(token | group) introduces no bias.

On the card the stages run through the port's kernels: the LUT-exp stage
is one K2 launch over (B, V) (`ops.lut_exp_weights`), and every level of
the tree is one launch of K1's keyed entry over (B, 128) bins, which
hashes the level's words from its key (`ky_sampler.ky_sample_keyed`).
The reference draws each level with its jnp oracle `ky_sample_ref`, since
its Pallas K1 takes at most 127 bins; K1 here takes 128, and its twin is
that oracle's walk.  The group-sum pyramid is a few plain torch ops, as
in the reference.  On CPU tensors the wrappers run the twins.

`gumbel` (one argmax over logits + noise) is the baseline; `greedy` is
deterministic.
"""

from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core.interp import LUTSpec, build_exp_weight_lut
from repro_torch.kernels import ky_sampler, ops

BRANCH = 128  # tree arity: the reference's TPU lane width, K1's widest row
INT32_MIN = -(2**31)


def level_precision(level: int) -> int:
    """KY precision of the draw at tree level `level` (0 = the leaves):
    enough bits for the level's sums of 8-bit weights, at most 30."""
    return min(30, 8 + 7 * (level + 1) + 2)


def ky_token_sample(
    logits: torch.Tensor,
    key: prng.Key,
    *,
    exp_table: torch.Tensor | None = None,
    exp_spec: LUTSpec | None = None,
    max_retries: int = 8,
) -> torch.Tensor:
    """logits (B, V) -> sampled token ids (B,) int32, on logits' device.

    `exp_table`/`exp_spec` default to `build_exp_weight_lut()` on that
    device; a caller drawing many tokens builds the table once and passes
    it (the copy of a new table to the card waits for its stream)."""
    if exp_table is None:
        exp_table, exp_spec = build_exp_weight_lut(device=logits.device)
    v = logits.shape[1]
    levels = weight_pyramid(
        ops.lut_exp_weights(logits.float(), exp_table, exp_spec))

    # draw root -> leaf; each level is one 128-bin rejection-KY walk
    n_levels = len(levels)
    keys = prng.split(key, n_levels)
    idx = _ky_draw(levels[-1], keys[-1], level_precision(n_levels - 1),
                   max_retries)
    for li in range(n_levels - 2, -1, -1):
        sub = _ky_draw(take_row(levels[li], idx), keys[li],
                       level_precision(li), max_retries)
        idx = idx * BRANCH + sub
    return torch.clamp(idx, max=v - 1)


def weight_pyramid(w: torch.Tensor) -> list[torch.Tensor]:
    """(B, V) int32 weights -> the integer-sum pyramid, leaf to root: level
    0 is w padded with zeros to a multiple of 128, each next level the sums
    of its groups of 128, padded alike, up to a root of 128; exact in
    int32."""
    b = w.shape[0]
    levels = [torch.nn.functional.pad(w, (0, (-w.shape[1]) % BRANCH))]
    while levels[-1].shape[-1] > BRANCH:
        grp = levels[-1].view(b, -1, BRANCH).sum(-1, dtype=torch.int32)
        levels.append(torch.nn.functional.pad(grp, (0, (-grp.shape[-1])
                                                    % BRANCH)))
    return levels


def take_row(level: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Group idx[b] of row b of a pyramid level (B, G * 128) -> (B, 128),
    a row of INT32_MIN where idx >= G: jnp.take_along_axis's fill for an
    index out of range (reached only by a draw from a row of all-zero
    sums, which prepare turns uniform over the padding too)."""
    rows = level.view(level.shape[0], -1, BRANCH)
    g = rows.shape[1]
    inside = idx < g
    safe = torch.where(inside, idx, torch.zeros_like(idx)).long()
    row = torch.gather(rows, 1, safe[:, None, None].expand(-1, 1, BRANCH))
    return torch.where(inside[:, None], row[:, 0],
                       torch.full_like(row[:, 0], INT32_MIN)).contiguous()


def _ky_draw(weights: torch.Tensor, key: prng.Key, precision: int,
             max_retries: int) -> torch.Tensor:
    """One draw per row of (B, 128) weights with the words of
    `random_words(key, (B,), n_words)`, hashed by K1 on the card."""
    labels, _ = ky_sampler.ky_sample_keyed(
        weights, key, n_bins=weights.shape[1], precision=precision,
        max_retries=max_retries)
    return labels


def gumbel_token_sample(logits: torch.Tensor, key: prng.Key
                        ) -> torch.Tensor:
    g = prng.gumbel(key, logits.shape, device=logits.device)
    return torch.argmax(logits.float() + g, dim=-1).to(torch.int32)


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_tokens(logits: torch.Tensor, key: prng.Key, method: str = "ky",
                  **kw) -> torch.Tensor:
    if method == "ky":
        return ky_token_sample(logits, key, **kw)
    if method == "gumbel":
        return gumbel_token_sample(logits, key)
    if method == "greedy":
        return greedy_token(logits)
    raise ValueError(method)
