"""Checkerboard (2-colour) chromatic Gibbs for grid MRFs (paper Eqn. 7,
Fig. 1f); port of `repro/core/mrf.py`.

The regular-PM counterpart of `bayesnet.py`: a 4-connected Potts/Ising grid
needs exactly two colours, so one Gibbs iteration is two dense half-steps,
each updating every other site at once, the paper's best-case workload
(Penguin/Art image tasks).  The per-site pipeline is the same C2->C1 chain:

    neighbour labels -> energy -> LUT-exp weights -> KY draw

`labels` carries a leading chains axis (B, H, W).  This is the unfused
engine, plain torch; the schedule backend's `fused=True` runs each
half-step as one launch of the K4 kernel (`kernels/mrf_gibbs.py`) on the
same random words, so its lut_ky labels are bit-identical.

Constants enter the float ops as 0-dim float32 tensors (`interp.scalar`):
an op with one is one IEEE float32 op on any device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import prng
from repro_torch.core.draws import draw_from_logits
from repro_torch.core.graphs import GridMRF
from repro_torch.core.interp import build_exp_weight_lut, scalar
from repro_torch.diag import accum as diag_accum


def neighbor_value_counts(labels: torch.Tensor, n_labels: int) -> torch.Tensor:
    """(..., H, W) labels -> (..., H, W, V) float32 count of 4-neighbours
    per value.  Border sites see fewer neighbours (the free boundary of the
    benchmark MRFs)."""
    v_range = torch.arange(n_labels, dtype=labels.dtype, device=labels.device)
    onehot = (labels[..., None] == v_range).to(torch.float32)
    h_ax, w_ax = labels.dim() - 2, labels.dim() - 1

    def shift(x, d, axis):
        """x moved one step along `axis` (d > 0: towards higher indices),
        zero-filled, so that site i sees its neighbour at i - d."""
        n = x.shape[axis]
        out = torch.zeros_like(x)
        if d > 0:
            out.narrow(axis, 1, n - 1).copy_(x.narrow(axis, 0, n - 1))
        else:
            out.narrow(axis, 0, n - 1).copy_(x.narrow(axis, 1, n - 1))
        return out

    return (
        shift(onehot, 1, h_ax)
        + shift(onehot, -1, h_ax)
        + shift(onehot, 1, w_ax)
        + shift(onehot, -1, w_ax)
    )


def site_log_potentials(
    mrf: GridMRF, labels: torch.Tensor, evidence: torch.Tensor
) -> torch.Tensor:
    """Unnormalized log P(site = v | neighbours, evidence) for every
    site/value.  labels (..., H, W), evidence (H, W) -> (..., H, W, V)."""
    counts = neighbor_value_counts(labels, mrf.n_labels)
    v_range = torch.arange(mrf.n_labels, dtype=labels.dtype,
                           device=labels.device)
    smooth = scalar(mrf.theta, counts) * counts
    if mrf.data_cost == "potts":
        data = scalar(mrf.h, counts) * (
            evidence[..., None] == v_range).to(torch.float32)
    elif mrf.data_cost == "quadratic":
        diff = (evidence[..., None] - v_range).to(torch.float32)
        data = scalar(-mrf.h, counts) * diff * diff
    else:
        raise ValueError(mrf.data_cost)
    return smooth + data


def checkerboard_mask(
    h: int, w: int, parity: int, device="cpu", row0: int = 0
) -> torch.Tensor:
    """(h, w) bool, True where ((row0 + r) + c) % 2 == parity: the active
    sites of a grid, or of a row slab whose first row is global row row0."""
    ii = (torch.arange(row0, row0 + h, device=device)[:, None]
          + torch.arange(w, device=device)[None, :])
    return (ii % 2) == parity


def half_step(
    mrf: GridMRF,
    labels: torch.Tensor,
    evidence: torch.Tensor,
    key: prng.Key,
    parity: int,
    sampler: str = "lut_ky",
    exp_table: torch.Tensor | None = None,
    exp_spec=None,
    pin_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Update all sites of one checkerboard colour at once (Alg. 2).

    `pin_mask` ((H, W) bool) keeps pinned pixels out of the update: draws
    are still computed for the whole grid (the random words of a site do
    not depend on the mask), but pinned sites keep their current labels."""
    if exp_table is None:
        exp_table, exp_spec = build_exp_weight_lut(device=labels.device)
    logp = site_log_potentials(mrf, labels, evidence)
    new = draw_from_logits(logp, key, sampler, exp_table, exp_spec)
    mask = checkerboard_mask(mrf.height, mrf.width, parity, labels.device)
    if pin_mask is not None:
        mask = mask & ~pin_mask
    return torch.where(mask, new, labels)


@dataclasses.dataclass
class MRFChainState:
    """Resume point for a grid-MRF Gibbs run: carrying (labels, key) across
    `mrf_gibbs_loop` calls makes a sliced run equal an uninterrupted one
    (the key is split once per iteration in sequence, and there is no
    burn-in or thinning state to realign).  `quality` carries the run's
    `diag.accum.QualityAccum` over the flattened site axis when the run was
    started with diagnostics on."""

    labels: torch.Tensor  # (B, H, W) int32 current chain states
    key: prng.Key  # key as of the next iteration
    quality: diag_accum.QualityAccum | None = None


def init_labels(
    mrf: GridMRF,
    key: prng.Key,
    n_chains: int,
    pin_mask: torch.Tensor | None = None,
    pin_vals: torch.Tensor | None = None,
    device="cuda",
) -> tuple[torch.Tensor, prng.Key]:
    """Random (B, H, W) label init with pinned pixels clamped to their
    values; the random tensor covers every site whatever the mask.
    Returns (labels, advanced key)."""
    k0, key = prng.split(key)
    labels = prng.randint(
        k0, (n_chains, mrf.height, mrf.width), 0, mrf.n_labels, device
    )
    if pin_mask is not None:
        labels = torch.where(pin_mask[None], pin_vals[None], labels)
    return labels, key


def site_onehot(labels: torch.Tensor, n_labels: int) -> torch.Tensor:
    """(B, H, W) labels -> (B, H*W, V) int32 one-hot, the quality
    accumulator's per-iteration input."""
    v_range = torch.arange(n_labels, dtype=labels.dtype, device=labels.device)
    return (labels.reshape(labels.shape[0], -1)[..., None]
            == v_range).to(torch.int32)


def mrf_gibbs_loop(
    mrf: GridMRF,
    evidence: torch.Tensor,
    key: prng.Key | None,
    n_chains: int,
    n_iters: int,
    sampler: str,
    pin_mask: torch.Tensor | None = None,
    pin_vals: torch.Tensor | None = None,
    carry: MRFChainState | None = None,
    return_state: bool = False,
    diag_total: int | None = None,
    diag_batch: int = diag_accum.DEFAULT_BATCH_LEN,
):
    """The eager iteration body: n_iters x (even half-step, odd half-step)
    on evidence's device, pins held fixed throughout.

    `carry` resumes a previous call's `MRFChainState` (then `key` is
    ignored and may be None) and `n_iters` counts *additional* iterations:
    sliced runs equal uninterrupted ones.  `return_state=True` returns
    (labels, state) instead of labels alone.

    `diag_total` (the query's total iteration budget) switches the
    streaming quality accumulator on for a fresh run: every iteration's
    labels feed a per-site one-hot into `diag.accum.update` (MRF runs have
    no burn-in or thinning, so every iteration is kept).  The update
    consumes no randomness."""
    dev = evidence.device
    exp_table, exp_spec = build_exp_weight_lut(device=dev)
    if carry is None:
        labels, key = init_labels(mrf, key, n_chains, pin_mask, pin_vals, dev)
        quality = None
        if diag_total is not None:
            quality = diag_accum.make_accum(
                n_chains, mrf.height * mrf.width, mrf.n_labels, diag_total,
                diag_batch, dev,
            )
    else:
        labels, key, quality = carry.labels, carry.key, carry.quality

    for _ in range(n_iters):
        key, ka, kb = prng.split(key, 3)
        labels = half_step(mrf, labels, evidence, ka, 0, sampler, exp_table,
                           exp_spec, pin_mask)
        labels = half_step(mrf, labels, evidence, kb, 1, sampler, exp_table,
                           exp_spec, pin_mask)
        if quality is not None:
            quality = diag_accum.update(
                quality, site_onehot(labels, mrf.n_labels), True)
    if return_state:
        return labels, MRFChainState(labels=labels, key=key, quality=quality)
    return labels


def run_mrf_gibbs(
    mrf: GridMRF,
    evidence,
    key: prng.Key | None,
    n_chains: int = 1,
    n_iters: int = 30,
    sampler: str = "lut_ky",
    pin_mask: torch.Tensor | None = None,
    pin_vals: torch.Tensor | None = None,
    carry: MRFChainState | None = None,
    return_state: bool = False,
    diag_total: int | None = None,
    diag_batch: int = diag_accum.DEFAULT_BATCH_LEN,
    device="cuda",
):
    """Full chromatic Gibbs on `device`: n_iters x (even half-step, odd
    half-step).  Returns final labels (B, H, W), the approximate MPE state
    of the denoising benchmarks (paper Eqn. 4).  `evidence` is an (H, W)
    integer image (array or tensor); `pin_mask`/`pin_vals` ((H, W) bool /
    int32 tensors on `device`) clamp pixels at known labels for the whole
    run.  `carry`/`return_state` slice the run and `diag_total`/
    `diag_batch` switch its quality accumulator on (see
    `mrf_gibbs_loop`)."""
    dev = device_mod.resolve(device)
    evidence = torch.as_tensor(evidence, dtype=torch.int32, device=dev)
    return mrf_gibbs_loop(
        mrf, evidence, key, n_chains, n_iters, sampler, pin_mask, pin_vals,
        carry=carry, return_state=return_state,
        diag_total=diag_total, diag_batch=diag_batch,
    )


def total_energy(
    mrf: GridMRF, labels: torch.Tensor, evidence: torch.Tensor
) -> torch.Tensor:
    """E(l) (paper Eqn. 3/7 numerator, log domain), a convergence metric."""
    right = (labels[..., :, 1:] == labels[..., :, :-1]).to(torch.float32)
    down = (labels[..., 1:, :] == labels[..., :-1, :]).to(torch.float32)
    smooth = scalar(mrf.theta, right) * (right.sum((-1, -2))
                                         + down.sum((-1, -2)))
    if mrf.data_cost == "potts":
        data = scalar(mrf.h, right) * (labels == evidence).to(
            torch.float32).sum((-1, -2))
    else:
        diff = (labels - evidence).to(torch.float32)
        data = scalar(-mrf.h, right) * (diff * diff).sum((-1, -2))
    return smooth + data


def make_denoising_problem(
    h: int, w: int, n_labels: int, noise: float, seed: int = 0
):
    """Synthetic Penguin/Art-style task: piecewise-constant image + label
    noise.  Returns numpy (clean (H, W), noisy evidence (H, W)) int32."""
    rng = np.random.default_rng(seed)
    clean = np.zeros((h, w), np.int32)
    for _ in range(max(3, n_labels)):
        r0, c0 = rng.integers(0, h), rng.integers(0, w)
        rh, cw = rng.integers(h // 4, h), rng.integers(w // 4, w)
        clean[r0 : r0 + rh, c0 : c0 + cw] = rng.integers(0, n_labels)
    flip = rng.random((h, w)) < noise
    noisy = np.where(flip, rng.integers(0, n_labels, (h, w)), clean)
    return clean, noisy.astype(np.int32)
