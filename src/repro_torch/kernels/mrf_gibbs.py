"""K4: one checkerboard Gibbs half-step of a grid MRF, and K6: the same
over one mesh position's row slab, as CUDA kernels.

Replaces the reference's Pallas kernel `mrf_half_step_kernel`
(src/repro/kernels/mrf_gibbs.py:159; body `_mrf_tile_body` :38, kernel
`_mrf_kernel` :101, vmapped over the chains by `mrf_round_step` :229).
The CUDA source is `csrc/mrf_gibbs.cu`; it inlines K2's lerp and K1's KY
walk from `csrc/aia_common.cuh`, as K3 does.

For every site of the active parity: count the 4-neighbours holding each
value (-1 beyond the borders), energy `theta * cnt + data` (Potts or
quadratic data cost), subtract the max, LUT-exp to integer weights, KY
walk; the other parity's sites keep their labels.

Random words are `ky.random_words(key, (B, H, W), n_words)`, the stream
the unfused `draw_from_logits` consumes for the same half-step, so lut_ky
labels are bit-identical to `core.mrf.half_step`.  The reference generates
them with XLA outside its kernel; K4 makes them inside, from the
half-step's key: active site (chain, r, c) owns counters
`site_word_index(chain, r, c, H, W, n_words)` + j of the stream, hashed
(threefry2x32, partitionable mode) only when the site's walk reaches word
j.  The other parity's words are never generated.

Bound on the H100: bytes: the labels read and written once (33.6 MB for
Penguin at B = 1024, ~10 us) against one threefry call per 32 walk steps
of every active site (~2.1 M calls, each 41 bit operations on the ALU
lanes, ~5 us; counts from the SASS, chip_smoke's threefry phase).

`mrf_half_step` launches the kernel for CUDA tensors (counted in
`mrf_half_step.launches`).  For CPU tensors it generates the key's words
with `round_words` and runs the plain twin `mrf_half_step_ref` on them.
`mrf_round_step` is the reference's entry point.

K6 (`mrf_halo_half_step`, twin `mrf_halo_half_step_ref`, counter
`mrf_halo_half_step.launches`) replaces the reference's
`mrf_halo_half_step_kernel` (src/repro/kernels/mrf_gibbs.py:280): K4's
template over a (b_loc, h_loc, W) row slab whose rows -1 and h_loc are
halo rows from the neighbouring positions, with the checkerboard taken at
the slab's global row offset.  `mrf_sharded_round_step` is the reference's
caller (:363) over every position of a (chains x rows) mesh at once: one
word stream per round (generated with torch, `round_words`), K6 per
position reading its slab of it.  Bound: bytes (the slab's active words,
its labels read and written once).
"""

from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core import ky as ky_core
from repro_torch.core.graphs import GridMRF
from repro_torch.core.interp import LUTSpec, interp_ref, inv_dx, scalar
from repro_torch.core.mrf import checkerboard_mask
from repro_torch.kernels import _lib
from repro_torch.kernels.bn_gibbs import SweepParams
from repro_torch.kernels.ky_sampler import LANES

# The sampler whose draw pipeline this kernel implements; anything else
# must be rejected loudly by the callers (never silently fall back).
FUSED_MRF_SAMPLERS = ("lut_ky",)

_TILE_ROWS = 32  # the reference's DEFAULT_BLOCK_H
_SMEM_DEFAULT = 48 * 1024
_SMEM_MAX = 232448  # 227 KB, after the dynamic shared-memory opt-in


def check_fused_sampler(sampler: str) -> None:
    if sampler not in FUSED_MRF_SAMPLERS:
        raise ValueError(
            f"fused MRF rounds implement the lut_ky datapath only, got "
            f"sampler={sampler!r}"
        )


def half_step_params(
    mrf: GridMRF, precision: int = 16, max_retries: int = 8
) -> SweepParams:
    """The draw's static parameters, widened as `draw_from_logits` widens
    them for 8-bit weights over n_labels bins."""
    v = mrf.n_labels
    if v >= LANES:  # raised, not asserted: must hold under `python -O`
        raise ValueError(f"n_labels {v} >= {LANES} KY lanes")
    precision = max(precision, 8 + (v - 1).bit_length() + 1)
    return SweepParams(v, 8, precision, max_retries)


def round_words(
    mrf: GridMRF, key: prng.Key, n_chains: int, p: SweepParams, device
) -> torch.Tensor:
    """One half-step's packed words, (B, H, W, n_words) int32: the twin's
    input, and K6's; K4 hashes the active sites' words itself."""
    return ky_core.random_words(
        key, (n_chains, mrf.height, mrf.width), p.n_words, device
    )


def site_word_index(
    chain: int, r: int, c: int, height: int, width: int, n_words: int
) -> int:
    """The counter of word 0 of site (chain, r, c) in its half-step's
    stream, laid out (B, H, W, n_words); word j is this + j.  K4 computes
    the same index (mrf_gibbs.cu, 64-bit)."""
    return ((chain * height + r) * width + c) * n_words


def _check_grid(mrf, labels, evidence) -> None:
    if labels.dtype != torch.int32 or labels.dim() != 3 or tuple(
            labels.shape[1:]) != (mrf.height, mrf.width):
        raise ValueError(
            f"labels must be (B, {mrf.height}, {mrf.width}) int32")
    hh, ww = labels.shape[1:]
    if evidence.dtype != torch.int32 or tuple(evidence.shape) != (hh, ww):
        raise ValueError(f"evidence must be ({hh}, {ww}) int32")
    if mrf.data_cost not in ("potts", "quadratic"):
        raise ValueError(mrf.data_cost)


def _check(mrf, labels, evidence, words, p: SweepParams) -> None:
    _check_grid(mrf, labels, evidence)
    b, hh, ww = labels.shape
    if words.dtype != torch.int32 or tuple(words.shape) != (
            b, hh, ww, p.n_words):
        raise ValueError(f"words must be ({b}, {hh}, {ww}, {p.n_words}) int32")


def site_weights(
    mrf: GridMRF, labels: torch.Tensor, evidence: torch.Tensor,
    exp_table: torch.Tensor, exp_spec: LUTSpec,
    up_halo: torch.Tensor | None = None,
    down_halo: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, H, W, V) int32 LUT-exp weights of every site, in the op order of
    the reference's oracle `kernels/ref.py:41` `mrf_gibbs_half_step` and of
    the kernel: neighbours -1 beyond the borders, cnt = ((up + down) +
    left) + right, e = theta * cnt + data, z = e - max_v e, LUT-exp, round,
    clamp at 0.  `up_halo`/`down_halo` ((B, W)) stand above the first row
    and below the last one in place of -1 (a slab's neighbour rows)."""
    neg_row = torch.full_like(labels[..., :1, :], -1)
    neg_col = torch.full_like(labels[..., :, :1], -1)
    above = neg_row if up_halo is None else up_halo[:, None, :]
    below = neg_row if down_halo is None else down_halo[:, None, :]
    up = torch.cat([above, labels[..., :-1, :]], dim=-2)
    down = torch.cat([labels[..., 1:, :], below], dim=-2)
    left = torch.cat([neg_col, labels[..., :, :-1]], dim=-1)
    right = torch.cat([labels[..., :, 1:], neg_col], dim=-1)
    f32 = torch.float32
    theta = scalar(mrf.theta, exp_table)
    energies = []
    for v in range(mrf.n_labels):
        cnt = (((up == v).to(f32) + (down == v).to(f32))
               + (left == v).to(f32)) + (right == v).to(f32)
        if mrf.data_cost == "potts":
            data = scalar(mrf.h, exp_table) * (evidence == v).to(f32)
        else:
            diff = (evidence - v).to(f32)
            data = scalar(-mrf.h, exp_table) * diff * diff
        energies.append(theta * cnt + data)
    e = torch.stack(energies, dim=-1)
    z = e - e.amax(-1, keepdim=True)
    w = torch.round(interp_ref(z, exp_table.reshape(-1), exp_spec))
    return torch.clamp(w, min=0.0).to(torch.int32)


def mrf_half_step_ref(
    mrf: GridMRF, labels: torch.Tensor, evidence: torch.Tensor,
    words: torch.Tensor, parity: int, exp_table: torch.Tensor,
    exp_spec: LUTSpec, p: SweepParams,
) -> torch.Tensor:
    """Plain torch twin of K4: `site_weights`, the KY walk of every site,
    then the checkerboard select (the kernel walks the active sites only;
    each site reads only its own words, so the labels are the same)."""
    _check(mrf, labels, evidence, words, p)
    b, hh, ww = labels.shape
    w = site_weights(mrf, labels, evidence, exp_table, exp_spec)
    # w >= 0, so the plain walk's argmax fallback is the kernel's
    new, _ = ky_core.ky_sample_fast(
        w.reshape(-1, mrf.n_labels), words.reshape(-1, p.n_words),
        n_bins=mrf.n_labels, precision=p.precision,
        max_retries=p.max_retries,
    )
    mask = checkerboard_mask(hh, ww, parity, labels.device)
    return torch.where(mask, new.reshape(b, hh, ww), labels)


def tile_rows(width: int, lut_size: int) -> int:
    """Rows of the grid a block takes: the reference's 32 where its label
    rows (plus two halo rows), evidence rows and LUT fit the default 48 KB
    of shared memory, fewer for wide grids, and one row (with the opt-in
    to 227 KB) for the widest."""
    fit = (_SMEM_DEFAULT // 4 - lut_size - 2 * width) // (2 * width)
    rows = max(1, min(_TILE_ROWS, fit))
    if 4 * ((2 * rows + 2) * width + lut_size) > _SMEM_MAX:
        raise ValueError(f"grid width {width} does not fit one block's "
                         "shared memory")
    return rows


def mrf_half_step(
    mrf: GridMRF, labels: torch.Tensor, evidence: torch.Tensor,
    key: prng.Key, parity: int, exp_table: torch.Tensor,
    exp_spec: LUTSpec, p: SweepParams,
) -> torch.Tensor:
    """One half-step over (B, H, W) int32 labels, drawing from the
    half-step's `key`: K4 for CUDA tensors (it hashes its words itself),
    the twin on `round_words(mrf, key, ...)` for CPU tensors.  Returns new
    labels; the input is left as it was."""
    _check_grid(mrf, labels, evidence)
    if not isinstance(key, prng.Key):
        raise TypeError(
            f"mrf_half_step draws from a prng.Key, got {type(key)}")
    if labels.device.type == "cpu":
        words = round_words(mrf, key, labels.shape[0], p, labels.device)
        return mrf_half_step_ref(mrf, labels, evidence, words, parity,
                                 exp_table, exp_spec, p)
    tab = exp_table.reshape(-1)
    _lib.require_cuda("mrf_half_step", labels, evidence, tab)
    b, hh, ww = labels.shape
    out = torch.empty_like(labels)
    P, I, U, F = _lib.PTR, _lib.INT, _lib.UINT, _lib.FLOAT
    fn = _lib.function(
        "mrf_gibbs", "aia_mrf_half_step",
        [P, P, P, U, U, P, I, I, I, I, I, I, I, F, F, F, I, F, F, I, I, I,
         P],
    )
    with torch.cuda.device(labels.device):
        code = fn(
            labels.data_ptr(), out.data_ptr(), evidence.data_ptr(),
            key.k1, key.k2, tab.data_ptr(), b, hh, ww,
            tile_rows(ww, exp_spec.size), mrf.n_labels, parity,
            int(mrf.data_cost == "quadratic"), mrf.theta, mrf.h, -mrf.h,
            exp_spec.size, exp_spec.x0, inv_dx(exp_spec), p.n_words,
            p.precision, p.total_steps, _lib.stream_of(labels),
        )
    _lib.check("mrf_gibbs", code, "mrf_half_step")
    mrf_half_step.launches += 1
    return out


mrf_half_step.launches = 0


def mrf_round_step(
    mrf: GridMRF,
    labels: torch.Tensor,
    evidence: torch.Tensor,
    key: prng.Key,
    parity: int,
    exp_table: torch.Tensor,
    exp_spec: LUTSpec,
    *,
    precision: int = 16,
    max_retries: int = 8,
) -> torch.Tensor:
    """One schedule round (a single checkerboard parity) through K4, the
    `compile.backend` entry point for `fused=True` MRF execution: words of
    `ky.random_words(key, (B, H, W), n_words)`, the stream
    `draw_from_logits` consumes for the eager half-step, so lut_ky labels
    are bit-identical to `core.mrf.half_step` under the same key."""
    p = half_step_params(mrf, precision, max_retries)
    return mrf_half_step(mrf, labels, evidence, key, parity, exp_table,
                         exp_spec, p)


def _check_slab(mrf, labels, up, down, row0, evidence, words, p) -> None:
    """K6's inputs: a (b, h, W) int32 slab of rows [row0, row0 + h) of the
    grid, each chain's rows contiguous (chains may be strided), (b, W)
    halos, (h, W) evidence rows and (b, h, W, n_words) words laid out
    like the labels."""
    if labels.dtype != torch.int32 or labels.dim() != 3 or (
            labels.shape[2] != mrf.width):
        raise ValueError(f"labels must be (B, h, {mrf.width}) int32")
    b, hh, ww = labels.shape
    if not 0 <= row0 <= mrf.height - hh:
        raise ValueError(f"rows [{row0}, {row0 + hh}) lie outside the "
                         f"grid's {mrf.height}")
    for name, t in (("up_halo", up), ("down_halo", down)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b, ww):
            raise ValueError(f"{name} must be ({b}, {ww}) int32")
    if evidence.dtype != torch.int32 or tuple(evidence.shape) != (hh, ww):
        raise ValueError(f"evidence must be ({hh}, {ww}) int32")
    if words.dtype != torch.int32 or tuple(words.shape) != (
            b, hh, ww, p.n_words):
        raise ValueError(f"words must be ({b}, {hh}, {ww}, {p.n_words}) int32")
    if mrf.data_cost not in ("potts", "quadratic"):
        raise ValueError(mrf.data_cost)


def mrf_halo_half_step_ref(
    mrf: GridMRF, labels: torch.Tensor, up_halo: torch.Tensor,
    down_halo: torch.Tensor, row0: int, evidence: torch.Tensor,
    words: torch.Tensor, parity: int, exp_table: torch.Tensor,
    exp_spec: LUTSpec, p: SweepParams,
) -> torch.Tensor:
    """Plain torch twin of K6: `site_weights` with the halo rows, the KY
    walk of every site, then the checkerboard select at global row row0."""
    _check_slab(mrf, labels, up_halo, down_halo, row0, evidence, words, p)
    b, hh, ww = labels.shape
    w = site_weights(mrf, labels, evidence, exp_table, exp_spec, up_halo,
                     down_halo)
    new, _ = ky_core.ky_sample_fast(
        w.reshape(-1, mrf.n_labels), words.reshape(-1, p.n_words),
        n_bins=mrf.n_labels, precision=p.precision,
        max_retries=p.max_retries,
    )
    mask = checkerboard_mask(hh, ww, parity, labels.device, row0)
    return torch.where(mask, new.reshape(b, hh, ww), labels)


def _rows_contiguous(t: torch.Tensor) -> bool:
    """Each chain's block (all dims but the first) is dense row-major."""
    expect = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != expect:
            return False
        expect *= size
    return True


def mrf_halo_half_step(
    mrf: GridMRF, labels: torch.Tensor, up_halo: torch.Tensor,
    down_halo: torch.Tensor, row0: int, evidence: torch.Tensor,
    words: torch.Tensor, parity: int, exp_table: torch.Tensor,
    exp_spec: LUTSpec, p: SweepParams, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """One half-step over a (b, h, W) slab of grid rows [row0, row0 + h):
    K6 for CUDA tensors, the twin for CPU tensors.  `labels`, `words` and
    `out` may be slabs of larger tensors (strided across chains, dense
    within one); K6 writes into `out` (a new tensor when None), which must
    not overlap `labels`.  Returns the slab's new labels."""
    _check_slab(mrf, labels, up_halo, down_halo, row0, evidence, words, p)
    if labels.device.type == "cpu":
        new = mrf_halo_half_step_ref(mrf, labels, up_halo, down_halo, row0,
                                     evidence, words, parity, exp_table,
                                     exp_spec, p)
        if out is None:
            return new
        out.copy_(new)
        return out
    tab = exp_table.reshape(-1)
    if out is None:
        out = torch.empty_strided(labels.shape, labels.stride(),
                                  dtype=labels.dtype, device=labels.device)
    b, hh, ww = labels.shape
    if (tuple(out.shape) != (b, hh, ww) or out.dtype != torch.int32
            or out.stride(0) != labels.stride(0)):
        raise ValueError("out must be shaped and strided like labels")
    for name, t in (("labels", labels), ("words", words), ("out", out)):
        if not _rows_contiguous(t):
            raise ValueError(f"mrf_halo_half_step: {name} must be dense "
                             "within each chain")
    _lib.require_cuda("mrf_halo_half_step", up_halo, down_halo, evidence,
                      tab)
    for t in (labels, words, out):
        if t.device != evidence.device:
            raise ValueError("mrf_halo_half_step: every tensor must be on "
                             f"{evidence.device}, got {t.device}")
    P, I, L, F = _lib.PTR, _lib.INT, _lib.LONG, _lib.FLOAT
    fn = _lib.function(
        "mrf_gibbs", "aia_mrf_halo_half_step",
        [P, P, P, P, L, I, P, P, L, P, I, I, I, I, I, I, I, F, F, F, I, F, F,
         I, I, I, P],
    )
    with torch.cuda.device(labels.device):
        code = fn(
            labels.data_ptr(), out.data_ptr(), up_halo.data_ptr(),
            down_halo.data_ptr(), labels.stride(0), row0,
            evidence.data_ptr(), words.data_ptr(), words.stride(0),
            tab.data_ptr(), b, hh, ww, tile_rows(ww, exp_spec.size),
            mrf.n_labels, parity, int(mrf.data_cost == "quadratic"),
            mrf.theta, mrf.h, -mrf.h, exp_spec.size, exp_spec.x0,
            inv_dx(exp_spec), p.n_words, p.precision, p.total_steps,
            _lib.stream_of(labels),
        )
    _lib.check("mrf_gibbs", code, "mrf_halo_half_step")
    mrf_halo_half_step.launches += 1
    return out


mrf_halo_half_step.launches = 0


def mrf_sharded_round_step(
    mrf: GridMRF,
    labels: torch.Tensor,
    evidence: torch.Tensor,
    key: prng.Key,
    parity: int,
    exp_table: torch.Tensor,
    exp_spec: LUTSpec,
    *,
    n_chain_pos: int,
    n_row_pos: int,
    up_halo: torch.Tensor,
    down_halo: torch.Tensor,
    precision: int = 16,
    max_retries: int = 8,
) -> torch.Tensor:
    """One schedule round on every position of an (n_chain_pos x n_row_pos)
    mesh: chain block ci and row slab gi of the (B, H, W) labels go through
    one K6 launch each.  The round's words are generated once over the full
    (B, H, W) grid, the stream the single-device round draws, and each
    position reads its slab of them, so the labels are bit-identical to
    `mrf_round_step` whatever the mesh.  `up_halo`/`down_halo` are the
    (n_row_pos, B, W) rows the exchange delivered to each slab (-1 beyond
    the grid).  Every position reads the pre-round labels and writes its
    slab of a new tensor, as every device of the reference reads its own
    pre-round shard."""
    b, height, width = labels.shape
    if height % n_row_pos or b % n_chain_pos:
        raise ValueError(
            f"a ({b}, {height}, {width}) grid does not split over "
            f"{n_chain_pos} x {n_row_pos} positions"
        )
    p = half_step_params(mrf, precision, max_retries)
    words = round_words(mrf, key, b, p, labels.device)
    out = torch.empty_like(labels)
    b_loc, h_loc = b // n_chain_pos, height // n_row_pos
    for ci in range(n_chain_pos):
        cs = slice(ci * b_loc, (ci + 1) * b_loc)
        for gi in range(n_row_pos):
            rs = slice(gi * h_loc, (gi + 1) * h_loc)
            mrf_halo_half_step(
                mrf, labels[cs, rs], up_halo[gi, cs], down_halo[gi, cs],
                gi * h_loc, evidence[rs], words[cs, rs], parity, exp_table,
                exp_spec, p, out=out[cs, rs],
            )
    return out
