"""K4: one checkerboard Gibbs half-step of a grid MRF, and K6: the same
over every row slab of a mesh with the slabs' halo rows, as CUDA kernels.

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
lanes, ~5 us; counts from the SASS, chip_smoke's threefry phase).  The
kernel (`mrf_lanes_kernel`, csrc/mrf_gibbs.cu) gives a block a few chains
of one query and a tile of rows, stages the tile's evidence once for them
and the labels as bytes, and draws with exact-width lanes and K1's
bit-plane walk; a warp is held until its slowest site's walk is done.

`mrf_half_step` launches the kernel for CUDA tensors (counted in
`mrf_half_step.launches`), as one query with the key by value.  For CPU
tensors it generates the key's words with `round_words` and runs the plain
twin `mrf_half_step_ref` on them.  `mrf_round_step` is the reference's
entry point.  `mrf_half_step_lanes` (counted in
`mrf_half_step_lanes.launches`) is K4's lane entry: one half-step over the
chains of Q queries of a serving bucket, each query with its own evidence
plane and half-step key (a (Q, 2) int32 tensor on the card); its twin
`mrf_half_step_lanes_ref` runs the per-key twin query by query.  Both are
shaped by `lanes_launch`.

K6 (`mrf_halo_half_step`, twin `mrf_halo_half_step_ref`, counter
`mrf_halo_half_step.launches`) replaces the reference's
`mrf_halo_half_step_kernel` (src/repro/kernels/mrf_gibbs.py:280), which
the reference's sharded engine calls on every device of its mesh, one row
slab each.  Its kernel (`mrf_half_step_kernel`) runs a block of chains and
grid rows split into row slabs, each slab's rows -1 and h_loc taken from
its exchanged halo rows, with the checkerboard and the words' counters at
the global chain and row.  `mrf_sharded_round_step` is the reference's
caller (:363): one K6 launch per round over every slab of a (chains x
rows) mesh, hashing the words of the single-device half-step's stream
(`site_word_index` at the global site).  For CPU tensors
`mrf_halo_half_step` builds the stream's words of its block and runs the
twin per slab.  Bound: bytes (the labels read and written once).
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
_SMS = 132  # H100 SXM
# K4's lane kernel: chains of one query a block may hold, most first, and
# grid rows a block takes at most (on the H100 fewer chains and rows a
# block ran faster than 8 x 32: PERF.md's kernel findings)
_LANE_CHAINS = (2, 1)
_LANE_ROWS = 16


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
    """One half-step's packed words, (B, H, W, n_words) int32: the twins'
    input; K4 and K6 hash the active sites' words themselves."""
    return ky_core.random_words(
        key, (n_chains, mrf.height, mrf.width), p.n_words, device
    )


def site_word_index(
    chain: int, r: int, c: int, height: int, width: int, n_words: int
) -> int:
    """The counter of word 0 of site (chain, r, c) in its half-step's
    stream, laid out (B, H, W, n_words); word j is this + j.  K4 and K6
    compute the same index at the global chain and row (mrf_gibbs.cu,
    64-bit)."""
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
    out = _half_step_lanes("mrf_half_step", mrf, labels, evidence, 1, None,
                           key, parity, exp_table, exp_spec, p)
    mrf_half_step.launches += 1
    return out


mrf_half_step.launches = 0


def _check_lanes(mrf, labels, evidence, keys):
    if labels.dtype != torch.int32 or labels.dim() != 3 or tuple(
            labels.shape[1:]) != (mrf.height, mrf.width):
        raise ValueError(
            f"labels must be (Q * B, {mrf.height}, {mrf.width}) int32")
    if keys.dtype != torch.int32 or keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError("keys must be (Q, 2) int32 key words")
    q = keys.shape[0]
    if evidence.dtype != torch.int32 or tuple(evidence.shape) != (
            q, mrf.height, mrf.width):
        raise ValueError(
            f"evidence must be ({q}, {mrf.height}, {mrf.width}) int32")
    if q < 1 or labels.shape[0] % q:
        raise ValueError(f"{labels.shape[0]} chains do not split into {q} "
                         "queries")
    if mrf.data_cost not in ("potts", "quadratic"):
        raise ValueError(mrf.data_cost)
    return q, labels.shape[0] // q


def mrf_half_step_lanes_ref(
    mrf: GridMRF, labels: torch.Tensor, evidence: torch.Tensor,
    keys: torch.Tensor, parity: int, exp_table: torch.Tensor,
    exp_spec: LUTSpec, p: SweepParams,
) -> torch.Tensor:
    """Plain torch twin of K4's lane entry: the per-key twin over each
    query's (B, H, W) block with its evidence plane and key, query by
    query."""
    q, b = _check_lanes(mrf, labels, evidence, keys)
    return torch.cat([
        mrf_half_step_ref(mrf, labels[i * b:(i + 1) * b], evidence[i],
                          round_words(mrf, k, b, p, labels.device), parity,
                          exp_table, exp_spec, p)
        for i, k in enumerate(prng.keys_of(keys))])


def lanes_launch(mrf: GridMRF, q: int, b: int, lut_size: int = 16) -> dict:
    """The lane kernel's launch for Q queries of B chains: a block takes
    `chains_per_block` chains of one query (2, or 1 where 2 leaves some of
    the card's 132 SMs without a block or overflows shared memory) and
    `tile_rows` grid rows (at most 16), staging the tile's evidence once
    for its chains; 256 threads.  The instance is exact-width for 2-8
    labels."""
    h, w, v = mrf.height, mrf.width, mrf.n_labels
    th = min(_LANE_ROWS, tile_rows(w, lut_size))
    tiles = -(-h // th)

    def smem(c):
        return 4 * lut_size + 4 * th * w + c * (th + 2) * w

    fits = [c for c in _LANE_CHAINS if smem(c) <= _SMEM_MAX]
    cpb = next((c for c in fits if q * -(-b // c) * tiles >= _SMS),
               fits[-1])
    cap = v if 2 <= v <= 8 else next(c for c in (16, 32, 128) if v <= c)
    return {"chains_per_block": cpb, "tile_rows": th, "threads": 256,
            "smem": smem(cpb), "blocks": q * -(-b // cpb) * tiles,
            "kernel": f"mrf_lanes_kernel<{cap}, {int(2 <= v <= 8)}>"}


def _half_step_lanes(name, mrf, labels, evidence, q, keys, key, parity,
                     exp_table, exp_spec, p) -> torch.Tensor:
    """Launch the lane kernel (for the entry `name`) over Q queries of
    `labels` with evidence (Q, H, W) (or (H, W) when Q = 1), drawing from
    the (Q, 2) int32 `keys` on the card, or from one `key` when keys is
    None."""
    tab = exp_table.reshape(-1)
    extra = () if keys is None else (keys,)
    _lib.require_cuda(name, labels, evidence, *extra, tab)
    hh, ww = labels.shape[1:]
    b = labels.shape[0] // q
    ln = lanes_launch(mrf, q, b, exp_spec.size)
    out = torch.empty_like(labels)
    P, I, U, F = _lib.PTR, _lib.INT, _lib.UINT, _lib.FLOAT
    fn = _lib.function(
        "mrf_gibbs", "aia_mrf_half_step_lanes",
        [P, P, P, P, U, U, P, I, I, I, I, I, I, I, I, I, F, F, F, I, F, F, I,
         I, I, P],
    )
    k1, k2 = (0, 0) if key is None else (key.k1, key.k2)
    with torch.cuda.device(labels.device):
        code = fn(
            labels.data_ptr(), out.data_ptr(), evidence.data_ptr(),
            None if keys is None else keys.data_ptr(), k1, k2,
            tab.data_ptr(), q, b, hh, ww, ln["tile_rows"],
            ln["chains_per_block"], mrf.n_labels, parity,
            int(mrf.data_cost == "quadratic"), mrf.theta, mrf.h, -mrf.h,
            exp_spec.size, exp_spec.x0, inv_dx(exp_spec), p.n_words,
            p.precision, p.total_steps, _lib.stream_of(labels),
        )
    _lib.check("mrf_gibbs", code, name)
    return out


def mrf_half_step_lanes(
    mrf: GridMRF, labels: torch.Tensor, evidence: torch.Tensor,
    keys: torch.Tensor, parity: int, exp_table: torch.Tensor,
    exp_spec: LUTSpec, p: SweepParams,
) -> torch.Tensor:
    """One half-step over the chains of Q queries, (Q * B, H, W) int32
    `labels` whose rows [q B, (q + 1) B) are query q's, with query q's
    evidence plane `evidence[q]` ((Q, H, W) int32) and half-step key, row q
    of the (Q, 2) int32 `keys`: one launch of K4's lane entry for CUDA
    tensors, each query drawing the words of its standalone
    `mrf_half_step`; the twin for CPU tensors."""
    q, b = _check_lanes(mrf, labels, evidence, keys)
    if labels.device.type == "cpu":
        return mrf_half_step_lanes_ref(mrf, labels, evidence, keys, parity,
                                       exp_table, exp_spec, p)
    out = _half_step_lanes("mrf_half_step_lanes", mrf, labels, evidence, q,
                           keys, None, parity, exp_table, exp_spec, p)
    mrf_half_step_lanes.launches += 1
    return out


mrf_half_step_lanes.launches = 0


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
    """K6's twin's inputs: a (b, h, W) int32 slab of rows [row0, row0 + h)
    of the grid, (b, W) halos, (h, W) evidence rows and (b, h, W, n_words)
    words laid out like the labels."""
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
    """Plain torch twin of K6 over one slab: `site_weights` with the halo
    rows, the KY walk of every site, then the checkerboard select at
    global row row0."""
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


def _check_slabs(mrf, labels, up, down, row0, chain0, evidence, key):
    """K6's inputs: a (b, h, W) int32 block of chains [chain0, chain0 + b)
    and grid rows [row0, row0 + h), dense within each chain, split into
    n_slabs = up.shape[0] slabs; (n_slabs, b, W) halos, (h, W) evidence."""
    if not isinstance(key, prng.Key):
        raise TypeError(f"K6 draws from a prng.Key, got {type(key)}")
    if labels.dtype != torch.int32 or labels.dim() != 3 or (
            labels.shape[2] != mrf.width):
        raise ValueError(f"labels must be (B, h, {mrf.width}) int32")
    b, hh, ww = labels.shape
    if not 0 <= row0 <= mrf.height - hh:
        raise ValueError(f"rows [{row0}, {row0 + hh}) lie outside the "
                         f"grid's {mrf.height}")
    if chain0 < 0:
        raise ValueError(f"chain0 {chain0} < 0")
    if up.dim() != 3 or up.shape[0] < 1 or hh % up.shape[0]:
        raise ValueError(f"halos must be (n_slabs, {b}, {ww}) with n_slabs "
                         f"dividing {hh} rows")
    n_slabs = up.shape[0]
    for name, t in (("up_halo", up), ("down_halo", down)):
        if t.dtype != torch.int32 or tuple(t.shape) != (n_slabs, b, ww):
            raise ValueError(f"{name} must be ({n_slabs}, {b}, {ww}) int32")
    if evidence.dtype != torch.int32 or tuple(evidence.shape) != (hh, ww):
        raise ValueError(f"evidence must be ({hh}, {ww}) int32")
    if mrf.data_cost not in ("potts", "quadratic"):
        raise ValueError(mrf.data_cost)
    if not _rows_contiguous(labels):
        raise ValueError("labels must be dense within each chain")


def mrf_halo_half_step(
    mrf: GridMRF, labels: torch.Tensor, up_halo: torch.Tensor,
    down_halo: torch.Tensor, row0: int, evidence: torch.Tensor,
    key: prng.Key, parity: int, exp_table: torch.Tensor, exp_spec: LUTSpec,
    p: SweepParams, chain0: int = 0,
) -> torch.Tensor:
    """One half-step of the half-step `key` over a (b, h, W) block of
    chains [chain0, chain0 + b) and grid rows [row0, row0 + h), split into
    n_slabs = up_halo.shape[0] row slabs of h / n_slabs rows, slab g's
    neighbour rows being up_halo[g] and down_halo[g] ((b, W), -1 beyond
    the grid): one K6 launch for CUDA tensors (the input may be a block of
    a larger tensor, strided across chains), the twin per slab on the
    stream's words for CPU tensors.  The draws are the single-device
    half-step's (`site_word_index` at the global site).  Returns the
    block's new labels as a new tensor."""
    _check_slabs(mrf, labels, up_halo, down_halo, row0, chain0, evidence,
                 key)
    b, hh, ww = labels.shape
    n_slabs = up_halo.shape[0]
    h_loc = hh // n_slabs
    if labels.device.type == "cpu":
        words = prng.bits(
            key, (b, mrf.height, ww, p.n_words), labels.device,
            start=site_word_index(chain0, 0, 0, mrf.height, ww, p.n_words),
        )[:, row0:row0 + hh]
        slabs = [slice(g * h_loc, (g + 1) * h_loc) for g in range(n_slabs)]
        return torch.cat([
            mrf_halo_half_step_ref(
                mrf, labels[:, rs], up_halo[g], down_halo[g],
                row0 + rs.start, evidence[rs], words[:, rs], parity,
                exp_table, exp_spec, p)
            for g, rs in enumerate(slabs)], dim=1)
    tab = exp_table.reshape(-1)
    _lib.require_cuda("mrf_halo_half_step", up_halo, down_halo, evidence,
                      tab)
    if labels.device != evidence.device:
        raise ValueError("mrf_halo_half_step: every tensor must be on "
                         f"{evidence.device}, got {labels.device}")
    out = torch.empty((b, hh, ww), dtype=torch.int32, device=labels.device)
    P, I, U, L, F = _lib.PTR, _lib.INT, _lib.UINT, _lib.LONG, _lib.FLOAT
    fn = _lib.function(
        "mrf_gibbs", "aia_mrf_halo_half_step",
        [P, P, L, L, P, P, L, I, I, I, I, P, U, U, P, I, I, I, I, I, I, F, F,
         F, I, F, F, I, I, I, P],
    )
    with torch.cuda.device(labels.device):
        code = fn(
            labels.data_ptr(), out.data_ptr(), labels.stride(0), hh * ww,
            up_halo.data_ptr(), down_halo.data_ptr(), chain0, row0,
            mrf.height, h_loc, n_slabs, evidence.data_ptr(), key.k1, key.k2,
            tab.data_ptr(), b, ww, min(tile_rows(ww, exp_spec.size), h_loc),
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
    mesh: one K6 launch over the (B, H, W) labels split into n_row_pos row
    slabs (a chain position is a block of whole chains, which K6 runs
    independently).  Each slab's words are those of the single-device
    round's stream at its global rows, so the labels are bit-identical to
    `mrf_round_step` whatever the mesh.  `up_halo`/`down_halo` are the
    (n_row_pos, B, W) rows the exchange delivered to each slab (-1 beyond
    the grid).  Every slab reads the pre-round labels and writes its rows
    of a new tensor, as every device of the reference reads its own
    pre-round shard."""
    b, height, width = labels.shape
    if height % n_row_pos or b % n_chain_pos:
        raise ValueError(
            f"a ({b}, {height}, {width}) grid does not split over "
            f"{n_chain_pos} x {n_row_pos} positions"
        )
    p = half_step_params(mrf, precision, max_retries)
    return mrf_halo_half_step(mrf, labels, up_halo, down_halo, 0, evidence,
                              key, parity, exp_table, exp_spec, p)
