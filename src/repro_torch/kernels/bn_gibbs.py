"""K3: one whole Bayes-net Gibbs sweep per launch, and K5: one colour
round over every position of a mesh per launch, as CUDA kernels.

Replaces the reference's Pallas kernel `fused_gibbs_sweep`
(src/repro/kernels/bn_gibbs.py:236; body `bn_round_step` :137, layout
`build_fused_rounds` :96, words `fused_round_words` :216).  The CUDA source
is `csrc/bn_gibbs.cu`; it inlines K2's lerp and K1's KY walk from
`csrc/aia_common.cuh`.

For every schedule round in order, for every (chain, node) row: gather the
CPT addresses from the chain values, sum the F factor log-probs in f32 left
to right, mask by card, subtract the max, turn the log-probs into integer
weights (LUT-exp for lut_ky, exact exp quantised to 15 bits for exact_ky),
run the KY walk and store the label.

Random words are exactly what the unfused `draw_from_logits` draws for the
same round (`ky.random_words(keys[r], (B * n_c_r,), W)` with `keys =
prng.split(key, R)`), so lut_ky is bit-identical to the unfused sweep.
The reference generates them with XLA outside its kernel; K3 makes them
inside, from the sweep's key: round r's key is `round_key(key, r)`, and
row (chain, c) of round r owns counters `row_word_index(chain, n_c_r, c,
W)` + j of that round's stream, hashed (threefry2x32, partitionable mode)
only when the row's walk reaches word j.  No word is generated outside the
kernel or stored, and a row that stops early hashes only what it consumed.

Bound on the H100: the threefry calls, then bytes (`launch/kernel_cost`):
a sweep must read and write the (B, n) values once and hash one threefry
call per 32 walk steps of every row.  The kernel (`bn_lanes_kernel`)
keeps everything else on chip: a block holds CPW chains of one query as
bytes, node-major, in shared memory for the whole sweep (the TPU kept
them VMEM-resident across its sequential grid over rounds; here a loop
over rounds inside the block takes the grid's place), with the exp LUT
and, where it fits, the log-CPT arena; a warp takes 32 / CPW nodes of a
round, each across the block's chains, so its table reads are broadcasts
and its loops uniform; the round tables are compact (`LaneTables`: the
real factors and scope slots only); and a label is stored straight into
shared memory where the TPU scattered with a one-hot matmul.  The walk
holds a warp until its slowest row is done (csrc/bn_gibbs.cu).

`bn_sweep` launches the kernel for CUDA tensors (counted in
`bn_sweep.launches`), as one query with the key by value.
`bn_sweep_lanes` (counted in `bn_sweep_lanes.launches`) is K3's lane
entry: one sweep over the chains of Q queries of a serving bucket, each
query with its own sweep key, read from a (Q, 2) int32 tensor on the card;
its twin `bn_sweep_lanes_ref` runs the per-key twin query by query.  Both
launches are shaped by `lanes_launch` and draw from the same kernel.  For
CPU tensors `bn_sweep` generates the key's words with `fused_round_words`
(rounds in order, unpadded: round r's rows are (chain, node) = chain *
n_c_r + node) and runs the plain twin `bn_sweep_ref` on them.
`fused_gibbs_sweep` is the reference's drop-in entry point.

K5 (`fused_color_round_mesh`, `fused_color_round`, twin
`fused_color_round_ref`, counter `fused_color_round.launches` for both)
replaces the reference's `fused_color_round`
(src/repro/kernels/bn_gibbs.py:316), which the reference's sharded engine
calls once per round on every mesh device.  Its kernel (`bn_rounds_kernel`,
`chains_per_block` int32 chains a block over the padded table) runs one
round over a range of mesh positions of a `core.distributed.
ShardedFusedRounds` table (owned nodes first, pad lanes after them with
node id -1, never processed): `fused_color_round_mesh` launches it once per
round over every position of the mesh, `fused_color_round` over one
position (what a mesh over several cards launches per card).  Like K3 it
takes the sweep's key and hashes each owned row's words itself, at the
row's counters in the round's full stream (`owned_row_word_index`), so its
draws are the single-device round's.  For CPU tensors both build the
round's stream (`round_stream`) and run the twin per position, which reads
its rows out of the stream.  Bound: bytes (each node position's values
read and written once).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import ky as ky_core
from repro_torch.core.bayesnet import NEG_INF, CompiledBayesNet
from repro_torch.core.interp import interp_ref, inv_dx
from repro_torch.kernels import _lib
from repro_torch.kernels.ky_sampler import LANES

# The samplers whose draw pipeline this kernel implements; anything else
# must be rejected loudly by the callers (never silently fall back).
FUSED_BN_SAMPLERS = ("lut_ky", "exact_ky")

_SMS = 132  # H100 SXM
_SMEM_DEFAULT = 48 * 1024
_SMEM_MAX = 232448  # 227 KB, after the dynamic shared-memory opt-in
# K3's lane entry: chains a block may hold (one warp's width, or a
# fraction of it), its warps at most, and the shared memory up to which a
# block stages the log-CPT arena (two blocks an SM)
_LANE_CHAINS = (32, 16, 8, 4)
_LANE_WARPS = 16
_LANE_STAGE = 100 * 1024


def check_fused_sampler(sampler: str) -> None:
    """The fused-BN sampler gate shared by every entry layer: cdf/gumbel
    draw from a different random stream entirely, so a silent fallback
    would change which engine served without anyone noticing."""
    if sampler not in FUSED_BN_SAMPLERS:
        raise ValueError(
            f"fused BN rounds implement the {'/'.join(FUSED_BN_SAMPLERS)} "
            f"datapaths only, got sampler={sampler!r}"
        )


@dataclasses.dataclass
class BNFusedRounds:
    """A round-group list padded to the common (c_max, f_max, s_max)
    envelope and stacked on a leading rounds axis.  Padded factor and scope
    slots address the arena's zero entry with stride 0; padded node lanes
    carry node id -1 and are never processed."""

    nodes: torch.Tensor  # (R, C) int32; -1 = padded lane
    cards: torch.Tensor  # (R, C) int32; 0 = padded lane
    base: torch.Tensor  # (R, C*F) int32
    stride: torch.Tensor  # (R, C*F*S) int32
    scope_var: torch.Tensor  # (R, C*F*S) int32
    is_self: torch.Tensor  # (R, C*F*S) int32 (0/1)
    n_c_t: torch.Tensor  # (R,) int32 real node count per round
    n_c: tuple[int, ...]
    c_max: int
    f_max: int
    s_max: int
    # the lane entry's compact tables, built at its first launch
    lanes: "LaneTables | None" = dataclasses.field(
        default=None, repr=False, compare=False)


def build_fused_rounds(groups) -> BNFusedRounds:
    """Stack a `ColorGroup` list into the kernel's padded layout, on the
    groups' device.  Built once per run, not per sweep."""
    c_max = max(g.nodes.shape[0] for g in groups)
    f_max = max(g.base.shape[1] for g in groups)
    s_max = max(g.stride.shape[2] for g in groups)

    def pad(x, shape, fill=0):
        out = torch.full(shape, fill, dtype=torch.int32, device=x.device)
        out[tuple(slice(0, d) for d in x.shape)] = x.to(torch.int32)
        return out.reshape(-1)

    device = groups[0].nodes.device
    n_c = tuple(int(g.nodes.shape[0]) for g in groups)
    return BNFusedRounds(
        nodes=torch.stack([pad(g.nodes, (c_max,), -1) for g in groups]),
        cards=torch.stack([pad(g.cards, (c_max,)) for g in groups]),
        base=torch.stack([pad(g.base, (c_max, f_max)) for g in groups]),
        stride=torch.stack(
            [pad(g.stride, (c_max, f_max, s_max)) for g in groups]),
        scope_var=torch.stack(
            [pad(g.scope_var, (c_max, f_max, s_max)) for g in groups]),
        is_self=torch.stack(
            [pad(g.is_self, (c_max, f_max, s_max)) for g in groups]),
        n_c_t=torch.tensor(n_c, dtype=torch.int32, device=device),
        n_c=n_c,
        c_max=c_max,
        f_max=f_max,
        s_max=s_max,
    )


@dataclasses.dataclass
class LaneTables:
    """K3's lane entry's round tables, compact: the real rows, factors and
    scope slots of a `BNFusedRounds` and nothing else, in its order (rounds
    in order, each round's nodes, each node's factors and each factor's
    slots left to right).  Row i of round r is row round_rows[r] + i; its
    factors are facs[rows[., 2]:rows[., 3]], a factor's slots
    slots[facs[., 1]:facs[., 2]].  `facs` and `slots` are sized for the
    padded envelope (plus one scratch entry that padding is routed to), so
    that the tables are built on the device with no copy to the host; only
    their leading entries are read."""

    round_rows: torch.Tensor  # (R + 1,) int32
    rows: torch.Tensor  # (N, 4) int32: node, card, first factor, end
    facs: torch.Tensor  # (N * F + 1, 4) int32: base, first slot, end, 0
    slots: torch.Tensor  # (N * F * S + 1, 2) int32: stride, 2 scope + self


def build_lane_tables(fr: BNFusedRounds) -> LaneTables:
    """`LaneTables` of `fr`, on its device.  Padded factors (base 0) trail
    each node's real ones and padded slots (stride 0) each factor's, so a
    real entry's place is a running count (no data-dependent shape)."""
    dev = fr.nodes.device
    r_n, c, f, s = len(fr.n_c), fr.c_max, fr.f_max, fr.s_max
    i32 = torch.int32
    ends = np.cumsum(fr.n_c)
    sel = np.concatenate([r * c + np.arange(k) for r, k in enumerate(fr.n_c)])
    idx = torch.from_numpy(sel).to(dev, non_blocking=True)
    n = len(sel)
    base = fr.base.reshape(r_n * c, f)[idx]
    stride = fr.stride.reshape(r_n * c, f, s)[idx]
    scope = fr.scope_var.reshape(r_n * c, f, s)[idx]
    is_self = fr.is_self.reshape(r_n * c, f, s)[idx]
    fmask = base != 0
    nf = fmask.sum(1, dtype=i32)
    f_end = torch.cumsum(nf, 0, dtype=i32)
    smask = stride != 0
    ns = smask.sum(2, dtype=i32).reshape(-1)  # 0 for a padded factor
    s_end = torch.cumsum(ns, 0, dtype=i32)
    f_ar = torch.arange(f, dtype=i32, device=dev)
    s_ar = torch.arange(s, dtype=i32, device=dev)
    fdest = torch.where(fmask, (f_end - nf)[:, None] + f_ar, n * f)
    sdest = torch.where(smask, (s_end - ns).reshape(n, f, 1) + s_ar,
                        n * f * s)
    facs = torch.zeros((n * f + 1, 4), dtype=i32, device=dev)
    facs[fdest.reshape(-1).long()] = torch.stack(
        [base, (s_end - ns).reshape(n, f), s_end.reshape(n, f),
         torch.zeros_like(base)], -1).reshape(-1, 4)
    slots = torch.zeros((n * f * s + 1, 2), dtype=i32, device=dev)
    slots[sdest.reshape(-1).long()] = torch.stack(
        [stride, 2 * scope + is_self.to(i32)], -1).reshape(-1, 2)
    round_rows = torch.from_numpy(
        np.concatenate([[0], ends]).astype(np.int32)).to(dev,
                                                         non_blocking=True)
    rows = torch.stack([fr.nodes.reshape(-1)[idx], fr.cards.reshape(-1)[idx],
                        f_end - nf, f_end], -1)
    return LaneTables(round_rows, rows.contiguous(), facs, slots)


def lane_tables(fr: BNFusedRounds) -> LaneTables:
    """`fr`'s compact tables, built once per `BNFusedRounds`."""
    if fr.lanes is None:
        fr.lanes = build_lane_tables(fr)
    return fr.lanes


@dataclasses.dataclass(frozen=True)
class SweepParams:
    """The draw's static parameters, derived as `draw_from_logits` derives
    them (precision widened so V weights of weight_bits fit 2^precision)."""

    v_max: int
    weight_bits: int
    precision: int
    max_retries: int

    @property
    def total_steps(self) -> int:
        return self.precision * self.max_retries

    @property
    def n_words(self) -> int:
        return -(-self.total_steps // 32)


def sweep_params(
    cbn: CompiledBayesNet, sampler: str, precision: int = 16,
    max_retries: int = 8,
) -> SweepParams:
    check_fused_sampler(sampler)
    v = cbn.max_card
    if v >= LANES:  # raised, not asserted: must hold under `python -O`
        raise ValueError(
            f"max_card {v} >= {LANES} KY lanes; pad wider alphabets "
            "hierarchically"
        )
    weight_bits = 8 if sampler == "lut_ky" else 15
    precision = max(precision, weight_bits + (v - 1).bit_length() + 1)
    return SweepParams(v, weight_bits, precision, max_retries)


def round_key(key: prng.Key, r: int) -> prng.Key:
    """`prng.split(key, R)[r]` for any R > r: split hashes the counter
    pair (0, r) (its two-word iota), which is how K3 derives each round's
    key inside the kernel."""
    a, b = prng.threefry2x32(key.k1, key.k2, 0, int(r))
    return prng.Key(int(a), int(b))


def row_word_index(chain: int, n_c: int, c: int, n_words: int) -> int:
    """The counter of word 0 of row (chain, c) in its round's stream, whose
    rows are (chain, node) = chain * n_c + node of n_words words each; word
    j is this + j.  K3 computes the same index (bn_gibbs.cu, 64-bit)."""
    return (chain * n_c + c) * n_words


def round_stream(
    sfr, key: prng.Key, r: int, chain0: int, n_chains: int, n_words: int,
    device,
) -> torch.Tensor:
    """Round r's stream of the sweep `key` over chains [chain0, chain0 +
    n_chains), flattened: the rows (chain, node) of
    `ky.random_words(round_key(key, r), (B * n_c_r,), W)` for those chains,
    for `fused_round_words` (K3) or a `ShardedFusedRounds` table (K5).
    The twins' input; K3 and K5 hash the rows' words themselves."""
    nc = sfr.n_c[r]
    return prng.bits(round_key(key, r), (n_chains * nc * n_words,), device,
                     start=row_word_index(chain0, nc, 0, n_words))


def fused_round_words(
    fr: BNFusedRounds, key: prng.Key, n_chains: int, n_words: int, device
) -> torch.Tensor:
    """Every round's packed words, rounds in order, unpadded: round r's
    block is `ky.random_words(keys[r], (B * n_c_r,), W)` flattened, with
    `keys = prng.split(key, R)`.  The twin's input; K3 hashes the same
    words itself."""
    return torch.cat([round_stream(fr, key, r, 0, n_chains, n_words, device)
                      for r in range(len(fr.n_c))])


def bn_round_step(
    vals: torch.Tensor, fr: BNFusedRounds, r: int, words: torch.Tensor,
    cbn: CompiledBayesNet, sampler: str, p: SweepParams,
) -> torch.Tensor:
    """One colour round, plain torch, in the reference `bn_round_step`'s op
    order: gather, factor sum left to right, card mask, max-subtract,
    weights, KY walk, scatter.  `words` is round r's (B * n_c_r, W) block."""
    nc, c, f, s = fr.n_c[r], fr.c_max, fr.f_max, fr.s_max
    return round_update(
        vals, fr.nodes[r, :nc], fr.cards[r, :nc],
        fr.base[r].reshape(c, f)[:nc], fr.stride[r].reshape(c, f, s)[:nc],
        fr.scope_var[r].reshape(c, f, s)[:nc],
        fr.is_self[r].reshape(c, f, s)[:nc],
        words.reshape(vals.shape[0], nc, p.n_words), cbn, sampler, p,
    )


def round_update(
    vals: torch.Tensor, nodes: torch.Tensor, cards: torch.Tensor,
    base: torch.Tensor, stride: torch.Tensor, scope: torch.Tensor,
    is_self: torch.Tensor, words: torch.Tensor, cbn: CompiledBayesNet,
    sampler: str, p: SweepParams,
) -> torch.Tensor:
    """The body of `bn_round_step` over the nc real nodes of one round:
    (nc,) nodes and cards, (nc, F) base, (nc, F, S) stride/scope/is_self,
    (B, nc, W) words.  Returns new values; `vals` is left as it was."""
    b, nc = vals.shape[0], nodes.shape[0]
    out = vals.clone()
    if nc == 0:
        return out
    f = base.shape[1]
    sv = vals[:, scope.long()]  # (B, nc, F, S)
    v_range = torch.arange(p.v_max, dtype=torch.int32, device=vals.device)
    val_or_v = torch.where(is_self[None, ..., None] != 0, v_range,
                           sv[..., None])
    addr = base[None, :, :, None] + (
        stride[None, ..., None] * val_or_v).sum(-2)  # (B, nc, F, V)
    # lanes v >= card may address past the arena; they are masked below
    addr = addr.clamp(0, cbn.log_flat.shape[0] - 1)
    g = cbn.log_flat[addr]
    logp = g[..., 0, :]
    for k in range(1, f):  # left to right, as XLA reduces on the CPU
        logp = logp + g[..., k, :]
    logp = torch.where(v_range < cards[None, :, None], logp,
                       torch.full_like(logp, NEG_INF))

    flat = logp.reshape(b * nc, p.v_max)
    z = flat - flat.amax(-1, keepdim=True)
    if sampler == "lut_ky":
        w = torch.clamp(
            torch.round(interp_ref(z, cbn.exp_table, cbn.exp_spec)), min=0.0,
        ).to(torch.int32)
    else:
        w = ky_core.quantize_probs(torch.exp(z), bits=p.weight_bits)
    # w >= 0, so the plain walk's argmax fallback is the kernel's
    labels, _ = ky_core.ky_sample_fast(
        w, words.reshape(b * nc, p.n_words), n_bins=p.v_max,
        precision=p.precision, max_retries=p.max_retries,
    )
    out[:, nodes.long()] = labels.reshape(b, nc)
    return out


def _check_vals(cbn, vals, sampler: str):
    check_fused_sampler(sampler)
    if vals.dtype != torch.int32 or vals.dim() != 2:
        raise ValueError("vals must be (B, n) int32")
    if vals.shape[1] != cbn.n_nodes:
        raise ValueError(f"vals has {vals.shape[1]} nodes, net has "
                         f"{cbn.n_nodes}")


def _check_sweep(cbn, fr, vals, words, sampler: str, p: SweepParams):
    _check_vals(cbn, vals, sampler)
    want = vals.shape[0] * sum(fr.n_c) * p.n_words
    if words.dtype != torch.int32 or words.numel() != want:
        raise ValueError(f"words must be {want} int32 (rounds in order)")


def bn_sweep_ref(
    cbn: CompiledBayesNet, fr: BNFusedRounds, vals: torch.Tensor,
    words: torch.Tensor, sampler: str, p: SweepParams,
) -> torch.Tensor:
    """Plain torch twin of K3: every round of one sweep, in order."""
    _check_sweep(cbn, fr, vals, words, sampler, p)
    off = 0
    for r, nc in enumerate(fr.n_c):
        n = vals.shape[0] * nc * p.n_words
        vals = bn_round_step(vals, fr, r, words[off:off + n], cbn, sampler,
                             p)
        off += n
    return vals


def chains_per_block(n_chains: int, n_nodes: int, lut_size: int) -> int:
    """Chains a K5 block keeps resident (int32): enough blocks for two per
    SM when the batch allows, within the default 48 KB of shared memory
    when a chain fits there (beyond it, one chain per block with the
    opt-in)."""
    per_chain = 4 * n_nodes
    fixed = 4 * lut_size
    fit = (_SMEM_DEFAULT - fixed) // per_chain
    cpc = max(1, min(n_chains // (2 * _SMS), fit)) if fit >= 1 else 1
    if cpc * per_chain + fixed > _SMEM_MAX:
        raise ValueError(
            f"{n_nodes} nodes do not fit one block's shared memory"
        )
    return cpc


def bn_sweep(
    cbn: CompiledBayesNet, fr: BNFusedRounds, vals: torch.Tensor,
    key: prng.Key, sampler: str, p: SweepParams,
) -> torch.Tensor:
    """One sweep over all rounds, drawing from the sweep's `key`: K3 for
    CUDA tensors (it hashes its words itself), the twin on
    `fused_round_words(fr, key, ...)` for CPU tensors."""
    _check_vals(cbn, vals, sampler)
    if not isinstance(key, prng.Key):
        raise TypeError(f"bn_sweep draws from a prng.Key, got {type(key)}")
    if vals.device.type == "cpu":
        words = fused_round_words(fr, key, vals.shape[0], p.n_words,
                                  vals.device)
        return bn_sweep_ref(cbn, fr, vals, words, sampler, p)
    out = _sweep_lanes("bn_sweep", cbn, fr, vals, 1, None, key, sampler, p)
    bn_sweep.launches += 1
    return out


bn_sweep.launches = 0


def fused_gibbs_sweep(
    cbn: CompiledBayesNet,
    fr: BNFusedRounds,
    vals: torch.Tensor,
    key: prng.Key,
    sampler: str = "lut_ky",
    *,
    precision: int = 16,
    max_retries: int = 8,
) -> torch.Tensor:
    """Drop-in for `bayesnet.gibbs_sweep` on the fused samplers: one K3
    launch runs every round of the sweep, words included, bit-exact with
    the unfused sweep for lut_ky.  Raises on samplers outside
    `FUSED_BN_SAMPLERS`."""
    p = sweep_params(cbn, sampler, precision, max_retries)
    return bn_sweep(cbn, fr, vals, key, sampler, p)


def _check_lanes(cbn, vals, keys, sampler):
    _check_vals(cbn, vals, sampler)
    if keys.dtype != torch.int32 or keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError("keys must be (Q, 2) int32 key words")
    q = keys.shape[0]
    if q < 1 or vals.shape[0] % q:
        raise ValueError(f"{vals.shape[0]} chains do not split into {q} "
                         "queries")
    return q, vals.shape[0] // q


def bn_sweep_lanes_ref(
    cbn: CompiledBayesNet, fr: BNFusedRounds, vals: torch.Tensor,
    keys: torch.Tensor, sampler: str, p: SweepParams,
) -> torch.Tensor:
    """Plain torch twin of K3's lane entry: the per-key twin over each
    query's (B, n) block of `vals` with its own key, query by query."""
    q, b = _check_lanes(cbn, vals, keys, sampler)
    return torch.cat([
        bn_sweep_ref(cbn, fr, vals[i * b:(i + 1) * b],
                     fused_round_words(fr, k, b, p.n_words, vals.device),
                     sampler, p)
        for i, k in enumerate(prng.keys_of(keys))])


def lane_stride(chains_per_warp: int) -> int:
    """Bytes between two nodes' rows of chain values in a lane block's
    shared memory: an odd number of words, so that the transposing copies
    in and out fall in 32 banks (`LaneShape::STRIDE`, bn_gibbs.cu)."""
    return 4 * ((chains_per_warp // 4) | 1)


def lanes_launch(cbn: CompiledBayesNet, fr: BNFusedRounds, q: int,
                 b: int) -> dict:
    """The lane entry's launch for Q queries of B chains: a block holds
    `chains_per_warp` chains of one query (never two: a query's last block
    is partial when they do not divide B), the largest of 32, 16, 8 and 4
    that still gives the card's 132 SMs a block each (4 where none does),
    and a warp takes 32 / chains_per_warp nodes of a round at once, each
    across those chains.  Threads: enough warps for the widest round, at
    most 16.  The log-CPT arena is staged in shared memory when the block
    then stays within `_LANE_STAGE` bytes (two blocks an SM), else it is
    read through the cache.  Raises where even 4 chains of bytes do not
    fit a block."""
    n, lut, arena = cbn.n_nodes, cbn.exp_spec.size, cbn.log_flat.numel()
    fits = [c for c in _LANE_CHAINS if 4 * lut + n * lane_stride(c)
            <= _SMEM_MAX]
    if not fits:
        raise ValueError(f"{n} nodes do not fit one block's shared memory")
    cpw = next((c for c in fits if q * -(-b // c) >= _SMS), fits[-1])
    smem = 4 * lut + n * lane_stride(cpw)
    stage = smem + 4 * arena <= _LANE_STAGE
    warps = min(_LANE_WARPS, max(-(-nc // (32 // cpw)) for nc in fr.n_c))
    v = cbn.max_card
    exact = 2 <= v <= 4
    cap = v if exact else next(c for c in (8, 16, 32, 128) if v <= c)
    return {"chains_per_warp": cpw, "threads": 32 * max(warps, 1),
            "stage_arena": stage, "smem": smem + (4 * arena if stage else 0),
            "blocks": q * -(-b // cpw),
            "kernel": f"bn_lanes_kernel<{cap}, {int(exact)}, {cpw}>"}


def _sweep_lanes(name, cbn, fr, vals, q, keys, key, sampler,
                 p) -> torch.Tensor:
    """Launch the lane kernel (for the entry `name`) over Q queries of
    `vals`, drawing from the (Q, 2) int32 `keys` on the card, or from one
    `key` when keys is None."""
    tab = cbn.exp_table
    t = lane_tables(fr)
    extra = () if keys is None else (keys,)
    _lib.require_cuda(
        name, vals, *extra, cbn.log_flat, tab, t.round_rows, t.rows, t.facs,
        t.slots,
    )
    b, n = vals.shape[0] // q, vals.shape[1]
    spec = cbn.exp_spec
    ln = lanes_launch(cbn, fr, q, b)
    out = torch.empty_like(vals)
    P, I, U, F = _lib.PTR, _lib.INT, _lib.UINT, _lib.FLOAT
    fn = _lib.function(
        "bn_gibbs", "aia_bn_sweep_lanes",
        [P, P, I, I, I, I, I, I, P, P, P, P, P, U, U, I, P, I, I, P, I, F, F,
         I, I, I, I, I, P],
    )
    k1, k2 = (0, 0) if key is None else (key.k1, key.k2)
    with torch.cuda.device(vals.device):
        code = fn(
            vals.data_ptr(), out.data_ptr(), q, b, n, ln["chains_per_warp"],
            ln["threads"], len(fr.n_c), t.round_rows.data_ptr(),
            t.rows.data_ptr(), t.facs.data_ptr(), t.slots.data_ptr(),
            None if keys is None else keys.data_ptr(), k1, k2, p.n_words,
            cbn.log_flat.data_ptr(), cbn.log_flat.numel(),
            int(ln["stage_arena"]), tab.data_ptr(), spec.size, spec.x0,
            inv_dx(spec), p.v_max, int(sampler == "exact_ky"), p.weight_bits,
            p.precision, p.total_steps, _lib.stream_of(vals),
        )
    _lib.check("bn_gibbs", code, name)
    return out


def bn_sweep_lanes(
    cbn: CompiledBayesNet, fr: BNFusedRounds, vals: torch.Tensor,
    keys: torch.Tensor, sampler: str, p: SweepParams,
) -> torch.Tensor:
    """One sweep over the chains of Q queries, (Q * B, n) int32 `vals`
    whose rows [q B, (q + 1) B) are query q's, each query drawing from its
    own sweep key, row q of the (Q, 2) int32 `keys`: one launch of K3's
    lane entry for CUDA tensors, with each query's words those of its
    standalone `bn_sweep`; the twin for CPU tensors."""
    q, b = _check_lanes(cbn, vals, keys, sampler)
    if vals.device.type == "cpu":
        return bn_sweep_lanes_ref(cbn, fr, vals, keys, sampler, p)
    out = _sweep_lanes("bn_sweep_lanes", cbn, fr, vals, q, keys, None,
                       sampler, p)
    bn_sweep_lanes.launches += 1
    return out


bn_sweep_lanes.launches = 0


def owned_row_word_index(
    sfr, d: int, r: int, c: int, chain: int, n_words: int
) -> int:
    """The counter of word 0 of owned lane c of mesh position d in round r
    of `sfr`, for the run's chain `chain`: `row_word_index` at the owned
    node's place in the round's full group (`word_pos`) over the round's
    full node count, so the row draws the single-device round's words.
    K5 computes the same index (bn_gibbs.cu, 64-bit)."""
    return row_word_index(chain, sfr.n_c[r], int(sfr.word_pos[d, r, c]),
                          n_words)


def _check_color_round(cbn, sfr, d, r, vals, words, chain0, sampler, p):
    check_fused_sampler(sampler)
    if vals.dtype != torch.int32 or vals.dim() != 2 or (
            vals.shape[1] != cbn.n_nodes):
        raise ValueError(f"vals must be (B, {cbn.n_nodes}) int32")
    n_full = sfr.n_c[r]
    if words.dtype != torch.int32 or words.numel() % (n_full * p.n_words):
        raise ValueError(f"words must be round {r}'s full int32 stream of "
                         f"(chains x {n_full} x {p.n_words}) words")
    total = words.numel() // (n_full * p.n_words)
    if not 0 <= chain0 <= total - vals.shape[0]:
        raise ValueError(f"chains [{chain0}, {chain0 + vals.shape[0]}) lie "
                         f"outside the stream's {total}")
    if not (0 <= d < len(sfr.n_own) and 0 <= r < len(sfr.n_c)):
        raise ValueError(f"no position {d} / round {r} in the table")


def fused_color_round_ref(
    cbn: CompiledBayesNet, sfr, d: int, r: int, vals: torch.Tensor,
    words: torch.Tensor, chain0: int, sampler: str, p: SweepParams,
) -> torch.Tensor:
    """Plain torch twin of K5 over one position: `round_update` over
    position d's owned nodes of round r, with their rows gathered out of
    `words`, round r's stream from chain 0 (at least up to the block's
    chains), for the (b_loc, n) chain block `vals` whose first chain is
    chain `chain0` of the stream."""
    _check_color_round(cbn, sfr, d, r, vals, words, chain0, sampler, p)
    k = sfr.n_own[d][r]
    wr = words.reshape(-1, sfr.n_c[r], p.n_words)[chain0:chain0 + len(vals)]
    return round_update(
        vals, sfr.nodes[d, r, :k], sfr.cards[d, r, :k], sfr.base[d, r, :k],
        sfr.stride[d, r, :k], sfr.scope_var[d, r, :k],
        sfr.is_self[d, r, :k], wr[:, sfr.word_pos[d, r, :k].long()], cbn,
        sampler, p,
    )


def _check_keyed_round(cbn, sfr, r, vals, key, sampler):
    _check_vals(cbn, vals, sampler)
    if not isinstance(key, prng.Key):
        raise TypeError(f"K5 draws from a prng.Key, got {type(key)}")
    if not 0 <= r < len(sfr.n_c):
        raise ValueError(f"no round {r} in the table")


def _color_round(cbn, sfr, r, vals, key, sampler, p, *, chain_base,
                 n_chain_pos, d0, n_node_pos) -> torch.Tensor:
    """Launch K5 over node positions d0 .. d0 + n_node_pos - 1 and
    n_chain_pos equal chain blocks of `vals` (chain `chain_base` first).
    Returns the (n_node_pos, B, n) stack of the positions' new values."""
    tab = cbn.exp_table
    _lib.require_cuda(
        "fused_color_round", vals, cbn.log_flat, tab, sfr.nodes, sfr.cards,
        sfr.base, sfr.stride, sfr.scope_var, sfr.is_self, sfr.word_pos,
        sfr.n_own_t, sfr.n_c_t,
    )
    b, n = vals.shape
    spec = cbn.exp_spec
    # blocks from the launch's total (chain, node position) pairs, so the
    # grid fills the card as K3's does, however the mesh splits it
    cpc = chains_per_block(n_node_pos * b, n, spec.size)
    out = torch.empty((n_node_pos, b, n), dtype=torch.int32,
                      device=vals.device)
    P, I, U, L, F = _lib.PTR, _lib.INT, _lib.UINT, _lib.LONG, _lib.FLOAT
    fn = _lib.function(
        "bn_gibbs", "aia_bn_color_round",
        [P, P, L, I, I, I, I, I, I, I, I, P, P, I, I, I, P, P, P, P, P, P, P,
         U, U, I, P, P, I, F, F, I, I, I, I, I, P],
    )
    with torch.cuda.device(vals.device):
        code = fn(
            vals.data_ptr(), out.data_ptr(), chain_base, n_chain_pos,
            b // n_chain_pos, d0, n_node_pos, n, cpc, len(sfr.n_c), r,
            sfr.n_own_t.data_ptr(), sfr.n_c_t.data_ptr(), sfr.c_max,
            sfr.f_max, sfr.s_max, sfr.nodes.data_ptr(),
            sfr.cards.data_ptr(), sfr.base.data_ptr(),
            sfr.stride.data_ptr(), sfr.scope_var.data_ptr(),
            sfr.is_self.data_ptr(), sfr.word_pos.data_ptr(), key.k1, key.k2,
            p.n_words, cbn.log_flat.data_ptr(), tab.data_ptr(), spec.size,
            spec.x0, inv_dx(spec), p.v_max, int(sampler == "exact_ky"),
            p.weight_bits, p.precision, p.total_steps, _lib.stream_of(vals),
        )
    _lib.check("bn_gibbs", code, "fused_color_round")
    fused_color_round.launches += 1
    return out


def fused_color_round_mesh(
    cbn: CompiledBayesNet, sfr, r: int, vals: torch.Tensor, key: prng.Key,
    sampler: str, p: SweepParams, n_chain_pos: int,
) -> torch.Tensor:
    """Round r of the sweep `key` on every position of an (n_chain_pos x
    n_node_pos) mesh, n_node_pos the table's positions: one K5 launch for
    CUDA tensors; for CPU tensors the twin on `round_stream` per position.
    `vals` is the run's (B, n) values, chain block ci = chains [ci * b_loc,
    (ci + 1) * b_loc).  Every position reads the pre-round values.  Returns
    the (n_node_pos, B, n) stack whose plane d holds every chain's values
    after node position d's update (the owned nodes' new labels, the rest
    as they were): the input of `distributed._psum_merge`."""
    _check_keyed_round(cbn, sfr, r, vals, key, sampler)
    b = vals.shape[0]
    if n_chain_pos < 1 or b % n_chain_pos:
        raise ValueError(f"{b} chains do not split over {n_chain_pos} "
                         "chain positions")
    n_node_pos = len(sfr.n_own)
    if vals.device.type == "cpu":
        words = round_stream(sfr, key, r, 0, b, p.n_words, vals.device)
        b_loc = b // n_chain_pos
        return torch.stack([torch.cat([
            fused_color_round_ref(cbn, sfr, d, r, vals[c0:c0 + b_loc], words,
                                  c0, sampler, p)
            for c0 in range(0, b, b_loc)]) for d in range(n_node_pos)])
    return _color_round(cbn, sfr, r, vals, key, sampler, p, chain_base=0,
                        n_chain_pos=n_chain_pos, d0=0, n_node_pos=n_node_pos)


def fused_color_round(
    cbn: CompiledBayesNet, sfr, d: int, r: int, vals: torch.Tensor,
    key: prng.Key, chain0: int, sampler: str, p: SweepParams,
) -> torch.Tensor:
    """Round r of the sweep `key` over mesh position d's owned nodes of the
    `ShardedFusedRounds` table `sfr`: K5 over that one position for CUDA
    tensors, the twin on `round_stream` for CPU tensors.  `vals` is the
    position's (b_loc, n) chain block, whose first chain is chain `chain0`
    of the run.  Returns the block's new values; nodes the position does
    not own keep theirs."""
    _check_keyed_round(cbn, sfr, r, vals, key, sampler)
    if not 0 <= d < len(sfr.n_own):
        raise ValueError(f"no position {d} in the table")
    if chain0 < 0:
        raise ValueError(f"chain0 {chain0} < 0")
    if vals.device.type == "cpu":
        words = round_stream(sfr, key, r, chain0, len(vals), p.n_words,
                             vals.device)
        return fused_color_round_ref(cbn, sfr, d, r, vals, words, 0, sampler,
                                     p)
    return _color_round(cbn, sfr, r, vals, key, sampler, p,
                        chain_base=chain0, n_chain_pos=1, d0=d,
                        n_node_pos=1)[0]


fused_color_round.launches = 0
