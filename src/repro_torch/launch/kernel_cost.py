"""The work of the port's kernels and runs, counted from launch shapes.

The counterpart of the reference's `launch/hlo_cost.py` `analyze`, which
reads the work of a compiled XLA executable from its optimized HLO.  The
port has no HLO: every entry of its CUDA kernels (K1-K6) gets a function
of its launch shape returning a `KernelCost`, and `program_cost` /
`bucket_cost` total the launches a run or a serving dispatch makes.  The
profiler (`obs/profile.py`) turns a total into a roofline
(`launch/roofline.py`).

A roofline is a lower bound, so every count is the least the function
needs, never what one implementation happens to spend:

  * `hbm_bytes`: each input read once, each output written once (int32
    and float32 throughout, 4 bytes an element).
  * `hash_calls`: threefry calls, one per 32-bit random word.  A KY draw's
    walk reads at least one word (and on the served models one word is
    all it reads: 1,024 x 441 = 451,584 calls a pigs sweep, chip_smoke),
    a cdf draw one, a Gumbel draw one per bin; the chain init draws two
    per value (`prng.randint`).
  * `flops`: float32 operations.  K3 and K5: the factor sums (rows x F x
    V).  K4 and K6: ~16 per site and label (neighbour counts, energy, max,
    lerp) and one walk step per site (shift, mask, add and compare on
    V + 1 lanes plus the step's bookkeeping).  K1: one walk step per row.
    K2: 8 per element.
  * `collective_by_op`: the sharded route's mesh collectives, under the
    reference's HLO op names so that `obs.profile.HLO_OP_MECHANISM` and
    the profile table read them unchanged: the psum merge of a BN round
    (`core/distributed.py` `_psum_merge`) as "all-reduce", the halo
    exchange of an MRF half-step (`_halo_exchange`) as
    "collective-permute", each the bytes it reads and writes.

Count the work, not the implementation: the unfused twins run the same
sweep as K3 / K4, so a run's cost does not depend on `fused` (only the
fused path's first-use cross-check adds work, counted where the profiler
captures a dispatch or a whole-program run before it runs the check).  A
bucket's Q queries cost one lane-entry launch per sweep on the vmap
route, the tables read once for all of them, and Q runs over the mesh,
one after another, on the sharded route.  Not counted: the quality
accumulator of a `diagnostics` run, the pin select of a pinned MRF, and
the copies of the answers to the host.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import distributed
from repro_torch.core.interp import DEFAULT_SIZE

ITEM = 4  # bytes of an int32 / float32 element
K2_FLOPS = 8  # per element: scale, floor, clamp, gather x2, lerp
MRF_SITE_FLOPS = 16  # per site and label: counts, energy, max, lerp
WALK_LANE_OPS = 4  # per walk step and lane: shift, mask, add, compare
WALK_STEP_OPS = 8  # per walk step: its own bookkeeping
CHECK_CHAINS, CHECK_ITERS = 2, 3  # compile/backend.py's cross-check budget


@dataclasses.dataclass(frozen=True)
class KernelCost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    hash_calls: float = 0.0
    collective_by_op: dict = dataclasses.field(default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.collective_by_op.values()))

    def __add__(self, other: "KernelCost") -> "KernelCost":
        ops = dict(self.collective_by_op)
        for op, b in other.collective_by_op.items():
            ops[op] = ops.get(op, 0.0) + b
        return KernelCost(self.flops + other.flops,
                          self.hbm_bytes + other.hbm_bytes,
                          self.hash_calls + other.hash_calls, ops)

    def __mul__(self, n: float) -> "KernelCost":
        return KernelCost(self.flops * n, self.hbm_bytes * n,
                          self.hash_calls * n,
                          {op: b * n for op, b in
                           self.collective_by_op.items()})

    __rmul__ = __mul__


def total(costs) -> KernelCost:
    out = KernelCost()
    for c in costs:
        out = out + c
    return out


# ---------------------------------------------------------------------------
# Launch shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BNShape:
    """What a BN sweep's launches read: the chain values' width, the
    log-CPT arena and exp LUT, and the round tables padded to the
    (c_max, f_max, s_max) envelope of `kernels/bn_gibbs.build_fused_rounds`.
    `n_c` holds each round's free nodes."""

    n_nodes: int
    v_max: int
    arena: int
    lut: int
    n_c: tuple[int, ...]
    c_max: int
    f_max: int
    s_max: int

    @property
    def rows(self) -> int:
        """Nodes drawn per chain and sweep."""
        return sum(self.n_c)

    @property
    def table_bytes(self) -> int:
        """nodes, cards (R, C); base (R, C, F); stride, scope_var,
        is_self (R, C, F, S)."""
        r, c, f, s = len(self.n_c), self.c_max, self.f_max, self.s_max
        return ITEM * r * c * (2 + f + 3 * f * s)


def bn_shape(cbn, groups) -> BNShape:
    """The shape of `cbn` swept over the round groups `groups`."""
    return BNShape(
        n_nodes=int(cbn.n_nodes), v_max=int(cbn.max_card),
        arena=int(cbn.log_flat.numel()), lut=int(cbn.exp_table.numel()),
        n_c=tuple(int(g.nodes.shape[0]) for g in groups),
        c_max=max(int(g.nodes.shape[0]) for g in groups),
        f_max=max(int(g.base.shape[1]) for g in groups),
        s_max=max(int(g.stride.shape[2]) for g in groups),
    )


@dataclasses.dataclass(frozen=True)
class MRFShape:
    height: int
    width: int
    n_labels: int
    lut: int

    @property
    def sites(self) -> int:
        return self.height * self.width

    def active(self, parity: int) -> int:
        """Sites of the grid a half-step of `parity` draws: those with
        (row + col) % 2 == parity."""
        even = (-(-self.height // 2) * -(-self.width // 2)
                + (self.height // 2) * (self.width // 2))
        return even if parity == 0 else self.sites - even


def mrf_shape(mrf, lut: int) -> MRFShape:
    return MRFShape(int(mrf.height), int(mrf.width), int(mrf.n_labels),
                    int(lut))


def words_per_draw(sampler: str, n_bins: int) -> int:
    """The least random words one draw reads."""
    return n_bins if sampler == "gumbel" else 1


# ---------------------------------------------------------------------------
# Kernel entries (per launch)
# ---------------------------------------------------------------------------


def ky_sample(rows: int, bins: int, n_words: int) -> KernelCost:
    """K1, words read (`ky_sampler.ky_sample_kernel`): weights and words in,
    labels and three stats out."""
    return KernelCost(
        flops=rows * (WALK_LANE_OPS * (bins + 1) + WALK_STEP_OPS),
        hbm_bytes=ITEM * rows * (bins + n_words + 4),
    )


def ky_sample_keyed(rows: int, bins: int) -> KernelCost:
    """K1's keyed entry (`ky_sample_keyed`): the words hashed in the
    kernel, at least one per row."""
    return KernelCost(
        flops=rows * (WALK_LANE_OPS * (bins + 1) + WALK_STEP_OPS),
        hbm_bytes=ITEM * rows * (bins + 4), hash_calls=rows,
    )


def lut_exp(n: int, lut: int) -> KernelCost:
    """K2 (`interp_lut.interp_kernel`) over n floats."""
    return KernelCost(flops=K2_FLOPS * n, hbm_bytes=ITEM * (2 * n + lut))


def _bn_rounds(shape: BNShape, chains: int, rows: int,
               words: int) -> KernelCost:
    return KernelCost(flops=chains * rows * shape.f_max * shape.v_max,
                      hash_calls=chains * rows * words)


def bn_sweep(shape: BNShape, n_chains: int, words: int = 1) -> KernelCost:
    """K3 (`bn_gibbs.bn_sweep`): one sweep of every round; the values read
    and written once, the tables, arena and LUT read once."""
    vals = ITEM * n_chains * shape.n_nodes
    return _bn_rounds(shape, n_chains, shape.rows, words) + KernelCost(
        hbm_bytes=2 * vals + ITEM * (shape.arena + shape.lut)
        + shape.table_bytes)


def bn_sweep_lanes(shape: BNShape, n_queries: int, n_chains: int,
                   words: int = 1) -> KernelCost:
    """K3's lane entry (`bn_sweep_lanes`): one sweep of Q queries' chains
    in one launch, a (Q, 2) key array read beside the tables."""
    return (bn_sweep(shape, n_queries * n_chains, words)
            + KernelCost(hbm_bytes=2 * ITEM * n_queries))


def bn_color_round_mesh(shape: BNShape, r: int, n_chains: int,
                        n_node_pos: int, c_local: int,
                        words: int = 1) -> KernelCost:
    """K5 (`bn_gibbs.fused_color_round_mesh`): round r on every position of
    a mesh with `n_node_pos` node positions, `c_local` lanes each (the
    `ShardedFusedRounds` envelope); the values read once, each node
    position's plane written once, the round's slice of the position
    tables (nodes, cards, word_pos; base; stride, scope_var, is_self),
    the arena and LUT read once."""
    vals = ITEM * n_chains * shape.n_nodes
    f, s = shape.f_max, shape.s_max
    table = ITEM * n_node_pos * c_local * (3 + f + 3 * f * s)
    return _bn_rounds(shape, n_chains, shape.n_c[r], words) + KernelCost(
        hbm_bytes=(1 + n_node_pos) * vals + table
        + ITEM * (shape.arena + shape.lut))


def psum_merge(n_chains: int, n_nodes: int, n_node_pos: int) -> KernelCost:
    """`_psum_merge` of one BN round: the node positions' planes and the
    values read, the merged values written."""
    vals = ITEM * n_chains * n_nodes
    return KernelCost(collective_by_op={
        "all-reduce": float((n_node_pos + 2) * vals)})


def mrf_half_step(shape: MRFShape, n_chains: int, parity: int,
                  words: int = 1) -> KernelCost:
    """K4 (`mrf_gibbs.mrf_half_step`): the labels read and written once,
    the evidence and LUT read once."""
    v = shape.n_labels
    act = n_chains * shape.active(parity)
    return KernelCost(
        flops=act * (MRF_SITE_FLOPS * v + WALK_LANE_OPS * (v + 1)
                     + WALK_STEP_OPS),
        hbm_bytes=ITEM * (2 * n_chains * shape.sites + shape.sites
                          + shape.lut),
        hash_calls=act * words,
    )


def mrf_half_step_lanes(shape: MRFShape, n_queries: int, n_chains: int,
                        parity: int, words: int = 1) -> KernelCost:
    """K4's lane entry (`mrf_half_step_lanes`): Q queries' chains, an
    evidence plane and a key each."""
    one = mrf_half_step(shape, n_queries * n_chains, parity, words)
    return one + KernelCost(
        hbm_bytes=ITEM * ((n_queries - 1) * shape.sites + 2 * n_queries))


def mrf_halo_half_step(shape: MRFShape, n_chains: int, n_row_pos: int,
                       parity: int, words: int = 1) -> KernelCost:
    """K6 (`mrf_gibbs.mrf_halo_half_step`): every row slab of a mesh with
    `n_row_pos` row positions in one launch; K4's bytes plus the
    exchanged halo rows (two (n_row_pos, B, W) planes) read once."""
    return mrf_half_step(shape, n_chains, parity, words) + KernelCost(
        hbm_bytes=ITEM * 2 * n_row_pos * n_chains * shape.width)


def halo_exchange(shape: MRFShape, n_chains: int,
                  n_row_pos: int) -> KernelCost:
    """`_halo_exchange` of one half-step: the slabs' border rows read, the
    two halo planes written."""
    row = ITEM * n_chains * shape.width
    moved = 2 * n_row_pos * row + 2 * (n_row_pos - 1) * row
    return KernelCost(collective_by_op={"collective-permute": float(moved)})


def chain_init(n_values: int) -> KernelCost:
    """A uniform chain init (`prng.randint`): two words per value, the
    values written."""
    return KernelCost(hbm_bytes=ITEM * n_values, hash_calls=2 * n_values)


def histogram(n_chains: int, n_nodes: int, v_max: int) -> KernelCost:
    """One kept sweep's (n, V) marginal histogram: the values read, the
    histogram read and written."""
    return KernelCost(hbm_bytes=ITEM * (n_chains * n_nodes
                                        + 2 * n_nodes * v_max))


# ---------------------------------------------------------------------------
# Runs and dispatches
# ---------------------------------------------------------------------------


def kept_sweeps(n_iters: int, burn_in: int, thin: int) -> int:
    """Sweeps a run of n_iters from sweep 0 keeps (`diag.accum.kept_count`;
    a resumed slice keeps at least as many)."""
    return max((n_iters - burn_in + thin - 1) // thin, 0)


def _bn_groups(program, clamp_nodes, backend):
    if clamp_nodes:
        return program.clamped_executable(tuple(clamp_nodes), backend)
    if backend == "schedule":
        return program.schedule_executable().round_groups
    return program.cbn.groups


def _parities(program, backend):
    if backend == "schedule":
        return program.schedule_executable().parities
    return (0, 1)


def program_cost(
    program, *, n_chains: int, n_iters: int, burn_in: int = 50,
    thin: int = 1, sampler: str = "lut_ky", backend: str = "schedule",
    clamp_nodes=(), n_queries: int = 1, resumed: bool = False, mesh=None,
    cross_check: bool = False, sharded_check: bool = False,
) -> KernelCost:
    """The work of `n_queries` runs of `program` at one budget: the chain
    inits (unless `resumed`), every sweep's rounds (BN: one sweep launch,
    or one K5 launch and psum merge per round on a mesh; MRF: one
    half-step launch per parity, with a halo exchange on a mesh), the
    histogram of every kept BN sweep, and, with `cross_check`, the fused
    path's first-use cross-check (an eager and a fused run at
    compile/backend.py's tiny budget, and with `sharded_check` its sharded
    leg).  `mesh` = (chain positions, node or row positions) runs the
    sharded route, whose queries run one after another.  Raises for a
    program kind it does not know."""
    q = int(n_queries)
    if program.kind == "bn":
        groups = _bn_groups(program, clamp_nodes, backend)
        shape = bn_shape(program.cbn, groups)
        words = words_per_draw(sampler, shape.v_max)
        if mesh is None:
            sweep = (bn_sweep(shape, n_chains, words) if q == 1 else
                     bn_sweep_lanes(shape, q, n_chains, words))
        else:
            n_pos = int(mesh[1])
            c_loc = distributed.local_lanes(groups, n_pos,
                                            program.placement)
            sweep = q * total(
                bn_color_round_mesh(shape, r, n_chains, n_pos, c_loc, words)
                + psum_merge(n_chains, shape.n_nodes, n_pos)
                for r in range(len(shape.n_c)))
        hist = histogram(n_chains, shape.n_nodes, shape.v_max)
        cost = (n_iters * sweep
                + q * kept_sweeps(n_iters, burn_in, thin) * hist)
        n_values = n_chains * shape.n_nodes
    elif program.kind == "mrf":
        shape = mrf_shape(program.mrf, DEFAULT_SIZE)
        parities = _parities(program, backend)
        words = words_per_draw(sampler, shape.n_labels)
        if mesh is None:
            it = total(mrf_half_step(shape, n_chains, p, words) if q == 1
                       else mrf_half_step_lanes(shape, q, n_chains, p, words)
                       for p in parities)
        else:
            n_pos = int(mesh[1])
            it = q * total(mrf_halo_half_step(shape, n_chains, n_pos, p,
                                              words)
                           + halo_exchange(shape, n_chains, n_pos)
                           for p in parities)
        cost = n_iters * it
        n_values = n_chains * shape.sites
    else:
        raise ValueError(f"no cost model for program kind {program.kind!r}")
    if not resumed:
        cost = cost + q * chain_init(n_values)
    if cross_check:
        check = dict(n_chains=CHECK_CHAINS, n_iters=CHECK_ITERS, burn_in=0,
                     sampler=sampler)
        cost = cost + 2 * program_cost(program, **check)
        if sharded_check:
            w = 1 if program.kind == "mrf" and program.mrf.height % 2 else 2
            cost = cost + program_cost(program, mesh=(1, w), **check)
    return cost


def bucket_cost(program, key, n_lanes: int, route: str = "vmap", *,
                shard_width: int = 1, cross_check: bool = False
                ) -> KernelCost:
    """The work of one serving dispatch of `key` (a `runtime.BucketKey`)
    over `n_lanes` queries on `route`: "vmap" (one lane loop, or the
    queries one by one when unfused, the same work) or "sharded" (each
    query over a (1, shard_width) mesh)."""
    if route not in ("vmap", "sharded"):
        raise ValueError(f"unknown route {route!r}")
    return program_cost(
        program, n_chains=key.n_chains, n_iters=key.n_iters,
        burn_in=key.burn_in, thin=key.thin, sampler=key.sampler,
        backend=key.backend, clamp_nodes=key.clamp_nodes, n_queries=n_lanes,
        resumed=key.resumed,
        mesh=(1, shard_width) if route == "sharded" else None,
        cross_check=cross_check and key.fused,
        sharded_check=route == "sharded",
    )
