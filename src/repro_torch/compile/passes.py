# Copied from the reference package, src/repro/compile/passes.py: numpy only,
# kept in step with it so both packages compile a model identically.
"""Pass pipeline: `moralize -> dsatur -> greedy_map -> schedule -> verify`.

Each pass is a named, timed transformation over a `PassContext`; the context
accumulates the artifacts (conflict graph, colors, placement, schedule) and
a diagnostics dict that benchmarks and `launch/report.py` render directly.
The passes wrap the existing `core/coloring.py` and `core/mapping.py`
heuristics — the pipeline is the compiler spine those modules were missing,
not a reimplementation of them.

Custom pipelines are first-class: `run_pipeline(ir, passes=[...])` lets a
benchmark swap `GreedyMapPass` for `RandomMapPass` (the Fig. 9 baseline) or
a future pass without touching `run_pipeline`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.analysis import verify as verify_mod
from repro_torch.compile import schedule as schedule_mod
from repro_torch.compile.ir import SamplingGraph
from repro_torch.core import coloring as coloring_mod
from repro_torch.core import mapping as mapping_mod
from repro_torch.obs import tracer


@dataclasses.dataclass
class PassContext:
    """Mutable state threaded through the pipeline."""

    ir: SamplingGraph
    mesh_shape: tuple[int, int] = (4, 4)
    adj: list[set[int]] | None = None
    colors: np.ndarray | None = None
    placement: mapping_mod.MeshPlacement | None = None
    schedule: schedule_mod.Schedule | None = None
    diagnostics: dict = dataclasses.field(default_factory=dict)
    pass_times_s: dict = dataclasses.field(default_factory=dict)

    def require(self, *fields: str) -> None:
        for f in fields:
            if getattr(self, f) is None:
                raise RuntimeError(
                    f"pass ordering error: '{f}' not produced yet"
                )


class Pass:
    """A named pipeline stage; subclasses mutate the context in `run`."""

    name = "pass"

    def run(self, ctx: PassContext) -> None:
        raise NotImplementedError

    def __call__(self, ctx: PassContext) -> None:
        with tracer.span(
            f"pass:{self.name}", cat="compile",
            ir=ctx.ir.ir_key, n_nodes=ctx.ir.n_nodes,
            mesh_shape=list(ctx.mesh_shape),
        ):
            t0 = time.perf_counter()
            self.run(ctx)
            ctx.pass_times_s[self.name] = time.perf_counter() - t0


class MoralizePass(Pass):
    """Materialize the conflict graph.  The IR already canonicalized the
    moral / grid adjacency into edges; this pass expands it to the adjacency
    sets every later pass consumes, and records graph-shape diagnostics."""

    name = "moralize"

    def run(self, ctx: PassContext) -> None:
        ctx.adj = ctx.ir.adjacency()
        degrees = np.array([len(a) for a in ctx.adj] or [0])
        ctx.diagnostics.update(
            n_nodes=ctx.ir.n_nodes,
            n_edges=ctx.ir.n_edges,
            max_degree=int(degrees.max()),
        )


class DsaturPass(Pass):
    """RV-parallelism detection (paper C3): DSATUR coloring + verification."""

    name = "dsatur"

    def run(self, ctx: PassContext) -> None:
        ctx.require("adj")
        ctx.colors = coloring_mod.dsatur(ctx.adj)
        verify_mod.require_proper_coloring(
            ctx.adj, ctx.colors, loc=f"{ctx.ir.name}:dsatur"
        )
        stats = coloring_mod.color_stats(ctx.colors)
        ctx.diagnostics.update(
            n_colors=stats["n_colors"],
            color_balance=stats["balance"],
        )


class MergeSmallColorsPass(Pass):
    """Fuse tiny independent color classes into one round (serving-path
    optimization: every round is a kernel launch plus a barrier, so a tail
    of near-singleton colors makes the microbatched runtime pay launch
    overhead per round per query batch).

    A class with at most `max_size` nodes is folded into the first other
    class it shares no conflict edge with (smallest candidate first, color
    id as the tie-break, so the result is deterministic).  Merging two
    independent classes preserves proper coloring by definition; the pass
    re-verifies anyway, and `backend.lower_schedule` re-checks legality a
    second time before the merged rounds ever execute.

    On raw DSATUR output this is provably the identity: greedy coloring
    gives every node of class d a neighbor in every class below d (else it
    would have taken the smaller color), so no two classes are ever
    independent.  Its value is as the *normalizer* in the serving pipeline —
    any pass or imported coloring that splinters rounds (round splitters,
    per-component colorings, hand-written schedules) gets its fragments
    re-fused before the runtime pays per-round launch overhead for them."""

    name = "merge_small_colors"

    def __init__(self, max_size: int = 4):
        self.max_size = max_size

    def run(self, ctx: PassContext) -> None:
        ctx.require("adj", "colors")
        colors = np.asarray(ctx.colors).copy()
        n_before = int(colors.max()) + 1 if len(colors) else 0
        members = {
            c: set(np.where(colors == c)[0].tolist())
            for c in range(n_before)
        }
        # neighbor color sets make the independence test O(classes)
        adj_colors = {
            c: {int(colors[u]) for v in nodes for u in ctx.adj[v]}
            for c, nodes in members.items()
        }
        by_size = sorted(members, key=lambda c: (len(members[c]), c))
        for c in by_size:
            if len(members[c]) == 0 or len(members[c]) > self.max_size:
                continue
            for d in sorted(members, key=lambda d: (len(members[d]), d)):
                if d == c or not members[d] or c in adj_colors[d]:
                    continue
                members[d] |= members[c]
                adj_colors[d] |= adj_colors[c]
                for e in members:  # c's conflicts are now d's
                    if c in adj_colors[e]:
                        adj_colors[e].add(d)
                members[c] = set()
                break
        relabel = {}
        for c in range(n_before):
            for v in sorted(members.get(c, ())):
                colors[v] = relabel.setdefault(c, len(relabel))
        verify_mod.require_proper_coloring(
            ctx.adj, colors, loc=f"{ctx.ir.name}:merge_small_colors"
        )
        ctx.colors = colors
        stats = coloring_mod.color_stats(colors)
        ctx.diagnostics.update(
            n_colors=stats["n_colors"],
            color_balance=stats["balance"],
            rounds_merged=n_before - stats["n_colors"],
        )


class GreedyMapPass(Pass):
    """Spatial placement (Sec. IV-B): communication-distance-minimizing
    greedy mapping onto the core mesh."""

    name = "greedy_map"

    def run(self, ctx: PassContext) -> None:
        ctx.require("adj", "colors")
        ctx.placement = mapping_mod.greedy_map(
            ctx.adj, ctx.colors, ctx.mesh_shape
        )
        ctx.diagnostics["comm_hops"] = mapping_mod.comm_cost(
            ctx.adj, ctx.placement
        )


class RandomMapPass(Pass):
    """Baseline placement (the Fig. 9 'random' column) — drop-in for
    GreedyMapPass so benchmarks compare schedules, not code paths."""

    name = "random_map"

    def __init__(self, seed: int = 0):
        self.seed = seed

    def run(self, ctx: PassContext) -> None:
        ctx.require("adj", "colors")
        ctx.placement = mapping_mod.random_map(
            ctx.ir.n_nodes, ctx.mesh_shape, self.seed
        )
        ctx.diagnostics["comm_hops"] = mapping_mod.comm_cost(
            ctx.adj, ctx.placement
        )


class SchedulePass(Pass):
    """Lower (colors, placement) to the explicit per-color round schedule
    and record its cycle/byte cost model."""

    name = "schedule"

    def run(self, ctx: PassContext) -> None:
        ctx.require("adj", "colors", "placement")
        ctx.schedule = schedule_mod.build_schedule(
            ctx.ir, ctx.colors, ctx.placement, adj=ctx.adj
        )
        ctx.diagnostics["schedule_cost"] = ctx.schedule.cost()
        # placement quality at a glance: the worst per-core node count of
        # any round (what compute_cycles charges) vs the balanced ideal
        ctx.diagnostics["critical_core_load"] = max(
            (max(r.core_load) for r in ctx.schedule.rounds), default=0
        )
        ctx.diagnostics["balanced_core_load"] = max(
            (
                -(-len(r.nodes) // ctx.schedule.n_cores)
                for r in ctx.schedule.rounds
            ),
            default=0,
        )


class VerifyPass(Pass):
    """Static verification of the lowered artifact (`repro.analysis`): the
    parallel-Gibbs race check, comm completeness against an independently
    recomputed traffic matrix, placement/core_load legality, clamp/pin
    consistency, and cost-model reconciliation.  Runs by default as the
    last stage of every named pipeline; raises a structured
    `ScheduleVerificationError` on any error-severity finding (an
    explicit raise — it survives `python -O`, unlike the asserts it
    replaced).  Warning-severity findings (load imbalance, spurious comm)
    land in `diagnostics["verify"]` instead of failing the compile."""

    name = "verify"

    def run(self, ctx: PassContext) -> None:
        ctx.require("adj", "colors", "placement", "schedule")
        findings = verify_mod.verify_schedule_static(
            ctx.ir, ctx.schedule,
            placement=ctx.placement, diagnostics=ctx.diagnostics,
            adj=ctx.adj, model=ctx.ir.name,
        )
        verify_mod.raise_on_errors(findings)
        ctx.diagnostics["verify"] = {
            "n_rules": len(verify_mod.VERIFY_RULES),
            "n_findings": len(findings),
            "warnings": [f.render() for f in findings],
        }


def default_pipeline() -> list[Pass]:
    return [
        MoralizePass(), DsaturPass(), GreedyMapPass(), SchedulePass(),
        VerifyPass(),
    ]


def runtime_pipeline() -> list[Pass]:
    """The serving-path lowering (`repro.runtime`): the default pipeline
    plus small-color merging, so no coloring source can splinter rounds
    and charge the microbatched runtime per-round launch overhead (on
    DSATUR's own output the merge is an identity — see the pass docstring).
    Kept out of the default pipeline so standalone `compile_bayesnet`
    stays bit-comparable with default-compiled programs."""
    return [
        MoralizePass(), DsaturPass(), MergeSmallColorsPass(),
        GreedyMapPass(), SchedulePass(), VerifyPass(),
    ]


def random_baseline_pipeline(seed: int = 0) -> list[Pass]:
    """The Fig. 9 baseline: the default lowering with the greedy placement
    swapped for a seeded random one.  Kept here so benchmarks/tests compare
    against the real pipeline even as passes are added."""
    return [
        MoralizePass(), DsaturPass(), RandomMapPass(seed), SchedulePass(),
        VerifyPass(),
    ]


# Named pipelines are the cacheable ones: `compile_graph(pipeline=...)` keys
# the program cache by this name, so every registered lowering of a model
# gets its own slot (ad-hoc `passes=[...]` lists still bypass the cache).
_PIPELINES: dict[str, Callable[[], list[Pass]]] = {
    "default": default_pipeline,
    "runtime": runtime_pipeline,
}


def named_pipeline(name: str) -> list[Pass]:
    if name not in _PIPELINES:
        raise ValueError(
            f"unknown pipeline {name!r}; registered: {sorted(_PIPELINES)}"
        )
    return _PIPELINES[name]()


def run_pipeline(
    ir: SamplingGraph,
    mesh_shape: tuple[int, int] = (4, 4),
    passes: Sequence[Pass] | None = None,
) -> PassContext:
    """Run the (default or custom) pass list over a fresh context."""
    ctx = PassContext(ir=ir, mesh_shape=mesh_shape)
    for p in passes if passes is not None else default_pipeline():
        p(ctx)
    return ctx
