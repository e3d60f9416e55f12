# Copied from the reference package, src/repro/compile/schedule.py: numpy only,
# kept in step with it so both packages compile a model identically.
"""Round schedules — the compile chain's explicit execution plan (Alg. 2).

A `Schedule` lowers (colors, placement) into what the hardware actually
runs: one `Round` per color, each updating a conditionally-independent node
set in parallel across the core mesh, followed by the communication that
makes the new values visible before the next round.  The comm ops name the
paper's two data-movement mechanisms and their TPU analogues:

  * ``ppermute_halo``  — neighbor-RF read (C4): an MRF site reads labels
    from mesh-adjacent cores; on TPU a `lax.ppermute` boundary exchange.
  * ``psum_broadcast`` — shared-RF value broadcast: a BN node's new value
    is pushed to every core holding a Markov-blanket neighbor; on TPU the
    per-color `lax.psum` of the (disjoint) state-vector delta.

The cycle/byte cost model is deliberately simple — a line-graph model in the
spirit of Fig. 9, not a simulator: per round, compute is the update count of
the round's most-loaded core under the actual placement (the round barriers
on the slowest core), and communication pays a per-hop latency plus a
serialization term.  Its purpose is *relative* comparison (greedy vs random
placement, schedule A vs B), which is exactly what bench_compile reports.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.compile.ir import SamplingGraph
from repro_torch.core.mapping import MeshPlacement, _manhattan

# Line-graph cost-model constants (relative units, one "cycle" = one core
# update slot).  HOP_CYCLES is the per-link latency of the mesh NoC; a
# 4-byte value serializes in one cycle on AIA's 32-bit links.
UPDATE_CYCLES = 1
HOP_CYCLES = 2
BYTES_PER_LINK_CYCLE = 4
VALUE_BYTES = 4  # one int32 RV value


@dataclasses.dataclass(frozen=True)
class CommOp:
    """Aggregated traffic from one core to another after a round."""

    mechanism: str  # "ppermute_halo" | "psum_broadcast"
    src_core: int
    dst_core: int
    n_bytes: int
    hops: int  # Manhattan distance on the core mesh

    @property
    def cycles(self) -> int:
        return HOP_CYCLES * self.hops + -(-self.n_bytes // BYTES_PER_LINK_CYCLE)


@dataclasses.dataclass(frozen=True)
class Round:
    """One color's parallel update step + the exchanges it triggers."""

    color: int
    nodes: tuple[int, ...]
    comm: tuple[CommOp, ...]
    # nodes-per-core under the *actual* placement (index = core id).  The
    # round barriers on its most-loaded core, so this — not the balanced
    # share ceil(n/n_cores) — is what compute costs.  Empty tuple = no
    # placement known (legacy), fall back to the balanced share.
    core_load: tuple[int, ...] = ()

    def compute_cycles(self, n_cores: int) -> int:
        if self.core_load:
            return UPDATE_CYCLES * max(self.core_load)
        return UPDATE_CYCLES * -(-len(self.nodes) // n_cores)

    def comm_cycles(self) -> int:
        # mesh links are independent: rounds pay the slowest single op,
        # not the sum (the event unit barriers on the last arrival)
        return max((op.cycles for op in self.comm), default=0)


@dataclasses.dataclass(frozen=True)
class Schedule:
    rounds: tuple[Round, ...]
    mesh_shape: tuple[int, int]

    @property
    def n_cores(self) -> int:
        return self.mesh_shape[0] * self.mesh_shape[1]

    def cost(self) -> dict:
        """Cycle/byte model of one full sweep (all rounds)."""
        compute = sum(r.compute_cycles(self.n_cores) for r in self.rounds)
        comm = sum(r.comm_cycles() for r in self.rounds)
        return {
            "n_rounds": len(self.rounds),
            "compute_cycles": compute,
            "comm_cycles": comm,
            "total_cycles": compute + comm,
            "total_bytes": sum(
                op.n_bytes for r in self.rounds for op in r.comm
            ),
            "total_hop_bytes": sum(
                op.n_bytes * op.hops for r in self.rounds for op in r.comm
            ),
            "n_comm_ops": sum(len(r.comm) for r in self.rounds),
        }


def build_schedule(
    ir: SamplingGraph,
    colors: np.ndarray,
    placement: MeshPlacement,
    adj: list[set[int]] | None = None,
) -> Schedule:
    """Lower (colors, placement) to per-color rounds with explicit comm.

    After round r updates node u, every conflict neighbor v of a *different*
    color reads u's new value in a later round; if v lives on another core
    that read is a message.  Messages are aggregated per (src, dst) core
    pair — that is what a halo exchange / delta broadcast physically ships.
    `adj` lets the caller reuse an already-materialized adjacency.
    """
    mechanism = "ppermute_halo" if ir.kind == "mrf" else "psum_broadcast"
    cols = placement.mesh_shape[1]
    n_cores = placement.mesh_shape[0] * placement.mesh_shape[1]
    if adj is None:
        adj = ir.adjacency()
    evid = {node for node, _ in ir.evidence}
    rounds = []
    for c in range(int(colors.max()) + 1 if len(colors) else 0):
        nodes = tuple(
            int(v) for v in np.where(colors == c)[0] if int(v) not in evid
        )
        if not nodes:
            continue  # all-evidence color: nothing to update or ship
        traffic: dict[tuple[int, int], int] = {}
        for u in nodes:
            cu = int(placement.placement[u])
            dst_cores = {
                int(placement.placement[v])
                for v in adj[u]
                if colors[v] != c and v not in evid
            }
            for cv in dst_cores - {cu}:
                traffic[(cu, cv)] = traffic.get((cu, cv), 0) + VALUE_BYTES
        comm = tuple(
            CommOp(
                mechanism=mechanism,
                src_core=src,
                dst_core=dst,
                n_bytes=nb,
                hops=_manhattan(src, dst, cols),
            )
            for (src, dst), nb in sorted(traffic.items())
        )
        core_load = np.bincount(
            placement.placement[list(nodes)], minlength=n_cores
        )
        rounds.append(Round(
            color=c, nodes=nodes, comm=comm,
            core_load=tuple(int(x) for x in core_load),
        ))
    return Schedule(rounds=tuple(rounds), mesh_shape=placement.mesh_shape)


def verify_schedule(
    ir: SamplingGraph,
    schedule: Schedule,
    adj: list[set[int]] | None = None,
) -> None:
    """Legality: rounds partition the free RVs, and no round contains two
    adjacent RVs (the conditional-independence precondition of Alg. 2).

    Delegates to the static verifier's legality rules and raises a
    structured `repro.analysis.ScheduleVerificationError` (an
    `AssertionError` subclass, but *raised*, so it survives `python -O`).
    The full rule set — comm completeness, placement legality, cost-model
    sanity — runs in the pipeline's `VerifyPass` and in
    `analysis.verify_program`, which also see the placement and
    diagnostics this signature does not carry."""
    from repro_torch.analysis import verify as verify_mod  # analysis imports us

    verify_mod.raise_on_errors(
        verify_mod.verify_schedule_static(ir, schedule, adj=adj)
    )
