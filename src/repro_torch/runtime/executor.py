"""The multi-worker executor: sharded dispatch over a simulated worker pool
(port of `repro/runtime/executor.py`).

This is the host-RISC-V half of the AIA posture the runtime had been
missing: the chip paper's host core exists to *distribute* sampling work
across the mesh (and, in the companion multi-chip work, across chips),
where a single serial executor would dispatch every microbatch in turn.
Here the engine hands every flushed bucket to a `WorkerPool` of W simulated workers:

  * each worker is a device (or, for wide dispatches, one lane of a mesh
    slice) with a **busy-until clock**; a dispatch starts at
    `max(flush time, worker free time)` and occupies the worker for its
    predicted service time, so the deterministic event loop overlaps
    service across workers while the host-side real execution stays
    single-threaded and replayable;
  * **large MRF buckets route to `run_sharded`** across a mesh slice of
    `shard_width` workers (the multi-chip analogue: compute cycles split
    over the slice, comm cycles do not), occupying every worker in the
    slice; small buckets take the one-device "vmap" route (the lane-
    batched loops of `batcher`) exactly as before.  The port's mesh is
    single-controller, every position on the engine's device, so a
    (1, shard_width) mesh always exists and the sharded route always
    executes through `core.distributed.run_program_sharded`: the
    reference's fallback to the vmap executable when a host has too few
    devices has no counterpart.  Route choice stays config-deterministic.
    A **fused** sharded bucket runs K6 (one launch per half-step over every
    row slab) with the halo exchanges between, bit-exact with the vmap
    fused route, so slicing (chain-state carry) and the diagnostics
    accumulator ride the sharded route first-class — the `BucketKey` a
    dispatch executes under is the bucket's.

Service times come from the engine's `Calibrator` (measured when warm, the
line model cold); the wall time of every real dispatch is recorded next to
the prediction so the dashboards can report calibration error without the
simulated clock ever reading a wall clock.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import distributed as dist_mod
from repro_torch.diag import accum as diag_accum
from repro_torch.obs import tracer
from repro_torch.runtime import batcher as batcher_mod
from repro_torch.runtime import calibrate as calibrate_mod
from repro_torch.runtime.batcher import BucketKey, Query, QueryResult
from repro_torch.runtime.metrics import BatchRecord


@dataclasses.dataclass(frozen=True)
class ExecutorConfig:
    """Worker-pool shape.  The defaults (one worker, sharded route off)
    reproduce the single-serial-executor engine exactly."""

    n_workers: int = 1
    shard_width: int = 1  # mesh-slice width for sharded MRF dispatches
    shard_min_sites: int | None = None  # route grids >= this; None = never

    def __post_init__(self):
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {self.n_workers}")
        if self.shard_width < 1:
            raise ValueError(
                f"shard_width must be >= 1, got {self.shard_width}"
            )
        if self.shard_min_sites is not None and (
            self.shard_width < 2 or self.shard_width > self.n_workers
        ):
            raise ValueError(
                "the sharded route needs 2 <= shard_width <= n_workers "
                f"(got shard_width={self.shard_width}, "
                f"n_workers={self.n_workers})"
            )


class WorkerPool:
    """W busy-until clocks + per-worker busy-time accounting."""

    def __init__(self, n_workers: int):
        self.busy_until = [0.0] * n_workers
        self.busy_s = [0.0] * n_workers
        # idle-while-work-waited: the part of each worker's idle gap during
        # which its next batch's oldest query had already arrived (idle
        # blocked on the flush window / batching, not on arrivals)
        self.stall_s = [0.0] * n_workers

    @property
    def n_workers(self) -> int:
        return len(self.busy_until)

    def earliest_free(self) -> float:
        """When the next worker frees up.  The engine gates flushes on this:
        a bucket keeps accumulating queries while every worker is busy
        (adaptive batching — the batch grows exactly while it cannot run
        anyway), which with one worker reproduces the serial engine's
        flush cadence."""
        return min(self.busy_until)

    def assign(self, clock: float, width: int = 1) -> tuple[tuple[int, ...],
                                                            float]:
        """Pick the slice of `width` contiguous, slice-aligned workers that
        can start earliest (ties to the lowest index — fully deterministic).
        Returns (worker ids, start time)."""
        n = self.n_workers
        assert 1 <= width <= n
        best = None
        for w0 in range(0, n - width + 1, width):
            workers = tuple(range(w0, w0 + width))
            free = max(self.busy_until[w] for w in workers)
            if best is None or free < best[1]:
                best = (workers, free)
        workers, free = best
        return workers, max(clock, free)

    def commit(self, workers: tuple[int, ...], start: float, finish: float,
               ready_t: float = float("inf")) -> None:
        """Book a dispatch.  `ready_t` is when this batch's oldest query
        arrived: any idle between `max(free, ready_t)` and `start` is time
        the worker sat free *while this work waited* — stall charged to the
        flush window, not to the arrival process."""
        for w in workers:
            self.stall_s[w] += max(
                0.0, start - max(self.busy_until[w], ready_t)
            )
            self.busy_until[w] = finish
            self.busy_s[w] += finish - start


class Executor:
    """Routes flushed buckets onto the pool and runs them for real.

    One instance per engine run (the pool clocks are run-scoped).  The
    `calibrator` is shared across runs — that is the point of it."""

    def __init__(
        self,
        config: ExecutorConfig,
        calibrator: calibrate_mod.Calibrator,
        pad_sizes,
    ):
        self.config = config
        self.calibrator = calibrator
        self.pad_sizes = tuple(pad_sizes)
        self.pool = WorkerPool(config.n_workers)
        self._mesh: dist_mod.Mesh | None = None
        self._rounds_emitted: set[str] = set()  # programs with round_cost out

    # -- routing ------------------------------------------------------------

    def route(self, program, key: BucketKey) -> str:
        """"sharded" | "vmap", from config + bucket statics alone (never
        from device availability — the simulated clock must not depend on
        the machine it replays on)."""
        cfg = self.config
        if (
            cfg.shard_min_sites is not None
            and key.kind == "mrf"
            and not key.has_pins
            # a resumed bucket stays sharded only when fused — the fused
            # sharded engine carries chain state bit-exactly; the legacy
            # sharded engines fold keys per device and carry nothing
            and (key.fused or not key.resumed)
            and program.mrf.height * program.mrf.width >= cfg.shard_min_sites
            and program.mrf.height % cfg.shard_width == 0
        ):
            return "sharded"
        return "vmap"

    def _shard_mesh(self, device) -> dist_mod.Mesh:
        """The (1, shard_width) ("data", "model") mesh on the engine's
        device (every program of an engine lives there), built once."""
        if self._mesh is None:
            self._mesh = dist_mod.make_mesh(
                (1, self.config.shard_width), ("data", "model"), device
            )
        return self._mesh

    # -- dispatch -----------------------------------------------------------

    def batch_route(self, program, key: BucketKey, qs: list[Query]) -> str:
        """The route this specific batch takes: the bucket's static route,
        demoted to vmap when any query continues past this slice on a
        *non-fused* sharded bucket — the legacy sharded engines cannot
        return chain state and a continuation must never silently restart.
        Fused sharded buckets carry state bit-exactly, so they keep the
        route through every slice."""
        route = self.route(program, key)
        if (route == "sharded" and not key.fused
                and any(q.n_iters > key.n_iters for q in qs)):
            route = "vmap"
        return route

    def execute(
        self,
        program,
        key: BucketKey,
        qs: list[Query],
        route: str,
        return_state: bool = False,
    ) -> list[QueryResult]:
        """Real execution only (no pool booking): the path `dispatch` runs
        and `Engine.calibrate`'s timed warmup re-runs, so warmup measures
        exactly what serving will pay — sharded route included."""
        if route == "sharded":
            return self._run_sharded(program, key, qs, return_state)
        return batcher_mod.execute_bucket(
            program, key, qs, self.pad_sizes, return_state=return_state
        )

    def dispatch(
        self,
        program,
        key: BucketKey,
        qs: list[Query],
        clock: float,
        return_state: bool = False,
    ) -> tuple[list[QueryResult], BatchRecord]:
        """Execute one microbatch and place it on the pool's timeline.

        Real execution happens now (host order = flush order, replayable);
        the simulated start/finish come from the chosen workers' busy-until
        clocks and the calibrated service prediction."""
        cfg = self.config
        route = self.batch_route(program, key, qs)
        width = cfg.shard_width if route == "sharded" else 1
        lower0 = program.clamp_lowerings
        # measured_s feeds the calibrator; it is real time by design
        wall0 = time.perf_counter()  # lint: allow[wallclock-in-sim]
        batch = self.execute(program, key, qs, route, return_state)
        measured_s = time.perf_counter() - wall0  # lint: allow[wallclock-in-sim]
        n_padded = batcher_mod.pad_size(len(qs), self.pad_sizes)
        service_s, service_src = self.calibrator.predict(
            program, calibrate_mod.sig_of(key, route), n_padded,
            shard_width=width,
        )
        ready_t = min(q.arrival_s for q in qs)
        workers, start = self.pool.assign(clock, width)
        finish = start + service_s
        self.pool.commit(workers, start, finish, ready_t=ready_t)
        for r in batch:
            r.start_s = start
            r.finish_s = finish
        if tracer.enabled():
            self._trace_dispatch(
                program, key, qs, route, workers, start, finish,
                n_padded=n_padded, service_s=service_s,
                service_src=service_src, measured_s=measured_s,
            )
        rec = BatchRecord(
            model=qs[0].model, kind=key.kind, n_real=len(qs),
            n_padded=n_padded, service_s=service_s,
            clamp_lowerings=program.clamp_lowerings - lower0,
            worker=workers[0], n_workers=len(workers), route=route,
            start_s=start, finish_s=finish, measured_s=measured_s,
            service_src=service_src,
        )
        return batch, rec

    # -- tracing ------------------------------------------------------------

    def _emit_round_costs(self, program) -> None:
        """Once per program: one `round_cost` instant per schedule round —
        the static cost model attribution joins dispatches against.
        Emitted here (not at compile time) so cache-hit programs still get
        coverage in every traced run."""
        pkey = program.program_key
        if pkey in self._rounds_emitted:
            return
        self._rounds_emitted.add(pkey)
        sched = program.schedule
        n_cores = (
            program.placement.mesh_shape[0] * program.placement.mesh_shape[1]
        )
        for idx, r in enumerate(sched.rounds):
            mech = r.comm[0].mechanism if r.comm else None
            tracer.instant(
                "round_cost", cat="cost",
                program=pkey, round=idx, color=int(r.color),
                n_nodes=len(r.nodes),
                compute_cycles=int(r.compute_cycles(n_cores)),
                comm_cycles=int(r.comm_cycles()),
                mechanism=mech,
                n_comm_ops=len(r.comm),
                comm_bytes=int(sum(op.n_bytes for op in r.comm)),
            )

    def _trace_dispatch(
        self, program, key: BucketKey, qs: list[Query], route: str,
        workers: tuple[int, ...], start: float, finish: float, *,
        n_padded: int, service_s: float, service_src: str, measured_s: float,
    ) -> None:
        """One `dispatch` sim-span on the slice's first worker lane (the
        span attribution counts), plus `dispatch_lane` spans on the rest of
        the slice so the timeline shows every occupied worker without
        double-counting the dispatch."""
        self._emit_round_costs(program)
        args = dict(
            model=qs[0].model, kind=key.kind, route=route,
            sampler=key.sampler, fused=key.fused,
            n_real=len(qs), n_padded=n_padded,
            pad_efficiency=round(len(qs) / n_padded, 6) if n_padded else 0.0,
            n_iters=key.n_iters, n_chains=key.n_chains,
            resumed=key.resumed, program=program.program_key,
            service_s=service_s, service_src=service_src,
        )
        tracer.sim_span(
            "dispatch", start, finish, cat="runtime",
            track=f"worker{workers[0]}",
            wargs={"measured_s": measured_s}, **args,
        )
        for w in workers[1:]:
            tracer.sim_span(
                "dispatch_lane", start, finish, cat="runtime",
                track=f"worker{w}", model=qs[0].model, route=route,
                lead_worker=workers[0],
            )

    def _run_sharded(
        self, program, key: BucketKey, qs: list[Query],
        return_state: bool = False,
    ) -> list[QueryResult]:
        """The real sharded route: each query's grid rows split over the
        mesh slice via the `core/distributed.py` engines (pins never route
        here), one query after another.

        Fused buckets run the fused sharded engine — K6 over every row slab
        per half-step, the same datapath as the vmap route and bit-exact
        with it (asserted at first sharded-fused use), so chain-state
        carries and the quality accumulator cross the route boundary
        freely.  Non-fused buckets keep the legacy engines, whose
        per-position key folding legitimately draws different bits — the
        route is part of the engine config, not a hidden fallback."""
        mesh = self._shard_mesh(program.device)
        if not key.fused:
            out = []
            for q in qs:
                labels = program.run_sharded(
                    prng.key(q.seed), mesh,
                    n_chains=key.n_chains, n_iters=key.n_iters,
                    sampler=key.sampler,
                    evidence=torch.tensor(np.asarray(q.image, np.int32),
                                          device=program.device),
                    backend=key.backend,
                )
                out.append(QueryResult(
                    qid=q.qid, model=q.model, kind="mrf", marginals=None,
                    final_state=labels.cpu().numpy(), arrival_s=q.arrival_s,
                    batch_size=len(qs),
                ))
            return out
        program.ensure_fused_cross_check(key.sampler, sharded=True)
        run_state = return_state or key.diagnostics
        out = []
        for q in qs:
            # the accumulator splits at the query's *total* budget even
            # when this dispatch runs one slice of it (as the vmap route's
            # per-lane totals do)
            diag_total = None
            if key.diagnostics and not key.resumed:
                diag_total = q.n_iters
            res = dist_mod.run_program_sharded(
                program,
                None if key.resumed else prng.key(q.seed), mesh,
                n_chains=key.n_chains, n_iters=key.n_iters,
                sampler=key.sampler,
                evidence=torch.tensor(np.asarray(q.image, np.int32),
                                      device=program.device),
                backend=key.backend, fused=True,
                carry=q.carry, return_state=run_state,
                diag_total=diag_total,
            )
            state = None
            if run_state:
                labels, state = res
            else:
                labels = res
            quality = None
            if key.diagnostics:
                quality = diag_accum.summarize(state.quality).brief()
            out.append(QueryResult(
                qid=q.qid, model=q.model, kind="mrf", marginals=None,
                final_state=labels.cpu().numpy(), arrival_s=q.arrival_s,
                batch_size=len(qs),
                carry=state if return_state else None,
                quality=quality,
            ))
        return out
