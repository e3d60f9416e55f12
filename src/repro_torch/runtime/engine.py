"""The serving engine: a deterministic event loop over batched queries
(port of `repro/runtime/engine.py`; it serves on the card unless built
with `device="cpu"`).

This is the software analogue of the AIA chip's query-serving posture —
many concurrent posterior queries amortized over fixed compiled hardware,
with the host processor distributing work across the mesh.  The engine owns
a registry of models (canonicalized structure-only, so every query on a
model shares one `ir_key` and therefore one program-cache slot), admits
queries from a trace, groups them into buckets (`batcher.BucketKey`), and
flushes a bucket when it fills to `max_batch` or its oldest query has
waited out the microbatch window.

Flushed buckets dispatch onto an `executor.WorkerPool` of `n_workers`
simulated workers with per-worker busy-until clocks, so service overlaps
across workers while the loop itself stays single-threaded and replayable;
large MRF buckets can route onto a mesh slice via `run_sharded`
(`shard_min_sites`).  Long queries execute in slices of `slice_iters`
sweeps (chain-state carry-over — bit-exact with an uninterrupted run), so
short queries interleave between a long query's slices: continuous
batching.  The front door applies `admission.AdmissionConfig` token-bucket
rate limiting and bounded per-bucket queues (shed/defer) once the executor
saturates.

Time is *simulated*: the clock advances by the calibrated service time
(`calibrate.Calibrator` — measured warmup dispatches when available, the
schedule-cost line model cold), never by wall time.  That makes every
latency number deterministic — same trace, same calibration table, same
numbers, every run — while the actual sampling math still runs for real
underneath (results are genuine posteriors).

`backend="schedule"` is the global default (`CompiledProgram.run` shares
it); `Engine(..., backend="eager")` is the escape hatch back to the eager
engines.  `fused=True` serves eligible buckets with one K3 launch per BN
sweep or one K4 launch per MRF half-step over all of a bucket's queries
(`batcher`).
"""

from __future__ import annotations

import dataclasses
import heapq
import time

from repro_torch import device as device_mod
from repro_torch.compile import ir as ir_mod
from repro_torch.compile.program import compile_graph, set_cache_capacity
from repro_torch.core.graphs import DiscreteBayesNet, GridMRF
from repro_torch.obs import timeseries, tracer
from repro_torch.runtime import batcher as batcher_mod
from repro_torch.runtime.admission import (
    DEFER,
    SHED,
    AdmissionConfig,
    AdmissionController,
)
from repro_torch.runtime.batcher import BucketKey, Query, QueryResult
from repro_torch.runtime.calibrate import Calibrator
from repro_torch.runtime.executor import Executor, ExecutorConfig
from repro_torch.runtime.metrics import RuntimeMetrics


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    backend: str = "schedule"  # the global default; "eager" escape hatch
    # route eligible buckets (BN lut_ky/exact_ky, MRF lut_ky on the
    # schedule backend) through the fused kernels (K3, K4, and K6 on the
    # sharded route) — bit-exact with unfused, so a pure service-time knob
    fused: bool = False
    # thread the streaming quality accumulator (repro.diag) through every
    # bucket: each served query's QueryResult.quality carries its R-hat/ESS
    # brief, the metrics grow rhat_max/ess_min columns, and the tracer
    # emits per-query `quality` instants.  Draw streams are bit-identical
    # either way, on every route
    diagnostics: bool = False
    pipeline: str = "runtime"  # pass list incl. merge_small_colors
    mesh_shape: tuple[int, int] = (4, 4)
    window_s: float = 0.002  # microbatch admission window (simulated)
    max_batch: int = 8
    pad_sizes: tuple[int, ...] = batcher_mod.PAD_SIZES
    cache_capacity: int | None = None  # None: leave the global setting
    # executor: W simulated workers; large MRF buckets can shard over a
    # mesh slice of shard_width workers (None = sharded route off)
    n_workers: int = 1
    shard_width: int = 1
    shard_min_sites: int | None = None
    # continuous batching: serve long queries in slices of this many sweeps
    # (None = whole-query dispatches, the pre-slicing behavior)
    slice_iters: int | None = None
    # front-door backpressure (None = open admission)
    admission: AdmissionConfig | None = None
    # line service model (the calibrator's cold fallback): cycles -> seconds
    # at the modeled clock, one launch overhead per microbatch, one wave per
    # `chain_slots` chains
    clock_hz: float = 500e6
    launch_overhead_cycles: int = 50_000
    chain_slots: int = 256


class Engine:
    """Deterministic batched serving over the compiled-program cache, on
    `device` (the card by default; raises without one unless asked for
    the CPU, where the kernels' plain twins run)."""

    def __init__(
        self,
        models: dict[str, DiscreteBayesNet | GridMRF],
        config: EngineConfig | None = None,
        calibrator: Calibrator | None = None,
        *,
        device="cuda",
        **overrides,
    ):
        if config is None:
            config = EngineConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        if config.backend not in ("eager", "schedule"):
            raise ValueError(f"unknown backend {config.backend!r}")
        if config.fused and config.backend != "schedule":
            raise ValueError("fused execution requires backend='schedule'")
        if config.max_batch > max(config.pad_sizes):
            raise ValueError(
                f"max_batch {config.max_batch} exceeds the pad ladder "
                f"{config.pad_sizes}; every flush size must pad to a ladder "
                "shape or each occupancy becomes a fresh compile"
            )
        if config.slice_iters is not None and config.slice_iters < 1:
            raise ValueError(
                f"slice_iters must be >= 1, got {config.slice_iters}"
            )
        # fail at construction, not mid-run: ExecutorConfig validates the
        # worker/slice shape
        ExecutorConfig(
            n_workers=config.n_workers, shard_width=config.shard_width,
            shard_min_sites=config.shard_min_sites,
        )
        self.config = config
        self.device = device_mod.resolve(device)
        self.calibrator = calibrator
        # structure-only canonicalization: per-query evidence never touches
        # the IR, so every query on a model maps to the same program key
        self.graphs = {
            name: ir_mod.canonicalize(m, evidence_mode="runtime")
            for name, m in models.items()
        }
        if config.cache_capacity is not None:
            set_cache_capacity(config.cache_capacity)
        self.metrics = RuntimeMetrics()
        self._queue: list[Query] = []
        self.shed_qids: list[int] = []

    # -- admission ---------------------------------------------------------

    def submit(self, queries) -> None:
        """Admission-time validation: a bad query must be rejected here,
        with the same range rules `CompiledProgram.run()` enforces on the
        single-query path — inside a microbatch an out-of-range (or
        negatively indexed) clamp would otherwise feed the gathers
        silently and serve a wrong posterior."""
        for q in queries:
            if q.model not in self.graphs:
                raise KeyError(f"unregistered model {q.model!r}")
            graph = self.graphs[q.model]
            if graph.kind == "mrf" and q.image is None:
                raise ValueError(
                    f"query {q.qid}: MRF queries carry an observation image"
                )
            for node, val in (q.evidence or {}).items():
                node, val = int(node), int(val)
                if not (0 <= node < graph.n_nodes
                        and 0 <= val < graph.cards[node]):
                    what = "evidence" if graph.kind == "bn" else "pin"
                    raise ValueError(
                        f"query {q.qid}: {what} {node}={val} out of range"
                    )
            self._queue.append(q)

    # -- program + service model -------------------------------------------

    def _program(self, model: str):
        return compile_graph(
            self.graphs[model],
            mesh_shape=self.config.mesh_shape,
            pipeline=self.config.pipeline,
            device=self.device,
        )

    def _bucket_key(self, q: Query) -> BucketKey:
        return batcher_mod.bucket_key(
            q, self.graphs[q.model], self.config.backend,
            self.config.slice_iters, fused=self.config.fused,
            diagnostics=self.config.diagnostics,
        )

    def _make_calibrator(self) -> Calibrator:
        cfg = self.config
        return Calibrator(
            clock_hz=cfg.clock_hz,
            launch_overhead_cycles=cfg.launch_overhead_cycles,
            chain_slots=cfg.chain_slots,
        )

    def calibrate(self, queries=None, repeats: int = 2) -> Calibrator:
        """Measured-time warmup: execute one representative microbatch per
        distinct bucket signature in `queries` (default: the submitted
        queue), wall-timed, and freeze the medians into this engine's
        calibrator (creating one if needed).

        Runs the *same* bucket paths the serving loop will run, so it
        doubles as the warmup (kernel builds, lowerings, first-use
        cross-checks), and the frozen table keeps
        `run()` deterministic — the loop never reads a wall clock.
        Returns the calibrator (shareable across engines)."""
        cfg = self.config
        if self.calibrator is None:
            self.calibrator = self._make_calibrator()
        qs = list(self._queue if queries is None else queries)
        buckets: dict[BucketKey, list[Query]] = {}
        for q in sorted(qs, key=lambda q: (q.arrival_s, q.qid)):
            if q.carry is not None:
                continue  # continuations can't be warmed without states
            buckets.setdefault(self._bucket_key(q), []).append(q)
        return_state = cfg.slice_iters is not None
        # a throwaway executor: warmup runs the exact execution path the
        # serving loop will (vmap or sharded per the bucket's route) but
        # never books the pool
        executor = Executor(
            ExecutorConfig(
                n_workers=cfg.n_workers, shard_width=cfg.shard_width,
                shard_min_sites=cfg.shard_min_sites,
            ),
            self.calibrator, cfg.pad_sizes,
        )

        def dispatch(program, key, rep_qs, route):
            executor.execute(program, key, rep_qs, route, return_state)
            return batcher_mod.pad_size(len(rep_qs), cfg.pad_sizes)

        items = []
        for key, qlist in buckets.items():
            program = self._program(qlist[0].model)
            rep = qlist[: cfg.max_batch]
            route = executor.batch_route(program, key, rep)
            # the bucket key IS the execution key on every route (the fused
            # sharded datapath is first-class, nothing gets demoted), so
            # warmup measures exactly what serving will dispatch
            items.append((program, key, rep, route))
        self.calibrator.warmup(dispatch, items, repeats=repeats)
        return self.calibrator

    # -- the event loop ----------------------------------------------------

    def run(self) -> dict[int, QueryResult]:
        """Drain the submitted queries; returns {qid: QueryResult} for the
        queries that were served (`metrics` reports the shed ones).

        Single pass, deterministic: admission (token bucket + queue bounds)
        at the simulated clock, bucket flush on fill-or-window, dispatch
        onto the worker pool at the calibrated service time.  Long queries
        re-enter the arrival queue between slices as continuations carrying
        their chain state — bit-exact with an unsliced run."""
        cfg = self.config
        # wall-metric half of the dual clock, not the sim's event time
        wall0 = time.perf_counter()  # lint: allow[wallclock-in-sim]
        self.metrics = RuntimeMetrics()  # run-scoped cache delta
        executor = Executor(
            ExecutorConfig(
                n_workers=cfg.n_workers, shard_width=cfg.shard_width,
                shard_min_sites=cfg.shard_min_sites,
            ),
            self.calibrator or self._make_calibrator(),
            cfg.pad_sizes,
        )
        admission = AdmissionController(cfg.admission)
        series = self.metrics.series
        # delta-base for this run's ring-buffer overflow (tracer is
        # process-global; the count must describe this trace only)
        dropped0 = tracer.get().dropped if tracer.enabled() else 0
        tracer.instant(
            "run_start", cat="runtime", sim_t=0.0,
            n_workers=cfg.n_workers, backend=cfg.backend, fused=cfg.fused,
            max_batch=cfg.max_batch, window_s=cfg.window_s,
            slice_iters=cfg.slice_iters, diagnostics=cfg.diagnostics,
        )
        # heap entries (arrival_s, qid, seq, query): seq breaks ties between
        # a query's re-arrivals (defers, slice continuations) deterministically
        heap: list = []
        seq = 0
        first_arrival: dict[int, float] = {}
        for q in sorted(self._queue, key=lambda q: (q.arrival_s, q.qid)):
            first_arrival[q.qid] = q.arrival_s
            heapq.heappush(heap, (q.arrival_s, q.qid, seq, q))
            seq += 1
        self._queue = []
        pending: dict[BucketKey, list[Query]] = {}
        # continuations that met a full bucket wait here (never shed — their
        # chains are half run) and refill the bucket right after it flushes;
        # parking them outside the heap keeps `len(bucket) <= queue_limit`
        # at every instant without perturbing the heap-driven clock (a
        # heap-parked retry would suppress the `not heap` drain rule and
        # ulp-step the clock — a livelock)
        overflow: dict[BucketKey, list[Query]] = {}
        programs: dict[BucketKey, object] = {}
        clock = 0.0
        results: dict[int, QueryResult] = {}
        return_state = cfg.slice_iters is not None

        def admit():
            nonlocal seq
            while heap and heap[0][0] <= clock:
                _, _, _, q = heapq.heappop(heap)
                if q.carry is None:
                    # front door: continuations were already admitted once
                    decision, when = admission.decide(
                        q.arrival_s, first_arrival[q.qid]
                    )
                    if decision == DEFER:
                        tracer.instant(
                            "defer", cat="admission", sim_t=clock,
                            qid=q.qid, until=when,
                        )
                        # copy, never mutate: submitted Query objects may be
                        # replayed through another engine pass
                        q = dataclasses.replace(q, arrival_s=when)
                        heapq.heappush(heap, (when, q.qid, seq, q))
                        seq += 1
                        continue
                    if decision == SHED:
                        admission.record_shed(q.qid, by_queue=False)
                        tracer.instant(
                            "shed", cat="admission", sim_t=clock,
                            qid=q.qid, by="tokens",
                        )
                        continue
                key = self._bucket_key(q)
                bucket = pending.setdefault(key, [])
                if admission.queue_full(len(bucket)):
                    if q.carry is None:
                        admission.record_shed(q.qid, by_queue=True)
                        tracer.instant(
                            "shed", cat="admission", sim_t=clock,
                            qid=q.qid, by="queue",
                        )
                    else:
                        overflow.setdefault(key, []).append(q)
                    continue
                # the program cache's front door: one lookup per admitted
                # query (this is the hit rate the metrics report), and the
                # resolved program rides with the bucket to its flush
                programs[key] = self._program(q.model)
                bucket.append(q)
                admission.note_depth(len(bucket))
            depth = sum(len(b) for b in pending.values())
            series.gauge("queue_depth").sample(clock, depth)
            if tracer.enabled():
                tracer.counter("queue_depth", depth, sim_t=clock)
                if admission.config.rate_qps is not None:
                    tracer.counter(
                        "tokens", round(admission.tokens, 6), sim_t=clock
                    )

        def oldest(key):
            return min(q.arrival_s for q in pending[key])

        admit()
        while heap or pending:
            # NB: the readiness test and the idle-advance horizon must use
            # the *identical* float expressions (`oldest + window`, the
            # pool's `earliest_free`); computing one as `clock - oldest >=
            # window` lets rounding disagree with the horizon and spin the
            # loop at a frozen clock
            free_t = executor.pool.earliest_free()
            ready = [
                k for k, qs in pending.items()
                if len(qs) >= cfg.max_batch
                or clock >= oldest(k) + cfg.window_s
                or not heap
            ] if clock >= free_t else []  # all workers busy: batches grow
            if not ready:
                # idle: jump to the next *future* event — the next arrival,
                # the next window expiry, or (with work waiting) the next
                # worker coming free.  Past horizons must be filtered out:
                # a window that expired while every worker was busy would
                # otherwise pin `min(horizons)` at or before the clock and
                # freeze the loop (its bucket is not ready — the worker
                # gate vetoed it — so nothing else advances time).  The
                # case analysis guarantees a future horizon exists here:
                # arrivals <= clock were admitted, and a busy pool means
                # free_t > clock.
                horizons = [heap[0][0]] if heap else []
                horizons += [oldest(k) + cfg.window_s for k in pending]
                if pending:
                    horizons.append(free_t)
                clock = min(h for h in horizons if h > clock)
                admit()
                continue
            key = min(ready, key=lambda k: (oldest(k), repr(k)))
            qs = sorted(
                pending[key], key=lambda q: (q.arrival_s, q.qid)
            )[: cfg.max_batch]
            taken = {q.qid for q in qs}
            remaining = [q for q in pending[key] if q.qid not in taken]
            # the flush made room: parked continuations re-enter first (in
            # park order), up to the bound
            parked = overflow.get(key, [])
            while parked and not admission.queue_full(len(remaining)):
                remaining.append(parked.pop(0))
                admission.note_depth(len(remaining))
            if not parked:
                overflow.pop(key, None)
            if remaining:
                pending[key] = remaining
            else:
                del pending[key]
            tracer.instant(
                "flush", cat="runtime", sim_t=clock,
                model=qs[0].model, kind=key.kind, n_queries=len(qs),
                full=len(qs) >= cfg.max_batch,
            )
            batch, rec = executor.dispatch(
                programs[key], key, qs, clock, return_state=return_state
            )
            self.metrics.record_batch(rec)
            series.histogram(
                "pad_efficiency", boundaries=timeseries.PAD_EFF_BOUNDARIES,
            ).observe(rec.start_s, rec.n_real / max(rec.n_padded, 1))
            series.histogram("bucket_service_s").observe(
                rec.start_s, rec.service_s
            )
            # cumulative flush-window stall across the pool, sampled per
            # dispatch: the window/ladder autotuner's minimization target
            series.gauge("worker_stall_s").sample(
                rec.finish_s, round(sum(executor.pool.stall_s), 9)
            )
            done = []
            for q, r in zip(qs, batch):
                left = q.n_iters - key.n_iters
                if left > 0:
                    # continuation: same query, chain state attached, the
                    # remaining budget, re-arriving when its slice finished
                    # (a copy — submitted Query objects stay pristine)
                    cont = dataclasses.replace(
                        q, carry=r.carry, n_iters=left,
                        arrival_s=rec.finish_s,
                    )
                    heapq.heappush(heap, (rec.finish_s, cont.qid, seq, cont))
                    seq += 1
                else:
                    r.arrival_s = first_arrival[r.qid]
                    r.carry = None  # slices are internal; results are final
                    results[r.qid] = r
                    done.append(r)
                    series.histogram("query_latency_s").observe(
                        rec.finish_s, r.latency_s
                    )
                    if r.quality is not None and tracer.enabled():
                        # convergence lands on the timeline next to the
                        # dispatch lanes that produced it
                        tracer.instant(
                            "quality", cat="quality", sim_t=rec.finish_s,
                            qid=r.qid, model=r.model, **r.quality,
                        )
            self.metrics.record_queries(done)
            admit()
        # every parked continuation refilled its bucket before the loop
        # could drain (overflow[key] non-empty implies pending[key] was full
        # an instant ago); a violation here would mean lost queries, which
        # must crash, not silently under-serve
        assert not any(overflow.values()), overflow
        self.metrics.worker_busy_s = tuple(executor.pool.busy_s)
        self.metrics.worker_stall_s = tuple(executor.pool.stall_s)
        self.metrics.sheds = admission.sheds
        self.metrics.shed_tokens = admission.shed_tokens
        self.metrics.shed_queue = admission.shed_queue
        self.metrics.defers = admission.defers
        self.metrics.max_queue_depth = admission.max_queue_depth
        if tracer.enabled():
            self.metrics.trace_dropped = tracer.get().dropped - dropped0
        self.shed_qids = list(admission.shed_qids)
        self.metrics.wall_s = (  # lint: allow[wallclock-in-sim]
            time.perf_counter() - wall0
        )
        self.metrics.finalize()
        return results
