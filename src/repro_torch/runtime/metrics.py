"""Serving metrics for the runtime engine (a copy of
`repro/runtime/metrics.py`, on the port's program cache): latency
percentiles, throughput,
per-worker utilization, backpressure counters, and the cache behavior that
makes or breaks a sampling-as-a-service box.

Latency/throughput numbers are in *simulated* seconds (the engine's
deterministic clock — same trace, same numbers, every run, which is what
the tests pin down); `wall_s` is the only wall-clock field the determinism
comparisons must skip — `measured_s` on batch records (real dispatch wall
time, kept for calibration-error reporting) never enters the summary
except through `calib_median_err`, which is advisory.  Cache counters are
deltas over the engine run, not process-lifetime totals, so one summary
describes one trace.

Percentiles are honest about tiny samples: p50/p95 of 0 or 1 observations
is reported as None (rendered "n/a"), never a fabricated number.

Key reference (summary dict; all sim-clock unless noted):

  =================  ======================================================
  latency_p50/p95_s  exact percentiles over per-query latencies
                     (``percentile()`` — None below 2 samples)
  latency_p99_s      *histogram-derived*: upper bucket bound from the
                     ``query_latency_s`` series (conservative; None below
                     2 observations, same refusal as ``percentile()``)
  trace_dropped      ring-buffer overflow count for this run when tracing
                     was on (0 = full attribution coverage; nonzero emits
                     an ``obs-trace-dropped`` warning finding)
  calib_median_err   advisory, wall-derived — excluded from determinism
                     comparisons along with wall_s
  series             ``obs.timeseries.SeriesRegistry`` — queue_depth /
                     pad_efficiency / worker_stall_s / bucket_service_s /
                     query_latency_s sampled on the sim clock
  =================  ======================================================
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.compile.program import cache_stats
from repro_torch.obs import timeseries


@dataclasses.dataclass
class BatchRecord:
    model: str
    kind: str
    n_real: int
    n_padded: int
    service_s: float  # predicted (simulated) service time
    clamp_lowerings: int
    worker: int = 0  # first worker of the dispatch's slice
    n_workers: int = 1  # slice width (1 = plain vmap dispatch)
    route: str = "vmap"  # "vmap" | "sharded"
    start_s: float = 0.0
    finish_s: float = 0.0
    measured_s: float = 0.0  # real dispatch wall time (never drives the sim)
    service_src: str = "line"  # "measured" | "line"


def percentile(samples, q) -> float | None:
    """np.percentile that refuses to invent statistics: fewer than two
    samples has no distribution to summarize, so report None ("n/a")."""
    if len(samples) < 2:
        return None
    return float(np.percentile(np.asarray(samples), q))


def fmt_ms(seconds: float | None) -> str:
    return "n/a" if seconds is None else f"{seconds * 1e3:.2f}ms"


class RuntimeMetrics:
    """Accumulates per-query and per-batch records during an engine run."""

    def __init__(self):
        self.query_records: list = []  # QueryResult, finalized
        self.batch_records: list[BatchRecord] = []
        self._cache0 = dict(cache_stats())
        self._cache_frozen: dict | None = None
        self.wall_s = 0.0
        # executor + admission state, installed by the engine at end-of-run
        self.worker_busy_s: tuple[float, ...] = (0.0,)
        # per-worker idle-while-work-waited time (the flush-window stall):
        # the slice of a worker's idle gap during which its next batch's
        # oldest query had already arrived — idle *blocked on batching*,
        # as opposed to idle with nothing to serve
        self.worker_stall_s: tuple[float, ...] = (0.0,)
        self.sheds = 0
        self.shed_tokens = 0
        self.shed_queue = 0
        self.defers = 0
        self.max_queue_depth = 0
        # sim-clock time series (always on; pure python, deterministic)
        self.series = timeseries.SeriesRegistry()
        # tracer ring-buffer overflow during this run (0 when tracing off)
        self.trace_dropped = 0

    def record_batch(self, rec: BatchRecord) -> None:
        self.batch_records.append(rec)

    def record_queries(self, results) -> None:
        self.query_records.extend(results)

    def finalize(self) -> None:
        """Freeze the cache delta at end-of-run (the engine calls this):
        cache counters are process-global, so a summary computed later —
        after other engines or baselines have run — must not absorb their
        traffic."""
        self._cache_frozen = self.cache_delta()

    def cache_delta(self) -> dict:
        if self._cache_frozen is not None:
            return dict(self._cache_frozen)
        now = cache_stats()
        delta = {
            k: now[k] - self._cache0[k]
            for k in ("hits", "misses", "evictions")
        }
        delta["size"] = now["size"]
        delta["capacity"] = now["capacity"]
        total = delta["hits"] + delta["misses"]
        delta["hit_rate"] = delta["hits"] / total if total else 0.0
        return delta

    def summary(self) -> dict:
        lat = [r.latency_s for r in self.query_records]
        cache = self.cache_delta()
        clamp_lowerings = sum(b.clamp_lowerings for b in self.batch_records)
        finish = max((r.finish_s for r in self.query_records), default=0.0)
        n = len(self.query_records)
        p50 = percentile(lat, 50)
        p95 = percentile(lat, 95)
        util = tuple(
            round(b / finish, 6) if finish else 0.0
            for b in self.worker_busy_s
        )
        stall = tuple(
            round(s / finish, 6) if finish else 0.0
            for s in self.worker_stall_s
        )
        # advisory calibration error: |predicted - measured| / measured over
        # dispatches served from the measured table (wall noise — excluded
        # from determinism comparisons along with wall_s)
        errs = [
            abs(b.service_s - b.measured_s) / b.measured_s
            for b in self.batch_records
            if b.service_src == "measured" and b.measured_s > 0
        ]
        submitted = n + self.sheds
        # quality roll-ups over served queries that carried a diagnostics
        # brief (engine diagnostics=True); None when diagnostics were off
        # or every brief was degenerate
        qual = [r.quality for r in self.query_records
                if getattr(r, "quality", None)]
        rhats = [q["rhat_max"] for q in qual if q.get("rhat_max") is not None]
        esses = [q["ess_min"] for q in qual if q.get("ess_min") is not None]
        return {
            "n_queries": n,
            "n_batches": len(self.batch_records),
            # like the percentiles, honest about the degenerate case: with
            # zero dispatched batches there is no mean batch size to report
            "mean_batch": (
                n / len(self.batch_records) if self.batch_records else None
            ),
            "pad_efficiency": (
                sum(b.n_real for b in self.batch_records)
                / max(sum(b.n_padded for b in self.batch_records), 1)
            ),
            # latencies stay in seconds end to end; `table()` formats once
            # at the edge (the old *_ms keys were converted twice)
            "latency_p50_s": p50,
            "latency_p95_s": p95,
            # histogram-derived (bucket upper bound): conservative, and
            # like percentile() it refuses below 2 observations
            "latency_p99_s": (
                self.series.histogram("query_latency_s").quantile(99)
            ),
            "latency_mean_s": float(np.mean(lat)) if n else None,
            "sim_elapsed_s": finish,
            "throughput_qps": n / finish if finish else 0.0,
            "n_workers": len(self.worker_busy_s),
            "worker_util": util,
            "worker_stall_frac": stall,
            "sharded_batches": sum(
                1 for b in self.batch_records if b.route == "sharded"
            ),
            "sheds": self.sheds,
            "shed_tokens": self.shed_tokens,
            "shed_queue": self.shed_queue,
            "shed_rate": self.sheds / submitted if submitted else 0.0,
            "defers": self.defers,
            "max_queue_depth": self.max_queue_depth,
            "calib_median_err": (
                float(np.median(errs)) if errs else None
            ),
            "calibrated_batches": len(errs),
            "cache_hits": cache["hits"],
            "cache_misses": cache["misses"],
            "cache_evictions": cache["evictions"],
            "cache_size": cache["size"],
            "cache_capacity": cache["capacity"],
            "cache_hit_rate": cache["hit_rate"],
            "recompiles": cache["misses"] + clamp_lowerings,
            "clamp_lowerings": clamp_lowerings,
            "quality_queries": len(qual),
            "rhat_max": float(max(rhats)) if rhats else None,
            "ess_min": float(min(esses)) if esses else None,
            "trace_dropped": self.trace_dropped,
            "wall_s": self.wall_s,
        }

    def table(self) -> str:
        """Render the summary as the runtime dashboard block."""
        s = self.summary()
        util = "/".join(f"{u:.2f}" for u in s["worker_util"])
        stall = "/".join(f"{u:.2f}" for u in s["worker_stall_frac"])
        mean_batch = (
            "n/a" if s["mean_batch"] is None else f"{s['mean_batch']:.2f}"
        )
        rhat = "n/a" if s["rhat_max"] is None else f"{s['rhat_max']:.3f}"
        ess = "n/a" if s["ess_min"] is None else f"{s['ess_min']:.0f}"
        rows = [
            "| queries | batches | mean batch | pad eff | p50 | p95 | p99 | "
            "sim qps | workers (util) | stall | shed | defer | maxq | "
            "hit rate | evict | recompiles | rhat max | ess min | dropped | "
            "wall |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"
            "---|---|---|---|---|",
            (
                f"| {s['n_queries']} | {s['n_batches']} "
                f"| {mean_batch} | {s['pad_efficiency']:.2f} "
                f"| {fmt_ms(s['latency_p50_s'])} "
                f"| {fmt_ms(s['latency_p95_s'])} "
                f"| {fmt_ms(s['latency_p99_s'])} "
                f"| {s['throughput_qps']:.1f} "
                f"| {s['n_workers']} ({util}) | {stall} "
                f"| {s['sheds']} | {s['defers']} | {s['max_queue_depth']} "
                f"| {s['cache_hit_rate']:.3f} "
                f"| {s['cache_evictions']} | {s['recompiles']} "
                f"| {rhat} | {ess} "
                f"| {s['trace_dropped']} "
                f"| {s['wall_s']:.2f}s |"
            ),
        ]
        return "\n".join(rows)
