"""Measured-time service calibration for the serving executor (a copy of
`repro/runtime/calibrate.py`).

The engine's original service model was a *line model*: schedule cycles at a
modeled clock plus a launch overhead.  It is deterministic and shape-aware,
but it is a guess — its constants were picked, not measured, so latency
dashboards and admission thresholds drift from what dispatches actually
cost.  This module replaces the guess with measurements while keeping the
event loop deterministic:

  * `Calibrator` holds a **frozen table** of measured service times, one
    entry per dispatch *signature* (program, backend, sampler, chain/iter
    budget, resumed-or-fresh, vmap-or-sharded route) at a probe pad size.
  * `warmup()` (driven by `Engine.calibrate()`) executes each signature a
    few times for real, wall-timed, drops the first repeat (the kernel
    build, lowering and first-use cross-checks) and freezes the median.
  * `predict()` answers from the table when the signature was warmed —
    scaled across pad sizes by the chain-wave ratio, which is the only
    shape effect the line model believes in — and **falls back to the line
    model cold**, so an uncalibrated engine behaves exactly like the old
    one.

Determinism: the table never updates during `Engine.run()` — measured
dispatch times observed by the run are recorded in the metrics for
prediction-error reporting, but the simulated clock only ever reads the
frozen table.  Two runs with the same seed and the same calibrator produce
identical metrics; re-calibrating produces a new table (wall time is noisy)
but each table is internally consistent.
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.obs import tracer


@dataclasses.dataclass(frozen=True)
class ServiceSig:
    """Everything a dispatch's cost depends on, minus the pad size (pads
    scale by the wave ratio — see `Calibrator.predict`).  The BN clamp set
    and MRF pin flag are part of the signature: different clamp sets lower
    different gather-group structures with different per-sweep cost, so
    they must not share a measurement."""

    program_key: str
    kind: str
    backend: str
    sampler: str
    clamp_nodes: tuple
    has_pins: bool
    n_chains: int
    n_iters: int
    burn_in: int
    thin: int
    resumed: bool
    route: str  # "vmap" | "sharded"
    # fused Pallas rounds are bit-exact with unfused but cost differently;
    # they must not share a measurement
    fused: bool = False


def sig_of(key, route: str = "vmap") -> ServiceSig:
    """The service signature of a `batcher.BucketKey` on a given route."""
    return ServiceSig(
        program_key=key.program_key,
        kind=key.kind,
        backend=key.backend,
        sampler=key.sampler,
        clamp_nodes=key.clamp_nodes,
        has_pins=key.has_pins,
        n_chains=key.n_chains,
        n_iters=key.n_iters,
        burn_in=key.burn_in,
        thin=key.thin,
        resumed=key.resumed,
        route=route,
        fused=key.fused,
    )


def _median(xs: list[float]) -> float:
    ys = sorted(xs)
    m = len(ys) // 2
    return ys[m] if len(ys) % 2 else 0.5 * (ys[m - 1] + ys[m])


@dataclasses.dataclass
class Calibrator:
    """Per-signature measured service times with a line-model cold start.

    The line-model constants mirror the engine's historical defaults: one
    launch overhead per microbatch, the schedule's cycle estimate per sweep,
    one wave per `chain_slots` chains of the padded batch."""

    clock_hz: float = 500e6
    launch_overhead_cycles: int = 50_000
    chain_slots: int = 256
    # frozen measurements: sig -> (probe pad size, median seconds)
    measured: dict = dataclasses.field(default_factory=dict)

    # -- the cold fallback --------------------------------------------------

    def _waves(self, n_padded: int, n_chains: int) -> int:
        return -(-n_padded * n_chains // self.chain_slots)

    def line_s(
        self, program, sig: ServiceSig, n_padded: int, shard_width: int = 1
    ) -> float:
        """The line service model (the pre-calibration engine behavior).

        A sharded dispatch splits the *compute* cycles over the mesh slice
        but still pays every comm cycle — the paper's multi-chip posture,
        where inter-chip exchange is the part that does not scale."""
        cost = program.schedule.cost()
        if shard_width > 1:
            sweep = cost["compute_cycles"] / shard_width + cost["comm_cycles"]
        else:
            sweep = cost["total_cycles"]
        waves = self._waves(n_padded, sig.n_chains)
        cycles = self.launch_overhead_cycles + sweep * sig.n_iters * waves
        return cycles / self.clock_hz

    # -- measurements -------------------------------------------------------

    def record(self, sig: ServiceSig, n_padded: int, seconds: float) -> None:
        """Freeze a measurement for `sig` at probe pad `n_padded` (later
        records for the same signature overwrite — warmup records once)."""
        self.measured[sig] = (int(n_padded), float(seconds))

    def warmed(self, sig: ServiceSig) -> bool:
        return sig in self.measured

    def predict(
        self, program, sig: ServiceSig, n_padded: int, shard_width: int = 1
    ) -> tuple[float, str]:
        """(service seconds, "measured" | "line").

        Measured predictions scale across pad sizes by the chain-wave ratio
        (on the ladder sizes the engine uses, n_padded x n_chains rarely
        exceeds one wave, so this is usually the identity)."""
        entry = self.measured.get(sig)
        if entry is None:
            return self.line_s(program, sig, n_padded, shard_width), "line"
        probe_pad, probe_s = entry
        scale = self._waves(n_padded, sig.n_chains) / self._waves(
            probe_pad, sig.n_chains
        )
        return probe_s * scale, "measured"

    # -- warmup -------------------------------------------------------------

    def warmup(self, dispatch, buckets, repeats: int = 2) -> dict:
        """Time each distinct bucket signature through `dispatch` and freeze
        the medians.

        `buckets` is an iterable of (program, bucket_key, queries, route) —
        one representative microbatch per signature, on the route the
        serving loop will pick for it (the engine builds these from the
        submitted trace).  `dispatch(program, key, queries, route)` must
        execute the batch exactly as the serving loop will (same
        executable, same pad, same vmap/sharded path) and return the padded
        size.  The first timing of every signature pays the kernel build, the
        lowering and the cross-checks and
        is dropped; the median of the `repeats` that follow is frozen.
        Returns {sig: seconds}."""
        out = {}
        for program, key, qs, route in buckets:
            sig = sig_of(key, route)
            if self.warmed(sig):
                continue
            with tracer.span(
                "warmup_compile", cat="calibrate",
                program=sig.program_key, kind=sig.kind,
                sampler=sig.sampler, route=route, fused=sig.fused,
            ):
                # untimed rep: pays the build, lowering and cross-checks
                n_padded = dispatch(program, key, qs, route)
            times = []
            for rep in range(max(1, repeats)):
                with tracer.span(
                    "warmup_rep", cat="calibrate",
                    program=sig.program_key, kind=sig.kind,
                    sampler=sig.sampler, route=route, rep=rep,
                ):
                    # the dispatch ends in the results' copy to numpy,
                    # which waits for the card: the wall covers its work
                    t0 = time.perf_counter()
                    dispatch(program, key, qs, route)
                    times.append(time.perf_counter() - t0)
            self.record(sig, n_padded, _median(times))
            out[sig] = self.measured[sig][1]
            tracer.instant(
                "calibrated", cat="calibrate",
                program=sig.program_key, kind=sig.kind,
                sampler=sig.sampler, route=route,
                n_padded=n_padded, n_reps=max(1, repeats),
                wargs={"median_s": self.measured[sig][1]},
            )
        return out
