"""Admission control and backpressure for the serving engine (a copy of
`repro/runtime/admission.py`: simulated-time arithmetic, no device).

Once the executor's service times are calibrated (measured, not modeled —
see `calibrate.py`), a saturating trace stops being an accounting exercise
and becomes a policy question: which queries do we delay, and which do we
refuse, so the ones we accept still meet their latency promise?  This
module answers it with the two classic mechanisms, both in *simulated*
time so the event loop stays deterministic:

  * a **token bucket** at the front door: tokens refill at `rate_qps` up to
    a burst depth; a query arriving to an empty bucket is *deferred* to the
    simulated instant a token will exist (re-entering the arrival queue,
    competing again) or *shed* outright — `policy` picks, and a deferral
    that would exceed `max_defer_s` past the original arrival sheds anyway,
    because serving a stale answer late is the worst of both.
  * **bounded per-bucket queues**: a query whose bucket already holds
    `queue_limit` pending queries is shed at admission — the queue bound is
    what keeps worst-case latency finite when a burst outruns the workers.

Slice continuations (chain-state carry-over) bypass both mechanisms: their
query was already admitted once, and half-running a posterior helps nobody.

Everything here is pure simulated-time arithmetic on the deterministic
clock — no wall time, no randomness — so shed/defer decisions replay
exactly and the engine's determinism guarantee survives saturation.
"""

from __future__ import annotations

import dataclasses

ADMIT = "admit"
DEFER = "defer"
SHED = "shed"


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Front-door policy.  The defaults disable everything (open
    admission), so an engine without explicit backpressure behaves exactly
    as before this module existed."""

    rate_qps: float | None = None  # token refill rate; None = unlimited
    burst: int = 16  # token bucket depth (and the max burst admitted)
    queue_limit: int | None = None  # max pending queries per bucket
    policy: str = "defer"  # "defer" | "shed" on an empty token bucket
    max_defer_s: float = 0.050  # defer budget past the original arrival

    def __post_init__(self):
        if self.policy not in (DEFER, SHED):
            raise ValueError(f"unknown admission policy {self.policy!r}")
        if self.rate_qps is not None and self.rate_qps <= 0:
            raise ValueError(f"rate_qps must be > 0, got {self.rate_qps}")
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")
        if self.queue_limit is not None and self.queue_limit < 1:
            raise ValueError(
                f"queue_limit must be >= 1, got {self.queue_limit}"
            )


class AdmissionController:
    """Deterministic token-bucket + queue-bound bookkeeping.

    The engine consults `decide()` for every arrival (in nondecreasing
    simulated-arrival order — the refill integrates elapsed time) and
    `queue_full()` before enqueueing into a bucket; counters feed the
    metrics dashboards."""

    def __init__(self, config: AdmissionConfig | None = None):
        self.config = config or AdmissionConfig()
        self.tokens = float(self.config.burst)
        self._last_t = 0.0
        self.defers = 0  # deferral *events* (one query may defer repeatedly)
        self.shed_qids: list[int] = []
        self.shed_tokens = 0  # shed by the token bucket / defer budget
        self.shed_queue = 0  # shed by a full bucket queue
        self.max_queue_depth = 0

    # -- token bucket -------------------------------------------------------

    def _refill(self, t: float) -> None:
        if t > self._last_t:
            self.tokens = min(
                float(self.config.burst),
                self.tokens + (t - self._last_t) * self.config.rate_qps,
            )
            self._last_t = t

    def decide(self, t: float, first_arrival_t: float) -> tuple[str, float]:
        """(ADMIT, t) | (DEFER, retry_t) | (SHED, t) for an arrival at
        simulated time `t` whose original arrival was `first_arrival_t`
        (they differ for a re-arriving deferred query)."""
        cfg = self.config
        if cfg.rate_qps is None:
            return ADMIT, t
        self._refill(t)
        # the 1e-9 tolerance matters: a deferred query retries at the exact
        # instant the refill integral reaches 1.0, and float rounding can
        # land it at 0.999...; without the tolerance it would re-defer by a
        # zero-width wait forever
        if self.tokens >= 1.0 - 1e-9:
            self.tokens -= 1.0
            return ADMIT, t
        retry_t = t + (1.0 - self.tokens) / cfg.rate_qps
        if (
            cfg.policy == SHED
            or retry_t - first_arrival_t > cfg.max_defer_s
            or retry_t <= t  # no representable progress: shed, don't spin
        ):
            self.shed_tokens += 1
            return SHED, t
        self.defers += 1
        return DEFER, retry_t

    # -- bounded queues -----------------------------------------------------

    def queue_full(self, depth: int) -> bool:
        """True if a bucket already holding `depth` queries must shed the
        next one."""
        limit = self.config.queue_limit
        return limit is not None and depth >= limit

    def note_depth(self, depth: int) -> None:
        self.max_queue_depth = max(self.max_queue_depth, depth)

    def record_shed(self, qid: int, by_queue: bool) -> None:
        self.shed_qids.append(qid)
        if by_queue:
            self.shed_queue += 1

    @property
    def sheds(self) -> int:
        return len(self.shed_qids)
