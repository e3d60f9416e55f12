"""Structured tracing: nestable spans + typed counters in a ring buffer
(a copy of `repro/obs/tracer.py`: plain Python, no torch).

The whole stack (compile passes, the runtime event loop, the executor's
dispatches, kernel entry points) calls into this module unconditionally;
when tracing is *off* — the default — every entry point is a single
module-attribute check that returns a shared no-op object, so the serving
hot path pays no allocation and no branch beyond `if _TRACER is None`.
Enable via the `REPRO_TRACE=1` environment variable (checked once at
import) or `repro_torch.obs.enable()`.

Two clocks, deliberately:

  * **wall** — `time.perf_counter()` at span open/close.  Real, noisy,
    machine-dependent; stripped from the deterministic JSONL export and
    kept for the Perfetto timeline and calibration-error attribution.
  * **sim** — the runtime engine's deterministic simulated clock, attached
    explicitly by the instrumentation (`sim_span(name, t0, t1)`).  Same
    trace, same sim timestamps, every run — which is what makes the JSONL
    event log byte-identical across same-seed replays and therefore
    testable.

Event payloads follow the same split: `args` holds deterministic values
(bucket statics, predicted cycles, pad decisions), `wargs` holds
wall-derived ones (measured dispatch seconds).  `export.to_jsonl` drops
wall timestamps and `wargs`; `export.to_perfetto` keeps everything.

The buffer is a bounded deque (default 64Ki events): a runaway trace
evicts its *oldest* events rather than growing without bound; `dropped`
reports how many fell off so exports can say so instead of silently
presenting a truncated run as complete.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time

DEFAULT_CAPACITY = 1 << 16


@dataclasses.dataclass
class Event:
    """One trace record.  `kind` is "span" | "instant" | "counter"."""

    seq: int
    kind: str
    name: str
    cat: str
    track: str | None
    wall_t0: float | None  # perf_counter seconds; wall — stripped from JSONL
    wall_t1: float | None
    sim_t0: float | None  # simulated seconds; deterministic
    sim_t1: float | None
    args: dict  # deterministic payload
    wargs: dict  # wall-derived payload — stripped from JSONL


class Tracer:
    """Ring buffer of `Event`s with a deterministic sequence counter."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.events: collections.deque[Event] = collections.deque(
            maxlen=capacity
        )
        self.n_emitted = 0
        self._seq = 0

    def emit(
        self,
        kind: str,
        name: str,
        cat: str,
        track: str | None = None,
        wall_t0: float | None = None,
        wall_t1: float | None = None,
        sim_t0: float | None = None,
        sim_t1: float | None = None,
        args: dict | None = None,
        wargs: dict | None = None,
    ) -> Event:
        ev = Event(
            seq=self._seq, kind=kind, name=name, cat=cat, track=track,
            wall_t0=wall_t0, wall_t1=wall_t1, sim_t0=sim_t0, sim_t1=sim_t1,
            args=args if args is not None else {},
            wargs=wargs if wargs is not None else {},
        )
        self._seq += 1
        self.n_emitted += 1
        self.events.append(ev)
        return ev

    @property
    def dropped(self) -> int:
        """Events evicted by the ring (emitted minus retained)."""
        return self.n_emitted - len(self.events)

    def clear(self) -> None:
        self.events.clear()
        self.n_emitted = 0
        self._seq = 0


class _NullSpan:
    """The shared off-path span: every method is a no-op, one instance
    serves every disabled `span()` call (no allocation on the hot path)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass

    def set_wall(self, **wargs) -> None:
        pass


NULL_SPAN = _NullSpan()


class _Span:
    """A live wall-clocked span (context manager).  `set()` attaches
    deterministic attributes, `set_wall()` wall-derived ones."""

    __slots__ = ("_tracer", "name", "cat", "track", "args", "wargs", "_t0")

    def __init__(self, tracer: Tracer, name: str, cat: str,
                 track: str | None, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.track = track
        self.args = args
        self.wargs: dict = {}
        self._t0 = 0.0

    def __enter__(self):
        # the wall half of the span's dual timestamps (see module docstring)
        self._t0 = time.perf_counter()  # lint: allow[wallclock-in-sim]
        return self

    def set(self, **args) -> None:
        self.args.update(args)

    def set_wall(self, **wargs) -> None:
        self.wargs.update(wargs)

    def __exit__(self, *exc):
        t1 = time.perf_counter()  # lint: allow[wallclock-in-sim]
        self._tracer.emit(
            "span", self.name, self.cat, self.track,
            wall_t0=self._t0, wall_t1=t1, args=self.args, wargs=self.wargs,
        )
        return False


_TRACER: Tracer | None = None


def enabled() -> bool:
    return _TRACER is not None


def get() -> Tracer | None:
    return _TRACER


def enable(capacity: int = DEFAULT_CAPACITY) -> Tracer:
    """Install a fresh tracer (any previous buffer is discarded) and
    return it."""
    global _TRACER
    _TRACER = Tracer(capacity)
    return _TRACER


def disable() -> None:
    global _TRACER
    _TRACER = None


def span(name: str, cat: str = "host", track: str | None = None, **args):
    """Context manager timing a wall-clocked span.  Off: returns the
    shared no-op span."""
    t = _TRACER
    if t is None:
        return NULL_SPAN
    return _Span(t, name, cat, track, args)


def instant(
    name: str, cat: str = "host", track: str | None = None,
    sim_t: float | None = None, wargs: dict | None = None, **args,
) -> None:
    """A point event (shed/defer decisions, flush markers, round costs)."""
    t = _TRACER
    if t is None:
        return
    t.emit("instant", name, cat, track, sim_t0=sim_t, sim_t1=sim_t,
           args=args, wargs=wargs)


def sim_span(
    name: str, t0: float, t1: float, cat: str = "sim",
    track: str | None = None, wargs: dict | None = None, **args,
) -> None:
    """A retrospective span on the *simulated* clock (the engine knows a
    dispatch's start/finish only after booking the worker pool)."""
    t = _TRACER
    if t is None:
        return
    t.emit("span", name, cat, track, sim_t0=t0, sim_t1=t1,
           args=args, wargs=wargs)


def counter(
    name: str, value, sim_t: float | None = None,
    track: str | None = None, cat: str = "sim",
) -> None:
    """A typed counter sample (queue depth, token-bucket level)."""
    t = _TRACER
    if t is None:
        return
    t.emit("counter", name, cat, track, sim_t0=sim_t, sim_t1=sim_t,
           args={"value": value})


# honor the environment once at import: REPRO_TRACE=1 (anything but ""/"0")
if os.environ.get("REPRO_TRACE", "") not in ("", "0"):
    enable()
