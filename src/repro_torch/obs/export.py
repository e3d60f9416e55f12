"""Trace exports: deterministic JSONL and a Chrome/Perfetto timeline
(a copy of `repro/obs/export.py`).

Two serializations of the same event buffer, with opposite priorities:

  * `to_jsonl` — the *testable* log.  Wall timestamps and wall-derived
    payloads (`Event.wargs`) are stripped, keys are sorted, events keep
    their deterministic emit order — so two same-seed engine runs produce
    byte-identical files and a CI diff of the two is a real regression
    signal, not timestamp noise.
  * `to_perfetto` — the *viewable* timeline (chrome://tracing or
    https://ui.perfetto.dev).  Everything survives: simulated-clock lanes
    (one per engine worker, plus the engine's own lane and counter tracks
    for queue depth / token bucket) render under the "sim" process, and
    wall-clocked host spans (compile passes, lowering/cross-check, kernel
    dispatch entries, calibration warmup) under the "host" process.

The two processes intentionally use different timebases — simulated
seconds vs wall seconds since the first event — because gluing them onto
one axis would draw a lie: the sim clock advances by calibrated service
times, not by the wall.
"""

from __future__ import annotations

import json

# deterministic JSONL field order is handled by sort_keys; these are the
# event fields it keeps (everything else is wall-derived)
_JSONL_FIELDS = ("seq", "kind", "name", "cat", "track", "sim_t0", "sim_t1")

SIM_PID = 1
HOST_PID = 2


def event_dict(ev, strip_wall: bool = True) -> dict:
    """One `Event` -> a plain JSON-friendly dict.  With `strip_wall` (the
    JSONL contract) wall timestamps and `wargs` are dropped."""
    rec = {
        "seq": ev.seq, "kind": ev.kind, "name": ev.name, "cat": ev.cat,
    }
    if ev.track is not None:
        rec["track"] = ev.track
    if ev.sim_t0 is not None:
        rec["sim_t0"] = ev.sim_t0
    if ev.sim_t1 is not None:
        rec["sim_t1"] = ev.sim_t1
    if ev.args:
        rec["args"] = dict(ev.args)
    if not strip_wall:
        if ev.wall_t0 is not None:
            rec["wall_t0"] = ev.wall_t0
        if ev.wall_t1 is not None:
            rec["wall_t1"] = ev.wall_t1
        if ev.wargs:
            rec["wargs"] = dict(ev.wargs)
    return rec


def events_as_dicts(events, strip_wall: bool = False) -> list[dict]:
    """The full buffer as plain dicts (analysis-friendly: `attrib` and the
    tests consume this form, and JSONL round-trips to it)."""
    return [event_dict(ev, strip_wall=strip_wall) for ev in events]


def to_jsonl(events) -> str:
    """Deterministic JSONL: one sorted-key JSON object per line, wall
    fields stripped.  Same trace => byte-identical string."""
    lines = [
        json.dumps(event_dict(ev, strip_wall=True), sort_keys=True)
        for ev in events
    ]
    return "\n".join(lines) + ("\n" if lines else "")


def write_jsonl(path: str, events) -> None:
    with open(path, "w") as f:
        f.write(to_jsonl(events))


def load_jsonl(path: str) -> list[dict]:
    """Parse a JSONL event log back into the dict form `attrib` consumes."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# ---------------------------------------------------------------------------
# Perfetto / Chrome trace_event JSON
# ---------------------------------------------------------------------------


def _meta(pid: int, tid: int, name: str, what: str) -> dict:
    return {"ph": "M", "pid": pid, "tid": tid, "name": what,
            "args": {"name": name}}


def to_perfetto(events) -> dict:
    """Events -> a Chrome trace_event JSON object.

    Lanes: sim-clock events with `track="workerN"` land on one thread per
    engine worker under the "sim (deterministic clock)" process (a
    `run_start` instant's `n_workers` arg pre-declares every worker lane,
    so idle workers still show as empty lanes); other sim tracks (engine,
    counters) get their own threads.  Wall-clocked spans group by `cat`
    under the "host (wall clock)" process, timebased at the first wall
    event."""
    events = list(events)
    trace: list[dict] = []
    trace.append(_meta(SIM_PID, 0, "sim (deterministic clock)",
                       "process_name"))
    trace.append(_meta(HOST_PID, 0, "host (wall clock)", "process_name"))

    # -- lane assignment ---------------------------------------------------
    n_workers = 0
    for ev in events:
        if ev.name == "run_start":
            n_workers = max(n_workers, int(ev.args.get("n_workers", 0)))
        if ev.track and ev.track.startswith("worker"):
            try:
                n_workers = max(n_workers, int(ev.track[6:]) + 1)
            except ValueError:
                pass
    sim_tids: dict[str, int] = {"engine": 1}
    for w in range(n_workers):
        sim_tids[f"worker{w}"] = 10 + w
    host_tids: dict[str, int] = {}

    def sim_tid(track: str | None) -> int:
        track = track or "engine"
        if track not in sim_tids:
            sim_tids[track] = 100 + len(sim_tids)
        return sim_tids[track]

    def host_tid(cat: str) -> int:
        if cat not in host_tids:
            host_tids[cat] = 1 + len(host_tids)
        return host_tids[cat]

    walls = [ev.wall_t0 for ev in events if ev.wall_t0 is not None]
    wall0 = min(walls) if walls else 0.0

    for ev in events:
        args = {**ev.args, **ev.wargs}
        if ev.sim_t0 is not None:
            # simulated-clock lane (microseconds of sim time)
            pid, tid = SIM_PID, sim_tid(ev.track)
            ts = ev.sim_t0 * 1e6
            if ev.kind == "counter":
                trace.append({
                    "ph": "C", "pid": pid, "tid": tid, "ts": ts,
                    "name": ev.name,
                    "args": {"value": ev.args.get("value", 0)},
                })
            elif ev.kind == "span":
                trace.append({
                    "ph": "X", "pid": pid, "tid": tid, "ts": ts,
                    "dur": max(0.0, (ev.sim_t1 - ev.sim_t0) * 1e6),
                    "name": ev.name, "cat": ev.cat, "args": args,
                })
            else:
                trace.append({
                    "ph": "i", "s": "t", "pid": pid, "tid": tid, "ts": ts,
                    "name": ev.name, "cat": ev.cat, "args": args,
                })
        elif ev.wall_t0 is not None:
            pid, tid = HOST_PID, host_tid(ev.cat)
            ts = (ev.wall_t0 - wall0) * 1e6
            if ev.kind == "span":
                trace.append({
                    "ph": "X", "pid": pid, "tid": tid, "ts": ts,
                    "dur": max(0.0, (ev.wall_t1 - ev.wall_t0) * 1e6),
                    "name": ev.name, "cat": ev.cat, "args": args,
                })
            else:
                trace.append({
                    "ph": "i", "s": "t", "pid": pid, "tid": tid, "ts": ts,
                    "name": ev.name, "cat": ev.cat, "args": args,
                })
        # events with neither clock (pure markers) are metadata-only; skip

    for track, tid in sorted(sim_tids.items(), key=lambda kv: kv[1]):
        trace.append(_meta(SIM_PID, tid, track, "thread_name"))
    for cat, tid in sorted(host_tids.items(), key=lambda kv: kv[1]):
        trace.append(_meta(HOST_PID, tid, cat, "thread_name"))
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def write_perfetto(path: str, events) -> None:
    with open(path, "w") as f:
        json.dump(to_perfetto(events), f, indent=1)
