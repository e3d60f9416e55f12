"""The port's `repro_torch.obs` against the reference's `repro.obs`.

  * The same calls into both tracers record the same events, and both
    exporters (deterministic JSONL, Perfetto, the attribution join and its
    table) turn the same events into byte-identical output.
  * A traced run of the port's engine over the quick Zipf trace: its
    exports through the reference's exporters equal the port's, byte for
    byte; its sim-clock events (run_start, flush, dispatch, queue depth,
    round costs) equal the reference engine's on the same trace; the JSONL
    is byte-identical across same-seed runs; dispatch spans reconcile with
    the metrics; attribution covers every dispatch; tracing changes no
    answer.
  * The CLI round trip: `python -m repro_torch.runtime --trace-out`."""

import dataclasses
import json
import os

import pytest

from repro import obs as r_obs
from repro.compile import clear_program_cache as r_clear
from repro.launch.report import attribution_table as r_attribution_table
from repro.obs import attrib as r_attrib
from repro.obs import export as r_export
from repro.obs import tracer as r_tracer
from repro.runtime import Engine as REngine
from repro.runtime import EngineConfig as RConfig
from repro.runtime import zipf_trace as r_zipf_trace
from repro_torch import obs
from repro_torch.compile.program import clear_program_cache
from repro_torch.obs import attrib, export, tracer
from repro_torch.obs.tracer import NULL_SPAN, Tracer
from repro_torch.runtime import Engine, EngineConfig, zipf_trace


@pytest.fixture(autouse=True)
def _obs_off():
    obs.disable()
    r_obs.disable()
    clear_program_cache()
    yield
    obs.disable()
    r_obs.disable()
    clear_program_cache()


def _as_reference(events):
    """The port's events as the reference's `Event`s (same fields)."""
    return [r_tracer.Event(**dataclasses.asdict(e)) for e in events]


def _same_exports(events):
    """Every export of `events` by the port equals the reference's."""
    ref = _as_reference(events)
    assert export.to_jsonl(events) == r_export.to_jsonl(ref)
    assert json.dumps(export.to_perfetto(events), sort_keys=True) == \
        json.dumps(r_export.to_perfetto(ref), sort_keys=True)
    dicts = export.events_as_dicts(events)
    assert dicts == r_export.events_as_dicts(ref)
    rows, gaps = attrib.attribution(dicts)
    assert (rows, gaps) == r_attrib.attribution(dicts)
    assert attrib.coverage(dicts) == r_attrib.coverage(dicts)
    assert attrib.attribution_table(rows) == r_attribution_table(rows)
    return rows, gaps


def _drive(mod):
    """One fixed sequence of tracer calls (every entry point)."""
    tr = mod.enable(capacity=6)
    with mod.span("compile", cat="compile", n=3) as s:
        s.set(extra=[1, 2])
        s.set_wall(w=0.25)
    mod.instant("flush", cat="runtime", sim_t=0.5, model="m", full=True)
    mod.sim_span("dispatch", 0.5, 0.75, cat="runtime", track="worker1",
                 wargs={"measured_s": 0.1}, model="m", program="p",
                 service_s=0.25)
    mod.counter("queue_depth", 3, sim_t=0.5)
    for i in range(4):  # overflows the ring: the oldest events go
        mod.instant(f"e{i}", sim_t=float(i))
    events = list(tr.events)
    dropped = tr.dropped
    mod.disable()
    return events, dropped


def test_same_calls_record_the_same_events():
    ev_t, drop_t = _drive(tracer)
    ev_r, drop_r = _drive(r_tracer)
    assert drop_t == drop_r == 2
    strip = lambda e: {k: v for k, v in dataclasses.asdict(e).items()
                       if k not in ("wall_t0", "wall_t1")}
    assert [strip(e) for e in ev_t] == [strip(e) for e in ev_r]
    _same_exports(ev_t)


def test_disabled_tracing_is_a_null_span():
    assert not obs.enabled()
    s = tracer.span("x", foo=1)
    assert s is NULL_SPAN
    with s as live:
        live.set(a=1)
        live.set_wall(b=2)
    tracer.instant("x")
    tracer.counter("x", 1)
    tracer.sim_span("x", 0.0, 1.0)
    assert obs.get() is None


def test_ring_buffer_evicts_oldest_and_counts_dropped():
    tr = Tracer(capacity=4)
    for i in range(10):
        tr.emit("instant", f"e{i}", "test")
    assert len(tr.events) == 4 and tr.dropped == 6
    assert [e.name for e in tr.events] == ["e6", "e7", "e8", "e9"]
    tr.clear()
    assert len(tr.events) == 0 and tr.dropped == 0
    with pytest.raises(ValueError):
        Tracer(capacity=0)


def _traced_pass(**cfg):
    clear_program_cache()
    tr = obs.enable()
    models, queries = zipf_trace(24, quick=True, seed=3,
                                 mean_interarrival_s=5e-5)
    eng = Engine(models, EngineConfig(pad_sizes=(8,), max_batch=8, **cfg),
                 device="cpu")
    eng.submit(queries)
    results = eng.run()
    events = list(tr.events)
    obs.disable()
    return eng, results, events


SIM_CATS = ("runtime", "cost", "admission")


def _sim_events(dicts):
    """The sim-clock events, without the sequence numbers (compile spans
    interleave differently) and the reference's profiler join key."""
    out = []
    for e in dicts:
        if e["cat"] not in SIM_CATS:
            continue
        e = {k: v for k, v in e.items() if k != "seq"}
        e["args"] = {k: v for k, v in e["args"].items()
                     if k != "profile_sig"}
        out.append(e)
    return out


def test_engine_trace_matches_the_reference():
    eng, _, events = _traced_pass(n_workers=2, fused=True)
    rows, gaps = _same_exports(events)
    assert gaps == [] and rows

    r_clear()
    tr = r_obs.enable()
    models, queries = r_zipf_trace(24, quick=True, seed=3,
                                   mean_interarrival_s=5e-5)
    ref = REngine(models, RConfig(pad_sizes=(8,), max_batch=8, n_workers=2))
    ref.submit(queries)
    ref.run()
    r_events = list(tr.events)
    r_obs.disable()
    r_clear()
    mine = _sim_events(export.events_as_dicts(events, strip_wall=True))
    theirs = _sim_events(r_export.events_as_dicts(r_events, strip_wall=True))
    # the reference's dispatch spans say fused=False (its default engine);
    # the port's served fused: the same clock, the same decisions
    for e in theirs:
        if "fused" in e["args"]:
            e["args"]["fused"] = True
    assert mine == theirs
    assert eng.metrics.series.to_jsonl() == ref.metrics.series.to_jsonl()


def test_jsonl_byte_identical_across_same_seed_runs(tmp_path):
    _, r1, ev1 = _traced_pass(n_workers=2)
    _, r2, ev2 = _traced_pass(n_workers=2)
    j1, j2 = export.to_jsonl(ev1), export.to_jsonl(ev2)
    assert j1 == j2
    assert len(j1.splitlines()) == len(ev1) > 0
    for qid in r1:
        assert (r1[qid].final_state == r2[qid].final_state).all()
    path = os.path.join(tmp_path, "t.jsonl")
    export.write_jsonl(path, ev1)
    loaded = export.load_jsonl(path)
    assert all("wall_t0" not in r and "wargs" not in r for r in loaded)
    relines = [json.dumps(r, sort_keys=True) for r in loaded]
    assert "\n".join(relines) + "\n" == j1
    rows, gaps = attrib.attribution(loaded)
    assert gaps == []
    assert all(r["n_measured"] == 0 for r in rows if r["kind"] == "round")
    assert "n/a" in attrib.attribution_table(rows)


def test_event_counts_reconcile_with_metrics():
    eng, _, events = _traced_pass(n_workers=2)
    m = eng.metrics
    dicts = export.events_as_dicts(events)
    disp = [e for e in dicts
            if e["name"] == "dispatch" and e["kind"] == "span"]
    assert len(disp) == len(m.batch_records) > 0
    assert (sum(e["args"]["n_real"] for e in disp)
            == sum(b.n_real for b in m.batch_records))
    assert len([e for e in dicts if e["name"] == "flush"]) == \
        len(m.batch_records)
    buckets = [e for e in dicts if e["name"] == "execute_bucket"]
    assert len(buckets) == len(m.batch_records)
    for e in buckets:
        assert 0.0 < e["args"]["pad_efficiency"] <= 1.0
    rows, gaps = attrib.attribution(dicts)
    assert gaps == []
    n_disp = 0
    for prog in {r["program"] for r in rows if r["kind"] == "round"}:
        rr = [r for r in rows if r["kind"] == "round"
              and r["program"] == prog]
        assert sum(r["share"] for r in rr) == pytest.approx(1.0)
        n_disp += rr[0]["n_dispatches"]
    assert n_disp == len(m.batch_records)
    starts = [e for e in events if e.name == "run_start"]
    assert len(starts) == 1 and starts[0].args["n_workers"] == 2
    host = export.to_perfetto(events)["traceEvents"]
    assert any(e.get("name") == "cross_check" for e in host)


def test_tracing_does_not_change_results_or_sim_metrics():
    models, queries = zipf_trace(24, quick=True, seed=4,
                                 mean_interarrival_s=5e-5)
    off = Engine(models, EngineConfig(pad_sizes=(8,), max_batch=8,
                                      n_workers=2), device="cpu")
    off.submit(queries)
    r_off = off.run()
    clear_program_cache()
    obs.enable()
    on = Engine(models, EngineConfig(pad_sizes=(8,), max_batch=8,
                                     n_workers=2), device="cpu")
    on.submit(queries)
    r_on = on.run()
    obs.disable()
    s_off, s_on = off.metrics.summary(), on.metrics.summary()
    for k in s_off:
        if k not in ("wall_s", "calib_median_err"):
            assert s_off[k] == s_on[k], k
    for qid in r_off:
        assert (r_off[qid].final_state == r_on[qid].final_state).all()


def test_cli_trace_out_round_trip(tmp_path, capsys):
    from repro_torch.runtime.__main__ import main as runtime_main

    path = os.path.join(tmp_path, "trace.json")
    rc = runtime_main([
        "--quick", "--trace", "zipf", "--queries", "48", "--workers", "2",
        "--fused", "--device", "cpu", "--trace-out", path,
    ])
    assert rc == 0
    assert not obs.enabled()
    doc = json.load(open(path))
    assert any(e.get("name") == "dispatch" for e in doc["traceEvents"])
    base = os.path.splitext(path)[0]
    assert os.path.exists(base + ".jsonl")
    sidecar = json.load(open(base + ".attrib.json"))
    assert sidecar["gaps"] == [] and sidecar["rows"]
    out = capsys.readouterr().out
    assert "| round |" in out and "served=48" in out
