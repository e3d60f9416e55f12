"""The port's executor subsystem (`repro_torch.runtime`): the
counterparts of the reference's tests/test_executor.py, on the CPU twins.

Resumed slices batched into foreign buckets, the multi-worker pool,
routing and the sharded route (which on the port always executes, on a
single-controller mesh of the engine's device), measured-time calibration,
token-bucket admission + bounded queues, and the engine-level
continuous-batching guarantees.  The sharded route equals the vmap route,
sliced, batched, fused and with diagnostics, as the reference asserts on 8
simulated devices.  One test replays a saturating bursty trace through
both engines: every sim-clock metric and shed decision agrees.

Inputs come from numpy seeds.  Tolerance: bit-equal."""

import dataclasses

import numpy as np
import pytest

from repro.compile import clear_program_cache as r_clear
from repro.runtime import AdmissionConfig as RAdmission
from repro.runtime import Engine as REngine
from repro.runtime import EngineConfig as RConfig
from repro.runtime import bursty_trace as r_bursty_trace
from repro_torch.compile import ir as t_ir
from repro_torch.compile.program import clear_program_cache, compile_graph
from repro_torch.core import mrf as t_mrf
from repro_torch.core.graphs import GridMRF, bn_repository_replica
from repro_torch.core.graphs import random_bayesnet
from repro_torch.kernels import mrf_gibbs
from repro_torch.runtime import (
    AdmissionConfig,
    AdmissionController,
    Calibrator,
    Engine,
    EngineConfig,
    Executor,
    ExecutorConfig,
    Query,
    RuntimeMetrics,
    WorkerPool,
    bucket_key,
    bursty_trace,
    execute_bucket,
    sig_of,
    zipf_trace,
)
from repro_torch.runtime.admission import ADMIT, DEFER, SHED
from repro_torch.runtime.metrics import BatchRecord, percentile

CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh_cache():
    clear_program_cache()
    yield
    clear_program_cache()


def _engine(models, **kw):
    return Engine(models, EngineConfig(**kw), device=CPU)


# ---------------------------------------------------------------------------
# resumed slices in foreign buckets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
def test_resumed_slice_in_foreign_bucket_bit_exact(fused):
    """A resumed slice batched with companions its first slice never saw
    still ends on the uninterrupted run's bits."""
    bn = random_bayesnet(9, max_parents=2, cards=(2, 3), seed=5)
    graph = t_ir.canonicalize(bn, evidence_mode="runtime")
    prog = compile_graph(graph, pipeline="runtime", device=CPU)
    mk = lambda qid, seed: Query(
        qid=qid, model="m", evidence={1: 0, 4: 1}, n_chains=2,
        n_iters=10, burn_in=2, seed=seed,
    )
    qa, qb = mk(0, 11), mk(1, 22)
    ref = execute_bucket(
        prog, bucket_key(qa, graph, "schedule", fused=fused), [qa])[0]
    sliced_key = bucket_key(qa, graph, "schedule", slice_iters=6,
                            fused=fused)
    ra = execute_bucket(prog, sliced_key, [qa], return_state=True)[0]
    rb = execute_bucket(prog, sliced_key, [qb], return_state=True)[0]
    conta = dataclasses.replace(qa, carry=ra.carry, n_iters=4)
    contb = dataclasses.replace(qb, carry=rb.carry, n_iters=4)
    rkey = bucket_key(conta, graph, "schedule", slice_iters=6, fused=fused)
    assert rkey.resumed and rkey.n_iters == 4 and rkey.fused == fused
    out = execute_bucket(prog, rkey, [conta, contb])
    np.testing.assert_array_equal(out[0].final_state, ref.final_state)
    np.testing.assert_array_equal(out[0].marginals, ref.marginals)
    solo_b = execute_bucket(prog, rkey, [contb])[0]
    np.testing.assert_array_equal(out[1].final_state, solo_b.final_state)


# ---------------------------------------------------------------------------
# WorkerPool + Executor
# ---------------------------------------------------------------------------


def test_worker_pool_overlaps_and_is_deterministic():
    pool = WorkerPool(3)
    w0, s0 = pool.assign(0.0)
    assert w0 == (0,) and s0 == 0.0
    pool.commit(w0, s0, 5.0)
    w1, s1 = pool.assign(1.0)
    assert w1 == (1,) and s1 == 1.0
    pool.commit(w1, s1, 4.0)
    w2, s2 = pool.assign(1.0)
    assert w2 == (2,)
    pool.commit(w2, 1.0, 2.0)
    w3, s3 = pool.assign(1.5)
    assert w3 == (2,) and s3 == 2.0
    assert pool.busy_s == [5.0, 3.0, 1.0]


def test_worker_pool_slice_assignment():
    pool = WorkerPool(4)
    workers, start = pool.assign(0.0, width=2)
    assert workers == (0, 1) and start == 0.0
    pool.commit(workers, 0.0, 3.0)
    workers, start = pool.assign(0.0, width=2)
    assert workers == (2, 3)
    pool.commit(workers, 0.0, 1.0)
    workers, start = pool.assign(0.0, width=4)
    assert workers == (0, 1, 2, 3) and start == 3.0


def test_executor_config_validation():
    with pytest.raises(ValueError):
        ExecutorConfig(n_workers=0)
    with pytest.raises(ValueError):
        ExecutorConfig(n_workers=2, shard_width=1, shard_min_sites=16)
    with pytest.raises(ValueError):
        ExecutorConfig(n_workers=2, shard_width=4, shard_min_sites=16)
    with pytest.raises(ValueError):  # and the engine refuses it up front
        _engine({}, n_workers=2, shard_width=4, shard_min_sites=16)


def test_executor_routing_rules():
    cal = Calibrator()
    ex = Executor(
        ExecutorConfig(n_workers=4, shard_width=2, shard_min_sites=64),
        cal, (8,),
    )
    graph = t_ir.from_mrf(GridMRF(8, 8, 2))
    mrf_prog = compile_graph(graph, device=CPU)
    bn_graph = t_ir.canonicalize(random_bayesnet(6, seed=1),
                                 evidence_mode="runtime")
    bn_prog = compile_graph(bn_graph, device=CPU)
    img = np.zeros((8, 8), np.int32)
    q = Query(qid=0, model="g", image=img, n_chains=2, n_iters=2)
    mrf_key = bucket_key(q, graph, "schedule")
    assert ex.route(mrf_prog, mrf_key) == "sharded"
    pinned = dataclasses.replace(q, evidence={0: 1})
    assert ex.route(mrf_prog, bucket_key(pinned, graph, "schedule")) == \
        "vmap"
    bq = Query(qid=1, model="b", n_chains=2, n_iters=2)
    assert ex.route(bn_prog, bucket_key(bq, bn_graph, "schedule")) == "vmap"
    # unfused resumed buckets never shard; fused ones keep the route
    rq = dataclasses.replace(q, carry=object())
    assert ex.route(mrf_prog, bucket_key(rq, graph, "schedule")) == "vmap"
    assert ex.route(mrf_prog, bucket_key(rq, graph, "schedule",
                                         fused=True)) == "sharded"
    small = Executor(
        ExecutorConfig(n_workers=4, shard_width=2, shard_min_sites=1000),
        cal, (8,),
    )
    assert small.route(mrf_prog, mrf_key) == "vmap"


def test_executor_sharded_dispatch_occupies_the_slice():
    """A sharded dispatch books every worker of its slice, bills compute /
    width + comm, and really runs on the port's mesh: its labels are the
    legacy sharded engine's."""
    cal = Calibrator()
    ex = Executor(
        ExecutorConfig(n_workers=4, shard_width=2, shard_min_sites=64),
        cal, (4,),
    )
    graph = t_ir.from_mrf(GridMRF(8, 8, 2))
    prog = compile_graph(graph, device=CPU)
    img = np.zeros((8, 8), np.int32)
    qs = [Query(qid=i, model="g", image=img, n_chains=2, n_iters=2, seed=i)
          for i in range(2)]
    key = bucket_key(qs[0], graph, "schedule")
    batch, rec = ex.dispatch(prog, key, qs, 0.0)
    assert rec.route == "sharded" and rec.n_workers == 2
    assert ex.pool.busy_until[0] == ex.pool.busy_until[1] == rec.finish_s
    assert ex.pool.busy_until[2] == 0.0
    assert len(batch) == 2
    sig = sig_of(key, "sharded")
    assert cal.line_s(prog, sig, 2, shard_width=2) < \
        cal.line_s(prog, sig, 2, shard_width=1)
    # an unfused batch whose queries continue past this slice must not
    # shard: the legacy sharded engines carry no chain state
    long_qs = [dataclasses.replace(q, n_iters=8) for q in qs]
    sliced_key = bucket_key(long_qs[0], graph, "schedule", slice_iters=2)
    _, rec2 = ex.dispatch(prog, sliced_key, long_qs, 10.0,
                          return_state=True)
    assert rec2.route == "vmap" and rec2.n_workers == 1


def _grid_queries(mrf, n, n_iters=8):
    imgs = [t_mrf.make_denoising_problem(mrf.height, mrf.width,
                                         mrf.n_labels, 0.25, seed=s)[1]
            for s in range(3)]
    return [Query(qid=i, model="g", image=imgs[i % 3], n_chains=2,
                  n_iters=n_iters, seed=i, arrival_s=1e-5 * i)
            for i in range(n)]


def test_sharded_route_equals_the_vmap_route():
    """One bucket at once batched, sliced, sharded, fused and with
    diagnostics: every dispatch, continuations included, keeps the fused
    sharded route (K6 on the CPU twin, over the (1, 4) mesh), and every
    answer and quality brief equals the single-device vmap engine's,
    unsliced."""
    mrf = GridMRF(8, 8, 3, theta=1.1, h=1.5)
    eng = _engine({"g": mrf}, pad_sizes=(4,), max_batch=4, n_workers=8,
                  shard_width=4, shard_min_sites=64, fused=True,
                  diagnostics=True, slice_iters=3)
    eng.submit(_grid_queries(mrf, 6))
    res = eng.run()
    recs = eng.metrics.batch_records
    assert len(res) == 6 and len(recs) > 2
    assert all(r.route == "sharded" and r.n_workers == 4 for r in recs)
    assert all(res[q].quality is not None for q in res)
    clear_program_cache()
    ref = _engine({"g": mrf}, pad_sizes=(4,), max_batch=4, fused=True,
                  diagnostics=True)
    ref.submit(_grid_queries(mrf, 6))
    whole = ref.run()
    assert all(r.route == "vmap" for r in ref.metrics.batch_records)
    for qid in res:
        np.testing.assert_array_equal(res[qid].final_state,
                                      whole[qid].final_state)
        qa, qb = res[qid].quality, whole[qid].quality
        assert qa.keys() == qb.keys()
        for k in qa:
            x, y = qa[k], qb[k]
            assert x == y or (x != x and y != y), (k, x, y)


def test_unfused_sharded_route_runs_the_legacy_engine():
    """An unfused unpinned grid bucket on the sharded route runs the
    legacy sharded engine (per-position key folding), query by query."""
    mrf = GridMRF(8, 8, 2, theta=1.0, h=1.5)
    eng = _engine({"g": mrf}, pad_sizes=(4,), max_batch=4, n_workers=4,
                  shard_width=2, shard_min_sites=64)
    qs = _grid_queries(mrf, 2, n_iters=3)
    eng.submit(qs)
    res = eng.run()
    assert eng.metrics.summary()["sharded_batches"] >= 1
    prog = eng._program("g")
    from repro_torch import prng
    from repro_torch.core import distributed

    mesh = distributed.make_mesh((1, 2), ("data", "model"), CPU)
    for q in qs:
        want = prog.run_sharded(prng.key(q.seed), mesh, n_chains=2,
                                n_iters=3, evidence=q.image)
        np.testing.assert_array_equal(res[q.qid].final_state, want.numpy())


# ---------------------------------------------------------------------------
# Calibrator
# ---------------------------------------------------------------------------


def test_calibrator_cold_fallback_and_measured_override():
    cal = Calibrator()
    prog = compile_graph(t_ir.canonicalize(random_bayesnet(6, seed=2),
                                           evidence_mode="runtime"),
                         device=CPU)
    q = Query(qid=0, model="m", n_chains=4, n_iters=8)
    sig = sig_of(bucket_key(q, prog.ir, "schedule"))
    cold, src = cal.predict(prog, sig, 4)
    assert src == "line" and cold == cal.line_s(prog, sig, 4)
    cal.record(sig, 4, 0.125)
    warm, src = cal.predict(prog, sig, 4)
    assert src == "measured" and warm == 0.125
    assert cal.predict(prog, sig, 8)[0] == 0.125
    big = dataclasses.replace(sig, n_chains=256)
    cal.record(big, 1, 0.1)
    assert cal.predict(prog, big, 2)[0] == pytest.approx(0.2)


def _zoo(seed=7, n=24, keep=("survey", "cancer", "grid")):
    models, queries = zipf_trace(n, quick=True, seed=seed,
                                 mean_interarrival_s=5e-5)
    models = {k: v for k, v in models.items() if k in keep}
    return models, [q for q in queries if q.model in keep]


@pytest.mark.parametrize("fused", [False, True])
def test_engine_calibrate_freezes_measurements_and_stays_deterministic(
        fused):
    models, queries = _zoo(seed=3, n=16, keep=("survey", "cancer"))
    eng = _engine(models, pad_sizes=(4,), max_batch=4, fused=fused)
    eng.submit(queries)
    cal = eng.calibrate(queries)
    assert len(cal.measured) > 0
    assert all(seconds > 0 for _, seconds in cal.measured.values())
    assert all(sig.fused == fused for sig in cal.measured)
    res1 = eng.run()
    s1 = eng.metrics.summary()
    assert all(b.service_src == "measured"
               for b in eng.metrics.batch_records)
    eng2 = Engine(models, EngineConfig(pad_sizes=(4,), max_batch=4,
                                       fused=fused),
                  calibrator=cal, device=CPU)
    eng2.submit(queries)
    res2 = eng2.run()
    s2 = eng2.metrics.summary()
    for k in s1:
        if k not in ("wall_s", "calib_median_err"):
            assert s1[k] == s2[k], k
    for qid in res1:
        assert res1[qid].finish_s == res2[qid].finish_s
        np.testing.assert_array_equal(res1[qid].final_state,
                                      res2[qid].final_state)


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------


def test_admission_config_validation():
    with pytest.raises(ValueError):
        AdmissionConfig(policy="drop")
    with pytest.raises(ValueError):
        AdmissionConfig(rate_qps=0)
    with pytest.raises(ValueError):
        AdmissionConfig(queue_limit=0)


def test_token_bucket_admits_defers_and_sheds():
    ctl = AdmissionController(AdmissionConfig(rate_qps=10.0, burst=2,
                                              max_defer_s=1.0))
    assert ctl.decide(0.0, 0.0)[0] == ADMIT
    assert ctl.decide(0.0, 0.0)[0] == ADMIT
    decision, retry = ctl.decide(0.0, 0.0)
    assert decision == DEFER and retry == pytest.approx(0.1)
    assert ctl.decide(retry, 0.0)[0] == ADMIT
    assert ctl.defers == 1 and ctl.shed_tokens == 0
    decision, _ = ctl.decide(retry, retry - 1.0)
    assert decision == SHED and ctl.shed_tokens == 1


def test_token_bucket_shed_policy_and_open_admission():
    ctl = AdmissionController(AdmissionConfig(rate_qps=1.0, burst=1,
                                              policy="shed"))
    assert ctl.decide(0.0, 0.0)[0] == ADMIT
    assert ctl.decide(0.0, 0.0)[0] == SHED
    open_ctl = AdmissionController(None)
    assert all(open_ctl.decide(0.0, 0.0)[0] == ADMIT for _ in range(100))


def test_queue_bounds():
    ctl = AdmissionController(AdmissionConfig(queue_limit=3))
    assert not ctl.queue_full(2)
    assert ctl.queue_full(3)
    ctl.record_shed(7, by_queue=True)
    assert ctl.sheds == 1 and ctl.shed_queue == 1
    assert AdmissionController(None).queue_full(10 ** 9) is False


def _bursty(trace):
    models, queries = trace(30, quick=True, seed=2)
    keep = {"survey", "grid"}
    return ({k: v for k, v in models.items() if k in keep},
            [q for q in queries if q.model in keep])


def test_engine_bounded_queues_match_the_reference_engine():
    """Saturating bursty arrivals against a bounded 2-worker engine: every
    pending queue stays within the limit, served + shed covers every
    query, and the port's engine makes the reference's decisions: the same
    shed queries, the same sim-clock summary, the same answers."""
    adm = dict(rate_qps=2000.0, burst=4, queue_limit=3, policy="shed")
    kw = dict(pad_sizes=(4,), max_batch=4, n_workers=2)
    models, queries = _bursty(bursty_trace)
    eng = _engine(models, admission=AdmissionConfig(**adm), **kw)
    eng.submit(queries)
    res = eng.run()
    s = eng.metrics.summary()
    assert s["sheds"] > 0
    assert len(res) + s["sheds"] == len(queries)
    assert set(eng.shed_qids).isdisjoint(res)
    assert s["max_queue_depth"] <= 3

    r_clear()
    r_models, r_queries = _bursty(r_bursty_trace)
    ref = REngine(r_models, RConfig(admission=RAdmission(**adm), **kw))
    ref.submit(r_queries)
    r_res = ref.run()
    r_clear()
    assert ref.shed_qids == eng.shed_qids
    r_s = ref.metrics.summary()
    for k in s:
        if k not in ("wall_s", "calib_median_err"):
            assert s[k] == r_s[k], k
    for qid, r in r_res.items():
        np.testing.assert_array_equal(res[qid].final_state,
                                      np.asarray(r.final_state))
        assert res[qid].finish_s == r.finish_s


# ---------------------------------------------------------------------------
# Engine: multi-worker overlap + continuous batching
# ---------------------------------------------------------------------------


def test_multi_worker_qps_beats_serial_and_preserves_bits():
    m1, q1 = _zoo()
    e1 = _engine(m1, pad_sizes=(4,), max_batch=4, n_workers=1)
    e1.submit(q1)
    r1 = e1.run()
    m4, q4 = _zoo()
    e4 = _engine(m4, pad_sizes=(4,), max_batch=4, n_workers=4, fused=True)
    e4.submit(q4)
    r4 = e4.run()
    s1, s4 = e1.metrics.summary(), e4.metrics.summary()
    assert s4["throughput_qps"] > s1["throughput_qps"]
    assert s4["latency_p95_s"] <= s1["latency_p95_s"]
    for qid in r1:
        np.testing.assert_array_equal(r1[qid].final_state,
                                      r4[qid].final_state)
    assert len(s4["worker_util"]) == 4
    assert sum(e4.metrics.worker_busy_s) > 0


@pytest.mark.parametrize("fused", [False, True])
def test_engine_sliced_serving_bit_exact_with_unsliced(fused):
    m_a, q_a = _zoo(seed=9)
    e_a = _engine(m_a, pad_sizes=(4,), max_batch=4, fused=fused)
    e_a.submit(q_a)
    r_a = e_a.run()
    m_b, q_b = _zoo(seed=9)
    e_b = _engine(m_b, pad_sizes=(4,), max_batch=4, fused=fused,
                  slice_iters=5)
    e_b.submit(q_b)
    r_b = e_b.run()
    assert sorted(r_a) == sorted(r_b)
    assert e_b.metrics.summary()["n_batches"] > \
        e_a.metrics.summary()["n_batches"]
    for qid in r_a:
        np.testing.assert_array_equal(r_a[qid].final_state,
                                      r_b[qid].final_state)
        if r_a[qid].marginals is not None:
            np.testing.assert_array_equal(r_a[qid].marginals,
                                          r_b[qid].marginals)


def test_slicing_interleaves_short_queries_between_long_slices():
    bn = bn_repository_replica("survey")
    long_q = Query(qid=0, model="m", evidence={0: 1}, n_chains=2,
                   n_iters=24, burn_in=0, seed=1, arrival_s=0.0)
    short_q = Query(qid=1, model="m", evidence={0: 1}, n_chains=2,
                    n_iters=4, burn_in=0, seed=2, arrival_s=1e-5)

    def serve(slice_iters):
        eng = _engine({"m": bn}, pad_sizes=(2,), max_batch=2, window_s=1e-6,
                      slice_iters=slice_iters, fused=True)
        eng.submit([dataclasses.replace(long_q),
                    dataclasses.replace(short_q)])
        return eng.run()

    unsliced = serve(None)
    sliced = serve(4)
    assert sliced[1].finish_s < unsliced[1].finish_s
    np.testing.assert_array_equal(unsliced[0].final_state,
                                  sliced[0].final_state)


def test_continuations_respect_queue_bound_without_starving():
    bn = bn_repository_replica("survey")
    queries = [
        Query(qid=i, model="m", evidence={0: 1}, n_chains=2,
              n_iters=12, burn_in=0, seed=i, arrival_s=1e-6 * i)
        for i in range(6)
    ]
    eng = _engine({"m": bn}, pad_sizes=(4,), max_batch=4, window_s=5e-4,
                  slice_iters=4, admission=AdmissionConfig(queue_limit=2))
    eng.submit(queries)
    res = eng.run()
    s = eng.metrics.summary()
    assert len(res) + s["sheds"] == len(queries)
    assert s["max_queue_depth"] <= 2
    ref = _engine({"m": bn}, pad_sizes=(4,), max_batch=4)
    ref.submit([dataclasses.replace(q) for q in queries])
    whole = ref.run()
    for qid in res:
        np.testing.assert_array_equal(res[qid].final_state,
                                      whole[qid].final_state)


def test_lone_overflow_continuation_terminates():
    bn = bn_repository_replica("survey")
    queries = [
        Query(qid=0, model="m", evidence={0: 1}, n_chains=2, n_iters=8,
              burn_in=0, seed=1, arrival_s=0.0),
        Query(qid=1, model="m", evidence={0: 1}, n_chains=2, n_iters=8,
              burn_in=0, seed=2, arrival_s=0.0),
        Query(qid=2, model="m", evidence={0: 1}, n_chains=2, n_iters=8,
              burn_in=0, seed=3, arrival_s=3e-4),
    ]
    eng = _engine({"m": bn}, pad_sizes=(4,), max_batch=4, window_s=2e-4,
                  slice_iters=4, n_workers=2,
                  admission=AdmissionConfig(queue_limit=2))
    eng.submit(queries)
    res = eng.run()
    s = eng.metrics.summary()
    assert len(res) + s["sheds"] == 3
    assert s["max_queue_depth"] <= 2


def test_engine_rejects_bad_queries_and_defaults_to_the_card():
    models, _ = _zoo()
    eng = _engine(models, pad_sizes=(4,), max_batch=4)
    with pytest.raises(KeyError):
        eng.submit([Query(qid=0, model="nope")])
    with pytest.raises(ValueError):  # MRF query without an image
        eng.submit([Query(qid=1, model="grid")])
    with pytest.raises(ValueError):  # evidence out of range
        eng.submit([Query(qid=2, model="survey", evidence={0: 99})])
    with pytest.raises(ValueError):
        _engine(models, backend="pallas")
    with pytest.raises(ValueError):
        _engine(models, backend="eager", fused=True)
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine(models)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def test_percentiles_refuse_tiny_samples():
    assert percentile([], 50) is None
    assert percentile([1.0], 95) is None
    assert percentile([1.0, 3.0], 50) == 2.0


def test_summary_reports_na_on_empty_and_singleton_runs():
    from repro_torch.runtime.batcher import QueryResult

    m = RuntimeMetrics()
    s = m.summary()
    assert s["latency_p50_s"] is None and s["latency_p95_s"] is None
    assert s["latency_mean_s"] is None and s["throughput_qps"] == 0.0
    assert s["mean_batch"] is None
    assert "n/a" in m.table()
    m.record_queries([QueryResult(
        qid=0, model="m", kind="bn", marginals=None,
        final_state=np.zeros(1), arrival_s=0.0, start_s=1.0, finish_s=2.0,
    )])
    m.record_batch(BatchRecord(model="m", kind="bn", n_real=1, n_padded=1,
                               service_s=1.0, clamp_lowerings=0))
    s = m.summary()
    assert s["latency_p50_s"] is None and s["latency_p95_s"] is None
    assert s["latency_mean_s"] == pytest.approx(2.0)
    assert s["n_queries"] == 1


def test_summary_surfaces_workers_and_backpressure():
    m = RuntimeMetrics()
    m.worker_busy_s = (1.0, 3.0)
    m.sheds, m.shed_queue, m.defers, m.max_queue_depth = 2, 1, 5, 7
    s = m.summary()
    assert s["n_workers"] == 2 and len(s["worker_util"]) == 2
    assert s["sheds"] == 2 and s["defers"] == 5
    assert s["max_queue_depth"] == 7
    assert "| 2 | 5 | 7 |" in m.table()


def test_fused_mrf_bucket_launches_no_kernel_on_the_cpu():
    """On CPU tensors the lane entries run their twins: no launch is
    counted, and a CUDA tensor would be needed for one."""
    mrf = GridMRF(8, 8, 3)
    before = mrf_gibbs.mrf_half_step_lanes.launches
    eng = _engine({"g": mrf}, pad_sizes=(4,), max_batch=4, fused=True)
    eng.submit(_grid_queries(mrf, 3, n_iters=2))
    assert len(eng.run()) == 3
    assert mrf_gibbs.mrf_half_step_lanes.launches == before
