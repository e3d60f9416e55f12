"""The port's serving runtime (`repro_torch.runtime`) against the
reference's (`repro.runtime`), and the lane-batched pieces under it.

  * The port's Engine and the reference's serve the same quick Zipf trace
    (`zipf_trace(quick=True)`: 60 queries on survey, cancer, asia and an
    8 x 8 grid, lut_ky, 4 chains x 16 sweeps): every answer bit-equal and
    the sim-clock metrics series byte-identical.  The reference runs its
    default unfused, jitted buckets; the port runs unfused (queries one
    after another) and fused (one K3 / K4 lane launch per sweep or
    half-step, through the twins here).
  * A fused bucket's lane equals the same query run alone, fresh and
    resumed, and a resumed bucket may mix lanes at different sweep counts
    `t`.
  * K3's and K4's lane twins against the per-key twins, query by query;
    the kernels against the twins on the card (`cuda` marker).
  * `prng.split_many` against `prng.split` and `jax.random.split`.

Inputs come from numpy seeds.  Tolerance: bit-equal throughout."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.compile import clear_program_cache as r_clear
from repro.runtime import Engine as REngine
from repro.runtime import EngineConfig as RConfig
from repro.runtime import zipf_trace as r_zipf_trace
from repro_torch import prng
from repro_torch.compile import backend
from repro_torch.compile import ir as t_ir
from repro_torch.compile.program import clear_program_cache as t_clear
from repro_torch.compile.program import compile_graph
from repro_torch.core import bayesnet as t_bn
from repro_torch.core import mrf as t_mrf
from repro_torch.core.graphs import GridMRF, bn_repository_replica
from repro_torch.kernels import bn_gibbs, mrf_gibbs
from repro_torch.runtime import (
    Engine,
    EngineConfig,
    Query,
    bucket_key,
    execute_bucket,
    zipf_trace,
)


@pytest.fixture(autouse=True)
def _fresh_cache():
    t_clear()
    yield
    t_clear()


@pytest.fixture(scope="module")
def reference_serving():
    """The reference engine over the quick Zipf trace: results and the
    metrics series' JSONL."""
    r_clear()
    models, queries = r_zipf_trace(quick=True)
    eng = REngine(models, RConfig())
    eng.submit(queries)
    res = eng.run()
    r_clear()
    return res, eng.metrics.series.to_jsonl()


@pytest.mark.parametrize("fused", [False, True])
def test_engine_matches_the_reference_engine(reference_serving, fused):
    ref, ref_series = reference_serving
    models, queries = zipf_trace(quick=True)
    eng = Engine(models, EngineConfig(fused=fused), device="cpu")
    eng.submit(queries)
    res = eng.run()
    assert sorted(res) == sorted(ref)
    for qid, r in ref.items():
        got = res[qid]
        np.testing.assert_array_equal(got.final_state,
                                      np.asarray(r.final_state))
        if r.marginals is None:
            assert got.marginals is None
        else:
            np.testing.assert_array_equal(got.marginals,
                                          np.asarray(r.marginals))
        assert (got.start_s, got.finish_s, got.batch_size) == (
            r.start_s, r.finish_s, r.batch_size)
    assert eng.metrics.series.to_jsonl() == ref_series
    if fused:
        assert any(b.n_real > 1 for b in eng.metrics.batch_records)


def _bn_queries(n, n_iters=7, **kw):
    bn = bn_repository_replica("alarm")
    rng = np.random.default_rng(3)
    nodes = rng.choice(bn.n_nodes, size=5, replace=False)
    return bn, [
        Query(qid=i, model="m", n_chains=5, n_iters=n_iters, burn_in=2,
              thin=2,
              seed=int(rng.integers(1 << 30)),
              evidence={int(v): int(rng.integers(bn.cards[v]))
                        for v in nodes}, **kw)
        for i in range(n)
    ]


@pytest.mark.parametrize("fused", [False, True])
def test_bn_bucket_lane_equals_the_query_alone(fused):
    bn, queries = _bn_queries(3)
    graph = t_ir.canonicalize(bn, evidence_mode="runtime")
    prog = compile_graph(graph, pipeline="runtime", device="cpu")
    key = bucket_key(queries[0], graph, "schedule", fused=fused)
    assert key.fused == fused
    launches = bn_gibbs.bn_sweep_lanes.launches
    out = execute_bucket(prog, key, queries)
    assert bn_gibbs.bn_sweep_lanes.launches == launches  # CPU: the twin
    for q, r in zip(queries, out):
        marg, vals = prog.run(
            prng.key(q.seed), n_chains=5, n_iters=7, burn_in=2, thin=2,
            evidence=q.evidence, fused=fused, device="cpu")
        np.testing.assert_array_equal(r.final_state, vals.numpy())
        np.testing.assert_array_equal(r.marginals, marg.numpy())


@pytest.mark.parametrize("kind", ["bn", "mrf"])
def test_bucket_lanes_across_key_split_chunks(kind):
    """A bucket splits its keys SPLIT_CHUNK iterations at a time inside
    the loop: over two whole chunks and a partial one, each lane still
    equals its query run alone."""
    n = 2 * backend.SPLIT_CHUNK + 3
    if kind == "bn":
        bn, queries = _bn_queries(2, n_iters=n)
        graph = t_ir.canonicalize(bn, evidence_mode="runtime")
        kw = dict(n_chains=5, burn_in=2, thin=2)
    else:
        graph = t_ir.from_mrf(GridMRF(6, 8, 4, theta=1.2, h=2.0))
        queries = [Query(qid=i, model="g", n_chains=2, n_iters=n,
                         seed=5 + i, image=t_mrf.make_denoising_problem(
                             6, 8, 4, 0.25, seed=i)[1]) for i in range(2)]
        kw = dict(n_chains=2)
    prog = compile_graph(graph, pipeline="runtime", device="cpu")
    key = bucket_key(queries[0], graph, "schedule", fused=True)
    assert key.fused and key.n_iters == n
    for q, r in zip(queries, execute_bucket(prog, key, queries)):
        ev = q.evidence if kind == "bn" else q.image
        out = prog.run(prng.key(q.seed), n_iters=n, evidence=ev, fused=True,
                       device="cpu", **kw)
        if kind == "bn":
            np.testing.assert_array_equal(r.marginals, out[0].numpy())
            out = out[1]
        np.testing.assert_array_equal(r.final_state, out.numpy())


def test_mrf_bucket_lane_equals_the_query_alone():
    mrf = GridMRF(9, 7, 3, theta=1.1, h=1.6)
    graph = t_ir.from_mrf(mrf)
    prog = compile_graph(graph, pipeline="runtime", device="cpu")
    rng = np.random.default_rng(4)
    queries = [
        Query(qid=i, model="g", n_chains=3, n_iters=4, seed=11 + i,
              image=t_mrf.make_denoising_problem(9, 7, 3, 0.3, seed=i)[1],
              evidence={int(s): int(rng.integers(3))
                        for s in rng.choice(63, size=4, replace=False)})
        for i in range(3)
    ]
    key = bucket_key(queries[0], graph, "schedule", fused=True)
    assert key.fused and key.has_pins
    out = execute_bucket(prog, key, queries)
    for q, r in zip(queries, out):
        lab = prog.run(prng.key(q.seed), n_chains=3, n_iters=4,
                       evidence=q.image, pins=q.evidence, fused=True,
                       device="cpu")
        np.testing.assert_array_equal(r.final_state, lab.numpy())
        for site, val in q.evidence.items():
            assert (r.final_state[:, site // 7, site % 7] == val).all()


@pytest.mark.parametrize("kind", ["bn", "mrf"])
def test_resumed_bucket_mixes_lanes_at_different_t(kind):
    """Query A sliced 3 + 4, query B 1 + 4 + 2: their 4-sweep slices
    (A at t=3, B at t=1) share one resumed bucket, and each lane still
    ends on its uninterrupted run's bits (marginals included: the
    burn-in/thinning gate is per lane)."""
    if kind == "bn":
        bn, (qa, qb) = _bn_queries(2)
        graph = t_ir.canonicalize(bn, evidence_mode="runtime")
    else:
        mrf = GridMRF(6, 8, 4, theta=1.2, h=2.0)
        graph = t_ir.from_mrf(mrf)
        qa, qb = [Query(qid=i, model="g", n_chains=2, n_iters=7, seed=5 + i,
                        image=t_mrf.make_denoising_problem(6, 8, 4, 0.25,
                                                           seed=i)[1])
                  for i in range(2)]
    prog = compile_graph(graph, pipeline="runtime", device="cpu")

    def run(qs, n, resumed=False):
        q0 = dataclasses.replace(qs[0], n_iters=n)
        key = bucket_key(q0, graph, "schedule", fused=True)
        key = dataclasses.replace(key, resumed=resumed)
        assert key.fused
        return execute_bucket(prog, key, qs, return_state=True)

    whole = run([qa, qb], 7)
    (ra,) = run([qa], 3)
    (rb,) = run([qb], 1)
    assert ra.carry.__class__ is (t_bn.BNChainState if kind == "bn"
                                  else t_mrf.MRFChainState)
    ca = dataclasses.replace(qa, carry=ra.carry, n_iters=4)
    cb = dataclasses.replace(qb, carry=rb.carry, n_iters=6)
    if kind == "bn":
        assert (ca.carry.t, cb.carry.t) == (3, 1)
    ra2, rb2 = run([ca, cb], 4, resumed=True)
    if kind == "bn":
        assert (ra2.carry.t, rb2.carry.t) == (7, 5)
    cb2 = dataclasses.replace(qb, carry=rb2.carry, n_iters=2)
    (rb3,) = run([cb2], 2, resumed=True)
    for got, want in ((ra2, whole[0]), (rb3, whole[1])):
        np.testing.assert_array_equal(got.final_state, want.final_state)
        if kind == "bn":
            np.testing.assert_array_equal(got.marginals, want.marginals)


@pytest.mark.parametrize("sampler", ["lut_ky", "exact_ky"])
def test_k3_lane_twin_equals_the_per_key_twin(sampler):
    cbn = t_bn.compile_bayesnet(bn_repository_replica("insurance"),
                                device="cpu")
    fr = bn_gibbs.build_fused_rounds(cbn.groups)
    p = bn_gibbs.sweep_params(cbn, sampler)
    b, q = 3, 4
    vals = torch.cat([t_bn.init_chain_values(cbn, prng.key(i), b)[0]
                      for i in range(q)])
    keys = [prng.key(9 + i) for i in range(q - 1)] + [
        prng.Key(0xFFFFFFFF, 0x1234)]
    got = bn_gibbs.bn_sweep_lanes(cbn, fr, vals, prng.key_tensor(keys, "cpu"), sampler,
                                  p)
    for i, k in enumerate(keys):
        want = bn_gibbs.bn_sweep(cbn, fr, vals[i * b:(i + 1) * b], k,
                                 sampler, p)
        assert torch.equal(got[i * b:(i + 1) * b], want)
    with pytest.raises(ValueError):  # 12 chains do not split into 5
        bn_gibbs.bn_sweep_lanes(cbn, fr, vals, prng.key_tensor(keys + keys[:1], "cpu"),
                                sampler, p)


def test_k4_lane_twin_equals_the_per_key_twin():
    mrf = GridMRF(7, 9, 5, theta=0.8, h=1.4, data_cost="quadratic")
    tab, spec = t_mrf.build_exp_weight_lut(device="cpu")
    p = mrf_gibbs.half_step_params(mrf)
    b, q = 2, 3
    labels = prng.randint(prng.key(1), (q * b, 7, 9), 0, 5, "cpu")
    evs = torch.stack([torch.from_numpy(
        t_mrf.make_denoising_problem(7, 9, 5, 0.3, seed=i)[1])
        for i in range(q)])
    keys = [prng.key(20 + i) for i in range(q)]
    for parity in (0, 1):
        got = mrf_gibbs.mrf_half_step_lanes(mrf, labels, evs,
                                            prng.key_tensor(keys, "cpu"), parity, tab,
                                            spec, p)
        for i, k in enumerate(keys):
            want = mrf_gibbs.mrf_half_step(mrf, labels[i * b:(i + 1) * b],
                                           evs[i], k, parity, tab, spec, p)
            assert torch.equal(got[i * b:(i + 1) * b], want)
    with pytest.raises(ValueError):  # one evidence plane per query
        mrf_gibbs.mrf_half_step_lanes(mrf, labels, evs[:2], prng.key_tensor(keys, "cpu"),
                                      0, tab, spec, p)


def test_split_many_equals_split_and_jax():
    rng = np.random.default_rng(0)
    keys = [prng.key(int(s)) for s in rng.integers(0, 2**32, 40)]
    keys += [prng.Key(int(a), int(b))
             for a, b in rng.integers(0, 2**32, (40, 2))]
    arr = prng.key_array(keys)
    # the kernels' key arrays: int32 bit patterns, and back
    assert prng.keys_of(prng.key_tensor(keys, "cpu")) == keys
    assert prng.keys_of(arr) == keys
    for num in (1, 2, 3, 5, 16):
        out = prng.split_many(arr, num)
        assert out.shape == (len(keys), num, 2)
        for k, row in zip(keys, out):
            assert prng.keys_of(row) == list(prng.split(k, num))
            jk = jax.random.wrap_key_data(
                np.asarray([k.k1, k.k2], np.uint32))
            want = np.asarray(jax.random.key_data(jax.random.split(jk, num)))
            np.testing.assert_array_equal(row, want.astype(np.int64))


def test_fused_fits_on_hopper_shared_memory():
    from repro_torch.analysis import kernel_lint

    alarm = t_ir.canonicalize(bn_repository_replica("alarm"),
                              evidence_mode="runtime")
    assert kernel_lint.fused_fits(alarm, 1024)
    # a grid whose two label rows, halo rows and LUT exceed 227 KB
    wide = t_ir.from_mrf(GridMRF(2, 20000, 2))
    assert not kernel_lint.fused_fits(wide, 4)
    assert not bucket_key(Query(qid=0, model="w", n_chains=4), wide,
                          "schedule", fused=True).fused
    assert kernel_lint.fused_fits(t_ir.from_mrf(GridMRF(64, 64, 4)), 1024)


@pytest.mark.cuda
def test_k3_lanes_matches_its_twin_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    dev = torch.device("cuda")
    cbn = t_bn.compile_bayesnet(bn_repository_replica("hailfinder"),
                                device=dev)
    fr = bn_gibbs.build_fused_rounds(cbn.groups)
    p = bn_gibbs.sweep_params(cbn, "lut_ky")
    for b, q in ((300, 3), (7, 5)):
        vals = torch.cat([t_bn.init_chain_values(cbn, prng.key(i), b)[0]
                          for i in range(q)])
        keys = prng.key_tensor([prng.key(40 + i) for i in range(q)], dev)
        got = bn_gibbs.bn_sweep_lanes(cbn, fr, vals, keys, "lut_ky", p)
        want = bn_gibbs.bn_sweep_lanes_ref(cbn, fr, vals, keys, "lut_ky", p)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_k4_lanes_matches_its_twin_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    dev = torch.device("cuda")
    mrf = GridMRF(37, 45, 6, theta=1.2, h=2.0)
    tab, spec = t_mrf.build_exp_weight_lut(device=dev)
    p = mrf_gibbs.half_step_params(mrf)
    b, q = 16, 3
    labels = prng.randint(prng.key(1), (q * b, 37, 45), 0, 6, dev)
    evs = torch.stack([torch.from_numpy(
        t_mrf.make_denoising_problem(37, 45, 6, 0.3, seed=i)[1])
        for i in range(q)]).to(dev)
    keys = prng.key_tensor([prng.key(7 + i) for i in range(q)], dev)
    for parity in (0, 1):
        got = mrf_gibbs.mrf_half_step_lanes(mrf, labels, evs, keys, parity,
                                            tab, spec, p)
        want = mrf_gibbs.mrf_half_step_lanes_ref(mrf, labels, evs, keys,
                                                 parity, tab, spec, p)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
