"""The port's quality accumulator, snapshot and new samplers against the
reference: `diag.accum.update` against the reference's (jitted) on the same
one-hot stream, `summarize` on the same moments, `run(diagnostics=True)`
on both packages, sliced diagnostics against whole, `prng.uniform` and
`prng.gumbel` against `jax.random`, and the exact_ky/cdf/gumbel samplers
against exact variable elimination.

Tolerances: counts and kept-draw bookkeeping exact.  Welford `mean` and
`bm_mean` to atol 1e-6, `m2` and `bm_m2` to rtol 1e-5 (atol 1e-6 for cells
near zero): XLA may fuse the update's multiply-adds, where torch rounds each
op, so the float32 moments can differ in their last bits.  `uniform` is
bit-equal; `gumbel` goes through torch's logs, held to rtol 1e-6.
Marginals of exact_ky, cdf and gumbel (transcendental float ops, different
last bits on each side) are held to per-node TV 0.05 of variable
elimination, the repo's quickstart gate; at 64 chains x 400 sweeps the
sampling noise is about 0.01."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compile import clear_program_cache as r_clear
from repro.compile import compile_graph as r_compile_graph
from repro.core import graphs as r_graphs
from repro.diag import accum as r_accum
from repro_torch import convert, prng
from repro_torch.compile import ir as t_ir
from repro_torch.compile import program as t_program
from repro_torch.core import graphs as t_graphs
from repro_torch.core import mrf as t_mrf
from repro_torch.core.exact import ve_marginal
from repro_torch.diag import accum as t_accum
from repro_torch.diag import oracle as t_oracle

_r_update = jax.jit(r_accum.update)
MOMENTS = ("mean", "m2", "bm_mean", "bm_m2", "cur_sum")


@pytest.fixture(autouse=True)
def _fresh_caches():
    t_program.clear_program_cache()
    r_clear()
    yield
    t_program.clear_program_cache()
    r_clear()


def _key(seed):
    jk = jax.random.key(seed)
    return jk, convert.key_from_reference(
        np.asarray(jax.random.key_data(jk)))


def _stream(seed, sweeps=23, b=3, s=5, v=4):
    """A one-hot stream with a burn-in/thinning-like keep gate."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, v, (sweeps, b, s))
    onehot = (labels[..., None] == np.arange(v)).astype(np.int32)
    keep = (np.arange(sweeps) >= 3) & (np.arange(sweeps) % 2 == 1)
    return onehot, keep


def _accumulate(seed, batch_len):
    onehot, keep = _stream(seed)
    total = int(keep.sum())
    _, b, s, v = onehot.shape
    rq = r_accum.make_accum(b, s, v, total, batch_len)
    tq = t_accum.make_accum(b, s, v, total, batch_len, device="cpu")
    for x, k in zip(onehot, keep):
        rq = _r_update(rq, jnp.asarray(x), jnp.asarray(bool(k)))
        tq = t_accum.update(tq, torch.from_numpy(x), bool(k))
    return rq, tq


@pytest.mark.parametrize("batch_len", [2, 3, 8])
def test_update_moments_match_reference(batch_len):
    rq, tq = _accumulate(batch_len, batch_len)
    assert list(tq.counts) == np.asarray(rq.counts).tolist()
    for name in ("split_at", "batch_len", "bm_count", "cur_n"):
        assert getattr(tq, name) == int(np.asarray(getattr(rq, name))), name
    for name in MOMENTS:
        got = getattr(tq, name).numpy()
        want = np.asarray(getattr(rq, name))
        if name in ("m2", "bm_m2"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=name)


def _same_snapshot(a, b, exact=True):
    tol = dict(rtol=0, atol=0) if exact else dict(rtol=1e-4, atol=1e-6)
    for name in ("kept", "n_chains", "split_at", "batch_len", "n_batches",
                 "overflow_risk", "finite"):
        assert getattr(a, name) == getattr(b, name), name
    np.testing.assert_allclose(a.rhat, b.rhat, equal_nan=True, **tol)
    np.testing.assert_allclose(a.p_hat, b.p_hat, equal_nan=True, **tol)
    assert (a.ess is None) == (b.ess is None)
    if a.ess is not None:
        np.testing.assert_allclose(a.ess, b.ess, equal_nan=True, **tol)


def test_summarize_matches_reference_on_the_same_moments():
    _, tq = _accumulate(5, 3)
    rq = r_accum.QualityAccum(
        counts=jnp.asarray(tq.counts, jnp.int32),
        **{n: jnp.asarray(getattr(tq, n).numpy()) for n in MOMENTS},
        split_at=jnp.asarray(tq.split_at, jnp.int32),
        batch_len=jnp.asarray(tq.batch_len, jnp.int32),
        bm_count=jnp.asarray(tq.bm_count, jnp.int32),
        cur_n=jnp.asarray(tq.cur_n, jnp.int32),
    )
    cards = np.array([4, 2, 3, 4, 1])
    free = np.array([True, True, False, True, True])
    want = r_accum.summarize(rq, cards=cards, free_mask=free, total_kept=9)
    got = t_accum.summarize(tq, cards=cards, free_mask=free, total_kept=9)
    _same_snapshot(got, want)
    assert got.to_dict() == want.to_dict()


def test_diagnostics_run_matches_reference_and_leaves_draws_alone():
    net = "asia"
    kw = dict(n_chains=8, n_iters=30, burn_in=6, thin=2)
    jk, k = _key(4)
    r_prog = r_compile_graph(r_graphs.bn_repository_replica(net))
    t_prog = t_program.compile_graph(t_graphs.bn_repository_replica(net),
                                     device="cpu")
    rm, rv, rsnap = r_prog.run(jk, diagnostics=True, **kw)
    tm, tv, tsnap = t_prog.run(k, diagnostics=True, fused=True,
                               device="cpu", **kw)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(rm))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    _same_snapshot(tsnap, rsnap, exact=False)
    m0, v0 = t_prog.run(k, device="cpu", **kw)
    assert torch.equal(m0, tm) and torch.equal(v0, tv)


def test_sliced_diagnostics_equal_whole():
    """A query's accumulator is made from its *total* budget (`diag_total`)
    on the first slice, as the reference's serving path makes it; the
    slices then accumulate exactly what the whole run does."""
    from repro_torch.compile import backend as t_backend
    from repro_torch.core import bayesnet as t_bn

    # BN, burn-in and thinning across the slice point, fused
    cbn = t_bn.compile_bayesnet(t_graphs.bn_repository_replica("cancer"),
                                evidence={1: 0}, device="cpu")
    kw = dict(burn_in=4, sampler="lut_ky", thin=3, fused=True)
    vals, key = t_bn.init_chain_values(cbn, prng.key(1), 5)
    m, v, st = t_bn.gibbs_run_loop(cbn, cbn.groups, vals, key, 40,
                                   return_state=True, diag_total=40, **kw)
    _, _, st1 = t_bn.gibbs_run_loop(cbn, cbn.groups, vals, key, 17,
                                    return_state=True, diag_total=40, **kw)
    m2, v2, st2 = t_bn.gibbs_run_loop(cbn, cbn.groups, None, None, 23,
                                      carry=st1, return_state=True, **kw)
    assert torch.equal(m, m2) and torch.equal(v, v2)
    total = t_accum.kept_count(40, 4, 3)
    snap = t_accum.summarize(st.quality, total_kept=total)
    _same_snapshot(t_accum.summarize(st2.quality, total_kept=total), snap)
    assert snap.finite and snap.kept == total
    # MRF, pins, the fused schedule path
    tm = t_graphs.GridMRF(7, 10, 3, theta=1.2, h=2.0)
    _, noisy = t_mrf.make_denoising_problem(7, 10, 3, 0.25, seed=2)
    prog = t_program.compile_graph(tm, device="cpu")
    ex = t_backend.lower_schedule(prog)
    pin_mask, pin_vals = t_backend.pin_arrays(tm, {0: 1, 13: 2}, "cpu")
    kw = dict(n_chains=4, fused=True, pin_mask=pin_mask, pin_vals=pin_vals,
              return_state=True)
    ev = torch.from_numpy(noisy)
    lab, st = t_backend.run_mrf_schedule(ex, ev, prng.key(2), n_iters=19,
                                         diag_total=19, **kw)
    _, st1 = t_backend.run_mrf_schedule(ex, ev, prng.key(2), n_iters=11,
                                        diag_total=19, **kw)
    lab2, st2 = t_backend.run_mrf_schedule(ex, ev, None, n_iters=8,
                                           carry=st1, **kw)
    assert torch.equal(lab, lab2)
    snap = t_accum.summarize(st.quality, total_kept=19)
    _same_snapshot(t_accum.summarize(st2.quality, total_kept=19), snap)
    assert snap.p_hat.shape == (70, 3) and snap.kept == 19
    np.testing.assert_array_equal(snap.p_hat[13], [0.0, 0.0, 1.0])
    # program.run: a resumed run needs a carry that has the accumulator
    _, st0 = prog.run(prng.key(2), n_iters=2, evidence=noisy,
                      return_state=True, device="cpu")
    with pytest.raises(ValueError):
        prog.run(None, n_iters=2, evidence=noisy, carry_state=st0,
                 diagnostics=True, device="cpu")
    lab3, snap3 = prog.run(prng.key(2), n_iters=19, evidence=noisy,
                           pins={0: 1, 13: 2}, n_chains=4, fused=True,
                           diagnostics=True, device="cpu")
    assert torch.equal(lab3, lab)
    _same_snapshot(snap3, snap)


@pytest.mark.parametrize("shape", [(1000,), (7, 33), (4, 5, 6)])
def test_uniform_and_gumbel_match_jax(shape):
    jk, k = _key(sum(shape))
    want = np.asarray(jax.random.uniform(jk, shape, jnp.float32))
    got = prng.uniform(k, shape, device="cpu").numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    tiny = float(np.finfo(np.float32).tiny)
    want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, tiny, 1.0))
    got = prng.uniform(k, shape, tiny, 1.0, device="cpu").numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    want = np.asarray(jax.random.gumbel(jk, shape, jnp.float32))
    got = prng.gumbel(k, shape, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sampler", ["exact_ky", "cdf", "gumbel"])
def test_samplers_within_tv_of_exact_marginals(sampler):
    asia = t_graphs.bn_repository_replica("asia")
    ev = {0: 1, 5: 0}
    prog = t_program.compile_graph(
        t_ir.canonicalize(asia, evidence_mode="runtime"), device="cpu")
    marg, _, snap = prog.run(prng.key(3), evidence=ev, n_chains=64,
                             n_iters=400, burn_in=80, sampler=sampler,
                             diagnostics=True, device="cpu")
    for q in range(asia.n_nodes):
        if q in ev:
            continue
        exact = ve_marginal(asia, q, ev)
        tv = 0.5 * np.abs(snap.p_hat[q, :asia.cards[q]] - exact).sum()
        assert tv <= 0.05, (sampler, q, tv)
        np.testing.assert_allclose(marg[q, :asia.cards[q]].numpy(),
                                   snap.p_hat[q, :asia.cards[q]], atol=1e-5)
    assert snap.rhat_max is not None and snap.rhat_max < 1.1
    audit = t_oracle.oracle_audit(asia, snap.p_hat, ev)
    assert audit["status"] == "ok" and audit["tv_max"] <= 0.05


def test_oracle_matches_reference():
    from repro.diag import oracle as r_oracle

    for name in ("asia", "cancer"):
        r_net = r_graphs.bn_repository_replica(name)
        t_net = t_graphs.bn_repository_replica(name)
        assert t_oracle.ve_cost_estimate(t_net) == r_oracle.ve_cost_estimate(
            r_net)
        for sampler in ("lut_ky", "exact_ky"):
            want = r_oracle.ky_quantization_tv(r_net, sampler)["tv"]
            got = t_oracle.ky_quantization_tv(t_net, sampler)["tv"]
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
