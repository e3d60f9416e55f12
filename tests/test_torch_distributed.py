"""The port's sharded execution (`core/distributed.py`,
`CompiledProgram.run_sharded`) on meshes of CPU positions:

  * `prng.fold_in` against `jax.random.fold_in`, bit for bit;
  * the fused route against the port's own single-device fused run, bit
    for bit, on (1, 1), (1, 2) and (2, 4) meshes: BN lut_ky and exact_ky
    with burn-in and thinning mid-stride, MRF lut_ky, carries crossing the
    route boundary both ways, `diagnostics=True` snapshots field for field;
  * both fused engines and both legacy engines against the reference's on
    a (2, 4) mesh of 8 simulated host devices (one subprocess, built with
    `compat.make_mesh`), bit for bit at lut_ky; the legacy engines'
    exact_ky, cdf and gumbel by per-node TV against variable elimination,
    under 0.05 (the repo's quickstart gate);
  * on a card, the fused route makes words in plain torch
    (`prng._raw_bits`) only for its chain init, never when resumed;
  * every argument check of the sharded route;
  * the mesh over ranks (`RankMesh`): 8 gloo ranks on the CPU as a (2, 4)
    mesh, one spawn for the module (`torch_rank_cases.sampler_cases`),
    against the reference's (2, 4) outputs (both fused and both legacy
    engines) and against the single-process mesh and `run` (carries
    crossing both ways, `diagnostics=True` snapshots field for field, the
    halo at both grid edges), every rank returning the same, bit for bit;
    a (1, 2) world; the errors (a mesh that is not the world, chains or
    rows that do not divide, NCCL with two ranks on one card, a failed
    or hung rank).

Inputs come from numpy seeds; keys are the reference's keys carried
across."""

import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch import convert, prng
from repro_torch.compile import ir as t_ir
from repro_torch.compile import program as t_program
from repro_torch.core import bayesnet as t_bn
from repro_torch.core import distributed as t_dist
from repro_torch.core import mrf as t_mrf
from repro_torch.core.exact import ve_marginal
from repro_torch.core.graphs import GridMRF, bn_repository_replica, \
    random_bayesnet
from repro_torch.launch import mesh as mesh_mod

import torch_rank_cases as cases

MESHES = [(1, 1), (1, 2), (2, 4)]


@pytest.fixture(autouse=True)
def _fresh_cache():
    t_program.clear_program_cache()
    yield
    t_program.clear_program_cache()


def _cpu_mesh(shape):
    return t_dist.make_mesh(shape, ("data", "model"), device="cpu")


def _bn_prog():
    return t_program.compile_graph(
        t_ir.from_bayesnet(random_bayesnet(12, seed=3)), device="cpu")


def _mrf_prog(height=8):
    return t_program.compile_graph(
        t_ir.from_mrf(GridMRF(height, 16, 4, theta=1.1)), device="cpu")


def _evidence(height=8, seed=0):
    return np.random.default_rng(seed).integers(
        0, 4, (height, 16)).astype(np.int32)


def _same_state(a, b):
    for f in ("vals", "labels", "hist"):
        if hasattr(a, f):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.key == b.key
    assert getattr(a, "t", None) == getattr(b, "t", None)


# ---------------------------------------------------------------------------
# prng.fold_in
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("data", [0, 1, 7, 2**31 - 1])
@pytest.mark.parametrize("seed", [0, 5, 2**31 - 1])
def test_fold_in_matches_jax(seed, data):
    # a key straight from a seed, and one with both words random
    base = jax.random.key(seed)
    for jk in (base, jax.random.split(base)[1]):
        k = convert.key_from_reference(np.asarray(jax.random.key_data(jk)))
        want = np.asarray(jax.random.key_data(jax.random.fold_in(jk, data)))
        got = prng.fold_in(k, data)
        assert [got.k1, got.k2] == want.tolist()


# ---------------------------------------------------------------------------
# the fused route against the single-device fused run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampler", ["lut_ky", "exact_ky"])
@pytest.mark.parametrize("shape", MESHES)
def test_fused_sharded_bn_equals_single_device(shape, sampler):
    prog = _bn_prog()
    # 7 sweeps, burn-in 2, thin 2: the run ends mid-stride
    kw = dict(n_chains=8, n_iters=7, burn_in=2, thin=2, sampler=sampler,
              fused=True)
    m1, v1 = prog.run(prng.key(11), device="cpu", **kw)
    m2, v2 = prog.run_sharded(prng.key(11), _cpu_mesh(shape), **kw)
    assert torch.equal(m1, m2) and torch.equal(v1, v2)


@pytest.mark.parametrize("shape", MESHES)
def test_fused_sharded_mrf_equals_single_device(shape):
    prog = _mrf_prog()
    ev = _evidence()
    kw = dict(n_chains=4, n_iters=5, fused=True)
    want = prog.run(prng.key(7), evidence=ev, device="cpu", **kw)
    got = prog.run_sharded(prng.key(7), _cpu_mesh(shape), evidence=ev, **kw)
    assert torch.equal(got, want)


def test_bn_carry_crosses_the_route_boundary_both_ways():
    prog = _bn_prog()
    mesh = _cpu_mesh((2, 4))
    kw = dict(n_chains=8, burn_in=2, thin=2, fused=True)
    m, v, st = prog.run(prng.key(3), n_iters=7, return_state=True,
                        device="cpu", **kw)
    # 3 sweeps single-device, then 4 sharded (slice inside a thin stride)
    _, _, a = prog.run(prng.key(3), n_iters=3, return_state=True,
                       device="cpu", **kw)
    m_a, v_a, st_a = prog.run_sharded(None, mesh, n_iters=4, carry_state=a,
                                      return_state=True, **kw)
    # and the other way round
    _, _, b = prog.run_sharded(prng.key(3), mesh, n_iters=3,
                               return_state=True, **kw)
    m_b, v_b, st_b = prog.run(None, n_iters=4, carry_state=b,
                              return_state=True, device="cpu", **kw)
    for mm, vv, ss in ((m_a, v_a, st_a), (m_b, v_b, st_b)):
        assert torch.equal(mm, m) and torch.equal(vv, v)
        _same_state(ss, st)


def test_mrf_carry_crosses_the_route_boundary_both_ways():
    prog = _mrf_prog()
    mesh = _cpu_mesh((2, 4))
    ev = _evidence(seed=2)
    kw = dict(evidence=ev, n_chains=4, fused=True)
    whole = prog.run(prng.key(9), n_iters=6, device="cpu", **kw)
    _, a = prog.run(prng.key(9), n_iters=2, return_state=True, device="cpu",
                    **kw)
    lab_a = prog.run_sharded(None, mesh, n_iters=4, carry_state=a, **kw)
    _, b = prog.run_sharded(prng.key(9), mesh, n_iters=2, return_state=True,
                            **kw)
    lab_b = prog.run(None, n_iters=4, carry_state=b, device="cpu", **kw)
    assert torch.equal(lab_a, whole) and torch.equal(lab_b, whole)


@pytest.mark.cuda
def test_fused_sharded_route_makes_words_only_for_the_chain_init():
    """On a card, `run_sharded(fused=True)` on a (2, 4) mesh calls the
    plain-torch generator only for its chain init (K5 and K6 hash their
    words), not once when resumed from a carry, and equals the
    single-device run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    dev = torch.device("cuda")
    mesh = t_dist.make_mesh((2, 4), ("data", "model"), device=dev)
    bn = t_program.compile_graph(
        t_ir.from_bayesnet(random_bayesnet(12, seed=3)), device=dev)
    mrf = t_program.compile_graph(
        t_ir.from_mrf(GridMRF(8, 16, 4, theta=1.1)), device=dev)
    for prog in (bn, mrf):  # first-use checks draw in plain torch
        prog.ensure_fused_cross_check("lut_ky", sharded=True)
    bn_kw = dict(n_chains=8, burn_in=2, thin=2, fused=True)
    mrf_kw = dict(n_chains=4, evidence=torch.from_numpy(_evidence()).to(dev),
                  fused=True)

    def calls(fn):
        c0 = prng._raw_bits.calls
        out = fn()
        return out, prng._raw_bits.calls - c0

    _, bn_init = calls(lambda: t_bn.init_chain_values(bn.cbn, prng.key(0),
                                                      8))
    _, mrf_init = calls(lambda: t_mrf.init_labels(mrf.mrf, prng.key(0), 4,
                                                  None, None, dev))
    (_, _, st), n_first = calls(lambda: bn.run_sharded(
        prng.key(11), mesh, n_iters=3, return_state=True, **bn_kw))
    (m, v), n_resumed = calls(lambda: bn.run_sharded(
        None, mesh, n_iters=4, carry_state=st, **bn_kw))
    assert (n_first, n_resumed) == (bn_init, 0)
    m1, v1 = bn.run(prng.key(11), n_iters=7, device=dev, **bn_kw)
    assert torch.equal(m, m1) and torch.equal(v, v1)
    (_, st), n_first = calls(lambda: mrf.run_sharded(
        prng.key(9), mesh, n_iters=2, return_state=True, **mrf_kw))
    lab, n_resumed = calls(lambda: mrf.run_sharded(
        None, mesh, n_iters=4, carry_state=st, **mrf_kw))
    assert (n_first, n_resumed) == (mrf_init, 0)
    assert torch.equal(lab, mrf.run(prng.key(9), n_iters=6, device=dev,
                                    **mrf_kw))


def _assert_snap_equal(a, b):
    da, db = a.to_dict(), b.to_dict()
    assert da.keys() == db.keys()
    for k in da:
        x, y = da[k], db[k]
        if isinstance(x, (str, bool)) or x is None or y is None:
            assert x == y, k
        else:
            np.testing.assert_array_equal(np.asarray(x, float),
                                          np.asarray(y, float), k)
    np.testing.assert_array_equal(a.p_hat, b.p_hat)


def test_sharded_quality_snapshots_equal_single_device():
    mesh = _cpu_mesh((2, 4))
    mprog = _mrf_prog()
    ev = np.zeros((8, 16), np.int32)
    lab1, snap1 = mprog.run(prng.key(7), evidence=ev, n_chains=4, n_iters=5,
                            fused=True, diagnostics=True, device="cpu")
    lab2, snap2 = mprog.run_sharded(prng.key(7), mesh, evidence=ev,
                                    n_chains=4, n_iters=5, fused=True,
                                    diagnostics=True)
    assert torch.equal(lab1, lab2)
    _assert_snap_equal(snap1, snap2)
    pbn = _bn_prog()
    kw = dict(n_chains=4, n_iters=6, burn_in=2, thin=2, fused=True,
              diagnostics=True)
    m1, v1, sn1 = pbn.run(prng.key(11), device="cpu", **kw)
    m2, v2, sn2 = pbn.run_sharded(prng.key(11), mesh, **kw)
    assert torch.equal(m1, m2) and torch.equal(v1, v2)
    _assert_snap_equal(sn1, sn2)


# ---------------------------------------------------------------------------
# the port against the reference's engines on a (2, 4) mesh
# ---------------------------------------------------------------------------

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from repro.compile import compile_graph
    from repro.compile import ir as compile_ir
    from repro.core import compat
    from repro.core.graphs import GridMRF, random_bayesnet

    # jax.make_mesh's explicit axes make indexing a sharded result raise
    mesh = compat.make_mesh((2, 4), ("data", "model"))
    ev = np.random.default_rng(0).integers(0, 4, (8, 16)).astype(np.int32)
    res = {}
    prog = compile_graph(compile_ir.from_mrf(GridMRF(8, 16, 4, theta=1.1)))
    res["mrf_fused"] = prog.run_sharded(
        jax.random.key(7), mesh, evidence=jnp.asarray(ev), n_chains=4,
        n_iters=5, fused=True)
    for be in ("schedule", "eager"):
        res["mrf_legacy_" + be] = prog.run_sharded(
            jax.random.key(8), mesh, evidence=jnp.asarray(ev), n_chains=4,
            n_iters=3, fused=False, backend=be)
    pbn = compile_graph(compile_ir.from_bayesnet(random_bayesnet(12, seed=3)))
    res["bn_fused_m"], res["bn_fused_v"] = pbn.run_sharded(
        jax.random.key(11), mesh, n_chains=4, n_iters=6, burn_in=2, thin=2,
        fused=True)
    for be in ("schedule", "eager"):
        m, v = pbn.run_sharded(jax.random.key(12), mesh, n_chains=4,
                               n_iters=6, burn_in=2, fused=False, backend=be)
        res["bn_legacy_" + be + "_m"], res["bn_legacy_" + be + "_v"] = m, v
    np.savez(sys.argv[1], ev=ev, **{k: np.asarray(x) for k, x in res.items()})
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded engines on a (2, 4) mesh, run once a
    session in a subprocess with 8 simulated host devices."""
    def compute():
        out = tmp_path_factory.mktemp("sharded") / "reference.npz"
        root = Path(__file__).resolve().parent.parent
        env = dict(os.environ)
        env["PYTHONPATH"] = str(root / "src")
        env["JAX_PLATFORMS"] = "cpu"
        env.pop("XLA_FLAGS", None)
        res = subprocess.run([sys.executable, "-c", _REFERENCE, str(out)],
                             env=env, capture_output=True, text=True,
                             timeout=600)
        assert "REFERENCE_OK" in res.stdout, (res.stdout[-2000:]
                                              + res.stderr[-4000:])
        return dict(np.load(out))

    return cases.once_per_session(tmp_path_factory, "sharded_reference",
                                  compute)


def test_fused_engines_match_the_reference(reference):
    mesh = _cpu_mesh((2, 4))
    ev = reference["ev"]
    got = _mrf_prog().run_sharded(prng.key(7), mesh, evidence=ev,
                                  n_chains=4, n_iters=5, fused=True)
    np.testing.assert_array_equal(got.numpy(), reference["mrf_fused"])
    m, v = _bn_prog().run_sharded(prng.key(11), mesh, n_chains=4, n_iters=6,
                                  burn_in=2, thin=2, fused=True)
    np.testing.assert_array_equal(m.numpy(), reference["bn_fused_m"])
    np.testing.assert_array_equal(v.numpy(), reference["bn_fused_v"])


@pytest.mark.parametrize("backend", ["schedule", "eager"])
def test_legacy_engines_match_the_reference(reference, backend):
    mesh = _cpu_mesh((2, 4))
    got = _mrf_prog().run_sharded(prng.key(8), mesh,
                                  evidence=reference["ev"], n_chains=4,
                                  n_iters=3, fused=False, backend=backend)
    np.testing.assert_array_equal(got.numpy(),
                                  reference[f"mrf_legacy_{backend}"])
    m, v = _bn_prog().run_sharded(prng.key(12), mesh, n_chains=4, n_iters=6,
                                  burn_in=2, fused=False, backend=backend)
    np.testing.assert_array_equal(m.numpy(),
                                  reference[f"bn_legacy_{backend}_m"])
    np.testing.assert_array_equal(v.numpy(),
                                  reference[f"bn_legacy_{backend}_v"])


@pytest.mark.parametrize("sampler", ["exact_ky", "cdf", "gumbel"])
def test_legacy_bn_samplers_within_tv_of_exact(sampler):
    asia = bn_repository_replica("asia")
    ev = {0: 1, 5: 0}
    prog = t_program.compile_graph(asia, ev, device="cpu")
    marg, _ = prog.run_sharded(prng.key(4), _cpu_mesh((2, 4)), n_chains=256,
                               n_iters=300, burn_in=50, sampler=sampler)
    tv = max(
        0.5 * np.abs(ve_marginal(asia, q, ev)
                     - marg[q, :asia.cards[q]].numpy()).sum()
        for q in range(asia.n_nodes) if q not in ev
    )
    assert tv < 0.05, tv


def test_legacy_mrf_runs_every_sampler():
    prog = _mrf_prog()
    mesh = _cpu_mesh((2, 4))
    for sampler in ("exact_ky", "cdf", "gumbel"):
        lab = prog.run_sharded(prng.key(2), mesh, evidence=_evidence(),
                               n_chains=4, n_iters=2, sampler=sampler)
        assert lab.shape == (4, 8, 16) and lab.dtype == torch.int32
        assert bool(((lab >= 0) & (lab < 4)).all())


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------


def test_meshes_lie_on_one_device_and_default_to_the_card():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_dist.Mesh(np.array([[torch.device("cpu"), torch.device("cuda", 1)]],
                             dtype=object), ("data", "model"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_dist.make_mesh((2, 4))
    mesh = _cpu_mesh((2, 4))
    assert mesh.shape == {"data": 2, "model": 4} and mesh.size == 8
    with pytest.raises(ValueError):
        mesh.axis_size("pod")


def test_indivisible_shapes_raise():
    mprog = _mrf_prog(height=9)
    for fused in (True, False):
        with pytest.raises(ValueError, match="grid height"):
            mprog.run_sharded(prng.key(0), _cpu_mesh((1, 2)),
                              evidence=_evidence(9), n_chains=2, n_iters=1,
                              fused=fused)
        with pytest.raises(ValueError, match="n_chains"):
            _bn_prog().run_sharded(prng.key(0), _cpu_mesh((3, 1)),
                                   n_chains=4, n_iters=1, fused=fused)


def test_unlowered_comm_mechanisms_raise():
    import dataclasses

    for prog, wrong in ((_bn_prog(), "ppermute_halo"),
                        (_mrf_prog(), "psum_broadcast")):
        rounds = tuple(
            dataclasses.replace(r, comm=tuple(
                dataclasses.replace(op, mechanism=wrong) for op in r.comm))
            for r in prog.schedule.rounds)
        assert any(r.comm for r in rounds)
        prog.schedule = dataclasses.replace(prog.schedule, rounds=rounds)
        kw = {} if prog.kind == "bn" else {"evidence": _evidence()}
        with pytest.raises(ValueError, match="mechanism"):
            prog.run_sharded(prng.key(0), _cpu_mesh((1, 2)), n_chains=2,
                             n_iters=1, fused=False, **kw)
        t_program.clear_program_cache()


def test_sharded_route_argument_checks():
    mesh = _cpu_mesh((1, 2))
    bn = _bn_prog()
    with pytest.raises(ValueError, match="runtime evidence"):
        bn.run_sharded(prng.key(0), mesh, evidence={0: 1}, fused=True)
    for kw in (dict(return_state=True), dict(diagnostics=True),
               dict(thin=2)):
        with pytest.raises(ValueError):
            bn.run_sharded(prng.key(0), mesh, n_iters=1, **kw)
    with pytest.raises(ValueError):
        bn.run_sharded(prng.key(0), mesh, fused=True, backend="eager")
    with pytest.raises(ValueError):
        bn.run_sharded(prng.key(0), mesh, fused=True, sampler="cdf")
    mrf = _mrf_prog()
    ev = _evidence()
    for kw in (dict(burn_in=3), dict(thin=2)):
        for fused in (True, False):
            with pytest.raises(ValueError):
                mrf.run_sharded(prng.key(0), mesh, evidence=ev, n_iters=1,
                                fused=fused, **kw)
    with pytest.raises(ValueError, match="lut_ky"):
        mrf.run_sharded(prng.key(0), mesh, evidence=ev, fused=True,
                        sampler="exact_ky")
    pinned = t_program.compile_graph(
        t_ir.from_mrf(GridMRF(8, 16, 4), pinned={3: 1}), device="cpu")
    with pytest.raises(ValueError, match="pins"):
        pinned.run_sharded(prng.key(0), mesh, evidence=ev, n_chains=2,
                           n_iters=1, fused=True)
    with pytest.raises(ValueError, match="mesh lies on"):
        bn.run_sharded(prng.key(0), t_dist.Mesh(
            np.array([[torch.device("meta")]], dtype=object),
            ("data", "model")), n_iters=1)


# ---------------------------------------------------------------------------
# the mesh over ranks: 8 gloo ranks on the CPU
# ---------------------------------------------------------------------------

RANK_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of `torch_rank_cases.sampler_cases` on a (2, 4)
    mesh of 8 gloo ranks, spawned once a session."""
    return cases.once_per_session(
        tmp_path_factory, "rank_mesh_2x4", lambda: mesh_mod.spawn(
            cases.sampler_cases, 8, backend="gloo", device="cpu",
            timeout_s=RANK_TIMEOUT_S, mesh_shape=(2, 4)))


def test_rank_mesh_positions_and_collectives(ranks):
    assert [r["rank"] for r in ranks] == list(range(8))
    assert [r["coords"] for r in ranks] == [(i, j) for i in range(2)
                                            for j in range(4)]
    # every rank ran the same collectives (a count that differs would
    # have deadlocked or paired the wrong exchanges)
    assert len({r["collectives"] for r in ranks}) == 1
    assert ranks[0]["collectives"] > 0


def test_rank_mesh_fused_engines_match_the_reference(reference, ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["ref_mrf_fused"].numpy(),
                                      reference["mrf_fused"])
        m, v = r["ref_bn_fused"]
        np.testing.assert_array_equal(m.numpy(), reference["bn_fused_m"])
        np.testing.assert_array_equal(v.numpy(), reference["bn_fused_v"])


@pytest.mark.parametrize("backend", ["schedule", "eager"])
def test_rank_mesh_legacy_engines_match_the_reference(reference, ranks,
                                                      backend):
    for r in ranks:
        np.testing.assert_array_equal(
            r[f"ref_mrf_legacy_{backend}"].numpy(),
            reference[f"mrf_legacy_{backend}"])
        m, v = r[f"ref_bn_legacy_{backend}"]
        np.testing.assert_array_equal(m.numpy(),
                                      reference[f"bn_legacy_{backend}_m"])
        np.testing.assert_array_equal(v.numpy(),
                                      reference[f"bn_legacy_{backend}_v"])


@pytest.mark.parametrize("case", ["bn_fused", "bn_exact", "mrf_fused"])
def test_rank_mesh_equals_single_process_and_run(ranks, case):
    mesh = _cpu_mesh((2, 4))
    if case == "mrf_fused":
        prog, kw = cases.mrf_prog(), dict(evidence=cases.evidence(),
                                          **cases.MRF_KW)
        key = prng.key(7)
    else:
        prog, kw = cases.bn_prog(), dict(cases.BN_KW)
        kw["sampler"] = "exact_ky" if case == "bn_exact" else "lut_ky"
        key = prng.key(11)
    single = prog.run(key, device="cpu", **kw)
    sharded = prog.run_sharded(key, mesh, **kw)
    for r in ranks:
        for want in (single, sharded):
            got = r[case]
            if case == "mrf_fused":
                assert torch.equal(got, want)
            else:
                assert torch.equal(got[0], want[0])
                assert torch.equal(got[1], want[1])


def test_rank_mesh_bn_carry_crosses_both_ways(ranks):
    prog = cases.bn_prog()
    kw = {k: v for k, v in cases.BN_KW.items() if k != "n_iters"}
    m, v, st = prog.run(prng.key(3), n_iters=7, return_state=True,
                        device="cpu", **kw)
    for r in ranks:
        m_a, v_a, st_a = r["bn_carry_in"]
        m_b, v_b, st_b = prog.run(None, n_iters=4,
                                  carry_state=r["bn_carry_out"],
                                  return_state=True, device="cpu", **kw)
        for mm, vv, ss in ((m_a, v_a, st_a), (m_b, v_b, st_b)):
            assert torch.equal(mm, m) and torch.equal(vv, v)
            _same_state(ss, st)


def test_rank_mesh_mrf_carry_crosses_both_ways(ranks):
    prog = cases.mrf_prog()
    kw = dict(evidence=cases.evidence(seed=2), n_chains=4, fused=True)
    whole = prog.run(prng.key(9), n_iters=6, device="cpu", **kw)
    for r in ranks:
        assert torch.equal(r["mrf_carry_in"], whole)
        lab = prog.run(None, n_iters=4, carry_state=r["mrf_carry_out"],
                       device="cpu", **kw)
        assert torch.equal(lab, whole)


def test_rank_mesh_quality_snapshots_equal_single_device(ranks):
    mprog, bprog = cases.mrf_prog(), cases.bn_prog()
    zeros = np.zeros((8, 16), np.int32)
    lab1, snap1 = mprog.run(prng.key(7), evidence=zeros, n_chains=4,
                            n_iters=5, fused=True, diagnostics=True,
                            device="cpu")
    m1, v1, sn1 = bprog.run(prng.key(11), device="cpu", **cases.BN_DIAG_KW)
    # 2 iterations, then 3 resumed, on one device
    _, _, a = mprog.run(prng.key(7), evidence=zeros, n_chains=4, n_iters=2,
                        fused=True, diagnostics=True, return_state=True,
                        device="cpu")
    _, snap_sliced = mprog.run(None, evidence=zeros, n_chains=4, n_iters=3,
                               fused=True, diagnostics=True, carry_state=a,
                               device="cpu")
    for r in ranks:
        lab2, snap2 = r["mrf_diag"]
        assert torch.equal(lab1, lab2)
        _assert_snap_equal(snap1, snap2)
        m2, v2, sn2 = r["bn_diag"]
        assert torch.equal(m1, m2) and torch.equal(v1, v2)
        _assert_snap_equal(sn1, sn2)
        # 2 iterations on one device, 3 resumed on the ranks: the
        # accumulator's (chain, site) blocks cross both ways
        lab3, snap3 = r["mrf_diag_resumed"]
        assert torch.equal(lab3, lab1)
        _assert_snap_equal(snap3, snap_sliced)


def test_rank_mesh_carries_its_quality_state():
    """The accumulator's blocks cut and gathered as the ranks do it are
    the whole accumulator (leaves elementwise over chain and site)."""
    prog = cases.mrf_prog()
    zeros = np.zeros((8, 16), np.int32)
    _, _, st = prog.run(prng.key(7), evidence=zeros, n_chains=4, n_iters=3,
                        fused=True, diagnostics=True, return_state=True,
                        device="cpu")
    q = st.quality
    blocks = [[t_dist._accum_block(q, slice(2 * i, 2 * i + 2),
                                   slice(32 * j, 32 * j + 32))
               for j in range(4)] for i in range(2)]
    for f in t_dist._ACCUM_LEAVES:
        whole = torch.cat([torch.cat([getattr(b, f) for b in row], dim=-2)
                           for row in blocks], dim=-3)
        assert torch.equal(whole, getattr(q, f)), f
    for f in ("counts", "split_at", "batch_len", "bm_count", "cur_n"):
        assert getattr(blocks[1][3], f) == getattr(q, f), f


def test_rank_halo_at_both_grid_edges(ranks):
    grid = torch.arange(4 * 8 * 16, dtype=torch.int32).reshape(4, 8, 16)
    up, down = t_dist._halo_exchange(grid, 4)
    for r in ranks:
        ci, gi = r["coords"]
        got_up, got_down = r["halo"]
        assert torch.equal(got_up, up[gi, 2 * ci:2 * ci + 2])
        assert torch.equal(got_down, down[gi, 2 * ci:2 * ci + 2])
        assert bool((got_up == -1).all()) == (gi == 0)
        assert bool((got_down == -1).all()) == (gi == 3)


def test_rank_mesh_argument_errors(ranks):
    for r in ranks:
        err = r["errors"]
        assert "positions; the world has 8 ranks" in err["mesh_size"]
        assert "(16, 16) mesh" in err["production_mesh"]
        for k in ("n_chains", "n_chains_legacy"):
            assert err[k].startswith("ValueError: n_chains 3"), err[k]
        assert err["grid_height"].startswith("ValueError: grid height 9")


def test_rank_mesh_1x2_equals_single_process(tmp_path_factory):
    out = cases.once_per_session(
        tmp_path_factory, "rank_mesh_1x2", lambda: mesh_mod.spawn(
            cases.sampler_cases, 2, backend="gloo", device="cpu",
            timeout_s=RANK_TIMEOUT_S, mesh_shape=(1, 2)))
    mesh = _cpu_mesh((1, 2))
    bn, mrf = cases.bn_prog(), cases.mrf_prog()
    m, v = bn.run_sharded(prng.key(11), mesh, **cases.BN_KW)
    lab = mrf.run_sharded(prng.key(7), mesh, evidence=cases.evidence(),
                          **cases.MRF_KW)
    assert [r["coords"] for r in out] == [(0, 0), (0, 1)]
    for r in out:
        assert torch.equal(r["bn_fused"][0], m)
        assert torch.equal(r["bn_fused"][1], v)
        assert torch.equal(r["mrf_fused"], lab)


def test_nccl_refuses_two_ranks_on_one_card():
    with pytest.raises(ValueError, match="duplicate GPU"):
        mesh_mod.check_backend("nccl", 2, "cuda", 1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        mesh_mod.check_backend("nccl", 1, "cpu", 0)
    with pytest.raises(ValueError, match="backend"):
        mesh_mod.check_backend("mpi", 1, "cpu", 0)
    mesh_mod.check_backend("nccl", 4, "cuda", 4)
    mesh_mod.check_backend("gloo", 8, "cuda", 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.spawn(cases.hang, 2, backend="gloo", device="cuda")


def test_spawn_fails_when_a_rank_fails():
    t0 = time.monotonic()
    with pytest.raises(mesh_mod.RankFailed,
                       match="rank 1 fails on purpose") as info:
        mesh_mod.spawn(cases.fail_on_rank_1, 2, backend="gloo",
                       device="cpu", timeout_s=RANK_TIMEOUT_S)
    # the rank that failed first is named first
    assert str(info.value).startswith("rank1 exited with code 1")
    # rank 0, left waiting in its barrier, was ended, not waited for
    assert time.monotonic() - t0 < RANK_TIMEOUT_S / 2


def test_spawn_names_the_rank_that_raised_before_its_peer(tmp_path):
    """The peer's failure recorded first, both tracebacks with one mtime:
    the rank that raised of its own is still named first, and a rank
    with no record (killed) last."""
    class Proc:
        def __init__(self, name, exitcode):
            self.name, self.exitcode = name, exitcode

    lost = RuntimeError("[pair.cc:534] Connection closed by peer "
                        "[127.0.0.1]:1234")
    mesh_mod.record_failure(tmp_path, 0, lost, "rank 0 lost its peer\n")
    mesh_mod.record_failure(tmp_path, 1, RuntimeError("rank 1 fails"),
                            "rank 1 fails on purpose\n")
    for r in (0, 1):
        os.utime(tmp_path / f"rank{r}.err", ns=(10**18, 10**18))
    procs = [Proc("rank0", 1), Proc("rank1", 1), Proc("rank2", -9),
             Proc("rank3", 0)]
    text = mesh_mod._failures(procs, tmp_path)
    assert text.startswith("rank1 exited with code 1:\nrank 1 fails")
    names = [line.split()[0] for line in text.splitlines()
             if " exited with code " in line]
    assert names == ["rank1", "rank0", "rank2"]
    assert "(no traceback)" in text
    # the rank that raised may still be exiting when its peer has exited
    procs[1].exitcode = None
    assert mesh_mod._failures(procs, tmp_path).startswith(
        "rank1 exited with code 1:\nrank 1 fails")


def test_spawn_times_out_a_hung_rank():
    with pytest.raises(TimeoutError, match="still running"):
        mesh_mod.spawn(cases.hang, 1, backend="gloo", device="cpu",
                       timeout_s=2)
