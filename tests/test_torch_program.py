"""The port's compile chain and `CompiledProgram.run` against the
reference's, plus the port's guards: it imports neither JAX nor the
reference package, its entry points default to the card and refuse to run
on the CPU unasked, and a CUDA tensor never reaches a kernel's twin.

The reference runs `run(backend="schedule")` as it serves (jitted); the
port runs `run(fused=True, device="cpu")`, i.e. K3's plain twin once per
sweep.  Tolerance: bit-equal."""

import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.compile import canonicalize as r_canonicalize
from repro.compile import clear_program_cache as r_clear
from repro.compile import compile_graph as r_compile_graph
from repro.core import graphs as r_graphs
from repro_torch import convert, prng
from repro_torch.compile import ir as t_ir
from repro_torch.compile import program as t_program
from repro_torch.core import bayesnet as t_bn
from repro_torch.core import distributed
from repro_torch.core import graphs as t_graphs
from repro_torch.kernels import (bn_gibbs, interp_lut, ky_sampler, mrf_gibbs,
                                 ops)

EVIDENCE = {3: 1, 10: 0, 20: 1}


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


def _assert_same(port_out, ref_out):
    for got, want in zip(port_out, ref_out):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["baked", "runtime"])
def test_fused_run_matches_reference_schedule_run_on_alarm(mode):
    r_net = r_graphs.bn_repository_replica("alarm")
    t_net = t_graphs.bn_repository_replica("alarm")
    # the reference's first-use cross-checks compile its engines at 2
    # chains x 3 sweeps without burn-in; serving the same budget reuses those
    # executables instead of compiling a third one
    kw = dict(n_chains=2, n_iters=3, burn_in=0)
    jk, k = _key(6)
    if mode == "baked":
        r_prog = r_compile_graph(r_net, EVIDENCE)
        t_prog = t_program.compile_graph(t_net, EVIDENCE, device="cpu")
        want = r_prog.run(jk, backend="schedule", **kw)
        got = t_prog.run(k, fused=True, device="cpu", **kw)
    else:
        r_prog = r_compile_graph(
            r_canonicalize(r_net, evidence_mode="runtime"))
        t_prog = t_program.compile_graph(
            t_ir.canonicalize(t_net, evidence_mode="runtime"), device="cpu")
        want = r_prog.run(jk, backend="schedule", evidence=EVIDENCE, **kw)
        got = t_prog.run(k, fused=True, evidence=EVIDENCE, device="cpu",
                         **kw)
    assert t_prog.program_key == r_prog.program_key
    _assert_same(got, want)
    unfused = t_prog.run(k, device="cpu", evidence=EVIDENCE
                         if mode == "runtime" else None, **kw)
    _assert_same(unfused, [x.numpy() for x in got])


def test_sliced_run_equals_whole_run():
    t_net = t_graphs.bn_repository_replica("asia")
    prog = t_program.compile_graph(
        t_ir.canonicalize(t_net, evidence_mode="runtime"), device="cpu")
    kw = dict(n_chains=6, burn_in=4, thin=2, evidence={1: 0}, fused=True,
              device="cpu")
    m, v = prog.run(prng.key(2), n_iters=15, **kw)
    _, _, st = prog.run(prng.key(2), n_iters=7, return_state=True, **kw)
    _, _, st = prog.run(None, n_iters=5, carry_state=st, return_state=True,
                        **kw)
    m2, v2 = prog.run(None, n_iters=3, carry_state=st, **kw)
    assert torch.equal(m, m2) and torch.equal(v, v2)
    assert isinstance(st, t_bn.BNChainState) and st.t == 12


def test_program_cache_hits_on_recompile():
    net = t_graphs.bn_repository_replica("survey")
    graph = t_ir.canonicalize(net, evidence_mode="runtime")
    p1 = t_program.compile_graph(graph, device="cpu")
    p2 = t_program.compile_graph(
        t_ir.canonicalize(t_graphs.bn_repository_replica("survey"),
                          evidence_mode="runtime"), device="cpu")
    assert p2 is p1
    stats = t_program.cache_stats()
    assert (stats["hits"], stats["misses"], stats["size"]) == (1, 1, 1)
    p1.run(prng.key(0), n_chains=2, n_iters=2, evidence={0: 1}, device="cpu")
    p1.run(prng.key(1), n_chains=2, n_iters=2, evidence={0: 0}, device="cpu")
    assert p1.clamp_lowerings == 1  # one specialization per observed set
    t_program.set_cache_capacity(1)
    t_program.compile_graph(net, device="cpu")  # baked IR: another slot
    assert t_program.cache_stats()["evictions"] == 1
    t_program.set_cache_capacity(128)


def test_converter_round_trips_reference_net_and_key():
    from repro.core import bayesnet as r_bn

    r = r_bn.compile_bayesnet(r_graphs.bn_repository_replica("cancer"),
                              evidence={0: 1})
    arrays, meta = convert.reference_bn_arrays(r)
    t = convert.from_reference_bn(arrays, meta, device="cpu")
    again, meta2 = convert.reference_bn_arrays(t)
    assert meta2 == meta
    for k, v in arrays.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
        assert again[k].dtype == v.dtype, k
    jk, k = _key(99)
    assert [k.k1, k.k2] == np.asarray(jax.random.key_data(jk)).tolist()
    # the converted net gives the reference's chain init
    rv, _ = r_bn.init_chain_values(r, jk, 4)
    tv, _ = t_bn.init_chain_values(t, k, 4)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


def test_unported_paths_raise():
    """What still raises: a fused run with a sampler its kernel does not
    implement (K3/K5: lut_ky/exact_ky; K4/K6: lut_ky), on either route, and
    on the sharded route a mesh over more than one device (a later item),
    BN runtime evidence, baked MRF pins and an indivisible grid.  The
    sharded cross-check itself runs."""
    prog = t_program.compile_graph(t_graphs.bn_repository_replica("survey"),
                                   device="cpu")
    mesh = distributed.make_mesh((1, 2), device="cpu")
    with pytest.raises(ValueError):
        prog.run(prng.key(0), fused=True, backend="eager", device="cpu")
    with pytest.raises(ValueError):
        prog.run(prng.key(0), fused=True, sampler="cdf", device="cpu")
    with pytest.raises(ValueError):
        prog.run_sharded(prng.key(0), mesh, fused=True, sampler="cdf")
    with pytest.raises(ValueError):
        prog.run_sharded(prng.key(0), mesh, evidence={0: 1}, fused=True)
    with pytest.raises(NotImplementedError):
        distributed.Mesh(np.array([[torch.device("cpu"), torch.device(
            "cuda", 1)]], dtype=object), ("data", "model"))
    prog.ensure_fused_cross_check("lut_ky", sharded=True)
    assert ("lut_ky", "sharded") in prog._fused_checked
    mrf = t_program.compile_graph(t_graphs.GridMRF(4, 4, 2), device="cpu")
    ev = np.zeros((4, 4))
    for sampler in ("exact_ky", "cdf", "gumbel"):
        with pytest.raises(ValueError):
            mrf.run(prng.key(0), evidence=ev, fused=True, sampler=sampler,
                    device="cpu")
        with pytest.raises(ValueError):
            mrf.run_sharded(prng.key(0), mesh, evidence=ev, fused=True,
                            sampler=sampler)
    with pytest.raises(ValueError):
        mrf.run_sharded(prng.key(0), distributed.make_mesh(
            (1, 3), device="cpu"), evidence=ev, fused=True)
    pinned = t_program.compile_graph(
        t_ir.from_mrf(t_graphs.GridMRF(4, 4, 2), pinned={1: 0}),
        device="cpu")
    with pytest.raises(ValueError):
        pinned.run_sharded(prng.key(0), mesh, evidence=ev, fused=True)


def test_port_imports_neither_jax_nor_the_reference():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro",
                                            "triton"))
        # the serving runtime, the tracer, the profiler, the CLIs, the
        # LM serving path (configs, models, steps, serve) and the LM
        # training path (train, optim, data, checkpoint) are walked too
        want = {"repro_torch.runtime." + m for m in (
            "admission", "batcher", "calibrate", "engine", "executor",
            "metrics", "trace", "__main__")} | {
            "repro_torch.obs." + m for m in (
                "tracer", "timeseries", "export", "attrib", "profile",
                "__main__")} | {
            "repro_torch.launch." + m for m in (
                "roofline", "kernel_cost", "report")} | {
            "repro_torch.analysis." + m for m in (
                "kernel_lint", "source_lint", "__main__")} | {
            "repro_torch.diag.__main__"} | {
            "repro_torch.models." + m for m in (
                "layers", "transformer", "sampling")} | {
            "repro_torch.launch." + m for m in ("steps", "serve",
                                                "train")} | {
            "repro_torch.optim.adamw", "repro_torch.data.pipeline",
            "repro_torch.checkpoint.checkpoint"} | {
            "repro_torch.configs." + m for m in (
                "base", "yi_9b", "codeqwen1_5_7b", "musicgen_medium",
                "internvl2_76b", "mistral_large_123b", "qwen2_72b",
                "qwen2_moe_a2_7b", "llama4_scout_17b_a16e",
                "jamba_1_5_large_398b", "xlstm_350m")}
        missing = sorted(want - set(names))
        print(len(names), bad, missing)
        sys.exit(1 if bad or missing or len(names) < 20 else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults would run")
    net = t_graphs.bn_repository_replica("survey")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_program.compile_graph(net)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_bn.compile_bayesnet(net)
    cpu_net = t_bn.compile_bayesnet(net, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_bn.run_gibbs(cpu_net, prng.key(0))
    prog = t_program.compile_graph(net, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prog.run(prng.key(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prng.bits(prng.key(0), (4,))


@pytest.mark.cuda
def test_cuda_tensors_never_reach_the_twins(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")

    def twin_called(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain twin")

    def words_made(*args, **kwargs):
        raise AssertionError("K1's or K3-K6's words were made in plain "
                             "torch")

    monkeypatch.setattr(interp_lut, "interp_kernel_ref", twin_called)
    monkeypatch.setattr(ky_sampler, "ky_sample_kernel_ref", twin_called)
    monkeypatch.setattr(bn_gibbs, "bn_sweep_ref", twin_called)
    monkeypatch.setattr(mrf_gibbs, "mrf_half_step_ref", twin_called)
    monkeypatch.setattr(bn_gibbs, "fused_color_round_ref", twin_called)
    monkeypatch.setattr(mrf_gibbs, "mrf_halo_half_step_ref", twin_called)
    dev = torch.device("cuda")
    net = t_graphs.bn_repository_replica("survey")
    cbn = t_bn.compile_bayesnet(net, device=dev)
    counters = (interp_lut.interp_kernel, ky_sampler.ky_sample_kernel,
                bn_gibbs.bn_sweep, mrf_gibbs.mrf_half_step,
                bn_gibbs.fused_color_round, mrf_gibbs.mrf_halo_half_step)
    before = [c.launches for c in counters]
    w = ops.lut_exp_weights(torch.randn(64, 5, device=dev), cbn.exp_table,
                            cbn.exp_spec)
    vals, _ = t_bn.init_chain_values(cbn, prng.key(2), 8)
    fr = bn_gibbs.build_fused_rounds(cbn.groups)
    grid = t_graphs.GridMRF(9, 7, 4)
    labels = torch.zeros((3, 9, 7), dtype=torch.int32, device=dev)
    evidence = torch.ones((9, 7), dtype=torch.int32, device=dev)
    sfr = distributed.build_sharded_fused_rounds(cbn, cbn.groups, 2)
    p = bn_gibbs.sweep_params(cbn, "lut_ky")
    up, down = distributed._halo_exchange(labels, 3)
    # K1 and K3-K6 make their words inside the kernel: no word in plain
    # torch
    with monkeypatch.context() as m:
        m.setattr(prng, "_raw_bits", words_made)
        ops.ky_sample(w, prng.key(1))
        bn_gibbs.fused_gibbs_sweep(cbn, fr, vals, prng.key(3))
        mrf_gibbs.mrf_round_step(grid, labels, evidence, prng.key(4), 1,
                                 cbn.exp_table, cbn.exp_spec)
        bn_gibbs.fused_color_round(cbn, sfr, 1, 0, vals[4:], prng.key(5), 4,
                                   "lut_ky", p)
        bn_gibbs.fused_color_round_mesh(cbn, sfr, 0, vals, prng.key(5),
                                        "lut_ky", p, 2)
        mrf_gibbs.mrf_sharded_round_step(
            grid, labels, evidence, prng.key(6), 0, cbn.exp_table,
            cbn.exp_spec, n_chain_pos=1, n_row_pos=3, up_halo=up,
            down_halo=down)
    torch.cuda.synchronize()
    after = [c.launches for c in counters]
    # K5: one position, then every position in one launch; K6: 3 slabs in
    # one launch
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1, 2, 1]


@pytest.mark.cuda
def test_fused_main_path_makes_no_words_outside_the_kernels(monkeypatch):
    """`run(fused=True)` on one device, resumed from a carry (the chain
    init and the first-use cross-check, which draw in plain torch, done
    before): with `prng._raw_bits` raising, a BN and an MRF program still
    serve, through K3 and K4 alone, and give the unpatched run's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    dev = torch.device("cuda")
    bn_prog = t_program.compile_graph(
        t_ir.canonicalize(t_graphs.bn_repository_replica("alarm"),
                          evidence_mode="runtime"), device=dev)
    grid = t_graphs.GridMRF(12, 10, 3)
    mrf_prog = t_program.compile_graph(grid, device=dev)
    ev = torch.from_numpy(
        np.random.default_rng(0).integers(0, 3, (12, 10)).astype(
            np.int32)).to(dev)
    bn_kw = dict(n_chains=32, sampler="lut_ky", fused=True, device=dev,
                 evidence={0: 1})
    mrf_kw = dict(n_chains=32, sampler="lut_ky", fused=True, device=dev,
                  evidence=ev)
    _, _, bn_st = bn_prog.run(prng.key(1), n_iters=2, return_state=True,
                              **bn_kw)
    _, mrf_st = mrf_prog.run(prng.key(2), n_iters=2, return_state=True,
                             **mrf_kw)
    bn_want = bn_prog.run(None, n_iters=5, carry_state=bn_st, **bn_kw)
    mrf_want = mrf_prog.run(None, n_iters=5, carry_state=mrf_st, **mrf_kw)
    k3, k4 = bn_gibbs.bn_sweep.launches, mrf_gibbs.mrf_half_step.launches

    def words_made(*args, **kwargs):
        raise AssertionError("words were made in plain torch")

    monkeypatch.setattr(prng, "_raw_bits", words_made)
    bn_got = bn_prog.run(None, n_iters=5, carry_state=bn_st, **bn_kw)
    mrf_got = mrf_prog.run(None, n_iters=5, carry_state=mrf_st, **mrf_kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(bn_got, bn_want))
    assert torch.equal(mrf_got, mrf_want)
    assert bn_gibbs.bn_sweep.launches - k3 == 5
    assert mrf_gibbs.mrf_half_step.launches - k4 == 2 * 5
