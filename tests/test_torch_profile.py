"""The port's profiler (`repro_torch.obs.profile`, `launch.kernel_cost`,
`launch.roofline`) against the reference's `repro.obs.profile`.

  * Signatures: byte-equal to the reference's on the port's own bucket
    keys from a quick Zipf trace, and on the port's programs.
  * `kernel_cost` at the served shapes reproduces the kernel table's
    bytes, threefry calls and bounds (`PERF.md`, chip_smoke on an H100),
    and a bucket that differs only in `fused` does the same work.
  * A profiled `--fused` quick replay on the CPU with the sharded route on:
    every dispatch joins a profile, sharded ones included, and every
    answer equals the same replay's without profiling.
  * `validate_profile`, the join of sharded dispatches, capture cache
    hits, and the static sweep (the counterparts of `tests/test_profile.py`).
"""

import pytest
import torch

from repro.obs import profile as r_profile
from repro_torch import obs, prng
from repro_torch.compile import ir
from repro_torch.compile.program import clear_program_cache, compile_graph
from repro_torch.core import bayesnet as bnet
from repro_torch.core import distributed
from repro_torch.core.graphs import GridMRF, bn_repository_replica
from repro_torch.launch import kernel_cost, roofline
from repro_torch.obs import export
from repro_torch.obs import profile
from repro_torch.runtime import Engine, EngineConfig, bucket_key, zipf_trace


@pytest.fixture(autouse=True)
def _off():
    obs.disable()
    profile.disable()
    clear_program_cache()
    yield
    obs.disable()
    profile.disable()
    clear_program_cache()


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------


def _trace_keys():
    models, queries = zipf_trace(24, quick=True, seed=3)
    graphs = {m: ir.canonicalize(g, evidence_mode="runtime")
              for m, g in models.items()}
    keys = set()
    for q in queries:
        for fused in (False, True):
            keys.add(bucket_key(q, graphs[q.model], "schedule", 8,
                                fused=fused, diagnostics=fused))
    return models, sorted(keys, key=repr)


@pytest.mark.parametrize("route,width", [("vmap", 1), ("sharded", 2),
                                         ("sharded", 4)])
def test_bucket_signature_equals_the_reference(route, width):
    _, keys = _trace_keys()
    assert len(keys) >= 4
    for key in keys:
        for pad in (1, 4, 8):
            mine = profile.bucket_signature(key, pad, route, width)
            assert mine == r_profile.bucket_signature(key, pad, route, width)
            assert mine.startswith("bucket|" + key.program_key[:16])


def test_program_signature_equals_the_reference():
    models, _ = _trace_keys()
    for g in models.values():
        prog = compile_graph(g, device="cpu")
        for fused in (False, True):
            kw = dict(n_chains=8, n_iters=32, burn_in=8, thin=2,
                      sampler="lut_ky", fused=fused)
            mine = profile.program_signature(prog, **kw)
            assert mine == r_profile.program_signature(prog, **kw)


# ---------------------------------------------------------------------------
# kernel_cost at the served shapes
# ---------------------------------------------------------------------------


def _pigs():
    cbn = bnet.compile_bayesnet(bn_repository_replica("pigs"), device="cpu")
    return cbn, kernel_cost.bn_shape(cbn, cbn.groups)


def _k5_round_mean():
    prog = compile_graph(bn_repository_replica("pigs"), device="cpu")
    groups = prog.schedule_executable().round_groups
    shape = kernel_cost.bn_shape(prog.cbn, groups)
    lanes = distributed.local_lanes(groups, 4, prog.placement)
    n = len(shape.n_c)
    return kernel_cost.total(
        kernel_cost.bn_color_round_mesh(shape, r, 1024, 4, lanes)
        for r in range(n)) * (1.0 / n)


PENGUIN = kernel_cost.mrf_shape(GridMRF(64, 64, 4, theta=1.2, h=2.0), 16)

# entry -> (cost, MB, threefry calls or None, bound ms): the kernel
# table's per-launch numbers (PERF.md; chip_smoke, NVIDIA H100 80GB HBM3)
ENTRIES = {
    "K3 pigs B=1024": (lambda: kernel_cost.bn_sweep(_pigs()[1], 1024),
                       3.97, 451_584, 0.00118),
    "K4 Penguin B=1024": (lambda: kernel_cost.mrf_half_step(PENGUIN, 1024, 0),
                          33.6, 2_097_152, 0.0100),
    "K3 lanes pigs 8 x 1024": (
        lambda: kernel_cost.bn_sweep_lanes(_pigs()[1], 8, 1024),
        29.3, 3_612_672, 0.00886),
    "K4 lanes Penguin 2 x 1024": (
        lambda: kernel_cost.mrf_half_step_lanes(PENGUIN, 2, 1024, 0),
        67.1, None, 0.0200),
    "K5 pigs (2, 4), per round": (_k5_round_mean, 9.14, 112_896, 0.00273),
    "K6 Penguin (2, 4)": (
        lambda: kernel_cost.mrf_halo_half_step(PENGUIN, 1024, 4, 0),
        33.6 + 2.1, None, 0.0106),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_kernel_cost_reproduces_the_kernel_table(entry):
    fn, mb, calls, bound_ms = ENTRIES[entry]
    cost = fn()
    assert cost.hbm_bytes / 1e6 == pytest.approx(mb, rel=3e-3)
    if calls is not None:
        assert cost.hash_calls == calls
    roof = roofline.Roofline(cost.flops, cost.hbm_bytes,
                             cost.collective_bytes, cost.hash_calls)
    assert max(roof.t_compute, roof.t_memory) * 1e3 == pytest.approx(
        bound_ms, rel=6e-3)
    assert roof.t_collective == 0.0


def test_roofline_terms_and_bottleneck():
    r = roofline.Roofline(flops=67e12, hbm_bytes=0.0, collective_bytes=0.0)
    assert r.t_compute == pytest.approx(1.0) and r.bottleneck == "compute"
    # the hash's bit operations bind: 41 on 64 ALU lanes x 132 SMs
    calls = 132 * 64 * 1.98e9 / 41
    r = roofline.Roofline(0.0, 0.0, 0.0, hash_calls=calls)
    assert r.t_compute == pytest.approx(1.0)
    r = roofline.Roofline(0.0, 3.35e12, 6.7e12)
    assert (r.t_memory, r.t_collective) == (pytest.approx(1.0),
                                            pytest.approx(2.0))
    assert r.bottleneck == "collective"


def _bucket_keys(model, graph, fused):
    models, queries = zipf_trace(24, quick=True, seed=3)
    q = next(q for q in queries if q.model == model)
    return bucket_key(q, graph, "schedule", None, fused=fused)


@pytest.mark.parametrize("model", ["survey", "grid"])
def test_fused_and_unfused_buckets_cost_the_same(model):
    models, _ = zipf_trace(24, quick=True, seed=3)
    graph = ir.canonicalize(models[model], evidence_mode="runtime")
    prog = compile_graph(graph, device="cpu")
    k_f = _bucket_keys(model, graph, True)
    k_u = _bucket_keys(model, graph, False)
    assert k_f.fused and not k_u.fused
    for lanes in (1, 5):
        a = kernel_cost.bucket_cost(prog, k_f, lanes)
        assert a == kernel_cost.bucket_cost(prog, k_u, lanes)
        assert a.hbm_bytes > 0 and a.hash_calls > 0
    # the pending first-use cross-check adds work to the fused dispatch
    more = kernel_cost.bucket_cost(prog, k_f, 1, cross_check=True)
    assert more.hbm_bytes > kernel_cost.bucket_cost(prog, k_f, 1).hbm_bytes
    assert kernel_cost.bucket_cost(prog, k_u, 1, cross_check=True) == \
        kernel_cost.bucket_cost(prog, k_u, 1)


def test_sharded_cost_carries_the_collectives():
    bn = compile_graph(bn_repository_replica("asia"), device="cpu")
    mrf = compile_graph(GridMRF(8, 8, 3), device="cpu")
    kw = dict(n_chains=4, n_iters=6, burn_in=2)
    c = kernel_cost.program_cost(bn, mesh=(1, 2), **kw)
    assert set(c.collective_by_op) == {"all-reduce"}
    c = kernel_cost.program_cost(mrf, mesh=(1, 2), **kw)
    assert set(c.collective_by_op) == {"collective-permute"}
    assert kernel_cost.program_cost(mrf, **kw).collective_by_op == {}


def test_sharded_bucket_costs_each_lane_and_the_sharded_check():
    """A sharded dispatch runs its queries over the (1, w) mesh one after
    another: it costs `n_lanes` runs, and its pending first-use
    cross-check adds the eager, fused and sharded legs."""
    models, _ = zipf_trace(24, quick=True, seed=3)
    graph = ir.canonicalize(models["grid"], evidence_mode="runtime")
    prog = compile_graph(graph, device="cpu")
    key = _bucket_keys("grid", graph, True)
    one = kernel_cost.bucket_cost(prog, key, 1, "sharded", shard_width=2)
    two = kernel_cost.bucket_cost(prog, key, 2, "sharded", shard_width=2)
    assert two == 2 * one
    assert set(one.collective_by_op) == {"collective-permute"}
    run = dict(n_chains=key.n_chains, n_iters=key.n_iters,
               sampler=key.sampler)
    assert one == kernel_cost.program_cost(prog, mesh=(1, 2), **run)
    check = kernel_cost.bucket_cost(prog, key, 1, "sharded", shard_width=2,
                                    cross_check=True)
    tiny = dict(n_chains=kernel_cost.CHECK_CHAINS,
                n_iters=kernel_cost.CHECK_ITERS, burn_in=0,
                sampler=key.sampler)
    assert check == (one + 2 * kernel_cost.program_cost(prog, **tiny)
                     + kernel_cost.program_cost(prog, mesh=(1, 2), **tiny))
    with pytest.raises(ValueError, match="unknown route"):
        kernel_cost.bucket_cost(prog, key, 1, "ring")


def test_unknown_program_kind_raises():
    class Odd:
        kind = "hypergraph"

    with pytest.raises(ValueError, match="no cost model"):
        kernel_cost.program_cost(Odd(), n_chains=2, n_iters=2)


# ---------------------------------------------------------------------------
# capture + join
# ---------------------------------------------------------------------------


def _replay(profiled: bool, seed: int = 3):
    clear_program_cache()
    tr = reg = None
    if profiled:
        tr = obs.enable()
        reg = profile.enable()
    models, queries = zipf_trace(24, quick=True, seed=seed,
                                 mean_interarrival_s=5e-5)
    for q in queries:  # pinned grids never take the sharded route
        if q.image is not None:
            q.evidence = None
    eng = Engine(models, EngineConfig(
        pad_sizes=(8,), max_batch=8, n_workers=2, shard_width=2,
        shard_min_sites=16, fused=True), device="cpu")
    eng.submit(queries)
    results = eng.run()
    events = export.events_as_dicts(list(tr.events)) if profiled else None
    profile.disable()
    obs.disable()
    return eng, results, events, reg


def test_profiled_replay_joins_every_dispatch_and_changes_no_answer():
    eng, results, events, reg = _replay(True)
    assert results and reg.profiles
    for prof in reg.profiles.values():
        assert prof.hbm_bytes > 0 and prof.roofline_s > 0
        assert prof.bottleneck in profile.BOTTLENECKS
        assert "capture_s" not in prof.as_dict(deterministic=True)
        assert "capture_s" in prof.as_dict(deterministic=False)
    joined = profile.join_dispatches(reg.profiles, events)
    assert joined["unattributed"] == []
    assert joined["n_dispatches"] == len(eng.metrics.batch_records)
    assert joined["n_sharded"] > 0
    assert [c["mechanism"] for c in joined["comm"]] == ["ppermute_halo"]
    for row in joined["rows"]:
        assert row["n_dispatches"] > 0 and row["measured_mean_s"] > 0
        assert 0 < row["peak_frac"] <= 1.0
        # a dispatch costs the fewest real lanes its pad admits, on either
        # route (the replay pads to 8 only, so that is one)
        assert row["meta"]["n_lanes"] == 1
    sharded = [r for r in joined["rows"] if r["meta"]["route"] == "sharded"]
    assert sharded and all(r["meta"]["mesh"] == [1, 2]
                           and r["collective_bytes"] > 0 for r in sharded)
    rec = {"schema": 1, "buckets": reg.rows(deterministic=False),
           "joined": joined, "peaks": {}}
    assert profile.validate_profile(rec) == []
    _, plain, _, _ = _replay(False)
    assert sorted(plain) == sorted(results)
    for qid, r in plain.items():
        assert (r.final_state == results[qid].final_state).all()
        assert (r.marginals is None) == (results[qid].marginals is None)
        if r.marginals is not None:
            assert (r.marginals == results[qid].marginals).all()


def test_capture_cache_hits_by_signature():
    obs.enable()
    reg = profile.enable()
    prog = compile_graph(bn_repository_replica("asia"), device="cpu")
    kw = dict(n_chains=4, n_iters=6, burn_in=2, sampler="lut_ky")
    profile.capture_program(prog, fused=True, **kw)
    first = dict(reg.profiles)
    profile.capture_program(prog, fused=True, **kw)
    profile.capture_program(prog, fused=False, **kw)
    assert reg.hits == 1 and len(reg.profiles) == 2
    assert all(reg.profiles[s] is p for s, p in first.items())
    # the fused run counts its pending first-use cross-check
    (fused,) = first.values()
    unfused = next(p for s, p in reg.profiles.items() if s not in first)
    assert fused.hbm_bytes > unfused.hbm_bytes
    events = export.events_as_dicts(list(obs.get().events))
    assert len([e for e in events if e["name"] == "hlo_cost"]) == 2


def test_program_runs_capture_their_unsliced_schedule_calls():
    """`run()` records a static cost on the branches the reference hooks
    (schedule backend, no evidence, pins, carry or diagnostics) and on no
    other, and changes no answer."""
    bn, mrf = (compile_graph(ir.canonicalize(g, evidence_mode="runtime"),
                             device="cpu")
               for g in (bn_repository_replica("asia"), GridMRF(8, 8, 3)))
    ev = torch.zeros((8, 8), dtype=torch.int32)
    kw = dict(n_chains=4, n_iters=6, device="cpu")
    plain = (bn.run(prng.key(1), fused=True, burn_in=2, **kw),
             mrf.run(prng.key(2), evidence=ev, **kw))
    reg = profile.enable()
    got = (bn.run(prng.key(1), fused=True, burn_in=2, **kw),
           mrf.run(prng.key(2), evidence=ev, **kw))
    assert all(torch.equal(a, b) for a, b in zip(plain[0], got[0]))
    assert torch.equal(plain[1], got[1])
    assert sorted(reg.profiles) == sorted([
        profile.program_signature(bn, n_chains=4, n_iters=6, burn_in=2,
                                  thin=1, sampler="lut_ky", fused=True),
        profile.program_signature(mrf, n_chains=4, n_iters=6, burn_in=50,
                                  thin=1, sampler="lut_ky", fused=False),
    ])
    bn.run(prng.key(1), evidence={0: 1}, burn_in=2, **kw)
    bn.run(prng.key(1), burn_in=2, diagnostics=True, **kw)
    mrf.run(prng.key(2), evidence=ev, pins={0: 1}, **kw)
    bn.run(prng.key(1), burn_in=2, backend="eager", **kw)
    assert len(reg.profiles) == 2


def test_profiling_off_captures_nothing():
    prog = compile_graph(bn_repository_replica("asia"), device="cpu")
    assert not profile.enabled()
    assert profile.capture_program(prog, n_chains=2, n_iters=2) is None
    _, keys = _trace_keys()
    assert profile.capture_bucket(prog, keys[0], 8, (8,), route="sharded",
                                  shard_width=2) is None


def test_validate_profile_flags_holes():
    bad = {
        "schema": 1,
        "buckets": [{"sig": "s", "flops": -1.0, "hbm_bytes": 0.0,
                     "collective_bytes": 0.0, "bottleneck": "nonsense"}],
        "joined": {"unattributed": [{"sig": "x", "n_dispatches": 3}]},
    }
    problems = profile.validate_profile(bad)
    assert problems == r_profile.validate_profile(bad)
    assert any("unattributed" in p for p in problems)
    assert any("nonsense" in p for p in problems)
    assert profile.validate_profile({"schema": 1, "buckets": [],
                                     "joined": {}}) != []
    assert profile.validate_profile({"schema": 2}) != []


def test_join_attributes_sharded_dispatches_as_the_reference_does():
    _, keys = _trace_keys()
    sig = profile.bucket_signature(keys[0], 8, route="sharded",
                                   shard_width=4)
    prof = {
        "sig": sig, "flops": 2.0e6, "hbm_bytes": 1.0e6,
        "collective_bytes": 4096.0, "roofline_s": 1e-4,
        "collective_by_op": {"collective-permute": 4096.0},
        "bottleneck": "collective",
    }
    mk = lambda s: {
        "name": "dispatch",
        "args": {"route": "sharded", "profile_sig": s, "model": "g",
                 "service_s": 2e-3},
        "wargs": {"measured_s": 1e-3},
    }
    events = [mk(sig), mk(sig), mk("bucket|nope|sharded|sh4")]
    joined = profile.join_dispatches({sig: prof}, events)
    ref = r_profile.join_dispatches({sig: prof}, events)
    assert joined["rows"] == ref["rows"]
    assert joined["unattributed"] == ref["unattributed"]
    assert joined["n_sharded"] == 3
    (row,) = joined["rows"]
    assert row["n_dispatches"] == 2
    assert row["peak_frac"] == pytest.approx(0.1)
    (comm,) = joined["comm"]
    assert comm["mechanism"] == "ppermute_halo"
    assert comm["total_bytes"] == pytest.approx(2 * 4096.0)


@pytest.mark.parametrize("n_padded,pads,want", [
    (8, (8,), 1), (8, (1, 2, 4, 8), 5), (1, (1, 2), 1), (2, (1, 2, 4), 2),
])
def test_least_lanes(n_padded, pads, want):
    assert profile.least_lanes(n_padded, pads) == want


def test_static_sweep_is_deterministic_and_counts_work_not_route():
    rows = profile.static_profile_sweep(quick=True, device="cpu")
    assert rows == profile.static_profile_sweep(quick=True, device="cpu")
    assert len(rows) == 4  # survey and the grid, fused and unfused
    by_prog = {}
    for r in rows:
        assert r["hbm_bytes"] > 0 and r["bottleneck"] in profile.BOTTLENECKS
        assert "capture_s" not in r
        by_prog.setdefault(r["meta"]["program"], []).append(
            (r["flops"], r["hbm_bytes"], r["hash_calls"]))
    for costs in by_prog.values():
        assert len(costs) == 2 and costs[0] == costs[1]
