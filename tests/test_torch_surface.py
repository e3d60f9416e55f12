"""The reference's last functions in the port, and the port's surface
against the reference's, on the CPU:

  * `core/ky.entropy` equals the reference's bit for bit as a float64, and
    the Fig. 11 unit check holds on the port's KY draw (bits per sample
    at most H + 2.1, fewer for a peaked row than a flat one);
  * `launch/report`'s `compile_table` and `runtime_table` render seeded
    records that reach every branch into the reference's bytes, and
    `report.main` prints their sections when `compile/` and `runtime/`
    sit beside the dry run's directory;
  * every top-level public function and class of each reference module
    has a namesake in its port module, except the names `NO_PORT` lists
    with the reason each has none, and each reference example has a
    `torch_` counterpart."""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ky as r_ky
from repro.kernels import ops as r_ops
from repro.launch import report as r_report
from repro_torch import prng
from repro_torch.core import ky as t_ky
from repro_torch.kernels import ops as t_ops
from repro_torch.launch import report

ROOT = Path(__file__).resolve().parents[1]

# reference modules with no port module, and reference names with no
# namesake in their port module: each with its reason
NO_PORT_MODULES = {
    "kernels/ref.py": "its jnp oracles are the torch twins "
    "(`kernels/*_ref`)",
    "core/compat.py": "it holds jax API shims",
    "launch/hlo_cost.py": "it reads XLA HLO; `launch/kernel_cost.py` "
    "counts the port's work from launch shapes",
}
NO_PORT = {
    "launch/roofline.py": {"parse_collectives": "it reads XLA HLO text"},
    "analysis/kernel_lint.py": {
        name: "a TPU VMEM budget: the port's `SMEM_BUDGET` is one H100 "
        "block's shared memory and takes no mesh-slice width"
        for name in ("vmem_budget", "set_vmem_budget", "bn_group_envelope")},
    "models/transformer.py": {"init_superblock": "the port builds a block "
                              "at a time (`init_block`)"},
    "kernels/interp_lut.py": {"interp_eval": "a Pallas kernel body's "
                              "helper: `interp_kernel_ref` is its twin"},
    "kernels/ky_sampler.py": {
        "preprocess_lanes": "a Pallas kernel body's helper: "
        "`core/ky.prepare` is its twin",
        "ddg_walk": "a Pallas kernel body's helper: `ky_sample_kernel_ref` "
        "walks as it does"},
    "kernels/mrf_gibbs.py": {
        "mrf_half_step_kernel": "the K4 kernel body: `mrf_half_step` "
        "launches its CUDA counterpart",
        "mrf_halo_half_step_kernel": "the K6 kernel body: "
        "`mrf_halo_half_step` launches its CUDA counterpart"},
}


def _public_names(path: Path, imported: bool = False) -> set:
    """Top-level public functions and classes of a module; with
    `imported`, also the names it imports (a port module may re-export a
    function kept elsewhere)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif imported and isinstance(node, ast.ImportFrom):
            out.update(a.asname or a.name for a in node.names)
    return {n for n in out if not n.startswith("_")}


def test_every_reference_name_has_a_port_or_a_reason():
    ref, port = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
    missing_modules, missing = set(), {}
    for f in sorted(ref.rglob("*.py")):
        rel = f.relative_to(ref).as_posix()
        twin = port / rel
        if not twin.exists():
            missing_modules.add(rel)
            continue
        gone = _public_names(f) - _public_names(twin, imported=True)
        if gone:
            missing[rel] = gone
    assert missing_modules == set(NO_PORT_MODULES)
    assert missing == {m: set(names) for m, names in NO_PORT.items()}
    for example in sorted((ROOT / "examples").glob("*.py")):
        if not example.name.startswith("torch_"):
            assert (example.parent / f"torch_{example.name}").exists(), (
                example.name)


@pytest.mark.parametrize("seed", range(4))
def test_entropy_is_the_references(seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 256, 1 + seed * 7)
    w[rng.random(w.shape) < 0.3] = 0
    w[0] = 1 + w[0]  # a row with mass
    for p in (w, w.astype(np.float32) / 7.0, [240, 2, 2, 2], [1]):
        got, want = t_ky.entropy(p), r_ky.entropy(np.asarray(p))
        assert type(got) is float
        assert np.float64(got).tobytes() == np.float64(want).tobytes()


def test_entropy_scaling_bits_used():
    """Fig. 11 at unit level, on the port's KY draw (its CPU twin):
    expected bits a sample track the entropy H (at most H + 2), so a
    low-entropy row samples faster; the same draw as the reference's
    (tests/test_ky_sampler.py)."""
    b = 4000
    rows = {"peaked": [240, 2, 2, 2], "flat": [61, 61, 62, 62]}
    bits = {}
    for name, w in rows.items():
        weights = torch.tensor(w, dtype=torch.int32).repeat(b, 1)
        labels, st = t_ops.ky_sample(weights, prng.key(0), return_stats=True)
        bits[name] = float(st["bits_used"].double().mean())
        r_labels, r_st = r_ops.ky_sample(
            jnp.tile(jnp.asarray(w, jnp.int32), (b, 1)), jax.random.key(0),
            return_stats=True)
        assert np.array_equal(labels.numpy(), np.asarray(r_labels))
        assert np.array_equal(st["bits_used"].numpy(),
                              np.asarray(r_st["bits_used"]))
        assert bits[name] <= t_ky.entropy(np.array(w)) + 2.1
    assert bits["peaked"] < bits["flat"]


def _compile_records(rng) -> list:
    """Compile-chain records: one with every optional field, one with
    none (the "—" cells)."""
    recs = []
    for i, kind in enumerate(("bn", "mrf", "bn")):
        r = {"workload": f"w{i}", "kind": kind,
             "n_nodes": int(rng.integers(5, 500)),
             "n_colors": int(rng.integers(2, 9)),
             "compile_cold_ms": float(rng.random() * 100),
             "compile_warm_us": float(rng.random() * 50),
             "cache_hit_rate": float(rng.random()),
             "sweep_cycles": int(rng.integers(0, 9000)),
             "random_sweep_cycles": int(rng.integers(1, 9000)),
             "comm_hop_bytes": int(rng.integers(0, 4096)),
             "random_hop_bytes": int(rng.integers(1, 4096))}
        if i != 1:
            r.update(eager_sweep_s=float(rng.random() * 2),
                     schedule_sweep_s=float(rng.random() * 1e-3),
                     cache_evictions=int(rng.integers(0, 4)),
                     cache_size=int(rng.integers(1, 8)), cache_capacity=8)
        recs.append(r)
    return recs


def _runtime_records(rng) -> list:
    """Runtime records: quality fields present and absent ("n/a"), an
    absent `sim_latency_p99_ms`, and one with the executor's gates (the
    footer)."""
    recs = []
    for i, (trace, backend) in enumerate((("zipf", "schedule"),
                                          ("bursty", "eager"),
                                          ("zipf", "eager"))):
        r = {"trace": trace, "backend": backend, "n_models": i + 2,
             "n_queries": int(rng.integers(10, 200)),
             "mean_batch": float(rng.random() * 8),
             "batched_qps": float(rng.random() * 500),
             "serial_qps": float(rng.random() * 100),
             "speedup": float(rng.random() * 6),
             "cache_hit_rate": float(rng.random()),
             "cache_evictions": int(rng.integers(0, 5)),
             "recompiles": int(rng.integers(0, 3)),
             "sim_latency_p95_ms": float(rng.random() * 30)}
        if i != 1:
            r.update(sim_latency_p99_ms=float(rng.random() * 60),
                     rhat_max=float(1 + rng.random() / 10),
                     ess_min=float(rng.random() * 900),
                     trace_dropped=int(rng.integers(0, 3)))
        if i == 2:
            r.update(workers_speedup=float(1 + rng.random() * 3),
                     slicing_batches=int(rng.integers(1, 9)),
                     calib_median_err=float(rng.random() / 5),
                     bursty_max_queue_depth=int(rng.integers(1, 64)),
                     bursty_shed_rate=float(rng.random() / 4),
                     bursty_defers=int(rng.integers(0, 40)))
        recs.append(r)
    return recs


@pytest.mark.parametrize("seed", range(3))
def test_compile_and_runtime_tables_are_the_references(seed):
    rng = np.random.default_rng(seed)
    crecs, rrecs = _compile_records(rng), _runtime_records(rng)
    got = report.compile_table(crecs)
    assert got == r_report.compile_table(crecs)
    assert "| — | — |" in got
    got = report.runtime_table(rrecs)
    assert got == r_report.runtime_table(rrecs)
    assert "| n/a | n/a | n/a | n/a |" in got
    assert "executor gates:" in got
    assert report.runtime_table(rrecs[:2]) == r_report.runtime_table(
        rrecs[:2])
    assert "executor gates" not in report.runtime_table(rrecs[:2])


def test_report_main_prints_the_compile_and_runtime_sections(tmp_path,
                                                             capsys):
    rng = np.random.default_rng(7)
    dry = tmp_path / "dryrun"
    dry.mkdir()
    (dry / "yi-9b__train_4k__single__baseline.json").write_text(json.dumps(
        {"arch": "yi-9b", "cell": "train_4k", "mesh": "single",
         "status": "skipped", "reason": "a record the test wrote"}))
    assert report.main([str(dry)]) == 0
    printed = capsys.readouterr().out
    assert "## Compile chain" not in printed
    assert "## Serving runtime" not in printed
    for sub, recs in (("compile", _compile_records(rng)),
                      ("runtime", _runtime_records(rng))):
        (tmp_path / sub).mkdir()
        for i, r in enumerate(recs):
            (tmp_path / sub / f"{i}.json").write_text(json.dumps(r))
    assert report.load_compile(str(tmp_path / "runtime")) == \
        r_report.load_compile(str(tmp_path / "runtime"))
    assert report.main([str(dry)]) == 0
    printed = capsys.readouterr().out
    crecs = report.load_compile(str(tmp_path / "compile"))
    rrecs = report.load_compile(str(tmp_path / "runtime"))
    assert ("## Compile chain (repro_torch.compile)\n\n"
            + r_report.compile_table(crecs) + "\n") in printed
    assert ("## Serving runtime (repro_torch.runtime)\n\n"
            + r_report.runtime_table(rrecs) + "\n") in printed
