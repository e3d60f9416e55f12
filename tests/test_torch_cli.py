"""The port's reporting CLIs against the reference's: `python -m
repro_torch.diag`, `repro_torch.obs`, `repro_torch.analysis`, and the
runtime CLI's `--profile-out`, with the report tables they print.

  * The diag CLI at the reference test's tiny budget (survey, unfused, 16
    chains, 80 iterations, `lut_ky`): its snapshots equal the reference's
    `quality_sweep` (counts, kept draws and the oracle audit bit for bit,
    R-hat and ESS to the accumulator's float32 rounding); it exits 1 on an
    injected breach and declares an over-limit oracle `n/a` as a warning.
  * `profile_table`, `quality_table` and `verification_table` render the
    same rows into the reference's bytes.
  * `--profile-out` writes a profile that `python -m repro_torch.obs
    --profile` accepts.
  * The analysis CLI is clean on `src/repro_torch`; each of the port's
    source rules and the shared-memory rule is caught on an injected
    case."""

import json
import pathlib
import textwrap

import numpy as np
import pytest
import torch

from repro.analysis.__main__ import verify_sweep as r_verify_sweep
from repro.diag import __main__ as r_diag_cli
from repro.launch import report as r_report
from repro_torch import obs
from repro_torch.analysis import kernel_lint, source_lint
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.__main__ import verify_sweep
from repro_torch.compile import ir as compile_ir
from repro_torch.compile.program import clear_program_cache
from repro_torch.core.graphs import GridMRF, bn_repository_replica
from repro_torch.diag import __main__ as diag_cli
from repro_torch.launch import report
from repro_torch.obs import profile
from repro_torch.obs.__main__ import main as obs_main
from repro_torch.runtime.__main__ import main as runtime_main

SRC_ROOT = pathlib.Path(source_lint.__file__).parents[1]  # src/repro_torch

TINY = dict(n_chains=16, n_iters=80, burn_in=20, sampler="lut_ky",
            rhat_threshold=5.0, tv_threshold=1.0, ess_floor=0.0)
_TINY_ARGS = ["--models", "survey", "--variants", "unfused",
              "--n-chains", "16", "--n-iters", "80", "--burn-in", "20",
              "--device", "cpu"]


@pytest.fixture(autouse=True)
def _off():
    obs.disable()
    profile.disable()
    clear_program_cache()
    yield
    obs.disable()
    profile.disable()
    clear_program_cache()


@pytest.fixture(scope="module")
def sweeps():
    """The port's and the reference's quality sweeps at the tiny budget."""
    mine = diag_cli.quality_sweep(("survey",), ("unfused",), device="cpu",
                                  **TINY)
    theirs = r_diag_cli.quality_sweep(("survey",), ("unfused",), **TINY)
    return mine, theirs


# ---------------------------------------------------------------------------
# the diag CLI
# ---------------------------------------------------------------------------


# the quality accumulator's float32 moments: XLA's compiled update and the
# port's round a few last bits apart (tests/test_torch_diag.py, the same
# tolerance); everything drawn or counted is bit-equal
STAT_TOL = dict(rtol=1e-4, atol=1e-6)
STATS = ("rhat", "ess", "rhat_max", "ess_min")


def test_diag_snapshots_equal_the_reference(sweeps):
    mine, theirs = sweeps
    assert list(mine.meta["snapshots"]) == ["survey/unfused"]
    a = mine.meta["snapshots"]["survey/unfused"]
    b = theirs.meta["snapshots"]["survey/unfused"]
    assert sorted(a) == sorted(b)
    for k in a:
        if k in STATS:
            np.testing.assert_allclose(a[k], b[k], **STAT_TOL, err_msg=k)
        else:
            assert a[k] == b[k], k
    rows = (mine.meta["rows"][0], theirs.meta["rows"][0])
    for k in rows[0]:
        if k in STATS or k == "wall_s":
            continue
        assert rows[0][k] == rows[1][k], k
    np.testing.assert_allclose(rows[0]["rhat_max"], rows[1]["rhat_max"],
                               **STAT_TOL)
    assert [f.to_dict() for f in mine.findings] == \
        [f.to_dict() for f in theirs.findings]
    assert mine.meta["budget"] == theirs.meta["budget"]
    assert mine.meta["thresholds"] == theirs.meta["thresholds"]


def test_quality_table_equals_the_reference(sweeps):
    for rows in (sweeps[0].meta["rows"], sweeps[1].meta["rows"]):
        assert report.quality_table(rows) == r_report.quality_table(rows)
    na = dict(sweeps[0].meta["rows"][0], rhat_max=None, ess_min=None,
              oracle="n/a", tv_max=None, maxabs_max=None)
    assert report.quality_table([na]) == r_report.quality_table([na])
    assert "| n/a |" in report.quality_table([na])


def test_diag_cli_defaults_match_the_reference():
    for name in ("BENCH_BNS", "VARIANTS", "DEFAULT_N_CHAINS",
                 "DEFAULT_N_ITERS", "DEFAULT_BURN_IN", "QUICK_N_ITERS",
                 "QUICK_BURN_IN", "DEFAULT_RHAT", "DEFAULT_TV",
                 "DEFAULT_ESS_FLOOR", "DEFAULT_SEED"):
        assert getattr(diag_cli, name) == getattr(r_diag_cli, name), name


def test_diag_cli_passes_with_sane_thresholds(tmp_path, capsys):
    out = tmp_path / "snap.json"
    rc = diag_cli.main(_TINY_ARGS + ["--rhat-threshold", "5",
                                     "--tv-threshold", "1",
                                     "--ess-floor", "0", "--out", str(out)])
    assert rc == 0
    snap = json.loads(out.read_text())
    assert snap["n_errors"] == 0
    (row,) = snap["meta"]["rows"]
    assert (row["model"], row["variant"]) == ("survey", "unfused")
    assert row["oracle"] == "ok" and row["kept"] == 60
    assert "| survey | unfused |" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--rhat-threshold", "0.5", "--tv-threshold", "1", "--ess-floor", "0"],
    ["--rhat-threshold", "5", "--tv-threshold", "1", "--ess-floor", "1e9"],
])
def test_diag_cli_exits_nonzero_on_injected_breach(flags):
    assert diag_cli.main(_TINY_ARGS + flags) == 1


def test_diag_cli_declares_oracle_na_as_warning():
    rep = diag_cli.quality_sweep(("survey",), ("unfused",), ve_limit=1,
                                 device="cpu", **TINY)
    assert [f.rule for f in rep.warnings] == ["diag-oracle-unavailable"]
    assert rep.exit_code == 0
    assert rep.meta["rows"][0]["oracle"] == "n/a"


def test_clis_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runtime_main(["--trace", "zipf", "--quick"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        diag_cli.main(["--quick"])


# ---------------------------------------------------------------------------
# --profile-out and the obs CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    path = tmp_path_factory.mktemp("prof") / "profile.json"
    rc = runtime_main([
        "--quick", "--trace", "zipf", "--device", "cpu", "--fused",
        "--workers", "2", "--shard-width", "2", "--shard-min-sites", "16",
        "--no-pins", "--profile-out", str(path),
    ])
    return rc, path


def test_profile_out_writes_what_the_obs_cli_accepts(profiled, capsys):
    rc, path = profiled
    assert rc == 0
    assert not profile.enabled() and not obs.enabled()
    rec = json.loads(path.read_text())
    assert profile.validate_profile(rec) == []
    assert rec["joined"]["n_sharded"] > 0
    assert rec["peaks"]["hbm_bw"] == 3.35e12
    assert path.with_suffix(".series.jsonl").exists()
    assert obs_main(["--profile", str(path)]) == 0
    out = capsys.readouterr().out
    assert "0 unattributed" in out and "| comm | ppermute_halo |" in out


def test_obs_cli_fails_on_an_unattributed_dispatch(profiled, tmp_path):
    rec = json.loads(profiled[1].read_text())
    rec["joined"]["unattributed"] = [{"sig": "bucket|x", "model": "m",
                                      "program": "p", "n_dispatches": 2}]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(rec))
    assert obs_main(["--profile", str(bad)]) == 2


def test_profile_table_equals_the_reference(profiled):
    rec = json.loads(profiled[1].read_text())
    rows, comm = rec["joined"]["rows"], rec["joined"]["comm"]
    assert rows and comm
    assert report.profile_table(rows, comm) == \
        r_report.profile_table(rows, comm)
    assert report.profile_table(rows) == r_report.profile_table(rows)


# ---------------------------------------------------------------------------
# the analysis CLI, the source lint and the kernel lint
# ---------------------------------------------------------------------------


def test_verification_table_and_rows_equal_the_reference():
    models = ("survey", "alarm")
    mine = verify_sweep(models).meta["rows"]
    theirs = r_verify_sweep(models).meta["rows"]
    strip = lambda rows: [{k: v for k, v in r.items() if k != "verify_s"}
                          for r in rows]
    assert strip(mine) == strip(theirs)
    for rows in (mine, theirs):
        assert report.verification_table(rows) == \
            r_report.verification_table(rows)


def test_analysis_cli_clean_on_the_port(tmp_path, capsys):
    out = tmp_path / "findings.json"
    rc = analysis_main(["--format", "json", "--out", str(out)])
    assert rc == 0
    data = json.loads(out.read_text())
    assert data["n_findings"] == 0, data["findings"]
    assert data["meta"]["analyzers"] == ["source_lint", "verify",
                                         "kernel_lint"]
    assert data["meta"]["lint_root"] == str(SRC_ROOT)
    assert data["meta"]["smem_budget_bytes"] == 232448


def test_analysis_cli_injected_violation_exits_nonzero(tmp_path):
    bad = tmp_path / "repro_torch" / "kernels" / "sabotage.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import triton\n")
    out = tmp_path / "findings.json"
    rc = analysis_main(["--skip-verify", "--skip-kernels", "--root",
                        str(tmp_path), "--format", "json", "--out", str(out)])
    assert rc == 1
    (f,) = json.loads(out.read_text())["findings"]
    assert f["rule"] == "port-import"


def _lint(tmp_path, rel, code):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(code))
    return [f.rule for f in source_lint.lint_file(p, root=tmp_path)]


# (file, code, rules found): each rule caught, and its clean counterpart
LINT_CASES = {
    "jax": ("repro_torch/core/x.py", "import jax.numpy as jnp\n",
            ["port-import"]),
    "reference": ("repro_torch/obs/x.py", "from repro.obs import tracer\n",
                  ["port-import"]),
    "triton-top": ("repro_torch/kernels/x.py", "import triton\n",
                   ["port-import"]),
    "triton-lazy": ("repro_torch/kernels/x.py", """
        def launch():
            import triton.language as tl
            return tl
        """, []),
    "relative": ("repro_torch/kernels/x.py", "from . import _lib\n", []),
    "rng": ("repro_torch/runtime/x.py", """
        import torch

        def f(x):
            return torch.rand(3) + torch.randint(0, 4, (3,)) + x.uniform_()
        """, ["torch-random-unkeyed"] * 3),
    "rng-keyed": ("repro_torch/runtime/x.py", """
        import torch

        def f(g):
            return torch.rand(3, generator=g)
        """, []),
    "twin-division": ("repro_torch/kernels/x.py", """
        def twin(x):
            return x / 2.0 + x / -0.5
        """, ["twin-float-division"] * 2),
    "twin-division-scalar": ("repro_torch/core/x.py", """
        from repro_torch.core.interp import scalar

        def twin(x):
            return x / scalar(2.0, x.device) + x / 2
        """, []),
    "division-outside-twins": ("repro_torch/runtime/x.py", """
        def rate(n):
            return n / 2.0
        """, []),
    "wallclock": ("repro_torch/runtime/engine.py", """
        import time

        def tick():
            return time.perf_counter()
        """, ["wallclock-in-sim"]),
    "wallclock-allowed": ("repro_torch/runtime/engine.py", """
        import time

        def tick():
            return time.perf_counter()  # lint: allow[wallclock-in-sim]
        """, []),
    "assert": ("repro_torch/compile/x.py", """
        def check(x):
            assert x > 0
        """, ["bare-assert"]),
    "assert-outside": ("repro_torch/runtime/x.py", """
        def check(x):
            assert x > 0
        """, []),
}


@pytest.mark.parametrize("case", sorted(LINT_CASES))
def test_source_lint_catches_each_rule(tmp_path, case):
    rel, code, want = LINT_CASES[case]
    assert _lint(tmp_path, rel, code) == want


def test_port_lints_clean():
    findings = source_lint.lint_repo(SRC_ROOT)
    assert findings == [], "\n".join(f.render() for f in findings)


def _ir(graph):
    if isinstance(graph, GridMRF):
        return compile_ir.from_mrf(graph)
    return compile_ir.from_bayesnet(graph, evidence_mode="runtime")


def test_kernel_lint_judges_shared_memory():
    pigs = _ir(bn_repository_replica("pigs"))
    fp = kernel_lint.estimate_footprint(pigs, 1024)
    # two blocks per SM: 1,024 chains over 264 blocks, 3 chains a block
    assert fp.breakdown == {"chain_values": 3 * 441 * 4, "exp_lut": 64}
    assert kernel_lint.lint_kernels([pigs], n_chains=1024) == []
    (f,) = kernel_lint.lint_kernels([pigs], n_chains=1024, budget=5_000)
    assert (f.rule, f.severity) == ("smem-budget", "warning")
    (f,) = kernel_lint.lint_kernels([pigs], n_chains=1024, budget=5_000,
                                    demotable=False)
    assert (f.rule, f.severity) == ("smem-budget", "error")
    (f,) = kernel_lint.lint_kernels([pigs], n_chains=1024, budget=7_000)
    assert (f.rule, f.severity) == ("smem-pressure", "warning")


@pytest.mark.parametrize("grid,rules,fits", [
    (GridMRF(64, 64, 4), [], True),
    (GridMRF(4, 20_000, 2), ["smem-budget"], False),
    (GridMRF(8, 8, 130), ["ky-lanes"], False),
])
def test_kernel_lint_demotes_what_does_not_fit(grid, rules, fits):
    g = _ir(grid)
    assert [f.rule for f in kernel_lint.lint_kernels([g])] == rules
    assert kernel_lint.fused_fits(g, 64) is fits
    fp = kernel_lint.estimate_footprint(g, 64)
    assert fp.total_bytes == sum(fp.breakdown.values())
