"""Static-analysis CLI: source lint + schedule verification + kernel lint
(port of `repro/analysis/__main__.py`).

    python -m repro_torch.analysis                   # everything, text
    python -m repro_torch.analysis --format json     # JSON report (stdout)
    python -m repro_torch.analysis --format json --out findings.json
    python -m repro_torch.analysis --models survey alarm  # restrict sweep
    python -m repro_torch.analysis --skip-lint       # artifact checks only
    python -m repro_torch.analysis --root some/dir   # lint another tree

Runs three analyzers and merges their findings into one report:

  1. the port's convention AST lint over the source tree (`source_lint`);
  2. schedule verification: every bench model compiled through *both*
     named pipelines (default/runtime) and statically verified — races,
     comm completeness, placement, clamps, cost model (`verify`);
  3. the fused kernels' shared-memory lint over the same model set
     (`kernel_lint`).

Exit status is the report's: nonzero iff any error-severity finding.
Numpy and AST end to end: the sweep runs the pass pipeline, never the
execution backends, so this CLI needs no card.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

from repro_torch.analysis import Report
from repro_torch.analysis import kernel_lint, source_lint
from repro_torch.analysis import verify as verify_mod
from repro_torch.compile import ir as ir_mod
from repro_torch.compile.passes import named_pipeline, run_pipeline
from repro_torch.core.graphs import GridMRF, bn_repository_replica

# the reference's model set (its benchmarks/bench_compile.py BN_WORKLOADS)
# plus two MRF grids — small enough to sweep in seconds, wide enough
# (pigs: 441 nodes) to exercise the envelope and shared-memory paths
BENCH_BNS = ("survey", "alarm", "insurance", "water", "hepar2", "pigs")
BENCH_MRFS = ((16, 16, 4), (32, 32, 2))
PIPELINES = ("default", "runtime")


def iter_models(names=None):
    """(name, structure-only IR) for the sweep set."""
    for name in names if names is not None else BENCH_BNS:
        yield name, ir_mod.from_bayesnet(
            bn_repository_replica(name), evidence_mode="runtime"
        )
    if names is None:
        for h, w, v in BENCH_MRFS:
            mrf = GridMRF(h, w, v, name=f"mrf{h}x{w}v{v}")
            yield mrf.name, ir_mod.from_mrf(mrf)


def verify_sweep(models=None, mesh_shape=(4, 4)) -> Report:
    """Compile every model through both named pipelines and statically
    verify the lowered artifact.  A pipeline whose VerifyPass raises is
    recorded as its findings, not a crash — the sweep always completes."""
    report = Report(meta={"rows": [], "pipelines": list(PIPELINES)})
    for name, graph in iter_models(models):
        for pipe in PIPELINES:
            t0 = time.perf_counter()
            try:
                ctx = run_pipeline(graph, mesh_shape, named_pipeline(pipe))
                found = []
                verify_s = ctx.pass_times_s.get("verify", 0.0)
                n_rounds = len(ctx.schedule.rounds)
            except verify_mod.ScheduleVerificationError as e:
                found = list(e.findings)
                verify_s = time.perf_counter() - t0
                n_rounds = 0
            report.extend(found)
            report.meta["rows"].append({
                "model": name,
                "kind": graph.kind,
                "pipeline": pipe,
                "n_nodes": graph.n_nodes,
                "n_rounds": n_rounds,
                "n_rules": len(verify_mod.VERIFY_RULES),
                "n_findings": len(found),
                "verify_s": round(verify_s, 6),
            })
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis: source lint + schedule verify + "
                    "kernel shared-memory lint",
    )
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--out", help="also write the JSON report to this path")
    ap.add_argument(
        "--root", default=None,
        help="source tree to lint (default: the repro_torch package)",
    )
    ap.add_argument(
        "--models", nargs="*", default=None,
        help=f"bench BNs to sweep (default: {' '.join(BENCH_BNS)} + MRFs)",
    )
    ap.add_argument("--n-chains", type=int, default=32,
                    help="chain width for the kernel shared-memory lint")
    ap.add_argument("--skip-lint", action="store_true")
    ap.add_argument("--skip-verify", action="store_true")
    ap.add_argument("--skip-kernels", action="store_true")
    args = ap.parse_args(argv)

    report = Report(meta={"analyzers": []})
    if not args.skip_lint:
        root = pathlib.Path(
            args.root if args.root else pathlib.Path(__file__).parents[1]
        )
        report.extend(source_lint.lint_repo(root))
        report.meta["analyzers"].append("source_lint")
        report.meta["lint_root"] = str(root)
    if not args.skip_verify:
        sweep = verify_sweep(args.models)
        report.extend(sweep.findings)
        report.meta["analyzers"].append("verify")
        report.meta["verify_rows"] = sweep.meta["rows"]
    if not args.skip_kernels:
        graphs = [g for _, g in iter_models(args.models)]
        report.extend(
            kernel_lint.lint_kernels(graphs, n_chains=args.n_chains)
        )
        report.meta["analyzers"].append("kernel_lint")
        report.meta["smem_budget_bytes"] = kernel_lint.SMEM_BUDGET

    if args.out:
        pathlib.Path(args.out).write_text(report.to_json())
    if args.format == "json":
        print(report.to_json())
    else:
        if report.meta.get("verify_rows"):
            from repro_torch.launch.report import verification_table

            print(verification_table(report.meta["verify_rows"]))
            print()
        print(report.render_text())
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
