"""Sampling-quality CLI: convergence + exact-marginal audit over the zoo
(port of `repro/diag/__main__.py`).

    python -m repro_torch.diag                    # full sweep, on the card
    python -m repro_torch.diag --quick            # CI budget (survey only)
    python -m repro_torch.diag --quick --device cpu   # the kernels' twins
    python -m repro_torch.diag --format json --out quality-snapshot.json
    python -m repro_torch.diag --models survey alarm  # restrict the sweep
    python -m repro_torch.diag --variants unfused     # skip the fused kernels
    python -m repro_torch.diag --rhat-threshold 1.05  # tighten the gate

Runs every selected bench BN through `CompiledProgram.run(diagnostics=True)`
on each backend variant and audits the result three ways:

  1. convergence — the streaming accumulator's split-chain R-hat and
     batch-means ESS (`diag.accum`), gated against `--rhat-threshold`
     and `--ess-floor`;
  2. faithfulness — total-variation / max-abs error of the empirical
     marginals against variable elimination (`diag.oracle`), gated
     against `--tv-threshold`; models whose min-fill VE cost estimate
     exceeds `--ve-limit` are *declared* `n/a` (a warning finding), never
     silently skipped;
  3. trustworthiness — the accumulator's own overflow/nonfinite flags.

Exit status is the report's: nonzero iff any error-severity finding —
the same contract as `python -m repro_torch.analysis`.  The threshold flags
double as the breach-injection mechanism the acceptance tests use (pass
an impossible threshold, expect exit 1).

Default model set is the VE-tractable zoo plus `water` (whose cost
estimate sits just above the default limit — it exercises the declared
`n/a` path).  `hepar2`/`pigs` are selectable via `--models` but excluded
by default, as in the reference (whose fused backend runs in interpret
mode off a TPU), so that both CLIs sweep the same zoo.  `--device`
(default `cuda`) picks where the sweep runs: on the card the fused
variant runs K3, on the CPU its twin.  The snapshots are bit-equal to the
reference's on the same seed and budget (`lut_ky`).
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

from repro_torch import prng
from repro_torch.analysis import Finding, Report
from repro_torch.compile.program import compile_graph
from repro_torch.core.graphs import bn_repository_replica
from repro_torch.diag import oracle as oracle_mod

# default sweep: the tractable zoo (survey/alarm/insurance under the
# default VE limit) + water for the declared-n/a oracle path
BENCH_BNS = ("survey", "alarm", "insurance", "water")
VARIANTS = ("unfused", "fused")

# full-budget defaults: 128 chains x 800 kept draws clears both gates
# with ~2x margin on every default model — alarm, the slowest mixer and
# the coarsest-quantized (lut_ky per-CPT TV floor ~0.010), lands at
# R-hat ~1.04 and TV-vs-VE ~0.009.  Width beats length here: cross-chain
# averaging shrinks marginal noise faster than longer (autocorrelated)
# chains do, and it parallelizes for free under vmap
DEFAULT_N_CHAINS = 128
DEFAULT_N_ITERS = 1000
DEFAULT_BURN_IN = 200
# --quick (the CI budget): survey only, 300 kept
QUICK_N_ITERS = 400
QUICK_BURN_IN = 100

DEFAULT_RHAT = 1.1
DEFAULT_TV = 0.02
DEFAULT_ESS_FLOOR = 100.0
DEFAULT_SEED = 0xA1A


def quality_sweep(
    models=BENCH_BNS,
    variants=VARIANTS,
    *,
    n_chains: int = DEFAULT_N_CHAINS,
    n_iters: int = DEFAULT_N_ITERS,
    burn_in: int = DEFAULT_BURN_IN,
    sampler: str = "lut_ky",
    seed: int = DEFAULT_SEED,
    rhat_threshold: float = DEFAULT_RHAT,
    tv_threshold: float = DEFAULT_TV,
    ess_floor: float = DEFAULT_ESS_FLOOR,
    ve_limit: int = oracle_mod.DEFAULT_VE_LIMIT,
    device="cuda",
) -> Report:
    """Run the quality sweep on `device` and fold every audit into one
    Report.

    One row per (model, variant) lands in `report.meta["rows"]` — the
    schema `launch.report.quality_table` renders — and the full
    accumulator snapshots in `report.meta["snapshots"]` keyed
    "model/variant"."""
    report = Report(meta={
        "rows": [],
        "snapshots": {},
        "budget": {
            "n_chains": n_chains, "n_iters": n_iters, "burn_in": burn_in,
            "sampler": sampler, "seed": seed,
        },
        "thresholds": {
            "rhat": rhat_threshold, "tv": tv_threshold,
            "ess_floor": ess_floor, "ve_limit": ve_limit,
        },
    })
    for name in models:
        bn = bn_repository_replica(name)
        prog = compile_graph(bn, device=device)
        # per-model, variant-independent: worst-case KY-quantization TV —
        # the error floor the sampler's integer pmf imposes before any
        # sampling noise (fused and unfused share the quantized tables)
        ky_tv = float(oracle_mod.ky_quantization_tv(bn, sampler)["tv_max"])
        for variant in variants:
            loc = f"{name}/{variant}"
            t0 = time.perf_counter()
            marginals, _, snap = prog.run(
                key=prng.key(seed),
                n_chains=n_chains,
                n_iters=n_iters,
                burn_in=burn_in,
                sampler=sampler,
                fused=variant == "fused",
                diagnostics=True,
                device=device,
            )
            wall_s = time.perf_counter() - t0
            brief = snap.brief()
            audit = oracle_mod.oracle_audit(bn, marginals.cpu().numpy(),
                                            limit=ve_limit)

            if brief["overflow_risk"] or not brief["finite"]:
                why = ("kept-draw count near int32/f32 exactness headroom"
                       if brief["overflow_risk"]
                       else "non-finite accumulator statistics")
                report.extend([Finding(
                    "diag-accum-overflow", loc,
                    f"quality accumulator untrustworthy: {why}",
                    fixit="shorten the run or widen the accumulator dtypes",
                )])
            rhat = brief["rhat_max"]
            if rhat is not None and rhat > rhat_threshold:
                report.extend([Finding(
                    "diag-threshold-breach", loc,
                    f"split R-hat {rhat:.4f} exceeds threshold "
                    f"{rhat_threshold} — chains not converged",
                    fixit="raise n_iters/burn_in or inspect the schedule",
                )])
            ess = brief["ess_min"]
            if ess is not None and ess < ess_floor:
                report.extend([Finding(
                    "diag-threshold-breach", loc,
                    f"min per-site ESS {ess:.0f} below floor "
                    f"{ess_floor:.0f} — draws too autocorrelated",
                    fixit="raise n_iters or thin less aggressively",
                )])
            if audit["status"] == "ok":
                if audit["tv_max"] > tv_threshold:
                    report.extend([Finding(
                        "diag-threshold-breach", loc,
                        f"worst-node TV vs exact marginals "
                        f"{audit['tv_max']:.4f} exceeds threshold "
                        f"{tv_threshold} — sampler unfaithful at this "
                        "budget",
                        fixit="raise the budget; if ky_tv dominates, raise "
                              "the KY quantization bits",
                    )])
            else:
                report.extend([Finding(
                    "diag-oracle-unavailable", loc,
                    f"exact-marginal audit n/a: min-fill VE cost estimate "
                    f"{audit['ve_cost']} exceeds limit {ve_limit}",
                    fixit="raise --ve-limit to force the audit",
                )])

            row = {
                "model": name,
                "variant": variant,
                "n_nodes": int(bn.n_nodes),
                "n_chains": n_chains,
                "kept": int(brief["kept"]),
                "rhat_max": rhat,
                "ess_min": ess,
                "oracle": audit["status"],
                "tv_max": audit.get("tv_max"),
                "maxabs_max": audit.get("maxabs_max"),
                "ky_tv": ky_tv,
                "wall_s": round(wall_s, 3),
            }
            report.meta["rows"].append(row)
            report.meta["snapshots"][loc] = snap.to_dict()
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.diag",
        description="sampling-quality sweep: R-hat/ESS convergence + "
                    "exact-marginal audit over the bench zoo",
    )
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--out", help="also write the JSON report to this path")
    ap.add_argument(
        "--models", nargs="*", default=None,
        help=f"bench BNs to sweep (default: {' '.join(BENCH_BNS)})",
    )
    ap.add_argument(
        "--variants", nargs="*", default=None, choices=VARIANTS,
        help="backend variants to run (default: both)",
    )
    ap.add_argument("--n-chains", type=int, default=DEFAULT_N_CHAINS)
    ap.add_argument("--n-iters", type=int, default=None)
    ap.add_argument("--burn-in", type=int, default=None)
    ap.add_argument("--sampler", default="lut_ky",
                    choices=("lut_ky", "exact_ky"))
    ap.add_argument("--seed", type=lambda s: int(s, 0), default=DEFAULT_SEED)
    ap.add_argument("--rhat-threshold", type=float, default=DEFAULT_RHAT)
    ap.add_argument("--tv-threshold", type=float, default=DEFAULT_TV)
    ap.add_argument("--ess-floor", type=float, default=DEFAULT_ESS_FLOOR)
    ap.add_argument("--ve-limit", type=int,
                    default=oracle_mod.DEFAULT_VE_LIMIT)
    ap.add_argument(
        "--quick", action="store_true",
        help="CI budget: survey only, short run, both variants",
    )
    ap.add_argument("--device", default="cuda",
                    help="where to sweep: cuda (the default) or cpu")
    args = ap.parse_args(argv)

    models = tuple(args.models) if args.models is not None else (
        ("survey",) if args.quick else BENCH_BNS
    )
    variants = tuple(args.variants) if args.variants else VARIANTS
    n_iters = args.n_iters if args.n_iters is not None else (
        QUICK_N_ITERS if args.quick else DEFAULT_N_ITERS
    )
    burn_in = args.burn_in if args.burn_in is not None else (
        QUICK_BURN_IN if args.quick else DEFAULT_BURN_IN
    )

    report = quality_sweep(
        models, variants,
        n_chains=args.n_chains,
        n_iters=n_iters,
        burn_in=burn_in,
        sampler=args.sampler,
        seed=args.seed,
        rhat_threshold=args.rhat_threshold,
        tv_threshold=args.tv_threshold,
        ess_floor=args.ess_floor,
        ve_limit=args.ve_limit,
        device=args.device,
    )

    if args.out:
        pathlib.Path(args.out).write_text(report.to_json())
    if args.format == "json":
        print(report.to_json())
    else:
        from repro_torch.launch.report import quality_table

        print(quality_table(report.meta["rows"]))
        print()
        print(report.render_text())
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
