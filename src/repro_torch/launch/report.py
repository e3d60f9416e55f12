"""Report tables the port's CLIs print (port of the reference's
`launch/report.py`).

`profile_table`, `quality_table`, `verification_table`, `compile_table`
and `runtime_table` render the same rows into the same bytes as the
reference's; `attribution_table` is `obs.attrib`'s.  `main` prints the
compile and runtime tables too when `compile/` and `runtime/` record
directories (`load_compile`) sit beside the dry run's.  `load`,
`roofline_table`, `dryrun_table` and `bottleneck_notes` render the LM
dry run's JSONs (`launch/dryrun.py`): its numbers are computed from
shapes on meta tensors, never measured, and each table says so.  Their
memory column holds a rank's peak live bytes against one H100's 80 GB.

    PYTHONPATH=src python -m repro_torch.launch.report build/dryrun
"""

from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.obs.attrib import attribution_table  # noqa: F401


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def _fmt_q(x, spec: str) -> str:
    return "n/a" if x is None else format(x, spec)


def verification_table(rows: list[dict]) -> str:
    """Static-verification sweep view (`python -m repro_torch.analysis`):
    one row per (model, pipeline) with the rules run, findings raised,
    round count, and verifier wall time — the summary the CLI prints above
    its findings."""
    out = [
        "| model | kind | pipeline | nodes | rounds | rules | findings | "
        "verify |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        status = str(r["n_findings"]) if r["n_findings"] else "clean"
        out.append(
            f"| {r['model']} | {r['kind']} | {r['pipeline']} "
            f"| {r['n_nodes']} | {r['n_rounds']} | {r['n_rules']} "
            f"| {status} | {_fmt_s(r['verify_s'])} |"
        )
    return "\n".join(out)


def quality_table(rows: list[dict]) -> str:
    """Sampling-quality sweep view (`python -m repro_torch.diag`): one row per
    (model, backend variant) with the convergence diagnostics (worst split
    R-hat, smallest per-site ESS), the exact-marginal audit (total-variation
    and max-abs error vs variable elimination, or "n/a" when the min-fill
    cost estimate ruled VE intractable), kept-draw count, and sweep wall
    time.  This is the table the diag CLI prints above its findings and the
    CI quality job archives next to the JSON snapshot."""
    out = [
        "| model | variant | nodes | chains | kept | rhat max | ess min | "
        "oracle | tv max | maxabs | ky tv | wall |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        out.append(
            f"| {r['model']} | {r['variant']} | {r['n_nodes']} "
            f"| {r['n_chains']} | {r['kept']} "
            f"| {_fmt_q(r.get('rhat_max'), '.4f')} "
            f"| {_fmt_q(r.get('ess_min'), '.0f')} "
            f"| {r['oracle']} | {_fmt_q(r.get('tv_max'), '.4f')} "
            f"| {_fmt_q(r.get('maxabs_max'), '.4f')} "
            f"| {_fmt_q(r.get('ky_tv'), '.2e')} "
            f"| {_fmt_s(r['wall_s'])} |"
        )
    return "\n".join(out)


def profile_table(rows: list[dict], comm: list[dict] | None = None) -> str:
    """Roofline view (`repro_torch.obs.profile`): one row per dispatch
    signature with its static costs (flops / HBM bytes / collective bytes
    counted from launch shapes by `launch.kernel_cost`), the roofline
    bottleneck, the roofline lower bound, and the measured dispatch mean
    with achieved-vs-peak — followed by per-comm-mechanism rows.  Rendered
    by the runtime CLI's `--profile-out` path and
    `python -m repro_torch.obs --profile`."""

    def num(x):
        return "0" if not x else f"{x:.3g}"

    out = [
        "| model | kind | sampler | fused | pad | iters x chains | disp | "
        "flops | hbm B | coll B | bottleneck | roofline | meas mean | "
        "peak frac |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        m = r.get("meta", {})
        meas = r.get("measured_mean_s")
        frac = r.get("peak_frac")
        out.append(
            f"| {m.get('model', '—')} | {m.get('kind', '—')} "
            f"| {m.get('sampler', '—')} | {int(bool(m.get('fused')))} "
            f"| {m.get('n_padded', '—')} "
            f"| {m.get('n_iters', '—')}x{m.get('n_chains', '—')} "
            f"| {r.get('n_dispatches', 0)} "
            f"| {num(r['flops'])} | {num(r['hbm_bytes'])} "
            f"| {num(r['collective_bytes'])} | {r['bottleneck']} "
            f"| {_fmt_s(r['roofline_s'])} "
            f"| {_fmt_s(meas) if meas is not None else 'n/a'} "
            f"| {_fmt_q(frac, '.2%')} |"
        )
    for c in comm or []:
        bw = c.get("achieved_bw")
        out.append(
            f"| comm | {c['mechanism']} | {c['hlo_op']} | — | — | — "
            f"| {c['n_dispatches']} | — | — | {num(c['total_bytes'])} "
            f"| collective | — "
            f"| {_fmt_s(c['measured_total_s'])} "
            f"| {'n/a' if bw is None else f'{bw / 1e9:.3g}GB/s'} |"
        )
    return "\n".join(out)


def load_compile(results_dir: str) -> list[dict]:
    """Every result JSON under `results_dir`, in file-name order (the
    compile chain's and the serving runtime's benchmark records)."""
    out = []
    for f in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def compile_table(recs: list[dict]) -> str:
    """Per-workload view of the compile chain: compile cost, cache
    behavior (hit rate, evictions, resident size/capacity), the schedule
    the passes chose vs a random placement, and the eager-vs-schedule
    backend wall-clock per sweep."""
    rows = [
        "| workload | kind | nodes | colors | compile cold | cache hit | "
        "hit rate | evict | cached | sweep cycles | vs random | hop-bytes | "
        "vs random | eager sweep | schedule sweep |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["kind"], r["n_nodes"])):
        cyc_win = r["random_sweep_cycles"] / max(r["sweep_cycles"], 1)
        hop_win = r["random_hop_bytes"] / max(r["comm_hop_bytes"], 1)
        eager = r.get("eager_sweep_s")
        sched = r.get("schedule_sweep_s")
        evict = r.get("cache_evictions")
        size, cap = r.get("cache_size"), r.get("cache_capacity")
        cached = f"{size}/{cap}" if size is not None else "—"
        rows.append(
            f"| {r['workload']} | {r['kind']} | {r['n_nodes']} "
            f"| {r['n_colors']} | {r['compile_cold_ms']:.1f}ms "
            f"| {r['compile_warm_us']:.0f}us | {r['cache_hit_rate']:.2f} "
            f"| {evict if evict is not None else '—'} | {cached} "
            f"| {r['sweep_cycles']} | {cyc_win:.2f}x "
            f"| {r['comm_hop_bytes']} | {hop_win:.2f}x "
            f"| {_fmt_s(eager) if eager is not None else '—'} "
            f"| {_fmt_s(sched) if sched is not None else '—'} |"
        )
    return "\n".join(rows)


def runtime_table(recs: list[dict]) -> str:
    """Serving-runtime view: the batched engine vs the one-query-at-a-time
    baseline on the same trace.  The quality columns (worst split R-hat /
    smallest ESS over served queries) are populated when the trace ran
    with engine diagnostics on; records without the fields render "n/a".
    A record with the executor's gates adds their footer."""
    rows = [
        "| trace | backend | models | queries | mean batch | batched qps | "
        "serial qps | speedup | hit rate | evict | recompiles | sim p95 | "
        "sim p99 | rhat max | ess min | dropped |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["trace"], r["backend"])):
        p99 = r.get("sim_latency_p99_ms")
        rows.append(
            f"| {r['trace']} | {r['backend']} | {r['n_models']} "
            f"| {r['n_queries']} | {r['mean_batch']:.2f} "
            f"| {r['batched_qps']:.1f} | {r['serial_qps']:.1f} "
            f"| {r['speedup']:.2f}x | {r['cache_hit_rate']:.3f} "
            f"| {r['cache_evictions']} | {r['recompiles']} "
            f"| {r['sim_latency_p95_ms']:.2f}ms "
            f"| {'n/a' if p99 is None else f'{p99:.2f}ms'} "
            f"| {_fmt_q(r.get('rhat_max'), '.3f')} "
            f"| {_fmt_q(r.get('ess_min'), '.0f')} "
            f"| {_fmt_q(r.get('trace_dropped'), 'd')} |"
        )
    g = next((r for r in recs if "workers_speedup" in r), None)
    if g:
        rows += [
            "",
            f"executor gates: 4-worker sim speedup "
            f"{g['workers_speedup']:.2f}x · sliced serving bit-exact "
            f"({g['slicing_batches']} sliced batches) · calibration median "
            f"err {g['calib_median_err']:.1%} · bursty max queue depth "
            f"{g['bursty_max_queue_depth']} at shed rate "
            f"{g['bursty_shed_rate']:.1%} ({g['bursty_defers']} defers)",
        ]
    return "\n".join(rows)


CELL_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
CARD_BYTES = 80e9  # H100 80GB HBM3
COMPUTED = ("Computed by `python -m repro_torch.launch.dryrun` for one rank "
            "of the mesh on meta tensors, priced at the H100's published "
            "rates: not measured.")


def load(results_dir: str, opt: str = "baseline") -> list[dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(results_dir, f"*__{opt}.json"))):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def _sorted(recs):
    return sorted(recs, key=lambda r: (r["arch"], CELL_ORDER.index(r["cell"]),
                                       r["mesh"]))


def roofline_table(recs: list[dict], mesh: str = "single") -> str:
    """One row per (arch, cell) on `mesh`: the three roofline terms of a
    rank's step, the bottleneck, the useful share of its operations, its
    peak live memory and whether that fits one H100."""
    rows = [
        f"{COMPUTED}", "",
        "| arch | cell | t_compute | t_memory | t_collective | bottleneck | "
        "useful FLOPs | mem GiB/chip | fits in 80 GB |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in _sorted([r for r in recs if r["mesh"] == mesh]):
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['cell']} | — | — | — | skipped "
                        "| — | — | — |")
            continue
        rf = r["roofline"]
        peak = r["memory"]["peak_live_bytes"]
        rows.append(
            f"| {r['arch']} | {r['cell']} | {_fmt_s(rf['t_compute_s'])} "
            f"| {_fmt_s(rf['t_memory_s'])} | {_fmt_s(rf['t_collective_s'])} "
            f"| {rf['bottleneck']} | {rf['useful_flops_ratio']:.3f} "
            f"| {peak / 2**30:.1f} | {'yes' if peak <= CARD_BYTES else 'NO'} |"
        )
    return "\n".join(rows)


def dryrun_table(recs: list[dict]) -> str:
    """One row per (arch, cell, mesh): a rank's argument and temporary
    bytes and its collectives' bytes by op (all-gather, all-reduce,
    all-to-all) and by link (NVLink within a host, the network across
    hosts)."""
    g = 2**30
    rows = [
        f"{COMPUTED}", "",
        "| arch | cell | mesh | status | run s | args GiB | temp GiB | "
        "AG GiB | AR GiB | A2A GiB | NVLink GiB | network GiB |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in _sorted(recs):
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['cell']} | {r['mesh']} | "
                        f"skipped ({r['reason'][:40]}...) " + "| — " * 8
                        + "|")
            continue
        c = r["collectives"]["bytes_by_op"]
        link = r["collectives"]["bytes_by_link"]
        rows.append(
            f"| {r['arch']} | {r['cell']} | {r['mesh']} | ok "
            f"| {r['run_s']:.0f} "
            f"| {r['memory']['argument_size_in_bytes'] / g:.2f} "
            f"| {r['memory']['temp_size_in_bytes'] / g:.2f} "
            f"| {c.get('all-gather', 0) / g:.2f} "
            f"| {c.get('all-reduce', 0) / g:.2f} "
            f"| {c.get('all-to-all', 0) / g:.2f} "
            f"| {link.get('nvlink', 0) / g:.2f} "
            f"| {link.get('network', 0) / g:.2f} |"
        )
    return "\n".join(rows)


def bottleneck_notes(recs: list[dict]) -> str:
    """One sentence per (arch, cell) on what would move the dominant
    term of the port's meshed step."""
    notes = {
        ("memory", "train"): "HBM traffic dominates: fuse the step's "
        "elementwise ops (the count is unfused) and keep activations in "
        "bf16.",
        ("memory", "prefill"): "activation and logits traffic dominates: "
        "take only the last position's logits and fuse attention's stages.",
        ("memory", "decode"): "decode streams every weight and the rank's "
        "cache shard a step: batch more sequences per card.",
        ("collective", "train"): "the blocks' weight gathers over the "
        "data axes (the model axis's blocks stay split: tensor-parallel "
        "compute), the model axis's activation sums and the gradient "
        "all-reduce dominate: a reduce-scatter in place of the all-reduce, "
        "overlap with compute.",
        ("collective", "prefill"): "the data-axis weight gathers and the "
        "model axis's activation sums dominate: overlap the next block's "
        "gather with this block's compute.",
        ("collective", "decode"): "a step gathers each block's model-axis "
        "block of weights over the data axes and the vocabulary blocks of "
        "the embedding and head (the cache stays where it lies): gather "
        "the serving weights once per generate and look up only the "
        "tokens' rows.",
        ("compute", "train"): "compute-bound: drop the remat recompute or "
        "the ranks' redundant rows on the model axis.",
    }
    out = []
    for r in _sorted(recs):
        if r["status"] != "ok" or r["mesh"] != "single":
            continue
        key = (r["roofline"]["bottleneck"], r["kind"])
        out.append(f"* **{r['arch']} / {r['cell']}** — "
                   f"{notes.get(key, 'see table.')}")
    return "\n".join(out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    d = argv[0] if argv else os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))), "build", "dryrun")
    recs = load(d)
    if not recs:
        print(f"no dry-run results under {d}", file=sys.stderr)
        return 1
    print("## Roofline (single pod, computed)\n")
    print(roofline_table(recs, "single"))
    print("\n## Dry-run detail (computed)\n")
    print(dryrun_table(recs))
    print("\n## Bottlenecks\n")
    print(bottleneck_notes(recs))
    # the compile chain's and the runtime's records, where their
    # directories sit beside the dry run's
    for sub, title, table in (
            ("compile", "Compile chain (repro_torch.compile)", compile_table),
            ("runtime", "Serving runtime (repro_torch.runtime)",
             runtime_table)):
        rdir = os.path.join(os.path.dirname(os.path.abspath(d)), sub)
        rrecs = load_compile(rdir) if os.path.isdir(rdir) else []
        if rrecs:
            print(f"\n## {title}\n")
            print(table(rrecs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
