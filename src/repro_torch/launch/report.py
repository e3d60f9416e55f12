"""Report tables the port's CLIs print (port of the reference's
`launch/report.py`).

`profile_table`, `quality_table` and `verification_table` render the same
rows into the same bytes as the reference's; `attribution_table` is
`obs.attrib`'s.  The dry-run, compile and roofline tables of the
reference's language-model cells wait for a port of that stack.
"""

from __future__ import annotations

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
