"""Post-run cost attribution: join predicted round costs with dispatches
(a copy of `repro/obs/attrib.py`, plus `attribution_table`, the
reference's `launch/report.py` renderer the runtime CLI prints).

`calib_median_err` says *how wrong* the service predictions are on median;
this module says *where*.  The executor emits, per program, one
`round_cost` instant per schedule round (the cost model's compute/comm
cycles under the actual placement) and, per microbatch, one `dispatch`
span carrying the calibrated prediction (`service_s`, deterministic) next
to the measured dispatch wall (`measured_s`, wall-derived).  `attribution`
joins the two:

  * each dispatch's predicted seconds and measured wall are allocated
    across its program's rounds proportionally to the rounds' modeled
    cycles — the per-round drill-down behind the single advisory number;
  * comm is attributed separately per mechanism (`ppermute_halo` /
    `psum_broadcast`) from the rounds' comm-cycle shares, which is the
    comm-vs-compute breakdown the paper's figures hinge on.

Coverage is a checked property, not an aspiration: a dispatch whose
program has no `round_cost` events is a *gap*, returned explicitly so CI
can fail on silent attribution holes.  Measured walls are optional — an
attribution computed from the deterministic JSONL (wall fields stripped)
reports predicted columns and leaves measured ones empty.
"""

from __future__ import annotations


def _args(ev: dict) -> dict:
    return ev.get("args") or {}


def _wargs(ev: dict) -> dict:
    return ev.get("wargs") or {}


def attribution(events) -> tuple[list[dict], list[dict]]:
    """Join `round_cost` and `dispatch` events into attribution rows.

    `events` is an iterable of event dicts (`export.events_as_dicts` /
    `export.load_jsonl`).  Returns `(rows, gaps)`:

      * `rows` — per (model, program, round) dicts with the round's modeled
        cycles, its share of the sweep, the predicted seconds allocated to
        it across every dispatch, and (when walls were recorded) the
        measured seconds and relative error; plus one `kind="comm"` row per
        (model, program, mechanism) aggregating the comm-cycle share.
      * `gaps` — dispatches whose program has no recorded round costs
        (attribution holes; CI asserts this list is empty).
    """
    rounds: dict[str, dict[int, dict]] = {}
    dispatches: list[dict] = []
    for ev in events:
        name = ev.get("name")
        if name == "round_cost":
            a = _args(ev)
            rounds.setdefault(a["program"], {})[int(a["round"])] = a
        elif name == "dispatch" and ev.get("kind") == "span":
            dispatches.append(ev)

    rows: dict[tuple, dict] = {}
    comm_rows: dict[tuple, dict] = {}
    gaps: dict[str, dict] = {}
    for ev in dispatches:
        a = _args(ev)
        prog = a.get("program", "?")
        model = a.get("model", "?")
        rr = rounds.get(prog)
        if not rr:
            gap = gaps.setdefault(prog, {
                "program": prog, "model": model, "n_dispatches": 0,
            })
            gap["n_dispatches"] += 1
            continue
        total_cycles = sum(
            r["compute_cycles"] + r["comm_cycles"] for r in rr.values()
        )
        pred_s = float(a.get("service_s", 0.0))
        meas_s = _wargs(ev).get("measured_s")
        for idx in sorted(rr):
            r = rr[idx]
            cyc = r["compute_cycles"] + r["comm_cycles"]
            share = cyc / total_cycles if total_cycles else 0.0
            row = rows.setdefault((model, prog, idx), {
                "kind": "round", "model": model, "program": prog,
                "round": idx, "n_nodes": r["n_nodes"],
                "compute_cycles": r["compute_cycles"],
                "comm_cycles": r["comm_cycles"],
                "mechanism": r.get("mechanism"),
                "share": share, "n_dispatches": 0,
                "pred_s": 0.0, "meas_s": 0.0, "n_measured": 0,
            })
            row["n_dispatches"] += 1
            row["pred_s"] += pred_s * share
            if meas_s is not None:
                row["meas_s"] += float(meas_s) * share
                row["n_measured"] += 1
            mech = r.get("mechanism")
            if mech and r["comm_cycles"]:
                cshare = (r["comm_cycles"] / total_cycles
                          if total_cycles else 0.0)
                crow = comm_rows.setdefault((model, prog, mech), {
                    "kind": "comm", "model": model, "program": prog,
                    "mechanism": mech,
                    "comm_cycles": 0, "comm_bytes": 0, "n_comm_ops": 0,
                    "share": 0.0, "n_dispatches": 0,
                    "pred_s": 0.0, "meas_s": 0.0, "n_measured": 0,
                })
                crow["pred_s"] += pred_s * cshare
                if meas_s is not None:
                    crow["meas_s"] += float(meas_s) * cshare
        # static comm aggregates + dispatch counts (once per dispatch)
        for (m, p, mech), crow in comm_rows.items():
            if p != prog:
                continue
            crow["n_dispatches"] += 1
            if meas_s is not None:
                crow["n_measured"] += 1
    # static comm totals (independent of dispatches)
    for (model, prog, mech), crow in comm_rows.items():
        rr = rounds.get(prog, {})
        tot = sum(r["compute_cycles"] + r["comm_cycles"] for r in rr.values())
        crow["comm_cycles"] = sum(
            r["comm_cycles"] for r in rr.values()
            if r.get("mechanism") == mech
        )
        crow["comm_bytes"] = sum(
            r.get("comm_bytes", 0) for r in rr.values()
            if r.get("mechanism") == mech
        )
        crow["n_comm_ops"] = sum(
            r.get("n_comm_ops", 0) for r in rr.values()
            if r.get("mechanism") == mech
        )
        crow["share"] = crow["comm_cycles"] / tot if tot else 0.0

    def err(row):
        if row["n_measured"] and row["meas_s"] > 0:
            return abs(row["pred_s"] - row["meas_s"]) / row["meas_s"]
        return None

    out = []
    for key in sorted(rows):
        row = rows[key]
        row["rel_err"] = err(row)
        out.append(row)
    for key in sorted(comm_rows):
        row = comm_rows[key]
        row["rel_err"] = err(row)
        out.append(row)
    return out, sorted(gaps.values(), key=lambda g: g["program"])


def coverage(events) -> dict:
    """Reconciliation summary: dispatch spans seen, programs with round
    costs, and any attribution gaps — the CI assertion payload."""
    rows, gaps = attribution(events)
    n_dispatch = sum(
        1 for ev in events
        if ev.get("name") == "dispatch" and ev.get("kind") == "span"
    )
    return {
        "n_dispatch_spans": n_dispatch,
        "n_round_rows": sum(1 for r in rows if r["kind"] == "round"),
        "n_comm_rows": sum(1 for r in rows if r["kind"] == "comm"),
        "n_gaps": len(gaps),
        "gaps": gaps,
    }


def attribution_table(rows: list[dict]) -> str:
    """Predicted-vs-measured cost attribution: one row per schedule round
    with its modeled compute/comm cycles, its share of the sweep, and the
    predicted seconds the dispatches allocated to it — next to the
    measured wall when the trace recorded one — followed by the
    per-mechanism comm rows.  Rendered by the runtime CLI's `--trace-out`
    path (the reference keeps it in `launch/report.py`)."""

    def ms(row, field):
        if row["n_measured"] == 0 and field == "meas_s":
            return "n/a"
        return f"{row[field] * 1e3:.2f}ms"

    def err(row):
        e = row.get("rel_err")
        return "n/a" if e is None else f"{e:.1%}"

    out = [
        "| model | kind | round | nodes | mechanism | compute cyc | "
        "comm cyc | share | disp | pred | meas | err |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["kind"] != "round":
            continue
        out.append(
            f"| {r['model']} | round | {r['round']} | {r['n_nodes']} "
            f"| {r['mechanism'] or '—'} | {r['compute_cycles']} "
            f"| {r['comm_cycles']} | {r['share']:.1%} "
            f"| {r['n_dispatches']} | {ms(r, 'pred_s')} | {ms(r, 'meas_s')} "
            f"| {err(r)} |"
        )
    for r in rows:
        if r["kind"] != "comm":
            continue
        out.append(
            f"| {r['model']} | comm | — | — | {r['mechanism']} | — "
            f"| {r['comm_cycles']} | {r['share']:.1%} "
            f"| {r['n_dispatches']} | {ms(r, 'pred_s')} | {ms(r, 'meas_s')} "
            f"| {err(r)} |"
        )
    return "\n".join(out)
