"""Attribution/profile checker CLI: validate saved obs artifacts (port of
`repro/obs/__main__.py`).

    python -m repro_torch.obs trace.jsonl        # recompute from the log
    python -m repro_torch.obs trace.attrib.json  # validate an attribution
    python -m repro_torch.obs --profile profile.json  # validate a profile

Parses the artifact, renders the predicted-vs-measured attribution table
(or the roofline profile table) from `launch/report.py`, and exits
non-zero when the artifact has holes: attribution *gaps* (dispatched
rounds no `round_cost` event covers), no dispatches at all, or — in
`--profile` mode — unattributed dispatches, empty captures, or invalid
roofline rows.  A saved attribution that recorded tracer ring-buffer
drops prints an `obs-trace-dropped` warning (coverage is suspect but not
necessarily broken).  Plain Python: it reads files and needs no card.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis import Finding
from repro_torch.launch.report import attribution_table, profile_table
from repro_torch.obs import attrib, export
from repro_torch.obs import profile as profile_mod


def check_rows(rows: list[dict], gaps: list[dict]) -> int:
    n_rounds = sum(1 for r in rows if r.get("kind") == "round")
    if not rows or n_rounds == 0:
        print("[obs] ERROR: attribution is empty (no dispatched rounds)")
        return 2
    print(attribution_table(rows))
    total_disp = max((r.get("n_dispatches", 0) for r in rows), default=0)
    print(f"\n[obs] {n_rounds} round rows, "
          f"{sum(1 for r in rows if r.get('kind') == 'comm')} comm rows, "
          f"{total_disp} dispatches attributed")
    if gaps:
        for g in gaps:
            print(f"[obs] ERROR: attribution gap — program "
                  f"{g['program'][:16]} (model {g['model']}) dispatched "
                  f"{g['n_dispatches']}x with no recorded round costs")
        return 2
    return 0


def check_profile(rec: dict, path: str) -> int:
    problems = profile_mod.validate_profile(rec)
    joined = rec.get("joined", {})
    rows = joined.get("rows", [])
    if rows or joined.get("comm"):
        print(profile_table(rows, joined.get("comm", [])))
    print(f"\n[obs] {len(rec.get('buckets', []))} captured signatures, "
          f"{joined.get('n_dispatches', 0)} dispatches "
          f"({joined.get('n_sharded', 0)} sharded), "
          f"{len(joined.get('unattributed', []))} unattributed")
    for p in problems:
        print(f"[obs] ERROR: {p}")
    return 2 if problems else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.obs")
    ap.add_argument("path", help="trace .jsonl event log, .attrib.json, or "
                                 "(with --profile) profile.json")
    ap.add_argument("--profile", action="store_true",
                    help="validate a saved obs.profile artifact instead of "
                         "an attribution")
    args = ap.parse_args(argv)
    if args.profile:
        with open(args.path) as f:
            return check_profile(json.load(f), args.path)
    if args.path.endswith(".jsonl"):
        events = export.load_jsonl(args.path)
        rows, gaps = attrib.attribution(events)
        dropped = 0
    else:
        with open(args.path) as f:
            rec = json.load(f)
        rows, gaps = rec.get("rows", []), rec.get("gaps", [])
        dropped = rec.get("dropped", 0)
    if dropped:
        print("[obs] " + Finding(
            "obs-trace-dropped", f"trace:{args.path}",
            f"{dropped} events were dropped by the tracer ring buffer; "
            "attribution coverage may be incomplete",
            fixit="re-record with obs.enable(capacity=...) raised",
        ).render())
    return check_rows(rows, gaps)


if __name__ == "__main__":
    sys.exit(main())
