"""Trace-replay CLI for the port's serving runtime.

    PYTHONPATH=src python -m repro_torch.runtime --trace zipf --quick
    PYTHONPATH=src python -m repro_torch.runtime --trace zipf --quick \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.runtime --trace bursty --quick \\
        --workers 4 --fused

Replays a synthetic query trace through the engine and prints the serving
dashboard (latency percentiles in simulated time, throughput, per-worker
utilization, shed/defer counters, cache and recompile behavior).  Runs on
the card unless `--device cpu` asks for the kernels' plain twins.  The
reference CLI's `--profile-out` waits for a port of `obs/profile`.
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch import obs
from repro_torch.obs import attrib as attrib_mod
from repro_torch.obs import export as export_mod
from repro_torch.runtime.admission import AdmissionConfig
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.trace import TRACES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.runtime")
    ap.add_argument("--trace", default="zipf", choices=sorted(TRACES),
                    help="trace family to replay")
    ap.add_argument("--quick", action="store_true",
                    help="small budgets (CI smoke)")
    ap.add_argument("--queries", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where to serve: cuda (the default) or cpu")
    ap.add_argument("--backend", default="schedule",
                    choices=["schedule", "eager"],
                    help="execution backend (schedule is the global "
                         "default; eager is the escape hatch)")
    ap.add_argument("--fused", action="store_true",
                    help="route eligible buckets through the fused "
                         "kernels (bit-exact; schedule backend only)")
    ap.add_argument("--window-ms", type=float, default=2.0,
                    help="microbatch admission window, simulated ms")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=None,
                    help="program-cache capacity override")
    ap.add_argument("--workers", type=int, default=1,
                    help="simulated worker count (the executor pool)")
    ap.add_argument("--shard-width", type=int, default=1,
                    help="mesh-slice width for sharded MRF dispatches")
    ap.add_argument("--shard-min-sites", type=int, default=None,
                    help="route MRF grids with >= this many sites to "
                         "run_sharded (default: sharded route off)")
    ap.add_argument("--no-pins", action="store_true",
                    help="strip pin evidence from grid queries (pinned "
                         "grids are ineligible for the sharded route)")
    ap.add_argument("--slice-iters", type=int, default=None,
                    help="serve long queries in slices of this many sweeps "
                         "(continuous batching; default: whole-query)")
    ap.add_argument("--rate-qps", type=float, default=None,
                    help="token-bucket admission rate (default: open)")
    ap.add_argument("--burst", type=int, default=16,
                    help="token-bucket depth")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="bounded per-bucket queue depth (default: open)")
    ap.add_argument("--policy", default="defer", choices=["defer", "shed"],
                    help="what an empty token bucket does to an arrival")
    ap.add_argument("--calibrate", action="store_true",
                    help="timed warmup dispatches -> measured service "
                         "times (otherwise the line model serves)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Perfetto timeline to PATH, the "
                         "deterministic JSONL event log next to it "
                         "(.jsonl), and the predicted-vs-measured "
                         "attribution (.attrib.json); prints the "
                         "attribution table and fails on coverage gaps")
    args = ap.parse_args(argv)

    if args.trace_out:
        obs.enable()

    models, queries = TRACES[args.trace](
        args.queries, quick=args.quick, seed=args.seed
    )
    if args.no_pins:
        for q in queries:
            if q.image is not None:
                q.evidence = None
    # quick mode reports one pad size, as the reference's does (which pads
    # every microbatch to one shape to bound its compiles)
    pad_sizes = (args.max_batch,) if args.quick else \
        tuple(s for s in (1, 2, 4, 8, 16, 32) if s <= args.max_batch)
    admission = None
    if args.rate_qps is not None or args.queue_limit is not None:
        admission = AdmissionConfig(
            rate_qps=args.rate_qps, burst=args.burst,
            queue_limit=args.queue_limit, policy=args.policy,
        )
    engine = Engine(models, EngineConfig(
        backend=args.backend,
        fused=args.fused,
        window_s=args.window_ms * 1e-3,
        max_batch=args.max_batch,
        pad_sizes=pad_sizes,
        cache_capacity=args.capacity,
        n_workers=args.workers,
        shard_width=args.shard_width,
        shard_min_sites=args.shard_min_sites,
        slice_iters=args.slice_iters,
        admission=admission,
    ), device=args.device)
    engine.submit(queries)
    if args.calibrate:
        cal = engine.calibrate()
        print(f"[runtime] calibrated {len(cal.measured)} dispatch "
              "signature(s)")
    results = engine.run()
    s = engine.metrics.summary()

    gaps = []
    if args.trace_out:
        tr = obs.get()
        events = list(tr.events)
        dicts = export_mod.events_as_dicts(events)
        base = os.path.splitext(args.trace_out)[0]
        export_mod.write_perfetto(args.trace_out, events)
        export_mod.write_jsonl(base + ".jsonl", events)
        rows, gaps = attrib_mod.attribution(dicts)
        with open(base + ".attrib.json", "w") as f:
            json.dump({
                "rows": rows, "gaps": gaps,
                "n_events": len(events), "dropped": tr.dropped,
            }, f, indent=1, sort_keys=True)
        print(f"[runtime] trace: {args.trace_out} ({len(events)} events, "
              f"{tr.dropped} dropped) + {base}.jsonl + {base}.attrib.json")
        print(attrib_mod.attribution_table(rows))
        obs.disable()
    print(f"[runtime] trace={args.trace} backend={args.backend} "
          f"fused={args.fused} workers={args.workers} models={len(models)} "
          f"device={engine.device} served={len(results)} "
          f"shed={s['sheds']}")
    print(engine.metrics.table())
    if len(results) + s["sheds"] != len(queries):
        print(f"[runtime] ERROR: "
              f"{len(queries) - len(results) - s['sheds']} queries "
              "neither served nor shed")
        return 1
    if s["cache_hit_rate"] < 0.9:
        print(f"[runtime] ERROR: program-cache hit rate "
              f"{s['cache_hit_rate']:.3f} < 0.9 on a {args.trace} trace")
        return 1
    if s["max_queue_depth"] and engine.config.admission and \
            engine.config.admission.queue_limit is not None and \
            s["max_queue_depth"] > engine.config.admission.queue_limit:
        print(f"[runtime] ERROR: max queue depth {s['max_queue_depth']} "
              f"exceeds the configured limit")
        return 1
    if s["trace_dropped"]:
        from repro_torch.analysis import Finding
        print("[runtime] " + Finding(
            "obs-trace-dropped", f"trace:{args.trace}",
            f"{s['trace_dropped']} events dropped by the tracer ring "
            "buffer during this run",
            fixit="re-run with obs.enable(capacity=...) raised",
        ).render())
    if gaps:
        for g in gaps:
            print(f"[runtime] ERROR: attribution gap — program "
                  f"{g['program'][:16]} dispatched {g['n_dispatches']}x "
                  "with no recorded round costs")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
