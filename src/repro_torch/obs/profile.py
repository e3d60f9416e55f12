"""Roofline profiler for the port's serving dispatches and program runs
(port of `repro/obs/profile.py`).

The runtime traces *when* dispatches run (`obs.tracer` spans) and the
diag layer checks *whether* samples are correct; this module answers
*what work each dispatch does*.  Before a bucket runs (hooked in
`runtime/batcher.py` on the vmap route, in `runtime/executor.py` on the
sharded route) and before a schedule program's unsliced run (hooked in
`compile/program.py`), the profiler:

  1. counts the work of the call about to execute from its launch shapes
     (`launch/kernel_cost.py`: float32 operations, HBM bytes, threefry
     calls and mesh-collective bytes of every launch it makes),
  2. classifies the roofline bottleneck (compute / memory / collective)
     from the H100 terms of `launch/roofline.py`,
  3. caches the result by signature and emits an `hlo_cost` instant into
     the trace (the reference's event name, so its readers need no
     change).

The reference lowers and compiles each executable and reads XLA's HLO;
the port has no HLO, so the `xla_flops` / `xla_bytes` of the reference's
`BucketProfile` (XLA's own cost analysis) have no counterpart and are
dropped: nothing in `profile_table` or `validate_profile` reads them.  The
port's profile carries `hash_calls` instead, the threefry work its
compute term includes.  A shape `kernel_cost` does not know raises: no
capture quietly gives way.

`join_dispatches` then joins the cached static costs against measured
`dispatch` span walls (via the `profile_sig` arg the executor stamps on
every span) to report achieved-vs-peak per bucket and per comm mechanism,
and fails no dispatch silently: one without a profile is listed as
unattributed.  `static_profile_sweep` costs a fixed model zoo at a tiny
budget.

Module state mirrors `obs.tracer`: profiling is off by default
(`enable()` / `disable()`, or the `REPRO_PROFILE` environment variable),
and the hooks are no-ops while disabled; turning it on changes no answer.
Signature strings and static costs contain no wall-clock terms; only the
per-capture `capture_s` diagnostic does, and it is excluded from
deterministic exports.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time

from repro_torch.launch import kernel_cost as cost_mod
from repro_torch.launch import roofline as roofline_mod
from repro_torch.obs import tracer

# mesh-collective op -> the schedule comm mechanism it carries (the
# reference's table; `kernel_cost` files the port's collectives under
# these op names)
HLO_OP_MECHANISM = {
    "all-reduce": "psum_broadcast",
    "collective-permute": "ppermute_halo",
    "all-gather": "all_gather",
    "all-to-all": "all_to_all",
    "reduce-scatter": "reduce_scatter",
}

BOTTLENECKS = ("compute", "memory", "collective")


def bucket_signature(key, n_padded: int, route: str = "vmap",
                     shard_width: int = 1) -> str:
    """Deterministic signature of a batcher bucket dispatch, byte-equal to
    the reference's for the same key: every static field of the bucket
    (and its pad width) participates; a sharded-route dispatch adds the
    route and slice width.  Pure string math — safe to stamp on every
    dispatch span whether or not profiling is enabled."""
    clamp = ",".join(str(n) for n in key.clamp_nodes)
    parts = [
        "bucket", key.program_key[:16], key.kind, key.backend, key.sampler,
        f"pad{n_padded}", f"ch{key.n_chains}", f"it{key.n_iters}",
        f"bi{key.burn_in}", f"th{key.thin}", f"cl[{clamp}]",
        f"pins{int(key.has_pins)}", f"fused{int(key.fused)}",
        f"res{int(key.resumed)}", f"diag{int(key.diagnostics)}",
    ]
    if route != "vmap":
        parts += [route, f"sh{shard_width}"]
    return "|".join(parts)


def program_signature(program, *, n_chains, n_iters, burn_in, thin,
                      sampler, fused) -> str:
    """Signature of a whole-program (unbatched `run()`) call."""
    return "|".join([
        "run", program.program_key[:16], program.kind, sampler,
        f"ch{n_chains}", f"it{n_iters}", f"bi{burn_in}", f"th{thin}",
        f"fused{int(fused)}",
    ])


@dataclasses.dataclass
class BucketProfile:
    """Static cost + roofline classification of one dispatch signature."""

    sig: str
    meta: dict
    flops: float
    hbm_bytes: float
    hash_calls: float
    collective_bytes: float
    collective_by_op: dict
    t_compute_s: float
    t_memory_s: float
    t_collective_s: float
    bottleneck: str
    capture_s: float  # wall time of the count (diagnostic)

    @property
    def roofline_s(self) -> float:
        return max(self.t_compute_s, self.t_memory_s, self.t_collective_s)

    def as_dict(self, deterministic: bool = True) -> dict:
        d = {
            "sig": self.sig,
            "meta": dict(self.meta),
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "hash_calls": self.hash_calls,
            "collective_bytes": self.collective_bytes,
            "collective_by_op": dict(self.collective_by_op),
            "t_compute_s": self.t_compute_s,
            "t_memory_s": self.t_memory_s,
            "t_collective_s": self.t_collective_s,
            "roofline_s": self.roofline_s,
            "bottleneck": self.bottleneck,
        }
        if not deterministic:
            d["capture_s"] = round(self.capture_s, 6)
        return d


class ProfileRegistry:
    """Cache of :class:`BucketProfile` keyed by signature."""

    def __init__(self):
        self.profiles: dict = {}
        self.hits = 0

    def capture(self, sig: str, count, **meta) -> BucketProfile:
        """Profile the call whose work `count()` returns (a
        `kernel_cost.KernelCost`), once per signature: `count` is a
        zero-arg thunk, so cache hits do no work."""
        prof = self.profiles.get(sig)
        if prof is not None:
            self.hits += 1
            return prof
        t0 = time.perf_counter()
        cost = count()
        if not isinstance(cost, cost_mod.KernelCost):
            raise TypeError(f"{sig}: the count returned "
                            f"{type(cost).__name__}, not a KernelCost")
        roof = roofline_mod.Roofline(
            flops=cost.flops, hbm_bytes=cost.hbm_bytes,
            collective_bytes=cost.collective_bytes,
            hash_calls=cost.hash_calls,
        )
        prof = BucketProfile(
            sig=sig, meta=dict(meta),
            flops=cost.flops, hbm_bytes=cost.hbm_bytes,
            hash_calls=cost.hash_calls,
            collective_bytes=cost.collective_bytes,
            collective_by_op={
                k: v for k, v in sorted(cost.collective_by_op.items()) if v
            },
            t_compute_s=roof.t_compute, t_memory_s=roof.t_memory,
            t_collective_s=roof.t_collective, bottleneck=roof.bottleneck,
            capture_s=time.perf_counter() - t0,
        )
        self.profiles[sig] = prof
        if tracer.enabled():
            tracer.instant(
                "hlo_cost", cat="cost", sig=sig,
                flops=prof.flops, hbm_bytes=prof.hbm_bytes,
                collective_bytes=prof.collective_bytes,
                bottleneck=prof.bottleneck,
                **{k: meta[k] for k in ("model", "kind", "program")
                   if meta.get(k) is not None},
            )
        return prof

    def rows(self, deterministic: bool = True) -> list:
        return [self.profiles[s].as_dict(deterministic)
                for s in sorted(self.profiles)]


# -- module state (mirrors obs.tracer) --------------------------------------

_REGISTRY = None


def enabled() -> bool:
    return _REGISTRY is not None


def get() -> "ProfileRegistry | None":
    return _REGISTRY


def enable() -> ProfileRegistry:
    global _REGISTRY
    _REGISTRY = ProfileRegistry()
    return _REGISTRY


def disable() -> None:
    global _REGISTRY
    _REGISTRY = None


# -- capture hooks ----------------------------------------------------------

def least_lanes(n_padded: int, pad_sizes) -> int:
    """The fewest real queries a dispatch padded to `n_padded` can hold:
    one more than the ladder's next smaller size.  The port computes only
    the real lanes, and dispatches of one signature may hold different
    counts, so a signature's cost counts the fewest (a roofline is a
    lower bound)."""
    below = [s for s in pad_sizes if s < n_padded]
    return max(below) + 1 if below else 1


def capture_bucket(program, key, n_padded, pad_sizes, *, route="vmap",
                   shard_width=1, model=None) -> "BucketProfile | None":
    """Batcher and executor hook: profile the bucket dispatch about to run
    on `route` (before its first-use cross-check, which it counts when
    pending), under the signature the executor stamps on its span.  The
    sharded route runs each query over the (1, shard_width) mesh, its
    collectives included."""
    reg = get()
    if reg is None:
        return None
    sig = bucket_signature(key, n_padded, route, shard_width)
    lanes = least_lanes(n_padded, pad_sizes)
    sharded = route == "sharded"
    pending = key.fused and program.fused_check_pending(key.sampler,
                                                        sharded=sharded)
    mesh = {"mesh": [1, shard_width]} if sharded else {}
    return reg.capture(
        sig, lambda: cost_mod.bucket_cost(program, key, lanes, route,
                                          shard_width=shard_width,
                                          cross_check=pending),
        model=model, kind=key.kind, program=key.program_key,
        sampler=key.sampler, backend=key.backend, fused=key.fused,
        resumed=key.resumed, n_padded=n_padded, n_lanes=lanes,
        n_chains=key.n_chains, n_iters=key.n_iters, route=route, **mesh,
    )


def capture_program(program, *, n_chains, n_iters, burn_in=50, thin=1,
                    sampler="lut_ky", fused=False, cross_check=None,
                    registry=None) -> "BucketProfile | None":
    """Profile a whole-program schedule run (`program.run()` without
    evidence, pins or a carry).  `cross_check=None` counts the fused
    path's first-use cross-check when it is still pending."""
    reg = registry if registry is not None else get()
    if reg is None:
        return None
    sig = program_signature(
        program, n_chains=n_chains, n_iters=n_iters, burn_in=burn_in,
        thin=thin, sampler=sampler, fused=fused,
    )
    if cross_check is None:
        cross_check = fused and program.fused_check_pending(sampler)
    return reg.capture(
        sig, lambda: cost_mod.program_cost(
            program, n_chains=n_chains, n_iters=n_iters, burn_in=burn_in,
            thin=thin, sampler=sampler, cross_check=cross_check),
        model=program.ir.name, kind=program.kind,
        program=program.program_key, sampler=sampler, fused=fused,
        n_chains=n_chains, n_iters=n_iters, route="run",
    )


# -- joining static costs against measured dispatch walls -------------------

def join_dispatches(profiles, events) -> dict:
    """Join cached static costs against measured `dispatch` spans.

    `profiles` maps sig -> :class:`BucketProfile` (or its dict form);
    `events` is a list of event dicts (`export.events_as_dicts` with wall
    fields kept, or `export.load_jsonl` output).  Returns rows aggregated
    per signature with achieved-vs-peak ratios, per-mechanism comm rows,
    and the dispatches no profile covered.  Sharded-route dispatches
    attribute like any other: a sharded dispatch without a profile is an
    unattributed finding, not a skip."""
    rows: dict = {}
    unattributed: dict = {}
    n_dispatches = 0
    n_sharded = 0
    for ev in events:
        if ev.get("name") != "dispatch":
            continue
        a = ev.get("args") or {}
        w = ev.get("wargs") or {}
        n_dispatches += 1
        if a.get("route") != "vmap":
            n_sharded += 1
        sig = a.get("profile_sig")
        prof = profiles.get(sig)
        if prof is None:
            u = unattributed.setdefault(sig or "<unsigned>", {
                "sig": sig, "model": a.get("model"),
                "program": a.get("program"), "n_dispatches": 0,
            })
            u["n_dispatches"] += 1
            continue
        pd = prof.as_dict() if isinstance(prof, BucketProfile) else dict(prof)
        row = rows.get(sig)
        if row is None:
            row = rows[sig] = {
                **pd, "n_dispatches": 0, "n_measured": 0,
                "measured_total_s": 0.0, "service_total_s": 0.0,
            }
        row["n_dispatches"] += 1
        row["service_total_s"] += float(a.get("service_s") or 0.0)
        ms = w.get("measured_s")
        if ms is not None:
            row["n_measured"] += 1
            row["measured_total_s"] += float(ms)
    out_rows = []
    comm: dict = {}
    for sig in sorted(rows):
        row = rows[sig]
        meas = (row["measured_total_s"] / row["n_measured"]
                if row["n_measured"] else None)
        row["measured_mean_s"] = meas
        row["service_total_s"] = round(row["service_total_s"], 9)
        row["measured_total_s"] = round(row["measured_total_s"], 9)
        if meas and meas > 0:
            row["achieved_flops"] = row["flops"] / meas
            row["achieved_hbm_bw"] = row["hbm_bytes"] / meas
            row["peak_frac"] = min(1.0, row["roofline_s"] / meas)
        else:
            row["achieved_flops"] = row["achieved_hbm_bw"] = None
            row["peak_frac"] = None
        for op, nbytes in row.get("collective_by_op", {}).items():
            mech = HLO_OP_MECHANISM.get(op, op)
            c = comm.setdefault(mech, {
                "mechanism": mech, "hlo_op": op, "bytes_per_dispatch": 0.0,
                "total_bytes": 0.0, "measured_total_s": 0.0,
                "n_dispatches": 0,
            })
            c["bytes_per_dispatch"] += nbytes
            c["total_bytes"] += nbytes * row["n_dispatches"]
            c["measured_total_s"] += row["measured_total_s"]
            c["n_dispatches"] += row["n_dispatches"]
        out_rows.append(row)
    comm_rows = []
    for mech in sorted(comm):
        c = comm[mech]
        c["measured_total_s"] = round(c["measured_total_s"], 9)
        c["achieved_bw"] = (
            c["total_bytes"] / c["measured_total_s"]
            if c["measured_total_s"] > 0 else None
        )
        # the mesh's positions share one card: device memory carries the
        # collectives
        c["peak_frac"] = (
            min(1.0, c["achieved_bw"] / roofline_mod.HBM_BW)
            if c["achieved_bw"] else None
        )
        comm_rows.append(c)
    return {
        "rows": out_rows,
        "comm": comm_rows,
        "unattributed": [unattributed[k] for k in sorted(unattributed)],
        "n_dispatches": n_dispatches,
        "n_sharded": n_sharded,
    }


def write_profile(path, registry, events) -> dict:
    """Join + write the `profile.json` artifact; returns the record."""
    joined = join_dispatches(registry.profiles, events)
    rec = {
        "schema": 1,
        "peaks": {"flops": roofline_mod.PEAK_FLOPS,
                  "hbm_bw": roofline_mod.HBM_BW,
                  "nvlink_bw": roofline_mod.NVLINK_BW,
                  "hash_calls_per_s": 1.0 / roofline_mod.hash_seconds(1.0)},
        "buckets": registry.rows(deterministic=False),
        "capture_hits": registry.hits,
        "joined": joined,
    }
    pathlib.Path(path).write_text(json.dumps(rec, indent=1, sort_keys=True))
    return rec


def validate_profile(rec: dict) -> list:
    """Sanity problems in a saved `profile.json` ([] when healthy)."""
    problems = []
    if rec.get("schema") != 1:
        problems.append(f"unknown profile schema {rec.get('schema')!r}")
        return problems
    buckets = rec.get("buckets", [])
    if not buckets:
        problems.append("no captured bucket profiles")
    for b in buckets:
        if b.get("bottleneck") not in BOTTLENECKS:
            problems.append(
                f"{b.get('sig')}: bad bottleneck {b.get('bottleneck')!r}")
        if not b.get("hbm_bytes", 0) > 0:
            problems.append(f"{b.get('sig')}: hbm_bytes must be > 0")
    joined = rec.get("joined", {})
    for u in joined.get("unattributed", []):
        problems.append(
            f"unattributed dispatches: sig={u.get('sig')!r} "
            f"x{u.get('n_dispatches')}")
    return problems


# -- static sweep ------------------------------------------------------------

# fixed tiny budget: the rows are static costs, not wall time
SWEEP_BUDGET = dict(n_chains=8, n_iters=32, burn_in=8, thin=1)
SWEEP_BN_MODELS = ("survey", "alarm")
SWEEP_GRID = 8


def static_profile_sweep(quick: bool = False, device="cuda") -> list:
    """Per-signature static costs over a fixed model zoo, compiled on
    `device` (the reference's zoo and budget; no cross-check is counted,
    so the rows depend on nothing but the programs)."""
    from repro_torch.compile.program import compile_graph
    from repro_torch.core.graphs import GridMRF, bn_repository_replica

    reg = ProfileRegistry()
    models = SWEEP_BN_MODELS[:1] if quick else SWEEP_BN_MODELS
    progs = [compile_graph(bn_repository_replica(name), device=device)
             for name in models]
    progs.append(compile_graph(GridMRF(
        SWEEP_GRID, SWEEP_GRID, 3, theta=1.1, h=1.8,
        name=f"grid{SWEEP_GRID}",
    ), device=device))
    for prog in progs:
        for fused in (False, True):
            capture_program(prog, sampler="lut_ky", fused=fused,
                            cross_check=False, registry=reg, **SWEEP_BUDGET)
    return reg.rows(deterministic=True)


# honor the environment once at import, like tracer's REPRO_TRACE
if os.environ.get("REPRO_PROFILE", "") not in ("", "0"):
    enable()
