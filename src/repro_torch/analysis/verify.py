# Copied from the reference package, src/repro/analysis/verify.py: numpy only,
# kept in step with it so both packages compile a model identically.
"""Static schedule verifier — the parallel-Gibbs race detector.

Given a `SamplingGraph` and a lowered `Schedule`, prove (or refute) the
invariants the whole execution stack assumes but never re-checks after
lowering:

  * **round independence** — no conflict edge inside a color round.  Two
    neighbors updating in the same round is the chromatic-Gibbs race
    condition: each reads the other's stale-or-fresh value depending on
    core timing, and the chain no longer targets the model's posterior.
  * **coverage** — the rounds partition exactly the free (non-evidence)
    RVs: no orphans, no duplicates, no unknown nodes.
  * **clamp/pin consistency** — evidence-clamped nodes never appear in a
    sampling round, and MRF pins never swallow a whole checkerboard
    parity class (which would silently change the per-iteration
    key-split structure).
  * **comm completeness** — every cross-core conflict edge whose value
    crosses a round boundary is covered by a comm op of the right
    mechanism, byte count, and hop distance; no op ships traffic nothing
    generates.
  * **placement legality** — nodes sit on real cores and each round's
    recorded `core_load` matches the placement (that tuple is what the
    cost model charges compute against).
  * **cost-model sanity** — the diagnostics the passes recorded
    (`schedule_cost`, critical/balanced core load) reconcile with the
    cost recomputed from the schedule itself.

Everything here is a pure function of the artifacts — no JAX, no
execution — so it can gate every compile (`VerifyPass`), every cached
program (`verify_program`), and every CI run without touching a device.

The expected-traffic recomputation deliberately re-derives what
`schedule.build_schedule` computes, from the *rounds themselves* rather
than the colors array: the verifier checks the artifact that will
execute, independent of how it was produced.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.analysis import Finding, Report
from repro_torch.core import coloring as coloring_mod

# `repro.compile` imports this module (VerifyPass, the re-exported error
# type), so compile-side names are only touched lazily: type annotations
# stay strings (future-annotations) and VALUE_BYTES/_manhattan are fetched
# inside the functions that need them.

# the rule ids this analyzer can emit (the CLI/report "rules run" set)
VERIFY_RULES = (
    "race-in-round", "node-dup", "coverage", "clamp-resampled",
    "pin-full-parity", "comm-missing", "comm-mechanism", "comm-bytes",
    "comm-hops", "comm-spurious", "placement-range", "placement-load",
    "load-imbalance", "cost-model",
)


class ScheduleVerificationError(AssertionError):
    """A lowered schedule violates a statically provable invariant.

    Subclasses AssertionError so callers guarding with
    `pytest.raises(AssertionError)` (and the backend's legality re-check)
    keep working — but it is *raised*, never `assert`ed, so the check
    survives `python -O`.  Carries the structured findings that produced
    it."""

    def __init__(self, findings):
        self.findings = tuple(findings)
        lines = [f.render() for f in self.findings]
        super().__init__(
            "schedule verification failed "
            f"({len(self.findings)} error finding(s)):\n  "
            + "\n  ".join(lines)
        )


def raise_on_errors(findings, keep_warnings: bool = True) -> list[Finding]:
    """Raise `ScheduleVerificationError` if any error-severity finding is
    present; otherwise return the findings unchanged (warnings pass)."""
    errors = [f for f in findings if f.severity == "error"]
    if errors:
        raise ScheduleVerificationError(errors)
    return list(findings) if keep_warnings else []


def require_proper_coloring(
    adj: list[set[int]], colors: np.ndarray, loc: str
) -> None:
    """The raised (non-strippable) replacement for the pipeline's old
    `assert verify_coloring(...)`: locate an offending edge and raise a
    structured race finding."""
    if coloring_mod.verify_coloring(adj, colors):
        return
    findings = []
    for u, nbrs in enumerate(adj):
        bad = [v for v in nbrs if colors[v] == colors[u] and v > u]
        if bad:
            findings.append(Finding(
                rule="race-in-round",
                loc=loc,
                message=(
                    f"nodes {u} and {bad[0]} are conflict-graph neighbors "
                    f"but share color {int(colors[u])}"
                ),
                fixit="re-run DSATUR or repair the imported coloring",
            ))
            break
    if not findings:  # length/range mismatch rather than a same-color edge
        findings.append(Finding(
            rule="race-in-round", loc=loc,
            message="coloring failed verify_coloring (malformed colors array)",
        ))
    raise ScheduleVerificationError(findings)


def _expected_traffic(
    schedule: Schedule,
    adj: list[set[int]],
    evid: set[int],
    placement: MeshPlacement,
) -> list[dict[tuple[int, int], int]]:
    """Per-round expected (src_core, dst_core) -> bytes, re-derived from
    round membership: after a round updates u, every free conflict neighbor
    outside the round reads u's new value; a cross-core read ships
    VALUE_BYTES, aggregated per core pair (one halo exchange / delta
    broadcast per pair)."""
    from repro_torch.compile.schedule import VALUE_BYTES

    pl = placement.placement
    per_round = []
    n = len(pl)
    for r in schedule.rounds:
        in_round = set(r.nodes)
        traffic: dict[tuple[int, int], int] = {}
        for u in r.nodes:
            if not 0 <= u < n:  # unknown id; already a coverage finding
                continue
            cu = int(pl[u])
            dst_cores = {
                int(pl[v])
                for v in adj[u]
                if v not in in_round and v not in evid
            }
            for cv in dst_cores - {cu}:
                traffic[(cu, cv)] = traffic.get((cu, cv), 0) + VALUE_BYTES
        per_round.append(traffic)
    return per_round


def _legality_findings(
    ir: SamplingGraph, schedule: Schedule, adj: list[set[int]],
    evid: set[int], loc: str,
) -> list[Finding]:
    """Rules that need no placement: races, duplicates, coverage, clamps,
    full-parity pins."""
    out: list[Finding] = []
    seen: set[int] = set()
    for r in schedule.rounds:
        rloc = f"{loc}:round {r.color}"
        in_round = set(r.nodes)
        dup = in_round & seen
        if len(in_round) < len(r.nodes):
            out.append(Finding(
                rule="node-dup", loc=rloc,
                message=f"round lists {len(r.nodes) - len(in_round)} "
                        "node(s) more than once",
            ))
        if dup:
            out.append(Finding(
                rule="node-dup", loc=rloc,
                message=f"node(s) {sorted(dup)[:4]} already scheduled in an "
                        "earlier round",
            ))
        seen |= in_round
        clamped = in_round & evid
        if clamped:
            out.append(Finding(
                rule="clamp-resampled", loc=rloc,
                message=f"evidence-clamped node(s) {sorted(clamped)[:4]} "
                        "would be re-sampled",
                fixit="drop evidence nodes from the round in build_schedule",
            ))
        unknown = {u for u in in_round if not (0 <= u < ir.n_nodes)}
        if unknown:
            out.append(Finding(
                rule="coverage", loc=rloc,
                message=f"unknown node id(s) {sorted(unknown)[:4]} "
                        f"(IR has {ir.n_nodes} nodes)",
            ))
            in_round -= unknown
        for u in sorted(in_round):
            bad = adj[u] & in_round
            if bad:
                out.append(Finding(
                    rule="race-in-round", loc=rloc,
                    message=(
                        f"conflict-graph neighbors {u} and {min(bad)} update "
                        "in the same round (parallel-Gibbs race)"
                    ),
                    fixit="split the round so no conflict edge is internal",
                ))
                break  # one witness per round keeps reports readable
    free = set(range(ir.n_nodes)) - evid
    missing = free - seen
    if missing:
        out.append(Finding(
            rule="coverage", loc=loc,
            message=f"{len(missing)} free RV(s) appear in no round "
                    f"(first: {sorted(missing)[:4]}); their chains would "
                    "never mix",
        ))
    if ir.kind == "mrf":
        src = ir.source
        h, w = int(src.height), int(src.width)
        for parity in (0, 1):
            cls = {
                r * w + c
                for r in range(h) for c in range(w)
                if (r + c) % 2 == parity
            }
            if cls and cls <= evid:
                out.append(Finding(
                    rule="pin-full-parity", loc=f"{loc}:ir",
                    message=(
                        f"pins cover the entire parity-{parity} checkerboard "
                        "class; the per-iteration key-split structure would "
                        "silently change"
                    ),
                    fixit="leave at least one free site per parity class",
                ))
    return out


def _comm_findings(
    ir: SamplingGraph, schedule: Schedule, adj: list[set[int]],
    evid: set[int], placement: MeshPlacement, loc: str,
) -> list[Finding]:
    from repro_torch.core.mapping import _manhattan

    out: list[Finding] = []
    expected_mech = "ppermute_halo" if ir.kind == "mrf" else "psum_broadcast"
    cols = schedule.mesh_shape[1]
    expected = _expected_traffic(schedule, adj, evid, placement)
    for r, want in zip(schedule.rounds, expected):
        rloc = f"{loc}:round {r.color}"
        got: dict[tuple[int, int], int] = {}
        for op in r.comm:
            if op.mechanism != expected_mech:
                out.append(Finding(
                    rule="comm-mechanism", loc=rloc,
                    message=(
                        f"comm op {op.src_core}->{op.dst_core} uses "
                        f"{op.mechanism!r}; {ir.kind} rounds move data via "
                        f"{expected_mech!r}"
                    ),
                    fixit=f"lower {ir.kind} comm onto {expected_mech}",
                ))
            want_hops = _manhattan(op.src_core, op.dst_core, cols)
            if op.hops != want_hops:
                out.append(Finding(
                    rule="comm-hops", loc=rloc,
                    message=(
                        f"comm op {op.src_core}->{op.dst_core} claims "
                        f"{op.hops} hop(s); Manhattan distance on the "
                        f"{schedule.mesh_shape} mesh is {want_hops}"
                    ),
                ))
            got[(op.src_core, op.dst_core)] = (
                got.get((op.src_core, op.dst_core), 0) + op.n_bytes
            )
        for pair in sorted(set(want) - set(got)):
            out.append(Finding(
                rule="comm-missing", loc=rloc,
                message=(
                    f"cross-core edge traffic core {pair[0]} -> core "
                    f"{pair[1]} ({want[pair]} B) has no covering comm op; "
                    "the next round would read a stale value"
                ),
                fixit="emit the aggregated comm op in build_schedule",
            ))
        for pair in sorted(set(got) - set(want)):
            out.append(Finding(
                rule="comm-spurious", loc=rloc,
                message=(
                    f"comm op core {pair[0]} -> core {pair[1]} "
                    f"({got[pair]} B) matches no cross-round conflict edge "
                    "(cost model overcharges)"
                ),
            ))
        for pair in sorted(set(got) & set(want)):
            if got[pair] != want[pair]:
                out.append(Finding(
                    rule="comm-bytes", loc=rloc,
                    message=(
                        f"comm op core {pair[0]} -> core {pair[1]} ships "
                        f"{got[pair]} B; the round's updates generate "
                        f"{want[pair]} B"
                    ),
                ))
    return out


def _placement_findings(
    ir: SamplingGraph, schedule: Schedule, evid: set[int],
    placement: MeshPlacement, loc: str,
) -> list[Finding]:
    out: list[Finding] = []
    n_cores = schedule.n_cores
    pl = np.asarray(placement.placement)
    off_mesh = np.where((pl < 0) | (pl >= n_cores))[0]
    if len(off_mesh):
        out.append(Finding(
            rule="placement-range", loc=loc,
            message=(
                f"node(s) {off_mesh[:4].tolist()} placed on core(s) "
                f"{pl[off_mesh[:4]].tolist()}; mesh has {n_cores} cores"
            ),
        ))
        return out  # load accounting is meaningless off-mesh
    for r in schedule.rounds:
        if not r.core_load:
            continue  # legacy schedule: compute falls back to balanced share
        rloc = f"{loc}:round {r.color}"
        known = [u for u in r.nodes if 0 <= u < len(pl)]
        want = np.bincount(pl[known], minlength=n_cores)
        got = np.asarray(r.core_load)
        if len(got) != n_cores or not np.array_equal(got, want):
            out.append(Finding(
                rule="placement-load", loc=rloc,
                message=(
                    "recorded core_load disagrees with the placement "
                    f"(critical core charge {int(got.max()) if len(got) else 0}"
                    f" recorded vs {int(want.max())} actual)"
                ),
                fixit="rebuild core_load from the placement in build_schedule",
            ))
            continue
        balanced = -(-len(r.nodes) // n_cores)
        if int(got.max()) > 2 * balanced:
            out.append(Finding(
                rule="load-imbalance", loc=rloc,
                message=(
                    f"critical core holds {int(got.max())} nodes vs balanced "
                    f"share {balanced} (placement quality, not correctness)"
                ),
                fixit="try a different mapper (ROADMAP item 5)",
            ))
    return out


def _cost_findings(
    schedule: Schedule, diagnostics: dict, loc: str
) -> list[Finding]:
    out: list[Finding] = []
    recorded = diagnostics.get("schedule_cost")
    if recorded is not None:
        actual = schedule.cost()
        diff = {
            k: (recorded.get(k), actual[k])
            for k in actual
            if recorded.get(k) != actual[k]
        }
        if diff:
            k, (rec, act) = next(iter(diff.items()))
            out.append(Finding(
                rule="cost-model", loc=loc,
                message=(
                    f"recorded schedule_cost[{k!r}]={rec} but the schedule "
                    f"recomputes {act} ({len(diff)} field(s) disagree)"
                ),
                fixit="re-record diagnostics after any schedule mutation",
            ))
    crit = diagnostics.get("critical_core_load")
    if crit is not None:
        actual_crit = max(
            (max(r.core_load) for r in schedule.rounds if r.core_load),
            default=0,
        )
        if crit != actual_crit:
            out.append(Finding(
                rule="cost-model", loc=loc,
                message=(
                    f"recorded critical_core_load={crit} but the rounds' "
                    f"core_load gives {actual_crit}"
                ),
            ))
    bal = diagnostics.get("balanced_core_load")
    if bal is not None:
        actual_bal = max(
            (-(-len(r.nodes) // schedule.n_cores) for r in schedule.rounds),
            default=0,
        )
        if bal != actual_bal:
            out.append(Finding(
                rule="cost-model", loc=loc,
                message=(
                    f"recorded balanced_core_load={bal} but the rounds give "
                    f"{actual_bal}"
                ),
            ))
    return out


def verify_schedule_static(
    ir: SamplingGraph,
    schedule: Schedule,
    *,
    placement: MeshPlacement | None = None,
    diagnostics: dict | None = None,
    adj: list[set[int]] | None = None,
    model: str | None = None,
) -> list[Finding]:
    """Run every applicable verify rule; return findings (never raises).

    Legality rules (races, coverage, clamps, pins) always run.  Comm and
    placement rules need the `placement`; cost-model rules need the pass
    `diagnostics` — both are optional so the verifier degrades gracefully
    on partial artifacts (e.g. a bare Schedule in a test)."""
    if adj is None:
        adj = ir.adjacency()
    evid = {node for node, _ in ir.evidence}
    loc = model or ir.name
    findings = _legality_findings(ir, schedule, adj, evid, loc)
    if placement is not None:
        findings += _comm_findings(ir, schedule, adj, evid, placement, loc)
        findings += _placement_findings(ir, schedule, evid, placement, loc)
    if diagnostics is not None:
        findings += _cost_findings(schedule, diagnostics, loc)
    return findings


def verify_program(program) -> Report:
    """Verify a `CompiledProgram`'s full artifact (schedule + placement +
    diagnostics) and wrap the result in a timed `Report` — the unit the
    CLI sweep and `launch/report.py`'s verification table consume."""
    t0 = time.perf_counter()
    findings = verify_schedule_static(
        program.ir,
        program.schedule,
        placement=program.placement,
        diagnostics=program.diagnostics,
        model=program.ir.name,
    )
    return Report(
        findings=findings,
        meta={
            "model": program.ir.name,
            "kind": program.ir.kind,
            "ir_key": program.ir.ir_key[:12],
            "pipeline": program.diagnostics.get("pipeline", "?"),
            "n_rounds": len(program.schedule.rounds),
            "n_rules": len(VERIFY_RULES),
            "verify_s": time.perf_counter() - t0,
        },
    )
