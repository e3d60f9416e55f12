"""`repro_torch.analysis` — the finding model every analyzer reports in.

Copied from the reference package's `repro.analysis` (`Finding`, `Report`
and the rule catalog): the schedule verifier (`analysis/verify.py`), the
kernel lint on Hopper shared memory (`kernel_lint.py`), the port's source
lint (`source_lint.py`), the quality CLI (`python -m repro_torch.diag`)
and the observability CLIs.  `python -m repro_torch.analysis` runs the
three analyzers.  Plain Python and numpy: nothing here touches a device.
"""

from __future__ import annotations

import dataclasses
import json


# ---------------------------------------------------------------------------
# Rule catalog: every finding names one of these ids.  The severity here is
# the rule's *default*; individual findings may downgrade (never upgrade).
# ---------------------------------------------------------------------------

RULES: dict[str, tuple[str, str]] = {
    # -- schedule verifier (analysis/verify.py) -----------------------------
    "race-in-round": (
        "error",
        "two conflict-graph neighbors are scheduled in the same color round "
        "(the parallel-Gibbs race condition)",
    ),
    "node-dup": ("error", "a node is scheduled in more than one round"),
    "coverage": (
        "error",
        "the rounds do not partition the free RVs (orphan or unknown node)",
    ),
    "clamp-resampled": (
        "error",
        "an evidence-clamped node appears in a sampling round",
    ),
    "pin-full-parity": (
        "error",
        "MRF pins cover an entire checkerboard parity class (the "
        "per-iteration key-split structure would silently change)",
    ),
    "comm-missing": (
        "error",
        "a cross-core conflict edge that crosses a round boundary has no "
        "covering comm op in the round that produces the value",
    ),
    "comm-mechanism": (
        "error",
        "a comm op names the wrong data-movement mechanism for this model "
        "family (ppermute_halo for MRF, psum_broadcast for BN)",
    ),
    "comm-bytes": (
        "error",
        "a comm op's byte count disagrees with the traffic its round "
        "actually generates",
    ),
    "comm-hops": (
        "error",
        "a comm op's hop count is not the Manhattan distance between its "
        "cores on the mesh",
    ),
    "comm-spurious": (
        "warning",
        "a comm op ships traffic no conflict edge generates (the cost "
        "model overcharges)",
    ),
    "placement-range": ("error", "a node is placed on a core off the mesh"),
    "placement-load": (
        "error",
        "a round's recorded core_load disagrees with the placement "
        "(compute_cycles would charge the wrong critical core)",
    ),
    "load-imbalance": (
        "warning",
        "a round's critical core load exceeds twice its balanced share "
        "(placement quality, not correctness)",
    ),
    "cost-model": (
        "error",
        "recorded cost diagnostics disagree with the cost recomputed from "
        "the schedule",
    ),
    # -- kernel lint (analysis/kernel_lint.py): the reference's vmem-budget
    # and vmem-pressure, judged on a block's shared memory ------------------
    "smem-budget": (
        "error",
        "a fused kernel's block needs more shared memory than Hopper's "
        "227 KB per block (the launch would fail; demote to unfused)",
    ),
    "smem-pressure": (
        "warning",
        "a fused kernel's block needs more than 75% of the shared-memory "
        "budget",
    ),
    "ky-lanes": (
        "error",
        "a model's widest alphabet exceeds the KY walk's 127 bins (the "
        "fused kernels reject it; demote to unfused)",
    ),
    # -- sampling-quality CLI (python -m repro_torch.diag) -------------------
    "diag-threshold-breach": (
        "error",
        "a run's sampling-quality diagnostic (split R-hat, TV-vs-exact "
        "marginal error, ESS floor) breached its threshold — the posterior "
        "is not converged/faithful at this budget",
    ),
    "diag-oracle-unavailable": (
        "warning",
        "the exact-inference oracle is intractable for this model "
        "(min-fill VE cost above the limit); marginal error went unaudited, "
        "not silently passed",
    ),
    "diag-accum-overflow": (
        "error",
        "the quality accumulator's kept-draw count approached the int32/"
        "float32 exactness headroom (statistics no longer trustworthy)",
    ),
    # -- source lint (analysis/source_lint.py) -------------------------------
    "wallclock-in-sim": (
        "error",
        "wall-clock call (time.time/perf_counter/monotonic, datetime.now) "
        "inside a deterministic-simulation module",
    ),
    "bare-assert": (
        "error",
        "bare `assert` guarding a compile-pipeline invariant (stripped "
        "under python -O; raise ScheduleVerificationError instead)",
    ),
    "port-import": (
        "error",
        "the port imports jax or the reference package `repro`, or imports "
        "triton at module level (it must import on a host without them)",
    ),
    "torch-random-unkeyed": (
        "error",
        "a torch random call without an explicit `generator=` (the port "
        "draws from the threefry key streams; a global-RNG draw is neither "
        "reproducible nor the reference's)",
    ),
    "twin-float-division": (
        "error",
        "a tensor divided by a Python float in a twin (CUDA rounds "
        "`tensor / float` differently; pass a 0-dim float32 tensor, "
        "core/interp.py `scalar`)",
    ),
    # -- observability (runtime CLI) -----------------------------------------
    "obs-trace-dropped": (
        "warning",
        "the tracer ring buffer overflowed during the run (dropped events "
        "silently skew attribution coverage; re-run with "
        "obs.enable(capacity=...) raised)",
    ),
}

SEVERITIES = ("error", "warning", "info")


def rule_severity(rule: str) -> str:
    return RULES[rule][0] if rule in RULES else "error"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer result: rule id, severity, location, message, fix hint.

    `loc` is a clickable `path:line` for source findings and a
    `model:round N` / `model:ir` style anchor for artifact findings —
    always something a human can jump to."""

    rule: str
    loc: str
    message: str
    severity: str = ""
    fixit: str = ""

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"unknown rule id {self.rule!r}")
        sev = self.severity or rule_severity(self.rule)
        if sev not in SEVERITIES:
            raise ValueError(f"unknown severity {sev!r}")
        object.__setattr__(self, "severity", sev)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        tail = f"  [fix: {self.fixit}]" if self.fixit else ""
        return f"{self.loc}: {self.severity}[{self.rule}] {self.message}{tail}"


@dataclasses.dataclass
class Report:
    """The shared reporting spine: findings + run metadata, renderable as
    text (one line per finding) or JSON (the CI artifact schema)."""

    findings: list[Finding] = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    @property
    def exit_code(self) -> int:
        """Nonzero exactly when an error-severity finding exists — the CLI
        and CI contract."""
        return 1 if self.errors else 0

    def to_dict(self) -> dict:
        return {
            "schema": 1,
            "n_findings": len(self.findings),
            "n_errors": len(self.errors),
            "n_warnings": len(self.warnings),
            "findings": [f.to_dict() for f in self.findings],
            "meta": self.meta,
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def render_text(self) -> str:
        lines = [f.render() for f in self.findings]
        lines.append(
            f"{len(self.findings)} finding(s): {len(self.errors)} error(s), "
            f"{len(self.warnings)} warning(s)"
        )
        return "\n".join(lines)
