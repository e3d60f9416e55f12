"""`repro_torch.analysis` — the finding model the schedule verifier reports in.

Copied from the reference package's `repro.analysis` (`Finding`, `Report`
and the rule catalog of the schedule verifier, `analysis/verify.py`).  The
kernel linter and the source lint are not part of the port yet.  Plain
Python and numpy: nothing here touches a device.
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
