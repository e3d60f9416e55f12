# Copied from the reference package, src/repro/compile/ir.py: numpy only,
# kept in step with it so both packages compile a model identically.
"""`SamplingGraph` — the compile chain's input IR (paper Sec. II + Fig. 8).

Bayes nets and grid MRFs enter the compiler through one canonical form: an
undirected *conflict graph* (edge = the two RVs may not update in the same
round) plus per-RV cardinalities and baked-in evidence.  The original model
is kept as the `source` payload — later passes need the CPTs / potentials to
generate code — but every structural decision (coloring, placement,
scheduling) reads only the canonical fields, which is what lets one pipeline
serve both model families.

The IR hashes stably: `ir_key` is a sha256 over the canonical structure AND
the numeric parameters (CPT bytes, MRF potentials), so it can key the
program cache — two models that would compile to the same program share a
key, and any parameter change invalidates it.  Runtime inputs (the MRF
evidence image, PRNG keys, chain counts) are deliberately *not* part of the
IR: a serving workload re-runs one cached program with fresh data.

Evidence comes in two modes, recorded as `evidence_mode`:

  * ``"baked"``   — the (node, value) pairs are part of the program: they
    feed `ir_key`, the schedule drops them from every round, and the CPT
    gathers read their fixed values.  Two queries that differ only in an
    observed value hash to *different* programs.
  * ``"runtime"`` — structure-only canonicalization for the serving path
    (`repro.runtime`): `ir_key` hashes cards/edges/parameters but no
    evidence, and per-query observations enter `CompiledProgram.run()` as
    clamp masks (BN) / pinned pixels (MRF) instead.  Every query on the
    same model hits the same cached program.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib

import numpy as np

from repro_torch.core.graphs import DiscreteBayesNet, GridMRF


def _hash_field(h, tag: str, data: bytes) -> None:
    """Domain-separated hashing: tag + 8-byte length prefix + payload, so no
    two field byte-streams can be re-split into a colliding message."""
    h.update(tag.encode())
    h.update(len(data).to_bytes(8, "little"))
    h.update(data)


@dataclasses.dataclass(frozen=True)
class SamplingGraph:
    """Canonical conflict-graph IR for a discrete sampling workload."""

    kind: str  # "bn" | "mrf"
    n_nodes: int
    cards: tuple[int, ...]  # per-RV cardinality
    edges: tuple[tuple[int, int], ...]  # sorted conflict edges, i < j
    evidence: tuple[tuple[int, int], ...]  # sorted (node, value) pairs
    source: DiscreteBayesNet | GridMRF
    name: str = "graph"
    evidence_mode: str = "baked"  # "baked" | "runtime"

    def adjacency(self) -> list[set[int]]:
        adj: list[set[int]] = [set() for _ in range(self.n_nodes)]
        for i, j in self.edges:
            adj[i].add(j)
            adj[j].add(i)
        return adj

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    @functools.cached_property
    def ir_key(self) -> str:
        """Stable content hash: structure + numeric parameters + evidence.

        Every field is hashed as tag + length + bytes (`_hash_field`): a bare
        concatenation of the byte streams would let distinct `(cards, edges,
        evidence)` splits collide — e.g. one edge vs the same two ints read
        as an evidence pair.

        `evidence_mode` is hashed too: a runtime-evidence program accepts
        per-query clamps that a baked one rejects, so the two must never
        share a cache slot even when the structural fields agree."""
        h = hashlib.sha256()
        _hash_field(h, "kind", self.kind.encode())
        _hash_field(h, "evmode", self.evidence_mode.encode())
        _hash_field(h, "cards", np.asarray(self.cards, np.int64).tobytes())
        _hash_field(h, "edges", np.asarray(self.edges, np.int64).tobytes())
        _hash_field(
            h, "evidence", np.asarray(self.evidence, np.int64).tobytes()
        )
        if isinstance(self.source, DiscreteBayesNet):
            for ps, cpt in zip(self.source.parents, self.source.cpts):
                _hash_field(h, "parents", np.asarray(ps, np.int64).tobytes())
                _hash_field(
                    h, "cpt",
                    np.ascontiguousarray(cpt, np.float64).tobytes(),
                )
        else:
            m = self.source
            _hash_field(
                h, "mrf",
                f"{m.height},{m.width},{m.n_labels},{m.theta!r},"
                f"{m.h!r},{m.data_cost}".encode(),
            )
        return h.hexdigest()


def from_bayesnet(
    bn: DiscreteBayesNet,
    evidence: dict[int, int] | None = None,
    evidence_mode: str = "baked",
) -> SamplingGraph:
    """Canonicalize a BN: the conflict graph is the moral graph (i ~ j iff
    j in MB(i)).  With `evidence_mode="baked"` (default) evidence is part of
    the program (baked into the CPT gathers), hence part of the IR; with
    `"runtime"` the IR is structure-only and observations arrive per query
    at `CompiledProgram.run(evidence=...)`."""
    bn.validate()
    if evidence_mode not in ("baked", "runtime"):
        raise ValueError(f"unknown evidence_mode {evidence_mode!r}")
    if evidence_mode == "runtime" and evidence:
        raise ValueError(
            "structure-only canonicalization takes no evidence; pass the "
            "observations to CompiledProgram.run(evidence=...) instead"
        )
    adj = bn.moral_adjacency()
    edges = tuple(
        (i, j) for i in range(bn.n_nodes) for j in sorted(adj[i]) if i < j
    )
    ev = tuple(sorted((int(k), int(v)) for k, v in (evidence or {}).items()))
    for node, val in ev:
        if not (0 <= node < bn.n_nodes and 0 <= val < bn.cards[node]):
            raise ValueError(f"evidence {node}={val} out of range")
    return SamplingGraph(
        kind="bn",
        n_nodes=bn.n_nodes,
        cards=tuple(int(c) for c in bn.cards),
        edges=edges,
        evidence=ev,
        source=bn,
        name=bn.name,
        evidence_mode=evidence_mode,
    )


def from_mrf(
    mrf: GridMRF, pinned: dict[int, int] | None = None
) -> SamplingGraph:
    """Canonicalize a grid MRF: the conflict graph is the 4-connected grid
    adjacency.  The evidence *image* is always a runtime input (same
    program, new data every request).  `pinned` optionally bakes pixels at
    known labels into the program ({site: label}); without it the IR is
    runtime-mode and per-query pins go to `CompiledProgram.run(pins=...)`."""
    adj = mrf.adjacency()
    n = mrf.height * mrf.width
    edges = tuple((i, j) for i in range(n) for j in sorted(adj[i]) if i < j)
    ev = tuple(sorted((int(k), int(v)) for k, v in (pinned or {}).items()))
    for site, lab in ev:
        if not (0 <= site < n and 0 <= lab < mrf.n_labels):
            raise ValueError(f"pinned pixel {site}={lab} out of range")
    # the checkerboard backend executes whole parity classes; a class that
    # is pinned away entirely would change the per-iteration key-split
    # structure and silently diverge from the eager engine
    for parity in (0, 1):
        cls = {
            r * mrf.width + c
            for r in range(mrf.height)
            for c in range(mrf.width)
            if (r + c) % 2 == parity
        }
        if cls and cls <= {site for site, _ in ev}:
            raise ValueError(
                f"pinned pixels cover the entire parity-{parity} class; "
                "at least one free site per checkerboard color is required"
            )
    return SamplingGraph(
        kind="mrf",
        n_nodes=n,
        cards=(mrf.n_labels,) * n,
        edges=edges,
        evidence=ev,
        source=mrf,
        name=mrf.name,
        evidence_mode="baked" if ev else "runtime",
    )


def canonicalize(
    model: DiscreteBayesNet | GridMRF,
    evidence: dict[int, int] | None = None,
    evidence_mode: str = "baked",
) -> SamplingGraph:
    """Front-end dispatch: any supported model -> SamplingGraph.

    `evidence_mode="runtime"` is the serving path's structure-only form:
    the returned IR hashes cards/edges/parameters but no observations, so
    every query on the same model shares one `ir_key`.  An MRF's mode is
    determined by its pins, not this argument (no pins here ⇒ runtime-mode
    IR; baked pins go through `ir.from_mrf(mrf, pinned=...)`), but the
    argument is still validated so a typo cannot pass silently."""
    if evidence_mode not in ("baked", "runtime"):
        raise ValueError(f"unknown evidence_mode {evidence_mode!r}")
    if isinstance(model, DiscreteBayesNet):
        return from_bayesnet(model, evidence, evidence_mode)
    if isinstance(model, GridMRF):
        if evidence:
            raise ValueError(
                "MRF evidence is a runtime input of CompiledProgram.run(), "
                "not part of the IR (baked pins go through ir.from_mrf)"
            )
        return from_mrf(model)
    raise TypeError(f"cannot canonicalize {type(model).__name__}")
