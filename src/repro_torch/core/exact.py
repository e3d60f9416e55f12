# Copied from the reference package, src/repro/core/exact.py: numpy only,
# kept in step with it so both packages compile a model identically.
"""Exact inference by variable elimination — the test oracle and the
"exact inference" baseline column of Table IV (Dice's role in the paper).

Factors are dense numpy arrays over sorted variable scopes; elimination order
is min-fill.  Tractable for the small/medium replicas (treewidth-bounded);
the large ones (pigs, hepar2) are exactly the regime where the paper argues
sampling wins — our Table IV reproduction reports VE runtime or timeout there.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from repro_torch.core.graphs import DiscreteBayesNet


@dataclasses.dataclass
class Factor:
    scope: tuple[int, ...]  # sorted variable ids
    table: np.ndarray  # shape = cards[scope]

    def __post_init__(self):
        assert tuple(sorted(self.scope)) == tuple(self.scope)


def _product(a: Factor, b: Factor, cards: np.ndarray) -> Factor:
    scope = tuple(sorted(set(a.scope) | set(b.scope)))

    def expand(f: Factor) -> np.ndarray:
        shape = [cards[v] if v in f.scope else 1 for v in scope]
        perm = [f.scope.index(v) for v in scope if v in f.scope]
        return f.table.transpose(perm).reshape(shape)

    return Factor(scope, expand(a) * expand(b))


def _marginalize(f: Factor, var: int) -> Factor:
    ax = f.scope.index(var)
    return Factor(tuple(v for v in f.scope if v != var), f.table.sum(axis=ax))


def _reduce_evidence(f: Factor, evidence: dict[int, int]) -> Factor:
    idx: list = []
    scope: list[int] = []
    for v in f.scope:
        if v in evidence:
            idx.append(evidence[v])
        else:
            idx.append(slice(None))
            scope.append(v)
    return Factor(tuple(scope), f.table[tuple(idx)])


def _min_fill_order(scopes: list[set[int]], elim: set[int]) -> list[int]:
    all_vars = set().union(*scopes) if scopes else set()
    adj: dict[int, set[int]] = {v: set() for v in all_vars | elim}
    for s in scopes:
        for a, b in itertools.combinations(sorted(s), 2):
            adj[a].add(b)
            adj[b].add(a)
    order: list[int] = []
    remaining = set(elim)
    alive = set(adj)
    while remaining:
        best, best_fill = None, None
        for v in sorted(remaining):
            nbrs = adj[v] & alive - {v}
            fill = sum(
                1
                for a, b in itertools.combinations(sorted(nbrs), 2)
                if b not in adj[a]
            )
            if best_fill is None or fill < best_fill:
                best, best_fill = v, fill
        nbrs = adj[best] & alive - {best}
        for a, b in itertools.combinations(sorted(nbrs), 2):
            adj[a].add(b)
            adj[b].add(a)
        order.append(best)
        remaining.remove(best)
        alive.remove(best)
    return order


def ve_marginal(
    bn: DiscreteBayesNet, query: int, evidence: dict[int, int] | None = None
) -> np.ndarray:
    """P(X_query | evidence) by variable elimination."""
    evidence = dict(evidence or {})
    assert query not in evidence
    factors = []
    for i, (ps, cpt) in enumerate(zip(bn.parents, bn.cpts)):
        scope = tuple(ps) + (i,)
        order = tuple(np.argsort(scope))
        f = Factor(tuple(sorted(scope)), np.ascontiguousarray(cpt.transpose(order)))
        factors.append(_reduce_evidence(f, evidence))

    elim = set(range(bn.n_nodes)) - {query} - set(evidence)
    scopes = [set(f.scope) for f in factors]
    for v in _min_fill_order(scopes, elim):
        touching = [f for f in factors if v in f.scope]
        rest = [f for f in factors if v not in f.scope]
        prod = touching[0]
        for f in touching[1:]:
            prod = _product(prod, f, bn.cards)
        factors = rest + [_marginalize(prod, v)]

    result = factors[0]
    for f in factors[1:]:
        result = _product(result, f, bn.cards)
    assert result.scope == (query,), result.scope
    t = result.table.astype(np.float64)
    return t / t.sum()


def all_marginals(
    bn: DiscreteBayesNet, evidence: dict[int, int] | None = None
) -> list[np.ndarray]:
    return [
        ve_marginal(bn, q, evidence)
        if q not in (evidence or {})
        else np.eye(bn.cards[q])[(evidence or {})[q]]
        for q in range(bn.n_nodes)
    ]


def brute_force_marginal(
    bn: DiscreteBayesNet, query: int, evidence: dict[int, int] | None = None
) -> np.ndarray:
    """O(prod cards) enumeration — oracle for the oracle (tiny nets only)."""
    evidence = dict(evidence or {})
    out = np.zeros(bn.cards[query], np.float64)
    ranges = [range(c) for c in bn.cards]
    for assign in itertools.product(*ranges):
        if any(assign[v] != x for v, x in evidence.items()):
            continue
        p = np.exp(bn.joint_logp(np.asarray(assign)))
        out[assign[query]] += p
    return out / out.sum()
