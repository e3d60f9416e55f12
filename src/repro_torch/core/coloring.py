# Copied from the reference package, src/repro/core/coloring.py: numpy only,
# kept in step with it so both packages compile a model identically.
"""DSATUR graph coloring (paper Sec. IV-A) — the RV-parallelism detector.

Colors the Gibbs conflict graph (moral graph for BNs, grid adjacency for
MRFs) so that same-color RVs are conditionally independent and can be updated
simultaneously (Alg. 2).  DSATUR: repeatedly color the vertex with the
highest saturation degree (number of distinct neighbor colors), breaking ties
by degree.  The paper reports <= 6 colors on all BN-repo workloads.
"""

from __future__ import annotations

import heapq

import numpy as np


def dsatur(adj: list[set[int]]) -> np.ndarray:
    n = len(adj)
    colors = np.full(n, -1, np.int64)
    if n == 0:
        return colors
    sat: list[set[int]] = [set() for _ in range(n)]
    degree = np.array([len(a) for a in adj])
    # max-heap keyed by (saturation, degree); lazily invalidated entries
    heap = [(-0, -int(degree[i]), i) for i in range(n)]
    heapq.heapify(heap)
    colored = 0
    while colored < n:
        while True:
            s, d, v = heapq.heappop(heap)
            if colors[v] == -1 and -s == len(sat[v]):
                break
        used = {colors[u] for u in adj[v] if colors[u] != -1}
        c = 0
        while c in used:
            c += 1
        colors[v] = c
        colored += 1
        for u in adj[v]:
            if colors[u] == -1 and c not in sat[u]:
                sat[u].add(c)
                heapq.heappush(heap, (-len(sat[u]), -int(degree[u]), u))
    return colors


def verify_coloring(adj: list[set[int]], colors: np.ndarray) -> bool:
    """No two adjacent vertices share a color == the conditional-independence
    precondition of parallel Gibbs (checked after coloring, as in the paper)."""
    return all(
        colors[v] != colors[u] for v in range(len(adj)) for u in adj[v]
    ) and (colors >= 0).all()


def color_groups(colors: np.ndarray) -> list[np.ndarray]:
    return [np.where(colors == c)[0] for c in range(int(colors.max()) + 1)]


def color_stats(colors: np.ndarray) -> dict:
    groups = color_groups(colors)
    sizes = np.array([len(g) for g in groups])
    return {
        "n_colors": len(groups),
        "sizes": sizes,
        "balance": float(sizes.min() / sizes.max()) if len(sizes) else 1.0,
    }


def parallel_speedup(colors: np.ndarray, n_cores: int) -> float:
    """Fig. 9 line-graph model: sequential cost = n RVs; chromatic-parallel
    cost = sum_c ceil(|color c| / n_cores)."""
    groups = color_groups(colors)
    par = sum(-(-len(g) // n_cores) for g in groups)
    return len(colors) / max(par, 1)
