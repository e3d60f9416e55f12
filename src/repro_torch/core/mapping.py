# Copied from the reference package, src/repro/core/mapping.py: numpy only,
# kept in step with it so both packages compile a model identically.
"""Spatial mapping of colored RVs onto a 2-D core/device mesh (paper Sec. IV-B).

After coloring, AIA's compiler places mutually-independent nodes on the 4x4
mesh "maximizing parallelism and minimizing the communication distance
between nodes that have to exchange information".  We reproduce that greedy
heuristic for an arbitrary (rows x cols) mesh:

  * nodes are placed in decreasing conflict-degree order;
  * each node goes to the core minimizing the summed Manhattan distance to
    its already-placed Markov-blanket neighbors;
  * per-(core, color) load is capped at ceil(|color|/n_cores) to keep every
    color's update step balanced (the parallelism half of the objective).

On AIA the payoff is 1-cycle neighbor-RF reads; on TPU the payoff is that
`ppermute` halo partners are mesh-adjacent (single ICI hop).  The distributed
BN engine uses the placement to partition color groups; `comm_cost` is the
metric reported in bench_coloring (vs. a random placement baseline).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MeshPlacement:
    placement: np.ndarray  # (n_nodes,) core id
    mesh_shape: tuple[int, int]

    def coords(self, core: int) -> tuple[int, int]:
        return divmod(core, self.mesh_shape[1])


def _manhattan(a: int, b: int, cols: int) -> int:
    ra, ca = divmod(a, cols)
    rb, cb = divmod(b, cols)
    return abs(ra - rb) + abs(ca - cb)


def greedy_map(
    adj: list[set[int]],
    colors: np.ndarray,
    mesh_shape: tuple[int, int] = (4, 4),
) -> MeshPlacement:
    rows, cols = mesh_shape
    n_cores = rows * cols
    n = len(adj)
    placement = np.full(n, -1, np.int64)
    # per-color per-core capacity keeps each color's parallel step balanced
    cap = {
        c: -(-int((colors == c).sum()) // n_cores)
        for c in range(int(colors.max()) + 1)
    }
    load = np.zeros((int(colors.max()) + 1, n_cores), np.int64)
    order = sorted(range(n), key=lambda v: -len(adj[v]))
    for v in order:
        c = int(colors[v])
        placed_nbrs = [u for u in adj[v] if placement[u] >= 0]
        best, best_cost = None, None
        for core in range(n_cores):
            if load[c, core] >= cap[c]:
                continue
            cost = sum(
                _manhattan(core, int(placement[u]), cols) for u in placed_nbrs
            )
            # prefer lightly-loaded cores on ties (spread for parallelism)
            key = (cost, int(load[:, core].sum()))
            if best_cost is None or key < best_cost:
                best, best_cost = core, key
        placement[v] = best
        load[c, best] += 1
    return MeshPlacement(placement, mesh_shape)


def random_map(
    n_nodes: int, mesh_shape: tuple[int, int] = (4, 4), seed: int = 0
) -> MeshPlacement:
    rng = np.random.default_rng(seed)
    n_cores = mesh_shape[0] * mesh_shape[1]
    return MeshPlacement(
        rng.integers(0, n_cores, size=n_nodes), mesh_shape
    )


def comm_cost(adj: list[set[int]], pl: MeshPlacement) -> float:
    """Total Manhattan hops over all conflict edges — the paper's
    communication-distance objective (lower = cheaper exchanges)."""
    cols = pl.mesh_shape[1]
    total = 0
    for v in range(len(adj)):
        for u in adj[v]:
            if u > v:
                total += _manhattan(int(pl.placement[v]), int(pl.placement[u]), cols)
    return float(total)
