# Copied from the reference package, src/repro/core/graphs.py: numpy only,
# kept in step with it so both packages compile a model identically.
"""Discrete probabilistic-model graph IR (paper Sec. II).

The front-end of the "AIA compiler": Bayes nets (irregular DAGs with CPTs)
and grid MRFs are described here as plain numpy structures; `coloring.py`
and `bayesnet.py` lower them to dense per-color update tensors.

BN-repository benchmarks (survey, cancer, alarm, ...) are not downloadable in
this offline container, so `bn_repository_replica()` generates *structure-
matched synthetic replicas*: same node count, comparable in/out-degree and
arity ranges taken from the published descriptions.  Every benchmark table
that uses them says so.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class DiscreteBayesNet:
    """Nodes 0..n-1 in topological order; cpts[i] has shape
    (card[p0], ..., card[pk], card[i]) for parents p0..pk of node i."""

    cards: np.ndarray  # (n,) int
    parents: list[list[int]]
    cpts: list[np.ndarray]
    name: str = "bn"

    @property
    def n_nodes(self) -> int:
        return len(self.cards)

    def children(self, i: int) -> list[int]:
        return [c for c in range(self.n_nodes) if i in self.parents[c]]

    def markov_blanket(self, i: int) -> set[int]:
        mb: set[int] = set(self.parents[i])
        for c in self.children(i):
            mb.add(c)
            mb.update(self.parents[c])
        mb.discard(i)
        return mb

    def moral_adjacency(self) -> list[set[int]]:
        """Undirected conflict graph for chromatic Gibbs: i ~ j iff j is in
        MB(i).  (Symmetric by construction of the Markov blanket.)"""
        adj = [set() for _ in range(self.n_nodes)]
        for i in range(self.n_nodes):
            for j in self.markov_blanket(i):
                adj[i].add(j)
                adj[j].add(i)
        return adj

    def n_edges(self) -> int:
        return sum(len(p) for p in self.parents)

    def validate(self) -> None:
        for i, (ps, cpt) in enumerate(zip(self.parents, self.cpts)):
            assert all(p < i for p in ps), f"node {i}: parents must precede"
            want = tuple(self.cards[p] for p in ps) + (self.cards[i],)
            assert cpt.shape == want, f"node {i}: cpt shape {cpt.shape} != {want}"
            s = cpt.sum(axis=-1)
            assert np.allclose(s, 1.0, atol=1e-6), f"node {i}: cpt not normalized"

    def joint_logp(self, assignment: np.ndarray) -> float:
        lp = 0.0
        for i, (ps, cpt) in enumerate(zip(self.parents, self.cpts)):
            idx = tuple(int(assignment[p]) for p in ps) + (int(assignment[i]),)
            lp += float(np.log(cpt[idx]))
        return lp


def random_cpt(rng: np.random.Generator, shape: tuple[int, ...]) -> np.ndarray:
    """Dirichlet(0.8) rows — mildly peaked, no zero entries (ergodic Gibbs)."""
    flat = rng.dirichlet(np.full(shape[-1], 0.8), size=int(np.prod(shape[:-1])))
    return np.clip(flat, 1e-4, None).reshape(shape) / np.clip(
        flat, 1e-4, None
    ).reshape(shape).sum(-1, keepdims=True)


def random_bayesnet(
    n_nodes: int,
    max_parents: int = 3,
    cards: Sequence[int] | int = 2,
    seed: int = 0,
    name: str = "random",
    edge_density: float = 0.5,
) -> DiscreteBayesNet:
    rng = np.random.default_rng(seed)
    if isinstance(cards, int):
        card_arr = np.full(n_nodes, cards, np.int64)
    else:
        card_arr = rng.choice(list(cards), size=n_nodes)
    parents: list[list[int]] = []
    for i in range(n_nodes):
        k = min(i, max_parents)
        k = int(rng.binomial(k, edge_density)) if k else 0
        ps = sorted(rng.choice(i, size=k, replace=False).tolist()) if k else []
        parents.append(ps)
    cpts = [
        random_cpt(rng, tuple(card_arr[p] for p in ps) + (int(card_arr[i]),))
        for i, ps in enumerate(parents)
    ]
    bn = DiscreteBayesNet(card_arr, parents, cpts, name=name)
    bn.validate()
    return bn


# (n_nodes, max_parents, arity candidates, density) from published BN-repo
# descriptions — structure-matched replicas, NOT the original CPTs.
_BN_REPO_STATS: dict[str, tuple[int, int, tuple[int, ...], float]] = {
    "survey": (6, 2, (2, 3), 0.7),
    "cancer": (5, 2, (2,), 0.7),
    "asia": (8, 2, (2,), 0.7),
    "sachs": (11, 3, (3,), 0.6),
    "insurance": (27, 3, (2, 3, 4, 5), 0.6),
    "water": (32, 5, (3, 4), 0.5),
    "alarm": (37, 4, (2, 3, 4), 0.55),
    "hailfinder": (56, 4, (2, 3, 4, 5, 11), 0.5),
    "hepar2": (70, 6, (2, 3, 4), 0.45),
    "win95pts": (76, 7, (2,), 0.4),
    "pigs": (441, 2, (3,), 0.6),
}


def bn_repository_replica(name: str, seed: int = 0) -> DiscreteBayesNet:
    n, mp, cards, dens = _BN_REPO_STATS[name]
    return random_bayesnet(
        n, max_parents=mp, cards=cards, seed=seed, name=name, edge_density=dens
    )


def bn_repository_names() -> list[str]:
    return list(_BN_REPO_STATS)


@dataclasses.dataclass(frozen=True)
class GridMRF:
    """Potts/Ising MRF on an (H, W) 4-connected grid (paper Eqn. 7).

    E(l) = sum_(i~j) theta·[l_i == l_j] + sum_i datacost(l_i, e_i)
    datacost = h·[l_i == e_i]           ('potts', the paper's form)
             | -h·(l_i - e_i)^2          ('quadratic', gray-level denoising)
    """

    height: int
    width: int
    n_labels: int
    theta: float = 1.0
    h: float = 2.0
    data_cost: str = "potts"
    name: str = "mrf"

    def checkerboard_colors(self) -> np.ndarray:
        ii = np.add.outer(np.arange(self.height), np.arange(self.width))
        return (ii % 2).astype(np.int64)

    def adjacency(self) -> list[set[int]]:
        def nid(r, c):
            return r * self.width + c

        adj = [set() for _ in range(self.height * self.width)]
        for r in range(self.height):
            for c in range(self.width):
                for dr, dc in ((0, 1), (1, 0)):
                    r2, c2 = r + dr, c + dc
                    if r2 < self.height and c2 < self.width:
                        adj[nid(r, c)].add(nid(r2, c2))
                        adj[nid(r2, c2)].add(nid(r, c))
        return adj
