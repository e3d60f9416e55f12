"""Synthetic serving traces: Zipf-over-models and bursty on/off streams
(a copy of `repro/runtime/trace.py`; the same (seed, quick) pair gives
the reference's trace, byte for byte).

Real sampling-as-a-service traffic is heavy-tailed over a model zoo — a few
hot models take most queries, a long tail stays warm in the cache.  The
Zipf trace models exactly that: model i is drawn with probability
proportional to 1/(i+1)^s, arrivals are a Poisson process (exponential
interarrivals), and per-query observations are sampled from a small pool of
observation *patterns* per model (real deployments re-use feature masks far
more than feature values, which is what makes clamp-set bucketing pay off).

Steady-state Poisson arrivals never actually stress admission control, so
the **bursty** trace layers an on/off (Markov-modulated) envelope on top:
ON periods fire arrivals at a rate far above the executor's service rate,
OFF periods go silent.  That is the arrival pattern that fills bounded
queues, drains token buckets, and forces shed/defer decisions — the
backpressure machinery gets exercised instead of merely existing.

Everything is seeded `numpy.random.default_rng` — the same (seed, quick)
pair replays the identical trace, which the engine's deterministic clock
turns into identical metrics.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graphs import GridMRF, bn_repository_replica
from repro_torch.core.mrf import make_denoising_problem
from repro_torch.runtime.batcher import Query


def zipf_models(quick: bool = False) -> dict:
    """The model zoo, hottest first (rank order = Zipf rank).  The quick
    zoo is deliberately small: every (model, observation-pattern) pair is
    a distinct executable to compile, and the CI smoke budget is minutes."""
    names = ["survey", "cancer", "asia"]
    if not quick:
        names += ["sachs", "insurance", "alarm"]
    models = {n: bn_repository_replica(n) for n in names}
    size = 8 if quick else 16
    models["grid"] = GridMRF(size, size, 3, theta=1.1, h=1.8, name="grid")
    return models


def zipf_trace(
    n_queries: int = 150,
    *,
    quick: bool = False,
    seed: int = 0,
    s: float = 1.1,
    mean_interarrival_s: float = 1e-4,
    n_patterns: int = 2,
    n_chains: int = 8,
    n_iters: int = 40,
    burn_in: int = 10,
) -> tuple[dict, list[Query]]:
    """Build (models, queries) for a Zipf-distributed posterior workload.

    BN queries observe one of `n_patterns` fixed node subsets per model
    (values re-drawn per query); MRF queries carry a fresh noisy image and,
    half the time, a few pinned pixels.  Returns models keyed by name and
    queries sorted by arrival time."""
    if quick:
        n_queries = min(n_queries, 60)
        n_iters = min(n_iters, 16)
        n_chains = min(n_chains, 4)
        burn_in = min(burn_in, 4)
        n_patterns = 1  # one executable per model in the CI smoke budget
    rng = np.random.default_rng(seed)
    models = zipf_models(quick)
    patterns = _observation_patterns(models, rng, n_patterns)
    weights = _zipf_weights(models, s)
    # NB: the interarrival draw is interleaved with the query draws (not
    # pre-drawn) so the (seed, quick) -> trace mapping stays byte-identical
    # across PRs — benchmark baselines compare the same workload
    queries: list[Query] = []
    clock = 0.0
    for qid in range(n_queries):
        clock += float(rng.exponential(mean_interarrival_s))
        queries.append(_draw_query(
            qid, clock, models, patterns, weights, rng, quick=quick,
            n_chains=n_chains, n_iters=n_iters, burn_in=burn_in,
        ))
    return models, queries


def bursty_trace(
    n_queries: int = 150,
    *,
    quick: bool = False,
    seed: int = 0,
    s: float = 1.1,
    on_s: float = 1.5e-3,
    off_s: float = 6e-3,
    burst_interarrival_s: float = 2e-5,
    n_patterns: int = 2,
    n_chains: int = 8,
    n_iters: int = 40,
    burn_in: int = 10,
) -> tuple[dict, list[Query]]:
    """Build (models, queries) for a saturating on/off arrival pattern.

    The same Zipf zoo and observation patterns as `zipf_trace`, but
    arrivals come in bursts: ON periods (exponential, mean `on_s`) fire
    queries every ~`burst_interarrival_s` — far faster than the executor
    can serve — then OFF periods (mean `off_s`) go silent so queues drain.
    This is the trace that actually exercises token-bucket admission and
    bounded-queue shedding; Zipf steady-state never does."""
    if quick:
        n_queries = min(n_queries, 60)
        n_iters = min(n_iters, 16)
        n_chains = min(n_chains, 4)
        burn_in = min(burn_in, 4)
        n_patterns = 1
    rng = np.random.default_rng(seed)
    models = zipf_models(quick)
    patterns = _observation_patterns(models, rng, n_patterns)
    weights = _zipf_weights(models, s)
    arrivals = _onoff_arrivals(
        n_queries, rng, on_s, off_s, burst_interarrival_s
    )
    queries = [
        _draw_query(qid, clock, models, patterns, weights, rng, quick=quick,
                    n_chains=n_chains, n_iters=n_iters, burn_in=burn_in)
        for qid, clock in enumerate(arrivals)
    ]
    return models, queries


TRACES = {"zipf": zipf_trace, "bursty": bursty_trace}


# ---------------------------------------------------------------------------
# shared trace machinery
# ---------------------------------------------------------------------------


def _observation_patterns(
    models: dict, rng, n_patterns: int
) -> dict[str, list[np.ndarray]]:
    """Per-BN-model pool of observed-node patterns (the serving reality
    that makes static clamp sets cacheable)."""
    patterns: dict[str, list[np.ndarray]] = {}
    for name, m in models.items():
        if isinstance(m, GridMRF):
            continue
        k = max(1, m.n_nodes // 4)
        patterns[name] = [
            rng.choice(m.n_nodes, size=min(k, m.n_nodes - 1), replace=False)
            for _ in range(n_patterns)
        ]
    return patterns


def _onoff_arrivals(
    n: int, rng, on_s: float, off_s: float, burst_interarrival_s: float
) -> list[float]:
    """Markov-modulated arrivals: dense bursts during ON, silence OFF."""
    clock, out = 0.0, []
    phase_end = clock + float(rng.exponential(on_s))
    while len(out) < n:
        dt = float(rng.exponential(burst_interarrival_s))
        if clock + dt > phase_end:
            # end of the ON period: skip the OFF gap, start the next burst
            clock = phase_end + float(rng.exponential(off_s))
            phase_end = clock + float(rng.exponential(on_s))
            continue
        clock += dt
        out.append(clock)
    return out


def _zipf_weights(models: dict, s: float) -> np.ndarray:
    """Model-selection weights, hottest first (rank order = Zipf rank) —
    computed once per trace, they consume no RNG."""
    weights = 1.0 / np.arange(1, len(models) + 1) ** s
    return weights / weights.sum()


def _draw_query(
    qid: int, clock: float, models: dict, patterns: dict,
    weights: np.ndarray, rng, *,
    quick: bool, n_chains: int, n_iters: int, burn_in: int,
) -> Query:
    """One Zipf-distributed query at a given arrival instant (shared by
    every trace family — the families differ only in their arrival
    process)."""
    names = list(models)
    name = names[int(rng.choice(len(names), p=weights))]
    m = models[name]
    if isinstance(m, GridMRF):
        _, noisy = make_denoising_problem(
            m.height, m.width, m.n_labels, noise=0.25,
            seed=int(rng.integers(1 << 16)),
        )
        # pinned and unpinned MRF buckets are distinct executables;
        # the quick trace pins everything to compile just one
        pins = None
        if quick or rng.random() < 0.5:
            sites = rng.choice(m.height * m.width, size=3, replace=False)
            pins = {int(p): int(rng.integers(m.n_labels)) for p in sites}
        return Query(
            qid=qid, model=name, evidence=pins, image=noisy,
            n_chains=n_chains, n_iters=n_iters, burn_in=0,
            seed=int(rng.integers(1 << 30)), arrival_s=clock,
        )
    nodes = patterns[name][int(rng.integers(len(patterns[name])))]
    ev = {int(v): int(rng.integers(m.cards[v])) for v in nodes}
    # per-query thinning splits buckets (it is a static loop parameter), so
    # the quick/CI trace keeps thin=1 to bound the number of distinct
    # executables it compiles
    thin = 1 if quick else int(rng.choice([1, 2]))
    return Query(
        qid=qid, model=name, evidence=ev,
        n_chains=n_chains, n_iters=n_iters, burn_in=burn_in, thin=thin,
        seed=int(rng.integers(1 << 30)), arrival_s=clock,
    )
