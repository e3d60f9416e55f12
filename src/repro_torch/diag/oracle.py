"""Oracle audits (port of `repro/diag/oracle.py`): how far are the sampled
marginals from the truth, and how much of that gap is the KY
quantization's fault?

Two independent error sources meet in a served posterior:

  * *mixing* error — finite chains / finite sweeps (what R-hat and ESS in
    `diag.accum` watch), and
  * *quantization* error — the LUT-exp int8 weights (lut_ky) or 15-bit
    weight grid (exact_ky) sample a slightly different conditional than
    the CPT's (paper Sec. III-D; rejection-KY draws *exactly*
    proportionally to the integer weights, so the quantized pmf is the
    true target of the hardware datapath).

This module bounds both.  `oracle_audit` compares a run's marginal
estimate against `core/exact.py` variable elimination — but only where
the elimination is tractable: `ve_cost_estimate` replays the min-fill
order symbolically and prices the largest intermediate factor, and an
intractable model is declared "n/a" (a visible verdict the caller must
surface), never silently skipped.
`ky_quantization_tv` computes, per node, the worst total-variation gap
between the quantized conditional and the true CPT row over all parent
configurations — the irreducible floor the mixing error sits on top of.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.core.graphs import DiscreteBayesNet

# elimination-cost ceiling (entries in the largest intermediate factor)
# above which VE is declared intractable.  1e6 float64 entries ~ 8 MB and
# sub-second; the bench zoo splits cleanly (pigs/hepar2 blow through it).
DEFAULT_VE_LIMIT = 1_000_000


def ve_cost_estimate(
    bn: DiscreteBayesNet, evidence: dict[int, int] | None = None
) -> int:
    """Largest intermediate-factor size (entries) a min-fill variable
    elimination of every non-evidence variable would materialize.

    Mirrors `exact._min_fill_order`'s greedy choice on the moralized
    factor graph but runs purely on scopes — no tables are built — so
    pricing an intractable model costs microseconds, not memory."""
    evidence = dict(evidence or {})
    cards = np.asarray(bn.cards, np.int64)
    scopes = []
    for i, ps in enumerate(bn.parents):
        scope = {v for v in (tuple(ps) + (i,)) if v not in evidence}
        if scope:
            scopes.append(scope)
    elim = set(range(bn.n_nodes)) - set(evidence)
    adj: dict[int, set[int]] = {v: set() for v in elim}
    for s in scopes:
        for a, b in itertools.combinations(sorted(s), 2):
            adj[a].add(b)
            adj[b].add(a)
    worst = 1
    alive = set(adj)
    remaining = set(elim)
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
        size = int(cards[best]) * int(np.prod(cards[sorted(nbrs)], initial=1))
        worst = max(worst, size)
        for a, b in itertools.combinations(sorted(nbrs), 2):
            adj[a].add(b)
            adj[b].add(a)
        remaining.remove(best)
        alive.remove(best)
    return worst


def ve_tractable(
    bn: DiscreteBayesNet,
    evidence: dict[int, int] | None = None,
    limit: int = DEFAULT_VE_LIMIT,
) -> bool:
    return ve_cost_estimate(bn, evidence) <= limit


def oracle_audit(
    bn: DiscreteBayesNet,
    p_hat: np.ndarray,
    evidence: dict[int, int] | None = None,
    limit: int = DEFAULT_VE_LIMIT,
) -> dict:
    """Audit estimated marginals ((n, V) rows, padded slots ignored)
    against exact VE marginals.  Returns a dict with `status` "ok" or
    "n/a" (intractable — the caller must surface it, not drop it); on
    "ok", per-node total-variation distances, the max TV, and the max
    absolute per-entry error."""
    from repro_torch.core import exact

    evidence = dict(evidence or {})
    cost = ve_cost_estimate(bn, evidence)
    if cost > limit:
        return {
            "status": "n/a",
            "ve_cost": cost,
            "ve_limit": limit,
            "reason": (
                f"min-fill elimination needs a {cost}-entry intermediate "
                f"factor (limit {limit})"
            ),
        }
    p_hat = np.asarray(p_hat, np.float64)
    truth = exact.all_marginals(bn, evidence)
    tv = np.zeros(bn.n_nodes)
    maxabs = np.zeros(bn.n_nodes)
    for i, p_true in enumerate(truth):
        est = p_hat[i, : len(p_true)]
        diff = np.abs(est - p_true)
        tv[i] = 0.5 * diff.sum()
        maxabs[i] = diff.max()
    free = np.array([i not in evidence for i in range(bn.n_nodes)])
    sel = tv[free] if free.any() else tv
    return {
        "status": "ok",
        "ve_cost": cost,
        "ve_limit": limit,
        "tv": tv,
        "maxabs": maxabs,
        "tv_max": float(sel.max()) if sel.size else 0.0,
        "maxabs_max": float((maxabs[free] if free.any() else maxabs).max())
        if maxabs.size else 0.0,
    }


# ---------------------------------------------------------------------------
# KY-quantization error attribution
# ---------------------------------------------------------------------------


def quantized_pmf(
    logp: np.ndarray,
    sampler: str,
    exp_table=None,
    exp_spec=None,
) -> np.ndarray:
    """The pmf a KY sampler actually draws from for one (..., V) row of
    unnormalized log-potentials — the integer-weight quantization of
    `core/draws.py`, normalized (rejection restarts make KY sampling
    exactly proportional to the weights, so this IS the target pmf).

    Replicates the draws.py weight derivation operation for operation:
    shift by the row max, then LUT-interpolated exp rounded to int8
    (lut_ky) or exact exp on a 15-bit grid (exact_ky)."""
    from repro_torch.core import ky as ky_core
    from repro_torch.core.interp import build_exp_weight_lut, interp_ref

    logp = torch.as_tensor(np.asarray(logp, np.float32))
    z = logp - logp.amax(-1, keepdim=True)
    if sampler == "lut_ky":
        if exp_table is None:
            exp_table, exp_spec = build_exp_weight_lut(device="cpu")
        tab = torch.as_tensor(exp_table).cpu()
        w = torch.clamp(torch.round(interp_ref(z, tab, exp_spec)),
                        min=0.0).to(torch.int32)
    elif sampler == "exact_ky":
        w = ky_core.quantize_probs(torch.exp(z), bits=15)
    else:
        raise ValueError(
            f"quantized pmf is a KY concept; sampler {sampler!r} draws from "
            "the float distribution directly"
        )
    w = w.numpy().astype(np.float64)
    denom = w.sum(axis=-1, keepdims=True)
    # an all-zero weight row cannot occur (the row max always quantizes to
    # the top weight), but guard the division all the same
    return w / np.maximum(denom, 1.0)


def ky_quantization_tv(
    bn: DiscreteBayesNet,
    sampler: str = "lut_ky",
    exp_table=None,
    exp_spec=None,
) -> dict:
    """Per-node worst-case quantization error: for every parent
    configuration of every CPT, the total-variation distance between the
    true conditional row and the pmf the KY datapath actually samples.

    This is the *attribution* bound: a marginal-error audit (TV vs VE)
    that exceeds mixing noise but sits near this floor is quantization's
    fault; one far above it is a mixing (or correctness) problem."""
    tv = np.zeros(bn.n_nodes)
    for i, cpt in enumerate(bn.cpts):
        rows = np.asarray(cpt, np.float64).reshape(-1, cpt.shape[-1])
        with np.errstate(divide="ignore"):
            logp = np.log(rows)
        q = quantized_pmf(logp, sampler, exp_table, exp_spec)
        tv[i] = float(np.max(0.5 * np.abs(q - rows).sum(-1)))
    return {
        "sampler": sampler,
        "tv": tv,
        "tv_max": float(tv.max()) if tv.size else 0.0,
    }
