"""Streaming sampling-quality accumulators (port of `repro/diag/accum.py`).

One `QualityAccum` rides inside the Gibbs iteration loops
(`bayesnet.gibbs_run_loop`, `mrf.mrf_gibbs_loop` and the schedule
backend's round cores) and takes the same per-sweep one-hot tensor the
marginal histogram uses: a Welford update on the run's device, no host
sync, no randomness consumed, so switching diagnostics on never changes a
draw stream.  It lives in the chain state (`BNChainState.quality` /
`MRFChainState.quality`), and the kept-draw index comes from its own
counters, so a run sliced at any boundaries accumulates the same
statistics as an uninterrupted one.

What it tracks, per chain, per node, per value of the one-hot marginal
indicator x = 1[X_node = v]:

  * split-chain mean/variance (Welford, two halves at `split_at`, the
    kept-index midpoint of the query's *total* budget, fixed when the
    accumulator is made); `summarize` folds the 2B sub-chains into
    Gelman-Rubin split R-hat;
  * batch-means state (`batch_len`-draw batches, Welford over the batch
    means) -> effective sample size per chain,
    ESS = kept * Var(x) / (L * Var(batch means)), summed over chains;
  * the pooled mean, the streaming marginal estimate `p_hat`.

The counters are host integers (the loop's keep gate is a host decision
in the port), the moments float32 tensors.  `summarize` runs on the host
(numpy) at the end of a run and is the reference's, copied.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# batch length for the batch-means ESS estimator: long enough to absorb
# the few-sweep autocorrelation of chromatic Gibbs on the bench nets,
# short enough that quick budgets still complete >= 2 batches
DEFAULT_BATCH_LEN = 8

# kept*chains headroom before the int32 histogram in BNChainState.hist
# (and the float32 Welford counts) start losing exactness
_INT32_HEADROOM = 2**30


@dataclasses.dataclass
class QualityAccum:
    """Raw streaming moments of one run."""

    counts: tuple[int, int]  # kept draws per split half
    mean: torch.Tensor  # (2, B, S, V) f32 Welford mean per half/chain/site/V
    m2: torch.Tensor  # (2, B, S, V) f32 Welford sum of squared deviations
    split_at: int  # kept index where half 1 begins
    batch_len: int  # batch-means batch length
    bm_count: int  # completed batches
    bm_mean: torch.Tensor  # (B, S, V) f32 Welford mean over batch means
    bm_m2: torch.Tensor  # (B, S, V) f32 Welford m2 over batch means
    cur_sum: torch.Tensor  # (B, S, V) f32 running sum of the open batch
    cur_n: int  # kept draws in the open batch


def make_accum(
    n_chains: int,
    n_sites: int,
    n_values: int,
    total_kept: int,
    batch_len: int = DEFAULT_BATCH_LEN,
    device="cuda",
) -> QualityAccum:
    """Fresh accumulator for a run that will keep `total_kept` draws in
    total (the *whole* query budget, not the current slice: the split
    point must be the same wherever the run is sliced)."""
    shape2 = (2, n_chains, n_sites, n_values)
    shape1 = (n_chains, n_sites, n_values)

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return QualityAccum(
        counts=(0, 0),
        mean=zeros(shape2),
        m2=zeros(shape2),
        split_at=max(int(total_kept) // 2, 1),
        batch_len=int(batch_len),
        bm_count=0,
        bm_mean=zeros(shape1),
        bm_m2=zeros(shape1),
        cur_sum=zeros(shape1),
        cur_n=0,
    )


def kept_count(n_iters: int, burn_in: int, thin: int) -> int:
    """Kept draws of a fresh run: |{t in [0, n_iters) : t >= burn_in and
    (t - burn_in) % thin == 0}|, the loop's own keep gate, counted."""
    return max((int(n_iters) - burn_in + thin - 1) // thin, 0)


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    """A host count as a 0-dim float32 tensor: a division by it is one
    IEEE float32 division on any device (a Python-float divisor is not,
    on the card)."""
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


def update(q: QualityAccum, onehot: torch.Tensor, keep: bool) -> QualityAccum:
    """Fold one sweep's one-hot indicators ((B, S, V), any numeric dtype)
    into the accumulator.  `keep` is the loop's burn-in/thinning gate; a
    masked-out sweep leaves every statistic as it was.  The float ops are
    the reference's, in its order: delta / n, then delta * (x - mean')."""
    if not keep:
        return q
    x = onehot.to(torch.float32)
    half = int(q.counts[0] + q.counts[1] >= q.split_at)
    counts = list(q.counts)
    counts[half] += 1
    delta = x - q.mean[half]
    mean_h = q.mean[half] + delta / _f32(counts[half], x)
    m2_h = q.m2[half] + delta * (x - mean_h)
    mean, m2 = q.mean.clone(), q.m2.clone()
    mean[half] = mean_h
    m2[half] = m2_h
    # batch-means: accumulate the open batch; fold its mean into the
    # batch-level Welford stats when it fills
    cur_sum = q.cur_sum + x
    cur_n = q.cur_n + 1
    bm_count, bm_mean, bm_m2 = q.bm_count, q.bm_mean, q.bm_m2
    if cur_n >= q.batch_len:
        bmean = cur_sum / _f32(max(q.batch_len, 1), x)
        bm_count += 1
        bdelta = bmean - bm_mean
        bm_mean = bm_mean + bdelta / _f32(bm_count, x)
        bm_m2 = bm_m2 + bdelta * (bmean - bm_mean)
        cur_sum = torch.zeros_like(cur_sum)
        cur_n = 0
    return QualityAccum(
        counts=(counts[0], counts[1]), mean=mean, m2=m2,
        split_at=q.split_at, batch_len=q.batch_len, bm_count=bm_count,
        bm_mean=bm_mean, bm_m2=bm_m2, cur_sum=cur_sum, cur_n=cur_n,
    )


# ---------------------------------------------------------------------------
# host-side summary (the reference's, over numpy copies)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QualitySnapshot:
    """Host-side reduction of a `QualityAccum`: per-node convergence
    diagnostics plus the scalar roll-ups.  `rhat`/`ess` are NaN where
    undefined (a node with no varying value, e.g. clamped evidence, has
    nothing to diagnose); `rhat` is +inf where chains are stuck in disjoint
    modes (zero within-chain variance, nonzero between)."""

    rhat: np.ndarray  # (S,) worst split R-hat over the node's values
    ess: np.ndarray | None  # (S,) total ESS over chains; None if < 2 batches
    p_hat: np.ndarray  # (S, V) pooled streaming marginal estimate
    kept: int
    n_chains: int
    split_at: int
    batch_len: int
    n_batches: int
    rhat_max: float | None
    ess_min: float | None
    overflow_risk: bool
    finite: bool

    def brief(self) -> dict:
        """The scalar row serving metrics carry around."""
        return {
            "rhat_max": self.rhat_max,
            "ess_min": self.ess_min,
            "kept": self.kept,
            "n_chains": self.n_chains,
            "n_batches": self.n_batches,
            "overflow_risk": self.overflow_risk,
            "finite": self.finite,
        }

    def to_dict(self) -> dict:
        d = self.brief()
        d["split_at"] = self.split_at
        d["batch_len"] = self.batch_len
        d["rhat"] = [None if not np.isfinite(r) and not np.isinf(r)
                     else (float(r) if np.isfinite(r) else "inf")
                     for r in self.rhat]
        if self.ess is not None:
            d["ess"] = [None if np.isnan(e) else float(e) for e in self.ess]
        return d


def _combine_welford(na, ma, m2a, nb, mb, m2b):
    """Chan et al. parallel-variance merge of two Welford states."""
    n = na + nb
    safe = np.maximum(n, 1)
    delta = mb - ma
    mean = ma + delta * (nb / safe)
    m2 = m2a + m2b + delta * delta * (na * nb / safe)
    return n, mean, m2


def _host(x, dtype):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def summarize(
    q: QualityAccum,
    cards=None,
    free_mask=None,
    total_kept: int | None = None,
) -> QualitySnapshot:
    """Reduce raw moments to the quality snapshot (host numpy).

    `cards` ((S,) value cardinalities) masks padded value slots out of the
    diagnostics; `free_mask` ((S,) bool) restricts the rhat_max / ess_min
    roll-ups to unclamped nodes.  `total_kept` (the query's whole budget)
    flags an accumulator summarized mid-run as `finite=False` rather than
    silently under-counting."""
    counts = _host(q.counts, np.int64)  # (2,)
    mean = _host(q.mean, np.float64)  # (2, B, S, V)
    m2 = _host(q.m2, np.float64)
    _, n_chains, n_sites, n_values = mean.shape
    kept = int(counts.sum())

    value_ok = np.ones((n_sites, n_values), bool)
    if cards is not None:
        cards = _host(cards, np.int64)
        value_ok = np.arange(n_values)[None, :] < cards[:, None]
    node_ok = np.ones(n_sites, bool)
    if free_mask is not None:
        node_ok = _host(free_mask, bool)

    # ---- split R-hat over the 2B sub-chains -------------------------------
    active = [h for h in (0, 1) if counts[h] >= 2]
    rhat_nv = np.full((n_sites, n_values), np.nan)
    if active:
        n_sub = int(counts[active].min())
        # (M, S, V) sub-chain means and (unbiased) variances
        sub_mean = mean[active].reshape(-1, n_sites, n_values)
        sub_var = (m2[active] / np.maximum(counts[active, None, None, None]
                                           - 1, 1)
                   ).reshape(-1, n_sites, n_values)
        w = sub_var.mean(0)
        b = n_sub * sub_mean.var(0, ddof=1) if sub_mean.shape[0] > 1 else (
            np.zeros_like(w))
        var_plus = (n_sub - 1) / n_sub * w + b / n_sub
        tiny = 1e-12
        varies = (w > tiny) | (b > tiny)
        with np.errstate(divide="ignore", invalid="ignore"):
            r = np.sqrt(var_plus / w)
        # stuck-apart chains: no within variance, real between variance
        r = np.where((w <= tiny) & (b > tiny), np.inf, r)
        rhat_nv = np.where(varies & value_ok, r, np.nan)

    with np.errstate(invalid="ignore"):
        rhat_node = np.full(n_sites, np.nan)
        has = ~np.all(np.isnan(rhat_nv), axis=1)
        rhat_node[has] = np.nanmax(rhat_nv[has], axis=1)

    # ---- batch-means ESS --------------------------------------------------
    bm_count = int(q.bm_count)
    batch_len = int(q.batch_len)
    ess_node = None
    if bm_count >= 2 and kept >= 2:
        var_bm = _host(q.bm_m2, np.float64) / (bm_count - 1)  # (B, S, V)
        # whole-run per-chain variance: merge the two split halves
        _, _, m2c = _combine_welford(
            counts[0], mean[0], m2[0], counts[1], mean[1], m2[1]
        )
        s2 = m2c / max(kept - 1, 1)  # (B, S, V)
        tiny = 1e-12
        with np.errstate(divide="ignore", invalid="ignore"):
            ess = kept * s2 / (batch_len * var_bm)
        ess = np.where(s2 <= tiny, np.nan, np.minimum(ess, kept))
        # anticorrelated-beyond-batch case: zero batch variance with real
        # within variance — every kept draw is effectively independent
        ess = np.where((s2 > tiny) & (var_bm <= tiny), float(kept), ess)
        # sum over chains; a constant (stuck) chain contributes zero
        # effective samples, and the cell is undefined only when *every*
        # chain is constant there
        ess_nv = np.where(np.isnan(ess), 0.0, ess).sum(0)
        ess_nv = np.where(np.isnan(ess).all(0) | ~value_ok, np.nan, ess_nv)
        with np.errstate(invalid="ignore"):
            ess_node = np.full(n_sites, np.nan)
            has = ~np.all(np.isnan(ess_nv), axis=1)
            ess_node[has] = np.nanmin(ess_nv[has], axis=1)

    # ---- pooled marginal estimate -----------------------------------------
    weight = counts[:, None, None, None].astype(np.float64)
    pooled = (mean * weight).sum(0) / max(kept, 1)  # (B, S, V)
    p_hat = np.where(value_ok, pooled.mean(0), 0.0)

    finite = bool(
        np.isfinite(mean).all() and np.isfinite(m2).all()
        and np.isfinite(_host(q.bm_m2, np.float64)).all()
    )
    if total_kept is not None and kept != int(total_kept):
        finite = False
    overflow_risk = kept * n_chains >= _INT32_HEADROOM

    sel = node_ok & ~np.isnan(rhat_node)
    rhat_max = float(np.max(rhat_node[sel])) if sel.any() else None
    ess_min = None
    if ess_node is not None:
        sel = node_ok & ~np.isnan(ess_node)
        ess_min = float(np.min(ess_node[sel])) if sel.any() else None
    return QualitySnapshot(
        rhat=rhat_node,
        ess=ess_node,
        p_hat=p_hat,
        kept=kept,
        n_chains=n_chains,
        split_at=int(q.split_at),
        batch_len=batch_len,
        n_batches=bm_count,
        rhat_max=rhat_max,
        ess_min=ess_min,
        overflow_risk=overflow_risk,
        finite=finite,
    )
