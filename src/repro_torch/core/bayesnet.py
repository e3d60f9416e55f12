"""Chromatic parallel Gibbs sampling for Bayes nets (paper Alg. 2 + Sec. IV).

Port of `repro/core/bayesnet.py`.  The "compiler" lowers an irregular DAG
into dense, padded per-colour update tensors, and the engine executes one
colour at a time:

  compile time (numpy)                      run time (torch, per colour)
  ----------------------------------------  -------------------------------
  moral graph -> DSATUR colours (C3)        gather CPT entries for all
  per node: Markov-blanket factor list        (chain, node, factor, value)
  factor -> (base, stride, scope) tensors     in one vectorized address calc
  pad to (n_c, F, S) per colour             logp -> LUT-exp weights (C2)
                                            -> rejection-KY draw (C1)
                                            -> scatter into the state vector

The unfused engine (`gibbs_sweep`) is plain torch, as the reference's is
plain XLA; `gibbs_run_loop(fused=True)` runs each sweep as one launch of
the K3 kernel (`kernels/bn_gibbs.py`).  Both consume the same keys in the
same order, so their lut_ky results are bit-identical.

Keys are `prng.Key`s (the reference's jax.random streams, bit for bit),
split once per sweep and once per round.  The loop over sweeps is a Python
loop; the chain state is a `BNChainState` dataclass.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import prng
from repro_torch.core import coloring as coloring_mod
from repro_torch.core.draws import draw_from_logits
from repro_torch.core.graphs import DiscreteBayesNet
from repro_torch.core.interp import LUTSpec, build_exp_weight_lut
from repro_torch.diag import accum as diag_accum

NEG_INF = -1e30


@dataclasses.dataclass
class ColorGroup:
    nodes: torch.Tensor  # (n_c,) int32
    cards: torch.Tensor  # (n_c,) int32
    base: torch.Tensor  # (n_c, F) int32; 0 => padded factor slot
    stride: torch.Tensor  # (n_c, F, S) int32
    scope_var: torch.Tensor  # (n_c, F, S) int32
    is_self: torch.Tensor  # (n_c, F, S) bool


@dataclasses.dataclass
class CompiledBayesNet:
    log_flat: torch.Tensor  # (T,) f32: [0.0] + concat(log cpts)
    groups: list[ColorGroup]
    cards: torch.Tensor  # (n,) int32
    init_vals: torch.Tensor  # (n,) int32 (evidence baked in)
    free_mask: torch.Tensor  # (n,) bool
    max_card: int
    n_nodes: int
    colors: tuple[int, ...]
    exp_table: torch.Tensor  # (lut_size,) f32
    exp_spec: LUTSpec
    name: str = "bn"

    @property
    def device(self) -> torch.device:
        return self.log_flat.device


def cpt_bases(bn: DiscreteBayesNet) -> np.ndarray:
    """Offset of each node's CPT in the flat log-CPT arena (entry 0 is the
    dummy used by padded factor slots)."""
    bases = np.zeros(bn.n_nodes, np.int64)
    off = 1
    for i, cpt in enumerate(bn.cpts):
        bases[i] = off
        off += cpt.size
    return bases


def build_color_group(
    bn: DiscreteBayesNet, free: list[int], bases: np.ndarray | None = None,
    device="cuda",
) -> ColorGroup:
    """Dense CPT-gather tensors for one conditionally-independent node set
    (one colour for `compile_bayesnet`, one schedule round for the
    backend)."""
    if bases is None:
        bases = cpt_bases(bn)

    def factor_slots(fnode: int):
        """(base, stride-per-scope-var, scope vars) for CPT of `fnode`."""
        scope = list(bn.parents[fnode]) + [fnode]
        dims = [int(bn.cards[v]) for v in scope]
        strides = np.ones(len(dims), np.int64)
        for k in range(len(dims) - 2, -1, -1):
            strides[k] = strides[k + 1] * dims[k + 1]
        return bases[fnode], strides, scope

    factor_lists = [[i] + bn.children(i) for i in free]
    f_max = max(len(fl) for fl in factor_lists)
    s_max = max(len(bn.parents[f]) + 1 for fl in factor_lists for f in fl)
    nc = len(free)
    base = np.zeros((nc, f_max), np.int64)
    stride = np.zeros((nc, f_max, s_max), np.int64)
    scope_var = np.zeros((nc, f_max, s_max), np.int64)
    is_self = np.zeros((nc, f_max, s_max), bool)
    for a, (i, fl) in enumerate(zip(free, factor_lists)):
        for b, f in enumerate(fl):
            fb, fs, sc = factor_slots(f)
            base[a, b] = fb
            stride[a, b, : len(sc)] = fs
            scope_var[a, b, : len(sc)] = sc
            is_self[a, b, : len(sc)] = [v == i for v in sc]
    dev = device_mod.resolve(device)

    def i32(x):
        return torch.tensor(np.asarray(x, np.int32), device=dev)

    return ColorGroup(
        nodes=i32(free),
        cards=i32([bn.cards[i] for i in free]),
        base=i32(base),
        stride=i32(stride),
        scope_var=i32(scope_var),
        is_self=torch.tensor(is_self, device=dev),
    )


def build_clamped_groups(
    bn: DiscreteBayesNet,
    node_lists,
    clamp_nodes,
    bases: np.ndarray | None = None,
    device="cuda",
) -> list[ColorGroup]:
    """Rebuild gather groups with a runtime-evidence set removed: clamped
    nodes drop out of every group and all-clamped groups vanish — exactly
    what `compile_bayesnet` does when the same evidence is baked."""
    if bases is None:
        bases = cpt_bases(bn)
    clamp = set(int(v) for v in clamp_nodes)
    out: list[ColorGroup] = []
    for nodes in node_lists:
        free = [int(v) for v in nodes if int(v) not in clamp]
        if free:
            out.append(build_color_group(bn, free, bases, device))
    return out


def compile_bayesnet(
    bn: DiscreteBayesNet,
    evidence: dict[int, int] | None = None,
    lut_size: int = 16,
    lut_range: float = 8.0,
    lut_bits: int = 8,
    seed: int = 0,
    colors: np.ndarray | None = None,
    device="cuda",
) -> CompiledBayesNet:
    """Backend code generation (Fig. 8 right half): per-colour CPT-gather
    tensors on `device`.  Called standalone it runs DSATUR itself."""
    dev = device_mod.resolve(device)
    bn.validate()
    evidence = dict(evidence or {})
    n = bn.n_nodes
    if colors is None:
        colors = coloring_mod.dsatur(bn.moral_adjacency())
    # raised, not asserted: a bad imported coloring is the parallel-Gibbs
    # race condition, and that check must survive `python -O`
    from repro_torch.analysis import verify as verify_mod

    verify_mod.require_proper_coloring(
        bn.moral_adjacency(), colors, loc=f"{bn.name}:compile_bayesnet"
    )

    bases = cpt_bases(bn)
    tables = [np.zeros(1)] + [np.log(cpt.reshape(-1)) for cpt in bn.cpts]
    log_flat = torch.tensor(
        np.concatenate(tables).astype(np.float32), device=dev
    )

    groups: list[ColorGroup] = []
    for group_nodes in coloring_mod.color_groups(colors):
        free = [v for v in group_nodes if v not in evidence]
        if not free:
            continue
        groups.append(build_color_group(bn, free, bases, dev))

    rng = np.random.default_rng(seed)
    init = rng.integers(0, np.asarray(bn.cards), size=n)
    free_mask = np.ones(n, bool)
    for v, x in evidence.items():
        init[v] = x
        free_mask[v] = False

    # integer-weight exp table (paper Sec. III-D: 16 entries, 8-bit values)
    exp_table, exp_spec = build_exp_weight_lut(
        bits=lut_bits, x_min=-lut_range, size=lut_size, device=dev
    )
    return CompiledBayesNet(
        log_flat=log_flat,
        groups=groups,
        cards=torch.tensor(np.asarray(bn.cards, np.int32), device=dev),
        init_vals=torch.tensor(init.astype(np.int32), device=dev),
        free_mask=torch.tensor(free_mask, device=dev),
        max_card=int(np.max(bn.cards)),
        n_nodes=n,
        colors=tuple(int(c) for c in colors),
        exp_table=exp_table,
        exp_spec=exp_spec,
        name=bn.name,
    )


@dataclasses.dataclass
class BNChainState:
    """Everything a BN Gibbs run needs to resume exactly where it stopped:
    the chain values, the key of the next sweep, the marginal histogram so
    far and `t`, the global count of sweeps done, so the burn-in/thinning
    gate stays aligned across slices.  `quality` carries the run's
    `diag.accum.QualityAccum` when it was started with diagnostics on."""

    vals: torch.Tensor  # (B, n) int32 current chain states
    key: prng.Key  # key as of the next sweep
    hist: torch.Tensor  # (n, V) int32 marginal histogram so far
    t: int  # sweeps completed
    quality: diag_accum.QualityAccum | None = None


def group_log_conditionals(
    cbn: CompiledBayesNet, g: ColorGroup, vals: torch.Tensor
) -> torch.Tensor:
    """log P(X_i = v | MB(X_i)) up to a constant, for all chains and all
    nodes of one colour at once.  vals: (B, n) -> (B, n_c, V).

    The F factor log-probs are summed left to right, the order XLA uses on
    the CPU: torch.sum reduces in another order and flips low bits, and a
    flipped weight after round() changes the draw."""
    v_range = torch.arange(cbn.max_card, dtype=torch.int32,
                           device=vals.device)
    sv = vals[:, g.scope_var.long()]  # (B, n_c, F, S)
    val_or_v = torch.where(
        g.is_self[None, ..., None], v_range, sv[..., None]
    )  # (B, n_c, F, S, V)
    addr = g.base[None, :, :, None] + (
        g.stride[None, ..., None] * val_or_v).sum(-2)  # (B, n_c, F, V)
    # lanes v >= card may address past the arena; they are masked below
    addr = addr.clamp(0, cbn.log_flat.shape[0] - 1)
    lp = cbn.log_flat[addr]
    logp = lp[..., 0, :]
    for f in range(1, lp.shape[-2]):
        logp = logp + lp[..., f, :]
    return torch.where(v_range < g.cards[None, :, None], logp,
                       torch.full_like(logp, NEG_INF))


def update_color_group(
    cbn: CompiledBayesNet,
    g: ColorGroup,
    vals: torch.Tensor,
    key: prng.Key,
    sampler: str = "lut_ky",
) -> torch.Tensor:
    logp = group_log_conditionals(cbn, g, vals)
    labels = draw_from_logits(logp, key, sampler, cbn.exp_table, cbn.exp_spec)
    out = vals.clone()
    out[:, g.nodes.long()] = labels
    return out


def gibbs_sweep(
    cbn: CompiledBayesNet,
    vals: torch.Tensor,
    key: prng.Key,
    sampler: str,
    groups: list[ColorGroup] | None = None,
) -> torch.Tensor:
    """One iteration of Alg. 2: loop over rounds, parallel within a round.
    `groups` defaults to the eager colour groups; the schedule backend
    passes its round-ordered groups (same key-split structure either
    way)."""
    groups = cbn.groups if groups is None else groups
    keys = prng.split(key, len(groups))
    for g, k in zip(groups, keys):
        vals = update_color_group(cbn, g, vals, k, sampler)
    return vals


def init_chain_values(
    cbn: CompiledBayesNet,
    key: prng.Key,
    n_chains: int,
    clamp_vals: torch.Tensor | None = None,
    clamp_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, prng.Key]:
    """Per-chain uniform init of the free RVs in [0, card_i), drawn with
    the reference's `jax.random.randint` stream (per-node maxval, no modulo
    fold).  `clamp_vals`/`clamp_mask` ((n,) int32 / (n,) bool) add runtime
    evidence; the random tensor is drawn for every node either way, so a
    runtime-clamped init equals a baked one.  Returns (vals (B, n),
    advanced key)."""
    k0, key = prng.split(key)
    rnd = prng.randint(
        k0, (n_chains, cbn.n_nodes), 0,
        torch.clamp(cbn.cards[None], min=1), cbn.device,
    )
    fixed = cbn.init_vals
    free = cbn.free_mask
    if clamp_mask is not None:
        fixed = torch.where(clamp_mask, clamp_vals, fixed)
        free = free & ~clamp_mask
    vals = torch.where(free[None], rnd, fixed[None])
    return vals, key


def gibbs_run_loop(
    cbn: CompiledBayesNet,
    groups: list[ColorGroup],
    vals: torch.Tensor | None,
    key: prng.Key | None,
    n_iters: int,
    burn_in: int,
    sampler: str,
    thin: int = 1,
    carry: BNChainState | None = None,
    return_state: bool = False,
    fused: bool = False,
    diag_total: int | None = None,
    diag_batch: int = diag_accum.DEFAULT_BATCH_LEN,
    sweep=None,
):
    """The iteration loop shared by the eager engine (`groups=cbn.groups`),
    the schedule-direct backend (`groups` built from the schedule's rounds)
    and the fused sharded engine (`core/distributed.py`).

    `fused=True` runs every sweep as one launch of K3
    (`kernels/bn_gibbs.fused_gibbs_sweep`; its plain twin on the CPU), bit-
    exact with the unfused sweep for lut_ky; other samplers raise.  A
    `sweep` callable ((vals, key) -> vals) runs each sweep instead: the
    sharded engine's, which draws the same words.

    `thin` keeps every thin-th post-burn-in sweep in the histogram.
    `carry` resumes a previous call's `BNChainState` (then `vals`/`key` are
    ignored) and `n_iters` counts additional sweeps; the burn-in/thinning
    gate tests the carried global sweep count, so a run sliced at any
    boundaries equals the uninterrupted run.  `return_state=True` appends
    the state needed to continue.

    `diag_total` (the query's *total* sweep budget, more than this call's
    `n_iters` under slicing) switches the streaming quality accumulator on
    for a fresh run: it takes the same one-hot tensor as the histogram,
    under the same keep gate, and consumes no randomness.  On a resumed
    carry the accumulator (or its absence) rides in with the state."""
    if sweep is None and fused:
        # lazy import: kernels/bn_gibbs imports this module for NEG_INF
        from repro_torch.kernels import bn_gibbs

        bn_gibbs.check_fused_sampler(sampler)
        fr = bn_gibbs.build_fused_rounds(groups)

        def sweep(v, k):
            return bn_gibbs.fused_gibbs_sweep(cbn, fr, v, k, sampler)
    elif sweep is None:
        def sweep(v, k):
            return gibbs_sweep(cbn, v, k, sampler, groups)

    if carry is None:
        quality = None
        if diag_total is not None:
            quality = diag_accum.make_accum(
                vals.shape[0], cbn.n_nodes, cbn.max_card,
                diag_accum.kept_count(diag_total, burn_in, thin), diag_batch,
                cbn.device,
            )
        carry = BNChainState(
            vals=vals,
            key=key,
            hist=torch.zeros((cbn.n_nodes, cbn.max_card), dtype=torch.int32,
                             device=cbn.device),
            t=0,
            quality=quality,
        )
    vals, key, hist, t = carry.vals, carry.key, carry.hist, carry.t
    quality = carry.quality
    v_range = torch.arange(cbn.max_card, dtype=torch.int32,
                           device=cbn.device)
    for _ in range(n_iters):
        key, sub = prng.split(key)
        vals = sweep(vals, sub)
        keep = t >= burn_in and (t - burn_in) % thin == 0
        if keep or quality is not None:
            onehot = vals[..., None] == v_range
        if keep:
            hist = hist + onehot.sum(0, dtype=torch.int32)
        if quality is not None:
            quality = diag_accum.update(quality, onehot, keep)
        t += 1
    carry = BNChainState(vals=vals, key=key, hist=hist, t=t, quality=quality)
    marginals = hist_marginals(cbn, hist)
    if return_state:
        return marginals, vals, carry
    return marginals, vals


def hist_marginals(cbn: CompiledBayesNet, hist: torch.Tensor) -> torch.Tensor:
    """(n, V) int32 histogram -> float32 marginals, 0 beyond each card."""
    v_range = torch.arange(cbn.max_card, dtype=torch.int32,
                           device=cbn.device)
    card_mask = v_range[None] < cbn.cards[:, None]
    denom = torch.clamp(hist.sum(-1, keepdim=True, dtype=torch.int32), min=1)
    return torch.where(
        card_mask, hist.to(torch.float32) / denom.to(torch.float32),
        torch.zeros((), dtype=torch.float32, device=cbn.device),
    )


def run_gibbs(
    cbn: CompiledBayesNet,
    key: prng.Key | None,
    n_chains: int = 32,
    n_iters: int = 200,
    burn_in: int = 50,
    sampler: str = "lut_ky",
    thin: int = 1,
    carry: BNChainState | None = None,
    return_state: bool = False,
    device="cuda",
    diag_total: int | None = None,
    diag_batch: int = diag_accum.DEFAULT_BATCH_LEN,
):
    """Multi-chain chromatic Gibbs on `device`; returns (marginals (n, V),
    final vals (B, n)) [, state].  `cbn` must have been compiled for that
    device (`compile_bayesnet(..., device=...)`).  `diag_total` switches
    the quality accumulator on (see `gibbs_run_loop`)."""
    dev = device_mod.resolve(device)
    if cbn.device != dev:
        raise ValueError(
            f"the net was compiled for {cbn.device}, not {dev}; compile it "
            "with compile_bayesnet(..., device=...)"
        )
    vals = None
    if carry is None:
        vals, key = init_chain_values(cbn, key, n_chains)
    return gibbs_run_loop(
        cbn, cbn.groups, vals, key, n_iters, burn_in, sampler, thin,
        carry=carry, return_state=return_state,
        diag_total=diag_total, diag_batch=diag_batch,
    )
