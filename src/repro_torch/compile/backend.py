"""Schedule-direct execution backend (port of `repro/compile/backend.py`).

The `Schedule` is the execution plan:

  * BN: one CPT-gather tensor set (`ColorGroup`) per `Round`, built from
    the round's node list — not from `cbn.groups` — and swept in schedule
    order.  A pass that merges or splits rounds changes execution through
    this lowering alone.
  * MRF: each round is recognized as one checkerboard parity and executed
    in schedule order.  The default path is the eager engine's half-step
    (bit-exact for every sampler); `fused=True` routes lut_ky rounds
    through the K4 kernel (`kernels/mrf_gibbs.py`) on the same random
    words, so still bit-identical.

Bit-exactness with the eager engine is a checked invariant: `cross_check`
runs both on a tiny budget and compares bits the first time a program is
lowered, `cross_check_fused` does the same before K3 or K4 first serves a
program, and `cross_check_clamped` before a runtime-evidence
specialization first serves.

`cross_check_fused(sharded=True)` adds the sharded leg: the fused engine
of `core/distributed.py` on a tiny mesh must give the single-device fused
run's bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.compile.schedule import Schedule, verify_schedule
from repro_torch.core import bayesnet as bnet
from repro_torch.core import mrf as mrf_mod
from repro_torch.core.graphs import GridMRF
from repro_torch.core.interp import build_exp_weight_lut
from repro_torch.diag import accum as diag_accum
from repro_torch.kernels import mrf_gibbs as mrf_kernels
from repro_torch.kernels.bn_gibbs import check_fused_sampler
from repro_torch.obs import tracer

class ScheduleLoweringError(RuntimeError):
    """The schedule cannot be lowered to this backend's execution form."""


class BackendMismatch(AssertionError):
    """The schedule backend produced different bits than the eager engine."""


@dataclasses.dataclass
class BNScheduleExec:
    """A BN schedule lowered to per-round gather tensors."""

    cbn: bnet.CompiledBayesNet
    round_groups: list[bnet.ColorGroup]  # one per Round, schedule-ordered
    # runtime-evidence node set the groups were specialized for; () =
    # unclamped lowering
    clamp_nodes: tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class MRFScheduleExec:
    """A grid-MRF schedule lowered to a checkerboard parity sequence."""

    mrf: GridMRF
    parities: tuple[int, ...]  # per-round parity, schedule-ordered
    pinned: tuple[tuple[int, int], ...] = ()  # baked (site, label) pins


def lower_schedule(
    program, clamp_nodes: tuple[int, ...] = ()
) -> BNScheduleExec | MRFScheduleExec:
    """Lower a `CompiledProgram`'s schedule into an executable form, after
    re-verifying its legality.

    BN: per-round gather tensors on the program's device; `clamp_nodes`
    specializes the lowering for a runtime-evidence node set (clamped nodes
    drop out of every round exactly as baked evidence does).  MRF: one
    checkerboard parity per round; pins are runtime arrays, so
    `clamp_nodes` must be empty, and baked pins ride in from the IR."""
    ir = program.ir
    schedule: Schedule = program.schedule
    verify_schedule(ir, schedule)
    if ir.kind == "bn":
        bn = ir.source
        clamp = set(clamp_nodes)
        groups = bnet.build_clamped_groups(
            bn, [r.nodes for r in schedule.rounds], clamp, bnet.cpt_bases(bn),
            program.cbn.device,
        )
        if not groups:
            raise ScheduleLoweringError(
                "runtime evidence clamps every free RV; nothing to sample"
            )
        return BNScheduleExec(
            cbn=program.cbn, round_groups=groups,
            clamp_nodes=tuple(sorted(clamp)),
        )
    if clamp_nodes:
        raise ScheduleLoweringError(
            "MRF pins are runtime arrays (run(pins=...)), not a lowering "
            "specialization"
        )
    mrf = ir.source
    pinned_sites = {node for node, _ in ir.evidence}
    class_size = {
        p: sum(
            (r + c) % 2 == p and (r * mrf.width + c) not in pinned_sites
            for r in range(mrf.height) for c in range(mrf.width)
        )
        for p in (0, 1)
    }
    parities = []
    for r in schedule.rounds:
        pars = {(v // mrf.width + v % mrf.width) % 2 for v in r.nodes}
        if len(pars) != 1:
            raise ScheduleLoweringError(
                f"MRF round {r.color} mixes checkerboard parities {pars}; "
                "the grid path needs single-parity rounds"
            )
        parity = pars.pop()
        if len(r.nodes) != class_size[parity]:
            # the grid path executes whole parity classes (minus baked
            # pins); a round holding only part of one has no lowering here
            # and must fail loudly, not run the wrong plan
            raise ScheduleLoweringError(
                f"MRF round {r.color} covers {len(r.nodes)} of the "
                f"{class_size[parity]} free parity-{parity} sites; partial-"
                "parity rounds are not loweable by the grid backend"
            )
        parities.append(parity)
    return MRFScheduleExec(
        mrf=mrf, parities=tuple(parities), pinned=ir.evidence
    )


def pin_arrays(
    mrf: GridMRF, pinned, device
) -> tuple[torch.Tensor, torch.Tensor]:
    """(site, label) pin pairs -> ((H, W) bool mask, (H, W) int32 values)
    on `device`.  Accepts a dict or an iterable of pairs; values are
    validated against the label alphabet."""
    mask = np.zeros((mrf.height, mrf.width), bool)
    vals = np.zeros((mrf.height, mrf.width), np.int32)
    items = pinned.items() if isinstance(pinned, dict) else pinned
    for site, lab in items:
        site, lab = int(site), int(lab)
        if not (0 <= site < mrf.height * mrf.width and
                0 <= lab < mrf.n_labels):
            raise ValueError(f"pinned pixel {site}={lab} out of range")
        mask[site // mrf.width, site % mrf.width] = True
        vals[site // mrf.width, site % mrf.width] = lab
    return (torch.tensor(mask, device=device),
            torch.tensor(vals, device=device))


def bn_rounds_core(
    cbn, round_groups, key, *, n_chains, n_iters, burn_in, sampler, thin=1,
    clamp_vals=None, clamp_mask=None, carry=None, return_state=False,
    fused=False, diag_total=None, diag_batch=diag_accum.DEFAULT_BATCH_LEN,
):
    """BN round sweep: init (with optional runtime clamps) + the shared
    `gibbs_run_loop`.  A `carry` skips the init and resumes the chain
    exactly; `fused=True` runs each sweep through K3; `diag_total`
    switches the quality accumulator on."""
    if carry is None:
        vals, key = bnet.init_chain_values(
            cbn, key, n_chains, clamp_vals=clamp_vals, clamp_mask=clamp_mask
        )
    else:
        vals = None
    return bnet.gibbs_run_loop(
        cbn, round_groups, vals, key, n_iters, burn_in, sampler, thin,
        carry=carry, return_state=return_state, fused=fused,
        diag_total=diag_total, diag_batch=diag_batch,
    )


# ---------------------------------------------------------------------------
# A serving bucket's queries in one loop: one launch per sweep / half-step
# ---------------------------------------------------------------------------


# iterations whose key splits are made (on the host) and copied to the card
# together; the next chunk's split overlaps the launches queued before it
SPLIT_CHUNK = 8


def _split_chunk(keys: np.ndarray, n: int, num: int, device):
    """The key splits of the next `n` iterations of Q lanes, each
    iteration one `prng.split_many` of every lane's key into `num`:
    returns the (n, num - 1, Q, 2) int32 subkeys on `device` (splits
    1 .. num - 1, each (Q, 2) slice contiguous; the copy does not wait for
    the card) and the (Q, 2) keys after the n-th iteration."""
    subs = np.zeros((n, num - 1) + keys.shape, np.int64)
    for i in range(n):
        ks = prng.split_many(keys, num)
        subs[i] = ks[:, 1:].transpose(1, 0, 2)
        keys = ks[:, 0]
    return prng.key_tensor(subs, device), keys


def bn_rounds_lanes(
    cbn, round_groups, keys, *, n_chains, n_iters, burn_in, sampler,
    thin=1, clamp_vals=None, clamp_mask=None, carries=None,
    diag_totals=None, diag_batch=diag_accum.DEFAULT_BATCH_LEN,
):
    """`bn_rounds_core(fused=True)` for Q queries at once, the serving
    runtime's bucket: each sweep is one batched key split and one launch of
    K3's lane entry (`bn_sweep_lanes`) over the Q * B chains, then one
    (Q, n, V) histogram update.  The splits are made `SPLIT_CHUNK` sweeps
    at a time inside the loop, so the host splits while the card runs the
    sweeps already queued.  Lane q equals `bn_rounds_core` run alone
    with `keys[q]`, `clamp_vals[q]` ((Q, n)) and the shared `clamp_mask`,
    or resumed from `carries[q]`, bit for bit.

    Lanes keep their own sweep count `t`, so a resumed bucket may mix
    lanes at different points of their runs: the burn-in/thinning gate is
    a (Q,) mask per sweep.  `diag_totals` (per lane, fresh buckets) switch
    the quality accumulators on; they are updated lane by lane.  Returns
    (marginals (Q, n, V), vals (Q, B, n), per-lane `BNChainState`s)."""
    from repro_torch.kernels import bn_gibbs

    bn_gibbs.check_fused_sampler(sampler)
    dev = cbn.device
    fr = bn_gibbs.build_fused_rounds(round_groups)
    p = bn_gibbs.sweep_params(cbn, sampler)
    if carries is None:
        lanes = [
            bnet.init_chain_values(
                cbn, k, n_chains,
                clamp_vals=None if clamp_vals is None else clamp_vals[i],
                clamp_mask=clamp_mask)
            for i, k in enumerate(keys)
        ]
        vals = torch.cat([v for v, _ in lanes])
        key_arr = prng.key_array([k for _, k in lanes])
        q = len(lanes)
        hist = torch.zeros((q, cbn.n_nodes, cbn.max_card), dtype=torch.int32,
                           device=dev)
        t0 = np.zeros(q, np.int64)
        quality = [None] * q
        if diag_totals is not None:
            kept = [diag_accum.kept_count(n, burn_in, thin)
                    for n in diag_totals]
            quality = [diag_accum.make_accum(
                n_chains, cbn.n_nodes, cbn.max_card, k, diag_batch, dev)
                for k in kept]
    else:
        q = len(carries)
        vals = torch.cat([c.vals for c in carries])
        key_arr = prng.key_array([c.key for c in carries])
        hist = torch.stack([c.hist for c in carries])
        t0 = np.array([c.t for c in carries], np.int64)
        quality = [c.quality for c in carries]
    b = vals.shape[0] // q
    tt = t0[None] + np.arange(n_iters)[:, None]  # (n_iters, Q)
    keep = (tt >= burn_in) & ((tt - burn_in) % thin == 0)
    keep_dev = torch.from_numpy(keep).to(dev)
    v_range = torch.arange(cbn.max_card, dtype=torch.int32, device=dev)
    track = any(x is not None for x in quality)
    for i in range(n_iters):
        if i % SPLIT_CHUNK == 0:
            subs_dev, key_arr = _split_chunk(
                key_arr, min(SPLIT_CHUNK, n_iters - i), 2, dev)
        vals = bn_gibbs.bn_sweep_lanes(cbn, fr, vals,
                                       subs_dev[i % SPLIT_CHUNK, 0], sampler,
                                       p)
        if keep[i].any() or track:
            onehot = vals.view(q, b, -1)[..., None] == v_range
        if keep[i].all():
            hist = hist + onehot.sum(1, dtype=torch.int32)
        elif keep[i].any():
            hist = hist + torch.where(
                keep_dev[i][:, None, None], onehot.sum(1, dtype=torch.int32),
                torch.zeros((), dtype=torch.int32, device=dev))
        if track:
            quality = [
                None if a is None else diag_accum.update(
                    a, onehot[j], bool(keep[i, j]))
                for j, a in enumerate(quality)
            ]
    marginals = bnet.hist_marginals(cbn, hist)
    vals = vals.view(q, b, -1)
    states = [
        bnet.BNChainState(vals=vals[j], key=k, hist=hist[j],
                          t=int(t0[j]) + n_iters, quality=quality[j])
        for j, k in enumerate(prng.keys_of(key_arr))
    ]
    return marginals, vals, states


def mrf_rounds_lanes(
    mrf, parities, evidence, keys, *, n_chains, n_iters, sampler,
    pin_mask=None, pin_vals=None, carries=None, diag_totals=None,
    diag_batch=diag_accum.DEFAULT_BATCH_LEN,
):
    """`mrf_rounds_core(fused=True)` for Q queries at once: each iteration
    is one batched key split, then per round one launch of K4's lane entry
    (`mrf_half_step_lanes`) over the Q * B chains with each query's
    evidence plane (`evidence`, (Q, H, W) int32) and one masked select
    restoring the pins ((Q, H, W) `pin_mask`/`pin_vals`).  Lane q equals
    `mrf_rounds_core` run alone with `keys[q]`, or resumed from
    `carries[q]`, bit for bit.  `diag_totals` switch the per-lane quality
    accumulators on (updated lane by lane).  Returns (labels (Q, B, H, W),
    per-lane `MRFChainState`s)."""
    mrf_kernels.check_fused_sampler(sampler)
    dev = evidence.device
    exp_table, exp_spec = build_exp_weight_lut(device=dev)
    p = mrf_kernels.half_step_params(mrf)
    if carries is None:
        lanes = [
            mrf_mod.init_labels(
                mrf, k, n_chains,
                None if pin_mask is None else pin_mask[i],
                None if pin_vals is None else pin_vals[i], dev)
            for i, k in enumerate(keys)
        ]
        labels = torch.cat([lab for lab, _ in lanes])
        key_arr = prng.key_array([k for _, k in lanes])
        quality = [None] * len(lanes)
        if diag_totals is not None:
            quality = [diag_accum.make_accum(
                n_chains, mrf.height * mrf.width, mrf.n_labels, n,
                diag_batch, dev) for n in diag_totals]
    else:
        labels = torch.cat([c.labels for c in carries])
        key_arr = prng.key_array([c.key for c in carries])
        quality = [c.quality for c in carries]
    q = len(quality)
    b = labels.shape[0] // q
    for i in range(n_iters):
        if i % SPLIT_CHUNK == 0:
            subs_dev, key_arr = _split_chunk(
                key_arr, min(SPLIT_CHUNK, n_iters - i), 1 + len(parities),
                dev)
        for r, parity in enumerate(parities):
            labels = mrf_kernels.mrf_half_step_lanes(
                mrf, labels, evidence, subs_dev[i % SPLIT_CHUNK, r], parity,
                exp_table, exp_spec, p)
            if pin_mask is not None:
                labels = torch.where(
                    pin_mask[:, None], pin_vals[:, None],
                    labels.view(q, b, mrf.height, mrf.width),
                ).view(q * b, mrf.height, mrf.width)
        if any(a is not None for a in quality):
            quality = [
                None if a is None else diag_accum.update(
                    a, mrf_mod.site_onehot(labels[j * b:(j + 1) * b],
                                           mrf.n_labels), True)
                for j, a in enumerate(quality)
            ]
    labels = labels.view(q, b, mrf.height, mrf.width)
    states = [
        mrf_mod.MRFChainState(labels=labels[j], key=k, quality=quality[j])
        for j, k in enumerate(prng.keys_of(key_arr))
    ]
    return labels, states


def run_bn_schedule(
    ex: BNScheduleExec,
    key: prng.Key | None,
    *,
    clamp_vals: torch.Tensor | None = None,
    clamp_mask: torch.Tensor | None = None,
    **kwargs,
):
    """Execute a lowered BN schedule; same contract as `bayesnet.run_gibbs`
    (returns (marginals (n, V), final vals))."""
    return bn_run_clamped(
        ex.cbn, ex.round_groups, clamp_vals, clamp_mask, key, **kwargs
    )


def bn_run_clamped(
    cbn,
    round_groups,
    clamp_vals: torch.Tensor | None,
    clamp_mask: torch.Tensor | None,
    key: prng.Key | None,
    *,
    n_chains: int = 32,
    n_iters: int = 200,
    burn_in: int = 50,
    sampler: str = "lut_ky",
    thin: int = 1,
    carry=None,
    return_state: bool = False,
    fused: bool = False,
    diag_total: int | None = None,
    diag_batch: int = diag_accum.DEFAULT_BATCH_LEN,
):
    """Execute an already-specialized clamped grouping with per-query
    evidence values; same contract as `bayesnet.run_gibbs`.  `fused=True`
    drives the sweeps through K3 (lut_ky/exact_ky only)."""
    if fused:
        check_fused_sampler(sampler)
    with tracer.span(
        "bn_rounds", cat="kernel", sampler=sampler, fused=fused,
        n_chains=n_chains, n_iters=n_iters, n_rounds=len(round_groups),
        resumed=carry is not None,
    ):
        return bn_rounds_core(
            cbn, round_groups, key, n_chains=n_chains, n_iters=n_iters,
            burn_in=burn_in, sampler=sampler, thin=thin,
            clamp_vals=clamp_vals, clamp_mask=clamp_mask,
            carry=carry, return_state=return_state, fused=fused,
            diag_total=diag_total, diag_batch=diag_batch,
        )


# ---------------------------------------------------------------------------
# MRF: schedule-ordered rounds, optionally fused through K4
# ---------------------------------------------------------------------------


def mrf_rounds_core(
    mrf, parities, evidence, key, *, n_chains, n_iters, sampler, fused,
    pin_mask=None, pin_vals=None, carry=None, return_state=False,
    diag_total=None, diag_batch=diag_accum.DEFAULT_BATCH_LEN, step=None,
):
    """Schedule-ordered MRF sweep on evidence's device.  Each iteration
    splits its key into 1 + len(parities) and runs the rounds in order.
    K4 computes the whole parity update and pinned sites are restored
    afterwards, which matches the unfused path's masked select bit for bit
    because pinned sites always hold their pinned value going in.  A `step`
    callable ((labels, key, parity) -> labels) runs each fused round
    instead of K4: the sharded engine's, on the same words.

    A `carry` (`mrf.MRFChainState`) skips the init and resumes the chain
    exactly: the per-iteration key split is the carry itself."""
    dev = evidence.device
    exp_table, exp_spec = build_exp_weight_lut(device=dev)
    if carry is None:
        labels, key = mrf_mod.init_labels(
            mrf, key, n_chains, pin_mask, pin_vals, dev
        )
        quality = None
        if diag_total is not None:
            quality = diag_accum.make_accum(
                n_chains, mrf.height * mrf.width, mrf.n_labels, diag_total,
                diag_batch, dev,
            )
    else:
        labels, key, quality = carry.labels, carry.key, carry.quality

    for _ in range(n_iters):
        ks = prng.split(key, 1 + len(parities))
        for i, parity in enumerate(parities):
            if step is not None:
                labels = step(labels, ks[1 + i], parity)
            elif fused:
                labels = mrf_kernels.mrf_round_step(
                    mrf, labels, evidence, ks[1 + i], parity, exp_table,
                    exp_spec,
                )
                if pin_mask is not None:
                    labels = torch.where(pin_mask[None], pin_vals[None],
                                         labels)
            else:
                labels = mrf_mod.half_step(
                    mrf, labels, evidence, ks[1 + i], parity, sampler,
                    exp_table, exp_spec, pin_mask,
                )
        if quality is not None:
            quality = diag_accum.update(
                quality, mrf_mod.site_onehot(labels, mrf.n_labels), True)
        key = ks[0]
    if return_state:
        return labels, mrf_mod.MRFChainState(
            labels=labels, key=key, quality=quality
        )
    return labels


def run_mrf_schedule(
    ex: MRFScheduleExec,
    evidence: torch.Tensor,
    key: prng.Key | None,
    *,
    n_chains: int = 32,
    n_iters: int = 200,
    sampler: str = "lut_ky",
    fused: bool = False,
    pin_mask: torch.Tensor | None = None,
    pin_vals: torch.Tensor | None = None,
    carry=None,
    return_state: bool = False,
    diag_total: int | None = None,
    diag_batch: int = diag_accum.DEFAULT_BATCH_LEN,
):
    """Execute a lowered MRF schedule on evidence's device; same contract
    as `mrf.run_mrf_gibbs` (returns final labels (B, H, W)).

    `fused=True` drives the rounds through K4 (lut_ky only).  Pins come
    from either the lowering (baked into the IR) or the caller (runtime
    queries); `program.run()` guarantees they never both apply.
    `carry`/`return_state` slice the run: see `mrf_rounds_core`."""
    if fused:
        mrf_kernels.check_fused_sampler(sampler)
    if pin_mask is None and ex.pinned:
        pin_mask, pin_vals = pin_arrays(ex.mrf, ex.pinned, evidence.device)
    with tracer.span(
        "mrf_rounds", cat="kernel", sampler=sampler, fused=fused,
        n_chains=n_chains, n_iters=n_iters, n_rounds=len(ex.parities),
        resumed=carry is not None, pinned=pin_mask is not None,
    ):
        return mrf_rounds_core(
            ex.mrf, ex.parities, evidence, key, n_chains=n_chains,
            n_iters=n_iters, sampler=sampler, fused=fused,
            pin_mask=pin_mask, pin_vals=pin_vals, carry=carry,
            return_state=return_state, diag_total=diag_total,
            diag_batch=diag_batch,
        )


# ---------------------------------------------------------------------------
# Bit-exactness cross-checks between the execution paths
# ---------------------------------------------------------------------------

_CHECK_KEY = 0xA1A  # fixed: the check must be deterministic per program
_CHECK_CHAINS = 2
_CHECK_ITERS = 3


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _mrf_check_inputs(program):
    """Zero evidence and the program's baked pins (which bind the eager
    side too), on the program's device."""
    mrf = program.mrf
    ev = torch.zeros((mrf.height, mrf.width), dtype=torch.int32,
                     device=program.device)
    pin_mask = pin_vals = None
    if program.ir.evidence:
        pin_mask, pin_vals = pin_arrays(mrf, program.ir.evidence,
                                        program.device)
    return ev, pin_mask, pin_vals


def cross_check(program, ex=None) -> None:
    """Run the eager engine and the schedule backend on a tiny budget and
    require identical bits (raises `BackendMismatch`)."""
    ex = lower_schedule(program) if ex is None else ex
    key = prng.key(_CHECK_KEY)
    if program.kind == "mrf":
        ev, pin_mask, pin_vals = _mrf_check_inputs(program)
        lab_e = mrf_mod.run_mrf_gibbs(
            program.mrf, ev, key, n_chains=_CHECK_CHAINS,
            n_iters=_CHECK_ITERS, pin_mask=pin_mask, pin_vals=pin_vals,
            device=program.device,
        )
        lab_s = run_mrf_schedule(
            ex, ev, key, n_chains=_CHECK_CHAINS, n_iters=_CHECK_ITERS,
        )
        if not torch.equal(lab_e, lab_s):
            raise BackendMismatch(
                f"schedule backend diverged from eager on program "
                f"{program.program_key[:12]} ({program.kind})"
            )
        return
    cbn = program.cbn
    eager = bnet.run_gibbs(
        cbn, key, n_chains=_CHECK_CHAINS, n_iters=_CHECK_ITERS, burn_in=0,
        device=cbn.device,
    )
    sched = run_bn_schedule(
        ex, key, n_chains=_CHECK_CHAINS, n_iters=_CHECK_ITERS, burn_in=0,
    )
    if not _same(eager, sched):
        raise BackendMismatch(
            f"schedule backend diverged from eager on program "
            f"{program.program_key[:12]} ({program.kind})"
        )


def _check_mesh(program):
    """The mesh of the sharded cross-check leg: (1, 2) on the program's
    device (both positions on one device, so the check crosses a shard
    boundary even on one card), or (1, 1) for an MRF of odd height, which
    two row slabs cannot split.  The reference takes the widest legal
    split over the host's devices instead."""
    from repro_torch.core import distributed as dist_mod

    w = 2
    if program.kind == "mrf" and program.mrf.height % 2:
        w = 1
    return dist_mod.make_mesh((1, w), ("data", "model"), program.device)


def cross_check_fused(
    program, ex, sampler: str = "lut_ky", *, sharded: bool = False,
) -> None:
    """First-use guarantee for the fused kernel path: a tiny fused run must
    match the eager engine bit for bit before K3 or K4 ever serves the
    program (the eager side never touches a kernel, so a word-derivation or
    layout drift in `kernels/bn_gibbs.py` or `kernels/mrf_gibbs.py` is
    caught here).

    `sharded=True` also runs the fused sharded engine
    (`core/distributed.py`, K5 / K6) on a tiny mesh (`_check_mesh`) and
    requires the single-device fused run's bits, and so eager's."""
    key = prng.key(_CHECK_KEY)
    kwargs = dict(n_chains=_CHECK_CHAINS, n_iters=_CHECK_ITERS,
                  sampler=sampler)
    if program.kind == "mrf":
        ev, pin_mask, pin_vals = _mrf_check_inputs(program)
        lab_e = mrf_mod.run_mrf_gibbs(
            program.mrf, ev, key, pin_mask=pin_mask, pin_vals=pin_vals,
            device=program.device, **kwargs,
        )
        lab_f = run_mrf_schedule(ex, ev, key, fused=True, **kwargs)
        if not torch.equal(lab_e, lab_f):
            raise BackendMismatch(
                f"fused MRF rounds diverged from eager on program "
                f"{program.program_key[:12]} (sampler={sampler})"
            )
        if sharded:
            from repro_torch.core import distributed as dist_mod

            lab_s = dist_mod.run_program_sharded(
                program, key, _check_mesh(program), evidence=ev,
                backend="schedule", fused=True, **kwargs,
            )
            if not torch.equal(lab_s, lab_f):
                raise BackendMismatch(
                    f"sharded fused MRF rounds diverged from single-device "
                    f"fused on program {program.program_key[:12]} "
                    f"(sampler={sampler})"
                )
        return
    cbn = program.cbn
    eager = bnet.run_gibbs(cbn, key, burn_in=0, device=cbn.device, **kwargs)
    fused = run_bn_schedule(ex, key, fused=True, burn_in=0, **kwargs)
    if not _same(eager, fused):
        raise BackendMismatch(
            f"fused BN rounds diverged from eager on program "
            f"{program.program_key[:12]} (sampler={sampler})"
        )
    if sharded:
        from repro_torch.core import distributed as dist_mod

        shard = dist_mod.run_program_sharded(
            program, key, _check_mesh(program), burn_in=0,
            backend="schedule", fused=True, **kwargs,
        )
        if not _same(shard, fused):
            raise BackendMismatch(
                f"sharded fused BN rounds diverged from single-device "
                f"fused on program {program.program_key[:12]} "
                f"(sampler={sampler})"
            )


def cross_check_clamped(program, ex: BNScheduleExec) -> None:
    """The clamped-lowering counterpart of `cross_check`: both backends run
    a tiny clamped budget (every clamped node observed at value 0) and must
    agree bit for bit.  The eager side rebuilds its groups from
    `cbn.groups`, independently of the schedule lowering."""
    bn = program.ir.source
    cbn = program.cbn
    clamp = ex.clamp_nodes
    clamp_vals = torch.zeros(bn.n_nodes, dtype=torch.int32,
                             device=cbn.device)
    clamp_mask = torch.zeros(bn.n_nodes, dtype=torch.bool, device=cbn.device)
    clamp_mask[list(clamp)] = True
    key = prng.key(_CHECK_KEY)
    eager_groups = bnet.build_clamped_groups(
        bn, [g.nodes.cpu().numpy() for g in cbn.groups], clamp,
        device=cbn.device,
    )
    kwargs = dict(
        n_chains=_CHECK_CHAINS, n_iters=_CHECK_ITERS, burn_in=0,
        sampler="lut_ky", thin=1,
    )
    eager = bn_rounds_core(
        cbn, eager_groups, key, clamp_vals=clamp_vals, clamp_mask=clamp_mask,
        **kwargs,
    )
    sched = run_bn_schedule(
        ex, key, clamp_vals=clamp_vals, clamp_mask=clamp_mask, **kwargs
    )
    if not _same(eager, sched):
        raise BackendMismatch(
            f"clamped schedule backend diverged from eager on program "
            f"{program.program_key[:12]} (clamp={clamp})"
        )
