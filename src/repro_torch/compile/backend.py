"""Schedule-direct execution backend, BN half (port of `repro/compile/backend.py`).

The `Schedule` is the execution plan: one CPT-gather tensor set
(`ColorGroup`) per `Round`, built from the round's node list — not from
`cbn.groups` — and swept in schedule order.  A pass that merges or splits
rounds changes execution through this lowering alone.

Bit-exactness with the eager engine is a checked invariant: `cross_check`
runs both on a tiny budget and compares bits the first time a program is
lowered, `cross_check_fused` does the same before the K3 kernel first
serves a program, and `cross_check_clamped` before a runtime-evidence
specialization first serves.

Grid-MRF programs and the sharded engines are later parts of the port
(ROADMAP.md); their entry points raise here.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import prng
from repro_torch.compile.schedule import Schedule, verify_schedule
from repro_torch.core import bayesnet as bnet
from repro_torch.kernels.bn_gibbs import check_fused_sampler
from repro_torch.obs import tracer

MRF_NOT_PORTED = (
    "grid-MRF programs are the next slice of the port (ROADMAP.md, "
    "'Modules still to port', item 6); run them with the reference package"
)


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


def lower_schedule(program, clamp_nodes: tuple[int, ...] = ()) -> BNScheduleExec:
    """Lower a BN `CompiledProgram`'s schedule into per-round gather
    tensors on the program's device, after re-verifying its legality.
    `clamp_nodes` specializes the lowering for a runtime-evidence node set:
    clamped nodes drop out of every round exactly as baked evidence does."""
    ir = program.ir
    schedule: Schedule = program.schedule
    verify_schedule(ir, schedule)
    if ir.kind != "bn":
        raise NotImplementedError(MRF_NOT_PORTED)
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


def bn_rounds_core(
    cbn, round_groups, key, *, n_chains, n_iters, burn_in, sampler, thin=1,
    clamp_vals=None, clamp_mask=None, carry=None, return_state=False,
    fused=False,
):
    """BN round sweep: init (with optional runtime clamps) + the shared
    `gibbs_run_loop`.  A `carry` skips the init and resumes the chain
    exactly; `fused=True` runs each sweep through K3."""
    if carry is None:
        vals, key = bnet.init_chain_values(
            cbn, key, n_chains, clamp_vals=clamp_vals, clamp_mask=clamp_mask
        )
    else:
        vals = None
    return bnet.gibbs_run_loop(
        cbn, round_groups, vals, key, n_iters, burn_in, sampler, thin,
        carry=carry, return_state=return_state, fused=fused,
    )


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
        )


# ---------------------------------------------------------------------------
# Bit-exactness cross-checks between the execution paths
# ---------------------------------------------------------------------------

_CHECK_KEY = 0xA1A  # fixed: the check must be deterministic per program
_CHECK_CHAINS = 2
_CHECK_ITERS = 3


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def cross_check(program, ex=None) -> None:
    """Run the eager engine and the schedule backend on a tiny budget and
    require identical bits (raises `BackendMismatch`)."""
    if program.kind != "bn":
        raise NotImplementedError(MRF_NOT_PORTED)
    ex = lower_schedule(program) if ex is None else ex
    key = prng.key(_CHECK_KEY)
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


def cross_check_fused(
    program, ex, sampler: str = "lut_ky", *, sharded: bool = False,
) -> None:
    """First-use guarantee for the fused kernel path: a tiny fused run must
    match the eager engine bit for bit before K3 ever serves the program
    (the eager side never touches a kernel, so a word-derivation or layout
    drift in `kernels/bn_gibbs.py` is caught here).  Only the single-device
    leg is ported."""
    if sharded:
        raise NotImplementedError(
            "the sharded fused engines are a later slice of the port "
            "(ROADMAP.md, item 11)"
        )
    if program.kind != "bn":
        raise NotImplementedError(MRF_NOT_PORTED)
    key = prng.key(_CHECK_KEY)
    cbn = program.cbn
    eager = bnet.run_gibbs(
        cbn, key, n_chains=_CHECK_CHAINS, n_iters=_CHECK_ITERS, burn_in=0,
        sampler=sampler, device=cbn.device,
    )
    fused = run_bn_schedule(
        ex, key, fused=True, n_chains=_CHECK_CHAINS, n_iters=_CHECK_ITERS,
        burn_in=0, sampler=sampler,
    )
    if not _same(eager, fused):
        raise BackendMismatch(
            f"fused BN rounds diverged from eager on program "
            f"{program.program_key[:12]} (sampler={sampler})"
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
