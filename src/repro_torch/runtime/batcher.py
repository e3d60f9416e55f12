"""Query batching: group posterior queries into buckets and run each bucket
in one pass over its queries (port of `repro/runtime/batcher.py`).

The unit of execution is a *bucket*: every pending query that resolves to
the same compiled program AND the same static execution signature (BN
observed-node set, chain/iteration budget, sampler, backend).  Within a
bucket only per-query *data* varies — evidence values, pin masks,
observation images, PRNG seeds — so the reference runs the whole
microbatch as one `jax.vmap` over one jitted executable.

Here a fused bucket runs the lane-batched loops of `compile.backend`
(`bn_rounds_lanes`, `mrf_rounds_lanes`): the Q queries' chains stacked
into one (Q * B, ...) tensor, one K3 launch per BN sweep or one K4 launch
per MRF half-step for all of them, each query drawing from its own keys.
Unfused buckets (the cdf/gumbel samplers, the eager backend) run their
queries one after another through the single-query loops.  Either way a
query's draws are bit-identical to running it alone, which is what makes
batched serving a pure throughput win, never an answer change.

The reference pads a bucket up to a ladder of sizes (1, 2, 4, ...) so that
XLA's shape cache holds a few shapes per signature; its pad lanes replicate
query 0 and are dropped.  The port has no shape cache to feed and computes
only the real lanes, but it reports the padded size (`n_padded`) exactly as
the reference does, so the metrics and the simulated clock are the same.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.analysis import kernel_lint
from repro_torch.compile import backend as backend_mod
from repro_torch.core import mrf as mrf_mod
from repro_torch.diag import accum as diag_accum
from repro_torch.kernels.bn_gibbs import FUSED_BN_SAMPLERS
from repro_torch.obs import tracer

PAD_SIZES = (1, 2, 4, 8, 16, 32)


def fused_eligible(
    kind: str, sampler: str, backend: str,
    graph=None, n_chains: int | None = None,
) -> bool:
    """Whether a bucket's static signature can route onto the fused
    kernels: schedule backend + a sampler the kernels implement (BN:
    lut_ky/exact_ky; MRF: lut_ky).  Eligibility is decided here — per
    bucket, from statics alone — so an engine with `fused=True` serves
    eligible buckets fused and the rest unfused, instead of rejecting
    mixed traffic the way the single-program `run(fused=True)` API does.

    With `graph` and `n_chains` (the `bucket_key` route supplies both),
    eligibility additionally requires the kernels' blocks to fit Hopper's
    shared memory (`analysis.kernel_lint.fused_fits`): a bucket that does
    not fit is demoted to the unfused route here, bit-exact, instead of
    failing at launch."""
    if backend != "schedule":
        return False
    if kind == "bn":
        if sampler not in FUSED_BN_SAMPLERS:
            return False
    elif sampler != "lut_ky":
        return False
    if graph is not None and n_chains is not None:
        return kernel_lint.fused_fits(graph, n_chains, sampler)
    return True


@dataclasses.dataclass
class Query:
    """One posterior-sampling request against a registered model.

    `carry` is engine-internal: a slice continuation is the same query
    re-entering the arrival queue with its chain state attached and
    `n_iters` counting the *remaining* sweeps — user-submitted queries
    leave it None."""

    qid: int
    model: str
    evidence: dict | None = None  # BN: {node: value} clamps; MRF: pins
    image: np.ndarray | None = None  # MRF observation image (H, W)
    n_chains: int = 8
    n_iters: int = 40
    burn_in: int = 10  # BN marginal accumulation only; ignored for MRF
    thin: int = 1  # BN marginal accumulation only; ignored for MRF
    sampler: str = "lut_ky"
    seed: int = 0
    arrival_s: float = 0.0
    carry: object = None  # chain state of a slice continuation


@dataclasses.dataclass
class QueryResult:
    """What the engine hands back: the posterior payload plus the timeline
    the simulated clock assigned to this query."""

    qid: int
    model: str
    kind: str  # "bn" | "mrf"
    marginals: np.ndarray | None  # BN: (n, V) streaming marginal estimate
    final_state: np.ndarray  # BN: (B, n) vals; MRF: (B, H, W) labels
    arrival_s: float = 0.0
    start_s: float = 0.0
    finish_s: float = 0.0
    batch_size: int = 1
    carry: object = None  # chain state, when the bucket ran return_state
    # diag.accum.QualitySnapshot.brief() of this lane's accumulator, when
    # the bucket ran with diagnostics (intermediate slices carry the
    # snapshot as-of-that-slice; the final slice's is the query's verdict)
    quality: dict | None = None

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """Everything that must be *static* across a microbatch.

    `n_iters` is the sweeps *this dispatch* runs — under slicing that is
    one slice, not the query's whole budget, which is how a long query's
    second slice can share a bucket with another long query that asked for
    a different total.  `resumed` separates fresh buckets (chains
    initialized from seeds) from continuation buckets (carried chain state
    resumed).  `fused` routes the bucket through the fused kernels
    (bit-exact with unfused, but a different calibration signature, since
    its service time differs).  `diagnostics` threads the streaming quality
    accumulator through the bucket — per-lane draw streams stay
    bit-identical either way."""

    program_key: str
    kind: str
    clamp_nodes: tuple[int, ...]  # BN observed-node set; () for MRF
    has_pins: bool  # MRF: whether pin arrays ride along
    n_chains: int
    n_iters: int
    burn_in: int
    thin: int
    sampler: str
    backend: str
    resumed: bool = False
    fused: bool = False
    diagnostics: bool = False


def bucket_key(
    query: Query, graph, backend: str, slice_iters: int | None = None,
    fused: bool = False, diagnostics: bool = False,
) -> BucketKey:
    """The bucket a query lands in, derived without compiling anything
    (`graph` is the model's structure-only IR from engine registration).

    MRF execution has no burn-in/thinning concept (it returns final
    states), so those fields are normalized to 0/1 for MRF queries — both
    to make the "ignored" semantics explicit and so queries differing only
    in dead fields share a bucket instead of splintering microbatches.

    With `slice_iters`, a query whose remaining budget exceeds it lands in
    a bucket that runs exactly one slice; the engine re-enqueues the rest
    as a continuation (`query.carry` set, `n_iters` = what remains).

    `fused=True` (the engine config knob) routes *eligible* buckets onto
    the fused kernels (`fused_eligible`); ineligible buckets keep the
    unfused route — never a silent answer change, since fused and unfused
    are bit-exact for every eligible signature."""
    if graph.kind == "bn":
        clamp = tuple(sorted(int(k) for k in (query.evidence or {})))
        has_pins = False
        burn_in, thin = query.burn_in, query.thin
    else:
        clamp = ()
        has_pins = bool(query.evidence)
        burn_in, thin = 0, 1
    n_iters = query.n_iters
    if slice_iters is not None:
        n_iters = min(n_iters, slice_iters)
    return BucketKey(
        program_key=graph.ir_key,
        kind=graph.kind,
        clamp_nodes=clamp,
        has_pins=has_pins,
        n_chains=query.n_chains,
        n_iters=n_iters,
        burn_in=burn_in,
        thin=thin,
        sampler=query.sampler,
        backend=backend,
        resumed=query.carry is not None,
        fused=fused and fused_eligible(
            graph.kind, query.sampler, backend,
            graph=graph, n_chains=query.n_chains,
        ),
        diagnostics=diagnostics,
    )


def pad_size(n: int, sizes=PAD_SIZES) -> int:
    """Next bucket-ladder size >= n (beyond the ladder, n itself): the
    size the reference pads a bucket to, which the port reports."""
    for s in sizes:
        if n <= s:
            return s
    return n


# ---------------------------------------------------------------------------
# bucket execution
# ---------------------------------------------------------------------------


def execute_bucket(
    program,
    key: BucketKey,
    queries: list[Query],
    pad_sizes=PAD_SIZES,
    return_state: bool = False,
) -> list[QueryResult]:
    """Run one microbatch through its program and unpack per-query results.

    A `resumed` bucket resumes the queries' carried chain states instead
    of seeding fresh chains; `return_state=True` attaches each lane's
    post-run chain state to its `QueryResult.carry`, which is how the
    engine slices long queries (continuous batching).  Both are
    bit-preserving: a lane resumed here equals the same query resumed
    standalone, whatever its batch-mates.

    A `diagnostics` bucket additionally threads the streaming quality
    accumulator through every lane and summarizes it into
    `QueryResult.quality`."""
    n_real = len(queries)
    n_pad = pad_size(n_real, pad_sizes)
    with tracer.span(
        "execute_bucket", cat="batch",
        kind=key.kind, sampler=key.sampler, fused=key.fused,
        diagnostics=key.diagnostics,
        resumed=key.resumed, n_real=n_real, n_padded=n_pad,
        pad_efficiency=round(n_real / n_pad, 6) if n_pad else 0.0,
        n_iters=key.n_iters, n_chains=key.n_chains,
    ):
        run = _bn_bucket if key.kind == "bn" else _mrf_bucket
        return run(program, key, queries, return_state)


def _totals(key: BucketKey, queries: list[Query]) -> list[int] | None:
    """Each lane's accumulator splits at its query's *total* budget — a
    fresh query's n_iters is that total (the engine rewrites n_iters only
    on continuation re-enqueues); resumed lanes carry theirs."""
    if key.diagnostics and not key.resumed:
        return [q.n_iters for q in queries]
    return None


def _quality(state, cards=None, free_mask=None) -> dict:
    return diag_accum.summarize(
        state.quality, cards=cards, free_mask=free_mask
    ).brief()


def _bn_bucket(program, key: BucketKey, queries: list[Query],
               return_state: bool) -> list[QueryResult]:
    dev = program.device
    cbn = program.cbn
    n = program.ir.n_nodes
    ev_mask = np.zeros(n, bool)
    ev_mask[list(key.clamp_nodes)] = True
    ev_vals = np.zeros((len(queries), n), np.int32)
    for i, q in enumerate(queries):
        for node, val in (q.evidence or {}).items():
            ev_vals[i, int(node)] = int(val)
    clamp_vals = torch.tensor(ev_vals, device=dev)
    clamp_mask = torch.tensor(ev_mask, device=dev)
    groups = program.clamped_executable(key.clamp_nodes, key.backend)
    totals = _totals(key, queries)
    carries = [q.carry for q in queries] if key.resumed else None
    kw = dict(n_chains=key.n_chains, n_iters=key.n_iters,
              burn_in=key.burn_in, sampler=key.sampler, thin=key.thin)
    if key.fused:
        # same first-use guarantee the single-program path gets
        program.ensure_fused_cross_check(key.sampler)
        marg, vals, states = backend_mod.bn_rounds_lanes(
            cbn, groups, [prng.key(q.seed) for q in queries],
            clamp_vals=clamp_vals, clamp_mask=clamp_mask, carries=carries,
            diag_totals=totals, **kw,
        )
    else:
        outs = [
            backend_mod.bn_rounds_core(
                cbn, groups, None if key.resumed else prng.key(q.seed),
                clamp_vals=clamp_vals[i], clamp_mask=clamp_mask,
                carry=q.carry, return_state=True, fused=False,
                diag_total=None if totals is None else totals[i], **kw,
            )
            for i, q in enumerate(queries)
        ]
        marg = torch.stack([m for m, _, _ in outs])
        vals = torch.stack([v for _, v, _ in outs])
        states = [s for _, _, s in outs]
    marg, vals = marg.cpu().numpy(), vals.cpu().numpy()
    cards = cbn.cards.cpu().numpy()
    return [
        QueryResult(
            qid=q.qid, model=q.model, kind="bn", marginals=marg[i],
            final_state=vals[i], arrival_s=q.arrival_s,
            batch_size=len(queries),
            carry=states[i] if return_state else None,
            quality=_quality(states[i], cards=cards, free_mask=~ev_mask)
            if key.diagnostics else None,
        )
        for i, q in enumerate(queries)
    ]


def _mrf_bucket(program, key: BucketKey, queries: list[Query],
                return_state: bool) -> list[QueryResult]:
    dev = program.device
    mrf = program.mrf
    imgs = torch.tensor(
        np.stack([np.asarray(q.image, np.int32) for q in queries]),
        device=dev,
    )
    pmask = pvals = None
    if key.has_pins:
        pins = [backend_mod.pin_arrays(mrf, q.evidence or {}, dev)
                for q in queries]
        pmask = torch.stack([m for m, _ in pins])
        pvals = torch.stack([v for _, v in pins])
    if key.fused:
        # same first-use guarantee the single-program path gets
        program.ensure_fused_cross_check(key.sampler)
    totals = _totals(key, queries)
    if key.backend == "schedule":
        parities = program.schedule_executable().parities
    if key.fused:
        labels, states = backend_mod.mrf_rounds_lanes(
            mrf, parities, imgs, [prng.key(q.seed) for q in queries],
            n_chains=key.n_chains, n_iters=key.n_iters, sampler=key.sampler,
            pin_mask=pmask, pin_vals=pvals,
            carries=[q.carry for q in queries] if key.resumed else None,
            diag_totals=totals,
        )
    else:
        outs = []
        for i, q in enumerate(queries):
            kw = dict(
                pin_mask=None if pmask is None else pmask[i],
                pin_vals=None if pvals is None else pvals[i],
                carry=q.carry, return_state=True,
                diag_total=None if totals is None else totals[i],
            )
            seed = None if key.resumed else prng.key(q.seed)
            if key.backend == "schedule":
                outs.append(backend_mod.mrf_rounds_core(
                    mrf, parities, imgs[i], seed, n_chains=key.n_chains,
                    n_iters=key.n_iters, sampler=key.sampler, fused=False,
                    **kw))
            else:
                outs.append(mrf_mod.mrf_gibbs_loop(
                    mrf, imgs[i], seed, key.n_chains, key.n_iters,
                    key.sampler, **kw))
        labels = torch.stack([lab for lab, _ in outs])
        states = [s for _, s in outs]
    labels = labels.cpu().numpy()

    def free(i):
        if pmask is None:
            return None
        return ~pmask[i].cpu().numpy().reshape(-1)

    return [
        QueryResult(
            qid=q.qid, model=q.model, kind="mrf", marginals=None,
            final_state=labels[i], arrival_s=q.arrival_s,
            batch_size=len(queries),
            carry=states[i] if return_state else None,
            quality=_quality(states[i], free_mask=free(i))
            if key.diagnostics else None,
        )
        for i, q in enumerate(queries)
    ]
