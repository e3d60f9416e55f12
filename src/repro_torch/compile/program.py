"""`CompiledProgram` — the executable artifact of the compile chain
(port of `repro/compile/program.py`).

One object carries the canonical IR (and its content hash), the placement
and round schedule the passes chose, the per-colour CPT-gather tensors on
the program's device (BN), and diagnostics.  `run()` executes a Bayes net
or a grid MRF on that device.

`compile_graph()` is the entry point and fronts an LRU program cache keyed
by `(ir_key, mesh_shape, pipeline, device)`: a serving workload that
re-submits the same model pays the pass pipeline once.

Programs compiled from a runtime-evidence IR (`evidence_mode="runtime"`)
accept per-query observations at `run(evidence={node: value})`; the
lowering is specialized per observed-node set and cached on the program,
the values stay runtime inputs, and the result is bit-exact with baking
the same observations.  MRF programs take the evidence image and
optional pixel pins at `run()`.

`run_sharded()` executes across a `core.distributed.Mesh` of positions on
the program's device: the fused route runs one K5 / K6 launch per round
over every position and is bit-exact with `run(fused=True)`, the legacy
route folds keys per position.

While profiling is on (`obs.profile`), an unsliced schedule run records
its static cost and roofline under its `program_signature` before it runs.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import prng
from repro_torch.analysis import Finding
from repro_torch.analysis import verify as verify_mod
from repro_torch.compile import backend as backend_mod
from repro_torch.compile import ir as ir_mod
from repro_torch.compile import passes as passes_mod
from repro_torch.compile.schedule import Schedule
from repro_torch.core import bayesnet as bnet
from repro_torch.core import distributed as dist_mod
from repro_torch.core import mrf as mrf_mod
from repro_torch.core.graphs import DiscreteBayesNet, GridMRF
from repro_torch.core.mapping import MeshPlacement
from repro_torch.diag import accum as diag_accum
from repro_torch.kernels import mrf_gibbs as mrf_kernels
from repro_torch.obs import profile as profile_mod
from repro_torch.obs import tracer


def _fused_tag(sampler: str, sharded: bool):
    return (sampler, "sharded") if sharded else sampler


@dataclasses.dataclass
class CompiledProgram:
    ir: ir_mod.SamplingGraph
    placement: MeshPlacement
    schedule: Schedule
    diagnostics: dict
    device: torch.device
    cbn: bnet.CompiledBayesNet | None = None  # BN backend artifact
    compile_s: float = 0.0
    # lazily lowered + cross-checked schedule-direct executable
    _schedule_exec: object = dataclasses.field(default=None, repr=False)
    # runtime-evidence specializations, keyed by (clamp node set, backend)
    _clamp_execs: dict = dataclasses.field(default_factory=dict, repr=False)
    # how many clamped lowerings were built (serving metric: "recompiles")
    clamp_lowerings: int = 0
    # samplers whose fused kernel path passed the first-use cross-check
    _fused_checked: set = dataclasses.field(default_factory=set, repr=False)

    @property
    def program_key(self) -> str:
        return self.ir.ir_key

    @property
    def kind(self) -> str:
        return self.ir.kind

    @property
    def mrf(self) -> GridMRF:
        if self.kind != "mrf":
            raise TypeError(f"program compiled for kind={self.kind!r}")
        return self.ir.source

    def schedule_executable(self):
        """The schedule lowered for direct execution (cached per program).
        The first lowering runs the backend cross-check: a tiny run of both
        backends must agree bit for bit before the schedule backend is ever
        trusted with real work."""
        if self._schedule_exec is None:
            with tracer.span(
                "lower_schedule", cat="compile", program=self.program_key,
                kind=self.kind, n_rounds=len(self.schedule.rounds),
            ):
                ex = backend_mod.lower_schedule(self)
            with tracer.span(
                "cross_check", cat="compile", program=self.program_key,
                kind=self.kind,
            ):
                backend_mod.cross_check(self, ex)
            self._schedule_exec = ex
        return self._schedule_exec

    def fused_check_pending(self, sampler: str, *,
                            sharded: bool = False) -> bool:
        """Whether the first fused use with `sampler` (on the sharded
        route: `sharded=True`) still has its cross-check to run."""
        return _fused_tag(sampler, sharded) not in self._fused_checked

    def ensure_fused_cross_check(
        self, sampler: str, *, sharded: bool = False
    ) -> None:
        """First-use gate for the fused kernel path: a tiny fused run must
        match the eager engine bit for bit before `fused=True` ever serves
        this program with this sampler.  `sharded=True` extends it to the
        sharded engines (their bits must match the single-device fused
        run's too) and is checked at first sharded use.  Cached per
        (sampler, route)."""
        tag = _fused_tag(sampler, sharded)
        if tag in self._fused_checked:
            return
        with tracer.span(
            "cross_check_fused", cat="compile", program=self.program_key,
            sampler=sampler, sharded=sharded,
        ):
            backend_mod.cross_check_fused(
                self, self.schedule_executable(), sampler, sharded=sharded,
            )
        self._fused_checked.add(tag)

    def clamped_executable(self, clamp_nodes: tuple[int, ...], backend: str):
        """Round-ordered gather groups specialized for a runtime-evidence
        node set (cached per (set, backend) on the program).  The node set
        fixes the gather-tensor shapes; the observed values stay runtime
        inputs.  The schedule backend cross-checks its first lowering
        against an independently derived eager grouping."""
        key = (clamp_nodes, backend)
        groups = self._clamp_execs.get(key)
        if groups is None:
            with tracer.span(
                "clamp_lowering", cat="compile", program=self.program_key,
                n_clamped=len(set(clamp_nodes)), backend=backend,
            ):
                groups = self._build_clamped(clamp_nodes, backend)
            self._clamp_execs[key] = groups
            self.clamp_lowerings += 1
        return groups

    def _build_clamped(self, clamp_nodes: tuple[int, ...], backend: str):
        if len(set(clamp_nodes)) >= self.ir.n_nodes:
            raise ValueError(
                "runtime evidence clamps every free RV; nothing to sample"
            )
        if backend == "schedule":
            ex = backend_mod.lower_schedule(self, clamp_nodes)
            backend_mod.cross_check_clamped(self, ex)
            return ex.round_groups
        groups = bnet.build_clamped_groups(
            self.ir.source,
            [g.nodes.cpu().numpy() for g in self.cbn.groups],
            clamp_nodes, device=self.device,
        )
        if not groups:
            raise ValueError(
                "runtime evidence clamps every free RV; nothing to sample"
            )
        return groups

    def _bn_clamp_arrays(self, evidence: dict):
        """Validate a runtime-evidence dict -> (nodes, vals (n,), mask (n,))."""
        if self.ir.evidence_mode != "runtime":
            raise ValueError(
                "BN evidence is baked into this program at compile time; "
                "per-query evidence needs a structure-only IR "
                "(ir.canonicalize(bn, evidence_mode='runtime'))"
            )
        if not isinstance(evidence, dict):
            raise TypeError("BN runtime evidence is a {node: value} dict")
        n = self.ir.n_nodes
        vals = np.zeros(n, np.int32)
        mask = np.zeros(n, bool)
        for node, val in evidence.items():
            node, val = int(node), int(val)
            if not (0 <= node < n and 0 <= val < self.ir.cards[node]):
                raise ValueError(f"evidence {node}={val} out of range")
            vals[node] = val
            mask[node] = True
        nodes = tuple(sorted(int(k) for k in evidence))
        return (nodes, torch.tensor(vals, device=self.device),
                torch.tensor(mask, device=self.device))

    def _summarize_quality(self, state, free_mask=None, total_kept=None):
        """Host-side reduction of a run's quality accumulator ->
        `diag.accum.QualitySnapshot` (clamped nodes or pinned pixels
        masked out of the R-hat/ESS roll-ups via `free_mask`)."""
        if state.quality is None:
            raise ValueError(
                "chain state carries no quality accumulator; resume a run "
                "that was started with diagnostics=True"
            )
        cards = self.cbn.cards.cpu().numpy() if self.kind == "bn" else None
        return diag_accum.summarize(
            state.quality, cards=cards, free_mask=free_mask,
            total_kept=total_kept,
        )

    def run(
        self,
        key: prng.Key | None,
        *,
        n_chains: int = 32,
        n_iters: int = 200,
        burn_in: int | None = None,
        thin: int = 1,
        sampler: str = "lut_ky",
        evidence=None,
        pins=None,
        backend: str = "schedule",
        fused: bool = False,
        carry_state=None,
        return_state: bool = False,
        diagnostics: bool = False,
        device="cuda",
    ):
        """Execute on `device`, which must be the device the program was
        compiled for.

        BN: returns (marginals (n, V), final vals (B, n)); `burn_in`
        defaults to 50 and `thin` keeps every thin-th post-burn-in sweep.
        On a runtime-evidence program, `evidence={node: value}` clamps per
        query, bit-exact with baking the same dict.  MRF: `evidence` is the
        runtime (H, W) observation image; returns final labels (B, H, W)
        and has no burn-in or thinning (passing one raises).  `pins=
        {site: label}` (or a ((H, W) bool, (H, W) int32) pair of tensors)
        clamps pixels per query on a runtime-mode MRF program, bit-exact
        with baking them through `ir.from_mrf(mrf, pinned=...)`.

        `backend="schedule"` (the default) executes the schedule's rounds;
        "eager" runs the engines directly.  `fused=True` routes the
        schedule rounds through the kernels: K3, one launch per BN sweep
        (lut_ky/exact_ky), or K4, one launch per MRF half-step (lut_ky).
        The first fused use per sampler runs a tiny eager cross-check.

        `return_state=True` appends the chain state (`bayesnet.BNChainState`
        / `mrf.MRFChainState`); passing it back as `carry_state=` resumes
        the run for `n_iters` more sweeps (then `key` may be None).  A run
        sliced at any boundaries equals the uninterrupted run, given the
        same burn_in, thin, sampler, backend and evidence/pins per slice.

        `diagnostics=True` threads the streaming quality accumulator
        (`diag.accum`) through the run and appends a `QualitySnapshot`
        before the state: BN runs return (marginals, vals, snapshot
        [, state]), MRF runs (labels, snapshot[, state]).  It consumes no
        randomness, so the draws equal those with diagnostics off.  A
        resumed run with diagnostics needs a carry that has the
        accumulator."""
        dev = device_mod.resolve(device)
        if dev != self.device:
            raise ValueError(
                f"this program was compiled for {self.device}, not {dev}; "
                "compile it with compile_graph(..., device=...)"
            )
        if backend not in ("eager", "schedule"):
            raise ValueError(f"unknown backend {backend!r}")
        if fused and backend != "schedule":
            raise ValueError("fused execution requires backend='schedule'")
        if thin < 1:
            raise ValueError(f"thin must be >= 1, got {thin}")
        if carry_state is None and key is None:
            raise ValueError("a fresh run (carry_state=None) needs a PRNG key")
        diag_total = None
        if diagnostics:
            if carry_state is None:
                # the accumulator's split point is fixed from this call's
                # full budget; resumed slices ignore diag_total
                diag_total = n_iters
            elif getattr(carry_state, "quality", None) is None:
                raise ValueError(
                    "diagnostics=True on a resumed run needs a carry from a "
                    "run that was itself started with diagnostics=True (the "
                    "accumulator lives in the chain state)"
                )
        branch = self._run_bn if self.kind == "bn" else self._run_mrf
        out, free_mask, total_kept = branch(
            key, n_chains=n_chains, n_iters=n_iters, burn_in=burn_in,
            thin=thin, sampler=sampler, evidence=evidence, pins=pins,
            backend=backend, fused=fused, carry_state=carry_state,
            return_state=return_state or diagnostics, diag_total=diag_total,
        )
        if not diagnostics:
            return out
        *results, state = out
        snap = self._summarize_quality(
            state, free_mask=free_mask,
            total_kept=total_kept if carry_state is None else None,
        )
        return (*results, snap, state) if return_state else (*results, snap)

    def _run_bn(
        self, key, *, n_chains, n_iters, burn_in, thin, sampler, evidence,
        pins, backend, fused, carry_state, return_state, diag_total,
    ):
        """The BN branch of `run`: (output, free_mask, kept draws)."""
        if carry_state is not None and not isinstance(
            carry_state, bnet.BNChainState
        ):
            raise TypeError(
                "BN programs resume from a bayesnet.BNChainState, got "
                f"{type(carry_state).__name__}"
            )
        if pins is not None:
            raise ValueError(
                "pins are an MRF concept; BN observations go through "
                "evidence={node: value}"
            )
        if fused:
            backend_mod.check_fused_sampler(sampler)
        burn_in = 50 if burn_in is None else burn_in
        if (profile_mod.enabled() and evidence is None
                and backend == "schedule" and carry_state is None
                and diag_total is None):
            profile_mod.capture_program(
                self, n_chains=n_chains, n_iters=n_iters, burn_in=burn_in,
                thin=thin, sampler=sampler, fused=fused,
            )
        if fused:
            self.ensure_fused_cross_check(sampler)
        kw = dict(n_chains=n_chains, n_iters=n_iters, burn_in=burn_in,
                  sampler=sampler, thin=thin, carry=carry_state,
                  return_state=return_state, diag_total=diag_total)
        free_mask = None
        if evidence is not None:
            nodes, ev_vals, ev_mask = self._bn_clamp_arrays(evidence)
            free_mask = ~ev_mask.cpu().numpy()
            groups = self.clamped_executable(nodes, backend)
            out = backend_mod.bn_run_clamped(
                self.cbn, groups, ev_vals, ev_mask, key, fused=fused, **kw)
        elif backend == "schedule":
            out = backend_mod.run_bn_schedule(
                self.schedule_executable(), key, fused=fused, **kw)
        else:
            out = bnet.run_gibbs(self.cbn, key, device=self.device, **kw)
        return out, free_mask, diag_accum.kept_count(n_iters, burn_in, thin)

    def _run_mrf(
        self, key, *, n_chains, n_iters, burn_in, thin, sampler, evidence,
        pins, backend, fused, carry_state, return_state, diag_total,
    ):
        """The MRF branch of `run`: (output, free_mask, kept draws)."""
        if carry_state is not None and not isinstance(
            carry_state, mrf_mod.MRFChainState
        ):
            raise TypeError(
                "MRF programs resume from an mrf.MRFChainState, got "
                f"{type(carry_state).__name__}"
            )
        if evidence is None:
            raise ValueError("MRF programs take the evidence image at run()")
        if burn_in is not None:
            raise ValueError(
                "MRF programs return final states only; burn_in does not apply"
            )
        if thin != 1:
            raise ValueError(
                "MRF programs return final states only; thin does not apply"
            )
        mrf = self.mrf
        evidence = torch.as_tensor(evidence, dtype=torch.int32,
                                   device=self.device)
        if tuple(evidence.shape) != (mrf.height, mrf.width):
            raise ValueError(
                f"evidence image is {tuple(evidence.shape)}, the grid is "
                f"{(mrf.height, mrf.width)}"
            )
        pin_mask = pin_vals = None
        if pins is not None:
            if self.ir.evidence_mode != "runtime":
                raise ValueError(
                    "this program bakes its pinned pixels at compile time "
                    "(ir.from_mrf(mrf, pinned=...)); per-query pins need a "
                    "runtime-mode IR"
                )
            if isinstance(pins, dict):
                pin_mask, pin_vals = backend_mod.pin_arrays(
                    mrf, pins, self.device)
            else:
                pin_mask, pin_vals = pins
        elif self.ir.evidence:
            pin_mask, pin_vals = backend_mod.pin_arrays(
                mrf, self.ir.evidence, self.device)
        kw = dict(n_chains=n_chains, n_iters=n_iters, sampler=sampler,
                  pin_mask=pin_mask, pin_vals=pin_vals, carry=carry_state,
                  return_state=return_state, diag_total=diag_total)
        if backend == "schedule":
            if fused:
                mrf_kernels.check_fused_sampler(sampler)
            if (profile_mod.enabled() and carry_state is None
                    and diag_total is None and pin_mask is None):
                profile_mod.capture_program(
                    self, n_chains=n_chains, n_iters=n_iters,
                    sampler=sampler, fused=fused,
                )
            if fused:
                self.ensure_fused_cross_check(sampler)
            out = backend_mod.run_mrf_schedule(
                self.schedule_executable(), evidence, key, fused=fused, **kw)
        else:
            out = mrf_mod.run_mrf_gibbs(mrf, evidence, key,
                                        device=self.device, **kw)
        # pinned pixels are constant by construction; keep them out of the
        # R-hat/ESS roll-ups like clamped BN nodes
        free_mask = None
        if pin_mask is not None:
            free_mask = ~pin_mask.cpu().numpy().reshape(-1)
        return out, free_mask, n_iters

    def run_sharded(
        self,
        key: prng.Key | None,
        mesh,
        *,
        n_chains: int = 32,
        n_iters: int = 200,
        burn_in: int | None = None,
        sampler: str = "lut_ky",
        evidence=None,
        backend: str = "schedule",
        fused: bool = False,
        thin: int = 1,
        carry_state=None,
        return_state: bool = False,
        diagnostics: bool = False,
        **axes,
    ):
        """Execute across `mesh`: a `core.distributed.make_mesh` mesh whose
        positions lie on the program's device, or a mesh over the ranks of
        a `torch.distributed` world (`distributed.RankMesh`, or the
        `launch.mesh.make_mesh` `DeviceMesh` it wraps, on the program's
        device), where every rank calls this with the same arguments, runs
        its own position and returns the whole result.  Node ownership
        follows this program's placement (see
        `distributed.run_program_sharded`).  With
        backend="schedule" (the default, like `run()`) the rounds come from
        this program's schedule and each round's comm op is routed onto
        its named collective; backend="eager" is the escape hatch.

        `fused=True` runs K5 (BN colour round) / K6 (MRF slab half-step)
        once per round over every position, with halo exchanges or psum
        merges between rounds.  The draw stream is bit-identical to
        `run(fused=True)` (asserted at first sharded use), so `thin`,
        `carry_state`, `return_state` and `diagnostics` keep the `run()`
        contracts, and a query may be sliced across the route boundary and
        resume on either side.  The legacy route (`fused=False`) folds the
        key per position and carries no state."""
        if self.kind == "bn" and evidence is not None:
            raise ValueError(
                "runtime evidence clamps are a single-device serving path; "
                "bake the evidence for sharded execution"
            )
        if not fused:
            if carry_state is not None or return_state or diagnostics:
                raise ValueError(
                    "carry_state/return_state/diagnostics ride the fused "
                    "sharded datapath; pass fused=True"
                )
            if thin != 1:
                raise ValueError(
                    "thin rides the fused sharded datapath; pass fused=True"
                )
            return dist_mod.run_program_sharded(
                self, key, mesh, n_chains=n_chains, n_iters=n_iters,
                burn_in=burn_in, sampler=sampler, evidence=evidence,
                backend=backend, **axes,
            )
        if backend != "schedule":
            raise ValueError("fused execution requires backend='schedule'")
        if thin < 1:
            raise ValueError(f"thin must be >= 1, got {thin}")
        if carry_state is None and key is None:
            raise ValueError("a fresh run (carry_state=None) needs a PRNG key")
        if self.kind == "bn":
            if carry_state is not None and not isinstance(
                carry_state, bnet.BNChainState
            ):
                raise TypeError(
                    "BN programs resume from a bayesnet.BNChainState, got "
                    f"{type(carry_state).__name__}"
                )
            backend_mod.check_fused_sampler(sampler)
            burn_in = 50 if burn_in is None else burn_in
        else:
            if carry_state is not None and not isinstance(
                carry_state, mrf_mod.MRFChainState
            ):
                raise TypeError(
                    "MRF programs resume from an mrf.MRFChainState, got "
                    f"{type(carry_state).__name__}"
                )
            if evidence is None:
                raise ValueError(
                    "MRF programs take the evidence image at run_sharded()")
            if burn_in is not None:
                raise ValueError(
                    "MRF programs return final states only; burn_in does "
                    "not apply"
                )
            if thin != 1:
                raise ValueError(
                    "MRF programs return final states only; thin does not "
                    "apply"
                )
            mrf_kernels.check_fused_sampler(sampler)
        diag_total = None
        if diagnostics:
            if carry_state is None:
                diag_total = n_iters
            elif getattr(carry_state, "quality", None) is None:
                raise ValueError(
                    "diagnostics=True on a resumed run needs a carry from a "
                    "run that was itself started with diagnostics=True (the "
                    "accumulator lives in the chain state)"
                )
        self.ensure_fused_cross_check(sampler, sharded=True)
        out = dist_mod.run_program_sharded(
            self, key, mesh, n_chains=n_chains, n_iters=n_iters,
            burn_in=burn_in, sampler=sampler, evidence=evidence,
            backend=backend, fused=True, thin=thin, carry=carry_state,
            return_state=return_state or diagnostics, diag_total=diag_total,
            **axes,
        )
        if not diagnostics:
            return out
        *results, state = out
        total_kept = n_iters
        if self.kind == "bn":
            total_kept = diag_accum.kept_count(n_iters, burn_in, thin)
        snap = self._summarize_quality(
            state, total_kept=total_kept if carry_state is None else None,
        )
        return (*results, snap, state) if return_state else (*results, snap)


def _compile_uncached(
    graph: ir_mod.SamplingGraph,
    mesh_shape: tuple[int, int],
    passes=None,
    pipeline: str = "default",
    device: torch.device | None = None,
) -> CompiledProgram:
    t0 = time.perf_counter()
    if passes is None:
        passes = passes_mod.named_pipeline(pipeline)
    with tracer.span(
        "compile_graph", cat="compile", ir=graph.ir_key, kind=graph.kind,
        n_nodes=graph.n_nodes, pipeline=pipeline,
        mesh_shape=list(mesh_shape),
    ):
        ctx = passes_mod.run_pipeline(graph, mesh_shape, passes)
    cbn = None
    if graph.kind == "bn":
        cbn = bnet.compile_bayesnet(
            graph.source, evidence=dict(graph.evidence), colors=ctx.colors,
            device=device,
        )
        # cross-check the two lowerings: schedule rounds must be exactly
        # the backend's colour groups, else "bit-exact" would be a lie
        if len(cbn.groups) != len(ctx.schedule.rounds):
            raise verify_mod.ScheduleVerificationError([Finding(
                rule="coverage", loc=f"{graph.name}:lowering",
                message=(
                    f"backend built {len(cbn.groups)} color groups but the "
                    f"schedule has {len(ctx.schedule.rounds)} rounds"
                ),
            )])
        for g, r in zip(cbn.groups, ctx.schedule.rounds):
            if tuple(int(v) for v in g.nodes.cpu().tolist()) != r.nodes:
                raise verify_mod.ScheduleVerificationError([Finding(
                    rule="coverage", loc=f"{graph.name}:round {r.color}",
                    message=(
                        "backend color group and schedule round disagree on "
                        "node membership; the two lowerings would not be "
                        "bit-exact"
                    ),
                )])
    diagnostics = dict(ctx.diagnostics)
    diagnostics["pass_times_s"] = dict(ctx.pass_times_s)
    diagnostics["pipeline"] = pipeline
    return CompiledProgram(
        ir=graph,
        placement=ctx.placement,
        schedule=ctx.schedule,
        diagnostics=diagnostics,
        device=device,
        cbn=cbn,
        compile_s=time.perf_counter() - t0,
    )


# ---------------------------------------------------------------------------
# LRU program cache (serving-style repeated workloads pay compile once)
# ---------------------------------------------------------------------------

_CACHE: collections.OrderedDict[tuple, CompiledProgram] = (
    collections.OrderedDict()
)
_CACHE_CAPACITY = 128
_STATS = {"hits": 0, "misses": 0, "evictions": 0}


def set_cache_capacity(capacity: int) -> int:
    """Set the program-cache capacity; shrinking evicts LRU-first
    immediately.  Returns the previous capacity."""
    global _CACHE_CAPACITY
    if capacity < 1:
        raise ValueError(f"cache capacity must be >= 1, got {capacity}")
    prev, _CACHE_CAPACITY = _CACHE_CAPACITY, capacity
    while len(_CACHE) > _CACHE_CAPACITY:
        _CACHE.popitem(last=False)
        _STATS["evictions"] += 1
    return prev


def compile_graph(
    model: DiscreteBayesNet | GridMRF | ir_mod.SamplingGraph,
    evidence: dict[int, int] | None = None,
    *,
    mesh_shape: tuple[int, int] = (4, 4),
    passes=None,
    pipeline: str = "default",
    cache: bool = True,
    cross_check: bool = False,
    device="cuda",
) -> CompiledProgram:
    """Front door of the compile chain: model -> IR -> passes -> program,
    with the program's tensors on `device`.

    With `cache=True` (default) programs are memoized by the IR content
    hash, mesh shape, pipeline name and device; ad-hoc `passes` bypass the
    cache.  `cross_check=True` lowers the schedule backend at compile time
    and bit-checks it against the eager engine (otherwise the check runs at
    the backend's first use)."""
    dev = device_mod.resolve(device)
    if isinstance(model, ir_mod.SamplingGraph):
        if evidence:
            raise ValueError(
                "evidence must be baked into the SamplingGraph at "
                "canonicalization (ir.from_bayesnet/canonicalize); it cannot "
                "be re-applied to an existing IR"
            )
        graph = model
    else:
        graph = ir_mod.canonicalize(model, evidence)
    if passes is not None or not cache:
        prog = _compile_uncached(graph, mesh_shape, passes, pipeline, dev)
        if cross_check:
            prog.schedule_executable()
        return prog
    key = (graph.ir_key, mesh_shape, pipeline, str(dev))
    prog = _CACHE.get(key)
    if prog is not None:
        _STATS["hits"] += 1
        _CACHE.move_to_end(key)
        return prog
    _STATS["misses"] += 1
    prog = _compile_uncached(graph, mesh_shape, pipeline=pipeline, device=dev)
    if cross_check:
        prog.schedule_executable()
    _CACHE[key] = prog
    if len(_CACHE) > _CACHE_CAPACITY:
        _CACHE.popitem(last=False)
        _STATS["evictions"] += 1
    return prog


def cache_stats() -> dict:
    total = _STATS["hits"] + _STATS["misses"]
    return {
        **_STATS,
        "size": len(_CACHE),
        "capacity": _CACHE_CAPACITY,
        "hit_rate": _STATS["hits"] / total if total else 0.0,
    }


def clear_program_cache() -> None:
    _CACHE.clear()
    for k in _STATS:
        _STATS[k] = 0
