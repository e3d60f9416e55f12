"""Static shared-memory footprints of the fused kernels on Hopper (port of
`repro/analysis/kernel_lint.py`).

A fused bucket whose block does not fit fails at launch, after the
batcher has committed the microbatch.  The reference estimates a Pallas
kernel's per-core VMEM residency against a 16 MiB budget; on the H100 a
CUDA block holds what its wrapper stages in shared memory, at most 227 KB
after the dynamic opt-in, so the footprint here is exactly what the
wrappers' own sizing rules allocate:

  * **BN** (K3 / K5, `kernels/bn_gibbs.py`): K5's `chains_per_block`
    chains' values (4 bytes a node) and the exp LUT.  The rule packs as
    many chains as the default 48 KB holds (and two blocks per SM when the
    batch allows); a net too wide for one chain within 227 KB raises.
    K3's lane kernel (`lanes_launch`) holds at least 4 chains as bytes,
    the same 4 bytes a node, and stages the arena only where it fits.
  * **MRF** (K4 / K6, `kernels/mrf_gibbs.py`): K6's `tile_rows` label rows
    plus the two halo rows, the tile's evidence rows and the LUT (K4's
    lane kernel takes at most 16 of those rows, its labels as bytes).  A
    grid too wide for one row within 227 KB raises.  A sharded bucket's slabs keep
    the grid's width and a block takes rows of one slab, so the footprint
    takes no mesh-slice width.
  * The KY walk's register lanes cover at most 127 bins (`ky_sampler.
    LANES`); a wider alphabet is the `ky-lanes` finding.

Rules, against the reference's: `smem-budget` is its `vmem-budget` (an
error, or a warning where the batcher's `fused_fits` demotes the bucket
before it launches), `smem-pressure` its `vmem-pressure` (above 75% of
the budget).  Register spills are not estimated statically: `chip_smoke`
reads them from ptxas' report of every built instance.

`fused_fits` is the demotion oracle of `runtime.batcher.fused_eligible`:
False means "route unfused", bit-exact and only slower.
"""

from __future__ import annotations

import dataclasses

from repro_torch.analysis import Finding
from repro_torch.core.interp import DEFAULT_SIZE
from repro_torch.kernels import bn_gibbs, mrf_gibbs
from repro_torch.kernels.ky_sampler import LANES

# Hopper's shared memory per block, after the dynamic opt-in (the
# wrappers' `_SMEM_MAX`)
SMEM_BUDGET = bn_gibbs._SMEM_MAX
# fraction of the budget at which a warning (not an error) fires
PRESSURE_FRACTION = 0.75
ITEM_BYTES = 4  # int32 / float32


@dataclasses.dataclass(frozen=True)
class KernelFootprint:
    """A fused kernel's shared memory per block, with the breakdown that
    tells a human which buffer blew the budget."""

    kernel: str  # "bn_fused" | "mrf_fused"
    model: str
    n_chains: int
    sampler: str
    breakdown: dict
    max_bins: int  # the widest alphabet the walk must cover

    @property
    def total_bytes(self) -> int:
        return sum(self.breakdown.values())

    def fits(self, budget: int = SMEM_BUDGET) -> bool:
        return self.total_bytes <= budget and self.max_bins < LANES

    def findings(
        self, budget: int | None = None, demotable: bool = True
    ) -> list[Finding]:
        """`demotable=True` (the default) means the batcher's `fused_fits`
        guard routes this bucket unfused before it launches, so an
        over-budget block is an advisory (warning) rather than a launch
        failure in waiting (error)."""
        budget = SMEM_BUDGET if budget is None else budget
        loc = f"{self.model}:{self.kernel}"
        sev = "warning" if demotable else "error"
        demote = ("; batcher demotes this bucket to the unfused route"
                  if demotable else "")
        out = []
        if self.max_bins >= LANES:
            out.append(Finding(
                rule="ky-lanes", loc=loc, severity=sev,
                message=f"{self.max_bins} bins, the walk covers "
                        f"{LANES - 1}{demote}",
                fixit="split the variable's alphabet hierarchically, or "
                      "keep the bucket on the unfused route",
            ))
        total = self.total_bytes
        top = max(self.breakdown, key=self.breakdown.get)
        detail = (
            f"{total / 1024:.1f} KB of shared memory per block "
            f"(B={self.n_chains}, sampler={self.sampler}; dominant buffer "
            f"{top!r} at {self.breakdown[top] / 1024:.1f} KB) vs "
            f"{budget / 1024:.1f} KB budget"
        )
        if total > budget:
            out.append(Finding(
                rule="smem-budget", loc=loc, message=detail + demote,
                severity=sev,
                fixit="keep the bucket on the unfused route, or stage fewer "
                      "rows per block",
            ))
        elif total > PRESSURE_FRACTION * budget:
            out.append(Finding(rule="smem-pressure", loc=loc,
                               message=detail))
        return out


def bn_fused_footprint(
    graph, n_chains: int, sampler: str = "lut_ky"
) -> KernelFootprint:
    """K3's (and K5's) block for one model at one chain width: the chains
    `bn_gibbs.chains_per_block` packs (one, where even one does not fit
    its rule) and the exp LUT."""
    n = int(graph.n_nodes)
    try:
        cpc = bn_gibbs.chains_per_block(int(n_chains), n, DEFAULT_SIZE)
    except ValueError:
        cpc = 1
    return KernelFootprint(
        kernel="bn_fused", model=graph.name, n_chains=int(n_chains),
        sampler=sampler, max_bins=max(graph.cards, default=0),
        breakdown={"chain_values": cpc * n * ITEM_BYTES,
                   "exp_lut": DEFAULT_SIZE * ITEM_BYTES},
    )


def mrf_fused_footprint(
    graph, n_chains: int, sampler: str = "lut_ky"
) -> KernelFootprint:
    """K4's (and K6's) block for one grid: `mrf_gibbs.tile_rows` label rows
    and their two halo rows, the tile's evidence rows and the exp LUT
    (one row, where even one does not fit its rule).  Chains run in other
    blocks, so the footprint does not grow with `n_chains`."""
    width = int(graph.source.width)
    try:
        rows = mrf_gibbs.tile_rows(width, DEFAULT_SIZE)
    except ValueError:
        rows = 1
    return KernelFootprint(
        kernel="mrf_fused", model=graph.name, n_chains=int(n_chains),
        sampler=sampler, max_bins=int(graph.source.n_labels),
        breakdown={"label_rows": (rows + 2) * width * ITEM_BYTES,
                   "evidence_rows": rows * width * ITEM_BYTES,
                   "exp_lut": DEFAULT_SIZE * ITEM_BYTES},
    )


def estimate_footprint(
    graph, n_chains: int, sampler: str = "lut_ky"
) -> KernelFootprint:
    if graph.kind == "bn":
        return bn_fused_footprint(graph, n_chains, sampler)
    return mrf_fused_footprint(graph, n_chains, sampler)


# verdicts memoized by content hash: bucket_key calls this per query
_FIT_CACHE: dict[tuple, bool] = {}


def fused_fits(graph, n_chains: int, sampler: str = "lut_ky") -> bool:
    """Does this (model, chain width, sampler) bucket fit the fused
    kernels' blocks and the KY walk's lanes?  Unlike the reference's, the
    verdict takes no mesh-slice width (see the module docstring)."""
    key = (graph.ir_key, int(n_chains), sampler)
    hit = _FIT_CACHE.get(key)
    if hit is None:
        hit = estimate_footprint(graph, n_chains, sampler).fits()
        _FIT_CACHE[key] = hit
    return hit


def lint_kernels(
    graphs, n_chains: int = 32, sampler: str = "lut_ky",
    budget: int | None = None, demotable: bool = True,
) -> list[Finding]:
    """Footprint findings for a set of IRs — the CLI entry point."""
    out: list[Finding] = []
    for g in graphs:
        out.extend(
            estimate_footprint(g, n_chains, sampler).findings(
                budget, demotable=demotable
            )
        )
    return out
