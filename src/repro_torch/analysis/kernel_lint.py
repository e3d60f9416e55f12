"""Will a bucket fit the fused kernels?  Judged on Hopper shared memory.

The port's counterpart of the reference's `analysis/kernel_lint.py:273`
`fused_fits`, the demotion oracle of `runtime.batcher.fused_eligible`.  The
reference estimates a Pallas kernel's VMEM footprint against a 16 MiB
budget; here a block of K3 holds `chains_per_block` chains' values (at
least one chain, at most 227 KB of shared memory) and a block of K4 / K6
holds `tile_rows` label rows of the grid (at least one row), so a bucket
fits when both sizing rules accept its model, and the KY walk's register
lanes cover its widest alphabet.  False means "route unfused": bit-exact,
only slower.  The rest of the reference's lint (footprint reports,
findings, the CLI) is not ported yet.
"""

from __future__ import annotations

from repro_torch.core.interp import DEFAULT_SIZE
from repro_torch.kernels import bn_gibbs, mrf_gibbs
from repro_torch.kernels.ky_sampler import LANES

# verdicts memoized by content hash: bucket_key calls this per query
_FIT_CACHE: dict[tuple, bool] = {}


def _fits(graph, n_chains: int) -> bool:
    try:
        if graph.kind == "bn":
            if max(graph.cards) >= LANES:
                return False
            bn_gibbs.chains_per_block(n_chains, graph.n_nodes, DEFAULT_SIZE)
        else:
            mrf = graph.source
            if mrf.n_labels >= LANES:
                return False
            mrf_gibbs.tile_rows(mrf.width, DEFAULT_SIZE)
    except ValueError:
        return False
    return True


def fused_fits(graph, n_chains: int, sampler: str = "lut_ky") -> bool:
    """Does this (model, chain width, sampler) bucket fit the fused
    kernels' blocks?  Unlike the reference's, the verdict takes no
    mesh-slice width: a sharded MRF bucket's slabs keep the grid's width,
    and a block takes whole rows of one slab, so every width fits alike."""
    key = (graph.ir_key, int(n_chains), sampler)
    hit = _FIT_CACHE.get(key)
    if hit is None:
        hit = _fits(graph, int(n_chains))
        _FIT_CACHE[key] = hit
    return hit
