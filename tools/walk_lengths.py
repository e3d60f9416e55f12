#!/usr/bin/env python3
"""How long the KY walks of K3's and K4's lane kernels are, and what a
warp pays for them: a warp of those kernels walks 32 rows (K3: one node
across 32 chains; K4: 32 column pairs of one grid row) and runs until its
slowest lane is done, so its walk costs the maximum of 32 walks' steps,
not their mean.  Runs the twins (the same walks, step for step) on the
CPU and prints, per model, the mean steps a row and the mean over warps
of the slowest lane's steps, as one JSON line each.

    PYTHONPATH=src python3 tools/walk_lengths.py [--chains 256] [--sweeps 3]
"""

import argparse
import json
import sys

import torch

from repro_torch import prng
from repro_torch.core import bayesnet as bnet
from repro_torch.core import ky as ky_core
from repro_torch.core import mrf as mrf_mod
from repro_torch.core.graphs import GridMRF, bn_repository_replica
from repro_torch.core.interp import build_exp_weight_lut
from repro_torch.core.mrf import checkerboard_mask
from repro_torch.kernels import bn_gibbs, mrf_gibbs

WARP = 32


def bn_walks(name: str, chains: int, sweeps: int) -> dict:
    """Steps of every row's walk over `sweeps` pigs-style sweeps, the
    rows of a round grouped as the lane kernel's warps take them (one
    node, 32 chains)."""
    cbn = bnet.compile_bayesnet(bn_repository_replica(name), device="cpu")
    fr = bn_gibbs.build_fused_rounds(cbn.groups)
    vals, _ = bnet.init_chain_values(cbn, prng.key(1), chains)
    p = bn_gibbs.sweep_params(cbn, "lut_ky")
    steps, fast = [], ky_core.ky_sample_fast

    def record(*args, **kwargs):
        out = fast(*args, **kwargs)
        steps.append(out[1]["bits_used"])
        return out

    ky_core.ky_sample_fast = record
    try:
        for i in range(sweeps):
            vals = bn_gibbs.bn_sweep(cbn, fr, vals, prng.key(5 + i),
                                     "lut_ky", p)
    finally:
        ky_core.ky_sample_fast = fast
    means, worst = [], []
    for i, s in enumerate(steps):
        nc = fr.n_c[i % len(fr.n_c)]
        warps = s.reshape(chains, nc).T.reshape(nc, chains // WARP, WARP)
        means.append(s.float().mean())
        worst.append(warps.max(-1).values.float().mean())
    return {"model": name, "precision": p.precision,
            "mean_steps": float(torch.stack(means).mean()),
            "warp_max_steps": float(torch.stack(worst).mean())}


def mrf_walks(name: str, h: int, w: int, v: int, cost: str,
              chains: int) -> dict:
    """Steps of every active site's walk of one half-step (parity 0) from
    random labels, sites grouped as the lane kernel's warps take them (32
    column pairs of a row)."""
    mrf = GridMRF(h, w, v, theta=1.2, h=2.0, data_cost=cost)
    tab, spec = build_exp_weight_lut(device="cpu")
    ev = torch.as_tensor(mrf_mod.make_denoising_problem(h, w, v, 0.25,
                                                        seed=1)[1])
    labels = prng.randint(prng.key(1), (chains, h, w), 0, v, "cpu")
    p = mrf_gibbs.half_step_params(mrf)
    words = mrf_gibbs.round_words(mrf, prng.key(3), chains, p, "cpu")
    active = checkerboard_mask(h, w, 0, "cpu")
    weights = mrf_gibbs.site_weights(mrf, labels, ev, tab, spec)[:, active]
    s = ky_core.ky_sample_fast(
        weights.reshape(-1, v), words[:, active].reshape(-1, p.n_words),
        n_bins=v, precision=p.precision)[1]["bits_used"]
    return {"model": name, "precision": p.precision,
            "mean_steps": float(s.float().mean()),
            "warp_max_steps": float(
                s.reshape(-1, WARP).max(-1).values.float().mean())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--sweeps", type=int, default=3)
    args = ap.parse_args(argv)
    if args.chains % WARP:
        ap.error(f"--chains must be a multiple of {WARP}")
    for name in ("pigs", "hailfinder"):
        print(json.dumps(bn_walks(name, args.chains, args.sweeps)))
    for name, shape in (("penguin", (64, 64, 4, "potts")),
                        ("art", (48, 48, 8, "potts")),
                        ("art_quadratic", (48, 48, 8, "quadratic"))):
        print(json.dumps(mrf_walks(name, *shape, args.chains)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
