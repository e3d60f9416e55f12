#!/usr/bin/env python3
"""Time, at 1,024 chains, one pigs sweep through K3 and one Penguin
half-step through K4 (entry points `bn_gibbs.fused_gibbs_sweep` and
`mrf_gibbs.mrf_round_step`), and the same on a (2, 4) mesh of one card: a
pigs sweep of `run_sharded(fused=True)` (K5 and the psum merges) and a
Penguin half-step of the sharded engine (`distributed._halo_exchange`,
then `mrf_gibbs.mrf_sharded_round_step`: K6); K1 through
`ky_sampler.ky_sample_kernel` (words read) at the draw request's 65,536 x
32 and at the pigs shape (451,584 x 3), and the draw request through
`ops.ky_sample(weights, key)` alone and after `ops.lut_exp_weights`; from
the checkout named on the command line, with that checkout's own sources
and kernel build (timed by this repository's chip_smoke helpers, so that
two checkouts are timed alike); prints one JSON line with the card's name
and power limit.

The entry points take the key in every version of the port, so each time
covers all the work of a sweep or half-step: the random words (made in
plain torch before the launch, or inside the kernel) and the kernels.
`*_events_ms` is CUDA events around back-to-back calls (host cost
included), `*_device_ms` the device time of every kernel per call and
`*_kernel_ms` the mean device time of one launch of the named kernel
(torch.profiler, by the kernel's name in the checkout: K3 and its lane entry share one kernel, K4 and its lane
entry another; older checkouts ran K3 in K5's kernel and K4 in K6's).
The K1 entries take the words or the key in every version, so `draw_*`
covers the words (plain torch, or hashed in the kernel) and K1;
`draw_labels_sum` must be the same in every checkout.  The sharded sweep is the slope of a query's wall (and its
host's issue time) between 50 and 250 sweeps (`chip_smoke.per_sweep`).

To compare two commits on one card, unpack both (`git archive`) into
directories that `.gitignore` lists and time them in turns in one call:

    for t in build/parent build/change build/change build/parent; do
        python3 tools/kernel_ab.py $t
    done

Needs a CUDA device; the checkout must hold `src/repro_torch`.
"""

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    """This repository's chip_smoke, whose timing helpers time every tree
    alike (the tree's own modules are imported inside them)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(tree: str) -> None:
    sys.path.insert(0, tree + "/src")
    import torch

    cs = _chip_smoke()
    from repro_torch import prng
    from repro_torch.compile.program import compile_graph
    from repro_torch.core import bayesnet as bnet
    from repro_torch.core import distributed
    from repro_torch.core import ky as ky_core
    from repro_torch.core.graphs import bn_repository_replica
    from repro_torch.kernels import _lib, bn_gibbs, ky_sampler, mrf_gibbs, ops

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    _lib.build(("bn_gibbs", "mrf_gibbs", "ky_sampler", "interp_lut"))
    dev = torch.device("cuda")
    cbn = bnet.compile_bayesnet(bn_repository_replica("pigs"), device=dev)
    fr = bn_gibbs.build_fused_rounds(cbn.groups)
    vals, _ = bnet.init_chain_values(cbn, prng.key(1), 1024)

    def k3():
        bn_gibbs.fused_gibbs_sweep(cbn, fr, vals, prng.key(2), "lut_ky")

    tab, spec = cs.exp_lut(dev)
    mrf, _, ev = cs._mrf_model(torch, "penguin")
    labels = prng.randint(prng.key(1), (1024, 64, 64), 0, 4, dev)

    def k4():
        mrf_gibbs.mrf_round_step(mrf, labels, ev, prng.key(2), 0, tab, spec)

    mesh = distributed.make_mesh((2, 4), ("data", "model"), "cuda")
    prog = compile_graph(bn_repository_replica("pigs"), device=dev)

    def bn_sharded(n):
        prog.run_sharded(prng.key(3), mesh, n_chains=1024, n_iters=n,
                         burn_in=0, fused=True)

    def k6():
        up, down = distributed._halo_exchange(labels, 4)
        mrf_gibbs.mrf_sharded_round_step(
            mrf, labels, ev, prng.key(2), 0, tab, spec, n_chain_pos=2,
            n_row_pos=4, up_halo=up, down_halo=down)

    def kernel_ms(fn, reps, names):
        # the first of the kernel's names in this checkout's build
        for name in names:
            ms = cs.device_ms(torch, fn, reps, name)
            if ms is not None:
                return ms
        return None

    # the draw request's 65,536 x 32 weights and the pigs sweep's 451,584
    # rows of 3, as chip_smoke makes them
    g = torch.Generator(device=dev).manual_seed(5)
    logp = torch.log(torch.rand((1 << 16, 32), generator=g, device=dev)
                     * 200.0 + 1.0)
    w32 = ops.lut_exp_weights(logp, tab, spec)
    words32 = ky_core.random_words(prng.key(9), (1 << 16,), 4, dev)
    n_pigs = 1024 * sum(fr.n_c)
    w3 = ops.lut_exp_weights(
        -10.0 * torch.rand((n_pigs, 3), generator=g, device=dev), tab, spec)
    words3 = ky_core.random_words(prng.key(8), (n_pigs,), 4, dev)

    def k1_32():
        ky_sampler.ky_sample_kernel(w32, words32, n_bins=32)

    def k1_3():
        ky_sampler.ky_sample_kernel(w3, words3, n_bins=3)

    def draw():
        return ops.ky_sample(w32, prng.key(9))

    def draw_full():
        ops.ky_sample(ops.lut_exp_weights(logp, tab, spec), prng.key(9))

    # the lane entries: one launch over Q queries of 1,024 chains, each
    # query with its own key (and, for K4, its own evidence plane)
    lanes = {}

    def k3_lanes(name, q):
        net = bnet.compile_bayesnet(bn_repository_replica(name), device=dev)
        tables = bn_gibbs.build_fused_rounds(net.groups)
        v = torch.cat([bnet.init_chain_values(net, prng.key(30 + i), 1024)[0]
                       for i in range(q)])
        kt = prng.key_tensor([prng.key(40 + i) for i in range(q)], dev)
        p = bn_gibbs.sweep_params(net, "lut_ky")
        return lambda: bn_gibbs.bn_sweep_lanes(net, tables, v, kt, "lut_ky",
                                               p)

    def k4_lanes(name, q):
        from repro_torch.core import mrf as mrf_mod

        grid, _, _ = cs._mrf_model(torch, name)
        hh, ww, nl = grid.height, grid.width, grid.n_labels
        evs = torch.stack([torch.as_tensor(mrf_mod.make_denoising_problem(
            hh, ww, nl, 0.25, seed=s)[1]) for s in range(q)]).to(dev)
        lab = prng.randint(prng.key(1), (q * 1024, hh, ww), 0, nl, dev)
        kt = prng.key_tensor([prng.key(50 + i) for i in range(q)], dev)
        p = mrf_gibbs.half_step_params(grid)
        return lambda: mrf_gibbs.mrf_half_step_lanes(grid, lab, evs, kt, 0,
                                                     tab, spec, p)

    # K3 runs as `bn_lanes_kernel` (in older checkouts as K5's
    # `bn_rounds_kernel`, before that `bn_sweep_kernel`), K4 as
    # `mrf_lanes_kernel` (older: K6's `mrf_half_step_kernel`)
    k3_names = ("bn_lanes_kernel", "bn_rounds_kernel", "bn_sweep_kernel")
    k4_names = ("mrf_lanes_kernel", "mrf_half_step_kernel")
    for tag, fn, reps, names in (
            ("k3_lanes_pigs_8x1024", k3_lanes("pigs", 8), 50, k3_names),
            ("k3_lanes_pigs_1x1024", k3_lanes("pigs", 1), 200, k3_names),
            ("k3_lanes_hailfinder_2x1024", k3_lanes("hailfinder", 2), 200,
             k3_names),
            ("k4_lanes_penguin_2x1024", k4_lanes("penguin", 2), 50, k4_names),
            ("k4_lanes_art_2x1024", k4_lanes("art", 2), 50, k4_names)):
        lanes[f"{tag}_events_ms"] = cs.time_ms(torch, fn, reps)
        lanes[f"{tag}_kernel_ms"] = kernel_ms(fn, reps, names)
        lanes[f"{tag}_labels_sum"] = int(fn().long().sum())

    sweep_ms, sweep_host_ms = cs.per_sweep(torch, bn_sharded)
    print(json.dumps({
        "tree": tree, "card": cs.nvidia_smi(),
        "k3_sweep_events_ms": cs.time_ms(torch, k3, 200),
        "k3_kernel_ms": kernel_ms(k3, 200, k3_names),
        "k4_half_step_events_ms": cs.time_ms(torch, k4, 50),
        "k4_kernel_ms": kernel_ms(k4, 50, k4_names),
        "sharded_pigs_sweep_ms": sweep_ms,
        "sharded_pigs_sweep_host_ms": sweep_host_ms,
        "sharded_pigs_k5_kernel_ms_a_round": kernel_ms(
            lambda: bn_sharded(20), 1, ("bn_rounds_kernel",)),
        "sharded_penguin_half_step_events_ms": cs.time_ms(torch, k6, 50),
        "sharded_penguin_half_step_device_ms": cs.device_ms(torch, k6, 50,
                                                            ""),
        "sharded_penguin_half_step_k6_kernel_ms": cs.device_ms(
            torch, k6, 50, "mrf_half_step_kernel"),
        "k1_32_events_ms": cs.time_ms(torch, k1_32, 200),
        "k1_32_kernel_ms": cs.device_ms(torch, k1_32, 200, "ky_"),
        "k1_pigs_events_ms": cs.time_ms(torch, k1_3, 50),
        "k1_pigs_kernel_ms": cs.device_ms(torch, k1_3, 50, "ky_"),
        "draw_ky_sample_events_ms": cs.time_ms(torch, draw, 200),
        "draw_ky_sample_device_ms": cs.device_ms(torch, draw, 200, ""),
        "draw_events_ms": cs.time_ms(torch, draw_full, 200),
        "draw_device_ms": cs.device_ms(torch, draw_full, 200, ""),
        "draw_labels_sum": int(draw().long().sum()),
        **lanes,
    }), flush=True)

if __name__ == "__main__":
    main(sys.argv[1])
