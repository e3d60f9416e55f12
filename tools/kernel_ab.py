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
and kernel build; prints one JSON line with the card's name and power
limit.

The entry points take the key in every version of the port, so each time
covers all the work of a sweep or half-step: the random words (made in
plain torch before the launch, or inside the kernel) and the kernels.
`*_events_ms` is CUDA events around back-to-back calls (host cost
included), `*_device_ms` the device time of every kernel per call and
`*_kernel_ms` that of K3-K6 alone (torch.profiler; K3 and K5 share one
kernel since K5's redesign, whose name the profiler shows, and K4 and K6
another).  The K1 entries take the words or the key in every version, so
`draw_*` covers the words (plain torch, or hashed in the kernel) and K1;
`draw_labels_sum` must be the same in every checkout.  The sharded sweep is the slope of a query's wall (and its
host's issue time) between 50 and 250 sweeps (`chip_smoke.per_sweep`).

To compare two commits on one card, unpack both (`git archive`) into
directories that `.gitignore` lists and time them in turns in one call:

    for t in build/parent build/change build/change build/parent; do
        python3 tools/kernel_ab.py $t
    done

Needs a CUDA device; the checkout must hold `chip_smoke.py` and
`src/repro_torch`.
"""

import json
import sys


def main(tree: str) -> None:
    sys.path.insert(0, tree + "/src")
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
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

    bn_names = ("bn_rounds_kernel", "bn_sweep_kernel")
    sweep_ms, sweep_host_ms = cs.per_sweep(torch, bn_sharded)
    k5_ms = kernel_ms(lambda: bn_sharded(20), 1, bn_names)
    print(json.dumps({
        "tree": tree, "card": cs.nvidia_smi(),
        "k3_sweep_events_ms": cs.time_ms(torch, k3, 200),
        "k3_sweep_device_ms": cs.device_ms(torch, k3, 200, ""),
        "k3_kernel_ms": kernel_ms(k3, 200, bn_names),
        "k4_half_step_events_ms": cs.time_ms(torch, k4, 50),
        "k4_half_step_device_ms": cs.device_ms(torch, k4, 50, ""),
        "k4_kernel_ms": cs.device_ms(torch, k4, 50, "mrf_half_step_kernel"),
        "sharded_pigs_sweep_ms": sweep_ms,
        "sharded_pigs_sweep_host_ms": sweep_host_ms,
        "sharded_pigs_sweep_k5_kernel_ms": k5_ms and k5_ms / 20,
        "sharded_penguin_half_step_events_ms": cs.time_ms(torch, k6, 50),
        "sharded_penguin_half_step_device_ms": cs.device_ms(torch, k6, 50,
                                                            ""),
        "sharded_penguin_half_step_k6_kernel_ms": cs.device_ms(
            torch, k6, 50, "mrf_half_step_kernel"),
        "k1_32_events_ms": cs.time_ms(torch, k1_32, 200),
        "k1_32_kernel_ms": cs.device_ms(torch, k1_32, 200, ""),
        "k1_pigs_events_ms": cs.time_ms(torch, k1_3, 50),
        "k1_pigs_kernel_ms": cs.device_ms(torch, k1_3, 50, ""),
        "draw_ky_sample_events_ms": cs.time_ms(torch, draw, 200),
        "draw_ky_sample_device_ms": cs.device_ms(torch, draw, 200, ""),
        "draw_events_ms": cs.time_ms(torch, draw_full, 200),
        "draw_device_ms": cs.device_ms(torch, draw_full, 200, ""),
        "draw_labels_sum": int(draw().long().sum()),
    }), flush=True)

if __name__ == "__main__":
    main(sys.argv[1])
