#!/usr/bin/env python3
"""Time one pigs sweep through K3 and one Penguin half-step through K4 at
1,024 chains, through their entry points `bn_gibbs.fused_gibbs_sweep` and
`mrf_gibbs.mrf_round_step`, from the checkout named on the command line,
with that checkout's own sources and kernel build; prints one JSON line
with the card's name and power limit.

The entry points take the key in every version of the port, so each time
covers all the work of a sweep or half-step: the random words (made in
plain torch before the launch, or inside the kernel) and the kernel.
`*_events_ms` is CUDA events around back-to-back calls (host cost
included), `*_device_ms` the device time of every kernel per call and
`*_kernel_ms` that of K3 or K4 alone (torch.profiler).

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
    from repro_torch.core import bayesnet as bnet
    from repro_torch.core.graphs import bn_repository_replica
    from repro_torch.kernels import _lib, bn_gibbs, mrf_gibbs

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    _lib.build(("bn_gibbs", "mrf_gibbs"))
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

    print(json.dumps({
        "tree": tree, "card": cs.nvidia_smi(),
        "k3_sweep_events_ms": cs.time_ms(torch, k3, 200),
        "k3_sweep_device_ms": cs.device_ms(torch, k3, 200, ""),
        "k3_kernel_ms": cs.device_ms(torch, k3, 200, "bn_sweep_kernel"),
        "k4_half_step_events_ms": cs.time_ms(torch, k4, 50),
        "k4_half_step_device_ms": cs.device_ms(torch, k4, 50, ""),
        "k4_kernel_ms": cs.device_ms(torch, k4, 50, "mrf_half_step_kernel"),
    }), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
