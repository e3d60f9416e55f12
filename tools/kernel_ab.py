#!/usr/bin/env python3
"""Time K3 (one pigs sweep) and K4 (one Penguin half-step) at 1,024 chains
from the checkout named on the command line, with that checkout's own
sources and kernel build; prints one JSON line with the card's name and
power limit.

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
    from repro_torch.kernels import _lib, bn_gibbs, mrf_gibbs

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    _lib.build(("bn_gibbs", "mrf_gibbs"))
    cbn, fr, vals, p, words = cs._k3_setup(torch, "pigs", "lut_ky")

    def k3():
        bn_gibbs.bn_sweep(cbn, fr, vals, words, "lut_ky", p)

    dev = torch.device("cuda")
    tab, spec = cs.exp_lut(dev)
    mrf, _, ev = cs._mrf_model(torch, "penguin")
    labels = prng.randint(prng.key(1), (1024, 64, 64), 0, 4, dev)
    q = mrf_gibbs.half_step_params(mrf)
    w4 = mrf_gibbs.round_words(mrf, prng.key(2), 1024, q, dev)

    def k4():
        mrf_gibbs.mrf_half_step(mrf, labels, ev, w4, 0, tab, spec, q)

    print(json.dumps({
        "tree": tree, "card": cs.nvidia_smi(),
        "k3_device_ms": cs.device_ms(torch, k3, 200, "bn_sweep_kernel"),
        "k3_events_ms": cs.time_ms(torch, k3, 200),
        "k4_device_ms": cs.device_ms(torch, k4, 200, "mrf_half_step_kernel"),
        "k4_events_ms": cs.time_ms(torch, k4, 200),
    }), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
