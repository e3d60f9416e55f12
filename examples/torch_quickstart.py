"""Quickstart on the PyTorch/CUDA port: exact vs approximate inference on
a Bayes net (the paper's core workload) through the port's compile chain,
as `examples/quickstart.py` does through the reference's.

    PYTHONPATH=src python examples/torch_quickstart.py               # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # twins

It runs on the card by default and raises without one; `--device cpu`
runs the kernels' plain torch twins.
"""

import argparse

import numpy as np

from repro_torch import device as device_mod
from repro_torch import prng
from repro_torch.compile.ir import canonicalize
from repro_torch.compile.program import cache_stats, compile_graph
from repro_torch.core.exact import ve_marginal
from repro_torch.core.graphs import bn_repository_replica


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=device_mod.DEFAULT,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    # the paper's "alarm" benchmark (structure-matched replica)
    bn = bn_repository_replica("alarm")
    evidence = {0: 1, 5: 0}
    query = 20

    # exact inference (variable elimination) — the Table IV baseline
    exact = ve_marginal(bn, query, evidence)

    # the compile chain (Fig. 8): BN -> SamplingGraph IR -> moralize ->
    # DSATUR -> greedy mesh placement -> round schedule -> CompiledProgram
    prog = compile_graph(bn, evidence=evidence, device=dev)
    cost = prog.schedule.cost()
    print(f"alarm replica: {prog.ir.n_nodes} nodes -> "
          f"{prog.diagnostics['n_colors']} colors, "
          f"{cost['n_rounds']} rounds/sweep, "
          f"~{cost['total_cycles']} model cycles "
          f"(compiled in {prog.compile_s*1e3:.0f} ms, "
          f"program {prog.program_key[:12]}...)")
    # a repeated request hits the program cache instead of re-compiling
    prog2 = compile_graph(bn, evidence=evidence, device=dev)
    assert prog2 is prog
    print(f"program cache: {cache_stats()['hits']} hit(s)")

    # execute: chromatic parallel Gibbs with LUT-exp (C2) + rejection-KY
    # (C1), running the compiled Schedule's rounds directly
    # (backend="schedule"; bit-exact with backend="eager"), each sweep one
    # launch of the fused BN kernel (fused=True; bit-exact with its
    # round-by-round form, fused=False)
    marginals, _ = prog.run(
        prng.key(0), n_chains=64, n_iters=500, burn_in=125,
        sampler="lut_ky", backend="schedule", fused=True, device=dev,
    )
    approx = marginals.cpu().numpy()[query][: len(exact)]

    print(f"P(X{query} | e)  exact : {np.round(exact, 4)}")
    print(f"P(X{query} | e)  gibbs : {np.round(approx, 4)}")
    tvd = 0.5 * np.abs(exact - approx).sum()
    print(f"total variation distance: {tvd:.4f}")
    assert tvd < 0.05, "Gibbs failed to converge"

    # the serving path compiles structure-only instead: evidence becomes a
    # *runtime* clamp, so every query on this model — whatever it observed
    # — reuses one cached program, bit-exact with baking that evidence at
    # compile time
    served = compile_graph(canonicalize(bn, evidence_mode="runtime"),
                           device=dev)
    marg_rt, _ = served.run(
        prng.key(0), n_chains=64, n_iters=500, burn_in=125,
        evidence=evidence, backend="schedule", fused=True, device=dev,
    )
    assert bool((marg_rt == marginals).all())
    print(f"runtime-clamped program {served.program_key[:12]}... serves any "
          "evidence dict, bit-exact with the baked compile")
    print("OK")


if __name__ == "__main__":
    main()
