"""What the ranks of the port's CPU rank-mesh tests run (no tests here).

`launch.mesh.spawn` pickles a rank's function by name, so the functions
live in this module, which imports neither JAX nor the reference: each
spawned rank imports it afresh.  The inputs are those of
`test_torch_distributed.py`'s reference run (seeds, shapes, keys), so a
rank's results are held against the reference's (2, 4) outputs and
against the single-process mesh.
"""

from __future__ import annotations

import fcntl
import os
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.compile import ir as t_ir
from repro_torch.compile import program as t_program
from repro_torch.core import distributed as t_dist
from repro_torch.core.graphs import GridMRF, random_bayesnet

CPU = torch.device("cpu")


def bn_prog():
    return t_program.compile_graph(
        t_ir.from_bayesnet(random_bayesnet(12, seed=3)), device="cpu")


def mrf_prog(height=8):
    return t_program.compile_graph(
        t_ir.from_mrf(GridMRF(height, 16, 4, theta=1.1)), device="cpu")


def evidence(height=8, seed=0):
    return np.random.default_rng(seed).integers(
        0, 4, (height, 16)).astype(np.int32)


# (BN run keyword arguments, MRF ones) of the cases the tests compare
BN_KW = dict(n_chains=8, n_iters=7, burn_in=2, thin=2, fused=True)
MRF_KW = dict(n_chains=4, n_iters=5, fused=True)
BN_DIAG_KW = dict(n_chains=4, n_iters=6, burn_in=2, thin=2, fused=True,
                  diagnostics=True)


def _raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return f"ValueError: {e}"
    return "no error"


def sampler_cases(rank, device_mesh) -> dict:
    """Every case of a (2, 4) world, or the fused ones of a smaller mesh:
    each rank runs its position and returns the whole results."""
    mesh = t_dist.RankMesh(device_mesh, CPU)
    bn, mrf = bn_prog(), mrf_prog()
    ev = evidence()
    res = {"rank": rank, "coords": mesh.coords}
    res["bn_fused"] = bn.run_sharded(prng.key(11), mesh, **BN_KW)
    # the DeviceMesh itself, taken on the program's device
    res["bn_exact"] = bn.run_sharded(prng.key(11), device_mesh,
                                     sampler="exact_ky", **BN_KW)
    res["mrf_fused"] = mrf.run_sharded(prng.key(7), mesh, evidence=ev,
                                       **MRF_KW)
    if mesh.shape != {"data": 2, "model": 4}:
        res["collectives"] = mesh.collectives
        return res
    # the reference's (2, 4) cases (test_torch_distributed._REFERENCE)
    res["ref_mrf_fused"] = mrf.run_sharded(
        prng.key(7), mesh, evidence=ev, n_chains=4, n_iters=5, fused=True)
    res["ref_bn_fused"] = bn.run_sharded(
        prng.key(11), mesh, n_chains=4, n_iters=6, burn_in=2, thin=2,
        fused=True)
    for be in ("schedule", "eager"):
        res[f"ref_mrf_legacy_{be}"] = mrf.run_sharded(
            prng.key(8), mesh, evidence=ev, n_chains=4, n_iters=3,
            fused=False, backend=be)
        res[f"ref_bn_legacy_{be}"] = bn.run_sharded(
            prng.key(12), mesh, n_chains=4, n_iters=6, burn_in=2,
            fused=False, backend=be)
    # carries: 3 sweeps on one device then 4 on the ranks, and 3 on the
    # ranks (their state goes back to the test, which runs 4 on one device)
    kw = {k: v for k, v in BN_KW.items() if k != "n_iters"}
    _, _, a = bn.run(prng.key(3), n_iters=3, return_state=True,
                     device="cpu", **kw)
    res["bn_carry_in"] = bn.run_sharded(None, mesh, n_iters=4, carry_state=a,
                                        return_state=True, **kw)
    res["bn_carry_out"] = bn.run_sharded(prng.key(3), mesh, n_iters=3,
                                         return_state=True, **kw)[2]
    mkw = dict(evidence=evidence(seed=2), n_chains=4, fused=True)
    _, a = mrf.run(prng.key(9), n_iters=2, return_state=True, device="cpu",
                   **mkw)
    res["mrf_carry_in"] = mrf.run_sharded(None, mesh, n_iters=4,
                                          carry_state=a, **mkw)
    res["mrf_carry_out"] = mrf.run_sharded(prng.key(9), mesh, n_iters=2,
                                           return_state=True, **mkw)[1]
    # diagnostics: fresh, and resumed from a one-device carry
    zeros = np.zeros((8, 16), np.int32)
    res["mrf_diag"] = mrf.run_sharded(prng.key(7), mesh, evidence=zeros,
                                      n_chains=4, n_iters=5, fused=True,
                                      diagnostics=True)
    res["bn_diag"] = bn.run_sharded(prng.key(11), mesh, **BN_DIAG_KW)
    _, _, a = mrf.run(prng.key(7), evidence=zeros, n_chains=4, n_iters=2,
                      fused=True, diagnostics=True, return_state=True,
                      device="cpu")
    res["mrf_diag_resumed"] = mrf.run_sharded(
        None, mesh, evidence=zeros, n_chains=4, n_iters=3, fused=True,
        diagnostics=True, carry_state=a)
    # the halo exchange alone, on chain block ci and row slab gi of a
    # known grid: slabs 0 and 3 meet the grid's edges
    grid = torch.arange(4 * 8 * 16, dtype=torch.int32).reshape(4, 8, 16)
    ci, gi = mesh.coord("data"), mesh.coord("model")
    res["halo"] = t_dist._rank_halo(
        mesh, grid[2 * ci:2 * ci + 2, 2 * gi:2 * gi + 2], "model")
    # argument errors, raised on every rank before any collective
    from repro_torch.launch import mesh as mesh_mod

    res["errors"] = {
        "mesh_size": _raises(lambda: mesh_mod.make_mesh(
            (2, 2), ("data", "model"), device_type="cpu")),
        "production_mesh": _raises(lambda: mesh_mod.make_production_mesh(
            device_type="cpu")),
        "n_chains": _raises(lambda: bn.run_sharded(
            prng.key(0), mesh, n_chains=3, n_iters=1, fused=True)),
        "n_chains_legacy": _raises(lambda: bn.run_sharded(
            prng.key(0), mesh, n_chains=3, n_iters=1)),
        "grid_height": _raises(lambda: mrf_prog(height=9).run_sharded(
            prng.key(0), mesh, evidence=evidence(9), n_chains=2, n_iters=1,
            fused=True)),
    }
    res["collectives"] = mesh.collectives
    return res


def fail_on_rank_1(rank, device_mesh):
    """Rank 1 raises; rank 0 waits in a barrier rank 1 never joins."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    torch.distributed.barrier()


def hang(rank, device_mesh):
    time.sleep(600)


def once_per_session(tmp_path_factory, name: str, compute):
    """`compute()` once per test session: pytest-xdist's workers share one
    result through a file in the session's temporary directory (a lock
    keeps a second worker waiting for the first), so a module fixture
    that spawns ranks or a JAX subprocess runs once, not once a worker."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent  # shared by this session's workers
    path = base / f"{name}.pt"
    with open(base / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            tmp = base / f"{name}.{os.getpid()}.tmp"
            torch.save(compute(), tmp)
            os.replace(tmp, path)
    return torch.load(path, weights_only=False)
