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


# ---------------------------------------------------------------------------
# the LM mesh (test_torch_lm_mesh.py): reduced configs in float32 with the
# reference's weights; every rank returns whole tensors
# ---------------------------------------------------------------------------

LM_ARCHS = ("yi-9b", "qwen2-moe-a2.7b", "xlstm-350m", "jamba-1.5-large-398b")
LM_B, LM_S0, LM_GEN, LM_SEQ = 8, 16, 3, 16
# decode's K/V cache slots: a multiple of the (2, 4) mesh's model axis, so
# that the cache is split by sequence there (6 slots a rank: the last
# rank holds no valid slot until the third decode step)
LM_CACHE = 24
LM_KEY = 5


def lm_cfg(arch: str):
    """Reduced `arch` computing and holding its leaves in float32 (jamba's
    config holds bf16 leaves, and a bf16 gradient turns float32 rounding
    into whole bf16 steps, which no float32 bound holds)."""
    import dataclasses

    from repro_torch import configs as t_configs

    return dataclasses.replace(t_configs.get_config(arch).reduced(),
                               dtype="float32", param_dtype="float32")


def lm_inputs(vocab: int, seed: int = 0) -> dict:
    """Prompts (B, S0), the decode steps' teacher-forced tokens (GEN, B,
    1), and a train batch (B, SEQ) of tokens and labels."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, vocab, (LM_B, LM_SEQ + 1)).astype(np.int32)
    return {"prompts": rng.integers(0, vocab, (LM_B, LM_S0)).astype(np.int32),
            "decode": rng.integers(0, vocab, (LM_GEN, LM_B, 1)
                                   ).astype(np.int32),
            "tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy()}


def lm_opt_cfg():
    from repro_torch.optim import adamw

    return adamw.AdamWConfig(warmup_steps=1, total_steps=10)


def comm_record(comm) -> dict:
    """What a meshed step's `collectives.Comm` counted: result bytes and
    calls by op, bytes and calls by "<op> over <axis>", and the axes each parameter
    was gathered over."""
    return {"nbytes": dict(comm.nbytes), "count": dict(comm.count),
            "axis_bytes": dict(comm.axis_bytes),
            "axis_count": dict(comm.axis_count),
            "leaf_axes": dict(comm.leaf_axes)}


def lm_serve(cfg, model, inputs, mesh=None) -> dict:
    """Prefill logits and caches, then GEN teacher-forced decode steps
    (the attention caches grown to LM_CACHE slots) with the KY sampler:
    each step's logits and tokens (whole); on a
    mesh, the prefill's and the decode steps' collectives
    (`comm_record`)."""
    from repro_torch import prng
    from repro_torch.launch import collectives, sharding, steps
    from repro_torch.models import transformer as tfm

    batch = {"tokens": torch.from_numpy(inputs["prompts"])}
    if mesh is None:
        logits, caches = steps.make_prefill_step(cfg)(model, batch)
        serve = steps.make_serve_step(cfg, sampler="ky")
    else:
        model = sharding.distribute(
            mesh, model, sharding.param_specs(mesh, cfg, model), cfg=cfg)
        prefill = steps.make_prefill_step(cfg, mesh)(batch)
        logits, caches = prefill(model, batch)
        caches = collectives.whole(caches)
    out = {"prefill_logits": logits,
           "prefill_caches": [{n: t.clone() for n, t in c.items()}
                              for c in caches]}
    caches = tfm.grow_attn_caches(caches, cfg, LM_CACHE - LM_S0)
    if mesh is not None:
        serve, _ = steps.make_serve_step(cfg, mesh, sampler="ky")(caches,
                                                                  LM_B)
    key, toks, lgs = prng.key(LM_KEY), [], []
    for t in range(LM_GEN):
        key, sub = prng.split(key)
        tok, lg, caches = serve(model, torch.from_numpy(inputs["decode"][t]),
                                caches, LM_S0 + t, sub)
        toks.append(tok)
        lgs.append(lg)
    out["ky_tokens"], out["decode_logits"] = torch.stack(toks), torch.stack(
        lgs)
    if mesh is not None:
        out["comm"] = {"prefill": comm_record(prefill.comm),
                       "decode": comm_record(serve.comm)}
    return out


def lm_generate(cfg, model, inputs, mesh=None) -> dict:
    """`serve.generate` of the prompts (LM_GEN KY tokens): the tokens, and
    the largest K/V-shaped tensor (4 axes ending in (kv heads, head dim))
    any op made on this rank, in elements."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from repro_torch import prng
    from repro_torch.launch import serve, sharding

    tail = (cfg.n_kv_heads, cfg.hd)

    class KVPeak(TorchDispatchMode):
        peak = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_flatten(out)[0]:
                if (type(t) is torch.Tensor and t.device.type != "meta"
                        and t.ndim == 4 and tuple(t.shape[2:]) == tail):
                    self.peak = max(self.peak, t.numel())
            return out

    if mesh is not None:
        model = sharding.distribute(
            mesh, model, sharding.param_specs(mesh, cfg, model), cfg=cfg)
    prompts = torch.from_numpy(inputs["prompts"])
    with KVPeak() as kv:
        toks, _ = serve.generate(cfg, model, prompts, LM_GEN, sampler="ky",
                                 mesh=mesh, key=prng.key(LM_KEY))
    return {"tokens": toks, "kv_peak": kv.peak}


def lm_train(cfg, model, inputs, mesh=None, ckpt_dir=None) -> dict:
    """One AdamW step: its loss, gradients (whole, by state-dict name) and
    updated leaves; on a mesh the collectives of the gradients' pass
    (`comm_record`), and with `ckpt_dir` a checkpoint after that step, a
    second step, and the second step again from the checkpoint restored
    onto fresh state."""
    import copy

    from repro_torch.launch import collectives, sharding
    from repro_torch.launch import train as t_train
    from repro_torch.models import transformer as tfm

    batch = {k: torch.from_numpy(inputs[k]) for k in ("tokens", "labels")}
    shapes = {n: p.shape for n, p in tfm.train_leaves(model, cfg).items()}

    def build(m):
        return t_train.build(cfg, lm_opt_cfg(), "cpu", mesh, batch, m)

    def whole(tree):
        return {n: collectives.whole(t).reshape(shapes[n]).detach().clone()
                for n, t in tree.items()}

    params, leaves, state, fn, _ = build(copy.deepcopy(model))
    if mesh is None:
        loss = tfm.train_loss(params, cfg, batch)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
    else:
        loss, _, g = fn.loss_and_grads(params, batch)
        comm = fn.comm
        record = comm_record(comm)
        specs = sharding.param_specs(mesh, cfg, tfm.train_leaves(model, cfg))
        loss = comm.all_reduce(loss.detach(), comm.dp)
        grads = {n: comm.gather_spec(g[n], specs[n]).reshape(shapes[n])
                 for n in g}
    _, _, m = fn(params, state, batch)
    out = {"loss": m["loss"], "grad_loss": loss.detach(), "grads": grads,
           "grad_norm": m["grad_norm"], "leaves": whole(leaves)}
    if mesh is not None:
        out["comm"] = {"train": record}
    if ckpt_dir is None:
        return out
    from repro_torch.checkpoint import checkpoint as t_ckpt

    t_ckpt.save(ckpt_dir, 1, {"params": leaves, "opt": state}, cfg=cfg)
    fn(params, state, batch)
    out["second"] = whole(leaves)
    params2, leaves2, state2, fn2, _ = build(copy.deepcopy(model))
    _, by_path = t_ckpt.restore(ckpt_dir, 1)
    t_train._restore_into(cfg, {"params": leaves2, "opt": state2}, by_path)
    fn2(params2, state2, batch)
    out["second_resumed"] = whole(leaves2)
    return out


def lm_mesh_cases(rank, device_mesh, trees, ckpt_dir, restore) -> dict:
    """Every LM case on this rank's position: `trees` the reference's
    weights by arch (numpy); `ckpt_dir` where the (2, 4) world writes its
    checkpoint, which a world with `restore` restores after its cases
    (`lm_restore`)."""
    from repro_torch import convert

    out = {"rank": rank, "coords": tuple(int(c) for c in
                                         device_mesh.get_coordinate())}
    for arch in LM_ARCHS:
        cfg = lm_cfg(arch)
        inputs = lm_inputs(cfg.vocab)
        res = lm_serve(cfg, convert.lm_params_from_reference(
            trees[arch], cfg, "cpu"), inputs, device_mesh)
        if arch == "yi-9b":
            res["generate"] = lm_generate(
                cfg, convert.lm_params_from_reference(trees[arch], cfg,
                                                      "cpu"),
                inputs, device_mesh)
        train = lm_train(cfg, convert.lm_params_from_reference(
            trees[arch], cfg, "cpu", train=True), inputs, device_mesh,
            ckpt_dir if arch == "yi-9b" and not restore else None)
        res["comm"].update(train.pop("comm"))
        res.update(train)
        out[arch] = res
    if restore:
        out["restored"] = lm_restore(rank, device_mesh, trees["yi-9b"],
                                     ckpt_dir)
    return out


def lm_restore(rank, device_mesh, tree, ckpt_dir) -> dict:
    """The (2, 4) world's checkpoint restored onto this world's mesh:
    every parameter and first moment whole."""
    from repro_torch import convert
    from repro_torch.checkpoint import checkpoint as t_ckpt
    from repro_torch.launch import collectives
    from repro_torch.launch import train as t_train
    from repro_torch.models import transformer as tfm

    cfg = lm_cfg("yi-9b")
    model = convert.lm_params_from_reference(tree, cfg, "cpu", train=True)
    shapes = {n: p.shape for n, p in tfm.train_leaves(model, cfg).items()}
    inputs = lm_inputs(cfg.vocab)
    _, leaves, state, _, _ = t_train.build(
        cfg, lm_opt_cfg(), "cpu", device_mesh,
        {k: inputs[k] for k in ("tokens", "labels")}, model)
    _, by_path = t_ckpt.restore(ckpt_dir, 1)
    t_train._restore_into(cfg, {"params": leaves, "opt": state}, by_path)
    return {part: {n: collectives.whole(t).reshape(shapes[n]).detach()
                   for n, t in tree_.items()}
            for part, tree_ in (("leaves", leaves), ("m", state["m"]))}
