"""Step builders for training (loss, gradients and the AdamW update) and
serving (prefill, and decode with the token draw), plus each dry-run
cell's inputs.

Port of `repro/launch/steps.py`.  The reference jits each step; PyTorch
runs eagerly, so a step here is a plain function.  The dry-run cells:

  train_4k    -> train_step   (loss + AdamW update, global_batch=256, S=4096)
  prefill_32k -> prefill_step (forward + cache build, gb=32, S=32768)
  decode_32k  -> serve_step   (1 new token against a 32768 KV/state cache,
                               gb=128, KY token sampling inside the step)
  long_500k   -> serve_step   (S_cache=524288, gb=1; sub-quadratic archs)

Without a mesh a factory returns the one-device step.  With a mesh (a
`launch/mesh.make_mesh` `DeviceMesh` over the ranks of a
`torch.distributed` world, or a shape-only `mesh.AbstractMesh` for a dry
run) each rank runs the same step SPMD with the reference's two-stage
call shapes:

  * `make_train_step(cfg, mesh)` returns `(with_batch, shardings)`, and
    `with_batch(batch_shape)` returns `(fn, bspecs)`;
  * `make_prefill_step(cfg, mesh)` returns `with_batch`, and
    `with_batch(batch_shape)` returns `fn`;
  * `make_serve_step(cfg, mesh)` returns `with_caches`, and
    `with_caches(cache_shape, batch)` returns `(fn, cspecs)`.

The parameters and AdamW moments are `sharding.distribute`d trees (each
rank's shard, as DTensors), the caches a prefill step returns too; a
batch, tokens or caches may also be given whole, and the step takes its
own part.  A rank computes its batch rows block by block, with the
weights gathered over the data axes and, where the rules split them
over the model axis, its own heads and columns of them, the partial
products summed over that axis (`launch/collectives.py`; every other
weight gathered whole), and every rank returns what the
one-device step returns: the whole last logits and tokens, the same
metrics; the loss is the mean over the global batch (each rank's mean
over its rows, averaged over the dp ranks) plus the global switch loss,
and the gradients are summed over the dp ranks.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import collectives
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.models import moe as moe_mod
from repro_torch.models import sampling as tok_sampling
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw

SHAPE_CELLS = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def cell_applicable(cfg: ModelConfig, cell: str) -> tuple[bool, str]:
    if cell == "long_500k" and not cfg.long_context:
        return False, (
            "pure full-attention arch: 500k decode requires sub-quadratic "
            "attention (skip documented in DESIGN.md Sec. 5)"
        )
    return True, ""


# ---------------------------------------------------------------------------
# abstract inputs (dry-run stand-ins): tensors on the meta device
# ---------------------------------------------------------------------------


def abstract_params(cfg: ModelConfig, train: bool = False):
    """The model's shapes (a serving model, or with `train` a training
    one), on the meta device."""
    return tfm.init_model(cfg, device="meta", train=train)


def abstract_batch(cfg: ModelConfig, seq: int, batch: int) -> dict:
    front = cfg.frontend_len if cfg.frontend else 0
    meta = dict(device="meta")
    out = {
        "tokens": torch.empty((batch, seq - front), dtype=torch.int32,
                              **meta),
        "labels": torch.empty((batch, seq), dtype=torch.int32, **meta),
    }
    if cfg.frontend:
        out["features"] = torch.empty((batch, front, tfm.FRONTEND_DIM),
                                      dtype=torch.float32, **meta)
    return out


def abstract_caches(cfg: ModelConfig, batch: int, s_max: int):
    return tfm.init_decode_caches(cfg, batch, s_max, device="meta")


def abstract_opt_state(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig):
    leaves = tfm.train_leaves(abstract_params(cfg, train=True), cfg)
    return adamw.init(leaves, opt_cfg)


# ---------------------------------------------------------------------------
# step factories
# ---------------------------------------------------------------------------


def act_partition(mesh, cfg: ModelConfig, batch_dim: int):
    """The residual stream's (B, S, d) spec: batch over DP when it
    divides (a rank then computes its rows), d over TP (the reference's
    constraint; between blocks the port keeps every d on every model
    rank, each block's split products summed over the model axis)."""
    if mesh is None:
        return None
    dp = mesh_lib.dp_axes(mesh)
    tp = mesh_lib.tp_axis(mesh)
    dp_size = math.prod(mesh_lib.axis_size(mesh, a) for a in dp)
    b_ax = (dp if len(dp) > 1 else dp[0]) if batch_dim % dp_size == 0 \
        else None
    d_ax = tp if tp and cfg.d_model % mesh_lib.axis_size(mesh, tp) == 0 \
        else None
    return (b_ax, None, d_ax)


def check_mesh(mesh) -> None:
    """Raise ValueError unless `mesh` is a mesh a step can run on: a
    `DeviceMesh` over the whole world (every rank runs the step), or a
    shape-only mesh."""
    if isinstance(mesh, mesh_lib.AbstractMesh):
        return
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise ValueError(f"{mesh!r} is not a mesh: pass a launch.mesh."
                         "make_mesh DeviceMesh, an AbstractMesh, or None")
    import torch.distributed as dist

    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a mesh of {mesh.size()} ranks in a world of "
                         f"{dist.get_world_size()}: a step runs on every "
                         "rank of the world")


def _set_moe_ctx(mesh, comm=None):
    """The MoE FFNs' mesh context for a meshed step's body (the axes, and
    the rank's Comm), restored after it."""
    tp = mesh_lib.tp_axis(mesh)
    return moe_mod.moe_mesh(mesh_lib.dp_axes(mesh), tp,
                            mesh_lib.axis_size(mesh, tp) if tp else 1, comm)


def default_opt_cfg(cfg: ModelConfig) -> adamw.AdamWConfig:
    """The reference's AdamW defaults, with bf16 moments for models past
    2e11 parameters (where float32 moments would not fit its chips)."""
    moment = "bfloat16" if cfg.n_params() > 2e11 else "float32"
    return adamw.AdamWConfig(moment_dtype=moment)


def _bind(comm: collectives.Comm, t, spec, shape):
    """A step input as the rank's shard: a DTensor's local tensor; a
    plain tensor of the global `shape` is whole (the rank takes its
    block), any other plain tensor already the rank's shard."""
    if sharding.is_dtensor(t):
        return t.to_local()
    if tuple(t.shape) == tuple(shape):
        return comm.own(t, spec)
    return t


def _compute_batch(comm, batch: dict, bspecs: dict, shapes: dict):
    """The batch in the layout a rank computes: its rows (all of them,
    gathered, when the batch is sequence-sharded)."""
    out = {}
    for k, v in batch.items():
        loc = _bind(comm, v, bspecs[k], shapes[k])
        out[k] = loc if comm.rows else comm.gather_spec(loc, bspecs[k])
    return out


def _locals(tree) -> dict:
    """The rank's shards of a model's parameters (by state-dict name) or
    of a dict of leaves."""
    named = dict(tree.named_parameters()) if hasattr(
        tree, "named_parameters") else tree
    return {n: sharding.local(p) for n, p in named.items()}


def make_train_step(cfg: ModelConfig, mesh=None,
                    opt_cfg: adamw.AdamWConfig | None = None,
                    remat_policy: str = "nothing"):
    """Without a mesh: train_step(params, opt_state, batch) -> (params,
    opt_state, metrics): `transformer.train_loss` and its gradients, then
    `adamw.update` in place.  `params` is a training model
    (`init_model(..., train=True)`), `opt_state` is `adamw.init` of its
    `transformer.train_leaves`; metrics are float32 0-dim tensors: "loss",
    "grad_norm" and "lr".

    With a mesh: (with_batch, {"params": pspecs, "opt": ospecs}), and
    `with_batch(batch_shape)` -> (the step on the rank's shards, bspecs);
    the step updates the distributed params and moments in place."""
    opt_cfg = opt_cfg or default_opt_cfg(cfg)

    def step(params, opt_state, batch):
        leaves = tfm.train_leaves(params, cfg)
        loss = tfm.train_loss(params, cfg, batch, remat_policy=remat_policy)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        _, opt_state, metrics = adamw.update(
            leaves, dict(zip(leaves, grads)), opt_state, opt_cfg,
            decays=tfm.decays)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    if mesh is None:
        return step
    check_mesh(mesh)

    # in the leaves' order (`train_leaves`: the gradient norm's sum)
    pspecs = sharding.param_specs(mesh, cfg, tfm.train_leaves(
        abstract_params(cfg, True), cfg))
    ospecs = sharding.opt_specs(mesh, cfg, abstract_opt_state(cfg, opt_cfg))
    shardings = {"params": pspecs, "opt": ospecs}

    def with_batch(batch_shape):
        bspecs = sharding.batch_specs(mesh, cfg, batch_shape)
        shapes = {k: tuple(v.shape) for k, v in batch_shape.items()}
        comm = collectives.Comm(mesh)
        comm.rows = act_partition(mesh, cfg, shapes["tokens"][0])[0] \
            is not None
        reduce = comm.reduce_sumsq(pspecs)

        def loss_and_grads(params, batch):
            """(the rank's term of the loss, its leaves' local shards
            (trainable aliases), their gradients: each leaf's own block of
            the dp-summed gradient)."""
            loc = {n: sharding.local(p).detach().requires_grad_(True)
                   for n, p in tfm.train_leaves(params, cfg).items()}
            plan = collectives.Plan(comm, cfg, loc, pspecs)
            b = _compute_batch(comm, batch, bspecs, shapes)
            with _set_moe_ctx(mesh, comm):
                loss = tfm.train_loss(params, cfg, b, shard=plan,
                                      remat_policy=remat_policy) \
                    / comm.dp_size
                grads = torch.autograd.grad(loss, list(loc.values()))
            return loss, loc, dict(zip(loc, grads))

        def mesh_step(params, opt_state, batch):
            loss, loc, grads = loss_and_grads(params, batch)
            state = {"m": _locals(opt_state["m"]),
                     "v": _locals(opt_state["v"]),
                     "step": sharding.local(opt_state["step"])}
            _, _, metrics = adamw.update(
                {n: t.detach() for n, t in loc.items()}, grads, state,
                opt_cfg, decays=tfm.decays, reduce_sumsq=reduce)
            metrics["loss"] = comm.all_reduce(loss.detach(), comm.dp)
            return params, opt_state, metrics

        mesh_step.loss_and_grads = loss_and_grads
        mesh_step.comm = comm  # its collectives' counts
        return mesh_step, bspecs

    return with_batch, shardings


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """prefill_step(params, batch) -> (last logits (B, V), caches).  With
    a mesh, `with_batch(batch_shape, extra=0)` -> that step on the rank's
    shards, the caches stored as `sharding.cache_specs` lays them out,
    with `extra` positions of decode headroom in the full-attention K/V
    (`transformer.grow_attn_caches` on the rank's rows before they are
    stored: no rank holds the whole cache)."""

    def step(params, batch):
        return tfm.prefill(params, cfg, batch)

    if mesh is None:
        return step
    check_mesh(mesh)

    pspecs = sharding.param_specs(mesh, cfg, abstract_params(cfg))

    def with_batch(batch_shape, extra: int = 0):
        bspecs = sharding.batch_specs(mesh, cfg, batch_shape)
        shapes = {k: tuple(v.shape) for k, v in batch_shape.items()}
        comm = collectives.Comm(mesh)
        comm.rows = act_partition(mesh, cfg, shapes["tokens"][0])[0] \
            is not None

        @torch.no_grad()
        def mesh_step(params, batch):
            plan = collectives.Plan(comm, cfg, _locals(params), pspecs)
            b = _compute_batch(comm, batch, bspecs, shapes)
            with _set_moe_ctx(mesh, comm):
                logits, caches = tfm.prefill(params, cfg, b, shard=plan)
            if extra:
                caches = tfm.grow_attn_caches(caches, cfg, extra)
            return comm.gather_rows(logits), plan.store_caches(mesh,
                                                               caches)

        mesh_step.comm = comm
        return mesh_step

    return with_batch


def make_serve_step(cfg: ModelConfig, mesh=None, sampler: str = "ky",
                    **sample_kw):
    """serve_step(params, tokens (B, 1), caches, pos, key) ->
    (next_tokens (B,), logits (B, V), caches).  Token sampling (the paper's
    C1+C2 pipeline for sampler='ky') happens inside the step; `sample_kw`
    goes to `sampling.sample_tokens` (the LUT-exp table a caller builds
    once: `exp_table=`, `exp_spec=`).

    With a mesh, `with_caches(cache_shape, batch)` -> (that step on the
    rank's shards, cspecs): the rank's rows run the layers, the logits
    are gathered over the dp ranks and every rank draws the whole batch
    with the same key (the one-device draw, bit for bit), so every rank
    returns the whole tokens and logits."""

    def step(params, tokens, caches, pos: int, key):
        logits, caches = tfm.decode_step(params, cfg, tokens, caches, pos)
        return (tok_sampling.sample_tokens(logits, key, sampler, **sample_kw),
                logits, caches)

    if mesh is None:
        return step
    check_mesh(mesh)

    pspecs = sharding.param_specs(mesh, cfg, abstract_params(cfg))

    def with_caches(cache_shape, batch: int):
        cspecs = sharding.cache_specs(mesh, cfg, cache_shape)
        cshapes = [{n: tuple(t.shape) for n, t in c.items()}
                   for c in cache_shape]
        comm = collectives.Comm(mesh)
        comm.rows = act_partition(mesh, cfg, batch)[0] is not None
        tok_spec = ((mesh_lib.dp_axes(mesh) if len(mesh_lib.dp_axes(mesh))
                     > 1 else mesh_lib.dp_axes(mesh)[0]) if comm.rows
                    else None, None)

        @torch.no_grad()
        def mesh_step(params, tokens, caches, pos: int, key):
            plan = collectives.Plan(comm, cfg, _locals(params), pspecs,
                                    cspecs)
            caches = [{n: _stored(comm, mesh, t, cspecs[i][n],
                                  cshapes[i][n]) for n, t in c.items()}
                      for i, c in enumerate(caches)]
            tok = _bind(comm, tokens, tok_spec, (batch, 1))
            with _set_moe_ctx(mesh, comm):
                logits, caches = tfm.decode_step(params, cfg, tok, caches,
                                                 pos, shard=plan)
            logits = comm.gather_rows(logits)
            toks = tok_sampling.sample_tokens(logits, key, sampler,
                                              **sample_kw)
            return toks, logits, caches

        mesh_step.comm = comm
        return mesh_step, cspecs

    return with_caches


def _stored(comm, mesh, t, spec, shape):
    """A cache leaf as the rank's stored shard: a DTensor as it is; a
    whole plain tensor (of the global `shape`) cut to the rank's block."""
    if sharding.is_dtensor(t):
        return t
    if tuple(t.shape) == tuple(shape):
        return sharding.wrap(mesh, comm.own(t, spec).contiguous(), shape,
                              spec)
    return t
