"""Step builders for training (loss, gradients and the AdamW update) and
serving (prefill, and decode with the token draw).

Port of `repro/launch/steps.py`'s `default_opt_cfg`, `make_train_step`,
`make_prefill_step` and `make_serve_step` for one device (`mesh=None`).
The reference jits each step; PyTorch runs eagerly, so a step here is a
plain function.  A mesh raises `NotImplementedError`: the LM mesh
(sharding as DTensor placements over `launch/mesh.py`'s meshes) is
ROADMAP §1 item 2.  The sampler runs over a mesh of ranks already
(`core/distributed.RankMesh`).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sampling as tok_sampling
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded LM steps are not ported: the LM mesh is ROADMAP §1 "
            "item 2 (the sampler's mesh over ranks is "
            "core.distributed.RankMesh); pass mesh=None"
        )


def default_opt_cfg(cfg: ModelConfig) -> adamw.AdamWConfig:
    """The reference's AdamW defaults, with bf16 moments for models past
    2e11 parameters (where float32 moments would not fit its chips)."""
    moment = "bfloat16" if cfg.n_params() > 2e11 else "float32"
    return adamw.AdamWConfig(moment_dtype=moment)


def make_train_step(cfg: ModelConfig, mesh=None,
                    opt_cfg: adamw.AdamWConfig | None = None,
                    remat_policy: str = "nothing"):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): `transformer.train_loss` and its gradients, then
    `adamw.update` in place.  `params` is a training model
    (`init_model(..., train=True)`), `opt_state` is `adamw.init` of its
    `transformer.train_leaves`; metrics are float32 0-dim tensors: "loss",
    "grad_norm" and "lr"."""
    _no_mesh(mesh)
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

    return step


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """prefill_step(params, batch) -> (last logits (B, V), caches)."""
    _no_mesh(mesh)

    def step(params, batch):
        return tfm.prefill(params, cfg, batch)

    return step


def make_serve_step(cfg: ModelConfig, mesh=None, sampler: str = "ky",
                    **sample_kw):
    """serve_step(params, tokens (B, 1), caches, pos, key) ->
    (next_tokens (B,), logits (B, V), caches).  Token sampling (the paper's
    C1+C2 pipeline for sampler='ky') happens inside the step; `sample_kw`
    goes to `sampling.sample_tokens` (the LUT-exp table a caller builds
    once: `exp_table=`, `exp_spec=`)."""
    _no_mesh(mesh)

    def step(params, tokens, caches, pos: int, key):
        logits, caches = tfm.decode_step(params, cfg, tokens, caches, pos)
        return (tok_sampling.sample_tokens(logits, key, sampler, **sample_kw),
                logits, caches)

    return step
