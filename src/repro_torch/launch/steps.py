"""Step builders for serving (prefill, and decode with the token draw).

Port of `repro/launch/steps.py`'s `make_prefill_step` and
`make_serve_step` for one device (`mesh=None`).  The reference jits each
step; PyTorch runs eagerly, so a step here is a plain function.  A mesh
raises `NotImplementedError`: meshes over several cards are ROADMAP §1
item 4.  `make_train_step` waits for the training slice (§1 item 3).
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sampling as tok_sampling
from repro_torch.models import transformer as tfm


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded LM steps are not ported (ROADMAP §1 item 4: meshes "
            "over several cards); pass mesh=None"
        )


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
