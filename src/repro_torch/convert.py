"""Carry a reference model and key across to the port.

The tests hand the same compiled Bayes net and the same PRNG key to both
packages.  Everything crosses as numpy arrays, so nothing here imports the
reference package or JAX:

  * `from_reference_bn(arrays, meta)` builds a port `CompiledBayesNet` from
    the leaves of a reference `CompiledBayesNet` (`reference_bn_arrays`
    reads them off the reference object by attribute);
  * `key_from_reference(key_data)` takes `jax.random.key_data(k)`;
  * `lm_params_from_reference(tree, cfg)` builds the port's language model
    from the reference's `init_model` parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import prng
from repro_torch.core.bayesnet import ColorGroup, CompiledBayesNet
from repro_torch.core.interp import LUTSpec
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import Params

GROUP_FIELDS = ("nodes", "cards", "base", "stride", "scope_var", "is_self")
NET_FIELDS = ("log_flat", "cards", "init_vals", "free_mask", "exp_table")


def reference_bn_arrays(cbn) -> tuple[dict[str, np.ndarray], dict]:
    """(arrays, meta) of a compiled net of either package: arrays keyed
    `log_flat`, `cards`, `init_vals`, `free_mask`, `exp_table` and
    `groups/<i>/<field>`; meta holds the static fields.  Reads attributes
    only, so it works on the reference's jax arrays through `np.asarray`."""

    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    arrays = {f: host(getattr(cbn, f)) for f in NET_FIELDS}
    for i, g in enumerate(cbn.groups):
        for f in GROUP_FIELDS:
            arrays[f"groups/{i}/{f}"] = host(getattr(g, f))
    spec = cbn.exp_spec
    meta = {
        "max_card": int(cbn.max_card),
        "n_nodes": int(cbn.n_nodes),
        "colors": tuple(int(c) for c in cbn.colors),
        "exp_spec": (float(spec.x0), float(spec.dx), int(spec.size)),
        "name": str(cbn.name),
        "n_groups": len(cbn.groups),
    }
    return arrays, meta


def from_reference_bn(
    arrays: dict[str, np.ndarray], meta: dict, device="cuda"
) -> CompiledBayesNet:
    """A port `CompiledBayesNet` on `device` from `reference_bn_arrays`'s
    (arrays, meta)."""
    dev = device_mod.resolve(device)

    def t(name, dtype):
        return torch.tensor(np.asarray(arrays[name]).astype(dtype),
                            device=dev)

    groups = [
        ColorGroup(
            **{f: t(f"groups/{i}/{f}", np.int32)
               for f in GROUP_FIELDS if f != "is_self"},
            is_self=t(f"groups/{i}/is_self", bool),
        )
        for i in range(meta["n_groups"])
    ]
    x0, dx, size = meta["exp_spec"]
    return CompiledBayesNet(
        log_flat=t("log_flat", np.float32),
        groups=groups,
        cards=t("cards", np.int32),
        init_vals=t("init_vals", np.int32),
        free_mask=t("free_mask", bool),
        max_card=int(meta["max_card"]),
        n_nodes=int(meta["n_nodes"]),
        colors=tuple(meta["colors"]),
        exp_table=t("exp_table", np.float32).reshape(-1),
        exp_spec=LUTSpec(x0=float(x0), dx=float(dx), size=int(size)),
        name=meta["name"],
    )


def key_from_reference(key_data: np.ndarray) -> prng.Key:
    """`jax.random.key_data(k)` (two uint32 words) -> `prng.Key`."""
    k1, k2 = (int(w) for w in np.asarray(key_data, np.uint32).reshape(2))
    return prng.Key(k1, k2)


def lm_params_from_reference(tree, cfg, device="cuda") -> Params:
    """The port's model (`transformer.init_model`'s tree) holding the
    weights of the reference's `init_model(key, cfg)` tree, given as
    nested dicts of numpy arrays.  The reference stacks its layers over
    the `n_super` axis of `"super"` (layer i = slot i % period of
    superblock i // period); its (d, H, hd) `wq`/`wk`/`wv` and (H, hd, d)
    `wo` become the port's (d, H * hd) and (H * hd, d) matrices.  Weights
    the reference casts to the activation type at every use are cast once
    to `cfg.dtype`; the norm weights stay float32."""
    tfm.check_supported(cfg)
    dev = device_mod.resolve(device)
    dt = cfg.act_dtype

    def t(x, dtype=dt, shape=None):
        x = torch.tensor(np.asarray(x, np.float32), device=dev)
        return (x if shape is None else x.reshape(shape)).to(dtype)

    period = len(cfg.pattern)
    blocks = []
    for i in range(cfg.n_layers):
        b = {k: _leaf(v, i // period)
             for k, v in tree["super"][f"b{i % period}"].items()}
        d = cfg.d_model
        core = {
            "wq": t(b["core"]["wq"], shape=(d, -1)),
            "wk": t(b["core"]["wk"], shape=(d, -1)),
            "wv": t(b["core"]["wv"], shape=(d, -1)),
            "wo": t(b["core"]["wo"], shape=(-1, d)),
        }
        for name in ("bq", "bk", "bv"):
            if name in b["core"]:
                core[name] = t(b["core"][name], shape=(-1,))
        blk = {"norm1": t(b["norm1"], torch.float32), "core": Params(**core)}
        if "ffn" in b:
            blk["norm2"] = t(b["norm2"], torch.float32)
            blk["ffn"] = Params(**{k: t(b["ffn"][k])
                                   for k in ("wg", "wu", "wd")})
        blocks.append(Params(**blk))
    p = {"embed": t(tree["embed"]), "blocks": torch.nn.ModuleList(blocks),
         "final_norm": t(tree["final_norm"], torch.float32)}
    for name in ("head", "frontend_proj"):
        if name in tree:
            p[name] = t(tree[name])
    return Params(**p)


def _leaf(tree, i: int):
    """Superblock i of a stacked sub-tree."""
    if isinstance(tree, dict):
        return {k: _leaf(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
