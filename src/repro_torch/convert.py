"""Carry a reference model and key across to the port.

The tests hand the same compiled Bayes net and the same PRNG key to both
packages.  Everything crosses as numpy arrays, so nothing here imports the
reference package or JAX:

  * `from_reference_bn(arrays, meta)` builds a port `CompiledBayesNet` from
    the leaves of a reference `CompiledBayesNet` (`reference_bn_arrays`
    reads them off the reference object by attribute);
  * `key_from_reference(key_data)` takes `jax.random.key_data(k)`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import prng
from repro_torch.core.bayesnet import ColorGroup, CompiledBayesNet
from repro_torch.core.interp import LUTSpec

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
