"""Carry a reference model and key across to the port.

The tests hand the same compiled Bayes net and the same PRNG key to both
packages.  Everything crosses as numpy arrays, so nothing here imports the
reference package or JAX:

  * `from_reference_bn(arrays, meta)` builds a port `CompiledBayesNet` from
    the leaves of a reference `CompiledBayesNet` (`reference_bn_arrays`
    reads them off the reference object by attribute);
  * `key_from_reference(key_data)` takes `jax.random.key_data(k)`;
  * `lm_params_from_reference(tree, cfg)` builds the port's language model
    from the reference's `init_model` parameters (`train=True`: a training
    model), and `lm_tree_from_port(named, cfg)` carries the port's leaves
    (parameters, gradients or moments, by state-dict name) back into the
    reference's tree layout.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import prng
from repro_torch.core.bayesnet import ColorGroup, CompiledBayesNet
from repro_torch.core.interp import LUTSpec
from repro_torch.models import transformer as tfm
from repro_torch.models import layers
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


def lm_params_from_reference(tree, cfg, device="cuda",
                             train: bool = False) -> Params:
    """The port's model (`transformer.init_model`'s tree) holding the
    weights of the reference's `init_model(key, cfg)` tree, given as
    nested dicts of numpy arrays.  The reference stacks its layers over
    the `n_super` axis of `"super"` (layer i = slot i % period of
    superblock i // period); its head-split projections, (d, H, hd)
    `wq`/`wk`/`wv`, (H, hd, d) `wo` and sLSTM's (d, 4, H, hd) `w_in`,
    become the port's 2-D matrices, their biases vectors.  Weights the
    reference casts to the activation type at every use are cast once to
    `cfg.dtype`; those it reads in float32 (the norms, Mamba's `a_log`
    and `d_skip`, sLSTM's `r`) stay float32, and Mamba's `dt_bias` keeps
    the parameter type.  Products accumulate in float32 from here on
    (`layers.accumulate_in_float32`).

    With `train`, a training model (`transformer.init_model(...,
    train=True)`'s types): every leaf in the reference's own type, the
    parameter type (Mamba's `a_log` and `d_skip` float32), trainable."""
    layers.accumulate_in_float32()
    dev = device_mod.resolve(device)
    pdt = getattr(torch, cfg.param_dtype)
    dt = pdt if train else cfg.act_dtype
    keep = {"a_log": torch.float32, "d_skip": torch.float32,
            "r": pdt if train else torch.float32, "dt_bias": pdt}

    def t(x, dtype=dt, shape=None):
        x = torch.tensor(np.asarray(x, np.float32), device=dev)
        return (x if shape is None else x.reshape(shape)).to(dtype)

    def core(c, kind):
        d = cfg.d_model
        flat = {"wq": (d, -1), "wk": (d, -1), "wv": (d, -1), "w_in": (d, -1),
                "bq": (-1,), "bk": (-1,), "bv": (-1,), "b": (-1,)}
        if kind in tfm.ATTN_KINDS:
            flat["wo"] = (-1, d)
        return Params(**{name: t(w, keep.get(name, dt), flat.get(name))
                         for name, w in c.items()})

    def ffn(f):
        if "shared" in f:
            f = {**f, "shared": Params(**{k: t(w)
                                          for k, w in f["shared"].items()})}
        return Params(**{k: w if isinstance(w, Params) else t(w)
                         for k, w in f.items()})

    period = len(cfg.pattern)
    norm = pdt if train else torch.float32
    blocks = []
    for i in range(cfg.n_layers):
        b = {k: _leaf(v, i // period)
             for k, v in tree["super"][f"b{i % period}"].items()}
        blk = {"norm1": t(b["norm1"], norm),
               "core": core(b["core"], cfg.pattern[i % period])}
        if "ffn" in b:
            blk["norm2"] = t(b["norm2"], norm)
            blk["ffn"] = ffn(b["ffn"])
        blocks.append(Params(**blk))
    p = {"embed": t(tree["embed"]), "blocks": torch.nn.ModuleList(blocks),
         "final_norm": t(tree["final_norm"], norm)}
    for name in ("head", "frontend_proj"):
        if name in tree:
            p[name] = t(tree[name])
    return Params(**p).requires_grad_(train)


def _reference_shape(name: str, kind: str | None, cfg) -> tuple | None:
    """The reference's shape of a port leaf the port holds flattened (None
    where the two agree): the head-split projections and biases."""
    d, hd, h = cfg.d_model, cfg.hd, cfg.n_heads
    if kind in tfm.ATTN_KINDS:
        return {"wq": (d, -1, hd), "wk": (d, -1, hd), "wv": (d, -1, hd),
                "wo": (-1, hd, d), "bq": (-1, hd), "bk": (-1, hd),
                "bv": (-1, hd)}.get(name)
    if kind == "mlstm":
        return {"wq": (d, h, hd), "wk": (d, h, hd),
                "wv": (d, h, hd)}.get(name)
    if kind == "slstm":
        return {"w_in": (d, 4, h, hd), "b": (4, h, hd)}.get(name)
    return None


def reference_leaf_shape(name: str, cfg, shape) -> tuple:
    """The reference's per-layer shape of the port leaf `name` (a
    state-dict name) of `shape`: the head-split projections and biases
    the port holds flattened, split back; every other leaf's own shape."""
    path = tfm.reference_path(name, cfg)
    keys = path[2:-1] if path[0] == "super" else path
    kind = (cfg.pattern[int(path[1][1:])]
            if path[0] == "super" and keys[0] == "core" else None)
    ref = _reference_shape(keys[-1], kind, cfg)
    if ref is None:
        return tuple(shape)
    return tuple(torch.empty(tuple(shape), device="meta").reshape(ref).shape)


def port_leaf_shape(name: str, cfg, ref_shape) -> tuple:
    """The inverse of `reference_leaf_shape`: the port's shape of leaf
    `name` given the reference's per-layer shape (projections flattened
    behind d_model, an attention `wo` in front of it, biases to
    vectors)."""
    ref_shape = tuple(ref_shape)
    path = tfm.reference_path(name, cfg)
    keys = path[2:-1] if path[0] == "super" else path
    kind = (cfg.pattern[int(path[1][1:])]
            if path[0] == "super" and keys[0] == "core" else None)
    if _reference_shape(keys[-1], kind, cfg) is None:
        return ref_shape
    n = int(np.prod(ref_shape))
    if keys[-1] in ("bq", "bk", "bv", "b"):
        return (n,)
    if keys[-1] == "wo":
        return (n // ref_shape[-1], ref_shape[-1])
    return (ref_shape[0], n // ref_shape[0])


def lm_tree_from_port(named: dict, cfg) -> dict:
    """The port's leaves by state-dict name (`model.named_parameters()`,
    or gradients or moments under the same names) as the reference's tree
    of float32 numpy arrays: a block leaf stacked over the superblocks
    under `super/b<slot>`, the head-split matrices reshaped back."""
    out: dict = {}
    stacks: dict = {}
    for name, leaf in named.items():
        arr = leaf.detach().float().cpu().numpy()
        path = tfm.reference_path(name, cfg)
        if path[0] != "super":
            out[name] = arr
            continue
        slot, keys, i = int(path[1][1:]), path[2:-1], path[-1]
        kind = cfg.pattern[slot] if keys[0] == "core" else None
        shape = _reference_shape(keys[-1], kind, cfg)
        stacks.setdefault(path[1:-1], {})[i] = (
            arr if shape is None else arr.reshape(shape))
    for path, layers_ in stacks.items():
        node = out.setdefault("super", {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([layers_[i] for i in range(cfg.n_super)])
    return out


def _leaf(tree, i: int):
    """Superblock i of a stacked sub-tree."""
    if isinstance(tree, dict):
        return {k: _leaf(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
