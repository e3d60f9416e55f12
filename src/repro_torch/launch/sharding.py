"""Logical-to-mesh sharding rules for parameters, optimizer state, batches
and decode caches (2-D TP x FSDP layout), as DTensor placements.

Port of `repro/launch/sharding.py`.  The rules are the reference's, rule
for rule:

  * TP ("model" axis): d_ff, attention heads, vocab, the expert hidden
    dim;
  * FSDP ("data" axis): the other large dimension of every big matrix,
    never across pods;
  * any rule that does not divide its dimension degrades to None.

A spec is a tuple with one entry per tensor dimension: None, an axis
name, or a tuple of axis names (major to minor), as the reference's
`PartitionSpec`.  `placements(mesh, spec)` turns it into a DTensor's
placements: an axis naming dimension `d` is `Shard(d)` on that mesh
dimension (a tuple shards `d` on each of its axes, in mesh order), every
other mesh dimension `Replicate()`.

Every rule is keyed on the leaf's name.  The port's parameter leaves are
state-dict names (`blocks.5.core.wq`); `transformer.reference_path` gives
the reference's path, whose last key names the rule and whose `"super"`
marks a scanned (layer-stacked) leaf.  A parameter is stored on the mesh
in the reference's per-layer shape (`convert.reference_leaf_shape`: the
head-split projections the port holds flattened are split back), so that
each rank holds exactly the reference's shard of it; `port_shape` is the
shape a layer reads.  Decode caches are a list with one dict a layer;
the reference stacks them over superblocks, so a rule sees the layer's
shape behind a leading axis of one.

`distribute(mesh, tree, specs)` puts a host or one-device tree on the
mesh: each rank keeps its own shard (a contiguous copy) and wraps it in
a `DTensor`.  On a shape-only mesh (`mesh.AbstractMesh`) the leaves stay
plain tensors of the rank's shard shape (on the `meta` device for a dry
run).  The compute over those shards is `launch/collectives.py`'s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import Params

Spec = tuple


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _size(mesh, axes) -> int:
    return math.prod(mesh_lib.axis_size(mesh, a) for a in axes)


def _div(mesh, axis, dim: int):
    """axis if it divides dim, else None (graceful degradation)."""
    if axis is None:
        return None
    return axis if dim % _size(mesh, _axes(axis)) == 0 else None


def param_spec(mesh, cfg: ModelConfig, name: str, shape: tuple[int, ...],
               scanned: bool) -> Spec:
    """The spec of parameter leaf `name` of the reference's `shape`
    (layer-stacked when `scanned`), as the reference's `param_spec`."""
    tp = mesh_lib.tp_axis(mesh)
    fs = mesh_lib.fsdp_axis(mesh)
    s = shape[1:] if scanned else shape
    r = len(s)
    dv = lambda axis, dim: _div(mesh, axis, dim)
    spec = None

    if name in ("wg", "wu", "wd"):
        if r == 3:  # moe expert stack (E, d, f) / (E, f, d): TP on f
            hid = 2 if name in ("wg", "wu") else 1
            other = 3 - hid
            spec = [None, None, None]
            spec[hid] = dv(tp, s[hid])
            spec[other] = dv(fs, s[other])
            spec = tuple(spec)
        elif r == 2:  # dense mlp (d, ff) / (ff, d)
            spec = ((dv(tp, s[0]), dv(fs, s[1])) if name == "wd"
                    else (dv(fs, s[0]), dv(tp, s[1])))
    elif name == "embed" and r == 2:
        spec = (dv(tp, s[0]), dv(fs, s[1]))
    elif name == "head" and r == 2:
        spec = (dv(fs, s[0]), dv(tp, s[1]))
    elif name == "frontend_proj" and r == 2:
        spec = (None, dv(tp, s[1]))
    elif name in ("wq", "wk", "wv") and r == 3:
        spec = (dv(fs, s[0]), dv(tp, s[1]), None)
    elif name == "wo" and r == 3:
        spec = (dv(tp, s[0]), None, dv(fs, s[2]))
    elif name in ("bq", "bk", "bv") and r == 2:
        spec = (dv(tp, s[0]), None)
    elif name == "router" and r == 2:
        spec = (dv(fs, s[0]), None)
    elif name == "in_proj" and r == 2:
        spec = (dv(fs, s[0]), dv(tp, s[1]))
    elif name == "conv_w" and r == 2:
        spec = (None, dv(tp, s[1]))
    elif name in ("conv_b", "dt_bias", "d_skip") and r == 1:
        spec = (dv(tp, s[0]),)
    elif name == "x_proj" and r == 2:
        spec = (dv(tp, s[0]), None)
    elif name == "dt_proj" and r == 2:
        spec = (None, dv(tp, s[1]))
    elif name == "a_log" and r == 2:
        spec = (dv(tp, s[0]), None)
    elif name in ("wi", "wf") and r == 2:
        spec = (dv(fs, s[0]), None)
    elif name == "out_proj" and r == 2:
        spec = (dv(tp, s[0]), dv(fs, s[1]))
    elif name in ("wo_gate", "out") and r == 2:
        spec = (dv(fs, s[0]), dv(tp, s[1]))
    elif name == "w_in" and r == 4:
        spec = (dv(fs, s[0]), None, None, dv(tp, s[3]))
    elif name == "r" and r == 4:
        spec = (None, dv(tp, s[1]), None, None)

    if spec is None:  # norms, small biases, unknown leaves: replicated
        spec = (None,) * r
    if scanned:
        spec = (None,) + tuple(spec)
    return tuple(spec)


def _named(params) -> dict[str, torch.Tensor]:
    """{state-dict name: leaf} of a model or of such a dict."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def leaf_rule(cfg: ModelConfig, name: str) -> tuple[str, bool]:
    """(the rule's leaf name, scanned) of state-dict name `name`."""
    path = tfm.reference_path(name, cfg)
    rule = next(k for k in reversed(path) if isinstance(k, str))
    return rule, path[0] == "super"


def storage_shape(cfg: ModelConfig, name: str, shape) -> tuple[int, ...]:
    """The shape a parameter is stored on the mesh in: the reference's
    per-layer shape."""
    return convert.reference_leaf_shape(name, cfg, tuple(shape))


def port_shape(cfg: ModelConfig, name: str, shape) -> tuple[int, ...]:
    """The shape a layer reads a parameter in, from its storage shape."""
    return convert.port_leaf_shape(name, cfg, tuple(shape))


def param_specs(mesh, cfg: ModelConfig, params) -> dict[str, Spec]:
    """{state-dict name: spec of the leaf in its `storage_shape`} of a
    model (or of {name: leaf}); a block leaf's spec is the reference's
    for its stacked leaf without the leading layer axis."""
    out = {}
    for name, leaf in _named(params).items():
        rule, scanned = leaf_rule(cfg, name)
        shape = storage_shape(cfg, name, leaf.shape)
        spec = param_spec(mesh, cfg, rule, (1,) * scanned + shape, scanned)
        out[name] = spec[1:] if scanned else spec
    return out


def opt_specs(mesh, cfg: ModelConfig, opt_state) -> dict:
    """Optimizer moments shard like their parameters; step is
    replicated."""
    return {"m": param_specs(mesh, cfg, opt_state["m"]),
            "v": param_specs(mesh, cfg, opt_state["v"]),
            "step": ()}


def _dp_spec(mesh):
    dp = mesh_lib.dp_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


def batch_specs(mesh, cfg: ModelConfig, batch_shape) -> dict[str, Spec]:
    """Batch (tokens, labels, features) over the DP axes; if the global
    batch is too small (long-context cells), the sequence axis
    instead."""
    dp_size = _size(mesh, mesh_lib.dp_axes(mesh))
    out = {}
    for k, v in batch_shape.items():
        b, s, nd = v.shape[0], v.shape[1], len(v.shape)
        if b % dp_size == 0:
            out[k] = (_dp_spec(mesh),) + (None,) * (nd - 1)
        elif s % dp_size == 0 and nd >= 2:
            out[k] = (None, _dp_spec(mesh)) + (None,) * (nd - 2)
        else:
            out[k] = (None,) * nd
    return out


def _cache_spec(mesh, name: str, s: tuple[int, ...]) -> Spec:
    """The reference's `cache_specs` rule for a stacked leaf of shape
    `s` (a leading superblock axis)."""
    dp = mesh_lib.dp_axes(mesh)
    tp = mesh_lib.tp_axis(mesh)
    dp_size = _size(mesh, dp)
    bspec = _dp_spec(mesh) if s[1] % dp_size == 0 else None
    rest = [None] * (len(s) - 2)
    if name in ("k", "v") and len(s) == 5:
        # (L, B, S_cache, KVH, HD): sequence over model (+data if free)
        seq_axes = tuple(a for a in ((tp,) if tp else ())
                         if s[2] % mesh_lib.axis_size(mesh, a) == 0)
        if bspec is None:
            both = tuple(list(dp) + [tp]) if tp else dp
            if s[2] % _size(mesh, both) == 0:
                rest[0] = both
            elif seq_axes:
                rest[0] = seq_axes[0]
        elif seq_axes:
            rest[0] = seq_axes[0]
    elif name in ("conv", "ssm") and len(s) == 4:
        # mamba conv (L, B, K-1, di) / ssm (L, B, di, n)
        di_dim = 3 if name == "conv" else 2
        if tp and s[di_dim] % mesh_lib.axis_size(mesh, tp) == 0:
            rest[di_dim - 2] = tp
    elif name in ("C", "n", "m", "c", "h") and tp:
        # mlstm/slstm states (L, B, H, ...): shard trailing head_dim
        for dim in range(len(s) - 1, 1, -1):
            if s[dim] % mesh_lib.axis_size(mesh, tp) == 0 and dim >= 3:
                rest[dim - 2] = tp
                break
    return (None, bspec, *rest)


def cache_specs(mesh, cfg: ModelConfig, cache_shape) -> list[dict]:
    """Decode caches (one dict a layer): batch over DP when divisible; the
    long axis (KV sequence, d_inner, head_dim) over TP.  Leaf names:
    attention k/v (B, S, KVH, HD); mamba conv/ssm; mlstm C/n/m; slstm
    c/n/h/m."""
    return [{name: _cache_spec(mesh, name, (1, *leaf.shape))[1:]
             for name, leaf in layer.items()} for layer in cache_shape]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's `NamedSharding`)."""
    mesh: Any
    spec: Spec


def to_named(mesh, specs):
    """The tree of specs as `NamedSharding`s on `mesh`."""
    if isinstance(specs, dict):
        return {k: to_named(mesh, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [to_named(mesh, v) for v in specs]
    return NamedSharding(mesh, specs)


def placements(mesh, spec: Spec) -> list:
    """The DTensor placements of `spec` on `mesh`, one per mesh
    dimension."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        where = [names.index(a) for a in _axes(entry)]
        if where != sorted(where):
            raise ValueError(f"spec {spec}: axes {entry} are not in the "
                             f"mesh's order {names}")
        for m in where:
            out[m] = Shard(dim)
    return out


def coordinates(mesh) -> dict[str, int]:
    """This rank's index along each axis."""
    return dict(zip(mesh.mesh_dim_names,
                    (int(c) for c in mesh.get_coordinate())))


def shard_slices(mesh, shape, spec: Spec, coords=None) -> tuple[slice, ...]:
    """The rank's block of a tensor of `shape` laid out by `spec`: a
    dimension over axes (a1, ..., ak) splits into their product of equal
    chunks, chunk c1 * n2 * ... + ck at coordinates (c1, ..., ck)."""
    coords = coordinates(mesh) if coords is None else coords
    out = []
    for dim, n in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        idx, parts = 0, 1
        for a in _axes(entry):
            size = mesh_lib.axis_size(mesh, a)
            idx, parts = idx * size + coords[a], parts * size
        if n % parts:
            raise ValueError(f"spec {spec}: dimension {dim} of {tuple(shape)}"
                             f" does not split {parts} ways")
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def local_shape(mesh, shape, spec: Spec) -> tuple[int, ...]:
    return tuple(s.stop - s.start for s in shard_slices(mesh, shape, spec))


def shard_bytes(mesh, shape, spec: Spec, dtype: torch.dtype) -> int:
    """Bytes of one rank's shard."""
    return math.prod(local_shape(mesh, shape, spec)) * dtype.itemsize


def is_live(mesh) -> bool:
    return not isinstance(mesh, mesh_lib.AbstractMesh)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """The rank's shard of a leaf: a DTensor's local tensor (sharing its
    storage), a plain tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def wrap(mesh, shard: torch.Tensor, shape, spec: Spec) -> torch.Tensor:
    """A rank's shard as a DTensor of global `shape` (a plain tensor on a
    shape-only mesh)."""
    if not is_live(mesh):
        return shard
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(shard, mesh, placements(mesh, spec),
                              run_check=False, shape=shape, stride=stride)


def shard_leaf(mesh, t: torch.Tensor, spec: Spec, shape=None,
               device=None) -> torch.Tensor:
    """The rank's shard of whole tensor `t` (viewed as `shape`, the
    storage shape), copied to `device` (t's by default), as a DTensor."""
    shape = tuple(t.shape) if shape is None else tuple(shape)
    t = t.reshape(shape)
    if t.device.type == "meta":
        part = torch.empty(local_shape(mesh, shape, spec), dtype=t.dtype,
                           device="meta")
    else:
        part = t[shard_slices(mesh, shape, spec)].to(
            device or t.device, copy=True).contiguous()
    return wrap(mesh, part, shape, spec)


def distribute(mesh, tree, specs, *, cfg: ModelConfig | None = None,
               device=None):
    """A host or one-device tree on the mesh, each leaf the rank's shard
    as a DTensor: a model (`Params`, its specs `param_specs`) as a model
    of the same structure, trainable as it was; a dict or list of tensors
    (optimizer state, batch, caches) leaf for leaf.  With `cfg`, a leaf
    keyed by a parameter's name (a model's, or an AdamW moment's) is
    stored in its `storage_shape` (a model needs `cfg`).  `device` moves
    each shard (the leaves' own by default)."""
    if isinstance(tree, nn.Module):
        if cfg is None:
            raise ValueError("distribute a model with its cfg")
        return _distribute_module(mesh, cfg, tree, specs, device)
    if isinstance(tree, dict):
        return {k: distribute(mesh, v, specs[k], cfg=cfg, device=device)
                if isinstance(v, (dict, list, tuple)) else shard_leaf(
                    mesh, v, specs[k], storage_shape(cfg, k, v.shape)
                    if cfg is not None else None, device)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [distribute(mesh, v, s, cfg=cfg, device=device)
                for v, s in zip(tree, specs)]
    return shard_leaf(mesh, tree, specs, device=device)


def _distribute_module(mesh, cfg: ModelConfig, model: nn.Module,
                       specs: dict, device):
    """`distribute` of a model: its structure rebuilt, each parameter the
    rank's shard of its storage shape.  Products accumulate in float32
    from here on, as a built model's do (`layers.accumulate_in_float32`)."""
    from repro_torch.models import layers

    layers.accumulate_in_float32()

    def build(mod, prefix):
        if isinstance(mod, nn.ModuleList):
            return nn.ModuleList(build(m, f"{prefix}{i}.")
                                 for i, m in enumerate(mod))
        entries = {}
        for name, p in mod._parameters.items():
            full = prefix + name
            entries[name] = shard_leaf(
                mesh, p.detach(), specs[full],
                storage_shape(cfg, full, p.shape), device)
        for name, child in mod._modules.items():
            entries[name] = build(child, f"{prefix}{name}.")
        out = Params(**entries)
        for name, p in mod._parameters.items():
            out._parameters[name].requires_grad_(p.requires_grad)
        return out

    return build(model, "")


def shard_like(ref: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """`part` (a rank's shard) laid out as DTensor `ref` is (a plain
    `part` when `ref` is plain: a shape-only mesh)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(ref, DTensor):
        return part
    return DTensor.from_local(part, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def mesh_device(mesh) -> torch.device:
    """The device of this rank's tensors on a live mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def load_whole(leaf: torch.Tensor, value) -> None:
    """Write this rank's block of a whole value (a host array or tensor,
    in the leaf's global shape or the shape a layer reads: the same
    elements in order) into `leaf`, a DTensor or a plain tensor, cast to
    its type."""
    from torch.distributed.tensor import DTensor

    whole = torch.as_tensor(value).reshape(leaf.shape)
    with torch.no_grad():
        if isinstance(leaf, DTensor):
            from repro_torch.launch import collectives

            spec = collectives.spec_of(leaf)
            part = whole[shard_slices(leaf.device_mesh, leaf.shape, spec)]
            leaf.to_local().copy_(part)
        else:
            leaf.copy_(whole)
