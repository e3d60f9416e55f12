"""Gradient-compression collectives over a mesh axis (port of
`repro/optim/compression.py`).

Two mechanisms, both honest about what moves over the wire:

* `psum_bf16`: reduce in bf16 instead of float32, halving the
  data-parallel all-reduce's bytes (error ~1e-3 relative).
* `psum_int8`: per-tensor-scaled int8 quantization with error feedback:
  each rank quantizes (grad + residual) with a scale common to the axis
  (an all-reduce MAX of the ranks' scales), the int8 payloads are summed
  as int32 (the wire format of a ring all-reduce is the int8 payload on
  the first hop and grows toward int32: a ~2-4x saving, not 4x), and the
  quantization residual is returned for the next step, so the bias
  telescopes away.

The reference's functions run inside `shard_map`, where an axis name
finds its devices; here `axis_name` names an axis of a `DeviceMesh`
(`launch/mesh.make_mesh`) and the collective runs over
`mesh.get_group(axis_name)`, every rank of the group calling it.  Trees
are the port's parameter trees: nested dicts of tensors, as
`optim/adamw.py` walks them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _local_scale(x: torch.Tensor) -> torch.Tensor:
    """max |x| / 127 + 1e-20, a float32 0-dim tensor."""
    return x.abs().max() / _f32(127.0, x) + _f32(1e-20, x)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def psum_bf16(x: torch.Tensor, axis_name: str, *, mesh) -> torch.Tensor:
    y = x.to(torch.bfloat16, copy=True)
    dist.all_reduce(y, group=mesh.get_group(axis_name))
    return y.to(x.dtype)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = _local_scale(x)
    return _quantize(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def psum_int8(
    x: torch.Tensor, axis_name: str, residual: torch.Tensor | None = None,
    *, mesh,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce.  Returns (reduced, new_residual).

    A common scale (the MAX over the group's ranks) keeps the integer sums
    commensurable; the local quantization error is returned so the caller
    can add it to the next step's gradient (1-bit-Adam-style
    telescoping)."""
    group = mesh.get_group(axis_name)
    if residual is not None:
        x = x + residual.to(x.dtype)
    scale = _local_scale(x)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = _quantize(x, scale)
    # x - q * scale with one rounding, as XLA's fused multiply-add gives
    # it: in float64 the product of an int8 and a float32 is exact, and so
    # is the difference (x / (q * scale) lies in [1/2, 3/2] where q != 0)
    new_residual = (x.double() - q.double() * scale.double()).to(
        torch.float32)
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    return total.to(torch.float32) * scale, new_residual


def _leaves(tree, prefix=()):
    """(path, tensor) of a nested dict of tensors, in its order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_psum_compressed(grads, axis_name: str, mode: str = "none",
                         residuals=None, *, mesh):
    """Apply the selected compression to every leaf.  Returns
    (reduced_grads, new_residuals); the residuals are None unless
    mode is "int8"."""
    if mode == "none":
        def plain(_, g):
            g = g.clone()
            dist.all_reduce(g, group=mesh.get_group(axis_name))
            return g

        return _map(grads, plain), None
    if mode == "bf16":
        return _map(grads, lambda _, g: psum_bf16(g, axis_name,
                                                  mesh=mesh)), None
    if mode == "int8":
        outs = {path: psum_int8(
            g, axis_name, None if residuals is None else _at(residuals, path),
            mesh=mesh) for path, g in _leaves(grads)}
        return (_map(grads, lambda path, _: outs[path][0]),
                _map(grads, lambda path, _: outs[path][1]))
    raise ValueError(mode)


def init_residuals(grads):
    """float32 zeros shaped like every leaf of `grads`."""
    return _map(grads, lambda _, g: torch.zeros(g.shape, dtype=torch.float32,
                                                device=g.device))
