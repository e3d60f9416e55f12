"""Checkpoints: an npz of leaves and a JSON manifest, written atomically.

Port of `repro/checkpoint/checkpoint.py`, in its format: checkpoint
`step` is the directory `<base>/ckpt_<step:010d>/` holding `manifest.json`
(the step, the caller's `extra` and, per leaf, its npz key, path, shape
and type) and `shard_host0.npz`.  A tree is nested dicts of tensors (a
training run saves `{"params": <state-dict names>, "opt": {"m", "v",
"step"}}`); a leaf's path is its keys joined by "/", dict keys sorted at
every level as the reference's pytree flattening sorts them, so the
reference's `restore(like=None)` reads a port checkpoint under the same
paths.

* atomic — the files go to `<base>/tmp.<step>`, renamed into place, so a
  preemption mid-write never leaves a partial checkpoint;
* exact — every leaf is stored in its own type but bf16, which numpy has
  no type for: a bf16 leaf is stored widened to float32 (exactly) and
  the manifest keeps "bfloat16", to which `restore` rounds it back;
* rotated — `rotate` keeps the last `keep_last`;
* elastic — a tree on a mesh of ranks (DTensor leaves) is saved whole:
  for each leaf in turn every rank sends its shard to rank 0, which
  writes it (`save` with the model's `cfg` writes a parameter or moment
  in the shape the one-device model holds it), so the checkpoint is the
  one-device one; `restore` returns host arrays, read leaf by leaf, which
  a caller puts on whatever mesh exists now (`launch/sharding.
  load_whole`).
"""

from __future__ import annotations

import collections.abc
import contextlib
import json
import os
import shutil
import zipfile

import numpy as np
import torch

MANIFEST = "manifest.json"


def _flatten(tree, prefix: str = ""):
    """[(path, leaf)] of nested dicts, keys sorted at every level."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flatten(tree[key], f"{prefix}{key}/")
        return out
    return [(prefix[:-1], tree)]


def _host(leaf) -> tuple[np.ndarray, str]:
    """(the array the npz stores, the leaf's type name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _whole(path: str, leaf, cfg):
    """A mesh leaf gathered whole on rank 0 (every rank sends its shard;
    None elsewhere), in the shape the one-device model holds it; any
    other leaf itself."""
    from torch.distributed.tensor import DTensor

    if not isinstance(leaf, DTensor):
        return leaf
    from repro_torch.launch import collectives, sharding

    whole = collectives.to_rank0(leaf)
    if whole is not None and cfg is not None:
        whole = whole.reshape(sharding.port_shape(cfg, path.split("/")[-1],
                                                  whole.shape))
    return whole


def save(base_dir: str, step: int, tree, extra: dict | None = None,
         cfg=None) -> str:
    """Atomically write checkpoint `step`.  Returns the final directory.
    A tree on a mesh is saved by every rank together (rank 0 writes;
    they meet at a barrier after)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    leaves = _flatten(tree)
    meshed = any(isinstance(leaf, DTensor) for _, leaf in leaves)
    writer = not meshed or dist.get_rank() == 0
    tmp = os.path.join(base_dir, f"tmp.{step}")
    final = os.path.join(base_dir, f"ckpt_{step:010d}")
    if writer:
        os.makedirs(base_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    # the npz np.savez writes, one leaf at a time (a mesh's leaves are
    # gathered one by one, never all at once)
    with (zipfile.ZipFile(os.path.join(tmp, "shard_host0.npz"), "w",
                          allowZip64=True) if writer
          else contextlib.nullcontext()) as zf:
        for i, (path, leaf) in enumerate(leaves):
            key = f"leaf_{i:05d}"
            whole = _whole(path, leaf, cfg)
            if not writer:
                continue
            arr, dtype = _host(whole)
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr),
                                          allow_pickle=False)
            manifest["leaves"].append({"key": key, "path": path,
                                       "shape": list(arr.shape),
                                       "dtype": dtype})
    if writer:
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    if meshed:
        dist.barrier()
    return final


def _steps(base_dir: str, complete: bool) -> list[int]:
    if not os.path.isdir(base_dir):
        return []
    return sorted(
        int(d.split("_")[1]) for d in os.listdir(base_dir)
        if d.startswith("ckpt_") and (not complete or os.path.isfile(
            os.path.join(base_dir, d, MANIFEST))))


def latest_step(base_dir: str) -> int | None:
    """The last complete checkpoint's step, None when there is none."""
    steps = _steps(base_dir, complete=True)
    return steps[-1] if steps else None


class _Stored(collections.abc.Mapping):
    """{path: numpy array as stored}, each array read from the npz when
    it is asked for (a mesh's ranks restore leaf by leaf, never holding
    the whole checkpoint at once)."""

    def __init__(self, npz: str, keys: dict):
        self._npz, self._keys = npz, keys

    def __getitem__(self, path: str) -> np.ndarray:
        with np.load(self._npz) as data:
            return data[self._keys[path]]

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)


def restore(base_dir: str, step: int, like=None):
    """Load checkpoint `step`.  Without `like`: (manifest, {path: numpy
    array as stored}, a mapping that reads each array when asked).  With
    `like` (a tree of tensors), (manifest, the same tree of new tensors,
    each of `like`'s shape checked, type and device, bf16 leaves rounded
    back from their stored float32).  A restored model takes float32
    reductions, as a built one does (`layers.accumulate_in_float32`)."""
    d = os.path.join(base_dir, f"ckpt_{step:010d}")
    with open(os.path.join(d, MANIFEST)) as f:
        manifest = json.load(f)
    by_path = _Stored(os.path.join(d, "shard_host0.npz"),
                      {rec["path"]: rec["key"]
                       for rec in manifest["leaves"]})
    if like is None:
        return manifest, by_path
    from repro_torch.models import layers

    layers.accumulate_in_float32()

    def build(tree, prefix: str):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in tree.items()}
        path = prefix[:-1]
        arr = by_path[path]
        if tuple(arr.shape) != tuple(tree.shape):
            raise ValueError(f"{path}: stored {tuple(arr.shape)}, "
                             f"expected {tuple(tree.shape)}")
        return torch.from_numpy(arr).to(device=tree.device,
                                        dtype=tree.dtype)

    return manifest, build(like, "")


def rotate(base_dir: str, keep_last: int = 3) -> None:
    """Delete all but the last `keep_last` checkpoints."""
    for s in _steps(base_dir, complete=False)[:-keep_last]:
        shutil.rmtree(os.path.join(base_dir, f"ckpt_{s:010d}"),
                      ignore_errors=True)
