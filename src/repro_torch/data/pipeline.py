"""Token data pipeline: deterministic and exactly resumable.

Port of `repro/data/pipeline.py` (numpy copies; the batches are the
reference's, array for array).  Batches are a pure function of (seed,
step), so a run restarted from a checkpoint reproduces the stream bit for
bit with no pipeline state beyond the step counter.

Sources:
* `SyntheticLM` — a seeded Zipf-ish stream with local structure (copy and
  shift patterns), so a model trained for a few steps shows a falling
  loss;
* `BinCorpus` — a memory-mapped flat token file (uint16/uint32) with
  wrap-around sampling, for real corpora.

`to_device` puts a host batch on one device, `place_batch` on a mesh of
ranks (each rank its block, as a DTensor).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        b, s = self.global_batch, self.seq_len
        # Zipf marginals + short-range copy structure => learnable bigrams
        base = rng.zipf(1.3, size=(b, s + 1)) % self.vocab
        shift = np.roll(base, 3, axis=1)
        mask = rng.random((b, s + 1)) < 0.5
        toks = np.where(mask, shift, base).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass
class BinCorpus:
    path: str
    vocab: int
    seq_len: int
    global_batch: int
    dtype: str = "uint16"
    seed: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        if len(self._data) <= self.seq_len + 1:
            raise ValueError(f"corpus too small: {len(self._data)} tokens "
                             f"for rows of {self.seq_len + 1}")

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        n = len(self._data) - self.seq_len - 1
        starts = rng.integers(0, n, size=self.global_batch)
        rows = np.stack(
            [self._data[s:s + self.seq_len + 1] for s in starts]
        ).astype(np.int32) % self.vocab
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def to_device(batch: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """A host batch as tensors on `device`, each array's type kept."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def place_batch(batch: dict[str, np.ndarray], shardings: dict,
                device=None) -> dict[str, torch.Tensor]:
    """A host batch on a mesh: each array the rank's block of it by its
    `sharding.NamedSharding` (`sharding.to_named(mesh, bspecs)`), as a
    DTensor on the rank's device (`device`, or the mesh's); an array
    without one goes whole to that device."""
    from repro_torch.launch import sharding

    if device is None and shardings:
        device = sharding.mesh_device(next(iter(shardings.values())).mesh)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)) \
            if isinstance(v, np.ndarray) else v
        if k in shardings:
            out[k] = sharding.shard_leaf(shardings[k].mesh, t,
                                         shardings[k].spec, device=device)
        else:
            out[k] = t.to(device)
    return out
