"""Meshes over the ranks of a `torch.distributed` world (port of
`repro/launch/mesh.py`).

The reference's mesh is one controller's grid of devices; here a mesh is
a grid of processes (ranks), each on its own device, built as a
`torch.distributed.device_mesh.DeviceMesh` with named axes.  Its groups
per axis (`mesh.get_group("model")`) carry the collectives of the
sampler's rank engines (`core/distributed.RankMesh`) and of
`optim/compression.py`.

The transport is the caller's: `"nccl"` moves CUDA tensors between cards
(one rank a card), `"gloo"` moves host memory, so any number of ranks may
share a card or run on the CPU.  Nothing here picks one for the caller.

Start a world with `torchrun --nproc-per-node N -m <module>` and
`init_ranks(backend)` in each rank (`env://`), or from one process with
`spawn(fn, N, ...)`, which tests and `chip_smoke.py` use.  Nothing here
touches a device or starts a process at import.
"""

from __future__ import annotations

import math
import multiprocessing
import multiprocessing.connection
import os
import pickle
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
# the engines' axis names by mesh rank (the reference's meshes)
_DEFAULT_AXES = {1: ("data",), 2: ("data", "model"),
                 3: ("pod", "data", "model")}


def check_backend(backend: str, local_world_size: int, device: str,
                  n_cuda: int) -> None:
    """Raise unless `backend` can carry a world of `local_world_size`
    ranks on this host with tensors on `device` ("cuda" or "cpu"):
    NCCL moves CUDA tensors only and refuses two ranks on one card in a
    communicator, so it needs a card a rank; gloo takes any layout."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if device == "cuda" and n_cuda < 1:
        raise RuntimeError("no CUDA device: pass device='cpu' with gloo")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("nccl moves CUDA tensors only; use gloo on the "
                             "CPU")
        if local_world_size > n_cuda:
            raise ValueError(
                f"nccl with {local_world_size} ranks on {n_cuda} card(s): "
                "NCCL refuses two ranks on one card in a communicator "
                "(duplicate GPU); run one rank a card, or pass "
                "backend='gloo' to share a card")


def init_ranks(backend: str, init_method: str | None = None,
               device: str = "cuda") -> torch.device:
    """Join this process to the world and return its device.  Rank, world
    size and local rank come from the environment (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE, as `torchrun` sets them); the rendezvous
    is `init_method`, `env://` (MASTER_ADDR/MASTER_PORT) by default, or a
    `file://` path that the ranks share.  A CUDA rank takes card
    local_rank % (cards on the host) and makes it current before the
    group exists, so neither NCCL nor `DeviceMesh` picks another."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_cuda = torch.cuda.device_count() if device == "cuda" else 0
    check_backend(backend, local_world, device, n_cuda)
    dev = torch.device("cpu")
    if device == "cuda":
        dev = torch.device("cuda", local_rank % n_cuda)
        torch.cuda.set_device(dev)
        torch.cuda.init()
    # NCCL binds its communicators to the rank's card
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world, device_id=dev if backend == "nccl" else None)
    return dev


def make_mesh(shape, axes, *, device_type: str = "cuda"):
    """A `DeviceMesh` of `shape` over the whole world, its axes named
    `axes` (e.g. (2, 4), ("data", "model") on 8 ranks); the product of
    `shape` must be the world size.  `device_type` is the ranks' tensors'
    ("cuda" by default, "cpu" for CPU ranks)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} with axes {axes}")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh holds {math.prod(shape)} "
                         f"positions; the world has {world} ranks")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production mesh, (16, 16) over (data, model), or
    (2, 16, 16) over (pod, data, model): a world of 256 or 512 ranks (a
    dry run takes its shape alone: `abstract_mesh`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return make_mesh(shape, _DEFAULT_AXES[len(shape)],
                     device_type=device_type)


class AbstractMesh:
    """A shape-only mesh: named axes and their sizes, and the coordinate
    of the one rank a dry run plays, with no process group and no device
    (the counterpart of `jax.sharding.AbstractMesh`).  It answers what
    the sharding rules and `launch/collectives.py` ask of a
    `DeviceMesh`: `mesh_dim_names`, `shape`, `size`, `get_coordinate`."""

    def __init__(self, shape, axes, coordinate=None):
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(axes)
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} with axes "
                             f"{self.mesh_dim_names}")
        coordinate = (0,) * len(self.shape) if coordinate is None \
            else tuple(int(c) for c in coordinate)
        if len(coordinate) != len(self.shape) or not all(
                0 <= c < n for c, n in zip(coordinate, self.shape)):
            raise ValueError(f"coordinate {coordinate} outside the mesh "
                             f"{self.shape}")
        self._coordinate = coordinate

    def size(self, mesh_dim: int | None = None) -> int:
        return (math.prod(self.shape) if mesh_dim is None
                else self.shape[mesh_dim])

    def get_coordinate(self) -> tuple[int, ...]:
        return self._coordinate

    def __repr__(self) -> str:
        return (f"AbstractMesh({self.shape}, {self.mesh_dim_names}, "
                f"at {self._coordinate})")


def abstract_mesh(shape, axes=None, coordinate=None) -> AbstractMesh:
    """A shape-only mesh of `shape`, its axes the reference's by default
    (("data", "model") for two axes): the production meshes of a dry run
    are `abstract_mesh((16, 16))` and `abstract_mesh((2, 16, 16))`."""
    shape = tuple(int(s) for s in shape)
    return AbstractMesh(shape, axes or _DEFAULT_AXES[len(shape)],
                        coordinate)


def axis_size(mesh, name: str) -> int:
    """The size of axis `name` of a `DeviceMesh` or an `AbstractMesh`."""
    return int(mesh.size(mesh.mesh_dim_names.index(name)))


def dp_axes(mesh) -> tuple[str, ...]:
    """Data-parallel axes: ('pod', 'data') multi-pod, ('data',) one pod."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def fsdp_axis(mesh) -> str | None:
    """Parameters and optimizer state shard over 'data' within a pod
    (never across pods)."""
    return "data" if "data" in mesh.mesh_dim_names else None


def tp_axis(mesh) -> str | None:
    return "model" if "model" in mesh.mesh_dim_names else None


# ---------------------------------------------------------------------------
# spawn: N ranks from one process
# ---------------------------------------------------------------------------


class RankFailed(RuntimeError):
    """A rank of `spawn` raised or died; the message holds its traceback."""


def _rank_main(rank, world, backend, device, store, shape, axes,
               out_dir) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    # the ranks share the host's cores, as torchrun's ranks do
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    out = Path(out_dir)
    try:
        with open(out / "call.pkl", "rb") as f:
            fn, args = pickle.load(f)
        init_ranks(backend, f"file://{store}", device=device)
        mesh = make_mesh(shape, axes, device_type=device)
        result = fn(rank, mesh, *args)
        torch.save(result, out / f"rank{rank}.pt")
    except BaseException as exc:
        record_failure(out, rank, exc, traceback.format_exc())
        sys.exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# what a rank raises when a peer's process went away first (gloo's and
# NCCL's words for a closed connection): such a rank failed second
_PEER_LOST = ("Connection closed by peer", "Connection reset by peer",
              "Broken pipe", "remote process exited", "NCCL communicator was "
              "aborted")


def _peer_lost(exc: BaseException) -> bool:
    return isinstance(exc, dist.DistNetworkError) or any(
        w in str(exc) for w in _PEER_LOST)


def record_failure(out: Path, rank: int, exc: BaseException,
                   trace: str) -> None:
    """Rank `rank`'s failure, before its process group is torn down: its
    traceback in `rank<r>.err`, and one line in `failures`, appended in
    one write to a file opened with O_APPEND, so that the lines stand in
    the order the ranks failed ("<rank> own" or "<rank> peer": whether
    the rank raised of its own or saw a peer's connection close)."""
    (out / f"rank{rank}.err").write_text(trace)
    line = f"{rank} {'peer' if _peer_lost(exc) else 'own'}\n".encode()
    fd = os.open(out / "failures", os.O_WRONLY | os.O_APPEND | os.O_CREAT,
                 0o644)
    try:
        os.write(fd, line)
    finally:
        os.close(fd)


def spawn(fn, world_size: int, *, backend: str, device: str = "cuda",
          timeout_s: float = 300.0, mesh_shape=None, args=()) -> list:
    """Run `fn(rank, mesh, *args)` in `world_size` fresh processes (the
    spawn start method: a child never inherits the parent's CUDA state),
    `mesh` a `make_mesh` of `mesh_shape` over them, its axes the
    reference's ("data"; "data", "model"; "pod", "data", "model"), by
    default one axis over the world.  The ranks meet at a file store in a
    temporary directory.  Returns each rank's result, in rank order (sent
    back through `torch.save`; CUDA tensors come back on the CPU).

    `fn` must be importable by name (a module-level function).  A rank
    that raises or dies ends the call: the other ranks are killed (they
    may wait in a collective the failed rank never joins) and
    `RankFailed` carries its traceback.  So does a call that runs past
    `timeout_s` (`TimeoutError`)."""
    shape = (world_size,) if mesh_shape is None else tuple(mesh_shape)
    axes = _DEFAULT_AXES[len(shape)]
    if math.prod(shape) != world_size:
        raise ValueError(f"a {shape} mesh over {world_size} ranks")
    n_cuda = torch.cuda.device_count() if device == "cuda" else 0
    check_backend(backend, world_size, device, n_cuda)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        # the call goes through a file: a start's arguments larger than a
        # pipe's buffer would hold each start until its child had imported
        # torch, one child after another
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(
            target=_rank_main, name=f"rank{r}",
            args=(r, world_size, backend, device, os.path.join(tmp, "store"),
                  shape, axes, tmp))
            for r in range(world_size)]
        try:
            for p in procs:
                p.start()
            _join(procs, tmp, time.monotonic() + timeout_s, timeout_s)
            return [torch.load(Path(tmp) / f"rank{r}.pt", map_location="cpu",
                               weights_only=False)
                    for r in range(world_size)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)


def _join(procs, tmp: str, deadline: float, timeout_s: float) -> None:
    """Wait for every rank; raise when one fails, or at the deadline."""
    running = list(procs)
    while running:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(
                f"ranks {[p.name for p in running]} still running after "
                f"{timeout_s} s")
        multiprocessing.connection.wait([p.sentinel for p in running], left)
        running = [p for p in running if p.exitcode is None]
        if any(p.exitcode not in (None, 0) for p in procs):
            # a peer of the failed rank fails too once its connection
            # closes, and the failed rank may still be exiting: let them
            # exit, and name the first to fail first
            grace = time.monotonic() + _GRACE_S
            while running and time.monotonic() < grace:
                multiprocessing.connection.wait(
                    [p.sentinel for p in running], grace - time.monotonic())
                running = [p for p in running if p.exitcode is None]
            raise RankFailed(_failures(procs, Path(tmp)))


_GRACE_S = 2.0


def _failures(procs, tmp: Path) -> str:
    """Each failed rank's traceback: first the ranks that raised of their
    own, then those that only saw a peer's connection close, each group
    in the order of the `failures` lines (the order of failure); a rank
    that died without a line (killed, or dead before its `except`) last.
    A rank with a line has failed even if its process is still exiting
    (it exits with code 1)."""
    order: dict[str, tuple[int, int]] = {}
    log = tmp / "failures"
    lines = log.read_text().split("\n") if log.exists() else []
    for i, line in enumerate(lines):
        if line.count(" ") == 1:
            rank, how = line.split(" ")
            order.setdefault(f"rank{rank}", (how != "own", i))
    failed = [p for p in procs
              if p.exitcode not in (None, 0) or p.name in order]
    failed.sort(key=lambda p: order.get(p.name, (2, 0)))
    err = {p.name: tmp / f"{p.name}.err" for p in failed}
    return "\n".join(
        f"{p.name} exited with code "
        f"{1 if p.exitcode is None else p.exitcode}:\n"
        + (err[p.name].read_text() if err[p.name].exists()
           else "(no traceback)") for p in failed)
