"""Sharded chromatic Gibbs over a mesh of positions (port of
`repro/core/distributed.py`).

The reference runs one `shard_map` program over a (data, model) device
mesh: chains are split over "data", and over "model" a grid MRF is split
into row slabs and a Bayes net's round nodes into owned sets (the paper's
Sec. IV-B mapping).  Two collectives move state between positions:

  * `lax.ppermute` halo exchange (MRF, the `ppermute_halo` comm op): each
    slab's border rows go to its neighbours before every round;
  * `lax.psum` of the int32 state delta (BN, `psum_broadcast`): owned sets
    are disjoint, so `vals + sum_d (new_d - vals)` merges a round exactly.

The engines take either of two meshes:

  * `Mesh`: one process drives every position, like the reference's
    single controller.  All positions lie on one device (several share
    it, as the reference's simulated host devices share one CPU); a
    `Mesh` over two devices raises.  The state of a run is one tensor on
    that device whose blocks are the positions' shards, and the
    collectives are exact integer tensor operations between those blocks
    (`_halo_exchange`, `_psum_merge`).
  * `RankMesh`: one position a rank of a `torch.distributed` world
    (`launch/mesh.py`), each on its own device, or several ranks sharing
    a card over gloo.  A rank holds its position's block, launches K5 or
    K6 over it, and the collectives cross processes (`_rank_halo`, an
    exchange with the grid-axis neighbours; `_rank_sum`, an int32
    all-reduce over an axis's group).  At the end every rank gathers the
    blocks and returns what a `Mesh` run returns.

Every position of a round reads the pre-round state, and the merge or the
assembly of slabs happens after all of them, as on the reference's mesh.

Fused engines (`mrf_fused_sharded`, `bn_fused_sharded`): on a `Mesh`
every round is one launch over every position of the mesh, K6
(`kernels/mrf_gibbs.py` `mrf_halo_half_step`, over all row slabs, their
rows -1 and h_loc from the exchanged halos) or K5 (`kernels/bn_gibbs.py`
`fused_color_round_mesh`, each node position's update in its own plane of
a stack that `_psum_merge` then sums); on a `RankMesh`, one launch a rank
over its own block (`mrf_halo_half_step` at its `row0`/`chain0`,
`fused_color_round` at its node position).  The kernels hash each
position's words from the round's key at the counters of the round's
full stream, so the draws, and the chain states, carries and quality
accumulators, are bit-identical to the single-device fused run whatever
the mesh, and no word is made in plain torch.  The run loops are the
single-device ones (`compile/backend.mrf_rounds_core`,
`bayesnet.gibbs_run_loop`) with the sharded round in place of the
single-device one.

Legacy engines (`mrf_gibbs_sharded`, `bn_gibbs_sharded`) are plain torch,
with no kernel: each position folds its mesh index into the key
(`prng.fold_in`) and draws its own stream, so their bits depend on the
mesh shape and match the reference's on the same shape, on either mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import prng
from repro_torch.compile import backend as backend_mod
from repro_torch.core import bayesnet as bnet
from repro_torch.core import mrf as mrf_mod
from repro_torch.core.draws import draw_from_logits
from repro_torch.core.graphs import GridMRF
from repro_torch.core.interp import build_exp_weight_lut
from repro_torch.core.mapping import MeshPlacement
from repro_torch.diag import accum as diag_accum
from repro_torch.kernels import bn_gibbs
from repro_torch.kernels import mrf_gibbs as mrf_kernels

MULTI_DEVICE_NOT_PORTED = (
    "a single-process Mesh lies on one device; for positions on several "
    "devices run one rank a position over torch.distributed "
    "(launch/mesh.py, RankMesh; ROADMAP.md §1 item 2)"
)


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class Mesh:
    """Named axes over an array of positions, each mapped to a torch device
    (the port's `jax.sharding.Mesh`).  `shape` maps axis name -> size."""

    devices: np.ndarray  # object array of torch.device, one per position
    axis_names: tuple[str, ...]

    def __post_init__(self):
        self.axis_names = tuple(self.axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"{self.devices.ndim}-d positions, axes {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis names {self.axis_names}")
        if len({str(_normalize(d)) for d in self.devices.flat}) > 1:
            raise NotImplementedError(MULTI_DEVICE_NOT_PORTED)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """The device every position lies on."""
        return self.devices.flat[0]

    def axis_size(self, name: str) -> int:
        if name not in self.shape:
            raise ValueError(f"the mesh has axes {self.axis_names}, not "
                             f"{name!r}")
        return self.shape[name]


def _normalize(dev) -> torch.device:
    dev = torch.device(dev)
    if (dev.type == "cuda" and dev.index is None
            and torch.cuda.is_available()):
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(
    shape, axis_names=("data", "model"), device="cuda"
) -> Mesh:
    """A mesh of `shape` positions, every one on `device` (the port's
    `core/compat.make_mesh`; the card by default, raising without one like
    `device.resolve`)."""
    shape = tuple(int(s) for s in shape)
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} has an empty axis")
    devices = np.empty(math.prod(shape), dtype=object)
    devices[:] = [device_mod.resolve(device)] * devices.size
    return Mesh(devices.reshape(shape), tuple(axis_names))


@dataclasses.dataclass(eq=False)
class RankMesh:
    """This rank's view of a mesh over the ranks of a `torch.distributed`
    world, one position a rank: a `DeviceMesh` with named axes over the
    whole world (`launch/mesh.make_mesh`) and the device this rank runs
    its block on.  Same axis API as `Mesh`.  `collectives` and
    `collective_s` count the engines' collectives on this rank and the
    host seconds they took: under gloo from a card, after the card has
    finished the round, the staging through host memory included; under
    NCCL, the time to enqueue them on the card's stream."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    device: torch.device
    collectives: int = 0
    collective_s: float = 0.0
    axis_names: tuple[str, ...] = dataclasses.field(init=False)
    coords: tuple[int, ...] = dataclasses.field(init=False)
    ranks: np.ndarray = dataclasses.field(init=False)  # global rank a position
    backend: str = dataclasses.field(init=False)
    host_staged: bool = dataclasses.field(init=False)

    def __post_init__(self):
        import torch.distributed as dist

        names = self.device_mesh.mesh_dim_names
        if not names:
            raise ValueError("a RankMesh needs named axes (mesh_dim_names)")
        self.axis_names = tuple(names)
        self.ranks = self.device_mesh.mesh.cpu().numpy()
        if self.ranks.size != dist.get_world_size():
            raise ValueError(f"the mesh holds {self.ranks.size} ranks, the "
                             f"world {dist.get_world_size()}")
        self.coords = tuple(int(c) for c in self.device_mesh.get_coordinate())
        self.device = _normalize(self.device)
        self.backend = dist.get_backend()
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("nccl moves CUDA tensors: run the program on "
                             "the rank's card")
        # gloo reads and writes host memory only
        self.host_staged = self.backend == "gloo" and self.device.type != "cpu"

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def axis_size(self, name: str) -> int:
        if name not in self.shape:
            raise ValueError(f"the mesh has axes {self.axis_names}, not "
                             f"{name!r}")
        return self.shape[name]

    def coord(self, name: str) -> int:
        """This rank's index along axis `name`."""
        self.axis_size(name)
        return self.coords[self.axis_names.index(name)]

    def group(self, name: str):
        return self.device_mesh.get_group(name)

    def peer(self, name: str, index: int) -> int:
        """The global rank at `index` along axis `name`, this rank's
        indices along the others."""
        at = list(self.coords)
        at[self.axis_names.index(name)] = index
        return int(self.ranks[tuple(at)])


def _as_mesh(mesh, device: torch.device):
    """`mesh` itself, or a `DeviceMesh` as this rank's `RankMesh` on
    `device`."""
    if isinstance(mesh, (Mesh, RankMesh)):
        return mesh
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(mesh, DeviceMesh):
        return RankMesh(mesh, device)
    raise TypeError(f"a Mesh, RankMesh or DeviceMesh, got {type(mesh)}")


def _split(total: int, parts: int, what: str) -> int:
    if total % parts:
        raise ValueError(f"{what} {total} must divide over {parts} devices")
    return total // parts


def _on_mesh_device(mesh: Mesh | RankMesh, device: torch.device,
                    what: str) -> None:
    if _normalize(mesh.device) != _normalize(device):
        raise ValueError(f"the mesh lies on {mesh.device}, the {what} on "
                         f"{device}")


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------


def _halo_exchange(
    labels: torch.Tensor, n_rows: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The `ppermute` halo exchange of a (B, H, W) grid split into n_rows
    row slabs: every slab sends its last row down and its first row up.
    Returns (up, down), each (n_rows, B, W): the rows slab g sees above
    and below itself, -1 beyond the grid (no neighbour)."""
    b, h, w = labels.shape
    h_loc = h // n_rows
    up = labels.new_full((n_rows, b, w), -1)
    down = labels.new_full((n_rows, b, w), -1)
    if n_rows > 1:
        up[1:] = labels[:, h_loc - 1:h - 1:h_loc].transpose(0, 1)
        down[:-1] = labels[:, h_loc::h_loc].transpose(0, 1)
    return up, down


def _psum_merge(vals: torch.Tensor, news: torch.Tensor) -> torch.Tensor:
    """`vals + psum(new_d - vals)` over the node positions: the disjoint
    updates of one round, the planes of the (n_node_pos, *vals.shape)
    stack `news`, merged in exact int32."""
    return vals + (news - vals).sum(0, dtype=torch.int32)


@contextlib.contextmanager
def _collective(mesh: RankMesh):
    """Count one collective of this rank and its host time.  A staged
    collective waits for the card anyway (its device-to-host copy), so it
    waits first and the time is the exchange's alone."""
    if mesh.host_staged:
        torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    yield
    mesh.collectives += 1
    mesh.collective_s += time.perf_counter() - t0


def _to_wire(mesh: RankMesh, t: torch.Tensor) -> torch.Tensor:
    """A dense copy of `t` for a collective to read or fill: a host tensor
    where gloo carries a card's tensor."""
    return t.to("cpu" if mesh.host_staged else t.device,
                copy=True).contiguous()


def _rank_sum(mesh: RankMesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """`psum` across ranks: the sum of every position's `t` along `axis`,
    an all-reduce over the axis's group (exact for integer tensors)."""
    import torch.distributed as dist

    with _collective(mesh):
        w = _to_wire(mesh, t)
        dist.all_reduce(w, group=mesh.group(axis))
    return w.to(t.device)


def _rank_halo(
    mesh: RankMesh, lab: torch.Tensor, axis: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """The `ppermute` halo exchange across ranks: this rank's (b, h, W)
    slab sends its first row to the previous position along `axis` and
    its last row to the next, in one `batch_isend_irecv` (host tensors
    under gloo).  Returns (up, down), the (b, W) rows above and below the
    slab, -1 beyond the grid."""
    import torch.distributed as dist

    n, g = mesh.axis_size(axis), mesh.coord(axis)
    wire = "cpu" if mesh.host_staged else lab.device
    up = torch.full((lab.shape[0], lab.shape[2]), -1, dtype=lab.dtype,
                    device=wire)
    down = torch.full_like(up, -1)
    with _collective(mesh):
        ops = []
        if g > 0:
            prev = mesh.peer(axis, g - 1)
            ops += [dist.P2POp(dist.isend, _to_wire(mesh, lab[:, 0]), prev),
                    dist.P2POp(dist.irecv, up, prev)]
        if g < n - 1:
            nxt = mesh.peer(axis, g + 1)
            ops += [dist.P2POp(dist.isend, _to_wire(mesh, lab[:, -1]), nxt),
                    dist.P2POp(dist.irecv, down, nxt)]
        if ops:  # a one-slab grid has no peer to post to
            for work in dist.batch_isend_irecv(ops):
                work.wait()
    return up.to(lab.device), down.to(lab.device)


def _rank_gather(
    mesh: RankMesh, t: torch.Tensor, dims: dict[str, int]
) -> torch.Tensor:
    """Every position's block `t` (one shape on every rank), assembled on
    every rank: the blocks along mesh axis `a` concatenated along tensor
    dim dims[a], the axes in the dict's order (the first outermost where
    two share a dim).  Positions along an axis not in `dims` hold copies,
    and the one at index 0 is read."""
    import torch.distributed as dist

    with _collective(mesh):
        w = _to_wire(mesh, t)
        blocks = [torch.empty_like(w) for _ in range(mesh.size)]
        dist.all_gather(blocks, w)
    named = list(dims)
    kept = [a for a in mesh.axis_names if a in dims]
    ranks = mesh.ranks[tuple(slice(None) if a in dims else 0
                             for a in mesh.axis_names)].transpose(
        [kept.index(a) for a in named])

    def cat(r, k):
        if k == len(named):
            return blocks[int(r)]
        return torch.cat([cat(x, k + 1) for x in r], dim=dims[named[k]])

    return cat(ranks, 0).to(t.device)


# the QualityAccum leaves that are elementwise over (chain, site, value);
# its other fields are counters every position holds alike
_ACCUM_LEAVES = ("mean", "m2", "bm_mean", "bm_m2", "cur_sum")


def _accum_block(q: diag_accum.QualityAccum, chains: slice,
                 sites: slice) -> diag_accum.QualityAccum:
    """A position's block of a run's quality accumulator (the reference's
    `_quality_spec`)."""
    return dataclasses.replace(q, **{
        f: getattr(q, f)[..., chains, sites, :].contiguous()
        for f in _ACCUM_LEAVES})


def _accum_gather(mesh: RankMesh, q: diag_accum.QualityAccum,
                  chain_axis: str, site_axis: str | None = None):
    dims = {chain_axis: -3}
    if site_axis is not None:
        dims[site_axis] = -2
    return dataclasses.replace(q, **{
        f: _rank_gather(mesh, getattr(q, f), dims) for f in _ACCUM_LEAVES})


# ---------------------------------------------------------------------------
# MRF: row slabs with halo exchange
# ---------------------------------------------------------------------------


def _local_half_step(
    mrf: GridMRF, lab, ev, key, parity, sampler, exp_table, exp_spec, up,
    down, row0,
) -> torch.Tensor:
    """One legacy half-step of a (b, h_loc, W) slab whose neighbour rows
    are `up`/`down` ((b, W)) and whose first row is global row row0: the
    site potentials of the slab padded with its halo rows (their own rows
    are dropped), then a draw from the slab's own key."""
    padded = torch.cat([up[:, None], lab, down[:, None]], dim=-2)
    ev_pad = torch.nn.functional.pad(ev, (0, 0, 1, 1))
    logp = mrf_mod.site_log_potentials(mrf, padded, ev_pad)[..., 1:-1, :, :]
    new = draw_from_logits(logp, key, sampler, exp_table, exp_spec)
    mask = mrf_mod.checkerboard_mask(lab.shape[-2], lab.shape[-1], parity,
                                     lab.device, row0)
    return torch.where(mask, new, lab)


def mrf_gibbs_sharded(
    mrf: GridMRF,
    evidence: torch.Tensor,
    key: prng.Key,
    mesh: Mesh | RankMesh,
    *,
    n_chains: int,
    n_iters: int,
    sampler: str = "lut_ky",
    chain_axes: tuple[str, ...] = ("data",),
    grid_axis: str = "model",
    parities: tuple[int, ...] = (0, 1),
) -> torch.Tensor:
    """Legacy chromatic Gibbs with the grid row-split over `grid_axis` and
    the chains over `chain_axes`.  Position (ci, gi) (ci the row-major
    index over `chain_axes`) starts from its own key
    `fold_in(fold_in(key, ci), gi)` and draws its slab's init and every
    half-step from it.  `parities` is the round order: (0, 1) eagerly, the
    schedule's under the schedule backend.  A rank of a `RankMesh` runs
    its own position, exchanging halos with its grid neighbours.  Returns
    the final (B, H, W) labels."""
    dev = mesh.device
    _on_mesh_device(mesh, evidence.device, "evidence")
    exp_table, exp_spec = build_exp_weight_lut(device=dev)
    n_grid = mesh.axis_size(grid_axis)
    n_chain_dev = math.prod(mesh.axis_size(a) for a in chain_axes)
    h_loc = _split(mrf.height, n_grid, "grid height")
    b_loc = _split(n_chains, n_chain_dev, "n_chains")
    if isinstance(mesh, RankMesh):
        ci = 0
        for a in chain_axes:
            ci = ci * mesh.axis_size(a) + mesh.coord(a)
        gi = mesh.coord(grid_axis)
        k0, k = prng.split(prng.fold_in(prng.fold_in(key, ci), gi))
        lab = prng.randint(k0, (b_loc, h_loc, mrf.width), 0, mrf.n_labels,
                           dev)
        ev = evidence[gi * h_loc:(gi + 1) * h_loc]
        for _ in range(n_iters):
            ks = prng.split(k, 1 + len(parities))
            for i, parity in enumerate(parities):
                up, down = _rank_halo(mesh, lab, grid_axis)
                lab = _local_half_step(mrf, lab, ev, ks[1 + i], parity,
                                       sampler, exp_table, exp_spec, up,
                                       down, gi * h_loc)
            k = ks[0]
        return _rank_gather(mesh, lab, {**{a: 0 for a in chain_axes},
                                        grid_axis: 1})

    def block(ci, gi):
        return (slice(ci * b_loc, (ci + 1) * b_loc),
                slice(gi * h_loc, (gi + 1) * h_loc))

    positions = [(ci, gi) for ci in range(n_chain_dev)
                 for gi in range(n_grid)]
    labels = torch.empty((n_chains, mrf.height, mrf.width),
                         dtype=torch.int32, device=dev)
    keys = {}
    for ci, gi in positions:
        k = prng.fold_in(prng.fold_in(key, ci), gi)
        k0, keys[ci, gi] = prng.split(k)
        labels[block(ci, gi)] = prng.randint(
            k0, (b_loc, h_loc, mrf.width), 0, mrf.n_labels, dev)
    for _ in range(n_iters):
        ks = {pos: prng.split(keys[pos], 1 + len(parities))
              for pos in positions}
        for i, parity in enumerate(parities):
            up, down = _halo_exchange(labels, n_grid)
            new = torch.empty_like(labels)
            for ci, gi in positions:
                cs, rs = block(ci, gi)
                new[cs, rs] = _local_half_step(
                    mrf, labels[cs, rs], evidence[rs], ks[ci, gi][1 + i],
                    parity, sampler, exp_table, exp_spec, up[gi, cs],
                    down[gi, cs], gi * h_loc,
                )
            labels = new
        keys = {pos: ks[pos][0] for pos in positions}
    return labels


# ---------------------------------------------------------------------------
# Bayes nets: round nodes owned by positions (Sec. IV-B mapping)
# ---------------------------------------------------------------------------


def _owners(nodes: np.ndarray, n_dev: int,
            placement: MeshPlacement | None) -> list[np.ndarray]:
    """Indices of a group's nodes owned by each node position: the placed
    core modulo n_dev with a mapping, else round-robin."""
    if placement is not None:
        owner = placement.placement[nodes] % n_dev
    else:
        owner = np.arange(len(nodes)) % n_dev
    return [np.where(owner == d)[0] for d in range(n_dev)]


def local_lanes(groups: list[bnet.ColorGroup], n_dev: int,
                placement: MeshPlacement | None = None) -> int:
    """The local lane envelope of `build_sharded_fused_rounds`: the most
    nodes one of `n_dev` node positions owns in one round (at least 1)."""
    return max(1, max(len(p) for g in groups for p in _owners(
        g.nodes.cpu().numpy(), n_dev, placement)))


@dataclasses.dataclass
class ShardedGroup:
    """One colour group split over n_dev node positions, padded to equal
    width.  Every tensor has a leading (n_dev,) axis; node id n_nodes marks
    a pad slot (cards 1), which draws and is then dropped."""

    nodes: torch.Tensor  # (n_dev, nc_max)
    cards: torch.Tensor
    base: torch.Tensor  # (n_dev, nc_max, F)
    stride: torch.Tensor  # (n_dev, nc_max, F, S)
    scope_var: torch.Tensor
    is_self: torch.Tensor


def shard_bn_groups(
    cbn: bnet.CompiledBayesNet,
    n_dev: int,
    placement: MeshPlacement | None = None,
    groups: list[bnet.ColorGroup] | None = None,
) -> list[ShardedGroup]:
    """Split each colour group (`cbn.groups`, or the schedule's round
    groups) over the node positions, on the net's device."""
    out = []
    for g in cbn.groups if groups is None else groups:
        host = {f: getattr(g, f).cpu().numpy() for f in
                ("nodes", "cards", "base", "stride", "scope_var", "is_self")}
        parts = _owners(host["nodes"], n_dev, placement)
        nc_max = max(1, max(len(p) for p in parts))

        def pack(arr, pad_value=0):
            res = np.full((n_dev, nc_max) + arr.shape[1:], pad_value,
                          arr.dtype)
            for d, part in enumerate(parts):
                res[d, :len(part)] = arr[part]
            return torch.tensor(res, device=cbn.device)

        out.append(ShardedGroup(
            nodes=pack(host["nodes"], cbn.n_nodes),
            cards=pack(host["cards"], 1),
            base=pack(host["base"]),  # pad base 0 -> the dummy entry
            stride=pack(host["stride"]),
            scope_var=pack(host["scope_var"]),
            is_self=pack(host["is_self"]),
        ))
    return out


def _shard_group_update(cbn, sg: ShardedGroup, d: int, vals, key, sampler):
    """Position d's update of one legacy round: the padded group's draws
    (pad rows draw too, so every row reads the reference's words), then
    the owned nodes' labels scattered into a copy of `vals`."""
    g = bnet.ColorGroup(
        nodes=sg.nodes[d], cards=sg.cards[d], base=sg.base[d],
        stride=sg.stride[d], scope_var=sg.scope_var[d],
        is_self=sg.is_self[d],
    )
    logp = bnet.group_log_conditionals(cbn, g, vals)
    lab = draw_from_logits(logp, key, sampler, cbn.exp_table, cbn.exp_spec)
    owned = g.nodes < cbn.n_nodes
    upd = vals.clone()
    upd[:, g.nodes[owned].long()] = lab[:, owned]
    return upd


def _legacy_bn_block(cbn, sgroups, key, b_loc, n_iters, burn_in, merge):
    """One chain block of the legacy engine, from its key
    `fold_in(key, ci)`: every sweep splits the block's key, and each group
    draws from one of the sweep key's splits, `merge(vals, sg, k)` taking
    the node positions' disjoint updates.  Returns (vals, the block's
    histogram)."""
    vals, kc = bnet.init_chain_values(cbn, key, b_loc)
    v_range = torch.arange(cbn.max_card, dtype=torch.int32,
                           device=cbn.device)
    hist = torch.zeros((cbn.n_nodes, cbn.max_card), dtype=torch.int32,
                       device=cbn.device)
    for t in range(n_iters):
        kc, sub = prng.split(kc)
        for sg, k in zip(sgroups, prng.split(sub, len(sgroups))):
            vals = merge(vals, sg, k)
        if t >= burn_in:
            hist = hist + (vals[..., None] == v_range).sum(
                0, dtype=torch.int32)
    return vals, hist


def bn_gibbs_sharded(
    cbn: bnet.CompiledBayesNet,
    key: prng.Key,
    mesh: Mesh | RankMesh,
    *,
    n_chains: int,
    n_iters: int,
    burn_in: int,
    sampler: str = "lut_ky",
    placement: MeshPlacement | None = None,
    chain_axis: str = "data",
    node_axis: str = "model",
    groups: list[bnet.ColorGroup] | None = None,
):
    """Legacy distributed Alg. 2: a round's nodes split over `node_axis`,
    chains over `chain_axis`.  Chain block ci starts from
    `fold_in(key, ci)`; node position d draws round r from
    `fold_in(keys[r], d)`; after each round the disjoint updates merge
    (`_psum_merge`, or `_rank_sum` over the node axis's ranks).  The node
    positions of a chain block hold the same values and key (the
    reference replicates them), so a `Mesh` run keeps one copy per block.
    Returns (marginals (n, V), final vals (B, n))."""
    _on_mesh_device(mesh, cbn.device, "net")
    n_dev = mesh.axis_size(node_axis)
    n_chain_dev = mesh.axis_size(chain_axis)
    b_loc = _split(n_chains, n_chain_dev, "n_chains")
    sgroups = shard_bn_groups(cbn, n_dev, placement, groups=groups)

    def update(sg, d, vals, k):
        return _shard_group_update(cbn, sg, d, vals, prng.fold_in(k, d),
                                   sampler)

    if isinstance(mesh, RankMesh):
        ci, d = mesh.coord(chain_axis), mesh.coord(node_axis)
        vals, hist = _legacy_bn_block(
            cbn, sgroups, prng.fold_in(key, ci), b_loc, n_iters, burn_in,
            lambda v, sg, k: v + _rank_sum(mesh, update(sg, d, v, k) - v,
                                           node_axis))
        return (bnet.hist_marginals(cbn, _rank_sum(mesh, hist, chain_axis)),
                _rank_gather(mesh, vals, {chain_axis: 0}))
    blocks, hist = [], 0
    for ci in range(n_chain_dev):
        vals, h = _legacy_bn_block(
            cbn, sgroups, prng.fold_in(key, ci), b_loc, n_iters, burn_in,
            lambda v, sg, k: _psum_merge(v, torch.stack([
                update(sg, d, v, k) for d in range(n_dev)])))
        blocks.append(vals)
        hist = hist + h
    return bnet.hist_marginals(cbn, hist), torch.cat(blocks)


# ---------------------------------------------------------------------------
# Fused sharded engines: one K5 / K6 launch per round over every position
# ---------------------------------------------------------------------------


def mrf_fused_sharded(
    mrf: GridMRF,
    evidence: torch.Tensor,
    key: prng.Key | None,
    mesh: Mesh | RankMesh,
    *,
    n_chains: int,
    n_iters: int,
    parities: tuple[int, ...],
    carry: mrf_mod.MRFChainState | None = None,
    return_state: bool = False,
    diag_total: int | None = None,
    diag_batch: int = diag_accum.DEFAULT_BATCH_LEN,
    chain_axis: str = "data",
    grid_axis: str = "model",
):
    """The fused MRF schedule rounds on a mesh: per round, the halo
    exchange, then one K6 launch over every position's row slab
    (`mrf_gibbs.mrf_sharded_round_step`), or on a `RankMesh` over this
    rank's block (`_mrf_fused_ranks`).  Bit-exact with
    `compile/backend.run_mrf_schedule(fused=True)`: the same init, key
    splits and per-site words, so an `MRFChainState` carry (labels, key,
    quality accumulator) crosses the single-device/sharded boundary either
    way.  Pins never route here."""
    _on_mesh_device(mesh, evidence.device, "evidence")
    n_grid = mesh.axis_size(grid_axis)
    n_chain_dev = mesh.axis_size(chain_axis)
    _split(mrf.height, n_grid, "grid height")
    _split(n_chains, n_chain_dev, "n_chains")
    if carry is not None and carry.labels.shape[0] != n_chains:
        raise ValueError(f"the carry holds {carry.labels.shape[0]} chains, "
                         f"not n_chains={n_chains}")
    if isinstance(mesh, RankMesh):
        return _mrf_fused_ranks(
            mrf, evidence, key, mesh, n_chains=n_chains, n_iters=n_iters,
            parities=parities, carry=carry, return_state=return_state,
            diag_total=diag_total, diag_batch=diag_batch,
            chain_axis=chain_axis, grid_axis=grid_axis)
    exp_table, exp_spec = build_exp_weight_lut(device=evidence.device)

    def step(labels, k, parity):
        up, down = _halo_exchange(labels, n_grid)
        return mrf_kernels.mrf_sharded_round_step(
            mrf, labels, evidence, k, parity, exp_table, exp_spec,
            n_chain_pos=n_chain_dev, n_row_pos=n_grid, up_halo=up,
            down_halo=down,
        )

    return backend_mod.mrf_rounds_core(
        mrf, parities, evidence, key, n_chains=n_chains, n_iters=n_iters,
        sampler="lut_ky", fused=True, carry=carry, return_state=return_state,
        diag_total=diag_total, diag_batch=diag_batch, step=step,
    )


def _mrf_fused_ranks(mrf, evidence, key, mesh: RankMesh, *, n_chains,
                     n_iters, parities, carry, return_state, diag_total,
                     diag_batch, chain_axis, grid_axis):
    """`mrf_fused_sharded` on a `RankMesh`: this rank's (b_loc, h_loc, W)
    block of chains ci and rows gi, cut from the whole init (or carry),
    then per round the halo exchange with its grid neighbours and one K6
    launch over the block at its `row0`/`chain0`.  The quality
    accumulator's leaves are elementwise over (chain, site), so each rank
    updates its block; labels and accumulator are gathered at the end."""
    h_loc = mrf.height // mesh.axis_size(grid_axis)
    b_loc = n_chains // mesh.axis_size(chain_axis)
    ci, gi = mesh.coord(chain_axis), mesh.coord(grid_axis)
    chains = slice(ci * b_loc, (ci + 1) * b_loc)
    rows = slice(gi * h_loc, (gi + 1) * h_loc)
    dev = evidence.device
    if carry is None:
        labels, key = mrf_mod.init_labels(mrf, key, n_chains, device=dev)
        quality = None
        if diag_total is not None:
            quality = diag_accum.make_accum(
                b_loc, h_loc * mrf.width, mrf.n_labels, diag_total,
                diag_batch, dev)
    else:
        labels, key, quality = carry.labels, carry.key, carry.quality
        if quality is not None:
            quality = _accum_block(quality, chains, slice(
                rows.start * mrf.width, rows.stop * mrf.width))
    local = mrf_mod.MRFChainState(
        labels=labels[chains, rows].contiguous(), key=key, quality=quality)
    ev = evidence[rows]
    exp_table, exp_spec = build_exp_weight_lut(device=dev)
    p = mrf_kernels.half_step_params(mrf)

    def step(lab, k, parity):
        up, down = _rank_halo(mesh, lab, grid_axis)
        return mrf_kernels.mrf_halo_half_step(
            mrf, lab, up[None], down[None], rows.start, ev, k, parity,
            exp_table, exp_spec, p, chain0=chains.start)

    _, st = backend_mod.mrf_rounds_core(
        mrf, parities, ev, None, n_chains=b_loc, n_iters=n_iters,
        sampler="lut_ky", fused=True, carry=local, return_state=True,
        step=step,
    )
    labels = _rank_gather(mesh, st.labels, {chain_axis: 0, grid_axis: 1})
    if not return_state:
        return labels
    quality = st.quality
    if quality is not None:
        quality = _accum_gather(mesh, quality, chain_axis, grid_axis)
    return labels, mrf_mod.MRFChainState(labels=labels, key=st.key,
                                         quality=quality)


@dataclasses.dataclass
class ShardedFusedRounds:
    """The fused-BN round tables split over n_dev node positions: K5's
    table.  Per (position, round), the owned nodes come first in their
    round-group order and pad lanes follow them: node id -1, cards 0,
    word_pos 0, all-zero gather rows.  `word_pos` is an owned node's place
    in its round's full group, where its words lie in the round's stream;
    `n_own` counts the owned lanes, which are the only ones K5 and its twin
    process."""

    nodes: torch.Tensor  # (n_dev, R, C) int32; -1 = pad lane
    cards: torch.Tensor  # (n_dev, R, C) int32; 0 = pad lane
    base: torch.Tensor  # (n_dev, R, C, F) int32
    stride: torch.Tensor  # (n_dev, R, C, F, S) int32
    scope_var: torch.Tensor
    is_self: torch.Tensor  # (n_dev, R, C, F, S) int32 (0/1)
    word_pos: torch.Tensor  # (n_dev, R, C) int32
    n_own_t: torch.Tensor  # (n_dev, R) int32
    n_c_t: torch.Tensor  # (R,) int32 full node count per round
    n_own: tuple[tuple[int, ...], ...]  # (n_dev, R) on the host
    n_c: tuple[int, ...]  # full node count per round
    c_max: int  # local lane envelope
    f_max: int
    s_max: int


def build_sharded_fused_rounds(
    cbn: bnet.CompiledBayesNet,
    groups: list[bnet.ColorGroup],
    n_dev: int,
    placement: MeshPlacement | None = None,
) -> ShardedFusedRounds:
    """Split each round's gather tensors over the node positions (the
    ownership rule of `shard_bn_groups`), in numpy, then stack them on a
    rounds axis padded to the common local envelope, on the net's
    device."""
    host = [{f: getattr(g, f).cpu().numpy() for f in
             ("nodes", "cards", "base", "stride", "scope_var", "is_self")}
            for g in groups]
    parts = [_owners(h["nodes"], n_dev, placement) for h in host]
    c_max = local_lanes(groups, n_dev, placement)
    f_max = max(h["base"].shape[1] for h in host)
    s_max = max(h["stride"].shape[2] for h in host)
    lead = (n_dev, len(groups), c_max)
    nodes = np.full(lead, -1, np.int32)
    cards = np.zeros(lead, np.int32)
    base = np.zeros(lead + (f_max,), np.int32)
    stride = np.zeros(lead + (f_max, s_max), np.int32)
    scope_var = np.zeros(lead + (f_max, s_max), np.int32)
    is_self = np.zeros(lead + (f_max, s_max), np.int32)
    word_pos = np.zeros(lead, np.int32)
    n_own = np.zeros((n_dev, len(groups)), np.int32)
    for r, (h, ps) in enumerate(zip(host, parts)):
        f, s = h["base"].shape[1], h["stride"].shape[2]
        for d, p in enumerate(ps):
            k = len(p)
            nodes[d, r, :k] = h["nodes"][p]
            cards[d, r, :k] = h["cards"][p]
            base[d, r, :k, :f] = h["base"][p]
            stride[d, r, :k, :f, :s] = h["stride"][p]
            scope_var[d, r, :k, :f, :s] = h["scope_var"][p]
            is_self[d, r, :k, :f, :s] = h["is_self"][p]
            word_pos[d, r, :k] = p
            n_own[d, r] = k

    def dev(x):
        return torch.tensor(x, device=cbn.device)

    return ShardedFusedRounds(
        nodes=dev(nodes), cards=dev(cards), base=dev(base),
        stride=dev(stride), scope_var=dev(scope_var), is_self=dev(is_self),
        word_pos=dev(word_pos), n_own_t=dev(n_own),
        n_c_t=dev(np.array([len(h["nodes"]) for h in host], np.int32)),
        n_own=tuple(tuple(int(k) for k in row) for row in n_own),
        n_c=tuple(len(h["nodes"]) for h in host),
        c_max=c_max, f_max=f_max, s_max=s_max,
    )


def bn_fused_sharded(
    cbn: bnet.CompiledBayesNet,
    key: prng.Key | None,
    mesh: Mesh | RankMesh,
    *,
    n_chains: int,
    n_iters: int,
    burn_in: int,
    sampler: str = "lut_ky",
    thin: int = 1,
    placement: MeshPlacement | None = None,
    groups: list[bnet.ColorGroup] | None = None,
    carry: bnet.BNChainState | None = None,
    return_state: bool = False,
    diag_total: int | None = None,
    diag_batch: int = diag_accum.DEFAULT_BATCH_LEN,
    chain_axis: str = "data",
    node_axis: str = "model",
):
    """The fused BN colour rounds on a mesh: per round, one K5 launch over
    every position (each its chain block and owned nodes, all reading the
    round's input values, `bn_gibbs.fused_color_round_mesh`), then
    `_psum_merge` of the node positions' planes; on a `RankMesh`, one K5
    launch a rank over its own position (`_bn_fused_ranks`).  Bit-exact with
    `compile/backend.run_bn_schedule(fused=True)`: the loop is
    `bayesnet.gibbs_run_loop` (init, key splits, burn-in/thinning gate,
    histogram, quality accumulator), and K5 derives each round's key from
    the sweep's and hashes every owned row's words at its counters in the
    single-device round's stream.  Returns what `gibbs_run_loop`
    returns."""
    bn_gibbs.check_fused_sampler(sampler)
    _on_mesh_device(mesh, cbn.device, "net")
    groups = cbn.groups if groups is None else groups
    n_dev = mesh.axis_size(node_axis)
    n_chain_dev = mesh.axis_size(chain_axis)
    _split(n_chains, n_chain_dev, "n_chains")
    if carry is not None and carry.vals.shape[0] != n_chains:
        raise ValueError(f"the carry holds {carry.vals.shape[0]} chains, "
                         f"not n_chains={n_chains}")
    p = bn_gibbs.sweep_params(cbn, sampler)
    sfr = build_sharded_fused_rounds(cbn, groups, n_dev, placement)
    if isinstance(mesh, RankMesh):
        return _bn_fused_ranks(
            cbn, groups, sfr, p, key, mesh, n_chains=n_chains,
            n_iters=n_iters, burn_in=burn_in, sampler=sampler, thin=thin,
            carry=carry, return_state=return_state, diag_total=diag_total,
            diag_batch=diag_batch, chain_axis=chain_axis,
            node_axis=node_axis)

    def sweep(vals, sub):
        for r in range(len(sfr.n_c)):
            vals = _psum_merge(vals, bn_gibbs.fused_color_round_mesh(
                cbn, sfr, r, vals, sub, sampler, p, n_chain_dev))
        return vals

    vals = None
    if carry is None:
        vals, key = bnet.init_chain_values(cbn, key, n_chains)
    return bnet.gibbs_run_loop(
        cbn, groups, vals, key, n_iters, burn_in, sampler, thin,
        carry=carry, return_state=return_state, diag_total=diag_total,
        diag_batch=diag_batch, sweep=sweep,
    )


def _bn_fused_ranks(cbn, groups, sfr, p, key, mesh: RankMesh, *, n_chains,
                    n_iters, burn_in, sampler, thin, carry, return_state,
                    diag_total, diag_batch, chain_axis, node_axis):
    """`bn_fused_sharded` on a `RankMesh`: rank (ci, d) holds chains
    [ci b_loc, (ci + 1) b_loc) of every node, cut from the whole init (or
    carry), replicated over the node axis.  Per round, one K5 launch over
    node position d's owned nodes (`bn_gibbs.fused_color_round` at
    `chain0` ci b_loc, plane d of the table built for the whole mesh, so
    each row keeps its counters in the round's full stream), then
    `vals + all_reduce(new - vals)` in int32 over the node axis.  The
    histogram counts this block's chains and is summed over the chain
    axis in int32 at the end; vals and the quality accumulator are
    gathered."""
    b_loc = n_chains // mesh.axis_size(chain_axis)
    ci, d = mesh.coord(chain_axis), mesh.coord(node_axis)
    chains = slice(ci * b_loc, (ci + 1) * b_loc)
    hist0 = torch.zeros((cbn.n_nodes, cbn.max_card), dtype=torch.int32,
                        device=cbn.device)
    if carry is None:
        vals, key = bnet.init_chain_values(cbn, key, n_chains)
        t, quality = 0, None
        if diag_total is not None:
            quality = diag_accum.make_accum(
                b_loc, cbn.n_nodes, cbn.max_card,
                diag_accum.kept_count(diag_total, burn_in, thin), diag_batch,
                cbn.device)
    else:
        vals, key, hist0, t = carry.vals, carry.key, carry.hist, carry.t
        quality = carry.quality
        if quality is not None:
            quality = _accum_block(quality, chains, slice(None))
    local = bnet.BNChainState(vals=vals[chains].contiguous(), key=key,
                              hist=torch.zeros_like(hist0), t=t,
                              quality=quality)

    def sweep(v, sub):
        for r in range(len(sfr.n_c)):
            new = bn_gibbs.fused_color_round(cbn, sfr, d, r, v, sub,
                                             chains.start, sampler, p)
            v = v + _rank_sum(mesh, new - v, node_axis)
        return v

    _, _, st = bnet.gibbs_run_loop(
        cbn, groups, None, None, n_iters, burn_in, sampler, thin,
        carry=local, return_state=True, sweep=sweep,
    )
    hist = hist0 + _rank_sum(mesh, st.hist, chain_axis)
    vals = _rank_gather(mesh, st.vals, {chain_axis: 0})
    marginals = bnet.hist_marginals(cbn, hist)
    if not return_state:
        return marginals, vals
    quality = st.quality
    if quality is not None:
        quality = _accum_gather(mesh, quality, chain_axis)
    return marginals, vals, bnet.BNChainState(
        vals=vals, key=st.key, hist=hist, t=st.t, quality=quality)


# ---------------------------------------------------------------------------
# Program entry
# ---------------------------------------------------------------------------


def _check_comm_mechanisms(program, expected: str) -> None:
    """The schedule backend routes each round's comm op onto the collective
    its mechanism names (`psum_broadcast` -> `_psum_merge`, `ppermute_halo`
    -> `_halo_exchange`); a round carrying any other mechanism has no
    lowering in these engines and is rejected, not silently merged."""
    for r in program.schedule.rounds:
        for op in r.comm:
            if op.mechanism != expected:
                raise ValueError(
                    f"round {r.color} comm op uses mechanism "
                    f"{op.mechanism!r}; this engine lowers {expected!r} only"
                )


def run_program_sharded(
    program,
    key: prng.Key | None,
    mesh,
    *,
    n_chains: int = 32,
    n_iters: int = 200,
    burn_in: int | None = None,
    sampler: str = "lut_ky",
    evidence=None,
    backend: str = "eager",
    fused: bool = False,
    thin: int = 1,
    carry=None,
    return_state: bool = False,
    diag_total: int | None = None,
    diag_batch: int = diag_accum.DEFAULT_BATCH_LEN,
    **axes,
):
    """Execute a `compile.CompiledProgram` across `mesh`: a `Mesh` on the
    program's device, or a `RankMesh` (or its `DeviceMesh`, taken on the
    program's device) whose every rank calls this with the same
    arguments and returns the same result.

    BNs run the psum-merge engines with node ownership from the program's
    Sec. IV-B placement; MRFs the halo-exchange engines (the row split is
    the placement of a grid).  `backend="schedule"` takes the rounds and
    their order from the compiled schedule and checks that each round's
    comm op names the engine's mechanism.  `fused=True` (schedule backend
    only) runs K5 / K6 and is bit-exact with the single-device fused run,
    so `carry`/`return_state` and the `diag_total` accumulator ride there
    and only there: the legacy engines fold keys per position and carry no
    state."""
    if backend not in ("eager", "schedule"):
        raise ValueError(f"unknown backend {backend!r}")
    if fused and backend != "schedule":
        raise ValueError("fused sharded execution is schedule-backend only")
    if not fused and (carry is not None or return_state
                      or diag_total is not None):
        raise ValueError(
            "carry/return_state/diag_total ride the fused sharded route "
            "only (the legacy sharded engines fold keys per position and "
            "carry no state)"
        )
    mesh = _as_mesh(mesh, program.device)
    _on_mesh_device(mesh, program.device, "program")
    if program.kind == "bn":
        if evidence is not None:
            raise ValueError(
                "BN evidence is baked into the program at compile time")
        groups = None
        if backend == "schedule":
            _check_comm_mechanisms(program, "psum_broadcast")
            groups = program.schedule_executable().round_groups
        burn_in = 50 if burn_in is None else burn_in
        if fused:
            return bn_fused_sharded(
                program.cbn, key, mesh, n_chains=n_chains, n_iters=n_iters,
                burn_in=burn_in, sampler=sampler, thin=thin,
                placement=program.placement, groups=groups, carry=carry,
                return_state=return_state, diag_total=diag_total,
                diag_batch=diag_batch, **axes,
            )
        return bn_gibbs_sharded(
            program.cbn, key, mesh, n_chains=n_chains, n_iters=n_iters,
            burn_in=burn_in, sampler=sampler, placement=program.placement,
            groups=groups, **axes,
        )
    mrf = program.mrf
    if evidence is None:
        raise ValueError("MRF programs take the evidence image at run time")
    if burn_in is not None:
        raise ValueError(
            "MRF programs return final states only; burn_in does not apply")
    evidence = torch.as_tensor(evidence, dtype=torch.int32,
                               device=program.device)
    if tuple(evidence.shape) != (mrf.height, mrf.width):
        raise ValueError(
            f"evidence image is {tuple(evidence.shape)}, the grid is "
            f"{(mrf.height, mrf.width)}"
        )
    parities = (0, 1)
    if backend == "schedule":
        _check_comm_mechanisms(program, "ppermute_halo")
        parities = program.schedule_executable().parities
    if fused:
        if sampler != "lut_ky":
            raise ValueError(
                f"fused sharded MRF rounds implement the lut_ky datapath "
                f"only, got sampler={sampler!r}"
            )
        if program.ir.evidence:
            raise ValueError(
                "baked MRF pins have no sharded-fused lowering (the "
                "executor route excludes pinned buckets)"
            )
        return mrf_fused_sharded(
            mrf, evidence, key, mesh, n_chains=n_chains, n_iters=n_iters,
            parities=parities, carry=carry, return_state=return_state,
            diag_total=diag_total, diag_batch=diag_batch, **axes,
        )
    return mrf_gibbs_sharded(
        mrf, evidence, key, mesh, n_chains=n_chains, n_iters=n_iters,
        sampler=sampler, parities=parities, **axes,
    )
