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

The port is single-controller like the reference: one process drives
every position of a `Mesh`.  A position maps to a torch device, and all
positions of a mesh lie on one device (several may share it, as the
reference's simulated host devices share one CPU); a mesh over more than
one device raises.  The state of a run is one tensor on that device whose
blocks are the positions' shards, and the collectives are exact integer
tensor operations between those blocks (`_halo_exchange`, `_psum_merge`).
Every position of a round reads the pre-round state, and the merge or the
assembly of slabs happens after all of them, as on the reference's mesh.

Fused engines (`mrf_fused_sharded`, `bn_fused_sharded`): every round is
one launch over every position of the mesh, K6 (`kernels/mrf_gibbs.py`
`mrf_halo_half_step`, over all row slabs, their rows -1 and h_loc from the
exchanged halos) or K5 (`kernels/bn_gibbs.py` `fused_color_round_mesh`,
each node position's update in its own plane of a stack that
`_psum_merge` then sums).  The kernels hash each position's words from
the round's key at the counters of the round's full stream, so the draws,
and the chain states, carries and quality accumulators, are bit-identical
to the single-device fused run whatever the mesh, and no word is made in
plain torch.  The run loops are the single-device ones
(`compile/backend.mrf_rounds_core`, `bayesnet.gibbs_run_loop`) with the
sharded round in place of the single-device one.

Legacy engines (`mrf_gibbs_sharded`, `bn_gibbs_sharded`) are plain torch,
with no kernel: each position folds its mesh index into the key
(`prng.fold_in`) and draws its own stream, so their bits depend on the
mesh shape and match the reference's on the same shape.
"""

from __future__ import annotations

import dataclasses
import math

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
    "a mesh whose positions lie on more than one device (peer copies or "
    "NCCL across processes) is a later item of the port (ROADMAP.md §1 "
    "item 14); map every position to one device"
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


def _split(total: int, parts: int, what: str) -> int:
    if total % parts:
        raise ValueError(f"{what} {total} must divide over {parts} devices")
    return total // parts


def _on_mesh_device(mesh: Mesh, device: torch.device, what: str) -> None:
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
    mesh: Mesh,
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
    schedule's under the schedule backend.  Returns the final (B, H, W)
    labels."""
    dev = mesh.device
    _on_mesh_device(mesh, evidence.device, "evidence")
    exp_table, exp_spec = build_exp_weight_lut(device=dev)
    n_grid = mesh.axis_size(grid_axis)
    n_chain_dev = math.prod(mesh.axis_size(a) for a in chain_axes)
    h_loc = _split(mrf.height, n_grid, "grid height")
    b_loc = _split(n_chains, n_chain_dev, "n_chains")

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


def bn_gibbs_sharded(
    cbn: bnet.CompiledBayesNet,
    key: prng.Key,
    mesh: Mesh,
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
    with `_psum_merge`.  The node positions of a chain block hold the same
    values and key (the reference replicates them), so the port keeps one
    copy per block.  Returns (marginals (n, V), final vals (B, n))."""
    _on_mesh_device(mesh, cbn.device, "net")
    n_dev = mesh.axis_size(node_axis)
    n_chain_dev = mesh.axis_size(chain_axis)
    b_loc = _split(n_chains, n_chain_dev, "n_chains")
    sgroups = shard_bn_groups(cbn, n_dev, placement, groups=groups)
    blocks, keys = [], []
    for ci in range(n_chain_dev):
        v, k = bnet.init_chain_values(cbn, prng.fold_in(key, ci), b_loc)
        blocks.append(v)
        keys.append(k)
    v_range = torch.arange(cbn.max_card, dtype=torch.int32,
                           device=cbn.device)
    hist = torch.zeros((cbn.n_nodes, cbn.max_card), dtype=torch.int32,
                       device=cbn.device)
    for t in range(n_iters):
        for ci in range(n_chain_dev):
            keys[ci], sub = prng.split(keys[ci])
            vals = blocks[ci]
            for sg, k in zip(sgroups, prng.split(sub, len(sgroups))):
                vals = _psum_merge(vals, torch.stack([
                    _shard_group_update(cbn, sg, d, vals, prng.fold_in(k, d),
                                        sampler)
                    for d in range(n_dev)
                ]))
            blocks[ci] = vals
            if t >= burn_in:
                hist = hist + (vals[..., None] == v_range).sum(
                    0, dtype=torch.int32)
    return bnet.hist_marginals(cbn, hist), torch.cat(blocks)


# ---------------------------------------------------------------------------
# Fused sharded engines: one K5 / K6 launch per round over every position
# ---------------------------------------------------------------------------


def mrf_fused_sharded(
    mrf: GridMRF,
    evidence: torch.Tensor,
    key: prng.Key | None,
    mesh: Mesh,
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
    (`mrf_gibbs.mrf_sharded_round_step`).  Bit-exact with
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
    c_max = max(1, max(len(p) for ps in parts for p in ps))
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
    mesh: Mesh,
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
    `_psum_merge` of the node positions' planes.  Bit-exact with
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
    mesh: Mesh,
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
    """Execute a `compile.CompiledProgram` across `mesh`, which must lie on
    the program's device.

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
