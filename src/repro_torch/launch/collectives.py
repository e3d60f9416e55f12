"""Every collective of the LM mesh, for one rank.

The LM steps over a mesh (`launch/steps.py`) keep each parameter,
optimizer moment, batch and decode cache as the rank's shard
(`launch/sharding.py`) and compute with the reference's 2-D layout, FSDP
on the data axes and tensor parallelism (TP) on the model axis:

  * `Plan.block` gathers a block's leaves at use.  Where the rules split
    an attention, Mamba, mLSTM, sLSTM, MLP, MoE-expert or shared-expert
    leaf over the model axis (`Plan.split`), the leaf is gathered over
    the other axes only and the rank computes its own heads, channels,
    head dims or columns of it inside the block's `ModelSplit`: the region is entered through the identity
    (whose backward sums the ranks' partial input gradients over the
    model axis, `_ToModelSplit`) and left through the sum of the ranks'
    partial products over it (`_ModelSum`; both sums in float32, in
    float64 for float32 activations).  A leaf the rules leave whole that
    a rank reads only in part inside the region (an attention's K/V
    projections when the KV heads do not divide the axis) gets
    gradients summed over the model axis too.  The other
    leaves (norms, the router, any part whose dimension does not
    divide the axis) are gathered whole.  The
    gather's backward is its adjoint: the gradient is summed over the
    data-parallel ranks (in float32) and the rank keeps its own block of
    it (an all-reduce and a slice: gloo has no reduce-scatter);
  * the embedding and the head stay split by vocabulary over the model
    axis (`Plan.embed`, `Plan.logits`: a masked lookup summed over it, a
    column block of logits gathered over it);
  * a decode cache stays as the rules store it (`Plan.cache_in`,
    `cache_out`): an attention's K/V split by sequence over the model
    axis is attended where it lies (`SeqSplit`: flash-decoding, the
    ranks' partials merged by log-sum-exp), and a recurrent state keeps
    the rank's channels or head dims;
  * a rank computes the batch rows of its data-parallel position (all of
    them when the batch does not divide: `rows` false), so ranks along
    the model axis compute the same rows with their own heads and
    columns;
  * `dp_sum` (differentiable: its backward is the same sum) carries the
    MoE switch loss's global means, `gather_rows` the logits the token
    draw reads (every rank draws the whole batch with the same key, so
    the draw equals the single-process one), `reduce_sumsq` the global
    gradient norm.

A `Comm` works in two modes.  On a live world (a `DeviceMesh`) it calls
`torch.distributed` on the mesh's per-axis groups; under gloo a card's
tensor goes through a host copy (gloo moves host memory), under NCCL
it goes directly.  On a shape-only mesh (`mesh.AbstractMesh`) it calls
nothing: each collective returns a `meta` tensor of its result's shape.
Both modes count every collective by op, with its result's bytes, by
the axis it runs over (`axis_bytes`, `axis_count`) and by whether its group stays on
one host of `HOST_CARDS` cards (a dry run prices the two at different
link rates: `launch/roofline.py`), and record the axes each parameter
was gathered over (`leaf_axes`); a live `Comm` also times each exchange
on the host clock and adds its bytes to `BYTES`.  An axis of size one
calls nothing; so a mesh whose model axis has size one computes as one
process does.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import math
import time

import torch

from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding

HOST_CARDS = 8  # cards a host: NVLink joins these, the network the rest
# every live Comm's exchanges in this process: their count and host seconds
TOTALS = {"collectives": 0, "seconds": 0.0}
# every live Comm's result bytes in this process, by "<op> over <axis>"
BYTES: collections.Counter = collections.Counter()
# 16-bit floats cross as bytes (gloo moves no int16 or bf16); a byte view
# keeps each element's bytes together along the last axis
_BITS = {torch.bfloat16: torch.uint8, torch.float16: torch.uint8}


class Comm:
    """The collectives of one rank of `mesh`."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.sizes = {a: mesh_lib.axis_size(mesh, a) for a in self.names}
        self.coords = sharding.coordinates(mesh)
        self.dry = not sharding.is_live(mesh)
        self.dp = mesh_lib.dp_axes(mesh)
        self.dp_size = math.prod(self.sizes[a] for a in self.dp)
        self.tp = mesh_lib.tp_axis(mesh)
        self.world = math.prod(self.sizes.values())
        self.rows = True  # this call's batch rows split over the dp axes
        self.count: collections.Counter = collections.Counter()
        self.nbytes: collections.Counter = collections.Counter()
        self.link_bytes: collections.Counter = collections.Counter()
        self.axis_bytes: collections.Counter = collections.Counter()
        self.axis_count: collections.Counter = collections.Counter()
        self.leaf_axes: dict[str, tuple[str, ...]] = {}
        self.seconds = 0.0
        self._backend = None
        if not self.dry:
            import torch.distributed as dist

            self._backend = dist.get_backend()

    # ---- bookkeeping -------------------------------------------------

    def _rank_of(self, coords: dict) -> int:
        r = 0
        for a in self.names:
            r = r * self.sizes[a] + coords[a]
        return r

    def link(self, axes) -> str:
        """"nvlink" when the group over `axes` lies on this rank's host
        (ranks numbered row-major over the mesh, `HOST_CARDS` a host),
        else "network"."""
        hosts = set()
        for idx in itertools.product(*(range(self.sizes[a]) for a in axes)):
            c = dict(self.coords)
            c.update(zip(axes, idx))
            hosts.add(self._rank_of(c) // HOST_CARDS)
        return "nvlink" if len(hosts) == 1 else "network"

    def _record(self, op: str, shape, dtype, axes) -> None:
        b = math.prod(shape) * dtype.itemsize
        self.count[op] += 1
        self.nbytes[op] += b
        self.link_bytes[self.link(axes)] += b
        for a in axes:
            self.axis_bytes[f"{op} over {a}"] += b
            self.axis_count[f"{op} over {a}"] += 1
            if not self.dry:
                BYTES[f"{op} over {a}"] += b

    @contextlib.contextmanager
    def _timed(self, t: torch.Tensor):
        """Time one exchange (outside autograd: its buffers are written in
        place; the differentiable ops are `_Gather` and `_DpSum`)."""
        staged = self._staged(t)
        if staged:  # the device-to-host copy waits for the card anyway
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        with torch.no_grad():
            yield staged
        dt = time.perf_counter() - t0
        self.seconds += dt
        TOTALS["collectives"] += 1
        TOTALS["seconds"] += dt

    def _staged(self, t: torch.Tensor) -> bool:
        return self._backend == "gloo" and t.device.type == "cuda"

    # ---- plain collectives (no autograd) -------------------------------

    def _wire(self, t: torch.Tensor, staged: bool) -> torch.Tensor:
        """A dense copy of `t` for a collective: in host memory where gloo
        carries a card's tensor (pageable: eight ranks pinning every
        gathered size would lock tens of GB of the host's memory)."""
        return t.to("cpu" if staged else t.device, copy=True).contiguous()

    def all_gather(self, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
        """t's blocks along `dim` from every rank of the group over
        `axes` (major to minor), concatenated in their order."""
        import torch.distributed as dist

        for a in reversed(tuple(axes)):
            n = self.sizes[a]
            if n == 1:
                continue
            shape = list(t.shape)
            shape[dim] *= n
            self._record("all-gather", shape, t.dtype, (a,))
            if self.dry:
                t = torch.empty(shape, dtype=t.dtype, device=t.device)
                continue
            with self._timed(t) as staged:
                wire = self._wire(t, staged)
                # the blocks stacked along dim 0, as gloo writes them
                out = torch.empty((n * t.shape[0], *t.shape[1:]),
                                  dtype=t.dtype, device=wire.device)
                bits = _BITS.get(t.dtype)
                if bits is not None:  # bit for bit, whatever gloo types
                    dist.all_gather_into_tensor(
                        out.view(bits), wire.view(bits),
                        group=self.mesh.get_group(a))
                else:
                    dist.all_gather_into_tensor(
                        out, wire, group=self.mesh.get_group(a))
                out = out.to(t.device)
                t = out.view(n, *t.shape).movedim(0, dim).reshape(
                    shape).contiguous()
        return t

    def all_reduce(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The sum of t over the group over `axes` (a new tensor)."""
        import torch.distributed as dist

        for a in axes:
            if self.sizes[a] == 1:
                continue
            self._record("all-reduce", t.shape, t.dtype, (a,))
            if self.dry:
                t = torch.empty_like(t)
                continue
            with self._timed(t) as staged:
                wire = self._wire(t, staged)
                dist.all_reduce(wire, group=self.mesh.get_group(a))
                t = wire.to(t.device)
        return t

    def all_to_all(self, parts, shapes, axis: str) -> list[torch.Tensor]:
        """What each rank of the group over `axis` sends this one:
        `parts[q]` is what this rank sends rank q, `shapes[q]` the shape
        of what rank q sends here (all of one type; a part may be
        empty).  Counted by the bytes received."""
        import torch.distributed as dist

        ref = parts[0]
        dtype, dev = ref.dtype, ref.device
        numel = [math.prod(s) for s in shapes]
        self._record("all-to-all", (sum(numel),), dtype, (axis,))
        if self.dry:
            return [torch.empty(s, dtype=dtype, device=dev) for s in shapes]
        with self._timed(ref) as staged:
            wire = self._wire(torch.cat([t.reshape(-1) for t in parts]),
                              staged)
            out = torch.empty(sum(numel), dtype=dtype, device=wire.device)
            sent = [t.numel() for t in parts]
            bits = _BITS.get(dtype)
            if bits is not None:  # as bytes: gloo moves no 16-bit floats
                k = dtype.itemsize
                dist.all_to_all_single(
                    out.view(bits), wire.view(bits), [n * k for n in numel],
                    [n * k for n in sent], group=self.mesh.get_group(axis))
            else:
                dist.all_to_all_single(out, wire, numel, sent,
                                       group=self.mesh.get_group(axis))
            out = out.to(dev)
        return [b.view(s) for b, s in zip(out.split(numel), shapes)]

    def gather_spec(self, t: torch.Tensor, spec, skip=()) -> torch.Tensor:
        """The whole tensor of the local shard `t` laid out by `spec`,
        gathered over every axis of every dimension not in `skip`."""
        for dim, entry in enumerate(spec):
            if dim not in skip and entry is not None:
                t = self.all_gather(t, dim, sharding._axes(entry))
        return t

    def own(self, whole: torch.Tensor, spec, skip=()) -> torch.Tensor:
        """This rank's block of `whole` under `spec`, the dimensions in
        `skip` taken whole (a view)."""
        spec = tuple(None if d in skip else e for d, e in enumerate(spec))
        return whole[sharding.shard_slices(self.mesh, whole.shape, spec,
                                           self.coords)]

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The whole batch of a (rows, ...) tensor whose rows are split
        over the dp axes (itself when they are not)."""
        return self.all_gather(t, 0, self.dp) if self.rows else t

    def own_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole-batch tensor (all of them when the
        batch does not split)."""
        if not self.rows or self.dp_size == 1:
            return t
        idx = 0
        for a in self.dp:
            idx = idx * self.sizes[a] + self.coords[a]
        n = t.shape[0] // self.dp_size
        return t[idx * n:(idx + 1) * n]

    # ---- differentiable ------------------------------------------------

    def dp_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the dp ranks; its gradient is the sum of the
        ranks' gradients (each rank's loss a term of the objective)."""
        if self.dp_size == 1:
            return t
        return _DpSum.apply(t, self)

    def reduce_sumsq(self, specs: dict):
        """A function of the vector of per-leaf local sums of squares (in
        the order of `specs`' names) giving each leaf's global sum: one
        replica of each distinct shard counts (the rank at coordinate 0 of
        every axis the leaf's spec does not name), over the whole world."""
        if self.world == 1:
            return None
        keep = []
        for spec in specs.values():
            named = {a for e in spec for a in sharding._axes(e)}
            keep.append(float(all(self.coords[a] == 0 for a in self.names
                                  if a not in named)))

        def reduce(v: torch.Tensor) -> torch.Tensor:
            w = torch.tensor(keep, dtype=v.dtype, device=v.device)
            return self.all_reduce(v * w, self.names)

        return reduce


class _DpSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        return comm.all_reduce(t, comm.dp)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.contiguous(), ctx.comm.dp), None


class _Gather(torch.autograd.Function):
    """Forward: the whole leaf from its shard (the dimensions in `skip`
    left split), viewed in the shape a layer reads.  Backward: the
    gradient summed over the dp ranks (and over the model axis with
    `model_sum`: a leaf read in part by each model rank) in float32, this
    rank's block of it in the leaf's type."""

    @staticmethod
    def forward(ctx, t, comm, spec, shape, skip=(), model_sum=False):
        ctx.comm, ctx.spec, ctx.dtype, ctx.skip = comm, spec, t.dtype, skip
        ctx.axes = comm.dp + ((comm.tp,) if model_sum else ())
        whole = comm.gather_spec(t, spec, skip)
        ctx.whole = whole.shape
        return whole.view(shape)

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        g = g.reshape(ctx.whole)
        if any(comm.sizes[a] > 1 for a in ctx.axes):
            g = comm.all_reduce(g.float(), ctx.axes)
        return (comm.own(g, ctx.spec, ctx.skip).to(ctx.dtype), None, None,
                None, None, None)


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The type the model axis sums partial products in: float32 for
    16-bit ones (exact for a few terms), float64 for float32 ones (the
    sum then rounds once, as one product's float32 accumulation does).
    Only float32 activations take the float64 sum, at twice the model
    axis's bytes: the configs compute in bf16, and float32 runs are the
    CPU tests' comparisons with one process and the reference."""
    return torch.float64 if dtype.itemsize >= 4 else torch.float32


class _ModelSum(torch.autograd.Function):
    """The sum over the model axis of terms whose total every model rank
    then uses alike, returned in `dtype` (forward an all-reduce in
    `_wide(dtype)`; backward the identity: each rank's term gets the
    total's gradient, in the term's type)."""

    @staticmethod
    def forward(ctx, t, comm, dtype):
        ctx.dtype = t.dtype
        return comm.all_reduce(t.to(_wide(dtype)), (comm.tp,)).to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


def _exchange(comm, t: torch.Tensor, have, want) -> torch.Tensor:
    """Equal blocks of t's last axis moved between the model ranks: rank
    q holds the global blocks `have[q]` (in that order) and receives the
    blocks `want[q]`; returns this rank's `want` blocks in order (one
    all-to-all, each block sent once)."""
    r, n = comm.coords[comm.tp], comm.sizes[comm.tp]
    blk = t.shape[-1] // len(have[r])
    mine = {b: t[..., i * blk:(i + 1) * blk] for i, b in enumerate(have[r])}
    lead = tuple(t.shape[:-1])
    sends = [[b for b in want[q] if b in mine] for q in range(n)]
    recvs = [[b for b in want[r] if b in have[q]] for q in range(n)]
    got = comm.all_to_all(
        [torch.stack([mine[b] for b in bs]) if bs else t.new_empty(0)
         for bs in sends],
        [(len(bs), *lead, blk) for bs in recvs], comm.tp)
    blocks = {b: part[j] for bs, part in zip(recvs, got)
              for j, b in enumerate(bs)}
    return torch.cat([blocks[b] for b in want[r]], dim=-1)


class _ColumnProduct(torch.autograd.Function):
    """x (..., K), the same on every model rank, times the rank's column
    block w (K, N / n) of a weight split by column over the model axis:
    the rank's output columns.  Backward: w's gradient from its columns;
    x's gradient whole, as one device computes it and the same on every
    rank (so x enters no region): every rank's output-column gradient
    gathered, times the rank's rows of w (exchanged from the ranks'
    columns, its share of w), the rows' blocks gathered."""

    @staticmethod
    def forward(ctx, x, w, comm):
        ctx.comm = comm
        ctx.save_for_backward(x, w)
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        comm = ctx.comm
        n = comm.sizes[comm.tp]
        k, m = w.shape[0] // n, w.shape[1]
        dw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, m)
        # block (row block kb, column block q) is rank q's rows kb
        rows = _exchange(comm, w.reshape(1, n * k * m),
                         [tuple(kb * n + q for kb in range(n))
                          for q in range(n)],
                         [tuple(q * n + c for c in range(n))
                          for q in range(n)])
        rows = rows.view(n, k, m).transpose(0, 1).reshape(k, n * m)
        whole = comm.all_gather(g.contiguous(), g.ndim - 1, (comm.tp,))
        dx = comm.all_gather((whole @ rows.T).contiguous(), g.ndim - 1,
                             (comm.tp,))
        return dx, dw, None


class _Exchange(torch.autograd.Function):
    """`_exchange` of `have` into `want`; backward, the gradient's blocks
    sent back (`want` into `have`)."""

    @staticmethod
    def forward(ctx, t, comm, have, want):
        ctx.comm, ctx.have, ctx.want = comm, have, want
        return _exchange(comm, t, have, want)

    @staticmethod
    def backward(ctx, g):
        return (_exchange(ctx.comm, g.contiguous(), ctx.want, ctx.have),
                None, None, None)


class _Product(torch.autograd.Function):
    """A 16-bit product whose contraction is split over the model axis,
    with a float32 result, so that the ranks' partial products are
    summed before any rounding to the operands' type (as one product
    accumulates its whole contraction in float32).  a (..., K) @ w (K, N),
    or the experts' a (G, E, C, K) by w (E, K, N).  Backward: the
    operands' gradients from the incoming gradient in their type, as the
    16-bit product's own backward computes them."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        if w.ndim == 2:
            a2 = a.reshape(-1, a.shape[-1])
            if a.device.type == "cpu":  # no 16-bit product to float32
                out = a2.float() @ w.float()
            else:
                out = torch.mm(a2, w, out_dtype=torch.float32)
            return out.view(*a.shape[:-1], w.shape[-1])
        g, e, c, k = a.shape
        ae = a.transpose(0, 1).reshape(e, g * c, k)
        if a.device.type != "cuda":  # FlopCounterMode miscounts bmm.dtype
            out = torch.bmm(ae.float(), w.float())
        else:
            out = torch.bmm(ae, w, out_dtype=torch.float32)
        return out.view(e, g, c, -1).transpose(0, 1)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        if w.ndim == 2:
            da = g @ w.T
            dw = a.reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1])
            return da, dw
        return (torch.einsum("becd,efd->becf", g, w),
                torch.einsum("becf,becd->efd", a, g))


class _ToModelSplit(torch.autograd.Function):
    """The identity into a product split over the model axis; backward,
    the ranks' partial gradients summed over it (in the wider type)."""

    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        return comm.all_reduce(g.to(_wide(g.dtype)), (comm.tp,)).to(
            g.dtype), None


class _GatherModel(torch.autograd.Function):
    """A last-axis block over the model axis gathered whole; backward, the
    rank's block of the gradient (every model rank's loss is the same)."""

    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm, ctx.n = comm, t.shape[-1]
        return comm.all_gather(t, t.ndim - 1, (comm.tp,))

    @staticmethod
    def backward(ctx, g):
        i = ctx.comm.coords[ctx.comm.tp]
        return g[..., i * ctx.n:(i + 1) * ctx.n], None


class ModelSplit:
    """One block's tensor-parallel region on the model axis, for one rank.
    `parts` names the block's parts computed split: "core" (an
    attention's heads, a Mamba mixer's d_inner channels, an xLSTM
    mixer's heads or head dims and its output columns), "ffn" (the dense
    FFN's d_ff or the MoE experts' hidden dim) and "shared" (the shared
    experts' d_ff).  A layer takes the object of its part (`of`) or None,
    reads its block of the split dimension (`block`), enters with
    `enter`, forms its partial products of a contraction split over the
    axis with `product` and leaves with `leave`; a recurrent mixer also
    moves blocks between the ranks (`exchange`), gathers a last-axis
    block (`gather_last`) and takes output columns whose input gradient
    it needs exact (`columns`)."""

    def __init__(self, comm: Comm, parts):
        self.comm, self.parts = comm, frozenset(parts)
        self.size = comm.sizes[comm.tp]
        self.index = comm.coords[comm.tp]

    def of(self, part: str):
        """This region for `part` if the part is split, else None."""
        return self if part in self.parts else None

    def block(self, n: int) -> tuple[int, int]:
        """[start, stop) of this rank's equal block of n."""
        return self.index * n // self.size, (self.index + 1) * n // self.size

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """t, whole on every model rank, into the region (backward: the
        ranks' partial gradients summed)."""
        return _ToModelSplit.apply(t, self.comm)

    def leave(self, t: torch.Tensor, dtype=None) -> torch.Tensor:
        """The sum over the model axis of the ranks' partial products, in
        `dtype` (t's by default)."""
        return _ModelSum.apply(t, self.comm, dtype or t.dtype)

    def exchange(self, t: torch.Tensor, have, want) -> torch.Tensor:
        """Equal blocks of t's last axis moved between the ranks: rank q
        holds the global blocks `have[q]` and takes `want[q]`."""
        return _Exchange.apply(t, self.comm, have, want)

    def columns(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The rank's output columns x @ w of w's column block, x the same
        on every rank, with x's gradient whole and exact on every rank
        (`_ColumnProduct`: x does not enter the region)."""
        return _ColumnProduct.apply(x, w, self.comm)

    def gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's last-axis block of t concatenated; backward, the
        rank's block of the gradient (every model rank's loss is the same:
        `enter` the result where ranks use it in part)."""
        return _GatherModel.apply(t, self.comm)

    def product(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """This rank's partial product a @ w (or the experts' a (G, E, C,
        K) by w (E, K, N)) over its block of the contraction, for `leave`:
        float32 for 16-bit operands (`_Product`), else the plain product."""
        if a.dtype.itemsize < 4:
            return _Product.apply(a, w)
        return a @ w if w.ndim == 2 else torch.einsum("becf,efd->becd", a, w)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every model rank's t concatenated along `dim`, in rank order
        (no gradient)."""
        return self.comm.all_gather(t, dim, (self.comm.tp,))


class SeqSplit:
    """An attention layer's decode cache split by sequence position over
    `axes` (the model axis, and the data axes before it where the batch
    does not split): this rank holds cache slots [start, start + n) of
    `total` and attends over them where they lie (flash-decoding).
    `merge` combines the ranks' per-query (max, sum of exponentials)
    pairs by log-sum-exp and `sum` adds their partial outputs, both over
    `axes` and in float32 (the sum in float64 for float32 activations),
    so that every rank holds the whole attention of every query."""

    def __init__(self, comm: Comm, axes, start: int, total: int):
        self.comm, self.axes = comm, tuple(axes)
        self.start, self.total = start, total

    def merge(self, m: torch.Tensor, l: torch.Tensor):
        """(max, sum) over every rank's slots, from this rank's."""
        both = self.comm.all_gather(torch.stack([m, l])[None].contiguous(),
                                    0, self.axes)
        ms, ls = both[:, 0], both[:, 1]
        top = ms.amax(0)
        return top, (ls * torch.exp(ms - top)).sum(0)

    def sum(self, t: torch.Tensor, dtype) -> torch.Tensor:
        """The ranks' partial outputs t summed, in `dtype`."""
        return self.comm.all_reduce(t.to(_wide(dtype)), self.axes).to(dtype)


# a block's parts split over the model axis when this leaf's spec names it
_PART_LEAVES = {"core": "core.wq", "ffn": "ffn.wg", "shared": "ffn.shared.wg"}
# the leaf that splits each mixer's "core" part: attention heads, Mamba's
# d_inner rows of x_proj, an mLSTM's output columns, an sLSTM's head dims
_CORE_LEAF = {"attn": "core.wq", "attn_chunked": "core.wq",
              "mamba": "core.x_proj", "mlstm": "core.out",
              "slstm": "core.w_in"}


def _part(path) -> str | None:
    """The part of a block a leaf at `path` (below the block) belongs to."""
    if path[:2] == ["ffn", "shared"]:
        return "shared"
    return path[0] if path else None


class Plan:
    """How one rank runs the model on the mesh: `leaves` the local shards
    by state-dict name, `specs` their specs (`sharding.param_specs`),
    `cache_specs` the decode caches' (`sharding.cache_specs`)."""

    def __init__(self, comm: Comm, cfg, leaves: dict, specs: dict,
                 cache_specs=None):
        self.comm, self.cfg = comm, cfg
        self.leaves, self.specs = leaves, specs
        self.cache_specs = cache_specs

    def leaf(self, name: str, skip=(), model_sum: bool = False
             ) -> torch.Tensor:
        """Leaf `name` whole (the dimensions in `skip` left split), in the
        shape a layer reads it; with `model_sum` its gradient is summed
        over the model axis too."""
        t, spec = self.leaves[name], self.specs[name]
        whole = tuple(n if d in skip else n * math.prod(
            self.comm.sizes[a] for a in sharding._axes(e))
            for d, (n, e) in enumerate(zip(t.shape, spec)))
        shape = sharding.port_shape(self.cfg, name, whole)
        self.comm.leaf_axes[name] = tuple(
            a for d, e in enumerate(spec) if d not in skip
            for a in sharding._axes(e) if self.comm.sizes[a] > 1)
        if t.requires_grad and torch.is_grad_enabled():
            return _Gather.apply(t, self.comm, spec, shape, skip, model_sum)
        return self.comm.gather_spec(t, spec, skip).view(shape)

    def _vocab_split(self, name: str, dim: int) -> bool:
        """Whether leaf `name`'s vocabulary dimension `dim` is split over
        the model axis alone (then it stays split)."""
        tp = self.comm.tp
        return (tp is not None and self.comm.sizes[tp] > 1
                and self.specs[name][dim] == tp)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding rows of `tokens` in the activation type.  With the
        vocabulary split over the model axis, each rank looks up the
        tokens of its block (zero rows for the others) and the rows are
        summed over the axis: exact, one term is not zero.  Rows are
        looked up as one process looks them up (`layers.embed_rows`)."""
        from repro_torch.models import layers

        if not self._vocab_split("embed", 0):
            return layers.embed_rows(self.leaf("embed"), tokens, self.cfg)
        w = self.leaf("embed", skip=(0,))
        n = w.shape[0]
        local = tokens.long() - self.comm.coords[self.comm.tp] * n
        mine = (local >= 0) & (local < n)
        rows = layers.embed_rows(w, local.clamp(0, n - 1), self.cfg)
        rows = rows * mine[..., None].to(rows.dtype)
        return _ModelSum.apply(rows, self.comm, rows.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """float32 logits of normed hidden states x.  With the vocabulary
        split over the model axis, each rank takes its block of columns
        (the whole d) and the blocks are gathered."""
        from repro_torch.models import layers

        name, dim = (("embed", 0) if self.cfg.tie_embeddings
                     else ("head", 1))
        if not self._vocab_split(name, dim):
            w = self.leaf(name)
            head = w.T if self.cfg.tie_embeddings else w
            return (x @ layers.act(head, self.cfg)).float()
        w = self.leaf(name, skip=(dim,))
        head = w.T if self.cfg.tie_embeddings else w
        part = (_ToModelSplit.apply(x, self.comm)
                @ layers.act(head, self.cfg)).float()
        return _GatherModel.apply(part, self.comm)

    def _kind(self, i: int) -> str:
        return self.cfg.pattern[i % len(self.cfg.pattern)]

    def split(self, i: int) -> ModelSplit | None:
        """Block i's tensor-parallel region: the parts whose leaves the
        rules split over the model axis (the mixer's "core" by its
        `_CORE_LEAF`), or None."""
        tp = self.comm.tp
        if tp is None or self.comm.sizes[tp] == 1:
            return None
        leaves = dict(_PART_LEAVES, core=_CORE_LEAF[self._kind(i)])
        parts = [part for part, leaf in leaves.items()
                 if tp in self.specs.get(f"blocks.{i}.{leaf}", ())]
        return ModelSplit(self.comm, parts) if parts else None

    def block(self, i: int) -> tuple[dict, ModelSplit | None]:
        """Block i's leaves as nested dicts ({"core": {"wq": ...},
        "norm1": ...}), which the layers read as they read a `Params`, and
        its region (`split`).  A leaf of a split part keeps its
        model-axis dimension split; every other leaf is whole."""
        prefix = f"blocks.{i}."
        split = self.split(i)
        out: dict = {}
        for name in self.leaves:
            if name.startswith(prefix):
                *path, last = name[len(prefix):].split(".")
                skip, model_sum = (), False
                if split is not None and _part(path) in split.parts:
                    skip = tuple(d for d, e in enumerate(self.specs[name])
                                 if e == self.comm.tp)
                    # read in part by each model rank (K/V heads that
                    # do not divide the axis)
                    model_sum = path[0] == "core" and not skip
                node = out
                for k in path:
                    node = node.setdefault(k, {})
                node[last] = self.leaf(name, skip, model_sum)
        return out, split

    def model_dims(self, i: int, name: str, spec=None) -> tuple[int, ...]:
        """The dimensions of layer i's cache leaf `name` that the layer
        keeps split over the model axis as it is stored: a recurrent
        mixer's d_inner or head dims inside its region (the rules'
        `sharding.cache_specs`), in decode an attention's sequence
        (`seq_split`); () for the rest, which the layer reads whole."""
        tp = self.comm.tp
        if tp is None or self.comm.sizes[tp] == 1:
            return ()
        kind = self._kind(i)
        if kind in ("attn", "attn_chunked"):
            return (1,) if spec is not None and tp in sharding._axes(
                spec[1]) else ()
        split = self.split(i)
        if split is None or "core" not in split.parts:
            return ()
        return _recurrent_dims(self.cfg, kind, name, self.comm.sizes[tp])

    def _skip(self, i: int, name: str) -> tuple[int, ...]:
        spec = self.cache_specs[i][name]
        return ((0,) if self.comm.rows else ()) + self.model_dims(i, name,
                                                                  spec)

    def seq_split(self, i: int, cache: dict) -> SeqSplit | None:
        """Layer i's K/V split by sequence over the model axis (with the
        data axes where the batch does not split): the rank's slots, or
        None where the sequence is stored whole on the model axis (a
        length that does not divide it), or for a recurrent layer."""
        if "k" not in cache or not self.model_dims(
                i, "k", self.cache_specs[i]["k"]):
            return None
        axes = sharding._axes(self.cache_specs[i]["k"][1])
        n = sharding.local(cache["k"]).shape[1]
        idx = 0
        for a in axes:
            idx = idx * self.comm.sizes[a] + self.comm.coords[a]
        return SeqSplit(self.comm, axes, idx * n,
                        n * math.prod(self.comm.sizes[a] for a in axes))

    def cache_in(self, i: int, cache: dict) -> dict:
        """Layer i's decode cache in the layout the layer computes in: its
        own rows and the dimensions it keeps split over the model axis
        (`model_dims`) as stored, every other dimension whole."""
        return {n: self.comm.gather_spec(sharding.local(t),
                                         self.cache_specs[i][n],
                                         self._skip(i, n))
                for n, t in cache.items()}

    def cache_out(self, i: int, cache: dict, new: dict) -> dict:
        """Write this rank's block of layer i's updated cache `new` (in
        the compute layout) into its stored shards; returns `cache`."""
        for n, t in cache.items():
            loc = sharding.local(t)
            part = self.comm.own(new[n], self.cache_specs[i][n],
                                 self._skip(i, n))
            if part.data_ptr() != loc.data_ptr() or loc.device.type == "meta":
                loc.copy_(part)
        return cache

    def store_caches(self, mesh, caches):
        """A prefill's caches in the compute layout (the rank's rows; a
        recurrent mixer's region's dimensions split over the model axis;
        all else whole: a tensor-parallel attention's K/V come gathered to
        every KV head, `layers.whole_kv`) as the rank's stored shards
        (DTensors of the global caches)."""
        rows = self.comm.dp_size if self.comm.rows else 1
        n = self.comm.sizes[self.comm.tp] if self.comm.tp else 1
        out, shapes = [], []
        for i, c in enumerate(caches):
            layer = {}
            for name, t in c.items():
                shape = list(t.shape)
                shape[0] *= rows
                for d in self.model_dims(i, name):
                    shape[d] *= n
                layer[name] = torch.empty(shape, device="meta")
            shapes.append(layer)
        self.cache_specs = sharding.cache_specs(mesh, self.cfg, shapes)
        for i, c in enumerate(caches):
            layer = {}
            for name, t in c.items():
                spec = self.cache_specs[i][name]
                dims = self.model_dims(i, name)
                if any(self.comm.tp not in sharding._axes(spec[d])
                       for d in dims):
                    raise ValueError(f"layer {i}'s {name} is split over the "
                                     f"model axis on {dims}, stored {spec}")
                skip = ((0,) if self.comm.rows else ()) + dims
                layer[name] = sharding.wrap(
                    mesh, self.comm.own(t, spec, skip).contiguous(),
                    shapes[i][name].shape, spec)
            out.append(layer)
        return out


def _recurrent_dims(cfg, kind: str, name: str, n: int) -> tuple[int, ...]:
    """A recurrent mixer's cache dimensions its region keeps split over a
    model axis of n (those the rules split, `sharding.cache_specs`):
    Mamba's d_inner; an sLSTM's head dim; an mLSTM's trailing head dim
    (C's key dim, n's), its m whole."""
    if kind == "mamba":
        return ({"conv": (2,), "ssm": (1,)}[name]
                if cfg.d_inner % n == 0 else ())
    if cfg.hd % n:
        return ()
    if kind == "slstm":
        return (2,)
    return {"C": (3,), "n": (2,), "m": ()}[name]


def whole(tree):
    """A tree of DTensors (caches, moments) as whole tensors on every
    rank, gathered through this module's collectives."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: whole(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [whole(v) for v in tree]
    if not isinstance(tree, DTensor):
        return tree
    return Comm(tree.device_mesh).gather_spec(tree.to_local(),
                                              spec_of(tree))


def to_rank0(t):
    """DTensor `t` whole in rank 0's host memory (None on the other
    ranks): every rank sends its shard to rank 0 (`dist.gather`; host
    tensors under gloo), which puts each at its block."""
    import numpy as np
    import torch.distributed as dist

    mesh, spec = t.device_mesh, spec_of(t)
    part = t.to_local().contiguous()
    if dist.get_backend() == "gloo":
        part = part.cpu()
    bits = _BITS.get(part.dtype)
    wire = part if bits is None else part.view(bits)
    rank = dist.get_rank()
    parts = ([torch.empty_like(wire) for _ in range(dist.get_world_size())]
             if rank == 0 else None)
    with torch.no_grad():
        dist.gather(wire, parts, dst=0)
    if rank != 0:
        return None
    whole = torch.empty(t.shape, dtype=t.dtype)
    ranks = mesh.mesh.cpu().numpy()
    for r, buf in enumerate(parts):
        coords = dict(zip(mesh.mesh_dim_names, (
            int(c) for c in np.argwhere(ranks == r)[0])))
        buf = buf.cpu() if bits is None else buf.cpu().view(t.dtype)
        whole[sharding.shard_slices(mesh, t.shape, spec, coords)] = buf
    return whole


def spec_of(t) -> tuple:
    """A DTensor's placements as a spec (axes sharding a dimension in
    mesh order)."""
    from torch.distributed.tensor import Shard

    names = t.device_mesh.mesh_dim_names
    entries: list = [[] for _ in range(t.ndim)]
    for m, p in enumerate(t.placements):
        if isinstance(p, Shard):
            entries[p.dim].append(names[m])
    return tuple(None if not e else (e[0] if len(e) == 1 else tuple(e))
                 for e in entries)
