"""Dry run of the LM steps on the production mesh, for one rank, on meta
tensors (port of `repro/launch/dryrun.py`).

For every (architecture x input shape) cell, run the port's own step
(train_step / prefill_step / serve_step, `launch/steps.py`) for the rank
at coordinate 0 of the production mesh — (16, 16) = ("data", "model")
single-pod and (2, 16, 16) = ("pod", "data", "model") multi-pod — on a
shape-only mesh (`launch/mesh.abstract_mesh`) with every tensor on the
`meta` device, so it needs no card and no world, and record:

  * the rank's argument bytes, exact from its shard shapes;
  * the peak bytes of live tensors during the step (tracked on the meta
    tensors the step makes, its arguments included);
  * its operations (`torch.utils.flop_counter.FlopCounterMode`) and the
    bytes its ops read and write (each op's inputs and outputs, views
    excluded: an unfused upper count of its HBM traffic);
  * its collectives by op, with bytes and counts, from
    `launch/collectives.py`'s dry mode, by the axis each runs over and by
    the link each crosses;
  * `model_flops / n_chips` and the roofline at the H100's terms
    (`launch/roofline.LMRoofline`).

Two paths cannot run as they are on meta tensors, and the dry run
replaces them for the step's call (`shape_only_paths`): the token draw
(K1's retries read values), whose K1 and K2 a decode cell counts from
`launch/kernel_cost.py` by shape, as the profiler does; and the Mamba and
sLSTM scans, a loop over every position (hours at 32k positions), run
as spans of positions folded into the batch.  A span's ops are the
loop's ops over its positions, but its states are alive at once, so the
peak bytes of jamba's and xlstm-350m's cells are upper counts.  These are
computed numbers, not measurements.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
        --cell decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single \\
        --out build/dryrun
    PYTHONPATH=src python -m repro_torch.launch.report build/dryrun

Results land in `<out>/<arch>__<cell>__<mesh>__<tag>.json` (`build/dryrun`
by default); `--all` runs each pending cell in a fresh subprocess, so a
failed cell leaves a `.err` log and the sweep goes on, and a re-run skips
the cells already written (resumable).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from pathlib import Path

RESULTS_DIR = str(Path(__file__).resolve().parents[3] / "build" / "dryrun")
MESHES = {"single": (16, 16), "multi": (2, 16, 16)}


def _levels(vocab: int, branch: int = 128) -> int:
    """Levels of the KY token draw's tree over `vocab` (K1 launches a
    token)."""
    n, levels = vocab, 1
    while -(-n // branch) > 1:
        n, levels = -(-n // branch), levels + 1
    return levels


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tree_bytes(tree) -> int:
    import torch

    if isinstance(tree, torch.nn.Module):
        return sum(_nbytes(p) for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return _nbytes(tree)


def _op_counter(live0: int):
    """A dispatch mode over meta tensors: each op's input and output bytes
    (ops whose outputs alias an input move nothing), and the bytes of the
    tensors alive (each op's new outputs until they are freed), with its
    peak."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.live = self.peak = live0
            self.io_bytes = 0

        def _free(self, n: int) -> None:
            self.live -= n

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            aliased = any(r.alias_info is not None
                          for r in func._schema.returns)
            if aliased:
                return out
            tensors = lambda x: [t for t in tree_flatten(x)[0]
                                 if isinstance(t, torch.Tensor)]
            outs = tensors(out)
            self.io_bytes += sum(_nbytes(t) for t in tensors((args, kwargs)))
            for t in outs:
                n = _nbytes(t)
                self.io_bytes += n
                self.live += n
                weakref.finalize(t, self._free, n)
            self.peak = max(self.peak, self.live)
            return out

    return Ops()


def _spans(s: int) -> list[tuple[int, int]]:
    """The position spans a scan takes as one step: all S under autograd
    (which keeps every position's state, as the loop does), else spans of
    ceil(S/512) positions."""
    import torch

    n = s if torch.is_grad_enabled() else -(-s // 512)
    return [(t, min(s, t + n)) for t in range(0, s, n)]


def _mamba_spans(h, xs, dts, bs, cs, a):
    """`ssm.scan` with each span of positions one `ssm_step` over the span
    folded into the batch, each from the span's first state."""
    import torch

    from repro_torch.models import ssm

    b, ys = xs.shape[0], []
    for t0, t1 in _spans(xs.shape[1]):
        n = t1 - t0
        fold = lambda t: t[:, t0:t1].reshape(b * n, *t.shape[2:])
        h_all, y = ssm.ssm_step(h.repeat_interleave(n, 0), fold(xs),
                                fold(dts), fold(bs), fold(cs), a)
        ys.append(y.view(b, n, -1))
        h = h_all.view(b, n, *h.shape[1:])[:, -1]
    return h, torch.cat(ys, dim=1)


def _slstm_spans(pre, r, state, tp=None):
    """`xlstm.slstm_scan` with each span of positions one `slstm_step`
    over the span folded into the batch (a split recurrence's gathers
    then one a span, of the span's bytes)."""
    import torch

    from repro_torch.models import xlstm

    b, hs = pre.shape[0], []
    for t0, t1 in _spans(pre.shape[1]):
        n = t1 - t0
        h_t, new = xlstm.slstm_step(
            pre[:, t0:t1].reshape(b * n, *pre.shape[2:]), r,
            {k: v.repeat_interleave(n, 0) for k, v in state.items()}, tp)
        hs.append(h_t.view(b, n, *h_t.shape[1:]))
        state = {k: v.view(b, n, *v.shape[1:])[:, -1]
                 for k, v in new.items()}
    return torch.cat(hs, dim=1), state


def _meta_tokens(logits, *args, **kwargs):
    import torch

    return torch.empty(logits.shape[0], dtype=torch.int32,
                       device=logits.device)


@contextlib.contextmanager
def shape_only_paths():
    """Within: the recurrent scans as spans (`_mamba_spans`,
    `_slstm_spans`) and the token draw as meta tokens (K1 and K2 priced
    by `cell_inputs`)."""
    from repro_torch.models import sampling, ssm, xlstm

    swaps = ((ssm, "scan", _mamba_spans),
             (xlstm, "slstm_scan", _slstm_spans),
             (sampling, "sample_tokens", _meta_tokens))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def cell_inputs(cfg, kind: str, seq: int, batch: int, mesh):
    """(step fn, its arguments, the rank's argument bytes, K1/K2 cost)."""
    import torch

    from repro_torch import prng
    from repro_torch.launch import kernel_cost, sharding
    from repro_torch.launch import steps as steps_lib

    if kind == "train":
        opt_cfg = steps_lib.default_opt_cfg(cfg)
        with_batch, sh = steps_lib.make_train_step(cfg, mesh, opt_cfg)
        batch_abs = steps_lib.abstract_batch(cfg, seq, batch)
        fn, bspecs = with_batch(batch_abs)
        params = sharding.distribute(
            mesh, steps_lib.abstract_params(cfg, train=True), sh["params"],
            cfg=cfg)
        opt = sharding.distribute(
            mesh, steps_lib.abstract_opt_state(cfg, opt_cfg), sh["opt"],
            cfg=cfg)
        local_batch = sharding.distribute(mesh, batch_abs, bspecs)
        arg_bytes = (_tree_bytes(params) + _tree_bytes(opt)
                     + _tree_bytes(local_batch))
        return fn, (params, opt, batch_abs), arg_bytes, None
    params_model = steps_lib.abstract_params(cfg)
    params = sharding.distribute(
        mesh, params_model, sharding.param_specs(mesh, cfg, params_model),
        cfg=cfg)
    if kind == "prefill":
        batch_abs = steps_lib.abstract_batch(cfg, seq, batch)
        del batch_abs["labels"]
        fn = steps_lib.make_prefill_step(cfg, mesh)(batch_abs)
        local_batch = sharding.distribute(
            mesh, batch_abs, sharding.batch_specs(mesh, cfg, batch_abs))
        return (fn, (params, batch_abs),
                _tree_bytes(params) + _tree_bytes(local_batch), None)
    caches = steps_lib.abstract_caches(cfg, batch, seq)
    fn, cspecs = steps_lib.make_serve_step(cfg, mesh, sampler="ky")(
        caches, batch)
    tokens = torch.empty((batch, 1), dtype=torch.int32, device="meta")
    tspecs = sharding.batch_specs(mesh, cfg, {"tokens": tokens})
    local = (_tree_bytes(sharding.distribute(mesh, caches, cspecs))
             + _tree_bytes(sharding.distribute(mesh, {"tokens": tokens},
                                               tspecs)))
    # pos (int32) and the key (two uint32 words), as the reference's step
    arg_bytes = _tree_bytes(params) + local + 4 + 8
    draw = (kernel_cost.lut_exp(batch * cfg.vocab, 32)
            + _levels(cfg.vocab) * kernel_cost.ky_sample_keyed(batch, 128))
    return (fn, (params, tokens, caches, seq - 1, prng.key(0)), arg_bytes,
            draw)


def run_cell(arch: str, cell: str, mesh_kind: str, out_dir: str,
             opt_tag: str = "baseline") -> dict:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import roofline as rl
    from repro_torch.launch import steps as steps_lib

    cfg = get_config(arch)
    spec = steps_lib.SHAPE_CELLS[cell]
    fname = os.path.join(out_dir, f"{arch}__{cell}__{mesh_kind}__{opt_tag}")
    os.makedirs(out_dir, exist_ok=True)
    ok, why = steps_lib.cell_applicable(cfg, cell)
    if not ok:
        rec = {"arch": arch, "cell": cell, "mesh": mesh_kind,
               "opt": opt_tag, "status": "skipped", "reason": why}
        with open(fname + ".json", "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[dryrun] {arch} {cell} {mesh_kind}: SKIPPED ({why[:60]})")
        return rec

    mesh = mesh_lib.abstract_mesh(MESHES[mesh_kind])
    n_chips = mesh.size()
    seq, batch, kind = spec["seq"], spec["batch"], spec["kind"]
    t0 = time.time()
    fn, args, arg_bytes, draw = cell_inputs(cfg, kind, seq, batch, mesh)
    t_build = time.time() - t0
    comm = fn.comm  # the step's collectives: counted from here on
    for counter in (comm.count, comm.nbytes, comm.link_bytes,
                    comm.axis_bytes, comm.axis_count):
        counter.clear()
    ops = _op_counter(arg_bytes)
    with FlopCounterMode(display=False) as fc, ops, shape_only_paths():
        out = fn(*args)
    del out
    t_run = time.time() - t0 - t_build
    flops = float(fc.get_total_flops())

    coll = rl.CollectiveStats(dict(comm.nbytes), dict(comm.count),
                              dict(comm.link_bytes))
    extra = 0.0
    if draw is not None:  # K1/K2 at the larger of their two bounds
        extra = max(draw.hbm_bytes / rl.HBM_BW,
                    rl.hash_seconds(draw.hash_calls))
    roof = rl.LMRoofline(
        flops=flops, hbm_bytes=float(ops.io_bytes), collectives=coll,
        model_flops=rl.model_flops(cfg, kind, seq, batch) / n_chips,
        extra_seconds=extra)
    rec = {
        "arch": arch, "cell": cell, "mesh": mesh_kind, "opt": opt_tag,
        "status": "ok", "computed": True, "n_chips": int(n_chips),
        "seq": seq, "batch": batch, "kind": kind,
        "build_s": round(t_build, 1), "run_s": round(t_run, 1),
        "memory": {"argument_size_in_bytes": int(arg_bytes),
                   "peak_live_bytes": int(ops.peak),
                   "temp_size_in_bytes": int(ops.peak - arg_bytes)},
        "cost": {"flops": flops, "bytes accessed": float(ops.io_bytes)},
        "token_draw": None if draw is None else {
            "flops": draw.flops, "hbm_bytes": draw.hbm_bytes,
            "hash_calls": draw.hash_calls, "seconds": extra},
        "collectives": {"bytes_by_op": coll.bytes_by_op,
                        "count_by_op": coll.count_by_op,
                        "bytes_by_link": coll.bytes_by_link,
                        "bytes_by_axis": dict(comm.axis_bytes),
                        "total_bytes": coll.total_bytes},
        "roofline": roof.as_dict(),
    }
    with open(fname + ".json", "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[dryrun] {arch} {cell} {mesh_kind}: OK (run {t_run:.0f}s, "
          f"args {arg_bytes / 2**30:.2f} GiB, peak "
          f"{ops.peak / 2**30:.2f} GiB, bottleneck {roof.bottleneck})")
    return rec


def drive_all(meshes, archs, cells, out_dir, tag="baseline"):
    """Run every pending cell in a fresh subprocess (resumable,
    isolated)."""
    from repro_torch.configs import list_archs
    from repro_torch.launch.steps import SHAPE_CELLS

    archs = archs or list_archs()
    cells = cells or list(SHAPE_CELLS)
    todo = [(a, c, m) for m in meshes for a in archs for c in cells
            if not os.path.exists(os.path.join(
                out_dir, f"{a}__{c}__{m}__{tag}.json"))]
    print(f"[dryrun] {len(todo)} cells to run")
    failures = []
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve()
                                           .parents[2])}
    for i, (arch, cell, mesh_kind) in enumerate(todo):
        print(f"[dryrun] ({i + 1}/{len(todo)}) {arch} {cell} {mesh_kind}",
              flush=True)
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--cell", cell, "--mesh", mesh_kind, "--out", out_dir,
             "--tag", tag],
            capture_output=True, text=True, timeout=7200, env=env)
        if r.returncode != 0:
            failures.append((arch, cell, mesh_kind))
            err_file = os.path.join(
                out_dir, f"{arch}__{cell}__{mesh_kind}__{tag}.err")
            with open(err_file, "w") as f:
                f.write(r.stdout[-5000:] + "\n---\n" + r.stderr[-10000:])
            print(f"[dryrun]   FAILED (log: {err_file})", flush=True)
        else:
            print(r.stdout.strip().splitlines()[-1] if r.stdout.strip()
                  else "[dryrun]   ok", flush=True)
    print(f"[dryrun] done: {len(todo) - len(failures)} ok, "
          f"{len(failures)} failed")
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None,
                    choices=[None, "train_4k", "prefill_32k", "decode_32k",
                             "long_500k"])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="sweep mode: a subprocess per pending cell")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        failures = drive_all(meshes, [args.arch] if args.arch else None,
                             [args.cell] if args.cell else None, args.out,
                             args.tag)
        return 1 if failures else 0
    if not (args.arch and args.cell):
        ap.error("--arch and --cell (or --all)")
    try:
        run_cell(args.arch, args.cell, meshes[0], args.out, args.tag)
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
