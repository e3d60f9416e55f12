#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port alone (never JAX or the JAX package) through these phases,
each printing one JSON line; any failure raises and exits non-zero:

 1. build   — nvcc builds the four kernel libraries (K1-K6) from
              `src/repro_torch/kernels/csrc/` (one process per source, in
              parallel); prints the build
              time, ptxas' register/spill report (for K1 per instance:
              registers, stack and spill bytes, and it fails if one
              spills) and the card's name and power limit.
 1a. threefry — the device function K3-K6 hash their random words
              with (`aia::jax_word`, through its test entry
              `ops.device_bits`) against `prng.bits` on 2^24 counters under
              three keys, and on 2^20 counters across the 2^32 boundary:
              bit-equal.  Times both.  Reads the integer instructions of
              one call from the SASS of the test entry's loop (cuobjdump)
              and fails if the 2^24 calls ran faster than those
              instructions allow at the rates the bounds assume.
 2. k2      — K2 (LUT lerp) against its torch twin on 2^24 floats in
              [-10, 1] through the exp-weight LUT: bit-equal.  Also counts
              where PyTorch's CUDA division by a Python scalar differs from
              a true division and from the reciprocal multiply the port
              uses (XLA's compiled form of the reference's `/ dx`).
 3. k1      — K1 (KY draw), both entries (words read, and words hashed
              in the kernel from a key), against its twin on the key's
              words: 65,573 rows (a ragged last warp) of random weights
              with edge rows first (all zero, one-hot, negative, all below
              -1, multiples of 2^p, summing above 2^p, wrapping int32) at
              1-127 bins, precision 16 and 21, 8 retries and 1 (bits run
              out): labels and the three stats bit-equal.
 4. k3      — K3 (one BN sweep, words hashed inside the kernel from the
              sweep's key) against its twin on the same key's words for
              pigs and hailfinder at 1,024 chains: lut_ky bit-equal;
              exact_ky reports the share of differing labels, and its
              marginals over 200 sweeps lie within per-node TV 0.02 of the
              twin's.  Reports the threefry calls the rows' walks need.
 5. serve   — the main path.  Launch counters are zeroed, then the port
              serves: 4 posterior queries on pigs (each with its own 5-20
              observed nodes and seed) and 1 on hailfinder through
              `compile_graph(...).run(key, n_chains=1024, n_iters=200,
              burn_in=50, fused=True)`, and one direct draw request (65,536
              rows of 32 log-potentials through `ops.lut_exp_weights` and
              `ops.ky_sample`, which makes no word in plain torch).
              Counters are read right after.  Each query
              is bit-equal to `fused=False`; a run sliced 100 + 100 through
              `carry_state` equals the whole run; K3's launches equal the
              sweeps served plus the first-use cross-checks'; the plain-
              torch generator (`prng._raw_bits`) ran only for each query's
              chain init, and not once in the resumed 100 sweeps; marginals
              on asia agree with exact variable elimination.
 6. k4      — K4 (one MRF half-step, words hashed inside the kernel from
              the half-step's key) against its twin on the same key's words
              at 1,024 chains, both parities, on Penguin (64 x 64, 4
              labels), Art (48 x 48, 8 labels) and quadratic-cost Art, the
              widths of the reference's MRF benchmark: labels bit-equal.
 7. serve_mrf — the MRF main path.  Counters zeroed, then one denoising
              query per model through `compile_graph(GridMRF).run(key,
              evidence=noisy, n_chains=1024, n_iters=200, fused=True)`
              (warm-up + timed), counters read right after: K4 launched
              2 x 200 times per query plus the first-use cross-check's
              2 x 3 per program.  Then, at 1,024 chains x 20 iterations:
              fused equals `fused=False`, 10 + 10 iterations through
              `carry_state` equal 20, 64 pixels pinned at their clean
              labels hold in every chain; chain 0 of each Potts query has
              fewer wrong pixels than the noisy image; and the plain-torch
              generator ran only for the chain init (none in a resumed
              run).
 8. diag    — `diagnostics=True`: on asia, each of lut_ky, exact_ky, cdf
              and gumbel gives a snapshot whose per-node p_hat is within TV
              0.05 of exact variable elimination; the Penguin query with
              diagnostics draws the served labels, and its snapshot's
              per-pixel argmax beats the noisy image.
 9. k5      — K5 (one colour round on every position of a mesh per
              launch, words hashed inside the kernel from the sweep's key)
              against its twin per position on the round's full stream,
              for pigs and hailfinder at 1,024 chains under the ownership
              of a (2, 4) mesh: every round of one sweep, both from the
              same pre-round values; lut_ky bit-equal, exact_ky reports the
              share of differing labels per round; and one launch of the
              one-position entry against its twin.
10. k6      — K6 (one MRF half-step over every row slab of a mesh per
              launch, words hashed inside the kernel) against its twin per
              slab on the half-step's full words at 1,024 chains on the
              (2, 4) mesh (4-way row split) of Penguin, Art and
              Art-quadratic, random halo rows holding -1, both parities;
              and a block of half the chains at an odd global row:
              bit-equal.
11. serve_sharded — the sharded main path.  Counters zeroed, then
              `compile_graph(query).run_sharded(key, make_mesh((2, 4)),
              n_chains=1024, n_iters=200, fused=True)` for the 4 pigs and 1
              hailfinder queries of `serve` (evidence baked, burn-in 50) and
              for Penguin, Art and Art-quadratic (evidence image at run
              time); counters read right after: K5 launched once per round
              (rounds per sweep) and K6 twice per iteration, plus the
              first-use cross-checks', and K3/K4 only in the cross-checks'
              single-device legs; the plain-torch generator
              (`prng._raw_bits`) ran only for each query's chain init.  Each
              query equals `run(fused=True)` bit for bit; a pigs query
              sliced 100 sharded + 100 single-device, and 100 + 100 sharded,
              equals the whole run, and so does Penguin 100 + 100 sharded,
              the resumed halves making no word in plain torch; the legacy
              `fused=False` route on asia (100 sweeps) is within TV 0.05 of
              exact variable elimination.
12. timing  — every kernel and its twin at the main paths' shapes: the
              kernel's device time (torch.profiler) and time per call (CUDA
              events), the twin's time (for K3-K6 with the key's words
              generated, as the function's input is the key), and the least
              time the card needs for the same bytes and operations (K3-K6
              take their bytes and threefry calls from `launch.
              kernel_cost`, which `profile` held against this run's
              walks; each call at
              the instructions the threefry phase read from the SASS: its
              bit operations on 132 SMs x 64 ALU lanes, all of its integer
              instructions at 132 x 128 issue lanes, x the SM clock); K1
              through both entries, beside `torch.multinomial` on the same
              weights; K1 and K2 also alone at the shapes their bodies
              take inside K3 on pigs; the draw request's wall by part
              (timing_draw_request); one pigs sweep alone and in the query
              loop, wall,
              device and host time by part (key split, wrapper, histogram),
              and one Penguin half-step back to back with the card's busy
              share, beside the plain-torch word generation they no longer
              run; K5 per round launch of a pigs sweep and K6 per Penguin
              half-step launch on the (2, 4) mesh; one sharded pigs sweep
              and one sharded Penguin half-step by part (K5 and the psum
              merge, K6 and the halo exchange).  Prints `{"kernels":
              [...]}` (K1-K6, and K3's and K4's lane entries).
13. k3_lanes / k4_lanes (run before `timing`) — K3's lane entry
              (`bn_sweep_lanes`: one sweep over the chains of Q queries,
              each with its own key read from device memory) on pigs, and
              K4's (`mrf_half_step_lanes`: one half-step over Q queries,
              each with its own key and evidence plane) on Penguin and
              Art, at Q = 3 x 1,024 chains, and K3's on hailfinder at the
              runtime bucket's Q = 2: bit-equal to their twins and to the
              one-query kernels run query by query (exact_ky too); 1,024
              chains are no multiple of K3's chains per block on pigs, so
              every query's last block is partial.
14. serve_runtime (run before `timing`) — the serving runtime's main
              path: `Engine(fused=True, max_batch=8, n_workers=4,
              shard_width=4, shard_min_sites=4096, slice_iters=100)` over
              8 pigs queries sharing one observed-node set (own values and
              seeds), 2 hailfinder queries and 4 Penguin queries (2 pinned:
              the vmap route; 2 unpinned: the sharded route), all 1,024
              chains x 200 sweeps, programs cold.  Counters zeroed before
              `run()` and read after: K3's lane entry launched once per
              sweep of each BN bucket (not once per query), K4's twice per
              iteration of the pinned Penguin bucket, K6 twice per
              iteration of each sharded query, plus the first-use
              cross-checks'.  Every answer equals the standalone
              `program.run(key, ..., fused=True)` and the unsliced
              engine's, bit for bit; pins hold.  Then each bucket's wall
              (WALL_REPS warm runs; CUDA events around each dispatch,
              which ends in the answers' copy to the host) beside the sum
              of its queries' standalone walls (WALL_REPS runs each,
              answers copied to the host too), as medians with their
              least and largest, with queries per wall-second, and
              `engine.calibrate()`'s medians beside the line model's
              predictions.  `timing` adds the lane entries' rows: K3's at
              the pigs bucket (8 x 1,024), K4's at the pinned Penguin
              bucket (2 x 1,024), each held against its twin on the same
              inputs, and the bucket loops per sweep or iteration
              (timing_runtime_bucket_sweep: pigs by part, batched key
              split, K3 lane wrapper, histogram, the card's busy share;
              timing_lane_loops: the pigs and pinned Penguin bucket loops
              at their served Q and at Q = 1 beside the one-query loop).
15. profile (after serve_runtime, before `timing`) — the profiler
              (`repro_torch.obs.profile`): the runtime phase's engine and
              14 queries replayed with profiling on; `profile.json`
              (build/profile/) validates, every dispatch (the sharded ones
              included) joins to a static cost from `launch.kernel_cost`
              whose roofline is at most 1.05x its measured wall, and every
              answer equals the replay without profiling.  `kernel_cost`'s
              per-launch bytes and threefry calls of K3, K4, both lane
              entries, K5 and K6 agree within 1% with the counts of this
              run's data (the twins' walks), and `timing` takes its bounds
              from them.  `python -m repro_torch.obs --profile` and
              `python -m repro_torch.diag --quick` exit 0; the engine's
              wall with profiling on and off, medians of 3 runs.

The last line is `{"ok": true, "device": {...}}`.  Without a CUDA device,
or run from a directory that lacks the port's sources, it prints no result
and exits 2.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# integer rates per SM and clock (H100 white paper: 64 INT32 and 128 FP32
# lanes per SM, 4 schedulers issuing one warp instruction each): LOP3, SHF
# and PRMT run only on the 64 INT32 lanes; an integer add runs there as
# IADD3 or on the FMA pipe as IMAD, so no mix of integer instructions
# issues faster than 128 lanes.  The clock is nvidia-smi's max SM clock.
SMS, ALU_LANES, ISSUE_LANES = 132, 64, 128

CHAINS = 1024
ITERS = 200
BURN_IN = 50
DEVICE = "cuda"

# the reference's MRF benchmark (benchmarks/bench_mrf.py:33-34): grid,
# labels, data cost; theta 1.2, h 2.0, evidence from
# make_denoising_problem(h, w, v, 0.25, seed=1)
MRF_MODELS = {
    "penguin": (64, 64, 4, "potts"),
    "art": (48, 48, 8, "potts"),
    "art_quadratic": (48, 48, 8, "quadratic"),
}
MRF_CHECK_ITERS = 20
MRF_PINS = 64
THREEFRY_COUNTERS = 1 << 24
# the device kernels' names, for the profiler: K3 and K5 are one kernel,
# and so are K4 and K6
BN_KERNEL = "bn_rounds_kernel"
MRF_KERNEL = "mrf_half_step_kernel"
# K1's instances (ky_lanes_kernel, ky_planes_kernel) share this prefix
K1_KERNEL = "ky_"
K1_WIDTHS = (1, 2, 3, 4, 11, 15, 16, 31, 32, 33, 63, 64, 65, 127)
K1_PRECISIONS = (16, 21)
DRAW_ROWS, DRAW_BINS = 1 << 16, 32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the port's sources (src/repro_torch) are not "
              "beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_all = time.perf_counter()
    card, k1_ptxas = timed(phase_build, torch)
    per_call = timed(phase_threefry, torch)
    timed(phase_k2, torch)
    timed(phase_k1, torch)
    k3_err = timed(phase_k3, torch)
    k4_err = timed(phase_k4, torch)
    launches = timed(phase_serve, torch)
    mrf_launches, served = timed(phase_serve_mrf, torch)
    timed(phase_diag, torch, served)
    k5_err = timed(phase_k5, torch)
    k6_err = timed(phase_k6, torch)
    sharded_launches = timed(phase_serve_sharded, torch, served)
    lanes_err = timed(phase_lanes, torch)
    runtime = timed(phase_serve_runtime, torch)
    counts = timed(phase_profile, torch)
    timed(phase_timing, torch, launches, k3_err, mrf_launches, k4_err,
          sharded_launches, k5_err, k6_err, per_call, k1_ptxas, runtime,
          lanes_err, counts)
    for mod in sys.modules:
        check(not (mod == "jax" or mod.startswith("jax.")
                   or mod == "repro" or mod.startswith("repro.")),
              f"{mod} was imported")
    emit({"phase": "done", "seconds": time.perf_counter() - t_all})
    print(card)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def timed(phase, *args):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = phase(*args)
    emit({"phase_seconds": phase.__name__, "s": time.perf_counter() - t0})
    return out


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def time_ms(torch, fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int, kernel: str):
    """Mean device time per call of the kernels whose name contains
    `kernel`, from torch.profiler's CUPTI trace (launch gaps excluded); None
    when the profiler recorded no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in kernel_events(torch, prof)
             if kernel in e.key)
    return us / reps / 1e3 if us > 0 else None


def device_busy_ms(torch, fn, reps: int) -> float:
    """Device time per call of every kernel `fn` launches (torch.profiler),
    for the card's busy share against the wall time per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total
               for e in kernel_events(torch, prof)) / 1e3 / reps


def kernel_events(torch, prof):
    """The profile's device-side kernel rows (the host ops that launched
    them carry the same device time and would count it twice)."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _wrappers() -> dict:
    from repro_torch.kernels import bn_gibbs, interp_lut, ky_sampler, mrf_gibbs

    return {
        "bn_sweep": bn_gibbs.bn_sweep,
        "ky_sample_kernel": ky_sampler.ky_sample_kernel,
        "interp_kernel": interp_lut.interp_kernel,
        "mrf_half_step": mrf_gibbs.mrf_half_step,
        "fused_color_round": bn_gibbs.fused_color_round,
        "mrf_halo_half_step": mrf_gibbs.mrf_halo_half_step,
        "bn_sweep_lanes": bn_gibbs.bn_sweep_lanes,
        "mrf_half_step_lanes": mrf_gibbs.mrf_half_step_lanes,
    }


def zero_launches() -> None:
    for wrapper in _wrappers().values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {name: w.launches for name, w in _wrappers().items()}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: float, ops: float, ops_rate: float = FP32_FLOPS,
          int_ms: float = 0.0):
    """Least ms for the work: the larger of its bytes at the HBM rate and
    its operations at their peak rate (float32 ops at `ops_rate`, and the
    integer work `int_ms`, from `hash_ms`)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / ops_rate * 1e3, int_ms)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def sm_clock_hz() -> float:
    """The SM's maximum clock as nvidia-smi reports it."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()[0]
    return float(mhz) * 1e6


def sass_loop_counts(sass: str, function: str) -> list[dict]:
    """Per loop of `function` in `cuobjdump -sass` output that stores
    (STG): its stores, its bit operations (LOP3, SHF, PRMT: the hash's
    xors and rotates), which only the ALU pipe runs, and its integer adds
    (IADD3, VIADD and IMAD forms other than moves and wide products),
    which either pipe runs.  A loop is the span from a branch's target
    back to the branch (targets as addresses or as `.L_x_` labels)."""
    lines, inside = [], False
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = function in ln
        elif inside:
            lines.append(ln)
    label = re.compile(r"^\s*(\.L_x_\d+):")
    instr = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)([^;]*);")
    labels, ops, pending = {}, [], []
    for ln in lines:
        m = label.match(ln)
        if m:
            pending.append(m.group(1))
            continue
        m = instr.search(ln)
        if m:
            addr = int(m.group(1), 16)
            labels.update((name, addr) for name in pending)
            pending = []
            ops.append((addr, m.group(2).split("."), m.group(3)))
    loops = []
    for addr, op, args in ops:
        target = re.search(r"(0x[0-9a-f]+|\.L_x_\d+)", args)
        if op[0] != "BRA" or not target:
            continue
        t = target.group(1)
        start = labels.get(t, addr + 1) if t.startswith(".") else int(t, 16)
        if start > addr:
            continue
        body = [o for a, o, _ in ops if start <= a <= addr]
        stores = sum(o[0] == "STG" for o in body)
        if not stores:
            continue
        loops.append({
            "instructions": len(body), "stores": stores,
            "bit_ops": sum(o[0] in ("LOP3", "SHF", "PRMT") for o in body),
            "add_ops": sum(o[0] in ("IADD3", "VIADD") or (
                o[0] == "IMAD" and not {"MOV", "WIDE"} & set(o))
                for o in body),
        })
    return loops


def threefry_sass(torch) -> dict:
    """Integer instructions per `aia::jax_word` call, read from the SASS of
    its test entry's kernel (`threefry_words_kernel`, the same in every
    library) in the built interp_lut library: the storing loop with the
    fewest bit operations per store, per store.  Its adds include the
    loop's 64-bit index step."""
    from repro_torch.kernels import _lib

    tool = Path(_lib.nvcc()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(tool), "-sass", str(_lib.library_path("interp_lut"))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    loops = sass_loop_counts(sass, "threefry_words_kernel")
    check(bool(loops), "no storing loop in threefry_words_kernel's SASS")
    best = min(loops, key=lambda lp: lp["bit_ops"] / lp["stores"])
    return {"loops": loops,
            "bit_ops_per_call": best["bit_ops"] / best["stores"],
            "add_ops_per_call": best["add_ops"] / best["stores"],
            "sm_clock_hz": sm_clock_hz()}


def hash_ms(calls: int, per_call: dict) -> float:
    """Least ms for `calls` threefry calls: their bit operations on the
    ALU lanes, and all their integer instructions at the issue rate."""
    clock = per_call["sm_clock_hz"]
    bit = calls * per_call["bit_ops_per_call"] / (SMS * ALU_LANES * clock)
    every = calls * (per_call["bit_ops_per_call"]
                     + per_call["add_ops_per_call"]) / (
        SMS * ISSUE_LANES * clock)
    return max(bit, every) * 1e3


def ptxas_entries(log: str, prefix: str) -> list[dict]:
    """Registers, stack frame and spill bytes of each kernel template
    instance `<prefix>..._kernel<N, Source>` in an `nvcc -Xptxas -v` log,
    named from its mangled template arguments."""
    entries, cur = [], None
    name = re.compile(r"\d+(" + re.escape(prefix) + r"\w*?_kernel)ILi(\d+)"
                      r"ENS_(\d+)")
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            t, cur = name.search(m.group(1)), None
            if t:
                source = m.group(1)[t.end():t.end() + int(t.group(3))]
                cur = {"function": f"{t.group(1)}<{t.group(2)}, {source}>"}
                entries.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return entries


class WalkBits:
    """Records `bits_used` of every KY walk the twins run (through
    `ky.ky_sample_fast`) while active: `threefry_calls` is the sum over
    rows of ceil(bits / 32), the words, and so the threefry calls, that
    the kernel's walk of the same rows hashes."""

    def __enter__(self):
        from repro_torch.core import ky as ky_core

        self._ky, self._fast, self.bits = ky_core, ky_core.ky_sample_fast, []

        def fast(*args, **kwargs):
            out = self._fast(*args, **kwargs)
            self.bits.append(out[1]["bits_used"])
            return out

        ky_core.ky_sample_fast = fast
        return self

    def __exit__(self, *exc):
        self._ky.ky_sample_fast = self._fast

    @property
    def threefry_calls(self) -> int:
        return sum(int(((b.long() + 31) // 32).sum()) for b in self.bits)


def exp_lut(device):
    from repro_torch.core.interp import build_exp_weight_lut

    return build_exp_weight_lut(device=device)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build(torch) -> str:
    from repro_torch.kernels import _lib

    t0 = time.perf_counter()
    seconds = _lib.build()
    ptxas = {}
    for name in _lib.SOURCES:
        log = _lib.BUILD_DIR / f"{name}.log"
        if log.exists():
            ptxas[name] = [
                ln.strip() for ln in log.read_text().splitlines()
                if "registers" in ln or "spill" in ln
            ]
    # K1's instances, one per layout and word source, from this build's log
    k1_log = _lib.BUILD_DIR / "ky_sampler.log"
    k1 = ptxas_entries(k1_log.read_text(), K1_KERNEL) if k1_log.exists() \
        else []
    card = nvidia_smi()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_library_s": seconds, "ptxas": ptxas, "k1_instances": k1,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvidia_smi": card})
    print(card, flush=True)
    check(len(k1) == 10, f"K1's build log names {len(k1)} instances, not "
          f"10 (two word sources x five layouts)")
    check(all(e.get("spill_store_bytes") == 0 and e.get("spill_load_bytes")
              == 0 and e.get("stack_bytes") == 0 for e in k1),
          f"a K1 instance spills or keeps a stack: {k1}")
    return card, k1


def phase_threefry(torch):
    """`aia::jax_word` (the device function of K3's and K4's words) against
    `prng.bits`, the plain-torch generator the twins and K5/K6 use."""
    from repro_torch import prng
    from repro_torch.kernels import ops

    dev = torch.device(DEVICE)
    n = THREEFRY_COUNTERS
    out = {"phase": "threefry", "counters": n, "mismatches": {}}
    for seed in (0, 1234, 2**32 - 1):
        k = prng.key(seed)
        got = ops.device_bits(k, n, 0, dev)
        want = prng.bits(k, (n,), dev)
        bad = int((got != want).sum())
        out["mismatches"][str(seed)] = bad
        check(bad == 0, f"aia::jax_word differs from prng.bits in {bad} of "
              f"{n} words (seed {seed})")
    # a window across the 2^32 boundary: the counter's high word is 1 after
    start, m = (1 << 32) - (1 << 19), 1 << 20
    bad = int((ops.device_bits(k, m, start, dev)
               != prng.bits(k, (m,), dev, start=start)).sum())
    out["mismatches"]["across_2^32"] = bad
    check(bad == 0, f"aia::jax_word differs across the 2^32 counter boundary "
          f"in {bad} words")
    out["device_function_ms"] = time_ms(
        torch, lambda: ops.device_bits(k, n, 0, dev), 20)
    out["prng_bits_ms"] = time_ms(torch, lambda: prng.bits(k, (n,), dev), 5)
    out["device_function_words_per_s"] = n / (out["device_function_ms"] / 1e3)
    # the instructions of one call, from the SASS; the least time they
    # allow for these n words must not exceed the time measured, or the
    # count or the rates (and so K3's and K4's bounds) are wrong
    per_call = threefry_sass(torch)
    out["sass"] = per_call
    out["hash_bound_ms"] = hash_ms(n, per_call)
    check(out["hash_bound_ms"] <= out["device_function_ms"],
          f"{n} threefry calls took {out['device_function_ms']} ms, less "
          f"than the {out['hash_bound_ms']} ms their instructions need at "
          f"the rates assumed")
    emit(out)
    return per_call


def phase_k2(torch):
    from repro_torch.core.interp import inv_dx
    from repro_torch.kernels import interp_lut

    dev = torch.device(DEVICE)
    tab, spec = exp_lut(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.rand(1 << 24, generator=g, device=dev) * 11.0 - 10.0
    y_k = interp_lut.interp_kernel(x, tab, spec)
    y_t = interp_lut.interp_kernel_ref(x, tab, spec)
    torch.cuda.synchronize()
    diff = int((y_k.view(torch.int32) != y_t.view(torch.int32)).sum())
    # PyTorch's CUDA division by a Python scalar, against the true division
    # and against the reciprocal multiply the port takes from XLA
    shifted = x - spec.x0
    by_scalar = shifted / spec.dx
    true_div = shifted / torch.full((), spec.dx, device=dev)
    recip = shifted * torch.full((), inv_dx(spec), device=dev)
    emit({"phase": "k2", "n": x.numel(), "mismatches": diff,
          "scalar_division_vs_true_division": int(
              (by_scalar != true_div).sum()),
          "scalar_division_vs_reciprocal_multiply": int(
              (by_scalar != recip).sum())})
    check(diff == 0, f"K2 differs from its twin in {diff} elements")


def k1_rows(torch, n_bins: int, precision: int, rows: int, seed: int):
    """`rows` random KY weights in [0, 256) on the card, the edge rows
    first: all zero, one-hot, some negative, all below -1, all 2^p (a walk
    past level p - 1), one bin of 2^p, a sum above 2^p, a sum that wraps
    int32, all -1."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    w = rand(0, 256, (rows, n_bins))
    w[0] = 0
    w[1] = 0
    w[1, -1] = 255
    w[2] = rand(-300, 50, (n_bins,))
    w[3] = rand(-1000, -1, (n_bins,))
    w[4] = 1 << precision
    w[5] = 0
    w[5, 0] = 1 << precision
    w[6] = (1 << precision) // 2 + rand(0, 1000, (n_bins,))
    w[7] = 2**31 - 1
    w[8] = -1
    return w


def phase_k1(torch):
    """Both K1 entries against the twin on the key's words."""
    from repro_torch import prng
    from repro_torch.core import ky as ky_core
    from repro_torch.kernels import ky_sampler

    dev = torch.device(DEVICE)
    rows = (1 << 16) + 37
    out = {"phase": "k1", "rows": rows, "mismatches": {}, "fallbacks": {}}
    for v in K1_WIDTHS:
        for p in K1_PRECISIONS:
            for retries in (8, 1):
                w = k1_rows(torch, v, p, rows, 1000 * v + p)
                key = prng.key(100 * v + p + retries)
                kw = dict(n_bins=v, precision=p, max_retries=retries)
                words = ky_core.random_words(
                    key, (rows,), ky_sampler.n_words_for(p, retries), dev)
                lab_t, st_t = ky_sampler.ky_sample_kernel_ref(w, words, **kw)
                bad = []
                for lab, st in (ky_sampler.ky_sample_kernel(w, words, **kw),
                                ky_sampler.ky_sample_keyed(w, key, **kw)):
                    n = int((lab != lab_t).sum())
                    for name in ("bits_used", "rejections", "fallback"):
                        n += int((st[name] != st_t[name]).sum())
                    bad.append(n)
                case = f"{v}/{p}/{retries}"
                out["mismatches"][case] = bad
                out["fallbacks"][case] = int(st_t["fallback"].sum())
                check(bad == [0, 0], f"K1 differs from its twin at bins/"
                      f"precision/retries {case}: words read, keyed {bad}")
    emit(out)


def _k3_setup(torch, name: str, sampler: str):
    """pigs or hailfinder on the card, its fused rounds, 1,024 chains'
    initial values, the draw's parameters and a sweep key."""
    from repro_torch import prng
    from repro_torch.core import bayesnet as bnet
    from repro_torch.core.graphs import bn_repository_replica
    from repro_torch.kernels import bn_gibbs

    dev = torch.device(DEVICE)
    cbn = bnet.compile_bayesnet(bn_repository_replica(name), device=dev)
    fr = bn_gibbs.build_fused_rounds(cbn.groups)
    vals, _ = bnet.init_chain_values(cbn, prng.key(1), CHAINS)
    p = bn_gibbs.sweep_params(cbn, sampler)
    return cbn, fr, vals, p, prng.key(2)


def _k3_twin(cbn, fr, vals, key, sampler, p):
    """K3's plain version as a function of the key: the key's words in
    plain torch, then the twin."""
    from repro_torch.kernels import bn_gibbs

    words = bn_gibbs.fused_round_words(fr, key, vals.shape[0], p.n_words,
                                       vals.device)
    return bn_gibbs.bn_sweep_ref(cbn, fr, vals, words, sampler, p)


def _marginals(torch, cbn, fr, vals, sampler, sweep):
    """Marginals over ITERS sweeps (burn-in BURN_IN) with `sweep` as the
    sweep function (K3 or its twin), from the same keys."""
    from repro_torch import prng
    from repro_torch.kernels import bn_gibbs

    p = bn_gibbs.sweep_params(cbn, sampler)
    key = prng.key(3)
    v_range = torch.arange(cbn.max_card, device=vals.device)
    hist = torch.zeros(cbn.n_nodes, cbn.max_card, device=vals.device)
    for t in range(ITERS):
        key, sub = prng.split(key)
        vals = sweep(cbn, fr, vals, sub, sampler, p)
        if t >= BURN_IN:
            hist += (vals[..., None] == v_range).sum(0)
    return hist / hist.sum(-1, keepdim=True)


def phase_k3(torch) -> dict:
    from repro_torch import prng
    from repro_torch.kernels import bn_gibbs

    errs = {}
    for name in ("pigs", "hailfinder"):
        cbn, fr, vals, p, key = _k3_setup(torch, name, "lut_ky")
        bad, err = 0, 0
        for k in (key, prng.key(12), prng.key(2**32 - 1)):
            out_k = bn_gibbs.bn_sweep(cbn, fr, vals, k, "lut_ky", p)
            with WalkBits() as walks:
                out_t = _k3_twin(cbn, fr, vals, k, "lut_ky", p)
            torch.cuda.synchronize()
            bad += int((out_k != out_t).sum())
            err = max(err, int((out_k - out_t).abs().max()))
        changed = float((out_k != vals).float().mean())
        lut_words = p.n_words
        errs[name] = err
        check(bad == 0, f"K3 lut_ky differs from its twin on {name} ({bad})")

        cbn, fr, vals, p, key = _k3_setup(torch, name, "exact_ky")
        ex_k = bn_gibbs.bn_sweep(cbn, fr, vals, key, "exact_ky", p)
        ex_t = _k3_twin(cbn, fr, vals, key, "exact_ky", p)
        share = float((ex_k != ex_t).float().mean())
        m_k = _marginals(torch, cbn, fr, vals, "exact_ky", bn_gibbs.bn_sweep)
        m_t = _marginals(torch, cbn, fr, vals, "exact_ky", _k3_twin)
        tv = float((0.5 * (m_k - m_t).abs().sum(-1)).max())
        rows = CHAINS * sum(fr.n_c)
        emit({"phase": "k3", "model": name, "chains": CHAINS,
              "nodes": cbn.n_nodes, "rounds": len(fr.n_c),
              "c_max": fr.c_max, "f_max": fr.f_max, "s_max": fr.s_max,
              "keys": 3, "lut_ky_mismatches": bad,
              "lut_ky_changed_share": changed,
              "rows": rows, "threefry_calls": walks.threefry_calls,
              "threefry_calls_per_row": walks.threefry_calls / rows,
              "lut_ky_words_per_row_before": lut_words,
              "exact_ky_differing_label_share": share,
              "exact_ky_max_node_tv_200_sweeps": tv})
        check(tv <= 0.02, f"K3 exact_ky marginals off by TV {tv} on {name}")
    return errs


def _mrf_model(torch, name: str):
    """(GridMRF, clean (H, W) numpy, noisy evidence (H, W) on the card)."""
    from repro_torch.core import mrf as mrf_mod
    from repro_torch.core.graphs import GridMRF

    h, w, v, cost = MRF_MODELS[name]
    clean, noisy = mrf_mod.make_denoising_problem(h, w, v, 0.25, seed=1)
    mrf = GridMRF(h, w, v, theta=1.2, h=2.0, data_cost=cost)
    return mrf, clean, torch.as_tensor(noisy, device=DEVICE)


def phase_k4(torch) -> dict:
    from repro_torch import prng
    from repro_torch.kernels import mrf_gibbs

    dev = torch.device(DEVICE)
    tab, spec = exp_lut(dev)
    errs = {}
    for name in MRF_MODELS:
        mrf, _, ev = _mrf_model(torch, name)
        labels = prng.randint(prng.key(1), (CHAINS, mrf.height, mrf.width),
                              0, mrf.n_labels, dev)
        p = mrf_gibbs.half_step_params(mrf)
        out = {"phase": "k4", "model": name, "chains": CHAINS,
               "grid": [mrf.height, mrf.width], "labels": mrf.n_labels,
               "data_cost": mrf.data_cost,
               "tile_rows": mrf_gibbs.tile_rows(mrf.width, spec.size),
               "mismatches": {}, "changed_share": {}}
        err = 0
        for parity in (0, 1):
            key = prng.key(2 + parity)
            got = mrf_gibbs.mrf_half_step(mrf, labels, ev, key, parity, tab,
                                          spec, p)
            words = mrf_gibbs.round_words(mrf, key, CHAINS, p, dev)
            want = mrf_gibbs.mrf_half_step_ref(mrf, labels, ev, words,
                                               parity, tab, spec, p)
            torch.cuda.synchronize()
            bad = int((got != want).sum())
            err = max(err, int((got - want).abs().max()))
            out["mismatches"][str(parity)] = bad
            out["changed_share"][str(parity)] = float(
                (got != labels).float().mean())
            check(bad == 0, f"K4 differs from its twin on {name}, parity "
                  f"{parity} ({bad} labels)")
        errs[name] = err
        emit(out)
    return errs


def _queries(model_name: str, n: int, seed: int, cards):
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for q in range(n):
        k = int(rng.integers(5, 21))
        nodes = rng.choice(len(cards), size=k, replace=False)
        ev = {int(v): int(rng.integers(0, cards[v])) for v in nodes}
        out.append((model_name, ev, int(rng.integers(0, 2**31 - 1))))
    return out


def phase_serve(torch) -> dict:
    import numpy as np

    from repro_torch import prng
    from repro_torch.compile import ir
    from repro_torch.compile.program import compile_graph
    from repro_torch.core import bayesnet as bnet
    from repro_torch.core import draws
    from repro_torch.core.exact import ve_marginal
    from repro_torch.core.graphs import bn_repository_replica
    from repro_torch.kernels import bn_gibbs, ops

    dev = torch.device(DEVICE)
    nets = {m: bn_repository_replica(m) for m in ("pigs", "hailfinder")}
    progs = {m: compile_graph(ir.canonicalize(bn, evidence_mode="runtime"),
                              device=dev) for m, bn in nets.items()}
    # the plain-torch generator's calls for one chain init (randint), the
    # only words a fused query may make outside K3
    c0 = prng._raw_bits.calls
    bnet.init_chain_values(progs["pigs"].cbn, prng.key(0), CHAINS)
    init_calls = prng._raw_bits.calls - c0
    queries = (_queries("pigs", 4, 11, nets["pigs"].cards)
               + _queries("hailfinder", 1, 12, nets["hailfinder"].cards))
    run_kw = dict(n_chains=CHAINS, n_iters=ITERS, burn_in=BURN_IN,
                  sampler="lut_ky", fused=True, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    draw_logp = torch.log(torch.rand((1 << 16, 32), generator=g, device=dev)
                          * 200.0 + 1.0)
    tab, spec = exp_lut(dev)

    # ---- the main path: counters zeroed, requests served, counters read --
    zero_launches()
    served, sweeps, checks, raw_calls = [], 0, 0, []
    checked_programs = set()
    for i, (model, ev, seed) in enumerate(queries):
        prog = progs[model]
        before = bn_gibbs.bn_sweep.launches
        first = model not in checked_programs
        # warm-up run (its first use also runs the fused cross-check)
        prog.run(prng.key(seed), evidence=ev, **run_kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        c0 = prng._raw_bits.calls
        start.record()
        marg, vals = prog.run(prng.key(seed), evidence=ev, **run_kw)
        end.record()
        end.synchronize()
        raw_calls.append(prng._raw_bits.calls - c0)
        ms = start.elapsed_time(end)
        sweeps += 2 * ITERS
        if first:
            checks += 3  # cross_check_fused: 3 sweeps of 2 chains
            checked_programs.add(model)
        served.append((model, ev, seed, marg, vals))
        emit({"phase": "serve", "query": i, "model": model,
              "n_evidence": len(ev), "seed": seed, "wall_ms": ms,
              "sweeps_per_s": ITERS / (ms / 1e3),
              "k3_launches": bn_gibbs.bn_sweep.launches - before,
              "plain_torch_generator_calls": raw_calls[-1]})
    weights = ops.lut_exp_weights(draw_logp, tab, spec)
    c0 = prng._raw_bits.calls
    labels = ops.ky_sample(weights, prng.key(9))
    draw_calls = prng._raw_bits.calls - c0
    torch.cuda.synchronize()
    launches = read_launches()
    # ---- end of the main path ----------------------------------------------

    check(launches["mrf_half_step"] == 0, f"BN path launched K4: {launches}")
    check(launches["bn_sweep"] == sweeps + checks,
          f"K3 launched {launches['bn_sweep']} times, expected "
          f"{sweeps} sweeps + {checks} cross-check sweeps")
    check(launches["ky_sample_kernel"] == 1 and launches["interp_kernel"] == 1,
          f"draw request launches {launches}")
    check(draw_calls == 0, f"the draw request called prng._raw_bits "
          f"{draw_calls} times: its words were made outside K1")
    check(all(c == init_calls for c in raw_calls),
          f"a fused query called prng._raw_bits {raw_calls} times, its chain "
          f"init {init_calls}: words were made outside K3")

    # ---- is what came out right? ------------------------------------------
    for i, (model, ev, seed, marg, vals) in enumerate(served):
        n, v = nets[model].n_nodes, int(np.max(nets[model].cards))
        check(tuple(marg.shape) == (n, v) and tuple(vals.shape) == (CHAINS, n),
              f"query {i}: shapes {tuple(marg.shape)} {tuple(vals.shape)}")
        check(bool(torch.isfinite(marg).all()), f"query {i}: non-finite")
        check(bool(torch.allclose(marg.sum(-1), torch.ones(n, device=dev))),
              f"query {i}: marginals do not sum to 1")
        for node, val in ev.items():
            check(float(marg[node, val]) == 1.0 and bool(
                (vals[:, node] == val).all()), f"query {i}: evidence moved")
        m_u, v_u = progs[model].run(prng.key(seed), evidence=ev,
                                    **{**run_kw, "fused": False})
        check(torch.equal(marg, m_u) and torch.equal(vals, v_u),
              f"query {i}: fused and unfused runs differ")
    model, ev, seed, marg, vals = served[0]
    half = {**run_kw, "n_iters": ITERS // 2}
    _, _, st = progs[model].run(prng.key(seed), evidence=ev,
                                return_state=True, **half)
    c0 = prng._raw_bits.calls
    m_s, v_s = progs[model].run(None, evidence=ev, carry_state=st, **half)
    resumed_calls = prng._raw_bits.calls - c0
    check(torch.equal(m_s, marg) and torch.equal(v_s, vals),
          "a run sliced 100 + 100 differs from the whole run")
    check(resumed_calls == 0, f"100 resumed fused sweeps called "
          f"prng._raw_bits {resumed_calls} times")
    ref_labels = draws.draw_from_logits(draw_logp, prng.key(9), "lut_ky",
                                        tab, spec)
    check(torch.equal(labels, ref_labels),
          "draw request differs from the plain draw_from_logits")

    asia = bn_repository_replica("asia")
    ev = {0: 1, 5: 0}
    asia_prog = compile_graph(ir.canonicalize(asia, evidence_mode="runtime"),
                              device=dev)
    tvs = {}
    for sampler in ("lut_ky", "exact_ky"):
        marg, _ = asia_prog.run(prng.key(4), evidence=ev, n_chains=CHAINS,
                                n_iters=500, burn_in=100, sampler=sampler,
                                fused=True, device=dev)
        tvs[sampler] = max(
            0.5 * float(np.abs(ve_marginal(asia, q, ev)
                               - marg[q, :asia.cards[q]].cpu().numpy()).sum())
            for q in range(asia.n_nodes) if q not in ev
        )
    sweep_profile(torch, progs[served[0][0]], served[0][1], served[0][2],
                  run_kw)
    emit({"phase": "serve_checks", "fused_equals_unfused": True,
          "sliced_equals_whole": True, "draw_request_equals_plain": True,
          "plain_torch_generator_calls_per_query": raw_calls,
          "of_which_chain_init": init_calls,
          "plain_torch_generator_calls_resumed_100_sweeps": resumed_calls,
          "plain_torch_generator_calls_draw_request": draw_calls,
          "asia_max_node_tv_vs_exact": tvs, "launches": launches})
    check(max(tvs.values()) <= 0.05, f"asia marginals off exact VE: {tvs}")
    return launches


def phase_serve_mrf(torch):
    """The MRF main path: one denoising query per model, fused through K4."""
    import numpy as np

    from repro_torch import prng
    from repro_torch.compile import ir
    from repro_torch.compile.program import compile_graph
    from repro_torch.core import mrf as mrf_mod

    dev = torch.device(DEVICE)
    models = {name: _mrf_model(torch, name) for name in MRF_MODELS}
    progs = {name: compile_graph(ir.canonicalize(mrf, evidence_mode="runtime"),
                                 device=dev)
             for name, (mrf, _, _) in models.items()}
    run_kw = dict(n_chains=CHAINS, n_iters=ITERS, sampler="lut_ky",
                  backend="schedule", fused=True, device=dev)
    # the plain-torch generator's calls for one chain init (randint), the
    # only words a fused query may make outside K4
    c0 = prng._raw_bits.calls
    mrf_mod.init_labels(models["penguin"][0], prng.key(0), CHAINS, None,
                        None, dev)
    init_calls = prng._raw_bits.calls - c0

    # ---- the main path: counters zeroed, queries served, counters read ----
    zero_launches()
    served, raw_calls = {}, {}
    for i, (name, (mrf, clean, ev)) in enumerate(models.items()):
        seed = 100 + i
        before = read_launches()["mrf_half_step"]
        # warm-up query (its first use also runs the fused cross-check)
        progs[name].run(prng.key(seed), evidence=ev, **run_kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        c0 = prng._raw_bits.calls
        start.record()
        labels = progs[name].run(prng.key(seed), evidence=ev, **run_kw)
        end.record()
        end.synchronize()
        raw_calls[name] = prng._raw_bits.calls - c0
        ms = start.elapsed_time(end)
        served[name] = (seed, labels)
        emit({"phase": "serve_mrf", "model": name,
              "grid": [mrf.height, mrf.width], "labels": mrf.n_labels,
              "data_cost": mrf.data_cost, "chains": CHAINS, "iters": ITERS,
              "seed": seed, "wall_ms": ms,
              "iters_per_s": ITERS / (ms / 1e3),
              "site_updates_per_s": CHAINS * mrf.height * mrf.width * ITERS
              / (ms / 1e3),
              "k4_launches": read_launches()["mrf_half_step"] - before,
              "plain_torch_generator_calls": raw_calls[name]})
    launches = read_launches()
    # ---- end of the main path ----------------------------------------------

    check(all(c == init_calls for c in raw_calls.values()),
          f"a fused MRF query called prng._raw_bits {raw_calls} times, its "
          f"chain init {init_calls}: words were made outside K4")
    want = len(models) * (2 * 2 * ITERS + 2 * 3)
    check(launches["mrf_half_step"] == want,
          f"K4 launched {launches['mrf_half_step']} times, expected {want} "
          "(2 per iteration per query, plus 2 x 3 cross-check rounds per "
          "program)")
    check(launches["bn_sweep"] == 0 and launches["ky_sample_kernel"] == 0
          and launches["interp_kernel"] == 0,
          f"MRF path launched other kernels: {launches}")

    # ---- is what came out right? ------------------------------------------
    checks, resumed_calls = {}, {}
    chk = {**run_kw, "n_iters": MRF_CHECK_ITERS}
    for name, (mrf, clean, ev) in models.items():
        seed, labels = served[name]
        prog = progs[name]
        check(tuple(labels.shape) == (CHAINS, mrf.height, mrf.width)
              and labels.dtype == torch.int32, f"{name}: labels shaped "
              f"{tuple(labels.shape)} {labels.dtype}")
        check(bool(((labels >= 0) & (labels < mrf.n_labels)).all()),
              f"{name}: labels out of range")
        fused = prog.run(prng.key(seed), evidence=ev, **chk)
        unfused = prog.run(prng.key(seed), evidence=ev,
                           **{**chk, "fused": False})
        check(torch.equal(fused, unfused), f"{name}: fused and unfused "
              "runs differ")
        half = {**chk, "n_iters": MRF_CHECK_ITERS // 2}
        _, st = prog.run(prng.key(seed), evidence=ev, return_state=True,
                         **half)
        c0 = prng._raw_bits.calls
        sliced = prog.run(None, evidence=ev, carry_state=st, **half)
        resumed_calls[name] = prng._raw_bits.calls - c0
        check(resumed_calls[name] == 0, f"{name}: resumed fused iterations "
              f"called prng._raw_bits {resumed_calls[name]} times")
        check(torch.equal(sliced, fused), f"{name}: a run sliced 10 + 10 "
              "differs from the whole run")
        rng = np.random.default_rng(seed)
        sites = rng.choice(mrf.height * mrf.width, MRF_PINS, replace=False)
        pins = {int(s_): int(clean.flat[s_]) for s_ in sites}
        pinned = prog.run(prng.key(seed), evidence=ev, pins=pins, **chk)
        rows, cols = np.unravel_index(sites, (mrf.height, mrf.width))
        held = pinned.cpu()[:, torch.as_tensor(rows), torch.as_tensor(cols)]
        check(bool((held == torch.as_tensor(clean[rows, cols])).all()),
              f"{name}: pinned pixels moved")
        noisy_err = float((ev.cpu().numpy() != clean).mean())
        chain0_err = float((labels[0].cpu().numpy() != clean).mean())
        checks[name] = {"noisy_error": noisy_err,
                        "chain0_error": chain0_err}
        if mrf.data_cost == "potts":
            check(chain0_err < noisy_err, f"{name}: chain 0 error "
                  f"{chain0_err} not below the noisy image's {noisy_err}")
    emit({"phase": "serve_mrf_checks", "fused_equals_unfused": True,
          "sliced_equals_whole": True, "pins_held": True,
          "plain_torch_generator_calls_per_query": raw_calls,
          "of_which_chain_init": init_calls,
          "plain_torch_generator_calls_resumed": resumed_calls,
          "denoising": checks, "launches": launches})
    return launches, {name: (models[name], progs[name], *served[name])
                      for name in models}


def phase_diag(torch, served: dict):
    """diagnostics=True on both program kinds, held against exact variable
    elimination (asia) and against the served MRF query."""
    import numpy as np

    from repro_torch import prng
    from repro_torch.compile import ir
    from repro_torch.compile.program import compile_graph
    from repro_torch.core.exact import ve_marginal
    from repro_torch.core.graphs import bn_repository_replica

    dev = torch.device(DEVICE)
    asia = bn_repository_replica("asia")
    ev = {0: 1, 5: 0}
    prog = compile_graph(ir.canonicalize(asia, evidence_mode="runtime"),
                         device=dev)
    out = {"phase": "diag", "asia_max_node_tv_vs_exact": {},
           "asia_rhat_max": {}, "asia_ess_min": {}}
    for sampler in ("lut_ky", "exact_ky", "cdf", "gumbel"):
        marg, _, snap = prog.run(
            prng.key(4), evidence=ev, n_chains=CHAINS, n_iters=500,
            burn_in=100, sampler=sampler, diagnostics=True,
            fused=sampler in ("lut_ky", "exact_ky"), device=dev)
        tv = max(
            0.5 * float(np.abs(ve_marginal(asia, q, ev)
                               - snap.p_hat[q, :asia.cards[q]]).sum())
            for q in range(asia.n_nodes) if q not in ev)
        out["asia_max_node_tv_vs_exact"][sampler] = tv
        out["asia_rhat_max"][sampler] = snap.rhat_max
        out["asia_ess_min"][sampler] = snap.ess_min
        check(snap.finite and snap.kept == 400, f"asia {sampler}: snapshot "
              f"kept {snap.kept}, finite {snap.finite}")
        check(np.allclose(snap.p_hat, marg.cpu().numpy(), atol=1e-5),
              f"asia {sampler}: snapshot p_hat and marginals disagree")
        check(tv <= 0.05, f"asia {sampler}: p_hat off exact VE by TV {tv}")

    ((mrf, clean, noisy), mprog, seed, labels) = served["penguin"]
    run_kw = dict(n_chains=CHAINS, n_iters=ITERS, sampler="lut_ky",
                  fused=True, device=dev)
    t0 = time.perf_counter()
    lab, snap = mprog.run(prng.key(seed), evidence=noisy, diagnostics=True,
                          **run_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(torch.equal(lab, labels), "penguin: labels with diagnostics differ "
          "from the served query's")
    mpm = snap.p_hat.argmax(-1).reshape(mrf.height, mrf.width)
    mpm_err = float((mpm != clean).mean())
    noisy_err = float((noisy.cpu().numpy() != clean).mean())
    check(snap.finite and snap.kept == ITERS
          and snap.p_hat.shape == (mrf.height * mrf.width, mrf.n_labels),
          f"penguin snapshot: kept {snap.kept}, finite {snap.finite}")
    check(mpm_err < noisy_err, f"penguin: snapshot argmax error {mpm_err} "
          f"not below the noisy image's {noisy_err}")
    out.update({"penguin_wall_s_with_diagnostics": wall,
                "penguin_rhat_max": snap.rhat_max,
                "penguin_ess_min": snap.ess_min,
                "penguin_snapshot_argmax_error": mpm_err,
                "penguin_noisy_error": noisy_err})
    emit(out)


MESH = (2, 4)  # (chain positions, node / row positions)


def _sharded_bn(torch, name: str):
    """A compiled program of `name` on the card, its (2, 4) ownership table
    over the schedule's rounds, and 1,024 chains' initial values."""
    from repro_torch import prng
    from repro_torch.compile.program import compile_graph
    from repro_torch.core import bayesnet as bnet
    from repro_torch.core import distributed
    from repro_torch.core.graphs import bn_repository_replica

    dev = torch.device(DEVICE)
    prog = compile_graph(bn_repository_replica(name), device=dev)
    groups = prog.schedule_executable().round_groups
    sfr = distributed.build_sharded_fused_rounds(prog.cbn, groups, MESH[1],
                                                 prog.placement)
    vals, _ = bnet.init_chain_values(prog.cbn, prng.key(1), CHAINS)
    return prog.cbn, sfr, vals


def _k5_twin_round(torch, cbn, sfr, r, vals, key, sampler, p):
    """K5's plain version as a function of the key: round r's stream in
    plain torch, then the twin per (node position, chain block), stacked
    as K5 stacks its planes."""
    from repro_torch.kernels import bn_gibbs

    words = bn_gibbs.round_stream(sfr, key, r, 0, vals.shape[0], p.n_words,
                                  vals.device)
    b_loc = vals.shape[0] // MESH[0]
    return torch.stack([torch.cat([
        bn_gibbs.fused_color_round_ref(cbn, sfr, d, r, vals[c0:c0 + b_loc],
                                       words, c0, sampler, p)
        for c0 in range(0, vals.shape[0], b_loc)])
        for d in range(MESH[1])])


def phase_k5(torch) -> dict:
    """Every round of one sweep on the (2, 4) mesh: one K5 launch over all
    positions against the twin per position on the round's full stream,
    both from the same pre-round values (the run goes on from K5's merged
    values); and one launch of the one-position entry."""
    from repro_torch import prng
    from repro_torch.core import distributed
    from repro_torch.kernels import bn_gibbs

    errs = {}
    for name in ("pigs", "hailfinder"):
        cbn, sfr, vals0 = _sharded_bn(torch, name)
        out = {"phase": "k5", "model": name, "chains": CHAINS,
               "mesh": list(MESH), "rounds": len(sfr.n_c),
               "c_max": sfr.c_max, "owned_per_round_position":
               [list(row) for row in sfr.n_own]}
        key = prng.key(2)
        for sampler in ("lut_ky", "exact_ky"):
            p = bn_gibbs.sweep_params(cbn, sampler)
            vals, bad, err, differ = vals0, 0, 0, []
            for r in range(len(sfr.n_c)):
                got = bn_gibbs.fused_color_round_mesh(cbn, sfr, r, vals, key,
                                                      sampler, p, MESH[0])
                want = _k5_twin_round(torch, cbn, sfr, r, vals, key, sampler,
                                      p)
                torch.cuda.synchronize()
                bad += int((got != want).sum())
                err = max(err, int((got - want).abs().max()))
                differ.append(float((got != want).float().mean()))
                vals = distributed._psum_merge(vals, got)
            if sampler == "lut_ky":
                out["lut_ky_mismatches"] = bad
                out["lut_ky_changed_share"] = float(
                    (vals != vals0).float().mean())
                errs[name] = err
                check(bad == 0, f"K5 lut_ky differs from its twin on {name} "
                      f"({bad})")
                # the one-position entry: node position 3, chain block 1
                b_loc = CHAINS // MESH[0]
                one = bn_gibbs.fused_color_round(
                    cbn, sfr, MESH[1] - 1, 1, vals[b_loc:], key, b_loc,
                    sampler, p)
                twin = bn_gibbs.fused_color_round_ref(
                    cbn, sfr, MESH[1] - 1, 1, vals[b_loc:],
                    bn_gibbs.round_stream(sfr, key, 1, 0, CHAINS, p.n_words,
                                          vals.device), b_loc, sampler, p)
                one_bad = int((one != twin).sum())
                out["one_position_mismatches"] = one_bad
                check(one_bad == 0, f"K5's one-position entry differs from "
                      f"its twin on {name} ({one_bad})")
            else:
                out["exact_ky_differing_label_share_per_round"] = differ
        out["launches_per_sweep"] = len(sfr.n_c)
        emit(out)
    return errs


def phase_k6(torch) -> dict:
    """One K6 launch over every row slab of the (2, 4) mesh (4-way row
    split) against the twin per slab on the half-step's full words, with
    random halo rows holding -1, both parities; and one block of chains
    [512, 1024) and rows [h_loc + 1, 2 h_loc + 1) (an odd global row)."""
    from repro_torch import prng
    from repro_torch.kernels import mrf_gibbs

    dev = torch.device(DEVICE)
    tab, spec = exp_lut(dev)
    errs = {}
    n_g = MESH[1]
    for name in MRF_MODELS:
        mrf, _, ev = _mrf_model(torch, name)
        h_loc = mrf.height // n_g
        labels = prng.randint(prng.key(1), (CHAINS, mrf.height, mrf.width),
                              0, mrf.n_labels, dev)
        # random halo rows, -1 (beyond the grid) among the labels
        up = prng.randint(prng.key(5), (n_g, CHAINS, mrf.width), -1,
                          mrf.n_labels, dev)
        down = prng.randint(prng.key(6), (n_g, CHAINS, mrf.width), -1,
                            mrf.n_labels, dev)
        p = mrf_gibbs.half_step_params(mrf)
        out = {"phase": "k6", "model": name, "chains": CHAINS,
               "mesh": list(MESH), "slab_rows": h_loc,
               "grid": [mrf.height, mrf.width], "labels": mrf.n_labels,
               "data_cost": mrf.data_cost, "mismatches": {},
               "odd_row_block_mismatches": {}}
        err = 0
        half = CHAINS // 2
        odd = slice(h_loc + 1, 2 * h_loc + 1)
        for parity in (0, 1):
            key = prng.key(2 + parity)
            got = mrf_gibbs.mrf_halo_half_step(mrf, labels, up, down, 0, ev,
                                               key, parity, tab, spec, p)
            words = mrf_gibbs.round_words(mrf, key, CHAINS, p, dev)
            want = torch.cat([
                mrf_gibbs.mrf_halo_half_step_ref(
                    mrf, labels[:, g * h_loc:(g + 1) * h_loc], up[g], down[g],
                    g * h_loc, ev[g * h_loc:(g + 1) * h_loc],
                    words[:, g * h_loc:(g + 1) * h_loc], parity, tab, spec, p)
                for g in range(n_g)], dim=1)
            got_odd = mrf_gibbs.mrf_halo_half_step(
                mrf, labels[half:, odd], up[:1, half:], down[:1, half:],
                odd.start, ev[odd], key, parity, tab, spec, p, chain0=half)
            want_odd = mrf_gibbs.mrf_halo_half_step_ref(
                mrf, labels[half:, odd], up[0, half:], down[0, half:],
                odd.start, ev[odd], words[half:, odd], parity, tab, spec, p)
            torch.cuda.synchronize()
            bad = int((got != want).sum())
            bad_odd = int((got_odd != want_odd).sum())
            err = max(err, int((got - want).abs().max()),
                      int((got_odd - want_odd).abs().max()))
            out["mismatches"][str(parity)] = bad
            out["odd_row_block_mismatches"][str(parity)] = bad_odd
            check(bad == 0 and bad_odd == 0, f"K6 differs from its twin on "
                  f"{name}, parity {parity} ({bad}, {bad_odd} labels)")
        errs[name] = err
        emit(out)
    return errs


def phase_serve_sharded(torch, served_mrf: dict) -> dict:
    """The sharded main path: BN and MRF queries through run_sharded on a
    (2, 4) mesh of one card, counters zeroed before and read after."""
    import numpy as np

    from repro_torch import prng
    from repro_torch.compile.program import compile_graph
    from repro_torch.core import bayesnet as bnet
    from repro_torch.core import distributed
    from repro_torch.core import mrf as mrf_mod
    from repro_torch.core.exact import ve_marginal
    from repro_torch.core.graphs import bn_repository_replica

    dev = torch.device(DEVICE)
    mesh = distributed.make_mesh(MESH, ("data", "model"), DEVICE)
    nets = {m: bn_repository_replica(m) for m in ("pigs", "hailfinder")}
    queries = (_queries("pigs", 4, 11, nets["pigs"].cards)
               + _queries("hailfinder", 1, 12, nets["hailfinder"].cards))
    # runtime evidence is a single-device path: each query bakes its own
    progs = [compile_graph(nets[m], ev, device=dev) for m, ev, _ in queries]
    rounds = [len(p.schedule_executable().round_groups) for p in progs]
    bn_kw = dict(n_chains=CHAINS, n_iters=ITERS, burn_in=BURN_IN,
                 sampler="lut_ky", fused=True)
    mrf_kw = dict(n_chains=CHAINS, n_iters=ITERS, sampler="lut_ky",
                  fused=True)
    # the plain-torch generator's calls for one chain init of each kind,
    # the only words a fused sharded query may make outside K5 and K6
    c0 = prng._raw_bits.calls
    bnet.init_chain_values(progs[0].cbn, prng.key(0), CHAINS)
    bn_init = prng._raw_bits.calls - c0
    c0 = prng._raw_bits.calls
    mrf_mod.init_labels(served_mrf["penguin"][0][0], prng.key(0), CHAINS,
                        None, None, dev)
    mrf_init = prng._raw_bits.calls - c0

    def wall(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        c0 = prng._raw_bits.calls
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end), prng._raw_bits.calls - c0

    # ---- the main path: counters zeroed, queries served, counters read ----
    zero_launches()
    bn_out, mrf_out = [], {}
    for prog, (model, ev, seed) in zip(progs, queries):
        prog.ensure_fused_cross_check("lut_ky", sharded=True)
        bn_out.append(wall(lambda: prog.run_sharded(prng.key(seed), mesh,
                                                    **bn_kw)))
    for name, ((mrf, clean, ev), prog, seed, _) in served_mrf.items():
        prog.ensure_fused_cross_check("lut_ky", sharded=True)
        mrf_out[name] = wall(lambda: prog.run_sharded(
            prng.key(seed), mesh, evidence=ev, **mrf_kw))
    launches = read_launches()
    # ---- end of the main path ----------------------------------------------

    # one K5 launch per round and one K6 launch per half-step over every
    # position; the cross-checks: eager + 3 single-device fused sweeps (K3)
    # or half-step pairs (K4) + the same on a (1, 2) mesh (K5/K6)
    want_k5 = sum(ITERS * r + 3 * r for r in rounds)
    want_k6 = len(served_mrf) * (2 * ITERS + 2 * 3)
    want = {"fused_color_round": want_k5, "mrf_halo_half_step": want_k6,
            "bn_sweep": 3 * len(progs),
            "mrf_half_step": 2 * 3 * len(served_mrf),
            "ky_sample_kernel": 0, "interp_kernel": 0,
            "bn_sweep_lanes": 0, "mrf_half_step_lanes": 0}
    check(launches == want, f"sharded path launches {launches}, expected "
          f"{want}")
    raw_calls = [c for _, _, c in bn_out] + [c for _, _, c in
                                             mrf_out.values()]
    check(raw_calls == [bn_init] * len(bn_out) + [mrf_init] * len(mrf_out),
          f"a fused sharded query called prng._raw_bits {raw_calls} times, "
          f"its chain init {bn_init} (BN) or {mrf_init} (MRF): words were "
          "made outside K5/K6")

    # ---- is what came out right? ------------------------------------------
    for i, (prog, (model, ev, seed), ((marg, vals), ms, _)) in enumerate(
            zip(progs, queries, bn_out)):
        (m1, v1), ms1, _ = wall(lambda: prog.run(prng.key(seed), device=dev,
                                                 **bn_kw))
        n = nets[model].n_nodes
        check(tuple(vals.shape) == (CHAINS, n) and bool(
            torch.isfinite(marg).all()), f"sharded query {i}: shapes/values")
        check(torch.equal(marg, m1) and torch.equal(vals, v1),
              f"sharded query {i} differs from run(fused=True)")
        for node, val in ev.items():
            check(float(marg[node, val]) == 1.0, f"query {i}: evidence moved")
        emit({"phase": "serve_sharded", "query": i, "model": model,
              "mesh": list(MESH), "n_evidence": len(ev), "seed": seed,
              "rounds": rounds[i], "wall_ms_sharded": ms,
              "wall_ms_single_device": ms1,
              "sweeps_per_s_sharded": ITERS / (ms / 1e3),
              "plain_torch_generator_calls": raw_calls[i],
              "equals_single_device": True})
    for name, ((mrf, clean, ev), prog, seed, labels) in served_mrf.items():
        got, ms, calls = mrf_out[name]
        check(torch.equal(got, labels), f"{name}: run_sharded differs from "
              "the served run(fused=True)")
        emit({"phase": "serve_sharded", "model": name, "mesh": list(MESH),
              "grid": [mrf.height, mrf.width], "slab_rows":
              mrf.height // MESH[1], "wall_ms_sharded": ms,
              "iters_per_s_sharded": ITERS / (ms / 1e3),
              "chain0_error": float((got[0].cpu().numpy() != clean).mean()),
              "plain_torch_generator_calls": calls,
              "equals_single_device": True})

    sharded_profile(torch, progs[0], queries[0][2], mesh, bn_kw)
    # a pigs query: 100 sweeps sharded, then 100 single-device, and then
    # 100 sharded resumed from the same carry (no word in plain torch)
    prog, (_, ev, seed), ((marg, vals), _, _) = progs[0], queries[0], \
        bn_out[0]
    half = {**bn_kw, "n_iters": ITERS // 2}
    _, _, st = prog.run_sharded(prng.key(seed), mesh, return_state=True,
                                **half)
    m_s, v_s = prog.run(None, carry_state=st, device=dev, **half)
    check(torch.equal(m_s, marg) and torch.equal(v_s, vals),
          "a pigs query sliced 100 sharded + 100 single-device differs")
    (m_r, v_r), _, bn_resumed = wall(lambda: prog.run_sharded(
        None, mesh, carry_state=st, **half))
    check(torch.equal(m_r, marg) and torch.equal(v_r, vals),
          "a pigs query sliced 100 + 100 sharded differs")
    # Penguin: 100 iterations sharded, then 100 resumed
    ((mrf, clean, ev), mprog, seed, labels) = served_mrf["penguin"]
    mhalf = {**mrf_kw, "n_iters": ITERS // 2}
    _, mst = mprog.run_sharded(prng.key(seed), mesh, evidence=ev,
                               return_state=True, **mhalf)
    lab_r, _, mrf_resumed = wall(lambda: mprog.run_sharded(
        None, mesh, evidence=ev, carry_state=mst, **mhalf))
    check(torch.equal(lab_r, labels),
          "a Penguin query sliced 100 + 100 sharded differs")
    check(bn_resumed == 0 and mrf_resumed == 0, f"resumed fused sharded "
          f"runs called prng._raw_bits {bn_resumed} (pigs) and "
          f"{mrf_resumed} (Penguin) times")

    # the legacy route (plain torch, keys folded per position) on asia
    asia = bn_repository_replica("asia")
    ev = {0: 1, 5: 0}
    asia_prog = compile_graph(asia, ev, device=dev)
    # 100 sweeps: each position draws its own words every round
    legacy, ms, _ = wall(lambda: asia_prog.run_sharded(
        prng.key(4), mesh, n_chains=CHAINS, n_iters=100, burn_in=20,
        fused=False))
    tv = max(0.5 * float(np.abs(
        ve_marginal(asia, q, ev)
        - legacy[0][q, :asia.cards[q]].cpu().numpy()).sum())
        for q in range(asia.n_nodes) if q not in ev)
    emit({"phase": "serve_sharded_checks", "sharded_equals_single_device":
          True, "sliced_across_routes_equals_whole": True,
          "plain_torch_generator_calls_per_query": raw_calls,
          "of_which_chain_init": {"bn": bn_init, "mrf": mrf_init},
          "plain_torch_generator_calls_resumed_100": {
              "pigs": bn_resumed, "penguin": mrf_resumed},
          "legacy_asia_max_node_tv_vs_exact": tv, "legacy_asia_wall_ms": ms,
          "launches": launches, "expected_launches": want})
    check(tv <= 0.05, f"legacy sharded asia marginals off exact VE: {tv}")
    return launches


PROFILE_SWEEPS = 50


def run_profile(torch, run) -> tuple[float, float, list]:
    """Wall ms of `run` unprofiled (CUDA events, after a warm-up) and the
    device ms of every kernel it launches (torch.profiler), over the same
    call, with the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    wall = time_ms(torch, run, 2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.device_time_total / 1e3)
                   for e in kernel_events(torch, prof)),
                  key=lambda r: -r[1])
    return wall, sum(ms for _, ms in rows), rows


def sharded_profile(torch, prog, seed, mesh, run_kw):
    """Wall and device time per sweep of one 50-sweep sharded run of a
    served pigs query, every sweep kept in the histogram as after the
    burn-in, with its kernels by device time."""
    from repro_torch import prng

    kw = {**run_kw, "n_iters": PROFILE_SWEEPS, "burn_in": 0}
    wall, total, rows = run_profile(
        torch, lambda: prog.run_sharded(prng.key(seed), mesh, **kw))
    k5 = sum(ms for name, ms in rows if BN_KERNEL in name)
    n = PROFILE_SWEEPS
    emit({"phase": "serve_sharded_profile", "per_sweep": True,
          "mesh": list(MESH), "sweeps": n, "wall_ms": wall / n,
          "device_ms": total / n, "k5_device_ms": k5 / n,
          "other_device_ms": (total - k5) / n,
          "device_busy_share": total / wall,
          "top_kernels_ms": [[name[:80], ms / n] for name, ms in rows[:6]]})


def sweep_profile(torch, prog, ev, seed, run_kw):
    """Wall and device time per sweep of one 50-sweep run of a served
    query, every sweep kept in the histogram as after the burn-in: how busy
    the card is and what keeps it busy."""
    from repro_torch import prng

    kw = {**run_kw, "n_iters": PROFILE_SWEEPS, "burn_in": 0}
    wall, total, rows = run_profile(
        torch, lambda: prog.run(prng.key(seed), evidence=ev, **kw))
    k3 = sum(ms for name, ms in rows if BN_KERNEL in name)
    n = PROFILE_SWEEPS
    emit({"phase": "serve_profile", "per_sweep": True, "sweeps": n,
          "wall_ms": wall / n, "device_ms": total / n,
          "k3_device_ms": k3 / n, "other_device_ms": (total - k3) / n,
          "device_busy_share": total / wall,
          "top_kernels_ms": [[name[:80], ms / n] for name, ms in rows[:6]]})


def host_ms(torch, fn, reps: int) -> float:
    """Host ms per call of `fn` issued back to back (time.perf_counter),
    not waiting for the card: the host's own cost, launches included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def per_sweep(torch, fn, reps: int = 3) -> tuple[float, float]:
    """Wall ms (CUDA events) and the host's ms to issue it (perf_counter,
    before waiting for the card) per sweep of `fn(n)`, both from the same
    runs: the slope between n = 50 and n = 250, so fixed costs drop out,
    over `reps` interleaved pairs of runs."""
    fn(50)
    torch.cuda.synchronize()
    wall, host = {50: 0.0, 250: 0.0}, {50: 0.0, 250: 0.0}
    for _ in range(reps):
        for n in (50, 250):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            fn(n)
            host[n] += (time.perf_counter() - t0) * 1e3
            end.record()
            end.synchronize()
            wall[n] += start.elapsed_time(end)
    return ((wall[250] - wall[50]) / 200 / reps,
            (host[250] - host[50]) / 200 / reps)


def sweep_parts(torch, cbn, fr, vals, key) -> dict:
    """One pigs sweep at 1,024 chains, alone and in the query loop, in one
    call, per sweep (`per_sweep`: wall and host issue time from the same
    runs).  `loop_*`: `bayesnet.gibbs_run_loop`, the loop a fused query
    runs, every sweep kept in the histogram, with the device time of every
    kernel (torch.profiler, same slope).  `presplit_*`: the same loop body
    (sweep, histogram) with the sweeps' keys split beforehand, and
    `insplit_*` with them split in the loop.  `sweep_*`:
    `fused_gibbs_sweep` back to back on one key, as tools/kernel_ab.py
    times it.  `host_*`: the host's time per call of each part of the
    body, issued back to back: the key split (numpy), the sweep's wrapper
    (parameters, checks, ctypes launch), the histogram update."""
    from repro_torch import prng
    from repro_torch.core import bayesnet as bnet
    from repro_torch.kernels import bn_gibbs

    sweep = lambda: bn_gibbs.fused_gibbs_sweep(cbn, fr, vals, key, "lut_ky")
    hist = torch.zeros((cbn.n_nodes, cbn.max_card), dtype=torch.int32,
                       device=vals.device)
    v_range = torch.arange(cbn.max_card, dtype=torch.int32,
                           device=vals.device)

    def hist_update(v, h):
        return h + (v[..., None] == v_range).sum(0, dtype=torch.int32)

    keys, k = [], key
    for _ in range(250):
        k, sub = prng.split(k)
        keys.append(sub)

    def body(n, split):
        v, h, k = vals, hist, key
        for sub in keys[:n]:
            if split:
                k, sub = prng.split(k)
            v = bn_gibbs.fused_gibbs_sweep(cbn, fr, v, sub, "lut_ky")
            h = hist_update(v, h)
        return v, h

    loop = lambda n: bnet.gibbs_run_loop(cbn, cbn.groups, vals, key, n, 0,
                                         "lut_ky", 1, fused=True)
    out = {}
    out["loop_ms"], out["loop_host_ms"] = per_sweep(torch, loop)
    out["loop_device_ms"] = (device_busy_ms(torch, lambda: loop(250), 1)
                             - device_busy_ms(torch, lambda: loop(50), 1)
                             ) / 200
    out["presplit_ms"], out["presplit_host_ms"] = per_sweep(
        torch, lambda n: body(n, False))
    out["insplit_ms"], out["insplit_host_ms"] = per_sweep(
        torch, lambda n: body(n, True))
    out["sweep_ms"] = time_ms(torch, sweep, 200)
    out["sweep_device_ms"] = device_busy_ms(torch, sweep, 200)
    out["host_split_ms"] = host_ms(torch, lambda: prng.split(key), 200)
    out["host_sweep_ms"] = host_ms(torch, sweep, 200)
    out["host_hist_ms"] = host_ms(torch, lambda: hist_update(vals, hist),
                                  200)
    out["host_parts_ms"] = (out["host_split_ms"] + out["host_sweep_ms"]
                            + out["host_hist_ms"])
    out["loop_busy_share"] = out["loop_device_ms"] / out["loop_ms"]
    out["sweep_busy_share"] = out["sweep_device_ms"] / out["sweep_ms"]
    return out


def phase_timing(torch, launches: dict, k3_err: dict, mrf_launches: dict,
                 k4_err: dict, sharded_launches: dict, k5_err: dict,
                 k6_err: dict, per_call: dict, k1_ptxas: list, runtime: dict,
                 lanes_err: dict, counts: dict):
    from repro_torch import prng
    from repro_torch.core import ky as ky_core
    from repro_torch.kernels import bn_gibbs, interp_lut, ky_sampler, ops
    from repro_torch.launch import kernel_cost

    dev = torch.device(DEVICE)
    rows = []

    # K3 at the pigs main-path shape (B = 1024, lut_ky); its input is the
    # sweep's key, so its plain version generates the key's words too
    c = counts["k3"]
    cbn, fr, vals, p, key = c["inputs"]
    k3 = lambda: bn_gibbs.bn_sweep(cbn, fr, vals, key, "lut_ky", p)
    ms_events = time_ms(torch, k3, 50)
    ms = device_ms(torch, k3, 50, BN_KERNEL)
    plain = time_ms(torch, lambda: _k3_twin(cbn, fr, vals, key, "lut_ky", p),
                    2)
    b = vals.shape[0]
    # bytes, the factor sums' float ops and the threefry calls from
    # kernel_cost (the profile phase held them against this data's)
    cost = c["cost"]
    int_ms = hash_ms(cost.hash_calls, per_call)
    bms, by = bound(cost.hbm_bytes, cost.flops, FP32_FLOPS, int_ms)
    rows.append({
        "name": "K3 bn_sweep (pigs, B=1024, lut_ky)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bn_gibbs.cu",
        "replaces": "src/repro/kernels/bn_gibbs.py:236",
        "launches": launches["bn_sweep"], "max_abs_err": k3_err["pigs"],
        "ms": ms or ms_events, "plain_ms": plain, "bound_ms": bms,
        "bound_by": by, "library_ms": None, "ms_per_call_events": ms_events,
        "bytes": cost.hbm_bytes, "threefry_calls_model": cost.hash_calls,
        "bytes_counted": c["bytes"],
        "threefry_calls": c["threefry_calls"],
        "threefry_bound_ms": int_ms,
    })

    # K2 at the draw request's shape (65,536 x 32 log-potentials)
    tab, spec = exp_lut(dev)
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.rand(1 << 21, generator=g, device=dev) * 11.0 - 10.0
    y_k = interp_lut.interp_kernel(x, tab, spec)
    y_t = interp_lut.interp_kernel_ref(x, tab, spec)
    k2 = lambda: interp_lut.interp_kernel(x, tab, spec)
    ms_events = time_ms(torch, k2, 200)
    ms = device_ms(torch, k2, 200, "interp_kernel")
    plain = time_ms(torch, lambda: interp_lut.interp_kernel_ref(x, tab, spec),
                    50)
    k2 = kernel_cost.lut_exp(x.numel(), tab.numel())
    bms, by = bound(k2.hbm_bytes, k2.flops, FP32_FLOPS)
    rows.append({
        "name": "K2 interp_kernel (65,536 x 32)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/interp_lut.cu",
        "replaces": "src/repro/kernels/interp_lut.py:50",
        "launches": launches["interp_kernel"],
        "max_abs_err": float((y_k - y_t).abs().max()),
        "ms": ms or ms_events, "plain_ms": plain, "bound_ms": bms,
        "bound_by": by, "library_ms": None, "ms_per_call_events": ms_events,
    })

    rows.append(timing_k1(torch, launches, per_call, k1_ptxas, x, tab, spec))

    # one pigs sweep alone and in the query loop, by part, beside the
    # plain-torch word generation the sweep ran before K3 made its words
    wgen = time_ms(torch, lambda: bn_gibbs.fused_round_words(
        fr, key, b, p.n_words, dev), 20)
    emit({"phase": "timing_context", "chains": b,
          **sweep_parts(torch, cbn, fr, vals, prng.key(7)),
          "plain_torch_word_generation_ms_not_run": wgen,
          "pigs_sweep_word_bytes_not_made": b * sum(fr.n_c) * p.n_words * 4})

    # K2 and K1 alone at the shapes their bodies take inside K3 on pigs:
    # one sweep's B * 441 rows of 3 max-subtracted log-probs
    n_rows = b * sum(fr.n_c)
    z = -10.0 * torch.rand((n_rows, p.v_max), generator=g, device=dev)
    w3 = ops.lut_exp_weights(z, tab, spec)
    key3 = prng.key(8)
    words3 = ky_core.random_words(key3, (n_rows,), p.n_words, dev)
    bits3 = ky_sampler.ky_sample_kernel(w3, words3, n_bins=3)[1]["bits_used"]
    ops3 = float(bits3.sum()) * (4 * 4 + 8)
    pigs = {}
    for name, kern, twin, kernel, moved, ops_, int_ms in (
        ("K2", lambda: interp_lut.interp_kernel(z, tab, spec),
         lambda: interp_lut.interp_kernel_ref(z, tab, spec), "interp_kernel",
         kernel_cost.lut_exp(z.numel(), tab.numel()).hbm_bytes,
         kernel_cost.lut_exp(z.numel(), tab.numel()).flops, 0.0),
        ("K1", lambda: ky_sampler.ky_sample_kernel(w3, words3, n_bins=3),
         lambda: ky_sampler.ky_sample_kernel_ref(w3, words3, n_bins=3),
         K1_KERNEL, kernel_cost.ky_sample(n_rows, 3, p.n_words).hbm_bytes,
         ops3, 0.0),
        # the same draws with the words hashed in the kernel from key3
        ("K1_keyed", lambda: ky_sampler.ky_sample_keyed(w3, key3, n_bins=3),
         lambda: ky_sampler.ky_sample_kernel_ref(w3, words3, n_bins=3),
         K1_KERNEL, kernel_cost.ky_sample_keyed(n_rows, 3).hbm_bytes, ops3,
         hash_ms(int(((bits3.long() + 31) // 32).sum()), per_call)),
    ):
        bms, by = bound(moved, ops_, FP32_FLOPS, int_ms)
        pigs[name] = {"ms": device_ms(torch, kern, 50, kernel),
                      "ms_per_call_events": time_ms(torch, kern, 50),
                      "plain_ms": time_ms(torch, twin, 3),
                      "bound_ms": bms, "bound_by": by}
    emit({"phase": "timing_pigs_shapes", "rows": n_rows, "bins": p.v_max,
          **pigs})
    rows.append(timing_mrf(torch, mrf_launches, k4_err, per_call, counts))
    rows.extend(timing_sharded(torch, sharded_launches, k5_err, k6_err,
                               per_call, counts))
    rows.extend(timing_lanes(torch, runtime, lanes_err, per_call, counts))
    emit({"kernels": rows})


def timing_k1(torch, launches: dict, per_call: dict, k1_ptxas: list, x,
              tab, spec) -> dict:
    """K1 at the draw request's shape (65,536 rows of 32 LUT-exp weights):
    the words entry (the reference kernel's signature, the row's `ms`) and
    the keyed entry the draw request runs, each against the twin; their
    bounds; `torch.multinomial` on the same weights as float32, one draw
    per row (the same distribution: KY with its rejection bin draws bin i
    with probability w_i / sum(w)), which the port never calls.  Then the
    draw request's wall by part (`timing_draw_request`).  Returns K1's row
    of the kernels line."""
    from repro_torch import prng
    from repro_torch.core import ky as ky_core
    from repro_torch.kernels import ky_sampler, ops
    from repro_torch.launch import kernel_cost

    dev = torch.device(DEVICE)
    w = ops.lut_exp_weights(x.reshape(DRAW_ROWS, DRAW_BINS), tab, spec)
    key = prng.key(9)
    words = ky_core.random_words(key, (DRAW_ROWS,), 4, dev)
    lab_t, st_t = ky_sampler.ky_sample_kernel_ref(w, words, n_bins=DRAW_BINS)
    err = 0
    for lab, _ in (ky_sampler.ky_sample_kernel(w, words, n_bins=DRAW_BINS),
                   ky_sampler.ky_sample_keyed(w, key, n_bins=DRAW_BINS)):
        err = max(err, int((lab - lab_t).abs().max()))
    k1 = lambda: ky_sampler.ky_sample_kernel(w, words, n_bins=DRAW_BINS)
    keyed = lambda: ky_sampler.ky_sample_keyed(w, key, n_bins=DRAW_BINS)
    wf = w.float()
    library = lambda: torch.multinomial(wf, 1)
    ms_events = time_ms(torch, k1, 200)
    ms = device_ms(torch, k1, 200, K1_KERNEL)
    keyed_events = time_ms(torch, keyed, 200)
    keyed_ms = device_ms(torch, keyed, 200, K1_KERNEL)
    library_events = time_ms(torch, library, 200)
    library_ms = device_busy_ms(torch, library, 200)
    plain = time_ms(torch, lambda: ky_sampler.ky_sample_kernel_ref(
        w, words, n_bins=DRAW_BINS), 5)
    bits = st_t["bits_used"]
    calls = int(((bits.long() + 31) // 32).sum())
    # per walk step: shift, mask, add and compare on 33 lanes, plus the
    # step's own bookkeeping, at the float32 peak, the highest non-tensor
    # rate of NVIDIA's H100 data sheet; the keyed entry reads no words but
    # hashes one threefry call per 32 bits its walks use (`hash_ms`)
    ops_ = float(bits.sum()) * (4 * (DRAW_BINS + 1) + 8)
    # bytes from kernel_cost: weights (and words) read once, the labels
    # and three stats written once
    bms, by = bound(kernel_cost.ky_sample(
        DRAW_ROWS, DRAW_BINS, words.shape[1]).hbm_bytes, ops_)
    keyed_bms, keyed_by = bound(
        kernel_cost.ky_sample_keyed(DRAW_ROWS, DRAW_BINS).hbm_bytes, ops_,
        FP32_FLOPS, hash_ms(calls, per_call))
    timing_draw_request(torch, tab, spec)
    return {
        "name": "K1 ky_sample_kernel (65,536 x 32)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ky_sampler.cu",
        "replaces": "src/repro/kernels/ky_sampler.py:159",
        "launches": launches["ky_sample_kernel"], "max_abs_err": err,
        "ms": ms or ms_events, "plain_ms": plain, "bound_ms": bms,
        "bound_by": by, "library_ms": library_ms or library_events,
        "library": "torch.multinomial(weights.float(), 1)",
        "library_ms_per_call_events": library_events,
        "ms_per_call_events": ms_events,
        "keyed_ms": keyed_ms or keyed_events,
        "keyed_ms_per_call_events": keyed_events,
        "keyed_bound_ms": keyed_bms, "keyed_bound_by": keyed_by,
        "threefry_calls": calls, "walk_steps_per_row": float(bits.sum())
        / DRAW_ROWS, "ptxas": k1_ptxas,
    }


def timing_draw_request(torch, tab, spec) -> None:
    """The main path's draw request (65,536 rows of 32 log-potentials
    through `ops.lut_exp_weights`, then `ops.ky_sample`), back to back:
    wall (CUDA events), host issue time and device time of the whole draw
    and of each part, beside the plain-torch generation of the draw's
    words that `ky_sample` no longer runs."""
    from repro_torch import prng
    from repro_torch.core import ky as ky_core
    from repro_torch.kernels import ops

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(5)
    logp = torch.log(torch.rand((DRAW_ROWS, DRAW_BINS), generator=g,
                                device=dev) * 200.0 + 1.0)
    key = prng.key(9)
    w = ops.lut_exp_weights(logp, tab, spec)
    parts = {
        "draw": lambda: ops.ky_sample(ops.lut_exp_weights(logp, tab, spec),
                                      key),
        "lut_exp_weights": lambda: ops.lut_exp_weights(logp, tab, spec),
        "ky_sample": lambda: ops.ky_sample(w, key),
    }
    out = {"phase": "timing_draw_request", "rows": DRAW_ROWS,
           "bins": DRAW_BINS}
    for name, fn in parts.items():
        out[f"{name}_ms"] = time_ms(torch, fn, 200)
        out[f"{name}_host_ms"] = host_ms(torch, fn, 200)
        out[f"{name}_device_ms"] = device_busy_ms(torch, fn, 200)
    out["draw_busy_share"] = out["draw_device_ms"] / out["draw_ms"]
    c0 = prng._raw_bits.calls
    ops.ky_sample(w, key)
    out["plain_torch_generator_calls"] = prng._raw_bits.calls - c0
    out["plain_torch_word_generation_ms_not_run"] = time_ms(
        torch, lambda: ky_core.random_words(key, (DRAW_ROWS,), 4, dev), 50)
    emit(out)


def timing_mrf(torch, launches: dict, k4_err: dict, per_call: dict,
               counts: dict) -> dict:
    """K4 at the Penguin and Art shapes (1,024 chains, parity 0), one MRF
    half-step through the entry point back to back with the card's busy
    share, beside the plain-torch word generation it no longer runs.
    Returns K4's row of the kernels line (Penguin, the first served
    model)."""
    from repro_torch import prng
    from repro_torch.kernels import mrf_gibbs

    dev = torch.device(DEVICE)
    shapes = {}
    for name in ("penguin", "art"):
        c = counts["k4"] if name == "penguin" else count_mrf(torch, name)
        mrf, ev, labels, p, key, tab, spec = c["inputs"]
        b = labels.shape[0]
        k4 = lambda: mrf_gibbs.mrf_half_step(mrf, labels, ev, key, 0, tab,
                                             spec, p)
        # its input is the half-step's key: the plain version generates
        # the key's words, then runs the twin
        twin = lambda: mrf_gibbs.mrf_half_step_ref(
            mrf, labels, ev, mrf_gibbs.round_words(mrf, key, b, p, dev), 0,
            tab, spec, p)
        # the bytes and threefry calls from kernel_cost (the labels read
        # and written once, the evidence and the table; one call per
        # active site, held against this data's walks in `profile`); the
        # operations this data's sites need: ~16 float ops per site and
        # value (counts, energy, max, lerp) and, per walk step, shift,
        # mask, add and compare on V + 1 lanes plus the step's
        # bookkeeping, at the float32 rate
        cost, v, n_active = c["cost"], mrf.n_labels, c["active_sites"]
        steps = c["walk_steps"]
        ops = n_active * v * 16 + steps * (4 * (v + 1) + 8)
        int_ms = hash_ms(cost.hash_calls, per_call)
        bms, by = bound(cost.hbm_bytes, ops, FP32_FLOPS, int_ms)
        shapes[name] = {
            "ms": device_ms(torch, k4, 50, MRF_KERNEL),
            "ms_per_call_events": time_ms(torch, k4, 50),
            "plain_ms": time_ms(torch, twin, 2), "bound_ms": bms,
            "bound_by": by, "bytes": cost.hbm_bytes, "ops": ops,
            "bytes_counted": c["bytes"],
            "walk_steps_per_site": steps / n_active,
            "active_sites": n_active, "threefry_calls_model": cost.hash_calls,
            "threefry_calls": c["threefry_calls"],
            "threefry_calls_per_site": c["threefry_calls"] / n_active,
            "threefry_bound_ms": int_ms,
        }

    # one half-step of the served Penguin query through the entry point,
    # and how busy the card is over a run of them
    mrf, _, ev = _mrf_model(torch, "penguin")
    tab, spec = exp_lut(dev)
    labels = prng.randint(prng.key(1), (CHAINS, mrf.height, mrf.width), 0,
                          mrf.n_labels, dev)
    p = mrf_gibbs.half_step_params(mrf)
    key = prng.key(3)
    step = lambda: mrf_gibbs.mrf_round_step(mrf, labels, ev, key, 0, tab,
                                            spec)
    wgen = lambda: mrf_gibbs.round_words(mrf, key, CHAINS, p, dev)
    reps = 50
    step_ms = time_ms(torch, step, reps)
    device_total = device_busy_ms(torch, step, reps)
    emit({"phase": "timing_mrf", "chains": CHAINS, "shapes": shapes,
          "penguin_half_step_ms": step_ms,
          "penguin_half_step_device_ms": device_total,
          "device_busy_share": device_total / step_ms,
          "plain_torch_word_generation_ms_not_run": time_ms(torch, wgen, 5),
          "penguin_words_bytes_not_made": CHAINS * mrf.height * mrf.width
          * p.n_words * 4})
    pg = shapes["penguin"]
    return {
        "name": "K4 mrf_half_step (penguin 64x64x4, B=1024)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mrf_gibbs.cu",
        "replaces": "src/repro/kernels/mrf_gibbs.py:159",
        "launches": launches["mrf_half_step"],
        "max_abs_err": max(k4_err.values()),
        "ms": pg["ms"] or pg["ms_per_call_events"], "plain_ms": pg["plain_ms"],
        "bound_ms": pg["bound_ms"], "bound_by": pg["bound_by"],
        "library_ms": None, "ms_per_call_events": pg["ms_per_call_events"],
        "bytes": pg["bytes"],
        "threefry_calls_model": pg["threefry_calls_model"],
        "bytes_counted": pg["bytes_counted"],
        "threefry_calls": pg["threefry_calls"],
        "threefry_bound_ms": pg["threefry_bound_ms"],
    }


def timing_sharded(torch, launches: dict, k5_err: dict, k6_err: dict,
                   per_call: dict, counts: dict):
    """K5 per round launch over every position of a pigs sweep on the
    (2, 4) mesh, and K6 per half-step launch over every slab of Penguin,
    at 1,024 chains: kernel device time, time per call, the twin's time
    (with the key's words generated, as the function's input is the key)
    and the bound (bytes and threefry calls from `kernel_cost`: values or
    labels read once, the node positions' planes or the labels written
    once; one call per drawn row or active site, held against the twins'
    walks in `profile`; the calls at the SASS's instructions).  Then one
    pigs sharded sweep and one Penguin sharded half-step by part
    (`sharded_parts`).  Returns K5's and K6's rows of the kernels line."""
    from repro_torch.kernels import bn_gibbs, mrf_gibbs

    dev = torch.device(DEVICE)
    rows = []

    # K5: the rounds of one pigs sweep, one launch each
    c5 = counts["k5"]
    cbn, sfr, vals, p, key, n = c5["inputs"]

    def k5_sweep():
        for r in range(n):
            bn_gibbs.fused_color_round_mesh(cbn, sfr, r, vals, key, "lut_ky",
                                            p, MESH[0])

    def twin_sweep():
        for r in range(n):
            _k5_twin_round(torch, cbn, sfr, r, vals, key, "lut_ky", p)

    ms_events = time_ms(torch, k5_sweep, 20) / n
    ms = device_ms(torch, k5_sweep, 20, BN_KERNEL)
    plain = time_ms(torch, twin_sweep, 2) / n
    # per launch, averaged over the sweep's rounds: the values read once,
    # each node position's plane written once, the position tables of one
    # round, the arena and LUT; the factor sums' float ops; the threefry
    # calls of the owned rows
    cost = c5["cost"]
    int_ms = hash_ms(cost.hash_calls, per_call)
    bms, by = bound(cost.hbm_bytes, cost.flops, FP32_FLOPS, int_ms)
    emit({"phase": "timing_k5", "model": "pigs", "mesh": list(MESH),
          "launches_timed": n, "ms": ms and ms / n,
          "ms_per_call_events": ms_events, "plain_ms": plain,
          "bound_ms": bms, "bound_by": by,
          "bytes_per_launch": cost.hbm_bytes,
          "threefry_calls_model_per_launch": cost.hash_calls,
          "threefry_calls_per_launch": c5["threefry_calls"],
          "threefry_bound_ms": int_ms})
    rows.append({
        "name": "K5 fused_color_round_mesh (pigs, one round on every "
                "position of a (2, 4) mesh, B=1024, lut_ky)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bn_gibbs.cu",
        "replaces": "src/repro/kernels/bn_gibbs.py:316",
        "launches": launches["fused_color_round"],
        "max_abs_err": k5_err["pigs"],
        "ms": (ms / n) if ms else ms_events, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "ms_per_call_events": ms_events, "bytes": cost.hbm_bytes,
        "threefry_calls_model": cost.hash_calls,
        "bytes_counted": c5["bytes"],
        "threefry_calls": c5["threefry_calls"],
        "threefry_bound_ms": int_ms,
    })

    # K6: one Penguin half-step over every slab, one launch
    c6 = counts["k6"]
    mrf, ev, labels, up, down, p, key, tab, spec = c6["inputs"]
    n_g = MESH[1]
    h_loc, v = mrf.height // n_g, mrf.n_labels
    k6 = lambda: mrf_gibbs.mrf_halo_half_step(mrf, labels, up, down, 0, ev,
                                              key, 0, tab, spec, p)

    def twin():
        words = mrf_gibbs.round_words(mrf, key, CHAINS, p, dev)
        return [mrf_gibbs.mrf_halo_half_step_ref(
            mrf, labels[:, g * h_loc:(g + 1) * h_loc], up[g], down[g],
            g * h_loc, ev[g * h_loc:(g + 1) * h_loc],
            words[:, g * h_loc:(g + 1) * h_loc], 0, tab, spec, p)
            for g in range(n_g)]

    ms_events = time_ms(torch, k6, 50)
    ms = device_ms(torch, k6, 50, MRF_KERNEL)
    plain = time_ms(torch, twin, 2)
    # bytes and threefry calls from kernel_cost (the labels read and
    # written once, the halo rows, evidence and LUT); operations counted
    # from this data's walks as for K4
    cost, n_active, steps = c6["cost"], c6["active_sites"], c6["walk_steps"]
    ops = n_active * v * 16 + steps * (4 * (v + 1) + 8)
    int_ms = hash_ms(cost.hash_calls, per_call)
    bms, by = bound(cost.hbm_bytes, ops, FP32_FLOPS, int_ms)
    emit({"phase": "timing_k6", "model": "penguin", "mesh": list(MESH),
          "slab_rows": h_loc, "ms": ms, "ms_per_call_events": ms_events,
          "plain_ms": plain, "bound_ms": bms, "bound_by": by,
          "bytes_per_launch": cost.hbm_bytes, "ops_per_launch": ops,
          "threefry_calls_model": cost.hash_calls,
          "threefry_calls": c6["threefry_calls"],
          "threefry_bound_ms": int_ms})
    rows.append({
        "name": "K6 mrf_halo_half_step (penguin, every 16-row slab of a "
                "(2, 4) mesh, B=1024)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mrf_gibbs.cu",
        "replaces": "src/repro/kernels/mrf_gibbs.py:280",
        "launches": launches["mrf_halo_half_step"],
        "max_abs_err": max(k6_err.values()),
        "ms": ms or ms_events, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "ms_per_call_events": ms_events, "bytes": cost.hbm_bytes,
        "threefry_calls_model": cost.hash_calls, "bytes_counted": c6["bytes"],
        "threefry_calls": c6["threefry_calls"],
        "threefry_bound_ms": int_ms,
    })
    sharded_parts(torch, cbn, sfr, vals, mrf, ev, labels)
    return rows


def sharded_parts(torch, cbn, sfr, vals, mrf, ev, labels) -> None:
    """One pigs sweep and one Penguin half-step of the fused sharded
    engines on the (2, 4) mesh at 1,024 chains, by part.  `loop_*`: a
    query through `run_sharded(fused=True)` (pigs: histogram every sweep;
    Penguin: per iteration of two half-steps), wall and host issue time per
    sweep or iteration (`per_sweep`) and the card's busy share
    (torch.profiler, same slope).  `round_*` / `half_step_*`: one
    round (K5 launch + psum merge) or half-step (halo exchange + K6
    launch) back to back: wall (CUDA events), host issue time, device
    time.  Parts: host and device time of the K5 wrapper, the psum merge
    (`_psum_merge`), the key split and the histogram; of the halo exchange
    (`_halo_exchange`) and the K6 wrapper."""
    from repro_torch import prng
    from repro_torch.compile.program import compile_graph
    from repro_torch.core import distributed
    from repro_torch.core.graphs import bn_repository_replica
    from repro_torch.kernels import bn_gibbs, mrf_gibbs

    mesh = distributed.make_mesh(MESH, ("data", "model"), DEVICE)
    # the programs `_sharded_bn` and the MRF queries compile
    prog = compile_graph(bn_repository_replica("pigs"), device=cbn.device)
    mprog = compile_graph(mrf, device=cbn.device)
    key = prng.key(7)
    p = bn_gibbs.sweep_params(cbn, "lut_ky")
    n = len(sfr.n_c)
    hist = torch.zeros((cbn.n_nodes, cbn.max_card), dtype=torch.int32,
                       device=vals.device)
    v_range = torch.arange(cbn.max_card, dtype=torch.int32,
                           device=vals.device)
    k5 = lambda: bn_gibbs.fused_color_round_mesh(cbn, sfr, 0, vals, key,
                                                 "lut_ky", p, MESH[0])
    stack = k5()
    merge = lambda: distributed._psum_merge(vals, stack)
    rnd = lambda: distributed._psum_merge(vals, k5())

    def bn_loop(iters):
        return prog.run_sharded(key, mesh, n_chains=CHAINS, n_iters=iters,
                                burn_in=0, fused=True)

    bn = {"rounds_per_sweep": n}
    bn["loop_ms"], bn["loop_host_ms"] = per_sweep(torch, bn_loop)
    bn["loop_device_ms"] = (device_busy_ms(torch, lambda: bn_loop(250), 1)
                            - device_busy_ms(torch, lambda: bn_loop(50), 1)
                            ) / 200
    bn["loop_busy_share"] = bn["loop_device_ms"] / bn["loop_ms"]
    bn["round_ms"] = time_ms(torch, rnd, 200)
    bn["round_host_ms"] = host_ms(torch, rnd, 200)
    bn["round_device_ms"] = device_busy_ms(torch, rnd, 200)
    bn["host_k5_wrapper_ms"] = host_ms(torch, k5, 200)
    bn["host_psum_merge_ms"] = host_ms(torch, merge, 200)
    bn["host_key_split_ms"] = host_ms(torch, lambda: prng.split(key), 200)
    bn["host_hist_ms"] = host_ms(torch, lambda: hist + (
        vals[..., None] == v_range).sum(0, dtype=torch.int32), 200)
    bn["device_k5_ms"] = device_ms(torch, k5, 200, BN_KERNEL)
    bn["device_psum_merge_ms"] = device_busy_ms(torch, merge, 200)
    emit({"phase": "timing_sharded_bn_sweep", "model": "pigs",
          "mesh": list(MESH), "chains": CHAINS, **bn})

    tab, spec = exp_lut(labels.device)
    n_g = MESH[1]
    exchange = lambda: distributed._halo_exchange(labels, n_g)
    up, down = exchange()
    k6 = lambda: mrf_gibbs.mrf_sharded_round_step(
        mrf, labels, ev, key, 0, tab, spec, n_chain_pos=MESH[0],
        n_row_pos=n_g, up_halo=up, down_halo=down)

    def half_step():
        u, d = exchange()
        return mrf_gibbs.mrf_sharded_round_step(
            mrf, labels, ev, key, 0, tab, spec, n_chain_pos=MESH[0],
            n_row_pos=n_g, up_halo=u, down_halo=d)

    def mrf_loop(iters):
        return mprog.run_sharded(key, mesh, evidence=ev, n_chains=CHAINS,
                                 n_iters=iters, fused=True)

    m = {}
    m["loop_ms_per_iteration"], m["loop_host_ms_per_iteration"] = per_sweep(
        torch, mrf_loop)
    m["loop_device_ms_per_iteration"] = (
        device_busy_ms(torch, lambda: mrf_loop(250), 1)
        - device_busy_ms(torch, lambda: mrf_loop(50), 1)) / 200
    m["loop_busy_share"] = (m["loop_device_ms_per_iteration"]
                            / m["loop_ms_per_iteration"])
    m["half_step_ms"] = time_ms(torch, half_step, 200)
    m["half_step_host_ms"] = host_ms(torch, half_step, 200)
    m["half_step_device_ms"] = device_busy_ms(torch, half_step, 200)
    m["half_step_busy_share"] = m["half_step_device_ms"] / m["half_step_ms"]
    m["host_halo_exchange_ms"] = host_ms(torch, exchange, 200)
    m["host_k6_wrapper_ms"] = host_ms(torch, k6, 200)
    m["device_halo_exchange_ms"] = device_busy_ms(torch, exchange, 200)
    m["device_k6_ms"] = device_ms(torch, k6, 200, MRF_KERNEL)
    emit({"phase": "timing_sharded_mrf_half_step", "model": "penguin",
          "mesh": list(MESH), "chains": CHAINS, **m})


# ---------------------------------------------------------------------------
# the serving runtime: K3's and K4's lane entries, and a bucket per launch
# ---------------------------------------------------------------------------

LANES_Q = 3  # queries of the lane-entry checks
WALL_REPS = 5  # timed runs of each runtime bucket and standalone query
RUNTIME_SLICE = 100  # the runtime phase's slice_iters
RUNTIME_SEED = 17


def phase_lanes(torch) -> dict:
    """K3's lane entry (`bn_sweep_lanes`) on pigs and K4's
    (`mrf_half_step_lanes`) on Penguin and Art, LANES_Q queries of 1,024
    chains each, and K3's on hailfinder at the runtime bucket's 2 queries,
    against their twins (bit-equal, lut_ky) and against the one-query
    kernels run query by query with the same keys (bit-equal, exact_ky
    included).  `timing_lanes` holds the runtime's other bucket shapes
    (pigs at 8 queries, Penguin at 2) against the twins.  K3's blocks hold `chains_per_block` chains of one
    query, and 1,024 is no multiple of it: each query's last block is
    partial."""
    from repro_torch import prng
    from repro_torch.core import bayesnet as bnet
    from repro_torch.core import mrf as mrf_mod
    from repro_torch.core.graphs import bn_repository_replica
    from repro_torch.kernels import bn_gibbs, mrf_gibbs

    dev = torch.device(DEVICE)
    errs = {"k3": 0}
    # pigs at LANES_Q, whose queries end in partial blocks, and the
    # runtime's hailfinder bucket (2 queries) at its own shape
    for name, q, seed in (("pigs", LANES_Q, 20), ("hailfinder", 2, 90)):
        cbn = bnet.compile_bayesnet(bn_repository_replica(name), device=dev)
        fr = bn_gibbs.build_fused_rounds(cbn.groups)
        vals = torch.cat([bnet.init_chain_values(cbn, prng.key(seed + i),
                                                 CHAINS)[0]
                          for i in range(q)])
        keys = [prng.key(seed + 10 + i) for i in range(q - 1)] + [
            prng.Key(0xFFFFFFFF, 0x89ABCDEF)]
        kt = prng.key_tensor(keys, dev)
        cpc = min(bn_gibbs.chains_per_block(q * CHAINS, cbn.n_nodes,
                                            cbn.exp_spec.size), CHAINS)
        if name == "pigs":
            check(CHAINS % cpc != 0, f"{cpc} chains per block divide "
                  f"{CHAINS}: no partial block to check")
        out = {"phase": "k3_lanes", "model": name, "queries": q,
               "chains": CHAINS, "chains_per_block": cpc,
               "partial_block_chains": CHAINS % cpc}
        for sampler in ("lut_ky", "exact_ky"):
            p = bn_gibbs.sweep_params(cbn, sampler)
            got = bn_gibbs.bn_sweep_lanes(cbn, fr, vals, kt, sampler, p)
            one = torch.cat([
                bn_gibbs.bn_sweep(cbn, fr, vals[i * CHAINS:(i + 1) * CHAINS],
                                  k, sampler, p) for i, k in enumerate(keys)])
            torch.cuda.synchronize()
            bad = int((got != one).sum())
            out[f"{sampler}_mismatches_vs_one_query_kernel"] = bad
            check(bad == 0, f"K3 lanes differ from K3 run query by query "
                  f"({name}, {sampler}, {bad} labels)")
            if sampler == "lut_ky":
                want = bn_gibbs.bn_sweep_lanes_ref(cbn, fr, vals, kt, sampler,
                                                   p)
                bad = int((got != want).sum())
                errs["k3"] = max(errs["k3"], int((got - want).abs().max()))
                out["lut_ky_mismatches_vs_twin"] = bad
                out["lut_ky_changed_share"] = float(
                    (got != vals).float().mean())
                check(bad == 0, f"K3 lanes differ from their twin on {name} "
                      f"({bad})")
        emit(out)

    tab, spec = exp_lut(dev)
    errs["k4"] = 0
    for name in ("penguin", "art"):
        mrf, _, _ = _mrf_model(torch, name)
        hh, ww, v = mrf.height, mrf.width, mrf.n_labels
        evs = torch.stack([torch.as_tensor(mrf_mod.make_denoising_problem(
            hh, ww, v, 0.25, seed=s)[1]) for s in range(LANES_Q)]).to(dev)
        labels = prng.randint(prng.key(1), (LANES_Q * CHAINS, hh, ww), 0, v,
                              dev)
        p = mrf_gibbs.half_step_params(mrf)
        out = {"phase": "k4_lanes", "model": name, "queries": LANES_Q,
               "chains": CHAINS, "mismatches_vs_twin": {},
               "mismatches_vs_one_query_kernel": {}}
        for parity in (0, 1):
            keys = [prng.key(40 + 3 * parity + i) for i in range(LANES_Q)]
            kt = prng.key_tensor(keys, dev)
            got = mrf_gibbs.mrf_half_step_lanes(mrf, labels, evs, kt, parity,
                                                tab, spec, p)
            one = torch.cat([mrf_gibbs.mrf_half_step(
                mrf, labels[i * CHAINS:(i + 1) * CHAINS], evs[i], k, parity,
                tab, spec, p) for i, k in enumerate(keys)])
            want = mrf_gibbs.mrf_half_step_lanes_ref(mrf, labels, evs, kt,
                                                     parity, tab, spec, p)
            torch.cuda.synchronize()
            b1, b2 = int((got != one).sum()), int((got != want).sum())
            errs["k4"] = max(errs["k4"], int((got - want).abs().max()))
            out["mismatches_vs_one_query_kernel"][str(parity)] = b1
            out["mismatches_vs_twin"][str(parity)] = b2
            check(b1 == 0 and b2 == 0, f"K4 lanes differ on {name}, parity "
                  f"{parity}: {b1} labels from K4 query by query, {b2} "
                  "from the twin")
        emit(out)
    return errs


def _runtime_trace():
    """The runtime phase's models and queries, all at 1,024 chains x 200
    sweeps, arriving within one microbatch window: 8 pigs queries sharing
    one observed-node set (5-20 nodes) with their own values and seeds, 2
    hailfinder queries likewise, and 4 Penguin denoising queries, the
    first 2 with MRF_PINS pixels pinned at their clean labels (the vmap
    route) and 2 unpinned (the sharded route)."""
    import numpy as np

    from repro_torch.core import mrf as mrf_mod
    from repro_torch.core.graphs import GridMRF, bn_repository_replica
    from repro_torch.runtime import Query

    nets = {m: bn_repository_replica(m) for m in ("pigs", "hailfinder")}
    h, w, v, _ = MRF_MODELS["penguin"]
    models = {**nets, "penguin": GridMRF(h, w, v, theta=1.2, h=2.0,
                                         name="penguin")}
    rng = np.random.default_rng(RUNTIME_SEED)
    queries = []

    def add(model, **kw):
        queries.append(Query(
            qid=len(queries), model=model, n_chains=CHAINS, n_iters=ITERS,
            seed=int(rng.integers(0, 2**31 - 1)),
            arrival_s=1e-6 * len(queries), **kw))

    for model, n_q in (("pigs", 8), ("hailfinder", 2)):
        cards = nets[model].cards
        nodes = rng.choice(len(cards), size=int(rng.integers(5, 21)),
                           replace=False)
        for _ in range(n_q):
            add(model, burn_in=BURN_IN, evidence={
                int(x): int(rng.integers(0, cards[x])) for x in nodes})
    for i in range(4):
        clean, noisy = mrf_mod.make_denoising_problem(h, w, v, 0.25,
                                                      seed=40 + i)
        pins = None
        if i < 2:
            sites = rng.choice(h * w, size=MRF_PINS, replace=False)
            pins = {int(s): int(clean.flat[s]) for s in sites}
        add("penguin", evidence=pins, image=noisy, burn_in=0)
    return models, queries


def _to_host(out):
    """A standalone run's answer copied to the host: BN (marginals, final
    values), MRF final labels."""
    if isinstance(out, tuple):
        return [t.cpu() for t in out]
    return out.cpu()


def wall_ms(torch, fn) -> float:
    """The wall of one call of `fn` (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def spread(xs) -> dict:
    """The median, least and largest of a few timed runs."""
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def _runtime_config(**kw):
    from repro_torch.runtime import EngineConfig

    return EngineConfig(fused=True, max_batch=8, n_workers=4, shard_width=4,
                        shard_min_sites=4096, **kw)


class DispatchWalls:
    """While active, records every executor dispatch's wall from CUDA
    events around `Executor.execute` (which ends in the results' copy to
    the host): (model, route, queries, resumed, ms)."""

    def __init__(self, torch):
        self.torch, self.rows = torch, []

    def __enter__(self):
        from repro_torch.runtime import executor

        torch, rows = self.torch, self.rows
        self._cls, self._orig = executor.Executor, executor.Executor.execute
        orig = self._orig

        def execute(ex, program, key, qs, route, return_state=False):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(ex, program, key, qs, route, return_state)
            end.record()
            end.synchronize()
            rows.append((qs[0].model, route, len(qs), key.resumed,
                         start.elapsed_time(end)))
            return out

        self._cls.execute = execute
        return self

    def __exit__(self, *exc):
        self._cls.execute = self._orig


def phase_serve_runtime(torch) -> dict:
    """The serving runtime's main path: `Engine(fused=True, max_batch=8,
    n_workers=4, shard_width=4, shard_min_sites=4096, slice_iters=100)`
    over `_runtime_trace`, programs compiled cold, counters zeroed before
    `run()` and read after.  Every BN bucket sweep is one launch of K3's
    lane entry and every pinned Penguin half-step one launch of K4's, over
    all of the bucket's queries; the unpinned Penguin queries take the
    sharded route (K6).  Then: every answer equals the standalone
    `program.run(key, ..., fused=True)` and the unsliced engine's, bit for
    bit; each bucket's wall (a warm run, CUDA events) beside the sum of
    its queries' standalone walls; `engine.calibrate()`'s medians beside
    the line model's predictions."""
    from repro_torch import prng
    from repro_torch.compile.program import clear_program_cache
    from repro_torch.runtime import Engine

    dev = torch.device(DEVICE)
    models, queries = _runtime_trace()
    clear_program_cache()
    eng = Engine(models, _runtime_config(slice_iters=RUNTIME_SLICE),
                 device=dev)
    eng.submit(queries)

    # ---- the main path: counters zeroed, the trace served, counters read --
    zero_launches()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = read_launches()
    # ---- end of the main path ----------------------------------------------

    recs = eng.metrics.batch_records
    n_bn = sum(1 for q in queries if q.model != "penguin")
    bn_recs = [r for r in recs if r.kind == "bn"]
    vmap_mrf = [r for r in recs if r.kind == "mrf" and r.route == "vmap"]
    sharded = [r for r in recs if r.route == "sharded"]
    n_sharded_q = sum(r.n_real for r in sharded)
    # a BN bucket: one K3 lane launch per sweep of its slice, whatever its
    # queries; a pinned Penguin bucket: two K4 lane launches per iteration;
    # a sharded Penguin query: two K6 launches per iteration; the
    # cross-checks: 3 one-query K3 sweeps per BN program, 3 K4
    # half-step pairs for the vmap route's and 3 more for the sharded
    # route's single-device leg, and 3 K6 pairs on its (1, 2) mesh
    want = {
        "bn_sweep_lanes": RUNTIME_SLICE * len(bn_recs),
        "mrf_half_step_lanes": 2 * RUNTIME_SLICE * len(vmap_mrf),
        "bn_sweep": 3 * 2, "mrf_half_step": 2 * 3 * 2,
        "mrf_halo_half_step": n_sharded_q * 2 * RUNTIME_SLICE + 2 * 3,
        "fused_color_round": 0, "ky_sample_kernel": 0, "interp_kernel": 0,
    }
    dispatches = [{"model": r.model, "route": r.route, "queries": r.n_real,
                   "n_padded": r.n_padded, "workers": r.n_workers,
                   "measured_s": r.measured_s} for r in recs]
    emit({"phase": "serve_runtime", "queries": len(queries),
          "slice_iters": RUNTIME_SLICE, "chains": CHAINS, "sweeps": ITERS,
          "served": len(res), "dispatches": dispatches,
          "launches": launches, "expected_launches": want,
          "wall_s_cold": cold_s})
    check(len(res) == len(queries), f"served {len(res)} of {len(queries)}")
    check(sorted(r.n_real for r in bn_recs) == [2, 2, 8, 8],
          f"BN buckets {[(r.model, r.n_real) for r in bn_recs]}: the pigs "
          "queries should share one bucket per slice, hailfinder's another")
    check(sum(r.n_real for r in vmap_mrf) == 2 * 2 and n_sharded_q == 2 * 2,
          f"Penguin dispatches {dispatches}")
    check(launches == want, f"runtime launches {launches}, expected {want}")

    # ---- is what came out right? ------------------------------------------
    walls = {}
    for q in queries:
        prog = eng._program(q.model)
        if q.model == "penguin":
            kw = dict(evidence=q.image, pins=q.evidence)
        else:
            kw = dict(evidence=q.evidence, burn_in=BURN_IN)
        run = lambda: prog.run(prng.key(q.seed), n_chains=CHAINS,
                               n_iters=ITERS, fused=True, device=dev, **kw)
        out = run()
        # the standalone query's answer reaches the host, as a served
        # bucket's does (`execute_bucket` ends in the copy)
        walls[q.qid] = [wall_ms(torch, lambda: _to_host(run()))
                        for _ in range(WALL_REPS)]
        r = res[q.qid]
        if q.model == "penguin":
            same = (r.final_state == out.cpu().numpy()).all()
            w = models["penguin"].width
            pinned = all((r.final_state[:, s // w, s % w] == lab).all()
                         for s, lab in (q.evidence or {}).items())
            check(pinned, f"query {q.qid}: a pinned pixel moved")
        else:
            same = ((r.final_state == out[1].cpu().numpy()).all()
                    and (r.marginals == out[0].cpu().numpy()).all())
        check(bool(same), f"query {q.qid} ({q.model}) differs from its "
              "standalone run")
    whole_eng = Engine(models, _runtime_config(), device=dev)
    whole_eng.submit(queries)
    whole = whole_eng.run()
    for q in queries:
        a, b = res[q.qid], whole[q.qid]
        check((a.final_state == b.final_state).all() and (
            a.marginals is None or (a.marginals == b.marginals).all()),
            f"query {q.qid}: sliced and unsliced answers differ")

    # ---- walls: each bucket (warm) against its queries' standalone walls --
    runs = []
    for _ in range(WALL_REPS):
        warm = Engine(models, _runtime_config(slice_iters=RUNTIME_SLICE),
                      device=dev)
        warm.submit(queries)
        with DispatchWalls(torch) as dw:
            warm.run()
        runs.append(dw.rows)
    routes = {q.qid: ("sharded" if q.model == "penguin" and not q.evidence
                      else "vmap") for q in queries}
    buckets = []
    for model in models:
        for route in ("vmap", "sharded"):
            per_run = [[x[4] for x in rows if x[0] == model and x[1] == route]
                       for rows in runs]
            if not per_run[0]:
                continue
            qids = [q.qid for q in queries
                    if q.model == model and routes[q.qid] == route]
            bucket = spread([sum(x) for x in per_run])
            alone = {"median": sum(statistics.median(walls[i])
                                   for i in qids),
                     "min": sum(min(walls[i]) for i in qids),
                     "max": sum(max(walls[i]) for i in qids)}
            buckets.append({
                "model": model, "route": route, "queries": len(qids),
                "dispatches": len(per_run[0]), "runs": WALL_REPS,
                "dispatch_ms": per_run, "bucket_ms": bucket,
                "standalone_ms_sum": alone,
                "standalone_ms": {i: walls[i] for i in qids},
                "speedup_of_medians": alone["median"] / bucket["median"],
                "queries_per_wall_s": len(qids) / (bucket["median"] / 1e3),
                "standalone_queries_per_wall_s": len(qids) / (
                    alone["median"] / 1e3),
            })
    emit({"phase": "serve_runtime_walls", "card": nvidia_smi(),
          "buckets": buckets})

    # ---- calibration: measured medians beside the line model --------------
    cal = warm.calibrate(queries)
    names = {g.ir_key: m for m, g in warm.graphs.items()}
    sigs = []
    for sig, (pad, median_s) in cal.measured.items():
        prog = warm._program(names[sig.program_key])
        width = warm.config.shard_width if sig.route == "sharded" else 1
        sigs.append({"model": names[sig.program_key], "route": sig.route,
                     "n_iters": sig.n_iters, "resumed": sig.resumed,
                     "n_padded": pad, "median_s": median_s,
                     "line_s": cal.line_s(prog, sig, pad, width)})
    emit({"phase": "serve_runtime_calibration", "signatures": sigs})
    check(len(sigs) >= 4, f"calibrated {len(sigs)} signatures")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# profile: every served dispatch joined to its static cost and roofline
# ---------------------------------------------------------------------------

PROFILE_WALL_RUNS = 3  # engine runs with profiling on, and off, for walls
RATIO_LIMIT = 1.05  # a bound above the wall: work the card did not do
COUNT_TOLERANCE = 0.01  # kernel_cost against the counts of this run's data


def count_k3(torch) -> dict:
    """K3 at the pigs main-path shape (B = 1,024, lut_ky), as `timing`
    times it: its inputs, the bytes it must move (the values read and
    written once, the tables, arena and LUT), the threefry calls the rows'
    walks need (the twin's walks), and `kernel_cost`'s count of the same
    launch."""
    from repro_torch.launch import kernel_cost

    cbn, fr, vals, p, key = _k3_setup(torch, "pigs", "lut_ky")
    with WalkBits() as walks:
        _k3_twin(cbn, fr, vals, key, "lut_ky", p)
    return {
        "inputs": (cbn, fr, vals, p, key),
        "bytes": (nbytes(vals, cbn.log_flat, cbn.exp_table, fr.nodes,
                         fr.cards, fr.base, fr.stride, fr.scope_var,
                         fr.is_self) + nbytes(vals)),
        "threefry_calls": walks.threefry_calls,
        "cost": kernel_cost.bn_sweep(kernel_cost.bn_shape(cbn, cbn.groups),
                                     vals.shape[0]),
    }


def _mrf_walk(torch, mrf, w, words, active, p) -> tuple[float, int]:
    """The walk steps and threefry calls of the active sites' draws from
    weights `w` ((B, H, W, V)) and words ((B, H, W, n_words))."""
    from repro_torch.core import ky as ky_core

    v = mrf.n_labels
    bits = ky_core.ky_sample_fast(
        w[:, active].reshape(-1, v), words[:, active].reshape(-1, p.n_words),
        n_bins=v, precision=p.precision)[1]["bits_used"]
    return float(bits.sum()), int(((bits.long() + 31) // 32).sum())


def count_mrf(torch, name: str) -> dict:
    """K4 at a served MRF shape (1,024 chains, parity 0), as `timing_mrf`
    times it: its inputs, the bytes it must move (the labels read and
    written once, the evidence and table), the walk steps and threefry
    calls of the active sites, and `kernel_cost`'s count."""
    from repro_torch import prng
    from repro_torch.core.mrf import checkerboard_mask
    from repro_torch.kernels import mrf_gibbs
    from repro_torch.launch import kernel_cost

    dev = torch.device(DEVICE)
    tab, spec = exp_lut(dev)
    mrf, _, ev = _mrf_model(torch, name)
    b, v = CHAINS, mrf.n_labels
    labels = prng.randint(prng.key(1), (b, mrf.height, mrf.width), 0, v, dev)
    p = mrf_gibbs.half_step_params(mrf)
    key = prng.key(2)
    active = checkerboard_mask(mrf.height, mrf.width, 0, dev)
    steps, calls = _mrf_walk(
        torch, mrf, mrf_gibbs.site_weights(mrf, labels, ev, tab, spec),
        mrf_gibbs.round_words(mrf, key, b, p, dev), active, p)
    return {
        "inputs": (mrf, ev, labels, p, key, tab, spec),
        "bytes": 2 * nbytes(labels) + nbytes(ev, tab),
        "threefry_calls": calls, "walk_steps": steps,
        "active_sites": b * int(active.sum()),
        "cost": kernel_cost.mrf_half_step(
            kernel_cost.mrf_shape(mrf, tab.numel()), b, 0),
    }


def count_k3_lanes(torch) -> dict:
    """K3's lane entry at the runtime's pigs bucket (8 queries x 1,024
    chains, lut_ky), as `timing_lanes` times it: the Q * B chains' values
    read and written once, the key array and tables; the twin's walks."""
    from repro_torch import prng
    from repro_torch.core import bayesnet as bnet
    from repro_torch.core.graphs import bn_repository_replica
    from repro_torch.kernels import bn_gibbs
    from repro_torch.launch import kernel_cost

    dev = torch.device(DEVICE)
    q = 8
    cbn = bnet.compile_bayesnet(bn_repository_replica("pigs"), device=dev)
    fr = bn_gibbs.build_fused_rounds(cbn.groups)
    vals = torch.cat([bnet.init_chain_values(cbn, prng.key(50 + i),
                                             CHAINS)[0] for i in range(q)])
    kt = prng.key_tensor([prng.key(60 + i) for i in range(q)], dev)
    p = bn_gibbs.sweep_params(cbn, "lut_ky")
    with WalkBits() as walks:
        bn_gibbs.bn_sweep_lanes_ref(cbn, fr, vals, kt, "lut_ky", p)
    return {
        "inputs": (cbn, fr, vals, kt, p, q),
        "bytes": (2 * nbytes(vals) + nbytes(kt, cbn.log_flat, cbn.exp_table,
                                            fr.nodes, fr.cards, fr.base,
                                            fr.stride, fr.scope_var,
                                            fr.is_self)),
        "threefry_calls": walks.threefry_calls,
        "cost": kernel_cost.bn_sweep_lanes(
            kernel_cost.bn_shape(cbn, cbn.groups), q, CHAINS),
    }


def count_k4_lanes(torch) -> dict:
    """K4's lane entry at the runtime's pinned Penguin bucket (2 queries x
    1,024 chains, parity 0), as `timing_lanes` times it: the labels read
    and written once, the evidence planes, keys and table; the active
    sites' walks, lane by lane."""
    from repro_torch import prng
    from repro_torch.core import mrf as mrf_mod
    from repro_torch.kernels import mrf_gibbs
    from repro_torch.launch import kernel_cost

    dev = torch.device(DEVICE)
    q = 2
    mrf, _, _ = _mrf_model(torch, "penguin")
    hh, ww, v = mrf.height, mrf.width, mrf.n_labels
    evs = torch.stack([torch.as_tensor(mrf_mod.make_denoising_problem(
        hh, ww, v, 0.25, seed=40 + i)[1]) for i in range(q)]).to(dev)
    labels = prng.randint(prng.key(1), (q * CHAINS, hh, ww), 0, v, dev)
    keys = [prng.key(70 + i) for i in range(q)]
    kt = prng.key_tensor(keys, dev)
    tab, spec = exp_lut(dev)
    p = mrf_gibbs.half_step_params(mrf)
    calls, steps, n_active = _k4_lane_calls(torch, mrf, labels, evs, keys,
                                            CHAINS)
    return {
        "inputs": (mrf, labels, evs, kt, tab, spec, p, q),
        "bytes": 2 * nbytes(labels) + nbytes(evs, kt, tab),
        "threefry_calls": calls, "walk_steps": steps,
        "active_sites": n_active,
        "cost": kernel_cost.mrf_half_step_lanes(
            kernel_cost.mrf_shape(mrf, tab.numel()), q, CHAINS, 0),
    }


def count_k5(torch) -> dict:
    """K5 per round launch of one pigs sweep on the (2, 4) mesh, as
    `timing_sharded` times it, averaged over the sweep's rounds: the
    values read once, each node position's plane written once, a round's
    position tables, the arena and LUT; the twin's walks."""
    from repro_torch import prng
    from repro_torch.compile.program import compile_graph
    from repro_torch.core.graphs import bn_repository_replica
    from repro_torch.kernels import bn_gibbs
    from repro_torch.launch import kernel_cost

    cbn, sfr, vals = _sharded_bn(torch, "pigs")
    p = bn_gibbs.sweep_params(cbn, "lut_ky")
    key = prng.key(2)
    n = len(sfr.n_c)
    with WalkBits() as walks:
        for r in range(n):
            _k5_twin_round(torch, cbn, sfr, r, vals, key, "lut_ky", p)
    table = nbytes(sfr.nodes, sfr.cards, sfr.base, sfr.stride,
                   sfr.scope_var, sfr.is_self, sfr.word_pos) // n
    groups = compile_graph(bn_repository_replica("pigs"),
                           device=DEVICE).schedule_executable().round_groups
    shape = kernel_cost.bn_shape(cbn, groups)
    sweep = kernel_cost.total(
        kernel_cost.bn_color_round_mesh(shape, r, CHAINS, MESH[1], sfr.c_max)
        for r in range(n))
    return {
        "inputs": (cbn, sfr, vals, p, key, n),
        "bytes": ((1 + MESH[1]) * nbytes(vals) + table
                  + nbytes(cbn.log_flat, cbn.exp_table)),
        "threefry_calls": walks.threefry_calls / n,
        "cost": sweep * (1.0 / n),
    }


def count_k6(torch) -> dict:
    """K6 per Penguin half-step launch over every slab of the (2, 4) mesh
    (parity 0), as `timing_sharded` times it: the labels read and written
    once, the halo rows, evidence and table; the active sites' walks over
    the slabs."""
    from repro_torch import prng
    from repro_torch.core import distributed
    from repro_torch.core.mrf import checkerboard_mask
    from repro_torch.kernels import mrf_gibbs
    from repro_torch.launch import kernel_cost

    dev = torch.device(DEVICE)
    tab, spec = exp_lut(dev)
    mrf, _, ev = _mrf_model(torch, "penguin")
    n_g = MESH[1]
    h_loc, v = mrf.height // n_g, mrf.n_labels
    labels = prng.randint(prng.key(1), (CHAINS, mrf.height, mrf.width), 0, v,
                          dev)
    p = mrf_gibbs.half_step_params(mrf)
    key = prng.key(2)
    up, down = distributed._halo_exchange(labels, n_g)
    active = checkerboard_mask(mrf.height, mrf.width, 0, dev)
    w = torch.cat([mrf_gibbs.site_weights(
        mrf, labels[:, g * h_loc:(g + 1) * h_loc],
        ev[g * h_loc:(g + 1) * h_loc], tab, spec, up[g], down[g])
        for g in range(n_g)], dim=1)
    steps, calls = _mrf_walk(torch, mrf, w,
                             mrf_gibbs.round_words(mrf, key, CHAINS, p, dev),
                             active, p)
    return {
        "inputs": (mrf, ev, labels, up, down, p, key, tab, spec),
        "bytes": 2 * nbytes(labels) + nbytes(up, down, ev, tab),
        "threefry_calls": calls, "walk_steps": steps,
        "active_sites": CHAINS * int(active.sum()),
        "cost": kernel_cost.mrf_halo_half_step(
            kernel_cost.mrf_shape(mrf, tab.numel()), CHAINS, n_g, 0),
    }


COUNTS = {"k3": count_k3, "k4": lambda torch: count_mrf(torch, "penguin"),
          "k3_lanes": count_k3_lanes, "k4_lanes": count_k4_lanes,
          "k5": count_k5, "k6": count_k6}


def _replay(torch, models, queries, profiled: bool):
    """One engine run of the runtime phase's configuration and queries;
    with `profiled`, under the tracer and the profiler, whose events and
    registry it returns.  Returns (results, wall s, events, registry)."""
    from repro_torch import obs
    from repro_torch.obs import export, profile
    from repro_torch.runtime import Engine

    if profiled:
        obs.enable()
        profile.enable()
    eng = Engine(models, _runtime_config(slice_iters=RUNTIME_SLICE),
                 device=torch.device(DEVICE))
    eng.submit(queries)
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = reg = None
    if profiled:
        events = export.events_as_dicts(list(obs.get().events))
        reg = profile.get()
        profile.disable()
        obs.disable()
    return res, wall, events, reg


def phase_profile(torch) -> dict:
    """The profiler (`repro_torch.obs.profile`) over the runtime phase's
    engine and 14 queries, replayed once with profiling on: every dispatch,
    the sharded ones included, joins to a static cost (`launch.
    kernel_cost`) whose roofline is at most RATIO_LIMIT of its measured
    wall; `profile.json` (under build/profile/) validates; every answer
    equals the same replay's without profiling, bit for bit.  Then
    `kernel_cost`'s per-launch bytes and threefry calls of K3, K4, their
    lane entries, K5 and K6 against the counts of this run's data
    (`COUNTS`, what `timing` bounds them with), within COUNT_TOLERANCE;
    `python -m repro_torch.obs --profile` and `python -m repro_torch.diag
    --quick` as subprocesses (exit 0); and the engine's wall with
    profiling on against off, medians of PROFILE_WALL_RUNS runs.  Returns
    the counts, which `timing` reuses."""
    import os

    from repro_torch.launch import report
    from repro_torch.obs import profile

    models, queries = _runtime_trace()
    off, _, _, _ = _replay(torch, models, queries, False)
    on, _, events, reg = _replay(torch, models, queries, True)
    for q in queries:
        a, b = on[q.qid], off[q.qid]
        check((a.final_state == b.final_state).all() and (
            a.marginals is None or (a.marginals == b.marginals).all()),
            f"query {q.qid}: profiling changed its answer")
    out_dir = ROOT / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "profile.json"
    rec = profile.write_profile(path, reg, events)
    joined = rec["joined"]
    problems = profile.validate_profile(rec)
    print(report.profile_table(joined["rows"], joined["comm"]), flush=True)
    ratios = {row["sig"]: row["roofline_s"] / row["measured_mean_s"]
              for row in joined["rows"]}
    rows = [{k: row[k] for k in ("sig", "meta", "n_dispatches", "flops",
                                 "hbm_bytes", "hash_calls",
                                 "collective_bytes", "bottleneck",
                                 "roofline_s", "measured_mean_s")}
            | {"roofline_over_measured": ratios[row["sig"]]}
            for row in joined["rows"]]
    emit({"phase": "profile", "card": nvidia_smi(), "path": str(path),
          "signatures": len(rec["buckets"]),
          "dispatches": joined["n_dispatches"],
          "sharded_dispatches": joined["n_sharded"],
          "unattributed": joined["unattributed"], "problems": problems,
          "rows": rows, "comm": joined["comm"]})
    check(problems == [], f"profile.json has problems: {problems}")
    check(joined["unattributed"] == [] and joined["n_sharded"] > 0,
          f"unattributed {joined['unattributed']}, "
          f"{joined['n_sharded']} sharded dispatches")
    bad = {s: r for s, r in ratios.items() if not r <= RATIO_LIMIT}
    check(not bad, f"roofline above {RATIO_LIMIT} x the measured wall: {bad}")

    counts = {name: fn(torch) for name, fn in COUNTS.items()}
    agree = {}
    for name, c in counts.items():
        cost = c["cost"]
        agree[name] = {
            "bytes": c["bytes"], "kernel_cost_bytes": cost.hbm_bytes,
            "threefry_calls": c["threefry_calls"],
            "kernel_cost_threefry_calls": cost.hash_calls,
        }
        for ours, theirs in ((cost.hbm_bytes, c["bytes"]),
                             (cost.hash_calls, c["threefry_calls"])):
            check(abs(ours - theirs) <= COUNT_TOLERANCE * theirs,
                  f"{name}: kernel_cost counts {ours}, the data {theirs}")
    emit({"phase": "profile_counts", "tolerance": COUNT_TOLERANCE,
          "entries": agree})

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    clis = {}
    for name, args in (("obs", ["repro_torch.obs", "--profile", str(path)]),
                       ("diag", ["repro_torch.diag", "--quick"])):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                             env=env, capture_output=True, text=True,
                             timeout=600)
        clis[name] = {"rc": out.returncode,
                      "s": time.perf_counter() - t0,
                      "tail": out.stdout.splitlines()[-3:]}
        check(out.returncode == 0, f"python -m {' '.join(args)} exited "
              f"{out.returncode}: {out.stdout[-2000:]} {out.stderr[-2000:]}")
    walls = {"on": [], "off": []}
    for _ in range(PROFILE_WALL_RUNS):
        walls["on"].append(_replay(torch, models, queries, True)[1])
        walls["off"].append(_replay(torch, models, queries, False)[1])
    emit({"phase": "profile_walls", "card": nvidia_smi(), "clis": clis,
          "engine_wall_s_profiled": spread(walls["on"]),
          "engine_wall_s_unprofiled": spread(walls["off"])})
    return counts


def _k4_lane_calls(torch, mrf, labels, evs, keys, b):
    """The threefry calls K4's lane entry hashes for one half-step (parity
    0): the words the active sites' walks consume, lane by lane."""
    from repro_torch.core import ky as ky_core
    from repro_torch.core.mrf import checkerboard_mask
    from repro_torch.kernels import mrf_gibbs

    dev = labels.device
    tab, spec = exp_lut(dev)
    p = mrf_gibbs.half_step_params(mrf)
    active = checkerboard_mask(mrf.height, mrf.width, 0, dev)
    calls, steps = 0, 0.0
    for i, k in enumerate(keys):
        lab = labels[i * b:(i + 1) * b]
        words = mrf_gibbs.round_words(mrf, k, b, p, dev)
        w = mrf_gibbs.site_weights(mrf, lab, evs[i], tab, spec)[:, active]
        bits = ky_core.ky_sample_fast(
            w.reshape(-1, mrf.n_labels),
            words[:, active].reshape(-1, p.n_words), n_bins=mrf.n_labels,
            precision=p.precision)[1]["bits_used"]
        steps += float(bits.sum())
        calls += int(((bits.long() + 31) // 32).sum())
    return calls, steps, int(active.sum()) * b * len(keys)


def runtime_parts(torch, cbn, vals, kt, q: int) -> None:
    """The runtime's pigs bucket loop (`backend.bn_rounds_lanes`, Q = 8 x
    1,024 chains, every sweep kept), per sweep: wall and host issue time
    (`per_sweep`, the slope between 50 and 250 sweeps), the card's busy
    share (torch.profiler, same slope), and its parts issued back to back:
    the batched key split (numpy), K3's lane wrapper and launch, the
    (Q, n, V) histogram update (host and device time)."""
    import numpy as np

    from repro_torch import prng
    from repro_torch.compile import backend
    from repro_torch.kernels import bn_gibbs

    keys = [prng.key(80 + i) for i in range(q)]
    fr = bn_gibbs.build_fused_rounds(cbn.groups)
    p = bn_gibbs.sweep_params(cbn, "lut_ky")
    hist = torch.zeros((q, cbn.n_nodes, cbn.max_card), dtype=torch.int32,
                       device=vals.device)
    v_range = torch.arange(cbn.max_card, dtype=torch.int32,
                           device=vals.device)
    arr = prng.key_array(keys)

    def loop(n):
        return backend.bn_rounds_lanes(cbn, cbn.groups, keys,
                                       n_chains=CHAINS, n_iters=n, burn_in=0,
                                       sampler="lut_ky")

    k3 = lambda: bn_gibbs.bn_sweep_lanes(cbn, fr, vals, kt, "lut_ky", p)
    hist_update = lambda: hist + (vals.view(q, CHAINS, -1)[..., None]
                                  == v_range).sum(1, dtype=torch.int32)
    out = {"queries": q, "chains": CHAINS}
    out["loop_ms"], out["loop_host_ms"] = per_sweep(torch, loop)
    out["loop_device_ms"] = (device_busy_ms(torch, lambda: loop(250), 1)
                             - device_busy_ms(torch, lambda: loop(50), 1)
                             ) / 200
    out["loop_busy_share"] = out["loop_device_ms"] / out["loop_ms"]
    out["loop_ms_per_query_sweep"] = out["loop_ms"] / q
    out["host_split_many_ms"] = host_ms(
        torch, lambda: prng.split_many(arr, 2), 200)
    out["host_k3_lanes_wrapper_ms"] = host_ms(torch, k3, 200)
    out["host_hist_ms"] = host_ms(torch, hist_update, 200)
    out["device_k3_lanes_ms"] = device_ms(torch, k3, 50, BN_KERNEL)
    out["device_hist_ms"] = device_busy_ms(torch, hist_update, 50)
    out["split_many_equals_split"] = bool(np.array_equal(
        prng.split_many(arr, 2)[:, 1],
        prng.key_array([prng.split(k)[1] for k in keys])))
    emit({"phase": "timing_runtime_bucket_sweep", "model": "pigs", **out})


def loop_row(torch, fn) -> dict:
    """Wall, host issue and card time per sweep of a loop `fn(n)`
    (`per_sweep` and torch.profiler, the slope between 50 and 250)."""
    ms, host = per_sweep(torch, fn)
    d250 = device_busy_ms(torch, lambda: fn(250), 1)
    d50 = device_busy_ms(torch, lambda: fn(50), 1)
    dev = (d250 - d50) / 200
    return {"ms": ms, "host_ms": host, "device_ms": dev,
            "busy_share": dev / ms, "device_ms_of_250_and_50": [d250, d50]}


def timing_lane_loops(torch) -> None:
    """The runtime's fused bucket loops per sweep (pigs, hailfinder, every
    sweep kept) or per iteration (Penguin with MRF_PINS pixels pinned):
    `backend.bn_rounds_lanes` / `mrf_rounds_lanes` at the served bucket's
    Q (hailfinder and Penguin: 2; pigs' 8 is `runtime_parts`') and at
    Q = 1, beside the one-query loop a fused
    `program.run` takes (`bn_rounds_core` / `mrf_rounds_core`, fused) on
    the first lane's key, all at 1,024 chains per query, in one call."""
    import numpy as np

    from repro_torch import prng
    from repro_torch.compile import backend
    from repro_torch.core import bayesnet as bnet
    from repro_torch.core import mrf as mrf_mod
    from repro_torch.core.graphs import GridMRF, bn_repository_replica

    dev = torch.device(DEVICE)
    kw = dict(n_chains=CHAINS, burn_in=0, sampler="lut_ky")
    out = {"phase": "timing_lane_loops", "card": nvidia_smi(),
           "chains": CHAINS}
    keys = [prng.key(110 + i) for i in range(8)]
    for name, qs in (("pigs", (1,)), ("hailfinder", (2, 1))):
        cbn = bnet.compile_bayesnet(bn_repository_replica(name), device=dev)
        row = out[f"{name}_per_sweep"] = {}
        for q in qs:
            row[f"lanes_q{q}"] = loop_row(
                torch, lambda n: backend.bn_rounds_lanes(
                    cbn, cbn.groups, keys[:q], n_iters=n, **kw))
        row["one_query"] = loop_row(
            torch, lambda n: backend.bn_rounds_core(
                cbn, cbn.groups, keys[0], n_iters=n, fused=True, **kw))

    h, w, v, _ = MRF_MODELS["penguin"]
    mrf = GridMRF(h, w, v, theta=1.2, h=2.0, name="penguin")
    rng = np.random.default_rng(RUNTIME_SEED)
    evs, masks, pvals = [], [], []
    for i in range(2):
        clean, noisy = mrf_mod.make_denoising_problem(h, w, v, 0.25,
                                                      seed=40 + i)
        sites = rng.choice(h * w, size=MRF_PINS, replace=False)
        m, pv = backend.pin_arrays(
            mrf, {int(x): int(clean.flat[x]) for x in sites}, dev)
        evs.append(torch.as_tensor(noisy, dtype=torch.int32))
        masks.append(m)
        pvals.append(pv)
    ev = torch.stack(evs).to(dev)
    pm, pv = torch.stack(masks), torch.stack(pvals)
    mkw = dict(n_chains=CHAINS, sampler="lut_ky")
    out["penguin_per_iter"] = {}
    for q in (2, 1):
        out["penguin_per_iter"][f"lanes_q{q}"] = loop_row(
            torch, lambda n: backend.mrf_rounds_lanes(
                mrf, (0, 1), ev[:q], keys[:q], n_iters=n, pin_mask=pm[:q],
                pin_vals=pv[:q], **mkw))
    out["penguin_per_iter"]["one_query"] = loop_row(
        torch, lambda n: backend.mrf_rounds_core(
            mrf, (0, 1), ev[0], keys[0], n_iters=n, fused=True,
            pin_mask=pm[0], pin_vals=pv[0], **mkw))
    emit(out)


def timing_lanes(torch, runtime: dict, errs: dict, per_call: dict,
                 counts: dict):
    """K3's lane entry at the runtime's pigs bucket (8 queries x 1,024
    chains, lut_ky) and K4's at its pinned Penguin bucket (2 x 1,024),
    one launch each: held against the twin on the same inputs (bit-equal;
    `max_abs_err` is the largest of these and `phase_lanes`'), kernel
    device time (torch.profiler), time per call
    (CUDA events), the twin's time (the lanes' words generated in plain
    torch, then the per-key twin query by query) and the bound (bytes and
    threefry calls from `kernel_cost`: the Q * B chains' values or labels
    read and written once, the tables; one call per drawn row or active
    site, held against the walks in `profile`; the calls at the SASS's
    instructions).  Returns the two rows of the kernels line."""
    from repro_torch.kernels import bn_gibbs, mrf_gibbs

    launches = runtime["launches"]
    rows = []
    c = counts["k3_lanes"]
    cbn, fr, vals, kt, p, q = c["inputs"]
    k3 = lambda: bn_gibbs.bn_sweep_lanes(cbn, fr, vals, kt, "lut_ky", p)
    twin = lambda: bn_gibbs.bn_sweep_lanes_ref(cbn, fr, vals, kt, "lut_ky",
                                               p)
    got, want = k3(), twin()
    torch.cuda.synchronize()
    bad = int((got != want).sum())
    err = max(errs["k3"], int((got - want).abs().max()))
    check(bad == 0, f"K3 lanes differ from their twin at the runtime's pigs "
          f"bucket (Q={q}, {bad} labels)")
    ms_events = time_ms(torch, k3, 50)
    ms = device_ms(torch, k3, 50, BN_KERNEL)
    plain = time_ms(torch, twin, 1)
    cost = c["cost"]
    int_ms = hash_ms(cost.hash_calls, per_call)
    bms, by = bound(cost.hbm_bytes, cost.flops, FP32_FLOPS, int_ms)
    rows.append({
        "name": "K3 bn_sweep_lanes (pigs, Q=8 x B=1024, lut_ky)",
        "route": "cuda", "source": "src/repro_torch/kernels/csrc/bn_gibbs.cu",
        "replaces": "src/repro/kernels/bn_gibbs.py:236",
        "launches": launches["bn_sweep_lanes"], "max_abs_err": err,
        "mismatches_vs_twin": bad,
        "ms": ms or ms_events, "plain_ms": plain, "bound_ms": bms,
        "bound_by": by, "library_ms": None, "ms_per_call_events": ms_events,
        "bytes": cost.hbm_bytes, "threefry_calls_model": cost.hash_calls,
        "bytes_counted": c["bytes"],
        "threefry_calls": c["threefry_calls"],
        "threefry_bound_ms": int_ms, "per_query_ms": (ms or ms_events) / q,
    })
    runtime_parts(torch, cbn, vals, kt, q)
    timing_lane_loops(torch)

    c = counts["k4_lanes"]
    mrf, labels, evs, kt, tab, spec, p, q = c["inputs"]
    v = mrf.n_labels
    k4 = lambda: mrf_gibbs.mrf_half_step_lanes(mrf, labels, evs, kt, 0, tab,
                                               spec, p)
    twin = lambda: mrf_gibbs.mrf_half_step_lanes_ref(mrf, labels, evs, kt,
                                                     0, tab, spec, p)
    got, want = k4(), twin()
    torch.cuda.synchronize()
    bad = int((got != want).sum())
    err = max(errs["k4"], int((got - want).abs().max()))
    check(bad == 0, f"K4 lanes differ from their twin at the runtime's "
          f"Penguin bucket (Q={q}, {bad} labels)")
    ms_events = time_ms(torch, k4, 50)
    ms = device_ms(torch, k4, 50, MRF_KERNEL)
    plain = time_ms(torch, twin, 1)
    cost, n_active, steps = c["cost"], c["active_sites"], c["walk_steps"]
    ops = n_active * v * 16 + steps * (4 * (v + 1) + 8)
    int_ms = hash_ms(cost.hash_calls, per_call)
    bms, by = bound(cost.hbm_bytes, ops, FP32_FLOPS, int_ms)
    rows.append({
        "name": "K4 mrf_half_step_lanes (penguin 64x64x4, Q=2 x B=1024)",
        "route": "cuda", "source": "src/repro_torch/kernels/csrc/mrf_gibbs.cu",
        "replaces": "src/repro/kernels/mrf_gibbs.py:159",
        "launches": launches["mrf_half_step_lanes"],
        "max_abs_err": err, "mismatches_vs_twin": bad,
        "ms": ms or ms_events, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "ms_per_call_events": ms_events, "bytes": cost.hbm_bytes,
        "threefry_calls_model": cost.hash_calls, "bytes_counted": c["bytes"],
        "threefry_calls": c["threefry_calls"],
        "threefry_bound_ms": int_ms, "per_query_ms": (ms or ms_events) / q,
    })
    return rows


if __name__ == "__main__":
    sys.exit(main())
