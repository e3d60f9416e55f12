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
              1-128 bins, precision 16 and 21 (and 17, 24 and 30 at 128
              bins, the token sampler's tree levels), 8 retries and 1
              (bits run out): labels and the three stats bit-equal.
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
11a. serve_ranks — the sampler's mesh over processes: the kernel
              libraries are built before the ranks start (they only load
              them), then `launch.mesh.spawn` starts 8 gloo ranks sharing
              the card as a (2, 4) mesh (`core.distributed.RankMesh`).
              Each rank runs its own position through
              `compile_graph(...).run_sharded(key, mesh, ...)`: pigs and
              hailfinder (one query of `serve` each, fused, 1,024 chains x
              200 sweeps), Penguin (1,024 x 200), asia with
              `diagnostics=True`, and pigs sliced at sweep 100 and resumed
              through its carry; counters zeroed on each rank before and
              read after: K5 launched once per round a rank (over its own
              node position and chain block), K6 twice per iteration (its
              own slab), nothing else.  Every rank's result equals, bit
              for bit, the single-process `run_sharded` on a (2, 4) mesh
              of the card and `run(fused=True)` (the snapshot field for
              field).  Each run's wall by part on rank 0: K5/K6 ms a
              launch (alone in rank 0, CUDA events), the collectives'
              host ms a round (gloo, staged through host memory), and the
              rest, the host's.  Then an NCCL world of min(cards, 4) ranks
              as a (1, n) mesh (one rank holding a 1 x 1 mesh on one
              card) runs pigs and Penguin, equal to the single-process
              mesh and to `run`.  A failed rank fails the phase.
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
              [...]}` (K1-K6, K3's and K4's lane entries, and K1 and K2
              at the token draw's shapes of each LM phase).
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
16. serve_lm (after profile, before `timing`) — LM serving at yi-9b's
              full width (d 4,096; its 48 layers cut to LM_SERVE_LAYERS'
              8, printed; bf16, random weights from a seeded
              generator): caches freed,
              then 8 prompts of 128 tokens (seeded) through
              `launch.serve.generate(..., 16, sampler="ky")` (LM_GEN, cut
              from 32, printed) after a
              warm-up, counters zeroed before and read after: K1 launched
              3 times (the tree's levels, 128 bins each) and K2 once per
              token, nothing else, and no word made in plain torch.  Every
              token in [0, 64,000); the steps run again through
              `steps.make_serve_step` give the same tokens, each equal to
              the twin's draw (`ky_token_sample` on the CPU) on the same
              float32 logits and key; the last step's logits within 5% of
              the largest |logit| of a full forward over the 144 tokens
              (bf16); greedy decoding twice gives equal tokens.  Then
              (timing_serve_lm) prefill of 8 x 128 tokens and decode per
              token (medians over the 15 steps, CUDA events) beside their
              bounds (bf16 operations at 989 TFLOP/s; bytes at 3.35 TB/s),
              a step split into the model and the draw with the card's
              busy share, the draw beside `torch.multinomial(softmax)`,
              and K2 at (8, 64,000) and K1 at each level's (8, 128) against
              their twins and bounds: the kernels line's token-draw rows.
              The model is freed and the serve CLI runs in a subprocess
              (`python -m repro_torch.launch.serve --arch yi-9b --batch 8
              --prompt-len 128 --gen 16 --sampler ky`), which must exit 0.
17. serve_lm_moe — the same run, checks and timings for qwen2-moe-a2.7b
              at full width (6 of its 24 layers, LM_SERVE_LAYERS; d 2,048,
              16 heads of 128 with qkv bias, 60 experts top-4 at 1,408 and
              a shared 5,632; the whole stack 14.3 B parameters, 28.6 GB
              in bf16; vocabulary 151,936: 3 K1 launches a token).  Prefill routes each row as a group
              (capacity 12 an expert), a decode step the batch as one
              (capacity 4); the assignments dropped at capacity per row in
              prefill, each decode step and the forward are printed, and
              decode against forward holds the rows that dropped none.
              The bounds count every expert's slots (`lm_expert_macs`).
18. serve_lm_xlstm — the same for xlstm-350m at full width (4 of 24
              layers, d 1,024, mLSTM:sLSTM 3:1, vocabulary 50,304: 3 K1 launches a
              token; the recurrent states are the caches), decode against
              forward within 10% (its exponential gates amplify bf16
              rounding; the reference's own gap reaches 7.6%), then its
              serve CLI in a subprocess.  For it and jamba, decode against
              forward is also held on a float32 copy, within 1e-3.
19. serve_lm_hybrid — the same for jamba-1.5-large-398b at reduced()
              (Mamba, attention and MoE on every other layer; vocabulary
              256: 2 K1 launches a token), since 398.6 B parameters do not
              fit one card.
20. mamba_block — one Mamba mixer at jamba's full widths (d 8,192,
              d_inner 16,384, 16 states, dt rank 512, conv 4; 0.42 B
              parameters) in float32 on the card: 8 rows, a prefill of 128
              positions, 8 decode steps.  Decode step t equals a prefill
              over 129 + t positions at its last one, and the card's
              prefill output and state equal the CPU's, within 1e-3 of the
              scale; prefill and a decode step timed beside their bounds.
21. moe_block — one MoE FFN at qwen2-moe-a2.7b's widths (d 2,048, 60
              experts top-4 at 1,408, shared 5,632) in float32: a prefill
              row of 128 tokens (capacity 12) and a decode group of 8
              (capacity 4), leaning towards two experts so that both drop
              assignments; the card's experts, slots and kept assignments
              equal the CPU's, its output within 1e-4 of the scale.

22. train_lm — single-card training at full width: yi-9b (d 4,096, GQA
              32/4 of 128, SwiGLU 11,008, vocabulary 64,000) cut to 8 of
              its 48 layers, and qwen2-moe-a2.7b (60 experts top-4 at
              1,408, shared 5,632, vocabulary 151,936) cut to 2 of 24, each
              cut printed; a training model from a seed (float32 leaves),
              AdamW as the reference's trainer runs it by default (lr
              3e-4, warmup 20), remat "nothing", B = 4 x
              S = 1,024 tokens from `SyntheticLM`, through
              `steps.make_train_step`: 10 steps, whose losses are finite
              and fall (the last below the first, from about ln V), each
              step's loss, grad norm and lr printed; the step's median ms
              over 5 steps after 2 warm-up steps (CUDA events) beside its
              bound (`lm_train_flops` at 989 TFLOP/s plus AdamW's bytes
              at 3.35 TB/s), tokens/s, the card's busy share and kernels
              of one step (torch.profiler) and the peak memory.  Then the
              trainer as a user runs it, in subprocesses under
              deterministic algorithms: `python -m
              repro_torch.launch.train --arch yi-9b --reduced` for 4 steps
              with a checkpoint every 2, then `--steps 6 --resume` (it
              prints "resumed from step 4"), against an uninterrupted
              6-step run: every step's loss, grad norm and lr equal bit
              for bit.
23. train_block — one yi-9b layer (attention and SwiGLU) at full width in
              float32, B = 1 x S = 1,024: the loss mean(y^2) and the
              gradient of every leaf and the input on the card within
              1e-4 of the CPU's; the flash backward at yi-9b's heads
              against the naive oracle under autograd on the card.
24. serve_lm_mesh (after moe_block) — LM serving over a mesh of ranks
              (`launch/sharding.py`, `launch/collectives.py`, the meshed
              `launch/steps.py` factories): 8 gloo ranks sharing the card
              as (2, 4), then an NCCL world of min(cards, 4) ranks (one
              card: a 1 x 1 mesh), at full width with depth cut (yi-9b 2
              of 48 layers, qwen2-moe-a2.7b 1 of 24, xlstm-350m 4 of 24:
              three mLSTM and an sLSTM, jamba-1.5-large-398b 1 of 72: a
              Mamba mixer and the dense FFN; each cut printed).
              Each rank builds the model from the seed on the card,
              distributes it (its shards alone stay: the bytes the
              caching allocator was asked for equal the specs' shard
              bytes) and runs `serve.generate(..., mesh=)` on 8 prompts
              of 128 tokens for 4 KY tokens (cut from 8), counters
              zeroed before and read after (K1 a tree level and 1 K2 a
              token, nothing else); every
              rank returns the same tokens and logits, every draw equals
              the twin's on the gathered logits, the logits are within
              LM_MESH_LOGIT_RTOL of the one-process steps' teacher-forced
              on the same tokens, and the NCCL 1 x 1 world is bit-equal
              to one process.  The meshed steps compute tensor-parallel
              over the model axis (attention heads, Mamba channels, xLSTM
              heads and head dims, FFN and expert columns; partial sums
              all-reduced), and decode attends over each rank's block of
              the K/V cache's sequence: the bytes a rank's decode step
              moves over "model" must stay under one gather of the
              attention layers' caches.  Prints each rank's wall, the
              collectives' host ms and result bytes a token by op and
              axis and by axis, a decode step's by axis, and the
              resident bytes.
25. train_lm_mesh (after train_block) — LM training over the mesh at
              full width with depth cut, float32 leaves, under
              deterministic algorithms, on the NCCL world (whose rank 0
              first runs each one-process reference) and the (2, 4) gloo
              world: yi-9b 2 of 48 layers, B 8 x S 512 `SyntheticLM`, 3
              AdamW steps; then the models whose recurrent mixers split
              over "model" (Mamba by channel, mLSTM by head, sLSTM by
              head dim), one AdamW step each on B 8 x S 128:
              xlstm-350m 4 of 24 layers (three mLSTM and an sLSTM) and
              jamba-1.5-large-398b 1 of 72 (a Mamba mixer and the dense
              FFN; 2.1 G leaves, built by the gloo ranks in turns); each
              cut printed.  For each model: the same losses on every
              rank (yi-9b's falling); in the gloo world, before yi-9b's
              last step a checkpoint of block 0 and the final norm with
              their moments (every rank sends its shards to rank 0,
              which writes them whole), those zeroed and restored from
              it bit for bit, the last step run from them; ranks holding
              the same block of a leaf hold the same bytes; a rank's
              leaves take its shards' bytes; step 0's loss within
              LM_MESH_LOSS_RTOL (yi-9b, 5e-5) or LM_MESH_LOSS_RTOL_BY_ARCH
              (xlstm-350m and jamba 1e-4, each between its sound gap and
              a fault planted in its split region) and its gradient norm
              within LM_MESH_GNORM_RTOL (1e-3; xlstm-350m 1e-2,
              LM_MESH_GNORM_RTOL_BY_ARCH) of the one-process run's, and
              each leaf's update within LM_MESH_UPDATE_RTOL (0.25)
              of the norm of the one-process update (bit-equal on the
              NCCL 1 x 1 world); each step's wall, collective ms and
              each rank's collective bytes by op and axis, and the
              resident bytes, printed.
26. examples (after train_lm_mesh) — the port's four examples
              (`examples/torch_quickstart.py`, `torch_mrf_denoise.py`,
              `torch_serve_lm.py`, `torch_train_lm.py`, the reference's
              four with the same arguments and checks) on the card at
              their smallest arguments (EXAMPLES), as subprocesses
              started together: each exits 0 and prints its check
              (TVD < 0.05; the denoised error below the noisy one; each
              sampler's line; the loss fell) and "OK", the four within
              60 s; their seconds on a phase_seconds line.

The last line is `{"ok": true, "device": {...}}`.  Without a CUDA device,
or run from a directory that lacks the port's sources, it prints no result
and exits 2.
"""

from __future__ import annotations

import json
import os
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
# the device kernels' names, for the profiler: K3 and its lane entry are
# one kernel, and so are K4 and its lane entry
K3_KERNEL = "bn_lanes_kernel"
K5_KERNEL = "bn_rounds_kernel"
K4_KERNEL = "mrf_lanes_kernel"
K6_KERNEL = "mrf_half_step_kernel"
# K1's instances (ky_lanes_kernel, ky_planes_kernel) share this prefix
K1_KERNEL = "ky_"
K1_WIDTHS = (1, 2, 3, 4, 11, 15, 16, 31, 32, 33, 63, 64, 65, 127, 128)
K1_PRECISIONS = (16, 21)
# the token sampler's tree levels: 128 bins at precisions 17, 24 and 30
K1_LEVEL_CASES = tuple((128, p) for p in (17, 24, 30))
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
    timed(phase_serve_ranks, torch)
    lanes_err = timed(phase_lanes, torch)
    runtime = timed(phase_serve_runtime, torch)
    counts = timed(phase_profile, torch)
    lm_rows = timed(phase_serve_lm, torch, per_call)
    lm_rows += timed(phase_serve_lm_moe, torch, per_call)
    lm_rows += timed(phase_serve_lm_xlstm, torch, per_call)
    lm_rows += timed(phase_serve_lm_hybrid, torch, per_call)
    timed(phase_mamba_block, torch)
    timed(phase_moe_block, torch)
    mesh_launches = timed(phase_serve_lm_mesh, torch)
    for row in lm_rows[:2]:  # yi-9b's K1 and K2 rows
        kernel = ("ky_sample_kernel" if row["name"].startswith("K1")
                  else "interp_kernel")
        row["launches_serve_lm_mesh_rank0"] = {
            arch: n[kernel] for arch, n in mesh_launches.items()}
    timed(phase_train_lm, torch)
    timed(phase_train_block, torch)
    timed(phase_train_lm_mesh, torch)
    timed(phase_examples, torch)
    timed(phase_timing, torch, launches, k3_err, mrf_launches, k4_err,
          sharded_launches, k5_err, k6_err, per_call, k1_ptxas, runtime,
          lanes_err, counts, lm_rows)
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


def profiled_kernels(torch, fn, reps: int) -> list:
    """The device-side kernel rows (`kernel_events`) of `reps` calls of
    `fn` under torch.profiler, after one call outside it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return kernel_events(torch, prof)


def device_ms(torch, fn, reps: int, kernel: str, launches: int = 1):
    """Device ms per call of the kernels whose name contains `kernel`, from
    torch.profiler's CUPTI trace (launch gaps excluded): the mean time of
    the launches the trace recorded, times `launches` a call.  Late in a
    long process the profiler can start tracing the card some
    milliseconds into its window and miss the launches before, so the
    mean is taken over the recorded launches, not over `reps` calls.
    With `kernel` "" every kernel of a call is summed, over `reps` calls.
    None when the profiler recorded no such kernel."""
    rows = [e for e in profiled_kernels(torch, fn, reps) if kernel in e.key]
    us = sum(e.device_time_total for e in rows)
    if us <= 0:
        return None
    if not kernel:
        return us / reps / 1e3
    return us / sum(e.count for e in rows) * launches / 1e3


def device_busy_ms(torch, fn, reps: int) -> float:
    """Device time per call of every kernel `fn` launches (torch.profiler),
    for the card's busy share against the wall time per call; windows of
    long loops, where a late start of the trace is lost in the sum."""
    return sum(e.device_time_total
               for e in profiled_kernels(torch, fn, reps)) / 1e3 / reps


def device_kernels_per_call(torch, fn, reps: int) -> float:
    """Device kernels `fn` launches per call (torch.profiler's count of
    kernel rows), the work a host issues one launch at a time."""
    return sum(e.count for e in profiled_kernels(torch, fn, reps)) / reps


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


def instance_name(mangled: str) -> str | None:
    """`bn_lanes_kernel<3, 1, 32>` from the mangled name of an instance of
    an integer- or bool-templated `..._kernel` (K3-K6), else None."""
    m = re.search(r"\d([a-z_]+_kernel)I((?:L[ib]-?\d+E)+)E", mangled)
    if not m:
        return None
    args = re.findall(r"L[ib](-?\d+)E", m.group(2))
    return f"{m.group(1)}<{', '.join(args)}>"


def template_instances(log: str) -> list[dict]:
    """Registers, stack frame and spill bytes of every instance of an
    integer-templated `..._kernel<...>` in an `nvcc -Xptxas -v` log (K3-K6:
    `bn_lanes_kernel<CAP, EXACT, CPW>`, `bn_rounds_kernel<VCAP>`,
    `mrf_lanes_kernel<CAP, EXACT>`, `mrf_half_step_kernel<VCAP>`), named
    by `instance_name`."""
    entries, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name, cur = instance_name(m.group(1)), None
            if name:
                cur = {"function": name}
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
    # K3-K6's instances, one line of their own
    k3_k6 = []
    for name in ("bn_gibbs", "mrf_gibbs"):
        log = _lib.BUILD_DIR / f"{name}.log"
        if log.exists():
            k3_k6 += template_instances(log.read_text())
    emit({"phase": "build_k3_k6_instances", "instances": k3_k6})
    check(len(k3_k6) == 48, f"K3-K6's build logs name {len(k3_k6)} "
          "instances, not 48 (K3: 7 widths x 4 chains a block, K5: 5, K4: "
          "10, K6: 5)")
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
    cases = [(v, p) for v in K1_WIDTHS for p in K1_PRECISIONS]
    for v, p in cases + list(K1_LEVEL_CASES):
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
               "launch": mrf_gibbs.lanes_launch(mrf, 1, CHAINS, spec.size),
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


RANK_MESH = (2, 4)  # gloo ranks sharing the card
RANK_TIMEOUT_S = 600
NCCL_MAX_RANKS = 4


def _rank_jobs(torch) -> list[dict]:
    """The serve_ranks runs, as data a rank rebuilds its programs from:
    one pigs and one hailfinder query of `serve`, Penguin, asia with
    diagnostics, and the pigs query sliced at sweep 100."""
    from repro_torch.core.graphs import bn_repository_replica

    def query(model, seed):
        _, ev, key = _queries(model, 1, seed,
                              bn_repository_replica(model).cards)[0]
        return {"model": model, "evidence": ev, "seed": key}

    bn_kw = dict(n_chains=CHAINS, n_iters=ITERS, burn_in=BURN_IN,
                 sampler="lut_ky", backend="schedule", fused=True)
    pigs = query("pigs", 11)
    return [
        {"name": "pigs", **pigs, "kw": bn_kw},
        {"name": "hailfinder", **query("hailfinder", 12), "kw": bn_kw},
        {"name": "penguin", "model": "penguin", "seed": 100,
         "kw": dict(n_chains=CHAINS, n_iters=ITERS, sampler="lut_ky",
                    backend="schedule", fused=True)},
        {"name": "asia_diagnostics", "model": "asia",
         "evidence": {0: 1, 5: 0}, "seed": 4,
         "kw": {**bn_kw, "diagnostics": True}},
        {"name": "pigs_sliced", **pigs, "kw": bn_kw, "slice": ITERS // 2},
    ]


def _rank_program(torch, job: dict, dev):
    """(program, MRF evidence image or None) of a serve_ranks job."""
    from repro_torch.compile import ir
    from repro_torch.compile.program import compile_graph
    from repro_torch.core.graphs import bn_repository_replica

    if job["model"] in MRF_MODELS:
        mrf, _, ev = _mrf_model(torch, job["model"])
        return compile_graph(ir.canonicalize(mrf, evidence_mode="runtime"),
                             device=dev), ev.to(dev)
    return compile_graph(bn_repository_replica(job["model"]),
                         job["evidence"], device=dev), None


def _run_job(job: dict, prog, ev, mesh):
    """Serve `job` on `mesh` (`run_sharded`), or on one device with mesh
    None (`run`); a sliced job runs its halves through the carry."""
    from repro_torch import prng

    kw = dict(job["kw"])
    if ev is not None:
        kw["evidence"] = ev
    if mesh is None:
        def run(key, **a):
            return prog.run(key, device=prog.device, **a)
    else:
        def run(key, **a):
            return prog.run_sharded(key, mesh, **a)
    key = prng.key(job["seed"])
    if "slice" not in job:
        return run(key, **kw)
    first = {**kw, "n_iters": job["slice"]}
    *_, state = run(key, return_state=True, **first)
    return run(None, carry_state=state,
               **{**kw, "n_iters": kw["n_iters"] - job["slice"]})


def _same(a, b) -> bool:
    """Bit-equal results: tensors (on any device), numpy arrays (NaN
    equal to NaN), snapshots field for field, tuples element by
    element."""
    import dataclasses

    import numpy as np

    if hasattr(a, "detach"):
        return (hasattr(b, "detach") and a.dtype == b.dtype
                and a.shape == b.shape
                and bool((a.detach().cpu() == b.detach().cpu()).all()))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(
            _same(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (a != a and b != b)
    return a == b


def rank_serve(rank, device_mesh, jobs, time_kernels) -> dict:
    """One rank of serve_ranks (`launch.mesh.spawn` runs it): the jobs on
    this rank's position, counters zeroed before and read after, each
    run's wall and collectives; then, with `time_kernels`, K5 and K6 alone
    at this rank's shapes while the other ranks wait."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = distributed.RankMesh(device_mesh, dev)
    progs = [_rank_program(torch, job, dev) for job in jobs]
    for prog, _ in progs:  # first-use checks, outside the counted runs
        prog.ensure_fused_cross_check("lut_ky", sharded=True)
    out = {"rank": rank, "coords": mesh.coords, "runs": {}, "rounds": {}}
    zero_launches()
    for job, (prog, ev) in zip(jobs, progs):
        dist.barrier()
        torch.cuda.synchronize()
        c0, s0, t0 = mesh.collectives, mesh.collective_s, time.perf_counter()
        res = _run_job(job, prog, ev, mesh)
        torch.cuda.synchronize()
        out["runs"][job["name"]] = {
            "result": res, "wall_ms": (time.perf_counter() - t0) * 1e3,
            "collectives": mesh.collectives - c0,
            "collective_ms": (mesh.collective_s - s0) * 1e3}
        if prog.kind == "bn":
            out["rounds"][job["name"]] = len(
                prog.schedule_executable().round_groups)
    out["launches"] = read_launches()
    dist.barrier()
    if time_kernels and rank == 0:
        out["kernel_ms"] = _rank_kernel_ms(torch, jobs, progs, mesh)
    dist.barrier()
    return out


def _rank_kernel_ms(torch, jobs, progs, mesh) -> dict:
    """K5 over rank 0's position of pigs (its chain block, node position
    0, round 0) and K6 over its Penguin block, each alone on the card: ms
    a launch (CUDA events, 20 launches)."""
    from repro_torch import prng
    from repro_torch.core import bayesnet as bnet
    from repro_torch.core import distributed
    from repro_torch.core.interp import build_exp_weight_lut
    from repro_torch.kernels import bn_gibbs, mrf_gibbs

    names = [j["name"] for j in jobs]
    prog, _ = progs[names.index("pigs")]
    cbn = prog.cbn
    sfr = distributed.build_sharded_fused_rounds(
        cbn, prog.schedule_executable().round_groups,
        mesh.axis_size("model"), prog.placement)
    p = bn_gibbs.sweep_params(cbn, "lut_ky")
    b_loc = CHAINS // mesh.axis_size("data")
    vals, _ = bnet.init_chain_values(cbn, prng.key(1), CHAINS)
    blk = vals[:b_loc].contiguous()
    k5 = time_ms(torch, lambda: bn_gibbs.fused_color_round(
        cbn, sfr, 0, 0, blk, prng.key(2), 0, "lut_ky", p), 20)
    prog, ev = progs[names.index("penguin")]
    mrf = prog.mrf
    h_loc = mrf.height // mesh.axis_size("model")
    lab = torch.randint(0, mrf.n_labels, (b_loc, h_loc, mrf.width),
                        dtype=torch.int32, device=mesh.device)
    halo = torch.full((1, b_loc, mrf.width), -1, dtype=torch.int32,
                      device=mesh.device)
    table, spec = build_exp_weight_lut(device=mesh.device)
    pm = mrf_gibbs.half_step_params(mrf)
    k6 = time_ms(torch, lambda: mrf_gibbs.mrf_halo_half_step(
        mrf, lab, halo, halo, 0, ev[:h_loc], prng.key(3), 0, table, spec,
        pm, 0), 20)
    return {"fused_color_round": k5, "mrf_halo_half_step": k6}


def phase_serve_ranks(torch) -> None:
    """The sampler's mesh over processes: 8 gloo ranks sharing the card as
    a (2, 4) mesh, then an NCCL world of one rank a card, each held bit
    for bit against the single-process mesh and `run(fused=True)`."""
    from repro_torch.core import distributed
    from repro_torch.kernels import _lib
    from repro_torch.launch import mesh as mesh_mod

    _lib.build()  # the ranks load the libraries; none of them builds one
    card = nvidia_smi()
    dev = torch.device(DEVICE)
    jobs = _rank_jobs(torch)
    ranks = mesh_mod.spawn(rank_serve, RANK_MESH[0] * RANK_MESH[1],
                           backend="gloo", device="cuda",
                           timeout_s=RANK_TIMEOUT_S, mesh_shape=RANK_MESH,
                           args=(jobs, True))
    single = distributed.make_mesh(RANK_MESH, ("data", "model"), dev)
    for job in jobs:
        prog, ev = _rank_program(torch, job, dev)
        ref = _run_job(job, prog, ev, single)
        one = _run_job(job, prog, ev, None)
        check(_same(ref, one), f"serve_ranks {job['name']}: the "
              "single-process mesh differs from run(fused=True)")
        for r in ranks:
            check(_same(r["runs"][job["name"]]["result"], ref),
                  f"serve_ranks {job['name']}: rank {r['rank']} differs "
                  "from the single-process (2, 4) mesh")
    rounds = ranks[0]["rounds"]
    # one K5 launch a round a rank, two K6 launches an iteration a rank
    want_launches = {name: 0 for name in ranks[0]["launches"]}
    want_launches["fused_color_round"] = ITERS * sum(rounds.values())
    want_launches["mrf_halo_half_step"] = 2 * ITERS
    for r in ranks:
        check(r["launches"] == want_launches, f"serve_ranks: rank "
              f"{r['rank']} launched {r['launches']}, expected "
              f"{want_launches}")
    k_ms = ranks[0]["kernel_ms"]
    for job in jobs:
        runs = [r["runs"][job["name"]] for r in ranks]
        run0 = runs[0]
        kernel = ("mrf_halo_half_step" if job["model"] in MRF_MODELS
                  else "fused_color_round")
        launches = (2 * ITERS if kernel == "mrf_halo_half_step"
                    else ITERS * rounds[job["name"]])
        kernel_ms = launches * k_ms[kernel]
        emit({"phase": "serve_ranks", "run": job["name"], "backend": "gloo",
              "mesh": list(RANK_MESH), "ranks": len(ranks),
              "chains": CHAINS, "iters": ITERS, "card": card,
              "wall_ms_rank0": run0["wall_ms"],
              "wall_ms_ranks_max": max(x["wall_ms"] for x in runs),
              "kernel": kernel, "launches_rank0": launches,
              "kernel_ms_a_launch_alone": k_ms[kernel],
              "kernel_ms_rank0": kernel_ms,
              "collectives_rank0": run0["collectives"],
              "collective_ms_rank0": run0["collective_ms"],
              "collective_ms_a_round": run0["collective_ms"] / max(
                  launches, 1),
              "host_ms_rank0": run0["wall_ms"] - kernel_ms
              - run0["collective_ms"],
              "equals_single_process_mesh": True, "equals_run": True})
    emit({"phase": "serve_ranks_checks", "ranks": len(ranks),
          "coords": [list(r["coords"]) for r in ranks],
          "launches_per_rank": want_launches, "bit_equal_runs":
          [j["name"] for j in jobs], "card": card})

    # NCCL: one rank a card, as a (1, n) mesh
    n = min(torch.cuda.device_count(), NCCL_MAX_RANKS)
    nccl_jobs = [j for j in jobs if j["name"] in ("pigs", "penguin")]
    ranks = mesh_mod.spawn(rank_serve, n, backend="nccl", device="cuda",
                           timeout_s=RANK_TIMEOUT_S, mesh_shape=(1, n),
                           args=(nccl_jobs, False))
    single = distributed.make_mesh((1, n), ("data", "model"), dev)
    for job in nccl_jobs:
        prog, ev = _rank_program(torch, job, dev)
        ref = _run_job(job, prog, ev, single)
        check(_same(ref, _run_job(job, prog, ev, None)),
              f"serve_ranks nccl {job['name']}: the single-process mesh "
              "differs from run(fused=True)")
        for r in ranks:
            check(_same(r["runs"][job["name"]]["result"], ref),
                  f"serve_ranks nccl {job['name']}: rank {r['rank']} "
                  "differs from the single-process mesh")
        run0 = ranks[0]["runs"][job["name"]]
        emit({"phase": "serve_ranks", "run": job["name"], "backend": "nccl",
              "mesh": [1, n], "ranks": n, "chains": CHAINS, "iters": ITERS,
              "card": card, "wall_ms_rank0": run0["wall_ms"],
              "collectives_rank0": run0["collectives"],
              "collective_ms_rank0": run0["collective_ms"],
              "collective_ms_a_round": run0["collective_ms"] / (
                  2 * ITERS if job["model"] in MRF_MODELS
                  else ITERS * ranks[0]["rounds"][job["name"]]),
              "launches_rank0": ranks[0]["launches"],
              "equals_single_process_mesh": True, "equals_run": True})


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
    k5 = sum(ms for name, ms in rows if K5_KERNEL in name)
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
    k3 = sum(ms for name, ms in rows if K3_KERNEL in name)
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
                 lanes_err: dict, counts: dict, lm_rows: list):
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
    ms = device_ms(torch, k3, 50, K3_KERNEL)
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
    rows.extend(lm_rows)
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
            "ms": device_ms(torch, k4, 50, K4_KERNEL),
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
    ms = device_ms(torch, k5_sweep, 20, K5_KERNEL, launches=n)
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
    ms = device_ms(torch, k6, 50, K6_KERNEL)
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
    bn["device_k5_ms"] = device_ms(torch, k5, 200, K5_KERNEL)
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
    m["device_k6_ms"] = device_ms(torch, k6, 200, K6_KERNEL)
    emit({"phase": "timing_sharded_mrf_half_step", "model": "penguin",
          "mesh": list(MESH), "chains": CHAINS, **m})


# ---------------------------------------------------------------------------
# the serving runtime: K3's and K4's lane entries, and a bucket per launch
# ---------------------------------------------------------------------------

LANES_Q = 3  # queries of the lane-entry checks
# chains a query in the K3 lane check on pigs: no multiple of the lane
# kernel's chains a block (32, 16, 8 or 4), so each query ends in a
# partial block
LANES_PARTIAL = 1000
WALL_REPS = 5  # timed runs of each runtime bucket and standalone query
RUNTIME_SLICE = 100  # the runtime phase's slice_iters
RUNTIME_SEED = 17


def phase_lanes(torch) -> dict:
    """K3's lane entry (`bn_sweep_lanes`) on pigs and K4's
    (`mrf_half_step_lanes`) on Penguin and Art, LANES_Q queries each, and
    K3's on hailfinder at the runtime bucket's 2 queries of 1,024 chains,
    against their twins (bit-equal, lut_ky) and against the one-query
    kernels run query by query with the same keys (bit-equal, exact_ky
    included).  `timing_lanes` holds the runtime's other bucket shapes
    (pigs at 8 queries, Penguin at 2) against the twins.  K3's blocks hold
    `chains_per_warp` chains of one query; pigs runs at LANES_PARTIAL
    chains a query, no multiple of it, so every query's last block is
    partial (checked)."""
    from repro_torch import prng
    from repro_torch.core import bayesnet as bnet
    from repro_torch.core import mrf as mrf_mod
    from repro_torch.core.graphs import bn_repository_replica
    from repro_torch.kernels import bn_gibbs, mrf_gibbs

    dev = torch.device(DEVICE)
    errs = {"k3": 0}
    # pigs at LANES_Q, whose queries end in partial blocks, and the
    # runtime's hailfinder bucket (2 queries) at its own shape
    for name, q, b, seed in (("pigs", LANES_Q, LANES_PARTIAL, 20),
                             ("hailfinder", 2, CHAINS, 90)):
        cbn = bnet.compile_bayesnet(bn_repository_replica(name), device=dev)
        fr = bn_gibbs.build_fused_rounds(cbn.groups)
        vals = torch.cat([bnet.init_chain_values(cbn, prng.key(seed + i),
                                                 b)[0]
                          for i in range(q)])
        keys = [prng.key(seed + 10 + i) for i in range(q - 1)] + [
            prng.Key(0xFFFFFFFF, 0x89ABCDEF)]
        kt = prng.key_tensor(keys, dev)
        ln = bn_gibbs.lanes_launch(cbn, fr, q, b)
        cpw = ln["chains_per_warp"]
        if name == "pigs":
            check(b % cpw != 0, f"{cpw} chains per block divide {b}: no "
                  "partial block to check")
        out = {"phase": "k3_lanes", "model": name, "queries": q,
               "chains": b, "chains_per_block": cpw,
               "partial_block_chains": b % cpw, "launch": ln}
        for sampler in ("lut_ky", "exact_ky"):
            p = bn_gibbs.sweep_params(cbn, sampler)
            got = bn_gibbs.bn_sweep_lanes(cbn, fr, vals, kt, sampler, p)
            one = torch.cat([
                bn_gibbs.bn_sweep(cbn, fr, vals[i * b:(i + 1) * b], k,
                                  sampler, p) for i, k in enumerate(keys)])
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


# ---------------------------------------------------------------------------
# LM serving: yi-9b, qwen2-moe-a2.7b and xlstm-350m at full width, jamba
# at reduced(); the KY token sampler on K2 and K1; one Mamba mixer at
# jamba's full widths
# ---------------------------------------------------------------------------

LM_ARCH = "yi-9b"  # the widest dense config one H100 holds in bf16
LM_MOE_ARCH = "qwen2-moe-a2.7b"  # 14.3 B parameters, 28.6 GB in bf16
LM_XLSTM_ARCH = "xlstm-350m"  # mLSTM:sLSTM 3:1, 0.23 B parameters
# Mamba + attention + MoE on every other layer; 398.6 B parameters do not
# fit one card, so it serves at reduced() (nothing sharded yet)
LM_HYBRID_ARCH = "jamba-1.5-large-398b"
LM_BATCH, LM_PROMPT, LM_GEN = 8, 128, 16
# tokens the one-card serving phases generate (printed with each phase's
# cut), cut from 32 when train_lm_mesh came to train three models and the
# examples joined: a whole run passed 1,100 s
LM_GEN_CUT = "32 -> 16"
# the one-card serving phases' depth, full widths (printed), cut to keep
# chip_smoke within its time with the LM mesh's phases (a whole run took
# up to 1,187 s of its 1,200 with qwen2-moe-a2.7b's 24 layers, and 1,130 s
# with yi-9b 16, qwen2-moe 12 and xlstm-350m 8 once the mesh served four
# models); the serve CLIs of yi-9b and xlstm-350m still run the whole
# stacks
LM_SERVE_LAYERS = {"yi-9b": 8, "qwen2-moe-a2.7b": 6, "xlstm-350m": 4}
LM_SEED = 0
# decode against forward, bf16: at most 5% of the largest |logit|, the
# reference's own bound for two execution orders (0.15 on its logits of
# ~3, tests/test_models_smoke.py), taken relative to the logits' scale
LM_FORWARD_RTOL = 0.05
# xlstm-350m's exponential gates amplify bf16 rounding: on the CPU at
# full width (8 seeds of 8 rows of random tokens, prefill 128, decode to
# position 158; tests/test_torch_lm_decode_gap.py) the reference's own
# decode against its forward reaches 7.6% of the largest |logit|, the
# port's 6.1% on the same weights and tokens.  Its limit is 10%: above
# every reading of either, below the 10.4% the card read while cuBLAS
# reduced bf16 partial sums in bf16 (tools/lm_bf16.py gap;
# layers.accumulate_in_float32)
LM_FORWARD_RTOL_BY_ARCH = {"xlstm-350m": 0.10}
# decode against forward for models with recurrent mixers, also on a
# float32 copy of the model: at most 1e-3 of the largest |logit| (xlstm
# reduced, 24 layers, on the CPU: 6.6e-6)
LM_FORWARD_RTOL_F32 = 1e-3
LM_REPS = 5  # timed calls of each part, medians
BF16_FLOPS = 989e12  # H100 SXM, dense tensor cores
ATTN_KINDS = ("attn", "attn_chunked")
# one Mamba mixer at jamba's widths (d 8,192, d_inner 16,384, 16 states,
# dt rank 512, conv 4), float32 on the card (TF32 off) against the CPU:
# 8 rows, a prefill of 128 positions, then 8 decode steps
MAMBA_BATCH, MAMBA_PROMPT, MAMBA_STEPS = 8, 128, 8
# float32, two devices' summation orders over 8,192- and 16,384-long dot
# products: at most 1e-3 of the output's largest |value|
MAMBA_RTOL = 1e-3
# one MoE FFN at qwen2-moe's widths, float32 on the card (TF32 off)
# against the CPU: a prefill row of 128 tokens and a decode group of 8,
# leaning towards experts 0 and 1: the inputs gain a vector along the
# sum of their router columns that raises expert 0's logit by MOE_LEAN
# standard deviations of a logit, so that most tokens pick both
MOE_PROMPT, MOE_GROUP, MOE_LEAN = 128, 8, 3.0
MOE_RTOL = 1e-4


def _layers_of(cfg, kinds) -> int:
    return cfg.n_super * sum(k in kinds for k in cfg.pattern)


def lm_matmul_params(cfg) -> int:
    """Weights every token multiplies: the mixers' projections (attention
    q, k, v and o; Mamba's in, x, dt and out projections; mLSTM's q, k, v,
    gates, output gate and out; sLSTM's input, recurrent r and out), the
    dense FFNs, and of an MoE FFN the router and the shared expert.  The
    routed experts (`lm_expert_macs`), the head and the embedding table
    apart."""
    d, hd, h = cfg.d_model, cfg.hd, cfg.n_heads
    total = 0
    for slot, kind in enumerate(cfg.pattern):
        if kind in ATTN_KINDS:
            mix = d * hd * (2 * h + 2 * cfg.n_kv_heads)
        elif kind == "mamba":
            di, n, r = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
            mix = d * 2 * di + di * (r + 2 * n) + r * di + di * d
        elif kind == "mlstm":
            mix = 3 * d * h * hd + 2 * d * h + 2 * d * d
        else:  # slstm
            mix = 4 * d * h * hd + 4 * h * hd * hd + d * d
        moe = cfg.moe_for(slot)
        ffn = (3 * d * cfg.d_ff if moe is None
               else d * moe.n_experts + 3 * d * moe.d_shared)
        total += cfg.n_super * (mix + ffn)
    return total


def lm_expert_macs(cfg, batch: int, seq: int) -> int:
    """Multiply-adds of the routed experts over a step of `batch` rows of
    `seq` tokens: every expert's SwiGLU over all C of its slots, empty
    ones included, as the dispatch computes them; a group a row, or the
    whole batch one group in a decode step over several rows."""
    from repro_torch.models import moe as moe_mod

    groups, tokens = (1, batch) if seq == 1 and batch > 1 else (batch, seq)
    total = 0
    for slot in range(len(cfg.pattern)):
        moe = cfg.moe_for(slot)
        if moe is not None:
            total += (cfg.n_super * groups * moe.n_experts
                      * moe_mod.capacity(tokens, moe)
                      * 3 * cfg.d_model * moe.d_expert)
    return total


def lm_recurrent_flops(cfg, batch: int, seq: int) -> float:
    """Operations of the recurrent mixers outside their projections over a
    step of `batch` rows of `seq` tokens: Mamba's scan (6 a state element
    a token), mLSTM's matrix memory (4 H hd^2 a token: the rank-1 update
    and the read) and, in a prefill, its chunks' causal pairs (6 H hd a
    pair: q.k, the decayed sum of v and of k)."""
    from repro_torch.models import xlstm

    tokens = batch * seq
    n_mlstm = _layers_of(cfg, ("mlstm",))
    ops = 6.0 * cfg.d_inner * cfg.ssm_state * _layers_of(
        cfg, ("mamba",)) * tokens
    ops += 4.0 * cfg.n_heads * cfg.hd ** 2 * n_mlstm * tokens
    if seq > 1 and n_mlstm:
        lc = xlstm.chunk_len(seq)
        pairs = seq // lc * (lc * (lc + 1) // 2)
        ops += 6.0 * cfg.n_heads * cfg.hd * n_mlstm * pairs * batch
    return ops


def lm_attention_flops(cfg, batch: int, pairs: int) -> float:
    """The two attention products (q.k and p.v, 2 x hd operations each)
    over `pairs` (query, key) pairs per head, every attention layer, every
    row."""
    return (4.0 * cfg.hd * cfg.n_heads * _layers_of(cfg, ATTN_KINDS) * pairs
            * batch)


def lm_prefill_flops(cfg, batch: int, seq: int) -> float:
    """Operations a prefill's outputs need: every token through the layers'
    projections and routed experts' slots, the causal attention (a query
    reads its own and earlier keys), the recurrent mixers, and the head at
    the last position only (the one logit row the step returns)."""
    return (2.0 * lm_matmul_params(cfg) * batch * seq
            + 2.0 * lm_expert_macs(cfg, batch, seq)
            + lm_attention_flops(cfg, batch, seq * (seq + 1) // 2)
            + lm_recurrent_flops(cfg, batch, seq)
            + 2.0 * cfg.d_model * cfg.vocab * batch)


def lm_decode_flops(cfg, batch: int, n_keys: int) -> float:
    """Operations of one decode step: one token per row through the
    projections, the expert slots and the head, attending over `n_keys`
    keys, and one step of the recurrent mixers."""
    return (2.0 * (lm_matmul_params(cfg) + cfg.d_model * cfg.vocab) * batch
            + 2.0 * lm_expert_macs(cfg, batch, 1)
            + lm_attention_flops(cfg, batch, n_keys)
            + lm_recurrent_flops(cfg, batch, 1))


def lm_step_bytes(weight_bytes: int, embed_bytes: int, cfg, tokens: int,
                  kv_read: int, kv_written: int, logit_rows: int) -> int:
    """Bytes a prefill or decode step must move: every weight but the
    embedding table read once (of the table only the tokens' bf16 rows;
    an MoE step reads every expert, since the dispatch multiplies every
    expert's slots), the caches (K/V and recurrent states) read and
    written, the float32 logit rows written."""
    return (weight_bytes - embed_bytes + 2 * tokens * cfg.d_model + kv_read
            + kv_written + 4 * logit_rows * cfg.vocab)


def token_levels(vocab: int) -> int:
    """The token sampler's tree levels over `vocab`: K1 launches a token."""
    from repro_torch.models import sampling

    levels, width = 1, -(-vocab // sampling.BRANCH) * sampling.BRANCH
    while width > sampling.BRANCH:
        width = -(-(width // sampling.BRANCH) // sampling.BRANCH) \
            * sampling.BRANCH
        levels += 1
    return levels


def event_ms(torch, fn) -> tuple[float, object]:
    """(ms, fn()) of one call with an empty queue before it: CUDA events
    around the call, so the time counts the host's launches and the
    card's work."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def _serve_cli(arch: str, phase: str) -> None:
    """The serve CLI in a subprocess at the phase's shape; must exit 0."""
    import os

    cmd = ["repro_torch.launch.serve", "--arch", arch, "--batch",
           str(LM_BATCH), "--prompt-len", str(LM_PROMPT), "--gen",
           str(LM_GEN), "--sampler", "ky"]
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", *cmd], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=600)
    emit({"phase": f"{phase}_cli", "cmd": "python -m " + " ".join(cmd),
          "rc": out.returncode, "s": time.perf_counter() - t0,
          "tail": out.stdout.splitlines()[-2:]})
    check(out.returncode == 0, f"the serve CLI exited {out.returncode}: "
          f"{out.stdout[-2000:]} {out.stderr[-2000:]}")


def _free(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_lm(torch, per_call: dict) -> list:
    """LM serving at yi-9b's full width, depth cut; returns the token-level
    K1 and K2 rows of the kernels line.  The model is freed before the
    serve CLI (the whole stack) runs in a subprocess."""
    _free(torch)
    rows = _serve_lm(torch, per_call, _serve_cut(LM_ARCH, "serve_lm"),
                     "serve_lm")
    _free(torch)
    _serve_cli(LM_ARCH, "serve_lm")
    return rows


def _serve_cut(arch: str, phase: str):
    """`arch` at full width, its depth cut to LM_SERVE_LAYERS (printed)."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config(arch)
    emit({"phase": f"{phase}_cut", "arch": arch, "widths": "full",
          "layers": f"{LM_SERVE_LAYERS[arch]} of {full.n_layers}",
          "gen": LM_GEN, "gen_cut": LM_GEN_CUT})
    return dataclasses.replace(full, n_layers=LM_SERVE_LAYERS[arch])


def phase_serve_lm_moe(torch, per_call: dict) -> list:
    """qwen2-moe-a2.7b at full width (60 experts top-4, shared 5,632),
    depth cut."""
    _free(torch)
    rows = _serve_lm(torch, per_call,
                     _serve_cut(LM_MOE_ARCH, "serve_lm_moe"),
                     "serve_lm_moe")
    _free(torch)
    return rows


def phase_serve_lm_xlstm(torch, per_call: dict) -> list:
    """xlstm-350m at full width, depth cut, then its serve CLI (the whole
    stack) in a subprocess."""
    _free(torch)
    rows = _serve_lm(torch, per_call,
                     _serve_cut(LM_XLSTM_ARCH, "serve_lm_xlstm"),
                     "serve_lm_xlstm")
    _free(torch)
    _serve_cli(LM_XLSTM_ARCH, "serve_lm_xlstm")
    return rows


def phase_serve_lm_hybrid(torch, per_call: dict) -> list:
    """jamba-1.5-large-398b at reduced(): Mamba, attention and MoE."""
    from repro_torch.configs import get_config

    _free(torch)
    emit({"phase": "serve_lm_hybrid_cut", "arch": LM_HYBRID_ARCH,
          "widths": "reduced()", "gen": LM_GEN, "gen_cut": LM_GEN_CUT})
    rows = _serve_lm(torch, per_call, get_config(LM_HYBRID_ARCH).reduced(),
                     "serve_lm_hybrid")
    _free(torch)
    return rows


def moe_row_drops(torch, moe_mod, x, router, moe):
    """(B,) the assignments `moe_apply` drops at capacity for x (B, S, d),
    per batch row: `route` over the groups it routes, each dropped
    assignment counted at its token's row."""
    g = moe_mod.groups(x)
    r = moe_mod.route(g, router, moe)
    d = torch.zeros(g.shape[:2], dtype=torch.int64, device=x.device)
    d.scatter_add_(1, r.stok, (~r.keep).long())
    return (d.transpose(0, 1) if g is not x else d).sum(-1)


def _drops(torch, moe_mod, fn):
    """(fn(), the assignments its MoE FFNs dropped at capacity per row
    (list)), counted by a wrapper of `moe_apply` installed for the call."""
    dropped = torch.zeros(LM_BATCH, dtype=torch.int64, device=DEVICE)
    orig = moe_mod.moe_apply

    def counted(p, x, cfg, moe):
        dropped.add_(moe_row_drops(torch, moe_mod, x, p["router"], moe))
        return orig(p, x, cfg, moe)

    moe_mod.moe_apply = counted
    try:
        return fn(), dropped.tolist()
    finally:
        moe_mod.moe_apply = orig


def _serve_lm(torch, per_call: dict, cfg, phase: str) -> list:
    from repro_torch import prng
    from repro_torch.core.interp import build_exp_weight_lut
    from repro_torch.launch import serve, steps
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import sampling
    from repro_torch.models import transformer as tfm

    dev = torch.device(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tfm.init_model(cfg, seed=LM_SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    g = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                            generator=g, device=dev, dtype=torch.int32)
    key = prng.key(LM_SEED)
    serve.generate(cfg, model, prompts, 2, sampler="ky", key=key)  # warm-up

    # ---- the main path: counters zeroed, a batch served, counters read ----
    zero_launches()
    c0 = prng._raw_bits.calls
    toks, times = serve.generate(cfg, model, prompts, LM_GEN, sampler="ky",
                                 key=key)
    torch.cuda.synchronize()
    launches = read_launches()
    raw_calls = prng._raw_bits.calls - c0
    # ---- end of the main path ----------------------------------------------
    peak = torch.cuda.max_memory_allocated()

    n_levels = token_levels(cfg.vocab)
    check(tuple(toks.shape) == (LM_BATCH, LM_PROMPT + LM_GEN),
          f"{phase}: generate gave {tuple(toks.shape)} tokens")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"{phase}: a token lies outside the vocabulary")
    check(torch.equal(toks[:, :LM_PROMPT], prompts),
          f"{phase}: the prompt moved")
    check(launches["ky_sample_kernel"] == n_levels * LM_GEN
          and launches["interp_kernel"] == LM_GEN,
          f"{phase}: {LM_GEN} tokens launched K1 "
          f"{launches['ky_sample_kernel']} and K2 "
          f"{launches['interp_kernel']} times, not {n_levels} and 1 each")
    check(all(n == 0 for name, n in launches.items()
              if name not in ("ky_sample_kernel", "interp_kernel")),
          f"{phase}: the LM path launched another kernel: {launches}")
    check(raw_calls == 0, f"{phase}: the token sampler called "
          f"prng._raw_bits {raw_calls} times: words were made outside K1")

    # ---- every step's tokens against the twin on the same logits, and the
    # MoE assignments each step dropped at capacity, per row ---------------
    tab, spec = build_exp_weight_lut(device=dev)
    tab_cpu, spec_cpu = build_exp_weight_lut(device="cpu")
    batch = {"tokens": prompts}
    (logits, caches), drop_prefill = _drops(
        torch, moe_mod, lambda: steps.make_prefill_step(cfg)(model, batch))
    caches = tfm.grow_attn_caches(caches, cfg, LM_GEN)
    step = steps.make_serve_step(cfg, sampler="ky", exp_table=tab,
                                 exp_spec=spec)
    k = key
    tok = sampling.ky_token_sample(logits, k, exp_table=tab, exp_spec=spec)
    step_logits, twin_bad = [logits], 0
    twin_bad += int((tok.cpu() != sampling.ky_token_sample(
        logits.cpu(), k, exp_table=tab_cpu, exp_spec=spec_cpu)).sum())
    mine, drop_steps = [tok], []
    for t in range(LM_GEN - 1):
        k, sub = prng.split(k)
        (tok, logits, caches), dropped = _drops(
            torch, moe_mod, lambda: step(model, tok[:, None], caches,
                                         LM_PROMPT + t, sub))
        drop_steps.append(dropped)
        twin = sampling.ky_token_sample(logits.cpu(), sub,
                                        exp_table=tab_cpu, exp_spec=spec_cpu)
        twin_bad += int((tok.cpu() != twin).sum())
        mine.append(tok)
        step_logits.append(logits)
    mine = torch.stack(mine, dim=1)
    check(twin_bad == 0, f"{phase}: {twin_bad} of {LM_BATCH * LM_GEN} "
          f"tokens differ from the twin's draw on the same logits and keys")
    check(torch.equal(mine, toks[:, LM_PROMPT:]),
          f"{phase}: the steps run again gave other tokens than generate")

    # ---- the last decode step against a full forward ----------------------
    # all 160 tokens (the KV loop's chunks divide 160; 159 would take
    # chunks of one): position 158's logits see tokens 0..158 only.  With
    # MoE FFNs, a row's forward and decode differ by design wherever either
    # dropped an assignment (a 160-token row and a decode group of 8 have
    # other capacities): such rows are not held
    (full, _), drop_fwd = _drops(
        torch, moe_mod, lambda: tfm.forward(model, cfg, {"tokens": toks}))
    fwd = full[:, -2]
    del full
    dropped_any = [drop_prefill[b] + sum(s[b] for s in drop_steps)
                   + drop_fwd[b] for b in range(LM_BATCH)]
    held = [b for b in range(LM_BATCH) if dropped_any[b] == 0]
    check(bool(torch.isfinite(fwd).all()),
          f"{phase}: forward logits are not finite")
    scale = float(fwd.abs().max())
    err = float((step_logits[-1][held] - fwd[held]).abs().max()) \
        if held else None
    same_argmax = float((step_logits[-1].argmax(-1) == fwd.argmax(-1))
                        .float().mean())
    rtol = LM_FORWARD_RTOL_BY_ARCH.get(cfg.name, LM_FORWARD_RTOL)
    check(err is None or err <= rtol * scale,
          f"{phase}: decode differs from forward by {err} (largest |logit| "
          f"{scale}, limit {rtol} of it)")
    recurrent = any(k not in ATTN_KINDS for k in cfg.pattern)
    f32 = _decode_vs_forward_f32(torch, cfg, toks) if recurrent else None
    check(f32 is None or f32["max_abs"] is None
          or f32["max_abs"] <= LM_FORWARD_RTOL_F32 * f32["scale"],
          f"{phase}: in float32 decode differs from forward by {f32}")

    # ---- greedy twice ------------------------------------------------------
    g1, _ = serve.generate(cfg, model, prompts, LM_GEN, sampler="greedy")
    g2, _ = serve.generate(cfg, model, prompts, LM_GEN, sampler="greedy")
    check(torch.equal(g1, g2), f"{phase}: greedy decoding run twice differs")

    emit({"phase": phase, "arch": cfg.name, "batch": LM_BATCH,
          "prompt_len": LM_PROMPT, "gen": LM_GEN,
          "params": sum(p.numel() for p in model.parameters()),
          "weight_bytes": weight_bytes, "init_s": init_s,
          "peak_bytes": peak, "launches": launches,
          "k1_launches_per_token": n_levels,
          "plain_torch_generator_calls": raw_calls,
          "tokens_vs_twin_mismatches": twin_bad,
          "moe_dropped_prefill": drop_prefill,
          "moe_dropped_decode_steps": drop_steps,
          "moe_dropped_forward": drop_fwd,
          "decode_vs_forward_rows_held": held,
          "decode_vs_forward_max_abs": err, "forward_max_abs_logit": scale,
          "decode_vs_forward_rtol": rtol,
          "decode_vs_forward_same_argmax": same_argmax,
          "decode_vs_forward_float32": f32,
          "greedy_twice_equal": True, "sample_row": toks[0, -16:].tolist()})

    return timing_serve_lm(torch, cfg, model, prompts, caches, times,
                           step_logits[-1], launches, per_call, weight_bytes,
                           (tab, spec), phase)


def _decode_vs_forward_f32(torch, cfg, toks) -> dict:
    """The served tokens teacher-forced through a float32 copy of the model
    (the same seed: the weights before their cast to bf16): a prefill of
    the prompt and decode steps to position 158 against a forward over
    all 160 tokens, on the rows that dropped no MoE assignment."""
    import dataclasses

    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = tfm.init_model(cfg32, seed=LM_SEED, device=torch.device(DEVICE))
    (_, caches), drops = _drops(torch, moe_mod, lambda: tfm.prefill(
        model, cfg32, {"tokens": toks[:, :LM_PROMPT]}))
    caches = tfm.grow_attn_caches(caches, cfg32, LM_GEN)
    for t in range(LM_GEN - 1):
        pos = LM_PROMPT + t
        (logits, caches), d = _drops(torch, moe_mod, lambda: tfm.decode_step(
            model, cfg32, toks[:, pos:pos + 1], caches, pos))
        drops = [a + b for a, b in zip(drops, d)]
    (full, _), d = _drops(torch, moe_mod, lambda: tfm.forward(
        model, cfg32, {"tokens": toks}))
    held = [b for b in range(LM_BATCH) if drops[b] + d[b] == 0]
    fwd = full[:, -2]
    err = float((logits[held] - fwd[held]).abs().max()) if held else None
    del model, caches, full
    _free(torch)
    return {"max_abs": err, "scale": float(fwd.abs().max()),
            "rows_held": held, "rtol": LM_FORWARD_RTOL_F32}


def _cache_bytes(cfg, caches) -> tuple[int, int, int]:
    """(all cache bytes, attention K/V bytes of one position over every
    attention layer, recurrent state bytes)."""
    nb = lambda t: t.numel() * t.element_size()
    total = sum(nb(t) for c in caches for t in c.values())
    attn = [c for i, c in enumerate(caches)
            if cfg.pattern[i % len(cfg.pattern)] in ATTN_KINDS]
    kv_row = sum(nb(c[n]) // c[n].shape[1] for c in attn for n in ("k", "v"))
    state = total - sum(nb(t) for c in attn for t in c.values())
    return total, kv_row, state


def timing_serve_lm(torch, cfg, model, prompts, caches, times, logits,
                    launches, per_call, weight_bytes, lut,
                    phase: str) -> list:
    """Prefill and decode on the card beside their bounds, the decode step
    split into the model and the token draw, K2 at (8, V) and K1 at
    (8, 128) beside theirs, and the whole draw beside `torch.multinomial`
    on the softmax.  Returns the token-level K1 and K2 rows."""
    from repro_torch import prng
    from repro_torch.core import ky as ky_core
    from repro_torch.kernels import interp_lut, ky_sampler, ops
    from repro_torch.launch import kernel_cost, steps
    from repro_torch.models import sampling
    from repro_torch.models import transformer as tfm

    dev = torch.device(DEVICE)
    tab, spec = lut
    med = statistics.median
    batch = {"tokens": prompts}
    prefill = steps.make_prefill_step(cfg)
    prefill_ms = med(event_ms(torch, lambda: prefill(model, batch))[0]
                     for _ in range(LM_REPS))
    pos = LM_PROMPT + LM_GEN - 2  # the last step's slot, rewritten alike
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    key = prng.key(1)
    step = steps.make_serve_step(cfg, sampler="ky", exp_table=tab,
                                 exp_spec=spec)
    step_ms = med(event_ms(torch, lambda: step(model, tok, caches, pos,
                                                key))[0]
                  for _ in range(LM_REPS))
    model_ms = med(event_ms(torch, lambda: tfm.decode_step(
        model, cfg, tok, caches, pos))[0] for _ in range(LM_REPS))
    draw = lambda: sampling.ky_token_sample(logits, key, exp_table=tab,
                                            exp_spec=spec)
    draw_ms = med(event_ms(torch, draw)[0] for _ in range(LM_REPS))
    g = torch.Generator(device=dev).manual_seed(3)
    multinomial = lambda: torch.multinomial(torch.softmax(logits, -1), 1,
                                            generator=g)
    multinomial_ms = med(event_ms(torch, multinomial)[0]
                         for _ in range(LM_REPS))
    step_busy = device_busy_ms(torch, lambda: step(model, tok, caches, pos,
                                                   key), LM_REPS)
    step_kernels = device_kernels_per_call(
        torch, lambda: step(model, tok, caches, pos, key), 2)
    draw_kernels = device_kernels_per_call(torch, lambda: sampling
                                           .ky_token_sample(
                                               logits, key, exp_table=tab,
                                               exp_spec=spec), 5)
    prefill_busy = device_busy_ms(torch, lambda: prefill(model, batch), 2)
    prefill_kernels = device_kernels_per_call(
        torch, lambda: prefill(model, batch), 1)
    model_busy = device_busy_ms(torch, lambda: tfm.decode_step(
        model, cfg, tok, caches, pos), LM_REPS)
    model_kernels = device_kernels_per_call(torch, lambda: tfm.decode_step(
        model, cfg, tok, caches, pos), 2)
    draw_busy = device_busy_ms(torch, draw, 20)
    draw_host = host_ms(torch, draw, 20)

    kv_bytes, kv_row, state_bytes = _cache_bytes(cfg, caches)
    embed_bytes = model["embed"].numel() * model["embed"].element_size()
    n_keys = pos + 1
    dec_bytes = lm_step_bytes(weight_bytes, embed_bytes, cfg, LM_BATCH,
                              kv_row * n_keys + state_bytes,
                              kv_row + state_bytes, LM_BATCH)
    dec_flops = lm_decode_flops(cfg, LM_BATCH, n_keys)
    dec_bound, dec_by = bound(dec_bytes, dec_flops, BF16_FLOPS)
    pre_bytes = lm_step_bytes(weight_bytes, embed_bytes, cfg,
                              LM_BATCH * LM_PROMPT, 0,
                              kv_row * LM_PROMPT + state_bytes, LM_BATCH)
    pre_flops = lm_prefill_flops(cfg, LM_BATCH, LM_PROMPT)
    pre_bound, pre_by = bound(pre_bytes, pre_flops, BF16_FLOPS)
    decode_ms = med(1e3 * s for s in times)
    emit({"phase": f"timing_{phase}", "arch": cfg.name,
          "card": nvidia_smi(),
          "prefill_ms": prefill_ms, "prefill_tokens": LM_BATCH * LM_PROMPT,
          "prefill_bound_ms": pre_bound, "prefill_bound_by": pre_by,
          "prefill_flops": pre_flops, "prefill_bytes": pre_bytes,
          "prefill_expert_macs": lm_expert_macs(cfg, LM_BATCH, LM_PROMPT),
          "prefill_busy_ms": prefill_busy,
          "prefill_busy_share": prefill_busy / prefill_ms,
          "prefill_kernels": prefill_kernels, "model_kernels": model_kernels,
          "decode_ms_per_token_median": decode_ms,
          "decode_ms_spread": spread([1e3 * s for s in times]),
          "decode_tokens_per_s": LM_BATCH / (decode_ms / 1e3),
          "decode_bound_ms": dec_bound, "decode_bound_by": dec_by,
          "decode_bytes": dec_bytes, "decode_flops": dec_flops,
          "decode_expert_macs": lm_expert_macs(cfg, LM_BATCH, 1),
          "kv_cache_bytes": kv_bytes, "recurrent_state_bytes": state_bytes,
          "serve_step_ms": step_ms, "serve_step_busy_ms": step_busy,
          "serve_step_kernels": step_kernels, "draw_kernels": draw_kernels,
          "serve_step_busy_share": step_busy / step_ms,
          "model_ms": model_ms, "model_busy_ms": model_busy,
          "model_busy_share": model_busy / model_ms,
          "draw_ms": draw_ms, "draw_busy_ms": draw_busy,
          "draw_host_ms": draw_host, "draw_busy_share": draw_busy / draw_ms,
          "multinomial_softmax_ms": multinomial_ms,
          "draw_over_multinomial": draw_ms / multinomial_ms})

    # K2 at the draw's shape: the last step's max-subtracted logits
    z = (logits - logits.amax(-1, keepdim=True)).contiguous().reshape(-1)
    k2 = lambda: interp_lut.interp_kernel(z, tab, spec)
    y_k, y_t = k2(), interp_lut.interp_kernel_ref(z, tab, spec)
    torch.cuda.synchronize()
    k2_bad = int((y_k.view(torch.int32) != y_t.view(torch.int32)).sum())
    check(k2_bad == 0, f"{phase}: K2 differs from its twin at the token "
          f"shape in {k2_bad} elements")
    cost = kernel_cost.lut_exp(z.numel(), tab.numel())
    k2_bound, k2_by = bound(cost.hbm_bytes, cost.flops)
    k2_events = time_ms(torch, k2, 200)
    k2_row = {
        "name": f"K2 interp_kernel (token draw, {cfg.name}, {LM_BATCH} x "
                f"{cfg.vocab:,})", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/interp_lut.cu",
        "replaces": "src/repro/kernels/interp_lut.py:50",
        "launches": launches["interp_kernel"],
        "max_abs_err": float((y_k - y_t).abs().max()),
        "ms": device_ms(torch, k2, 200, "interp_kernel") or k2_events,
        "plain_ms": time_ms(torch, lambda: interp_lut.interp_kernel_ref(
            z, tab, spec), 20),
        "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
        "ms_per_call_events": k2_events, "launches_per_token": 1,
    }

    # K1 at each tree level's shape (B, 128): the rows the last step's
    # draw reads, the levels walked root to leaf as `ky_token_sample` does
    levels = sampling.weight_pyramid(ops.lut_exp_weights(logits, tab, spec))
    level_rows, k1_row, idx = [], None, None
    for li in range(len(levels) - 1, -1, -1):
        wl = levels[li] if idx is None else sampling.take_row(levels[li],
                                                              idx)
        p = sampling.level_precision(li)
        kw = dict(n_bins=sampling.BRANCH, precision=p, max_retries=8)
        lkey = prng.key(20 + li)
        words = ky_core.random_words(lkey, (LM_BATCH,),
                                     ky_sampler.n_words_for(p, 8), dev)
        lab_t, st_t = ky_sampler.ky_sample_kernel_ref(wl, words, **kw)
        lab_k, st_k = ky_sampler.ky_sample_keyed(wl, lkey, **kw)
        bad = int((lab_k != lab_t).sum()) + sum(
            int((st_k[n] != st_t[n]).sum())
            for n in ("bits_used", "rejections", "fallback"))
        check(bad == 0, f"{phase}: K1 differs from its twin at tree level "
              f"{li} (precision {p}, 128 bins): {bad}")
        keyed = lambda: ky_sampler.ky_sample_keyed(wl, lkey, **kw)
        bits = st_t["bits_used"]
        calls = int(((bits.long() + 31) // 32).sum())
        ops_ = float(bits.sum()) * (4 * (sampling.BRANCH + 1) + 8)
        cost = kernel_cost.ky_sample_keyed(LM_BATCH, sampling.BRANCH)
        bms, by = bound(cost.hbm_bytes, ops_, FP32_FLOPS,
                        hash_ms(calls, per_call))
        wf = wl.float()
        library = lambda: torch.multinomial(wf, 1, generator=g)
        events = time_ms(torch, keyed, 200)
        row = {"level": li, "precision": p,
               "ms": device_ms(torch, keyed, 200, K1_KERNEL) or events,
               "ms_per_call_events": events, "bound_ms": bms,
               "bound_by": by, "walk_bits": int(bits.sum()),
               "threefry_calls": calls,
               "plain_ms": time_ms(torch, lambda: ky_sampler
                                   .ky_sample_kernel_ref(wl, words, **kw),
                                   5),
               "library_ms": device_busy_ms(torch, library, 200),
               "library_ms_per_call_events": time_ms(torch, library, 200),
               "max_abs_err": int((lab_k - lab_t).abs().max())}
        level_rows.append(row)
        idx = lab_t if idx is None else idx * sampling.BRANCH + lab_t
        if k1_row is None:  # the top level
            k1_row = {
                "name": f"K1 ky_sample_keyed (token draw, {cfg.name}, "
                        f"{LM_BATCH} x 128, p={p})", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/ky_sampler.cu",
                "replaces": "src/repro/kernels/ky_sampler.py:159",
                "launches": launches["ky_sample_kernel"],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": bms,
                "bound_by": by, "library_ms": row["library_ms"],
                "library": "torch.multinomial(weights.float(), 1)",
                "ms_per_call_events": events,
                "launches_per_token": len(levels)}
    emit({"phase": f"timing_{phase}_kernels", "k1_levels": level_rows,
          "k2": {n: k2_row[n] for n in ("ms", "ms_per_call_events",
                                        "bound_ms", "plain_ms")}})
    return [k1_row, k2_row]


def phase_mamba_block(torch) -> None:
    """One Mamba mixer at jamba's full widths in float32: 8 rows, a
    prefill of 128 positions and 8 decode steps on the card.  Decode step
    t equals a prefill over 129 + t positions at its last one, and the
    card's outputs and state equal the same module's on the CPU, each
    within MAMBA_RTOL of the output's scale; prefill and a decode step
    timed beside their bounds."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    _free(torch)
    cfg = dataclasses.replace(get_config(LM_HYBRID_ARCH), dtype="float32")
    dev = torch.device(DEVICE)
    p_cpu = ssm.init_mamba(torch.Generator().manual_seed(LM_SEED), cfg,
                           torch.device("cpu"))
    p = copy.deepcopy(p_cpu).to(dev)  # Module.to moves in place
    n_params = sum(t.numel() for t in p.parameters())
    g = torch.Generator().manual_seed(LM_SEED + 2)
    x_cpu = torch.randn((MAMBA_BATCH, MAMBA_PROMPT + MAMBA_STEPS,
                         cfg.d_model), generator=g)
    x = x_cpu.to(dev)
    pre = x[:, :MAMBA_PROMPT]
    y, state = ssm.mamba_apply(p, pre, cfg)
    st_prefill = {k: v.clone() for k, v in state.items()}  # decode writes
    whole, _ = ssm.mamba_apply(p, x, cfg)  # positions 128..135 its last
    steps_out = []
    for t in range(MAMBA_STEPS):
        yt, state = ssm.mamba_decode(
            p, x[:, MAMBA_PROMPT + t:MAMBA_PROMPT + t + 1], state, cfg)
        steps_out.append(yt)
    dec = torch.cat(steps_out, dim=1)
    scale = float(whole.abs().max())
    cont_err = float((dec - whole[:, MAMBA_PROMPT:]).abs().max())
    check(bool(torch.isfinite(whole).all()), "mamba_block: not finite")
    check(cont_err <= MAMBA_RTOL * scale, f"mamba_block: decode differs "
          f"from the prefill over more positions by {cont_err} "
          f"(scale {scale})")

    y_cpu, st_cpu = ssm.mamba_apply(p_cpu, x_cpu[:, :MAMBA_PROMPT], cfg)
    cpu_err = float((y.cpu() - y_cpu).abs().max())
    ssm_scale = float(st_cpu["ssm"].abs().max())
    ssm_err = float((st_prefill["ssm"].cpu() - st_cpu["ssm"]).abs().max())
    check(cpu_err <= MAMBA_RTOL * float(y_cpu.abs().max()),
          f"mamba_block: the card's prefill differs from the CPU's by "
          f"{cpu_err}")
    check(ssm_err <= MAMBA_RTOL * ssm_scale, f"mamba_block: the card's "
          f"state differs from the CPU's by {ssm_err} (scale {ssm_scale})")

    med = statistics.median
    prefill_ms = med(event_ms(torch, lambda: ssm.mamba_apply(p, pre, cfg))[0]
                     for _ in range(3))
    st = {k: v.clone() for k, v in state.items()}
    x1 = x[:, -1:]
    decode_ms = med(event_ms(torch, lambda: ssm.mamba_decode(p, x1, st,
                                                             cfg))[0]
                    for _ in range(LM_REPS))
    prefill_busy = device_busy_ms(torch, lambda: ssm.mamba_apply(p, pre,
                                                                 cfg), 1)
    decode_busy = device_busy_ms(torch, lambda: ssm.mamba_decode(
        p, x1, st, cfg), LM_REPS)
    wbytes = sum(t.numel() * t.element_size() for t in p.parameters())
    sbytes = sum(t.numel() * t.element_size() for t in st.values())
    one = dataclasses.replace(cfg, n_layers=1, pattern=("mamba",), d_ff=0,
                              moe=None, moe_mask=(), vocab=0)
    tokens = MAMBA_BATCH * MAMBA_PROMPT
    act = 4 * cfg.d_model * tokens * 2  # float32 input read, output written
    pre_bound, pre_by = bound(
        wbytes + act + sbytes, 2.0 * lm_matmul_params(one) * tokens
        + lm_recurrent_flops(one, MAMBA_BATCH, MAMBA_PROMPT))
    dec_bound, dec_by = bound(
        wbytes + 2 * sbytes + 4 * cfg.d_model * MAMBA_BATCH * 2,
        2.0 * lm_matmul_params(one) * MAMBA_BATCH
        + lm_recurrent_flops(one, MAMBA_BATCH, 1))
    emit({"phase": "mamba_block", "card": nvidia_smi(),
          "d_model": cfg.d_model, "d_inner": cfg.d_inner,
          "ssm_state": cfg.ssm_state, "dt_rank": cfg.dt_rank,
          "conv": cfg.ssm_conv, "params": n_params, "batch": MAMBA_BATCH,
          "prefill": MAMBA_PROMPT, "decode_steps": MAMBA_STEPS,
          "dtype": "float32", "rtol": MAMBA_RTOL,
          "decode_vs_prefill_max_abs": cont_err, "output_scale": scale,
          "card_vs_cpu_max_abs": cpu_err, "card_vs_cpu_state_max_abs":
          ssm_err, "state_scale": ssm_scale,
          "prefill_ms": prefill_ms, "prefill_bound_ms": pre_bound,
          "prefill_bound_by": pre_by, "prefill_busy_ms": prefill_busy,
          "prefill_busy_share": prefill_busy / prefill_ms,
          "decode_ms": decode_ms, "decode_bound_ms": dec_bound,
          "decode_bound_by": dec_by, "decode_busy_ms": decode_busy,
          "decode_busy_share": decode_busy / decode_ms})
    del p, p_cpu
    _free(torch)


def phase_moe_block(torch) -> None:
    """One MoE FFN at qwen2-moe-a2.7b's widths in float32 (TF32 off): a
    prefill row of 128 tokens (capacity 12 an expert) and a decode group of
    8 (capacity 4), their inputs leaning towards experts 0 and 1 so that
    both drop assignments.  On the card, the experts, slots and kept
    assignments equal the CPU's, and the output is within MOE_RTOL of the
    CPU's output scale."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod

    _free(torch)
    cfg = dataclasses.replace(get_config(LM_MOE_ARCH), dtype="float32")
    moe, d = cfg.moe, cfg.d_model
    cpu, dev = torch.device("cpu"), torch.device(DEVICE)
    p_cpu = moe_mod.init_moe(torch.Generator().manual_seed(LM_SEED), cfg,
                             moe, cpu)
    p = copy.deepcopy(p_cpu).to(dev)  # Module.to moves in place
    router = p_cpu["router"]
    lean = router[:, 0] + router[:, 1]  # x ~ N(0, 1): logit sd |column|
    lean = lean * (MOE_LEAN * router[:, 0].norm() / (lean @ router[:, 0]))
    g = torch.Generator().manual_seed(LM_SEED + 3)
    out = {"phase": "moe_block", "d_model": d, "experts": moe.n_experts,
           "top_k": moe.top_k, "d_expert": moe.d_expert,
           "d_shared": moe.d_shared, "dtype": "float32", "rtol": MOE_RTOL,
           "params": sum(t.numel() for t in p.parameters())}
    for name, shape in (("prefill", (1, MOE_PROMPT, d)),
                        ("decode_group", (MOE_GROUP, 1, d))):
        x_cpu = torch.randn(shape, generator=g) + lean
        x = x_cpu.to(dev)
        r_cpu = moe_mod.route(moe_mod.groups(x_cpu), router, moe)
        r = moe_mod.route(moe_mod.groups(x), p["router"], moe)
        same = all(torch.equal(getattr(r, f).cpu(), getattr(r_cpu, f))
                   for f in ("top_i", "slot", "keep", "stok"))
        y_cpu = moe_mod.moe_apply(p_cpu, x_cpu, cfg, moe)
        y = moe_mod.moe_apply(p, x, cfg, moe)
        torch.cuda.synchronize()
        scale = float(y_cpu.abs().max())
        err = float((y.cpu() - y_cpu).abs().max())
        dropped = int((~r.keep).sum())
        out[name] = {"tokens": shape[0] * shape[1], "capacity": r.cap,
                     "assignments": int(r.keep.numel()),
                     "dropped": dropped, "routing_equal": same,
                     "max_abs": err, "scale": scale}
        check(dropped > 0, f"moe_block: the {name} inputs dropped nothing")
        check(same, f"moe_block: the card's {name} routing differs from "
              f"the CPU's")
        check(bool(torch.isfinite(y).all()) and err <= MOE_RTOL * scale,
              f"moe_block: the card's {name} output differs from the "
              f"CPU's by {err} (scale {scale})")
    emit(out)
    del p, p_cpu
    _free(torch)


# ---------------------------------------------------------------------------
# LM training on one card: yi-9b and qwen2-moe-a2.7b at full width, depth
# cut; one yi-9b layer and its flash backward against the CPU
# ---------------------------------------------------------------------------

# layers kept of each config's stack (yi-9b 48, qwen2-moe-a2.7b 24): the
# float32 leaves, their gradients and two float32 AdamW moments take 16
# bytes a parameter, 30.4 and 28.3 GB here
TRAIN_LAYERS = {"yi-9b": 8, "qwen2-moe-a2.7b": 2}
# B x S tokens a step from SyntheticLM: 1,024 positions cross the flash
# loops' 512-position chunks and the causal mask
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
TRAIN_STEPS, TRAIN_WARM, TRAIN_TIMED = 10, 2, 5
TRAIN_REMAT = "nothing"
# AdamW as the reference's trainer runs it by default (`launch/train.py`:
# --lr 3e-4, --warmup 20, the rest AdamWConfig's defaults)
TRAIN_LR, TRAIN_WARMUP = 3e-4, 20
# the checkpoint check: `launch.train` on yi-9b reduced, 4 steps with a
# checkpoint every 2, resumed to 6, against an uninterrupted 6
TRAIN_CLI_ARCH = "yi-9b"
# one yi-9b layer (attention + SwiGLU) in float32 (TF32 off), B = 1 x S =
# 1,024, the loss mean(y^2): loss and every gradient on the card within
# 1e-4 of the CPU's (float32 sums over 4,096- and 11,008-long products in
# two devices' orders), per leaf against its largest |g|
BLOCK_SEQ, BLOCK_RTOL = 1024, 1e-4
# the flash backward at yi-9b's heads against the naive oracle under
# autograd on the card, float32: 1e-4 of each gradient's largest |g|
FLASH_RTOL = 1e-4


def lm_train_flops(cfg, batch: int, seq: int) -> float:
    """bf16 operations of a train step: three times the forward's (the
    forward's products, and the backward's two per product), the forward
    taking every position through the layers' projections, the routed
    experts' slots, the causal attention, the recurrent mixers and the
    head (the loss reads every position's logits).  Remat's recompute is
    not counted: the bound is the work the step's outputs need."""
    fwd = (2.0 * (lm_matmul_params(cfg) + cfg.d_model * cfg.vocab)
           * batch * seq
           + 2.0 * lm_expert_macs(cfg, batch, seq)
           + lm_attention_flops(cfg, batch, seq * (seq + 1) // 2)
           + lm_recurrent_flops(cfg, batch, seq))
    return 3.0 * fwd


def adamw_bytes(leaves: dict, state: dict) -> int:
    """Bytes AdamW's update must move: every leaf, its gradient (the
    leaf's type) and both moments read, the leaf and moments written."""
    nb = lambda t: t.numel() * t.element_size()
    return sum(3 * nb(p) + 2 * nb(state["m"][n]) + 2 * nb(state["v"][n])
               for n, p in leaves.items())


def phase_train_lm(torch) -> None:
    """Single-card training at full width (yi-9b, qwen2-moe-a2.7b; depth
    cut, each cut printed), then the trainer's checkpoint resume."""
    for arch, n_layers in TRAIN_LAYERS.items():
        _free(torch)
        _train_lm(torch, arch, n_layers)
    _free(torch)
    _train_cli_resume(torch)


def _profile_step(torch, fn) -> tuple[float, int]:
    """(device ms, kernels) of one call of `fn` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = kernel_events(torch, prof)
    return (sum(e.device_time_total for e in events) / 1e3,
            sum(e.count for e in events))


def _train_lm(torch, arch: str, n_layers: int) -> None:
    import dataclasses
    import math

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw

    dev = torch.device(DEVICE)
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers)
    emit({"phase": "train_lm_cut", "arch": arch,
          "layers": f"{n_layers} of {full.n_layers}",
          "widths": "full", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tfm.init_model(cfg, seed=LM_SEED, device=dev, train=True)
    leaves = tfm.train_leaves(model, cfg)
    opt_cfg = dataclasses.replace(steps.default_opt_cfg(cfg), lr=TRAIN_LR,
                                  warmup_steps=TRAIN_WARMUP,
                                  total_steps=TRAIN_STEPS + 1)
    state = adamw.init(leaves, opt_cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = steps.make_train_step(cfg, None, opt_cfg,
                                 remat_policy=TRAIN_REMAT)
    data = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=LM_SEED)
    rows = []
    for i in range(TRAIN_STEPS):
        batch = to_device(data.batch(i), dev)
        ms, (_, state, metrics) = event_ms(
            torch, lambda: step(model, state, batch))
        rows.append({"step": i, "ms": ms,
                     **{k: float(v) for k, v in metrics.items()}})
    peak = torch.cuda.max_memory_allocated()
    batch = to_device(data.batch(TRAIN_STEPS), dev)
    busy_ms, kernels = _profile_step(
        torch, lambda: step(model, state, batch))

    losses = [r["loss"] for r in rows]
    timed_ms = [r["ms"] for r in rows[TRAIN_WARM:TRAIN_WARM + TRAIN_TIMED]]
    step_ms = statistics.median(timed_ms)
    n_params = sum(p.numel() for p in leaves.values())
    flops = lm_train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    opt_bytes = adamw_bytes(leaves, state)
    bound_ms = (flops / BF16_FLOPS + opt_bytes / HBM_BYTES_PER_S) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    emit({"phase": "train_lm", "arch": arch, "card": nvidia_smi(),
          "layers": n_layers, "params": n_params, "init_s": init_s,
          "remat": TRAIN_REMAT, "opt": dataclasses.asdict(opt_cfg),
          "steps": rows, "ln_vocab": math.log(cfg.vocab),
          "step_ms_median": step_ms, "step_ms_spread": spread(timed_ms),
          "bound_ms": bound_ms, "bound_flops": flops,
          "bound_flops_ms": flops / BF16_FLOPS * 1e3,
          "bound_opt_bytes": opt_bytes,
          "bound_opt_bytes_ms": opt_bytes / HBM_BYTES_PER_S * 1e3,
          "step_over_bound": step_ms / bound_ms,
          "tokens_per_s": tokens / (step_ms / 1e3),
          "busy_ms": busy_ms, "busy_share": busy_ms / step_ms,
          "kernels_per_step": kernels, "peak_bytes": peak})
    timing_train_lm(torch, cfg, model, leaves, state, opt_cfg, batch,
                    step_ms)
    check(all(math.isfinite(x) for x in losses),
          f"train_lm {arch}: a loss is not finite: {losses}")
    check(losses[-1] < losses[0],
          f"train_lm {arch}: the loss did not fall over {TRAIN_STEPS} "
          f"steps: {losses}")
    del model, leaves, state, batch


def timing_train_lm(torch, cfg, model, leaves, state, opt_cfg, batch,
                    step_ms: float) -> None:
    """A train step by part, medians of LM_REPS calls (CUDA events): the
    forward alone (no autograd), the loss and its gradients (remat
    "nothing", and "dots", which keeps the projections' outputs), AdamW's
    update alone, and the flash attention
    of one layer at the step's shape, forward alone and forward with its
    backward, times the attention layers (remat runs each forward
    twice)."""
    from repro_torch.models import layers
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw

    med = statistics.median
    params = list(leaves.values())

    def fwd_bwd(policy):
        loss = tfm.train_loss(model, cfg, batch, remat_policy=policy)
        return torch.autograd.grad(loss, params)

    parts = {}
    with torch.no_grad():  # the forward alone: remat recomputes its layers
        parts["forward_ms"] = med(event_ms(torch, lambda: tfm.train_loss(
            model, cfg, batch))[0] for _ in range(LM_REPS))
    for policy in ("nothing", "dots"):
        torch.cuda.reset_peak_memory_stats()
        parts[f"loss_and_grads_{policy}_ms"] = med(
            event_ms(torch, lambda: fwd_bwd(policy))[0]
            for _ in range(LM_REPS))
        parts[f"loss_and_grads_{policy}_peak_bytes"] = (
            torch.cuda.max_memory_allocated())
    grads = dict(zip(leaves, fwd_bwd(TRAIN_REMAT)))
    parts["adamw_ms"] = med(event_ms(torch, lambda: adamw.update(
        leaves, grads, state, opt_cfg, decays=tfm.decays))[0]
        for _ in range(LM_REPS))
    del grads
    n_attn = _layers_of(cfg, ATTN_KINDS)
    hp, kvp = layers.head_geometry(cfg)[:2]
    g = torch.Generator(device=DEVICE).manual_seed(LM_SEED + 7)
    shape = lambda h: (TRAIN_BATCH, TRAIN_SEQ, h, cfg.hd)
    qkv = [torch.randn(shape(h), generator=g, device=DEVICE,
                       dtype=cfg.act_dtype).requires_grad_(True)
           for h in (hp, kvp, kvp)]
    dout = torch.randn(shape(hp), generator=g, device=DEVICE,
                       dtype=cfg.act_dtype)

    def flash_fwd_bwd():
        out = layers.flash_attention(*qkv)
        return torch.autograd.grad(out, qkv, dout)

    with torch.no_grad():
        fwd_ms = med(event_ms(torch, lambda: layers.flash_attention(*qkv))[0]
                     for _ in range(LM_REPS))
    fb_ms = med(event_ms(torch, flash_fwd_bwd)[0] for _ in range(LM_REPS))
    parts.update({"flash_fwd_ms_a_layer": fwd_ms,
                  "flash_fwd_bwd_ms_a_layer": fb_ms,
                  "attention_layers": n_attn,
                  "flash_in_step_ms": n_attn * (fwd_ms + fb_ms)})
    emit({"phase": "timing_train_lm", "arch": cfg.name,
          "step_ms": step_ms, **parts,
          "other_ms": step_ms - parts["loss_and_grads_nothing_ms"]
          - parts["adamw_ms"]})


def _train_cli_resume(torch) -> None:
    """`python -m repro_torch.launch.train` in subprocesses under
    deterministic algorithms: 4 steps with a checkpoint every 2, resumed
    to 6, against an uninterrupted 6-step run: every step's loss, grad
    norm and lr equal bit for bit (exact floats from --metrics-out)."""
    import json as json_mod
    import os
    import shutil

    base = ROOT / "build" / "train_cli"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    common = ["--arch", TRAIN_CLI_ARCH, "--reduced", "--deterministic",
              "--log-every", "1"]
    runs = {"first": ["--steps", "4", "--ckpt-every", "2"],
            "resumed": ["--steps", "6", "--ckpt-every", "2", "--resume"],
            "whole": ["--steps", "6", "--ckpt-every", "2"]}

    def cmd(name):
        d = base / ("whole" if name == "whole" else "split")
        return [sys.executable, "-m", "repro_torch.launch.train", *common,
                *runs[name], "--ckpt-dir", str(d), "--metrics-out",
                str(d) + ".jsonl"]

    # the uninterrupted run shares nothing with the split one: it runs
    # alongside (deterministic algorithms hold each bit for bit)
    t_whole = time.perf_counter()
    whole_proc = subprocess.Popen(cmd("whole"), cwd=ROOT, env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for name in ("first", "resumed", "whole"):
            t0 = time.perf_counter()
            if name == "whole":
                stdout, stderr = whole_proc.communicate(timeout=600)
                res = subprocess.CompletedProcess(cmd(name),
                                                  whole_proc.returncode,
                                                  stdout, stderr)
                t0 = t_whole
            else:
                res = subprocess.run(cmd(name), cwd=ROOT, env=env,
                                     capture_output=True, text=True,
                                     timeout=600)
            out[name] = {"rc": res.returncode, "s": time.perf_counter() - t0,
                         "tail": res.stdout.splitlines()[-2:]}
            check(res.returncode == 0, f"train CLI ({name}) exited "
                  f"{res.returncode}: {res.stdout[-2000:]} "
                  f"{res.stderr[-2000:]}")
            if name == "resumed":
                check("[train] resumed from step 4" in res.stdout,
                      f"train CLI: no resume: {res.stdout[-1000:]}")
    finally:
        if whole_proc.poll() is None:  # a failed check stops it too
            whole_proc.kill()
            whole_proc.wait()
    read = lambda p: [json_mod.loads(ln) for ln in open(p)]
    split, whole = read(str(base / "split") + ".jsonl"), read(
        str(base / "whole") + ".jsonl")
    emit({"phase": "train_lm_cli", "cmd": "python -m "
          "repro_torch.launch.train " + " ".join(common), "runs": out,
          "split": split, "whole": whole, "bit_equal": split == whole})
    check(split == whole, "train CLI: the resumed run's metrics differ "
          "from the uninterrupted run's")


# ---------------------------------------------------------------------------
# the LM mesh over ranks: serve_lm_mesh, train_lm_mesh
# ---------------------------------------------------------------------------

LM_MESH = (2, 4)  # gloo ranks sharing the card, (data, model)
# full widths, depth cut (printed): layers served over the mesh (8 gloo
# ranks move each block's weights over the data axis and the
# tensor-parallel sums over the model axis through host memory; before
# tensor-parallel compute a decode step of yi-9b's 4 layers took 6.6 s).
# xlstm-350m's 4 layers are one period of its pattern (three mLSTM, one
# sLSTM); jamba's one is slot 0, a Mamba mixer and the dense FFN
LM_MESH_SERVE = {"yi-9b": 2, "qwen2-moe-a2.7b": 1, "xlstm-350m": 4,
                 "jamba-1.5-large-398b": 1}
# tokens a model (cut from 8, printed, to make room for xlstm and jamba)
LM_MESH_GEN = 4
LM_MESH_GEN_CUT = "8 -> 4"
LM_MESH_TRAIN_ARCH, LM_MESH_TRAIN_LAYERS = "yi-9b", 2
LM_MESH_TRAIN_BATCH, LM_MESH_TRAIN_SEQ, LM_MESH_TRAIN_STEPS = 8, 512, 3
# the models whose recurrent mixers split over "model" (Mamba by d_inner
# channel, mLSTM by head, sLSTM by head dim), trained at the depths
# serve_lm_mesh serves them (xlstm-350m: one period, three mLSTM and an
# sLSTM; jamba: a Mamba mixer and the dense FFN), float32 leaves, one
# AdamW step each on B 8 x S 128 (the sLSTM gathers h over "model" at
# every position, forward and backward)
LM_MESH_TRAIN_TP = {"xlstm-350m": 4, "jamba-1.5-large-398b": 1}
LM_MESH_TP_BATCH, LM_MESH_TP_SEQ, LM_MESH_TP_STEPS = 8, 128, 1
# gloo ranks sharing the card build a training model past this in turns
# (jamba's layer: 2.1 G float32 leaves, 8.4 GB; yi-9b's 2 layers, 3.5 GB,
# at once)
LM_MESH_TRAIN_TURN_BYTES = 2**32
# bf16 logits of the mesh's rows (GEMMs over 4 rows, not 8) against the
# one-process step's, teacher-forced on the same tokens: a share of the
# largest |logit| (the decode-against-forward limit, LM_FORWARD_RTOL)
LM_MESH_LOGIT_RTOL = LM_FORWARD_RTOL
# mesh against one process, train_lm_mesh.  Step 0 starts from the same
# leaves: its loss and gradient norm, each a share of the one-process
# value.  The loss's limit lies between the bf16 tensor-parallel step's
# sound gap (its contractions split over the model axis and summed in
# float32: 1.54e-5) and the gaps of planted faults in the split region
# (the model-axis sum dropped 2.6e-4, a rank's heads against other rows
# of wo 3.6e-3; PERF.md §6).  After the steps, each leaf's update
# p_final - p_init: the norm of its difference from the one-process
# update, a share of that update's norm (bf16 activations over other
# GEMM shapes move each gradient a little, and AdamW's normalised first
# steps turn a near-zero gradient's sign into a whole step).  A gradient taken from
# half the batch (a dropped dp sum) moves the norm by a third and the
# updates by about their size (PERF.md, PR 24).
LM_MESH_LOSS_RTOL = 5e-5
# the same limit for the models of LM_MESH_TRAIN_TP, each between its
# sound gap and the gap of a fault planted in its own split region
# (PERF.md §6): xlstm-350m sound 1.107e-5, its sLSTM's h gathered from
# the wrong ranks 4.41e-3; jamba with x_proj's partial sum not summed
# over "model" 2.07e-4 (its sound gap as yi-9b's and xlstm's, ~1.5e-5)
LM_MESH_LOSS_RTOL_BY_ARCH = {"xlstm-350m": 1e-4,
                             "jamba-1.5-large-398b": 1e-4}
LM_MESH_GNORM_RTOL = 1e-3
# xlstm-350m's gradient norm: its exponential gates amplify the bf16
# tensor-parallel step's rounding (sound 1.646e-3, the planted sLSTM
# fault 0.0521; PERF.md §6)
LM_MESH_GNORM_RTOL_BY_ARCH = {"xlstm-350m": 1e-2}
LM_MESH_UPDATE_RTOL = 0.25
# the checkpoint saved, zeroed and restored on the gloo world: block 0's
# leaves and moments, the final norm and the step (a full-width block)
LM_MESH_CKPT_LEAVES = ("blocks.0.", "final_norm")
LM_MESH_DIR = ROOT / "build" / "lm_mesh"


def _mesh_cfg(torch, arch: str, n_layers: int):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), n_layers=n_layers)


def _digest(t) -> str:
    """A tensor's bytes hashed (bit-equal tensors, equal digests)."""
    import hashlib

    import torch

    host = t.detach().contiguous().cpu().view(-1).view(torch.uint8)
    return hashlib.sha256(host.numpy().tobytes()).hexdigest()


def _requested(torch) -> int:
    """Bytes the caching allocator holds for this process's tensors, as
    they were asked for (before its rounding)."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def _resident(torch, model, specs, cfg, mesh, base: int) -> dict:
    """The rank's resident parameter bytes after `distribute` (the whole
    model freed): `memory_allocated` (the caching allocator's blocks,
    each rounded up; a block carved from a larger segment may keep up to
    1 MiB more) and the bytes those blocks were asked for
    (`requested_bytes`, less `base`, what the process held before the
    model: a cuBLAS workspace, say), beside the specs' shard bytes."""
    from repro_torch.launch import sharding

    _free(torch)
    spec_bytes = 0
    for name, p in model.named_parameters():
        shape = sharding.storage_shape(cfg, name, p.shape)
        spec_bytes += sharding.shard_bytes(mesh, shape, specs[name], p.dtype)
    return {"resident_bytes": torch.cuda.memory_allocated(),
            "requested_bytes": _requested(torch) - base,
            "spec_shard_bytes": spec_bytes}


def _build_shards(torch, device_mesh, cfg, turn_bytes: int,
                  train: bool = False):
    """(the model built from the seed on the card and distributed, each
    rank keeping its shards and the whole freed; its specs).  gloo ranks
    sharing the card build a whole model past `turn_bytes` in turns (one
    at a time: eight of jamba's layer and its float32 draws at once
    passed the card's 80 GB)."""
    import torch.distributed as dist

    from repro_torch.launch import sharding
    from repro_torch.models import transformer as tfm

    dev = torch.device("cuda", torch.cuda.current_device())
    big = sum(w.numel() * w.element_size() for w in tfm.init_model(
        cfg, device="meta", train=train).parameters()) > turn_bytes
    turns = (dist.get_world_size()
             if dist.get_backend() == "gloo" and big else 1)
    rank = dist.get_rank()
    for turn in range(turns):
        if turn == rank % turns:
            whole = tfm.init_model(cfg, seed=LM_SEED, device=dev,
                                   train=train)
            specs = sharding.param_specs(device_mesh, cfg, whole)
            model = sharding.distribute(device_mesh, whole, specs, cfg=cfg)
            del whole
            _free(torch)
        if turns > 1:
            dist.barrier()
    return model, specs


def rank_lm_serve(rank, device_mesh, gloo_tokens) -> dict:
    """One rank of serve_lm_mesh, for each arch of LM_MESH_SERVE in turn:
    the model built on the card from the seed and distributed (each rank
    its shard, the whole freed); the kernels loaded by one small draw;
    then `serve.generate(..., mesh=)` with counters zeroed before and
    read after, keeping the logits each token was drawn from, and every
    draw against the twin on them.  With `gloo_tokens` (the NCCL world:
    the gloo world's tokens by arch), rank 0 then runs the one-process
    reference (`_serve_single`) in the same process."""
    import torch
    import torch.distributed as dist

    out = {}
    for arch, n_layers in LM_MESH_SERVE.items():
        cfg = _mesh_cfg(torch, arch, n_layers)
        out[arch] = _rank_serve(torch, rank, device_mesh, cfg)
        if gloo_tokens is not None and rank == 0:
            out[arch]["single"] = _serve_single(torch, cfg,
                                                gloo_tokens[arch])
        _free(torch)
    dist.barrier()
    return out


def _rank_serve(torch, rank, device_mesh, cfg) -> dict:
    import torch.distributed as dist

    from repro_torch import prng
    from repro_torch.core.interp import build_exp_weight_lut
    from repro_torch.launch import collectives, serve
    from repro_torch.models import sampling

    dev = torch.device("cuda", torch.cuda.current_device())
    base = _requested(torch)
    t_build = time.perf_counter()
    model, specs = _build_shards(torch, device_mesh, cfg, 2**31)
    build_s = time.perf_counter() - t_build
    mem = _resident(torch, model, specs, cfg, device_mesh, base)
    g = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                            generator=g, device=dev, dtype=torch.int32)
    key = prng.key(LM_SEED)
    sampling.ky_token_sample(torch.zeros((LM_BATCH, 256), device=dev), key)
    dist.barrier()
    zero_launches()
    c0 = dict(collectives.TOTALS)
    b0 = dict(collectives.BYTES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, comms = [], {}
    toks, times = serve.generate(cfg, model, prompts, LM_MESH_GEN,
                                 sampler="ky", mesh=device_mesh, key=key,
                                 logits_out=logits, comms_out=comms)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    coll = {k: collectives.TOTALS[k] - c0[k] for k in c0}
    coll_bytes = collective_bytes(collectives.BYTES, b0, LM_MESH_GEN)
    # each draw against the twin on the gathered logits it came from
    t_twin = time.perf_counter()
    tab_cpu, spec_cpu = build_exp_weight_lut(device="cpu")
    twin_bad, k = 0, key
    for t, lg in enumerate(logits):
        sub = k
        if t:
            k, sub = prng.split(k)
        twin = sampling.ky_token_sample(lg.cpu(), sub, exp_table=tab_cpu,
                                        exp_spec=spec_cpu)
        twin_bad += int((toks[:, LM_PROMPT + t].cpu() != twin).sum())
    twin_s = time.perf_counter() - t_twin
    lgs = torch.stack(logits).cpu()
    del model, logits
    return {"rank": rank, "coords": tuple(device_mesh.get_coordinate()),
            "build_s": build_s, "twin_s": twin_s,
            "tokens": toks.cpu(), "logits_digest": _digest(lgs),
            "logits": lgs if rank == 0 else None, "wall_s": wall,
            "step_s": times, "collectives": coll["collectives"],
            "collective_ms": coll["seconds"] * 1e3,
            "collective_bytes_per_token": coll_bytes,
            "decode_bytes_by_axis_per_step": by_axis(
                {k: v / (LM_MESH_GEN - 1)
                 for k, v in comms["decode"].axis_bytes.items()}),
            "launches": launches,
            "twin_mismatches": twin_bad, **mem}


def _serve_single(torch, cfg, toks) -> dict:
    """The one-process step on the card: generate's tokens and the logits
    they were drawn from, and the logits of the prefill and decode steps
    teacher-forced on `toks` (the gloo world's), in generate's order."""
    from repro_torch import prng
    from repro_torch.launch import serve, steps
    from repro_torch.models import transformer as tfm

    dev = torch.device("cuda", torch.cuda.current_device())
    model = tfm.init_model(cfg, seed=LM_SEED, device=dev)
    prompts = toks[:, :LM_PROMPT].to(dev)
    key = prng.key(LM_SEED)
    own = []
    mine, _ = serve.generate(cfg, model, prompts, LM_MESH_GEN, sampler="ky",
                             key=key, logits_out=own)
    logits, caches = steps.make_prefill_step(cfg)(model, {"tokens": prompts})
    caches = tfm.grow_attn_caches(caches, cfg, LM_MESH_GEN)
    step = steps.make_serve_step(cfg, sampler="ky")
    lgs, k, t_dev = [logits], key, toks.to(dev)
    for t in range(LM_MESH_GEN - 1):
        k, sub = prng.split(k)
        _, lg, caches = step(model, t_dev[:, LM_PROMPT + t:LM_PROMPT + t + 1],
                             caches, LM_PROMPT + t, sub)
        lgs.append(lg)
    out = {"tokens": mine.cpu(), "own_logits": torch.stack(own).cpu(),
           "logits": torch.stack(lgs).cpu()}
    del model, caches
    return out


def phase_serve_lm_mesh(torch) -> dict:
    """LM serving over ranks: 8 gloo ranks sharing the card as (2, 4), then
    an NCCL world of min(cards, 4) ranks (whose rank 0 also runs the
    one-process reference), at full width with depth cut (LM_MESH_SERVE:
    yi-9b 2 of 48 layers, qwen2-moe-a2.7b 1 of 24, xlstm-350m 4 of 24,
    jamba-1.5-large-398b 1 of 72), 8 prompts of 128 tokens and
    LM_MESH_GEN KY tokens.  Every rank returns the same tokens and
    logits; each rank's weights take its shards' bytes; the logits are
    within LM_MESH_LOGIT_RTOL of the one-process step's on the same
    tokens (the NCCL 1 x 1 world bit-equal); every draw equals the
    twin's on the gathered logits; a gloo rank's decode step moves fewer
    bytes over "model" than one gather of the K/V caches would.  Returns
    rank 0's launches per arch."""
    from repro_torch.kernels import _lib
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import sampling

    _lib.build()  # the ranks load the libraries; none of them builds one
    card = nvidia_smi()
    n = min(torch.cuda.device_count(), NCCL_MAX_RANKS)
    for arch, n_layers in LM_MESH_SERVE.items():
        emit({"phase": "serve_lm_mesh_cut", "arch": arch,
              "layers": f"{n_layers} of {_full_layers(arch)}",
              "widths": "full", "batch": LM_BATCH, "prompt_len": LM_PROMPT,
              "gen": LM_MESH_GEN, "gen_cut": LM_MESH_GEN_CUT})
    _free(torch)
    gloo = mesh_mod.spawn(rank_lm_serve, LM_MESH[0] * LM_MESH[1],
                          backend="gloo", device="cuda",
                          timeout_s=RANK_TIMEOUT_S, mesh_shape=LM_MESH,
                          args=(None,))
    nccl = mesh_mod.spawn(rank_lm_serve, n, backend="nccl", device="cuda",
                          timeout_s=RANK_TIMEOUT_S, mesh_shape=(1, n),
                          args=({a: gloo[0][a]["tokens"]
                                 for a in LM_MESH_SERVE},))
    out = {}
    for arch, n_layers in LM_MESH_SERVE.items():
        cfg = _mesh_cfg(torch, arch, n_layers)
        single = nccl[0][arch]["single"]
        cache_bytes = _cache_gather_bytes(cfg)
        worlds = {"gloo": [r[arch] for r in gloo],
                  "nccl": [r[arch] for r in nccl]}
        for name, world in worlds.items():
            r0 = world[0]
            emit({"phase": "serve_lm_mesh", "arch": arch, "backend": name,
                  "mesh": list(LM_MESH) if name == "gloo" else [1, n],
                  "card": card, "layers": n_layers,
                  "wall_s_ranks": [r["wall_s"] for r in world],
                  "build_s_rank0": r0["build_s"],
                  "twin_check_s_rank0": r0["twin_s"],
                  "decode_step_s_rank0": r0["step_s"],
                  "collectives_rank0": r0["collectives"],
                  "collective_ms_rank0": r0["collective_ms"],
                  "collective_ms_per_token_rank0":
                      r0["collective_ms"] / LM_MESH_GEN,
                  "collective_bytes_per_token_ranks":
                      [r["collective_bytes_per_token"] for r in world],
                  "result_bytes_by_axis_per_token_ranks":
                      [by_axis(r["collective_bytes_per_token"])
                       for r in world],
                  "decode_step_bytes_by_axis_ranks":
                      [r["decode_bytes_by_axis_per_step"] for r in world],
                  "cache_gather_bytes_per_step": cache_bytes,
                  "resident_bytes_ranks": [r["resident_bytes"]
                                           for r in world],
                  "requested_bytes_ranks": [r["requested_bytes"]
                                            for r in world],
                  "spec_shard_bytes_ranks": [r["spec_shard_bytes"]
                                             for r in world],
                  "launches_rank0": r0["launches"],
                  "twin_mismatches": [r["twin_mismatches"] for r in world],
                  # the gloo world teacher-forced on its own tokens, the
                  # NCCL world against one process's own generate
                  "logits_vs_one_process_max_abs": float(
                      (r0["logits"] - single["logits" if name == "gloo"
                                             else "own_logits"]).abs().max()),
                  "largest_abs_logit": float(single["logits"].abs().max()),
                  "rtol": LM_MESH_LOGIT_RTOL,
                  "tokens_equal_one_process": bool(torch.equal(
                      r0["tokens"], single["tokens"]))})
        levels = sampling.weight_pyramid(torch.zeros((1, cfg.vocab),
                                                     dtype=torch.int32))
        want = {"ky_sample_kernel": len(levels) * LM_MESH_GEN,
                "interp_kernel": LM_MESH_GEN}
        for name, world in worlds.items():
            for r in world:
                where = f"serve_lm_mesh {arch} {name}: rank {r['rank']}"
                check(torch.equal(r["tokens"], world[0]["tokens"])
                      and r["logits_digest"] == world[0]["logits_digest"],
                      f"{where} returned other tokens or logits than rank "
                      "0")
                check(r["twin_mismatches"] == 0, f"{where}: "
                      f"{r['twin_mismatches']} draws differ from the "
                      "twin's on the gathered logits")
                check(r["requested_bytes"] == r["spec_shard_bytes"],
                      f"{where} holds {r['requested_bytes']} bytes of "
                      f"weights, its shards {r['spec_shard_bytes']}")
                model = r["decode_bytes_by_axis_per_step"].get("model", 0)
                check(name != "gloo" or not cache_bytes
                      or model < cache_bytes, f"{where} moves {model} "
                      "bytes a decode step over the model axis, not under "
                      f"one gather of the K/V caches ({cache_bytes})")
                got = {k: r["launches"][k] for k in want}
                check(got == want and all(
                    v == 0 for k, v in r["launches"].items()
                    if k not in want), f"{where} launched {r['launches']},"
                    f" expected {want} and no other kernel")
        scale = float(single["logits"].abs().max())
        err = float((worlds["gloo"][0]["logits"]
                     - single["logits"]).abs().max())
        check(err <= LM_MESH_LOGIT_RTOL * scale, f"serve_lm_mesh {arch}: "
              f"mesh logits differ from one process by {err} (largest "
              f"|logit| {scale}, limit {LM_MESH_LOGIT_RTOL} of it)")
        if n == 1:
            one = worlds["nccl"][0]
            check(torch.equal(one["logits"], single["own_logits"])
                  and torch.equal(one["tokens"], single["tokens"]),
                  f"serve_lm_mesh {arch}: the NCCL 1 x 1 world differs "
                  "from the one-process step")
        out[arch] = worlds["gloo"][0]["launches"]
    return out


def by_axis(per_op: dict) -> dict:
    """Bytes by "<op> over <axis>" summed by axis."""
    out: dict = {}
    for k, v in per_op.items():
        axis = k.rsplit(" over ", 1)[1]
        out[axis] = out.get(axis, 0) + v
    return out


def _cache_gather_bytes(cfg) -> int:
    """What a (2, 4) gloo rank's decode step would gather over "model"
    were the K/V caches' sequence gathered there (the earlier layout):
    every attention layer's K and V of the rank's rows, the whole cache
    length, every KV head; 0 without attention layers."""
    import torch

    from repro_torch.models import layers as lyr

    attn = sum(cfg.pattern[i % len(cfg.pattern)] in ("attn", "attn_chunked")
               for i in range(cfg.n_layers))
    rows = LM_BATCH // LM_MESH[0]
    return (attn * rows * (LM_PROMPT + LM_MESH_GEN)
            * lyr.head_geometry(cfg)[1] * cfg.hd * 2
            * torch.tensor([], dtype=cfg.act_dtype).element_size())


def collective_bytes(now: dict, before: dict, per: int) -> dict:
    """The collectives' result bytes since `before` (a copy of
    `collectives.BYTES`), by "<op> over <axis>", each divided by `per`
    (tokens or steps)."""
    return {k: (v - before.get(k, 0)) / per for k, v in sorted(now.items())
            if v != before.get(k, 0)}


def _full_layers(arch: str) -> int:
    from repro_torch.configs import get_config

    return get_config(arch).n_layers


def lm_mesh_train_runs() -> dict:
    """train_lm_mesh's models in order: {arch: (layers, batch, seq,
    steps)}."""
    runs = {LM_MESH_TRAIN_ARCH: (LM_MESH_TRAIN_LAYERS, LM_MESH_TRAIN_BATCH,
                                 LM_MESH_TRAIN_SEQ, LM_MESH_TRAIN_STEPS)}
    runs.update({arch: (layers, LM_MESH_TP_BATCH, LM_MESH_TP_SEQ,
                        LM_MESH_TP_STEPS)
                 for arch, layers in LM_MESH_TRAIN_TP.items()})
    return runs


def rank_lm_train(rank, device_mesh, single_dir, ckpt_dir) -> dict:
    """One rank of train_lm_mesh, under deterministic algorithms: each
    model of `lm_mesh_train_runs` in turn (`_rank_train`; the one-process
    references' files in `single_dir`, yi-9b's checkpoint in `ckpt_dir`),
    freed before the next."""
    import torch
    import torch.distributed as dist

    _deterministic(torch)
    out = {}
    for arch, run in lm_mesh_train_runs().items():
        out[arch] = _rank_train(
            torch, rank, device_mesh, arch, run,
            os.path.join(single_dir, arch),
            ckpt_dir if arch == LM_MESH_TRAIN_ARCH else None)
        _free(torch)
    dist.barrier()
    return out


def _mesh_train_cfg(arch: str, n_layers: int):
    """`arch` at full width, depth cut, its leaves in float32 (jamba's
    config holds bf16 leaves)."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), n_layers=n_layers,
                               param_dtype="float32")


def _rank_train(torch, rank, device_mesh, arch, run, single_path,
                ckpt_dir) -> dict:
    """`arch`'s training model (float32 leaves) built from the seed on the
    card and distributed (`_build_shards`), then run = (layers, batch,
    seq, steps) AdamW steps on `SyntheticLM` batches placed on the mesh;
    with `ckpt_dir` (yi-9b, the gloo world), before the last step a
    checkpoint of LM_MESH_CKPT_LEAVES (rank 0 writes it), those leaves and
    moments zeroed and restored from it (bit-equal to the state saved),
    and the last step run from the restored state.  In the NCCL world
    (`single_path` not written yet) rank 0 first runs the one-process
    reference and writes its leaves to `single_path` (its state freed
    before the mesh's is built: jamba's layer with its moments is 25
    GB); every rank returns, for each leaf's block, the squared norms of
    its difference from the one-process leaf and of the one-process
    update (read by memory map)."""
    import torch.distributed as dist

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.data.pipeline import SyntheticLM, place_batch
    from repro_torch.launch import collectives, sharding, steps
    from repro_torch.launch import train as train_lib
    from repro_torch.models import transformer as tfm

    n_layers, batch_size, seq, n_steps = run
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = _mesh_train_cfg(arch, n_layers)
    opt_cfg = _mesh_opt_cfg(n_steps)
    data = SyntheticLM(cfg.vocab, seq, batch_size, seed=LM_SEED)
    if rank == 0 and not os.path.exists(single_path):
        _train_single(torch, cfg, opt_cfg, data, n_steps, single_path)
    dist.barrier()
    base = _requested(torch)
    t_build = time.perf_counter()
    params, specs = _build_shards(torch, device_mesh, cfg,
                                  LM_MESH_TRAIN_TURN_BYTES, train=True)
    build_s = time.perf_counter() - t_build
    mem = _resident(torch, params, specs, cfg, device_mesh, base)
    with_batch, _ = steps.make_train_step(cfg, device_mesh, opt_cfg)
    fn, bspecs = with_batch(data.batch(0))
    bshard = sharding.to_named(device_mesh, bspecs)
    leaves = tfm.train_leaves(params, cfg)
    init = {n: sharding.local(p).detach().clone() for n, p in leaves.items()}
    state = train_lib.moments(device_mesh, leaves, opt_cfg)
    tree = None
    if ckpt_dir is not None:
        saved = [n for n in leaves if n.startswith(LM_MESH_CKPT_LEAVES)]
        tree = {"params": {n: leaves[n] for n in saved},
                "opt": {"m": {n: state["m"][n] for n in saved},
                        "v": {n: state["v"][n] for n in saved},
                        "step": state["step"]}}
    rows, restored = [], None
    for i in range(n_steps):
        if ckpt_dir is not None and i == n_steps - 1:
            restored = _save_zero_restore(torch, ckpt, train_lib, cfg,
                                          tree, ckpt_dir, i)
        batch = place_batch(data.batch(i), bshard, dev)
        dist.barrier()
        c0 = dict(collectives.TOTALS)
        b0 = dict(collectives.BYTES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = fn(params, state, batch)
        torch.cuda.synchronize()
        rows.append({"step": i, "s": time.perf_counter() - t0,
                     "collective_ms": (collectives.TOTALS["seconds"]
                                       - c0["seconds"]) * 1e3,
                     "collectives": collectives.TOTALS["collectives"]
                     - c0["collectives"],
                     "collective_bytes": collective_bytes(
                         collectives.BYTES, b0, 1),
                     **{k: float(v) for k, v in m.items()}})
    del state, tree
    ref = torch.load(single_path, mmap=True, weights_only=True)
    sq, digests = {}, {}
    for n, p in leaves.items():
        sl = sharding.shard_slices(device_mesh, p.shape,
                                   collectives.spec_of(p))
        want = ref[n].reshape(p.shape)[sl].to(dev)
        got = sharding.local(p).detach()
        block = str([(s.start, s.stop) for s in sl])
        sq[n] = (block, float((got - want).double().square().sum()),
                 float((want - init[n]).double().square().sum()))
        digests[n] = (block, _digest(got))
        del want
    dist.barrier()
    return {"rank": rank, "coords": tuple(device_mesh.get_coordinate()),
            "build_s": build_s, "steps": rows,
            "restored_bit_equal": restored, "update_sq": sq,
            "digests": digests, **mem}


def _update_gaps(ranks) -> dict:
    """Each leaf's ||p_mesh - p_one|| / ||p_one - p_init|| over its
    distinct blocks (replicas counted once)."""
    parts: dict = {}
    for r in ranks:
        for n, (block, err, upd) in r["update_sq"].items():
            parts.setdefault(n, {})[block] = (err, upd)
    out = {}
    for n, blocks in parts.items():
        err = sum(e for e, _ in blocks.values())
        upd = sum(u for _, u in blocks.values())
        out[n] = (err ** 0.5) / max(upd ** 0.5, 1e-30)
    return out


def _save_zero_restore(torch, ckpt, train_lib, cfg, tree, ckpt_dir,
                       step) -> bool:
    """Save `tree` (a mesh's), zero its leaves in place, restore the
    checkpoint into them: whether every shard came back bit for bit."""
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.launch import sharding

    ckpt.save(ckpt_dir, step, tree, cfg=cfg)
    flat = _flatten(tree)
    saved = [sharding.local(t).clone() for _, t in flat]
    with torch.no_grad():
        for _, t in flat:
            sharding.local(t).zero_()
    _, by_path = ckpt.restore(ckpt_dir, step)
    train_lib._restore_into(cfg, tree, by_path)
    return all(torch.equal(sharding.local(t), s)
               for (_, t), s in zip(flat, saved))


def _deterministic(torch) -> None:
    """Deterministic algorithms in a rank (as the trainer's
    --deterministic): a 1 x 1 world against one process is then held bit
    for bit."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)


def _mesh_opt_cfg(n_steps: int):
    """AdamW as train_lm runs it, float32 moments (`steps.default_opt_cfg`
    keeps bf16 moments for models past 2e11 parameters, which a cut
    model is not, and counts a model's parameters by whole periods of
    its pattern, which jamba's one layer is not)."""
    from repro_torch.optim import adamw

    return adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                             total_steps=n_steps + 1,
                             moment_dtype="float32")


def _train_single(torch, cfg, opt_cfg, data, n_steps: int,
                  single_path) -> None:
    """The one-process run train_lm_mesh holds the ranks against: the same
    model, batches and steps with mesh None; its final leaves saved to
    `single_path`, its steps beside them."""
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw

    dev = torch.device("cuda", torch.cuda.current_device())
    model = tfm.init_model(cfg, seed=LM_SEED, device=dev, train=True)
    leaves = tfm.train_leaves(model, cfg)
    state = adamw.init(leaves, opt_cfg)
    fn = steps.make_train_step(cfg, None, opt_cfg)
    rows = []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = fn(model, state, to_device(data.batch(i), dev))
        torch.cuda.synchronize()
        rows.append({"step": i, "s": time.perf_counter() - t0,
                     **{k: float(v) for k, v in m.items()}})
    torch.save({n: p.detach().cpu() for n, p in leaves.items()},
               single_path)
    torch.save(rows, single_path + ".steps")
    del model, leaves, state
    _free(torch)


def phase_train_lm_mesh(torch) -> None:
    """LM training over ranks at full width with depth cut
    (`lm_mesh_train_runs`, float32 leaves): yi-9b 2 of 48 layers, B 8 x S
    512, 3 AdamW steps; the models whose recurrent mixers split over
    "model", xlstm-350m 4 of 24 layers and jamba-1.5-large-398b 1 of 72,
    B 8 x S 128, one step each.  First on an NCCL world of min(cards, 4)
    ranks (its rank 0 first runs each one-process reference), then on 8
    gloo ranks sharing the card as (2, 4), which saves yi-9b's checkpoint
    before its last step and restores it."""
    import shutil

    from repro_torch.launch import mesh as mesh_mod

    card = nvidia_smi()
    runs = lm_mesh_train_runs()
    for arch, (layers, batch, seq, n_steps) in runs.items():
        emit({"phase": "train_lm_mesh_cut", "arch": arch,
              "layers": f"{layers} of {_full_layers(arch)}",
              "widths": "full", "leaves": "float32", "batch": batch,
              "seq": seq, "steps": n_steps})
    shutil.rmtree(LM_MESH_DIR, ignore_errors=True)
    single_dir = LM_MESH_DIR / "single"
    single_dir.mkdir(parents=True)
    _free(torch)
    n = min(torch.cuda.device_count(), NCCL_MAX_RANKS)
    worlds = {
        "nccl": mesh_mod.spawn(
            rank_lm_train, n, backend="nccl", device="cuda",
            timeout_s=RANK_TIMEOUT_S, mesh_shape=(1, n),
            args=(str(single_dir), None)),
        "gloo": mesh_mod.spawn(
            rank_lm_train, LM_MESH[0] * LM_MESH[1], backend="gloo",
            device="cuda", timeout_s=RANK_TIMEOUT_S, mesh_shape=LM_MESH,
            args=(str(single_dir), str(LM_MESH_DIR / "ckpt_gloo"))),
    }
    for arch, (layers, _, _, n_steps) in runs.items():
        single = torch.load(single_dir / f"{arch}.steps")
        rtols = (LM_MESH_LOSS_RTOL_BY_ARCH.get(arch, LM_MESH_LOSS_RTOL),
                 LM_MESH_GNORM_RTOL_BY_ARCH.get(arch, LM_MESH_GNORM_RTOL))
        for name, world in worlds.items():
            _check_train_world(torch, card, arch, layers, n_steps, name,
                               [r[arch] for r in world], single, rtols, n)
    shutil.rmtree(LM_MESH_DIR, ignore_errors=True)


def _check_train_world(torch, card, arch, layers, n_steps, name, ranks,
                       single, rtols, n) -> None:
    """Print one world's run of `arch` and hold it: every rank's losses
    equal (and falling over several steps), a rank's leaves take its
    shards' bytes, replicas of each block bit-equal, yi-9b's checkpoint
    restored bit for bit (gloo), step 0's loss and gradient norm within
    `rtols` = (loss, norm) of one process's, each leaf's update within
    LM_MESH_UPDATE_RTOL, the NCCL 1 x 1 world bit-equal."""
    loss_rtol, gnorm_rtol = rtols
    gaps = _update_gaps(ranks)
    worst = max((g, leaf) for leaf, g in gaps.items())
    exact = all(e == 0.0 for r in ranks
                for _, e, _ in r["update_sq"].values())
    s0, o0 = ranks[0]["steps"][0], single[0]
    loss_gap = abs(s0["loss"] - o0["loss"]) / abs(o0["loss"])
    gnorm_gap = abs(s0["grad_norm"] - o0["grad_norm"]) / o0["grad_norm"]
    emit({"phase": "train_lm_mesh", "backend": name, "card": card,
          "mesh": list(LM_MESH) if name == "gloo" else [1, n],
          "arch": arch, "layers": layers,
          "build_s_ranks": [r["build_s"] for r in ranks],
          "steps_rank0": ranks[0]["steps"],
          "collective_bytes_per_step_ranks": [
              r["steps"][0]["collective_bytes"] for r in ranks],
          "collective_bytes_by_axis_per_step_ranks": [
              by_axis(r["steps"][0]["collective_bytes"]) for r in ranks],
          "step_s_ranks": [[s["s"] for s in r["steps"]] for r in ranks],
          "one_process_steps": single,
          "resident_bytes_ranks": [r["resident_bytes"] for r in ranks],
          "requested_bytes_ranks": [r["requested_bytes"] for r in ranks],
          "spec_shard_bytes_ranks": [r["spec_shard_bytes"] for r in ranks],
          "step0_loss_gap": loss_gap, "loss_rtol": loss_rtol,
          "step0_grad_norm_gap": gnorm_gap, "grad_norm_rtol": gnorm_rtol,
          "update_gap_worst": worst, "update_gaps": gaps,
          "update_rtol": LM_MESH_UPDATE_RTOL,
          "bit_equal_one_process": exact,
          "restored_bit_equal": [r["restored_bit_equal"] for r in ranks]})
    losses = [s["loss"] for s in ranks[0]["steps"]]
    where = f"train_lm_mesh {arch} {name}"
    for r in ranks:
        rank = f"{where}: rank {r['rank']}"
        check([s["loss"] for s in r["steps"]] == losses,
              f"{rank}'s losses differ from rank 0's")
        check(name != "gloo" or arch != LM_MESH_TRAIN_ARCH
              or r["restored_bit_equal"], f"{rank}'s state restored from "
              "the checkpoint differs from the state saved")
        check(r["requested_bytes"] == r["spec_shard_bytes"],
              f"{rank} holds {r['requested_bytes']} bytes of leaves, its "
              f"shards {r['spec_shard_bytes']}")
    # the replicas of each block of each leaf are bit-equal
    for leaf in ranks[0]["digests"]:
        by_block: dict = {}
        for r in ranks:
            sl, dg = r["digests"][leaf]
            by_block.setdefault(str(sl), set()).add(dg)
        check(all(len(d) == 1 for d in by_block.values()),
              f"{where}: ranks holding the same block of {leaf} differ")
    check(all(x == x for x in losses)
          and (n_steps == 1 or losses[-1] < losses[0]),
          f"{where}: the loss did not fall over {n_steps} steps: {losses}")
    check(loss_gap <= loss_rtol, f"{where}: step 0's loss differs from one "
          f"process's by {loss_gap} of it (limit {loss_rtol})")
    check(gnorm_gap <= gnorm_rtol, f"{where}: step 0's gradient norm "
          f"differs from one process's by {gnorm_gap} of it (limit "
          f"{gnorm_rtol})")
    check(worst[0] <= LM_MESH_UPDATE_RTOL, f"{where}: leaf {worst[1]}'s "
          f"update differs from one process's by {worst[0]} of its norm "
          f"(limit {LM_MESH_UPDATE_RTOL})")
    check(name != "nccl" or n != 1 or exact, f"{where}: the 1 x 1 world's "
          "leaves differ from the one-process run's")


# the port's four examples (examples/torch_*.py, the counterparts of the
# reference's quickstart.py, mrf_denoise.py, serve_lm.py and train_lm.py)
# at their smallest arguments, on the card (their default device), as
# subprocesses started together; the four within EXAMPLES_S
EXAMPLES = {
    "quickstart": [],
    "mrf_denoise": ["--size", "16", "--iters", "10"],
    "serve_lm": ["--batch", "2", "--prompt-len", "8", "--gen", "3"],
    "train_lm": ["--size", "2m", "--steps", "10"],
}
EXAMPLES_S = 60.0
EXAMPLE_TIMEOUT_S = 300.0


def _example_checks(name: str, out: str) -> dict:
    """The readings of an example's own printed check (quickstart: the
    total variation distance from exact inference; mrf_denoise: the noisy
    and denoised errors; serve_lm: each sampler's line; train_lm: the
    loss fell)."""
    if name == "quickstart":
        m = re.search(r"total variation distance: ([0-9.]+)", out)
        return {"tvd": float(m.group(1)) if m else None}
    if name == "mrf_denoise":
        m = re.search(r"noisy error ([0-9.]+) -> denoised error ([0-9.]+)",
                      out)
        return {"noisy_error": float(m.group(1)) if m else None,
                "denoised_error": float(m.group(2)) if m else None}
    if name == "serve_lm":
        return {"samplers": re.findall(r"\[serve_lm\] +(\w+) *:", out)}
    return {"loss_decreased": "[train_lm] loss decreased" in out}


def phase_examples(torch) -> None:
    """The four examples on the card, as a user runs them (`python
    examples/torch_<name>.py` with EXAMPLES' arguments, the kernels
    already built), started together: each exits 0 and prints its own
    check and "OK" last, the four within EXAMPLES_S.  Prints each one's
    seconds on a phase_seconds line."""
    import shutil

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    work = ROOT / "build" / "examples"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    procs, logs = {}, {}
    t0 = time.perf_counter()
    for name, args in EXAMPLES.items():
        argv = [sys.executable, str(ROOT / "examples" / f"torch_{name}.py"),
                *args]
        if name == "train_lm":
            argv += ["--ckpt-dir", str(work / "ckpt")]
        logs[name] = (work / f"{name}.out", work / f"{name}.err")
        with open(logs[name][0], "w") as out, open(logs[name][1], "w") as err:
            procs[name] = subprocess.Popen(argv, cwd=work, env=env,
                                           stdout=out, stderr=err)
    ends: dict = {}
    while len(ends) < len(procs):
        late = time.perf_counter() - t0 > EXAMPLE_TIMEOUT_S
        for name, proc in procs.items():
            if name in ends:
                continue
            if proc.poll() is not None:
                ends[name] = time.perf_counter() - t0
            elif late:
                proc.kill()
                proc.wait()
                ends[name] = None
        time.sleep(0.05)
    wall = time.perf_counter() - t0
    readings = {}
    for name, (out, err) in logs.items():
        text = out.read_text()
        readings[name] = {"rc": procs[name].returncode, "s": ends[name],
                          "last_line": (text.strip().splitlines()
                                        or [""])[-1],
                          **_example_checks(name, text)}
    emit({"phase_seconds": "examples", "s": wall, "card": nvidia_smi(),
          "examples": readings})
    for name, r in readings.items():
        tail = logs[name][1].read_text()[-2000:]
        check(r["s"] is not None, f"example {name} ran past "
              f"{EXAMPLE_TIMEOUT_S} s")
        check(r["rc"] == 0 and r["last_line"].endswith("OK"),
              f"example {name} exited {r['rc']}: {tail}")
    q, m = readings["quickstart"], readings["mrf_denoise"]
    check(q["tvd"] is not None and q["tvd"] < 0.05, f"quickstart: TVD "
          f"{q['tvd']}")
    check(m["denoised_error"] is not None
          and m["denoised_error"] < m["noisy_error"],
          f"mrf_denoise: {m}")
    check(readings["serve_lm"]["samplers"] == ["ky", "gumbel", "greedy"],
          f"serve_lm: {readings['serve_lm']}")
    check(readings["train_lm"]["loss_decreased"], "train_lm: the loss did "
          "not fall")
    check(wall <= EXAMPLES_S, f"the four examples took {wall} s (limit "
          f"{EXAMPLES_S})")
    shutil.rmtree(work, ignore_errors=True)


def phase_train_block(torch) -> None:
    """One yi-9b layer at full width in float32 (TF32 off), B = 1 x S =
    1,024: the loss mean(y^2) and the gradient of every leaf and of the
    input on the card against the CPU's, within BLOCK_RTOL of each
    gradient's largest |g|; then the flash backward at yi-9b's head
    geometry against the naive oracle under autograd, on the card."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers
    from repro_torch.models import transformer as tfm

    _free(torch)
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=1,
                              dtype="float32")
    cpu, dev = torch.device("cpu"), torch.device(DEVICE)
    blk_cpu = tfm.init_block(torch.Generator().manual_seed(LM_SEED), cfg, 0,
                             cpu).requires_grad_(True)
    blk = copy.deepcopy(blk_cpu).to(dev)  # Module.to moves in place
    g = torch.Generator().manual_seed(LM_SEED + 5)
    x_cpu = torch.randn((1, BLOCK_SEQ, cfg.d_model), generator=g)
    res = {}
    for name, p, x in (("cpu", blk_cpu, x_cpu), ("card", blk, x_cpu.to(dev))):
        x = x.clone().requires_grad_(True)
        pos = torch.arange(BLOCK_SEQ, dtype=torch.int32, device=x.device)
        t0 = time.perf_counter()
        y, _ = tfm.block_apply(p, x, cfg, 0, pos)
        loss = y.square().mean()
        params = dict(p.named_parameters())
        grads = torch.autograd.grad(loss, [x, *params.values()])
        if name == "card":
            torch.cuda.synchronize()
        res[name] = {"loss": float(loss.detach()),
                     "s": time.perf_counter() - t0,
                     "grads": dict(zip(["input", *params],
                                       [t.cpu() for t in grads]))}
    ratios = {}
    for n, want in res["cpu"]["grads"].items():
        got = res["card"]["grads"][n]
        ratios[n] = float((got - want).abs().max() / want.abs().max())
    loss_rel = abs(res["card"]["loss"] - res["cpu"]["loss"]) / res["cpu"][
        "loss"]

    # the flash backward alone at yi's heads: 32 query heads over 4 KV
    # heads of 128, against attention_reference under autograd
    shapes = ((1, BLOCK_SEQ, cfg.n_heads, cfg.hd),
              (1, BLOCK_SEQ, cfg.n_kv_heads, cfg.hd),
              (1, BLOCK_SEQ, cfg.n_kv_heads, cfg.hd))
    gd = torch.Generator(device=dev).manual_seed(LM_SEED + 6)
    q, k, v = (torch.randn(s, generator=gd, device=dev) * 0.3
               for s in shapes)
    dout = torch.randn(shapes[0], generator=gd, device=dev)
    flash = {}
    for name, fn in (("flash", lambda *a: layers.flash_attention(*a)),
                     ("naive", lambda *a: layers.attention_reference(*a))):
        xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        flash[name] = torch.autograd.grad(fn(*xs), xs, dout)
    flash_ratios = [float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(flash["flash"], flash["naive"])]
    emit({"phase": "train_block", "arch": cfg.name, "seq": BLOCK_SEQ,
          "dtype": "float32", "rtol": BLOCK_RTOL,
          "params": sum(t.numel() for t in blk.parameters()),
          "loss_cpu": res["cpu"]["loss"], "loss_card": res["card"]["loss"],
          "loss_rel": loss_rel, "cpu_s": res["cpu"]["s"],
          "card_s": res["card"]["s"], "grad_max_rel": max(ratios.values()),
          "grad_rel": ratios, "flash_vs_naive_rel": {
              "dq": flash_ratios[0], "dk": flash_ratios[1],
              "dv": flash_ratios[2]}, "flash_rtol": FLASH_RTOL})
    check(loss_rel <= BLOCK_RTOL, f"train_block: loss {res['card']['loss']}"
          f" on the card, {res['cpu']['loss']} on the CPU")
    bad = {n: r for n, r in ratios.items() if not r <= BLOCK_RTOL}
    check(not bad, f"train_block: gradients differ from the CPU's: {bad}")
    check(all(r <= FLASH_RTOL for r in flash_ratios),
          f"train_block: the flash backward differs from the naive "
          f"oracle's: {flash_ratios}")
    del blk, blk_cpu, flash
    _free(torch)


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
    out["device_k3_lanes_ms"] = device_ms(torch, k3, 50, K3_KERNEL)
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
    ms = device_ms(torch, k3, 50, K3_KERNEL)
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
    ms = device_ms(torch, k4, 50, K4_KERNEL)
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
