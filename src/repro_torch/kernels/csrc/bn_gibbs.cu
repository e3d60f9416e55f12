// K3: one whole Bayes-net Gibbs sweep (every colour round) per launch, for
// one query or the Q queries of a serving bucket (`bn_lanes_kernel`), and
// K5: one colour round over every position of a mesh per launch
// (`bn_rounds_kernel`).
//
// K3 replaces the reference's Pallas kernel `fused_gibbs_sweep`
// (src/repro/kernels/bn_gibbs.py:236, body `bn_round_step` :137), which
// inlines K2's `interp_eval` and K1's `preprocess_lanes`, `ddg_walk` and
// `argmax_fallback`, and the vmap of it over a bucket's queries
// (src/repro/runtime/batcher.py:236).  Per round, for every (chain, node)
// row: CPT-address gather from the chain values, f32 factor sum left to
// right, card mask, max-subtract, LUT-exp (lut_ky) or exact exp quantised
// to 15 bits (exact_ky), KY walk, label store.
//
// K3's design (`bn_lanes_kernel<CAP, EXACT, CPW>`, entry
// `aia_bn_sweep_lanes`; one query is Q = 1 with the key by value):
//   * The sequential grid over rounds becomes a loop over rounds inside one
//     block; a block owns CPW chains (32, 16, 8 or 4) of one query for the
//     whole sweep, so no state crosses blocks.  Each query's chains split
//     into ceil(B / CPW) blocks, the last one partial when CPW does not
//     divide B; the wrapper takes the widest CPW that still gives all 132
//     SMs a block.
//   * The chains' values are resident as bytes (cardinalities are below
//     128), node-major: node i's CPW chains at i * STRIDE, STRIDE an odd
//     number of words so that the transposing copy from and to the int32
//     (chain, node) layout in device memory falls in 32 banks.  The exp
//     LUT and, where the block stays within ~100 KB, the log-CPT arena are
//     staged beside them.
//   * Warp-uniform rows: a warp takes 32 / CPW nodes of the round at once,
//     each across the block's CPW chains (lane = node slot * CPW + chain).
//     Every table read (`rows`, `facs`, `slots`) is then one broadcast per
//     node slot, and the factor and slot loops' trip counts are uniform
//     across a node's lanes; only the chain values and the arena gathers
//     differ between lanes.
//   * Compact round tables (`bn_gibbs.LaneTables`, built once per table on
//     the device): each row's real factors and each factor's real scope
//     slots, in the padded table's order, with offsets.  The padded row's
//     trailing factors added the arena's 0.0 (x + 0.0 == x but for a
//     zero's sign, which the max subtraction erases) and its padded slots
//     stride 0, so skipping them leaves every label bit-equal.  Lanes v >=
//     card gather a clamped address, as the twin does, and are masked
//     after the sum, so the gather has no branch.
//   * Exact-width instances for nets of 2-4 values (CAP = v_max): the lane
//     loops, lerps and walk columns run over the net's bins only.
//   * The walk is K1's bit-plane walk (`aia::plane_draw`, `exact_walk`):
//     a step is one popcount of the level's column, the rejection bin held
//     apart; every row's bins and rejection bin sum to exactly 2^precision,
//     so the walk needs no sign-bit level.
//   * The one-hot MXU scatter becomes a byte store of the label.  The store
//     needs no barrier before the round ends: a node's gathers read only its
//     Markov blanket, and a proper colouring puts none of it in the node's
//     own round.  __syncthreads() separates the rounds.
//   * The random words are made inside the kernel, where the TPU kernel
//     read words that XLA generated before the call (`jax.random.bits`
//     outside the Pallas kernel, src/repro/kernels/bn_gibbs.py:216).  The
//     block's query's sweep key comes from a (Q, 2) int32 array (or by
//     value); round r's key is `prng.split(key, R)[r]`, the threefry hash of
//     the counter pair (0, r).  Row (chain, c) of round r owns counters
//     `row_word_index` (bn_gibbs.py) of that round's stream, the chain
//     counted within its query, so every query draws the words of its
//     standalone sweep; its walk hashes word j (`aia::WordsFromKey`) only
//     when it reaches step 32 j.
//
// Bound on the H100 (`launch/kernel_cost.py`): the threefry calls, then
// bytes.  A sweep must read and write the (Q B, n) values once (29.3 MB
// for pigs at 8 x 1,024: 8.7 us at 3.35 TB/s) and hash one threefry call
// per 32 walk steps of every row (3.6 M calls, 8.9 us: 41 bit operations a
// call on the ALU pipe).  What holds it above: instruction issue.  A warp
// pays for its slowest lane's walk (a row walks 2-3 levels on average, the
// warp's slowest 7-8), and each row's gather, four lerps and the
// preprocessing's integer division run a few hundred instructions more
// (PERF.md's kernel findings).
//
// K5 replaces the reference's Pallas kernel `fused_color_round`
// (src/repro/kernels/bn_gibbs.py:316), which runs the same `bn_round_step`
// body as a grid=(1,) call over one shard's slice of one round; the
// reference's sharded engine calls it on every device of its mesh between
// the psum merges.  Here one launch runs round r on every position of a
// (chain positions x node positions) mesh (`bn_rounds_kernel<VCAP>`):
//   * the position is the block's outer index and its chain block is split
//     into blocks of `chains_per_block` chains, held as int32 (chains x n)
//     in shared memory; every block stages its chains' pre-round values,
//     as every device of the reference reads its own pre-round copy;
//   * a thread takes (chain, node) rows of the round over the padded
//     table, the position's slice of `ShardedFusedRounds` (positions,
//     rounds, lanes, ...), whose pad lanes trail the n_own owned lanes and
//     are never processed, and draws with K3's walk (`aia::plane_draw`);
//   * a row draws from round r's key of the sweep key, like K3's, at the
//     counters of the round's full stream: `owned_row_word_index`
//     (bn_gibbs.py), the global chain times the round's full node count
//     n_c[r] plus the owned node's place `word_pos` in the full group.  So
//     the draws are the single-device round's, whatever the mesh;
//   * each node position writes its chains' full values into its own plane
//     of an (n_node_pos, B, n) stack: the collective stays outside the
//     kernel (`distributed._psum_merge` sums the planes' deltas), where a
//     mesh over several cards puts a cross-card all_reduce.
// Bound: bytes.  Each node position reads and writes the (B, n) values
// once (4 x 3.6 MB for pigs on a (2, 4) mesh); the hash is a quarter of
// K3's (one round's rows).

#include "aia_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;

struct RoundsArgs {
  const int* vals_in;  // (n_chain_pos * b_loc, n): the launch's chains
  int* vals_out;       // (n_node_pos, n_chain_pos * b_loc, n)
  long long chain_base;  // global chain of vals_in's first row (counters)
  int n_chain_pos, b_loc, d0, n_node_pos, n, chains_per_block;
  int blocks_per_pos;
  // tables of n_dev positions x R rounds; rounds r0 .. r0 + n_r - 1 run
  int R, r0, n_r;
  const int* n_rows;  // (n_dev, R) lanes processed per position and round
  const int* n_full;  // (R,) the round's full node count (counter stride)
  int c_max, f_max, s_max;
  const int* nodes;     // (n_dev, R, c_max)
  const int* cards;     // (n_dev, R, c_max)
  const int* base;      // (n_dev, R, c_max * f_max)
  const int* stride;    // (n_dev, R, c_max * f_max * s_max)
  const int* scope;     // (n_dev, R, c_max * f_max * s_max)
  const int* is_self;   // (n_dev, R, c_max * f_max * s_max)
  const int* word_pos;  // (n_dev, R, c_max) lane's place in the full
                        // group (K5; K3's lane is its place)
  unsigned k1, k2;      // the sweep's key; round r draws from (0, r)'s hash
  int n_words;
  const float* logf;  // (T,) log-CPT arena
  const float* tab;   // (lut_size,) exp-weight LUT
  int lut_size;
  float x0, inv_dx;
  int v_max, exact, weight_bits, precision, total_steps;
};

// One (chain, lane) row of one round: gather, factor sum, weights, KY walk.
template <int VCAP>
__device__ __forceinline__ int draw_row(const RoundsArgs& a, const float* tab,
                                        const int* vrow, long long t, int c,
                                        const aia::WordsFromKey& words) {
  const int fs = a.f_max * a.s_max;
  const int* base = a.base + t * a.c_max * a.f_max;
  const int* stride = a.stride + t * a.c_max * fs;
  const int* scope = a.scope + t * a.c_max * fs;
  const int* is_self = a.is_self + t * a.c_max * fs;
  const int card = __ldg(a.cards + t * a.c_max + c);

  // --- flat-CPT gather + f32 factor sum, left to right ---
  float logp[VCAP];
#pragma unroll
  for (int v = 0; v < VCAP; ++v) logp[v] = 0.0f;
  for (int f = 0; f < a.f_max; ++f) {
    int fixed = __ldg(base + c * a.f_max + f);
    int self_stride = 0;
    const int slot = (c * a.f_max + f) * a.s_max;
    for (int s = 0; s < a.s_max; ++s) {
      const int st = __ldg(stride + slot + s);
      if (st == 0) continue;  // padded scope slot: adds stride 0
      if (__ldg(is_self + slot + s))
        self_stride += st;
      else
        fixed += st * vrow[__ldg(scope + slot + s)];
    }
#pragma unroll
    for (int v = 0; v < VCAP; ++v) {
      if (v < card) {
        float x = __ldg(a.logf + fixed + self_stride * v);
        logp[v] = (f == 0) ? x : __fadd_rn(logp[v], x);
      }
    }
  }
  float mx = kNegInf;
#pragma unroll
  for (int v = 0; v < VCAP; ++v) {
    if (v < a.v_max) {
      if (v >= card) logp[v] = kNegInf;
      mx = fmaxf(mx, logp[v]);
    }
  }

  // --- C2: LUT-exp (or the exact-exp ablation) -> integer weights ---
  int w[VCAP];
  if (!a.exact) {
#pragma unroll
    for (int v = 0; v < VCAP; ++v) {
      float y = aia::lut_interp(__fsub_rn(logp[v], mx), tab, a.x0, a.inv_dx,
                                a.lut_size);
      w[v] = (v < a.v_max) ? (int)fmaxf(rintf(y), 0.0f) : 0;
    }
  } else {
    const float top = (float)((1 << a.weight_bits) - 1);
    float p[VCAP];
    float pmax = 0.0f;
#pragma unroll
    for (int v = 0; v < VCAP; ++v) {
      p[v] = (v < a.v_max) ? expf(__fsub_rn(logp[v], mx)) : 0.0f;
      pmax = fmaxf(pmax, p[v]);
    }
    const float scale = __fdiv_rn(top, fmaxf(pmax, 1e-30f));
#pragma unroll
    for (int v = 0; v < VCAP; ++v) {
      float q = fminf(fmaxf(rintf(__fmul_rn(p[v], scale)), 0.0f), top);
      w[v] = (v < a.v_max) ? (int)q : 0;
    }
  }

  // --- C1: KY over v_max bins, walked over bit planes ---
  return aia::plane_draw<VCAP>(w, a.v_max, a.precision, a.total_steps,
                               words);
}

template <int VCAP>
__global__ void bn_rounds_kernel(RoundsArgs a) {
  extern __shared__ int smem[];
  int* vals = smem;                                        // chains x n
  float* tab = (float*)(smem + a.chains_per_block * a.n);  // lut_size
  // block -> (position, chain block); a position is (chain pos, node pos)
  const int pos = blockIdx.x / a.blocks_per_pos;
  const int inner = blockIdx.x - pos * a.blocks_per_pos;
  const int ci = pos / a.n_node_pos;
  const int dd = pos - ci * a.n_node_pos;
  const int d = a.d0 + dd;
  const int first = inner * a.chains_per_block;  // within the position
  const int nch = min(a.chains_per_block, a.b_loc - first);
  const long long row0 = (long long)ci * a.b_loc + first;  // launch row
  const int* vin = a.vals_in + row0 * a.n;
  for (int i = threadIdx.x; i < nch * a.n; i += blockDim.x) vals[i] = vin[i];
  for (int i = threadIdx.x; i < a.lut_size; i += blockDim.x) tab[i] = a.tab[i];
  __syncthreads();

  for (int r = a.r0; r < a.r0 + a.n_r; ++r) {
    const long long t = (long long)d * a.R + r;  // the table's (d, r)
    const int nc = a.n_rows[t];
    const unsigned long long n_full = (unsigned)a.n_full[r];
    // bn_gibbs.round_key: prng.split(key, R)[r] hashes the pair (0, r)
    const uint2 rk = aia::threefry2x32(a.k1, a.k2, 0u, (unsigned)r);
    const int* nodes = a.nodes + t * a.c_max;
    const int* wpos = a.word_pos + t * a.c_max;
    for (int row = threadIdx.x; row < nch * nc; row += blockDim.x) {
      const int b = row / nc;
      const int c = row - b * nc;
      int* vrow = vals + b * a.n;
      // bn_gibbs.owned_row_word_index: (global chain * n_c[r] + the
      // lane's place in the full group) * n_words, 64-bit
      const unsigned long long chain =
          (unsigned long long)(a.chain_base + row0 + b);
      const unsigned long long place = (unsigned)__ldg(wpos + c);
      const aia::WordsFromKey src{rk.x, rk.y,
                                  (chain * n_full + place) * a.n_words};
      vrow[nodes[c]] = draw_row<VCAP>(a, tab, vrow, t, c, src);
    }
    __syncthreads();
  }

  const long long plane = (long long)a.n_chain_pos * a.b_loc * a.n;
  int* vout = a.vals_out + dd * plane + row0 * a.n;
  for (int i = threadIdx.x; i < nch * a.n; i += blockDim.x) vout[i] = vals[i];
}

template <int VCAP>
int launch(const RoundsArgs& a, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks =
      (long long)a.n_chain_pos * a.n_node_pos * a.blocks_per_pos;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(int) * (size_t)a.chains_per_block * a.n +
      sizeof(float) * (size_t)a.lut_size;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bn_rounds_kernel<VCAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bn_rounds_kernel<VCAP><<<(unsigned)blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(RoundsArgs& a, cudaStream_t s) {
  if (a.chains_per_block < 1 || a.b_loc < 1 || a.n_chain_pos < 1 ||
      a.n_node_pos < 1)
    return (int)cudaErrorInvalidValue;
  a.blocks_per_pos = (a.b_loc + a.chains_per_block - 1) / a.chains_per_block;
  const int lanes = a.v_max + 1;
  if (lanes <= 4) return launch<4>(a, s);
  if (lanes <= 8) return launch<8>(a, s);
  if (lanes <= 16) return launch<16>(a, s);
  if (lanes <= 32) return launch<32>(a, s);
  if (lanes <= 128) return launch<128>(a, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K3's lane entry: warp-uniform rows over compact round tables
// ---------------------------------------------------------------------------

struct LanesArgs {
  const int* vals_in;  // (Q * B, n) int32, query q's chains rows [q B, ...)
  int* vals_out;       // (Q * B, n) int32
  int Q, B, n, blocks_per_query, R;
  const int* round_rows;  // (R + 1,) round r's rows: [rr[r], rr[r + 1])
  const int4* rows;  // a row (round, place c): {node, card, factors [z, w)}
  const int4* facs;  // a factor: {base, slots [y, z), 0}
  const int2* slots;  // a scope slot: {stride, 2 * scope + is_self}
  const int* keys;    // (Q, 2) a key per query, or null: (k1, k2) for all
  unsigned k1, k2;
  int n_words;
  const float* logf;  // (arena,) log-CPT arena
  int arena, stage_arena;
  const float* tab;   // (lut_size,) exp-weight LUT
  int lut_size;
  float x0, inv_dx;
  int v_max, exact, weight_bits, precision, total_steps;
};

// A block holds CPW chains of one query; a warp takes NPW nodes of a round
// at once, each across the CPW chains (lane = node slot * CPW + chain).
// The chains' values are bytes, node-major: node i's CPW chains at
// i * STRIDE, STRIDE an odd number of words so that the transposing copy
// in and out (consecutive threads on consecutive nodes of one chain) hits
// 32 banks.
template <int CPW>
struct LaneShape {
  static constexpr int NPW = 32 / CPW;
  static constexpr int STRIDE = 4 * ((CPW / 4) | 1);
};

// One row (node, chain b of the block) of a round over the compact
// tables: the padded row's gather, factor sum, weights and draw with its
// padding skipped.  A padded factor added the arena's 0.0 to each lane
// (x + 0.0 == x but for a zero's sign, which the max subtraction erases);
// a padded scope slot added stride 0.  Lanes v >= card gather a clamped
// address, as the twin does, and are masked after the sum, so the loads
// need no branch.  N = CAP bins when EXACT, else the runtime v_max <= CAP.
template <int CAP, bool EXACT, int STRIDE>
__device__ __forceinline__ int lanes_row(const LanesArgs& a,
                                         const float* cpt, const float* tab,
                                         const unsigned char* vals, int b,
                                         int4 row,
                                         const aia::WordsFromKey& words) {
  const int n = EXACT ? CAP : a.v_max;
  const int card = row.y;
  const int last = a.arena - 1;
  // --- flat-CPT gather + f32 factor sum, left to right ---
  float logp[CAP];
#pragma unroll
  for (int v = 0; v < CAP; ++v) logp[v] = 0.0f;
  for (int f = row.z; f < row.w; ++f) {
    const int4 fac = __ldg(a.facs + f);
    int fixed = fac.x;
    int self_stride = 0;
    for (int s = fac.y; s < fac.z; ++s) {
      const int2 sl = __ldg(a.slots + s);
      if (sl.y & 1)
        self_stride += sl.x;
      else
        fixed += sl.x * (int)vals[(sl.y >> 1) * STRIDE + b];
    }
#pragma unroll
    for (int v = 0; v < CAP; ++v) {
      if (EXACT || v < n) {
        const float x = cpt[min(fixed + self_stride * v, last)];
        logp[v] = (f == row.z) ? x : __fadd_rn(logp[v], x);
      }
    }
  }
  float mx = kNegInf;
#pragma unroll
  for (int v = 0; v < CAP; ++v) {
    if (EXACT || v < n) {
      if (v >= card) logp[v] = kNegInf;
      mx = fmaxf(mx, logp[v]);
    }
  }

  // --- C2: LUT-exp (or the exact-exp ablation) -> integer weights ---
  int w[CAP];
  if (!a.exact) {
#pragma unroll
    for (int v = 0; v < CAP; ++v) {
      w[v] = 0;
      if (EXACT || v < n) {
        const float y = aia::lut_interp(__fsub_rn(logp[v], mx), tab, a.x0,
                                        a.inv_dx, a.lut_size);
        w[v] = (int)fmaxf(rintf(y), 0.0f);
      }
    }
  } else {
    const float top = (float)((1 << a.weight_bits) - 1);
    float p[CAP];
    float pmax = 0.0f;
#pragma unroll
    for (int v = 0; v < CAP; ++v) {
      p[v] = (EXACT || v < n) ? expf(__fsub_rn(logp[v], mx)) : 0.0f;
      pmax = fmaxf(pmax, p[v]);
    }
    const float scale = __fdiv_rn(top, fmaxf(pmax, 1e-30f));
#pragma unroll
    for (int v = 0; v < CAP; ++v) {
      const float q = fminf(fmaxf(rintf(__fmul_rn(p[v], scale)), 0.0f), top);
      w[v] = (EXACT || v < n) ? (int)q : 0;
    }
  }

  // --- C1: KY over v_max bins, walked over bit planes ---
  return aia::plane_draw<CAP>(w, n, a.precision, a.total_steps, words);
}

template <int CAP, bool EXACT, int CPW>
__global__ void __launch_bounds__(512, CAP <= 8 ? 2 : 1)
    bn_lanes_kernel(LanesArgs a) {
  using S = LaneShape<CPW>;
  extern __shared__ int smem[];
  float* tab = reinterpret_cast<float*>(smem);  // lut_size
  float* arena = tab + a.lut_size;              // arena, when staged
  unsigned char* vals = reinterpret_cast<unsigned char*>(
      arena + (a.stage_arena ? a.arena : 0));   // n x STRIDE bytes
  const int q = blockIdx.x / a.blocks_per_query;
  const int first = (blockIdx.x - q * a.blocks_per_query) * CPW;
  const int nch = min(CPW, a.B - first);
  const long long row0 = (long long)q * a.B + first;
  const int* vin = a.vals_in + row0 * a.n;
  // flat element f = b * n + i of the block's chains, f stepping by the
  // block: (b, i) advance by (step_b, step_i) with one carry, no division
  const int step_b = blockDim.x / a.n;
  const int step_i = blockDim.x - step_b * a.n;
  const int b0 = threadIdx.x / a.n;
  const int i0 = threadIdx.x - b0 * a.n;
  for (int b = b0, i = i0, f = threadIdx.x; b < nch; f += blockDim.x) {
    vals[i * S::STRIDE + b] = (unsigned char)vin[f];
    i += step_i;
    b += step_b;
    if (i >= a.n) {
      i -= a.n;
      ++b;
    }
  }
  for (int i = threadIdx.x; i < a.lut_size; i += blockDim.x) tab[i] = a.tab[i];
  if (a.stage_arena)
    for (int i = threadIdx.x; i < a.arena; i += blockDim.x)
      arena[i] = a.logf[i];
  const float* cpt = a.stage_arena ? arena : a.logf;
  // the sweep's key: the block's query's, or the launch's
  const unsigned k1 = a.keys ? (unsigned)__ldg(a.keys + 2 * q) : a.k1;
  const unsigned k2 = a.keys ? (unsigned)__ldg(a.keys + 2 * q + 1) : a.k2;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int step = (blockDim.x >> 5) * S::NPW;  // node slots a block pass
  const int b = lane % CPW;                       // the lane's chain
  for (int r = 0; r < a.R; ++r) {
    const int rbeg = __ldg(a.round_rows + r);
    const int nc = __ldg(a.round_rows + r + 1) - rbeg;
    // bn_gibbs.round_key: prng.split(key, R)[r] hashes the pair (0, r)
    const uint2 rk = aia::threefry2x32(k1, k2, 0u, (unsigned)r);
    for (int c = warp * S::NPW + lane / CPW; c < nc; c += step) {
      if (b >= nch) continue;
      const int4 row = __ldg(a.rows + rbeg + c);
      // bn_gibbs.row_word_index: (chain within the query * n_c[r] + c)
      // * n_words, 64-bit
      const aia::WordsFromKey src{
          rk.x, rk.y,
          ((unsigned long long)(first + b) * nc + c) * a.n_words};
      // a node's gathers read only its Markov blanket, none of which a
      // proper colouring puts in its own round: no barrier before the
      // round ends
      vals[row.x * S::STRIDE + b] =
          (unsigned char)lanes_row<CAP, EXACT, S::STRIDE>(a, cpt, tab, vals,
                                                          b, row, src);
    }
    __syncthreads();
  }

  int* vout = a.vals_out + row0 * a.n;
  for (int bb = b0, i = i0, f = threadIdx.x; bb < nch; f += blockDim.x) {
    vout[f] = vals[i * S::STRIDE + bb];
    i += step_i;
    bb += step_b;
    if (i >= a.n) {
      i -= a.n;
      ++bb;
    }
  }
}

template <int CAP, bool EXACT, int CPW>
int launch_lanes(LanesArgs& a, int threads, cudaStream_t stream) {
  a.blocks_per_query = (a.B + CPW - 1) / CPW;
  const long long blocks = (long long)a.Q * a.blocks_per_query;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)a.lut_size + (a.stage_arena ? a.arena : 0)) +
      (size_t)a.n * LaneShape<CPW>::STRIDE;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bn_lanes_kernel<CAP, EXACT, CPW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bn_lanes_kernel<CAP, EXACT, CPW>
      <<<(unsigned)blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int CAP, bool EXACT>
int lanes_cpw(LanesArgs& a, int cpw, int threads, cudaStream_t s) {
  switch (cpw) {
    case 32: return launch_lanes<CAP, EXACT, 32>(a, threads, s);
    case 16: return launch_lanes<CAP, EXACT, 16>(a, threads, s);
    case 8: return launch_lanes<CAP, EXACT, 8>(a, threads, s);
    case 4: return launch_lanes<CAP, EXACT, 4>(a, threads, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Exact-width instances for nets of 2-4 values at most (binary nets,
// pigs' 3), a runtime bound within 8, 16, 32 or 127 bins beyond.
int dispatch_lanes(LanesArgs& a, int cpw, int threads, cudaStream_t s) {
  switch (a.v_max) {
    case 2: return lanes_cpw<2, true>(a, cpw, threads, s);
    case 3: return lanes_cpw<3, true>(a, cpw, threads, s);
    case 4: return lanes_cpw<4, true>(a, cpw, threads, s);
  }
  if (a.v_max < 1) return (int)cudaErrorInvalidValue;
  if (a.v_max <= 8) return lanes_cpw<8, false>(a, cpw, threads, s);
  if (a.v_max <= 16) return lanes_cpw<16, false>(a, cpw, threads, s);
  if (a.v_max <= 32) return lanes_cpw<32, false>(a, cpw, threads, s);
  if (a.v_max <= 127) return lanes_cpw<128, false>(a, cpw, threads, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K3 lanes: one sweep of R rounds over Q queries of B chains each, vals
// (Q * B, n), query q drawing from its key keys[2 q], keys[2 q + 1] (or
// every query from (k1, k2) when keys is null), over the compact round
// tables; chains_per_warp is 32, 16, 8 or 4 (a block's chains), threads a
// multiple of 32 up to 512, stage_arena whether the log-CPT arena is
// copied into shared memory.
extern "C" int aia_bn_sweep_lanes(
    const int* vals_in, int* vals_out, int Q, int B, int n,
    int chains_per_warp, int threads, int R, const int* round_rows,
    const int* rows, const int* facs, const int* slots, const int* keys,
    unsigned k1, unsigned k2, int n_words, const float* logf, int arena,
    int stage_arena, const float* tab, int lut_size, float x0, float inv_dx,
    int v_max, int exact, int weight_bits, int precision, int total_steps,
    void* stream) {
  if (Q < 1 || B < 1 || n < 1 || R < 1 || threads < 32 || threads > 512 ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  LanesArgs a{vals_in, vals_out, Q, B, n, 0, R, round_rows,
              reinterpret_cast<const int4*>(rows),
              reinterpret_cast<const int4*>(facs),
              reinterpret_cast<const int2*>(slots), keys, k1, k2, n_words,
              logf, arena, stage_arena, tab, lut_size, x0, inv_dx, v_max,
              exact, weight_bits, precision, total_steps};
  return dispatch_lanes(a, chains_per_warp, threads, (cudaStream_t)stream);
}

// K5: round r of the sweep key (k1, k2) on node positions d0 .. d0 +
// n_node_pos - 1 of n_chain_pos chain blocks of b_loc chains each.
// vals_in holds the launch's n_chain_pos * b_loc chains, the first of which
// is chain chain_base of the run; vals_out is (n_node_pos,
// n_chain_pos * b_loc, n).  The tables are a `ShardedFusedRounds`
// ((n_dev, R, c_max, ...), n_own (n_dev, R), n_c (R,)).
extern "C" int aia_bn_color_round(
    const int* vals_in, int* vals_out, long long chain_base, int n_chain_pos,
    int b_loc, int d0, int n_node_pos, int n, int chains_per_block, int R,
    int r, const int* n_own, const int* n_c, int c_max, int f_max,
    int s_max, const int* nodes, const int* cards, const int* base,
    const int* stride, const int* scope, const int* is_self,
    const int* word_pos, unsigned k1, unsigned k2, int n_words,
    const float* logf, const float* tab, int lut_size, float x0,
    float inv_dx, int v_max, int exact, int weight_bits, int precision,
    int total_steps, void* stream) {
  if (r < 0 || r >= R || d0 < 0) return (int)cudaErrorInvalidValue;
  RoundsArgs a{vals_in, vals_out, chain_base, n_chain_pos, b_loc, d0,
               n_node_pos, n, chains_per_block, 0, R, r, 1, n_own, n_c,
               c_max, f_max, s_max, nodes, cards, base, stride, scope,
               is_self, word_pos, k1, k2, n_words, logf, tab, lut_size, x0,
               inv_dx, v_max, exact, weight_bits, precision, total_steps};
  return dispatch(a, (cudaStream_t)stream);
}
