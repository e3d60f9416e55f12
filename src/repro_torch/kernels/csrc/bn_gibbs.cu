// K3: one whole Bayes-net Gibbs sweep (every colour round) per launch, and
// K5: one colour round over every position of a mesh per launch.  Both are
// the one kernel below, `bn_rounds_kernel`, launched over other ranges.
//
// K3 replaces the reference's Pallas kernel `fused_gibbs_sweep`
// (src/repro/kernels/bn_gibbs.py:236, body `bn_round_step` :137), which
// inlines K2's `interp_eval` and K1's `preprocess_lanes`, `ddg_walk` and
// `argmax_fallback`.  Per round, for every (chain, node) row: CPT-address
// gather from the chain values, f32 factor sum left to right, card mask,
// max-subtract, LUT-exp (lut_ky) or exact exp quantised to 15 bits
// (exact_ky), KY walk, label store.
//
// Design, against the reference's TPU layout:
//   * The sequential grid over rounds becomes a loop over rounds inside one
//     block; blocks own disjoint chain blocks, so no state crosses blocks.
//   * A block holds its chains' (chains x n) int32 values in shared memory
//     for the whole sweep and writes them back once.
//   * A thread takes (chain, node) rows of the current round and keeps the
//     row's V log-probs, weights and walk state in registers.  The arena is
//     read through the read-only cache (it is tens of KB and stays in L2).
//   * The one-hot MXU scatter becomes a direct store of the label.  The
//     store needs no barrier before the round ends: a node's gathers read
//     only its Markov blanket, and a proper colouring puts none of it in
//     the node's own round.  __syncthreads() separates the rounds.
//   * The random words are made inside the kernel, where the TPU kernel
//     read words that XLA generated before the call (`jax.random.bits`
//     outside the Pallas kernel, src/repro/kernels/bn_gibbs.py:216).  The
//     kernel takes the sweep's key by value; round r's key is
//     `prng.split(key, R)[r]`, the threefry hash of the counter pair
//     (0, r), derived at the top of the round.  Row (chain, c) of round r
//     owns counters `row_word_index` (bn_gibbs.py) of that round's stream,
//     and its walk hashes word j (`aia::WordsFromKey`) only when it reaches
//     step 32 j, so a row hashes the words it consumes (one, in most rows)
//     and no word crosses device memory.  The bits are the reference's:
//     threefry is counter-based.
//
// Bound on the H100: bytes, barely.  A sweep must read and write the
// (B, n) values once (3.6 MB for pigs at B = 1024; with the arena and the
// round tables ~1.2 us at 3.35 TB/s).  It must hash one threefry call per
// 32 walk steps of every row: ~450 k calls for pigs, each 41 bit
// operations (20 SHF rotates, 21 LOP3 xors) that only the ALU pipe runs,
// ~1.1 us on 132 SMs x 64 ALU lanes x the SM clock; its ~31 adds can issue
// on the FMA pipe (counts read from the SASS by chip_smoke's threefry
// phase).  The gather/lerp/walk arithmetic is tens of integer and float
// ops per row.
//
// K5 replaces the reference's Pallas kernel `fused_color_round`
// (src/repro/kernels/bn_gibbs.py:316), which runs the same `bn_round_step`
// body as a grid=(1,) call over one shard's slice of one round; the
// reference's sharded engine calls it on every device of its mesh between
// the psum merges.  Here one launch runs round r on every position of a
// (chain positions x node positions) mesh:
//   * the position is the block's outer index and its chain block is split
//     into blocks of `chains_per_block` chains; every block stages its
//     chains' pre-round values, as every device of the reference reads its
//     own pre-round copy;
//   * the round table is the position's slice of `ShardedFusedRounds`,
//     (positions, rounds, lanes, ...), whose pad lanes trail the n_own
//     owned lanes and are never processed;
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
//
// K3's lane entry (`aia_bn_sweep_lanes`) runs one sweep over the chains of
// Q queries at once, the serving runtime's bucket, where the reference
// vmaps `fused_gibbs_sweep` over the queries (src/repro/runtime/
// batcher.py:236).  The values are (Q * B, n), query q's chains the rows
// [q B, (q + 1) B), and each query has its own sweep key, read from a
// (Q, 2) int32 array in device memory (the wrapper copies a bucket's keys
// up once).  A chain position is a query here:
//   * a block never straddles two queries, because it hashes one round key
//     per round: each query's chains split into ceil(B / chains_per_block)
//     blocks, the last one partial when chains_per_block does not divide B;
//   * a row's words are counted from its chain within its query (the local
//     chain), so every query draws the words of its standalone sweep.
// Bound: bytes, as K3's, for Q * B chains.
//
// K3 is this kernel over one position (the whole batch) and all R rounds
// of an unsplit table; K5 over one round and a range of positions; K3's
// lane entry over all R rounds and Q chain positions with a key each.  The
// template parameter MODE compiles the position arithmetic out of K3's
// instances, so K3 runs the code it ran before K5 shared it.

#include "aia_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// What a launch covers (bn_rounds_kernel's MODE).
constexpr int kSweep = 0;  // K3: one position, every round
constexpr int kMesh = 1;   // K5: one round, a range of mesh positions
constexpr int kLanes = 2;  // K3 lanes: every round, Q queries, a key each

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
  const int* lane_keys;  // (n_chain_pos, 2) a key per query (kLanes only)
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

  // --- C1: KY walk over v_max bins + the rejection bin ---
  int m[VCAP];
  aia::ky_prepare<VCAP>(w, a.v_max, a.precision, m);
  int bits, rejs;
  bool done;
  int label = aia::ddg_walk<VCAP>(m, words, a.v_max, a.precision,
                                  a.total_steps, bits, rejs, done);
  if (!done) label = aia::argmax_fallback<VCAP>(w, a.v_max);
  return label;
}

template <int VCAP, int MODE>
__global__ void bn_rounds_kernel(RoundsArgs a) {
  constexpr bool MESH = MODE == kMesh;
  constexpr bool LANES = MODE == kLanes;
  extern __shared__ int smem[];
  int* vals = smem;                                        // chains x n
  float* tab = (float*)(smem + a.chains_per_block * a.n);  // lut_size
  // block -> (position, chain block); a position is (chain pos, node pos)
  const int pos = MESH || LANES ? blockIdx.x / a.blocks_per_pos : 0;
  const int inner =
      MESH || LANES ? blockIdx.x - pos * a.blocks_per_pos : blockIdx.x;
  const int ci = MESH ? pos / a.n_node_pos : (LANES ? pos : 0);
  const int dd = MESH ? pos - ci * a.n_node_pos : 0;
  const int d = MESH ? a.d0 + dd : 0;
  const int first = inner * a.chains_per_block;  // within the position
  const int nch = min(a.chains_per_block, a.b_loc - first);
  const long long row0 = (long long)ci * a.b_loc + first;  // launch row
  const int* vin = a.vals_in + row0 * a.n;
  for (int i = threadIdx.x; i < nch * a.n; i += blockDim.x) vals[i] = vin[i];
  for (int i = threadIdx.x; i < a.lut_size; i += blockDim.x) tab[i] = a.tab[i];
  // the sweep's key: the launch's, or (K3 lanes) the block's query's
  const unsigned k1 = LANES ? (unsigned)__ldg(a.lane_keys + 2 * ci) : a.k1;
  const unsigned k2 = LANES ? (unsigned)__ldg(a.lane_keys + 2 * ci + 1) : a.k2;
  __syncthreads();

  for (int r = a.r0; r < a.r0 + a.n_r; ++r) {
    const long long t = (long long)d * a.R + r;  // the table's (d, r)
    const int nc = a.n_rows[t];
    const unsigned long long n_full = MESH ? (unsigned)a.n_full[r] : nc;
    // bn_gibbs.round_key: prng.split(key, R)[r] hashes the pair (0, r)
    const uint2 rk = aia::threefry2x32(k1, k2, 0u, (unsigned)r);
    const int* nodes = a.nodes + t * a.c_max;
    const int* wpos = MESH ? a.word_pos + t * a.c_max : nullptr;
    for (int row = threadIdx.x; row < nch * nc; row += blockDim.x) {
      const int b = row / nc;
      const int c = row - b * nc;
      int* vrow = vals + b * a.n;
      // bn_gibbs.row_word_index (K3) / owned_row_word_index (K5):
      // (global chain * n_c[r] + the lane's place in the full group)
      // * n_words, 64-bit.  K3's chain is first + b (row0 = first), and
      // so is the lane entry's: the chain within its query
      const unsigned long long chain =
          MESH ? (unsigned long long)(a.chain_base + row0 + b) : first + b;
      const unsigned long long place = MESH ? (unsigned)__ldg(wpos + c) : c;
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

template <int VCAP, int MODE>
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
        bn_rounds_kernel<VCAP, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bn_rounds_kernel<VCAP, MODE>
      <<<(unsigned)blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(RoundsArgs& a, cudaStream_t s) {
  if (a.chains_per_block < 1 || a.b_loc < 1 || a.n_chain_pos < 1 ||
      a.n_node_pos < 1)
    return (int)cudaErrorInvalidValue;
  a.blocks_per_pos = (a.b_loc + a.chains_per_block - 1) / a.chains_per_block;
  const int lanes = a.v_max + 1;
  if (lanes <= 4) return launch<4, MODE>(a, s);
  if (lanes <= 8) return launch<8, MODE>(a, s);
  if (lanes <= 16) return launch<16, MODE>(a, s);
  if (lanes <= 32) return launch<32, MODE>(a, s);
  if (lanes <= 128) return launch<128, MODE>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K3: one sweep of R rounds over B chains, drawing from the sweep's key
// (k1, k2); the round tables are (R, c_max, ...) and n_c their node counts.
extern "C" int aia_bn_sweep(
    const int* vals_in, int* vals_out, int B, int n, int chains_per_block,
    int R, const int* n_c, int c_max, int f_max, int s_max, const int* nodes,
    const int* cards, const int* base, const int* stride, const int* scope,
    const int* is_self, unsigned k1, unsigned k2, int n_words,
    const float* logf, const float* tab, int lut_size, float x0,
    float inv_dx, int v_max, int exact, int weight_bits, int precision,
    int total_steps, void* stream) {
  RoundsArgs a{vals_in, vals_out, 0, 1, B, 0, 1, n, chains_per_block, 0,
               R, 0, R, n_c, n_c, c_max, f_max, s_max, nodes, cards, base,
               stride, scope, is_self, nullptr, k1, k2, n_words, logf, tab,
               lut_size, x0, inv_dx, v_max, exact, weight_bits, precision,
               total_steps};
  return dispatch<kSweep>(a, (cudaStream_t)stream);
}

// K3 lanes: one sweep of R rounds over Q queries of B chains each, vals
// (Q * B, n), query q drawing from its key keys[2 q], keys[2 q + 1].
extern "C" int aia_bn_sweep_lanes(
    const int* vals_in, int* vals_out, int Q, int B, int n,
    int chains_per_block, int R, const int* n_c, int c_max, int f_max,
    int s_max, const int* nodes, const int* cards, const int* base,
    const int* stride, const int* scope, const int* is_self,
    const int* keys, int n_words, const float* logf, const float* tab,
    int lut_size, float x0, float inv_dx, int v_max, int exact,
    int weight_bits, int precision, int total_steps, void* stream) {
  if (keys == nullptr || chains_per_block > B)
    return (int)cudaErrorInvalidValue;
  RoundsArgs a{vals_in, vals_out, 0, Q, B, 0, 1, n, chains_per_block, 0,
               R, 0, R, n_c, n_c, c_max, f_max, s_max, nodes, cards, base,
               stride, scope, is_self, nullptr, 0u, 0u, n_words, logf, tab,
               lut_size, x0, inv_dx, v_max, exact, weight_bits, precision,
               total_steps, keys};
  return dispatch<kLanes>(a, (cudaStream_t)stream);
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
  return dispatch<kMesh>(a, (cudaStream_t)stream);
}
