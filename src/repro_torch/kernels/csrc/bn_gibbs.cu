// K3: one whole Bayes-net Gibbs sweep (every colour round) per launch.
//
// Replaces the reference's Pallas kernel `fused_gibbs_sweep`
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
// K5: one colour round over one mesh position's owned nodes per launch.
//
// Replaces the reference's Pallas kernel `fused_color_round`
// (src/repro/kernels/bn_gibbs.py:316), which runs the same `bn_round_step`
// body as a grid=(1,) call over a shard's slice of one round; the sharded
// engine (`core/distributed.py` `bn_fused_sharded`) launches it once per
// round per position, between the psum merges.  It is the template below
// with R = 1, words read from device memory (KEYED = false), and two
// differences:
//   * the round table is the position's slice of `ShardedFusedRounds`,
//     whose pad lanes trail the n_c owned lanes (node id -1, cards 0) and
//     are never processed, as K3 never processes its rounds' pad lanes;
//   * a row's words are not packed per shard: the kernel reads them from
//     the round's full stream (B_total chains x word_nc nodes, generated
//     once per round for every position) at chain word_chain0 + b and node
//     word_pos[c], the owned node's place in the round's full group.  The
//     reference gathers the same rows with dynamic_slice and take.
// Bound: bytes.  A launch reads the owned rows' words (b_loc x n_c rows of
// n_words) and reads and writes the position's (b_loc, n) values once.

#include "aia_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;

struct SweepArgs {
  const int* vals_in;
  int* vals_out;
  int B, n, chains_per_block, R;
  const int* n_c;  // (R,) real node count per round
  int c_max, f_max, s_max;
  const int* nodes;    // (R, c_max)
  const int* cards;    // (R, c_max)
  const int* base;     // (R, c_max * f_max)
  const int* stride;   // (R, c_max * f_max * s_max)
  const int* scope;    // (R, c_max * f_max * s_max)
  const int* is_self;  // (R, c_max * f_max * s_max)
  // K3 (KEYED): the sweep's key; round r draws from prng.split(key, R)[r]
  unsigned k1, k2;
  // K5 (not KEYED): the round's full stream of words, row
  // (word_chain0 + chain) * word_nc + word_pos[c]
  const int* words;
  const int* word_pos;  // (c_max,)
  int word_chain0, word_nc;
  int n_words;
  const float* logf;  // (T,) log-CPT arena
  const float* tab;   // (lut_size,) exp-weight LUT
  int lut_size;
  float x0, inv_dx;
  int v_max, exact, weight_bits, precision, total_steps;
};

template <int VCAP, bool KEYED>
__global__ void bn_sweep_kernel(SweepArgs a) {
  extern __shared__ int smem[];
  int* vals = smem;                                        // chains x n
  float* tab = (float*)(smem + a.chains_per_block * a.n);  // lut_size
  const int chain0 = blockIdx.x * a.chains_per_block;
  const int nch = min(a.chains_per_block, a.B - chain0);
  const int* vin = a.vals_in + (long long)chain0 * a.n;
  for (int i = threadIdx.x; i < nch * a.n; i += blockDim.x) vals[i] = vin[i];
  for (int i = threadIdx.x; i < a.lut_size; i += blockDim.x) tab[i] = a.tab[i];
  __syncthreads();

  const int fs = a.f_max * a.s_max;
  for (int r = 0; r < a.R; ++r) {
    const int nc = a.n_c[r];
    // bn_gibbs.round_key: prng.split(key, R)[r] hashes the pair (0, r)
    uint2 rk = make_uint2(0u, 0u);
    if constexpr (KEYED) rk = aia::threefry2x32(a.k1, a.k2, 0u, (unsigned)r);
    const int* nodes = a.nodes + (long long)r * a.c_max;
    const int* cards = a.cards + (long long)r * a.c_max;
    const int* base = a.base + (long long)r * a.c_max * a.f_max;
    const int* stride = a.stride + (long long)r * a.c_max * fs;
    const int* scope = a.scope + (long long)r * a.c_max * fs;
    const int* is_self = a.is_self + (long long)r * a.c_max * fs;
    for (int row = threadIdx.x; row < nch * nc; row += blockDim.x) {
      const int b = row / nc;
      const int c = row - b * nc;
      int* vrow = vals + b * a.n;
      const int card = cards[c];

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
      int bits, rejs, label;
      bool done;
      if constexpr (KEYED) {
        // bn_gibbs.row_word_index: ((chain0 + b) * n_c[r] + c) * n_words
        const aia::WordsFromKey src{
            rk.x, rk.y,
            ((unsigned long long)(chain0 + b) * nc + c) * a.n_words};
        label = aia::ddg_walk<VCAP>(m, src, a.v_max, a.precision,
                                    a.total_steps, bits, rejs, done);
      } else {
        const long long wr =
            (long long)(a.word_chain0 + chain0 + b) * a.word_nc +
            __ldg(a.word_pos + c);
        const aia::WordsFromMemory src{a.words + wr * a.n_words};
        label = aia::ddg_walk<VCAP>(m, src, a.v_max, a.precision,
                                    a.total_steps, bits, rejs, done);
      }
      if (!done) label = aia::argmax_fallback<VCAP>(w, a.v_max);
      vrow[nodes[c]] = label;
    }
    __syncthreads();
  }

  int* vout = a.vals_out + (long long)chain0 * a.n;
  for (int i = threadIdx.x; i < nch * a.n; i += blockDim.x) vout[i] = vals[i];
}

template <int VCAP, bool KEYED>
int launch(const SweepArgs& a, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (a.B + a.chains_per_block - 1) / a.chains_per_block;
  const size_t smem =
      sizeof(int) * (size_t)a.chains_per_block * a.n +
      sizeof(float) * (size_t)a.lut_size;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bn_sweep_kernel<VCAP, KEYED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bn_sweep_kernel<VCAP, KEYED><<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool KEYED>
int dispatch(const SweepArgs& a, cudaStream_t s) {
  const int lanes = a.v_max + 1;
  if (lanes <= 4) return launch<4, KEYED>(a, s);
  if (lanes <= 8) return launch<8, KEYED>(a, s);
  if (lanes <= 16) return launch<16, KEYED>(a, s);
  if (lanes <= 32) return launch<32, KEYED>(a, s);
  if (lanes <= 128) return launch<128, KEYED>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K3: one sweep of R rounds, drawing from the sweep's key (k1, k2).
extern "C" int aia_bn_sweep(
    const int* vals_in, int* vals_out, int B, int n, int chains_per_block,
    int R, const int* n_c, int c_max, int f_max, int s_max, const int* nodes,
    const int* cards, const int* base, const int* stride, const int* scope,
    const int* is_self, unsigned k1, unsigned k2, int n_words,
    const float* logf, const float* tab, int lut_size, float x0,
    float inv_dx, int v_max, int exact, int weight_bits, int precision,
    int total_steps, void* stream) {
  SweepArgs a{vals_in, vals_out, B, n, chains_per_block, R, n_c,
              c_max, f_max, s_max, nodes, cards, base, stride,
              scope, is_self, k1, k2, nullptr, nullptr, 0, 0, n_words, logf,
              tab, lut_size, x0, inv_dx, v_max, exact, weight_bits,
              precision, total_steps};
  return dispatch<true>(a, (cudaStream_t)stream);
}

// K5: one round (R = 1) over a mesh position's owned nodes; vals_in and
// vals_out are the position's (B, n) chain block, words the round's full
// stream, n_c a pointer to the position's owned-node count.
extern "C" int aia_bn_color_round(
    const int* vals_in, int* vals_out, int B, int n, int chains_per_block,
    const int* n_c, int c_max, int f_max, int s_max, const int* nodes,
    const int* cards, const int* base, const int* stride, const int* scope,
    const int* is_self, const int* word_pos, const int* words,
    int word_chain0, int word_nc, int n_words, const float* logf,
    const float* tab, int lut_size, float x0, float inv_dx, int v_max,
    int exact, int weight_bits, int precision, int total_steps,
    void* stream) {
  SweepArgs a{vals_in, vals_out, B, n, chains_per_block, 1, n_c,
              c_max, f_max, s_max, nodes, cards, base, stride,
              scope, is_self, 0u, 0u, words, word_pos, word_chain0, word_nc,
              n_words, logf, tab, lut_size, x0, inv_dx, v_max, exact,
              weight_bits, precision, total_steps};
  return dispatch<false>(a, (cudaStream_t)stream);
}
