// K4: one checkerboard Gibbs half-step of a grid MRF per launch.
//
// Replaces the reference's Pallas kernel `mrf_half_step_kernel`
// (src/repro/kernels/mrf_gibbs.py:159; body `_mrf_tile_body` :38, kernel
// `_mrf_kernel` :101, vmapped over the chains by `mrf_round_step` :229),
// which inlines K2's `interp_eval` and K1's `preprocess_lanes`, `ddg_walk`
// and `argmax_fallback`.  For every site of the active parity: count the
// 4-neighbours holding each value (-1 beyond the borders), energy
// theta * cnt + data (Potts: h * [e == v]; quadratic: (-h * d) * d with
// d = e - v), subtract the max, LUT-exp, round, KY walk, store.
//
// Design, against the reference's TPU layout:
//   * A block takes one (chain, row tile): the TPU's sequential grid over
//     row blocks, vmapped over the chains, becomes one flat grid of
//     independent blocks.  The tile is up to 32 rows (the reference's
//     block_h) and the last tile of a grid whose height is no multiple of
//     it is ragged, so any H and W work.
//   * The tile's label rows plus one halo row above and below (-1 beyond
//     the grid), its evidence rows and the exp table are staged in shared
//     memory, where the TPU read the halos from the adjacent row blocks.
//   * One thread per site of the active parity.  The other parity's sites
//     are neither computed nor given words: each site consumes only its
//     own words, so skipping them leaves every label bit-equal to the
//     reference, which draws for all sites and discards half.
//   * The random words are made inside the kernel, where the TPU kernel
//     read words that XLA generated before the call (`jax.random.bits`
//     outside the Pallas kernel, src/repro/kernels/mrf_gibbs.py:254).  K4
//     takes the half-step's key by value; active site (chain, r, c) owns
//     counters `site_word_index` (mrf_gibbs.py) of its stream, and its walk
//     hashes word j (`aia::WordsFromKey`) only when it reaches step 32 j.
//     The other parity's words are never generated, and no word crosses
//     device memory.
//   * A parity-p site reads only parity-(1 - p) neighbours, so an update
//     in place would be safe.  The kernel writes a separate output all the
//     same (the other parity's sites copied through), so that the wrapper
//     is a pure function like its twin; that costs half the labels' bytes
//     once more per launch.
//   * Energies, weights and walk state live in per-thread registers of a
//     compile-time capacity VCAP >= n_labels + 1, picked per launch (8
//     lanes for Potts-4, 16 for 8 labels), as in K1 and K3.
//
// Bit-exactness: every float op is the explicitly rounded intrinsic of the
// op the reference executes (no contraction of theta * cnt + data), the
// lerp is `aia::lut_interp` (reciprocal multiply and one fused multiply-add,
// XLA's compiled form of the reference), and rounding is rintf.
//
// Bound on the H100: bytes.  A launch must read the labels once (16.8 MB
// for Penguin 64 x 64 at B = 1024) and write them once (16.8 MB), ~10 us
// at 3.35 TB/s; evidence and table are small and cached.  It must hash one
// threefry call per 32 walk steps of every active site: ~2.1 M calls on
// Penguin, each 41 bit operations that only the ALU pipe runs, ~5 us on
// 132 SMs x 64 ALU lanes x the SM clock (counts read from the SASS by
// chip_smoke's threefry phase).  The rest is tens of integer and float ops
// per site and lane.
//
// K6: one half-step over every row slab of a mesh per launch.
//
// Replaces the reference's Pallas kernel `mrf_halo_half_step_kernel`
// (src/repro/kernels/mrf_gibbs.py:280; body `_mrf_halo_kernel` :123),
// which the reference's sharded engine (`core/distributed.py`
// `mrf_fused_sharded`) calls on every device of its mesh, one row slab
// each.  Here K4 and K6 are one kernel: K4 is the grid as one slab with
// -1 beyond it; K6 a block of chains and rows split into n_slabs slabs of
// slab_h rows, all in one launch:
//   * blocks are (chain, tile), and a tile never crosses a slab boundary
//     (the last tile of a slab is ragged when block_h does not divide
//     slab_h: the reference needs h_loc % block_h == 0, this kernel does
//     not, and the labels are the same either way);
//   * a tile at a slab's border stages its row -1 or row slab_h from the
//     slab's exchanged up and down halo rows ((n_slabs, B, W), -1 beyond
//     the grid), never from the neighbouring slab's labels, so the halo
//     exchange (`distributed._halo_exchange`) stays the data path;
//   * the checkerboard is taken at the global row row0 + r, so a slab at
//     an odd row works;
//   * its words are hashed from the half-step's key like K4's, at the
//     global site: `site_word_index(chain0 + chain, row0 + r, c, H_total,
//     W, n_words)`, the counter of the single-device half-step's stream,
//     so the labels are the single-device half-step's whatever the mesh;
//   * the input may be a block of a larger tensor (strided across chains,
//     dense within a chain); the output is its own (B, rows, W) tensor.
// Bound: bytes: the labels read and written once, the halo rows; the
// hash as K4's.
//
// K4's lane entry (`aia_mrf_half_step_lanes`) runs one half-step over the
// chains of Q queries at once, the serving runtime's bucket, where the
// reference vmaps `mrf_round_step` over the queries (src/repro/runtime/
// batcher.py:291).  The labels are (Q * B, H, W), query q's chains the
// rows [q B, (q + 1) B); each query has its own evidence plane ((Q, H, W))
// and its own half-step key, read from a (Q, 2) int32 array in device
// memory.  A block is still one (chain, row tile) and so never straddles
// two queries; a site's words are counted from its chain within its query
// (the local chain), so every query draws the words of its standalone
// half-step.  Bound: bytes, as K4's, for Q * B chains.
//
// The template parameter MODE compiles the slab arithmetic, the halo
// reads, the offsets and the per-query keys out of K4's instances, so K4
// runs the code it ran before K6 and the lane entry shared it.

#include <math.h>

#include "aia_common.cuh"

namespace {

struct HalfStepArgs {
  const int* labels_in;  // (B, rows, W), chain stride in_stride
  int* labels_out;       // (B, rows, W), chain stride out_stride
  const int* evidence;   // (rows, W)
  const int* up;         // (n_slabs, B, W) row above each slab, or null: -1
  const int* down;       // (n_slabs, B, W) row below each slab, or null: -1
  long long in_stride, out_stride;
  long long chain0;      // global chain of chain 0 (counters)
  int row0;              // global row of row 0 (parity, counters)
  int H_total;           // the grid's height (counters)
  unsigned k1, k2;       // the half-step's key
  const float* tab;      // (lut_size,) exp-weight LUT
  int B, W, slab_h, n_slabs, block_h, tiles_per_slab, n_labels, parity;
  int quadratic;
  float theta, h, neg_h;
  int lut_size;
  float x0, inv_dx;
  int n_words, precision, total_steps;
  const int* lane_keys;  // (Q, 2) a key per query (kLanes only)
  int lane_chains;       // B, the chains of one query (kLanes only)
};

// What a launch covers (mrf_half_step_kernel's MODE).
constexpr int kGrid = 0;   // K4: a whole grid, one key
constexpr int kSlabs = 1;  // K6: row slabs with halos
constexpr int kLanes = 2;  // K4 lanes: Q queries' grids, a key and an
                           // evidence plane each

template <int VCAP, int MODE>
__global__ void mrf_half_step_kernel(HalfStepArgs a) {
  constexpr bool SLABS = MODE == kSlabs;
  constexpr bool LANES = MODE == kLanes;
  extern __shared__ int smem[];
  const int W = a.W;
  const int tiles = SLABS ? a.n_slabs * a.tiles_per_slab : a.tiles_per_slab;
  const int chain = blockIdx.x / tiles;
  const int tile = blockIdx.x - chain * tiles;
  // K4 lanes: the chain's query, and the chain within it (counters)
  const int q = LANES ? chain / a.lane_chains : 0;
  const int lchain = LANES ? chain - q * a.lane_chains : chain;
  const int g = SLABS ? tile / a.tiles_per_slab : 0;  // the slab
  const int s0 = g * a.slab_h;                        // its first row
  const int row0 = SLABS ? a.row0 : 0;
  const long long chain0 = SLABS ? a.chain0 : 0;
  const int r0 = s0 + (tile - g * a.tiles_per_slab) * a.block_h;
  const int rows = min(a.block_h, s0 + a.slab_h - r0);
  const int* lin = a.labels_in + (long long)chain * a.in_stride;
  int* lout =
      a.labels_out + (long long)chain * (SLABS ? a.out_stride : a.in_stride);
  const long long halo = ((long long)g * a.B + chain) * W;
  int* lab = smem;                        // (rows + 2) x W, row 0 = r0 - 1
  int* ev = smem + (a.block_h + 2) * W;   // rows x W
  float* tab = reinterpret_cast<float*>(ev + a.block_h * W);
  for (int i = threadIdx.x; i < (rows + 2) * W; i += blockDim.x) {
    const int gr = r0 - 1 + i / W;
    const int c = i % W;
    if (gr >= s0 && gr < s0 + a.slab_h)
      lab[i] = lin[(long long)gr * W + c];
    else if (gr < s0)
      lab[i] = SLABS && a.up ? a.up[halo + c] : -1;
    else
      lab[i] = SLABS && a.down ? a.down[halo + c] : -1;
  }
  const int* evg =
      a.evidence + ((LANES ? (long long)q * a.H_total : 0) + r0) * W;
  const unsigned k1 = LANES ? (unsigned)__ldg(a.lane_keys + 2 * q) : a.k1;
  const unsigned k2 = LANES ? (unsigned)__ldg(a.lane_keys + 2 * q + 1) : a.k2;
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x) ev[i] = evg[i];
  for (int i = threadIdx.x; i < a.lut_size; i += blockDim.x) tab[i] = a.tab[i];
  __syncthreads();

  // the other parity's sites pass through unchanged
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
    const int r = i / W;
    const int c = i - r * W;
    if (((row0 + r0 + r + c) & 1) != a.parity)
      lout[(long long)(r0 + r) * W + c] = lab[(r + 1) * W + c];
  }

  const int half_w = (W + 1) >> 1;
  for (int s = threadIdx.x; s < rows * half_w; s += blockDim.x) {
    const int r = s / half_w;
    const int gr = r0 + r;
    const int c = ((a.parity + row0 + gr) & 1) + 2 * (s - r * half_w);
    if (c >= W) continue;
    const int* row = lab + (r + 1) * W;
    const int up = row[c - W];
    const int down = row[c + W];
    const int left = c > 0 ? row[c - 1] : -1;
    const int right = c + 1 < W ? row[c + 1] : -1;
    const int e = ev[r * W + c];

    // --- energies per candidate value, the reference's op order ---
    float en[VCAP];
    float mx = -INFINITY;
#pragma unroll
    for (int v = 0; v < VCAP; ++v) {
      en[v] = 0.0f;
      if (v < a.n_labels) {
        const float cnt = __fadd_rn(
            __fadd_rn(__fadd_rn((float)(up == v), (float)(down == v)),
                      (float)(left == v)),
            (float)(right == v));
        float data;
        if (a.quadratic) {
          const float d = (float)(e - v);
          data = __fmul_rn(__fmul_rn(a.neg_h, d), d);
        } else {
          data = __fmul_rn(a.h, (float)(e == v));
        }
        en[v] = __fadd_rn(__fmul_rn(a.theta, cnt), data);
        mx = fmaxf(mx, en[v]);
      }
    }

    // --- C2: LUT-exp -> integer weights ---
    int w[VCAP];
#pragma unroll
    for (int v = 0; v < VCAP; ++v) {
      const float y = aia::lut_interp(__fsub_rn(en[v], mx), tab, a.x0,
                                      a.inv_dx, a.lut_size);
      w[v] = (v < a.n_labels) ? (int)fmaxf(rintf(y), 0.0f) : 0;
    }

    // --- C1: KY walk over n_labels bins + the rejection bin ---
    int m[VCAP];
    aia::ky_prepare<VCAP>(w, a.n_labels, a.precision, m);
    int bits, rejs;
    bool done;
    // mrf_gibbs.site_word_index at the global site:
    // (((chain0 + chain) * H_total + row0 + gr) * W + c) * n_words, the
    // chain being the local one in the lane entry
    const aia::WordsFromKey src{
        k1, k2,
        ((((unsigned long long)(chain0 + lchain)) * a.H_total + row0 + gr) *
             W + c) * a.n_words};
    int label = aia::ddg_walk<VCAP>(m, src, a.n_labels, a.precision,
                                    a.total_steps, bits, rejs, done);
    if (!done) label = aia::argmax_fallback<VCAP>(w, a.n_labels);
    lout[(long long)gr * W + c] = label;
  }
}

template <int VCAP, int MODE>
int launch(const HalfStepArgs& a, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (long long)a.n_slabs * a.tiles_per_slab * a.B;
  const size_t smem = sizeof(int) * (size_t)(2 * a.block_h + 2) * a.W +
                      sizeof(float) * (size_t)a.lut_size;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mrf_half_step_kernel<VCAP, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mrf_half_step_kernel<VCAP, MODE>
      <<<(unsigned)blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(HalfStepArgs& a, cudaStream_t s) {
  if (a.block_h < 1 || a.slab_h < 1 || a.n_slabs < 1 || a.W < 1 ||
      a.row0 < 0 || a.chain0 < 0)
    return (int)cudaErrorInvalidValue;
  a.tiles_per_slab = (a.slab_h + a.block_h - 1) / a.block_h;
  const int lanes = a.n_labels + 1;
  if (lanes <= 4) return launch<4, MODE>(a, s);
  if (lanes <= 8) return launch<8, MODE>(a, s);
  if (lanes <= 16) return launch<16, MODE>(a, s);
  if (lanes <= 32) return launch<32, MODE>(a, s);
  if (lanes <= 128) return launch<128, MODE>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K4: a whole (B, H, W) grid, drawing from the half-step's key (k1, k2).
extern "C" int aia_mrf_half_step(
    const int* labels_in, int* labels_out, const int* evidence, unsigned k1,
    unsigned k2, const float* tab, int B, int H, int W, int block_h,
    int n_labels, int parity, int quadratic, float theta, float h,
    float neg_h, int lut_size, float x0, float inv_dx, int n_words,
    int precision, int total_steps, void* stream) {
  const long long plane = (long long)H * W;
  HalfStepArgs a{labels_in, labels_out, evidence, nullptr,  nullptr,
                 plane,     plane,      0,        0,        H,
                 k1,        k2,         tab,      B,        W,
                 H,         1,          block_h,  0,        n_labels,
                 parity,    quadratic,  theta,    h,        neg_h,
                 lut_size,  x0,         inv_dx,   n_words,  precision,
                 total_steps};
  return dispatch<kGrid>(a, (cudaStream_t)stream);
}

// K4 lanes: Q queries of B chains each, labels (Q * B, H, W), evidence
// (Q, H, W); query q draws from its key keys[2 q], keys[2 q + 1].
extern "C" int aia_mrf_half_step_lanes(
    const int* labels_in, int* labels_out, const int* evidence,
    const int* keys, const float* tab, int Q, int B, int H, int W,
    int block_h, int n_labels, int parity, int quadratic, float theta,
    float h, float neg_h, int lut_size, float x0, float inv_dx, int n_words,
    int precision, int total_steps, void* stream) {
  if (keys == nullptr || Q < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const long long plane = (long long)H * W;
  HalfStepArgs a{labels_in, labels_out, evidence, nullptr,  nullptr,
                 plane,     plane,      0,        0,        H,
                 0u,        0u,         tab,      Q * B,    W,
                 H,         1,          block_h,  0,        n_labels,
                 parity,    quadratic,  theta,    h,        neg_h,
                 lut_size,  x0,         inv_dx,   n_words,  precision,
                 total_steps, keys,     B};
  return dispatch<kLanes>(a, (cudaStream_t)stream);
}

// K6: B chains (the first is chain chain0 of the run) of n_slabs row
// slabs of slab_h rows each, the first row global row row0 of a grid of
// H_total rows; up and down are (n_slabs, B, W); in_stride and out_stride
// the chain strides (in elements) of the labels in and out.
extern "C" int aia_mrf_halo_half_step(
    const int* labels_in, int* labels_out, long long in_stride,
    long long out_stride, const int* up, const int* down, long long chain0,
    int row0, int H_total, int slab_h, int n_slabs, const int* evidence,
    unsigned k1, unsigned k2, const float* tab, int B, int W, int block_h,
    int n_labels, int parity, int quadratic, float theta, float h,
    float neg_h, int lut_size, float x0, float inv_dx, int n_words,
    int precision, int total_steps, void* stream) {
  if ((long long)row0 + (long long)slab_h * n_slabs > H_total)
    return (int)cudaErrorInvalidValue;
  HalfStepArgs a{labels_in, labels_out, evidence, up,       down,
                 in_stride, out_stride, chain0,   row0,     H_total,
                 k1,        k2,         tab,      B,        W,
                 slab_h,    n_slabs,    block_h,  0,        n_labels,
                 parity,    quadratic,  theta,    h,        neg_h,
                 lut_size,  x0,         inv_dx,   n_words,  precision,
                 total_steps};
  return dispatch<kSlabs>(a, (cudaStream_t)stream);
}
