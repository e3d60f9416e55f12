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
// K6: K4 over one mesh position's row slab, per launch.
//
// Replaces the reference's Pallas kernel `mrf_halo_half_step_kernel`
// (src/repro/kernels/mrf_gibbs.py:280; body `_mrf_halo_kernel` :123),
// which the sharded engine (`core/distributed.py` `mrf_fused_sharded`)
// launches once per half-step per position.  It is the template below
// with four differences, all in its arguments:
//   * the slab's rows -1 and h_loc are the chain's up and down halo rows
//     (the neighbouring positions' border rows, exchanged before the
//     round; -1 beyond the grid) where K4 stages -1;
//   * the checkerboard is taken against the slab's global row offset
//     row0: a site (r, c) of the slab is active when ((row0 + r) + c) % 2
//     equals the parity, so an odd row0 works;
//   * its words are read from device memory (KEYED = false): the round's
//     full (B, H, W, n_words) stream, generated once for every position;
//   * labels, output and words are addressed with a chain stride: a slab
//     of the (B, H, W) labels and of the round's full (B, H, W, n_words)
//     words is contiguous within a chain and strided across chains, so
//     every position reads the one stream generated for the round and
//     writes its slab of one output tensor, with no copies.
// The ragged last tile stays: the reference needs h_loc % block_h == 0,
// this kernel does not, and the labels are the same either way.
// Bound: bytes: the slab's active words, its labels read and written
// once, its halo rows.

#include <math.h>

#include "aia_common.cuh"

namespace {

struct HalfStepArgs {
  const int* labels_in;  // (B, H, W), chain stride lab_stride
  int* labels_out;       // (B, H, W), chain stride lab_stride
  const int* evidence;   // (H, W)
  const int* words;      // K6: (B, H, W, n_words), chain stride word_stride
  unsigned k1, k2;       // K4 (KEYED): the half-step's key
  const float* tab;      // (lut_size,) exp-weight LUT
  const int* up;         // (B, W) row above row 0, or null: -1 (K4)
  const int* down;       // (B, W) row below row H - 1, or null: -1 (K4)
  long long lab_stride, word_stride;
  int row0;              // global row of row 0, for the parity
  int B, H, W, block_h, tiles, n_labels, parity, quadratic;
  float theta, h, neg_h;
  int lut_size;
  float x0, inv_dx;
  int n_words, precision, total_steps;
};

template <int VCAP, bool KEYED>
__global__ void mrf_half_step_kernel(HalfStepArgs a) {
  extern __shared__ int smem[];
  const int W = a.W;
  const int chain = blockIdx.x / a.tiles;
  const int r0 = (blockIdx.x - chain * a.tiles) * a.block_h;
  const int rows = min(a.block_h, a.H - r0);
  const long long plane = (long long)chain * a.lab_stride;
  const int* lin = a.labels_in + plane;
  int* lout = a.labels_out + plane;
  int* lab = smem;                        // (rows + 2) x W, row 0 = r0 - 1
  int* ev = smem + (a.block_h + 2) * W;   // rows x W
  float* tab = reinterpret_cast<float*>(ev + a.block_h * W);
  for (int i = threadIdx.x; i < (rows + 2) * W; i += blockDim.x) {
    const int gr = r0 - 1 + i / W;
    const int c = i % W;
    if (gr >= 0 && gr < a.H)
      lab[i] = lin[(long long)gr * W + c];
    else if (gr < 0)
      lab[i] = a.up ? a.up[(long long)chain * W + c] : -1;
    else
      lab[i] = a.down ? a.down[(long long)chain * W + c] : -1;
  }
  const int* evg = a.evidence + (long long)r0 * W;
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x) ev[i] = evg[i];
  for (int i = threadIdx.x; i < a.lut_size; i += blockDim.x) tab[i] = a.tab[i];
  __syncthreads();

  // the other parity's sites pass through unchanged
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
    const int r = i / W;
    const int c = i - r * W;
    if (((a.row0 + r0 + r + c) & 1) != a.parity)
      lout[(long long)(r0 + r) * W + c] = lab[(r + 1) * W + c];
  }

  const int half_w = (W + 1) >> 1;
  for (int s = threadIdx.x; s < rows * half_w; s += blockDim.x) {
    const int r = s / half_w;
    const int gr = r0 + r;
    const int c = ((a.parity + a.row0 + gr) & 1) + 2 * (s - r * half_w);
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
    int bits, rejs, label;
    bool done;
    if constexpr (KEYED) {
      // mrf_gibbs.site_word_index: ((chain * H + r) * W + c) * n_words
      const aia::WordsFromKey src{
          a.k1, a.k2,
          (((unsigned long long)chain * a.H + gr) * W + c) * a.n_words};
      label = aia::ddg_walk<VCAP>(m, src, a.n_labels, a.precision,
                                  a.total_steps, bits, rejs, done);
    } else {
      const aia::WordsFromMemory src{
          a.words + (long long)chain * a.word_stride +
          ((long long)gr * W + c) * a.n_words};
      label = aia::ddg_walk<VCAP>(m, src, a.n_labels, a.precision,
                                  a.total_steps, bits, rejs, done);
    }
    if (!done) label = aia::argmax_fallback<VCAP>(w, a.n_labels);
    lout[(long long)gr * W + c] = label;
  }
}

template <int VCAP, bool KEYED>
int launch(const HalfStepArgs& a, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (long long)a.tiles * a.B;
  if (a.row0 < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (size_t)(2 * a.block_h + 2) * a.W +
                      sizeof(float) * (size_t)a.lut_size;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mrf_half_step_kernel<VCAP, KEYED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mrf_half_step_kernel<VCAP, KEYED>
      <<<(unsigned)blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool KEYED>
int dispatch(const HalfStepArgs& a, cudaStream_t s) {
  const int lanes = a.n_labels + 1;
  if (lanes <= 4) return launch<4, KEYED>(a, s);
  if (lanes <= 8) return launch<8, KEYED>(a, s);
  if (lanes <= 16) return launch<16, KEYED>(a, s);
  if (lanes <= 32) return launch<32, KEYED>(a, s);
  if (lanes <= 128) return launch<128, KEYED>(a, s);
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
  if (block_h < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (H + block_h - 1) / block_h;
  const long long plane = (long long)H * W;
  HalfStepArgs a{labels_in, labels_out, evidence, nullptr,  k1,
                 k2,        tab,        nullptr,  nullptr,  plane,
                 0,         0,          B,        H,        W,
                 block_h,   tiles,      n_labels, parity,   quadratic,
                 theta,     h,          neg_h,    lut_size, x0,
                 inv_dx,    n_words,    precision, total_steps};
  return dispatch<true>(a, (cudaStream_t)stream);
}

// K6: a slab of H rows starting at global row row0, with its chains' up
// and down halo rows ((B, W) each) and chain strides (in elements) for the
// labels (in and out alike) and the words.
extern "C" int aia_mrf_halo_half_step(
    const int* labels_in, int* labels_out, const int* up, const int* down,
    long long lab_stride, int row0, const int* evidence, const int* words,
    long long word_stride, const float* tab, int B, int H, int W,
    int block_h, int n_labels, int parity, int quadratic, float theta,
    float h, float neg_h, int lut_size, float x0, float inv_dx, int n_words,
    int precision, int total_steps, void* stream) {
  if (block_h < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (H + block_h - 1) / block_h;
  HalfStepArgs a{labels_in, labels_out, evidence, words,    0u,
                 0u,        tab,        up,       down,     lab_stride,
                 word_stride, row0,     B,        H,        W,
                 block_h,   tiles,      n_labels, parity,   quadratic,
                 theta,     h,          neg_h,    lut_size, x0,
                 inv_dx,    n_words,    precision, total_steps};
  return dispatch<false>(a, (cudaStream_t)stream);
}
