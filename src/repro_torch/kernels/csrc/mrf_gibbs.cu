// K4: one checkerboard Gibbs half-step of a grid MRF per launch, for one
// query or the Q queries of a serving bucket (`mrf_lanes_kernel`), and K6:
// one half-step over every row slab of a mesh per launch
// (`mrf_half_step_kernel`).
//
// K4 replaces the reference's Pallas kernel `mrf_half_step_kernel`
// (src/repro/kernels/mrf_gibbs.py:159; body `_mrf_tile_body` :38, kernel
// `_mrf_kernel` :101, vmapped over the chains by `mrf_round_step` :229,
// and over a bucket's queries by src/repro/runtime/batcher.py:291), which
// inlines K2's `interp_eval` and K1's `preprocess_lanes`, `ddg_walk` and
// `argmax_fallback`.  For every site of the active parity: count the
// 4-neighbours holding each value (-1 beyond the borders), energy
// theta * cnt + data (Potts: h * [e == v]; quadratic: (-h * d) * d with
// d = e - v), subtract the max, LUT-exp, round, KY walk, store.
//
// K4's design (`mrf_lanes_kernel<CAP, EXACT>`, entry
// `aia_mrf_half_step_lanes`; one query is Q = 1 with the key by value):
//   * A block takes a few chains of one query (2 where that still gives
//     all 132 SMs a block) and a tile of up to 16 grid rows: the TPU's
//     sequential grid over row blocks, vmapped over the chains and
//     queries, becomes one flat grid of independent blocks; the last tile
//     of a grid whose height is no multiple of it is ragged.  Wider blocks
//     (8 chains x 32 rows) shared the evidence among more chains but ran
//     slower on the H100 (PERF.md's kernel findings).
//   * The block stages its query's evidence rows once for its chains
//     (int32), the exp LUT, and each chain's tile rows plus one halo row
//     above and below as signed bytes, -1 beyond the grid kept distinct as
//     0xFF (labels are below 128); the TPU read the halos from the adjacent
//     row blocks.  Warps copy rows, lanes columns, with no division.
//   * A thread walks (chain, row, column pair) items of the block by fixed
//     steps (no division in the loop): the pair's active site is computed
//     and its other-parity partner passed through, both written as one
//     8-byte store when W is even.  The other parity's sites are neither
//     computed nor given words: each site consumes only its own words, so
//     skipping them leaves every label bit-equal to the reference, which
//     draws for all sites and discards half.
//   * Exact-width instances for 2-8 labels (CAP = n_labels: 4 for Penguin,
//     8 for Art), a runtime bound within 16, 32 or 127 beyond: the
//     energies, lerps and walk columns run over the labels in use only.
//   * The walk is K1's bit-plane walk (`aia::plane_draw`, `exact_walk`): a
//     step is one popcount of the level's column, the rejection bin held
//     apart, with no loop over lanes.
//   * The random words are made inside the kernel, where the TPU kernel
//     read words that XLA generated before the call (`jax.random.bits`
//     outside the Pallas kernel, src/repro/kernels/mrf_gibbs.py:254).
//     Active site (chain, r, c) owns counters `site_word_index`
//     (mrf_gibbs.py) of its query's half-step stream, the chain counted
//     within its query, so every query draws the words of its standalone
//     half-step; its walk hashes word j (`aia::WordsFromKey`) only when it
//     reaches step 32 j.
//   * A parity-p site reads only parity-(1 - p) neighbours, so an update
//     in place would be safe.  The kernel writes a separate output all the
//     same (the other parity's sites copied through), so that the wrapper
//     is a pure function like its twin.
//
// Bit-exactness: every float op is the explicitly rounded intrinsic of the
// op the reference executes (no contraction of theta * cnt + data), the
// lerp is `aia::lut_interp` (reciprocal multiply and one fused multiply-add,
// XLA's compiled form of the reference), and rounding is rintf.
//
// Bound on the H100 (`launch/kernel_cost.py`): bytes.  A launch must read
// the labels once (33.6 MB for Penguin 64 x 64 at 2 x 1,024) and write
// them once, ~20 us at 3.35 TB/s; evidence and table are small and
// cached.  It must hash one threefry call per 32 walk steps of every
// active site (4.2 M calls on that bucket, ~10 us on 132 SMs x 64 ALU
// lanes).  What holds it above: instruction issue.  A warp pays for its
// slowest lane's walk (a site walks 2-3 levels on average, the warp's
// slowest 7-9), and each site's energies, lerps and the preprocessing's
// integer division run a few hundred instructions more (PERF.md's kernel
// findings).
//
// K6 replaces the reference's Pallas kernel `mrf_halo_half_step_kernel`
// (src/repro/kernels/mrf_gibbs.py:280; body `_mrf_halo_kernel` :123),
// which the reference's sharded engine (`core/distributed.py`
// `mrf_fused_sharded`) calls on every device of its mesh, one row slab
// each.  Here one launch runs a block of chains and rows split into
// n_slabs slabs of slab_h rows (`mrf_half_step_kernel<VCAP>`):
//   * blocks are (chain, tile), and a tile never crosses a slab boundary
//     (the last tile of a slab is ragged when block_h does not divide
//     slab_h: the reference needs h_loc % block_h == 0, this kernel does
//     not, and the labels are the same either way); the tile's int32 label
//     rows, halo rows, evidence rows and the LUT are staged in shared
//     memory, one thread per active site;
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
//     dense within a chain); the output is its own (B, rows, W) tensor;
//   * energies, weights and walk state live in per-thread registers of a
//     compile-time capacity VCAP >= n_labels + 1; the draw is K4's
//     (`aia::plane_draw`).
// Bound: bytes: the labels read and written once, the halo rows; the
// hash as K4's.

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
};

template <int VCAP>
__global__ void mrf_half_step_kernel(HalfStepArgs a) {
  extern __shared__ int smem[];
  const int W = a.W;
  const int tiles = a.n_slabs * a.tiles_per_slab;
  const int chain = blockIdx.x / tiles;
  const int tile = blockIdx.x - chain * tiles;
  const int g = tile / a.tiles_per_slab;  // the slab
  const int s0 = g * a.slab_h;                        // its first row
  const int row0 = a.row0;
  const long long chain0 = a.chain0;
  const int r0 = s0 + (tile - g * a.tiles_per_slab) * a.block_h;
  const int rows = min(a.block_h, s0 + a.slab_h - r0);
  const int* lin = a.labels_in + (long long)chain * a.in_stride;
  int* lout =
      a.labels_out + (long long)chain * a.out_stride;
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
      lab[i] = a.up ? a.up[halo + c] : -1;
    else
      lab[i] = a.down ? a.down[halo + c] : -1;
  }
  const int* evg = a.evidence + (long long)r0 * W;
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

    // --- C1: KY over n_labels bins, walked over bit planes ---
    // mrf_gibbs.site_word_index at the global site:
    // (((chain0 + chain) * H_total + row0 + gr) * W + c) * n_words
    const aia::WordsFromKey src{
        a.k1, a.k2,
        ((((unsigned long long)(chain0 + chain)) * a.H_total + row0 + gr) *
             W + c) * a.n_words};
    lout[(long long)gr * W + c] =
        aia::plane_draw<VCAP>(w, a.n_labels, a.precision, a.total_steps, src);
  }
}

template <int VCAP>
int launch(const HalfStepArgs& a, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (long long)a.n_slabs * a.tiles_per_slab * a.B;
  const size_t smem = sizeof(int) * (size_t)(2 * a.block_h + 2) * a.W +
                      sizeof(float) * (size_t)a.lut_size;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mrf_half_step_kernel<VCAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mrf_half_step_kernel<VCAP>
      <<<(unsigned)blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(HalfStepArgs& a, cudaStream_t s) {
  if (a.block_h < 1 || a.slab_h < 1 || a.n_slabs < 1 || a.W < 1 ||
      a.row0 < 0 || a.chain0 < 0)
    return (int)cudaErrorInvalidValue;
  a.tiles_per_slab = (a.slab_h + a.block_h - 1) / a.block_h;
  const int lanes = a.n_labels + 1;
  if (lanes <= 4) return launch<4>(a, s);
  if (lanes <= 8) return launch<8>(a, s);
  if (lanes <= 16) return launch<16>(a, s);
  if (lanes <= 32) return launch<32>(a, s);
  if (lanes <= 128) return launch<128>(a, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K4's lane entry: chains of one query share a block, its evidence and LUT
// ---------------------------------------------------------------------------

struct LanesArgs {
  const int* labels_in;  // (Q * B, H, W)
  int* labels_out;       // (Q * B, H, W)
  const int* evidence;   // (Q, H, W)
  const int* keys;       // (Q, 2) a key per query, or null: (k1, k2)
  unsigned k1, k2;
  const float* tab;      // (lut_size,) exp-weight LUT
  int Q, B, H, W, tile_h, tiles, chains_per_block, groups, n_labels,
      parity, quadratic;
  float theta, h, neg_h;
  int lut_size;
  float x0, inv_dx;
  int n_words, precision, total_steps;
};

// One active site: neighbour counts, energies in the reference's op order,
// LUT-exp weights and the plane walk over N labels (N = CAP at compile
// time when EXACT, else the runtime n_labels <= CAP).
template <int CAP, bool EXACT>
__device__ __forceinline__ int lanes_site(const LanesArgs& a,
                                          const float* tab, int up, int down,
                                          int left, int right, int e,
                                          const aia::WordsFromKey& words) {
  const int n = EXACT ? CAP : a.n_labels;
  float en[CAP];
  float mx = -INFINITY;
#pragma unroll
  for (int v = 0; v < CAP; ++v) {
    en[v] = 0.0f;
    if (EXACT || v < n) {
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
  int w[CAP];
#pragma unroll
  for (int v = 0; v < CAP; ++v) {
    w[v] = 0;
    if (EXACT || v < n) {
      const float y = aia::lut_interp(__fsub_rn(en[v], mx), tab, a.x0,
                                      a.inv_dx, a.lut_size);
      w[v] = (int)fmaxf(rintf(y), 0.0f);
    }
  }
  return aia::plane_draw<CAP>(w, n, a.precision, a.total_steps, words);
}

// A block: chains [first, first + nch) of query q and grid rows [r0, r0 +
// rows).  Shared memory: the LUT, the tile's evidence rows (int32) and
// each chain's tile rows plus the halo row above and below as signed
// bytes (-1 beyond the grid is 0xFF, distinct from every label < 128).
// A thread walks (chain, row, column pair) items, one active site and
// its other-parity partner each, advancing by fixed steps (no division in
// the loop), and writes the pair as one 8-byte store when W is even.
template <int CAP, bool EXACT>
__global__ void __launch_bounds__(256) mrf_lanes_kernel(LanesArgs a) {
  extern __shared__ int smem[];
  const int W = a.W;
  const int bq = blockIdx.x / a.tiles;  // (query, chain group)
  const int tile = blockIdx.x - bq * a.tiles;
  const int q = bq / a.groups;
  const int first = (bq - q * a.groups) * a.chains_per_block;
  const int nch = min(a.chains_per_block, a.B - first);
  const int r0 = tile * a.tile_h;
  const int rows = min(a.tile_h, a.H - r0);
  const int lrows = a.tile_h + 2;  // a chain's staged rows
  float* tab = reinterpret_cast<float*>(smem);
  int* ev = smem + a.lut_size;                    // tile_h x W
  signed char* lab =
      reinterpret_cast<signed char*>(ev + a.tile_h * W);  // nch x lrows x W
  const long long plane = (long long)a.H * W;
  const long long chain0 = (long long)q * a.B + first;  // launch chain
  const int* lin = a.labels_in + chain0 * plane;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  // staged rows (chain bb, row rr = 0 .. rows + 1, grid row r0 - 1 + rr)
  // by warps, columns by lanes
  {
    int bb = 0, rr = warp;
    while (rr >= rows + 2) {
      rr -= rows + 2;
      ++bb;
    }
    while (bb < nch) {
      const int gr = r0 - 1 + rr;
      const bool inside = gr >= 0 && gr < a.H;
      const int* src = lin + bb * plane + (long long)gr * W;
      signed char* dst = lab + (bb * lrows + rr) * W;
      for (int c = lane; c < W; c += 32)
        dst[c] = (signed char)(inside ? src[c] : -1);
      rr += nwarps;
      while (rr >= rows + 2) {
        rr -= rows + 2;
        ++bb;
      }
    }
  }
  const int* evg = a.evidence + q * plane + (long long)r0 * W;
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x) ev[i] = evg[i];
  for (int i = threadIdx.x; i < a.lut_size; i += blockDim.x) tab[i] = a.tab[i];
  const unsigned k1 = a.keys ? (unsigned)__ldg(a.keys + 2 * q) : a.k1;
  const unsigned k2 = a.keys ? (unsigned)__ldg(a.keys + 2 * q + 1) : a.k2;
  __syncthreads();

  const int hw = (W + 1) >> 1;  // column pairs a row
  const int step_r = blockDim.x / hw;
  const int step_j = blockDim.x - step_r * hw;
  int bb = 0, r = threadIdx.x / hw;
  int j = threadIdx.x - r * hw;
  while (r >= rows) {
    r -= rows;
    ++bb;
  }
  const bool even_w = (W & 1) == 0;
  while (bb < nch) {
    const int gr = r0 + r;
    const int c = 2 * j + ((a.parity + gr) & 1);  // the active column
    const signed char* row = lab + (bb * lrows + r + 1) * W;
    int label = -1;
    if (c < W) {
      const int up = row[c - W];
      const int down = row[c + W];
      const int left = c > 0 ? row[c - 1] : -1;
      const int right = c + 1 < W ? row[c + 1] : -1;
      // mrf_gibbs.site_word_index of the chain within its query:
      // (((first + bb) * H + gr) * W + c) * n_words, 64-bit
      const aia::WordsFromKey src{
          k1, k2,
          (((unsigned long long)(first + bb) * a.H + gr) * W + c) *
              a.n_words};
      label = lanes_site<CAP, EXACT>(a, tab, up, down, left, right,
                                     ev[r * W + c], src);
    }
    // the pair (2 j, 2 j + 1): the active site's new label and its
    // partner's label passed through
    int* out = a.labels_out + (chain0 + bb) * plane + (long long)gr * W;
    const int c0 = 2 * j;
    const int v0 = c0 == c ? label : row[c0];
    if (even_w) {
      const int v1 = c0 + 1 == c ? label : row[c0 + 1];
      *reinterpret_cast<int2*>(out + c0) = make_int2(v0, v1);
    } else {
      out[c0] = v0;
      if (c0 + 1 < W) out[c0 + 1] = c0 + 1 == c ? label : row[c0 + 1];
    }
    j += step_j;
    r += step_r;
    if (j >= hw) {
      j -= hw;
      ++r;
    }
    while (r >= rows) {
      r -= rows;
      ++bb;
    }
  }
}

template <int CAP, bool EXACT>
int launch_lanes(const LanesArgs& a, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (long long)a.Q * a.groups * a.tiles;
  const size_t smem = sizeof(float) * (size_t)a.lut_size +
                      sizeof(int) * (size_t)a.tile_h * a.W +
                      (size_t)a.chains_per_block * (a.tile_h + 2) * a.W;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mrf_lanes_kernel<CAP, EXACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mrf_lanes_kernel<CAP, EXACT>
      <<<(unsigned)blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Exact-width instances for 2-8 labels (Ising, Potts-4 Penguin, Art's 8),
// a runtime bound within 16, 32 or 127 lanes beyond.
int dispatch_lanes(const LanesArgs& a, cudaStream_t s) {
  switch (a.n_labels) {
    case 2: return launch_lanes<2, true>(a, s);
    case 3: return launch_lanes<3, true>(a, s);
    case 4: return launch_lanes<4, true>(a, s);
    case 5: return launch_lanes<5, true>(a, s);
    case 6: return launch_lanes<6, true>(a, s);
    case 7: return launch_lanes<7, true>(a, s);
    case 8: return launch_lanes<8, true>(a, s);
  }
  if (a.n_labels < 1) return (int)cudaErrorInvalidValue;
  if (a.n_labels <= 16) return launch_lanes<16, false>(a, s);
  if (a.n_labels <= 32) return launch_lanes<32, false>(a, s);
  if (a.n_labels <= 127) return launch_lanes<128, false>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K4 lanes: Q queries of B chains each, labels (Q * B, H, W), evidence
// (Q, H, W); query q draws from its key keys[2 q], keys[2 q + 1] (every
// query from (k1, k2) when keys is null).  A block takes chains_per_block
// chains of one query and tile_h rows.
extern "C" int aia_mrf_half_step_lanes(
    const int* labels_in, int* labels_out, const int* evidence,
    const int* keys, unsigned k1, unsigned k2, const float* tab, int Q,
    int B, int H, int W, int tile_h, int chains_per_block, int n_labels,
    int parity, int quadratic, float theta, float h, float neg_h,
    int lut_size, float x0, float inv_dx, int n_words, int precision,
    int total_steps, void* stream) {
  if (Q < 1 || B < 1 || H < 1 || W < 1 || tile_h < 1 ||
      chains_per_block < 1)
    return (int)cudaErrorInvalidValue;
  LanesArgs a{labels_in, labels_out, evidence, keys, k1, k2, tab, Q, B, H,
              W, tile_h, (H + tile_h - 1) / tile_h, chains_per_block,
              (B + chains_per_block - 1) / chains_per_block, n_labels,
              parity, quadratic, theta, h, neg_h, lut_size, x0, inv_dx,
              n_words, precision, total_steps};
  return dispatch_lanes(a, (cudaStream_t)stream);
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
  return dispatch(a, (cudaStream_t)stream);
}
