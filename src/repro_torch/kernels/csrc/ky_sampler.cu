// K1: one exact rejection-Knuth-Yao draw per row, walked over bit planes.
//
// Replaces the reference's Pallas kernel `ky_sample_kernel`
// (src/repro/kernels/ky_sampler.py:159: body `_ky_kernel` :140,
// `preprocess_lanes` :58, `ddg_walk` :74, `argmax_fallback` :128).  The TPU
// kernel walks a row's DDG tree on 128 lanes: each level shifts every
// lane's weight, sums the lanes' bits with a triangular MXU matmul and
// takes the first lane whose prefix sum exceeds d.  Here, as in the
// paper's datapath (a DDG column read per cycle, a prefix adder over the
// bins), a level's column is a bit plane over the row's bins only: bit i
// of word j is bit (p - 1 - level) of scaled bin 32 j + i.  The rejection
// bin is held apart as one int; it is always the last lane, so a step is
//
//   c = popc(column): accept at its (d+1)-th set bit if c > d, else reject
//   if c + rejbit > d, else d -= c + rejbit and go down a level,
//
// the reference's first lane past d with no loop over lanes.
//
// Bound on the H100: bytes.  A row's weights are read once and four ints
// written; its words are read (`aia_ky_sample`) or hashed by the walk from
// the key when it reaches them (`aia_ky_sample_keyed`).  Two layouts share
// the walk (`aia::plane_walk`, aia_common.cuh, which K3's and K4's lane
// entries walk with too):
//
//   * up to 8 bins (`ky_lanes_kernel<CAP>`): a thread loads its row into
//     registers and forms each level's column from them when the walk
//     reaches it, CAP shifts and masks for the few levels a walk visits;
//   * 9-128 bins (`ky_planes_kernel<NW>`, NW = 1, 2, 4 words a plane): a
//     warp copies its 32 rows into shared memory with coalesced loads;
//     each thread prepares its row, transposes each 32-bin word of scaled
//     weights into 32 bit planes in registers (five rounds of masked
//     swaps), and keeps the p + 1 planes its walk can reach in shared
//     memory, where the walk reads the plane of its level by index (a
//     register array read at a runtime index would live in local memory).
//
// The TPU kernel keeps its rejection bin in a lane of its 128, so it takes
// at most 127 bins.  With the rejection bin apart, 128 bins fill the four
// words of `ky_planes_kernel<4>` exactly: the token sampler's tree levels
// (models/sampling.py) draw from rows of 128 group sums.  A row of 128
// bins has no padding lane, so its bit-exhaustion fallback is the plain
// argmax of the reference's `ky_sample_ref`.

#include "aia_common.cuh"

namespace {

constexpr int MAX_PRECISION = 30;          // 2^p and every sum fit in int32
constexpr int MAX_BINS = 128;              // 4 words of a plane
constexpr int PLANES = MAX_PRECISION + 1;  // levels 0..p-1 and the sign

using aia::nth_set_bit;
using aia::plane_walk;
using aia::Prep;
using aia::prepare;
using aia::scaled;

// Where a row's words come from: a (B, n_words) int32 array, or the
// stream of a key at the row's counters, `random_words(key, (B,),
// n_words)` = `jax.random.bits(key, (B, n_words))`, hashed on demand.
struct FromMemory {
  const int* words;
  int n_words;
  __device__ aia::WordsFromMemory row(long long r) const {
    return {words + r * n_words};
  }
};

struct FromKey {
  unsigned k1, k2;
  int n_words;
  __device__ aia::WordsFromKey row(long long r) const {
    return {k1, k2, (unsigned long long)r * (unsigned long long)n_words};
  }
};

struct Out {
  int *labels, *bits, *rejs, *fb;
  __device__ void put(long long r, int label, int bits_used, int rejections,
                      bool done) const {
    labels[r] = label;
    bits[r] = bits_used;
    rejs[r] = rejections;
    fb[r] = done ? 0 : 1;
  }
};

// Up to CAP <= 8 bins: one thread per row, the row in registers.
template <int CAP, class Source>
__global__ void __launch_bounds__(128)
    ky_lanes_kernel(const int* __restrict__ weights, Source source, int B,
                    int n_bins, int precision, int total_steps, Out out) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const auto words = source.row(row);
  const int* wrow = weights + row * n_bins;
  int w[CAP];
  unsigned s = 0u;
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
    w[i] = i < n_bins ? wrow[i] : 0;
    s += (unsigned)max(w[i], 0);
  }
  const Prep pr = prepare(s, n_bins, precision);
  // The empty asm keeps each scaled weight in a register: without it nvcc
  // recomputes them at every walk step (a SEL and an IMAD per bin).
  unsigned m[CAP];
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
    m[i] = i < n_bins ? scaled(w[i], pr) : 0u;
    asm volatile("" : "+r"(m[i]));
  }
  auto column = [&](int, int b, unsigned(&col)[1]) {
    unsigned c = 0u;
#pragma unroll
    for (int i = 0; i < CAP; ++i) c |= ((m[i] >> b) & 1u) << i;
    col[0] = c;
  };
  int bits, rejs;
  bool done;
  int label = plane_walk<1, CAP>(column, pr.rej, words, precision,
                                 total_steps, bits, rejs, done);
  if (!done) label = aia::argmax_fallback<CAP>(w, n_bins);
  out.put(row, label, bits, rejs, done);
}

// One round of the 32 x 32 bit transpose: swap the high J-bit half of
// each 2J-bit block of a[k] with the low half of a[k + J], for k & J == 0.
template <int J, unsigned M>
__device__ __forceinline__ void transpose_round(unsigned (&a)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if (k & J) continue;
    const unsigned t = ((a[k] >> J) ^ a[k + J]) & M;
    a[k + J] ^= t;
    a[k] ^= t << J;
  }
}

// a[i] (bin i's weight) -> a[b] (bit b of every bin: bit i is bin i's).
__device__ __forceinline__ void transpose32(unsigned (&a)[32]) {
  transpose_round<16, 0x0000FFFFu>(a);
  transpose_round<8, 0x00FF00FFu>(a);
  transpose_round<4, 0x0F0F0F0Fu>(a);
  transpose_round<2, 0x33333333u>(a);
  transpose_round<1, 0x55555555u>(a);
}

// 9-128 bins: a warp per 32 rows, the planes in shared memory.
template <int NW, class Source>
__global__ void __launch_bounds__(128 / NW)
    ky_planes_kernel(const int* __restrict__ weights, Source source, int B,
                     int n_bins, int precision, int total_steps, Out out) {
  constexpr int WARPS = 4 / NW;
  constexpr int ROW = 32 * NW + 1;  // room for the widest odd stride
  __shared__ int tile[WARPS][32 * ROW];
  __shared__ unsigned planes[WARPS][PLANES * NW * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long first = ((long long)blockIdx.x * WARPS + warp) * 32;
  if (first >= B) return;
  const int rows = (int)min(32LL, (long long)B - first);
  // The warp's rows are contiguous in memory: copy them with coalesced
  // loads, each row at an odd stride so that the threads' row reads below
  // fall in 32 banks (128 bins: stride 129 = ROW).  f / n_bins as a
  // multiply: exact for f < 2^12, and f < 32 * n_bins <= 2^12.
  const int stride = n_bins | 1;
  const unsigned magic = ((1u << 20) + n_bins - 1) / n_bins;
  int* tw = tile[warp];
  const int* src = weights + first * n_bins;
  for (int f = lane; f < rows * n_bins; f += 32) {
    const int r = (int)(((unsigned)f * magic) >> 20);
    tw[r * stride + f - r * n_bins] = src[f];
  }
  __syncwarp();
  if (lane >= rows) return;
  const long long row = first + lane;
  const auto words = source.row(row);
  const int* w = tw + lane * stride;
  unsigned s = 0u;
  for (int i = 0; i < n_bins; ++i) s += (unsigned)max(w[i], 0);
  const Prep pr = prepare(s, n_bins, precision);
  // plane (slot, j) of this thread's row at pl[(slot * NW + j) * 32]: slot
  // p - 1 - b holds bit b < p, slot p the sign; each thread reads and
  // writes its own column of the warp's planes only
  unsigned* pl = planes[warp] + lane;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    unsigned a[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      a[i] = 0u;
      if (32 * j + i < n_bins) a[i] = scaled(w[32 * j + i], pr);
    }
    transpose32(a);
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      if (b < precision)
        pl[((precision - 1 - b) * NW + j) * 32] = a[b];
      else if (b == 31)
        pl[(precision * NW + j) * 32] = a[b];
    }
  }
  auto column = [&](int level, int, unsigned(&col)[NW]) {
    const int slot = min(level, precision);
#pragma unroll
    for (int j = 0; j < NW; ++j) col[j] = pl[(slot * NW + j) * 32];
  };
  int bits, rejs;
  bool done;
  int label = plane_walk<NW, 32>(column, pr.rej, words, precision,
                                 total_steps, bits, rejs, done);
  if (!done) {
    // argmax_fallback: the first bin of the largest raw weight, or lane
    // n_bins (the reference's -1 padding) when every weight is below -1
    // and the row has a padding lane (fewer than 128 bins)
    int mx = INT_MIN, amax = 0;
    for (int i = 0; i < n_bins; ++i)
      if (w[i] > mx) {
        mx = w[i];
        amax = i;
      }
    label = mx < -1 && n_bins < MAX_BINS ? n_bins : amax;
  }
  out.put(row, label, bits, rejs, done);
}

template <int CAP, class Source>
void launch_lanes(const int* weights, Source src, int B, int n_bins,
                  int precision, int total_steps, Out out, cudaStream_t s) {
  const int threads = 128;
  const int blocks = (int)(((long long)B + threads - 1) / threads);
  ky_lanes_kernel<CAP><<<blocks, threads, 0, s>>>(
      weights, src, B, n_bins, precision, total_steps, out);
}

template <int NW, class Source>
void launch_planes(const int* weights, Source src, int B, int n_bins,
                   int precision, int total_steps, Out out, cudaStream_t s) {
  const int rows = 128 / NW;  // 32 per warp
  const int blocks = (int)(((long long)B + rows - 1) / rows);
  ky_planes_kernel<NW><<<blocks, rows, 0, s>>>(
      weights, src, B, n_bins, precision, total_steps, out);
}

template <class Source>
int launch(const int* weights, Source src, int B, int n_bins, int precision,
           int total_steps, Out out, void* stream) {
  if (n_bins < 1 || n_bins > MAX_BINS || precision < 1 ||
      precision > MAX_PRECISION || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_bins <= 4)
    launch_lanes<4>(weights, src, B, n_bins, precision, total_steps, out, s);
  else if (n_bins <= 8)
    launch_lanes<8>(weights, src, B, n_bins, precision, total_steps, out, s);
  else if (n_bins <= 32)
    launch_planes<1>(weights, src, B, n_bins, precision, total_steps, out, s);
  else if (n_bins <= 64)
    launch_planes<2>(weights, src, B, n_bins, precision, total_steps, out, s);
  else
    launch_planes<4>(weights, src, B, n_bins, precision, total_steps, out, s);
  return (int)cudaGetLastError();
}

}  // namespace

// The reference kernel's signature: (B, n_bins) weights, (B, n_words)
// words.
extern "C" int aia_ky_sample(const int* weights, const int* words, int B,
                             int n_bins, int n_words, int precision,
                             int total_steps, int* labels, int* bits,
                             int* rejs, int* fb, void* stream) {
  return launch(weights, FromMemory{words, n_words}, B, n_bins, precision,
                total_steps, Out{labels, bits, rejs, fb}, stream);
}

// The draw request's entry: row r's word j is word r * n_words + j of the
// stream of key (k1, k2), hashed when the walk reaches it.
extern "C" int aia_ky_sample_keyed(const int* weights, unsigned k1,
                                   unsigned k2, int B, int n_bins,
                                   int n_words, int precision,
                                   int total_steps, int* labels, int* bits,
                                   int* rejs, int* fb, void* stream) {
  return launch(weights, FromKey{k1, k2, n_words}, B, n_bins, precision,
                total_steps, Out{labels, bits, rejs, fb}, stream);
}
