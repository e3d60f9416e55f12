// Device functions shared by the three sampling kernels of the port, as
// the reference shares `interp_eval` (kernels/interp_lut.py) and
// `preprocess_lanes`/`ddg_walk`/`argmax_fallback` (kernels/ky_sampler.py)
// between its Pallas kernels.
//
// Bit-exactness rules (the lut_ky draw rounds the lerp's output, so one
// flipped low bit changes a label):
//   * every float op is written as the explicitly rounded intrinsic of the
//     op the reference executes, so nvcc cannot contract or reorder it.  The
//     reference as XLA compiles it (under jit and in its Pallas kernels)
//     multiplies by the float32 reciprocal of the LUT step instead of
//     dividing, and evaluates the lerp as one fused multiply-add; the lerp
//     here does the same (__fmul_rn, __fmaf_rn);
//   * round-half-to-even is rintf, never roundf (jnp.round rounds half to
//     even, roundf rounds half away from zero);
//   * random words are the uint32 bit patterns of jax.random.bits; bit t
//     of a row is (word[t / 32] >> (t % 32)) & 1.  A walk takes them from
//     a row of int32 words in device memory (K1's words entry) or hashes
//     them from the stream's key and the row's counters when it reaches
//     them (K1's keyed entry and K3-K6: `threefry2x32`, `jax_word`,
//     `WordsFromKey`).
//
// Every kernel walks bit planes of the bins (`prepare`, `scaled`,
// `plane_walk`), the rejection bin held apart: a step is one popcount of a
// column, with no loop over lanes, where the reference's `ddg_walk` sums
// all 128 lanes' bits with a matmul.  K3-K6 hold a row's weights in
// per-thread register arrays of a compile-time capacity CAP >= n_bins,
// every loop over them unrolled with a mask so the arrays stay in
// registers (`plane_draw`, with the lean `exact_walk` their rows allow);
// K1 forms its columns from registers or shared memory (ky_sampler.cu).

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace aia {

// K2's body: Y[i] + frac * (Y[i+1] - Y[i]) on a uniform table with
// saturating ends (interp_lut.interp_eval); inv_dx is fl32(1 / dx).
__device__ __forceinline__ float lut_interp(float x, const float* tab,
                                            float x0, float inv_dx, int size) {
  float u = __fmul_rn(__fsub_rn(x, x0), inv_dx);
  u = fminf(fmaxf(u, 0.0f), (float)(size - 1));
  int idx = min((int)u, size - 2);
  float frac = __fsub_rn(u, (float)idx);
  float y0 = tab[idx];
  float y1 = tab[idx + 1];
  return __fmaf_rn(frac, __fsub_rn(y1, y0), y0);
}

// One threefry2x32 round: x += y, y = rotl(y, r) ^ x.
__device__ __forceinline__ void threefry_round(unsigned& x, unsigned& y,
                                               int r) {
  x += y;
  y = __funnelshift_l(y, y, r) ^ x;
}

// The threefry2x32 hash (20 rounds) of the counter pair (x1, x2) under the
// key (k1, k2), in uint32 arithmetic that wraps: `prng.threefry2x32`
// (prng.py), which follows jax's `_threefry2x32_lowering`.  Rotations
// (13, 15, 26, 6) and (17, 29, 16, 24) in turn, key schedule k1, k2,
// k1 ^ k2 ^ 0x1BD11BDA, five injections, the i-th (from 1) adding i to the
// second word.  41 bit operations (20 SHF, 21 LOP3 with jax_word's xor) and
// ~27 adds in the SASS, the key schedule hoisted out of a loop.
__device__ __forceinline__ uint2 threefry2x32(unsigned k1, unsigned k2,
                                              unsigned x1, unsigned x2) {
  const unsigned k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  unsigned x = x1 + k1;
  unsigned y = x2 + k2;
  threefry_round(x, y, 13); threefry_round(x, y, 15);
  threefry_round(x, y, 26); threefry_round(x, y, 6);
  x += k2; y += k3 + 1u;
  threefry_round(x, y, 17); threefry_round(x, y, 29);
  threefry_round(x, y, 16); threefry_round(x, y, 24);
  x += k3; y += k1 + 2u;
  threefry_round(x, y, 13); threefry_round(x, y, 15);
  threefry_round(x, y, 26); threefry_round(x, y, 6);
  x += k1; y += k2 + 3u;
  threefry_round(x, y, 17); threefry_round(x, y, 29);
  threefry_round(x, y, 16); threefry_round(x, y, 24);
  x += k2; y += k3 + 4u;
  threefry_round(x, y, 13); threefry_round(x, y, 15);
  threefry_round(x, y, 26); threefry_round(x, y, 6);
  x += k3; y += k1 + 5u;
  return make_uint2(x, y);
}

// Word i of `jax.random.bits(key, shape, uint32)` in jax's partitionable
// threefry mode (`prng._raw_bits`): b1 ^ b2 of the hash of the counter
// pair (i >> 32, i & 0xFFFFFFFF).  64-bit counters, whatever the shape.
__device__ __forceinline__ unsigned jax_word(unsigned k1, unsigned k2,
                                             unsigned long long i) {
  const uint2 b = threefry2x32(k1, k2, (unsigned)(i >> 32), (unsigned)i);
  return b.x ^ b.y;
}

// Where a walk takes word j of its row: a row of int32 words in device
// memory ...
struct WordsFromMemory {
  const int* row;
  __device__ __forceinline__ unsigned operator()(int j) const {
    return (unsigned)row[j];
  }
};

// ... or the row's counters base + j of the stream of key (k1, k2), hashed
// when the walk reaches them, so a row that stops early hashes only the
// words it consumes.
struct WordsFromKey {
  unsigned k1, k2;
  unsigned long long base;
  __device__ __forceinline__ unsigned operator()(int j) const {
    return jax_word(k1, k2, base + (unsigned long long)j);
  }
};

// The bit of a weight that the reference's `(m >> (p - 1 - level)) & 1`
// reads: bit p - 1 - level, and past level p - 1 (reached only when every
// weight is a multiple of 2^p) the sign bit, which an arithmetic shift by
// a negative amount fills with.
__device__ __forceinline__ int level_bit(int level, int precision) {
  return level < precision ? precision - 1 - level : 31;
}

// Position of the set bit of rank n (from 0) of x, which has more than n,
// all below bit WIDTH: a binary search of log2(WIDTH) halvings.
template <int WIDTH>
__device__ __forceinline__ int nth_set_bit(unsigned x, int n) {
  int pos = 0;
#pragma unroll
  for (int w = WIDTH / 2; w > 0; w >>= 1) {
    const int c = __popc(x & ((1u << w) - 1u));
    if (n >= c) {
      n -= c;
      x >>= w;
      pos += w;
    }
  }
  return pos;
}

// preprocess_lanes from a row's clamped sum s (wrapped in int32, as
// jnp.sum wraps): uniform if s <= 0, k = max(2^p // s, 1), and the
// rejection bin 2^p - k s (the wrapped sum of the scaled bins).
struct Prep {
  bool uniform;
  unsigned k;
  int rej;
};

__device__ __forceinline__ Prep prepare(unsigned s, int n_bins,
                                        int precision) {
  const bool uniform = (int)s <= 0;
  if (uniform) s = (unsigned)n_bins;
  const unsigned k = max((1u << precision) / s, 1u);
  return {uniform, k, (int)((1u << precision) - k * s)};
}

// A bin's scaled weight (a bin of the row, never a padding lane).
__device__ __forceinline__ unsigned scaled(int w, const Prep& pr) {
  return (pr.uniform ? 1u : (unsigned)max(w, 0)) * pr.k;
}

// ky_sampler.ddg_walk for one row over its columns: `column(level, b, col)`
// fills the NW words of the bins' column at `level` (bit b of each scaled
// bin), each below bit WIDTH.  The rejection bin is held apart (`rej`), so
// a step is
//
//   c = popc(column): accept at its (d+1)-th set bit if c > d, else reject
//   if c + rejbit > d, else d -= c + rejbit and go down a level,
//
// the reference's first lane past d with no loop over lanes.  Word j of
// the row comes from `words(j)` at step 32 j.  Returns the label, or -1
// when the bit budget ran out (done = false).  It takes every step that
// the reference's `ddg_walk` takes on the same scaled bins (the column's
// set bits below the rejection bin are its lanes), so the two give the
// same label, bits and rejections.
template <int NW, int WIDTH, class Column, class Words>
__device__ __forceinline__ int plane_walk(const Column& column, int rej,
                                          const Words& words, int precision,
                                          int total_steps, int& bits,
                                          int& rejs, bool& done) {
  int d = 0, level = 0;
  unsigned word = 0u;
  bits = 0;
  rejs = 0;
  done = false;
  for (int t = 0; t < total_steps; ++t) {
    if ((t & 31) == 0) word = words(t >> 5);
    d = (int)(2u * (unsigned)d + ((word >> (t & 31)) & 1u));
    ++bits;
    // d wraps negative after 31 levels without a leaf; every prefix sum
    // then exceeds it, and the reference takes lane 0
    if (d < 0) {
      done = true;
      return 0;
    }
    const int b = level_bit(level, precision);
    unsigned col[NW];
    column(level, b, col);
    int c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) c += __popc(col[j]);
    if (c > d) {
      int r = d, label = -1;
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int cj = __popc(col[j]);
        if (label < 0) {
          if (r < cj)
            label = 32 * j + nth_set_bit<WIDTH>(col[j], r);
          else
            r -= cj;
        }
      }
      done = true;
      return label;
    }
    const int total = c + ((rej >> b) & 1);
    if (total > d) {
      ++rejs;
      d = 0;
      level = 0;
    } else {
      d -= total;
      ++level;
    }
  }
  return -1;
}

// plane_walk for a row whose scaled bins and rejection bin sum to exactly
// 2^precision with rej >= 0, as every row of the lane entries' does (the
// precision is widened so that n_bins weights of weight_bits bits sum
// below it: bn_gibbs.sweep_params, mrf_gibbs.half_step_params).  Such a
// DDG tree is complete by level precision - 1 (its internal nodes there
// number 2^p minus that sum, none), so the walk reads bit precision - 1 -
// level of each column and needs neither plane_walk's sign-bit level past
// it nor its exit on a wrapped d: the same steps and the same label, for
// fewer instructions a step.
template <int NW, int WIDTH, class Column, class Words>
__device__ __forceinline__ int exact_walk(const Column& column, int rej,
                                          const Words& words, int precision,
                                          int total_steps, bool& done) {
  int d = 0;
  int b = precision - 1;  // the bit of the current level
  unsigned word = 0u;
  done = false;
  for (int t = 0; t < total_steps; ++t) {
    if ((t & 31) == 0) word = words(t >> 5);
    d = 2 * d + (int)((word >> (t & 31)) & 1u);
    unsigned col[NW];
    column(0, b, col);
    int c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) c += __popc(col[j]);
    if (c > d) {
      int r = d, label = -1;
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int cj = __popc(col[j]);
        if (label < 0) {
          if (r < cj)
            label = 32 * j + nth_set_bit<WIDTH>(col[j], r);
          else
            r -= cj;
        }
      }
      done = true;
      return label;
    }
    const int total = c + ((rej >> b) & 1);
    if (total > d) {
      d = 0;
      b = precision - 1;
    } else {
      d -= total;
      --b;
    }
  }
  return -1;
}

// ky_sampler.argmax_fallback: first lane of the largest raw weight among
// the n_bins bins.  The reference holds -1 in its lanes n_bins..127, so
// when every weight is below -1 its argmax is lane n_bins.
template <int VCAP>
__device__ __forceinline__ int argmax_fallback(const int (&w)[VCAP],
                                               int n_bins) {
  int mx = INT_MIN, amax = 0;
#pragma unroll
  for (int i = 0; i < VCAP; ++i) {
    if (i < n_bins && w[i] > mx) {
      mx = w[i];
      amax = i;
    }
  }
  return mx < -1 ? n_bins : amax;
}

// Smallest power of two >= n (n <= 32): the width nth_set_bit searches.
__host__ __device__ constexpr int pow2_width(int n) {
  return n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : 32;
}

// preprocess_lanes, the plane walk (`exact_walk`) and argmax_fallback for
// one row of n_bins <= CAP integer weights held in registers (w[i] = 0
// from n_bins on): the lane entries' draw.  A level's column is formed from the
// scaled weights when the walk reaches it (CAP shifts and masks, one word
// per 32 bins).  With CAP == n_bins at compile time every mask folds away.
template <int CAP, class Words>
__device__ __forceinline__ int plane_draw(const int (&w)[CAP], int n_bins,
                                          int precision, int total_steps,
                                          const Words& words) {
  constexpr int NW = (CAP + 31) / 32;
  unsigned s = 0u;
#pragma unroll
  for (int i = 0; i < CAP; ++i)
    if (i < n_bins) s += (unsigned)max(w[i], 0);
  const Prep pr = prepare(s, n_bins, precision);
  // The empty asm keeps each scaled weight in a register: without it nvcc
  // recomputes them at every walk step (as in K1's ky_lanes_kernel).
  unsigned m[CAP];
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
    m[i] = i < n_bins ? scaled(w[i], pr) : 0u;
    asm volatile("" : "+r"(m[i]));
  }
  auto column = [&](int, int b, unsigned(&col)[NW]) {
#pragma unroll
    for (int j = 0; j < NW; ++j) col[j] = 0u;
#pragma unroll
    for (int i = 0; i < CAP; ++i) col[i / 32] |= ((m[i] >> b) & 1u) << (i % 32);
  };
  bool done;
  int label = exact_walk<NW, pow2_width(CAP < 32 ? CAP : 32)>(
      column, pr.rej, words, precision, total_steps, done);
  if (!done) label = argmax_fallback<CAP>(w, n_bins);
  return label;
}

}  // namespace aia

// Each kernel library is one translation unit that includes this header
// once, so the error-string helper and the generator's test entry are
// defined exactly once per library.
extern "C" const char* aia_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

namespace {

__global__ void threefry_words_kernel(unsigned k1, unsigned k2,
                                      unsigned long long start,
                                      unsigned long long n, int* out) {
  const unsigned long long stride =
      (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i =
           (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = (int)aia::jax_word(k1, k2, start + i);
}

}  // namespace

// Test entry of the generator, used by no sampling path: out[i] =
// aia::jax_word(k1, k2, start + i) for i < n, words start .. start + n - 1
// of the stream `prng.bits(Key(k1, k2), ...)` (`ops.device_bits`).
extern "C" int aia_threefry_words(unsigned k1, unsigned k2,
                                  unsigned long long start,
                                  unsigned long long n, int* out,
                                  void* stream) {
  if (n == 0) return 0;
  const unsigned long long blocks = (n + 255) / 256;
  threefry_words_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                          (cudaStream_t)stream>>>(k1, k2, start, n, out);
  return (int)cudaGetLastError();
}
