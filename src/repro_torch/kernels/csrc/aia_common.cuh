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
// K3-K6 walk with `ky_prepare`/`ddg_walk` below; K1 walks bit planes of
// the bins (ky_sampler.cu) and shares only the word sources and
// `argmax_fallback`.  Here distributions live in per-thread register
// arrays of a compile-time capacity VCAP >= n_bins + 1 (bins plus the
// rejection bin); every loop over them is unrolled with a runtime mask so
// the arrays stay in registers.  Lanes past n_bins + 1 play the part of
// the reference's zero lanes up to 128.

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

// ky_sampler.preprocess_lanes: clamp -> uniform if all zero -> scale to
// fill 2^precision -> rejection bin in lane n_bins.
template <int VCAP>
__device__ __forceinline__ void ky_prepare(const int (&w)[VCAP], int n_bins,
                                           int precision, int (&m)[VCAP]) {
  int s = 0;
#pragma unroll
  for (int i = 0; i < VCAP; ++i) {
    m[i] = (i < n_bins) ? max(w[i], 0) : 0;
    s += m[i];
  }
  if (s <= 0) {
    s = 0;
#pragma unroll
    for (int i = 0; i < VCAP; ++i) {
      m[i] = (i < n_bins) ? 1 : 0;
      s += m[i];
    }
  }
  int k = max((1 << precision) / s, 1);
  int tot = 0;
#pragma unroll
  for (int i = 0; i < VCAP; ++i) {
    m[i] *= k;
    tot += m[i];
  }
  int rej = (1 << precision) - tot;
#pragma unroll
  for (int i = 0; i < VCAP; ++i) {
    if (i == n_bins) m[i] = rej;
  }
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

// ky_sampler.ddg_walk for one row, stopping at the row's own termination
// (the reference's lock-step loop never changes a finished row, so the
// per-row exit gives the same label and counts).  Word j of the row comes
// from `words(j)` at step 32 j.  Returns the label, or -1 when the bit
// budget ran out (done = false).
template <int VCAP, class Words>
__device__ __forceinline__ int ddg_walk(const int (&m)[VCAP],
                                        const Words& words, int n_bins,
                                        int precision, int total_steps,
                                        int& bits, int& rejs, bool& done) {
  int d = 0, level = 0, label = -1;
  unsigned word = 0u;
  bits = 0;
  rejs = 0;
  done = false;
  for (int t = 0; t < total_steps; ++t) {
    if ((t & 31) == 0) word = words(t >> 5);
    int bit = (int)((word >> (t & 31)) & 1u);
    d = 2 * d + bit;
    int sh = precision - 1 - level;
    int c = 0, idx = -1;
#pragma unroll
    for (int i = 0; i < VCAP; ++i) {
      if (i <= n_bins) {
        c += (m[i] >> sh) & 1;
        if (idx < 0 && c > d) idx = i;
      }
    }
    ++bits;
    if (c > d) {
      if (idx >= n_bins) {
        ++rejs;
        d = 0;
        level = 0;
      } else {
        label = idx;
        done = true;
        break;
      }
    } else {
      d -= c;
      ++level;
    }
  }
  return label;
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
