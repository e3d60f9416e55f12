// K1: one exact rejection-Knuth-Yao draw per row.
//
// Replaces the reference's Pallas kernel `ky_sample_kernel`
// (src/repro/kernels/ky_sampler.py:159, body `_ky_kernel`).  One thread
// walks one row's DDG tree in registers; the TPU's lane cumsum (a
// triangular MXU matmul over 128 lanes) becomes a running sum over the
// row's n_bins + 1 lanes, and the lock-step early-exit while_loop becomes
// each thread's own exit.
//
// Bound on the H100: bytes.  A row reads n_bins weights and n_words words
// and writes four ints; the walk is O(entropy) integer steps of O(n_bins)
// work.  Rows map to consecutive threads, so each warp reads consecutive
// rows of weights and words.

#include "aia_common.cuh"

namespace {

template <int VCAP>
__global__ void ky_sample_kernel(const int* __restrict__ weights,
                                 const int* __restrict__ words, int B,
                                 int n_bins, int n_words, int precision,
                                 int total_steps, int* __restrict__ labels,
                                 int* __restrict__ bits_out,
                                 int* __restrict__ rejs_out,
                                 int* __restrict__ fb_out) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const int* wrow = weights + (long long)row * n_bins;
  int w[VCAP];
#pragma unroll
  for (int i = 0; i < VCAP; ++i) w[i] = (i < n_bins) ? wrow[i] : 0;
  int m[VCAP];
  aia::ky_prepare<VCAP>(w, n_bins, precision, m);
  int bits, rejs;
  bool done;
  const aia::WordsFromMemory src{words + (long long)row * n_words};
  int label = aia::ddg_walk<VCAP>(m, src, n_bins, precision, total_steps,
                                  bits, rejs, done);
  if (!done) label = aia::argmax_fallback<VCAP>(w, n_bins);
  labels[row] = label;
  bits_out[row] = bits;
  rejs_out[row] = rejs;
  fb_out[row] = done ? 0 : 1;
}

template <int VCAP>
void launch(const int* weights, const int* words, int B, int n_bins,
            int n_words, int precision, int total_steps, int* labels,
            int* bits, int* rejs, int* fb, cudaStream_t stream) {
  const int threads = 128;
  int blocks = (B + threads - 1) / threads;
  ky_sample_kernel<VCAP><<<blocks, threads, 0, stream>>>(
      weights, words, B, n_bins, n_words, precision, total_steps, labels,
      bits, rejs, fb);
}

}  // namespace

extern "C" int aia_ky_sample(const int* weights, const int* words, int B,
                             int n_bins, int n_words, int precision,
                             int total_steps, int* labels, int* bits,
                             int* rejs, int* fb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int lanes = n_bins + 1;
  if (lanes <= 4)
    launch<4>(weights, words, B, n_bins, n_words, precision, total_steps,
              labels, bits, rejs, fb, s);
  else if (lanes <= 8)
    launch<8>(weights, words, B, n_bins, n_words, precision, total_steps,
              labels, bits, rejs, fb, s);
  else if (lanes <= 16)
    launch<16>(weights, words, B, n_bins, n_words, precision, total_steps,
               labels, bits, rejs, fb, s);
  else if (lanes <= 32)
    launch<32>(weights, words, B, n_bins, n_words, precision, total_steps,
               labels, bits, rejs, fb, s);
  else if (lanes <= 128)
    launch<128>(weights, words, B, n_bins, n_words, precision, total_steps,
                labels, bits, rejs, fb, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
