// K2: LUT linear interpolation, y = Y[i] + frac * (Y[i+1] - Y[i]).
//
// Replaces the reference's Pallas kernel `interp_kernel`
// (src/repro/kernels/interp_lut.py:50, body `interp_eval` :25).  The TPU
// has no per-lane VMEM gather, so the reference unrolls the <= 32-entry
// table walk into lane selects; here the table sits in shared memory and
// each thread gathers its two entries directly.
//
// Bound on the H100: bytes (4 read + 4 written per element, a dozen flops).
// The grid-stride loop keeps every load and store coalesced; the ops are
// the explicitly rounded intrinsics of aia_common.cuh, so the result is
// bit-equal to the plain torch twin.

#include "aia_common.cuh"

namespace {

__global__ void interp_kernel(const float* __restrict__ x,
                              float* __restrict__ y, long long n,
                              const float* __restrict__ table, int size,
                              float x0, float inv_dx) {
  extern __shared__ float tab[];
  for (int i = threadIdx.x; i < size; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    y[i] = aia::lut_interp(x[i], tab, x0, inv_dx, size);
  }
}

}  // namespace

extern "C" int aia_interp(const float* x, float* y, long long n,
                          const float* table, int size, float x0, float inv_dx,
                          void* stream) {
  const int threads = 256;
  long long want = (n + threads - 1) / threads;
  int blocks = (int)(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
  interp_kernel<<<blocks, threads, size * sizeof(float),
                  (cudaStream_t)stream>>>(x, y, n, table, size, x0, inv_dx);
  return (int)cudaGetLastError();
}
