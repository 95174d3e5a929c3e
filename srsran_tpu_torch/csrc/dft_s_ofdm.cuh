// Device functions shared by K18 (the DFT-s-OFDM PUSCH) and K19 (PUCCH
// F3/F4) in dft_s_ofdm.cu: one bin of the M-point unitary IDFT from a
// block in shared memory and a CTA sum; the demap of one symbol with its
// Gold sign (demap_symbol) is pusch_demap.cuh's, shared with K3 and K16.
// The twin of the IDFT is srsran_tpu_torch/ops/transform_precode.py::
// deprecode.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "pusch_demap.cuh"

namespace srsran_dfts {

using namespace srsran_demap;

// Output bins per CTA (one thread each).
constexpr int TILE = 128;

// Bin k of the unitary IDFT of v[0..M): sum_n v[n] * tw[(k * n) mod M],
// tw[m] = exp(2j pi m / M) / sqrt(M).  The index advances by k and wraps
// once (k < M), so no product k * n is formed.  Each complex product is
// rounded in float32 as the twin's matmul rounds it; the sum runs in
// float64, so its rounding does not grow with M.
__device__ __forceinline__ float2 idft_bin(const float2* __restrict__ v,
                                           const float2* __restrict__ tw,
                                           int M, int k) {
  double re = 0.0, im = 0.0;
  int idx = 0;
  for (int n = 0; n < M; ++n) {
    const float2 p = cmul(v[n], tw[idx]);
    re += (double)p.x;
    im += (double)p.y;
    idx += k;
    if (idx >= M) idx -= M;
  }
  return make_float2((float)re, (float)im);
}

// Sum of one float per thread over the CTA (TILE threads); every thread
// gets the total.  red holds TILE floats of shared memory.
__device__ __forceinline__ float cta_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = TILE / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();
  return total;
}

}  // namespace srsran_dfts
