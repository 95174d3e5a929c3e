// Per-RE helpers shared by the PUSCH demap kernels K3 (pusch_demap.cu) and
// K16 (pusch_demap_lxn.cu): complex arithmetic with one rounding per
// operation, and the exact max-log demap of one real axis with the Gold
// sign (the twin is srsran_tpu_torch/ops/modulation.py::demodulate followed
// by ops/scrambling.py::descramble_llrs).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace srsran_demap {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

// conj(a) * b
__device__ __forceinline__ float2 cjmul(float2 a, float2 b) {
  return make_float2(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ __forceinline__ float abs2(float2 a) {
  return __fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y));
}

template <int HALF>
__device__ __forceinline__ void demap_axis(float coord, float nv,
                                           const float* __restrict__ levels,
                                           const uint8_t* __restrict__ seq,
                                           float* __restrict__ out, int base,
                                           int axis) {
  constexpr int NL = 1 << HALF;
  float d2[NL];
#pragma unroll
  for (int v = 0; v < NL; ++v) {
    const float diff = __fsub_rn(coord, levels[v]);
    d2[v] = __fmul_rn(diff, diff);
  }
  const float den = fmaxf(nv, 1e-12f);
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    float d0 = 1e30f, d1 = 1e30f;
#pragma unroll
    for (int v = 0; v < NL; ++v) {
      if ((v >> (HALF - 1 - i)) & 1)
        d1 = fminf(d1, d2[v]);
      else
        d0 = fminf(d0, d2[v]);
    }
    const int g = base + 2 * i + axis;
    const float l = __fdiv_rn(__fsub_rn(d1, d0), den);
    out[g] = seq[g] ? -l : l;
  }
}

}  // namespace srsran_demap
