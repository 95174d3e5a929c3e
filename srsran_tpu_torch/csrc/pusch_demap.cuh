// Per-RE helpers shared by the PUSCH demap kernels K3 (pusch_demap.cu), K18
// and K19 (dft_s_ofdm.cu; K16 has its own): complex arithmetic
// with one rounding per operation, the exact max-log demap of one real axis
// and of one symbol of any modulation, with the Gold sign (the twin is
// srsran_tpu_torch/ops/modulation.py::demodulate followed by
// ops/scrambling.py::descramble_llrs).

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

// Demap kinds: 0 BPSK, 1 pi/2-BPSK (derotated by -j where rot_odd), 2
// square QAM through the PAM level table (QPSK .. 256QAM, HALF bits per
// axis).  Symbol g's bits start at g * Qm in the LLRs and in the Gold bits.
// BPSK: 2 ((re + im) 2 scale) / max(nv, 1e-12), as the JAX package's
// ops/modulation.py::demodulate computes it, each step rounded.
template <int HALF>
__device__ __forceinline__ void demap_symbol(float2 x, float nv, int kind,
                                             int rot_odd, float two_scale,
                                             const float* __restrict__ levels,
                                             const uint8_t* __restrict__ seq,
                                             float* __restrict__ llr, int g) {
  if (kind < 2) {
    if (kind == 1 && rot_odd) x = make_float2(x.y, -x.x);
    const float proj = __fmul_rn(__fadd_rn(x.x, x.y), two_scale);
    const float l = __fdiv_rn(__fmul_rn(2.f, proj), fmaxf(nv, 1e-12f));
    llr[g] = seq[g] ? -l : l;
    return;
  }
  demap_axis<HALF>(x.x, nv, levels, seq, llr, g * 2 * HALF, 0);
  demap_axis<HALF>(x.y, nv, levels, seq, llr, g * 2 * HALF, 1);
}

}  // namespace srsran_demap
