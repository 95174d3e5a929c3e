// Per-RE and per-CTA helpers shared by the PUSCH demap kernels K3
// (pusch_demap.cu), K16 (pusch_demap_lxn.cu), K18 and K19 (dft_s_ofdm.cuh):
// complex arithmetic with one rounding per operation, the SFU reciprocal,
// the exact max-log demap of one PAM axis by one reciprocal of the noise
// (K3, K16) or by a division with a uint8 Gold bit a LLR (K18, K19's
// demap_symbol), and the staged 16-byte store of a CTA's LLRs with their
// Gold signs packed 32 a word (K3, K16).  The twin is
// srsran_tpu_torch/ops/modulation.py::demodulate followed by
// ops/scrambling.py::descramble_llrs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace srsran_demap {

constexpr int kLxnMaxLevels = 16;    // PAM levels (256QAM)

// K3's and K16's launch, by value (srsran_tpu_torch/kernels/_build.py
// LxnParams; K3 takes ZF, mmse 0, with 1 or 2 layers).
struct LxnParams {
  int nre, P, S, K, L, T, Ka, sc_off;
  int kind;       // 0 BPSK, 1 pi/2-BPSK, 2 QAM (QPSK .. 256QAM)
  int half;       // PAM bits an axis (1 for BPSK)
  int rot0;       // pi/2-BPSK: the parity of the launch's first symbol
  int mmse, nslots;
  float two_scale;
  float levels[kLxnMaxLevels];
};

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

// A reciprocal by the SFU (within 2 ulp; the operands lie in [1e-30,
// 1e30]): an IEEE-rounded one branches to a slow path, which splits a
// thread's independent chains and serialises them.
__device__ __forceinline__ float rcp(float x) { return __fdividef(1.f, x); }

// The max-log LLRs of one PAM axis (HALF bits) into out[0], out[2], ...,
// before the Gold sign: (min d^2 over bit 1 - min d^2 over bit 0) times
// the reciprocal of the noise; levels holds the 2^HALF Gray PAM levels.
template <int HALF>
__device__ __forceinline__ void demap_axis_scaled(float coord, float inv_nv,
                                                  const float* levels,
                                                  float* out) {
  constexpr int NL = 1 << HALF;
  float d2[NL];
#pragma unroll
  for (int v = 0; v < NL; ++v) {
    const float diff = coord - levels[v];
    d2[v] = diff * diff;
  }
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    // each half's minimum as a tree (min is exact: any order is the same)
    float m0[NL / 2], m1[NL / 2];
#pragma unroll
    for (int v = 0, j0 = 0, j1 = 0; v < NL; ++v) {
      if ((v >> (HALF - 1 - i)) & 1)
        m1[j1++] = d2[v];
      else
        m0[j0++] = d2[v];
    }
#pragma unroll
    for (int w = NL / 4; w >= 1; w /= 2) {
#pragma unroll
      for (int j = 0; j < w; ++j) {
        m0[j] = fminf(m0[j], m0[j + w]);
        m1[j] = fminf(m1[j], m1[j + w]);
      }
    }
    const float d0 = fminf(1e30f, m0[0]), d1 = fminf(1e30f, m1[0]);
    out[2 * i] = (d1 - d0) * inv_nv;
  }
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

// n floats of shared memory (src[i] at dst + i's alignment: src + head is
// 16-byte aligned where dst + head is) to device memory as 16-byte vectors,
// a scalar head and tail, by a CTA of THREADS threads; with GOLD, element
// i's sign flipped by bit g0 + i of the packed Gold words (words w0 on in
// gold, one spare after the last).
template <int THREADS, bool GOLD>
__device__ __forceinline__ void store_span(float* __restrict__ dst,
                                           const float* src, int n,
                                           const uint32_t* gold, int g0,
                                           int w0) {
  const int head = min(n, (int)((4 - (((uintptr_t)dst >> 2) & 3)) & 3));
  const int nv4 = (n - head) >> 2;
  const int tid = threadIdx.x;
  // the Gold bits of elements i .. i + 31, bit 0 first
  auto bits = [&](int i) -> uint32_t {
    const int g = g0 + i, w = (g >> 5) - w0;
    return __funnelshift_r(gold[w], gold[w + 1], g & 31);
  };
  auto sign = [&](float v, uint32_t bit) -> float {
    return __int_as_float(__float_as_int(v) ^ (int)(bit << 31));
  };
  for (int i = tid; i < head; i += THREADS)
    dst[i] = GOLD ? sign(src[i], bits(i) & 1) : src[i];
#pragma unroll 4
  for (int v = tid; v < nv4; v += THREADS) {
    const int i = head + 4 * v;
    float4 o = *reinterpret_cast<const float4*>(src + i);
    if (GOLD) {
      const uint32_t b = bits(i);
      o = make_float4(sign(o.x, b & 1), sign(o.y, (b >> 1) & 1),
                      sign(o.z, (b >> 2) & 1), sign(o.w, (b >> 3) & 1));
    }
    *reinterpret_cast<float4*>(dst + i) = o;
  }
  for (int i = head + 4 * nv4 + tid; i < n; i += THREADS)
    dst[i] = GOLD ? sign(src[i], bits(i) & 1) : src[i];
}

}  // namespace srsran_demap
