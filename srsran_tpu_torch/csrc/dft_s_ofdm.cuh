// Device functions shared by K18 (the DFT-s-OFDM PUSCH) and K19 (PUCCH
// F3/F4) in dft_s_ofdm.cu: asynchronous copies into shared memory, the
// port combining of a few REs with all their loads in flight, the M-point
// IDFT as a mixed-radix Stockham FFT in shared memory (radix 4, 2, 3 and 5
// stages, the plan by value), a CTA sum, and the demap of a block of
// symbols from shared memory with coalesced LLR writes; the demap of one
// symbol with its Gold sign (demap_symbol) is pusch_demap.cuh's, shared with
// K3 and K16.  The twin of the IDFT is srsran_tpu_torch/ops/
// transform_precode.py::deprecode, its plan ops/transform_precode.py::
// fft_plan.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "pusch_demap.cuh"

namespace srsran_dfts {

using namespace srsran_demap;

constexpr int kMaxThreads = 1024;
constexpr int kMaxStages = 8;
constexpr int kMaxLevels = 16;

// Mirrors kernels/_build.py::FftPlan: the Stockham stages of the M-point
// IDFT.  Stage s has radix radix[s]; its input holds sub-transforms of
// span[s] points (the product of the earlier radices), and its twiddle for
// element r of butterfly j is tw[r * (j mod span) * step] with step = M /
// (span * radix), an exact index below M.  j / span is __umulhi(j,
// magic[s]) with magic = 2^32 / span + 1 (0 for span 1, where j mod span
// is 0), exact for every j < M / radix of the sizes the host plans
// (checked there).
struct FftPlan {
  int M, stages;
  int radix[kMaxStages];
  int span[kMaxStages];
  int step[kMaxStages];
  unsigned magic[kMaxStages];
  float scale;               // 1 / sqrt(M), from float64, rounded once
};

// cp.async: a copy of 4 or 8 bytes from device into shared memory that
// the thread does not wait for; cp_async_wait() waits for the thread's own
// copies (a CTA barrier after it publishes them to the others).
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The CTA's asynchronous copy of n 8-byte and then w 4-byte words.
__device__ __forceinline__ void prefetch(float2* dst8, const float2* src8,
                                         int n, uint32_t* dst4,
                                         const uint32_t* src4, int w) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    cp_async8(dst8 + i, src8 + i);
  for (int i = threadIdx.x; i < w; i += blockDim.x)
    cp_async4(dst4 + i, src4 + i);
}

// REs per thread in flight at once in the equalizers, ports per batch of
// loads, and the most noise values (hops x ports) a launch reads.
constexpr int kReUnroll = 2;
constexpr int kPortBatch = 4;
constexpr int kMaxNoise = 64;

// For U REs at once: the sums over the P ports of |h|^2 and conj(h) y,
// each in port order; the loads of kPortBatch ports of all U REs are
// issued together.  RE u's
// sample of port q is grid[q ystride + yoff[u]], its coefficient
// coeffs[q hstride + hoff[u]].
template <int U>
__device__ __forceinline__ void combine(
    const float2* __restrict__ grid, const float2* __restrict__ coeffs,
    const size_t (&yoff)[U], const size_t (&hoff)[U], size_t ystride,
    size_t hstride, int P, float (&energy)[U], float2 (&corr)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    energy[u] = 0.f;
    corr[u] = make_float2(0.f, 0.f);
  }
  for (int q0 = 0; q0 < P; q0 += kPortBatch) {
    float2 y[U][kPortBatch], h[U][kPortBatch];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < kPortBatch; ++j)
        if (q0 + j < P) {
          y[u][j] = grid[(size_t)(q0 + j) * ystride + yoff[u]];
          h[u][j] = coeffs[(size_t)(q0 + j) * hstride + hoff[u]];
        }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < kPortBatch; ++j)
        if (q0 + j < P) {
          energy[u] = __fadd_rn(energy[u], abs2(h[u][j]));
          corr[u] = cadd(corr[u], cjmul(h[u][j], y[u][j]));
        }
  }
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}

__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(__fmul_rn(a.x, s), __fmul_rn(a.y, s));
}

// i * a
__device__ __forceinline__ float2 cmuli(float2 a) {
  return make_float2(-a.y, a.x);
}

// In-place R-point inverse DFT, y_q = sum_r v_r exp(2j pi r q / R); the
// constants are cos and sin of 2 pi / R multiples in float64, rounded once.
template <int R>
__device__ __forceinline__ void idft_small(float2 (&v)[R]);

template <>
__device__ __forceinline__ void idft_small<2>(float2 (&v)[2]) {
  const float2 a = v[0];
  v[0] = cadd(a, v[1]);
  v[1] = csub(a, v[1]);
}

template <>
__device__ __forceinline__ void idft_small<4>(float2 (&v)[4]) {
  const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
  const float2 t2 = cadd(v[1], v[3]), t3 = cmuli(csub(v[1], v[3]));
  v[0] = cadd(t0, t2);
  v[1] = cadd(t1, t3);
  v[2] = csub(t0, t2);
  v[3] = csub(t1, t3);
}

template <>
__device__ __forceinline__ void idft_small<3>(float2 (&v)[3]) {
  constexpr float kS = (float)0.86602540378443864676;      // sin(2 pi / 3)
  const float2 t = cadd(v[1], v[2]);
  const float2 u = cmuli(cscale(csub(v[1], v[2]), kS));
  const float2 m = csub(v[0], cscale(t, 0.5f));
  v[0] = cadd(v[0], t);
  v[1] = cadd(m, u);
  v[2] = csub(m, u);
}

template <>
__device__ __forceinline__ void idft_small<5>(float2 (&v)[5]) {
  constexpr float kC1 = (float)0.30901699437494742410;     // cos(2 pi / 5)
  constexpr float kC2 = (float)-0.80901699437494742410;    // cos(4 pi / 5)
  constexpr float kS1 = (float)0.95105651629515357212;     // sin(2 pi / 5)
  constexpr float kS2 = (float)0.58778525229247312917;     // sin(4 pi / 5)
  const float2 t1 = cadd(v[1], v[4]), s1 = csub(v[1], v[4]);
  const float2 t2 = cadd(v[2], v[3]), s2 = csub(v[2], v[3]);
  const float2 a1 = cadd(v[0], cadd(cscale(t1, kC1), cscale(t2, kC2)));
  const float2 a2 = cadd(v[0], cadd(cscale(t1, kC2), cscale(t2, kC1)));
  const float2 b1 = cmuli(cadd(cscale(s1, kS1), cscale(s2, kS2)));
  const float2 b2 = cmuli(csub(cscale(s1, kS2), cscale(s2, kS1)));
  v[0] = cadd(v[0], cadd(t1, t2));
  v[1] = cadd(a1, b1);
  v[4] = csub(a1, b1);
  v[2] = cadd(a2, b2);
  v[3] = csub(a2, b2);
}

// One Stockham stage: butterfly j (of M / R) reads src[j + r M / R],
// twiddles element r by tw[r k step] (k = j mod span), transforms, and
// writes dst[(j - k) R + k + r span] times ``scale`` (1 but in the last
// stage: an exact product).  After the last stage the result is in natural
// order.
template <int R>
__device__ __forceinline__ void fft_stage(const float2* src, float2* dst,
                                          const float2* tw, int M, int span,
                                          int step, unsigned magic,
                                          float scale) {
  const int nb = M / R;
  for (int j = threadIdx.x; j < nb; j += blockDim.x) {
    const int k =
        span == 1 ? 0 : j - (int)__umulhi((unsigned)j, magic) * span;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = src[j + r * nb];
    if (k) {
      const int t = k * step;
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], tw[r * t]);
    }
    idft_small<R>(v);
    const int d = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[d + r * span] = cscale(v[r], scale);
  }
}

// The unitary M-point IDFT of a (shared, M points) with b as the other
// ping-pong buffer, 1 / sqrt(M) applied in the last stage; returns the
// buffer that holds the result (the other is then free).  tw: the table
// exp(2j pi m / M), m < M, in shared memory.  Ends synchronized.
__device__ __forceinline__ float2* idft(float2* a, float2* b,
                                        const float2* tw, const FftPlan& p) {
#pragma unroll 1
  for (int s = 0; s < p.stages; ++s) {
    const int span = p.span[s], step = p.step[s];
    const unsigned magic = p.magic[s];
    const float sc = s == p.stages - 1 ? p.scale : 1.f;
    switch (p.radix[s]) {
      case 4: fft_stage<4>(a, b, tw, p.M, span, step, magic, sc); break;
      case 2: fft_stage<2>(a, b, tw, p.M, span, step, magic, sc); break;
      case 3: fft_stage<3>(a, b, tw, p.M, span, step, magic, sc); break;
      default: fft_stage<5>(a, b, tw, p.M, span, step, magic, sc); break;
    }
    __syncthreads();
    float2* t = a;
    a = b;
    b = t;
  }
  return a;
}

// The plan's checks, for the C entry points.
inline bool plan_ok(const FftPlan& p) {
  if (p.M < 1 || p.stages < 0 || p.stages > kMaxStages) return false;
  int span = 1;
  for (int s = 0; s < p.stages; ++s) {
    const int r = p.radix[s];
    if ((r < 2 || r > 5) || p.span[s] != span ||
        span * r * p.step[s] != p.M ||
        p.magic[s] != (span == 1 ? 0u : 0xFFFFFFFFu / span + 1))
      return false;
    span *= r;
  }
  return span == p.M;
}

// Sum of one float per thread over the CTA (blockDim.x a multiple of 32, at
// most kMaxThreads); every thread gets the total, summed in a fixed order.
// red holds kMaxThreads / 32 floats of shared memory.
__device__ __forceinline__ float cta_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w)
    total = __fadd_rn(total, red[w]);
  return total;
}

// Demap symbols x[0..n) (shared memory) into their Qm LLRs each, with the
// Gold sign of seq (the block's first bit, shared memory) and pi/2-BPSK's
// parity counted from parity0, into llr (the block's first LLR); the
// symbols also to x_out unless it is null.  Up to Qm = 2 a warp's LLRs are
// one contiguous run already and go straight out; past that each chunk of
// symbols goes through demap_symbol into the shared stage (chunk * Qm
// floats), then out by consecutive threads on consecutive LLRs.
template <int HALF>
__device__ __forceinline__ void demap_block(
    const float2* x, int n, float nv, int kind, int parity0, float two_scale,
    const float* levels, const uint8_t* seq, float* __restrict__ llr,
    float2* __restrict__ x_out, float* stage, int chunk) {
  const int qm = kind < 2 ? 1 : 2 * HALF;
  const bool direct = qm <= 2;
  if (direct) chunk = n;
  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int cn = min(chunk, n - c0);
    for (int i = threadIdx.x; i < cn; i += blockDim.x) {
      const float2 xi = x[c0 + i];
      if (x_out) x_out[c0 + i] = xi;
      demap_symbol<HALF>(xi, nv, kind, (parity0 + c0 + i) & 1, two_scale,
                         levels, seq + (size_t)c0 * qm,
                         direct ? llr : stage, i);
    }
    if (direct) return;
    __syncthreads();
    for (int i = threadIdx.x; i < cn * qm; i += blockDim.x)
      llr[(size_t)c0 * qm + i] = stage[i];
    __syncthreads();
  }
}

}  // namespace srsran_dfts
