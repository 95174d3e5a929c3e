// K16: fused PUSCH L x N equalize (ZF or MMSE) -> max-log demap ->
// descramble, for Hopper: the cases K3 (pusch_demap.cu) does not take --
// MMSE with 1-2 layers and ZF or MMSE with 3-4 layers (it takes ZF with 1-2
// layers too, for the tests).
//
// Replaces srsran_tpu/ops/equalizer.py::equalize_mmse_1xn (:37-52) and
// equalize_lxn (:83-118), as dispatched by equalize (:121-137), with
// ops/modulation.py::demodulate (:112-130) and ops/scrambling.py::
// descramble_llrs (:21-24), fed by the data-RE gather of
// srsran_tpu/phy/upper/pusch.py::_frontend_hop (:209-219).  Twin:
// srsran_tpu_torch/ops/ul_demap.py::equalize_demap_descramble_ref.
//
// What bounds it.  Bytes: per RE it reads P complex samples and P L complex
// coefficients and writes L Qm float LLRs and L complex symbols; at the
// 4-layer QAM64 UE of the two-UE slot (27,060 REs, 4 ports) about 4.6 MB,
// some 1.4 us at 3.35 TB/s, 3.5 MB of it the LLR and symbol writes.  The
// former design kept four full 4 x 4 complex matrices live a thread (the
// Gram, the factor, its inverse and A^-1: 128 floats), took an IEEE
// division inside its triple loop (30 a RE at L = 4) and one per LLR, and
// stored each RE's 24 LLRs from its own thread, 96 bytes from its
// neighbour's: every warp store touched 32 sectors, 28 times a RE.
//
// Design.  One thread per data RE, 64 REs a CTA, registers capped for 12
// CTAs an SM (80, no spill): UE A's 423 CTAs run three or four an SM, a
// batch of four (1,692) nearly in one wave.  The thread gathers y[p] and
// h[p][l] through the host RE plan (the ports' loads issued together) and
// accumulates the upper triangle of G = H^H H (10 complex values at L = 4)
// and z = H^H y.  One layer: the 1 x N closed forms (ZF, or MMSE with x =
// z / (|h|^2 + nv)), one reciprocal.  Two to four layers: A = G + c I (c =
// nv for MMSE, 1e-9 for ZF) factored in place as L D L^H (unit lower L,
// real D; one reciprocal per pivot), x by forward substitution, D^-1 and
// back substitution -- no inverse is formed.  The output noise column by
// column: w = L^-1 e_l by forward substitution; ZF nv [A^-1]_ll = nv sum_k
// |w_k|^2 / d_k; MMSE nv c^H G c with c = A^-1 e_l = L^-H D^-1 w (from G
// itself, not A^-1 - c A^-2, which cancels at low SNR); 1e12 where it is
// not positive.  The reciprocals are the SFU's (within 2 ulp): an
// IEEE-rounded one branches to a slow path that serialises the layers'
// chains.  The JAX package inverts A by LU with pivoting, so the two round
// differently: parity is to a tolerance.  Then the demap (pusch_demap.cuh's,
// shared with K3: one reciprocal of the layer's noise, then multiplies;
// each bit's two minima as trees; every modulation from BPSK to 256QAM,
// pi/2-BPSK's parity from the launch's first codeword symbol) into shared
// memory, and x beside it.  A CTA's REs are contiguous in codeword order,
// so its LLRs and symbols are two contiguous spans: the CTA writes them as
// 16-byte vectors (pusch_demap.cuh's store_span; the staging offset matches
// the span's alignment), each LLR's Gold sign flipped on the way from the
// plan's Gold bits packed 32 a word, the CTA's words loaded into shared
// memory at its start.
//
// A slot axis (the slot-batch mode): blockIdx.y picks the slot, whose grid,
// coefficients, noise variance, LLRs and symbols lie at fixed strides; the
// RE plan, the level table and the Gold bits are shared.  A slot is only an
// offset: each slot's arithmetic is its unbatched launch's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pusch_demap.cuh"

namespace {

using srsran_demap::LxnParams;
using srsran_demap::rcp;

constexpr int kLxnThreads = 64;      // REs a CTA
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cconj(float2 a) {
  return make_float2(a.x, -a.y);
}

__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// acc + conj(a) b
__device__ __forceinline__ float2 cjfma(float2 a, float2 b, float2 acc) {
  return make_float2(fmaf(a.x, b.x, fmaf(a.y, b.y, acc.x)),
                     fmaf(a.x, b.y, fmaf(-a.y, b.x, acc.y)));
}

__device__ __forceinline__ float abs2(float2 a) {
  return fmaf(a.x, a.x, a.y * a.y);
}

// Packed upper triangle of an L x L Hermitian matrix (j <= i) and strict
// lower triangle of the unit factor (i > j).
template <int L>
__host__ __device__ constexpr int up(int j, int i) {
  return j * L - j * (j - 1) / 2 + (i - j);
}
__host__ __device__ constexpr int lo(int i, int j) {
  return i * (i - 1) / 2 + j;
}

template <int L, bool MMSE>
__device__ __forceinline__ void solve(const float2 (&g)[L * (L + 1) / 2],
                                      const float2 (&z)[L], float nv,
                                      float2 (&x)[L], float (&nvs)[L]) {
  if constexpr (L == 1) {
    const float e = g[0].x;
    if constexpr (MMSE) {
      const float inv = rcp(fmaxf(e + nv, 1e-12f));
      x[0] = cscale(z[0], inv);
      nvs[0] = e < 1e-12f ? 1e12f : nv * e * inv * inv;
    } else {
      const float inv = rcp(fmaxf(e, 1e-12f));
      x[0] = cscale(z[0], inv);
      nvs[0] = e < 1e-12f ? 1e12f : nv * inv;
    }
  } else {
    const float ridge = MMSE ? nv : 1e-9f;
    // A = L D L^H in place: d, its reciprocals, the factor's lower part.
    float d[L], rd[L];
    float2 f[L * (L - 1) / 2];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      float dj = g[up<L>(j, j)].x + ridge;
#pragma unroll
      for (int k = 0; k < j; ++k) dj -= abs2(f[lo(j, k)]) * d[k];
      d[j] = fmaxf(dj, 1e-30f);
      rd[j] = rcp(d[j]);
#pragma unroll
      for (int i = j + 1; i < L; ++i) {
        float2 v = cconj(g[up<L>(j, i)]);                  // A[i][j]
#pragma unroll
        for (int k = 0; k < j; ++k)
          v = csub(v, cscale(cmul(f[lo(i, k)], cconj(f[lo(j, k)])), d[k]));
        f[lo(i, j)] = cscale(v, rd[j]);
      }
    }
    // x: L u = z, v = D^-1 u, L^H x = v.
    float2 u[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      u[i] = z[i];
#pragma unroll
      for (int k = 0; k < i; ++k) u[i] = csub(u[i], cmul(f[lo(i, k)], u[k]));
    }
#pragma unroll
    for (int i = L - 1; i >= 0; --i) {
      float2 v = cscale(u[i], rd[i]);
#pragma unroll
      for (int k = i + 1; k < L; ++k)
        v = csub(v, cmul(cconj(f[lo(k, i)]), x[k]));
      x[i] = v;
    }
    // The noise diagonal, a column at a time: w = L^-1 e_l.
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float2 w[L];
#pragma unroll
      for (int k = 0; k < L; ++k) {
        w[k] = make_float2(k == l ? 1.f : 0.f, 0.f);
        if (k > l) {
#pragma unroll
          for (int m = l; m < k; ++m)
            w[k] = csub(w[k], cmul(f[lo(k, m)], w[m]));
        }
      }
      float diag = 0.f;
      if constexpr (MMSE) {
        // c = A^-1 e_l = L^-H D^-1 w, then c^H G c.
        float2 c[L];
#pragma unroll
        for (int i = L - 1; i >= 0; --i) {
          float2 v = i >= l ? cscale(w[i], rd[i]) : make_float2(0.f, 0.f);
#pragma unroll
          for (int k = i + 1; k < L; ++k)
            v = csub(v, cmul(cconj(f[lo(k, i)]), c[k]));
          c[i] = v;
        }
        float off = 0.f;
#pragma unroll
        for (int m = 0; m < L; ++m) {
          diag = fmaf(g[up<L>(m, m)].x, abs2(c[m]), diag);
#pragma unroll
          for (int n = m + 1; n < L; ++n)
            off += cmul(cconj(c[m]), cmul(g[up<L>(m, n)], c[n])).x;
        }
        diag = fmaf(2.f, off, diag);
      } else {
#pragma unroll
        for (int k = l; k < L; ++k) diag = fmaf(abs2(w[k]), rd[k], diag);
      }
      nvs[l] = diag <= 0.f ? 1e12f : nv * diag;
    }
  }
}

template <int L, bool MMSE, int HALF>
__global__ void __launch_bounds__(kLxnThreads, 12)
    pusch_demap_lxn_kernel(const float2* __restrict__ grid,
                           const float2* __restrict__ coeffs,
                           const int* __restrict__ sym,
                           const int* __restrict__ sc,
                           const float* __restrict__ nv_ptr,
                           float* __restrict__ llr, float2* __restrict__ xout,
                           const __grid_constant__ LxnParams p,
                           const uint32_t* __restrict__ gold) {
  constexpr int QMAX = 2 * HALF;
  constexpr int kGoldWords = kLxnThreads * L * QMAX / 32 + 2;
  __shared__ __align__(16) float s_llr[kLxnThreads * L * QMAX + 4];
  __shared__ __align__(16) float s_x[kLxnThreads * L * 2 + 4];
  __shared__ uint32_t s_gold[kGoldWords];
  const int qm = p.kind < 2 ? 1 : QMAX;
  const int re0 = blockIdx.x * kLxnThreads;
  const int n = min(kLxnThreads, p.nre - re0);
  const size_t b = blockIdx.y;                       // slot
  const int tid = threadIdx.x;
  // the CTA's Gold words, loaded while the solve runs
  const int g0 = re0 * L * qm, w0 = g0 >> 5;
  const int nw = ((g0 + n * L * qm - 1) >> 5) - w0 + 2;
  for (int i = tid; i < nw; i += kLxnThreads) s_gold[i] = gold[w0 + i];
  float* llr_b = llr + (b * p.nre + re0) * (size_t)(L * qm);
  float* x_b = reinterpret_cast<float*>(xout + (b * p.nre + re0) * (size_t)L);
  // staging offsets: shared index o + i lies at dst + i's alignment
  const int ol = (int)(((uintptr_t)llr_b >> 2) & 3);
  const int ox = (int)(((uintptr_t)x_b >> 2) & 3);
  if (tid < n) {
    const int re = re0 + tid;
    const int s = sym[re];
    const int k = sc[re];
    const int t = p.T == 1 ? 0 : s;
    const float nv = nv_ptr[b];
    const float2* y_p = grid + b * (size_t)p.P * p.S * p.K +
                        (size_t)s * p.K + k;
    const float2* h_p = coeffs + b * (size_t)p.P * L * p.T * p.Ka +
                        (size_t)t * p.Ka + (k - p.sc_off);
    const size_t y_step = (size_t)p.S * p.K, h_step = (size_t)p.T * p.Ka;
    float2 g[L * (L + 1) / 2], z[L];
#pragma unroll
    for (int i = 0; i < L * (L + 1) / 2; ++i) g[i] = make_float2(0.f, 0.f);
#pragma unroll
    for (int l = 0; l < L; ++l) z[l] = make_float2(0.f, 0.f);
#pragma unroll 4
    for (int pp = 0; pp < p.P; ++pp) {
      const float2 y = y_p[pp * y_step];
      float2 h[L];
#pragma unroll
      for (int l = 0; l < L; ++l) h[l] = h_p[(pp * L + l) * h_step];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        z[l] = cjfma(h[l], y, z[l]);
#pragma unroll
        for (int m = l; m < L; ++m)
          g[up<L>(l, m)] = cjfma(h[l], h[m], g[up<L>(l, m)]);
      }
    }
    float2 xs[L];
    float nvs[L];
    solve<L, MMSE>(g, z, nv, xs, nvs);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int si = tid * L + l;                    // the CTA's symbol
      s_x[ox + 2 * si] = xs[l].x;
      s_x[ox + 2 * si + 1] = xs[l].y;
      const float inv = rcp(fmaxf(nvs[l], 1e-12f));
      if (p.kind < 2) {
        float2 v = xs[l];
        if (p.kind == 1 && ((p.rot0 + re * L + l) & 1))
          v = make_float2(v.y, -v.x);
        s_llr[ol + si] = (2.f * ((v.x + v.y) * p.two_scale)) * inv;
      } else {
        float* out = s_llr + ol + si * QMAX;
        srsran_demap::demap_axis_scaled<HALF>(xs[l].x, inv, p.levels, out);
        srsran_demap::demap_axis_scaled<HALF>(xs[l].y, inv, p.levels,
                                        out + 1);
      }
    }
  }
  __syncthreads();
  srsran_demap::store_span<kLxnThreads, true>(llr_b, s_llr + ol, n * L * qm,
                                             s_gold, g0, w0);
  srsran_demap::store_span<kLxnThreads, false>(x_b, s_x + ox, 2 * n * L,
                                              nullptr, 0, 0);
}

template <int L, bool MMSE>
int launch(const float2* grid, const float2* coeffs, const int* sym,
           const int* sc, const float* nv, float* llr, float2* x,
           const LxnParams& p, const uint32_t* seq, cudaStream_t st) {
  const dim3 blocks((p.nre + kLxnThreads - 1) / kLxnThreads, p.nslots);
#define SRSRAN_LXN(H)                                                       \
  pusch_demap_lxn_kernel<L, MMSE, H><<<blocks, kLxnThreads, 0, st>>>(       \
      grid, coeffs, sym, sc, nv, llr, x, p, seq)
  switch (p.half) {
    case 1: SRSRAN_LXN(1); break;
    case 2: SRSRAN_LXN(2); break;
    case 3: SRSRAN_LXN(3); break;
    case 4: SRSRAN_LXN(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SRSRAN_LXN
  return (int)cudaGetLastError();
}

inline bool params_ok(const LxnParams& p) {
  return p.nre >= 1 && p.P >= 1 && p.S >= 1 && p.K >= 1 && p.L >= 1 &&
         p.L <= 4 && p.T >= 1 && p.Ka >= 1 && p.kind >= 0 && p.kind <= 2 &&
         p.half >= 1 && p.half <= 4 && (p.kind == 2 || p.half == 1) &&
         p.nslots >= 1;
}

}  // namespace

// grid complex64 [slots, P, S, K]; coeffs complex64 [slots, P, L, T, Ka];
// sym, sc int32 [nre] (the data REs in codeword order); nv float [slots];
// llr float [slots, nre L Qm]; x complex64 [slots, nre, L]; params an
// LxnParams; seq int32 [nre L Qm / 32 + 1] the Gold bits of the launch's
// LLRs packed 32 a word, bit b of word w for LLR 32 w + b (a spare word
// last).
extern "C" int srsran_pusch_demap_lxn(void* grid, void* coeffs, void* sym,
                                      void* sc, void* nv, void* llr, void* x,
                                      void* stream, const void* params,
                                      const void* seq) {
  const LxnParams* p = (const LxnParams*)params;
  if (!params_ok(*p)) return (int)cudaErrorInvalidValue;
  const float2* g = (const float2*)grid;
  const float2* h = (const float2*)coeffs;
  const int* si = (const int*)sym;
  const int* ki = (const int*)sc;
  const float* n = (const float*)nv;
  float* l = (float*)llr;
  float2* xo = (float2*)x;
  const uint32_t* q = (const uint32_t*)seq;
  cudaStream_t st = (cudaStream_t)stream;
  switch (p->L * 2 + (p->mmse ? 1 : 0)) {
    case 2: return launch<1, false>(g, h, si, ki, n, l, xo, *p, q, st);
    case 3: return launch<1, true>(g, h, si, ki, n, l, xo, *p, q, st);
    case 4: return launch<2, false>(g, h, si, ki, n, l, xo, *p, q, st);
    case 5: return launch<2, true>(g, h, si, ki, n, l, xo, *p, q, st);
    case 6: return launch<3, false>(g, h, si, ki, n, l, xo, *p, q, st);
    case 7: return launch<3, true>(g, h, si, ki, n, l, xo, *p, q, st);
    case 8: return launch<4, false>(g, h, si, ki, n, l, xo, *p, q, st);
    case 9: return launch<4, true>(g, h, si, ki, n, l, xo, *p, q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
