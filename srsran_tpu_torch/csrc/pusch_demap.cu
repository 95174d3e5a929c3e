// K3: fused PUSCH ZF equalize (1-2 layers) -> max-log demap -> descramble,
// for Hopper.
//
// Replaces srsran_tpu/ops/equalizer.py::equalize_zf_2xn (:55-80) and
// equalize_zf_1xn (:17-34), srsran_tpu/ops/modulation.py::demodulate
// (:112-130) and srsran_tpu/ops/scrambling.py::descramble_llrs (:21-24), fed
// by the data-RE gather of srsran_tpu/phy/upper/pusch.py::_frontend_hop
// (:209-219).  Twin: srsran_tpu_torch/ops/ul_demap.py::
// equalize_demap_descramble_ref.
//
// What bounds it.  Bytes: per RE it reads P complex samples and P L complex
// coefficients and writes L Qm float LLRs and L complex symbols; at the
// flagship (35,508 REs, 4 ports, 2 layers, QAM64) about 3.9 MB, 1.16 us at
// 3.35 TB/s, 1.7 MB of it the LLR writes.  The former design stored each
// RE's 12 LLRs from its own thread, 48 bytes from its neighbour's (every
// warp store touched 12 sectors, 12 times a RE), read one uint8 Gold byte a
// LLR, and took an IEEE division a LLR and six in the 2-layer solve.
//
// Design, K16's store path on K3's closed forms.  One thread per data RE,
// 64 REs a CTA.  The thread gathers y[p] and h[p][l] through the host RE
// plan and accumulates the Gram entries and matched-filter outputs over
// the P ports in registers, each product and sum rounded as the twin's.  It
// solves closed-form ZF: one layer x = z / |h|^2 by one reciprocal; two
// layers by one reciprocal of the determinant (clamped at 1e-12), then
// multiplies.  The demap (pusch_demap.cuh: one reciprocal of each layer's
// noise, clamped at 1e-12; for QPSK .. 256QAM exact max-log LLRs per real
// axis against the PAM level table, the same as modulation._pam_levels
// times the QAM scale, held by value in the launch's struct (K16's
// LxnParams); for BPSK and pi/2-BPSK the projection on (1 + j), pi/2-BPSK
// derotated by -j at odd codeword symbol indices) writes into shared
// memory, and x beside it.  The
// reciprocals are the SFU's (within 2 ulp), so the LLRs and x agree with
// the twin's quotients to a few ulp.  A CTA's REs are contiguous in
// codeword order (RE-major, layer-minor, then b0(I) b1(Q) b2(I) ...), so
// its LLRs and symbols are two contiguous spans: the CTA writes them as
// 16-byte vectors, each LLR's Gold sign flipped on the way from the plan's
// Gold bits packed 32 a word (a word a thread, loaded at the CTA's start
// and put in shared memory after the solve), with the call's Gold offset
// folded in.
//
// pi/2-BPSK's parity counts codeword symbols, RE-major and layer-minor,
// across both hops of a hopping PUSCH (the JAX package demaps the hops'
// symbols concatenated, srsran_tpu/phy/upper/pusch.py:274, :286-290), so a
// launch takes the parity of its first symbol, rot0: the wrapper derives it
// from the Gold offset (hop 2 starts where hop 1's bits ended).
//
// A slot axis (the slot-batch mode): blockIdx.y picks the slot, whose grid,
// coefficients, noise variance, LLRs and symbols lie at fixed strides; the
// RE plan, the level table and the Gold bits are shared (the scrambling
// c_init does not depend on the slot).  A slot is only an offset: each
// slot's arithmetic is its unbatched launch's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pusch_demap.cuh"

namespace {

using namespace srsran_demap;

constexpr int kDemapThreads = 64;     // REs a CTA
template <int L, int HALF>
__global__ void __launch_bounds__(kDemapThreads)
    pusch_demap_kernel(const float2* __restrict__ grid,
                       const float2* __restrict__ coeffs,
                       const int* __restrict__ sym, const int* __restrict__ sc,
                       const float* __restrict__ nv_ptr,
                       float* __restrict__ llr, float2* __restrict__ xout,
                       const __grid_constant__ LxnParams p,
                       const uint32_t* __restrict__ gold) {
  constexpr int QMAX = 2 * HALF;
  constexpr int kGoldWords = kDemapThreads * L * QMAX / 32 + 2;
  __shared__ __align__(16) float s_llr[kDemapThreads * L * QMAX + 4];
  __shared__ __align__(16) float s_x[kDemapThreads * L * 2 + 4];
  __shared__ uint32_t s_gold[kGoldWords];
  const int qm = p.kind < 2 ? 1 : QMAX;
  const int re0 = blockIdx.x * kDemapThreads;
  const int n = min(kDemapThreads, p.nre - re0);
  const size_t b = blockIdx.y;                       // slot
  const int tid = threadIdx.x;
  // the CTA's Gold words (one a thread at most), held in a register while
  // the solve runs and stored to shared memory after it
  static_assert(kGoldWords <= kDemapThreads, "a Gold word a thread");
  const int g0 = re0 * L * qm, w0 = g0 >> 5;
  const int nw = ((g0 + n * L * qm - 1) >> 5) - w0 + 2;
  const uint32_t word = tid < nw ? gold[w0 + tid] : 0u;
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
    float2 xs[L];
    float nvs[L];
    if constexpr (L == 1) {
      float energy = 0.f;
      float2 corr = make_float2(0.f, 0.f);
#pragma unroll 4
      for (int pp = 0; pp < p.P; ++pp) {
        const float2 y = y_p[pp * y_step];
        const float2 h = h_p[pp * h_step];
        energy = __fadd_rn(energy, abs2(h));
        corr = cadd(corr, cjmul(h, y));
      }
      const float inv = rcp(fmaxf(energy, 1e-12f));
      xs[0] = make_float2(__fmul_rn(corr.x, inv), __fmul_rn(corr.y, inv));
      nvs[0] = energy < 1e-12f ? 1e12f : __fmul_rn(nv, inv);
    } else {
      float a = 0.f, d = 0.f;
      float2 bb = make_float2(0.f, 0.f), z0 = bb, z1 = bb;
#pragma unroll 4
      for (int pp = 0; pp < p.P; ++pp) {
        const float2 y = y_p[pp * y_step];
        const float2 h0 = h_p[(pp * 2 + 0) * h_step];
        const float2 h1 = h_p[(pp * 2 + 1) * h_step];
        a = __fadd_rn(a, abs2(h0));
        d = __fadd_rn(d, abs2(h1));
        bb = cadd(bb, cjmul(h0, h1));
        z0 = cadd(z0, cjmul(h0, y));
        z1 = cadd(z1, cjmul(h1, y));
      }
      float det = __fsub_rn(__fmul_rn(a, d), abs2(bb));
      if (det < 1e-12f) det = 1e-12f;
      const float rdet = rcp(det);
      const float2 bz1 = cmul(bb, z1);
      const float2 cbz0 = cjmul(bb, z0);
      xs[0] = make_float2(__fmul_rn(__fsub_rn(__fmul_rn(d, z0.x), bz1.x), rdet),
                          __fmul_rn(__fsub_rn(__fmul_rn(d, z0.y), bz1.y), rdet));
      xs[1] = make_float2(
          __fmul_rn(__fsub_rn(__fmul_rn(a, z1.x), cbz0.x), rdet),
          __fmul_rn(__fsub_rn(__fmul_rn(a, z1.y), cbz0.y), rdet));
      nvs[0] = __fmul_rn(__fmul_rn(nv, d), rdet);
      nvs[1] = __fmul_rn(__fmul_rn(nv, a), rdet);
    }
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
        demap_axis_scaled<HALF>(xs[l].x, inv, p.levels, out);
        demap_axis_scaled<HALF>(xs[l].y, inv, p.levels, out + 1);
      }
    }
  }
  if (tid < nw) s_gold[tid] = word;
  __syncthreads();
  store_span<kDemapThreads, true>(llr_b, s_llr + ol, n * L * qm, s_gold, g0,
                                  w0);
  store_span<kDemapThreads, false>(x_b, s_x + ox, 2 * n * L, nullptr, 0, 0);
}

template <int L>
int launch(const float2* grid, const float2* coeffs, const int* sym,
           const int* sc, const float* nv, float* llr, float2* x,
           const LxnParams& p, const uint32_t* seq, cudaStream_t st) {
  const dim3 blocks((p.nre + kDemapThreads - 1) / kDemapThreads, p.nslots);
#define SRSRAN_DEMAP(H)                                                     \
  pusch_demap_kernel<L, H><<<blocks, kDemapThreads, 0, st>>>(               \
      grid, coeffs, sym, sc, nv, llr, x, p, seq)
  switch (p.half) {
    case 1: SRSRAN_DEMAP(1); break;
    case 2: SRSRAN_DEMAP(2); break;
    case 3: SRSRAN_DEMAP(3); break;
    case 4: SRSRAN_DEMAP(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SRSRAN_DEMAP
  return (int)cudaGetLastError();
}

inline bool params_ok(const LxnParams& p) {
  return p.nre >= 1 && p.P >= 1 && p.S >= 1 && p.K >= 1 && p.L >= 1 &&
         p.L <= 2 && p.T >= 1 && p.Ka >= 1 && p.kind >= 0 && p.kind <= 2 &&
         p.half >= 1 && p.half <= 4 && (p.kind == 2 || p.half == 1) &&
         p.mmse == 0 && p.nslots >= 1;
}

}  // namespace

// grid complex64 [slots, P, S, K]; coeffs complex64 [slots, P, L, T, Ka];
// sym, sc int32 [nre] (the data REs in codeword order); nv float [slots];
// llr float [slots, nre L Qm]; x complex64 [slots, nre, L]; params a
// LxnParams; seq int32 [nre L Qm / 32 + 1] the Gold bits of the launch's
// LLRs (from the call's Gold offset) packed 32 a word, bit b of word w for
// LLR 32 w + b (a spare word last).
extern "C" int srsran_pusch_demap(void* grid, void* coeffs, void* sym,
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
  return p->L == 1 ? launch<1>(g, h, si, ki, n, l, xo, *p, q, st)
                   : launch<2>(g, h, si, ki, n, l, xo, *p, q, st);
}
