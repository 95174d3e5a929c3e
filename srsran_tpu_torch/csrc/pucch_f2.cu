// K13: PUCCH format 2 data demodulation for Hopper.
//
// Replaces the tail of srsran_tpu/phy/upper/pucch.py::process_format2
// (:764-775): for each of the 8 * nof_rb data REs of each symbol, the
// maximum-ratio combination over the rx ports with the channel estimate,
// x = sum_p conj(h_p) y_p / max(sum_p |h_p|^2, 1e-12), the post-combining
// noise nv = mean_p(noise_var) / max(energy, 1e-12), max-log QPSK LLRs
// ((y + a)^2 - (y - a)^2) / max(nv, 1e-12) per axis, and the Gold
// descramble (sign flip).  It reads K8's coefficients and noise on the
// device.  Twin: srsran_tpu_torch/phy/upper/pucch.py::f2_demap_ref.
//
// Bounds on this card: bytes, (P + 1) x 8 bytes read and 8 bytes written
// per RE, 16 to 256 REs a PDU: a launch and one thread's latency chain.
//
// Design.  One CTA a slot (blockIdx.x; grid, coefficients, noise and LLRs
// per slot), one thread a (symbol, data RE).  Nothing is looked up before
// the loads: the RE's subcarrier is closed-form (the 8 of each PRB's 12
// with k % 3 != 1, JAX pucch.py:728-731) and the PDU's Gold bits come
// packed 32 a word in the parameter struct (F2DemapParams::gold, by
// value), so
// a thread issues every port's grid value and coefficient and the P noise
// values at entry, sums them in port order, flips the signs by the bits of
// one parameter word and writes its two LLRs in one 8-byte store.  The
// code is kept short (a CTA this small waits on fetching its instructions
// as much as on its loads): 32-bit offsets (the wrapper refuses more than
// 2^31 elements), the sums as fused multiply-adds, and for the twin's
// five divisions two by __fdividef, with the max-log difference (x + a)^2
// - (x - a)^2 taken as the 4 a x it equals.  So the LLRs are rounded in
// another way than the twin's: a few ulp of each LLR's magnitude, and
// near x = 0 none of the twin's cancellation, far inside K13's tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF2MaxPorts = 8;
constexpr int kF2GoldWords = 17;      // 512 bits (16 RB x 2 symbols) + 1
constexpr int kF2MaxThreads = 256;    // 16 RB x 8 REs x 2 symbols

}  // namespace

// K13's launch, by value (srsran_tpu_torch/kernels/_build.py
// F2DemapParams): the grid [slots, P, S, K], the data REs a symbol (nd = 8
// nof_rb), the PDU's symbols, first symbol and first subcarrier, the
// coefficients a port (12 nof_rb), the CTA's threads, the QPSK level and
// the Gold bits of the PDU's c_init (bit b of word w for LLR 32 w + b).
struct F2DemapParams {
  int slots, P, S, K, nd, nsym, l0, sc0, nsc, threads;
  float level;
  uint32_t gold[kF2GoldWords];
};

namespace {

__global__ void __launch_bounds__(kF2MaxThreads)
pucch_f2_kernel(const float2* __restrict__ grid,
                const float2* __restrict__ coeffs,
                const float* __restrict__ noise_var, float2* __restrict__ llr,
                const F2DemapParams p) {
  const int gid = threadIdx.x, b = blockIdx.x;
  if (gid >= p.nsym * p.nd) return;
  const int s = gid >= p.nd, j = gid - s * p.nd;      // nsym <= 2
  const int m = j & 7;
  const int k = (j >> 3) * 12 + m + ((m + 1) >> 1);   // k % 3 != 1
  const float2* y = grid + ((b * p.P * p.S + p.l0 + s) * p.K + p.sc0 + k);
  const float2* h = coeffs + (b * p.P * p.nsc + k);
  const float* nz = noise_var + b * p.P;
  const int ystride = p.S * p.K;
  float2 yv[kF2MaxPorts], hv[kF2MaxPorts];
  float nv[kF2MaxPorts];
#pragma unroll
  for (int q = 0; q < kF2MaxPorts; ++q) {
    if (q >= p.P) break;
    yv[q] = __ldg(y + q * ystride);
    hv[q] = __ldg(h + q * p.nsc);
    nv[q] = __ldg(nz + q);
  }
  float noise = 0.f, energy = 0.f;
  float2 corr = make_float2(0.f, 0.f);
#pragma unroll
  for (int q = 0; q < kF2MaxPorts; ++q) {
    if (q >= p.P) break;
    noise += nv[q];
    corr.x = fmaf(hv[q].y, yv[q].y, fmaf(hv[q].x, yv[q].x, corr.x));
    corr.y = fmaf(-hv[q].y, yv[q].x, fmaf(hv[q].x, yv[q].y, corr.y));
    energy = fmaf(hv[q].y, hv[q].y, fmaf(hv[q].x, hv[q].x, energy));
  }
  // (x + a)^2 - (x - a)^2 = 4 a x, x = corr / den, over nv = noise / den
  const float inv_den = __fdividef(1.f, fmaxf(energy, 1e-12f));
  const float scale = __fdividef(
      4.f * p.level, fmaxf(noise / (float)p.P * inv_den, 1e-12f));
  const float li = corr.x * inv_den * scale;
  const float lq = corr.y * inv_den * scale;
  const uint32_t bits = p.gold[gid >> 4] >> (2 * (gid & 15));
  llr[b * p.nsym * p.nd + gid] =
      make_float2(__int_as_float(__float_as_int(li) ^ (bits & 1) << 31),
                  __int_as_float(__float_as_int(lq) ^ (bits >> 1 & 1) << 31));
}

}  // namespace

// For `slots` slots (F2DemapParams): grid c64 [slots, P, S, K]; coeffs c64
// [slots, P, 12 * nof_rb] (K8's [P, 1, 1, .] per slot); noise_var f32
// [slots, P]; llr f32 [slots, 2 * nsym * nd].
extern "C" int srsran_pucch_f2_demap(const void* grid, const void* coeffs,
                                     const void* noise_var, void* llr,
                                     void* stream, const void* params) {
  const F2DemapParams* p = (const F2DemapParams*)params;
  const int n = p->nsym * p->nd;
  if (p->P < 1 || p->P > kF2MaxPorts || p->nd < 8 || p->nd % 8 ||
      p->nsym < 1 || p->nsym > 2 || p->slots < 1 || p->nsc != 3 * p->nd / 2 ||
      2 * n > 32 * (kF2GoldWords - 1) || p->threads < n ||
      p->threads > kF2MaxThreads || p->threads % 32)
    return (int)cudaErrorInvalidValue;
  pucch_f2_kernel<<<p->slots, p->threads, 0, (cudaStream_t)stream>>>(
      (const float2*)grid, (const float2*)coeffs, (const float*)noise_var,
      (float2*)llr, *p);
  return (int)cudaGetLastError();
}
