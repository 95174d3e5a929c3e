// K11: the SRS-specific noise estimate for Hopper.
//
// Replaces the tail of srsran_tpu/phy/upper/srs.py::estimate (:98-118),
// which runs after the generic channel estimate (K8 here): per rx port, the
// TA-compensated wideband coefficient of every SRS port (phase ramp from
// K8's TA, read on the device), the reconstruction of all ports' sequences,
// the residual of the symbol-accumulated received comb over K - L degrees of
// freedom, its MAX_SINR floor against K8's RSRP, and the SNR.
// Twin: srsran_tpu_torch/phy/upper/srs.py::srs_noise_ref.
//
// Bounds on this card: bytes, a few KB (K = 24 comb REs of 4 rx ports at
// the flagship): a launch and one warp's latency chain, never bytes or
// operations.  So the design cuts the chain.
//
// Design.  A warp per (rx port, slot), no barrier: a CTA holds the warps
// of SrsNoiseParams::ppc rx ports of one slot (blockIdx.y; the grid, TA,
// RSRP and outputs per slot, the sequences shared), lane r takes
// subcarriers r, r + 32 W, ... (J of them, J a power of two the entry
// dispatches on).  Nothing is looked up: the comb's columns are closed
// form (sc0 + comb k, srs.py::sc_indices) and its symbols a range from s0,
// so each lane issues its S rx loads and its L sequence values a
// subcarrier, the TA and the RSRP at entry.  The sequences are [L, K] (a
// port's sequence is the same on every SRS symbol), so the symbol sum
// acc[k] = sum_s rx[s, k] is formed once and feeds both the L correlations
// conj(e_l) acc ramp and the residual acc - S sum_l wb_l e_l conj(ramp);
// the ramp exp(j c ta k) is one sincosf a subcarrier (full range
// reduction: the phase reaches hundreds of radians at K = 1632).  The L
// complex sums go through one 5-round __shfl_xor_sync butterfly together
// (a fixed order: the same bits on every run), the residual's energy
// through a second.  Past K = 256 a port takes W = 2..8 warps, each
// summing its share, joined by one shared-memory step and one barrier per
// sum (the flagship, W = 1, has none).  The code is kept short: 32-bit
// offsets (the wrapper refuses more than 2^31 elements), fused products,
// no integer division, 1 / (S K) as one product; the noise quotient and
// the SNR stay IEEE divisions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSrsMaxRxPorts = 16;
constexpr int kSrsMaxLayers = 8;      // SRS ports (sequences)
constexpr int kSrsMaxSymbols = 4;
constexpr int kSrsMaxWarps = 8;       // warps a CTA
constexpr int kSrsMaxPerLane = 8;     // subcarriers a lane

}  // namespace

// K11's launch, by value (srsran_tpu_torch/kernels/_build.py
// SrsNoiseParams): the grid [slots, P, nsym, nsc]; the comb's S symbols
// from s0 and K subcarriers sc0 + comb k; L sequences; lw the log2 of a
// port's warps W, ppc the rx ports a CTA, J the subcarriers a lane; the
// TA's and the RSRP's elements a slot; c the ramp's phase a second and a
// comb sample, inv_sk 1 / (S K), sdof S max(K - L, 1).
struct SrsNoiseParams {
  int slots, P, nsym, nsc, sc0, comb, s0, S, K, L, lw, ppc, J, ta_stride,
      rsrp_stride;
  float c, inv_sk, sdof;
};

namespace {

constexpr unsigned kFull = 0xffffffffu;

// acc + a b and acc + a conj(b) as fused multiply-adds (explicit: the
// library builds with --fmad=false)
__device__ __forceinline__ float2 cmac(float2 acc, float2 a, float2 b) {
  return make_float2(fmaf(-a.y, b.y, fmaf(a.x, b.x, acc.x)),
                     fmaf(a.y, b.x, fmaf(a.x, b.y, acc.y)));
}
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(fmaf(a.y, b.y, a.x * b.x), fmaf(-a.x, b.y, a.y * b.x));
}

template <int J, int NL>
__global__ void __launch_bounds__(32 * kSrsMaxWarps)
srs_noise_kernel(const float2* __restrict__ grid, const float* __restrict__ ta,
                 const float* __restrict__ rsrp, float* __restrict__ out,
                 const float2* __restrict__ seq, const SrsNoiseParams p) {
  __shared__ float2 part[kSrsMaxWarps][NL];
  __shared__ float nz_part[kSrsMaxWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = warp & ((1 << p.lw) - 1);
  const int port = blockIdx.x * p.ppc + (warp >> p.lw);
  const int b = blockIdx.y;
  if (port >= p.P) return;                // W = 1 only: no barrier below
  const int step = 32 << p.lw;
  const int r0 = (sub << 5) + lane;

  // Every global load first: the lane's S rx values and L sequence values
  // a subcarrier, the TA.
  const float2* g =
      grid + ((b * p.P + port) * p.nsym + p.s0) * p.nsc + p.sc0;
  const float cta = p.c * __ldg(ta + b * p.ta_stride);
  float2 x[J][kSrsMaxSymbols], e[J][NL];
#pragma unroll
  for (int i = 0; i < J; ++i) {
    const int k = r0 + i * step;
    if (k < p.K) {
#pragma unroll
      for (int s = 0; s < kSrsMaxSymbols; ++s)
        if (s < p.S) x[i][s] = __ldg(g + s * p.nsc + p.comb * k);
#pragma unroll
      for (int l = 0; l < NL; ++l)
        if (l < p.L) e[i][l] = __ldg(seq + l * p.K + k);
    }
  }
  const float rs = __ldg(rsrp + b * p.rsrp_stride + port);

  // The symbol sums, the ramps and the L correlations.
  float2 acc[J], ramp[J], corr[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) corr[l] = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < J; ++i) {
    const int k = r0 + i * step;
    acc[i] = make_float2(0.f, 0.f);
    ramp[i] = make_float2(0.f, 0.f);
    if (k < p.K) {
      acc[i] = x[i][0];
#pragma unroll
      for (int s = 1; s < kSrsMaxSymbols; ++s)
        if (s < p.S)
          acc[i] = make_float2(acc[i].x + x[i][s].x, acc[i].y + x[i][s].y);
      sincosf(cta * (float)k, &ramp[i].y, &ramp[i].x);
#pragma unroll
      for (int l = 0; l < NL; ++l)
        if (l < p.L) {
          const float2 m = cmul_conj(acc[i], e[i][l]);
          corr[l] = cmac(corr[l], m, ramp[i]);
        }
    }
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      corr[l].x += __shfl_xor_sync(kFull, corr[l].x, m);
      corr[l].y += __shfl_xor_sync(kFull, corr[l].y, m);
    }
  if (p.lw) {                             // a port's W warps: one join
    if (lane == 0)
#pragma unroll
      for (int l = 0; l < NL; ++l) part[sub][l] = corr[l];
    __syncthreads();
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      corr[l] = part[0][l];
      for (int w = 1; w < (1 << p.lw); ++w)
        corr[l] = make_float2(corr[l].x + part[w][l].x,
                              corr[l].y + part[w][l].y);
    }
  }
  float2 wb[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l)
    wb[l] = make_float2(corr[l].x * p.inv_sk, corr[l].y * p.inv_sk);

  // The residual of the reconstruction, from the registers.
  const float fs = (float)p.S;
  float nz = 0.f;
#pragma unroll
  for (int i = 0; i < J; ++i) {
    if (r0 + i * step < p.K) {
      float2 recon = make_float2(0.f, 0.f);
#pragma unroll
      for (int l = 0; l < NL; ++l)
        if (l < p.L) recon = cmac(recon, wb[l], cmul_conj(e[i][l], ramp[i]));
      const float2 d = make_float2(fmaf(-fs, recon.x, acc[i].x),
                                   fmaf(-fs, recon.y, acc[i].y));
      nz = fmaf(d.x, d.x, fmaf(d.y, d.y, nz));
    }
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) nz += __shfl_xor_sync(kFull, nz, m);
  if (p.lw) {
    if (lane == 0) nz_part[sub] = nz;
    __syncthreads();
    if (sub != 0) return;
    for (int w = 1; w < (1 << p.lw); ++w) nz += nz_part[w];
  }
  if (lane == 0) {
    const float nv = fmaxf(nz / p.sdof, rs * 1e-6f);
    out[b * 2 * p.P + port] = nv;
    out[b * 2 * p.P + p.P + port] = rs / fmaxf(nv, 1e-12f);
  }
}

using SrsKernel = void (*)(const float2*, const float*, const float*, float*,
                           const float2*, const SrsNoiseParams);

template <int J>
SrsKernel pick_layers(int L) {
  return L <= 1 ? srs_noise_kernel<J, 1> : L <= 2 ? srs_noise_kernel<J, 2>
       : L <= 4 ? srs_noise_kernel<J, 4> : srs_noise_kernel<J, 8>;
}

}  // namespace

// For `slots` slots of grid c64 [slots, P, nsym, nsc] (SrsNoiseParams), ta
// f32 (one a slot, ta_stride apart), rsrp f32 [slots, P] (rows rsrp_stride
// apart) and the sequences c64 [L, K]: out f32 [slots, 2, P] = noise_var
// [P], snr [P].
extern "C" int srsran_srs_noise(const void* grid, const void* ta,
                                const void* rsrp, void* out, void* stream,
                                const void* params, const void* seq) {
  const SrsNoiseParams* p = (const SrsNoiseParams*)params;
  const int W = 1 << p->lw;
  if (p->slots < 1 || p->P < 1 || p->P > kSrsMaxRxPorts || p->L < 1 ||
      p->L > kSrsMaxLayers || p->S < 1 || p->S > kSrsMaxSymbols ||
      p->K < 1 || p->lw < 0 || W > kSrsMaxWarps || p->ppc < 1 ||
      p->ppc * W > kSrsMaxWarps || (p->lw && p->ppc != 1) ||
      (p->J != 1 && p->J != 2 && p->J != 4 && p->J != kSrsMaxPerLane) ||
      32 * W * p->J < p->K)
    return (int)cudaErrorInvalidValue;
  const SrsKernel k = p->J == 1 ? pick_layers<1>(p->L)
                    : p->J == 2 ? pick_layers<2>(p->L)
                    : p->J == 4 ? pick_layers<4>(p->L)
                                : pick_layers<8>(p->L);
  const dim3 blocks((p->P + p->ppc - 1) / p->ppc, p->slots);
  k<<<blocks, 32 * p->ppc * W, 0, (cudaStream_t)stream>>>(
      (const float2*)grid, (const float*)ta, (const float*)rsrp, (float*)out,
      (const float2*)seq, *p);
  return (int)cudaGetLastError();
}
