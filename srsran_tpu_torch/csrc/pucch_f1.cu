// K10: PUCCH format 1 batch detection for Hopper.
//
// Replaces srsran_tpu/phy/upper/pucch.py::detect_format1_batch (:325-416):
// for every user multiplexed on one PUCCH F1 occasion (one PRB, one or two
// hops), the per-hop channel h0 [U, P] from the OCC-weighted DM-RS symbols,
// the channel energy, the matched-filter statistic z [U, D] of every data
// symbol, then mean, variance, detection metric, symbol estimate, detection
// flag and HARQ bits.  The host weights of f1_batch_weights (cyclic-shift
// phases with conj(base) folded in, OCC weights) arrive as device tensors,
// so the kernel reads the raw [P, S, 12] slice of each hop from the grid.
// Twin: srsran_tpu_torch/phy/upper/pucch.py::f1_detect_ref.
//
// Bounds on this card: a few thousand multiply-adds on ~6 KB at the
// flagship (4 ports x 14 symbols x 12 subcarriers, one user): a launch and
// one CTA's latency chain, never bytes or operations.  So the design cuts
// the chain.
//
// Design.  One CTA per (slot, user): blockIdx.x the slot (each weight
// array shared or one per slot, F1Params::stacked), blockIdx.y the user;
// the users' CTAs read the same hop slices, the second one from L2.  The
// matched filter factors through the per-(port, symbol) despread
//   t[p, s] = sum_n d0[p, s, n] w[s, n],  w = a_dm on DM-RS, ph on data
// symbols (a_dm = ph x the DM-RS OCC weight), so that
//   h0[p] = sum_{DM-RS s of the hop} t[p, s] / 12 / n_dm,
//   z[s]  = w_da[s] sum_p conj(h0[p]) t[p, s]
// (the twin's einsum over p and n, summed in another order).  Thread
// (p, s) = (t % 8, t / 8) with p < P issues its 12 grid loads and 12 weight
// loads at entry, lane s of warp 0 its w_da, before any barrier; each
// thread sums its 12 terms in registers (two chains) into shared memory.
// After the CTA's one barrier warp 0 alone finishes, every step spread
// over lanes: lane h P + q forms hop h's channel at port q from shared
// memory, lane s gathers its hop's P channels by shuffles and forms its
// symbol's z, one five-step __shfl_xor_sync butterfly sums z and the
// energy on every lane, a second the deviations from the mean, and lane 0
// writes the user's symbol, metric, bits and flag.  Every sum runs in a
// fixed order, so a call is deterministic.
//
// A CTA this small spends its time fetching its instructions and waiting
// on its loads, so the code is kept short: 32-bit offsets (the wrapper
// refuses more than 2^31 elements), no integer division, the complex
// products as fused multiply-adds, and reciprocals by __fdividef (the
// constants' ones made while the loads fly).  So the sums are rounded in
// another way than the twin's: products fused, |x|^2 as x x + y y where
// the twin squares a hypot, quotients within 2 ulp; a few ulp in all, far
// inside K10's tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF1MaxPorts = 8;
constexpr int kF1MaxSymbols = 14;
constexpr int kF1MaxUsers = 64;
constexpr int kF1MaxThreads = 128;    // >= 8 * kF1MaxSymbols

}  // namespace

// One hop of the occasion (srsran_tpu_torch/kernels/_build.py F1Hop): its
// PRB, first grid symbol, symbol count, first symbol relative to the
// allocation (DM-RS on its even symbols), DM-RS count (>= 1) and the index
// of its first symbol among both hops' (0, or hop 0's count).
struct F1Hop {
  int prb, l_lo, ns, s0, n_dm, first;
};

// K10's launch, by value (_build.py F1Params).  Bit 3 h + j of `stacked`:
// weight j (a_dm, ph, w_da) of hop h has a leading slot axis.
struct F1Params {
  int slots, U, P, nhops, nsym, S, K, stacked, n_data, threads;
  float threshold;
  F1Hop hop[2];
};

namespace {

// acc + a b and acc + conj(a) b as fused multiply-adds (explicit: the
// library builds with --fmad=false)
__device__ __forceinline__ float2 cmac(float2 acc, float2 a, float2 b) {
  return make_float2(fmaf(-a.y, b.y, fmaf(a.x, b.x, acc.x)),
                     fmaf(a.y, b.x, fmaf(a.x, b.y, acc.y)));
}
__device__ __forceinline__ float2 cjmac(float2 acc, float2 a, float2 b) {
  return make_float2(fmaf(a.y, b.y, fmaf(a.x, b.x, acc.x)),
                     fmaf(-a.y, b.x, fmaf(a.x, b.y, acc.y)));
}
__device__ __forceinline__ float abs2(float2 a) {
  return fmaf(a.x, a.x, a.y * a.y);
}

// Slot b's row of a weight array: shared, or one per slot (bit `bit` of
// the stacked mask), of `per_slot` elements a slot.
__device__ __forceinline__ const float2* slot_row(const float2* w, int stacked,
                                                  int bit, int b,
                                                  int per_slot) {
  return (stacked >> bit) & 1 ? w + b * per_slot : w;
}

__global__ void __launch_bounds__(kF1MaxThreads)
pucch_f1_kernel(const float2* __restrict__ grid,
                const float2* __restrict__ adm0, const float2* __restrict__ ph0,
                const float2* __restrict__ wda0,
                const float2* __restrict__ adm1, const float2* __restrict__ ph1,
                const float2* __restrict__ wda1,
                uint8_t* __restrict__ detected, float* __restrict__ metric,
                char2* __restrict__ bits, float2* __restrict__ d_hat,
                const F1Params p) {
  __shared__ float2 t_sh[kF1MaxPorts][kF1MaxSymbols];
  const int t = threadIdx.x, b = blockIdx.x, u = blockIdx.y;

  // Every global load first: thread (port t % 8, symbol t / 8) its grid
  // row and weight row, lane s of warp 0 its symbol's OCC weight.
  const int port = t & 7, s = t >> 3;
  const bool row_thread = port < p.P && s < p.nsym;
  float2 d[12], w[12];
  if (row_thread) {
    const int h = s >= p.hop[0].ns;
    const F1Hop hp = h ? p.hop[1] : p.hop[0];
    const int local = s - hp.first;
    const bool dmrs = ((hp.s0 + local) & 1) == 0;
    const int per_slot = p.U * hp.ns * 12;
    const float2* wr =
        dmrs ? slot_row(h ? adm1 : adm0, p.stacked, 3 * h, b, per_slot)
             : slot_row(h ? ph1 : ph0, p.stacked, 3 * h + 1, b, per_slot);
    wr += (u * hp.ns + local) * 12;
    const float2* gr =
        grid + (((b * p.P + port) * p.S + hp.l_lo + local) * p.K +
                hp.prb * 12);
#pragma unroll
    for (int k = 0; k < 12; ++k) d[k] = __ldg(gr + k);
#pragma unroll
    for (int k = 0; k < 12; ++k) w[k] = __ldg(wr + k);
  }
  float2 wda = make_float2(0.f, 0.f);
  bool data = false;
  if (t < p.nsym) {
    const int h = t >= p.hop[0].ns;
    const F1Hop hp = h ? p.hop[1] : p.hop[0];
    const int local = t - hp.first;
    data = ((hp.s0 + local) & 1) == 1;
    if (data)
      wda = __ldg(slot_row(h ? wda1 : wda0, p.stacked, 3 * h + 2, b,
                           p.U * hp.ns) + u * hp.ns + local);
  }
  // warp 0's reciprocals while the loads fly: lane h P + q's channel
  // scale 1 / (12 n_dm) of hop h, and 1 / D
  const int lane_hop = t >= p.P;
  const float inv_dm = __fdividef(
      1.f, 12.f * (float)(lane_hop ? p.hop[1].n_dm : p.hop[0].n_dm));
  const float inv_nd = __fdividef(1.f, (float)p.n_data);
  if (row_thread) {
    float2 acc0 = make_float2(0.f, 0.f), acc1 = acc0;
#pragma unroll
    for (int k = 0; k < 12; k += 2) {
      acc0 = cmac(acc0, d[k], w[k]);
      acc1 = cmac(acc1, d[k + 1], w[k + 1]);
    }
    t_sh[port][s] = make_float2(acc0.x + acc1.x, acc0.y + acc1.y);
  }
  __syncthreads();
  if (t >= 32) return;

  // Warp 0.  Lane h P + q forms hop h's channel at port q and its energy;
  // lane s gathers its hop's channels by shuffles and forms its symbol's
  // z; one butterfly sums z and the energy, a second the deviations.
  float2 h0 = make_float2(0.f, 0.f);
  float e = 0.f;
  if (t < p.nhops * p.P) {
    const int q = t - lane_hop * p.P;
    const F1Hop hp = lane_hop ? p.hop[1] : p.hop[0];
#pragma unroll
    for (int j = 0; j < kF1MaxSymbols; j += 2) {   // the loads side by side
      const int k = (hp.s0 & 1) + j;
      if (k < hp.ns) {
        h0.x += t_sh[q][hp.first + k].x;
        h0.y += t_sh[q][hp.first + k].y;
      }
    }
    h0 = make_float2(h0.x * inv_dm, h0.y * inv_dm);
    e = abs2(h0);
  }
  const int hop = t >= p.hop[0].ns;
  float2 z = make_float2(0.f, 0.f);
  for (int q = 0; q < p.P; ++q) {
    const float2 hq =
        make_float2(__shfl_sync(0xffffffffu, h0.x, hop * p.P + q),
                    __shfl_sync(0xffffffffu, h0.y, hop * p.P + q));
    if (data) z = cjmac(z, hq, t_sh[q][t]);
  }
  if (data) z = cmac(make_float2(0.f, 0.f), z, wda);
  float3 sums = make_float3(z.x, z.y, e);
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    sums.x += __shfl_xor_sync(0xffffffffu, sums.x, m);
    sums.y += __shfl_xor_sync(0xffffffffu, sums.y, m);
    sums.z += __shfl_xor_sync(0xffffffffu, sums.z, m);
  }
  const float2 zm = make_float2(sums.x * inv_nd, sums.y * inv_nd);
  float dev = data ? abs2(make_float2(z.x - zm.x, z.y - zm.y)) : 0.f;
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    dev += __shfl_xor_sync(0xffffffffu, dev, m);
  if (t != 0) return;
  const float inv_den =
      __fdividef(1.f, fmaxf(12.f * sums.z / (float)p.nhops, 1e-12f));
  const float2 dh = make_float2(zm.x * inv_den, zm.y * inv_den);
  const float m = __fdividef((float)p.n_data * abs2(zm),
                             fmaxf(dev * inv_nd, 1e-9f));
  const int o = b * p.U + u;
  d_hat[o] = dh;
  metric[o] = m;
  bits[o] = make_char2(dh.x < 0.f, dh.y < 0.f);
  detected[o] = m > p.threshold;
}

}  // namespace

// For `slots` slots of grid c64 [slots, P, S, K] (F1Params): hop 0's
// weights a_dm [(slots,) U, ns, 12], ph [(slots,) U, ns, 12], w_da
// [(slots,) U, ns] c64, then hop 1's (hop 0's again with one hop);
// detected uint8 [slots, U], metric f32 [slots, U], bits int8 [slots, U,
// 2], d_hat c64 [slots, U].
extern "C" int srsran_pucch_f1(const void* grid, const void* adm0,
                               const void* ph0, const void* wda0,
                               const void* adm1, const void* ph1,
                               const void* wda1, void* detected, void* metric,
                               void* bits, void* d_hat, void* stream,
                               const void* params) {
  const F1Params* p = (const F1Params*)params;
  if (p->P < 1 || p->P > kF1MaxPorts || p->U < 1 || p->U > kF1MaxUsers ||
      p->nhops < 1 || p->nhops > 2 || p->nsym < 1 ||
      p->nsym > kF1MaxSymbols || p->n_data < 1 || p->slots < 1 ||
      p->threads < 32 || p->threads > kF1MaxThreads || p->threads % 32 ||
      p->threads < 8 * p->nsym)
    return (int)cudaErrorInvalidValue;
  pucch_f1_kernel<<<dim3(p->slots, p->U), p->threads, 0,
                    (cudaStream_t)stream>>>(
      (const float2*)grid, (const float2*)adm0, (const float2*)ph0,
      (const float2*)wda0, (const float2*)adm1, (const float2*)ph1,
      (const float2*)wda1, (uint8_t*)detected, (float*)metric, (char2*)bits,
      (float2*)d_hat, *p);
  return (int)cudaGetLastError();
}
