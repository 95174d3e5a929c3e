// K12: PUCCH format 0 detection for Hopper.
//
// Replaces srsran_tpu/phy/upper/pucch.py::detect_format0 (:120-180): the
// correlation of the occasion's REs rx [P, S <= 2, 12] with the C <= 8
// candidate cyclic shifts of the HARQ/SR dictionary (host references
// [C, S, 12], f0_refs_for), corr[c] = sum_{p,s} |t[c,p,s]|^2 / 12, the
// energy, the noise max(energy - max corr, 1e-9) / 12, the metric
// corr / noise, the first argmax, the detection flag and the HARQ/SR
// look-up of the winning candidate.
// Twin: srsran_tpu_torch/phy/upper/pucch.py::f0_detect_ref.
//
// Bounds on this card: a few hundred multiply-adds on ~800 bytes at the
// flagship (4 ports, 2 symbols, 8 candidates): a launch and one CTA's
// latency chain, never bytes or operations.  So the design cuts the chain.
//
// Design.  One warp a slot (blockIdx.x; the references shared or one set
// a slot, F0Params::refs_stride), no __syncthreads and no shared memory.
// Lane t takes row r = t % G of the candidates c = t / G + j 32 / G, j <
// F0Params::passes, where G = 2^lg is the smallest power of two >= P S,
// so each candidate's rows lie in one aligned group of G <= 16 lanes (8
// at the flagship: 4 candidates a pass, 2 passes).  Row r is (port r >>
// (S - 1), symbol r & (S - 1)).  Each row lane issues its 12 grid loads
// and its candidates' 12 reference loads each at entry, then forms its
// row's energy sum |rx|^2 and, per candidate, t = sum_n rx conj(ref) and
// |t|^2.  A segmented __shfl_xor_sync butterfly sums each group's lanes
// (every group sums the same energy in the same order; group 0's is
// taken), lane j < C fetches candidate j's sum by one shuffle a pass and
// finishes in lanes: corr / 12 (times the float 1 / 12, as the twin's
// scalar division on the card), a 3-step max butterfly, the noise, the
// quotient corr / noise as an IEEE division (the decisions must equal the
// twin's), and a 3-step (value, index) butterfly that keeps the lower
// index on ties, as torch.argmax; lanes 0..nb write the winner's SR and
// HARQ bits from F0Params::maps (one word by value), lane 0 the rest.
// The code is kept short (a warp this small waits on fetching its
// instructions as much as on its loads): 32-bit offsets (the wrapper
// refuses more than 2^31 elements), no integer division, the products as
// fused multiply-adds.  So the sums are rounded in another way than the
// twin's (products fused, |x|^2 as x x + y y where the twin squares a
// hypot, sums in butterfly order): a few ulp, inside K12's tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF0MaxPorts = 8;
constexpr int kF0MaxSymbols = 2;
constexpr int kF0MaxCandidates = 8;

}  // namespace

// K12's launch, by value (srsran_tpu_torch/kernels/_build.py F0Params):
// the grid [slots, P, nsym, nsc]; the occasion's S symbols from l0, symbol
// s at subcarriers sc0 (s = 0) or sc1 (s = 1) on; C candidates; lg the
// log2 of a candidate's lane group; the passes (1, 2 or 4) of 32 / 2^lg
// candidates; the references' elements a slot (0: shared); candidate c's
// SR bit at bit c (1 + nb) of maps, its HARQ bit i at bit c (1 + nb) + 1 +
// i.
struct F0Params {
  int slots, P, S, C, nb, lg, passes, nsym, nsc, l0, sc0, sc1, refs_stride;
  uint32_t maps;
  float threshold;
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
// x / 12 as the twin computes it on the card: PyTorch divides a tensor by
// a Python scalar as a product with the scalar's float reciprocal
constexpr float kInv12 = 1.f / 12.f;

__device__ __forceinline__ float abs2(float2 a) {
  return fmaf(a.x, a.x, a.y * a.y);
}

// acc + a conj(b) as fused multiply-adds (explicit: the library builds
// with --fmad=false)
__device__ __forceinline__ float2 cmac_conj(float2 acc, float2 a, float2 b) {
  return make_float2(fmaf(a.y, b.y, fmaf(a.x, b.x, acc.x)),
                     fmaf(-a.x, b.y, fmaf(a.y, b.x, acc.y)));
}

template <int J>
__global__ void __launch_bounds__(32)
pucch_f0_kernel(const float2* __restrict__ grid,
                const float2* __restrict__ refs, bool* __restrict__ detected,
                float* __restrict__ metric, int8_t* __restrict__ out,
                long long* __restrict__ best_out, const F0Params p) {
  const int t = threadIdx.x, b = blockIdx.x;
  const int r = t & ((1 << p.lg) - 1), q = t >> p.lg, lng = 5 - p.lg;
  const bool row = r < p.P * p.S;

  // Every global load first: the row's 12 REs and its candidates' 12
  // reference values each.
  float2 x[12], w[J][12];
  if (row) {
    const int s = r & (p.S - 1);
    const float2* gr =
        grid + ((b * p.P + (r >> (p.S - 1))) * p.nsym + p.l0 + s) * p.nsc +
        (s ? p.sc1 : p.sc0);
#pragma unroll
    for (int k = 0; k < 12; ++k) x[k] = __ldg(gr + k);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = q + (j << lng);
      if (c < p.C) {
        const float2* wr = refs + b * p.refs_stride + (c * p.S + s) * 12;
#pragma unroll
        for (int k = 0; k < 12; ++k) w[j][k] = __ldg(wr + k);
      }
    }
  }
  float tsq[J], e = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) tsq[j] = 0.f;
  if (row) {
    float e0 = 0.f, e1 = 0.f;
#pragma unroll
    for (int k = 0; k < 12; k += 2) {
      e0 += abs2(x[k]);
      e1 += abs2(x[k + 1]);
    }
    e = e0 + e1;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (q + (j << lng) < p.C) {
        float2 acc0 = make_float2(0.f, 0.f), acc1 = acc0;
#pragma unroll
        for (int k = 0; k < 12; k += 2) {
          acc0 = cmac_conj(acc0, x[k], w[j][k]);
          acc1 = cmac_conj(acc1, x[k + 1], w[j][k + 1]);
        }
        tsq[j] = abs2(make_float2(acc0.x + acc1.x, acc0.y + acc1.y));
      }
    }
  }
  // each candidate's rows summed over its lane group
  for (int m = (1 << p.lg) >> 1; m >= 1; m >>= 1) {
#pragma unroll
    for (int j = 0; j < J; ++j) tsq[j] += __shfl_xor_sync(kFull, tsq[j], m);
    e += __shfl_xor_sync(kFull, e, m);
  }
  const float energy = __shfl_sync(kFull, e, 0);
  // lane t < C: candidate t's sum, pass t >> lng of group t % 2^lng
  const int src = (t & ((1 << lng) - 1)) << p.lg, pass = t >> lng;
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float v = __shfl_sync(kFull, tsq[j], src);
    if (pass == j) sum = v;
  }
  const bool cand = t < p.C;
  const float corr = cand ? sum * kInv12 : 0.f;
  float cmax = corr;
#pragma unroll
  for (int m = kF0MaxCandidates >> 1; m >= 1; m >>= 1)
    cmax = fmaxf(cmax, __shfl_xor_sync(kFull, cmax, m));
  const float noise = fmaxf(energy - cmax, 1e-9f) * kInv12;
  float best = cand ? corr / noise : __int_as_float(0xff800000);  // -inf
  int bi = t;
#pragma unroll
  for (int m = kF0MaxCandidates >> 1; m >= 1; m >>= 1) {
    const float ov = __shfl_xor_sync(kFull, best, m);
    const int oi = __shfl_xor_sync(kFull, bi, m);
    if (ov > best || (ov == best && oi < bi)) {
      best = ov;
      bi = oi;
    }
  }
  if (t <= p.nb)
    out[b * (1 + p.nb) + t] = (p.maps >> (bi * (1 + p.nb) + t)) & 1u;
  if (t == 0) {
    detected[b] = best > p.threshold;
    metric[b] = best;
    best_out[b] = bi;
  }
}

}  // namespace

// For `slots` slots of grid c64 [slots, P, nsym, nsc] (F0Params): refs
// c64 [(slots,) C, S, 12]; per slot detected bool, metric f32, out int8
// [1 + nb] (SR, then the HARQ bits), best int64.
extern "C" int srsran_pucch_f0(const void* grid, const void* refs,
                               void* detected, void* metric, void* out,
                               void* best, void* stream, const void* params) {
  const F0Params* p = (const F0Params*)params;
  if (p->P < 1 || p->P > kF0MaxPorts || p->S < 1 || p->S > kF0MaxSymbols ||
      p->C < 1 || p->C > kF0MaxCandidates || p->nb < 0 || p->nb > 2 ||
      p->slots < 1 || p->lg < 0 || p->lg > 4 || (1 << p->lg) < p->P * p->S ||
      p->passes * (32 >> p->lg) < p->C)
    return (int)cudaErrorInvalidValue;
  const float2* g = (const float2*)grid;
  const float2* w = (const float2*)refs;
  cudaStream_t s = (cudaStream_t)stream;
  // a build for each pass count: the 4-pass build alone, which takes every
  // shape, ran 0.09-0.13 us slower a launch at 1 and 2 passes on an H100
  // (launch_profile --cases pucch_f0)
  if (p->passes == 1)
    pucch_f0_kernel<1><<<p->slots, 32, 0, s>>>(
        g, w, (bool*)detected, (float*)metric, (int8_t*)out, (long long*)best,
        *p);
  else if (p->passes == 2)
    pucch_f0_kernel<2><<<p->slots, 32, 0, s>>>(
        g, w, (bool*)detected, (float*)metric, (int8_t*)out, (long long*)best,
        *p);
  else
    pucch_f0_kernel<4><<<p->slots, 32, 0, s>>>(
        g, w, (bool*)detected, (float*)metric, (int8_t*)out, (long long*)best,
        *p);
  return (int)cudaGetLastError();
}
