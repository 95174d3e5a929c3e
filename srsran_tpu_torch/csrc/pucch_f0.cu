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
// Design.  One block per F0 PDU and slot (a slot batch runs its B slots as
// B blocks of one launch: blockIdx.x is the slot, the references shared or
// one set per slot).  One thread per (candidate, port, symbol)
// correlates 12 subcarriers; one thread per candidate sums its terms in a
// fixed order; one thread takes the energy, the metric and the first
// maximum and writes the decision.  Bounds on this card: a few hundred
// multiply-adds on ~800 bytes at the flagship (4 ports, 2 symbols, 8
// candidates): the kernel is launch-bound by nature, and is worth the ~10
// launches of its twin.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr int MAX_C = 8;
constexpr int MAX_P = 8;
constexpr int MAX_S = 2;

__device__ __forceinline__ float abs2(float2 a) { return a.x * a.x + a.y * a.y; }

__global__ void pucch_f0_kernel(const float2* __restrict__ grid, int P,
                                int nsym_grid, int nsc_grid, int S, int l0,
                                int prb0, int prb1,
                                const float2* __restrict__ refs,
                                long long refs_stride, int C,
                                const int8_t* __restrict__ maps, int nb,
                                float threshold, bool* __restrict__ detected,
                                float* __restrict__ metric_out,
                                int8_t* __restrict__ out,
                                long long* __restrict__ best_out) {
  __shared__ float tsq[MAX_C * MAX_P * MAX_S];
  __shared__ float corr[MAX_C];
  const int t = threadIdx.x;
  const size_t b = blockIdx.x;                         // slot
  grid += b * P * nsym_grid * nsc_grid;
  refs += b * refs_stride;
  detected += b;
  metric_out += b;
  out += b * (nb + 1);
  best_out += b;
  if (t < C * P * S) {
    const int c = t / (P * S), r = t % (P * S), p = r / S, s = r % S;
    const int prb = s == 0 ? prb0 : prb1;
    const float2* rx =
        grid + ((size_t)p * nsym_grid + l0 + s) * nsc_grid + prb * 12;
    const float2* ref = refs + ((size_t)c * S + s) * 12;
    float2 acc = make_float2(0.f, 0.f);
    for (int n = 0; n < 12; ++n) {  // rx * conj(ref)
      const float2 a = rx[n], b = ref[n];
      acc.x += a.x * b.x + a.y * b.y;
      acc.y += a.y * b.x - a.x * b.y;
    }
    tsq[t] = abs2(acc);
  }
  __syncthreads();
  if (t < C) {
    float acc = 0.f;
    for (int i = 0; i < P * S; ++i) acc += tsq[t * P * S + i];
    corr[t] = acc / 12.f;
  }
  __syncthreads();
  if (t == 0) {
    float energy = 0.f;
    for (int p = 0; p < P; ++p)
      for (int s = 0; s < S; ++s) {
        const int prb = s == 0 ? prb0 : prb1;
        const float2* rx =
            grid + ((size_t)p * nsym_grid + l0 + s) * nsc_grid + prb * 12;
        for (int n = 0; n < 12; ++n) energy += abs2(rx[n]);
      }
    float cmax = corr[0];
    for (int c = 1; c < C; ++c) cmax = fmaxf(cmax, corr[c]);
    const float noise = fmaxf(energy - cmax, 1e-9f) / 12.f;
    int best = 0;
    float mbest = corr[0] / noise;
    for (int c = 1; c < C; ++c) {
      const float m = corr[c] / noise;
      if (m > mbest) {
        mbest = m;
        best = c;
      }
    }
    *detected = mbest > threshold;
    *metric_out = mbest;
    *best_out = best;
    for (int i = 0; i <= nb; ++i) out[i] = maps[best * (nb + 1) + i];
  }
}

}  // namespace

// For `slots` slots: grid c64 [slots, P, nsym, nsc]; refs c64 [C, S, 12],
// one set per slot when refs_stride = C * S * 12 (0: shared); maps int8
// [C, 1 + nb] (SR, then HARQ bits); outputs per slot detected bool, metric
// f32, out int8 [1 + nb], best int64.
extern "C" int srsran_pucch_f0(void* grid, int P, int nsym_grid, int nsc_grid,
                               int S, int l0, int prb0, int prb1, void* refs,
                               long long refs_stride, int C, void* maps,
                               int nb, float threshold, void* detected,
                               void* metric, void* out, void* best,
                               int slots, void* stream) {
  if (P < 1 || P > MAX_P || S < 1 || S > MAX_S || C < 1 || C > MAX_C ||
      nb < 0 || nb > 2 || slots < 1)
    return (int)cudaErrorInvalidValue;
  pucch_f0_kernel<<<slots, NT, 0, (cudaStream_t)stream>>>(
      (const float2*)grid, P, nsym_grid, nsc_grid, S, l0, prb0, prb1,
      (const float2*)refs, refs_stride, C, (const int8_t*)maps, nb, threshold,
      (bool*)detected, (float*)metric, (int8_t*)out, (long long*)best);
  return (int)cudaGetLastError();
}
