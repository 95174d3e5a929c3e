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
// Design.  One thread per (symbol, data RE); the port loop is sequential
// (P <= 8).  A slot batch runs its B slots in one launch (blockIdx.y is
// the slot; grid, coefficients, noise and LLRs per slot, the subcarrier
// plan and the scrambling sequence shared).  Bounds on this card: bytes, (P + 1) x 8 bytes read and 8 bytes
// written per RE (16 to 256 REs per PDU at most): launch-bound, worth the
// ~15 launches of its twin.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;

__device__ __forceinline__ float abs2(float2 a) {
  const float m = hypotf(a.x, a.y);
  return m * m;
}

__global__ void pucch_f2_kernel(const float2* __restrict__ grid, int P,
                                int nsym_grid, int nsc_grid,
                                const float2* __restrict__ coeffs,
                                const float* __restrict__ noise_var,
                                const int* __restrict__ data_sc, int nd,
                                int alloc0, int nsc_alloc, int l0, int S,
                                float level,
                                const uint8_t* __restrict__ gold,
                                float* __restrict__ llr) {
  const int gid = blockIdx.x * NT + threadIdx.x;
  if (gid >= S * nd) return;
  const size_t b = blockIdx.y;                         // slot
  grid += b * P * nsym_grid * nsc_grid;
  coeffs += b * P * nsc_alloc;
  noise_var += b * P;
  llr += b * 2 * S * nd;
  const int s = gid / nd, j = gid % nd;
  const int sc = data_sc[j];
  float noise = 0.f;
  for (int p = 0; p < P; ++p) noise += noise_var[p];
  noise = noise / (float)P;
  float2 corr = make_float2(0.f, 0.f);
  float energy = 0.f;
  for (int p = 0; p < P; ++p) {
    const float2 h = coeffs[(size_t)p * nsc_alloc + (sc - alloc0)];
    const float2 y = grid[((size_t)p * nsym_grid + l0 + s) * nsc_grid + sc];
    corr.x += h.x * y.x + h.y * y.y;  // conj(h) * y
    corr.y += h.x * y.y - h.y * y.x;
    energy += abs2(h);
  }
  const float den = fmaxf(energy, 1e-12f);
  const float nv = fmaxf(noise / den, 1e-12f);
  const float xr = corr.x / den, xi = corr.y / den;
  float li = ((xr + level) * (xr + level) - (xr - level) * (xr - level)) / nv;
  float lq = ((xi + level) * (xi + level) - (xi - level) * (xi - level)) / nv;
  const int k = 2 * gid;
  if (gold[k]) li = -li;
  if (gold[k + 1]) lq = -lq;
  llr[k] = li;
  llr[k + 1] = lq;
}

}  // namespace

// For `slots` slots: grid c64 [slots, P, nsym, nsc]; coeffs c64 [slots, P,
// 12 * nof_rb] (K8's [P, 1, 1, .] per slot); noise_var f32 [slots, P];
// data_sc int32 [nd] absolute subcarriers; gold uint8 [2 * S * nd]; llr f32
// [slots, 2 * S * nd].
extern "C" int srsran_pucch_f2_demap(void* grid, int P, int nsym_grid,
                                     int nsc_grid, void* coeffs,
                                     void* noise_var, void* data_sc, int nd,
                                     int alloc0, int l0, int S, float level,
                                     void* gold, void* llr, int slots,
                                     void* stream) {
  if (P < 1 || nd < 1 || nd % 8 || S < 1 || S > 2 || slots < 1)
    return (int)cudaErrorInvalidValue;
  const int n = S * nd;
  // 8 data REs of each PRB's 12 subcarriers
  pucch_f2_kernel<<<dim3((n + NT - 1) / NT, slots), NT, 0,
                    (cudaStream_t)stream>>>(
      (const float2*)grid, P, nsym_grid, nsc_grid, (const float2*)coeffs,
      (const float*)noise_var, (const int*)data_sc, nd, alloc0, 3 * nd / 2,
      l0, S, level, (const uint8_t*)gold, (float*)llr);
  return (int)cudaGetLastError();
}
