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
// Design.  One block per rx port and slot (a slot batch runs its B slots in
// one launch: blockIdx.y is the slot; grid, TA, RSRP and outputs per slot,
// the sequences shared); the comb (K = 24 at the flagship, at most
// 1632) is read from the grid straight into registers, every sum is a
// fixed-order block tree (the same bits on every run).  Bounds on this card:
// bytes (a few KB): the kernel is launch-bound; its worth is the ~25 plain
// launches of the twin it replaces.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_L = 8;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ float2 block_sum2(float2 v, float2* sh) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] = cadd(sh[t], sh[t + s]);
    __syncthreads();
  }
  const float2 r = sh[0];
  __syncthreads();
  return r;
}

__global__ void srs_noise_kernel(const float2* __restrict__ grid,
                                 int nsym_grid, int nsc_grid,
                                 const int* __restrict__ syms,
                                 const int* __restrict__ cols,
                                 const float2* __restrict__ expected, int L,
                                 int S, int K, float c,
                                 const float* __restrict__ ta,
                                 const float* __restrict__ rsrp, int dof,
                                 float* __restrict__ out, int P) {
  __shared__ float2 sh[NT];
  __shared__ float2 wb[MAX_L];
  const int p = blockIdx.x;
  const size_t b = blockIdx.y;                         // slot
  grid += b * P * nsym_grid * nsc_grid;
  rsrp += b * P;
  out += b * 2 * P;
  const float cta = c * ta[b];
  auto rx = [&](int s, int k) {
    return grid[((size_t)p * nsym_grid + syms[s]) * nsc_grid + cols[k]];
  };
  auto ramp = [&](int k) {
    float sn, cs;
    sincosf(cta * (float)k, &sn, &cs);
    return make_float2(cs, sn);
  };
  for (int l = 0; l < L; ++l) {
    float2 acc = make_float2(0.f, 0.f);
    for (int k = threadIdx.x; k < K; k += NT) {
      float2 m = make_float2(0.f, 0.f);
      for (int s = 0; s < S; ++s) {
        const float2 e = expected[((size_t)l * S + s) * K + k];
        m = cadd(m, cmul(rx(s, k), make_float2(e.x, -e.y)));
      }
      m = make_float2(m.x / (float)S, m.y / (float)S);
      acc = cadd(acc, cmul(m, ramp(k)));
    }
    acc = block_sum2(acc, sh);
    if (threadIdx.x == 0) wb[l] = make_float2(acc.x / (float)K, acc.y / (float)K);
  }
  __syncthreads();
  float nz = 0.f;
  for (int k = threadIdx.x; k < K; k += NT) {
    const float2 r = ramp(k);
    const float2 rc = make_float2(r.x, -r.y);
    float2 recon = make_float2(0.f, 0.f);
    for (int l = 0; l < L; ++l)
      recon = cadd(recon, cmul(wb[l], cmul(expected[(size_t)l * S * K + k], rc)));
    float2 acc = make_float2(0.f, 0.f);
    for (int s = 0; s < S; ++s) acc = cadd(acc, rx(s, k));
    const float2 d = make_float2(acc.x - (float)S * recon.x,
                                 acc.y - (float)S * recon.y);
    const float m = hypotf(d.x, d.y);
    nz += m * m;
  }
  nz = block_sum2(make_float2(nz, 0.f), sh).x;
  if (threadIdx.x == 0) {
    float nv = nz / ((float)S * (float)dof);
    nv = fmaxf(nv, rsrp[p] * 1e-6f);
    out[p] = nv;
    out[P + p] = rsrp[p] / fmaxf(nv, 1e-12f);
  }
}

}  // namespace

// For `slots` slots of grid c64 [slots, P, nsym, nsc], ta f32 [slots] and
// rsrp f32 [slots, P]: out float [slots, 2P] = noise_var [P], snr [P].
extern "C" int srsran_srs_noise(void* grid, int P, int nsym_grid, int nsc_grid,
                                void* syms, void* cols, void* expected, int L,
                                int S, int K, float c, void* ta, void* rsrp,
                                int dof, void* out, int slots, void* stream) {
  if (L > MAX_L || slots < 1) return (int)cudaErrorInvalidValue;
  srs_noise_kernel<<<dim3(P, slots), NT, 0, (cudaStream_t)stream>>>(
      (const float2*)grid, nsym_grid, nsc_grid, (const int*)syms,
      (const int*)cols, (const float2*)expected, L, S, K, c, (const float*)ta,
      (const float*)rsrp, dof, (float*)out, P);
  return (int)cudaGetLastError();
}
