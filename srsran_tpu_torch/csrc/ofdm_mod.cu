// K7: the passes before and after the IFFT of OFDM modulation, for Hopper.
//
// Replaces the non-FFT work of srsran_tpu/ops/ofdm.py::modulate_slot
// (:72-107): the half-spectrum swap of the [P, S, K] grid into N DFT bins
// with zeros between the halves (_grid_to_bins, :55) before the IFFT, and
// after it the per-symbol phase compensation e^{-j 2 pi f_c t_l} times the
// scale, with the cyclic-prefix insertion gather of _cp_insert_plan (:111)
// into [P, T] samples.  The IFFT itself stays cuFFT (torch.fft.ifft), as
// the JAX package left it to XLA, and the compensation multiplies after it,
// as the JAX package does, so the kernel differs from its twin only by
// cuFFT's rounding.  Twin: srsran_tpu_torch/ops/ofdm.py::modulate_slot_ref.
//
// Design.  Two elementwise gathers, one thread per output element: the bins
// pass writes every bin (grid value or 0), the CP pass reads the host CP
// plan (output sample -> symbol * N + n) and the symbol's compensation
// factor from tiny device tables.  Bounds on this card: memory -- each pass
// moves about 2 MB at the flagship (4 x 14 x 4096 bins, 4 x 61,440 samples).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

__global__ void ofdm_grid_to_bins_kernel(const float2* __restrict__ grid,
                                         float2* __restrict__ bins, int P,
                                         int S, int K, int N) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)P * S * N;
  if (gid >= total) return;
  const int n = (int)(gid % N);
  const long long ps = gid / N;
  const int half = K / 2;
  float2 v = make_float2(0.f, 0.f);
  if (n < K - half)
    v = grid[ps * K + half + n];
  else if (n >= N - half)
    v = grid[ps * K + n - (N - half)];
  bins[gid] = v;
}

__global__ void ofdm_cp_insert_kernel(const float2* __restrict__ x,
                                      float2* __restrict__ out,
                                      const int* __restrict__ plan,
                                      const float2* __restrict__ comp, int P,
                                      int S, int N, int T) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)P * T;
  if (gid >= total) return;
  const int t = (int)(gid % T);
  const int p = (int)(gid / T);
  const int src = plan[t];
  out[gid] = cmul(x[(size_t)p * S * N + src], comp[src / N]);
}

}  // namespace

extern "C" int srsran_ofdm_grid_to_bins(void* grid, void* bins, int P, int S,
                                        int K, int N, void* stream) {
  const long long total = (long long)P * S * N;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  ofdm_grid_to_bins_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float2*)grid, (float2*)bins, P, S, K, N);
  return (int)cudaGetLastError();
}

extern "C" int srsran_ofdm_cp_insert(void* x, void* out, void* plan,
                                     void* comp, int P, int S, int N, int T,
                                     void* stream) {
  const long long total = (long long)P * T;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  ofdm_cp_insert_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float2*)x, (float2*)out, (const int*)plan, (const float2*)comp,
      P, S, N, T);
  return (int)cudaGetLastError();
}
