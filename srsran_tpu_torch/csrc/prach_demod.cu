// K21: the PRACH occasion demodulator, for Hopper.
//
// Replaces srsran_tpu/phy/lower/prach_demod.py::demodulate (:29-52), the
// JAX package's [L_ra, N_u] bin matrix times each repetition's window.
// Twin: srsran_tpu_torch/phy/lower/prach_demod.py::demodulate_ref.
//
//   out[p, r, k] = sum_n tw[((b0 + k) n) mod N_u] x[p, s0 + r N_u + n],
//   tw[m] = e^{-2 pi i m / N_u} / sqrt(N_u)
//
// Design.  One CTA of 256 threads per (8 bins, repetition, port).  The
// twiddle index is kept in integers: each thread starts at (b n) mod N_u
// for its first sample and steps by (256 b) mod N_u with one conditional
// subtraction, so no phase is ever formed as 2 pi b n / N_u in float32
// (where b n reaches 10^10 for the long formats).  The table is built in
// float64 on the host and cast, as the JAX matrix is.  At N_u <= 6144
// (B4 on the flagship: N_u = 4096, 32 KB) the table sits in shared
// memory, which needs the opt-in above 48 KB; above (the long formats,
// N_u up to 98,304) it is read from global memory through L1/L2.  On the
// H100 the shared table is 1.4x faster than the same kernel reading it
// through L1/L2, at N_u = 4096 and 6144 alike.  Each thread reads each of
// its window samples once for its 8 bins; the 8 sums are reduced by warp
// shuffles, then over the 8 warps in order.
//
// Bound on this card: bytes.  B4 on the flagship moves 1.6 MB of window
// and output, 0.49 us at 3.35 TB/s; an N_u-point FFT per port and
// repetition would do 11.8 MFLOP (0.18 us at 67 TFLOP/s).  The kernel's
// direct sum does 8 L_ra N_u per row, 218.6 MFLOP, and its table gathers
// and integer index updates cost as much as the MACs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 8;
constexpr int kSmemMax = 6144;          // complex64 entries: 48 KB

template <bool kShared>
__global__ void prach_demod_kernel(const float2* __restrict__ x,
                                   int row_stride, int start, int n_u,
                                   int l_ra, int b0,
                                   const float2* __restrict__ tw,
                                   float2* __restrict__ out) {
  extern __shared__ float2 tws[];
  __shared__ float2 red[kThreads / 32][kBins];
  const int k0 = blockIdx.x * kBins, rep = blockIdx.y, p = blockIdx.z;
  const float2* table = tw;
  if (kShared) {
    for (int i = threadIdx.x; i < n_u; i += blockDim.x) tws[i] = tw[i];
    __syncthreads();
    table = tws;
  }
  const float2* win = x + (size_t)p * row_stride + start + (size_t)rep * n_u;
  int m[kBins], step[kBins];
  float2 acc[kBins];
#pragma unroll
  for (int j = 0; j < kBins; ++j) {
    const int k = k0 + j;
    const long long b = k < l_ra ? ((long long)b0 + k) % n_u : 0;
    m[j] = (int)((b * threadIdx.x) % n_u);
    step[j] = (int)((b * blockDim.x) % n_u);
    acc[j] = make_float2(0.f, 0.f);
  }
  for (int n = threadIdx.x; n < n_u; n += blockDim.x) {
    const float2 v = win[n];
#pragma unroll
    for (int j = 0; j < kBins; ++j) {
      const float2 w = table[m[j]];
      acc[j].x += w.x * v.x - w.y * v.y;
      acc[j].y += w.x * v.y + w.y * v.x;
      m[j] += step[j];
      if (m[j] >= n_u) m[j] -= n_u;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kBins; ++j) {
    float re = acc[j].x, im = acc[j].y;
    for (int o = 16; o > 0; o >>= 1) {
      re += __shfl_down_sync(0xffffffffu, re, o);
      im += __shfl_down_sync(0xffffffffu, im, o);
    }
    if (lane == 0) red[warp][j] = make_float2(re, im);
  }
  __syncthreads();
  if (threadIdx.x < kBins && k0 + threadIdx.x < l_ra) {
    float2 s = make_float2(0.f, 0.f);
    for (int w = 0; w < kThreads / 32; ++w) {
      s.x += red[w][threadIdx.x].x;
      s.y += red[w][threadIdx.x].y;
    }
    out[((size_t)p * gridDim.y + rep) * l_ra + k0 + threadIdx.x] = s;
  }
}

}  // namespace

extern "C" int srsran_prach_demod(void* x, int ports, int row_stride,
                                  int start, int n_u, int reps, int l_ra,
                                  int b0, void* tw, void* out, void* stream) {
  if (ports < 1 || reps < 1 || l_ra < 1 || n_u < 1 || b0 < 0 || b0 >= n_u)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((l_ra + kBins - 1) / kBins, reps, ports);
  if (n_u <= kSmemMax) {
    // the table and the 512 B of `red` pass the 48 KB a launch gets by
    // default once N_u > 6080
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        prach_demod_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemMax * (int)sizeof(float2));
    if (opt_in != cudaSuccess) return (int)opt_in;
    prach_demod_kernel<true><<<grid, kThreads, n_u * sizeof(float2), st>>>(
        (const float2*)x, row_stride, start, n_u, l_ra, b0,
        (const float2*)tw, (float2*)out);
  } else {
    prach_demod_kernel<false><<<grid, kThreads, 0, st>>>(
        (const float2*)x, row_stride, start, n_u, l_ra, b0,
        (const float2*)tw, (float2*)out);
  }
  return (int)cudaGetLastError();
}
