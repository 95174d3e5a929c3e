// K20: the frequency-domain TDL fading channel, for Hopper.
//
// Replaces srsran_tpu/emulation/channel.py::run (:67-96) given its draws.
// Twin: srsran_tpu_torch/emulation/channel.py::apply_ref.
//
//   H[r,t,k]  = sum_d g[r,t,d] steer[d,k]
//   rx[r,s,k] = rot[s] sum_t H[r,t,k] tx[t,s,k]        (rot = 1 without CFO)
//   n0        = mean over all R*S*K REs of |rx|^2 / 10^(SINR/10)
//   rx       += sqrt(n0 / 2) noise[r,s,k]
//
// Design.  Launch 1 (tdl_mix_kernel): one block per (rx port r, 256
// subcarriers), one thread per subcarrier.  The block stages g[r] (T*D
// taps) in shared memory; a thread forms its T channel taps H[r,:,k] in
// registers (D complex MACs each, written once), then rx[r,s,k] for every
// symbol, and keeps sum |rx|^2 in double.  The block reduces those sums in
// a fixed tree order and writes one partial per block.  Launch 2
// (tdl_noise_kernel): every block first sums the R*ceil(K/256) partials
// serially, in index order (52 at the flagship), so each block derives the
// same n0 without atomics and a replay gives the same bits; then one
// thread per RE adds sqrt(n0/2) noise to rx.
//
// Bounds on this card: bytes.  At the flagship (4x4, 12 taps, 14 x 3276
// REs) tx and noise in, rx and H out, the steering table in: about 5 MB,
// some 1.5 us at 3.35 TB/s; launch 2 reads rx back once more (L2).  The
// 11 MFLOP of the products do not decide it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTx = 8;
constexpr int kMaxTaps = 16;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__global__ void tdl_mix_kernel(const float2* __restrict__ tx,
                               const float2* __restrict__ g,
                               const float2* __restrict__ steer,
                               const float2* __restrict__ rot, int use_rot,
                               int T, int S, int K, int D,
                               float2* __restrict__ h, float2* __restrict__ rx,
                               double* __restrict__ partial) {
  __shared__ float2 gs[kMaxTx * kMaxTaps];
  __shared__ double red[kThreads];
  const int r = blockIdx.y;
  for (int i = threadIdx.x; i < T * D; i += blockDim.x)
    gs[i] = g[(size_t)r * T * D + i];
  __syncthreads();
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  double acc = 0.0;
  if (k < K) {
    float2 hk[kMaxTx];
    for (int t = 0; t < T; ++t) {
      float2 a = make_float2(0.f, 0.f);
      for (int d = 0; d < D; ++d)
        a = cadd(a, cmul(gs[t * D + d], steer[(size_t)d * K + k]));
      hk[t] = a;
      h[((size_t)r * T + t) * K + k] = a;
    }
    for (int s = 0; s < S; ++s) {
      float2 y = make_float2(0.f, 0.f);
      for (int t = 0; t < T; ++t)
        y = cadd(y, cmul(hk[t], tx[((size_t)t * S + s) * K + k]));
      if (use_rot) y = cmul(y, rot[s]);
      rx[((size_t)r * S + s) * K + k] = y;
      acc += (double)y.x * y.x + (double)y.y * y.y;
    }
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[blockIdx.y * gridDim.x + blockIdx.x] = red[0];
}

__global__ void tdl_noise_kernel(float2* __restrict__ rx,
                                 const float2* __restrict__ noise,
                                 const double* __restrict__ partial, int np,
                                 double scale, int n) {
  __shared__ float amp;
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int i = 0; i < np; ++i) s += partial[i];     // fixed order
    amp = (float)sqrt(s * scale);
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float2 v = rx[i], z = noise[i];
  rx[i] = make_float2(v.x + amp * z.x, v.y + amp * z.y);
}

}  // namespace

// scale = 1 / (R * S * K * 10^(SINR/10) * 2): sqrt(sum * scale) = sqrt(n0/2).
extern "C" int srsran_tdl_channel(void* tx, void* g, void* steer, void* rot,
                                  int use_rot, int T, int R, int S, int K,
                                  int D, void* h, void* rx, void* partial,
                                  double scale, void* noise, void* stream) {
  if (T < 1 || T > kMaxTx || D < 1 || D > kMaxTaps || R < 1 || S < 1 ||
      K < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 mix((K + kThreads - 1) / kThreads, R);
  tdl_mix_kernel<<<mix, kThreads, 0, st>>>(
      (const float2*)tx, (const float2*)g, (const float2*)steer,
      (const float2*)rot, use_rot, T, S, K, D, (float2*)h, (float2*)rx,
      (double*)partial);
  const int n = R * S * K;
  tdl_noise_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (float2*)rx, (const float2*)noise, (const double*)partial,
      (int)(mix.x * mix.y), scale, n);
  return (int)cudaGetLastError();
}
