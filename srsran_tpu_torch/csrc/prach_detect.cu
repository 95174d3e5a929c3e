// K9: PRACH preamble detection for Hopper.
//
// Replaces srsran_tpu/phy/upper/prach.py::detect (:177-246): correlate the
// frequency-domain capture [P, S, L] with the conjugate of every root
// sequence, pack the two halves of the L bins into the IDFT input (zeros
// elsewhere), then -- after cuFFT's IDFT (torch.fft.ifft) -- the delay
// power summed over ports and symbols, and for every preamble its circular
// search window, the local noise reference, the per-bin metric, the first
// maximum, the metric times the window, the timing advance and the
// threshold decision.  The JAX package runs a Python loop of ~8 ops per
// preamble (64 at the flagship); here it is one launch.
// Twin: srsran_tpu_torch/phy/upper/prach.py::detect_ref.
//
// Design.  Pass 1 (prach_corr_kernel): one thread per IDFT input bin
// [P, S, R, N] writes its correlation product or zero.  Pass 2a
// (prach_power_kernel): one thread per (root, delay bin) sums |x|^2 over
// ports and symbols.  Pass 2b (prach_detect_kernel): one block per
// preamble; the geometry (root index, window start) is a static host table
// uploaded once; fixed-order block sums and a first-index argmax keep the
// result the same from run to run; block 0 also writes the RSSI.  A slot
// batch runs its B captures through the same three launches: pass 1 treats
// the slot axis as more (port, symbol) rows, passes 2a and 2b take the slot
// as blockIdx.y.  Bounds on
// this card: bytes -- the IDFT buffer of 4 x 12 x 10 x 1024 complex64
// (3.9 MB at the flagship) is written once and read by cuFFT.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float abs2(float2 a) {
  const float m = hypotf(a.x, a.y);
  return m * m;
}

__device__ float block_sum(float v, float* sh) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] += sh[t + s];
    __syncthreads();
  }
  const float r = sh[0];
  __syncthreads();
  return r;
}

__global__ void prach_corr_kernel(const float2* __restrict__ rx,
                                  const float2* __restrict__ roots, int PS,
                                  int R, int L, int N,
                                  float2* __restrict__ buf) {
  const long long gid = (long long)blockIdx.x * NT + threadIdx.x;
  if (gid >= (long long)PS * R * N) return;
  const int n = (int)(gid % N);
  const long long q = gid / N;
  const int r = (int)(q % R);
  const long long ps = q / R;
  const int half = (L + 1) / 2;
  int bin = -1;
  if (n < half) bin = n;
  else if (n >= N - (L - half)) bin = n - (N - L);
  float2 v = make_float2(0.f, 0.f);
  if (bin >= 0) {
    const float2 c = roots[(size_t)r * L + bin];
    v = cmul(rx[ps * L + bin], make_float2(c.x, -c.y));
  }
  buf[gid] = v;
}

__global__ void prach_power_kernel(const float2* __restrict__ d, int PS, int R,
                                   int N, float scale,
                                   float* __restrict__ power) {
  const long long gid = (long long)blockIdx.x * NT + threadIdx.x;
  if (gid >= (long long)R * N) return;
  const size_t b = blockIdx.y;                         // slot
  d += b * PS * R * N;
  power += b * R * N;
  float acc = 0.f;
  for (int ps = 0; ps < PS; ++ps) {
    const float2 x = d[(size_t)ps * R * N + gid];
    acc += abs2(make_float2(x.x * scale, x.y * scale));
  }
  power[gid] = acc;
}

__global__ void prach_detect_kernel(const float* __restrict__ power, int R,
                                    int N,
                                    const int* __restrict__ geom, int win,
                                    int margin, int search, float threshold,
                                    float span, const float2* __restrict__ rx,
                                    int nrx, float* __restrict__ metrics,
                                    float* __restrict__ ta,
                                    uint8_t* __restrict__ detected,
                                    float* __restrict__ rssi) {
  __shared__ float sh[NT];
  __shared__ float sv[NT];
  __shared__ int si[NT];
  const int pre = blockIdx.x, t = threadIdx.x;
  const size_t b = blockIdx.y;                         // slot
  const int npre = gridDim.x;
  power += b * R * N;
  rx += b * nrx;
  metrics += b * npre;
  ta += b * npre;
  detected += b * npre;
  rssi += b;
  const float* pw = power + (size_t)geom[2 * pre] * N;
  const int start = geom[2 * pre + 1];
  // the region [start - margin, start + win + margin) of the circular power
  float ref = 0.f;
  for (int j = t; j < win + 2 * margin; j += NT)
    ref += pw[((start - margin + j) % N + N) % N];
  ref = block_sum(ref, sh);
  float best = -1.f;
  int bi = 0x7fffffff;
  for (int j = t; j < search; j += NT) {
    const float seg = pw[(start + j) % N];
    const float m = seg / fmaxf(ref - seg, 1e-12f);
    if (m > best) {
      best = m;
      bi = j;
    }
  }
  sv[t] = best;
  si[t] = bi;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (t < s) {
      const float ov = sv[t + s];
      const int oi = si[t + s];
      if (ov > sv[t] || (ov == sv[t] && oi < si[t])) {
        sv[t] = ov;
        si[t] = oi;
      }
    }
    __syncthreads();
  }
  if (t == 0) {
    const float m = sv[0] * (float)win;
    metrics[pre] = m;
    ta[pre] = (float)si[0] / span;
    detected[pre] = m > threshold;
  }
  if (pre == 0) {
    float e = 0.f;
    for (int i = t; i < nrx; i += NT) e += abs2(rx[i]);
    e = block_sum(e, sh);
    if (t == 0) rssi[0] = e / (float)nrx;
  }
}

inline int blocks_for(long long n) { return (int)((n + NT - 1) / NT); }

}  // namespace

// Pass 1: rx [P*S, L], roots [R, L] -> buf [P*S, R, N] (a slot batch
// passes its slots * P * S rows as PS).
extern "C" int srsran_prach_corr(void* rx, void* roots, int PS, int R, int L,
                                 int N, void* buf, void* stream) {
  prach_corr_kernel<<<blocks_for((long long)PS * R * N), NT, 0,
                      (cudaStream_t)stream>>>((const float2*)rx,
                                              (const float2*)roots, PS, R, L,
                                              N, (float2*)buf);
  return (int)cudaGetLastError();
}

// Pass 2 on the IDFT output d [slots, P*S, R, N] of `slots` slots: power
// [slots, R, N] (scratch), then per preamble (geom int [npre, 2] = root
// index, window start) metrics, ta and detected [slots, npre], and the RSSI
// [slots] of rx [slots, nrx].
extern "C" int srsran_prach_detect(void* d, int PS, int R, int N, float scale,
                                   void* power, void* geom, int npre, int win,
                                   int margin, int search, float threshold,
                                   float span, void* rx, int nrx,
                                   void* metrics, void* ta, void* detected,
                                   void* rssi, int slots, void* stream) {
  if (slots < 1 || npre < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 power_grid(blocks_for((long long)R * N), slots);
  prach_power_kernel<<<power_grid, NT, 0, st>>>((const float2*)d, PS, R, N,
                                                scale, (float*)power);
  prach_detect_kernel<<<dim3(npre, slots), NT, 0, st>>>(
      (const float*)power, R, N, (const int*)geom, win, margin, search,
      threshold,
      span, (const float2*)rx, nrx, (float*)metrics, (float*)ta,
      (uint8_t*)detected, (float*)rssi);
  return (int)cudaGetLastError();
}
