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
// Bounds on this card: bytes.  At the gNB simulator's shape (4x4 TDLA, 12
// taps, 14 x 3276 REs) tx and noise in, rx and H out, the steering table
// in: 5,136,768 bytes, 1.534 us at 3.35 TB/s.  The 11 MFLOP of the
// products do not decide it.
//
// Design.  Two launches: the noise's level needs the power of every RE.
//
// Launch 1: a CTA takes one rx port r, a run of 32 lanes along k (V = 2
// subcarriers a lane, so every tx, rx, H and steering access is one 16-byte
// vector, neighbouring lanes on neighbouring addresses; V = 1 with 8-byte
// accesses when K is odd or an input is not 16-byte aligned) and a group
// of `warps` symbols, one a warp (TdlParams: runs x splits x R CTAs; the
// host picks the splits so that the grid holds at least two CTAs an SM:
// 416 CTAs of 7 warps at the gNB simulator's shape, where the former
// kernel ran 52).  At entry every thread issues all of its CTA's loads as
// cp.async copies into shared memory -- its symbol's T tx vectors, its
// share of the run's D steering vectors and of the T x D gains -- so the
// whole CTA's bytes are in flight at once and hold no registers.  After
// one barrier warp w forms the rows t = w, w + warps, ... of the run's H,
// each from the D staged steering vectors (the table read once per (d, k)
// a CTA, not once per TX port); the CTAs of symbol group 0 store them.
// After a second barrier each thread mixes its symbol from the T rows and
// stores rx; its |rx|^2 in double goes into the CTA's partial by a warp
// butterfly and a butterfly over the warps' sums, stored in the call's
// scratch (one a call, so calls on two streams or in a graph share
// nothing).
//
// Launch 2: a thread per V REs, a programmatic dependent launch of launch
// 1: its noise loads go out first, then it waits for launch 1's rx and
// partials, one warp sums the partials -- lane l takes partials l, l + 32,
// ... in order, then a butterfly, lane 0's value for every CTA, in double,
// so a replay gives the same bits -- and every thread adds sqrt(n0 / 2)
// noise to its rx.
//
// A one-launch form was measured on this card (NVIDIA H100 80GB HBM3,
// 700 W): a cooperative grid holding rx in registers across a grid-wide
// wait on the partials took as long as the two launches in a CUDA graph,
// and it needs scratch that is set before every call or kept between
// calls, which two streams would share.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxTx = 8;
constexpr int kMaxTaps = 16;
constexpr int kTdlMaxWarps = 16;
constexpr int kTdlMaxSmem = 49152;   // 48 KB: no opt-in attribute

// K20's launch, by address (srsran_tpu_torch/kernels/_build.py TdlParams):
// R rx ports, T tx ports, S symbols, K subcarriers, D taps; V subcarriers
// a lane; lanes = ceil(K / V); runs = ceil(lanes / 32) CTAs along k;
// splits symbol groups (gridDim.y) of `warps` symbols; use_rot 1 with a
// CFO; nblocks = runs splits R; smem launch 1's dynamic shared memory a
// CTA in bytes; scale = 1 / (R S K 10^(SINR/10) 2), so that sqrt(sum
// scale) = sqrt(n0 / 2).
struct TdlParams {
  int R, T, S, K, D, V, lanes, runs, splits, warps, use_rot, nblocks, smem;
  double scale;
};

namespace {

constexpr int kNoiseThreads = 256;

template <int V>
struct Vec {
  float2 c[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load(const float2* p) {
  Vec<V> v;
  if (V == 2) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v.c[0] = make_float2(q.x, q.y);
    v.c[V - 1] = make_float2(q.z, q.w);
  } else {
    v.c[0] = __ldg(p);
  }
  return v;
}

template <int V>
__device__ __forceinline__ void store(float2* p, const Vec<V>& v) {
  if (V == 2)
    *reinterpret_cast<float4*>(p) =
        make_float4(v.c[0].x, v.c[0].y, v.c[V - 1].x, v.c[V - 1].y);
  else
    *p = v.c[0];
}

template <int V>
__device__ __forceinline__ Vec<V> zero() {
  Vec<V> v;
#pragma unroll
  for (int i = 0; i < V; ++i) v.c[i] = make_float2(0.f, 0.f);
  return v;
}

// acc + a b, complex, by fused multiply-adds
__device__ __forceinline__ float2 cmac(float2 acc, float2 a, float2 b) {
  return make_float2(__fmaf_rn(-a.y, b.y, __fmaf_rn(a.x, b.x, acc.x)),
                     __fmaf_rn(a.y, b.x, __fmaf_rn(a.x, b.y, acc.y)));
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

constexpr int kPartialsInFlight = 16;       // a lane's loads per round trip

// sqrt(n0 / 2) from the call's partials, by one warp: lane l sums partials
// l, l + 32, ... in order (kPartialsInFlight loads in flight at a time;
// the zeros past the last add nothing), then a butterfly; lane 0's value.
__device__ __forceinline__ float noise_amp(const double* partial, int n,
                                           double scale, int lane) {
  double s = 0.0;
  for (int base = lane; base < n; base += 32 * kPartialsInFlight) {
    double v[kPartialsInFlight];
#pragma unroll
    for (int u = 0; u < kPartialsInFlight; ++u) {
      const int i = base + 32 * u;
      v[u] = i < n ? __ldcg(partial + i) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kPartialsInFlight; ++u) s += v[u];
  }
  s = warp_sum(s);
  return (float)sqrt(__shfl_sync(0xffffffffu, s, 0) * scale);
}

// cp.async of V complex values (16 bytes through L2, or 8 through L1)
template <int V>
__device__ __forceinline__ void stage(float2* dst, const float2* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (V == 2)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void stage8(float2* dst, const float2* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

// a plain load of V complex values (shared memory, or global memory written
// by this grid or an earlier one)
template <int V>
__device__ __forceinline__ Vec<V> ldv(const float2* p) {
  Vec<V> v;
  if (V == 2) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v.c[0] = make_float2(q.x, q.y);
    v.c[V - 1] = make_float2(q.z, q.w);
  } else {
    v.c[0] = *p;
  }
  return v;
}

// The dynamic shared memory of a launch-1 CTA, in complex values (the
// host's channel._tdl_smem): steering [D][32 V], gains [T D] padded to
// even, H [T][32 V], tx [warps][T][32 V].
template <int V>
__global__ void __launch_bounds__(32 * kTdlMaxWarps)
tdl_kernel(const float2* __restrict__ tx, const float2* __restrict__ g,
           float2* __restrict__ rx, float2* __restrict__ h,
           const float2* __restrict__ steer, const float2* __restrict__ rot,
           double* __restrict__ partial, const TdlParams p) {
  extern __shared__ float4 smem_raw[];
  __shared__ double wsum[kTdlMaxWarps];
  constexpr int L = 32 * V;                        // complex values a row
  float2* st = reinterpret_cast<float2*>(smem_raw);
  float2* gs = st + p.D * L;
  float2* hs = gs + ((p.T * p.D + 1) & ~1);
  float2* xs = hs + p.T * L;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r = blockIdx.z;
  const int j0 = blockIdx.x * 32;                  // the run's first lane
  const int j = j0 + lane;
  const bool live = j < p.lanes;
  const int k = j * V;
  const int s = blockIdx.y * p.warps + w;          // the warp's symbol
  const bool mine = live && s < p.S;
  const int sk = p.S * p.K;

  // Every load at entry, into shared memory: the symbol's T tx vectors
  // (the thread's own), the run's steering and the port's gains (shared
  // out over the CTA), then the rotation.
  float2* xw = xs + w * p.T * L;
  if (mine)
    for (int t = 0; t < p.T; ++t)
      stage<V>(xw + t * L + lane * V, tx + t * sk + s * p.K + k);
  for (int c = threadIdx.x; c < p.D * 32; c += blockDim.x) {
    const int jj = j0 + (c & 31);
    if (jj < p.lanes) stage<V>(st + c * V, steer + (c >> 5) * p.K + jj * V);
  }
  for (int c = threadIdx.x; c < p.T * p.D; c += blockDim.x)
    stage8(gs + c, g + r * p.T * p.D + c);
  // launch 2 may start once every CTA of this one has (programmatic
  // dependent launch; it waits for this grid's results)
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::);
  const float2 ro = p.use_rot && s < p.S ? __ldg(rot + s)
                                          : make_float2(1.f, 0.f);
  __syncthreads();

  // The run's H rows, t = w, w + warps, ...: each from the D steering
  // vectors, in tap order.
  if (live)
    for (int t = w; t < p.T; t += p.warps) {
      Vec<V> a = zero<V>();
      for (int d = 0; d < p.D; ++d) {
        const float2 gv = gs[t * p.D + d];
        const Vec<V> sv = ldv<V>(st + d * L + lane * V);
#pragma unroll
        for (int i = 0; i < V; ++i) a.c[i] = cmac(a.c[i], gv, sv.c[i]);
      }
      store<V>(hs + t * L + lane * V, a);
      if (blockIdx.y == 0) store<V>(h + (r * p.T + t) * p.K + k, a);
    }
  __syncthreads();

  // The symbol's rx from the T rows, in TX port order; its power in double.
  Vec<V> y = zero<V>();
  double acc = 0.0;
  if (mine) {
    for (int t = 0; t < p.T; ++t) {
      const Vec<V> ht = ldv<V>(hs + t * L + lane * V);
      const Vec<V> xt = ldv<V>(xw + t * L + lane * V);
#pragma unroll
      for (int i = 0; i < V; ++i) y.c[i] = cmac(y.c[i], ht.c[i], xt.c[i]);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (p.use_rot) y.c[i] = cmac(make_float2(0.f, 0.f), y.c[i], ro);
      acc += (double)y.c[i].x * y.c[i].x + (double)y.c[i].y * y.c[i].y;
    }
    store<V>(rx + r * sk + s * p.K + k, y);
  }
  // The CTA's partial: a butterfly in each warp, then over the warps' sums.
  acc = warp_sum(acc);
  if (lane == 0) wsum[w] = acc;
  __syncthreads();
  if (w == 0) {
    const double c = warp_sum(lane < p.warps ? wsum[lane] : 0.0);
    if (lane == 0)
      partial[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
              blockIdx.x] = c;
  }
}

// Launch 2: a thread per V REs of rx [R, S, K] (K even when V = 2),
// launched as a programmatic dependent of launch 1: its noise loads go out
// while launch 1 runs, then it waits for launch 1's rx and partials
// (griddepcontrol.wait).
template <int V>
__global__ void __launch_bounds__(kNoiseThreads)
tdl_noise_kernel(float2* __restrict__ rx, const float2* __restrict__ noise,
                 const double* __restrict__ partial, const TdlParams p) {
  __shared__ float amp_s;
  const int n = p.R * p.S * p.K / V;
  const int i = blockIdx.x * kNoiseThreads + threadIdx.x;
  Vec<V> v, z;
  if (i < n) z = load<V>(noise + i * V);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (i < n) v = ldv<V>(rx + i * V);
  if (threadIdx.x < 32) {
    const float a = noise_amp(partial, p.nblocks, p.scale, threadIdx.x);
    if (threadIdx.x == 0) amp_s = a;
  }
  __syncthreads();
  if (i >= n) return;
  const float amp = amp_s;
#pragma unroll
  for (int c = 0; c < V; ++c)
    v.c[c] = make_float2(__fadd_rn(v.c[c].x, __fmul_rn(amp, z.c[c].x)),
                         __fadd_rn(v.c[c].y, __fmul_rn(amp, z.c[c].y)));
  store<V>(rx + i * V, v);
}

// Launch 1's dynamic shared memory a CTA in bytes (see tdl_kernel).
int smem_bytes(const TdlParams* p) {
  const int L = 32 * p->V;
  return 8 * (p->D * L + ((p->T * p->D + 1) & ~1) + p->T * L +
              p->warps * p->T * L);
}

// The most elements of an array the kernels index with an int: tx [T, S,
// K], noise and rx [R, S, K], H [R, T, K], the steering table [D, K].
long long max_elements(const TdlParams* p) {
  const long long k = p->K;
  long long m = (long long)p->R * p->S * k;
  if ((long long)p->T * p->S * k > m) m = (long long)p->T * p->S * k;
  if ((long long)p->R * p->T * k > m) m = (long long)p->R * p->T * k;
  if ((long long)p->D * k > m) m = (long long)p->D * k;
  return m;
}

bool valid(const TdlParams* p) {
  return p->R >= 1 && p->T >= 1 && p->T <= kMaxTx && p->D >= 1 &&
         p->D <= kMaxTaps && p->S >= 1 && p->K >= 1 &&
         (p->V == 1 || (p->V == 2 && p->K % 2 == 0)) &&
         p->lanes == (p->K + p->V - 1) / p->V &&
         p->runs == (p->lanes + 31) / 32 && p->warps >= 1 &&
         p->warps <= kTdlMaxWarps && p->splits >= 1 &&
         p->splits * p->warps >= p->S &&
         p->nblocks == p->runs * p->splits * p->R &&
         p->smem == smem_bytes(p) && p->smem <= kTdlMaxSmem &&
         max_elements(p) < (1ll << 31);
}

template <int V>
cudaError_t launch(const void* tx, const void* gains, const void* noise,
                   void* rx, void* h, const void* steer, const void* rot,
                   double* partial, const TdlParams& p, cudaStream_t st) {
  tdl_kernel<V><<<dim3(p.runs, p.splits, p.R), 32 * p.warps, p.smem, st>>>(
      (const float2*)tx, (const float2*)gains, (float2*)rx, (float2*)h,
      (const float2*)steer, (const float2*)rot, partial, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = p.R * p.S * p.K / V;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + kNoiseThreads - 1) / kNoiseThreads);
  cfg.blockDim = dim3(kNoiseThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, tdl_noise_kernel<V>, (float2*)rx,
                            (const float2*)noise, (const double*)partial, p);
}

}  // namespace

// tx c64 [T, S, K], gains c64 [R, T, D], noise c64 [R, S, K] in; rx c64
// [R, S, K] and H c64 [R, T, K] out, the call's scratch of nblocks
// partials (double) (TdlParams; tx and noise 16-byte aligned when V = 2);
// the plan's steering table c64 [D, K] and rotation c64 [S].
extern "C" int srsran_tdl_channel(void* tx, void* gains, void* noise,
                                  void* rx, void* h, void* scratch,
                                  void* stream, const void* params,
                                  const void* steer, const void* rot) {
  const TdlParams* p = (const TdlParams*)params;
  if (p == nullptr || !valid(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  double* partial = (double*)scratch;
  const cudaError_t err =
      p->V == 2 ? launch<2>(tx, gains, noise, rx, h, steer, rot, partial, *p,
                            st)
                : launch<1>(tx, gains, noise, rx, h, steer, rot, partial, *p,
                            st);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}
