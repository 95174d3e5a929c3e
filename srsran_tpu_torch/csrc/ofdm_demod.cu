// K4: OFDM demodulation of a slot for Hopper, one launch a call.
//
// Replaces srsran_tpu/ops/ofdm.py::demodulate_slot (:135-163): for every
// row (B P) and symbol, the FFT window at the symbol's data start less
// window_offset (_window_plan_rx, :126), the unitary N-point FFT, the
// per-bin ramp exp(2j pi off kbin / N) where the window is offset, the
// conjugate phase compensation times the scale, and the K used bins in
// half-spectrum order (_bins_to_grid, :65).  Twin:
// srsran_tpu_torch/ops/ofdm.py::demodulate_slot_ref.
//
// What bounds it.  Bytes: the slot's samples read once and the grid written
// once, 3.4 MB at the flagship (P 4, S 14, N 4096, K 3276), about 1.0 us at
// the card's memory rate; the FFTs are 14 MFLOP (0.2 us at its float32
// rate).  The former design gathered the windows into a [P, S, N] buffer,
// ran cuFFT on it and gathered the bins back: four device activities and
// three passes over ~2 MB.
//
// Design.  One CTA a (row, symbol), no cuFFT, no buffer in device memory
// (ofdm.cuh): in the radix-16 form (N a power of two from 128 to 4096) its
// N / 16 threads load the window straight from the row's samples, register
// m of thread t holding sample start + t + T m (coalesced 8-byte loads at
// any start), run the stages in registers with the shared buffer between
// them, and hold bin t + T m after the last; each keeps the bins that are
// used, times the ramp (the table's entry off b mod N, gathered in bin
// order by the host) and comp[s] scale / sqrt(N), and stores them at their
// grid index (consecutive bins, consecutive subcarriers).  Other sizes of
// the form 2^a 3^b 5^c take the Stockham form (N / 4 threads, dynamic
// shared memory).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ofdm.cuh"

namespace {

using namespace srsran_ofdm;

// The used bins of v (register m: bin tid + T m) times the ramp (with an
// offset) and the symbol's factor into the symbol's grid row g.
template <int N, int T>
__device__ __forceinline__ void store_bins(const float2 (&v)[16],
                                           const float2 (&ramp)[16], float2* g,
                                           const OfdmParams& p, float2 c,
                                           int tid) {
  const int up = p.K - p.half;       // bins [0, up) -> grid [half, K)
  const int lo = N - p.half;         // bins [lo, N) -> grid [0, half)
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int b = tid + T * m;
    if (b < up || b >= lo) {
      const float2 val = p.off ? cmul(v[m], ramp[m]) : v[m];
      g[b < up ? p.half + b : b - lo] = cmul(val, c);
    }
  }
}

template <int LOGN>
__global__ void __launch_bounds__(Form<LOGN>::T, 2)
    ofdm_demod_kernel(const float2* __restrict__ samples,
                      float2* __restrict__ grid,
                      const float2* __restrict__ tw, const OfdmParams p) {
  using F = Form<LOGN>;
  __shared__ float2 sh[F::N + F::N / 16];
  const int tid = threadIdx.x, s = blockIdx.x, row = blockIdx.y;
  float2 w1[15], w2[15];
  load_twiddles<LOGN, 1>(w1, tw, p.tw_off[0], tid);
  if constexpr (F::STAGES == 3) load_twiddles<LOGN, 2>(w2, tw, p.tw_off[1], tid);
  const float2* x = samples + (size_t)row * p.T + p.start[s];
  float2 v[16], ramp[16];
#pragma unroll
  for (int m = 0; m < 16; ++m) v[m] = x[tid + F::T * m];
  fft_head<LOGN, false>(v, w1, sh, tid);
  // the ramp's loads in flight during the last stage, all 16 before any
  // use (a load behind each bin's store would wait out its own latency)
  if (p.off) {
#pragma unroll
    for (int m = 0; m < 16; ++m)
      ramp[m] = __ldg(tw + p.ramp + tid + F::T * m);
  }
  fft_last<LOGN, false>(v, w1, w2, sh, tid);
  store_bins<F::N, F::T>(v, ramp, grid + ((size_t)row * p.S + s) * p.K, p,
                         make_float2(p.comp[2 * s], p.comp[2 * s + 1]), tid);
}

// The Stockham form: the forward FFT as conj(IDFT(conj x)).
__global__ void __launch_bounds__(kOfdmMixedMaxThreads)
    ofdm_demod_mixed_kernel(const float2* __restrict__ samples,
                            float2* __restrict__ grid,
                            const float2* __restrict__ tw,
                            const OfdmParams p) {
  extern __shared__ float2 smem[];
  const int N = p.N, s = blockIdx.x, row = blockIdx.y;
  float2 *a = smem, *b = smem + N, *w = smem + 2 * N;
  const float2* x = samples + (size_t)row * p.T + p.start[s];
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float2 u = x[i];
    a[i] = make_float2(u.x, -u.y);
    w[i] = tw[i];
  }
  __syncthreads();
  const float2* X = srsran_dfts::idft(a, b, w, p.fft);
  float2* g = grid + ((size_t)row * p.S + s) * p.K;
  const float2 c = make_float2(p.comp[2 * s], p.comp[2 * s + 1]);
  for (int k = threadIdx.x; k < p.K; k += blockDim.x) {
    const int bin = k < p.half ? N - p.half + k : k - p.half;
    float2 val = make_float2(X[bin].x, -X[bin].y);
    if (p.off) val = cmul(val, __ldg(tw + p.ramp + bin));
    g[k] = cmul(val, c);
  }
}

template <int LOGN>
cudaError_t launch(const OfdmParams& p, cudaStream_t st, const void* samples,
                   void* grid, const void* tw) {
  ofdm_demod_kernel<LOGN><<<dim3(p.S, p.rows), Form<LOGN>::T, 0, st>>>(
      (const float2*)samples, (float2*)grid, (const float2*)tw, p);
  return cudaGetLastError();
}

}  // namespace

// Let the Stockham form take `bytes` of dynamic shared memory (once per
// device, before any capture).
extern "C" int srsran_ofdm_demod_prepare(int bytes) {
  return (int)cudaFuncSetAttribute(ofdm_demod_mixed_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
}

// samples complex64 [rows, T]; grid complex64 [rows, S, K]; params an
// OfdmParams; table complex64: exp(2j pi m / N) [N], then the radix-16
// form's stage twiddles at tw_off, then (an offset) the ramp [N] at ramp.
extern "C" int srsran_ofdm_demodulate(const void* samples, void* grid,
                                      void* stream, const void* params,
                                      const void* table) {
  const OfdmParams* p = (const OfdmParams*)params;
  if (!params_ok(*p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (p->form) {
    case 7: return (int)launch<7>(*p, st, samples, grid, table);
    case 8: return (int)launch<8>(*p, st, samples, grid, table);
    case 9: return (int)launch<9>(*p, st, samples, grid, table);
    case 10: return (int)launch<10>(*p, st, samples, grid, table);
    case 11: return (int)launch<11>(*p, st, samples, grid, table);
    case 12: return (int)launch<12>(*p, st, samples, grid, table);
    default:
      ofdm_demod_mixed_kernel<<<dim3(p->S, p->rows), mixed_threads(p->N),
                                p->smem, st>>>(
          (const float2*)samples, (float2*)grid, (const float2*)table, *p);
      return (int)cudaGetLastError();
  }
}
