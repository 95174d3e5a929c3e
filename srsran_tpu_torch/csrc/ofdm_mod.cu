// K7: OFDM modulation of a slot for Hopper, one launch a call.
//
// Replaces srsran_tpu/ops/ofdm.py::modulate_slot (:72-107): for every row
// (B P) and symbol, the K grid values placed with zeros between the halves
// (_grid_to_bins, :55), the unitary N-point IFFT, the phase compensation
// exp(-2j pi f_c t_l) times the scale, and the symbol written with its
// cyclic prefix, its last c_s samples first (_cp_insert_plan, :111).
// Twin: srsran_tpu_torch/ops/ofdm.py::modulate_slot_ref.
//
// What bounds it.  Bytes: the grid read once and the slot's samples written
// once, 3.4 MB at the flagship (P 4, S 14, N 4096, K 3276), about 1.0 us at
// the card's memory rate; the IFFTs are 14 MFLOP.  The former design wrote
// every bin (zeros included) to a [P, S, N] buffer, ran cuFFT on it and
// gathered the samples with their CP from it: four device activities.
//
// Design.  One CTA a (row, symbol), no cuFFT, no buffer in device memory
// (ofdm.cuh): in the radix-16 form (N a power of two from 128 to 4096)
// register m of thread t takes bin t + T m from the grid where it is used
// and starts at zero elsewhere (the N - K empty bins are never loaded), the
// stages run in registers with the shared buffer between them, and after
// the last register m holds sample t + T m: times comp[s] scale / sqrt(N)
// it goes to the symbol's body and, where it is one of the last c_s, to
// its CP too, from the same register (coalesced stores).  Other sizes of
// the form 2^a 3^b 5^c take the Stockham form (N / 4 threads, dynamic
// shared memory).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ofdm.cuh"

namespace {

using namespace srsran_ofdm;

template <int LOGN>
__global__ void __launch_bounds__(Form<LOGN>::T, 2)
    ofdm_mod_kernel(const float2* __restrict__ grid,
                    float2* __restrict__ samples,
                    const float2* __restrict__ tw, const OfdmParams p) {
  using F = Form<LOGN>;
  __shared__ float2 sh[F::N + F::N / 16];
  const int tid = threadIdx.x, s = blockIdx.x, row = blockIdx.y;
  float2 w1[15], w2[15];
  load_twiddles<LOGN, 1>(w1, tw, p.tw_off[0], tid);
  if constexpr (F::STAGES == 3) load_twiddles<LOGN, 2>(w2, tw, p.tw_off[1], tid);
  const float2* g = grid + ((size_t)row * p.S + s) * p.K;
  const int up = p.K - p.half;       // bins [0, up) <- grid [half, K)
  const int lo = F::N - p.half;      // bins [lo, N) <- grid [0, half)
  float2 v[16];
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int b = tid + F::T * m;
    v[m] = b < up ? g[p.half + b] : b >= lo ? g[b - lo] : make_float2(0.f, 0.f);
  }
  fft_head<LOGN, true>(v, w1, sh, tid);
  fft_last<LOGN, true>(v, w1, w2, sh, tid);
  const float2 c = make_float2(p.comp[2 * s], p.comp[2 * s + 1]);
  const int cp = p.cp[s];
  float2* y = samples + (size_t)row * p.T + p.start[s];
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int n = tid + F::T * m;
    const float2 val = cmul(v[m], c);
    y[cp + n] = val;
    if (n >= F::N - cp) y[n - (F::N - cp)] = val;
  }
}

// The Stockham form.
__global__ void __launch_bounds__(kOfdmMixedMaxThreads)
    ofdm_mod_mixed_kernel(const float2* __restrict__ grid,
                          float2* __restrict__ samples,
                          const float2* __restrict__ tw, const OfdmParams p) {
  extern __shared__ float2 smem[];
  const int N = p.N, s = blockIdx.x, row = blockIdx.y;
  float2 *a = smem, *b = smem + N, *w = smem + 2 * N;
  const float2* g = grid + ((size_t)row * p.S + s) * p.K;
  const int up = p.K - p.half, lo = N - p.half;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    a[i] = i < up ? g[p.half + i] : i >= lo ? g[i - lo] : make_float2(0.f, 0.f);
    w[i] = tw[i];
  }
  __syncthreads();
  const float2* x = srsran_dfts::idft(a, b, w, p.fft);
  const float2 c = make_float2(p.comp[2 * s], p.comp[2 * s + 1]);
  const int cp = p.cp[s];
  float2* y = samples + (size_t)row * p.T + p.start[s];
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float2 val = cmul(x[n], c);
    y[cp + n] = val;
    if (n >= N - cp) y[n - (N - cp)] = val;
  }
}

template <int LOGN>
cudaError_t launch(const OfdmParams& p, cudaStream_t st, const void* grid,
                   void* samples, const void* tw) {
  ofdm_mod_kernel<LOGN><<<dim3(p.S, p.rows), Form<LOGN>::T, 0, st>>>(
      (const float2*)grid, (float2*)samples, (const float2*)tw, p);
  return cudaGetLastError();
}

}  // namespace

// Let the Stockham form take `bytes` of dynamic shared memory (once per
// device, before any capture).
extern "C" int srsran_ofdm_mod_prepare(int bytes) {
  return (int)cudaFuncSetAttribute(ofdm_mod_mixed_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
}

// grid complex64 [rows, S, K]; samples complex64 [rows, T]; params an
// OfdmParams; table complex64: exp(2j pi m / N) [N], then the radix-16
// form's stage twiddles at tw_off.
extern "C" int srsran_ofdm_modulate(const void* grid, void* samples,
                                    void* stream, const void* params,
                                    const void* table) {
  const OfdmParams* p = (const OfdmParams*)params;
  if (!params_ok(*p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (p->form) {
    case 7: return (int)launch<7>(*p, st, grid, samples, table);
    case 8: return (int)launch<8>(*p, st, grid, samples, table);
    case 9: return (int)launch<9>(*p, st, grid, samples, table);
    case 10: return (int)launch<10>(*p, st, grid, samples, table);
    case 11: return (int)launch<11>(*p, st, grid, samples, table);
    case 12: return (int)launch<12>(*p, st, grid, samples, table);
    default:
      ofdm_mod_mixed_kernel<<<dim3(p->S, p->rows), mixed_threads(p->N),
                              p->smem, st>>>(
          (const float2*)grid, (float2*)samples, (const float2*)table, *p);
      return (int)cudaGetLastError();
  }
}
