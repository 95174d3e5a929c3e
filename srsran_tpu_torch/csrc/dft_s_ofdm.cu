// K18 and K19: the DFT-s-OFDM receivers, for Hopper.
//
// K18 replaces the transform-precoded back end of srsran_tpu/phy/upper/
// pusch.py::codeword_llrs (:277-298): the 1 x N ZF / MMSE equalizer of
// srsran_tpu/ops/equalizer.py:17-52 over each data RE, per data symbol the
// unitary M-point IDFT of srsran_tpu/ops/transform_precode.py::deprecode
// (:30) and the mean post-equalizer noise of the block, the max-log demap
// (srsran_tpu/ops/modulation.py:112, pi/2-BPSK to 256QAM) and the
// descramble.  Twin: srsran_tpu_torch/ops/ul_demap.py::
// tp_equalize_demap_descramble_ref.
//
// K19 replaces srsran_tpu/phy/upper/pucch.py::process_format3 (:656-676)
// after its channel estimate: per data symbol corr / (energy + noise) over
// the rx ports, nv = noise / mean(energy), the IDFT, the F4 OCC despread,
// QPSK or pi/2-BPSK demap and the descramble.  Twin: srsran_tpu_torch/phy/
// upper/pucch.py::f3_demap_ref.
//
// Design.  One CTA per (slot, data symbol): blockIdx.x the data symbol,
// blockIdx.y the slot, one thread per point up to 512.  At its start the
// CTA issues cp.async copies of the twiddles, its block's Gold bits and the
// noise values into shared memory, which land while it combines its M REs
// over the ports (pass 1: each thread's REs two at a time, the loads of
// four ports in flight together) -- gathered from the grid through an
// int32 plan (K18: symbol, subcarrier and coefficient column per RE, so
// both hops of a hopping PUSCH go through one launch with the hops'
// estimates side by side).  Pass 2 equalizes each RE once, with one
// rounding per operation as the twin, into shared memory, and the CTA sums
// the symbol's noise term in a fixed order.  The IDFT is a mixed-radix
// Stockham FFT over two ping-pong buffers of M points in shared memory
// (dft_s_ofdm.cuh::idft): radix 4, 2, 3 and 5 stages in the order of the
// host's plan, which comes by value in the parameter struct with the rest
// of the call signature's scalars and the level table (kernels/_build.py::
// Launch), so a launch reads no host-made table but the twiddles exp(2j pi
// m / M) (float64, rounded once, read at exact indices) and the Gold bits,
// and a captured CUDA graph holds its plan; 1 / sqrt(M) is applied once,
// in the last stage.  Every bin then lies in shared memory: K19's F4
// despread reads its occ_length bins from there.  The demap and descramble
// read the bins and the Gold bits from shared memory; past 2 LLRs per
// symbol they stage the LLRs in the free buffer, so the LLRs leave in
// coalesced writes (dft_s_ofdm.cuh::demap_block).  Sums run in float32: an
// FFT's rounding grows with log M, where the direct sum it replaced (M
// terms per bin) kept a float64 sum to stop its rounding growing with M.
//
// A slot axis (the slot-batch mode): the slot's grid, coefficients, noise,
// LLRs and symbols lie at fixed strides; the plan (K18: with block_hop),
// the twiddles, the level table and the Gold bits are shared (the scrambling
// c_init does not depend on the slot).  A slot is only an offset: each
// slot's arithmetic and sum order are its unbatched launch's.
//
// Cost on this card: per data symbol ~5 M log2 M operations for the IDFT,
// 8 per complex MAC over the ports for the equalizer and a few per LLR for
// the demap; bytes: each RE's P samples and coefficients, the plan and the
// LLRs.  The function is bound by its bytes at every M (0.76 µs at M =
// 3240, 12 symbols).  One CTA per symbol puts 12-14 CTAs on the 132 SMs for
// one slot, so at large M the time is one SM's: its instruction rate over
// the symbol's equalizer, FFT stages (up to 7, each a CTA barrier) and
// demap -- 1024 threads were no faster than 512 at M = 3240 -- and at small
// M the chain of a launch, the loads' latency and the barriers.  Splitting
// a large symbol over a cluster of CTAs is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dft_s_ofdm.cuh"

namespace {

using namespace srsran_dfts;

constexpr int kMaxDataSymbols = 14;
constexpr int kMaxOcc = 4;

// Mirrors kernels/_build.py::TpDemapParams (K18's launch).
struct TpDemapParams {
  FftPlan fft;
  int nslots, nblocks, nre, P, S, K, T, Ka, H, mmse, kind, half, threads;
  float two_scale;
  float levels[kMaxLevels];
};

// Mirrors kernels/_build.py::F3DemapParams (K19's launch).
struct F3DemapParams {
  FftPlan fft;
  int nslots, P, S, K, sc0, n_data, occ_len, kind, threads;
  int gold_stride;                 // bytes per data symbol's Gold row
  float two_scale;
  int data_syms[kMaxDataSymbols];
  float occ_conj[2 * kMaxOcc];     // re, im
  float levels[kMaxLevels];
};

// Dynamic shared memory of a CTA: the ping-pong buffers and the twiddles
// (M points each), then the block's Gold bits (gold_bytes, a multiple of 4).
size_t smem_bytes(int M, int gold_bytes) {
  return 3 * (size_t)M * sizeof(float2) + (size_t)gold_bytes;
}

template <int HALF>
__global__ void __launch_bounds__(kMaxThreads) pusch_tp_demap_kernel(
    const float2* __restrict__ grid, const float2* __restrict__ coeffs,
    const int* __restrict__ plan, const float* __restrict__ noise,
    const int* __restrict__ block_hop, float* __restrict__ llr,
    float2* __restrict__ x_out, const __grid_constant__ TpDemapParams p,
    const float2* __restrict__ twiddle, const uint8_t* __restrict__ seq) {
  extern __shared__ float2 smem[];
  __shared__ float red[kMaxThreads / 32];
  __shared__ float levels[kMaxLevels];
  __shared__ float noise_s[kMaxNoise];
  __shared__ int hop_s;
  const int M = p.fft.M, P = p.P, nre = p.nre;
  const int qm = p.kind < 2 ? 1 : 2 * HALF;
  const int blk = blockIdx.x;
  const size_t b = blockIdx.y;                       // slot
  const size_t g0 = (size_t)blk * M;  // the block's place in the codeword
  float2* a = smem;
  float* energy_s = (float*)(smem + M);
  float2* tw = smem + 2 * M;
  uint8_t* gold = (uint8_t*)(smem + 3 * M);
  // the twiddles, the block's Gold bits (M Qm bytes, 4-aligned: M % 4 ==
  // 0), its hop and the slot's noise arrive while the CTA combines
  noise += b * p.H * P;
  prefetch(tw, twiddle, M, (uint32_t*)gold,
           (const uint32_t*)(seq + g0 * qm), M * qm / 4);
  for (int i = threadIdx.x; i < p.H * P; i += blockDim.x)
    cp_async4(noise_s + i, noise + i);
  if (threadIdx.x == 0) cp_async4(&hop_s, block_hop + blk);
  grid += b * P * p.S * p.K;
  coeffs += b * P * p.T * p.Ka;
  llr += b * nre * qm;
  x_out += b * nre;
  if (threadIdx.x < kMaxLevels) levels[threadIdx.x] = p.levels[threadIdx.x];
  const int* sym = plan;
  const int* sc = plan + nre;
  const int* col = plan + 2 * nre;
  // pass 1: each RE's sums over the ports (corr into a, energy beside it)
  constexpr int U = kReUnroll;
  for (int n0 = threadIdx.x; n0 < M; n0 += U * blockDim.x) {
    size_t yoff[U], hoff[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {    // past M: RE M - 1 again, not kept
      const int re = (int)g0 + min(n0 + u * (int)blockDim.x, M - 1);
      const int s = sym[re];
      yoff[u] = (size_t)s * p.K + sc[re];
      hoff[u] = (size_t)(p.T == 1 ? 0 : s) * p.Ka + col[re];
    }
    float energy[U];
    float2 corr[U];
    combine<U>(grid, coeffs, yoff, hoff, (size_t)p.S * p.K,
               (size_t)p.T * p.Ka, P, energy, corr);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int n = n0 + u * blockDim.x;
      if (n < M) {
        a[n] = corr[u];
        energy_s[n] = energy[u];
      }
    }
  }
  cp_async_wait();
  __syncthreads();
  float nv = 0.f;                    // the hop's estimator noise, mean over P
  for (int q = 0; q < P; ++q) nv = __fadd_rn(nv, noise_s[hop_s * P + q]);
  nv = __fdiv_rn(nv, (float)P);
  // pass 2, over the thread's own REs of pass 1: the 1 x N ZF / MMSE
  float part = 0.f;
  for (int n = threadIdx.x; n < M; n += blockDim.x) {
    const float energy = energy_s[n];
    const float2 corr = a[n];
    float2 xv;
    float onv;
    if (p.mmse) {
      const float d = fmaxf(__fadd_rn(energy, nv), 1e-12f);
      xv = make_float2(__fdiv_rn(corr.x, d), __fdiv_rn(corr.y, d));
      onv = __fdiv_rn(__fmul_rn(nv, energy), __fmul_rn(d, d));
    } else {
      const float inv = __fdiv_rn(1.f, fmaxf(energy, 1e-12f));
      xv = make_float2(__fmul_rn(corr.x, inv), __fmul_rn(corr.y, inv));
      onv = __fmul_rn(nv, inv);
    }
    if (energy < 1e-12f) onv = 1e12f;
    a[n] = xv;
    part = __fadd_rn(part, onv);
  }
  const float nv_blk = __fdiv_rn(cta_sum(part, red), (float)M);
  float2* x = idft(a, smem + M, tw, p.fft);
  demap_block<HALF>(x, M, nv_blk, p.kind, blk * M, p.two_scale, levels, gold,
                    llr + g0 * qm, x_out + g0,
                    (float*)(x == a ? smem + M : a), 2 * M / qm);
}

__global__ void __launch_bounds__(kMaxThreads) pucch_f3_demap_kernel(
    const float2* __restrict__ grid, const float2* __restrict__ coeffs,
    const float* __restrict__ noise_var, float* __restrict__ llr,
    const __grid_constant__ F3DemapParams p,
    const float2* __restrict__ twiddle, const uint8_t* __restrict__ seq) {
  extern __shared__ float2 smem[];
  __shared__ float red[kMaxThreads / 32];
  __shared__ float levels[kMaxLevels];
  __shared__ float noise_s[kMaxNoise];
  const int M = p.fft.M, P = p.P;
  const int qm = p.kind == 1 ? 1 : 2;
  const int i_sym = blockIdx.x;
  const size_t b = blockIdx.y;                       // slot
  const int m_data = M / p.occ_len;
  float2* a = smem;
  float* energy_s = (float*)(smem + M);
  float2* tw = smem + 2 * M;
  uint8_t* gold = (uint8_t*)(smem + 3 * M);
  // the twiddles, the symbol's row of Gold bits (padded to 4 bytes) and
  // the slot's noise arrive while the CTA combines
  noise_var += b * P;
  prefetch(tw, twiddle, M, (uint32_t*)gold,
           (const uint32_t*)(seq + (size_t)i_sym * p.gold_stride),
           p.gold_stride / 4);
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    cp_async4(noise_s + i, noise_var + i);
  grid += b * P * p.S * p.K;
  coeffs += b * P * M;
  llr += b * p.n_data * m_data * qm;
  if (threadIdx.x < kMaxLevels) levels[threadIdx.x] = p.levels[threadIdx.x];
  const size_t row = (size_t)p.data_syms[i_sym] * p.K + p.sc0;
  constexpr int U = kReUnroll;
  for (int n0 = threadIdx.x; n0 < M; n0 += U * blockDim.x) {
    size_t yoff[U], hoff[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {    // past M: RE M - 1 again, not kept
      const int n = min(n0 + u * (int)blockDim.x, M - 1);
      yoff[u] = row + n;
      hoff[u] = n;
    }
    float energy[U];
    float2 corr[U];
    combine<U>(grid, coeffs, yoff, hoff, (size_t)p.S * p.K, (size_t)M, P,
               energy, corr);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int n = n0 + u * blockDim.x;
      if (n < M) {
        a[n] = corr[u];
        energy_s[n] = energy[u];
      }
    }
  }
  cp_async_wait();
  __syncthreads();
  float noise = 0.f;
  for (int q = 0; q < P; ++q) noise = __fadd_rn(noise, noise_s[q]);
  noise = __fdiv_rn(noise, (float)P);
  float part = 0.f;
  for (int n = threadIdx.x; n < M; n += blockDim.x) {
    const float energy = energy_s[n];
    const float2 corr = a[n];
    const float d = __fadd_rn(energy, noise);
    a[n] = make_float2(__fdiv_rn(corr.x, d), __fdiv_rn(corr.y, d));
    part = __fadd_rn(part, energy);
  }
  const float mean_e = __fdiv_rn(cta_sum(part, red), (float)M);
  const float nv = __fdiv_rn(noise, fmaxf(mean_e, 1e-12f));
  float2* x = idft(a, smem + M, tw, p.fft);
  // the F4 despread in place: symbol i reads bins j m_data + i, j <
  // occ_len, which no other thread reads, and writes bin i
  if (p.occ_len > 1) {
    for (int i = threadIdx.x; i < m_data; i += blockDim.x) {
      float2 xi = cmul(x[i], make_float2(p.occ_conj[0], p.occ_conj[1]));
#pragma unroll
      for (int j = 1; j < kMaxOcc; ++j)
        if (j < p.occ_len)
          xi = cadd(xi, cmul(x[j * m_data + i],
                             make_float2(p.occ_conj[2 * j],
                                         p.occ_conj[2 * j + 1])));
      const float inv = (float)p.occ_len;
      x[i] = make_float2(__fdiv_rn(xi.x, inv), __fdiv_rn(xi.y, inv));
    }
    __syncthreads();
  }
  // pi/2-BPSK turns by the index inside the symbol's block, as the JAX
  // receiver demaps each data symbol on its own
  demap_block<1>(x, m_data, nv, p.kind, 0, p.two_scale, levels, gold,
                 llr + (size_t)i_sym * m_data * qm, nullptr,
                 (float*)(x == a ? smem + M : a), 2 * M / qm);
}

// Dynamic shared memory beyond 48 KB (with the static part) needs the
// opt-in, set for each kernel (``granted`` is the caller's, one per kernel)
// at its first call and whenever a larger size comes; the slot programs'
// warm-up run makes the first call before any graph capture.
template <typename F>
cudaError_t opt_in(F kernel, size_t bytes, size_t& granted) {
  if (bytes <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) granted = bytes;
  return err;
}

bool threads_ok(int threads) {
  return threads >= 32 && threads <= kMaxThreads && threads % 32 == 0;
}

template <int HALF>
cudaError_t launch_tp(const TpDemapParams& p, cudaStream_t st,
                      const float2* grid, const float2* coeffs,
                      const int* plan, const float* noise,
                      const int* block_hop, float* llr, float2* x,
                      const float2* twiddle, const uint8_t* seq) {
  static size_t granted = 0;
  const int qm = p.kind < 2 ? 1 : 2 * HALF;
  const size_t bytes = smem_bytes(p.fft.M, p.fft.M * qm);
  const cudaError_t err = opt_in(pusch_tp_demap_kernel<HALF>, bytes, granted);
  if (err != cudaSuccess) return err;
  pusch_tp_demap_kernel<HALF><<<dim3(p.nblocks, p.nslots), p.threads, bytes,
                                st>>>(grid, coeffs, plan, noise, block_hop,
                                      llr, x, p, twiddle, seq);
  return cudaGetLastError();
}

}  // namespace

// grid complex64 [(B,) P, S, K]; coeffs [(B,) P, 1, T, Ka]; plan int32 [3,
// nre]; noise f32 [(B,) H, P]; block_hop int32 [nblocks]; llr f32 [(B,) nre
// Qm]; x complex64 [(B,) nre, 1]; params the call signature's
// TpDemapParams (M a multiple of 4); twiddle complex64 [M]; seq uint8 [nre
// Qm].
extern "C" int srsran_pusch_tp_demap(const void* grid, const void* coeffs,
                                     const void* plan, const void* noise,
                                     const void* block_hop, void* llr,
                                     void* x, void* stream,
                                     const void* params, const void* twiddle,
                                     const void* seq) {
  const TpDemapParams* p = (const TpDemapParams*)params;
  if (!plan_ok(p->fft) || p->fft.M % 4 || p->nblocks < 1 ||
      p->nre != p->nblocks * p->fft.M || p->P < 1 ||
      p->H * p->P > kMaxNoise ||
      p->kind < 0 || p->kind > 2 || p->H < 1 || p->nslots < 1 ||
      p->nslots > 65535 || !threads_ok(p->threads))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SRSRAN_TP_LAUNCH(H)                                                   \
  return (int)launch_tp<H>(*p, st, (const float2*)grid,                      \
                           (const float2*)coeffs, (const int*)plan,          \
                           (const float*)noise, (const int*)block_hop,       \
                           (float*)llr, (float2*)x, (const float2*)twiddle,  \
                           (const uint8_t*)seq)
  switch (p->half) {
    case 1: SRSRAN_TP_LAUNCH(1);
    case 2: SRSRAN_TP_LAUNCH(2);
    case 3: SRSRAN_TP_LAUNCH(3);
    case 4: SRSRAN_TP_LAUNCH(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SRSRAN_TP_LAUNCH
}

// grid complex64 [(B,) P, S, K]; coeffs [(B,) P, 1, 1, M]; noise_var f32
// [(B,) P]; llr f32 [(B,) n_data M / occ_len Qm]; params the call
// signature's F3DemapParams; twiddle complex64 [M]; seq uint8 [n_data,
// gold_stride]: each data symbol's M / occ_len Qm Gold bits, padded.
extern "C" int srsran_pucch_f3_demap(const void* grid, const void* coeffs,
                                     const void* noise_var, void* llr,
                                     void* stream, const void* params,
                                     const void* twiddle, const void* seq) {
  const F3DemapParams* p = (const F3DemapParams*)params;
  if (!plan_ok(p->fft) || p->occ_len < 1 || p->occ_len > kMaxOcc ||
      p->fft.M % p->occ_len || p->n_data < 1 ||
      p->n_data > kMaxDataSymbols || p->kind < 1 || p->kind > 2 ||
      p->gold_stride % 4 || p->P < 1 || p->P > kMaxNoise ||
      p->gold_stride < p->fft.M / p->occ_len * (p->kind == 1 ? 1 : 2) ||
      p->nslots < 1 || p->nslots > 65535 || !threads_ok(p->threads))
    return (int)cudaErrorInvalidValue;
  static size_t granted = 0;
  const size_t bytes = smem_bytes(p->fft.M, p->gold_stride);
  const cudaError_t err = opt_in(pucch_f3_demap_kernel, bytes, granted);
  if (err != cudaSuccess) return (int)err;
  pucch_f3_demap_kernel<<<dim3(p->n_data, p->nslots), p->threads, bytes,
                          (cudaStream_t)stream>>>(
      (const float2*)grid, (const float2*)coeffs, (const float*)noise_var,
      (float*)llr, *p, (const float2*)twiddle, (const uint8_t*)seq);
  return (int)cudaGetLastError();
}
