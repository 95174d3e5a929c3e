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
// Design.  One CTA per (data symbol, tile of 128 output bins): a single
// CTA per symbol would leave most of the 132 SMs idle at the 12 data
// symbols of a slot.  The CTA first equalizes its whole symbol -- M REs,
// gathered from the grid through an int32 plan (K18: symbol, subcarrier
// and coefficient column per RE, so both hops of a hopping PUSCH go
// through one launch with the hops' estimates side by side) -- into shared
// memory, with the twiddle table beside it, and reduces the symbol's
// noise term over the CTA.  Each thread then forms its bin as a direct sum
// over the M REs (the twiddle index advances by the bin and wraps, and the
// sum is kept in float64), despreads (F4: its occ_length bins), demaps and
// applies the Gold sign at the symbol's place in the codeword.
//
// A slot axis (the slot-batch mode): blockIdx.z picks the slot (y is the
// data symbol), whose grid, coefficients, noise, LLRs and symbols lie at
// fixed strides; the plan (K18: with block_hop), the twiddles, the data
// symbols and OCC (K19), the level table and the Gold bits are shared (the
// scrambling c_init does not depend on the slot).  A slot is only an
// offset: each slot's arithmetic and sum order are its unbatched launch's.
//
// Cost: the direct sum does M complex multiply-adds per output symbol, 8 M^2
// operations per data symbol: at the cell-edge UE's M = 72 about 0.5 MFLOP
// for 12 symbols (the launch dominates), at the cell's largest DFT-s-OFDM
// allocation (270 RB, M = 3240) about 1.0 GFLOP.  A mixed-radix (2, 3, 5)
// FFT needs about 5 M log2 M per symbol, 2.3 MFLOP for those 12 symbols,
// so the function itself is bound by its bytes at every M; the direct sum
// sits far above that bound at large M.  K19 is small (M <= 192).  A
// shared-memory mixed-radix form of the IDFT is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dft_s_ofdm.cuh"

namespace {

using namespace srsran_dfts;

template <int HALF>
__global__ void __launch_bounds__(TILE) pusch_tp_demap_kernel(
    const float2* __restrict__ grid, const float2* __restrict__ coeffs,
    const int* __restrict__ plan, int nre, int P, int S, int K, int T,
    int Ka, const float* __restrict__ noise, int H,
    const int* __restrict__ block_hop,
    int M, const float2* __restrict__ twiddle, int mmse, int kind,
    const float* __restrict__ levels, float two_scale,
    const uint8_t* __restrict__ seq, float* __restrict__ llr,
    float2* __restrict__ x_out) {
  extern __shared__ float2 smem[];
  float2* v = smem;                  // [M] equalized REs of the block
  float2* tw = smem + M;             // [M] twiddles
  __shared__ float red[TILE];
  const int blk = blockIdx.y;
  const size_t b = blockIdx.z;                       // slot
  grid += b * P * S * K;
  coeffs += b * P * T * Ka;
  noise += b * H * P;
  llr += b * nre * (kind < 2 ? 1 : 2 * HALF);      // Qm bits per symbol
  x_out += b * nre;
  const int* sym = plan;
  const int* sc = plan + nre;
  const int* col = plan + 2 * nre;
  const int hop = block_hop[blk];
  float nv = 0.f;                    // the hop's estimator noise, mean over P
  for (int p = 0; p < P; ++p) nv = __fadd_rn(nv, noise[hop * P + p]);
  nv = __fdiv_rn(nv, (float)P);
  float part = 0.f;
  for (int n = threadIdx.x; n < M; n += TILE) {
    const int re = blk * M + n;
    const int s = sym[re], k = sc[re], c = col[re];
    const int t = (T == 1) ? 0 : s;
    float energy = 0.f;
    float2 corr = make_float2(0.f, 0.f);
    for (int p = 0; p < P; ++p) {
      const float2 y = grid[((size_t)p * S + s) * K + k];
      const float2 h = coeffs[((size_t)p * T + t) * Ka + c];
      energy = __fadd_rn(energy, abs2(h));
      corr = cadd(corr, cjmul(h, y));
    }
    float2 xv;
    float onv;
    if (mmse) {
      const float d = fmaxf(__fadd_rn(energy, nv), 1e-12f);
      xv = make_float2(__fdiv_rn(corr.x, d), __fdiv_rn(corr.y, d));
      onv = __fdiv_rn(__fmul_rn(nv, energy), __fmul_rn(d, d));
    } else {
      const float inv = __fdiv_rn(1.f, fmaxf(energy, 1e-12f));
      xv = make_float2(__fmul_rn(corr.x, inv), __fmul_rn(corr.y, inv));
      onv = __fmul_rn(nv, inv);
    }
    if (energy < 1e-12f) onv = 1e12f;
    v[n] = xv;
    tw[n] = twiddle[n];
    part = __fadd_rn(part, onv);
  }
  const float nv_blk = __fdiv_rn(cta_sum(part, red), (float)M);
  const int k = blockIdx.x * TILE + threadIdx.x;
  if (k >= M) return;
  const float2 xk = idft_bin(v, tw, M, k);
  const int g = blk * M + k;          // the symbol's place in the codeword
  x_out[g] = xk;
  demap_symbol<HALF>(xk, nv_blk, kind, g & 1, two_scale, levels, seq, llr, g);
}

template <int HALF>
__global__ void __launch_bounds__(TILE) pucch_f3_demap_kernel(
    const float2* __restrict__ grid, int P, int S, int K,
    const float2* __restrict__ coeffs, const float* __restrict__ noise_var,
    int sc0, int M, const int* __restrict__ data_syms, int occ_len,
    const float2* __restrict__ occ_conj, const float2* __restrict__ twiddle,
    int kind, const float* __restrict__ levels, float two_scale,
    const uint8_t* __restrict__ seq, float* __restrict__ llr) {
  extern __shared__ float2 smem[];
  float2* v = smem;
  float2* tw = smem + M;
  __shared__ float red[TILE];
  const int i_sym = blockIdx.y;
  const size_t b = blockIdx.z;                       // slot
  const int m_data = M / occ_len;
  grid += b * P * S * K;
  coeffs += b * P * M;
  noise_var += b * P;
  llr += b * gridDim.y * m_data * (kind == 1 ? 1 : 2);
  const int l = data_syms[i_sym];
  float noise = 0.f;
  for (int p = 0; p < P; ++p) noise = __fadd_rn(noise, noise_var[p]);
  noise = __fdiv_rn(noise, (float)P);
  float part = 0.f;
  for (int n = threadIdx.x; n < M; n += TILE) {
    float energy = 0.f;
    float2 corr = make_float2(0.f, 0.f);
    for (int p = 0; p < P; ++p) {
      const float2 y = grid[((size_t)p * S + l) * K + sc0 + n];
      const float2 h = coeffs[(size_t)p * M + n];
      energy = __fadd_rn(energy, abs2(h));
      corr = cadd(corr, cjmul(h, y));
    }
    const float d = __fadd_rn(energy, noise);
    v[n] = make_float2(__fdiv_rn(corr.x, d), __fdiv_rn(corr.y, d));
    tw[n] = twiddle[n];
    part = __fadd_rn(part, energy);
  }
  const float mean_e = __fdiv_rn(cta_sum(part, red), (float)M);
  const float nv = __fdiv_rn(noise, fmaxf(mean_e, 1e-12f));
  const int i = blockIdx.x * TILE + threadIdx.x;
  if (i >= m_data) return;
  float2 x;
  if (occ_len == 1) {
    x = idft_bin(v, tw, M, i);
  } else {
    x = make_float2(0.f, 0.f);
    for (int j = 0; j < occ_len; ++j)
      x = cadd(x, cmul(idft_bin(v, tw, M, j * m_data + i), occ_conj[j]));
    const float inv = (float)occ_len;
    x = make_float2(__fdiv_rn(x.x, inv), __fdiv_rn(x.y, inv));
  }
  // pi/2-BPSK turns by the index inside the symbol's block, as the JAX
  // receiver demaps each data symbol on its own
  demap_symbol<HALF>(x, nv, kind, i & 1, two_scale, levels, seq, llr,
                     i_sym * m_data + i);
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

template <int HALF>
cudaError_t launch_tp(const dim3& blocks, size_t bytes, cudaStream_t st,
                      const float2* grid, const float2* coeffs,
                      const int* plan, int nre, int P, int S, int K, int T,
                      int Ka, const float* noise, int H, const int* block_hop,
                      int M,
                      const float2* twiddle, int mmse, int kind,
                      const float* levels, float two_scale,
                      const uint8_t* seq, float* llr, float2* x) {
  static size_t granted = 0;
  const cudaError_t err = opt_in(pusch_tp_demap_kernel<HALF>, bytes, granted);
  if (err != cudaSuccess) return err;
  pusch_tp_demap_kernel<HALF><<<blocks, TILE, bytes, st>>>(
      grid, coeffs, plan, nre, P, S, K, T, Ka, noise, H, block_hop, M,
      twiddle, mmse, kind, levels, two_scale, seq, llr, x);
  return cudaGetLastError();
}

}  // namespace

extern "C" int srsran_pusch_tp_demap(void* grid, void* coeffs, void* plan,
                                     int nre, int P, int S, int K, int T,
                                     int Ka, void* noise, int nhops,
                                     void* block_hop, int M, void* twiddle,
                                     int mmse, int kind, int half,
                                     void* levels, float two_scale, void* seq,
                                     void* llr, void* x, int nslots,
                                     void* stream) {
  if (M < 1 || nre % M || kind < 0 || kind > 2 || nhops < 1 || nslots < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 blocks((M + TILE - 1) / TILE, nre / M, nslots);
  const size_t bytes = 2 * (size_t)M * sizeof(float2);
  cudaStream_t st = (cudaStream_t)stream;
#define SRSRAN_TP_LAUNCH(H)                                                   \
  return (int)launch_tp<H>(                                                  \
      blocks, bytes, st, (const float2*)grid, (const float2*)coeffs,         \
      (const int*)plan, nre, P, S, K, T, Ka, (const float*)noise, nhops,     \
      (const int*)block_hop, M, (const float2*)twiddle, mmse, kind,          \
      (const float*)levels, two_scale, (const uint8_t*)seq, (float*)llr,     \
      (float2*)x)
  switch (half) {
    case 1: SRSRAN_TP_LAUNCH(1);
    case 2: SRSRAN_TP_LAUNCH(2);
    case 3: SRSRAN_TP_LAUNCH(3);
    case 4: SRSRAN_TP_LAUNCH(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SRSRAN_TP_LAUNCH
}

extern "C" int srsran_pucch_f3_demap(void* grid, int P, int S, int K,
                                     void* coeffs, void* noise_var, int sc0,
                                     int M, void* data_syms, int n_data,
                                     int occ_len, void* occ_conj,
                                     void* twiddle, int kind, void* levels,
                                     float two_scale, void* seq, void* llr,
                                     int nslots, void* stream) {
  if (M < 1 || occ_len < 1 || M % occ_len || n_data < 1 || kind < 1 ||
      kind > 2 || nslots < 1)
    return (int)cudaErrorInvalidValue;
  const int m_data = M / occ_len;
  const dim3 blocks((m_data + TILE - 1) / TILE, n_data, nslots);
  const size_t bytes = 2 * (size_t)M * sizeof(float2);
  static size_t granted = 0;
  const cudaError_t err = opt_in(pucch_f3_demap_kernel<1>, bytes, granted);
  if (err != cudaSuccess) return (int)err;
  pucch_f3_demap_kernel<1><<<blocks, TILE, bytes, (cudaStream_t)stream>>>(
      (const float2*)grid, P, S, K, (const float2*)coeffs,
      (const float*)noise_var, sc0, M, (const int*)data_syms, occ_len,
      (const float2*)occ_conj, (const float2*)twiddle, kind,
      (const float*)levels, two_scale, (const uint8_t*)seq, (float*)llr);
  return (int)cudaGetLastError();
}
