// K3: fused PUSCH equalize -> max-log demap -> descramble, for Hopper.
//
// Replaces srsran_tpu/ops/equalizer.py::equalize_zf_2xn (:55-80) and
// equalize_zf_1xn (:17-34), srsran_tpu/ops/modulation.py::demodulate
// (:112-130) and srsran_tpu/ops/scrambling.py::descramble_llrs (:21-24), fed
// by the data-RE gather of srsran_tpu/phy/upper/pusch.py::_frontend_hop
// (:209-219).  Twin: srsran_tpu_torch/ops/ul_demap.py::
// equalize_demap_descramble_ref.
//
// Design.  One thread per data RE.  The thread gathers y[p] from the grid and
// h[p][l] from the channel estimate through the host RE plan, accumulating
// the Gram entries and matched-filter outputs over the P ports in registers
// (no per-RE arrays).  It solves closed-form ZF (1 layer, or 2 layers with
// the det < 1e-12 clamp), then demaps each layer's symbol with
// pusch_demap.cuh's demap_symbol: for QPSK .. 256QAM exact max-log LLRs per
// real axis against the PAM level table (the same table as
// modulation._pam_levels times the QAM scale), for BPSK and pi/2-BPSK the
// projection on (1 + j) (pi/2-BPSK derotated by -j at odd codeword symbol
// indices), divided by the post-equalizer noise; then the Gold sign.  It
// writes the LLRs in codeword order (RE-major, layer-minor, then b0(I)
// b1(Q) b2(I) ...) and the equalized symbols x (for the EVM).
//
// pi/2-BPSK's parity counts codeword symbols, RE-major and layer-minor,
// across both hops of a hopping PUSCH (the JAX package demaps the hops'
// symbols concatenated, srsran_tpu/phy/upper/pusch.py:274, :286-290), so a
// launch takes the parity of its first symbol, rot0: the wrapper derives it
// from the Gold offset (hop 2 starts where hop 1's bits ended).
//
// A slot axis (the slot-batch mode): blockIdx.y picks the slot, whose grid,
// coefficients, noise variance, LLRs and symbols lie at fixed strides; the
// RE plan, the level table and the Gold bits are shared (the scrambling
// c_init does not depend on the slot).
//
// Bounds on this card: memory -- per RE it reads P complex samples and
// P*L complex coefficients and writes L*Qm f32 LLRs; at the flagship
// (35,508 REs, 4 ports, 2 layers, QAM64) about 3.5 MB in all per slot.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pusch_demap.cuh"

namespace {

using namespace srsran_demap;

template <int HALF>
__global__ void pusch_demap_kernel(
    const float2* __restrict__ grid, const float2* __restrict__ coeffs,
    const int* __restrict__ sym, const int* __restrict__ sc, int nre, int P,
    int S, int K, int L, int T, int Ka, int sc_off,
    const float* __restrict__ nv_ptr, const float* __restrict__ levels,
    int kind, int rot0, float two_scale, const uint8_t* __restrict__ seq,
    float* __restrict__ llr, float2* __restrict__ x) {
  const int re = blockIdx.x * blockDim.x + threadIdx.x;
  if (re >= nre) return;
  const int qm = kind < 2 ? 1 : 2 * HALF;
  const size_t b = blockIdx.y;                       // slot
  grid += b * P * S * K;
  coeffs += b * P * L * T * Ka;
  nv_ptr += b;
  llr += b * nre * L * qm;
  x += b * nre * L;
  const int s = sym[re];
  const int k = sc[re];
  const int ka = k - sc_off;
  const int t = (T == 1) ? 0 : s;
  const float nv = *nv_ptr;
  float2 xs[2];
  float nvs[2];
  if (L == 1) {
    float energy = 0.f;
    float2 corr = make_float2(0.f, 0.f);
    for (int p = 0; p < P; ++p) {
      const float2 y = grid[((size_t)p * S + s) * K + k];
      const float2 h = coeffs[((size_t)p * T + t) * Ka + ka];
      energy = __fadd_rn(energy, abs2(h));
      corr = cadd(corr, cjmul(h, y));
    }
    const float inv = __fdiv_rn(1.f, fmaxf(energy, 1e-12f));
    xs[0] = make_float2(__fmul_rn(corr.x, inv), __fmul_rn(corr.y, inv));
    nvs[0] = energy < 1e-12f ? 1e12f : __fmul_rn(nv, inv);
  } else {
    float a = 0.f, d = 0.f;
    float2 b = make_float2(0.f, 0.f), z0 = b, z1 = b;
    for (int p = 0; p < P; ++p) {
      const float2 y = grid[((size_t)p * S + s) * K + k];
      const float2 h0 = coeffs[(((size_t)p * 2 + 0) * T + t) * Ka + ka];
      const float2 h1 = coeffs[(((size_t)p * 2 + 1) * T + t) * Ka + ka];
      a = __fadd_rn(a, abs2(h0));
      d = __fadd_rn(d, abs2(h1));
      b = cadd(b, cjmul(h0, h1));
      z0 = cadd(z0, cjmul(h0, y));
      z1 = cadd(z1, cjmul(h1, y));
    }
    float det = __fsub_rn(__fmul_rn(a, d), abs2(b));
    if (det < 1e-12f) det = 1e-12f;
    const float2 bz1 = cmul(b, z1);
    const float2 cbz0 = cjmul(b, z0);
    xs[0] = make_float2(__fdiv_rn(__fsub_rn(__fmul_rn(d, z0.x), bz1.x), det),
                        __fdiv_rn(__fsub_rn(__fmul_rn(d, z0.y), bz1.y), det));
    xs[1] = make_float2(__fdiv_rn(__fsub_rn(__fmul_rn(a, z1.x), cbz0.x), det),
                        __fdiv_rn(__fsub_rn(__fmul_rn(a, z1.y), cbz0.y), det));
    nvs[0] = __fdiv_rn(__fmul_rn(nv, d), det);
    nvs[1] = __fdiv_rn(__fmul_rn(nv, a), det);
  }
  for (int l = 0; l < L; ++l) {
    const int si = re * L + l;
    x[si] = xs[l];
    demap_symbol<HALF>(xs[l], nvs[l], kind, (rot0 + si) & 1, two_scale,
                       levels, seq, llr, si);
  }
}

}  // namespace

extern "C" int srsran_pusch_demap(void* grid, void* coeffs, void* sym,
                                  void* sc, int nre, int P, int S, int K,
                                  int L, int T, int Ka, int sc_off,
                                  void* nv_ptr, void* levels, int half,
                                  int kind, int rot0, float two_scale,
                                  void* seq, void* llr, void* x,
                                  int nslots, void* stream) {
  if (L < 1 || L > 2 || nslots < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const dim3 blocks((nre + threads - 1) / threads, nslots);
  cudaStream_t st = (cudaStream_t)stream;
#define SRSRAN_DEMAP_LAUNCH(H)                                              \
  pusch_demap_kernel<H><<<blocks, threads, 0, st>>>(                       \
      (const float2*)grid, (const float2*)coeffs, (const int*)sym,         \
      (const int*)sc, nre, P, S, K, L, T, Ka, sc_off, (const float*)nv_ptr, \
      (const float*)levels, kind, rot0, two_scale, (const uint8_t*)seq,   \
      (float*)llr, (float2*)x)
  switch (half) {
    case 1: SRSRAN_DEMAP_LAUNCH(1); break;
    case 2: SRSRAN_DEMAP_LAUNCH(2); break;
    case 3: SRSRAN_DEMAP_LAUNCH(3); break;
    case 4: SRSRAN_DEMAP_LAUNCH(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SRSRAN_DEMAP_LAUNCH
  return (int)cudaGetLastError();
}
