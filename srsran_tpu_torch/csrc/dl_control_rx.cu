// K28: UE-side DL control receive demap -- RE gather, max-log QPSK LLRs,
// Gold descramble -- for Hopper.
//
// Replaces the device part of srsran_tpu/phy/upper/pdcch.py::recover
// (:311-317) and of srsran_tpu/phy/upper/ssb.py::pbch_decode (:356-361):
// the gather of a codeword's data REs from the grid,
// srsran_tpu/ops/modulation.py::demodulate for QPSK (per axis, the
// distances to the two levels +-s, s = 1/sqrt(2): LLR = ((y + s)^2 -
// (y - s)^2) / max(noise_var, 1e-12)) and
// srsran_tpu/ops/scrambling.py::descramble_llrs (the LLR's sign flipped
// where the Gold bit is 1).  Twin:
// srsran_tpu_torch/ops/dl_control.py::control_llrs_ref.
//
// Design.  One thread per RE of every codeword of the launch (every DCI of
// a slot and its PBCH, in item order): it finds its codeword by a binary
// search over the codewords' first REs, reads the complex value at its
// flat offset in the grid (a host table, uploaded once per plan), and
// writes both LLRs of its QPSK symbol, each with its Gold bit's sign (the
// bits of every codeword host-built and packed 32 to a word, uploaded once
// per plan).  Each product, sum and the division are rounded on their own
// (__fmul_rn, __fadd_rn, __fdiv_rn), in the twin's order, so the LLRs are
// bit-exact to it.
//
// Bounds on this card: bytes -- each RE's grid value and offset read
// once, its two LLRs written once (a few thousand REs a slot): the launch,
// not the bytes, sets its time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float axis_llr(float y, float s, float nv) {
  const float d1 = __fadd_rn(y, s);               // y - (-s): bit 1's level
  const float d0 = __fsub_rn(y, s);               // y - s: bit 0's level
  return __fdiv_rn(__fsub_rn(__fmul_rn(d1, d1), __fmul_rn(d0, d0)), nv);
}

__device__ __forceinline__ float signed_by(float llr, const uint32_t* gold,
                                           long long g) {
  return ((gold[g >> 5] >> (g & 31)) & 1u) ? -llr : llr;
}

__global__ void control_llrs_kernel(const float2* __restrict__ grid,
                                    const int* __restrict__ re,
                                    const int* __restrict__ re_off, int nb,
                                    const float* __restrict__ nv,
                                    const uint32_t* __restrict__ gold,
                                    int nre, float s,
                                    float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nre) return;
  int lo = 0, hi = nb - 1;                  // last codeword with re_off <= r
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (re_off[mid] <= r) lo = mid; else hi = mid - 1;
  }
  const float v = fmaxf(nv[lo], 1e-12f);
  const float2 y = grid[re[r]];
  const long long g = 2LL * r;
  out[g] = signed_by(axis_llr(y.x, s, v), gold, g);
  out[g + 1] = signed_by(axis_llr(y.y, s, v), gold, g + 1);
}

}  // namespace

// grid complex64 (flat); re int32 [nre]; re_off int32 [nb + 1]; nv float
// [nb]; gold int32 words; out float [2 nre].
extern "C" int srsran_control_llrs(void* grid, void* re, void* re_off, int nb,
                                   void* nv, void* gold, int nre, float s,
                                   void* out, void* stream) {
  if (nb < 1 || nre < 0) return (int)cudaErrorInvalidValue;
  if (nre == 0) return 0;
  const int threads = 128;
  const int blocks = (nre + threads - 1) / threads;
  control_llrs_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float2*)grid, (const int*)re, (const int*)re_off, nb,
      (const float*)nv, (const uint32_t*)gold, nre, s, (float*)out);
  return (int)cudaGetLastError();
}
