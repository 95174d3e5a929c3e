// K33: the polar encode chain (TS38.212 §5.3.1, §5.4.1) for Hopper.
//
// Replaces srsran_tpu/ops/polar.py::allocate (:37, with _set_pc_bits :55),
// encode (:26) and rate_match (:162) as the UE side composes them (uci.py:
// 27-37, pucch.py:465 and :561, ssb.py:188, pdcch.py:68): message bits in,
// transmitted bits out, in one launch.  Twin: srsran_tpu_torch/ops/polar.py::
// encode_chain_ref (allocate -> encode -> rate_match, plain).
//
// Design.  One CTA per codeword; the encoder input u [N] (N <= 1024) lives
// in shared memory as bytes.  A host table per code carries every position
// the chain needs, so the kernel has no serial shift register and no
// interleaver arithmetic:
//   info_pos[K], info_src[K]  u[info_pos[j]] = msg[info_src[j]] (the DL
//                             input interleaver i_IL folded into info_src);
//   pc_pos[npc], pc_start[npc + 1], pc_src[ns]
//                             each PC bit the XOR of the info positions the
//                             length-5 cyclic register would have fed it
//                             (ops/polar.py::_pc_sources, walked on the host);
//   plan[E]                   transmitted bit i = x[plan[i]]: the sub-block
//                             interleaver, repetition / puncture / shorten
//                             selection and (UL) the triangular interleaver
//                             i_BIL composed into one gather.
// The log2 N butterfly stages x[i0] ^= x[i0 + half] run in place, a
// __syncthreads() between stages.  Bounds on this card: bytes (K in, E out)
// and a few operations per bit; the kernel is launch-bound at every shape of
// the UE side (E <= 1728 for a DCI, 864 for the PBCH).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_N = 1024;

__global__ void polar_encode_kernel(const int8_t* __restrict__ msg, int K,
                                    int n, const int* __restrict__ table,
                                    int npc, int ns, int E,
                                    int8_t* __restrict__ out) {
  __shared__ uint8_t u[MAX_N];
  const int N = 1 << n;
  const int t = threadIdx.x;
  const int8_t* m = msg + (size_t)blockIdx.x * K;
  const int* info_pos = table;
  const int* info_src = info_pos + K;
  const int* pc_pos = info_src + K;
  const int* pc_start = pc_pos + npc;
  const int* pc_src = pc_start + npc + 1;
  const int* plan = pc_src + ns;
  for (int i = t; i < N; i += NT) u[i] = 0;
  __syncthreads();
  for (int j = t; j < K; j += NT) u[info_pos[j]] = (uint8_t)(m[info_src[j]] & 1);
  __syncthreads();
  for (int p = t; p < npc; p += NT) {
    uint8_t v = 0;
    for (int s = pc_start[p]; s < pc_start[p + 1]; ++s) v ^= u[pc_src[s]];
    u[pc_pos[p]] = v;
  }
  __syncthreads();
  for (int s = 0; s < n; ++s) {
    const int half = 1 << s;
    for (int q = t; q < N / 2; q += NT) {
      const int i0 = (q >> s) * (2 * half) + (q & (half - 1));
      u[i0] ^= u[i0 + half];
    }
    __syncthreads();
  }
  int8_t* o = out + (size_t)blockIdx.x * E;
  for (int i = t; i < E; i += NT) o[i] = (int8_t)u[plan[i]];
}

}  // namespace

// msg int8 [B, K]; table int32 [2K + 2 npc + 1 + ns + E] as above; out int8
// [B, E].
extern "C" int srsran_polar_encode(void* msg, int B, int K, int n, void* table,
                                   int npc, int ns, int E, void* out,
                                   void* stream) {
  if (B < 1 || K < 1 || n < 1 || (1 << n) > MAX_N || K > (1 << n) || E < 1 ||
      npc < 0 || ns < 0)
    return (int)cudaErrorInvalidValue;
  polar_encode_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(
      (const int8_t*)msg, K, n, (const int*)table, npc, ns, E, (int8_t*)out);
  return (int)cudaGetLastError();
}
