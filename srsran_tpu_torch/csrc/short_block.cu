// K14: short-block (TS38.212 §5.3.3) maximum-likelihood detection for Hopper.
//
// Replaces srsran_tpu/ops/short_block.py::detect (:80-94): the correlation of
// a codeword's LLRs [E] with all 2^K candidate codewords (K <= 11), the first
// argmax, its bits, and metric = corr / (||llr|| sqrt(E) + 1e-9).
// Twin: srsran_tpu_torch/ops/short_block.py::detect_ref (the JAX package's
// [B, E] x [E, 2^K] product against the host candidate bank).
//
// Design.  Every short-block code is affine over GF(2) and periodic in the
// codeword index with a period P <= 64 (32 for Reed-Muller): candidate c's
// bit at position j is parity(c & mask[j % P]) ^ ones[j % P].  So one block
// per codeword first folds the LLRs into P per-position sums (each a
// sequential sum in index order), then its threads span the candidates and
// build each codeword's signs from the P masks: 2^K * P additions, no
// [2^K, E] table in memory.  A block-wide argmax keeps the first maximum
// (ties to the lower candidate index, as argmax does).  Bounds on this card:
// operations, 2 * 2^K * E for the plain correlation (4 M at K = 11, E = 512);
// the fold cuts them by E / P, so the kernel is launch-bound.
//
// K34, the encoder beside it: replaces srsran_tpu/ops/short_block.py::encode
// (:32-66): RM(32, K) for K 3-11, the K = 1 and K = 2 patterns with their
// Qm placeholders, and the cyclic repetition to E.  Twin: ops/short_block.py
// ::encode_ref.  Bounds: bytes (K in, E out per codeword), nanoseconds at
// the UE side's shapes; the kernel is latency-bound.  One warp per codeword
// (ops/short_block.py::ENCODE_WARPS a CTA): the first K lanes load a message
// byte each and one __ballot_sync packs the word w (bit i = message bit i);
// lane r forms the period's bits r and r + 32 as parity(w & mask[r]) ^
// ones[r] from a [2, P] table in message order (ops/short_block.py::
// _kernel_tables), two more ballots put the whole period (P <= 64) in every
// lane's registers, and the warp writes the E bytes 8 a lane as 8-byte
// stores (csrc/warp_bits.cuh), byte j = period bit j % P.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_bits.cuh"

// K34's launch (by address; the kernel takes its fields by value).
struct ShortBlockEncodeParams {
  int B;       // codewords
  int K;       // message bits, 1..11
  int E;       // transmitted bits
  int P;       // the code's period, 1..64
  int warps;   // codewords (warps) a CTA
};

namespace {

constexpr int NT = 256;
constexpr int MAX_P = 64;

__global__ void short_block_kernel(const float* __restrict__ llr, int E, int K,
                                   int P, const int* __restrict__ tables,
                                   int8_t* __restrict__ bits,
                                   float* __restrict__ metric) {
  __shared__ float fold[MAX_P];
  __shared__ int mask[MAX_P];
  __shared__ int ones[MAX_P];
  __shared__ float red[NT];
  __shared__ int redi[NT];
  const int t = threadIdx.x;
  const float* x = llr + (size_t)blockIdx.x * E;
  if (t < P) {
    float acc = 0.f;
    for (int j = t; j < E; j += P) acc += x[j];
    fold[t] = acc;
    mask[t] = tables[t];
    ones[t] = tables[P + t];
  }
  // ||llr||^2 as a fixed-order tree sum
  float sq = 0.f;
  for (int j = t; j < E; j += NT) sq += x[j] * x[j];
  red[t] = sq;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (t < s) red[t] += red[t + s];
    __syncthreads();
  }
  const float norm2 = red[0];
  __syncthreads();

  float best = __int_as_float(0xff800000);  // -inf
  int bi = 0x7fffffff;
  const int nc = 1 << K;
  for (int c = t; c < nc; c += NT) {
    float corr = 0.f;
    for (int r = 0; r < P; ++r) {
      const int bit = (__popc(c & mask[r]) & 1) ^ ones[r];
      corr += bit ? -fold[r] : fold[r];
    }
    if (corr > best) {  // c rises within a thread: the first maximum stays
      best = corr;
      bi = c;
    }
  }
  red[t] = best;
  redi[t] = bi;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (t < s) {
      const float ov = red[t + s];
      const int oi = redi[t + s];
      if (ov > red[t] || (ov == red[t] && oi < redi[t])) {
        red[t] = ov;
        redi[t] = oi;
      }
    }
    __syncthreads();
  }
  if (t < K) bits[(size_t)blockIdx.x * K + t] = (redi[0] >> (K - 1 - t)) & 1;
  if (t == 0) {
    const float norm = sqrtf(norm2) * sqrtf((float)E) + 1e-9f;
    metric[blockIdx.x] = red[0] / norm;
  }
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;

__global__ void __launch_bounds__(32 * kMaxWarps)
short_block_encode_kernel(const int8_t* __restrict__ bits,
                          int8_t* __restrict__ out,
                          const ShortBlockEncodeParams p,
                          const int* __restrict__ table) {
  const int lane = threadIdx.x & 31;
  const int cw = blockIdx.x * p.warps + (threadIdx.x >> 5);
  if (cw >= p.B) return;                     // the whole warp
  const int8_t* m = bits + (size_t)cw * p.K;
  const uint32_t w = __ballot_sync(kFull, lane < p.K && (m[lane] & 1));
  const int r1 = lane + 32;
  const bool b0 = lane < p.P && ((__popc(w & __ldg(table + lane)) ^
                                  __ldg(table + p.P + lane)) & 1);
  const bool b1 = r1 < p.P && ((__popc(w & __ldg(table + r1)) ^
                                __ldg(table + p.P + r1)) & 1);
  const uint64_t period = (uint64_t)__ballot_sync(kFull, b0) |
                          (uint64_t)__ballot_sync(kFull, b1) << 32;
  int8_t* o = out + (size_t)cw * p.E;
  for (int c = lane; 8 * c < p.E; c += 32) {
    uint64_t v = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = 8 * c + q;
      v |= ((period >> (p.P == 32 ? (j & 31) : j % p.P)) & 1u) << (8 * q);
    }
    store_chunk(o, p.E, c, v);
  }
}

}  // namespace

// llr f32 [B, E]; tables int32 [2, P] (masks, ones); bits int8 [B, K];
// metric f32 [B].
extern "C" int srsran_short_block_detect(void* llr, int B, int E, int K, int P,
                                         void* tables, void* bits, void* metric,
                                         void* stream) {
  if (K < 1 || K > 11 || P < 1 || P > MAX_P || B < 1 || E < 1)
    return (int)cudaErrorInvalidValue;
  short_block_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(
      (const float*)llr, E, K, P, (const int*)tables, (int8_t*)bits,
      (float*)metric);
  return (int)cudaGetLastError();
}

// K34: bits int8 [B, K]; out int8 [B, E]; params by address; table int32
// [2, P] (masks in message order, ones).
extern "C" int srsran_short_block_encode(void* bits, void* out, void* stream,
                                         const void* params, void* table) {
  const ShortBlockEncodeParams* p = (const ShortBlockEncodeParams*)params;
  if (p->K < 1 || p->K > 11 || p->P < 1 || p->P > MAX_P || p->B < 1 ||
      p->E < 1 || p->warps < 1 || p->warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  short_block_encode_kernel<<<(p->B + p->warps - 1) / p->warps,
                              32 * p->warps, 0, (cudaStream_t)stream>>>(
      (const int8_t*)bits, (int8_t*)out, *p, (const int*)table);
  return (int)cudaGetLastError();
}
