// K14: short-block (TS38.212 §5.3.3) maximum-likelihood detection for Hopper.
//
// Replaces srsran_tpu/ops/short_block.py::detect (:80-94): the correlation of
// a codeword's LLRs [E] with all 2^K candidate codewords (K <= 11), the first
// argmax, its bits, and metric = corr / (||llr|| sqrt(E) + 1e-9).
// Twin: srsran_tpu_torch/ops/short_block.py::detect_ref (the JAX package's
// [B, E] x [E, 2^K] product against the host candidate bank).
//
// Bounds on this card: bytes (the E LLRs in; the fold, the norm and the
// correlations of the folded sums as a Walsh-Hadamard transform take 3 E +
// (K + 1) 2^K operations, 26 k at K = 11, E = 512), nanoseconds; at the
// flagship's K = 6, E = 32 a launch and one warp's latency chain.  So the
// design cuts the chain.
//
// Design.  Every short-block code is affine over GF(2) and periodic in the
// codeword index: candidate c's bit at position j is parity(c & mask[j %
// Q]) ^ ones[j % Q] for a fold period Q <= 32 that is a multiple of the
// code's period (ops/short_block.py::_fold_period: 32 for Reed-Muller, 30,
// 24 or 32 for K <= 2).  A warp a codeword, ShortBlockDetectParams::warps
// codewords a CTA, no __syncthreads.  Lane r loads its word of a 128-byte
// table (ops/short_block.py::_detect_table) beside its LLRs, folds the
// LLRs at position r of the period (coalesced, in index order) and their
// squares, signs the sum by position r's placeholder bit, and takes by
// one shuffle the sum of its source position: for K >= 3 the position
// whose Reed-Muller rows 1..5 spell the lane index (they are a permutation
// of the 32 positions), so the part of every correlation that the
// candidate bits of rows 1..5 decide is a Walsh-Hadamard transform over
// the lanes; for K <= 2 its own.  A loop over the other candidate bits
// (row 0 and rows 6..K-1; all K bits for K <= 2), nk = 2^(K - 5) times for
// K >= 6 (2 at the flagship's K = 6), signs the lanes' sums by the loop
// index's mask bits and runs one 5-step __shfl_xor_sync butterfly: lane u
// then holds the correlation of candidate (loop index's bits, u's bits),
// which it keeps if it is the lane's first maximum.  That is 5 nk
// additions a lane where the plain sum takes Q 2^K / 32, and the code is a
// short loop: a lone warp's time goes to fetching its instructions and
// waiting on its loads, so every step is kept short.  A (value, index)
// butterfly keeps the first maximum (ties to the lower candidate index, as
// argmax does); lanes < K store the bits, lane 0 the metric, corr / (||llr||
// sqrt(E) + 1e-9) with the norm's 5-step butterfly and the quotient by
// __fdividef (within 2 ulp).  Sums run in butterfly order, not the twin's
// product order: a few ulp.

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

constexpr int kSbMaxPeriod = 32;     // K14: a code period the fold takes

// K14's launch, by value (srsran_tpu_torch/kernels/_build.py
// ShortBlockDetectParams): B codewords of E LLRs; the fold period Q <= 32;
// the codewords (warps) a CTA; the loop's nk indices and the split (ks, kt)
// that places loop index j in the candidate index, ((j >> ks) << kt) | (j
// & (2^ks - 1)); sqrt(E) in float32.
struct ShortBlockDetectParams {
  int B, K, E, Q, warps, nk, ks, kt;
  float sqrt_e;
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr int MAX_P = 64;             // K34's code period

// Loop index j: its candidates' correlations over the lanes, by one
// Walsh-Hadamard butterfly of the lanes' sums g signed by j's mask bits;
// lane u then holds candidate ((j >> ks) << kt) | (j & (2^ks - 1)) | its
// part, kept if it is the lane's first maximum (j rises within a lane).
__device__ __forceinline__ void correlate(int j, float g, int kmask,
                                          int part, bool cand, int lane,
                                          const ShortBlockDetectParams& p,
                                          float& best, int& bi) {
  float v = __int_as_float(__float_as_int(g) ^
                           ((__popc(j & kmask) & 1) << 31));
#pragma unroll
  for (int m = 1; m <= 16; m <<= 1) {
    const float y = __shfl_xor_sync(kFull, v, m);
    v = (lane & m) ? y - v : v + y;
  }
  if (cand && v > best) {
    best = v;
    bi = ((j >> p.ks) << p.kt) | (j & ((1 << p.ks) - 1)) | part;
  }
}

__global__ void __launch_bounds__(32 * kMaxWarps)
short_block_kernel(const float* __restrict__ llr, int8_t* __restrict__ bits,
                   float* __restrict__ metric,
                   const ShortBlockDetectParams p,
                   const uint32_t* __restrict__ table) {
  const int lane = threadIdx.x & 31;
  const int cw = blockIdx.x * p.warps + (threadIdx.x >> 5);
  if (cw >= p.B) return;                     // the whole warp
  const float* x = llr + cw * p.E;

  // Every global load first: the lane's word and its LLRs.  Lane r folds
  // the LLRs at position r of the period (index order) and their squares.
  const uint32_t w = __ldg(table + lane);
  float f = 0.f, sq = 0.f;
  if (lane < p.Q) {
#pragma unroll 4
    for (int j = lane; j < p.E; j += p.Q) {
      const float v = __ldg(x + j);
      f += v;
      sq = fmaf(v, v, sq);
    }
  }
  // The placeholder bit of position r, then each lane takes its source
  // position's signed sum.
  f = __int_as_float(__float_as_int(f) ^ ((w & 64u) << 25));
  float g = __shfl_sync(kFull, f, w & 31);
  if (!(w & 32u)) g = 0.f;
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) sq += __shfl_xor_sync(kFull, sq, m);

  // The loop over the other candidate bits: two indices (K 3..6) in one
  // unrolled pair, more (K = 1, 2 and K >= 7) four at a time in flight.
  const int kmask = (w >> 8) & 0xff, part = w >> 16;
  const bool cand = w & 128u;
  float best = __int_as_float(0xff800000);   // -inf
  int bi = 0;
  if (p.nk <= 2) {
#pragma unroll 2
    for (int j = 0; j < p.nk; ++j)
      correlate(j, g, kmask, part, cand, lane, p, best, bi);
  } else {
#pragma unroll 4
    for (int j = 0; j < p.nk; ++j)
      correlate(j, g, kmask, part, cand, lane, p, best, bi);
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    const float ov = __shfl_xor_sync(kFull, best, m);
    const int oi = __shfl_xor_sync(kFull, bi, m);
    if (ov > best || (ov == best && oi < bi)) {
      best = ov;
      bi = oi;
    }
  }
  if (lane < p.K) bits[cw * p.K + lane] = (bi >> (p.K - 1 - lane)) & 1;
  if (lane == 0)
    metric[cw] = __fdividef(best, sqrtf(sq) * p.sqrt_e + 1e-9f);
}

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

// K14: llr f32 [B, E]; bits int8 [B, K]; metric f32 [B]; params by
// address; table uint32 [32], the lane words of ops/short_block.py::
// _detect_table.
extern "C" int srsran_short_block_detect(const void* llr, void* bits,
                                         void* metric, void* stream,
                                         const void* params,
                                         const void* table) {
  const ShortBlockDetectParams* p = (const ShortBlockDetectParams*)params;
  if (p->K < 1 || p->K > 11 || p->Q < 1 || p->Q > kSbMaxPeriod ||
      p->B < 1 || p->E < 1 || p->warps < 1 || p->warps > kMaxWarps ||
      p->nk < 1 || p->nk > (1 << p->K) || p->ks < 0 || p->kt < p->ks)
    return (int)cudaErrorInvalidValue;
  short_block_kernel<<<(p->B + p->warps - 1) / p->warps, 32 * p->warps, 0,
                       (cudaStream_t)stream>>>(
      (const float*)llr, (int8_t*)bits, (float*)metric, *p,
      (const uint32_t*)table);
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
