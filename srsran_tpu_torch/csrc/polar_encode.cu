// K33: the polar encode chain (TS38.212 §5.3.1, §5.4.1) for Hopper.
//
// Replaces srsran_tpu/ops/polar.py::allocate (:37, with _set_pc_bits :55),
// encode (:26) and rate_match (:162) as the UE side composes them (uci.py:
// 27-37, pucch.py:465 and :561, ssb.py:188, pdcch.py:68): message bits in,
// transmitted bits out, in one launch.  Twin: srsran_tpu_torch/ops/polar.py::
// encode_chain_ref (allocate -> encode -> rate_match, plain).
//
// Bounds on this card: bytes (K in, E out per codeword) and a few
// operations per bit, some nanoseconds at every shape of the UE side; the
// kernel is latency-bound (one codeword a call, mostly), so its design
// keeps the chain short: every load it needs issued at its start, then no
// memory round trip until the stores; no shared memory, no barrier.
//
// Design.  A warp per codeword, or two or four that share its gather
// (`split`, ops/polar.py::_encode_params: up to 512 transmitted bits a
// warp), up to four warps a CTA.  The encoder's N <= 1024 bits live packed
// in registers: lane L holds positions 32L..32L+31 of u as one word
// (position 32L + b is bit b).  A warp issues about one instruction a
// cycle, so the design counts instructions.  A host plan per code
// (ops/polar.py::_encode_tables) gives
//   src[32][32] int16, lane l's row: the message index of position 32t + l
//             for t < N / 32 (the DL input interleaver i_IL folded in), or
//             -1 (frozen, PC, or past N);
//   pc[npc][32], pc_pos[npc]  uint32, per PC bit the mask of its sources
//             (the info positions the length-5 cyclic register feeds it,
//             ops/polar.py::_pc_sources) in each lane's word, then its
//             position;
//   plan[E]   int16 (padded to a multiple of 16), transmitted bit i =
//             x[plan[i]]: the sub-block interleaver, repetition / puncture
//             / shorten selection and (UL) the triangular interleaver i_BIL
//             composed into one gather.
// Each warp first loads its src row (four 16-byte loads a lane), message
// bytes, PC masks and its first round's plan (32 bytes a lane) into
// registers.  The message is packed by __ballot_sync, a word per 32 bits
// (lane w keeps word w).  u is built a word a round: lane l takes the
// message bit of position 32t + l by __shfl_sync and a ballot makes word t
// (N / 32 rounds, 8 at a time with no branch among them, so that they
// overlap).  A PC bit is the parity of u at its sources: __popc of the
// lane's word under its mask, __reduce_xor_sync over the warp (its sources
// are info bits, set before it).  The butterfly's stages 0-4 run inside a
// word (x ^= (x >> h) & M_s), stages 5..n-1 across lanes
// (__shfl_xor_sync).  The gather takes a lane's 16 transmitted bits of a
// round by __shfl_sync (16 independent shuffles) and writes them as one
// 16-byte store (csrc/warp_bits.cuh); a codeword's warps take its rounds
// in turn.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_bits.cuh"

// The plan's launch (by address; the kernel takes its fields by value).
struct PolarEncodeParams {
  int B;       // codewords
  int K;       // message bits, K <= N
  int n;       // log2 N, 5..10
  int E;       // transmitted bits
  int npc;     // parity-check bits
  int warps;   // warps a CTA
  int split;   // warps a codeword (its gather's rounds in turn): 1, 2 or 4
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr int kMsgWords = 8;     // message words loaded up front (K <= 256)
constexpr int kMaxPc = 4;        // PC masks loaded up front

// The 8 transmitted bits of one plan chunk (8 int16 sources) as bytes.
__device__ __forceinline__ uint64_t gather8(uint32_t x, uint4 q) {
  const uint32_t h[4] = {q.x, q.y, q.z, q.w};
  uint64_t v = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const uint32_t s = (h[t >> 1] >> (16 * (t & 1))) & 0xffffu;
    const uint32_t got = __shfl_sync(kFull, x, s >> 5);
    v |= (uint64_t)((got >> (s & 31)) & 1u) << (8 * t);
  }
  return v;
}

__global__ void __launch_bounds__(32 * kMaxWarps)
polar_encode_kernel(const int8_t* __restrict__ msg, int8_t* __restrict__ out,
                    const PolarEncodeParams p,
                    const int16_t* __restrict__ src,
                    const uint32_t* __restrict__ pc,
                    const uint4* __restrict__ plan) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * p.warps + (threadIdx.x >> 5);
  const int cw = warp >> (__ffs(p.split) - 1), part = warp & (p.split - 1);
  if (cw >= p.B) return;                     // the whole warp
  const int words = 1 << (p.n - 5);          // lanes that hold u
  const int chunks = (p.E + 15) >> 4;        // plan chunks of 16
  const int8_t* m = msg + (size_t)cw * p.K;

  // Every load first.
  const uint4* s4 = reinterpret_cast<const uint4*>(src + 32 * lane);
  uint4 sv[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) sv[v] = __ldg(s4 + v);
  int mb[kMsgWords];
#pragma unroll
  for (int w = 0; w < kMsgWords; ++w) {
    const int j = 32 * w + lane;
    mb[w] = j < p.K ? m[j] : 0;
  }
  uint32_t pm[kMaxPc], pp[kMaxPc];
#pragma unroll
  for (int k = 0; k < kMaxPc; ++k) {
    pm[k] = k < p.npc ? __ldg(pc + 32 * k + lane) : 0u;
    pp[k] = k < p.npc ? __ldg(pc + 32 * p.npc + k) : 0u;
  }
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const int c0 = 32 * part + lane;           // the lane's first 16 bits
  const uint4 pa = c0 < chunks ? __ldg(plan + 2 * c0) : zero;
  const uint4 pb = c0 < chunks ? __ldg(plan + 2 * c0 + 1) : zero;

  // The message packed: lane w keeps bits 32w..32w+31.
  uint32_t mw = 0;
#pragma unroll
  for (int w = 0; w < kMsgWords; ++w) {
    const uint32_t word = __ballot_sync(kFull, mb[w] & 1);
    if (lane == w) mw = word;
  }
  for (int w = kMsgWords; w < (p.K + 31) >> 5; ++w) {
    const int j = 32 * w + lane;
    const uint32_t word = __ballot_sync(kFull, j < p.K && (m[j] & 1));
    if (lane == w) mw = word;
  }

  // Allocation, a word of u a round: lane l takes position 32t + l.  The
  // rounds go 8 at a time with no branch among them, so that their
  // shuffles and ballots overlap (rounds past N / 32 give 0).
  uint32_t x = 0;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    if (8 * g >= words) break;               // the whole warp
    const uint4 q = sv[g];
    const uint32_t h[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = (int)(int16_t)(h[i >> 1] >> (16 * (i & 1)));
      const uint32_t got = __shfl_sync(kFull, mw, (e >> 5) & 31);
      const uint32_t word =
          __ballot_sync(kFull, e >= 0 && ((got >> (e & 31)) & 1u));
      if (lane == 8 * g + i) x = word;
    }
  }

  // Parity-check bits.
#pragma unroll
  for (int k = 0; k < kMaxPc; ++k) {
    if (k < p.npc) {
      const uint32_t par = __reduce_xor_sync(kFull, __popc(x & pm[k]) & 1u);
      if (lane == (int)(pp[k] >> 5)) x |= par << (pp[k] & 31);
    }
  }
  for (int k = kMaxPc; k < p.npc; ++k) {
    const uint32_t par = __reduce_xor_sync(
        kFull, __popc(x & __ldg(pc + 32 * k + lane)) & 1u);
    const uint32_t pos = __ldg(pc + 32 * p.npc + k);
    if (lane == (int)(pos >> 5)) x |= par << (pos & 31);
  }

  // x = u F^{(x)n}: stages 0-4 in the word, 5..n-1 across lanes.
  x ^= (x >> 1) & 0x55555555u;
  x ^= (x >> 2) & 0x33333333u;
  x ^= (x >> 4) & 0x0F0F0F0Fu;
  x ^= (x >> 8) & 0x00FF00FFu;
  x ^= (x >> 16) & 0x0000FFFFu;
#pragma unroll
  for (int s = 5; s < 10; ++s) {
    if (s == p.n) break;                     // the whole warp
    const int d = 1 << (s - 5);
    const uint32_t y = __shfl_xor_sync(kFull, x, d);
    if (!(lane & d)) x ^= y;
  }

  // Rate matching (+ i_BIL): the gather, 16 bits a lane a round, the
  // codeword's warps taking rounds part, part + split, ...
  int8_t* o = out + (size_t)cw * p.E;
  if (c0 - lane < chunks) {                  // the whole warp
    const uint64_t lo = gather8(x, pa), hi = gather8(x, pb);
    if (c0 < chunks) store16(o, p.E, c0, lo, hi);
  }
  for (int c = c0 + 32 * p.split; c - lane < chunks; c += 32 * p.split) {
    const bool in = c < chunks;
    const uint64_t lo = gather8(x, in ? __ldg(plan + 2 * c) : zero);
    const uint64_t hi = gather8(x, in ? __ldg(plan + 2 * c + 1) : zero);
    if (in) store16(o, p.E, c, lo, hi);
  }
}

}  // namespace

// msg int8 [B, K]; out int8 [B, E]; params by address; src int16 [32, 32];
// pc uint32 [npc * 32 + npc] (at least one word); plan int16 [E padded to a
// multiple of 16], values < N.
extern "C" int srsran_polar_encode(void* msg, void* out, void* stream,
                                   const void* params, void* src, void* pc,
                                   void* plan) {
  const PolarEncodeParams* p = (const PolarEncodeParams*)params;
  if (p->B < 1 || p->K < 1 || p->n < 5 || p->n > 10 || p->K > (1 << p->n) ||
      p->E < 1 || p->npc < 0 || p->split < 1 || (p->split & (p->split - 1)) ||
      p->warps < 1 || p->warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const long long warps = (long long)p->B * p->split;
  polar_encode_kernel<<<(int)((warps + p->warps - 1) / p->warps),
                        32 * p->warps, 0, (cudaStream_t)stream>>>(
      (const int8_t*)msg, (int8_t*)out, *p, (const int16_t*)src,
      (const uint32_t*)pc, (const uint4*)plan);
  return (int)cudaGetLastError();
}
