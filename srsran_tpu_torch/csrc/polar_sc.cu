// K15: polar rate dematch + successive-cancellation decode + CRC check for
// Hopper.
//
// Replaces srsran_tpu/ops/polar.py::rate_dematch (:171-189) and sc_decode
// (:203-241), and the crc.py::crc_check of the decoded message that the UCI
// decoders run after them (pucch.py:782-785, uci.py:44-47), or the DCI's
// check (pdcch.py::decode_dci :97-100) and the PBCH's (ssb.py::pbch_decode
// :363-365) on the UE side: the inverse triangular channel interleaver, the
// accumulation of the received LLRs over the rate-matching plan (punctured
// bits 0, shortened bits 1e4, repetitions summed in transmission order),
// the tree-pruned simplified SC decoder over N <= 1024 (min-sum f = sign a
// sign b min(|a|, |b|), g = b + (1 - 2 x) a, RATE_0 segments decide zeros,
// RATE_1 segments hard-decide and re-encode), the read-out of the message
// bits and the check of their trailing CRC.  Twin:
// srsran_tpu_torch/ops/polar.py::decode_ref.
//
// What bounds it.  About 3 N log2 N operations on 4 E + N bytes: nothing
// on this card.  SC is a chain of dependent node steps (121 at the F2's N =
// 64, 381 for the PBCH, 591 at N = 1024), so the time is the steps' latency
// times their count.  The former design (one CTA a codeword walking the
// schedule with a CTA barrier and a global load of the step's row per
// step) took ~570 cycles a step.
//
// Design.  One warp decodes one codeword (several warps a CTA, every
// codeword of a batch [S, B, E] in one launch); nothing in the kernel
// waits on more than its warp.
//   * The schedule (ops/polar.py::_sc_words) is one 32-bit word a step:
//     op | log2 m << 3 | first u index << 7, a G step also saving the left
//     child's bits (the twin's SAVE).  A mixed node of 16 positions is one
//     SUB step (its first u index / 16 << 7, its frozen flags << 13) that
//     every lane decodes whole in registers by the twin's recursion
//     (sc_small): the F2's 121 rows become 13 steps, the PBCH's 381 65,
//     N = 1024's 591 113.  The words go by value in the launch's struct: a
//     step reads its word from the constant bank at an index every lane
//     shares, so its branches are uniform and nothing waits on memory.
//   * LLRs: the levels of nodes of m >= 64 live in shared memory (2N floats
//     a warp, level m at 2N - 2m); a node of 16 or 32 lives in registers,
//     element i in lane i, one register a level, its halves exchanged by
//     shuffles.  The steps of m <= 64 are templates on log2 m, so every
//     level's register is named at compile time; the larger ones share one
//     copy of the code.
//   * Bits, packed: the hard bits x of a level of m <= 32 are one word
//     that every lane holds (a ballot makes it), of a level of m >= 64
//     m / 32 words in shared memory; the decided u are N / 32 words, word j
//     in lane j.  SAVE and COMB are word operations, and a RATE_1 leaf's
//     re-encode is the butterfly on packed words: shifts and masks inside a
//     word, a shuffle-XOR between words.
//   * The CRC is linear: its register over the K decoded bits is the XOR of
//     the remainder word of each set bit (a host table [K],
//     ops/crc.py::_remainder_words, loaded before the steps), taken with
//     __reduce_xor_sync and compared with the expected syndrome (0 for a
//     plain trailing CRC; a DCI's is the remainder of its 24 leading ones
//     and RNTI mask, which the host computes once per RNTI).
//   * Rate dematch in the same launch: lane p holds mother positions p +
//     32 c and sums their received LLRs round by round in transmission
//     order, from a host table of the received index per (round,
//     position): every round's loads in flight at once.
// min-sum f and g are exact in float32 (f's sign is the XOR of its inputs'
// signs, g adds or subtracts once), the sign of 0 is 0 (a zero LLR decides
// bit 0, a zero of either sign adds nothing) and no node type changes the
// float operations, so the bits and flags equal the twin's.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kPolarMaxSteps = 2048;

// Mirrors kernels/_build.py::PolarDecodeParams (K15's launch).  The table
// (int32) holds, in order: dem[R][N] (round j of mother position q: the
// received index summed into it, -1 none, -2 at j = 0: shortened),
// readout[K] (the message bits' positions in u) and rem[K] (the CRC
// remainder word of each message bit).
struct PolarDecodeParams {
  int B;          // codewords
  int E;          // received LLRs a codeword
  int n;          // log2 N, 5..10
  int K;          // message bits (CRC included)
  int R;          // rounds of the rate dematch (received LLRs a position)
  int nops;       // schedule words
  int warps;      // warps (codewords) a CTA
  unsigned expect;  // the CRC register of a good message
  unsigned words[kPolarMaxSteps];  // the schedule, a word a step
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxN = 1024;
constexpr int kMaxWarps = 8;
constexpr int kCrcRounds = 8;      // readout and remainder words kept in
                                   // registers: K <= 256

enum { OP_R0 = 0, OP_R1 = 1, OP_F = 2, OP_G = 3, OP_COMB = 5, OP_SUB = 6 };
constexpr int kSubLg = 4;          // a SUB word decodes a node of 16 whole

// f = sign a sign b min(|a|, |b|) and g = b + (1 - 2 x) a, as the twin
// computes them: the sign of f's minimum is the XOR of a's and b's (of a
// zero minimum, a zero either way: every zero decides bit 0 and adds
// nothing), and g adds or subtracts a once.
__device__ __forceinline__ float fnode(float a, float b) {
  const float m = fminf(fabsf(a), fabsf(b));
  return __int_as_float(__float_as_int(m) |
                        ((__float_as_int(a) ^ __float_as_int(b)) &
                         (int)0x80000000));
}
__device__ __forceinline__ float gnode(float a, float b, unsigned x) {
  return x ? b - a : b + a;
}
__device__ __forceinline__ unsigned low_mask(int m) {
  return m >= 32 ? kFull : (1u << m) - 1u;
}

// u = x F^{(x) log2 m} inside one word of m <= 32 bits (the butterfly is
// its own inverse): stage `half` XORs bit a + half into bit a.
__device__ __forceinline__ unsigned butterfly_word(unsigned w, int m) {
  if (m > 1) w ^= (w >> 1) & 0x55555555u;
  if (m > 2) w ^= (w >> 2) & 0x33333333u;
  if (m > 4) w ^= (w >> 4) & 0x0f0f0f0fu;
  if (m > 8) w ^= (w >> 8) & 0x00ff00ffu;
  if (m > 16) w ^= (w >> 16) & 0x0000ffffu;
  return w;
}

// The node of M <= 16 positions whose LLRs are v, decoded by the twin's
// recursion in one lane's registers (mask bit i: position i frozen): its
// hard bits x and decided bits u, bit i for position i.
template <int M>
__device__ __forceinline__ void sc_small(const float (&v)[M], unsigned mask,
                                         unsigned& x, unsigned& u) {
  constexpr unsigned full = (1u << M) - 1u;
  mask &= full;
  if (mask == full) {                      // RATE_0
    x = u = 0u;
    return;
  }
  if (mask == 0u) {                        // RATE_1
    unsigned b = 0u;
#pragma unroll
    for (int i = 0; i < M; ++i) b |= (unsigned)(v[i] < 0.f) << i;
    x = b;
    u = butterfly_word(b, M);
    return;
  }
  if constexpr (M > 1) {
    constexpr int H = M / 2;
    float a[H];
#pragma unroll
    for (int i = 0; i < H; ++i) a[i] = fnode(v[i], v[H + i]);
    unsigned xl, ul;
    sc_small<H>(a, mask, xl, ul);
    float b[H];
#pragma unroll
    for (int i = 0; i < H; ++i) b[i] = gnode(v[i], v[H + i], (xl >> i) & 1u);
    unsigned xr, ur;
    sc_small<H>(b, mask >> H, xr, ur);
    x = (xl ^ xr) | (xr << H);
    u = ul | (ur << H);
  } else {
    x = u = 0u;                            // not reached: a mask of 1 bit
  }
}

// A RATE_1 leaf of m >= 64 elements: the hard bits of its shared LLR
// level Ls[lm, lm + m) as m / 32 words (lane j: word j, also stored to
// Xs[wm + j]), re-encoded into the decided bits u from position lo.
__device__ __forceinline__ void rate1_shared(const float* Ls, unsigned* Xs,
                                             int lm, int wm, int m, int lo,
                                             unsigned& u, int lane) {
  const int nw = m >> 5;
  unsigned x = 0u;
  for (int k = 0; k < nw; ++k) {
    const unsigned b = __ballot_sync(kFull, Ls[lm + 32 * k + lane] < 0.f);
    if (lane == k) x = b;
  }
  if (lane < nw) Xs[wm + lane] = x;
  unsigned v = butterfly_word(x, 32);
  for (int s = 1; s < nw; s <<= 1) {
    const unsigned o = __shfl_xor_sync(kFull, v, s);
    if (!(lane & s)) v ^= o;
  }
  const int w0 = lo >> 5;
  v = __shfl_sync(kFull, v, (lane - w0) & 31);
  if (lane >= w0 && lane < w0 + nw) u = v;
}

// A warp's registers: r[l] the LLRs of the level of 2^l elements, l = 4, 5
// (lane i: element i), xs[l] its hard bits (every lane the same word), u
// the decided bits (lane j: word j); a node of 16 or fewer positions is
// decided whole (sc_small).  Levels of m >= 64 live in shared
// memory: LLRs Ls (level m at 2N - 2m) and hard bits Xs (level m at word
// (2N - 2m) / 32, lane j: word j).
struct Warp {
  float r[6];
  unsigned xs[6];
  unsigned u;
};

// A node step at log2 m = LG in 4..6 (its child level in registers).
template <int LG>
__device__ __forceinline__ void step(Warp& w, unsigned word, float* Ls,
                                     unsigned* Xs, int N, int lane) {
  constexpr int m = 1 << LG;
  constexpr int h = m >> 1;
  const int op = word & 7, lo = word >> 7;
  if constexpr (LG <= 5) {
    if (op == OP_R0) {
      w.xs[LG] = 0u;
    } else if (op == OP_R1) {
      const unsigned x = __ballot_sync(kFull, w.r[LG] < 0.f) & low_mask(m);
      w.xs[LG] = x;
      if (lane == (lo >> 5)) w.u |= butterfly_word(x, m) << (lo & 31);
    } else if constexpr (LG == kSubLg) {   // OP_SUB: the whole node
      float v[m];
#pragma unroll
      for (int i = 0; i < m; ++i) v[i] = __shfl_sync(kFull, w.r[LG], i);
      unsigned x, u;
      sc_small<m>(v, word >> 13, x, u);
      w.xs[LG] = x;
      const int first = ((word >> 7) & 63) * m;
      if (lane == (first >> 5)) w.u |= u << (first & 31);
    } else {
      if (op == OP_COMB) {
        const unsigned r = w.xs[LG - 1] & low_mask(h);
        w.xs[LG] = ((w.xs[LG] ^ r) & low_mask(h)) | (r << h);
      } else {
        const float a = w.r[LG];
        const float b = __shfl_sync(kFull, w.r[LG], (lane + h) & 31);
        if (op == OP_F) {
          w.r[LG - 1] = fnode(a, b);
        } else {                           // SAVE, then G
          w.xs[LG] = w.xs[LG - 1] & low_mask(h);
          w.r[LG - 1] = gnode(a, b, (w.xs[LG - 1] >> lane) & 1u);
        }
      }
    }
  } else {                                 // LG == 6: a shared level
    const int lm = 2 * N - 2 * m, wm = lm >> 5;
    if (op == OP_R0) {
      if (lane < 2) Xs[wm + lane] = 0u;
    } else if (op == OP_R1) {
      rate1_shared(Ls, Xs, lm, wm, m, lo, w.u, lane);
    } else if (op == OP_COMB) {
      if (lane == 0) Xs[wm] ^= w.xs[5];
      if (lane == 1) Xs[wm + 1] = w.xs[5];
    } else {
      const float a = Ls[lm + lane], b = Ls[lm + h + lane];
      if (op == OP_F) {
        w.r[5] = fnode(a, b);
      } else {
        if (lane == 0) Xs[wm] = w.xs[5];
        w.r[5] = gnode(a, b, (w.xs[5] >> lane) & 1u);
      }
    }
    __syncwarp();
  }
}

// A node step at log2 m = lg >= 7 (shared levels only; one copy of the
// code for every such level).
__device__ __forceinline__ void step_shared(unsigned& u, int op, int lg,
                                            int lo, float* Ls, unsigned* Xs,
                                            int N, int lane) {
  const int m = 1 << lg, h = m >> 1, hw = h >> 5;
  const int lm = 2 * N - 2 * m, lh = lm + m, wm = lm >> 5, wh = lh >> 5;
  if (op == OP_R0) {
    if (lane < 2 * hw) Xs[wm + lane] = 0u;
  } else if (op == OP_R1) {
    rate1_shared(Ls, Xs, lm, wm, m, lo, u, lane);
  } else if (op == OP_COMB) {
    if (lane < hw) Xs[wm + lane] ^= Xs[wh + lane];
    else if (lane < 2 * hw) Xs[wm + lane] = Xs[wh + lane - hw];
  } else if (op == OP_F) {
    for (int i = lane; i < h; i += 32)
      Ls[lh + i] = fnode(Ls[lm + i], Ls[lm + h + i]);
  } else {                                 // SAVE, then G
    if (lane < hw) Xs[wm + lane] = Xs[wh + lane];
    for (int k = 0; k < hw; ++k) {
      const unsigned xk = Xs[wh + k];
      const int i = 32 * k + lane;
      Ls[lh + i] = gnode(Ls[lm + i], Ls[lm + h + i], (xk >> lane) & 1u);
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    polar_sc_kernel(const float* __restrict__ llr, int8_t* __restrict__ bits,
                    bool* __restrict__ ok, const PolarDecodeParams p,
                    const int* __restrict__ tab) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int cw = blockIdx.x * p.warps + wid;
  if (cw >= p.B) return;                   // the whole warp
  const int N = 1 << p.n;
  const int* dem = tab;
  const int* readout = dem + p.R * N;
  const unsigned* rem = reinterpret_cast<const unsigned*>(readout + p.K);
  float* Ls = smem + (size_t)wid * (2 * N + 64);
  unsigned* Xs = reinterpret_cast<unsigned*>(Ls + 2 * N);

  // The CRC's tables, loaded now and used at the end.
  int ro[kCrcRounds];
  unsigned rw[kCrcRounds];
#pragma unroll
  for (int c = 0; c < kCrcRounds; ++c) {
    const int k = 32 * c + lane;
    ro[c] = k < p.K ? __ldg(readout + k) : 0;
    rw[c] = k < p.K ? __ldg(rem + k) : 0u;
  }

  // Rate dematch into the root level: lane holds positions lane + 32 c,
  // eight at a time; round j adds the received LLR dem[j][q] (in
  // transmission order).
  const float* x = llr + (size_t)cw * p.E;
  float root = 0.f;                        // position lane, the root of N = 32
  for (int c0 = 0; c0 < (N >> 5); c0 += 8) {
    float acc[8];
    bool shortened[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      acc[c] = 0.f;
      shortened[c] = false;
    }
    for (int j = 0; j < p.R; ++j) {
      int idx[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        idx[c] = c0 + c < (N >> 5) ? __ldg(dem + j * N + 32 * (c0 + c) + lane)
                                   : -1;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (idx[c] >= 0) acc[c] += __ldg(x + idx[c]);
        shortened[c] |= idx[c] == -2;
      }
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float v = shortened[c] ? 1e4f : acc[c];
      if (c0 + c < (N >> 5)) Ls[32 * (c0 + c) + lane] = v;
      if (c0 + c == 0) root = v;
    }
  }

  Warp w;
#pragma unroll
  for (int l = 0; l < 6; ++l) {
    w.r[l] = 0.f;
    w.xs[l] = 0u;
  }
  w.u = 0u;
  w.r[5] = root;                           // the root when N = 32
  __syncwarp();

#pragma unroll 1
  for (int o = 0; o < p.nops; ++o) {
    const unsigned word = p.words[o];
    const int lg = (word >> 3) & 15;
    switch (lg) {                          // no node below kSubLg
      case 4: step<4>(w, word, Ls, Xs, N, lane); break;
      case 5: step<5>(w, word, Ls, Xs, N, lane); break;
      case 6: step<6>(w, word, Ls, Xs, N, lane); break;
      default:
        step_shared(w.u, word & 7, lg, word >> 7, Ls, Xs, N, lane);
        break;
    }
  }

  // Message bits, and the CRC register as the XOR of the set bits'
  // remainder words.
  unsigned reg = 0u;
  int8_t* out = bits + (size_t)cw * p.K;
#pragma unroll
  for (int c = 0; c < kCrcRounds; ++c) {
    const int k = 32 * c + lane;
    const unsigned word = __shfl_sync(kFull, w.u, ro[c] >> 5);
    const unsigned b = (word >> (ro[c] & 31)) & 1u;
    if (k < p.K) {
      out[k] = (int8_t)b;
      if (b) reg ^= rw[c];
    }
  }
  for (int k0 = 32 * kCrcRounds; k0 < p.K; k0 += 32) {
    const int k = k0 + lane;
    const int pos = k < p.K ? __ldg(readout + k) : 0;
    const unsigned word = __shfl_sync(kFull, w.u, pos >> 5);
    const unsigned b = (word >> (pos & 31)) & 1u;
    if (k < p.K) {
      out[k] = (int8_t)b;
      if (b) reg ^= __ldg(rem + k);
    }
  }
  reg = __reduce_xor_sync(kFull, reg);
  if (lane == 0) ok[cw] = reg == p.expect;
}

}  // namespace

// llr f32 [B, E]; bits int8 [B, K]; ok bool [B]; params a
// PolarDecodeParams; tab the int32 table above.
extern "C" int srsran_polar_decode(void* llr, void* bits, void* ok,
                                   void* stream, const void* params,
                                   const void* tab) {
  const PolarDecodeParams* p = (const PolarDecodeParams*)params;
  if (p->n < 5 || (1 << p->n) > kMaxN || p->B < 1 || p->E < 1 || p->K < 1 ||
      p->R < 1 || p->nops < 1 || p->nops > kPolarMaxSteps || p->warps < 1 ||
      p->warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (2 * ((size_t)1 << p->n) + 64) * p->warps;
  polar_sc_kernel<<<(p->B + p->warps - 1) / p->warps, 32 * p->warps, smem,
                    (cudaStream_t)stream>>>(
      (const float*)llr, (int8_t*)bits, (bool*)ok, *p, (const int*)tab);
  return (int)cudaGetLastError();
}
