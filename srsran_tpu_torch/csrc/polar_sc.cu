// K15: polar rate dematch + successive-cancellation decode + CRC check for
// Hopper.
//
// Replaces srsran_tpu/ops/polar.py::rate_dematch (:171-189) and sc_decode
// (:203-241), and the crc.py::crc_check of the decoded message that the UCI
// decoders run after them (pucch.py:782-785, uci.py:44-47): the inverse
// triangular channel interleaver, the accumulation of the received LLRs
// over the rate-matching plan (punctured bits 0, shortened bits 1e4,
// repetitions summed in transmission order), the tree-pruned simplified SC
// decoder over N <= 1024 (min-sum f = sign a sign b min(|a|, |b|), g = b +
// (1 - 2 x) a, RATE_0 segments decide zeros, RATE_1 segments hard-decide and
// re-encode), the read-out of the message bits and the check of their
// trailing CRC.  Twin: srsran_tpu_torch/ops/polar.py::decode_ref.
//
// Design.  One CTA per codeword.  The decoder's recursion is walked on the
// host once per frozen mask into a flat node schedule (F, G, SAVE, COMB,
// RATE_0, RATE_1 rows); every thread of the block walks the same schedule,
// each step a vector operation over the node's length, with a barrier
// between steps.  Shared memory holds one LLR vector and one hard-bit
// vector per tree level (2N floats, 2N bytes) and the decided bits u (N
// bytes).  min-sum f and g are exact in float32 (g adds once), and the sign
// of 0 is 0 (a zero LLR decides bit 0), so the decoded bits equal the
// twin's; the repetition sums run in the twin's order.  Bounds on this card:
// about 3 N log2 N operations on 4 E + N bytes: the kernel is latency-bound
// by its serial schedule (one barrier per node), which is the nature of SC.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_N = 1024;

enum { OP_R0 = 0, OP_R1 = 1, OP_F = 2, OP_G = 3, OP_SAVE = 4, OP_COMB = 5 };

// Offsets of the level buffers of node length m (< 2N in all).
__device__ __forceinline__ int lvl(int big_n, int m) { return 2 * big_n - 2 * m; }

__device__ __forceinline__ float sgn(float a) {
  return (float)((a > 0.f) - (a < 0.f));
}

__global__ void polar_sc_kernel(const float* __restrict__ llr, int E, int n,
                                const int* __restrict__ tables,
                                const int* __restrict__ program, int nops,
                                const int* __restrict__ readout, int K,
                                int crc_len, int poly,
                                int8_t* __restrict__ bits,
                                bool* __restrict__ ok) {
  __shared__ float L[2 * MAX_N];
  __shared__ uint8_t X[2 * MAX_N];
  __shared__ uint8_t U[MAX_N];
  const int t = threadIdx.x;
  const int N = 1 << n;
  const float* x = llr + (size_t)blockIdx.x * E;
  const int* first = tables;          // [N + E]: first[n], then src[i]
  const int* src = tables + N;
  const int* shortened = tables + N + E;  // second row, [N] used

  // Rate dematch into the root level (offset 0).
  for (int p = t; p < N; p += NT) {
    float acc = 0.f;
    for (int i = first[p]; i >= 0 && i < E; i += N) acc += x[src[i]];
    L[p] = shortened[p] ? 1e4f : acc;
    U[p] = 0;
  }
  __syncthreads();

  for (int o = 0; o < nops; ++o) {
    const int op = program[3 * o];
    const int m = 1 << program[3 * o + 1];
    const int lo = program[3 * o + 2];
    const int h = m >> 1;
    const int lm = lvl(N, m), lh = lvl(N, h);
    switch (op) {
      case OP_F:
        for (int i = t; i < h; i += NT) {
          const float a = L[lm + i], b = L[lm + h + i];
          L[lh + i] = sgn(a) * sgn(b) * fminf(fabsf(a), fabsf(b));
        }
        break;
      case OP_G:   // the left child's bits are in the node's own X (SAVE)
        for (int i = t; i < h; i += NT) {
          const float a = L[lm + i], b = L[lm + h + i];
          L[lh + i] = b + (1.f - 2.f * (float)X[lm + i]) * a;
        }
        break;
      case OP_SAVE:
        for (int i = t; i < h; i += NT) X[lm + i] = X[lh + i];
        break;
      case OP_COMB:
        for (int i = t; i < h; i += NT) {
          const uint8_t r = X[lh + i];
          X[lm + i] ^= r;
          X[lm + h + i] = r;
        }
        break;
      case OP_R0:
        for (int i = t; i < m; i += NT) X[lm + i] = 0;
        break;
      case OP_R1: {
        for (int i = t; i < m; i += NT) {
          const uint8_t b = L[lm + i] < 0.f;
          X[lm + i] = b;
          U[lo + i] = b;
        }
        // u = x F^{(x)log2 m} (the butterfly is its own inverse)
        for (int half = 1; half < m; half <<= 1) {
          __syncthreads();
          for (int i = t; i < h; i += NT) {
            const int a = lo + (i / half) * 2 * half + i % half;
            U[a] ^= U[a + half];
          }
        }
        break;
      }
    }
    __syncthreads();
  }

  // Message bits, then the CRC register over all K of them (message with
  // its CRC: the remainder is 0 when the CRC matches).
  int8_t* out = bits + (size_t)blockIdx.x * K;
  for (int k = t; k < K; k += NT) out[k] = (int8_t)U[readout[k]];
  if (t == 0) {
    const unsigned mask = (1u << crc_len) - 1u;
    unsigned reg = 0;
    for (int k = 0; k < K; ++k) {
      const unsigned fb = ((reg >> (crc_len - 1)) & 1u) ^ U[readout[k]];
      reg = (reg << 1) & mask;
      if (fb) reg ^= (unsigned)poly & mask;
    }
    ok[blockIdx.x] = reg == 0;
  }
}

}  // namespace

// llr f32 [B, E]; tables int32 [2, N + E] (first/src, shortened);
// program int32 [nops, 3]; readout int32 [K]; bits int8 [B, K]; ok bool [B].
extern "C" int srsran_polar_decode(void* llr, int B, int E, int n, void* tables,
                                   void* program, int nops, void* readout,
                                   int K, int crc_len, int poly, void* bits,
                                   void* ok, void* stream) {
  if (n < 1 || (1 << n) > MAX_N || B < 1 || E < 1 || K < 1 || crc_len < 1 ||
      crc_len > 24)
    return (int)cudaErrorInvalidValue;
  polar_sc_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(
      (const float*)llr, E, n, (const int*)tables, (const int*)program, nops,
      (const int*)readout, K, crc_len, poly, (int8_t*)bits, (bool*)ok);
  return (int)cudaGetLastError();
}
