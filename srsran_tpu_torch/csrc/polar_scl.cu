// K29: CA-SCL polar list decoding for Hopper.
//
// Replaces srsran_tpu/ops/polar_scl.py::scl_decode (:35-166): successive-
// cancellation list decoding of [B, N] mother-codeword LLRs (N <= 1024)
// with list size L <= 8 over the whole decode tree (min-sum f = sign a
// sign b min(|a|, |b|), g = b + (1 - 2 x) a), a penalty |llr| on every
// frozen or parity-check leaf whose LLR disagrees with the known bit, the
// best L of the 2L candidates [pm + pen0 (paths 0..L-1), pm + pen1 (paths
// 0..L-1)] at every information leaf ordered by (metric, candidate index)
// as jax.lax.top_k orders ties, and at the end the message of the best
// path -- with a CRC, the best path whose trailing CRC passes (a failing
// path's metric + 1e20, the first index on ties), ok = any path passed.
// Twin: srsran_tpu_torch/ops/polar_scl.py::scl_decode_ref.
//
// Design.  One CTA per codeword and one warp per path.  The decoder's
// recursion is walked once per (frozen mask, PC bits) on the host into a
// leaf-by-leaf schedule (F, G, SAVE, COMB and one FROZEN / INFO / PC row
// per leaf); no Rate-0 / Rate-1 pruning, because the frozen leaves' penalties
// decide the survivors.  Each warp walks the schedule on its own path's
// buffers in shared memory -- an LLR vector and a partial-sum vector per
// tree level (2N floats, 2N bytes) and the decided bits u (N bytes) -- with
// only __syncwarp between steps.  At an information leaf the warps meet at
// one barrier: each warp's lane 0 writes its two candidates, every lane j
// < 2L ranks candidate j against all 2L, and warp w takes the candidate of
// rank w; it then copies its source path's whole state outright into the
// other of two buffer sets (ping-pong: 2L path states, 176 KB at N = 1024,
// L = 8, as opt-in dynamic shared memory).  The leaf's candidates are
// double-buffered, so one barrier per information leaf suffices.  Every
// float operation is the twin's in the twin's order (f and g are exact in
// float32, each metric update one rounded add; dead paths start at 1e30
// and tie until log2 L splits have separated them), so the survivors, the
// messages and the CRC flags are bit-exact.  Bounds on this card: about
// 3 L N log2 N operations on 4 B N bytes in: the kernel is latency-bound
// by its serial schedule (about 5 N warp steps and one barrier per
// information leaf), which is the nature of SC decoding; lazy copies and
// pruning are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_N = 1024;
constexpr int MAX_L = 8;

enum { OP_F = 0, OP_G, OP_SAVE, OP_COMB, OP_FROZEN, OP_INFO, OP_PC };

__device__ __forceinline__ int lvl(int big_n, int m) {
  return 2 * big_n - 2 * m;
}

__device__ __forceinline__ float sgn(float a) {
  return (float)((a > 0.f) - (a < 0.f));
}

__global__ void polar_scl_kernel(const float* __restrict__ llr, int n, int L,
                                 const int* __restrict__ program, int nops,
                                 const int* __restrict__ pc_table,
                                 const int* __restrict__ readout, int K,
                                 int crc_len, int poly,
                                 int8_t* __restrict__ bits,
                                 bool* __restrict__ ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float cand[2][2 * MAX_L];
  __shared__ float fin_pm[MAX_L];
  __shared__ int fin_ok[MAX_L];
  __shared__ int best_path;
  const int N = 1 << n;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // [set][path] states: LLR levels, partial-sum levels, decided bits
  float* lf = reinterpret_cast<float*>(smem);
  uint8_t* xs = smem + (size_t)2 * L * 2 * N * sizeof(float);
  uint8_t* us = xs + (size_t)2 * L * 2 * N;
  const float* x = llr + (size_t)blockIdx.x * N;

  int s = 0;  // the buffer set the paths live in
  float* Lw = lf + (size_t)w * 2 * N;
  uint8_t* Xw = xs + (size_t)w * 2 * N;
  uint8_t* Uw = us + (size_t)w * N;
  for (int i = lane; i < N; i += 32) {
    Lw[i] = x[i];
    Uw[i] = 0;
  }
  for (int i = lane; i < 2 * N; i += 32) Xw[i] = 0;
  float pm = w == 0 ? 0.f : 1e30f;
  int cp = 0;  // the candidates' buffer
  const int leaf = 2 * N - 2;
  __syncwarp();

  for (int o = 0; o < nops; ++o) {
    const int op = program[3 * o];
    const int a1 = program[3 * o + 1];
    const int lo = program[3 * o + 2];
    if (op <= OP_COMB) {
      const int m = 1 << a1, h = m >> 1;
      const int lm = lvl(N, m), lh = lvl(N, h);
      switch (op) {
        case OP_F:
          for (int i = lane; i < h; i += 32) {
            const float a = Lw[lm + i], b = Lw[lm + h + i];
            Lw[lh + i] = sgn(a) * sgn(b) * fminf(fabsf(a), fabsf(b));
          }
          break;
        case OP_G:
          for (int i = lane; i < h; i += 32) {
            const float a = Lw[lm + i], b = Lw[lm + h + i];
            Lw[lh + i] = b + (1.f - 2.f * (float)Xw[lm + i]) * a;
          }
          break;
        case OP_SAVE:
          for (int i = lane; i < h; i += 32) Xw[lm + i] = Xw[lh + i];
          break;
        default: {  // OP_COMB
          for (int i = lane; i < h; i += 32) {
            const uint8_t r = Xw[lh + i];
            Xw[lm + i] ^= r;
            Xw[lm + h + i] = r;
          }
        }
      }
      __syncwarp();
      continue;
    }
    const float v = Lw[leaf];
    if (op != OP_INFO) {  // a known bit: 0, or a PC bit's parity of u
      int bit = 0;
      if (op == OP_PC) {
        int acc = 0;
        for (int j = pc_table[a1] + lane; j < pc_table[a1 + 1]; j += 32)
          acc += Uw[pc_table[j]];
        for (int d = 16; d > 0; d >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, d);
        bit = acc & 1;
      }
      const bool mismatch = bit ? v > 0.f : v < 0.f;
      pm = pm + (mismatch ? fabsf(v) : 0.f);
      __syncwarp();
      if (lane == 0) {
        Xw[leaf] = (uint8_t)bit;
        Uw[lo] = (uint8_t)bit;
      }
      __syncwarp();
      continue;
    }
    // Information leaf: split every path into its bit-0 / bit-1 candidates
    // and keep the best L.
    const float pen0 = v < 0.f ? fabsf(v) : 0.f;
    const float pen1 = v > 0.f ? fabsf(v) : 0.f;
    if (lane == 0) {
      cand[cp][w] = pm + pen0;
      cand[cp][L + w] = pm + pen1;
    }
    __syncthreads();
    int rank = 0;
    const float cj = lane < 2 * L ? cand[cp][lane] : 0.f;
    for (int k = 0; k < 2 * L; ++k) {
      const float ck = cand[cp][k];
      rank += (ck < cj) || (ck == cj && k < lane);
    }
    const unsigned sel = __ballot_sync(0xffffffffu, lane < 2 * L && rank == w);
    const int jw = sel ? __ffs(sel) - 1 : w;
    const int src = jw % L;
    const int bit = jw >= L;
    pm = cand[cp][jw];
    cp ^= 1;
    // copy the source path's state into this path's buffers of the other set
    const size_t from = (size_t)s * L + src, to = (size_t)(1 - s) * L + w;
    {
      const int4* a = reinterpret_cast<const int4*>(lf + from * 2 * N);
      int4* b = reinterpret_cast<int4*>(lf + to * 2 * N);
      for (int i = lane; i < N / 2; i += 32) b[i] = a[i];
    }
    {
      const int* a = reinterpret_cast<const int*>(xs + from * 2 * N);
      int* b = reinterpret_cast<int*>(xs + to * 2 * N);
      for (int i = lane; i < N / 2; i += 32) b[i] = a[i];
    }
    {
      const int* a = reinterpret_cast<const int*>(us + from * N);
      int* b = reinterpret_cast<int*>(us + to * N);
      for (int i = lane; i < N / 4; i += 32) b[i] = a[i];
    }
    s = 1 - s;
    Lw = lf + to * 2 * N;
    Xw = xs + to * 2 * N;
    Uw = us + to * N;
    __syncwarp();
    if (lane == 0) {
      Xw[leaf] = (uint8_t)bit;
      Uw[lo] = (uint8_t)bit;
    }
    __syncwarp();
  }

  // Each path's message CRC (the remainder of all K bits is 0 when the
  // trailing CRC matches), then the selection.
  if (lane == 0) {
    int pass = 1;
    if (crc_len > 0) {
      const unsigned mask = (1u << crc_len) - 1u;
      unsigned reg = 0;
      for (int k = 0; k < K; ++k) {
        const unsigned fb = ((reg >> (crc_len - 1)) & 1u) ^ Uw[readout[k]];
        reg = (reg << 1) & mask;
        if (fb) reg ^= (unsigned)poly & mask;
      }
      pass = reg == 0;
    }
    fin_pm[w] = pm;
    fin_ok[w] = pass;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int best = 0, any = 0;
    float bv = 0.f;
    for (int p = 0; p < L; ++p) {
      const float vp = (crc_len == 0 || fin_ok[p]) ? fin_pm[p]
                                                   : fin_pm[p] + 1e20f;
      if (p == 0 || vp < bv) {
        bv = vp;
        best = p;
      }
      any |= fin_ok[p];
    }
    best_path = best;
    ok[blockIdx.x] = crc_len == 0 ? true : any != 0;
  }
  __syncthreads();
  const uint8_t* ub = us + ((size_t)s * L + best_path) * N;
  int8_t* out = bits + (size_t)blockIdx.x * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    out[k] = (int8_t)ub[readout[k]];
}

}  // namespace

// llr f32 [B, N] mother-codeword LLRs; program int32 [nops, 3]; pc_table
// int32 (n_pc + 1 CSR offsets, then the sources); readout int32 [K]; crc_len
// 0 for no CRC; bits int8 [B, K]; ok bool [B].
extern "C" int srsran_polar_scl(void* llr, int B, int n, int L, void* program,
                                int nops, void* pc_table, void* readout, int K,
                                int crc_len, int poly, void* bits, void* ok,
                                void* stream) {
  if (n < 5 || (1 << n) > MAX_N || L < 1 || L > MAX_L || B < 1 || K < 1 ||
      crc_len < 0 || crc_len > 24)
    return (int)cudaErrorInvalidValue;
  const int N = 1 << n;
  const size_t smem = (size_t)2 * L * (2 * N * sizeof(float) + 2 * N + N);
  cudaError_t err = cudaFuncSetAttribute(
      polar_scl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  polar_scl_kernel<<<B, 32 * L, smem, (cudaStream_t)stream>>>(
      (const float*)llr, n, L, (const int*)program, nops,
      (const int*)pc_table, (const int*)readout, K, crc_len, poly,
      (int8_t*)bits, (bool*)ok);
  return (int)cudaGetLastError();
}
