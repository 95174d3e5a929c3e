// K21: the PRACH occasion demodulator, for Hopper.
//
// Replaces srsran_tpu/phy/lower/prach_demod.py::demodulate (:29-52), the
// JAX package's [L_ra, N_u] bin matrix times each repetition's window.
// Twin: srsran_tpu_torch/phy/lower/prach_demod.py::demodulate_ref.
//
//   out[p, r, k] = sum_n tw[((b0 + k) n) mod N_u] x[p, s0 + r N_u + n],
//   tw[m] = e^{-2 pi i m / N_u} / sqrt(N_u)
//
// a complex product of [L_ra x N_u] by [N_u x ports * reps] (B4 on the
// flagship: 139 x 4096 by 4096 x 48).
//
// Design: a register-tiled product on the CUDA cores.  A CTA of 8 warps
// owns a tile of 8 bins by RT rows (RT = 4; 2 or 1 when there are fewer
// rows) and a range of the samples; each thread holds the tile's 8 x RT
// complex sums in registers.  Sample n = 32 q + l goes to lane l of the
// warp that owns 32-sample block q (the 8 warps take the blocks in turn),
// so a warp reads each row's 32 samples as one coalesced 256 B load, and
// the twiddle splits as tw[b n] = tw[32 b q] tw[b l] sqrt(N_u):
//
//   out[b] = sqrt(N_u) sum_l tw[b l] sum_q tw[32 b q] x[32 q + l].
//
// In the loop over q every lane of a warp reads the same entry
// tw[32 b q] (a broadcast: one shared-memory wavefront per bin, no bank
// conflicts), and each entry feeds RT complex multiply-adds; the lane's
// own factor tw[b l] is applied once at the end.  Every twiddle index is
// exact integer arithmetic mod N_u (no phase is formed in float32, where
// b n reaches 10^10 for the long formats), and the table is built in
// float64 on the host and cast, as the JAX matrix is.  The 8 bins' indices
// follow one another by 32 q mod N_u, so a thread keeps one index and one
// step, not one per bin, as byte offsets (a mask in place of the wrap when
// N_u is a power of two, as at B4's 4096).  The sums over the lanes run as
// a butterfly reduce-scatter (each level halves the values a lane holds),
// then over the 8 warps in order in shared memory.  When the tiles are
// fewer than the card's SMs (format 0: 4 rows of 839 bins) the samples
// split over CTAs (split-K) into a scratch buffer, summed by a second
// kernel in split order, so the result is the same run to run.  At N_u <=
// 6144 the table sits in shared memory (opt-in above 48 KB), copied in by
// cp.async with every copy in flight at once, while the first samples
// load; above (the long formats, N_u up to 98,304) the broadcast reads go
// through L1/L2.  Each iteration loads the next block's samples before its
// arithmetic.
//
// Bound on this card: bytes.  B4 on the flagship moves 1.6 MB of window
// and output, 0.49 us at 3.35 TB/s; an N_u-point FFT per port and
// repetition would do 11.8 MFLOP.  This direct product does 8 L_ra N_u per
// row, 218.6 MFLOP at B4, 3.3 us at the 67 TFLOP/s of FP32 FMA.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Mirrors kernels/_build.py::PrachDemodParams.
struct PrachDemodParams {
  int ports, row_stride, start, n_u, reps, l_ra, b0;
  int rt;            // rows per thread: 1, 2 or 4
  int splits;        // CTAs over the samples of one tile
  int split_blocks;  // 32-sample blocks per split, a multiple of kWarps
  float scale;       // sqrt(N_u): tw carries 1/sqrt(N_u), and enters twice
};

constexpr int kBins = 8;              // bins per CTA (and per thread)
constexpr int kSmemMax = 6144;        // table entries held in shared memory
constexpr unsigned kFull = 0xffffffffu;

// One level of the butterfly: lanes l and l ^ OFF hold the same 2H values;
// each keeps one half, summed with its partner's copy of that half.  At
// H == 2 (one complex value left) the remaining offsets sum plainly.
// ``slot`` collects which elements the lane keeps.
template <int H, int OFF, int V>
__device__ __forceinline__ void scatter(float (&v)[V], int lane, int& slot) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, OFF);
  }
  if (upper) slot += H;
  if constexpr (H > 2 && OFF > 1) {
    scatter<H / 2, OFF / 2>(v, lane, slot);
  } else {
#pragma unroll
    for (int o = OFF / 2; o >= 1; o /= 2) {
      v[0] += __shfl_xor_sync(kFull, v[0], o);
      v[1] += __shfl_xor_sync(kFull, v[1], o);
    }
  }
}

// (a + d) mod n8 for a, d in [0, n8): a mask when N_u is a power of two.
template <bool kPow2>
__device__ __forceinline__ int wrap_add(int a, int d, int n8) {
  if (kPow2) return (a + d) & (n8 - 1);
  a += d;
  return a >= n8 ? a - n8 : a;
}

// The table entry at byte offset m8.
template <bool kShared>
__device__ __forceinline__ float2 entry(const float2* table,
                                        const float2* __restrict__ tw,
                                        int m8) {
  if (kShared) return *(const float2*)((const char*)table + m8);
  return __ldg((const float2*)((const char*)tw + m8));
}

template <int RT, bool kShared, bool kPow2>
__global__ void __launch_bounds__(kThreads, 2)
prach_demod_kernel(const float2* __restrict__ x, const PrachDemodParams p,
                   const float2* __restrict__ tw, float2* __restrict__ out) {
  extern __shared__ __align__(16) float2 table[];
  __shared__ float2 red[kWarps][RT * kBins];
  const int n_u = p.n_u, n8 = 8 * n_u;
  if (kShared) {      // all of the table's copies in flight at once
    for (int i = threadIdx.x; i < n_u; i += kThreads)
      __pipeline_memcpy_async(table + i, tw + i, sizeof(float2));
    __pipeline_commit();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * kBins;
  const int rows = p.ports * p.reps;
  const int row0 = blockIdx.y * RT;
  const float2* win[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = min(row0 + r, rows - 1);
    const int port = row / p.reps, rep = row - port * p.reps;
    win[r] = x + (size_t)port * p.row_stride + p.start + (size_t)rep * n_u;
  }
  const int nblocks = (n_u + 31) / 32;
  const int q0 = blockIdx.z * p.split_blocks + warp;
  const int q_end = min(nblocks, (blockIdx.z + 1) * p.split_blocks);
  // bin k0's table offset (bytes) at this warp's first block and its step
  // over kWarps blocks; bin k0 + j's is j * 32 q entries further (mod N_u)
  const long long b = ((long long)p.b0 + k0) % n_u;
  int m0 = 8 * (int)((b * 32 * q0) % n_u);
  const int step = 8 * (int)((b * 32 * kWarps) % n_u);
  float2 acc[RT][kBins];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int j = 0; j < kBins; ++j) acc[r][j] = make_float2(0.f, 0.f);
  // each iteration loads the next block's samples before it computes
  float2 next[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int n = q0 * 32 + lane;
    next[r] = q0 < q_end && n < n_u ? __ldg(win[r] + n)
                                    : make_float2(0.f, 0.f);
  }
  if (kShared) {
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  for (int q = q0; q < q_end; q += kWarps) {
    float2 v[RT];
    const int n = (q + kWarps) * 32 + lane;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      v[r] = next[r];
      next[r] = q + kWarps < q_end && n < n_u ? __ldg(win[r] + n)
                                              : make_float2(0.f, 0.f);
    }
    const int base = 256 * q;        // 8 (32 q): 32 q < N_u, the block start
    int m = m0;
#pragma unroll
    for (int j = 0; j < kBins; ++j) {
      const float2 w = entry<kShared>(table, tw, m);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        acc[r][j].x = fmaf(w.x, v[r].x, fmaf(-w.y, v[r].y, acc[r][j].x));
        acc[r][j].y = fmaf(w.x, v[r].y, fmaf(w.y, v[r].x, acc[r][j].y));
      }
      m = wrap_add<kPow2>(m, base, n8);
    }
    m0 = wrap_add<kPow2>(m0, step, n8);
  }
  // the lane's factor tw[b l], then the sums over the lanes
  constexpr int V = 2 * RT * kBins;
  float flat[V];
  const int lane8 = 8 * lane;
  int li = 8 * (int)((b * lane) % n_u);
#pragma unroll
  for (int j = 0; j < kBins; ++j) {
    const float2 f = entry<kShared>(table, tw, li);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float2 a = acc[r][j];
      flat[2 * (r * kBins + j)] = fmaf(a.x, f.x, -(a.y * f.y));
      flat[2 * (r * kBins + j) + 1] = fmaf(a.x, f.y, a.y * f.x);
    }
    li = wrap_add<false>(li, lane8 % n8, n8);
  }
  int slot = 0;
  scatter<V / 2, 16>(flat, lane, slot);
  // 64 / V lanes end with each element; the lowest of them writes it
  if ((lane & (64 / V - 1)) == 0)
    red[warp][slot / 2] = make_float2(flat[0], flat[1]);
  __syncthreads();
  if (threadIdx.x < RT * kBins) {
    const int e = threadIdx.x, r = e / kBins, j = e - r * kBins;
    float2 s = red[0][e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      s.x += red[w][e].x;
      s.y += red[w][e].y;
    }
    const int row = row0 + r, k = k0 + j;
    if (row < rows && k < p.l_ra)
      out[((size_t)blockIdx.z * rows + row) * p.l_ra + k] =
          make_float2(s.x * p.scale, s.y * p.scale);
  }
}

// out[i] = sum over the splits of part[s, i], in split order.
__global__ void prach_demod_sum(const float2* __restrict__ part, int splits,
                                int n, float2* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float2 s = part[i];
  for (int k = 1; k < splits; ++k) {
    s.x += part[(size_t)k * n + i].x;
    s.y += part[(size_t)k * n + i].y;
  }
  out[i] = s;
}

template <int RT, bool kPow2>
cudaError_t launch(const float2* x, const PrachDemodParams& p,
                   const float2* tw, float2* dst, cudaStream_t st) {
  const dim3 grid((p.l_ra + kBins - 1) / kBins,
                  (p.ports * p.reps + RT - 1) / RT, p.splits);
  if (p.n_u <= kSmemMax) {
    // the table and `red` pass the 48 KB a launch gets by default once
    // N_u > 5888
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        prach_demod_kernel<RT, true, kPow2>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemMax * (int)sizeof(float2));
    if (opt_in != cudaSuccess) return opt_in;
    prach_demod_kernel<RT, true, kPow2>
        <<<grid, kThreads, p.n_u * sizeof(float2), st>>>(x, p, tw, dst);
  } else {
    prach_demod_kernel<RT, false, kPow2><<<grid, kThreads, 0, st>>>(
        x, p, tw, dst);
  }
  return cudaGetLastError();
}

template <int RT>
cudaError_t launch_rows(const float2* x, const PrachDemodParams& p,
                        const float2* tw, float2* dst, cudaStream_t st) {
  return (p.n_u & (p.n_u - 1)) == 0 ? launch<RT, true>(x, p, tw, dst, st)
                                    : launch<RT, false>(x, p, tw, dst, st);
}

}  // namespace

// x complex64 [ports, row_stride]; out complex64 [ports, reps, L_ra];
// scratch complex64 [splits, ports, reps, L_ra] when splits > 1 (else
// unused); params the call signature's PrachDemodParams; tw complex64
// [N_u].
extern "C" int srsran_prach_demod(const void* x, void* out, void* scratch,
                                  void* stream, const void* params,
                                  const void* tw) {
  const PrachDemodParams* p = (const PrachDemodParams*)params;
  if (p->ports < 1 || p->reps < 1 || p->l_ra < 1 || p->n_u < 1 ||
      p->b0 < 0 || p->b0 >= p->n_u || p->n_u > (1 << 27) ||
      (p->rt != 1 && p->rt != 2 && p->rt != 4) ||
      p->splits < 1 || p->split_blocks < kWarps ||
      p->split_blocks % kWarps || (p->splits > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float2* dst = (float2*)(p->splits > 1 ? scratch : out);
  const float2* xs = (const float2*)x;
  const float2* t = (const float2*)tw;
  const cudaError_t err = p->rt == 4   ? launch_rows<4>(xs, *p, t, dst, st)
                          : p->rt == 2 ? launch_rows<2>(xs, *p, t, dst, st)
                                       : launch_rows<1>(xs, *p, t, dst, st);
  if (err != cudaSuccess) return (int)err;
  if (p->splits > 1) {
    const int n = p->ports * p->reps * p->l_ra;
    prach_demod_sum<<<(n + 255) / 256, 256, 0, st>>>(
        (const float2*)scratch, p->splits, n, (float2*)out);
  }
  return (int)cudaGetLastError();
}
