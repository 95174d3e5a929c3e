// K9: PRACH preamble detection for Hopper, one launch a call.
//
// Replaces srsran_tpu/phy/upper/prach.py::detect (:177-246): correlate the
// frequency-domain capture [P, S, L] with the conjugate of every root
// sequence, pack the two halves of the L bins into an N-point IDFT input
// (zeros elsewhere), transform, sum the delay power |x|^2 over ports and
// symbols, and for every preamble its circular search window, the local
// noise reference, the per-bin metric, the first maximum, the metric times
// the window, the timing advance and the threshold decision; the RSSI of
// the capture.  Twin: srsran_tpu_torch/phy/upper/prach.py::detect_ref.
//
// What bounds it.  Operations: at the flagship B4 (P 4, S 12, R 10 roots,
// N 1024) 480 transforms of 1024 points, about 25 MFLOP, some 0.4 us at the
// card's float32 rate; the capture and the roots are 60 KB.  The former
// design wrote the zero-padded IDFT input [P, S, R, N] to device memory
// (3.9 MB for 139 non-zero bins a row), ran cuFFT on it, read it back for
// the power and launched a detection pass: four activities and ~16 MB of
// traffic for a function whose data fit in shared memory.  What is left is
// latency: a row's transform is ~1,500 dependent-ish instructions, and the
// phases after it (the cluster's sum, the detection) are a few hundred
// cycles each.
//
// Design.  One launch a call, no cuFFT, no IDFT buffer, no scratch.  A
// thread-block cluster of C = 1, 2, 4 or 8 CTAs per (slot, root), 8 warps a
// CTA, one CTA an SM; the root's P S rows are dealt out a warp each (row q
// to CTA q / 8 mod C), C halved while the launch would not fit the SMs in
// one wave.  Every load of the set-up goes in flight at once by cp.async
// (the warp's first row and the root into shared memory, the tables, the
// root's window starts).  A warp transforms its row by a four-step split
// N = V x 32 (V = N / 32):
//   1. lane t forms its column x[32 n1 + t] = rx * conj(root) at the packed
//      bins, zero elsewhere (never loaded);
//   2. N <= 1024: the column's V-point radix-2 decimation in frequency in
//      registers (its twiddles the same word for every lane), register m
//      holding output k1 = rev(m); a form pruned at compile time to L_RA
//      139's six live rows of 32 at N 1024 (rows 0-2 and 29-31) skips the
//      butterflies of zeros.  N 2048 and 4096: a direct DFT over the
//      column's non-zero rows only (a host table), 32 outputs at a time;
//   3. the twiddle w_N^(t k1) (a host table [V, 32]), a transpose through
//      the warp's shared buffer (rows padded to 33 words), and the 32-point
//      decimation in registers over t: lane k1 holds X[k1 + V rev5(m)];
//   4. |X|^2 added into the lane's 32 power registers.
// Root 0's cluster also sums each row's |rx|^2 (hypot, as the twin's abs)
// for the slot's RSSI.  The warps' powers meet in shared memory in warp
// order, scaled by 1 / N (the twin's |ifft * sqrt(N)|^2), and go to this
// CTA's slot of the leader's shared memory (distributed shared memory);
// after one cluster barrier the leader sums the slots in rank order (no
// float atomics: a run repeats bit for bit) and detects the root's
// preambles, a warp each: the circular reference over [start - margin,
// start + win + margin) in a fixed-order shuffle tree, the metric per bin
// with its 1e-12 floor, the FIRST maximum over the search bins (ties to
// the lower bin), metric x win, TA = bin / (N scs) and the threshold; root
// 0's leader sums the rows' energies in row order for the RSSI.  A slot
// axis is the grid's third dimension.  N is a power of two from 256 to 4096
// (the wrapper refuses any other).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kPrachThreads = 256;
constexpr int kPrachWarps = kPrachThreads / 32;
constexpr int kPrachMaxCtas = 8;   // a portable cluster
constexpr int kPad = 33;           // a transpose row, complex words
constexpr int kPrachMaxRootPreambles = 64;
constexpr int kPrachMaxRows = 128;   // P S
constexpr unsigned kFull = 0xffffffffu;

// The launch, by value (srsran_tpu_torch/kernels/_build.py
// PrachDetectParams).
struct PrachDetectParams {
  int B;          // slots
  int rows;       // P S: the IDFT rows of a root
  int L;          // L_RA
  int half;       // (L + 1) / 2: the low half's bins
  int N;          // IDFT points
  int V;          // N / 32
  int roots;      // roots with preambles (the grid's second dimension)
  int npre;       // preambles
  int nz;         // non-zero input rows n1 of the split (<= 32)
  int live;       // their mask (V <= 32; bit n1), read as unsigned
  int C;          // CTAs a (slot, root)
  int win, margin, search;
  int nrx;        // P S L: a slot's capture
  int smem;       // dynamic shared memory a CTA, bytes
  float threshold, span, inv_n;
  int off_tw, off_wv, off_w32;       // complex table: roots [R, L] at 0
  int off_geom, off_range;           // int table: n1 rows at 0, rev5 at nz
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, a.y * b.y), fmaf(a.y, b.x, -a.x * b.y));
}

// acc + a * b
__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 acc) {
  return make_float2(fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x)),
                     fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y)));
}

// The cluster barrier in two halves (every thread of every CTA calls
// both, in turn): arrive publishes this thread's earlier writes (shared,
// distributed shared and device memory), wait returns once every thread
// has arrived and sees theirs.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// m's low `bits` bits reversed (at compile time in the unrolled loops).
__host__ __device__ constexpr int rev_bits(int m, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((m >> b) & 1) << (bits - 1 - b);
  return r;
}

__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v / 2);
}

// The entries that may be non-zero after a radix-2 stage of half-size S
// whose input may be non-zero at the bits of `live` (an entry is, where it
// or its partner was).
__host__ __device__ constexpr unsigned dif_live(unsigned live, int S) {
  unsigned out = 0;
  for (int i = 0; i < 32; ++i) {
    const int partner = (i / S) % 2 == 0 ? i + S : i - S;
    if (((live >> i) & 1) || (partner < 32 && ((live >> partner) & 1)))
      out |= 1u << i;
  }
  return out;
}

// d w_{2S}^j, w_{2S}^j = w_32^m (m = 16 j / S) from w32[m] = e^{2 pi i m /
// 32}; 1 and i need no product.
__device__ __forceinline__ float2 twiddle(float2 d, int m,
                                          const float2* __restrict__ w32) {
  return m == 0 ? d : m == 8 ? make_float2(-d.y, d.x) : cmul(d, w32[m]);
}

// One radix-2 stage of half-size S of an M-point decimation in frequency
// (inverse sign).  LIVE: the entries that may be non-zero (known at
// compile time); a butterfly of two zeros is skipped, one of a zero is
// half a butterfly.
template <int M, int S, unsigned LIVE>
__device__ __forceinline__ void dif_stage(float2 (&y)[M],
                                          const float2* __restrict__ w32) {
#pragma unroll
  for (int base = 0; base < M; base += 2 * S) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const bool la = (LIVE >> (base + j)) & 1;
      const bool lc = (LIVE >> (base + j + S)) & 1;
      const int m = j * (16 / S);
      const float2 a = y[base + j], c = y[base + j + S];
      if (la && lc) {
        y[base + j] = make_float2(a.x + c.x, a.y + c.y);
        y[base + j + S] = twiddle(make_float2(a.x - c.x, a.y - c.y), m, w32);
      } else if (la) {
        y[base + j + S] = twiddle(a, m, w32);
      } else if (lc) {
        y[base + j] = c;
        y[base + j + S] = twiddle(make_float2(-c.x, -c.y), m, w32);
      }
    }
  }
}

// The M-point inverse DFT in place (M = 8, 16, 32), radix-2 decimation in
// frequency: natural order in, y[m] = X[rev(m)] out (log2 M bits); LIVE:
// the inputs that may be non-zero.
template <int M, unsigned LIVE = ~0u>
__device__ __forceinline__ void idft(float2 (&y)[M],
                                     const float2* __restrict__ w32) {
  constexpr unsigned L16 = M >= 32 ? dif_live(LIVE, 16) : LIVE;
  constexpr unsigned L8 = M >= 16 ? dif_live(L16, 8) : L16;
  constexpr unsigned L4 = dif_live(L8, 4);
  constexpr unsigned L2 = dif_live(L4, 2);
  if constexpr (M >= 32) dif_stage<M, 16, LIVE>(y, w32);
  if constexpr (M >= 16) dif_stage<M, 8, L16>(y, w32);
  dif_stage<M, 4, L8>(y, w32);
  dif_stage<M, 2, L4>(y, w32);
  dif_stage<M, 1, L2>(y, w32);
}

// Fixed-order warp sum (shuffle-down tree), lane 0's value to every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return __shfl_sync(kFull, v, 0);
}

// The dynamic shared memory (prach.py::_detect_smem): complex tw [N], wv
// [V], w32 [16], the root [L], the warps' buffers [8][32][33] (a row's
// capture, then its transpose); float the cluster's powers [C][N] and the
// rows' energies [128] (the leader's are read); int the root's window
// starts [64], rows [nz] and rev5 [32].
struct Smem {
  float2 *tw, *wv, *w32, *root, *buf;
  float *pw, *rowe;
  int *starts, *n1s, *rev;
  __device__ Smem(unsigned char* base, int N, int V, int L, int C, int nz) {
    tw = (float2*)base;
    wv = tw + N;
    w32 = wv + V;
    root = w32 + 16;
    buf = root + L;
    pw = (float*)(buf + kPrachWarps * 32 * kPad);
    rowe = pw + C * N;
    starts = (int*)(rowe + kPrachMaxRows);
    n1s = starts + kPrachMaxRootPreambles;
    rev = n1s + nz;
  }
};

// Asynchronous copies of 8 and 4 bytes into shared memory (no register
// staging), waited for all at once.
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// A warp's copy of its row's capture [L] into its buffer.
__device__ __forceinline__ void stage_row(float2* wb,
                                          const float2* __restrict__ row,
                                          int L, int lane) {
  for (int i = lane; i < L; i += 32) cp_async8(wb + i, row + i);
}

// A row's energy sum |rx|^2 (|.| as hypot, as the twin's abs) in a fixed
// order: lane-strided partial sums, then a shuffle tree; lane 0 stores it.
__device__ __forceinline__ void row_energy(const float2* row, int L, int lane,
                                           float* dst) {
  float e = 0.f;
  for (int i = lane; i < L; i += 32) {
    const float m = hypotf(row[i].x, row[i].y);
    e += m * m;
  }
  e = warp_sum(e);
  if (lane == 0) *dst = e;
}

// Lane t's column (x[32 n1 + t], n1 < V) of the row staged in wb: the
// correlation rx * conj(root) at the packed bins, zero elsewhere; rows n1
// outside LIVE are zero at compile time (the pruned first pass).
template <int V, unsigned LIVE>
__device__ __forceinline__ void column(float2 (&y)[V], const float2* wb,
                                       const float2* root, int N, int L,
                                       int half, int lane) {
  const int high = N - (L - half);
#pragma unroll
  for (int n1 = 0; n1 < V; ++n1) {
    const int n = 32 * n1 + lane;
    const int bin = n < half ? n : n - (N - L);
    y[n1] = ((LIVE >> n1) & 1) && (n < half || n >= high)
                ? cmul_conj(wb[bin], root[bin])
                : make_float2(0.f, 0.f);
  }
}

template <int V, unsigned LIVE>
__global__ void __launch_bounds__(kPrachThreads, 1)
    prach_detect_kernel(const float2* __restrict__ rx, float* __restrict__ out,
                        uint8_t* __restrict__ detected,
                        const __grid_constant__ PrachDetectParams p,
                        const float2* __restrict__ ctab,
                        const int* __restrict__ itab) {
  constexpr bool kFft = V <= 32;          // else the chunked direct DFT
  constexpr int KB = kFft ? V : 32;       // outputs k1 a pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm(smem_raw, p.N, p.V, p.L, p.C, p.nz);
  cluster_arrive();                       // this CTA has started
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ra = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int root = itab[p.off_range + 3 * ra];
  const int p0 = itab[p.off_range + 3 * ra + 1];
  const int np = itab[p.off_range + 3 * ra + 2];
  const float2* rxs = rx + (size_t)b * p.nrx;
  const float2* rt = ctab + (size_t)root * p.L;
  const int q0 = rank * kPrachWarps + warp, dq = p.C * kPrachWarps;
  float2* wb = sm.buf + warp * 32 * kPad;
  // Every load of the set-up in flight at once: the first row, the root,
  // the tables, the root's window starts.
  if (kFft && q0 < p.rows) stage_row(wb, rxs + (size_t)q0 * p.L, p.L, lane);
  for (int i = tid; i < p.L; i += kPrachThreads) cp_async8(sm.root + i, rt + i);
  for (int i = tid; i < p.N; i += kPrachThreads)
    cp_async8(sm.tw + i, ctab + p.off_tw + i);
  for (int i = tid; i < p.V; i += kPrachThreads)
    cp_async8(sm.wv + i, ctab + p.off_wv + i);
  if (tid < 16) cp_async8(sm.w32 + tid, ctab + p.off_w32 + tid);
  for (int i = tid; i < p.nz + 32; i += kPrachThreads)
    cp_async4(sm.n1s + i, itab + i);
  if (rank == 0)
    for (int k = tid; k < np; k += kPrachThreads)
      cp_async4(sm.starts + k, itab + p.off_geom + 2 * (p0 + k) + 1);
  cp_async_wait();
  __syncthreads();
  float2 y[KB];

  float* wf = reinterpret_cast<float*>(wb);
  // this CTA's slot of the leader's powers
  float* slot = nullptr;
  for (int c = 0; c < p.V / KB; ++c) {
    float pw[32];
#pragma unroll
    for (int m = 0; m < 32; ++m) pw[m] = 0.f;
    for (int q = q0; q < p.rows; q += dq) {
      const float2* row = rxs + (size_t)q * p.L;
      if constexpr (kFft) {
        // the column's V-point DFT in registers, then the twiddle; k1 =
        // rev(m) to the transpose
        if (q != q0) {
          stage_row(wb, row, p.L, lane);
          cp_async_wait();
          __syncwarp();
        }
        if (ra == 0) row_energy(wb, p.L, lane, sm.rowe + q);
        column<V, LIVE>(y, wb, sm.root, p.N, p.L, p.half, lane);
        idft<V, LIVE>(y, sm.w32);
        __syncwarp();
#pragma unroll
        for (int m = 0; m < V; ++m) {
          constexpr int bits = log2i(V);
          const int k1 = rev_bits(m, bits);
          wb[lane * kPad + k1] = cmul(y[m], sm.tw[k1 * 32 + lane]);
        }
      } else {
        // the column's direct DFT over its non-zero rows, KB outputs at a
        // time, staged inputs first
        if (ra == 0 && c == 0) row_energy(row, p.L, lane, sm.rowe + q);
        const int high = p.N - (p.L - p.half);
        __syncwarp();
        for (int j = 0; j < p.nz; ++j) {
          const int n = 32 * sm.n1s[j] + lane;
          float2 v = make_float2(0.f, 0.f);
          if (n < p.half) {
            v = cmul_conj(row[n], rt[n]);
          } else if (n >= high) {
            const int bin = n - (p.N - p.L);
            v = cmul_conj(row[bin], rt[bin]);
          }
          wb[j * kPad + lane] = v;
        }
#pragma unroll
        for (int i = 0; i < KB; ++i) y[i] = make_float2(0.f, 0.f);
        for (int j = 0; j < p.nz; ++j) {
          const float2 x = wb[j * kPad + lane];
          const int n1 = sm.n1s[j];
#pragma unroll
          for (int i = 0; i < KB; ++i)
            y[i] = cfma(x, sm.wv[(n1 * (c * KB + i)) & (p.V - 1)], y[i]);
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < KB; ++i)
          wb[lane * kPad + i] = cmul(y[i], sm.tw[(c * KB + i) * 32 + lane]);
      }
      __syncwarp();
      if (lane < KB) {                    // the 32-point stage over the lanes
        float2 z[32];
#pragma unroll
        for (int m = 0; m < 32; ++m) z[m] = wb[m * kPad + lane];
        idft<32>(z, sm.w32);
#pragma unroll
        for (int m = 0; m < 32; ++m)      // the power
          pw[m] += fmaf(z[m].x, z[m].x, z[m].y * z[m].y);
      }
      __syncwarp();
    }
    // The warps' powers in warp order, into this CTA's slot of the
    // leader's shared memory (distributed shared memory but for rank 0).
    __syncwarp();
#pragma unroll
    for (int m = 0; m < 32; ++m) wf[m * 32 + lane] = pw[m];
    __syncthreads();
    if (c == 0) {
      cluster_wait();                     // every CTA has started
      slot = cluster.map_shared_rank(sm.pw, 0) + rank * p.N;
      if (ra == 0) {                      // this CTA's rows' energies
        float* rowe = cluster.map_shared_rank(sm.rowe, 0);
        for (int q = tid; q < p.rows; q += kPrachThreads)
          if ((q / kPrachWarps) % p.C == rank) rowe[q] = sm.rowe[q];
      }
    }
    for (int e = tid; e < 32 * KB; e += kPrachThreads) {
      const int m = e / KB, t = e - m * KB;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kPrachWarps; ++w)
        s += reinterpret_cast<const float*>(sm.buf + w * 32 * kPad)[m * 32 + t];
      slot[c * KB + t + p.V * sm.rev[m]] = s * p.inv_n;
    }
    __syncthreads();
  }
  cluster_arrive();                       // the slots are written
  cluster_wait();

  float* metrics = out + (size_t)b * p.npre;
  float* ta = out + (size_t)(p.B + b) * p.npre;
  if (rank == 0) {                        // the root's preambles
    for (int i = tid; i < p.N; i += kPrachThreads) {
      float v[kPrachMaxCtas];
#pragma unroll
      for (int k = 0; k < kPrachMaxCtas; ++k)
        v[k] = k < p.C ? sm.pw[k * p.N + i] : 0.f;
      float s = v[0];
#pragma unroll
      for (int k = 1; k < kPrachMaxCtas; ++k)
        if (k < p.C) s += v[k];
      sm.pw[i] = s;
    }
    __syncthreads();
    const int reg = p.win + 2 * p.margin, mask = p.N - 1;
    for (int k = warp; k < np; k += kPrachWarps) {
      const int pre = p0 + k;
      const int start = sm.starts[k];
      float ref = 0.f;
#pragma unroll 4
      for (int j = lane; j < reg; j += 32)
        ref += sm.pw[(start - p.margin + j) & mask];
      ref = warp_sum(ref);
      float best = -1.f;
      int bi = 0x7fffffff;
#pragma unroll 4
      for (int j = lane; j < p.search; j += 32) {
        const float seg = sm.pw[(start + j) & mask];
        const float m = __fdiv_rn(seg, fmaxf(ref - seg, 1e-12f));
        if (m > best) {
          best = m;
          bi = j;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_down_sync(kFull, best, o);
        const int oi = __shfl_down_sync(kFull, bi, o);
        if (ov > best || (ov == best && oi < bi)) {
          best = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        const float m = best * (float)p.win;
        metrics[pre] = m;
        ta[pre] = __fdiv_rn((float)bi, p.span);
        detected[(size_t)b * p.npre + pre] = m > p.threshold;
      }
    }
  }
  if (ra == 0 && rank == 0 && warp == kPrachWarps - 1) {   // the RSSI
    float e = 0.f;
    for (int q = lane; q < p.rows; q += 32) e += sm.rowe[q];
    e = warp_sum(e);
    if (lane == 0) out[(size_t)2 * p.npre * p.B + b] = e / (float)p.nrx;
  }
}

using KernelFn = void (*)(const float2*, float*, uint8_t*,
                          const PrachDetectParams, const float2*, const int*);

// The pruned form: L_RA 139 at N 1024 (rows 0-2 and 29-31 hold bins).
constexpr unsigned kLive139 = 0xE0000007u;

inline KernelFn kernel_for(int V, unsigned live) {
  switch (V) {
    case 8: return prach_detect_kernel<8, ~0u>;
    case 16: return prach_detect_kernel<16, ~0u>;
    case 32: return live == kLive139 ? prach_detect_kernel<32, kLive139>
                                     : prach_detect_kernel<32, ~0u>;
    case 64: return prach_detect_kernel<64, ~0u>;
    default: return prach_detect_kernel<128, ~0u>;
  }
}

inline bool params_ok(const PrachDetectParams& p) {
  const int N = p.N;
  return p.B >= 1 && p.rows >= 1 && p.L >= 1 && p.half >= 1 &&
         p.half <= p.L && N >= 256 && N <= 4096 && !(N & (N - 1)) &&
         N >= p.L && p.V * 32 == N && p.roots >= 1 && p.npre >= 1 &&
         p.nz >= 1 && p.nz <= 32 && p.C >= 1 && p.C <= kPrachMaxCtas &&
         p.win >= 1 && p.margin >= 0 && p.win + 2 * p.margin <= N &&
         p.search >= 1 && p.search <= p.win && p.nrx == p.rows * p.L &&
         p.rows <= kPrachMaxRows &&
         p.smem > 0;
}

}  // namespace

// Lets every form of the kernel take up to `bytes` of dynamic shared
// memory on the current device (the wrapper calls it once per device,
// before any capture).
extern "C" int srsran_prach_prepare(int bytes) {
  const int sizes[] = {8, 16, 32, 64, 128};
  for (int V : sizes) {
    const unsigned lives[] = {~0u, kLive139};
    for (unsigned live : lives) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel_for(V, live), cudaFuncAttributeMaxDynamicSharedMemorySize,
          bytes);
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

// rx complex64 [B, P, S, L]; out float [B (2 npre + 1)]: metrics [B,
// npre], ta [B, npre], rssi [B]; detected bool [B, npre]; params
// a PrachDetectParams; ctab complex64: roots [R, L], tw [V, 32] (w_N^(t
// k1) at k1 * 32 + t), wv [V] (w_V^m), w32 [16] (w_32^m); itab int32: the
// non-zero rows n1 [nz], rev5 [32], per preamble (root, window start)
// [npre, 2], per launched root (root, first preamble, count) [roots, 3].
extern "C" int srsran_prach_detect(void* rx, void* out, void* detected,
                                   void* stream, const void* params,
                                   const void* ctab, const void* itab) {
  const PrachDetectParams* p = (const PrachDetectParams*)params;
  if (!params_ok(*p)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p->C, p->roots, p->B);
  cfg.blockDim = dim3(kPrachThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)p->smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p->C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel_for(p->V, (unsigned)p->live), (const float2*)rx,
      (float*)out, (uint8_t*)detected, *p, (const float2*)ctab,
      (const int*)itab);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
