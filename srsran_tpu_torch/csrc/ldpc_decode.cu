// K1: layered normalized min-sum LDPC decoder with CRC early stop, for Hopper.
//
// Replaces srsran_tpu/ops/ldpc_decode.py::decode_early_stop (:112-155), whose
// layer update is _make_sweep (:47-72), and its CRC predicate ops/crc.py::
// crc_check.  Twin: srsran_tpu_torch/ops/ldpc_decode.py::decode_early_stop_ref.
//
// Design.  One CTA per codeblock, one thread per lifted lane j < Z.  The
// LLRs of the columns the decoded rows touch (the "live" columns: 22 + rows
// at BG1, 10 + rows at BG2; 32 of 68 at the flagship's 10 layers, 104 KB
// at 46) live in dynamic shared memory; rows run in order inside the CTA
// with the cyclic shifts as index arithmetic ((j + s) mod Z).  Within one
// row every (edge, lane) owns a distinct LLR, so lanes need no atomics.
//  * The edge tables go by value in the launch's parameter struct
//    (__grid_constant__): per edge an int2, the byte offset of (column,
//    shift) and the first lane that wraps, one 8-byte constant-bank load at
//    a uniform address; no row reads a table from global memory.
//  * A row is a template over its degree (up to 19), unrolled: each thread
//    reads its D LLRs once, keeps t = LLR - old message in registers, finds
//    min1 and min2 by fminf / fmaxf and the signs, and the write pass only
//    stores.  Messages are +-(0.8 * magnitude), the sign as a bit.
//  * A barrier follows a row only when the next row shares a column with
//    a row since the last one (the host's mask; rows 16.. of BG1 pair up):
//    the rows between two barriers touch disjoint LLRs.
//  * c2v stays in global memory (L2: 7.8 MB at 37 codeblocks and 46 rows)
//    in compressed form per (row, lane): min1, min2 (unscaled magnitudes)
//    and one word with the argmin edge (bits 24..28) and the per-edge output
//    signs (bits 0..23); the old message of edge e is rebuilt as 0.8 * (+-(e
//    == argmin ? min2 : min1)), the very value that was added when it was
//    written.  A thread loads row r + 2's words while it works on row r.
//    The first sweep reads no c2v (it is zero), so c2v needs no clearing.
//  * The columns no row touches go from the caller's LLRs straight to the
//    output, soft and hard, once; the live columns in 16-byte loads and
//    stores.
//
// Early stop without a host sync, the JAX package's all-CBs rule kept per
// slot as jax.vmap keeps each slot's while-loop state: a slot whose CBs all
// pass stops, and its LLRs and count stay as a run of that slot alone
// leaves them, on the device.  A CTA's CRC of its first k' hard bits is the
// XOR of the host remainder words of its set bits.  Two launch forms:
//  * ldpc_decode_kernel, every sweep in one launch, while the launch holds
//    at most half the SMs (the flagship's 37 codeblocks): the LLRs stay in
//    shared memory across the sweeps; after each sweep a CTA counts a CRC
//    failure into its slot's word for that sweep, arrives on the slot's
//    counter, waits for the slot's other CTAs (all resident: one CTA an SM,
//    and room for a second such launch beside it) and stops with the slot.
//  * ldpc_sweep_kernel, a launch per sweep for larger batches (built for two
//    CTAs an SM, 80 registers: a batch may outnumber the SMs): a CTA reads
//    its slot's "done" first and returns when it is set; it ends its sweep
//    by counting a failure and arriving, and the slot's last CTA to arrive
//    counts the sweep, sets "done" when none failed and clears the counters.
// One cudaMemsetAsync clears the state [slots, 4 + sweeps].
//
// Bounds on this card: the row loop: a row's latency chain (table loads,
// shared-memory round trips, the min chain, the barrier) and issue (about
// 25 instructions per edge and lane), one CTA per codeblock (37 of 132 SMs
// at the flagship).  Arithmetic is written with __fsub_rn / __fmul_rn /
// __fadd_rn (and the library builds with --fmad=false) so the hard
// decisions match the PyTorch twin bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kLdpcMaxRows = 46;
constexpr int kLdpcMaxEdges = 316;
constexpr int kLdpcMaxDegree = 19;

// The plan's launch (by address; the kernels take it by value).
struct LdpcDecodeParams {
  int nb;                 // codeblocks, all slots
  int cbs_per_slot;
  int nslots;
  int nrows;              // decoded rows (layers)
  int ncols;              // NV
  int live;               // columns the decoded rows touch: [0, live)
  int z;
  int threads;            // z rounded up to a warp
  int single;             // 2 nb <= SMs: every sweep in one launch
  int stride;             // state ints a slot: 4 + sweeps
  int k_prime;            // CRC'd hard bits; 0: no CRC (a fixed count)
  int sweeps;             // max_iter
  float scaling;
  unsigned long long sync;  // bit r: a barrier after row r
  unsigned short row_ptr[kLdpcMaxRows + 1];
  int2 edge[kLdpcMaxEdges];  // byte offset of (col, shift): 4 (col z + s);
                             // the wrap lane: z - s
};

namespace {

constexpr int kThreads = 384;          // Z <= 384

__device__ __forceinline__ float& at(float* sh, int byte_offset) {
  return *reinterpret_cast<float*>(reinterpret_cast<char*>(sh) + byte_offset);
}

// One row of degree D for lane j: reads, min-sum, writes; (o1, o2, om) in
// is the row's stored c2v, out its new one.  Messages are built as +-(0.8 *
// magnitude) with the sign as a bit: the same bits as 0.8 * (+-m) (IEEE
// multiplication rounds symmetrically), two multiplies a row.
template <int D>
__device__ __forceinline__ void row_update(float* __restrict__ sh,
                                           const LdpcDecodeParams& p, int e0,
                                           int j, float& o1, float& o2,
                                           uint32_t& om) {
  const int z4 = 4 * p.z, j4 = 4 * j;
  const float sc = p.scaling;
  const int oidx = (int)(om >> 24);
  const uint32_t so1 = __float_as_uint(__fmul_rn(sc, o1));
  const uint32_t so2 = __float_as_uint(__fmul_rn(sc, o2));
  int pos[D];                           // byte offsets in sh
  float t[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {         // lane j reads lane (j + s) mod z
    const int2 ed = p.edge[e0 + k];
    pos[k] = ed.x + j4 - (j >= ed.y ? z4 : 0);
  }
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const uint32_t old = ((k == oidx) ? so2 : so1) ^ ((om << (31 - k)) &
                                                    0x80000000u);
    t[k] = __fsub_rn(at(sh, pos[k]), __uint_as_float(old));
  }
  float m1 = __int_as_float(0x7f800000), m2 = m1;
  int idx = 0;
  uint32_t neg = 0;
#pragma unroll
  for (int k = 0; k < D; ++k) {        // the first minimum, the second
    const float a = fabsf(t[k]);
    if (a < m1) idx = k;
    m2 = fminf(m2, fmaxf(m1, a));
    m1 = fminf(m1, a);
    if (t[k] < 0.f) neg |= 1u << k;
  }
  const uint32_t esgn = ((__popc(neg) & 1) ? ~neg : neg) & ((1u << D) - 1u);
  const uint32_t sm1 = __float_as_uint(__fmul_rn(sc, m1));
  const uint32_t sm2 = __float_as_uint(__fmul_rn(sc, m2));
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const uint32_t nw = ((k == idx) ? sm2 : sm1) ^ ((esgn << (31 - k)) &
                                                   0x80000000u);
    at(sh, pos[k]) = __fadd_rn(t[k], __uint_as_float(nw));
  }
  o1 = m1;
  o2 = m2;
  om = ((uint32_t)idx << 24) | esgn;
}

__device__ __forceinline__ void row_dispatch(int deg, float* sh,
                                             const LdpcDecodeParams& p,
                                             int e0, int j, float& o1,
                                             float& o2, uint32_t& om) {
  switch (deg) {
#define LDPC_ROW(D) \
  case D: row_update<D>(sh, p, e0, j, o1, o2, om); break;
    LDPC_ROW(1) LDPC_ROW(2) LDPC_ROW(3) LDPC_ROW(4) LDPC_ROW(5) LDPC_ROW(6)
    LDPC_ROW(7) LDPC_ROW(8) LDPC_ROW(9) LDPC_ROW(10) LDPC_ROW(11)
    LDPC_ROW(12) LDPC_ROW(13) LDPC_ROW(14) LDPC_ROW(15) LDPC_ROW(16)
    LDPC_ROW(17) LDPC_ROW(18) LDPC_ROW(19)
#undef LDPC_ROW
    default: break;
  }
}

__device__ __forceinline__ char4 hard4(float4 v) {
  return make_char4(v.x < 0.f, v.y < 0.f, v.z < 0.f, v.w < 0.f);
}

// [lo, hi) floats of src to dst (and, when bits is set, their hard bits),
// float4 where vec (kCopyUnroll loads in flight a thread), the rest one a
// thread.  lo is a multiple of 4.
constexpr int kCrcLoads = 22;          // k' <= 22 Z <= 22 threads

template <int kCopyUnroll>
__device__ __forceinline__ void copy_span(const float* __restrict__ src,
                                          float* __restrict__ dst,
                                          int8_t* __restrict__ bits, int lo,
                                          int hi, bool vec) {
  const int v0 = vec ? lo / 4 : 0, v1 = vec ? hi / 4 : 0;
  const int nth = blockDim.x;
  for (int i0 = v0 + threadIdx.x; i0 < v1; i0 += kCopyUnroll * nth) {
    float4 v[kCopyUnroll];
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u)
      if (i0 + u * nth < v1)
        v[u] = reinterpret_cast<const float4*>(src)[i0 + u * nth];
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      const int i = i0 + u * nth;
      if (i < v1) {
        reinterpret_cast<float4*>(dst)[i] = v[u];
        if (bits) reinterpret_cast<char4*>(bits)[i] = hard4(v[u]);
      }
    }
  }
  for (int i = (vec ? 4 * v1 : lo) + threadIdx.x; i < hi; i += nth) {
    const float v = src[i];
    dst[i] = v;
    if (bits) bits[i] = v < 0.f ? 1 : 0;
  }
}

// The rows of one sweep over the CTA's live LLRs in sh, c2v read back from
// global memory after the first sweep (warm); ends with a barrier.
__device__ __forceinline__ void sweep_rows(const LdpcDecodeParams& p,
                                           float* sh, float* c2v, int cb,
                                           bool warm) {
  const int z = p.z, nrows = p.nrows;
  const int j = threadIdx.x;
  const bool lane = j < z;
  const size_t plane = (size_t)p.nb * nrows * z;
  float* m1s = c2v;
  float* m2s = c2v + plane;
  uint32_t* metas = reinterpret_cast<uint32_t*>(c2v + 2 * plane);
  const size_t base = (size_t)cb * nrows * z + j;
  float c1 = 0.f, c2 = 0.f, n1 = 0.f, n2 = 0.f;
  uint32_t cm = 0, nm = 0;
  if (warm && lane) {
    c1 = m1s[base];
    c2 = m2s[base];
    cm = metas[base];
    if (nrows > 1) {
      n1 = m1s[base + z];
      n2 = m2s[base + z];
      nm = metas[base + z];
    }
  }
  __syncthreads();

  for (int r = 0; r < nrows; ++r) {
    if (lane) {
      float f1 = 0.f, f2 = 0.f;
      uint32_t fm = 0;
      if (warm && r + 2 < nrows) {         // row r + 2's c2v, ahead
        const size_t at = base + (size_t)(r + 2) * z;
        f1 = m1s[at];
        f2 = m2s[at];
        fm = metas[at];
      }
      const int e0 = p.row_ptr[r];
      row_dispatch(p.row_ptr[r + 1] - e0, sh, p, e0, j, c1, c2, cm);
      const size_t at = base + (size_t)r * z;
      m1s[at] = c1;
      m2s[at] = c2;
      metas[at] = cm;
      c1 = n1;
      c2 = n2;
      cm = nm;
      n1 = f1;
      n2 = f2;
      nm = fm;
    }
    // rows between two barriers touch disjoint columns (the host's sync
    // mask, whose last bit is set): their lanes run on without waiting
    if ((p.sync >> r) & 1ull) __syncthreads();
  }
}

// This thread's share of the CRC of the first k' hard bits: the XOR of the
// host remainder words (w, loaded by load_crc) of its bits that are set.
__device__ __forceinline__ void load_crc(const LdpcDecodeParams& p,
                                         const uint32_t* __restrict__ rows,
                                         uint32_t* w) {
#pragma unroll
  for (int u = 0; u < kCrcLoads; ++u) {
    const int i = threadIdx.x + u * blockDim.x;
    w[u] = i < p.k_prime ? rows[i] : 0u;
  }
}

__device__ __forceinline__ uint32_t crc_part(const LdpcDecodeParams& p,
                                             const float* sh,
                                             const uint32_t* w) {
  uint32_t acc = 0;
#pragma unroll
  for (int u = 0; u < kCrcLoads; ++u) {
    const int i = threadIdx.x + u * blockDim.x;
    if (i < p.k_prime && sh[i] < 0.f) acc ^= w[u];
  }
  return acc;
}

// The block's XOR of acc, in thread 0.
__device__ __forceinline__ uint32_t block_xor(uint32_t acc,
                                              uint32_t* warp_acc) {
  for (int off = 16; off > 0; off >>= 1)
    acc ^= __shfl_xor_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_acc[threadIdx.x >> 5] = acc;
  __syncthreads();
  uint32_t t = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t ^= warp_acc[w];
  return t;
}

// One sweep over every row.  in: the caller's LLRs (read by sweep 0 only);
// llr, bits: the output; c2v: min1 [nb, nrows, z], min2, meta after it;
// state [nslots, stride]: done, sweeps, arrived, failed.  Built for two
// CTAs an SM (80 registers): a batch may hold more codeblocks than SMs.
__global__ void __launch_bounds__(kThreads, 2)
ldpc_sweep_kernel(const __grid_constant__ LdpcDecodeParams p,
                  const float* __restrict__ in, float* __restrict__ llr,
                  int8_t* __restrict__ bits, float* __restrict__ c2v,
                  int* __restrict__ state,
                  const uint32_t* __restrict__ crc_rows, int sweep, int vec) {
  const int cb = blockIdx.x;
  int* st = state + p.stride * (cb / p.cbs_per_slot);
  if (st[0]) return;          // an earlier sweep passed every CRC of the slot
  extern __shared__ float sh[];
  __shared__ uint32_t warp_acc[kThreads / 32];
  const size_t n = (size_t)p.ncols * p.z;
  const int nlive = p.live * p.z;
  float* g = llr + cb * n;
  int8_t* b = bits + cb * n;
  if (sweep == 0) {
    const float* src = in + cb * n;
    copy_span<4>(src, sh, nullptr, 0, nlive, vec);
    copy_span<4>(src, g, b, nlive & ~3, (int)n, vec);   // untouched columns
  } else {
    copy_span<4>(g, sh, nullptr, 0, nlive, vec);
  }
  sweep_rows(p, sh, c2v, cb, sweep > 0);

  // The live columns back, soft and hard; then the CRC.
  copy_span<4>(sh, g, b, 0, nlive, vec);
  if (p.k_prime == 0) return;
  uint32_t w[kCrcLoads];
  load_crc(p, crc_rows, w);
  const uint32_t t = block_xor(crc_part(p, sh, w), warp_acc);
  if (threadIdx.x == 0) {
    if (t != 0u) atomicAdd(st + 3, 1);
    __threadfence();
    if (atomicAdd(st + 2, 1) == p.cbs_per_slot - 1) {   // the slot's last
      __threadfence();
      const int failed = atomicAdd(st + 3, 0);
      st[1] += 1;
      if (failed == 0) st[0] = 1;
      st[2] = 0;
      st[3] = 0;
    }
  }
}

// Every sweep in one launch, the LLRs in shared memory throughout: after
// each sweep a CTA counts its CRC failure into its slot's word for that
// sweep and arrives on the slot's counter, thread 0 waits for the slot's
// other CTAs (every CTA of the launch is resident: the host takes this
// path only while the launch holds at most half the SMs, one CTA each),
// and the slot stops when none failed.  state [nslots, stride]: arrived
// (counting up over the sweeps), sweeps, -, -, failures of sweep s at 4 +
// s.
__global__ void __launch_bounds__(kThreads, 1)
ldpc_decode_kernel(const __grid_constant__ LdpcDecodeParams p,
                   const float* __restrict__ in, float* __restrict__ llr,
                   int8_t* __restrict__ bits, float* __restrict__ c2v,
                   int* __restrict__ state,
                   const uint32_t* __restrict__ crc_rows, int vec) {
  const int cb = blockIdx.x;
  int* st = state + p.stride * (cb / p.cbs_per_slot);
  extern __shared__ float sh[];
  __shared__ uint32_t warp_acc[kThreads / 32];
  __shared__ int done;
  const size_t n = (size_t)p.ncols * p.z;
  const int nlive = p.live * p.z;
  float* g = llr + cb * n;
  int8_t* b = bits + cb * n;
  const float* src = in + cb * n;
  copy_span<8>(src, sh, nullptr, 0, nlive, vec);
  copy_span<8>(src, g, b, nlive & ~3, (int)n, vec);   // untouched columns
  uint32_t w[kCrcLoads];
  load_crc(p, crc_rows, w);
  int sweeps = 0;
  for (int s = 0; s < p.sweeps; ++s) {
    sweep_rows(p, sh, c2v, cb, s > 0);
    ++sweeps;
    if (p.k_prime == 0) continue;
    const uint32_t t = block_xor(crc_part(p, sh, w), warp_acc);
    if (threadIdx.x == 0) {
      if (t != 0u) atomicAdd(st + 4 + s, 1);
      __threadfence();
      atomicAdd(st, 1);
      const int all = p.cbs_per_slot * (s + 1);
      while (atomicAdd(st, 0) < all) __nanosleep(32);
      __threadfence();
      done = atomicAdd(st + 4 + s, 0) == 0;
    }
    __syncthreads();
    if (done) break;
  }
  copy_span<8>(sh, g, b, 0, nlive, vec);
  if (threadIdx.x == 0 && cb % p.cbs_per_slot == 0) st[1] = sweeps;
}

bool valid(const LdpcDecodeParams* p) {
  if (p->nrows <= 0 || p->nrows > kLdpcMaxRows) return false;
  for (int r = 0; r < p->nrows; ++r)
    if (p->row_ptr[r + 1] - p->row_ptr[r] < 1 ||
        p->row_ptr[r + 1] - p->row_ptr[r] > kLdpcMaxDegree)
      return false;
  if (p->z <= 0) return false;
  for (int e = 0; e < p->row_ptr[p->nrows] && e < kLdpcMaxEdges; ++e)
  {
    const int off = p->edge[e].x / 4;
    if (p->edge[e].x < 0 || p->edge[e].x % 4 || off / p->z >= p->live ||
        p->edge[e].y != p->z - off % p->z)
      return false;
  }
  return p->nb > 0 && p->cbs_per_slot > 0 && p->nslots > 0 &&
         p->nb == p->cbs_per_slot * p->nslots && p->z <= kThreads &&
         p->live > 0 && p->live <= p->ncols &&
         p->threads == (p->z + 31) / 32 * 32 &&
         p->sweeps > 0 && ((p->sync >> (p->nrows - 1)) & 1ull) &&
         p->stride == 4 + p->sweeps &&
         p->row_ptr[p->nrows] <= kLdpcMaxEdges && p->k_prime >= 0 &&
         p->k_prime <= p->live * p->z &&
         p->k_prime <= kCrcLoads * p->threads;
}

}  // namespace

// in, llr f32 [nb, ncols * z]; bits int8 [nb, ncols * z]; scratch int32
// [stride * nslots + 3 * nb * nrows * z] (the state, then the c2v);
// crc_rows uint32 [k_prime] (unread when k_prime is 0).
extern "C" int srsran_ldpc_decode(void* in, void* llr, void* bits,
                                  void* scratch, void* stream,
                                  const void* params, const void* crc_rows) {
  const LdpcDecodeParams* p = (const LdpcDecodeParams*)params;
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)p->live * p->z * sizeof(float);
  // Raised once per size, outside any stream capture after the first call:
  // a CUDA graph captures the launches of a warmed-up program only.
  static size_t smem_set = 0;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ldpc_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ldpc_decode_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  int* state = (int*)scratch;
  cudaError_t err = cudaMemsetAsync(
      state, 0, sizeof(int) * (size_t)p->stride * p->nslots, st);
  if (err != cudaSuccess) return (int)err;
  float* c2v = (float*)(state + p->stride * p->nslots);
  const int vec = (((uintptr_t)in | (uintptr_t)llr | (uintptr_t)bits) & 15) == 0
                  && (p->ncols * p->z) % 4 == 0;
  if (p->single) {
    ldpc_decode_kernel<<<p->nb, p->threads, smem, st>>>(
        *p, (const float*)in, (float*)llr, (int8_t*)bits, c2v, state,
        (const uint32_t*)crc_rows, vec);
    return (int)cudaGetLastError();
  }
  for (int s = 0; s < p->sweeps; ++s) {
    ldpc_sweep_kernel<<<p->nb, p->threads, smem, st>>>(
        *p, (const float*)in, (float*)llr, (int8_t*)bits, c2v, state,
        (const uint32_t*)crc_rows, s, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
