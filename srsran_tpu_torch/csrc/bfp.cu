// K23 and K24: block-floating-point IQ compression for the O-RAN
// U-plane, for Hopper.
//
// K23 srsran_bfp_compress replaces srsran_tpu/ofh/compression.py::
// bfp_compress (:26-51) and the host packer pack_section (:66-87), fused.
// Twin: srsran_tpu_torch/ofh/compression.py::compress_ref.  Per PRB (24
// reals, interleaved re/im):
//
//   v    = clamp(rint(x * 32767), -32768, 32767)      (half to even)
//   e    = max(32 - clz(max |v|) - (w - 1), 0)
//   mant = clamp(v >> e, -2^(w-1), 2^(w-1) - 1)        (arithmetic shift)
//
// and the payload record: 1 byte e & 0x0F, then the 24 mantissas MSB first
// as w-bit two's-complement fields (1 + 3w bytes).  exp and mant are
// written too when their pointers are not null.
//
// K24 srsran_bfp_decompress_sections replaces unpack_section (:90-105),
// bfp_decompress (:54-63) and the grid write of srsran_tpu/ru/ofh.py
// (:242-245), fused: each section (byte offset, port, symbol, start PRB,
// nof PRB, width) decodes its records and writes (float)(mant << e) /
// 32767 into the grid [ports, symbols, 12 nprb].  srsran_bfp_decompress
// is its (exp, mant) mode.  Twins: compression.py::decompress_sections_ref
// and bfp_decompress_ref.
//
// Bit-exactness with the JAX package: rintf (not roundf, which rounds half
// away from zero); the clamp to int16 before |v|; clz on the magnitude;
// the IEEE quotient by 32767 (below; the build passes no
// --use_fast_math).  Every width from 1 to 16 is taken.
//
// The quotient.  For a mantissa m of at most 16 bits and 0 <= e <= 15,
// m 2^e is exact in float32 and IEEE division commutes with scaling by a
// power of two (nothing here underflows or overflows), so
// IEEE(m 2^e / 32767) = IEEE(m / 32767) x 2^e, bit for bit; and
// IEEE(m / 32767) is q0 = m r, r = RN(1 / 32767) = 0x1.0002p-15, after
// one Newton step on the exact remainder m - 32767 q0 (two FMAs).
// tests/test_torch_bfp_plan.py checks both for every m in [-2^15, 2^15)
// and e in 0..15.  A value is then three rounded products and an exact
// multiply by 2^e, with no division, no table and no barrier.  A
// 2^w-entry table of quotients made by each CTA in shared memory (K35's
// trick, llr.cu) made K24 twice as slow a flagship launch (its fill, its
// CTA barrier and the lookups), and an IEEE division per value (w = 14)
// two and a half times (PERF.md, section 6).
//
// Design.  A warp takes a tile of up to 32 PRBs (kBfpTilePrbs) and a lane
// a PRB.  K23: the warp loads its PRBs' 96 B each as 16-byte vectors,
// lane l loading vectors l, l + 32, ... (512 contiguous bytes an
// instruction) into shared memory; lane l reads back its PRB, reduces its
// block maximum in registers, and writes its record's bytes (the width a
// template parameter: the packing unrolls to fixed shifts) into a staging
// row of 32 (1 + 3w) bytes -- a multiple of 16, so every tile of the
// payload starts 16-byte aligned -- which the warp stores as 16-byte
// vectors; (exp, mant) go out the same way.  K24: the host cuts every
// section into tiles of at most 32 PRBs (compression.py::_tiles), which
// ride in the launch's struct by value (up to kBfpMaxTiles a launch).  A
// warp loads its tile's n (1 + 3w) bytes -- at any byte offset -- as the
// aligned 16-byte chunks that cover them into shared memory, lane l
// extracts its record's 24 fields from two byte-swapped words by a funnel
// shift, and the tile's 96 n contiguous grid bytes are staged and stored
// as 16-byte vectors.  No section waits on
// another, no lane walks two PRBs, and no warp waits on another.
//
// Bound on this card: bytes.  At the flagship width (4 ports, 14 symbols,
// 273 PRB, w = 9: 15,288 PRBs) K23 reads 1,467,648 B and writes 428,064
// B: 0.566 us at 3.35 TB/s; K24 moves the same bytes the other way.  The
// arithmetic is a few integer operations per value.  The design before
// this one (a thread per PRB loading and storing at a 96 B stride, byte
// stores to device memory, a CTA per section, a division per value) took
// 6.42 us (K23) and 15.39 us (K24) a launch on an NVIDIA H100 80GB HBM3 at
// 700 W; PERF.md holds this design's times.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

constexpr int kBfpMaxTiles = 1024;      // tiles a K24 launch takes
constexpr int kBfpTilePrbs = 32;        // PRBs a tile (a warp)
constexpr int kBfpPrbBits = 22;         // a tile's flat PRB field

struct BfpCompressParams {
  int nblocks, width;
};

// A K24 tile: its first record's byte offset in the buffer, and its first
// PRB in the flat grid [ports x symbols x nprb] | (n - 1) << 22 |
// (width - 1) << 27.
struct BfpTile {
  int start, word;
};

struct BfpSectionsParams {
  int ntiles, buf_len;
  BfpTile tiles[kBfpMaxTiles];
};

struct BfpExpandParams {
  int nblocks;
};

namespace {

constexpr int kValues = 24;               // reals per PRB
constexpr int kVectors = kValues / 4;     // 16-byte vectors per PRB
constexpr float kScale = 32767.0f;
constexpr int kCompressWarps = 2;
constexpr int kUnpackWarps = 4;
constexpr int kMaxRecord = 1 + 3 * 16;
// a tile's records at any byte offset, in 16-byte chunks, and one spare
// word for the second word of the last field
constexpr int kUnpackChunks = (15 + kBfpTilePrbs * kMaxRecord + 15) / 16 + 1;
constexpr int kExpandPrbs = 64;           // (exp, mant) mode: PRBs a CTA

__device__ __forceinline__ int to_fixed(float x) {
  const float r = rintf(x * kScale);
  return (int)fminf(fmaxf(r, -32768.0f), 32767.0f);
}

__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((127 + e) << 23);
}

// (float)(mant << e) / 32767 as the twin computes it
__device__ __forceinline__ float expand(int mant, int e) {
  return (float)(int)((unsigned)mant << e) / kScale;
}

// IEEE(m / 32767) for -2^15 <= m < 2^15, by the remainder's Newton step
__device__ __forceinline__ float quotient(int m) {
  constexpr float r = 0x1.0002p-15f;          // RN(1 / 32767)
  const float x = (float)m;
  const float q0 = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q0, kScale, x), r, q0);
}

template <int W>
__global__ void __launch_bounds__(32 * kCompressWarps)
bfp_compress_kernel(const float4* __restrict__ iq,
                    uint8_t* __restrict__ exp_out,
                    int4* __restrict__ mant_out,
                    uint8_t* __restrict__ payload,
                    const __grid_constant__ BfpCompressParams p) {
  constexpr int R = 1 + 3 * W;
  __shared__ float4 stage[kCompressWarps][kBfpTilePrbs * kVectors];
  __shared__ __align__(16) uint8_t packed[kCompressWarps]
                                         [kBfpTilePrbs * kMaxRecord];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long prb0 =
      ((long long)blockIdx.x * kCompressWarps + warp) * kBfpTilePrbs;
  if (prb0 >= p.nblocks) return;
  const int n = (int)min((long long)kBfpTilePrbs, p.nblocks - prb0);
  const int nv = kVectors * n;
  const float4* src = iq + prb0 * kVectors;
  float4* st = stage[warp];
  float4 in[kVectors];
#pragma unroll
  for (int k = 0; k < kVectors; ++k) {
    const int j = lane + 32 * k;
    in[k] = j < nv ? __ldg(src + j) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < kVectors; ++k)
    if (lane + 32 * k < nv) st[lane + 32 * k] = in[k];
  __syncwarp();
  if (lane < n) {
    int v[kValues];
    int m = 0;
#pragma unroll
    for (int k = 0; k < kVectors; ++k) {
      const float4 c = st[kVectors * lane + k];
      v[4 * k] = to_fixed(c.x);
      v[4 * k + 1] = to_fixed(c.y);
      v[4 * k + 2] = to_fixed(c.z);
      v[4 * k + 3] = to_fixed(c.w);
#pragma unroll
      for (int i = 4 * k; i < 4 * k + 4; ++i) m = max(m, abs(v[i]));
    }
    const int e = max(32 - __clz(m) - (W - 1), 0);
    constexpr int hi = (1 << (W - 1)) - 1;
    constexpr unsigned mask = (1u << W) - 1u;
#pragma unroll
    for (int i = 0; i < kValues; ++i) v[i] = min(max(v[i] >> e, -hi - 1), hi);
    if (mant_out) {
      int4* ms = reinterpret_cast<int4*>(st) + kVectors * lane;
#pragma unroll
      for (int k = 0; k < kVectors; ++k)
        ms[k] = make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    }
    if (exp_out) exp_out[prb0 + lane] = (uint8_t)e;
    uint8_t* rec = packed[warp] + lane * R;
    rec[0] = (uint8_t)(e & 0x0F);
    unsigned acc = 0;
    int nacc = 0, pos = 1;
#pragma unroll
    for (int i = 0; i < kValues; ++i) {
      acc = (acc << W) | ((unsigned)v[i] & mask);
      nacc += W;
#pragma unroll
      for (int b = 0; b < 2; ++b)
        if (nacc >= 8) {
          nacc -= 8;
          rec[pos++] = (uint8_t)(acc >> nacc);
        }
    }
  }
  __syncwarp();
  // the tile's n R payload bytes start at prb0 R, a multiple of 16
  const int nbytes = n * R;
  uint8_t* dst = payload + prb0 * R;
  const uint4* pk = reinterpret_cast<const uint4*>(packed[warp]);
  for (int c = lane; c < nbytes / 16; c += 32)
    reinterpret_cast<uint4*>(dst)[c] = pk[c];
  for (int b = (nbytes & ~15) + lane; b < nbytes; b += 32)
    dst[b] = packed[warp][b];
  if (mant_out) {
    int4* md = mant_out + prb0 * kVectors;
    const int4* ms = reinterpret_cast<const int4*>(st);
    for (int c = lane; c < nv; c += 32) md[c] = ms[c];
  }
}

// The 16 bytes at addr, those outside [lo, hi) as zeros.
__device__ __forceinline__ uint4 edge_chunk(uintptr_t addr, uintptr_t lo,
                                            uintptr_t hi) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uintptr_t a = addr + j;
    if (a >= lo && a < hi)
      w[j >> 2] |= (unsigned)*reinterpret_cast<const uint8_t*>(a)
                   << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ unsigned big_endian(unsigned w) {
  return __byte_perm(w, 0u, 0x0123);
}

__global__ void __launch_bounds__(32 * kUnpackWarps)
bfp_decompress_sections_kernel(const uint8_t* __restrict__ buf,
                               float4* __restrict__ grid,
                               const __grid_constant__ BfpSectionsParams p) {
  __shared__ uint4 stage[kUnpackWarps][kUnpackChunks];
  __shared__ float4 out[kUnpackWarps][kBfpTilePrbs * kVectors];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * kUnpackWarps + warp;
  if (t >= p.ntiles) return;
  const BfpTile tile = p.tiles[t];
  const int prb = tile.word & ((1 << kBfpPrbBits) - 1);
  const int n = ((tile.word >> kBfpPrbBits) & 31) + 1;
  const int width = ((tile.word >> (kBfpPrbBits + 5)) & 15) + 1;
  const int R = 1 + 3 * width;
  // the tile's bytes [base, base + n R) as the aligned chunks covering
  // them; a chunk that reaches outside the buffer is read byte by byte
  const uintptr_t lo = (uintptr_t)buf, hi = lo + (unsigned)p.buf_len;
  const uintptr_t base = lo + (unsigned)tile.start;
  const uintptr_t first = base & ~(uintptr_t)15;
  const int off0 = (int)(base - first);
  const int nch = (off0 + n * R + 15) >> 4;
  uint4 c[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uintptr_t a = first + 16 * (uintptr_t)(lane + 32 * k);
    if (lane + 32 * k < nch)
      c[k] = a >= lo && a + 16 <= hi
                 ? __ldg(reinterpret_cast<const uint4*>(a))
                 : edge_chunk(a, lo, hi);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (lane + 32 * k < nch) stage[warp][lane + 32 * k] = c[k];
  __syncwarp();
  if (lane < n) {
    const unsigned* s = reinterpret_cast<const unsigned*>(stage[warp]);
    const int b = off0 + lane * R;
    float v[kValues];
    const int e = (s[b >> 2] >> (8 * (b & 3))) & 0x0F;
    const float scale = pow2(e);
    int bit = 8 * b + 8;
#pragma unroll
    for (int i = 0; i < kValues; ++i, bit += width) {
      const int q = bit >> 5;
      const unsigned x = __funnelshift_l(big_endian(s[q + 1]),
                                         big_endian(s[q]), bit & 31);
      const int m = (int)x >> (32 - width);     // the field, sign-extended
      v[i] = __fmul_rn(quotient(m), scale);
    }
    float4* o = out[warp] + kVectors * lane;
#pragma unroll
    for (int k = 0; k < kVectors; ++k)
      o[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  }
  __syncwarp();
  float4* g = grid + (size_t)prb * kVectors;
  for (int j = lane; j < kVectors * n; j += 32) g[j] = out[warp][j];
}

// (exp, mant) mode: threadIdx.x a 16-byte vector of PRB threadIdx.y; a
// value outside the quotient's range (|mant| > 2^15 or e > 15, which no
// record holds) takes the twin's division.
__global__ void __launch_bounds__(kVectors * kExpandPrbs)
bfp_decompress_kernel(const uint8_t* __restrict__ exp,
                      const int4* __restrict__ mant,
                      float4* __restrict__ out,
                      const __grid_constant__ BfpExpandParams p) {
  const long long b = (long long)blockIdx.x * kExpandPrbs + threadIdx.y;
  if (b >= p.nblocks) return;
  const long long j = b * kVectors + threadIdx.x;
  const int4 m = __ldg(mant + j);
  const int e = __ldg(exp + b);
  const float scale = pow2(min(e, 15));
  const int mv[4] = {m.x, m.y, m.z, m.w};
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = e <= 15 && mv[i] >= -32768 && mv[i] < 32768
               ? __fmul_rn(quotient(mv[i]), scale)
               : expand(mv[i], e);
  out[j] = make_float4(f[0], f[1], f[2], f[3]);
}

template <int W>
void launch_compress(const BfpCompressParams& p, const void* iq, void* exp,
                     void* mant, void* payload, cudaStream_t stream) {
  const long long warps = (p.nblocks + kBfpTilePrbs - 1LL) / kBfpTilePrbs;
  const int blocks = (int)((warps + kCompressWarps - 1) / kCompressWarps);
  bfp_compress_kernel<W><<<blocks, 32 * kCompressWarps, 0, stream>>>(
      (const float4*)iq, (uint8_t*)exp, (int4*)mant, (uint8_t*)payload, p);
}

template <int... W>
void dispatch_compress(std::integer_sequence<int, W...>,
                       const BfpCompressParams& p, const void* iq, void* exp,
                       void* mant, void* payload, cudaStream_t stream) {
  using Fn = void (*)(const BfpCompressParams&, const void*, void*, void*,
                      void*, cudaStream_t);
  constexpr Fn forms[] = {launch_compress<W + 1>...};
  forms[p.width - 1](p, iq, exp, mant, payload, stream);
}

}  // namespace

// iq: complex64 [nblocks x 12], 16-byte aligned; exp uint8 [nblocks] and
// mant int32 [nblocks, 24] (both or neither null), payload uint8
// [nblocks, 1 + 3 width], all 16-byte aligned.
extern "C" int srsran_bfp_compress(const void* iq, void* exp_out,
                                   void* mant_out, void* payload,
                                   void* stream, const void* params) {
  const BfpCompressParams* p = (const BfpCompressParams*)params;
  if (p->nblocks < 1 || p->width < 1 || p->width > 16)
    return (int)cudaErrorInvalidValue;
  dispatch_compress(std::make_integer_sequence<int, 16>{}, *p, iq, exp_out,
                    mant_out, payload, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// buf: the sections' records (any alignment); grid: complex64 [ports,
// symbols, 12 nprb], 16-byte aligned, written at the tiles' PRBs only.
extern "C" int srsran_bfp_decompress_sections(const void* buf, void* grid,
                                              void* stream,
                                              const void* params) {
  const BfpSectionsParams* p = (const BfpSectionsParams*)params;
  if (p->ntiles < 1 || p->ntiles > kBfpMaxTiles || p->buf_len < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (p->ntiles + kUnpackWarps - 1) / kUnpackWarps;
  bfp_decompress_sections_kernel<<<blocks, 32 * kUnpackWarps, 0,
                                   (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (float4*)grid, *p);
  return (int)cudaGetLastError();
}

// exp uint8 [nblocks], mant int32 [nblocks, 24] and out complex64
// [nblocks x 12], mant and out 16-byte aligned.
extern "C" int srsran_bfp_decompress(const void* exp, const void* mant,
                                     void* out, void* stream,
                                     const void* params) {
  const BfpExpandParams* p = (const BfpExpandParams*)params;
  if (p->nblocks < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((p->nblocks + kExpandPrbs - 1LL) / kExpandPrbs);
  bfp_decompress_kernel<<<blocks, dim3(kVectors, kExpandPrbs), 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)exp, (const int4*)mant, (float4*)out, *p);
  return (int)cudaGetLastError();
}
