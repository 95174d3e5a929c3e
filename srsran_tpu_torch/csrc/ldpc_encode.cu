// K5: DL-SCH encode -- TB CRC, segmentation with CB CRC, LDPC encode -- for
// Hopper.
//
// Replaces srsran_tpu/ops/ldpc_encode.py::encode (:56-122) and the two CRCs
// of srsran_tpu/phy/upper/pdsch.py::encode_transport_block (:157-183): the
// TB CRC24A (or CRC16) and the per-codeblock CRC24B of ops/crc.py::crc
// (:57).  Twin: srsran_tpu_torch/ops/ldpc_encode.py::dlsch_encode_ref.
// Output: the encoded codeblocks without the 2Z punctured systematic bits,
// int8 [C, N] (one bit per byte), the layout K6 (csrc/pdsch_map.cu) reads.
//
// Design: one launch, one CTA per (codeblock, slot), every column of Z bits
// packed 32 to a word in shared memory (nw = ceil(Z / 32) words and a pad
// word a column).
//  * Pack: the codeblock's TB bytes come into shared memory in 16-byte
//    loads (one round trip), then a warp packs each column word's 32 bytes
//    by __ballot_sync; the TB's bits are read once.
//  * CRCs on packed words: the CRC is linear, and the bits of a word at
//    message position s weigh x^(n - 32 - s + L) times its bit-reversed
//    value p, so a word's share of the remainder is p(x) x^e mod G, taken a
//    byte at a time against four host words x^(e + 8k) mod G
//    (ops/ldpc_encode.py::_crc_word_tables; a shift for the word that runs
//    past the message): four independent 8-step carry-less products, 16
//    table bytes per 32 message bits (brought in by cp.async), not a table
//    word per set bit.  The CB CRC24B and this codeblock's share of the TB
//    CRC are two such sums per word and one block XOR; the TB shares meet
//    by atomicXor in a word per slot, each CTA then arrives on its slot's
//    counter.  The CTAs whose codeblock holds TB CRC bits (the last one, or
//    two) wait for every CTA of their slot to arrive -- each arrives before
//    any long work and never waits itself, so the wait ends -- insert the
//    TB CRC and add its bits' share to the CB CRC; then the CB CRC goes in.
//  * Encode on packed words: a circulant shift of a column is a rotate of
//    its nw words by funnel shifts, wrapping at Z (any lifting size of TS
//    38.212 Table 5.3.2-1; below 32 a rotate inside one word), and a row's
//    parity word the XOR of its edges' rotated words, 32 bits per
//    operation: the four core-row sums over the info columns (8 lanes a
//    word, a shuffle XOR), then on one warp p0 from their XOR (one surviving
//    cyclic shift) and p1..p3 by the host schedule of the double-diagonal
//    back-substitution (the order the twin solves them in), then every
//    extension row over info and core columns.  The edge tables and the
//    core schedule go by value in the launch's struct.
//  * Unpack: columns 2.. to bytes, 16 a thread into one 16-byte store when
//    Z is a multiple of 16.
//
// A slot axis (the slot-batch mode): grid dimension y is the slot, each with
// its own TB, TB CRC word and counter and [C, N] output.  One
// cudaMemsetAsync clears the slots' words.
//
// Bounds on this card: bytes (the TB once, 835,584 B at the flagship, and
// C x N output bytes, 2.5 MB) against latency: a CTA's phases are short
// and separated by barriers, and the holder of the TB CRC waits for the
// slowest CTA's share; 100 CTAs at the flagship on 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kEncMaxRows = 46;
constexpr int kEncMaxEdges = 316;
constexpr int kEncCoreInts = 28;

// The plan's launch (by address; the kernel takes it by value).
struct DlschEncodeParams {
  int tbs;                // TB bits
  int tb_crc_len;         // 24 or 16
  int cb_crc_len;         // 24 or 0 (one codeblock)
  int ppc;                // payload bits per codeblock (K' - L_cb)
  int kb, z, nw;          // info columns, lifting size, words a column
  int ncols, nrows;
  int ncb, nslots;
  int threads;
  unsigned int tb_poly, cb_poly;     // with the x^L term
  int core[kEncCoreInts];            // ops/ldpc_encode.py::_core_schedule
  unsigned short row_ptr[kEncMaxRows + 1];
  unsigned int edge[kEncMaxEdges];   // col * (nw + 1) | shift << 16
};

namespace {

constexpr int kThreads = 512;
constexpr int kCoreParts = 8;          // lanes a core-row word
constexpr int kCoreEdges = 3;          // 19 edges over 8 lanes
constexpr int kExtEdges = 10;          // an extension row's largest degree
constexpr int kMaxWords = 22 * 12;     // info columns x words a column

// (b(x) * a(x)) mod G for a byte b, a of degree below L, G the L + 1 bits
// of poly: Horner over b's bits from the top, unrolled, without branches.
__device__ __forceinline__ uint32_t mulmod8(uint32_t b, uint32_t a, int L,
                                            uint32_t poly) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 7; i >= 0; --i) {
    r = (r << 1) ^ ((r >> (L - 1)) & 1u ? poly : 0u);
    r ^= ((b >> i) & 1u) ? a : 0u;
  }
  return r;
}

// A word's share of a CRC: its bit-reversed value p (bit b of the word is
// message bit s + b) times x^e mod G, byte k of p by the table's word k =
// x^(e + 8k) mod G (word 0's bits 24..31: the right shift of the word that
// runs past the message): four independent chains of 8 steps.
__device__ __forceinline__ uint32_t crc_share(uint32_t word, uint4 tab, int L,
                                              uint32_t poly) {
  const uint32_t p = __brev(word) >> (tab.x >> 24);
  return mulmod8(p & 0xffu, tab.x & 0xffffffu, L, poly) ^
         mulmod8((p >> 8) & 0xffu, tab.y, L, poly) ^
         mulmod8((p >> 16) & 0xffu, tab.z, L, poly) ^
         mulmod8(p >> 24, tab.w, L, poly);
}

// Word w of a column rotated by s: bit b = column bit (32w + b + s) mod z.
__device__ __forceinline__ uint32_t rot(const uint32_t* col, int z, int w,
                                        int s) {
  if (z < 32) {
    const uint32_t mask = (1u << z) - 1u;
    const uint32_t v = col[0] & mask;
    return s ? ((v >> s) | (v << (z - s))) & mask : v;
  }
  int p0 = 32 * w + s;
  if (p0 >= z) p0 -= z;
  const int q = p0 >> 5;
  const uint32_t v = __funnelshift_r(col[q], col[q + 1], p0 & 31);
  const int m = z - p0;              // bits before the wrap
  const uint32_t keep = m < 32 ? (1u << (m & 31)) - 1u : 0xffffffffu;
  return (v & keep) | (m < 32 ? col[0] << (m & 31) : 0u);
}

// The XOR of a and of b over the block (warp_acc: 2 words a warp).
__device__ __forceinline__ uint2 block_xor2(uint32_t a, uint32_t b,
                                            uint2* warp_acc) {
  for (int off = 16; off > 0; off >>= 1) {
    a ^= __shfl_xor_sync(0xffffffffu, a, off);
    b ^= __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                   // warp_acc free from an earlier use
  if (lane == 0) warp_acc[warp] = make_uint2(a, b);
  __syncthreads();
  uint2 t = make_uint2(0, 0);
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    t.x ^= warp_acc[w].x;
    t.y ^= warp_acc[w].y;
  }
  return t;
}

__device__ __forceinline__ void set_bit(uint32_t* cols, int ws, int z, int i) {
  const int c = i / z, j = i - c * z;
  atomicOr(cols + c * ws + (j >> 5), 1u << (j & 31));
}

// 16 bytes global -> shared without registers (completion: wait_all).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Four bits to four bytes of 0/1.
__device__ __forceinline__ uint32_t bytes4(uint32_t v) {
  return ((v & 0xfu) * 0x00204081u) & 0x01010101u;
}

// Where the staged TB bytes start in the dynamic shared memory, in words
// (16-byte aligned, after the columns and the core sums).
__host__ __device__ __forceinline__ int stage_words(
    const DlschEncodeParams& p) {
  return ((p.ncols + 4) * (p.nw + 1) + 3) & ~3;
}

// scratch [2, nslots]: the slots' TB CRC words, then their counters.
__global__ void __launch_bounds__(kThreads)
dlsch_encode_kernel(const __grid_constant__ DlschEncodeParams p,
                    const int8_t* __restrict__ tb, int8_t* __restrict__ out,
                    uint32_t* __restrict__ scratch,
                    const uint4* __restrict__ cb_tab,
                    const uint4* __restrict__ tb_tab, int vec) {
  extern __shared__ uint32_t sh[];   // [ncols + 4][ws], then the TB bytes
  __shared__ uint2 warp_acc[kThreads / 32];
  __shared__ uint32_t tb_crc_word;
  const int cb = blockIdx.x, slot = blockIdx.y;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  const int z = p.z, nw = p.nw, ws = nw + 1, kb = p.kb;
  uint32_t* cols = sh;
  uint32_t* cs = sh + p.ncols * ws;
  tb += (size_t)slot * p.tbs;
  const long long cb0 = (long long)cb * p.ppc;     // first TB position

  // This thread's CRC table words (kb * nw <= threads) into shared memory
  // without registers, in flight while the TB bytes come in.
  __shared__ uint4 tabs[2][kMaxWords];
  if (tid < kb * nw) {
    cp_async16(&tabs[0][tid], cb_tab + tid);
    cp_async16(&tabs[1][tid], tb_tab + (size_t)cb * kb * nw + tid);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // The codeblock's TB bytes into shared memory, 16 at a load, laid out at
  // their global address's alignment (byte i at stage[off + i]).
  const int nbytes = (int)max(0LL, min((long long)p.ppc, p.tbs - cb0));
  const int8_t* src = tb + (nbytes ? cb0 : 0);
  const int off = (int)((uintptr_t)src & 15);
  uint8_t* stage = reinterpret_cast<uint8_t*>(sh + stage_words(p));
  const int head = min(nbytes, (16 - off) & 15);
  const int nvec = (nbytes - head) / 16;
  for (int v = tid; v < nvec; v += nth)
    reinterpret_cast<uint4*>(stage + off + head)[v] =
        reinterpret_cast<const uint4*>(src + head)[v];
  for (int i = tid; i < head; i += nth) stage[off + i] = (uint8_t)src[i];
  for (int i = head + 16 * nvec + tid; i < nbytes; i += nth)
    stage[off + i] = (uint8_t)src[i];
  for (int i = tid; i < (p.ncols + 4) * ws; i += nth)
    if (i >= kb * ws || i % ws == nw) sh[i] = 0u;
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // Pack the info columns (TB bits only; CRC bits and fillers 0): a warp
  // a column, a ballot a word.
  for (int c = warp; c < kb; c += nwarps) {
#pragma unroll 4
    for (int w = 0; w < nw; ++w) {
      const int j = 32 * w + lane, i = c * z + j;
      const int bit = (j < z && i < nbytes) ? stage[off + i] & 1 : 0;
      const uint32_t word = __ballot_sync(0xffffffffu, bit);
      if (lane == 0) cols[c * ws + w] = word;
    }
  }
  __syncthreads();

  // Both CRCs' shares of this codeblock's TB bits.
  uint32_t cb_acc = 0, tb_acc = 0;
  const int ltb = p.tb_crc_len;
  if (tid < kb * nw) {
    const uint32_t word = cols[(tid / nw) * ws + tid % nw];
    if (p.cb_crc_len) cb_acc = crc_share(word, tabs[0][tid], 24, p.cb_poly);
    tb_acc = crc_share(word, tabs[1][tid], ltb, p.tb_poly);
  }
  {
    const uint2 both = block_xor2(tb_acc, cb_acc, warp_acc);
    tb_acc = both.x;
    cb_acc = both.y;
  }
  uint32_t* tb_crc = scratch + slot;
  int* arrived = reinterpret_cast<int*>(scratch + p.nslots) + slot;
  if (tid == 0) {
    if (tb_acc) atomicXor(tb_crc, tb_acc);
    __threadfence();
    atomicAdd(arrived, 1);
  }

  // The TB CRC, where this codeblock holds some of its bits.
  const long long crc0 = (long long)p.tbs;
  const bool holds = cb0 < crc0 + ltb && cb0 + p.ppc > crc0;
  if (holds) {
    if (tid == 0) {
      while (atomicAdd(arrived, 0) < p.ncb) __nanosleep(64);
      __threadfence();
      tb_crc_word = atomicXor(tb_crc, 0u);
    }
    __syncthreads();
    uint32_t extra = 0;
    if (tid < ltb) {
      const long long g = crc0 + tid;
      if (g >= cb0 && g < cb0 + p.ppc &&
          ((tb_crc_word >> (ltb - 1 - tid)) & 1u)) {
        const int i = (int)(g - cb0);
        set_bit(cols, ws, z, i);
        const int c = i / z, j = i - c * z;
        if (p.cb_crc_len)
          extra = crc_share(1u << (j & 31), tabs[0][c * nw + (j >> 5)], 24,
                            p.cb_poly);
      }
    }
    cb_acc ^= block_xor2(extra, 0u, warp_acc).x;
  }
  if (p.cb_crc_len && tid < p.cb_crc_len && ((cb_acc >> (23 - tid)) & 1u))
    set_bit(cols, ws, z, p.ppc + tid);
  __syncthreads();

  // Core rows 0..3 over the info columns: kCoreParts lanes a (row, word),
  // each XORing every kCoreParts-th edge, then a shuffle XOR.
  if (tid < 4 * nw * kCoreParts) {     // whole groups of lanes (nw <= 12)
    const int item = tid / kCoreParts, part = tid % kCoreParts;
    const int r = item / nw, w = item - r * nw;
    const int e0 = p.row_ptr[r], e1 = p.row_ptr[r + 1];
    uint32_t a = 0;
#pragma unroll
    for (int k = 0; k < kCoreEdges; ++k) {   // all loads issued, then masked
      const int e = e0 + part + k * kCoreParts;
      const unsigned int ed = p.edge[min(e, e1 - 1)];
      const int off = (int)(ed & 0xffffu);
      const uint32_t v = rot(cols + off, z, w, (int)(ed >> 16));
      a ^= (e < e1 && off < kb * ws) ? v : 0u;
    }
#pragma unroll
    for (int m = kCoreParts / 2; m > 0; m >>= 1)
      a ^= __shfl_xor_sync(0xffffffffu, a, m);
    if (part == 0) cs[r * ws + w] = a;
  }
  __syncthreads();

  // p0 = roll(sum of the core rows, s0) (a rotate by z - s0), then p1..p3,
  // each step solving one core row for its one unknown column: nw <= 12
  // words a column, so one warp, ordered by __syncwarp.
  if (warp == 0) {
    const int s0 = p.core[0] ? z - p.core[0] : 0;
    for (int w = lane; w < nw; w += 32)
      cols[kb * ws + w] = rot(cs, z, w, s0) ^ rot(cs + ws, z, w, s0) ^
                          rot(cs + 2 * ws, z, w, s0) ^
                          rot(cs + 3 * ws, z, w, s0);
    __syncwarp();
    for (int st = 0; st < 3; ++st) {
      const int* step = p.core + 1 + 9 * st;
      const int r = step[0], target = step[1], nterms = step[2];
      for (int w = lane; w < nw; w += 32) {
        uint32_t a = cs[r * ws + w];
        for (int t = 0; t < nterms; ++t)
          a ^= rot(cols + step[3 + 2 * t] * ws, z, w, step[4 + 2 * t]);
        cols[target * ws + w] = a;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // Extension rows: parity column kb + r from the info and core columns.
  for (int idx = tid; idx < (p.nrows - 4) * nw; idx += nth) {
    const int r = 4 + idx / nw, w = idx - (r - 4) * nw;
    const int e0 = p.row_ptr[r], e1 = p.row_ptr[r + 1];
    uint32_t a = 0;
#pragma unroll
    for (int k = 0; k < kExtEdges; ++k) {    // all loads issued, then masked
      const unsigned int ed = p.edge[min(e0 + k, e1 - 1)];
      const int off = (int)(ed & 0xffffu);
      const uint32_t v = rot(cols + off, z, w, (int)(ed >> 16));
      a ^= (e0 + k < e1 && off < (kb + 4) * ws) ? v : 0u;
    }
    cols[(kb + r) * ws + w] = a;
  }
  __syncthreads();

  // Columns 2.. out, one bit a byte.
  const int n = (p.ncols - 2) * z;
  int8_t* o = out + ((size_t)slot * p.ncb + cb) * n;
  if (vec) {                           // z % 16 == 0, o 16-byte aligned
    for (int i = tid; i < n / 16; i += nth) {
      const int c = (16 * i) / z, j = 16 * i - c * z;
      const uint32_t v = cols[(c + 2) * ws + (j >> 5)] >> (j & 16);
      reinterpret_cast<uint4*>(o)[i] =
          make_uint4(bytes4(v), bytes4(v >> 4), bytes4(v >> 8),
                     bytes4(v >> 12));
    }
  } else {
    for (int i = tid; i < n; i += nth) {
      const int c = i / z, j = i - c * z;
      o[i] = (int8_t)((cols[(c + 2) * ws + (j >> 5)] >> (j & 31)) & 1u);
    }
  }
}

bool valid(const DlschEncodeParams* p) {
  if (p->nrows < 5 || p->nrows > kEncMaxRows || p->z < 2 || p->z > 384 ||
      p->nw != (p->z + 31) / 32 || p->kb + p->nrows != p->ncols ||
      p->ncb < 1 || p->nslots < 1 || p->threads < 32 ||
      p->threads > kThreads || p->threads % 32 != 0 || p->tbs < 1 ||
      (p->tb_crc_len != 24 && p->tb_crc_len != 16) ||
      (p->cb_crc_len != 24 && p->cb_crc_len != 0) || p->ppc < 1 ||
      (long long)p->ppc * p->ncb < (long long)p->tbs + p->tb_crc_len ||
      p->ppc + p->cb_crc_len > p->kb * p->z ||
      p->row_ptr[p->nrows] > kEncMaxEdges || p->kb * p->nw > p->threads ||
      p->kb * p->nw > kMaxWords)
    return false;
  const int ws = p->nw + 1;
  for (int r = 0; r < p->nrows; ++r)
    if (p->row_ptr[r + 1] - p->row_ptr[r] >
        (r < 4 ? kCoreParts * kCoreEdges : kExtEdges))
      return false;
  if (4 * p->nw * kCoreParts > p->threads) return false;
  for (int e = 0; e < p->row_ptr[p->nrows]; ++e)
    if ((int)(p->edge[e] & 0xffffu) >= p->ncols * ws ||
        (int)(p->edge[e] >> 16) >= p->z)
      return false;
  for (int st = 0; st < 3; ++st) {
    const int* step = p->core + 1 + 9 * st;
    if (step[0] < 0 || step[0] > 3 || step[1] < p->kb ||
        step[1] >= p->kb + 4 || step[2] < 0 || step[2] > 3)
      return false;
  }
  return p->core[0] >= 0 && p->core[0] < p->z;
}

}  // namespace

// tb int8 [nslots, tbs]; out int8 [nslots, ncb, (ncols - 2) * z]; scratch
// int32 [2 * nslots]; cb_tab uint32 [kb * nw, 4], tb_tab uint32 [ncb * kb
// * nw, 4] (ops/ldpc_encode.py::_crc_word_tables).
extern "C" int srsran_dlsch_encode(void* tb, void* out, void* scratch,
                                   void* stream, const void* params,
                                   const void* cb_tab, const void* tb_tab) {
  const DlschEncodeParams* p = (const DlschEncodeParams*)params;
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, 2 * sizeof(uint32_t) * (size_t)p->nslots, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(uint32_t) * stage_words(*p) + p->ppc + 16;
  const int vec = p->z % 16 == 0 && ((uintptr_t)out & 15) == 0;
  dlsch_encode_kernel<<<dim3(p->ncb, p->nslots), p->threads, smem, st>>>(
      *p, (const int8_t*)tb, (int8_t*)out, (uint32_t*)scratch,
      (const uint4*)cb_tab, (const uint4*)tb_tab, vec);
  return (int)cudaGetLastError();
}
