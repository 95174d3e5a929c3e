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
// Design.
//  * dlsch_crc_kernel: the CRC is linear, so the TB CRC is the XOR of the
//    host remainder words (ops/crc.py::_remainder_words) of the set TB bits.
//    A grid-stride loop, a warp XOR-reduce, a block XOR-reduce, then one
//    atomicXor per block into a word zeroed by cudaMemsetAsync.  XOR is
//    order-free, so the result is deterministic.
//  * dlsch_encode_kernel: one CTA per codeblock.  It gathers its K' - L_cb
//    payload bits from the TB, the TB CRC word and the zero tail into shared
//    memory while XOR-ing the CB CRC24B remainder words of the set bits,
//    appends the CB CRC, and leaves the filler bits 0.  Then the LDPC
//    encode runs in shared memory: the four core-row sums over the info
//    columns, p0 from their XOR (one surviving cyclic shift), p1..p3 by the
//    host schedule of the double-diagonal back-substitution (the order the
//    twin solves them in), then every extension row as the XOR of its
//    edges over info and core columns.  The circulant shifts are index
//    arithmetic ((j + s) mod Z) over the graph's edge tables.
//
// A slot axis (the slot-batch mode): the last grid dimension of both
// passes is the slot, each with its own TB, TB CRC word and [C, N] output;
// one launch of each pass encodes every slot's TB.
//
// Bounds on this card: memory and latency.  The CRC pass reads the TB
// (835,584 B at the flagship) and the words of its set bits (~1.7 MB); the
// encode pass reads the TB once more and writes C x N bytes (2.5 MB), with
// the rows' XORs in shared memory.  100 CTAs at the flagship on 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t block_xor(uint32_t acc, uint32_t* warp_acc) {
  for (int off = 16; off > 0; off >>= 1)
    acc ^= __shfl_xor_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_acc[warp] = acc;
  __syncthreads();
  uint32_t t = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t ^= warp_acc[w];
  return t;
}

__global__ void dlsch_crc_kernel(const int8_t* __restrict__ tb, int tbs,
                                 const uint32_t* __restrict__ words,
                                 uint32_t* __restrict__ crc_out) {
  __shared__ uint32_t warp_acc[32];
  tb += (size_t)blockIdx.y * tbs;
  crc_out += blockIdx.y;
  uint32_t acc = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < tbs;
       i += gridDim.x * blockDim.x)
    if (tb[i] & 1) acc ^= words[i];
  acc = block_xor(acc, warp_acc);
  if (threadIdx.x == 0 && acc != 0u) atomicXor(crc_out, acc);
}

// core schedule: [s0, then 3 steps of (row, target column, nterms,
// (column, shift) x 3)].
constexpr int kCoreSteps = 3;
constexpr int kStepInts = 9;

__global__ void dlsch_encode_kernel(
    const int8_t* __restrict__ tb, int tbs, const uint32_t* __restrict__ tb_crc,
    int tb_crc_len, const uint32_t* __restrict__ cb_words, int cb_crc_len,
    int ppc, int kb, int z, int ncols, int nrows,
    const int* __restrict__ row_ptr, const int* __restrict__ edge_col,
    const int* __restrict__ edge_shift, const int* __restrict__ core,
    int8_t* __restrict__ out) {
  extern __shared__ uint8_t sh[];       // [ncols * z] bits, then [4 * z] sums
  __shared__ uint32_t warp_acc[32];
  uint8_t* cs = sh + ncols * z;
  const int cb = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int kinfo = kb * z;
  tb += (size_t)blockIdx.y * tbs;                       // the slot's TB
  out += (size_t)blockIdx.y * gridDim.x * (ncols - 2) * z;
  const uint32_t tcrc = tb_crc[blockIdx.y];

  // Payload bits, TB CRC, zero tail; CB CRC as the XOR of remainder words.
  uint32_t acc = 0;
  for (int i = tid; i < kinfo; i += nth) {
    uint8_t b = 0;
    if (i < ppc) {
      const long long g = (long long)cb * ppc + i;
      if (g < tbs)
        b = (uint8_t)(tb[g] & 1);
      else if (g < (long long)tbs + tb_crc_len)
        b = (uint8_t)((tcrc >> (tb_crc_len - 1 - (int)(g - tbs))) & 1u);
      if (b && cb_crc_len) acc ^= cb_words[i];
    }
    sh[i] = b;
  }
  const uint32_t cbc = block_xor(acc, warp_acc);   // ends with a barrier
  if (cb_crc_len && tid < cb_crc_len)
    sh[ppc + tid] = (uint8_t)((cbc >> (cb_crc_len - 1 - tid)) & 1u);
  __syncthreads();

  // Core rows 0..3 over the info columns.
  for (int idx = tid; idx < 4 * z; idx += nth) {
    const int r = idx / z, j = idx - r * z;
    uint8_t a = 0;
    for (int e = row_ptr[r]; e < row_ptr[r + 1]; ++e) {
      const int c = edge_col[e];
      if (c >= kb) continue;
      int q = j + edge_shift[e];
      if (q >= z) q -= z;
      a ^= sh[c * z + q];
    }
    cs[idx] = a;
  }
  __syncthreads();

  // p0 = roll(sum of the core rows, s0).
  const int s0 = core[0];
  for (int j = tid; j < z; j += nth) {
    int m = j - s0;
    if (m < 0) m += z;
    sh[kb * z + j] = cs[m] ^ cs[z + m] ^ cs[2 * z + m] ^ cs[3 * z + m];
  }
  __syncthreads();

  // p1..p3: each step solves one core row for its one unknown column.
  for (int st = 0; st < kCoreSteps; ++st) {
    const int* step = core + 1 + st * kStepInts;
    const int r = step[0], target = step[1], nterms = step[2];
    for (int j = tid; j < z; j += nth) {
      uint8_t a = cs[r * z + j];
      for (int t = 0; t < nterms; ++t) {
        int q = j + step[4 + 2 * t];
        if (q >= z) q -= z;
        a ^= sh[step[3 + 2 * t] * z + q];
      }
      sh[target * z + j] = a;
    }
    __syncthreads();
  }

  // Extension rows: parity column kb + r from the info and core columns.
  for (int idx = tid; idx < (nrows - 4) * z; idx += nth) {
    const int r = 4 + idx / z, j = idx % z;
    uint8_t a = 0;
    for (int e = row_ptr[r]; e < row_ptr[r + 1]; ++e) {
      const int c = edge_col[e];
      if (c >= kb + 4) continue;
      int q = j + edge_shift[e];
      if (q >= z) q -= z;
      a ^= sh[c * z + q];
    }
    sh[(kb + r) * z + j] = a;
  }
  __syncthreads();

  const int n = (ncols - 2) * z;
  int8_t* o = out + (size_t)cb * n;
  for (int i = tid; i < n; i += nth) o[i] = (int8_t)sh[2 * z + i];
}

}  // namespace

extern "C" int srsran_dlsch_encode(
    void* tb, int tbs, void* tb_words, int tb_crc_len, void* tb_crc,
    void* cb_words, int cb_crc_len, int ppc, int kb, int z, int ncols,
    int nrows, void* row_ptr, void* edge_col, void* edge_shift, void* core,
    int ncb, void* out, int nslots, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(tb_crc, 0, sizeof(uint32_t) * (size_t)nslots, st);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  int blocks = (tbs + threads - 1) / threads;
  if (blocks > 528) blocks = 528;
  if (blocks < 1) blocks = 1;
  dlsch_crc_kernel<<<dim3(blocks, nslots), threads, 0, st>>>(
      (const int8_t*)tb, tbs, (const uint32_t*)tb_words, (uint32_t*)tb_crc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(ncols + 4) * z;
  dlsch_encode_kernel<<<dim3(ncb, nslots), 512, smem, st>>>(
      (const int8_t*)tb, tbs, (const uint32_t*)tb_crc, tb_crc_len,
      (const uint32_t*)cb_words, cb_crc_len, ppc, kb, z, ncols, nrows,
      (const int*)row_ptr, (const int*)edge_col, (const int*)edge_shift,
      (const int*)core, (int8_t*)out);
  return (int)cudaGetLastError();
}
