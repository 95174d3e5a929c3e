// K36: the LDPC syndrome check for Hopper.
//
// Replaces srsran_tpu/ops/ldpc_decode.py::check_parity (:158-168): for each
// codeword of hard bits [NV * Z], whether every lifted check row XORs to 0
// over its circulant-shifted columns.  Twin: srsran_tpu_torch/ops/
// ldpc_decode.py::check_parity_ref.
//
// Design.  One CTA per codeword; its threads span the Z lanes of a check
// row and walk the rows in turn, each lane XORing bit (c * Z + (j + s) mod
// Z) over the row's edges (c, s) -- the edge tables K1 reads (ops/
// ldpc_decode.py::_edge_tables) -- into one flag per thread; a block-wide OR
// (__syncthreads_or) ends it.  No early exit, so every launch reads the
// same bytes.  Bounds on this card: bytes (the NV * Z bits once; 26,112
// per BG1 codeword at Z = 384) against an XOR per edge and lane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 384;

__global__ void ldpc_parity_kernel(const int8_t* __restrict__ bits, int nrows,
                                   int ncols, int Z,
                                   const int* __restrict__ row_ptr,
                                   const int* __restrict__ edge_col,
                                   const int* __restrict__ edge_shift,
                                   uint8_t* __restrict__ ok) {
  const int8_t* x = bits + (size_t)blockIdx.x * ncols * Z;
  int bad = 0;
  for (int r = 0; r < nrows; ++r) {
    for (int j = threadIdx.x; j < Z; j += NT) {
      int acc = 0;
      for (int e = row_ptr[r]; e < row_ptr[r + 1]; ++e) {
        int q = j + edge_shift[e];
        if (q >= Z) q -= Z;
        acc ^= x[(size_t)edge_col[e] * Z + q] & 1;
      }
      bad |= acc;
    }
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) ok[blockIdx.x] = bad ? 0 : 1;
}

}  // namespace

// bits int8 [B, ncols * Z]; (row_ptr [nrows + 1], edge_col, edge_shift) the
// graph's edges, shifts already reduced mod Z; ok bool [B].
extern "C" int srsran_ldpc_parity(void* bits, int B, int nrows, int ncols,
                                  int Z, void* row_ptr, void* edge_col,
                                  void* edge_shift, void* ok, void* stream) {
  if (B < 1 || nrows < 1 || ncols < 1 || Z < 1)
    return (int)cudaErrorInvalidValue;
  ldpc_parity_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(
      (const int8_t*)bits, nrows, ncols, Z, (const int*)row_ptr,
      (const int*)edge_col, (const int*)edge_shift, (uint8_t*)ok);
  return (int)cudaGetLastError();
}
