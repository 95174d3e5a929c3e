// K1: layered normalized min-sum LDPC decoder with CRC early stop, for Hopper.
//
// Replaces srsran_tpu/ops/ldpc_decode.py::decode_early_stop (:112-155), whose
// layer update is _make_sweep (:47-72), and its CRC predicate ops/crc.py::
// crc_check.  Twin: srsran_tpu_torch/ops/ldpc_decode.py::decode_early_stop_ref.
//
// Design.  One CTA per codeblock, one thread per lifted lane j < Z.  The CB's
// NV*Z LLRs (26,112 f32 = 104 KB at BG1, Z=384) live in dynamic shared memory
// for the sweep; rows run in order inside the CTA with the cyclic shifts as
// index arithmetic ((j + s) mod Z), so no gather plan is read.  Within one
// row every (edge, lane) owns a distinct LLR, so lanes need no atomics; a
// __syncthreads() separates rows.  c2v stays in global memory in compressed
// form per (row, lane): min1, min2 (unscaled magnitudes), and one word with
// the argmin edge (bits 24..28) and the per-edge output signs (bits 0..23).
// The old message of edge e is rebuilt as 0.8 * (+-(e == argmin ? min2 :
// min1)), the very value that was added when it was written.
//
// Early stop without a host sync: one launch per sweep; the CTA ends the
// sweep with the CRC of its first k' hard bits (XOR of the host remainder
// matrix rows, packed 24 bits per word, then a warp XOR-reduce) into
// cb_ok[cb].  ldpc_check_kernel (one warp per slot) then counts the sweep
// and sets the slot's state[0] ("done") when every CB of that slot passed --
// the JAX package's all-CBs rule, kept per slot as jax.vmap keeps each
// slot's while-loop state.  A launch may hold several slots (cbs_per_slot
// CBs each, state [slots, 2]); a CTA reads its own slot's flag first and
// returns at once when it is set, so a finished slot's LLRs and iteration
// count (state[1]) stay as a run of that slot alone leaves them, and they
// stay on the device.
//
// Bounds on this card: each sweep reads and writes the codeblock LLRs once
// from global memory and the compressed c2v once per row; the row loop is
// latency-bound on shared memory with Z threads per CTA and only C CTAs (37
// at the flagship on 132 SMs).  Arithmetic is written with __fsub_rn /
// __fmul_rn / __fadd_rn (and the library builds with --fmad=false) so the
// hard decisions match the PyTorch twin bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void ldpc_sweep_kernel(
    float* __restrict__ llr, int8_t* __restrict__ bits,
    float* __restrict__ c2v_min1, float* __restrict__ c2v_min2,
    uint32_t* __restrict__ c2v_meta,
    const int* __restrict__ row_ptr, const int* __restrict__ edge_col,
    const int* __restrict__ edge_shift, int nrows, int ncols, int z,
    float scaling, const uint32_t* __restrict__ crc_rows, int k_prime,
    int* __restrict__ cb_ok, const int* __restrict__ state, int cbs_per_slot) {
  // an earlier sweep already passed every CRC of this CB's slot
  if (state[2 * (blockIdx.x / cbs_per_slot)]) return;
  const float kInf = __int_as_float(0x7f800000);
  extern __shared__ float sh[];
  __shared__ uint32_t warp_acc[32];
  const int cb = blockIdx.x;
  const int n = ncols * z;
  float* g = llr + (size_t)cb * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) sh[i] = g[i];
  __syncthreads();

  const int j = threadIdx.x;
  for (int r = 0; r < nrows; ++r) {
    if (j < z) {
      const int e0 = row_ptr[r], e1 = row_ptr[r + 1];
      const size_t cidx = ((size_t)cb * nrows + r) * z + j;
      const float o1 = c2v_min1[cidx], o2 = c2v_min2[cidx];
      const uint32_t ometa = c2v_meta[cidx];
      const int oidx = (int)(ometa >> 24);
      float m1 = kInf, m2 = kInf;
      int idx = 0;
      uint32_t neg = 0;
      for (int e = e0; e < e1; ++e) {
        const int d = e - e0;
        int q = j + edge_shift[e];
        if (q >= z) q -= z;
        const float mag_o = (d == oidx) ? o2 : o1;
        const float old = __fmul_rn(scaling, ((ometa >> d) & 1u) ? -mag_o : mag_o);
        const float t = __fsub_rn(sh[edge_col[e] * z + q], old);
        const float a = fabsf(t);
        if (a < m1) {
          m2 = m1;
          m1 = a;
          idx = d;
        } else if (a < m2) {
          m2 = a;
        }
        if (t < 0.f) neg |= 1u << d;
      }
      const uint32_t mask = (1u << (e1 - e0)) - 1u;
      const uint32_t esgn = ((__popc(neg) & 1) ? ~neg : neg) & mask;
      for (int e = e0; e < e1; ++e) {
        const int d = e - e0;
        int q = j + edge_shift[e];
        if (q >= z) q -= z;
        const int pos = edge_col[e] * z + q;
        const float mag_o = (d == oidx) ? o2 : o1;
        const float old = __fmul_rn(scaling, ((ometa >> d) & 1u) ? -mag_o : mag_o);
        const float t = __fsub_rn(sh[pos], old);
        const float mag = (d == idx) ? m2 : m1;
        const float nw = __fmul_rn(scaling, ((esgn >> d) & 1u) ? -mag : mag);
        sh[pos] = __fadd_rn(t, nw);
      }
      c2v_min1[cidx] = m1;
      c2v_min2[cidx] = m2;
      c2v_meta[cidx] = ((uint32_t)idx << 24) | esgn;
    }
    __syncthreads();
  }

  int8_t* b = bits + (size_t)cb * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = sh[i];
    g[i] = v;
    b[i] = v < 0.f ? 1 : 0;
  }
  if (crc_rows == nullptr) return;
  uint32_t acc = 0;
  for (int i = threadIdx.x; i < k_prime; i += blockDim.x)
    if (sh[i] < 0.f) acc ^= crc_rows[i];
  for (int off = 16; off > 0; off >>= 1)
    acc ^= __shfl_xor_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_acc[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t t = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t ^= warp_acc[w];
    cb_ok[cb] = (t == 0u) ? 1 : 0;
  }
}

// One warp per slot (blockIdx.x): the slot's cbs_per_slot CRC flags.
__global__ void ldpc_check_kernel(const int* __restrict__ cb_ok,
                                  int cbs_per_slot, int* __restrict__ state) {
  state += 2 * blockIdx.x;
  cb_ok += (size_t)blockIdx.x * cbs_per_slot;
  if (state[0]) return;
  int ok = 1;
  for (int i = threadIdx.x; i < cbs_per_slot; i += 32) ok &= cb_ok[i];
  ok = __all_sync(0xffffffffu, ok);
  if (threadIdx.x == 0) {
    state[1] += 1;
    if (ok) state[0] = 1;
  }
}

}  // namespace

extern "C" int srsran_ldpc_sweep(
    void* llr, void* bits, void* c2v_min1, void* c2v_min2, void* c2v_meta,
    void* row_ptr, void* edge_col, void* edge_shift, int nrows, int ncols,
    int z, float scaling, void* crc_rows, int k_prime, void* cb_ok,
    void* state, int nb, int cbs_per_slot, void* stream) {
  const size_t smem = (size_t)ncols * z * sizeof(float);
  // Raised once per size, outside any stream capture after the first call:
  // a CUDA graph captures the launches of a warmed-up program only.
  static size_t smem_set = 0;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ldpc_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const int threads = (z + 31) / 32 * 32;
  ldpc_sweep_kernel<<<nb, threads, smem, (cudaStream_t)stream>>>(
      (float*)llr, (int8_t*)bits, (float*)c2v_min1, (float*)c2v_min2,
      (uint32_t*)c2v_meta, (const int*)row_ptr, (const int*)edge_col,
      (const int*)edge_shift, nrows, ncols, z, scaling,
      (const uint32_t*)crc_rows, k_prime, (int*)cb_ok, (const int*)state,
      cbs_per_slot);
  return (int)cudaGetLastError();
}

extern "C" int srsran_ldpc_check(void* cb_ok, int nslots, int cbs_per_slot,
                                 void* state, void* stream) {
  ldpc_check_kernel<<<nslots, 32, 0, (cudaStream_t)stream>>>(
      (const int*)cb_ok, cbs_per_slot, (int*)state);
  return (int)cudaGetLastError();
}
