// K32: LDPC rate matching, bits out, for Hopper.
//
// Replaces srsran_tpu/ops/ldpc_rate_match.py::rate_match (:53-69), the
// single-codeblock bit selection and interleave the UE transmitter runs
// per codeblock (phy/upper/ue_tx.py:76-78), and the whole-TB form
// rate_match_batch (:117) as the port's UE side and PDSCH encoder call
// it: codeblock c (int8 [N], the 2Z punctured systematic bits already
// removed) gives E_c bits, bit i of which is buffer position
// window((k0' + (i mod Qm) E_c / Qm + i / Qm) mod N_nf): the circular
// window over the filler-free limited buffer (N_nf = n_cb - filler bits,
// start k0' in filler-free coordinates), mapped back across the filler gap
// [fs, fe), and the Qm-row interleaver f_{i + j Qm} = e_{i E/Qm + j} folded
// into the index.  Twin: srsran_tpu_torch/ops/ldpc_rate_match.py::
// rate_match_batch_ref; the same index on the host:
// ops/ldpc_rate_match.py::gather_index.
//
// Design.  One thread per output bit (a grid row per codeblock): an index
// computation and a byte gather, bit-exact by construction.  Bounds on this
// card: bytes (each codeblock's window positions, min(E, N_nf), read once,
// E bytes written once); the kernel is a pure gather.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void rate_match_kernel(const int8_t* __restrict__ cw, int N,
                                  const int* __restrict__ off,
                                  const int* __restrict__ es, int qm, int fs,
                                  int fe, int n_nf, int k0p,
                                  int8_t* __restrict__ out) {
  const int c = blockIdx.y;
  const int e = es[c];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= e) return;
  const int rows = e / qm;
  const long long j = (long long)(i % qm) * rows + i / qm;   // window index
  int q = (int)((k0p + j) % n_nf);                          // filler-free
  if (q >= fs) q += fe - fs;                                 // buffer index
  out[(size_t)off[c] + i] = cw[(size_t)c * N + q];
}

}  // namespace

// cw int8 [C, N]; off, es int32 [C] (each codeblock's first output bit and
// E); (fs, fe, n_nf, k0p) the window plan; out int8 [sum E].
extern "C" int srsran_rate_match(void* cw, int C, int N, void* off, void* es,
                                 int e_max, int qm, int fs, int fe, int n_nf,
                                 int k0p, void* out, void* stream) {
  if (C < 1 || N < 1 || e_max < 1 || qm < 1 || n_nf < 1 || fs < 0 ||
      fe < fs || C > 65535)
    return (int)cudaErrorInvalidValue;
  const int nt = 256;
  dim3 grid((e_max + nt - 1) / nt, C);
  rate_match_kernel<<<grid, nt, 0, (cudaStream_t)stream>>>(
      (const int8_t*)cw, N, (const int*)off, (const int*)es, qm, fs, fe, n_nf,
      k0p, (int8_t*)out);
  return (int)cudaGetLastError();
}
