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
// Design.  One launch per TB, one thread per output bit (a grid row per
// codeblock): an index computation in 32-bit integers and a byte gather,
// bit-exact by construction.  Everything but the two tensors' pointers
// comes by value in RateMatchParams, which the wrapper builds once per call
// signature (kernels/_build.py::Launch): the window plan and each
// codeblock's E and first output bit, as runs of codeblocks of equal E
// (TS38.212 §5.4.2.1 gives at most two), so a launch reads no host-made
// table from device memory and a CUDA graph holds nothing but the
// parameters.  Bounds on this card: bytes (each codeblock's window
// positions, min(E, N_nf), read once, E bytes written once); at the
// flagship's 37 codeblocks the kernel takes the time of a launch, and the
// wrapper's host path (one ctypes call) is what its callers wait for.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRuns = 8;

// Mirrors kernels/_build.py::RateMatchParams.
struct RateMatchParams {
  int C, N, e_max, qm, fs, fe, n_nf, k0p, runs;
  int run_end[kMaxRuns];     // one past the run's last codeblock
  int run_e[kMaxRuns];       // the run's E
  int run_off[kMaxRuns];     // the run's first output bit
};

__global__ void rate_match_kernel(const int8_t* __restrict__ cw,
                                  const RateMatchParams p,
                                  int8_t* __restrict__ out) {
  const int c = blockIdx.y;
  int r = 0;
  while (r < p.runs - 1 && c >= p.run_end[r]) ++r;
  const int first = r ? p.run_end[r - 1] : 0;
  const int e = p.run_e[r];
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (unsigned)e) return;
  const unsigned qm = p.qm;
  const unsigned j = (i % qm) * ((unsigned)e / qm) + i / qm;  // window index
  unsigned q = ((unsigned)p.k0p + j) % (unsigned)p.n_nf;       // filler-free
  if (q >= (unsigned)p.fs) q += p.fe - p.fs;                   // buffer index
  out[(size_t)p.run_off[r] + (size_t)(c - first) * e + i] =
      cw[(size_t)c * p.N + q];
}

}  // namespace

// cw int8 [C, N]; out int8 [sum E]; params the call signature's
// RateMatchParams.
extern "C" int srsran_rate_match(const void* cw, void* out, void* stream,
                                 const void* params) {
  const RateMatchParams* p = (const RateMatchParams*)params;
  if (p->C < 1 || p->N < 1 || p->e_max < 1 || p->qm < 1 || p->n_nf < 1 ||
      p->fs < 0 || p->fe < p->fs || p->C > 65535 || p->runs < 1 ||
      p->runs > kMaxRuns || p->run_end[p->runs - 1] != p->C)
    return (int)cudaErrorInvalidValue;
  const int nt = 256;
  dim3 grid((p->e_max + nt - 1) / nt, p->C);
  rate_match_kernel<<<grid, nt, 0, (cudaStream_t)stream>>>(
      (const int8_t*)cw, *p, (int8_t*)out);
  return (int)cudaGetLastError();
}
