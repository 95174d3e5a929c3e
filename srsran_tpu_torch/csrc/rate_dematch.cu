// K2: LDPC rate dematch + HARQ combining + decoder input layout, for Hopper.
//
// Replaces srsran_tpu/ops/ldpc_rate_match.py::rate_dematch_batch (:159-203)
// together with the soft-buffer add and the 2Z zero prefix of
// srsran_tpu/phy/upper/sch_decoder.py::decode (:40-45).  Twin:
// srsran_tpu_torch/ops/ldpc_rate_match.py::rate_dematch_combine_ref.
//
// Design.  A gather: one thread per output position (cb, k) of the decoder
// input [C, 2Z + N].  The 2Z punctured positions get 0, and so do the
// positions past a limited circular buffer (kk >= n_cb = N_nf + fe - fs,
// where n_ref < N cut it; JAX ldpc_rate_match.py:190-202).  Position
// kk = k - 2Z of the circular buffer is a filler bit (LLR 1e4) or, in filler-free
// coordinates q, the sum of the received LLRs at window offsets
// i = q - k0' + r * N_nf (r = 0, 1, ...; 0 <= i < E), read through the Qm
// de-interleave (i -> row i mod (E/Qm), column i div (E/Qm)).  The sum runs
// in the order r = 0, 1, ... with no atomics, so it is deterministic.  The
// HARQ soft buffer is added last, and the result is written both as new_soft
// [C, N] and into the decoder input, in one pass.
//
// Bounds on this card: pure memory traffic (G f32 reads, 2 C N f32 writes
// plus the soft buffer read), about 10 MB at the flagship.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void rate_dematch_kernel(
    const float* __restrict__ llr, const float* __restrict__ soft,
    float* __restrict__ new_soft, float* __restrict__ dec_in,
    const int* __restrict__ cb_off, const int* __restrict__ cb_e, int nb,
    int n, int z2, int qm, int fs, int fe, int n_nf, int k0p, float filler) {
  const int width = z2 + n;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)nb * width) return;
  const int cb = (int)(gid / width);
  const int k = (int)(gid - (long long)cb * width);
  if (k < z2) {
    dec_in[gid] = 0.f;
    return;
  }
  const int kk = k - z2;
  float acc;
  if (kk >= n_nf + (fe - fs)) {
    acc = 0.f;                                  // past the limited buffer
  } else if (kk >= fs && kk < fe) {
    acc = filler;
  } else {
    const int q = kk < fs ? kk : kk - (fe - fs);
    const int e = cb_e[cb];
    const int off = cb_off[cb];
    const int rows = e / qm;
    acc = 0.f;
    for (int i = q - k0p; i < e; i += n_nf) {
      if (i >= 0) {
        const int col = i / rows;
        const int row = i - col * rows;
        acc = __fadd_rn(acc, llr[off + row * qm + col]);
      }
    }
  }
  const size_t o = (size_t)cb * n + kk;
  if (soft != nullptr) acc = __fadd_rn(acc, soft[o]);
  new_soft[o] = acc;
  dec_in[gid] = acc;
}

}  // namespace

extern "C" int srsran_rate_dematch(void* llr, void* soft, void* new_soft,
                                   void* dec_in, void* cb_off, void* cb_e,
                                   int nb, int n, int z2, int qm, int fs,
                                   int fe, int n_nf, int k0p, float filler,
                                   void* stream) {
  const long long total = (long long)nb * (z2 + n);
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  rate_dematch_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)llr, (const float*)soft, (float*)new_soft, (float*)dec_in,
      (const int*)cb_off, (const int*)cb_e, nb, n, z2, qm, fs, fe, n_nf, k0p,
      filler);
  return (int)cudaGetLastError();
}
