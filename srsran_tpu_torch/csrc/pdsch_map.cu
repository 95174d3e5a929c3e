// K6: PDSCH map -- rate match, scramble, modulate, layer map, precode and
// grid add in one pass, for Hopper.
//
// Replaces srsran_tpu/ops/ldpc_rate_match.py::rate_match_batch (:132-156),
// ops/scrambling.py::scramble_bits (:15), ops/modulation.py::modulate
// (:45-64), ops/precoding.py::layer_map / precode (:16, :33) and the grid
// scatter-add of srsran_tpu/phy/upper/pdsch.py::process (:248-249).  Twin:
// srsran_tpu_torch/ops/dl_map.py::pdsch_map_ref.
//
// Design.  A gather: one thread per data RE i, which owns the L codeword
// symbols d = i*L + l (layer mapping d -> layer d mod L, position d div L).
// Every E_r is a multiple of L*Qm, so all of an RE's bits lie in one
// codeblock, found by a binary search over the E offsets.  Bit b of symbol
// d sits at k = d*Qm + b - off within its codeblock's E bits; the Qm
// interleave puts it at window offset i_sel = b*(E/Qm) + (k div Qm); the
// circular window over the filler-free buffer from k0' gives
// q = (k0' + i_sel) mod N_nf, and the fillers [fs, fe) are skipped (q < fs
// stays, else q + fe - fs).  The bit is read from the encoded codeblocks
// (K5's int8 [C, N] layout), XOR-ed with the Gold bit (host-built, packed
// 32 to a word, uploaded once per c_init and G), and the Qm/2 bits of each
// axis index the Gray PAM level table (ops/modulation.py::
// pam_levels_scaled).  The thread then forms each port's sum over layers of
// W[p, l] x_l and ADDS it into grid[p, l_sym, k_sc]: the grid may already
// hold the SSB there (the JAX program sums both); each (p, l, k) has one
// writer, so there are no atomics.
//
// A slot axis (the slot-batch mode): blockIdx.y picks the slot, whose
// encoded codeblocks and grid lie at fixed strides; the E offsets, the Gold
// words (the c_init does not depend on the slot), the level table, the RE
// plan and the precoder are shared.
//
// Bounds on this card: latency of the bit gathers (L*Qm scattered byte
// reads per RE from the 2.5 MB codeblock buffer, which stays in L2) and the
// grid read-modify-write (P complex64 per RE).  32,760 REs at the flagship.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 4;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

template <int QM>
__global__ void pdsch_map_kernel(
    const int8_t* __restrict__ cw, int n, const long long* __restrict__ cb_off,
    int ncb, int fs, int fe, int n_nf, int k0p,
    const uint32_t* __restrict__ gold, const float* __restrict__ levels,
    const int* __restrict__ sym, const int* __restrict__ sc, int nre, int L,
    const float2* __restrict__ w, int P, float2* __restrict__ grid, int S,
    int K) {
  const int re = blockIdx.x * blockDim.x + threadIdx.x;
  if (re >= nre) return;
  cw += (size_t)blockIdx.y * ncb * n;                   // the slot's CBs
  grid += (size_t)blockIdx.y * P * S * K;               // and grid
  const long long g0 = (long long)re * L * QM;
  int lo = 0, hi = ncb - 1;                 // last cb with cb_off[cb] <= g0
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (cb_off[mid] <= g0) lo = mid; else hi = mid - 1;
  }
  const int cb = lo;
  const long long off = cb_off[cb];
  const int rows = (int)((cb_off[cb + 1] - off) / QM);
  const int8_t* cwb = cw + (size_t)cb * n;

  float2 x[kMaxLayers];
  for (int l = 0; l < L; ++l) {
    const long long d = (long long)re * L + l;
    const int row = (int)(d - off / QM);    // k div Qm for every bit of d
    int vi = 0, vq = 0;
#pragma unroll
    for (int b = 0; b < QM; ++b) {
      const long long g = d * QM + b;
      const int q = (int)(((long long)k0p + (long long)b * rows + row) % n_nf);
      const int pos = q < fs ? q : q + (fe - fs);
      int bit = cwb[pos] & 1;
      bit ^= (int)((gold[g >> 5] >> (g & 31)) & 1u);
      if (b & 1) vq = (vq << 1) | bit; else vi = (vi << 1) | bit;
    }
    x[l] = make_float2(levels[vi], levels[vq]);
  }
  const int s = sym[re], k = sc[re];
  for (int p = 0; p < P; ++p) {
    float2 acc = cmul(w[p * L], x[0]);
    for (int l = 1; l < L; ++l) {
      const float2 t = cmul(w[p * L + l], x[l]);
      acc = make_float2(__fadd_rn(acc.x, t.x), __fadd_rn(acc.y, t.y));
    }
    float2* gp = grid + ((size_t)p * S + s) * K + k;
    const float2 v = *gp;
    *gp = make_float2(__fadd_rn(v.x, acc.x), __fadd_rn(v.y, acc.y));
  }
}

}  // namespace

extern "C" int srsran_pdsch_map(void* cw, int n, void* cb_off, int ncb,
                                int fs, int fe, int n_nf, int k0p, void* gold,
                                void* levels, int qm, void* sym, void* sc,
                                int nre, int L, void* w, int P, void* grid,
                                int S, int K, int nslots, void* stream) {
  if (L < 1 || L > kMaxLayers || nslots < 1) return (int)cudaErrorInvalidValue;
  if (nre == 0) return 0;
  const int threads = 128;
  const dim3 blocks((nre + threads - 1) / threads, nslots);
  cudaStream_t st = (cudaStream_t)stream;
#define SRSRAN_MAP_LAUNCH(Q)                                                  \
  pdsch_map_kernel<Q><<<blocks, threads, 0, st>>>(                           \
      (const int8_t*)cw, n, (const long long*)cb_off, ncb, fs, fe, n_nf, k0p, \
      (const uint32_t*)gold, (const float*)levels, (const int*)sym,          \
      (const int*)sc, nre, L, (const float2*)w, P, (float2*)grid, S, K)
  switch (qm) {
    case 2: SRSRAN_MAP_LAUNCH(2); break;
    case 4: SRSRAN_MAP_LAUNCH(4); break;
    case 6: SRSRAN_MAP_LAUNCH(6); break;
    case 8: SRSRAN_MAP_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SRSRAN_MAP_LAUNCH
  return (int)cudaGetLastError();
}
