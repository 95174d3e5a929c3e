// K16: fused PUSCH L x N equalize (ZF or MMSE) -> max-log demap ->
// descramble, for Hopper: the cases K3 (pusch_demap.cu) does not take --
// MMSE with 1-2 layers and ZF or MMSE with 3-4 layers (it takes ZF with 1-2
// layers too, for the tests).
//
// Replaces srsran_tpu/ops/equalizer.py::equalize_mmse_1xn (:37-52) and
// equalize_lxn (:83-118), as dispatched by equalize (:121-137), with
// ops/modulation.py::demodulate (:112-130) and ops/scrambling.py::
// descramble_llrs (:21-24), fed by the data-RE gather of
// srsran_tpu/phy/upper/pusch.py::_frontend_hop (:209-219).  Twin:
// srsran_tpu_torch/ops/ul_demap.py::equalize_demap_descramble_ref.
//
// Design.  One thread per data RE, everything in registers.  The thread
// gathers y[p] and h[p][l] through the host RE plan and accumulates the
// upper triangle of G = H^H H (at most 10 complex entries) and z = H^H y
// over the P ports.  One layer: the 1 x N closed forms (ZF, or MMSE with
// x = z / (|h|^2 + nv)).  Two to four layers: A = G + c I (c = nv for MMSE,
// 1e-9 for ZF), factored A = L D L^H (unit lower L, real D: Hermitian
// positive definite, no square roots), W = L^-1, A^-1 = W^H D^-1 W, x =
// A^-1 z; the output noise is nv [A^-1]_ll (ZF) or nv [A^-1 G A^-1]_ll
// (MMSE, from G itself, not A^-1 - c A^-2, which cancels at low SNR), 1e12
// where it is not positive.  The JAX package inverts A by LU with pivoting,
// so the two round differently: parity is to a tolerance.  Then the demap
// and the Gold sign of K3 (pusch_demap.cuh's demap_symbol, every modulation
// from BPSK to 256QAM, pi/2-BPSK's parity from the launch's first codeword
// symbol as in K3), LLRs in codeword order (RE-major, layer-minor) and x
// for the EVM.
//
// A slot axis (the slot-batch mode): blockIdx.y picks the slot, whose grid,
// coefficients, noise variance, LLRs and symbols lie at fixed strides, as
// in K3; the RE plan, the level table and the Gold bits are shared.  A
// slot is only an offset: each slot's arithmetic is its unbatched launch's.
//
// Bounds on this card: memory -- per RE it reads P complex samples and
// P*L complex coefficients and writes L*Qm f32 LLRs and L complex symbols;
// at the 4-layer QAM64 UE of the two-UE slot (27,060 REs, 4 ports) about
// 4.6 MB, some 1.4 us at 3.35 TB/s; the solve is ~600 flops per RE.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pusch_demap.cuh"

namespace {

using namespace srsran_demap;

struct DemapArgs {
  const float2* grid;
  const float2* coeffs;
  const int* sym;
  const int* sc;
  int nre, P, S, K, T, Ka, sc_off;
  const float* nv_ptr;
  const float* levels;
  int kind, rot0;
  float two_scale;
  const uint8_t* seq;
  float* llr;
  float2* x;
};

__device__ __forceinline__ float2 cconj(float2 a) {
  return make_float2(a.x, -a.y);
}

__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(__fmul_rn(a.x, s), __fmul_rn(a.y, s));
}

template <int L, bool MMSE>
__device__ __forceinline__ void solve(const float2 (&g)[L][L],
                                      const float2 (&z)[L], float nv,
                                      float2 (&xs)[L], float (&nvs)[L]) {
  if constexpr (L == 1) {
    const float energy = g[0][0].x;
    if constexpr (MMSE) {
      const float den = fmaxf(__fadd_rn(energy, nv), 1e-12f);
      xs[0] = make_float2(__fdiv_rn(z[0].x, den), __fdiv_rn(z[0].y, den));
      nvs[0] = energy < 1e-12f
                   ? 1e12f
                   : __fdiv_rn(__fmul_rn(nv, energy), __fmul_rn(den, den));
    } else {
      const float inv = __fdiv_rn(1.f, fmaxf(energy, 1e-12f));
      xs[0] = cscale(z[0], inv);
      nvs[0] = energy < 1e-12f ? 1e12f : __fmul_rn(nv, inv);
    }
  } else {
    const float ridge = MMSE ? nv : 1e-9f;
    // A = L D L^H over the upper triangle g[j][i] (j <= i) of G.
    float d[L];
    float2 lo[L][L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      float dj = __fadd_rn(g[j][j].x, ridge);
#pragma unroll
      for (int k = 0; k < j; ++k)
        dj = __fsub_rn(dj, __fmul_rn(abs2(lo[j][k]), d[k]));
      d[j] = fmaxf(dj, 1e-30f);
      const float inv_d = __fdiv_rn(1.f, d[j]);
#pragma unroll
      for (int i = j + 1; i < L; ++i) {
        float2 v = cconj(g[j][i]);                       // A[i][j]
#pragma unroll
        for (int k = 0; k < j; ++k) {
          const float2 t = cscale(cmul(lo[i][k], cconj(lo[j][k])), d[k]);
          v = make_float2(__fsub_rn(v.x, t.x), __fsub_rn(v.y, t.y));
        }
        lo[i][j] = cscale(v, inv_d);
      }
    }
    // W = L^-1 (unit lower): W[i][j] = -sum_{k=j}^{i-1} L[i][k] W[k][j].
    float2 w[L][L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
#pragma unroll
      for (int i = 0; i < L; ++i)
        w[i][j] = make_float2(i == j ? 1.f : 0.f, 0.f);
#pragma unroll
      for (int i = j + 1; i < L; ++i) {
        float2 acc = lo[i][j];
#pragma unroll
        for (int k = j + 1; k < i; ++k) acc = cadd(acc, cmul(lo[i][k], w[k][j]));
        w[i][j] = make_float2(-acc.x, -acc.y);
      }
    }
    // A^-1[l][m] = sum_{k >= max(l, m)} conj(W[k][l]) W[k][m] / d[k].
    float2 ai[L][L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
#pragma unroll
      for (int m = 0; m < L; ++m) {
        float2 acc = make_float2(0.f, 0.f);
#pragma unroll
        for (int k = (l > m ? l : m); k < L; ++k)
          acc = cadd(acc, cscale(cjmul(w[k][l], w[k][m]),
                                 __fdiv_rn(1.f, d[k])));
        ai[l][m] = acc;
      }
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int m = 0; m < L; ++m) acc = cadd(acc, cmul(ai[l][m], z[m]));
      xs[l] = acc;
      float diag;
      if constexpr (MMSE) {
        // [A^-1 G A^-1]_ll = sum_{m,n} A^-1[l][m] G[m][n] conj(A^-1[l][n])
        float2 s = make_float2(0.f, 0.f);
#pragma unroll
        for (int m = 0; m < L; ++m) {
          float2 row = make_float2(0.f, 0.f);
#pragma unroll
          for (int n = 0; n < L; ++n) {
            const float2 gmn = m <= n ? g[m][n] : cconj(g[n][m]);
            row = cadd(row, cmul(gmn, cconj(ai[l][n])));
          }
          s = cadd(s, cmul(ai[l][m], row));
        }
        diag = s.x;
      } else {
        diag = ai[l][l].x;
      }
      nvs[l] = diag <= 0.f ? 1e12f : __fmul_rn(nv, diag);
    }
  }
}

template <int L, bool MMSE, int HALF>
__global__ void pusch_demap_lxn_kernel(const DemapArgs a) {
  const int re = blockIdx.x * blockDim.x + threadIdx.x;
  if (re >= a.nre) return;
  const int qm = a.kind < 2 ? 1 : 2 * HALF;
  const size_t b = blockIdx.y;                       // slot
  const float2* grid = a.grid + b * a.P * a.S * a.K;
  const float2* coeffs = a.coeffs + b * a.P * L * a.T * a.Ka;
  float* llr = a.llr + b * a.nre * L * qm;
  float2* x = a.x + b * a.nre * L;
  const int s = a.sym[re];
  const int k = a.sc[re];
  const int ka = k - a.sc_off;
  const int t = (a.T == 1) ? 0 : s;
  const float nv = a.nv_ptr[b];
  float2 g[L][L];
  float2 z[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    z[l] = make_float2(0.f, 0.f);
#pragma unroll
    for (int m = 0; m < L; ++m) g[l][m] = make_float2(0.f, 0.f);
  }
  for (int p = 0; p < a.P; ++p) {
    const float2 y = grid[((size_t)p * a.S + s) * a.K + k];
    float2 h[L];
#pragma unroll
    for (int l = 0; l < L; ++l)
      h[l] = coeffs[(((size_t)p * L + l) * a.T + t) * a.Ka + ka];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      z[l] = cadd(z[l], cjmul(h[l], y));
#pragma unroll
      for (int m = l; m < L; ++m) g[l][m] = cadd(g[l][m], cjmul(h[l], h[m]));
    }
  }
  float2 xs[L];
  float nvs[L];
  solve<L, MMSE>(g, z, nv, xs, nvs);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int si = re * L + l;
    x[si] = xs[l];
    demap_symbol<HALF>(xs[l], nvs[l], a.kind, (a.rot0 + si) & 1,
                       a.two_scale, a.levels, a.seq, llr, si);
  }
}

template <int L, bool MMSE>
int launch(const DemapArgs& a, int half, int nslots, cudaStream_t st) {
  const int threads = 128;
  const dim3 blocks((a.nre + threads - 1) / threads, nslots);
  switch (half) {
    case 1: pusch_demap_lxn_kernel<L, MMSE, 1><<<blocks, threads, 0, st>>>(a); break;
    case 2: pusch_demap_lxn_kernel<L, MMSE, 2><<<blocks, threads, 0, st>>>(a); break;
    case 3: pusch_demap_lxn_kernel<L, MMSE, 3><<<blocks, threads, 0, st>>>(a); break;
    case 4: pusch_demap_lxn_kernel<L, MMSE, 4><<<blocks, threads, 0, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int L>
int launch_method(const DemapArgs& a, int half, int mmse, int nslots,
                  cudaStream_t st) {
  return mmse ? launch<L, true>(a, half, nslots, st)
              : launch<L, false>(a, half, nslots, st);
}

}  // namespace

extern "C" int srsran_pusch_demap_lxn(void* grid, void* coeffs, void* sym,
                                      void* sc, int nre, int P, int S, int K,
                                      int L, int T, int Ka, int sc_off,
                                      void* nv_ptr, void* levels, int half,
                                      int kind, int rot0, float two_scale,
                                      int mmse, void* seq, void* llr, void* x,
                                      int nslots, void* stream) {
  if (nslots < 1) return (int)cudaErrorInvalidValue;
  if (nre <= 0) return 0;
  const DemapArgs a{(const float2*)grid, (const float2*)coeffs,
                    (const int*)sym, (const int*)sc, nre, P, S, K, T, Ka,
                    sc_off, (const float*)nv_ptr, (const float*)levels,
                    kind, rot0, two_scale, (const uint8_t*)seq, (float*)llr,
                    (float2*)x};
  cudaStream_t st = (cudaStream_t)stream;
  switch (L) {
    case 1: return launch_method<1>(a, half, mmse, nslots, st);
    case 2: return launch_method<2>(a, half, mmse, nslots, st);
    case 3: return launch_method<3>(a, half, mmse, nslots, st);
    case 4: return launch_method<4>(a, half, mmse, nslots, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
