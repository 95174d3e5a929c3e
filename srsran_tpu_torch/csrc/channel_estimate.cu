// K8: DM-RS / SRS port channel estimation for Hopper.
//
// Replaces srsran_tpu/ops/channel_estimate.py::estimate (:180-275) and
// _time_alignment (:293-323): LS estimate at the pilots read straight from
// the resource grid, fd-OCC pair despread, CFO from the phase slope between
// DM-RS symbols, symbol average, frequency smoothing + interpolation to every
// subcarrier (time average or per-symbol interpolation), RSRP, EPRE, residual
// noise with its MAX_SINR floor, and the IDFT power-peak time alignment.
// Twin: srsran_tpu_torch/ops/channel_estimate.py::estimate_from_grid_ref.
//
// Design.  Five small passes on the caller's stream, plus cuFFT for the TA
// IDFT (torch.fft.ifft) between the last two:
//   1. chest_ls_kernel: one thread per (port, layer, symbol, despread
//      pilot) computes the LS value from the grid and, with CFO on, its
//      term of the CFO cross-correlation; each block writes the fixed-order
//      sum of its terms to a partials array (no float atomics: the same
//      inputs give the same bits on every run).
//   2. chest_avg_kernel: every block reduces the partials in the same fixed
//      order (so all blocks hold the same CFO), then one thread per (port,
//      layer, pilot) rotates each symbol's LS value, averages over symbols
//      and scatters the average into the zero-filled TA buffer: at k *
//      stride on a regular comb (the JAX regular branch, :302-312, drops the
//      comb's shift), at the pilot's own subcarrier from a table on an
//      irregular one (the JAX scatter branch, :313-315).
//   3. chest_interp_kernel: the smoothing + interpolation operator is a host
//      band matrix (first column + [nsc, W] weights, W = 8 at the flagship)
//      instead of the twin's dense [nsc, K] matmul (20.8 MB read per slot at
//      the flagship); one thread per output subcarrier, W multiply-adds.
//      The same launch evaluates the band rows at the pilot positions (the
//      smoothed pilots that RSRP and the residual need).
//   4. chest_stats_kernel: up to 32 blocks per rx port write partial sums
//      of EPRE, RSRP and the residual (reconstruction over all layers, CFO
//      re-applied) over their stripe of the pilots.
//   5. chest_ta_kernel (after cuFFT): one block sums the IDFT power over
//      ports and layers in the +-1/(2 stride) delay window and takes the
//      FIRST maximum (ties to the lower index, as argmax does); one thread
//      per port sums its stats partials in a fixed order and writes EPRE,
//      RSRP, the noise with its floor and the SNR.
// A slot axis (the slot-batch mode): every pass takes the slot from its
// last grid dimension and reads and writes that slot's grid, pilots (or
// the shared ones: exp_stride 0), LS values, partials, coefficients,
// statistics and TA buffer at fixed strides; the band and the tables are
// shared.  One launch of each pass serves every slot.
//
// Bounds on this card: bytes (the pilots, the band and the coefficients,
// about 0.5 MB per slot at the flagship PUSCH); the passes are launch-bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int NT_TA = 1024;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 conjf2(float2 a) {
  return make_float2(a.x, -a.y);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float abs2(float2 a) {
  const float m = hypotf(a.x, a.y);
  return m * m;
}

// Fixed-order tree sum over a block of NTH threads (all threads call it).
template <int NTH>
__device__ float2 block_sum2(float2 v, float2* sh) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int s = NTH / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] = cadd(sh[t], sh[t + s]);
    __syncthreads();
  }
  const float2 r = sh[0];
  __syncthreads();
  return r;
}

template <int NTH>
__device__ float block_sum(float v, float* sh) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int s = NTH / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] += sh[t + s];
    __syncthreads();
  }
  const float r = sh[0];
  __syncthreads();
  return r;
}

// The CFO in Hz from the pass-1 partials, identical in every block.
__device__ float cfo_from_partials(const float2* partials, int n,
                                   float two_pi_dt, float2* sh) {
  float2 acc = make_float2(0.f, 0.f);
  for (int i = threadIdx.x; i < n; i += NT) acc = cadd(acc, partials[i]);
  acc = block_sum2<NT>(acc, sh);
  return atan2f(acc.y, acc.x) / two_pi_dt;
}

// e^{j sign 2 pi cfo t}, with the phase rounded as the twin rounds it.
__device__ __forceinline__ float2 cfo_rot(float cfo, float t, float sign) {
  const float ph = (sign * 6.2831855f * cfo) * t;
  float s, c;
  sincosf(ph, &s, &c);
  return make_float2(c, s);
}

struct Pilots {
  const float2* grid;
  int nsym_grid, nsc_grid;
  const int* syms;
  const int* cols;
  const float2* expected;  // [L, S, K]
  int S, K;
  float beta2;
  size_t grid_stride, exp_stride;  // per slot (exp_stride 0: shared pilots)

  __device__ Pilots slot(size_t b) const {
    Pilots q = *this;
    q.grid += b * grid_stride;
    q.expected += b * exp_stride;
    return q;
  }

  __device__ float2 rx(int p, int s, int k) const {
    return grid[((size_t)p * nsym_grid + syms[s]) * nsc_grid + cols[k]];
  }
  __device__ float2 ls1(int p, int l, int s, int k) const {
    const float2 v = cmul(rx(p, s, k),
                          conjf2(expected[((size_t)l * S + s) * K + k]));
    return make_float2(v.x / beta2, v.y / beta2);
  }
  // LS value of despread pilot k (a pilot pair under the fd-OCC cover).
  __device__ float2 ls(int p, int l, int s, int k, int cdm) const {
    if (!cdm) return ls1(p, l, s, k);
    const float2 a = ls1(p, l, s, 2 * k), b = ls1(p, l, s, 2 * k + 1);
    return make_float2(0.5f * (a.x + b.x), 0.5f * (a.y + b.y));
  }
};

__global__ void chest_ls_kernel(Pilots pil, int P, int L, int Ksm, int cdm,
                                int use_cfo, float2* __restrict__ ls,
                                float2* __restrict__ partials) {
  __shared__ float2 sh[NT];
  const long long total = (long long)P * L * pil.S * Ksm;
  const size_t b = blockIdx.y;                        // slot
  pil = pil.slot(b);
  ls += b * total;
  partials += b * gridDim.x;
  const long long gid = (long long)blockIdx.x * NT + threadIdx.x;
  float2 part = make_float2(0.f, 0.f);
  if (gid < total) {
    const int k = (int)(gid % Ksm);
    long long r = gid / Ksm;
    const int s = (int)(r % pil.S);
    r /= pil.S;
    const int l = (int)(r % L);
    const int p = (int)(r / L);
    const float2 v = pil.ls(p, l, s, k, cdm);
    ls[gid] = v;
    if (use_cfo && s >= 1) part = cmul(v, conjf2(pil.ls(p, l, s - 1, k, cdm)));
  }
  if (use_cfo) {
    part = block_sum2<NT>(part, sh);
    if (threadIdx.x == 0) partials[blockIdx.x] = part;
  }
}

__global__ void chest_avg_kernel(int P, int L, int S, int Ksm, int use_cfo,
                                 int keep_symbols, const float* __restrict__ times,
                                 const float2* __restrict__ partials,
                                 int nparts, float two_pi_dt,
                                 float2* __restrict__ ls,
                                 float2* __restrict__ ls_avg,
                                 float2* __restrict__ tabuf, int nfft,
                                 int stride_sm,
                                 const int* __restrict__ ta_idx,
                                 float* __restrict__ stats, int cfo_slot) {
  __shared__ float2 sh[NT];
  const size_t b = blockIdx.y;                        // slot
  partials += b * nparts;
  ls += b * P * L * S * Ksm;
  ls_avg += b * P * L * Ksm;
  tabuf += b * P * L * nfft;
  stats += b * (4 * P + 2);
  const float cfo =
      use_cfo ? cfo_from_partials(partials, nparts, two_pi_dt, sh) : 0.f;
  const long long gid = (long long)blockIdx.x * NT + threadIdx.x;
  if (gid == 0) stats[cfo_slot] = cfo;
  if (gid >= (long long)P * L * Ksm) return;
  const int k = (int)(gid % Ksm);
  const long long pl = gid / Ksm;
  float2 acc = make_float2(0.f, 0.f);
  for (int s = 0; s < S; ++s) {
    const size_t at = ((size_t)pl * S + s) * Ksm + k;
    float2 v = ls[at];
    if (use_cfo) {
      v = cmul(v, cfo_rot(cfo, times[s], -1.f));
      if (keep_symbols) ls[at] = v;
    }
    acc = cadd(acc, v);
  }
  const float2 avg = make_float2(acc.x / (float)S, acc.y / (float)S);
  ls_avg[gid] = avg;
  tabuf[(size_t)pl * nfft +
        (ta_idx ? (size_t)ta_idx[k] : (size_t)k * stride_sm)] = avg;
}

__device__ __forceinline__ float2 band_row(const int* __restrict__ first,
                                           const float* __restrict__ w, int W,
                                           int n, const float2* __restrict__ x) {
  const float* wr = w + (size_t)n * W;
  const float2* xr = x + first[n];
  float2 acc = make_float2(0.f, 0.f);
  for (int j = 0; j < W; ++j) {
    acc.x += wr[j] * xr[j].x;
    acc.y += wr[j] * xr[j].y;
  }
  return acc;
}

__global__ void chest_interp_kernel(int P, int L, int S, int Ksm, int K,
                                    int nsc, int W, int nsym_out, int interp,
                                    const int* __restrict__ first,
                                    const float* __restrict__ w,
                                    const int* __restrict__ pilot_idx,
                                    const int* __restrict__ td_i0,
                                    const float* __restrict__ td_w,
                                    const float2* __restrict__ ls,
                                    const float2* __restrict__ ls_avg,
                                    float2* __restrict__ coeffs,
                                    float2* __restrict__ filtered) {
  const long long gid = (long long)blockIdx.x * NT + threadIdx.x;
  const long long total_c = (long long)P * L * nsym_out * nsc;
  const size_t b = blockIdx.y;                        // slot
  ls += b * P * L * S * Ksm;
  ls_avg += b * P * L * Ksm;
  coeffs += b * total_c;
  filtered += b * P * L * K;
  if (gid < total_c) {
    const int n = (int)(gid % nsc);
    const long long r = gid / nsc;
    const int so = (int)(r % nsym_out);
    const long long pl = r / nsym_out;
    float2 v;
    if (!interp) {
      v = band_row(first, w, W, n, ls_avg + pl * Ksm);
    } else {
      const int i0 = td_i0[so];
      const float wt = td_w[so], w0 = 1.f - wt;
      const float2 f0 = band_row(first, w, W, n, ls + (pl * S + i0) * Ksm);
      const float2 f1 = band_row(first, w, W, n, ls + (pl * S + i0 + 1) * Ksm);
      v = make_float2(f0.x * w0 + f1.x * wt, f0.y * w0 + f1.y * wt);
    }
    coeffs[gid] = v;
    return;
  }
  const long long g = gid - total_c;
  if (g >= (long long)P * L * K) return;
  const int k = (int)(g % K);
  const long long pl = g / K;
  filtered[g] = band_row(first, w, W, pilot_idx[k], ls_avg + pl * Ksm);
}

// Per-port partial sums of |rx|^2, |filtered|^2 and |residual|^2 over a
// block's stripe of the pilots; grid (NB, P, slots).
__global__ void chest_stats_kernel(Pilots pil, int L, int use_cfo,
                                   const float* __restrict__ times,
                                   const float2* __restrict__ partials,
                                   int nparts, float two_pi_dt, float beta,
                                   const float2* __restrict__ filtered,
                                   float* __restrict__ stats_part) {
  __shared__ float2 sh2[NT];
  __shared__ float sh[NT];
  const int b = blockIdx.x, nb = gridDim.x, p = blockIdx.y;
  const size_t slot = blockIdx.z;
  const int S = pil.S, K = pil.K;
  pil = pil.slot(slot);
  partials += slot * nparts;
  filtered += slot * gridDim.y * L * K;
  stats_part += slot * gridDim.y * nb * 3;
  const float cfo =
      use_cfo ? cfo_from_partials(partials, nparts, two_pi_dt, sh2) : 0.f;
  float e = 0.f, r = 0.f, nz = 0.f;
  for (int i = b * NT + threadIdx.x; i < S * K; i += nb * NT)
    e += abs2(pil.rx(p, i / K, i % K));
  for (int i = b * NT + threadIdx.x; i < L * K; i += nb * NT)
    r += abs2(filtered[(size_t)p * L * K + i]);
  for (int i = b * NT + threadIdx.x; i < S * K; i += nb * NT) {
    const int s = i / K, k = i % K;
    float2 recon = make_float2(0.f, 0.f);
    const float2 rot = use_cfo ? cfo_rot(cfo, times[s], 1.f)
                               : make_float2(1.f, 0.f);
    for (int l = 0; l < L; ++l) {
      float2 t = cmul(filtered[((size_t)p * L + l) * K + k],
                      pil.expected[((size_t)l * S + s) * K + k]);
      t = make_float2(t.x * beta, t.y * beta);
      if (use_cfo) t = cmul(t, rot);
      recon = cadd(recon, t);
    }
    const float2 x = pil.rx(p, s, k);
    nz += abs2(make_float2(x.x - recon.x, x.y - recon.y));
  }
  e = block_sum<NT>(e, sh);
  r = block_sum<NT>(r, sh);
  nz = block_sum<NT>(nz, sh);
  if (threadIdx.x == 0) {
    float* out = stats_part + ((size_t)p * nb + b) * 3;
    out[0] = e;
    out[1] = r;
    out[2] = nz;
  }
}

// The TA from the IDFT of the TA buffer, and (one thread per port) the
// fixed-order sums of the stats partials: EPRE, RSRP, noise with its
// MAX_SINR floor, SNR.  One block per slot.
__global__ void chest_ta_kernel(const float2* __restrict__ h, int P, int L,
                                int S, int K, int nfft, int maxd, float span,
                                float beta, const float* __restrict__ stats_part,
                                int nb, float* __restrict__ stats) {
  __shared__ float sv[NT_TA];
  __shared__ int si[NT_TA];
  const int t = threadIdx.x;
  const int PL = P * L;
  const size_t slot = blockIdx.x;
  h += slot * PL * nfft;
  stats_part += slot * P * nb * 3;
  stats += slot * (4 * P + 2);
  if (t < P) {
    float e = 0.f, r = 0.f, nz = 0.f;
    for (int b = 0; b < nb; ++b) {
      const float* part = stats_part + ((size_t)t * nb + b) * 3;
      e += part[0];
      r += part[1];
      nz += part[2];
    }
    const float rsrp = (r / (float)(L * K)) * (beta * beta);
    float nv = nz / (float)(S * K);
    nv = fmaxf(nv, rsrp * 1e-6f);
    stats[t] = nv;
    stats[P + t] = rsrp;
    stats[2 * P + t] = e / (float)(S * K);
    stats[3 * P + t] = rsrp / fmaxf(nv, 1e-12f);
  }
  float best = -1.f;
  int bi = 0x7fffffff;
  for (int m = t; m < 2 * maxd; m += NT_TA) {
    const int n = m < maxd ? m : nfft - 2 * maxd + m;
    float pw = 0.f;
    for (int i = 0; i < PL; ++i) pw += abs2(h[(size_t)i * nfft + n]);
    if (pw > best) {
      best = pw;
      bi = m;
    }
  }
  sv[t] = best;
  si[t] = bi;
  __syncthreads();
  for (int s = NT_TA / 2; s > 0; s >>= 1) {
    if (t < s) {
      const float ov = sv[t + s];
      const int oi = si[t + s];
      if (ov > sv[t] || (ov == sv[t] && oi < si[t])) {
        sv[t] = ov;
        si[t] = oi;
      }
    }
    __syncthreads();
  }
  if (t == 0) {
    const int idx = si[0];
    const int delay = idx < maxd ? idx : idx - 2 * maxd;
    stats[4 * P + 1] = (float)delay / span;
  }
}

inline int blocks_for(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

}  // namespace

// The blocks per port of the stats pass (the wrapper sizes stats_part
// [P, NB, 3] with the same rule).
inline int stats_blocks(int S, int K) {
  const int nb = (S * K + NT - 1) / NT;
  return nb < 1 ? 1 : (nb > 32 ? 32 : nb);
}

// Passes 1-4, for `slots` slots (grid, LS, coefficient and stats buffers
// slot-major; the pilots per slot unless shared_pilots).  stats: float
// [slots, 4P + 2] = noise_var, rsrp, epre, snr (each [P]), cfo, ta; pass 2
// writes the cfo, srsran_chest_ta the rest.  tabuf [slots, P*L, nfft] is
// zeroed here and filled by pass 2, at ta_idx [Ksm] (an irregular comb's
// despread subcarriers) or, when it is null, at k * stride_sm.
extern "C" int srsran_chest_estimate(
    void* grid, int nsym_grid, int nsc_grid, void* syms, void* cols,
    void* expected, void* times, void* band_first, void* band_w,
    void* pilot_idx, void* td_i0, void* td_w, int P, int L, int S, int K,
    int cdm, int nsc, int W, int use_cfo, int nsym_out, int interp,
    float beta, float two_pi_dt, int nfft, int stride_sm, void* ls,
    void* ls_avg, void* partials, void* filtered, void* coeffs,
    void* stats_part, void* stats, void* tabuf, void* ta_idx, int slots,
    int shared_pilots, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int Ksm = cdm ? K / 2 : K;
  Pilots pil{(const float2*)grid, nsym_grid, nsc_grid, (const int*)syms,
             (const int*)cols, (const float2*)expected, S, K, beta * beta,
             (size_t)P * nsym_grid * nsc_grid,
             shared_pilots ? 0 : (size_t)L * S * K};
  cudaError_t err = cudaMemsetAsync(
      tabuf, 0, sizeof(float2) * (size_t)slots * P * L * nfft, st);
  if (err != cudaSuccess) return (int)err;
  const int n1 = blocks_for((long long)P * L * S * Ksm, NT);
  chest_ls_kernel<<<dim3(n1, slots), NT, 0, st>>>(
      pil, P, L, Ksm, cdm, use_cfo, (float2*)ls, (float2*)partials);
  chest_avg_kernel<<<dim3(blocks_for((long long)P * L * Ksm, NT), slots), NT,
                     0, st>>>(
      P, L, S, Ksm, use_cfo, interp, (const float*)times,
      (const float2*)partials, n1, two_pi_dt, (float2*)ls, (float2*)ls_avg,
      (float2*)tabuf, nfft, stride_sm, (const int*)ta_idx, (float*)stats,
      4 * P);
  const long long n3 =
      (long long)P * L * nsym_out * nsc + (long long)P * L * K;
  chest_interp_kernel<<<dim3(blocks_for(n3, NT), slots), NT, 0, st>>>(
      P, L, S, Ksm, K, nsc, W, nsym_out, interp, (const int*)band_first,
      (const float*)band_w, (const int*)pilot_idx, (const int*)td_i0,
      (const float*)td_w, (const float2*)ls, (const float2*)ls_avg,
      (float2*)coeffs, (float2*)filtered);
  chest_stats_kernel<<<dim3(stats_blocks(S, K), P, slots), NT, 0, st>>>(
      pil, L, use_cfo, (const float*)times, (const float2*)partials, n1,
      two_pi_dt, beta, (const float2*)filtered, (float*)stats_part);
  return (int)cudaGetLastError();
}

// Pass 5, after the IDFT h of tabuf: the TA and the per-port stats, one
// block per slot.
extern "C" int srsran_chest_ta(void* h, int P, int L, int S, int K, int nfft,
                               int maxd, float span, float beta,
                               void* stats_part, void* stats, int slots,
                               void* stream) {
  chest_ta_kernel<<<slots, NT_TA, 0, (cudaStream_t)stream>>>(
      (const float2*)h, P, L, S, K, nfft, maxd, span, beta,
      (const float*)stats_part, stats_blocks(S, K), (float*)stats);
  return (int)cudaGetLastError();
}
