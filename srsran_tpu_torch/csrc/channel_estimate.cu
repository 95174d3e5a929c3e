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
// What bounds it.  Bytes: the pilots, the band and the coefficients, about
// 0.5 MB a slot at the flagship PUSCH, 0.17 µs at 3.35 TB/s.  The former
// design ran five passes of a few dozen CTAs each, a memset and cuFFT
// between them (about 8 device activities, 30 µs): every pass paid a launch
// ramp and a tail, and the TA zeroed, filled, transformed and read back a
// 524 KB buffer per slot for an argmax over 2048 bins.  What remains is
// latency: a few dependent phases, each a few loads deep, so the design
// spreads each phase over a cluster of CTAs.
//
// Design.  One launch a call, no memset, no cuFFT.  A thread-block cluster
// per slot of C = P G CTAs (G = 8 / P for P = 1, 2, 4, 8 rx ports): CTA
// (port, g) owns chunk g of its port's despread pilots and of its
// subcarriers.  Four cluster barriers order the phases; every sum that
// crosses CTAs goes through distributed shared memory or a per-slot
// scratch in device memory, in rank order (no float atomics: the same
// inputs give the same bits):
//   1. LS values of the CTA's pilots (grid and pilots read once, the
//      received pilots kept for the statistics), the EPRE and the CFO
//      cross-correlation terms as they come;
//   2. the CFO: each CTA's fixed-order sum pushed to every CTA, a barrier,
//      then the C partials summed in rank order;
//   3. the rotation by the CFO and the symbol average of the chunk, written
//      to the scratch (with the rotated LS values when the coefficients
//      interpolate them); a barrier;
//   4. the TA: CTA r transforms the (port, layer) rows r, r + C, ...; its
//      power over the window is pushed, slice by slice, to the CTAs that
//      own the slices;
//   5. the coefficients of the CTA's subcarriers, all layers, from its
//      port's averages loaded from the scratch, two subcarriers a 16-byte
//      store (the smoothing + interpolation as a host band matrix: first
//      column + [nsc, W] weights, W = 8 at the flagship; the twin applies
//      it as a dense [nsc, K] matmul);
//   6. the RSRP and residual sums of the CTA's pilots (all layers'
//      reconstruction, the CFO re-applied), pushed to rank 0 with its EPRE;
//      a barrier; each CTA sums the power of its slice over the CTAs in
//      rank order and takes its FIRST maximum (ties to the lower index, as
//      argmax does), pushed to rank 0; a barrier; rank 0 takes the first
//      of the largest in rank order, and sums each port's G partials in
//      order (EPRE, RSRP, the noise with its MAX_SINR floor, the SNR).
//
// The TA in shared memory.  Place the despread pilots at positions pos_k
// of the nfft-point IDFT (k * stride on a regular comb, as the JAX regular
// branch does; each pilot's subcarrier on an irregular one, as its scatter
// branch does).  With s the largest power of two dividing every pos_k -
// pos_0 and M = nfft / s,
//     h[m] = (1/nfft) sum_k x_k e^{j 2 pi pos_k m / nfft}
//          = e^{j 2 pi pos_0 m / nfft} (1/nfft) IDFT_M(y)[m mod M] M,
// y[(pos_k - pos_0) / s] = x_k: |h| over the window is |IDFT_M(y)| up to a
// constant, which the argmax does not see.  So the TA of a (port, layer)
// row is one M-point transform (2048 points at the flagship, stride 4):
// a radix-4 decimation in frequency in place in shared memory (a radix-2
// stage last where log2 M is odd; each stage's butterflies on neighbouring
// words, its twiddles from its own host table), each position's power
// added into its bin (the digit-reversal, a host table).  The F2's comb 3
// and an irregular comb take the same path with M = nfft / s.
//
// A slot axis (the slot-batch mode) is the grid's second dimension: every
// cluster reads and writes its slot's grid, pilots (or the shared ones),
// scratch, coefficients and statistics; one launch serves every slot.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dft_s_ofdm.cuh"

namespace cg = cooperative_groups;

constexpr int kChestMaxSymbols = 14;
constexpr int kChestMaxPorts = 8;
constexpr int kChestMaxLayers = 4;
constexpr int kChestMaxCtas = 8;   // a portable cluster
constexpr int kChestThreads = 512;
constexpr int kFastS = 4;          // step 1's loads all up front for S <= 4
constexpr int kFastL = 2;          // symbols and L <= 2 layers

// Mirrors kernels/_build.py::ChestParams (K8's launch).
struct ChestParams {
  int P, L, S, K, Ksm;       // ports, layers, symbols, pilots, despread
  int cdm;                   // fd-OCC pairs despread
  int nsc, W;                // subcarriers out, band width
  int nsym_grid, nsc_grid;   // the grid's symbols and subcarriers
  int nsym_out, interp;      // coefficient symbols; per-symbol interpolation
  int use_cfo;
  int nslots, shared_pilots;
  int G;                     // CTAs a port (the cluster: P G CTAs)
  int chunk;                 // despread pilots a CTA, at most
  int M, maxd, nfft;         // TA transform points, window half width, nfft
  int lg_s;                  // log2(nfft / M)
  int smem;                  // dynamic shared memory bytes
  float beta, beta2, two_pi_dt, span;
  int syms[kChestMaxSymbols];
  float times[kChestMaxSymbols];
  int td_i0[kChestMaxSymbols];
  float td_w[kChestMaxSymbols];
};

namespace {

constexpr int NT = kChestThreads;
constexpr int NW = NT / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 conjf2(float2 a) {
  return make_float2(a.x, -a.y);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// |a|^2 as the twin computes it: abs() (a hypot), then squared.
__device__ __forceinline__ float mag2(float2 a) {
  const float m = hypotf(a.x, a.y);
  return m * m;
}
// |a|^2 as x^2 + y^2 (the statistics, held to the twin within a
// tolerance).
__device__ __forceinline__ float abs2(float2 a) {
  return a.x * a.x + a.y * a.y;
}

// e^{j sign 2 pi cfo t}, with the phase rounded as the twin rounds it.
__device__ __forceinline__ float2 cfo_rot(float cfo, float t, float sign) {
  const float ph = (sign * 6.2831855f * cfo) * t;
  float s, c;
  sincosf(ph, &s, &c);
  return make_float2(c, s);
}

// Fixed-order CTA sums of V floats a thread: a shuffle-down tree in each
// warp, then the warps' sums in another one in warp 0; the total is valid
// in thread 0.  red: NW x V floats of shared memory.
template <int V>
__device__ __forceinline__ void cta_reduce(float (&v)[V], float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] += __shfl_down_sync(kFull, v[i], o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < V; ++i) red[warp * V + i] = v[i];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = lane < NW ? red[lane * V + i] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] += __shfl_down_sync(kFull, v[i], o);
  }
  __syncthreads();
}

// The cluster barrier in two halves (every thread of every CTA calls
// both, in turn): arrive publishes this thread's earlier writes (shared,
// distributed shared and device memory), wait returns once every thread
// has arrived and sees theirs.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Row n of the band operator applied to x (shared memory): W weights from
// first[n] on, four to a 16-byte load where W allows, summed in order.
__device__ __forceinline__ float2 band_row(const int* __restrict__ first,
                                           const float* __restrict__ w, int W,
                                           int n, const float2* x) {
  const float* wr = w + (size_t)n * W;
  const float2* xr = x + __ldg(first + n);
  float2 acc = make_float2(0.f, 0.f);
  if (!(W & 3)) {
#pragma unroll 2
    for (int j = 0; j < W; j += 4) {
      const float4 c = __ldg(reinterpret_cast<const float4*>(wr + j));
      const float cj[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc.x += cj[q] * xr[j + q].x;
        acc.y += cj[q] * xr[j + q].y;
      }
    }
  } else {
    for (int j = 0; j < W; ++j) {
      const float c = __ldg(wr + j);
      acc.x += c * xr[j].x;
      acc.y += c * xr[j].y;
    }
  }
  return acc;
}

// The band of 8 (the DM-RS combs' width): row n's weights in registers,
// applied to x in order.
struct Band8 {
  float c[8];
  int first;
  __device__ __forceinline__ void load(const int* __restrict__ f,
                                       const float* __restrict__ w, int n) {
    first = __ldg(f + n);
    const float4 a = __ldg(reinterpret_cast<const float4*>(w + 8 * (size_t)n));
    const float4 b =
        __ldg(reinterpret_cast<const float4*>(w + 8 * (size_t)n + 4));
    c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w;
    c[4] = b.x; c[5] = b.y; c[6] = b.z; c[7] = b.w;
  }
  __device__ __forceinline__ float2 apply(const float2* x) const {
    const float2* xr = x + first;
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc.x += c[j] * xr[j].x;
      acc.y += c[j] * xr[j].y;
    }
    return acc;
  }
};

// A CTA's shared memory, in float2 units from its start: the TA's
// twiddles [M], one TA row [M], its port's averages [L][Ksm] (after, for
// per-symbol interpolation, its rotated LS values [L][S][Ksm]), the LS
// values of its chunk [L][S][chunk], its received pilots [S][2 chunk];
// then floats: the power of its TA rows [M] and every CTA's over its
// slice of the window [C][ceil(W2 / C)].
struct Layout {
  int row, port, ls, rx, pw, pall, end;
  __host__ __device__ Layout(const ChestParams& p) {
    row = p.M;
    port = row + p.M;
    ls = port + p.L * ((p.interp ? p.S : 0) + 1) * p.Ksm;
    rx = ls + p.L * p.S * p.chunk;
    pw = 2 * (rx + p.S * 2 * p.chunk);             // in floats
    pall = pw + p.M;
    const int C = p.P * p.G;
    end = pall + C * ((2 * p.maxd + C - 1) / C);
  }
  __host__ __device__ int bytes() const { return 4 * end; }
};

__global__ void __launch_bounds__(NT, 1)
    chest_kernel(const float2* __restrict__ grid,
                 const float2* __restrict__ expected,
                 float2* __restrict__ coeffs, float* __restrict__ stats,
                 float2* __restrict__ scratch, const ChestParams p,
                 const int* __restrict__ ints,
                 const float* __restrict__ weights,
                 const float2* __restrict__ twiddles) {
  extern __shared__ float4 smem4[];
  __shared__ float red[NW * 3];
  __shared__ float2 cfo_all[kChestMaxCtas];    // every CTA's CFO partial
  __shared__ float spart[kChestMaxCtas][3];    // every CTA's stats sums
  __shared__ float cand_v[kChestMaxCtas];      // every CTA's TA candidate
  __shared__ int cand_i[kChestMaxCtas];
  __shared__ float2 rot[2 * kChestMaxSymbols];  // e^{-+j 2 pi cfo t_s}
  __shared__ int best_i[NW];

  cluster_arrive();       // this CTA has started (DSMEM may reach it)
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.P * p.G, rank = blockIdx.x, slot = blockIdx.y;
  const int port = rank / p.G, g = rank % p.G, tid = threadIdx.x;
  const int L = p.L, S = p.S, K = p.K, Ksm = p.Ksm, M = p.M;
  const int W2 = 2 * p.maxd, lgM = __ffs(M) - 1;
  const int k_lo = g * Ksm / p.G, k_hi = (g + 1) * Ksm / p.G;
  const int* first = ints;
  const int* cols = first + p.nsc;
  const int* ta_pos = cols + 2 * K;
  const int* pfirst = ta_pos + Ksm;
  const int* perm = pfirst + K;
  const float* pweights = weights + (size_t)p.nsc * p.W;
  const int per_port = L * ((p.interp ? S : 0) + 1) * Ksm;

  const float2* slot_grid =
      grid + (size_t)slot * p.P * p.nsym_grid * p.nsc_grid;
  if (!p.shared_pilots) expected += (size_t)slot * L * S * K;
  coeffs += ((size_t)slot * p.P + port) * L * p.nsym_out * p.nsc;
  stats += (size_t)slot * (4 * p.P + 2);
  scratch += (size_t)slot * p.P * per_port;

  const Layout lay(p);
  float2* sm2 = reinterpret_cast<float2*>(smem4);
  float* sm1 = reinterpret_cast<float*>(smem4);
  float2* tw = sm2;
  float2* row = sm2 + lay.row;
  float2* pavg = sm2 + lay.port;   // the port's (rotated LS and) averages
  float2* ls = sm2 + lay.ls;
  float2* rxs = sm2 + lay.rx;
  float* pw = sm1 + lay.pw;
  float* pall = sm1 + lay.pall;
  for (int m = tid; m < M; m += NT)
    srsran_dfts::cp_async8(tw + m, twiddles + m);
  for (int m = tid; m < M; m += NT) pw[m] = 0.f;

  // 1. LS values of the chunk, one despread pilot a thread: its grid
  // samples read once for all layers (kept for the statistics), every
  // load issued before the first use where S <= 4 and L <= 2 (else the
  // next symbol's samples while this one's are used); the EPRE and the CFO
  // cross-correlation terms as they come.
  const float2* pgrid = slot_grid + (size_t)port * p.nsym_grid * p.nsc_grid;
  const int n_chunk = k_hi - k_lo;
  float e = 0.f;
  float2 part = make_float2(0.f, 0.f);
  // x conj(e) / beta^2 (beta = 1: no division, the same bits)
  auto ls1 = [&](float2 x, float2 ex) {
    const float2 a = cmul(x, conjf2(ex));
    return p.beta2 == 1.f ? a
                          : make_float2(a.x / p.beta2, a.y / p.beta2);
  };
  auto ls_value = [&](float2 x0, float2 e0, float2 x1, float2 e1) {
    const float2 a = ls1(x0, e0);
    if (!p.cdm) return a;
    const float2 b = ls1(x1, e1);
    return make_float2(0.5f * (a.x + b.x), 0.5f * (a.y + b.y));
  };
  const bool fast = S <= kFastS && L <= kFastL;
  for (int c = tid; c < n_chunk; c += NT) {
    const int k = k_lo + c;
    const int k0 = p.cdm ? 2 * k : k;
    const int c0 = __ldg(cols + k0), c1 = p.cdm ? __ldg(cols + k0 + 1) : c0;
    float2* rx_c = rxs + (p.cdm ? 2 * c : c);
    if (fast) {
      float2 x0[kFastS], x1[kFastS], e0[kFastS][kFastL], e1[kFastS][kFastL];
#pragma unroll
      for (int s = 0; s < kFastS; ++s) {
        if (s < S) {
          const float2* grow = pgrid + (size_t)p.syms[s] * p.nsc_grid;
          x0[s] = grow[c0];
          x1[s] = grow[c1];
#pragma unroll
          for (int l = 0; l < kFastL; ++l) {
            if (l < L) {
              const float2* ex = expected + ((size_t)l * S + s) * K + k0;
              e0[s][l] = ex[0];
              e1[s][l] = p.cdm ? ex[1] : e0[s][l];
            }
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kFastS; ++s) {
        if (s < S) {
          rx_c[(size_t)s * 2 * p.chunk] = x0[s];
          e += abs2(x0[s]);
          if (p.cdm) {
            rx_c[(size_t)s * 2 * p.chunk + 1] = x1[s];
            e += abs2(x1[s]);
          }
#pragma unroll
          for (int l = 0; l < kFastL; ++l) {
            if (l < L) {
              const float2 v = ls_value(x0[s], e0[s][l], x1[s], e1[s][l]);
              ls[((size_t)l * S + s) * p.chunk + c] = v;
              if (s > 0) {
                const float2 pv = ls[((size_t)l * S + s - 1) * p.chunk + c];
                part = cadd(part, cmul(v, conjf2(pv)));
              }
            }
          }
        }
      }
      continue;
    }
    float2 prev[kChestMaxLayers];
    const float2* grow = pgrid + (size_t)p.syms[0] * p.nsc_grid;
    float2 nx0 = grow[c0], nx1 = grow[c1];
    for (int s = 0; s < S; ++s) {
      const float2 x0 = nx0, x1 = nx1;
      if (s + 1 < S) {
        grow = pgrid + (size_t)p.syms[s + 1] * p.nsc_grid;
        nx0 = grow[c0];
        nx1 = grow[c1];
      }
      float2 e0[kChestMaxLayers], e1[kChestMaxLayers];
#pragma unroll
      for (int l = 0; l < kChestMaxLayers; ++l) {
        if (l < L) {
          const float2* ex = expected + ((size_t)l * S + s) * K + k0;
          e0[l] = ex[0];
          e1[l] = p.cdm ? ex[1] : e0[l];
        }
      }
      rx_c[(size_t)s * 2 * p.chunk] = x0;
      e += abs2(x0);
      if (p.cdm) {
        rx_c[(size_t)s * 2 * p.chunk + 1] = x1;
        e += abs2(x1);
      }
#pragma unroll
      for (int l = 0; l < kChestMaxLayers; ++l) {
        if (l < L) {
          const float2 v = ls_value(x0, e0[l], x1, e1[l]);
          ls[((size_t)l * S + s) * p.chunk + c] = v;
          if (s > 0) part = cadd(part, cmul(v, conjf2(prev[l])));
          prev[l] = v;
        }
      }
    }
  }

  // 2. The CFO: each CTA's cross-correlation summed in a fixed order,
  // pushed to every CTA of the cluster, then the C partials in rank order.
  cluster_wait();         // every CTA has started
  float cfo = 0.f;
  if (p.use_cfo) {
    float v[2] = {part.x, part.y};
    cta_reduce<2>(v, red);
    if (tid < 32) {
      const float2 tot = make_float2(__shfl_sync(kFull, v[0], 0),
                                     __shfl_sync(kFull, v[1], 0));
      if (tid < C) *cluster.map_shared_rank(&cfo_all[rank], tid) = tot;
    }
    cluster.sync();
    float2 acc = make_float2(0.f, 0.f);
    for (int q = 0; q < C; ++q) acc = cadd(acc, cfo_all[q]);
    cfo = atan2f(acc.y, acc.x) / p.two_pi_dt;
    if (tid < S) {
      rot[tid] = cfo_rot(cfo, p.times[tid], -1.f);
      rot[kChestMaxSymbols + tid] = cfo_rot(cfo, p.times[tid], 1.f);
    }
  }
  if (rank == 0 && tid == 0) stats[4 * p.P] = cfo;
  __syncthreads();

  // 3. Rotation by the CFO and the symbol average of the chunk, to the
  // scratch: the port's averages [L][Ksm], or its rotated LS values
  // [L][S][Ksm] then the averages for per-symbol interpolation.
  float2* port_scratch = scratch + (size_t)port * per_port;
  float2* avg_scratch = port_scratch + (p.interp ? L * S * Ksm : 0);
  for (int i = tid; i < L * n_chunk; i += NT) {
    const int c = i % n_chunk, l = i / n_chunk;
    float2 acc = make_float2(0.f, 0.f);
    for (int s = 0; s < S; ++s) {
      float2 v = ls[((size_t)l * S + s) * p.chunk + c];
      if (p.use_cfo) v = cmul(v, rot[s]);
      if (p.interp) port_scratch[((size_t)l * S + s) * Ksm + k_lo + c] = v;
      acc = cadd(acc, v);
    }
    avg_scratch[(size_t)l * Ksm + k_lo + c] =
        make_float2(acc.x / (float)S, acc.y / (float)S);
  }
  cluster.sync();         // every CTA's averages are in the scratch

  // 4. The TA: CTA r transforms rows r, r + C, ... of the P L (port,
  // layer) rows -- the row's averages at (ta_pos[k] - ta_pos[0]) >> lg_s,
  // through the M-point IDFT (radix-4 decimation in frequency in place,
  // a radix-2 stage last where log2 M is odd) -- and sums |.|^2 over them
  // in order, each position into its bin; the window's bins go to their
  // owners.
  srsran_dfts::cp_async_wait();
  const int ta0 = __ldg(ta_pos);
  for (int rho = rank; rho < p.P * L; rho += C) {
    const int rp = rho / L, rl = rho % L;
    const float2* src = scratch + (size_t)rp * per_port +
                        (p.interp ? L * S * Ksm : 0) + (size_t)rl * Ksm;
    for (int m = tid; m < M; m += NT) row[m] = make_float2(0.f, 0.f);
    __syncthreads();
    for (int k = tid; k < Ksm; k += NT)
      row[(__ldg(ta_pos + k) - ta0) >> p.lg_s] = src[k];
    __syncthreads();
    const float2* w = tw;
    int n_blk = M;
    for (; n_blk >= 4; n_blk >>= 2) {      // radix-4 stages
      const int q = n_blk >> 2, lq = __ffs(q) - 1;
      for (int b = tid; b < (M >> 2); b += NT) {
        const int n = b & (q - 1);
        float2* x = row + ((b >> lq) << (lq + 2)) + n;
        const float2 a = x[0], bb = x[q], c = x[2 * q], d = x[3 * q];
        const float2 apc = cadd(a, c), amc = csub(a, c);
        const float2 bpd = cadd(bb, d), bmd = csub(bb, d);
        const float2 ibmd = make_float2(-bmd.y, bmd.x);   // j (b - d)
        x[0] = cadd(apc, bpd);
        x[q] = cmul(cadd(amc, ibmd), w[n]);
        x[2 * q] = cmul(csub(apc, bpd), w[q + n]);
        x[3 * q] = cmul(csub(amc, ibmd), w[2 * q + n]);
      }
      w += 3 * q;
      __syncthreads();
    }
    if (n_blk == 2) {                      // a last radix-2 stage
      for (int b = tid; b < (M >> 1); b += NT) {
        float2* x = row + 2 * b;
        const float2 a = x[0], bb = x[1];
        x[0] = cadd(a, bb);
        x[1] = csub(a, bb);
      }
      __syncthreads();
    }
    for (int m = tid; m < M; m += NT)      // position m holds bin perm[m]
      pw[__ldg(perm + m)] += mag2(row[m]);
    __syncthreads();
  }
  // the window's bins to their owners: CTA q owns bins [q slice, (q + 1)
  // slice) and holds every CTA's power there, [C][slice]
  const int slice = (W2 + C - 1) / C;
  for (int m = tid; m < W2; m += NT) {
    const int n = m < p.maxd ? m : p.nfft - W2 + m;
    const int owner = m / slice;
    cluster.map_shared_rank(pall, owner)[rank * slice + m - owner * slice] =
        pw[n & (M - 1)];
  }

  // 5. The coefficients of the CTA's subcarriers, two a 16-byte store
  // where the rows allow it, from its port's averages (or rotated LS
  // values) loaded from the scratch; a band of 8 loaded once for every
  // layer and symbol; per-symbol interpolation between the DM-RS symbols
  // i0 and i0 + 1, their band rows made once per i0.
  for (int i = tid; i < per_port; i += NT) pavg[i] = port_scratch[i];
  __syncthreads();
  const float2* avg = pavg + (p.interp ? L * S * Ksm : 0);
  const int pairs = (p.nsc + 1) >> 1;
  const int t_lo = g * pairs / p.G, t_hi = (g + 1) * pairs / p.G;
  const bool vec = !(p.nsc & 1);
  auto store2 = [&](float2* out, float2 v0, float2 v1, bool two) {
    if (vec) {
      *reinterpret_cast<float4*>(out) = make_float4(v0.x, v0.y, v1.x, v1.y);
    } else {
      out[0] = v0;
      if (two) out[1] = v1;
    }
  };
  if (p.W == 8) {
    for (int t = t_lo + tid; t < t_hi; t += NT) {
      const int n = 2 * t;
      const bool two = n + 1 < p.nsc;
      Band8 b0, b1;
      b0.load(first, weights, n);
      if (two) b1.load(first, weights, n + 1);
      const float2 zero = make_float2(0.f, 0.f);
      for (int l = 0; l < L; ++l) {
        float2* out = coeffs + (size_t)l * p.nsym_out * p.nsc + n;
        if (!p.interp) {
          const float2* x = avg + (size_t)l * Ksm;
          store2(out, b0.apply(x), two ? b1.apply(x) : zero, two);
          continue;
        }
        float2 f0a = zero, f1a = zero, f0b = zero, f1b = zero;
        int cur = -1;
        for (int so = 0; so < p.nsym_out; ++so, out += p.nsc) {
          const int i0 = p.td_i0[so];
          if (i0 != cur) {
            const float2* x0 = pavg + ((size_t)l * S + i0) * Ksm;
            f0a = b0.apply(x0);
            f1a = b0.apply(x0 + Ksm);
            if (two) {
              f0b = b1.apply(x0);
              f1b = b1.apply(x0 + Ksm);
            }
            cur = i0;
          }
          const float wt = p.td_w[so], w0 = 1.f - wt;
          store2(out,
                 make_float2(f0a.x * w0 + f1a.x * wt, f0a.y * w0 + f1a.y * wt),
                 make_float2(f0b.x * w0 + f1b.x * wt, f0b.y * w0 + f1b.y * wt),
                 two);
        }
      }
    }
  } else {
    const int span = t_hi - t_lo;
    for (int i = tid; i < L * span; i += NT) {
      const int l = i / span, n = 2 * (t_lo + i % span);
      const bool two = n + 1 < p.nsc;
      float2* out = coeffs + (size_t)l * p.nsym_out * p.nsc + n;
      float2 f0a = make_float2(0.f, 0.f), f1a = f0a, f0b = f0a, f1b = f0a;
      int cur = -1;
      for (int so = 0; so < p.nsym_out; ++so, out += p.nsc) {
        float2 v0, v1;
        if (!p.interp) {
          const float2* x = avg + (size_t)l * Ksm;
          v0 = band_row(first, weights, p.W, n, x);
          v1 = two ? band_row(first, weights, p.W, n + 1, x)
                   : make_float2(0.f, 0.f);
        } else {
          const int i0 = p.td_i0[so];
          if (i0 != cur) {
            const float2* x0 = pavg + ((size_t)l * S + i0) * Ksm;
            f0a = band_row(first, weights, p.W, n, x0);
            f1a = band_row(first, weights, p.W, n, x0 + Ksm);
            if (two) {
              f0b = band_row(first, weights, p.W, n + 1, x0);
              f1b = band_row(first, weights, p.W, n + 1, x0 + Ksm);
            }
            cur = i0;
          }
          const float wt = p.td_w[so], w0 = 1.f - wt;
          v0 = make_float2(f0a.x * w0 + f1a.x * wt, f0a.y * w0 + f1a.y * wt);
          v1 = make_float2(f0b.x * w0 + f1b.x * wt, f0b.y * w0 + f1b.y * wt);
        }
        store2(out, v0, v1, two);
      }
    }
  }

  // 6. RSRP and the residual over the chunk's pilots (all layers'
  // reconstruction, the CFO re-applied; the band rows at the pilots from
  // their own host tables, the received pilots kept from step 1), pushed
  // with the EPRE to rank 0.
  float r = 0.f, nz = 0.f;
  const int per = p.cdm ? 2 : 1;
  for (int c = tid; c < per * n_chunk; c += NT) {
    const int k = per * k_lo + c;
    float2 ex[kFastS][kFastL];
    if (fast) {                            // every pilot load up front
#pragma unroll
      for (int s = 0; s < kFastS; ++s)
#pragma unroll
        for (int l = 0; l < kFastL; ++l)
          if (s < S && l < L) ex[s][l] = expected[((size_t)l * S + s) * K + k];
    }
    float2 f[kChestMaxLayers];
    if (p.W == 8) {
      Band8 b;
      b.load(pfirst, pweights, k);
#pragma unroll
      for (int l = 0; l < kChestMaxLayers; ++l)
        if (l < L) f[l] = b.apply(avg + (size_t)l * Ksm);
    } else {
#pragma unroll
      for (int l = 0; l < kChestMaxLayers; ++l)
        if (l < L)
          f[l] = band_row(pfirst, pweights, p.W, k, avg + (size_t)l * Ksm);
    }
#pragma unroll
    for (int l = 0; l < kChestMaxLayers; ++l)
      if (l < L) r += abs2(f[l]);
    // the residual of symbol s, the pilots' values from e_at(s, l)
    auto residual = [&](int s, auto e_at) {
      const float2 x = rxs[(size_t)s * 2 * p.chunk + c];
      float2 recon = make_float2(0.f, 0.f);
#pragma unroll
      for (int l = 0; l < kChestMaxLayers; ++l) {
        if (l < L) {
          float2 t = cmul(f[l], e_at(l));
          t = make_float2(t.x * p.beta, t.y * p.beta);
          if (p.use_cfo) t = cmul(t, rot[kChestMaxSymbols + s]);
          recon = cadd(recon, t);
        }
      }
      nz += abs2(make_float2(x.x - recon.x, x.y - recon.y));
    };
    if (fast) {
#pragma unroll
      for (int s = 0; s < kFastS; ++s)
        if (s < S)
          residual(s, [&](int l) { return ex[s][l < kFastL ? l : 0]; });
    } else {
      for (int s = 0; s < S; ++s)
        residual(s, [&](int l) {
          return expected[((size_t)l * S + s) * K + k];
        });
    }
  }
  {
    float v[3] = {e, r, nz};
    cta_reduce<3>(v, red);
    if (tid == 0) {
      float* dst = &cluster.map_shared_rank(&spart[0][0], 0)[3 * rank];
      dst[0] = v[0];
      dst[1] = v[1];
      dst[2] = v[2];
    }
  }
  cluster_arrive();       // the owners may read the power, rank 0 the sums
  cluster_wait();

  // 7. The TA: each CTA the FIRST maximum over its slice of the window of
  // the power summed over the CTAs in rank order (ties to the lower bin,
  // as argmax does), pushed to rank 0, which takes the first of the
  // largest over the slices in order; and each port's statistics from its
  // G partials in order.
  {
    float best = -1.f;
    int bi = 0x7fffffff;
    const int lo = rank * slice, hi = min(lo + slice, W2);
    for (int m = lo + tid; m < hi; m += NT) {
      float tot = 0.f;
      for (int q = 0; q < C; ++q) tot += pall[q * slice + m - lo];
      if (tot > best) {
        best = tot;
        bi = m;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_down_sync(kFull, best, o);
      const int oi = __shfl_down_sync(kFull, bi, o);
      if (ov > best || (ov == best && oi < bi)) {
        best = ov;
        bi = oi;
      }
    }
    const int lane = tid & 31, warp = tid >> 5;
    if (lane == 0) {
      red[warp] = best;
      best_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < NW ? red[lane] : -1.f;
      bi = lane < NW ? best_i[lane] : 0x7fffffff;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_down_sync(kFull, best, o);
        const int oi = __shfl_down_sync(kFull, bi, o);
        if (ov > best || (ov == best && oi < bi)) {
          best = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        cluster.map_shared_rank(cand_v, 0)[rank] = best;
        cluster.map_shared_rank(cand_i, 0)[rank] = bi;
      }
    }
  }
  cluster_arrive();       // rank 0 may read the candidates
  cluster_wait();
  if (rank != 0) return;
  if (tid < p.P) {
    float v[3] = {0.f, 0.f, 0.f};
    for (int q = 0; q < p.G; ++q)
      for (int i = 0; i < 3; ++i) v[i] += spart[tid * p.G + q][i];
    const float rsrp = (v[1] / (float)(L * K)) * (p.beta * p.beta);
    float nv = v[2] / (float)(S * K);
    nv = fmaxf(nv, rsrp * 1e-6f);
    stats[tid] = nv;
    stats[p.P + tid] = rsrp;
    stats[2 * p.P + tid] = v[0] / (float)(S * K);
    stats[3 * p.P + tid] = rsrp / fmaxf(nv, 1e-12f);
  }
  if (tid == 0) {
    float best = cand_v[0];
    int bi = cand_i[0];
    for (int q = 1; q < C; ++q)
      if (cand_v[q] > best) {
        best = cand_v[q];
        bi = cand_i[q];
      }
    const int delay = bi < p.maxd ? bi : bi - W2;
    stats[4 * p.P + 1] = (float)delay / p.span;
  }
}

inline bool params_ok(const ChestParams& p) {
  return p.P >= 1 && p.G >= 1 && p.P * p.G <= kChestMaxCtas && p.L >= 1 &&
         p.L <= kChestMaxLayers && p.S >= 1 && p.S <= kChestMaxSymbols &&
         p.K >= 1 && p.Ksm >= p.G && p.chunk >= (p.Ksm + p.G - 1) / p.G &&
         p.nsc >= 1 && p.W >= 1 && p.nsym_out >= 1 &&
         p.nsym_out <= kChestMaxSymbols && p.nslots >= 1 && p.M >= 2 &&
         !(p.M & (p.M - 1)) && p.maxd >= 1 && p.nfft == p.M << p.lg_s &&
         p.smem == Layout(p).bytes();
}

}  // namespace

// Lets the kernel take up to `bytes` of dynamic shared memory on the
// current device (the wrapper calls it once per plan, before any capture).
extern "C" int srsran_chest_prepare(int bytes) {
  return (int)cudaFuncSetAttribute(
      chest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// grid complex64 [slots, P, nsym_grid, nsc_grid]; expected complex64
// [slots, L, S, K] (or [L, S, K] shared); coeffs complex64 [slots, P, L,
// nsym_out, nsc]; stats float [slots, 4P + 2] = noise_var, rsrp, epre, snr
// (each [P]), cfo, ta; scratch complex64 [slots, P, L (S + 1) Ksm] with
// per-symbol interpolation, else [slots, P, L Ksm]; params a ChestParams;
// ints int32 [nsc + 3K + Ksm + M]: the band's first columns, the pilots' grid
// columns, the pilots' subcarriers, the despread pilots' places in the
// nfft-point IDFT (their subcarriers; the M-point one takes (place -
// first place) >> lg_s), the band's first columns at the pilots, the bin
// of each position of the transformed row [M]; weights float [nsc + K,
// W]: the band's weights, then its rows at the pilots; twiddles
// complex64 [M], the radix-4 stages' tables: for block size N = M, M / 4,
// ..., 4, e^{2 pi j r t / N} for r = 1, 2, 3, t < N / 4.
extern "C" int srsran_chest_estimate(void* grid, void* expected, void* coeffs,
                                     void* stats, void* scratch, void* stream,
                                     const void* params, const void* ints,
                                     const void* weights,
                                     const void* twiddles) {
  const ChestParams* p = (const ChestParams*)params;
  if (!params_ok(*p)) return (int)cudaErrorInvalidValue;
  const int C = p->P * p->G;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, p->nslots, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = (size_t)p->smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, chest_kernel, (const float2*)grid, (const float2*)expected,
      (float2*)coeffs, (float*)stats, (float2*)scratch, *p, (const int*)ints,
      (const float*)weights, (const float2*)twiddles);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
