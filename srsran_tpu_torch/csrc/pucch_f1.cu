// K10: PUCCH format 1 batch detection for Hopper.
//
// Replaces srsran_tpu/phy/upper/pucch.py::detect_format1_batch (:325-416):
// for every user multiplexed on one PUCCH F1 occasion (one PRB, one or two
// hops), the per-hop channel h0 [U, P] from the OCC-weighted DM-RS symbols,
// the channel energy, the matched-filter statistic z [U, D] of every data
// symbol, then mean, variance, detection metric, symbol estimate, detection
// flag and HARQ bits.  The host weights of f1_batch_weights (cyclic-shift
// phases with conj(base) folded in, OCC weights) arrive as device tensors,
// so the kernel reads the raw [P, S, 12] slice of each hop from the grid.
// Twin: srsran_tpu_torch/phy/upper/pucch.py::f1_detect_ref.
//
// Design.  One block per occasion group and slot (a slot batch runs its B
// slots as B blocks of one launch: blockIdx.x is the slot, each weight
// array shared or one per slot): the hop slice sits in shared
// memory (at most 8 ports x 14 symbols x 12 subcarriers), the users are a
// loop, every sum is sequential in a fixed order.  Bounds on this card: the
// work is a few thousand multiply-adds on ~6 KB (4 x 14 x 12 REs and U = 1
// at the flagship): the kernel is launch-bound by nature.  Its worth is the
// ~20 plain launches of the twin that it replaces.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr int MAX_P = 8;
constexpr int MAX_SYM = 14;
constexpr int MAX_U = 64;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float abs2(float2 a) {
  const float m = hypotf(a.x, a.y);
  return m * m;
}

struct Hop {
  int prb, l_lo, nsym, s0;             // s0: first symbol relative to the
  const float2* a_dm;                  // allocation; [U, nsym, 12]
  const float2* ph;                    // [U, nsym, 12]
  const float2* w_da;                  // [U, nsym]
};

// Slot b's weights of a hop: bits 0-2 of `stacked` say which of a_dm, ph
// and w_da carry one array per slot (the others are shared).
__device__ Hop slot_hop(Hop h, size_t b, int U, int stacked) {
  const size_t n = (size_t)U * h.nsym;
  if (stacked & 1) h.a_dm += b * n * 12;
  if (stacked & 2) h.ph += b * n * 12;
  if (stacked & 4) h.w_da += b * n;
  return h;
}

__global__ void pucch_f1_kernel(const float2* __restrict__ grid,
                                int nsym_grid, int nsc_grid, int P, int U,
                                int nhops, Hop h0p, Hop h1p, int stacked,
                                float threshold,
                                uint8_t* __restrict__ detected,
                                float* __restrict__ metric,
                                int8_t* __restrict__ bits,
                                float2* __restrict__ d_hat) {
  __shared__ float2 d0[MAX_P * MAX_SYM * 12];
  __shared__ float2 dm[MAX_P * 12];
  __shared__ float2 h0[MAX_P];
  __shared__ float2 zc[MAX_U * MAX_SYM];
  __shared__ float he[MAX_U];
  const int t = threadIdx.x;
  const size_t b = blockIdx.x;                         // slot
  grid += b * P * nsym_grid * nsc_grid;
  h0p = slot_hop(h0p, b, U, stacked);
  h1p = slot_hop(h1p, b, U, stacked >> 3);
  detected += b * U;
  metric += b * U;
  bits += b * 2 * U;
  d_hat += b * U;
  for (int u = t; u < U; u += NT) he[u] = 0.f;
  int dbase = 0;
  for (int hi = 0; hi < nhops; ++hi) {
    const Hop hop = hi == 0 ? h0p : h1p;
    const int ns = hop.nsym;
    __syncthreads();
    for (int i = t; i < P * ns * 12; i += NT) {
      const int p = i / (ns * 12), r = i % (ns * 12);
      d0[i] = grid[((size_t)p * nsym_grid + hop.l_lo + r / 12) * nsc_grid +
                   hop.prb * 12 + r % 12];
    }
    int n_dm = 0, n_da = 0;
    for (int s = 0; s < ns; ++s) ((hop.s0 + s) % 2 == 0 ? n_dm : n_da)++;
    if (n_dm == 0) n_dm = 1;
    const int first_data = (hop.s0 % 2 == 1) ? 0 : 1;
    __syncthreads();
    for (int u = 0; u < U; ++u) {
      if (t < P * 12) {
        const int p = t / 12, n = t % 12;
        float2 acc = make_float2(0.f, 0.f);
        for (int s = 0; s < ns; ++s)
          acc = cadd(acc, cmul(d0[(p * ns + s) * 12 + n],
                               hop.a_dm[((size_t)u * ns + s) * 12 + n]));
        dm[t] = acc;
      }
      __syncthreads();
      if (t < P) {
        float2 acc = make_float2(0.f, 0.f);
        for (int n = 0; n < 12; ++n) acc = cadd(acc, dm[t * 12 + n]);
        acc = make_float2(acc.x / 12.f, acc.y / 12.f);
        h0[t] = make_float2(acc.x / (float)n_dm, acc.y / (float)n_dm);
      }
      __syncthreads();
      if (t == 0) {
        float e = 0.f;
        for (int p = 0; p < P; ++p) e += abs2(h0[p]);
        he[u] = he[u] + 12.f * e;
      }
      if (t < ns && (hop.s0 + t) % 2 == 1) {
        float2 z = make_float2(0.f, 0.f);
        for (int p = 0; p < P; ++p) {
          const float2 hc = make_float2(h0[p].x, -h0[p].y);
          for (int n = 0; n < 12; ++n)
            z = cadd(z, cmul(cmul(hc, d0[(p * ns + t) * 12 + n]),
                             hop.ph[((size_t)u * ns + t) * 12 + n]));
        }
        zc[u * MAX_SYM + dbase + (t - first_data) / 2] =
            cmul(z, hop.w_da[(size_t)u * ns + t]);
      }
      __syncthreads();
    }
    dbase += n_da;
  }
  __syncthreads();
  for (int u = t; u < U; u += NT) {
    const float2* z = zc + u * MAX_SYM;
    float2 zm = make_float2(0.f, 0.f);
    for (int i = 0; i < dbase; ++i) zm = cadd(zm, z[i]);
    zm = make_float2(zm.x / (float)dbase, zm.y / (float)dbase);
    const float den = fmaxf(he[u] / (float)nhops, 1e-12f);
    const float2 d = make_float2(zm.x / den, zm.y / den);
    float var = 0.f;
    for (int i = 0; i < dbase; ++i)
      var += abs2(make_float2(z[i].x - zm.x, z[i].y - zm.y));
    var = var / (float)dbase;
    const float m = (float)dbase * abs2(zm) / fmaxf(var, 1e-9f);
    metric[u] = m;
    detected[u] = m > threshold;
    bits[2 * u] = d.x < 0.f;
    bits[2 * u + 1] = d.y < 0.f;
    d_hat[u] = d;
  }
}

}  // namespace

// For `slots` slots of grid c64 [slots, P, nsym, nsc]: per hop (prb, l_lo,
// nsym, s0) and its three weight pointers (a_dm, ph, w_da) of hop 0 then
// hop 1 (hop 1's unused with one hop); bit 3h + j of `stacked` set where
// weight j of hop h has a leading slot axis.  detected uint8 [slots, U],
// metric f32 [slots, U], bits int8 [slots, U, 2], d_hat c64 [slots, U].
extern "C" int srsran_pucch_f1(void* grid, int P, int nsym_grid, int nsc_grid,
                               int U, int nhops, int prb0, int l0, int ns0,
                               int s00, void* adm0, void* ph0, void* wda0,
                               int prb1, int l1, int ns1, int s01, void* adm1,
                               void* ph1, void* wda1, int stacked,
                               float threshold, void* detected, void* metric,
                               void* bits, void* d_hat, int slots,
                               void* stream) {
  if (P > MAX_P || U > MAX_U || ns0 > MAX_SYM || ns1 > MAX_SYM ||
      nhops < 1 || nhops > 2 || slots < 1)
    return (int)cudaErrorInvalidValue;
  Hop a{prb0, l0, ns0, s00, (const float2*)adm0, (const float2*)ph0,
        (const float2*)wda0};
  Hop b{prb1, l1, ns1, s01, (const float2*)adm1, (const float2*)ph1,
        (const float2*)wda1};
  pucch_f1_kernel<<<slots, NT, 0, (cudaStream_t)stream>>>(
      (const float2*)grid, nsym_grid, nsc_grid, P, U, nhops, a, b, stacked,
      threshold,
      (uint8_t*)detected, (float*)metric, (int8_t*)bits, (float2*)d_hat);
  return (int)cudaGetLastError();
}
