// K25: DL reference-signal map (NZP-CSI-RS, PT-RS, PRS) and K26: DL DM-RS
// map, for Hopper.
//
// K25 replaces srsran_tpu/phy/upper/csi_rs.py::process (:219),
// srsran_tpu/phy/upper/ptrs_prs.py::map_ptrs (:94) and ::map_prs (:170):
// sequence values, CDM-covered and weighted by the CSI-RS precoder, added
// to the grid at planned (port, symbol, subcarrier) targets.  Twin:
// srsran_tpu_torch/ops/dl_rs.py::rs_map_ref.
//
// Design.  The host builds, once per plan key, a list grouped by target
// RE: each target's flat grid offset, then its terms (value source, value
// index, complex weight = CDM cover x precoder entry) in the JAX package's
// summation order (ops/dl_rs.py::rs_plan).  One thread per target reads
// the grid value, adds its terms one by one and writes it back: every
// target has one writer, so there are no atomics, and a target that
// several CSI-RS ports reach through a precoder (or that several PDUs
// share) sums in the reference's order.  The values of up to kMaxSources
// PDUs ride in the slot context; their pointers and per-slot strides are
// passed by value.  A slot with more RS PDUs takes one launch for every
// kMaxSources of them, in PDU order (ops/dl_rs.py::rs_map): a target's
// terms follow the PDUs' order, so the sums round as in one launch.
// Products and sums are rounded one by one (__fmul_rn / __fadd_rn), as
// the twin rounds them.
//
// Bounds on this card: bytes -- each target's grid value read and
// written once, its terms' plan entries and values read once.  A flagship
// DL slot has a few thousand targets (2,184 for a 4-port CSI-RS on 273
// RB, 1,370 for PT-RS, 9,792 for a comb-4 PRS over 12 symbols): the
// launch, not the bytes, sets its time.
//
// K26 replaces srsran_tpu/phy/upper/dmrs.py::map_to_grid (:198-234) on the
// DL: per-layer pilots of configuration type 1 (comb 2, ports 0-3) or type
// 2 (pairs {2g, 2g+1, 2g+6, 2g+7} per PRB, ports 0-5), with their w_f and
// w_t covers, on a contiguous or scattered (RA type 0, interleaved VRB)
// PRB set, precoded by the port's matrix or the RE's PRG matrix, added at
// the CDM group's subcarriers.  Twin:
// srsran_tpu_torch/ops/dl_rs.py::dmrs_map_ref.
//
// Design.  One thread per (slot, DM-RS symbol, allocated PRB, subcarrier
// pair (kk, kk + 1), kk even), over every port: both REs of a pair share
// what the thread needs.  In type 1 the pair holds one RE of CDM group 0
// and one of group 1, both at pilot m = 6 j + kk / 2 of the allocation's
// pilots (j the PRB's rank); in type 2 both REs belong to group (kk mod 6)
// / 2, at pilots m = 4 j + 2 (kk >= 6) and m + 1 (a thread whose group no
// layer uses returns at once).  The pilots are the allocated PRBs'
// columns of the Gold sequence, selected on the host (JAX
// dmrs.py::_prb_pilot_select).  Symbol and slot are blockIdx.y and
// blockIdx.z, the PRB rank the pair index over the compile-time 6; a
// contiguous allocation's PRB is prb0 + j in closed form, a scattered one
// (RA type 0, interleaved VRBs) reads its PRB table once.  Everything else
// comes by value in DmrsMapParams: the DM-RS symbols, the layers' ports
// byte-packed, the type, the PRG size and base.  The thread loads its one
// or two pilots and the precoder entries it needs (the one [P, L] matrix,
// or its PRB's row of the PRG table counted from the PRG of the first
// allocated PRB, through L1; the matrix is a device tensor of the slot
// context, so it cannot ride in the struct without a host sync), then each
// port's pair as one 16-byte load, adds for each RE, in layer order, the
// layers of its CDM group (W[p, l] x pilot_l with w_f = -1 on odd pilots
// for odd ports, w_t = +1; without a matrix layer l on port l alone), and
// stores the pair as one 16-byte store.  Layers of one CDM group share REs,
// so an RE holds ((g + w0 p0) + w1 p1) as in the JAX package, which adds
// layer after layer; products and sums are rounded one by one (__fmul_rn /
// __fadd_rn), as the twin rounds them.  32-bit offsets (the wrapper
// refuses more than 2^31 elements), no runtime division but a PRG size
// that is no power of two.  One build per precoder form and port count (up
// to 4 or 8): on an H100 a build holding every form's code ran 0.15-0.25
// us slower a launch (its code fetched cold), and a thread per (pair,
// port, symbol) ran no faster, and 0.4 us slower over a batch of 4.
//
// Bounds on this card: bytes -- the DM-RS REs of every port read and
// written once (4 ports x 2 symbols x 3,276 subcarriers at the flagship),
// the base pilots, the PRB table and the matrices read once.
//
// A slot axis (the slot-batch mode): K25's blockIdx.y, K26's blockIdx.z
// picks the slot; the grid lies at a fixed per-slot stride, each value
// source (K25) or pilot set and matrix (K26) at its own (0: one set shared
// by every slot); the plans are shared.

#include <cuda_runtime.h>
#include <stdint.h>

// The value sources, passed by value (outside the unnamed namespace: the
// C entry point takes it, and must keep external linkage).
constexpr int kMaxSources = 32;

struct RsSources {
  const float2* ptr[kMaxSources];
  long long stride[kMaxSources];        // complex values per slot (0: shared)
};

constexpr int kMaxLayers = 4;
constexpr int kMaxDmrsSymbols = 4;

// K26's launch, by value (srsran_tpu_torch/kernels/_build.py
// DmrsMapParams): the grid [nslots, P, S, K]; the allocation's nprb PRBs
// (prb0 + j when contiguous, else the PRB table) and their npairs = 6 nprb
// subcarrier pairs; L layers on the DM-RS ports byte-packed in ports
// (layer 0 lowest); type2 0 for configuration type 1, 1 for type 2; wkind
// 0 (no matrix: layer l on port l), 1 (one [P, L] matrix) or 2 (a PRG
// table [G, P, L], PRG (prb >> prg_shift, or prb / prg_size when
// prg_shift < 0) - prg_base); npil pilots a DM-RS symbol; the pilots' and
// the matrices' complex elements a slot (0: shared); the DM-RS symbols
// (-1 past the last).
struct DmrsMapParams {
  int nslots, P, S, K, nprb, npairs, L, ports, type2, prb0, contiguous,
      wkind, prg_shift, prg_size, prg_base, npil, pilot_stride, w_stride;
  int symbols[kMaxDmrsSymbols];
};

namespace {

constexpr int kDmrsMaxPorts = 8;
constexpr int kDmrsThreads = 64;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__global__ void rs_map_kernel(RsSources src, const long long* __restrict__ tgt,
                              const int* __restrict__ start,
                              const int* __restrict__ term_src,
                              const int* __restrict__ term_idx,
                              const float2* __restrict__ w, int ntgt,
                              float2* __restrict__ grid,
                              long long grid_stride) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ntgt) return;
  const long long slot = blockIdx.y;
  float2* g = grid + slot * grid_stride + tgt[t];
  float2 acc = *g;
  for (int j = start[t]; j < start[t + 1]; ++j) {
    const int s = term_src[j];
    const float2 v = src.ptr[s][slot * src.stride[s] + term_idx[j]];
    acc = cadd(acc, cmul(v, w[j]));
  }
  *g = acc;
}

__device__ __forceinline__ float2 neg(float2 a) {
  return make_float2(-a.x, -a.y);
}

// NP: the ports the build holds in registers (4, or kDmrsMaxPorts); WK:
// the precoder's form (DmrsMapParams::wkind)
template <int NP, int WK>
__global__ void __launch_bounds__(kDmrsThreads)
dmrs_map_kernel(float2* __restrict__ grid, const float2* __restrict__ pilots,
                const float2* __restrict__ w, const int* __restrict__ prbs,
                const DmrsMapParams p) {
  const int t = blockIdx.x * kDmrsThreads + threadIdx.x;
  if (t >= p.npairs) return;
  const int si = blockIdx.y, b = blockIdx.z;
  const int j = (unsigned)t / 6u, q = t - 6 * j;   // PRB rank, pair
  // the pair's CDM groups and pilot indices
  const int g0 = p.type2 ? (q >= 3 ? q - 3 : q) : 0;
  const int g1 = p.type2 ? g0 : 1;
  const int m0 = p.type2 ? 4 * j + ((q >= 3) << 1) : 6 * j + q;
  bool any = false;
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l)
    if (l < p.L) {
      const int g = (p.ports >> (8 * l + 1)) & 0x7f;
      any |= g == g0 || g == g1;
    }
  if (!any) return;                               // type 2: no layer here

  // Every load of the thread before the grid's: its pilots, its precoder
  // entries, its PRB.
  const float2* pv = pilots + b * p.pilot_stride + si * p.npil + m0;
  const float2 pv0 = __ldg(pv);
  const float2 pv1 = p.type2 ? __ldg(pv + 1) : pv0;
  const int prb = p.contiguous ? p.prb0 + j : __ldg(prbs + j);
  const float2* wr = w + b * p.w_stride;
  if (WK == 2)
    wr += ((p.prg_shift >= 0 ? prb >> p.prg_shift : prb / p.prg_size) -
           p.prg_base) * p.P * p.L;
  float2 wv[NP][kMaxLayers];
  if (WK)
#pragma unroll
    for (int o = 0; o < NP; ++o)
#pragma unroll
      for (int l = 0; l < kMaxLayers; ++l)
        if (o < p.P && l < p.L) wv[o][l] = __ldg(wr + o * p.L + l);
  const int sym = si == 0 ? p.symbols[0] : si == 1 ? p.symbols[1]
                : si == 2 ? p.symbols[2] : p.symbols[3];
  float2* gp = grid + ((b * p.P) * p.S + sym) * p.K + 12 * prb + 2 * q;
  const int pstride = p.S * p.K;
  float4 v[NP];
#pragma unroll
  for (int o = 0; o < NP; ++o)
    if (o < p.P && (WK || o < p.L))
      v[o] = *reinterpret_cast<const float4*>(gp + o * pstride);

  // Each layer's covered pilot on each RE of the pair (w_f = -1 on odd
  // pilots for odd ports; m0 is odd only in type 1, m0 + 1 always).
  float2 x0[kMaxLayers], x1[kMaxLayers];
  bool a0[kMaxLayers], a1[kMaxLayers];
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l) {
    const int port = (p.ports >> (8 * l)) & 0xff;
    a0[l] = l < p.L && (port >> 1) == g0;
    a1[l] = l < p.L && (port >> 1) == g1;
    const bool odd = port & 1;
    x0[l] = odd && (m0 & 1) ? neg(pv0) : pv0;
    x1[l] = odd && (p.type2 || (m0 & 1)) ? neg(pv1) : pv1;
  }
#pragma unroll
  for (int o = 0; o < NP; ++o) {
    if (o >= p.P || (!WK && o >= p.L)) continue;
    float2 acc0 = make_float2(v[o].x, v[o].y);
    float2 acc1 = make_float2(v[o].z, v[o].w);
#pragma unroll
    for (int l = 0; l < kMaxLayers; ++l) {
      if (WK) {
        if (a0[l]) acc0 = cadd(acc0, cmul(wv[o][l], x0[l]));
        if (a1[l]) acc1 = cadd(acc1, cmul(wv[o][l], x1[l]));
      } else if (l == o) {
        if (a0[l]) acc0 = cadd(acc0, x0[l]);
        if (a1[l]) acc1 = cadd(acc1, x1[l]);
      }
    }
    *reinterpret_cast<float4*>(gp + o * pstride) =
        make_float4(acc0.x, acc0.y, acc1.x, acc1.y);
  }
}

}  // namespace

extern "C" int srsran_rs_map(RsSources src, void* tgt, void* start,
                             void* term_src, void* term_idx, void* w,
                             int ntgt, void* grid, long long grid_stride,
                             int nslots, void* stream) {
  if (nslots < 1) return (int)cudaErrorInvalidValue;
  if (ntgt == 0) return 0;
  const int threads = 128;
  const dim3 blocks((ntgt + threads - 1) / threads, nslots);
  rs_map_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      src, (const long long*)tgt, (const int*)start, (const int*)term_src,
      (const int*)term_idx, (const float2*)w, ntgt, (float2*)grid,
      grid_stride);
  return (int)cudaGetLastError();
}

// For `nslots` slots of grid c64 [nslots, P, S, K] (DmrsMapParams; 16-byte
// aligned, K even), in place: pilots c64 [(nslots,) S_dmrs, npil], w null,
// one [(nslots,) P, L] matrix or a PRG table [(nslots,) G, P, L], the PRB
// table int32 [nprb] (read only when not contiguous).
extern "C" int srsran_dmrs_map(void* grid, const void* pilots, const void* w,
                               void* stream, const void* params,
                               const void* prbs) {
  const DmrsMapParams* p = (const DmrsMapParams*)params;
  if (p->L < 1 || p->L > kMaxLayers || p->S < 1 || p->nprb < 1 ||
      p->npairs != 6 * p->nprb || p->P < 1 || p->P > kDmrsMaxPorts ||
      p->nslots < 1 || p->wkind < 0 || p->wkind > 2 || (p->K & 1) ||
      (p->wkind == 0 && p->L > p->P) || (p->wkind && w == nullptr) ||
      (p->wkind == 2 && p->prg_shift < 0 && p->prg_size < 1))
    return (int)cudaErrorInvalidValue;
  int nsym = 0;
  while (nsym < kMaxDmrsSymbols && p->symbols[nsym] >= 0) ++nsym;
  if (nsym < 1) return (int)cudaErrorInvalidValue;
  const dim3 blocks((p->npairs + kDmrsThreads - 1) / kDmrsThreads, nsym,
                    p->nslots);
  // a build for up to 4 ports (the flagship's) and one for up to 8 (twice
  // the registers for the matrix and the pairs), each for one precoder
  // form: the build that held every form's code ran 0.15-0.25 us slower a
  // launch on an H100 (launch_profile --cases dmrs_map)
  using Kernel = void (*)(float2*, const float2*, const float2*, const int*,
                          const DmrsMapParams);
  const Kernel forms[2][3] = {
      {dmrs_map_kernel<4, 0>, dmrs_map_kernel<4, 1>, dmrs_map_kernel<4, 2>},
      {dmrs_map_kernel<kDmrsMaxPorts, 0>, dmrs_map_kernel<kDmrsMaxPorts, 1>,
       dmrs_map_kernel<kDmrsMaxPorts, 2>}};
  forms[p->P > 4][p->wkind]<<<blocks, kDmrsThreads, 0,
                              (cudaStream_t)stream>>>(
      (float2*)grid, (const float2*)pilots, (const float2*)w,
      (const int*)prbs, *p);
  return (int)cudaGetLastError();
}
