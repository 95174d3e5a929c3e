// K25: DL reference-signal map (NZP-CSI-RS, PT-RS, PRS) and K26: DL DM-RS
// map, for Hopper.
//
// K25 replaces srsran_tpu/phy/upper/csi_rs.py::process (:219),
// srsran_tpu/phy/upper/ptrs_prs.py::map_ptrs (:94) and ::map_prs (:170):
// sequence values, CDM-covered and weighted by the CSI-RS precoder, added
// to the grid at planned (port, symbol, subcarrier) targets.  Twin:
// srsran_tpu_torch/ops/dl_rs.py::rs_map_ref.
//
// Design.  The host builds, once per plan key, a plan grouped by target
// RE (ops/dl_rs.py::rs_plan: each target's terms -- value source, value
// index, complex weight = CDM cover x precoder entry -- in the JAX
// package's summation order), then sorts the targets by descending term
// count (stable) and writes one 16-byte record per term
// (ops/dl_rs.py::rs_records): {the target's offset within a slot's grid,
// source << kRsIndexBits | value index, the weight as float2}, term-major
// -- all rank-0 records, then all rank-1 records, ... -- so that rank r
// covers a prefix [0, n_r) of the targets; the n_r and each rank's first
// record ride by value (RsMapParams).  One thread per target issues its
// record loads at entry, then its grid load and its value loads together,
// then one store: two dependent round trips, where a target list with a
// start[] indirection and 64-bit offsets took four.  A target has one
// writer, so there are no atomics, and a target that several CSI-RS
// ports reach through a precoder (or that several PDUs share) sums grid +
// term 0 + term 1 + ... in the reference's order; products and sums are
// rounded one by one (__fmul_rn / __fadd_rn), as the twin rounds them.
// Missing terms are not padded with zero weights (-0.0 + 0 v is +0.0).
// The values of up to kMaxSources PDUs ride in the launch's arguments:
// their pointers, from the call's host array, and their per-slot strides.
// A slot with more RS PDUs takes one launch for every kMaxSources of them,
// in PDU order (ops/dl_rs.py::rs_map): a target's terms follow the PDUs'
// order, so the sums round as in one launch.  One build per rank bound (1,
// 2, 4 or kRsMaxRanks), so that a slot whose targets have one term runs
// no code for a second.  32-bit offsets: the wrapper refuses a grid of
// 2^31 elements or more.
//
// Bounds on this card: bytes -- each target's grid value read and
// written once, its terms' records and values read once.  A flagship
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
// by every slot); the plans and records are shared.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxSources = 32;
constexpr int kRsMaxRanks = 16;
constexpr int kRsIndexBits = 27;

// K25's launch, by address (srsran_tpu_torch/kernels/_build.py
// RsMapParams): ntgt targets, sorted by descending term count; nslots
// slots of grid_stride complex values; nranks term ranks, rank r covering
// targets [0, rank_n[r]) with its records from rank_base[r]; nsrc value
// sources, each stride complex values a slot (0: shared by every slot).
struct RsMapParams {
  int ntgt, nslots, grid_stride, nranks, nsrc;
  int rank_n[kRsMaxRanks];
  int rank_base[kRsMaxRanks];
  int stride[kMaxSources];
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

// The kernel's arguments, by value: the sources' pointers and the launch.
struct RsArgs {
  const float2* ptr[kMaxSources];
  RsMapParams p;
};

constexpr int kRsThreads = 128;

// NR: the build's bound on the term ranks (RsMapParams::nranks <= NR).
// The arguments are a __grid_constant__: a source's pointer and stride,
// indexed by the record, load from the parameter bank, with no copy of
// the struct into local memory.
template <int NR>
__global__ void __launch_bounds__(kRsThreads)
rs_map_kernel(const __grid_constant__ RsArgs a, const int4* __restrict__ rec,
              float2* __restrict__ grid) {
  const int t = blockIdx.x * kRsThreads + threadIdx.x;
  if (t >= a.p.ntgt) return;              // rank 0 covers every target
  const int slot = blockIdx.y;
  int4 q[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r)
    if (r == 0 || (r < a.p.nranks && t < a.p.rank_n[r]))
      q[r] = __ldg(rec + a.p.rank_base[r] + t);
  float2* g = grid + slot * a.p.grid_stride + q[0].x;
  float2 acc = *g;
  float2 v[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r)
    if (r == 0 || (r < a.p.nranks && t < a.p.rank_n[r])) {
      const unsigned word = (unsigned)q[r].y;
      const int s = word >> kRsIndexBits;
      v[r] = __ldg(a.ptr[s] + slot * a.p.stride[s] +
                   (int)(word & ((1u << kRsIndexBits) - 1u)));
    }
#pragma unroll
  for (int r = 0; r < NR; ++r)
    if (r == 0 || (r < a.p.nranks && t < a.p.rank_n[r]))
      acc = cadd(acc, cmul(v[r], make_float2(__int_as_float(q[r].z),
                                             __int_as_float(q[r].w))));
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

// For `nslots` slots of grid c64 [nslots, P, S, K] (RsMapParams), in
// place: `pointers` a host array of the nsrc value sources' device
// pointers; the plan's records int4 [sum of rank_n] (16-byte aligned).
extern "C" int srsran_rs_map(void* grid, const void* pointers, void* stream,
                             const void* params, const void* records) {
  const RsMapParams* p = (const RsMapParams*)params;
  const uint64_t* ptrs = (const uint64_t*)pointers;
  if (p == nullptr || ptrs == nullptr || p->ntgt < 1 || p->nslots < 1 ||
      p->nranks < 1 || p->nranks > kRsMaxRanks || p->nsrc < 1 ||
      p->nsrc > kMaxSources || p->rank_n[0] != p->ntgt ||
      ((uintptr_t)records & 15))
    return (int)cudaErrorInvalidValue;
  RsArgs a;
  a.p = *p;
  for (int i = 0; i < kMaxSources; ++i)
    a.ptr[i] = i < p->nsrc ? (const float2*)ptrs[i] : nullptr;
  const dim3 blocks((p->ntgt + kRsThreads - 1) / kRsThreads, p->nslots);
  using Kernel = void (*)(const RsArgs, const int4*, float2*);
  const Kernel k = p->nranks <= 1   ? rs_map_kernel<1>
                   : p->nranks <= 2 ? rs_map_kernel<2>
                   : p->nranks <= 4 ? rs_map_kernel<4>
                                    : rs_map_kernel<kRsMaxRanks>;
  k<<<blocks, kRsThreads, 0, (cudaStream_t)stream>>>(
      a, (const int4*)records, (float2*)grid);
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
