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
// Design.  One thread per (DM-RS symbol, allocated PRB, subcarrier of the
// PRB, port).  The PRB comes from a table of the allocation's PRBs
// (uploaded once per allocation; a contiguous one reads it too), and the
// pilot index from the PRB's rank in the table: the pilots are the
// allocated PRBs' columns of the Gold sequence, selected on the host (JAX
// dmrs.py::_prb_pilot_select).  The thread reads the grid value once and,
// for each layer whose CDM group (port >> 1 in both types) occupies the
// subcarrier, in layer order, adds W[g][p, l] x pilot_l (W the one [P, L]
// matrix, g = 0, or the PRG table's matrix of the subcarrier's PRG,
// counted from the PRG of the first allocated PRB); without a matrix,
// layer l goes to port l alone.  Layers of one CDM group share REs, so an
// RE holds ((g + w0 p0) + w1 p1) as in the JAX package, which adds layer
// after layer.
//
// Bounds on this card: bytes -- the DM-RS REs of every port read and
// written once (4 ports x 2 symbols x 3,276 subcarriers at the flagship),
// the base pilots, the PRB table and the matrices read once.
//
// A slot axis (the slot-batch mode): blockIdx.y picks the slot; the grid
// lies at a fixed per-slot stride, each value source at its own (0: one
// set shared by every slot); the plans are shared.

#include <cuda_runtime.h>
#include <stdint.h>

// The value sources, passed by value (outside the unnamed namespace: the
// C entry point takes it, and must keep external linkage).
constexpr int kMaxSources = 32;

struct RsSources {
  const float2* ptr[kMaxSources];
  long long stride[kMaxSources];        // complex values per slot (0: shared)
};

namespace {

constexpr int kMaxLayers = 4;
constexpr int kMaxDmrsSymbols = 4;

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

// ports: the DM-RS port of each layer (0..5), 8 bits each, layer 0 lowest.
// type2: 0 for configuration type 1 (6 pilots a PRB), 1 for type 2 (4).
__global__ void dmrs_map_kernel(const float2* __restrict__ pilots,
                                long long pilot_stride,
                                const int* __restrict__ symbols, int nsym,
                                int ports, int L, const float2* __restrict__ w,
                                long long w_stride, int prg_size, int prg_base,
                                const int* __restrict__ prbs, int nprb,
                                int type2, float2* __restrict__ grid, int P,
                                int S, int K) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nsym * nprb * 12 * P) return;
  const int p = i % P;
  const int kk = (i / P) % 12;                      // subcarrier in the PRB
  const int j = (i / (P * 12)) % nprb;              // rank of the PRB
  const int si = i / (P * 12 * nprb);
  const long long slot = blockIdx.y;
  const int k = prbs[j] * 12 + kk;                  // subcarrier
  const int per_rb = type2 ? 4 : 6;
  const int group = type2 ? (kk % 6) >> 1 : kk & 1; // CDM group at kk
  // the pilot index on the group's subcarriers of the allocation
  const int m = j * per_rb + (type2 ? ((kk >= 6) << 1) + (kk & 1) : kk >> 1);
  const int npil = per_rb * nprb;
  const float2* pv_row = pilots + slot * pilot_stride + (long long)si * npil;
  const float2* wp = nullptr;
  if (w != nullptr) {
    wp = w + slot * w_stride;
    if (prg_size > 0) wp += (long long)(k / 12 / prg_size - prg_base) * P * L;
  }
  float2* gp = grid + slot * (long long)P * S * K
               + ((long long)p * S + symbols[si]) * K + k;
  float2 acc = *gp;
  for (int l = 0; l < L; ++l) {
    const int port = (ports >> (8 * l)) & 0xff;
    if ((port >> 1) != group) continue;             // the CDM group's REs
    if (wp == nullptr && l != p) continue;          // layer l -> port l
    float2 pv = pv_row[m];
    // w_f = (+1, -1) on odd pilots for odd ports; w_t = +1 for every port
    if ((port & 1) && (m & 1)) pv = make_float2(-pv.x, -pv.y);
    acc = cadd(acc, wp == nullptr ? pv : cmul(wp[p * L + l], pv));
  }
  *gp = acc;
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

extern "C" int srsran_dmrs_map(void* pilots, long long pilot_stride,
                               void* symbols, int nsym, int ports, int L,
                               void* w, long long w_stride, int prg_size,
                               int prg_base, void* prbs, int nprb,
                               int config_type, void* grid, int P, int S,
                               int K, int nslots, void* stream) {
  if (L < 1 || L > kMaxLayers || nsym < 1 || nsym > kMaxDmrsSymbols
      || nslots < 1 || prg_size < 0 || nprb < 1
      || (config_type != 1 && config_type != 2))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)nsym * nprb * 12 * P;
  const int threads = 128;
  const dim3 blocks((unsigned)((n + threads - 1) / threads), nslots);
  dmrs_map_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float2*)pilots, pilot_stride, (const int*)symbols, nsym, ports,
      L, (const float2*)w, w_stride, prg_size, prg_base, (const int*)prbs,
      nprb, config_type == 2, (float2*)grid, P, S, K);
  return (int)cudaGetLastError();
}
