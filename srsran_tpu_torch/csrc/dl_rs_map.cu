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
// DL: per-layer type-1 pilots (w_f, w_t covers), precoded by the port's
// matrix or the RE's PRG matrix, added at the comb.  Twin:
// srsran_tpu_torch/ops/dl_rs.py::dmrs_map_ref.
//
// Design.  One thread per (DM-RS symbol, subcarrier of the allocation,
// port).  The thread reads the grid value once and, for each layer whose
// CDM group occupies the subcarrier, in layer order, adds W[g][p, l] x
// pilot_l (W the one [P, L] matrix, g = 0, or the PRG table's matrix of
// the subcarrier's PRG); without a matrix, layer l goes to port l alone.
// Layers of one CDM group share REs, so an RE holds ((g + w0 p0) + w1 p1)
// as in the JAX package, which adds layer after layer.
//
// Bounds on this card: bytes -- the DM-RS REs of every port read and
// written once (4 ports x 2 symbols x 3,276 subcarriers at the flagship),
// the base pilots and the matrices read once.
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

// ports: the DM-RS port of each layer (0..3), 8 bits each, layer 0 lowest.
__global__ void dmrs_map_kernel(const float2* __restrict__ pilots,
                                long long pilot_stride, int npil,
                                const int* __restrict__ symbols, int nsym,
                                int ports, int L, const float2* __restrict__ w,
                                long long w_stride, int prg_size, int prg_base,
                                int rb_start, float2* __restrict__ grid,
                                int P, int S, int K) {
  const int span = 2 * npil;                       // 12 x rb_count
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nsym * span * P) return;
  const int p = i % P;
  const int kk = (i / P) % span;
  const int si = i / (P * span);
  const long long slot = blockIdx.y;
  const int k = rb_start * 12 + kk;                 // subcarrier
  const int m = kk >> 1;                            // pilot index on the comb
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
    if ((port >> 1) != (kk & 1)) continue;          // CDM group's comb
    if (wp == nullptr && l != p) continue;          // layer l -> port l
    float2 pv = pv_row[m];
    // w_f = (+1, -1) on odd pilots for ports 1 and 3; w_t = +1 for 0..3
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

extern "C" int srsran_dmrs_map(void* pilots, long long pilot_stride, int npil,
                               void* symbols, int nsym, int ports, int L,
                               void* w, long long w_stride, int prg_size,
                               int prg_base, int rb_start, void* grid, int P,
                               int S, int K, int nslots, void* stream) {
  if (L < 1 || L > kMaxLayers || nsym < 1 || nsym > kMaxDmrsSymbols
      || nslots < 1 || prg_size < 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)nsym * 2 * npil * P;
  if (n == 0) return 0;
  const int threads = 128;
  const dim3 blocks((unsigned)((n + threads - 1) / threads), nslots);
  dmrs_map_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float2*)pilots, pilot_stride, npil, (const int*)symbols, nsym,
      ports, L, (const float2*)w, w_stride, prg_size, prg_base, rb_start,
      (float2*)grid, P, S, K);
  return (int)cudaGetLastError();
}
