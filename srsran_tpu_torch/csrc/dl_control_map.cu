// K27: DL control map -- the PDCCH and PBCH bit chains as GF(2) affine
// maps, QPSK, and the PDCCH / SS-PBCH patches added to the grid, for
// Hopper.
//
// Replaces srsran_tpu/phy/upper/pdcch.py::process (:283-307) and
// srsran_tpu/phy/upper/ssb.py::ssb_block + map_ssb_to_grid (:298-341).
// Each JAX function computes its whole bit chain (CRC, polar encode, rate
// match, scrambling) as one product payload @ M ^ const over GF(2), maps
// the coded bits to QPSK and adds a dense patch -- QPSK symbols, pilots,
// and for the SSB the PSS and SSS -- into the grid: the PDCCH's on port 0,
// the SSB's on every port.  Twins: srsran_tpu_torch/phy/upper/pdcch.py::
// process_ref and srsran_tpu_torch/phy/upper/ssb.py::map_ssb_to_grid_ref.
//
// Design.  One launch covers up to kMaxPdus PDCCHs (the UL DCIs'
// included) and SSBs of a DL slot -- a slot with more takes one launch
// for every kMaxPdus PDUs, in plan order (ops/dl_control.py::control_map)
// -- with a CTA per group of PDUs whose patches overlap (in practice a
// CTA per PDU), which runs its PDUs in plan order, so every RE has one
// writer and sums in the JAX order.  The fused map is stored by
// output bit, bit-packed (uint32 [E, W], W = ceil(A / 32); the PBCH's
// [864, 2]) and uploaded once per map key; the CTA packs the payload 32
// bits to a word into shared memory (for the SSB's slot-context form, the
// MIB then its timing bits XOR the scrambling mask), and a thread per
// patch RE and port forms the RE's two coded bits as popc(payload & row)
// & 1 ^ const, maps them to QPSK as the JAX code does ((1 - 2b) x
// float32(1/sqrt 2), times the amplitude), and adds the value at the RE.
// Pilot REs take host-built values (the PDCCH DM-RS from the slot context,
// times the amplitude); the rest of the patch, its base, is zero for the
// PDCCH and PSS, SSS and PBCH DM-RS for the SSB.  Sums and products are
// rounded one by one (__fadd_rn / __fmul_rn), as the twins round them.
//
// Bounds on this card: bytes -- each patch RE of each port read and
// written once, the maps (E x W words) and the payloads read once; the
// GF(2) work is 2 W AND-and-popcount per coded bit.  An AL8 PDCCH is 864
// coded bits, the PBCH 864: the launch sets the time.
//
// A slot axis (the slot-batch mode): blockIdx.y picks the slot; the grid,
// each payload and each pilot or context vector lie at their own per-slot
// strides (0: shared); the maps and patch plans are shared.

#include <cuda_runtime.h>
#include <stdint.h>

// The launch's PDU table, passed by value (outside the unnamed namespace:
// the C entry point takes it, and must keep external linkage).
constexpr int kMaxPdus = 16;
constexpr int kMaxWords = 8;            // payload bits <= 256

struct ControlPdu {
  const int8_t* bits0;        // payload (the DCI, or the MIB)
  const int8_t* bits1;        // SSB slot context: timing bits
  const int8_t* bits2;        //   and the first-scrambling mask
  const float2* pilots;       // PDCCH DM-RS values (else null)
  const uint32_t* rows;       // [E, words]: row e's bits of M[:, e]
  const int* offset;          // [E] the map's constant bit
  const int* index;           // [h * w] 0 base, 1 + k data k, 1 + nd + j pilot j
  const float2* base;         // [h * w] base patch (null: zeros)
  long long stride0, stride1, stride2, pilot_stride;   // per slot
  int n0, n1, words, nd;      // payload bits, context bits, words, data REs
  int l0, sc0, h, w;          // patch rectangle
  int all_ports;              // SSB: every port; PDCCH: port 0
  float amplitude;
};

struct ControlArgs {
  ControlPdu pdu[kMaxPdus];
  int group_start[kMaxPdus + 1];
  float qpsk;                 // float32(1 / sqrt 2)
};

namespace {

__device__ __forceinline__ int coded_bit(const uint32_t* words,
                                         const uint32_t* row, int nw,
                                         int offset) {
  int acc = 0;
  for (int i = 0; i < nw; ++i) acc += __popc(words[i] & row[i]);
  return (acc & 1) ^ (offset & 1);
}

__global__ void control_map_kernel(ControlArgs a, float2* __restrict__ grid,
                                   int P, int S, int K,
                                   long long grid_stride) {
  __shared__ uint32_t words[kMaxWords];
  const long long slot = blockIdx.y;
  float2* g = grid + slot * grid_stride;
  for (int u = a.group_start[blockIdx.x]; u < a.group_start[blockIdx.x + 1];
       ++u) {
    const ControlPdu& d = a.pdu[u];
    if (threadIdx.x < d.words) {
      uint32_t word = 0;
      for (int j = 0; j < 32; ++j) {
        const int b = 32 * threadIdx.x + j;
        int bit = 0;
        if (b < d.n0) {
          bit = d.bits0[slot * d.stride0 + b];
        } else if (b < d.n0 + d.n1) {
          bit = d.bits1[slot * d.stride1 + b - d.n0]
                ^ d.bits2[slot * d.stride2 + b - d.n0];
        }
        word |= (uint32_t)(bit & 1) << j;
      }
      words[threadIdx.x] = word;
    }
    __syncthreads();
    const int nre = d.h * d.w;
    const int nports = d.all_ports ? P : 1;
    for (int r = threadIdx.x; r < nre * nports; r += blockDim.x) {
      const int re = r % nre;
      const int p = r / nre;
      const int idx = d.index[re];
      float2 v;
      if (idx == 0) {
        v = d.base != nullptr ? d.base[re] : make_float2(0.f, 0.f);
      } else if (idx <= d.nd) {
        const int e = 2 * (idx - 1);
        const int b0 = coded_bit(words, d.rows + (long long)e * d.words,
                                 d.words, d.offset[e]);
        const int b1 = coded_bit(words, d.rows + (long long)(e + 1) * d.words,
                                 d.words, d.offset[e + 1]);
        v = make_float2(__fmul_rn(b0 ? -a.qpsk : a.qpsk, d.amplitude),
                        __fmul_rn(b1 ? -a.qpsk : a.qpsk, d.amplitude));
      } else {
        const float2 pv =
            d.pilots[slot * d.pilot_stride + (idx - 1 - d.nd)];
        v = make_float2(__fmul_rn(pv.x, d.amplitude),
                        __fmul_rn(pv.y, d.amplitude));
      }
      float2* gp = g + ((long long)p * S + d.l0 + re / d.w) * K + d.sc0
                   + re % d.w;
      const float2 o = *gp;
      *gp = make_float2(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y));
    }
    __syncthreads();          // the next PDU of the group may share REs
  }
}

}  // namespace

extern "C" int srsran_control_map(ControlArgs args, int ngroups, void* grid,
                                  int P, int S, int K, long long grid_stride,
                                  int nslots, void* stream) {
  if (ngroups < 0 || ngroups > kMaxPdus || nslots < 1)
    return (int)cudaErrorInvalidValue;
  for (int u = 0; u < args.group_start[ngroups]; ++u)
    if (args.pdu[u].words > kMaxWords) return (int)cudaErrorInvalidValue;
  if (ngroups == 0) return 0;
  control_map_kernel<<<dim3(ngroups, nslots), 256, 0,
                       (cudaStream_t)stream>>>(args, (float2*)grid, P, S, K,
                                               grid_stride);
  return (int)cudaGetLastError();
}
