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
// included) and SSBs of a DL slot; a slot with more takes one launch for
// every kMaxPdus PDUs, in plan order (ops/dl_control.py::control_map).
// The host plan (ops/dl_control.py::_control_params, once per call
// signature) lists every grid RE that a PDU of the launch adds to, once:
// its offset in the [S, K] plane, its first value source (a data symbol,
// a pilot or a constant of the SSB's base patch) with that PDU's ports
// (port 0 or all), further sources of other PDUs at the same RE in plan
// order (rare: overlapping PDUs), and whether a PDU adds a zero there (a
// hole of its patch rectangle, on port 0 or on every port).  The twins
// add each PDU's dense rectangle in plan order; adding +0.0 maps -0.0 to
// +0.0 and leaves every other value as it is, so it commutes with any add
// and a second one changes nothing: one +0.0 after the RE's values keeps
// the result bit-equal to the dense adds, without a thread per hole and
// PDU.  The REs go in tiles of kThreads, one CTA per (tile, slot), a
// thread per RE with all its ports, so an AL8 PDCCH and an SSB spread over
// several SMs and every RE still has one writer.
//
// A thread loads its RE's entry, then -- before the payload is packed --
// the sources it needs: the RE's two rows of the fused map (stored by
// output bit and interleaved, I and Q word by word, 16 bytes at a time;
// the map's constant bit folded in as row bit A, against a payload bit
// fixed at 1), a pilot or a base value, and the grid RE on up to four
// ports.  Meanwhile the CTA packs the payload of each PDU its tile reads
// (a 16-bit mask from the plan), one warp per 32-bit word: lane j loads
// bit 32 w + j (the SSB's slot-context form XORs its two context parts)
// and __ballot_sync forms the word.  After one barrier a data RE's two
// coded bits are popc(payload & row) & 1, mapped to QPSK as the JAX code
// does ((1 - 2b) x float32(1/sqrt 2), times the amplitude), and the value
// is added into every port from registers.  Sums and products are rounded
// one by one (__fadd_rn / __fmul_rn), as the twins round them.
//
// Bounds on this card: bytes -- each written RE of each port read and
// written once, the maps (E x W words) and the payloads read once; the
// GF(2) work is 2 W AND-and-popcount per coded bit.  An AL8 PDCCH is 864
// coded bits, the PBCH 864: the launch and one chain of dependent loads
// set the time.
//
// A slot axis (the slot-batch mode): blockIdx.y picks the slot; the grid,
// each payload and each pilot vector lie at their own per-slot strides (0:
// shared); the plan's tables are shared.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxPdus = 16;
constexpr int kMaxWords = 8;            // payload bits + 1 <= 256
constexpr int kPtrsPerPdu = 4;          // bits0, bits1, bits2, pilots
constexpr int kThreads = 128;           // REs per tile (one CTA)

// One PDU of a launch (outside the unnamed namespace: the C entry point
// takes it by address, and must keep external linkage).  The pointers
// are the call's; the rest is the plan's.
struct ControlPdu {
  const int8_t* bits0;        // payload (the DCI, or the MIB)
  const int8_t* bits1;        // SSB slot context: timing bits
  const int8_t* bits2;        //   and the first-scrambling mask
  const float2* pilots;       // PDCCH DM-RS values (else null)
  long long stride0, stride1, stride2, pilot_stride;   // per slot
  int n0, n1;                 // payload bits, context bits
  int words;                  // words of a packed row: 1, 2, 4 or 8
  float amplitude;
};

struct ControlArgs {
  ControlPdu pdu[kMaxPdus];
  int npdus, nitems, ntiles, nslots;
  int P, S, K;
  float qpsk;                 // float32(1 / sqrt 2)
  long long grid_stride;      // per slot
};

// The plan's launch: the kernel's arguments and, per PDU, which entry of
// the call's pointer array fills bits0, bits1, bits2 and pilots (-1: none).
struct ControlParams {
  ControlArgs args;
  int ptr[kMaxPdus][kPtrsPerPdu];
};

namespace {

// An RE's entry (int4): x its offset l * K + k in the [S, K] plane; y its
// first source (bits 0-1 the kind, 2-5 the PDU, 6 every port, 8-11 the
// PDU's words); z bit 0 a zero added on port 0, bit 1 a zero added on
// every port, bit 2 the RE spans every port, bits 3-7 the count of
// further sources and bits 8-31 the first of them (after the nitems REs;
// their y and w as an RE's); w the source's argument: a data RE's first
// row word, a pilot's index or a base value's index.
constexpr int kData = 1, kPilot = 2, kConst = 3;

__device__ __forceinline__ float2 add(float2 o, float2 v) {
  return make_float2(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y));
}

// The RE's two rows of the fused map, I and Q interleaved word by word:
// (W + 1) / 2 loads of 16 bytes.
__device__ __forceinline__ void load_rows(const uint32_t* __restrict__ rows,
                                          int first, int words,
                                          uint4 (&r)[4]) {
  const uint4* p = reinterpret_cast<const uint4*>(rows + first);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    r[c] = c < (words + 1) / 2 ? __ldg(p + c) : make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ uint32_t word_of(const uint4 (&r)[4], int k) {
  const uint4 v = r[k >> 2];            // k is a constant once unrolled
  return (k & 3) == 0 ? v.x : (k & 3) == 1 ? v.y : (k & 3) == 2 ? v.z : v.w;
}

// popc(payload & row) & 1 for the I and the Q row: the QPSK symbol.
__device__ __forceinline__ float2 data_value(const uint32_t* pay, int words,
                                             const uint4 (&r)[4], float q,
                                             float amplitude) {
  int a0 = 0, a1 = 0;
#pragma unroll
  for (int i = 0; i < kMaxWords; ++i) {
    if (i < words) {
      const uint32_t p = pay[i];
      a0 += __popc(p & word_of(r, 2 * i));
      a1 += __popc(p & word_of(r, 2 * i + 1));
    }
  }
  return make_float2(__fmul_rn((a0 & 1) ? -q : q, amplitude),
                     __fmul_rn((a1 & 1) ? -q : q, amplitude));
}

__device__ __forceinline__ float2 pilot_value(const ControlPdu& d,
                                              long long slot, int j) {
  const float2 v = d.pilots[slot * d.pilot_stride + j];
  return make_float2(__fmul_rn(v.x, d.amplitude), __fmul_rn(v.y, d.amplitude));
}

// A further source's value, its loads made here (the rare path).
__device__ float2 source_value(const ControlArgs& a, int y, int w,
                               long long slot, const uint32_t* pay,
                               const uint32_t* __restrict__ rows,
                               const float2* __restrict__ consts) {
  const int kind = y & 3;
  const int u = (y >> 2) & 15;
  if (kind == kData) {
    uint4 r[4];
    const int words = (y >> 8) & 15;
    load_rows(rows, w, words, r);
    return data_value(pay + u * kMaxWords, words, r, a.qpsk,
                      a.pdu[u].amplitude);
  }
  if (kind == kPilot) return pilot_value(a.pdu[u], slot, w);
  return consts[w];
}

__global__ void __launch_bounds__(kThreads)
control_map_kernel(ControlArgs a, float2* __restrict__ grid,
                   const int4* __restrict__ items,
                   const uint32_t* __restrict__ rows,
                   const float2* __restrict__ consts,
                   const int* __restrict__ tiles) {
  __shared__ uint32_t pay[kMaxPdus * kMaxWords];
  const long long slot = blockIdx.y;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const bool live = t < a.nitems;
  const int mask = tiles[blockIdx.x];

  // 1. The RE's entry and its sources, ahead of the payload.
  int4 it = make_int4(0, 0, 0, 0);
  if (live) it = __ldg(items + t);
  const int kind = it.y & 3;
  const int u = (it.y >> 2) & 15;
  const int words = (it.y >> 8) & 15;
  const int nports = (it.z & 4) ? a.P : 1;
  const long long plane = (long long)a.S * a.K;
  float2* gp = grid + slot * a.grid_stride + it.x;
  uint4 r[4];
  float2 src = make_float2(0.f, 0.f);
  if (live && kind == kData) {
    load_rows(rows, it.w, words, r);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) r[c] = make_uint4(0, 0, 0, 0);
    if (live && kind == kPilot) src = pilot_value(a.pdu[u], slot, it.w);
    if (live && kind == kConst) src = __ldg(consts + it.w);
  }
  float2 g[4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
    g[p] = live && p < nports ? gp[p * plane] : make_float2(0.f, 0.f);

  // 2. The payloads of the tile's PDUs, a warp per word, by ballot; the
  //    map's constant bit (row bit n0 + n1) against a payload bit of 1.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int m = mask; m; m &= m - 1) {
    const int v = __ffs(m) - 1;
    const ControlPdu& d = a.pdu[v];
    for (int wd = warp; wd < d.words; wd += kThreads / 32) {
      const int b = 32 * wd + lane;
      int bit;
      if (b < d.n0) {
        bit = d.bits0[slot * d.stride0 + b];
      } else if (b < d.n0 + d.n1) {
        bit = d.bits1[slot * d.stride1 + b - d.n0]
              ^ d.bits2[slot * d.stride2 + b - d.n0];
      } else {
        bit = b == d.n0 + d.n1;
      }
      const uint32_t word = __ballot_sync(0xffffffffu, bit & 1);
      if (lane == 0) pay[v * kMaxWords + wd] = word;
    }
  }
  __syncthreads();
  if (!live) return;

  // 3. The value, added into every port it spans from registers; then
  //    the zero of a hole.
  const int extra = (it.z >> 3) & 31;
  const bool all = (it.y >> 6) & 1;
  const int z = it.z;
  if (extra == 0) {
    float2 v = src;
    if (kind == kData)
      v = data_value(pay + u * kMaxWords, words, r, a.qpsk,
                     a.pdu[u].amplitude);
    auto put = [&](float2 o, int p) {
      if (kind != 0 && (all || p == 0)) o = add(o, v);
      if ((z & 2) || ((z & 1) && p == 0)) o = add(o, make_float2(0.f, 0.f));
      gp[p * plane] = o;
    };
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if (p < nports) put(g[p], p);
    for (int p = 4; p < nports; ++p) put(gp[p * plane], p);
    return;
  }
  const int4* more = items + a.nitems + (z >> 8);
  for (int p = 0; p < nports; ++p) {
    float2 o = gp[p * plane];
    for (int s = 0; s <= extra; ++s) {
      const int y = s == 0 ? it.y : more[s - 1].y;
      const int w = s == 0 ? it.w : more[s - 1].w;
      if ((y & 3) != 0 && (((y >> 6) & 1) || p == 0))
        o = add(o, source_value(a, y, w, slot, pay, rows, consts));
    }
    if ((z & 2) || ((z & 1) && p == 0)) o = add(o, make_float2(0.f, 0.f));
    gp[p * plane] = o;
  }
}

}  // namespace

// grid complex64 [(B,) P, S, K] in place; ptrs the call's pointer array
// (host memory, read here: a captured graph keeps the values); params the
// plan's; items int4 [nitems + extras], rows uint32, consts float2 and
// tiles int32 [ntiles] its device tables.
extern "C" int srsran_control_map(void* grid, const void* pointers,
                                  void* stream, const void* plan,
                                  const void* items, const void* rows,
                                  const void* consts, const void* tiles) {
  const uint64_t* ptrs = (const uint64_t*)pointers;
  const ControlParams* params = (const ControlParams*)plan;
  if (params == nullptr || ptrs == nullptr) return (int)cudaErrorInvalidValue;
  ControlArgs a = params->args;
  if (a.npdus < 1 || a.npdus > kMaxPdus || a.nitems < 1 || a.ntiles < 1
      || a.ntiles != (a.nitems + kThreads - 1) / kThreads || a.nslots < 1)
    return (int)cudaErrorInvalidValue;
  for (int u = 0; u < a.npdus; ++u) {
    ControlPdu& d = a.pdu[u];
    if (d.words < 1 || d.words > kMaxWords || d.n0 + d.n1 >= 32 * d.words)
      return (int)cudaErrorInvalidValue;
    const int* ix = params->ptr[u];
    d.bits0 = ix[0] >= 0 ? (const int8_t*)ptrs[ix[0]] : nullptr;
    d.bits1 = ix[1] >= 0 ? (const int8_t*)ptrs[ix[1]] : nullptr;
    d.bits2 = ix[2] >= 0 ? (const int8_t*)ptrs[ix[2]] : nullptr;
    d.pilots = ix[3] >= 0 ? (const float2*)ptrs[ix[3]] : nullptr;
    if (d.bits0 == nullptr || (d.n1 > 0 && (!d.bits1 || !d.bits2)))
      return (int)cudaErrorInvalidValue;
  }
  control_map_kernel<<<dim3(a.ntiles, a.nslots), kThreads, 0,
                       (cudaStream_t)stream>>>(
      a, (float2*)grid, (const int4*)items, (const uint32_t*)rows,
      (const float2*)consts, (const int*)tiles);
  return (int)cudaGetLastError();
}
