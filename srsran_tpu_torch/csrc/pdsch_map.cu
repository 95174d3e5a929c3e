// K6: PDSCH map -- rate match, scramble, modulate, layer map, precode and
// grid add in one pass, for Hopper.
//
// Replaces srsran_tpu/ops/ldpc_rate_match.py::rate_match_batch (:132-156),
// ops/scrambling.py::scramble_bits (:15), ops/modulation.py::modulate
// (:45-64), ops/precoding.py::layer_map / precode (:16, :33) and the grid
// scatter-add of srsran_tpu/phy/upper/pdsch.py::process (:248-249).  Twin:
// srsran_tpu_torch/ops/dl_map.py::pdsch_map_ref.
//
// What bounds it.  Bytes: the window's distinct codeword bytes (G at the
// flagship, 1 MB), each data RE's grid value on every port read and
// written (2.1 MB) and the RE plan: about 3.4 MB, 1.02 us at 3.35 TB/s.  The former design ran a thread a RE that found its
// codeblock by a binary search over 64-bit offsets and then, for each of
// its L Qm bits (32 at the flagship), took a 64-bit modulo for the
// circular window, a scattered byte load and a load of the bit's Gold
// word: 10.1 us in the DL slot, a chain of instructions and latencies.
//
// Design: tiles of one codeblock.  Every E_r is a multiple of L Qm, so an
// RE's bits lie in one codeblock, and NR's E_r takes at most two values
// (TS 38.212 5.4.2.1): the first C0 codeblocks hold n0 REs each, the rest
// n1, all by value in the launch's struct.  blockIdx.y is the codeblock,
// blockIdx.x a tile of T <= 128 consecutive REs of it, a thread each, so
// the codeblock and the tile's first RE follow in closed form.  The
// codeblock's E bits are the window e(j) = w((k0' + j) mod N_nf) over its
// filler-free circular buffer; the Qm interleave puts bit b of its symbol
// row r at e(b E / Qm + r), and the tile's L T symbols are rows [r0 L, r0 L
// + L T).  So bit plane b of the tile is one contiguous run of L T window
// positions from (k0' + b E / Qm + r0 L) mod N_nf: that modulo (32-bit) is
// taken once per tile and stepped by E / Qm mod N_nf from plane to plane;
// within the run each byte only wraps at N_nf (a subtraction) and steps
// over the fillers [fs, fs + gap) (a compare).  The CTA stages its Qm runs
// of K5's int8 [C, N] codeblocks into shared memory a word of four
// entries a thread and plane: two aligned word loads and a funnel shift
// where the four lie in one stretch of the buffer, byte loads where a wrap
// or a filler edge falls among them; each thread issues all of its loads
// (and its RE's plan, Gold words and grid values) before it waits on the
// first.  Each thread then reads its own L bytes of every plane (one word
// at L = 4) and assembles its L symbols.  The Gold bits (c_init = (rnti <<
// 15) + n_id) are the plan's, packed 32 a word: an RE's L Qm <= 32 bits
// span two words at most, read once and aligned by one funnel shift.  The
// Qm / 2 bits of each axis index the Gray PAM level table
// (ops/modulation.py::pam_levels_scaled, by value, copied to shared
// memory).  The thread loads its grid values on every port with the
// staging (they arrive while the planes load), forms each port's sum over
// layers of W[p, l] x_l (one precoder's P L values in shared memory,
// copied by cp.async while the planes load; each product and sum rounded
// in the twin's order) and ADDS it into grid[p, l_sym, k_sc],
// neighbouring threads on neighbouring subcarriers: the grid may already
// hold the SSB there (the JAX program sums both); each (p, l, k) has one
// writer, so there are no atomics.  Registers are capped for 8 CTAs an SM
// (64, no spill): the flagship's 300 CTAs run in one wave, a batch of
// four's 1,200 in two.
//
// K22, per-PRG precoding (srsran_tpu/ops/precoding.py::precode_prg, :38,
// and srsran_tpu/phy/upper/pdsch.py:191-195, :239-258): the precoder is a
// table of G [P, L] matrices, and each RE takes its PRG's, g = k div 12 div
// prg_size - prg_base with prg_base = rb_start div prg_size (PRG boundaries
// aligned to CRB 0).  prg_size 0 means one matrix for every RE: with G = 1
// the arithmetic is K6's, bit for bit.  A tile of at most 128 REs spans a
// few PRGs, so its threads read their rows of the table through L1 (any
// table size; no copy of the whole table a CTA).  Twin:
// srsran_tpu_torch/ops/precoding.py::precode_prg, whose products and sums
// are rounded one by one in the kernel's order.
//
// A slot axis (the slot-batch mode): blockIdx.z picks the slot, whose
// encoded codeblocks and grid lie at fixed strides, and whose precoder
// table lies at w_stride (0: shared by every slot); the codeblock sizes,
// the Gold words (the c_init does not depend on the slot), the level table
// and the RE plan are shared.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dft_s_ofdm.cuh"

namespace {

constexpr int kMapThreads = 128;     // REs a tile at most, a thread each
constexpr int kMapMaxLayers = 4;
constexpr int kMapMaxPorts = 8;
constexpr int kMapMaxLevels = 16;    // PAM levels (256QAM)

// The launch, by value (srsran_tpu_torch/kernels/_build.py MapParams).
struct MapParams {
  int C, C0, n0, n1;    // codeblocks; the first C0 hold n0 REs, the rest n1
  int tiles, T;         // tiles a codeblock, REs a tile (<= kMapThreads)
  int N;                // a codeblock's bytes (K5's [C, N] rows)
  int fs, gap;          // the fillers [fs, fs + gap) of the circular buffer
  int n_nf, k0p;        // the filler-free length, the window's start in it
  int qm, L, P, S, K, nre;
  int prg_size, prg_base;   // K22's PRG size (0: one matrix), first PRG
  int w_stride;             // the precoder's complex values a slot (0:
                            // one for every slot)
  int nslots;               // the slots
  float levels[kMapMaxLevels];
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

template <int QM, int L>
__global__ void __launch_bounds__(kMapThreads, 8)
    pdsch_map_kernel(const int8_t* __restrict__ cw,
                     const int* __restrict__ sym, const int* __restrict__ sc,
                     const float2* __restrict__ w, float2* __restrict__ grid,
                     const __grid_constant__ MapParams p,
                     const uint32_t* __restrict__ gold) {
  constexpr int kPlane = kMapThreads * L;            // a plane's bytes
  __shared__ __align__(4) uint8_t s_bits[QM * kPlane];
  __shared__ float s_levels[kMapMaxLevels];
  __shared__ float2 s_w[kMapMaxPorts * kMapMaxLayers];   // one matrix
  const int tid = threadIdx.x;
  const int cb = blockIdx.y;
  const int n_cb = cb < p.C0 ? p.n0 : p.n1;
  const int r0 = blockIdx.x * p.T;          // the tile's first RE in its CB
  const int nt = min(p.T, n_cb - r0);
  if (nt <= 0) return;                      // the whole CTA: a short CB
  const int before = min(cb, p.C0);
  const int re = before * p.n0 + (cb - before) * p.n1 + r0 + tid;
  const bool live = tid < nt;
  const size_t slot = blockIdx.z;
  const size_t plane = (size_t)p.S * p.K;
  float2* g = grid + slot * p.P * plane;
  // The RE's plan and Gold words, then the tile's bit planes: plane b is
  // window positions b E / Qm + [r0 L, r0 L + nt L), one run from q0 in
  // the filler-free buffer; all of a thread's loads are issued before the
  // first is used.
  const int g0 = re * (L * QM);              // the RE's first codeword bit
  int s = 0, k = 0;
  uint32_t glo = 0, ghi = 0;
  if (live) {
    s = sym[re];
    k = sc[re];
    glo = gold[g0 >> 5];
    ghi = gold[(g0 >> 5) + 1];
  }
  // one precoder for every RE (K6): its P L values copied into shared
  // memory by cp.async while the planes load; a PRG table (K22) is read
  // through L1, a tile's REs spanning a few of its PRGs
  const float2* wt = w + slot * (size_t)p.w_stride;
  if (p.prg_size == 0 && tid < p.P * L)
    srsran_dfts::cp_async8(s_w + tid, wt + tid);
  const int8_t* row = cw + (slot * p.C + cb) * (size_t)p.N;
  const unsigned n_nf = p.n_nf, fs = p.fs, gap = p.gap;
  const int m = nt * L;
  unsigned q0 = (unsigned)(p.k0p + r0 * L) % n_nf;
  const unsigned step = (unsigned)(n_cb * L) % n_nf;
  // Thread u stages window entries [4u, 4u + 4) of every plane, one word:
  // two aligned word loads and a funnel shift where the four lie in one
  // stretch of the buffer (no wrap, no filler edge among them), else four
  // byte loads.  The word loads of every plane are issued first, the
  // shifts after them.
  const bool words = ((uintptr_t)row & 3) == 0;
  const int e0 = 4 * tid;
  const bool stages = e0 < m;
  unsigned qs[QM];
  uint32_t lo[QM], hi[QM];
#pragma unroll
  for (int b = 0; b < QM; ++b) {
    unsigned q = q0 + e0;
    if (q >= n_nf) {                          // the wrap: once, or more
      q -= n_nf;                              // where a run exceeds N_nf
      if (q >= n_nf) q %= n_nf;
    }
    qs[b] = q;
    const unsigned pos = q < fs ? q : q + gap;
    lo[b] = hi[b] = 0;
    if (stages && words && q + 3 < n_nf && (q >= fs || q + 3 < fs) &&
        (pos & ~3u) + 8 <= (unsigned)p.N) {
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(row) + (pos >> 2);
      lo[b] = wp[0];
      hi[b] = wp[1];
    }
    q0 += step;
    if (q0 >= n_nf) q0 -= n_nf;
  }
  // the grid values on every port, loaded while the planes arrive
  const size_t at = (size_t)s * p.K + k;
  float2 v[kMapMaxPorts];
  if (live) {
#pragma unroll
    for (int pp = 0; pp < kMapMaxPorts; ++pp)
      if (pp < p.P) v[pp] = g[pp * plane + at];
  }
  if (tid < kMapMaxLevels) s_levels[tid] = p.levels[tid];
  if (stages) {
#pragma unroll
    for (int b = 0; b < QM; ++b) {
      const unsigned q = qs[b], pos = q < fs ? q : q + gap;
      uint32_t word;
      if (words && q + 3 < n_nf && (q >= fs || q + 3 < fs) &&
          (pos & ~3u) + 8 <= (unsigned)p.N) {
        word = __funnelshift_r(lo[b], hi[b], (pos & 3) * 8);
      } else {
        word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          unsigned qi = q + i;
          while (qi >= n_nf) qi -= n_nf;
          word |= (uint32_t)(uint8_t)row[qi < fs ? qi : qi + gap] << (8 * i);
        }
      }
      *reinterpret_cast<uint32_t*>(s_bits + b * kPlane + e0) = word;
    }
  }
  srsran_dfts::cp_async_wait();
  __syncthreads();
  if (!live) return;
  const uint32_t gbits = __funnelshift_r(glo, ghi, g0 & 31);
  // this RE's L bytes of each plane, byte l at bits 8 l
  uint32_t mine[QM];
#pragma unroll
  for (int b = 0; b < QM; ++b) {
    const uint8_t* at_b = s_bits + b * kPlane + tid * L;
    if constexpr (L == 4) {
      mine[b] = *reinterpret_cast<const uint32_t*>(at_b);
    } else if constexpr (L == 2) {
      mine[b] = *reinterpret_cast<const uint16_t*>(at_b);
    } else {
      mine[b] = 0;
#pragma unroll
      for (int l = 0; l < L; ++l) mine[b] |= (uint32_t)at_b[l] << (8 * l);
    }
  }
  float2 x[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    int vi = 0, vq = 0;
#pragma unroll
    for (int b = 0; b < QM; ++b) {
      const int bit = ((mine[b] >> (8 * l)) ^ (gbits >> (l * QM + b))) & 1;
      if (b & 1) vq = (vq << 1) | bit; else vi = (vi << 1) | bit;
    }
    x[l] = make_float2(s_levels[vi], s_levels[vq]);
  }
  const float2* wp =
      p.prg_size > 0 ? wt + (k / 12 / p.prg_size - p.prg_base) * p.P * L
                     : s_w;
#pragma unroll
  for (int pp = 0; pp < kMapMaxPorts; ++pp) {
    if (pp < p.P) {
      const float2* wr = wp + pp * L;
      float2 acc = cmul(wr[0], x[0]);
#pragma unroll
      for (int l = 1; l < L; ++l) {
        const float2 t = cmul(wr[l], x[l]);
        acc = make_float2(__fadd_rn(acc.x, t.x), __fadd_rn(acc.y, t.y));
      }
      g[pp * plane + at] =
          make_float2(__fadd_rn(v[pp].x, acc.x), __fadd_rn(v[pp].y, acc.y));
    }
  }
}

template <int QM>
int launch(const int8_t* cw, const int* sym, const int* sc, const float2* w,
           float2* grid, const MapParams& p, const uint32_t* gold,
           cudaStream_t st) {
  const dim3 blocks(p.tiles, p.C, p.nslots);
#define SRSRAN_MAP(L)                                                        \
  pdsch_map_kernel<QM, L><<<blocks, kMapThreads, 0, st>>>(cw, sym, sc, w,  \
                                                         grid, p, gold)
  switch (p.L) {
    case 1: SRSRAN_MAP(1); break;
    case 2: SRSRAN_MAP(2); break;
    case 3: SRSRAN_MAP(3); break;
    case 4: SRSRAN_MAP(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SRSRAN_MAP
  return (int)cudaGetLastError();
}

inline bool params_ok(const MapParams& p) {
  const int n_max = p.n0 > p.n1 ? p.n0 : p.n1;
  return p.C >= 1 && p.C0 >= 0 && p.C0 <= p.C && p.n0 >= 0 && p.n1 >= 0 &&
         p.T >= 1 && p.T <= kMapThreads && p.tiles >= 1 &&
         (long long)p.tiles * p.T >= n_max && p.N >= 1 && p.n_nf >= 1 &&
         p.fs >= 0 && p.gap >= 0 && p.k0p >= 0 && p.L >= 1 &&
         p.L <= kMapMaxLayers && p.P >= 1 && p.P <= kMapMaxPorts &&
         p.S >= 1 && p.K >= 1 && p.prg_size >= 0 && p.w_stride >= 0 &&
         p.nslots >= 1;
}

}  // namespace

// cw int8 [slots, C, N] (K5's encoded codeblocks); sym, sc int32 [nre] (the
// data REs in codeword order); w complex64 the precoder: [P, L], a PRG
// table [G, P, L], or either per slot at w_stride; grid complex64 [slots,
// P, S, K], added into; params a MapParams; gold int32 [nre L Qm / 32 + 1]
// the codeword's Gold bits packed 32 a word, bit b of word w for bit 32 w +
// b (a spare word last).
extern "C" int srsran_pdsch_map(void* cw, void* sym, void* sc, void* w,
                                void* grid, void* stream, const void* params,
                                const void* gold) {
  const MapParams* p = (const MapParams*)params;
  if (!params_ok(*p)) return (int)cudaErrorInvalidValue;
  const int8_t* c = (const int8_t*)cw;
  const int* si = (const int*)sym;
  const int* ki = (const int*)sc;
  const float2* wp = (const float2*)w;
  float2* g = (float2*)grid;
  const uint32_t* q = (const uint32_t*)gold;
  cudaStream_t st = (cudaStream_t)stream;
  switch (p->qm) {
    case 2: return launch<2>(c, si, ki, wp, g, *p, q, st);
    case 4: return launch<4>(c, si, ki, wp, g, *p, q, st);
    case 6: return launch<6>(c, si, ki, wp, g, *p, q, st);
    case 8: return launch<8>(c, si, ki, wp, g, *p, q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
