// The N-point FFT of one OFDM symbol in registers and shared memory, shared
// by K4 (ofdm_demod.cu: the forward transform) and K7 (ofdm_mod.cu: the
// inverse), with their launch struct and its checks.  The host plan is
// srsran_tpu_torch/ops/ofdm.py (_ofdm_params, _fft_table, _fft_stages).
//
// Two forms, one CTA a (row, symbol) in both:
// - The radix-16 form, N = 2^n from 128 to 4096 (n = 7..12, a template
//   argument): N / 16 threads, each holding 16 points in registers.  The
//   stages are a Stockham decimation in time of radix 16 (and a last one of
//   radix 2, 4 or 8 when 4 does not divide n); stage s of radix R and span L
//   (the product of the earlier radices) takes butterfly j's elements
//   src[j + r N / R], twiddles element r by w^(r (j mod L) N / (L R)),
//   transforms them, and writes dst[(j - j mod L) R + j mod L + r L].  A
//   thread's butterflies are j = tid + i T (i < G = 16 / R, T = N / 16), so
//   its register m = i + r G reads point tid + T m in every stage, and holds
//   output tid + T m after the last: the first stage reads device memory and
//   the last writes it, both coalesced, and the stages between meet in one
//   padded shared buffer (word i at i + i / 16: no bank conflict on either
//   side).  Each stage's twiddles come from a host table [R - 1, L] (entry
//   (r - 1, k) = w^(r k N / (L R))), read once into registers at the start.
// - The Stockham form (N = 2^a 3^b 5^c up to 4096, not a power of two from
//   128): K18's mixed-radix IDFT (dft_s_ofdm.cuh) over two buffers and the
//   table in dynamic shared memory, N / 4 threads (mixed_threads: a radix-4
//   stage's butterflies, one each); K4 takes the forward transform as
//   conj(IDFT(conj x)).
// Every twiddle is an entry of one table, exp(2j pi m / N) built in float64
// and rounded once (ops/transform_precode.py::twiddles), the forward
// transform's its conjugate; so is K4's window-offset ramp, the entry
// (off b mod N) of bin b, gathered by the host in bin order (a coalesced
// read); the 1 / sqrt(N) of the unitary transforms is folded into the
// per-symbol factor comp.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dft_s_ofdm.cuh"

namespace srsran_ofdm {

constexpr int kOfdmMaxSymbols = 14;
constexpr int kOfdmMaxStages = 3;      // the radix-16 form at N = 4096
constexpr int kOfdmMinLog = 7;         // N = 128
constexpr int kOfdmMaxLog = 12;        // N = 4096
constexpr int kOfdmMaxPoints = 4096;
constexpr int kOfdmMixedMaxThreads = 1024;

// The Stockham form's threads: N / 4 in whole warps, 64 to 1024.
inline int mixed_threads(int n) {
  const int t = (n / 4 + 31) / 32 * 32;
  return t < 64 ? 64 : t > kOfdmMixedMaxThreads ? kOfdmMixedMaxThreads : t;
}

// The launch, by value (srsran_tpu_torch/kernels/_build.py OfdmParams).
struct OfdmParams {
  int rows;      // B P: the rows of the launch
  int S;         // symbols a slot
  int N;         // DFT points
  int K;         // used subcarriers
  int half;      // K / 2: the grid's lower half, the DFT's last bins
  int T;         // samples a row
  int off;       // K4: the FFT window's offset into the CP (K7: 0)
  int form;      // log2 N: the radix-16 form; 0: the Stockham form
  int tw_off[kOfdmMaxStages - 1];   // the radix-16 form's stage s >= 1:
                                    // its twiddles [R - 1, L] at tw_off[s - 1]
  int smem;      // the Stockham form's dynamic shared memory, bytes
  int ramp;      // K4 with an offset: the ramp's first entry in the table
  int start[kOfdmMaxSymbols];   // K4: symbol s's window start in its row;
                                // K7: the first sample of symbol s's CP
  int cp[kOfdmMaxSymbols];      // K7: symbol s's CP length
  float comp[2 * kOfdmMaxSymbols];   // comp[s] scale / sqrt(N), (re, im)
  srsran_dfts::FftPlan fft;     // the Stockham form's IDFT (scale 1)
};

// The radix-16 form of N = 2^LOGN.
template <int LOGN>
struct Form {
  static constexpr int N = 1 << LOGN;
  static constexpr int T = N / 16;                    // threads
  static constexpr int STAGES = (LOGN + 3) / 4;
  static constexpr int LAST = LOGN % 4 ? 1 << (LOGN % 4) : 16;
  __host__ __device__ static constexpr int radix(int s) {
    return s < STAGES - 1 ? 16 : LAST;
  }
  __host__ __device__ static constexpr int span(int s) {
    return 1 << (4 * s);                              // the radices before
  }
};

// Shared-memory word of point i (one pad word every 16).
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// a * b
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, a.y * b.y), fmaf(a.y, b.x, -a.x * b.y));
}

// a * b, or a * conj(b) for the forward transform
template <bool INV>
__device__ __forceinline__ float2 twiddle(float2 a, float2 b) {
  return INV ? cmul(a, b) : cmul_conj(a, b);
}

// cos and sin of 2 pi q / 16, q < 8, from float64
__host__ __device__ constexpr float cos16(int q) {
  return q == 0 ? 1.f : q == 1 ? (float)0.92387953251128675613
       : q == 2 ? (float)0.70710678118654752440
       : q == 3 ? (float)0.38268343236508977173 : q == 4 ? 0.f
       : q == 5 ? (float)-0.38268343236508977173
       : q == 6 ? (float)-0.70710678118654752440
       : (float)-0.92387953251128675613;
}

__host__ __device__ constexpr float sin16(int q) {
  return cos16(q <= 4 ? 4 - q : q - 4);
}

// d w_16^q, w_16 = exp(-+2j pi / 16) (INV: +), q < 8 known at compile time
template <bool INV>
__device__ __forceinline__ float2 rotate16(float2 d, int q) {
  if (q == 0) return d;
  if (q == 4) return INV ? make_float2(-d.y, d.x) : make_float2(d.y, -d.x);
  const float c = cos16(q), s = sin16(q);
  return INV ? make_float2(fmaf(d.x, c, -d.y * s), fmaf(d.y, c, d.x * s))
             : make_float2(fmaf(d.x, c, d.y * s), fmaf(d.y, c, -d.x * s));
}

__host__ __device__ constexpr int rev_bits(int m, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((m >> b) & 1) << (bits - 1 - b);
  return r;
}

__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v / 2);
}

// One radix-2 pass of half-size H over the R points of u (decimation in
// frequency): u[b + j], u[b + j + H] -> their sum, their difference times
// w_{2H}^j = w_16^(16 j / 2H).
template <int R, int H, bool INV>
__device__ __forceinline__ void dif_pass(float2 (&u)[R]) {
#pragma unroll
  for (int b = 0; b < R; b += 2 * H) {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float2 a = u[b + j], c = u[b + j + H];
      u[b + j] = cadd(a, c);
      u[b + j + H] = rotate16<INV>(csub(a, c), j * (8 / H));
    }
  }
}

// The R-point DFT (R = 2, 4, 8, 16) of u in place, natural order in and out
// (the passes leave X[rev(m)] in u[m]; the reversal is a renaming).
template <int R, bool INV>
__device__ __forceinline__ void dft(float2 (&u)[R]) {
  if constexpr (R >= 16) dif_pass<R, 8, INV>(u);
  if constexpr (R >= 8) dif_pass<R, 4, INV>(u);
  if constexpr (R >= 4) dif_pass<R, 2, INV>(u);
  dif_pass<R, 1, INV>(u);
  float2 t[R];
#pragma unroll
  for (int k = 0; k < R; ++k) t[k] = u[rev_bits(k, log2i(R))];
#pragma unroll
  for (int k = 0; k < R; ++k) u[k] = t[k];
}

// Stage S's twiddles of this thread into w: butterfly i's element r at
// w[i (R - 1) + r - 1], from the stage's table at tw + off.
template <int LOGN, int S>
__device__ __forceinline__ void load_twiddles(float2 (&w)[15],
                                              const float2* __restrict__ tw,
                                              int off, int tid) {
  using F = Form<LOGN>;
  constexpr int R = F::radix(S), G = 16 / R, L = F::span(S);
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int k = (tid + i * F::T) & (L - 1);
#pragma unroll
    for (int r = 1; r < R; ++r)
      w[i * (R - 1) + r - 1] = __ldg(tw + off + (r - 1) * L + k);
  }
}

// Stage S on the registers v (see the header): twiddle (S > 0), transform,
// then into the shared buffer unless it is the last stage (S > 0: after a
// barrier, every thread having read its points).
template <int LOGN, int S, bool INV>
__device__ __forceinline__ void stage(float2 (&v)[16], const float2 (&w)[15],
                                      float2* sh, int tid) {
  using F = Form<LOGN>;
  constexpr int R = F::radix(S), G = 16 / R, L = F::span(S);
  constexpr bool LAST = S == F::STAGES - 1;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    float2 u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = v[i + r * G];
    if constexpr (S > 0) {
#pragma unroll
      for (int r = 1; r < R; ++r)
        u[r] = twiddle<INV>(u[r], w[i * (R - 1) + r - 1]);
    }
    dft<R, INV>(u);
#pragma unroll
    for (int r = 0; r < R; ++r) v[i + r * G] = u[r];
  }
  if constexpr (!LAST) {
    static_assert(G == 1, "a stage before the last is radix 16");
    if constexpr (S > 0) __syncthreads();
    const int k = tid & (L - 1);
    const int d = (tid - k) * 16 + k;
#pragma unroll
    for (int r = 0; r < 16; ++r) sh[pad(d + r * L)] = v[r];
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 16; ++m) v[m] = sh[pad(tid + F::T * m)];
  }
}

// The N-point DFT (INV: the inverse, unnormalised) of v, in two calls:
// fft_head runs every stage but the last, fft_last the last (K4 issues its
// ramp's loads between them, to land during the last stage).  On entry
// register m holds point tid + T m, on exit output tid + T m; w1, w2:
// stages 1 and 2's twiddles (load_twiddles).
template <int LOGN, bool INV>
__device__ __forceinline__ void fft_head(float2 (&v)[16],
                                         const float2 (&w1)[15], float2* sh,
                                         int tid) {
  stage<LOGN, 0, INV>(v, w1, sh, tid);
  if constexpr (Form<LOGN>::STAGES == 3) stage<LOGN, 1, INV>(v, w1, sh, tid);
}

template <int LOGN, bool INV>
__device__ __forceinline__ void fft_last(float2 (&v)[16],
                                         const float2 (&w1)[15],
                                         const float2 (&w2)[15], float2* sh,
                                         int tid) {
  if constexpr (Form<LOGN>::STAGES == 3)
    stage<LOGN, 2, INV>(v, w2, sh, tid);
  else
    stage<LOGN, 1, INV>(v, w1, sh, tid);
}

// The checks of a launch's parameters, for the C entry points.
inline bool params_ok(const OfdmParams& p) {
  if (p.rows < 1 || p.S < 1 || p.S > kOfdmMaxSymbols || p.N < 1 ||
      p.N > kOfdmMaxPoints || p.K < 1 || p.K > p.N || p.half != p.K / 2 ||
      p.T < 1 || p.off < 0 || (p.off && p.ramp < p.N))
    return false;
  for (int s = 0; s < p.S; ++s)
    if (p.start[s] < 0 || p.cp[s] < 0 || p.cp[s] > p.N ||
        p.start[s] + p.cp[s] + p.N > p.T)
      return false;
  if (p.form == 0)
    return srsran_dfts::plan_ok(p.fft) && p.fft.M == p.N &&
           p.fft.scale == 1.f && p.smem == 3 * p.N * (int)sizeof(float2);
  return p.form >= kOfdmMinLog && p.form <= kOfdmMaxLog && p.N == 1 << p.form;
}

}  // namespace srsran_ofdm
