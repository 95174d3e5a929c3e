// K35: the saturating int8 LLR type for Hopper.
//
// Replaces srsran_tpu/ops/llr.py::quantize (:21) and dequantize (:27) (and
// to_float's int8 branch, :31): f32 -> int8 with the reference's +-20 <->
// +-120 mapping, round half to even and saturation at +-127, and int8 -> f32.
// Twin: srsran_tpu_torch/ops/llr.py::quantize_ref / dequantize_ref.
//
// Design.  One fused elementwise pass each, 16 LLRs a thread: quantize
// reads four float4 and writes one 16-byte store, dequantize reads 16
// bytes and writes four float4 (its warp's 512 LLRs transposed by
// shuffles, so that every store instruction of the warp writes 512
// contiguous bytes; the 256 quotients made once a CTA by IEEE division,
// then looked up); a grid of the plan's CTAs (a few per SM of the
// card, ops/llr.py::_llr_params) strides over the vectors, and the LLRs
// past the last whole vector (of 16, or of 512 for dequantize) go one a
// thread.  Pointers not 16-byte aligned take the scalar path for all LLRs.  rintf (round half to even,
// as jnp.round; not roundf, which rounds half away from zero) of x * 6,
// clamped to +-127; dequantize's quotients are IEEE divisions by 6 (the
// library builds without fast math), as the twin divides by a device
// tensor.
// Bounds on this card: bytes (5 per LLR each way); at the flagship
// PUSCH's 426,096 LLRs (2.1 MB) the pass is about 0.64 us of bytes, so the
// launch and one round trip to memory set the time.

#include <cuda_runtime.h>
#include <stdint.h>

// The plan's launch (by address; the kernel takes its fields by value).
struct LlrParams {
  long long n;                // LLRs
  float scale;                // 6
  int blocks;                 // CTAs
};

namespace {

constexpr int NT = 256;
constexpr int kVec = 16;               // LLRs per vector

__device__ __forceinline__ int8_t quantize_one(float x, float scale) {
  const float v = rintf(__fmul_rn(x, scale));
  return (int8_t)fminf(fmaxf(v, -127.f), 127.f);
}

__device__ __forceinline__ uint32_t quantize4(float4 v, float scale) {
  return (uint32_t)(uint8_t)quantize_one(v.x, scale)
         | (uint32_t)(uint8_t)quantize_one(v.y, scale) << 8
         | (uint32_t)(uint8_t)quantize_one(v.z, scale) << 16
         | (uint32_t)(uint8_t)quantize_one(v.w, scale) << 24;
}

// Four int8 LLRs (a word) through the CTA's quotient table.
__device__ __forceinline__ float4 dequantize4(uint32_t q, const float* tab) {
  return make_float4(tab[q & 0xff], tab[(q >> 8) & 0xff],
                     tab[(q >> 16) & 0xff], tab[q >> 24]);
}

// vec: whether the vector body runs (pointers 16-byte aligned); the LLRs
// past it go one a thread.
__global__ void __launch_bounds__(NT)
llr_quantize_kernel(const float* __restrict__ x, long long n, float scale,
                    int vec, int8_t* __restrict__ q) {
  const long long nv = vec ? n / kVec : 0;
  const long long stride = (long long)gridDim.x * NT;
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  for (long long i = t; i < nv; i += stride) {
    const float4* src = reinterpret_cast<const float4*>(x) + 4 * i;
    const float4 a = __ldg(src), b = __ldg(src + 1), c = __ldg(src + 2),
                 d = __ldg(src + 3);
    reinterpret_cast<uint4*>(q)[i] =
        make_uint4(quantize4(a, scale), quantize4(b, scale),
                   quantize4(c, scale), quantize4(d, scale));
  }
  for (long long i = kVec * nv + t; i < n; i += stride)
    q[i] = quantize_one(x[i], scale);
}

// The quotients first: thread i of the CTA divides int8 value (int8_t)i by
// the scale in IEEE division into a table in shared memory; every LLR is
// then a lookup, the same bits as its own division.  (A division per LLR
// costs data-dependent time: the IEEE division's operand check sends
// zeros and some quotients down its slow path, a warp at a time.)  A warp
// takes 512 LLRs at a time: lane l loads bytes 16 l .. 16 l + 15, and
// store c writes float4 32 c + l of the warp's 128 (LLRs 128 c + 4 l on),
// whose four bytes lane 8 c + l / 4 holds: shuffled over, so that each of
// the four stores covers 512 contiguous bytes.
__global__ void __launch_bounds__(NT)
llr_dequantize_kernel(const int8_t* __restrict__ q, long long n, float scale,
                      int vec, float* __restrict__ x) {
  static_assert(NT == 256, "a thread per int8 value");
  __shared__ float tab[256];
  tab[threadIdx.x] = (float)(int8_t)threadIdx.x / scale;
  __syncthreads();
  constexpr int kChunk = 32 * kVec;
  const long long nc = vec ? n / kChunk : 0;
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (NT / 32);
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  for (long long w = t / 32; w < nc; w += warps) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(q) + 32 * w + lane);
    float4* dst = reinterpret_cast<float4*>(x) + 128 * w + lane;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int src = 8 * c + (lane >> 2);
      const uint32_t a = __shfl_sync(0xffffffffu, v.x, src);
      const uint32_t b = __shfl_sync(0xffffffffu, v.y, src);
      const uint32_t d = __shfl_sync(0xffffffffu, v.z, src);
      const uint32_t e = __shfl_sync(0xffffffffu, v.w, src);
      const int k = lane & 3;
      dst[32 * c] = dequantize4(k == 0 ? a : k == 1 ? b : k == 2 ? d : e, tab);
    }
  }
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = kChunk * nc + t; i < n; i += stride)
    x[i] = tab[(uint8_t)q[i]];
}

inline bool aligned(const void* a, const void* b) {
  return ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 16 == 0);
}

inline bool valid(const LlrParams* p) {
  return p != nullptr && p->n >= 1 && p->blocks >= 1;
}

}  // namespace

// x f32 [n] -> q int8 [n].
extern "C" int srsran_llr_quantize(void* x, void* q, void* stream,
                                   const void* plan) {
  const LlrParams* params = (const LlrParams*)plan;
  if (!valid(params)) return (int)cudaErrorInvalidValue;
  llr_quantize_kernel<<<params->blocks, NT, 0, (cudaStream_t)stream>>>(
      (const float*)x, params->n, params->scale, aligned(x, q),
      (int8_t*)q);
  return (int)cudaGetLastError();
}

// q int8 [n] -> x f32 [n].
extern "C" int srsran_llr_dequantize(void* q, void* x, void* stream,
                                     const void* plan) {
  const LlrParams* params = (const LlrParams*)plan;
  if (!valid(params)) return (int)cudaErrorInvalidValue;
  llr_dequantize_kernel<<<params->blocks, NT, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, params->n, params->scale, aligned(q, x), (float*)x);
  return (int)cudaGetLastError();
}
