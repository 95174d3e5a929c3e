// K35: the saturating int8 LLR type for Hopper.
//
// Replaces srsran_tpu/ops/llr.py::quantize (:21) and dequantize (:27) (and
// to_float's int8 branch, :31): f32 -> int8 with the reference's +-20 <->
// +-120 mapping, round half to even and saturation at +-127, and int8 -> f32.
// Twin: srsran_tpu_torch/ops/llr.py::quantize_ref / dequantize_ref.
//
// Design.  One fused elementwise pass each, one thread per LLR: rintf (round
// half to even, as jnp.round; not roundf, which rounds half away from zero)
// of x * 6, clamped to +-127; dequantize divides by 6 in IEEE division (the
// library builds without fast math), as the twin divides by a device tensor.
// Bounds on this card: bytes (5 per LLR each way); the passes are
// launch-bound below about a million LLRs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__global__ void llr_quantize_kernel(const float* __restrict__ x, long long n,
                                    float scale, int8_t* __restrict__ q) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  const float v = rintf(x[i] * scale);
  q[i] = (int8_t)fminf(fmaxf(v, -127.f), 127.f);
}

__global__ void llr_dequantize_kernel(const int8_t* __restrict__ q,
                                      long long n, float scale,
                                      float* __restrict__ x) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  x[i] = (float)q[i] / scale;
}

inline int blocks(long long n) { return (int)((n + NT - 1) / NT); }

}  // namespace

// x f32 [n] -> q int8 [n].
extern "C" int srsran_llr_quantize(void* x, long long n, float scale, void* q,
                                   void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  llr_quantize_kernel<<<blocks(n), NT, 0, (cudaStream_t)stream>>>(
      (const float*)x, n, scale, (int8_t*)q);
  return (int)cudaGetLastError();
}

// q int8 [n] -> x f32 [n].
extern "C" int srsran_llr_dequantize(void* q, long long n, float scale,
                                     void* x, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  llr_dequantize_kernel<<<blocks(n), NT, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, n, scale, (float*)x);
  return (int)cudaGetLastError();
}
