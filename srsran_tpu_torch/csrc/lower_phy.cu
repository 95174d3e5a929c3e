// K30 (CFO rotation) and K31 (amplitude control) for Hopper.
//
// K30 replaces srsran_tpu/phy/lower/cfo.py::apply_cfo (:19-27), which
// CfoProcessor.process (:64-71) runs per baseband block: samples
// complex64 [..., T] times exp(j theta_t), theta_t = f32(2 pi c) f32(t +
// offset) -- JAX forms (2j pi c) n as a complex64 product of the
// double-rounded f32(2 pi c) and f32(n), one rounding, and so does this
// kernel (the host rounds 2 pi c once).  The rotation is precise sincosf,
// the complex product four rounded multiplies and two rounded adds
// (--fmad=false), as the twin's separate real operations.  Twin:
// srsran_tpu_torch/phy/lower/cfo.py::apply_cfo_ref.
//
// K31 replaces srsran_tpu/phy/lower/amplitude_control.py::scale (:24),
// clip (:30) and _metrics (:43): a gain, a hard clip of the magnitude at
// the ceiling (|x| by hypotf, as jnp.abs and torch.abs of a complex value;
// over = |x| > ceiling; x * (ceiling / max(|x|, 1e-12))), and the metrics
// over the whole array: mean and peak of |x|^2, their dB, the PAPR and the
// share of clipped samples (scale: a ceiling of +inf, share 0).  One pass
// writes the samples and each CTA's partial sum (double), peak and clipped
// count; a one-CTA launch reduces the partials in a fixed order and
// computes the four metrics.  Peak and the clipped share are exact; the
// mean power differs from the twin's float32 mean only by its sum order.
// Twin: srsran_tpu_torch/phy/lower/amplitude_control.py::clip_ref.
//
// Bounds on this card: both are memory passes (8 bytes read and 8 written
// per sample, about 20 operations each).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_BLOCKS = 1024;

__global__ void cfo_kernel(const float2* __restrict__ x, long long total,
                           int T, float w, long long offset,
                           float2* __restrict__ y) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const float theta = w * (float)(i % T + offset);
    float s, c;
    sincosf(theta, &s, &c);
    const float2 v = x[i];
    y[i] = make_float2(v.x * c - v.y * s, v.x * s + v.y * c);
  }
}

__global__ void amplitude_kernel(const float2* __restrict__ x, long long total,
                                 float gain, float ceiling,
                                 float2* __restrict__ y,
                                 double* __restrict__ part_sum,
                                 float* __restrict__ part_peak,
                                 int* __restrict__ part_count) {
  __shared__ double ssum[NT];
  __shared__ float speak[NT];
  __shared__ int scount[NT];
  double acc = 0.0;
  float peak = 0.f;
  int count = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const float2 v = x[i];
    float re = v.x * gain, im = v.y * gain;
    const float mag = hypotf(re, im);
    if (mag > ceiling) {
      const float r = ceiling / fmaxf(mag, 1e-12f);
      re = re * r;
      im = im * r;
      ++count;
    }
    y[i] = make_float2(re, im);
    const float a = hypotf(re, im);
    const float p = a * a;
    acc += (double)p;
    peak = fmaxf(peak, p);
  }
  ssum[threadIdx.x] = acc;
  speak[threadIdx.x] = peak;
  scount[threadIdx.x] = count;
  __syncthreads();
  for (int h = NT / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
      ssum[threadIdx.x] += ssum[threadIdx.x + h];
      speak[threadIdx.x] = fmaxf(speak[threadIdx.x], speak[threadIdx.x + h]);
      scount[threadIdx.x] += scount[threadIdx.x + h];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    part_sum[blockIdx.x] = ssum[0];
    part_peak[blockIdx.x] = speak[0];
    part_count[blockIdx.x] = scount[0];
  }
}

// metrics: avg_power_db, peak_power_db, papr_db, clipped_ratio
__global__ void amplitude_finish(const double* __restrict__ part_sum,
                                 const float* __restrict__ part_peak,
                                 const int* __restrict__ part_count,
                                 int nblocks, long long total,
                                 float* __restrict__ metrics) {
  __shared__ double ssum[NT];
  __shared__ float speak[NT];
  __shared__ long long scount[NT];
  double acc = 0.0;
  float peak = 0.f;
  long long count = 0;
  for (int b = threadIdx.x; b < nblocks; b += NT) {
    acc += part_sum[b];
    peak = fmaxf(peak, part_peak[b]);
    count += part_count[b];
  }
  ssum[threadIdx.x] = acc;
  speak[threadIdx.x] = peak;
  scount[threadIdx.x] = count;
  __syncthreads();
  for (int h = NT / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
      ssum[threadIdx.x] += ssum[threadIdx.x + h];
      speak[threadIdx.x] = fmaxf(speak[threadIdx.x], speak[threadIdx.x + h]);
      scount[threadIdx.x] += scount[threadIdx.x + h];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float avg = fmaxf((float)(ssum[0] / (double)total), 1e-15f);
    const float pk = fmaxf(speak[0], 1e-15f);
    metrics[0] = 10.f * log10f(avg);
    metrics[1] = 10.f * log10f(pk);
    metrics[2] = 10.f * log10f(pk / avg);
    metrics[3] = (float)scount[0] / (float)total;
  }
}

int blocks_for(long long total) {
  const long long b = (total + NT - 1) / NT;
  return (int)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

}  // namespace

// x, y complex64 [total] (rows of T samples); w = f32(2 pi cfo_norm).
extern "C" int srsran_cfo(void* x, long long total, int T, float w,
                          long long offset, void* y, void* stream) {
  if (total < 1 || T < 1) return (int)cudaErrorInvalidValue;
  cfo_kernel<<<blocks_for(total), NT, 0, (cudaStream_t)stream>>>(
      (const float2*)x, total, T, w, offset, (float2*)y);
  return (int)cudaGetLastError();
}

// x, y complex64 [total]; ceiling +inf for a plain scale; scratch holds
// MAX_BLOCKS doubles, floats and ints; metrics f32 [4].
extern "C" int srsran_amplitude(void* x, long long total, float gain,
                                float ceiling, void* y, void* part_sum,
                                void* part_peak, void* part_count,
                                void* metrics, void* stream) {
  if (total < 1) return (int)cudaErrorInvalidValue;
  const int nb = blocks_for(total);
  amplitude_kernel<<<nb, NT, 0, (cudaStream_t)stream>>>(
      (const float2*)x, total, gain, ceiling, (float2*)y, (double*)part_sum,
      (float*)part_peak, (int*)part_count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  amplitude_finish<<<1, NT, 0, (cudaStream_t)stream>>>(
      (const double*)part_sum, (const float*)part_peak,
      (const int*)part_count, nb, total, (float*)metrics);
  return (int)cudaGetLastError();
}
