// Shared __device__ log-bucket codec of the three ingest kernels.
//
// Counterpart of loghisto_tpu/ops/codec.py: compress (the device tier)
// and loghisto_tpu/ops/ingest.py: bucket_indices.  The JAX device codec
// computes in float32; this one computes in float64 so that every
// kernel puts every sample in the bucket the host contract compress_np
// (float64, the Go reference's math) gives it:
//
//     bucket = sign(v) * min(floor(precision * log1p(|v|) + 0.5), 32767)
//
// NaN pins to bucket 0, +/-inf saturate at +/-32767, -0.0 is bucket 0.
// The multiply and the add are rounded separately (__dmul_rn,
// __dadd_rn) as NumPy rounds them: nvcc would otherwise contract them
// into one fma, whose single rounding can move a value that sits on a
// bucket edge.  The dense column clips the bucket to +/-bucket_limit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ int lh_codec_bucket(float v, int precision) {
  const double x = static_cast<double>(v);
  if (isnan(x)) return 0;
  const double scaled = __dmul_rn(static_cast<double>(precision), log1p(fabs(x)));
  const double mag = fmin(floor(__dadd_rn(scaled, 0.5)), 32767.0);
  const int m = static_cast<int>(mag);
  return x < 0.0 ? -m : m;
}

__device__ __forceinline__ int lh_dense_col(float v, int bucket_limit, int precision) {
  int b = lh_codec_bucket(v, precision);
  b = b < -bucket_limit ? -bucket_limit : (b > bucket_limit ? bucket_limit : b);
  return b + bucket_limit;
}

// Grid of at most `blocks_per_sm` blocks on every SM for a grid-stride
// loop over n items.
static inline unsigned lh_grid(long long n, int threads, int blocks_per_sm) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  long long blocks = (n + threads - 1) / threads;
  const long long cap = static_cast<long long>(sms) * blocks_per_sm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

extern "C" const char* lh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
