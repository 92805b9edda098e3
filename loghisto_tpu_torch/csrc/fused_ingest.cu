// K1: fused raw ingest — codec and scatter-add in one launch.
//
// Replaces loghisto_tpu/ops/fused_ingest.py `_kernel` (launched by
// fused_ingest_batch through pl.pallas_call).  Same function:
//     acc[id, col(v)] += 1 for every sample with 0 <= id < M,
// acc int32 [M, B] updated in place (B = 2*bucket_limit + 1).
//
// The TPU kernel sorts samples into row blocks, pads them to tiles and
// adds one-hot matrices on the MXU, because a TPU has no fast scatter.
// Hopper has int32 atomics in L2, so none of that machinery is carried
// over: one thread per sample (grid-stride) runs the float64 codec of
// codec.cuh and adds 1 with atomicAdd into the accumulator in device
// memory.  Ids outside [0, M) drop, as sanitize_ids + mode="drop" does.
// Global atomics serve any row count, so there is no M % 8 constraint.
//
// Bound on the card: the 8 B/sample read of (id, value) and the atomic
// read-modify-write of each touched cell in L2 / device memory.  A hot
// cell under skewed ids serialises its atomics (the known weakness);
// shared-memory row tiles that pre-aggregate hot rows are later work.
#include "codec.cuh"

__global__ void lh_fused_ingest_kernel(int* __restrict__ acc,
                                       const int* __restrict__ ids,
                                       const float* __restrict__ values,
                                       long long n, int num_metrics,
                                       int num_buckets, int bucket_limit,
                                       int precision) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int id = ids[i];
    if (id < 0 || id >= num_metrics) continue;
    const int col = lh_dense_col(values[i], bucket_limit, precision);
    atomicAdd(acc + static_cast<long long>(id) * num_buckets + col, 1);
  }
}

extern "C" int lh_fused_ingest(void* acc, const void* ids, const void* values,
                               long long n, int num_metrics, int num_buckets,
                               int bucket_limit, int precision, void* stream) {
  if (num_buckets != 2 * bucket_limit + 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  lh_fused_ingest_kernel<<<lh_grid(n, threads, 16), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(acc), static_cast<const int*>(ids),
      static_cast<const float*>(values), n, num_metrics, num_buckets,
      bucket_limit, precision);
  return static_cast<int>(cudaGetLastError());
}
