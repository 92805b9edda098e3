// K2: single-row histogram (M = 1), with and without the id mask.
//
// Replaces loghisto_tpu/ops/pallas_kernels.py `_hist_kernel` (K2a,
// pallas_histogram_row) and `_hist_kernel_masked` (K2b,
// pallas_row_ingest_batch): acc_row[col(v)] += 1 for every sample —
// only for samples whose id is 0 when `ids` is given.
//
// The TPU kernels form one-hot tiles and add them on the MXU into a
// float32 VMEM scratch.  Here each block builds a private int32 [B]
// histogram in shared memory (B = 8193 is 32.8 KB; dynamic shared
// memory, opted in above 48 KB for larger B) with shared-memory atomics,
// then merges its nonzero bins into the global row with one atomicAdd
// each.  The TPU's f32 scratch is why the reference refuses N >= 2^24
// per call; this kernel's int32 counts do not need that bound, and the
// wrapper keeps the reference's ValueErrors only so that both packages
// refuse the same inputs.
//
// Bound on the card: the 4 B/sample value read (8 B with the mask).
// Shared-memory atomics absorb the per-sample adds; a value stream
// concentrated in few buckets serialises on those bins.
#include "codec.cuh"

__global__ void lh_row_ingest_kernel(int* __restrict__ acc_row,
                                     const int* __restrict__ ids,
                                     const float* __restrict__ values,
                                     long long n, int num_buckets,
                                     int bucket_limit, int precision) {
  extern __shared__ int hist[];
  for (int b = threadIdx.x; b < num_buckets; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    if (ids != nullptr && ids[i] != 0) continue;
    atomicAdd(hist + lh_dense_col(values[i], bucket_limit, precision), 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < num_buckets; b += blockDim.x) {
    const int c = hist[b];
    if (c) atomicAdd(acc_row + b, c);
  }
}

extern "C" int lh_row_ingest(void* acc_row, const void* ids, const void* values,
                             long long n, int num_buckets, int bucket_limit,
                             int precision, void* stream) {
  if (num_buckets != 2 * bucket_limit + 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(num_buckets) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lh_row_ingest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = 512;
  // each block pays a B-wide zero and merge: give it >= 8 samples/thread
  const long long per_block = static_cast<long long>(threads) * 8;
  const unsigned grid = lh_grid((n + per_block - 1) / per_block, 1, 4);
  lh_row_ingest_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(acc_row), static_cast<const int*>(ids),
      static_cast<const float*>(values), n, num_buckets, bucket_limit, precision);
  return static_cast<int>(cudaGetLastError());
}
