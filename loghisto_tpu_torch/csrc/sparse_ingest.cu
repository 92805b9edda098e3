// K3: weighted scatter of packed (id, codec_bucket, count) triples.
//
// Replaces loghisto_tpu/ops/sparse_ingest.py `_pallas_kernel`
// (pallas_sparse_ingest): for every row of the int32 [n, 3] array with
// 0 <= id < M, acc[id, clip(bucket, -bl, bl) + bl] += count, acc int32
// [M, B] updated in place.  Pad rows carry id -1 and drop.
//
// The TPU kernel walks the cells serially and round-trips one bucket row
// per cell through VMEM by DMA, because a serial grid is how a TPU adds
// duplicate cells exactly.  Hopper adds them exactly with atomics: one
// thread per triple (grid-stride) and one atomicAdd of its count.
//
// Bound on the card: the 12 B/triple read and the atomic
// read-modify-write of each touched cell; triples are unique cells by
// construction (the host fold), so atomics rarely collide.
#include "codec.cuh"

__global__ void lh_sparse_ingest_kernel(int* __restrict__ acc,
                                        const int* __restrict__ packed,
                                        long long n, int num_metrics,
                                        int num_buckets, int bucket_limit) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int id = packed[3 * i];
    if (id < 0 || id >= num_metrics) continue;
    const int count = packed[3 * i + 2];
    if (count == 0) continue;
    int b = packed[3 * i + 1];
    b = b < -bucket_limit ? -bucket_limit : (b > bucket_limit ? bucket_limit : b);
    atomicAdd(acc + static_cast<long long>(id) * num_buckets + b + bucket_limit, count);
  }
}

extern "C" int lh_sparse_ingest(void* acc, const void* packed, long long n,
                                int num_metrics, int num_buckets,
                                int bucket_limit, void* stream) {
  if (num_buckets != 2 * bucket_limit + 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  lh_sparse_ingest_kernel<<<lh_grid(n, threads, 16), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(acc), static_cast<const int*>(packed), n, num_metrics,
      num_buckets, bucket_limit);
  return static_cast<int>(cudaGetLastError());
}
