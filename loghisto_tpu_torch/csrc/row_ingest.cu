// K2: single-row histogram (M = 1), with and without the id mask.
//
// Replaces loghisto_tpu/ops/pallas_kernels.py `_hist_kernel` (K2a,
// pallas_histogram_row) and `_hist_kernel_masked` (K2b,
// pallas_row_ingest_batch): acc_row[col(v)] += 1 for every sample —
// only for samples whose id is 0 when `ids` is given.
//
// The TPU kernels form one-hot tiles and add them on the MXU into a
// float32 VMEM scratch.  The TPU's f32 scratch is why the reference
// refuses N >= 2^24 per call; this kernel's int32 counts do not need that
// bound, and the wrapper keeps the reference's ValueErrors only so that
// both packages refuse the same inputs.
//
// Bound on the card: the 4 B/sample value read (8 B with the mask) and
// the row's read-modify-write: 0.0100 ms for 2^22 masked samples.  The
// earlier kernel (9e897f6: 528 blocks of 512 threads, each zeroing and
// flushing its own 8193-bin histogram with global atomics, the float64
// codec of codec.cuh) took 0.039 ms; its float64 codec alone, one column
// written a sample, takes 0.027 and its grid's zero and flush alone 0.011
// (PERF.md; scripts/torch_kernel_ab.py k2, NVIDIA H100 80GB HBM3,
// 700 W).  The design:
//   * an exact float32 table codec (lh_table_bucket): x = precision *
//     __logf(1 + |v|) + 0.5 in float32.  Its error against the real
//     value is at most (precision + x) * 5e-7 (the intrinsic's 2^-21.41
//     absolute error below 2 and 3 ulp above, the rounding of 1 + |v|
//     and of the fma), so where x lies more than eps = (precision + x) *
//     2^-18 (7.6 times that) from an integer, floor(x) is the bucket
//     compress_np gives.  Otherwise the estimate is corrected against the
//     threshold table t (ops/codec.bucket_thresholds: t[k] is the
//     smallest float32 whose compress_np bucket is >= k, t[0] = 0) by
//     comparison until t[k] <= |v| < t[k + 1]; the loops reach that k
//     from any start, so the table alone decides those samples.  1.7% of
//     all float32 patterns read the table, through the read-only cache (so
//     it is not staged in shared memory, and any bucket_limit is served).
//     NaN is bucket 0, +/-inf and every bucket past bucket_limit clamp to
//     it, -0.0 and subnormals are 0: what lh_dense_col gives.
//     chip_smoke.py's phase codec holds it against lh_dense_col on all
//     2^32 float32 patterns.  Alone it takes 0.012 ms on 2^22 values
//     (the float64 codec 0.027);
//   * a persistent grid of 512-thread blocks, 2 an SM, in clusters of 8;
//     each thread loads values and ids 16 bytes at a time, with a ragged
//     head and tail taken one sample a thread (and every sample so when
//     the values and ids sit at different offsets of a 16-byte line);
//   * one private [B] histogram a block in shared memory, added to with
//     shared atomics (lognormal values spread a warp's 32 samples over
//     ~1000 bins, so conflicts are rare; one bin for every sample is
//     correct, only slower);
//   * at the end the cluster's 8 histograms are summed in distributed
//     shared memory, each block summing one eighth of the bins, and each
//     nonzero sum takes one global atomic: a live bin costs one global add
//     a cluster, not one a block.
// The constants were measured (scripts/torch_kernel_ab.py designs, ms on
// 2^22 samples masked / unmasked): this kernel 0.0177 / 0.0156; 1 block
// an SM 0.0224 / 0.0190, 4 0.0175 / 0.0157; 2 loads in flight 0.0181 /
// 0.0167, 4 0.0179 / 0.0172.  A launch over 2^12 samples takes 0.0065
// ms, an empty kernel on the same grid 0.0020.
// Integer adds commute: the result equals the plain version bit for bit.
#include <cooperative_groups.h>

#include "codec.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kCluster = 8;
constexpr int kBlocksPerSm = 2;
constexpr int kUnroll = 1;  // 16-byte loads a thread in flight
constexpr long long kMaxShared = 232448;  // 227 KB, a Hopper block's most

// the dense column offset (-bucket_limit .. bucket_limit) of v by the
// table codec; *slow tells whether the table was read
__device__ __forceinline__ int lh_table_bucket(float v, const float* __restrict__ t, int bl,
                                               float p, bool* slow) {
  const float a = fabsf(v);
  int k;
  *slow = false;
  if (!(a <= 3.402823466e38f)) {
    k = (a != a) ? 0 : bl;  // NaN pins to 0, +/-inf clamps
  } else {
    const float x = fmaf(p, __logf(1.0f + a), 0.5f);
    const float f = floorf(x);
    const float frac = x - f;  // exact
    const float eps = (p + x) * 0x1p-18f;
    k = min(static_cast<int>(f), bl);
    if (frac < eps || frac > 1.0f - eps) {
      *slow = true;
      k = max(k, 0);
      while (k < bl && a >= __ldg(t + k + 1)) ++k;
      while (k > 0 && a < __ldg(t + k)) --k;
    }
  }
  return v < 0.0f ? -k : k;
}

__device__ __forceinline__ int lh_table_col(float v, const float* __restrict__ t, int bl,
                                            float p) {
  bool slow;
  return lh_table_bucket(v, t, bl, p, &slow) + bl;
}

template <bool kMasked, bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
lh_row_ingest_kernel(int* __restrict__ acc_row, const int* __restrict__ ids,
                     const float* __restrict__ values, const float* __restrict__ table,
                     long long n, long long head, int num_buckets, int bucket_limit,
                     float precision) {
  extern __shared__ int hist[];
  for (int b = threadIdx.x; b < num_buckets; b += kThreads) hist[b] = 0;
  __syncthreads();

  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  auto add = [&](int id, float v) {
    if (id == 0) {
      atomicAdd(hist + lh_table_col(v, table, bucket_limit, precision), 1);
    }
  };
  if (kVec) {
    // [0, head) and [head + 4 * nq, n): at most 3 samples each
    const long long nq = (n - head) / 4;
    const long long tail = head + 4 * nq;
    if (gtid < head) add(kMasked ? ids[gtid] : 0, values[gtid]);
    if (gtid < n - tail) add(kMasked ? ids[tail + gtid] : 0, values[tail + gtid]);
    const float4* v4 = reinterpret_cast<const float4*>(values + head);
    const int4* i4 = reinterpret_cast<const int4*>(kMasked ? ids + head : nullptr);
    for (long long q = gtid; q < nq; q += stride * kUnroll) {
      float4 v[kUnroll];
      int4 id[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long qu = q + u * stride;
        const bool in = qu < nq;
        v[u] = in ? __ldg(v4 + qu) : make_float4(0.f, 0.f, 0.f, 0.f);
        // a sample adds where its id is 0 (every sample of the unmasked
        // entry); past the end nothing adds
        id[u] = !in ? make_int4(1, 1, 1, 1)
                    : (kMasked ? __ldg(i4 + qu) : make_int4(0, 0, 0, 0));
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        add(id[u].x, v[u].x);
        add(id[u].y, v[u].y);
        add(id[u].z, v[u].z);
        add(id[u].w, v[u].w);
      }
    }
  } else {
    for (long long i = gtid; i < n; i += stride) add(kMasked ? ids[i] : 0, values[i]);
  }

  // the cluster's histograms, summed in distributed shared memory: block
  // r of the cluster sums bins [r * per, (r + 1) * per) of all of them
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  const int per = (num_buckets + kCluster - 1) / kCluster;
  const int lo = rank * per;
  const int hi = min(num_buckets, lo + per);
  const int* remote[kCluster];
#pragma unroll
  for (int r = 0; r < kCluster; ++r) remote[r] = cluster.map_shared_rank(hist, r);
  for (int b = lo + threadIdx.x; b < hi; b += kThreads) {
    int s = 0;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) s += remote[r][b];
    if (s) atomicAdd(acc_row + b, s);
  }
  cluster.sync();  // no block leaves while another reads its histogram
}

// Exhaustive check of the table codec: every float32 bit pattern in
// [start, start + count) through lh_table_col and lh_dense_col; counts[0]
// += the patterns on which they differ, counts[1] += those that read the
// table.
__global__ void lh_codec_check_kernel(const float* __restrict__ table,
                                      unsigned long long start, unsigned long long count,
                                      int bucket_limit, int precision,
                                      unsigned long long* counts) {
  unsigned long long bad = 0, slow_n = 0;
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i = static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
                              threadIdx.x;
       i < count; i += stride) {
    const float v = __uint_as_float(static_cast<unsigned>(start + i));
    bool slow;
    const int got = lh_table_bucket(v, table, bucket_limit, static_cast<float>(precision),
                                    &slow) + bucket_limit;
    bad += got != lh_dense_col(v, bucket_limit, precision);
    slow_n += slow;
  }
  for (int o = 16; o; o >>= 1) {
    bad += __shfl_down_sync(0xffffffffu, bad, o);
    slow_n += __shfl_down_sync(0xffffffffu, slow_n, o);
  }
  if ((threadIdx.x & 31) == 0) {
    if (bad) atomicAdd(counts, bad);
    if (slow_n) atomicAdd(counts + 1, slow_n);
  }
}

template <bool kMasked, bool kVec>
cudaError_t lh_prepare(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(lh_row_ingest_kernel<kMasked, kVec>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// clusters of kCluster blocks with smem bytes each that the card holds at
// once, asked once per device and size
template <bool kMasked, bool kVec>
int lh_resident_clusters(size_t smem) {
  static int cached[64][2][2];
  static size_t cached_smem[64][2][2];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 63;
  int& c = cached[dev][kMasked][kVec];
  if (c > 0 && cached_smem[dev][kMasked][kVec] == smem) return c;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, lh_row_ingest_kernel<kMasked, kVec>, &cfg) !=
          cudaSuccess ||
      clusters < 1) {
    cudaGetLastError();
    return 1;
  }
  c = clusters;
  cached_smem[dev][kMasked][kVec] = smem;
  return clusters;
}

// the launch's blocks: whole clusters, no more than the card holds at
// once nor kBlocksPerSm an SM, and at least one pass of loads a block
template <bool kMasked, bool kVec>
long long lh_blocks(long long n, size_t smem) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long pass = static_cast<long long>(kCluster) * kThreads * kUnroll * 4;
  long long clusters = (n + pass - 1) / pass;
  const long long by_sm = static_cast<long long>(sms) * kBlocksPerSm / kCluster;
  if (clusters > by_sm) clusters = by_sm;
  const long long resident = lh_resident_clusters<kMasked, kVec>(smem);
  if (clusters > resident) clusters = resident;
  if (clusters < 1) clusters = 1;
  return clusters * kCluster;
}

template <bool kMasked, bool kVec>
cudaError_t lh_launch(int* acc_row, const int* ids, const float* values, const float* table,
                      long long n, long long head, int num_buckets, int bucket_limit,
                      int precision, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(num_buckets) * sizeof(int);
  cudaError_t e = lh_prepare<kMasked, kVec>(smem);
  if (e != cudaSuccess) return e;
  const long long blocks = lh_blocks<kMasked, kVec>(n, smem);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, lh_row_ingest_kernel<kMasked, kVec>, acc_row, ids, values,
                         table, n, head, num_buckets, bucket_limit,
                         static_cast<float>(precision));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// table: float32 [bucket_limit + 1] of ops/codec.bucket_thresholds
extern "C" int lh_row_ingest(void* acc_row, const void* ids, const void* values,
                             const void* table, long long n, int num_buckets,
                             int bucket_limit, int precision, void* stream) {
  if (num_buckets != 2 * bucket_limit + 1 || bucket_limit < 1 || n < 0 ||
      static_cast<long long>(num_buckets) * 4 > kMaxShared || precision < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const uintptr_t va = reinterpret_cast<uintptr_t>(values) & 15u;
  const bool masked = ids != nullptr;
  // 16-byte loads need the values and ids at one offset of a 16-byte line
  const bool vec = !masked || (reinterpret_cast<uintptr_t>(ids) & 15u) == va;
  long long head = static_cast<long long>((16u - va) & 15u) / 4;
  if (head > n) head = n;
  int* a = static_cast<int*>(acc_row);
  const int* i = static_cast<const int*>(ids);
  const float* v = static_cast<const float*>(values);
  const float* t = static_cast<const float*>(table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (masked) {
    e = vec ? lh_launch<true, true>(a, i, v, t, n, head, num_buckets, bucket_limit, precision, st)
            : lh_launch<true, false>(a, i, v, t, n, 0, num_buckets, bucket_limit, precision, st);
  } else {
    e = lh_launch<false, true>(a, i, v, t, n, head, num_buckets, bucket_limit, precision, st);
  }
  return static_cast<int>(e);
}

// the blocks (clusters of 8) a masked launch over n samples takes, or a
// negated CUDA error
extern "C" int lh_row_ingest_blocks(long long n, int num_buckets) {
  const size_t smem = static_cast<size_t>(num_buckets) * sizeof(int);
  const cudaError_t e = lh_prepare<true, true>(smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return static_cast<int>(lh_blocks<true, true>(n, smem));
}

// counts: device uint64 [2] (mismatches, table reads), added to
extern "C" int lh_row_codec_check(const void* table, long long start, long long count,
                                  int bucket_limit, int precision, void* counts,
                                  void* stream) {
  if (start < 0 || count < 0 || start + count > (1LL << 32) || bucket_limit < 1 ||
      precision < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (count == 0) return static_cast<int>(cudaGetLastError());
  lh_codec_check_kernel<<<lh_grid(count, 256, 8), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<unsigned long long>(start),
      static_cast<unsigned long long>(count), bucket_limit, precision,
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}
