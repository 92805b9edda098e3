// K1: fused raw ingest — codec and scatter-add in one launch.
//
// Replaces loghisto_tpu/ops/fused_ingest.py `_kernel` (launched by
// fused_ingest_batch through pl.pallas_call).  Same function:
//     acc[id, col(v)] += 1 for every sample with 0 <= id < M,
// acc int32 [M, B] updated in place (B = 2*bucket_limit + 1).
//
// The TPU kernel sorts samples into row blocks, pads them to tiles and
// adds one-hot matrices on the MXU, because a TPU has no fast scatter.
// Hopper has int32 atomics, so none of that machinery is carried over.
// Ids outside [0, M) drop, as sanitize_ids + mode="drop" does; any row
// count is served (no M % 8 row tile).
//
// Bound on the card: the byte bound counts the 8 B/sample read of
// (id, value) and the read-modify-write of each touched cell (8 B):
// 0.0032 ms for 2^20 Zipf(1.3) samples at 10,000 x 8193.  What holds K1
// back is the atomics.  On precomputed cells they alone take what the
// earlier kernel (fd1717c: one thread a sample, one global atomicAdd
// each) takes: 0.053 ms on Zipf ids, 0.024 on uniform ids; the codec
// alone takes 0.008.  Without the two most frequent rows (36% of a Zipf batch) the
// Zipf atomics take 0.019: the adds of a few hot rows queue on the L2
// lines that hold them.  The design takes the hot rows' repeats off the
// global atomics:
//   * a persistent grid of 512-thread blocks, 2 an SM, each taking one
//     contiguous chunk of the batch, in clusters of 8 blocks; the grid is
//     as many whole clusters as the card holds at once, the shared memory
//     asked for keeping it to 2 blocks an SM
//     (ops/fused_ingest.plan_fused_ingest, lh_fused_ingest_clusters);
//   * each thread loads 4 samples (coalesced, predicated on the chunk's
//     end) before it runs their codecs; a warp matches the samples' rows
//     (__match_any_sync): a sample whose row has fewer than 3 lanes of
//     its warp goes straight to a global atomicAdd; the others
//     are folded by cell and the lowest lane of each group adds the
//     group's count to the cluster's cell table;
//   * the table lives in the cluster's distributed shared memory: 2^12
//     slots a block, open-addressed, keyed by the flat cell id * B + col
//     (32-bit keys while M*B < 2^31, 64-bit beyond), int32 counts; a
//     key's hash picks its slot and the block of the cluster that holds
//     it.  Probing is bounded (8 slots) and a cell that finds no slot
//     goes to the global atomic, so the table never loses a sample;
//   * the tables are cleared before any block of the cluster writes one
//     (a split barrier: a warp waits only before its first add into a
//     table) and flushed when every block has written: one global
//     atomicAdd per filled slot, the blocks starting their flush at slots
//     spread over the table.
// A hot cell then takes one global add per cluster and not one per
// sample.  Integer adds commute: the result equals the plain version bit
// for bit whatever the order.
//
// Measured and dropped (the design sweep of scripts/torch_kernel_ab.py
// k1, since taken out of the script, on NVIDIA H100 80GB HBM3, 700 W; ms
// on Zipf 2^20 / uniform 2^20 / Zipf 2^22 samples, against the earlier
// kernel's 0.054 / 0.023 / 0.249; PERF.md):
//   * every sample into a per-block table, 1 block an SM, 16,384 slots:
//     0.061 / 0.069 / 0.291 (the inserts and the flush cost more than the
//     repeats they merge);
//   * only the hot rows' samples into per-block tables, no cluster:
//     0.037 / 0.024 / 0.110; clusters of 2: 0.030 / 0.026 / 0.103; of 4:
//     0.025 / 0.027 / 0.101;
//   * a grid one cluster past what the card holds at once: 0.032 / 0.035 /
//     0.123; 256-thread blocks, 2 samples a thread a pass, or register
//     caps: no faster.
// Uniform ids pay for the clusters: 0.027 ms with no row hot, against
// 0.0245 for per-block tables on the full grid of 264 blocks and 0.0265
// for clusters of 2 on that grid, so about 2 us is the cluster launch and
// its barriers and 1 us the grid of 30 whole clusters (240 blocks).  This
// is an open fault (ROADMAP Queue 2).
#include <cooperative_groups.h>

#include "codec.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;
constexpr int kProbes = 8;
constexpr int kCluster = 8;       // blocks that share their tables
constexpr int kClusterBits = 3;   // log2(kCluster)
constexpr int kHotMin = 3;        // lanes of a warp on one row that make it hot
constexpr int kMinTableLog2 = 8;
constexpr int kMaxTableLog2 = 12;
constexpr long long kMaxShared = 232448;  // 227 KB, a Hopper block's most

__device__ __forceinline__ unsigned lh_slot_of(unsigned key, int bits) {
  return (key * 2654435761u) >> (32 - bits);
}

__device__ __forceinline__ unsigned lh_slot_of(unsigned long long key, int bits) {
  return static_cast<unsigned>((key * 0x9E3779B97F4A7C15ull) >> (64 - bits));
}

// add c to cell `key`: into its slot of the table of the cluster's block
// that owns the key, or into acc when the bounded probe finds neither the
// key nor an empty slot
template <class Key>
__device__ __forceinline__ void lh_table_add(Key* keys, int* counts, int log2, Key key,
                                             int c, int* __restrict__ acc) {
  constexpr Key kEmpty = ~Key(0);
  const unsigned mask = (1u << log2) - 1u;
  const unsigned g = lh_slot_of(key, log2 + kClusterBits);
  unsigned s = g & mask;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned owner = g >> log2;
  keys = cluster.map_shared_rank(keys, owner);
  counts = cluster.map_shared_rank(counts, owner);
#pragma unroll 1
  for (int p = 0; p < kProbes; ++p, s = (s + 1u) & mask) {
    Key k = *reinterpret_cast<volatile Key*>(keys + s);
    if (k == kEmpty) {
      k = atomicCAS(keys + s, kEmpty, key);
      if (k == kEmpty) k = key;  // the slot is now this key's
    }
    if (k == key) {
      atomicAdd(counts + s, c);
      return;
    }
  }
  atomicAdd(acc + key, c);
}

// The cluster's tables are cleared before any block of it writes one and
// flushed after every block has: a split barrier.  Each thread arrives
// once its block's table is clear; a warp waits on that phase only before
// its first add into a table (or at the end), so warps with no hot
// sample never stall on the start of the cluster's other blocks.
__device__ __forceinline__ void lh_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void lh_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <class Key>
__global__ void __launch_bounds__(kThreads)
lh_fused_ingest_kernel(int* __restrict__ acc, const int* __restrict__ ids,
                       const float* __restrict__ values, long long n, long long chunk,
                       int num_metrics, int num_buckets, int bucket_limit, int precision,
                       int log2) {
  extern __shared__ __align__(16) unsigned char lh_smem[];
  constexpr Key kEmpty = ~Key(0);
  const int slots = 1 << log2;
  Key* keys = reinterpret_cast<Key*>(lh_smem);
  int* counts = reinterpret_cast<int*>(keys + slots);
  for (int s = threadIdx.x; s < slots; s += kThreads) {
    keys[s] = kEmpty;
    counts[s] = 0;
  }
  lh_cluster_arrive();
  bool cleared = false;  // this warp has seen every table of the cluster clear

  const long long begin = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = begin + chunk < n ? begin + chunk : n;
  const int lane = threadIdx.x & 31;
  // the loop bound depends on the block only: every lane of a warp runs
  // every iteration and reaches every __match_any_sync
  for (long long base = begin; base < end; base += kThreads * kUnroll) {
    int id[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads + threadIdx.x;
      const bool in = i < end;
      id[u] = in ? __ldg(ids + i) : -1;
      v[u] = in ? __ldg(values + i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = id[u] >= 0 && id[u] < num_metrics;
      const unsigned rows = __match_any_sync(0xffffffffu, ok ? id[u] : -1);
      const bool hot = ok && __popc(rows) >= kHotMin;
      const Key cell =
          ok ? static_cast<Key>(id[u]) * static_cast<Key>(num_buckets) +
                   static_cast<Key>(lh_dense_col(v[u], bucket_limit, precision))
             : kEmpty;
      if (ok && !hot) atomicAdd(acc + cell, 1);
      if (__any_sync(0xffffffffu, hot)) {  // warp-uniform
        if (!cleared) {
          lh_cluster_wait();
          cleared = true;
        }
        const Key key = hot ? cell : kEmpty;
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        if (hot && lane == __ffs(peers) - 1) {
          lh_table_add<Key>(keys, counts, log2, key, __popc(peers), acc);
        }
      }
    }
  }
  // every add of the cluster has reached its table
  if (!cleared) lh_cluster_wait();
  lh_cluster_arrive();
  lh_cluster_wait();

  const unsigned rot = static_cast<unsigned>(
      static_cast<unsigned long long>(blockIdx.x) * slots / gridDim.x);
  for (int j = threadIdx.x; j < slots; j += kThreads) {
    const unsigned s = (static_cast<unsigned>(j) + rot) & static_cast<unsigned>(slots - 1);
    const int c = counts[s];
    if (c) atomicAdd(acc + keys[s], c);
  }
}

template <class Key>
cudaError_t lh_prepare(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(lh_fused_ingest_kernel<Key>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <class Key>
cudaLaunchConfig_t lh_config(int blocks, size_t smem, cudaLaunchAttribute* attr,
                             cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
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
  return cfg;
}

// clusters of kCluster blocks of smem bytes each that the card holds at once
template <class Key>
int lh_clusters(size_t smem) {
  cudaError_t e = lh_prepare<Key>(smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = lh_config<Key>(kCluster, smem, attr, nullptr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, lh_fused_ingest_kernel<Key>, &cfg);
  return e == cudaSuccess ? clusters : -static_cast<int>(e);
}

template <class Key>
cudaError_t lh_launch(int* acc, const int* ids, const float* values, long long n,
                      int num_metrics, int num_buckets, int bucket_limit, int precision,
                      int blocks, long long chunk, int log2, size_t smem,
                      cudaStream_t stream) {
  cudaError_t e = lh_prepare<Key>(smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = lh_config<Key>(blocks, smem, attr, stream);
  e = cudaLaunchKernelEx(&cfg, lh_fused_ingest_kernel<Key>, acc, ids, values, n, chunk,
                         num_metrics, num_buckets, bucket_limit, precision, log2);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// blocks x chunk samples cover the batch, in clusters of 8 blocks; each
// block's table has 2^table_log2 slots (2^8 to 2^12) of key_bits-bit keys
// (32 only while num_metrics * num_buckets < 2^31) in shared_bytes of
// dynamic shared memory (at least the table; more caps the blocks an SM
// holds).  ops/fused_ingest.plan_fused_ingest computes them.
extern "C" int lh_fused_ingest(void* acc, const void* ids, const void* values,
                               long long n, int num_metrics, int num_buckets,
                               int bucket_limit, int precision, int blocks,
                               long long chunk, int table_log2, int key_bits,
                               long long shared_bytes, void* stream) {
  const long long cells = static_cast<long long>(num_metrics) * num_buckets;
  if (num_buckets != 2 * bucket_limit + 1 || n < 0 || num_metrics < 0 ||
      table_log2 < kMinTableLog2 || table_log2 > kMaxTableLog2 ||
      (key_bits != 32 && key_bits != 64) || (key_bits == 32 && cells >= (1LL << 31)) ||
      shared_bytes < (1LL << table_log2) * (key_bits / 8 + 4) || shared_bytes > kMaxShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (blocks < 1 || chunk < 1 || static_cast<long long>(blocks) * chunk < n ||
      blocks % kCluster != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* a = static_cast<int*>(acc);
  const int* i = static_cast<const int*>(ids);
  const float* v = static_cast<const float*>(values);
  const size_t smem = static_cast<size_t>(shared_bytes);
  const cudaError_t err =
      key_bits == 32
          ? lh_launch<unsigned>(a, i, v, n, num_metrics, num_buckets, bucket_limit,
                                precision, blocks, chunk, table_log2, smem, st)
          : lh_launch<unsigned long long>(a, i, v, n, num_metrics, num_buckets,
                                          bucket_limit, precision, blocks, chunk,
                                          table_log2, smem, st);
  return static_cast<int>(err);
}

// clusters of 8 blocks with key_bits-bit tables in shared_bytes of
// dynamic shared memory that the current device holds at once (> 0), or
// a negated CUDA error
extern "C" int lh_fused_ingest_clusters(int key_bits, long long shared_bytes) {
  if ((key_bits != 32 && key_bits != 64) || shared_bytes < 0 || shared_bytes > kMaxShared) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(shared_bytes);
  return key_bits == 32 ? lh_clusters<unsigned>(smem)
                        : lh_clusters<unsigned long long>(smem);
}
