// K8: multirow ingest — accumulate a block-sorted, pre-bucketed layout.
//
// Replaces loghisto_tpu/ops/pallas_multirow.py `_kernel` (launched by
// make_multirow_ingest through pl.pallas_call).  Same function: for every
// layout entry j of tile t = j / tile with 0 <= rows[j] < rows_tile,
//     acc[tile_block[t] * rows_tile + rows[j], bidx[j]] += 1,
// acc int32 [M, B] updated in place.  Filler entries (rows[j] ==
// rows_tile, anywhere in a tile, whole parked tail tiles included) add
// nothing; a cell outside acc drops, as in the plain version.  Any
// tile_block is served: a block may come back after another.
//
// The TPU kernel turns each 2048-entry tile into a bf16 one-hot product
// on the MXU and keeps the row block resident in VMEM across the serial
// grid.  Hopper has exact int32 atomics and updates the accumulator in
// place, so none of that is carried over.
//
// Bound on the card: the 4 B row of each layout entry, the 4 B bucket of
// each real entry, 4 B per tile, and the read-modify-write of each touched
// cell: 0.0062 ms for 2^20 Zipf(1.3) samples at 10,000 x 8193 (3.6 M
// entries, 70% filler).  The earlier kernel (9e897f6: one thread an entry,
// a warp fold of equal cells, one global atomic a group) took 0.056: its
// atomics alone on the same cells take 0.052, 0.019 without the two
// hottest rows, and the walk over the layout alone 0.0054 (PERF.md;
// scripts/torch_kernel_ab.py k8, NVIDIA H100 80GB HBM3, 700 W).  The
// layout already groups the hot rows: 55% of such a batch falls in row
// block 0, one run of 284 consecutive tiles.  The design:
//   * a persistent grid of clusters of 8 512-thread blocks, at most 4
//     blocks an SM, no more clusters than the card holds at once (62 on
//     the H100) and at least kMinSpan tiles a cluster; each cluster takes
//     one contiguous range of tiles, and block r of it the tiles r, r + 8,
//     ... of the range, 16-byte loads (4 entries a thread a tile); a warp
//     whose rows are all filler reads no bucket;
//   * warp 0 of each block finds the first longest run of one tile_block
//     value in its cluster's range (every block finds the same) and counts
//     the whole run it belongs to across the range's ends.  If the whole
//     run holds at least kRunMin tiles (many clusters then add into the
//     same rows), the piece's entries add into a [rows_tile, B] histogram
//     spread over the cluster's shared memory: bin b of every row lives in
//     block b % 8 (an even share whatever rows are hot; 32.8 KB a block at
//     8 x 8193), reached through distributed shared memory after a warp
//     folds equal cells (__match_any_sync, so a metric that repeats one
//     value costs one add a warp); at the end each block adds its nonzero
//     bins to acc, one global atomic a live cell per cluster and not one
//     per sample;
//   * every other tile adds each entry with its own global atomic;
//   * the route is chosen from the run length the kernel reads, nothing
//     else; the histogram is used only where it fits in a block's shared
//     memory (rows_tile * ceil(B / 8) int32, up to 56 rows at 8193
//     buckets) and the run's block lies inside acc.
// The constants were measured in one call (scripts/torch_kernel_ab.py
// designs; ms on Zipf 2^20 at M = 16 / 256 / 10,000, then uniform at 256 /
// 10,000): this kernel 0.0299 / 0.0254 / 0.0270, 0.0221 / 0.0334.  The
// variants were measured with kMinSpan 8: that kernel 0.0337 / 0.0290 /
// 0.0270, 0.0227 / 0.0334; kMinSpan 24 0.0308 / 0.0230 / 0.0270, 0.0224 /
// 0.0335; 2 blocks an SM with 4 tiles in flight 0.0293 / 0.0276 / 0.0332,
// 0.0192 / 0.0358; 2 tiles in flight 0.0339 / 0.0283 / 0.0269, 0.0231 /
// 0.0352; the run's piece alone against kRunMin 8 in place of the whole
// run against 32: 256 uniform 0.0270 (its 16-tile runs repeat few cells);
// a warp fold on the direct route: 256 / 10,000 uniform 0.0379 / 0.0380;
// every tile direct: 0.0563 / 0.0570 / 0.0586.  Integer adds commute: the
// result equals the plain version bit for bit.
#include <cooperative_groups.h>

#include "codec.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kPer = 4;                   // entries a thread a tile
constexpr int kTile = kThreads * kPer;    // ops/row_ingest.SAMPLE_TILE
constexpr int kCluster = 8;
constexpr int kBlocksPerSm = 4;
constexpr int kInFlight = 1;              // tiles a block loads at once
constexpr int kRunMin = 32;               // tiles of a run that take the histogram
constexpr int kMinSpan = 16;              // tiles a cluster takes at least
static_assert(kRunMin <= 32, "lh_run_beyond counts with one warp");
constexpr long long kMaxShared = 232448;  // 227 KB, a Hopper block's most

struct RunPlan {
  int start, end, block;
  int whole;  // tiles of the whole run holding [start, end), counted up
              // to kRunMin past each end of it
};

__device__ __forceinline__ void lh_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void lh_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// tiles next to [start, end) on one side (step -1 or +1) within [0, tiles)
// that hold `block`, counted up to kRunMin, by one warp
__device__ int lh_run_beyond(const int* __restrict__ tile_block, int from, int step,
                             int tiles, int block) {
  const int lane = threadIdx.x & 31;
  const int t = from + step * lane;
  const bool other = lane >= kRunMin || t < 0 || t >= tiles || __ldg(tile_block + t) != block;
  const unsigned stop = __ballot_sync(0xffffffffu, other);
  return stop ? __ffs(stop) - 1 : 32;
}

// the first longest run of one tile_block value in [ts, te), and the
// length of the whole run it belongs to, by one warp
__device__ RunPlan lh_longest_run(const int* __restrict__ tile_block, int ts, int te,
                                  int tiles) {
  const int lane = threadIdx.x & 31;
  RunPlan best = {ts, ts, 0, 0};
  int cur = ts;
  int carry = 0;
  for (int base = ts; base < te; base += 32) {
    const int t = base + lane;
    const int v = t < te ? __ldg(tile_block + t) : 0;
    int prev = __shfl_up_sync(0xffffffffu, v, 1);
    if (lane == 0) prev = carry;
    const bool start = t < te && (t == ts || v != prev);
    unsigned mask = __ballot_sync(0xffffffffu, start);
    carry = __shfl_sync(0xffffffffu, v, 31);
    while (mask) {  // warp-uniform
      const int pos = base + __ffs(mask) - 1;
      mask &= mask - 1;
      if (pos - cur > best.end - best.start) best = {cur, pos, 0, 0};
      cur = pos;
    }
  }
  if (te - cur > best.end - best.start) best = {cur, te, 0, 0};
  best.block = __ldg(tile_block + best.start);
  best.whole = lh_run_beyond(tile_block, best.start - 1, -1, tiles, best.block) +
               (best.end - best.start) +
               lh_run_beyond(tile_block, best.end, 1, tiles, best.block);
  return best;
}

// The tiles first, first + 8, ... of [first, last) that this block takes:
// kInFlight of them loaded at once.  kHist adds into the cluster's
// histogram of the run's row block; otherwise each entry goes to acc with
// its own global atomic.
template <bool kHist>
__device__ __forceinline__ void lh_tiles(int* __restrict__ acc, int* hist, int hist_row,
                                         const int* __restrict__ rows,
                                         const int* __restrict__ bidx,
                                         const int* __restrict__ tile_block, int first,
                                         int last, int rows_tile, int num_metrics,
                                         int num_buckets) {
  const int4* rows4 = reinterpret_cast<const int4*>(rows);
  const int4* bidx4 = reinterpret_cast<const int4*>(bidx);
  cg::cluster_group cluster = cg::this_cluster();
  for (int t0 = first; t0 < last; t0 += kCluster * kInFlight) {
    int4 r[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int t = t0 + u * kCluster;
      r[u] = t < last ? __ldg(rows4 + static_cast<long long>(t) * kThreads + threadIdx.x)
                      : make_int4(rows_tile, rows_tile, rows_tile, rows_tile);
    }
    int4 b[kInFlight];
    bool any[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int t = t0 + u * kCluster;
      const bool real = static_cast<unsigned>(r[u].x) < static_cast<unsigned>(rows_tile) ||
                        static_cast<unsigned>(r[u].y) < static_cast<unsigned>(rows_tile) ||
                        static_cast<unsigned>(r[u].z) < static_cast<unsigned>(rows_tile) ||
                        static_cast<unsigned>(r[u].w) < static_cast<unsigned>(rows_tile);
      any[u] = __any_sync(0xffffffffu, real);
      b[u] = real ? __ldg(bidx4 + static_cast<long long>(t) * kThreads + threadIdx.x)
                  : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (!any[u]) continue;  // warp-uniform: 32 x 4 filler entries
      const int t = t0 + u * kCluster;
      const long long row0 =
          kHist ? 0 : static_cast<long long>(__ldg(tile_block + t)) * rows_tile;
      const int rr[kPer] = {r[u].x, r[u].y, r[u].z, r[u].w};
      const int bb[kPer] = {b[u].x, b[u].y, b[u].z, b[u].w};
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const bool ok = static_cast<unsigned>(rr[e]) < static_cast<unsigned>(rows_tile) &&
                        static_cast<unsigned>(bb[e]) < static_cast<unsigned>(num_buckets);
        if (kHist) {
          // the run's block lies inside acc: only the bucket can drop
          const int key = ok ? rr[e] * num_buckets + bb[e] : -1;
          const unsigned peers = __match_any_sync(0xffffffffu, key);
          if (ok && (threadIdx.x & 31) == __ffs(peers) - 1) {
            int* owner = cluster.map_shared_rank(hist, bb[e] % kCluster);
            atomicAdd(owner + rr[e] * hist_row + bb[e] / kCluster, __popc(peers));
          }
        } else {
          const long long row = row0 + rr[e];
          const long long cell =
              ok && row >= 0 && row < num_metrics ? row * num_buckets + bb[e] : -1;
          if (cell >= 0) atomicAdd(acc + cell, 1);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
lh_multirow_ingest_kernel(int* __restrict__ acc, const int* __restrict__ rows,
                          const int* __restrict__ bidx, const int* __restrict__ tile_block,
                          int tiles, int range, int rows_tile, int num_metrics,
                          int num_buckets, int hist_row, int hist_ok) {
  extern __shared__ int hist[];  // [rows_tile, hist_row]: bins b = k (mod 8)
  __shared__ RunPlan plan;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.x / kCluster;
  const int ts = c * range;
  const int te = min(tiles, ts + range);
  if (threadIdx.x < 32) {
    const RunPlan p =
        ts < te ? lh_longest_run(tile_block, ts, te, tiles) : RunPlan{ts, ts, 0, 0};
    if (threadIdx.x == 0) plan = p;
  }
  __syncthreads();
  const RunPlan p = plan;
  // every block of the cluster reads the same plan: the choice is uniform
  const bool use = hist_ok && p.whole >= kRunMin && p.block >= 0 &&
                   static_cast<long long>(p.block) * rows_tile + rows_tile <= num_metrics;
  const int slots = rows_tile * hist_row;
  if (use) {
    for (int s = threadIdx.x; s < slots; s += kThreads) hist[s] = 0;
    lh_cluster_arrive();  // this block's histogram is clear
  }
  // the direct tiles: the range less the run
  const int first = ts + rank;
  if (use) {
    lh_tiles<false>(acc, hist, hist_row, rows, bidx, tile_block, first,
                    min(te, p.start), rows_tile, num_metrics, num_buckets);
    const int after = p.end + ((first - p.end) % kCluster + kCluster) % kCluster;
    lh_tiles<false>(acc, hist, hist_row, rows, bidx, tile_block, after, te, rows_tile,
                    num_metrics, num_buckets);
    lh_cluster_wait();  // every histogram of the cluster is clear
    const int in_run = p.start + ((first - p.start) % kCluster + kCluster) % kCluster;
    lh_tiles<true>(acc, hist, hist_row, rows, bidx, tile_block, in_run, p.end, rows_tile,
                   num_metrics, num_buckets);
    lh_cluster_arrive();  // every add of the cluster has landed
    lh_cluster_wait();
    const long long base = static_cast<long long>(p.block) * rows_tile;
    for (int s = threadIdx.x; s < slots; s += kThreads) {
      const int v = hist[s];
      const int r = s / hist_row;
      const int bin = (s - r * hist_row) * kCluster + rank;
      if (v) atomicAdd(acc + (base + r) * num_buckets + bin, v);
    }
  } else {
    lh_tiles<false>(acc, hist, hist_row, rows, bidx, tile_block, first, te, rows_tile,
                    num_metrics, num_buckets);
  }
}

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

// clusters with smem bytes a block that the card holds at once, asked once
// per device and size
int lh_resident_clusters(size_t smem) {
  static int cached[64];
  static size_t cached_smem[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 63;
  if (cached[dev] > 0 && cached_smem[dev] == smem) return cached[dev];
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = lh_config(kCluster, smem, attr, nullptr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, lh_multirow_ingest_kernel, &cfg) !=
          cudaSuccess ||
      clusters < 1) {
    cudaGetLastError();
    return 1;
  }
  cached[dev] = clusters;
  cached_smem[dev] = smem;
  return clusters;
}

// the launch's clusters (of 8 blocks) over `tiles` tiles: at most
// kBlocksPerSm blocks an SM and what the card holds at once, and at least
// kMinSpan tiles a cluster; *smem gets the histogram's bytes (0: it does
// not fit)
long long lh_clusters(int tiles, int rows_tile, int num_buckets, size_t* smem) {
  const long long hist_bytes =
      static_cast<long long>(rows_tile) * ((num_buckets + kCluster - 1) / kCluster) * 4;
  *smem = hist_bytes <= kMaxShared ? static_cast<size_t>(hist_bytes) : 0;
  if (*smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lh_multirow_ingest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(*smem));
    if (e != cudaSuccess) return -static_cast<long long>(e);
  }
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  long long clusters = (tiles + kMinSpan - 1) / kMinSpan;
  const long long by_sm = static_cast<long long>(sms) * kBlocksPerSm / kCluster;
  if (clusters > by_sm) clusters = by_sm;
  const long long resident = lh_resident_clusters(*smem);
  if (clusters > resident) clusters = resident;
  return clusters < 1 ? 1 : clusters;
}

}  // namespace

extern "C" int lh_multirow_ingest(void* acc, const void* rows, const void* bidx,
                                  const void* tile_block, long long n, int tile,
                                  int rows_tile, int num_metrics, int num_buckets,
                                  void* stream) {
  if (tile != kTile || rows_tile <= 0 || n < 0 || n % tile != 0 || num_metrics < 0 ||
      num_buckets <= 0 || n / tile > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const int tiles = static_cast<int>(n / tile);
  size_t smem = 0;
  const long long clusters = lh_clusters(tiles, rows_tile, num_buckets, &smem);
  if (clusters < 0) return static_cast<int>(-clusters);
  const int range = static_cast<int>((tiles + clusters - 1) / clusters);
  const int hist_row = (num_buckets + kCluster - 1) / kCluster;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      lh_config(static_cast<int>(clusters * kCluster), smem, attr,
                static_cast<cudaStream_t>(stream));
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, lh_multirow_ingest_kernel, static_cast<int*>(acc),
      static_cast<const int*>(rows), static_cast<const int*>(bidx),
      static_cast<const int*>(tile_block), tiles, range, rows_tile, num_metrics,
      num_buckets, hist_row, static_cast<int>(smem > 0));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the clusters a launch over `tiles` tiles takes (each a contiguous range
// of ceil(tiles / clusters) tiles), or a negated CUDA error; *hist_fits
// tells whether the run histogram fits in a block's shared memory
extern "C" int lh_multirow_clusters(int tiles, int rows_tile, int num_buckets,
                                    int* hist_fits) {
  if (tiles <= 0 || rows_tile <= 0 || num_buckets <= 0) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem = 0;
  const long long clusters = lh_clusters(tiles, rows_tile, num_buckets, &smem);
  *hist_fits = smem > 0;
  return static_cast<int>(clusters);
}
