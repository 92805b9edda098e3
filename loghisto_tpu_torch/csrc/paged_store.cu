// K4 and K4f: paged bucket storage on Hopper.
//
// K4, lh_paged_scatter — replaces loghisto_tpu/ops/paged_store.py
// `pallas_paged_scatter` (its pallas_call runs the sparse-ingest kernel
// with pool pages as rows).  For every row of the int32 [n, 3] array of
// translated (slot, offset, count) triples with 0 < slot < P:
//     pool[slot, clip(offset, 0, page_size - 1)] += count,
// pool int32 [P, page_size] updated in place.  Slot 0 is the reserved
// zero page and is never written; pads carry slot -1.
//
// Bound on the card: the byte bound counts 12 B per triple read once and
// the read-modify-write of each touched pool cell (8 B): 0.0056 ms for
// phase k4's band batch (933,888 padded triples).  What holds K4 back is
// random access to the pool: the paged sparse route hands it about one
// cell a page of a 2 GiB pool (40x the L2), so each cell costs a sector
// read and written back, 713,970 distinct 32-byte sectors, which would
// take 0.0136 ms at 64 B a sector and the data sheet's 3.35 TB/s.
// Measured (scripts/torch_kernel_ab.py k4 on NVIDIA H100 80GB HBM3,
// 700 W; PERF.md): the earlier kernel (fd1717c: one triple a thread in a
// grid-stride loop) 0.054 ms; a plain store in place of the atomic
// 0.055, the same triples with their slots renumbered into a pool of
// only the touched pages 0.054, in a random order 0.064.  The time is
// that of the random cells, whichever instruction writes them: K4 takes
// what a plain store takes, 4x the computed sector time, a gap not yet
// explained (PERF.md section 7).  The kernel is the triple loop of
// csrc/triple_scatter.cuh with K4's cell map (0 < slot < P, offset
// clipped to the page), one triple a thread in 512-thread blocks, the
// grid sized to the triples.  Other layouts, timed with kernels since
// taken out of the A/B script: 4, 2 or 1 triples a thread in blocks of
// 64-512 threads took the band batch within 1% of each other and of the
// earlier kernel (0.0539-0.0550), and this layout was no slower than any
// on the row-grouped interval of the paged threshold (262,144 triples,
// several cells a page: 0.0033-0.0035 against the earlier kernel's
// 0.0034-0.0038).
//
// K4f, lh_fused_paged_ingest — replaces loghisto_tpu/ops/fused_ingest.py
// `fused_paged_ingest_batch` (whose one pallas_call is K4, after XLA
// passes that compress, encode, translate, then sort and segment-sum the
// batch's duplicate cells).  For every raw sample:
//     col  = clip(codec(value), -bl, bl) + bl        (codec.cuh, float64)
//     c    = row_codec[id]                           (-1: drop)
//     s    = enc_luts[c, col]                        (storage bucket)
//     slot = page_major[s / page_size, id]           (-1 or 0: drop)
//     pool[slot, s % page_size] += 1
//
// The TPU round-trips a whole page through VMEM by DMA per cell on a
// serial grid — the only way it adds duplicate cells exactly — so the
// JAX step folds duplicates first to bound that cost by unique cells.
// Hopper's int32 atomicAdd adds duplicates exactly, so there is no sort
// and no padding (D2).
//
// Bound on the card (bytes): 8 B per sample in (id, value), the table
// entries the inputs need — 4 B of row_codec per distinct id, 4 B of
// enc_luts per distinct (codec, col), 4 B of page table per distinct
// (id, page) — and the read-modify-write of each touched pool cell (8 B).
// What holds it back is latency, not bytes: each sample runs a chain of
// three dependent gathers (row codec -> encode LUT -> page table) before
// its random atomic into a 2 GiB pool.  The design:
//   * the page table is read from K4f's own page-major mirror
//     [pages_per_row, M] (PagedStore.device_luts), not [M, pages_per_row]:
//     samples on the same page index of their rows (a row's band of
//     buckets sits on one or two pages) gather from one contiguous M * 4 B
//     slab (4 MB at 2^20 rows), which stays in the 50 MB L2 across
//     launches, where the row-major table (138 MB) costs a random DRAM
//     sector per sample;
//   * each thread takes 4 samples (16 B vector loads of ids and values
//     when both are 16 B aligned) and starts every load of a step for all
//     4 before the next step, so the three dependent gathers of one sample
//     overlap those of the others;
//   * a warp folds equal cells with __match_any_sync and the lowest lane
//     adds the group's count with one atomic (as K8 does), which serves
//     skewed traffic: a hot cell takes one atomic per warp and step, not
//     one per sample.  Every lane takes part; a dropped sample carries the
//     key -1.
// Flat indices are formed in 64 bits: page * M and slot * page_size reach
// 2^25 and 2^29 at 2^20 rows and 2^21 slots.
#include "codec.cuh"
#include "triple_scatter.cuh"

// K4's triple layout (csrc/triple_scatter.cuh): threads a block, triples
// a thread
constexpr int kK4Threads = 512;
constexpr int kK4Per = 1;

__global__ void __launch_bounds__(kK4Threads)
lh_paged_scatter_kernel(int* __restrict__ pool, const int* __restrict__ packed, long long n,
                        int pool_pages, int page_size) {
  lh_scatter_triples<kK4Threads, kK4Per>(packed, n, [&](int slot, int off, int count) {
    if (count == 0 || slot <= 0 || slot >= pool_pages) return;
    off = off < 0 ? 0 : (off >= page_size ? page_size - 1 : off);
    atomicAdd(pool + static_cast<long long>(slot) * page_size + off, count);
  });
}

constexpr int kSamplesPerThread = 4;

__global__ void lh_fused_paged_ingest_kernel(
    int* __restrict__ pool, const int* __restrict__ ids,
    const float* __restrict__ values, long long n,
    const int* __restrict__ row_codec, const int* __restrict__ enc_luts,
    const int* __restrict__ page_major, int num_metrics, int num_codecs,
    int pages_per_row, int pool_pages, int page_size, int bucket_limit,
    int precision, bool vec) {
  constexpr int K = kSamplesPerThread;
  const int num_buckets = 2 * bucket_limit + 1;
  const long long tile = static_cast<long long>(blockDim.x) * K;
  // the loop bound depends on the block only: every lane of a warp runs
  // every iteration and reaches every __match_any_sync
  for (long long base = static_cast<long long>(blockIdx.x) * tile; base < n;
       base += static_cast<long long>(gridDim.x) * tile) {
    const long long i0 = base + static_cast<long long>(threadIdx.x) * K;
    int id[K];
    float v[K];
    if (vec && i0 + K <= n) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(ids + i0));
      const float4 b = __ldg(reinterpret_cast<const float4*>(values + i0));
      id[0] = a.x; id[1] = a.y; id[2] = a.z; id[3] = a.w;
      v[0] = b.x; v[1] = b.y; v[2] = b.z; v[3] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const bool in = i0 + j < n;
        id[j] = in ? __ldg(ids + i0 + j) : -1;
        v[j] = in ? __ldg(values + i0 + j) : 0.0f;
      }
    }
    int codec[K], col[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool ok = id[j] >= 0 && id[j] < num_metrics;
      codec[j] = ok ? __ldg(row_codec + id[j]) : -1;
      col[j] = lh_dense_col(v[j], bucket_limit, precision);
    }
    int st[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool ok = codec[j] >= 0 && codec[j] < num_codecs;
      st[j] = ok ? __ldg(enc_luts + static_cast<long long>(codec[j]) * num_buckets + col[j])
                 : -1;  // LUT entries are storage indices >= 0
    }
    long long cell[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int page = st[j] >= 0 ? st[j] / page_size : pages_per_row;
      const int slot =
          page < pages_per_row
              ? __ldg(page_major + static_cast<long long>(page) * num_metrics + id[j])
              : -1;
      cell[j] = (slot > 0 && slot < pool_pages)
                    ? static_cast<long long>(slot) * page_size + (st[j] - page * page_size)
                    : -1;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const unsigned peers = __match_any_sync(0xffffffffu, cell[j]);
      if (cell[j] >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
        atomicAdd(pool + cell[j], __popc(peers));
      }
    }
  }
}

extern "C" int lh_paged_scatter(void* pool, const void* packed, long long n,
                                int pool_pages, int page_size, void* stream) {
  if (page_size <= 0 || pool_pages <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  lh_paged_scatter_kernel<<<lh_triple_blocks<kK4Threads, kK4Per>(n), kK4Threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(pool), static_cast<const int*>(packed), n, pool_pages,
      page_size);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lh_fused_paged_ingest(
    void* pool, const void* ids, const void* values, long long n,
    const void* row_codec, const void* enc_luts, const void* page_major,
    int num_metrics, int num_codecs, int pages_per_row, int pool_pages,
    int page_size, int bucket_limit, int precision, void* stream) {
  if (page_size <= 0 || pool_pages <= 0 || pages_per_row <= 0 || bucket_limit <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;  // a multiple of 32: whole warps reach the fold
  const bool vec = (reinterpret_cast<uintptr_t>(ids) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(values) % 16 == 0);
  lh_fused_paged_ingest_kernel<<<lh_grid((n + kSamplesPerThread - 1) / kSamplesPerThread,
                                         threads, 16),
                                 threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(pool), static_cast<const int*>(ids),
      static_cast<const float*>(values), n, static_cast<const int*>(row_codec),
      static_cast<const int*>(enc_luts), static_cast<const int*>(page_major),
      num_metrics, num_codecs, pages_per_row, pool_pages, page_size,
      bucket_limit, precision, vec);
  return static_cast<int>(cudaGetLastError());
}
