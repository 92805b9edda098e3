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
// K4f, lh_fused_paged_ingest — replaces loghisto_tpu/ops/fused_ingest.py
// `fused_paged_ingest_batch` (whose one pallas_call is K4, after XLA
// passes that compress, encode, translate, then sort and segment-sum the
// batch's duplicate cells).  One thread per raw sample:
//     col  = clip(codec(value), -bl, bl) + bl        (codec.cuh, float64)
//     c    = row_codec[id]                           (-1: drop)
//     s    = enc_luts[c, col]                        (storage bucket)
//     slot = page_table[id, s / page_size]           (-1 or 0: drop)
//     pool[slot, s % page_size] += 1
//
// The TPU round-trips a whole page through VMEM by DMA per cell on a
// serial grid — the only way it adds duplicate cells exactly — so the
// JAX step folds duplicates first to bound that cost by unique cells.
// Hopper's int32 atomicAdd adds duplicates exactly, so there is no sort,
// no fold and no padding: both kernels are one grid-stride loop and one
// atomic per item.  The three lookup tables of K4f (~98 KB at B = 8193
// for the LUTs; the page table is gathered one 4 B entry per sample)
// stay in L2.  Flat indices are formed in 64 bits: id * pages_per_row
// and slot * page_size reach 2^29 at 2^20 rows and 2^21 slots.
//
// Bound on the card: the bytes each item moves — K4 12 B per triple,
// K4f 8 B per sample plus ~8 B of table gathers — and the atomic
// read-modify-write of each touched pool cell (8 B).
#include "codec.cuh"

__global__ void lh_paged_scatter_kernel(int* __restrict__ pool,
                                        const int* __restrict__ packed,
                                        long long n, int pool_pages,
                                        int page_size) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int slot = packed[3 * i];
    if (slot <= 0 || slot >= pool_pages) continue;
    const int count = packed[3 * i + 2];
    if (count == 0) continue;
    int off = packed[3 * i + 1];
    off = off < 0 ? 0 : (off >= page_size ? page_size - 1 : off);
    atomicAdd(pool + static_cast<long long>(slot) * page_size + off, count);
  }
}

__global__ void lh_fused_paged_ingest_kernel(
    int* __restrict__ pool, const int* __restrict__ ids,
    const float* __restrict__ values, long long n,
    const int* __restrict__ row_codec, const int* __restrict__ enc_luts,
    const int* __restrict__ page_table, int num_metrics, int num_codecs,
    int pages_per_row, int pool_pages, int page_size, int bucket_limit,
    int precision) {
  const int num_buckets = 2 * bucket_limit + 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int id = ids[i];
    if (id < 0 || id >= num_metrics) continue;
    const int codec = row_codec[id];
    if (codec < 0 || codec >= num_codecs) continue;
    const int col = lh_dense_col(values[i], bucket_limit, precision);
    const int s = enc_luts[static_cast<long long>(codec) * num_buckets + col];
    if (s < 0) continue;  // LUT entries are storage indices >= 0
    const int page = s / page_size;
    if (page >= pages_per_row) continue;
    const int slot =
        page_table[static_cast<long long>(id) * pages_per_row + page];
    if (slot <= 0 || slot >= pool_pages) continue;
    atomicAdd(pool + static_cast<long long>(slot) * page_size + (s - page * page_size), 1);
  }
}

extern "C" int lh_paged_scatter(void* pool, const void* packed, long long n,
                                int pool_pages, int page_size, void* stream) {
  if (page_size <= 0 || pool_pages <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  lh_paged_scatter_kernel<<<lh_grid(n, threads, 16), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(pool), static_cast<const int*>(packed), n, pool_pages,
      page_size);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lh_fused_paged_ingest(
    void* pool, const void* ids, const void* values, long long n,
    const void* row_codec, const void* enc_luts, const void* page_table,
    int num_metrics, int num_codecs, int pages_per_row, int pool_pages,
    int page_size, int bucket_limit, int precision, void* stream) {
  if (page_size <= 0 || pool_pages <= 0 || pages_per_row <= 0 || bucket_limit <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  lh_fused_paged_ingest_kernel<<<lh_grid(n, threads, 16), threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(pool), static_cast<const int*>(ids),
      static_cast<const float*>(values), n, static_cast<const int*>(row_codec),
      static_cast<const int*>(enc_luts), static_cast<const int*>(page_table),
      num_metrics, num_codecs, pages_per_row, pool_pages, page_size,
      bucket_limit, precision);
  return static_cast<int>(cudaGetLastError());
}
