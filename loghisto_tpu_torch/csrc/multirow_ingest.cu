// K8: multirow ingest — accumulate a block-sorted, pre-bucketed layout.
//
// Replaces loghisto_tpu/ops/pallas_multirow.py `_kernel` (launched by
// make_multirow_ingest through pl.pallas_call).  Same function: for every
// layout entry j of tile t = j / tile with rows[j] < rows_tile,
//     acc[tile_block[t] * rows_tile + rows[j], bidx[j]] += 1,
// acc int32 [M, B] updated in place.  Filler entries (rows[j] ==
// rows_tile, whole parked tail tiles included) add nothing; a cell
// outside acc drops, as in the plain version.
//
// The TPU kernel turns each 2048-entry tile into a bf16 one-hot product
// on the MXU and keeps the row block resident in VMEM across the serial
// grid, reading the aliased input block only on a block's first tile (a
// revisit could see it stale).  Hopper has exact int32 atomics and
// updates the accumulator in place, so none of that is carried over:
// one thread per entry reads its tile's block and adds with atomicAdd.
// Privatising the row block in shared memory is not possible at the
// default width (8 rows x 8193 x 4 B = 262,176 B > 232,448 B a block may
// have), and flushing a 65K-cell tile per 2048 entries would move 32x
// more cells than it adds.
//
// The layout is sorted by row block (stably), so a warp's 32 entries
// mostly share one block and, under a skewed load, often one cell: the
// warp folds equal cells with __match_any_sync and the lowest lane adds
// the group's count with one atomic.
//
// Bound on the card: the 4 B row of each layout entry, the 4 B bucket of
// each real entry (filler's is never read), 4 B per tile, and the
// read-modify-write of each touched cell.
#include "codec.cuh"

__global__ void lh_multirow_ingest_kernel(int* __restrict__ acc,
                                          const int* __restrict__ rows,
                                          const int* __restrict__ bidx,
                                          const int* __restrict__ tile_block,
                                          long long n, int tile, int rows_tile,
                                          int num_metrics, int num_buckets) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long cell = -1;
  if (j < n) {
    const int r = rows[j];
    if (r >= 0 && r < rows_tile) {
      const long long row =
          static_cast<long long>(tile_block[j / tile]) * rows_tile + r;
      const int b = bidx[j];
      if (row >= 0 && row < num_metrics && b >= 0 && b < num_buckets) {
        cell = row * num_buckets + b;
      }
    }
  }
  // every lane of the warp reaches the match (blockDim is a multiple of 32)
  const unsigned peers = __match_any_sync(0xffffffffu, cell);
  if (cell < 0) return;
  if ((threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(acc + cell, __popc(peers));
  }
}

extern "C" int lh_multirow_ingest(void* acc, const void* rows, const void* bidx,
                                  const void* tile_block, long long n, int tile,
                                  int rows_tile, int num_metrics, int num_buckets,
                                  void* stream) {
  if (tile <= 0 || rows_tile <= 0 || n % tile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  lh_multirow_ingest_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(acc), static_cast<const int*>(rows),
      static_cast<const int*>(bidx), static_cast<const int*>(tile_block), n,
      tile, rows_tile, num_metrics, num_buckets);
  return static_cast<int>(cudaGetLastError());
}
