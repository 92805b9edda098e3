// The triple loop shared by K3 (sparse_ingest.cu) and K4 (paged_store.cu):
// a weighted scatter of an int32 [n, 3] array of (row, column, count)
// triples, one atomicAdd per kept triple.  The two kernels differ only in
// how a triple becomes a cell (the `add` functor): K3 keeps 0 <= id < M_t
// and clips the codec bucket to +/-bl, K4 keeps 0 < slot < P and clips
// the page offset to [0, page_size - 1].
//
// Layout: a block of THREADS threads takes THREADS * PER consecutive
// triples, PER a thread: thread t takes triples t, t + THREADS, ... of the
// block, so each of a warp's loads reads 32 neighbouring triples (384
// contiguous bytes) and each of its atomics lands on the neighbouring
// cells that a host fold sorts next to each other.  A thread issues its
// 3 * PER loads, predicated on the end of the array, before any branch,
// then its atomics, so the loads of its PER triples are in flight
// together.  The grid is sized to the triples: no grid-stride pass and
// no ragged second loop.  The loads are 4-byte, so any view (packed[1:]
// starts 12 bytes in) takes the same path.  A triple past the end reads
// as (0, 0, 0): count 0, dropped by every `add`.  K3 takes 128 x 4 (the
// fastest of the layouts measured on the card, PERF.md); K4 takes 512 x 1
// (paged_store.cu: its time is its DRAM sectors', in any layout).
#pragma once

#include <cuda_runtime.h>

template <int THREADS, int PER, class Add>
__device__ __forceinline__ void lh_scatter_triples(const int* __restrict__ packed,
                                                   long long n, const Add& add) {
  const long long first = static_cast<long long>(blockIdx.x) * (THREADS * PER) + threadIdx.x;
  int f[PER][3];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const long long i = first + u * THREADS;
    const bool in = i < n;
#pragma unroll
    for (int c = 0; c < 3; ++c) f[u][c] = in ? __ldg(packed + 3 * i + c) : 0;
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) add(f[u][0], f[u][1], f[u][2]);
}

// blocks of a launch over n > 0 triples
template <int THREADS, int PER>
static inline unsigned lh_triple_blocks(long long n) {
  return static_cast<unsigned>((n + THREADS * PER - 1) / (THREADS * PER));
}
