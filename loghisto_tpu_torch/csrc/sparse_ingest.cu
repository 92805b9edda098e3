// K3: weighted scatter of packed (id, codec_bucket, count) triples into
// one or more accumulators in one launch.
//
// Replaces loghisto_tpu/ops/sparse_ingest.py `_pallas_kernel`
// (pallas_sparse_ingest): for every row of the int32 [n, 3] array and
// every target t with 0 <= id < M_t,
//
//     acc_t[id, clip(bucket, -bl, bl) + bl] += count
//
// each acc_t int32 [M_t, B] updated in place (up to 8 targets sharing B).
// Pad rows carry id -1 (or an id past every M_t) and drop.  The JAX
// package scatters one target per call; the fused commit and the
// retention push hand the same triples to the accumulator, every tier's
// open slot and the interval histogram, so here one launch reads each
// triple once and adds it to every target.  Integer adds commute, so the
// targets equal what one launch per target gives, bit for bit.
//
// The TPU kernel walks the cells serially and round-trips one bucket row
// per cell through VMEM by DMA, because a serial grid is how a TPU adds
// duplicate cells exactly.  Hopper adds them exactly with atomics.  The
// design:
//
//   * The triple loop of csrc/triple_scatter.cuh, shared with K4: a block
//     of 128 threads takes 512 consecutive triples, 4 a thread, strided
//     by 128 so that a warp's loads are coalesced; a thread issues its 12
//     loads, predicated on the end of the array, before any branch, then
//     its atomics; the grid is sized to the triples.  Measured against
//     16-byte loads of a thread's own 4 triples (3 int4; the atomics of a
//     warp then spread over 4x the cells) and against int4 loads
//     transposed through shared memory, this layout was the fastest
//     (PERF.md).
//   * The target pointers and row counts ride the launch arguments; the
//     kernel is compiled for each target count (1-8), so a one-target
//     launch carries no per-target loop.
//
// Bound on the card: 12 B per triple read once, plus the atomic
// read-modify-write of each touched cell of each target (8 B); equal
// cells (the fold's split counts) stay exact through the atomics.
#include "codec.cuh"
#include "triple_scatter.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 4;  // triples a thread
constexpr int kMaxTargets = 8;

struct LhTargets {
  int* acc[kMaxTargets];
  int rows[kMaxTargets];
};

// one triple into each of the NT targets
template <int NT>
__device__ __forceinline__ void lh_add(const LhTargets& t, int id, int bucket, int count,
                                       int nb, int bl) {
  if (count == 0 || id < 0) return;
  const long long off =
      static_cast<long long>(id) * nb + (bucket < -bl ? -bl : (bucket > bl ? bl : bucket)) + bl;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    if (id < t.rows[k]) atomicAdd(t.acc[k] + off, count);
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads)
lh_sparse_ingest_kernel(LhTargets t, const int* __restrict__ packed, long long n, int nb,
                        int bl) {
  lh_scatter_triples<kThreads, kPer>(packed, n, [&](int id, int bucket, int count) {
    lh_add<NT>(t, id, bucket, count, nb, bl);
  });
}

template <int NT>
cudaError_t lh_launch(const LhTargets& t, const int* packed, long long n, int nb, int bl,
                      cudaStream_t stream) {
  lh_sparse_ingest_kernel<NT>
      <<<lh_triple_blocks<kThreads, kPer>(n), kThreads, 0, stream>>>(t, packed, n, nb, bl);
  return cudaGetLastError();
}

}  // namespace

// accs: n_targets device pointers to int32 [rows[t], num_buckets]
// accumulators; packed: int32 [n, 3] (any 4-byte aligned view).
extern "C" int lh_sparse_ingest(void* const* accs, const int* rows, int n_targets,
                                const void* packed, long long n, int num_buckets,
                                int bucket_limit, void* stream) {
  if (num_buckets != 2 * bucket_limit + 1 || n_targets < 1 || n_targets > kMaxTargets ||
      n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  LhTargets t = {};
  for (int k = 0; k < n_targets; ++k) {
    t.acc[k] = static_cast<int*>(accs[k]);
    t.rows[k] = rows[k];
  }
  const int* p = static_cast<const int*>(packed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (n_targets) {
    case 1: err = lh_launch<1>(t, p, n, num_buckets, bucket_limit, st); break;
    case 2: err = lh_launch<2>(t, p, n, num_buckets, bucket_limit, st); break;
    case 3: err = lh_launch<3>(t, p, n, num_buckets, bucket_limit, st); break;
    case 4: err = lh_launch<4>(t, p, n, num_buckets, bucket_limit, st); break;
    case 5: err = lh_launch<5>(t, p, n, num_buckets, bucket_limit, st); break;
    case 6: err = lh_launch<6>(t, p, n, num_buckets, bucket_limit, st); break;
    case 7: err = lh_launch<7>(t, p, n, num_buckets, bucket_limit, st); break;
    case 8: err = lh_launch<8>(t, p, n, num_buckets, bucket_limit, st); break;
  }
  return static_cast<int>(err);
}
