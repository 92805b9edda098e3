// K5: masked ring merge of the retention wheel, every view of a tier in
// one pass.
//
// Replaces loghisto_tpu/ops/window.py `_merge_kernel` (window_merge_pallas),
// launched once per view there:
//
//     out[v, m, b] = sum over slots s with masks[v, s] of ring[s, m, b]
//
// ring int32 [S, M, B] (contiguous), out int32 [V, M, B].  The sum is taken
// in uint32 and cast back, so it wraps in two's complement exactly as
// jnp.sum(..., dtype=int32) does (signed overflow is undefined in C++).
//
// The plan.  The TPU grid sweeps every slot for every metric tile and uses
// the mask only to decide whether to add a block.  Here the host turns the
// V masks into runs: a run is a slot order in which each of its views is a
// prefix (the masks of one run are nested, as every trailing window of a
// tier is: they walk back from the same open slot).  The plan is one int32
// device buffer, uploaded by the wrapper without a synchronisation:
//
//     order[0 .. n_order)             slot indices, run after run
//     views[V][3] = (v, start, k)     out[v] = sum of order[start .. start+k)
//
// with the views sorted by (start, k) and each run as long as its largest
// view.  A run starts where one of its views starts; the walk resets its
// running sum there and writes out[v] when it has added k_v slots.  Nested
// masks give one run, so each listed slot is read once for all the views:
// (distinct slots + V) * M * B * 4 bytes, the bound on the card.  Masks that
// are not nested give one run per chain of nested views (a slot in two
// chains is read twice), still in one launch.  Nothing in the launch
// arguments grows with S or V: any ring size and any number of views.
//
// The stream.  Each block owns 32 KB chunks of the flat M*B range (chunk c,
// c + gridDim.x, ...), one resident grid of two 256-thread blocks per SM.
// Thread 0 feeds the chunk of each listed slot into a 3-stage shared-memory
// ring (96 KB) with 1-D bulk copies (cp.async.bulk, the TMA's linear form)
// that complete on an mbarrier per stage; the threads wait on the stage,
// add 8 int4 each into registers, and the stage is refilled 3 steps ahead,
// across chunk boundaries, so the copy engine never drains.  No thread
// spends registers on loads, and large copies keep many bytes in flight
// for few requests and few block barriers per byte.
//
// Bulk copies need 16-byte aligned, 16-byte multiple transfers: when
// M*B % 4 != 0 (B = 2*bucket_limit+1 is odd, so an odd M gives an odd M*B)
// or a pointer is not 16-byte aligned, a scalar grid-stride path walks the
// same plan with one element per thread.  Slot and view offsets s*M*B pass
// 2^31 at the default tier-0 ring (60 x 1024 x 8193), so they are 64-bit.
#include "bulk_copy.cuh"
#include "codec.cuh"

namespace {

// the bulk path's shape: 256 threads, 8 int4 each per step (32 KB
// chunks), 3 stages (96 KB of dynamic shared memory, 2 blocks per SM)
constexpr int kThreads = 256;
constexpr int kVec = 8;
constexpr int kStages = 3;

// The plan walk shared by both paths: before position p of the slot order,
// reset the running sum where a run starts and emit every view that ends
// there.  The next view's start and end are kept in registers, so a step
// that neither starts a run nor ends a view reads nothing.
struct LhViewWalk {
  const int* views;  // [V][3] = (v, start, k), sorted by (start, k)
  int n_views;
  int e, start, end, run;

  __device__ __forceinline__ LhViewWalk(const int* v, int n) : views(v), n_views(n), e(-1), run(-1) {
    next();
  }
  __device__ __forceinline__ void next() {
    ++e;
    start = e < n_views ? __ldg(views + 3 * e + 1) : -1;
    end = e < n_views ? start + __ldg(views + 3 * e + 2) : -1;
  }
  template <class Reset, class Emit>
  __device__ __forceinline__ void at(int p, Reset reset, Emit emit) {
    if (start == p && run != p) {
      reset();
      run = p;
    }
    while (end == p) {
      emit(__ldg(views + 3 * e));
      next();
      if (start == p && run != p) {
        reset();
        run = p;
      }
    }
  }
};

template <int T, int U, int S>
__global__ void __launch_bounds__(T)
lh_window_merge_bulk(int* __restrict__ out, const int* __restrict__ ring,
                     const int* __restrict__ plan, int n_order, int n_views,
                     long long mb, long long n_chunks) {
  constexpr int kChunk = 4 * T * U;  // ints per chunk
  extern __shared__ __align__(128) unsigned char lh_smem_raw[];
  uint4* stage = reinterpret_cast<uint4*>(lh_smem_raw);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(lh_smem_raw + S * kChunk * 4);
  const int* order = plan;
  const int tid = threadIdx.x;
  const long long first = blockIdx.x;
  const long long my_chunks = (n_chunks - first + gridDim.x - 1) / gridDim.x;
  const long long total = my_chunks * n_order;  // bulk copies this block takes

  if (tid == 0) {
    for (int s = 0; s < S; ++s) lh_mbar_init(&full[s], 1);
    lh_mbar_init_fence();
  }
  __syncthreads();

  // copy q of this block: slot order[q % n_order] of its chunk q / n_order
  auto request = [&](long long q) {
    const long long base = (first + (q / n_order) * gridDim.x) * kChunk;
    const long long len = min(static_cast<long long>(kChunk), mb - base);
    const int slot = __ldg(order + q % n_order);
    lh_bulk_load(stage + (q % S) * (kChunk / 4), ring + static_cast<long long>(slot) * mb + base,
                 static_cast<unsigned>(len * 4), &full[q % S]);
  };
  if (tid == 0) {
    for (long long q = 0; q < total && q < S; ++q) request(q);
  }

  long long q = 0;
  for (long long i = 0; i < my_chunks; ++i) {
    const long long base = (first + i * gridDim.x) * kChunk;
    const long long len = min(static_cast<long long>(kChunk), mb - base);
    uint4 acc[U];
    LhViewWalk walk(plan + n_order, n_views);
    auto reset = [&] {
#pragma unroll
      for (int u = 0; u < U; ++u) acc[u] = make_uint4(0u, 0u, 0u, 0u);
    };
    auto emit = [&](int v) {
      uint4* dst = reinterpret_cast<uint4*>(out + static_cast<long long>(v) * mb + base);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = tid + u * T;
        if (4LL * j < len) dst[j] = acc[u];
      }
    };
    reset();
    for (int p = 0;; ++p) {
      walk.at(p, reset, emit);
      if (p == n_order) break;
      const int s = static_cast<int>(q % S);
      lh_mbar_wait(&full[s], static_cast<unsigned>((q / S) & 1));
      const uint4* src = stage + s * (kChunk / 4);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = tid + u * T;
        if (4LL * j < len) {
          const uint4 v = src[j];
          acc[u].x += v.x;
          acc[u].y += v.y;
          acc[u].z += v.z;
          acc[u].w += v.w;
        }
      }
      __syncthreads();  // every thread has read stage s: refill it
      if (tid == 0 && q + S < total) request(q + S);
      ++q;
    }
  }
}

__global__ void lh_window_merge_scalar(int* __restrict__ out, const int* __restrict__ ring,
                                       const int* __restrict__ plan, int n_order,
                                       int n_views, long long mb) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < mb;
       i += stride) {
    unsigned acc = 0u;
    LhViewWalk walk(plan + n_order, n_views);
    auto reset = [&] { acc = 0u; };
    auto emit = [&](int v) { out[static_cast<long long>(v) * mb + i] = static_cast<int>(acc); };
    for (int p = 0;; ++p) {
      walk.at(p, reset, emit);
      if (p == n_order) break;
      acc += static_cast<unsigned>(
          __ldg(ring + static_cast<long long>(__ldg(plan + p)) * mb + i));
    }
  }
}

template <int T, int U, int S>
int lh_launch_bulk(int* out, const int* ring, const int* plan, int n_order, int n_views,
                   long long mb, cudaStream_t stream) {
  constexpr int kChunk = 4 * T * U;
  const int smem = S * kChunk * 4 + S * 8;
  auto kernel = lh_window_merge_bulk<T, U, S>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 132, per_sm = 1;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T, smem);
  const long long n_chunks = (mb + kChunk - 1) / kChunk;
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > n_chunks) blocks = n_chunks;
  kernel<<<static_cast<unsigned>(blocks), T, smem, stream>>>(out, ring, plan, n_order, n_views,
                                                             mb, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// plan: device int32 [n_order + 3 * n_views] as above, every slot index in
// [0, S) and every view in [0, n_views) (the wrapper builds and checks it);
// out int32 [n_views, M, B]; mb = M * B.
extern "C" int lh_window_merge(void* out, const void* ring, const void* plan, int n_order,
                               int n_views, long long mb, void* stream) {
  if (n_order < 0 || n_views < 0 || mb < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (mb == 0 || n_views == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(ring) % 16 == 0);
  if (mb % 4 == 0 && aligned) {
    return lh_launch_bulk<kThreads, kVec, kStages>(
        static_cast<int*>(out), static_cast<const int*>(ring), static_cast<const int*>(plan),
        n_order, n_views, mb, s);
  }
  lh_window_merge_scalar<<<lh_grid(mb, 256, 16), 256, 0, s>>>(
      static_cast<int*>(out), static_cast<const int*>(ring), static_cast<const int*>(plan),
      n_order, n_views, mb);
  return static_cast<int>(cudaGetLastError());
}
