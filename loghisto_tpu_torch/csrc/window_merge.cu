// K5: masked ring merge of the retention wheel.
//
// Replaces loghisto_tpu/ops/window.py `_merge_kernel` (window_merge_pallas):
//
//     out[m, b] = sum over listed slots s of ring[s, m, b]
//
// ring int32 [S, M, B] (contiguous), out int32 [M, B].  The sum is taken
// in uint32 and cast back, so it wraps in two's complement exactly as
// jnp.sum(..., dtype=int32) does (signed overflow is undefined in C++).
// An empty slot list writes zeros.
//
// The TPU grid sweeps every slot for every metric tile, reads each slot's
// block and uses the mask only to decide whether to add it, keeping the
// output block resident in VMEM.  Here the host hands the kernel the
// compact list of masked slot indices (by value, in the launch arguments:
// no copy and no synchronisation per call), so unmasked slots are never
// read.  Each thread owns output elements of the flat M*B range, loops
// over the listed slots with the sum in registers, and writes each output
// element once: k slot reads plus one write, the bandwidth floor.
//
// Bound on the card: bytes, (k + 1) * M * B * 4 over the HBM rate.  Loads
// are coalesced; 16-byte vector loads when M*B % 4 == 0 and both
// pointers are 16-byte aligned (every slot then starts aligned), a scalar
// path otherwise (B = 2*bucket_limit+1 is odd, so an odd M gives an odd
// M*B).  Slot offsets s*M*B pass 2^31 at the default tier-0 ring
// (60 x 1024 x 8193), so they are 64-bit.
#include "codec.cuh"

// The slot list travels in the kernel's arguments; 1000 slots keep them
// under the 4 KB launch-parameter limit.  The wrapper raises on a larger
// ring rather than truncate.
#define LH_MAX_WINDOW_SLOTS 1000

struct LhSlotList {
  int n;
  int slot[LH_MAX_WINDOW_SLOTS];
};

__global__ void lh_window_merge_vec4(int4* __restrict__ out,
                                     const int4* __restrict__ ring,
                                     long long nvec, LhSlotList list) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nvec; i += stride) {
    unsigned x = 0u, y = 0u, z = 0u, w = 0u;
#pragma unroll 4
    for (int j = 0; j < list.n; ++j) {
      const int4 v = __ldg(ring + static_cast<long long>(list.slot[j]) * nvec + i);
      x += static_cast<unsigned>(v.x);
      y += static_cast<unsigned>(v.y);
      z += static_cast<unsigned>(v.z);
      w += static_cast<unsigned>(v.w);
    }
    out[i] = make_int4(static_cast<int>(x), static_cast<int>(y),
                       static_cast<int>(z), static_cast<int>(w));
  }
}

__global__ void lh_window_merge_scalar(int* __restrict__ out,
                                       const int* __restrict__ ring,
                                       long long mb, LhSlotList list) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < mb; i += stride) {
    unsigned acc = 0u;
#pragma unroll 4
    for (int j = 0; j < list.n; ++j) {
      acc += static_cast<unsigned>(
          __ldg(ring + static_cast<long long>(list.slot[j]) * mb + i));
    }
    out[i] = static_cast<int>(acc);
  }
}

// slots: host array of n slot indices, each in [0, num_slots); mb = M * B.
extern "C" int lh_window_merge(void* out, const void* ring, const int* slots,
                               int n, int num_slots, long long mb,
                               void* stream) {
  if (n < 0 || n > LH_MAX_WINDOW_SLOTS || num_slots > LH_MAX_WINDOW_SLOTS || mb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  LhSlotList list;
  list.n = n;
  for (int j = 0; j < n; ++j) {
    if (slots[j] < 0 || slots[j] >= num_slots) return static_cast<int>(cudaErrorInvalidValue);
    list.slot[j] = slots[j];
  }
  if (mb == 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(ring) % 16 == 0);
  if (mb % 4 == 0 && aligned) {
    const long long nvec = mb / 4;
    lh_window_merge_vec4<<<lh_grid(nvec, threads, 16), threads, 0, s>>>(
        static_cast<int4*>(out), static_cast<const int4*>(ring), nvec, list);
  } else {
    lh_window_merge_scalar<<<lh_grid(mb, threads, 16), threads, 0, s>>>(
        static_cast<int*>(out), static_cast<const int*>(ring), mb, list);
  }
  return static_cast<int>(cudaGetLastError());
}
