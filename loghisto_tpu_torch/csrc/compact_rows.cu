// K6: the lifecycle's row repack.
//
// Replaces loghisto_tpu/ops/lifecycle.py `_compact_kernel`
// (compact_rows_pallas, vmapped over each ring's slots):
//
//     out[s, i, :] = in[s, perm[i], :]   if 0 <= perm[i] < m_src
//                  = 0                   otherwise (-1 hole, DROP_ID, or
//                                         out of range)
//
// in and out are contiguous [slots, rows, width] arrays of 4-byte
// elements (int32 counts or float32 baselines: the copy moves bits), out
// holding n_out rows per slot.  An accumulator is one slot; a ring is
// [S, M_t, B]; a wsum bank is [K, M, 1].
//
// The TPU feeds perm through scalar prefetch into the BlockSpec's index
// map, so each grid step DMAs one survivor row into VMEM and writes it
// back.  Here the grid is (output row, slot): one launch covers a whole
// ring, and each block reads its own perm entry, then copies the 8193-wide
// row with coalesced 4-byte loads (B is odd, so rows are not 16-byte
// aligned).  An empty row is written as zeros without reading anything.
// The repack runs out of place (the wrapper swaps the output in): the
// survivor permutation is ascending (perm[new] = old >= new), but blocks
// run in no order, so an in-place copy could read a row another block
// has already overwritten.  Row offsets are 64-bit: 60 * 1024 * 8193
// passes 2^31.
//
// Bound on the card: bytes — every output row written once plus every
// live source row read once, over the HBM rate.
#include "codec.cuh"

__global__ void lh_compact_rows_kernel(unsigned* __restrict__ out,
                                       const unsigned* __restrict__ in,
                                       const int* __restrict__ perm,
                                       int n_out, int m_src, int width) {
  const int i = blockIdx.x;
  const long long s = blockIdx.y;
  const int p = perm[i];
  unsigned* dst = out + (s * n_out + i) * static_cast<long long>(width);
  if (p < 0 || p >= m_src) {
    for (int j = threadIdx.x; j < width; j += blockDim.x) dst[j] = 0u;
    return;
  }
  const unsigned* src = in + (s * m_src + p) * static_cast<long long>(width);
  for (int j = threadIdx.x; j < width; j += blockDim.x) dst[j] = __ldg(src + j);
}

// out [slots, n_out, width], in [slots, m_src, width], perm int32 [n_out]
// (device).
extern "C" int lh_compact_rows(void* out, const void* in, const void* perm,
                               int n_out, int m_src, int width, int slots,
                               void* stream) {
  if (n_out < 0 || m_src < 0 || width < 1 || slots < 0 || slots > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0 || slots == 0) return static_cast<int>(cudaGetLastError());
  const int threads = width >= 256 ? 256 : 32;
  const dim3 grid(static_cast<unsigned>(n_out), static_cast<unsigned>(slots));
  lh_compact_rows_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(out), static_cast<const unsigned*>(in),
      static_cast<const int*>(perm), n_out, m_src, width);
  return static_cast<int>(cudaGetLastError());
}
