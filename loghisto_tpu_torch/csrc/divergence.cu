// K7: per-row drift scores of the distribution drift engine.
//
// Replaces loghisto_tpu/ops/anomaly.py `_div_kernel` (divergence_pallas,
// with divergence_scores' bank pad and floor mask around it).  For each
// metric row r < M, with total = max(counts[r], 1), the bank's rows
// prof [Mb, B] / w [Mb] (rows r >= Mb have no baseline):
//
//     base_pmf[b] = prof[r, b] / max(w[r], 1e-30)
//     base_cdf    = prefix sum of base_pmf
//     live_cdf[b] = cdf[r, b] / total
//     live_pmf[b] = (cdf[r, b] - cdf[r, b - 1]) / total   (exact int bins)
//     ks  = max_b |live_cdf - base_cdf|
//     emd = sum_b |live_cdf - base_cdf|
//     jsd = (KL(live || mid) + KL(base || mid)) / 2, mid = (live + base) / 2,
//           log2, terms with p = 0 (or with mid = 0: a subnormal p) skipped
//
// and exactly 0 for rows with counts < min_samples or w <= 0 (the floor
// mask), which read nothing.
//
// The TPU kernel keeps an 8-row tile of both operands in VMEM while the
// three reductions run.  Here one block of 256 threads walks one row in
// one pass, in tiles of 768 columns (3 contiguous columns a thread), and
// never holds the whole row:
//
//   * Thread 0 streams the tiles into a 3-stage shared-memory ring with
//     1-D bulk copies (cp.async.bulk) that complete on an mbarrier per
//     stage.  Rows are B * 4 bytes with B odd, so they are not 16-byte
//     aligned: each tile's copy starts at the 16-byte aligned address at
//     or below the tile's first column and ends at the one at or above
//     its end, and the tile is read at an offset of 0-3 elements (the
//     cdf and prof rows each have their own).  A 16-byte aligned chunk
//     that holds a byte of the row lies in the row's page, so the few
//     bytes read past either end never fault; they are never used.
//   * A stage is refilled as soon as every thread is past it, so two
//     tiles are in flight while the block works on the third.  The ring
//     is 18.8 KB and a thread keeps to 32 registers (launch bounds), so
//     8 blocks (2048 threads, the SM's limit) fit on an SM, and the 1024
//     rows of the retention system run in one wave.
//   * Per tile: each thread divides its 3 prof values by max(w, 1e-30)
//     (one division a bucket) and sums them, a warp-shuffle scan and one
//     shared-memory exchange of the 8 warp totals give each thread its
//     prefix, and the base CDF prefix is carried from tile to tile in a
//     register.  The thread then forms base_cdf, the live CDF and pmf
//     (the exact int32 bins times 1 / total, within an ulp of the
//     quotient), and the ks / emd / JSD terms of its columns.  The column
//     before a thread's first comes from the staged tile, or from the
//     previous tile's last column, carried in a register.  3 is odd, so
//     the strided shared-memory reads are free of bank conflicts.  One
//     block reduction ends the row.
//
// log2f is the accurate libdevice function, not the fast-math __log2f,
// and the scan adds in another order than the plain cumsum: the scores
// equal the plain version within a float32 tolerance, not bit for bit.
//
// Bound on the card: bytes, the cdf and prof rows read once (8 B per
// bucket of an unmasked row) plus 12 B written per row.  What holds the
// kernel above it (PERF.md): the tile stream alone reaches ~2.4 TB/s,
// and the JSD terms (two divisions and two log2f where a pmf is nonzero)
// overlap the loads only in part.
#include "bulk_copy.cuh"
#include "codec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 3;                   // contiguous columns a thread, odd
constexpr int kTile = kThreads * kCols;    // 768 columns, a multiple of 4
constexpr int kStages = 3;
constexpr int kSpan = kTile + 8;           // offset (<= 3) + tile + round-up (<= 3)

__device__ __forceinline__ float lh_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float lh_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ uintptr_t lh_align_down16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) & ~static_cast<uintptr_t>(15);
}

__device__ __forceinline__ uintptr_t lh_align_up16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) + 15) & ~static_cast<uintptr_t>(15);
}

__global__ void __launch_bounds__(kThreads, 8)
lh_divergence_kernel(const int* __restrict__ cdf, const int* __restrict__ counts,
                     const float* __restrict__ prof, const float* __restrict__ w,
                     float* __restrict__ out, int m, int mb, int b, int min_samples) {
  __shared__ __align__(16) int s_cdf[kStages][kSpan];
  __shared__ __align__(16) float s_prof[kStages][kSpan];
  __shared__ __align__(8) unsigned long long s_full[kStages];
  __shared__ float s_tot[2][kWarps];
  __shared__ float s_red[4][kWarps];

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int cnt = counts[r];
  const float wr = r < mb ? w[r] : 0.0f;
  if (!(cnt >= min_samples && wr > 0.0f)) {
    if (tid == 0) {
      out[r] = 0.0f;
      out[m + r] = 0.0f;
      out[2LL * m + r] = 0.0f;
    }
    return;
  }
  const int* crow = cdf + static_cast<long long>(r) * b;
  const float* prow = prof + static_cast<long long>(r) * b;
  const int ntiles = (b + kTile - 1) / kTile;
  // kTile is a multiple of 4, so every tile of a row sits at the same
  // offset from its aligned copy
  const int lead_c = static_cast<int>((reinterpret_cast<uintptr_t>(crow) & 15) >> 2);
  const int lead_p = static_cast<int>((reinterpret_cast<uintptr_t>(prow) & 15) >> 2);

  // thread 0: stream tile k (columns [k * kTile, min((k + 1) * kTile, b)))
  // of both rows into stage k % kStages
  auto request = [&](int k) {
    const int s = k % kStages;
    const int c0 = k * kTile;
    const int c1 = min(c0 + kTile, b);
    const uintptr_t ca = lh_align_down16(crow + c0), ce = lh_align_up16(crow + c1);
    const uintptr_t pa = lh_align_down16(prow + c0), pe = lh_align_up16(prow + c1);
    lh_mbar_expect(&s_full[s], static_cast<unsigned>((ce - ca) + (pe - pa)));
    lh_bulk_copy(s_cdf[s], reinterpret_cast<const void*>(ca), static_cast<unsigned>(ce - ca),
                 &s_full[s]);
    lh_bulk_copy(s_prof[s], reinterpret_cast<const void*>(pa), static_cast<unsigned>(pe - pa),
                 &s_full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) lh_mbar_init(&s_full[s], 1);
    lh_mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 0; k < kStages && k < ntiles; ++k) request(k);
  }

  const float inv_total = 1.0f / static_cast<float>(cnt > 1 ? cnt : 1);
  const float wden = fmaxf(wr, 1e-30f);
  const int j0 = tid * kCols;  // this thread's first column within a tile
  float carry = 0.0f;          // base_cdf before the tile
  unsigned prev_last = 0u;     // cdf of the column before the tile
  float ks = 0.0f, emd = 0.0f, kl_live = 0.0f, kl_base = 0.0f;

  for (int k = 0; k < ntiles; ++k) {
    const int s = k % kStages;
    const int ncols = min(kTile, b - k * kTile);
    lh_mbar_wait(&s_full[s], static_cast<unsigned>((k / kStages) & 1));
    const int* tc = s_cdf[s] + lead_c;
    const float* tp = s_prof[s] + lead_p;

    // this thread's base_pmf (one division a bucket) and its sum
    float bp[kCols];
    float part = 0.0f;
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      bp[u] = j0 + u < ncols ? tp[j0 + u] / wden : 0.0f;
      part += bp[u];
    }
    float incl = part;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0f;
    if (lane == 31) s_tot[k & 1][warp] = incl;
    __syncthreads();
    // every thread is past tile k - 1: refill its stage
    if (tid == 0 && k >= 1 && k - 1 + kStages < ntiles) request(k - 1 + kStages);
    float warp_prefix = 0.0f, tile_total = 0.0f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      const float t = s_tot[k & 1][q];
      if (q < warp) warp_prefix += t;
      tile_total += t;
    }

    // base_cdf, the live CDF and pmf, the three scores' terms
    if (j0 < ncols) {
      float run = carry + (warp_prefix + excl);
      unsigned prev = j0 == 0 ? prev_last : static_cast<unsigned>(tc[j0 - 1]);
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        if (j0 + u < ncols) {
          const unsigned c = static_cast<unsigned>(tc[j0 + u]);
          const float bpu = bp[u];
          run += bpu;
          const float lc = static_cast<float>(static_cast<int>(c)) * inv_total;
          const float lp = static_cast<float>(static_cast<int>(c - prev)) * inv_total;
          prev = c;
          const float d = fabsf(lc - run);
          ks = fmaxf(ks, d);
          emd += d;
          const float mid = 0.5f * (lp + bpu);
          // a subnormal p whose half rounds to 0 leaves mid = 0: skipped,
          // as the plain version skips it
          if (lp > 0.0f && mid > 0.0f) kl_live += lp * log2f(lp / mid);
          if (bpu > 0.0f && mid > 0.0f) kl_base += bpu * log2f(bpu / mid);
        }
      }
    }
    carry += tile_total;
    prev_last = static_cast<unsigned>(tc[ncols - 1]);
  }

  ks = lh_warp_max(ks);
  emd = lh_warp_sum(emd);
  kl_live = lh_warp_sum(kl_live);
  kl_base = lh_warp_sum(kl_base);
  if (lane == 0) {
    s_red[0][warp] = ks;
    s_red[1][warp] = emd;
    s_red[2][warp] = kl_live;
    s_red[3][warp] = kl_base;
  }
  __syncthreads();
  if (tid == 0) {
    float k_max = 0.0f, e = 0.0f, kl = 0.0f, kb = 0.0f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      k_max = fmaxf(k_max, s_red[0][q]);
      e += s_red[1][q];
      kl += s_red[2][q];
      kb += s_red[3][q];
    }
    out[r] = k_max;
    out[m + r] = 0.5f * (kl + kb);
    out[2LL * m + r] = e;
  }
}

}  // namespace

// cdf int32 [M, B], counts int32 [M], prof f32 [Mb, B] and w f32 [Mb]
// (one bank's rows), out f32 [3, M] (ks, jsd, emd).
extern "C" int lh_divergence(const void* cdf, const void* counts,
                             const void* prof, const void* w, void* out,
                             int m, int mb, int b, int min_samples,
                             void* stream) {
  if (m < 0 || mb < 0 || b < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  // 8 blocks of 21.7 KB need the largest shared-memory carve-out
  const cudaError_t carve = cudaFuncSetAttribute(
      lh_divergence_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carve != cudaSuccess) return static_cast<int>(carve);
  lh_divergence_kernel<<<m, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cdf), static_cast<const int*>(counts),
      static_cast<const float*>(prof), static_cast<const float*>(w),
      static_cast<float*>(out), m, mb, b, min_samples);
  return static_cast<int>(cudaGetLastError());
}
