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
// three reductions run.  Here one block of 256 threads takes one row:
// it stages the row's cdf (int32) and prof (f32) in dynamic shared memory
// with coalesced 4-byte loads (2 x 8193 x 4 B = 64 KB, above the default
// 48 KB, so the attribute is set; B is odd, so rows are not 16-byte
// aligned).  Each thread then owns a contiguous chunk of ceil(B / 256) =
// 33 columns (an odd stride: no bank conflicts): it sums its chunk of
// base_pmf, a block scan (warp shuffles) turns the chunk totals into each
// chunk's prefix, and a second pass forms base_cdf, the live CDF and pmf,
// and the ks/emd/JSD terms, reduced across the block.  log2f is the
// accurate libdevice function, not the fast-math __log2f, and the scan
// runs in another order than XLA's cumsum: the scores equal the plain
// version within a float32 tolerance, not bit for bit.
//
// Bound on the card: bytes, the cdf and prof rows read once (8 B per
// bucket of an unmasked row) plus 12 B written per row; the 2 log2f per
// bucket are far below the SFU rate.
#include "codec.cuh"

#define LH_DIV_THREADS 256
#define LH_DIV_WARPS (LH_DIV_THREADS / 32)

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

__global__ void lh_divergence_kernel(const int* __restrict__ cdf,
                                     const int* __restrict__ counts,
                                     const float* __restrict__ prof,
                                     const float* __restrict__ w,
                                     float* __restrict__ out, int m, int mb,
                                     int b, int min_samples) {
  extern __shared__ unsigned char lh_smem[];
  int* s_cdf = reinterpret_cast<int*>(lh_smem);
  float* s_prof = reinterpret_cast<float*>(s_cdf + b);
  __shared__ float s_warp[4][LH_DIV_WARPS];

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
  for (int j = tid; j < b; j += LH_DIV_THREADS) {
    s_cdf[j] = crow[j];
    s_prof[j] = prow[j];
  }
  __syncthreads();

  const float total = static_cast<float>(cnt > 1 ? cnt : 1);
  const float wden = fmaxf(wr, 1e-30f);
  const int chunk = (b + LH_DIV_THREADS - 1) / LH_DIV_THREADS;
  const int lo = min(tid * chunk, b);
  const int hi = min(lo + chunk, b);

  // pass 1: this chunk's base_pmf total, then an exclusive block scan
  float part = 0.0f;
  for (int j = lo; j < hi; ++j) part += s_prof[j] / wden;
  float incl = part;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  if (lane == 31) s_warp[0][warp] = incl;
  __syncthreads();
  float warp_prefix = 0.0f;
  for (int k = 0; k < warp; ++k) warp_prefix += s_warp[0][k];
  float run = warp_prefix + excl;

  // pass 2: base_cdf, the live CDF and pmf, the three scores' terms
  float ks = 0.0f, emd = 0.0f, kl_live = 0.0f, kl_base = 0.0f;
  for (int j = lo; j < hi; ++j) {
    const float bp = s_prof[j] / wden;
    run += bp;
    const float lc = static_cast<float>(s_cdf[j]) / total;
    const unsigned prev = j > 0 ? static_cast<unsigned>(s_cdf[j - 1]) : 0u;
    const int bin = static_cast<int>(static_cast<unsigned>(s_cdf[j]) - prev);
    const float lp = static_cast<float>(bin) / total;
    const float d = fabsf(lc - run);
    ks = fmaxf(ks, d);
    emd += d;
    const float mid = 0.5f * (lp + bp);
    // a subnormal p whose half rounds to 0 leaves mid = 0: skipped, as
    // the plain version skips it
    if (lp > 0.0f && mid > 0.0f) kl_live += lp * log2f(lp / mid);
    if (bp > 0.0f && mid > 0.0f) kl_base += bp * log2f(bp / mid);
  }
  ks = lh_warp_max(ks);
  emd = lh_warp_sum(emd);
  kl_live = lh_warp_sum(kl_live);
  kl_base = lh_warp_sum(kl_base);
  __syncthreads();  // s_warp[0] is read above; reuse it below
  if (lane == 0) {
    s_warp[0][warp] = ks;
    s_warp[1][warp] = emd;
    s_warp[2][warp] = kl_live;
    s_warp[3][warp] = kl_base;
  }
  __syncthreads();
  if (tid == 0) {
    float k_max = 0.0f, e = 0.0f, kl = 0.0f, kb = 0.0f;
    for (int k = 0; k < LH_DIV_WARPS; ++k) {
      k_max = fmaxf(k_max, s_warp[0][k]);
      e += s_warp[1][k];
      kl += s_warp[2][k];
      kb += s_warp[3][k];
    }
    out[r] = k_max;
    out[m + r] = 0.5f * (kl + kb);
    out[2LL * m + r] = e;
  }
}

// cdf int32 [M, B], counts int32 [M], prof f32 [Mb, B] and w f32 [Mb]
// (one bank's rows), out f32 [3, M] (ks, jsd, emd).
extern "C" int lh_divergence(const void* cdf, const void* counts,
                             const void* prof, const void* w, void* out,
                             int m, int mb, int b, int min_samples,
                             void* stream) {
  if (m < 0 || mb < 0 || b < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(b) * 8;
  cudaError_t e = cudaFuncSetAttribute(
      lh_divergence_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  lh_divergence_kernel<<<m, LH_DIV_THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cdf), static_cast<const int*>(counts),
      static_cast<const float*>(prof), static_cast<const float*>(w),
      static_cast<float*>(out), m, mb, b, min_samples);
  return static_cast<int>(cudaGetLastError());
}
