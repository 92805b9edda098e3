"""Histogram statistics: percentiles, sum/count/avg (counterpart of
``loghisto_tpu/ops/stats.py``).

The host tier (``percentiles_sparse``, ``summarize_sparse``,
``dense_stats_np``) is copied: NumPy, int64-exact, the reference's
float64 selection rule "first bucket where float(cum)/float(total) >= p"
(metrics.go:411-414).

The torch tier ``dense_stats`` keeps the JAX device rule bit for bit:
the cumsum stays exact in int32 and the division is float32, through
the integer rank threshold k* (``k0 = ceil(p*total)``, the +/-1
candidate window, the clamp before the int cast).  Selection is
identical to the reference for per-metric counts up to 2^24 and within
one bucket beyond; p = 0 and p = 1 take the exact first/last populated
bucket at any count.

JAX finds the k*-th bucket by a two-level block search, a TPU layout
device that avoids a full-width cumsum.  Here one int32 ``cumsum`` and
``searchsorted`` select the same buckets: both count the buckets whose
cumulative count is below k*.  Sums are an float32 ``acc.float() @ reps``
as in JAX; TF32 is switched off for it.  ``dense_cdf`` and the snapshot
and group queries wait for the retention slice.
"""

from __future__ import annotations

import numpy as np
import torch

from loghisto_tpu_torch.config import PRECISION
from loghisto_tpu_torch.ops.codec import decompress_np


def percentiles_sparse(
    buckets: np.ndarray, counts: np.ndarray, ps: np.ndarray,
    precision: int = PRECISION,
) -> np.ndarray:
    """Percentiles from a sparse (bucket, count) histogram (host tier).
    Returns bucket representative values, one per p; an empty histogram
    returns zeros."""
    if len(np.asarray(buckets)) == 0:
        return np.zeros(len(np.asarray(ps)))
    order = np.argsort(buckets, kind="stable")
    values = decompress_np(np.asarray(buckets)[order], precision)
    cdf = np.cumsum(np.asarray(counts, dtype=np.uint64)[order])
    total = float(cdf[-1])
    # Same operation order as the reference: float(cum)/float(total) >= p.
    cdfn = cdf.astype(np.float64) / total
    idx = np.searchsorted(cdfn, np.asarray(ps, dtype=np.float64), side="left")
    idx = np.minimum(idx, len(values) - 1)
    return values[idx]


def summarize_sparse(
    buckets: np.ndarray, counts: np.ndarray, precision: int = PRECISION,
) -> tuple[float, int]:
    """(sum of representatives * counts, total count) — metrics.go:342-347."""
    values = decompress_np(np.asarray(buckets), precision)
    counts = np.asarray(counts, dtype=np.float64)
    return float(np.dot(values, counts)), int(counts.sum())


def dense_stats_np(
    acc: np.ndarray,
    ps: np.ndarray,
    bucket_limit: int,
    precision: int = PRECISION,
) -> dict[str, np.ndarray]:
    """Host (NumPy, int64) mirror of dense_stats for intervals whose
    counts exceed what the int32 device accumulator holds — the spill
    path.  Exact at any count < 2^53."""
    acc = np.asarray(acc, dtype=np.int64)
    ps = np.asarray(ps, dtype=np.float64)
    reps = decompress_np(
        np.arange(-bucket_limit, bucket_limit + 1, dtype=np.int64), precision
    )
    cdf = np.cumsum(acc, axis=1)
    counts = cdf[:, -1]
    sums = acc.astype(np.float64) @ reps
    m, b = acc.shape
    idx = np.zeros((m, len(ps)), dtype=np.int64)
    for row in range(m):
        total = counts[row]
        if total == 0:
            continue
        cdfn = cdf[row].astype(np.float64) / float(total)
        pos = np.minimum(np.searchsorted(cdfn, ps, side="left"), b - 1)
        populated = np.nonzero(acc[row])[0]
        lo, hi = populated[0], populated[-1]
        idx[row] = np.where(ps <= 0, lo, np.where(ps >= 1, hi, pos))
    pct = reps[idx]
    pct[counts == 0] = 0.0
    return {"counts": counts, "sums": sums, "percentiles": pct}


def bucket_representatives(
    bucket_limit: int, precision: int = PRECISION, device=None,
    dtype=torch.float32,
) -> torch.Tensor:
    """Representative value of every dense-axis bucket (index b maps to
    codec bucket b - bucket_limit), rounded once from the float64 host
    codec so every device holds the same table."""
    idx = np.arange(-bucket_limit, bucket_limit + 1, dtype=np.int64)
    reps = torch.from_numpy(decompress_np(idx, precision))
    return reps.to(device=device, dtype=dtype)


def dense_stats(
    acc: torch.Tensor,
    ps,
    bucket_limit: int,
    precision: int = PRECISION,
) -> dict[str, torch.Tensor]:
    """Per-metric statistics from a dense int32 [M, B] count tensor, on
    its device.

    Returns counts [M] int32, sums [M] float32, percentiles [M, P]
    float32 and buckets [M, P] int64 (the selected dense-axis index of
    each percentile).  Empty metrics return 0 for every statistic.
    """
    num_buckets = acc.shape[1]
    device = acc.device
    # state the matvec's precision: full float32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    reps = bucket_representatives(bucket_limit, precision, device)
    sums = acc.to(torch.float32) @ reps
    cdf = torch.cumsum(acc, dim=1, dtype=torch.int32)
    counts = cdf[:, -1].contiguous()

    ps = torch.as_tensor(ps, dtype=torch.float32, device=device)
    total_i = torch.clamp(counts, min=1)[:, None]  # [M, 1]
    total_f = total_i.to(torch.float32)
    k0 = torch.ceil(ps[None, :] * total_f)  # [M, P] first candidate
    window = torch.tensor([-1.0, 0.0, 1.0], device=device)
    cands = k0[:, :, None] + window  # [M, P, 3]
    ok = (cands / total_f[:, :, None] >= ps[None, :, None]) & (cands >= 1.0)
    inf = torch.tensor(float("inf"), device=device)
    best = torch.where(ok, cands, inf).amin(dim=2)
    k_star_f = torch.where(torch.isfinite(best), best, k0)
    # int32-representable float clamp BEFORE the cast, then the exact
    # integer clamp (same order as the reference)
    k_star_f = torch.clamp(k_star_f, 1.0, float(np.float32(2**31 - 256)))
    k_star = torch.minimum(k_star_f.to(torch.int32), total_i)
    # endpoints: rank 1 is the first populated bucket, rank == total the
    # last populated bucket — exact at any count
    k = torch.where(
        ps[None, :] <= 0, torch.ones_like(k_star),
        torch.where(ps[None, :] >= 1, total_i.expand_as(k_star), k_star),
    )
    idx = torch.searchsorted(cdf, k.contiguous(), side="left")
    idx = torch.clamp(idx, max=num_buckets - 1)
    pct = reps[idx]
    nonempty = (counts > 0)[:, None]
    return {
        "counts": counts,
        "sums": sums,
        "percentiles": torch.where(nonempty, pct, torch.zeros_like(pct)),
        "buckets": idx,
    }
