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
as in JAX; TF32 is switched off for it.  ``snapshot_row_stats`` is that
selection over given CDF rows (the paged query's tail);
``sparse_cells_stats`` is the host tier of paged storage's collect().

The snapshot query engine of the retention wheel: ``dense_cdf`` is the
commit-time payload (exact int32 CDF, counts, float32 sums) and
``make_snapshot_query_fn`` the query (a row gather, then
``snapshot_row_stats``).  ``dense_stats`` and ``dense_cdf`` take their
sums from one helper (``row_sums``), so a snapshot serve and a
recompute over the same window give the same bits.
``make_group_query_fn`` is the group_by rollup over the same payload:
the matched CDF rows summed per group (``index_select``, then int32
``index_add_``), then ``snapshot_row_stats``.  On a ("stream",
"metric") mesh (ROADMAP D9) both take ``mesh=`` and serve a rank's row
block of the payload: collective calls of the rank's metric line.

The torch tier imports torch when called, so the host tier loads
without it (the torch-free emitter tier reads ``percentiles_sparse``
and ``summarize_sparse``).
"""

from __future__ import annotations

import functools

import numpy as np

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


def sparse_cells_stats(
    rows: np.ndarray,
    dense_idx: np.ndarray,
    counts: np.ndarray,
    num_metrics: int,
    ps: np.ndarray,
    bucket_limit: int,
    precision: int = PRECISION,
) -> dict[str, np.ndarray]:
    """``dense_stats_np`` over a sparse cell list (rows, dense-axis
    bucket indices, int64 counts; duplicate cells fold): the collect()
    tier of paged storage.  O(cells) host work, no [M, B] array.

    The JAX function loops over every row in Python; this one is
    vectorized: sort by (row, bucket), fold duplicates, one cumsum with
    each row's exclusive prefix subtracted, then the float64 rule
    ``float(cum)/float(total) >= p`` per cell.  Within a row the ratio
    is nondecreasing, so the selected cell is the row's first cell plus
    the number of its cells below p — what the JAX function's
    ``searchsorted`` returns.  Counts and percentiles equal it bit for
    bit; sums reduce each row in bucket order like its ``np.dot``, up
    to the summation order (rtol 1e-12)."""
    rows = np.asarray(rows, dtype=np.int64)
    dense_idx = np.asarray(dense_idx, dtype=np.int64)
    cell_counts = np.asarray(counts, dtype=np.int64)
    ps = np.asarray(ps, dtype=np.float64)
    m, p_n = int(num_metrics), len(ps)
    out_counts = np.zeros(m, dtype=np.int64)
    out_sums = np.zeros(m, dtype=np.float64)
    out_pct = np.zeros((m, p_n), dtype=np.float64)
    if not len(rows):
        return {"counts": out_counts, "sums": out_sums, "percentiles": out_pct}
    keys = rows * (2 * bucket_limit + 2) + dense_idx
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    first = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    uniq = keys[first]
    folded = np.add.reduceat(cell_counts[order], first)
    u_rows = uniq // (2 * bucket_limit + 2)
    u_idx = uniq - u_rows * (2 * bucket_limit + 2)
    keep = (u_rows >= 0) & (u_rows < m)
    u_rows, u_idx, folded = u_rows[keep], u_idx[keep], folded[keep]
    if not len(u_rows):
        return {"counts": out_counts, "sums": out_sums, "percentiles": out_pct}

    # segments: one per occupied row, cells in bucket order
    seg_start = np.flatnonzero(np.r_[True, u_rows[1:] != u_rows[:-1]])
    seg_len = np.diff(np.r_[seg_start, len(u_rows)])
    seg_rows = u_rows[seg_start]
    cum = np.cumsum(folded)
    before = np.r_[0, cum[seg_start[1:] - 1]]  # exclusive row prefix
    cdf = cum - np.repeat(before, seg_len)
    totals = cdf[seg_start + seg_len - 1]
    out_counts[seg_rows] = totals

    reps = decompress_np(u_idx - bucket_limit, precision)
    out_sums[seg_rows] = np.add.reduceat(reps * folded.astype(np.float64),
                                         seg_start)

    cdfn = cdf.astype(np.float64) / np.repeat(totals, seg_len).astype(
        np.float64)
    below = cdfn[:, None] < ps[None, :]  # [cells, P]
    n_below = np.add.reduceat(below.astype(np.int64), seg_start, axis=0)
    pos = np.minimum(n_below, (seg_len - 1)[:, None])
    pos = np.where(ps[None, :] <= 0, 0,
                   np.where(ps[None, :] >= 1, (seg_len - 1)[:, None], pos))
    out_pct[seg_rows] = reps[seg_start[:, None] + pos]
    return {"counts": out_counts, "sums": out_sums, "percentiles": out_pct}


def bucket_representatives(
    bucket_limit: int, precision: int = PRECISION, device=None,
    dtype=None,
) -> torch.Tensor:
    """Representative value of every dense-axis bucket (index b maps to
    codec bucket b - bucket_limit), rounded once from the float64 host
    codec so every device holds the same table; ``dtype`` None means
    ``torch.float32``.  Built once per (geometry, device, dtype) and
    shared: callers must not write it."""
    import torch

    return _representatives(bucket_limit, precision,
                            torch.device(device or "cpu"),
                            torch.float32 if dtype is None else dtype)


@functools.lru_cache(maxsize=64)
def _representatives(bucket_limit, precision, device, dtype):
    from loghisto_tpu_torch.ops.backend import to_device

    idx = np.arange(-bucket_limit, bucket_limit + 1, dtype=np.int64)
    # the first query of a geometry uploads without a synchronisation
    return to_device(decompress_np(idx, precision), device, dtype)


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
    snap = dense_cdf(acc, bucket_limit, precision)
    return snapshot_row_stats(
        snap["cdf"], snap["counts"], snap["sums"], ps, bucket_limit, precision
    )


def row_sums(
    acc: torch.Tensor, bucket_limit: int, precision: int = PRECISION
) -> torch.Tensor:
    """Per-row float32 sum of representative values: the float32 matvec
    ``acc.float() @ reps`` every dense statistic shares."""
    import torch

    # state the matvec's precision: full float32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    reps = bucket_representatives(bucket_limit, precision, acc.device)
    return acc.to(torch.float32) @ reps


def dense_cdf(
    acc: torch.Tensor, bucket_limit: int, precision: int = PRECISION
) -> dict[str, torch.Tensor]:
    """Commit-time snapshot payload of a dense int32 [M, B] count tensor,
    or of V of them stacked [V, M, B]: ``cdf`` int32 of the same shape
    (exact per-row bucket prefix sums, the cumsum kept in int32 — by
    default torch would promote it to int64), ``counts`` int32 [M] or
    [V, M] (its last column) and ``sums`` float32 [M] or [V, M]
    (``row_sums`` of each [M, B] on its own, so each view's sums are the
    bits ``window_stats`` computes for it)."""
    import torch

    cdf = torch.cumsum(acc, dim=-1, dtype=torch.int32)
    if acc.ndim == 3:
        sums = torch.stack([row_sums(a, bucket_limit, precision) for a in acc])
    else:
        sums = row_sums(acc, bucket_limit, precision)
    return {"cdf": cdf, "counts": cdf[..., -1].contiguous(), "sums": sums}


def _owned(mesh, rows: int, ids, device):
    """On a mesh: (global row ids as a long tensor, this rank's block
    index of each, whether this rank's block holds it)."""
    from loghisto_tpu_torch.ops.backend import to_device
    from loghisto_tpu_torch.parallel.mesh import METRIC_AXIS, axis_index
    import torch

    idx = to_device(ids, device, torch.long)
    lo = axis_index(mesh, METRIC_AXIS) * rows
    own = (idx >= lo) & (idx < lo + rows)
    return idx, torch.where(own, idx - lo, torch.zeros_like(idx)), own


def make_snapshot_query_fn(bucket_limit: int, precision: int = PRECISION,
                           mesh=None):
    """Sparse snapshot query ``f(cdf, counts, sums, ids, ps) -> stats of
    rows ids``: one gather of the requested rows on the snapshot's
    device, then ``snapshot_row_stats``; readback is O(len(ids) * P).
    ``ids`` may be host ints; they are moved to the snapshot's device.

    With ``mesh`` the payload is this rank's row block and ``ids`` are
    global: each rank computes the stats of the rows its block holds,
    and one ``all_gather`` over the metric axis (a collective of the
    rank's metric line) brings every rank each row's stats from its
    owner, the same ``[n, P]`` results on every rank, bit for bit."""
    import torch

    from loghisto_tpu_torch.ops.backend import to_device

    def query(cdf, counts, sums, ids, ps):
        idx = to_device(ids, cdf.device, torch.long)
        return snapshot_row_stats(
            cdf[idx], counts[idx], sums[idx], ps, bucket_limit, precision
        )

    if mesh is None:
        return query

    def sharded_query(cdf, counts, sums, ids, ps):
        from loghisto_tpu_torch.parallel.mesh import gather_parts

        rows = cdf.shape[0]
        idx, local, _ = _owned(mesh, rows, ids, cdf.device)
        out = query(cdf, counts, sums, local, ps)
        # float64 holds every int32 count and bucket and every float32
        # sum and percentile exactly
        mine = torch.cat([
            out["counts"].double()[:, None], out["sums"].double()[:, None],
            out["buckets"].double(), out["percentiles"].double(),
        ], dim=1)
        every = gather_parts(mesh, mine[None]).to(cdf.device)
        pick = every[torch.clamp(idx // rows, max=every.shape[0] - 1),
                     torch.arange(len(idx), device=cdf.device)]
        n_ps = out["percentiles"].shape[1]
        return {
            "counts": pick[:, 0].to(torch.int32),
            "sums": pick[:, 1].to(torch.float32),
            "buckets": pick[:, 2:2 + n_ps].to(out["buckets"].dtype),
            "percentiles": pick[:, 2 + n_ps:].to(torch.float32),
        }

    return sharded_query


def make_group_query_fn(bucket_limit: int, precision: int = PRECISION,
                        mesh=None):
    """Group_by rollup ``f(cdf, counts, sums, ids, gids, ps, *,
    num_groups) -> stats per group``: gather the snapshot rows ``ids``,
    sum them into ``num_groups`` merged rows by ``gids``, then
    ``snapshot_row_stats``, all on the snapshot's device; readback is
    O(num_groups * P).  ``ids`` and ``gids`` may be host ints.

    The merge is exact: log-bucket histograms merge by bucket-count
    addition, and a prefix sum is linear, so the sum of CDF rows is the
    CDF of the merged histogram (int32 ``index_add_``, exact in any
    order; a merged group's total must stay within int32, the contract
    of one wheel slot).  The float32 sums add in the device's order,
    which CUDA's ``index_add_`` does not fix from run to run.  Callers
    pad ``ids`` with row 0 and send the pad rows to a dump group they
    drop after readback (``TimeWheel._group_rollup``).

    With ``mesh`` the payload is this rank's row block: each rank sums
    the rows its block holds into partial group rows, one int32
    ``all_reduce`` over the metric axis sums the partial CDFs and counts
    (exact, by the same linearity) and a float32 one the partial sums,
    then every rank runs the same row statistics.  A collective of the
    rank's metric line."""
    import torch

    from loghisto_tpu_torch.ops.backend import to_device

    def partial(cdf, counts, sums, rows_of, seg, num_groups, own=None):
        """The rows ``rows_of`` summed per group (rows not ``own``
        count as zero)."""
        device = cdf.device
        picked = cdf.index_select(0, rows_of)
        picked_counts = counts.index_select(0, rows_of)
        picked_sums = sums.index_select(0, rows_of)
        if own is not None:
            picked = picked.masked_fill(~own[:, None], 0)
            picked_counts = picked_counts.masked_fill(~own, 0)
            picked_sums = picked_sums.masked_fill(~own, 0)
        gcdf = torch.zeros((num_groups, cdf.shape[1]), dtype=cdf.dtype,
                           device=device).index_add_(0, seg, picked)
        gcounts = torch.zeros(num_groups, dtype=counts.dtype,
                              device=device).index_add_(0, seg,
                                                        picked_counts)
        gsums = torch.zeros(num_groups, dtype=sums.dtype,
                            device=device).index_add_(0, seg, picked_sums)
        return gcdf, gcounts, gsums

    def group_query(cdf, counts, sums, ids, gids, ps, *, num_groups):
        device = cdf.device
        seg = to_device(gids, device, torch.long)
        if mesh is None:
            idx = to_device(ids, device, torch.long)
            gcdf, gcounts, gsums = partial(cdf, counts, sums, idx, seg,
                                           num_groups)
        else:
            from loghisto_tpu_torch.parallel.mesh import reduce_parts

            _, local, own = _owned(mesh, cdf.shape[0], ids, device)
            gcdf, gcounts, gsums = partial(cdf, counts, sums, local, seg,
                                           num_groups, own)
            # one int32 reduce for the CDFs and counts, one float32 for
            # the sums
            whole = reduce_parts(mesh, torch.cat([gcdf, gcounts[:, None]],
                                                 dim=1))
            gcdf, gcounts = whole[:, :-1], whole[:, -1].contiguous()
            gsums = reduce_parts(mesh, gsums)
        return snapshot_row_stats(gcdf, gcounts, gsums, ps, bucket_limit,
                                  precision)

    return group_query


def snapshot_row_stats(
    cdf_rows: torch.Tensor,
    counts: torch.Tensor,
    sums: torch.Tensor,
    ps,
    bucket_limit: int,
    precision: int = PRECISION,
) -> dict[str, torch.Tensor]:
    """Statistics from exact int32 CDF rows [n, B] with their counts [n]
    and float32 sums [n]: counts and sums pass through, percentiles
    [n, P] and their selected buckets [n, P] are selected by the k* rule
    of ``dense_stats`` (same float32 operation order as the JAX
    ``snapshot_row_stats``)."""
    import torch

    from loghisto_tpu_torch.ops.backend import to_device

    num_buckets = cdf_rows.shape[1]
    device = cdf_rows.device
    reps = bucket_representatives(bucket_limit, precision, device)
    ps = to_device(ps, device, torch.float32)
    total_i = torch.clamp(counts, min=1)[:, None]  # [M, 1]
    total_f = total_i.to(torch.float32)
    k0 = torch.ceil(ps[None, :] * total_f)  # [M, P] first candidate
    window = torch.arange(-1.0, 2.0, dtype=torch.float32, device=device)
    cands = k0[:, :, None] + window  # [M, P, 3]
    ok = (cands / total_f[:, :, None] >= ps[None, :, None]) & (cands >= 1.0)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=device)
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
    idx = torch.searchsorted(cdf_rows.contiguous(), k.contiguous(),
                             side="left")
    idx = torch.clamp(idx, max=num_buckets - 1)
    pct = reps[idx]
    nonempty = (counts > 0)[:, None]
    return {
        "counts": counts,
        "sums": sums,
        "percentiles": torch.where(nonempty, pct, torch.zeros_like(pct)),
        "buckets": idx,
    }
