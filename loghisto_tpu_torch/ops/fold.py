"""Host fold of raw samples into packed triples — the sparse transport's
host half (counterpart of the fold tiers of
``loghisto_tpu/_native/__init__.py``: ``compress_np_host``,
``pack_cells``, ``fold_packed_numpy``, ``unpack_cells`` and
``fold_packed``).

A raw ``(ids, values)`` batch folds into an int32 ``[n, 3]`` array of
``(id, codec_bucket, count)`` rows with the float64 codec — the same
buckets ``compress_np`` and the device kernels give.  A count above
``PACKED_COUNT_CAP`` splits across rows.  ``fold_packed`` takes the
parallel C++ fold (``loghisto_tpu_torch._native.fold_packed_native``)
when the native library builds and this NumPy tier otherwise; both run
the same codec, so their cells are equal.
"""

from __future__ import annotations

import numpy as np

# Per-row count cap of the packed wire format: every emitted row stays
# < 2^30, below the aggregator's int32 spill threshold, and a larger
# count splits across rows (additive merges keep splits exact).
PACKED_COUNT_CAP = (1 << 30) - 1


def compress_np_host(values: np.ndarray, precision: int = 100) -> np.ndarray:
    """Float64 host codec, bit for bit ``ops.codec.compress_np`` (int32
    out)."""
    v = np.asarray(values, dtype=np.float64)
    mag = np.floor(precision * np.log1p(np.abs(v)) + 0.5)
    mag = np.where(np.isnan(mag), 0.0, mag)
    mag = np.minimum(mag, 32767.0)
    out = mag.astype(np.int32)
    return np.where(v < 0, -out, out).astype(np.int32)


def pack_cells(
    ids: np.ndarray, buckets: np.ndarray, counts: np.ndarray,
    cap: int = PACKED_COUNT_CAP,
) -> np.ndarray:
    """Assemble unique-cell columns into the int32 [m, 3] wire array,
    splitting any count > cap across rows.  counts must be positive."""
    counts = np.asarray(counts, dtype=np.int64)
    if not len(counts):
        return np.empty((0, 3), dtype=np.int32)
    reps = (counts + cap - 1) // cap
    total = int(reps.sum())
    out = np.empty((total, 3), dtype=np.int32)
    out[:, 0] = np.repeat(np.asarray(ids, dtype=np.int64), reps)
    out[:, 1] = np.repeat(np.asarray(buckets, dtype=np.int64), reps)
    weights = np.full(total, cap, dtype=np.int64)
    ends = np.cumsum(reps) - 1
    weights[ends] = counts - (reps - 1) * cap
    out[:, 2] = weights
    return out


def fold_packed_numpy(
    ids: np.ndarray, values: np.ndarray, bucket_limit: int,
    precision: int = 100,
) -> np.ndarray:
    """Fold a raw batch into packed [m, 3] triples: compress (float64),
    key, unique.  Negative ids drop here; ids >= M drop on the device."""
    ids = np.asarray(ids, dtype=np.int32)
    values = np.asarray(values, dtype=np.float32)
    keep = ids >= 0
    if not keep.all():
        ids, values = ids[keep], values[keep]
    if not len(ids):
        return np.empty((0, 3), dtype=np.int32)
    b = np.clip(compress_np_host(values, precision),
                -bucket_limit, bucket_limit)
    keys = (ids.astype(np.int64) << 16) | (b.astype(np.int64) + 32768)
    ukeys, counts = np.unique(keys, return_counts=True)
    return pack_cells(ukeys >> 16, (ukeys & 0xFFFF) - 32768, counts)


def fold_packed(
    ids: np.ndarray, values: np.ndarray, bucket_limit: int,
    precision: int = 100, num_threads: int | None = None,
) -> np.ndarray:
    """Fold a raw batch into packed triples through the fastest tier
    there is: the parallel native fold when the library built (and could
    allocate its tables), ``fold_packed_numpy`` otherwise, so the sparse
    transport never needs a compiler."""
    from loghisto_tpu_torch import _native

    if _native.available():
        try:
            return _native.fold_packed_native(
                ids, values, bucket_limit, precision, num_threads)
        except MemoryError:
            pass  # table or output allocation failed: the NumPy tier
    return fold_packed_numpy(ids, values, bucket_limit, precision)


def unpack_cells(packed: np.ndarray):
    """Split the int32 [m, 3] wire array into (ids int32, codec_buckets
    int32, counts int64) columns."""
    return (
        packed[:, 0],
        packed[:, 1],
        packed[:, 2].astype(np.int64),
    )
