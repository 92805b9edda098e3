"""Hybrid hot-row accumulation: a one-hot product for the hot head, a
scatter for the cold tail (counterpart of
``loghisto_tpu/ops/hybrid_hist.py``).

Samples whose row id is below ``hot_rows`` are counted by a factorized
[T, hot * H] x [T, 128] one-hot product per ``sample_tile`` samples
(H = ceil(B / 128)); the rest go through ``index_put_`` with
accumulation.  As in ``ops/matmul_hist.py`` the product is
``torch.matmul`` (XLA's dot in the JAX package, outside any Pallas
kernel) on float32 one-hots, and each tile's product (at most
``sample_tile`` counts per cell, exact in float32) is added into int32.
The JAX package refuses batches of 2^24 samples or more, because its
hot-head sum stays float32 across the whole batch; the same bound is
kept here so both packages refuse the same inputs.  Bit-identical to
``ops/ingest.py`` for any id distribution; ``acc`` is updated IN PLACE.
"""

from __future__ import annotations

import torch

from loghisto_tpu_torch.config import PRECISION
from loghisto_tpu_torch.ops.backend import resolve_device
from loghisto_tpu_torch.ops.ingest import bucket_indices, sanitize_ids
from loghisto_tpu_torch.ops.matmul_hist import LANES, one_hot_f32

MAX_BATCH = 1 << 24


def ingest_batch_hybrid(
    acc: torch.Tensor,
    ids: torch.Tensor,
    values: torch.Tensor,
    bucket_limit: int,
    precision: int = PRECISION,
    hot_rows: int = 128,
    sample_tile: int = 2048,
) -> torch.Tensor:
    """Accumulate one (ids, values) batch into acc [M, B] in place."""
    m, b = acc.shape
    hot = min(hot_rows, m)
    h = (b + LANES - 1) // LANES
    n = values.shape[0]
    if n >= MAX_BATCH:
        raise ValueError(
            f"batch of {n} >= 2^24 could silently saturate the float32 "
            "hot-head accumulation; split the batch"
        )
    idx = bucket_indices(values, bucket_limit, precision).long()
    valid = sanitize_ids(ids, m)
    is_hot = valid & (ids < hot)

    # hot head: column row * H + idx // 128; everything else takes the
    # drop column hot * H
    col = torch.where(is_hot, ids.long() * h + idx // LANES, hot * h)
    lane = idx % LANES
    head = torch.zeros((hot * h, LANES), dtype=torch.int32,
                       device=acc.device)
    for off in range(0, n, sample_tile):
        partial = torch.matmul(
            one_hot_f32(col[off:off + sample_tile], hot * h).T,
            one_hot_f32(lane[off:off + sample_tile], LANES),
        )
        head += partial.to(torch.int32)
    acc[:hot] += head.view(hot, h * LANES)[:, :b]

    # cold tail: the scatter
    cold = valid & ~is_hot
    cold_ids = ids[cold].long()
    acc.index_put_(
        (cold_ids, idx[cold]), torch.ones_like(cold_ids, dtype=acc.dtype),
        accumulate=True,
    )
    return acc


def make_hybrid_ingest_fn(bucket_limit: int, precision: int = PRECISION,
                          hot_rows: int = 128, device=None):
    """f(acc, ids, values) -> acc (in place) through the hybrid path on
    ``device`` (default the card)."""
    dev = resolve_device(device)

    def ingest(acc, ids, values):
        return ingest_batch_hybrid(
            acc, torch.as_tensor(ids, device=dev),
            torch.as_tensor(values, device=dev), bucket_limit, precision,
            hot_rows,
        )

    return ingest
