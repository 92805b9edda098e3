"""Plain PyTorch ingest: codec -> scatter-add into the dense bucket tensor
(counterpart of ``loghisto_tpu/ops/ingest.py``).

These are the semantic oracle of the three Hopper kernels
(ops/fused_ingest.py, ops/row_ingest.py, ops/sparse_ingest.py): a batch
of ``(metric_id, value)`` samples is bucketed and scatter-added into an
``int32[num_metrics, num_buckets]`` accumulator.  Ordering never
matters — log-bucket histograms are commutative.

Where JAX donates the accumulator and returns a new one, these update
``acc`` IN PLACE and return it.  Out-of-range metric ids (negative or
>= M) drop.  JAX gets that from ``mode="drop"`` after mapping negative
ids out of range (it would otherwise wrap them); PyTorch's
``index_put_`` raises on an out-of-range index and wraps a negative one,
so here the invalid samples are masked out before the scatter.
"""

from __future__ import annotations

import torch

from loghisto_tpu_torch.config import PRECISION
from loghisto_tpu_torch.ops.backend import resolve_device
from loghisto_tpu_torch.ops.codec import compress


def bucket_indices(
    values: torch.Tensor, bucket_limit: int, precision: int = PRECISION
) -> torch.Tensor:
    """values -> clipped dense bucket-axis indices in [0, 2*bucket_limit]
    (int32).  Values are taken as float32 first — the canonical sample
    type of every ingest path — then bucketed by the float64 codec."""
    buckets = compress(torch.as_tensor(values).to(torch.float32), precision)
    return torch.clamp(buckets, -bucket_limit, bucket_limit) + bucket_limit


def sanitize_ids(ids: torch.Tensor, num_metrics: int) -> torch.Tensor:
    """Keep-mask of the samples whose metric id lies in [0, num_metrics).
    (The JAX twin remaps negative ids past the end for mode="drop"; a
    mask is the PyTorch form of the same drop.)"""
    return (ids >= 0) & (ids < num_metrics)


def _scatter(acc, ids, cols, weights) -> torch.Tensor:
    keep = sanitize_ids(ids, acc.shape[0])
    acc.index_put_(
        (ids[keep].long(), cols[keep].long()),
        weights[keep].to(acc.dtype),
        accumulate=True,
    )
    return acc


def ingest_batch(
    acc: torch.Tensor,
    ids: torch.Tensor,
    values: torch.Tensor,
    bucket_limit: int,
    precision: int = PRECISION,
) -> torch.Tensor:
    """Accumulate one (ids, values) batch into ``acc`` in place."""
    cols = bucket_indices(values, bucket_limit, precision)
    return _scatter(acc, ids, cols, torch.ones_like(cols))


def weighted_ingest_batch(
    acc: torch.Tensor,
    ids: torch.Tensor,
    buckets: torch.Tensor,
    weights: torch.Tensor,
    bucket_limit: int,
) -> torch.Tensor:
    """Pre-computed codec buckets plus integer weights, in place; buckets
    are clipped to the dense range."""
    cols = torch.clamp(buckets, -bucket_limit, bucket_limit) + bucket_limit
    return _scatter(acc, ids, cols, weights)


def _on(device):
    dev = resolve_device(device)
    return lambda t: torch.as_tensor(t, device=dev)


def make_ingest_fn(bucket_limit: int, precision: int = PRECISION,
                   device=None):
    """f(acc, ids, values) -> acc (in place) with acc int32 [M, B] on
    ``device`` (default the card).  Host arrays are moved there."""
    on = _on(device)

    def ingest(acc, ids, values):
        return ingest_batch(acc, on(ids), on(values), bucket_limit, precision)

    return ingest


def make_weighted_ingest_fn(bucket_limit: int, device=None):
    """f(acc, ids, buckets, weights) -> acc (in place): merge pre-bucketed
    host-tier histograms (weight = bucket count)."""
    on = _on(device)

    def ingest(acc, ids, buckets, weights):
        return weighted_ingest_batch(
            acc, on(ids), on(buckets), on(weights), bucket_limit
        )

    return ingest


def make_packed_ingest_fn(bucket_limit: int, device=None):
    """f(acc, packed) -> acc (in place) from ONE int32 [n, 3] array of
    (id, codec_bucket, count) columns; pad rows use id -1."""
    on = _on(device)

    def ingest(acc, packed):
        packed = on(packed)
        if packed.ndim != 2 or packed.shape[1] != 3:
            raise ValueError(
                f"packed must be [n, 3] (id, bucket, count); "
                f"got {tuple(packed.shape)}"
            )
        return weighted_ingest_batch(
            acc, packed[:, 0], packed[:, 1], packed[:, 2], bucket_limit
        )

    return ingest


def merge_accumulators(acc: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """Elementwise histogram merge, in place — the mergeability property
    the whole distributed design rides on."""
    return acc.add_(other)
