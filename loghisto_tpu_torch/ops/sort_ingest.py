"""Sort-deduplicated ingest (counterpart of
``loghisto_tpu/ops/sort_ingest.py``).

The JAX package builds these for the TPU, where a scatter-add with many
duplicate (metric, bucket) indices serialises: the batch becomes one
combined cell key per sample, a sort groups equal keys, and one
conflict-free scatter adds each unique cell's count.  In the JAX package
they are XLA, not Pallas, so here they are plain PyTorch that runs on
the tensor's device — on the card too, where ``ingest_path="sort"`` or
``"sortscan"`` asks for them.  Bit-identical to ``ops/ingest.py``
(histograms are commutative); ``acc`` is updated IN PLACE.

  * ``sort_ingest_batch``: ``torch.unique(return_counts=True)`` over the
    keys, then one ``index_add_`` of the counts.
  * ``sortscan_ingest_batch``: one sort, segment starts from adjacent
    differences, each start's count the distance to the next start.

The keys are int64 here, but the JAX package's int32 bound on the
combined key (``num_metrics * num_buckets < 2^31 - 2``) is kept and
checked at construction (``validate_flat_cell_shape``), so both packages
accept the same shapes.
"""

from __future__ import annotations

import torch

from loghisto_tpu_torch.config import PRECISION
from loghisto_tpu_torch.ops.backend import resolve_device
from loghisto_tpu_torch.ops.ingest import bucket_indices, sanitize_ids

# one shy of the JAX sort path's invalid-key sentinel
MAX_FLAT_CELLS = 2**31 - 2


def flat_cell_incapability(
    num_metrics: int, num_buckets: int, path: str = "sort"
) -> str | None:
    """Why a combined int32 cell key (id * num_buckets + bucket) cannot
    represent this shape, or None — the bound every path that flattens
    (row, bucket) keeps (sort, sortscan, matmul)."""
    if num_metrics * num_buckets >= MAX_FLAT_CELLS:
        return (
            f"{path} ingest needs num_metrics * num_buckets < 2^31 - 2 "
            f"for its combined int32 cell key; got "
            f"{num_metrics} x {num_buckets}"
        )
    return None


def validate_flat_cell_shape(
    num_metrics: int, num_buckets: int, path: str = "sort"
) -> None:
    """Raise ``flat_cell_incapability``'s reason, if there is one."""
    reason = flat_cell_incapability(num_metrics, num_buckets, path)
    if reason is not None:
        raise ValueError(reason)


def _cell_keys(acc, ids, values, bucket_limit, precision):
    """Flat int64 cell keys (id * num_buckets + bucket) of the samples
    whose id lies in [0, M); the others drop here."""
    num_metrics, num_buckets = acc.shape
    bidx = bucket_indices(values, bucket_limit, precision).long()
    keep = sanitize_ids(ids, num_metrics)
    return ids[keep].long() * num_buckets + bidx[keep]


def sort_ingest_batch(
    acc: torch.Tensor,
    ids: torch.Tensor,
    values: torch.Tensor,
    bucket_limit: int,
    precision: int = PRECISION,
) -> torch.Tensor:
    """Accumulate one (ids, values) batch into ``acc`` in place: unique
    cells and their counts, then one scatter of unique indices."""
    keys = _cell_keys(acc, ids, values, bucket_limit, precision)
    cells, counts = torch.unique(keys, return_counts=True)
    acc.view(-1).index_add_(0, cells, counts.to(acc.dtype))
    return acc


def sortscan_ingest_batch(
    acc: torch.Tensor,
    ids: torch.Tensor,
    values: torch.Tensor,
    bucket_limit: int,
    precision: int = PRECISION,
) -> torch.Tensor:
    """The leaner dedup, in place: one sort, segment starts where the
    sorted key changes, each segment's count the distance from its start
    to the next start (the JAX reverse min-scan in closed form)."""
    keys = _cell_keys(acc, ids, values, bucket_limit, precision)
    n = keys.shape[0]
    if n == 0:
        return acc
    sk = torch.sort(keys).values
    flags = torch.ones(n, dtype=torch.bool, device=sk.device)
    flags[1:] = sk[1:] != sk[:-1]
    starts = torch.nonzero(flags).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    acc.view(-1).index_add_(0, sk[starts], (ends - starts).to(acc.dtype))
    return acc


def _make(step, path, bucket_limit, precision, device):
    dev = resolve_device(device)

    def ingest(acc, ids, values):
        validate_flat_cell_shape(acc.shape[0], acc.shape[1], path)
        return step(
            acc, torch.as_tensor(ids, device=dev),
            torch.as_tensor(values, device=dev), bucket_limit, precision,
        )

    return ingest


def make_sort_ingest_fn(bucket_limit: int, precision: int = PRECISION,
                        device=None):
    """f(acc, ids, values) -> acc (in place) through the sort-dedup
    formulation on ``device`` (default the card)."""
    return _make(sort_ingest_batch, "sort", bucket_limit, precision, device)


def make_sortscan_ingest_fn(bucket_limit: int, precision: int = PRECISION,
                            device=None):
    """f(acc, ids, values) -> acc (in place) through the sortscan
    formulation on ``device`` (default the card)."""
    return _make(sortscan_ingest_batch, "sortscan", bucket_limit, precision,
                 device)
