"""Carrying aggregator state across from the JAX package — the metrics
system's counterpart of carrying weights across.

``state_from_jax`` takes plain host values read off a
``loghisto_tpu.parallel.aggregator.TPUAggregator`` (the caller reads
them; this module imports nothing of the JAX package) and builds the
state dict that ``TorchAggregator.load_state_dict`` reads and
``TorchAggregator.state_dict`` writes:

    acc      = np.asarray(jax_agg._acc)          # int32 [M, B]
    names    = jax_agg.registry.names()          # id -> name (None = hole)
    lifetime = jax_agg._agg                      # id -> [sum, count]
    spill    = jax_agg._spill                    # int64 [M, B] or None

For paged storage, ``paged_state_from_jax`` takes what the caller
reads off a JAX ``TPUAggregator(storage="paged").paged``:

    pool            = np.asarray(store._pool)     # int32 [P, page_size]
    page_table      = store.page_table            # int32 [M, ppr]
    row_codec       = store.row_codec             # int8 [M], -1 unassigned
    host_spill      = store._host_spill           # {(row, dense idx): n}
    free_lists      = store._free_lists           # one list per arena
    allocated_pages = store.allocated_pages

After the load, the port's ``collect()`` equals the JAX aggregator's
``collect()`` from the same state.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np

from loghisto_tpu_torch.config import PRECISION
from loghisto_tpu_torch.parallel.aggregator import STATE_FORMAT


def state_from_jax(
    acc: np.ndarray,
    names: Sequence[Optional[str]],
    lifetime: Mapping[int, Sequence],
    spill: Optional[np.ndarray] = None,
    precision: int = PRECISION,
) -> dict:
    """Build a ``TorchAggregator`` state dict from a JAX aggregator's
    accumulator, registry names, lifetime store and spill."""
    acc = np.array(acc, dtype=np.int32, copy=True)
    if acc.ndim != 2 or acc.shape[1] % 2 != 1:
        raise ValueError(
            f"acc must be int32 [M, 2*bucket_limit+1]; got {acc.shape}"
        )
    names = list(names)
    if len(names) > acc.shape[0]:
        raise ValueError(
            f"{len(names)} names for an accumulator of {acc.shape[0]} rows"
        )
    if spill is not None:
        spill = np.array(spill, dtype=np.int64, copy=True)
        if spill.shape != acc.shape:
            raise ValueError(
                f"spill shape {spill.shape} != acc shape {acc.shape}"
            )
    return {
        "format": STATE_FORMAT,
        "bucket_limit": (acc.shape[1] - 1) // 2,
        "precision": precision,
        "acc": acc,
        "names": names,
        "agg": {int(mid): [e[0], e[1]] for mid, e in lifetime.items()},
        "spill": spill,
    }


def paged_state_from_jax(
    pool: np.ndarray,
    page_table: np.ndarray,
    row_codec: np.ndarray,
    host_spill: Mapping[Tuple[int, int], int],
    free_lists: Sequence[Sequence[int]],
    allocated_pages: int,
    names: Sequence[Optional[str]],
    lifetime: Mapping[int, Sequence],
    bucket_limit: int = 4096,
    precision: int = PRECISION,
) -> dict:
    """Build a paged ``TorchAggregator`` state dict from a JAX paged
    store's pool, page table, codecs, host spill, free list and
    allocation count, plus the aggregator's names and lifetime store.
    The port is single-device: ``free_lists`` must hold one arena."""
    pool = np.array(pool, dtype=np.int32, copy=True)
    table = np.array(page_table, dtype=np.int32, copy=True)
    if pool.ndim != 2:
        raise ValueError(f"pool must be int32 [P, page_size]; got {pool.shape}")
    if table.ndim != 2 or table.shape[1] * pool.shape[1] < 2 * bucket_limit + 1:
        raise ValueError(
            f"page_table {table.shape} does not cover {2 * bucket_limit + 1} "
            f"buckets in pages of {pool.shape[1]}"
        )
    if len(free_lists) != 1:
        raise ValueError(
            f"{len(free_lists)} page arenas: the port's store is "
            "single-device (one arena)"
        )
    names = list(names)
    if len(names) > table.shape[0]:
        raise ValueError(
            f"{len(names)} names for a page table of {table.shape[0]} rows"
        )
    return {
        "format": STATE_FORMAT,
        "storage": "paged",
        "bucket_limit": int(bucket_limit),
        "precision": precision,
        "acc": None,
        "paged": {
            "pool": pool,
            "page_table": table,
            "row_codec": np.array(row_codec, dtype=np.int8, copy=True),
            "host_spill": {
                (int(r), int(d)): int(v) for (r, d), v in host_spill.items()
            },
            "free_list": [int(x) for x in free_lists[0]],
            "allocated_pages": int(allocated_pages),
        },
        "names": names,
        "agg": {int(mid): [e[0], e[1]] for mid, e in lifetime.items()},
        "spill": None,
    }
