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

A JAX ``TPUAggregator(ingest_path="multirow")`` keeps its accumulator
lane-padded to [M, H * 128]; pass ``bucket_limit`` and the pad is
stripped to the canonical [M, 2 * bucket_limit + 1] (ROADMAP D7, the
layout the JAX checkpoint also treats as canonical).

For paged storage, ``paged_state_from_jax`` takes what the caller
reads off a JAX ``TPUAggregator(storage="paged").paged``:

    pool            = np.asarray(store._pool)     # int32 [P, page_size]
    page_table      = store.page_table            # int32 [M, ppr]
    row_codec       = store.row_codec             # int8 [M], -1 unassigned
    host_spill      = store._host_spill           # {(row, dense idx): n}
    free_lists      = store._free_lists           # one list per arena
    allocated_pages = store.allocated_pages

After the load, the port's ``collect()`` equals the JAX aggregator's
``collect()`` from the same state.  A JAX store on a mesh has one arena
per metric shard (``free_lists`` one list each, the pool the arenas in
shard order): its state loads onto any rank of a port mesh with as many
metric shards, each rank taking its arena's block of the pool and its
block's spilled cells (ROADMAP D12).

``wheel_state_from_jax`` reads a JAX ``loghisto_tpu.window.TimeWheel``
(duck-typed: its rings through ``np.asarray``, its tier metadata,
counters, pinned windows and registry names) into the state dict that
``TimeWheel.load_state_dict`` reads and ``TimeWheel.state_dict``
writes.  The loaded wheel then answers every query as the JAX wheel
does, and keeps doing so as both take the same intervals.

``lifecycle_state_from_jax`` and ``anomaly_state_from_jax`` take a JAX
``LifecycleManager.state_dict()`` / ``AnomalyManager.state_dict()``
(host NumPy arrays and ints) and return the state that the port's
``LifecycleManager.load_state`` / ``AnomalyManager.load_state`` read,
so both packages continue from the same activity vector, counters and
baseline banks.

A JAX aggregator, wheel or manager on a mesh is read the same way:
``np.asarray`` of a sharded JAX array gathers it to the host, so these
states are whole, and each load on a port mesh of any shape keeps its
rank's blocks (the accumulator's rows on stream index 0, ROADMAP D11).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np

from loghisto_tpu_torch.config import PRECISION
from loghisto_tpu_torch.parallel.aggregator import STATE_FORMAT
from loghisto_tpu_torch.window.store import WHEEL_STATE_FORMAT


def state_from_jax(
    acc: np.ndarray,
    names: Sequence[Optional[str]],
    lifetime: Mapping[int, Sequence],
    spill: Optional[np.ndarray] = None,
    precision: int = PRECISION,
    bucket_limit: Optional[int] = None,
) -> dict:
    """Build a ``TorchAggregator`` state dict from a JAX aggregator's
    accumulator, registry names, lifetime store and spill.  With
    ``bucket_limit``, ``acc`` may be wider than 2 * bucket_limit + 1
    columns (a multirow accumulator's lane pad), and the extra columns
    are dropped."""
    acc = np.array(acc, dtype=np.int32, copy=True)
    if bucket_limit is not None:
        width = 2 * bucket_limit + 1
        if acc.ndim != 2 or acc.shape[1] < width:
            raise ValueError(
                f"acc must be int32 [M, >= {width}] for bucket_limit="
                f"{bucket_limit}; got {acc.shape}"
            )
        acc = np.ascontiguousarray(acc[:, :width])
    if acc.ndim != 2 or acc.shape[1] % 2 != 1:
        raise ValueError(
            f"acc must be int32 [M, 2*bucket_limit+1]; got {acc.shape} "
            "(pass bucket_limit= to strip a multirow lane pad)"
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
    store's pool, page table, codecs, host spill, free lists and
    allocation count, plus the aggregator's names and lifetime store.
    ``free_lists`` holds one list per arena: one for a single-device
    store, one per metric shard for a mesh store, whose state then loads
    onto any rank of a port mesh with that many metric shards."""
    pool = np.array(pool, dtype=np.int32, copy=True)
    table = np.array(page_table, dtype=np.int32, copy=True)
    if pool.ndim != 2:
        raise ValueError(f"pool must be int32 [P, page_size]; got {pool.shape}")
    if table.ndim != 2 or table.shape[1] * pool.shape[1] < 2 * bucket_limit + 1:
        raise ValueError(
            f"page_table {table.shape} does not cover {2 * bucket_limit + 1} "
            f"buckets in pages of {pool.shape[1]}"
        )
    if not len(free_lists) or pool.shape[0] % len(free_lists):
        raise ValueError(
            f"a pool of {pool.shape[0]} pages does not split into "
            f"{len(free_lists)} page arenas"
        )
    if table.shape[0] % len(free_lists):
        raise ValueError(
            f"a page table of {table.shape[0]} rows does not split over "
            f"{len(free_lists)} page arenas"
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
            **({"free_list": [int(x) for x in free_lists[0]]}
               if len(free_lists) == 1 else
               {"free_lists": [[int(x) for x in f] for f in free_lists]}),
            "allocated_pages": int(allocated_pages),
        },
        "names": names,
        "agg": {int(mid): [e[0], e[1]] for mid, e in lifetime.items()},
        "spill": None,
    }


def wheel_state_from_jax(jax_wheel) -> dict:
    """Build a ``TimeWheel`` state dict from a JAX ``TimeWheel``: per
    tier the ring (int32 [S, M, B]), ``slot``, ``in_slot``, ``written``,
    ``durations`` and ``rates``; the wheel's ``intervals_pushed``,
    ``samples_retained``, ``shed_samples``, pinned windows, last interval
    time and registry names."""
    tiers = jax_wheel._tiers
    return {
        "format": WHEEL_STATE_FORMAT,
        "bucket_limit": jax_wheel.config.bucket_limit,
        "precision": jax_wheel.config.precision,
        "interval": float(jax_wheel.interval),
        "num_metrics": int(jax_wheel.num_metrics),
        "tiers": [(int(t.spec.slots), int(t.spec.res)) for t in tiers],
        "rings": [np.array(t.ring, dtype=np.int32, copy=True) for t in tiers],
        "slot": [int(t.slot) for t in tiers],
        "in_slot": [int(t.in_slot) for t in tiers],
        "written": [np.array(t.written, dtype=bool, copy=True)
                    for t in tiers],
        "durations": [np.array(t.durations, dtype=np.float64, copy=True)
                      for t in tiers],
        "rates": [[dict(r) for r in t.rates] for t in tiers],
        "intervals_pushed": int(jax_wheel.intervals_pushed),
        "samples_retained": int(jax_wheel.samples_retained),
        "shed_samples": int(jax_wheel.shed_samples),
        "pinned": [float(w) for w in jax_wheel.pinned_windows()],
        "names": list(jax_wheel.registry.names()),
        "last_time": jax_wheel._last_time,
    }


def lifecycle_state_from_jax(state: Mapping) -> dict:
    """A port ``LifecycleManager`` state from a JAX
    ``LifecycleManager.state_dict()``: the activity vector (int32 [M])
    and the lifetime counters."""
    la = np.array(state.get("last_active", []), dtype=np.int32, copy=True)
    if la.ndim != 1:
        raise ValueError(f"last_active must be int32 [M]; got {la.shape}")
    return {
        "last_active": la,
        **{key: int(state.get(key, 0)) for key in (
            "evicted_series", "overflowed_samples", "evictions",
            "compactions")},
    }


def anomaly_state_from_jax(state: Mapping) -> dict:
    """A port ``AnomalyManager`` state from a JAX
    ``AnomalyManager.state_dict()``: the baseline banks (prof f32
    [K, M, B], wsum f32 [K, M]) and the scored-interval count."""
    prof = np.array(state["prof"], dtype=np.float32, copy=True)
    wsum = np.array(state["wsum"], dtype=np.float32, copy=True)
    if prof.ndim != 3 or wsum.shape != prof.shape[:2]:
        raise ValueError(
            f"prof must be f32 [K, M, B] and wsum f32 [K, M]; got "
            f"{prof.shape} and {wsum.shape}"
        )
    return {"prof": prof, "wsum": wsum,
            "scored_intervals": int(state.get("scored_intervals", 0))}
