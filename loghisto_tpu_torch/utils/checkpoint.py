"""Checkpoint / resume for metric state (counterpart of
``loghisto_tpu/utils/checkpoint.py``, format version 3).

The reference has no persistence: its lifetime stores die with the
process (metrics.go:111-126).  The dense bucket tensor plus the lifetime
scalars fully determine the statistics, and both serialize as arrays.

Format: one ``.npz`` with JSON-encoded name tables, written atomically
(temp file, fsync, rename) so a crash mid-write cannot corrupt the last
good snapshot.  It is the JAX package's file, key for key and dtype for
dtype, so a snapshot written by either package restores into the other:

  * ``version`` (int64 3) and, when stamped, ``seq_watermark`` (int64):
    the last committed interval seq folded into the state;
  * the host ``MetricSystem``: ``ms_counter_names`` / ``ms_counter_values``
    (uint64), ``ms_agg_names`` / ``ms_agg_sums`` (float64) /
    ``ms_agg_counts`` (uint64), and ``ms_agg_sums_u64`` when every sum is
    an int (``go_compat``);
  * the aggregator: ``agg_acc``, the canonical dense ``[M, B]`` (int32
    for an unspilled dense accumulator, int64 when spilled or paged: the
    paged store's ``decode_dense(include_spill=True)``), ``agg_names``
    (freed slots as JSON null), ``agg_registry_generation``, the
    lifetime ``agg_ids`` / ``agg_sums`` / ``agg_counts``, and on paged
    storage each row's codec, ``pg_codec_names``;
  * ``lc_last_active`` / ``lc_counters`` (a ``LifecycleManager``) and
    ``an_prof`` / ``an_wsum`` / ``an_counters`` (an ``AnomalyManager``).

The port's multirow accumulator is already the canonical ``[M, B]``
(ROADMAP D7), so a save strips no lane padding.  A restore remaps rows
by NAME and merges into the live state on its device: a dense delta is
one in-place add on the accumulator's device (the card, where the
aggregator lives there), a paged delta one ``PagedStore.commit``
(translate, then one K4 launch); deltas that could wrap an int32 cell
take the exact host spill.  Interval caches are not persisted: the
samples of a crashed interval are shed, as in the reference.

On a ("stream", "metric") mesh (ROADMAP D11) ``save`` and ``restore``
are collective calls: every rank makes them, in the same order, on its
main thread.  A save holds the gathered state, never a rank's block:
the host stores and the accumulator's stream partials (with their
spills, in int64) summed over the stream axis, the accumulator, activity
and bank blocks gathered over the metric axis, each to rank (0, 0)
alone (a ``reduce`` and ``gather``s, not their all-rank forms); rank
(0, 0) alone writes the file, then one agreed status (a MIN over the mesh) makes a failed
write raise on every rank.  The optional key ``mesh_shape`` (int64
``[stream, metric]``) records the saving mesh; a file without it (the
JAX package's, or a single device's) reads as one stream row.  Every
rank reads the same file on a restore: the names register in the same
order on every rank, the registry's growth is laid out
(``TorchAggregator._mesh_regrow``), and only then do the rows land: the
accumulator's on stream index 0's blocks alone (each rank's share of
the int32 envelope decides between its block and its host spill), the
lifetime store, the activity vector and the banks on every rank's
blocks, the host stores on stream index 0's ranks.  A save on any mesh
shape restores onto any other, onto one device and into the JAX
package, and the JAX package's saves restore onto any mesh.

Paged storage on a mesh (ROADMAP D13): a save lands the staged batches,
then each metric shard's cells and its block's spilled cells go to rank
(0, 0) alone as int64 triples from the ranks of stream index 0 (the
arenas are the same on every rank of a metric column, never stream
partials, so nothing is summed over the stream axis), and rank (0, 0)
writes the canonical dense ``agg_acc`` and ``pg_codec_names`` as one
device does.  A restore makes the same host commit on every rank, each
landing its arena's triples; the spill-or-commit choice reads the
pool's maximum agreed over the mesh.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from loghisto_tpu_torch.parallel.mesh import (
    AXES,
    acc_sharding,
    agreed,
    axis_size,
    gather_objects,
    is_first_rank,
    is_stream_lead,
)

logger = logging.getLogger("loghisto_tpu_torch")

# v2: the interval-seq watermark rides the payload, so crash recovery
# replays only journal intervals past the snapshotted state (v1 files
# restore with watermark None).  v3: paged aggregators save the
# canonical dense decode of pool + host spill, so any storage restores
# any save, and ``pg_codec_names`` re-pins each row's codec on a paged
# restore (v1/v2 files restore with codecs chosen from the delta).
FORMAT_VERSION = 3


def save(
    path: str,
    metric_system=None,
    aggregator=None,
    lifecycle=None,
    anomaly=None,
    seq_watermark: Optional[int] = None,
    fault_injector=None,
) -> None:
    """Atomically snapshot lifetime state to ``path`` (.npz).

    ``seq_watermark`` stamps the snapshot with the last committed
    interval seq folded into this state.  ``fault_injector`` (any object
    with ``check(site)``) sees the two crash windows: "checkpoint.write"
    before the payload lands and "checkpoint.rename" after the fsync,
    before the atomic rename.

    ``lifecycle`` adds the activity vector and the churn counters (the
    overflow rows are ordinary named rows of the accumulator);
    ``anomaly`` adds the EWMA baseline banks.  The aggregator is read
    after one full barrier (``flush(force=True)``), the one
    ``state_dict`` takes."""
    mesh = _mesh_of(metric_system, aggregator, lifecycle, anomaly)
    if mesh is not None:
        return _mesh_save(path, mesh, metric_system, aggregator, lifecycle,
                          anomaly, seq_watermark, fault_injector)
    payload = {"version": np.int64(FORMAT_VERSION)}
    if seq_watermark is not None:
        payload["seq_watermark"] = np.int64(seq_watermark)

    if metric_system is not None:
        counters, agg = _host_stores(metric_system)
        _put_host_stores(payload, counters, agg)

    if aggregator is not None:
        # the full barrier: every buffered and queued sample is in the
        # accumulator (or the pool) before it is read
        aggregator.flush(force=True)
        spill = None
        with aggregator._dev_lock:
            if aggregator.paged is not None:
                acc = aggregator.paged.decode_dense(include_spill=True)
                payload["pg_codec_names"] = _names_arr(
                    aggregator.paged.codec_names()
                )
            else:
                # a copy on the device, ordered on the writers' stream:
                # the readback waits for it after the lock is released
                acc = aggregator._acc.clone()
                if aggregator._spill is not None:
                    spill = aggregator._spill.copy()
        if aggregator.paged is None:
            acc = acc.cpu().numpy()
            # a spilled interval keeps part of its counts in the host
            # int64 fold; the combined snapshot is int64
            if spill is not None:
                acc = acc.astype(np.int64) + spill
        with aggregator._agg_lock:
            agg_items = sorted(aggregator._agg.items())
        _put_aggregator(payload, aggregator, acc,
                        aggregator.registry.names(), agg_items)
    if lifecycle is not None:
        _put_lifecycle(payload, lifecycle.state_dict())
    if anomaly is not None:
        _put_anomaly(payload, anomaly.state_dict())
    _write(path, payload, fault_injector)


def _mesh_save(path, mesh, metric_system, aggregator, lifecycle, anomaly,
               seq_watermark, fault_injector) -> None:
    """``save`` on a mesh: every rank makes the same collectives, which
    deliver the gathered state to rank (0, 0) alone; it writes the file,
    then one agreed status."""
    first = is_first_rank(mesh)
    payload = {"version": np.int64(FORMAT_VERSION),
               "mesh_shape": np.array([axis_size(mesh, axis)
                                       for axis in AXES], dtype=np.int64)}
    if seq_watermark is not None:
        payload["seq_watermark"] = np.int64(seq_watermark)
    if metric_system is not None:
        sums = _stream_sums(mesh, *_host_stores(metric_system),
                            metric_system.config.go_compat)
        if first:
            _put_host_stores(payload, *sums)
    if aggregator is not None and aggregator.paged is not None:
        _put_paged_mesh(payload, aggregator, first)
    elif aggregator is not None:
        # the barrier, growth's layout, the stream sum, the metric gather
        st = aggregator.state_dict(first_only=True)
        if first:
            acc = (st["acc"] if st["spill"] is None
                   else st["acc"].astype(np.int64) + st["spill"])
            _put_aggregator(payload, aggregator, acc, st["names"],
                            sorted(st["agg"].items()))
    if lifecycle is not None:
        st = lifecycle.state_dict(first_only=True)
        if first:
            _put_lifecycle(payload, st)
    if anomaly is not None:
        st = anomaly.state_dict(first_only=True)
        if first:
            _put_anomaly(payload, st)
    err = None
    if first:
        try:
            _write(path, payload, fault_injector)
        except Exception as e:  # noqa: BLE001 - re-raised after the vote
            err = e
    if not agreed(mesh, err is None):
        if err is not None:
            raise err
        raise RuntimeError(f"checkpoint to {path} failed on rank (0, 0); "
                           "previous snapshot intact")


def _put_paged_mesh(payload: dict, aggregator, first: bool) -> None:
    """A paged mesh's aggregator into rank (0, 0)'s payload (ROADMAP
    D13): the staged batches land (the barrier and the growth's layout),
    then each metric shard's cells and its block's spilled cells, as
    int64 triples from the ranks of stream index 0, go to rank (0, 0)
    alone, which decodes them into the canonical dense ``agg_acc``.  The
    arenas are the same on every rank of a metric column, so the dense
    path's stream sum would count them ``n_stream`` times; it does not
    run.  The codecs, the names and the lifetime store are the same on
    every rank: rank (0, 0)'s own."""
    aggregator.land_staged()
    with aggregator._dev_lock:
        acc = aggregator.paged.decode_dense(include_spill=True,
                                            first_only=True)
        if not first:
            return
        payload["pg_codec_names"] = _names_arr(
            aggregator.paged.codec_names())
        names = aggregator.registry.names()
    with aggregator._agg_lock:
        agg_items = sorted(aggregator._agg.items())
    _put_aggregator(payload, aggregator, acc, names, agg_items)


def _host_stores(metric_system) -> tuple:
    """(counters, {name: (sum, count)}) of a host ``MetricSystem``."""
    with metric_system._store_lock:
        counters = dict(metric_system._counter_store)
        agg = {
            name: (entry[0], entry[1])
            for name, entry in metric_system._histogram_agg_store.items()
        }
    return counters, agg


def _put_host_stores(payload: dict, counters: dict, agg: dict) -> None:
    payload["ms_counter_names"] = _names_arr(counters.keys())
    payload["ms_counter_values"] = np.array(
        list(counters.values()), dtype=np.uint64
    )
    payload["ms_agg_names"] = _names_arr(agg.keys())
    payload["ms_agg_sums"] = np.array(
        [v[0] for v in agg.values()], dtype=np.float64
    )
    payload["ms_agg_counts"] = np.array(
        [v[1] for v in agg.values()], dtype=np.uint64
    )
    if agg and all(isinstance(v[0], int) for v in agg.values()):
        # go_compat sums are exact uint64s that float64 would clip
        # above 2^53; keep the exact form alongside
        payload["ms_agg_sums_u64"] = np.array(
            [v[0] & 0xFFFFFFFFFFFFFFFF for v in agg.values()],
            dtype=np.uint64,
        )


def _put_aggregator(payload: dict, aggregator, acc, names,
                    agg_items) -> None:
    payload["agg_acc"] = acc
    payload["agg_names"] = _names_arr(names)
    payload["agg_registry_generation"] = np.int64(
        getattr(aggregator.registry, "generation", 0)
    )
    payload["agg_ids"] = np.array(
        [k for k, _ in agg_items], dtype=np.int64
    )
    payload["agg_sums"] = np.array(
        [v[0] for _, v in agg_items], dtype=np.float64
    )
    payload["agg_counts"] = np.array(
        [v[1] for _, v in agg_items], dtype=np.uint64
    )


def _put_lifecycle(payload: dict, st: dict) -> None:
    payload["lc_last_active"] = st["last_active"]
    payload["lc_counters"] = np.array(
        [
            st["evicted_series"],
            st["overflowed_samples"],
            st["evictions"],
            st["compactions"],
        ],
        dtype=np.int64,
    )


def _put_anomaly(payload: dict, st: dict) -> None:
    payload["an_prof"] = st["prof"]
    payload["an_wsum"] = st["wsum"]
    payload["an_counters"] = np.array(
        [st["scored_intervals"]], dtype=np.int64
    )


def _write(path: str, payload: dict, fault_injector) -> None:
    """The payload to ``path``: temp file, fsync, atomic rename, with the
    fault injector's two sites."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        if fault_injector is not None:
            fault_injector.check("checkpoint.write")
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **payload)
            f.flush()
            os.fsync(f.fileno())  # data durable before the rename
        if fault_injector is not None:
            fault_injector.check("checkpoint.rename")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _mesh_of(*parts):
    """The mesh of the first part (a system, an aggregator or a manager)
    that runs on one, else None."""
    for part in parts:
        agg = getattr(part, "aggregator", part)
        mesh = getattr(agg, "mesh", None)
        if mesh is not None:
            return mesh
    return None


def _stream_sums(mesh, counters: dict, agg: dict, go_compat: bool):
    """The host stores summed over the stream axis (each stream row's
    ranks hold that row's samples; a counter sums over stream, D9), on
    rank (0, 0); None on every other rank.  A collective of the stream
    line through rank (0, 0)."""
    parts = gather_objects(mesh, (counters, agg))
    if parts is None:
        return None
    total_c: dict = {}
    total_a: dict = {}
    for c, a in parts:
        for name, v in c.items():
            total_c[name] = total_c.get(name, 0) + v
        for name, (s, n) in a.items():
            entry = total_a.setdefault(name, [0, 0])
            entry[0] += s
            if go_compat:
                entry[0] &= 0xFFFFFFFFFFFFFFFF
            entry[1] += n
    return total_c, {name: tuple(e) for name, e in total_a.items()}


def restore(
    path: str,
    metric_system=None,
    aggregator=None,
    lifecycle=None,
    anomaly=None,
) -> Optional[int]:
    """Restore lifetime state saved by ``save`` (either package's), merging
    over the targets' current state.  Rows remap by name through the
    aggregator's ``_id_for`` (its grow policy applies; a shed name warns
    and drops; freed slots stay holes); unnamed rows keep their id only
    where no named metric owns it.  ``lifecycle`` and ``anomaly`` take
    the saved activity vector and banks through the same row map, and
    the registry's generation advances to at least the saved one.

    Returns the snapshot's seq watermark, or None for an unstamped or v1
    file.  On a mesh a collective call (the module docstring has the
    rules)."""
    mesh = _mesh_of(metric_system, aggregator, lifecycle, anomaly)
    with np.load(path, allow_pickle=False) as data:
        version = int(data["version"])
        if version > FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        seq_watermark = (
            int(data["seq_watermark"]) if "seq_watermark" in data else None
        )

        if (metric_system is not None and "ms_counter_names" in data
                and (mesh is None or is_stream_lead(mesh))):
            _restore_metric_system(metric_system, data)

        if aggregator is not None and "agg_acc" in data:
            id_remap = _restore_aggregator(aggregator, data)
            if lifecycle is not None and "lc_last_active" in data:
                saved_la = np.asarray(data["lc_last_active"], dtype=np.int32)
                la = np.zeros(aggregator.num_metrics, dtype=np.int32)
                for saved_id, new_id in id_remap.items():
                    if saved_id < len(saved_la) and new_id < len(la):
                        la[new_id] = saved_la[saved_id]
                counters = data["lc_counters"]
                lifecycle.load_state({
                    "last_active": la,
                    "evicted_series": int(counters[0]),
                    "overflowed_samples": int(counters[1]),
                    "evictions": int(counters[2]),
                    "compactions": int(counters[3]),
                })
            if anomaly is not None and "an_prof" in data:
                # a baseline never lands on a row its name does not own
                saved_prof = np.asarray(data["an_prof"], dtype=np.float32)
                saved_wsum = np.asarray(data["an_wsum"], dtype=np.float32)
                k, ms_rows, b = saved_prof.shape
                m = aggregator.num_metrics
                prof = np.zeros((k, m, b), dtype=np.float32)
                wsum = np.zeros((k, m), dtype=np.float32)
                for saved_id, new_id in id_remap.items():
                    if saved_id < ms_rows and new_id < m:
                        prof[:, new_id] = saved_prof[:, saved_id]
                        wsum[:, new_id] = saved_wsum[:, saved_id]
                anomaly.load_state({
                    "prof": prof,
                    "wsum": wsum,
                    "scored_intervals": int(data["an_counters"][0]),
                })
    return seq_watermark


def _restore_metric_system(metric_system, data) -> None:
    names = _arr_names(data["ms_counter_names"])
    values = data["ms_counter_values"]
    agg_names = _arr_names(data["ms_agg_names"])
    sums = data["ms_agg_sums"]
    counts = data["ms_agg_counts"]
    # go_compat stores need int sums (the uint64 mask would TypeError
    # on floats); the exact u64 sidecar is preferred
    go_compat = metric_system.config.go_compat
    if go_compat and "ms_agg_sums_u64" in data:
        sums = data["ms_agg_sums_u64"]
    with metric_system._store_lock:
        for name, value in zip(names, values):
            metric_system._counter_store[name] = int(value)
        for name, s, c in zip(agg_names, sums, counts):
            metric_system._histogram_agg_store[name] = [
                int(s) if go_compat else float(s), int(c)
            ]


def _remap_rows(aggregator, acc: np.ndarray, saved_names):
    """The snapshot's rows moved to their target ids: (remapped [M, B]
    of the target's row count, [(saved id, target id)]).  Named rows map
    by name through ``_id_for`` (grow policy, shed with a warning, holes
    skipped), then unnamed nonzero rows by identity where no named
    metric owns the id.  On a mesh the registry's growth is laid out
    after the names register and before the rows are placed."""
    row_map = []
    for saved_id, name in enumerate(saved_names):
        if name is None:
            continue  # a freed slot: folded and zeroed before the save
        new_id = aggregator._id_for(name)
        if new_id < 0:
            logger.warning(
                "restore: metric %r shed (registry at max_metrics)", name
            )
            continue
        row_map.append((saved_id, new_id))
    named_rows = {saved_id for saved_id, _ in row_map}
    named_targets = {new_id for _, new_id in row_map}
    target_named_rows = len(aggregator.registry)
    live = np.nonzero(acc.any(axis=1))[0].tolist()
    for saved_id in live:
        if saved_id in named_rows:
            continue
        if saved_id in named_targets or saved_id < target_named_rows:
            logger.warning(
                "restore: dropping unnamed checkpoint row %d: its row id "
                "is owned by a named metric in the target; register names "
                "before saving to keep such rows", saved_id,
            )
            continue
        row_map.append((saved_id, saved_id))
    if aggregator.mesh is not None:
        aggregator._mesh_regrow()
    remapped = np.zeros(
        (aggregator.num_metrics, acc.shape[1]), dtype=acc.dtype
    )
    for saved_id, new_id in row_map:
        remapped[new_id] += acc[saved_id]
    return remapped, row_map


def _restore_aggregator(aggregator, data) -> dict:
    """Merge the snapshot's accumulator and lifetime store into
    ``aggregator``; returns the saved-id -> target-id map."""
    acc = data["agg_acc"]
    # the target may have MORE rows than the snapshot (growth)
    if (
        acc.ndim != 2
        or acc.shape[1] != aggregator.config.num_buckets
        or acc.shape[0] > aggregator.num_metrics
    ):
        raise ValueError(
            f"checkpoint accumulator shape {acc.shape} does not fit the "
            "aggregator's configuration "
            f"({aggregator.num_metrics}, {aggregator.config.num_buckets})"
        )
    remapped, row_map = _remap_rows(aggregator, acc,
                                    _arr_names(data["agg_names"]))
    if aggregator.paged is not None:
        codecs = (_arr_names(data["pg_codec_names"])
                  if "pg_codec_names" in data else None)
        with aggregator._dev_lock:
            _restore_paged_delta(aggregator, remapped, row_map, codecs)
    elif aggregator.mesh is not None:
        with aggregator._dev_lock:
            _restore_mesh_delta(aggregator, remapped)
    else:
        with aggregator._dev_lock:
            _restore_dense_delta(aggregator, remapped)
    id_remap = dict(row_map)
    with aggregator._agg_lock:
        go_compat = aggregator.config.go_compat
        for mid, s, c in zip(
            data["agg_ids"], data["agg_sums"], data["agg_counts"]
        ):
            new_id = id_remap.get(int(mid))
            if new_id is None:
                continue
            entry = aggregator._agg.setdefault(new_id, [0, 0])
            # int sums under go_compat (collect's uint64 mask)
            entry[0] += int(s) if go_compat else float(s)
            entry[1] += int(c)
    if "agg_registry_generation" in data:
        saved_gen = int(data["agg_registry_generation"])
        reg = aggregator.registry
        with reg._lock:
            reg._generation = max(reg._generation, saved_gen)
    return id_remap


def _headroom_exceeded(aggregator, delta_max: int, live_max: int) -> bool:
    """Restored counts never increment ``_interval_ingested``, so the
    live maximum joins the check: successive restores (several workers'
    snapshots) would otherwise stack toward 2^31 unseen."""
    return (
        delta_max + live_max + aggregator.spill_threshold
        + aggregator.batch_size
    ) >= 2 ** 31


def _restore_paged_delta(aggregator, remapped: np.ndarray, row_map,
                         codecs) -> None:
    """Merge a remapped canonical-dense delta into paged storage (caller
    holds ``_dev_lock``): the saved codecs are re-pinned first, through
    the by-name row map, then the nonzero cells commit as (row, bucket -
    bucket_limit, count) triples through ``PagedStore.commit`` (translate,
    one K4 launch), or into the store's exact host spill when the
    headroom check fails.  On a paged mesh (ROADMAP D13) every rank makes
    the same host commit and lands its arena's triples, or spills into
    its block; restored counts do not join ``_interval_ingested``, as on
    one card."""
    pg = aggregator.paged
    if codecs is not None:
        for saved_id, new_id in row_map:
            if saved_id < len(codecs) and codecs[saved_id] is not None:
                pg.set_row_codec(new_id, codecs[saved_id])
    rows, cols = np.nonzero(remapped)
    weights = remapped[rows, cols].astype(np.int64)
    live_max = pg.max_cell()
    if aggregator.mesh is not None:
        import torch.distributed as dist

        from loghisto_tpu_torch.parallel.mesh import mesh_reduce

        # each rank's arena holds its own maximum: the spill-or-commit
        # choice changes every rank's host half, so the ranks agree on
        # the whole pool's maximum first (one MAX over the mesh)
        live_max = mesh_reduce(aggregator.mesh, [live_max],
                               dist.ReduceOp.MAX)[0]
    if _headroom_exceeded(aggregator, int(weights.max(initial=0)),
                          live_max):
        pg.spill_cells(rows.astype(np.int64), cols.astype(np.int64), weights)
    elif len(rows):
        packed = np.empty((len(rows), 3), dtype=np.int32)
        packed[:, 0] = rows
        packed[:, 1] = cols.astype(np.int64) - aggregator.config.bucket_limit
        packed[:, 2] = weights
        pg.commit(packed)
    aggregator.stats_snapshot = None


def _restore_mesh_delta(aggregator, remapped: np.ndarray) -> None:
    """``_restore_dense_delta`` on a mesh rank (caller holds
    ``_dev_lock``): the block's rows of the remapped delta land on stream
    index 0 alone, so the sum over the stream axis counts them once.
    Restored device counts join the rank's ``_interval_ingested``, so
    the partial stays under its share of the int32 envelope
    (``_spill_at``, ROADMAP D8); a delta that would pass it, or fail the
    magnitude check, merges into the rank's host spill."""
    aggregator.stats_snapshot = None
    if not is_stream_lead(aggregator.mesh):
        return
    block = remapped[acc_sharding(aggregator.mesh).index(remapped.shape)]
    total = int(block.sum(dtype=np.int64))
    live_max = int(aggregator._acc.max())
    if (_headroom_exceeded(aggregator, int(block.max(initial=0)), live_max)
            or aggregator._interval_ingested + total
            >= aggregator._spill_at):
        if aggregator._spill is None:
            aggregator._spill = block.astype(np.int64)
        else:
            aggregator._spill += block.astype(np.int64)
        return
    delta = torch.from_numpy(np.ascontiguousarray(block, dtype=np.int32))
    aggregator._acc.add_(delta.to(aggregator._acc.device))
    aggregator._interval_ingested += total


def _restore_dense_delta(aggregator, remapped: np.ndarray) -> None:
    """Merge a remapped canonical-dense delta into a dense aggregator
    (caller holds ``_dev_lock``): in place on the accumulator's device.
    A delta that fails the headroom check (an int64 snapshot taken
    mid-spill, or counts that could wrap int32) merges into the host
    spill instead; ``collect()`` folds spill + accumulator exactly.  As
    in the reference, the check is on magnitude, so a small int64
    snapshot (a paged save) lands on the device.  The live maximum is
    one reduction on the accumulator's device."""
    live_max = int(aggregator._acc.max())
    if _headroom_exceeded(aggregator, int(remapped.max(initial=0)),
                          live_max):
        if aggregator._spill is None:
            aggregator._spill = remapped.astype(np.int64)
        else:
            aggregator._spill += remapped.astype(np.int64)
    else:
        delta = torch.from_numpy(remapped.astype(np.int32, copy=False))
        aggregator._acc.add_(delta.to(aggregator._acc.device))
    aggregator.stats_snapshot = None


def _names_arr(names) -> np.ndarray:
    return np.frombuffer(
        json.dumps(list(names)).encode(), dtype=np.uint8
    ).copy()


def _arr_names(arr: np.ndarray) -> list:
    return json.loads(arr.tobytes().decode())
