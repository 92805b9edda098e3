"""The single-device aggregation engine (counterpart of
``loghisto_tpu/parallel/aggregator.py``: ``TPUAggregator`` as
``TorchAggregator``, and ``IngestStagingRing``).

Samples enter through ``record_batch(ids, values)`` (or ``record``),
buffer on the host and, every ``batch_size`` samples, ``flush`` hands
them to ONE transfer worker thread (a FIFO).  With
``native_staging=True`` they buffer in the native lock-striped staging
buffer (``_native.NativeIngestBuffer``: the writer's C call releases the
GIL, a full shard sheds and counts) instead of Python lists.

``storage`` picks what accumulates them (ops/dispatch.py
``resolve_storage_path``, resolved before the transport as in the
reference): "dense", the int32 [M, B] accumulator, or "paged", the page
pool + page table + per-row codecs of paging.py.  "auto" pages at
2^16 rows and above.  On dense storage the worker takes one of two
routes, updating the accumulator in place:

  * raw: the batch is copied through a ring of pinned host buffers to
    the device (``non_blocking=True``) and each ``batch_size`` chunk is
    one ingest step — K1 (fused) or, for a single-row accumulator, K2
    (row), by default; K8 (multirow) or one of the JAX package's XLA
    paths when ``ingest_path`` names it (ops/dispatch.py);
  * sparse: the batch is folded on the host into packed
    (id, bucket, count) triples (``ops/fold.fold_packed``: the parallel
    native fold, or NumPy without a compiler) and merged by K3;
  * preagg (explicit opt-in): every ``record_batch`` folds into the
    calling thread's shard of a ``_native.ShardedCellStore`` at record
    time; a forced flush (``collect``, ``close``) or a store past
    ``max_host_cells`` ships the drained cells to K3.  The wire carries
    each interval's unique cells once.

On paged storage:

  * raw (``fused_paged``; "auto" on cuda, explicit
    ``ingest_path="fused"`` elsewhere): ``PagedStore.prepare_batch``
    assigns codecs and maps pages on the worker, the batch goes through
    the staging ring, and each chunk is one K4f launch into the pool;
  * sparse (the CPU's "auto" route, and ``transport="sparse"``): the
    host fold, ``PagedStore.commit`` (translate, pad, K4).

``collect()`` on paged storage runs ``PagedStore.stats``
(``sparse_cells_stats``) and names the results as the dense route does.

``transport="auto"`` starts raw and probes the first item of at least
2^16 samples: when its unique-cell density is at or below the crossover
(ops/dispatch.py) it switches to sparse, as the reference does.

``collect()`` is a full barrier, then runs ``ops.stats.dense_stats`` on
the device and names the results ``name_count/_sum/_avg/_<pct>`` and the
lifetime ``name_agg_{avg,count,sum}`` exactly as the reference does
(``go_compat`` included).  Intervals that crossed ``spill_threshold``
fold the accumulator into an exact int64 host spill and take
``dense_stats_np``.  ``on_registry_full="grow"`` doubles the row space
up to ``max_metrics``; growth from one row swaps K2 for K1.

``merge_packed(packed)`` merges int32 ``[n, 3]`` cells already in this
aggregator's row space through the same packed route (the federation
receiver's drain); ``pending_samples`` and ``transport_stats()`` are the
reference's monitoring surface.

``attach(ms)`` subscribes to a host ``MetricSystem``'s raw broadcast:
a bridge thread runs ``merge_raw`` on every interval (K3 on dense
storage, ``PagedStore.commit`` on paged storage, the exact host spill
past the int32 guard).  A failed merge is logged and kept as
``bridge_error``, which ``collect()`` and ``detach()`` re-raise.

With a fused ``IntervalCommitter`` (``commit.py``) the committer, not
this bridge, lands each interval: it folds the cells into ``_acc`` and
publishes ``stats_snapshot``; past the int32 guard it falls back to
``_merge_cells_locked``.

With a span ring installed (``obs_recorder``, by
``TorchMetricSystem(observability=...)``) ``flush`` records
``ingest.flush``, the transfer worker ``ingest.drain`` per item and, on
the raw route, ``ingest.upload`` / ``ingest.dispatch`` per chunk.
``collect()`` runs inside ``utils.trace.maybe_capture("loghisto_collect")``:
a ``torch.profiler`` capture of its flush and statistics when
``LOGHISTO_TRACE_DIR`` is set, a named region otherwise.

Shed, don't block (the reference's rule, with or without resilience):
``flush`` never waits for the card.  While the transfer queue holds
``max_pending_samples`` or more, or the device is inside its retry
cooldown, a non-forced ``flush`` returns and leaves the samples in the
bounded host buffer, where ``_bound_pending_locked`` drops the OLDEST
first (the requeue before the pending lists) and counts them in
``tpu.SamplesShed``.  The default bound is 32 batches: a producer of
small batches that outruns the worker (the paged raw route, whose
worker prepares pages on the host) sheds most of its stream, so raise
``max_pending_samples`` to the backlog the host may hold.  A device failure in the transfer worker (a chunk
that raises, an ``agg.ingest`` fault) arms ``retry_cooldown``, puts the
unapplied rest of the batch back into the requeue buffer
(``_requeue_raw``) and, on the packed routes, lands the cells in the
exact host spill; ``_on_device_failure_locked`` is also the breaker's
single count point.  The port's kernels update the accumulator and the
page pool in place, so a failure consumes neither (``_acc_deleted`` and
``PagedStore.pool_deleted`` read False, where the reference's donated
JAX arrays may be deleted).  An error outside those nets (a malformed
item) is still re-raised by the next ``flush``, ``wait_transfers`` or
``collect``.

With resilience (``TorchMetricSystem(resilience=...)``) the system
installs ``supervisor`` (the bridge runs supervised; a worker killed by
an ``agg.xfer_worker`` fault is respawned by the next enqueue and
counted with ``note_external_restart``), ``device_breaker`` and
``fault_injector`` (the ``agg.ingest`` and ``agg.xfer_worker`` sites).
The mesh (ROADMAP D8, first half of Queue 1 item 11): one process per
device over ``torch.distributed``.  ``make_distributed_step`` (an int32
stream ``all_reduce`` per batch), ``make_sharded_accumulator`` and
``make_interval_distributed_step`` (collective-free folds, one
``all_reduce`` per collect, ``collect.start`` overlapping the next
fold) are the reference's factories rank by rank, and
``TorchAggregator(mesh=)`` runs the raw and sparse transports on each
rank's block of dense storage, with ``collect()`` as the collective
point.  The mesh's fused commit (item 11b-1, ROADMAP D9) adds the rank's
stream row's cells to its block through ``IntervalCommitter``, which on
the fan-out path merges them here (``_merge_cells_locked``, spilling at
the rank's share); the block stays the row's partial, so no accumulator
snapshot is published on a mesh.  The lifecycle and drift carries
(item 11b-2, ROADMAP D10) register with ``_mesh_regrow`` so growth lays
them out anew with the accumulator.  The state on a mesh (item 11b-3,
ROADMAP D11): ``state_dict`` sums the stream partials with their spills
in int64 and gathers the rows over the metric axis, so it returns the
single-device state on every rank; ``load_state_dict`` and a checkpoint
restore put the accumulator's rows on stream index 0 alone.

Paged storage on a mesh (item 11c-1, ROADMAP D12): the store is one
rank's part of the reference's one-controller store (``paging.py``):
the host half (page table, codecs, free stacks) the same on every rank,
the pool the rank's metric shard's arena.  Page maps and codec choices
depend on whole batches, so the transfer worker runs no ingest and no
collective: it stages the rank's stream row's samples on the host
(``MeshStage``), and ``merge_packed`` / ``merge_raw`` stage their cell
batches.  At the next collective entry point (``collect()``, a commit,
a system query, ``stop()``) the ranks land them (``land_staged``): the
ranks of a stream row agree on the prefix of its input to take (a MIN),
cut it into ``batch_size`` batches (folded into cells on the sparse
transport), agree on the batch counts (a MAX), gather each batch k over
the stream axis in stream order (the global batch k, the sparse cells
folded again as the global batch folds), and every rank runs
``prepare_batch`` / ``translate`` on it and K4f or K4 on its own
arena.  ``collect()`` then computes the statistics of the rank's
block from its arena and its block's host spill, and one gather over the
metric axis gives every rank the set; paged storage needs no stream
``all_reduce``.  On a paged mesh (ROADMAP D13) ``state_dict`` is the
store's state gathered over the metric axis, the arenas summed over
nothing (each is the same on every rank of its metric column), and the
lifecycle's eviction and compaction land the stage first.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime as _dt
import logging
import threading
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from loghisto_tpu_torch.channel import Channel, ChannelClosed
from loghisto_tpu_torch.config import (
    DEFAULT_PERCENTILES,
    PRECISION,
    MetricConfig,
)
from loghisto_tpu_torch.metrics import (
    _UINT64_MASK,
    ProcessedMetricSet,
    RawMetricSet,
)
from loghisto_tpu_torch.obs.spans import NULL_RECORDER
from loghisto_tpu_torch.ops import dispatch
from loghisto_tpu_torch.ops.backend import kernel_launches, resolve_device
from loghisto_tpu_torch.ops.fold import compress_np_host, fold_packed
from loghisto_tpu_torch.ops.multirow_ingest import multirow_step
from loghisto_tpu_torch.ops.sparse_ingest import sparse_ingest
from loghisto_tpu_torch.ops.stats import dense_stats, dense_stats_np
from loghisto_tpu_torch.paging import PagedStore, PagedStoreConfig
from loghisto_tpu_torch.parallel.mesh import (
    METRIC_AXIS,
    STREAM_AXIS,
    acc_sharding,
    axis_group,
    axis_index,
    axis_size,
    block_ids,
    block_rows,
    check_mesh,
    collective_device,
    gather_parts,
    host_gather,
    is_stream_lead,
    mesh_device,
    mesh_reduce,
    reduce_parts,
)
from loghisto_tpu_torch.registry import MetricRegistry, RegistryFullError
from loghisto_tpu_torch.resilience.supervise import spawn_thread
from loghisto_tpu_torch.utils.trace import maybe_capture

logger = logging.getLogger("loghisto_tpu_torch")

DEFAULT_GROWTH_FACTOR = 8

# Minimum raw-item size the transport="auto" density probe runs on.
_PROBE_SAMPLES = 1 << 16


def _step_for(path: str):
    """The uniform per-chunk step of a resolved dense ingest path."""
    if path == "multirow":
        return multirow_step
    return dispatch.ingest_step_fn(path)


STATE_FORMAT = "loghisto_tpu_torch.aggregator/1"

class IngestStagingRing:
    """Depth-K reusable host staging slots for the raw route.

    ``stage()`` copies a chunk into the next slot (pinned memory when
    the device is a card) and issues its host->device copy with
    ``non_blocking=True``, recording an event behind it.  Before a slot
    is reused (depth stages later) its event is synchronized: the copy
    has then finished reading the host buffer, so overwriting it cannot
    corrupt an in-flight transfer."""

    def __init__(self, slot_samples: int, device: torch.device,
                 depth: int = 3):
        if depth < 2:
            raise ValueError(f"ring depth must be >= 2, got {depth}")
        if slot_samples < 1:
            raise ValueError(f"slot_samples must be >= 1, got {slot_samples}")
        self.slot_samples = int(slot_samples)
        self.device = device
        self.depth = int(depth)
        pin = device.type == "cuda"
        self._ids = [
            torch.empty(self.slot_samples, dtype=torch.int32, pin_memory=pin)
            for _ in range(depth)
        ]
        self._values = [
            torch.empty(self.slot_samples, dtype=torch.float32,
                        pin_memory=pin)
            for _ in range(depth)
        ]
        self._events: list = [None] * depth
        self._next = 0
        self.uploads = 0
        self.bytes_uploaded = 0

    def stage(self, ids: np.ndarray, values: np.ndarray):
        """Copy one chunk (<= slot_samples) into the next slot and start
        its upload; returns the (ids, values) device tensors."""
        n = len(ids)
        if n > self.slot_samples:
            raise ValueError(f"chunk of {n} exceeds slot {self.slot_samples}")
        i = self._next
        self._next = (i + 1) % self.depth
        if self._events[i] is not None:
            self._events[i].synchronize()
            self._events[i] = None
        host_ids, host_values = self._ids[i][:n], self._values[i][:n]
        host_ids.numpy()[:] = ids
        host_values.numpy()[:] = values
        self.uploads += 1
        self.bytes_uploaded += n * (host_ids.element_size()
                                    + host_values.element_size())
        if self.device.type == "cuda":
            ids_dev = host_ids.to(self.device, non_blocking=True)
            values_dev = host_values.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            self._events[i] = event
        else:
            # the CPU "upload" is a copy: the slot is reused while the
            # caller may still hold the tensors
            ids_dev, values_dev = host_ids.clone(), host_values.clone()
        return ids_dev, values_dev

    def drain(self) -> None:
        """Wait for every in-flight upload, then release the slots."""
        for i, event in enumerate(self._events):
            if event is not None:
                event.synchronize()
                self._events[i] = None


# -- the mesh steps (ROADMAP D8: one process per device) ------------------- #


def _mesh_block(mesh, num_metrics: int) -> tuple[int, int]:
    """Check the mesh and the row split: (first row, rows) of this
    rank's block."""
    check_mesh(mesh)
    n_metric = axis_size(mesh, METRIC_AXIS)
    if num_metrics % n_metric:
        raise ValueError(
            f"num_metrics={num_metrics} not divisible by metric axis "
            f"size {n_metric}"
        )
    return block_rows(mesh, num_metrics)


def _mesh_plan(mesh, num_metrics: int, ingest_path: str, batch_size,
               num_buckets: int):
    """The block and the resolved per-rank path: (device, first row,
    rows, stream group, path)."""
    lo, rows = _mesh_block(mesh, num_metrics)
    path = dispatch.resolve_ingest_path(
        ingest_path, num_metrics, batch_size, num_buckets, mesh=mesh)
    return mesh_device(mesh), lo, rows, axis_group(mesh, STREAM_AXIS), path


def local_histogram_fold(
    acc_local: torch.Tensor,
    ids: torch.Tensor,
    values: torch.Tensor,
    rows_per_shard: int,
    bucket_limit: int,
    precision: int = PRECISION,
    ingest_path: str = "fused",
    *,
    mesh,
) -> torch.Tensor:
    """The sharded-ingest core of the per-batch step: shift ids into this
    rank's block (ids outside it become -1, which every step drops),
    bucket the stream row's samples into a fresh local histogram with
    the resolved step (``ingest_path`` is concrete: K1, K2b for a
    one-row block, or a named XLA path), ``all_reduce`` it in int32 over
    the stream axis and fold it into ``acc_local`` in place.  A
    collective: every rank of the mesh calls it."""
    import torch.distributed as dist

    lo = axis_index(mesh, METRIC_AXIS) * rows_per_shard
    hist = torch.zeros_like(acc_local)
    _step_for(ingest_path)(hist, block_ids(ids, lo, rows_per_shard), values,
                           bucket_limit, precision)
    dist.all_reduce(hist, group=axis_group(mesh, STREAM_AXIS))
    acc_local += hist
    return acc_local


def make_distributed_step(
    mesh,
    num_metrics: int,
    bucket_limit: int,
    percentile_values,
    precision: int = PRECISION,
    ingest_path: str = "auto",
    batch_size: Optional[int] = None,
):
    """The full per-batch aggregation step over a ("stream", "metric")
    mesh, run by every rank.

    Returns f(acc, ids, values) -> (acc, stats) where
      acc    int32 [num_metrics / n_metric, B], this rank's block
             (``make_sharded_accumulator``), updated in place
      ids    int32 [N], this rank's stream row's samples
      values float32 [N]
      stats  ``dense_stats`` of the block: counts [rows], sums [rows],
             percentiles [rows, P] (the reference's metric-sharded stats,
             this rank's part)

    Per rank: bucket the stream row's samples into a local histogram
    (ids outside the block drop), ``all_reduce`` it over the stream axis,
    fold it into the block, then the block's statistics.  "auto" resolves
    on the block's rows (ROADMAP D8): K2b for one row, K1 otherwise."""
    dev, _, rows, _, path = _mesh_plan(
        mesh, num_metrics, ingest_path, batch_size, 2 * bucket_limit + 1)
    ps = np.asarray(percentile_values, dtype=np.float32)

    def step(acc, ids, values):
        acc = local_histogram_fold(
            acc, torch.as_tensor(ids, device=dev),
            torch.as_tensor(values, device=dev), rows, bucket_limit,
            precision, ingest_path=path, mesh=mesh)
        return acc, dense_stats(acc, ps, bucket_limit, precision)

    step.ingest_path = path
    return step


def make_sharded_accumulator(mesh, num_metrics: int,
                             num_buckets: int) -> torch.Tensor:
    """This rank's zero block of the metric-sharded accumulator
    (``mesh.acc_sharding``: rows ``[m * M / n_metric, (m + 1) * M /
    n_metric)``), on its device.  Placing zeros takes no collective."""
    _, rows = _mesh_block(mesh, num_metrics)
    return torch.zeros((rows, num_buckets), dtype=torch.int32,
                       device=acc_sharding(mesh).device)


class PendingCollect:
    """An interval collect in flight (``collect.start``): the stream
    ``all_reduce`` of the partial runs while the caller folds the next
    batch into a fresh partial; ``wait()`` completes it, folds the
    reduced partial into the block and returns ``(acc, stats)``."""

    def __init__(self, work, acc, partial, finish):
        self._work, self._acc, self._partial = work, acc, partial
        self._finish = finish

    def wait(self):
        self._work.wait()
        self._acc += self._partial
        return self._acc, self._finish(self._acc)


def make_interval_distributed_step(
    mesh,
    num_metrics: int,
    bucket_limit: int,
    percentile_values,
    precision: int = PRECISION,
    ingest_path: str = "auto",
    batch_size: Optional[int] = None,
):
    """Interval-amortized distributed aggregation: each rank folds
    batches into its own (stream, metric) partial block with ZERO
    collectives, and the stream-axis ``all_reduce`` runs once per
    ``collect``.

    Returns (ingest, collect, make_partial):

      make_partial() -> int32 [num_metrics / n_metric, B]: this rank's
          zero partial block (the reference's [1, rows, B] device block).
      ingest(partial, ids, values) -> partial
          Collective-free fold of this rank's stream row's samples, in
          place.
      collect(acc, partial) -> (acc, fresh_partial, stats)
          One int32 ``all_reduce`` over the stream axis, folded into the
          block, statistics on the merged rows, and a fresh zero
          partial.  ``collect.start(acc, partial)`` starts the reduction
          with ``async_op=True`` and returns a ``PendingCollect``: fold
          the next batch into a fresh ``make_partial()`` while it is in
          flight, then ``.wait() -> (acc, stats)`` (the counterpart of
          the reference's r13 overlap; JAX hands back futures, PyTorch a
          work handle).

    Overflow contract: the partials and the block are int32 and the
    worst case puts every sample in one cell, so callers collect before
    an interval ingests 2^31 samples over all stream rows.
    ``TorchAggregator`` enforces it with its host int64 spill; step
    callers own the bound, as ``run_firehose`` does."""
    import torch.distributed as dist

    dev, lo, rows, stream_group, path = _mesh_plan(
        mesh, num_metrics, ingest_path, batch_size, 2 * bucket_limit + 1)
    ps = np.asarray(percentile_values, dtype=np.float32)
    fold = _step_for(path)

    def make_partial() -> torch.Tensor:
        return torch.zeros((rows, 2 * bucket_limit + 1), dtype=torch.int32,
                           device=dev)

    def ingest(partial, ids, values):
        ids = torch.as_tensor(ids, device=dev)
        fold(partial, block_ids(ids, lo, rows),
             torch.as_tensor(values, device=dev), bucket_limit, precision)
        return partial

    def stats(acc):
        return dense_stats(acc, ps, bucket_limit, precision)

    def collect_start(acc, partial) -> PendingCollect:
        work = dist.all_reduce(partial, group=stream_group, async_op=True)
        return PendingCollect(work, acc, partial, stats)

    def collect(acc, partial):
        acc, st = collect_start(acc, partial).wait()
        return acc, make_partial(), st

    collect.start = collect_start
    ingest.ingest_path = path
    return ingest, collect, make_partial


class MeshStage:
    """ROADMAP D12's host stage of one mesh rank on paged storage: the
    rank's stream row's input between two collective entry points.

    The transfer worker adds the row's samples in its FIFO order
    (``add_samples``); ``merge_packed`` / ``merge_raw`` add cell batches
    (``add_cells``).  ``take(n, c)`` removes the first ``n`` samples,
    cut into batches of ``batch_size`` (folded into cells with ``fold``,
    the sparse transport), and the first ``c`` cell batches: a prefix of
    the row's input, so the ranks of a stream row, which agree on ``n``
    and ``c`` first, cut the same batches however their flushes fell.
    Samples are int32 ``[n, 2]`` (id, float32 value bits), cells int64
    ``[n, 3]`` (id, codec bucket, count).  Nothing here is shed: the
    stage holds what the rank recorded until an entry point lands it
    (the aggregator's ``max_staged_samples`` bounds it by refusing new
    batches instead)."""

    def __init__(self, batch_size: int, fold=None):
        self.batch_size = int(batch_size)
        self._fold = fold
        self._lock = threading.Lock()
        self._ids: list = []
        self._values: list = []
        self._n = 0
        self._cells: list = []
        self._cell_counts = 0  # the staged cells' counts summed

    @property
    def staged_samples(self) -> int:
        """Samples and cells' counts held (a racy read)."""
        return self._n + self._cell_counts

    def counts(self) -> tuple:
        """(staged samples, staged cell batches)."""
        with self._lock:
            return self._n, len(self._cells)

    def add_samples(self, ids: np.ndarray, values: np.ndarray) -> None:
        with self._lock:
            self._ids.append(ids)
            self._values.append(values)
            self._n += len(ids)

    def add_cells(self, cells: np.ndarray) -> None:
        cells = np.asarray(cells, dtype=np.int64).reshape(-1, 3)
        with self._lock:
            self._cells.append(cells)
            self._cell_counts += int(cells[:, 2].sum())

    def take(self, n: int, c: int):
        """(sample batches, cell batches): the first ``n`` samples in
        batches of ``batch_size`` and the first ``c`` cell batches, which
        leave the stage."""
        with self._lock:
            ids = (np.concatenate(self._ids) if self._ids
                   else np.empty(0, np.int32))
            values = (np.concatenate(self._values) if self._values
                      else np.empty(0, np.float32))
            self._ids, self._values = [ids[n:]], [values[n:]]
            self._n -= n
            cells, self._cells = self._cells[:c], self._cells[c:]
            self._cell_counts -= sum(int(x[:, 2].sum()) for x in cells)
        batches = []
        for off in range(0, n, self.batch_size):
            i = ids[off:min(off + self.batch_size, n)]
            v = values[off:min(off + self.batch_size, n)]
            if self._fold is None:
                batch = np.empty((len(i), 2), dtype=np.int32)
                batch[:, 0] = i
                batch[:, 1] = v.astype(np.float32).view(np.int32)
            else:
                batch = self._fold(i, v).astype(np.int64)
            batches.append(batch)
        return batches, cells


def refold_cells(cells: np.ndarray) -> np.ndarray:
    """int64 ``[n, 3]`` (id, codec bucket, count) cells with the counts of
    each (id, bucket) summed, one row a cell in key order: the cells a
    fold of the stream rows' samples together gives."""
    if not len(cells):
        return cells
    keys = (cells[:, 0] << 20) | (cells[:, 1] + (1 << 19))
    ukeys, inv = np.unique(keys, return_inverse=True)
    counts = np.zeros(len(ukeys), dtype=np.int64)
    np.add.at(counts, inv.reshape(-1), cells[:, 2])
    return np.stack([ukeys >> 20, (ukeys & ((1 << 20) - 1)) - (1 << 19),
                     counts], axis=1)


class TorchAggregator:
    """Device-tier metric engine of the port: record_batch -> transfer
    worker -> K1/K2/K3 into the int32 [M, B] accumulator, or K4f/K4 into
    the paged pool -> collect()."""

    def __init__(
        self,
        num_metrics: int = 1024,
        config: MetricConfig = MetricConfig(),
        percentiles: Mapping[str, float] = DEFAULT_PERCENTILES,
        registry: Optional[MetricRegistry] = None,
        batch_size: int = 1 << 16,
        ingest_path: str = "auto",
        on_registry_full: str = "grow",
        max_metrics: Optional[int] = None,
        spill_threshold: int = 1 << 30,
        transport: str = "auto",
        storage: str = "auto",
        paged_config: Optional[PagedStoreConfig] = None,
        device=None,
        native_staging: bool = False,
        mesh=None,
    ):
        """``device`` defaults to the card and raises when CUDA is
        absent; ``device="cpu"`` runs the plain versions.  The other
        arguments mean what they mean for ``TPUAggregator``;
        ``storage`` is "auto", "dense" or "paged", and ``paged_config`` a
        ``paging.PagedStoreConfig``.

        ``ingest_path`` is "auto" or one of ``dispatch.INGEST_PATHS``:
        "fused" (K1), "row" or its JAX name "pallas" (K2b, one row),
        "multirow" (preprocess + K8; M % 8 == 0, dense storage), or one
        of the JAX package's XLA paths, "scatter", "sort", "sortscan",
        "matmul", "hybrid".  Those have no Pallas kernel in the JAX
        package, so their PyTorch form runs on the card as well: it is
        the reference's path, not a fallback.  An explicit path checks
        its shape before the accumulator is allocated, with the JAX
        package's sentences.

        ``transport`` is "auto", "raw", "sparse" or "preagg" (an explicit
        opt-in: its record-time fold trades the writers' CPU for flush
        latency, which no flush-side probe can see).  ``native_staging``
        stages raw samples in the native buffer; without a compiler it
        logs the build error and stages in Python, and with preagg the
        buffer is unused (samples fold at record time).

        ``mesh`` (a ("stream", "metric") mesh from ``parallel.mesh.
        make_mesh``; ROADMAP D8) makes this aggregator one rank's part:
        it holds the rows ``[m * M / n_metric, (m + 1) * M / n_metric)``
        of the accumulator on the mesh's device, and every rank of
        stream row s receives that row's samples (``record_batch``,
        ``merge_raw``, ``merge_packed``) and keeps its block.  The
        transfer worker runs no collective; ``collect()`` is the
        collective point: every rank calls it, in the same order, and
        every rank returns the global set.  The registries must be
        identical on every rank (intern names in the same order), as
        the reference's multihost design requires.  Each rank spills at
        ``spill_threshold / n_stream``, so the reduced interval stays
        under the int32 bound.  Growth moves rows between ranks, so it
        happens at the collective point: the registry grows at once, the
        new rows' samples and cells wait on the host, and ``collect()``
        lays the blocks out anew before its statistics
        (``_mesh_regrow``).  On paged storage (ROADMAP D12) the rank's
        store holds its metric shard's arena and every rank the whole
        host half; the worker stages the row's samples and cells
        (``MeshStage``) and ``collect()`` lands them first, each global
        batch translated on every rank; the ``spill_threshold`` holds
        for the whole interval, which every rank counts alike.
        Lifecycle, checkpoints and ``state_dict`` on a paged mesh follow
        ROADMAP D13."""
        if mesh is not None and device is None:
            device = mesh.device_type  # a rank aggregates on its mesh device
        self.device = resolve_device(device)
        self.config = config
        self.num_metrics = num_metrics
        self.registry = (
            registry if registry is not None
            else MetricRegistry(capacity=num_metrics)
        )
        if self.registry.capacity > num_metrics:
            raise ValueError(
                f"registry capacity {self.registry.capacity} exceeds "
                f"num_metrics {num_metrics}: names beyond the accumulator "
                "rows could never be aggregated"
            )
        for label in percentiles:
            try:
                if not isinstance(label % "name", str):
                    raise TypeError("renders to non-string")
            except (TypeError, ValueError) as e:
                raise ValueError(
                    f"percentile label {label!r} is not a valid %-format "
                    f"template for a metric name: {e}"
                ) from None
        self.percentiles = dict(percentiles)
        self.batch_size = batch_size
        if on_registry_full not in ("grow", "error"):
            raise ValueError(
                f"on_registry_full={on_registry_full!r}: expected 'grow' "
                "or 'error'"
            )
        self.on_registry_full = on_registry_full
        self.max_metrics = (
            int(max_metrics) if max_metrics is not None
            else num_metrics * DEFAULT_GROWTH_FACTOR
        )
        if self.max_metrics < num_metrics:
            raise ValueError(
                f"max_metrics {self.max_metrics} < num_metrics {num_metrics}"
            )
        if not 0 < spill_threshold <= 1 << 30:
            raise ValueError(
                "spill_threshold must be in (0, 2^30]: the overflow "
                "guarantee needs threshold + one ingest chunk < 2^31"
            )
        if spill_threshold + batch_size >= 1 << 31:
            raise ValueError(
                f"spill_threshold {spill_threshold} + batch_size "
                f"{batch_size} >= 2^31: a single chunk between spill "
                "checks could wrap an int32 cell"
            )
        self.spill_threshold = int(spill_threshold)
        self.mesh = mesh
        self._n_stream = self._n_metric = 1
        self._metric_index = 0
        if mesh is not None:
            self._check_mesh(mesh, ingest_path)
        if transport not in ("auto", "raw", "preagg", "sparse"):
            raise ValueError(
                f"transport={transport!r}: expected 'auto', 'raw', "
                "'preagg', or 'sparse'"
            )
        # the dense path resolves before any allocation, against the
        # growth cap, as the JAX aggregator checks an explicit path
        # (unknown names raise here too); paged storage replaces it below
        dense_path = dispatch.resolve_ingest_path(
            ingest_path, num_metrics, batch_size, config.num_buckets,
            guard_metrics=self.max_metrics, mesh=mesh,
        )
        # storage first: it pins the transport (paged with K4f ingests
        # raw, paged without it rides the host fold)
        platform = self.device.type
        self.fused_paged_reason = dispatch.fused_paged_incapability(
            num_metrics, config.num_buckets, batch_size=batch_size,
            transport=transport, platform=platform,
            crossover=(ingest_path == "auto"), mesh=mesh,
        )
        fused_paged_ok = (
            self.fused_paged_reason is None
            and ingest_path in ("auto", "fused")
        )
        self.storage, self.storage_reason = dispatch.resolve_storage_path(
            storage, num_metrics, config.num_buckets, platform,
            transport=transport, fused_ok=fused_paged_ok, mesh=mesh,
        )
        self.fused_paged = self.storage == "paged" and fused_paged_ok
        if self.storage == "paged":
            transport = "raw" if self.fused_paged else "sparse"
        # "auto" probes only where some density can switch it: on the card
        # the measured crossover is 0.0 (raw always), so it stays raw
        # without paying the host probe
        self._transport_auto = (
            transport == "auto"
            and dispatch.sparse_density_crossover(self.device.type) > 0.0
        )
        self.transport = "raw" if transport == "auto" else transport
        self.probe_density: Optional[float] = None
        self.kernel_tier = dispatch.kernel_tier(self.device.type)
        self.paged_config = paged_config or PagedStoreConfig()
        self.paged: Optional[PagedStore] = None
        if self.storage == "paged":
            if ingest_path == "row":
                raise ValueError(
                    "ingest_path='row' needs the dense single-row "
                    "accumulator; paged storage keeps none"
                )
            if ingest_path == "multirow":
                raise ValueError(
                    "ingest_path='multirow' needs the dense accumulator; "
                    "paged storage keeps none (every paged commit rides "
                    "the packed sparse-triple scatter)"
                )
            if ingest_path == "fused" and not self.fused_paged:
                raise ValueError(
                    "ingest_path='fused' with paged storage needs the "
                    f"direct-to-paged fused kernel: {self.fused_paged_reason}"
                )
            # the pool + page table ARE the accumulator
            self.ingest_path = "fused_paged" if self.fused_paged else "packed"
            self._ingest = None
        else:
            self.ingest_path = dense_path
            self._ingest = _step_for(self.ingest_path)

        # Two locks, never nested: _lock guards host staging, _dev_lock
        # the device state (_acc, _spill, _interval_ingested, growth).
        self._lock = threading.Lock()
        self._dev_lock = threading.Lock()
        self._pending_ids: list = []
        self._pending_values: list = []
        self._pending_count = 0
        # the worker's re-buffer for batches a device failure (or the
        # retry cooldown) bounced back: appended in order by the single
        # FIFO worker, so all of it is OLDER than _pending_* (flush drains
        # it first, and the oldest-first shed stays honest); under _lock
        self._requeue_ids: list = []
        self._requeue_values: list = []
        self._requeue_count = 0
        # the host buffer's bound while the device is slow or down
        self.max_pending_samples = 32 * batch_size
        # D12: what a paged mesh rank holds on the host for its next
        # collective entry point; record_batch refuses a batch past it
        self.max_staged_samples = 256 * batch_size
        self.retry_cooldown = 1.0  # seconds between device retries
        self._device_down_until = 0.0
        # samples accepted by the native buffer since its last drain
        # (under _lock); the auto-flush counts them
        self._native_staged = 0
        self._native_buf = None
        # samples dropped by the host buffer's bound and those the
        # preagg store could not take; written from the staging side and
        # the worker, under _shed_lock
        self._shed_samples = 0
        self._shed_lock = threading.Lock()
        # resilience, installed by TorchMetricSystem(resilience=...): the
        # supervisor ledgers bridge and worker restarts, the breaker
        # counts device failures (one count point:
        # _on_device_failure_locked), the injector scripts faults (None:
        # one attribute test a site)
        self.supervisor = None
        self.device_breaker = None
        self.fault_injector = None
        # wire accounting of the packed routes (transport_stats); the
        # staging ring counts the raw route's uploads
        self._xfer_uploads = 0
        self._xfer_bytes = 0
        self._xfer_samples_shipped = 0
        # ship cells mid-interval once the host store holds this many
        # (bounds host memory at ~16 B a cell)
        self.max_host_cells = 1 << 22
        self._cell_store = None
        if self.transport == "preagg":
            from loghisto_tpu_torch import _native

            # one shard per writer thread, double-buffered; "auto" takes
            # the NumPy store when no compiler built the library
            self._cell_store = _native.ShardedCellStore(
                config.bucket_limit, config.precision, backend="auto")
            if native_staging:
                logger.info(
                    "preagg transport folds samples into the cell store at "
                    "record time; the native staging buffer is unused")
        elif native_staging:
            from loghisto_tpu_torch import _native

            if _native.available():
                # 16 shards of 4 batches each (12 B a sample)
                self._native_buf = _native.NativeIngestBuffer(
                    num_shards=16,
                    capacity_per_shard=max(batch_size * 4, 1 << 16),
                )
            else:
                logger.warning(
                    "native staging requested but unavailable (%s); using "
                    "Python staging", _native.build_error())

        self._xfer_cv = threading.Condition()
        self._xfer_queue: collections.deque = collections.deque()
        self._xfer_queued_samples = 0
        self._xfer_active = False
        self._xfer_thread: Optional[threading.Thread] = None
        self._xfer_stop = False
        self._xfer_error: Optional[BaseException] = None
        self._staging_ring: Optional[IngestStagingRing] = None
        self.staging_depth = 3
        # ingest.* spans; TorchMetricSystem(observability=...) installs a
        # real ring
        self.obs_recorder = NULL_RECORDER

        # D12's host stage of a mesh rank on paged storage
        self._stage: Optional[MeshStage] = None
        if self.storage == "paged":
            self.paged = PagedStore(
                num_metrics, config.bucket_limit, config.precision,
                config=self.paged_config, device=self.device, mesh=mesh,
            )
            self._acc = None
            if mesh is not None:
                self._stage = MeshStage(
                    batch_size, None if self.fused_paged else (
                        lambda i, v: fold_packed(i, v, config.bucket_limit,
                                                 config.precision)))
        else:
            self._acc = torch.zeros(
                (self._rows, config.num_buckets), dtype=torch.int32,
                device=self.device,
            )
        self._spill: Optional[np.ndarray] = None
        # a mesh rank's samples and cells of rows the registry grew but
        # the blocks do not hold yet: folded in by _mesh_regrow (under
        # _dev_lock)
        self._late_raw: list = []
        self._late_cells: list = []
        # a mesh rank's other row-block carries (the lifecycle's activity
        # block, the drift engine's banks): each a callable that
        # _mesh_regrow hands its ``regrown``, in registration order
        self._mesh_carries: list = []
        self._interval_ingested = 0
        self._spilled_samples = 0
        self._registry_shed_samples = 0
        # the fused committer's handle over the live accumulator
        # (window/snapshot.AccSnapshot); None whenever the accumulator
        # was reset, grown, spilled or replaced — None means "recompute"
        self.stats_snapshot = None

        self._agg_lock = threading.Lock()
        self._agg: Dict[int, list] = {}

        # host-tier bridge (attach): (ms, thread, stop event) while attached
        self._attached: Optional[tuple] = None
        self._bridge_lock = threading.Lock()
        self._bridge_ch: Optional[Channel] = None
        self.bridge_evictions = 0
        self.bridge_error: Optional[BaseException] = None
        self._last_aggregation_us = 0.0

    def _check_mesh(self, mesh, ingest_path) -> None:
        """The mesh's refusals, before anything is allocated; sets the
        rank's coordinates and its device."""
        check_mesh(mesh)
        n_metric = axis_size(mesh, METRIC_AXIS)
        if self.num_metrics % n_metric:
            raise ValueError(
                f"num_metrics={self.num_metrics} not divisible by the mesh "
                f"metric axis ({n_metric})"
            )
        if self.device.type != mesh.device_type:
            raise ValueError(
                f"device={device!r} but the mesh's devices are "
                f"{mesh.device_type!r}: a rank aggregates on its mesh device"
            )
        self.device = mesh_device(mesh)
        if ingest_path == "multirow":
            raise ValueError(
                "ingest_path='multirow' is single-device (its dense "
                "layout is lane-padded); use scatter with a mesh"
            )
        self._n_stream = axis_size(mesh, STREAM_AXIS)
        self._n_metric = n_metric
        self._metric_index = axis_index(mesh, METRIC_AXIS)

    @property
    def _rows(self) -> int:
        """Rows of this rank's block (all of them without a mesh)."""
        return self.num_metrics // self._n_metric

    @property
    def _row0(self) -> int:
        """The block's first row."""
        return self._metric_index * self._rows

    @property
    def _spill_at(self) -> int:
        """This rank's spill point: the stream ``all_reduce`` sums
        ``n_stream`` partials, so each stays under its share of
        ``spill_threshold``.  Paged storage keeps no partials (every rank
        lands the global batches, D12): the whole threshold."""
        if self.paged is not None:
            return self.spill_threshold
        return max(1, self.spill_threshold // self._n_stream)

    @property
    def staged_samples(self) -> int:
        """Samples (and cells' counts) a mesh rank on paged storage holds
        on the host for the next collective entry point (D12); 0
        elsewhere."""
        return 0 if self._stage is None else self._stage.staged_samples

    @property
    def kernel_launches(self) -> dict:
        """Launch count of every Hopper kernel (process-wide counters,
        ops/backend.py; they stay 0 on the CPU, where no kernel runs)."""
        return kernel_launches()

    # -- direct ingestion ---------------------------------------------- #

    def record(self, name: str, value: float) -> None:
        self.record_batch(
            np.array([self._id_for(name)], dtype=np.int32),
            np.array([value], dtype=np.float32),
        )

    def _id_for(self, name: str, samples: int = 1) -> int:
        """Row id for a name under the on_registry_full policy: grow the
        row space up to max_metrics, then shed (-1 drops) with a count."""
        try:
            return self.registry.id_for(name)
        except RegistryFullError:
            if self.on_registry_full == "error":
                raise
        with self._dev_lock:
            try:
                return self.registry.id_for(name)  # a racer may have grown
            except RegistryFullError:
                pass
            if self._grow_locked():
                return self.registry.id_for(name)
            if self._registry_shed_samples == 0:
                logger.warning(
                    "metric registry exhausted at max_metrics=%d; samples "
                    "for further new names are shed", self.max_metrics,
                )
            self._registry_shed_samples += samples
            return -1

    def _grow_row_unit(self) -> int:
        """Row-count granularity growth must keep: the mesh's metric axis
        (every block the same rows), the multirow step's row tile (K1
        serves any row count)."""
        if self.mesh is not None:
            return self._n_metric
        if self.ingest_path == "multirow":
            return dispatch.MULTIROW_ROWS_TILE
        return 1

    def _grow_locked(self, target: Optional[int] = None) -> bool:
        """Grow the row space in place (caller holds _dev_lock): zero rows
        are appended to the accumulator and the spill, and a row kernel
        that no longer fits is swapped for the fused kernel.  The new row
        count rounds down to ``_grow_row_unit``.  On a mesh only the
        registry grows here; the blocks follow at the next collect
        (``_mesh_regrow``)."""
        old_m = self.registry.capacity if self.mesh else self.num_metrics
        new_m = min(
            target if target is not None else old_m * 2, self.max_metrics
        )
        new_m -= new_m % self._grow_row_unit()  # the clamp may land off-grid
        if new_m <= old_m:
            return False
        if self.mesh is not None:
            self.registry.grow(new_m)
            return True
        if self.paged is not None:
            # a host page-table extension: no device data moves
            self.paged.grow(new_m)
            self.num_metrics = new_m
            self.stats_snapshot = None
            self.registry.grow(new_m)
            return True
        path = self.ingest_path
        if dispatch.ingest_incapability(path, new_m, self.batch_size,
                                        self._acc.shape[1]):
            path = dispatch.resolve_ingest_path(
                "auto", new_m, self.batch_size
            )
        grown = torch.zeros(
            (new_m, self._acc.shape[1]), dtype=torch.int32,
            device=self.device,
        )
        grown[:old_m] = self._acc
        self._acc = grown
        self.ingest_path, self._ingest = path, _step_for(path)
        self.num_metrics = new_m
        self.stats_snapshot = None  # row space changed; handle is stale
        self.registry.grow(new_m)
        if self._spill is not None:
            spill = np.zeros((new_m, self._spill.shape[1]), dtype=np.int64)
            spill[:old_m] = self._spill
            self._spill = spill
        return True

    def _spill_fold_locked(self) -> None:
        """Fold the accumulator into the host int64 spill and zero it,
        without closing the interval (caller holds _dev_lock).  Paged
        storage folds its pool into the store's exact host spill."""
        if self.paged is not None:
            self.paged.spill_pool()
            self._spilled_samples += self._interval_ingested
            self._interval_ingested = 0
            self.stats_snapshot = None
            return
        acc_np = self._acc.cpu().numpy().astype(np.int64)
        if self._spill is None:
            self._spill = acc_np
        else:
            self._spill += acc_np
        self._acc.zero_()
        self._spilled_samples += self._interval_ingested
        self._interval_ingested = 0
        self.stats_snapshot = None  # acc folded out; handle is stale

    def record_batch(self, ids: np.ndarray, values: np.ndarray) -> None:
        """Buffer a batch of (metric_id, value) samples; flushes when the
        buffered count reaches batch_size.  On preagg the batch folds
        into the cell store here instead."""
        ids = np.asarray(ids, dtype=np.int32)
        values = np.asarray(values, dtype=np.float32)
        if ids.shape != values.shape:
            raise ValueError("ids and values must have the same shape")
        if self._stage is not None:
            self._refuse_past_stage_cap(len(ids))
        if self._cell_store is not None:
            self._preagg_record(ids, values)
            return
        if self._native_buf is not None:
            accepted = self._native_buf.record_batch(
                ids, values.astype(np.float64))
            # counted under the lock: a racy += could lose a flush
            with self._lock:
                self._native_staged += accepted
                should_flush = self._native_staged >= self.batch_size
            if should_flush:
                self.flush()
            return
        with self._lock:
            self._pending_ids.append(ids)
            self._pending_values.append(values)
            self._pending_count += len(ids)
            # bounded while the device is down or slow (flush is gated)
            self._bound_pending_locked()
            should_flush = self._pending_count >= self.batch_size
        if should_flush:
            self.flush()

    def _refuse_past_stage_cap(self, n: int) -> None:
        """D12's bound on a paged mesh rank: the stage, the host buffer
        and the transfer queue together hold at most
        ``max_staged_samples`` samples (cells count their counts), so a
        batch that would pass it raises, whole and untaken, until a
        collective entry point (``collect()``, a commit, a query) lands
        the stage.  Nothing staged is ever shed."""
        held = (self._stage.staged_samples + self.pending_samples
                + self._xfer_queued_samples)
        if held + n > self.max_staged_samples:
            raise RuntimeError(
                f"paged mesh rank stage full: {held} samples held on the "
                f"host for the next collective entry point, {n} more "
                f"would pass max_staged_samples="
                f"{self.max_staged_samples}; call collect() (or commit, "
                "or query) on every rank to land them"
            )

    @property
    def pending_samples(self) -> int:
        """Samples buffered on the host awaiting a device attempt, the
        requeued and the fresh (a racy read: exact whenever the worker
        is idle); the watchdog compares it with
        ``max_pending_samples``."""
        return self._requeue_count + self._pending_count

    def _bound_pending_locked(self) -> None:
        """Hold the whole host buffer (requeue + pending) to
        ``max_pending_samples`` by shedding the OLDEST samples: the
        requeue first (strictly older, one FIFO worker), a partial array
        sliced so no more than the overflow goes.  Caller holds
        _lock."""
        overflow = (self._requeue_count + self._pending_count
                    - self.max_pending_samples)
        for ids_list, values_list, count_attr in (
            (self._requeue_ids, self._requeue_values, "_requeue_count"),
            (self._pending_ids, self._pending_values, "_pending_count"),
        ):
            while overflow > 0 and ids_list:
                head = ids_list[0]
                take = min(len(head), overflow)
                if take == len(head):
                    ids_list.pop(0)
                    values_list.pop(0)
                else:
                    ids_list[0] = head[take:]
                    values_list[0] = values_list[0][take:]
                setattr(self, count_attr, getattr(self, count_attr) - take)
                with self._shed_lock:
                    self._shed_samples += take
                overflow -= take

    def _preagg_record(self, ids: np.ndarray, values: np.ndarray) -> None:
        """Fold one batch into the calling thread's cell shard.  The card
        sees the cells at a forced flush or past ``max_host_cells``."""
        consumed = self._cell_store.add(ids, values)
        if consumed < len(ids):
            # the shard's table could not grow: the consumed prefix is
            # folded exactly once, so ship everything held and retry only
            # the rest
            self._ship_packed(self._cell_store.drain_packed_all())
            rest = self._cell_store.add(ids[consumed:], values[consumed:])
            if consumed + rest < len(ids):
                dropped = len(ids) - consumed - rest
                with self._shed_lock:
                    self._shed_samples += dropped
                logger.error("cell store cannot grow even after draining; "
                             "shed %d samples", dropped)
        if len(self._cell_store) >= self.max_host_cells:
            self.flush()

    def flush(self, force: bool = False) -> None:
        """Hand buffered samples to the transfer worker.  Enqueue-only,
        unless ``force`` (collect, close): then it waits until every
        enqueued item has reached the device, the spill or the requeue
        buffer.  On preagg it ships the store's cells when forced or
        past ``max_host_cells``.  A non-forced flush never waits: while
        the device cools down or the queue holds ``max_pending_samples``
        it leaves the samples in the bounded host buffer."""
        with self.obs_recorder.span("ingest.flush"):
            self._flush_impl(force)

    def _drain_host_locked(self):
        """Take the whole host buffer, requeue first (older); caller
        holds _lock."""
        ids = np.concatenate(self._requeue_ids + self._pending_ids)
        values = np.concatenate(self._requeue_values + self._pending_values)
        self._requeue_ids, self._requeue_values = [], []
        self._requeue_count = 0
        self._pending_ids, self._pending_values = [], []
        self._pending_count = 0
        return ids, values

    def _flush_impl(self, force: bool) -> None:
        self._raise_worker_error()
        if self._cell_store is not None:
            if force or len(self._cell_store) >= self.max_host_cells:
                packed = self._cell_store.drain_packed_all()
                if len(packed):
                    self._enqueue_xfer(("packed", packed, None, 0, force))
            if force:
                self.wait_transfers()
            return
        if self._native_buf is not None:
            with self._lock:
                self._native_staged = 0
            nids, nvalues = self._native_buf.drain()
            if len(nids):
                with self._lock:
                    self._pending_ids.append(nids)
                    self._pending_values.append(nvalues.astype(np.float32))
                    self._pending_count += len(nids)
                    self._bound_pending_locked()
        with self._lock:
            if not self._requeue_count and not self._pending_count:
                ids = values = None
            elif not force and time.monotonic() < self._device_down_until:
                # cooling down after a device failure: keep buffering
                # (_device_down_until is written under _dev_lock; a racy
                # read of a heuristic)
                return
            elif (not force
                  and self._xfer_queued_samples >= self.max_pending_samples):
                # the queue is saturated (the device is slower than the
                # producers): the samples stay in the bounded host
                # buffer, where the oldest-first shed applies
                return
            else:
                ids, values = self._drain_host_locked()
        kind = "fold" if self.transport == "sparse" else "raw"
        if ids is not None:
            self._enqueue_xfer((kind, ids, values, len(ids), force))
        if not force:
            return
        self.wait_transfers()
        # an item in flight when we drained may have failed during the
        # wait and requeued its samples: they were recorded before this
        # flush, so the barrier owes them one forced attempt (one only:
        # if it fails too, the device is down and they stay buffered)
        with self._lock:
            if not self._requeue_count and not self._pending_count:
                return
            ids, values = self._drain_host_locked()
        self._enqueue_xfer((kind, ids, values, len(ids), True))
        self.wait_transfers()

    # -- transfer pipeline ---------------------------------------------- #

    def _enqueue_xfer(self, item: tuple) -> None:
        """Append one (kind, ids, values, n_samples, force) item to the
        FIFO, lazily (re)spawning the worker thread."""
        with self._xfer_cv:
            if self._xfer_thread is None or not self._xfer_thread.is_alive():
                if (self._xfer_thread is not None and not self._xfer_stop
                        and self.supervisor is not None):
                    # the worker died abnormally (close() sets _xfer_stop
                    # first): this respawn is its restart, on the shared
                    # ledger the thread_restarted invariant reads
                    self.supervisor.note_external_restart(
                        "loghisto-torch-xfer")
                self._xfer_stop = False
                self._xfer_thread = threading.Thread(
                    target=self._xfer_worker, daemon=True,
                    name="loghisto-torch-xfer",
                )
                self._xfer_thread.start()
            self._xfer_queue.append(item)
            self._xfer_queued_samples += item[3]
            self._xfer_cv.notify_all()

    def _raise_worker_error(self) -> None:
        # the worker stores under the same condition variable, so an
        # error stored between the read and the clear cannot be lost
        with self._xfer_cv:
            err, self._xfer_error = self._xfer_error, None
        if err is not None:
            raise RuntimeError(
                "the transfer worker failed to apply a batch"
            ) from err

    def wait_transfers(self, timeout: Optional[float] = None) -> bool:
        """Block until the queue is empty and the worker idle; re-raise a
        worker failure.  Returns False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._xfer_cv:
            while self._xfer_queue or self._xfer_active:
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return False
                self._xfer_cv.wait(remaining)
        self._raise_worker_error()
        return True

    def close(self) -> None:
        """Drain everything (buffers, queue, in-flight uploads) and stop
        the worker.  The aggregator stays usable: a later flush respawns
        the worker."""
        try:
            self.flush(force=True)
        finally:
            with self._dev_lock:
                if self._staging_ring is not None:
                    self._staging_ring.drain()
            with self._xfer_cv:
                self._xfer_stop = True
                self._xfer_cv.notify_all()
                t = self._xfer_thread
            if t is not None:
                t.join(timeout=10.0)

    def _xfer_worker(self) -> None:
        while True:
            inj = self.fault_injector
            if inj is not None:
                # between items (no queue bookkeeping in flight): a
                # scripted crash kills the worker (the next enqueue
                # respawns it), a wedge backs the queue up into the
                # max_pending_samples shed
                inj.check("agg.xfer_worker")
            with self._xfer_cv:
                while not self._xfer_queue and not self._xfer_stop:
                    self._xfer_cv.wait()
                if not self._xfer_queue:
                    self._xfer_active = False
                    self._xfer_cv.notify_all()
                    return
                item = self._xfer_queue.popleft()
                self._xfer_active = True
            try:
                with self.obs_recorder.span("ingest.drain"):
                    self._process_xfer_item(item)
            except Exception as e:  # surfaced by the next flush/collect
                # device failures are handled inside the item's nets;
                # what reaches here is not a device failure
                logger.exception("transfer worker failed on a %s item",
                                 item[0])
                with self._xfer_cv:
                    self._xfer_error = e
            finally:
                with self._xfer_cv:
                    self._xfer_queued_samples -= item[3]
                    self._xfer_active = False
                    self._xfer_cv.notify_all()

    def merge_packed(self, packed: np.ndarray, wait: bool = False) -> None:
        """Merge an int32 ``[n, 3]`` (row_id, codec_bucket, count) cell
        array, already in THIS aggregator's row space, through the
        transfer worker's packed route (K3 or the paged commit, the same
        spill guarantees and wire accounting as the sparse transport).
        Scatter-adds are order-free, so interleaving with local ingest
        cannot change the aggregate.  ``wait`` blocks until the queue
        drains."""
        packed = np.ascontiguousarray(packed, dtype=np.int32)
        if packed.ndim != 2 or packed.shape[1] != 3:
            raise ValueError(
                f"packed cell array must be [n, 3] (id, bucket, count); "
                f"got shape {packed.shape}"
            )
        if len(packed):
            self._enqueue_xfer(("packed", packed, None, 0, False))
        if wait:
            self.wait_transfers()

    def transport_stats(self) -> dict:
        """Wire accounting of the active transport: uploads, the bytes
        moved host->device and the samples they carried."""
        ring = self._staging_ring
        return {
            "transport": self.transport,
            "probe_density": self.probe_density,
            "uploads": self._xfer_uploads + (ring.uploads if ring else 0),
            "bytes_uploaded": self._xfer_bytes
            + (ring.bytes_uploaded if ring else 0),
            "samples_shipped": self._xfer_samples_shipped,
        }

    def _process_xfer_item(self, item: tuple) -> None:
        kind, a, b, n, force = item
        if self._stage is not None:
            # D12: a paged mesh rank stages; the entry points land
            if kind == "packed":
                self._stage.add_cells(a)
            else:
                self._stage.add_samples(a, b)
                self._xfer_samples_shipped += n
            return
        if kind == "packed":
            self._xfer_uploads += 1
            self._xfer_bytes += a.nbytes
            self._xfer_samples_shipped += int(a[:, 2].sum(dtype=np.int64))
            self._ship_packed(a)
            return
        # the cooldown gate, per item: after a failure arms it, queued
        # non-forced items go straight back to the requeue buffer, so a
        # down device costs one attempt a cooldown, in arrival order
        if not force and time.monotonic() < self._device_down_until:
            self._requeue_raw(a, b)
            return
        if kind == "fold" or self._maybe_switch_sparse(a, b, n):
            packed = fold_packed(
                a, b, self.config.bucket_limit, self.config.precision)
            self._xfer_uploads += 1
            self._xfer_bytes += packed.nbytes
            self._xfer_samples_shipped += n
            self._ship_packed(packed)
            return
        self._process_raw(a, b, n)

    def _requeue_raw(self, ids: np.ndarray, values: np.ndarray) -> None:
        if not len(ids):
            return
        with self._lock:
            self._requeue_ids.append(ids)
            self._requeue_values.append(values)
            self._requeue_count += len(ids)
            self._bound_pending_locked()

    def _maybe_switch_sparse(self, ids, values, n) -> bool:
        """transport="auto" density probe: runs once, on the first raw
        item of at least 2^16 samples, over the WHOLE item.  Returns True
        when this item should already take the fold route."""
        if not self._transport_auto or self.probe_density is not None:
            return False
        if n < _PROBE_SAMPLES:
            return False
        keep = ids >= 0
        kept = int(keep.sum())
        if not kept:
            return False
        buckets = compress_np_host(
            values[keep], self.config.precision
        ).astype(np.int64)
        keys = (ids[keep].astype(np.int64) << 16) | (buckets + 32768)
        self.probe_density = len(np.unique(keys)) / kept
        device_type = self.device.type
        chosen = dispatch.choose_transport(device_type, self.probe_density)
        if chosen != self.transport:
            logger.info(
                "transport auto-probe: cell density %.3f <= crossover "
                "%.3f on %s; switching to the sparse packed-triple "
                "transport", self.probe_density,
                dispatch.sparse_density_crossover(device_type), device_type,
            )
            self.transport = chosen
        return self.transport == "sparse"

    def _process_raw(self, ids: np.ndarray, values: np.ndarray,
                     n: int) -> None:
        """Raw route: stage each batch_size chunk through the pinned ring
        and launch one ingest step on it, with the spill check per
        chunk (the int32 overflow guarantee).  A failing chunk keeps
        the samples exact: everything before it was applied, everything
        from it on is requeued from the host arrays."""
        bs = self.batch_size
        retry_off = None
        with self._dev_lock:
            if self.paged is not None:
                # K4f: assign codecs and map every page the batch touches
                # BEFORE the upload; ids come back rewritten (pool
                # saturated -> overflow row, or -1 after an exact spill),
                # so a requeue of these arrays stays count-exact
                ids, _ = self.paged.prepare_batch(ids, values)
            # a mesh rank stages its block's ids; a requeue keeps the
            # row-space ids
            staged = ids
            if self.mesh is not None:
                late = ((ids >= self.num_metrics)
                        & (ids < self.registry.capacity))
                if late.any():
                    self._late_raw.append((ids[late], values[late]))
                    ids, values = ids[~late], values[~late]
                    n = len(ids)
                staged = block_ids(ids, self._row0, self._rows)
            ring = self._staging_ring
            if ring is None or ring.slot_samples != bs:
                ring = self._staging_ring = IngestStagingRing(
                    bs, self.device, depth=self.staging_depth)
            bl, prec = self.config.bucket_limit, self.config.precision
            rec = self.obs_recorder
            for off in range(0, n, bs):
                try:
                    inj = self.fault_injector
                    if inj is not None:
                        # inside the per-chunk net: an injected failure
                        # takes the organic recovery
                        inj.check("agg.ingest")
                    with rec.span("ingest.upload"):
                        ids_dev, values_dev = ring.stage(
                            staged[off:off + bs], values[off:off + bs]
                        )
                    with rec.span("ingest.dispatch"):
                        if self.paged is not None:
                            self.paged.ingest_raw(ids_dev, values_dev)
                        else:
                            self._ingest(self._acc, ids_dev, values_dev,
                                         bl, prec)
                except Exception:
                    self._on_device_failure_locked()
                    retry_off = off
                    break
                self._device_down_until = 0.0
                self._interval_ingested += min(bs, n - off)
                if self._interval_ingested >= self._spill_at:
                    self._spill_fold_locked()
        self._xfer_samples_shipped += n if retry_off is None else retry_off
        if retry_off is not None:
            # the traceback was logged by _on_device_failure_locked
            logger.warning("buffering %d samples for retry (cooldown %.1fs)",
                           n - retry_off, self.retry_cooldown)
            self._requeue_raw(ids[retry_off:n], values[retry_off:n])

    def _ship_packed(self, packed: np.ndarray) -> None:
        """Merge packed (id, bucket, count) triples into the accumulator
        through K3 (dense) or ``PagedStore.commit`` (paged: translate,
        pad, K4), or into the exact host spill when the int32 guarantee
        requires it."""
        if not len(packed):
            return
        if packed.ndim != 2 or packed.shape[1] != 3:
            raise ValueError(
                f"packed cell array must be [m, 3] (id, bucket, count); "
                f"got shape {packed.shape}"
            )
        if packed.dtype != np.int32:
            raise ValueError(
                f"packed cell array must be int32; got {packed.dtype}"
            )
        bl = self.config.bucket_limit
        with self._dev_lock:
            if self.mesh is not None:
                # under the lock: a regrow between the stash and the
                # block's cut would count the late cells twice
                self._stash_late_cells_locked(
                    packed[:, 0], packed[:, 1], packed[:, 2])
                lo = self._row0
                packed = packed[(packed[:, 0] >= lo)
                                & (packed[:, 0] < lo + self._rows)]
                if not len(packed):
                    return
                packed[:, 0] -= lo
            weights = packed[:, 2]
            total = int(weights.sum(dtype=np.int64))
            if (
                self._interval_ingested + total >= self._spill_at
                or int(weights.max()) >= 1 << 30
            ):
                self._spill_fold_locked()
                self._spill_add_cells_locked(
                    packed[:, 0], packed[:, 1], packed[:, 2])
                return
            try:
                if self.paged is not None:
                    self._interval_ingested += self.paged.commit(packed)
                else:
                    # one launch per item: there is no per-shape compile
                    # to amortize with fixed-size chunks
                    sparse_ingest(self._acc,
                                  torch.from_numpy(packed).to(self.device),
                                  bl)
                    self._interval_ingested += total
            except Exception:
                # the cells are finished aggregates: the exact host
                # spill takes them, no retry queue needed
                self._on_device_failure_locked()
                self._spill_add_cells_locked(
                    packed[:, 0], packed[:, 1], packed[:, 2])
                return
            self._device_down_until = 0.0

    def _spill_add_cells_locked(self, ids, buckets, weights) -> None:
        """Add (id, codec bucket, count) cells to the host int64 spill —
        exact at any magnitude.  Caller holds _dev_lock.  Paged storage
        keeps its spill as the store's sparse host dict."""
        ids = np.asarray(ids, dtype=np.int64)
        # paged storage takes global ids (a mesh rank's store keeps its
        # block's), a dense mesh rank its block's local ones
        keep = (ids >= 0) & (ids < (self.num_metrics if self.paged is not None
                                    else self._rows))
        bl = self.config.bucket_limit
        cols = np.clip(np.asarray(buckets, dtype=np.int64)[keep], -bl, bl) + bl
        weights = np.asarray(weights, dtype=np.int64)[keep]
        if self.paged is not None:
            self.paged.spill_cells(ids[keep], cols, weights)
        else:
            if self._spill is None:
                self._spill = np.zeros(
                    (self._rows, self.config.num_buckets),
                    dtype=np.int64,
                )
            np.add.at(self._spill, (ids[keep], cols), weights)
        self._spilled_samples += int(weights.sum())

    # -- host-tier bridge ----------------------------------------------- #

    def merge_raw(self, raw: RawMetricSet) -> None:
        """Merge one host-tier interval (sparse bucket maps) into the
        device accumulator (``_merge_cells_locked``)."""
        ids, bidx, weights = [], [], []
        for name, bucket_counts in raw.histograms.items():
            n = len(bucket_counts)
            if not n:
                continue
            counts = np.fromiter(bucket_counts.values(), np.int64, n)
            mid = self._id_for(name, samples=int(counts.sum()))
            if mid < 0:
                continue  # shed (already counted, with its true weight)
            ids.append(np.full(n, mid, dtype=np.int64))
            bidx.append(np.fromiter(bucket_counts.keys(), np.int64, n))
            weights.append(counts)
        if not ids:
            return
        if self._stage is not None:
            # D12: the row's cells wait for the next entry point
            self._stage.add_cells(np.stack([np.concatenate(ids),
                                            np.concatenate(bidx),
                                            np.concatenate(weights)],
                                           axis=1))
            return
        with self._dev_lock:
            self._merge_cells_locked(np.concatenate(ids),
                                     np.concatenate(bidx),
                                     np.concatenate(weights))

    def _merge_cells_locked(self, ids_np: np.ndarray, bidx_np: np.ndarray,
                            weights_np: np.ndarray) -> None:
        """Merge weighted (id, codec bucket, count) cells: repacked as
        int32 triples through K3 on dense storage, or
        ``PagedStore.commit`` on paged storage.  When the interval total
        would reach ``spill_threshold``, or any weight is >= 2^30, the
        cells go to the exact int64 host spill instead.  Caller holds
        _dev_lock (the fused committer's spill fallback enters here).  A
        dense mesh rank keeps the cells of its block; on a paged mesh the
        cells are a global batch (D12), which every rank translates."""
        if self.mesh is not None and self.paged is None:
            self._stash_late_cells_locked(ids_np, bidx_np, weights_np)
            lo = self._row0
            keep = (ids_np >= lo) & (ids_np < lo + self._rows)
            ids_np = ids_np[keep] - lo
            bidx_np, weights_np = bidx_np[keep], weights_np[keep]
        n = len(ids_np)
        if not n:
            return
        total = int(weights_np.sum(dtype=np.int64))
        bl = self.config.bucket_limit
        if (
            self._interval_ingested + total >= self._spill_at
            or int(weights_np.max()) >= 1 << 30
        ):
            self._spill_fold_locked()
            self._spill_add_cells_locked(ids_np, bidx_np, weights_np)
            return
        # int32 is safe now: the guard bounds every weight below 2^30
        packed = np.empty((n, 3), dtype=np.int32)
        packed[:, 0] = ids_np
        packed[:, 1] = np.clip(bidx_np, -bl, bl)
        packed[:, 2] = weights_np
        try:
            if self.paged is not None:
                self._interval_ingested += self.paged.commit(packed)
            else:
                sparse_ingest(self._acc,
                              torch.from_numpy(packed).to(self.device), bl)
                self._interval_ingested += total
        except Exception:
            # nothing of this one launch applied: the exact host spill
            # takes every cell, no sample lost or counted twice
            self._on_device_failure_locked()
            self._spill_add_cells_locked(ids_np, bidx_np, weights_np)
            return
        # success only: a failed chunk's cooldown must survive a merge
        # that returns normally
        self._device_down_until = 0.0

    def _acc_deleted(self) -> bool:
        """Whether a failed launch consumed the accumulator: never in
        the port.  The reference donates its JAX accumulator into each
        dispatch, and a failure may leave it deleted; the port's kernels
        update the tensor in place, so it survives every failure (a
        sticky CUDA error poisons the whole context instead, which only
        ``recover()`` in a new process answers)."""
        return False

    def _on_device_failure_locked(self) -> None:
        """Device-failure bookkeeping (caller holds _dev_lock and calls
        from inside the except handler, so the traceback is live): log
        it, arm the retry cooldown, recover a consumed accumulator or
        pool (never, in the port: ``_acc_deleted``), drop the snapshot
        handle and count the failure on the breaker, its single count
        point: the committer's recovery, the bridge merge and the
        transfer worker all come through here."""
        logger.exception("device ingest dispatch failed")
        self._device_down_until = time.monotonic() + self.retry_cooldown
        lost = self._acc_deleted() or (
            self.paged is not None and self.paged.pool_deleted())
        if lost:
            logger.error("device failure consumed the accumulator; %d "
                         "already-ingested samples of this interval are "
                         "lost", self._interval_ingested)
            with self._shed_lock:
                self._shed_samples += self._interval_ingested
            self._interval_ingested = 0
            if self.paged is not None:
                self.paged.reset_pool()
            else:
                self._acc.zero_()
        self.stats_snapshot = None
        if self.device_breaker is not None:
            self.device_breaker.record_failure("aggregator")

    def _raise_bridge_error(self, clear: bool = False) -> None:
        err = self.bridge_error
        if err is not None:
            if clear:
                self.bridge_error = None
            raise RuntimeError(
                "the aggregator's bridge failed to merge an interval"
            ) from err

    def attach(self, ms, channel_capacity: int = 8) -> None:
        """Subscribe to a MetricSystem's raw broadcast: a bridge thread
        merges every interval (``merge_raw``).  A strike-evicted channel
        is re-subscribed (``bridge_evictions`` counts it).  A failed
        merge is logged and kept in ``bridge_error`` (the first one),
        which ``collect()`` and ``detach()`` re-raise."""
        if self._attached is not None:
            raise RuntimeError("already attached")
        stop = threading.Event()
        ch = Channel(channel_capacity)
        ms.subscribe_to_raw_metrics(ch)
        self._bridge_ch = ch

        def bridge():
            nonlocal ch
            while True:
                try:
                    raw = ch.get()
                except ChannelClosed:
                    with self._bridge_lock:
                        # detach() sets stop before taking this lock, so
                        # a channel detach closed is never re-subscribed
                        if stop.is_set():
                            return
                        self.bridge_evictions += 1
                        ch = Channel(channel_capacity)
                        ms.subscribe_to_raw_metrics(ch)
                        self._bridge_ch = ch
                    logger.warning(
                        "bridge channel was strike-evicted; re-subscribed "
                        "(eviction #%d)", self.bridge_evictions,
                    )
                    continue
                try:
                    self.merge_raw(raw)
                except Exception as e:
                    logger.exception(
                        "device merge failed for interval %s", raw.time
                    )
                    if self.bridge_error is None:
                        self.bridge_error = e

        # supervised, a crashed bridge restarts with capped backoff; the
        # clean stop-event return ends it for good
        t = spawn_thread(self.supervisor, bridge, "loghisto-torch-bridge")
        self._attached = (ms, t, stop)

    def detach(self) -> None:
        """Unsubscribe, let the bridge merge what its channel already
        holds, join it, and re-raise (then clear) a bridge failure."""
        if self._attached is not None:
            ms, t, stop = self._attached
            stop.set()
            with self._bridge_lock:
                ch, self._bridge_ch = self._bridge_ch, None
            if ch is not None:
                ms.unsubscribe_from_raw_metrics(ch)
                ch.close()  # the bridge drains it, then returns
            # a supervised handle's restart loop stops too, so no backoff
            # nap outlives the join
            t.stop()
            t.join(timeout=30.0)
            self._attached = None
        self._raise_bridge_error(clear=True)

    # -- collection ----------------------------------------------------- #

    def _dense_stats(self, acc, spill, ps: list) -> dict:
        """counts / sums / percentiles of a dense interval snapshot as
        host arrays."""
        bl, prec = self.config.bucket_limit, self.config.precision
        if spill is not None:
            # spill interval: counts may exceed int32, so the whole
            # extraction runs in exact int64 on the host
            return dense_stats_np(
                spill + acc.cpu().numpy().astype(np.int64),
                np.asarray(ps, dtype=np.float64), bl, prec,
            )
        return {
            k: v.cpu().numpy() for k, v in dense_stats(
                acc, np.asarray(ps, dtype=np.float32), bl, prec
            ).items()
        }

    def _stash_late_cells_locked(self, ids, buckets, weights) -> None:
        """Keep the cells of rows the registry grew but the blocks do not
        hold yet, for ``_mesh_regrow`` (caller holds _dev_lock)."""
        ids = np.asarray(ids, dtype=np.int64)
        late = (ids >= self.num_metrics) & (ids < self.registry.capacity)
        if late.any():
            self._late_cells.append((
                ids[late], np.asarray(buckets, dtype=np.int64)[late],
                np.asarray(weights, dtype=np.int64)[late]))

    def _mesh_regrow(self) -> None:
        """Growth on a mesh, at the collective point: the ranks agree on
        the row count (their registries grow in the same order), each
        stream row's old blocks are gathered over the metric axis and
        every rank keeps its new block (doubling M moves rows between
        ranks), then the samples and cells that waited on the host for
        the new rows are folded in.  Collectives, in this order on every
        rank: the row count (MAX over stream, then metric); when it grew,
        the spill flag (MAX over metric) and the gathers of the blocks
        and, if any rank of the row spilled, of the spills; then each
        registered carry (``_mesh_carries``: the lifecycle's activity
        block, the drift engine's banks), which lays itself out anew
        through the same ``regrown``."""
        import torch.distributed as dist

        max_ = dist.ReduceOp.MAX
        new_m = mesh_reduce(self.mesh, [self.registry.capacity], max_)[0]
        if new_m == self.num_metrics:
            return
        old_m = self.num_metrics

        def regrown(part: torch.Tensor, dim: int = 0,
                    fill=0) -> torch.Tensor:
            """This rank's new block of its line's rows (on dim ``dim``),
            the new rows ``fill``, on the collective's device."""
            whole = gather_parts(self.mesh, part, dim=dim)
            shape = list(whole.shape)
            shape[dim] = new_m
            grown = torch.full(shape, fill, dtype=whole.dtype,
                               device=whole.device)
            grown.narrow(dim, 0, old_m).copy_(whole)
            rows = new_m // self._n_metric
            return grown.narrow(dim, self._metric_index * rows, rows).clone()

        with self._dev_lock:
            self.registry.grow(new_m)
            if self.paged is not None:
                # the store redraws its shard blocks and migrates the rows
                # that change shard (a collective of the metric line); the
                # stage still holds the new rows' samples (D12); then the
                # lifecycle's activity block (D13)
                self.paged.grow(new_m)
                self.num_metrics = new_m
                self.stats_snapshot = None
                for relayout in self._mesh_carries:
                    relayout(regrown)
                return
            acc = regrown(self._acc).to(self.device)
            if mesh_reduce(self.mesh, [self._spill is not None], max_,
                           (METRIC_AXIS,))[0]:
                spill = (self._spill if self._spill is not None
                         else np.zeros(tuple(self._acc.shape), np.int64))
                self._spill = regrown(torch.from_numpy(spill)).cpu().numpy()
            self._acc = acc
            self.num_metrics = new_m
            for relayout in self._mesh_carries:
                relayout(regrown)
            if dispatch.ingest_incapability(self.ingest_path, self._rows,
                                            self.batch_size, acc.shape[1]):
                self.ingest_path = dispatch.resolve_ingest_path(
                    "auto", self._rows, self.batch_size)
                self._ingest = _step_for(self.ingest_path)
            self.stats_snapshot = None
            late_raw, self._late_raw = self._late_raw, []
            late_cells, self._late_cells = self._late_cells, []
        for ids, values in late_raw:
            self._process_raw(ids, values, len(ids))
        with self._dev_lock:
            for cells in late_cells:
                self._merge_cells_locked(*cells)

    def land_staged(self) -> None:
        """ROADMAP D12, at a collective entry point of a mesh rank on
        paged storage (nothing elsewhere): the stage's batches, gathered
        over the stream axis, land on every rank's host half and arena.
        After a forced flush and the registry's growth
        (``_mesh_regrow``) the ranks of each stream row agree on the
        prefix of the row's input to take (a MIN over the metric line),
        cut into ``batch_size`` batches, then on the sample and cell
        batch counts (a MAX over the mesh; a row with fewer batches adds
        empty ones); batch
        k of every stream row, in stream order, is the global batch k:
        raw samples go through ``prepare_batch`` and K4f in
        ``batch_size`` chunks, the sparse transport's cells are folded
        again as the global batch folds and committed (translate, K4),
        as are the ``merge_packed`` / ``merge_raw`` cell batches after
        them.  A collective of every rank of the mesh."""
        if self._stage is None:
            return
        import torch.distributed as dist

        self.flush(force=True)
        # the registry's growth first: the staged ids may name new rows
        self._mesh_regrow()
        # a prefix every rank of the stream row holds (MIN over the
        # metric line), so the row's batches are the same on each
        n, c = mesh_reduce(self.mesh, list(self._stage.counts()),
                           dist.ReduceOp.MIN, (METRIC_AXIS,))
        samples, cells = self._stage.take(n, c)
        k_s, k_c = mesh_reduce(self.mesh, [len(samples), len(cells)],
                               dist.ReduceOp.MAX)
        raw = self.fused_paged
        for batch in self._gather_batches(samples, k_s, 2 if raw else 3,
                                          np.int32 if raw else np.int64):
            with self._dev_lock:
                if raw:
                    self._land_raw_locked(
                        batch[:, 0].copy(),
                        batch[:, 1].copy().view(np.float32))
                else:
                    self._land_cells_locked(refold_cells(batch))
        for batch in self._gather_batches(cells, k_c, 3, np.int64):
            with self._dev_lock:
                self._land_cells_locked(batch)

    def _gather_batches(self, batches: list, k: int, width: int,
                        dtype) -> list:
        """The ``k`` global batches of this rank's stream line: batch j of
        every stream row (an empty one past a row's last), concatenated
        in stream order.  Two collectives of the line, the batch sizes'
        gather and one of the data, each row's padded to the longest
        (none when ``k`` is 0; the second none when every batch is
        empty)."""
        if not k:
            return []
        sizes = [len(b) for b in batches] + [0] * (k - len(batches))
        per = gather_parts(self.mesh, torch.tensor(sizes, dtype=torch.int64,
                                                   device=self.device),
                           STREAM_AXIS).cpu().numpy().reshape(-1, k)
        longest = int(per.sum(axis=1).max())
        if not longest:
            return [np.empty((0, width), dtype=dtype)] * k
        part = np.zeros((longest, width), dtype=dtype)
        if batches:
            data = np.concatenate(batches)
            part[:len(data)] = data
        whole = gather_parts(self.mesh, torch.from_numpy(part).to(
            self.device), STREAM_AXIS).cpu().numpy()
        starts = np.arange(len(per)) * longest
        offs = starts[:, None] + np.concatenate(
            [np.zeros((len(per), 1), np.int64), np.cumsum(per, axis=1)[:, :-1]],
            axis=1)
        return [np.concatenate([whole[offs[r, j]:offs[r, j] + per[r, j]]
                                for r in range(len(per))])
                for j in range(k)]

    def _land_raw_locked(self, ids: np.ndarray, values: np.ndarray) -> None:
        """One global raw batch on a paged mesh rank (caller holds
        _dev_lock): ``prepare_batch`` on all of it, then K4f on the
        rank's arena in ``batch_size`` chunks, with the spill check per
        chunk.  A chunk that fails takes the device-failure handler and
        raises: ``prepare_batch`` already changed every rank's host half
        for the whole batch, so neither the one-card route's requeue (a
        later ``prepare_batch`` on this rank alone) nor a fold of the
        rest on the host would keep the rank's arena what the reference
        holds.  The rank's arena then lacks the batch's rest; the mesh
        has to be rebuilt."""
        ids, _ = self.paged.prepare_batch(ids, values)
        bs, n = self.batch_size, len(ids)
        ring = self._staging_ring
        if ring is None or ring.slot_samples != bs:
            ring = self._staging_ring = IngestStagingRing(
                bs, self.device, depth=self.staging_depth)
        for off in range(0, n, bs):
            try:
                inj = self.fault_injector
                if inj is not None:
                    inj.check("agg.ingest")
                ids_dev, values_dev = ring.stage(ids[off:off + bs],
                                                 values[off:off + bs])
                self.paged.ingest_raw(ids_dev, values_dev)
            except Exception as exc:
                self._on_device_failure_locked()
                raise RuntimeError(
                    f"K4f failed on a paged mesh rank: {n - off} samples "
                    "of a global batch did not land in its arena"
                ) from exc
            self._device_down_until = 0.0
            self._interval_ingested += min(bs, n - off)
            if self._interval_ingested >= self._spill_at:
                self._spill_fold_locked()

    def _land_cells_locked(self, cells: np.ndarray) -> None:
        """One global cell batch (int64 ``[n, 3]``) on a paged mesh rank
        (caller holds _dev_lock): ``_merge_cells_locked``'s envelope
        check, then translate and K4 on the rank's arena."""
        if len(cells):
            self._xfer_uploads += 1
            self._xfer_bytes += len(cells) * 12
            self._merge_cells_locked(cells[:, 0], cells[:, 1], cells[:, 2])

    def _paged_mesh_stats(self, stats: dict) -> dict:
        """The statistics of every row on every rank: the block's (from
        the rank's arena and its block's spill) gathered over the metric
        axis, three gathers of the metric line."""
        return {key: gather_parts(self.mesh, torch.as_tensor(
            stats[key], device=self.device)).cpu().numpy()
            for key in ("counts", "sums", "percentiles")}

    def _mesh_stats(self, acc, spill, ps: list) -> dict:
        """The global statistics of a mesh interval, on every rank: the
        interval's partial (the block, plus its int64 spill) summed over
        the stream axis, its rows' statistics, gathered over the metric
        axis.  Collectives, in this order on every rank: the spill flag
        (MAX over stream, then metric: any spill anywhere makes every
        block take the exact int64 host route, as one spill does in the
        reference), the block's ``all_reduce`` and three gathers."""
        import torch.distributed as dist

        stream = axis_group(self.mesh, STREAM_AXIS)
        bl, prec = self.config.bucket_limit, self.config.precision
        if mesh_reduce(self.mesh, [spill is not None],
                       dist.ReduceOp.MAX)[0]:
            total = acc.to(torch.int64)
            if spill is not None:
                total += torch.from_numpy(spill).to(total.device)
            total = total.to(collective_device(stream, self.device))
            dist.all_reduce(total, group=stream)
            block = dense_stats_np(total.cpu().numpy(),
                                   np.asarray(ps, dtype=np.float64), bl, prec)
        else:
            # int32 is exact: every rank's partial stays under its share
            # of spill_threshold (_spill_at)
            dist.all_reduce(acc, group=stream)
            block = dense_stats(acc, np.asarray(ps, dtype=np.float32), bl,
                                prec)
        # a host block (the spill route) goes to the card under NCCL
        return {key: gather_parts(self.mesh, torch.as_tensor(
            block[key], device=self.device)).cpu().numpy()
            for key in ("counts", "sums", "percentiles")}

    def collect(self, reset: bool = True) -> ProcessedMetricSet:
        """Statistics of every registered metric with the reference's
        naming scheme; ``reset`` closes the interval.  Re-raises a
        failure of the attach bridge.  On a mesh it is a collective
        call: every rank calls it, in the same order, and each returns
        the global set."""
        self._raise_bridge_error()
        with maybe_capture("loghisto_collect"):
            self.flush(force=True)
            if self.mesh is not None:
                self._mesh_regrow()
                self.land_staged()
            labels, stats = self._interval_stats(reset)
        return self._named(labels, stats, reset)

    def _interval_stats(self, reset: bool):
        """(percentile labels, host statistics arrays) of the interval;
        ``reset`` closes it."""
        t0 = time.perf_counter()
        labels, ps = [], []
        for label, p in self.percentiles.items():
            if 0.0 <= p <= 1.0:
                labels.append(label)
                ps.append(p)
        with self._dev_lock:
            if self.paged is not None:
                # sparse statistics over the decoded pool + host spill;
                # they read the pool, so they run under the lock
                stats = self.paged.stats(
                    np.asarray(ps, dtype=np.float64), reset=reset
                )
            else:
                acc, spill = self._acc, self._spill
                if reset:
                    self._acc = torch.zeros_like(acc)
                    self._spill = None
                else:
                    acc = acc.clone()
                    spill = None if spill is None else spill.copy()
            if reset:
                self._interval_ingested = 0
                self._spilled_samples = 0
                self.stats_snapshot = None
        if self.mesh is not None and self.paged is not None:
            stats = self._paged_mesh_stats(stats)
        elif self.mesh is not None:
            stats = self._mesh_stats(acc, spill, ps)
        elif self.paged is None:
            stats = self._dense_stats(acc, spill, ps)
        self._last_aggregation_us = (time.perf_counter() - t0) * 1e6
        return labels, stats

    def _named(self, labels, stats, reset: bool) -> ProcessedMetricSet:
        """The statistics under the reference's names, folded into the
        lifetime ``_agg_*`` store."""
        # Python lists: the per-row naming loop below reads scalars, and
        # list items are several times cheaper than NumPy scalars at a
        # million rows
        nonzero = np.nonzero(stats["counts"])[0]
        counts = stats["counts"][nonzero].tolist()
        sums = stats["sums"][nonzero].astype(np.float64).tolist()
        pcts = stats["percentiles"][nonzero].astype(np.float64).tolist()

        mids = nonzero.tolist()
        names = self.registry.names()[: len(stats["counts"])]
        metrics: Dict[str, float] = {}
        with self._agg_lock:
            if reset:
                agg_view = self._agg
            else:
                agg_view = {
                    mid: list(entry) for mid, entry in self._agg.items()
                }
            # every nonzero row folds into the lifetime store, named or
            # not; reporting stays name-gated (as in the reference)
            for mid, count, total, row_pcts in zip(
                mids, counts, sums, pcts
            ):
                count = int(count)
                if mid < len(names) and names[mid] is not None:
                    name = names[mid]
                    metrics[f"{name}_count"] = float(count)
                    metrics[f"{name}_sum"] = total
                    metrics[f"{name}_avg"] = total / count
                    for label, value in zip(labels, row_pcts):
                        metrics[label % name] = value
                entry = agg_view.setdefault(mid, [0, 0])
                if self.config.go_compat:
                    entry[0] = (entry[0] + int(total)) & _UINT64_MASK
                else:
                    entry[0] += total
                entry[1] += count
            for mid, entry in agg_view.items():
                name = names[mid] if mid < len(names) else None
                if name is None or entry[1] <= 0:
                    continue
                if self.config.go_compat:
                    avg = float(int(entry[0]) // int(entry[1]))
                else:
                    avg = entry[0] / entry[1]
                metrics[f"{name}_agg_avg"] = avg
                metrics[f"{name}_agg_count"] = float(entry[1])
                metrics[f"{name}_agg_sum"] = float(entry[0])
        return ProcessedMetricSet(
            time=_dt.datetime.now(tz=_dt.timezone.utc), metrics=metrics
        )

    # -- gauges --------------------------------------------------------- #

    def register_device_gauges(self, ms) -> None:
        """Register the aggregator's gauges on a MetricSystem, under the
        reference's ``tpu.*`` names so dashboards line up: device memory
        in use (``torch.cuda.memory_allocated``; 0 on the CPU), the last
        statistics time, sheds, bridge evictions, spills, on paged
        storage the pool's occupancy, and on a paged mesh the host
        stage (``tpu.MeshStagedSamples``, the port's own)."""
        device = self.device

        def hbm_bytes() -> float:
            if device.type != "cuda":
                return 0.0
            return float(torch.cuda.memory_allocated(device))

        gauges = {
            "tpu.HbmBytesInUse": hbm_bytes,
            "tpu.LastAggregationUs": lambda: self._last_aggregation_us,
            "tpu.BridgeEvictions": lambda: float(self.bridge_evictions),
            "tpu.RegistryShedSamples":
                lambda: float(self._registry_shed_samples),
            "tpu.SpilledSamples": lambda: float(self._spilled_samples),
            "tpu.SamplesShed": lambda: float(self._shed_samples),
        }
        if self._native_buf is not None:
            buf = self._native_buf
            gauges["tpu.StagingDropped"] = lambda: float(buf.dropped)
        if self.paged is not None:
            st = self.paged

            def alloc_rate(state={"n": 0, "t": None}):
                # pages a second since the previous scrape
                now, n = time.monotonic(), int(st.allocated_pages)
                last_n, last_t = state["n"], state["t"]
                state["n"], state["t"] = n, now
                if last_t is None or now <= last_t:
                    return 0.0
                return max(0.0, (n - last_n) / (now - last_t))

            gauges.update({
                "tpu.PagedOccupiedPages": lambda: float(st.occupied_pages),
                "tpu.PagedFreePages": lambda: float(st.free_pages),
                "tpu.PagedHbmBytes": lambda: float(st.hbm_bytes()),
                "tpu.PagedSpilledCells": lambda: float(st.spilled_cells),
                "tpu.PagedLastCommitH2DBytes":
                    lambda: float(st.last_h2d_bytes),
                "paging.PageAllocRate": alloc_rate,
                "paging.SpilledCells": lambda: float(st.spilled_cells),
                "paging.PoolSaturation": lambda: float(st.pool_saturation()),
                "paging.AllocatedPages": lambda: float(st.allocated_pages),
                # the per-shard arenas the saturation is the worst of
                # (host state: the same on every rank of a mesh)
                "paging.ShardFreePagesMin":
                    lambda: float(min(st.shard_free_pages())),
            })
            for k in range(st._n_shards):
                gauges[f"paging.Shard{k}Occupancy"] = (
                    lambda k=k: float(st.shard_occupancy()[k]))
        if self._stage is not None:
            # the port's own (D12): the paged mesh rank's host stage
            gauges["tpu.MeshStagedSamples"] = (
                lambda: float(self.staged_samples))
        for name, fn in gauges.items():
            ms.register_gauge_func(name, fn)

    # -- state ---------------------------------------------------------- #

    def state_dict(self, *, first_only: bool = False) -> Optional[dict]:
        """The aggregator's state as host arrays (see state.py): the live
        accumulator (dense) or the store's pool, page table, codecs,
        free list and host spill (paged), the registry's names, the
        lifetime store and the dense spill.  A full barrier first.

        On a mesh (ROADMAP D11) a collective call that every rank makes:
        the registry's growth is laid out (``_mesh_regrow``), each rank's
        stream partial with its host spill is summed over the stream
        axis in int64 and the sums are gathered over the metric axis, so
        every rank returns the same single-device state: ``acc`` the
        whole int32 ``[M, B]``, or zeros with the sum in ``spill`` where
        any rank spilled or a cell passes int32.  With ``first_only``
        (a checkpoint's save) the sum and the gather go to rank (0, 0)
        alone, and every other rank returns None.  On a paged mesh
        (ROADMAP D13) the state is the store's, gathered over the metric
        axis (``PagedStore.state``): the arenas in shard order, one free
        list each."""
        if self.mesh is not None and self.paged is not None:
            return self._paged_mesh_state_dict(first_only)
        self.flush(force=True)
        if self.mesh is not None:
            return self._mesh_state_dict(first_only)
        with self._dev_lock, self._agg_lock:
            paged = self.paged is not None
            # a copy on the device, ordered on the writers' stream; the
            # readback waits for it once the locks are released
            acc = None if paged else self._acc.clone()
            state = {
                "format": STATE_FORMAT,
                "storage": self.storage,
                "bucket_limit": self.config.bucket_limit,
                "precision": self.config.precision,
                "acc": None,
                "paged": self.paged.state() if paged else None,
                "names": self.registry.names(),
                "agg": {mid: list(e) for mid, e in self._agg.items()},
                "spill": None if self._spill is None else self._spill.copy(),
            }
        if acc is not None:
            state["acc"] = acc.cpu().numpy()
        return state

    def _paged_mesh_state_dict(self, first_only: bool) -> Optional[dict]:
        """``state_dict`` on a paged mesh (ROADMAP D13): the staged
        batches land first (``land_staged``: the barrier and the
        growth's layout), then the store's state is gathered over the
        metric axis (``PagedStore.state``).  The arenas are the same on
        every rank of a metric column, so nothing is summed over the
        stream axis."""
        self.land_staged()
        with self._dev_lock:
            paged = self.paged.state(first_only)
            if paged is None:
                return None
            names = self.registry.names()
        with self._agg_lock:
            agg = {mid: list(e) for mid, e in self._agg.items()}
        return {
            "format": STATE_FORMAT,
            "storage": self.storage,
            "bucket_limit": self.config.bucket_limit,
            "precision": self.config.precision,
            "acc": None,
            "paged": paged,
            "names": names,
            "agg": agg,
            "spill": None,
        }

    def _mesh_state_dict(self, first_only: bool) -> Optional[dict]:
        """``state_dict`` on a mesh (after the barrier)."""
        import torch.distributed as dist

        self._mesh_regrow()
        with self._dev_lock:
            # the partial is a copy on the device (int64), so the
            # collectives run after the lock: the transfer worker folds
            # on meanwhile, past this snapshot
            spilled = self._spill is not None
            part = self._acc.to(torch.int64)
            if self._spill is not None:
                part += torch.from_numpy(self._spill).to(part.device)
            names = self.registry.names()
        spilled = mesh_reduce(self.mesh, [spilled], dist.ReduceOp.MAX)[0]
        total = reduce_parts(self.mesh, part, STREAM_AXIS, first_only)
        if total is not None:
            total = host_gather(total, acc_sharding(self.mesh), first_only)
        if total is None:
            return None
        with self._agg_lock:
            agg = {mid: list(e) for mid, e in self._agg.items()}
        exact = not spilled and int(total.max(initial=0)) < 2 ** 31
        return {
            "format": STATE_FORMAT,
            "storage": self.storage,
            "bucket_limit": self.config.bucket_limit,
            "precision": self.config.precision,
            "acc": (total.astype(np.int32) if exact
                    else np.zeros(total.shape, np.int32)),
            "paged": None,
            "names": names,
            "agg": agg,
            "spill": None if exact else total,
        }

    def load_state_dict(self, state: dict) -> None:
        """Replace this aggregator's state with ``state`` (from
        ``state_dict``, ``state.state_from_jax`` or
        ``state.paged_state_from_jax``).  The row space takes the state's
        row count; the ingest path re-resolves for it.  The state's
        storage must be this aggregator's.

        On a mesh (ROADMAP D11) every rank loads the same state, with no
        collective: the registry and the lifetime store on every rank,
        the accumulator's rows on each rank's block of stream index 0
        (the other stream rows' partials start empty, so the sum over
        the stream axis is the state's), in the host spill where the
        block's counts reach the rank's share of ``spill_threshold``.
        The state's rows must split over the metric axis."""
        if state.get("format") != STATE_FORMAT:
            raise ValueError(f"unknown state format {state.get('format')!r}")
        for key in ("bucket_limit", "precision"):
            if state[key] != getattr(self.config, key):
                raise ValueError(
                    f"state {key}={state[key]} but this aggregator has "
                    f"{getattr(self.config, key)}"
                )
        storage = state.get("storage", "dense")
        if storage != self.storage:
            raise ValueError(
                f"state holds {storage} storage; this aggregator's is "
                f"{self.storage}"
            )
        if storage == "paged":
            self._load_paged_state(state)
            return
        acc = np.ascontiguousarray(state["acc"], dtype=np.int32)
        if acc.ndim != 2 or acc.shape[1] != self.config.num_buckets:
            raise ValueError(f"state acc has shape {acc.shape}")
        m = acc.shape[0]
        spill = state.get("spill")
        if spill is not None and np.shape(spill) != acc.shape:
            raise ValueError(f"state spill has shape {np.shape(spill)}")
        if self.mesh is not None:
            if m % self._n_metric:
                raise ValueError(
                    f"state of {m} rows does not split over the mesh "
                    f"metric axis ({self._n_metric})")
            acc, spill = self._stream_lead_share(acc, spill)
        self.flush(force=True)
        rows = m // self._n_metric
        with self._dev_lock, self._agg_lock:
            path = self.ingest_path
            if dispatch.ingest_incapability(path, rows, self.batch_size,
                                            acc.shape[1]):
                path = dispatch.resolve_ingest_path("auto", rows,
                                                    self.batch_size)
            self.registry = MetricRegistry.from_names(state["names"], m)
            self.num_metrics = m
            self.max_metrics = max(self.max_metrics, m)
            self.ingest_path, self._ingest = path, _step_for(path)
            self._acc = torch.from_numpy(acc).to(self.device)
            self.stats_snapshot = None
            self._spill = (
                None if spill is None
                else np.array(spill, dtype=np.int64, copy=True)
            )
            self._interval_ingested = int(acc.sum(dtype=np.int64))
            self._spilled_samples = (
                0 if spill is None else int(self._spill.sum())
            )
            self._agg = {
                int(mid): [e[0], e[1]] for mid, e in state["agg"].items()
            }

    def _stream_lead_share(self, acc: np.ndarray, spill):
        """This rank's part of a whole (int32 acc, int64 spill or None)
        on a mesh: the rows of its block at stream index 0, in the host
        spill where their counts reach the rank's share of the int32
        envelope (``_spill_at``); empty elsewhere."""
        part = acc_sharding(self.mesh)
        index = part.index(acc.shape)
        if not is_stream_lead(self.mesh):
            return np.zeros(acc[index].shape, np.int32), None
        block = np.ascontiguousarray(acc[index])
        if spill is None and int(block.sum(dtype=np.int64)) < self._spill_at:
            return block, None
        total = block.astype(np.int64)
        if spill is not None:
            total += np.asarray(spill, dtype=np.int64)[index]
        return np.zeros(block.shape, np.int32), total

    def _load_paged_state(self, state: dict) -> None:
        """The paged half of ``load_state_dict``: a fresh store at the
        state's arena shape, then its contents (on a mesh, the rank's
        arena of a state with one arena per metric shard; no
        collective)."""
        pst = state["paged"]
        pool_shape = np.shape(pst["pool"])
        m = np.shape(pst["page_table"])[0]
        arenas = len(pst.get("free_lists") or [None])
        config = dataclasses.replace(
            self.paged_config, pool_pages=pool_shape[0] // arenas,
            page_size=pool_shape[1],
        )
        store = PagedStore(
            m, self.config.bucket_limit, self.config.precision,
            config=config, device=self.device, mesh=self.mesh,
        )
        store.load_state(pst)
        self.flush(force=True)
        with self._dev_lock, self._agg_lock:
            self.paged, self.paged_config = store, config
            self.stats_snapshot = None
            self.registry = MetricRegistry.from_names(state["names"], m)
            self.num_metrics = m
            self.max_metrics = max(self.max_metrics, m)
            self._spill = None
            self._interval_ingested = int(pst["pool"].sum(dtype=np.int64))
            self._spilled_samples = int(sum(pst["host_spill"].values()))
            self._agg = {
                int(mid): [e[0], e[1]] for mid, e in state["agg"].items()
            }
