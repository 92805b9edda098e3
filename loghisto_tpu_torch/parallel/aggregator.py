"""The single-device aggregation engine (counterpart of
``loghisto_tpu/parallel/aggregator.py``: ``TPUAggregator`` as
``TorchAggregator``, and ``IngestStagingRing``).

Samples enter through ``record_batch(ids, values)`` (or ``record``),
buffer on the host and, every ``batch_size`` samples, ``flush`` hands
them to ONE transfer worker thread (a FIFO).

``storage`` picks what accumulates them (ops/dispatch.py
``resolve_storage_path``, resolved before the transport as in the
reference): "dense", the int32 [M, B] accumulator, or "paged", the page
pool + page table + per-row codecs of paging.py.  "auto" pages at
2^16 rows and above.  On dense storage the worker takes one of two
routes, updating the accumulator in place:

  * raw: the batch is copied through a ring of pinned host buffers to
    the device (``non_blocking=True``) and each ``batch_size`` chunk is
    one ingest-kernel launch — K1 (fused) or, for a single-row
    accumulator, K2 (row);
  * sparse: the batch is folded on the host into packed
    (id, bucket, count) triples (ops/fold.py) and merged by K3.

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

``attach(ms)`` subscribes to a host ``MetricSystem``'s raw broadcast:
a bridge thread runs ``merge_raw`` on every interval (K3 on dense
storage, ``PagedStore.commit`` on paged storage, the exact host spill
past the int32 guard).  A failed merge is logged and kept as
``bridge_error``, which ``collect()`` and ``detach()`` re-raise.

Not in these slices: preagg and native staging, the mesh, lifecycle,
drift, observability, the fault injector and the supervisor.  A device
error in the transfer worker is not
retried: it is re-raised by the next ``flush``, ``wait_transfers`` or
``collect``.  When the transfer queue holds more than
``max_pending_samples``, ``flush`` waits for it instead of shedding.
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
from loghisto_tpu_torch.config import DEFAULT_PERCENTILES, MetricConfig
from loghisto_tpu_torch.metrics import (
    _UINT64_MASK,
    ProcessedMetricSet,
    RawMetricSet,
)
from loghisto_tpu_torch.ops import dispatch
from loghisto_tpu_torch.ops.backend import kernel_launches, resolve_device
from loghisto_tpu_torch.ops.fold import compress_np_host, fold_packed_numpy
from loghisto_tpu_torch.ops.fused_ingest import fused_ingest_batch
from loghisto_tpu_torch.ops.row_ingest import row_ingest_batch
from loghisto_tpu_torch.ops.sparse_ingest import sparse_ingest
from loghisto_tpu_torch.ops.stats import dense_stats, dense_stats_np
from loghisto_tpu_torch.paging import PagedStore, PagedStoreConfig
from loghisto_tpu_torch.registry import MetricRegistry, RegistryFullError

logger = logging.getLogger("loghisto_tpu_torch")

DEFAULT_GROWTH_FACTOR = 8

# Minimum raw-item size the transport="auto" density probe runs on.
_PROBE_SAMPLES = 1 << 16

_STEPS = {"fused": fused_ingest_batch, "row": row_ingest_batch}

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
    ):
        """``device`` defaults to the card and raises when CUDA is
        absent; ``device="cpu"`` runs the plain versions.  The other
        arguments mean what they mean for ``TPUAggregator``;
        ``ingest_path`` is "auto", "fused" or "row" (ops/dispatch.py),
        ``storage`` "auto", "dense" or "paged", and ``paged_config`` a
        ``paging.PagedStoreConfig``."""
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
        if transport not in ("auto", "raw", "sparse"):
            raise ValueError(
                f"transport={transport!r}: expected 'auto', 'raw' or "
                "'sparse' (preagg comes in a later slice)"
            )
        if ingest_path not in ("auto", "fused", "row"):
            raise ValueError(
                f"unknown ingest_path {ingest_path!r}: expected 'auto', "
                "'fused' or 'row'"
            )
        # storage first: it pins the transport (paged with K4f ingests
        # raw, paged without it rides the host fold)
        platform = self.device.type
        self.fused_paged_reason = dispatch.fused_paged_incapability(
            num_metrics, config.num_buckets, batch_size=batch_size,
            transport=transport, platform=platform,
            crossover=(ingest_path == "auto"),
        )
        fused_paged_ok = (
            self.fused_paged_reason is None
            and ingest_path in ("auto", "fused")
        )
        self.storage, self.storage_reason = dispatch.resolve_storage_path(
            storage, num_metrics, config.num_buckets, platform,
            transport=transport, fused_ok=fused_paged_ok,
        )
        self.fused_paged = self.storage == "paged" and fused_paged_ok
        if self.storage == "paged":
            transport = "raw" if self.fused_paged else "sparse"
        self._transport_auto = transport == "auto"
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
            if ingest_path == "fused" and not self.fused_paged:
                raise ValueError(
                    "ingest_path='fused' with paged storage needs the "
                    f"direct-to-paged fused kernel: {self.fused_paged_reason}"
                )
            # the pool + page table ARE the accumulator
            self.ingest_path = "fused_paged" if self.fused_paged else "packed"
            self._ingest = None
        else:
            self.ingest_path = dispatch.resolve_ingest_path(
                ingest_path, num_metrics, batch_size
            )
            self._ingest = _STEPS[self.ingest_path]

        # Two locks, never nested: _lock guards host staging, _dev_lock
        # the device state (_acc, _spill, _interval_ingested, growth).
        self._lock = threading.Lock()
        self._dev_lock = threading.Lock()
        self._pending_ids: list = []
        self._pending_values: list = []
        self._pending_count = 0
        self.max_pending_samples = 32 * batch_size

        self._xfer_cv = threading.Condition()
        self._xfer_queue: collections.deque = collections.deque()
        self._xfer_queued_samples = 0
        self._xfer_active = False
        self._xfer_thread: Optional[threading.Thread] = None
        self._xfer_stop = False
        self._xfer_error: Optional[BaseException] = None
        self._staging_ring: Optional[IngestStagingRing] = None

        if self.storage == "paged":
            self.paged = PagedStore(
                num_metrics, config.bucket_limit, config.precision,
                config=self.paged_config, device=self.device,
            )
            self._acc = None
        else:
            self._acc = torch.zeros(
                (num_metrics, config.num_buckets), dtype=torch.int32,
                device=self.device,
            )
        self._spill: Optional[np.ndarray] = None
        self._interval_ingested = 0
        self._spilled_samples = 0
        self._registry_shed_samples = 0

        self._agg_lock = threading.Lock()
        self._agg: Dict[int, list] = {}

        # host-tier bridge (attach): (ms, thread, stop event) while attached
        self._attached: Optional[tuple] = None
        self._bridge_lock = threading.Lock()
        self._bridge_ch: Optional[Channel] = None
        self.bridge_evictions = 0
        self.bridge_error: Optional[BaseException] = None
        self._last_aggregation_us = 0.0

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

    def _grow_locked(self, target: Optional[int] = None) -> bool:
        """Grow the row space in place (caller holds _dev_lock): zero rows
        are appended to the accumulator and the spill, and a row kernel
        that no longer fits is swapped for the fused kernel."""
        old_m = self.num_metrics
        new_m = min(
            target if target is not None else old_m * 2, self.max_metrics
        )
        if new_m <= old_m:
            return False
        if self.paged is not None:
            # a host page-table extension: no device data moves
            self.paged.grow(new_m)
            self.num_metrics = new_m
            self.registry.grow(new_m)
            return True
        path = self.ingest_path
        if dispatch.ingest_incapability(path, new_m, self.batch_size):
            path = dispatch.resolve_ingest_path(
                "auto", new_m, self.batch_size
            )
        grown = torch.zeros(
            (new_m, self._acc.shape[1]), dtype=torch.int32,
            device=self.device,
        )
        grown[:old_m] = self._acc
        self._acc = grown
        self.ingest_path, self._ingest = path, _STEPS[path]
        self.num_metrics = new_m
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
            return
        acc_np = self._acc.cpu().numpy().astype(np.int64)
        if self._spill is None:
            self._spill = acc_np
        else:
            self._spill += acc_np
        self._acc.zero_()
        self._spilled_samples += self._interval_ingested
        self._interval_ingested = 0

    def record_batch(self, ids: np.ndarray, values: np.ndarray) -> None:
        """Buffer a batch of (metric_id, value) samples; flushes when the
        buffered count reaches batch_size."""
        ids = np.asarray(ids, dtype=np.int32)
        values = np.asarray(values, dtype=np.float32)
        if ids.shape != values.shape:
            raise ValueError("ids and values must have the same shape")
        with self._lock:
            self._pending_ids.append(ids)
            self._pending_values.append(values)
            self._pending_count += len(ids)
            should_flush = self._pending_count >= self.batch_size
        if should_flush:
            self.flush()

    def flush(self, force: bool = False) -> None:
        """Hand buffered samples to the transfer worker.  Enqueue-only,
        unless ``force`` (collect, close): then it waits until every
        enqueued item has reached the device."""
        self._raise_worker_error()
        with self._lock:
            if self._pending_count:
                ids = np.concatenate(self._pending_ids)
                values = np.concatenate(self._pending_values)
                self._pending_ids, self._pending_values = [], []
                self._pending_count = 0
            else:
                ids = values = None
        if ids is not None:
            kind = "fold" if self.transport == "sparse" else "raw"
            self._enqueue_xfer((kind, ids, values, len(ids)))
        if force:
            self.wait_transfers()
        elif self._xfer_queued_samples > self.max_pending_samples:
            # device slower than producers: wait here (backpressure)
            # rather than let the queue grow without bound
            with self._xfer_cv:
                while (
                    self._xfer_queued_samples > self.max_pending_samples
                    and self._xfer_error is None
                ):
                    self._xfer_cv.wait()
            self._raise_worker_error()

    # -- transfer pipeline ---------------------------------------------- #

    def _enqueue_xfer(self, item: tuple) -> None:
        """Append one (kind, ids, values, n_samples) item to the FIFO,
        lazily (re)spawning the worker thread."""
        with self._xfer_cv:
            if self._xfer_thread is None or not self._xfer_thread.is_alive():
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
                self._process_xfer_item(item)
            except Exception as e:  # surfaced by the next flush/collect
                logger.exception("transfer worker failed on a %s item",
                                 item[0])
                self._xfer_error = e
            finally:
                with self._xfer_cv:
                    self._xfer_queued_samples -= item[3]
                    self._xfer_active = False
                    self._xfer_cv.notify_all()

    def _process_xfer_item(self, item: tuple) -> None:
        kind, ids, values, n = item
        if kind == "fold" or self._maybe_switch_sparse(ids, values, n):
            self._ship_packed(fold_packed_numpy(
                ids, values, self.config.bucket_limit, self.config.precision
            ))
            return
        self._process_raw(ids, values, n)

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
        chosen = dispatch.choose_transport(self.probe_density)
        if chosen != self.transport:
            logger.info(
                "transport auto-probe: cell density %.3f <= crossover "
                "%.3f; switching to the sparse packed-triple transport",
                self.probe_density, dispatch.SPARSE_DENSITY_CROSSOVER,
            )
            self.transport = chosen
        return self.transport == "sparse"

    def _process_raw(self, ids: np.ndarray, values: np.ndarray,
                     n: int) -> None:
        """Raw route: stage each batch_size chunk through the pinned ring
        and launch one ingest step on it, with the spill check per
        chunk (the int32 overflow guarantee)."""
        bs = self.batch_size
        with self._dev_lock:
            if self.paged is not None:
                # K4f: assign codecs and map every page the batch touches
                # BEFORE the upload; ids come back rewritten (pool
                # saturated -> overflow row, or -1 after an exact spill)
                ids, _ = self.paged.prepare_batch(ids, values)
            ring = self._staging_ring
            if ring is None or ring.slot_samples != bs:
                ring = self._staging_ring = IngestStagingRing(bs, self.device)
            bl, prec = self.config.bucket_limit, self.config.precision
            for off in range(0, n, bs):
                ids_dev, values_dev = ring.stage(
                    ids[off:off + bs], values[off:off + bs]
                )
                if self.paged is not None:
                    self.paged.ingest_raw(ids_dev, values_dev)
                else:
                    self._ingest(self._acc, ids_dev, values_dev, bl, prec)
                self._interval_ingested += min(bs, n - off)
                if self._interval_ingested >= self.spill_threshold:
                    self._spill_fold_locked()

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
        weights = packed[:, 2]
        total = int(weights.sum(dtype=np.int64))
        bl = self.config.bucket_limit
        with self._dev_lock:
            if (
                self._interval_ingested + total >= self.spill_threshold
                or int(weights.max()) >= 1 << 30
            ):
                self._spill_fold_locked()
                self._spill_add_cells_locked(
                    packed[:, 0], packed[:, 1], packed[:, 2])
                return
            if self.paged is not None:
                self._interval_ingested += self.paged.commit(packed)
                return
            # one launch per item: there is no per-shape compile to
            # amortize with fixed-size chunks
            sparse_ingest(
                self._acc, torch.from_numpy(packed).to(self.device), bl
            )
            self._interval_ingested += total

    def _spill_add_cells_locked(self, ids, buckets, weights) -> None:
        """Add (id, codec bucket, count) cells to the host int64 spill —
        exact at any magnitude.  Caller holds _dev_lock.  Paged storage
        keeps its spill as the store's sparse host dict."""
        ids = np.asarray(ids, dtype=np.int64)
        keep = (ids >= 0) & (ids < self.num_metrics)
        bl = self.config.bucket_limit
        cols = np.clip(np.asarray(buckets, dtype=np.int64)[keep], -bl, bl) + bl
        weights = np.asarray(weights, dtype=np.int64)[keep]
        if self.paged is not None:
            self.paged.spill_cells(ids[keep], cols, weights)
        else:
            if self._spill is None:
                self._spill = np.zeros(
                    (self.num_metrics, self.config.num_buckets),
                    dtype=np.int64,
                )
            np.add.at(self._spill, (ids[keep], cols), weights)
        self._spilled_samples += int(weights.sum())

    # -- host-tier bridge ----------------------------------------------- #

    def merge_raw(self, raw: RawMetricSet) -> None:
        """Merge one host-tier interval (sparse bucket maps) into the
        device accumulator: the cells are repacked as int32
        (id, codec bucket, count) triples and go through K3 on dense
        storage, or ``PagedStore.commit`` on paged storage.  When the
        interval total would reach ``spill_threshold``, or any weight is
        >= 2^30, the cells go to the exact int64 host spill instead."""
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
        ids_np = np.concatenate(ids)
        bidx_np = np.concatenate(bidx)
        weights_np = np.concatenate(weights)
        bl = self.config.bucket_limit
        with self._dev_lock:
            if (
                self._interval_ingested + int(weights_np.sum())
                >= self.spill_threshold
                or int(weights_np.max()) >= 1 << 30
            ):
                self._spill_fold_locked()
                self._spill_add_cells_locked(ids_np, bidx_np, weights_np)
                return
            # int32 is safe now: the guard bounds every weight below 2^30
            packed = np.empty((len(ids_np), 3), dtype=np.int32)
            packed[:, 0] = ids_np
            packed[:, 1] = np.clip(bidx_np, -bl, bl)
            packed[:, 2] = weights_np
            if self.paged is not None:
                self._interval_ingested += self.paged.commit(packed)
                return
            sparse_ingest(self._acc, torch.from_numpy(packed).to(self.device),
                          bl)
            self._interval_ingested += int(weights_np.sum())

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

        t = threading.Thread(
            target=bridge, daemon=True, name="loghisto-torch-bridge"
        )
        t.start()
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

    def collect(self, reset: bool = True) -> ProcessedMetricSet:
        """Statistics of every registered metric with the reference's
        naming scheme; ``reset`` closes the interval.  Re-raises a
        failure of the attach bridge."""
        self._raise_bridge_error()
        self.flush(force=True)
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
        if self.paged is None:
            stats = self._dense_stats(acc, spill, ps)
        self._last_aggregation_us = (time.perf_counter() - t0) * 1e6
        # Python lists: the per-row naming loop below reads scalars, and
        # list items are several times cheaper than NumPy scalars at a
        # million rows
        nonzero = np.nonzero(stats["counts"])[0]
        counts = stats["counts"][nonzero].tolist()
        sums = stats["sums"][nonzero].astype(np.float64).tolist()
        pcts = stats["percentiles"][nonzero].astype(np.float64).tolist()

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
                nonzero.tolist(), counts, sums, pcts
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
        statistics time, sheds, bridge evictions, spills, and on paged
        storage the pool's occupancy."""
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
        }
        if self.paged is not None:
            st = self.paged
            gauges.update({
                "tpu.PagedOccupiedPages": lambda: float(st.allocated_pages),
                "tpu.PagedHbmBytes": lambda: float(st.hbm_bytes()),
                "tpu.PagedSpilledCells": lambda: float(st.spilled_cells),
                "paging.PoolSaturation": lambda: float(st.pool_saturation()),
                "paging.AllocatedPages": lambda: float(st.allocated_pages),
            })
        for name, fn in gauges.items():
            ms.register_gauge_func(name, fn)

    # -- state ---------------------------------------------------------- #

    def state_dict(self) -> dict:
        """The aggregator's state as host arrays (see state.py): the live
        accumulator (dense) or the store's pool, page table, codecs,
        free list and host spill (paged), the registry's names, the
        lifetime store and the dense spill.  A full barrier first."""
        self.flush(force=True)
        with self._dev_lock, self._agg_lock:
            paged = self.paged is not None
            return {
                "format": STATE_FORMAT,
                "storage": self.storage,
                "bucket_limit": self.config.bucket_limit,
                "precision": self.config.precision,
                "acc": None if paged else self._acc.cpu().numpy().copy(),
                "paged": self.paged.state() if paged else None,
                "names": self.registry.names(),
                "agg": {mid: list(e) for mid, e in self._agg.items()},
                "spill": None if self._spill is None else self._spill.copy(),
            }

    def load_state_dict(self, state: dict) -> None:
        """Replace this aggregator's state with ``state`` (from
        ``state_dict``, ``state.state_from_jax`` or
        ``state.paged_state_from_jax``).  The row space takes the state's
        row count; the ingest path re-resolves for it.  The state's
        storage must be this aggregator's."""
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
        self.flush(force=True)
        with self._dev_lock, self._agg_lock:
            path = self.ingest_path
            if dispatch.ingest_incapability(path, m, self.batch_size):
                path = dispatch.resolve_ingest_path("auto", m, self.batch_size)
            self.registry = MetricRegistry.from_names(state["names"], m)
            self.num_metrics = m
            self.max_metrics = max(self.max_metrics, m)
            self.ingest_path, self._ingest = path, _STEPS[path]
            self._acc = torch.from_numpy(acc).to(self.device)
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

    def _load_paged_state(self, state: dict) -> None:
        """The paged half of ``load_state_dict``: a fresh store at the
        state's pool shape, then its contents."""
        pst = state["paged"]
        pool_shape = np.shape(pst["pool"])
        m = np.shape(pst["page_table"])[0]
        config = dataclasses.replace(
            self.paged_config, pool_pages=pool_shape[0],
            page_size=pool_shape[1],
        )
        store = PagedStore(
            m, self.config.bucket_limit, self.config.precision,
            config=config, device=self.device,
        )
        store.load_state(pst)
        self.flush(force=True)
        with self._dev_lock, self._agg_lock:
            self.paged, self.paged_config = store, config
            self.registry = MetricRegistry.from_names(state["names"], m)
            self.num_metrics = m
            self.max_metrics = max(self.max_metrics, m)
            self._spill = None
            self._interval_ingested = int(pst["pool"].sum(dtype=np.int64))
            self._spilled_samples = int(sum(pst["host_spill"].values()))
            self._agg = {
                int(mid): [e[0], e[1]] for mid, e in state["agg"].items()
            }
