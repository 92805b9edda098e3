"""Host-facing MetricSystem: ingest, collection, processing, broadcast
(counterpart of ``loghisto_tpu/metrics.py``).

The rebuild of the reference's layers L2+L3 (metrics.go), batch-oriented:

  * Ingest (``counter``/``histogram``/``start_timer``) appends to
    lock-striped shard buffers — histogram samples are stored raw and
    bucketed once per interval by the vectorized host codec
    (``ops/codec.compress_np``), not per call.
  * The reaper is an interval-aligned daemon thread: swap-and-reset the
    shard buffers, fold counters into the lifetime store, poll gauges,
    broadcast a ``RawMetricSet``, then hand statistic derivation to a
    bounded worker pool which broadcasts the ``ProcessedMetricSet``
    (non-blocking broadcast, strike eviction, whole-interval shedding when
    the pool is saturated — metrics.go:508-653).

Naming, eviction, interval flooring, percentile validation and
``go_compat`` follow the reference exactly; lifetime ``_agg_*`` folding
happens once at collection, as in the reference's deliberate deviation
from Go.

``labels=`` on every recording call dimensions the series: the sample
lands on the canonical row ``name;k1=v1;...`` (sorted keys, so every
order of one label set is one series; ``labels/model.py``), and the
handle factories cache one handle per label set.

The statistics come from the port's own ``ops/stats`` host tier (NumPy,
no device), so this layer loads neither ``jax`` nor the JAX package
(ROADMAP F2).  ``fast_ingest=True`` (the C staging buffers of
``loghisto_tpu/_native``) waits for a later slice of the port and
raises.  The observability span ring is not ported.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import itertools
import logging
import os
import queue
import threading
import time
from array import array
from typing import Callable, Dict, Mapping, Optional

import numpy as np

from loghisto_tpu_torch.channel import Channel
from loghisto_tpu_torch.config import DEFAULT_PERCENTILES, MetricConfig
from loghisto_tpu_torch.labels.model import canonical_name
from loghisto_tpu_torch.ops.codec import compress_np
from loghisto_tpu_torch.ops.stats import percentiles_sparse, summarize_sparse
from loghisto_tpu_torch.utils.sysstats import default_gauges

logger = logging.getLogger("loghisto_tpu_torch")

_UINT64_MASK = 0xFFFFFFFFFFFFFFFF

FAST_INGEST_SLICE = (
    "fast_ingest=True needs the C staging buffers of loghisto_tpu/_native, "
    "which the port takes up in ROADMAP Queue 1 slice 6b (native staging); "
    "use the Python path (fast_ingest=False)"
)
@dataclasses.dataclass
class RawMetricSet:
    """Per-interval raw collection output (reference metrics.go:54-60).

    histograms maps name -> {bucket_index: count} — sparse, full int16
    span, exactly mergeable across systems by elementwise addition.
    ``duration`` is the interval in seconds and ``seq`` the interval
    sequence number (None for hand-built sets).
    """

    time: _dt.datetime
    counters: Dict[str, int]
    rates: Dict[str, int]
    histograms: Dict[str, Dict[int, int]]
    gauges: Dict[str, float]
    duration: Optional[float] = None
    seq: Optional[int] = None


@dataclasses.dataclass
class ProcessedMetricSet:
    """Flat human-readable metrics (reference metrics.go:47-50)."""

    time: _dt.datetime
    metrics: Dict[str, float]


def merge_raw_metric_sets(a: RawMetricSet, b: RawMetricSet) -> RawMetricSet:
    """Merge two RawMetricSets (the same interval collected by two
    processes).  Counters/rates add, histograms merge bucket-wise, gauges
    keep the second argument's value on collision, the earlier timestamp
    wins; a mismatched duration or seq becomes None."""
    counters = dict(a.counters)
    for name, v in b.counters.items():
        counters[name] = counters.get(name, 0) + v
    rates = dict(a.rates)
    for name, v in b.rates.items():
        rates[name] = rates.get(name, 0) + v
    histograms: Dict[str, Dict[int, int]] = {
        name: dict(buckets) for name, buckets in a.histograms.items()
    }
    for name, buckets in b.histograms.items():
        _merge_counts(
            histograms.setdefault(name, {}), buckets.keys(), buckets.values()
        )
    gauges = dict(a.gauges)
    gauges.update(b.gauges)
    return RawMetricSet(
        time=min(a.time, b.time),
        counters=counters,
        rates=rates,
        histograms=histograms,
        gauges=gauges,
        duration=a.duration if a.duration == b.duration else None,
        seq=a.seq if a.seq == b.seq else None,
    )


def _record_duration(system: "MetricSystem", name: str, duration_ns: int) -> int:
    """Shared clock-sample routing for TimerToken and _PyTimer."""
    system.histogram(name, float(duration_ns))
    return duration_ns


class TimerToken:
    """Concurrent named duration timing (reference metrics.go:62-67).
    stop() records the duration as a histogram sample in nanoseconds and
    returns it."""

    __slots__ = ("name", "start_ns", "_system")

    def __init__(self, name: str, system: "MetricSystem"):
        self.name = name
        self._system = system
        self.start_ns = time.perf_counter_ns()

    def stop(self) -> int:
        duration_ns = time.perf_counter_ns() - self.start_ns
        return _record_duration(self._system, self.name, duration_ns)

    def __enter__(self) -> "TimerToken":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    Stop = stop


class _PyTimer:
    """Reusable per-name timer handle: start()/stop(stamp), samples
    routed through histogram()."""

    __slots__ = ("name", "_system")

    def __init__(self, name: str, system: "MetricSystem"):
        self.name = name
        self._system = system

    def start(self) -> int:
        return time.perf_counter_ns()

    def stop(self, start_ns: int) -> int:
        duration_ns = time.perf_counter_ns() - start_ns
        return _record_duration(self._system, self.name, duration_ns)


class _PyRecorder:
    """Reusable per-name histogram recorder: record(value)."""

    __slots__ = ("name", "_system")

    def __init__(self, name: str, system: "MetricSystem"):
        self.name = name
        self._system = system

    def record(self, value: float) -> None:
        self._system.histogram(self.name, value)


class _PyCounter:
    """Reusable per-name counter handle: add(amount)."""

    __slots__ = ("name", "_system")

    def __init__(self, name: str, system: "MetricSystem"):
        self.name = name
        self._system = system

    def add(self, amount: int = 1) -> None:
        self._system.counter(self.name, amount)


class _Shard:
    """One lock stripe of the ingest path: counter dict + histogram
    append-buffers + folded sparse bucket counts.  A metric's raw buffer
    that reaches ``ingest_buffer_cap`` is compressed and folded into
    ``bucket_counts``, bounding memory at O(buckets)."""

    __slots__ = ("lock", "counters", "histograms", "bucket_counts")

    def __init__(self):
        self.lock = threading.Lock()
        self.counters: Dict[str, int] = {}
        self.histograms: Dict[str, array] = {}
        self.bucket_counts: Dict[str, Dict[int, int]] = {}


def _num_default_shards() -> int:
    return max(4, min(64, (os.cpu_count() or 4)))


def _merge_counts(dst: Dict[int, int], buckets, counts) -> None:
    """Fold (bucket, count) pairs into a sparse bucket->count dict."""
    for b, c in zip(buckets, counts):
        b = int(b)
        dst[b] = dst.get(b, 0) + int(c)


class MetricSystem:
    """Collects and distributes metrics (rebuild of reference
    metrics.go:79-195)."""

    def __init__(
        self,
        interval: float = 60.0,
        sys_stats: bool = True,
        config: MetricConfig = MetricConfig(),
        num_shards: Optional[int] = None,
        fast_ingest: bool = False,
    ):
        if interval <= 0:
            raise ValueError("interval must be positive seconds")
        if fast_ingest:
            raise ValueError(FAST_INGEST_SLICE)
        self.interval = float(interval)
        self.config = config
        self._percentiles: Dict[str, float] = dict(DEFAULT_PERCENTILES)

        self._shards = [_Shard() for _ in range(num_shards or _num_default_shards())]
        # threads take shards round-robin through a thread-local
        self._thread_local = threading.local()
        self._shard_counter = itertools.count()
        # one handle per (kind, canonical labeled name), so hot loops pay
        # the label sort and validation once per label set; a race builds
        # a duplicate handle at worst
        self._labeled_handles: Dict[tuple, object] = {}

        # lifetime stores
        self._store_lock = threading.Lock()
        self._counter_store: Dict[str, int] = {}
        # name -> [lifetime_sum, lifetime_count]
        self._histogram_agg_store: Dict[str, list] = {}

        self._gauge_lock = threading.Lock()
        self._gauge_funcs: Dict[str, Callable[[], float]] = {}
        if sys_stats:
            self._gauge_funcs.update(default_gauges())

        # subscription requests queue up and apply at the tick
        self._sub_requests: "queue.Queue[tuple[str, Channel]]" = queue.Queue()
        self._subscribers_lock = threading.Lock()
        self._raw_subscribers: Dict[Channel, int] = {}
        self._processed_subscribers: Dict[Channel, int] = {}

        self._lifecycle_lock = threading.Lock()
        self._shutdown = threading.Event()
        self._reaper_thread: Optional[threading.Thread] = None
        self._interval_seq = itertools.count(1)

    # ------------------------------------------------------------------ #
    # ingest hot path (reference layer L2)
    # ------------------------------------------------------------------ #

    def _shard(self) -> _Shard:
        idx = getattr(self._thread_local, "shard_idx", None)
        if idx is None:
            idx = next(self._shard_counter) % len(self._shards)
            self._thread_local.shard_idx = idx
        return self._shards[idx]

    def counter(
        self, name: str, amount: int = 1,
        labels: Optional[Mapping[str, str]] = None,
    ) -> None:
        """Record ``amount`` occurrences of an event (metrics.go:251-269).
        ``labels`` dimension the counter (the canonical labeled row)."""
        if labels:
            name = canonical_name(name, labels)
        shard = self._shard()
        with shard.lock:
            shard.counters[name] = shard.counters.get(name, 0) + amount

    def histogram(
        self, name: str, value: float,
        labels: Optional[Mapping[str, str]] = None,
    ) -> None:
        """Record one continuous value (metrics.go:273-295); bucketed
        vectorized at the buffer cap or at collection.  ``labels``
        dimension the series (prefer ``recorder(name, labels=...)`` in hot
        loops: it pays the canonicalization once)."""
        if labels:
            name = canonical_name(name, labels)
        shard = self._shard()
        with shard.lock:
            buf = shard.histograms.get(name)
            if buf is None:
                buf = shard.histograms[name] = array("d")
            buf.append(value)
            if len(buf) >= self.config.ingest_buffer_cap:
                self._fold_shard_buffer(shard, name, buf)

    def histogram_batch(
        self, name: str, values,
        labels: Optional[Mapping[str, str]] = None,
    ) -> None:
        """Record many values of one metric in a single call.  A NumPy
        array is appended as one float64 byte copy, not element by
        element."""
        if labels:
            name = canonical_name(name, labels)
        if isinstance(values, np.ndarray):
            raw = np.ascontiguousarray(values, dtype=np.float64).ravel()
        else:
            raw = None
        shard = self._shard()
        with shard.lock:
            buf = shard.histograms.get(name)
            if buf is None:
                buf = shard.histograms[name] = array("d")
            if raw is not None:
                buf.frombytes(raw.tobytes())
            else:
                buf.extend(values)
            if len(buf) >= self.config.ingest_buffer_cap:
                self._fold_shard_buffer(shard, name, buf)

    def _fold_shard_buffer(self, shard: _Shard, name: str, buf: array) -> None:
        """Compress a full raw buffer into the shard's sparse bucket
        counts.  Caller holds shard.lock."""
        values = np.frombuffer(buf, dtype=np.float64)
        buckets = compress_np(values, self.config.precision)
        uniq, cnt = np.unique(buckets, return_counts=True)
        _merge_counts(shard.bucket_counts.setdefault(name, {}), uniq, cnt)
        shard.histograms[name] = array("d")

    def _labeled_handle(self, kind: str, name: str, labels, build):
        """The cached handle of ``kind`` for the canonical labeled name
        (built by ``build(canonical name)`` on first use)."""
        cname = canonical_name(name, labels)
        key = (kind, cname)
        handle = self._labeled_handles.get(key)
        if handle is None:
            handle = build(cname)
            if len(self._labeled_handles) >= 4096:
                self._labeled_handles.clear()
            self._labeled_handles[key] = handle
        return handle

    def start_timer(
        self, name: str, labels: Optional[Mapping[str, str]] = None,
    ) -> TimerToken:
        """Begin a named timing; stop() the returned token (metrics.go:232)."""
        if labels:
            name = canonical_name(name, labels)
        return TimerToken(name, self)

    def timer(
        self, name: str, labels: Optional[Mapping[str, str]] = None,
    ) -> _PyTimer:
        """Reusable per-name timer handle for hot loops; with ``labels``
        one cached handle per label set."""
        if labels:
            return self._labeled_handle("timer", name, labels, self.timer)
        return _PyTimer(name, self)

    def recorder(
        self, name: str, labels: Optional[Mapping[str, str]] = None,
    ) -> _PyRecorder:
        """Reusable per-name histogram recorder for hot loops; with
        ``labels`` one cached handle per label set, so a per-request
        ``recorder("http.latency", labels={"route": r})`` costs one dict
        probe after the first call for each route."""
        if labels:
            return self._labeled_handle("recorder", name, labels,
                                        self.recorder)
        return _PyRecorder(name, self)

    def counter_handle(
        self, name: str, labels: Optional[Mapping[str, str]] = None,
    ) -> _PyCounter:
        """Reusable per-name counter handle for hot loops; with ``labels``
        one cached handle per label set."""
        if labels:
            return self._labeled_handle("counter", name, labels,
                                        self.counter_handle)
        return _PyCounter(name, self)

    def register_gauge_func(self, name: str, f: Callable[[], float]) -> None:
        with self._gauge_lock:
            self._gauge_funcs[name] = f

    def deregister_gauge_func(self, name: str) -> None:
        with self._gauge_lock:
            self._gauge_funcs.pop(name, None)

    def specify_percentiles(self, percentiles: Mapping[str, float]) -> None:
        """Override the default percentile set (metrics.go:197-201).  A
        malformed label template is rejected here."""
        for label in percentiles:
            try:
                rendered = label % "name"
            except (TypeError, ValueError) as e:
                raise ValueError(
                    f"percentile label {label!r} is not a valid %-format "
                    f"template for a metric name: {e}"
                ) from None
            if not isinstance(rendered, str):
                raise ValueError(
                    f"percentile label {label!r} must render to a string"
                )
        self._percentiles = dict(percentiles)

    # ------------------------------------------------------------------ #
    # subscription boundary (reference layer L3)
    # ------------------------------------------------------------------ #

    def subscribe_to_raw_metrics(self, ch: Channel) -> None:
        self._sub_requests.put(("sub_raw", ch))

    def unsubscribe_from_raw_metrics(self, ch: Channel) -> None:
        self._sub_requests.put(("unsub_raw", ch))

    def subscribe_to_processed_metrics(self, ch: Channel) -> None:
        self._sub_requests.put(("sub_processed", ch))

    def unsubscribe_from_processed_metrics(self, ch: Channel) -> None:
        self._sub_requests.put(("unsub_processed", ch))

    def _update_subscribers(self) -> None:
        """Apply queued (un)subscribe requests, once per tick
        (metrics.go:508-525)."""
        with self._subscribers_lock:
            while True:
                try:
                    op, ch = self._sub_requests.get_nowait()
                except queue.Empty:
                    return
                if op == "sub_raw":
                    self._raw_subscribers.setdefault(ch, 0)
                elif op == "unsub_raw":
                    self._raw_subscribers.pop(ch, None)
                elif op == "sub_processed":
                    self._processed_subscribers.setdefault(ch, 0)
                elif op == "unsub_processed":
                    self._processed_subscribers.pop(ch, None)

    def _broadcast(self, subscribers: Dict[Channel, int], item) -> None:
        """Non-blocking delivery with strike eviction (metrics.go:565-581).
        Caller holds _subscribers_lock."""
        evict = []
        for ch in subscribers:
            if ch.closed:
                evict.append(ch)
                continue
            if ch.offer(item):
                subscribers[ch] = 0
            else:
                subscribers[ch] += 1
                logger.error(
                    "a subscriber has allowed their channel to fill up; "
                    "dropping their metrics rather than blocking"
                )
                if subscribers[ch] >= self.config.eviction_strikes:
                    logger.error(
                        "subscriber dropped metrics %d times in a row; "
                        "closing the channel",
                        subscribers[ch],
                    )
                    evict.append(ch)
        for ch in evict:
            del subscribers[ch]
            ch.close()

    # ------------------------------------------------------------------ #
    # collection (metrics.go:420-479)
    # ------------------------------------------------------------------ #

    def _interval_floor(self, now: Optional[float] = None) -> _dt.datetime:
        """Timestamps are floored to interval boundaries (metrics.go:421)."""
        now = time.time() if now is None else now
        ns = int(now * 1e9)
        interval_ns = max(1, int(self.interval * 1e9))
        floored = ns // interval_ns * interval_ns
        return _dt.datetime.fromtimestamp(floored / 1e9, tz=_dt.timezone.utc)

    def collect_raw_metrics(self) -> RawMetricSet:
        ts = self._interval_floor()

        fresh_counters: Dict[str, int] = {}
        hist_buffers: Dict[str, list] = {}
        folded_counts: Dict[str, Dict[int, int]] = {}
        for shard in self._shards:
            with shard.lock:
                counters, shard.counters = shard.counters, {}
                hists, shard.histograms = shard.histograms, {}
                folded, shard.bucket_counts = shard.bucket_counts, {}
            for name, amount in counters.items():
                fresh_counters[name] = fresh_counters.get(name, 0) + amount
            for name, buf in hists.items():
                if len(buf):
                    hist_buffers.setdefault(name, []).append(buf)
            for name, counts in folded.items():
                _merge_counts(
                    folded_counts.setdefault(name, {}),
                    counts.keys(), counts.values(),
                )

        rates = dict(fresh_counters)
        with self._store_lock:
            for name, amount in fresh_counters.items():
                self._counter_store[name] = (
                    self._counter_store.get(name, 0) + amount
                )
            counters = dict(self._counter_store)

        histograms: Dict[str, Dict[int, int]] = folded_counts
        for name, bufs in hist_buffers.items():
            values = np.concatenate(
                [np.frombuffer(b, dtype=np.float64) for b in bufs]
            ) if len(bufs) > 1 else np.frombuffer(bufs[0], dtype=np.float64)
            buckets = compress_np(values, self.config.precision)
            uniq, cnt = np.unique(buckets, return_counts=True)
            _merge_counts(histograms.setdefault(name, {}), uniq, cnt)

        # fold this interval into the lifetime aggregates exactly once,
        # at collection (the sum of decompressed representatives)
        agg_increments = []
        for name, bucket_counts in histograms.items():
            buckets = np.fromiter(bucket_counts.keys(), dtype=np.int64)
            cnt = np.fromiter(bucket_counts.values(), dtype=np.uint64)
            total_sum, total_count = summarize_sparse(
                buckets, cnt, self.config.precision
            )
            sum_inc = int(total_sum) if self.config.go_compat else total_sum
            agg_increments.append((name, sum_inc, total_count))
        with self._store_lock:
            for name, sum_inc, total_count in agg_increments:
                entry = self._histogram_agg_store.setdefault(name, [0, 0])
                entry[0] += sum_inc
                if self.config.go_compat:
                    entry[0] &= _UINT64_MASK
                entry[1] += total_count

        with self._gauge_lock:
            gauge_funcs = dict(self._gauge_funcs)
        gauges = {}
        for name, f in gauge_funcs.items():
            try:
                gauges[name] = float(f())
            except Exception:
                logger.exception("gauge func %r raised; skipping", name)

        return RawMetricSet(
            time=ts,
            counters=counters,
            rates=rates,
            histograms=histograms,
            gauges=gauges,
            duration=self.interval,
            seq=next(self._interval_seq),
        )

    # ------------------------------------------------------------------ #
    # processing (metrics.go:334-418, 481-506)
    # ------------------------------------------------------------------ #

    def _process_histogram(
        self, name: str, bucket_counts: Mapping[int, int]
    ) -> Dict[str, float]:
        out: Dict[str, float] = {}
        buckets = np.fromiter(bucket_counts.keys(), dtype=np.int64)
        counts = np.fromiter(bucket_counts.values(), dtype=np.uint64)
        total_sum, total_count = summarize_sparse(
            buckets, counts, self.config.precision
        )
        out[f"{name}_count"] = float(total_count)
        out[f"{name}_sum"] = total_sum
        out[f"{name}_avg"] = total_sum / total_count if total_count else 0.0

        labels, ps = [], []
        for label, p in self._percentiles.items():
            if not 0.0 <= p <= 1.0:
                logger.error(
                    "unable to calculate percentile %r=%s: must be in [0,1]",
                    label, p,
                )
                continue
            labels.append(label)
            ps.append(p)
        if labels:
            pct = percentiles_sparse(
                buckets, counts, np.asarray(ps), self.config.precision
            )
            for label, value in zip(labels, pct):
                out[label % name] = float(value)
        return out

    def process_metrics(self, raw: RawMetricSet) -> ProcessedMetricSet:
        metrics: Dict[str, float] = {}
        for name, count in raw.counters.items():
            metrics[name] = float(count)
        for name, count in raw.rates.items():
            metrics[f"{name}_rate"] = float(count)
        for name, bucket_counts in raw.histograms.items():
            metrics.update(self._process_histogram(name, bucket_counts))
        metrics.update(raw.gauges)
        return ProcessedMetricSet(time=raw.time, metrics=metrics)

    def _attach_aggregates(
        self, processed: ProcessedMetricSet, raw: RawMetricSet
    ) -> None:
        """Add lifetime ``_agg_{avg,count,sum}`` (metrics.go:589-608)."""
        with self._store_lock:
            snapshot = {
                name: (entry[0], entry[1])
                for name, entry in self._histogram_agg_store.items()
                if name in raw.histograms
            }
        for name, (agg_sum, agg_count) in snapshot.items():
            if agg_count <= 0:
                continue
            if self.config.go_compat:
                avg = float(int(agg_sum) // int(agg_count))
            else:
                avg = agg_sum / agg_count
            processed.metrics[f"{name}_agg_avg"] = avg
            processed.metrics[f"{name}_agg_count"] = float(agg_count)
            processed.metrics[f"{name}_agg_sum"] = float(agg_sum)

    # ------------------------------------------------------------------ #
    # reaper loop (metrics.go:527-653)
    # ------------------------------------------------------------------ #

    def _reaper(self, shutdown: threading.Event) -> None:
        # per-generation queue and shutdown event: a restarted system never
        # inherits stale tasks or sentinels
        process_queue: "queue.Queue[Callable[[], None]]" = queue.Queue(16)
        n_workers = max((os.cpu_count() or 4) // 4, 4)
        workers = [
            threading.Thread(
                target=self._worker, args=(process_queue, shutdown),
                daemon=True, name="loghisto-worker",
            )
            for _ in range(n_workers)
        ]
        for w in workers:
            w.start()
        try:
            while True:
                now = time.time()
                tts = self.interval - (now % self.interval)
                if shutdown.wait(timeout=tts):
                    return
                try:
                    self._tick(process_queue)
                except Exception:
                    logger.exception("reaper tick failed; continuing")
        finally:
            for _ in workers:
                try:
                    process_queue.put(None, timeout=1.0)
                except queue.Full:
                    break  # workers are wedged; they are daemons anyway

    def _tick(self, process_queue: "queue.Queue") -> None:
        raw = self.collect_raw_metrics()
        self._update_subscribers()
        with self._subscribers_lock:
            self._broadcast(self._raw_subscribers, raw)

        def send_processed(raw=raw):
            processed = self.process_metrics(raw)
            self._attach_aggregates(processed, raw)
            with self._subscribers_lock:
                self._broadcast(self._processed_subscribers, processed)

        try:
            process_queue.put_nowait(send_processed)
        except queue.Full:
            # shed the whole interval rather than stall the reaper
            # (metrics.go:630-637)
            logger.error(
                "metric processing is saturated; dropping the %s "
                "interval rather than blocking the reaper",
                raw.time,
            )

    def _worker(
        self, process_queue: "queue.Queue", shutdown: threading.Event
    ) -> None:
        while True:
            try:
                task = process_queue.get(timeout=0.5)
            except queue.Empty:
                if shutdown.is_set():
                    return
                continue
            if task is None:
                return
            try:
                task()
            except Exception:
                logger.exception("metric processing task failed")

    def start(self) -> None:
        """Start the reaper; idempotent while running (metrics.go:644-648)."""
        with self._lifecycle_lock:
            if self._reaper_thread is not None and self._reaper_thread.is_alive():
                return
            self._shutdown = threading.Event()
            self._reaper_thread = threading.Thread(
                target=self._reaper, args=(self._shutdown,),
                daemon=True, name="loghisto-reaper",
            )
            self._reaper_thread.start()

    def stop(self) -> None:
        """Shut the reaper down and join it (metrics.go:651-653)."""
        with self._lifecycle_lock:
            self._shutdown.set()
            t = self._reaper_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)

    # Go-style aliases for drop-in familiarity with the reference API.
    Counter = counter
    Histogram = histogram
    StartTimer = start_timer
    RegisterGaugeFunc = register_gauge_func
    DeregisterGaugeFunc = deregister_gauge_func
    SpecifyPercentiles = specify_percentiles
    SubscribeToRawMetrics = subscribe_to_raw_metrics
    UnsubscribeFromRawMetrics = unsubscribe_from_raw_metrics
    SubscribeToProcessedMetrics = subscribe_to_processed_metrics
    UnsubscribeFromProcessedMetrics = unsubscribe_from_processed_metrics
    Start = start
    Stop = stop
