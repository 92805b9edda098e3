"""Interval-scoped span recording (counterpart of
``loghisto_tpu/obs/spans.py``).

``SpanRecorder`` is a fixed-capacity, preallocated, drop-oldest ring of
closed spans.  The hot path, ``record()``, is two ``perf_counter_ns``
reads already taken by the caller plus one counter increment and one
slot store, with no lock: under CPython the ``next()`` on the shared
``itertools.count`` and the single store into the slot list are each
atomic, so the committer's bridge, the transfer worker, the reaper and
query threads record concurrently without coordination.  Capacity is a
power of two so the slot index is a mask, and the ring never allocates
after construction: an old span is overwritten in place.

Every span carries the **interval sequence number** it attributes to.
The reaper mints one per interval (``MetricSystem.collect_raw_metrics``
stamps ``RawMetricSet.seq``) and the committer adopts it at commit time
(``begin_interval``); work off the committer thread (transfer drain,
broadcast, query serving) attributes to ``current_seq``, the latest
interval the pipeline landed.  The stage spans of one commit nest inside
that interval's ``commit.e2e`` span.

``SelfObserver`` re-ingests closed spans as ``obs.<stage>.LatencyUs``
histograms through the system's own ``histogram()``, and
``LatencyHistogram`` keeps samples in the library's log-bucket codec so
the ``commit.LatencyP50Us`` / ``P99Us`` gauges are served by the same
CDF walk as every other host histogram.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from loghisto_tpu_torch.config import PRECISION
from loghisto_tpu_torch.ops.codec import compress_np
from loghisto_tpu_torch.ops.stats import percentiles_sparse


class Span(NamedTuple):
    """One closed span: a pipeline stage, its bounds
    (``perf_counter_ns``), the interval it attributes to, and the
    recording thread's name (the Perfetto track).  ``flow`` is an
    optional cross-process flow id that ``perfetto.merge_traces`` chains
    across trace dumps."""

    stage: str
    start_ns: int
    end_ns: int
    seq: int
    thread: str
    flow: Optional[int] = None

    @property
    def duration_us(self) -> float:
        return (self.end_ns - self.start_ns) / 1e3


@dataclasses.dataclass
class ObsConfig:
    """Observability wiring for ``TorchMetricSystem(observability=...)``.

    ``capacity`` sizes the span ring (rounded up to a power of two);
    ``dogfood`` re-ingests closed spans as ``obs.*`` histograms;
    ``health`` attaches the watchdog and its ``health.*`` gauges;
    ``stall_intervals`` is the no-commit threshold (k in "no commit for
    more than k x interval"); ``backpressure_fraction`` is the
    staging/transfer high-water fraction that counts as backpressure."""

    capacity: int = 4096
    dogfood: bool = True
    health: bool = True
    stall_intervals: float = 3.0
    backpressure_fraction: float = 0.8


class _SpanHandle:
    """Context-manager handle for one in-flight span."""

    __slots__ = ("_rec", "stage", "seq", "flow", "start_ns")

    def __init__(self, rec: "SpanRecorder", stage: str, seq: Optional[int],
                 flow: Optional[int] = None):
        self._rec = rec
        self.stage = stage
        self.seq = seq
        self.flow = flow

    def __enter__(self) -> "_SpanHandle":
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self._rec.record(
            self.stage, self.start_ns, time.perf_counter_ns(), self.seq,
            self.flow,
        )


class _NullHandle:
    """Reusable no-op span handle."""

    __slots__ = ()

    def __enter__(self) -> "_NullHandle":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_HANDLE = _NullHandle()


class SpanRecorder:
    """Lock-free fixed-capacity span ring (see the module docstring)."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        cap = 1 << (int(capacity) - 1).bit_length()
        self.capacity = cap
        self._mask = cap - 1
        self._slots: list = [None] * cap
        self._counter = itertools.count()  # next() is atomic under the GIL
        self._seq_counter = itertools.count(1)
        self.current_seq = 0  # latest interval the pipeline landed
        self.enabled = True

    def begin_interval(self, seq: Optional[int] = None) -> int:
        """Adopt (or mint) the sequence number of the commit that is
        starting: the committer passes ``raw.seq``; a set without one
        (a hand-built set, an old journal line) gets a minted seq."""
        if seq is None:
            seq = next(self._seq_counter)
        self.current_seq = seq
        return seq

    def record(
        self,
        stage: str,
        start_ns: int,
        end_ns: int,
        seq: Optional[int] = None,
        flow: Optional[int] = None,
    ) -> None:
        """Store one closed span: one atomic counter increment, one tuple
        and one masked slot store; slot ``i & mask`` is overwritten."""
        if not self.enabled:
            return
        i = next(self._counter)
        self._slots[i & self._mask] = Span(
            stage, start_ns, end_ns,
            self.current_seq if seq is None else seq,
            threading.current_thread().name,
            flow,
        )

    def span(self, stage: str, seq: Optional[int] = None,
             flow: Optional[int] = None):
        """Context manager that records ``stage`` on exit."""
        if not self.enabled:
            return _NULL_HANDLE
        return _SpanHandle(self, stage, seq, flow)

    def _recorded_estimate(self) -> int:
        # peeking the counter would consume an index: CPython's repr of
        # itertools.count is count(n), n the next value
        r = repr(self._counter)
        return int(r[r.index("(") + 1:-1])

    @property
    def recorded(self) -> int:
        """Lifetime spans recorded."""
        return self._recorded_estimate()

    @property
    def dropped(self) -> int:
        """Spans overwritten before being read (lifetime)."""
        return max(0, self._recorded_estimate() - self.capacity)

    def spans(self) -> Tuple[Span, ...]:
        """A copy of the closed spans, oldest first.  Concurrent records
        may overwrite slots mid-copy (each slot read is atomic)."""
        n = self._recorded_estimate()
        if n <= self.capacity:
            snap = self._slots[:n]
        else:
            head = n & self._mask
            snap = self._slots[head:] + self._slots[:head]
        return tuple(s for s in snap if s is not None)

    def spans_for(self, seq: int) -> Tuple[Span, ...]:
        return tuple(s for s in self.spans() if s.seq == seq)

    def clear(self) -> None:
        """Reset the ring (between phases of a run)."""
        self._slots = [None] * self.capacity
        self._counter = itertools.count()


class _NullRecorder:
    """Disabled recorder: every instrumentation site holds one of these
    by default and pays a no-op call and nothing more."""

    enabled = False
    capacity = 0
    current_seq = 0
    recorded = 0
    dropped = 0

    def begin_interval(self, seq: Optional[int] = None) -> int:
        return 0 if seq is None else seq

    def record(self, *a, **k) -> None:
        pass

    def span(self, stage: str, seq: Optional[int] = None,
             flow: Optional[int] = None):
        return _NULL_HANDLE

    def spans(self) -> Tuple[Span, ...]:
        return ()

    def spans_for(self, seq: int) -> Tuple[Span, ...]:
        return ()

    def clear(self) -> None:
        pass


NULL_RECORDER = _NullRecorder()


def percentile_sparse_host(
    buckets, counts, ps, precision: int = PRECISION
) -> np.ndarray:
    """The reference's torch-free mirror of ``percentiles_sparse``; the
    port's ``ops/stats.percentiles_sparse`` already runs on the host with
    the same selection rule, so this is that function."""
    return percentiles_sparse(np.asarray(buckets), counts, ps, precision)


class LatencyHistogram:
    """Log-bucketed latency store: ``add`` folds one sample through the
    codec into sparse (bucket, count) state, and ``percentile(q)``
    (q in [0, 100]) walks the CDF of the buckets, within the codec's
    relative-error bound at any percentile."""

    def __init__(self, precision: int = PRECISION):
        self.precision = precision
        self._lock = threading.Lock()
        self._buckets: Dict[int, int] = {}
        self.count = 0

    def add(self, value_us: float) -> None:
        b = int(compress_np(np.asarray([value_us]), self.precision)[0])
        with self._lock:
            self._buckets[b] = self._buckets.get(b, 0) + 1
            self.count += 1

    def percentile(self, q: float) -> float:
        buckets, counts = self.snapshot()
        if not len(buckets):
            return 0.0
        return float(percentiles_sparse(
            buckets, counts, np.asarray([q / 100.0]), self.precision
        )[0])

    # the reference's torch-free twin; one selection rule here
    percentile_host = percentile

    def count_above(self, value_us: float) -> int:
        """Samples whose bucket lies strictly above ``value_us``'s bucket
        (the numerator of an SLO "fraction over budget")."""
        b = int(compress_np(np.asarray([value_us]), self.precision)[0])
        with self._lock:
            return sum(c for k, c in self._buckets.items() if k > b)

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        """(buckets, counts) copy."""
        with self._lock:
            n = len(self._buckets)
            buckets = np.fromiter(self._buckets.keys(), np.int64, count=n)
            counts = np.fromiter(self._buckets.values(), np.int64, count=n)
        return buckets, counts


class SelfObserver:
    """After each committed interval the committer hands over that
    interval's closed spans: each becomes one ``obs.<stage>.LatencyUs``
    sample through the system's ``histogram()`` (so exporters, retention
    and the card's aggregation see the pipeline's own latencies like any
    user metric), and ``commit.e2e`` samples also land in
    ``commit_latency``."""

    E2E_STAGE = "commit.e2e"

    def __init__(self, metric_system, recorder: SpanRecorder,
                 precision: int = PRECISION):
        self._ms = metric_system
        self._recorder = recorder
        self.commit_latency = LatencyHistogram(precision)
        self.reingested = 0

    def on_interval(self, seq: int) -> None:
        """Re-ingest the spans that attributed to ``seq`` (the
        committer's bridge thread, after the interval's tail work).
        Exceptions never propagate into the commit path: a failure is
        logged, and ``reingested`` stops growing."""
        try:
            for span in self._recorder.spans_for(seq):
                us = span.duration_us
                if span.stage == self.E2E_STAGE:
                    self.commit_latency.add(us)
                self._ms.histogram(f"obs.{span.stage}.LatencyUs", us)
                self.reingested += 1
        except Exception:
            logging.getLogger("loghisto_tpu_torch").exception(
                "self-observer re-ingest failed"
            )
