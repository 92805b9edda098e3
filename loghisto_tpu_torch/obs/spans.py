"""The commit path's latency store and the disabled span recorder
(counterpart of ``loghisto_tpu/obs/spans.py``: ``LatencyHistogram`` and
``NULL_RECORDER`` only).

``LatencyHistogram`` folds samples through the library's log-bucket
codec into sparse (bucket, count) state and serves percentiles through
the same CDF walk as every other host histogram (``percentiles_sparse``),
so the ``commit.Latency*`` gauges keep the codec's error bound at any
percentile.  ``NULL_RECORDER`` is what the committer's stage sites
(``begin_interval``, ``span``) and the firehose (``record``) hold until
the span ring is ported: each call is a no-op.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np

from loghisto_tpu_torch.config import PRECISION
from loghisto_tpu_torch.ops.codec import compress_np
from loghisto_tpu_torch.ops.stats import percentiles_sparse


class _NullSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_HANDLE = _NullSpan()


class _NullRecorder:
    """Disabled recorder: every site pays a no-op call and nothing more."""

    enabled = False

    def begin_interval(self, seq: Optional[int] = None) -> int:
        return 0 if seq is None else seq

    def span(self, stage: str, seq: Optional[int] = None):
        return _NULL_HANDLE

    def record(self, stage: str, t0_ns: int, t1_ns: int,
               seq: Optional[int] = None) -> None:
        return None


NULL_RECORDER = _NullRecorder()


class LatencyHistogram:
    """Log-bucketed latency store: ``add`` folds one sample, and
    ``percentile(q)`` (q in [0, 100]) walks the CDF of the buckets."""

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

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        """(buckets, counts) copy."""
        with self._lock:
            n = len(self._buckets)
            buckets = np.fromiter(self._buckets.keys(), np.int64, count=n)
            counts = np.fromiter(self._buckets.values(), np.int64, count=n)
        return buckets, counts
