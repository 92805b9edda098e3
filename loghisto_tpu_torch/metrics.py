"""Metric set records (counterpart of ``loghisto_tpu/metrics.py:71-110``).

Only the two interval records and the uint64 mask of the reference's
lifetime store are ported here; the host ``MetricSystem`` comes in a
later slice of the port.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import Dict, Optional

_UINT64_MASK = 0xFFFFFFFFFFFFFFFF


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
