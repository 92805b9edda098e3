"""Built-in process gauges — the analog of the reference's Go runtime gauges
(counterpart of ``loghisto_tpu/utils/sysstats.py``, copied).

The reference registers four gauges when ``sysStats`` is on
(metrics.go:172-193): ``sys.Alloc`` (heap bytes), ``sys.NumGC``,
``sys.PauseTotalNs`` and ``sys.NumGoroutine``.  The Python/TPU equivalents:

  sys.Alloc        -> current RSS bytes (/proc/self/statm)
  sys.NumGC        -> cumulative CPython gc collections (all generations)
  sys.PauseTotalNs -> cumulative wall time spent inside CPython gc passes,
                      measured via gc callbacks (closest analog of Go's
                      stop-the-world pause total)
  sys.NumGoroutine -> live thread count

Device gauges (registered by the aggregator, see parallel/aggregator.py):
``tpu.HbmBytesInUse``, ``tpu.LastAggregationUs`` (names kept from the
reference so dashboards line up; on the port they read the CUDA device).
"""

from __future__ import annotations

import gc
import os
import threading
import time
from typing import Callable, Dict

try:
    _PAGE_SIZE = os.sysconf("SC_PAGE_SIZE")
except (AttributeError, ValueError, OSError):
    _PAGE_SIZE = 4096


def rss_bytes() -> float:
    try:
        with open("/proc/self/statm") as f:
            return float(int(f.read().split()[1]) * _PAGE_SIZE)
    except (OSError, ValueError, IndexError):
        return 0.0


def num_gc() -> float:
    return float(sum(s["collections"] for s in gc.get_stats()))


class _GcPauseTracker:
    """Accumulates wall time spent in gc passes via gc.callbacks."""

    def __init__(self):
        self._lock = threading.Lock()
        self._total_ns = 0
        self._start_ns: int | None = None
        self._installed = False

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start_ns = time.perf_counter_ns()
        elif phase == "stop" and self._start_ns is not None:
            with self._lock:
                self._total_ns += time.perf_counter_ns() - self._start_ns
            self._start_ns = None

    def install(self) -> None:
        with self._lock:
            if not self._installed:
                gc.callbacks.append(self._cb)
                self._installed = True

    def total_ns(self) -> float:
        with self._lock:
            return float(self._total_ns)


_pause_tracker = _GcPauseTracker()


def pause_total_ns() -> float:
    _pause_tracker.install()
    return _pause_tracker.total_ns()


def num_threads() -> float:
    return float(threading.active_count())


def default_gauges() -> Dict[str, Callable[[], float]]:
    """The gauge set registered when sys_stats=True; names kept identical to
    the reference so dashboards and PrintBenchmark output line up."""
    _pause_tracker.install()
    return {
        "sys.Alloc": rss_bytes,
        "sys.NumGC": num_gc,
        "sys.PauseTotalNs": pause_total_ns,
        "sys.NumGoroutine": num_threads,
    }
