"""Self-observability of the port (counterpart of ``loghisto_tpu/obs``):
interval-scoped span tracing, dogfooded latency histograms, the pipeline
health watchdog and Perfetto-compatible trace export.

  * ``spans``: the lock-free fixed-capacity ``SpanRecorder`` ring that
    the committer, aggregator, wheel, lifecycle and drift managers, the
    reaper and the query engine record into, keyed by interval seq;
  * ``SelfObserver``: re-ingests closed spans as
    ``obs.<stage>.LatencyUs`` histograms through ``histogram()``, and
    serves the commit latency from the library's own log buckets;
  * ``health``: ``HealthWatchdog`` turns pipeline invariants into a
    ``HealthReport``, exported as ``health.*`` gauges and the
    ``/healthz`` JSON document;
  * ``perfetto``: dumps the span ring as Chrome ``trace_events`` JSON.

Wired by ``TorchMetricSystem(observability=ObsConfig(...))``.  The
``torch.profiler`` capture of the card's kernels is ``utils/trace.py``.
"""

from loghisto_tpu_torch.obs.spans import (  # noqa: F401
    NULL_RECORDER,
    LatencyHistogram,
    ObsConfig,
    SelfObserver,
    Span,
    SpanRecorder,
)
from loghisto_tpu_torch.obs.health import (  # noqa: F401
    HealthReport,
    HealthWatchdog,
)
from loghisto_tpu_torch.obs.perfetto import (  # noqa: F401
    dump_perfetto,
    trace_events,
)

__all__ = [
    "ObsConfig",
    "Span",
    "SpanRecorder",
    "NULL_RECORDER",
    "LatencyHistogram",
    "SelfObserver",
    "HealthReport",
    "HealthWatchdog",
    "trace_events",
    "dump_perfetto",
]
