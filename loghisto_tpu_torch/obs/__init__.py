"""Self-observability of the port (counterpart of ``loghisto_tpu/obs``):
for now only the commit path's latency histogram and the no-op span
recorder, exported here as in the reference; the span ring
(``ObsConfig``, ``Span``, ``SpanRecorder``, ``SelfObserver``), the
watchdog (``HealthReport``, ``HealthWatchdog``) and the trace export
(``trace_events``, ``dump_perfetto``) wait for the observability slice
(ROADMAP Queue 1, 6c)."""

from loghisto_tpu_torch.obs.spans import NULL_RECORDER, LatencyHistogram

__all__ = ["LatencyHistogram", "NULL_RECORDER"]
