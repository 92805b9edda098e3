"""Self-observability of the port (counterpart of ``loghisto_tpu/obs``):
for now only the commit path's latency histogram and the no-op span
recorder; the span ring, the watchdog and the trace export wait for the
observability slice."""
