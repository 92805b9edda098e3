"""Prometheus exposition-format serializer + pull endpoint (counterpart
of ``loghisto_tpu/prometheus.py``; layer L4).

The reference ships push-style Graphite/OpenTSDB serializers and notes
that output plugins are meant to be easy to add (readme.md:113).  This is
the modern third protocol: the text exposition format served over a pull
endpoint.

Metric names are sanitized per the Prometheus data model (invalid chars
become `_`; a leading digit gets a `_` prefix).  Percentile-labelled
names (`lat_99.9`) are emitted as one `summary`-style family with
`quantile` labels where recognizable; everything else is a gauge.

    from loghisto_tpu_torch.prometheus import PrometheusEndpoint
    PrometheusEndpoint(ms, port=9464).start()   # GET /metrics

With a retention wheel the endpoint also serves sliding-window tails —
``<metric>_w5m{quantile="0.99"}`` — from the wheel's latest snapshot
(the scrape windows are pinned, and a scrape at an unchanged epoch
re-serves the cached bytes):

    ms = TorchMetricSystem(retention=True)
    PrometheusEndpoint(ms, wheel=ms.retention).start()

Labeled rows (``base;k=v``) are written as native exposition labels,
``http_latency{code="500",route="/api",quantile="0.99"}``, with one
``# TYPE`` line per family.  ``/healthz`` and ``/fleetz`` answer as the
reference's endpoint answers a system without a watchdog or federation
tier (the port has neither yet: ROADMAP Queue 1 slices 6c and 14).
"""

from __future__ import annotations

import http.server
import json
import logging
import re
import threading
import urllib.parse
from typing import Optional

from loghisto_tpu_torch.channel import ChannelClosed, ResilientSubscription
from loghisto_tpu_torch.labels.model import parse_canonical, split_processed
from loghisto_tpu_torch.metrics import MetricSystem, ProcessedMetricSet

logger = logging.getLogger("loghisto_tpu_torch")

# /healthz of a system without a watchdog: serving, status unknown
NO_WATCHDOG = {
    "status": "unknown",
    "ok": True,
    "reasons": [{
        "code": "no_watchdog",
        "detail": ("this system has no health watchdog (the port's "
                   "observability slice, ROADMAP Queue 1 slice 6c)"),
        "value": 0.0,
    }],
}

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_QUANTILE_SUFFIX = re.compile(r"^(.*)_(50|75|90|95|99|99\.9|99\.99)$")
_SUFFIX_TO_Q = {
    "50": "0.5", "75": "0.75", "90": "0.9", "95": "0.95",
    "99": "0.99", "99.9": "0.999", "99.99": "0.9999",
}


def _sanitize(name: str) -> str:
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _escape_label_value(value: str) -> str:
    """Exposition-format label-value escaping: backslash, double quote,
    and newline (the canonical grammar forbids all three, but foreign
    names parsed tolerantly may still carry them — escape, never drop)."""
    return (
        value.replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _label_str(pairs) -> str:
    """``(("code","500"),("route","/api"))`` ->
    ``code="500",route="/api"`` — canonical pairs arrive key-sorted, so
    the rendering is deterministic.  Keys are sanitized (dots in the
    canonical key grammar become ``_`` per the Prometheus data model)."""
    return ",".join(
        f'{_sanitize(k)}="{_escape_label_value(v)}"' for k, v in pairs
    )


def prometheus_exposition(
    metric_set: ProcessedMetricSet,
    include_timestamps: bool = False,
) -> bytes:
    """Serialize a ProcessedMetricSet in the text exposition format.
    Usable directly as a Submitter serializer too (push-gateway style).

    Timestamps are omitted by default: explicitly-timestamped samples
    bypass Prometheus staleness handling and eventually get rejected as
    out-of-bounds when re-served from a cache; pass
    include_timestamps=True only for push-style delivery."""
    stamp = (
        f" {int(metric_set.time.timestamp() * 1000)}"
        if include_timestamps else ""
    )
    plain: list[str] = []
    # family -> label-string ("" for flat) -> quantile -> value; one
    # ``# TYPE`` line per family even when several label sets share it
    summaries: dict[str, dict[str, dict[str, float]]] = {}
    for name, value in sorted(metric_set.metrics.items()):
        sp = split_processed(name)
        if sp is not None:
            # labeled row: canonical ``base;k=v`` tail with
            # the processed suffix appended after it — re-emit as native
            # exposition labels, ``http_latency{route="/api"}``
            base, pairs, suffix = sp
            lstr = _label_str(pairs)
            qs = suffix[1:]  # "_99" -> "99"
            body = name[: -len(suffix)] if suffix else name
            if qs in _SUFFIX_TO_Q and f"{body}_count" in metric_set.metrics:
                summaries.setdefault(_sanitize(base), {}).setdefault(
                    lstr, {}
                ).setdefault(_SUFFIX_TO_Q[qs], value)
            else:
                plain.append(
                    f"{_sanitize(base + suffix)}{{{lstr}}} {value}{stamp}"
                )
            continue
        m = _QUANTILE_SUFFIX.match(name)
        # only treat a _NN suffix as a quantile when its histogram-family
        # sibling `<base>_count` exists — a counter named `disk_90` must
        # not masquerade as a latency quantile
        if m and f"{m.group(1)}_count" in metric_set.metrics:
            family = _sanitize(m.group(1))
            q = _SUFFIX_TO_Q[m.group(2)]
            # keep-first on sanitization collisions: duplicate
            # family+quantile samples fail the whole scrape
            summaries.setdefault(family, {}).setdefault(
                "", {}
            ).setdefault(q, value)
        else:
            plain.append(f"{_sanitize(name)} {value}{stamp}")
    lines = []
    for family, by_labels in sorted(summaries.items()):
        lines.append(f"# TYPE {family} summary")
        for lstr, quantiles in sorted(by_labels.items()):
            sep = "," if lstr else ""
            for q, value in sorted(
                quantiles.items(), key=lambda x: float(x[0])
            ):
                lines.append(
                    f'{family}{{{lstr}{sep}quantile="{q}"}} '
                    f"{value}{stamp}"
                )
    lines.extend(plain)
    return ("\n".join(lines) + "\n").encode()


def _window_label(seconds: float) -> str:
    """300 -> "5m", 3600 -> "1h", 90 -> "90s" — the window tag in
    ``<metric>_w5m`` family names."""
    s = int(seconds)
    if s >= 3600 and s % 3600 == 0:
        return f"{s // 3600}h"
    if s >= 60 and s % 60 == 0:
        return f"{s // 60}m"
    return f"{s}s"


def windowed_exposition(
    wheel,
    windows: tuple[float, ...] = (300.0,),
    quantiles: tuple[float, ...] = (0.5, 0.9, 0.99),
    pattern: str = "*",
) -> bytes:
    """Serialize sliding-window statistics from a TimeWheel: one summary
    family per (metric, window) — ``<metric>_w5m{quantile="0.99"}`` plus
    ``_count``/``_sum`` siblings — each window one wheel query.
    The window tag keeps families disjoint from the last-interval
    summaries prometheus_exposition emits for the same metric."""
    lines: list[str] = []
    for window in windows:
        label = _window_label(window)
        res = wheel.query(pattern, window, percentiles=quantiles)
        typed: set[str] = set()
        for name, entry in sorted(res.metrics.items()):
            base, pairs = parse_canonical(name)
            family = f"{_sanitize(base)}_w{label}"
            lstr = _label_str(pairs)
            sep = "," if lstr else ""
            if family not in typed:
                typed.add(family)
                lines.append(f"# TYPE {family} summary")
            for q in quantiles:
                key = f"{q * 100:.4f}".rstrip("0").rstrip(".")
                value = entry[f"p{key}"]
                lines.append(
                    f'{family}{{{lstr}{sep}quantile="{q:g}"}} {value}'
                )
            if lstr:
                lines.append(f"{family}_count{{{lstr}}} {entry['count']}")
                lines.append(f"{family}_sum{{{lstr}}} {entry['sum']}")
            else:
                lines.append(f"{family}_count {entry['count']}")
                lines.append(f"{family}_sum {entry['sum']}")
    if not lines:
        return b""
    return ("\n".join(lines) + "\n").encode()


class PrometheusEndpoint:
    """Pull endpoint: subscribes to processed metrics, caches the latest
    interval, and serves it at GET /metrics.

    With ``wheel=`` (a window.TimeWheel) each scrape also serves
    wheel-backed sliding-window quantiles (`<metric>_w5m{quantile=...}`)
    computed at scrape time, so the pull side sees live window tails,
    not just last-interval values."""

    def __init__(
        self,
        metric_system: MetricSystem,
        port: int = 9464,
        host: str = "0.0.0.0",
        wheel=None,
        windows: tuple[float, ...] = (300.0,),
        window_quantiles: tuple[float, ...] = (0.5, 0.9, 0.99),
    ):
        self._ms = metric_system
        self._addr = (host, port)
        self._wheel = wheel
        self._windows = tuple(windows)
        self._window_quantiles = tuple(window_quantiles)
        if wheel is not None:
            # materialize the scrape windows as commit-time snapshot
            # views, so a scrape serves from the latest snapshot epoch
            # (and repeat scrapes within one interval serve the cached
            # payload with zero device work)
            for w in self._windows:
                wheel.pin_window(w)
        self._windowed_cache: Optional[tuple] = None  # (epoch, payload)
        self._sub: Optional[ResilientSubscription] = None
        self._latest: bytes = b"# no interval collected yet\n"
        self._latest_lock = threading.Lock()
        self._server: Optional[http.server.ThreadingHTTPServer] = None
        self._threads: list[threading.Thread] = []

    def _windowed_payload(self) -> bytes:
        if self._wheel is None:
            return b""
        try:
            # serve the serialized payload straight from the latest
            # snapshot epoch: when no interval has committed since the
            # last scrape, the bytes are returned as-is — zero dispatch,
            # zero reserialization.  A wheel without snapshots (or
            # before its first commit) reports epoch None and falls
            # through to a fresh computation every scrape.
            snap = self._wheel.snapshot
            epoch = snap.epoch if snap is not None else None
            cached = self._windowed_cache
            if cached is not None and epoch is not None \
                    and cached[0] == epoch:
                return cached[1]
            payload = windowed_exposition(
                self._wheel, self._windows, self._window_quantiles
            )
            if epoch is not None:
                self._windowed_cache = (epoch, payload)
            return payload
        except Exception:
            logger.exception("windowed exposition failed; serving "
                             "last-interval metrics only")
            return b""

    @property
    def port(self) -> int:
        return self._server.server_address[1] if self._server else 0

    def start(self) -> None:
        if self._server is not None:
            return
        endpoint = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                path = urllib.parse.urlsplit(self.path).path.rstrip("/")
                if path == "/healthz":
                    self._serve_healthz()
                    return
                if path == "/fleetz":
                    self._serve_fleetz()
                    return
                if path not in ("", "/metrics"):
                    self.send_error(404)
                    return
                with endpoint._latest_lock:
                    payload = endpoint._latest
                payload += endpoint._windowed_payload()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _serve_healthz(self):
                """Pipeline health as JSON; without a watchdog, 200 and
                the ``no_watchdog`` reason."""
                payload = json.dumps(NO_WATCHDOG).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _serve_fleetz(self):
                """The fleet rollup of a federation tier; none here."""
                self.send_error(404, "no federation tier")

            def log_message(self, *args):  # quiet
                pass

        self._server = http.server.ThreadingHTTPServer(self._addr, Handler)
        self._server.daemon_threads = True
        # survives strike-eviction: a starved updater whose channel the
        # reaper closes re-subscribes instead of serving stale data
        self._sub = ResilientSubscription(
            self._ms.subscribe_to_processed_metrics,
            self._ms.unsubscribe_from_processed_metrics,
            8,
        )
        sub = self._sub

        def updater():
            while True:
                try:
                    pms = sub.get()
                except ChannelClosed:
                    return  # stop() closed the subscription
                payload = prometheus_exposition(pms)
                with self._latest_lock:
                    self._latest = payload

        self._threads = [
            threading.Thread(
                target=self._server.serve_forever, daemon=True,
                name="loghisto-prom-http",
            ),
            threading.Thread(
                target=updater, daemon=True, name="loghisto-prom-update"
            ),
        ]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._sub is not None:
            self._sub.close()
            self._sub = None
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
