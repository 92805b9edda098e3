"""The port's label-aware exporters (``graphite.py``, ``opentsdb.py``,
``prometheus.py``) and the retrying push (``resilience/backoff.py``)
against the JAX package's on the same metric sets.

Graphite, OpenTSDB and the instant Prometheus exposition: the same
BYTES.  The windowed exposition over two wheels fed the same intervals:
the same lines with counts EQUAL and quantile values rtol 4e-6, sums
rtol 1e-5 (ROADMAP F1).  ``PrometheusEndpoint`` is served on an
ephemeral loopback port; ``/healthz`` and ``/fleetz`` answer as the JAX
endpoint answers a system without a watchdog or a federation tier.
"""

import datetime as dt
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.graphite import graphite_protocol as jax_graphite
from loghisto_tpu.graphite import (
    make_graphite_serializer as jax_make_graphite_serializer,
)
from loghisto_tpu.labels import LabelIndex as JaxLabelIndex
from loghisto_tpu.metrics import MetricSystem as JaxMetricSystem
from loghisto_tpu.metrics import ProcessedMetricSet as JaxPMS
from loghisto_tpu.opentsdb import opentsdb_protocol as jax_opentsdb
from loghisto_tpu.prometheus import PrometheusEndpoint as JaxEndpoint
from loghisto_tpu.prometheus import prometheus_exposition as jax_exposition
from loghisto_tpu.prometheus import windowed_exposition as jax_windowed
from loghisto_tpu.resilience.backoff import Backoff as JaxBackoff
from loghisto_tpu.resilience.backoff import (
    send_with_backoff as jax_send_with_backoff,
)
from loghisto_tpu.window import TimeWheel as JaxWheel
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.graphite import (
    GraphiteProtocol,
    graphite_protocol,
    make_graphite_serializer,
    push_graphite,
)
from loghisto_tpu_torch.labels import LabelIndex
from loghisto_tpu_torch.metrics import MetricSystem, ProcessedMetricSet
from loghisto_tpu_torch.metrics import RawMetricSet
from loghisto_tpu_torch.opentsdb import opentsdb_protocol, push_opentsdb
from loghisto_tpu_torch.prometheus import (
    PrometheusEndpoint,
    prometheus_exposition,
    windowed_exposition,
)
from loghisto_tpu_torch.resilience import Backoff, send_with_backoff
from loghisto_tpu_torch.window.store import TimeWheel

T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
CANON = "http.latency;code=500;route=/api"
BL = 64


def _metric_sets():
    """Processed metric sets of labeled and flat recordings (every
    processing suffix), plus the pinned names of tests/test_labels.py."""
    ms = MetricSystem(interval=1e6, sys_stats=False)
    rng = np.random.default_rng(3)
    for route in ("/api", "/web"):
        for code in ("200", "500"):
            ms.histogram_batch("http.latency", rng.lognormal(2, 1, 50),
                               labels={"route": route, "code": code})
    ms.histogram_batch("http.latency", rng.lognormal(1, 1, 20))
    ms.counter("hits", 4, labels={"route": "/api"})
    ms.counter("plain.count", 2)
    ms.register_gauge_func("disk_90", lambda: 0.5)
    raw = ms.collect_raw_metrics()
    pms = ms.process_metrics(raw)
    ms._attach_aggregates(pms, raw)
    pinned = {CANON + "_99": 12.5, CANON + "_count": 7.0,
              "http.latency_99": 3.5, "http.latency_count": 2.0,
              "hits;route=/api_rate": 4.0, 'm;k=a"b\\c': 1.0,
              CANON + "_min": 1.0, CANON + "_max": 9.0, "flat.m": 1.0}
    out = []
    for metrics in (pms.metrics, pinned, {**pms.metrics, **pinned}):
        out.append((ProcessedMetricSet(time=T0, metrics=dict(metrics)),
                    JaxPMS(time=T0, metrics=dict(metrics))))
    return out


SETS = _metric_sets()


@pytest.mark.parametrize("labeled_tags", [False, True])
@pytest.mark.parametrize("tags", [None, {"dc": "us", "route": "static"}])
@pytest.mark.parametrize("k", range(len(SETS)))
def test_graphite_bytes_equal_jax(k, tags, labeled_tags):
    pms, jpms = SETS[k]
    for prefix in ("cockroach", "svc"):
        got = graphite_protocol(pms, prefix, "h", tags, labeled_tags)
        assert got == jax_graphite(jpms, prefix, "h", tags, labeled_tags)
    ser = make_graphite_serializer("p", "h", tags, labeled_tags)
    jser = jax_make_graphite_serializer("p", "h", tags, labeled_tags)
    assert ser(pms) == jser(jpms)
    assert GraphiteProtocol is graphite_protocol


def test_graphite_labeled_tags_pinned():
    pms = ProcessedMetricSet(time=T0, metrics={CANON + "_99": 12.5,
                                               CANON + "_max": 2.0,
                                               "flat.m": 1.0})
    legacy = graphite_protocol(pms, hostname="h").decode()
    assert ("cockroach.h.http.latency;code=500;route=/api.99 "
            "12.500000 1767225600\n") in legacy
    tagged = graphite_protocol(pms, hostname="h", labeled_tags=True).decode()
    assert ("cockroach.h.http.latency.99;code=500;route=/api "
            "12.500000 1767225600\n") in tagged
    assert "cockroach.h.http.latency.max;code=500;route=/api" in tagged
    assert ";route=/api_max" not in tagged
    assert "cockroach.h.flat.m 1.000000 1767225600\n" in tagged
    with pytest.raises(ValueError, match="invalid graphite tag"):
        make_graphite_serializer(tags={"a;b": "1"})


@pytest.mark.parametrize("labeled_tags", [False, True])
@pytest.mark.parametrize("tags", [None, {"host": "h", "route": "static"}])
@pytest.mark.parametrize("k", range(len(SETS)))
def test_opentsdb_bytes_equal_jax(k, tags, labeled_tags):
    pms, jpms = SETS[k]
    got = opentsdb_protocol(pms, tags, "h", labeled_tags)
    assert got == jax_opentsdb(jpms, tags, "h", labeled_tags)


def test_opentsdb_labeled_tags_pinned():
    pms = ProcessedMetricSet(time=T0, metrics={CANON + "_count": 7.0,
                                               "flat.m": 1.0})
    tagged = opentsdb_protocol(pms, hostname="h", labeled_tags=True).decode()
    assert ("put http.latency_count 1767225600 7.000000 "
            "host=h code=500 route=/api\n") in tagged
    assert "put flat.m 1767225600 1.000000 host=h\n" in tagged


@pytest.mark.parametrize("stamps", [False, True])
@pytest.mark.parametrize("k", range(len(SETS)))
def test_prometheus_exposition_bytes_equal_jax(k, stamps):
    pms, jpms = SETS[k]
    assert prometheus_exposition(pms, stamps) == jax_exposition(jpms, stamps)


def test_prometheus_labeled_exposition_pinned():
    lines = prometheus_exposition(SETS[1][0]).decode().splitlines()
    assert lines.count("# TYPE http_latency summary") == 1
    assert ('http_latency{code="500",route="/api",quantile="0.99"} '
            "12.5") in lines
    assert 'http_latency{quantile="0.99"} 3.5' in lines
    assert 'http_latency_count{code="500",route="/api"} 7.0' in lines
    assert 'hits_rate{route="/api"} 4.0' in lines
    assert 'm{k="a\\"b\\\\c"} 1.0' in lines


# -- the windowed exposition over two wheels fed the same intervals ----------


def _intervals(n, seed):
    rng = np.random.default_rng(seed)
    names = [f"rpc.latency;code={c};route=/r{r}" for r in range(3)
             for c in (200, 500)] + ["rpc.latency", "db.q;shard=1"]
    out = []
    for i in range(n):
        hists = {}
        for name in names:
            k = int(rng.integers(1, 8))
            hists[name] = {int(b): int(c) for b, c in zip(
                rng.integers(0, BL, k), rng.integers(1, 200, k))}
        out.append(RawMetricSet(time=T0 + dt.timedelta(seconds=i),
                                counters={}, rates={}, histograms=hists,
                                gauges={}, duration=1.0))
    return out


def _parse_exposition(payload):
    """{(sample name, label string): value} and the TYPE lines."""
    samples, types = {}, []
    for line in payload.decode().splitlines():
        if line.startswith("# TYPE"):
            types.append(line)
            continue
        head, value = line.rsplit(" ", 1)
        name, _, labels = head.partition("{")
        samples[(name, labels.rstrip("}"))] = float(value)
    return samples, types


@pytest.fixture(scope="module")
def wheels():
    jw = JaxWheel(num_metrics=16, config=JaxConfig(bucket_limit=BL),
                  interval=1.0, tiers=((4, 1), (3, 2)), merge_path="jnp")
    pw = TimeWheel(num_metrics=16, config=MetricConfig(bucket_limit=BL),
                   interval=1.0, tiers=((4, 1), (3, 2)), device="cpu")
    jw.label_index = JaxLabelIndex(jw.registry)
    pw.label_index = LabelIndex(pw.registry)
    for raw in _intervals(7, seed=2):
        jw.push(raw)
        pw.push(raw)
    return jw, pw


@pytest.mark.parametrize("pattern", ["*", "rpc.latency{code=500}"])
def test_windowed_exposition_equals_jax(wheels, pattern):
    jw, pw = wheels
    args = dict(windows=(2.0, 8.0, 60.0), quantiles=(0.5, 0.9, 0.99),
                pattern=pattern)
    got, gtypes = _parse_exposition(windowed_exposition(pw, **args))
    want, wtypes = _parse_exposition(jax_windowed(jw, **args))
    assert gtypes == wtypes and got.keys() == want.keys()
    for key, value in want.items():
        rtol = 0 if key[0].endswith("_count") else (
            1e-5 if key[0].endswith("_sum") else 4e-6)
        np.testing.assert_allclose(got[key], value, rtol=rtol, err_msg=key)
    # one family per window; every labeled series with its labels
    assert sum(t.startswith("# TYPE rpc_latency_w") for t in gtypes) == 3
    if pattern == "*":
        assert ("rpc_latency_w8s_count",
                'code="500",route="/r1"') in got
        assert ("rpc_latency_w8s_count", "") in got
        res = pw.query("*", 8.0)
        assert got[("rpc_latency_w8s_count", 'code="500",route="/r1"')] == \
            res.metrics["rpc.latency;code=500;route=/r1"]["count"]


# -- the pull endpoint -------------------------------------------------------


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5.0) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _serve(endpoint_cls, ms, wheel):
    ep = endpoint_cls(ms, port=0, host="127.0.0.1", wheel=wheel,
                      windows=(4.0,))
    ep.start()
    return ep, f"http://127.0.0.1:{ep.port}"


def test_endpoint_serves_metrics_healthz_and_fleetz_like_jax(wheels):
    jw, pw = wheels
    ms = MetricSystem(interval=0.05, sys_stats=False)
    jms = JaxMetricSystem(interval=0.05, sys_stats=False)
    ep, url = _serve(PrometheusEndpoint, ms, pw)
    jep, jurl = _serve(JaxEndpoint, jms, jw)
    try:
        assert 4.0 in pw.pinned_windows()
        for system in (ms, jms):
            system.start()
        deadline = time.monotonic() + 10.0
        while True:
            # /metrics serves the last interval: record into every one
            ms.histogram("http.latency", 3.0,
                         labels={"route": "/api", "code": "500"})
            status, body = _get(url + "/metrics")
            if b"http_latency{" in body:
                break
            assert time.monotonic() < deadline, body
            time.sleep(0.01)
        assert status == 200
        assert b'http_latency_count{code="500",route="/api"} ' in body
        assert b"# TYPE rpc_latency_w4s summary" in body
        # the windowed part is re-served from the snapshot epoch's cache
        assert ep._windowed_cache[0] == pw.snapshot.epoch
        assert _get(url + "/metrics")[1].endswith(ep._windowed_cache[1])
        for path in ("/healthz", "/fleetz", "/nope"):
            (st, b), (jst, jb) = _get(url + path), _get(jurl + path)
            assert st == jst, path
            if path == "/healthz":
                got, want = json.loads(b), json.loads(jb)
                assert st == 200
                assert {k: got[k] for k in ("status", "ok")} == {
                    k: want[k] for k in ("status", "ok")}
                assert [r["code"] for r in got["reasons"]] == [
                    r["code"] for r in want["reasons"]] == ["no_watchdog"]
            else:
                assert st == 404
    finally:
        for system in (ms, jms):
            system.stop()
        ep.stop()
        jep.stop()
    assert ep.port == 0 and not ep._threads


# -- retrying pushes ---------------------------------------------------------


def _refusing_address():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = s.getsockname()
    s.close()
    return addr


def test_send_with_backoff_against_a_refusing_address_like_jax():
    addr = _refusing_address()
    bo, jbo = Backoff(base_s=0.001, cap_s=0.004, seed=1), \
        JaxBackoff(base_s=0.001, cap_s=0.004, seed=1)
    err = send_with_backoff("tcp", addr, b"x", attempts=3, backoff=bo)
    jerr = jax_send_with_backoff("tcp", addr, b"x", attempts=3, backoff=jbo)
    assert type(err) is type(jerr) and isinstance(err, OSError)
    assert bo.attempt == jbo.attempt == 2
    assert bo.current_ms == jbo.current_ms
    assert push_graphite(addr, SETS[0][0], attempts=2,
                         backoff=Backoff(base_s=0.001)) is not None
    assert push_opentsdb(addr, SETS[0][0], attempts=1) is not None


def test_backoff_delays_equal_jax():
    bo, jbo = Backoff(seed=7), JaxBackoff(seed=7)
    assert [bo.next_delay() for _ in range(9)] == [
        jbo.next_delay() for _ in range(9)]
    bo.reset()
    assert bo.attempt == 0 and bo.current_s == 0.0
    with pytest.raises(ValueError, match="backoff wants"):
        Backoff(base_s=0.0)


def test_pushes_deliver_the_serializers_bytes():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    got = []

    def accept(n):
        for _ in range(n):
            conn, _ = srv.accept()
            with conn:
                data = b""
                while chunk := conn.recv(65536):
                    data += chunk
                got.append(data)

    t = threading.Thread(target=accept, args=(2,), daemon=True)
    t.start()
    try:
        pms = SETS[2][0]
        addr = srv.getsockname()
        assert push_graphite(addr, pms, hostname="h",
                             labeled_tags=True) is None
        assert push_opentsdb(addr, pms, hostname="h",
                             labeled_tags=True) is None
        t.join(timeout=10.0)
        assert not t.is_alive()
    finally:
        srv.close()
    assert got == [graphite_protocol(pms, hostname="h", labeled_tags=True),
                   opentsdb_protocol(pms, hostname="h", labeled_tags=True)]
