"""The port's backlog ``Submitter`` (``loghisto_tpu_torch/submitter.py``)
against the JAX package's: the bytes a TCP listener receives for the same
metric set and serializer are EQUAL, and the backlog, its eviction, the
retry gauges, the error contract of an injected failure and an idempotent
shutdown behave as the reference's tests (``tests/test_export.py``)
require.

Every listener binds port 0.  A wait on a sender thread is an event with
a 30 s deadline; no test asserts a time.
"""

import datetime as dt
import socket
import socketserver
import threading

import pytest

from loghisto_tpu.graphite import graphite_protocol as jax_graphite
from loghisto_tpu.metrics import MetricSystem as JaxMetricSystem
from loghisto_tpu.metrics import ProcessedMetricSet as JaxPMS
from loghisto_tpu.submitter import Submitter as JaxSubmitter
from loghisto_tpu_torch.graphite import graphite_protocol
from loghisto_tpu_torch.metrics import MetricSystem, ProcessedMetricSet
from loghisto_tpu_torch.submitter import (
    BACKLOG_SLOTS,
    BacklogSender,
    Submitter,
    new_submitter,
)

WAIT_S = 30.0
T0 = dt.datetime(2026, 3, 1, 12, 0, tzinfo=dt.timezone.utc)
METRICS = {"reqs_rate": 42.0, "lat_99": 17.25, "lat_count": 1000.0,
           "lat;route=/a_50": 3.5}


class _Collector(socketserver.ThreadingTCPServer):
    """A TCP listener on port 0 that keeps what each connection sent."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, port=0):
        outer = self
        self.received = []
        self.lock = threading.Lock()
        self.got = threading.Event()

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                data = self.rfile.read()
                with outer.lock:
                    outer.received.append(data)
                outer.got.set()

        super().__init__(("127.0.0.1", port), Handler)
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self):
        self.shutdown()
        self.server_close()
        self._thread.join(timeout=WAIT_S)


@pytest.fixture
def collector():
    server = _Collector()
    yield server
    server.close()


def _dead_addr():
    """A port that was just closed: connects are refused at once."""
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    addr = probe.getsockname()
    probe.close()
    return addr


def _delivered(ms, sub, pms, server):
    """Broadcast one processed set to the submitter's subscription (the
    reaper's own broadcast, driven by hand) and wait for the listener."""
    sub.start()
    try:
        ms._update_subscribers()
        with ms._subscribers_lock:
            ms._broadcast(ms._processed_subscribers, pms)
        assert server.got.wait(WAIT_S), "nothing delivered"
    finally:
        sub.shutdown()
    # the sender popped the head once its send returned
    assert sub.backlog_depth() == 0
    with server.lock:
        return b"".join(server.received)


def test_delivered_bytes_equal_the_jax_submitter():
    payloads = []
    for ms_cls, sub_cls, pms_cls, ser in (
        (JaxMetricSystem, JaxSubmitter, JaxPMS, jax_graphite),
        (MetricSystem, Submitter, ProcessedMetricSet, graphite_protocol),
    ):
        server = _Collector()
        try:
            ms = ms_cls(interval=0.05, sys_stats=False)
            sub = sub_cls(ms, lambda p, _s=ser: _s(p, hostname="h"), "tcp",
                          server.server_address)
            payloads.append(_delivered(
                ms, sub, pms_cls(time=T0, metrics=dict(METRICS)), server))
        finally:
            server.close()
    want, got = payloads
    assert got == want
    assert b"cockroach.h.reqs.rate 42.000000 " in got


def test_new_submitter_delivers_a_live_interval(collector):
    ms = MetricSystem(interval=0.05, sys_stats=False)
    sub = new_submitter(ms, graphite_protocol, "tcp",
                        collector.server_address)
    ms.counter("reqs", 42)
    ms.start()
    sub.start()
    try:
        assert collector.got.wait(WAIT_S), "nothing delivered"
    finally:
        sub.shutdown()
        ms.stop()
    with collector.lock:
        payload = b"".join(collector.received).decode()
    assert ".reqs" in payload
    assert sub.bytes_sent >= len(collector.received[0])


def test_backlog_retry_after_outage():
    ms = MetricSystem(interval=0.05, sys_stats=False)
    sub = Submitter(ms, graphite_protocol, "tcp", _dead_addr(),
                    dial_timeout=5.0)
    sub._append_to_backlog(b"first\n")
    sub._append_to_backlog(b"second\n")
    assert sub.retry_backlog() is not None  # the dead destination
    assert list(sub._backlog) == [b"first\n", b"second\n"]
    assert sub.send_failures == 1
    server = _Collector()
    try:
        sub.destination_address = server.server_address
        assert sub.retry_backlog() is None
        assert sub.backlog_depth() == 0
        with server.lock:
            n = len(server.received)
        while n < 2:
            assert server.got.wait(WAIT_S)
            server.got.clear()
            with server.lock:
                n = len(server.received)
        with server.lock:
            assert sorted(server.received) == [b"first\n", b"second\n"]
    finally:
        server.close()
    assert sub.bytes_sent == len(b"first\nsecond\n")


def test_backlog_evicts_the_oldest_past_sixty():
    ms = MetricSystem(interval=0.05, sys_stats=False)
    sub = Submitter(ms, graphite_protocol, "tcp", ("127.0.0.1", 1))
    assert BACKLOG_SLOTS == 60
    for i in range(65):
        sub._append_to_backlog(f"req{i}".encode())
    assert list(sub._backlog) == [f"req{i}".encode() for i in range(5, 65)]
    small = Submitter(ms, graphite_protocol, "tcp", ("127.0.0.1", 1),
                      backlog_slots=3)
    for i in range(5):
        small._append_to_backlog(f"req{i}".encode())
    assert list(small._backlog) == [b"req2", b"req3", b"req4"]


def test_bad_network_is_refused():
    ms = MetricSystem(interval=0.05, sys_stats=False)
    with pytest.raises(ValueError):
        Submitter(ms, graphite_protocol, "carrier-pigeon", ("h", 1))
    with pytest.raises(ValueError):
        BacklogSender("quic", ("h", 1))


def test_shutdown_is_safe_twice(collector):
    ms = MetricSystem(interval=0.05, sys_stats=False)
    sub = new_submitter(ms, graphite_protocol, "tcp",
                        collector.server_address)
    sub.start()
    threads = list(sub._threads)
    assert {t.name for t in threads} == {"loghisto-submitter-recv",
                                         "loghisto-submitter-send"}
    sub.shutdown()
    sub.shutdown()
    assert not any(t.is_alive() for t in threads)
    sub.Shutdown()


def test_backoff_gauges_follow_the_retry_cadence():
    ms = MetricSystem(interval=0.05, sys_stats=False)
    sub = Submitter(ms, graphite_protocol, "tcp", _dead_addr(),
                    dial_timeout=5.0)
    sub.register_gauges()
    raw = ms.collect_raw_metrics()
    for g in ("export.RetryBackoffMs", "export.SendFailures",
              "export.BacklogDepth", "export.BytesSent"):
        assert raw.gauges[g] == 0.0, g
    sub._append_to_backlog(b"x\n")
    assert sub.retry_backlog() is not None
    sub._backoff.next_delay()  # what the sender loop does on a failure
    raw = ms.collect_raw_metrics()
    assert raw.gauges["export.SendFailures"] == 1.0
    assert raw.gauges["export.BacklogDepth"] == 1.0
    assert raw.gauges["export.RetryBackoffMs"] > 0.0
    sub._backoff.reset()
    assert ms.collect_raw_metrics().gauges["export.RetryBackoffMs"] == 0.0


class _StubInjector:
    """The duck-typed fault injector: ``check(site)`` raises for the
    first ``times`` calls."""

    def __init__(self, times):
        self.times = times
        self.sites = []

    def check(self, site):
        self.sites.append(site)
        if len(self.sites) <= self.times:
            raise ConnectionError(f"injected at {site}")


def test_a_stub_injector_follows_the_error_contract(collector):
    ms = MetricSystem(interval=0.05, sys_stats=False)
    sub = Submitter(ms, graphite_protocol, "tcp", collector.server_address)
    assert sub.fault_injector is None
    sub.fault_injector = _StubInjector(times=2)
    assert isinstance(sub.submit(b"x\n"), ConnectionError)
    assert isinstance(sub.submit(b"x\n"), ConnectionError)
    assert sub.send_failures == 2
    assert sub.submit(b"x\n") is None  # the real destination takes over
    assert sub.send_failures == 2
    assert sub.fault_injector.sites == ["export.send"] * 3
    fed = BacklogSender("tcp", collector.server_address, fault_site="fed.send")
    fed.fault_injector = _StubInjector(times=1)
    assert fed.submit(b"y") is not None
    assert fed.fault_injector.sites == ["fed.send"]
