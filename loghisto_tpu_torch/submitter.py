"""Submitter: ships serialized metric sets to a TSDB over TCP or UDP
(counterpart of ``loghisto_tpu/submitter.py``).

Reference semantics (submitter.go:33-159):
  * it subscribes to processed metrics behind the subscription boundary;
  * an evicting backlog of 60 slots (the oldest request is dropped when
    it wraps) keeps a dead TSDB from growing memory without bound;
  * a sender loop wakes on interval boundaries and drains the backlog
    head-first, stopping at the first failure;
  * each send is a fresh dial with 5 s connect/write timeouts: delivery
    is best-effort, at-most-once and unacknowledged.

As in the reference's rebuild, one receiver thread serializes on
receipt and one sender thread drains and retries, and the backlog is a
``deque`` with ``maxlen`` (the same evict-oldest rule).  While the
destination is down the sender re-pokes it on a capped-exponential
cadence (``resilience/backoff.Backoff``), and the first success snaps
back to the interval cadence.

``BacklogSender`` is the delivery half alone, for any byte payload;
``Submitter`` adds the subscription and the serializer.  A fault
injector (``fault_injector``, duck-typed: ``check(site)`` raises to
script a failed send at ``fault_site``) is ``None`` by default.
"""

from __future__ import annotations

import logging
import queue
import socket
import threading
import time
from collections import deque
from typing import Callable, Optional

from loghisto_tpu_torch.channel import ChannelClosed, ResilientSubscription
from loghisto_tpu_torch.metrics import MetricSystem, ProcessedMetricSet

logger = logging.getLogger("loghisto_tpu_torch")

BACKLOG_SLOTS = 60
DIAL_TIMEOUT_S = 5.0


def send_once(
    network: str,
    address: tuple[str, int],
    payload: bytes,
    timeout: float = DIAL_TIMEOUT_S,
) -> Optional[Exception]:
    """One best-effort delivery: fresh dial, write, close.  Returns the
    error, if any (never raises for network failures)."""
    try:
        if network == "tcp":
            # create_connection resolves both IPv4 and IPv6.
            with socket.create_connection(address, timeout=timeout) as sock:
                sock.sendall(payload)
        else:
            host, port = address
            family, sock_type, proto, _, addr = socket.getaddrinfo(
                host, port, type=socket.SOCK_DGRAM
            )[0]
            sock = socket.socket(family, sock_type, proto)
            sock.settimeout(timeout)
            try:
                sock.sendto(payload, addr)
            finally:
                sock.close()
        return None
    except OSError as e:
        return e


class BacklogSender:
    """Evicting backlog + fresh-dial best-effort sends + capped-exponential
    retry cadence — the delivery half of the reference submitter, factored
    out so any byte payload (graphite lines, OpenTSDB JSON, federation
    frames) ships through one implementation.

    Payload-agnostic: callers enqueue ready-to-send ``bytes`` via
    ``_append_to_backlog`` (or ``enqueue``, which also wakes the sender).
    The sender thread drains head-first on the ``interval`` cadence,
    switching to the capped-exponential ``backoff`` cadence while the
    destination is down."""

    def __init__(
        self,
        destination_network: str,
        destination_address: tuple[str, int],
        *,
        backlog_slots: int = BACKLOG_SLOTS,
        dial_timeout: float = DIAL_TIMEOUT_S,
        interval: float = 60.0,
        backoff=None,
        fault_site: str = "export.send",
    ):
        if destination_network not in ("tcp", "udp"):
            raise ValueError("destination_network must be 'tcp' or 'udp'")
        self.destination_network = destination_network
        self.destination_address = destination_address
        self.dial_timeout = dial_timeout
        self.interval = float(interval)
        # shared capped-exponential retry cadence: a dead destination is
        # re-poked at growing intervals (capped at the send interval)
        # instead of every interval boundary; the first success snaps
        # back to the interval cadence (resilience/backoff.py)
        if backoff is None:
            from loghisto_tpu_torch.resilience.backoff import Backoff

            backoff = Backoff(
                base_s=min(1.0, self.interval / 4.0 or 0.25),
                cap_s=max(self.interval, 1.0),
            )
        self._backoff = backoff
        self.send_failures = 0
        self.bytes_sent = 0
        # chaos hook: scripted send failures at `fault_site`
        # ("export.send" for the TSDB path, "fed.send" for federation)
        self.fault_injector = None
        self._fault_site = fault_site
        self._backlog: deque[bytes] = deque(maxlen=backlog_slots)
        self._backlog_lock = threading.Lock()
        self._shutdown = threading.Event()
        self._wake = threading.Event()
        self._sender_thread: Optional[threading.Thread] = None

    # -- backlog ------------------------------------------------------- #

    def _append_to_backlog(self, request: bytes) -> None:
        with self._backlog_lock:
            self._backlog.append(request)  # maxlen evicts the oldest

    def enqueue(self, request: bytes) -> None:
        """Append and wake the sender thread (don't wait for the next
        interval boundary) — the flush-now path."""
        self._append_to_backlog(request)
        self._wake.set()

    def retry_backlog(self) -> Optional[Exception]:
        """Drain the backlog head-first; stop at the first failure and
        keep the unsent tail (reference submitter.go:70-93)."""
        while True:
            with self._backlog_lock:
                if not self._backlog:
                    return None
                request = self._backlog[0]
            err = self.submit(request)
            if err is not None:
                return err
            with self._backlog_lock:
                if self._backlog and self._backlog[0] is request:
                    self._backlog.popleft()

    # -- wire ---------------------------------------------------------- #

    def submit(self, request: bytes) -> Optional[Exception]:
        """One best-effort delivery: fresh dial, write, close
        (reference submitter.go:106-116).  Returns the error, if any."""
        inj = self.fault_injector
        if inj is not None:
            try:
                inj.check(self._fault_site)
            except Exception as e:  # injected failures follow the
                self.send_failures += 1  # send_once error contract
                return e
        err = send_once(
            self.destination_network, self.destination_address, request,
            self.dial_timeout,
        )
        if err is not None:
            self.send_failures += 1
        else:
            self.bytes_sent += len(request)
        return err

    # -- sender lifecycle ----------------------------------------------- #

    def _sender_loop(self) -> None:
        interval = self.interval
        while not self._shutdown.is_set():
            err = self.retry_backlog()
            if err is not None:
                logger.debug("submission failed: %s", err)
                # failed sends re-poke on the capped-exponential cadence
                tts = self._backoff.next_delay()
            else:
                self._backoff.reset()
                tts = interval - (time.time() % interval)
            self._wake.wait(timeout=tts)
            self._wake.clear()

    def backlog_depth(self) -> int:
        with self._backlog_lock:
            return len(self._backlog)

    def start_sender(self, name: str = "loghisto-sender") -> None:
        """Spawn the standalone sender thread (callers that manage their
        own threads — the Submitter — drive ``_sender_loop`` directly)."""
        if self._sender_thread is not None:
            return
        self._shutdown.clear()
        self._sender_thread = threading.Thread(
            target=self._sender_loop, daemon=True, name=name
        )
        self._sender_thread.start()

    def stop_sender(self, timeout: float = 5.0) -> None:
        self._shutdown.set()
        self._wake.set()
        t = self._sender_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=timeout)
        self._sender_thread = None


class Submitter(BacklogSender):
    """Receives processed metric sets, serializes them, and attempts
    delivery to `destination_address` with retry from an evicting backlog."""

    def __init__(
        self,
        metric_system: MetricSystem,
        serializer: Callable[[ProcessedMetricSet], bytes],
        destination_network: str,
        destination_address: tuple[str, int],
        backlog_slots: int = BACKLOG_SLOTS,
        dial_timeout: float = DIAL_TIMEOUT_S,
        backoff=None,
    ):
        super().__init__(
            destination_network, destination_address,
            backlog_slots=backlog_slots, dial_timeout=dial_timeout,
            interval=metric_system.interval, backoff=backoff,
            fault_site="export.send",
        )
        self.metric_system = metric_system
        self.serializer = serializer
        # survives strike-eviction: one transient stall must not kill the
        # export path permanently (deliberate improvement over the
        # reference, whose submitter dies with its evicted channel)
        self._metric_chan = ResilientSubscription(
            metric_system.subscribe_to_processed_metrics,
            metric_system.unsubscribe_from_processed_metrics,
            backlog_slots,
        )
        self._threads: list[threading.Thread] = []

    # -- lifecycle ------------------------------------------------------ #

    def _receiver_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                metrics = self._metric_chan.get(timeout=0.1)
            except ChannelClosed:
                return  # shutdown closed the subscription
            except queue.Empty:
                continue  # poll timeout; re-check shutdown
            try:
                self._append_to_backlog(self.serializer(metrics))
            except Exception:
                logger.exception("serializer failed; dropping metric set")

    def register_gauges(self, ms: Optional[MetricSystem] = None) -> None:
        """Export-path health on the ordinary gauge pipeline."""
        ms = ms if ms is not None else self.metric_system
        ms.register_gauge_func(
            "export.RetryBackoffMs", lambda: float(self._backoff.current_ms)
        )
        ms.register_gauge_func(
            "export.SendFailures", lambda: float(self.send_failures)
        )
        ms.register_gauge_func(
            "export.BacklogDepth", lambda: float(self.backlog_depth())
        )
        ms.register_gauge_func(
            "export.BytesSent", lambda: float(self.bytes_sent)
        )

    def start(self) -> None:
        """Spawn the receive/serialize and send/retry threads
        (reference submitter.go:119-149)."""
        if self._threads:
            return
        self._threads = [
            threading.Thread(
                target=self._receiver_loop, daemon=True,
                name="loghisto-submitter-recv",
            ),
            threading.Thread(
                target=self._sender_loop, daemon=True,
                name="loghisto-submitter-send",
            ),
        ]
        for t in self._threads:
            t.start()

    def shutdown(self) -> None:
        """Stop both threads; idempotent (reference submitter.go:152-159)."""
        self._shutdown.set()
        self._wake.set()
        self._metric_chan.close()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=5.0)
        self._threads = []

    # Reference-style aliases.
    Start = start
    Shutdown = shutdown


def new_submitter(
    metric_system: MetricSystem,
    serializer: Callable[[ProcessedMetricSet], bytes],
    destination_network: str,
    destination_address: tuple[str, int],
) -> Submitter:
    """Constructor mirroring the reference's NewSubmitter signature."""
    return Submitter(
        metric_system, serializer, destination_network, destination_address
    )
