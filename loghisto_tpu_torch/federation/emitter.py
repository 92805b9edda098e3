"""FederationEmitter: the frontend half of the federation tier
(counterpart of ``loghisto_tpu/federation/emitter.py``).

Runs inside any process (a web frontend, a worker, a sidecar) and
imports no torch: its whole import path is NumPy and the host tier
(``ops/fold.py``, the frame codec of ``ops/codec.py``,
``obs/spans.py``, ``submitter.py``), and ``tests/test_torch_isolation.py``
holds it to that in a fresh process.  Once an interval it folds what was
recorded since the last flush into packed ``[n, 3]`` int32 triples in
EMITTER-LOCAL id space, puts the names not yet shipped before them,
frames the payload (``wire.py`` on ``ops/codec.encode_frame``) and hands
the frame to a ``submitter.BacklogSender``: the evicting backlog,
capped-exponential backoff and fresh dial of the TSDB submitter,
pointed at the aggregator host's ``FederationReceiver``.

Delivery: at least once from the backlog (a frame is popped only after
a send succeeded; the receiver deduplicates by sequence number), and
shed rather than block when the receiver stays down long enough to wrap
the backlog (the receiver's gap count shows how many frames died so).

Two recording surfaces:

  * direct: ``record(name, value)`` / ``record_batch(local_ids,
    values)`` with ids from ``local_id(name)``;
  * wrapped: ``attach(metric_system)`` subscribes to a host
    ``MetricSystem``'s raw broadcast and re-ships every interval's
    histograms (already codec buckets) as cells, so an application's
    recorders federate without touching their call sites.

The frames equal the JAX emitter's byte for byte for the same records,
``emitter_id`` and clocks (the fold is the same float64 codec, and
``ops/fold.fold_packed`` orders its cells as the reference's does).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import numpy as np

from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.federation import wire
from loghisto_tpu_torch.labels.model import canonical_name
from loghisto_tpu_torch.obs.spans import LatencyHistogram, SpanRecorder
from loghisto_tpu_torch.ops.codec import encode_frame
from loghisto_tpu_torch.ops.fold import fold_packed, pack_cells
from loghisto_tpu_torch.submitter import BACKLOG_SLOTS, BacklogSender


class FederationEmitter:
    def __init__(
        self,
        address: tuple[str, int],
        network: str = "tcp",
        interval: float = 1.0,
        config: MetricConfig = MetricConfig(),
        emitter_id: Optional[int] = None,
        backlog_slots: int = 4 * BACKLOG_SLOTS,
        dial_timeout: float = 5.0,
        backoff=None,
        fault_injector=None,
        wire_version: int = 2,
        obs_capacity: int = 1024,
        restarts: int = 0,
    ):
        """``address`` is the receiver's (host, port).  ``interval`` is
        the flush/ship cadence.  ``config`` must agree with the
        aggregator's on precision (the fold runs the shared float64
        codec, so matching precision makes the federated aggregate equal
        to recording the same samples locally); bucket indices are
        clipped to ``bucket_limit`` at fold time like every other
        transport.  ``backlog_slots`` defaults wider than the TSDB
        submitter's 60 — a federation frame is an interval of unique
        cells, cheap to hold, expensive to lose.

        ``wire_version`` picks the frame kind: 2 (default) stamps every
        frame with capture timestamps and piggybacks a health summary
        at most once per ``health_interval_s`` (frames in between carry
        an empty health blob and the receiver keeps the last one — the
        summary changes at ~1 Hz, while the JSON encode/decode per
        frame is the dominant wire-v2 cost at high frame rates); 1
        emits the v1 format for old receivers.  ``restarts`` seeds
        the restart counter shipped in the health summary (a supervisor
        that respawns this process passes its attempt count)."""
        if wire_version not in (1, 2):
            raise ValueError(f"wire_version must be 1 or 2, got {wire_version}")
        self.config = config
        self.wire_version = int(wire_version)
        self.interval = float(interval)
        self.emitter_id = (
            int(emitter_id) if emitter_id is not None
            else int.from_bytes(os.urandom(8), "little") or 1
        )
        self._sender = BacklogSender(
            network, address,
            backlog_slots=backlog_slots, dial_timeout=dial_timeout,
            interval=self.interval, backoff=backoff, fault_site="fed.send",
        )
        self._sender.fault_injector = fault_injector
        self.fault_injector = fault_injector
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()
        self._names: dict[str, int] = {}     # name -> emitter-local id
        self._names_unsent: list[tuple[int, str]] = []
        self._staged_ids: list[np.ndarray] = []
        self._staged_values: list[np.ndarray] = []
        self._staged_cells: list[np.ndarray] = []  # pre-bucketed [n,3]
        self._seq = 0
        self.samples_recorded = 0
        self.frames_shipped = 0
        self.samples_shipped = 0
        self._ticker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._attached = None  # (ResilientSubscription, thread)
        # fleet-observability plane: capture stamps for the interval in
        # flight (first staged sample since the last flush; None when
        # nothing landed yet), an own span ring (torch-free, like
        # everything else on this path), and per-stage latency
        # histograms whose p99s ride in the health summary
        self._capture_mono_ns: Optional[int] = None
        self._capture_wall_ns: Optional[int] = None
        self.obs = SpanRecorder(obs_capacity)
        self.stage_latency = {
            "fold": LatencyHistogram(config.precision),
            "encode": LatencyHistogram(config.precision),
        }
        self.restarts = int(restarts)
        self._started_mono = time.monotonic()
        # health piggyback cadence: the summary rides at most this often
        # (0 ships it on every frame, as chaos drills want)
        self.health_interval_s = 1.0
        self._health_shipped_mono = float("-inf")

    # -- recording ------------------------------------------------------ #

    def local_id(self, name: str) -> int:
        """Emitter-local dense id for ``name`` (registers on first use
        and queues the name for the next frame's dictionary delta)."""
        with self._lock:
            lid = self._names.get(name)
            if lid is None:
                lid = len(self._names)
                self._names[name] = lid
                self._names_unsent.append((lid, name))
            return lid

    def record(self, name: str, value: float, labels=None) -> None:
        """``labels`` (optional mapping) canonicalizes AT RECORD TIME:
        every permutation of the same label set becomes one
        canonical ``name;k=v`` string and therefore ONE emitter-local
        id, one dictionary-delta row, one aggregator registry row.  The
        wire dictionary ships the canonical name as an opaque string —
        no federation format change."""
        if labels:
            name = canonical_name(name, labels)
        self.record_batch(
            np.array([self.local_id(name)], dtype=np.int32),
            np.array([value], dtype=np.float32),
        )

    def record_batch(self, ids: np.ndarray, values: np.ndarray) -> None:
        """Stage a batch of (emitter-local id, value) samples for the
        next flush.  O(1) list append — the fold runs at flush time."""
        ids = np.asarray(ids, dtype=np.int32)
        values = np.asarray(values, dtype=np.float32)
        if ids.shape != values.shape:
            raise ValueError("ids and values must have the same shape")
        with self._lock:
            if self._capture_mono_ns is None:
                self._stamp_capture_locked()
            self._staged_ids.append(ids)
            self._staged_values.append(values)
            self.samples_recorded += len(ids)

    # -- wrapping a host MetricSystem ----------------------------------- #

    def attach(self, metric_system) -> None:
        """Subscribe to ``metric_system``'s raw broadcast and re-ship
        every interval's histograms.  The host tier already folded each
        histogram to sparse codec buckets, so this path stages cells
        directly (clipped to this emitter's bucket_limit) instead of
        re-folding samples."""
        if self._attached is not None:
            return
        from loghisto_tpu_torch.channel import (
            ChannelClosed, ResilientSubscription,
        )

        ch = ResilientSubscription(
            metric_system.subscribe_to_raw_metrics,
            metric_system.unsubscribe_from_raw_metrics,
            16,
        )

        def _drain() -> None:
            while True:
                try:
                    raw = ch.get()
                except ChannelClosed:
                    return
                self.stage_raw(raw)

        t = threading.Thread(
            target=_drain, daemon=True, name="loghisto-fed-wrap"
        )
        t.start()
        self._attached = (ch, t)

    def stage_raw(self, raw) -> None:
        """Stage one RawMetricSet's histograms as pre-bucketed cells."""
        bl = self.config.bucket_limit
        for name, buckets in raw.histograms.items():
            if not buckets:
                continue
            lid = self.local_id(name)
            b = np.clip(
                np.fromiter(buckets.keys(), dtype=np.int64,
                            count=len(buckets)),
                -bl, bl,
            )
            c = np.fromiter(buckets.values(), dtype=np.int64,
                            count=len(buckets))
            cells = pack_cells(np.full(len(b), lid, dtype=np.int64), b, c)
            with self._lock:
                if self._capture_mono_ns is None:
                    self._stamp_capture_locked()
                self._staged_cells.append(cells)
                self.samples_recorded += int(c.sum())

    # -- clocks / health -------------------------------------------------- #

    def _wall_ns(self) -> int:
        """Wall clock for wire stamps; honors an injected ``clock_step``
        offset so chaos drills can step this emitter's wall clock
        without touching the host."""
        ns = time.time_ns()
        inj = self.fault_injector
        if inj is not None:
            off = getattr(inj, "clock_offset", None)
            if off is not None:
                ns += int(off() * 1e9)
        return ns

    def _stamp_capture_locked(self) -> None:
        self._capture_mono_ns = time.monotonic_ns()
        self._capture_wall_ns = self._wall_ns()

    def health_summary(self) -> dict:
        """Compact health summary piggybacked on every v2 frame: stage
        p99s (the host percentile rule of ``obs/spans.py``, torch-free),
        backlog depth, send failures, restart count, and
        uptime.  A few hundred bytes of JSON per frame."""
        return {
            "p99_us": {
                stage: round(hist.percentile_host(99.0), 1)
                for stage, hist in self.stage_latency.items()
            },
            "backlog": self._sender.backlog_depth(),
            "fail": self._sender.send_failures,
            "restarts": self.restarts,
            "up_s": round(time.monotonic() - self._started_mono, 1),
            "frames": self.frames_shipped,
            "samples": self.samples_shipped,
        }

    # -- flush / ship --------------------------------------------------- #

    def flush(self, heartbeat: bool = True) -> int:
        """Fold everything staged into one DELTA frame and enqueue it
        for sending.  Returns the number of samples in the frame.  With
        ``heartbeat`` (default) an empty interval still ships a zero-row
        frame — the receiver's per-emitter lag gauge and the
        ``emitter_starvation`` invariant feed on frame arrival times, so
        an idle emitter must stay audible."""
        # one flush at a time: concurrent flushes could enqueue their
        # frames out of seq order, and the receiver would shed the
        # late-arriving lower seq as a duplicate
        with self._flush_lock:
            return self._flush_locked(heartbeat)

    def _flush_locked(self, heartbeat: bool) -> int:
        inj = self.fault_injector
        if inj is not None:
            inj.check("fed.flush")
        flush_t0 = time.perf_counter_ns()
        with self._lock:
            ids = self._staged_ids
            values = self._staged_values
            cells = self._staged_cells
            names = self._names_unsent
            mono_ns = self._capture_mono_ns
            wall_ns = self._capture_wall_ns
            self._staged_ids, self._staged_values = [], []
            self._staged_cells = []
            self._names_unsent = []
            self._capture_mono_ns = None
            self._capture_wall_ns = None
        # this seq is ours: _seq only advances under _flush_lock, which
        # the caller holds — so the flow id can label the fold/encode
        # spans before the frame exists
        seq = self._seq + 1
        flow = wire.fed_flow_id(self.emitter_id, seq)
        fold_t0 = time.perf_counter_ns()
        parts = list(cells)
        if ids:
            parts.append(fold_packed(
                np.concatenate(ids), np.concatenate(values),
                self.config.bucket_limit, self.config.precision,
            ))
        parts = [p for p in parts if len(p)]
        if parts:
            packed = parts[0] if len(parts) == 1 else np.concatenate(parts)
        else:
            if not heartbeat and not names:
                return 0
            packed = np.empty((0, 3), dtype=np.int32)
        fold_t1 = time.perf_counter_ns()
        self.obs.record("fed.fold", fold_t0, fold_t1, seq, flow)
        self.stage_latency["fold"].add((fold_t1 - fold_t0) / 1e3)
        self._seq = seq
        # empty heartbeats stamp at flush time: there was no first
        # sample, so "capture" degenerates to "now" and the freshness
        # sample measures pure pipeline latency
        if mono_ns is None:
            mono_ns = time.monotonic_ns()
            wall_ns = self._wall_ns()
        enc_t0 = time.perf_counter_ns()
        if self.wire_version >= 2:
            health = None
            now_mono = time.monotonic()
            if now_mono - self._health_shipped_mono >= self.health_interval_s:
                health = self.health_summary()
                self._health_shipped_mono = now_mono
            payload = wire.encode_delta2(
                self.emitter_id, seq, names, packed,
                mono_ns, wall_ns, health,
            )
            kind = wire.KIND_DELTA2
        else:
            payload = wire.encode_delta(self.emitter_id, seq, names, packed)
            kind = wire.KIND_DELTA
        frame = encode_frame(kind, payload)
        enc_t1 = time.perf_counter_ns()
        self.obs.record("fed.encode", enc_t0, enc_t1, seq, flow)
        self.stage_latency["encode"].add((enc_t1 - enc_t0) / 1e3)
        self._sender.enqueue(frame)
        samples = int(packed[:, 2].sum(dtype=np.int64))
        self.frames_shipped += 1
        self.samples_shipped += samples
        self.obs.record(
            "fed.flush", flush_t0, time.perf_counter_ns(), seq, flow
        )
        return samples

    def drain(self, timeout: float = 10.0) -> bool:
        """Retry until the backlog is empty or ``timeout`` passes.
        Returns True when every enqueued frame was handed to the socket
        — the emitter-side half of exact conservation."""
        deadline = time.monotonic() + timeout
        while True:
            self._sender.retry_backlog()
            if self._sender.backlog_depth() == 0:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(min(0.05, self.interval / 4.0))

    # -- lifecycle ------------------------------------------------------ #

    def _ticker_loop(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(
                timeout=self.interval - (time.time() % self.interval)
            )
            if self._stop.is_set():
                return
            self.flush()

    def start(self) -> None:
        """Spawn the sender thread and the per-interval flush ticker."""
        self._sender.start_sender("loghisto-fed-send")
        if self._ticker is None or not self._ticker.is_alive():
            self._stop.clear()
            self._ticker = threading.Thread(
                target=self._ticker_loop, daemon=True,
                name="loghisto-fed-tick",
            )
            self._ticker.start()

    def close(self, drain_timeout: float = 10.0) -> bool:
        """Final flush, best-effort drain, stop threads.  Returns the
        drain verdict (False: frames remained undeliverable and were
        abandoned with the process — shed-don't-block, like every other
        exit path in the pipeline)."""
        self._stop.set()
        if self._ticker is not None:
            self._ticker.join(timeout=5.0)
            self._ticker = None
        if self._attached is not None:
            ch, t = self._attached
            ch.close()
            t.join(timeout=5.0)
            self._attached = None
        self.flush(heartbeat=False)
        ok = self.drain(timeout=drain_timeout)
        self._sender.stop_sender()
        return ok

    # -- introspection --------------------------------------------------- #

    @property
    def backlog_depth(self) -> int:
        return self._sender.backlog_depth()

    @property
    def bytes_sent(self) -> int:
        return self._sender.bytes_sent

    @property
    def send_failures(self) -> int:
        return self._sender.send_failures
