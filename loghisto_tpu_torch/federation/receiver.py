"""FederationReceiver: the aggregator half of the federation tier
(counterpart of ``loghisto_tpu/federation/receiver.py``).

A TCP listener whose accept thread, and each connection's decode
thread, start through ``resilience.supervise.spawn_thread``: with a
supervisor a crashed loop restarts with capped-exponential backoff and
shows on the ``thread_restarted`` health reason.  Per connection:
buffered recv, greedy frame parse (``ops/codec.py``), DELTA payload
decode (``wire.py``), then apply:

  * sequence tracking per emitter_id: a seq applied before (or fallen
    behind the reorder window) is counted and dropped, so the
    at-least-once sender may repeat frames freely.  Each frame rides
    its own TCP connection, so connection threads can apply one
    emitter's frames out of order: a never-seen seq inside the window
    still applies and takes back its provisional gap.  Seqs still
    missing count ``seq_gaps`` (frames that died in an emitter's
    wrapped backlog or with the emitter).
  * name interning: dictionary deltas map emitter-local ids to
    aggregator rows through ``TorchAggregator._id_for`` (free-list
    reuse, grow, then shed, as every other ingest path), and the id
    column of the triples is rewritten in one vectorized pass.  Rows
    whose local id has no mapping yet PARK (bounded) while the emitter
    has open seq gaps, since the dictionary frame may merely be late,
    and merge when it lands; they shed only when every gap is filled
    and the name still never arrived, when they age out or overflow
    the park, or at ``stop()``.
  * merge: rewritten triples drain into ``TorchAggregator.merge_packed``
    (the transfer worker's packed route: K3 on dense storage, the paged
    commit and K4 on paged storage).  int32 scatter-adds are
    order-free: the aggregate equals a single-process oracle fed the
    same samples in any order.

Corruption never merges: a frame that fails its CRC or the schema
counts ``decode_errors`` and drops the CONNECTION (the stream offers no
resync point), as an emitter crash mid-frame does, whose torn partial
frame is likewise counted and discarded at EOF.

With ``journal_path`` every applied frame is first appended to a binary
``utils/journal.FrameJournal`` (the wire's frame codec); after a
restart with a fresh aggregator, ``replay_journal()`` rebuilds the same
state, and duplicates in the journal deduplicate through the same seq
tracking as live frames.

Fault sites: ``fed.accept`` (accept loop, per connection) and
``fed.decode`` (per frame, before apply); the emitter holds
``fed.send``.  Spans: ``fed.decode``, ``fed.apply``, ``fed.merge`` and
the instant ``fed.park``.  A standalone receiver completes each v2
frame's freshness sample at apply; in ``TorchMetricSystem(federation=
...)`` the committer's freshness hook (``note_publish``) completes them
at snapshot publish.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional

import numpy as np

from loghisto_tpu_torch.federation import wire
from loghisto_tpu_torch.obs.spans import NULL_RECORDER, LatencyHistogram
from loghisto_tpu_torch.ops.codec import (
    FrameError, FrameTruncated, decode_frame,
)
from loghisto_tpu_torch.resilience.supervise import spawn_thread

_ACCEPT_POLL_S = 0.25
# Reorder window: a never-before-seen seq no further than this behind
# the high-water mark still applies (one connection per frame means
# frames from one emitter can race each other through conn threads);
# anything older is indistinguishable from a stale re-delivery and is
# dropped as a duplicate.
SEQ_WINDOW = 4096
# row_map sentinels: a local id whose dictionary entry never arrived
# (may be in a late frame) vs. one whose name the registry shed
ROW_UNKNOWN = -2
ROW_SHED = -1
# parked-row bounds per emitter: rows waiting on a late dictionary
# frame shed once this many rows queue up or once the emitter's seq
# high-water mark has advanced this far past their arrival
MAX_PARKED_ROWS = 1 << 16
PARK_SEQ_AGE = 64
# host-side freshness ledger bound (the bit-identity oracle's input);
# past this the histograms keep counting but the ledger stops
FRESHNESS_LEDGER_CAP = 1 << 16


class _EmitterState:
    """Per-emitter sequencing + id-mapping state, keyed by emitter_id."""

    __slots__ = (
        "last_seq", "seen", "row_map", "parked", "parked_rows",
        "last_frame_t", "frames", "samples", "duplicates", "gaps",
        # fleet-observability plane (v2 frames only)
        "e_mono0", "r_mono0", "e_wall0", "last_e_mono", "skew_ns",
        "health", "health_t", "freshness", "wire_v",
    )

    def __init__(self):
        self.last_seq = 0          # high-water mark
        self.seen: set[int] = set()  # applied seqs within SEQ_WINDOW
        # emitter-local id -> aggregator row (ROW_UNKNOWN: dictionary
        # entry not seen yet; ROW_SHED: the registry shed the name)
        self.row_map = np.full(64, ROW_UNKNOWN, dtype=np.int32)
        # rows waiting on a late dictionary frame: (hwm_at_park, packed)
        self.parked: list = []
        self.parked_rows = 0
        self.last_frame_t = time.monotonic()
        self.frames = 0
        self.samples = 0
        self.duplicates = 0
        self.gaps = 0
        # clock anchors: emitter monotonic/wall at first v2 frame of
        # this emitter incarnation, paired with the receiver monotonic
        # at arrival.  All lag/freshness math runs on monotonic deltas
        # against these; the wall stamp only feeds the skew detector.
        self.e_mono0: Optional[int] = None
        self.r_mono0 = 0
        self.e_wall0 = 0
        self.last_e_mono = 0
        self.skew_ns = 0  # (wall delta) - (mono delta) since anchor
        self.health: Optional[dict] = None
        self.health_t = 0.0
        self.freshness = LatencyHistogram()
        self.wire_v = 1


class FederationReceiver:
    def __init__(
        self,
        aggregator,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        journal_path: Optional[str] = None,
        replay_on_start: bool = False,
        expected_emitters: int = 0,
        supervisor=None,
        fault_injector=None,
        obs_recorder=None,
        recv_bytes: int = 1 << 16,
    ):
        self.aggregator = aggregator
        self.host = host
        self.port = int(port)  # rewritten to the bound port on start()
        self.journal_path = journal_path
        self.replay_on_start = replay_on_start
        self.expected_emitters = int(expected_emitters)
        self.supervisor = supervisor
        self.fault_injector = fault_injector
        self.obs_recorder = obs_recorder or NULL_RECORDER
        self.recv_bytes = recv_bytes

        self._sock: Optional[socket.socket] = None
        self._accept_thread = None
        self._conn_threads: list = []
        self._stop = threading.Event()
        self._lock = threading.Lock()       # guards apply + counters
        self._journal = None
        self._started_t: Optional[float] = None

        self.emitters: dict[int, _EmitterState] = {}
        self.frames_received = 0
        self.bytes_received = 0
        self.decode_errors = 0
        self.duplicate_frames = 0
        self.seq_gaps = 0
        self.samples_merged = 0
        self.samples_shed = 0    # rows whose name never resolved
        self.samples_parked = 0  # rows currently waiting on a late dict
        self.frames_replayed = 0
        self.connections_total = 0
        self.connections_active = 0
        # frames/s gauge state: (monotonic t, frames_received) at last read
        self._rate_mark = (time.monotonic(), 0)
        # -- fleet-observability plane -------------------------------- #
        self.frames_v1 = 0          # legacy frames applied (no stamps)
        self.fleet_freshness = LatencyHistogram()
        # applied-but-not-yet-queryable frames: (emitter_id,
        # apply_mono_ns, capture->apply latency ns).  A wired committer
        # (``has_publisher``) completes these at snapshot publish via
        # note_publish(); standalone receivers complete at apply time.
        self._pending: list = []
        self.has_publisher = False
        # host-side oracle ledger of completed freshness samples (µs)
        self.freshness_values: list = []
        self.freshness_dropped = 0
        # thresholds read by fleet_report()/watchdog; system wiring
        # overwrites from FederationConfig
        self.starvation_s = 3.0
        self.skew_tolerance_s = 1.0

    # -- lifecycle ------------------------------------------------------ #

    def start(self) -> None:
        """Replay the journal if configured, bind, and start accepting.
        ``self.port`` holds the real bound port afterwards (port=0 asks
        the OS for an ephemeral one)."""
        if self._sock is not None:
            return
        if self.replay_on_start and self.journal_path is not None:
            import os

            if os.path.exists(self.journal_path):
                self.replay_journal()
        if self.journal_path is not None:
            from loghisto_tpu_torch.utils.journal import FrameJournal

            self._journal = FrameJournal(self.journal_path)
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self.host, self.port))
        sock.listen(128)
        sock.settimeout(_ACCEPT_POLL_S)  # poll so stop() can interrupt
        self.port = sock.getsockname()[1]
        self._sock = sock
        self._stop.clear()
        self._started_t = time.monotonic()
        self._accept_thread = spawn_thread(
            self.supervisor, self._accept_loop, "loghisto-fed-accept"
        )

    def stop(self) -> None:
        """Stop accepting, close every connection's thread, close the
        journal.  In-flight decoded frames finish applying; the
        aggregator's transfer queue keeps whatever was already merged."""
        self._stop.set()
        t = self._accept_thread
        if t is not None:
            t.stop()  # a supervised thread restarts no more after this
            self._accept_thread = None
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        if t is not None:
            t.join(timeout=5.0)
        for ct in self._conn_threads:
            ct.stop()
            ct.join(timeout=5.0)
        self._conn_threads = []
        with self._lock:
            # finalize the ledger: rows still waiting on a dictionary
            # frame at shutdown will never resolve — count them shed
            for state in self.emitters.values():
                for _hwm, upack in state.parked:
                    samples = int(upack[:, 2].sum(dtype=np.int64))
                    self.samples_shed += samples
                    self.samples_parked -= samples
                state.parked = []
                state.parked_rows = 0
        if self._journal is not None:
            self._journal.close()
            self._journal = None

    # -- accept / decode ------------------------------------------------ #

    def _accept_loop(self) -> None:
        sock = self._sock
        while not self._stop.is_set() and sock is not None:
            try:
                conn, _addr = sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed by stop()
            inj = self.fault_injector
            if inj is not None:
                # a scripted raise here crashes the (supervised) accept
                # thread AFTER the 3-way handshake — the client sees the
                # connection reset, the supervisor restarts the loop
                try:
                    inj.check("fed.accept")
                except Exception:
                    conn.close()
                    raise
            self.connections_total += 1
            self._conn_threads = [
                ct for ct in self._conn_threads if ct.is_alive()
            ]
            self._conn_threads.append(spawn_thread(
                self.supervisor, lambda c=conn: self._conn_loop(c),
                f"loghisto-fed-conn-{self.connections_total}",
            ))

    def _conn_loop(self, conn: socket.socket) -> None:
        self.connections_active += 1
        buf = bytearray()
        try:
            conn.settimeout(_ACCEPT_POLL_S)
            while not self._stop.is_set():
                try:
                    chunk = conn.recv(self.recv_bytes)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not chunk:
                    break  # peer closed
                self.bytes_received += len(chunk)
                buf += chunk
                if not self._drain_buffer(buf):
                    return  # corrupt frame: drop the connection
            # EOF with a partial frame = emitter crashed (or was killed)
            # mid-frame: count it, merge nothing from it
            if len(buf):
                with self._lock:
                    self.decode_errors += 1
        finally:
            self.connections_active -= 1
            try:
                conn.close()
            except OSError:
                pass

    def _drain_buffer(self, buf: bytearray) -> bool:
        """Greedily decode+apply every complete frame in ``buf``,
        consuming the decoded prefix.  False means the stream is corrupt
        and the caller must drop the connection."""
        offset = 0
        try:
            while True:
                try:
                    kind, payload, offset = decode_frame(buf, offset)
                except FrameTruncated:
                    break  # need more bytes
                self._handle_frame(kind, payload)
        except (FrameError, wire.WireError):
            with self._lock:
                self.decode_errors += 1
            return False
        finally:
            if offset:
                del buf[:offset]
        return True

    def _handle_frame(self, kind: int, payload: bytes) -> None:
        inj = self.fault_injector
        if inj is not None:
            # scripted decode failure: follows the organic-corruption
            # path (counted, connection dropped), not a thread crash
            try:
                inj.check("fed.decode")
            except Exception as e:
                raise wire.WireError(f"injected decode fault: {e}") from e
        if kind not in (wire.KIND_DELTA, wire.KIND_DELTA2):
            raise wire.WireError(f"unknown frame kind {kind}")
        t0 = time.perf_counter_ns()
        delta = wire.decode_payload(kind, payload)
        flow = wire.fed_flow_id(delta.emitter_id, delta.seq)
        self.obs_recorder.record(
            "fed.decode", t0, time.perf_counter_ns(), None, flow
        )
        with self.obs_recorder.span("fed.apply", flow=flow):
            if self._journal is not None:
                # write-ahead, before apply: replay after a crash
                # re-applies through the same seq dedup, so the journal
                # being ahead of the aggregator is safe; behind is not
                self._journal.append(kind, payload)
            self._apply_delta(delta)

    # -- apply ---------------------------------------------------------- #

    def _apply_delta(self, delta: wire.DeltaFrame, live: bool = True) -> None:
        agg = self.aggregator
        flow = wire.fed_flow_id(delta.emitter_id, delta.seq)
        now_mono_ns = time.monotonic_ns()
        fresh_ns = None  # completed-at-apply freshness (no publisher)
        newly_parked = False
        with self._lock:
            state = self.emitters.get(delta.emitter_id)
            if state is None:
                state = self.emitters[delta.emitter_id] = _EmitterState()
                self._register_emitter_gauge(delta.emitter_id)
            # dictionary deltas apply even on duplicate frames —
            # interning is idempotent and a re-delivered frame may be
            # the only carrier of a name whose first copy half-applied
            for local_id, name in delta.names:
                if local_id >= len(state.row_map):
                    grown = np.full(
                        max(2 * len(state.row_map), local_id + 1),
                        ROW_UNKNOWN, dtype=np.int32,
                    )
                    grown[:len(state.row_map)] = state.row_map
                    state.row_map = grown
                state.row_map[local_id] = agg._id_for(name)
            state.last_frame_t = time.monotonic()
            # clock anchors update on EVERY live v2 frame, duplicates
            # included — any arrival proves liveness and carries the
            # freshest clock/health readings.  Replayed frames are
            # excluded: their stamps describe a past incarnation and
            # would anchor emitter clocks against the wrong receiver
            # clock.
            if delta.mono_ns is not None and live:
                state.wire_v = 2
                if state.e_mono0 is None or delta.mono_ns < state.e_mono0:
                    # first v2 frame from this emitter incarnation, or
                    # its monotonic clock reset (process restart):
                    # (re-)anchor both clock pairs here
                    state.e_mono0 = delta.mono_ns
                    state.r_mono0 = now_mono_ns
                    state.e_wall0 = delta.wall_ns
                    state.last_e_mono = delta.mono_ns
                state.last_e_mono = max(state.last_e_mono, delta.mono_ns)
                # a wall-clock step (NTP slew, fault injection) shows as
                # wall advancing at a different rate than monotonic;
                # lag/freshness never read the wall clock so a backward
                # step can only trip the skew flag, never go negative
                state.skew_ns = (
                    (delta.wall_ns - state.e_wall0)
                    - (delta.mono_ns - state.e_mono0)
                )
                if delta.health is not None:
                    state.health = delta.health
                    state.health_t = time.monotonic()
            seq = delta.seq
            merges: list = []
            if seq in state.seen or seq <= state.last_seq - SEQ_WINDOW:
                state.duplicates += 1
                self.duplicate_frames += 1
            else:
                if seq > state.last_seq:
                    missed = seq - state.last_seq - 1
                    if missed:
                        # provisional: a frame applying late un-counts
                        # itself below
                        state.gaps += missed
                        self.seq_gaps += missed
                    state.last_seq = seq
                else:
                    # in-window reorder: this seq was counted as a gap
                    # when a higher seq overtook it — it arrived after
                    # all
                    state.gaps -= 1
                    self.seq_gaps -= 1
                state.seen.add(seq)
                if len(state.seen) > 2 * SEQ_WINDOW:
                    floor = state.last_seq - SEQ_WINDOW
                    state.seen = {s for s in state.seen if s > floor}
                self.frames_received += 1
                state.frames += 1
                if delta.mono_ns is None:
                    self.frames_v1 += 1
                elif live:
                    # capture -> apply latency via the monotonic anchor
                    # pair; clamped, because transit jitter can make the
                    # anchor-predicted capture time land marginally
                    # after "now" for the fastest frames
                    base_ns = max(
                        0,
                        (now_mono_ns - state.r_mono0)
                        - (delta.mono_ns - state.e_mono0),
                    )
                    if self.has_publisher:
                        self._pending.append(
                            (delta.emitter_id, now_mono_ns, base_ns)
                        )
                    else:
                        fresh_ns = base_ns
                parked_before = state.parked_rows
                if len(delta.packed):
                    self._map_rows_locked(state, delta.packed, merges)
                newly_parked = state.parked_rows > parked_before
            # a frame (even a duplicate) may have carried the dictionary
            # entries parked rows were waiting on
            if state.parked:
                self._resolve_parked_locked(state, merges)
        if merges:
            with self.obs_recorder.span("fed.merge", flow=flow):
                for packed in merges:
                    agg.merge_packed(packed)
        if newly_parked:
            # instantaneous marker: this frame parked rows on a missing
            # dictionary entry
            t = time.perf_counter_ns()
            self.obs_recorder.record("fed.park", t, t, None, flow)
        if fresh_ns is not None:
            self._complete_freshness(delta.emitter_id, fresh_ns)

    def _map_rows_locked(self, state: _EmitterState, packed, merges) -> None:
        """Rewrite the local-id column through ``row_map``; merge the
        mapped rows, shed registry-shed rows, park unknown ones while a
        seq gap leaves room for their dictionary frame to still arrive.
        Caller holds ``self._lock``."""
        local = packed[:, 0]
        n = len(state.row_map)
        mapped = np.where(
            (local >= 0) & (local < n),
            state.row_map[np.clip(local, 0, n - 1)], ROW_UNKNOWN,
        )
        shed = mapped == ROW_SHED
        if shed.any():
            self.samples_shed += int(packed[shed, 2].sum(dtype=np.int64))
        unknown = mapped == ROW_UNKNOWN
        if unknown.any():
            upack = packed[unknown]
            usamples = int(upack[:, 2].sum(dtype=np.int64))
            if (state.gaps > 0
                    and state.parked_rows + len(upack) <= MAX_PARKED_ROWS):
                state.parked.append((state.last_seq, upack))
                state.parked_rows += len(upack)
                self.samples_parked += usamples
            else:
                # no open gap can explain the missing dictionary entry
                # (or the park bound is hit): the name never arrived
                self.samples_shed += usamples
        keep = mapped >= 0
        if keep.any():
            out = packed[keep]
            out[:, 0] = mapped[keep]
            samples = int(out[:, 2].sum(dtype=np.int64))
            state.samples += samples
            self.samples_merged += samples
            merges.append(out)

    def _resolve_parked_locked(self, state: _EmitterState, merges) -> None:
        """Retry parked rows against the (possibly just-extended)
        row_map: resolved rows merge, registry-shed rows shed, rows
        still unknown stay parked while a gap remains open and they have
        not aged out.  Caller holds ``self._lock``."""
        still: list = []
        for hwm, upack in state.parked:
            local = upack[:, 0]
            n = len(state.row_map)
            mapped = np.where(
                (local >= 0) & (local < n),
                state.row_map[np.clip(local, 0, n - 1)], ROW_UNKNOWN,
            )
            resolved = mapped >= 0
            if resolved.any():
                out = upack[resolved]
                out[:, 0] = mapped[resolved]
                samples = int(out[:, 2].sum(dtype=np.int64))
                state.samples += samples
                self.samples_merged += samples
                self.samples_parked -= samples
                merges.append(out)
            regshed = mapped == ROW_SHED
            if regshed.any():
                samples = int(upack[regshed, 2].sum(dtype=np.int64))
                self.samples_shed += samples
                self.samples_parked -= samples
            unknown = mapped == ROW_UNKNOWN
            if unknown.any():
                rest = upack[unknown]
                samples = int(rest[:, 2].sum(dtype=np.int64))
                if (state.gaps > 0
                        and state.last_seq - hwm <= PARK_SEQ_AGE):
                    still.append((hwm, rest))
                else:
                    self.samples_shed += samples
                    self.samples_parked -= samples
        state.parked = still
        state.parked_rows = sum(len(p) for _, p in still)

    # -- freshness (record -> queryable) ---------------------------------- #

    def _complete_freshness(self, emitter_id: int, fresh_ns: int) -> None:
        """One frame became queryable ``fresh_ns`` after its first
        sample was recorded: feed the fleet and per-emitter log-bucket
        histograms, the host-side oracle ledger, and (when wired into a
        system) the ordinary ``fed.FreshnessUs`` histogram path."""
        us = fresh_ns / 1e3
        self.fleet_freshness.add(us)
        with self._lock:
            state = self.emitters.get(emitter_id)
            if len(self.freshness_values) < FRESHNESS_LEDGER_CAP:
                self.freshness_values.append(us)
            else:
                self.freshness_dropped += 1
        if state is not None:
            state.freshness.add(us)
        ms = getattr(self, "_ms", None)
        if ms is not None:
            ms.histogram("fed.FreshnessUs", us)
            ms.histogram(f"fed.emitter.{emitter_id:016x}.FreshnessUs", us)

    def note_publish(self, seq=None) -> int:
        """Snapshot-publish hook: the committer calls this right after
        an interval's aggregate became queryable.  Every frame applied
        since the previous publish completes its freshness sample here
        (capture->apply latency from the wire stamps, plus apply->
        publish measured receiver-side).  Returns the number of frames
        completed."""
        now_ns = time.monotonic_ns()
        with self._lock:
            pending, self._pending = self._pending, []
        for emitter_id, apply_ns, base_ns in pending:
            self._complete_freshness(
                emitter_id, base_ns + (now_ns - apply_ns)
            )
        return len(pending)

    def oldest_pending_age_s(self) -> float:
        """Age of the oldest applied-but-unpublished frame — the
        ``fleet_freshness_stall`` invariant's input.  0 when nothing is
        pending (an idle fleet is not a stalled fleet)."""
        now_ns = time.monotonic_ns()
        with self._lock:
            if not self._pending:
                return 0.0
            return (now_ns - min(p[1] for p in self._pending)) / 1e9

    def freshness_totals(self, budget_us: float, emitter_id=None):
        """(total, over-budget) sample counts from the freshness
        histograms — the ``freshness`` SLO-burn rule's observation."""
        if emitter_id is None:
            hist = self.fleet_freshness
        else:
            with self._lock:
                state = self.emitters.get(emitter_id)
            if state is None:
                return 0, 0
            hist = state.freshness
        return hist.count, hist.count_above(budget_us)

    # -- journal replay -------------------------------------------------- #

    def replay_journal(self, path: Optional[str] = None) -> int:
        """Re-apply every journaled frame through the normal apply path
        (duplicates deduplicate by seq exactly like live re-delivery).
        Returns the number of frames applied.  Only meaningful against
        an aggregator that does NOT already contain these samples — the
        receiver-restart-with-fresh-state recovery drill."""
        from loghisto_tpu_torch.utils.journal import FrameJournal

        path = path if path is not None else self.journal_path
        if path is None:
            raise ValueError("no journal_path configured or given")
        n = 0
        for kind, payload in FrameJournal.replay(path):
            if kind not in (wire.KIND_DELTA, wire.KIND_DELTA2):
                continue
            try:
                # live=False: a replayed frame's stamps describe a past
                # incarnation — rebuilding state must not fabricate
                # freshness samples
                self._apply_delta(wire.decode_payload(kind, payload),
                                  live=False)
            except wire.WireError:
                with self._lock:
                    self.decode_errors += 1
                continue
            n += 1
        self.frames_replayed += n
        return n

    # -- health / gauges ------------------------------------------------- #

    def _lag_locked(self, state: _EmitterState, now_mono_ns: int) -> float:
        """Per-emitter lag in seconds, computed from MONOTONIC deltas
        against the anchor pair so a wall-clock step on either side can
        never drive it negative; clamped anyway because transit jitter
        on the anchor frame can predict a capture marginally in the
        future.  v1 emitters (no stamps) fall back to arrival age."""
        if state.e_mono0 is not None:
            lag_ns = (
                (now_mono_ns - state.r_mono0)
                - (state.last_e_mono - state.e_mono0)
            )
            return max(0.0, lag_ns / 1e9)
        return max(0.0, time.monotonic() - state.last_frame_t)

    def max_emitter_lag_s(self) -> float:
        """Lag of the STALEST emitter (0 with no emitters): the
        fleet-wide freshness bound the lag gauge and the starvation
        invariant read."""
        now_ns = time.monotonic_ns()
        with self._lock:
            if not self.emitters:
                return 0.0
            return max(
                self._lag_locked(s, now_ns) for s in self.emitters.values()
            )

    def max_emitter_skew_s(self) -> float:
        """Largest absolute wall-vs-monotonic divergence any emitter
        has shown since its clock anchor — the ``emitter_clock_skew``
        invariant's input."""
        with self._lock:
            if not self.emitters:
                return 0.0
            return max(
                abs(s.skew_ns) / 1e9 for s in self.emitters.values()
            )

    def last_frame_age_s(self) -> float:
        """Seconds since ANY frame arrived (since start() before the
        first frame; 0 when never started)."""
        now = time.monotonic()
        with self._lock:
            if self.emitters:
                return min(
                    now - s.last_frame_t for s in self.emitters.values()
                )
        if self._started_t is None:
            return 0.0
        return now - self._started_t

    def frames_per_s(self) -> float:
        """Frame arrival rate since the last call (gauge-scrape shaped)."""
        now = time.monotonic()
        t0, f0 = self._rate_mark
        frames = self.frames_received
        self._rate_mark = (now, frames)
        dt = now - t0
        if dt <= 0.0:
            return 0.0
        return (frames - f0) / dt

    def stats(self) -> dict:
        now_ns = time.monotonic_ns()
        with self._lock:
            per_emitter = {
                f"{eid:016x}": {
                    "last_seq": s.last_seq,
                    "frames": s.frames,
                    "samples": s.samples,
                    "duplicates": s.duplicates,
                    "gaps": s.gaps,
                    "parked_rows": s.parked_rows,
                    "wire_v": s.wire_v,
                    "lag_s": round(self._lag_locked(s, now_ns), 3),
                    "skew_s": round(s.skew_ns / 1e9, 6),
                }
                for eid, s in self.emitters.items()
            }
            pending = len(self._pending)
        return {
            "port": self.port,
            "connections_active": self.connections_active,
            "connections_total": self.connections_total,
            "frames_received": self.frames_received,
            "frames_replayed": self.frames_replayed,
            "frames_v1": self.frames_v1,
            "bytes_received": self.bytes_received,
            "decode_errors": self.decode_errors,
            "duplicate_frames": self.duplicate_frames,
            "seq_gaps": self.seq_gaps,
            "samples_merged": self.samples_merged,
            "samples_shed": self.samples_shed,
            "samples_parked": self.samples_parked,
            "freshness_samples": self.fleet_freshness.count,
            "freshness_pending": pending,
            "freshness_dropped": self.freshness_dropped,
            "emitters": per_emitter,
        }

    def fleet_report(self, top_k: int = 3) -> dict:
        """The ``/fleetz`` payload: every emitter's rollup (sequencing,
        lag, freshness p99, clock skew, piggybacked health), top-K
        slowest / laggiest / flappiest lists, and starvation / skew flag
        lists.  Percentiles run through the host rule of
        ``obs/spans.py``, so a bare receiver serves this without device
        code; ``/fleetz`` serves it."""
        now_ns = time.monotonic_ns()
        now = time.monotonic()
        with self._lock:
            snap = list(self.emitters.items())
            rows = {}
            for eid, s in snap:
                health = s.health or {}
                p99s = health.get("p99_us", {})
                lag = self._lag_locked(s, now_ns)
                rows[f"{eid:016x}"] = {
                    "last_seq": s.last_seq,
                    "frames": s.frames,
                    "samples": s.samples,
                    "gaps": s.gaps,
                    "duplicates": s.duplicates,
                    "parked_rows": s.parked_rows,
                    "wire_v": s.wire_v,
                    "lag_s": round(lag, 3),
                    "skew_s": round(s.skew_ns / 1e9, 6),
                    "stalled": lag > self.starvation_s,
                    "freshness_p99_us": round(
                        s.freshness.percentile_host(99.0), 1
                    ),
                    "stage_p99_us": p99s,
                    "backlog": health.get("backlog", 0),
                    "send_failures": health.get("fail", 0),
                    "restarts": health.get("restarts", 0),
                    "uptime_s": health.get("up_s", 0.0),
                    "health_age_s": (
                        round(now - s.health_t, 1) if s.health else None
                    ),
                }
            pending = len(self._pending)
        def _top(key) -> list:
            ranked = sorted(
                rows.items(), key=lambda kv: key(kv[1]), reverse=True
            )
            return [eid for eid, r in ranked[:top_k] if key(r) > 0]
        return {
            "emitters": rows,
            "fleet": {
                "emitters": len(rows),
                "expected_emitters": self.expected_emitters,
                "freshness_p99_us": round(
                    self.fleet_freshness.percentile_host(99.0), 1
                ),
                "freshness_samples": self.fleet_freshness.count,
                "freshness_pending": pending,
                "oldest_pending_age_s": round(
                    self.oldest_pending_age_s(), 3
                ),
                "frames_received": self.frames_received,
                "seq_gaps": self.seq_gaps,
                "samples_merged": self.samples_merged,
                "samples_shed": self.samples_shed,
            },
            "top": {
                "slowest": _top(
                    lambda r: max(r["stage_p99_us"].values(), default=0.0)
                ),
                "laggiest": _top(lambda r: r["lag_s"]),
                "flappiest": _top(
                    lambda r: r["restarts"] * 1000 + r["send_failures"]
                ),
            },
            "flags": {
                "starved": [
                    eid for eid, r in rows.items() if r["stalled"]
                ],
                "clock_skew": [
                    eid for eid, r in rows.items()
                    if abs(r["skew_s"]) > self.skew_tolerance_s
                ],
            },
        }

    def register_gauges(self, ms) -> None:
        """The ``federation.*`` gauge family on the ordinary exporter
        pipeline; per-emitter lag gauges register lazily as emitters
        first appear."""
        self._ms = ms
        ms.register_gauge_func(
            "federation.ConnectedEmitters",
            lambda: float(len(self.emitters)),
        )
        ms.register_gauge_func(
            "federation.ActiveConnections",
            lambda: float(self.connections_active),
        )
        ms.register_gauge_func(
            "federation.FramesReceived",
            lambda: float(self.frames_received),
        )
        ms.register_gauge_func(
            "federation.FramesPerSec", self.frames_per_s,
        )
        ms.register_gauge_func(
            "federation.BytesReceived",
            lambda: float(self.bytes_received),
        )
        ms.register_gauge_func(
            "federation.DecodeErrors",
            lambda: float(self.decode_errors),
        )
        ms.register_gauge_func(
            "federation.DuplicateFrames",
            lambda: float(self.duplicate_frames),
        )
        ms.register_gauge_func(
            "federation.SeqGaps", lambda: float(self.seq_gaps),
        )
        ms.register_gauge_func(
            "federation.SamplesMerged",
            lambda: float(self.samples_merged),
        )
        ms.register_gauge_func(
            "federation.SamplesShed",
            lambda: float(self.samples_shed),
        )
        ms.register_gauge_func(
            "federation.SamplesParked",
            lambda: float(self.samples_parked),
        )
        ms.register_gauge_func(
            "federation.MaxEmitterLagS", self.max_emitter_lag_s,
        )
        ms.register_gauge_func(
            "federation.MaxEmitterSkewS", self.max_emitter_skew_s,
        )
        ms.register_gauge_func(
            "fed.freshness_p99_us",
            lambda: self.fleet_freshness.percentile_host(99.0),
        )
        ms.register_gauge_func(
            "fed.freshness_pending",
            lambda: float(len(self._pending)),
        )

    def _register_emitter_gauge(self, emitter_id: int) -> None:
        ms = getattr(self, "_ms", None)
        if ms is None:
            return
        def _lag(eid=emitter_id) -> float:
            now_ns = time.monotonic_ns()
            with self._lock:
                s = self.emitters.get(eid)
                if s is None:
                    return 0.0
                return self._lag_locked(s, now_ns)
        ms.register_gauge_func(
            f"federation.emitter.{emitter_id:016x}.LagS", _lag
        )
        def _fresh_p99(eid=emitter_id) -> float:
            with self._lock:
                s = self.emitters.get(eid)
            if s is None:
                return 0.0
            return s.freshness.percentile_host(99.0)
        ms.register_gauge_func(
            f"fed.emitter.{emitter_id:016x}.freshness_p99_us", _fresh_p99
        )
