"""Crash-safe recovery (counterpart of
``loghisto_tpu/resilience/recovery.py``, copied over the port's
``utils/checkpoint.py`` and ``utils/journal.py``).

The guarantee: **at most one interval is lost across a process crash.**
Two durable artifacts deliver it:

  * periodic checkpoints, taken on the committer's bridge thread every
    ``checkpoint_every_intervals`` committed intervals, atomic (temp +
    fsync + rename) and stamped with the seq watermark of the last
    interval folded into the state;
  * the raw journal: every broadcast interval appends one JSONL line
    carrying its ``seq``.

``recover()`` restores the newest checkpoint, reads its watermark, then
replays only the journal's intervals with ``seq > watermark`` through
the fused committer, so the recovered statistics equal a pre-crash
oracle's bit for bit.  The only interval that can be missing is the
one in flight at the kill: its journal line is torn (skipped and
counted) or never reached the journal.  Both files are the JAX
package's formats, so either package recovers the other's crash.
Neither carries the wheel's interval count (the lifecycle clock), as
in the reference: a recovered lifecycle restarts its clock.

A CUDA error that poisons the context (an illegal address) cannot be
recovered inside the process; ``recover()`` in a new process is the
answer, and crash-only shutdown is the design's assumption.

``CircuitBreaker`` guards the fused commit: repeated device failures
inside ``breaker_window_s`` open it and the committer pins the
fan-out/spill path (on the card: K3 into the accumulator and the
tiers) until ``breaker_open_s`` passes and a half-open trial succeeds.
No breaker state moves work to the CPU.

Everything surfaces as ``resilience.*`` gauges and three watchdog
invariants (``thread_restarted``, ``breaker_open``,
``recovery_in_progress``) in ``/healthz``.

On a ("stream", "metric") mesh (ROADMAP D11) the manager follows D9's
thread rule: ``on_commit`` runs where the commit runs, at a collective
entry point on the rank's main thread, so the cadenced
``checkpoint_now`` is a collective there (``utils/checkpoint.save`` on
a mesh).  The watermark is the seq of the interval committed last; the
ranks check it is one seq (one MIN and one MAX over the mesh) and
refuse, as a counted checkpoint error, to stamp one that some rank has
not committed.  Each stream row keeps its own journal
(``utils/journal.row_journal_path``, written by the row's rank at
metric index 0).  ``recover()`` is a collective: every rank restores
the checkpoint, reads every saved row's journal past the watermark and,
seq by seq, commits the merged raw sets of the saved rows j with
``j % n_stream == s`` as its row s's interval (every name of that seq
in one order on every rank, so the registries stay alike); a row with
nothing for a seq commits an empty interval of that seq, so every rank
makes the same collectives.  Int32 adds commute, so any target shape
holds the sums of the merged intervals; a JAX journal (one file) is
row 0 of 1, and one device recovers a mesh's crash as row 0 of 1.  The
seq counter then moves past the most any rank replayed.  On paged
storage (ROADMAP D13) the replayed intervals go through the committer's
merged interval, whose cells come in the order of the live one (the
saved rows merged in row order, the names in file order), so a replay
onto another stream axis commits the live interval's cells in the same
chunks.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

from loghisto_tpu_torch.resilience.faults import FaultInjector

logger = logging.getLogger("loghisto_tpu_torch")


@dataclass
class ResilienceConfig:
    """Knobs for the resilience subsystem (TorchMetricSystem(resilience=...)).

    With ``checkpoint_path`` set, the committer bridge checkpoints every
    ``checkpoint_every_intervals`` committed intervals; with
    ``journal_path`` set, a RawJournal subscriber appends every interval
    and ``recover()`` replays past the checkpoint watermark.  Leave both
    None for supervision + breaker only (no durability)."""

    checkpoint_path: Optional[str] = None
    journal_path: Optional[str] = None
    checkpoint_every_intervals: int = 10
    recover_on_start: bool = True
    supervise: bool = True
    restart_backoff_s: float = 0.05
    restart_backoff_cap_s: float = 2.0
    breaker_threshold: int = 3
    breaker_window_s: float = 30.0
    breaker_open_s: float = 10.0
    fault_injector: Optional[FaultInjector] = None


class CircuitBreaker:
    """Count-over-window breaker for the device dispatch path.

    closed -> open when ``threshold`` failures land inside ``window_s``;
    open -> half-open after ``open_s`` (is_open() starts returning False
    so ONE trial dispatch goes through); half-open -> closed on success,
    half-open -> open on failure.  While open the committer routes every
    interval down the fan-out/spill path — the same path a single device
    failure already takes, just pinned, so a flapping device costs no
    failed commit per interval."""

    def __init__(
        self,
        threshold: int = 3,
        window_s: float = 30.0,
        open_s: float = 10.0,
    ):
        self.threshold = threshold
        self.window_s = window_s
        self.open_s = open_s
        self._lock = threading.Lock()
        self._failures: deque = deque()
        self._state = "closed"
        self._opened_at = 0.0
        self.opened_total = 0
        self.failures_total = 0

    def record_failure(self, source: str = "") -> bool:
        """Note one device failure; returns True if this opened the
        breaker.  Called from exactly ONE place per physical failure
        (the aggregator's _on_device_failure_locked) so consumer hooks
        fanning out from a failure can't multi-count it."""
        now = time.monotonic()
        with self._lock:
            self.failures_total += 1
            self._failures.append(now)
            while self._failures and \
                    now - self._failures[0] > self.window_s:
                self._failures.popleft()
            if self._state == "half-open":
                self._state = "open"
                self._opened_at = now
                self.opened_total += 1
                logger.warning(
                    "circuit breaker re-opened (half-open trial failed%s)",
                    f"; source={source}" if source else "",
                )
                return True
            if self._state == "closed" \
                    and len(self._failures) >= self.threshold:
                self._state = "open"
                self._opened_at = now
                self.opened_total += 1
                logger.warning(
                    "circuit breaker OPEN: %d device failures in %.1fs%s — "
                    "pinning the fan-out/spill commit path for %.1fs",
                    len(self._failures), self.window_s,
                    f" ({source})" if source else "", self.open_s,
                )
                return True
        return False

    def record_success(self) -> None:
        with self._lock:
            if self._state == "half-open":
                self._state = "closed"
                self._failures.clear()
                logger.info("circuit breaker closed (trial succeeded)")

    def is_open(self) -> bool:
        with self._lock:
            if self._state == "open":
                if time.monotonic() - self._opened_at >= self.open_s:
                    self._state = "half-open"
                    return False
                return True
            return False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state


@dataclass
class RecoveryReport:
    watermark: Optional[int]
    replayed_intervals: int
    skipped_intervals: int
    corrupt_lines: int
    wall_time_s: float
    checkpoint_found: bool
    journal_found: bool


class RecoveryManager:
    """Owns the durability pair (checkpoint cadence + journal) and the
    restart-time replay.  ``on_commit`` rides the committer bridge: one
    watermark store per interval plus a cadenced checkpoint — the async
    checkpoint never blocks ingest, only the bridge's commit loop, and
    the staging rings absorb that hiccup like any other slow interval."""

    def __init__(
        self,
        metric_system,
        aggregator=None,
        committer=None,
        lifecycle=None,
        anomaly=None,
        *,
        checkpoint_path: Optional[str] = None,
        journal_path: Optional[str] = None,
        checkpoint_every_intervals: int = 10,
        fault_injector: Optional[FaultInjector] = None,
    ):
        self._ms = metric_system
        self._agg = aggregator
        self._committer = committer
        self._lifecycle = lifecycle
        self._anomaly = anomaly
        self.checkpoint_path = checkpoint_path
        self.journal_path = journal_path
        self.checkpoint_every_intervals = max(
            int(checkpoint_every_intervals), 1
        )
        self.fault_injector = fault_injector
        self._lock = threading.Lock()
        self._journal = None
        self.in_progress = False
        self.last_seq: Optional[int] = None
        self.last_checkpoint_seq: Optional[int] = None
        self.checkpoints_taken = 0
        self.checkpoint_errors = 0
        self.checkpoint_last_ms = 0.0
        self.replayed_intervals = 0
        self.recoveries = 0
        self._since_checkpoint = 0
        self._mesh = getattr(aggregator, "mesh", None)

    # -- bridge-side cadence -------------------------------------------- #

    def on_commit(self, raw) -> None:
        """Committer tail hook (bridge thread).  Always advances the
        watermark; takes a checkpoint every N intervals unless a
        recovery replay is driving the commits."""
        if raw.seq is not None:
            self.last_seq = int(raw.seq)
        if self.in_progress or self.checkpoint_path is None:
            return
        self._since_checkpoint += 1
        inj = self.fault_injector
        if inj is not None:
            inj.check("recovery.tick")
        if self._since_checkpoint >= self.checkpoint_every_intervals:
            self.checkpoint_now()

    def checkpoint_now(self) -> bool:
        """Atomic snapshot stamped with the current watermark.  A failed
        write (disk full, injected crash) leaves the previous checkpoint
        intact — counted, logged, never fatal to the bridge."""
        if self.checkpoint_path is None:
            return False
        from loghisto_tpu_torch.utils import checkpoint

        t0 = time.perf_counter()
        try:
            with self._lock:
                if self._mesh is not None:
                    self._check_watermark()
                checkpoint.save(
                    self.checkpoint_path,
                    self._ms,
                    self._agg,
                    self._lifecycle,
                    self._anomaly,
                    seq_watermark=self.last_seq,
                    fault_injector=self.fault_injector,
                )
        except Exception as e:
            self.checkpoint_errors += 1
            logger.warning(
                "checkpoint to %s failed (%s); previous snapshot intact",
                self.checkpoint_path, e,
            )
            self._since_checkpoint = 0
            return False
        self.checkpoint_last_ms = (time.perf_counter() - t0) * 1000.0
        self.checkpoints_taken += 1
        self.last_checkpoint_seq = self.last_seq
        self._since_checkpoint = 0
        return True

    def _check_watermark(self) -> None:
        """On a mesh: raise unless every rank's watermark is one seq (a
        MIN and a MAX over the mesh, in one reduction)."""
        import torch.distributed as dist

        from loghisto_tpu_torch.parallel.mesh import mesh_reduce

        seq = -1 if self.last_seq is None else int(self.last_seq)
        hi, neg_lo = mesh_reduce(self._mesh, [seq, -seq],
                                 dist.ReduceOp.MAX)
        if hi != -neg_lo:
            raise ValueError(
                f"the ranks' watermarks differ ({-neg_lo} to {hi}): a "
                "checkpoint names only an interval every rank committed")

    # -- restart-time replay -------------------------------------------- #

    def _replay_one(self, raw) -> None:
        """One journal interval through the commit path the bridges run
        live."""
        if self._committer is not None:
            self._committer.commit(raw)
            return
        # fan-out path: feed both consumers the bridges would have fed
        if self._agg is not None:
            self._agg.merge_raw(raw)
        wheel = getattr(self._ms, "retention", None)
        if wheel is not None:
            wheel.push(raw)

    def recover(self) -> RecoveryReport:
        """Restore checkpoint + replay journal past the watermark.  Safe
        on a cold start (neither file exists -> empty report).  Sets
        ``in_progress`` for the HealthWatchdog invariant and to suppress
        cadence checkpoints while replayed intervals flow through the
        committer.  The journal is every file ``journal.row_journals``
        lists: the plain path, which replays line by line as the
        reference's does, and the rows' files of any mesh, merged by seq
        (``_row_intervals``); one device is row 0 of 1.  On a mesh a
        collective call (the module docstring has the rules)."""
        import torch.distributed as dist

        from loghisto_tpu_torch.parallel.mesh import (
            STREAM_AXIS,
            agreed,
            axis_index,
            axis_size,
            mesh_reduce,
        )
        from loghisto_tpu_torch.utils import checkpoint, journal

        mesh = self._mesh
        t0 = time.perf_counter()
        watermark: Optional[int] = None
        ckpt_found = (self.checkpoint_path is not None
                      and os.path.exists(self.checkpoint_path))
        if mesh is not None:
            # one answer on every rank, so every rank takes the same path
            ckpt_found = agreed(mesh, ckpt_found)
        files = ([] if self.journal_path is None
                 else journal.row_journals(self.journal_path))
        corrupt_before = journal.corrupt_lines_total()
        self.in_progress = True
        try:
            if ckpt_found:
                watermark = checkpoint.restore(
                    self.checkpoint_path, self._ms, self._agg,
                    self._lifecycle, self._anomaly)
                if watermark is not None:
                    self.last_seq = watermark
            row, rows = ((0, 1) if mesh is None else
                         (axis_index(mesh, STREAM_AXIS),
                          axis_size(mesh, STREAM_AXIS)))
            raws, skipped = _row_intervals(files, watermark, row, rows)
            top = max((r.seq for r in raws if r.seq is not None),
                      default=watermark or 0)
            most, neg_least, max_seq = (
                [len(raws), -len(raws), top] if mesh is None else
                mesh_reduce(mesh, [len(raws), -len(raws), top],
                            dist.ReduceOp.MAX))
            if most != -neg_least:
                raise RuntimeError(
                    f"the ranks read {-neg_least} to {most} journal "
                    "intervals: every rank must see every row's journal")
            for raw in raws:
                self._replay_one(raw)
            if top:
                self.last_seq = top
            # the reapers mint seqs past everything any rank recovered,
            # so the rows' new intervals line up again and the next
            # journal lines do not collide with replayed ones
            if max_seq and hasattr(self._ms, "_interval_seq"):
                self._ms._interval_seq = itertools.count(max_seq + 1)
        finally:
            self.in_progress = False
        return self._report(t0, watermark, len(raws), skipped,
                            corrupt_before, ckpt_found, bool(files))

    def _report(self, t0, watermark, replayed, skipped, corrupt_before,
                ckpt_found, jrnl_found) -> RecoveryReport:
        from loghisto_tpu_torch.utils import journal

        self.replayed_intervals += replayed
        self.recoveries += 1
        report = RecoveryReport(
            watermark=watermark,
            replayed_intervals=replayed,
            skipped_intervals=skipped,
            corrupt_lines=journal.corrupt_lines_total() - corrupt_before,
            wall_time_s=time.perf_counter() - t0,
            checkpoint_found=ckpt_found,
            journal_found=jrnl_found,
        )
        logger.info(
            "recovery: watermark=%s replayed=%d skipped=%d corrupt=%d "
            "in %.1fms",
            report.watermark, report.replayed_intervals,
            report.skipped_intervals, report.corrupt_lines,
            report.wall_time_s * 1000.0,
        )
        return report

    # -- lifecycle ------------------------------------------------------ #

    def start(self) -> None:
        """Start the journal subscriber (idempotent).  On a mesh the
        rank at metric index 0 of each stream row journals the row's
        intervals to ``row_journal_path``; the row's other ranks, whose
        raw sets are the same, journal nothing."""
        if self.journal_path is None or self._journal is not None:
            return
        from loghisto_tpu_torch.utils.journal import RawJournal

        path = self.journal_path
        if self._mesh is not None:
            from loghisto_tpu_torch.parallel.mesh import (
                METRIC_AXIS,
                STREAM_AXIS,
                axis_index,
                axis_size,
            )
            from loghisto_tpu_torch.utils.journal import row_journal_path

            if axis_index(self._mesh, METRIC_AXIS) != 0:
                return
            path = row_journal_path(
                path, axis_index(self._mesh, STREAM_AXIS),
                axis_size(self._mesh, STREAM_AXIS))
        self._journal = RawJournal(self._ms, path)
        self._journal.fault_injector = self.fault_injector
        self._journal.start()

    def stop(self, final_checkpoint: bool = True) -> None:
        """Stop the journal; a clean shutdown checkpoint makes restart
        lossless (the journal covers the crash case)."""
        if self._journal is not None:
            self._journal.stop()
            self._journal = None
        if final_checkpoint and self.checkpoint_path is not None:
            self.checkpoint_now()


def _row_intervals(files, watermark, row: int, rows: int):
    """Stream row ``row`` of ``rows``'s intervals past ``watermark`` from
    every saved row's journal (``journal.row_journals``).  The lines of
    one interval are the n-th line of a seq in each file (a journal
    appended to by a restart that did not recover holds a seq twice),
    or the n-th seq-less line of each file; their merged raw sets of the
    saved rows j with ``j % rows == row``, or an empty interval where
    this row has none, each holding every name of the interval's lines
    in file order, so each rank registers the same names in the same
    order.  The intervals run in the order of a merge of the files by
    (n, seq), a seq-less line where it stands in its file: one file
    replays line by line in file order, as the reference replays its
    journal, and the rows' files in seq order.  Returns (intervals,
    skipped lines)."""
    import dataclasses
    import functools
    import heapq

    from loghisto_tpu_torch.metrics import RawMetricSet, \
        merge_raw_metric_sets
    from loghisto_tpu_torch.utils import journal

    walks = []
    skipped = 0
    for j, _, path in files:
        walk, seen, at = [], {}, (0, -1)
        for raw in journal.replay(path):
            if (watermark is not None and raw.seq is not None
                    and raw.seq <= watermark):
                skipped += 1
                continue
            seq = raw.seq
            n = seen[seq] = seen.get(seq, -1) + 1
            if seq is not None:
                at = (n, seq)
            walk.append((at, (n, seq), j % rows == row, raw))
        walks.append(walk)
    by_key: dict = {}
    for _, key, own, raw in heapq.merge(*walks, key=lambda w: w[0]):
        by_key.setdefault(key, []).append((own, raw))
    out = []
    for (_, seq), entries in by_key.items():
        names = dict.fromkeys(n for _, raw in entries for n in raw.histograms)
        mine = [raw for own, raw in entries if own]
        if mine:
            merged = functools.reduce(merge_raw_metric_sets, mine)
        else:
            first = entries[0][1]
            merged = RawMetricSet(min(raw.time for _, raw in entries), {},
                                  {}, {}, {}, duration=first.duration)
        out.append(dataclasses.replace(
            merged, histograms={n: merged.histograms.get(n, {})
                                for n in names}, seq=seq))
    return out, skipped


def register_resilience_gauges(
    ms,
    supervisor=None,
    breaker=None,
    recovery=None,
    injector=None,
) -> None:
    """Surface the resilience subsystem on the ordinary gauge pipeline
    (scrapes/exports see ``resilience.*`` next to everything else)."""
    from loghisto_tpu_torch.utils import journal

    if supervisor is not None:
        ms.register_gauge_func(
            "resilience.ThreadRestarts",
            lambda: float(supervisor.total_restarts),
        )
        ms.register_gauge_func(
            "resilience.RestartBackoffMs",
            lambda: float(supervisor.current_backoff_ms()),
        )
    if breaker is not None:
        ms.register_gauge_func(
            "resilience.BreakerOpen",
            lambda: 1.0 if breaker.state != "closed" else 0.0,
        )
        ms.register_gauge_func(
            "resilience.BreakerOpenedTotal",
            lambda: float(breaker.opened_total),
        )
        ms.register_gauge_func(
            "resilience.BreakerFailures",
            lambda: float(breaker.failures_total),
        )
    if recovery is not None:
        ms.register_gauge_func(
            "resilience.CheckpointsTaken",
            lambda: float(recovery.checkpoints_taken),
        )
        ms.register_gauge_func(
            "resilience.CheckpointErrors",
            lambda: float(recovery.checkpoint_errors),
        )
        ms.register_gauge_func(
            "resilience.CheckpointLastMs",
            lambda: float(recovery.checkpoint_last_ms),
        )
        ms.register_gauge_func(
            "resilience.ReplayedIntervals",
            lambda: float(recovery.replayed_intervals),
        )
        ms.register_gauge_func(
            "resilience.RecoveryInProgress",
            lambda: 1.0 if recovery.in_progress else 0.0,
        )
    if injector is not None:
        ms.register_gauge_func(
            "resilience.FaultsInjected",
            lambda: float(injector.faults_injected),
        )
    ms.register_gauge_func(
        "journal.CorruptLines",
        lambda: float(journal.corrupt_lines_total()),
    )
