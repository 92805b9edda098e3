"""IntervalCommitter: one subscription that lands every interval on the
aggregator and on every retention tier (counterpart of
``loghisto_tpu/commit.py``, for a single-device pair on dense or paged
storage, and for one rank of a mesh on dense or paged storage).

The fan-out path resolves an interval's names twice and uploads its
cells twice (the aggregator's bridge, ``merge_raw``, and the wheel's,
``push``).  The committer replaces both bridges:

  1. the interval's sparse histograms become ``(id, codec bucket,
     count)`` cells ONCE, through the aggregator's registry policy (the
     wheel shares the registry);
  2. each chunk of at most ``chunk`` cells goes through the depth-2
     pinned staging ring (``ops.commit.CellStagingRing``);
  3. one commit step per chunk (``ops.commit.make_fused_commit_fn``)
     adds it to the accumulator, to every tier's open slot and, with a
     ``LifecycleManager`` / ``AnomalyManager``, stamps the activity
     vector and folds the interval histogram; the last step builds the
     snapshot payloads and updates the EWMA baseline bank
     (``make_fused_commit_snapshot_fn``).

On paged storage the page pool is the accumulator: under both locks each
chunk's cells are also translated against the page table on the host
(``PagedStore.translate``: pages map on demand, cells no page can hold
go to the exact host spill there) and staged through a
``PagedTripleRing``; the step adds them into the pool with K4 before
the tiers' K3.  The final step publishes the tier snapshots only —
``agg.stats_snapshot`` stays unset, and ``PagedStore.query`` / ``stats``
serve the pool.  The drift engine stays dense-only: its carries are
dense ``[M, B]`` tensors.

``last_dispatches`` counts commit steps, ``ceil(cells / chunk)`` for a
fused interval, as the reference counts its program calls; the kernel
launches behind them are counted by ``ops.backend.kernel_launches()``.

Overflow contract: an interval whose total would cross the aggregator's
``spill_threshold``, or a cell of weight >= 2^30, takes the aggregator's
exact host spill (``_merge_cells_locked``) and the wheel's own push.

Lock order: the aggregator's ``_dev_lock``, then the wheel's lock.

Observability: with a span ring installed (``obs_recorder``) a commit
adopts the interval's seq and records ``commit.cells``,
``commit.upload``, ``commit.dispatch``, ``commit.device_sync`` (the
wait on the commit's queued CUDA work, ``device_sync``) and
``commit.snapshot_publish``, all inside its ``commit.e2e`` span; then
the watchdog notes the commit, the freshness hook (the federation
receiver's ``note_publish``) completes the frames applied before it,
and the self-observer re-ingests the interval's spans.

Failure (D6, closed): a failed commit step is recovered as the
reference recovers it (``_on_fused_failure_locked``).  The aggregator's
handler arms the retry cooldown, drops ``stats_snapshot`` and counts
the failure on the breaker; the lifecycle and drift engines' handlers
run; the wheel's snapshot is invalidated (queries recompute until the
next commit publishes); the cells of the chunks not applied fold into
the aggregator's exact host spill, and on paged storage the chunk
whose translate ran but whose step failed re-lands through
``PagedStore.spill_triples``.  The tiers keep the chunks that landed
and close their slots, as in the reference.  The reference rebuilds
the carries its donated dispatch consumed; the port's steps update in
place, so a failure consumes nothing and no ring is reset.  What fails
outside the commit steps' net (a hook, the lifecycle tick) still leaves
``commit``; on the bridge thread it is logged and kept as
``bridge_error`` (also on the aggregator and the wheel), so the next
query, ``device_metrics()`` and ``stop()`` re-raise it.

On a ("stream", "metric") mesh (ROADMAP D8, D9) the aggregator and the
wheel hold this rank's blocks and the rank commits its stream row's
intervals; the global interval is the union over the stream rows.  The
ranks first agree, in one reduction over the mesh, on the interval's
chunk count (the most any stream row needs at ``chunk / n_stream``
cells a rank) and on the path: any rank past its share of the int32
envelope (``spill_threshold / n_stream``) or with an open breaker takes
every rank to the fan-out, which lands the row's cells in the
accumulator and gathers them for the wheel's push.  On the fused path
each chunk is one step of ``make_sharded_fused_commit_fn``: the stream
rows' shares gathered, the rank's own share into its accumulator block
(which stays the stream row's partial until ``collect()`` reduces it;
cells of rows the registry grew past the blocks wait on the host for
``collect()``'s re-layout), the gathered chunk into its block of every
tier's open slot.  With a ``LifecycleManager`` / ``AnomalyManager``
(ROADMAP D10, item 11b-2) the step also stamps the activity block and
folds the interval histogram block from the gathered chunk, and the
last one updates the rank's bank block; the commit lays out the
registry's growth first, carries and accumulator together.  A rank
whose step fails recovers as above and still sends its later chunks,
so its peers' rings miss nothing, and stamps every gathered chunk's
ids, so its activity block stays its peers'.  No
accumulator snapshot is published: ``agg.stats_snapshot`` stays None.
D9's thread rule: every collective runs at a collective entry point on
the rank's main thread.  ``commit()`` is one, so every rank calls it
for the same intervals in the same order; an attached bridge only
queues the broadcast intervals, and ``commit()`` and ``drain()`` (the
system's ``device_metrics()``, ``backfill_retention`` and window
queries call it) commit the queued ones first, in seq order, as many as
every rank holds.  The scoring pass and the lifecycle tick that follow
a commit are collectives too (``AnomalyManager.score_now``,
``LifecycleManager.check``, ``evict_ids`` and ``compact``), run on the
same thread in the same order on every rank.

On paged storage on a mesh (ROADMAP D12, item 11c-1) a translate
chooses codecs and maps pages from the cells it is given, so every rank
commits the MERGED interval: the stream rows' histograms are gathered
once an interval (one ``all_gather_object`` of the stream line) and
merged in stream order as ``merge_raw_metric_sets`` merges them, the
registry's growth is laid out, the aggregator's staged batches land,
and then every rank chunks and translates the same cells, as the
reference's one controller does, and runs one step of
``make_paged_fused_commit_fn`` a chunk on its arena's triples (arena
slots) and its ring blocks' cells (block ids): K4, one K3, K5 views
last.  The steps make no collective.  A failed step spills the rank's own arena's triples;
the fan-out (an open breaker on any rank, or the int32 envelope, which
every rank counts alike) merges the cells on every rank and pushes them
to the wheel from stream index 0 alone.  With lifecycle on (ROADMAP
D13) each step stamps the rank's activity block with the chunk's ids in
the aggregator's block, the fan-out with the merged interval's, and a
rank whose step failed stamps them all, as its peers did.

Resilience, installed by ``TorchMetricSystem(resilience=...)``: an open
``breaker`` pins the fan-out path (the aggregator's ``_merge_cells_locked``
and the wheel's push, K3 on the card) until a half-open trial commit
succeeds; ``fault_injector`` fires ``commit.dispatch`` inside the
steps' net, before a chunk, and ``commit.bridge`` in the bridge loop,
outside the per-commit net, so a bridge crash reaches ``supervisor``,
which restarts the bridge (the same closure, on the same staging rings
and events, and on the thread's default stream, which
``device_sync`` waits on); ``recovery.on_commit`` ends every commit
(the watermark and the cadenced checkpoint).
"""

from __future__ import annotations

import datetime as _dt
import logging
import threading
import time
from typing import Optional

import numpy as np
import torch

from loghisto_tpu_torch.channel import ChannelClosed, ResilientSubscription
from loghisto_tpu_torch.metrics import (
    MetricSystem,
    RawMetricSet,
    empty_interval,
    merge_raw_metric_sets,
)
from loghisto_tpu_torch.obs.spans import NULL_RECORDER, LatencyHistogram
from loghisto_tpu_torch.ops.commit import (
    COMMIT_CHUNK,
    CellStagingRing,
    PagedTripleRing,
    make_fused_commit_fn,
    make_fused_commit_snapshot_fn,
    make_paged_fused_commit_fn,
    make_paged_fused_commit_snapshot_fn,
    make_sharded_fused_commit_fn,
    make_sharded_fused_commit_snapshot_fn,
)
from loghisto_tpu_torch.parallel.mesh import (
    STREAM_AXIS,
    IntervalQueue,
    all_gather_objects,
    axis_size,
    block_ids,
    gather_triples,
    is_stream_lead,
    mesh_reduce,
    pad_triples,
)
from loghisto_tpu_torch.resilience.supervise import spawn_thread
from loghisto_tpu_torch.window.snapshot import AccSnapshot
from loghisto_tpu_torch.window.store import trailing_mask

logger = logging.getLogger("loghisto_tpu_torch")


def commit_incompatibility(aggregator, wheel) -> Optional[str]:
    """Why this (aggregator, wheel) pair cannot share one fused commit,
    or None when it can: one cell array feeds both, so they must agree
    on row ids (one registry), bucket geometry, device and mesh."""
    if aggregator.registry is not wheel.registry:
        return "aggregator and wheel use different registries"
    if aggregator.config.bucket_limit != wheel.config.bucket_limit:
        return (
            f"bucket_limit mismatch (aggregator "
            f"{aggregator.config.bucket_limit}, wheel "
            f"{wheel.config.bucket_limit})"
        )
    if aggregator.config.precision != wheel.config.precision:
        return (
            f"precision mismatch (aggregator {aggregator.config.precision},"
            f" wheel {wheel.config.precision})"
        )
    if aggregator.device != wheel.device:
        return (
            f"aggregator on {aggregator.device}, wheel on {wheel.device}"
        )
    if getattr(aggregator, "mesh", None) is not getattr(wheel, "mesh", None):
        return (
            "aggregator and wheel are sharded over different meshes (the "
            "fused program's carries must share one row sharding)"
        )
    return None


def _time_us(t) -> int:
    """An interval's time as POSIX microseconds (-1 for None), for the
    mesh's agreement on it."""
    if t is None:
        return -1
    return int(round(t.timestamp() * 1e6))


def _from_time_us(us: int, t):
    """The agreed time: ``t`` when it is the agreed one, else the
    datetime of ``us`` (UTC unless ``t`` names a zone; None for -1)."""
    if us < 0:
        return None
    if t is not None and _time_us(t) == us:
        return t
    tz = _dt.timezone.utc if t is None else t.tzinfo
    return (_dt.datetime.fromtimestamp(us // 1_000_000, tz)
            + _dt.timedelta(microseconds=us % 1_000_000))


def device_sync(device: torch.device) -> None:
    """Wait for the work this thread queued on the card: an event
    recorded on the current stream, then its host-side wait.  On the CPU
    every step already ran when it returned."""
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        event.synchronize()


class IntervalCommitter:
    """One-subscription interval commit for a (TorchAggregator,
    TimeWheel) pair, on dense or paged storage.  ``chunk`` is the commit
    step's width in cells (tests shrink it to force multi-step
    intervals); ``staging_depth`` sizes the upload ring."""

    def __init__(
        self,
        aggregator,
        wheel,
        chunk: int = COMMIT_CHUNK,
        staging_depth: int = 2,
        lifecycle=None,
        anomaly=None,
    ):
        reason = commit_incompatibility(aggregator, wheel)
        if reason is not None:
            raise ValueError(f"fused commit unavailable: {reason}")
        if anomaly is not None and not wheel.snapshots_enabled:
            raise ValueError(
                "drift engine requires commit-time snapshots: the EWMA "
                "bank update rides the final commit step and scoring "
                "consumes the published window CDFs"
            )
        self.paged = getattr(aggregator, "paged", None)
        if anomaly is not None and self.paged is not None:
            raise ValueError(
                "drift engine requires the dense accumulator: the "
                "interval-histogram and EWMA baseline-bank carries are "
                "dense [M, B] tensors, which paged storage exists to "
                "avoid keeping"
            )
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.aggregator = aggregator
        self.wheel = wheel
        self.chunk = int(chunk)
        self.lifecycle = lifecycle
        self.anomaly = anomaly
        tiers_n = len(wheel._tiers)
        bl, prec = wheel.config.bucket_limit, wheel.config.precision
        track, track_b = lifecycle is not None, anomaly is not None
        self.mesh = getattr(aggregator, "mesh", None)
        width = self.chunk
        if self.mesh is not None:
            n_stream = axis_size(self.mesh, STREAM_AXIS)
            if self.chunk % n_stream:
                raise ValueError(
                    f"commit chunk {self.chunk} not divisible by the mesh "
                    f"stream axis ({n_stream}): staged cell chunks always "
                    "pad to the full width, which must split evenly"
                )
        if self.mesh is not None and self.paged is None:
            # a rank stages its stream row's share of each chunk
            width = self.chunk // n_stream
            self._fused = make_sharded_fused_commit_fn(
                self.mesh, tiers_n, bl, track, track_b)
            self._fused_snap = make_sharded_fused_commit_snapshot_fn(
                self.mesh, tiers_n, bl, prec, track_activity=track,
                track_baseline=track_b)
        elif self.paged is not None:
            # on a mesh too (D12): every rank commits the merged
            # interval's chunks, cut to its arena and its ring blocks
            self._fused = make_paged_fused_commit_fn(tiers_n, bl, track)
            self._fused_snap = make_paged_fused_commit_snapshot_fn(
                tiers_n, bl, prec, track_activity=track)
        else:
            self._fused = make_fused_commit_fn(tiers_n, bl, track, track_b)
            self._fused_snap = make_fused_commit_snapshot_fn(
                tiers_n, bl, prec, track_activity=track,
                track_baseline=track_b,
            )
        self._staging = CellStagingRing(depth=staging_depth, width=width,
                                        device=aggregator.device)
        self._triples = (
            PagedTripleRing(depth=staging_depth, width=self.chunk,
                            device=aggregator.device)
            if self.paged is not None else None
        )

        self._metrics_lock = threading.Lock()
        self.intervals_committed = 0
        self.fused_intervals = 0
        self.fanout_intervals = 0  # spill fan-outs
        self.last_dispatches = 0
        self.last_h2d_bytes = 0
        self.last_uploads = 0
        self._latency_hist = LatencyHistogram(prec)
        # observability: the span ring, the self-observer and the
        # watchdog, installed by TorchMetricSystem(observability=...);
        # the defaults cost a no-op call per site
        self.obs_recorder = NULL_RECORDER
        self.self_observer = None
        self.watchdog = None
        # the federation receiver's note_publish, installed by
        # TorchMetricSystem(federation=...): frames applied before this
        # commit complete their freshness once the interval is queryable
        self.freshness_hook = None

        # resilience, installed by TorchMetricSystem(resilience=...)
        self.supervisor = None
        self.breaker = None
        self.fault_injector = None
        self.recovery = None
        # the paged chunk whose translate ran but whose step has not
        # returned: (triples, cells) for the failure recovery
        self._trip_inflight = None

        self._ms: Optional[MetricSystem] = None
        self._sub: Optional[ResilientSubscription] = None
        self._thread: Optional[threading.Thread] = None
        self.bridge_error: Optional[BaseException] = None
        # on a mesh, the attached bridge's queue (D9)
        self._queue = None

    # -- cell construction ---------------------------------------------- #

    def _cells_from_raw(self, raw: RawMetricSet):
        """Sparse interval histograms -> (ids int32, codec bucket int64,
        weight int64), resolved once through the aggregator's registry
        policy (growth up to max_metrics, shed past it).  Shed samples
        are mirrored into the wheel's shed counter."""
        agg = self.aggregator
        ids, bidx, weights = [], [], []
        shed = 0
        for name, bucket_counts in raw.histograms.items():
            n = len(bucket_counts)
            counts = np.fromiter(bucket_counts.values(), np.int64, n)
            total = int(counts.sum())
            mid = agg._id_for(name, samples=total)
            if mid < 0:
                shed += total
                continue
            if not n:
                continue
            ids.append(np.full(n, mid, dtype=np.int32))
            bidx.append(np.fromiter(bucket_counts.keys(), np.int64, n))
            weights.append(counts)
        if shed:
            with self.wheel._lock:
                self.wheel.shed_samples += shed
        if not ids:
            return None
        return np.concatenate(ids), np.concatenate(bidx), \
            np.concatenate(weights)

    def _merged_interval(self, raw: RawMetricSet) -> RawMetricSet:
        """D12, on a paged mesh: the global interval's histograms, the
        stream rows' intervals merged in stream order as
        ``merge_raw_metric_sets(row 0, row 1, ...)`` merges them (names
        and buckets in order of first appearance), so every rank chunks
        and translates the same cells in the reference's order.  One
        ``all_gather_object`` of the stream line."""
        merged = None
        for hists in all_gather_objects(self.mesh, raw.histograms):
            part = RawMetricSet(time=raw.time, counters={}, rates={},
                                histograms=hists, gauges={})
            merged = part if merged is None else merge_raw_metric_sets(
                merged, part)
        return merged

    def _dense_cells(self, cells):
        """(ids, codec bucket, int64 weight) -> the wheel's dense int32
        triplet (the same conversion as ``TimeWheel._cells_from_raw``:
        buckets clip to the dense range, weights to int32)."""
        ids, bidx64, w64 = cells
        bl = self.wheel.config.bucket_limit
        idx = (np.clip(bidx64, -bl, bl) + bl).astype(np.int32)
        w32 = np.minimum(w64, np.int64(2**31 - 1)).astype(np.int32)
        return ids, idx, w32

    # -- the commit ----------------------------------------------------- #

    def commit(self, raw: RawMetricSet, duration: Optional[float] = None):
        """Land one interval on the aggregator AND every retention tier,
        then score drift, run the wheel's hooks and the lifecycle tick.
        Returns the path taken ("fused", "fanout" or "empty").  On a mesh
        ``raw`` is this rank's stream row's interval, and the call is a
        collective that commits the queued intervals first."""
        self.drain()
        return self._commit_one(raw, duration)

    def drain(self, final: bool = False) -> int:
        """Commit the intervals an attached bridge queued on a mesh, as
        many as every rank holds (with ``final``, as the last drain at
        ``stop()``, the most any rank holds, a rank short of it an empty
        interval for each it lacks); a collective of the mesh.  0 and no
        collective off a mesh or before ``attach``."""
        if self._queue is None:
            return 0
        return self._queue.drain(final)

    @property
    def queued_intervals(self) -> int:
        """Intervals the bridge queued on a mesh that no collective call
        has committed yet (D9): on the host, not yet queryable."""
        return 0 if self._queue is None else len(self._queue)

    def _commit_one(self, raw: RawMetricSet,
                    duration: Optional[float] = None):
        rec = self.obs_recorder
        # adopt the reaper-minted interval seq: every span recorded until
        # the next commit attributes to this interval
        seq = rec.begin_interval(raw.seq)
        t0_ns = time.perf_counter_ns()
        t0 = time.perf_counter()
        wheel = self.wheel
        dur = (
            float(duration) if duration is not None
            else float(raw.duration) if raw.duration is not None
            else wheel.interval
        )
        up0 = self._staging.uploads
        b0 = self._staging.bytes_uploaded
        with rec.span("commit.cells", seq):
            if self.mesh is not None and self.paged is not None:
                cells = self._cells_from_raw(self._merged_interval(raw))
            else:
                cells = self._cells_from_raw(raw)
        when = raw.time
        if self.mesh is not None:
            mode, dispatches, when = self._commit_cells_mesh(cells, raw, dur)
        elif cells is None:
            # slot rotation and durations still advance
            wheel.push_cells(None, raw, dur)
            mode, dispatches = "empty", 0
        else:
            mode, dispatches = self._commit_cells(cells, raw, dur)
        if self.anomaly is not None:
            # score the snapshot just published BEFORE the hooks, so
            # drift rules evaluate this interval's scores
            self.anomaly.on_interval(raw, when)
        wheel.run_hooks(raw)
        if self.lifecycle is not None:
            # the policy tick runs outside every lock, on this thread:
            # no interval's cells are in flight while rows move
            self.lifecycle.on_interval()
        us = (time.perf_counter() - t0) * 1e6
        # the end-to-end span every stage span above nests inside
        rec.record("commit.e2e", t0_ns, time.perf_counter_ns(), seq)
        with self._metrics_lock:
            self.intervals_committed += 1
            if mode == "fused":
                self.fused_intervals += 1
            elif mode == "fanout":
                self.fanout_intervals += 1
            self.last_dispatches = dispatches
            self.last_uploads = self._staging.uploads - up0
            self.last_h2d_bytes = self._staging.bytes_uploaded - b0
        self._latency_hist.add(us)
        if self._ms is not None:
            # the commit latency rides the normal pipeline, like any
            # other metric
            self._ms.histogram("commit.LatencyUs", us)
        if self.watchdog is not None:
            self.watchdog.note_commit(seq)
        if self.freshness_hook is not None:
            # a publisher's failure must not fail the commit that landed
            try:
                self.freshness_hook(seq)
            except Exception:  # noqa: BLE001 - the reference's swallow
                logger.exception("freshness hook failed")
        if self.self_observer is not None:
            # this interval's closed spans re-enter through histogram()
            # as obs.<stage>.LatencyUs
            self.self_observer.on_interval(seq)
        if self.recovery is not None:
            # the watermark and the cadenced checkpoint ride the bridge
            # thread, never the ingest path
            self.recovery.on_commit(raw)
        return mode

    def _commit_cells(self, cells, raw: RawMetricSet, dur: float):
        """Commit one interval's cells.  Returns (mode, dispatches)."""
        agg, wheel = self.aggregator, self.wheel
        ids, bidx64, w64 = cells
        total = int(w64.sum(dtype=np.int64))
        # an open breaker pins the fan-out path: after repeated device
        # failures, stop attempting the fused commit until the open
        # window passes and a half-open trial succeeds
        pinned = self.breaker is not None and self.breaker.is_open()
        with agg._dev_lock:
            if (
                pinned
                or agg._interval_ingested + total >= agg.spill_threshold
                or int(w64.max()) >= 1 << 30
            ):
                # pinned, or past the int32 envelope: the aggregator
                # merges the cells itself (K3, or its exact host spill
                # past the envelope), the tiers take their own push below
                agg._merge_cells_locked(ids, bidx64, w64)
                agg.stats_snapshot = None
                if self.lifecycle is not None:
                    self.lifecycle.touch_locked(ids)
                dispatches = None
            else:
                with wheel._lock:
                    dispatches = self._fused_dispatch_locked(cells, raw, dur)
        if dispatches is not None:
            return "fused", dispatches
        wheel.push_cells(self._dense_cells(cells), raw, dur)
        # the reference's estimate: per chunk, one scatter for the
        # aggregator plus one per tier
        nchunks = -(-len(ids) // self.chunk)
        return "fanout", nchunks * (1 + len(wheel._tiers))

    def _post_close_masks(self, t, slot: int, dur: float, windows):
        """Snapshot view masks of one tier as they will read AFTER this
        interval's close-out, computed before the commit steps run:
        ``_tier_close_locked``'s metadata fold simulated on copies, then
        the same ``trailing_mask`` walk as a query."""
        written = t.written.copy()
        durations = t.durations.copy()
        written[slot] = True
        durations[slot] += dur
        in_slot = t.in_slot + 1
        cur = slot
        if in_slot >= t.spec.res:
            cur = (slot + 1) % t.spec.slots
            in_slot = 0
        return np.stack([
            trailing_mask(written, durations, cur, in_slot,
                          t.spec.slots, w)
            for w in windows
        ])

    def _fused_dispatch_locked(self, cells, raw: RawMetricSet,
                               dur: float, note: bool = True) -> int:
        """The fused path (caller holds agg._dev_lock, then
        wheel._lock): stage each chunk (on paged storage, translate it
        against the page table and stage its triples too — on a mesh the
        triples of the rank's arena and the cells of its ring blocks),
        run one commit step on it — the
        first with the ring-wrap keep factors, the last the snapshot
        variant — then close the tiers and publish the snapshots.
        ``note`` False notes the interval without its samples (a paged
        mesh rank off stream index 0: the merged cells are counted
        once).  Returns the number of commit steps."""
        agg, wheel = self.aggregator, self.wheel
        ids, idx, w32 = self._dense_cells(cells)
        buckets = idx - np.int32(wheel.config.bucket_limit)
        w64 = cells[2]
        tiers = wheel._tiers
        slots, keeps, windows, masks = self._open_tiers_locked(
            raw, dur, (ids, idx, w32) if note else None)
        ones = [1] * len(tiers)
        lc, an = self.lifecycle, self.anomaly
        if lc is not None:
            la = lc.ensure_capacity_locked(agg.num_metrics)
            epoch = wheel.intervals_pushed
        if an is not None:
            ihist, banks = an.ensure_capacity_locked(agg.num_metrics)
            bank = an.bank_for(raw.time)
        emit = masks is not None
        n = len(ids)
        dispatches = 0
        applied = 0
        payloads = acc_payload = None
        paged = self.paged
        # a paged mesh rank's activity block takes the chunk's ids in the
        # aggregator's block, whose rows need not be the ring blocks'
        stamp = None

        def landed():
            # the chunk is in the accumulator (K3) or the pool (K4): the
            # step's later launches may still fail, but from here the
            # recovery must not spill or re-land it again
            nonlocal applied
            applied = off + take
            self._trip_inflight = None
            agg._device_down_until = 0.0
            agg._interval_ingested += int(
                w64[off:off + take].sum(dtype=np.int64))

        try:
            inj = self.fault_injector
            for off in range(0, n, self.chunk):
                if inj is not None:
                    # inside the net: an injected failure is recovered
                    # as an organic one is
                    inj.check("commit.dispatch")
                take = min(self.chunk, n - off)
                with self.obs_recorder.span("commit.upload"):
                    cut = (ids[off:off + take], buckets[off:off + take],
                           w32[off:off + take])
                    if paged is not None and self.mesh is not None:
                        if lc is not None:
                            stamp = torch.from_numpy(block_ids(
                                cut[0], agg._row0, agg._rows)).to(
                                    agg.device)
                        # D12: the chunk's cells of the rank's ring
                        # blocks, block-local (the translate below takes
                        # the whole chunk)
                        lo, rows = wheel._row0, wheel._rows
                        own = (cut[0] >= lo) & (cut[0] < lo + rows)
                        cut = (cut[0][own] - lo, cut[1][own], cut[2][own])
                    packed = self._staging.stage(*cut)
                    if paged is not None:
                        # the host translate against the page table
                        # (both locks held, so pages may be mapped);
                        # cells it cannot place land in the exact host
                        # spill inside it, and the in-flight record keeps
                        # the failure recovery from spilling them again
                        pk = np.empty((take, 3), dtype=np.int32)
                        pk[:, 0] = ids[off:off + take]
                        pk[:, 1] = buckets[off:off + take]
                        pk[:, 2] = w32[off:off + take]
                        trip = paged.translate(pk)[0]
                        self._trip_inflight = (trip, take)
                        triples = self._triples.stage(
                            paged._arena_triples(trip))
                final = emit and off + take >= n
                # operand order of make_fused_commit_fn / _snapshot_fn and
                # their paged twins: carries, then the cells [and
                # triples], then the host scalars
                args = [agg._acc if paged is None else paged._pool,
                        [t.ring for t in tiers]]
                if lc is not None:
                    args.append(la)
                if an is not None:
                    args.append(ihist)
                    if final:
                        args.append(banks)
                args += [slots, keeps if dispatches == 0 else ones, packed]
                if paged is not None:
                    args.append(triples)
                if lc is not None:
                    args.append(epoch)
                if final:
                    args.append(masks)
                if an is not None:
                    args.append(0 if dispatches == 0 else 1)
                    if final:
                        args += [bank, an.decay32, an.min_count32]
                with self.obs_recorder.span("commit.dispatch"):
                    kw = {} if stamp is None else {"stamp": stamp}
                    out = iter((self._fused_snap if final else self._fused)(
                        *args, landed=landed, **kw))
                if paged is None:
                    agg._acc = next(out)
                else:
                    next(out)  # the pool, updated in place
                for t, r in zip(tiers, next(out)):
                    t.ring = r
                if lc is not None:
                    la = next(out)
                    lc.store_carry_locked(la)
                if an is not None:
                    ihist = next(out)
                    if final:
                        banks = next(out)
                    an.store_carry_locked(ihist, banks)
                if final:
                    payloads = next(out)
                    # the paged step emits no accumulator payload
                    acc_payload = next(out) if paged is None else None
                dispatches += 1
            if self.obs_recorder.enabled and dispatches:
                # only when observing: wait out the queued commit steps,
                # so the span carries the card's time instead of leaking
                # it into whoever touches the carries next (a failure
                # here takes the recovery below)
                with self.obs_recorder.span("commit.device_sync"):
                    device_sync(agg.device)
            if self.breaker is not None:
                # closes a half-open breaker after a successful trial;
                # failures count in one place (the aggregator's handler)
                self.breaker.record_success()
        except Exception:
            payloads = acc_payload = None
            self._on_fused_failure_locked(cells, applied)
        self._close_tiers_locked(slots, raw, dur, windows, masks, payloads,
                                 acc_payload)
        return dispatches

    def _open_tiers_locked(self, raw: RawMetricSet, dur: float, dense):
        """Open every tier's slot and note the interval (its dense cells,
        or None): (slots, keep factors, view windows, post-close masks),
        the last two None without snapshots."""
        wheel = self.wheel
        tiers = wheel._tiers
        slots = [t.slot for t in tiers]
        keeps = [0 if wheel._tier_open_locked(t, s) else 1
                 for t, s in zip(tiers, slots)]
        wheel._note_interval_locked(raw.time, dense)
        if not wheel.snapshots_enabled:
            return slots, keeps, None, None
        windows = wheel._view_windows_locked()
        return slots, keeps, windows, tuple(
            self._post_close_masks(t, s, dur, windows)
            for t, s in zip(tiers, slots))

    def _close_tiers_locked(self, slots, raw: RawMetricSet, dur: float,
                            windows, masks, payloads, acc_payload) -> None:
        """Close every tier's slot, then publish the final step's
        payloads (None after a failure, or without snapshots): tier
        metadata now matches the post-close state the masks encoded."""
        agg, wheel = self.aggregator, self.wheel
        tiers = wheel._tiers
        for t, s in zip(tiers, slots):
            wheel._tier_close_locked(t, s, raw.rates, dur)
        if payloads is None:
            return
        with self.obs_recorder.span("commit.snapshot_publish"):
            wheel.publish_snapshot_locked(tuple(
                wheel._tier_snapshot_locked(ti, windows, masks[ti],
                                            payloads[ti])
                for ti in range(len(tiers))
            ))
            if acc_payload is not None:
                agg.stats_snapshot = AccSnapshot(
                    epoch=wheel.intervals_pushed,
                    cdf=acc_payload["cdf"],
                    counts=acc_payload["counts"],
                    sums=acc_payload["sums"],
                )

    # -- the commit on a mesh (D9) -------------------------------------- #

    def _commit_cells_mesh(self, cells, raw: RawMetricSet, dur: float):
        """Commit this rank's stream row's cells (or None).  Returns
        (mode, dispatches, the interval's time).  With lifecycle or drift
        carries the registry's growth is laid out first
        (``_mesh_regrow``, the carries with the accumulator), so the
        interval's new rows take their cells, stamps and bank rows in
        it, as the reference's grow-then-commit does.  The ranks then
        agree (one reduction over the mesh, every rank, every interval):
        the chunk count, the most any rank needs; the fan-out if any rank
        needs it; and the interval's time (the latest), which picks the
        drift engine's bank on every rank alike."""
        import torch.distributed as dist

        agg, wheel, lc = self.aggregator, self.wheel, self.lifecycle
        if self.paged is not None:
            return self._commit_cells_paged_mesh(cells, raw, dur)
        if lc is not None or self.anomaly is not None:
            agg._mesh_regrow()
        width = self._staging.width
        n = 0 if cells is None else len(cells[0])
        spill = self.breaker is not None and self.breaker.is_open()
        if cells is not None:
            ids, _, w64 = cells
            lo = agg._row0
            block = (ids >= lo) & (ids < lo + agg._rows)
            spill = (spill or int(w64.max()) >= 1 << 30
                     or agg._interval_ingested + int(
                         w64[block].sum(dtype=np.int64)) >= agg._spill_at)
        nchunks, spill, t_us = mesh_reduce(
            self.mesh, [-(-n // width), int(spill), _time_us(raw.time)],
            dist.ReduceOp.MAX)
        when = _from_time_us(t_us, raw.time)
        if nchunks == 0:
            # no stream row has a cell: slot rotation and durations still
            # advance (the push's own agreement finds nothing to gather)
            wheel.push_cells(None, raw, dur)
            return "empty", 0, when
        if spill:
            # the aggregator keeps its block of the row's cells (K3, or
            # its exact host spill past the envelope), the wheel's push
            # gathers them, and the activity stamp takes the whole
            # interval's ids from that gather
            with agg._dev_lock:
                if cells is not None:
                    agg._merge_cells_locked(*cells)
                agg.stats_snapshot = None

            def touch(whole):
                with agg._dev_lock:
                    lc.touch_locked(whole[:, 0])

            wheel.push_cells(None if cells is None
                             else self._dense_cells(cells), raw, dur,
                             gathered=None if lc is None else touch)
            return "fanout", nchunks * (1 + len(wheel._tiers)), when
        with agg._dev_lock:
            with wheel._lock:
                return "fused", self._mesh_dispatch_locked(
                    cells, raw, dur, nchunks, when), when

    def _commit_cells_paged_mesh(self, cells, raw: RawMetricSet,
                                 dur: float):
        """Commit the MERGED interval's cells (the same on every rank,
        D12) on a paged mesh rank.  Returns (mode, dispatches, the
        interval's time).  The registry's growth is laid out first
        (``_mesh_regrow``: the store's shard blocks), and the
        aggregator's staged batches land (``land_staged``).  The ranks
        then agree (one reduction over the mesh) on the path, the
        fan-out if any rank's breaker is open, and on the interval's
        time.  The fused path is the single-device paged path on every
        rank (translate each chunk, one paged step on the rank's cut of
        it); the fan-out
        merges the cells on every rank and hands them to the wheel's
        push on stream index 0 alone, whose gather over the stream axis
        then counts them once."""
        import torch.distributed as dist

        agg, wheel = self.aggregator, self.wheel
        agg.land_staged()  # the registry's growth laid out first
        n = 0 if cells is None else len(cells[0])
        spill = self.breaker is not None and self.breaker.is_open()
        if cells is not None:
            w64 = cells[2]
            spill = (spill or int(w64.max()) >= 1 << 30
                     or agg._interval_ingested + int(
                         w64.sum(dtype=np.int64)) >= agg._spill_at)
        spill, t_us = mesh_reduce(
            self.mesh, [int(spill), _time_us(raw.time)], dist.ReduceOp.MAX)
        when = _from_time_us(t_us, raw.time)
        if n == 0:
            wheel.push_cells(None, raw, dur)
            return "empty", 0, when
        lead = is_stream_lead(self.mesh)
        if spill:
            with agg._dev_lock:
                agg._merge_cells_locked(*cells)
                agg.stats_snapshot = None
                if self.lifecycle is not None:
                    # the merged interval is every rank's: the rank
                    # stamps its block's ids of it (D13)
                    self.lifecycle.touch_locked(cells[0])
            wheel.push_cells(self._dense_cells(cells) if lead else None,
                             raw, dur)
            nchunks = -(-n // self.chunk)
            return "fanout", nchunks * (1 + len(wheel._tiers)), when
        with agg._dev_lock:
            with wheel._lock:
                return "fused", self._fused_dispatch_locked(
                    cells, raw, dur, note=lead), when

    def _mesh_dispatch_locked(self, cells, raw: RawMetricSet, dur: float,
                              nchunks: int, when) -> int:
        """The fused path of a mesh rank (caller holds agg._dev_lock,
        then wheel._lock): ``nchunks`` steps of the sharded step, each
        on this rank's share of the chunk (padded to the staging width),
        the last the snapshot variant; then the tiers close and the
        snapshot is published.  Returns the number of steps."""
        agg, wheel = self.aggregator, self.wheel
        width = self._staging.width
        bl = wheel.config.bucket_limit
        if cells is None:
            dense = None
            local = np.empty((0, 3), dtype=np.int32)
            w_block = np.empty(0, dtype=np.int64)
        else:
            dense = self._dense_cells(cells)
            ids, idx, w32 = dense
            local = np.stack([ids, idx - np.int32(bl), w32], axis=1)
            # rows the registry grew past the blocks: they wait on the
            # host for the next re-layout (the accumulator's share; the
            # wheel's rows never grow)
            agg._stash_late_cells_locked(*cells)
            lo = agg._row0
            w_block = np.where((ids >= lo) & (ids < lo + agg._rows),
                               cells[2], 0)
        tiers = wheel._tiers
        slots, keeps, windows, masks = self._open_tiers_locked(raw, dur,
                                                               dense)
        ones = [1] * len(tiers)
        lc, an = self.lifecycle, self.anomaly
        if lc is not None:
            la = lc.ensure_capacity_locked(agg.num_metrics)
            epoch = wheel.intervals_pushed
        if an is not None:
            ihist, banks = an.ensure_capacity_locked(agg.num_metrics)
            bank = an.bank_for(when)
        emit = masks is not None
        dispatches = applied = gathered = 0
        payloads = None
        seen = []  # every gathered chunk's ids, for a failure's stamps

        def share(k: int) -> np.ndarray:
            return pad_triples(local[k * width:(k + 1) * width], width)

        def landed():
            nonlocal applied
            applied = min(len(local), (dispatches + 1) * width)
            agg._device_down_until = 0.0
            agg._interval_ingested += int(
                w_block[dispatches * width:applied].sum(dtype=np.int64))

        def on_gather(whole):
            nonlocal gathered
            gathered = dispatches + 1
            if lc is not None:
                seen.append(whole[:, 0])

        try:
            inj = self.fault_injector
            for k in range(nchunks):
                if inj is not None:
                    inj.check("commit.dispatch")
                part = share(k)
                with self.obs_recorder.span("commit.upload"):
                    packed = self._staging.stage(part[:, 0], part[:, 1],
                                                 part[:, 2])
                final = emit and k == nchunks - 1
                # the single-device operand order: carries, the cells,
                # then the host scalars
                args = [agg._acc, [t.ring for t in tiers]]
                if lc is not None:
                    args.append(la)
                if an is not None:
                    args.append(ihist)
                    if final:
                        args.append(banks)
                args += [slots, keeps if k == 0 else ones, packed]
                if lc is not None:
                    args.append(epoch)
                if final:
                    args.append(masks)
                if an is not None:
                    args.append(0 if k == 0 else 1)
                    if final:
                        args += [bank, an.decay32, an.min_count32]
                with self.obs_recorder.span("commit.dispatch"):
                    out = iter((self._fused_snap if final else self._fused)(
                        *args, landed=landed, gathered=on_gather))
                next(out)
                next(out)  # the accumulator and rings, in place
                if lc is not None:
                    lc.store_carry_locked(next(out))
                if an is not None:
                    ihist = next(out)
                    if final:
                        banks = next(out)
                    an.store_carry_locked(ihist, banks)
                if final:
                    payloads = next(out)  # then the acc payload, None
                dispatches += 1
            if self.obs_recorder.enabled:
                with self.obs_recorder.span("commit.device_sync"):
                    device_sync(agg.device)
            if self.breaker is not None:
                self.breaker.record_success()
        except Exception:
            payloads = None
            self._on_fused_failure_locked(cells, applied)
            # the peers' rings still need this rank's later shares: send
            # them, in order, so every rank's gathers stay in step
            for k in range(gathered, nchunks):
                whole = gather_triples(self.mesh, torch.from_numpy(share(k)))
                if lc is not None:
                    seen.append(whole[:, 0])
            if lc is not None and seen:
                # D6 on a mesh: every gathered chunk's ids, as the peers
                # stamped them, so the carry stays the same on every
                # rank of the metric column (and the policy ticks agree)
                lc.on_device_failure_locked(torch.cat(seen))
        self._close_tiers_locked(slots, raw, dur, windows, masks, payloads,
                                 None)
        return dispatches

    def _on_fused_failure_locked(self, cells, applied: int) -> None:
        """Recovery of a failed fused commit (both locks held, called
        from inside the except handler): the aggregator's handler (the
        cooldown, the snapshot handle, the breaker's count), the
        lifecycle and drift engines' handlers, the wheel's snapshot
        invalidated, and the cells not applied into the aggregator's
        exact host spill, so no sample is lost or counted twice on the
        aggregator's side.  On paged storage the failed chunk's
        translated triples re-land through the page table's inverse
        (its translate already spilled what it could not place).  The
        reference also rebuilds the tier rings a donated dispatch
        consumed; the port's steps write the rings in place, so none is
        consumed and the tiers keep the chunks that landed.  A port step
        is several launches, not one program: ``applied`` already counts
        a chunk whose K3 (or, paged, K4) launch returned before a later
        launch of its step failed, so that chunk is not spilled again."""
        agg, wheel = self.aggregator, self.wheel
        agg._on_device_failure_locked()
        if cells is None:  # a mesh rank without cells of its own
            wheel.invalidate_snapshot_locked()
            return
        ids, bidx64, w64 = cells
        if self.lifecycle is not None and self.mesh is None:
            # (a mesh rank stamps every gathered chunk's ids itself)
            self.lifecycle.on_device_failure_locked(ids[:applied])
        elif self.lifecycle is not None and self.paged is not None:
            # a paged mesh rank: its peers stamped every chunk of the
            # merged interval, so it does too (D13)
            self.lifecycle.on_device_failure_locked(ids)
        if self.anomaly is not None:
            self.anomaly.on_device_failure_locked()
        # the published handle may describe rings the failed commit
        # half-wrote: queries recompute until the next commit publishes
        wheel.invalidate_snapshot_locked()
        start = applied
        inflight, self._trip_inflight = self._trip_inflight, None
        if self.paged is not None and inflight is not None:
            trip, take = inflight
            self.paged.spill_triples(trip)
            start = applied + take
        if start < len(ids):
            rest = ids[start:]
            if self.mesh is not None and self.paged is None:
                # the spill holds this rank's block (late rows wait on
                # the host already)
                lo, rows = agg._row0, agg._rows
                rest = np.where((rest >= lo) & (rest < lo + rows),
                                rest - lo, -1)
            agg._spill_add_cells_locked(rest, bidx64[start:], w64[start:])

    # -- warmup / attach ------------------------------------------------ #

    def kernel_names(self) -> tuple:
        """The Hopper kernels this committer's interval launches."""
        names = ["sparse_ingest", "window_merge"]
        if self.paged is not None:
            names.append("paged_scatter")
        if self.lifecycle is not None:
            names.append("compact_rows")
        if self.anomaly is not None:
            names.append("divergence")
        return tuple(names)

    def warmup(self) -> None:
        """Size the lifecycle and drift carries to the accumulator and,
        on the card, build every kernel the path launches, so the first
        interval pays no ``nvcc``."""
        agg = self.aggregator
        with agg._dev_lock:
            if self.lifecycle is not None:
                self.lifecycle.ensure_capacity_locked(agg.num_metrics)
            if self.anomaly is not None:
                self.anomaly.ensure_capacity_locked(agg.num_metrics)
        if agg.device.type == "cuda":
            from loghisto_tpu_torch.ops import _build

            _build.build_all(self.kernel_names())

    def attach(self, ms: MetricSystem, channel_capacity: int = 64) -> None:
        """Subscribe once behind the raw boundary for both consumers
        (strike-eviction resilient).  The channel holds 64 intervals: an
        interval shed here loses its samples, so the bridge may fall
        behind through a stall and catch up.  A failed commit is logged
        and kept in ``bridge_error`` (the first one), also on the
        aggregator and the wheel; a device failure inside the commit
        steps is recovered in ``commit`` and raises nothing."""
        if self._thread is not None:
            raise RuntimeError("already attached")
        self.warmup()
        if self.mesh is not None and self._queue is None:
            self._queue = IntervalQueue(self.mesh, self._commit_one,
                                        empty_interval)
        queue = self._queue
        self._ms = ms
        self._sub = ResilientSubscription(
            ms.subscribe_to_raw_metrics,
            ms.unsubscribe_from_raw_metrics,
            channel_capacity,
        )
        sub = self._sub

        def bridge():
            while True:
                try:
                    raw = sub.get()
                except ChannelClosed:
                    return
                inj = self.fault_injector
                if inj is not None:
                    # outside the per-commit net: a scripted bridge crash
                    # reaches the supervisor's restart loop
                    inj.check("commit.bridge")
                if queue is not None:
                    # D9: a commit is a collective; the entry points on
                    # the main thread commit it
                    queue.put(raw)
                    continue
                try:
                    self.commit(raw)
                except Exception as e:
                    logger.exception(
                        "fused interval commit failed for %s", raw.time
                    )
                    self._keep_error(e)

        # supervised, a crashed bridge restarts with capped backoff on the
        # same subscription; a clean ChannelClosed return (detach) ends it
        self._thread = spawn_thread(self.supervisor, bridge,
                                    "loghisto-torch-commit")

    def _keep_error(self, e: BaseException) -> None:
        for part in (self, self.aggregator, self.wheel):
            if part.bridge_error is None:
                part.bridge_error = e

    def detach(self) -> None:
        """Unsubscribe, let the bridge commit what its channel already
        holds, join it, and re-raise (then clear) a bridge failure."""
        if self._sub is not None:
            self._sub.close()
            self._sub = None
        if self._thread is not None:
            # a supervised handle's restart loop stops too, so no backoff
            # nap outlives the join
            self._thread.stop()
            self._thread.join(timeout=60.0)
            self._thread = None
        err, self.bridge_error = self.bridge_error, None
        if err is not None:
            for part in (self.aggregator, self.wheel):
                if part.bridge_error is err:
                    part.bridge_error = None
            raise RuntimeError(
                "the interval committer's bridge failed to commit an "
                "interval"
            ) from err

    # -- gauges ---------------------------------------------------------- #

    @property
    def bridge_evictions(self) -> int:
        return self._sub.evictions if self._sub is not None else 0

    def register_gauges(self, ms: MetricSystem) -> None:
        """Export the commit path's self-metrics: steps and H2D bytes per
        interval, the fused/fan-out split and the commit latency."""
        gauges = {
            "commit.DispatchesPerInterval":
                lambda: float(self.last_dispatches),
            "commit.H2DBytesPerInterval": lambda: float(self.last_h2d_bytes),
            "commit.CellUploadsPerInterval":
                lambda: float(self.last_uploads),
            "commit.FusedIntervals": lambda: float(self.fused_intervals),
            "commit.FanoutIntervals": lambda: float(self.fanout_intervals),
            "commit.LatencyP50Us": lambda: self._latency_hist.percentile(50.0),
            "commit.LatencyP99Us": lambda: self._latency_hist.percentile(99.0),
            "commit.BridgeEvictions": lambda: float(self.bridge_evictions),
        }
        for name, fn in gauges.items():
            ms.register_gauge_func(name, fn)
