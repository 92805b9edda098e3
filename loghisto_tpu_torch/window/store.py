"""TimeWheel: device-resident windowed retention (counterpart of
``loghisto_tpu/window/store.py``).

The live stack aggregates one interval at a time; the wheel keeps the
history that makes "p99 over the last 5 minutes" a device primitive.  It
subscribes behind the raw boundary (``attach``, like the aggregator) and
keeps, per resolution tier, one int32 ``[S, M, B]`` ring of interval
histograms on the wheel's device plus host per-slot counter deltas and
durations.

Every interval's cells land in each tier's open slot, so tier promotion
is a bucket-tensor add and totals are preserved exactly.  On the card:

  * the slot clear on ring wrap is ``ring[slot].zero_()``;
  * the cell scatter is one K3 launch for every tier
    (``ops/sparse_ingest.sparse_ingest_multi``) on the contiguous views
    ``ring[slot]``, after their clears: the wheel's dense bucket indices
    go back to codec buckets (``idx - bucket_limit``), and rows at or
    past a ring's M drop, as the reference's ``mode="drop"`` does;
  * every push refreshes the snapshot through K5
    (``ops/window.window_snapshot``, one launch per tier for all its
    views), and
    ``query`` serves from it — one row gather and ``snapshot_row_stats``
    — or recomputes through K5 (``window_stats``) for a window no view
    covers;
  * ``query_group_by`` merges the matched rows of a snapshot view per
    label group (``ops/stats.make_group_query_fn``: a row gather and an
    int32 ``index_add_``), or of a one-off K5 view for an unpinned
    window.

A pattern is a name glob or, with a ``LabelIndex`` installed
(``label_index``; ``TorchMetricSystem`` installs one), a label selector
such as ``http.latency{route=/api,code=~5..}``.

Everything runs on PyTorch's current stream.  A published snapshot
holds fresh tensors that no later push writes, so a query reads it
without the store lock.

The bridge thread logs a failed push, keeps the first exception as
``bridge_error`` and re-raises it from ``detach()`` and from the next
``query``/``window_counter`` — a failed kernel launch never vanishes.

With a fused ``IntervalCommitter`` (``commit.py``) the committer lands
each interval on the rings and publishes the snapshot itself
(``publish_snapshot_locked``); the lifecycle drops the snapshot and the
caches after it moves rows (``lifecycle_invalidated_locked``).

With a span ring installed (``obs_recorder``) a push records
``window.tier_push``, the interval's hooks ``window.hooks`` and every
query or group-by serve ``query.serve``.

With resilience (``TorchMetricSystem(resilience=...)``) the bridge
runs under the system's ``supervisor`` and ``fault_injector`` fires the
``wheel.push`` site before each tier push.

On a ("stream", "metric") mesh (``mesh=``, ROADMAP D8 and D9) each rank
holds the block ``[S, M / n_metric, B]`` of every ring (the reference's
``P(None, "metric", None)``) and its stream row's intervals.  A push
gathers the stream rows' cells over the stream axis
(``parallel/mesh.ragged_gather_triples``), so every rank's rings hold the
global interval, and keeps its block; the snapshot views stay
row-sharded.  ``query``, ``query_group_by``, ``window_counter`` and
``window_rate`` are then collective calls, which every rank makes in the
same order: a query computes the matched rows of its block and one
``all_gather`` over the metric axis brings every rank the ``[n, P]``
results; a group-by sums its block's partial group histograms (exact:
CDFs are linear) and reduces them over the metric axis before the row
statistics; a counter sums its stream row's deltas over the stream
axis.  The ranks of a metric line first agree on the serve path (a MIN
over it): a snapshot view, or a cached result, serves only where every
rank of the line has it, so a rank whose commit failed (no snapshot)
keeps its line's collectives in step.  ``attach`` on a mesh queues the broadcast intervals, and those
calls push the queued ones first (``IntervalQueue``).  A lifecycle
eviction or compaction moves ring rows on every rank together (ROADMAP
D10) and drops every rank's snapshot and caches
(``lifecycle_invalidated_locked``).  ``state_dict`` on a mesh gathers
the ring blocks over the metric axis, and ``load_state_dict`` keeps each
rank's block, so a wheel's state moves between mesh shapes (ROADMAP
D11).

Device bytes: ``sum(tier.slots) * num_metrics * num_buckets * 4``, a
rank's block of it on a mesh (``hbm_bytes()``).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import fnmatch
import logging
import math
import threading
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, \
    Sequence

import numpy as np
import torch

from loghisto_tpu_torch.channel import ChannelClosed, ResilientSubscription
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.labels import LabelIndex, is_selector, parse_selector
from loghisto_tpu_torch.labels.groupby import (
    GroupStats,
    assign_groups,
    equidepth_ranks,
    pct_key,
)
from loghisto_tpu_torch.metrics import (
    MetricSystem,
    RawMetricSet,
    empty_interval,
)
from loghisto_tpu_torch.obs.spans import NULL_RECORDER
from loghisto_tpu_torch.ops.backend import resolve_device
from loghisto_tpu_torch.ops.sparse_ingest import sparse_ingest_multi
from loghisto_tpu_torch.ops.stats import (
    make_group_query_fn,
    make_snapshot_query_fn,
)
from loghisto_tpu_torch.ops.window import (
    resolve_merge_path,
    window_snapshot,
    window_stats,
)
from loghisto_tpu_torch.parallel.mesh import (
    METRIC_AXIS,
    STREAM_AXIS,
    IntervalQueue,
    axis_size,
    block_rows,
    block_triples,
    check_mesh,
    gather_parts,
    host_gather,
    mesh_device,
    mesh_reduce,
    ragged_gather_triples,
    ring_sharding,
)
from loghisto_tpu_torch.registry import MetricRegistry, RegistryFullError
from loghisto_tpu_torch.resilience.supervise import spawn_thread
from loghisto_tpu_torch.window.snapshot import (
    QueryPlanCache,
    Snapshot,
    SnapshotView,
    TierSnapshot,
)

logger = logging.getLogger("loghisto_tpu_torch")

WHEEL_STATE_FORMAT = "loghisto_tpu_torch.timewheel/1"

class TierSpec(NamedTuple):
    """One retention tier: ``slots`` ring entries of ``res`` base
    intervals each."""

    slots: int
    res: int


DEFAULT_TIERS: tuple[TierSpec, ...] = (
    TierSpec(60, 1),      # e.g. 60 x 1s
    TierSpec(60, 60),     # 60 x 1m
    TierSpec(24, 3600),   # 24 x 1h
)

DEFAULT_QUERY_PERCENTILES: tuple[float, ...] = (0.5, 0.9, 0.99, 0.999)


@dataclasses.dataclass
class WindowStats:
    """Result of one window query: per-metric stat dicts
    ({"count", "sum", "avg", "p50", ...}) plus what was covered."""

    time: _dt.datetime
    window_s: float    # requested
    covered_s: float   # duration actually merged (sum of slot durations)
    tier: int          # tier index the query ran on
    slots: int         # ring slots merged
    metrics: Dict[str, Dict[str, float]]


class _Tier:
    """One resolution tier: the ring on the wheel's device and the host
    per-slot metadata.  All mutation happens under the wheel's lock."""

    def __init__(self, spec: TierSpec, rows: int, num_buckets: int,
                 device: torch.device):
        self.spec = spec
        self.ring = torch.zeros((spec.slots, rows, num_buckets),
                                dtype=torch.int32, device=device)
        self.slot = 0            # open slot index
        self.in_slot = 0         # intervals landed in the open slot
        self.written = np.zeros(spec.slots, dtype=bool)
        self.durations = np.zeros(spec.slots, dtype=np.float64)
        self.rates: List[Dict[str, int]] = [dict() for _ in range(spec.slots)]

    def span_intervals(self) -> int:
        return self.spec.slots * self.spec.res


def trailing_mask(
    written: np.ndarray,
    durations: np.ndarray,
    slot: int,
    in_slot: int,
    n_slots: int,
    window_s: float,
) -> np.ndarray:
    """Boolean mask over ring slots covering the trailing window: walk
    back from the open slot accumulating RECORDED slot durations until
    the window is covered (duration-driven, so replayed history at
    another cadence still answers "the trailing W seconds")."""
    mask = np.zeros(n_slots, dtype=bool)
    s = slot if in_slot > 0 else (slot - 1) % n_slots
    covered = 0.0
    for _ in range(n_slots):
        if not written[s] or mask[s]:
            break
        mask[s] = True
        covered += float(durations[s])
        if covered >= window_s - 1e-9:
            break
        s = (s - 1) % n_slots
    return mask


class TimeWheel:
    def __init__(
        self,
        num_metrics: int = 1024,
        config: MetricConfig = MetricConfig(),
        interval: float = 1.0,
        tiers: Sequence[TierSpec | tuple] = DEFAULT_TIERS,
        percentiles: Sequence[float] = DEFAULT_QUERY_PERCENTILES,
        registry: Optional[MetricRegistry] = None,
        merge_path: str = "auto",
        snapshots: bool = True,
        device=None,
        mesh=None,
    ):
        """``interval`` is the base interval in seconds (one push per
        interval); tier resolutions are in base intervals and strictly
        increasing.  ``device`` defaults to the card and raises without
        CUDA; ``device="cpu"`` runs the plain versions.  ``merge_path``
        accepts only "auto" (ROADMAP D4).  ``snapshots=False`` publishes
        no snapshot: every query recomputes under the lock.  ``mesh`` (the
        aggregator's ("stream", "metric") mesh) makes the rings this
        rank's metric-row blocks, on the mesh's device."""
        if mesh is not None and device is None:
            device = mesh.device_type  # a rank retains on its mesh device
        self.device = resolve_device(device)
        if interval <= 0:
            raise ValueError("interval must be positive seconds")
        self.interval = float(interval)
        self.config = config
        self.num_metrics = num_metrics
        self.registry = (
            registry if registry is not None
            else MetricRegistry(capacity=num_metrics)
        )
        if self.registry.capacity > num_metrics:
            raise ValueError(
                f"registry capacity {self.registry.capacity} exceeds the "
                f"wheel's num_metrics {num_metrics}"
            )
        tiers = tuple(TierSpec(*t) for t in tiers)
        if not tiers:
            raise ValueError("at least one retention tier is required")
        for t in tiers:
            if t.slots < 1 or t.res < 1:
                raise ValueError(f"invalid tier {t}: slots/res must be >= 1")
        if any(b.res <= a.res for a, b in zip(tiers, tiers[1:])):
            raise ValueError(
                f"tier resolutions must be strictly increasing, got "
                f"{[t.res for t in tiers]}"
            )
        self.percentiles = tuple(float(p) for p in percentiles)
        if any(not 0.0 <= p <= 1.0 for p in self.percentiles):
            raise ValueError("percentiles must be in [0, 1]")
        self.mesh = mesh
        self._rows, self._row0 = num_metrics, 0
        if mesh is not None:
            self._check_mesh(mesh, num_metrics)
        self.merge_path = resolve_merge_path(merge_path)
        self.snapshots_enabled = bool(snapshots)

        # snapshot query engine: commit-time CDF views + sparse serving;
        # on a mesh the views are row blocks and a serve is collective
        self._query_fn = make_snapshot_query_fn(
            config.bucket_limit, config.precision, mesh
        )
        self._group_fn = make_group_query_fn(
            config.bucket_limit, config.precision, mesh
        )
        # the label layer: a LabelIndex over this wheel's registry, set by
        # the owner (TorchMetricSystem); None means selector patterns
        # raise and name globs are the only pattern language
        self.label_index: Optional[LabelIndex] = None
        self._snapshot: Optional[Snapshot] = None
        self._pinned: List[float] = []      # pinned window seconds
        self._max_pinned = 8
        self._glob_cache: Dict[str, tuple] = {}   # pattern -> (gen, matches)
        self._result_cache: Dict[tuple, tuple] = {}  # qkey -> (epoch, gen, ws)
        self.plan_cache = QueryPlanCache()
        self.query_snapshot_hits = 0     # queries served from a snapshot
        self.query_fallbacks = 0         # locked-recompute fallbacks
        self.query_result_cache_hits = 0  # zero-dispatch host-cache hits
        self.query_rows_fetched = 0      # sparse rows read back (padded)
        self.query_group_serves = 0      # group_by rollups served

        self._tiers = [
            _Tier(t, self._rows, config.num_buckets, self.device)
            for t in tiers
        ]
        # covers ring contents, tier metadata and the snapshot refresh
        self._lock = threading.Lock()
        self.intervals_pushed = 0
        self.samples_retained = 0   # lifetime histogram samples landed
        self.shed_samples = 0       # registry-full sheds
        self._last_time: Optional[_dt.datetime] = None
        self._hooks: List[Callable[[RawMetricSet], None]] = []

        self._sub: Optional[ResilientSubscription] = None
        self._thread: Optional[threading.Thread] = None
        # tier-push, hook and query-serve spans; TorchMetricSystem(
        # observability=...) installs a real ring
        self.obs_recorder = NULL_RECORDER
        self.bridge_error: Optional[BaseException] = None
        # resilience, installed by TorchMetricSystem(resilience=...)
        self.supervisor = None
        self.fault_injector = None
        # on a mesh, the attached bridge's queue (D9)
        self._queue = None

    def _check_mesh(self, mesh, num_metrics: int) -> None:
        """The mesh's refusals (the reference's sentence) and this
        rank's block of the rows; the rings live on the mesh's device."""
        check_mesh(mesh)
        n_metric = axis_size(mesh, METRIC_AXIS)
        if num_metrics % n_metric:
            raise ValueError(
                f"num_metrics={num_metrics} not divisible by the mesh "
                f"metric axis ({n_metric})"
            )
        if self.device.type != mesh.device_type:
            raise ValueError(
                f"device={self.device.type!r} but the mesh's devices are "
                f"{mesh.device_type!r}: a rank retains on its mesh device"
            )
        self.device = mesh_device(mesh)
        self._row0, self._rows = block_rows(mesh, num_metrics)

    # -- sizing --------------------------------------------------------- #

    def hbm_bytes(self) -> int:
        """Device bytes the rings occupy (this rank's blocks on a
        mesh)."""
        return sum(
            t.spec.slots * self._rows * self.config.num_buckets * 4
            for t in self._tiers
        )

    @property
    def tiers(self) -> tuple[TierSpec, ...]:
        return tuple(t.spec for t in self._tiers)

    # -- ingestion ------------------------------------------------------ #

    def _cells_from_raw(self, raw: RawMetricSet):
        """Sparse interval histograms -> (row, dense bucket, weight) int32
        arrays, registry-resolved (one NumPy conversion per metric)."""
        ids, bidx, weights = [], [], []
        for name, bucket_counts in raw.histograms.items():
            try:
                mid = self.registry.id_for(name)
            except RegistryFullError:
                n = sum(bucket_counts.values())
                first = self.shed_samples == 0
                self.shed_samples += n
                if first:
                    logger.warning(
                        "timewheel registry exhausted at %d names; samples "
                        "for further new names are shed (shed_samples "
                        "counts them)", self.registry.capacity,
                    )
                continue
            n = len(bucket_counts)
            if not n:
                continue
            ids.append(np.full(n, mid, dtype=np.int32))
            bidx.append(np.fromiter(bucket_counts.keys(), np.int64, n))
            weights.append(np.fromiter(bucket_counts.values(), np.int64, n))
        if not ids:
            return None
        bl = self.config.bucket_limit
        idx_np = (np.clip(np.concatenate(bidx), -bl, bl) + bl).astype(np.int32)
        # int32 wire: a sparse cell above 2^31-1 is outside the wheel's
        # contract and clips (the live tier's spill keeps such counts)
        weights_np = np.minimum(
            np.concatenate(weights), np.int64(2**31 - 1)
        ).astype(np.int32)
        return np.concatenate(ids), idx_np, weights_np

    def _packed_cells(self, cells, gathered=None) -> Optional[torch.Tensor]:
        """The interval's cells as K3's int32 (id, codec bucket, count)
        triples on the wheel's device, uploaded once for every tier.  On
        a mesh the stream rows' cells are gathered first (a collective
        of the stream line, even where this rank has none; ``gathered``
        is called with them, global ids) and the ids move into this
        rank's block."""
        packed = None
        if cells is not None:
            ids_np, idx_np, weights_np = cells
            packed = np.empty((len(ids_np), 3), dtype=np.int32)
            packed[:, 0] = ids_np
            packed[:, 1] = idx_np - self.config.bucket_limit
            packed[:, 2] = weights_np
        if self.mesh is not None:
            whole = ragged_gather_triples(self.mesh, packed)
            if whole is None:
                return None
            if gathered is not None:
                gathered(whole)
            return block_triples(whole, self._row0, self._rows)
        if packed is None:
            return None
        return torch.from_numpy(packed).to(self.device)

    def push(self, raw: RawMetricSet, duration: Optional[float] = None) -> None:
        """Land one interval on every tier.  ``duration`` (seconds)
        defaults to the RawMetricSet's recorded duration, then to the
        wheel's interval.  On a mesh ``raw`` is this rank's stream row's
        interval and the push is a collective call."""
        dur = (
            float(duration) if duration is not None
            else float(raw.duration) if raw.duration is not None
            else self.interval
        )
        self.push_cells(self._cells_from_raw(raw), raw, dur)
        self.run_hooks(raw)

    def push_cells(self, cells, raw: RawMetricSet, dur: float,
                   gathered=None) -> None:
        """Land pre-built interval cells (the ``_cells_from_raw``
        triplet, or None) on every tier and publish a new snapshot; hooks
        are not run (``push`` runs them).  On a mesh the cells are this
        rank's stream row's, the call is a collective, and ``gathered``
        (if given) sees the stream rows' gathered triples before the
        interval is noted (the committer's fan-out stamps activity from
        them)."""
        inj = self.fault_injector
        if inj is not None:
            # a scripted tier-push failure exercises the bridge's net
            inj.check("wheel.push")
        with self.obs_recorder.span("window.tier_push", raw.seq):
            packed = self._packed_cells(cells, gathered)
            with self._lock:
                self._note_interval_locked(raw.time, cells)
                self._tiers_push_locked(packed, raw.rates, dur)
                self._refresh_snapshot_locked()

    def run_hooks(self, raw: RawMetricSet) -> None:
        """Fire the per-interval hooks (the rule engine) for ``raw``; a
        raising hook is logged and skipped."""
        with self.obs_recorder.span("window.hooks", raw.seq):
            for hook in list(self._hooks):
                try:
                    hook(raw)
                except Exception:
                    logger.exception("timewheel interval hook failed")

    def _note_interval_locked(self, time, cells) -> None:
        self._last_time = time
        self.intervals_pushed += 1
        if cells is not None:
            self.samples_retained += int(cells[2].sum(dtype=np.int64))

    def _tier_open_locked(self, tier: _Tier, slot: int) -> bool:
        """Open ``tier``'s current slot: reset its metadata on the slot's
        first interval and report whether its previous life must be
        cleared (ring wrap)."""
        needs_clear = False
        if tier.in_slot == 0:
            needs_clear = bool(tier.written[slot])
            tier.durations[slot] = 0.0
            tier.rates[slot] = {}
        return needs_clear

    def _tier_close_locked(self, tier: _Tier, slot: int, rates, dur: float):
        """Close out one interval on ``tier``: metadata fold and slot
        rotation."""
        tier.written[slot] = True
        tier.durations[slot] += dur
        slot_rates = tier.rates[slot]
        for name, delta in rates.items():
            slot_rates[name] = slot_rates.get(name, 0) + delta
        tier.in_slot += 1
        if tier.in_slot >= tier.spec.res:
            tier.slot = (slot + 1) % tier.spec.slots
            tier.in_slot = 0

    def _tiers_push_locked(self, packed, rates, dur: float):
        """Open every tier's slot (clearing it on ring wrap), scatter the
        interval's triples into all the open slots in one K3 launch,
        close every tier."""
        slots = [tier.slot for tier in self._tiers]
        for tier, slot in zip(self._tiers, slots):
            if self._tier_open_locked(tier, slot):
                tier.ring[slot].zero_()  # ring wrap: clear the previous life
        if packed is not None:
            sparse_ingest_multi(
                [tier.ring[slot] for tier, slot in zip(self._tiers, slots)],
                packed, self.config.bucket_limit)
        for tier, slot in zip(self._tiers, slots):
            self._tier_close_locked(tier, slot, rates, dur)

    def backfill(self, intervals: Iterable[RawMetricSet]) -> int:
        """Replay intervals into the wheel (offline reconstruction); each
        interval's recorded duration drives the rate math.  Returns the
        number of intervals pushed.  On a mesh a collective call, after
        the queued intervals."""
        self.drain()
        n = 0
        for raw in intervals:
            self.push(raw)
            n += 1
        return n

    # -- snapshots ------------------------------------------------------ #

    def pin_window(self, window_s: float) -> None:
        """Materialize a snapshot view for this trailing window from the
        NEXT commit on (capped at ``_max_pinned`` windows)."""
        with self._lock:
            self._pin_window_locked(float(window_s))

    def _pin_window_locked(self, w: float) -> None:
        if w <= 0 or not math.isfinite(w):
            return
        if any(abs(p - w) < 1e-9 for p in self._pinned):
            return
        if len(self._pinned) >= self._max_pinned:
            return
        self._pinned.append(w)

    def pinned_windows(self) -> tuple:
        return tuple(self._pinned)

    @property
    def snapshot(self) -> Optional[Snapshot]:
        """The latest immutable snapshot handle (None before the first
        commit)."""
        return self._snapshot

    def snapshot_age_intervals(self) -> Optional[int]:
        """Commits since the served snapshot's epoch (0 == fresh)."""
        snap = self._snapshot
        if snap is None:
            return None
        return self.intervals_pushed - snap.epoch

    def _view_windows_locked(self) -> List[float]:
        """The full written span (inf) first, then the pinned windows."""
        return [np.inf] + list(self._pinned)

    def _refresh_snapshot_locked(self) -> None:
        """Merge every tier's views from the live rings (one K5 launch
        per tier) and publish a new handle (the push path; the fused
        committer builds the same payloads in its final step and
        publishes them through ``publish_snapshot_locked``)."""
        if not self.snapshots_enabled:
            return
        windows = self._view_windows_locked()
        tiers = []
        for ti, t in enumerate(self._tiers):
            masks = np.stack([self._mask_locked(t, w) for w in windows])
            payload = window_snapshot(
                t.ring, masks, self.config.bucket_limit, self.config.precision
            )
            tiers.append(self._tier_snapshot_locked(ti, windows, masks, payload))
        self.publish_snapshot_locked(tuple(tiers))

    def publish_snapshot_locked(self, tiers: tuple) -> None:
        """Publish a new epoch-versioned handle (caller holds the lock
        and has already noted the interval)."""
        self._snapshot = Snapshot(
            epoch=self.intervals_pushed,
            time=self._last_time,
            interval=self.interval,
            tiers=tiers,
        )

    def invalidate_snapshot_locked(self) -> None:
        """Drop the published handle: queries recompute under the lock
        until the next commit publishes."""
        self._snapshot = None

    def lifecycle_invalidated_locked(self) -> None:
        """Called (lock held) after a lifecycle eviction or compaction
        changed ring rows in place: the snapshot describes the old rows
        and every cached glob resolution or result maps dead or moved
        ids, so all three go; the next commit republishes."""
        self._glob_cache.clear()
        self._result_cache.clear()
        self.invalidate_snapshot_locked()

    def _tier_snapshot_locked(
        self, ti: int, windows, masks: np.ndarray, payload
    ) -> TierSnapshot:
        t = self._tiers[ti]
        views = []
        for vi, w in enumerate(windows):
            mask = np.asarray(masks[vi], dtype=bool)
            views.append(SnapshotView(
                window_s=None if not math.isfinite(w) else float(w),
                mask=mask,
                covered_s=float(t.durations[mask].sum()),
                slots=int(mask.sum()),
                cdf=payload["cdf"][vi],
                counts=payload["counts"][vi],
                sums=payload["sums"][vi],
            ))
        return TierSnapshot(tier=ti, views=tuple(views))

    def _resolve_glob(self, pattern: str):
        """Glob -> ((mid, name), ...) memoized per registry state
        ``(generation, high_water)``: an unchanged generation means the
        registry only appended, so a grown one rescans the tail only."""
        names = self.registry.names()
        rgen = self.registry.generation
        hw = len(names)
        gen = (rgen, hw)
        ent = self._glob_cache.get(pattern)
        if ent is not None and ent[0] == gen:
            return gen, ent[1]
        if ent is not None and ent[0][0] == rgen and ent[0][1] < hw:
            matched = list(ent[1])
            start = ent[0][1]
        else:
            matched = []
            start = 0
        for mid in range(start, hw):
            name = names[mid]
            if name is None or mid >= self.num_metrics:
                continue
            if fnmatch.fnmatch(name, pattern):
                matched.append((mid, name))
        matches = tuple(matched)
        if len(self._glob_cache) >= 256 and pattern not in self._glob_cache:
            self._glob_cache.clear()
        self._glob_cache[pattern] = (gen, matches)
        return gen, matches

    def _resolve_matches(self, pattern: str):
        """Pattern -> (generation, ((mid, name), ...)), mids ascending: a
        brace selector (``base{k=v,...}``) through the label index, any
        other pattern through the glob cache.  Both return the same
        shape, so the result cache keys on either alike."""
        if is_selector(pattern):
            if self.label_index is None:
                raise ValueError(
                    f"selector query {pattern!r} needs a LabelIndex "
                    "(TorchMetricSystem installs one; a standalone wheel "
                    "sets wheel.label_index = LabelIndex(wheel.registry))"
                )
            return self.label_index.select(pattern, max_id=self.num_metrics)
        return self._resolve_glob(pattern)

    @staticmethod
    def _match_predicate(pattern: str) -> Callable[[str], bool]:
        """Name-level match test of the locked recompute (it agrees with
        ``_resolve_matches`` row for row without reading its caches or
        the index)."""
        if is_selector(pattern):
            return parse_selector(pattern).match_name
        return lambda name: fnmatch.fnmatch(name, pattern)

    # -- queries -------------------------------------------------------- #

    def _raise_bridge_error(self, clear: bool = False) -> None:
        err = self.bridge_error
        if err is not None:
            if clear:
                self.bridge_error = None
            raise RuntimeError(
                "the retention wheel's bridge failed to push an interval"
            ) from err

    def _select_tier(self, needed_intervals: int) -> int:
        for i, tier in enumerate(self._tiers):
            if tier.span_intervals() >= needed_intervals:
                return i
        return len(self._tiers) - 1

    def _mask_locked(self, tier: _Tier, window_s: float) -> np.ndarray:
        return trailing_mask(
            tier.written, tier.durations, tier.slot, tier.in_slot,
            tier.spec.slots, window_s,
        )

    def query(
        self,
        pattern: str = "*",
        window: Optional[float] = None,
        percentiles: Optional[Sequence[float]] = None,
        tier: Optional[int] = None,
    ) -> WindowStats:
        """Sliding-window statistics for every metric matching
        ``pattern`` (a name glob or a label selector) over the trailing
        ``window`` seconds (default: the coarsest tier's span).

        Served from the latest snapshot when a view covers the window:
        cached resolution, one gather of the matched rows and
        ``snapshot_row_stats``, without the store lock; repeat queries at
        an unchanged epoch return the cached result.  Other windows fall
        back to the locked recompute through K5 and pin themselves for
        the next commit.  On a mesh a collective call: every rank makes
        it, in the same order, and gets the global result."""
        ps, window, ti = self._query_args(percentiles, window, tier)
        # a serve attributes to the latest landed interval (the snapshot
        # it reads is that commit's handle)
        with self.obs_recorder.span("query.serve"):
            snap = self._snapshot  # atomic ref read; immutable handle
            view = None if snap is None else snap.tiers[ti].view_for(window)
            if not self._every_rank(view is not None):
                self.pin_window(window)
                self.query_fallbacks += 1
                return self._query_recompute(pattern, window, ps, ti)
            return self._query_snapshot(pattern, window, ps, ti, snap, view)

    def _every_rank(self, flag: bool) -> bool:
        """``flag`` off a mesh; on a mesh whether it holds on every rank
        of this rank's metric line (a MIN over it), so the line's ranks
        take the same serve path and make the same collectives, even
        after one of them dropped its snapshot (a failed commit) or its
        cached results."""
        if self.mesh is None:
            return flag
        import torch.distributed as dist

        return bool(mesh_reduce(self.mesh, [int(flag)], dist.ReduceOp.MIN,
                                (METRIC_AXIS,))[0])

    def _query_args(self, percentiles, window, tier) -> tuple:
        """Re-raise a bridge failure, push the queued intervals (on a
        mesh), then validate a query's arguments: (percentiles tuple,
        window seconds, tier index)."""
        self._raise_bridge_error()
        self.drain()
        ps = tuple(
            float(p) for p in (
                percentiles if percentiles is not None else self.percentiles
            )
        )
        if any(not 0.0 <= p <= 1.0 for p in ps):
            raise ValueError("percentiles must be in [0, 1]")
        if window is None:
            window = self._tiers[-1].span_intervals() * self.interval
        window = float(window)
        needed = max(1, math.ceil(window / self.interval))
        ti = self._select_tier(needed) if tier is None else int(tier)
        if not 0 <= ti < len(self._tiers):
            raise ValueError(f"tier {ti} out of range")
        return ps, window, ti

    @staticmethod
    def _entries(matches, counts, sums, pcts, keys) -> Dict[str, dict]:
        """Name the nonzero rows of one query's (counts, sums, pcts)."""
        metrics: Dict[str, Dict[str, float]] = {}
        for i, (_, name) in enumerate(matches):
            count = int(counts[i])
            if count == 0:
                continue
            entry = {
                "count": float(count),
                "sum": float(sums[i]),
                "avg": float(sums[i]) / count,
            }
            for key, value in zip(keys, pcts[i]):
                entry[key] = float(value)
            metrics[name] = entry
        return metrics

    def _query_snapshot(
        self, pattern: str, window: float, ps: tuple, ti: int,
        snap: Snapshot, view: SnapshotView,
    ) -> WindowStats:
        """Lock-free snapshot serve: cached glob, host result cache for
        this epoch, else one gather over the matched rows."""
        self.query_snapshot_hits += 1
        gen, matches = self._resolve_matches(pattern)
        qkey = (pattern, window, ps, ti)
        cached = self._result_cache.get(qkey)
        if self._every_rank(
            cached is not None
            and cached[0] == snap.epoch and cached[1] == gen
        ):
            self.query_result_cache_hits += 1
            return cached[2]
        metrics: Dict[str, Dict[str, float]] = {}
        if matches:
            ids_np = np.fromiter(
                (mid for mid, _ in matches), dtype=np.int32,
                count=len(matches),
            )
            padded, nb = QueryPlanCache.pad_ids(ids_np)
            self.plan_cache.note(ti, nb, len(ps))
            out = self._query_fn(view.cdf, view.counts, view.sums, padded,
                                 np.asarray(ps, dtype=np.float32))
            self.query_rows_fetched += nb
            metrics = self._entries(
                matches, out["counts"].cpu().numpy(),
                out["sums"].cpu().numpy(), out["percentiles"].cpu().numpy(),
                [pct_key(p) for p in ps],
            )
        ws = WindowStats(
            time=snap.time or _dt.datetime.now(tz=_dt.timezone.utc),
            window_s=window,
            covered_s=view.covered_s,
            tier=ti,
            slots=view.slots,
            metrics=metrics,
        )
        if len(self._result_cache) >= 128 and qkey not in self._result_cache:
            self._result_cache.clear()
        self._result_cache[qkey] = (snap.epoch, gen, ws)
        return ws

    def _query_recompute(
        self, pattern: str, window: float, ps: tuple, ti: int
    ) -> WindowStats:
        """Locked full recompute through K5 and ``dense_stats`` — the
        path of windows without a view, and the parity oracle of the
        snapshot serve."""
        t = self._tiers[ti]
        with self._lock:
            mask = self._mask_locked(t, window)
            covered = float(t.durations[mask].sum())
            ts = self._last_time or _dt.datetime.now(tz=_dt.timezone.utc)
            # fresh tensors that no later push writes: the gathers and
            # the readback run after the lock is released
            stats = window_stats(
                t.ring, mask, np.asarray(ps, dtype=np.float32),
                self.config.bucket_limit, self.config.precision,
            )
        if self.mesh is not None:
            # every rank's block, in row order (three gathers over the
            # metric axis)
            stats = {k: gather_parts(self.mesh, stats[k])
                     for k in ("counts", "sums", "percentiles")}
        counts = stats["counts"].cpu().numpy()
        sums = stats["sums"].cpu().numpy()
        pcts = stats["percentiles"].cpu().numpy()
        match = self._match_predicate(pattern)
        matches = [
            (mid, name) for mid, name in enumerate(self.registry.names())
            if name is not None and mid < self.num_metrics and match(name)
        ]
        rows = [mid for mid, _ in matches]
        return WindowStats(
            time=ts,
            window_s=window,
            covered_s=covered,
            tier=ti,
            slots=int(mask.sum()),
            metrics=self._entries(matches, counts[rows], sums[rows],
                                  pcts[rows], [pct_key(p) for p in ps]),
        )

    def query_group_by(
        self,
        selector: str,
        by: Sequence[str],
        window: Optional[float] = None,
        percentiles: Optional[Sequence[float]] = None,
        tier: Optional[int] = None,
        depth: Optional[int] = None,
    ) -> GroupStats:
        """Merge every row matching ``selector`` (a label selector or a
        name glob) into one histogram per distinct value-tuple of the
        ``by`` label keys, and answer count/sum/avg/percentiles per group
        on the wheel's device (``ops/stats.make_group_query_fn``).  Rows
        missing a ``by`` label group under "".  The merge is exact:
        grouping adds no sketch error.

        ``depth=k`` also returns each group's equi-depth summary, its
        k - 1 boundaries at ranks j/k, as ``edges`` (equi-depth edges
        are quantiles, so they ride the same rollup).  Serving follows
        ``query``: a repeat at an unchanged (epoch, generation) returns
        the cached result with no device work; a window no snapshot view
        covers takes a one-off K5 view built under the lock, and pins
        itself for the next commit.  On a mesh a collective call, as
        ``query``."""
        by = tuple(str(k) for k in by)
        if not by:
            raise ValueError("group_by needs at least one label key")
        ps, window, ti = self._query_args(percentiles, window, tier)
        eps = equidepth_ranks(int(depth)) if depth is not None else ()
        with self.obs_recorder.span("query.serve"):
            snap = self._snapshot  # atomic ref read; immutable handle
            view = None if snap is None else snap.tiers[ti].view_for(window)
            gen, matches = self._resolve_matches(selector)
            if self._every_rank(view is not None):
                qkey = ("#group_by", selector, by, window, ps, ti, depth)
                cached = self._result_cache.get(qkey)
                if self._every_rank(
                    cached is not None
                    and cached[0] == snap.epoch and cached[1] == gen
                ):
                    self.query_result_cache_hits += 1
                    return cached[2]
                gs = self._group_rollup(
                    matches, by, ps, eps, ti, view.cdf, view.counts,
                    view.sums, time=snap.time, window=window,
                    covered=view.covered_s, slots=view.slots,
                )
                if len(self._result_cache) >= 128 \
                        and qkey not in self._result_cache:
                    self._result_cache.clear()
                self._result_cache[qkey] = (snap.epoch, gen, gs)
                return gs
            # no view: one K5 view of the window from the live ring under
            # the lock (its payload is fresh tensors), the rollup outside
            self.pin_window(window)
            self.query_fallbacks += 1
            t = self._tiers[ti]
            with self._lock:
                mask = self._mask_locked(t, window)
                covered = float(t.durations[mask].sum())
                ts = self._last_time or _dt.datetime.now(
                    tz=_dt.timezone.utc)
                payload = window_snapshot(t.ring, mask[None],
                                          self.config.bucket_limit,
                                          self.config.precision)
            return self._group_rollup(
                matches, by, ps, eps, ti, payload["cdf"][0],
                payload["counts"][0], payload["sums"][0], time=ts,
                window=window, covered=covered, slots=int(mask.sum()),
            )

    def _group_rollup(
        self, matches, by: tuple, ps: tuple, eps: tuple, ti: int,
        cdf, counts, sums, *, time, window: float, covered: float,
        slots: int,
    ) -> GroupStats:
        """The rollup over one CDF view: ids padded to the plan grid
        (a power of two, pad rows into the dump group ``ng_real``), the
        group count to a power of two above it, the dump group dropped
        after readback."""
        self.query_group_serves += 1
        keys = [pct_key(p) for p in ps]
        groups: Dict[tuple, Dict[str, object]] = {}
        sizes: Dict[tuple, int] = {}
        if matches:
            gkeys, gids = assign_groups(matches, by)
            ng_real = len(gkeys)
            ids_np = np.fromiter(
                (mid for mid, _ in matches), dtype=np.int32,
                count=len(matches),
            )
            padded, nb = QueryPlanCache.pad_ids(ids_np)
            ng = 1 << ng_real.bit_length()
            gids_pad = np.full(nb, ng_real, dtype=np.int32)
            gids_pad[: len(gids)] = gids
            all_ps = np.asarray(ps + eps, dtype=np.float32)
            self.plan_cache.note((ti, "group", ng), nb, len(all_ps))
            out = self._group_fn(cdf, counts, sums, padded, gids_pad, all_ps,
                                 num_groups=ng)
            self.query_rows_fetched += nb
            gcounts = out["counts"].cpu().numpy()
            gsums = out["sums"].cpu().numpy()
            gpcts = out["percentiles"].cpu().numpy()
            gsizes = np.bincount(np.asarray(gids, dtype=np.int64),
                                 minlength=ng_real)
            for gi, gk in enumerate(gkeys):
                count = int(gcounts[gi])
                if count == 0:
                    continue
                entry: Dict[str, object] = {
                    "count": float(count),
                    "sum": float(gsums[gi]),
                    "avg": float(gsums[gi]) / count,
                }
                for key, value in zip(keys, gpcts[gi][: len(ps)]):
                    entry[key] = float(value)
                if eps:
                    entry["edges"] = [float(v) for v in gpcts[gi][len(ps):]]
                groups[gk] = entry
                sizes[gk] = int(gsizes[gi])
        return GroupStats(
            time=time or _dt.datetime.now(tz=_dt.timezone.utc),
            window_s=window,
            covered_s=covered,
            tier=ti,
            slots=slots,
            by=by,
            groups=groups,
            sizes=sizes,
        )

    def window_counter(
        self, name: str, window: float, tier: Optional[int] = None
    ) -> tuple[int, float]:
        """(sum of counter deltas, covered seconds) for ``name`` over the
        trailing window — the burn-rate primitive, from the host per-slot
        vectors and the recorded durations.  On a mesh a collective call:
        the stream rows' deltas are summed over the stream axis."""
        self._raise_bridge_error()
        self.drain()
        needed = max(1, math.ceil(window / self.interval))
        ti = self._select_tier(needed) if tier is None else int(tier)
        t = self._tiers[ti]
        with self._lock:
            mask = self._mask_locked(t, float(window))
            total = sum(
                t.rates[i].get(name, 0)
                for i in np.nonzero(mask)[0]
            )
            covered = float(t.durations[mask].sum())
        if self.mesh is not None:
            import torch.distributed as dist

            total = mesh_reduce(self.mesh, [int(total)], dist.ReduceOp.SUM,
                                (STREAM_AXIS,))[0]
        return int(total), covered

    def window_rate(self, name: str, window: float) -> float:
        """Counter rate (events/s) over the trailing window; 0 without
        covered history.  On a mesh a collective call."""
        total, covered = self.window_counter(name, window)
        return total / covered if covered > 0 else 0.0

    def register_query_gauges(self, ms: MetricSystem) -> None:
        """Export the query engine's self-metrics (the reference's
        ``commit.query_*`` names) through the gauge pipeline."""
        def age() -> float:
            a = self.snapshot_age_intervals()
            return -1.0 if a is None else float(a)

        gauges = {
            "commit.query_SnapshotAgeIntervals": age,
            "commit.query_PlanCacheHits": lambda: float(self.plan_cache.hits),
            "commit.query_PlanCacheMisses":
                lambda: float(self.plan_cache.misses),
            "commit.query_SparseRowsFetched":
                lambda: float(self.query_rows_fetched),
            "commit.query_SnapshotServed":
                lambda: float(self.query_snapshot_hits),
            "commit.query_RecomputeFallbacks":
                lambda: float(self.query_fallbacks),
            "commit.query_ResultCacheHits":
                lambda: float(self.query_result_cache_hits),
            "commit.query_GroupByServed":
                lambda: float(self.query_group_serves),
        }
        for name, fn in gauges.items():
            ms.register_gauge_func(name, fn)

    # -- state ---------------------------------------------------------- #

    def state_dict(self) -> dict:
        """The wheel's state as host values (see state.py): every tier's
        ring and metadata, the counters, the pinned windows and the
        registry's names.  On a mesh (ROADMAP D11) a collective call that
        every rank makes: each tier's ring blocks are gathered over the
        metric axis (the whole ``[S, M, B]`` through the host under
        gloo), the metadata is every rank's own (the same on each), so
        every rank returns the same single-device state."""
        with self._lock:
            # copies on the device, ordered on the writers' stream: the
            # gathers and the readbacks run after the lock is released
            rings = [t.ring.clone() for t in self._tiers]
            state = {
                "format": WHEEL_STATE_FORMAT,
                "bucket_limit": self.config.bucket_limit,
                "precision": self.config.precision,
                "interval": self.interval,
                "num_metrics": self.num_metrics,
                "tiers": [tuple(t.spec) for t in self._tiers],
                "rings": None,
                "slot": [t.slot for t in self._tiers],
                "in_slot": [t.in_slot for t in self._tiers],
                "written": [t.written.copy() for t in self._tiers],
                "durations": [t.durations.copy() for t in self._tiers],
                "rates": [[dict(r) for r in t.rates] for t in self._tiers],
                "intervals_pushed": self.intervals_pushed,
                "samples_retained": self.samples_retained,
                "shed_samples": self.shed_samples,
                "pinned": list(self._pinned),
                "names": self.registry.names(),
                "last_time": self._last_time,
            }
        if self.mesh is not None:
            state["rings"] = [host_gather(r, ring_sharding(self.mesh))
                              for r in rings]
        else:
            state["rings"] = [r.cpu().numpy() for r in rings]
        return state

    def load_state_dict(self, state: dict) -> None:
        """Replace the wheel's state with ``state`` (from ``state_dict``
        or ``state.wheel_state_from_jax``) and publish its snapshot.  The
        wheel's registry is replaced by one holding the state's names.
        On a mesh every rank loads the same state and keeps its block of
        each ring, with no collective."""
        if state.get("format") != WHEEL_STATE_FORMAT:
            raise ValueError(f"unknown state format {state.get('format')!r}")
        for key, have in (
            ("bucket_limit", self.config.bucket_limit),
            ("precision", self.config.precision),
            ("num_metrics", self.num_metrics),
        ):
            if state[key] != have:
                raise ValueError(
                    f"state {key}={state[key]} but this wheel has {have}"
                )
        specs = [TierSpec(*t) for t in state["tiers"]]
        if specs != [t.spec for t in self._tiers]:
            raise ValueError(
                f"state tiers {specs} differ from this wheel's {self.tiers}"
            )
        rings = []
        for t, ring in zip(self._tiers, state["rings"]):
            ring = np.ascontiguousarray(ring, dtype=np.int32)
            want = (t.spec.slots, self.num_metrics, self.config.num_buckets)
            if ring.shape != want:
                raise ValueError(
                    f"state ring of shape {ring.shape} for a tier of "
                    f"{want}"
                )
            if self.mesh is not None:
                ring = np.ascontiguousarray(
                    ring[ring_sharding(self.mesh).index(ring.shape)])
            rings.append(ring)
        with self._lock:
            for i, t in enumerate(self._tiers):
                t.ring = torch.from_numpy(rings[i]).to(self.device)
                t.slot = int(state["slot"][i])
                t.in_slot = int(state["in_slot"][i])
                t.written = np.array(state["written"][i], dtype=bool)
                t.durations = np.array(state["durations"][i],
                                       dtype=np.float64)
                t.rates = [dict(r) for r in state["rates"][i]]
            self.intervals_pushed = int(state["intervals_pushed"])
            self.samples_retained = int(state["samples_retained"])
            self.shed_samples = int(state.get("shed_samples", 0))
            self._pinned = [float(w) for w in state["pinned"]]
            self._last_time = state.get("last_time")
            self.registry = MetricRegistry.from_names(
                state["names"], max(self.registry.capacity,
                                    len(state["names"]))
            )
            if self.label_index is not None:
                self.label_index = LabelIndex(self.registry)
            self._glob_cache.clear()
            self._result_cache.clear()
            self._snapshot = None
            if self.intervals_pushed:
                self._refresh_snapshot_locked()

    # -- subscription bridge ------------------------------------------- #

    def add_interval_hook(self, fn: Callable[[RawMetricSet], None]) -> None:
        """Run ``fn(raw)`` after every pushed interval, on the pushing
        thread (the rule engine's attachment point)."""
        self._hooks.append(fn)

    def attach(self, ms: MetricSystem, channel_capacity: int = 16) -> None:
        """Subscribe behind the raw boundary: a bridge thread pushes every
        broadcast interval (strike-eviction resilient).  A failed push is
        logged and kept in ``bridge_error`` (the first one).  On a mesh
        the bridge only queues the intervals (a push is a collective, D9):
        the collective calls push them (``drain``)."""
        if self._thread is not None:
            raise RuntimeError("already attached")
        if self.mesh is not None and self._queue is None:
            self._queue = IntervalQueue(self.mesh, self.push, empty_interval)
        queue = self._queue
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
                if queue is not None:
                    queue.put(raw)
                    continue
                try:
                    self.push(raw)
                except Exception as e:
                    logger.exception(
                        "timewheel push failed for interval %s", raw.time
                    )
                    if self.bridge_error is None:
                        self.bridge_error = e

        # supervised, a crashed bridge restarts with capped backoff; the
        # clean ChannelClosed return (detach) ends it for good
        self._thread = spawn_thread(self.supervisor, bridge,
                                    "loghisto-timewheel")

    def detach(self) -> None:
        """Unsubscribe, let the bridge push what it already holds, join
        it, and re-raise (then clear) a bridge failure."""
        if self._sub is not None:
            self._sub.close()
            self._sub = None
        if self._thread is not None:
            self._thread.stop()  # a supervised handle's restart loop
            self._thread.join(timeout=30.0)
            self._thread = None
        self._raise_bridge_error(clear=True)

    def drain(self, final: bool = False) -> int:
        """Push the intervals an attached bridge queued on a mesh, as
        many as every rank holds (with ``final``, the most any rank
        holds, padded with empty intervals, as ``IntervalCommitter.drain``);
        a collective of the mesh.  0 and no collective off a mesh or
        before ``attach``."""
        if self._queue is None:
            return 0
        return self._queue.drain(final)

    @property
    def queued_intervals(self) -> int:
        """Intervals the bridge queued on a mesh that no collective call
        has pushed yet (D9)."""
        return 0 if self._queue is None else len(self._queue)
