"""LifecycleManager: owns the activity vector, runs the eviction
policies and drives the fold and repack steps (counterpart of
``loghisto_tpu/lifecycle/manager.py``).

The manager rides the IntervalCommitter's bridge thread: ``on_interval``
runs after each committed interval with no lock held, so an eviction
never races the cells of an interval in flight.  Registrations from
user threads are tolerated: eviction touches only ids live when the
policy read the registry, and compaction validates its permutation
against the registry under the registry's lock.

Lock order, as the committer's: the aggregator's ``_dev_lock``, then
the wheel's lock; the registry's and ``_agg``'s locks are leaves.  The
activity vector (int32 [M], on the aggregator's device) is guarded by
``_dev_lock`` like the accumulator.

Exactness: an eviction folds the victim's device rows into its
overflow row by integer addition and the host lifetime stores with
Python ints, so the overflow row's total equals the evicted counts
exactly.  A compaction is a pure row permutation (K6): survivors'
histograms are bit-identical across it.

On paged storage the pool is the accumulator, and ``PagedStore`` moves
it on the host: an eviction folds each overflow target's victims with
``fold_rows_into`` (a host translate plus a pool commit, K4) and drops
shed targets' victims with ``drop_rows``, then folds the rings
(``fold_paged``); a compaction permutes the page table's rows
(``apply_permutation``, no device traffic) after the registry's commit
point and before the rings' K6 repack (``compact_paged``).

A failure inside a policy tick is not caught here: it leaves the
committer's ``commit`` and lands in ``bridge_error`` (ROADMAP D6).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from loghisto_tpu_torch.lifecycle.policy import LifecycleConfig, \
    decide_victims
from loghisto_tpu_torch.obs.spans import NULL_RECORDER
from loghisto_tpu_torch.ops.commit import DROP_ID
from loghisto_tpu_torch.ops.lifecycle import (
    make_compact_fn,
    make_fold_evict_fn,
    make_touch_fn,
    pad_pow2_ids,
)

logger = logging.getLogger("loghisto_tpu_torch")


class LifecycleManager:
    """Lifecycle runtime for a (TorchAggregator, TimeWheel) pair, on
    dense or paged storage.
    ``TorchMetricSystem(lifecycle=LifecycleConfig(...))`` builds one;
    standalone construction serves tests."""

    def __init__(self, aggregator, wheel, config: LifecycleConfig,
                 metric_system=None):
        if wheel is None:
            raise ValueError(
                "lifecycle needs a retention wheel: activity tracking and"
                " eviction ride the fused interval commit"
            )
        self._paged = getattr(aggregator, "paged", None) is not None
        self.aggregator = aggregator
        self.wheel = wheel
        self.config = config
        self.metric_system = metric_system
        num_tiers = len(wheel._tiers)
        self._fold = make_fold_evict_fn(num_tiers, with_acc=not self._paged)
        self._compact = make_compact_fn(num_tiers, config.compact_path,
                                        with_acc=not self._paged)
        self._touch = make_touch_fn()
        # the drift engine's banks live and die with these rows; set by
        # TorchMetricSystem so bank rows are zeroed with their victims
        # and permuted with their survivors
        self.anomaly = None
        self._la: Optional[torch.Tensor] = None  # int32 [M], _dev_lock

        self._intervals_seen = 0
        # the tick's span; TorchMetricSystem(observability=...) installs
        # a real ring
        self.obs_recorder = NULL_RECORDER
        self.evicted_series = 0       # lifetime victims
        self.overflowed_samples = 0   # device counts folded to overflow
        self.evictions = 0            # eviction batches
        self.compactions = 0
        self.last_compaction_us = 0.0
        self._compaction_us: deque = deque(maxlen=256)
        self._metrics_lock = threading.Lock()

    # -- epoch / activity carry (callers hold agg._dev_lock) ------------- #

    @property
    def epoch(self) -> int:
        """Committed-interval count: the lifecycle clock (the wheel's
        counter, so a carried-over wheel keeps activity comparable)."""
        return self.wheel.intervals_pushed

    def ensure_capacity_locked(self, m: int) -> torch.Tensor:
        """The activity carry, grown to ``m`` rows (new rows stamp the
        current epoch: a fresh row is as alive as a fresh name)."""
        la = self._la
        dev = self.aggregator.device
        if la is None:
            la = torch.full((m,), self.epoch, dtype=torch.int32, device=dev)
        elif la.shape[0] < m:
            la = torch.cat([la, torch.full((m - la.shape[0],), self.epoch,
                                           dtype=torch.int32, device=dev)])
        self._la = la
        return la

    def store_carry_locked(self, la: torch.Tensor) -> None:
        self._la = la

    def touch_locked(self, ids: np.ndarray) -> None:
        """Activity stamp of the spill fan-out (the fused commit stamps
        inside its own step)."""
        if len(ids) == 0:
            return
        la = self.ensure_capacity_locked(self.aggregator.num_metrics)
        self._la = self._touch(la, pad_pow2_ids(ids), self.epoch)

    def on_device_failure_locked(self, landed_ids=None) -> None:
        """A fused commit step failed.  The reference rebuilds a carry
        its donated dispatch consumed, stamped at the current epoch; the
        port's steps update the activity vector in place, so it survives
        the failure (what the chunks before it stamped stays stamped)
        and nothing is rebuilt.  A port step is several launches, and
        one that failed after its chunk landed may not have stamped it:
        ``landed_ids``, the ids of every chunk that landed, are stamped
        again (a no-op for a row already stamped), so no active row
        reads as idle."""
        if landed_ids is not None:
            self.touch_locked(landed_ids)

    # -- the policy tick -------------------------------------------------- #

    def on_interval(self) -> None:
        """After each committed interval (committer thread, no lock
        held): every ``check_every`` intervals run the policies, evict,
        and auto-compact past the fragmentation threshold."""
        self._intervals_seen += 1
        if self._intervals_seen % self.config.check_every:
            return
        with self.obs_recorder.span("lifecycle.tick"):
            self.check()

    def check(self) -> List[str]:
        """One policy pass.  Returns the evicted names."""
        with self.aggregator._dev_lock:
            if self._la is None:
                return []
            last_active = self._la.cpu().numpy()
        victims = decide_victims(
            self.aggregator.registry.names(), last_active, self.epoch,
            self.config,
        )
        evicted = self.evict_ids(victims) if victims else []
        self._maybe_compact()
        return evicted

    def _maybe_compact(self) -> None:
        frac = self.config.auto_compact_fragmentation
        if frac <= 0:
            return
        reg = self.aggregator.registry
        free = reg.free_count()
        if free >= self.config.min_compact_rows and free > frac * len(reg):
            self.compact()

    # -- eviction --------------------------------------------------------- #

    def evict_ids(self, victims: List[int]) -> List[str]:
        """Retire the given live ids: device fold into their overflow
        rows, host lifetime folds, registry release, snapshot and cache
        invalidation.  Returns the evicted names."""
        agg, wheel, reg = self.aggregator, self.wheel, self.aggregator.registry
        pairs = []  # (victim id, name, overflow id or -1, overflow name)
        for mid in victims:
            name = reg.name_for(int(mid))
            if name is None or self.config.is_protected(name):
                continue
            oname = self.config.overflow_name(name)
            # registered BEFORE the device locks: _id_for may grow the
            # row space (it takes _dev_lock itself)
            omid = agg._id_for(oname)
            pairs.append((int(mid), name, omid, oname))
        if not pairs:
            return []
        vids = np.asarray([p[0] for p in pairs], dtype=np.int32)
        # a shed overflow target (registry exhausted) is DROP: the victim
        # still zeroes, its lifetime total survives in the host folds
        tids = np.asarray([p[2] if p[2] >= 0 else DROP_ID for p in pairs],
                          dtype=np.int32)
        vpad = pad_pow2_ids(vids)
        tpad = np.full(len(vpad), DROP_ID, dtype=np.int32)
        tpad[:len(tids)] = tids

        with agg._dev_lock:
            la = self.ensure_capacity_locked(agg.num_metrics)
            with wheel._lock:
                rings = [t.ring for t in wheel._tiers]
                if self._paged:
                    # the pool first, grouped by overflow target: a host
                    # translate plus a pool commit, count-exact, whose
                    # moved totals stand for the dense path's vcounts;
                    # shed targets' victims are dropped outright (their
                    # lifetime totals survive in the host folds below)
                    by_target: Dict[int, List[int]] = {}
                    shed: List[int] = []
                    for mid, _, omid, _ in pairs:
                        if omid >= 0:
                            by_target.setdefault(omid, []).append(mid)
                        else:
                            shed.append(mid)
                    moved = sum(agg.paged.fold_rows_into(vlist, omid)
                                for omid, vlist in by_target.items())
                    if shed:
                        agg.paged.drop_rows(shed)
                    rings, la = self._fold(rings, la, vpad, tpad,
                                           self.epoch)
                else:
                    acc, rings, la, vcounts = self._fold(
                        agg._acc, rings, la, vpad, tpad, self.epoch,
                    )
                    agg._acc = acc
                    moved = int(vcounts[:len(vids)].sum())
                for t, r in zip(wheel._tiers, rings):
                    t.ring = r
                self._la = la
                if self.anomaly is not None:
                    # the freed rows' next tenants start cold
                    self.anomaly.on_evicted_locked(vpad)
                if agg._spill is not None:
                    for mid, _, omid, _ in pairs:
                        if mid < len(agg._spill):
                            if 0 <= omid < len(agg._spill):
                                agg._spill[omid] += agg._spill[mid]
                            agg._spill[mid] = 0
                # release the names inside the critical section: a query
                # that starts after it sees the new generation, cleared
                # caches and no snapshot
                reg.evict([p[0] for p in pairs])
                wheel.lifecycle_invalidated_locked()
            agg.stats_snapshot = None

        # host lifetime folds (leaf locks, exact integers)
        with agg._agg_lock:
            for mid, _, omid, _ in pairs:
                entry = agg._agg.pop(mid, None)
                if entry is not None and omid >= 0:
                    dst = agg._agg.setdefault(omid, [0, 0])
                    dst[0] += entry[0]
                    dst[1] += entry[1]
        ms = self.metric_system
        if ms is not None:
            with ms._store_lock:
                for _, name, _, oname in pairs:
                    entry = ms._histogram_agg_store.pop(name, None)
                    if entry is not None:
                        dst = ms._histogram_agg_store.setdefault(
                            oname, [0, 0])
                        dst[0] += entry[0]
                        dst[1] += entry[1]
                    c = ms._counter_store.pop(name, None)
                    if c is not None:
                        ms._counter_store[oname] = (
                            ms._counter_store.get(oname, 0) + c)

        with self._metrics_lock:
            self.evictions += 1
            self.evicted_series += len(pairs)
            self.overflowed_samples += moved
        return [p[1] for p in pairs]

    # -- compaction ------------------------------------------------------- #

    def compact(self) -> bool:
        """Repack live rows to a dense prefix (K6 over every structure;
        on paged storage a page-table permutation and K6 over the rings),
        then remap the registry and the host aggregates.  Returns False
        when already dense or when a concurrent registration invalidated
        the permutation (the next tick retries)."""
        agg, wheel, reg = self.aggregator, self.wheel, self.aggregator.registry
        t0 = time.perf_counter()
        with agg._dev_lock:
            names = reg.names()
            live = [m for m, n in enumerate(names) if n is not None]
            m_rows = agg.num_metrics
            if len(live) == len(names):
                return False  # already dense
            perm = np.full(m_rows, DROP_ID, dtype=np.int32)
            perm[:len(live)] = live
            try:
                # host commit point first: validates that no registration
                # raced the permutation build
                reg.apply_permutation([int(p) for p in perm], m_rows)
            except ValueError as e:
                logger.warning("compaction aborted: %s", e)
                return False
            old_to_new = {old: new for new, old in enumerate(live)}
            la = self.ensure_capacity_locked(m_rows)
            with wheel._lock:
                tiers = wheel._tiers
                rings = [t.ring for t in tiers]
                for t in tiers:
                    t.ring = None  # the list holds the only reference
                try:
                    if self._paged:
                        # the pool's repack is a host permutation of the
                        # page table's rows (DROP_ID pads become -1
                        # holes), after the registry's commit point and
                        # before the rings' repack
                        agg.paged.apply_permutation(
                            np.where((perm >= 0) & (perm < m_rows), perm,
                                     -1), m_rows)
                        rings, la = self._compact(rings, la, perm,
                                                  self.epoch)
                    else:
                        acc, rings, la = self._compact(agg._acc, rings, la,
                                                       perm, self.epoch)
                        agg._acc = acc
                finally:
                    for t, r in zip(tiers, rings):
                        t.ring = r
                self._la = la
                if self.anomaly is not None:
                    # baselines follow their rows through the repack
                    self.anomaly.apply_permutation_locked(perm)
                if agg._spill is not None:
                    spill = np.zeros_like(agg._spill)
                    nsrc = [s for s in live if s < len(agg._spill)]
                    spill[:len(nsrc)] = agg._spill[nsrc]
                    agg._spill = spill
                wheel.lifecycle_invalidated_locked()
            agg.stats_snapshot = None
        with agg._agg_lock:
            agg._agg = {
                old_to_new[mid]: entry for mid, entry in agg._agg.items()
                if mid in old_to_new
            }
        us = (time.perf_counter() - t0) * 1e6
        with self._metrics_lock:
            self.compactions += 1
            self.last_compaction_us = us
            self._compaction_us.append(us)
        ms = self.metric_system
        if ms is not None:
            ms.histogram("lifecycle.CompactionLatencyUs", us)
        return True

    # -- state ------------------------------------------------------------ #

    def state_dict(self) -> dict:
        """Host state: the activity vector and the lifetime counters (the
        registry and the overflow rows ride the aggregator's state)."""
        with self.aggregator._dev_lock:
            la = (self._la.cpu().numpy().copy() if self._la is not None
                  else np.zeros(0, dtype=np.int32))
        with self._metrics_lock:
            return {
                "last_active": la,
                "evicted_series": self.evicted_series,
                "overflowed_samples": self.overflowed_samples,
                "evictions": self.evictions,
                "compactions": self.compactions,
            }

    def load_state(self, state: dict) -> None:
        la = np.asarray(state.get("last_active", []), dtype=np.int32)
        with self.aggregator._dev_lock:
            if len(la):
                self._la = torch.from_numpy(la.copy()).to(
                    self.aggregator.device)
        with self._metrics_lock:
            self.evicted_series = int(state.get("evicted_series", 0))
            self.overflowed_samples = int(state.get("overflowed_samples", 0))
            self.evictions = int(state.get("evictions", 0))
            self.compactions = int(state.get("compactions", 0))

    # -- gauges ----------------------------------------------------------- #

    def _compaction_p99(self) -> float:
        with self._metrics_lock:
            if not self._compaction_us:
                return 0.0
            return float(np.percentile(np.asarray(self._compaction_us), 99.0))

    def register_gauges(self, ms) -> None:
        """Export the ``lifecycle.*`` self-metric family."""
        reg = self.aggregator.registry
        agg = self.aggregator
        gauges: Dict[str, object] = {
            "lifecycle.ActiveSeries": lambda: float(reg.live_count()),
            "lifecycle.FreeSlots": lambda: float(reg.free_count()),
            "lifecycle.Generation": lambda: float(reg.generation),
            "lifecycle.EvictedSeries": lambda: float(self.evicted_series),
            "lifecycle.OverflowedSamples":
                lambda: float(self.overflowed_samples),
            "lifecycle.Evictions": lambda: float(self.evictions),
            "lifecycle.Compactions": lambda: float(self.compactions),
            "lifecycle.LastCompactionUs":
                lambda: float(self.last_compaction_us),
            "lifecycle.CompactionP99Us": self._compaction_p99,
            "lifecycle.Occupancy": lambda: (
                float(reg.live_count()) / agg.num_metrics
                if agg.num_metrics else 0.0),
        }
        for name, fn in gauges.items():
            ms.register_gauge_func(name, fn)
