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

On a ("stream", "metric") mesh (ROADMAP D10, dense storage) the
activity vector is the rank's block ``[M / n_metric]`` of it, the same
on every rank of a metric column (the fused step stamps the gathered
chunk's ids).  ``check()`` gathers it over the metric axis and runs the
policies on identical inputs on every rank; ``evict_ids`` folds the
victims across the metric line (``ops/lifecycle.
make_sharded_fold_evict_fn``) and ``compact`` moves the rows that cross
ranks before K6 repacks each block (``make_sharded_compact_fn``).  All
three are collectives that every rank calls in the same order (D9's
entry points); each first lays out the registry's growth
(``TorchAggregator._mesh_regrow``, which also re-lays the activity
block).

On paged storage on a mesh (ROADMAP D13) the pool's side runs on every
rank's host half, as on one card: ``fold_rows_into`` gathers the
victims' cells over the metric axis and every rank re-commits them into
the target's arena (K4), ``drop_rows`` and ``apply_permutation`` act on
the rank's own arena and spill block (a permutation migrates the rows
that change shard); the ring blocks and the activity block move as on
dense storage (``with_acc=False``), and the host spill moves with the
store, so the dense spill's fold is skipped.  An eviction or a
compaction lands the aggregator's staged batches first.

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
from loghisto_tpu_torch.ops.commit import stamp_activity
from loghisto_tpu_torch.ops.lifecycle import (
    make_compact_fn,
    make_fold_evict_fn,
    make_sharded_compact_fn,
    make_sharded_fold_evict_fn,
    make_touch_fn,
    pad_pow2_ids,
    resolve_compact_path,
    take_rows,
)
from loghisto_tpu_torch.parallel.mesh import (
    METRIC_AXIS,
    RowMove,
    block_ids,
    fold_rows,
    gather_parts,
    global_put,
    host_gather,
    is_first_rank,
    mesh_reduce,
    row_vector_sharding,
)

logger = logging.getLogger("loghisto_tpu_torch")

# a mesh's grown activity rows before their first use: the reference pads
# its carry when it next needs it, stamping the epoch of that moment
_UNSET = -(2**31)


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
        self._mesh = getattr(aggregator, "mesh", None)
        if self._mesh is not None:
            resolve_compact_path(config.compact_path)
            self._fold = make_sharded_fold_evict_fn(
                self._mesh, num_tiers, with_acc=not self._paged)
            self._compact = make_sharded_compact_fn(
                self._mesh, num_tiers, with_acc=not self._paged)
            # growth re-lays the activity block with the accumulator
            aggregator._mesh_carries.append(self._relayout_locked)
        else:
            self._fold = make_fold_evict_fn(num_tiers,
                                            with_acc=not self._paged)
            self._compact = make_compact_fn(num_tiers, config.compact_path,
                                            with_acc=not self._paged)
        self._touch = make_touch_fn()
        # the drift engine's banks live and die with these rows; set by
        # TorchMetricSystem so bank rows are zeroed with their victims
        # and permuted with their survivors
        self.anomaly = None
        self._la: Optional[torch.Tensor] = None  # int32 [M], _dev_lock
        self._unset = False  # a mesh's grown rows still read _UNSET

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
        # on a mesh, the bytes this rank sent in its last eviction and
        # its last compaction (the rows that crossed ranks)
        self.last_evict_bytes = 0
        self.last_compaction_bytes = 0

    # -- epoch / activity carry (callers hold agg._dev_lock) ------------- #

    @property
    def epoch(self) -> int:
        """Committed-interval count: the lifecycle clock (the wheel's
        counter, so a carried-over wheel keeps activity comparable)."""
        return self.wheel.intervals_pushed

    def ensure_capacity_locked(self, m: int) -> torch.Tensor:
        """The activity carry, grown to ``m`` rows (new rows stamp the
        current epoch: a fresh row is as alive as a fresh name).  On a
        mesh the rank's block of ``m`` rows, which only growth's
        re-layout resizes."""
        la = self._la
        dev = self.aggregator.device
        if self._mesh is not None:
            m //= self.aggregator._n_metric
            if la is not None and la.shape[0] != m:
                raise RuntimeError(f"activity block of {la.shape[0]} rows, "
                                   f"the accumulator's has {m}")
            if self._unset:
                la.masked_fill_(la == _UNSET, self.epoch)
                self._unset = False
        if la is None:
            la = torch.full((m,), self.epoch, dtype=torch.int32, device=dev)
        elif la.shape[0] < m:
            la = torch.cat([la, torch.full((m - la.shape[0],), self.epoch,
                                           dtype=torch.int32, device=dev)])
        self._la = la
        return la

    def store_carry_locked(self, la: torch.Tensor) -> None:
        self._la = la

    def _relayout_locked(self, regrown) -> None:
        """Growth on a mesh (``TorchAggregator._mesh_regrow``, under its
        lock): the rank's new block of the gathered carry, the new rows
        ``_UNSET`` until ``ensure_capacity_locked`` stamps them with the
        epoch of that call, when the reference pads its carry."""
        if self._la is not None:
            self._la = regrown(self._la, fill=_UNSET).to(
                self.aggregator.device)
            self._unset = True

    def touch_locked(self, ids) -> None:
        """Activity stamp of the spill fan-out (the fused commit stamps
        inside its own step); on a mesh ``ids`` are the whole interval's
        (global, a host array or a tensor) and the rank stamps those of
        its block."""
        if len(ids) == 0:
            return
        la = self.ensure_capacity_locked(self.aggregator.num_metrics)
        if self._mesh is not None:
            agg = self.aggregator
            ids = torch.as_tensor(ids).to(la.device, torch.int32)
            stamp_activity(la, block_ids(ids, agg._row0, agg._rows),
                           self.epoch)
            return
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
        reads as idle.  On a mesh they are the ids of every chunk the
        rank gathered, as its peers stamped them."""
        if landed_ids is not None:
            self.touch_locked(landed_ids)

    def _mesh_layout(self) -> None:
        """A mesh's collective preamble of an eviction or a compaction:
        the registry's growth laid out (``_mesh_regrow``, which re-lays
        the activity block too), and on paged storage the staged batches
        landed first (``land_staged``, which lays the growth out itself),
        so no staged sample lands under an id the rows' move reassigned
        (ROADMAP D13)."""
        agg = self.aggregator
        if self._paged:
            agg.land_staged()
        else:
            agg._mesh_regrow()

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
            # a copy on the device, ordered on the writers' stream: the
            # gather and the readback run after the lock is released
            la = self._la.clone()
        if self._mesh is not None:
            # the same [M] vector on every rank, so the same victims;
            # grown rows not stamped yet are past it (no row yet)
            la = gather_parts(self._mesh, la, METRIC_AXIS)
            la = la[:int((la != _UNSET).sum())]
        last_active = la.cpu().numpy()
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
        mesh = self._mesh
        if mesh is not None:
            # an overflow name may have grown the registry: its row must
            # exist before the fold (a collective, as every step below)
            self._mesh_layout()

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
                    if mesh is not None:
                        rings, la, self.last_evict_bytes = self._fold(
                            rings, la, vpad, tpad, self.epoch)
                    else:
                        rings, la = self._fold(rings, la, vpad, tpad,
                                               self.epoch)
                elif mesh is not None:
                    acc, rings, la, moved, sent = self._fold(
                        agg._acc, rings, la, vpad, tpad, self.epoch)
                    agg._acc = acc
                    self.last_evict_bytes = sent
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
                if mesh is not None and not self._paged:
                    self._fold_spill_mesh_locked(vpad, tpad)
                elif agg._spill is not None:
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

    def _mesh_spill_locked(self):
        """On a mesh: the rank's host spill block as a tensor (zeros if
        it had none) when any rank of its metric line holds one, else
        None; a collective of the line."""
        import torch.distributed as dist

        agg = self.aggregator
        if not mesh_reduce(self._mesh, [agg._spill is not None],
                           dist.ReduceOp.MAX, (METRIC_AXIS,))[0]:
            return None
        if agg._spill is None:
            agg._spill = np.zeros(tuple(agg._acc.shape), dtype=np.int64)
        return torch.from_numpy(agg._spill)

    def _fold_spill_mesh_locked(self, victims, targets) -> None:
        """The eviction fold of the host spill blocks across the metric
        line, as the accumulator's."""
        spill = self._mesh_spill_locked()
        if spill is not None:
            fold_rows(self._mesh, spill, 0, victims, targets,
                      self.aggregator._rows)

    # -- compaction ------------------------------------------------------- #

    def compact(self) -> bool:
        """Repack live rows to a dense prefix (K6 over every structure;
        on paged storage a page-table permutation and K6 over the rings),
        then remap the registry and the host aggregates.  Returns False
        when already dense or when a concurrent registration invalidated
        the permutation (the next tick retries)."""
        agg, wheel, reg = self.aggregator, self.wheel, self.aggregator.registry
        t0 = time.perf_counter()
        mesh = self._mesh
        if mesh is not None:
            # the permutation covers the grown rows: lay them out first
            self._mesh_layout()
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
                        if mesh is not None:
                            rings, la, self.last_compaction_bytes = (
                                self._compact(rings, la, perm, self.epoch,
                                              [np.flatnonzero(t.written)
                                               for t in tiers]))
                        else:
                            rings, la = self._compact(rings, la, perm,
                                                      self.epoch)
                    elif mesh is not None:
                        acc, rings, la, sent = self._compact(
                            agg._acc, rings, la, perm, self.epoch,
                            [np.flatnonzero(t.written) for t in tiers])
                        agg._acc = acc
                        self.last_compaction_bytes = sent
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
                    self.last_compaction_bytes += (
                        self.anomaly.apply_permutation_locked(perm))
                if mesh is not None and not self._paged:
                    spill = self._mesh_spill_locked()
                    if spill is not None:
                        move = RowMove(mesh, perm, agg._rows, agg._rows)
                        agg._spill = move.apply(spill, 0,
                                                take_rows).numpy()
                        self.last_compaction_bytes += move.bytes_sent
                elif agg._spill is not None:
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

    def state_dict(self, *, first_only: bool = False) -> Optional[dict]:
        """Host state: the activity vector and the lifetime counters (the
        registry and the overflow rows ride the aggregator's state).  On
        a mesh (ROADMAP D11) a collective call that every rank makes: the
        activity blocks gathered over the metric axis, every rank
        returning the same vector, cut where the reference's carry ends
        (grown rows not stamped yet are past it, as in ``check``).  With
        ``first_only`` (a checkpoint's save) rank (0, 0) alone gathers
        and returns the state, and every other rank returns None."""
        mesh = self._mesh
        with self.aggregator._dev_lock:
            # a copy on the device, ordered on the writers' stream: the
            # gather and the readback run after the lock is released
            la = None if self._la is None else self._la.clone()
        if la is None:
            la = np.zeros(0, dtype=np.int32)
        elif mesh is not None:
            la = host_gather(la, row_vector_sharding(mesh), first_only)
            if la is not None:
                la = la[:int((la != _UNSET).sum())].copy()
        else:
            la = la.cpu().numpy()
        if first_only and mesh is not None and not is_first_rank(mesh):
            return None
        with self._metrics_lock:
            return {
                "last_active": la,
                "evicted_series": self.evicted_series,
                "overflowed_samples": self.overflowed_samples,
                "evictions": self.evictions,
                "compactions": self.compactions,
            }

    def load_state(self, state: dict) -> None:
        """Replace the activity vector and the counters.  On a mesh every
        rank loads the same vector and keeps its block of the
        accumulator's rows (no collective); rows past a shorter vector
        wait unset, as grown rows do, until the next commit stamps
        them."""
        la = np.asarray(state.get("last_active", []), dtype=np.int32)
        with self.aggregator._dev_lock:
            if len(la) and self._mesh is not None:
                self._la = self._block_of(la)
            elif len(la):
                self._la = torch.from_numpy(la.copy()).to(
                    self.aggregator.device)
        with self._metrics_lock:
            self.evicted_series = int(state.get("evicted_series", 0))
            self.overflowed_samples = int(state.get("overflowed_samples", 0))
            self.evictions = int(state.get("evictions", 0))
            self.compactions = int(state.get("compactions", 0))

    def _block_of(self, la: np.ndarray) -> torch.Tensor:
        """This rank's block of a whole activity vector (caller holds
        ``_dev_lock``), padded with ``_UNSET`` to the accumulator's
        rows."""
        m = self.aggregator.num_metrics
        if len(la) > m:
            raise ValueError(f"activity vector of {len(la)} rows for an "
                             f"accumulator of {m}")
        whole = np.full(m, _UNSET, dtype=np.int32)
        whole[:len(la)] = la
        self._unset = self._unset or len(la) < m
        return global_put(whole, row_vector_sharding(self._mesh))

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
