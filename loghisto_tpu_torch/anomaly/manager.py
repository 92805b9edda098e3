"""AnomalyManager: owns the EWMA baseline banks, runs one scoring pass
per interval and serves drift scores to rules and exporters
(counterpart of ``loghisto_tpu/anomaly/manager.py``).

Like the LifecycleManager it rides the IntervalCommitter's bridge
thread.  The committer threads the carries — the interval histogram
``ihist`` and the banks ``(prof, wsum)`` — through its commit steps
(``ensure_capacity_locked`` / ``store_carry_locked``, under the
aggregator's ``_dev_lock``), then calls ``on_interval`` with no lock
held BEFORE the wheel's hooks, so drift rules see the interval that
just landed.  Scoring reads the published snapshot (immutable) and the
banks and runs K7 once (``ops.anomaly.divergence_scores``).

Scores are keyed on the registry's generation: ``scores_for(name)``
returns None when the generation moved since the scores were computed
(eviction, slot reuse, compaction), so a dead or reused id never serves
another series' score.  The LifecycleManager calls
``on_evicted_locked`` / ``apply_permutation_locked`` inside its device
critical sections: bank rows are zeroed with their victims and follow
their survivors.

On a ("stream", "metric") mesh (ROADMAP D10, dense storage) the
carries are the rank's blocks of the accumulator's rows: ``prof`` f32
``[K, M / n_metric, B]``, ``wsum`` f32 ``[K, M / n_metric]``, ``ihist``
int32 ``[M / n_metric, B]``, the same on every rank of a metric column.
Eviction zeroes the victims the rank holds, a compaction moves the bank
rows that cross ranks before K6 repacks each block, growth re-lays them
with the accumulator (``TorchAggregator._mesh_regrow``), and
``score_now`` is a collective: the ranks agree that every one of them
can score (a MIN over the mesh), K7 runs on each rank's view block and
one ``all_gather`` over the metric axis gives every rank the same
scores, so ``scores_for``, the ``anomaly.<name>.*`` gauges and drift
rules read the same numbers everywhere.

A scoring failure is not caught here: it leaves the committer's
``commit`` and lands in ``bridge_error`` (ROADMAP D6).
"""

from __future__ import annotations

import fnmatch
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from loghisto_tpu_torch.anomaly.config import AnomalyConfig
from loghisto_tpu_torch.obs.spans import NULL_RECORDER
from loghisto_tpu_torch.ops.anomaly import (
    SCORE_KEYS,
    make_bank_compact_fn,
    make_bank_evict_fn,
    make_divergence_fn,
    make_sharded_bank_compact_fn,
    make_sharded_divergence_fn,
    resolve_divergence_path,
)
from loghisto_tpu_torch.parallel.mesh import (
    bank_weight_sharding,
    block_ids,
    global_put,
    host_gather,
    is_first_rank,
    mesh_reduce,
    ring_sharding,
)


class AnomalyManager:
    """Drift-engine runtime for a dense (TorchAggregator, TimeWheel)
    pair.  ``TorchMetricSystem(anomaly=AnomalyConfig(...))`` builds one;
    standalone construction serves tests."""

    def __init__(self, aggregator, wheel, config: AnomalyConfig,
                 metric_system=None):
        if wheel is None:
            raise ValueError(
                "the drift engine needs a retention wheel: baselines "
                "ride the fused interval commit and scoring consumes "
                "the commit-time snapshot CDFs"
            )
        if not wheel.snapshots_enabled:
            raise ValueError(
                "the drift engine needs commit-time snapshots "
                "(TimeWheel snapshots=True): scoring consumes the "
                "published window CDF views"
            )
        if config.tier >= len(wheel._tiers):
            raise ValueError(
                f"anomaly tier {config.tier} out of range "
                f"({len(wheel._tiers)} tiers)"
            )
        self.aggregator = aggregator
        self.wheel = wheel
        self.config = config
        self.metric_system = metric_system
        self.divergence_path = resolve_divergence_path(config.divergence_path)
        self._mesh = getattr(aggregator, "mesh", None)
        self._evict = make_bank_evict_fn()
        if self._mesh is not None:
            self._div = make_sharded_divergence_fn(self._mesh,
                                                   self.divergence_path)
            self._compact = make_sharded_bank_compact_fn(self._mesh)
            # growth re-lays the bank blocks with the accumulator
            aggregator._mesh_carries.append(self._relayout_locked)
        else:
            self._div = make_divergence_fn(self.divergence_path)
            self._compact = make_bank_compact_fn()
        if config.window is not None:
            # materialize the scoring window as a snapshot view
            wheel.pin_window(config.window)

        # carries on the aggregator's device, guarded by _dev_lock
        self._prof: Optional[torch.Tensor] = None   # f32 [K, M, B]
        self._wsum: Optional[torch.Tensor] = None   # f32 [K, M]
        self._ihist: Optional[torch.Tensor] = None  # int32 [M, B]

        # latest host scores and the registry generation they belong to
        self._scores_lock = threading.Lock()
        self._scores: Optional[Dict[str, np.ndarray]] = None
        self._scores_gen = -1

        self._intervals_seen = 0
        # the scoring pass's span; TorchMetricSystem(observability=...)
        # installs a real ring
        self.obs_recorder = NULL_RECORDER
        self.scored_intervals = 0
        self.skipped_intervals = 0  # no snapshot / no baselines yet

        # per-metric gauges anomaly.<name>.{ks,jsd,emd}, registered lazily
        self._export_key = None  # (generation, registry high-water)
        self._exported: set = set()

    # -- host scalars of the commit's final step ------------------------- #

    @property
    def decay32(self) -> np.float32:
        return np.float32(self.config.decay)

    @property
    def min_count32(self) -> np.int32:
        return np.int32(self.config.min_samples)

    def bank_for(self, t) -> int:
        """Active bank for an interval timestamp (datetime or None),
        taken mod ``banks``."""
        cfg = self.config
        if cfg.bank_of is None or t is None:
            return 0
        return int(cfg.bank_of(t)) % cfg.banks

    # -- carry protocol (callers hold aggregator._dev_lock) -------------- #

    def ensure_capacity_locked(self, m: int):
        """The drift carries grown to ``m`` rows (new rows start cold:
        zero profile, zero weight).  Returns ``(ihist, (prof, wsum))``.
        On a mesh the rank's blocks of ``m`` rows, which only growth's
        re-layout resizes."""
        k = self.config.banks
        b = self.wheel.config.num_buckets
        dev = self.aggregator.device
        if self._mesh is not None:
            m //= self.aggregator._n_metric
            if self._prof is not None and self._prof.shape[1] != m:
                raise RuntimeError(f"bank block of {self._prof.shape[1]} "
                                   f"rows, the accumulator's has {m}")
        if self._ihist is None:
            self._ihist = torch.zeros((m, b), dtype=torch.int32, device=dev)
        elif self._ihist.shape[0] < m:
            self._ihist = torch.cat([self._ihist, torch.zeros(
                (m - self._ihist.shape[0], b), dtype=torch.int32,
                device=dev)])
        if self._prof is None:
            self._prof = torch.zeros((k, m, b), dtype=torch.float32,
                                     device=dev)
            self._wsum = torch.zeros((k, m), dtype=torch.float32, device=dev)
        elif self._prof.shape[1] < m:
            gap = m - self._prof.shape[1]
            self._prof = torch.cat([self._prof, torch.zeros(
                (k, gap, b), dtype=torch.float32, device=dev)], dim=1)
            self._wsum = torch.cat([self._wsum, torch.zeros(
                (k, gap), dtype=torch.float32, device=dev)], dim=1)
        return self._ihist, (self._prof, self._wsum)

    def store_carry_locked(self, ihist, banks) -> None:
        self._ihist = ihist
        self._prof, self._wsum = banks

    def _relayout_locked(self, regrown) -> None:
        """Growth on a mesh (``TorchAggregator._mesh_regrow``, under its
        lock): the rank's new blocks of the gathered carries, new rows
        cold."""
        dev = self.aggregator.device
        if self._ihist is not None:
            self._ihist = regrown(self._ihist).to(dev)
        if self._prof is not None:
            self._prof = regrown(self._prof, dim=1).to(dev)
            self._wsum = regrown(self._wsum, dim=1).to(dev)

    def on_device_failure_locked(self) -> None:
        """A fused commit step failed.  The reference rebuilds cold
        (zeros) the carries its donated dispatch consumed; the port's
        steps update the interval histogram and the banks in place, so
        they survive the failure and nothing is rebuilt."""

    # -- lifecycle integration (both device locks held) ------------------ #

    def on_evicted_locked(self, victim_ids: np.ndarray) -> None:
        """Zero the victims' bank rows (every bank) and interval
        histogram rows; ``victim_ids`` may carry DROP_ID pads.  On a
        mesh (global ids) the victims of the rank's block."""
        if self._prof is None:
            return
        if self._mesh is not None:
            agg = self.aggregator
            victim_ids = block_ids(np.asarray(victim_ids, dtype=np.int64),
                                   agg._row0, agg._rows)
        self._prof, self._wsum, self._ihist = self._evict(
            self._prof, self._wsum, self._ihist, victim_ids)

    def apply_permutation_locked(self, perm: np.ndarray) -> int:
        """Repack the bank carries with the lifecycle's survivor
        permutation (``perm[new] = old``); returns the bytes this rank
        sent (on a mesh, the bank rows that crossed ranks; else 0)."""
        if self._prof is None:
            return 0
        if self._mesh is None:
            self._prof, self._wsum, self._ihist = self._compact(
                self._prof, self._wsum, self._ihist, perm)
            return 0
        self._prof, self._wsum, self._ihist, sent = self._compact(
            self._prof, self._wsum, self._ihist, perm)
        return sent

    # -- scoring ---------------------------------------------------------- #

    def on_interval(self, raw, when=None) -> None:
        """After each committed interval (committer thread, no lock
        held), before the wheel's hooks.  ``when`` picks the bank (the
        mesh's agreed interval time; default ``raw.time``)."""
        self._intervals_seen += 1
        if self._intervals_seen % self.config.check_every:
            return
        with self.obs_recorder.span("anomaly.score", raw.seq):
            self.score_now(raw.time if when is None else when)

    def _view(self, snap):
        ts = snap.tiers[self.config.tier]
        view = None
        if self.config.window is not None:
            view = ts.view_for(self.config.window)
        # the full covered span is always views[0]
        return view if view is not None else ts.views[0]

    def score_now(self, now=None) -> Optional[Dict[str, np.ndarray]]:
        """One scoring pass (K7 on the card): live view CDF against the
        active bank.  Returns the host score arrays, or None when there
        is nothing to score yet."""
        snap = self.wheel.snapshot  # atomic read of an immutable handle
        with self.aggregator._dev_lock:
            ready = snap is not None and self._prof is not None
            if self._mesh is not None:
                import torch.distributed as dist

                # every rank scores, or none: the pass is a collective
                ready = bool(mesh_reduce(self._mesh, [int(ready)],
                                         dist.ReduceOp.MIN)[0])
            if not ready:
                self.skipped_intervals += 1
                return None
            prof, wsum = self._prof, self._wsum
            gen = self.aggregator.registry.generation
            view = self._view(snap)
            scores = self._div(view.cdf, view.counts, prof, wsum,
                               self.bank_for(now), self.config.min_samples)
        host = {k: v.cpu().numpy() for k, v in scores.items()}
        with self._scores_lock:
            self._scores = host
            self._scores_gen = gen
            self.scored_intervals += 1
        self._refresh_export()
        return host

    def scores_for(self, name: str) -> Optional[Dict[str, float]]:
        """Latest drift scores of a metric, or None when it has no
        scored row or the registry's generation moved since."""
        reg = self.aggregator.registry
        with self._scores_lock:
            scores, gen = self._scores, self._scores_gen
        if scores is None or reg.generation != gen:
            return None
        mid = reg.lookup(name)
        if mid is None or mid >= len(scores["ks"]):
            return None
        return {k: float(scores[k][mid]) for k in SCORE_KEYS}

    # -- state ------------------------------------------------------------ #

    def state_dict(self, *, first_only: bool = False) -> Optional[dict]:
        """Host bank state.  The interval histogram is in-flight state
        and is not kept.  On a mesh (ROADMAP D11) a collective call that
        every rank makes: the bank blocks gathered over the metric axis,
        every rank returning the same banks.  With ``first_only`` (a
        checkpoint's save) rank (0, 0) alone gathers and returns the
        state, and every other rank returns None."""
        k = self.config.banks
        b = self.wheel.config.num_buckets
        mesh = self._mesh
        with self.aggregator._dev_lock:
            # copies on the device, ordered on the writers' stream: the
            # gathers and the readback run after the lock is released
            banks = (None if self._prof is None
                     else (self._prof.clone(), self._wsum.clone()))
        if banks is None:
            prof = np.zeros((k, 0, b), dtype=np.float32)
            wsum = np.zeros((k, 0), dtype=np.float32)
        elif mesh is not None:
            prof = host_gather(banks[0], ring_sharding(mesh), first_only)
            wsum = host_gather(banks[1], bank_weight_sharding(mesh),
                               first_only)
        else:
            prof, wsum = (t.cpu().numpy() for t in banks)
        if first_only and mesh is not None and not is_first_rank(mesh):
            return None
        return {"prof": prof, "wsum": wsum,
                "scored_intervals": self.scored_intervals}

    def load_state(self, state: dict) -> None:
        """Replace the banks and the scored-interval count.  On a mesh
        every rank loads the same banks and keeps its block of the
        accumulator's rows (no collective); rows past shorter banks
        start cold."""
        prof = np.asarray(state["prof"], dtype=np.float32)
        wsum = np.asarray(state["wsum"], dtype=np.float32)
        if prof.shape[0] != self.config.banks:
            raise ValueError(
                f"state has {prof.shape[0]} banks, config has "
                f"{self.config.banks}"
            )
        dev = self.aggregator.device
        with self.aggregator._dev_lock:
            if prof.shape[1] and self._mesh is not None:
                m = self.aggregator.num_metrics
                if prof.shape[1] > m:
                    raise ValueError(f"banks of {prof.shape[1]} rows for "
                                     f"an accumulator of {m}")
                k, rows, b = prof.shape
                whole = np.zeros((k, m, b), dtype=np.float32)
                whole[:, :rows] = prof
                self._prof = global_put(whole, ring_sharding(self._mesh))
                whole = np.zeros((k, m), dtype=np.float32)
                whole[:, :rows] = wsum
                self._wsum = global_put(whole,
                                        bank_weight_sharding(self._mesh))
            elif prof.shape[1]:
                self._prof = torch.from_numpy(prof.copy()).to(dev)
                self._wsum = torch.from_numpy(wsum.copy()).to(dev)
        self.scored_intervals = int(state.get("scored_intervals", 0))

    # -- gauges ------------------------------------------------------------ #

    def _gauge(self, name: str, key: str) -> Callable[[], float]:
        def value() -> float:
            s = self.scores_for(name)
            return s[key] if s is not None else 0.0
        return value

    def _refresh_export(self) -> None:
        """Register ``anomaly.<metric>.{ks,jsd,emd}`` gauges for names
        matching ``export_glob`` (at most ``max_export``), rescanning
        only when the registry's (generation, high-water) moved."""
        ms = self.metric_system
        cfg = self.config
        if ms is None or cfg.export_glob is None:
            return
        reg = self.aggregator.registry
        key = (reg.generation, len(reg))
        if key == self._export_key:
            return
        self._export_key = key
        for name in reg.names():
            if name is None or name in self._exported:
                continue
            if len(self._exported) >= cfg.max_export:
                break
            if not fnmatch.fnmatch(name, cfg.export_glob):
                continue
            self._exported.add(name)
            for k in SCORE_KEYS:
                ms.register_gauge_func(f"anomaly.{name}.{k}",
                                       self._gauge(name, k))

    def register_gauges(self, ms) -> None:
        """Export the ``anomaly.*`` self-metric family."""
        gauges = {
            "anomaly.ScoredIntervals": lambda: float(self.scored_intervals),
            "anomaly.SkippedIntervals": lambda: float(self.skipped_intervals),
            "anomaly.ExportedMetrics": lambda: float(len(self._exported)),
            "anomaly.Banks": lambda: float(self.config.banks),
        }
        for name, fn in gauges.items():
            ms.register_gauge_func(name, fn)
