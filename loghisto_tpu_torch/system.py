"""TorchMetricSystem: the wired product in one object (counterpart of
``loghisto_tpu/system.py``'s ``TPUMetricSystem``).

A host ``MetricSystem`` whose intervals are also aggregated on the card:
it builds a ``TorchAggregator`` and, with ``retention=``, a ``TimeWheel``
that shares the aggregator's registry; both attach behind the raw
boundary, so callers keep using counter/histogram/start_timer.

    ms = TorchMetricSystem(interval=1.0, num_metrics=1024, retention=True)
    ms.start()
    ms.histogram_batch("rpc_latency", values)      # host path, as ever
    ms.query_window("rpc_latency", window=300)     # p99 over 5m, K5
    ms.device_metrics()                            # interval stats, K3

Labeled series (``labels=`` on every recording call) are registry rows
named ``base;k=v;...``; one ``LabelIndex`` over the shared registry
(``label_index``) resolves selectors for the wheel:

    ms.recorder("rpc.latency", labels={"route": "/a", "code": "500"})
    ms.query("rpc.latency{code=~5..}", window=60)
    ms.query_group_by("rpc.latency{}", by=["route"], window=300, depth=4)

With retention on dense storage, ``commit="auto"`` resolves to the
fused ``IntervalCommitter`` (``commit.py``): one bridge lands each
interval on the accumulator and every tier (K3), publishes the snapshot
(K5) and carries the lifecycle and drift engines:

    ms = TorchMetricSystem(retention=True,
                           lifecycle=LifecycleConfig(ttl_intervals=60),
                           anomaly=AnomalyConfig(banks=24,
                                                 bank_of=hourly_bank))
    ms.add_rule(DistributionDriftRule("lat_shape", "rpc_latency"))

``lifecycle=`` evicts idle or over-budget series into count-exact
overflow rows and repacks the rows (K6); ``anomaly=`` keeps EWMA
baseline banks and scores every row's window against them (K7).  Both
need the fused commit.  ``commit="fanout"``, paged storage (ROADMAP D5)
and a system without retention commit through the aggregator's bridge
(``merge_raw``) and the wheel's (``push``).  ``stop()`` stops the reaper
first, lets the bridges take every interval already broadcast, then
re-raises the first bridge failure, if any.

Entry point rule: ``device`` defaults to the card and raises without
CUDA; ``device="cpu"`` runs the plain versions.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional, Sequence

import numpy as np

from loghisto_tpu_torch.anomaly import AnomalyManager
from loghisto_tpu_torch.channel import Channel
from loghisto_tpu_torch.commit import IntervalCommitter, \
    commit_incompatibility
from loghisto_tpu_torch.config import DEFAULT_PERCENTILES, MetricConfig
from loghisto_tpu_torch.labels import LabelIndex
from loghisto_tpu_torch.lifecycle import LifecycleManager
from loghisto_tpu_torch.metrics import MetricSystem, ProcessedMetricSet, \
    RawMetricSet
from loghisto_tpu_torch.ops.backend import resolve_device
from loghisto_tpu_torch.ops.dispatch import resolve_commit_path
from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
from loghisto_tpu_torch.window import (
    DEFAULT_TIERS,
    RuleEngine,
    TimeWheel,
)


class TorchMetricSystem(MetricSystem):
    def __init__(
        self,
        interval: float = 60.0,
        sys_stats: bool = True,
        config: MetricConfig = MetricConfig(),
        num_metrics: int = 1024,
        percentiles: Mapping[str, float] = DEFAULT_PERCENTILES,
        retention=None,
        commit: str = "auto",
        transport: str = "auto",
        storage: str = "auto",
        paged_config=None,
        lifecycle=None,
        anomaly=None,
        device=None,
    ):
        """``retention``: ``True`` builds a TimeWheel with the default
        60x1 / 60x60 / 24x3600 tiers, a sequence of ``(slots, res)``
        pairs one with those tiers, and a ``TimeWheel`` is attached as it
        is (it must share this system's registry).  ``commit``,
        ``transport``, ``storage``, ``paged_config``, ``lifecycle`` (a
        ``LifecycleConfig``) and ``anomaly`` (an ``AnomalyConfig``) mean
        what they mean for ``TPUMetricSystem``."""
        self.device = resolve_device(device)
        super().__init__(interval=interval, sys_stats=sys_stats,
                         config=config)
        self.aggregator = TorchAggregator(
            num_metrics=num_metrics,
            config=config,
            percentiles=percentiles,
            transport=transport,
            storage=storage,
            paged_config=paged_config,
            device=self.device,
        )
        self.aggregator.register_device_gauges(self)
        # one inverted index over the shared registry: the wheel's
        # selector queries and the labels.* gauges
        self.label_index = LabelIndex(self.aggregator.registry)
        self.label_index.register_gauges(self)

        self.retention: Optional[TimeWheel] = None
        self.rule_engine: Optional[RuleEngine] = None
        if retention is not None and retention is not False:
            if isinstance(retention, TimeWheel):
                self.retention = retention
            else:
                tiers = DEFAULT_TIERS if retention is True else retention
                self.retention = TimeWheel(
                    num_metrics=num_metrics,
                    config=config,
                    interval=interval,
                    tiers=tiers,
                    registry=self.aggregator.registry,
                    device=self.device,
                )
            self.retention.label_index = self.label_index
            self.rule_engine = RuleEngine(self.retention)
            self.rule_engine.attach()
            self.retention.register_query_gauges(self)
        self.commit_path = resolve_commit_path(
            commit, paged=self.aggregator.storage == "paged")
        self.committer: Optional[IntervalCommitter] = None
        self.lifecycle = None
        self.anomaly = None
        for what, cfg in (("lifecycle", lifecycle), ("the drift engine",
                                                     anomaly)):
            if cfg is not None and self.retention is None:
                raise ValueError(
                    f"{what} needs retention: construct with "
                    f"TorchMetricSystem(retention=True, ...)"
                )
        if self.commit_path == "fused" and self.retention is not None:
            reason = commit_incompatibility(self.aggregator, self.retention)
            if reason is None:
                self._build_committer(lifecycle, anomaly)
            elif commit == "fused":
                raise ValueError(f"fused commit unavailable: {reason}")
        if self.committer is None:
            # one consumer without retention: the "fan-out" is the
            # aggregator's bridge alone
            self.commit_path = "fanout"
            for what, cfg in (("lifecycle", lifecycle),
                              ("the drift engine", anomaly)):
                if cfg is not None:
                    raise ValueError(
                        f"{what} rides the fused interval commit; this "
                        "configuration resolved commit='fanout' (the "
                        "fan-out pipeline carries neither the activity "
                        "vector nor the baseline banks)"
                    )
        self._attach_bridges()

    def _build_committer(self, lifecycle, anomaly) -> None:
        if lifecycle is not None:
            self.lifecycle = LifecycleManager(
                self.aggregator, self.retention, lifecycle,
                metric_system=self,
            )
            self.lifecycle.register_gauges(self)
        if anomaly is not None:
            self.anomaly = AnomalyManager(
                self.aggregator, self.retention, anomaly,
                metric_system=self,
            )
            self.anomaly.register_gauges(self)
            if self.lifecycle is not None:
                # evictions zero bank rows, compactions permute them
                self.lifecycle.anomaly = self.anomaly
        self.committer = IntervalCommitter(
            self.aggregator, self.retention,
            lifecycle=self.lifecycle, anomaly=self.anomaly,
        )
        self.committer.register_gauges(self)

    def _attach_bridges(self) -> None:
        if self.committer is not None:
            # the single bridge of the fused path
            if self.committer._thread is None:
                self.committer.attach(self)
            return
        if self.aggregator._attached is None:
            self.aggregator.attach(self)
        if self.retention is not None and self.retention._thread is None:
            self.retention.attach(self)

    def record_batch(self, ids: np.ndarray, values: np.ndarray) -> None:
        """Batched firehose ingestion straight to the device accumulator
        (ids come from ``metric_id``)."""
        self.aggregator.record_batch(ids, values)

    def metric_id(self, name: str) -> int:
        """Dense row id for ``name`` (registers on first use)."""
        return self.aggregator.registry.id_for(name)

    def device_metrics(self, reset: bool = True) -> ProcessedMetricSet:
        """Device-side statistics of everything aggregated so far;
        re-raises a failure of the aggregator's bridge."""
        return self.aggregator.collect(reset=reset)

    # -- windowed retention and rules (requires retention=) -------------- #

    def _require_retention(self) -> TimeWheel:
        if self.retention is None:
            raise RuntimeError(
                "windowed queries/rules need retention: construct with "
                "TorchMetricSystem(retention=True) (or tiers/a TimeWheel)"
            )
        return self.retention

    def query_window(
        self,
        pattern: str = "*",
        window: Optional[float] = None,
        percentiles: Optional[Sequence[float]] = None,
        tier: Optional[int] = None,
    ):
        """Sliding-window statistics over the retention wheel (see
        ``TimeWheel.query``); ``pattern`` is a name glob or a label
        selector."""
        return self._require_retention().query(
            pattern, window, percentiles, tier
        )

    def query(
        self,
        selector: str = "*",
        window: Optional[float] = None,
        percentiles: Optional[Sequence[float]] = None,
        tier: Optional[int] = None,
    ):
        """Window query by label selector (``rpc.latency{route=/a,
        code=~5..}``) or name glob; the same serve as ``query_window``."""
        return self._require_retention().query(
            selector, window, percentiles, tier
        )

    def query_group_by(
        self,
        selector: str,
        by: Sequence[str],
        window: Optional[float] = None,
        percentiles: Optional[Sequence[float]] = None,
        tier: Optional[int] = None,
        depth: Optional[int] = None,
    ):
        """Merge the rows matching ``selector`` into one histogram per
        value-tuple of the ``by`` label keys, on the card (see
        ``TimeWheel.query_group_by``); ``depth=k`` adds each group's
        equi-depth edges."""
        return self._require_retention().query_group_by(
            selector, by, window=window, percentiles=percentiles,
            tier=tier, depth=depth,
        )

    def window_rate(self, name: str, window: float) -> float:
        """Counter rate (events/s) over the trailing window."""
        return self._require_retention().window_rate(name, window)

    def add_rule(self, rule):
        """Register an alerting rule (window.rules.*Rule), evaluated
        after every interval; its state gauges join this system's.  A
        ``DistributionDriftRule`` is bound to this system's
        AnomalyManager (needs ``anomaly=``)."""
        self._require_retention()
        if getattr(rule, "kind", None) == "distribution_drift":
            if self.anomaly is None:
                raise ValueError(
                    "distribution_drift rules need the drift engine: "
                    "construct with TorchMetricSystem(retention=True, "
                    "anomaly=AnomalyConfig(...))"
                )
            rule.bind(self.anomaly)
        self.rule_engine.add(rule)
        self.rule_engine.register_gauges(self)
        return rule

    def subscribe_to_alerts(self, ch: Channel) -> None:
        self._require_retention()
        self.rule_engine.subscribe(ch)

    def unsubscribe_from_alerts(self, ch: Channel) -> None:
        if self.rule_engine is not None:
            self.rule_engine.unsubscribe(ch)

    def backfill_retention(self, intervals: Iterable[RawMetricSet]) -> int:
        """Replay recorded intervals (offline reconstruction of window
        state); returns the number pushed.  With a fused committer the
        replay runs through it, so the aggregator, lifecycle activity and
        drift baselines rebuild with the wheel."""
        self._require_retention()
        if self.committer is not None:
            n = 0
            for raw in intervals:
                self.committer.commit(raw)
                n += 1
            return n
        return self.retention.backfill(intervals)

    # ------------------------------------------------------------------ #

    def start(self) -> None:
        """Re-attach the bridges a previous stop() detached, then start
        the reaper."""
        self._attach_bridges()
        super().start()

    def stop(self) -> None:
        """Stop the reaper, then detach the bridges (each takes every
        interval already broadcast), drain the transfer worker, and
        re-raise the first bridge failure."""
        super().stop()
        errors = []
        parts = ((self.committer,) if self.committer is not None
                 else (self.aggregator, self.retention))
        for part in parts:
            if part is None:
                continue
            try:
                part.detach()
            except RuntimeError as e:
                errors.append(e)
        self.aggregator.close()
        if errors:
            raise errors[0]
