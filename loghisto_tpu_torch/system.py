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

The interval commit is the fan-out path: the aggregator's bridge
(``merge_raw``, K3) and the wheel's bridge (tier scatter K3, snapshot
K5).  ``commit="auto"`` resolves to it until the fused committer is
ported (ROADMAP D3).  ``stop()`` stops the reaper first, lets both
bridges take every interval already broadcast, then re-raises the first
bridge failure, if any.

Entry point rule: ``device`` defaults to the card and raises without
CUDA; ``device="cpu"`` runs the plain versions.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional, Sequence

import numpy as np

from loghisto_tpu_torch.channel import Channel
from loghisto_tpu_torch.config import DEFAULT_PERCENTILES, MetricConfig
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
        device=None,
    ):
        """``retention``: ``True`` builds a TimeWheel with the default
        60x1 / 60x60 / 24x3600 tiers, a sequence of ``(slots, res)``
        pairs one with those tiers, and a ``TimeWheel`` is attached as it
        is (it must share this system's registry).  ``commit``,
        ``transport``, ``storage`` and ``paged_config`` mean what they
        mean for ``TPUMetricSystem``; ``commit`` resolves to "fanout"."""
        self.device = resolve_device(device)
        self.commit_path = resolve_commit_path(commit)
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
            self.rule_engine = RuleEngine(self.retention)
            self.rule_engine.attach()
            self.retention.register_query_gauges(self)
        self._attach_bridges()

    def _attach_bridges(self) -> None:
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
        ``TimeWheel.query``)."""
        return self._require_retention().query(
            pattern, window, percentiles, tier
        )

    def window_rate(self, name: str, window: float) -> float:
        """Counter rate (events/s) over the trailing window."""
        return self._require_retention().window_rate(name, window)

    def add_rule(self, rule):
        """Register an alerting rule (window.rules.*Rule), evaluated
        after every interval; its state gauges join this system's."""
        self._require_retention()
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
        """Replay recorded intervals into the retention wheel (offline
        reconstruction of window state); returns the number pushed."""
        return self._require_retention().backfill(intervals)

    # ------------------------------------------------------------------ #

    def start(self) -> None:
        """Re-attach the bridges a previous stop() detached, then start
        the reaper."""
        self._attach_bridges()
        super().start()

    def stop(self) -> None:
        """Stop the reaper, then detach both bridges (each takes every
        interval already broadcast), drain the transfer worker, and
        re-raise the first bridge failure."""
        super().stop()
        errors = []
        for part in (self.aggregator, self.retention):
            if part is None:
                continue
            try:
                part.detach()
            except RuntimeError as e:
                errors.append(e)
        self.aggregator.close()
        if errors:
            raise errors[0]
