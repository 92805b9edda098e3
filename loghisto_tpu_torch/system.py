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

With retention, ``commit="auto"`` resolves to the fused
``IntervalCommitter`` (``commit.py``): one bridge lands each interval on
the accumulator — on paged storage the page pool, K4 — and every tier
(K3), publishes the snapshot (K5) and carries the lifecycle and drift
engines:

    ms = TorchMetricSystem(retention=True,
                           lifecycle=LifecycleConfig(ttl_intervals=60),
                           anomaly=AnomalyConfig(banks=24,
                                                 bank_of=hourly_bank))
    ms.add_rule(DistributionDriftRule("lat_shape", "rpc_latency"))

``lifecycle=`` evicts idle or over-budget series into count-exact
overflow rows and repacks the rows (K6); ``anomaly=`` keeps EWMA
baseline banks and scores every row's window against them (K7).  Both
need the fused commit, and the drift engine dense storage (its carries
are dense ``[M, B]`` tensors).  On paged storage — "auto" at 2^16 rows
and more — lifecycle folds and permutes the pool through ``PagedStore``:

    ms = TorchMetricSystem(num_metrics=1 << 16, retention=((8, 1), (4, 8)),
                           lifecycle=LifecycleConfig(ttl_intervals=2))

``commit="fanout"`` and a system without retention commit through the
aggregator's bridge (``merge_raw``) and the wheel's (``push``).
``stop()`` stops the reaper first, lets the bridges take every interval
already broadcast, then re-raises the first bridge failure, if any.

``observability=True`` (or an ``ObsConfig``) hands one span ring to
every stage (the reaper's broadcast, the aggregator's flush, drain,
upload and dispatch, the committer's stages, the wheel's pushes, hooks
and serves, the lifecycle tick and drift scoring), re-ingests the spans
as ``obs.<stage>.LatencyUs`` histograms, and attaches the
``HealthWatchdog`` that ``/healthz`` serves:

    ms = TorchMetricSystem(retention=True, observability=True)
    ms.health.report()                      # ok / degraded / stalled
    dump_perfetto(ms.obs, "trace.json")     # the span ring, for Perfetto
    ms.debug_dump()                         # one introspection snapshot

``resilience=True`` (or a ``ResilienceConfig``) supervises the reaper
and the bridges, guards the fused commit with a circuit breaker, and
with a checkpoint and a journal path makes a crash lose at most one
interval:

    ms = TorchMetricSystem(retention=True, resilience=ResilienceConfig(
        checkpoint_path="state.npz", journal_path="intervals.jsonl"))
    ms.start()        # recovers first (recover_on_start)
    ms.recover()      # or by hand: restore + replay past the watermark

``federation=FederationConfig(...)`` (or ``True``) makes the system the
aggregator host of a federation tier: a ``FederationReceiver`` over the
system's aggregator takes frames from ``FederationEmitter``s in other
processes (merges: K3, on paged storage K4), frames' freshness completes
when the commit publishes their interval, ``/fleetz`` serves the fleet
report, the watchdog gains the fleet invariants, and
``FreshnessSloRule``s bind to the receiver:

    ms = TorchMetricSystem(retention=True, observability=True,
                           federation=FederationConfig(expected_emitters=8))
    ms.start()                               # ms.federation.port
    ms.add_rule(FreshnessSloRule("fresh", budget_us=2e6))

``mesh=make_mesh(stream, metric)`` (``parallel/mesh.py``, ROADMAP D8
and D9) makes the system one rank of a mesh, one process per device:
the aggregator and the wheel hold the rank's metric-row blocks, the
rank records its stream row's samples, and "auto" resolves the sharded
fused commit (or the fan-out, with the reference's reason in
``commit_path_reason``, where ``mesh_commit_incapability`` names one):

    multihost.initialize("tcp://host:port", world, rank)
    ms = TorchMetricSystem(mesh=make_mesh(2, 1), retention=True)
    ms.query("rpc_latency", window=300)     # collective: every rank calls

On a mesh ``device_metrics()``, ``backfill_retention`` and the window
queries (``query``, ``query_window``, ``query_group_by``,
``window_rate``) are collective calls that every rank makes in the same
order; each first commits the intervals the bridge queued.  With
``lifecycle=`` and ``anomaly=`` (ROADMAP D10, item 11b-2) the drift
scoring and the lifecycle tick after each commit are collectives too,
and so are ``lifecycle.check()``, ``evict_ids``, ``compact()`` and
``anomaly.score_now()`` when called by hand.  With ``resilience=
ResilienceConfig(checkpoint_path=, journal_path=)`` (ROADMAP D11, item
11b-3) the cadenced checkpoint after a commit, ``recover()`` (and so
``start()`` with ``recover_on_start``) and ``stop()``'s final
checkpoint are collectives too; rank (0, 0) writes the checkpoint, each
stream row's rank at metric index 0 its row's journal
(``<journal_path>.row<s>of<n>``), and a crash on one mesh shape
recovers onto any other, or onto one device, with no option.

Paged storage on a mesh (``storage="paged"``, or an "auto" that
resolves to it; ROADMAP D12, item 11c-1): each rank's store holds its
metric shard's page arena and the whole host page table; the
aggregator stages the rank's samples on the host, and the collective
calls above (and ``stop()``) land them first; the committer commits the
stream rows' merged interval on every rank (K4 into the arena, K3 into
the ring blocks, K5 views).  ``lifecycle=`` and ``resilience=`` run on
a paged mesh as on dense storage (ROADMAP D13: eviction and compaction
across the ranks' arenas, K6 over the ring blocks, saves and restores of
the arenas, ``recover()`` onto any shape or one device); ``anomaly=``
keeps the reference's dense-only refusal.

Entry point rule: ``device`` defaults to the card and raises without
CUDA; ``device="cpu"`` runs the plain versions (a mesh's device type is
its ranks' device).
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional, Sequence

import numpy as np

from loghisto_tpu_torch.anomaly import AnomalyManager
from loghisto_tpu_torch.channel import Channel
from loghisto_tpu_torch.commit import IntervalCommitter, \
    commit_incompatibility
from loghisto_tpu_torch.config import DEFAULT_PERCENTILES, MetricConfig
from loghisto_tpu_torch.federation import FederationConfig
from loghisto_tpu_torch.federation.receiver import FederationReceiver
from loghisto_tpu_torch.labels import LabelIndex
from loghisto_tpu_torch.lifecycle import LifecycleManager
from loghisto_tpu_torch.metrics import MetricSystem, ProcessedMetricSet, \
    RawMetricSet
from loghisto_tpu_torch.obs import (
    HealthWatchdog,
    ObsConfig,
    SelfObserver,
    SpanRecorder,
)
from loghisto_tpu_torch.ops import dispatch
from loghisto_tpu_torch.ops.backend import resolve_device
from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
from loghisto_tpu_torch.parallel.mesh import axis_size
from loghisto_tpu_torch.resilience import (
    CircuitBreaker,
    RecoveryManager,
    ResilienceConfig,
    ThreadSupervisor,
    register_resilience_gauges,
)
from loghisto_tpu_torch.window import (
    DEFAULT_TIERS,
    RuleEngine,
    TimeWheel,
)


def _mesh_shape(mesh) -> Optional[dict]:
    """``{"stream": s, "metric": m}`` of a mesh (the reference's
    ``debug_dump()["mesh"]``), or None."""
    if mesh is None:
        return None
    return {axis: axis_size(mesh, axis) for axis in mesh.mesh_dim_names}


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
        native_staging: bool = False,
        fast_ingest: bool = False,
        observability=None,
        resilience=None,
        federation=None,
        device=None,
        mesh=None,
    ):
        """``retention``: ``True`` builds a TimeWheel with the default
        60x1 / 60x60 / 24x3600 tiers, a sequence of ``(slots, res)``
        pairs one with those tiers, and a ``TimeWheel`` is attached as it
        is (it must share this system's registry).  ``commit``,
        ``transport``, ``storage``, ``paged_config``, ``lifecycle`` (a
        ``LifecycleConfig``), ``anomaly`` (an ``AnomalyConfig``),
        ``native_staging`` (the aggregator's native staging buffer),
        ``fast_ingest`` (the host tier's C staging buffers) and
        ``observability`` (``True`` or an ``ObsConfig``: the span ring,
        the self-observer and the watchdog) and ``resilience`` (``True``
        or a ``ResilienceConfig``: supervision, the breaker, fault
        injection, checkpoints and the journal) mean what they mean for
        ``TPUMetricSystem``.

        ``federation`` takes a ``federation.FederationConfig`` (or
        ``True`` for the defaults) and turns this system into the
        aggregator host of a federation tier: a TCP
        ``FederationReceiver`` listens on ``(host, port)`` (port 0 binds
        an ephemeral one, read back from ``ms.federation.port``) for
        framed packed-triple deltas from ``FederationEmitter``s running
        in other processes, interns their metric names through this
        system's registry, deduplicates frames by per-emitter sequence
        number, and drains the triples into the aggregator
        (``merge_packed``) — so the federated aggregate equals a single
        process recording everything.  The accept/decode threads run
        supervised when ``resilience`` is on, ``federation.*`` gauges
        ride every exporter, frames' freshness completes when the
        commit publishes their interval, and with ``observability`` the
        health report gains the ``emitter_starvation`` /
        ``fed_decode_errors`` / ``fleet_freshness_stall`` /
        ``emitter_clock_skew`` invariants.

        ``mesh`` (a ("stream", "metric") mesh from
        ``parallel.mesh.make_mesh``) goes to the aggregator and the wheel,
        as in the reference; see the module docstring for the collective
        calls."""
        if mesh is not None and device is None:
            device = mesh.device_type
        self.device = resolve_device(device)
        super().__init__(interval=interval, sys_stats=sys_stats,
                         config=config, fast_ingest=fast_ingest)
        # resilience first, so every component below is built wired
        self.resilience: Optional[ResilienceConfig] = None
        self.fault_injector = None
        self.supervisor = None     # the reaper's start() reads it
        self.device_breaker = None
        self.recovery: Optional[RecoveryManager] = None
        self._recovered = False
        if resilience is not None and resilience is not False:
            rcfg = ResilienceConfig() if resilience is True else resilience
            self.resilience = rcfg
            self.fault_injector = rcfg.fault_injector
            if rcfg.supervise:
                self.supervisor = ThreadSupervisor(
                    base_backoff_s=rcfg.restart_backoff_s,
                    max_backoff_s=rcfg.restart_backoff_cap_s,
                )
            self.device_breaker = CircuitBreaker(
                threshold=rcfg.breaker_threshold,
                window_s=rcfg.breaker_window_s,
                open_s=rcfg.breaker_open_s,
            )
        self.aggregator = TorchAggregator(
            num_metrics=num_metrics,
            config=config,
            percentiles=percentiles,
            transport=transport,
            storage=storage,
            paged_config=paged_config,
            device=self.device,
            native_staging=native_staging,
            mesh=mesh,
        )
        self.aggregator.register_device_gauges(self)
        if self.resilience is not None:
            # before any attach: the bridges spawn supervised
            self.aggregator.supervisor = self.supervisor
            self.aggregator.device_breaker = self.device_breaker
            self.aggregator.fault_injector = self.fault_injector
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
                    mesh=mesh,
                )
            self.retention.label_index = self.label_index
            if self.resilience is not None:
                self.retention.supervisor = self.supervisor
                self.retention.fault_injector = self.fault_injector
            self.rule_engine = RuleEngine(self.retention)
            self.rule_engine.attach()
            self.retention.register_query_gauges(self)
        self.commit_path = dispatch.resolve_commit_path(
            commit, mesh=mesh,
            num_metrics=self.aggregator.num_metrics,
        )
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
        if self.resilience is not None:
            self._build_recovery()
        # after resilience (the receiver's threads run under the
        # supervisor, its fault sites on the injector), before
        # observability (the span ring and the watchdog take it)
        self.federation: Optional[FederationReceiver] = None
        self.federation_config: Optional[FederationConfig] = None
        if federation is not None and federation is not False:
            self._build_federation(federation)
        # the commit path's degradation reason, from the mesh
        self.commit_path_reason: Optional[str] = (
            dispatch.mesh_commit_incapability(
                mesh, num_metrics=self.aggregator.num_metrics)
            if mesh is not None and self.commit_path != "fused" else None
        )
        self.obs = None            # the SpanRecorder (None when off)
        self.obs_config = None
        self.health = None         # the HealthWatchdog (None when off)
        self.self_observer = None
        if observability is not None and observability is not False:
            self._build_observability(observability)
        self._attach_bridges()

    def _build_observability(self, observability) -> None:
        """One span ring for every site, the ``obs.SpansDropped`` gauge,
        and with ``dogfood`` the self-observer, with ``health`` the
        watchdog and its ``health.*`` gauges."""
        cfg = ObsConfig() if observability is True else observability
        self.obs_config = cfg
        rec = SpanRecorder(cfg.capacity)
        self.obs = rec
        # the ring wrapped faster than exporters drained it
        self.register_gauge_func("obs.SpansDropped",
                                 lambda: float(rec.dropped))
        self.obs_recorder = rec          # the reaper's broadcast span
        for part in (self.aggregator, self.retention, self.lifecycle,
                     self.anomaly, self.federation, self.committer):
            if part is not None:
                part.obs_recorder = rec
        if self.committer is not None and cfg.dogfood:
            self.self_observer = SelfObserver(self, rec)
            self.committer.self_observer = self.self_observer
        if cfg.health:
            fcfg = self.federation_config
            self.health = HealthWatchdog(
                self.committer, self.aggregator,
                interval=self.interval,
                stall_intervals=cfg.stall_intervals,
                backpressure_fraction=cfg.backpressure_fraction,
                commit_path=self.commit_path,
                commit_path_reason=self.commit_path_reason,
                wheel=self.retention,
                supervisor=self.supervisor,
                breaker=self.device_breaker,
                recovery=self.recovery,
                federation=self.federation,
                federation_starvation_intervals=(
                    fcfg.starvation_intervals if fcfg is not None else 3.0),
                federation_skew_tolerance_s=(
                    fcfg.skew_tolerance_s if fcfg is not None else 1.0),
            )
            if self.committer is not None:
                self.committer.watchdog = self.health
            self.health.register_gauges(self)

    def _build_federation(self, federation) -> None:
        """The receiver over the system's aggregator, its gauges and
        thresholds, and its freshness publisher: the committer's hook,
        or the wheel's interval hook where retention has no committer
        (otherwise frames complete at apply)."""
        fcfg = FederationConfig() if federation is True else federation
        self.federation_config = fcfg
        fed = FederationReceiver(
            self.aggregator,
            host=fcfg.host,
            port=fcfg.port,
            journal_path=fcfg.journal_path,
            replay_on_start=fcfg.replay_on_start,
            expected_emitters=fcfg.expected_emitters,
            supervisor=self.supervisor,
            fault_injector=self.fault_injector,
        )
        self.federation = fed
        fed.register_gauges(self)
        fed.starvation_s = fcfg.starvation_intervals * self.interval
        fed.skew_tolerance_s = fcfg.skew_tolerance_s
        if self.committer is not None:
            self.committer.freshness_hook = fed.note_publish
            fed.has_publisher = True
        elif self.retention is not None:
            self.retention.add_interval_hook(
                lambda raw: fed.note_publish(getattr(raw, "seq", None)))
            fed.has_publisher = True

    def _build_recovery(self) -> None:
        """The committer's breaker, injector and supervisor; with a
        checkpoint or journal path the ``RecoveryManager`` (the
        committer's tail hook, or the wheel's interval hook on the
        fan-out path, drives its cadence); the ``resilience.*`` and
        ``journal.CorruptLines`` gauges."""
        rcfg = self.resilience
        if self.committer is not None:
            self.committer.supervisor = self.supervisor
            self.committer.breaker = self.device_breaker
            self.committer.fault_injector = self.fault_injector
        if rcfg.checkpoint_path is not None or rcfg.journal_path is not None:
            self.recovery = RecoveryManager(
                self,
                aggregator=self.aggregator,
                committer=self.committer,
                lifecycle=self.lifecycle,
                anomaly=self.anomaly,
                checkpoint_path=rcfg.checkpoint_path,
                journal_path=rcfg.journal_path,
                checkpoint_every_intervals=rcfg.checkpoint_every_intervals,
                fault_injector=self.fault_injector,
            )
            if self.committer is not None:
                self.committer.recovery = self.recovery
            elif self.retention is not None:
                self.retention.add_interval_hook(
                    lambda raw, _rec=self.recovery: _rec.on_commit(raw))
        register_resilience_gauges(
            self,
            supervisor=self.supervisor,
            breaker=self.device_breaker,
            recovery=self.recovery,
            injector=self.fault_injector,
        )

    def debug_dump(self) -> dict:
        """One introspection snapshot of the pipeline: registry occupancy
        and free-list depth, the resolved commit path, query and cache
        counters, transfer and staging depths, the span ring's state,
        the resilience ledger (with ``resilience=``), the receiver's
        stats (with ``federation=``) and the current health report (the
        reference's keys; ``mesh`` is ``{"stream": s, "metric": m}`` on a
        mesh, else None; on a mesh also ``queued_intervals``, the depth of
        the bridge's queue).  Pure reads, safe from any thread."""
        agg = self.aggregator
        reg = agg.registry
        dump: dict = {
            "commit_path": self.commit_path,
            "commit_path_reason": self.commit_path_reason,
            "mesh": _mesh_shape(agg.mesh),
            "registry": {
                "capacity": reg.capacity,
                "occupancy": len(reg),
                "free_count": reg.free_count(),
                "generation": reg.generation,
            },
            "rings": {
                "xfer_queued_samples": agg._xfer_queued_samples,
                "pending_samples": agg.pending_samples,
                "max_pending_samples": agg.max_pending_samples,
                "staging_depth": agg.staging_depth,
            },
            "transport": agg.transport_stats(),
        }
        if agg.mesh is not None:
            # the port's own key, on a mesh alone: the intervals the
            # bridge queued for the next collective call (D9), on the
            # host and not yet queryable
            part = self.committer if self.committer is not None \
                else self.retention
            dump["queued_intervals"] = (0 if part is None
                                        else part.queued_intervals)
        wheel = self.retention
        if wheel is not None:
            dump["query"] = {
                "snapshot_hits": wheel.query_snapshot_hits,
                "fallbacks": wheel.query_fallbacks,
                "result_cache_hits": wheel.query_result_cache_hits,
                "rows_fetched": wheel.query_rows_fetched,
                "group_by_serves": wheel.query_group_serves,
                "plan_cache_hits": wheel.plan_cache.hits,
                "plan_cache_misses": wheel.plan_cache.misses,
                "snapshot_age_intervals": wheel.snapshot_age_intervals(),
            }
        labels_dump = self.label_index.stats()
        labels_dump["cardinality_by_prefix"] = (
            self.label_index.cardinality_by_prefix())
        dump["labels"] = labels_dump
        if self.committer is not None:
            dump["commit"] = {
                "intervals_committed": self.committer.intervals_committed,
                "fused_intervals": self.committer.fused_intervals,
                "fanout_intervals": self.committer.fanout_intervals,
                "staging_depth": self.committer._staging.depth,
            }
        rec = self.obs
        dump["obs"] = {
            "enabled": rec is not None,
            "capacity": rec.capacity if rec else 0,
            "recorded": rec.recorded if rec else 0,
            "dropped": rec.dropped if rec else 0,
            "current_seq": rec.current_seq if rec else 0,
            "saturated": (
                bool(rec.recorded >= rec.capacity) if rec else False
            ),
        }
        if self.resilience is not None:
            sup, br = self.supervisor, self.device_breaker
            rec, inj = self.recovery, self.fault_injector
            dump["resilience"] = {
                "thread_restarts": (dict(sup.restarts_by_name)
                                    if sup is not None else {}),
                "breaker_state": br.state if br is not None else None,
                "breaker_opened_total": (br.opened_total
                                         if br is not None else 0),
                "checkpoints_taken": (rec.checkpoints_taken
                                      if rec is not None else 0),
                "checkpoint_errors": (rec.checkpoint_errors
                                      if rec is not None else 0),
                "last_checkpoint_seq": (rec.last_checkpoint_seq
                                        if rec is not None else None),
                "recovery_in_progress": (rec.in_progress
                                         if rec is not None else False),
                "faults_injected": (inj.faults_injected
                                    if inj is not None else 0),
            }
        if self.federation is not None:
            dump["federation"] = self.federation.stats()
        dump["health"] = (
            self.health.report().as_dict() if self.health else None
        )
        return dump

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
        re-raises a failure of the aggregator's bridge.  On a mesh a
        collective call (the queued intervals commit first)."""
        self._drain()
        return self.aggregator.collect(reset=reset)

    def _drain(self) -> None:
        """On a mesh, commit the intervals the committer's bridge queued,
        as many as every rank holds (D9; on the fan-out path the wheel's
        queries push its own queue); nothing off a mesh."""
        if self.committer is not None:
            self.committer.drain()
        # D12: a paged mesh rank's staged batches land (nothing elsewhere)
        self.aggregator.land_staged()

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
        wheel = self._require_retention()
        self._drain()
        return wheel.query(pattern, window, percentiles, tier)

    def query(
        self,
        selector: str = "*",
        window: Optional[float] = None,
        percentiles: Optional[Sequence[float]] = None,
        tier: Optional[int] = None,
    ):
        """Window query by label selector (``rpc.latency{route=/a,
        code=~5..}``) or name glob; the same serve as ``query_window``."""
        wheel = self._require_retention()
        self._drain()
        return wheel.query(selector, window, percentiles, tier)

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
        wheel = self._require_retention()
        self._drain()
        return wheel.query_group_by(
            selector, by, window=window, percentiles=percentiles,
            tier=tier, depth=depth,
        )

    def window_rate(self, name: str, window: float) -> float:
        """Counter rate (events/s) over the trailing window."""
        wheel = self._require_retention()
        self._drain()
        return wheel.window_rate(name, window)

    def add_rule(self, rule):
        """Register an alerting rule (window.rules.*Rule), evaluated
        after every interval; its state gauges join this system's.  A
        ``DistributionDriftRule`` is bound to this system's
        AnomalyManager (needs ``anomaly=``), a ``FreshnessSloRule`` to
        the federation receiver (needs ``federation=``)."""
        self._require_retention()
        if getattr(rule, "kind", None) == "distribution_drift":
            if self.anomaly is None:
                raise ValueError(
                    "distribution_drift rules need the drift engine: "
                    "construct with TorchMetricSystem(retention=True, "
                    "anomaly=AnomalyConfig(...))"
                )
            rule.bind(self.anomaly)
        elif getattr(rule, "kind", None) == "freshness":
            if self.federation is None:
                raise ValueError(
                    "freshness rules read the federation receiver's "
                    "end-to-end latency ledger: construct with "
                    "TorchMetricSystem(federation=FederationConfig(...))"
                )
            rule.bind(self.federation)
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
        drift baselines rebuild with the wheel.  On a mesh a collective
        call: each rank replays its stream row's intervals."""
        self._require_retention()
        if self.committer is not None:
            n = 0
            for raw in intervals:
                self.committer.commit(raw)
                n += 1
            return n
        return self.retention.backfill(intervals)

    # ------------------------------------------------------------------ #

    def recover(self):
        """Restore the latest checkpoint and replay the journal's
        intervals past its seq watermark (``RecoveryManager.recover``):
        at most the interval in flight at a crash is lost.  Returns the
        ``RecoveryReport``.  Runs on the first ``start()`` when
        ``ResilienceConfig.recover_on_start`` is set."""
        if self.recovery is None:
            raise RuntimeError(
                "crash recovery needs a checkpoint/journal path: "
                "construct with TorchMetricSystem(resilience="
                "ResilienceConfig(checkpoint_path=..., journal_path=...))"
            )
        self._recovered = True
        return self.recovery.recover()

    def start(self) -> None:
        """Re-attach the bridges a previous stop() detached, recover
        (the first time, with ``recover_on_start``) and start the
        journal, start the federation receiver, then start the
        reaper."""
        self._attach_bridges()
        if self.recovery is not None:
            # before the reaper mints intervals: the replay runs through
            # the commit path, then the seq counter moves past it
            if self.resilience.recover_on_start and not self._recovered:
                self._recovered = True
                self.recovery.recover()
            self.recovery.start()
        if self.federation is not None:
            # after recovery (a journal replay lands on restored state),
            # before the reaper: federated deltas are ordinary ingest
            self.federation.start()
        super().start()

    def stop(self) -> None:
        """Stop the federation receiver (no new deltas), stop the
        reaper, then detach the bridges (each takes every interval
        already broadcast), on a mesh commit every queued interval (a
        collective: the most any rank holds, D9), drain the transfer
        worker, take the final
        checkpoint (with ``resilience=``), and re-raise the first bridge
        failure."""
        if self.federation is not None:
            self.federation.stop()
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
        if self.aggregator.mesh is not None:
            # the bridges queued, the ranks commit together (D9): the most
            # any rank holds, so no rank's last intervals are left behind
            if self.committer is not None:
                self.committer.drain(final=True)
            elif self.retention is not None:
                self.retention.drain(final=True)
            # D12: a paged mesh rank's staged batches land (a collective)
            self.aggregator.land_staged()
        self.aggregator.close()
        if self.recovery is not None:
            # after the bridges drained: the final checkpoint holds every
            # committed interval, so a clean stop/start replays nothing
            self.recovery.stop(final_checkpoint=True)
        if errors:
            raise errors[0]
