"""Pipeline health watchdog (counterpart of ``loghisto_tpu/obs/health.py``).

The watchdog rides the committer bridge thread — ``note_commit()`` is
one monotonic-clock store per interval — but all *evaluation* happens
lazily at read time (``report()``), on whichever thread asks: the
``/healthz`` HTTP handler, the reaper collecting ``health.*`` gauges,
or ``debug_dump()``.  That split matters: a wedged bridge thread can
never wedge its own detector, because the detector is the absence of
``note_commit`` observed from a live reader.

Invariants evaluated (each yields a machine-readable reason dict
``{"code", "detail", "value"}``):

  * ``no_commit``            — no committed interval for more than
    ``stall_intervals`` × interval (STALLED: the pipeline's heartbeat).
  * ``ingest_backpressure``  — host-side pending samples (staging
    buffers + requeues) at ≥ ``backpressure_fraction`` of the
    aggregator's admission cap; ingest is about to shed.
  * ``transfer_drain_lag``   — samples sitting in the transfer-worker
    queue at ≥ the same high-water fraction: the worker is alive but
    not draining (or dead with work enqueued).
  * ``fused_degraded``       — intervals taking the fan-out scatter
    instead of the single fused dispatch, with the resolved-path
    ``mesh_commit_incapability`` reason when the degradation was
    decided at construction, or the runtime cause (spill envelope /
    device-failure rebuild) when it was not.
  * ``subscriber_evictions`` — the committer's own bridge subscription
    (or any subscriber) was strike-evicted recently; data holes follow.
  * ``device_cooldown``      — the aggregator is inside its
    device-failure retry cooldown, replaying/rebuilding device state.
  * ``thread_restarted``     — a supervised pipeline thread crashed and
    was restarted with backoff (latched one stall window).
  * ``breaker_open``         — the device circuit breaker is open or
    half-open; intervals take the pinned fan-out/spill path.
  * ``recovery_in_progress`` — checkpoint restore + journal replay is
    rebuilding state after a crash.
  * ``emitter_starvation``   — the federation receiver expects emitters
    (configured count, or it has heard from some already) but no frame
    has arrived for more than its starvation window; the fan-in tier is
    dark while the pod looks otherwise healthy.
  * ``fed_decode_errors``    — a federation frame failed CRC/schema
    validation (or tore at connection EOF) recently; corrupt deltas are
    dropped, never merged (latched one stall window).
  * ``fleet_freshness_stall`` — federation frames were applied but
    their samples have not become queryable for more than the stall
    window: the fan-in tier ingests while the commit path starves it
    of publishes.
  * ``emitter_clock_skew``   — an emitter's wall clock diverged from
    its monotonic clock past the tolerance since its anchor (NTP step,
    VM pause, or an injected ``clock_step``); per-emitter lag stays
    correct (monotonic-only) but wall-aligned trace merges and
    wall-stamped logs from that emitter are suspect.
  * ``pool_saturation``      — a paged aggregator's fullest per-shard
    page arena is at ≥ ``pool_saturation_fraction`` of its capacity;
    the next page allocation in that shard spills to the host fold.
    Per-shard, not pod-wide: one hot metric shard
    saturates alone while the mesh average still looks roomy.

``no_commit`` makes the report STALLED; every other reason makes it
DEGRADED; otherwise OK.  Event-shaped invariants (fan-outs, evictions)
latch for one stall window so a scrape can't straddle the instant and
miss them.

In the port the watchdog reads one rank's pipeline.  A paged store has
one arena a metric shard (``PagedStore.shard_occupancy()`` is a list of
one on one card, of ``n_metric`` on a mesh, ROADMAP D12); the free
stacks are host state, the same on every rank, so every rank's
``pool_saturation`` names the same hottest shard.
``TorchMetricSystem(resilience=...)`` passes its supervisor, breaker and
recovery manager, and ``device_cooldown`` reads the aggregator's
``_device_down_until``, which its device-failure handler arms.
``TorchMetricSystem(federation=...)`` passes its receiver with the
config's starvation intervals and skew tolerance, so the four fleet
invariants (``emitter_starvation``, ``fed_decode_errors``,
``fleet_freshness_stall``, ``emitter_clock_skew``) fire through the
system; without a federation tier the receiver is ``None`` and they
never do.

Two invariants are the port's own, as their causes are (ROADMAP D9: on
a mesh the bridge queues each interval for the rank's next collective
call; D12: a paged mesh rank stages its input for the same call):

  * ``commit_backlog``       — at least ``stall_intervals`` intervals
    wait in the mesh bridge's queue (the committer's, or the wheel's on
    the fan-out path): their samples sit on the host, not yet queryable,
    until the rank calls ``query``, ``device_metrics`` or
    ``backfill_retention``.  Off a mesh the queue does not exist and the
    reason never fires; it has no gauge, so the gauge family stays the
    reference's.
  * ``stage_backlog``        — a paged mesh rank's host stage (its
    stream row's samples and cells, ``staged_samples``) is at
    ``backpressure_fraction`` or more of ``max_staged_samples``, past
    which ``record_batch`` refuses batches until a collective call lands
    the stage.  Off a paged mesh the stage does not exist and the reason
    never fires; its gauge is ``tpu.MeshStagedSamples``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

STATUS_OK = "ok"
STATUS_DEGRADED = "degraded"
STATUS_STALLED = "stalled"

_STATUS_CODE = {STATUS_OK: 0.0, STATUS_DEGRADED: 1.0, STATUS_STALLED: 2.0}


@dataclasses.dataclass(frozen=True)
class HealthReport:
    """One evaluation of the pipeline invariants.  ``status`` is
    ok/degraded/stalled; ``reasons`` carry machine-readable dicts
    (``code`` is stable API, ``detail`` is for humans, ``value`` is the
    measured quantity that tripped the invariant)."""

    status: str
    reasons: List[dict]
    last_commit_age_s: float
    last_seq: int
    intervals_committed: int

    @property
    def ok(self) -> bool:
        return self.status == STATUS_OK

    def reason_codes(self) -> List[str]:
        return [r["code"] for r in self.reasons]

    def as_dict(self) -> dict:
        return {
            "status": self.status,
            "ok": self.ok,
            "reasons": self.reasons,
            "last_commit_age_s": round(self.last_commit_age_s, 6),
            "last_seq": self.last_seq,
            "intervals_committed": self.intervals_committed,
        }


class HealthWatchdog:
    """Lazy-evaluating invariant monitor over one committer/aggregator
    pair — see the module docstring for the invariant list."""

    def __init__(
        self,
        committer,
        aggregator,
        interval: float,
        stall_intervals: float = 3.0,
        backpressure_fraction: float = 0.8,
        commit_path: Optional[str] = None,
        commit_path_reason: Optional[str] = None,
        wheel=None,
        supervisor=None,
        breaker=None,
        recovery=None,
        federation=None,
        federation_starvation_intervals: float = 3.0,
        federation_skew_tolerance_s: float = 1.0,
        pool_saturation_fraction: float = 0.9,
    ):
        self._committer = committer
        self._agg = aggregator
        self._wheel = wheel
        # resilience: restart ledger, device circuit breaker,
        # recovery manager — each optional, each adds one invariant
        self._supervisor = supervisor
        self._breaker = breaker
        self._recovery = recovery
        # federation: receiver fan-in starvation + decode
        # integrity, both read lazily off the receiver's counters
        self._federation = federation
        self.federation_starvation_intervals = float(
            federation_starvation_intervals
        )
        self.federation_skew_tolerance_s = float(federation_skew_tolerance_s)
        self.pool_saturation_fraction = float(pool_saturation_fraction)
        self.interval = float(interval)
        self.stall_intervals = float(stall_intervals)
        self.backpressure_fraction = float(backpressure_fraction)
        # resolved at system construction: "fused"/"fanout" and, for
        # fanout, the mesh_commit_incapability(...) string explaining it
        self.commit_path = commit_path
        self.commit_path_reason = commit_path_reason

        now = time.monotonic()
        self._born = now
        self._last_commit_t = now  # armed: silence from t0 counts
        self._last_seq = 0
        # event latches: a fan-out or an eviction stays visible for one
        # stall window after it happens, so scrapes can't miss it
        self._fanout_seen = int(getattr(committer, "fanout_intervals", 0))
        self._fanout_until = 0.0
        self._ev_seen = int(getattr(committer, "bridge_evictions", 0))
        self._ev_until = 0.0
        self._restarts_seen = int(
            getattr(supervisor, "total_restarts", 0) or 0
        )
        self._restarts_until = 0.0
        self._fed_errs_seen = int(
            getattr(federation, "decode_errors", 0) or 0
        )
        self._fed_errs_until = 0.0
        # fan-out systems have no committer calling note_commit; fall
        # back to observing the wheel's interval counter at read time
        self._pushed_seen = int(getattr(wheel, "intervals_pushed", 0) or 0)

    # -- bridge-thread hook (the only hot-path cost) -------------------- #

    def note_commit(self, seq: int) -> None:
        self._last_commit_t = time.monotonic()
        self._last_seq = int(seq)

    # -- lazy evaluation ------------------------------------------------- #

    @property
    def _latch_window(self) -> float:
        return self.stall_intervals * self.interval

    def report(self) -> HealthReport:
        now = time.monotonic()
        com, agg = self._committer, self._agg
        reasons: List[dict] = []
        stalled = False

        if self._wheel is not None:
            # intervals landed without a note_commit (fan-out bridges):
            # the wheel's counter moving is a liveness signal too
            pushed = int(getattr(self._wheel, "intervals_pushed", 0) or 0)
            if pushed > self._pushed_seen:
                self._pushed_seen = pushed
                self._last_commit_t = max(self._last_commit_t, now)
        age = now - self._last_commit_t
        threshold = self.stall_intervals * self.interval
        if age > threshold:
            stalled = True
            reasons.append({
                "code": "no_commit",
                "detail": (
                    f"no committed interval for {age:.3f}s "
                    f"(> {self.stall_intervals:g} x {self.interval:g}s "
                    "interval)"
                ),
                "value": age,
            })

        cap = float(getattr(agg, "max_pending_samples", 0) or 0)
        high_water = self.backpressure_fraction * cap
        pending = float(getattr(agg, "pending_samples", 0) or 0)
        if cap and pending >= high_water:
            reasons.append({
                "code": "ingest_backpressure",
                "detail": (
                    f"{int(pending)} pending host samples at "
                    f">= {self.backpressure_fraction:g} of the "
                    f"{int(cap)}-sample admission cap; shedding is next"
                ),
                "value": pending,
            })

        queued = float(getattr(agg, "_xfer_queued_samples", 0) or 0)
        if cap and queued >= high_water:
            reasons.append({
                "code": "transfer_drain_lag",
                "detail": (
                    f"{int(queued)} samples enqueued to the transfer "
                    "worker and not draining (high-water "
                    f"{int(high_water)})"
                ),
                "value": queued,
            })

        fanouts = int(getattr(com, "fanout_intervals", 0))
        if fanouts > self._fanout_seen:
            self._fanout_seen = fanouts
            self._fanout_until = now + self._latch_window
        if (now < self._fanout_until) or self.commit_path == "fanout":
            if self.commit_path == "fanout":
                detail = (
                    "commit path resolved to fan-out at construction: "
                    f"{self.commit_path_reason or 'unspecified'}"
                )
            else:
                detail = (
                    "interval(s) fell back from the fused single "
                    "dispatch to the fan-out scatter (int32 spill "
                    "envelope or device-failure rebuild)"
                )
            reasons.append({
                "code": "fused_degraded",
                "detail": detail,
                "value": float(fanouts),
            })

        evictions = int(getattr(com, "bridge_evictions", 0))
        if evictions > self._ev_seen:
            self._ev_seen = evictions
            self._ev_until = now + self._latch_window
        if now < self._ev_until:
            reasons.append({
                "code": "subscriber_evictions",
                "detail": (
                    "a pipeline subscription was strike-evicted for "
                    "not draining; intervals were dropped for that "
                    "consumer until it resubscribed"
                ),
                "value": float(evictions),
            })

        if self._supervisor is not None:
            # event latch like fan-outs/evictions: a restart stays
            # visible for one stall window
            restarts = int(self._supervisor.total_restarts)
            if restarts > self._restarts_seen:
                self._restarts_seen = restarts
                self._restarts_until = now + self._latch_window
            if now < self._restarts_until:
                reasons.append({
                    "code": "thread_restarted",
                    "detail": (
                        "a supervised pipeline thread crashed and was "
                        "restarted with backoff "
                        f"({dict(self._supervisor.restarts_by_name)})"
                    ),
                    "value": float(restarts),
                })

        if self._breaker is not None and self._breaker.state != "closed":
            # live state, not a latch: the breaker holds open/half-open
            # on its own clock until a trial dispatch succeeds
            reasons.append({
                "code": "breaker_open",
                "detail": (
                    f"device circuit breaker is {self._breaker.state} "
                    f"after {self._breaker.failures_total} failure(s); "
                    "intervals take the pinned fan-out/spill path"
                ),
                "value": float(self._breaker.opened_total),
            })

        if self._recovery is not None and self._recovery.in_progress:
            reasons.append({
                "code": "recovery_in_progress",
                "detail": (
                    "checkpoint restore + journal replay is rebuilding "
                    "pipeline state; queries may see partial history"
                ),
                "value": 1.0,
            })

        fed = self._federation
        if fed is not None:
            # starvation: the receiver is live, emitters are expected
            # (configured, or some already spoke), yet no frame for more
            # than the starvation window — the fan-in tier went dark
            expecting = (
                int(getattr(fed, "expected_emitters", 0) or 0) > 0
                or int(getattr(fed, "frames_received", 0) or 0) > 0
            )
            starve_after = (
                self.federation_starvation_intervals * self.interval
            )
            fed_age = fed.last_frame_age_s()
            if (
                expecting
                and getattr(fed, "_started_t", None) is not None
                and fed_age > starve_after
            ):
                reasons.append({
                    "code": "emitter_starvation",
                    "detail": (
                        f"no federation frame for {fed_age:.3f}s "
                        f"(> {self.federation_starvation_intervals:g} x "
                        f"{self.interval:g}s) with "
                        f"{len(fed.emitters)} emitter(s) seen of "
                        f"{fed.expected_emitters} expected"
                    ),
                    "value": fed_age,
                })
            # decode errors latch for one stall window like the other
            # event-shaped invariants
            fed_errs = int(getattr(fed, "decode_errors", 0) or 0)
            if fed_errs > self._fed_errs_seen:
                self._fed_errs_seen = fed_errs
                self._fed_errs_until = now + self._latch_window
            if now < self._fed_errs_until:
                reasons.append({
                    "code": "fed_decode_errors",
                    "detail": (
                        "federation frame(s) failed CRC/schema "
                        "validation or tore at connection EOF; the "
                        "corrupt deltas were dropped, not merged"
                    ),
                    "value": float(fed_errs),
                })
            # freshness stall: frames applied, nothing published since
            pending_age = getattr(fed, "oldest_pending_age_s", None)
            if pending_age is not None:
                pend_s = float(pending_age())
                if pend_s > self._latch_window:
                    reasons.append({
                        "code": "fleet_freshness_stall",
                        "detail": (
                            "federation frame(s) applied "
                            f"{pend_s:.3f}s ago are still not "
                            "queryable (> "
                            f"{self.stall_intervals:g} x "
                            f"{self.interval:g}s); the commit path is "
                            "starving the fan-in tier of publishes"
                        ),
                        "value": pend_s,
                    })
            # clock skew: live state off the per-emitter anchors, not a
            # latch — skew persists until the emitter re-anchors
            skew_f = getattr(fed, "max_emitter_skew_s", None)
            if skew_f is not None:
                skew_s = float(skew_f())
                if skew_s > self.federation_skew_tolerance_s:
                    reasons.append({
                        "code": "emitter_clock_skew",
                        "detail": (
                            "an emitter's wall clock diverged "
                            f"{skew_s:.3f}s from its monotonic clock "
                            "since anchor (> "
                            f"{self.federation_skew_tolerance_s:g}s "
                            "tolerance); its wall-stamped data is "
                            "suspect"
                        ),
                        "value": skew_s,
                    })

        paged = getattr(agg, "paged", None)
        if paged is not None:
            # live state, not a latch: saturation persists until evict/
            # compact/grow returns pages to the hot shard's free list.
            # pool_saturation() is the MAX per-shard occupancy fraction
            # — the spill decision is shard-local, so the pod-wide
            # average hides the shard that is actually about to spill
            sat = float(paged.pool_saturation())
            if sat >= self.pool_saturation_fraction:
                occ = paged.shard_occupancy()
                hot = max(range(len(occ)), key=occ.__getitem__)
                reasons.append({
                    "code": "pool_saturation",
                    "detail": (
                        f"page-pool shard {hot} is {sat:.1%} full "
                        f"(>= {self.pool_saturation_fraction:g} of its "
                        f"{paged.shard_pages - 1}-page arena); its next "
                        "page allocation spills to the host fold — "
                        "evict, compact, or grow"
                    ),
                    "value": sat,
                })

        stage_cap = float(getattr(agg, "max_staged_samples", 0) or 0)
        staged = float(getattr(agg, "staged_samples", 0) or 0)
        if stage_cap and staged >= self.backpressure_fraction * stage_cap:
            reasons.append({
                "code": "stage_backlog",
                "detail": (
                    f"{int(staged)} samples staged on the host for the "
                    "next collective call (collect, a commit, a query) "
                    f"at >= {self.backpressure_fraction:g} of the "
                    f"{int(stage_cap)}-sample stage cap; record_batch "
                    "refuses past it"
                ),
                "value": staged,
            })

        backlog = sum(int(getattr(part, "queued_intervals", 0) or 0)
                      for part in (com, self._wheel) if part is not None)
        if backlog >= self.stall_intervals:
            reasons.append({
                "code": "commit_backlog",
                "detail": (
                    f"{backlog} intervals queued on the host for the "
                    "next collective call (query, device_metrics, "
                    "backfill_retention); not yet queryable"
                ),
                "value": float(backlog),
            })

        down_until = float(getattr(agg, "_device_down_until", 0.0) or 0.0)
        if down_until > now:
            reasons.append({
                "code": "device_cooldown",
                "detail": (
                    "aggregator is inside its device-failure retry "
                    f"cooldown for another {down_until - now:.3f}s; "
                    "device state is being rebuilt from host buffers"
                ),
                "value": down_until - now,
            })

        status = (
            STATUS_STALLED if stalled
            else STATUS_DEGRADED if reasons
            else STATUS_OK
        )
        return HealthReport(
            status=status,
            reasons=reasons,
            last_commit_age_s=age,
            last_seq=self._last_seq,
            intervals_committed=int(
                getattr(com, "intervals_committed", 0)
            ),
        )

    # -- exporter integration ------------------------------------------- #

    def register_gauges(self, ms) -> None:
        """``health.Status`` (0 ok / 1 degraded / 2 stalled) plus one
        0/1 gauge per invariant — a dashboard can alert on any reason
        without parsing ``/healthz``."""
        ms.register_gauge_func(
            "health.Status",
            lambda: _STATUS_CODE[self.report().status],
        )
        ms.register_gauge_func(
            "health.LastCommitAgeS",
            lambda: self.report().last_commit_age_s,
        )
        for code in ("no_commit", "ingest_backpressure",
                     "transfer_drain_lag", "fused_degraded",
                     "subscriber_evictions", "device_cooldown",
                     "thread_restarted", "breaker_open",
                     "recovery_in_progress", "emitter_starvation",
                     "fed_decode_errors", "fleet_freshness_stall",
                     "emitter_clock_skew", "pool_saturation"):
            ms.register_gauge_func(
                f"health.{code}",
                lambda c=code: float(c in self.report().reason_codes()),
            )
