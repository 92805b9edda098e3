"""The port's pipeline watchdog (``loghisto_tpu_torch/obs/health.py``),
``/healthz`` and the paged store's per-shard occupancy against the JAX
package's.

The same fake committer and aggregator, and page stores fed the same
cells, go to both watchdogs, each reading one fake monotonic clock, so
the reports are EQUAL: status, reason codes, values, ages and seqs.  No
test waits on the wall clock: a stall is made by moving the clock (or
``_last_commit_t``) back.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from loghisto_tpu import paging as jpaging
from loghisto_tpu.obs import health as jax_health
from loghisto_tpu_torch import paging
from loghisto_tpu_torch.obs import health as port_health

BL = 512
HEALTH_GAUGES = (
    "health.Status", "health.LastCommitAgeS", "health.no_commit",
    "health.ingest_backpressure", "health.transfer_drain_lag",
    "health.fused_degraded", "health.subscriber_evictions",
    "health.device_cooldown", "health.thread_restarted",
    "health.breaker_open", "health.recovery_in_progress",
    "health.emitter_starvation", "health.fed_decode_errors",
    "health.fleet_freshness_stall", "health.emitter_clock_skew",
    "health.pool_saturation",
)


class _Clock:
    """A monotonic clock the test moves by hand."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


class _FakeCommitter:
    fanout_intervals = 0
    bridge_evictions = 0
    intervals_committed = 0


class _FakeAgg:
    max_pending_samples = 100
    pending_samples = 0
    _xfer_queued_samples = 0
    _device_down_until = 0.0
    paged = None


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    for mod in (jax_health, port_health):
        monkeypatch.setattr(mod, "time", c)
    return c


def _pair(**kw):
    """One fake committer and aggregator, read by both watchdogs."""
    com, agg = _FakeCommitter(), _FakeAgg()
    dogs = [mod.HealthWatchdog(com, agg, **kw)
            for mod in (jax_health, port_health)]
    return com, agg, dogs


def _same(dogs):
    want, got = (d.report() for d in dogs)
    assert got.as_dict() == want.as_dict()
    return got


def test_every_invariant_equals_the_jax_watchdog(clock):
    com, agg, dogs = _pair(interval=0.5, stall_intervals=2.0)
    assert _same(dogs).ok
    clock.t += 1.5
    rep = _same(dogs)
    assert rep.status == "stalled" and rep.reason_codes() == ["no_commit"]
    assert rep.reasons[0]["value"] == 1.5
    for d in dogs:
        d.note_commit(9)
    rep = _same(dogs)
    assert rep.ok and rep.last_seq == 9

    agg.pending_samples = 90        # >= 0.8 x 100
    agg._xfer_queued_samples = 85
    agg._device_down_until = clock.t + 5.0
    com.bridge_evictions = 2
    com.fanout_intervals = 1
    com.intervals_committed = 4
    rep = _same(dogs)
    assert rep.status == "degraded"
    assert rep.reason_codes() == [
        "ingest_backpressure", "transfer_drain_lag", "fused_degraded",
        "subscriber_evictions", "device_cooldown"]
    assert [r["value"] for r in rep.reasons] == [90.0, 85.0, 1.0, 2.0, 5.0]
    agg.pending_samples = agg._xfer_queued_samples = 0
    agg._device_down_until = 0.0
    # the event latches hold one stall window, then clear
    clock.t += 0.9
    for d in dogs:
        d.note_commit(10)
    assert _same(dogs).reason_codes() == ["fused_degraded",
                                          "subscriber_evictions"]
    clock.t += 0.2
    for d in dogs:
        d.note_commit(11)
    assert _same(dogs).ok


def test_construction_fanout_reason_equals_the_jax_watchdog(clock):
    _, _, dogs = _pair(interval=0.5, commit_path="fanout",
                       commit_path_reason="foreign wheel")
    rep = _same(dogs)
    assert rep.status == "degraded"
    (reason,) = rep.reasons
    assert reason["code"] == "fused_degraded"
    assert "foreign wheel" in reason["detail"]


def test_wheel_counter_is_a_liveness_signal(clock):
    class Wheel:
        intervals_pushed = 0

    com, agg = _FakeCommitter(), _FakeAgg()
    wheel = Wheel()
    dogs = [mod.HealthWatchdog(com, agg, interval=1.0, wheel=wheel)
            for mod in (jax_health, port_health)]
    clock.t += 5.0
    assert _same(dogs).status == "stalled"
    wheel.intervals_pushed = 1
    assert _same(dogs).ok


def _stores(pool=64):
    return (
        jpaging.PagedStore(16, BL, config=jpaging.PagedStoreConfig(
            pool_pages=pool), kernel="jnp"),
        paging.PagedStore(16, BL, config=paging.PagedStoreConfig(
            pool_pages=pool), device="cpu"),
    )


def _fill(stores, rows, rng):
    """The same cells translated into both stores (pages map on demand)."""
    packed = np.stack([
        np.repeat(np.asarray(rows, np.int32), 64),
        rng.integers(-BL, BL + 1, 64 * len(rows)).astype(np.int32),
        np.ones(64 * len(rows), np.int32),
    ], axis=1)
    for st in stores:
        st.translate(packed)


def test_shard_occupancy_equals_the_jax_store():
    rng = np.random.default_rng(7)
    jst, pst = _stores()
    assert pst.shard_pages == jst.shard_pages == 64
    assert pst.shard_occupancy() == jst.shard_occupancy() == [0.0]
    for rows in ([0, 1], [2, 3, 4], list(range(5, 12))):
        _fill((jst, pst), rows, rng)
        assert pst.shard_occupancy() == jst.shard_occupancy()
        assert pst.pool_saturation() == jst.pool_saturation()
        assert pst.occupied_pages == jst.occupied_pages


def test_pool_saturation_equals_the_jax_watchdog(clock):
    rng = np.random.default_rng(8)
    stores = _stores()
    row = 0
    while stores[1].pool_saturation() < 0.9:
        _fill(stores, [row], rng)
        row += 1
    com = _FakeCommitter()
    aggs = [_FakeAgg(), _FakeAgg()]
    for agg, st in zip(aggs, stores):
        agg.paged = st
    dogs = [mod.HealthWatchdog(com, agg, interval=1.0)
            for mod, agg in zip((jax_health, port_health), aggs)]
    rep = _same(dogs)
    (reason,) = rep.reasons
    assert reason["code"] == "pool_saturation"
    assert reason["value"] == stores[1].pool_saturation() >= 0.9
    assert "63-page arena" in reason["detail"]


# -- the system: /healthz and the gauges ---------------------------------- #


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _port_system():
    from loghisto_tpu_torch.system import TorchMetricSystem

    return TorchMetricSystem(interval=1.0, sys_stats=False, num_metrics=16,
                             retention=((4, 1),), observability=True,
                             device="cpu")


def _jax_system():
    from loghisto_tpu.system import TPUMetricSystem

    return TPUMetricSystem(interval=1.0, sys_stats=False, num_metrics=16,
                           retention=((4, 1),), observability=True)


def _raw(seq, seed):
    """One hand-built interval of lognormal samples on two names."""
    import datetime as dt

    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.ops.codec import compress_np

    rng = np.random.default_rng(seed)
    hists = {}
    for i, name in enumerate(("a.lat", "b.lat")):
        b, c = np.unique(compress_np(rng.lognormal(1.0 + i, 0.5, 100)),
                         return_counts=True)
        hists[name] = dict(zip(b.tolist(), c.tolist()))
    t = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc) + dt.timedelta(
        seconds=seq)
    return RawMetricSet(time=t, counters={}, rates={}, histograms=hists,
                        gauges={}, duration=1.0, seq=seq)


def _committed_system():
    ms = _port_system()
    ms.backfill_retention([_raw(1, 1), _raw(2, 2)])
    return ms


def test_healthz_serves_the_watchdog():
    from loghisto_tpu_torch.prometheus import PrometheusEndpoint

    ms = _committed_system()
    ep = PrometheusEndpoint(ms, port=0, host="127.0.0.1")
    try:
        ep.start()
        url = f"http://127.0.0.1:{ep.port}/healthz"
        status, doc = _get(url)
        assert status == 200 and doc["status"] == "ok"
        assert set(doc) == {"status", "ok", "reasons", "last_commit_age_s",
                            "last_seq", "intervals_committed"}
        assert doc["last_seq"] == 2 and doc["intervals_committed"] == 2
        # stalled -> 503, so liveness probes fail without parsing JSON
        ms.health._last_commit_t -= 999.0
        status, doc = _get(url)
        assert status == 503 and doc["status"] == "stalled"
        assert doc["reasons"][0]["code"] == "no_commit"
        for r in doc["reasons"]:
            assert set(r) == {"code", "detail", "value"}
        # commits resume: 200 again
        ms.backfill_retention([_raw(3, 3)])
        status, doc = _get(url)
        assert status == 200 and doc["status"] == "ok"
        assert doc["last_seq"] == 3
    finally:
        ep.stop()
        ms.stop()


def test_healthz_without_watchdog_is_the_jax_document():
    from loghisto_tpu.metrics import MetricSystem as JaxMetricSystem
    from loghisto_tpu.prometheus import PrometheusEndpoint as JaxEndpoint
    from loghisto_tpu_torch.metrics import MetricSystem
    from loghisto_tpu_torch.prometheus import NO_WATCHDOG, PrometheusEndpoint

    docs = []
    for ms_cls, ep_cls in ((JaxMetricSystem, JaxEndpoint),
                           (MetricSystem, PrometheusEndpoint)):
        ms = ms_cls(interval=60.0, sys_stats=False)
        ep = ep_cls(ms, port=0, host="127.0.0.1")
        try:
            ep.start()
            docs.append(_get(f"http://127.0.0.1:{ep.port}/healthz"))
        finally:
            ep.stop()
            ms.stop()
    assert docs[1] == docs[0] == (200, NO_WATCHDOG)


def test_health_gauges_are_registered_as_in_the_jax_system():
    systems = [_jax_system(), _port_system()]
    try:
        names = []
        for ms in systems:
            with ms._gauge_lock:
                names.append({n for n in ms._gauge_funcs
                              if n.startswith(("health.", "obs."))})
        assert names[1] == names[0]
        assert set(HEALTH_GAUGES) | {"obs.SpansDropped"} == names[1]
        gauges = systems[1].collect_raw_metrics().gauges
        assert gauges["health.Status"] == 0.0
        assert gauges["health.device_cooldown"] == 0.0
    finally:
        for ms in systems:
            ms.stop()
