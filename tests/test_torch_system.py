"""The port's host ``MetricSystem``, ``TorchAggregator.merge_raw``/
``attach`` and ``TorchMetricSystem`` against the JAX package's
``MetricSystem`` and a CPU ``TPUMetricSystem(commit="fanout")``, at small
sizes (M = 32, bucket_limit 64, tiers (4, 1), (3, 2), (2, 6)).

Tolerances:
  * host tier (collect_raw_metrics, process_metrics): EQUAL — both run
    the same float64 NumPy statistics;
  * device_metrics and query_window: counts EQUAL, percentile buckets
    EQUAL, percentile values rtol 4e-6 (XLA's float32 ``exp``, ROADMAP
    F1), sums and averages rtol 1e-5 (float32 matvecs);
  * spill intervals: both packages take the float64 host statistics:
    counts EQUAL.
"""

import queue
import time

import numpy as np
import pytest

from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.metrics import MetricSystem as JaxMetricSystem
from loghisto_tpu.metrics import merge_raw_metric_sets as jax_merge_sets
from loghisto_tpu.parallel.aggregator import TPUAggregator
from loghisto_tpu.system import TPUMetricSystem
from loghisto_tpu_torch.channel import Channel
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.metrics import MetricSystem, merge_raw_metric_sets
from loghisto_tpu_torch.ops.codec import compress_np
from loghisto_tpu_torch.ops.dispatch import resolve_commit_path
from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
from loghisto_tpu_torch.system import TorchMetricSystem

BL = 64
M = 32
TIERS = ((4, 1), (3, 2), (2, 6))
NAMES = ["api.lat", "api.size", "db.lat", "cache.lat"]


def _record(ms, rng, interval):
    """One interval of samples through every host entry point."""
    for i, name in enumerate(NAMES):
        values = rng.lognormal(-1.2 - 0.2 * i, 0.5, 300 + 50 * interval)
        ms.histogram_batch(name, values)
        for v in values[:20]:
            ms.histogram(name, float(v))
    ms.histogram_batch("list.lat", [0.1, 0.2, 0.3])
    ms.recorder("rec.lat").record(0.05 * (interval + 1))
    ms.counter("req", 100 + interval)
    ms.counter("err", interval % 3)
    ms.counter_handle("handle.req").add(7)
    if interval == 0:
        ms.counter("once", 0)


def _host_pair(**kw):
    jax_ms = JaxMetricSystem(sys_stats=False, config=JaxConfig(**kw))
    port = MetricSystem(sys_stats=False, config=MetricConfig(**kw))
    return jax_ms, port


@pytest.mark.parametrize("go_compat", [False, True])
def test_host_metric_system_matches_jax(go_compat):
    jax_ms, port = _host_pair(go_compat=go_compat, ingest_buffer_cap=256)
    rng_j, rng_p = np.random.default_rng(1), np.random.default_rng(1)
    for interval in range(3):
        _record(jax_ms, rng_j, interval)
        _record(port, rng_p, interval)
        want, got = jax_ms.collect_raw_metrics(), port.collect_raw_metrics()
        assert got.counters == want.counters
        assert got.rates == want.rates
        assert got.histograms == want.histograms
        assert (got.duration, got.seq, got.time) == (
            want.duration, want.seq, want.time)
        pw, pg = jax_ms.process_metrics(want), port.process_metrics(got)
        jax_ms._attach_aggregates(pw, want)
        port._attach_aggregates(pg, got)
        assert pg.metrics == pw.metrics


def test_specify_percentiles_and_processing_match_jax():
    jax_ms, port = _host_pair()
    pct = {"%s_p10": 0.1, "%s_p999": 0.999, "%s_bad": 1.5}
    jax_ms.specify_percentiles(pct)
    port.specify_percentiles(pct)
    rng_j, rng_p = np.random.default_rng(2), np.random.default_rng(2)
    _record(jax_ms, rng_j, 0)
    _record(port, rng_p, 0)
    want = jax_ms.process_metrics(jax_ms.collect_raw_metrics())
    got = port.process_metrics(port.collect_raw_metrics())
    assert got.metrics == want.metrics
    assert "api.lat_p10" in got.metrics and "api.lat_bad" not in got.metrics
    with pytest.raises(ValueError, match="not a valid %-format"):
        port.specify_percentiles({"%d_x": 0.5})


def test_timers_record_durations():
    _, port = _host_pair()
    with port.start_timer("t.lat"):
        time.sleep(0.001)
    timer = port.timer("t.lat")
    timer.stop(timer.start())
    raw = port.collect_raw_metrics()
    assert sum(raw.histograms["t.lat"].values()) == 2
    assert max(raw.histograms["t.lat"]) >= int(compress_np([1e6])[0])


def test_later_slice_options_raise_naming_their_slice():
    with pytest.raises(ValueError, match="slice 6b"):
        MetricSystem(fast_ingest=True)
    # labels= came with slice 7b: the calls land on the canonical row
    _, port = _host_pair()
    port.histogram("x", 1.0, labels={"route": "/a"})
    port.counter("x", labels={"route": "/a"})
    port.recorder("x", labels={"route": "/a"}).record(2.0)
    raw = port.collect_raw_metrics()
    assert sum(raw.histograms["x;route=/a"].values()) == 2
    assert raw.counters["x;route=/a"] == 1


def test_merge_raw_metric_sets_matches_jax():
    jax_ms, port = _host_pair()
    rng = np.random.default_rng(3)
    sets = []
    for interval in range(2):
        _record(port, rng, interval)
        sets.append(port.collect_raw_metrics())
    got = merge_raw_metric_sets(*sets)
    want = jax_merge_sets(*sets)
    assert got.histograms == want.histograms
    assert (got.counters, got.rates, got.seq, got.duration, got.time) == (
        want.counters, want.rates, want.seq, want.duration, want.time)


def test_broadcast_evicts_a_full_subscriber_like_jax():
    for ms in _host_pair():
        ch = Channel(1)
        ms.subscribe_to_raw_metrics(ch)
        q = queue.Queue(16)
        for _ in range(3):
            ms._tick(q)
        assert ch.closed and len(ch) == 1
        assert ch not in ms._raw_subscribers


def test_reaper_delivers_raw_and_processed_intervals():
    port = MetricSystem(interval=0.05, sys_stats=True)
    raw_ch, proc_ch = Channel(64), Channel(64)
    port.subscribe_to_raw_metrics(raw_ch)
    port.subscribe_to_processed_metrics(proc_ch)
    port.start()
    port.start()  # idempotent while running
    try:
        port.histogram("x", 1.5)
        raw = raw_ch.get(timeout=5.0)
        proc = proc_ch.get(timeout=5.0)
    finally:
        port.stop()
    assert "sys.Alloc" in raw.gauges and raw.duration == 0.05
    assert "sys.NumGoroutine" in proc.metrics


# -- aggregator: merge_raw and the spill guard ------------------------------


def _agg_pair(m=M):
    jax_agg = TPUAggregator(num_metrics=m, config=JaxConfig(bucket_limit=BL),
                            storage="dense")
    port = TorchAggregator(num_metrics=m, config=MetricConfig(bucket_limit=BL),
                           device="cpu")
    return jax_agg, port


def _assert_metrics_close(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if key.endswith(("_count", "_agg_count")):
            assert g == w, key
        elif key.endswith(("_sum", "_avg")):
            assert g == pytest.approx(w, rel=1e-5, abs=1e-6), key
        else:
            assert compress_np([g])[0] == compress_np([w])[0], key
            assert g == pytest.approx(w, rel=4e-6, abs=0), key


def test_merge_raw_matches_jax():
    jax_agg, port = _agg_pair()
    rng = np.random.default_rng(4)
    src = MetricSystem(sys_stats=False)
    try:
        for interval in range(3):
            _record(src, rng, interval)
            raw = src.collect_raw_metrics()
            raw.histograms["clipped"] = {-90: 3, 90: 4, 0: 1}
            jax_agg.merge_raw(raw)
            port.merge_raw(raw)
            assert port.registry.names() == jax_agg.registry.names()
            _assert_metrics_close(port.collect().metrics,
                                  jax_agg.collect().metrics)
        assert port._spill is None
    finally:
        jax_agg.close()
        port.close()


@pytest.mark.parametrize("weight", [1 << 30, (1 << 31) + 17])
def test_merge_raw_giant_weight_takes_the_exact_host_spill(weight):
    jax_agg, port = _agg_pair()
    rng = np.random.default_rng(5)
    src = MetricSystem(sys_stats=False)
    try:
        _record(src, rng, 0)
        raw = src.collect_raw_metrics()
        raw.histograms["giant"] = {10: weight, 11: 5}
        jax_agg.merge_raw(raw)
        port.merge_raw(raw)
        assert jax_agg._spill is not None and port._spill is not None
        np.testing.assert_array_equal(port._spill, jax_agg._spill)
        want, got = jax_agg.collect().metrics, port.collect().metrics
        assert got["giant_count"] == want["giant_count"] == weight + 5
        _assert_metrics_close(got, want)
    finally:
        jax_agg.close()
        port.close()


def test_merge_raw_on_paged_storage_matches_dense():
    rng = np.random.default_rng(6)
    src = MetricSystem(sys_stats=False)
    config = MetricConfig(bucket_limit=512)  # paging needs >= 1 full page
    dense = TorchAggregator(num_metrics=M, config=config, device="cpu")
    paged = TorchAggregator(num_metrics=M, config=config, storage="paged",
                            device="cpu")
    for interval in range(2):
        _record(src, rng, interval)
        raw = src.collect_raw_metrics()
        dense.merge_raw(raw)
        paged.merge_raw(raw)
    assert paged.paged.commits > 0
    want, got = dense.collect().metrics, paged.collect().metrics
    assert set(got) == set(want)
    for key in want:
        if key.endswith("_count"):
            assert got[key] == want[key]
        else:  # dense-codec rows: the same buckets
            assert compress_np([got[key]])[0] == compress_np([want[key]])[0]
    dense.close()
    paged.close()


def test_register_device_gauges():
    ms = MetricSystem(sys_stats=False)
    agg = TorchAggregator(num_metrics=4, config=MetricConfig(bucket_limit=BL),
                          device="cpu")
    agg.register_device_gauges(ms)
    gauges = ms.collect_raw_metrics().gauges
    assert gauges["tpu.HbmBytesInUse"] == 0.0
    assert {"tpu.LastAggregationUs", "tpu.BridgeEvictions",
            "tpu.SpilledSamples"} <= set(gauges)


# -- the whole system --------------------------------------------------------


def test_commit_path_resolves_to_fanout():
    """"auto" is the fused committer on dense storage and the fan-out on
    paged storage (D5); "fanout" always resolves, "fused" raises on
    paged storage naming the paged lifecycle slice."""
    assert resolve_commit_path("auto") == "fused"
    assert resolve_commit_path("auto", paged=True) == "fanout"
    assert resolve_commit_path("fanout") == "fanout"
    assert resolve_commit_path("fanout", paged=True) == "fanout"
    assert resolve_commit_path("fused") == "fused"
    with pytest.raises(ValueError, match="paged lifecycle slice"):
        resolve_commit_path("fused", paged=True)
    with pytest.raises(ValueError, match="unknown commit path"):
        resolve_commit_path("eager")
    with pytest.raises(ValueError, match="paged lifecycle slice"):
        TorchMetricSystem(device="cpu", commit="fused", storage="paged",
                          config=MetricConfig(bucket_limit=512),
                          num_metrics=M, retention=TIERS, sys_stats=False)
    paged = TorchMetricSystem(device="cpu", storage="paged", num_metrics=M,
                              config=MetricConfig(bucket_limit=512),
                              retention=TIERS, sys_stats=False)
    assert paged.commit_path == "fanout" and paged.committer is None
    paged.stop()
    # without retention the aggregator is the only consumer
    bare = TorchMetricSystem(device="cpu", commit="fused", num_metrics=4,
                             sys_stats=False)
    assert bare.commit_path == "fanout" and bare.committer is None
    bare.stop()
    dense = TorchMetricSystem(device="cpu", num_metrics=M, sys_stats=False,
                              config=MetricConfig(bucket_limit=BL),
                              retention=TIERS)
    assert dense.commit_path == "fused" and dense.committer is not None
    assert dense.aggregator._attached is None
    assert dense.retention._thread is None
    dense.stop()


def _system_pair():
    jax_ms = TPUMetricSystem(interval=1.0, sys_stats=False, num_metrics=M,
                             config=JaxConfig(bucket_limit=BL),
                             retention=TIERS, commit="fanout",
                             storage="dense")
    port = TorchMetricSystem(interval=1.0, sys_stats=False, num_metrics=M,
                             config=MetricConfig(bucket_limit=BL),
                             retention=TIERS, commit="fanout", device="cpu")
    assert port.commit_path == jax_ms.commit_path == "fanout"
    assert port.retention.registry is port.aggregator.registry
    return jax_ms, port


def test_whole_system_matches_tpu_metric_system():
    jax_ms, port = _system_pair()
    rng_j, rng_p = np.random.default_rng(7), np.random.default_rng(7)
    try:
        for w in (2.0, 5.0):
            jax_ms.retention.pin_window(w)
            port.retention.pin_window(w)
        for interval in range(14):
            for ms, rng in ((jax_ms, rng_j), (port, rng_p)):
                _record(ms, rng, interval)
                raw = ms.collect_raw_metrics()
                ms.retention.push(raw)
                ms.aggregator.merge_raw(raw)
            if interval % 5 == 4:
                _assert_metrics_close(port.device_metrics().metrics,
                                      jax_ms.device_metrics().metrics)
        for window in (1.0, 2.0, 3.0, 5.0, 8.0, None):
            want = jax_ms.query_window("*", window, percentiles=(0.5, 0.99))
            got = port.query_window("*", window, percentiles=(0.5, 0.99))
            assert (got.covered_s, got.tier, got.slots) == (
                want.covered_s, want.tier, want.slots)
            assert set(got.metrics) == set(want.metrics)
            for name, w in want.metrics.items():
                g = got.metrics[name]
                assert g["count"] == w["count"]
                assert g["sum"] == pytest.approx(w["sum"], rel=1e-5)
                for key in ("p50", "p99"):
                    assert g[key] == pytest.approx(w[key], rel=4e-6)
            assert port.window_rate("req", window or 36.0) == \
                jax_ms.window_rate("req", window or 36.0)
        _assert_metrics_close(port.device_metrics().metrics,
                              jax_ms.device_metrics().metrics)
    finally:
        jax_ms.stop()
        port.stop()


def test_whole_system_rules_and_alerts():
    from loghisto_tpu_torch.window import SloBurnRateRule

    port = TorchMetricSystem(interval=1.0, sys_stats=False, num_metrics=M,
                             config=MetricConfig(bucket_limit=BL),
                             retention=TIERS, device="cpu")
    ch = Channel(16)
    port.add_rule(SloBurnRateRule("slo", "err", "req", objective=0.99,
                                  long_window=6.0, short_window=2.0,
                                  threshold=0.5))
    port.subscribe_to_alerts(ch)
    rng = np.random.default_rng(8)
    for interval in range(6):
        _record(port, rng, interval)
        port.retention.push(port.collect_raw_metrics())
    assert "slo" in port.rule_engine.active()
    assert ch.get(block=False).rule == "slo"
    assert port.collect_raw_metrics().gauges["alert.slo"] == 1.0
    port.unsubscribe_from_alerts(ch)
    port.stop()
    bare = TorchMetricSystem(sys_stats=False, num_metrics=4, device="cpu")
    with pytest.raises(RuntimeError, match="need retention"):
        bare.query_window("*", 1.0)
    bare.stop()


def test_threaded_start_stop_carries_intervals():
    port = TorchMetricSystem(interval=0.1, sys_stats=True, num_metrics=M,
                             config=MetricConfig(bucket_limit=BL),
                             retention=TIERS, device="cpu")
    port.start()
    try:
        deadline = time.monotonic() + 20.0
        while port.retention.intervals_pushed < 3:
            port.histogram_batch("api.lat", np.full(50, 0.25))
            assert time.monotonic() < deadline, "no interval arrived"
            time.sleep(0.02)
    finally:
        port.stop()
    assert port.commit_path == "fused"
    assert port.committer.bridge_error is None
    assert port.aggregator.bridge_error is None
    assert port.retention.bridge_error is None
    assert port.committer.fused_intervals == port.retention.intervals_pushed
    assert port.device_metrics().metrics["api.lat_count"] > 0
    assert port.query_window("api.lat").metrics["api.lat"]["count"] > 0
    port.start()  # restartable: the committer's bridge re-attaches
    assert port.committer._thread is not None
    assert port.aggregator._attached is None
    port.stop()


def test_bridge_failures_surface_on_query_and_stop():
    port = TorchMetricSystem(interval=1.0, sys_stats=False, num_metrics=M,
                             config=MetricConfig(bucket_limit=BL),
                             retention=TIERS, commit="fanout", device="cpu")
    boom = RuntimeError("injected kernel launch failure")

    def fail(*a, **k):
        raise boom

    port.aggregator.merge_raw = fail
    port.retention._cells_from_raw = fail
    port.histogram("api.lat", 0.5)
    port._tick(queue.Queue(16))
    deadline = time.monotonic() + 10.0
    while (port.retention.bridge_error is None
           or port.aggregator.bridge_error is None):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="bridge failed") as e:
        port.query_window("*", 1.0)
    assert e.value.__cause__ is boom
    with pytest.raises(RuntimeError, match="bridge failed"):
        port.device_metrics()
    with pytest.raises(RuntimeError, match="bridge failed"):
        port.stop()
    assert port.aggregator.bridge_error is None  # detach cleared it


def test_committer_failure_surfaces_on_query_and_stop():
    """D6: a failed fused commit is not recovered; its exception is kept
    as bridge_error and re-raised by the next query, device_metrics()
    and stop()."""
    port = TorchMetricSystem(interval=1.0, sys_stats=False, num_metrics=M,
                             config=MetricConfig(bucket_limit=BL),
                             retention=TIERS, device="cpu")
    boom = RuntimeError("injected kernel launch failure")

    def fail(*a, **k):
        raise boom

    port.committer._fused_dispatch_locked = fail
    port.histogram("api.lat", 0.5)
    port._tick(queue.Queue(16))
    deadline = time.monotonic() + 10.0
    while port.committer.bridge_error is None:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="bridge failed") as e:
        port.query_window("*", 1.0)
    assert e.value.__cause__ is boom
    with pytest.raises(RuntimeError, match="bridge failed"):
        port.device_metrics()
    with pytest.raises(RuntimeError, match="committer's bridge failed"):
        port.stop()
    assert port.committer.bridge_error is None  # detach cleared it
    assert port.aggregator.bridge_error is None
    assert port.retention.bridge_error is None


def test_threaded_fused_system_with_lifecycle_and_drift():
    """The reaper feeds the committer's bridge; lifecycle and drift
    gauges export through the same pipeline; stop/start re-attaches."""
    from loghisto_tpu_torch.anomaly import AnomalyConfig
    from loghisto_tpu_torch.lifecycle import LifecycleConfig

    port = TorchMetricSystem(interval=0.1, sys_stats=False, num_metrics=M,
                             config=MetricConfig(bucket_limit=BL),
                             retention=TIERS, device="cpu",
                             lifecycle=LifecycleConfig(ttl_intervals=1,
                                                       check_every=1),
                             anomaly=AnomalyConfig(min_samples=5))
    port.start()
    try:
        deadline = time.monotonic() + 20.0
        k = 0
        while port.committer.intervals_committed < 4:
            port.histogram_batch("api.lat", np.full(50, 0.25))
            port.histogram(f"api.u{k}", 0.5)
            k += 1
            assert time.monotonic() < deadline, "no interval arrived"
            time.sleep(0.02)
    finally:
        port.stop()
    assert port.committer.bridge_error is None
    assert port.committer.fused_intervals == port.retention.intervals_pushed
    assert port.anomaly.scored_intervals == port.committer.intervals_committed
    gauges = port.collect_raw_metrics().gauges
    for g in ("commit.FusedIntervals", "lifecycle.ActiveSeries",
              "lifecycle.EvictedSeries", "anomaly.ScoredIntervals"):
        assert g in gauges, g
    assert port.lifecycle.evicted_series > 0
    port.start()
    assert port.committer._thread is not None
    port.stop()
