"""The port's span ring, self-observer and Perfetto export
(``loghisto_tpu_torch/obs``) against the JAX package's, at small sizes
(``num_metrics=16``, ``retention=((4, 1),)``, ``device="cpu"``), with
inputs from a numpy seed.

Tolerances: none.  The ring, the Perfetto document and the per-seq stage
sets are EQUAL; ``LatencyHistogram`` percentiles are EQUAL (both run the
host codec and the same CDF walk).  No test asserts a time or sleeps for
an interval boundary: intervals are fed by hand (``backfill_retention``
or the reaper's ``_tick``), and a wait on the committer's thread is a
counter with a 30 s deadline.
"""

import json
import queue
import threading
import time

import numpy as np
import pytest

import loghisto_tpu.obs as jax_obs
from loghisto_tpu.metrics import RawMetricSet as JaxRaw
from loghisto_tpu.obs import perfetto as jax_perfetto
from loghisto_tpu.system import TPUMetricSystem
import loghisto_tpu_torch.obs as port_obs
from loghisto_tpu_torch.metrics import RawMetricSet
from loghisto_tpu_torch.obs import perfetto as port_perfetto
from loghisto_tpu_torch.system import TorchMetricSystem

NAMES = ["api.lat", "db.lat", "cache.lat"]
PACKAGES = {"jax": jax_obs, "port": port_obs}
COMMIT_STAGES = {"commit.cells", "commit.upload", "commit.dispatch",
                 "commit.device_sync", "commit.snapshot_publish"}


def _port_system(observability=True, **kw):
    return TorchMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=16,
        retention=((4, 1),), observability=observability, device="cpu",
        **kw)


def _jax_system(observability=True, **kw):
    return TPUMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=16,
        retention=((4, 1),), observability=observability, **kw)


def _synchronised(com):
    """Wait for each JAX commit step before the next is staged (the JAX
    staging ring rewrites a host slot two stages later, and on the CPU
    ``jax.device_put`` reads it after returning: ROADMAP F3)."""
    import jax

    for attr in ("_fused", "_fused_snap"):
        step = getattr(com, attr)
        setattr(com, attr,
                lambda *a, _step=step: jax.block_until_ready(_step(*a)))
    return com


def _raw_intervals(cls, seed, n=4):
    """n hand-built intervals with seqs 1..n: lognormal buckets for each
    name, from one numpy seed."""
    import datetime as dt

    from loghisto_tpu_torch.ops.codec import compress_np

    rng = np.random.default_rng(seed)
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    out = []
    for k in range(n):
        hists = {}
        for i, name in enumerate(NAMES):
            b, c = np.unique(compress_np(rng.lognormal(1.0 + i, 0.6, 200)),
                             return_counts=True)
            hists[name] = dict(zip(b.tolist(), c.tolist()))
        rates = {"req": int(rng.integers(10, 20))}
        out.append(cls(time=t0 + dt.timedelta(seconds=k), counters=rates,
                       rates=dict(rates), histograms=hists, gauges={},
                       duration=1.0, seq=k + 1))
    return out


def _by_seq(spans):
    by = {}
    for s in spans:
        by.setdefault(s.seq, []).append(s)
    return by


def _assert_nested(spans):
    """Every committed interval's commit.* spans lie inside its
    commit.e2e, on its thread; e2e seqs strictly increase."""
    by = _by_seq(spans)
    e2e = [s for s in spans if s.stage == "commit.e2e"]
    assert e2e
    for parent in e2e:
        stages = {s.stage for s in by[parent.seq]}
        assert COMMIT_STAGES <= stages, (parent.seq, stages)
        for s in by[parent.seq]:
            if s.stage.startswith("commit.") and s is not parent:
                assert s.thread == parent.thread
                assert parent.start_ns <= s.start_ns <= s.end_ns \
                    <= parent.end_ns
    seqs = [s.seq for s in e2e]
    assert all(q > 0 for q in seqs)
    assert all(a < b for a, b in zip(seqs, seqs[1:]))
    return e2e


# -- ring semantics, both packages ---------------------------------------- #


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_ring_wraps_drop_oldest(pkg):
    rec = PACKAGES[pkg].SpanRecorder(capacity=8)
    for i in range(20):
        rec.record(f"s{i}", i, i + 1)
    assert (rec.capacity, rec.recorded, rec.dropped) == (8, 20, 12)
    assert [s.stage for s in rec.spans()] == [f"s{i}" for i in range(12, 20)]
    rec.clear()
    assert rec.spans() == () and rec.recorded == 0


def test_ring_contents_equal_the_jax_ring():
    rng = np.random.default_rng(5)
    recs = [m.SpanRecorder(capacity=13) for m in (jax_obs, port_obs)]
    for k in range(40):
        stage = f"s{int(rng.integers(0, 5))}"
        t0 = int(rng.integers(0, 1 << 40))
        seq = None if k % 3 else int(rng.integers(1, 9))
        for rec in recs:
            if k % 7 == 0:
                rec.begin_interval(k)
            rec.record(stage, t0, t0 + k, seq)
    want, got = (r.spans() for r in recs)
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    assert [r.dropped for r in recs] == [40 - 16] * 2
    assert recs[1].spans_for(14) == tuple(
        s for s in got if s.seq == 14)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_capacity_is_a_power_of_two_and_never_reallocates(pkg):
    rec = PACKAGES[pkg].SpanRecorder(capacity=5)
    assert rec.capacity == 8
    for i in range(100):
        rec.record("s", i, i + 1)
    assert len(rec._slots) == 8
    with pytest.raises(ValueError):
        PACKAGES[pkg].SpanRecorder(capacity=0)


def test_attribution_across_threads():
    rec = port_obs.SpanRecorder(capacity=256)
    assert rec.begin_interval(7) == 7

    def worker():
        for i in range(10):
            rec.record("w", i, i + 1)

    threads = [threading.Thread(target=worker, name=f"w{k}")
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = rec.spans_for(7)
    assert len(spans) == 40
    assert {s.thread for s in spans} == {"w0", "w1", "w2", "w3"}
    rec.record("x", 0, 1, seq=3)
    assert [s.stage for s in rec.spans_for(3)] == ["x"]
    assert rec.begin_interval() == 1  # minted when the caller has none
    assert rec.begin_interval(99) == 99 and rec.current_seq == 99
    with rec.span("y", seq=4):
        pass
    (y,) = rec.spans_for(4)
    assert y.stage == "y" and y.end_ns >= y.start_ns


def test_null_recorder_is_inert():
    null = port_obs.NULL_RECORDER
    with null.span("commit.e2e"):
        pass
    null.record("s", 0, 1)
    assert null.spans() == () and null.spans_for(0) == ()
    assert null.begin_interval(5) == 5 and null.begin_interval() == 0
    assert (null.enabled, null.recorded, null.dropped) == (False, 0, 0)
    rec = port_obs.SpanRecorder(capacity=4)
    rec.enabled = False
    rec.record("s", 0, 1)
    with rec.span("t"):
        pass
    assert rec.spans() == ()


# -- LatencyHistogram ----------------------------------------------------- #


def test_latency_histogram_equals_the_jax_histogram():
    values = np.random.default_rng(11).lognormal(5.0, 1.3, 3000)
    hists = [m.LatencyHistogram() for m in (jax_obs, port_obs)]
    for h in hists:
        for v in values:
            h.add(float(v))
    want, got = hists
    assert got.count == want.count == len(values)
    for q in (0.0, 1.0, 25.0, 50.0, 90.0, 99.0, 99.9, 100.0):
        assert got.percentile(q) == want.percentile(q), q
        assert got.percentile_host(q) == want.percentile_host(q), q
    for v in (10.0, 150.0, 1e4):
        assert got.count_above(v) == want.count_above(v)
    gb, gc = got.snapshot()
    wb, wc = want.snapshot()
    assert dict(zip(gb.tolist(), gc.tolist())) == dict(
        zip(wb.tolist(), wc.tolist()))
    assert port_obs.LatencyHistogram().percentile(99.0) == 0.0


def test_percentile_sparse_host_equals_the_jax_mirror():
    from loghisto_tpu.obs.spans import percentile_sparse_host as want
    from loghisto_tpu_torch.obs.spans import percentile_sparse_host as got

    rng = np.random.default_rng(3)
    buckets = rng.choice(np.arange(-300, 300), 40, replace=False)
    counts = rng.integers(1, 50, 40)
    ps = np.array([0.0, 0.5, 0.9, 0.99, 1.0])
    np.testing.assert_array_equal(got(buckets, counts, ps),
                                  want(buckets, counts, ps))
    np.testing.assert_array_equal(got([], [], ps), want([], [], ps))


# -- Perfetto --------------------------------------------------------------- #


class _Fixed:
    def __init__(self, spans):
        self._spans = spans

    def spans(self):
        return tuple(self._spans)


def _span_lists(seed=9):
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(30):
        t0 = int(rng.integers(0, 1 << 40))
        rows.append((f"stage{k % 6}", t0, t0 + int(rng.integers(0, 1 << 20)),
                     int(rng.integers(0, 5)), f"thread-{k % 3}",
                     None if k % 4 else int(rng.integers(1, 1 << 30))))
    return ([jax_obs.Span(*r) for r in rows],
            [port_obs.Span(*r) for r in rows])


@pytest.mark.parametrize("seqs", [None, (1, 3)])
def test_trace_events_equal_the_jax_document(seqs):
    jspans, pspans = _span_lists()
    want = jax_perfetto.trace_events(_Fixed(jspans), process_name="p",
                                     seqs=seqs)
    got = port_perfetto.trace_events(_Fixed(pspans), process_name="p",
                                     seqs=seqs)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def test_dump_perfetto_writes_one_event_per_span(tmp_path):
    rec = port_obs.SpanRecorder(capacity=64)
    rec.begin_interval(1)
    with rec.span("commit.e2e"):
        with rec.span("commit.cells"):
            pass
    rec.begin_interval(2)
    t = threading.Thread(target=lambda: rec.record("ingest.drain", 10, 20),
                         name="xfer-test")
    t.start()
    t.join()
    path = tmp_path / "trace.json"
    n = port_obs.dump_perfetto(rec, str(path))
    doc = json.loads(path.read_text())
    assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
    events = doc["traceEvents"]
    assert n == len(events)
    assert json.dumps(events) == json.dumps(jax_perfetto.trace_events(
        rec, process_name="loghisto_tpu_torch"))
    xs = [e for e in events if e["ph"] == "X"]
    assert len(xs) == len(rec.spans()) == 3
    threads = {e["args"]["name"] for e in events
               if e["ph"] == "M" and e["name"] == "thread_name"}
    assert "xfer-test" in threads
    for seq in (1, 2):
        chain = [e for e in events if e["ph"] in ("s", "t")
                 and e["id"] == seq]
        assert chain[0]["ph"] == "s"
        assert all(e["ph"] == "t" for e in chain[1:])


def test_merge_traces_equals_the_jax_merge():
    jspans, pspans = _span_lists(17)
    docs = []
    for k in range(2):
        ev = port_perfetto.trace_events(_Fixed(pspans[k::2]),
                                        process_name=f"p{k}")
        docs.append({"traceEvents": ev, "otherData": {
            "process": f"p{k}", "wall_anchor_ns": 10**18 + k * 5000,
            "perf_anchor_ns": 10**9 + k * 7000}})
    want = jax_perfetto.merge_traces(json.loads(json.dumps(docs)))
    got = port_perfetto.merge_traces(json.loads(json.dumps(docs)))
    assert got["traceEvents"] == want["traceEvents"]
    assert got["otherData"]["merged_from"] == ["p0", "p1"]


# -- the system: per-seq stage sets, dogfooding, debug_dump ---------------- #


def _stage_sets(spans):
    return {seq: sorted({s.stage for s in group})
            for seq, group in _by_seq(spans).items()}


def test_stage_sets_per_seq_equal_the_jax_system():
    jms = _jax_system()
    pms = _port_system()
    try:
        _synchronised(jms.committer)
        assert jms.commit_path == pms.commit_path == "fused"
        assert jms.backfill_retention(_raw_intervals(JaxRaw, 1)) == 4
        assert pms.backfill_retention(_raw_intervals(RawMetricSet, 1)) == 4
        pms.query_window("*", 2.0)
        jms.query_window("*", 2.0)
        want, got = jms.obs.spans(), pms.obs.spans()
        assert _stage_sets(got) == _stage_sets(want)
        assert [s.seq for s in _assert_nested(got)] == [1, 2, 3, 4]
        _assert_nested(want)
        assert pms.self_observer.reingested == jms.self_observer.reingested
        assert pms.self_observer.reingested == sum(
            1 for s in got if s.seq in (1, 2, 3, 4)
            and s.stage != "query.serve")
        assert pms.self_observer.commit_latency.count == 4
        # the dogfooded rows arrive through histogram()
        jraw, praw = jms.collect_raw_metrics(), pms.collect_raw_metrics()
        jobs = sorted(k for k in jraw.histograms if k.startswith("obs."))
        pobs = sorted(k for k in praw.histograms if k.startswith("obs."))
        assert pobs == jobs and "obs.commit.e2e.LatencyUs" in pobs
        assert sum(sum(h.values()) for k, h in praw.histograms.items()
                   if k.startswith("obs.")) == pms.self_observer.reingested
        assert pms.committer._latency_hist.percentile(50.0) > 0.0
    finally:
        jms.stop()
        pms.stop()


@pytest.mark.parametrize("lifecycle", [False, True])
def test_lifecycle_and_drift_spans_match_the_jax_system(lifecycle):
    from loghisto_tpu.anomaly import AnomalyConfig as JaxAnomaly
    from loghisto_tpu.lifecycle import LifecycleConfig as JaxLifecycle
    from loghisto_tpu_torch.anomaly import AnomalyConfig
    from loghisto_tpu_torch.lifecycle import LifecycleConfig

    def cfgs(lc, an):
        kw = {"anomaly": an(banks=2, bank_of=lambda t: t.second % 2,
                            min_samples=5)}
        if lifecycle:
            kw["lifecycle"] = lc(ttl_intervals=2, check_every=1)
        return kw

    jms = _jax_system(**cfgs(JaxLifecycle, JaxAnomaly))
    pms = _port_system(**cfgs(LifecycleConfig, AnomalyConfig))
    try:
        _synchronised(jms.committer)
        jms.backfill_retention(_raw_intervals(JaxRaw, 2))
        pms.backfill_retention(_raw_intervals(RawMetricSet, 2))
        want, got = jms.obs.spans(), pms.obs.spans()
        assert _stage_sets(got) == _stage_sets(want)
        stages = {s.stage for s in got}
        assert "anomaly.score" in stages
        assert ("lifecycle.tick" in stages) is lifecycle
        _assert_nested(got)
    finally:
        jms.stop()
        pms.stop()


def test_reaper_ticks_give_complete_nested_span_sets():
    """Intervals through the reaper's tick (by hand) and the committer's
    bridge: the committer adopts the reaper's seqs, and the broadcast
    span carries the same seq."""
    ms = _port_system()
    q = queue.Queue()
    rng = np.random.default_rng(4)
    try:
        for k in range(3):
            for name in NAMES:
                ms.histogram_batch(name, rng.lognormal(2.0, 0.5, 64))
            ms._tick(q)
            q.get_nowait()()  # the processed broadcast, on this thread
        deadline = time.monotonic() + 30.0
        while ms.committer.intervals_committed < 3:
            assert time.monotonic() < deadline, "no commit in 30 s"
            time.sleep(0.01)
    finally:
        ms.stop()
    spans = ms.obs.spans()
    e2e = _assert_nested(spans)
    assert [s.seq for s in e2e] == [1, 2, 3]
    by = _by_seq(spans)
    for s in e2e:
        assert {"obs.broadcast", "window.hooks"} <= {x.stage
                                                     for x in by[s.seq]}
    assert ms.health.report().last_seq == 3
    assert ms.self_observer.reingested > 0


def test_debug_dump_keys_equal_the_jax_dump():
    for obs in (True, None):
        jms, pms = _jax_system(obs), _port_system(obs)
        try:
            want, got = jms.debug_dump(), pms.debug_dump()
        finally:
            jms.stop()
            pms.stop()
        assert set(got) == set(want)
        for key in ("registry", "rings", "query", "commit", "obs", "labels"):
            assert set(got[key]) == set(want[key]), key
        assert got["obs"]["enabled"] is (obs is True)
        assert got["mesh"] is None and got["commit_path_reason"] is None
        assert json.dumps(got)
        if obs:
            assert got["obs"]["capacity"] == want["obs"]["capacity"] == 4096
            assert set(got["health"]) == set(want["health"])
            assert got["health"]["status"] == "ok"
        else:
            assert got["health"] is None and pms.health is None
    ms = TorchMetricSystem(interval=1.0, sys_stats=False, num_metrics=16,
                           device="cpu")
    jms = TPUMetricSystem(interval=1.0, sys_stats=False, num_metrics=16)
    try:
        assert set(ms.debug_dump()) == set(jms.debug_dump())
    finally:
        ms.stop()
        jms.stop()


def test_spans_dropped_gauge_and_sites_share_one_ring():
    ms = _port_system(port_obs.ObsConfig(capacity=8, dogfood=False,
                                         health=False))
    try:
        rec = ms.obs
        for part in (ms, ms.aggregator, ms.retention, ms.committer):
            assert part.obs_recorder is rec
        assert ms.self_observer is None and ms.health is None
        ms.backfill_retention(_raw_intervals(RawMetricSet, 3))
        gauges = ms.collect_raw_metrics().gauges
        assert gauges["obs.SpansDropped"] == float(rec.dropped) > 0
        assert ms.debug_dump()["obs"]["saturated"] is True
    finally:
        ms.stop()
