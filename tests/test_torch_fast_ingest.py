"""``MetricSystem(fast_ingest=True)`` of the port against the JAX
package's, on the same recorded values and counters.

Both fold the C staging buffers with the same float64 host codec and
statistics, so raw sets (histograms, counters, rates) and processed
metric sets are EQUAL; timers measure the host clock, so they are held
by count only.  No test asserts a time: durations are checked to be
non-negative integers.  Writer threads are explicit (4 or 8) and every
join has a timeout.
"""

import threading

import numpy as np
import pytest

import loghisto_tpu_torch as lh
from loghisto_tpu.metrics import MetricSystem as JaxMetricSystem
from loghisto_tpu_torch import _native
from loghisto_tpu_torch.metrics import (
    FastCounter,
    FastRecorder,
    FastTimer,
    FastTimerToken,
    MetricSystem,
)


@pytest.fixture(autouse=True)
def _fastpath_built():
    assert _native.fastpath_available(), _native.fastpath_error()


def _pair(**kw):
    jax_ms = JaxMetricSystem(sys_stats=False, fast_ingest=True, **kw)
    port = MetricSystem(sys_stats=False, fast_ingest=True, **kw)
    assert jax_ms._fast_record is not None and port._fast_record is not None
    return jax_ms, port


def _record(ms, rng, interval):
    """One interval through every fast entry point and the Python ones
    beside them."""
    vals = rng.lognormal(3, 1, 2000) * np.where(rng.random(2000) < 0.1,
                                                 -1, 1)
    for v in vals[:1500]:
        ms.histogram("h", float(v))
    rec = ms.recorder("rec")
    for v in vals[1500:]:
        rec.record(float(v))
    ms.recorder("lab", labels={"route": "/a"}).record(float(vals[0]))
    ms.histogram("lab", 2.0, labels={"route": "/b"})
    ms.histogram_batch("batch", vals[:100])  # the Python shards
    ms.counter("reqs", 10 + interval)
    ms.counter("reqs", 5)
    ms.counter("zero", 0)  # amount 0 still makes the rate entry
    ms.counter("big", (1 << 53) + 1)  # past 2^31: the exact Python path
    ms.counter("frac", 0.5)  # non-int: the Python path
    handle = ms.counter_handle("handle")
    handle.add(7)
    handle.add((1 << 31) + 1)  # past the window: counter()
    ms.counter_handle("handle", labels={"k": "v"}).add(3)


def _same_interval(jax_ms, port, want, got):
    assert got.counters == want.counters
    assert got.rates == want.rates
    assert got.histograms == want.histograms
    pw, pg = jax_ms.process_metrics(want), port.process_metrics(got)
    jax_ms._attach_aggregates(pw, want)
    port._attach_aggregates(pg, got)
    assert pg.metrics == pw.metrics
    return got, pg.metrics


def test_fast_ingest_matches_jax_over_intervals():
    jax_ms, port = _pair()
    rng_j, rng_p = np.random.default_rng(1), np.random.default_rng(1)
    for interval in range(3):
        _record(jax_ms, rng_j, interval)
        _record(port, rng_p, interval)
        raw, got = _same_interval(jax_ms, port,
                                  jax_ms.collect_raw_metrics(),
                                  port.collect_raw_metrics())
        assert got["h_count"] == 1500 and got["rec_count"] == 500
        assert got["reqs_rate"] == 15 + interval
        assert got["zero_rate"] == 0
        # the lifetime counter store stays integer-exact
        assert raw.counters["big"] == ((1 << 53) + 1) * (interval + 1)
        assert raw.counters["handle"] == (7 + (1 << 31) + 1) * (interval + 1)
    assert port._fast_dropped_total == port._fast_counter_dropped_total == 0


def test_fast_ingest_matches_the_python_path():
    fast = MetricSystem(sys_stats=False, fast_ingest=True)
    slow = MetricSystem(sys_stats=False)
    for ms in (fast, slow):
        _record(ms, np.random.default_rng(2), 0)
    want, got = slow.collect_raw_metrics(), fast.collect_raw_metrics()
    assert got.histograms == want.histograms
    assert got.counters == want.counters and got.rates == want.rates


def test_handles_are_the_fast_ones_and_timers_count():
    jax_ms, port = _pair()
    assert isinstance(port.recorder("r"), FastRecorder)
    assert isinstance(port.counter_handle("c"), FastCounter)
    assert isinstance(port.timer("t"), FastTimer)
    assert isinstance(port.start_timer("t"), FastTimerToken)
    assert lh.FastTimerToken is FastTimerToken
    for ms in (jax_ms, port):
        timer = ms.timer("t")
        for _ in range(5):
            d = timer.stop(timer.start())
            assert isinstance(d, int) and d >= 0
        tok = ms.start_timer("tok")
        assert tok.stop() >= 0
        with ms.start_timer("tok"):
            pass
        ms.start_timer("tok").Stop()
        ms.timer("t", labels={"op": "x"}).stop(ms.timer("t").start())
    want = jax_ms.process_metrics(jax_ms.collect_raw_metrics()).metrics
    got = port.process_metrics(port.collect_raw_metrics()).metrics
    assert set(got) == set(want)
    for key in ("t_count", "tok_count", "t;op=x_count"):
        assert got[key] == want[key]
    assert (got["t_count"], got["tok_count"]) == (5, 3)


def test_labeled_handles_and_partials_are_cached():
    _, port = _pair()
    assert port.recorder("x", labels={"a": "1", "b": "2"}) is port.recorder(
        "x", labels={"b": "2", "a": "1"})
    assert port._fast_record_partial("x") is port._fast_record_partial("x")
    assert port._fast_stop_partial("x") is port._fast_stop_partial("x")
    assert port._fast_add_partial("x") is port._fast_add_partial("x")
    # a swapped staging buffer gets a fresh binding at the next handle
    old = port._fast_record_partial("x")
    port._fast_buf = port._fastpath.create(64)
    assert port._fast_record_partial("x") is not old
    port.recorder("x").record(1.0)
    assert sum(port.collect_raw_metrics().histograms["x"].values()) == 1


@pytest.mark.parametrize("kind", ["histogram", "recorder", "timer",
                                  "counter", "counter_handle"])
def test_small_buffers_fold_before_they_fill(kind):
    """With a 2000-slot buffer and a fold threshold of 1000, 20,000
    records fold on the way and none is shed."""
    jax_ms, port = _pair(interval=3600)
    n = 20_000
    for ms in (jax_ms, port):
        ms._fast_fold_threshold = 1000
        ms._fast_buf = ms._fastpath.create(2000)
        ms._fast_counter_buf = ms._fastpath.create(2000)
        if kind == "histogram":
            for i in range(n):
                ms.histogram("x", float(i % 97))
        elif kind == "recorder":
            rec = ms.recorder("x")
            for i in range(n):
                rec.record(float(i % 97))
        elif kind == "timer":
            timer = ms.timer("x")
            for _ in range(n):
                timer.stop(timer.start())
        elif kind == "counter":
            for _ in range(n):
                ms.counter("x", 1)
        else:
            handle = ms.counter_handle("x")
            for _ in range(n):
                handle.add(1)
    want, got = jax_ms.collect_raw_metrics(), port.collect_raw_metrics()
    if kind.startswith("counter"):
        assert got.counters == want.counters == {"x": n}
    else:
        assert sum(got.histograms["x"].values()) == n
        if kind != "timer":
            assert got.histograms == want.histograms
    assert port._fast_dropped_total == port._fast_counter_dropped_total == 0


def test_concurrent_writers_exact():
    """8 threads over 1,000 names, through the fast histogram, recorder,
    counter and counter-handle paths: every name's count and every
    counter exact."""
    ms = MetricSystem(sys_stats=False, fast_ingest=True)
    names = [f"n{i}" for i in range(1000)]
    per = 4000

    def writer(k):
        rng = np.random.default_rng(k)
        rec = {n: ms.recorder(n) for n in names[k::8]}
        cnt = ms.counter_handle(f"c{k % 3}")
        for i, v in enumerate(rng.lognormal(3, 1, per)):
            name = names[(k * per + i) % 1000]
            if i % 2:
                ms.histogram(name, float(v))
            else:
                rec.get(name, ms.recorder(name)).record(float(v))
            if i % 3:
                cnt.add(2)
            else:
                ms.counter(f"c{k % 3}", 1)

    threads = [threading.Thread(target=writer, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    raw = ms.collect_raw_metrics()
    counts = {n: sum(h.values()) for n, h in raw.histograms.items()}
    assert sum(counts.values()) == 8 * per
    want = np.bincount([(k * per + i) % 1000 for k in range(8)
                        for i in range(per)], minlength=1000)
    assert [counts.get(n, 0) for n in names] == want.tolist()
    adds = sum(2 if i % 3 else 1 for i in range(per))
    assert raw.counters == {"c0": 3 * adds, "c1": 3 * adds, "c2": 2 * adds}
