"""The port's group_by rollup (``ops/stats.make_group_query_fn``,
``TimeWheel.query_group_by``, ``TorchMetricSystem.query_group_by``) and
selector queries against the JAX package on the same seeded inputs, and
against the float64 host merge oracle ``labels.groupby.merge_groups_host``,
at small sizes (M <= 64, bucket_limit 64).

Tolerances:
  * group keys, sizes, counts, merged CDF rows, selected buckets: EQUAL;
  * against JAX: percentile values and equi-depth edges rtol 4e-6 (JAX's
    representatives come from XLA's float32 ``exp``, ROADMAP F1), sums
    rtol 1e-6 (float32 sums added in another order);
  * against ``merge_groups_host`` with the port's own float32
    representative table: percentiles and edges EQUAL, sums rtol 1e-5
    (float32 device sums against a float64 dot);
  * the frontend's labeled rows: EQUAL to the JAX ``MetricSystem``'s.
"""

import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loghisto_tpu.commit import IntervalCommitter as JaxCommitter
from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.labels import LabelIndex as JaxLabelIndex
from loghisto_tpu.metrics import MetricSystem as JaxMetricSystem
from loghisto_tpu.ops.stats import make_group_query_fn as jax_group_fn
from loghisto_tpu.parallel.aggregator import TPUAggregator
from loghisto_tpu.window import TimeWheel as JaxWheel
from loghisto_tpu_torch import TorchMetricSystem
from loghisto_tpu_torch.commit import IntervalCommitter
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.labels import LabelIndex
from loghisto_tpu_torch.labels.groupby import (
    assign_groups,
    equidepth_ranks,
    group_key_for,
    merge_groups_host,
    pct_key,
)
from loghisto_tpu_torch.metrics import MetricSystem, RawMetricSet
from loghisto_tpu_torch.ops.stats import (
    bucket_representatives,
    dense_cdf,
    make_group_query_fn,
)
from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
from loghisto_tpu_torch.window.store import TimeWheel

BL = 64
B = 2 * BL + 1
M = 64
TIERS = ((8, 1), (4, 4))
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
PS = (0.0, 0.5, 0.9, 0.99, 1.0)
ROUTES = ["/a", "/b", "/c"]
CODES = ["200", "404", "500", "503"]
NAMES = ["http.latency"] + [
    f"http.latency;code={c};route={r}" for r in ROUTES for c in CODES
] + ["http.latency;route=/d", "db.q;route=/a", "db.q"]
SELECTORS = ["http.latency{}", "http.latency{code=~5..}",
             "*{route=/a}", "http.*{code!=200,route!~/[bc]}", "db.q"]
BYS = [("route",), ("route", "code"), ("code",), ("zone",)]


def _reps():
    return bucket_representatives(BL).numpy()


def _value_of(b):
    return _reps()[np.asarray(b) + BL]


# -- make_group_query_fn -----------------------------------------------------


def _group_inputs(seed, rows=64, groups=5):
    rng = np.random.default_rng(seed)
    acc = rng.integers(0, 40, (rows, B)).astype(np.int32)
    acc[rng.random((rows, B)) < 0.8] = 0
    acc[3] = 0  # one empty row
    ids = rng.permutation(rows)[: rows - 3].astype(np.int32)
    gids = rng.integers(0, groups, len(ids)).astype(np.int32)
    return acc, ids, gids


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_group_query_fn_equals_jax(seed):
    acc, ids, gids = _group_inputs(seed)
    ps = np.asarray([0.0, 0.25, 0.5, 0.9, 0.99, 1.0], np.float32)
    snap = dense_cdf(torch.from_numpy(acc), BL)
    got = make_group_query_fn(BL)(snap["cdf"], snap["counts"], snap["sums"],
                                  ids, gids, ps, num_groups=8)
    # JAX's rollup on the port's payload (the same CDF rows and sums)
    jc, jn, js = (jnp.asarray(snap[k].numpy()) for k in ("cdf", "counts",
                                                         "sums"))
    want = jax_group_fn(BL)(jc, jn, js, jnp.asarray(ids), jnp.asarray(gids),
                            jnp.asarray(ps), num_groups=8)
    np.testing.assert_array_equal(got["counts"].numpy(),
                                  np.asarray(want["counts"]))
    np.testing.assert_allclose(got["sums"].numpy(), np.asarray(want["sums"]),
                               rtol=1e-6)
    np.testing.assert_allclose(got["percentiles"].numpy(),
                               np.asarray(want["percentiles"]), rtol=4e-6)
    # the merged CDF rows are the CDFs of the merged histograms, equal to
    # JAX's segment sum; the selected buckets decode to the values
    merged = np.zeros((8, B), np.int64)
    np.add.at(merged, gids, acc[ids].astype(np.int64))
    want_cdf = np.asarray(jax.ops.segment_sum(jc[ids], gids, num_segments=8))
    np.testing.assert_array_equal(np.cumsum(merged, axis=1), want_cdf)
    np.testing.assert_array_equal(got["counts"].numpy(), merged.sum(1))
    reps = _reps()
    pct = got["percentiles"].numpy()
    nonempty = merged.sum(1) > 0
    np.testing.assert_array_equal(pct[nonempty],
                                  reps[got["buckets"].numpy()][nonempty])
    assert not pct[~nonempty].any()


def test_group_query_fn_follows_the_tensor_device():
    acc, ids, gids = _group_inputs(4)
    snap = dense_cdf(torch.from_numpy(acc), BL)
    out = make_group_query_fn(BL)(snap["cdf"], snap["counts"], snap["sums"],
                                  ids, gids, [0.5], num_groups=8)
    assert all(t.device.type == "cpu" for t in out.values())
    assert out["counts"].dtype == torch.int32
    assert out["percentiles"].shape == (8, 1)


# -- wheels fed the same intervals -------------------------------------------


def _intervals(n, seed, names=NAMES, start=0):
    """Seeded RawMetricSets over the labeled names (positive buckets, so
    float32 sums do not cancel)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(start, start + n):
        hists = {}
        for name in names:
            if rng.random() < 0.15:
                continue
            k = int(rng.integers(1, 10))
            buckets = rng.integers(0, BL + 4, k)
            counts = rng.integers(1, 300, k)
            hists[name] = {int(b): int(c) for b, c in zip(buckets, counts)}
        out.append(RawMetricSet(time=T0 + dt.timedelta(seconds=i),
                                counters={}, rates={}, histograms=hists,
                                gauges={}, duration=1.0, seq=i + 1))
    return out


def _wheels(pins=(3.0,)):
    jw = JaxWheel(num_metrics=M, config=JaxConfig(bucket_limit=BL),
                  interval=1.0, tiers=TIERS, merge_path="jnp")
    pw = TimeWheel(num_metrics=M, config=MetricConfig(bucket_limit=BL),
                   interval=1.0, tiers=TIERS, device="cpu")
    jw.label_index = JaxLabelIndex(jw.registry)
    pw.label_index = LabelIndex(pw.registry)
    for w in pins:
        jw.pin_window(w)
        pw.pin_window(w)
    return jw, pw


@pytest.fixture(scope="module")
def pushed():
    """Both wheels after 14 identical intervals (tier 0 wraps), with the
    merged histograms of every interval for the host oracle."""
    jw, pw = _wheels()
    raws = _intervals(14, seed=5)
    for raw in raws:
        jw.push(raw)
        pw.push(raw)
    return jw, pw, raws


def _merged(raws, names=None):
    out = {}
    for raw in raws:
        for name, hist in raw.histograms.items():
            if names is not None and name not in names:
                continue
            dst = out.setdefault(name, {})
            for b, c in hist.items():
                b = int(np.clip(b, -BL, BL))
                dst[b] = dst.get(b, 0) + c
    return out


def _same_groups(got, want, sums_rtol=1e-6):
    assert (got.window_s, got.covered_s, got.tier, got.slots, got.by) == (
        want.window_s, want.covered_s, want.tier, want.slots, want.by)
    assert list(got.groups) == list(want.groups)  # the same order
    assert got.sizes == want.sizes
    for gk, entry in want.groups.items():
        g = got.groups[gk]
        assert set(g) == set(entry)
        assert g["count"] == entry["count"], gk
        np.testing.assert_allclose(g["sum"], entry["sum"], rtol=sums_rtol)
        for key, value in entry.items():
            if key not in ("count", "sum", "avg"):
                np.testing.assert_allclose(g[key], value, rtol=4e-6,
                                           err_msg=f"{gk} {key}")


@pytest.mark.parametrize("by", BYS)
@pytest.mark.parametrize("selector", SELECTORS)
def test_group_by_equals_jax_wheel(pushed, selector, by):
    jw, pw, _ = pushed
    for window, depth in ((None, None), (3.0, 4), (1e9, 3)):
        got = pw.query_group_by(selector, by=by, window=window,
                                percentiles=PS, depth=depth)
        want = jw.query_group_by(selector, by=by, window=window,
                                 percentiles=PS, depth=depth)
        _same_groups(got, want)


@pytest.mark.parametrize("selector", SELECTORS)
def test_selector_query_equals_jax_wheel(pushed, selector):
    jw, pw, _ = pushed
    for window in (3.0, None):
        got = pw.query(selector, window, percentiles=PS)
        want = jw.query(selector, window, percentiles=PS)
        assert set(got.metrics) == set(want.metrics)
        for name, entry in want.metrics.items():
            assert got.metrics[name]["count"] == entry["count"]
            for key in entry:
                rtol = 1e-5 if key in ("sum", "avg") else 4e-6
                np.testing.assert_allclose(got.metrics[name][key],
                                           entry[key], rtol=rtol)
        oracle = pw._query_recompute(selector, got.window_s, PS, got.tier)
        assert got.metrics == oracle.metrics


@pytest.mark.parametrize("by", BYS)
def test_group_by_equals_the_host_merge_oracle(pushed, by):
    _, pw, raws = pushed
    for selector in ("http.latency{}", "*{code=~5..}"):
        sel = pw._resolve_matches(selector)[1]
        names = {n for _, n in sel}
        gs = pw.query_group_by(selector, by=by, window=1e9, percentiles=PS,
                               depth=4)
        ranks = equidepth_ranks(4)
        oracle = merge_groups_host(_merged(raws, names), by, PS + ranks,
                                   MetricConfig().precision,
                                   value_of=_value_of)
        assert set(gs.groups) == set(oracle)
        for gk, ref in oracle.items():
            got = gs.groups[gk]
            assert got["count"] == ref["count"]
            np.testing.assert_allclose(got["sum"], ref["sum"], rtol=1e-5)
            for p in PS:
                assert got[pct_key(p)] == ref[pct_key(p)], (gk, p)
            assert got["edges"] == [ref[pct_key(p)] for p in ranks]
        keys, gids = assign_groups(sel, by)
        assert list(gs.groups) == [k for k in keys if k in gs.groups]
        assert gs.sizes == {k: gids.count(i) for i, k in enumerate(keys)
                            if k in gs.groups}
        assert all(group_key_for(n, by) in gs.groups for n in names
                   if any(n in r.histograms for r in raws))


def test_depth_edges_are_the_percentiles_at_j_over_depth(pushed):
    _, pw, _ = pushed
    for depth in (2, 4, 7):
        gs = pw.query_group_by("http.latency{}", by=["route"], window=1e9,
                               percentiles=(), depth=depth)
        ref = pw.query_group_by("http.latency{}", by=["route"], window=1e9,
                                percentiles=equidepth_ranks(depth))
        for gk, entry in gs.groups.items():
            assert len(entry["edges"]) == depth - 1
            assert entry["edges"] == [ref.groups[gk][pct_key(p)]
                                      for p in equidepth_ranks(depth)]
    with pytest.raises(ValueError, match="depth >= 2"):
        pw.query_group_by("http.latency{}", by=["route"], depth=1)
    with pytest.raises(ValueError, match="at least one label key"):
        pw.query_group_by("http.latency{}", by=[])


def test_warm_repeat_serves_the_cached_result_without_device_work():
    jw, pw = _wheels()
    for raw in _intervals(4, seed=9):
        pw.push(raw)
    args = dict(by=["route"], window=1e9, percentiles=(0.5,), depth=4)
    first = pw.query_group_by("http.latency{}", **args)
    serves, hits = pw.query_group_serves, pw.query_result_cache_hits
    fetched = pw.query_rows_fetched
    again = pw.query_group_by("http.latency{}", **args)
    assert again is first
    assert pw.query_group_serves == serves
    assert pw.query_rows_fetched == fetched
    assert pw.query_result_cache_hits == hits + 1
    # another depth is another result; a push invalidates the epoch
    pw.query_group_by("http.latency{}", **{**args, "depth": 3})
    assert pw.query_group_serves == serves + 1
    pw.push(_intervals(1, seed=10, start=4)[0])
    assert pw.query_group_by("http.latency{}", **args) is not first
    assert pw.query_group_serves == serves + 2


def test_unpinned_window_falls_back_once_then_serves_from_the_snapshot():
    jw, pw = _wheels(pins=())
    raws = _intervals(5, seed=11)
    for raw in raws:
        jw.push(raw)
        pw.push(raw)
    args = dict(by=["code"], window=2.0, percentiles=PS)
    fb = pw.query_fallbacks
    got = pw.query_group_by("http.latency{}", **args)
    _same_groups(got, jw.query_group_by("http.latency{}", **args))
    assert pw.query_fallbacks == fb + 1 and got.groups
    assert 2.0 in pw.pinned_windows()
    names = {n for _, n in pw._resolve_matches("http.latency{}")[1]}
    oracle = merge_groups_host(_merged(raws[-2:], names), ["code"], PS,
                               MetricConfig().precision, value_of=_value_of)
    assert {k: v["count"] for k, v in got.groups.items()} == {
        k: v["count"] for k, v in oracle.items()}
    raw = _intervals(1, seed=12, start=5)[0]
    jw.push(raw)
    pw.push(raw)
    served = pw.query_group_by("http.latency{}", **args)
    assert pw.query_fallbacks == fb + 1  # the pin took
    _same_groups(served, jw.query_group_by("http.latency{}", **args))


def test_fused_commit_group_by_equals_jax():
    """The fused commit path (the system's default with retention)."""
    cfg, jcfg = MetricConfig(bucket_limit=BL), JaxConfig(bucket_limit=BL)
    agg = TorchAggregator(num_metrics=M, config=cfg, device="cpu")
    pw = TimeWheel(num_metrics=M, config=cfg, interval=1.0, tiers=TIERS,
                   registry=agg.registry, device="cpu")
    pw.label_index = LabelIndex(agg.registry)
    com = IntervalCommitter(agg, pw, chunk=16)
    jagg = TPUAggregator(num_metrics=M, config=jcfg, storage="dense")
    jw = JaxWheel(num_metrics=M, config=jcfg, interval=1.0, tiers=TIERS,
                  registry=jagg.registry, merge_path="jnp")
    jw.label_index = JaxLabelIndex(jagg.registry)
    jcom = JaxCommitter(jagg, jw, chunk=16)
    for attr in ("_fused", "_fused_snap"):  # ROADMAP F3
        step = getattr(jcom, attr)
        setattr(jcom, attr,
                lambda *a, _step=step: jax.block_until_ready(_step(*a)))
    for raw in _intervals(6, seed=13):
        assert com.commit(raw) == "fused"
        jcom.commit(raw)
    for selector in SELECTORS[:3]:
        for by in BYS[:2]:
            _same_groups(
                pw.query_group_by(selector, by=by, percentiles=PS, depth=4),
                jw.query_group_by(selector, by=by, percentiles=PS, depth=4))


# -- the system and its frontend ---------------------------------------------


def test_frontend_labeled_calls_land_on_the_canonical_row_like_jax():
    canon = "http.latency;code=500;route=/api"
    systems = [JaxMetricSystem(interval=1e6, sys_stats=False),
               MetricSystem(interval=1e6, sys_stats=False)]
    raws = []
    for ms in systems:
        ms.histogram("http.latency", 3.0,
                     labels={"route": "/api", "code": "500"})
        ms.histogram("http.latency", 4.0,
                     labels={"code": "500", "route": "/api"})
        ms.histogram_batch("http.latency", [5.0, 6.0],
                           labels={"code": "500", "route": "/api"})
        ms.counter("hits", 2, labels={"route": "/api"})
        ms.counter_handle("hits", labels={"route": "/api"}).add(3)
        ms.recorder("http.latency", labels={"code": "500",
                                            "route": "/api"}).record(7.0)
        with ms.start_timer("step", labels={"phase": "fwd"}):
            pass
        timer = ms.timer("step", labels={"phase": "fwd"})
        timer.stop(timer.start())
        raws.append(ms.collect_raw_metrics())
    want, got = raws
    assert got.histograms[canon] == want.histograms[canon]
    assert sum(got.histograms[canon].values()) == 5
    assert got.counters == want.counters
    assert got.counters["hits;route=/api"] == 5
    assert sum(got.histograms["step;phase=fwd"].values()) == 2
    assert set(got.histograms) == set(want.histograms)
    assert systems[1].process_metrics(got).metrics.keys() == \
        systems[0].process_metrics(got).metrics.keys()


def test_frontend_handles_are_cached_per_label_set():
    ms = MetricSystem(interval=1e6, sys_stats=False)
    r1 = ms.recorder("http.latency", labels={"route": "/a", "code": "1"})
    r2 = ms.recorder("http.latency", labels={"code": "1", "route": "/a"})
    assert r1 is r2
    assert r1 is not ms.recorder("http.latency", labels={"route": "/b"})
    assert r1.name == "http.latency;code=1;route=/a"
    c1 = ms.counter_handle("hits", labels={"route": "/a"})
    assert c1 is ms.counter_handle("hits", labels={"route": "/a"})
    t1 = ms.timer("step", labels={"phase": "fwd"})
    assert t1 is ms.timer("step", labels={"phase": "fwd"})
    assert ms.recorder("flat") is not ms.recorder("flat")  # unlabeled: fresh
    with pytest.raises(ValueError, match="invalid label key"):
        ms.histogram("m", 1.0, labels={"9bad": "v"})


def test_system_records_labels_and_serves_group_by():
    ms = TorchMetricSystem(interval=1.0, num_metrics=M, device="cpu",
                           sys_stats=False,
                           config=MetricConfig(bucket_limit=BL),
                           retention=TIERS)
    assert ms.commit_path == "fused"
    assert ms.retention.label_index is ms.label_index
    rng = np.random.default_rng(14)
    raws = []
    for i in range(4):
        for r in ROUTES:
            for c in CODES:
                ms.histogram_batch("rpc.latency",
                                   rng.lognormal(-1.5, 0.5, 30),
                                   labels={"route": r, "code": c})
        ms.recorder("rpc.latency", labels={"route": "/a"}).record(0.2)
        raw = ms.collect_raw_metrics()
        raws.append(raw)
        ms.backfill_retention([raw])
    gs = ms.query_group_by("rpc.latency{}", by=["route"], window=1e9,
                           percentiles=PS, depth=4)
    names = {n for n in ms.aggregator.registry.names()
             if n and n.startswith("rpc.latency;")}
    oracle = merge_groups_host(_merged(raws, names), ["route"],
                               PS + equidepth_ranks(4),
                               MetricConfig().precision, value_of=_value_of)
    assert gs.sizes == {("/a",): 5, ("/b",): 4, ("/c",): 4}
    for gk, ref in oracle.items():
        assert gs.groups[gk]["count"] == ref["count"]
        assert [gs.groups[gk][pct_key(p)] for p in PS] == [
            ref[pct_key(p)] for p in PS]
    res = ms.query("rpc.latency{route=/a,code!=200}", window=1e9)
    assert set(res.metrics) == {"rpc.latency;route=/a"} | {
        f"rpc.latency;code={c};route=/a" for c in CODES[1:]}
    assert ms.query_window("rpc.latency{route=/b}", 1e9).metrics.keys() == \
        ms.query("rpc.latency{route=/b}", 1e9).metrics.keys()
    gauges = ms.collect_raw_metrics().gauges
    assert gauges["commit.query_GroupByServed"] == 1.0
    assert gauges["labels.LiveLabelSets"] == 13.0
    assert gauges["labels.IndexRebuilds"] == 1.0
    ms.stop()
