"""The port's label layer (``loghisto_tpu_torch.labels``: the canonical
``name;k=v`` model, the selector language, the inverted ``LabelIndex``)
and the lifecycle's label budgets against the JAX package, on the cases
of ``tests/test_labels.py`` and seeded random names and selectors.

Everything here is host strings, ids and integer state: EQUAL.  Window
query percentiles against the JAX wheel: rtol 4e-6 (ROADMAP F1's float32
``exp``), sums rtol 1e-5; the port's serve against its own recompute:
EQUAL.
"""

import datetime as dt

import jax
import numpy as np
import pytest

from loghisto_tpu import labels as jl
from loghisto_tpu.commit import IntervalCommitter as JaxCommitter
from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.lifecycle import LifecycleConfig as JaxLifecycleConfig
from loghisto_tpu.lifecycle import LifecycleManager as JaxLifecycleManager
from loghisto_tpu.lifecycle.policy import decide_victims as jax_decide_victims
from loghisto_tpu.lifecycle.policy import (
    default_overflow_name as jax_default_overflow_name,
)
from loghisto_tpu.parallel.aggregator import TPUAggregator
from loghisto_tpu.registry import MetricRegistry as JaxRegistry
from loghisto_tpu.window import TimeWheel as JaxWheel
from loghisto_tpu_torch import labels as pl
from loghisto_tpu_torch.commit import IntervalCommitter
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.lifecycle import LifecycleConfig, LifecycleManager
from loghisto_tpu_torch.lifecycle.policy import (
    decide_victims,
    default_overflow_name,
)
from loghisto_tpu_torch.metrics import RawMetricSet
from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
from loghisto_tpu_torch.registry import MetricRegistry
from loghisto_tpu_torch.window.store import TimeWheel

BL = 64
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
CANON = "http.latency;code=500;route=/api"
SEED_NAMES = ("http.latency", CANON, "http.latency;code=200;route=/api",
              "db.q")


def _raw(i, histograms=None):
    return RawMetricSet(time=T0 + dt.timedelta(seconds=i), counters={},
                        rates={}, histograms=dict(histograms or {}),
                        gauges={}, duration=1.0)


# -- model -------------------------------------------------------------------


@pytest.mark.parametrize("name,labels", [
    ("http.latency", {"route": "/api", "code": "500"}),
    ("http.latency", {"code": "500", "route": "/api"}),
    ("m", None), ("m", {}), ("a.b", {"k.x": "", "_z": "1"}),
    ("m", {"k": 7}),
])
def test_canonical_name_equals_jax(name, labels):
    got = pl.canonical_name(name, labels)
    assert got == jl.canonical_name(name, labels)
    assert pl.is_labeled(got) == jl.is_labeled(got)


@pytest.mark.parametrize("name,labels", [
    ("m;x", {"k": "v"}), ("m{", {"k": "v"}), ("", {"k": "v"}),
    ("m", {"9bad": "v"}), ("m", {"k": "a;b"}), ("m", {"k": "a b"}),
    ("m", {"k": 'a"b'}), ("m", {"k": "a,b"}),
])
def test_canonical_grammar_rejections_equal_jax(name, labels):
    with pytest.raises(jl.LabelError) as want:
        jl.canonical_name(name, labels)
    with pytest.raises(pl.LabelError) as got:
        pl.canonical_name(name, labels)
    assert str(got.value) == str(want.value)
    assert issubclass(pl.LabelError, ValueError)


NAMES = [CANON, "flat", "weird;notapair", "weird;=v", "a;b=c;d=",
         "x;k=v;k2=v2", "x;k=v;9=2", "http.latency;route=/a,b"]


@pytest.mark.parametrize("name", NAMES)
def test_parse_canonical_equals_jax(name):
    assert pl.parse_canonical(name) == jl.parse_canonical(name)
    assert pl.base_of(name) == jl.base_of(name)
    assert pl.labels_of(name) == jl.labels_of(name)


def test_label_set_equals_jax():
    for labels in ({"b": "2", "a": "1"}, {}, {"route": "/x", "code": 5}):
        got, want = pl.LabelSet(labels), jl.LabelSet(labels)
        assert got.pairs == want.pairs and got.encode() == want.encode()
        assert got.as_dict() == want.as_dict()
        assert hash(got) == hash(pl.LabelSet(dict(reversed(
            list(labels.items())))))
        if labels:
            assert got.apply("m") == want.apply("m")
    assert pl.LabelSet({"a": "1"}) == pl.LabelSet({"a": "1"})
    assert pl.LabelSet({"a": "1"}) != pl.LabelSet({"a": "2"})


SUFFIXES = ("", "_99", "_99.99", "_count", "_agg_count", "_agg_avg",
            "_agg_sum", "_sum", "_avg", "_min", "_max", "_rate", "_50")


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_split_processed_equals_jax(suffix):
    for name in (CANON + suffix, "flat" + suffix, "weird;x" + suffix):
        assert pl.split_processed(name) == jl.split_processed(name), name
    assert pl.split_processed(CANON + suffix)[2] == suffix


# -- selector ----------------------------------------------------------------


SELECTORS = [
    "http.latency{route=/api,code=~5..}", "http.latency{code!=500}",
    "http.latency{code!~5..}", 'http.latency{route="/a,b"}',
    "http.*{route=/api}", "*{route=/api}", "http.latency{}",
    "http.latency{code=~\"\"}", "db.?{shard=3}", "http.latency{ code = 500 }",
    'm{k="a\\"b"}', "[hd]*{code=~[25]0[03]}",
]
MATCH_NAMES = [
    CANON, "http.latency;code=200;route=/api", "http.latency",
    "http.latency;route=/a,b", "http.bytes;route=/api", "db.q;route=/api",
    "db.q;shard=3", "db.qq;shard=3", 'm;k=a"b', "http.latency;code=503",
]


@pytest.mark.parametrize("text", SELECTORS)
def test_selector_matches_like_jax(text):
    got, want = pl.parse_selector(text), jl.parse_selector(text)
    assert (got.base, got.base_is_glob) == (want.base, want.base_is_glob)
    assert [(m.key, m.op, m.value) for m in got.matchers] == [
        (m.key, m.op, m.value) for m in want.matchers]
    assert [(m.key, m.value) for m in got.exact_matchers()] == [
        (m.key, m.value) for m in want.exact_matchers()]
    for name in MATCH_NAMES:
        assert got.match_name(name) == want.match_name(name), (text, name)
    assert pl.is_selector(text) and not pl.is_selector(got.base + "*")


@pytest.mark.parametrize("bad", ["m{", "{k=v}", "m{=v}", "m{k=v", "m;x{k=v}",
                                 "m{k~v}", "m{k=~(}", 'm{k="v}', "plain"])
def test_selector_parse_errors_equal_jax(bad):
    with pytest.raises(jl.SelectorError) as want:
        jl.parse_selector(bad)
    with pytest.raises(pl.SelectorError) as got:
        pl.parse_selector(bad)
    assert str(got.value) == str(want.value)


# -- inverted index ----------------------------------------------------------


def _registries(names=SEED_NAMES, capacity=64):
    p, j = MetricRegistry(capacity), JaxRegistry(capacity)
    for n in names:
        assert p.id_for(n) == j.id_for(n)
    return p, j


def _same_select(pidx, jidx, sel, max_id=None):
    got = pidx.select(sel, max_id=max_id)
    want = jidx.select(sel, max_id=max_id)
    assert got == want, sel
    mids = [m for m, _ in got[1]]
    assert mids == sorted(mids)
    return got


STAT_KEYS = ("generation", "rows", "labeled_rows", "bases", "postings",
             "posting_ids", "selector_cache_entries", "selector_cache_hits",
             "selector_cache_misses", "rebuilds", "tail_scans")


def _same_stats(pidx, jidx):
    got, want = pidx.stats(), jidx.stats()
    assert {k: got[k] for k in STAT_KEYS} == {k: want[k] for k in STAT_KEYS}
    assert pidx.cardinality_by_prefix() == jidx.cardinality_by_prefix()


def test_index_select_postings_and_stats_equal_jax():
    p, j = _registries()
    pidx, jidx = pl.LabelIndex(p), jl.LabelIndex(j)
    rows = _same_select(pidx, jidx, "http.latency{code=500}")[1]
    assert [n for _, n in rows] == [CANON]
    assert len(_same_select(pidx, jidx, "http.latency{}")[1]) == 3
    assert len(_same_select(pidx, jidx, "*{route=/api}")[1]) == 2
    _same_select(pidx, jidx, "http.latency{}", max_id=2)
    _same_stats(pidx, jidx)
    assert pidx.stats()["labeled_rows"] == 2


def test_index_tail_scan_cache_hits_and_generation_flush_equal_jax():
    p, j = _registries()
    pidx, jidx = pl.LabelIndex(p), jl.LabelIndex(j)
    for sel in ("http.latency{}", "http.latency{code=500}",
                "http.latency{code=500}"):
        _same_select(pidx, jidx, sel)
    for reg in (p, j):
        reg.id_for("http.latency;code=503;route=/api")  # a pure append
    assert len(_same_select(pidx, jidx, "http.latency{code=~5..}")[1]) == 2
    _same_stats(pidx, jidx)
    assert pidx.stats()["tail_scans"] == 1
    assert pidx.stats()["selector_cache_hits"] == 1
    for reg in (p, j):
        reg.evict([reg.lookup(CANON)])  # generation bump
    assert _same_select(pidx, jidx, "http.latency{code=500}")[1] == ()
    _same_stats(pidx, jidx)
    assert pidx.stats()["rebuilds"] == 2


def test_index_never_serves_stale_ids_after_slot_reuse():
    p, j = _registries()
    pidx, jidx = pl.LabelIndex(p), jl.LabelIndex(j)
    victim = p.lookup(CANON)
    assert _same_select(pidx, jidx, "http.latency{code=500}")[1][0][0] == \
        victim
    for reg in (p, j):
        reg.evict([victim])
        # the freed slot is reused under an unrelated labeled name
        assert reg.id_for("db.q;shard=3") == victim
    assert _same_select(pidx, jidx, "http.latency{code=500}")[1] == ()
    assert _same_select(pidx, jidx, "db.q{shard=3}")[1] == (
        (victim, "db.q;shard=3"),)


def _random_names(rng, n):
    names = set()
    while len(names) < n:
        base = rng.choice(["rpc.latency", "rpc.bytes", "db.q", "x"])
        labels = {}
        for key, values in (("route", [f"/r{i}" for i in range(6)]),
                            ("code", ["200", "404", "500", "503"]),
                            ("method", ["GET", "PUT"])):
            if rng.random() < 0.7:
                labels[key] = str(rng.choice(values))
        names.add(pl.canonical_name(str(base), labels))
    return sorted(names)


RANDOM_SELECTORS = [
    "rpc.latency{}", "rpc.*{code=~5..}", "*{route=/r3,method!=GET}",
    "rpc.latency{code!~[45]..,route=~/r[0-2]}", "db.q{method=}",
    "x{route!=/r1}", "*{code=200,method=PUT}", "rpc.?ytes{}",
]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_index_equals_jax_and_a_name_filter_under_churn(seed):
    rng = np.random.default_rng(seed)
    names = _random_names(rng, 120)
    p, j = _registries(names[:80], capacity=200)
    pidx, jidx = pl.LabelIndex(p), jl.LabelIndex(j)
    for step in range(4):
        for sel in RANDOM_SELECTORS:
            got = _same_select(pidx, jidx, sel, max_id=150)
            parsed = pl.parse_selector(sel)
            want = tuple(
                (mid, n) for mid, n in enumerate(p.names())
                if n is not None and mid < 150 and parsed.match_name(n))
            assert got[1] == want, sel
        _same_stats(pidx, jidx)
        if step == 0:  # appends
            for reg in (p, j):
                for n in names[80:100]:
                    reg.id_for(n)
        elif step == 1:  # evictions
            victims = sorted(rng.choice(100, 15, replace=False).tolist())
            assert p.evict(victims) == j.evict(victims)
        elif step == 2:  # reuse of freed slots
            for reg in (p, j):
                for n in names[100:]:
                    reg.id_for(n)


# -- wheel selector queries under churn --------------------------------------


def _synchronised(com):
    """Wait for each JAX commit step before the next is staged (ROADMAP
    F3: on the CPU ``jax.device_put`` reads the staging slot after it
    returns)."""
    for attr in ("_fused", "_fused_snap"):
        step = getattr(com, attr)
        setattr(com, attr,
                lambda *a, _step=step: jax.block_until_ready(_step(*a)))
    return com


def _pair(m=16, tiers=((8, 1), (4, 4)), cfg=None):
    """The port's and JAX's committer, aggregator, wheel (with a label
    index over the shared registry) and lifecycle manager."""
    cfg = cfg or {}
    agg = TorchAggregator(num_metrics=m, config=MetricConfig(bucket_limit=BL),
                          device="cpu")
    wheel = TimeWheel(num_metrics=m, config=MetricConfig(bucket_limit=BL),
                      interval=1.0, tiers=tiers, registry=agg.registry,
                      device="cpu")
    wheel.label_index = pl.LabelIndex(agg.registry)
    lc = LifecycleManager(agg, wheel, LifecycleConfig(**cfg))
    port = (IntervalCommitter(agg, wheel, lifecycle=lc), agg, wheel, lc)
    jagg = TPUAggregator(num_metrics=m, config=JaxConfig(bucket_limit=BL),
                         storage="dense")
    jwheel = JaxWheel(num_metrics=m, config=JaxConfig(bucket_limit=BL),
                      interval=1.0, tiers=tiers, registry=jagg.registry,
                      merge_path="jnp")
    jwheel.label_index = jl.LabelIndex(jagg.registry)
    jlc = JaxLifecycleManager(jagg, jwheel, JaxLifecycleConfig(**cfg))
    jax_ = (_synchronised(JaxCommitter(jagg, jwheel, lifecycle=jlc)), jagg,
            jwheel, jlc)
    return port, jax_


def _same_window(got, want):
    assert set(got.metrics) == set(want.metrics)
    assert (got.covered_s, got.slots, got.tier) == (want.covered_s,
                                                    want.slots, want.tier)
    for name, entry in want.metrics.items():
        g = got.metrics[name]
        assert set(g) == set(entry)
        assert g["count"] == entry["count"], name
        for key, value in entry.items():
            rtol = 1e-5 if key in ("sum", "avg") else 4e-6
            np.testing.assert_allclose(g[key], value, rtol=rtol,
                                       err_msg=f"{name} {key}")


@pytest.mark.parametrize("churn", ["evict", "compact", "grow"])
def test_wheel_selector_queries_equal_jax_under_churn(churn):
    port, jax_ = _pair(cfg=dict(check_every=1000,
                                auto_compact_fragmentation=0.0))
    names = [f"http.latency;code={c};route=/api" for c in (200, 500, 503)]
    sel = "http.latency{code=~5..}"
    for i in range(3):
        raw = _raw(i, {n: {j: 2} for j, n in enumerate(names)})
        port[0].commit(raw)
        jax_[0].commit(raw)
    got = port[2].query(sel, window=16.0)
    _same_window(got, jax_[2].query(sel, window=16.0))
    assert set(got.metrics) == set(names[1:])
    if churn == "evict":
        victim = [port[1].registry.lookup(names[1])]
        assert port[3].evict_ids(victim) == jax_[3].evict_ids(victim)
        expect = {names[2]}
    elif churn == "compact":
        victim = [port[1].registry.lookup(names[0])]
        assert port[3].evict_ids(victim) == jax_[3].evict_ids(victim)
        assert port[3].compact() and jax_[3].compact()
        expect = {names[1], names[2]}
    else:  # a labeled row appended after the first query
        expect = {names[1], names[2], "http.latency;code=599;route=/api"}
    raw = _raw(3, {n: {1: 1} for n in expect})
    port[0].commit(raw)
    jax_[0].commit(raw)
    assert port[1].registry.names() == jax_[1].registry.names()
    res = port[2].query(sel, window=16.0)
    _same_window(res, jax_[2].query(sel, window=16.0))
    assert set(res.metrics) == expect
    ref = port[2]._query_recompute(sel, 16.0, tuple(port[2].percentiles),
                                   res.tier)
    assert res.metrics == ref.metrics


def test_selector_without_an_index_raises_on_every_path():
    wheel = TimeWheel(num_metrics=4, config=MetricConfig(bucket_limit=BL),
                      tiers=((2, 1),), device="cpu")
    wheel.push(_raw(0, {"a;k=v": {1: 1}}))
    for call in (lambda: wheel.query("a{k=v}", 1.0),
                 lambda: wheel.query_group_by("a{k=v}", by=["k"],
                                              window=1.0)):
        with pytest.raises(ValueError, match="needs a LabelIndex"):
            call()
    # the recompute oracle reads no index
    assert set(wheel._query_recompute("a{k=v}", 1.0, (0.5,), 0).metrics) == {
        "a;k=v"}


# -- lifecycle: label budgets ------------------------------------------------


def test_default_overflow_name_strips_the_label_tail_like_jax():
    for name in (CANON, "api.u1.lat", "http.latency", "x;k=v"):
        assert default_overflow_name(name) == jax_default_overflow_name(name)
    assert default_overflow_name(CANON) == "_overflow.http"


@pytest.mark.parametrize("budgets", [{"http.*": 2}, {"http.lat": 0},
                                     {"http.lat": 1, "db.*": 0}])
def test_decide_victims_label_budgets_equal_jax(budgets):
    names = ["http.lat", "http.lat;u=1", "http.lat;u=2", "http.lat;u=3",
             "http.bytes;u=1", "db.q;u=1", None, "db.q"]
    la = [0, 1, 2, 3, 0, 0, 0, 5]
    got = decide_victims(names, la, 10, LifecycleConfig(
        label_budgets=budgets))
    want = jax_decide_victims(names, la, 10, JaxLifecycleConfig(
        label_budgets=budgets))
    assert got == want
    assert 0 not in got and 7 not in got  # flat rows are exempt


def test_label_budget_eviction_equals_jax_and_folds_count_exact():
    cfg = dict(label_budgets={"http.latency": 2}, check_every=1,
               auto_compact_fragmentation=0.0)
    port, jax_ = _pair(m=32, cfg=cfg)
    total = 0
    for i in range(6):
        raw = _raw(i, {"http.latency": {0: 3},
                       f"http.latency;route=/r{i}": {i - 2: 5}})
        port[0].commit(raw)
        jax_[0].commit(raw)
        total += 8
        assert port[1].registry.names() == jax_[1].registry.names()
        np.testing.assert_array_equal(port[1]._acc.numpy(),
                                      np.asarray(jax_[1]._acc))
        for key in ("evicted_series", "overflowed_samples", "evictions"):
            assert getattr(port[3], key) == getattr(jax_[3], key), key
    reg = port[1].registry
    live = [n for n in reg.names() if n and n.startswith("http.latency;")]
    assert len(live) == 2 and reg.lookup("http.latency") is not None
    acc = port[1]._acc.numpy()
    assert int(acc[reg.lookup("_overflow.http")].sum()) == \
        port[3].overflowed_samples > 0
    assert int(acc.sum()) == total
    sel = "http.latency{route=~/r.}"
    _same_window(port[2].query(sel, window=8.0),
                 jax_[2].query(sel, window=8.0))
