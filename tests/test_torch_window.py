"""The port's retention path — K5's plain version, the window statistics,
the TimeWheel, its snapshot engine, the rules and the carried-over state
— against the JAX package on the same seeded inputs, at small sizes
(M <= 32, bucket_limit 64, tiers (4, 1), (3, 2), (2, 6)).

Tolerances:
  * rings, CDFs, counts, slot metadata, counter totals: EQUAL;
  * percentile buckets: EQUAL; percentile values rtol 4e-6 (JAX takes
    representatives from XLA's float32 ``exp``, up to 1.4e-6 off the
    correctly rounded float32 the port uses — ROADMAP F1);
  * sums: rtol 1e-5 (float32 matvecs in another summation order);
  * the port's snapshot serve against its own recompute: EQUAL.
"""

import datetime as dt

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.ops.stats import dense_cdf as jax_dense_cdf
from loghisto_tpu.ops.window import (
    window_merge as jax_window_merge,
    window_merge_pallas,
    window_snapshot as jax_window_snapshot,
    window_stats as jax_window_stats,
)
from loghisto_tpu.window import rules as jax_rules
from loghisto_tpu.window.store import TimeWheel as JaxWheel
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.metrics import RawMetricSet
from loghisto_tpu_torch.ops.backend import kernel_launches
from loghisto_tpu_torch.ops.codec import compress_np
from loghisto_tpu_torch.ops.stats import dense_cdf
from loghisto_tpu_torch.ops.window import (
    MAX_WINDOW_SLOTS,
    resolve_merge_path,
    window_merge,
    window_merge_kernel,
    window_snapshot,
    window_stats,
)
from loghisto_tpu_torch.state import wheel_state_from_jax
from loghisto_tpu_torch.window import rules
from loghisto_tpu_torch.window.store import TimeWheel

BL = 64
B = 2 * BL + 1
M = 16
TIERS = ((4, 1), (3, 2), (2, 6))
NAMES = [f"svc.m{i}" for i in range(6)] + ["db.q0", "db.q1"]
PS = (0.0, 0.5, 0.9, 0.99, 1.0)


# -- K5 and the window statistics ------------------------------------------


def _ring(s, m, seed, high=50):
    rng = np.random.default_rng(seed)
    ring = rng.integers(0, high, (s, m, B)).astype(np.int32)
    ring[rng.random((s, m, B)) < 0.7] = 0
    return ring


def _mask(kind, s, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "all":
        return np.ones(s, bool)
    if kind == "empty":
        return np.zeros(s, bool)
    if kind == "single":
        m = np.zeros(s, bool)
        m[s // 2] = True
        return m
    if kind == "wrapped":  # a trailing window that wraps past slot 0
        m = np.zeros(s, bool)
        m[[s - 2, s - 1, 0, 1]] = True
        return m
    return rng.random(s) < 0.5


MASKS = ["all", "empty", "single", "wrapped", "random"]


@pytest.mark.parametrize("kind", MASKS)
def test_window_merge_equals_jax(kind):
    ring = _ring(7, 13, seed=1)
    mask = _mask(kind, 7, seed=2)
    want = np.asarray(jax_window_merge(jnp.asarray(ring), jnp.asarray(mask)))
    got = window_merge(torch.from_numpy(ring), mask)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version on a CPU ring, counting nothing
    before = kernel_launches()["window_merge"]
    got_k = window_merge_kernel(torch.from_numpy(ring), torch.from_numpy(mask))
    assert kernel_launches()["window_merge"] == before
    np.testing.assert_array_equal(got_k.numpy(), want)
    assert got_k.data_ptr() != torch.from_numpy(ring).data_ptr()


def test_window_merge_wraps_int32_like_jax():
    ring = np.zeros((3, 2, B), np.int32)
    ring[:2, 0, 5] = (1 << 30) + 5          # two slots: -2^31 + 10
    ring[:, 1, 7] = np.iinfo(np.int32).max   # three slots wrap further
    mask = np.ones(3, bool)
    want = np.asarray(jax_window_merge(jnp.asarray(ring), jnp.asarray(mask)))
    got = window_merge(torch.from_numpy(ring), mask).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 5] == -(1 << 31) + 10


def test_window_merge_equals_pallas_interpret():
    """One interpret-mode call of the TPU kernel (S=5, M=13, B=129)."""
    ring = _ring(5, 13, seed=3)
    mask = _mask("random", 5, seed=4)
    want = np.asarray(window_merge_pallas(
        jnp.asarray(ring), jnp.asarray(mask), interpret=True))
    np.testing.assert_array_equal(
        window_merge(torch.from_numpy(ring), mask).numpy(), want)


def test_merge_path_follows_the_device():
    assert resolve_merge_path("auto") == "auto"
    for path in ("jnp", "pallas", "cuda"):
        with pytest.raises(ValueError, match="follows the ring's device"):
            resolve_merge_path(path)
    with pytest.raises(ValueError, match="follows the ring's device"):
        TimeWheel(num_metrics=4, config=MetricConfig(bucket_limit=BL),
                  tiers=TIERS, merge_path="jnp", device="cpu")


def test_window_merge_rejects_bad_operands():
    ring = torch.zeros((3, 2, B), dtype=torch.int32)
    with pytest.raises(ValueError, match="entries for 3 slots"):
        window_merge_kernel(ring, np.ones(4, bool))
    with pytest.raises(ValueError, match="int32"):
        window_merge_kernel(ring.to(torch.int64), np.ones(3, bool))
    with pytest.raises(ValueError, match=r"\[S, M, B\]"):
        window_merge_kernel(ring[0], np.ones(3, bool))
    assert MAX_WINDOW_SLOTS >= max(s for s, _ in TIERS) * 10


def _acc(m, seed):
    rng = np.random.default_rng(seed)
    acc = np.zeros((m, B), np.int32)
    for r in range(1, m):
        n = int(rng.integers(1, 4000))
        v = rng.lognormal(-1.5, 0.7, n) * np.where(rng.random(n) < 0.2, -1, 1)
        cols = np.clip(compress_np(v), -BL, BL).astype(np.int64) + BL
        acc[r] = np.bincount(cols, minlength=B)
    return acc


def _assert_stats_equal(got, want):
    """Port stats (torch) against JAX stats (jnp), both [M, ...]."""
    gc, wc = got["counts"].numpy(), np.asarray(want["counts"])
    np.testing.assert_array_equal(gc, wc)
    gp, wp = got["percentiles"].numpy(), np.asarray(want["percentiles"])
    np.testing.assert_array_equal(compress_np(gp), compress_np(wp))
    np.testing.assert_allclose(gp, wp, rtol=4e-6, atol=0)
    np.testing.assert_allclose(got["sums"].numpy(), np.asarray(want["sums"]),
                               rtol=1e-5, atol=1e-6)


def test_dense_cdf_equals_jax():
    acc = _acc(20, seed=5)
    want = jax_dense_cdf(jnp.asarray(acc), BL)
    got = dense_cdf(torch.from_numpy(acc), BL)
    assert got["cdf"].dtype == torch.int32
    np.testing.assert_array_equal(got["cdf"].numpy(), np.asarray(want["cdf"]))
    np.testing.assert_array_equal(got["counts"].numpy(),
                                  np.asarray(want["counts"]))
    np.testing.assert_allclose(got["sums"].numpy(), np.asarray(want["sums"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", MASKS)
def test_window_stats_equals_jax(kind):
    s = 6
    ring = np.stack([_acc(M, seed=10 + i) for i in range(s)])
    mask = _mask(kind, s, seed=11)
    ps = np.asarray(PS, np.float32)
    want = jax_window_stats(jnp.asarray(ring), jnp.asarray(mask),
                            jnp.asarray(ps), BL)
    got = window_stats(torch.from_numpy(ring), mask, ps, BL)
    _assert_stats_equal(got, want)


def test_window_snapshot_equals_jax():
    s = 5
    ring = np.stack([_acc(M, seed=20 + i) for i in range(s)])
    masks = np.stack([_mask(k, s, seed=21) for k in MASKS])
    want = jax_window_snapshot(jnp.asarray(ring), jnp.asarray(masks), BL)
    got = window_snapshot(torch.from_numpy(ring), masks, BL)
    np.testing.assert_array_equal(got["cdf"].numpy(), np.asarray(want["cdf"]))
    np.testing.assert_array_equal(got["counts"].numpy(),
                                  np.asarray(want["counts"]))
    np.testing.assert_allclose(got["sums"].numpy(), np.asarray(want["sums"]),
                               rtol=1e-5, atol=1e-6)


# -- wheel against wheel ---------------------------------------------------


def _intervals(n, seed, names=NAMES, start=0):
    """Seeded RawMetricSets: sparse bucket maps (some past the clip
    range; negative buckets only near zero, so float32 sums do not
    cancel), counters, and mostly 1 s intervals with some 0.5 s ones."""
    rng = np.random.default_rng(seed)
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    out = []
    for i in range(start, start + n):
        hists = {}
        for name in names:
            if rng.random() < 0.15:
                continue  # the metric is idle this interval
            k = int(rng.integers(1, 12))
            buckets = rng.integers(-4, BL + 6, k)
            counts = rng.integers(1, 500, k)
            hists[name] = {int(b): int(c) for b, c in zip(buckets, counts)}
        rates = {"req": int(rng.integers(50, 150)),
                 "err": int(rng.integers(0, 20) if i % 7 < 4 else 60)}
        out.append(RawMetricSet(
            time=t0 + dt.timedelta(seconds=i), counters=dict(rates),
            rates=rates, histograms=hists, gauges={},
            duration=0.5 if i % 5 == 3 else 1.0, seq=i + 1,
        ))
    return out


def _wheels(pins=(2.0, 3.0, 6.0), **kw):
    jw = JaxWheel(num_metrics=M, config=JaxConfig(bucket_limit=BL),
                  interval=1.0, tiers=TIERS, merge_path="jnp", **kw)
    pw = TimeWheel(num_metrics=M, config=MetricConfig(bucket_limit=BL),
                   interval=1.0, tiers=TIERS, device="cpu", **kw)
    for w in pins:
        jw.pin_window(w)
        pw.pin_window(w)
    return jw, pw


def _assert_tiers_equal(jw, pw):
    assert jw.intervals_pushed == pw.intervals_pushed
    assert jw.samples_retained == pw.samples_retained
    assert jw.shed_samples == pw.shed_samples
    assert jw.registry.names() == pw.registry.names()
    for jt, pt in zip(jw._tiers, pw._tiers):
        np.testing.assert_array_equal(pt.ring.numpy(), np.asarray(jt.ring))
        assert (pt.slot, pt.in_slot) == (jt.slot, jt.in_slot)
        np.testing.assert_array_equal(pt.written, jt.written)
        np.testing.assert_array_equal(pt.durations, jt.durations)
        assert pt.rates == jt.rates


def _assert_window_equal(got, want):
    assert (got.window_s, got.covered_s, got.tier, got.slots) == (
        want.window_s, want.covered_s, want.tier, want.slots)
    assert got.time == want.time
    assert set(got.metrics) == set(want.metrics)
    for name, w in want.metrics.items():
        g = got.metrics[name]
        assert set(g) == set(w)
        assert g["count"] == w["count"], name
        assert g["sum"] == pytest.approx(w["sum"], rel=1e-5, abs=1e-6)
        assert g["avg"] == pytest.approx(w["avg"], rel=1e-5, abs=1e-6)
        for key in w:
            if key.startswith("p"):
                assert compress_np([g[key]])[0] == compress_np([w[key]])[0]
                assert g[key] == pytest.approx(w[key], rel=4e-6, abs=0)


@pytest.fixture(scope="module")
def pushed_pair():
    """Both wheels after 20 identical intervals (every ring wraps)."""
    jw, pw = _wheels()
    for raw in _intervals(20, seed=7):
        jw.push(raw)
        pw.push(raw)
    return jw, pw


def test_wheel_rings_and_metadata_equal_every_interval():
    jw, pw = _wheels()
    for raw in _intervals(20, seed=8):
        jw.push(raw)
        pw.push(raw)
        _assert_tiers_equal(jw, pw)
    # 20 intervals pass every tier's ring wrap (4, 3x2, 2x6 intervals)
    assert all(t.written.all() for t in pw._tiers)


WINDOWS = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 12.0, 30.0, None]


@pytest.mark.parametrize("window", WINDOWS)
def test_wheel_queries_equal(pushed_pair, window):
    jw, pw = pushed_pair
    for pattern in ("*", "svc.*", "db.q1", "nothing*"):
        want = jw.query(pattern, window, percentiles=PS)
        got = pw.query(pattern, window, percentiles=PS)
        _assert_window_equal(got, want)


@pytest.mark.parametrize("tier", [0, 1, 2])
def test_wheel_queries_equal_per_tier(pushed_pair, tier):
    jw, pw = pushed_pair
    for window in (1.0, 3.0, 7.0, 100.0):
        _assert_window_equal(
            pw.query("*", window, percentiles=(0.25, 0.75), tier=tier),
            jw.query("*", window, percentiles=(0.25, 0.75), tier=tier))


@pytest.mark.parametrize("window", [0.5, 1.0, 2.0, 3.5, 6.0, 12.0, 40.0])
def test_window_rate_equal(pushed_pair, window):
    jw, pw = pushed_pair
    for name in ("req", "err", "missing"):
        assert pw.window_counter(name, window) == jw.window_counter(
            name, window)
        assert pw.window_rate(name, window) == jw.window_rate(name, window)


def test_query_counters_pinning_and_cache_identity_match_jax():
    jw, pw = _wheels(pins=())
    raws = _intervals(6, seed=9)
    for raw in raws[:3]:
        jw.push(raw)
        pw.push(raw)
    log = []
    for wheel in (jw, pw):
        r0 = wheel.query("*", 2.0)      # unpinned: recompute, auto-pin
        r0b = wheel.query("*", 2.0)     # pin lands at the next commit
        wheel.push(raws[3])
        r1 = wheel.query("*", 2.0)      # served from the snapshot
        r2 = wheel.query("*", 2.0)      # unchanged epoch: the same object
        r_full = wheel.query("*", None)
        log.append((
            wheel.query_fallbacks, wheel.query_snapshot_hits,
            wheel.query_result_cache_hits, wheel.pinned_windows(),
            r2 is r1, r0 is r0b, wheel.query_rows_fetched,
            wheel.plan_cache.hits, wheel.plan_cache.misses,
            wheel.snapshot_age_intervals(),
        ))
        assert r_full.slots > 0
    assert log[0] == log[1]
    assert log[1][:6] == (2, 3, 1, (2.0,), True, False)


def test_snapshot_serve_equals_recompute_in_the_port(pushed_pair):
    _, pw = pushed_pair
    for window in (2.0, 3.0, 6.0, None):
        for pattern in ("*", "svc.m3"):
            served = pw.query(pattern, window, percentiles=PS)
            w = served.window_s
            oracle = pw._query_recompute(pattern, w, PS, served.tier)
            assert served.metrics == oracle.metrics
            assert (served.covered_s, served.slots) == (
                oracle.covered_s, oracle.slots)
    assert pw.query_snapshot_hits > 0


def test_selector_pattern_raises_like_the_reference(pushed_pair):
    jw, pw = pushed_pair
    for wheel in pushed_pair:
        with pytest.raises(ValueError, match="needs a LabelIndex"):
            wheel.query("http.latency{route=/api}", 2.0)


def test_registry_full_sheds_like_jax():
    jw, pw = _wheels(pins=())
    names = [f"n{i}" for i in range(M + 4)]
    for raw in _intervals(3, seed=12, names=names):
        jw.push(raw)
        pw.push(raw)
    _assert_tiers_equal(jw, pw)
    assert pw.shed_samples > 0


def test_hbm_bytes_and_tiers():
    jw, pw = _wheels(pins=())
    assert pw.hbm_bytes() == jw.hbm_bytes() == 9 * M * B * 4
    assert pw.tiers == jw.tiers


# -- rules ----------------------------------------------------------------


def _rule_pair(mod):
    return [
        mod.ThresholdRule("p90_hi", "svc.m1", "p90", window=3.0,
                          threshold=0.3, for_intervals=2),
        mod.ThresholdRule("count_lo", "svc.m2", "count", window=2.0,
                          threshold=400.0, op="<"),
        mod.RateOfChangeRule("req_jump", "req", window=2.0, threshold=20.0,
                             absolute=True),
        mod.SloBurnRateRule("slo", "err", "req", objective=0.9,
                            long_window=6.0, short_window=2.0,
                            threshold=1.5),
    ]


def test_rules_fire_and_clear_on_the_same_intervals_as_jax():
    jw, pw = _wheels(pins=())
    engines = []
    for wheel, mod in ((jw, jax_rules), (pw, rules)):
        engine = mod.RuleEngine(wheel)
        for rule in _rule_pair(mod):
            engine.add(rule)
        engine.attach()
        engines.append(engine)
    assert jw.pinned_windows() == pw.pinned_windows() == (3.0, 2.0)
    transitions = [[], []]
    for raw in _intervals(30, seed=13):
        for k, wheel in enumerate((jw, pw)):
            before = len(engines[k].history)
            wheel.push(raw)
            transitions[k].append(sorted(
                (a.rule, a.state) for a in list(engines[k].history)[before:]))
        assert sorted(engines[0].active()) == sorted(engines[1].active())
        for jr, pr in zip(engines[0].rules(), engines[1].rules()):
            if jr.last_value is None:
                assert pr.last_value is None
            else:
                assert pr.last_value == pytest.approx(jr.last_value,
                                                      rel=4e-6)
    assert transitions[0] == transitions[1]
    fired = {r for step in transitions[1] for r, s in step if s == "firing"}
    resolved = {r for step in transitions[1] for r, s in step
                if s == "resolved"}
    assert {"slo", "req_jump"} <= fired and resolved


def test_rule_gauges_and_alert_channel():
    from loghisto_tpu_torch.channel import Channel
    from loghisto_tpu_torch.metrics import MetricSystem

    _, pw = _wheels(pins=())
    engine = rules.RuleEngine(pw)
    engine.add(rules.SloBurnRateRule("slo", "err", "req", objective=0.9,
                                     long_window=6.0, short_window=2.0,
                                     threshold=1.5))
    engine.attach()
    ch = Channel(64)
    engine.subscribe(ch)
    ms = MetricSystem(sys_stats=False)
    engine.register_gauges(ms)
    for raw in _intervals(12, seed=13):
        pw.push(raw)
    alerts = []
    while len(ch):
        alerts.append(ch.get(block=False))
    assert alerts and alerts[0].state == rules.FIRING
    gauges = ms.collect_raw_metrics().gauges
    assert gauges["alert.slo"] == (1.0 if "slo" in engine.active() else 0.0)
    assert "alerts.firing" in gauges


# -- weights carried across -------------------------------------------------


def test_wheel_state_carried_from_jax_answers_as_jax():
    jw, _ = _wheels()
    raws = _intervals(15, seed=14)
    for raw in raws[:9]:
        jw.push(raw)
    pw = TimeWheel(num_metrics=M, config=MetricConfig(bucket_limit=BL),
                   interval=1.0, tiers=TIERS, device="cpu")
    pw.load_state_dict(wheel_state_from_jax(jw))
    _assert_tiers_equal(jw, pw)
    assert pw.pinned_windows() == jw.pinned_windows()
    for window in (2.0, 3.0, 5.0, None):
        _assert_window_equal(pw.query("*", window, percentiles=PS),
                             jw.query("*", window, percentiles=PS))
    for raw in raws[9:]:
        jw.push(raw)
        pw.push(raw)
    _assert_tiers_equal(jw, pw)
    for window in (1.0, 3.0, 6.0, 9.0, None):
        _assert_window_equal(pw.query("*", window, percentiles=PS),
                             jw.query("*", window, percentiles=PS))
        assert pw.window_rate("req", window or 36.0) == jw.window_rate(
            "req", window or 36.0)


def test_wheel_state_dict_round_trip(pushed_pair):
    _, pw = pushed_pair
    state = pw.state_dict()
    other = TimeWheel(num_metrics=M, config=MetricConfig(bucket_limit=BL),
                      interval=1.0, tiers=TIERS, device="cpu")
    other.load_state_dict(state)
    for a, b in zip(other._tiers, pw._tiers):
        assert torch.equal(a.ring, b.ring)
    for window in (2.0, 6.0, None):
        assert other.query("*", window).metrics == pw.query(
            "*", window).metrics
    with pytest.raises(ValueError, match="tiers"):
        TimeWheel(num_metrics=M, config=MetricConfig(bucket_limit=BL),
                  tiers=((4, 1),), device="cpu").load_state_dict(state)
