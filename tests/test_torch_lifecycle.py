"""The port's metric lifecycle (``loghisto_tpu_torch.lifecycle``,
``ops/lifecycle.py`` with K6's plain version) against the JAX package's,
at small sizes (M = 32, bucket_limit 64, tiers (4, 1), (3, 2)), plus the
behaviours ``tests/test_lifecycle.py`` pins for the reference: registry
free-list and generation, victim policy, count-exact overflow folds,
bit-identical survivors across a repack, invalidation, a threaded race
and the system wiring.

Everything here is integer or host state: the comparisons are EQUAL.
"""

import datetime as dt
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loghisto_tpu.commit import IntervalCommitter as JaxCommitter
from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.lifecycle import LifecycleConfig as JaxLifecycleConfig
from loghisto_tpu.lifecycle import LifecycleManager as JaxLifecycleManager
from loghisto_tpu.lifecycle import decide_victims as jax_decide_victims
from loghisto_tpu.ops.lifecycle import compact_rows as jax_compact_rows
from loghisto_tpu.ops.lifecycle import compact_rows_pallas
from loghisto_tpu.ops.lifecycle import make_compact_fn as jax_make_compact
from loghisto_tpu.ops.lifecycle import make_fold_evict_fn as jax_make_fold
from loghisto_tpu.parallel.aggregator import TPUAggregator
from loghisto_tpu.window import TimeWheel as JaxWheel
from loghisto_tpu_torch.commit import IntervalCommitter
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.lifecycle import (
    LifecycleConfig,
    LifecycleManager,
    decide_victims,
    default_overflow_name,
)
from loghisto_tpu_torch.metrics import RawMetricSet
from loghisto_tpu_torch.ops.commit import DROP_ID
from loghisto_tpu_torch.ops.lifecycle import (
    compact_rows,
    compact_rows_kernel,
    make_compact_fn,
    make_fold_evict_fn,
    pad_pow2_ids,
    resolve_compact_path,
)
from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
from loghisto_tpu_torch.registry import MetricRegistry
from loghisto_tpu_torch.state import lifecycle_state_from_jax
from loghisto_tpu_torch.window.store import TimeWheel

BL = 64
M = 32
TIERS = ((4, 1), (3, 2))
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)


def _raw(i, hists=None):
    return RawMetricSet(
        time=T0 + dt.timedelta(seconds=i), counters={}, rates={},
        histograms=dict(hists or {}), gauges={}, duration=1.0,
    )


def _port(config=None, m=M, tiers=TIERS):
    cfg = MetricConfig(bucket_limit=BL)
    agg = TorchAggregator(num_metrics=m, config=cfg, device="cpu")
    wheel = TimeWheel(num_metrics=m, config=cfg, interval=1.0, tiers=tiers,
                      registry=agg.registry, device="cpu")
    lc = LifecycleManager(agg, wheel, config or LifecycleConfig())
    return IntervalCommitter(agg, wheel, lifecycle=lc), agg, wheel, lc


def _jax(config, m=M, tiers=TIERS):
    cfg = JaxConfig(bucket_limit=BL)
    agg = TPUAggregator(num_metrics=m, config=cfg, storage="dense")
    wheel = JaxWheel(num_metrics=m, config=cfg, interval=1.0, tiers=tiers,
                     registry=agg.registry, merge_path="jnp")
    lc = JaxLifecycleManager(agg, wheel, config)
    return _synchronised(JaxCommitter(agg, wheel, lifecycle=lc)), agg, \
        wheel, lc


def _synchronised(com):
    """Wait for each JAX commit step before the next is staged: the JAX
    ``CellStagingRing`` rewrites a host slot two stages later, and on the
    CPU ``jax.device_put`` reads that memory after it returns, so an
    unfinished step would see the next chunk's cells (ROADMAP F3)."""
    for attr in ("_fused", "_fused_snap"):
        step = getattr(com, attr)
        setattr(com, attr,
                lambda *a, _step=step: jax.block_until_ready(_step(*a)))
    return com


def _churn(seed, n, fresh=4):
    """Steady names plus ``fresh`` new api names per interval."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h = {}
        for j in range(fresh):
            h[f"api.u{i}_{j}.lat"] = {int(b): int(c) for b, c in zip(
                rng.integers(-8, BL, 3), rng.integers(1, 20, 3))}
        for s in range(3):
            if rng.random() < 0.7:
                h[f"svc.s{s}.lat"] = {int(rng.integers(0, BL)): 2}
        out.append(_raw(i, h))
    return out


def _overflow_total(agg):
    """Samples in every ``_overflow.*`` row (api and svc names churn)."""
    acc = agg._acc.numpy()
    return sum(int(acc[m].sum()) for m, n in enumerate(agg.registry.names())
               if n is not None and n.startswith("_overflow."))


def _assert_same(pcom, pagg, pwheel, plc, jcom, jagg, jwheel, jlc):
    assert pagg.registry.names() == jagg.registry.names()
    assert pagg.registry.generation == jagg.registry.generation
    assert pagg.registry.free_count() == jagg.registry.free_count()
    np.testing.assert_array_equal(pagg._acc.numpy(), np.asarray(jagg._acc))
    for t, jt in zip(pwheel._tiers, jwheel._tiers):
        np.testing.assert_array_equal(t.ring.numpy(), np.asarray(jt.ring))
    np.testing.assert_array_equal(plc._la.numpy(), np.asarray(jlc._la))
    for key in ("evicted_series", "overflowed_samples", "evictions",
                "compactions"):
        assert getattr(plc, key) == getattr(jlc, key), key
    assert pagg._agg == jagg._agg


@pytest.mark.parametrize("auto_compact", [0.0, 0.25])
def test_lifecycle_matches_jax_on_a_churn_stream(auto_compact):
    cfg = dict(ttl_intervals=2, check_every=1, min_compact_rows=4,
               auto_compact_fragmentation=auto_compact)
    port = _port(LifecycleConfig(**cfg))
    jax_ = _jax(JaxLifecycleConfig(**cfg))
    total = 0
    # the last intervals bring no fresh names: freed rows pile up and
    # the auto-compaction threshold is crossed
    stream = _churn(1, 14) + [_raw(14 + k, {"svc.s0.lat": {3: 1}})
                              for k in range(4)]
    for i, raw in enumerate(stream):
        port[0].commit(raw)
        jax_[0].commit(raw)
        total += sum(sum(h.values()) for h in raw.histograms.values())
        _assert_same(*port, *jax_)
        if auto_compact == 0.0 and i % 5 == 4:
            assert port[3].compact() == jax_[3].compact()
            _assert_same(*port, *jax_)
    plc, pagg = port[3], port[1]
    assert plc.evicted_series > 0 and plc.compactions > 0
    acc = pagg._acc.numpy()
    assert int(acc.sum()) == total  # conservation
    assert _overflow_total(pagg) == plc.overflowed_samples
    assert pagg.num_metrics == M


def test_evict_ids_returns_the_same_names_as_jax():
    cfg = dict(check_every=1000, auto_compact_fragmentation=0.0)
    port = _port(LifecycleConfig(**cfg))
    jax_ = _jax(JaxLifecycleConfig(**cfg))
    for raw in _churn(2, 3):
        port[0].commit(raw)
        jax_[0].commit(raw)
    reg = port[1].registry
    victims = [reg.lookup("api.u0_1.lat"), reg.lookup("api.u2_3.lat"),
               reg.lookup("svc.s1.lat"), 999, reg.lookup("api.u1_0.lat")]
    victims = [v for v in victims if v is not None]
    assert port[3].evict_ids(victims) == jax_[3].evict_ids(victims)
    _assert_same(*port, *jax_)
    assert port[3].compact() and jax_[3].compact()
    _assert_same(*port, *jax_)


def test_lifecycle_state_carried_from_jax_continues_identically():
    from loghisto_tpu_torch.state import state_from_jax, wheel_state_from_jax

    cfg = dict(ttl_intervals=2, check_every=1, auto_compact_fragmentation=0.0)
    jcom, jagg, jwheel, jlc = _jax(JaxLifecycleConfig(**cfg))
    stream = _churn(4, 10)
    for raw in stream[:6]:
        jcom.commit(raw)
    pcom, pagg, pwheel, plc = _port(LifecycleConfig(**cfg))
    pagg.load_state_dict(state_from_jax(
        np.asarray(jagg._acc), jagg.registry.names(), jagg._agg))
    pwheel.load_state_dict(wheel_state_from_jax(jwheel))
    pwheel.registry = pagg.registry  # one registry for the pair
    plc.load_state(lifecycle_state_from_jax(jlc.state_dict()))
    for raw in stream[6:]:
        pcom.commit(raw)
        jcom.commit(raw)
        assert pagg.registry.names() == jagg.registry.names()
        np.testing.assert_array_equal(pagg._acc.numpy(),
                                      np.asarray(jagg._acc))
        for t, jt in zip(pwheel._tiers, jwheel._tiers):
            np.testing.assert_array_equal(t.ring.numpy(),
                                          np.asarray(jt.ring))
        np.testing.assert_array_equal(plc._la.numpy(), np.asarray(jlc._la))
        assert (plc.evicted_series, plc.overflowed_samples) == (
            jlc.evicted_series, jlc.overflowed_samples)
    state = plc.state_dict()
    assert state["evictions"] == jlc.evictions > 0


# -- registry ---------------------------------------------------------------


def test_registry_evict_free_list_reuse():
    r = MetricRegistry(8)
    assert [r.id_for(n) for n in ("a", "b", "c")] == [0, 1, 2]
    assert r.generation == 0 and r.live_count() == 3
    assert r.evict([1]) == ["b"]
    assert r.generation == 1
    assert r.free_count() == 1 and r.live_count() == 2
    assert r.name_for(1) is None and r.lookup("b") is None
    assert r.id_for("d") == 1 and r.generation == 2 and r.free_count() == 0
    assert r.id_for("e") == 3 and r.generation == 2  # an append
    assert r.evict([99, 1]) == ["d"]
    assert r.evict([1]) == []
    assert len(r) == 4


def test_registry_apply_permutation():
    r = MetricRegistry(8)
    for n in ("a", "b", "c", "d"):
        r.id_for(n)
    r.evict([0, 2])
    gen = r.generation
    r.apply_permutation([1, 3] + [int(DROP_ID)] * 6, 8)
    assert r.generation == gen + 1
    assert r.lookup("b") == 0 and r.lookup("d") == 1
    assert len(r) == 2 and r.free_count() == 0
    with pytest.raises(ValueError, match="drops live ids"):
        r.apply_permutation([0] + [int(DROP_ID)] * 7)
    with pytest.raises(ValueError, match="duplicates"):
        r.apply_permutation([0, 0, 1] + [int(DROP_ID)] * 5)
    with pytest.raises(ValueError, match="capacity"):
        r.apply_permutation([0, 1, -1], 2)


# -- policy -----------------------------------------------------------------


def test_policy_matches_jax_decide_victims():
    rng = np.random.default_rng(5)
    pools = ["api.u{}", "api.v{}", "db.q{}", "http.lat;route=/r{}",
             "_overflow.api", "keep.k{}"]
    for trial in range(30):
        n = int(rng.integers(1, 40))
        names = [None if rng.random() < 0.15 else
                 pools[int(rng.integers(0, len(pools)))].format(k)
                 for k in range(n)]
        seen, uniq = set(), []
        for name in names:
            uniq.append(None if name in seen else name)
            seen.add(name)
        la = rng.integers(0, 20, int(rng.integers(0, n + 1)))
        kw = dict(ttl_intervals=int(rng.integers(1, 6)),
                  max_live=int(rng.integers(1, 30)),
                  prefix_budgets={"api.*": int(rng.integers(0, 8))},
                  label_budgets={"http.*": int(rng.integers(0, 4))},
                  protect=("keep.*",))
        assert decide_victims(uniq, la, 20, LifecycleConfig(**kw)) == \
            jax_decide_victims(uniq, la, 20, JaxLifecycleConfig(**kw)), trial


def test_policy_ttl_protection_and_budgets():
    cfg = LifecycleConfig(ttl_intervals=3, protect=("keep.*",))
    assert decide_victims(["a", "keep.me", "_overflow.a", None, "b"],
                          [0, 0, 0, 0, 9], 10, cfg) == [0]
    cfg = LifecycleConfig(max_live=3, prefix_budgets={"api.*": 2})
    assert decide_victims(["api.a", "api.b", "api.c", "db.a", "db.b"],
                          [5, 1, 9, 2, 8], 10, cfg) == [1, 3]
    assert decide_victims(["a", "b"], [0], 10,
                          LifecycleConfig(ttl_intervals=1)) == [0]
    assert default_overflow_name("api.u1.lat") == "_overflow.api"
    assert default_overflow_name("http.lat;route=/a") == "_overflow.http"
    with pytest.raises(ValueError, match="ttl_intervals"):
        LifecycleConfig(ttl_intervals=0)


# -- the device steps -------------------------------------------------------


def test_fold_evict_matches_jax_and_is_exact():
    rng = np.random.default_rng(6)
    acc0 = rng.integers(0, 1000, (6, 5)).astype(np.int32)
    ring0 = rng.integers(0, 1000, (2, 4, 5)).astype(np.int32)  # 4 rows
    la0 = rng.integers(0, 5, 6).astype(np.int32)
    victims = pad_pow2_ids([1, 4, 2])
    targets = np.full(len(victims), DROP_ID, dtype=np.int32)
    targets[:3] = [5, 5, 3]  # duplicate target; 5 is past the ring
    acc, rings, la, vc = make_fold_evict_fn(1)(
        torch.from_numpy(acc0.copy()), [torch.from_numpy(ring0.copy())],
        torch.from_numpy(la0.copy()), victims, targets, 7)
    jacc, jrings, jla, jvc = jax_make_fold(1)(
        jnp.asarray(acc0), (jnp.asarray(ring0),), jnp.asarray(la0),
        victims, targets, np.int32(7))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(rings[0].numpy(), np.asarray(jrings[0]))
    np.testing.assert_array_equal(la.numpy(), np.asarray(jla))
    np.testing.assert_array_equal(vc.numpy()[:3], np.asarray(jvc)[:3])
    a = acc.numpy()
    assert (a[5] == acc0[5] + acc0[1] + acc0[4]).all()
    assert (a[3] == acc0[3] + acc0[2]).all()
    assert int(a.sum()) == int(acc0.sum())


PERM_CASES = [
    [7, 0, 15, -1, int(DROP_ID), 3, 9, 1] + [int(DROP_ID)] * 8,
    list(range(16)),
    [-1] * 16,
    [15, 14, 40, -(2**31), 2**31 - 1, 2, 2, 0],
]


@pytest.mark.parametrize("perm", PERM_CASES)
def test_compact_rows_plain_equals_jax_and_pallas_interpret(perm):
    rng = np.random.default_rng(3)
    arr = rng.integers(-100, 100, (16, 13)).astype(np.int32)
    perm = np.asarray(perm, dtype=np.int32)
    got = compact_rows(torch.from_numpy(arr), torch.from_numpy(perm))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_compact_rows(jnp.asarray(arr),
                                                 jnp.asarray(perm))))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(compact_rows_pallas(
            jnp.asarray(arr), jnp.asarray(perm), interpret=True)))
    # the wrapper takes the plain version on a CPU tensor
    assert torch.equal(compact_rows_kernel(torch.from_numpy(arr), perm), got)


def test_compact_rows_of_a_ring_and_of_floats():
    rng = np.random.default_rng(4)
    ring = rng.integers(0, 50, (3, 8, 5)).astype(np.int32)
    perm = np.array([6, -1, 0, int(DROP_ID), 7, 9], dtype=np.int32)
    got = compact_rows(torch.from_numpy(ring), perm).numpy()
    for s in range(3):
        np.testing.assert_array_equal(
            got[s], np.asarray(jax_compact_rows(jnp.asarray(ring[s]),
                                                jnp.asarray(perm))))
    prof = rng.random((2, 8, 5)).astype(np.float32)
    fgot = compact_rows(torch.from_numpy(prof), perm)
    assert fgot.dtype == torch.float32 and fgot.shape == (2, 6, 5)
    np.testing.assert_array_equal(fgot.numpy()[:, 0], prof[:, 6])
    assert not fgot.numpy()[:, 1].any()
    with pytest.raises(ValueError, match="4-byte"):
        compact_rows(torch.zeros((2, 3), dtype=torch.int64), [0, 1])


def test_compact_fn_matches_jax_compact():
    rng = np.random.default_rng(8)
    acc0 = rng.integers(0, 100, (8, 5)).astype(np.int32)
    rings0 = [rng.integers(0, 100, (3, 8, 5)).astype(np.int32),
              rng.integers(0, 100, (2, 6, 5)).astype(np.int32)]
    la0 = rng.integers(0, 9, 8).astype(np.int32)
    perm = np.array([1, 3, 4, 7, 6] + [int(DROP_ID)] * 3, dtype=np.int32)
    rings = [torch.from_numpy(r.copy()) for r in rings0]
    acc, rings_out, la = make_compact_fn(2)(
        torch.from_numpy(acc0.copy()), rings, torch.from_numpy(la0.copy()),
        perm, 11)
    assert rings_out is rings  # replaced entry by entry
    jacc, jrings, jla = jax_make_compact(2, "jnp")(
        jnp.asarray(acc0), tuple(jnp.asarray(r) for r in rings0),
        jnp.asarray(la0), jnp.asarray(perm), np.int32(11))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    for r, jr in zip(rings_out, jrings):
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(la.numpy(), np.asarray(jla))


def test_compact_path_accepts_only_auto():
    assert resolve_compact_path("auto") == "auto"
    for path in ("jnp", "pallas", "eager"):
        with pytest.raises(ValueError, match="compact_path"):
            resolve_compact_path(path)
    with pytest.raises(ValueError, match="compact_path"):
        _port(LifecycleConfig(compact_path="pallas"))


# -- the manager ------------------------------------------------------------


def test_fused_commit_tracks_activity():
    com, agg, _, lc = _port()
    com.commit(_raw(0, {"a": {1: 2}, "b": {0: 1}}))
    com.commit(_raw(1, {"a": {2: 3}}))
    com.commit(_raw(2, {"c": {0: 1}}))
    la = lc._la.numpy()
    reg = agg.registry
    assert la[reg.lookup("a")] == 2 and la[reg.lookup("b")] == 1
    assert la[reg.lookup("c")] == 3
    assert com.last_dispatches == 1


def test_ttl_eviction_folds_count_exact_overflow():
    cfg = LifecycleConfig(ttl_intervals=2, check_every=1,
                          auto_compact_fragmentation=0.0)
    com, agg, _, lc = _port(cfg)
    total = 0
    for raw in _churn(0, 8):
        com.commit(raw)
        total += sum(sum(h.values()) for h in raw.histograms.values())
    reg = agg.registry
    assert lc.evicted_series > 0 and lc.evictions > 0
    acc = agg._acc.numpy()
    assert _overflow_total(agg) == lc.overflowed_samples
    assert int(acc[reg.lookup("_overflow.api")].sum()) > 0
    assert int(acc.sum()) == total
    assert agg.collect(reset=False).metrics["_overflow.api_count"] > 0
    assert agg.num_metrics == M and reg.live_count() <= M


def test_eviction_respects_prefix_budget():
    cfg = LifecycleConfig(prefix_budgets={"api.*": 2}, check_every=1,
                          auto_compact_fragmentation=0.0)
    com, agg, _, _ = _port(cfg)
    h = {f"api.u{j}": {1: 1} for j in range(5)}
    h["db.q"] = {0: 1}
    com.commit(_raw(0, h))
    com.commit(_raw(1, {"db.q": {0: 1}}))
    live_api = [n for n in agg.registry.names()
                if n and n.startswith("api.")]
    assert len(live_api) == 2 and agg.registry.lookup("db.q") is not None


def test_compaction_keeps_survivors_bit_identical():
    cfg = LifecycleConfig(check_every=1000, auto_compact_fragmentation=0.0)
    com, agg, wheel, lc = _port(cfg, tiers=((4, 2), (3, 4)))
    rng = np.random.default_rng(1)
    names = [f"m{j}" for j in range(10)]
    for i in range(9):  # tier 0 wrapped, its open slot mid-fill
        com.commit(_raw(i, {n: {int(b): int(c) for b, c in zip(
            rng.integers(-8, BL, 6), rng.integers(1, 30, 6))}
            for n in names}))
    assert wheel._tiers[0].written.all() and wheel._tiers[0].in_slot == 1
    lc.evict_ids([agg.registry.lookup(n) for n in names[::3]])
    ps = (0.5, 0.99, 0.9999)
    oracle = {w: wheel.query("*", window=w, percentiles=ps).metrics
              for w in (4.0, 10.0)}
    before = {n: agg._acc[agg.registry.lookup(n)].clone()
              for n in names if agg.registry.lookup(n) is not None}
    assert lc.compact() is True
    live = [m for m, n in enumerate(agg.registry.names()) if n is not None]
    assert live == list(range(agg.registry.live_count()))
    for w, want in oracle.items():
        assert wheel.query("*", window=w, percentiles=ps).metrics == want
    for n, row in before.items():
        assert torch.equal(agg._acc[agg.registry.lookup(n)], row)
    assert not agg._acc[agg.registry.live_count():].any()
    com.commit(_raw(99, {"m1": {0: 1}}))
    assert lc.compact() is False


def test_compaction_reuses_low_ids_first():
    cfg = LifecycleConfig(check_every=1000, auto_compact_fragmentation=0.0)
    com, agg, _, lc = _port(cfg)
    com.commit(_raw(0, {f"n{j}": {0: 1} for j in range(6)}))
    lc.evict_ids([agg.registry.lookup("n2"), agg.registry.lookup("n4")])
    assert agg.registry.id_for("fresh1") in (2, 4)
    lc.compact()
    assert agg.registry.id_for("fresh2") == agg.registry.live_count() - 1


def test_query_after_eviction_never_serves_dead_id():
    cfg = LifecycleConfig(check_every=1000, auto_compact_fragmentation=0.0)
    com, agg, wheel, lc = _port(cfg)
    for i in range(2):
        com.commit(_raw(i, {"api.a": {1: 5}, "api.b": {2: 3}}))
    assert set(wheel.query("api.*", window=4.0).metrics) == {"api.a",
                                                             "api.b"}
    wheel.query("api.*", window=4.0)  # cached serve
    lc.evict_ids([agg.registry.lookup("api.b")])
    res = wheel.query("api.*", window=4.0)
    assert set(res.metrics) == {"api.a"}
    com.commit(_raw(2, {"api.c": {3: 1}}))
    assert agg.registry.lookup("api.c") == 1  # api.b's slot, reused
    assert wheel.query("api.c", window=1.0).metrics["api.c"]["count"] == 1.0


def test_snapshot_epoch_invalidated_on_eviction():
    cfg = LifecycleConfig(check_every=1000, auto_compact_fragmentation=0.0)
    com, agg, wheel, lc = _port(cfg)
    com.commit(_raw(0, {"a": {1: 5}, "b": {1: 5}}))
    assert wheel.snapshot is not None and agg.stats_snapshot is not None
    lc.evict_ids([agg.registry.lookup("b")])
    assert wheel.snapshot is None and agg.stats_snapshot is None
    com.commit(_raw(1, {"a": {1: 5}}))
    assert wheel.snapshot is not None


def test_threaded_churn_register_evict_query():
    cfg = LifecycleConfig(ttl_intervals=2, check_every=1,
                          auto_compact_fragmentation=0.3, min_compact_rows=4)
    com, agg, wheel, lc = _port(cfg, m=64)
    stop = threading.Event()
    errors = []

    def querier():
        while not stop.is_set():
            try:
                res = wheel.query("api.*", window=8.0)
                for entry in res.metrics.values():
                    assert entry["count"] > 0
            except Exception as e:  # pragma: no cover - failure path
                errors.append(e)
                return

    def registrar():
        for k in range(120):
            if stop.is_set():
                return
            try:
                agg._id_for(f"api.reg{k}.lat")
            except Exception as e:  # pragma: no cover - failure path
                errors.append(e)
                return

    threads = [threading.Thread(target=querier),
               threading.Thread(target=registrar)]
    for th in threads:
        th.start()
    try:
        for i in range(20):
            h = {f"api.w{i}_{j}.lat": {1: 2} for j in range(4)}
            h["api.steady"] = {0: 1}
            com.commit(_raw(i, h))
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10.0)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert lc.evicted_series > 0
    assert int(agg._acc.sum()) == 20 * (4 * 2 + 1)


def test_paged_aggregator_raises_naming_the_slice():
    """The paged lifecycle slice is ported: a paged aggregator takes a
    LifecycleManager (its steps are the rings-only fold and repack), and
    only a missing wheel still raises."""
    cfg = MetricConfig(bucket_limit=512)
    agg = TorchAggregator(num_metrics=M, config=cfg, storage="paged",
                          device="cpu")
    wheel = TimeWheel(num_metrics=M, config=cfg, tiers=TIERS,
                      registry=agg.registry, device="cpu")
    lc = LifecycleManager(agg, wheel, LifecycleConfig())
    assert lc._paged
    with pytest.raises(ValueError, match="retention wheel"):
        LifecycleManager(agg, None, LifecycleConfig())
    agg.close()


def test_system_wiring_gauges_and_requirements():
    from loghisto_tpu_torch.system import TorchMetricSystem

    ms = TorchMetricSystem(interval=0.05, sys_stats=False, num_metrics=M,
                           config=MetricConfig(bucket_limit=BL),
                           retention=((8, 1),), device="cpu",
                           lifecycle=LifecycleConfig(ttl_intervals=3,
                                                     check_every=2))
    try:
        assert ms.committer.lifecycle is ms.lifecycle is not None
        gauges = ms.collect_raw_metrics().gauges
        for g in ("lifecycle.ActiveSeries", "lifecycle.FreeSlots",
                  "lifecycle.EvictedSeries", "lifecycle.Occupancy",
                  "lifecycle.OverflowedSamples", "lifecycle.Generation",
                  "lifecycle.CompactionP99Us"):
            assert g in gauges, g
    finally:
        ms.stop()
    with pytest.raises(ValueError, match="retention"):
        TorchMetricSystem(sys_stats=False, device="cpu",
                          lifecycle=LifecycleConfig(ttl_intervals=1))
    with pytest.raises(ValueError, match="rides the fused"):
        TorchMetricSystem(sys_stats=False, device="cpu", retention=((4, 1),),
                          config=MetricConfig(bucket_limit=BL),
                          num_metrics=M, commit="fanout",
                          lifecycle=LifecycleConfig(ttl_intervals=1))
