"""The paged lifecycle slice end to end: the port's ``IntervalCommitter``
and ``LifecycleManager`` over a paged ``TorchAggregator`` against the
JAX package's over a paged ``TPUAggregator``, on the CPU, at a small
size: 48 rows, bucket_limit 128 (B = 257, the narrowest bucket axis
paged storage admits: two 256-bucket pages a row), a 512-page pool
(and a 24-page pool that saturates), tiers (4, 1), (3, 2), commit chunk
16 so an interval takes several commit steps.  A seeded stream of
RawMetricSets with name churn goes through both; the lifecycle checks
every interval (ttl 2) and compacts every 4 intervals.

Tolerances:
  * pool, page table, codecs, free list, host spill, rings, activity
    vector, registry, snapshot cdf and counts, lifecycle counters, the
    host lifetime aggregates and ``collect()``'s counts and percentiles
    (host float64 statistics in both): EQUAL;
  * snapshot sums: rtol 1e-5 (float32 matvecs summed in another order);
  * ``collect()``'s sums and averages: rtol 1e-12;
  * window-query percentile values: rtol 4e-6 (ROADMAP F1: JAX's bucket
    representatives come from XLA's float32 ``exp``), their float32 sums
    and averages rtol 1e-5, counts EQUAL.
"""

import datetime as dt
import zlib

import jax
import numpy as np
import pytest

from loghisto_tpu.commit import IntervalCommitter as JaxCommitter
from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.lifecycle import LifecycleConfig as JaxLifecycleConfig
from loghisto_tpu.lifecycle import LifecycleManager as JaxLifecycleManager
from loghisto_tpu.paging import PagedStoreConfig as JaxPagedConfig
from loghisto_tpu.parallel.aggregator import TPUAggregator
from loghisto_tpu.system import TPUMetricSystem
from loghisto_tpu.window import TimeWheel as JaxWheel
from loghisto_tpu_torch.anomaly import AnomalyConfig, AnomalyManager
from loghisto_tpu_torch.commit import IntervalCommitter
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.lifecycle import (
    LifecycleConfig,
    LifecycleManager,
    default_overflow_name,
)
from loghisto_tpu_torch.metrics import RawMetricSet
from loghisto_tpu_torch.paging import PagedStoreConfig
from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
from loghisto_tpu_torch.system import TorchMetricSystem
from loghisto_tpu_torch.window.store import TimeWheel

BL = 128
M = 48
POOL = 512
TIERS = ((4, 1), (3, 2))
CHUNK = 16
INTERVALS = 12
COMPACT_EVERY = 4
PS = (0.5, 0.9, 0.99)
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
LC = dict(ttl_intervals=2, check_every=1, auto_compact_fragmentation=0.0)


def _stream(seed, n=INTERVALS, steady=10, fresh=5):
    """Steady ``api.s<k>.lat`` names (one of them bursting past two
    pages), ``fresh`` new ``api.u<uid>.lat`` names an interval and a
    ``svc`` name that comes and goes; buckets mostly positive, so float32
    sums stay well conditioned."""
    rng = np.random.default_rng(seed)
    out = []
    uid = 0
    for i in range(n):
        h = {}
        for k in range(steady):
            if rng.random() < 0.9:
                lo = 10 * k - 20
                b = rng.integers(lo, lo + 30, 12)
                if k == 0:
                    b = np.concatenate([b, rng.integers(0, BL + 4, 6)])
                h[f"api.s{k}.lat"] = {}
                for bb, c in zip(b, rng.integers(1, 9, len(b))):
                    h[f"api.s{k}.lat"][int(bb)] = \
                        h[f"api.s{k}.lat"].get(int(bb), 0) + int(c)
        for _ in range(fresh):
            h[f"api.u{uid}.lat"] = {int(rng.integers(0, BL)):
                                    int(rng.integers(1, 8))}
            uid += 1
        if i % 3 == 0:
            h["svc.batch"] = {int(b): 3 for b in rng.integers(0, BL, 4)}
        out.append(RawMetricSet(time=T0 + dt.timedelta(seconds=i),
                                counters={}, rates={"req": i},
                                histograms=h, gauges={}, duration=1.0))
    return out


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


def _pair(codec, pool):
    jagg = TPUAggregator(num_metrics=M, config=JaxConfig(bucket_limit=BL),
                         storage="paged", paged_config=JaxPagedConfig(
                             pool_pages=pool, codec=codec))
    jwheel = JaxWheel(num_metrics=M, config=JaxConfig(bucket_limit=BL),
                      interval=1.0, tiers=TIERS, registry=jagg.registry,
                      merge_path="jnp")
    jlc = JaxLifecycleManager(jagg, jwheel, JaxLifecycleConfig(**LC))
    jcom = _synchronised(JaxCommitter(jagg, jwheel, chunk=CHUNK,
                                      lifecycle=jlc))
    pagg = TorchAggregator(num_metrics=M, config=MetricConfig(bucket_limit=BL),
                           storage="paged", device="cpu",
                           paged_config=PagedStoreConfig(pool_pages=pool,
                                                         codec=codec))
    pwheel = TimeWheel(num_metrics=M, config=MetricConfig(bucket_limit=BL),
                       interval=1.0, tiers=TIERS, registry=pagg.registry,
                       device="cpu")
    plc = LifecycleManager(pagg, pwheel, LifecycleConfig(**LC))
    pcom = IntervalCommitter(pagg, pwheel, chunk=CHUNK, lifecycle=plc)
    return (jcom, jagg, jwheel, jlc), (pcom, pagg, pwheel, plc)


def _cells(store):
    rows, idx, counts = store.decode_cells()
    order = np.lexsort((idx, rows))
    return rows[order], idx[order], counts[order]


def _assert_stores(jst, pst):
    np.testing.assert_array_equal(pst.page_table, jst.page_table)
    np.testing.assert_array_equal(pst.row_codec, jst.row_codec)
    assert pst.free_list() == jst._free_lists[0]
    assert pst._host_spill == jst._host_spill
    for key in ("allocated_pages", "released_pages", "spilled_cells",
                "overflowed_cells"):
        assert getattr(pst, key) == getattr(jst, key), key
    np.testing.assert_array_equal(pst._pool.numpy(), np.asarray(jst._pool))
    for g, w in zip(_cells(pst), _cells(jst)):
        np.testing.assert_array_equal(g, w)


def _assert_snapshots(pwheel, jwheel):
    sg, sw = pwheel.snapshot, jwheel.snapshot
    assert (sg is None) == (sw is None)
    if sg is None:
        return
    assert sg.epoch == sw.epoch
    for tg, tw in zip(sg.tiers, sw.tiers):
        for vg, vw in zip(tg.views, tw.views):
            np.testing.assert_array_equal(vg.mask, vw.mask)
            np.testing.assert_array_equal(vg.cdf.numpy(), np.asarray(vw.cdf))
            np.testing.assert_array_equal(vg.counts.numpy(),
                                          np.asarray(vw.counts))
            np.testing.assert_allclose(vg.sums.numpy(), np.asarray(vw.sums),
                                       rtol=1e-5, atol=1e-6)


def _assert_same(jax_side, port_side):
    jcom, jagg, jwheel, jlc = jax_side
    pcom, pagg, pwheel, plc = port_side
    _assert_stores(jagg.paged, pagg.paged)
    assert pagg.registry.names() == jagg.registry.names()
    assert pagg.registry.generation == jagg.registry.generation
    for t, jt in zip(pwheel._tiers, jwheel._tiers):
        np.testing.assert_array_equal(t.ring.numpy(), np.asarray(jt.ring))
        assert (t.slot, t.in_slot) == (jt.slot, jt.in_slot)
    np.testing.assert_array_equal(plc._la.numpy(), np.asarray(jlc._la))
    for key in ("evicted_series", "overflowed_samples", "evictions",
                "compactions"):
        assert getattr(plc, key) == getattr(jlc, key), key
    for key in ("fused_intervals", "fanout_intervals", "last_dispatches"):
        assert getattr(pcom, key) == getattr(jcom, key), key
    assert pagg._agg == jagg._agg
    assert pagg._interval_ingested == jagg._interval_ingested
    assert pagg.stats_snapshot is None and jagg.stats_snapshot is None
    _assert_snapshots(pwheel, jwheel)


def _assert_metrics(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        if key.endswith(("_sum", "_avg")):
            assert got[key] == pytest.approx(w, rel=1e-12, abs=1e-9), key
        else:
            assert got[key] == w, key


def _assert_windows(pwheel, jwheel, window):
    got = pwheel.query("*", window, PS).metrics
    want = jwheel.query("*", window, PS).metrics
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert set(g) == set(w), name
        for key, v in w.items():
            rel = 1e-5 if key in ("sum", "avg") else 4e-6
            assert g[key] == pytest.approx(v, rel=rel, abs=1e-9), (name, key)


@pytest.mark.parametrize("codec,pool", [
    ("dense", POOL), ("loglinear", POOL), ("polytail", POOL),
    ("auto", POOL), ("auto", 24)])
def test_paged_committer_and_lifecycle_equal_jax(codec, pool):
    jax_side, port_side = _pair(codec, pool)
    jcom, pcom = jax_side[0], port_side[0]
    try:
        seed = zlib.crc32(f"{codec}-{pool}".encode())
        for i, raw in enumerate(_stream(seed)):
            assert pcom.commit(raw) == jcom.commit(raw) == "fused"
            if (i + 1) % COMPACT_EVERY == 0:
                assert port_side[3].compact() == jax_side[3].compact()
            _assert_same(jax_side, port_side)
        plc = port_side[3]
        assert plc.evicted_series > 0 and plc.compactions > 0
        assert plc.overflowed_samples > 0
        # every live row's registry id is in the dense prefix after the
        # last compaction, and the pool's total is every sample committed
        _assert_windows(port_side[2], jax_side[2], 3.0)
        _assert_windows(port_side[2], jax_side[2], 1e9)
        if pool < POOL:
            assert port_side[1].paged.spilled_cells > 0
        _assert_metrics(port_side[1].collect().metrics,
                        jax_side[1].collect().metrics)
        _assert_stores(jax_side[1].paged, port_side[1].paged)
    finally:
        jax_side[1].close()
        port_side[1].close()


def test_paged_conservation_and_overflow_exact():
    """Through churn, eviction and compaction, after every interval: the
    pool plus the host spill hold every sample committed, each live row
    holds its name's samples since it was registered, and each overflow
    row exactly the samples of the names evicted into it."""
    _, (pcom, pagg, _, plc) = _pair("auto", POOL)
    reg = pagg.registry
    live, overflow, total = {}, {}, 0
    try:
        for i, raw in enumerate(_stream(5)):
            pcom.commit(raw)
            if (i + 1) % COMPACT_EVERY == 0:
                plc.compact()
                assert reg.names()[: reg.live_count()].count(None) == 0
            for name, h in raw.histograms.items():
                live[name] = live.get(name, 0) + sum(h.values())
                total += sum(h.values())
            for name in [n for n in live if reg.lookup(n) is None]:
                o = default_overflow_name(name)
                overflow[o] = overflow.get(o, 0) + live.pop(name)
            rows, _, counts = pagg.paged.decode_cells()
            assert int(counts.sum()) == total
            per_row = np.bincount(rows, weights=counts, minlength=M)
            for name, want in {**live, **overflow}.items():
                assert int(per_row[reg.lookup(name)]) == want, name
            assert plc.overflowed_samples == sum(overflow.values())
        assert overflow.get("_overflow.api", 0) > 0
    finally:
        pagg.close()


def test_paged_joins_fused_commit_and_lifecycle_but_not_anomaly():
    """The reference's test of the same name: a paged aggregator shares
    the fused commit and takes a LifecycleManager; the drift engine,
    whose carries are dense [M, B] tensors, is refused with the
    reference's words in both packages."""
    from loghisto_tpu.anomaly import AnomalyConfig as JaxAnomalyConfig
    from loghisto_tpu.anomaly import AnomalyManager as JaxAnomalyManager

    (jcom, jagg, jwheel, _), (pcom, pagg, pwheel, _) = _pair("auto", POOL)
    try:
        jan = JaxAnomalyManager(jagg, jwheel, JaxAnomalyConfig())
        pan = AnomalyManager(pagg, pwheel, AnomalyConfig())
        with pytest.raises(ValueError) as want:
            JaxCommitter(jagg, jwheel, anomaly=jan)
        with pytest.raises(ValueError) as got:
            IntervalCommitter(pagg, pwheel, anomaly=pan)
        assert str(got.value) == str(want.value)
        assert "drift engine requires the dense accumulator" in str(got.value)
        with pytest.raises(ValueError, match="dense accumulator"):
            TorchMetricSystem(device="cpu", sys_stats=False, num_metrics=M,
                              config=MetricConfig(bucket_limit=BL),
                              storage="paged", retention=TIERS,
                              lifecycle=LifecycleConfig(**LC),
                              anomaly=AnomalyConfig())
    finally:
        jagg.close()
        pagg.close()


def test_system_on_paged_storage_equals_jax_system():
    kw = dict(interval=1.0, sys_stats=False, num_metrics=M,
              storage="paged", retention=TIERS)
    jms = TPUMetricSystem(config=JaxConfig(bucket_limit=BL),
                          paged_config=JaxPagedConfig(pool_pages=POOL),
                          lifecycle=JaxLifecycleConfig(**LC), **kw)
    pms = TorchMetricSystem(config=MetricConfig(bucket_limit=BL),
                            paged_config=PagedStoreConfig(pool_pages=POOL),
                            lifecycle=LifecycleConfig(**LC), device="cpu",
                            **kw)
    try:
        assert pms.commit_path == jms.commit_path == "fused"
        assert pms.aggregator.storage == "paged"
        assert pms.aggregator._attached is None
        _synchronised(jms.committer)
        stream = _stream(9)
        for i in range(0, len(stream), 2):
            assert pms.backfill_retention(stream[i:i + 2]) == \
                jms.backfill_retention(stream[i:i + 2]) == 2
            if i % 4 == 2:
                assert pms.lifecycle.compact() == jms.lifecycle.compact()
            _assert_same(
                (jms.committer, jms.aggregator, jms.retention, jms.lifecycle),
                (pms.committer, pms.aggregator, pms.retention,
                 pms.lifecycle))
        got = pms.query_window("api.*", 3.0, percentiles=list(PS)).metrics
        want = jms.query_window("api.*", 3.0, percentiles=list(PS)).metrics
        assert set(got) == set(want) and got
        for name in want:
            for key, v in want[name].items():
                rel = 1e-5 if key in ("sum", "avg") else 4e-6
                assert got[name][key] == pytest.approx(v, rel=rel), key
        _assert_metrics(pms.device_metrics().metrics,
                        jms.device_metrics().metrics)
    finally:
        pms.stop()
        jms.stop()
