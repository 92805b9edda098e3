"""The port's fused interval commit (``loghisto_tpu_torch.commit``,
``ops/commit.py``) against the JAX package's ``IntervalCommitter`` and
against the port's own fan-out path, at small sizes (M = 32,
bucket_limit 64, tiers (4, 1), (3, 2), chunk 16 so intervals take several
commit steps).  Inputs come from a seeded numpy generator.

Tolerances:
  * accumulator, rings, slot/in_slot/written/rates, snapshot cdf and
    counts, activity vector, interval histogram: EQUAL;
  * snapshot sums: rtol 1e-5 against JAX (float32 matvecs summed in
    another order), EQUAL against the port's fan-out (same code);
  * EWMA banks: rtol 1e-6, atol 1e-7 (float32 multiply-adds that XLA may
    contract into fused multiply-adds).
"""

import datetime as dt

import jax
import numpy as np
import pytest
import torch

from loghisto_tpu.anomaly import AnomalyConfig as JaxAnomalyConfig
from loghisto_tpu.anomaly import AnomalyManager as JaxAnomalyManager
from loghisto_tpu.commit import IntervalCommitter as JaxCommitter
from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.lifecycle import LifecycleConfig as JaxLifecycleConfig
from loghisto_tpu.lifecycle import LifecycleManager as JaxLifecycleManager
from loghisto_tpu.parallel.aggregator import TPUAggregator
from loghisto_tpu.window import TimeWheel as JaxWheel
from loghisto_tpu_torch.anomaly import AnomalyConfig, AnomalyManager
from loghisto_tpu_torch.commit import IntervalCommitter, \
    commit_incompatibility
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.lifecycle import LifecycleConfig, LifecycleManager
from loghisto_tpu_torch.metrics import MetricSystem, RawMetricSet
from loghisto_tpu_torch.ops.commit import (
    COMMIT_CHUNK,
    DROP_ID,
    CellStagingRing,
    make_fused_commit_fn,
    stamp_activity,
)
from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
from loghisto_tpu_torch.window.store import TimeWheel

BL = 64
M = 32
TIERS = ((4, 1), (3, 2))
CHUNK = 16
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)


def _raw(i, hists=None, rates=None):
    return RawMetricSet(
        time=T0 + dt.timedelta(seconds=i), counters={},
        rates=dict(rates or {}), histograms=dict(hists or {}), gauges={},
        duration=1.0,
    )


def _intervals(seed, n, names=6, cells=30):
    """Seeded intervals: empty ones, hot and cold names, buckets mostly
    positive (float32 sums stay well conditioned) with some past the
    dense range (they clip)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        hists = {}
        for _ in range(int(rng.integers(0, names + 1))):
            h = hists.setdefault(f"svc.m{int(rng.integers(0, names))}", {})
            for _ in range(int(rng.integers(1, cells))):
                b = int(rng.integers(-4, 3 * BL // 2))
                h[b] = h.get(b, 0) + int(rng.integers(1, 200))
        out.append(_raw(i, hists, rates={"req": i % 3}))
    return out


def _jax_stack(lifecycle=False, anomaly=False, m=M, **agg_kw):
    cfg = JaxConfig(bucket_limit=BL)
    agg = TPUAggregator(num_metrics=m, config=cfg, storage="dense",
                        **agg_kw)
    wheel = JaxWheel(num_metrics=m, config=cfg, interval=1.0, tiers=TIERS,
                     registry=agg.registry, merge_path="jnp")
    lc = (JaxLifecycleManager(agg, wheel, JaxLifecycleConfig())
          if lifecycle else None)
    an = (JaxAnomalyManager(agg, wheel, JaxAnomalyConfig(
        banks=3, bank_of=lambda t: t.second % 3, decay=0.8, min_samples=5,
        window=2.0, divergence_path="jnp")) if anomaly else None)
    com = JaxCommitter(agg, wheel, chunk=CHUNK, lifecycle=lc, anomaly=an)
    return _synchronised(com), agg, wheel


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


def _port_stack(lifecycle=False, anomaly=False, m=M, **agg_kw):
    cfg = MetricConfig(bucket_limit=BL)
    agg = TorchAggregator(num_metrics=m, config=cfg, device="cpu", **agg_kw)
    wheel = TimeWheel(num_metrics=m, config=cfg, interval=1.0, tiers=TIERS,
                      registry=agg.registry, device="cpu")
    lc = (LifecycleManager(agg, wheel, LifecycleConfig())
          if lifecycle else None)
    an = (AnomalyManager(agg, wheel, AnomalyConfig(
        banks=3, bank_of=lambda t: t.second % 3, decay=0.8, min_samples=5,
        window=2.0)) if anomaly else None)
    com = IntervalCommitter(agg, wheel, chunk=CHUNK, lifecycle=lc,
                            anomaly=an)
    return com, agg, wheel


def _assert_wheels_equal(got, want, exact_sums):
    for t, wt in zip(got._tiers, want._tiers):
        np.testing.assert_array_equal(t.ring.numpy(), np.asarray(wt.ring))
        assert (t.slot, t.in_slot) == (wt.slot, wt.in_slot)
        np.testing.assert_array_equal(t.written, wt.written)
        np.testing.assert_array_equal(t.durations, wt.durations)
        assert t.rates == wt.rates
    assert got.intervals_pushed == want.intervals_pushed
    assert got.samples_retained == want.samples_retained
    sg, sw = got.snapshot, want.snapshot
    assert (sg is None) == (sw is None)
    if sg is None:
        return
    assert sg.epoch == sw.epoch
    for tg, tw in zip(sg.tiers, sw.tiers):
        assert len(tg.views) == len(tw.views)
        for vg, vw in zip(tg.views, tw.views):
            assert (vg.window_s, vg.covered_s, vg.slots) == (
                vw.window_s, vw.covered_s, vw.slots)
            np.testing.assert_array_equal(vg.mask, vw.mask)
            np.testing.assert_array_equal(vg.cdf.numpy(), np.asarray(vw.cdf))
            np.testing.assert_array_equal(vg.counts.numpy(),
                                          np.asarray(vw.counts))
            _assert_sums(vg.sums, vw.sums, exact_sums)


def _assert_sums(got, want, exact):
    got, want = np.asarray(got), np.asarray(want)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _assert_acc_snapshots_equal(got, want, exact_sums):
    assert (got is None) == (want is None)
    if got is None:
        return
    assert got.epoch == want.epoch
    np.testing.assert_array_equal(got.cdf.numpy(), np.asarray(want.cdf))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    _assert_sums(got.sums, want.sums, exact_sums)


def _assert_carry(got, want, **tol):
    assert (got is None) == (want is None)
    if got is None:
        return
    if tol:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("lifecycle,anomaly", [
    (False, False), (True, False), (False, True), (True, True)])
def test_committer_matches_jax_committer(lifecycle, anomaly):
    jcom, jagg, jwheel = _jax_stack(lifecycle, anomaly)
    pcom, pagg, pwheel = _port_stack(lifecycle, anomaly)
    for raw in _intervals(11, 12):
        assert pcom.commit(raw) == jcom.commit(raw)
        assert pcom.last_dispatches == jcom.last_dispatches
        assert pagg.registry.names() == jagg.registry.names()
        np.testing.assert_array_equal(pagg._acc.numpy(),
                                      np.asarray(jagg._acc))
        _assert_wheels_equal(pwheel, jwheel, exact_sums=False)
        _assert_acc_snapshots_equal(pagg.stats_snapshot,
                                    jagg.stats_snapshot, exact_sums=False)
        assert pagg._interval_ingested == jagg._interval_ingested
        if lifecycle:
            _assert_carry(pcom.lifecycle._la, jcom.lifecycle._la)
        if anomaly:
            pa, ja = pcom.anomaly, jcom.anomaly
            _assert_carry(pa._ihist, ja._ihist)
            _assert_carry(pa._prof, ja._prof, rtol=1e-6, atol=1e-7)
            _assert_carry(pa._wsum, ja._wsum, rtol=1e-6, atol=1e-7)
    assert pcom.fused_intervals == jcom.fused_intervals > 0
    assert (pcom.intervals_committed, pcom.fanout_intervals) == (
        jcom.intervals_committed, jcom.fanout_intervals)


def test_committer_matches_jax_with_registry_growth_past_wheel_rows():
    """Names past the wheel's rows land in the grown accumulator and
    drop off every ring, as in the JAX committer."""
    jcom, jagg, jwheel = _jax_stack(m=2, max_metrics=16)
    pcom, pagg, pwheel = _port_stack(m=2, max_metrics=16)
    for i in range(6):
        raw = _raw(i, {f"grow{j}": {j: 10 + j} for j in range(i + 2)})
        pcom.commit(raw)
        jcom.commit(raw)
    assert pagg.num_metrics == jagg.num_metrics > pwheel.num_metrics
    np.testing.assert_array_equal(pagg._acc.numpy(), np.asarray(jagg._acc))
    _assert_wheels_equal(pwheel, jwheel, exact_sums=False)


def _fanout_pair():
    cfg = MetricConfig(bucket_limit=BL)
    agg = TorchAggregator(num_metrics=M, config=cfg, device="cpu")
    wheel = TimeWheel(num_metrics=M, config=cfg, interval=1.0, tiers=TIERS,
                      registry=agg.registry, device="cpu")
    return agg, wheel


@pytest.mark.parametrize("seed", [3, 4])
def test_committer_equals_its_own_fanout_path(seed):
    """The fused commit and merge_raw + push compute the same bits:
    accumulator, rings, metadata and every snapshot view."""
    pcom, pagg, pwheel = _port_stack()
    ragg, rwheel = _fanout_pair()
    for raw in _intervals(seed, 10):
        pcom.commit(raw)
        ragg.merge_raw(raw)
        rwheel.push(raw)
        np.testing.assert_array_equal(pagg._acc.numpy(), ragg._acc.numpy())
        _assert_wheels_equal(pwheel, rwheel, exact_sums=True)


def test_spill_routes_the_interval_to_the_fanout_like_jax():
    jcom, jagg, jwheel = _jax_stack(lifecycle=True)
    pcom, pagg, pwheel = _port_stack(lifecycle=True)
    stream = _intervals(5, 3)
    stream.insert(1, _raw(9, {"svc.giant": {7: (1 << 30) + 3, 8: 2}}))
    stream.append(_raw(10, {"svc.m1": {1: 1 << 29}, "svc.m2": {1: 1 << 29}}))
    modes = []
    for raw in stream:
        modes.append(pcom.commit(raw))
        assert modes[-1] == jcom.commit(raw)
        assert pcom.last_dispatches == jcom.last_dispatches
    assert "fanout" in modes and pcom.fanout_intervals == jcom.fanout_intervals
    assert pagg.stats_snapshot is None
    np.testing.assert_array_equal(pagg._acc.numpy(), np.asarray(jagg._acc))
    np.testing.assert_array_equal(pagg._spill, jagg._spill)
    _assert_wheels_equal(pwheel, jwheel, exact_sums=False)
    _assert_carry(pcom.lifecycle._la, jcom.lifecycle._la)


def test_last_dispatches_counts_commit_steps():
    pcom, pagg, _ = _port_stack()
    hists = {f"svc.m{i}": {b: 1 for b in range(7 * i + 3)} for i in range(5)}
    cells = sum(len(h) for h in hists.values())
    assert pcom.commit(_raw(0, hists)) == "fused"
    assert pcom.last_dispatches == -(-cells // CHUNK)
    assert pcom.last_uploads == pcom.last_dispatches
    assert pcom.last_h2d_bytes == cells * 12
    assert pcom.commit(_raw(1)) == "empty" and pcom.last_dispatches == 0
    assert int(pagg._acc.sum()) == cells


def test_fused_commit_step_clears_on_keep_zero_and_stamps_activity():
    commit = make_fused_commit_fn(2, BL, track_activity=True)
    acc = torch.zeros((4, 2 * BL + 1), dtype=torch.int32)
    rings = [torch.ones((3, 4, 2 * BL + 1), dtype=torch.int32),
             torch.ones((2, 3, 2 * BL + 1), dtype=torch.int32)]
    la = torch.zeros(4, dtype=torch.int32)
    packed = torch.tensor([[0, 0, 5], [3, -BL - 9, 2], [1, BL, 1],
                           [int(DROP_ID), 0, 7]], dtype=torch.int32)
    acc, rings, la = commit(acc, rings, la, [1, 0], [0, 1], packed, 6)
    assert int(acc[0, BL]) == 5 and int(acc[3, 0]) == 2
    assert int(acc.sum()) == 8  # the DROP_ID pad dropped
    assert int(rings[0][1].sum()) == 8 and int(rings[0][0].sum()) == 4 * 129
    # ring 1 holds 3 rows: id 3 drops there, the slot was kept (x1)
    assert int(rings[1][0].sum()) == 3 * 129 + 6
    assert la.tolist() == [6, 6, 0, 6]


def test_stamp_activity_is_a_max_and_ignores_out_of_range_ids():
    la = torch.tensor([5, 1, 9], dtype=torch.int32)
    ids = torch.tensor([0, 1, 2, -1, 3, int(DROP_ID)], dtype=torch.int32)
    stamp_activity(la, ids, 4)
    assert la.tolist() == [5, 4, 9]


def test_staging_ring_contracts():
    with pytest.raises(ValueError, match="depth"):
        CellStagingRing(depth=1)
    ring = CellStagingRing(depth=2, width=4, device="cpu")
    with pytest.raises(ValueError, match="exceeds staging width"):
        ring.stage(np.zeros(5), np.zeros(5), np.zeros(5))
    a = ring.stage(np.array([1, 2]), np.array([-3, 4]), np.array([7, 8]))
    b = ring.stage(np.array([3]), np.array([5]), np.array([9]))
    c = ring.stage(np.array([6, 6, 6]), np.array([0, 0, 0]),
                   np.array([1, 1, 1]))
    # the slot of `a` was rewritten by `c`: what was staged must not move
    assert a.tolist() == [[1, -3, 7], [2, 4, 8]]
    assert b.tolist() == [[3, 5, 9]] and c.shape == (3, 3)
    assert (ring.uploads, ring.bytes_uploaded) == (3, 6 * 12)
    assert COMMIT_CHUNK == 1 << 16 and int(DROP_ID) == 2**30


def test_commit_incompatibility_and_refusals():
    cfg = MetricConfig(bucket_limit=BL)
    agg = TorchAggregator(num_metrics=M, config=cfg, device="cpu")
    foreign = TimeWheel(num_metrics=M, config=cfg, tiers=TIERS,
                        device="cpu")
    assert "different registries" in commit_incompatibility(agg, foreign)
    other = TimeWheel(num_metrics=M, config=MetricConfig(bucket_limit=32),
                      tiers=TIERS, registry=agg.registry, device="cpu")
    assert "bucket_limit" in commit_incompatibility(agg, other)
    prec = TimeWheel(num_metrics=M, config=MetricConfig(bucket_limit=BL,
                                                        precision=50),
                     tiers=TIERS, registry=agg.registry, device="cpu")
    assert "precision" in commit_incompatibility(agg, prec)
    with pytest.raises(ValueError, match="different registries"):
        IntervalCommitter(agg, foreign)
    nosnap = TimeWheel(num_metrics=M, config=cfg, tiers=TIERS,
                       registry=agg.registry, snapshots=False, device="cpu")
    with pytest.raises(ValueError, match="snapshots"):
        IntervalCommitter(agg, nosnap, anomaly=object())
    pcfg = MetricConfig(bucket_limit=512)
    paged = TorchAggregator(num_metrics=M, config=pcfg, storage="paged",
                            device="cpu")
    pw = TimeWheel(num_metrics=M, config=pcfg, tiers=TIERS,
                   registry=paged.registry, device="cpu")
    # paged storage joins the fused commit; only the drift engine, whose
    # carries are dense [M, B] tensors, stays dense-only
    assert commit_incompatibility(paged, pw) is None
    com = IntervalCommitter(paged, pw)
    assert com.paged is paged.paged
    assert "paged_scatter" in com.kernel_names()
    dense_wheel = TimeWheel(num_metrics=M, config=cfg, tiers=TIERS,
                            registry=agg.registry, device="cpu")
    assert "paged_scatter" not in IntervalCommitter(
        agg, dense_wheel).kernel_names()
    with pytest.raises(ValueError, match="drift engine requires the dense "
                                         "accumulator"):
        IntervalCommitter(paged, pw, anomaly=object())
    paged.close()


def test_snapshots_off_commits_without_publishing():
    cfg = MetricConfig(bucket_limit=BL)
    agg = TorchAggregator(num_metrics=M, config=cfg, device="cpu")
    wheel = TimeWheel(num_metrics=M, config=cfg, tiers=TIERS,
                      registry=agg.registry, snapshots=False, device="cpu")
    com = IntervalCommitter(agg, wheel, chunk=CHUNK)
    for raw in _intervals(8, 4):
        com.commit(raw)
    assert wheel.snapshot is None and agg.stats_snapshot is None
    assert wheel.query("*", 2.0).metrics  # locked recompute
    ragg, rwheel = _fanout_pair()
    for raw in _intervals(8, 4):
        ragg.merge_raw(raw)
        rwheel.push(raw)
    np.testing.assert_array_equal(agg._acc.numpy(), ragg._acc.numpy())


def test_committer_gauges_and_bridge():
    ms = MetricSystem(interval=0.05, sys_stats=False)
    pcom, pagg, pwheel = _port_stack(lifecycle=True, anomaly=True)
    pcom.register_gauges(ms)
    pcom.attach(ms)
    with pytest.raises(RuntimeError, match="already attached"):
        pcom.attach(ms)
    ms.start()
    try:
        import time

        deadline = time.monotonic() + 20.0
        while pcom.fused_intervals < 3:
            ms.histogram_batch("svc.lat", np.full(40, 0.25))
            assert time.monotonic() < deadline, "no interval committed"
            time.sleep(0.02)
    finally:
        ms.stop()
        pcom.detach()
    gauges = ms.collect_raw_metrics().gauges
    assert gauges["commit.FusedIntervals"] >= 3
    assert gauges["commit.DispatchesPerInterval"] >= 0
    assert gauges["commit.LatencyP99Us"] >= gauges["commit.LatencyP50Us"] > 0
    assert "commit.BridgeEvictions" in gauges
    # the commit latency rides the normal pipeline as a histogram
    assert pagg.registry.lookup("commit.LatencyUs") is not None
