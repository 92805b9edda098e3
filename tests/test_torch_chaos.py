"""Chaos drills on the port against the JAX package: scripted fault plans
through both pipelines on the same seeded inputs (port copies of
``tests/test_chaos.py``, plus the cross-package recovery, the D6
recovery of a failed fused commit on dense and paged storage, and the
shed-and-retry parity of the transfer worker).

Tolerances, port against JAX (ROADMAP F1):
  * counts, report fields, shed and pending counts, accumulators, rings,
    page tables, pools, host spills: EQUAL;
  * ``collect()`` sums: rtol 2e-6 (float32 bucket representatives, summed
    in another order); percentile values rtol 4e-6 (XLA's float32
    ``exp``);
  * port against port (a recovered stack against its oracle): EQUAL,
    percentiles included.

No assertion reads the wall clock: cooldowns are 0 (or an hour, where a
test needs the gate shut), the breaker's open time runs on a patched
clock, the watchdog's latch on a moved clock, wedges are released by
hand, every wait is on a counter with a 30 s deadline, and the JAX
commit steps are waited for (``_synchronised``, ROADMAP F3)."""

import datetime as dt
import itertools
import queue
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loghisto_tpu.obs.health as jax_health
import loghisto_tpu.resilience as jax_res
import loghisto_tpu.resilience.recovery as jax_recovery
import loghisto_tpu_torch.obs.health as port_health
import loghisto_tpu_torch.ops.commit as port_step
import loghisto_tpu_torch.resilience as port_res
import loghisto_tpu_torch.resilience.recovery as port_recovery
from loghisto_tpu.anomaly import AnomalyConfig as JaxAnomalyConfig
from loghisto_tpu.anomaly import AnomalyManager as JaxAnomalyManager
from loghisto_tpu.commit import IntervalCommitter as JaxCommitter
from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.lifecycle import LifecycleConfig as JaxLifecycleConfig
from loghisto_tpu.lifecycle import LifecycleManager as JaxLifecycleManager
from loghisto_tpu.ops.codec import compress_np as jax_compress_np
from loghisto_tpu.ops.ingest import bucket_indices as jax_bucket_indices
from loghisto_tpu.paging import PagedStoreConfig as JaxPagedConfig
from loghisto_tpu.parallel.aggregator import TPUAggregator
from loghisto_tpu.utils import journal as jax_journal
from loghisto_tpu.window import TimeWheel as JaxWheel
from loghisto_tpu_torch.anomaly import AnomalyConfig, AnomalyManager
from loghisto_tpu_torch.commit import IntervalCommitter
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.lifecycle import LifecycleConfig, LifecycleManager
from loghisto_tpu_torch.metrics import RawMetricSet
from loghisto_tpu_torch.ops.codec import compress_np
from loghisto_tpu_torch.paging import PagedStoreConfig
from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
from loghisto_tpu_torch.utils import journal
from loghisto_tpu_torch.window.store import TimeWheel

BL = 64
CFG, JCFG = MetricConfig(bucket_limit=BL), JaxConfig(bucket_limit=BL)
DEADLINE_S = 30.0
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)


def _wait(cond, what):
    deadline = time.monotonic() + DEADLINE_S
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


def _raw(i, hists, counters=None):
    """One interval; the JAX committer takes the port's RawMetricSet
    (duck-typed), and the journal lines of both packages are alike."""
    return RawMetricSet(time=T0 + dt.timedelta(seconds=i),
                        counters=dict(counters or {}), rates={},
                        histograms=hists, gauges={}, duration=1.0, seq=i)


def _synchronised(com):
    """Wait for each JAX commit step before the next is staged (ROADMAP
    F3: on the CPU ``jax.device_put`` reads the staging slot after it
    returns)."""
    for attr in ("_fused", "_fused_snap"):
        step = getattr(com, attr)
        setattr(com, attr,
                lambda *a, _step=step: jax.block_until_ready(_step(*a)))
    return com


def _port_build(inj=None, breaker=None):
    agg = TorchAggregator(num_metrics=16, config=CFG, device="cpu")
    wheel = TimeWheel(num_metrics=16, config=CFG, interval=1.0,
                      tiers=((4, 2),), registry=agg.registry, device="cpu")
    com = IntervalCommitter(agg, wheel)
    com.fault_injector, com.breaker = inj, breaker
    agg.fault_injector, agg.device_breaker = inj, breaker
    com.warmup()
    return com, agg, wheel


def _jax_build(inj=None, breaker=None):
    agg = TPUAggregator(num_metrics=16, config=JCFG, storage="dense")
    wheel = JaxWheel(num_metrics=16, config=JCFG, interval=1.0,
                     tiers=((4, 2),), registry=agg.registry,
                     merge_path="jnp")
    com = _synchronised(JaxCommitter(agg, wheel))
    com.fault_injector, com.breaker = inj, breaker
    agg.fault_injector, agg.device_breaker = inj, breaker
    com.warmup()
    return com, agg, wheel


# (build, resilience package, journal module) of each package
PORT = (_port_build, port_res, journal)
JAX = (_jax_build, jax_res, jax_journal)


def _snap(agg):
    """Every device statistic (counts, sums, percentiles) as one dict."""
    return dict(sorted(agg.collect(reset=False).metrics.items()))


def _assert_close_to_jax(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if key.endswith(("_count", "_agg_count")):
            assert g == w, key
        elif key.endswith(("_sum", "_avg")):
            assert g == pytest.approx(w, rel=2e-6, abs=1e-6), key
        else:
            assert int(compress_np([g])[0]) == int(compress_np([w])[0]), key
            assert g == pytest.approx(w, rel=4e-6, abs=0), key


# -- crash at every stage: at most one interval lost ------------------------


def _crash_scene(side, ck, jl, stage):
    """The doomed run: commit 6 intervals, checkpoint at seq 2 and 4,
    journal every interval, then crash per the stage.  Returns the
    intervals and the seq lost."""
    build, res, jmod = side
    raws = [_raw(i, {"lat": {i % 7: 10 + i}}, {"reqs": 100 * i})
            for i in range(1, 7)]
    com, agg, wheel = build()
    rec = res.RecoveryManager(None, aggregator=agg, committer=com,
                              checkpoint_path=ck, journal_path=jl,
                              checkpoint_every_intervals=10_000)
    tear = res.FaultInjector(seed=5).plan("journal.append", "truncate")
    lost = None
    with open(jl, "w") as f:
        for r in raws:
            com.commit(r)
            rec.on_commit(r)
            line = jmod.dump_line(r) + "\n"
            if stage == "mid_journal_append" and r.seq == 6:
                line = tear.mangle("journal.append", line)
                lost = 6
            f.write(line)
            if r.seq == 2:
                assert rec.checkpoint_now()
            if r.seq == 4:
                if stage == "mid_checkpoint_rename":
                    rec.fault_injector = res.FaultInjector().plan(
                        "checkpoint.rename", "raise")
                    assert not rec.checkpoint_now()
                    assert rec.checkpoint_errors == 1
                    rec.fault_injector = None
                else:
                    assert rec.checkpoint_now()
    agg.close()
    return raws, lost


def _recover(side, ck, jl):
    """A fresh stack recovering (ck, jl): (report fields, snap, wheel's
    pushed count)."""
    build, res, _ = side
    com, agg, wheel = build()
    rec = res.RecoveryManager(None, aggregator=agg, committer=com,
                              checkpoint_path=ck, journal_path=jl)
    report = rec.recover()
    fields = (report.watermark, report.replayed_intervals,
              report.skipped_intervals, report.corrupt_lines,
              report.checkpoint_found, report.journal_found)
    out = fields, _snap(agg), wheel.intervals_pushed
    agg.close()
    return out


def _oracle(side, survived):
    com, agg, _ = side[0]()
    for r in survived:
        com.commit(r)
    out = _snap(agg)
    agg.close()
    return out


@pytest.mark.parametrize("stage", [
    "after_checkpoint",        # kill right after a checkpoint landed
    "mid_journal_append",      # kill mid-append: torn final line
    "mid_checkpoint_rename",   # kill between fsync and rename
])
def test_crash_at_every_stage_loses_at_most_one_interval(tmp_path, stage):
    results = {}
    for name, side in (("jax", JAX), ("port", PORT)):
        ck, jl = str(tmp_path / f"{name}.npz"), str(tmp_path / f"{name}.jl")
        raws, lost = _crash_scene(side, ck, jl, stage)
        fields, snap, pushed = _recover(side, ck, jl)
        survived = [r for r in raws if r.seq != lost]
        results[name] = fields, snap, pushed, _oracle(side, survived)
    fields, snap, pushed, oracle = results["port"]
    wm = 2 if stage == "mid_checkpoint_rename" else 4
    replayed = len(survived) - wm
    corrupt = 1 if stage == "mid_journal_append" else 0
    assert fields == (wm, replayed, wm, corrupt, True, True)
    assert fields == results["jax"][0]
    assert snap == oracle  # the port's recovery: bit-identical
    assert pushed == replayed == results["jax"][2]
    _assert_close_to_jax(snap, results["jax"][1])


def test_crash_scene_recovers_across_packages(tmp_path):
    """A scene written by one package is recovered by the other: the
    result equals the writer's own recovery (EQUAL counts and report,
    float statistics within the F1 tolerances)."""
    for writer, reader in ((JAX, PORT), (PORT, JAX)):
        ck = str(tmp_path / f"{id(writer)}.npz")
        jl = str(tmp_path / f"{id(writer)}.jl")
        _crash_scene(writer, ck, jl, "mid_journal_append")
        own = _recover(writer, ck, jl)
        other = _recover(reader, ck, jl)
        assert other[0] == own[0] == (4, 1, 4, 1, True, True)
        assert other[2] == own[2] == 1
        port_snap, jax_snap = ((other[1], own[1]) if reader is PORT
                               else (own[1], other[1]))
        _assert_close_to_jax(port_snap, jax_snap)


def test_recover_advances_seq_counter_past_replay(tmp_path):
    jl = str(tmp_path / "j.jsonl")
    with open(jl, "w") as f:
        for r in [_raw(i, {"m": {1: 1}}) for i in (1, 2, 9)]:
            f.write(journal.dump_line(r) + "\n")
    for build, res, _ in (JAX, PORT):
        class FakeMS:
            _interval_seq = itertools.count(1)

        ms = FakeMS()
        com, agg, _ = build()
        report = res.RecoveryManager(ms, aggregator=agg, committer=com,
                                     journal_path=jl).recover()
        assert report.replayed_intervals == 3
        assert next(ms._interval_seq) == 10
        agg.close()


def test_recover_without_artifacts_is_a_clean_noop(tmp_path):
    for build, res, _ in (JAX, PORT):
        com, agg, _ = build()
        report = res.RecoveryManager(
            None, aggregator=agg, committer=com,
            checkpoint_path=str(tmp_path / "never.npz"),
            journal_path=str(tmp_path / "never.jsonl")).recover()
        assert not report.checkpoint_found and not report.journal_found
        assert report.replayed_intervals == 0 and report.watermark is None
        agg.close()


# -- scripted device failures: the breaker opens, samples conserved ---------


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def perf_counter(self):
        return time.perf_counter()


@pytest.fixture
def breaker_clock(monkeypatch):
    fake = FakeClock()
    for mod in (jax_recovery, port_recovery):
        monkeypatch.setattr(mod, "time", fake)
    return fake


def test_repeated_dispatch_failures_trip_breaker_and_pin_fanout():
    out = {}
    for name, (build, res, _) in (("jax", JAX), ("port", PORT)):
        inj = res.FaultInjector()
        inj.plan("commit.dispatch", "raise", every=1, times=3)
        br = res.CircuitBreaker(threshold=3, window_s=30.0, open_s=3600.0)
        com, agg, wheel = build(inj=inj, breaker=br)
        agg.retry_cooldown = 0.0
        modes = [com.commit(_raw(i, {"m": {1: 5}})) for i in (1, 2, 3)]
        trace = [inj.fires_at("commit.dispatch"), br.failures_total,
                 br.state, br.opened_total]
        # open: the next interval takes the pinned fan-out path, and no
        # further fused attempt is made
        modes.append(com.commit(_raw(4, {"m": {1: 5}})))
        trace.append(inj.fires_at("commit.dispatch"))
        out[name] = modes, trace, _snap(agg)
        agg.close()
    modes, trace, snap = out["port"]
    assert modes == ["fused", "fused", "fused", "fanout"]
    assert trace == [3, 3, "open", 1, 3]
    assert snap["m_count"] == 20.0
    assert (modes, trace) == out["jax"][:2]
    _assert_close_to_jax(snap, out["jax"][2])


def test_breaker_halfopen_trial_recloses_through_commit(breaker_clock):
    out = {}
    for name, (build, res, _) in (("jax", JAX), ("port", PORT)):
        br = res.CircuitBreaker(threshold=1, window_s=30.0, open_s=0.01)
        inj = res.FaultInjector().plan("commit.dispatch", "raise",
                                       on_call=1)
        com, agg, wheel = build(inj=inj, breaker=br)
        agg.retry_cooldown = 0.0
        com.commit(_raw(1, {"m": {1: 5}}))  # the failure opens it
        states = [br.state]
        breaker_clock.now += 0.02  # past open_s: the half-open trial
        states += [com.commit(_raw(2, {"m": {1: 5}})), br.state]
        out[name] = states, _snap(agg)["m_count"]
        agg.close()
    assert out["port"] == out["jax"] == (["open", "fused", "closed"], 10.0)


# -- D6: a failed fused commit is recovered ---------------------------------

D6_M = 32
D6_CHUNK = 16
D6_TIERS = ((4, 1), (3, 2))


def _d6_intervals(seed, n=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        hists = {}
        for k in range(8):
            h = hists.setdefault(f"svc.m{k}", {})
            for b in rng.integers(-4, 3 * BL // 2, 12).tolist():
                h[b] = h.get(b, 0) + int(rng.integers(1, 200))
        out.append(_raw(i + 1, hists))
    return out


def _d6_stacks(inj_port, inj_jax):
    jagg = TPUAggregator(num_metrics=D6_M, config=JCFG, storage="dense")
    jwheel = JaxWheel(num_metrics=D6_M, config=JCFG, interval=1.0,
                      tiers=D6_TIERS, registry=jagg.registry,
                      merge_path="jnp")
    jlc = JaxLifecycleManager(jagg, jwheel, JaxLifecycleConfig())
    jan = JaxAnomalyManager(jagg, jwheel, JaxAnomalyConfig(
        banks=3, bank_of=lambda t: t.second % 3, decay=0.8, min_samples=5,
        window=2.0, divergence_path="jnp"))
    jcom = _synchronised(JaxCommitter(jagg, jwheel, chunk=D6_CHUNK,
                                      lifecycle=jlc, anomaly=jan))
    pagg = TorchAggregator(num_metrics=D6_M, config=CFG, device="cpu")
    pwheel = TimeWheel(num_metrics=D6_M, config=CFG, interval=1.0,
                       tiers=D6_TIERS, registry=pagg.registry, device="cpu")
    plc = LifecycleManager(pagg, pwheel, LifecycleConfig())
    pan = AnomalyManager(pagg, pwheel, AnomalyConfig(
        banks=3, bank_of=lambda t: t.second % 3, decay=0.8, min_samples=5,
        window=2.0))
    pcom = IntervalCommitter(pagg, pwheel, chunk=D6_CHUNK, lifecycle=plc,
                             anomaly=pan)
    for com, agg, inj in ((jcom, jagg, inj_jax), (pcom, pagg, inj_port)):
        com.fault_injector = agg.fault_injector = inj
        agg.retry_cooldown = 0.0
    return (jcom, jagg, jwheel), (pcom, pagg, pwheel)


def _host_total(raws):
    hist = np.zeros((D6_M, 2 * BL + 1), dtype=np.int64)
    names = {}
    for raw in raws:
        for name, h in raw.histograms.items():
            row = names.setdefault(name, len(names))
            for b, c in h.items():
                hist[row, int(np.clip(b, -BL, BL)) + BL] += c
    return hist, names


@pytest.mark.parametrize("k", [1, 3])
def test_failed_dense_commit_recovers_like_the_reference(k):
    """commit.dispatch fires before chunk k of interval 3: the chunks
    before it land on the accumulator and the tiers, the rest in the
    exact host spill; the lifecycle and drift carries survive; the
    snapshot is dropped until the next commit publishes.  Accumulator,
    spill, rings, carries and snapshots EQUAL the JAX committer's, and
    accumulator + spill equal the host total of every interval."""
    raws = _d6_intervals(k)
    calls_before = sum(-(-sum(len(h) for h in r.histograms.values())
                         // D6_CHUNK) for r in raws[:2])
    inj_p = port_res.FaultInjector().plan(
        "commit.dispatch", "raise", on_call=calls_before + k + 1)
    inj_j = jax_res.FaultInjector().plan(
        "commit.dispatch", "raise", on_call=calls_before + k + 1)
    (jcom, jagg, jwheel), (pcom, pagg, pwheel) = _d6_stacks(inj_p, inj_j)
    try:
        for i, raw in enumerate(raws):
            assert pcom.commit(raw) == jcom.commit(raw) == "fused"
            assert inj_p.fired == inj_j.fired
            np.testing.assert_array_equal(pagg._acc.numpy(),
                                          np.asarray(jagg._acc))
            assert (pagg._spill is None) == (jagg._spill is None)
            if pagg._spill is not None:
                np.testing.assert_array_equal(pagg._spill, jagg._spill)
            for t, jt in zip(pwheel._tiers, jwheel._tiers):
                np.testing.assert_array_equal(t.ring.numpy(),
                                              np.asarray(jt.ring))
                assert (t.slot, t.in_slot) == (jt.slot, jt.in_slot)
            np.testing.assert_array_equal(pcom.lifecycle._la.numpy(),
                                          np.asarray(jcom.lifecycle._la))
            np.testing.assert_array_equal(pcom.anomaly._ihist.numpy(),
                                          np.asarray(jcom.anomaly._ihist))
            np.testing.assert_allclose(pcom.anomaly._prof.numpy(),
                                       np.asarray(jcom.anomaly._prof),
                                       rtol=1e-6, atol=1e-7)
            assert (pagg.stats_snapshot is None) == \
                (jagg.stats_snapshot is None)
            assert (pwheel.snapshot is None) == (jwheel.snapshot is None)
            assert pagg._interval_ingested == jagg._interval_ingested
            assert pagg._spilled_samples == jagg._spilled_samples
            if i == 2:
                # the failed interval: no snapshot, the spill holds the
                # unapplied chunks
                assert inj_p.fires_at("commit.dispatch") == 1
                assert pagg.stats_snapshot is None
                assert pagg._spill is not None
        want, names = _host_total(raws)
        got = pagg._acc.numpy().astype(np.int64) + pagg._spill
        rows = [pagg.registry.lookup(n) for n in names]
        np.testing.assert_array_equal(got[rows], want[:len(names)])
        _assert_close_to_jax(_snap(pagg), _snap(jagg))
    finally:
        jagg.close()
        pagg.close()


PG_BL = 128
PG_M = 48


def _pg_stacks(codec, inj_port, inj_jax):
    jagg = TPUAggregator(num_metrics=PG_M, config=JaxConfig(bucket_limit=PG_BL),
                         storage="paged", paged_config=JaxPagedConfig(
                             pool_pages=512, codec=codec))
    jwheel = JaxWheel(num_metrics=PG_M, config=JaxConfig(bucket_limit=PG_BL),
                      interval=1.0, tiers=D6_TIERS, registry=jagg.registry,
                      merge_path="jnp")
    jcom = _synchronised(JaxCommitter(jagg, jwheel, chunk=D6_CHUNK))
    pagg = TorchAggregator(num_metrics=PG_M,
                           config=MetricConfig(bucket_limit=PG_BL),
                           storage="paged", device="cpu",
                           paged_config=PagedStoreConfig(pool_pages=512,
                                                         codec=codec))
    pwheel = TimeWheel(num_metrics=PG_M, config=MetricConfig(bucket_limit=PG_BL),
                       interval=1.0, tiers=D6_TIERS, registry=pagg.registry,
                       device="cpu")
    pcom = IntervalCommitter(pagg, pwheel, chunk=D6_CHUNK)
    for com, agg, inj in ((jcom, jagg, inj_jax), (pcom, pagg, inj_port)):
        com.fault_injector = agg.fault_injector = inj
        agg.retry_cooldown = 0.0
    return (jcom, jagg, jwheel), (pcom, pagg, pwheel)


def _pg_cells(store):
    rows, idx, counts = store.decode_cells()
    order = np.lexsort((idx, rows))
    return rows[order], idx[order], counts[order]


@pytest.mark.parametrize("codec", ["dense", "auto"])
def test_failed_paged_commit_recovers_like_the_reference(codec):
    """The paged fused commit fails before chunk 2 of interval 2: pool,
    page table, codecs, host spill, rings EQUAL the JAX committer's, and
    pool + spill hold every sample committed."""
    rng = np.random.default_rng(17)
    raws = []
    for i in range(3):
        hists = {}
        for k in range(10):
            h = hists.setdefault(f"api.s{k}.lat", {})
            lo = 10 * k - 20
            for b in rng.integers(lo, lo + 30, 12).tolist():
                h[b] = h.get(b, 0) + int(rng.integers(1, 9))
        raws.append(_raw(i + 1, hists))
    first = -(-sum(len(h) for h in raws[0].histograms.values()) // D6_CHUNK)
    on = first + 3
    inj_p = port_res.FaultInjector().plan("commit.dispatch", "raise",
                                          on_call=on)
    inj_j = jax_res.FaultInjector().plan("commit.dispatch", "raise",
                                         on_call=on)
    (jcom, jagg, jwheel), (pcom, pagg, pwheel) = _pg_stacks(codec, inj_p,
                                                            inj_j)
    try:
        total = 0
        for raw in raws:
            assert pcom.commit(raw) == jcom.commit(raw) == "fused"
            total += sum(sum(h.values()) for h in raw.histograms.values())
            pst, jst = pagg.paged, jagg.paged
            np.testing.assert_array_equal(pst.page_table, jst.page_table)
            np.testing.assert_array_equal(pst.row_codec, jst.row_codec)
            assert pst._host_spill == jst._host_spill
            np.testing.assert_array_equal(pst._pool.numpy(),
                                          np.asarray(jst._pool))
            for t, jt in zip(pwheel._tiers, jwheel._tiers):
                np.testing.assert_array_equal(t.ring.numpy(),
                                              np.asarray(jt.ring))
            assert pagg._interval_ingested == jagg._interval_ingested
            assert pagg._spilled_samples == jagg._spilled_samples
        assert inj_p.fired == inj_j.fired == [("commit.dispatch", "raise",
                                               on)]
        assert pagg.paged._host_spill
        for g, w in zip(_pg_cells(pagg.paged), _pg_cells(jagg.paged)):
            np.testing.assert_array_equal(g, w)
        _, _, counts = pagg.paged.decode_cells()
        assert int(counts.sum()) == total
    finally:
        jagg.close()
        pagg.close()


def _raise_on_call(monkeypatch, name, on_call):
    """Make the port's ``ops.commit.<name>`` raise, as the card's
    allocator would, on its ``on_call``-th call: the launches before it
    in the same commit step have run."""
    real = getattr(port_step, name)
    calls = itertools.count(1)

    def boom(*a, **kw):
        if next(calls) == on_call:
            raise torch.cuda.OutOfMemoryError(f"{name}: injected")
        return real(*a, **kw)

    monkeypatch.setattr(port_step, name, boom)


@pytest.mark.parametrize("name", ["stamp_activity", "window_snapshot",
                                  "dense_cdf"])
def test_dense_step_failing_after_its_fold_counts_the_chunk_once(
        monkeypatch, name):
    """A port commit step is several launches, not one program: here a
    launch after K3 raises in interval 3 (chunk 1's activity stamp, or
    the final step's snapshot payloads).  That chunk already sits in
    the accumulator and the tiers, so the recovery spills only the
    chunks after it: accumulator, spill and rings EQUAL the JAX
    committer's whose dispatch failed one chunk later (or never, for
    the final step), and accumulator + spill equal the host total."""
    raws = _d6_intervals(5)
    before = sum(-(-sum(len(h) for h in r.histograms.values()) // D6_CHUNK)
                 for r in raws[:2])
    final = name != "stamp_activity"
    inj_j = jax_res.FaultInjector()
    if final:
        on_call = 3 if name == "dense_cdf" else 2 * len(D6_TIERS) + 1
    else:
        on_call = before + 2
        inj_j.plan("commit.dispatch", "raise", on_call=on_call + 1)
    _raise_on_call(monkeypatch, name, on_call)
    (jcom, jagg, jwheel), (pcom, pagg, pwheel) = _d6_stacks(
        port_res.FaultInjector(), inj_j)
    try:
        for i, raw in enumerate(raws):
            assert pcom.commit(raw) == jcom.commit(raw) == "fused"
            np.testing.assert_array_equal(pagg._acc.numpy(),
                                          np.asarray(jagg._acc))
            assert (pagg._spill is None) == (jagg._spill is None)
            if pagg._spill is not None:
                np.testing.assert_array_equal(pagg._spill, jagg._spill)
            for t, jt in zip(pwheel._tiers, jwheel._tiers):
                np.testing.assert_array_equal(t.ring.numpy(),
                                              np.asarray(jt.ring))
                assert (t.slot, t.in_slot) == (jt.slot, jt.in_slot)
            if not final:
                # both sides ran their engines' failure handlers
                np.testing.assert_array_equal(
                    pcom.lifecycle._la.numpy(),
                    np.asarray(jcom.lifecycle._la))
                np.testing.assert_array_equal(
                    pcom.anomaly._ihist.numpy(),
                    np.asarray(jcom.anomaly._ihist))
            assert pagg._interval_ingested == jagg._interval_ingested
            assert pagg._spilled_samples == jagg._spilled_samples
            if i == 2:
                assert pagg.stats_snapshot is None
                assert pwheel.snapshot is None
                assert (pagg._spill is None) == final
        want, names = _host_total(raws)
        got = pagg._acc.numpy().astype(np.int64)
        if pagg._spill is not None:
            got = got + pagg._spill
        rows = [pagg.registry.lookup(n) for n in names]
        np.testing.assert_array_equal(got[rows], want[:len(names)])
    finally:
        jagg.close()
        pagg.close()


@pytest.mark.parametrize("name", ["sparse_ingest_multi", "window_snapshot"])
def test_paged_step_failing_after_k4_lands_the_chunk_once(monkeypatch,
                                                          name):
    """On paged storage K4 puts a chunk into the pool before K3 puts it
    into the tiers.  A failure after K4 (chunk 2's K3 in interval 2, or
    the final step's payloads) must not re-land the chunk's triples:
    pool, page table, codecs and host spill EQUAL the JAX committer's
    whose dispatch failed one chunk later (or never), the rings EQUAL
    the one whose dispatch failed at the same chunk (K3 never ran) or
    never, and pool + spill hold every sample."""
    rng = np.random.default_rng(18)
    raws = []
    for i in range(3):
        hists = {}
        for k in range(10):
            h = hists.setdefault(f"api.s{k}.lat", {})
            lo = 10 * k - 20
            for b in rng.integers(lo, lo + 30, 12).tolist():
                h[b] = h.get(b, 0) + int(rng.integers(1, 9))
        raws.append(_raw(i + 1, hists))
    first = -(-sum(len(h) for h in raws[0].histograms.values()) // D6_CHUNK)
    pool_inj, ring_inj = jax_res.FaultInjector(), jax_res.FaultInjector()
    if name == "sparse_ingest_multi":
        on_call = first + 3
        pool_inj.plan("commit.dispatch", "raise", on_call=on_call + 1)
        ring_inj.plan("commit.dispatch", "raise", on_call=on_call)
    else:
        on_call = len(D6_TIERS) + 1
    _raise_on_call(monkeypatch, name, on_call)
    (jcom, jagg, _), (pcom, pagg, pwheel) = _pg_stacks(
        "auto", port_res.FaultInjector(), pool_inj)
    (rcom, ragg, rwheel), (_, spare, _) = _pg_stacks(
        "auto", port_res.FaultInjector(), ring_inj)
    spare.close()
    try:
        total = 0
        for raw in raws:
            assert pcom.commit(raw) == jcom.commit(raw) == "fused"
            assert rcom.commit(raw) == "fused"
            total += sum(sum(h.values()) for h in raw.histograms.values())
            pst, jst = pagg.paged, jagg.paged
            np.testing.assert_array_equal(pst.page_table, jst.page_table)
            np.testing.assert_array_equal(pst.row_codec, jst.row_codec)
            assert pst._host_spill == jst._host_spill
            np.testing.assert_array_equal(pst._pool.numpy(),
                                          np.asarray(jst._pool))
            for t, rt in zip(pwheel._tiers, rwheel._tiers):
                np.testing.assert_array_equal(t.ring.numpy(),
                                              np.asarray(rt.ring))
            assert pagg._interval_ingested == jagg._interval_ingested
            assert pagg._spilled_samples == jagg._spilled_samples
            _, _, counts = pagg.paged.decode_cells()
            assert int(counts.sum()) == total
        for g, w in zip(_pg_cells(pagg.paged), _pg_cells(jagg.paged)):
            np.testing.assert_array_equal(g, w)
    finally:
        for agg in (jagg, ragg, pagg):
            agg.close()


# -- the transfer worker: wedge, crash, shed and retry ----------------------


def _agreeing(rng, n, bl=BL):
    """Values on which the JAX float32 codec and the float64 codec agree
    (ROADMAP F1)."""
    v = rng.lognormal(-1.5, 0.6, 4 * n).astype(np.float32)
    got = np.asarray(jax_bucket_indices(jnp.asarray(v), bl)) - bl
    return v[got == np.clip(jax_compress_np(v), -bl, bl)][:n]


def _agg_pair(**kw):
    jagg = TPUAggregator(num_metrics=16, config=JCFG, storage="dense",
                         transport="raw", **kw)
    pagg = TorchAggregator(num_metrics=16, config=CFG, device="cpu",
                           transport="raw", **kw)
    for name in ("m", "n"):
        assert jagg.registry.id_for(name) == pagg.registry.id_for(name)
    return jagg, pagg


def test_wedged_transfer_worker_backs_up_then_drains():
    for res, agg in zip((jax_res, port_res), _agg_pair()):
        inj = res.FaultInjector(wedge_timeout_s=DEADLINE_S)
        inj.plan("agg.xfer_worker", "wedge", on_call=1)
        agg.fault_injector = inj
        mid = agg.registry.id_for("m")
        agg.record_batch(np.full(100, mid, np.int32),
                         np.ones(100, np.float32))
        agg.flush()  # enqueue-only; the worker wedges at its loop top
        _wait(lambda: inj.wedged_now == 1, "the wedge")
        assert not agg.wait_transfers(timeout=0.3)  # no deadlock
        inj.release_wedges()
        assert agg.wait_transfers(timeout=DEADLINE_S)
        assert agg.collect(reset=False).metrics["m_count"] == 100.0
        agg.close()


def test_crashed_transfer_worker_respawns_on_next_enqueue():
    names = ("loghisto-tpu-xfer", "loghisto-torch-xfer")
    for res, agg, name in zip((jax_res, port_res), _agg_pair(), names):
        inj = res.FaultInjector()
        inj.plan("agg.xfer_worker", "raise", on_call=1)
        sup = res.ThreadSupervisor()
        agg.fault_injector, agg.supervisor = inj, sup
        mid = agg.registry.id_for("m")
        agg.record_batch(np.full(50, mid, np.int32), np.ones(50, np.float32))
        agg.flush()  # the worker crashes at its loop top; the item waits
        _wait(lambda: not agg._xfer_thread.is_alive(), "the crash")
        agg.record_batch(np.full(50, mid, np.int32), np.ones(50, np.float32))
        agg.flush(force=True)
        assert sup.restarts_by_name == {name: 1}
        assert agg.collect(reset=False).metrics["m_count"] == 100.0
        agg.close()


def test_wedge_sheds_oldest_first_like_the_reference():
    """With the worker wedged the queue fills to max_pending_samples;
    later flushes return at once and the host buffer sheds its oldest
    samples.  The shed, pending and queued counts and, after the release,
    collect() equal the JAX aggregator's, and shed + counted = recorded."""
    rng = np.random.default_rng(29)
    script = []
    for _ in range(12):
        n = int(rng.integers(20, 90))
        script.append((rng.integers(0, 2, n).astype(np.int32),
                       _agreeing(rng, n)))
    recorded = sum(len(ids) for ids, _ in script)
    out = []
    for res, agg in zip((jax_res, port_res), _agg_pair(batch_size=64)):
        agg.max_pending_samples = 160
        inj = res.FaultInjector(wedge_timeout_s=DEADLINE_S)
        inj.plan("agg.xfer_worker", "wedge", on_call=1)
        agg.fault_injector = inj
        trace = []
        for ids, values in script:
            agg.record_batch(ids, values)
            trace.append((agg._shed_samples, agg.pending_samples,
                          agg._xfer_queued_samples))
        _wait(lambda: inj.wedged_now == 1, "the wedge")
        inj.release_wedges()
        metrics = agg.collect().metrics
        counted = metrics.get("m_count", 0.0) + metrics.get("n_count", 0.0)
        assert agg._shed_samples > 0
        assert agg._shed_samples + counted == recorded
        out.append((trace, agg._shed_samples, metrics))
        agg.close()
    (jtrace, jshed, jmetrics), (ptrace, pshed, pmetrics) = out
    assert ptrace == jtrace and pshed == jshed
    _assert_close_to_jax(pmetrics, jmetrics)


@pytest.mark.parametrize("cooldown", [0.0, 3600.0])
def test_device_failure_requeues_and_retries_like_the_reference(cooldown):
    """agg.ingest fires on the second chunk of a flush: the chunk before
    it lands, the rest is requeued; with no cooldown the forced barrier
    lands it, with an hour's cooldown non-forced flushes keep buffering
    (bounded, oldest shed) until a forced flush.  Every count, the
    breaker's ledger and collect() equal the JAX aggregator's."""
    rng = np.random.default_rng(31)
    batches = [(rng.integers(0, 2, 200).astype(np.int32),
                _agreeing(rng, 200)) for _ in range(4)]
    out = []
    for res, agg in zip((jax_res, port_res), _agg_pair(batch_size=64)):
        inj = res.FaultInjector().plan("agg.ingest", "raise", on_call=2)
        br = res.CircuitBreaker(threshold=10)
        agg.fault_injector, agg.device_breaker = inj, br
        agg.retry_cooldown = cooldown
        agg.max_pending_samples = 300
        trace = []
        agg.record_batch(*batches[0])
        agg.flush()
        assert agg.wait_transfers(timeout=DEADLINE_S)
        trace.append((agg.pending_samples, agg._shed_samples,
                      agg._device_down_until > 0.0))
        for ids, values in batches[1:]:
            agg.record_batch(ids, values)
            agg.flush()
            assert agg.wait_transfers(timeout=DEADLINE_S)
            trace.append((agg.pending_samples, agg._shed_samples))
        metrics = agg.collect().metrics
        counted = metrics.get("m_count", 0.0) + metrics.get("n_count", 0.0)
        assert agg._shed_samples + counted == 800
        assert agg.pending_samples == 0
        out.append((trace, br.failures_total, inj.fired,
                    agg._shed_samples, metrics))
        agg.close()
    assert out[1][:4] == out[0][:4]
    assert out[1][1] == 1
    if cooldown:
        assert out[1][3] > 0  # the gate held: the buffer's bound shed
    _assert_close_to_jax(out[1][4], out[0][4])


# -- scripted slow consumer / clock step ------------------------------------


def test_delay_fault_slows_but_never_corrupts():
    for res, wheel in (
            (jax_res, JaxWheel(num_metrics=16, config=JCFG, interval=1.0,
                               tiers=((4, 2),), merge_path="jnp")),
            (port_res, TimeWheel(num_metrics=16, config=CFG, interval=1.0,
                                 tiers=((4, 2),), device="cpu"))):
        inj = res.FaultInjector()
        inj.plan("wheel.push", "delay", delay_s=0.01, every=1, times=3)
        wheel.fault_injector = inj
        for i in (1, 2, 3):
            wheel.push(_raw(i, {"m": {2: 7}}))
        assert inj.fires_at("wheel.push") == 3
        assert wheel.intervals_pushed == 3
        assert wheel.query("m", window=8).metrics["m"]["count"] == 21


def test_backward_clock_step_cannot_stall_checkpoint_cadence(tmp_path):
    for name, (build, res, _) in (("jax", JAX), ("port", PORT)):
        inj = res.FaultInjector()
        inj.plan("recovery.tick", "clock_step", step_s=-3600.0)
        com, agg, _ = build()
        rec = res.RecoveryManager(
            None, aggregator=agg, committer=com,
            checkpoint_path=str(tmp_path / f"{name}.npz"),
            checkpoint_every_intervals=2, fault_injector=inj)
        for i in (1, 2, 3, 4):
            r = _raw(i, {"m": {1: 1}})
            com.commit(r)
            rec.on_commit(r)
        assert inj.clock_offset() == -3600.0
        assert rec.checkpoints_taken == 2
        agg.close()


# -- supervised live pipeline: restart + health transitions -----------------


class HealthClock:
    def __init__(self):
        self.now = 5000.0

    def monotonic(self):
        return self.now


def _drill(system_cls, res, resilience_kw):
    """commit.bridge raises on the second interval: the supervisor
    restarts the bridge, /healthz latches thread_restarted, commits keep
    flowing, and once the latch window passes (the watchdog's clock is
    moved, not waited for) the report is ok again."""
    inj = res.FaultInjector()
    inj.plan("commit.bridge", "raise", on_call=2)
    cfg = res.ResilienceConfig(restart_backoff_s=0.01,
                               restart_backoff_cap_s=0.05,
                               fault_injector=inj)
    ms = system_cls(interval=1.0, sys_stats=False, num_metrics=32,
                    retention=((4, 1),), commit="fused", resilience=cfg,
                    observability=True, **resilience_kw)
    if isinstance(ms.committer, JaxCommitter):
        _synchronised(ms.committer)
    q = queue.Queue()
    trace = []
    try:
        com = ms.committer
        for k in (1, 2, 3):
            ms.counter("reqs", 3)
            ms.histogram("lat", 0.25)
            ms._tick(q)
            if k == 2:
                _wait(lambda: ms.supervisor.total_restarts >= 1,
                      "the restart")
            else:
                _wait(lambda: com.intervals_committed >= (k if k < 2
                                                          else k - 1),
                      f"commit {k}")
        rep = ms.health.report()
        trace.append((ms.supervisor.total_restarts,
                      dict(ms.supervisor.restarts_by_name),
                      "thread_restarted" in rep.reason_codes(),
                      rep.status, com.intervals_committed))
        clock = ms.health._clock
        clock.now += ms.health._latch_window + 1.0
        ms.counter("reqs", 3)
        ms._tick(q)
        _wait(lambda: com.intervals_committed >= 3, "the next commit")
        rep = ms.health.report()
        dump = ms.debug_dump()["resilience"]
        trace.append((rep.status, rep.reason_codes(),
                      dump["thread_restarts"], dump["faults_injected"],
                      dump["breaker_state"]))
    finally:
        ms.stop()
    return trace


def test_supervised_bridge_restart_and_health_transitions(monkeypatch):
    from loghisto_tpu.system import TPUMetricSystem
    from loghisto_tpu_torch.system import TorchMetricSystem

    traces = []
    for health_mod, system_cls, res, kw in (
            (jax_health, TPUMetricSystem, jax_res, {}),
            (port_health, TorchMetricSystem, port_res, {"device": "cpu"})):
        clock = HealthClock()
        monkeypatch.setattr(health_mod, "time", clock)
        orig = health_mod.HealthWatchdog.__init__

        def init(self, *a, _orig=orig, _clock=clock, **k):
            _orig(self, *a, **k)
            self._clock = _clock

        monkeypatch.setattr(health_mod.HealthWatchdog, "__init__", init)
        traces.append(_drill(system_cls, res, kw))
    jax_trace, port_trace = traces
    restarts, by_name, latched, status, committed = port_trace[0]
    assert restarts == 1 and latched and status in ("degraded", "stalled")
    assert committed == 2  # the interval the crash dropped is not retried
    assert port_trace[1][:2] == ("ok", [])
    assert port_trace[1][2] == {"loghisto-torch-commit": 1}
    assert port_trace[1][3:] == (1, "closed")
    # the reference's ledger names its bridge loghisto-commit
    assert jax_trace[0][0] == 1 and jax_trace[0][2:] == port_trace[0][2:]
    assert jax_trace[1][:2] == port_trace[1][:2]
    assert jax_trace[1][3:] == port_trace[1][3:]


# -- the system: resilience=, recover(), the final checkpoint ---------------


def _resilient_system(pkg_system, res, tmp, name, recover_on_start, **kw):
    cfg = res.ResilienceConfig(
        checkpoint_path=str(tmp / f"{name}.npz"),
        journal_path=str(tmp / f"{name}.jsonl"),
        checkpoint_every_intervals=2, recover_on_start=recover_on_start)
    ms = pkg_system(interval=1.0, sys_stats=False, num_metrics=16,
                    config=(JCFG if res is jax_res else CFG),
                    retention=((4, 1),), commit="fused", resilience=cfg,
                    **kw)
    if res is jax_res:
        _synchronised(ms.committer)
    return ms


def test_system_checkpoints_journals_and_recovers_like_the_reference(
        tmp_path):
    """Both packages' systems with resilience=: five intervals through the
    reaper's tick (the journal appends each, the committer checkpoints
    every two), stop() takes the final checkpoint, and a second system
    recovers on start() with nothing to replay.  Ledgers, debug dumps and
    gauge names EQUAL; collect() EQUAL to the first system's and close to
    the JAX package's."""
    from loghisto_tpu.system import TPUMetricSystem
    from loghisto_tpu_torch.system import TorchMetricSystem

    rng = np.random.default_rng(41)
    values = [rng.lognormal(-1.5, 0.6, 50) for _ in range(5)]
    out = {}
    for name, system, res, kw in (
            ("jax", TPUMetricSystem, jax_res, {}),
            ("port", TorchMetricSystem, port_res, {"device": "cpu"})):
        ms = _resilient_system(system, res, tmp_path, name, False, **kw)
        ms.recovery.start()  # the journal, as start() would
        q = queue.Queue()
        for k, v in enumerate(values, 1):
            ms.histogram_batch("lat", v)
            ms.counter("reqs", k)
            ms._tick(q)
            _wait(lambda: ms.committer.intervals_committed >= k, "a commit")
        _wait(lambda: ms.recovery.checkpoints_taken >= 2, "the cadence")
        live = (ms.recovery.checkpoints_taken,
                ms.recovery.last_checkpoint_seq)
        gauges = sorted(k for k in ms._gauge_funcs
                        if k.startswith(("resilience.", "journal.")))
        snap = _snap(ms.aggregator)
        ms.stop()
        dump = ms.debug_dump()["resilience"]
        ms2 = _resilient_system(system, res, tmp_path, name, True, **kw)
        ms2.start()
        ms2.stop()
        rec = ms2.recovery
        out[name] = (live, dump, gauges,
                     (rec.recoveries, rec.replayed_intervals, rec.last_seq),
                     snap, _snap(ms2.aggregator), next(ms2._interval_seq))
    live, dump, gauges, recovered, snap, snap2, seq = out["port"]
    assert live == (2, 4)
    assert dump["checkpoints_taken"] == 3 and dump["last_checkpoint_seq"] == 5
    assert recovered == (1, 0, 5) and seq >= 6
    assert snap2 == snap
    assert out["jax"][:4] == out["port"][:4]
    _assert_close_to_jax(snap, out["jax"][4])
