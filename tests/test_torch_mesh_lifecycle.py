"""Lifecycle and drift on the port's mesh (ROADMAP Queue 1 item 11b-2,
decision D10): ``IntervalCommitter`` with a ``LifecycleManager`` and an
``AnomalyManager`` over ``TorchAggregator(mesh=)`` and
``TimeWheel(mesh=)``, and ``TorchMetricSystem(mesh=, lifecycle=,
anomaly=)``, against the JAX package's sharded committer (the
counterpart of ``tests/test_mesh_commit.py``'s eviction, drift and
system tests) at M = 16-32, ``bucket_limit`` 256, ``chunk=8``.

Meshes (2, 1), (1, 2) and (2, 2) launch their ranks once each
(``test_torch_ranks.launch``: gloo, a ``FileStore`` in ``tmp_path``, the
``mesh_lifecycle:SxM`` job; every collective on a rank's main thread, or
the launch fails).  Rank (s, m) commits the intervals of stream row s
(every name of an interval in each, in the same order, so the registries
agree); the JAX side commits their merged intervals on
``make_mesh(stream=s, metric=m)`` over the conftest's 8 virtual CPU
devices.  The scenarios: churn under a TTL of 2 with compactions (six
fresh names an interval, so victims and their overflow target sit in
different blocks), the same on the fan-out path (the exact host spill),
the same with rank 0's first commit step failing, drift scoring across a
shape change, growth past the wheel's rows with lifecycle and drift on,
and the system.

Tolerances:
  * the activity blocks, the registry, ``evicted_series``,
    ``overflowed_samples``, the ring blocks, the interval histogram
    blocks and the accumulator (the stream rows' partials, with their
    spill, summed per metric column): EQUAL;
  * the banks: rtol 1e-6, atol 1e-7 (the single-device drift parity
    tests' float32 tolerance);
  * the scores: rel 1e-6, abs 1e-7 against the port's single-device
    committer fed the merged intervals (the reference's sharded test
    holds its mesh to its single device so); against JAX, the port's
    single-device score tolerance (``test_torch_anomaly._tol``: the emd
    sums B float32 terms in another order than XLA, 1.9e-6 relative
    apart after the growth scenario);
  * served sums and percentiles: ``test_torch_mesh_commit._assert_served``.
"""

import jax
import numpy as np
import pytest

from loghisto_tpu.anomaly import AnomalyConfig as JaxAnomalyConfig
from loghisto_tpu.anomaly import AnomalyManager as JaxAnomalyManager
from loghisto_tpu.commit import IntervalCommitter as JaxCommitter
from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.lifecycle import LifecycleConfig as JaxLifecycleConfig
from loghisto_tpu.lifecycle import LifecycleManager as JaxLifecycleManager
from loghisto_tpu.metrics import RawMetricSet as JaxRawMetricSet
from loghisto_tpu.parallel.aggregator import TPUAggregator
from loghisto_tpu.parallel.mesh import make_mesh as jax_make_mesh
from loghisto_tpu.system import TPUMetricSystem
from loghisto_tpu.window import TimeWheel as JaxWheel

from loghisto_tpu_torch.anomaly import AnomalyConfig
from loghisto_tpu_torch.commit import IntervalCommitter
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.lifecycle import LifecycleConfig, LifecycleManager
from loghisto_tpu_torch.anomaly import AnomalyManager
from loghisto_tpu_torch.metrics import RawMetricSet
from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
from loghisto_tpu_torch.window.store import TimeWheel

import test_torch_ranks as R
from test_torch_aggregator import _assert_same
from test_torch_anomaly import _tol
from test_torch_mesh_commit import _assert_served, _flat_window

SHAPES = ((2, 1), (1, 2), (2, 2))
SHAPE_IDS = [f"{s}x{m}" for s, m in SHAPES]
UNIMODAL = {90: 100, 100: 200, 110: 100}
BIMODAL = {50: 120, 90: 40, 100: 160, 110: 40, 150: 120}


def _churn_cells(rng):
    """One stream row's cells of a churn interval: each name (fresh ones
    and the steady one, the last) in this row with probability 0.7."""
    cells = []
    for k in range(R.ML_FRESH + 1):
        if rng.random() < 0.7:
            for _ in range(int(rng.integers(1, 4))):
                cells.append((k, int(rng.integers(-4, 300)),
                              int(rng.integers(1, 50))))
    return np.array(cells, np.int64).reshape(-1, 3)


def _drift_cells(i, s):
    """Stream row s's share of drift interval i: every name's shape,
    unimodal until ML_SHIFT_AT, then bimodal for the even names, each
    count split over the two stream rows."""
    cells = []
    for k in range(R.ML_DRIFT_NAMES):
        shape = BIMODAL if i >= R.ML_SHIFT_AT and k % 2 == 0 else UNIMODAL
        for b, c in shape.items():
            c *= 1 + k % 3
            cells.append((k, b, c - c // 2 if s == 0 else c // 2))
    return np.array(cells, np.int64)


def _make_inputs():
    rng = np.random.default_rng(22)
    d = {}
    for i in range(R.ML_INTERVALS):
        for s in range(R.MC_STREAM_ROWS):
            d[f"ml.{i}.{s}"] = _churn_cells(rng)
    for i in range(R.ML_DRIFT_INTERVALS):
        for s in range(R.MC_STREAM_ROWS):
            d[f"mld.{i}.{s}"] = _drift_cells(i, s)
    for i in range(R.ML_GROW_INTERVALS):
        seen = len(R.mc_grow_names(i))
        for s in range(R.MC_STREAM_ROWS):
            n = int(rng.integers(4, 16))
            cells = np.empty((n, 3), np.int64)
            cells[:, 0] = rng.integers(0, seen, n)
            cells[:, 1] = rng.integers(0, 100, n)
            cells[:, 2] = rng.integers(1, 50, n)
            d[f"mlg.{i}.{s}"] = cells
    return d


@pytest.fixture(scope="module")
def inputs():
    return _make_inputs()


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Per mesh shape, every rank's results, by coordinate."""
    cache = {}

    def get(shape):
        if shape not in cache:
            s, m = shape
            results = R.launch(tmp_path_factory.mktemp(f"ml{s}x{m}"), s * m,
                               f"mesh_lifecycle:{s}x{m}", inputs)
            cache[shape] = {tuple(r["coord"].tolist()): r for r in results}
        return cache[shape]

    return get


def _raws(inputs, shape, key, names, n):
    """The merged intervals the JAX side commits."""
    return [R.mc_raw(JaxRawMetricSet,
                     [(s, inputs[f"{key}.{i}.{s}"]) for s in range(shape[0])],
                     names(i), i)
            for i in range(n)]


def _synchronised(com):
    """Wait for each JAX commit step (ROADMAP F3)."""
    for attr in ("_fused", "_fused_snap"):
        step = getattr(com, attr)
        setattr(com, attr,
                lambda *a, _step=step: jax.block_until_ready(_step(*a)))
    return com


def _jax_pipeline(shape, m0, tiers, max_metrics=None, lifecycle=None,
                  anomaly=None, **agg_kw):
    cfg = JaxConfig(bucket_limit=R.ML_BL)
    mesh = jax_make_mesh(stream=shape[0], metric=shape[1])
    agg = TPUAggregator(num_metrics=m0, config=cfg, mesh=mesh,
                        storage="dense", max_metrics=max_metrics or m0,
                        **agg_kw)
    wheel = JaxWheel(num_metrics=m0, config=cfg, interval=1.0, tiers=tiers,
                     registry=agg.registry, mesh=mesh)
    lc = JaxLifecycleManager(agg, wheel, lifecycle) if lifecycle else None
    an = JaxAnomalyManager(agg, wheel, anomaly) if anomaly else None
    if lc is not None and an is not None:
        lc.anomaly = an
    com = _synchronised(JaxCommitter(agg, wheel, chunk=R.ML_CHUNK,
                                     lifecycle=lc, anomaly=an))
    return com, agg, wheel, lc, an


def _port_scores(inputs, shape, key, names, n, m0, max_metrics=None,
                 lifecycle=None):
    """The scores of the port's single-device committer fed the merged
    intervals (on the CPU)."""
    cfg = MetricConfig(bucket_limit=R.ML_BL)
    agg = TorchAggregator(num_metrics=m0, config=cfg, device="cpu",
                          max_metrics=max_metrics or m0)
    wheel = TimeWheel(num_metrics=m0, config=cfg, interval=1.0,
                      tiers=R.ML_DRIFT_TIERS, registry=agg.registry,
                      device="cpu")
    lc = LifecycleManager(agg, wheel, lifecycle) if lifecycle else None
    an = AnomalyManager(agg, wheel, R.ml_anomaly_config(AnomalyConfig))
    if lc is not None:
        lc.anomaly = an
    com = IntervalCommitter(agg, wheel, chunk=R.ML_CHUNK, lifecycle=lc,
                            anomaly=an)
    try:
        for i in range(n):
            com.commit(R.mc_raw(RawMetricSet, [
                (s, inputs[f"{key}.{i}.{s}"]) for s in range(shape[0])],
                names(i), i))
        return {k: v.copy() for k, v in an._scores.items()}
    finally:
        agg.close()


def _check_scores(res, key, single):
    for coord, r in res.items():
        for k, v in single.items():
            np.testing.assert_allclose(r[f"{key}.scores.{k}"], v, rtol=1e-6,
                                       atol=1e-7, err_msg=f"{coord} {k}")


def _block(arr, m, n_metric, axis=0):
    rows = arr.shape[axis] // n_metric
    return np.take(arr, np.arange(m * rows, (m + 1) * rows), axis=axis)


def _jax_acc(agg):
    acc = np.asarray(agg._acc).astype(np.int64)
    return acc if agg._spill is None else acc + agg._spill


def _check(res, key, shape, agg, wheel, lc=None, an=None):
    """Every rank's blocks against the JAX carries: EQUAL, banks and
    scores within their tolerances."""
    s_n, m_n = shape
    names = ["" if n is None else n for n in agg.registry.names()]
    for (s, m), r in res.items():
        what = f"rank {(s, m)} {key}"
        assert r[f"{key}.names"].tolist() == names, what
        assert int(r[f"{key}.m"]) == agg.num_metrics, what
        for t, tier in enumerate(wheel._tiers):
            np.testing.assert_array_equal(
                r[f"{key}.ring{t}"],
                _block(np.asarray(tier.ring), m, m_n, axis=1),
                err_msg=f"{what} tier {t}")
            np.testing.assert_array_equal(r[f"{key}.state{t}"], [
                tier.slot, tier.in_slot, *tier.written.astype(int)])
        if lc is not None:
            np.testing.assert_array_equal(
                r[f"{key}.la"], _block(np.asarray(lc._la), m, m_n),
                err_msg=what)
            assert r[f"{key}.counters"].tolist() == [
                lc.evicted_series, lc.overflowed_samples, lc.evictions,
                lc.compactions], what
        if an is not None and an._ihist is None:  # a restored manager
            assert f"{key}.ihist" not in r, what
        elif an is not None:
            np.testing.assert_array_equal(
                r[f"{key}.ihist"], _block(np.asarray(an._ihist), m, m_n),
                err_msg=what)
            for carry, axis in (("prof", 1), ("wsum", 1)):
                np.testing.assert_allclose(
                    r[f"{key}.{carry}"],
                    _block(np.asarray(getattr(an, f"_{carry}")), m, m_n,
                           axis=axis), rtol=1e-6, atol=1e-7, err_msg=what)
            assert r[f"{key}.scored"].tolist() == [
                an.scored_intervals, an.skipped_intervals], what
            if an._scores is not None:
                tol = _tol(2 * R.ML_BL + 1)
                for k, v in an._scores.items():
                    np.testing.assert_allclose(
                        r[f"{key}.scores.{k}"], np.asarray(v), **tol[k],
                        err_msg=f"{what} {k}")
    want = _jax_acc(agg)
    for m in range(m_n):
        summed = sum(res[(s, m)][f"{key}.acc"] for s in range(s_n))
        np.testing.assert_array_equal(summed, _block(want, m, m_n))


def _crossings(lc_jax, n_metric, rows):
    """Wrap the JAX manager's fold to record each eviction's (victim,
    target) pairs whose blocks differ."""
    pairs = []
    real = lc_jax._fold

    def fold(*a):
        victims, targets = np.asarray(a[-3]), np.asarray(a[-2])
        for v, t in zip(victims.tolist(), targets.tolist()):
            if v < n_metric * rows and t < n_metric * rows \
                    and v // rows != t // rows:
                pairs.append((v, t))
        return real(*a)

    lc_jax._fold = fold
    return pairs


def _run_churn(inputs, shape, compact=True, **agg_kw):
    com, agg, wheel, lc, _ = _jax_pipeline(
        shape, R.ML_M, R.ML_TIERS,
        lifecycle=R.ml_lifecycle_config(JaxLifecycleConfig), **agg_kw)
    crossed = _crossings(lc, shape[1], R.ML_M // shape[1])
    modes = []
    for i, raw in enumerate(_raws(inputs, shape, "ml", R.ml_names,
                                  R.ML_INTERVALS)):
        modes.append(com.commit(raw))
        if i == R.ML_COMPACT_AT and compact:
            lc.compact()
    return com, agg, wheel, lc, modes, crossed


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_eviction_and_compaction_across_metric_ranks(shape, ranks, inputs):
    """TTL eviction and explicit compaction on the fused path: every
    rank's activity block, ring blocks and stream-summed accumulator
    equal the JAX sharded committer's, before and after the last
    compaction; on a two-way metric axis victims fold into an overflow
    row another rank holds, and their rows cross."""
    res = ranks(shape)
    com, agg, wheel, lc, modes, crossed = _run_churn(inputs, shape)
    try:
        assert lc.evicted_series > 0 and lc.compactions == 1
        _check(res, "churn.pre", shape, agg, wheel, lc)
        assert lc.compact()
        _check(res, "churn.post", shape, agg, wheel, lc)
        _check_collect = agg.collect(reset=False).metrics
    finally:
        agg.close()
    for r in res.values():
        assert r["churn.modes"].tolist() == modes
        assert bool(r["churn.compacted"])
        _assert_same(R.get_metrics(r, "churn.collect"), _check_collect)
    if shape[1] == 2:
        assert crossed, "no victim's overflow row lay on another rank"
        assert any(int(r["churn.evict_bytes"].sum()) for r in res.values())
        assert any(int(r["churn.compact_bytes"].sum()) for r in res.values())
    else:  # one block: nothing crosses
        assert not crossed
        for r in res.values():
            assert not r["churn.evict_bytes"].any()
            assert not r["churn.compact_bytes"].any()


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_the_fanout_path_stamps_the_whole_interval(shape, ranks, inputs):
    """Every interval past the spill point takes the fan-out: the
    activity stamp takes the gathered interval's ids, the evictions fold
    the host spill blocks across the metric line too."""
    res = ranks(shape)
    com, agg, wheel, lc, modes, _ = _run_churn(inputs, shape,
                                               spill_threshold=1)
    try:
        assert set(modes) == {"fanout"} and lc.evicted_series > 0
        _check(res, "fanout.pre", shape, agg, wheel, lc)
        lc.compact()
        _check(res, "fanout.post", shape, agg, wheel, lc)
        want = agg.collect(reset=False).metrics
    finally:
        agg.close()
    for r in res.values():
        assert r["fanout.modes"].tolist() == modes
        _assert_same(R.get_metrics(r, "fanout.collect"), want)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_a_failed_step_on_one_rank_keeps_the_carries_in_step(shape, ranks,
                                                             inputs):
    """Rank 0's first commit step fails: it stamps every chunk it
    gathered, so every rank's activity block still equals the reference
    (whose step never failed), every rank evicts the same names, and the
    collected sets (the failed chunks in rank 0's exact spill) agree."""
    res = ranks(shape)
    com, agg, wheel, lc, _, _ = _run_churn(inputs, shape, compact=False)
    try:
        want = agg.collect(reset=False).metrics
        la = np.asarray(lc._la)
        names = ["" if n is None else n for n in agg.registry.names()]
    finally:
        agg.close()
    for (s, m), r in res.items():
        np.testing.assert_array_equal(r["failure.pre.la"],
                                      _block(la, m, shape[1]))
        assert r["failure.pre.names"].tolist() == names
        assert r["failure.pre.counters"][0] == lc.evicted_series
        _assert_same(R.get_metrics(r, "failure.collect"), want)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_drift_scoring_after_a_shape_change(shape, ranks, inputs):
    res = ranks(shape)
    com, agg, wheel, _, an = _jax_pipeline(
        shape, R.ML_DRIFT_M, R.ML_DRIFT_TIERS,
        anomaly=R.ml_anomaly_config(JaxAnomalyConfig))
    try:
        for raw in _raws(inputs, shape, "mld", R.ml_drift_names,
                         R.ML_DRIFT_INTERVALS):
            com.commit(raw)
        assert an.scored_intervals > 0
        _check(res, "drift", shape, agg, wheel, an=an)
        want = [an.scores_for(n) for n in R.ml_drift_names()]
    finally:
        agg.close()
    assert want[0]["ks"] > 0.0  # the drift registered
    _check_scores(res, "drift", _port_scores(
        inputs, shape, "mld", R.ml_drift_names, R.ML_DRIFT_INTERVALS,
        R.ML_DRIFT_M))
    tol = _tol(2 * R.ML_BL + 1)
    for r in res.values():
        for w, got in zip(want, r["drift.served"].tolist()):
            for k, g in zip(("ks", "jsd", "emd"), got):
                assert g == pytest.approx(w[k], rel=tol[k]["rtol"],
                                          abs=tol[k]["atol"]), k


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_growth_past_the_wheel_rows_with_drift_on(shape, ranks, inputs):
    """The registry grows past the wheel's rows: the activity block and
    the banks grow with the accumulator's blocks (new rows stamped when
    the reference pads its carry), and each view block scores against
    the bank rows of its own global rows."""
    res = ranks(shape)
    com, agg, wheel, lc, an = _jax_pipeline(
        shape, R.ML_GROW_M0, R.ML_DRIFT_TIERS, max_metrics=R.ML_GROW_MAX,
        lifecycle=R.ml_lifecycle_config(JaxLifecycleConfig, ttl=3),
        anomaly=R.ml_anomaly_config(JaxAnomalyConfig))
    try:
        for raw in _raws(inputs, shape, "mlg", R.mc_grow_names,
                         R.ML_GROW_INTERVALS):
            com.commit(raw)
        assert agg.num_metrics > wheel.num_metrics  # it grew
        _check(res, "grow", shape, agg, wheel, lc, an)
    finally:
        agg.close()
    _check_scores(res, "grow", _port_scores(
        inputs, shape, "mlg", R.mc_grow_names, R.ML_GROW_INTERVALS,
        R.ML_GROW_M0, R.ML_GROW_MAX,
        R.ml_lifecycle_config(LifecycleConfig, ttl=3)))
    for r in res.values():
        assert int(r["grow.wheel_m"]) == R.ML_GROW_M0


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_system_with_lifecycle_and_drift_on_a_mesh(shape, ranks, inputs):
    """TorchMetricSystem(mesh=, retention=, lifecycle=, anomaly=) resolves
    "auto" to the fused commit, as TPUMetricSystem does; after the same
    intervals and a compaction every rank's carries, its served query,
    and the lifecycle and drift gauges equal the reference's."""
    res = ranks(shape)
    ms = TPUMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=R.ML_M,
        config=JaxConfig(bucket_limit=R.ML_BL), retention=R.ML_TIERS,
        mesh=jax_make_mesh(stream=shape[0], metric=shape[1]),
        lifecycle=R.ml_lifecycle_config(JaxLifecycleConfig),
        anomaly=JaxAnomalyConfig(decay=0.8, min_samples=4))
    _synchronised(ms.committer)
    try:
        assert ms.commit_path == "fused"
        ms.backfill_retention(_raws(inputs, shape, "ml", R.ml_names,
                                    R.ML_INTERVALS))
        assert ms.lifecycle.compact()
        _check(res, "system", shape, ms.aggregator, ms.retention,
               ms.lifecycle, ms.anomaly)
        served, meta = _flat_window(ms.query("*", None, R.MC_PS))
        gauges = {k: v for k, v in ms.collect_raw_metrics().gauges.items()
                  if k.startswith(("lifecycle.", "anomaly."))
                  and "Compaction" not in k}
        dump_keys = sorted(ms.debug_dump())
    finally:
        ms.stop()
    assert gauges["lifecycle.EvictedSeries"] > 0
    for r in res.values():
        assert r["system.path"].tolist() == ["fused", "None"]
        assert bool(r["system.wired"])
        assert int(r["system.backfilled"]) == R.ML_INTERVALS
        assert bool(r["system.compacted"])
        _assert_served(R.get_metrics(r, "system.q"), served, "system")
        np.testing.assert_array_equal(r["system.q.meta"], meta)
        assert R.get_metrics(r, "system.gauges") == gauges
        # the single-device dump's keys, and the mesh's own
        assert r["system.dump_keys"].tolist() == sorted(
            dump_keys + ["queued_intervals"])


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_checkpoints_and_recovery_on_a_mesh_cite_11b_3(shape, ranks):
    """What ROADMAP Queue 1 item 11b-3 lifted (decision D11): the
    aggregator's and the wheel's state round-trip on a mesh, and a system
    with a checkpoint or a journal path constructs, journals each stream
    row at metric index 0 and takes its final checkpoint at stop()
    (``tests/test_torch_mesh_recovery.py`` holds them against JAX)."""
    for (s, m), r in ranks(shape).items():
        for key in ("agg_state", "agg_load", "wheel_state", "wheel_load",
                    "sys_checkpoint", "sys_journal"):
            assert str(r[f"refuse.{key}"]) == "", key
        assert bool(r["state.same"])
        assert int(r["sys_checkpoint.taken"]) == 1
        want = [f"j.log.row{s}of{shape[0]}"] if m == 0 else []
        assert r["sys_journal.path"].tolist() == want
