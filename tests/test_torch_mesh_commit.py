"""The port's fused interval commit on a mesh (ROADMAP Queue 1 item
11b-1, decision D9): ``IntervalCommitter`` over ``TorchAggregator(mesh=)``
and ``TimeWheel(mesh=)``, and ``TorchMetricSystem(mesh=)``, against the
JAX package's sharded committer (the counterpart of
``tests/test_mesh_commit.py``), at M = 16, ``bucket_limit`` 256, tiers
(3, 1) and (2, 3), and ``chunk=8`` so an interval takes several steps
and pads the last.

Meshes (2, 1), (1, 2) and (2, 2) launch their ranks once each
(``test_torch_ranks.launch``: gloo, a ``FileStore`` in ``tmp_path``, the
``mesh_commit:SxM`` job; every collective on a rank's main thread, or
the launch fails).  Rank (s, m) commits the intervals of stream row s
(every name in each, in the same order, so the registries agree); the
JAX side commits their merged intervals on ``make_mesh(stream=s,
metric=m)`` over the conftest's 8 virtual CPU devices.  Intervals 2 (no
cells anywhere) and 4 (cells in stream row 0 only) test the empty
interval and a rank without cells of its own.

Tolerances:
  * rings, slot / in_slot / written, durations, counts, covered
    seconds, the accumulator (the stream rows' partials summed per
    metric column, after ``collect(reset=False)``): EQUAL;
  * served sums and averages: rtol 1e-5, atol 1e-6 (float32 sums in
    another order, as the single-device committer's parity tests);
  * served percentiles and edges: rtol 4e-6 (XLA's float32 ``exp``,
    ROADMAP F1);
  * the collected sets: ``test_torch_aggregator._assert_same``.
"""

import jax
import numpy as np
import pytest

from loghisto_tpu.commit import IntervalCommitter as JaxCommitter
from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.labels import LabelIndex as JaxLabelIndex
from loghisto_tpu.metrics import RawMetricSet as JaxRawMetricSet
from loghisto_tpu.obs import ObsConfig as JaxObsConfig
from loghisto_tpu.ops import dispatch as jax_dispatch
from loghisto_tpu.parallel.aggregator import TPUAggregator
from loghisto_tpu.parallel.mesh import make_mesh as jax_make_mesh
from loghisto_tpu.system import TPUMetricSystem
from loghisto_tpu.window import TimeWheel as JaxWheel

import test_torch_ranks as R
from test_torch_aggregator import _assert_same

SHAPE_IDS = [f"{s}x{m}" for s, m in R.MC_SHAPES]
EMPTY_INTERVAL = 2
ONE_ROW_INTERVAL = 4


def _cells(rng, n, names, lo, hi, counts):
    cells = np.empty((n, 3), np.int64)
    cells[:, 0] = rng.integers(0, names, n)
    cells[:, 1] = rng.integers(lo, hi, n)
    cells[:, 2] = rng.integers(1, counts, n)
    return cells


def _make_inputs():
    rng = np.random.default_rng(21)
    names = len(R.mc_names())
    d = {}
    for i in range(R.MC_INTERVALS):
        for s in range(R.MC_STREAM_ROWS):
            empty = i == EMPTY_INTERVAL or (i == ONE_ROW_INTERVAL and s)
            # buckets mostly positive (float32 sums stay well
            # conditioned), some past the dense range (they clip)
            d[f"mc.{i}.{s}"] = (np.empty((0, 3), np.int64) if empty else
                                _cells(rng, int(rng.integers(12, 40)),
                                       names, -4, 300, 200))
    for i in range(R.MC_GROW_INTERVALS):
        seen = len(R.mc_grow_names(i))
        for s in range(R.MC_STREAM_ROWS):
            d[f"mcg.{i}.{s}"] = _cells(rng, int(rng.integers(4, 16)), seen,
                                       0, 100, 50)
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
            results = R.launch(tmp_path_factory.mktemp(f"mc{s}x{m}"), s * m,
                               f"mesh_commit:{s}x{m}", inputs)
            cache[shape] = {tuple(r["coord"].tolist()): r for r in results}
        return cache[shape]

    return get


def _raws(inputs, shape, key="mc", names=None, n=R.MC_INTERVALS):
    """The merged intervals the JAX side commits."""
    return [R.mc_raw(JaxRawMetricSet,
                     [(s, inputs[f"{key}.{i}.{s}"]) for s in range(shape[0])],
                     names(i) if names else R.mc_names(), i)
            for i in range(n)]


def _synchronised(com):
    """Wait for each JAX commit step (ROADMAP F3: the JAX staging ring
    rewrites a host slot the CPU's ``device_put`` may still read)."""
    for attr in ("_fused", "_fused_snap"):
        step = getattr(com, attr)
        setattr(com, attr,
                lambda *a, _step=step: jax.block_until_ready(_step(*a)))
    return com


def _block(arr, m, n_metric, axis=0):
    rows = arr.shape[axis] // n_metric
    return np.take(arr, np.arange(m * rows, (m + 1) * rows), axis=axis)


def _flat_window(ws):
    """A JAX WindowStats / GroupStats as the ranks flatten theirs."""
    out = {}
    R._put_window(out, "w", ws)
    return R.get_metrics(out, "w"), out["w.meta"]


def _assert_served(got, want, what):
    assert set(got) == set(want), what
    for key, w in want.items():
        g = got[key]
        if key.endswith(".count"):
            assert g == w, (what, key)
        elif key.endswith((".sum", ".avg")):
            assert g == pytest.approx(w, rel=1e-5, abs=1e-6), (what, key)
        else:  # a percentile or an equi-depth edge
            assert g == pytest.approx(w, rel=4e-6, abs=0), (what, key)


def _serve_jax(query, group_by, rate):
    out = {}
    for q, (pattern, window) in enumerate(R.MC_QUERIES):
        out[f"q{q}"] = _flat_window(query(pattern, window, R.MC_PS))
    out["group"] = _flat_window(group_by(
        "api.lat{}", ["route"], window=None, percentiles=R.MC_PS, depth=4))
    out["rate"] = rate("req", 3.0)
    return out


def _check_served(res, key, want):
    for coord, r in res.items():
        for name, (w, wmeta) in ((k, v) for k, v in want.items()
                                 if k != "rate"):
            _assert_served(R.get_metrics(r, f"{key}.{name}"), w,
                           (coord, key, name))
            np.testing.assert_array_equal(r[f"{key}.{name}.meta"], wmeta)
        assert float(r[f"{key}.rate"]) == pytest.approx(want["rate"],
                                                        rel=1e-12)


def _check_wheel(res, key, wheel, n_metric):
    for (s, m), r in res.items():
        for t, tier in enumerate(wheel._tiers):
            np.testing.assert_array_equal(
                r[f"{key}.ring{t}"], _block(np.asarray(tier.ring), m,
                                            n_metric, axis=1),
                err_msg=f"rank {(s, m)} {key} tier {t}")
            np.testing.assert_array_equal(r[f"{key}.state{t}"], [
                tier.slot, tier.in_slot, *tier.written.astype(int)])
            np.testing.assert_array_equal(r[f"{key}.durations{t}"],
                                          tier.durations)


def _check_acc(res, key, jax_acc, shape):
    s_n, m_n = shape
    for m in range(m_n):
        summed = sum(res[(s, m)][f"{key}.acc"].astype(np.int64)
                     for s in range(s_n))
        np.testing.assert_array_equal(summed, _block(jax_acc, m, m_n))


def _check_collect(res, key, want):
    for r in res.values():
        _assert_same(R.get_metrics(r, f"{key}.collect"), want)


def _jax_pair(shape, num_metrics, **agg_kw):
    cfg = JaxConfig(bucket_limit=R.MC_BL)
    mesh = jax_make_mesh(stream=shape[0], metric=shape[1])
    agg = TPUAggregator(num_metrics=num_metrics, config=cfg, mesh=mesh,
                        storage="dense", **agg_kw)
    wheel = JaxWheel(num_metrics=num_metrics, config=cfg, interval=1.0,
                     tiers=R.MC_TIERS, registry=agg.registry, mesh=mesh)
    return agg, wheel


@pytest.mark.parametrize("shape", R.MC_SHAPES, ids=SHAPE_IDS)
def test_ranks_equal_the_jax_sharded_committer(shape, ranks, inputs):
    res = ranks(shape)
    agg, wheel = _jax_pair(shape, R.MC_M, max_metrics=R.MC_M)
    wheel.label_index = JaxLabelIndex(wheel.registry)
    com = _synchronised(JaxCommitter(agg, wheel, chunk=R.MC_CHUNK))
    try:
        modes = [com.commit(raw) for raw in _raws(inputs, shape)]
        assert modes[EMPTY_INTERVAL] == "empty"
        assert modes.count("fused") == R.MC_INTERVALS - 1
        _check_wheel(res, "fused", wheel, shape[1])
        want = _serve_jax(wheel.query, wheel.query_group_by,
                          wheel.window_rate)
        _check_served(res, "fused", want)
        _check_acc(res, "fused", np.asarray(agg._acc), shape)
        _check_collect(res, "fused", agg.collect(reset=False).metrics)
        for r in res.values():
            assert r["fused.modes"].tolist() == modes
            # no accumulator snapshot on a mesh: the block is a partial
            assert bool(r["fused.snapshot_none"])
            assert int(r["fused.hbm"]) == wheel.hbm_bytes() // shape[1]
    finally:
        agg.close()


@pytest.mark.parametrize("shape", R.MC_SHAPES, ids=SHAPE_IDS)
def test_a_failed_step_on_one_rank_keeps_the_mesh_in_step(shape, ranks,
                                                           inputs):
    """Rank 0's first step fails (an injected ``commit.dispatch``): the
    launch ends (no rank waits on a gather it never gets), rank 0 spills
    the cells it did not apply, so every rank's collected set still
    equals the reference's, and its peers' rings miss nothing of its
    later shares; the query right after the failure (rank 0 without a
    snapshot) gives every rank of a metric line the same result."""
    res = ranks(shape)
    agg, wheel = _jax_pair(shape, R.MC_M, max_metrics=R.MC_M)
    com = _synchronised(JaxCommitter(agg, wheel, chunk=R.MC_CHUNK))
    try:
        totals0 = []
        for i, raw in enumerate(_raws(inputs, shape)):
            com.commit(raw)
            if i == 0:
                totals0 = [sum(int(_block(np.asarray(t.ring), m, shape[1],
                                          axis=1).sum())
                               for t in wheel._tiers)
                           for m in range(shape[1])]
        want = agg.collect(reset=False).metrics
    finally:
        agg.close()
    for (s, m), r in res.items():
        _assert_same(R.get_metrics(r, "failure.collect"), want)
        assert bool(r["failure.spilled"]) == ((s, m) == (0, 0))
        assert bool(r["failure.snapshot"]) == ((s, m) != (0, 0))
        if (s, m) == (0, 0):  # its failed chunks are not in its rings
            assert int(r["failure.total0"]) < totals0[m]
        else:
            assert int(r["failure.total0"]) == totals0[m]
        # one metric line, one result (rank 0's rows lost its chunks)
        line = R.get_metrics(res[(s, 0)], "failure.q")
        assert R.get_metrics(r, "failure.q") == line
        assert line or s == 0
    # the rings wrapped past interval 0: every rank equals the reference
    _check_wheel(res, "failure", wheel, shape[1])


@pytest.mark.parametrize("shape", R.MC_SHAPES, ids=SHAPE_IDS)
def test_steps_pad_each_stream_row_to_its_share_of_the_chunk(shape, ranks,
                                                              inputs):
    """Every rank of an interval takes the same number of steps, the most
    any stream row needs at chunk / n_stream cells a rank."""
    s_n = shape[0]
    width = R.MC_CHUNK // s_n
    for i in range(R.MC_INTERVALS):
        need = max(-(-len(_rank_cells(inputs, i, s)) // width)
                   for s in range(s_n))
        for r in ranks(shape).values():
            assert int(r["fused.steps"][i]) == need, i


def _rank_cells(inputs, i, s):
    """The distinct (name, bucket) cells of stream row s in interval i."""
    return {(k, b) for k, b, _ in inputs[f"mc.{i}.{s}"].tolist()}


@pytest.mark.parametrize("shape", R.MC_SHAPES, ids=SHAPE_IDS)
def test_growth_past_the_wheel_rows(shape, ranks, inputs):
    """The registry grows past the wheel's rows: the accumulator's cells
    of the new rows wait for collect()'s re-layout, the rings drop
    them, as the reference's drop-off does."""
    res = ranks(shape)
    agg, wheel = _jax_pair(shape, R.MC_GROW_M0, max_metrics=R.MC_GROW_MAX)
    com = _synchronised(JaxCommitter(agg, wheel, chunk=R.MC_CHUNK))
    try:
        for raw in _raws(inputs, shape, "mcg", R.mc_grow_names,
                         R.MC_GROW_INTERVALS):
            com.commit(raw)
        assert agg.num_metrics > wheel.num_metrics  # it grew
        _check_wheel(res, "grow", wheel, shape[1])
        _check_collect(res, "grow", agg.collect(reset=False).metrics)
        _check_acc(res, "grow", np.asarray(agg._acc), shape)
        for r in res.values():
            assert int(r["grow.m"]) == agg.num_metrics
            assert int(r["grow.capacity"]) == agg.registry.capacity
    finally:
        agg.close()


def _jax_system(shape, **kw):
    return TPUMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=R.MC_M,
        config=JaxConfig(bucket_limit=R.MC_BL), retention=R.MC_TIERS,
        mesh=jax_make_mesh(stream=shape[0], metric=shape[1]), **kw)


@pytest.mark.parametrize("shape", R.MC_SHAPES, ids=SHAPE_IDS)
def test_system_on_a_mesh_equals_the_jax_system(shape, ranks, inputs):
    """TorchMetricSystem(mesh=, commit="auto"): the bridge's intervals
    queue and the first query commits them (D9), the rest replay through
    backfill_retention; the wheel, the serves and device_metrics equal
    TPUMetricSystem(mesh=, commit="fused") fed the merged intervals."""
    res = ranks(shape)
    ms = _jax_system(shape, commit="fused")
    _synchronised(ms.committer)
    try:
        ms.backfill_retention(_raws(inputs, shape))
        want_dump = ms.debug_dump()
        _check_wheel(res, "system", ms.retention, shape[1])
        _check_served(res, "system", _serve_jax(
            ms.query, ms.query_group_by, ms.window_rate))
        _check_collect(res, "system", ms.device_metrics(reset=False).metrics)
        _check_acc(res, "system", np.asarray(ms.aggregator._acc), shape)
    finally:
        ms.stop()
    for r in res.values():
        assert r["system.path"].tolist() == [
            ms.commit_path, str(ms.commit_path_reason)] == ["fused", "None"]
        assert r["system.mesh"].tolist() == [want_dump["mesh"]["stream"],
                                             want_dump["mesh"]["metric"]]
        # queued by the bridge, committed by the query on the main thread
        assert int(r["system.queued"]) == 0
        assert int(r["system.drained"]) == R.MC_BROADCAST
        assert int(r["system.backfilled"]) == R.MC_INTERVALS - R.MC_BROADCAST
        assert "fused_degraded" not in r["system.health"].tolist()


@pytest.mark.parametrize("shape", R.MC_SHAPES, ids=SHAPE_IDS)
def test_fanout_on_a_mesh_equals_the_jax_fanout(shape, ranks, inputs):
    res = ranks(shape)
    ms = _jax_system(shape, commit="fanout")
    try:
        raws = _raws(inputs, shape)
        ms.backfill_retention(raws)
        for raw in raws:
            ms.aggregator.merge_raw(raw)
        _check_wheel(res, "fanout", ms.retention, shape[1])
        _check_served(res, "fanout", _serve_jax(
            ms.query, ms.query_group_by, ms.window_rate))
        _check_collect(res, "fanout", ms.device_metrics(reset=False).metrics)
        _check_acc(res, "fanout", np.asarray(ms.aggregator._acc), shape)
    finally:
        ms.stop()
    for r in res.values():
        assert r["fanout.path"].tolist() == ["fanout", "True"]


def _stop_want(inputs, shape, m):
    """Block m's dense histogram of every interval a rank of metric
    column m queued before stop(): stream row s's first
    ``mc_stop_count(s, m)`` intervals, summed over the stream rows."""
    rows = R.MC_M // shape[1]
    want = np.zeros((rows, 2 * R.MC_BL + 1), np.int64)
    for s in range(shape[0]):
        for i in range(R.mc_stop_count(s, m)):
            for k, b, c in inputs[f"mc.{i}.{s}"].tolist():
                if m * rows <= k < (m + 1) * rows:
                    want[k - m * rows,
                         min(max(b, -R.MC_BL), R.MC_BL) + R.MC_BL] += c
    return want


@pytest.mark.parametrize("commit", ["auto", "fanout"])
@pytest.mark.parametrize("shape", R.MC_SHAPES, ids=SHAPE_IDS)
def test_stop_commits_every_queued_interval_of_every_rank(shape, commit,
                                                          ranks, inputs):
    """Rank (s, m) queues ``mc_stop_count(s, m)`` intervals and stops: the
    last drain commits the most any rank holds (a rank short of it
    commits empty intervals), so the rings and the collected accumulator
    hold every queued sample of every rank, and every rank's tiers are
    in the same state.  The second tier spans 6 intervals, more than any
    rank queues, so its slots hold them all."""
    res = ranks(shape)
    key = f"stop_{commit}"
    most = max(R.mc_stop_count(s, m) for s, m in res)
    states = {t: res[(0, 0)][f"{key}.state{t}"].tolist()
              for t in range(len(R.MC_TIERS))}
    for (s, m), r in res.items():
        n = R.mc_stop_count(s, m)
        assert int(r[f"{key}.queued"]) == n
        # the watchdog names a backlog of stall_intervals (3) or more
        assert ("commit_backlog" in r[f"{key}.health"].tolist()) == (n >= 3)
        assert int(r[f"{key}.padded"]) == most - n
        assert int(r[f"{key}.pushed"]) == most
        for t in states:
            assert r[f"{key}.state{t}"].tolist() == states[t], (s, m, t)
        want = _stop_want(inputs, shape, m)
        np.testing.assert_array_equal(
            r[f"{key}.ring1"].astype(np.int64).sum(axis=0), want,
            err_msg=f"rank {(s, m)}")
    for m in range(shape[1]):
        summed = sum(res[(s, m)][f"{key}.acc"].astype(np.int64)
                     for s in range(shape[0]))
        np.testing.assert_array_equal(summed, _stop_want(inputs, shape, m))


@pytest.mark.parametrize("shape", R.MC_SHAPES, ids=SHAPE_IDS)
def test_an_incapable_mesh_degrades_with_the_reference_reason(
        shape, ranks, monkeypatch):
    monkeypatch.setattr(
        jax_dispatch, "mesh_commit_incapability",
        R.mc_incapable(jax_dispatch.mesh_commit_incapability))
    ms = _jax_system(shape, observability=JaxObsConfig())
    try:
        want = [ms.commit_path, str(ms.commit_path_reason)]
        details = [r["detail"] for r in ms.health.report().reasons
                   if r["code"] == "fused_degraded"]
    finally:
        ms.stop()
    try:
        _jax_system(shape, commit="fused").stop()
        explicit = ""
    except ValueError as e:
        explicit = str(e)
    if shape[1] == 1:  # every row count divides a one-way metric axis
        assert want == ["fused", "None"] and not details and not explicit
    else:
        assert want[0] == "fanout" and "shard evenly" in want[1]
        assert want[1] in details[0] and want[1] in explicit
    for r in ranks(shape).values():
        assert r["degraded.path"].tolist() == want
        assert r["degraded.health"].tolist() == details
        assert str(r["degraded.explicit"]) == explicit


@pytest.mark.parametrize("shape", R.MC_SHAPES, ids=SHAPE_IDS)
def test_dispatch_matches_the_jax_table_on_the_same_meshes(shape, ranks):
    mesh = jax_make_mesh(stream=shape[0], metric=shape[1])
    odd = 2 * shape[1] + 1
    want = [
        str(jax_dispatch.mesh_commit_incapability(mesh, R.MC_M)),
        str(jax_dispatch.mesh_commit_incapability(mesh, odd)),
        jax_dispatch.resolve_commit_path("auto", "cpu", mesh=mesh,
                                         num_metrics=R.MC_M),
        jax_dispatch.resolve_commit_path("auto", "cpu", mesh=mesh,
                                         num_metrics=odd),
        jax_dispatch.resolve_commit_path("fanout", "cpu", mesh=mesh,
                                         num_metrics=odd),
    ]
    try:
        jax_dispatch.resolve_commit_path("fused", "cpu", mesh=mesh,
                                         num_metrics=odd)
        explicit = ""
    except ValueError as e:
        explicit = str(e)
    for r in ranks(shape).values():
        assert r["dispatch.reasons"].tolist() == want
        assert str(r["dispatch.explicit"]) == explicit
    if shape[1] > 1:
        assert want[3] == "fanout" and explicit


def test_dispatch_names_a_foreign_axis_layout_as_the_reference():
    from types import SimpleNamespace

    from jax.sharding import Mesh

    from loghisto_tpu_torch.ops import dispatch

    jax_mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("x", "y"))
    port_mesh = SimpleNamespace(mesh_dim_names=("x", "y"))
    want = jax_dispatch.mesh_commit_incapability(jax_mesh, 16)
    assert dispatch.mesh_commit_incapability(port_mesh, 16) == want
    assert dispatch.resolve_commit_path("auto", mesh=port_mesh) == "fanout"
    assert dispatch.mesh_commit_incapability(None) is None


@pytest.mark.parametrize("shape", R.MC_SHAPES, ids=SHAPE_IDS)
def test_refusals_in_the_reference_words(shape, ranks):
    s_n, m_n = shape
    cfg = JaxConfig(bucket_limit=R.MC_BL)
    agg, wheel = _jax_pair(shape, R.MC_M)
    plain = JaxWheel(num_metrics=R.MC_M, config=cfg, tiers=R.MC_TIERS,
                     registry=agg.registry)
    want = {}
    for key, fn in (
            ("chunk", lambda: JaxCommitter(agg, wheel, chunk=R.MC_CHUNK - 1)),
            ("meshes", lambda: JaxCommitter(agg, plain)),
            ("wheel_rows", lambda: JaxWheel(
                num_metrics=2 * m_n + 1, config=cfg, tiers=R.MC_TIERS,
                mesh=jax_make_mesh(stream=s_n, metric=m_n)))):
        try:
            fn()
            want[key] = ""
        except ValueError as e:
            want[key] = str(e)
    agg.close()
    assert ("stream" in want["chunk"]) == (s_n > 1)
    assert "different meshes" in want["meshes"]
    for r in ranks(shape).values():
        for key, w in want.items():
            assert str(r[f"refuse.{key}"]) == w, key
        # lifecycle and drift on a mesh construct since item 11b-2
        for key in ("lifecycle", "anomaly", "sys_lifecycle", "sys_anomaly"):
            assert str(r[f"refuse.{key}"]) == "", key
        # the state and crash recovery on a mesh since 11b-3 (D11)
        for key in ("agg_state", "wheel_state", "sys_recovery"):
            assert str(r[f"refuse.{key}"]) == "", key
        assert int(r["sys_recovery.checkpoints"]) == 1
        # paged storage on a mesh constructs since 11c-1 (ROADMAP D12)
        assert str(r["refuse.sys_paged"]) == ""
