"""Checkpoints, the journal and crash recovery across mesh shapes
(ROADMAP Queue 1 item 11b-3, decision D11): ``utils/checkpoint.save`` /
``restore`` on ``TorchAggregator(mesh=)`` with the lifecycle and drift
managers, the gathered states of the aggregator, the wheel and the
managers, the stream rows' journals and ``TorchMetricSystem(mesh=,
lifecycle=, anomaly=, resilience=)``, against the JAX package (the
counterpart of ``tests/test_mesh_commit.py``'s
``test_checkpoint_roundtrip_across_mesh_shapes`` and the system's
crash recovery) at M = 16, ``bucket_limit`` 256, one tier of 4 slots.

Two launches (``test_torch_ranks.launch``: gloo, a ``FileStore`` in
``tmp_path``, the ``mesh_recovery:<save>,<target>`` job; every
collective on a rank's main thread, or the launch fails): two ranks
save on (2, 1) and restore onto (1, 2), four save on (2, 2) and restore
onto (4, 1).  Before each launch the test process writes a JAX save
taken on ``make_mesh(2, 4)`` over the conftest's 8 virtual CPU devices.
Rank (s, m) commits the intervals of stream row s (every name in each,
in the same order); the JAX side commits their merged intervals.  The
scenarios: the save and its file; its restore onto the target mesh,
onto the saving mesh (where a restore added the whole delta to every
stream row's partial before, doubling every count), onto one device and
onto JAX's ``make_mesh(1, 8)``; the JAX save onto both port meshes; the
gathered states loaded onto the target mesh; a restore that grows a
registry holding other names; faults at "checkpoint.write" and
"checkpoint.rename" on rank (0, 0); a save's gathers to rank (0, 0)
alone and the bytes each rank hands them; a system crashed by hand
after 12 intervals (its checkpoint at interval 8, no final checkpoint)
and recovered onto the target mesh from the rows' journals, and onto
one device; a crash on the (1, 2) target mesh (one stream row, its
journal ``jl.log.row0of1``) recovered onto one device; one plain
journal replayed line by line.

Tolerances:
  * the accumulator (the stream rows' partials, with their spill, summed
    per metric column), the lifetime store, the registry, the activity
    blocks, the ring blocks, the counters and the collected sets: EQUAL;
  * the banks: rtol 1e-6, atol 1e-7;
  * the scores: as ``tests/test_torch_mesh_lifecycle.py`` states them.
"""

import dataclasses
import os
import pickle
import shutil

import numpy as np
import pytest

from loghisto_tpu.anomaly import AnomalyConfig as JaxAnomalyConfig
from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.lifecycle import LifecycleConfig as JaxLifecycleConfig
from loghisto_tpu.metrics import RawMetricSet as JaxRawMetricSet
from loghisto_tpu.parallel.mesh import make_mesh as jax_make_mesh
from loghisto_tpu.resilience import ResilienceConfig as JaxResilienceConfig
from loghisto_tpu.system import TPUMetricSystem
from loghisto_tpu.utils import checkpoint as jck
from loghisto_tpu.utils import journal as jjournal

from loghisto_tpu_torch.anomaly import AnomalyConfig, AnomalyManager
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.lifecycle import LifecycleConfig, LifecycleManager
from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
from loghisto_tpu_torch.state import (
    anomaly_state_from_jax,
    lifecycle_state_from_jax,
    state_from_jax,
    wheel_state_from_jax,
)
from loghisto_tpu_torch.utils import checkpoint
from loghisto_tpu_torch.window.store import TimeWheel

import test_torch_ranks as R
from test_torch_aggregator import _assert_same
from test_torch_mesh_lifecycle import (
    _block,
    _check,
    _jax_acc,
    _jax_pipeline,
    _synchronised,
)

LAUNCH_IDS = [x.replace(",", "-to-") for x in R.MR_LAUNCHES]
JAX_SAVE_SHAPE = (2, 4)


def _make_inputs():
    rng = np.random.default_rng(23)
    d = {}
    for i in range(R.MR_CRASH + R.MR_AFTER):
        for s in range(R.MR_STREAM_ROWS):
            n = int(rng.integers(12, 30))
            cells = np.empty((n, 3), np.int64)
            cells[:, 0] = rng.integers(0, R.MR_NAMES, n)
            cells[:, 1] = rng.integers(-4, 300, n)
            cells[:, 2] = rng.integers(1, 50, n)
            d[f"mr.{i}.{s}"] = cells
    return d


@pytest.fixture(scope="module")
def inputs():
    return _make_inputs()


def _jax_raws(inputs, rows, lo, hi):
    return [R.mr_raw(JaxRawMetricSet, inputs, rows, i) for i in range(lo, hi)]


def _jax_lc():
    return R.ml_lifecycle_config(JaxLifecycleConfig)


def _jax_an():
    return R.ml_anomaly_config(JaxAnomalyConfig)


def _jax_fed(shape, inputs, rows, **agg_kw):
    """The JAX sharded pipeline on ``shape`` fed the merged intervals of
    ``rows`` that the ranks commit before their save."""
    out = _jax_pipeline(shape, R.MR_M, R.MR_TIERS, lifecycle=_jax_lc(),
                        anomaly=_jax_an(), **agg_kw)
    for raw in _jax_raws(inputs, rows, 0, R.MR_SAVED):
        out[0].commit(raw)
    return out


def _jax_restored(shape, path, others=False):
    """A fresh JAX sharded pipeline on ``shape`` restored from ``path``
    (with ``others``: holding R.MR_OTHERS names first, free to grow)."""
    kw = {"max_metrics": R.MR_GROW_MAX} if others else {}
    com, agg, wheel, lc, an = _jax_pipeline(
        shape, R.MR_M, R.MR_TIERS, lifecycle=_jax_lc(), anomaly=_jax_an(),
        **kw)
    if others:
        for k in range(R.MR_OTHERS):
            agg._id_for(f"other{k}")
    watermark = jck.restore(path, aggregator=agg, lifecycle=lc, anomaly=an)
    return com, agg, wheel, lc, an, watermark


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Per launch: its directory and every rank's results by coordinate
    on the saving mesh and on the target mesh."""
    cache = {}

    def get(launch):
        if launch not in cache:
            (s0, m0), _ = R.mr_shapes(launch)
            d = tmp_path_factory.mktemp("mr" + launch.replace(",", "-"))
            com, agg, wheel, lc, an = _jax_fed(JAX_SAVE_SHAPE, inputs,
                                               range(JAX_SAVE_SHAPE[0]))
            try:
                jck.save(str(d / "jax.npz"), aggregator=agg, lifecycle=lc,
                         anomaly=an, seq_watermark=R.MR_SAVED)
                with open(d / "jax_state.pkl", "wb") as f:
                    pickle.dump(_port_states(agg, wheel, lc, an), f)
            finally:
                agg.close()
            results = R.launch(d, s0 * m0, f"mesh_recovery:{launch}",
                               {**inputs, "mr.dir": np.array(str(d))})
            cache[launch] = (d, {
                tuple(r["coord.src"].tolist()): r for r in results}, {
                tuple(r["coord.dst"].tolist()): r for r in results})
        return cache[launch]

    return get


def _port_states(agg, wheel, lc, an):
    """A JAX mesh pipeline's states in the port's formats (``state.py``:
    the JAX arrays gathered to the host)."""
    return (
        state_from_jax(np.asarray(agg._acc), agg.registry.names(), agg._agg,
                       agg._spill),
        wheel_state_from_jax(wheel),
        lifecycle_state_from_jax(lc.state_dict()),
        anomaly_state_from_jax(an.state_dict()))


def _shapes(launch):
    return R.mr_shapes(launch)


def _rows(shape):
    return range(shape[0])


def _check_restored(res, key, shape, path, others=False):
    """Every rank's blocks after its restore against a JAX pipeline on
    the same mesh shape restored from the same file."""
    com, agg, wheel, lc, an, watermark = _jax_restored(shape, path, others)
    try:
        _check(res, key, shape, agg, wheel, lc, an)
        want = agg.collect(reset=False).metrics
    finally:
        agg.close()
    for r in res.values():
        assert int(r[f"{key}.watermark"]) == watermark == R.MR_SAVED
        _assert_same(R.get_metrics(r, f"{key}.collect"), want)
        assert str(r[f"{key}.mode"]) == "fused"
    return agg


@pytest.mark.parametrize("launch", R.MR_LAUNCHES, ids=LAUNCH_IDS)
def test_a_mesh_save_holds_the_gathered_state(launch, ranks, inputs):
    """The file a mesh writes, and every rank's gathered state, hold the
    whole state: the stream rows' partials summed, every block gathered
    over the metric axis, equal to the JAX sharded pipeline fed the
    merged intervals; never one rank's block."""
    d, res_src, _ = ranks(launch)
    src, _ = _shapes(launch)
    com, agg, wheel, lc, an = _jax_fed(src, inputs, _rows(src))
    try:
        _check(res_src, "save", src, agg, wheel, lc, an)
        acc = _jax_acc(agg)
        la = np.asarray(lc._la)
        prof, wsum = np.asarray(an._prof), np.asarray(an._wsum)
        rings = [np.asarray(t.ring) for t in wheel._tiers]
        names = agg.registry.names()
    finally:
        agg.close()
    with np.load(d / "port.npz") as f:
        assert f["mesh_shape"].tolist() == list(src)
        assert int(f["seq_watermark"]) == R.MR_SAVED
        np.testing.assert_array_equal(f["agg_acc"], acc)
        assert checkpoint._arr_names(f["agg_names"]) == names
        np.testing.assert_array_equal(f["lc_last_active"], la)
        np.testing.assert_allclose(f["an_prof"], prof, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(f["an_wsum"], wsum, rtol=1e-6, atol=1e-7)
    for r in res_src.values():
        np.testing.assert_array_equal(
            r["save.state.acc"].astype(np.int64) + (
                r["save.state.spill"] if r["save.state.spill"].size else 0),
            acc)
        for t, ring in enumerate(rings):
            np.testing.assert_array_equal(r[f"save.state.ring{t}"], ring)
        np.testing.assert_array_equal(r["save.state.la"], la)
        np.testing.assert_allclose(r["save.state.prof"], prof, rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(r["save.state.wsum"], wsum, rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("launch", R.MR_LAUNCHES, ids=LAUNCH_IDS)
def test_a_save_restores_onto_another_shape_and_into_jax(launch, ranks,
                                                         inputs):
    """The counterpart of the JAX package's cross-shape checkpoint test:
    the mesh's file restores onto the target mesh as the JAX package
    restores it there, onto one device and onto JAX's 1x8 mesh, by
    name, and the restored pipelines still commit fused."""
    d, res_src, res_dst = ranks(launch)
    src, dst = _shapes(launch)
    path = str(d / "port.npz")
    _check_restored(res_dst, "restore", dst, path)
    com, agg, wheel, lc, an = _jax_fed(src, inputs, _rows(src))
    fresh, fagg, fwheel, flc, fam, _ = _jax_restored((1, 8), path)
    cfg = MetricConfig(bucket_limit=R.MR_BL)
    one = TorchAggregator(num_metrics=R.MR_M, config=cfg, device="cpu")
    one_wheel = TimeWheel(num_metrics=R.MR_M, config=cfg, interval=1.0,
                          tiers=R.MR_TIERS, registry=one.registry,
                          device="cpu")
    one_lc = LifecycleManager(one, one_wheel, R.ml_lifecycle_config(
        LifecycleConfig))
    one_an = AnomalyManager(one, one_wheel, R.ml_anomaly_config(
        AnomalyConfig))
    try:
        assert checkpoint.restore(path, aggregator=one, lifecycle=one_lc,
                                  anomaly=one_an) == R.MR_SAVED
        src_acc, dst_acc = _jax_acc(agg), _jax_acc(fagg)
        one_acc = one._acc.numpy().astype(np.int64)
        for name in R.mr_names():
            sid = agg.registry.lookup(name)
            for target, acc, prof, wsum, la in (
                    (fagg, dst_acc, np.asarray(fam._prof),
                     np.asarray(fam._wsum), np.asarray(flc._la)),
                    (one, one_acc, one_an._prof.numpy(),
                     one_an._wsum.numpy(), one_lc._la.numpy())):
                did = target.registry.lookup(name)
                assert did is not None, name
                np.testing.assert_array_equal(src_acc[sid], acc[did])
                np.testing.assert_allclose(
                    np.asarray(an._prof)[:, sid], prof[:, did], rtol=1e-6,
                    atol=1e-7)
                np.testing.assert_allclose(
                    np.asarray(an._wsum)[:, sid], wsum[:, did], rtol=1e-6,
                    atol=1e-7)
                assert np.asarray(lc._la)[sid] == la[did]
        # the restored JAX pipeline on 1x8 still commits fused
        assert fresh.commit(R.mr_raw(JaxRawMetricSet, inputs, (0,),
                                     R.MR_SAVED)) == "fused"
        _assert_same(one.collect(reset=False).metrics,
                     agg.collect(reset=False).metrics)
    finally:
        for a in (agg, fagg, one):
            a.close()


@pytest.mark.parametrize("launch", R.MR_LAUNCHES, ids=LAUNCH_IDS)
def test_a_restore_onto_the_saving_shape_counts_once(launch, ranks):
    """The stream-partial case: a restore onto the mesh that saved puts
    the accumulator's rows on stream index 0 alone, so the collected
    counts are the saved ones exactly (before D11 every stream row's
    partial took the whole delta)."""
    d, res_src, _ = ranks(launch)
    src, _ = _shapes(launch)
    _check_restored(res_src, "same", src, str(d / "port.npz"))
    for (s, m), r in res_src.items():
        assert R.get_metrics(r, "same.collect") == R.get_metrics(
            r, "save.collect")
        if s:  # only stream index 0 holds restored rows
            assert not r["same.acc"].any()


@pytest.mark.parametrize("launch", R.MR_LAUNCHES, ids=LAUNCH_IDS)
def test_a_jax_mesh_save_restores_onto_the_port_meshes(launch, ranks):
    """A save the JAX package took on its 2x4 mesh restores onto both
    port meshes as it restores onto JAX meshes of those shapes."""
    d, res_src, res_dst = ranks(launch)
    src, dst = _shapes(launch)
    path = str(d / "jax.npz")
    _check_restored(res_dst, "jax", dst, path)
    _check_restored(res_src, "jax_src", src, path)


@pytest.mark.parametrize("launch", R.MR_LAUNCHES, ids=LAUNCH_IDS)
def test_gathered_states_load_onto_another_shape(launch, ranks, inputs):
    """``state_dict`` of the aggregator, the wheel and both managers on
    the saving mesh, loaded onto the target mesh: every rank's blocks are
    the blocks of the JAX pipeline that fed the saving mesh's intervals,
    rings included, and the collected set is the same."""
    _, res_src, res_dst = ranks(launch)
    src, dst = _shapes(launch)
    com, agg, wheel, lc, an = _jax_fed(src, inputs, _rows(src))
    # a state carries no interval histogram, scores or skip count
    an._ihist, an._scores, an.skipped_intervals = None, None, 0
    try:
        _check(res_dst, "load", dst, agg, wheel, lc, an)
        want = agg.collect(reset=False).metrics
    finally:
        agg.close()
    for r in res_dst.values():
        _assert_same(R.get_metrics(r, "load.collect"), want)


@pytest.mark.parametrize("launch", R.MR_LAUNCHES, ids=LAUNCH_IDS)
def test_a_jax_mesh_state_loads_onto_the_port_meshes(launch, ranks, inputs):
    """``state.py`` carries a JAX ``TPUAggregator(mesh=)``'s,
    ``TimeWheel(mesh=)``'s and managers' states (2x4, read through their
    gathered host arrays) onto a port mesh of another shape: every
    rank's blocks are the JAX carries' rows."""
    _, _, res_dst = ranks(launch)
    _, dst = _shapes(launch)
    com, agg, wheel, lc, an = _jax_fed(JAX_SAVE_SHAPE, inputs,
                                       _rows(JAX_SAVE_SHAPE))
    an._ihist, an._scores, an.skipped_intervals = None, None, 0
    try:
        _check(res_dst, "jaxstate", dst, agg, wheel, lc, an)
        want = agg.collect(reset=False).metrics
    finally:
        agg.close()
    for r in res_dst.values():
        _assert_same(R.get_metrics(r, "jaxstate.collect"), want)


@pytest.mark.parametrize("launch", R.MR_LAUNCHES, ids=LAUNCH_IDS)
def test_host_stores_sum_over_stream_and_restore_on_stream_lead(
        launch, ranks):
    """The host MetricSystem's lifetime stores: each stream row's ranks
    hold that row's samples, so a mesh save holds their sum over the
    stream axis (a counter sums over stream, D9), and a restore puts it
    on stream index 0's ranks alone; the JAX package reads the totals."""
    from loghisto_tpu.metrics import MetricSystem as JaxMetricSystem

    d, _, res_dst = ranks(launch)
    src, _ = _shapes(launch)
    want = {"req": float(sum(3 + s for s in _rows(src))),
            **{f"row{s}": 1.0 for s in _rows(src)}}
    count = 3.0 * src[0]
    for (s, m), r in res_dst.items():
        counters = R.get_metrics(r, "restore.counters")
        hist = R.get_metrics(r, "restore.hist")
        if s == 0:
            assert counters == want
            assert hist["lat.1"] == count
        else:
            assert counters == {} and hist == {}
    jms = JaxMetricSystem(interval=1.0, sys_stats=False)
    jck.restore(str(d / "port.npz"), metric_system=jms)
    assert {k: float(v) for k, v in jms._counter_store.items()} == want
    assert jms._histogram_agg_store["lat"][1] == count


@pytest.mark.parametrize("launch", R.MR_LAUNCHES, ids=LAUNCH_IDS)
def test_a_restore_grows_a_registry_holding_other_names(launch, ranks):
    """The target holds other names first, so the saved names register
    past its rows: the restore grows the registry, lays the blocks and
    carries out anew (``_mesh_regrow``), and only then adds, as the JAX
    package's restore does on its mesh."""
    d, _, res_dst = ranks(launch)
    _, dst = _shapes(launch)
    agg = _check_restored(res_dst, "grow", dst, str(d / "port.npz"),
                          others=True)
    assert agg.num_metrics > R.MR_M
    for r in res_dst.values():
        assert int(r["grow.m"]) == agg.num_metrics


@pytest.mark.parametrize("launch", R.MR_LAUNCHES, ids=LAUNCH_IDS)
def test_a_failed_write_on_rank_0_keeps_every_rank_in_step(launch, ranks):
    """Faults at "checkpoint.write" (the second save) and
    "checkpoint.rename" (the third) on rank (0, 0) alone: every rank
    reports both failures and counts them, the first file stays, the
    fourth save lands; a watermark that differs across ranks is refused
    on every rank."""
    _, _, res_dst = ranks(launch)
    for r in res_dst.values():
        assert r["faults.ok"].tolist() == [True, False, False, True]
        assert bool(r["faults.kept"])
        assert r["faults.counts"].tolist() == [2, 2, 4]
        assert not bool(r["faults.split_watermark"])
        assert int(r["faults.errors"]) == 3


def _jax_system(shape, ck, jl):
    return TPUMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=R.MR_M,
        config=JaxConfig(bucket_limit=R.MR_BL), retention=R.MR_TIERS,
        mesh=jax_make_mesh(stream=shape[0], metric=shape[1]),
        lifecycle=_jax_lc(), anomaly=_jax_an(),
        resilience=JaxResilienceConfig(
            checkpoint_path=ck, journal_path=jl,
            checkpoint_every_intervals=R.MR_EVERY, recover_on_start=False))


def _jax_crash_and_recover(inputs, src, dst, tmp):
    """The JAX system on the saving shape takes the merged intervals
    (its checkpoint at interval 8), its journal holds them all, and it
    crashes; a JAX system on the target shape recovers and takes the
    merged intervals after."""
    ck, jl = str(tmp / "jax-ck.npz"), str(tmp / "jax-jl.log")
    ms = _jax_system(src, ck, jl)
    _synchronised(ms.committer)
    raws = _jax_raws(inputs, _rows(src), 0, R.MR_CRASH)
    try:
        ms.backfill_retention(raws)
        assert ms.recovery.last_checkpoint_seq == R.MR_EVERY
        with open(jl, "w") as f:
            for raw in raws:
                f.write(jjournal.dump_line(raw) + "\n")
        shutil.copy(ck, ck + ".crash")  # the files as the crash left them
    finally:
        ms.recovery.checkpoint_path = None  # no final checkpoint
        ms.stop()
    os.replace(ck + ".crash", ck)
    ms = _jax_system(dst, ck, jl)
    _synchronised(ms.committer)
    rep = ms.recover()
    ms.backfill_retention(_jax_raws(inputs, _rows(src), R.MR_CRASH,
                                    R.MR_CRASH + R.MR_AFTER))
    return ms, rep


@pytest.mark.parametrize("launch", R.MR_LAUNCHES, ids=LAUNCH_IDS)
def test_a_crashed_mesh_system_recovers_onto_another_shape(
        launch, ranks, inputs, tmp_path):
    """TorchMetricSystem(mesh=, lifecycle=, anomaly=, resilience=) on the
    saving mesh crashes after 12 intervals (its checkpoint at 8, each
    stream row's journal written by the row's rank at metric index 0);
    a system on the target mesh recovers (target row r replays the saved
    rows j with j % rows == r, an empty interval where it has none) and
    takes 4 more intervals: every rank's blocks, counters, scores and
    collected set equal the JAX system recovered on the target shape
    from the merged intervals and the same watermark."""
    d, res_src, res_dst = ranks(launch)
    src, dst = _shapes(launch)
    for (s, m), r in res_src.items():
        assert int(r["crash.committed"]) == R.MR_CRASH
        assert r["crash.checkpoints"].tolist() == [1, R.MR_EVERY,
                                                   R.MR_CRASH]
        want = [f"jl.log.row{s}of{src[0]}"] if m == 0 else []
        assert [os.path.basename(p) for p in r["crash.journal"].tolist()
                ] == want
        assert r["crash.files"].tolist() == [
            f"jl.log.row{j}of{src[0]}" for j in range(src[0])]
    for j in range(src[0]):
        # each row's file is the JAX package's line format
        lines = list(jjournal.replay(str(d / f"jl.log.row{j}of{src[0]}")))
        assert [raw.seq for raw in lines] == list(range(1, R.MR_CRASH + 1))
        want = _jax_raws(dict(inputs), (j,), 0, R.MR_CRASH)
        assert [raw.histograms for raw in lines] == [
            raw.histograms for raw in want]
    ms, rep = _jax_crash_and_recover(inputs, src, dst, tmp_path)
    try:
        assert rep.watermark == R.MR_EVERY
        assert rep.replayed_intervals == R.MR_CRASH - R.MR_EVERY
        _check(res_dst, "recover", dst, ms.aggregator, ms.retention,
               ms.lifecycle, ms.anomaly)
        want = ms.aggregator.collect(reset=False).metrics
        keys = sorted(ms.debug_dump()["resilience"])
    finally:
        ms.recovery.checkpoint_path = None
        ms.stop()
    for r in res_dst.values():
        assert r["recover.report"].tolist() == [
            R.MR_EVERY, R.MR_CRASH - R.MR_EVERY, R.MR_EVERY * src[0], 1, 1]
        assert int(r["recover.seq_next"]) == R.MR_CRASH + 1
        _assert_same(R.get_metrics(r, "recover.collect"), want)
        assert r["recover.dump"].tolist() == keys
        assert r["recover.final"].tolist() == [1, 0]  # stop()'s checkpoint
    # the recovered blocks' stream sum equals the merged intervals' total
    total = sum(int(c[:, 2].sum()) for i in range(R.MR_CRASH + R.MR_AFTER)
                for s, c in ((s, inputs[f"mr.{i}.{s}"]) for s in _rows(src)))
    summed = sum(int(r["recover.acc"].sum()) for r in res_dst.values())
    assert summed == total


def _one_device_recovers(crash_dir, src, inputs, tmp_path):
    """A device with no mesh recovers from a crashed mesh's checkpoint
    and rows' journals in ``crash_dir`` (its rows merged as row 0 of 1)
    and takes the merged intervals after: the state of the JAX system
    that crashed on ``src`` and recovered on one device."""
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.system import TorchMetricSystem
    from loghisto_tpu_torch.resilience import ResilienceConfig

    ms = TorchMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=R.MR_M,
        config=MetricConfig(bucket_limit=R.MR_BL), retention=R.MR_TIERS,
        device="cpu", lifecycle=R.ml_lifecycle_config(LifecycleConfig),
        anomaly=R.ml_anomaly_config(AnomalyConfig),
        resilience=ResilienceConfig(
            checkpoint_path=str(crash_dir / "ck.npz"),
            journal_path=str(crash_dir / "jl.log"),
            checkpoint_every_intervals=R.MR_EVERY, recover_on_start=False))
    jms, jrep = _jax_crash_and_recover(inputs, src, (1, 1), tmp_path)
    try:
        rep = ms.recover()
        assert (rep.watermark, rep.replayed_intervals) == (
            jrep.watermark, jrep.replayed_intervals) == (
            R.MR_EVERY, R.MR_CRASH - R.MR_EVERY)
        assert rep.journal_found
        assert next(ms._interval_seq) == R.MR_CRASH + 1
        ms.backfill_retention([R.mr_raw(RawMetricSet, inputs, _rows(src), i)
                               for i in range(R.MR_CRASH,
                                              R.MR_CRASH + R.MR_AFTER)])
        res = {(0, 0): {}}
        R._put_carries(res[(0, 0)], "one", ms.aggregator, ms.retention,
                       ms.lifecycle, ms.anomaly)
        _check(res, "one", (1, 1), jms.aggregator, jms.retention,
               jms.lifecycle, jms.anomaly)
        _assert_same(ms.aggregator.collect(reset=False).metrics,
                     jms.aggregator.collect(reset=False).metrics)
    finally:
        ms.recovery.checkpoint_path = jms.recovery.checkpoint_path = None
        ms.stop()
        jms.stop()


@pytest.mark.parametrize("launch", R.MR_LAUNCHES, ids=LAUNCH_IDS)
def test_one_device_recovers_a_mesh_crash(launch, ranks, inputs, tmp_path):
    """The crashed mesh's checkpoint and rows' journals, as the crash
    left them, recover one device with no mesh (its rows merged as row 0
    of 1): the state of the JAX system recovered from the merged
    intervals."""
    d, _, _ = ranks(launch)
    src, _ = _shapes(launch)
    _one_device_recovers(d / "crash", src, inputs, tmp_path)


def test_one_device_recovers_a_one_row_mesh_crash(ranks, inputs, tmp_path):
    """A crash on a mesh of one stream row, (1, 2): rank (0, 0) journals
    to ``jl.log.row0of1`` and rank (0, 1) journals nothing; one device
    with no mesh recovers every journaled interval past the watermark
    from that file (no plain ``jl.log`` exists), equal to the JAX
    system's recovery."""
    launch = R.MR_LAUNCHES[0]
    d, _, res_dst = ranks(launch)
    _, dst = _shapes(launch)
    assert dst == (1, 2)
    for (s, m), r in res_dst.items():
        assert int(r["onerow.committed"]) == R.MR_CRASH
        assert r["onerow.checkpoints"].tolist() == [1, R.MR_EVERY,
                                                    R.MR_CRASH]
        assert [os.path.basename(p) for p in r["onerow.journal"].tolist()
                ] == (["jl.log.row0of1"] if m == 0 else [])
        assert r["onerow.files"].tolist() == ["jl.log.row0of1"]
    crash = d / "onerow" / "crash"
    assert sorted(os.listdir(crash)) == ["ck.npz", "jl.log.row0of1"]
    _one_device_recovers(crash, dst, inputs, tmp_path)


@pytest.mark.parametrize("launch", R.MR_LAUNCHES, ids=LAUNCH_IDS)
def test_a_save_gathers_to_rank_0_alone(launch, ranks):
    """A checkpoint's save sends every rank's parts to rank (0, 0) alone:
    ``state_dict(first_only=True)`` of the aggregator and the managers
    returns the gathered state there, the same as the every-rank
    ``state_dict``, and None on every other rank.  Counted at the
    collectives, rank (0, 0) hands them only the agreement's few bytes,
    and every other rank at least its int64 accumulator block."""
    _, res_src, _ = ranks(launch)
    src, _ = _shapes(launch)
    block = R.MR_M // src[1] * (2 * R.MR_BL + 1) * 8
    for coord, r in res_src.items():
        first = coord == (0, 0)
        assert r["save.first_only"].tolist() == [first] * 3
        if first:
            assert r["save.first_same"].tolist() == [True] * 5
            assert 0 < int(r["save.sent"]) < 256
        else:
            assert "save.first_same" not in r
            assert int(r["save.sent"]) >= block


def test_one_journal_replays_line_by_line(tmp_path):
    """``_row_intervals`` on one plain journal keeps the reference's
    replay: every line its own interval, in file order, a seq-less line
    where it stands and a seq written twice (a restart that did not
    recover appends to the journal) twice; the watermark skips seq'd
    lines at or under it."""
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.resilience.recovery import _row_intervals
    from loghisto_tpu_torch.utils.journal import dump_line, row_journals

    import datetime as dt

    path = str(tmp_path / "j.log")
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    seqs = [1, 2, None, 3, 1, 2]
    with open(path, "w") as f:
        for k, q in enumerate(seqs):
            f.write(dump_line(RawMetricSet(
                t0 + dt.timedelta(seconds=k), {"c": k}, {}, {f"n{k}": {k: 1}},
                {}, 1.0, q)) + "\n")
    files = row_journals(path)
    assert [(j, n) for j, n, _ in files] == [(0, 1)]
    raws, skipped = _row_intervals(files, None, 0, 1)
    assert skipped == 0
    assert [raw.seq for raw in raws] == seqs
    assert [raw.histograms for raw in raws] == [
        {f"n{k}": {k: 1}} for k in range(len(seqs))]
    assert [raw.counters for raw in raws] == [
        {"c": k} for k in range(len(seqs))]
    raws, skipped = _row_intervals(files, 1, 0, 1)
    assert skipped == 2
    assert [raw.seq for raw in raws] == [2, None, 3, 2]
    assert [raw.counters["c"] for raw in raws] == [1, 2, 3, 5]


def test_pads_and_rows_merge_by_seq(tmp_path):
    """``_row_intervals``: the saved rows' intervals of one seq merge
    into the target row that takes them (j % rows), a row with none of
    a seq gets an empty interval of that seq, every interval lists every
    name of its seq in file order, and lines at or under the watermark
    are skipped."""
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.resilience.recovery import _row_intervals
    from loghisto_tpu_torch.utils.journal import (
        dump_line,
        row_journal_path,
        row_journals,
    )

    import datetime as dt

    base = str(tmp_path / "j.log")
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    for j in range(3):
        with open(row_journal_path(base, j, 3), "w") as f:
            for q in range(1, 4):
                raw = RawMetricSet(t0 + dt.timedelta(seconds=q), {"c": j},
                                   {"r": q}, {f"n{j}": {q: j + 1}}, {}, 1.0,
                                   q)
                f.write(dump_line(raw) + "\n")
    files = row_journals(base)
    assert [(j, n) for j, n, _ in files] == [(0, 3), (1, 3), (2, 3)]
    got = {r: _row_intervals(files, 1, r, 2) for r in range(2)}
    for r, (raws, skipped) in got.items():
        assert skipped == 3
        assert [raw.seq for raw in raws] == [2, 3]
        for raw in raws:
            assert list(raw.histograms) == ["n0", "n1", "n2"]
    row0 = got[0][0][0]
    assert row0.histograms == {"n0": {2: 1}, "n1": {}, "n2": {2: 3}}
    assert row0.counters == {"c": 2} and row0.rates == {"r": 4}
    row1 = got[1][0][0]
    assert row1.histograms == {"n0": {}, "n1": {2: 2}, "n2": {}}
    # four target rows: row 3 has no saved row and commits empty ones
    raws, _ = _row_intervals(files, None, 3, 4)
    assert [raw.seq for raw in raws] == [1, 2, 3]
    assert all(not any(h.values()) for raw in raws
               for h in [raw.histograms])
    assert dataclasses.asdict(raws[0])["rates"] == {}
