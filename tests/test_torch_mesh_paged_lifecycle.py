"""Lifecycle, checkpoints and crash recovery on paged storage on the
port's mesh (ROADMAP decision D13): ``LifecycleManager`` on
``TorchAggregator(mesh=, storage="paged")`` with ``TimeWheel(mesh=)``
(eviction into codec-less overflow rows across shards, a shed target,
compaction, growth), ``checkpoint.save`` / ``restore`` and the
aggregator's ``state_dict`` / ``load_state_dict`` across mesh shapes and
storages, and ``TorchMetricSystem(mesh=, storage="paged", lifecycle=,
resilience=)`` with ``recover()``, against the JAX package's mesh store,
committer, lifecycle manager, checkpoints and system (the counterpart of
``tests/test_mesh_paged.py:140-171`` and ``:216-264``), at its sizes:
M = 64, ``bucket_limit`` 128, ``pool_pages`` 256 (24 for a saturated
arena whose cells spill to the host).

Three launches (``test_torch_ranks.launch``: gloo, a ``FileStore`` in
``tmp_path``, the ``mesh_paged_lc:SxM`` job; every collective on a
rank's main thread, or the launch fails), in the order (2, 2), (2, 1),
(1, 2) and sharing one directory: the (2, 2) launch writes the mesh
save the others restore, the (2, 1) launch crashes the system that the
(1, 2) launch recovers.  Rank (s, m) takes stream row s's share of each
interval; the JAX side takes the merged intervals on
``make_mesh(stream=s, metric=m)`` over the conftest's 8 virtual CPU
devices.  Before the launches the test process writes a JAX (2, 4)
paged save and a dense one-device save.

Tolerances:
  * every arena against the JAX pool's block of its shard, page tables,
    codecs, free lists, counters, each rank's spilled cells against the
    JAX spill's cells of its block, ring blocks, activity blocks,
    registries, decoded pools, states: EQUAL;
  * the collected sets: ``test_torch_aggregator._assert_same``; served
    window statistics: ``test_torch_mesh_commit._assert_served``.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from loghisto_tpu.commit import IntervalCommitter as JaxCommitter
from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.lifecycle import LifecycleConfig as JaxLifecycleConfig
from loghisto_tpu.lifecycle import LifecycleManager as JaxLifecycle
from loghisto_tpu.metrics import RawMetricSet as JaxRawMetricSet
from loghisto_tpu.paging import PagedStoreConfig as JaxStoreConfig
from loghisto_tpu.parallel.aggregator import TPUAggregator
from loghisto_tpu.parallel.mesh import make_mesh as jax_make_mesh
from loghisto_tpu.system import TPUMetricSystem
from loghisto_tpu.utils import checkpoint as jck
from loghisto_tpu.window import TimeWheel as JaxWheel

from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.paging import PagedStoreConfig
from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
from loghisto_tpu_torch.utils import checkpoint

import test_torch_ranks as R
from test_torch_aggregator import _assert_same
from test_torch_mesh_commit import _assert_served, _flat_window, \
    _synchronised
from test_torch_mesh_paged import _agreeing, _check_rings, _check_store

SHAPE_IDS = [f"{s}x{m}" for s, m in R.PL_SHAPES]
JAX_CFG = JaxConfig(bucket_limit=R.PL_BL)


def _cells(rng, n_names, n=80):
    out = np.empty((n, 3), np.int64)
    out[:, 0] = rng.integers(0, n_names, n)
    out[:, 1] = rng.integers(-R.PL_BL, R.PL_BL + 1, n)
    out[:, 2] = rng.integers(1, 40, n)
    return out


def _packed(rng, n, m):
    out = np.empty((n, 3), np.int32)
    out[:, 0] = rng.integers(0, m, n)
    out[:, 1] = rng.integers(-R.PL_BL, R.PL_BL + 1, n)
    out[:, 2] = rng.integers(1, 50, n)
    return out


def _names(m=R.PL_CK_NAMES):
    return [f"h{j}" for j in range(m)]


def _make_inputs(d):
    rng = np.random.default_rng(25)
    inp = {"pl.dir": np.array(str(d))}
    for s in range(R.PL_STREAM_ROWS):
        for i in range(R.PL_BEFORE + R.PL_AFTER):
            inp[f"pl.{i}.{s}"] = _cells(rng, len(R.pl_names(i)))
        for i in range(3):
            inp[f"pls.{i}.{s}"] = _cells(rng, len(R.pl_shed_names(i)))
        for i in range(R.PL_SYS_CRASH + R.PL_SYS_AFTER):
            inp[f"plsys.{i}.{s}"] = _cells(rng, len(R.pl_names(
                i, R.PL_SYS_BEFORE, R.PL_SYS_VICTIMS)))
    for k in range(2):
        inp[f"pl.raw.{k}.ids"] = rng.integers(0, R.PL_NAMES, 512).astype(
            np.int32)
        inp[f"pl.raw.{k}.values"] = _agreeing(rng, 512, R.PL_BL)
    inp["pl.ck.packed"] = _packed(rng, 2000, R.PL_CK_NAMES)
    return inp


def _jax_agg(shape, pool=R.PL_POOL, storage="paged", **kw):
    return TPUAggregator(
        num_metrics=R.PL_M, config=JAX_CFG, storage=storage,
        paged_config=JaxStoreConfig(pool_pages=pool),
        mesh=None if shape is None else jax_make_mesh(
            stream=shape[0], metric=shape[1]), **kw)


def _write_sources(inputs, d):
    """The JAX (2, 4) paged save and the one-device dense save that every
    launch restores."""
    src = _jax_agg((2, 4), R.PL_CK_POOL)
    try:
        for name in _names():
            src._id_for(name)
        src.paged.commit(inputs["pl.ck.packed"])
        jck.save(os.path.join(d, "jax_save.npz"), aggregator=src)
    finally:
        src.close()
    dense = TorchAggregator(num_metrics=R.PL_M,
                            config=MetricConfig(bucket_limit=R.PL_BL),
                            storage="dense", device="cpu")
    try:
        for name in _names():
            dense._id_for(name)
        dense.merge_packed(inputs["pl.ck.packed"], wait=True)
        checkpoint.save(os.path.join(d, "dense_save.npz"), aggregator=dense)
    finally:
        dense.close()


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    d = tmp_path_factory.mktemp("plshared")
    inputs = _make_inputs(d)
    _write_sources(inputs, d)
    return d, inputs


@pytest.fixture(scope="module")
def ranks(shared, tmp_path_factory):
    """Per mesh shape, every rank's results, by coordinate; the launches
    run in ``R.PL_SHAPES``' order, each after the ones before it."""
    d, inputs = shared
    cache = {}

    def get(shape):
        for sh in R.PL_SHAPES[:R.PL_SHAPES.index(shape) + 1]:
            if sh not in cache:
                s, m = sh
                results = R.launch(tmp_path_factory.mktemp(f"pl{s}x{m}"),
                                   s * m, f"mesh_paged_lc:{s}x{m}", inputs)
                cache[sh] = {tuple(r["coord"].tolist()): r for r in results}
        return cache[shape]

    return get


def _merged(inputs, prefix, shape, i, names, seq=None):
    return R.pl_raw(JaxRawMetricSet,
                    [(s, inputs[f"{prefix}.{i}.{s}"]) for s in range(shape[0])],
                    i, names, seq=seq)


def _jax_pipeline(shape, pool, max_metrics=R.PL_MAX):
    agg = _jax_agg(shape, pool, max_metrics=max_metrics)
    wheel = JaxWheel(num_metrics=R.PL_M, config=JAX_CFG, interval=1.0,
                     tiers=R.PL_TIERS, registry=agg.registry,
                     mesh=agg.mesh)
    lc = JaxLifecycle(agg, wheel, JaxLifecycleConfig())
    com = _synchronised(JaxCommitter(agg, wheel, lifecycle=lc,
                                     chunk=R.PL_CHUNK))
    return agg, wheel, lc, com


def _check_lc(res, key, shape, agg, wheel, lc):
    """Every rank's arena, host half, spill, ring blocks, activity block,
    registry and lifecycle counters against the JAX pipeline's."""
    _check_store(res, key, agg.paged, shape)
    _check_rings(res, key, wheel, shape[1])
    la = np.asarray(lc._la)
    names = ["" if n is None else n for n in agg.registry.names()]
    for (s, m), r in res.items():
        rows = len(r[f"{key}.la"])
        assert len(la) == rows * shape[1], (key, len(la))
        np.testing.assert_array_equal(r[f"{key}.la"],
                                      la[m * rows:(m + 1) * rows], key)
        assert r[f"{key}.names"].tolist() == names, key
        assert r[f"{key}.lc_counters"].tolist() == [
            lc.evicted_series, lc.overflowed_samples, lc.evictions,
            lc.compactions], key


def _jax_raw(agg, inputs, k):
    """The JAX store's raw route on batch k, as the ranks land it."""
    st = agg.paged
    ids, _ = st.prepare_batch(inputs[f"pl.raw.{k}.ids"],
                              inputs[f"pl.raw.{k}.values"])
    st.ingest_raw(jnp.asarray(ids), jnp.asarray(inputs[f"pl.raw.{k}.values"]))


def _jax_lifecycle(res, inputs, shape, key, pool):
    agg, wheel, lc, com = _jax_pipeline(shape, pool)
    try:
        modes = []
        for i in range(R.PL_BEFORE + R.PL_AFTER):
            if i == 1:
                _jax_raw(agg, inputs, 0)
            if i == R.PL_BEFORE:
                victims = [agg.registry.lookup(f"p{v}")
                           for v in R.PL_VICTIMS]
                spilled = {row for (row, _) in agg.paged._host_spill
                           if row in victims}
                moved = lc.overflowed_samples
                evicted = lc.evict_ids([agg.registry.lookup(f"p{v}")
                                        for v in R.PL_VICTIMS])
                moved = lc.overflowed_samples - moved
                _check_lc(res, f"{key}.ev", shape, agg, wheel, lc)
                compacted = lc.compact()
                _check_lc(res, f"{key}.cp", shape, agg, wheel, lc)
                _jax_raw(agg, inputs, 1)
            modes.append(com.commit(_merged(inputs, "pl", shape, i,
                                            R.pl_names(i))))
        _check_lc(res, f"{key}.end", shape, agg, wheel, lc)
        want = agg.collect(reset=False).metrics
        m = agg.num_metrics
    finally:
        agg.close()
    assert com.fanout_intervals == 0
    for r in res.values():
        assert r[f"{key}.evicted"].tolist() == evicted
        assert int(r[f"{key}.moved"]) == moved > 0
        assert bool(r[f"{key}.compacted"]) == compacted is True
        assert r[f"{key}.modes"].tolist() == modes == ["fused"] * len(modes)
        assert int(r[f"{key}.fanout"]) == 0
        assert r[f"{key}.m"].tolist() == [m, m] == [R.PL_MAX, R.PL_MAX]
        _assert_same(R.get_metrics(r, f"{key}.collect"), want)
    return agg, spilled


@pytest.mark.parametrize("shape", R.PL_SHAPES, ids=SHAPE_IDS)
def test_evict_compact_and_grow_equal_the_jax_mesh_pipeline(shape, ranks,
                                                            shared):
    """JAX ``tests/test_mesh_paged.py:140-171`` on the port's ranks: three
    commits, ``evict_ids`` of four names (each into its own codec-less
    overflow row, from one shard into the other on a two-way metric
    axis), ``compact()``, three commits whose fresh names grow the
    registry from 64 rows to 128 (the shard blocks redrawn, the rows
    that change shard migrated).  After the eviction, the compaction and
    the last commit every rank's arena, host half, ring blocks and
    activity block equal the JAX pipeline's on the same mesh shape."""
    res = ranks(shape)
    agg, _ = _jax_lifecycle(res, shared[1], shape, "lc", R.PL_POOL)
    # each overflow row, registered by the eviction, took a codec there
    codecs = agg.paged.row_codec
    assert all(codecs[agg.registry.lookup(f"_overflow.p{v}")] >= 0
               for v in R.PL_VICTIMS)


@pytest.mark.parametrize("shape", R.PL_SHAPES, ids=SHAPE_IDS)
def test_spilled_victims_fold_and_migrate_across_shards(shape, ranks,
                                                        shared):
    """The same pipeline on arenas of 24 pages: the victims' cells sit
    partly in their owners' blocks of the host spill, the fold moves
    them to the target's block (another shard on a two-way metric axis),
    and the compaction and the growth migrate spilled rows between
    blocks; every rank's spill is the JAX spill's cells of its block."""
    res = ranks(shape)
    agg, spilled = _jax_lifecycle(res, shared[1], shape, "lcsat",
                                  R.PL_SAT_POOL)
    assert agg.paged.spilled_cells > 0 and agg.paged._host_spill
    # a victim of the first block held spilled cells; its overflow row
    # (ids 40-43) lies in the second block of a two-way metric axis
    assert 25 in spilled


@pytest.mark.parametrize("shape", R.PL_SHAPES, ids=SHAPE_IDS)
def test_a_shed_target_drops_its_victim(shape, ranks, shared):
    """A registry one row short of its growth cap: the first victim folds
    into the free row, the second's overflow name is shed, and its
    victim is dropped from the arenas and the spill blocks; the rest of
    the store equals the JAX pipeline's."""
    res = ranks(shape)
    inputs = shared[1]
    agg, wheel, lc, com = _jax_pipeline(shape, R.PL_SAT_POOL,
                                        max_metrics=R.PL_M)
    try:
        for i in range(3):
            if i == 2:
                evicted = lc.evict_ids([agg.registry.lookup(f"p{v}")
                                        for v in R.PL_SHED_VICTIMS])
                _check_lc(res, "shed.ev", shape, agg, wheel, lc)
                assert agg.registry.lookup("_overflow.p40") is None
                assert agg.registry.lookup("_overflow.p5") == R.PL_M - 1
            com.commit(_merged(inputs, "pls", shape, i, R.pl_shed_names(i)))
        _check_lc(res, "shed.end", shape, agg, wheel, lc)
    finally:
        agg.close()
    for r in res.values():
        assert r["shed.evicted"].tolist() == evicted == ["p5", "p40"]


# -- checkpoints and states ------------------------------------------------


def _jax_restored(shape, path, big=False):
    agg = _jax_agg(shape)
    if big:
        agg.paged.commit(np.array([[R.PL_BIG_ROW, 0, R.PL_BIG]], np.int32))
    jck.restore(path, aggregator=agg)
    return agg


def _want(inputs):
    jst = _jax_agg(None, R.PL_CK_POOL)
    try:
        for name in _names():
            jst._id_for(name)
        jst.paged.commit(inputs["pl.ck.packed"])
        return jst.paged.decode_dense(), jst.paged.codec_names()
    finally:
        jst.close()


def _check_loaded(res, key, jst, shape):
    """A store loaded from a state: what the state carries (each rank's
    arena, the host half, its block's spill and the allocation count)
    equals the JAX store's; the other counters start anew, as on one
    device."""
    sp = jst.shard_pages
    rps = jst.num_metrics // shape[1]
    pool = np.asarray(jst._pool)
    for (s, m), r in res.items():
        what = f"rank {(s, m)} {key}"
        np.testing.assert_array_equal(r[f"{key}.arena"],
                                      pool[m * sp:(m + 1) * sp], what)
        np.testing.assert_array_equal(r[f"{key}.table"], jst.page_table, what)
        np.testing.assert_array_equal(r[f"{key}.codec"], jst.row_codec, what)
        np.testing.assert_array_equal(
            r[f"{key}.free"], [x for f in jst._free_lists for x in f], what)
        want = sorted((row, b, v) for (row, b), v in jst._host_spill.items()
                      if m * rps <= row < (m + 1) * rps)
        np.testing.assert_array_equal(
            r[f"{key}.spill"], np.array(want, np.int64).reshape(-1, 3), what)
        assert int(r[f"{key}.counters"][0]) == jst.allocated_pages, what


def _check_state(res, key, jagg):
    """Every rank's ``state_dict`` against the JAX store's whole state,
    the ``first_only`` form on rank (0, 0) alone, and the state loaded
    onto a fresh aggregator on the same mesh."""
    jst = jagg.paged
    names = ["" if n is None else n for n in jagg.registry.names()]
    spill = sorted((r, d, v) for (r, d), v in jst._host_spill.items())
    for coord, r in res.items():
        np.testing.assert_array_equal(r[f"{key}.state.pool"],
                                      np.asarray(jst._pool))
        np.testing.assert_array_equal(r[f"{key}.state.table"], jst.page_table)
        np.testing.assert_array_equal(r[f"{key}.state.codec"], jst.row_codec)
        np.testing.assert_array_equal(
            r[f"{key}.state.free"], [x for f in jst._free_lists for x in f])
        np.testing.assert_array_equal(
            r[f"{key}.state.free_n"], [len(f) for f in jst._free_lists])
        np.testing.assert_array_equal(
            r[f"{key}.state.spill"], np.array(spill, np.int64).reshape(-1, 3))
        assert r[f"{key}.state.names"].tolist()[:len(names)] == names
        assert int(r[f"{key}.first"]) == (1 if coord == (0, 0) else -1)


@pytest.mark.parametrize("shape", [R.PL_SAVER], ids=["2x2"])
def test_a_mesh_save_holds_the_whole_store(shape, ranks, shared, tmp_path):
    """The (2, 2) save: every rank's arena and host half equal the JAX
    mesh store's after the same commit (its arenas spill); the file's
    ``agg_acc`` is the JAX store's dense decode with its spill, each
    cell once (no stream sum), and ``pg_codec_names`` its codecs;
    ``state_dict`` on every rank is the JAX store's whole state and
    loads back onto the same mesh; rank (0, 0) hands the save's
    collectives nothing but the agreements, every other rank of stream
    index 0 its cells."""
    res = ranks(shape)
    d, inputs = shared
    jagg = _jax_agg(shape, R.PL_CK_POOL)
    try:
        for name in _names():
            jagg._id_for(name)
        jagg.paged.commit(inputs["pl.ck.packed"])
        _check_store(res, "cksrc", jagg.paged, shape)
        _check_state(res, "cksrc", jagg)
        _check_loaded(res, "cksrc.load", jagg.paged, shape)
        assert jagg.paged._host_spill  # the save holds spilled cells
        want_collect = jagg.collect(reset=False).metrics
    finally:
        jagg.close()
    want, codecs = _want(inputs)
    with np.load(d / "port_save.npz") as f:
        np.testing.assert_array_equal(f["agg_acc"], want)
        assert checkpoint._arr_names(f["pg_codec_names"]) == codecs
        assert f["mesh_shape"].tolist() == list(shape)
    for coord, r in res.items():
        _assert_same(R.get_metrics(r, "cksrc.load.collect"), want_collect)
        sent = int(r["cksrc.sent"])
        if coord == (0, 0):
            assert sent < 256  # the agreements' few int64s
        elif coord[0] == 0:
            assert sent > 32 * 100  # its block's cells, 32 B each


@pytest.mark.parametrize("shape", R.PL_SHAPES, ids=SHAPE_IDS)
def test_saves_restore_across_shapes_and_storages(shape, ranks, shared):
    """The (2, 2) port save, a JAX (2, 4) save and a dense one-device
    save restored onto this mesh: every rank's arena and host half equal
    the JAX store's on the same shape restoring the same file, the
    decoded pool is the source's, the codecs its codecs; ``state_dict``
    of the restored aggregator is the JAX store's and loads back."""
    res = ranks(shape)
    d, inputs = shared
    want, codecs = _want(inputs)
    for key, name in (("ckport", "port_save.npz"), ("ckjax", "jax_save.npz"),
                      ("ckdense", "dense_save.npz")):
        jagg = _jax_restored(shape, str(d / name))
        try:
            _check_store(res, key, jagg.paged, shape)
            if key == "ckport":
                _check_state(res, key, jagg)
                _check_loaded(res, f"{key}.load", jagg.paged, shape)
            want_collect = jagg.collect(reset=False).metrics
        finally:
            jagg.close()
        for r in res.values():
            np.testing.assert_array_equal(r[f"{key}.dense"][:len(want)],
                                          want, key)
            assert not r[f"{key}.dense"][len(want):].any()
            got = r[f"{key}.codecs"].tolist()
            assert all(g == c for g, c in zip(got, codecs)
                       if c is not None), key
            _assert_same(R.get_metrics(r, f"{key}.collect"), want_collect)


@pytest.mark.parametrize("shape", R.PL_SHAPES, ids=SHAPE_IDS)
def test_a_restore_past_the_headroom_takes_the_agreed_spill(shape, ranks,
                                                            shared):
    """One cell near 2^30 in row 40 (the second block of a two-way metric
    axis) before a restore: the pool's maximum is agreed over the mesh,
    so every rank puts the restored cells in the host spill (its own
    block's), as the JAX store does from its whole pool's maximum; the
    host halves stay equal."""
    res = ranks(shape)
    d, inputs = shared
    jagg = _jax_restored(shape, str(d / "port_save.npz"), big=True)
    try:
        _check_store(res, "ckbig", jagg.paged, shape)
        assert len(jagg.paged._host_spill) > 100
    finally:
        jagg.close()
    want, _ = _want(inputs)
    for r in res.values():
        dense = r["ckbig.dense"]
        assert int(dense[R.PL_BIG_ROW].sum()) >= R.PL_BIG
        dense[R.PL_BIG_ROW, R.PL_BL] -= R.PL_BIG
        np.testing.assert_array_equal(dense[:len(want)], want)


def test_port_files_restore_into_jax_and_onto_one_device(ranks, shared):
    """Every launch's save of its restored aggregator (a (2, 2), (2, 1)
    or (1, 2) file) restores into the JAX package on one device and onto
    the port on one device, paged and dense, each equal to the source's
    decoded pool."""
    for shape in R.PL_SHAPES:
        ranks(shape)
    d, inputs = shared
    want, _ = _want(inputs)
    files = ["port_save.npz"] + [f"port_{s}x{m}.npz" for s, m in R.PL_SHAPES]
    for name in files:
        path = str(d / name)
        jagg = _jax_restored(None, path)
        try:
            np.testing.assert_array_equal(
                jagg.paged.decode_dense()[:len(want)], want, name)
        finally:
            jagg.close()
        for storage in ("paged", "dense"):
            agg = TorchAggregator(
                num_metrics=R.PL_M, config=MetricConfig(bucket_limit=R.PL_BL),
                storage=storage,
                paged_config=PagedStoreConfig(pool_pages=R.PL_POOL),
                device="cpu")
            try:
                checkpoint.restore(path, aggregator=agg)
                got = (agg.paged.decode_dense() if storage == "paged"
                       else agg._acc.numpy().astype(np.int64) + (
                           0 if agg._spill is None else agg._spill))
                np.testing.assert_array_equal(got[:len(want)], want,
                                              (name, storage))
            finally:
                agg.close()


# -- the system: a crash on (2, 1), recovered on (1, 2) and on one device ----


def _jax_uncrashed(inputs):
    """The JAX system on one device taking every merged interval, with
    the eviction and the compaction where the crashed system made them,
    never crashing."""
    ms = TPUMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=R.PL_M, config=JAX_CFG,
        storage="paged", paged_config=JaxStoreConfig(pool_pages=R.PL_POOL),
        retention=R.PL_SYS_TIERS, commit="fused",
        lifecycle=JaxLifecycleConfig(check_every=1,
                                     auto_compact_fragmentation=0.0))
    _synchronised(ms.committer)

    def raws(lo, hi):
        return [_merged(inputs, "plsys", R.PL_CRASHER, i, R.pl_names(
            i, R.PL_SYS_BEFORE, R.PL_SYS_VICTIMS), seq=i + 1)
            for i in range(lo, hi)]

    ms.backfill_retention(raws(0, R.PL_SYS_BEFORE))
    ms.lifecycle.evict_ids([ms.aggregator.registry.lookup(f"p{v}")
                            for v in R.PL_SYS_VICTIMS])
    ms.lifecycle.compact()
    ms.backfill_retention(raws(R.PL_SYS_BEFORE,
                               R.PL_SYS_CRASH + R.PL_SYS_AFTER))
    return ms


def _served(ms):
    return {q: _flat_window(ms.query(pattern, window, np.array(R.MP_PS)))
            for q, (pattern, window) in enumerate(R.PL_SYS_QUERIES)}


def _check_recovered(res, key, ms, served):
    want = ms.aggregator.paged.decode_dense()
    want_collect = ms.aggregator.collect(reset=False).metrics
    for r in res.values():
        np.testing.assert_array_equal(r[f"{key}.dense"], want)
        for q, (w, wmeta) in served.items():
            _assert_served(R.get_metrics(r, f"{key}.q{q}"), w, q)
            np.testing.assert_array_equal(r[f"{key}.q{q}.meta"], wmeta)
        _assert_same(R.get_metrics(r, f"{key}.collect"), want_collect)


def test_a_crashed_paged_mesh_system_recovers_onto_another_shape(ranks,
                                                                 shared):
    """TorchMetricSystem(mesh=, storage="paged", lifecycle=, resilience=)
    on (2, 1) takes 4 intervals, evicts across shards and compacts by
    hand, takes 5 more (its checkpoint at 6, each row's journal written
    by its rank) and crashes; a system on (1, 2) recovers (its one row
    replays both saved rows' journals past the watermark, the merged
    interval rebuilt in the live one's order) and takes 2 more: the
    decoded pool, the served queries and the collected set equal the
    uncrashed JAX system's, and the two ranks' host halves agree."""
    crashed = ranks(R.PL_CRASHER)
    res = ranks((1, 2))
    for r in crashed.values():
        assert int(r["crash.committed"]) == R.PL_SYS_CRASH
        assert r["crash.checkpoints"].tolist() == [
            1, R.PL_SYS_EVERY, R.PL_SYS_CRASH]
        assert r["crash.evicted"].tolist() == [
            f"p{v}" for v in R.PL_SYS_VICTIMS]
        assert bool(r["crash.compacted"])
        assert r["crash.files"].tolist() == [
            f"jl.log.row{j}of{R.PL_CRASHER[0]}"
            for j in range(R.PL_CRASHER[0])]
    ms = _jax_uncrashed(shared[1])
    try:
        _check_recovered(res, "recover", ms, _served(ms))
    finally:
        ms.stop()
    for r in res.values():
        assert r["recover.report"].tolist() == [
            R.PL_SYS_EVERY, R.PL_SYS_CRASH - R.PL_SYS_EVERY,
            R.PL_SYS_EVERY * R.PL_CRASHER[0], 1, 1]
    a, b = (res[(0, m)] for m in range(2))
    for part in ("table", "codec", "free", "free_n", "counters"):
        np.testing.assert_array_equal(a[f"recover.{part}"],
                                      b[f"recover.{part}"], part)


def test_one_device_recovers_a_paged_mesh_crash(ranks, shared, tmp_path):
    """The (2, 1) crash's checkpoint and rows' journals, as the crash left
    them, recover one device with no mesh (both rows merged as row 0 of
    1): the decoded pool, the served queries and the collected set equal
    the uncrashed JAX system's."""
    ranks(R.PL_CRASHER)
    d, inputs = shared
    for f in os.listdir(d / "crash"):
        shutil.copy(d / "crash" / f, tmp_path)
    ms = R._pl_system(None, str(tmp_path / "ck.npz"),
                      str(tmp_path / "jl.log"))
    jms = _jax_uncrashed(inputs)
    try:
        rep = ms.recover()
        assert (rep.watermark, rep.replayed_intervals) == (
            R.PL_SYS_EVERY, R.PL_SYS_CRASH - R.PL_SYS_EVERY)
        out = {}
        R.pl_recovered(ms, inputs, range(R.PL_CRASHER[0]), out, "one")
        _check_recovered({(0, 0): out}, "one", jms, _served(jms))
    finally:
        ms.recovery.checkpoint_path = None
        ms.stop()
        jms.stop()
