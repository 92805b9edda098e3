"""Paged storage on the port's mesh (ROADMAP Queue 1 item 11c-1, decision
D12): ``PagedStore(mesh=)``, ``TorchAggregator(mesh=, storage="paged")``
on the raw (K4f) and sparse (K4) transports, ``IntervalCommitter`` with
``TimeWheel(mesh=)`` on paged storage and ``TorchMetricSystem(mesh=,
storage="paged", retention=)``, against the JAX package's mesh store and
its sharded paged programs (the counterpart of
``tests/test_mesh_paged.py``), at its sizes: M = 64, ``bucket_limit`` 128,
``pool_pages`` 256 (the committer and the system: ``bucket_limit`` 512,
one dense page a row, so first-touch cells choose among all three
codecs).

Meshes (2, 1), (1, 2) and (2, 2) launch their ranks once each
(``test_torch_ranks.launch``: gloo, a ``FileStore`` in ``tmp_path``, the
``mesh_paged:SxM`` job; every collective on a rank's main thread, or the
launch fails).  Rank (s, m) is fed stream row s's share of each input;
the JAX side takes the global input (the rows' shares in stream order,
the merged intervals) on ``make_mesh(stream=s, metric=m)`` over the
conftest's 8 virtual CPU devices.  The (2, 2) launch also makes a (1, 4)
mesh of its four ranks, which loads a JAX (2, 4) store's state.

Tolerances:
  * every arena against the JAX pool's block of its shard, page tables,
    codecs, free lists, allocation and spill counters, each rank's
    spilled cells against the JAX spill's cells of its block, rings,
    decoded pools, counts: EQUAL;
  * the collected sets: ``test_torch_aggregator._assert_same``; served
    window statistics: ``test_torch_mesh_commit._assert_served``;
  * the pool's snapshot query (``PagedStore.query``): counts EQUAL, sums
    rtol 1e-5 atol 1e-4 (float32 sums of mixed-sign terms in another
    order), percentiles rtol 4e-6 (XLA's float32 ``exp``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from loghisto_tpu.commit import IntervalCommitter as JaxCommitter
from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.metrics import MetricSystem as JaxMetricSystem
from loghisto_tpu.metrics import RawMetricSet as JaxRawMetricSet
from loghisto_tpu.obs.health import HealthWatchdog as JaxWatchdog
from loghisto_tpu.ops.codec import compress_np
from loghisto_tpu.ops.ingest import bucket_indices as jax_bucket_indices
from loghisto_tpu.paging import PagedStore as JaxStore
from loghisto_tpu.paging import PagedStoreConfig as JaxStoreConfig
from loghisto_tpu.parallel.aggregator import TPUAggregator
from loghisto_tpu.parallel.mesh import make_mesh as jax_make_mesh
from loghisto_tpu.system import TPUMetricSystem
from loghisto_tpu.window import TimeWheel as JaxWheel
from loghisto_tpu_torch.ops import dispatch

import test_torch_ranks as R
from test_torch_aggregator import _assert_same
from test_torch_mesh_commit import _assert_served, _flat_window, \
    _synchronised

SHAPE_IDS = [f"{s}x{m}" for s, m in R.MP_SHAPES]
LOGLINEAR, POLYTAIL = 1, 2


def _agreeing(rng, n, bl):
    """n float32 values on which the JAX float32 device codec and the
    port's float64 codec agree (ROADMAP F1)."""
    v = (rng.lognormal(0.5, 1.2, 2 * n) * np.where(
        rng.random(2 * n) < 0.1, -1.0, 1.0)).astype(np.float32)
    jax_idx = np.asarray(jax_bucket_indices(jnp.asarray(v), bl)) - bl
    keep = jax_idx == np.clip(compress_np(v), -bl, bl)
    return v[keep][:n]


def _packed(rng, n, m=R.MP_M, bl=R.MP_BL):
    out = np.empty((n, 3), np.int32)
    out[:, 0] = rng.integers(0, m, n)
    out[:, 1] = rng.integers(-bl, bl + 1, n)
    out[:, 2] = rng.integers(1, 50, n)
    return out


def _cells(rng, n, lo, hi, counts=40):
    out = np.empty((n, 3), np.int64)
    out[:, 0] = rng.integers(0, R.MP_M, n)
    out[:, 1] = rng.integers(lo, hi, n)
    out[:, 2] = rng.integers(1, counts, n)
    return out


def _commit_cells(rng, i, s):
    """Interval i of stream row s: cells over the whole bucket axis past
    the body (small below zero, so float32 sums stay well conditioned),
    and in interval 0 the codec-flip row: its two tail buckets are in
    both rows, so counted once they make 2 of 5 first-touch buckets
    (loglinear) and counted twice 4 of 7 (polytail)."""
    cells = _cells(rng, int(rng.integers(40, 60)), -200, 460)
    cells = cells[cells[:, 0] != R.MP_FLIP_ROW]
    if i == 0:
        flip = [(300, 3), (310, 2), (5, 7)] if s == 0 else \
            [(300, 1), (310, 4), (10, 2), (20, 5)]
        cells = np.concatenate([np.array(
            [(R.MP_FLIP_ROW, b, c) for b, c in flip], np.int64), cells])
    return cells


def _jax_state_store(rng_packed):
    jst = JaxStore(R.MP_M, R.MP_BL, config=JaxStoreConfig(
        pool_pages=R.MP_POOL), mesh=jax_make_mesh(stream=2, metric=4))
    jst.commit(rng_packed)
    return jst


def _make_inputs():
    rng = np.random.default_rng(24)
    d = {"mp.packed": _packed(rng, 5000)}
    for k in range(2):
        d[f"mp.raw.{k}.values"] = _agreeing(rng, 3000, R.MP_BL)
        d[f"mp.raw.{k}.ids"] = rng.integers(-1, R.MP_M + 1, 3000).astype(
            np.int32)
    d["mp.g.packed"] = _packed(rng, 3000, m=32)
    d["mp.g.packed2"] = _packed(rng, 3000, m=64)
    d["mp.g.perm"] = rng.permutation(64).astype(np.int64)
    for i in range(2):
        for k in range(R.MP_BATCHES):
            for s in range(R.MP_STREAM_ROWS):
                d[f"mp.agg.{i}.{k}.{s}.ids"] = (
                    (rng.zipf(1.3, R.MP_BATCH) - 1) % (R.MP_M + 2) - 1
                ).astype(np.int32)
                d[f"mp.agg.{i}.{k}.{s}.values"] = _agreeing(
                    rng, R.MP_BATCH, R.MP_BL)
    for s in range(R.MP_STREAM_ROWS):
        d[f"mp.cells.{s}"] = _cells(rng, 40, -R.MP_BL, R.MP_BL + 1, 50)
        d[f"mp.packed.{s}"] = _packed(rng, 30)
        n = R.MP_CONSERVE * R.MP_CONSERVE_BATCH
        d[f"mp.cons.{s}.ids"] = rng.integers(0, R.MP_M, n).astype(np.int32)
        d[f"mp.cons.{s}.values"] = rng.lognormal(0.0, 1.0, n).astype(
            np.float32)
        d[f"mp.sys.{s}.ids"] = rng.integers(0, R.MP_M, 2000).astype(np.int32)
        d[f"mp.sys.{s}.values"] = _agreeing(rng, 2000, R.MP_C_BL)
        for i in range(R.MP_C_INTERVALS):
            d[f"mp.c.{i}.{s}"] = _commit_cells(rng, i, s)
    d["mp.js.packed"] = _packed(rng, 4000)
    js = _jax_state_store(d["mp.js.packed"])
    frees = js._free_lists
    d.update({
        "mp.js.pool": np.asarray(js._pool), "mp.js.table": js.page_table,
        "mp.js.codec": js.row_codec,
        "mp.js.free": np.array([x for f in frees for x in f], np.int64),
        "mp.js.free_n": np.array([len(f) for f in frees], np.int64),
        "mp.js.spill": np.array(sorted(
            (r, b, v) for (r, b), v in js._host_spill.items()),
            np.int64).reshape(-1, 3),
        "mp.js.allocated": np.array(js.allocated_pages),
    })
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
            results = R.launch(tmp_path_factory.mktemp(f"mp{s}x{m}"), s * m,
                               f"mesh_paged:{s}x{m}", inputs)
            cache[shape] = {tuple(r["coord"].tolist()): r for r in results}
        return cache[shape]

    return get


def _jax_mesh(shape):
    return jax_make_mesh(stream=shape[0], metric=shape[1])


def _check_store(res, key, jst, shape, spill=True):
    """Every rank's arena against the JAX pool's block of its shard, and
    the host half against the JAX store's."""
    pool = np.asarray(jst._pool)
    sp = jst.shard_pages
    rps = jst.num_metrics // shape[1]
    for (s, m), r in res.items():
        what = f"rank {(s, m)} {key}"
        np.testing.assert_array_equal(r[f"{key}.arena"],
                                      pool[m * sp:(m + 1) * sp], what)
        np.testing.assert_array_equal(r[f"{key}.table"], jst.page_table, what)
        np.testing.assert_array_equal(r[f"{key}.codec"], jst.row_codec, what)
        np.testing.assert_array_equal(
            r[f"{key}.free"], [x for f in jst._free_lists for x in f], what)
        np.testing.assert_array_equal(
            r[f"{key}.free_n"], [len(f) for f in jst._free_lists], what)
        if spill:
            want = sorted((row, b, v) for (row, b), v in
                          jst._host_spill.items()
                          if m * rps <= row < (m + 1) * rps)
            np.testing.assert_array_equal(
                r[f"{key}.spill"], np.array(want, np.int64).reshape(-1, 3),
                what)
        np.testing.assert_array_equal(r[f"{key}.counters"], [
            jst.allocated_pages, jst.spilled_cells, jst.overflowed_cells,
            jst.free_pages, jst.occupied_pages,
            # the rank's footprint: its arena and its block's table
            sp * jst.config.page_size * 4 + rps * jst.pages_per_row * 4,
            rps, jst.num_metrics, jst.total_pages], what)
        np.testing.assert_array_equal(
            r[f"{key}.occ"], jst.shard_occupancy() + [jst.pool_saturation()],
            what)


# -- the store ---------------------------------------------------------------


@pytest.mark.parametrize("shape", R.MP_SHAPES, ids=SHAPE_IDS)
def test_store_commit_and_spill_equal_the_jax_mesh_store(shape, ranks,
                                                         inputs):
    res = ranks(shape)
    mesh = _jax_mesh(shape)
    for key, pool, kw in (("store", R.MP_POOL, {}),
                          ("sat", R.MP_SAT_POOL, {}),
                          ("ov", R.MP_SAT_POOL, {"overflow_row": R.MP_M - 1})):
        jst = JaxStore(R.MP_M, R.MP_BL, config=JaxStoreConfig(
            pool_pages=pool, **kw), mesh=mesh)
        applied = jst.commit(inputs["mp.packed"])
        _check_store(res, key, jst, shape)
        dense = jst.decode_dense()
        for r in res.values():
            assert int(r[f"{key}.applied"]) == applied
            np.testing.assert_array_equal(r[f"{key}.dense"], dense)
        occ = jst.shard_occupancy()
        assert len(occ) == shape[1]
        assert jst.pool_saturation() == max(occ)
    # the saturated arenas spilled (no overflow row) or redirected, and
    # the ranks of each metric column hold their block's spilled cells
    assert jst.overflowed_cells > 0
    spilled = {m: len(r["sat.spill"]) for (_, m), r in res.items()}
    assert sum(spilled.values()) >= len(spilled) > 0
    assert all(int(r["sat.counters"][1]) > 0 for r in res.values())


@pytest.mark.parametrize("shape", R.MP_SHAPES, ids=SHAPE_IDS)
def test_store_raw_route_is_k4f_per_rank(shape, ranks, inputs):
    res = ranks(shape)
    jst = JaxStore(R.MP_M, R.MP_BL, config=JaxStoreConfig(
        pool_pages=R.MP_POOL), mesh=_jax_mesh(shape))
    for k in range(2):
        ids, spilled = jst.prepare_batch(inputs[f"mp.raw.{k}.ids"],
                                         inputs[f"mp.raw.{k}.values"])
        for r in res.values():
            np.testing.assert_array_equal(r[f"raw.{k}.ids"], ids)
            assert int(r[f"raw.{k}.spilled"]) == spilled
        jst.ingest_raw(jnp.asarray(ids),
                       jnp.asarray(inputs[f"mp.raw.{k}.values"]))
    _check_store(res, "raw", jst, shape)


@pytest.mark.parametrize("shape", R.MP_SHAPES, ids=SHAPE_IDS)
def test_growth_and_a_cross_shard_permutation_migrate_rows(shape, ranks,
                                                           inputs):
    """JAX ``tests/test_mesh_paged.py:173-213``: growth redraws the
    shard blocks and a full shuffle moves rows between arenas; every
    rank's arena and host half equal the JAX store's after each step."""
    res = ranks(shape)
    jst = JaxStore(32, R.MP_BL, config=JaxStoreConfig(pool_pages=128),
                   mesh=_jax_mesh(shape))
    jst.commit(inputs["mp.g.packed"])
    _check_store(res, "g0", jst, shape)
    before = jst.decode_dense()
    jst.grow(64)
    _check_store(res, "g1", jst, shape)
    np.testing.assert_array_equal(jst.decode_dense()[:32], before)
    jst.commit(inputs["mp.g.packed2"])
    _check_store(res, "g2", jst, shape)
    dense = jst.decode_dense()
    perm = inputs["mp.g.perm"]
    jst.apply_permutation(perm.tolist(), 64)
    _check_store(res, "g3", jst, shape)
    np.testing.assert_array_equal(jst.decode_dense(), dense[perm])
    q = jst.query(perm, np.array(R.MP_PS))
    for r in res.values():
        np.testing.assert_array_equal(r["g1.dense"][:32], before)
        np.testing.assert_array_equal(r["g3.dense"], dense[perm])
        got = r["g3.query"]
        np.testing.assert_array_equal(got[:, 0], q["counts"])
        # float32 sums of mixed-sign terms, summed in another order
        np.testing.assert_allclose(got[:, 1], q["sums"], rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(got[:, 2:], q["percentiles"], rtol=4e-6)


# -- the aggregator ----------------------------------------------------------


def _jax_agg(shape, transport, batch_size=1 << 14, pool=R.MP_POOL):
    agg = TPUAggregator(
        num_metrics=R.MP_M, config=JaxConfig(bucket_limit=R.MP_BL),
        storage="paged", paged_config=JaxStoreConfig(pool_pages=pool),
        transport=transport, batch_size=batch_size, max_metrics=R.MP_M,
        ingest_path="fused" if transport == "raw" else "auto",
        mesh=_jax_mesh(shape))
    for name in R.mp_names():
        agg.registry.id_for(name)
    return agg


def _raw_cells(cells):
    """The cells a port rank's ``merge_raw`` of ``raw_from_cells(cells)``
    stages (id, bucket, count), in the raw set's order."""
    raw = R.raw_from_cells(cells, JaxRawMetricSet, R.mp_names())
    return np.array([(int(name[1:]), b, c) for name, h in
                     raw.histograms.items() for b, c in h.items()], np.int32)


@pytest.mark.parametrize("transport", ["raw", "sparse"])
@pytest.mark.parametrize("shape", R.MP_SHAPES, ids=SHAPE_IDS)
def test_aggregator_equals_the_jax_mesh_aggregator(shape, transport, ranks,
                                                   inputs):
    """The rows' shares of each global batch: the ranks' collected sets
    equal the JAX aggregator's over the global batches, and after the
    first interval every arena and the host half equal its store's."""
    res = ranks(shape)
    agg = _jax_agg(shape, transport)
    key = f"agg.{transport}"
    try:
        for i in range(2):
            for k in range(R.MP_BATCHES):
                agg.record_batch(*(np.concatenate([
                    inputs[f"mp.agg.{i}.{k}.{s}.{part}"]
                    for s in range(shape[0])]) for part in ("ids", "values")))
                agg.flush(force=True)
            if i and transport == "sparse":
                for part in ("cells", "packed"):
                    agg.merge_packed(np.concatenate([
                        _raw_cells(inputs[f"mp.cells.{s}"]) if part == "cells"
                        else inputs[f"mp.packed.{s}"]
                        for s in range(shape[0])]), wait=True)
            want = agg.collect(reset=not i).metrics
            for r in res.values():
                _assert_same(R.get_metrics(r, f"{key}.{i}"), want)
            if not i:
                _check_store(res, f"{key}.{i}", agg.paged, shape)
    finally:
        agg.close()
    for r in res.values():
        assert r[f"{key}.path"].tolist() == [
            "fused_paged" if transport == "raw" else "packed", transport,
            "paged"]
        assert int(r[f"{key}.shed"]) == 0


@pytest.mark.parametrize("shape", R.MP_SHAPES, ids=SHAPE_IDS)
def test_deferred_batches_are_not_shed(shape, ranks, inputs):
    """40 batches between two collect() calls, past the 32-batch bound of
    the host buffer: the stage holds every one, and the collected counts
    are every sample of every stream row."""
    res = ranks(shape)
    ids = np.concatenate([inputs[f"mp.cons.{s}.ids"]
                          for s in range(shape[0])])
    for r in res.values():
        assert int(r["cons.staged"]) == R.MP_CONSERVE * R.MP_CONSERVE_BATCH
        assert int(r["cons.staged"]) > int(r["cons.bound"])
        assert int(r["cons.shed"]) == 0
        got = R.get_metrics(r, "cons")
        for k, name in enumerate(R.mp_names()):
            assert got.get(f"{name}_count", 0.0) == int((ids == k).sum())


@pytest.mark.parametrize("shape", R.MP_SHAPES, ids=SHAPE_IDS)
def test_the_stage_refuses_past_its_cap_and_sheds_nothing(shape, ranks,
                                                         inputs):
    """D12's bound: with ``max_staged_samples`` at 3 batches the fourth
    ``record_batch`` raises, ``tpu.MeshStagedSamples`` and the
    ``stage_backlog`` reason see the full stage, collect() counts every
    accepted sample of every stream row, and the landed stage takes
    batches again."""
    res = ranks(shape)
    n = R.MP_STAGE_CAP * R.MP_CONSERVE_BATCH
    ids = np.concatenate([inputs[f"mp.cons.{s}.ids"][:n]
                          for s in range(shape[0])])
    for r in res.values():
        assert int(r["cap.accepted"]) == n
        assert "max_staged_samples" in str(r["cap.refused"])
        assert int(r["cap.staged"]) == n
        assert float(r["cap.gauge"]) == n
        assert "stage_backlog" in str(r["cap.codes"]).split(",")
        got = R.get_metrics(r, "cap")
        for k, name in enumerate(R.mp_names()):
            assert got.get(f"{name}_count", 0.0) == int((ids == k).sum())
        staged, codes = r["cap.after"].tolist()
        assert int(staged) == 0 and "stage_backlog" not in codes
        assert int(r["cap.again"]) == R.MP_CONSERVE_BATCH


@pytest.mark.parametrize("shape", R.MP_SHAPES, ids=SHAPE_IDS)
def test_a_failed_k4f_raises_and_folds_nothing_on_the_host(shape, ranks):
    """A K4f chunk that fails while the stage lands raises from collect()
    on every rank; the batch's rest is not encoded and folded on the host
    (no spilled sample, no spill cell), and the chunk before it landed."""
    for r in ranks(shape).values():
        assert "K4f failed on a paged mesh rank" in str(r["k4f.raised"])
        assert r["k4f.host"].tolist() == [0, 0, 0, 1]


# -- the committer and the system --------------------------------------------


def _jax_pipeline(shape, pool):
    cfg = JaxConfig(bucket_limit=R.MP_C_BL)
    mesh = _jax_mesh(shape)
    agg = TPUAggregator(
        num_metrics=R.MP_M, config=cfg, storage="paged",
        paged_config=R.mp_paged_config(JaxStoreConfig, pool),
        max_metrics=R.MP_M, mesh=mesh)
    wheel = JaxWheel(num_metrics=R.MP_M, config=cfg, interval=1.0,
                     tiers=R.MP_C_TIERS, registry=agg.registry, mesh=mesh)
    return agg, wheel, _synchronised(JaxCommitter(agg, wheel,
                                                  chunk=R.MP_C_CHUNK))


def _merged(inputs, shape, i):
    return R.mp_raw(JaxRawMetricSet,
                    [(s, inputs[f"mp.c.{i}.{s}"]) for s in range(shape[0])], i)


def _check_rings(res, key, wheel, n_metric):
    for (s, m), r in res.items():
        for t, tier in enumerate(wheel._tiers):
            ring = np.asarray(tier.ring)
            rows = ring.shape[1] // n_metric
            np.testing.assert_array_equal(
                r[f"{key}.ring{t}"], ring[:, m * rows:(m + 1) * rows],
                f"rank {(s, m)} {key} tier {t}")
            np.testing.assert_array_equal(r[f"{key}.state{t}"], [
                tier.slot, tier.in_slot, *tier.written.astype(int)])


@pytest.mark.parametrize("shape", R.MP_SHAPES, ids=SHAPE_IDS)
def test_committer_pipeline_equals_the_jax_sharded_paged_commit(
        shape, ranks, inputs):
    """JAX ``tests/test_mesh_paged.py:104-137`` on the port's ranks: the
    merged intervals (each longer than the commit chunk), the codec-flip
    row, and a saturated arena that spills to the host."""
    res = ranks(shape)
    for key, pool in (("commit", R.MP_C_POOL), ("csat", R.MP_C_SAT_POOL)):
        agg, wheel, com = _jax_pipeline(shape, pool)
        try:
            modes = [com.commit(_merged(inputs, shape, i))
                     for i in range(R.MP_C_INTERVALS)]
            _check_rings(res, key, wheel, shape[1])
            _check_store(res, key, agg.paged, shape)
            want = agg.collect(reset=False).metrics
            for r in res.values():
                assert r[f"{key}.modes"].tolist() == modes
                assert all(int(n) > 1 for n in r[f"{key}.steps"])
                _assert_same(R.get_metrics(r, f"{key}.collect"), want)
        finally:
            agg.close()
        assert modes == ["fused"] * R.MP_C_INTERVALS
        # the flip row's first-touch cells were counted once: loglinear
        # from both rows' cells, polytail from row 0's alone
        assert int(agg.paged.row_codec[R.MP_FLIP_ROW]) == (
            LOGLINEAR if shape[0] > 1 else POLYTAIL)
        if key == "csat":
            assert agg.paged.spilled_cells > 0 and agg.paged._host_spill
        else:
            # dense and polytail rows beside the flip row's
            assert set(agg.paged.row_codec.tolist()) >= {0, 2}


@pytest.mark.parametrize("shape", R.MP_SHAPES, ids=SHAPE_IDS)
def test_system_on_a_paged_mesh_equals_the_jax_system(shape, ranks, inputs):
    res = ranks(shape)
    ms = TPUMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=R.MP_M,
        config=JaxConfig(bucket_limit=R.MP_C_BL), storage="paged",
        paged_config=R.mp_paged_config(JaxStoreConfig, R.MP_C_POOL),
        retention=R.MP_C_TIERS, mesh=_jax_mesh(shape), commit="fused")
    _synchronised(ms.committer)
    try:
        for name in R.mp_names():
            ms.metric_id(name)
        ms.backfill_retention([_merged(inputs, shape, i)
                               for i in range(R.MP_C_INTERVALS)])
        ms.record_batch(*(np.concatenate([inputs[f"mp.sys.{s}.{part}"]
                                          for s in range(shape[0])])
                          for part in ("ids", "values")))
        served = {q: _flat_window(ms.query(pattern, window, R.MP_PS))
                  for q, (pattern, window) in enumerate(R.MP_C_QUERIES)}
        _check_rings(res, "system", ms.retention, shape[1])
        want = ms.device_metrics(reset=False).metrics
        _check_store(res, "system", ms.aggregator.paged, shape)
    finally:
        ms.stop()
    for r in res.values():
        assert r["system.path"].tolist() == ["fused", "paged"]
        assert int(r["system.staged"]) == 0  # the query landed them
        for q, (w, wmeta) in served.items():
            _assert_served(R.get_metrics(r, f"system.q{q}"), w, q)
            np.testing.assert_array_equal(r[f"system.q{q}.meta"], wmeta)
        _assert_same(R.get_metrics(r, "system.collect"), want)


# -- the watchdog, the gauges, the dispatch table, the refusals, the state ---


class _JaxCom:
    fanout_intervals = bridge_evictions = intervals_committed = 0


class _JaxAgg:
    max_pending_samples = 100
    pending_samples = _xfer_queued_samples = 0
    _device_down_until = 0.0

    def __init__(self, paged):
        self.paged = paged


@pytest.mark.parametrize("shape", R.MP_SHAPES, ids=SHAPE_IDS)
def test_watchdog_and_gauges_name_every_shard(shape, ranks, inputs):
    """JAX ``tests/test_mesh_paged.py:288-353``: the pool_saturation
    detail names the hottest shard, a release clears it, and the paging
    gauges cover every shard arena."""
    res = ranks(shape)
    mesh = _jax_mesh(shape)
    jst = JaxStore(R.MP_M, R.MP_BL, config=JaxStoreConfig(pool_pages=128),
                   mesh=mesh)
    jst.commit(inputs["mp.packed"])
    sat = jst.pool_saturation()
    wd = JaxWatchdog(_JaxCom(), _JaxAgg(jst), interval=0.05,
                     pool_saturation_fraction=max(sat - 0.01, 0.0))
    wd.note_commit(1)
    (detail,) = [r["detail"] for r in wd.report().reasons
                 if r["code"] == "pool_saturation"]
    ms = JaxMetricSystem(interval=0.05, sys_stats=False)
    agg = TPUAggregator(
        num_metrics=R.MP_M, config=JaxConfig(bucket_limit=R.MP_BL),
        storage="paged", paged_config=JaxStoreConfig(pool_pages=R.MP_POOL),
        mesh=mesh)
    agg.paged.commit(inputs["mp.g.packed"])
    agg.register_device_gauges(ms)
    gauges = ms.collect_raw_metrics().gauges
    agg.close()
    names = sorted(g for g in gauges if g.startswith(("paging.",
                                                      "tpu.Paged")))
    for k in range(shape[1]):
        assert f"paging.Shard{k}Occupancy" in names
    # the rank's footprint and wire are its arena's
    rank_only = ("tpu.PagedHbmBytes", "tpu.PagedLastCommitH2DBytes")
    for r in res.values():
        assert r["health.codes"].tolist()[0].split(",").count(
            "pool_saturation") == 0
        assert "pool_saturation" in r["health.codes"].tolist()[1]
        assert r["health.detail"].tolist() == [detail]
        assert "pool_saturation" not in str(r["health.released"])
        assert r["gauges.names"].tolist() == names
        got = dict(zip([g for g in names if g != "paging.PageAllocRate"],
                       r["gauges.values"].tolist()))
        for g, v in got.items():
            if g not in rank_only:
                assert v == gauges[g], g


class _StubMesh:
    """A mesh's shape without its ranks: what the dispatch table reads."""

    mesh_dim_names = ("stream", "metric")

    def __init__(self, stream, metric):
        self._shape = (stream, metric)

    def size(self, dim):
        return self._shape[dim]


def test_resolve_full_path_admits_paged_routes_on_a_capable_mesh():
    """JAX ``tests/test_mesh_paged.py:356-375`` with the port's platform
    ("cuda" where the reference names "tpu")."""
    fp = dispatch.resolve_full_path(1 << 20, 8193, "cuda",
                                    batch_size=1 << 20,
                                    mesh=_StubMesh(2, 4))
    assert (fp.storage, fp.ingest, fp.transport, fp.commit) == (
        "paged", "fused_paged", "raw", "fused")
    assert "storage:paged" not in fp.reasons
    assert "ingest:fused_paged" not in fp.reasons
    # an uneven row split keeps the reference's mesh-shape sentence
    fp = dispatch.resolve_full_path((1 << 20) + 2, 8193, "cuda",
                                    batch_size=1 << 20,
                                    mesh=_StubMesh(2, 4))
    assert fp.storage == "dense"
    assert "mesh shape:" in fp.reasons["storage:paged"]


@pytest.mark.parametrize("shape", R.MP_SHAPES, ids=SHAPE_IDS)
def test_lifecycle_checkpoints_and_resilience_build_on_a_paged_mesh(
        shape, ranks):
    """ROADMAP D13: what a paged mesh refused before builds and runs on
    every rank (a LifecycleManager, ``state_dict``, a save, systems with
    ``lifecycle=`` and ``resilience=`` built and stopped); ``anomaly=``
    keeps the reference's dense-only refusal."""
    for coord, r in ranks(shape).items():
        for key in ("lifecycle", "state", "save", "sys_lifecycle",
                    "sys_resilience"):
            assert str(r[f"lifted.{key}"]) == "", key
        assert str(r["lifted.state_storage"]) == "paged"
        # rank (0, 0) alone writes a save (each rank's directory is its own)
        assert bool(r["lifted.saved"]) == (coord == (0, 0))
        assert r["lifted.built"].tolist() == ["paged", "paged"]
        assert "drift engine requires the dense accumulator" in str(
            r["lifted.sys_anomaly"])


def test_a_jax_mesh_store_state_loads_on_every_rank(ranks, inputs):
    """``paged_state_from_jax`` of a JAX (2, 4) store onto the port's
    (1, 4) mesh: each rank's arena is the JAX pool's block, its host half
    the JAX store's, and after the same commit both still are."""
    res = ranks((2, 2))
    jst = _jax_state_store(inputs["mp.js.packed"])
    four = {tuple(r["coord.four"].tolist()): r for r in res.values()}
    assert sorted(four) == [(0, m) for m in range(4)]
    _check_store(four, "state.0", jst, (1, 4))
    jst.commit(inputs["mp.packed"])
    _check_store(four, "state.1", jst, (1, 4))
    want = TPUAggregator(
        num_metrics=R.MP_M, config=JaxConfig(bucket_limit=R.MP_BL),
        storage="paged", paged_config=JaxStoreConfig(pool_pages=R.MP_POOL))
    try:
        for name in R.mp_names():
            want.registry.id_for(name)
        want.paged.commit(inputs["mp.js.packed"])
        want.paged.commit(inputs["mp.packed"])
        got = want.collect(reset=False).metrics
    finally:
        want.close()
    for r in four.values():
        _assert_same(R.get_metrics(r, "state"), got)
