"""The port's mesh (``loghisto_tpu_torch.parallel``: ``make_mesh``, the
three step factories and ``TorchAggregator(mesh=)`` on dense storage)
against the JAX package's (the counterpart of ``tests/test_mesh.py`` and
``test_mesh_scale.py``'s interval test, at M = 16 and ``bucket_limit``
256).

Each mesh shape (2,1), (1,2), (2,2), (4,1) and (1,4) launches its ranks
once for every scenario of this module (``test_torch_ranks.launch``:
fresh interpreters under gloo, a ``FileStore`` rendezvous and ``.npz``
results in ``tmp_path``); the JAX side runs here, on the conftest's 8
virtual CPU devices, with ``make_mesh(stream=s, metric=m)`` over the same
stream.  Rank (s, m) receives stream row s's slice of each batch:

  * every rank's int32 block EQUALS the rows of the JAX mesh accumulator
    at its position, after each per-batch step (accumulation across
    steps), for "auto" (K1 per rank; K2b for a one-row block), "scatter",
    "sort" and "hybrid" (all equal);
  * the interval step, with ``collect.start`` in flight while the next
    batch folds, gives the per-batch step's block and one device's;
  * ``TorchAggregator(mesh=)`` on the raw and sparse transports (with a
    ``merge_raw`` and a ``merge_packed`` interval): every rank returns
    the same ``ProcessedMetricSet``, equal to JAX ``TPUAggregator(mesh=,
    storage="dense")`` fed the whole stream (counts EQUAL, percentiles
    rtol 4e-6 on codec-agreeing values, ROADMAP F1), and the partials of
    each metric column sum to the JAX accumulator's rows.  The rows are
    fed in pieces of different sizes through a 1024-sample batch, so the
    transfer workers of different ranks flush different items; the
    ranks' collective guard proves no worker made a collective;
  * a tiny ``spill_threshold`` (each rank spills at its share) keeps the
    global counts exact, through the int64 host spill summed at collect;
  * growth: names past the rows grow every rank's registry at once and
    the blocks at the next ``collect()`` (8 -> 16 -> 32 rows, rows moving
    between ranks), equal to the JAX mesh aggregator's growth;
  * the refusals: an M the metric axis does not divide, a mesh larger
    than the world, multirow; paged storage, explicit or resolved by
    "auto", constructs since 11c-1 (ROADMAP D12); the state on a mesh
    round-trips since 11b-3 (ROADMAP D11); the fused commit of a pair
    on one mesh lands an interval (11b-1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.metrics import RawMetricSet as JaxRawMetricSet
from loghisto_tpu.ops.codec import compress_np
from loghisto_tpu.ops.ingest import bucket_indices as jax_bucket_indices
from loghisto_tpu.parallel.aggregator import (
    TPUAggregator,
    make_distributed_step as jax_distributed_step,
    make_sharded_accumulator as jax_sharded_accumulator,
)
from loghisto_tpu.parallel.mesh import make_mesh as jax_make_mesh
from loghisto_tpu_torch.ops.ingest import ingest_batch

import test_torch_ranks as R
from test_torch_aggregator import _assert_same

SHAPE_IDS = [f"{s}x{m}" for s, m in R.SHAPES]


def _agreeing(rng, n):
    """n float32 values on which the JAX float32 device codec and the
    port's float64 codec agree (ROADMAP F1)."""
    bl = R.MESH_BL
    v = (rng.lognormal(0.5, 1.2, 2 * n) * np.where(
        rng.random(2 * n) < 0.1, -1.0, 1.0)).astype(np.float32)
    jax_idx = np.asarray(jax_bucket_indices(jnp.asarray(v), bl)) - bl
    keep = jax_idx == np.clip(compress_np(v), -bl, bl)
    return v[keep][:n]


def _make_inputs():
    rng = np.random.default_rng(20)
    d = {}
    d["step.ids"] = ((rng.zipf(1.5, (R.STEPS, R.STEP_N)) - 1)
                     % R.MESH_M).astype(np.int32)
    d["step.values"] = _agreeing(rng, R.STEPS * R.STEP_N).reshape(
        R.STEPS, R.STEP_N)
    for i in range(R.AGG_INTERVALS):
        for s in range(4):
            n = R.agg_rows(s, i)
            d[f"agg.{i}.{s}.ids"] = rng.integers(
                -1, R.MESH_M + 1, n).astype(np.int32)
            d[f"agg.{i}.{s}.values"] = _agreeing(rng, n)
    for s in range(4):
        cells = np.empty((40, 3), np.int64)
        cells[:, 0] = rng.integers(0, len(R.MESH_NAMES), 40)
        cells[:, 1] = rng.integers(-R.MESH_BL, R.MESH_BL + 1, 40)
        cells[:, 2] = rng.integers(1, 50, 40)
        d[f"cells.{s}"] = cells
        packed = np.empty((30, 3), np.int32)
        packed[:, 0] = rng.integers(0, R.MESH_M, 30)
        packed[:, 1] = rng.integers(-R.MESH_BL, R.MESH_BL + 1, 30)
        packed[:, 2] = rng.integers(1, 20, 30)
        d[f"packed.{s}"] = packed
    d["grow.probe"] = _agreeing(rng, len(R.GROW_NAMES))
    for i, seen in enumerate(R.GROW_SEEN):
        for s in range(4):
            n = R.agg_rows(s, i)
            d[f"grow.{i}.{s}.ids"] = rng.integers(0, seen, n).astype(
                np.int32)
            d[f"grow.{i}.{s}.values"] = _agreeing(rng, n)
    for s in range(4):
        cells = np.empty((30, 3), np.int64)
        cells[:, 0] = rng.integers(0, len(R.GROW_NAMES), 30)
        cells[:, 1] = rng.integers(-R.MESH_BL, R.MESH_BL + 1, 30)
        cells[:, 2] = rng.integers(1, 50, 30)
        d[f"grow.cells.{s}"] = cells
    return d


@pytest.fixture(scope="module")
def inputs():
    return _make_inputs()


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Per mesh shape, every rank's results (one launch per shape)."""
    cache = {}

    def get(shape):
        if shape not in cache:
            s, m = shape
            cache[shape] = R.launch(
                tmp_path_factory.mktemp(f"mesh{s}x{m}"), s * m,
                f"mesh:{s}x{m}", inputs)
        return cache[shape]

    return get


def _by_coord(results):
    return {tuple(r["coord"].tolist()): r for r in results}


def _block(arr, m, n_metric):
    rows = arr.shape[0] // n_metric
    return arr[m * rows:(m + 1) * rows]


@pytest.mark.parametrize("shape", R.SHAPES, ids=SHAPE_IDS)
def test_ranks_sit_row_major_like_the_jax_mesh(shape, ranks):
    s_n, m_n = shape
    coords = [tuple(r["coord"].tolist()) for r in ranks(shape)]
    assert coords == [(r // m_n, r % m_n) for r in range(s_n * m_n)]
    devices = jax_make_mesh(stream=s_n, metric=m_n).devices
    assert devices.shape == shape  # JAX's grid: device r at (r // m, r % m)


@pytest.mark.parametrize("shape", R.SHAPES, ids=SHAPE_IDS)
def test_step_blocks_equal_the_jax_mesh_rows(shape, ranks, inputs):
    s_n, m_n = shape
    res = _by_coord(ranks(shape))
    mesh = jax_make_mesh(stream=s_n, metric=m_n)
    step = jax_distributed_step(mesh, R.MESH_M, R.MESH_BL, R.MESH_PS)
    acc = jax_sharded_accumulator(mesh, R.MESH_M, R.MESH_B)
    for k in range(R.STEPS):
        acc, stats = step(acc, jnp.asarray(inputs["step.ids"][k]),
                          jnp.asarray(inputs["step.values"][k]))
        want = np.asarray(acc)
        for (s, m), r in res.items():
            for path in R.STEP_PATHS:
                np.testing.assert_array_equal(
                    r[f"step.{path}.acc.{k}"], _block(want, m, m_n),
                    err_msg=f"rank {(s, m)} {path} step {k}")
        counts = np.concatenate([res[(0, m)][f"step.auto.counts.{k}"]
                                 for m in range(m_n)])
        pcts = np.concatenate([res[(0, m)][f"step.auto.pcts.{k}"]
                               for m in range(m_n)])
        np.testing.assert_array_equal(counts, np.asarray(stats["counts"]))
        np.testing.assert_allclose(pcts, np.asarray(stats["percentiles"]),
                                   rtol=4e-6, atol=0)
    # accumulation across steps: the second step holds both batches
    assert int(np.asarray(acc).sum()) == R.STEPS * R.STEP_N


@pytest.mark.parametrize("shape", R.SHAPES, ids=SHAPE_IDS)
def test_dispatched_paths_equal_scatter_and_auto_is_per_rank(
        shape, ranks, inputs):
    s_n, m_n = shape
    res = _by_coord(ranks(shape))
    one_row = jax_distributed_step(jax_make_mesh(stream=s_n, metric=m_n),
                                   m_n, R.MESH_BL, R.MESH_PS)
    acc, _ = one_row(
        jax_sharded_accumulator(jax_make_mesh(stream=s_n, metric=m_n), m_n,
                                R.MESH_B),
        jnp.asarray(inputs["step.ids"][0] % m_n),
        jnp.asarray(inputs["step.values"][0]))
    for (s, m), r in res.items():
        for path in R.STEP_PATHS:
            np.testing.assert_array_equal(r[f"step.{path}.acc.1"],
                                          r["step.scatter.acc.1"])
        # the port admits K1 per rank (D8), K2b for a one-row block
        assert str(r["step.auto.path"]) == "fused"
        assert str(r["step.row.path"]) == "row"
        np.testing.assert_array_equal(r["step.row.acc"],
                                      _block(np.asarray(acc), m, m_n))


@pytest.mark.parametrize("shape", R.SHAPES, ids=SHAPE_IDS)
def test_interval_step_equals_per_batch_step_and_one_device(
        shape, ranks, inputs):
    s_n, m_n = shape
    res = _by_coord(ranks(shape))
    one = [np.zeros((R.MESH_M, R.MESH_B), np.int32) for _ in range(2)]
    for k in range(R.STEPS):
        ingest_batch(torch.from_numpy(one[k]),
                     torch.from_numpy(inputs["step.ids"][k]),
                     torch.from_numpy(inputs["step.values"][k]), R.MESH_BL)
    both = one[0] + one[1]
    for (s, m), r in res.items():
        np.testing.assert_array_equal(r["interval.acc.0"],
                                      _block(one[0], m, m_n))
        np.testing.assert_array_equal(r["interval.acc.1"],
                                      r["step.scatter.acc.1"])
        np.testing.assert_array_equal(r["interval.acc.1"],
                                      _block(both, m, m_n))
        np.testing.assert_array_equal(r["interval.acc.2"],
                                      r["interval.acc.1"])
        assert int(r["interval.fresh_sum"]) == 0
        np.testing.assert_array_equal(r["interval.counts"],
                                      _block(both, m, m_n).sum(1))


def _jax_aggregator(shape, inputs, transport, **kw):
    """The JAX mesh aggregator fed the whole stream of every interval:
    per interval (acc + spill as int64, collected metrics)."""
    s_n, m_n = shape
    agg = TPUAggregator(
        num_metrics=R.MESH_M, config=JaxConfig(bucket_limit=R.MESH_BL),
        mesh=jax_make_mesh(stream=s_n, metric=m_n), storage="dense",
        transport=transport, batch_size=R.AGG_BATCH, **kw)
    out = []

    def close_interval():
        agg.flush(force=True)
        acc = np.asarray(agg._acc).astype(np.int64)
        if agg._spill is not None:
            acc = acc + agg._spill
        out.append((acc, agg.collect().metrics))

    try:
        for name in R.MESH_NAMES:
            agg.registry.id_for(name)
        for i in range(R.AGG_INTERVALS):
            for s in range(s_n):
                agg.record_batch(inputs[f"agg.{i}.{s}.ids"],
                                 inputs[f"agg.{i}.{s}.values"])
            close_interval()
        if transport == "sparse":
            for s in range(s_n):
                agg.merge_raw(R.raw_from_cells(inputs[f"cells.{s}"],
                                               JaxRawMetricSet))
                agg.merge_packed(inputs[f"packed.{s}"], wait=True)
            close_interval()
    finally:
        agg.close()
    return out


def _check_aggregator(shape, results, want, tag, keys):
    s_n, m_n = shape
    res = _by_coord(results)
    for key, (jax_acc, jax_metrics) in zip(keys, want):
        sets = [R.get_metrics(r, f"{tag}.{key}") for r in res.values()]
        for got in sets[1:]:
            assert got == sets[0]  # every rank: the same global set
        _assert_same(sets[0], jax_metrics)
        for m in range(m_n):
            summed = sum(res[(s, m)][f"{tag}.{key}.partial"]
                         for s in range(s_n))
            np.testing.assert_array_equal(summed, _block(jax_acc, m, m_n))


@pytest.mark.parametrize("transport", ["raw", "sparse"])
@pytest.mark.parametrize("shape", R.SHAPES, ids=SHAPE_IDS)
def test_aggregator_equals_jax_mesh_aggregator(shape, transport, ranks,
                                               inputs):
    results = ranks(shape)
    want = _jax_aggregator(shape, inputs, transport)
    keys = list(range(R.AGG_INTERVALS)) + (
        ["cells"] if transport == "sparse" else [])
    _check_aggregator(shape, results, want, transport, keys)
    for r in results:
        assert str(r[f"{transport}.transport"]) == transport
        assert str(r[f"{transport}.path"]) == "fused"
    # every name reported: the stream held every row
    names = R.get_metrics(results[0], f"{transport}.0")
    assert all(f"{n}_count" in names for n in R.MESH_NAMES)


@pytest.mark.parametrize("shape", R.SHAPES, ids=SHAPE_IDS)
def test_tiny_spill_threshold_keeps_global_counts_exact(shape, ranks,
                                                        inputs):
    s_n, m_n = shape
    results = ranks(shape)
    for r in results:  # each rank spilled at its share of the threshold
        for i in range(R.AGG_INTERVALS):
            assert bool(r[f"spill.{i}.spilled"])
    want = _jax_aggregator(shape, inputs, "raw",
                           spill_threshold=R.SPILL_THRESHOLD)
    _check_aggregator(shape, results, want, "spill",
                      list(range(R.AGG_INTERVALS)))
    for i in range(R.AGG_INTERVALS):
        ids = np.concatenate([inputs[f"agg.{i}.{s}.ids"]
                              for s in range(s_n)])
        got = R.get_metrics(results[-1], f"spill.{i}")
        for k, name in enumerate(R.MESH_NAMES):
            assert got[f"{name}_count"] == int((ids == k).sum()), name


@pytest.mark.parametrize("shape", R.SHAPES, ids=SHAPE_IDS)
def test_refusals_in_the_reference_words(shape, ranks):
    s_n, m_n = shape
    for r in ranks(shape):
        assert "mesh 7x3 needs 21 devices, have" in str(r["refuse.mesh"])
        if m_n > 1:  # 2 * m_n + 1 rows
            for key in ("refuse.step_rows", "refuse.interval_rows"):
                assert "not divisible by metric axis size" in str(r[key])
            assert "not divisible by the mesh metric axis" in str(
                r["refuse.agg_rows"])
        else:  # every row count divides a 1-way metric axis
            for key in ("refuse.step_rows", "refuse.interval_rows",
                        "refuse.agg_rows"):
                assert str(r[key]) == ""
        # paged storage on a mesh since 11c-1 (ROADMAP D12): explicit,
        # and "auto" at the crossover, construct
        assert str(r["refuse.paged"]) == ""
        assert str(r["refuse.auto_paged"]) == ""
        assert "single-device" in str(r["refuse.multirow"])
        # the state on a mesh round-trips since 11b-3 (ROADMAP D11)
        assert str(r["refuse.state"]) == ""
        assert bool(r["state.same"])
        # the sharded fused commit is in (11b-1): the pair commits
        assert str(r["commit.mode"]) == "fused"


@pytest.mark.parametrize("shape", R.SHAPES, ids=SHAPE_IDS)
def test_growth_moves_rows_at_collect_like_the_jax_mesh(shape, ranks,
                                                        inputs):
    s_n, m_n = shape
    results = ranks(shape)
    agg = TPUAggregator(
        num_metrics=R.GROW_M0, config=JaxConfig(bucket_limit=R.MESH_BL),
        mesh=jax_make_mesh(stream=s_n, metric=m_n), storage="dense",
        transport="raw", batch_size=R.AGG_BATCH, max_metrics=R.GROW_MAX)
    try:
        for i in range(len(R.GROW_SEEN)):
            for s in range(s_n):
                R.grow_feed(agg, inputs, s, i, JaxRawMetricSet)
            want = agg.collect().metrics
            for r in results:
                assert int(r[f"grow.{i}.capacity"]) == agg.registry.capacity
                assert int(r[f"grow.{i}.m"]) == agg.num_metrics
                assert int(r[f"grow.{i}.rows"]) == agg.num_metrics // m_n
                _assert_same(R.get_metrics(r, f"grow.{i}"), want)
    finally:
        agg.close()
    assert agg.num_metrics == R.GROW_MAX
