"""The ingest-path axis: the port's sort, sortscan, matmul, hybrid and
scatter steps, the multirow layout and K8's plain version, and
``TorchAggregator(ingest_path=p)`` for every path, each against the JAX
package on the same seeded input (JAX's multirow through Pallas in
interpret mode, as its own tests run it on the CPU).

Tolerances: every count, accumulator cell and layout entry EQUAL.
``collect()`` percentiles: the same bucket, values within rtol 4e-6
(XLA's float32 ``exp`` against the correctly rounded representatives,
ROADMAP F1); sums and averages rtol 2e-6 (that error plus float32
reduction order).  Streams are filtered to values on which the JAX
float32 codec and the port's float64 codec agree (their departures are
counted in test_torch_codec.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.ops import hybrid_hist as jhybrid
from loghisto_tpu.ops import matmul_hist as jmatmul
from loghisto_tpu.ops import sort_ingest as jsort
from loghisto_tpu.ops.codec import compress_np
from loghisto_tpu.ops.ingest import bucket_indices as jax_bucket_indices
from loghisto_tpu.ops.ingest import make_ingest_fn as jax_make_ingest_fn
from loghisto_tpu.ops.pallas_multirow import (
    make_multirow_ingest as jax_make_multirow_ingest,
)
from loghisto_tpu.ops.pallas_multirow import preprocess as jax_preprocess
from loghisto_tpu.parallel.aggregator import TPUAggregator
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.ops import dispatch
from loghisto_tpu_torch.ops.hybrid_hist import (
    ingest_batch_hybrid,
    make_hybrid_ingest_fn,
)
from loghisto_tpu_torch.ops.ingest import make_ingest_fn
from loghisto_tpu_torch.ops.matmul_hist import make_matmul_ingest_fn
from loghisto_tpu_torch.ops.multirow_ingest import (
    K8_RUN_MIN,
    SAMPLE_TILE,
    histogram_runs,
    make_multirow_ingest,
    multirow_ingest,
    multirow_ingest_batch,
    preprocess,
)
from loghisto_tpu_torch.ops.sort_ingest import (
    make_sort_ingest_fn,
    make_sortscan_ingest_fn,
    validate_flat_cell_shape,
)
from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
from loghisto_tpu_torch.state import state_from_jax

JAX_FACTORIES = {
    "scatter": jax_make_ingest_fn,
    "sort": jsort.make_sort_ingest_fn,
    "sortscan": jsort.make_sortscan_ingest_fn,
    "matmul": jmatmul.make_matmul_ingest_fn,
    "hybrid": jhybrid.make_hybrid_ingest_fn,
}
PORT_FACTORIES = {
    "scatter": make_ingest_fn,
    "sort": make_sort_ingest_fn,
    "sortscan": make_sortscan_ingest_fn,
    "matmul": make_matmul_ingest_fn,
    "hybrid": make_hybrid_ingest_fn,
}


def agreeing(values, bl):
    """The values on which JAX's float32 codec and compress_np agree."""
    values = np.asarray(values, np.float32)
    jax_idx = np.asarray(jax_bucket_indices(jnp.asarray(values), bl)) - bl
    return values[jax_idx == np.clip(compress_np(values), -bl, bl)]


def adversarial_batch(seed, n, m, bl):
    """Ids straddling [0, M) on both sides; NaN, zeros, negatives,
    infinities and denormals among codec-agreeing lognormal values."""
    rng = np.random.default_rng(seed)
    values = agreeing(rng.lognormal(3, 2, 2 * n), bl)[:n]
    values[:64] = np.nan
    values[64:128] = 0.0
    values[128:256] *= -1
    values[256:260] = [np.inf, -np.inf, 1e-45, -0.0]
    ids = rng.integers(-2, m + 3, len(values)).astype(np.int32)
    return ids, values


def _run(factory, acc0, batches, bl, **kw):
    ingest = factory(bl, **kw)
    acc = acc0
    for ids, values in batches:
        acc = ingest(acc, ids, values)
    return np.asarray(acc)


@pytest.mark.parametrize("path", list(PORT_FACTORIES))
def test_xla_path_matches_jax_adversarial_and_accumulates(path):
    """Two adversarial batches onto an accumulator that already holds
    counts (bucket_limit 256, 37 rows)."""
    bl, m = 256, 37
    rng = np.random.default_rng(1)
    start = rng.integers(0, 1000, (m, 2 * bl + 1)).astype(np.int32)
    batches = [adversarial_batch(9 + i, 1 << 13, m, bl) for i in range(2)]
    want = _run(JAX_FACTORIES[path], jnp.asarray(start), batches, bl)
    got = _run(PORT_FACTORIES[path], torch.from_numpy(start.copy()),
               batches, bl, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.sum() > start.sum()


@pytest.mark.parametrize("path", list(PORT_FACTORIES))
def test_xla_path_single_cell_and_all_invalid(path):
    bl, m = 64, 8
    cases = [
        # every sample in one cell: one segment spanning the batch
        (np.zeros(4096, np.int32), np.full(4096, 2.5, np.float32)),
        # every sample invalid: nothing lands
        (np.full(512, -1, np.int32), np.ones(512, np.float32)),
        (np.full(512, m, np.int32), np.ones(512, np.float32)),
    ]
    for ids, values in cases:
        zero = np.zeros((m, 2 * bl + 1), np.int32)
        want = _run(JAX_FACTORIES[path], jnp.asarray(zero), [(ids, values)],
                    bl)
        got = _run(PORT_FACTORIES[path], torch.from_numpy(zero),
                   [(ids, values)], bl, device="cpu")
        np.testing.assert_array_equal(got, want)
    assert got.sum() == 0 and want.sum() == 0


def test_hybrid_refuses_a_2_24_batch_as_jax_does():
    n = 1 << 24
    acc = torch.zeros((2, 129), dtype=torch.int32)
    with pytest.raises(ValueError) as port_err:
        ingest_batch_hybrid(acc, torch.zeros(n, dtype=torch.int32),
                            torch.ones(n, dtype=torch.float32), 64)
    with pytest.raises(ValueError) as jax_err:
        jhybrid.ingest_batch_hybrid(
            jnp.zeros((2, 129), jnp.int32), jnp.zeros(n, jnp.int32),
            jnp.ones(n, jnp.float32), 64)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("path", ["sort", "sortscan", "matmul"])
def test_flat_cell_bound_raises_at_construction_as_jax_does(path):
    with pytest.raises(ValueError) as jax_err:
        jsort.validate_flat_cell_shape(300_000, 8193, path)
    with pytest.raises(ValueError) as port_err:
        validate_flat_cell_shape(300_000, 8193, path)
    assert str(port_err.value) == str(jax_err.value)
    # the aggregators check the growth cap before allocating anything
    with pytest.raises(ValueError) as jax_err:
        TPUAggregator(num_metrics=1024, ingest_path=path, storage="dense",
                      max_metrics=300_000)
    with pytest.raises(ValueError) as port_err:
        TorchAggregator(num_metrics=1024, ingest_path=path, storage="dense",
                        max_metrics=300_000, device="cpu")
    assert str(jax_err.value) in str(port_err.value)


@pytest.mark.parametrize("kwargs", [
    {"num_metrics": 8, "ingest_path": "pallas"},
    {"num_metrics": 8, "ingest_path": "hybrid", "batch_size": 1 << 24,
     "spill_threshold": 1 << 20},
    {"num_metrics": 1, "ingest_path": "pallas", "batch_size": 1 << 24,
     "spill_threshold": 1 << 20},
    {"num_metrics": 12, "ingest_path": "multirow"},
    {"num_metrics": 8, "ingest_path": "warp-drive"},
])
def test_explicit_paths_raise_the_jax_sentences(kwargs):
    cfg = MetricConfig(bucket_limit=64)
    with pytest.raises(ValueError) as jax_err:
        TPUAggregator(config=JaxConfig(bucket_limit=64), storage="dense",
                      **kwargs)
    with pytest.raises(ValueError) as port_err:
        TorchAggregator(config=cfg, storage="dense", device="cpu", **kwargs)
    if kwargs["ingest_path"] != "warp-drive":
        assert str(jax_err.value) in str(port_err.value)


def test_auto_resolution_is_unchanged():
    assert dispatch.resolve_ingest_path("auto", 1) == "row"
    assert dispatch.resolve_ingest_path("auto", 1, batch_size=1 << 24) == (
        "fused")
    for m in (2, 8, 16, 10_000, 1 << 20):
        assert dispatch.resolve_ingest_path("auto", m) == "fused"
    agg = TorchAggregator(num_metrics=16, device="cpu")
    assert agg.ingest_path == "fused"
    agg.close()
    with pytest.raises(ValueError, match="multirow"):
        dispatch.ingest_step_fn("multirow")


def _layout_batch(seed, n, m, bl):
    rng = np.random.default_rng(seed)
    values = agreeing(rng.lognormal(2, 1.5, 2 * n), bl)[:n]
    values[::3] *= -1
    ids = np.where(rng.uniform(size=len(values)) < 0.6, 0,
                   rng.integers(-3, m + 5, len(values))).astype(np.int32)
    return ids, values


@pytest.mark.parametrize("rows_tile", [4, 8, 16])
@pytest.mark.parametrize("n", [1, 2, 5000, 2 * SAMPLE_TILE])
def test_preprocess_layout_equals_jax(rows_tile, n):
    m, bl = 32, 512
    ids, values = _layout_batch(rows_tile + n, n, m, bl)
    want = jax_preprocess(jnp.asarray(ids), jnp.asarray(values), m,
                          rows_tile, bl)
    got = preprocess(torch.from_numpy(ids), torch.from_numpy(values), m,
                     rows_tile, bl)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_preprocess_layout_invariants():
    rng = np.random.default_rng(4)
    m, rows_tile = 32, 8
    ids = rng.integers(0, m, 5000).astype(np.int32)
    values = rng.lognormal(2, 1, 5000).astype(np.float32)
    rows, bidx, tile_block = preprocess(
        torch.from_numpy(ids), torch.from_numpy(values), m, rows_tile, 512)
    g = tile_block.shape[0]
    assert g == (5000 + SAMPLE_TILE - 1) // SAMPLE_TILE + m // rows_tile
    rows = rows.numpy().reshape(g, SAMPLE_TILE)
    tile_block = tile_block.numpy()
    assert (np.diff(tile_block) >= 0).all()  # consecutive block visits
    reconstructed = np.concatenate([
        tile_block[t] * rows_tile + rows[t][rows[t] < rows_tile]
        for t in range(g)
    ])
    assert len(reconstructed) == 5000  # no sample lost, none duplicated
    np.testing.assert_array_equal(np.bincount(reconstructed, minlength=m),
                                  np.bincount(ids, minlength=m))


def _multirow_pair(rows_tile, batches, m=32, bl=512):
    jinit, jingest, jfinal = jax_make_multirow_ingest(
        m, bl, rows_tile=rows_tile, interpret=True)
    init, ingest, final = make_multirow_ingest(m, bl, rows_tile=rows_tile,
                                               device="cpu")
    jacc, acc = jinit(), init()
    for ids, values in batches:
        jacc = jingest(jacc, ids, values)
        acc = ingest(acc, ids, values)
    return final(acc).numpy(), np.asarray(jfinal(jacc))


def _agreeing_batch(rng, n, m, bl, ids=None):
    values = agreeing(rng.lognormal(2, 1.5, 2 * n), bl)[:n]
    values[::3] *= -1
    if ids is None:
        ids = rng.integers(0, m, len(values)).astype(np.int32)
    return ids[:len(values)], values


@pytest.mark.parametrize("rows_tile", [4, 8, 16])
def test_multirow_matches_jax_uniform(rows_tile):
    rng = np.random.default_rng(1)
    got, want = _multirow_pair(rows_tile,
                               [_agreeing_batch(rng, 10_000, 32, 512)])
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


def test_multirow_matches_jax_zipf_hot_block_and_oob():
    rng = np.random.default_rng(2)
    n = 20_000
    ids = np.where(rng.uniform(size=n) < 0.8, 0,
                   rng.integers(-3, 32 + 5, n)).astype(np.int32)
    got, want = _multirow_pair(8, [_agreeing_batch(rng, n, 32, 512, ids)])
    np.testing.assert_array_equal(got, want)


def test_multirow_matches_jax_across_three_batches():
    rng = np.random.default_rng(3)
    batches = [_agreeing_batch(rng, 3000, 32, 512) for _ in range(3)]
    got, want = _multirow_pair(8, batches)
    np.testing.assert_array_equal(got, want)
    # and the plain version of the whole step agrees
    acc = torch.zeros((32, 1025), dtype=torch.int32)
    for ids, values in batches:
        multirow_ingest_batch(acc, torch.from_numpy(ids),
                              torch.from_numpy(values), 512)
    np.testing.assert_array_equal(acc.numpy(), got)


def test_multirow_matches_jax_on_a_two_sample_batch():
    batch = (np.array([0, 31], np.int32), np.array([1.0, -1.0], np.float32))
    got, want = _multirow_pair(8, [batch])
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 2


def test_multirow_rejects_rows_off_the_tile_as_jax_does():
    with pytest.raises(ValueError) as jax_err:
        jax_make_multirow_ingest(30, 512, rows_tile=8)
    with pytest.raises(ValueError) as port_err:
        make_multirow_ingest(30, 512, rows_tile=8, device="cpu")
    assert str(port_err.value) == str(jax_err.value)


# -- the aggregator, every path ---------------------------------------------

AGG_BL = 64


def _agg_stream(seed, m, intervals=2, n=4000):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(intervals):
        values = agreeing(rng.lognormal(-1.5, 0.6, 2 * n), AGG_BL)[:n]
        values[rng.random(len(values)) < 0.1] *= -1
        ids = rng.integers(-1, m + 1, len(values)).astype(np.int32)
        out.append((ids, values))
    return out


def _assert_same(got, want):
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


@pytest.mark.parametrize("path,jax_path,m", [
    ("scatter", "scatter", 8), ("sort", "sort", 8),
    ("sortscan", "sortscan", 8), ("matmul", "matmul", 8),
    ("hybrid", "hybrid", 8), ("multirow", "multirow", 8),
    ("fused", "fused", 8), ("pallas", "pallas", 1), ("row", "pallas", 1),
])
def test_aggregator_path_matches_jax(path, jax_path, m):
    jax_agg = TPUAggregator(num_metrics=m,
                            config=JaxConfig(bucket_limit=AGG_BL),
                            ingest_path=jax_path, storage="dense",
                            transport="raw", batch_size=2048)
    port = TorchAggregator(num_metrics=m, config=MetricConfig(
        bucket_limit=AGG_BL), ingest_path=path, storage="dense",
        transport="raw", batch_size=2048, device="cpu")
    try:
        for i in range(m):
            assert jax_agg.registry.id_for(f"m{i}") == port.registry.id_for(
                f"m{i}")
        for ids, values in _agg_stream(7, m):
            jax_agg.record_batch(ids, values)
            port.record_batch(ids, values)
            got = port.collect().metrics
            _assert_same(got, jax_agg.collect().metrics)
            for i in range(m):
                assert got.get(f"m{i}_count", 0.0) == float((ids == i).sum())
        assert port.ingest_path == path
    finally:
        jax_agg.close()
        port.close()


def test_multirow_growth_respects_row_tile_as_jax_does():
    """max_metrics=20 is off the 8-row grid: growth stops at 16 rows and
    the four names past them are shed, in both packages."""
    aggs = [
        TPUAggregator(num_metrics=8, config=JaxConfig(bucket_limit=AGG_BL),
                      ingest_path="multirow", max_metrics=20),
        TorchAggregator(num_metrics=8, config=MetricConfig(
            bucket_limit=AGG_BL), ingest_path="multirow", max_metrics=20,
            device="cpu"),
    ]
    outs = []
    for agg in aggs:
        for i in range(20):
            agg.record(f"m{i}", 1.0)
        assert agg.num_metrics == 16
        assert agg._registry_shed_samples == 4
        outs.append(agg.collect().metrics)
        agg.record("m0", 2.0)  # still healthy after the exhausted grow
        assert agg.collect().metrics["m0_count"] == 1.0
        agg.close()
    _assert_same(outs[1], outs[0])
    assert sum(1 for k in outs[1]
               if k.endswith("_count") and not k.endswith("_agg_count")) == 16
    assert aggs[1].ingest_path == "multirow"


def test_state_from_jax_multirow_strips_the_lane_pad():
    jax_agg = TPUAggregator(num_metrics=8, config=JaxConfig(
        bucket_limit=AGG_BL), ingest_path="multirow", storage="dense")
    for i in range(8):
        jax_agg.registry.id_for(f"m{i}")
    stream = _agg_stream(11, 8)
    jax_agg.record_batch(*stream[0])
    jax_agg.collect()  # the lifetime store fills
    jax_agg.record_batch(*stream[1])
    jax_agg.flush(force=True)
    padded = np.asarray(jax_agg._acc)
    assert padded.shape == (8, 2 * 128)  # 129 buckets lane-padded to 256
    with pytest.raises(ValueError, match="bucket_limit"):
        state_from_jax(padded, jax_agg.registry.names(), jax_agg._agg)
    state = state_from_jax(padded, jax_agg.registry.names(), jax_agg._agg,
                           jax_agg._spill, bucket_limit=AGG_BL)
    assert state["acc"].shape == (8, 2 * AGG_BL + 1)
    port = TorchAggregator(num_metrics=8, config=MetricConfig(
        bucket_limit=AGG_BL), ingest_path="multirow", device="cpu")
    port.load_state_dict(state)
    assert port.ingest_path == "multirow"
    _assert_same(port.collect().metrics, jax_agg.collect().metrics)
    port.close()
    jax_agg.close()


def _scrambled_layout(seed, n, m, rows_tile, bl):
    """A preprocess layout with its tiles in a random order (so blocks
    are revisited after others) and each tile's entries shuffled (so
    filler sits anywhere inside a tile), plus the numpy count of what it
    adds: the same function K8 must compute on it."""
    rng = np.random.default_rng(seed)
    ids = np.where(rng.random(n) < 0.5, 0, rng.integers(-2, m + 2, n))
    ids = ids.astype(np.int32)
    values = rng.lognormal(2, 2, n).astype(np.float32)
    rows, bidx, tb = (t.numpy() for t in preprocess(
        torch.from_numpy(ids), torch.from_numpy(values), m, rows_tile, bl))
    g = len(tb)
    order = rng.permutation(g)
    rows = rows.reshape(g, SAMPLE_TILE)[order]
    bidx = bidx.reshape(g, SAMPLE_TILE)[order]
    for t in range(g):
        p = rng.permutation(SAMPLE_TILE)
        rows[t], bidx[t] = rows[t][p], bidx[t][p]
    tb = tb[order]
    keep = (ids >= 0) & (ids < m)
    cols = np.clip(compress_np(values[keep]), -bl, bl).astype(np.int64) + bl
    want = np.bincount(ids[keep].astype(np.int64) * (2 * bl + 1) + cols,
                       minlength=m * (2 * bl + 1)).reshape(m, -1)
    return rows.reshape(-1), bidx.reshape(-1), tb, want


@pytest.mark.parametrize("rows_tile", [4, 8, 16])
def test_multirow_plain_on_a_scrambled_layout(rows_tile):
    """K8's plain version (through its wrapper on CPU tensors) with
    filler inside tiles and tile_block revisiting blocks, against a
    numpy count of the samples."""
    m, bl = 64, 512
    rows, bidx, tb, want = _scrambled_layout(rows_tile, 20_000, m,
                                             rows_tile, bl)
    assert (np.diff(tb) < 0).any()  # a block comes back after another
    acc = torch.zeros((m, 2 * bl + 1), dtype=torch.int32)
    multirow_ingest(acc, torch.from_numpy(rows), torch.from_numpy(bidx),
                    torch.from_numpy(tb), rows_tile)
    np.testing.assert_array_equal(acc.numpy(), want)


@pytest.mark.parametrize("shape", ["one_hot_block", "every_block_one_tile"])
def test_preprocess_layout_equals_jax_at_the_kernels_run_lengths(shape):
    """The run lengths K8's route reads: one row block over many tiles
    (it takes the cluster histogram), and every block under one tile
    (the direct route)."""
    bl = 512
    rng = np.random.default_rng(7)
    if shape == "one_hot_block":
        m, n = 32, 48 * SAMPLE_TILE
        ids = np.where(rng.random(n) < 0.9, rng.integers(0, 8, n),
                       rng.integers(-1, m + 1, n)).astype(np.int32)
    else:
        m, n = 4096, 3 * SAMPLE_TILE
        ids = rng.integers(0, m, n).astype(np.int32)
    values = agreeing(rng.lognormal(2, 1.5, 2 * n), bl)[:n]
    ids = ids[:len(values)]
    want = jax_preprocess(jnp.asarray(ids), jnp.asarray(values), m, 8, bl)
    got = preprocess(torch.from_numpy(ids), torch.from_numpy(values), m, 8,
                     bl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    tb = got[2].numpy()
    starts = np.flatnonzero(np.r_[True, tb[1:] != tb[:-1]])
    longest = np.diff(np.r_[starts, len(tb)]).max()
    runs = histogram_runs(tb, clusters=2, span=-(-len(tb) // 2),
                          rows_tile=8, num_metrics=m)
    if shape == "one_hot_block":
        assert longest >= K8_RUN_MIN and runs
        assert tb[runs[0][0]] == 0
    else:
        # every block fits one tile; only the parked tail repeats a block
        per_block = np.bincount(tb, minlength=m // 8)[:-1]
        assert per_block.max() == 1
        assert all(tb[a] == m // 8 - 1 for a, _ in runs)


def test_histogram_runs_picks_the_first_longest_run_of_each_range():
    """In each range the first longest run; it takes the histogram when
    the whole run (across the range's ends) holds K8_RUN_MIN tiles and
    its block lies inside acc."""
    r = K8_RUN_MIN
    tb = np.array([0] * (r + 1) + [1] * 2 + [0] * 2 + [2] * r + [3] * r
                  + [9] * 2)
    span = r + 3
    got = histogram_runs(tb, 4, span, rows_tile=8, num_metrics=32)
    # range 2's piece of block 3 holds r - 1 tiles; its run holds r
    assert got == [(0, r + 1), (r + 5, 2 * r + 5), (2 * r + 6, 3 * r + 5)]
    # at 16 rows blocks 2 and 3 lie outside acc
    assert histogram_runs(tb, 4, span, 8, 16) == got[:1]
    assert histogram_runs(tb, 4, span, 8, 32, hist_fits=False) == []
    # pieces of 10 tiles of one long run: every range takes it
    assert histogram_runs(np.full(4 * 10, 5), 4, 10, 8, 48) == [
        (0, 10), (10, 20), (20, 30), (30, 40)]
    # runs one tile short of K8_RUN_MIN: none
    short = np.array([0] * (r - 1) + [1] * (r - 1))
    assert histogram_runs(short, 1, len(short), 8, 32) == []
