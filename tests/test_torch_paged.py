"""Paged storage of the port (loghisto_tpu_torch/paging.py,
ops/paged_store.py, the K4f plain version, ``sparse_cells_stats``)
against the JAX package on the CPU, at a small size: bucket_limit 512
(B = 1025, pages_per_row 5 at the default 256-bucket page), pools of
512 pages, 64 to 1024 rows.  Inputs are numpy arrays from a seed.

Tolerances:
  * pools, page tables, codecs, free lists, allocation counts, host
    spills, counts and percentiles from the host statistics: EQUAL;
  * host-statistics sums: rtol 1e-12 (the JAX function reduces each row
    with ``np.dot``, the port with ``np.add.reduceat``);
  * the device query's percentile values: rtol 4e-6 with the selected
    bucket equal, and its float32 sums rtol 2e-6 — JAX's representatives
    come from XLA's float32 ``exp`` (test_torch_stats.py).

The JAX device codec is float32 and the port's float64 (ROADMAP F1), so
raw-sample streams are drawn from values on which the two agree (the
departures are counted in test_torch_codec.py).  The JAX Pallas tier of
K4 runs in interpret mode once, on 256 triples; everywhere else the
port is held against the jnp tier, which the JAX package pins
bit-identical to it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loghisto_tpu import paging as jpaging
from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.ops import dispatch as jdispatch
from loghisto_tpu.ops import fused_ingest as jfused
from loghisto_tpu.ops import paged_store as jpaged
from loghisto_tpu.ops.codec import compress_np
from loghisto_tpu.ops.ingest import bucket_indices as jax_bucket_indices
from loghisto_tpu.ops.stats import sparse_cells_stats as jax_sparse_cells_stats
from loghisto_tpu.parallel.aggregator import TPUAggregator
from loghisto_tpu_torch import paging
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.ops import dispatch
from loghisto_tpu_torch.ops import paged_store
from loghisto_tpu_torch.ops.backend import kernel_launches
from loghisto_tpu_torch.ops.fused_ingest import fused_paged_ingest_batch
from loghisto_tpu_torch.ops.stats import sparse_cells_stats
from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
from loghisto_tpu_torch.state import paged_state_from_jax

BL = 512
B = 2 * BL + 1
POOL = 512
PS = np.array([0.0, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0])


def _values(rng, n, lo=-4.0, hi=6.5):
    """Values spread over the +/-512 buckets (and a little past the
    clip), restricted to those the JAX float32 codec buckets as
    ``compress_np`` does."""
    v = np.expm1(rng.uniform(lo, hi, 2 * n)) * np.where(
        rng.random(2 * n) < 0.2, -1.0, 1.0)
    v = v.astype(np.float32)
    jax_idx = np.asarray(jax_bucket_indices(jnp.asarray(v), BL))
    keep = jax_idx == np.clip(compress_np(v), -BL, BL) + BL
    return v[keep][:n]


def _stores(m=64, pool=POOL, **cfg):
    jst = jpaging.PagedStore(
        m, BL, config=jpaging.PagedStoreConfig(pool_pages=pool, **cfg),
        kernel="jnp",
    )
    # the JAX raw route on the jnp tier (bit-identical to its Pallas
    # tier, which interprets ~20 s per dispatch on a CPU)
    jst._fused_fn = jax.jit(
        lambda pool_, i, v, rc, enc, tbl: jfused.fused_paged_ingest_batch(
            pool_, i, v, rc, enc, tbl, BL, kernel="jnp"))
    pst = paging.PagedStore(
        m, BL, config=paging.PagedStoreConfig(pool_pages=pool, **cfg),
        device="cpu",
    )
    return jst, pst


def _assert_same_store(jst, pst):
    np.testing.assert_array_equal(pst.page_table, jst.page_table)
    np.testing.assert_array_equal(pst.row_codec, jst.row_codec)
    assert pst.allocated_pages == jst.allocated_pages
    assert pst.free_list() == jst._free_lists[0]
    assert pst._host_spill == jst._host_spill
    assert pst.spilled_cells == jst.spilled_cells
    assert pst.overflowed_cells == jst.overflowed_cells
    assert (pst.free_pages, pst.occupied_pages, pst.pool_saturation(),
            pst.hbm_bytes()) == (jst.free_pages, jst.occupied_pages,
                                 jst.pool_saturation(), jst.hbm_bytes())
    np.testing.assert_array_equal(pst._pool.numpy(), np.asarray(jst._pool))


# -- codecs ------------------------------------------------------------- #


@pytest.mark.parametrize("bl", [64, 512, 4096])
@pytest.mark.parametrize("name", ["dense", "loglinear", "polytail"])
def test_codec_luts_equal_jax(bl, name):
    make = {
        "dense": lambda m: m.dense_codec(2 * bl + 1),
        "loglinear": lambda m: m.loglinear_codec(bl, 4),
        "polytail": lambda m: m.polytail_codec(bl, min(1024, bl // 2), 0.10),
    }[name]
    got, want = make(paging), make(jpaging)
    assert got.name == want.name
    assert got.max_halfwidth == want.max_halfwidth
    assert got.max_rel_error() == want.max_rel_error()
    for lut in ("enc_lut", "dec_lut"):
        g, w = getattr(got, lut), getattr(want, lut)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("pages,page", [(1, 256), (512, 100), (1 << 24, 256)])
def test_pool_shape_validation_matches_jax(pages, page):
    with pytest.raises(ValueError) as want:
        jpaged.validate_pool_shape(pages, page)
    with pytest.raises(ValueError) as got:
        paged_store.validate_pool_shape(pages, page)
    assert str(got.value) == str(want.value)


# -- K4 ------------------------------------------------------------------ #


def _triples(rng, n, pool=POOL, page=256):
    slots = rng.integers(-3, pool + 3, n)
    slots[rng.random(n) < 0.05] = 0  # the zero page: never written
    offs = rng.integers(-20, page + 20, n)  # out-of-range offsets clip
    counts = rng.integers(0, 1000, n)
    packed = np.stack([slots, offs, counts], axis=1).astype(np.int32)
    # duplicates: repeat a block of cells
    return np.concatenate([packed, packed[: n // 4]])


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_scatter_plain_equals_jax(seed):
    rng = np.random.default_rng(seed)
    start = rng.integers(0, 100, (POOL, 256)).astype(np.int32)
    packed = _triples(rng, 20_000)
    want = np.asarray(jpaged.paged_scatter_batch(
        jnp.asarray(start), jnp.asarray(packed)))
    pool = torch.from_numpy(start.copy())
    got = paged_store.paged_scatter(pool, torch.from_numpy(packed))
    assert got is pool  # in place
    np.testing.assert_array_equal(pool.numpy(), want)
    assert not (pool[0] != torch.from_numpy(start[0])).any()
    assert kernel_launches()["paged_scatter"] == 0  # no kernel on a CPU


def test_paged_scatter_plain_equals_jax_pallas_interpret():
    rng = np.random.default_rng(2)
    packed = _triples(rng, 200, pool=64)[:256]
    want = np.asarray(jpaged.pallas_paged_scatter(
        jnp.zeros((64, 256), jnp.int32), jnp.asarray(packed),
        interpret=True))
    pool = torch.zeros((64, 256), dtype=torch.int32)
    paged_store.paged_scatter(pool, torch.from_numpy(packed))
    np.testing.assert_array_equal(pool.numpy(), want)


@pytest.mark.parametrize("shape", ["row_grouped", "hot_cell"])
def test_paged_scatter_plain_equals_jax_on_skewed_triples(shape):
    """K4's new shapes: row-grouped triples (a store's translation of a
    folded band interval, several cells of a row on one page) and one
    cell repeated 2^12 times among them, against the JAX jnp scatter."""
    rng = np.random.default_rng(17)
    m = 64
    store = paging.PagedStore(m, BL, config=paging.PagedStoreConfig(
        pool_pages=POOL), device="cpu")
    ids = np.repeat(np.arange(m, dtype=np.int32), 64)
    buckets = rng.integers(0, 200, m).repeat(64) + rng.integers(0, 4, len(ids))
    values = np.expm1(buckets / 100.0).astype(np.float32)
    from loghisto_tpu_torch.ops.fold import fold_packed_numpy

    packed = store.translate(fold_packed_numpy(ids, values, BL))[0]
    assert len(packed) >= 2 * m  # several cells a row
    if shape == "hot_cell":
        hot = np.tile(packed[:1], (1 << 12, 1))
        hot[:, 2] = 1
        packed = np.concatenate([packed[: len(packed) // 2], hot,
                                 packed[len(packed) // 2:]])
    start = rng.integers(0, 100, (POOL, 256)).astype(np.int32)
    start[0] = 0
    want = np.asarray(jpaged.paged_scatter_batch(
        jnp.asarray(start), jnp.asarray(packed)))
    pool = torch.from_numpy(start.copy())
    paged_store.paged_scatter(pool, torch.from_numpy(packed))
    np.testing.assert_array_equal(pool.numpy(), want)
    assert int(pool.sum()) - int(start.sum()) == int(packed[:, 2].sum())


def test_paged_scatter_refuses_bad_operands():
    pool = torch.zeros((8, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\[n, 3\]"):
        paged_store.paged_scatter(pool, torch.zeros((4, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        paged_store.paged_scatter(pool, torch.zeros((4, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match="int32"):
        paged_store.paged_scatter(pool.long(),
                                  torch.zeros((4, 3), dtype=torch.int32))


# -- K4f ----------------------------------------------------------------- #


def _prepared(codec, m=64, n=20_000, seed=3):
    """A JAX store that mapped pages for one raw batch, and the batch."""
    rng = np.random.default_rng(seed)
    jst, _ = _stores(m=m, codec="auto" if codec == "mixed" else codec)
    if codec == "mixed":
        for r in range(m):
            jst.set_row_codec(r, ("dense", "loglinear", "polytail")[r % 3])
    ids = rng.integers(-3, m + 3, n).astype(np.int32)
    vals = _values(rng, n)
    ids = ids[: len(vals)]
    out_ids, _ = jst.prepare_batch(ids, vals)
    out_ids[:50] = rng.integers(0, m, 50)  # unassigned rows / unmapped pages
    out_ids[50:60] = -1
    return jst, out_ids, vals


@pytest.mark.parametrize("codec", ["dense", "loglinear", "polytail", "mixed"])
def test_fused_paged_plain_equals_jax(codec):
    jst, ids, vals = _prepared(codec, m=96 if codec == "mixed" else 64)
    if codec == "mixed":
        assert len(set(jst.row_codec.tolist())) == 3
    rc, enc, tbl = (np.array(x) for x in jst.device_luts())
    start = np.random.default_rng(4).integers(0, 9, jst._pool.shape)
    start = start.astype(np.int32)
    start[0] = 0
    want = np.asarray(jfused.fused_paged_ingest_batch(
        jnp.asarray(start), jnp.asarray(ids), jnp.asarray(vals), rc, enc,
        tbl, BL, kernel="jnp"))
    pool = torch.from_numpy(start.copy())
    # the port's step takes the page table page-major: [pages_per_row, M]
    fused_paged_ingest_batch(
        pool, torch.from_numpy(ids), torch.from_numpy(vals),
        torch.from_numpy(rc), torch.from_numpy(enc),
        torch.from_numpy(np.ascontiguousarray(tbl.T)), BL,
    )
    np.testing.assert_array_equal(pool.numpy(), want)
    assert int(pool[0].abs().sum()) == 0


def test_fused_paged_hot_cell_and_empty_batch():
    jst, _, _ = _prepared("dense")
    rc, enc, tbl = (torch.from_numpy(np.array(x)) for x in jst.device_luts())
    pool = torch.zeros(jst._pool.shape, dtype=torch.int32)
    row = int(np.nonzero(jst.row_codec >= 0)[0][0])
    value = np.float32(np.expm1(1.5))
    jst.prepare_batch(np.array([row], np.int32), np.array([value]))
    tbl = torch.from_numpy(np.ascontiguousarray(jst.page_table.T))
    n = 1 << 16
    fused_paged_ingest_batch(
        pool, torch.full((n,), row, dtype=torch.int32),
        torch.full((n,), float(value)), rc, enc, tbl, BL)
    assert int(pool.max()) == n and int(pool.sum()) == n
    fused_paged_ingest_batch(
        pool, torch.zeros(0, dtype=torch.int32), torch.zeros(0), rc, enc,
        tbl, BL)
    assert int(pool.sum()) == n


# -- PagedStore ---------------------------------------------------------- #


def _raw_stream(store_pair, batches, m, seed, n=6000, lo=-4.0, hi=6.5):
    jst, pst = store_pair
    rng = np.random.default_rng(seed)
    for _ in range(batches):
        vals = _values(rng, n, lo, hi)
        ids = rng.integers(-2, m + 2, len(vals)).astype(np.int32)
        j_ids, j_sp = jst.prepare_batch(ids, vals)
        p_ids, p_sp = pst.prepare_batch(ids, vals)
        np.testing.assert_array_equal(p_ids, j_ids)
        assert p_sp == j_sp
        jst.ingest_raw(jnp.asarray(j_ids), jnp.asarray(vals))
        pst.ingest_raw(torch.from_numpy(p_ids), torch.from_numpy(vals))


@pytest.mark.parametrize("codec", ["auto", "dense", "loglinear", "polytail"])
def test_store_raw_route_equals_jax(codec):
    pair = _stores(m=256, codec=codec)
    _raw_stream(pair, 3, 256, seed=5)
    _assert_same_store(*pair)
    assert pair[1].fused_dispatches == pair[0].fused_dispatches == 3


def test_store_auto_codec_choice_covers_all_three():
    # narrow rows stay dense, wide rows go loglinear, tail-heavy polytail
    pair = _stores(m=64, body_halfwidth=128)
    jst, pst = pair
    rng = np.random.default_rng(8)
    ids = np.repeat(np.arange(12, dtype=np.int32), 400)
    vals = np.concatenate([
        _values(rng, 400, 1.0, 1.3) if r < 4 else
        _values(rng, 400, -6.5, 6.5) if r < 8 else
        _values(rng, 400, 0.0, 6.5) for r in range(12)])
    ids = ids[: len(vals)]
    for st in pair:
        st.prepare_batch(ids, vals)
    assert set(pst.row_codec[:12].tolist()) == {0, 1, 2}
    _assert_same_store(jst, pst)


def test_store_sparse_route_equals_jax():
    from loghisto_tpu_torch.ops.fold import fold_packed_numpy

    pair = _stores(m=512)
    jst, pst = pair
    rng = np.random.default_rng(6)
    for _ in range(3):
        vals = _values(rng, 30_000)
        ids = ((rng.zipf(1.3, len(vals)) - 1) % 520).astype(np.int32)
        packed = fold_packed_numpy(ids, vals, BL)
        assert pst.commit(packed) == jst.commit(packed)
    _assert_same_store(jst, pst)
    assert pst.commits == jst.commits and pst.h2d_bytes == jst.h2d_bytes


def test_store_overflow_row_redirect_on_saturation():
    # dense rows take 5 pages; 12 pages minus the zero page minus the
    # overflow row's 2 loglinear pages saturate on the third row
    pair = _stores(m=16, pool=12, codec="dense", overflow_row=15)
    jst, pst = pair
    rng = np.random.default_rng(13)
    vals = _values(rng, 4 * 600, -6.0, 6.5)
    ids = np.repeat(np.arange(4, dtype=np.int32), 600)[: len(vals)]
    j_ids, _ = jst.prepare_batch(ids, vals)
    p_ids, spilled = pst.prepare_batch(ids, vals)
    np.testing.assert_array_equal(p_ids, j_ids)
    assert spilled == 0 and pst.overflowed_cells > 0 and (p_ids == 15).any()
    jst.ingest_raw(jnp.asarray(j_ids), jnp.asarray(vals))
    pst.ingest_raw(torch.from_numpy(p_ids), torch.from_numpy(vals))
    _assert_same_store(jst, pst)
    rows, _, counts = pst.decode_cells()
    assert int(counts.sum()) == len(ids) and (rows == 15).any()


def test_store_spill_without_overflow_row_on_saturation():
    pair = _stores(m=16, pool=12, codec="dense")
    jst, pst = pair
    rng = np.random.default_rng(17)
    vals = _values(rng, 6 * 600, -6.0, 6.5)
    ids = np.repeat(np.arange(6, dtype=np.int32), 600)[: len(vals)]
    j_ids, j_sp = jst.prepare_batch(ids, vals)
    p_ids, p_sp = pst.prepare_batch(ids, vals)
    np.testing.assert_array_equal(p_ids, j_ids)
    assert p_sp == j_sp > 0 and (p_ids == -1).sum() == p_sp
    jst.ingest_raw(jnp.asarray(j_ids), jnp.asarray(vals))
    pst.ingest_raw(torch.from_numpy(p_ids), torch.from_numpy(vals))
    _assert_same_store(jst, pst)
    _, _, counts = pst.decode_cells(include_spill=True)
    assert int(counts.sum()) == len(ids)
    # the sparse route saturates the same way
    packed = np.array([[7, 3, 5], [8, -400, 2], [9, 500, 1]], np.int32)
    assert pst.commit(packed) == jst.commit(packed) == 8
    _assert_same_store(jst, pst)


def test_decode_and_spill_pool_equal_jax_as_multisets():
    pair = _stores(m=256)
    _raw_stream(pair, 2, 256, seed=9)
    jst, pst = pair

    def cells(st):
        rows, idx, counts = st.decode_cells()
        order = np.lexsort((idx, rows))
        return rows[order], idx[order], counts[order]

    for g, w in zip(cells(pst), cells(jst)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(pst.decode_dense(), jst.decode_dense())
    jst.spill_pool()
    pst.spill_pool()
    assert int(pst._pool.abs().sum()) == 0
    _assert_same_store(jst, pst)


def test_store_stats_and_query_equal_jax():
    pair = _stores(m=128)
    _raw_stream(pair, 2, 128, seed=10)
    jst, pst = pair
    ids = np.r_[np.arange(0, 128, 3), [5, 5, 127]]
    want, got = jst.query(ids, PS), pst.query(ids, PS)
    np.testing.assert_array_equal(got["counts"], want["counts"])
    np.testing.assert_allclose(got["sums"], want["sums"], rtol=2e-6)
    np.testing.assert_array_equal(
        compress_np(got["percentiles"]), compress_np(want["percentiles"]))
    np.testing.assert_allclose(got["percentiles"], want["percentiles"],
                               rtol=4e-6)
    want, got = jst.stats(PS, reset=False), pst.stats(PS, reset=False)
    np.testing.assert_array_equal(got["counts"], want["counts"])
    np.testing.assert_array_equal(got["percentiles"], want["percentiles"])
    np.testing.assert_allclose(got["sums"], want["sums"], rtol=1e-12)
    pst.stats(PS)  # reset
    assert int(pst._pool.abs().sum()) == 0 and not pst._host_spill


def test_store_grow_and_device_luts_follow_host_changes():
    pair = _stores(m=64)
    _raw_stream(pair, 1, 64, seed=11)
    jst, pst = pair
    rc, enc, tbl = pst.device_luts()
    assert pst.device_luts()[2] is tbl  # built once
    for st in pair:
        st.grow(96)
    _raw_stream(pair, 2, 96, seed=12)
    _assert_same_store(jst, pst)
    rc, enc, tbl = pst.device_luts()
    np.testing.assert_array_equal(tbl.numpy(), pst.page_table.T)
    np.testing.assert_array_equal(rc.numpy(), pst.row_codec)
    np.testing.assert_array_equal(enc.numpy(), np.asarray(jst.device_luts()[1]))


def test_page_major_mirror_follows_the_host_table():
    """K4f's page-major mirror, built on an empty table, equals the
    transposed host table after each batch's allocations: new rows take
    a codec (dirty rows), known rows map new pages (dirty pairs)."""
    pair = _stores(m=96)
    jst, pst = pair
    rc, enc, tbl = pst.device_luts()
    assert tbl.shape == (pst.pages_per_row, 96) and tbl.is_contiguous()
    assert (tbl == -1).all() and (rc == -1).all()
    rng = np.random.default_rng(41)
    for k in range(3):
        vals = _values(rng, 4000, -4.0 + k, 2.5 + 2 * k)
        ids = rng.integers(0, 32 * (k + 1), len(vals)).astype(np.int32)
        for st in pair:
            p_ids, _ = st.prepare_batch(ids, vals)
        before = int((tbl >= 0).sum())
        pst.ingest_raw(torch.from_numpy(p_ids), torch.from_numpy(vals))
        jst.ingest_raw(jnp.asarray(p_ids), jnp.asarray(vals))
        # updated in place
        assert all(a is b for a, b in zip(pst.device_luts(), (rc, enc, tbl)))
        assert int((tbl >= 0).sum()) > before
        np.testing.assert_array_equal(tbl.numpy(), pst.page_table.T)
        np.testing.assert_array_equal(
            tbl.numpy(), np.asarray(jst.device_luts()[2]).T)
        np.testing.assert_array_equal(rc.numpy(), pst.row_codec)
    _assert_same_store(jst, pst)
    assert (pst.row_codec[:96] >= 0).sum() == 96


# -- sparse_cells_stats --------------------------------------------------- #


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparse_cells_stats_equals_jax(seed):
    rng = np.random.default_rng(seed)
    m, n = 300, 20_000
    rows = rng.integers(0, m, n)
    rows[rows % 7 == 3] = 0  # rows 3, 10, ... stay empty
    idx = rng.integers(0, B, n)
    idx[: n // 10] = idx[n // 10: n // 5]  # duplicate cells fold
    counts = rng.integers(1, 1 << 20, n)
    counts[::97] = 1 << 40  # past int32
    ps = np.array([0.0, 1e-9, 0.5, 0.75, 0.9999, 1.0])
    want = jax_sparse_cells_stats(rows, idx, counts, m, ps, BL)
    got = sparse_cells_stats(rows, idx, counts, m, ps, BL)
    np.testing.assert_array_equal(got["counts"], want["counts"])
    np.testing.assert_array_equal(got["percentiles"], want["percentiles"])
    np.testing.assert_allclose(got["sums"], want["sums"], rtol=1e-12)
    assert (got["counts"][3::7] == 0).all()


def test_sparse_cells_stats_edges():
    ps = np.array([0.0, 0.5, 1.0])
    for rows, idx, counts, m in (
        ([], [], [], 4),                       # no cells
        ([0, 0, 5, -1], [3, 9, 1, 2], [2, 2, 7, 7], 4),  # rows out of range
        ([2], [1024], [1], 3),                 # one cell
    ):
        want = jax_sparse_cells_stats(rows, idx, counts, m, ps, BL)
        got = sparse_cells_stats(rows, idx, counts, m, ps, BL)
        for key in ("counts", "sums", "percentiles"):
            np.testing.assert_array_equal(got[key], want[key])


# -- dispatch ------------------------------------------------------------- #

GRID_M = [64, (1 << 16) - 1, 1 << 16, 1 << 20]
GRID_B = [129, 1025, 8193]
GRID_T = ["auto", "raw", "sparse"]


@pytest.mark.parametrize("fused_ok", [False, True])
@pytest.mark.parametrize("crossover", [True, False])
def test_paged_storage_incapability_equals_jax(fused_ok, crossover):
    for m in GRID_M:
        for b in GRID_B:
            for t in GRID_T:
                assert dispatch.paged_storage_incapability(
                    m, b, transport=t, crossover=crossover, fused_ok=fused_ok,
                ) == jdispatch.paged_storage_incapability(
                    m, b, transport=t, crossover=crossover, fused_ok=fused_ok,
                ), (m, b, t)


@pytest.mark.parametrize("platform,jax_platform", [
    ("cpu", "cpu"), ("cuda", "tpu"), (None, None)])
@pytest.mark.parametrize("crossover", [True, False])
def test_fused_paged_incapability_equals_jax(platform, jax_platform,
                                             crossover):
    edge = "platform: cpu — auto only picks the direct-to-paged fused kernel"
    for m in GRID_M:
        for b in GRID_B:
            for t in GRID_T:
                for bs in (None, 1024, 1 << 20):
                    got = dispatch.fused_paged_incapability(
                        m, b, batch_size=bs, transport=t, platform=platform,
                        crossover=crossover)
                    want = jdispatch.fused_paged_incapability(
                        m, b, batch_size=bs, transport=t,
                        platform=jax_platform, crossover=crossover)
                    if want is not None and want.startswith("platform:"):
                        # the planned departure: cuda where JAX has tpu
                        assert got.startswith(edge) and want.startswith(edge)
                        continue
                    if got is not None and platform == "cuda":
                        # and the card's own, swept batch crossover
                        got = got.replace(
                            str(dispatch.fused_min_batch_for("cuda")),
                            str(jdispatch.fused_min_batch_for("tpu")))
                    assert got == want, (m, b, t, bs)


def test_fused_min_batch_on_cuda():
    """The swept card value: K4f's route won from the smallest batch
    swept, 2^12 (chip_smoke.py transport_crossover)."""
    assert dispatch.fused_paged_incapability(
        1 << 20, 8193, batch_size=1 << 12, platform="cuda") is None
    reason = dispatch.fused_paged_incapability(
        1 << 20, 8193, batch_size=(1 << 12) - 1, platform="cuda")
    assert reason.startswith("batch too small:") and "4096" in reason


def test_resolve_storage_path_equals_jax():
    for m in GRID_M:
        for b in GRID_B:
            for t in GRID_T:
                for fused_ok in (False, True):
                    for storage in ("auto", "dense", "paged", "bogus"):
                        outs = []
                        for resolve, plat in (
                            (dispatch.resolve_storage_path, "cuda"),
                            (jdispatch.resolve_storage_path, "tpu"),
                        ):
                            try:
                                outs.append(resolve(storage, m, b, plat,
                                                    transport=t,
                                                    fused_ok=fused_ok))
                            except ValueError as e:
                                outs.append(("raised", str(e)))
                        assert outs[0] == outs[1], (m, b, t, storage)


def test_high_cardinality_default_resolves_paged():
    # on the card: TorchAggregator(num_metrics=1 << 20) -> paged + K4f
    reason = dispatch.fused_paged_incapability(
        1 << 20, 8193, batch_size=1 << 16, transport="auto", platform="cuda")
    assert reason is None
    assert dispatch.resolve_storage_path(
        "auto", 1 << 20, 8193, "cuda", transport="auto", fused_ok=True,
    ) == ("paged", None)
    # on the CPU: the JAX package's CPU route (paged, sparse, no fused)
    agg = TorchAggregator(num_metrics=1 << 20, device="cpu")
    assert (agg.storage, agg.transport, agg.ingest_path, agg.fused_paged) == (
        "paged", "sparse", "packed", False)
    assert agg.fused_paged_reason.startswith("platform: cpu")
    small = TorchAggregator(num_metrics=(1 << 16) - 1, device="cpu")
    assert small.storage == "dense" and small.ingest_path == "fused"
    assert small.storage_reason.startswith("below crossover:")
    with pytest.raises(ValueError, match="transport:"):
        TorchAggregator(num_metrics=64, storage="paged", transport="raw",
                        device="cpu")
    with pytest.raises(ValueError, match="row"):
        TorchAggregator(num_metrics=64, storage="paged", ingest_path="row",
                        device="cpu")


# -- the aggregator --------------------------------------------------------- #

NAMES = [f"svc{i}" for i in range(40)]


def _agg_pair(route, m=48, **kw):
    cfg = dict(storage="paged", batch_size=4096,
               paged_config=None, on_registry_full="grow", max_metrics=256)
    cfg.update(kw)
    jcfg = jpaging.PagedStoreConfig(pool_pages=POOL)
    pcfg = paging.PagedStoreConfig(pool_pages=POOL)
    extra = ({"transport": "sparse"} if route == "sparse"
             else {"transport": "raw", "ingest_path": "fused"})
    jax_agg = TPUAggregator(num_metrics=m, config=JaxConfig(bucket_limit=BL),
                            **{**cfg, "paged_config": jcfg}, **extra)
    port = TorchAggregator(num_metrics=m, config=MetricConfig(bucket_limit=BL),
                           device="cpu", **{**cfg, "paged_config": pcfg},
                           **extra)
    if route == "raw":
        assert jax_agg.fused_paged and port.fused_paged
        jax_agg.paged._fused_fn = jax.jit(
            lambda pool_, i, v, rc, enc, tbl: jfused.fused_paged_ingest_batch(
                pool_, i, v, rc, enc, tbl, BL, kernel="jnp"))
    return jax_agg, port


def _assert_same_metrics(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        if key.endswith(("_sum", "_avg")):
            assert got[key] == pytest.approx(w, rel=1e-12, abs=1e-9), key
        else:  # counts and percentiles: the same host float64 math
            assert got[key] == w, key


@pytest.mark.parametrize("route", ["sparse", "raw"])
def test_aggregator_equals_jax_across_growth(route):
    jax_agg, port = _agg_pair(route, m=16)
    rng = np.random.default_rng(21)
    try:
        for interval in range(3):
            # new names every interval: the registry grows 16 -> 64
            names = NAMES[: 16 + 12 * interval]
            ids = np.array([jax_agg._id_for(n) for n in names], np.int32)
            assert list(ids) == [port._id_for(n) for n in names]
            vals = _values(rng, 9000)
            pick = ids[rng.integers(0, len(ids), len(vals))]
            pick[::50] = -1
            for agg in (jax_agg, port):
                for off in range(0, len(vals), 2500):
                    agg.record_batch(pick[off:off + 2500],
                                     vals[off:off + 2500])
            _assert_same_metrics(port.collect().metrics,
                                 jax_agg.collect().metrics)
        assert port.num_metrics == jax_agg.num_metrics == 64
        assert port.transport == jax_agg.transport == route
        if route == "raw":
            assert port.paged.fused_dispatches > 0 and port.paged.commits == 0
        else:
            assert port.paged.commits > 0 and port.paged.fused_dispatches == 0
    finally:
        jax_agg.close()
        port.close()


@pytest.mark.parametrize("route", ["sparse", "raw"])
def test_aggregator_forced_spill_pool_equals_jax(route):
    jax_agg, port = _agg_pair(route, spill_threshold=3000)
    for name in NAMES[:20]:
        assert jax_agg.registry.id_for(name) == port.registry.id_for(name)
    rng = np.random.default_rng(22)
    try:
        for _ in range(2):
            vals = _values(rng, 10_000)
            ids = rng.integers(0, 20, len(vals)).astype(np.int32)
            for agg in (jax_agg, port):
                for off in range(0, len(vals), 4096):
                    agg.record_batch(ids[off:off + 4096], vals[off:off + 4096])
            port.flush(force=True)
            assert port.paged._host_spill  # the pool was folded out
            _assert_same_metrics(port.collect().metrics,
                                 jax_agg.collect().metrics)
    finally:
        jax_agg.close()
        port.close()


def test_paged_state_from_jax_then_collect_equals_jax():
    jax_agg, _ = _agg_pair("sparse")
    rng = np.random.default_rng(23)
    ids = np.array([jax_agg.registry.id_for(n) for n in NAMES[:30]], np.int32)
    try:
        for _ in range(2):
            vals = _values(rng, 8000)
            jax_agg.record_batch(ids[rng.integers(0, 30, len(vals))], vals)
            jax_agg.collect()  # the lifetime store fills
        vals = _values(rng, 8000)
        jax_agg.record_batch(ids[rng.integers(0, 30, len(vals))], vals)
        jax_agg.flush(force=True)
        st = jax_agg.paged
        st.spill_cells(np.array([4, 4]), np.array([100, 900]),
                       np.array([3, 1 << 33]))
        state = paged_state_from_jax(
            np.asarray(st._pool), st.page_table, st.row_codec,
            st._host_spill, st._free_lists, st.allocated_pages,
            jax_agg.registry.names(), jax_agg._agg, bucket_limit=BL,
        )
        port = TorchAggregator(
            num_metrics=8, config=MetricConfig(bucket_limit=BL),
            storage="paged", transport="sparse", device="cpu",
        )
        port.load_state_dict(state)
        assert port.paged.free_list() == st._free_lists[0]
        again = TorchAggregator(
            num_metrics=8, config=MetricConfig(bucket_limit=BL),
            storage="paged", transport="sparse", device="cpu",
        )
        again.load_state_dict(port.state_dict())
        want = jax_agg.collect().metrics
        _assert_same_metrics(port.collect().metrics, want)
        _assert_same_metrics(again.collect().metrics, want)
        with pytest.raises(ValueError, match="paged storage"):
            TorchAggregator(num_metrics=8, device="cpu",
                            config=MetricConfig(bucket_limit=BL),
                            storage="dense").load_state_dict(state)
        port.close()
        again.close()
    finally:
        jax_agg.close()
