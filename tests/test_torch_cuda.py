"""The Hopper kernels on the card, at small shapes, against their plain
PyTorch versions on the same CUDA tensors (int32 outputs EQUAL): K1, K2,
K3, K8 (the multirow layout accumulation, with one aggregator
interval on ``ingest_path="multirow"``), the paged pair K4 (triple
scatter) and K4f (direct-to-paged fused ingest), K5 (the retention
wheel's masked ring merge), K6 (the lifecycle's row repack, EQUAL) and
K7 (drift scores, within the float32 tolerance of
``tests/test_torch_anomaly.py``), plus one paged interval
through ``TorchAggregator``, a wheel, and a fused commit with lifecycle
and drift on the card.

These need an NVIDIA card and the CUDA toolkit (the kernels are built
with nvcc at first use), so they carry the ``cuda`` marker and skip
elsewhere.  On the card:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from loghisto_tpu_torch.ops.backend import kernel_launches
from loghisto_tpu_torch.ops.codec import compress_np, edge_values
from loghisto_tpu_torch.ops.fold import fold_packed_numpy, pack_cells
from loghisto_tpu_torch.ops.fused_ingest import (
    K1_CLUSTER,
    device_plan,
    fused_ingest_batch,
)
from loghisto_tpu_torch.ops.ingest import ingest_batch
from loghisto_tpu_torch.ops.multirow_ingest import (
    SAMPLE_TILE,
    device_clusters,
    histogram_runs,
    multirow_ingest,
    multirow_ingest_reference,
    preprocess,
)
from loghisto_tpu_torch.ops.row_ingest import (
    codec_check,
    histogram_row,
    histogram_row_reference,
    row_ingest_batch,
)
from loghisto_tpu_torch.ops.sparse_ingest import (
    MAX_TARGETS,
    sparse_ingest,
    sparse_ingest_batch,
    sparse_ingest_multi,
    sparse_ingest_multi_batch,
)
from loghisto_tpu_torch.ops.fused_ingest import (
    fused_paged_ingest_batch,
    fused_paged_ingest_reference,
)
from loghisto_tpu_torch.ops.paged_store import (
    paged_scatter,
    paged_scatter_batch,
)
from loghisto_tpu_torch.paging import PagedStore, PagedStoreConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on "
                    "the card")
    return torch.device("cuda")


def _batch(n, m, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-2, m + 2, n).astype(np.int32)
    values = (rng.lognormal(2, 3, n) * np.where(
        rng.random(n) < 0.3, -1, 1)).astype(np.float32)
    edge = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 3.4e38], np.float32)
    values[:6] = edge[:n]
    return ids, values


@pytest.mark.parametrize("m,bl", [(1, 64), (2, 64), (37, 64), (2, 4096),
                                  (5, 4096)])
def test_fused_kernel_equals_plain(dev, m, bl):
    ids, values = _batch(100_003, m, seed=m)
    ids_d, vals_d = torch.from_numpy(ids).to(dev), torch.from_numpy(values).to(dev)
    k = torch.zeros((m, 2 * bl + 1), dtype=torch.int32, device=dev)
    p = torch.zeros_like(k)
    before = kernel_launches()["fused_ingest"]
    fused_ingest_batch(k, ids_d, vals_d, bl)
    ingest_batch(p, ids_d, vals_d, bl)
    torch.cuda.synchronize()
    assert kernel_launches()["fused_ingest"] == before + 1
    assert torch.equal(k, p)


def _k1_equal(dev, m, bl, ids, values, offset=0):
    """K1 on ``ids[offset:]``, ``values[offset:]`` against the plain
    version: EQUAL; returns the kernel's accumulator."""
    ids_d = torch.from_numpy(ids).to(dev)[offset:]
    vals_d = torch.from_numpy(values).to(dev)[offset:]
    k = torch.zeros((m, 2 * bl + 1), dtype=torch.int32, device=dev)
    before = kernel_launches()["fused_ingest"]
    fused_ingest_batch(k, ids_d, vals_d, bl)
    torch.cuda.synchronize()
    assert kernel_launches()["fused_ingest"] == before + 1
    p = ingest_batch(torch.zeros_like(k), ids_d, vals_d, bl)
    assert torch.equal(k, p)
    return k


@pytest.mark.parametrize("n,rows", [(1 << 22, 64), (1 << 22, 4096),
                                    (1 << 23, 256)])
def test_fused_kernel_overflows_its_table(dev, n, rows):
    """Every warp holds 4 rows on 8 lanes each (all hot), the values
    spread over the whole bucket range: a cluster's samples fall on more
    than three times the distinct cells its 8 tables hold.  The cells that find no
    slot go to the global atomics; none is lost."""
    m, bl = 10_000, 4096
    rng = np.random.default_rng(n + rows)
    i = np.arange(n)
    ids = (((i // 32) * 4 + i % 4) % rows).astype(np.int32)
    values = (np.exp(rng.uniform(0.0, 40.0, n))
              * np.where(rng.random(n) < 0.5, -1, 1)).astype(np.float32)
    plan = device_plan(n, m, 2 * bl + 1, dev.index or 0)
    span = K1_CLUSTER * plan.chunk
    cols = np.clip(compress_np(values[:span]), -bl, bl).astype(np.int64)
    cells = np.unique(ids[:span].astype(np.int64) * (2 * bl + 1) + cols)
    assert len(cells) > 3 * K1_CLUSTER * (1 << plan.table_log2)
    k = _k1_equal(dev, m, bl, ids, values)
    assert int(k.sum()) == n


def test_fused_kernel_one_cell(dev):
    """2^20 samples on one cell: a warp folds them, each block's table
    takes one slot, each block adds once."""
    n, m, bl = 1 << 20, 9, 4096
    ids = np.full(n, 3, np.int32)
    values = np.full(n, 58.7, np.float32)
    k = _k1_equal(dev, m, bl, ids, values)
    assert int(k[3].max()) == n


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_fused_kernel_on_views(dev, offset):
    """``ids[offset:]`` and ``values[offset:]`` start off a 16-byte
    boundary; Zipf ids on two rows, edge values among them."""
    ids, values = _batch(200_003, 2, seed=40 + offset)
    _k1_equal(dev, 2, 4096, ids, values, offset=offset)


def test_fused_kernel_takes_64_bit_cells(dev):
    """A dense accumulator of M * B >= 2^31 cells (262,200 x 8193 int32,
    8.6 GB): the table keys are 64-bit and the rows past cell 2^31 are
    reached."""
    m, bl = 262_200, 4096
    b = 2 * bl + 1
    plan = device_plan(1 << 20, m, b, dev.index or 0)
    assert plan.key_bits == 64 and m * b >= 2**31
    rng = np.random.default_rng(62)
    n = 1 << 20
    ids = rng.integers(m - 300, m + 3, n).astype(np.int32)
    ids[::5] = rng.integers(-3, 100, len(ids[::5]))
    values = rng.lognormal(4.0, 2.0, n).astype(np.float32)
    k = _k1_equal(dev, m, bl, ids, values)
    assert int(k.view(-1)[2**31:].sum()) > 0
    del k
    torch.cuda.empty_cache()


def test_codec_edges_on_the_card(dev):
    bl = 4096
    edges = edge_values(bl)
    m = len(edges)
    acc = torch.zeros((m, 2 * bl + 1), dtype=torch.int32, device=dev)
    fused_ingest_batch(acc, torch.arange(m, dtype=torch.int32, device=dev),
                       torch.from_numpy(edges).to(dev), bl)
    want = np.clip(compress_np(edges), -bl, bl).astype(np.int64) + bl
    assert (acc.sum(dim=1) == 1).all()
    np.testing.assert_array_equal(acc.argmax(dim=1).cpu().numpy(), want)


@pytest.mark.parametrize("n", [4096, 100_003])
def test_row_kernel_equals_plain(dev, n):
    bl = 4096
    ids, values = _batch(n, 1, seed=n)
    ids_d, vals_d = torch.from_numpy(ids).to(dev), torch.from_numpy(values).to(dev)
    k = torch.zeros((1, 2 * bl + 1), dtype=torch.int32, device=dev)
    p = torch.zeros_like(k)
    row_ingest_batch(k, ids_d, vals_d, bl)
    histogram_row_reference(p[0], vals_d, bl, 100, ids_d)
    if n % 2048 == 0:
        histogram_row(k[0], vals_d, bl)
        histogram_row_reference(p[0], vals_d, bl, 100)
    torch.cuda.synchronize()
    assert torch.equal(k, p)


def _k2_equal(dev, ids, values, bl=4096, masked=True, offset=(0, 0)):
    """K2 (K2b with ids, K2a without) against histogram_row_reference;
    ``offset`` starts the ids and the values that many elements into
    their buffers."""
    ids_d = torch.from_numpy(ids).to(dev)[offset[0]:]
    vals_d = torch.from_numpy(values).to(dev)[offset[1]:]
    n = min(ids_d.shape[0], vals_d.shape[0])
    ids_d, vals_d = ids_d[:n], vals_d[:n]
    k = torch.zeros((1, 2 * bl + 1), dtype=torch.int32, device=dev)
    p = torch.zeros_like(k)
    before = kernel_launches()["row_ingest"]
    if masked:
        row_ingest_batch(k, ids_d, vals_d, bl)
        histogram_row_reference(p[0], vals_d, bl, 100, ids_d)
    else:
        histogram_row(k[0], vals_d, bl)
        histogram_row_reference(p[0], vals_d, bl, 100)
    torch.cuda.synchronize()
    assert kernel_launches()["row_ingest"] == before + 1
    assert torch.equal(k, p)
    return k


@pytest.mark.parametrize("masked", [True, False])
def test_row_kernel_one_bin_for_every_sample(dev, masked):
    n = 1 << 22
    k = _k2_equal(dev, np.zeros(n, np.int32), np.full(n, 58.7, np.float32),
                  masked=masked)
    assert int(k.max()) == n


@pytest.mark.parametrize("masked", [True, False])
def test_row_kernel_over_the_whole_float_range(dev, masked):
    """Uniform float32 bit patterns: every exponent, both signs, NaN,
    infinities, subnormals; ids 0 on about half."""
    n = 1 << 21
    rng = np.random.default_rng(21)
    values = rng.integers(0, 2**32, n, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    ids = rng.integers(0, 2, n).astype(np.int32)
    _k2_equal(dev, ids, values, masked=masked)


@pytest.mark.parametrize("n,masked", [(1, True), (2047, True),
                                      ((1 << 24) - 2049, True),
                                      (2048, False),
                                      ((1 << 24) - 2048, False)])
def test_row_kernel_at_the_size_limits(dev, n, masked):
    """The largest K2b batch is 2^24 - 2049: the reference pads N to a
    multiple of 2048 and refuses 2^24 (so 2^24 - 1 raises, as there)."""
    rng = np.random.default_rng(n)
    ids = np.where(rng.random(n) < 0.2, -1, 0).astype(np.int32)
    values = rng.lognormal(4, 2, n).astype(np.float32)
    _k2_equal(dev, ids, values, masked=masked)
    if n == (1 << 24) - 2049:
        big = torch.zeros(1 << 24, dtype=torch.float32, device=dev)
        acc = torch.zeros((1, 8193), dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="2\\^24"):
            row_ingest_batch(acc, big[:-1].int(), big[:-1], 4096)


@pytest.mark.parametrize("offset", [(1, 1), (3, 3), (1, 2), (0, 3)])
def test_row_kernel_on_views_off_a_16_byte_line(dev, offset):
    """Ragged heads and tails; ids and values at different offsets of a
    16-byte line take one sample a thread."""
    n = 100_003
    rng = np.random.default_rng(sum(offset))
    ids = np.where(rng.random(n) < 0.2, 1, 0).astype(np.int32)
    values = rng.lognormal(4, 2, n).astype(np.float32)
    _k2_equal(dev, ids, values, offset=offset)


def test_table_codec_on_a_slice_of_every_float32(dev):
    """2^28 consecutive float32 bit patterns (every positive value from
    2^-27 to 2^5, buckets 0 to 350) through K2's table codec and the
    float64 codec: no mismatch."""
    mismatches, table_reads = codec_check(0x32000000, 1 << 28, 4096)
    assert mismatches == 0
    assert table_reads > 0


@pytest.mark.parametrize("m,rows_tile,n", [(16, 8, 100_003), (64, 16, 5000),
                                           (4000, 8, 1), (8, 8, 0)])
def test_multirow_kernel_equals_plain(dev, m, rows_tile, n):
    """K8 against its plain version on the same layout, and the whole
    step against K1's plain version; one launch per non-empty layout."""
    bl = 4096
    ids, values = _batch(n, m, seed=n + m)
    ids_d, vals_d = torch.from_numpy(ids).to(dev), torch.from_numpy(values).to(dev)
    rows, bidx, tb = preprocess(ids_d, vals_d, m, rows_tile, bl)
    k = torch.zeros((m, 2 * bl + 1), dtype=torch.int32, device=dev)
    p, s = torch.zeros_like(k), torch.zeros_like(k)
    before = kernel_launches()["multirow_ingest"]
    multirow_ingest(k, rows, bidx, tb, rows_tile)
    multirow_ingest_reference(p, rows, bidx, tb, rows_tile)
    ingest_batch(s, ids_d, vals_d, bl)
    torch.cuda.synchronize()
    assert kernel_launches()["multirow_ingest"] == before + 1
    assert torch.equal(k, p)
    assert torch.equal(k, s)


def _k8_three_ways(dev, m, rows_tile, bl, ids, values, layout=None):
    """K8 on the layout of (ids, values) (or ``layout``) against its
    plain version and against K1 on the samples: all EQUAL; returns the
    layout's tile_block."""
    ids_d = torch.from_numpy(ids).to(dev)
    vals_d = torch.from_numpy(values).to(dev)
    if layout is None:
        layout = preprocess(ids_d, vals_d, m, rows_tile, bl)
    rows, bidx, tb = (t.to(dev) for t in layout)
    k = torch.zeros((m, 2 * bl + 1), dtype=torch.int32, device=dev)
    p, s = torch.zeros_like(k), torch.zeros_like(k)
    before = kernel_launches()["multirow_ingest"]
    multirow_ingest(k, rows, bidx, tb, rows_tile)
    multirow_ingest_reference(p, rows, bidx, tb, rows_tile)
    fused_ingest_batch(s, ids_d, vals_d, bl)
    torch.cuda.synchronize()
    assert kernel_launches()["multirow_ingest"] == before + 1
    assert torch.equal(k, p)
    assert torch.equal(k, s)
    return tb.cpu().numpy()


@pytest.mark.parametrize("rows_tile", [4, 8, 16])
def test_multirow_hot_run_crosses_the_cluster_ranges(dev, rows_tile):
    """2^22 samples, 90% of them in row block 0: a run of ~1800 tiles
    over many clusters' ranges, each of which adds its part through
    its cluster histogram."""
    m, bl, n = 64, 4096, 1 << 22
    rng = np.random.default_rng(rows_tile)
    ids = np.where(rng.random(n) < 0.9, rng.integers(0, rows_tile, n),
                   rng.integers(-2, m + 2, n)).astype(np.int32)
    values = rng.lognormal(4, 2, n).astype(np.float32)
    tb = _k8_three_ways(dev, m, rows_tile, bl, ids, values)
    clusters, span, fits = device_clusters(len(tb), rows_tile, 2 * bl + 1)
    runs = histogram_runs(tb, clusters, span, rows_tile, m, fits)
    assert fits and clusters > 1 and len(runs) >= 2


def test_multirow_run_touches_every_cell_of_its_block(dev):
    """One run over 8 rows x 8193 buckets, values over the whole bucket
    range: 65,544 distinct cells, every one held by the cluster
    histogram (no table to overflow)."""
    m, bl, n = 16, 4096, 1 << 21
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 8, n).astype(np.int32)
    values = (np.exp(rng.uniform(0, 90, n)) * np.where(
        rng.random(n) < 0.5, -1, 1)).astype(np.float32)
    _k8_three_ways(dev, m, 8, bl, ids, values)
    cols = np.clip(compress_np(values), -bl, bl).astype(np.int64)
    assert len(np.unique(ids.astype(np.int64) * (2 * bl + 1) + cols)) > 60_000


def test_multirow_one_cell_repeated_in_one_run(dev):
    n, m, bl = 1 << 22, 8, 4096
    ids = np.full(n, 5, np.int32)
    values = np.full(n, 58.7, np.float32)
    _k8_three_ways(dev, m, 8, bl, ids, values)


@pytest.mark.parametrize("rows_tile", [4, 8, 16])
def test_multirow_filler_inside_tiles_and_revisited_blocks(dev, rows_tile):
    """The layout's tiles in a random order (blocks revisited after
    others, the hot block's run cut into pieces) and every tile's
    entries shuffled (filler anywhere inside a tile)."""
    m, bl, n = 64, 4096, 1 << 20
    rng = np.random.default_rng(50 + rows_tile)
    ids = np.where(rng.random(n) < 0.7, rng.integers(0, rows_tile, n),
                   rng.integers(-2, m + 2, n)).astype(np.int32)
    values = rng.lognormal(4, 2, n).astype(np.float32)
    rows, bidx, tb = preprocess(torch.from_numpy(ids),
                                torch.from_numpy(values), m, rows_tile, bl)
    g = tb.shape[0]
    # keep runs: pieces of 40 consecutive tiles move together, so the hot
    # block's pieces still take the cluster histogram
    order = torch.from_numpy(np.concatenate([
        np.arange(a, min(a + 40, g)) for a in rng.permutation(
            np.arange(0, g, 40))]))
    rows = rows.view(g, SAMPLE_TILE)[order]
    bidx = bidx.view(g, SAMPLE_TILE)[order]
    shuffle = torch.from_numpy(np.argsort(rng.random((g, SAMPLE_TILE)), 1))
    rows = torch.gather(rows, 1, shuffle).reshape(-1)
    bidx = torch.gather(bidx, 1, shuffle).reshape(-1)
    tb = tb[order]
    assert (np.diff(tb.numpy()) < 0).any()
    tb_np = _k8_three_ways(dev, m, rows_tile, bl, ids, values,
                           (rows, bidx, tb))
    clusters, span, fits = device_clusters(g, rows_tile, 2 * bl + 1)
    assert histogram_runs(tb_np, clusters, span, rows_tile, m, fits)


def test_multirow_aggregator_interval_on_the_card(dev):
    from loghisto_tpu_torch.ops.backend import reset_kernel_launches
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    reset_kernel_launches()
    agg = TorchAggregator(num_metrics=16, ingest_path="multirow",
                          transport="raw", batch_size=4096)
    ids, values = _batch(20_000, 16, seed=5)
    for i in range(16):
        agg.registry.id_for(f"m{i}")
    agg.record_batch(ids, values)
    metrics = agg.collect().metrics
    agg.close()
    assert kernel_launches()["multirow_ingest"] == 5  # one per chunk
    keep = (ids >= 0) & (ids < 16)
    for i in range(16):
        assert metrics.get(f"m{i}_count", 0.0) == float((ids[keep] == i).sum())


def test_sparse_kernel_equals_plain(dev):
    m, bl = 50, 4096
    ids, values = _batch(200_000, m, seed=7)
    packed = fold_packed_numpy(ids, values, bl)
    pad = np.zeros((100, 3), np.int32)
    pad[:, 0] = -1
    packed = np.concatenate([packed, pad, [[0, 9 * bl, 2], [m, 0, 3]]])
    packed_d = torch.from_numpy(packed.astype(np.int32)).to(dev)
    k = torch.zeros((m, 2 * bl + 1), dtype=torch.int32, device=dev)
    p = torch.zeros_like(k)
    sparse_ingest(k, packed_d, bl)
    sparse_ingest_batch(p, packed_d, bl)
    torch.cuda.synchronize()
    assert torch.equal(k, p)


def _multi_triples(rng, n, bl, m_max):
    """n triples with split-count duplicates (adjacent), count-0 rows,
    ids -1, -7, at and past every target's rows and 2^30, buckets past
    +/-bl."""
    ids = rng.integers(-2, m_max + 3, n)
    ids[5::11] = 2**30
    buckets = rng.integers(-bl - 9, bl + 10, n)
    counts = rng.integers(1, 20, n)
    packed = pack_cells(ids, buckets, counts, cap=5)[:n].copy()
    packed[3::7, 2] = 0
    packed[6::13, 0] = -7
    return packed


def _multi_targets(rng, bl, dev):
    """Four targets of 9, 5 (a ring-slot view), 12 and 1 rows with
    nonzero contents; returns (targets, ring)."""
    b = 2 * bl + 1
    ring = torch.from_numpy(rng.integers(0, 9, (3, 5, b)).astype(
        np.int32)).to(dev)
    t = [torch.from_numpy(rng.integers(0, 9, (m, b)).astype(np.int32)).to(dev)
         for m in (9, 12, 1)]
    return [t[0], ring[1], t[1], t[2]], ring


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 511, 512, 513,
                               1031, 300_007])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_sparse_multi_kernel_equals_plain(dev, n, offset):
    """One launch into four targets of different row counts, from a view
    0-3 triples into its buffer (4 to 12 bytes off a 16-byte boundary),
    EQUAL to the plain version once per target."""
    bl = 64
    rng = np.random.default_rng(n + offset)
    buf = torch.from_numpy(_multi_triples(rng, n + offset, bl, 12)).to(dev)
    packed = buf[offset:]
    targets, ring = _multi_targets(rng, bl, dev)
    plain = [t.clone() for t in targets]
    ring_before = ring.clone()
    before = kernel_launches()["sparse_ingest"]
    sparse_ingest_multi(targets, packed, bl)
    sparse_ingest_multi_batch(plain, packed, bl)
    torch.cuda.synchronize()
    assert kernel_launches()["sparse_ingest"] == before + 1
    for got, want in zip(targets, plain):
        assert torch.equal(got, want)
    assert torch.equal(ring[0], ring_before[0])
    assert torch.equal(ring[2], ring_before[2])


def test_sparse_multi_kernel_past_one_launch_of_targets(dev):
    bl = 64
    rng = np.random.default_rng(3)
    packed = torch.from_numpy(_multi_triples(rng, 50_000, bl, 12)).to(dev)
    targets = [torch.zeros((m, 2 * bl + 1), dtype=torch.int32, device=dev)
               for m in range(3, MAX_TARGETS + 5)]
    before = kernel_launches()["sparse_ingest"]
    sparse_ingest_multi(targets, packed, bl)
    torch.cuda.synchronize()
    assert kernel_launches()["sparse_ingest"] == before + 2
    for t in targets:
        assert torch.equal(t, sparse_ingest_batch(torch.zeros_like(t),
                                                  packed, bl))


def test_sparse_multi_kernel_back_to_back_without_sync(dev):
    """Forty launches queued with no synchronisation, each from its own
    upload out of pinned memory: every target holds the forty scatters."""
    bl = 256
    rng = np.random.default_rng(14)
    targets, _ = _multi_targets(rng, bl, dev)
    plain = [t.clone() for t in targets]
    uploads = []
    for k in range(40):
        host = torch.from_numpy(_multi_triples(rng, 20_000 + k, bl, 12))
        uploads.append(host.pin_memory().to(dev, non_blocking=True))
        sparse_ingest_multi(targets, uploads[-1][k % 4:], bl)
    torch.cuda.synchronize()
    for k, packed in enumerate(uploads):
        sparse_ingest_multi_batch(plain, packed[k % 4:], bl)
    for got, want in zip(targets, plain):
        assert torch.equal(got, want)


def _k4_triples(rng, n, pages, page=256):
    """(slot, offset, count) triples with every pad K4 drops: slot -1,
    the zero page, slots >= P, count 0; offsets outside the page clip."""
    packed = np.stack([
        rng.integers(1, pages, n), rng.integers(0, page, n),
        rng.integers(1, 50, n)], axis=1).astype(np.int32)
    kind = rng.integers(0, 8, n)
    packed[kind == 0, 0] = -1
    packed[kind == 1, 0] = 0
    packed[kind == 2, 0] = pages + rng.integers(0, 3, (kind == 2).sum())
    packed[kind == 3, 2] = 0
    packed[kind == 4, 1] = rng.choice([-7, -1, page, page + 9],
                                      (kind == 4).sum())
    return packed


def _k4_equal(dev, pool_k, packed_d):
    p = pool_k.clone()
    before = kernel_launches()["paged_scatter"]
    paged_scatter(pool_k, packed_d)
    paged_scatter_batch(p, packed_d)
    torch.cuda.synchronize()
    assert kernel_launches()["paged_scatter"] == before + 1
    assert torch.equal(pool_k, p) and not pool_k[0].any()


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 511, 512, 513])
@pytest.mark.parametrize("offset", [0, 1])
def test_paged_scatter_kernel_ragged_ends_and_views(dev, n, offset):
    """Launches that end inside a thread's four triples and inside a
    block's 512, from ``packed[offset:]`` (``packed[1:]`` starts 12
    bytes in, off a 16-byte boundary)."""
    rng = np.random.default_rng(100 * n + offset)
    buf = torch.from_numpy(_k4_triples(rng, n + offset, 40)).to(dev)
    pool = torch.zeros((40, 256), dtype=torch.int32, device=dev)
    _k4_equal(dev, pool, buf[offset:])


def test_paged_scatter_kernel_one_cell(dev):
    """One cell 2^16 times among random triples."""
    rng = np.random.default_rng(16)
    packed = _k4_triples(rng, 50_000, 300)
    hot = np.tile(np.array([[5, 17, 1]], np.int32), (1 << 16, 1))
    packed = np.concatenate([packed[:20_000], hot, packed[20_000:]])
    pool = torch.zeros((300, 256), dtype=torch.int32, device=dev)
    _k4_equal(dev, pool, torch.from_numpy(packed).to(dev))
    assert int(pool[5, 17]) >= 1 << 16


def test_paged_scatter_kernel_back_to_back_without_sync(dev):
    """Forty launches queued with no synchronisation, each from its own
    upload out of pinned memory: the pool holds the forty scatters."""
    rng = np.random.default_rng(41)
    pool = torch.zeros((500, 256), dtype=torch.int32, device=dev)
    plain = torch.zeros_like(pool)
    uploads = []
    for k in range(40):
        host = torch.from_numpy(_k4_triples(rng, 20_000 + k, 500))
        uploads.append(host.pin_memory().to(dev, non_blocking=True))
        paged_scatter(pool, uploads[-1][k % 4:])
    torch.cuda.synchronize()
    for k, packed in enumerate(uploads):
        paged_scatter_batch(plain, packed[k % 4:])
    assert torch.equal(pool, plain) and not pool[0].any()


def test_paged_scatter_kernel_equals_plain(dev):
    rng = np.random.default_rng(11)
    pages, page, n = 300, 256, 200_000
    packed = np.stack([
        rng.integers(-3, pages + 3, n), rng.integers(-9, page + 9, n),
        rng.integers(0, 50, n)], axis=1).astype(np.int32)
    packed[::13, 0] = 0  # the zero page is never written
    packed_d = torch.from_numpy(packed).to(dev)
    k = torch.zeros((pages, page), dtype=torch.int32, device=dev)
    p = torch.zeros_like(k)
    before = kernel_launches()["paged_scatter"]
    paged_scatter(k, packed_d)
    paged_scatter_batch(p, packed_d)
    torch.cuda.synchronize()
    assert kernel_launches()["paged_scatter"] == before + 1
    assert torch.equal(k, p) and not k[0].any()


@pytest.mark.parametrize("codec", ["auto", "dense", "loglinear", "polytail"])
def test_fused_paged_kernel_equals_plain(dev, codec):
    m, bl = 200, 4096
    ids, values = _batch(300_000, m, seed=21)
    store = PagedStore(m, bl, config=PagedStoreConfig(
        pool_pages=2048, codec=codec), device=dev)
    out_ids, _ = store.prepare_batch(ids, values)
    out_ids[:100] = -1
    luts = store.device_luts()
    ids_d = torch.from_numpy(out_ids).to(dev)
    vals_d = torch.from_numpy(values).to(dev)
    k = torch.zeros_like(store._pool)
    p = torch.zeros_like(k)
    before = kernel_launches()["fused_paged_ingest"]
    fused_paged_ingest_batch(k, ids_d, vals_d, *luts, bl)
    fused_paged_ingest_reference(p, ids_d, vals_d, *luts, bl)
    torch.cuda.synchronize()
    assert kernel_launches()["fused_paged_ingest"] == before + 1
    assert torch.equal(k, p)
    assert int(k.sum()) == int((out_ids >= 0).sum() - (out_ids >= m).sum())


@pytest.mark.parametrize("offset", [0, 1])  # 16 B aligned: vector loads
def test_fused_paged_kernel_folds_a_hot_cell(dev, offset):
    """A warp of equal cells folds into one atomic per step; ids and
    values that start off a 16 B boundary take the scalar loads."""
    m, bl = 64, 4096
    ids, values = _batch(1 << 16, m, seed=22)
    ids = np.abs(ids) % m
    ids[1000:1000 + 20_000] = 7
    values[1000:1000 + 20_000] = 123.0
    store = PagedStore(m, bl, config=PagedStoreConfig(pool_pages=4096),
                       device=dev)
    out_ids, _ = store.prepare_batch(ids.astype(np.int32), values)
    luts = store.device_luts()
    ids_d = torch.from_numpy(out_ids).to(dev)[offset:]
    vals_d = torch.from_numpy(values).to(dev)[offset:]
    k = torch.zeros_like(store._pool)
    p = torch.zeros_like(k)
    fused_paged_ingest_batch(k, ids_d, vals_d, *luts, bl)
    fused_paged_ingest_reference(p, ids_d, vals_d, *luts, bl)
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    assert int(k.max()) >= 20_000


def test_paged_aggregator_interval_on_the_card(dev):
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    agg = TorchAggregator(num_metrics=1 << 16, batch_size=1 << 16)
    assert agg.storage == "paged" and agg.fused_paged
    ids, values = _batch(1 << 18, 1 << 16, seed=5)
    ids = np.abs(ids) % (1 << 16)
    for name in ("a", "b"):
        agg.registry.id_for(name)
    agg.record_batch(ids.astype(np.int32), values)
    m = agg.collect().metrics
    agg.close()
    assert m["a_count"] == float((ids == 0).sum())
    assert agg.paged.fused_dispatches >= 4


# -- K5: the masked ring merge of the retention wheel -----------------------


@pytest.mark.parametrize("shape", [(7, 64, 129), (5, 999, 129), (3, 1, 3)])
@pytest.mark.parametrize("kind", ["all", "empty", "single", "wrapped",
                                  "random"])
def test_window_merge_kernel_equals_plain(dev, shape, kind):
    from loghisto_tpu_torch.ops.window import (
        window_merge,
        window_merge_kernel,
    )

    s = shape[0]
    rng = np.random.default_rng(11)
    ring = torch.from_numpy(
        rng.integers(-(1 << 20), 1 << 20, shape).astype(np.int32)).to(dev)
    mask = {
        "all": np.ones(s, bool), "empty": np.zeros(s, bool),
        "single": np.eye(s, dtype=bool)[s // 2],
        "wrapped": np.isin(np.arange(s), [s - 1, 0, 1]),
        "random": rng.random(s) < 0.5,
    }[kind]
    before = kernel_launches()["window_merge"]
    got = window_merge_kernel(ring, mask)
    want = window_merge(ring, mask)
    torch.cuda.synchronize()
    assert kernel_launches()["window_merge"] == before + 1
    assert torch.equal(got, want)


def test_window_merge_kernel_wraps_int32(dev):
    from loghisto_tpu_torch.ops.window import window_merge_kernel

    ring = torch.zeros((3, 4, 129), dtype=torch.int32, device=dev)
    ring[:2, 0, 5] = (1 << 30) + 5
    ring[:, 1, 7] = 2**31 - 1
    got = window_merge_kernel(ring, np.ones(3, bool)).cpu().numpy()
    assert got[0, 5] == -(1 << 31) + 10
    assert got[1, 7] == np.int32(np.int64(3 * (2**31 - 1)) % 2**32 - 2**32)


def test_window_merge_kernel_refuses_what_it_cannot_take(dev):
    """A ring of more than 1000 slots is taken (the plan rides a device
    buffer, not the launch arguments); a mask on the card is refused."""
    from loghisto_tpu_torch.ops.window import (
        window_merge,
        window_merge_kernel,
    )

    ring = torch.arange(1001 * 3, dtype=torch.int32, device=dev).reshape(
        1001, 1, 3)
    mask = np.ones(1001, bool)
    assert torch.equal(window_merge_kernel(ring, mask),
                       window_merge(ring, mask))
    with pytest.raises(ValueError, match="host array"):
        window_merge_kernel(ring[:2], torch.ones(2, dtype=torch.bool,
                                                 device=dev))


def _views_1440(kind, s, rng):
    from loghisto_tpu_torch.window.store import trailing_mask

    if kind == "random":
        return rng.random((6, s)) < 0.4
    written = rng.random(s) < 0.97
    slot = int(rng.integers(0, s))
    written[slot] = True
    return np.stack([
        trailing_mask(written, np.ones(s), slot, 1, s, w)
        for w in (np.inf, 1.0, 5.0, 30.0, 60.0, 3600.0)])


@pytest.mark.parametrize("rows", [3, 4])  # M*B odd: scalar; % 4 == 0: bulk
@pytest.mark.parametrize("kind", ["nested", "random"])
def test_window_merge_views_equal_plain_at_1440_slots(dev, rows, kind):
    from loghisto_tpu_torch.ops.window import (
        window_merge,
        window_merge_views,
    )

    s = 1440
    rng = np.random.default_rng(12)
    ring = torch.from_numpy(rng.integers(
        -(1 << 30), 1 << 30, (s, rows, 129)).astype(np.int32)).to(dev)
    masks = _views_1440(kind, s, rng)
    before = kernel_launches()["window_merge"]
    got = window_merge_views(ring, masks)
    want = torch.stack([window_merge(ring, m) for m in masks])
    torch.cuda.synchronize()
    assert kernel_launches()["window_merge"] == before + 1
    assert torch.equal(got, want)


def test_window_merge_views_back_to_back_without_sync(dev):
    """Forty launches queued with no synchronisation, each with its own
    plan from pinned memory: no plan is overwritten before its copy."""
    from loghisto_tpu_torch.ops.window import (
        window_merge,
        window_merge_views,
    )

    rng = np.random.default_rng(13)
    ring = torch.from_numpy(rng.integers(
        0, 1 << 16, (24, 256, 1025)).astype(np.int32)).to(dev)
    plans = [rng.random((4, 24)) < 0.5 for _ in range(40)]
    outs = [window_merge_views(ring, masks) for masks in plans]
    torch.cuda.synchronize()
    for masks, got in zip(plans, outs):
        for v, mask in enumerate(masks):
            assert torch.equal(got[v], window_merge(ring, mask))


def test_wheel_on_the_card_serves_snapshots_through_k5(dev):
    import datetime as dt

    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.window.store import TimeWheel

    wheel = TimeWheel(num_metrics=8, config=MetricConfig(bucket_limit=64),
                      tiers=((4, 1), (3, 2)))
    wheel.pin_window(2.0)
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    before = kernel_launches()
    for i in range(7):
        wheel.push(RawMetricSet(t0, {}, {"req": 3}, {
            "a": {1: 2 + i, 40: 1}, "b": {-3: 5, 70: i}}, {}, 1.0))
    after = kernel_launches()
    # per push: one K3 for every tier, one K5 per tier for both its views
    assert after["sparse_ingest"] - before["sparse_ingest"] == 7 * 1
    assert after["window_merge"] - before["window_merge"] == 7 * 2
    for window in (2.0, None):
        served = wheel.query("*", window)
        oracle = wheel._query_recompute("*", served.window_s, (0.5, 0.9, 0.99,
                                                               0.999),
                                        served.tier)
        assert served.metrics == oracle.metrics
    assert wheel.query("a", 2.0).metrics["a"]["count"] == (2 + 5 + 1) + (
        2 + 6 + 1)


# -- K6: the lifecycle's row repack ------------------------------------------


@pytest.mark.parametrize("shape,dtype", [((64, 129), torch.int32),
                                         ((5, 999, 129), torch.int32),
                                         ((3, 40, 129), torch.float32),
                                         ((2, 33, 1), torch.float32)])
def test_compact_rows_kernel_equals_plain(dev, shape, dtype):
    from loghisto_tpu_torch.ops.commit import DROP_ID
    from loghisto_tpu_torch.ops.lifecycle import (
        compact_rows,
        compact_rows_kernel,
    )

    rng = np.random.default_rng(17)
    arr = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, shape)).to(
        dtype).to(dev)
    m = shape[-2]
    perm = rng.permutation(m).astype(np.int32)
    holes = rng.random(m) < 0.4
    perm[holes] = rng.choice([-1, int(DROP_ID), m, m + 7, -(2**31)],
                             int(holes.sum()))
    before = kernel_launches()["compact_rows"]
    got = compact_rows_kernel(arr, perm)
    want = compact_rows(arr, perm)
    torch.cuda.synchronize()
    assert kernel_launches()["compact_rows"] == before + 1
    assert got.data_ptr() != arr.data_ptr()
    assert torch.equal(got, want)


# -- K7: drift scores ---------------------------------------------------------


@pytest.mark.parametrize("m,bl", [(37, 64), (8, 4096)])
def test_divergence_kernel_equals_plain(dev, m, bl):
    from loghisto_tpu_torch.ops.anomaly import (
        divergence_kernel,
        divergence_plain,
    )

    b = 2 * bl + 1
    rng = np.random.default_rng(m)
    bins = rng.integers(0, 50, (m, b)).astype(np.int32)
    bins[3] = 0
    bins[3, b // 2] = 99  # a one-hot live pmf
    cdf = np.cumsum(bins, axis=1, dtype=np.int32)
    counts = bins.sum(axis=1).astype(np.int32)
    counts[0] = 0  # masked: count 0
    w = rng.random(m - 2).astype(np.float32) + 0.1  # bank of m - 2 rows
    pmf = rng.random((m - 2, b)) ** 4
    prof = (pmf / pmf.sum(axis=1, keepdims=True) * w[:, None]).astype(
        np.float32)
    w[1] = 0.0  # masked: no baseline
    prof[2] = bins[2] / bins[2].sum()
    w[2] = 1.0  # identical shapes: ks ~ 0
    t = [torch.from_numpy(x).to(dev) for x in (cdf, counts, prof, w)]
    before = kernel_launches()["divergence"]
    got = divergence_kernel(*t, 5)
    want = divergence_plain(*t, 5)
    torch.cuda.synchronize()
    assert kernel_launches()["divergence"] == before + 1
    tol = {"ks": (0, 2e-6), "jsd": (0, 1e-5), "emd": (1e-4, b * 2.0**-23)}
    for key, (rtol, atol) in tol.items():
        g, w_ = got[key].cpu().numpy(), want[key].cpu().numpy()
        np.testing.assert_allclose(g, w_, rtol=rtol, atol=atol, err_msg=key)
        assert g[0] == 0 and g[1] == 0 and (g[m - 2:] == 0).all()
    assert got["ks"][2] < 2e-6


def _k7_edge_inputs(m, b, mb, seed):
    """Rows whose live and baseline supports straddle K7's 896-column
    tile edges, one-hot rows at the first and last column, a subnormal
    baseline entry; a bank of mb rows, given as bank 1 of a 2-bank
    array so that its rows start off 16-byte boundaries."""
    tile = 896
    rng = np.random.default_rng(seed)
    cols = np.arange(b)
    bins = rng.integers(0, 3, (m, b)) * (rng.random((m, b)) < 0.05)
    pmf = rng.random((mb, b)) ** 8
    for r in range(m):
        edge = min(tile * (1 + r % 9), b - 1)
        live = slice(max(edge - 2 - r, 0), min(edge + 3 + 2 * r, b))
        bins[r, live] += rng.integers(1, 60, live.stop - live.start)
        if r < mb:
            pmf[r] += np.exp(-0.5 * ((cols - edge + 3 * r) / (2 + r)) ** 2)
    bins[m - 1, :] = 0
    bins[m - 1, b - 1] = 40  # a lone last column
    if m > 2:
        bins[m - 2, :] = 0
        bins[m - 2, 0] = 40  # a lone first column
    cdf = np.cumsum(bins, axis=1).astype(np.int32)
    counts = bins.sum(axis=1).astype(np.int32)
    w = rng.random(mb).astype(np.float32) + 0.1
    prof = (pmf / pmf.sum(axis=1, keepdims=True) * w[:, None]).astype(
        np.float32)
    prof[0, b // 2] = np.finfo(np.float32).smallest_subnormal
    if m > 3:
        counts[1] = 0      # masked: count 0
    if mb > 3:
        w[2] = 0.0         # masked: no baseline
    banks = np.zeros((2, mb, b), np.float32)
    banks[1] = prof
    return cdf, counts, banks, w


@pytest.mark.parametrize("m,b,mb", [(1, 3, 1), (6, 3, 4), (1, 8193, 1),
                                    (12, 129, 9), (11, 2049, 11),
                                    (21, 8193, 17), (20, 8193, 20)])
def test_divergence_kernel_across_tile_edges(dev, m, b, mb):
    from loghisto_tpu_torch.ops.anomaly import (
        divergence_kernel,
        divergence_plain,
    )

    cdf, counts, banks, w = _k7_edge_inputs(m, b, mb, seed=m * b)
    cdf_d, counts_d, w_d = (torch.from_numpy(x).to(dev)
                            for x in (cdf, counts, w))
    prof_d = torch.from_numpy(banks).to(dev)[1]
    before = kernel_launches()["divergence"]
    got = divergence_kernel(cdf_d, counts_d, prof_d, w_d, 5)
    want = divergence_plain(cdf_d, counts_d, prof_d, w_d, 5)
    torch.cuda.synchronize()
    assert kernel_launches()["divergence"] == before + 1
    tol = {"ks": (0, 2e-6), "jsd": (0, 1e-5), "emd": (1e-4, b * 2.0**-23)}
    for key, (rtol, atol) in tol.items():
        g, w_ = got[key].cpu().numpy(), want[key].cpu().numpy()
        np.testing.assert_allclose(g, w_, rtol=rtol, atol=atol, err_msg=key)
        masked = (counts < 5) | (np.pad(w, (0, m - min(m, mb)))[:m] <= 0)
        assert (g[masked] == 0).all() and (w_[masked] == 0).all()
        assert (g[mb:] == 0).all()


def test_fused_commit_with_lifecycle_and_drift_on_the_card(dev):
    import datetime as dt

    from loghisto_tpu_torch.anomaly import AnomalyConfig
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.lifecycle import LifecycleConfig
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.system import TorchMetricSystem

    ms = TorchMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=16,
        config=MetricConfig(bucket_limit=64), retention=((4, 1), (3, 2)),
        lifecycle=LifecycleConfig(ttl_intervals=1, check_every=1,
                                  auto_compact_fragmentation=0.0),
        anomaly=AnomalyConfig(min_samples=4, window=2.0))
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    before = kernel_launches()
    total = 0
    for i in range(6):
        hists = {"a": {1: 5, 9: 3}, f"api.u{i}": {4: 2}}
        total += 10
        ms.backfill_retention([RawMetricSet(
            t0 + dt.timedelta(seconds=i), {}, {}, hists, {}, 1.0)])
    assert ms.lifecycle.compact()
    after = kernel_launches()
    ms.stop()
    # one chunk an interval: one K3 into acc, both tiers' slots and ihist
    assert after["sparse_ingest"] - before["sparse_ingest"] == 6
    assert after["divergence"] - before["divergence"] == 6
    assert after["compact_rows"] > before["compact_rows"]
    assert ms.committer.fused_intervals == 6
    assert int(ms.aggregator._acc.sum()) == total
    assert ms.lifecycle.evicted_series > 0


def test_group_by_on_the_card_equals_the_cpu_wheel(dev):
    import datetime as dt

    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.labels import LabelIndex
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.window.store import TimeWheel

    cfg = MetricConfig(bucket_limit=64)
    wheels = []
    for device in (dev, "cpu"):
        w = TimeWheel(num_metrics=32, config=cfg, tiers=((4, 1), (3, 2)),
                      device=device)
        w.label_index = LabelIndex(w.registry)
        wheels.append(w)
    rng = np.random.default_rng(5)
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    for i in range(6):
        hists = {f"rpc.lat;code={c};route=/r{r}": {
            int(b): int(n) for b, n in zip(rng.integers(0, 70, 5),
                                           rng.integers(1, 300, 5))}
            for r in range(5) for c in (200, 500)}
        for w in wheels:
            w.push(RawMetricSet(t0 + dt.timedelta(seconds=i), {}, {}, hists,
                                {}, 1.0))
    card, cpu = wheels
    for sel, by in (("rpc.lat{}", ["route"]), ("rpc.lat{code=~5..}",
                                               ["route", "code"])):
        got = card.query_group_by(sel, by=by, depth=4)
        want = cpu.query_group_by(sel, by=by, depth=4)
        assert list(got.groups) == list(want.groups)
        assert got.sizes == want.sizes
        for gk, entry in want.groups.items():
            g = got.groups[gk]
            for key, value in entry.items():
                if key in ("sum", "avg"):
                    np.testing.assert_allclose(g[key], value, rtol=1e-6)
                else:
                    assert g[key] == value, (gk, key)
        before = kernel_launches()
        assert card.query_group_by(sel, by=by, depth=4) is got
        assert kernel_launches() == before  # a warm repeat launches nothing
    before = kernel_launches()["window_merge"]
    card.query_group_by("rpc.lat{}", by=["code"], window=2.0)  # unpinned
    assert kernel_launches()["window_merge"] == before + 1
    assert card.query_fallbacks == 1
