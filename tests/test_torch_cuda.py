"""The Hopper kernels on the card, at small shapes, against their plain
PyTorch versions on the same CUDA tensors (int32 outputs EQUAL): K1, K2,
K3, K8 (the multirow layout accumulation, with one aggregator
interval on ``ingest_path="multirow"``), the paged pair K4 (triple
scatter) and K4f (direct-to-paged fused ingest), K5 (the retention
wheel's masked ring merge), K6 (the lifecycle's row repack, EQUAL) and
K7 (drift scores, within the float32 tolerance of
``tests/test_torch_anomaly.py``), plus one paged interval
through ``TorchAggregator``, a wheel, a fused commit with lifecycle
and drift on the card, and on paged storage the fused commit with
eviction and compaction against the same steps on the CPU, K4f after a
fold and a permutation, the rings-only repack (K6), and checkpoint
restores (dense in place, paged through K4) against the same restores
on the CPU, a preagg interval through the native cell store and K3, the
sketches (``LogHistogram`` through K2a and K2b, HLL, t-digest, moments,
``torch.func.vmap``) and a federated ``TorchMetricSystem`` against the
same on the CPU, and the mesh (world size 1 under NCCL against one
device; two ranks on the one card under gloo, launched by
``tests/test_torch_ranks.py``).

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


def test_preagg_interval_lands_through_k3_on_the_card(dev):
    """transport="preagg": the native cell store folds at record time and
    a forced flush ships its cells to the card's accumulator through K3,
    equal to the same interval on the CPU and to the host oracle."""
    from loghisto_tpu_torch import _native
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    assert _native.available(), _native.build_error()
    m, bl = 64, 4096
    card = TorchAggregator(num_metrics=m, batch_size=1 << 14,
                           transport="preagg")
    cpu = TorchAggregator(num_metrics=m, batch_size=1 << 14,
                          transport="preagg", device="cpu")
    assert card._cell_store.backend == "native"
    ids, values = _batch(1 << 17, m, seed=21)
    before = kernel_launches()["sparse_ingest"]
    for agg in (card, cpu):
        for off in range(0, len(ids), 1 << 15):
            agg.record_batch(ids[off:off + (1 << 15)],
                             values[off:off + (1 << 15)])
        agg.flush(force=True)
    torch.cuda.synchronize()
    assert kernel_launches()["sparse_ingest"] > before
    keep = (ids >= 0) & (ids < m)
    want = np.zeros((m, 2 * bl + 1), np.int64)
    np.add.at(want, (ids[keep], np.clip(compress_np(values[keep]), -bl, bl)
                     + bl), 1)
    assert torch.equal(card._acc.cpu(), cpu._acc)
    np.testing.assert_array_equal(cpu._acc.numpy(), want)
    card.close()
    cpu.close()


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


# -- paged storage with lifecycle and the paged fused commit -----------------


def _paged_lifecycle_stack(device, chunk=64):
    from loghisto_tpu_torch.commit import IntervalCommitter
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.lifecycle import LifecycleConfig, \
        LifecycleManager
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.window.store import TimeWheel

    cfg = MetricConfig(bucket_limit=512)
    agg = TorchAggregator(num_metrics=96, config=cfg, storage="paged",
                          paged_config=PagedStoreConfig(pool_pages=1024),
                          device=device)
    wheel = TimeWheel(num_metrics=96, config=cfg, interval=1.0,
                      tiers=((4, 1), (3, 2)), registry=agg.registry,
                      device=device)
    lc = LifecycleManager(agg, wheel, LifecycleConfig(
        ttl_intervals=1, check_every=1, auto_compact_fragmentation=0.0))
    return IntervalCommitter(agg, wheel, chunk=chunk, lifecycle=lc), agg, \
        wheel, lc


def _churn_intervals(n=8, seed=31):
    import datetime as dt

    from loghisto_tpu_torch.metrics import RawMetricSet

    rng = np.random.default_rng(seed)
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    out = []
    for i in range(n):
        hists = {f"api.s{k}.lat": {int(b): int(c) for b, c in zip(
            rng.integers(-40, 500, 30), rng.integers(1, 50, 30))}
            for k in range(12)}
        # the last three bring no fresh names, so the final snapshot
        # outlives the last lifecycle tick (an eviction invalidates it)
        for j in range(10 if i < n - 3 else 0):
            hists[f"api.u{i}_{j}.lat"] = {int(rng.integers(0, 400)): 3}
        out.append(RawMetricSet(t0 + dt.timedelta(seconds=i), {}, {}, hists,
                                {}, 1.0))
    return out


def test_paged_fused_commit_on_the_card_equals_the_cpu(dev):
    """The paged fused commit (K4 into the pool, one K3 into both tiers'
    slots, K5 for the final chunk's views) with eviction and compaction
    (K6 over each ring) on the card equals the same steps on the CPU:
    pool, page table, free list, rings, activity vector and snapshot
    CDFs bit for bit."""
    card, cpu = _paged_lifecycle_stack(dev), _paged_lifecycle_stack("cpu")
    before = kernel_launches()
    chunks = 0
    for i, raw in enumerate(_churn_intervals()):
        for com, *_ in (card, cpu):
            assert com.commit(raw) == "fused"
        chunks += card[0].last_dispatches
        if i % 4 == 1:
            assert card[3].compact() == cpu[3].compact()
    torch.cuda.synchronize()
    after = {k: v - before[k] for k, v in kernel_launches().items()}
    # K4: one launch a commit chunk, and one a pool fold of an eviction
    assert after["sparse_ingest"] == chunks
    assert after["paged_scatter"] == chunks + card[1].paged.commits > chunks
    assert after["window_merge"] == 2 * 8
    assert after["compact_rows"] == 2 * card[3].compactions
    assert after["divergence"] == 0
    (_, cagg, cwheel, clc), (_, pagg, pwheel, plc) = card, cpu
    assert clc.evicted_series == plc.evicted_series > 0
    assert torch.equal(cagg.paged._pool.cpu(), pagg.paged._pool)
    np.testing.assert_array_equal(cagg.paged.page_table, pagg.paged.page_table)
    assert cagg.paged.free_list() == pagg.paged.free_list()
    for t, pt in zip(cwheel._tiers, pwheel._tiers):
        assert torch.equal(t.ring.cpu(), pt.ring)
    assert torch.equal(clc._la.cpu(), plc._la)
    for tg, tw in zip(cwheel.snapshot.tiers, pwheel.snapshot.tiers):
        for vg, vw in zip(tg.views, tw.views):
            assert torch.equal(vg.cdf.cpu(), vw.cdf)
            assert torch.equal(vg.counts.cpu(), vw.counts)
            torch.testing.assert_close(vg.sums.cpu(), vw.sums, rtol=1e-6,
                                       atol=1e-6)
    for agg in (cagg, pagg):
        agg.close()


def test_fused_paged_ingest_after_fold_and_permutation_reads_fresh_luts(dev):
    """The stale-mirror check: once K4f's device mirrors exist, an
    eviction fold (pages released and re-mapped) and a compaction (the
    page table's rows permuted) must reach them, or the next raw batch
    scatters into pages that now belong to another row.  A K4f batch
    after both equals the plain version run on mirrors built fresh from
    the host tables."""
    from loghisto_tpu_torch.ops.fused_ingest import (
        fused_paged_ingest_batch,
        fused_paged_ingest_reference,
    )

    m, bl = 256, 4096
    store = PagedStore(m, bl, config=PagedStoreConfig(pool_pages=4096),
                       device=dev)
    ids, values = _batch(1 << 16, m, seed=41)
    ids = np.abs(ids) % m
    out, _ = store.prepare_batch(ids.astype(np.int32), values)
    store.ingest_raw(torch.from_numpy(out).to(dev),
                     torch.from_numpy(values).to(dev))
    assert store._mirror is not None
    store.fold_rows_into(list(range(0, 96)), target=200)
    perm = [r for r in range(m) if store.row_codec[r] >= 0]
    store.apply_permutation(perm + [-1] * (m - len(perm)), m)
    ids2, values2 = _batch(1 << 16, len(perm), seed=42)
    out2, _ = store.prepare_batch(np.abs(ids2).astype(np.int32) % len(perm),
                                  values2)
    ids_d = torch.from_numpy(out2).to(dev)
    vals_d = torch.from_numpy(values2).to(dev)
    fresh = (torch.from_numpy(store.row_codec.astype(np.int32)).to(dev),
             torch.from_numpy(store._enc.astype(np.int32)).to(dev),
             torch.from_numpy(np.ascontiguousarray(store.page_table.T)).to(
                 dev))
    k = torch.zeros_like(store._pool)
    p = torch.zeros_like(k)
    fused_paged_ingest_batch(k, ids_d, vals_d, *store.device_luts(), bl)
    fused_paged_ingest_reference(p, ids_d, vals_d, *fresh, bl)
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    assert int(k.sum()) == int((out2 >= 0).sum())


def test_compact_paged_kernel_equals_the_cpu(dev):
    from loghisto_tpu_torch.ops.commit import DROP_ID
    from loghisto_tpu_torch.ops.lifecycle import make_compact_fn

    rng = np.random.default_rng(43)
    rings = [rng.integers(0, 1 << 20, (s, 300, 129)).astype(np.int32)
             for s in (5, 3)]
    la = rng.integers(0, 9, 300).astype(np.int32)
    perm = np.full(300, DROP_ID, dtype=np.int32)
    perm[:170] = np.sort(rng.choice(300, 170, replace=False))
    compact = make_compact_fn(2, with_acc=False)
    before = kernel_launches()["compact_rows"]
    got, got_la = compact([torch.from_numpy(r).to(dev) for r in rings],
                          torch.from_numpy(la).to(dev), perm, 4)
    want, want_la = compact([torch.from_numpy(r) for r in rings],
                            torch.from_numpy(la), perm, 4)
    torch.cuda.synchronize()
    assert kernel_launches()["compact_rows"] == before + 2
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(got_la.cpu(), want_la)


def _checkpoint_source(bl, seed):
    """A CPU aggregator holding seeded intervals of bucket maps over 12
    names, and its checkpoint file's path."""
    import datetime as dt
    import tempfile

    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.utils import checkpoint

    rng = np.random.default_rng(seed)
    src = TorchAggregator(num_metrics=16, config=MetricConfig(bucket_limit=bl),
                          device="cpu")
    for i in range(3):
        hists = {f"m{k}": {int(b): int(c) for b, c in zip(
            rng.integers(-bl, bl + 1, 20), rng.integers(1, 100, 20))}
            for k in range(12)}
        src.merge_raw(RawMetricSet(
            time=dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
            + dt.timedelta(seconds=i), counters={}, rates={},
            histograms=hists, gauges={}, duration=1.0, seq=i + 1))
    path = tempfile.mkdtemp() + "/src.npz"
    checkpoint.save(path, aggregator=src, seq_watermark=3)
    return src, path


def test_dense_restore_on_the_card_equals_the_cpu(dev):
    """A dense restore merges on the card, in place, and equals the same
    restore on the CPU; the card aggregator's save is the CPU's file."""
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.utils import checkpoint

    _, path = _checkpoint_source(64, 31)
    aggs = [TorchAggregator(num_metrics=16, config=MetricConfig(
        bucket_limit=64), device=d) for d in (dev, "cpu")]
    for agg in aggs:
        agg._id_for("other")
        acc = agg._acc
        assert checkpoint.restore(path, aggregator=agg) == 3
        assert agg._acc is acc and agg._spill is None
    card, cpu = aggs
    assert card._acc.device.type == "cuda"
    assert torch.equal(card._acc.cpu(), cpu._acc)
    assert card.registry.names() == cpu.registry.names()
    saved = []
    for agg in aggs:
        saved.append(path + f".{agg.device.type}.npz")
        checkpoint.save(saved[-1], aggregator=agg)
    with np.load(saved[0]) as a, np.load(saved[1]) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for agg in aggs:
        agg.close()


def test_paged_restore_on_the_card_equals_the_cpu(dev):
    """A paged restore on the card is translate plus one K4 launch, and
    leaves the pool, page table, codecs and free list of the same
    restore on the CPU; a second restore stacks exactly."""
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.paging import PagedStoreConfig
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.utils import checkpoint

    src, path = _checkpoint_source(512, 32)
    aggs = [TorchAggregator(num_metrics=16, config=MetricConfig(
        bucket_limit=512), device=d, storage="paged",
        paged_config=PagedStoreConfig(pool_pages=512, codec="auto"))
        for d in (dev, "cpu")]
    for rounds in (1, 2):
        for agg in aggs:
            before = kernel_launches()["paged_scatter"]
            checkpoint.restore(path, aggregator=agg)
            torch.cuda.synchronize()
            launched = kernel_launches()["paged_scatter"] - before
            assert launched == (1 if agg.device.type == "cuda" else 0)
        card, cpu = (a.paged for a in aggs)
        assert torch.equal(card._pool.cpu(), cpu._pool)
        np.testing.assert_array_equal(card.page_table, cpu.page_table)
        assert card.codec_names() == cpu.codec_names()
        assert card.free_list() == cpu.free_list()
        # "auto" may store a row lossily: its counts are conserved
        want = src._acc.numpy().astype(np.int64).sum(axis=1) * rounds
        np.testing.assert_array_equal(card.decode_dense().sum(axis=1), want)
    for agg in aggs:
        agg.close()


# -- observability on the card ---------------------------------------------- #


def _obs_raws(n, seed):
    import datetime as dt

    from loghisto_tpu_torch.metrics import RawMetricSet

    rng = np.random.default_rng(seed)
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    raws = []
    for k in range(n):
        hists = {}
        for i in range(6):
            b, c = np.unique(compress_np(rng.lognormal(1.0 + i, 0.7, 500)),
                             return_counts=True)
            hists[f"m{i}"] = dict(zip(b.tolist(), c.tolist()))
        raws.append(RawMetricSet(time=t0 + dt.timedelta(seconds=k),
                                 counters={}, rates={}, histograms=hists,
                                 gauges={}, duration=1.0, seq=k + 1))
    return raws


def test_observed_commit_on_the_card_nests_every_stage(dev):
    """A fused commit on the card with observability: every interval has
    its complete nested span set (commit.device_sync waits on the CUDA
    event of the commit's launches), the same stage sets as the CPU twin,
    the self-observer re-ingests, and the watchdog is ok."""
    from loghisto_tpu_torch.system import TorchMetricSystem

    systems = [TorchMetricSystem(interval=1.0, sys_stats=False,
                                 num_metrics=16, retention=((4, 1),),
                                 observability=True, device=d)
               for d in (dev, "cpu")]
    sets = []
    for ms in systems:
        before = kernel_launches()
        ms.backfill_retention(_obs_raws(4, 61))
        launched = {k: kernel_launches()[k] - before[k]
                    for k in ("sparse_ingest", "window_merge")}
        if ms.device.type == "cuda":
            assert launched == {"sparse_ingest": 4, "window_merge": 4}
        by = {}
        for s in ms.obs.spans():
            by.setdefault(s.seq, []).append(s)
        e2e = [s for s in ms.obs.spans() if s.stage == "commit.e2e"]
        assert [s.seq for s in e2e] == [1, 2, 3, 4]
        for parent in e2e:
            for s in by[parent.seq]:
                if s.stage.startswith("commit."):
                    assert parent.start_ns <= s.start_ns <= s.end_ns \
                        <= parent.end_ns
        sets.append({q: sorted({s.stage for s in g}) for q, g in by.items()})
        assert ms.self_observer.reingested > 0
        assert ms.health.report().ok
        ms.stop()
    assert sets[0] == sets[1]
    assert "commit.device_sync" in sets[0][1]


def test_collect_trace_on_the_card_holds_the_k1_launch(dev, monkeypatch,
                                                       tmp_path):
    """collect() under LOGHISTO_TRACE_DIR writes a Chrome trace with the
    loghisto_collect region and K1's CUDA kernel by name."""
    import glob
    import json

    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    monkeypatch.setenv("LOGHISTO_TRACE_DIR", str(tmp_path))
    # a batch_size past the batch: record_batch only buffers, and the
    # launch happens in collect()'s flush, inside the capture
    agg = TorchAggregator(num_metrics=64, batch_size=1 << 15, device=dev)
    rng = np.random.default_rng(62)
    agg.record_batch(rng.integers(0, 64, 1 << 14).astype(np.int32),
                     rng.lognormal(2.0, 1.0, 1 << 14).astype(np.float32))
    agg.collect()
    agg.close()
    (path,) = glob.glob(str(tmp_path / "loghisto_collect" / "*.json"))
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    assert "loghisto_collect" in names
    assert any("lh_fused_ingest_kernel" in n for n in names)


def test_print_benchmark_on_the_card(dev):
    import io

    from loghisto_tpu_torch.print_benchmark import (
        _interesting_metrics,
        print_benchmark,
    )

    out = io.StringIO()
    print_benchmark("card_op", concurrency=2, op=lambda: None, duration=3.0,
                    interval=0.5, out=out, device=True)
    want = _interesting_metrics("card_op")
    blocks = [b.split("\n") for b in out.getvalue().split("\n\n") if b]
    assert blocks
    counts = []
    for block in blocks:
        assert [ln.split(":")[0] for ln in block[1:]] == want
        counts.append(float(block[1].split("\t")[-1]))
    assert any(counts)


# -- resilience on the card (6c-2) and F7 -------------------------------------


def _profiler_split(mode):
    import json
    import os
    import subprocess
    import sys

    script = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "torch_profiler_split.py")
    proc = subprocess.run([sys.executable, script, mode],
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_profiler_captures_after_scheduled_sessions_and_the_firehose(dev):
    """F7, each sequence in a fresh process (scripts/torch_profiler_split.py):
    a capture of K1, K2b (cluster launches through cudaLaunchKernelEx),
    K3 (<<<>>>) and a PyTorch kernel, then six scheduled ``profile``
    sessions as ``chip_smoke._device_busy`` opens them, each followed by
    another capture: every probe capture keeps every kernel.  After
    ``chip_smoke.phase_firehose`` whole, K3 and PyTorch's kernel stay in
    the capture; whether the cluster launches do is printed (F7: on
    torch 2.11.0+cu128 they were gone, with their launch records kept)."""
    out = _profiler_split("scheduled")
    for entry in [out["before"]] + out["after"]:
        for how in ("as_is", "synced"):
            assert entry[how]["kernels"] == ["K1", "K2b", "K3",
                                             "torch_sum"], how
    out = _profiler_split("firehose_phase")
    assert "K1" in out["before"]["as_is"]["kernels"]
    after = out["after"][0]["as_is"]
    assert {"K3", "torch_sum"} <= set(after["kernels"])
    assert "cudaLaunchKernelExC" in after["launch_records"]
    print("F7 after the firehose phase:", out["first_capture_without"])


def _capture_raws(ms):
    from loghisto_tpu_torch.channel import Channel

    ch = Channel(64)
    ms.subscribe_to_raw_metrics(ch)
    return ch


def test_commit_bridge_restart_on_the_card(dev, monkeypatch):
    """commit.bridge kills the committer's bridge once: the supervisor
    restarts it, the commits that follow equal the host oracle of every
    interval but the one that died with the bridge, and
    ``commit.device_sync`` on the restarted thread still waits on the
    card's stream (the default stream of the system's device)."""
    import queue
    import threading

    import loghisto_tpu_torch.commit as commit_mod
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.resilience import FaultInjector, ResilienceConfig
    from loghisto_tpu_torch.system import TorchMetricSystem

    syncs = []
    real_sync = commit_mod.device_sync

    def watched(device):
        real_sync(device)
        stream = torch.cuda.current_stream(device)
        syncs.append((threading.current_thread().name, stream.stream_id,
                      torch.cuda.default_stream(device).stream_id,
                      stream.query()))

    monkeypatch.setattr(commit_mod, "device_sync", watched)
    inj = FaultInjector().plan("commit.bridge", "raise", on_call=2)
    ms = TorchMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=16,
        config=MetricConfig(bucket_limit=64), retention=((4, 1),),
        observability=True, device=dev,
        resilience=ResilienceConfig(fault_injector=inj,
                                    restart_backoff_s=0.01))
    ch = _capture_raws(ms)
    q = queue.Queue()
    com = ms.committer
    rng = np.random.default_rng(71)
    deadline_s = 30.0
    import time

    try:
        for k in range(1, 5):
            ms.histogram_batch("lat", rng.lognormal(-1.0, 0.5, 500))
            before = com.intervals_committed
            ms._tick(q)
            deadline = time.monotonic() + deadline_s
            if k == 2:
                while ms.supervisor.total_restarts < 1:
                    assert time.monotonic() < deadline
                    time.sleep(0.005)
            else:
                while com.intervals_committed <= before:
                    assert time.monotonic() < deadline
                    time.sleep(0.005)
        raws = [ch.get() for _ in range(4)]
        want = np.zeros(129, np.int64)
        for raw in raws:
            if raw.seq == 2:
                continue
            for name, h in raw.histograms.items():
                if name == "lat":
                    for b, c in h.items():
                        want[int(np.clip(b, -64, 64)) + 64] += c
        row = ms.aggregator.registry.lookup("lat")
        got = ms.aggregator._acc[row].cpu().numpy()
        np.testing.assert_array_equal(got, want)
        assert ms.supervisor.restarts_by_name == {"loghisto-torch-commit": 1}
        after = [s for s in syncs if s[0] == "loghisto-torch-commit"]
        assert len(after) >= 3
        for name, stream, default, done in after:
            assert stream == default and done
    finally:
        ms.stop()


def test_failed_fused_commit_on_the_card_equals_the_cpu(dev):
    """D6 on the card: commit.dispatch fires before chunk 2 of the second
    interval; accumulator, host spill and every ring equal the CPU twin's
    (which tests/test_torch_chaos.py holds to the JAX committer)."""
    import datetime as dt

    from loghisto_tpu_torch.commit import IntervalCommitter
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.resilience import FaultInjector
    from loghisto_tpu_torch.window.store import TimeWheel

    cfg = MetricConfig(bucket_limit=64)
    rng = np.random.default_rng(72)
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    raws = []
    for i in range(3):
        hists = {}
        for k in range(8):
            h = hists.setdefault(f"svc.m{k}", {})
            for b in rng.integers(-4, 96, 12).tolist():
                h[b] = h.get(b, 0) + int(rng.integers(1, 200))
        raws.append(RawMetricSet(t0 + dt.timedelta(seconds=i), {}, {},
                                 hists, {}, 1.0, seq=i + 1))
    sides = []
    for d in (dev, "cpu"):
        agg = TorchAggregator(num_metrics=32, config=cfg, device=d)
        wheel = TimeWheel(num_metrics=32, config=cfg, interval=1.0,
                          tiers=((4, 1), (3, 2)), registry=agg.registry,
                          device=d)
        com = IntervalCommitter(agg, wheel, chunk=16)
        inj = FaultInjector()
        com.fault_injector = agg.fault_injector = inj
        agg.retry_cooldown = 0.0
        com.commit(raws[0])
        inj.plan("commit.dispatch", "raise", on_call=3)
        for raw in raws[1:]:
            assert com.commit(raw) == "fused"
        assert inj.fires_at("commit.dispatch") == 1
        sides.append((agg, wheel))
    (gagg, gwheel), (cagg, cwheel) = sides
    np.testing.assert_array_equal(gagg._acc.cpu().numpy(),
                                  cagg._acc.numpy())
    np.testing.assert_array_equal(gagg._spill, cagg._spill)
    for t, c in zip(gwheel._tiers, cwheel._tiers):
        np.testing.assert_array_equal(t.ring.cpu().numpy(), c.ring.numpy())
    total = sum(sum(h.values()) for raw in raws
                for h in raw.histograms.values())
    assert int(gagg._acc.sum()) + int(gagg._spill.sum()) == total
    for agg, _ in sides:
        agg.close()


@pytest.mark.parametrize("storage", ["dense", "paged"])
def test_step_failing_after_its_fold_on_the_card_counts_once(
        dev, storage, monkeypatch):
    """A launch after the chunk landed raises in the second interval:
    dense_cdf of the final step (after K3 into the accumulator), or, on
    paged storage, chunk 2's K3 into the tiers (after K4 into the pool).
    The landed chunk is not spilled or re-landed: accumulator (or pool)
    plus spill, and every ring, equal the CPU twin's (which
    tests/test_torch_chaos.py holds to the JAX committer), and they hold
    every sample once."""
    import datetime as dt
    import itertools

    import loghisto_tpu_torch.ops.commit as step
    from loghisto_tpu_torch.commit import IntervalCommitter
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.window.store import TimeWheel

    cfg = MetricConfig(bucket_limit=64 if storage == "dense" else 128)
    rng = np.random.default_rng(74)
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    raws = []
    for i in range(3):
        hists = {}
        for k in range(8):
            h = hists.setdefault(f"svc.m{k}", {})
            for b in rng.integers(-4, 96, 12).tolist():
                h[b] = h.get(b, 0) + int(rng.integers(1, 200))
        raws.append(RawMetricSet(t0 + dt.timedelta(seconds=i), {}, {},
                                 hists, {}, 1.0, seq=i + 1))
    name = "dense_cdf" if storage == "dense" else "sparse_ingest_multi"
    real = getattr(step, name)
    sides = []
    for d in (dev, "cpu"):
        calls = itertools.count(1)

        def boom(*a, **kw):
            if next(calls) == on_call:
                raise torch.cuda.OutOfMemoryError(f"{name}: injected")
            return real(*a, **kw)

        on_call = 0
        monkeypatch.setattr(step, name, boom)
        kw = {}
        if storage == "paged":
            kw = dict(storage="paged",
                      paged_config=PagedStoreConfig(pool_pages=512))
        agg = TorchAggregator(num_metrics=32, config=cfg, device=d, **kw)
        wheel = TimeWheel(num_metrics=32, config=cfg, interval=1.0,
                          tiers=((4, 1), (3, 2)), registry=agg.registry,
                          device=d)
        com = IntervalCommitter(agg, wheel, chunk=16)
        agg.retry_cooldown = 0.0
        com.commit(raws[0])
        first = com.last_dispatches
        on_call = 2 if storage == "dense" else first + 3
        for raw in raws[1:]:
            assert com.commit(raw) == "fused"
        assert next(calls) > on_call
        sides.append((agg, wheel))
    (gagg, gwheel), (cagg, cwheel) = sides
    total = sum(sum(h.values()) for raw in raws
                for h in raw.histograms.values())
    if storage == "dense":
        np.testing.assert_array_equal(gagg._acc.cpu().numpy(),
                                      cagg._acc.numpy())
        assert (gagg._spill is None) == (cagg._spill is None)
        spilled = 0 if gagg._spill is None else int(gagg._spill.sum())
        assert int(gagg._acc.sum()) + spilled == total
    else:
        gst, cst = gagg.paged, cagg.paged
        np.testing.assert_array_equal(gst.page_table, cst.page_table)
        assert gst._host_spill == cst._host_spill
        np.testing.assert_array_equal(gst._pool.cpu().numpy(),
                                      cst._pool.numpy())
        assert int(gst.decode_cells()[2].sum()) == total
    for t, c in zip(gwheel._tiers, cwheel._tiers):
        np.testing.assert_array_equal(t.ring.cpu().numpy(), c.ring.numpy())
    for agg, _ in sides:
        agg.close()


def test_device_failure_requeue_on_the_card_equals_the_cpu(dev):
    """agg.ingest fires on the third chunk of a raw flush: the rest is
    requeued and the forced barrier lands it through K1; the card's
    accumulator equals the CPU twin's."""
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.resilience import FaultInjector

    rng = np.random.default_rng(73)
    ids = rng.integers(0, 64, 1 << 16).astype(np.int32)
    values = rng.lognormal(2.0, 1.0, 1 << 16).astype(np.float32)
    accs = []
    for d in (dev, "cpu"):
        agg = TorchAggregator(num_metrics=64, batch_size=1 << 12,
                              transport="raw", device=d)
        inj = FaultInjector().plan("agg.ingest", "raise", on_call=3)
        agg.fault_injector = inj
        agg.retry_cooldown = 0.0
        before = kernel_launches()["fused_ingest"]
        agg.record_batch(ids, values)
        agg.flush(force=True)
        assert inj.fires_at("agg.ingest") == 1 and agg.pending_samples == 0
        if d != "cpu":
            assert kernel_launches()["fused_ingest"] - before == 16
        accs.append(agg._acc.cpu().numpy().copy())
        agg.close()
    np.testing.assert_array_equal(accs[0], accs[1])
    assert int(accs[0].sum()) == len(ids)


# -- federation: the receiver's merges land through K3 and K4 -------------


def _federation_frames(seed, bl):
    """A seeded frame sequence from three emitters, one buffer per
    connection: a dictionary split over two frames, a duplicate, a gap
    filled late, a v1 frame and rows that arrive before their names."""
    from loghisto_tpu_torch.federation import wire
    from loghisto_tpu_torch.ops.codec import encode_frame

    rng = np.random.default_rng(seed)

    def rows(lids, n):
        return np.stack([rng.choice(np.asarray(lids), n),
                         rng.integers(-bl // 4, bl + 1, n),
                         rng.integers(1, 100, n)], axis=1).astype(np.int32)

    def v2(eid, seq, names, packed):
        return encode_frame(wire.KIND_DELTA2, wire.encode_delta2(
            eid, seq, names, packed, 10**12 + seq, 2 * 10**18 + seq))

    names = [(i, f"fed.n{i}") for i in range(40)]
    a1 = v2(1, 1, names[:20], rows(range(20), 3000))
    a2 = v2(1, 2, names[20:], rows(range(40), 3000))
    a3 = v2(1, 3, [], rows(range(40), 3000))
    b1 = encode_frame(wire.KIND_DELTA, wire.encode_delta(
        2, 1, [(0, "fed.b")], rows([0], 100)))
    c2 = v2(3, 2, [], rows([0, 1], 500))
    c1 = v2(3, 1, [(0, "fed.c0"), (1, "fed.c1")], rows([0], 10))
    return [a1, a3, a2, a3, b1, c2, c1]


@pytest.mark.parametrize("storage", ["dense", "paged"])
def test_federation_receiver_on_the_card_equals_the_cpu(dev, storage):
    """One frame sequence through a ``FederationReceiver`` over a card
    ``TorchAggregator`` and over a CPU one: the receiver's merges launch
    K3 (dense) or K4 (paged), and the storage, the counters and
    ``collect()``'s counts and percentiles are EQUAL."""
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.federation import FederationReceiver
    from loghisto_tpu_torch.paging import PagedStoreConfig
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    bl = 4096
    frames = _federation_frames(31, bl)
    kw = {"num_metrics": 64, "config": MetricConfig(bucket_limit=bl),
          "storage": storage}
    if storage == "paged":
        kw["paged_config"] = PagedStoreConfig(pool_pages=4096)
    kernel = "sparse_ingest" if storage == "dense" else "paged_scatter"
    out = []
    for d in (dev, "cpu"):
        agg = TorchAggregator(device=d, **kw)
        rx = FederationReceiver(agg)
        before = kernel_launches()[kernel]
        try:
            assert all(rx._drain_buffer(bytearray(f)) for f in frames)
            rx.stop()
            assert agg.wait_transfers(30.0)
            torch.cuda.synchronize()
            if d != "cpu":
                assert kernel_launches()[kernel] > before
            store = agg._acc if storage == "dense" else agg.paged._pool
            stats = rx.stats()
            out.append((store.cpu().numpy().copy(), stats,
                        agg.collect().metrics))
        finally:
            agg.close()
    (card, card_stats, card_m), (cpu, cpu_stats, cpu_m) = out
    np.testing.assert_array_equal(card, cpu)
    for key in ("frames_received", "duplicate_frames", "seq_gaps",
                "samples_merged", "samples_shed", "frames_v1"):
        assert card_stats[key] == cpu_stats[key], key
    assert card_stats["duplicate_frames"] == 1
    assert card_stats["seq_gaps"] == 0 and card_stats["samples_shed"] == 0
    assert set(card_m) == set(cpu_m)
    for key, want in cpu_m.items():
        if key.endswith(("_sum", "_avg")):
            assert card_m[key] == pytest.approx(want, rel=1e-5), key
        else:
            assert card_m[key] == want, key


@pytest.mark.parametrize("n,kernel_path", [(1 << 16, "K2a"),
                                           ((1 << 16) + 5, "K2b")])
def test_loghistogram_on_the_card_launches_k2(dev, n, kernel_path):
    """``LogHistogram.insert`` on the card: a multiple of 2048 samples
    through K2a, any other length through K2b; one launch each, counts
    EQUAL to the CPU histogram's, statistics within float32 rounding."""
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.models import LogHistogram

    rng = np.random.default_rng(n)
    values = np.concatenate([rng.lognormal(0, 2, n - 64),
                             edge_values(4096)[:64]]).astype(np.float32)
    cfg = MetricConfig()
    before = kernel_launches()["row_ingest"]
    card = LogHistogram.empty(cfg, device=dev).insert(values)
    torch.cuda.synchronize()
    assert kernel_launches()["row_ingest"] == before + 1, kernel_path
    cpu = LogHistogram.empty(cfg, device="cpu").insert(values)
    assert card.counts.device.type == "cuda"
    np.testing.assert_array_equal(card.counts.cpu().numpy(),
                                  cpu.counts.numpy())
    ps = [0.0, 0.5, 0.99, 1.0]
    got, want = card.statistics(ps), cpu.statistics(ps)
    assert got["count"] == want["count"] == n
    assert got["sum"] == pytest.approx(want["sum"], rel=1e-5)
    np.testing.assert_array_equal(got["percentiles"], want["percentiles"])


def test_sketches_on_the_card_equal_the_cpu(dev):
    """HLL registers EQUAL, a t-digest below capacity EQUAL and above it
    within the CPU tests' tolerance, moments counts EQUAL and floats
    within rtol 1e-5, and ``torch.func.vmap`` over stacked sketches on
    the card EQUAL to single calls."""
    from torch.func import vmap

    from loghisto_tpu_torch.models import hll, moments, tdigest

    rng = np.random.default_rng(12)
    values = rng.lognormal(3, 1.5, 200_000).astype(np.float32)
    x = torch.from_numpy(values)
    regs = hll.insert(hll.empty(device=dev), x.to(dev))
    assert torch.equal(regs.cpu(), hll.insert(hll.empty(device="cpu"), x))
    cfg = tdigest.TDigestConfig(capacity=512)
    for n in (300, 200_000):
        card = tdigest.insert(*tdigest.empty(cfg, device=dev), x[:n].to(dev),
                              config=cfg)
        cpu = tdigest.insert(*tdigest.empty(cfg, device="cpu"), x[:n],
                             config=cfg)
        if n <= cfg.capacity:
            assert torch.equal(card[0].cpu(), cpu[0])
            assert torch.equal(card[1].cpu(), cpu[1])
        assert float(card[1].sum()) == float(cpu[1].sum()) == n
        qs = torch.tensor([0.0, 0.5, 0.99, 0.999, 1.0])
        np.testing.assert_allclose(
            tdigest.quantile(*card, qs.to(dev)).cpu().numpy(),
            tdigest.quantile(*cpu, qs).numpy(), rtol=1e-4)
    st = moments.insert(moments.empty(device=dev), x.to(dev))
    st_cpu = moments.insert(moments.empty(device="cpu"), x)
    assert int(st.count) == int(st_cpu.count) == len(values)
    for field in ("scale", "min", "max"):
        assert float(getattr(st, field)) == float(getattr(st_cpu, field))
    np.testing.assert_allclose(
        moments.quantile(st, [0.5, 0.99]).cpu().numpy(),
        moments.quantile(st_cpu, [0.5, 0.99]).numpy(), rtol=1e-5)
    batch = x[:8 * 4096].reshape(8, 4096).to(dev)
    small = tdigest.TDigestConfig(capacity=64)
    m0, w0 = tdigest.empty(small, device=dev)
    ms2, ws2 = vmap(lambda m, w, v: tdigest.insert(m, w, v, config=small))(
        m0.expand(8, -1).clone(), w0.expand(8, -1).clone(), batch)
    regs2 = vmap(hll.insert)(hll.empty(device=dev).expand(8, -1).clone(),
                             batch)
    for i in range(8):
        m1, w1 = tdigest.insert(m0, w0, batch[i], config=small)
        assert torch.equal(ms2[i], m1) and torch.equal(ws2[i], w1)
        assert torch.equal(regs2[i], hll.insert(hll.empty(device=dev),
                                                batch[i]))


def test_federated_system_on_the_card_equals_the_cpu(dev):
    """``TorchMetricSystem(federation=...)`` on the card and on the CPU
    take the same frames through ``_drain_buffer`` and commit by hand:
    the merges launch K3, each commit K3 and K5, freshness completes at
    publish, and the federated rows are EQUAL."""
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.federation import FederationConfig
    from loghisto_tpu_torch.system import TorchMetricSystem

    bl = 4096
    frames = _federation_frames(32, bl)
    out = []
    for d in (dev, "cpu"):
        ms = TorchMetricSystem(interval=1.0, sys_stats=False,
                               num_metrics=64,
                               config=MetricConfig(bucket_limit=bl),
                               retention=((8, 1),), observability=True,
                               federation=FederationConfig(
                                   expected_emitters=3),
                               device=d)
        try:
            before = kernel_launches()
            assert all(ms.federation._drain_buffer(bytearray(f))
                       for f in frames)
            assert ms.aggregator.wait_transfers(30.0)
            pending = ms.federation.stats()["freshness_pending"]
            for _ in range(2):
                ms.backfill_retention([ms.collect_raw_metrics()])
            if d != "cpu":
                torch.cuda.synchronize()
                after = kernel_launches()
                assert after["sparse_ingest"] > before["sparse_ingest"]
                assert after["window_merge"] > before["window_merge"]
            st = ms.debug_dump()["federation"]
            metrics = ms.device_metrics(reset=False).metrics
            out.append((pending, st, {k: v for k, v in metrics.items()
                                      if k.startswith("fed.")}))
        finally:
            ms.stop()
    (pend, st, card_m), (cpu_pend, cpu_st, cpu_m) = out
    assert pend == cpu_pend > 0
    assert st["freshness_pending"] == cpu_st["freshness_pending"] == 0
    assert st["freshness_samples"] == cpu_st["freshness_samples"] == pend
    assert st["samples_merged"] == cpu_st["samples_merged"] > 0
    assert set(card_m) == set(cpu_m)
    for key, want in cpu_m.items():
        if key.endswith("_count"):
            assert card_m[key] == want, key
        elif "FreshnessUs" not in key:  # freshness reads the host clock
            assert card_m[key] == pytest.approx(want, rel=1e-5), key


def _mesh_card_inputs():
    """The mesh module's stream (``test_torch_ranks``) without the JAX
    codec filter: these tests hold the mesh against one device of the
    port, on any values."""
    import test_torch_ranks as R

    rng = np.random.default_rng(21)
    d = {"step.ids": ((rng.zipf(1.5, (R.STEPS, R.STEP_N)) - 1)
                      % R.MESH_M).astype(np.int32),
         "step.values": rng.lognormal(0.5, 1.2, (R.STEPS, R.STEP_N))
         .astype(np.float32)}
    for i in range(R.AGG_INTERVALS):
        for s in range(2):
            n = R.agg_rows(s, i)
            d[f"agg.{i}.{s}.ids"] = rng.integers(
                -1, R.MESH_M + 1, n).astype(np.int32)
            d[f"agg.{i}.{s}.values"] = rng.lognormal(0.5, 1.2, n).astype(
                np.float32)
    for s in range(2):
        cells = np.stack([rng.integers(0, len(R.MESH_NAMES), 40),
                          rng.integers(-R.MESH_BL, R.MESH_BL + 1, 40),
                          rng.integers(1, 50, 40)], axis=1)
        d[f"cells.{s}"] = cells.astype(np.int64)
        d[f"packed.{s}"] = np.stack([
            rng.integers(0, R.MESH_M, 30),
            rng.integers(-R.MESH_BL, R.MESH_BL + 1, 30),
            rng.integers(1, 20, 30)], axis=1).astype(np.int32)
    d["grow.probe"] = rng.lognormal(0.5, 1.2, len(R.GROW_NAMES)).astype(
        np.float32)
    for i, seen in enumerate(R.GROW_SEEN):
        for s in range(2):
            n = R.agg_rows(s, i)
            d[f"grow.{i}.{s}.ids"] = rng.integers(0, seen, n).astype(
                np.int32)
            d[f"grow.{i}.{s}.values"] = rng.lognormal(0.5, 1.2, n).astype(
                np.float32)
    for s in range(2):
        d[f"grow.cells.{s}"] = np.stack([
            rng.integers(0, len(R.GROW_NAMES), 30),
            rng.integers(-R.MESH_BL, R.MESH_BL + 1, 30),
            rng.integers(1, 50, 30)], axis=1).astype(np.int64)
    return d


def _mesh_one_device(dev, inputs, n_stream, transport):
    """One device of the port fed every stream row: per interval (acc as
    int64, collected metrics)."""
    import test_torch_ranks as R
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    agg = TorchAggregator(num_metrics=R.MESH_M, transport=transport,
                          config=MetricConfig(bucket_limit=R.MESH_BL),
                          batch_size=R.AGG_BATCH, device=dev)
    out = []

    def close_interval():
        agg.flush(force=True)
        out.append((agg._acc.cpu().numpy().astype(np.int64),
                    agg.collect().metrics))

    try:
        for name in R.MESH_NAMES:
            agg.registry.id_for(name)
        for i in range(R.AGG_INTERVALS):
            for s in range(n_stream):
                agg.record_batch(inputs[f"agg.{i}.{s}.ids"],
                                 inputs[f"agg.{i}.{s}.values"])
            close_interval()
        if transport == "sparse":
            for s in range(n_stream):
                agg.merge_raw(R.raw_from_cells(inputs[f"cells.{s}"],
                                               RawMetricSet))
                agg.merge_packed(inputs[f"packed.{s}"], wait=True)
            close_interval()
    finally:
        agg.close()
    return out


def test_mesh_world_one_under_nccl_equals_one_device(dev, tmp_path):
    """World size 1 under NCCL: TorchAggregator(mesh=make_mesh(1, 1))
    launches K1 and its block and collected set EQUAL one device's; the
    per-batch step (an NCCL all_reduce a batch) and the interval step
    (collect.start in flight while the next batch folds) EQUAL the same
    accumulator."""
    import test_torch_ranks as R
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.parallel import multihost
    from loghisto_tpu_torch.parallel.aggregator import (
        TorchAggregator,
        make_distributed_step,
        make_interval_distributed_step,
        make_sharded_accumulator,
    )
    from loghisto_tpu_torch.parallel.mesh import make_mesh

    inputs = _mesh_card_inputs()
    want = _mesh_one_device(dev, inputs, 1, "raw")
    multihost.initialize(f"file://{tmp_path}/rdzv", 1, 0)
    try:
        import torch.distributed as dist

        assert dist.get_backend() == "nccl"
        mesh = make_mesh(1, 1)
        agg = TorchAggregator(num_metrics=R.MESH_M, transport="raw",
                              config=MetricConfig(bucket_limit=R.MESH_BL),
                              batch_size=R.AGG_BATCH, mesh=mesh,
                              max_metrics=R.MESH_M)
        try:
            assert agg.device.type == "cuda"
            for name in R.MESH_NAMES:
                agg.registry.id_for(name)
            for i, (acc, metrics) in enumerate(want):
                before = kernel_launches()["fused_ingest"]
                agg.record_batch(inputs[f"agg.{i}.0.ids"],
                                 inputs[f"agg.{i}.0.values"])
                agg.flush(force=True)
                assert kernel_launches()["fused_ingest"] > before
                np.testing.assert_array_equal(agg._acc.cpu().numpy(), acc)
                assert agg.collect().metrics == metrics
        finally:
            agg.close()
        ids = torch.from_numpy(inputs["step.ids"]).to(dev)
        values = torch.from_numpy(inputs["step.values"]).to(dev)
        one = torch.zeros((R.MESH_M, R.MESH_B), dtype=torch.int32,
                          device=dev)
        step = make_distributed_step(mesh, R.MESH_M, R.MESH_BL, R.MESH_PS)
        acc = make_sharded_accumulator(mesh, R.MESH_M, R.MESH_B)
        ingest, collect, make_partial = make_interval_distributed_step(
            mesh, R.MESH_M, R.MESH_BL, R.MESH_PS)
        acc2 = make_sharded_accumulator(mesh, R.MESH_M, R.MESH_B)
        for k in range(R.STEPS):
            fused_ingest_batch(one, ids[k], values[k], R.MESH_BL)
            acc, _ = step(acc, ids[k], values[k])
        pending = collect.start(acc2, ingest(make_partial(), ids[0],
                                             values[0]))
        fresh = ingest(make_partial(), ids[1], values[1])
        acc2, _ = pending.wait()
        acc2, _, _ = collect(acc2, fresh)
        assert torch.equal(acc, one) and torch.equal(acc2, one)
    finally:
        multihost.shutdown()


def test_mesh_two_ranks_under_gloo_on_the_card(dev, tmp_path):
    """Two ranks on the one card under gloo (NCCL refuses a GPU twice),
    meshes (2, 1) and (1, 2): every rank's set EQUALS one device's fed
    every stream row, the partials of each metric column sum to its
    rows, each rank launched K1 (raw) and K3 (sparse), the per-batch
    step's blocks EQUAL one device's rows, and growth (8 -> 16 -> 32
    rows, laid out anew at each collect) EQUALS one device growing."""
    import test_torch_ranks as R

    inputs = _mesh_card_inputs()
    res = R.launch(tmp_path, 2, f"card:{dev.type}", inputs,
                   device=dev.type)
    for shape in ((2, 1), (1, 2)):
        s_n, m_n = shape
        tag = f"{s_n}x{m_n}"
        rows = R.MESH_M // m_n
        by = {tuple(r[f"{tag}.coord"].tolist()): r for r in res}
        for transport in ("raw", "sparse"):
            want = _mesh_one_device(dev, inputs, s_n, transport)
            keys = list(range(R.AGG_INTERVALS)) + (
                ["cells"] if transport == "sparse" else [])
            for key, (acc, metrics) in zip(keys, want):
                for r in res:
                    got = R.get_metrics(r, f"{tag}.{transport}.{key}")
                    assert got == metrics, (tag, transport, key)
                for m in range(m_n):
                    summed = sum(by[(s, m)][f"{tag}.{transport}.{key}.partial"]
                                 for s in range(s_n))
                    np.testing.assert_array_equal(
                        summed, acc[m * rows:(m + 1) * rows])
            kernel = "k1" if transport == "raw" else "k3"
            for r in res:
                assert int(r[f"{tag}.{transport}.{kernel}"]) > 0
        one = torch.zeros((R.MESH_M, R.MESH_B), dtype=torch.int32,
                          device=dev)
        for k in range(R.STEPS):
            fused_ingest_batch(
                one, torch.from_numpy(inputs["step.ids"][k]).to(dev),
                torch.from_numpy(inputs["step.values"][k]).to(dev),
                R.MESH_BL)
        one = one.cpu().numpy()
        for (s, m), r in by.items():
            assert str(r[f"{tag}.step.device"]).startswith(dev.type)
            np.testing.assert_array_equal(r[f"{tag}.step.acc"],
                                          one[m * rows:(m + 1) * rows])
        # growth: the blocks laid out anew at collect equal one device
        # growing at once
        from loghisto_tpu_torch.config import MetricConfig
        from loghisto_tpu_torch.metrics import RawMetricSet
        from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

        agg = TorchAggregator(num_metrics=R.GROW_M0, transport="raw",
                              config=MetricConfig(bucket_limit=R.MESH_BL),
                              batch_size=R.AGG_BATCH,
                              max_metrics=R.GROW_MAX, device=dev)
        try:
            for i in range(len(R.GROW_SEEN)):
                for s in range(s_n):
                    R.grow_feed(agg, inputs, s, i, RawMetricSet)
                want = agg.collect().metrics
                for r in res:
                    assert R.get_metrics(r, f"{tag}.grow.{i}") == want
                    assert int(r[f"{tag}.grow.{i}.m"]) == agg.num_metrics
        finally:
            agg.close()
