"""The Hopper kernels on the card, at small shapes, against their plain
PyTorch versions on the same CUDA tensors (int32 outputs EQUAL): K1, K2,
K3, and the paged pair K4 (triple scatter) and K4f (direct-to-paged
fused ingest), plus one paged interval through ``TorchAggregator``.

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
from loghisto_tpu_torch.ops.fold import fold_packed_numpy
from loghisto_tpu_torch.ops.fused_ingest import fused_ingest_batch
from loghisto_tpu_torch.ops.ingest import ingest_batch
from loghisto_tpu_torch.ops.row_ingest import (
    histogram_row,
    histogram_row_reference,
    row_ingest_batch,
)
from loghisto_tpu_torch.ops.sparse_ingest import (
    sparse_ingest,
    sparse_ingest_batch,
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
    values[:6] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 3.4e38]
    return ids, values


@pytest.mark.parametrize("m,bl", [(1, 64), (37, 64), (5, 4096)])
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
