"""The native routes through ``TorchAggregator(device="cpu")`` against the
JAX package's ``TPUAggregator`` (CPU, dense) on the same seeded streams:
transport="preagg" (the record-time cell store), transport="sparse"
(the native fold), native-staged raw at M > 1 and at M = 1, and
``merge_packed``, ``pending_samples`` and ``transport_stats``.

Compared per interval: the accumulators EQUAL (int32 [M, B]), then
``collect().metrics`` as in ``test_torch_aggregator.py``: key sets,
counts and percentile buckets EQUAL, percentile values rtol 4e-6 (XLA's
float32 ``exp``), sums and averages rtol 2e-6.  The raw route's stream is
drawn from values on which the JAX float32 device codec and the float64
codec agree; the host-folded routes use the float64 codec in both
packages, so their streams need no filter.  Preagg stores are swapped
for two-shard ones in both packages, so no test runs more than 4 shards.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest

from loghisto_tpu import _native as jax_native
from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.ops.codec import compress_np
from loghisto_tpu.ops.ingest import bucket_indices as jax_bucket_indices
from loghisto_tpu.parallel.aggregator import TPUAggregator
from loghisto_tpu_torch import _native
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.ops import dispatch
from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

BL = 4096
NAMES = ["rpc", "db", "cache", "queue", "disk"]


@pytest.fixture(autouse=True)
def _native_built():
    assert _native.available(), _native.build_error()


def _values(rng, n, agreeing):
    v = (rng.lognormal(3.0, 2.5, 2 * n) * np.where(
        rng.random(2 * n) < 0.1, -1.0, 1.0)).astype(np.float32)
    v[:5] = [0.0, -0.0, 1e-30, 5e5, 58.7]
    if agreeing:
        jax_idx = np.asarray(jax_bucket_indices(jnp.asarray(v), BL)) - BL
        v = v[jax_idx == np.clip(compress_np(v), -BL, BL)]
    return v[:n]


def _stream(seed, m, intervals=3, n=12_000, agreeing=False):
    """Per interval: (ids, values); ids straddle [0, M) (-1 and M drop)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(intervals):
        if m == 1:
            ids = np.where(rng.random(n) < 0.05, -1, 0).astype(np.int32)
        else:
            ids = ((rng.zipf(1.5, n) - 1) % (m + 1)).astype(np.int32) - 1
        out.append((ids, _values(rng, n, agreeing)))
    return out


def _assert_same(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if key.endswith(("_count", "_agg_count")):
            assert g == w, key
        elif key.endswith(("_sum", "_avg")):
            assert g == pytest.approx(w, rel=2e-6, abs=1e-6), key
        else:  # a percentile: same bucket, value within XLA's exp error
            assert int(compress_np([g])[0]) == int(compress_np([w])[0]), key
            assert g == pytest.approx(w, rel=4e-6, abs=0), key


def _two_shards(jax_agg, port):
    for agg, mod in ((jax_agg, jax_native), (port, _native)):
        if agg._cell_store is not None:
            agg._cell_store.close()
            agg._cell_store = mod.ShardedCellStore(BL, 100, num_shards=2)


def _pair(m=6, **kw):
    jax_agg = TPUAggregator(num_metrics=m, config=JaxConfig(),
                            storage="dense", batch_size=4096, **kw)
    port = TorchAggregator(num_metrics=m, config=MetricConfig(),
                           batch_size=4096, device="cpu", **kw)
    for name in NAMES[: max(1, m - 1)]:
        assert jax_agg.registry.id_for(name) == port.registry.id_for(name)
    _two_shards(jax_agg, port)
    return jax_agg, port


def _feed(agg, ids, values, chunk=3000):
    for off in range(0, len(ids), chunk):
        agg.record_batch(ids[off:off + chunk], values[off:off + chunk])


def _same_acc(jax_agg, port):
    jax_agg.flush(force=True)
    port.flush(force=True)
    np.testing.assert_array_equal(port._acc.numpy(),
                                  np.asarray(jax_agg._acc))


ROUTES = {
    # name: (aggregator kwargs, M, raw stream)
    "preagg": ({"transport": "preagg"}, 6, False),
    "sparse_native_fold": ({"transport": "sparse"}, 6, False),
    "native_staged_raw": ({"transport": "raw", "native_staging": True}, 6,
                          True),
    "native_staged_row": ({"transport": "raw", "native_staging": True}, 1,
                          True),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_jax_over_three_intervals(route):
    kw, m, agreeing = ROUTES[route]
    jax_agg, port = _pair(m, **kw)
    try:
        assert port.transport == jax_agg.transport == kw["transport"]
        if kw.get("native_staging"):
            assert port._native_buf is not None
            assert jax_agg._native_buf is not None
        if m == 1:
            assert port.ingest_path == "row"
        for ids, values in _stream(len(route), m, agreeing=agreeing):
            _feed(jax_agg, ids, values)
            _feed(port, ids, values)
            _same_acc(jax_agg, port)
            got, want = port.collect().metrics, jax_agg.collect().metrics
            _assert_same(got, want)
            for i, name in enumerate(NAMES[: max(1, m - 1)]):
                assert got[f"{name}_count"] == int((ids == i).sum())
        if kw.get("native_staging"):
            assert port._native_buf.dropped == 0
    finally:
        jax_agg.close()
        port.close()


@pytest.mark.parametrize("transport", ["preagg", "sparse", "raw"])
def test_pending_samples_and_transport_stats_match_jax(transport):
    jax_agg, port = _pair(transport=transport)
    try:
        ids, values = _stream(3, 6, intervals=1, n=10_000,
                              agreeing=True)[0]
        for agg in (jax_agg, port):
            agg.record_batch(ids[:1000], values[:1000])  # below batch_size
        want_pending = 0 if transport == "preagg" else 1000
        assert port.pending_samples == jax_agg.pending_samples == (
            want_pending)
        _feed(jax_agg, ids[1000:], values[1000:])
        _feed(port, ids[1000:], values[1000:])
        _same_acc(jax_agg, port)
        assert port.pending_samples == jax_agg.pending_samples == 0
        got, want = port.transport_stats(), jax_agg.transport_stats()
        assert set(got) == set(want)
        assert got["transport"] == want["transport"] == transport
        assert got["probe_density"] is want["probe_density"] is None
        assert got["samples_shipped"] == want["samples_shipped"]
        if transport == "raw":
            # the raw rings differ (JAX uploads padded super-slots); the
            # port's moves 8 bytes a sample
            assert got["bytes_uploaded"] == 8 * len(ids)
        else:
            assert got == want
            assert got["uploads"] >= 1
    finally:
        jax_agg.close()
        port.close()


@pytest.mark.parametrize("transport", ["raw", "sparse", "preagg"])
def test_merge_packed_matches_jax(transport):
    jax_agg, port = _pair(transport=transport)
    rng = np.random.default_rng(9)
    # buckets of the streams' value range (a uniform draw over
    # [-BL, BL] would sum representatives up to e^41, past what float32
    # sums hold to rtol 2e-6)
    packed = np.stack([
        rng.integers(-1, 7, 5000), rng.integers(-300, 1400, 5000),
        rng.integers(1, 1000, 5000)], axis=1).astype(np.int32)
    try:
        ids, values = _stream(4, 6, intervals=1, agreeing=True)[0]
        for agg in (jax_agg, port):
            _feed(agg, ids, values)  # interleaved with local ingest
            agg.merge_packed(packed[:2500])
            agg.merge_packed(packed[2500:], wait=True)
            agg.merge_packed(np.empty((0, 3), np.int32), wait=True)
            with pytest.raises(ValueError, match=r"\[n, 3\]"):
                agg.merge_packed(packed[:, :2])
        _same_acc(jax_agg, port)
        assert port.transport_stats()["samples_shipped"] == (
            jax_agg.transport_stats()["samples_shipped"])
        _assert_same(port.collect().metrics, jax_agg.collect().metrics)
    finally:
        jax_agg.close()
        port.close()


def test_preagg_ships_past_the_watermark_and_from_many_writers():
    """Four writer threads fold into the store; a watermark of 64 cells
    ships mid-interval.  The accumulator equals one preagg pass's, which
    equals the host oracle."""
    port = TorchAggregator(num_metrics=8, batch_size=4096, device="cpu",
                           transport="preagg")
    port._cell_store = _native.ShardedCellStore(BL, 100, num_shards=4)
    port.max_host_cells = 64
    batches = _stream(11, 8, intervals=8, n=3000)

    def writer(k):
        for ids, values in batches[k::4]:
            port.record_batch(ids, values)

    threads = [threading.Thread(target=writer, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    port.flush(force=True)
    assert port.transport_stats()["uploads"] > 2
    ids = np.concatenate([b[0] for b in batches])
    values = np.concatenate([b[1] for b in batches])
    keep = (ids >= 0) & (ids < 8)
    want = np.zeros((8, 2 * BL + 1), np.int32)
    np.add.at(want, (ids[keep], np.clip(compress_np(values[keep]), -BL, BL)
                     + BL), 1)
    np.testing.assert_array_equal(port._acc.numpy(), want)
    port.close()


def test_preagg_takes_no_native_staging_and_gauges_register():
    from loghisto_tpu_torch.metrics import MetricSystem

    pre = TorchAggregator(num_metrics=4, device="cpu", transport="preagg",
                          native_staging=True)
    assert pre._native_buf is None and pre._cell_store.backend == "native"
    staged = TorchAggregator(num_metrics=4, device="cpu",
                             native_staging=True)
    ms = MetricSystem(sys_stats=False)
    staged.register_device_gauges(ms)
    gauges = ms.collect_raw_metrics().gauges
    assert gauges["tpu.StagingDropped"] == 0.0
    assert gauges["tpu.SamplesShed"] == 0.0
    with pytest.raises(ValueError, match="'preagg', or 'sparse'"):
        TorchAggregator(num_metrics=4, device="cpu", transport="bulk")
    with pytest.raises(ValueError, match="paged storage unavailable"):
        TorchAggregator(num_metrics=4, device="cpu", transport="preagg",
                        storage="paged")


def test_choose_transport_native_ok():
    assert dispatch.choose_transport("cpu", 0.1) == "sparse"
    assert dispatch.choose_transport("cpu", 0.1, native_ok=False) == "raw"
    assert dispatch.choose_transport("cpu", 0.9) == "raw"
    assert dispatch.choose_transport("cpu", None) == "raw"
