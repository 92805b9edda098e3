"""The slice as a whole: the same seeded stream through the JAX package's
``TPUAggregator`` (CPU, dense, single device) and the port's
``TorchAggregator(device="cpu")``, over three intervals.

Compared per interval on ``collect().metrics``:
  * the key sets: EQUAL;
  * ``_count``, ``_agg_count`` and the bucket of every percentile: EQUAL;
  * percentile values: rtol 4e-6 (JAX's representatives come from XLA's
    float32 ``exp``, measured up to 1.4e-6 off the correctly rounded
    float32 the port uses — see test_torch_stats.py);
  * ``_sum``, ``_avg``, ``_agg_sum``, ``_agg_avg``: rtol 2e-6 (the same
    representative error plus float32 reduction order; the issue's 1e-6
    is met against the float64 host oracle, not against XLA's exp).
On spill intervals both packages take the float64 host statistics, so
everything but float formatting is exact there.

The stream is drawn from values on which the JAX float32 codec and the
float64 codec agree (their departures are counted in
test_torch_codec.py), so both packages see the same buckets.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest

from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.ops import dispatch as jax_dispatch
from loghisto_tpu.ops.codec import compress_np
from loghisto_tpu.ops.ingest import bucket_indices as jax_bucket_indices
from loghisto_tpu.parallel.aggregator import TPUAggregator
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.ops import dispatch
from loghisto_tpu_torch.ops.backend import kernel_launches
from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
from loghisto_tpu_torch.state import state_from_jax

BL = 4096
NAMES = ["rpc", "db", "cache", "queue", "disk"]


def _agreeing_values(rng, n):
    v = rng.lognormal(3.0, 2.5, 2 * n) * np.where(
        rng.random(2 * n) < 0.1, -1.0, 1.0)
    v = v.astype(np.float32)
    v[:5] = [0.0, -0.0, 1e-30, 5e5, 58.7]
    jax_idx = np.asarray(jax_bucket_indices(jnp.asarray(v), BL)) - BL
    keep = jax_idx == np.clip(compress_np(v), -BL, BL)
    return v[keep][:n]


def _stream(seed, intervals=3, n=12_000, m=6, zipf=False):
    """Per interval: (ids, values); ids straddle [0, M) and hit an
    unnamed row (m - 1)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(intervals):
        if zipf:
            ids = ((rng.zipf(1.5, n) - 1) % (m + 1)).astype(np.int32) - 1
        else:
            ids = rng.integers(-1, m + 1, n).astype(np.int32)
        out.append((ids, _agreeing_values(rng, n)))
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


def _pair(transport, m=6, **kw):
    jax_agg = TPUAggregator(
        num_metrics=m, config=JaxConfig(), transport=transport,
        storage="dense", batch_size=4096, **kw,
    )
    port = TorchAggregator(
        num_metrics=m, config=MetricConfig(), transport=transport,
        batch_size=4096, device="cpu", **kw,
    )
    for name in NAMES[: m - 1]:
        assert jax_agg.registry.id_for(name) == port.registry.id_for(name)
    return jax_agg, port


def _feed(agg, ids, values, chunk=3000):
    for off in range(0, len(ids), chunk):
        agg.record_batch(ids[off:off + chunk], values[off:off + chunk])


@pytest.mark.parametrize("transport", ["raw", "sparse"])
def test_three_intervals_match_jax(transport):
    jax_agg, port = _pair(transport)
    try:
        for ids, values in _stream(seed=1, zipf=transport == "sparse"):
            _feed(jax_agg, ids, values)
            _feed(port, ids, values)
            want, got = jax_agg.collect().metrics, port.collect().metrics
            _assert_same(got, want)
            fed = {n: int(((ids == i)).sum()) for i, n in enumerate(NAMES)}
            for name, count in fed.items():
                assert got[f"{name}_count"] == count
        assert port.transport == transport
        assert port.kernel_tier == "plain"
        assert sum(kernel_launches().values()) == 0  # no kernel on a CPU
    finally:
        jax_agg.close()
        port.close()


def test_auto_transport_probe_switches_on_skew():
    port = TorchAggregator(num_metrics=64, batch_size=1 << 17, device="cpu")
    rng = np.random.default_rng(5)
    ids = ((rng.zipf(1.3, 1 << 17) - 1) % 64).astype(np.int32)
    values = np.full(1 << 17, 42.0, np.float32)
    assert port.registry.id_for("hot") == 0
    port.record_batch(ids, values)
    metrics = port.collect().metrics
    assert port.transport == "sparse" and port.probe_density < 0.5
    assert metrics["hot_count"] == float((ids == 0).sum())
    assert metrics["hot_max"] == pytest.approx(42.0, rel=0.01)
    port.close()


@pytest.mark.parametrize("density", [0.0, 0.02, 0.18, 0.26, 0.49, 0.5,
                                     0.51, 1.0, None])
def test_choose_transport_per_device(density):
    """On the CPU the JAX rule (crossover 0.5, the same choice as
    ``loghisto_tpu``'s ``choose_transport``); on the card the crossover
    measured by chip_smoke.py's transport_crossover phase: 0.0, raw for
    any load."""
    assert dispatch.sparse_density_crossover("cpu") == 0.5
    assert dispatch.sparse_density_crossover("cuda") == 0.0
    assert dispatch.choose_transport("cpu", density) == (
        jax_dispatch.choose_transport("cpu", density))
    assert dispatch.choose_transport("cuda", density) == "raw"


def test_auto_probe_passes_its_device_type(monkeypatch):
    seen = []
    real = dispatch.choose_transport

    def spy(platform, density=None):
        seen.append((platform, density))
        return real(platform, density)

    monkeypatch.setattr(dispatch, "choose_transport", spy)
    port = TorchAggregator(num_metrics=8, batch_size=1 << 16, device="cpu")
    try:
        rng = np.random.default_rng(6)
        port.record_batch(rng.integers(0, 8, 1 << 16).astype(np.int32),
                          np.full(1 << 16, 3.0, np.float32))
        port.flush(force=True)
    finally:
        port.close()
    assert seen == [("cpu", port.probe_density)]
    assert port.transport == "sparse"  # 8 cells in 2^16 samples


def test_auto_skips_the_probe_where_no_density_switches(monkeypatch):
    """A crossover of 0.0 (the card's) keeps raw for any load, so the
    aggregator does not pay the host probe: a skewed load stays raw and
    ``probe_density`` stays None."""
    monkeypatch.setitem(dispatch.SPARSE_DENSITY_CROSSOVER_BY_DEVICE, "cpu",
                        0.0)
    port = TorchAggregator(num_metrics=8, batch_size=1 << 16, device="cpu")
    try:
        assert port.registry.id_for("hot") == 0
        port.record_batch(np.zeros(1 << 16, np.int32),
                          np.full(1 << 16, 3.0, np.float32))
        metrics = port.collect().metrics
    finally:
        port.close()
    assert port.transport == "raw" and port.probe_density is None
    assert metrics["hot_count"] == 1 << 16


def test_growth_from_one_row_swaps_row_kernel_for_fused():
    jax_agg, port = _pair("raw", m=1, max_metrics=16)
    assert port.ingest_path == "row"
    try:
        rng = np.random.default_rng(2)
        for interval in range(3):
            ids = np.array([jax_agg._id_for(n) for n in NAMES], np.int32)
            assert list(ids) == [port._id_for(n) for n in NAMES]
            ids = ids[rng.integers(0, len(NAMES), 5000)]
            values = _agreeing_values(rng, 5000)
            _feed(jax_agg, ids, values)
            _feed(port, ids, values)
            _assert_same(port.collect().metrics, jax_agg.collect().metrics)
        assert port.num_metrics == jax_agg.num_metrics == 8
        assert port.ingest_path == "fused"
    finally:
        jax_agg.close()
        port.close()


def test_spill_interval_matches_jax():
    jax_agg, port = _pair("raw", spill_threshold=5000)
    try:
        for ids, values in _stream(seed=3):
            _feed(jax_agg, ids, values)
            _feed(port, ids, values)
            port.flush(force=True)
            assert port._spill is not None
            _assert_same(port.collect().metrics, jax_agg.collect().metrics)
    finally:
        jax_agg.close()
        port.close()


@pytest.mark.parametrize("go_compat", [False, True])
def test_reference_goldens(go_compat):
    """Reference metrics_test: samples [33, 59, 330000] -> _sum 331132.69
    (after the codec round trip) and _agg_avg 110377.56 (110377 with the
    Go integer division)."""
    port = TorchAggregator(num_metrics=4, device="cpu",
                           config=MetricConfig(go_compat=go_compat))
    for v in (33, 59, 330000):
        port.record("histogram1", v)
    m = port.collect().metrics
    assert m["histogram1_sum"] == pytest.approx(331132.69, rel=1e-6)
    assert m["histogram1_count"] == 3.0
    if go_compat:
        assert m["histogram1_agg_avg"] == 110377.0
    else:
        assert m["histogram1_agg_avg"] == pytest.approx(110377.56, rel=1e-6)
    port.close()


def test_state_from_jax_then_collect_equals_jax_collect():
    jax_agg, _ = _pair("raw")
    stream = _stream(seed=4)
    try:
        for ids, values in stream[:2]:
            _feed(jax_agg, ids, values)
            jax_agg.collect()  # lifetime store fills
        _feed(jax_agg, *stream[2])
        jax_agg.flush(force=True)
        state = state_from_jax(
            np.asarray(jax_agg._acc), jax_agg.registry.names(),
            jax_agg._agg, jax_agg._spill,
        )
        port = TorchAggregator(num_metrics=2, device="cpu")
        port.load_state_dict(state)
        _assert_same(port.collect().metrics, jax_agg.collect().metrics)
        # and the port's own state round-trips
        _feed(port, *stream[0])
        again = TorchAggregator(num_metrics=6, device="cpu")
        again.load_state_dict(port.state_dict())
        assert port.collect().metrics == pytest.approx(
            again.collect().metrics)
        port.close()
        again.close()
    finally:
        jax_agg.close()


def test_worker_failure_surfaces_at_the_next_flush():
    """A device failure in the worker is retried, as in the reference:
    it surfaces as the armed cooldown and the requeued samples (the
    forced flush of collect() gives them one more attempt, which fails
    too), never as a lost or re-raised batch; once the device is back,
    the next collect() lands them."""
    jax_agg = TPUAggregator(num_metrics=2, config=JaxConfig(),
                            storage="dense", batch_size=8)
    port = TorchAggregator(num_metrics=2, batch_size=8, device="cpu")
    try:
        for agg in (jax_agg, port):
            agg.registry.id_for("m")
            real = agg._ingest

            def boom(*_):
                raise RuntimeError("injected device failure")

            agg._ingest = boom
            agg.record_batch(np.zeros(8, np.int32), np.ones(8, np.float32))
            assert "m_count" not in agg.collect().metrics
            assert agg.pending_samples == 8
            assert agg._device_down_until > 0.0
            agg._ingest = real
            assert agg.collect().metrics["m_count"] == 8.0
            assert agg.pending_samples == 0
    finally:
        jax_agg.close()
        port.close()


def test_a_worker_error_is_raised_at_the_next_flush_exactly_once(
        monkeypatch):
    """A failure that is not a device failure (``_process_xfer_item``
    raising) is stored by the transfer worker under ``_xfer_cv`` and
    raised by the next flush, once; the flush after it does not raise it
    again.  The reference has no worker error: this is the port's own
    contract."""
    agg = TorchAggregator(num_metrics=2, batch_size=8, device="cpu")
    try:
        mid = agg.registry.id_for("m")
        real = agg._process_xfer_item

        def boom(item):
            raise ValueError("injected worker fault")

        monkeypatch.setattr(agg, "_process_xfer_item", boom)
        agg.record_batch(np.full(8, mid, np.int32), np.ones(8, np.float32))
        agg.flush()  # enqueue only: the worker fails on its own thread
        deadline = time.monotonic() + 30.0
        while True:
            with agg._xfer_cv:
                if not agg._xfer_queue and not agg._xfer_active:
                    break
            assert time.monotonic() < deadline, "the worker never finished"
            time.sleep(0.005)
        with pytest.raises(RuntimeError, match="the transfer worker "
                           "failed to apply a batch") as info:
            agg.flush()
        assert isinstance(info.value.__cause__, ValueError)
        monkeypatch.setattr(agg, "_process_xfer_item", real)
        agg.flush()
        agg.record_batch(np.full(8, mid, np.int32), np.ones(8, np.float32))
        agg.flush(force=True)
        assert agg.collect().metrics["m_count"] == 8.0
    finally:
        agg.close()
