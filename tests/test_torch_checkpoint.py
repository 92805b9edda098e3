"""The port's checkpoints (``loghisto_tpu_torch.utils.checkpoint``) against
the JAX package's, on the CPU, at small sizes: bucket_limit 64 on dense
storage, 512 on paged storage (5 pages a row), 16 rows, pools of 512
pages.  Inputs are numpy arrays and bucket maps from a seed; the same
state is built in both packages, saved by each, and each file restored
into the other package.

Tolerances:
  * EQUAL: every ``.npz`` array (keys and dtypes too), every restored
    accumulator, host spill, pool, page table, free list, codec list,
    registry, activity vector, counter and watermark;
  * rtol 1e-12: lifetime sums that come from host statistics, where the
    two packages reduce in a different order (the host ``MetricSystem``'s
    ``ms_agg_sums``, and ``agg_sums`` of a spilled interval, which both
    packages take through the float64 host statistics);
  * drift banks: EQUAL through a file, as they are copied as float32 (the
    port's banks are carried over from the JAX manager's state, which
    ``tests/test_torch_anomaly.py`` holds to the port's own tolerance).

The JAX paged stores run their jnp tier (the aggregator's default).
"""

import datetime as dt
import logging
import os

import jax
import numpy as np
import pytest

from loghisto_tpu import MetricSystem as JaxMetricSystem
from loghisto_tpu.anomaly import AnomalyConfig as JaxAnomalyConfig
from loghisto_tpu.anomaly import AnomalyManager as JaxAnomalyManager
from loghisto_tpu.commit import IntervalCommitter as JaxCommitter
from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.labels import canonical_name as jax_canonical_name
from loghisto_tpu.lifecycle import LifecycleConfig as JaxLifecycleConfig
from loghisto_tpu.lifecycle import LifecycleManager as JaxLifecycleManager
from loghisto_tpu.metrics import RawMetricSet as JaxRaw
from loghisto_tpu.paging import PagedStoreConfig as JaxPagedConfig
from loghisto_tpu.parallel.aggregator import TPUAggregator
from loghisto_tpu.utils import checkpoint as jck
from loghisto_tpu.window import TimeWheel as JaxWheel
from loghisto_tpu_torch.anomaly import AnomalyConfig, AnomalyManager
from loghisto_tpu_torch.commit import IntervalCommitter
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.labels import canonical_name
from loghisto_tpu_torch.lifecycle import LifecycleConfig, LifecycleManager
from loghisto_tpu_torch.metrics import MetricSystem, RawMetricSet
from loghisto_tpu_torch.paging import PagedStoreConfig
from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
from loghisto_tpu_torch.utils import checkpoint
from loghisto_tpu_torch.window.store import TimeWheel

M = 16
BL = 64
PBL = 512
POOL = 512
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
CODECS = ("dense", "loglinear", "polytail", "auto")
NAMES = [f"api.s{k}.lat" for k in range(10)]
HOST_SUM_KEYS = ("ms_agg_sums",)


def _hists(rng, names, bl, cells=12, weight=9):
    """A seeded bucket map per name: a band of cells around a per-name
    centre and a few wide ones, with repeats."""
    out = {}
    for k, name in enumerate(names):
        centre = int(rng.integers(-bl // 2, bl // 2))
        b = np.concatenate([centre + rng.integers(-8, 8, cells),
                            rng.integers(-bl, bl + 1, 3)])
        h = {}
        counts = rng.integers(1, weight, len(b)).tolist()
        for bb, cc in zip(b.tolist(), counts):
            h[bb] = h.get(bb, 0) + cc
        out[name] = h
    return out


def _raws(hists, i=0, **kw):
    """The same interval as a JAX and a port RawMetricSet."""
    fields = dict(time=T0 + dt.timedelta(seconds=i), counters={}, rates={},
                  histograms=hists, gauges={}, duration=1.0, **kw)
    return JaxRaw(**fields), RawMetricSet(**fields)


def _synchronised(com):
    """Wait for each JAX commit step before the next is staged (ROADMAP
    F3: on the CPU ``jax.device_put`` reads the staging slot after it
    returns)."""
    for attr in ("_fused", "_fused_snap"):
        step = getattr(com, attr)
        setattr(com, attr,
                lambda *a, _step=step: jax.block_until_ready(_step(*a)))
    return com


def _aggs(m=M, bl=BL, paged=None, **kw):
    """A JAX and a port aggregator of the same configuration; ``paged``
    is a codec name for paged storage."""
    jkw, pkw = dict(kw), dict(kw)
    if paged is not None:
        jkw.update(storage="paged", paged_config=JaxPagedConfig(
            pool_pages=POOL, codec=paged))
        pkw.update(storage="paged", paged_config=PagedStoreConfig(
            pool_pages=POOL, codec=paged))
    else:
        jkw.setdefault("storage", "dense")
        pkw.setdefault("storage", "dense")
    go = jkw.pop("go_compat", False)
    pkw.pop("go_compat", None)
    jagg = TPUAggregator(num_metrics=m, config=JaxConfig(
        bucket_limit=bl, go_compat=go), **jkw)
    pagg = TorchAggregator(num_metrics=m, config=MetricConfig(
        bucket_limit=bl, go_compat=go), device="cpu", **pkw)
    return jagg, pagg


def _agreeing(rng, n, bl):
    """Values on which the JAX float32 codec and the float64 codec agree
    (ROADMAP F1), so both packages bucket them alike."""
    import jax.numpy as jnp

    from loghisto_tpu.ops.ingest import bucket_indices
    from loghisto_tpu_torch.ops.codec import compress_np

    v = rng.lognormal(-1.5, 0.6, 4 * n).astype(np.float32)
    got = np.asarray(bucket_indices(jnp.asarray(v), bl)) - bl
    v = v[got == np.clip(compress_np(v), -bl, bl)]
    return v[:n]


# -- the states, built alike in both packages -------------------------------
#
# Each state function returns (jax_targets, port_targets, save_kw): the
# keyword arguments of ``save`` / ``restore`` for each package.


def _merge(jagg, pagg, rng, names, bl, intervals=2):
    for i in range(intervals):
        jraw, praw = _raws(_hists(rng, names, bl), i)
        jagg.merge_raw(jraw)
        pagg.merge_raw(praw)


def _state_dense(rng, watermark=None):
    jagg, pagg = _aggs()
    _merge(jagg, pagg, rng, NAMES, BL)
    # an unnamed row, through record_batch with a raw id
    ids = np.full(40, 13, dtype=np.int32)
    values = _agreeing(rng, 40, BL)
    ids = ids[: len(values)]
    for a in (jagg, pagg):
        a.record_batch(ids, values)
        a.flush(force=True)
    return ({"aggregator": jagg}, {"aggregator": pagg},
            {"seq_watermark": watermark})


def _state_paged(rng, codec):
    jagg, pagg = _aggs(bl=PBL, paged=codec)
    _merge(jagg, pagg, rng, NAMES, PBL, intervals=3)
    return {"aggregator": jagg}, {"aggregator": pagg}, {}


def _state_multirow(rng):
    jagg, pagg = _aggs(ingest_path="multirow", transport="raw")
    for name in NAMES:
        assert jagg.registry.id_for(name) == pagg.registry.id_for(name)
    ids = rng.integers(0, len(NAMES), 600).astype(np.int32)
    values = _agreeing(rng, 600, BL)
    ids = ids[: len(values)]
    for a in (jagg, pagg):
        a.record_batch(ids, values)
        a.flush(force=True)
    return {"aggregator": jagg}, {"aggregator": pagg}, {}


def _state_spilled(rng):
    jagg, pagg = _aggs(batch_size=64)
    big = {"hot": {10: (1 << 31) + 777}, NAMES[0]: {3: 5}}
    for i in range(2):
        _merge(jagg, pagg, rng, NAMES[:4], BL, intervals=1)
        jraw, praw = _raws(big, 1)
        jagg.merge_raw(jraw)
        pagg.merge_raw(praw)
        if not i:
            # a spilled interval: its lifetime sums come from the
            # float64 host statistics
            for a in (jagg, pagg):
                a.collect()
    assert jagg._spill is not None and pagg._spill is not None
    return {"aggregator": jagg}, {"aggregator": pagg}, {}


def _state_go_compat(rng):
    jms = JaxMetricSystem(interval=1e-6, sys_stats=False,
                          config=JaxConfig(go_compat=True))
    pms = MetricSystem(interval=1e-6, sys_stats=False,
                       config=MetricConfig(go_compat=True))
    for ms in (jms, pms):
        ms.counter("reqs", 500)
        ms.histogram("neg", -1000.0)
        ms.histogram("lat", 100.0)
        raw = ms.collect_raw_metrics()
        ms._attach_aggregates(ms.process_metrics(raw), raw)
    jagg, pagg = _aggs(go_compat=True)
    _merge(jagg, pagg, rng, NAMES[:3], BL, intervals=1)
    return ({"metric_system": jms, "aggregator": jagg},
            {"metric_system": pms, "aggregator": pagg}, {})


def _committers(lifecycle=None, anomaly=None, m=M, tiers=((4, 1),)):
    """A JAX and a port (aggregator, wheel, lifecycle, anomaly, committer)
    of the same configuration on dense storage."""
    jcfg, pcfg = JaxConfig(bucket_limit=BL), MetricConfig(bucket_limit=BL)
    jagg = TPUAggregator(num_metrics=m, config=jcfg, storage="dense")
    pagg = TorchAggregator(num_metrics=m, config=pcfg, device="cpu")
    jwheel = JaxWheel(num_metrics=m, config=jcfg, interval=1.0, tiers=tiers,
                      registry=jagg.registry, merge_path="jnp")
    pwheel = TimeWheel(num_metrics=m, config=pcfg, interval=1.0, tiers=tiers,
                       registry=pagg.registry, device="cpu")
    jlc = plc = jan = pan = None
    if lifecycle is not None:
        jlc = JaxLifecycleManager(jagg, jwheel,
                                  JaxLifecycleConfig(**lifecycle))
        plc = LifecycleManager(pagg, pwheel, LifecycleConfig(**lifecycle))
    if anomaly is not None:
        jan = JaxAnomalyManager(jagg, jwheel, JaxAnomalyConfig(
            divergence_path="jnp", **anomaly))
        pan = AnomalyManager(pagg, pwheel, AnomalyConfig(**anomaly))
        if jlc is not None:
            jlc.anomaly, plc.anomaly = jan, pan
    jcom = _synchronised(JaxCommitter(jagg, jwheel, lifecycle=jlc,
                                      anomaly=jan))
    pcom = IntervalCommitter(pagg, pwheel, lifecycle=plc, anomaly=pan)
    return (jagg, jlc, jan, jcom), (pagg, plc, pan, pcom)


LC = dict(check_every=1000, auto_compact_fragmentation=0.0)
AN = dict(banks=2, bank_of=lambda t: t.hour, decay=0.9, min_samples=4)


def _state_lifecycle(rng):
    (jagg, jlc, _, jcom), (pagg, plc, _, pcom) = _committers(lifecycle=LC)
    for i, names in enumerate((NAMES[:6], NAMES[:2] + ["db.q"])):
        jraw, praw = _raws(_hists(rng, names, BL), i)
        jcom.commit(jraw)
        pcom.commit(praw)
    victims = [pagg.registry.lookup(n) for n in NAMES[2:4]]
    assert victims == [jagg.registry.lookup(n) for n in NAMES[2:4]]
    jlc.evict_ids(victims)
    plc.evict_ids(victims)
    assert pagg.registry.names().count(None) == 2  # holes
    return ({"aggregator": jagg, "lifecycle": jlc},
            {"aggregator": pagg, "lifecycle": plc}, {"seq_watermark": 2})


def _state_anomaly(rng):
    (jagg, _, jan, jcom), (pagg, _, pan, pcom) = _committers(anomaly=AN)
    for i in range(4):
        jraw, praw = _raws(_hists(rng, NAMES[:4], BL, weight=30), i)
        jcom.commit(jraw)
        pcom.commit(praw)
    # the port's banks from this stream agree with JAX's to the drift
    # tolerance; the file is held EQUAL on the same banks
    st = jan.state_dict()
    np.testing.assert_allclose(pan.state_dict()["prof"], st["prof"],
                               rtol=1e-6, atol=1e-7)
    pan.load_state({k: np.asarray(v) if k != "scored_intervals" else v
                    for k, v in st.items()})
    return ({"aggregator": jagg, "anomaly": jan},
            {"aggregator": pagg, "anomaly": pan}, {})


STATES = {
    "dense": lambda rng: _state_dense(rng),
    "dense_watermark": lambda rng: _state_dense(rng, watermark=8),
    **{f"paged_{c}": (lambda rng, c=c: _state_paged(rng, c)) for c in CODECS},
    "multirow": _state_multirow,
    "spilled": _state_spilled,
    "go_compat": _state_go_compat,
    "lifecycle": _state_lifecycle,
    "anomaly": _state_anomaly,
}


def _fresh_like(targets, package):
    """Fresh restore targets of the same kinds as ``targets`` (a saved
    state's), for ``package`` "jax" or "port"; every aggregator holds
    another name at id 0, so each restore remaps by name."""
    src = targets["aggregator"]
    paged = src.paged is not None
    codec = src.paged.config.codec if paged else None
    bl = src.config.bucket_limit
    kw = {}
    if src.ingest_path == "multirow":
        kw.update(ingest_path="multirow", transport="raw")
    if src.config.go_compat:
        kw["go_compat"] = True
    if "lifecycle" in targets or "anomaly" in targets:
        (jagg, jlc, jan, _), (pagg, plc, pan, _) = _committers(
            lifecycle=LC if "lifecycle" in targets else None,
            anomaly=AN if "anomaly" in targets else None)
        agg, lc, an = (jagg, jlc, jan) if package == "jax" else (pagg, plc,
                                                                 pan)
        out = {"aggregator": agg}
        if lc is not None:
            out["lifecycle"] = lc
        if an is not None:
            out["anomaly"] = an
    else:
        jagg, pagg = _aggs(bl=bl, paged=codec, **kw)
        out = {"aggregator": jagg if package == "jax" else pagg}
    out["aggregator"]._id_for("other")
    if "metric_system" in targets:
        cfg = (JaxConfig if package == "jax" else MetricConfig)(
            go_compat=src.config.go_compat)
        cls = JaxMetricSystem if package == "jax" else MetricSystem
        out["metric_system"] = cls(interval=1e-6, sys_stats=False,
                                   config=cfg)
    return out


def _acc(agg):
    """An aggregator's whole histogram state as int64 [M, B]."""
    if agg.paged is not None:
        return agg.paged.decode_dense(include_spill=True)
    acc = np.asarray(agg._finalize_acc(agg._acc) if hasattr(
        agg, "_finalize_acc") else agg._acc.numpy()).astype(np.int64)
    return acc if agg._spill is None else acc + agg._spill


def _assert_files_equal(jpath, ppath):
    with np.load(jpath) as jf, np.load(ppath) as pf:
        assert sorted(jf.files) == sorted(pf.files)
        for key in jf.files:
            assert jf[key].dtype == pf[key].dtype, key
            assert jf[key].shape == pf[key].shape, key
            if key in HOST_SUM_KEYS or (key == "agg_sums"
                                        and jf["agg_acc"].dtype == np.int64):
                np.testing.assert_allclose(pf[key], jf[key], rtol=1e-12,
                                           err_msg=key)
            else:
                np.testing.assert_array_equal(pf[key], jf[key], err_msg=key)


def _assert_restored_equal(jt, pt):
    """A JAX and a port restore target after restoring the same state."""
    jagg, pagg = jt["aggregator"], pt["aggregator"]
    assert pagg.registry.names() == jagg.registry.names()
    assert pagg.registry.generation == jagg.registry.generation
    assert pagg.num_metrics == jagg.num_metrics
    np.testing.assert_array_equal(_acc(pagg), _acc(jagg))
    assert (pagg._spill is None) == (jagg._spill is None)
    assert sorted(pagg._agg) == sorted(jagg._agg)
    for mid, (s, c) in jagg._agg.items():
        assert pagg._agg[mid][1] == c
        assert pagg._agg[mid][0] == pytest.approx(s, rel=1e-12)
    if jagg.paged is not None:
        jst, pst = jagg.paged, pagg.paged
        np.testing.assert_array_equal(np.asarray(jst._pool),
                                      pst._pool.numpy())
        np.testing.assert_array_equal(pst.page_table, jst.page_table)
        np.testing.assert_array_equal(pst.row_codec, jst.row_codec)
        assert pst.codec_names() == jst.codec_names()
        assert pst.free_list() == jst._free_lists[0]
        assert pst._host_spill == jst._host_spill
    if "lifecycle" in jt:
        jst, pst = jt["lifecycle"].state_dict(), pt["lifecycle"].state_dict()
        for key, want in jst.items():
            np.testing.assert_array_equal(np.asarray(pst[key]),
                                          np.asarray(want), err_msg=key)
    if "anomaly" in jt:
        jst, pst = jt["anomaly"].state_dict(), pt["anomaly"].state_dict()
        for key, want in jst.items():
            np.testing.assert_array_equal(np.asarray(pst[key]),
                                          np.asarray(want), err_msg=key)
    if "metric_system" in jt:
        jms, pms = jt["metric_system"], pt["metric_system"]
        assert pms._counter_store == jms._counter_store
        assert pms._histogram_agg_store == jms._histogram_agg_store


@pytest.mark.parametrize("state", sorted(STATES))
def test_file_both_ways(tmp_path, state):
    """The same state saved by each package: the same keys, dtypes and
    arrays; each file restores into the other package with equal
    results (and the same watermark)."""
    rng = np.random.default_rng(abs(hash(state)) % 2**32)
    jt, pt, save_kw = STATES[state](rng)
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jck.save(jpath, **jt, **save_kw)
    checkpoint.save(ppath, **pt, **save_kw)
    _assert_files_equal(jpath, ppath)
    want_wm = save_kw.get("seq_watermark")

    port_from_jax = _fresh_like(jt, "port")
    jax_from_port = _fresh_like(jt, "jax")
    assert checkpoint.restore(jpath, **port_from_jax) == want_wm
    assert jck.restore(ppath, **jax_from_port) == want_wm
    _assert_restored_equal(jax_from_port, port_from_jax)
    # and a port file read back by the port equals a JAX file by JAX
    port_from_port = _fresh_like(jt, "port")
    jax_from_jax = _fresh_like(jt, "jax")
    checkpoint.restore(ppath, **port_from_port)
    jck.restore(jpath, **jax_from_jax)
    _assert_restored_equal(jax_from_jax, port_from_port)
    _assert_restored_equal(jax_from_port, port_from_port)


def test_lifecycle_restore_keeps_holes_and_remaps_activity(tmp_path):
    """The lifecycle state after an eviction with a hole: the target's
    generation is no lower than the saved one, the evicted name does not
    come back, the overflow row conserves the counts and the activity
    vector follows each name (JAX ``test_lifecycle_roundtrip_generation
    _and_overflow``)."""
    jt, pt, _ = _state_lifecycle(np.random.default_rng(7))
    path = str(tmp_path / "lc.npz")
    checkpoint.save(path, **pt)
    src_agg, src_lc = pt["aggregator"], pt["lifecycle"]
    tgt = _fresh_like(pt, "port")
    checkpoint.restore(path, **tgt)
    agg, lc = tgt["aggregator"], tgt["lifecycle"]
    reg, src_reg = agg.registry, src_agg.registry
    assert reg.generation >= src_reg.generation > 0
    assert reg.lookup(NAMES[2]) is None and reg.lookup(NAMES[3]) is None
    assert lc.evicted_series == 2 and lc.evictions == 1
    assert lc.overflowed_samples == src_lc.overflowed_samples > 0
    ov = reg.lookup("_overflow.api")
    assert int(agg._acc[ov].sum()) == int(
        src_agg._acc[src_reg.lookup("_overflow.api")].sum())
    assert int(agg._acc.sum()) == int(src_agg._acc.sum())
    la, src_la = lc._la.numpy(), src_lc._la.numpy()
    for name in NAMES[:2] + ["db.q", NAMES[4]]:
        assert reg.lookup(name) != src_reg.lookup(name)
        assert la[reg.lookup(name)] == src_la[src_reg.lookup(name)]


# -- older and foreign files ------------------------------------------------


def _rewrite(path, version, drop=()):
    data = dict(np.load(path, allow_pickle=False))
    data["version"] = np.int64(version)
    for key in drop:
        data.pop(key, None)
    np.savez(path, **data)


@pytest.mark.parametrize("version", [1, 2])
def test_older_versions_restore_into_the_port(tmp_path, version):
    """v1 and v2 files, made as the JAX tests make them: a JAX save with
    the version stamp rewritten (v1: no watermark; v2: no codec
    sidecar), restore into dense and paged port aggregators."""
    jagg = TPUAggregator(num_metrics=8, config=JaxConfig(bucket_limit=PBL),
                         storage="paged",
                         paged_config=JaxPagedConfig(pool_pages=POOL))
    jagg.record("m", 5.0)
    jagg.flush(force=True)
    path = str(tmp_path / f"v{version}.npz")
    jck.save(path, aggregator=jagg, seq_watermark=7)
    _rewrite(path, version, drop=("seq_watermark", "pg_codec_names")
             if version == 1 else ("pg_codec_names",))
    want = jagg.paged.decode_dense()
    dense = TorchAggregator(num_metrics=8, config=MetricConfig(
        bucket_limit=PBL), device="cpu")
    paged = TorchAggregator(num_metrics=8, config=MetricConfig(
        bucket_limit=PBL), device="cpu", storage="paged",
        paged_config=PagedStoreConfig(pool_pages=POOL))
    for agg in (dense, paged):
        got = checkpoint.restore(path, aggregator=agg)
        assert got == (None if version == 1 else 7)
        np.testing.assert_array_equal(_acc(agg), want)
        assert agg.collect().metrics["m_count"] == 1


def test_future_version_refused(tmp_path):
    pagg = TorchAggregator(num_metrics=8, config=MetricConfig(bucket_limit=BL),
                           device="cpu")
    pagg.record("m", 0.5)
    path = str(tmp_path / "fut.npz")
    checkpoint.save(path, aggregator=pagg)
    _rewrite(path, 99)
    with pytest.raises(ValueError, match="version"):
        checkpoint.restore(path, aggregator=TorchAggregator(
            num_metrics=8, config=MetricConfig(bucket_limit=BL),
            device="cpu"))
    with pytest.raises(ValueError, match="version"):
        jck.restore(path, aggregator=TPUAggregator(
            num_metrics=8, config=JaxConfig(bucket_limit=BL),
            storage="dense"))


def test_jax_mesh_save_restores_at_world_size_one(tmp_path):
    """A JAX paged save taken on a 2x4 mesh of virtual CPU devices (as
    ``tests/test_mesh_paged.py`` takes one) restores into the port at
    world size 1, paged and dense, with the saved codecs."""
    from loghisto_tpu.parallel.mesh import make_mesh

    assert jax.device_count() >= 8, "conftest must provide 8 CPU devices"
    m, bl = 64, 128
    src = TPUAggregator(num_metrics=m, config=JaxConfig(bucket_limit=bl),
                        storage="paged", mesh=make_mesh(stream=2, metric=4),
                        paged_config=JaxPagedConfig(pool_pages=256))
    for j in range(32):
        src._id_for(f"h{j}")
    rng = np.random.default_rng(0)
    packed = np.empty((2000, 3), np.int32)
    packed[:, 0] = rng.integers(0, 32, 2000)
    packed[:, 1] = rng.integers(-bl, bl + 1, 2000)
    packed[:, 2] = rng.integers(1, 50, 2000)
    src.paged.commit(packed)
    want, codecs = src.paged.decode_dense(), src.paged.codec_names()
    path = str(tmp_path / "mesh.npz")
    jck.save(path, aggregator=src)

    paged = TorchAggregator(num_metrics=m, config=MetricConfig(
        bucket_limit=bl), device="cpu", storage="paged",
        paged_config=PagedStoreConfig(pool_pages=256))
    checkpoint.restore(path, aggregator=paged)
    np.testing.assert_array_equal(paged.paged.decode_dense(), want)
    assert paged.paged.codec_names() == codecs
    dense = TorchAggregator(num_metrics=m, config=MetricConfig(
        bucket_limit=bl), device="cpu")
    checkpoint.restore(path, aggregator=dense)
    np.testing.assert_array_equal(_acc(dense), want)


# -- cross-storage and the restore rules ------------------------------------


@pytest.mark.parametrize("direction", ["paged_to_dense", "dense_to_paged"])
def test_cross_storage_restore_equals_jax(tmp_path, direction):
    """A paged save into a dense aggregator and a dense save into a paged
    one: the port's restore equals the JAX restore of the same file."""
    rng = np.random.default_rng(11)
    src_paged = direction == "paged_to_dense"
    jsrc, psrc = _aggs(bl=PBL, paged="auto" if src_paged else None)
    _merge(jsrc, psrc, rng, NAMES, PBL)
    path = str(tmp_path / "x.npz")
    checkpoint.save(path, aggregator=psrc)
    jdst, pdst = _aggs(bl=PBL, paged=None if src_paged else "auto")
    for dst in (jdst, pdst):
        dst._id_for("other")
    jck.restore(path, aggregator=jdst)
    checkpoint.restore(path, aggregator=pdst)
    _assert_restored_equal({"aggregator": jdst}, {"aggregator": pdst})
    for name in NAMES:
        np.testing.assert_array_equal(
            _acc(pdst)[pdst.registry.lookup(name)],
            _acc(psrc)[psrc.registry.lookup(name)])


def test_restore_into_nonempty_registry_remaps_by_name(tmp_path):
    rng = np.random.default_rng(12)
    jsrc, psrc = _aggs()
    _merge(jsrc, psrc, rng, NAMES[:4], BL)
    path = str(tmp_path / "r.npz")
    checkpoint.save(path, aggregator=psrc)
    jdst, pdst = _aggs()
    for dst in (jdst, pdst):
        for name in ("x", "y", NAMES[2]):
            dst._id_for(name)
    jraw, praw = _raws({"x": {3: 4}, NAMES[2]: {1: 2}}, 5)
    jdst.merge_raw(jraw)
    pdst.merge_raw(praw)
    jck.restore(path, aggregator=jdst)
    checkpoint.restore(path, aggregator=pdst)
    _assert_restored_equal({"aggregator": jdst}, {"aggregator": pdst})
    src, dst = _acc(psrc), _acc(pdst)
    reg = pdst.registry
    assert reg.lookup(NAMES[0]) == 3  # after x, y and NAMES[2]
    for name in (NAMES[0], NAMES[1], NAMES[3]):
        np.testing.assert_array_equal(dst[reg.lookup(name)],
                                      src[psrc.registry.lookup(name)])
    two = src[psrc.registry.lookup(NAMES[2])].copy()
    two[1 + BL] += 2
    np.testing.assert_array_equal(dst[reg.lookup(NAMES[2])], two)


def test_grow_shed_and_unnamed_rows_follow_the_reference(tmp_path, caplog):
    """The grow policy applies to restores, a name past max_metrics is
    shed with a warning, and an unnamed row keeps its id only where no
    named metric owns it, in both packages alike."""
    rng = np.random.default_rng(13)
    jsrc, psrc = _aggs(m=8)
    _merge(jsrc, psrc, rng, [f"n{k}" for k in range(6)], BL, intervals=1)
    ids = np.array([6, 6, 7], dtype=np.int32)
    values = np.array([0.25, 0.5, 0.3], dtype=np.float32)
    for a in (jsrc, psrc):
        a.record_batch(ids, values)
        a.flush(force=True)
    path = str(tmp_path / "g.npz")
    checkpoint.save(path, aggregator=psrc)
    for kw in (dict(m=8, max_metrics=16), dict(m=8, max_metrics=8)):
        jdst, pdst = _aggs(**kw)
        for dst in (jdst, pdst):
            for k in range(3):
                dst._id_for(f"o{k}")
        with caplog.at_level(logging.WARNING):
            jck.restore(path, aggregator=jdst)
            checkpoint.restore(path, aggregator=pdst)
        _assert_restored_equal({"aggregator": jdst}, {"aggregator": pdst})
        assert pdst._registry_shed_samples == jdst._registry_shed_samples
    messages = [r.getMessage() for r in caplog.records
                if r.name == "loghisto_tpu_torch"]
    assert any("shed" in m for m in messages)
    assert any("unnamed checkpoint row" in m for m in messages)


def test_shape_mismatch_refused(tmp_path):
    pagg = TorchAggregator(num_metrics=8, config=MetricConfig(bucket_limit=BL),
                           device="cpu")
    pagg.record("m", 0.5)
    path = str(tmp_path / "s.npz")
    checkpoint.save(path, aggregator=pagg)
    for other in (
        TorchAggregator(num_metrics=4, config=MetricConfig(bucket_limit=BL),
                        device="cpu"),
        TorchAggregator(num_metrics=8, config=MetricConfig(bucket_limit=32),
                        device="cpu"),
    ):
        with pytest.raises(ValueError, match="does not fit"):
            checkpoint.restore(path, aggregator=other)


@pytest.mark.parametrize("target", ["dense", "paged"])
def test_successive_restores_route_to_the_spill(tmp_path, target):
    """Restored counts never raise ``_interval_ingested``, so the second
    of two 0.9e9 restores takes the exact host spill (the dense
    accumulator's, or the paged store's), as in JAX; no int32 wraps."""
    per_worker = 900_000_000
    src = TorchAggregator(num_metrics=8, config=MetricConfig(bucket_limit=PBL),
                          device="cpu", batch_size=64)
    src.registry.id_for("hot")
    src.merge_raw(_raws({"hot": {10: per_worker}})[1])
    path = str(tmp_path / "w.npz")
    checkpoint.save(path, aggregator=src)
    jdst, pdst = _aggs(m=8, bl=PBL, paged="auto" if target == "paged"
                       else None, batch_size=64)
    for _ in range(2):
        jck.restore(path, aggregator=jdst)
        checkpoint.restore(path, aggregator=pdst)
    _assert_restored_equal({"aggregator": jdst}, {"aggregator": pdst})
    if target == "paged":
        assert len(pdst.paged._host_spill) > 0
    else:
        assert pdst._spill is not None
    assert pdst.collect().metrics["hot_count"] == float(2 * per_worker)


def test_labeled_names_survive_a_round_trip(tmp_path):
    """Labeled series keep their canonical names through a save and a
    restore into a non-empty registry (JAX ``tests/test_labels.py::
    test_labeled_names_survive_checkpoint``), and the port's file of
    them equals the JAX one."""
    labels = ({"route": "/a", "code": "200"}, {"route": "/b", "code": "500"})
    names = [canonical_name("rpc.latency", lb) for lb in labels]
    assert names == [jax_canonical_name("rpc.latency", lb) for lb in labels]
    rng = np.random.default_rng(14)
    jsrc, psrc = _aggs()
    _merge(jsrc, psrc, rng, names, BL, intervals=1)
    jpath, ppath = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jck.save(jpath, aggregator=jsrc)
    checkpoint.save(ppath, aggregator=psrc)
    _assert_files_equal(jpath, ppath)
    dst = TorchAggregator(num_metrics=M, config=MetricConfig(bucket_limit=BL),
                          device="cpu")
    dst._id_for("other")
    checkpoint.restore(jpath, aggregator=dst)
    out = dst.collect().metrics
    for name in names:
        assert out[f"{name}_count"] == float(
            sum(_acc(psrc)[psrc.registry.lookup(name)]))


def test_metric_system_round_trip_both_ways(tmp_path):
    """The host lifetime stores, both ways, under the default float
    sums."""
    jms = JaxMetricSystem(interval=1e-6, sys_stats=False)
    pms = MetricSystem(interval=1e-6, sys_stats=False)
    for ms in (jms, pms):
        ms.counter("reqs", 500)
        for v in (33.0, 59.0, 330000.0):
            ms.histogram("lat", v)
        raw = ms.collect_raw_metrics()
        ms._attach_aggregates(ms.process_metrics(raw), raw)
    jpath, ppath = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jck.save(jpath, metric_system=jms)
    checkpoint.save(ppath, metric_system=pms)
    _assert_files_equal(jpath, ppath)
    back = MetricSystem(interval=1e-6, sys_stats=False)
    checkpoint.restore(jpath, metric_system=back)
    jback = JaxMetricSystem(interval=1e-6, sys_stats=False)
    jck.restore(ppath, metric_system=jback)
    assert back._counter_store == jback._counter_store == {"reqs": 500}
    assert back._histogram_agg_store["lat"][1] == 3
    assert back._histogram_agg_store["lat"][0] == pytest.approx(
        jback._histogram_agg_store["lat"][0], rel=1e-12)


# -- the atomic write -------------------------------------------------------


class _Raises:
    """A duck-typed fault injector that raises at one site."""

    def __init__(self, site):
        self.site = site
        self.seen = []

    def check(self, site):
        self.seen.append(site)
        if site == self.site:
            raise RuntimeError(f"injected at {site}")


@pytest.mark.parametrize("site", ["checkpoint.write", "checkpoint.rename"])
def test_injected_crash_leaves_the_previous_snapshot(tmp_path, site):
    pagg = TorchAggregator(num_metrics=8, config=MetricConfig(bucket_limit=BL),
                           device="cpu")
    pagg.record("m", 0.5)
    path = str(tmp_path / "crash.npz")
    checkpoint.save(path, aggregator=pagg, seq_watermark=7)
    before = open(path, "rb").read()
    pagg.record("m", 0.25)
    inj = _Raises(site)
    with pytest.raises(RuntimeError, match="injected"):
        checkpoint.save(path, aggregator=pagg, seq_watermark=8,
                        fault_injector=inj)
    assert inj.seen[-1] == site
    assert open(path, "rb").read() == before
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
    fresh = TorchAggregator(num_metrics=8,
                            config=MetricConfig(bucket_limit=BL),
                            device="cpu")
    assert checkpoint.restore(path, aggregator=fresh) == 7
    assert fresh.collect().metrics["m_count"] == 1


def test_multirow_device_failure_rebuilds_right_layout():
    """Port copy of the JAX test that waited for the device-failure
    requeue: a multirow ingest step that fails once is retried, and the
    accumulator keeps its layout (the port's is the canonical [M, B],
    D7, and in-place kernels consume nothing)."""
    outs = []
    for agg in _aggs(m=8, ingest_path="multirow", transport="raw"):
        agg.retry_cooldown = 0.0
        agg.registry.id_for("m")
        real = agg._ingest
        calls = [0]

        def flaky(*a, _real=real, _calls=calls):
            _calls[0] += 1
            if _calls[0] == 1:
                raise RuntimeError("device gone")
            return _real(*a)

        agg._ingest = flaky
        shape = tuple(agg._acc.shape)
        agg.record_batch(np.zeros(10, dtype=np.int32),
                         np.full(10, 5.0, dtype=np.float32))
        agg.flush()  # fails; the samples are requeued, not lost
        out = agg.collect().metrics
        assert out["m_count"] == 10
        assert tuple(agg._acc.shape) == shape
        outs.append(out)
        agg.close()
    assert outs[0]["m_count"] == outs[1]["m_count"]
