"""The port's drift engine (``loghisto_tpu_torch.anomaly``,
``ops/anomaly.py`` with K7's plain version) against the JAX package's,
at small sizes (M = 16, bucket_limit 256, one (4, 1) tier), plus the
behaviours ``tests/test_anomaly.py`` pins for the reference.

Tolerances (measured on this suite's inputs, stated with their reason):
  * EWMA banks: rtol 1e-6, atol 1e-7 — the same float32 operations,
    which XLA may contract into fused multiply-adds;
  * scores against JAX's jnp and interpret-mode Pallas tiers: ks atol
    2e-6 (the base CDF, at most 1, is a float32 cumsum summed in another
    order: a few ulps of 1), emd rtol 1e-4 plus atol B * 2^-23 (a sum of
    B such differences, one ulp of 1 per bucket), jsd atol 1e-5 (log2 of
    ratios of float32 pmfs, summed over B terms);
  * masked rows (below the min-sample floor, no baseline, past the
    bank): exactly 0 on both sides.
"""

import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loghisto_tpu.anomaly import AnomalyConfig as JaxAnomalyConfig
from loghisto_tpu.anomaly import AnomalyManager as JaxAnomalyManager
from loghisto_tpu.commit import IntervalCommitter as JaxCommitter
from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.lifecycle import LifecycleConfig as JaxLifecycleConfig
from loghisto_tpu.lifecycle import LifecycleManager as JaxLifecycleManager
from loghisto_tpu.ops.anomaly import divergence_scores as jax_divergence
from loghisto_tpu.ops.anomaly import ewma_bank_update as jax_ewma
from loghisto_tpu.ops.anomaly import make_divergence_fn as jax_div_fn
from loghisto_tpu.parallel.aggregator import TPUAggregator
from loghisto_tpu.window import TimeWheel as JaxWheel
from loghisto_tpu_torch.anomaly import AnomalyConfig, AnomalyManager, \
    hourly_bank
from loghisto_tpu_torch.commit import IntervalCommitter
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.lifecycle import LifecycleConfig, LifecycleManager
from loghisto_tpu_torch.metrics import RawMetricSet
from loghisto_tpu_torch.ops.anomaly import (
    divergence_kernel,
    divergence_plain,
    divergence_scores,
    ewma_bank_update,
    make_bank_compact_fn,
    resolve_divergence_path,
)
from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
from loghisto_tpu_torch.window import DistributionDriftRule, RuleEngine
from loghisto_tpu_torch.window.store import TimeWheel

BL = 256
M = 16
TIERS = ((4, 1),)
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)


def _tol(b):
    return {"ks": dict(rtol=0, atol=2e-6), "jsd": dict(rtol=0, atol=1e-5),
            "emd": dict(rtol=1e-4, atol=b * 2.0**-23)}


# one median (bucket 100), two shapes
UNIMODAL = {90: 100, 100: 200, 110: 100}
BIMODAL = {50: 120, 90: 40, 100: 160, 110: 40, 150: 120}


def _raw(i, hists=None, t0=T0):
    return RawMetricSet(
        time=t0 + dt.timedelta(seconds=i), counters={}, rates={},
        histograms=dict(hists or {}), gauges={}, duration=1.0,
    )


def _port(config=None, lifecycle=None, m=M):
    cfg = MetricConfig(bucket_limit=BL)
    agg = TorchAggregator(num_metrics=m, config=cfg, device="cpu")
    wheel = TimeWheel(num_metrics=m, config=cfg, interval=1.0, tiers=TIERS,
                      registry=agg.registry, device="cpu")
    am = AnomalyManager(agg, wheel, config or AnomalyConfig(
        decay=0.8, min_samples=16))
    lc = None
    if lifecycle is not None:
        lc = LifecycleManager(agg, wheel, lifecycle)
        lc.anomaly = am
    com = IntervalCommitter(agg, wheel, lifecycle=lc, anomaly=am)
    return com, agg, wheel, am, lc


def _jax(config, lifecycle=None, m=M):
    cfg = JaxConfig(bucket_limit=BL)
    agg = TPUAggregator(num_metrics=m, config=cfg, storage="dense")
    wheel = JaxWheel(num_metrics=m, config=cfg, interval=1.0, tiers=TIERS,
                     registry=agg.registry, merge_path="jnp")
    am = JaxAnomalyManager(agg, wheel, config)
    lc = None
    if lifecycle is not None:
        lc = JaxLifecycleManager(agg, wheel, lifecycle)
        lc.anomaly = am
    com = JaxCommitter(agg, wheel, lifecycle=lc, anomaly=am)
    return _synchronised(com), agg, wheel, am, lc


def _synchronised(com):
    """Wait for each JAX commit step before the next is staged: the JAX
    ``CellStagingRing`` rewrites a host slot two stages later, and on the
    CPU ``jax.device_put`` reads that memory after it returns, so an
    unfinished step would see the next chunk's cells (ROADMAP F3)."""
    for attr in ("_fused", "_fused_snap"):
        step = getattr(com, attr)
        setattr(com, attr,
                lambda *a, _step=step: jax.block_until_ready(_step(*a)))
    return com


def _assert_scores_close(got, want, b=2 * BL + 1):
    for key, tol in _tol(b).items():
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]),
                                   **tol, err_msg=key)


# -- EWMA banks -------------------------------------------------------------


def test_ewma_bank_update_matches_jax_and_a_numpy_oracle():
    rng = np.random.default_rng(7)
    k, m, b = 3, 12, 10
    prof = rng.random((k, m, b)).astype(np.float32)
    wsum = rng.random((k, m)).astype(np.float32)
    ihist = rng.integers(0, 40, (m, b)).astype(np.int32)
    ihist[4] = 0
    ihist[5, :] = [1] + [0] * (b - 1)  # below the floor
    p, w = ewma_bank_update(
        (torch.from_numpy(prof.copy()), torch.from_numpy(wsum.copy())),
        torch.from_numpy(ihist), 1, np.float32(0.75), 8)
    jp, jw = jax_ewma((jnp.asarray(prof), jnp.asarray(wsum)),
                      jnp.asarray(ihist), np.int32(1), np.float32(0.75),
                      np.int32(8))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    counts = ihist.sum(axis=1)
    upd = counts >= 8
    pmf = ihist / np.maximum(counts, 1)[:, None]
    want = prof.copy()
    want[1][upd] = 0.75 * prof[1][upd] + 0.25 * pmf[upd]
    np.testing.assert_allclose(p.numpy(), want, rtol=1e-6)
    # other banks and rows below the floor: bitwise untouched
    assert (p.numpy()[[0, 2]] == prof[[0, 2]]).all()
    assert (p.numpy()[1][~upd] == prof[1][~upd]).all()
    assert (w.numpy()[1][~upd] == wsum[1][~upd]).all()


def test_ewma_bias_correction_reproduces_a_constant_pmf():
    b = 8
    ihist = torch.zeros((2, b), dtype=torch.int32)
    ihist[0, :4] = torch.tensor([10, 20, 10, 60], dtype=torch.int32)
    prof = torch.zeros((1, 2, b))
    wsum = torch.zeros((1, 2))
    for _ in range(5):
        ewma_bank_update((prof, wsum), ihist, 0, 0.9, 1)
        np.testing.assert_allclose((prof[0, 0] / wsum[0, 0]).numpy(),
                                   [0.1, 0.2, 0.1, 0.6, 0, 0, 0, 0],
                                   rtol=1e-6)


def test_banks_match_jax_after_many_intervals_across_hours():
    """24 hourly banks, intervals crossing three hours, churn-free: the
    banks and every name's scores against JAX's."""
    kw = dict(banks=24, bank_of=hourly_bank, decay=0.9, min_samples=16,
              window=2.0)
    pcom, pagg, _, pam, _ = _port(AnomalyConfig(**kw))
    jcom, jagg, _, jam, _ = _jax(JaxAnomalyConfig(divergence_path="jnp",
                                                  **kw))
    rng = np.random.default_rng(9)
    t0 = T0.replace(hour=5, minute=59, second=57)
    for i in range(12):
        hists = {f"svc.m{j}": {int(b): int(c) for b, c in zip(
            rng.integers(40, 200, 8), rng.integers(1, 30, 8))}
            for j in range(6)}
        raw = _raw(i * 1200, hists, t0=t0)
        pcom.commit(raw)
        jcom.commit(raw)
        np.testing.assert_allclose(pam._prof.numpy(), np.asarray(jam._prof),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(pam._wsum.numpy(), np.asarray(jam._wsum),
                                   rtol=1e-6, atol=1e-7)
        for j in range(6):
            got, want = pam.scores_for(f"svc.m{j}"), jam.scores_for(
                f"svc.m{j}")
            assert (got is None) == (want is None)
            if got is not None:
                _assert_scores_close(got, want)
    assert pam.scored_intervals == jam.scored_intervals == 12
    assert (pam._wsum.numpy().sum(axis=1) > 0).sum() >= 3  # hours used


# -- scoring ----------------------------------------------------------------


def _score_inputs(seed, m, b, k=2):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, 50, (m, b)).astype(np.int32)
    bins[m // 2, :] = 0
    bins[m // 2, b // 3] = 77  # a one-hot live pmf
    cdf = np.cumsum(bins, axis=1, dtype=np.int32)
    counts = bins.sum(axis=1).astype(np.int32)
    counts[0] = 0  # count 0: masked
    # baselines as the EWMA keeps them: each row a pmf times its weight
    w = rng.random((k, m)).astype(np.float32) + 0.1
    pmf = rng.random((k, m, b)) ** 4
    prof = (pmf / pmf.sum(axis=2, keepdims=True) * w[:, :, None]).astype(
        np.float32)
    prof[1, 2] = bins[2] / max(bins[2].sum(), 1)  # identical shape: ks 0
    w[1, 2] = 1.0
    w[1, 1] = 0.0  # no baseline: masked
    return cdf, counts, prof, w


@pytest.mark.parametrize("seed,m,b", [(11, 21, 24), (12, 5, 129),
                                      (13, 64, 513)])
def test_scores_match_jax_jnp_and_pallas_interpret(seed, m, b):
    cdf, counts, prof, w = _score_inputs(seed, m, b)
    got = divergence_scores(torch.from_numpy(cdf), torch.from_numpy(counts),
                            torch.from_numpy(prof), torch.from_numpy(w), 1, 5)
    args = (jnp.asarray(cdf), jnp.asarray(counts), jnp.asarray(prof),
            jnp.asarray(w), np.int32(1), np.int32(5))
    for path in ("jnp", "pallas"):
        want = jax_div_fn(path)(*args)
        _assert_scores_close({k: v.numpy() for k, v in got.items()}, want, b)
        for key in ("ks", "jsd", "emd"):
            masked = np.asarray(want[key]) == 0
            assert (got[key].numpy()[masked] == 0).all()
    for key in ("ks", "jsd", "emd"):
        v = got[key].numpy()
        assert v[0] == 0.0 and v[1] == 0.0  # masked rows, exactly
    assert got["ks"][2] < 2e-6  # identical live and baseline shapes


# K7 walks a row in tiles of 896 columns (csrc/divergence.cu): at the
# card's width 8193 = 9 x 896 + 129, supports that straddle tile edges,
# the ragged last tile and a lone last column
K7_TILE = 896


def _tile_edge_inputs(seed, m=14, b=8193):
    """Rows whose live and baseline supports straddle K7's tile edges; a
    bank of m - 3 rows (the last 3 rows have no baseline)."""
    rng = np.random.default_rng(seed)
    cols = np.arange(b)
    bins = np.zeros((m, b), np.int64)
    pmf = np.zeros((m - 3, b))
    for r in range(m):
        edge = K7_TILE * (1 + r % 9)
        live = slice(max(edge - 1 - r, 0), edge + 2 + 3 * r)
        bins[r, live] = rng.integers(1, 40, live.stop - live.start)
        if r < m - 3:
            pmf[r] = np.exp(-0.5 * ((cols - edge + 5 * r) / (3 + r)) ** 2)
            pmf[r][pmf[r] < 1e-30] = 0.0
    bins[2] = 0
    bins[2, b - 1] = 50                        # a lone last column
    pmf[3] = 0.0
    pmf[3, [0, K7_TILE - 1, K7_TILE, b - 1]] = 1.0
    bins[4] = 0
    bins[4, :3] = 7                            # support in the first tile
    pmf[4] = bins[4] / bins[4].sum()           # identical shapes: ks ~ 0
    pmf[5, 2 * K7_TILE] = 1e-20
    cdf = np.cumsum(bins, axis=1).astype(np.int32)
    counts = bins.sum(axis=1).astype(np.int32)
    counts[0] = 0                              # masked: count 0
    w = rng.random(m - 3).astype(np.float32) + 0.1
    w[4] = 1.0
    prof = (pmf / pmf.sum(axis=1, keepdims=True) * w[:, None]).astype(
        np.float32)
    prof[5, 2 * K7_TILE] = np.finfo(np.float32).smallest_subnormal
    w[1] = 0.0                                 # masked: no baseline
    return cdf, counts, prof[None], w[None]


@pytest.mark.parametrize("seed", [21, 22])
def test_scores_match_jax_at_8193_buckets_across_tile_edges(seed):
    cdf, counts, prof, w = _tile_edge_inputs(seed)
    m, b = cdf.shape
    got = divergence_scores(torch.from_numpy(cdf), torch.from_numpy(counts),
                            torch.from_numpy(prof), torch.from_numpy(w), 0, 5)
    got = {k: v.numpy() for k, v in got.items()}
    args = (jnp.asarray(cdf), jnp.asarray(counts), jnp.asarray(prof),
            jnp.asarray(w), np.int32(0), np.int32(5))
    for path in ("jnp", "pallas"):
        want = jax_div_fn(path)(*args)
        _assert_scores_close(got, want, b)
    for key in ("ks", "jsd", "emd"):
        assert (got[key][[0, 1]] == 0).all() and (got[key][m - 3:] == 0).all()
    assert got["ks"][4] < 2e-6  # identical live and baseline shapes
    assert got["ks"][2] > 0.9   # the lone last column against its baseline


def test_kernel_wrapper_takes_the_plain_version_on_the_cpu():
    cdf, counts, prof, w = _score_inputs(3, 9, 33)
    t = [torch.from_numpy(x) for x in (cdf, counts, prof[1], w[1])]
    a = divergence_kernel(*t, 5)
    b = divergence_plain(*t, 5)
    for key in a:
        assert torch.equal(a[key], b[key])
    with pytest.raises(ValueError, match="int32"):
        divergence_kernel(t[0].float(), *t[1:], 5)


def test_scores_floor_and_cold_baseline():
    b = 16
    bins = np.zeros((4, b), dtype=np.int32)
    bins[0, 2] = 100   # hot row, baseline elsewhere
    bins[1, 2] = 3     # below the floor
    bins[2, 2] = 100   # hot row, cold baseline
    cdf = torch.from_numpy(np.cumsum(bins, axis=1, dtype=np.int32))
    counts = torch.from_numpy(bins.sum(axis=1).astype(np.int32))
    prof = torch.zeros((1, 4, b))
    wsum = torch.zeros((1, 4))
    prof[0, 0, 10] = prof[0, 1, 10] = 1.0
    wsum[0, 0] = wsum[0, 1] = 1.0
    out = divergence_scores(cdf, counts, prof, wsum, 0, 10)
    np.testing.assert_allclose(out["ks"][0].item(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(out["jsd"][0].item(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(out["emd"][0].item(), 8.0, rtol=1e-6)
    for key in ("ks", "jsd", "emd"):
        assert out[key][1:].tolist() == [0.0, 0.0, 0.0]


def test_scores_with_a_bank_smaller_than_the_live_rows():
    b = 8
    bins = np.full((6, b), 10, dtype=np.int32)
    cdf = torch.from_numpy(np.cumsum(bins, axis=1, dtype=np.int32))
    counts = torch.from_numpy(bins.sum(axis=1).astype(np.int32))
    prof = torch.full((1, 3, b), 1.0 / b)
    wsum = torch.ones((1, 3))
    out = divergence_scores(cdf, counts, prof, wsum, 0, 1)
    assert out["ks"].shape == (6,) and (out["ks"][3:] == 0).all()
    np.testing.assert_allclose(out["ks"][:3].numpy(), 0.0, atol=1e-6)
    want = jax_divergence(jnp.asarray(cdf.numpy()),
                          jnp.asarray(counts.numpy()),
                          jnp.asarray(prof.numpy()),
                          jnp.asarray(wsum.numpy()), np.int32(0),
                          np.int32(1))
    _assert_scores_close({k: v.numpy() for k, v in out.items()}, want, b)


def test_divergence_path_accepts_only_auto_and_config_validation():
    assert resolve_divergence_path("auto") == "auto"
    for path in ("jnp", "pallas", "warp"):
        with pytest.raises(ValueError, match="divergence_path"):
            resolve_divergence_path(path)
    with pytest.raises(ValueError):
        AnomalyConfig(decay=1.0)
    with pytest.raises(ValueError):
        AnomalyConfig(banks=0)
    with pytest.raises(ValueError):
        AnomalyConfig(min_samples=0)
    assert hourly_bank(T0.replace(hour=17)) == 17


def test_one_scoring_pass_per_interval_and_check_every():
    com, _, _, am, _ = _port()
    calls = {"div": 0}
    real = am._div

    def counting(*a):
        calls["div"] += 1
        return real(*a)

    am._div = counting
    for i in range(5):
        assert com.commit(_raw(i, {"lat": UNIMODAL, "qps": {0: 99}})) == \
            "fused"
        assert com.last_dispatches == 1 and calls["div"] == i + 1
    assert am.scored_intervals == 5 and am.skipped_intervals == 0
    com, _, _, am, _ = _port(AnomalyConfig(decay=0.8, min_samples=16,
                                           check_every=3))
    for i in range(6):
        com.commit(_raw(i, {"lat": UNIMODAL}))
    assert am.scored_intervals == 2


# -- rules ------------------------------------------------------------------


def _drift_engine(threshold=0.05, stat="jsd"):
    com, _, wheel, am, _ = _port(AnomalyConfig(decay=0.95, min_samples=16))
    engine = RuleEngine(wheel)
    rule = DistributionDriftRule("lat_drift", "lat", stat=stat,
                                 threshold=threshold)
    rule.bind(am)
    engine.add(rule)
    return com, am, engine


def test_bimodal_shift_at_flat_p50_fires_the_drift_rule():
    com, am, engine = _drift_engine()
    for i in range(6):
        com.commit(_raw(i, {"lat": UNIMODAL}))
        assert engine.evaluate(T0) == []
    assert am.scores_for("lat")["jsd"] < 1e-5
    fired = []
    for i in range(6, 10):
        com.commit(_raw(i, {"lat": BIMODAL}))
        fired += engine.evaluate(T0)
    assert [a.state for a in fired] == ["firing"]
    s = am.scores_for("lat")
    assert s["jsd"] > 0.05 and s["ks"] > 0 and s["emd"] > 0
    assert engine.active() == ["lat_drift"]


def test_pure_rate_surge_does_not_fire_and_a_shift_resolves():
    com, am, engine = _drift_engine()
    for i in range(6):
        com.commit(_raw(i, {"lat": UNIMODAL}))
        engine.evaluate(T0)
    quad = {b: 4 * c for b, c in UNIMODAL.items()}
    for i in range(6, 12):
        com.commit(_raw(i, {"lat": quad}))
        assert engine.evaluate(T0) == []
    s = am.scores_for("lat")
    assert s["jsd"] < 1e-5 and s["ks"] < 1e-5 and s["emd"] < 1e-3
    for i in range(12, 16):
        com.commit(_raw(i, {"lat": BIMODAL}))
        engine.evaluate(T0)
    assert engine.active() == ["lat_drift"]
    resolved = []
    for i in range(16, 40):
        com.commit(_raw(i, {"lat": UNIMODAL}))
        resolved += engine.evaluate(T0)
        if resolved:
            break
    assert [a.state for a in resolved] == ["resolved"]
    unbound = DistributionDriftRule("d", "lat")
    assert unbound.evaluate(None, T0) is None
    with pytest.raises(ValueError):
        DistributionDriftRule("d", "lat", stat="psi")


def test_bank_of_routes_updates_to_the_active_bank():
    com, agg, _, am, _ = _port(AnomalyConfig(
        banks=2, bank_of=lambda t: t.hour, decay=0.5, min_samples=16))
    for i in range(4):
        com.commit(_raw(i, {"lat": UNIMODAL}))
    for i in range(4):
        com.commit(_raw(i, {"lat": BIMODAL}, t0=T0 + dt.timedelta(hours=1)))
    mid = agg.registry.lookup("lat")
    prof, wsum = am._prof.numpy(), am._wsum.numpy()
    assert wsum[0, mid] > 0 and wsum[1, mid] > 0
    b0, b1 = prof[0, mid] / wsum[0, mid], prof[1, mid] / wsum[1, mid]
    assert b0.max() == pytest.approx(200 / 400, rel=1e-5)
    assert (b1 > 0).sum() > (b0 > 0).sum()
    assert am.scores_for("lat")["jsd"] < 0.05


# -- lifecycle integration --------------------------------------------------


def _churn_pair():
    return _port(lifecycle=LifecycleConfig(check_every=1000,
                                           auto_compact_fragmentation=0.0))


def test_evicted_id_never_serves_a_drift_score():
    com, agg, _, am, lc = _churn_pair()
    for i in range(4):
        com.commit(_raw(i, {"api.a": UNIMODAL, "api.b": UNIMODAL}))
    assert am.scores_for("api.a") is not None
    bid = agg.registry.lookup("api.b")
    lc.evict_ids([bid])
    assert am.scores_for("api.b") is None
    assert am.scores_for("api.a") is None  # generation moved
    assert not am._prof[:, bid].any() and not am._wsum[:, bid].any()
    assert not am._ihist[bid].any()
    com.commit(_raw(4, {"api.a": UNIMODAL, "api.c": BIMODAL}))
    assert agg.registry.lookup("api.c") == bid
    assert am.scores_for("api.c") == {"ks": 0.0, "jsd": 0.0, "emd": 0.0}
    assert am.scores_for("api.a") is not None


def test_compaction_permutes_banks_and_invalidates_scores():
    com, agg, _, am, lc = _churn_pair()
    names = [f"m{j}" for j in range(8)]
    for i in range(5):
        com.commit(_raw(i, {n: UNIMODAL for n in names}))
    mids = {n: agg.registry.lookup(n) for n in names}
    pre_prof, pre_wsum = am._prof.clone(), am._wsum.clone()
    lc.evict_ids([mids[n] for n in names[::2]])
    assert lc.compact() is True
    assert all(am.scores_for(n) is None for n in names)
    survivors = names[1::2]
    for n in survivors:
        nid = agg.registry.lookup(n)
        assert torch.equal(am._prof[:, nid], pre_prof[:, mids[n]])
        assert torch.equal(am._wsum[:, nid], pre_wsum[:, mids[n]])
    assert not am._wsum[:, agg.registry.live_count():].any()
    com.commit(_raw(50, {n: UNIMODAL for n in survivors}))
    for n in survivors:
        assert am.scores_for(n)["jsd"] < 1e-5


def test_bank_compact_fn_matches_jax():
    from loghisto_tpu.ops.anomaly import make_bank_compact_fn as jax_compact

    rng = np.random.default_rng(2)
    prof = rng.random((3, 8, 5)).astype(np.float32)
    wsum = rng.random((3, 8)).astype(np.float32)
    ihist = rng.integers(0, 9, (10, 5)).astype(np.int32)
    perm = np.array([3, -1, 0, 7, 2**30, 9, 5, 1, 2, 4], dtype=np.int32)
    got = make_bank_compact_fn()(torch.from_numpy(prof),
                                 torch.from_numpy(wsum),
                                 torch.from_numpy(ihist), perm)
    want = jax_compact()(jnp.asarray(prof), jnp.asarray(wsum),
                         jnp.asarray(ihist), jnp.asarray(perm))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_churn_stream_matches_jax_with_lifecycle():
    """Lifecycle and drift together on one churn stream: registry,
    banks and served scores against JAX's."""
    lkw = dict(ttl_intervals=2, check_every=1, min_compact_rows=2,
               auto_compact_fragmentation=0.2)
    akw = dict(decay=0.9, min_samples=16, window=2.0)
    pcom, pagg, _, pam, plc = _port(AnomalyConfig(**akw),
                                    LifecycleConfig(**lkw), m=32)
    jcom, jagg, _, jam, jlc = _jax(JaxAnomalyConfig(divergence_path="jnp",
                                                    **akw),
                                   JaxLifecycleConfig(**lkw), m=32)
    rng = np.random.default_rng(4)
    for i in range(14):
        h = {"svc.lat": UNIMODAL if i < 9 else BIMODAL}
        if i < 10:
            for j in range(3):
                h[f"api.u{i}_{j}.lat"] = {int(rng.integers(60, 140)): 20,
                                          100: 5}
        pcom.commit(_raw(i, h))
        jcom.commit(_raw(i, h))
        assert pagg.registry.names() == jagg.registry.names()
        np.testing.assert_allclose(pam._prof.numpy(), np.asarray(jam._prof),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(pam._ihist.numpy(),
                                      np.asarray(jam._ihist))
        got, want = pam.scores_for("svc.lat"), jam.scores_for("svc.lat")
        assert (got is None) == (want is None)
        if got is not None:
            _assert_scores_close(got, want)
    assert plc.evicted_series == jlc.evicted_series > 0
    assert plc.compactions == jlc.compactions > 0
    assert pam.scores_for("svc.lat")["jsd"] > 0.01  # the shift shows


def test_anomaly_state_carried_from_jax_continues_identically():
    from loghisto_tpu_torch.state import (
        anomaly_state_from_jax,
        state_from_jax,
        wheel_state_from_jax,
    )

    akw = dict(banks=2, bank_of=lambda t: t.second % 2, decay=0.8,
               min_samples=16, window=2.0)
    jcom, jagg, jwheel, jam, _ = _jax(JaxAnomalyConfig(divergence_path="jnp",
                                                       **akw))
    stream = [_raw(i, {"lat": UNIMODAL if i < 6 else BIMODAL,
                       "qps": {3: 40 + i}}) for i in range(10)]
    for raw in stream[:5]:
        jcom.commit(raw)
    pcom, pagg, pwheel, pam, _ = _port(AnomalyConfig(**akw))
    pagg.load_state_dict(state_from_jax(
        np.asarray(jagg._acc), jagg.registry.names(), jagg._agg))
    pwheel.load_state_dict(wheel_state_from_jax(jwheel))
    pwheel.registry = pagg.registry
    pam.load_state(anomaly_state_from_jax(jam.state_dict()))
    assert pam.scored_intervals == 5
    for raw in stream[5:]:
        pcom.commit(raw)
        jcom.commit(raw)
        np.testing.assert_allclose(pam._prof.numpy(), np.asarray(jam._prof),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(pam._wsum.numpy(), np.asarray(jam._wsum),
                                   rtol=1e-6, atol=1e-7)
        _assert_scores_close(pam.scores_for("lat"), jam.scores_for("lat"))
    state = pam.state_dict()
    assert state["prof"].shape == (2, M, 2 * BL + 1)
    assert state["scored_intervals"] == 10


# -- system wiring ----------------------------------------------------------


def test_system_wiring_gauges_export_and_requirements():
    from loghisto_tpu_torch.system import TorchMetricSystem

    ms = TorchMetricSystem(
        interval=0.05, sys_stats=False, num_metrics=32, device="cpu",
        config=MetricConfig(bucket_limit=BL), retention=((8, 1),),
        anomaly=AnomalyConfig(decay=0.8, min_samples=16,
                              export_glob="api.*"))
    try:
        assert ms.committer.anomaly is ms.anomaly is not None
        rule = ms.add_rule(DistributionDriftRule("d", "api.lat"))
        assert rule._manager is ms.anomaly
        ms.backfill_retention([_raw(0, {"api.lat": UNIMODAL,
                                         "other": {0: 9}})])
        gauges = ms.collect_raw_metrics().gauges
        for g in ("anomaly.ScoredIntervals", "anomaly.SkippedIntervals",
                  "anomaly.ExportedMetrics", "anomaly.Banks"):
            assert g in gauges, g
        for k in ("ks", "jsd", "emd"):
            assert f"anomaly.api.lat.{k}" in gauges
        assert "anomaly.other.ks" not in gauges
        assert gauges["anomaly.ScoredIntervals"] == 1.0
    finally:
        ms.stop()
    with pytest.raises(ValueError, match="retention"):
        TorchMetricSystem(sys_stats=False, device="cpu",
                          anomaly=AnomalyConfig())
    with pytest.raises(ValueError, match="fused"):
        TorchMetricSystem(sys_stats=False, device="cpu", retention=((8, 1),),
                          commit="fanout", anomaly=AnomalyConfig())
    bare = TorchMetricSystem(sys_stats=False, device="cpu",
                             retention=((8, 1),))
    try:
        with pytest.raises(ValueError, match="drift engine"):
            bare.add_rule(DistributionDriftRule("d", "lat"))
    finally:
        bare.stop()
