"""The sketches of the port (``loghisto_tpu_torch.models``) against the
JAX package's (``loghisto_tpu.models``), on the CPU, with inputs made by
numpy from a seed.

  * HyperLogLog: registers EQUAL bit for bit at p = 4, 14 and 18 and at
    lengths that are not powers of two (NaN, signed zeros, infinities and
    subnormals included); estimates rtol 1e-6 (a float32 sum of 2^p
    powers of two, added in another order);
  * moments: the count EQUAL; scale, min and max EQUAL; the mean rtol
    1e-5 or within 1e-6 sigma, the central sums M2..M4 rtol 1e-5 or within
    1e-6 of n * sigma^k (the size of their terms: M3 of a symmetric
    sample cancels), standardized
    moments and quantiles rtol 1e-5 (float32 sums of up to 50,000 terms
    added in another order);
  * t-digest: below capacity EQUAL bit for bit (means and weights, also
    weighted and merged); above it total weight, min and max EQUAL and
    quantiles within rtol 1e-4 plus 1e-6 of the data's range (a centroid
    at a cluster edge may land on the other side when the two
    frameworks' float32 ``asin`` and sums round differently; measured at
    most 1.7e-5 over 120 streams);
  * ``LogHistogram``: counts EQUAL except for the counted ROADMAP F1
    departures (the reference's float32 device codec rounds values at a
    bucket edge into the neighbouring bucket); statistics as the dense
    engine's (percentile values rtol 4e-6, XLA's float32 ``exp``);
  * ``torch.func.vmap`` over 8 stacked sketches equals 8 single calls
    EQUAL, and the reference's ``jax.vmap``;
  * the ports of the accuracy tests of ``tests/test_sketches.py``, and its
    mesh merges (``:428``, ``:459``) under collectives on four gloo ranks
    of a (4, 1) mesh (``test_torch_ranks.launch``, one launch for the
    module; the mesh of ROADMAP Queue 1 item 11a): HLL registers unioned
    by ``all_reduce(MAX)`` over the stream axis EQUAL a single sketch and
    JAX's ``pmax`` under ``shard_map``; moments states gathered and
    merged as a tree in rank order against a single pass (quantiles rtol
    5e-3, as the reference) and against JAX's same tree; a
    ``LogHistogram`` row summed in int32 EQUAL to one sketch of the whole
    stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.models import LogHistogram as JaxLogHistogram
from loghisto_tpu.models import hll as jhll
from loghisto_tpu.models import moments as jmoments
from loghisto_tpu.models import tdigest as jtdigest
from loghisto_tpu.ops.ingest import bucket_indices as jax_bucket_indices
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.models import LogHistogram, hll, moments, tdigest
from loghisto_tpu_torch.models import loghist
from loghisto_tpu_torch.ops.codec import compress_np, decompress_np, \
    edge_values

CPU = "cpu"


def _awkward(rng, n):
    """n float32 values: lognormal, integers (duplicates), and the
    special patterns a bit-level hash must take as they are."""
    f32 = np.finfo(np.float32)
    special = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf,
                        f32.smallest_subnormal, -f32.tiny, f32.max,
                        -1.5, 3.0], dtype=np.float32)
    half = n // 2
    values = np.concatenate([
        rng.lognormal(0.0, 3.0, half),
        rng.integers(0, 5000, n - half)]).astype(np.float32)
    values[:min(n, len(special))] = special[:min(n, len(special))]
    return rng.permutation(values)


# ---------------------------- HyperLogLog ---------------------------- #


@pytest.mark.parametrize("p", (4, 14, 18))
@pytest.mark.parametrize("n", (1, 1000, 3001, 65_537))
def test_hll_registers_equal_jax_bit_for_bit(p, n):
    rng = np.random.default_rng([p, n])
    jcfg, cfg = jhll.HLLConfig(p=p), hll.HLLConfig(p=p)
    values = _awkward(rng, n)
    jregs, regs = jhll.empty(jcfg), hll.empty(cfg, device=CPU)
    for chunk in np.array_split(values, 3):
        jregs = jhll.insert(jregs, chunk, config=jcfg)
        regs = hll.insert(regs, chunk, config=cfg)
    assert regs.dtype == torch.int32
    np.testing.assert_array_equal(regs.numpy(), np.asarray(jregs))
    np.testing.assert_allclose(float(hll.estimate(regs)),
                               float(jhll.estimate(jregs)), rtol=1e-6)


def test_hll_hash_equals_jax_on_every_exponent():
    """The int64 hash with 16-bit-half products equals the reference's
    wrap-around uint32 hash on bit patterns spread over every float32
    exponent and sign."""
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2**32, 1 << 16, dtype=np.uint64).astype(np.uint32)
    values = bits.view(np.float32)
    got = hll._hash32(torch.from_numpy(values)).numpy()
    want = np.asarray(jhll._hash32(jnp.asarray(values))).astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_hll_merge_and_config_equal_jax():
    cfg, jcfg = hll.HLLConfig(p=12), jhll.HLLConfig(p=12)
    a_vals = np.arange(0, 10_000, dtype=np.float32)
    b_vals = np.arange(5_000, 15_000, dtype=np.float32)
    a = hll.insert(hll.empty(cfg, device=CPU), a_vals, config=cfg)
    b = hll.insert(hll.empty(cfg, device=CPU), b_vals, config=cfg)
    merged = hll.merge(a, b)
    jmerged = jhll.merge(jhll.insert(jhll.empty(jcfg), a_vals, config=jcfg),
                         jhll.insert(jhll.empty(jcfg), b_vals, config=jcfg))
    np.testing.assert_array_equal(merged.numpy(), np.asarray(jmerged))
    assert abs(float(hll.estimate(merged)) / 15_000 - 1) < 0.06
    assert torch.equal(hll.merge(a, b), hll.merge(b, a))
    assert torch.equal(hll.merge(merged, merged), merged)
    for p in (2, 3, 19):
        with pytest.raises(ValueError) as got:
            hll.HLLConfig(p=p)
        with pytest.raises(ValueError) as want:
            jhll.HLLConfig(p=p)
        assert str(got.value) == str(want.value)
    assert hll.HLLConfig().num_registers == jhll.HLLConfig().num_registers


@pytest.mark.parametrize("true_n", (100, 5_000, 200_000))
def test_hll_cardinality(true_n):
    cfg = hll.HLLConfig(p=14)
    rng = np.random.default_rng(3)
    stream = np.tile(rng.permutation(true_n).astype(np.float32), 3)
    regs = hll.empty(cfg, device=CPU)
    for chunk in np.array_split(stream, 5):
        regs = hll.insert(regs, chunk, config=cfg)
    est = float(hll.estimate(regs))
    assert abs(est / true_n - 1) < 0.05, (est, true_n)


# ------------------------------ moments ------------------------------ #

MOMENT_FIELDS = ("mean", "m2", "m3", "m4")


def _moments_pair(chunks):
    js, ps = jmoments.empty(), moments.empty(device=CPU)
    for c in chunks:
        js = jmoments.insert(js, c)
        ps = moments.insert(ps, c)
    return ps, js


def _assert_moments_equal(ps, js):
    assert ps.count.dtype == torch.int32
    assert int(ps.count) == int(js.count)
    for field in ("scale", "min", "max"):
        assert float(getattr(ps, field)) == float(getattr(js, field)), field
    # the mean within rtol 1e-5 or 1e-6 sigma; a central sum M_k within
    # rtol 1e-5 or 1e-6 of n * sigma^k, the size of its terms (M3 of a
    # symmetric sample cancels to near zero)
    n = max(int(js.count), 1)
    sigma = (float(js.m2) / n) ** 0.5
    atol = {"mean": 1e-6 * sigma, "m2": 1e-6 * n * sigma ** 2,
            "m3": 1e-6 * n * sigma ** 3, "m4": 1e-6 * n * sigma ** 4}
    for field in MOMENT_FIELDS:
        np.testing.assert_allclose(float(getattr(ps, field)),
                                   float(getattr(js, field)), rtol=1e-5,
                                   atol=atol[field] + 1e-12, err_msg=field)
    np.testing.assert_allclose(
        [float(x) for x in moments.standardized_moments(ps)],
        [float(x) for x in jmoments.standardized_moments(js)], rtol=1e-5,
        atol=1e-6)


@pytest.mark.parametrize("dist", ("lognormal", "normal", "bimodal",
                                  "large_mean"))
def test_moments_equal_jax(dist):
    rng = np.random.default_rng(5)
    n = 50_000
    data = {
        "lognormal": lambda: rng.lognormal(2.0, 1.0, n),
        "normal": lambda: rng.normal(100.0, 15.0, n),
        "bimodal": lambda: np.concatenate([rng.normal(-50, 5, n // 2),
                                           rng.normal(900, 40, n // 2)]),
        "large_mean": lambda: rng.normal(10_000.0, 1.0, n),
    }[dist]().astype(np.float32)
    data[7] = np.nan  # pinned to 0.0 in both
    ps, js = _moments_pair(np.array_split(data, 7))
    _assert_moments_equal(ps, js)
    qs = np.array([0.0, 0.01, 0.1, 0.5, 0.9, 0.99, 1.0], dtype=np.float32)
    got = moments.quantile(ps, qs).numpy()
    want = np.asarray(jmoments.quantile(js, qs))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got[0] == want[0] and got[-1] == want[-1]  # the observed range


def test_moments_merge_equals_jax():
    rng = np.random.default_rng(6)
    a = rng.normal(0, 1, 10_000).astype(np.float32)
    b = rng.normal(5, 2, 10_000).astype(np.float32)
    pa, ja = _moments_pair([a])
    pb, jb = _moments_pair([b])
    _assert_moments_equal(moments.merge(pa, pb), jmoments.merge(ja, jb))
    combined, _ = _moments_pair([np.concatenate([a, b])])
    merged = moments.merge(pa, pb)
    for field in ("count", "scale", "min", "max"):
        assert float(getattr(merged, field)) == float(
            getattr(combined, field))
    np.testing.assert_allclose(
        [float(x) for x in moments.standardized_moments(merged)],
        [float(x) for x in moments.standardized_moments(combined)],
        rtol=2e-3)


def test_moments_degenerate_cases_equal_jax():
    qs = np.array([0.0, 0.5, 1.0], dtype=np.float32)
    cases = ([], [np.array([42.0], dtype=np.float32)],
             [np.array([-5.0, -1.0, -10.0], dtype=np.float32)],
             [np.array([1e30, 2e30, 3e30], dtype=np.float32)],
             [np.array([4.0, np.nan, 8.0], dtype=np.float32)],
             [np.array([], dtype=np.float32), np.array([7.0, 7.0])])
    for chunks in cases:
        ps, js = _moments_pair(chunks)
        _assert_moments_equal(ps, js)
        np.testing.assert_allclose(moments.quantile(ps, qs).numpy(),
                                   np.asarray(jmoments.quantile(js, qs)),
                                   rtol=1e-5)
    empty = moments.empty(device=CPU)
    assert float(moments.quantile(empty, np.array([0.5]))[0]) == 0.0
    one, _ = _moments_pair(cases[1])
    np.testing.assert_allclose(moments.quantile(one, qs).numpy(), 42.0)
    neg, _ = _moments_pair(cases[2])
    got = moments.quantile(neg, np.array([0.0, 1.0])).numpy()
    assert got[0] == -10.0 and got[1] == -1.0
    huge, _ = _moments_pair(cases[3])
    for field in MOMENT_FIELDS:
        assert np.isfinite(float(getattr(huge, field)))
    assert abs(float(moments.standardized_moments(huge)[0]) / 2e30 - 1) \
        < 1e-3
    nan, _ = _moments_pair(cases[4])
    assert int(moments.count(nan)) == 3
    assert abs(float(moments.standardized_moments(nan)[0]) - 4.0) < 1e-5


def test_moments_gaussian_quantiles():
    rng = np.random.default_rng(5)
    data = rng.normal(100.0, 15.0, 50_000).astype(np.float32)
    st, _ = _moments_pair(np.split(data, 5))
    mean, std, skew, kurt = (float(x)
                             for x in moments.standardized_moments(st))
    assert abs(mean - 100.0) < 0.5 and abs(std - 15.0) < 0.5
    assert abs(skew) < 0.1 and abs(kurt - 3.0) < 0.1
    got = moments.quantile(st, np.array([0.5, 0.9, 0.99])).numpy()
    assert np.abs(got - np.quantile(data, [0.5, 0.9, 0.99])).max() < 1.0
    assert int(moments.count(st)) == 50_000


def test_moments_no_cancellation_at_large_mean():
    rng = np.random.default_rng(8)
    data = rng.normal(10_000.0, 1.0, 20_000).astype(np.float32)
    st, _ = _moments_pair(np.split(data, 4))
    mean, std, _, _ = (float(x) for x in moments.standardized_moments(st))
    assert abs(mean - 10_000.0) < 0.1 and abs(std - 1.0) < 0.05
    got = moments.quantile(st, np.array([0.5, 0.99])).numpy()
    assert np.abs(got - np.quantile(data, [0.5, 0.99])).max() < 0.5


# ------------------------------ t-digest ----------------------------- #


def _digest_pair(chunks, cap, weights=None):
    cfg, jcfg = (tdigest.TDigestConfig(capacity=cap),
                 jtdigest.TDigestConfig(capacity=cap))
    m, w = tdigest.empty(cfg, device=CPU)
    jm, jw = jtdigest.empty(jcfg)
    for i, c in enumerate(chunks):
        sw = None if weights is None else weights[i]
        m, w = tdigest.insert(m, w, c, sw, config=cfg)
        jm, jw = jtdigest.insert(jm, jw, c, sw, config=jcfg)
    return (m, w), (np.asarray(jm), np.asarray(jw))


def _assert_digest_equal(port, ref):
    np.testing.assert_array_equal(port[0].numpy(), ref[0])
    np.testing.assert_array_equal(port[1].numpy(), ref[1])


def test_tdigest_bit_for_bit_below_capacity():
    rng = np.random.default_rng(5)
    data = (rng.pareto(1.5, 200) * 1e3).astype(np.float32)
    data[[3, 50]] = data[[4, 51]]  # equal means: the sort is stable
    port, ref = _digest_pair(np.array_split(data, 10), 256)
    _assert_digest_equal(port, ref)
    assert float(tdigest.count(port[1])) == 200.0
    w = port[1].numpy()
    assert (w[w > 0] == 1.0).all()
    np.testing.assert_allclose(np.sort(port[0].numpy()[w > 0]),
                               np.sort(data), rtol=1e-6)
    qs = np.array([0.0, 0.1, 0.5, 0.95, 0.999, 1.0], dtype=np.float32)
    np.testing.assert_array_equal(
        tdigest.quantile(*port, qs).numpy(),
        np.asarray(jtdigest.quantile(*map(jnp.asarray, ref), qs)))
    # weighted samples and a merge stay exact too
    weights = [rng.integers(1, 5, 30).astype(np.float32) for _ in range(3)]
    chunks = [rng.normal(0, 10, 30).astype(np.float32) for _ in range(3)]
    wport, wref = _digest_pair(chunks, 128, weights)
    _assert_digest_equal(wport, wref)
    other, oref = _digest_pair([rng.normal(5, 1, 30).astype(np.float32)],
                               128)
    cfg, jcfg = (tdigest.TDigestConfig(capacity=128),
                 jtdigest.TDigestConfig(capacity=128))
    merged = tdigest.merge(wport, other, config=cfg)
    _assert_digest_equal(merged, tuple(np.asarray(a) for a in jtdigest.merge(
        tuple(map(jnp.asarray, wref)), tuple(map(jnp.asarray, oref)),
        config=jcfg)))
    assert float(tdigest.count(merged[1])) == float(
        sum(x.sum() for x in weights)) + 30.0


@pytest.mark.parametrize("dist,cap", [("lognormal", 512), ("pareto", 256),
                                      ("normal", 64), ("uniform", 512)])
def test_tdigest_above_capacity_within_tolerance(dist, cap):
    rng = np.random.default_rng([7, cap])
    n = 40_000
    data = {
        "lognormal": lambda: rng.lognormal(5, 2, n),
        "pareto": lambda: (rng.pareto(1.5, n) + 1) * 1e3,
        "normal": lambda: rng.normal(0, 100, n),
        "uniform": lambda: rng.uniform(-5, 1000, n),
    }[dist]().astype(np.float32)
    port, ref = _digest_pair(np.array_split(data, 10), cap)
    w, jw = port[1].numpy(), ref[1]
    assert w.sum() == jw.sum() == n  # total weight EQUAL
    pop, jpop = port[0].numpy()[w > 0], ref[0][jw > 0]
    assert pop.min() == jpop.min() == data.min()
    assert pop.max() == jpop.max() == data.max()
    qs = np.array([0.0, 0.001, 0.01, 0.25, 0.5, 0.75, 0.9, 0.99, 0.999,
                   0.9999, 1.0], dtype=np.float32)
    got = tdigest.quantile(*port, qs).numpy()
    want = np.asarray(jtdigest.quantile(*map(jnp.asarray, ref), qs))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-6 * (data.max() - data.min()))


def test_tdigest_weight_zero_padding_changes_nothing():
    """The reference pads batches to a power of two with weight-0
    entries; the port does not pad, and such entries change no result,
    below capacity and above it."""
    rng = np.random.default_rng(9)
    for cap, n in ((64, 40), (64, 3000)):
        cfg = tdigest.TDigestConfig(capacity=cap)
        values = rng.lognormal(2, 1, n).astype(np.float32)
        plain = tdigest.insert(*tdigest.empty(cfg, device=CPU), values,
                               config=cfg)
        pad = 1 << (n - 1).bit_length()
        padded = tdigest.insert(
            *tdigest.empty(cfg, device=CPU),
            np.r_[values, np.zeros(pad - n, np.float32)],
            np.r_[np.ones(n, np.float32), np.zeros(pad - n, np.float32)],
            config=cfg)
        assert torch.equal(plain[0], padded[0])
        assert torch.equal(plain[1], padded[1])


def test_tdigest_segment_scan_is_exact_on_singletons():
    x = torch.tensor([1e8, 3.0, 1e-3, 5.0, 7.0, 1.0], dtype=torch.float32)
    seg = torch.tensor([0, 1, 1, 2, 3, 3])
    got = tdigest._segment_scan(x, seg)
    assert got[0] == x[0] and got[3] == x[3]  # singletons: themselves
    assert got[2] == x[1] + x[2] and got[5] == x[4] + x[5]


def test_tdigest_config_equals_jax():
    for kw in ({"capacity": 2}, {"delta": 1}, {"capacity": 64, "delta": 1000}):
        with pytest.raises(ValueError) as got:
            tdigest.TDigestConfig(**kw)
        with pytest.raises(ValueError) as want:
            jtdigest.TDigestConfig(**kw)
        assert str(got.value) == str(want.value)
    for cap in (16, 100, 512):
        assert tdigest.TDigestConfig(capacity=cap).delta == \
            jtdigest.TDigestConfig(capacity=cap).delta
    assert tdigest.TDigestConfig(capacity=100).delta == 160.0


def test_tdigest_quantiles_uniform():
    cfg = tdigest.TDigestConfig(capacity=256)
    rng = np.random.default_rng(0)
    data = rng.uniform(0, 1000, 50_000).astype(np.float32)
    m, w = tdigest.empty(cfg, device=CPU)
    for chunk in np.split(data, 10):
        m, w = tdigest.insert(m, w, chunk, config=cfg)
    qs = np.array([0.01, 0.25, 0.5, 0.75, 0.99], dtype=np.float32)
    got = tdigest.quantile(m, w, qs).numpy()
    assert np.all(np.abs(got - np.quantile(data, qs)) < 15.0)
    assert abs(float(tdigest.count(w)) - len(data)) < 1e-3 * len(data)


def test_tdigest_tail_accuracy_lognormal():
    cfg = tdigest.TDigestConfig(capacity=512)
    rng = np.random.default_rng(1)
    data = rng.lognormal(5, 2, 100_000).astype(np.float32)
    m, w = tdigest.empty(cfg, device=CPU)
    for chunk in np.split(data, 20):
        m, w = tdigest.insert(m, w, chunk, config=cfg)
    got = float(tdigest.quantile(m, w, np.array([0.999]))[0])
    assert abs(got / float(np.quantile(data, 0.999)) - 1) < 0.05


def test_tdigest_merge_matches_combined():
    cfg = tdigest.TDigestConfig()
    rng = np.random.default_rng(2)
    a_data = rng.normal(0, 1, 10_000).astype(np.float32)
    b_data = rng.normal(10, 1, 10_000).astype(np.float32)
    a = tdigest.insert(*tdigest.empty(cfg, device=CPU), a_data, config=cfg)
    b = tdigest.insert(*tdigest.empty(cfg, device=CPU), b_data, config=cfg)
    mm, mw = tdigest.merge(a, b, config=cfg)
    got = float(tdigest.quantile(mm, mw, np.array([0.5]))[0])
    assert abs(got - float(np.quantile(np.r_[a_data, b_data], 0.5))) < 0.5
    assert abs(float(tdigest.count(mw)) - 20_000) < 1.0


def test_tdigest_degenerate_sizes_and_nan_inf_policy():
    m, w = tdigest.insert(*tdigest.empty(device=CPU),
                          np.array([7.0], dtype=np.float32))
    np.testing.assert_allclose(
        tdigest.quantile(m, w, np.array([0.0, 0.5, 1.0])).numpy(), 7.0)
    m, w = tdigest.insert(*tdigest.empty(device=CPU),
                          np.array([1.0, 3.0], dtype=np.float32))
    got = tdigest.quantile(m, w, np.array([0.0, 1.0])).numpy()
    assert got[0] <= got[1] and 1.0 <= got[0] <= 3.0 and got[1] <= 3.0
    got = tdigest.quantile(*tdigest.empty(device=CPU), np.array([0.5]))
    assert float(got[0]) == 0.0
    cfg = tdigest.TDigestConfig(capacity=16)
    values = np.array([1.0, np.nan, 2.0, np.inf, -np.inf])
    port, ref = _digest_pair([values], 16)
    _assert_digest_equal(port, ref)
    assert float(tdigest.count(port[1])) == 5.0
    m, w = tdigest.insert(*tdigest.empty(cfg, device=CPU),
                          np.array([1.0, 1000.0]), config=cfg)
    q50 = float(tdigest.quantile(m, w, np.array([0.5]))[0])
    assert abs(q50 - 500.5) < 1.0


def test_tdigest_max_survives_compression():
    cfg = tdigest.TDigestConfig(capacity=64)
    rng = np.random.default_rng(6)
    m, w = tdigest.empty(cfg, device=CPU)
    true_max, true_min = -np.inf, np.inf
    for _ in range(20):
        chunk = rng.lognormal(5, 2, 500)
        true_max, true_min = max(true_max, chunk.max()), min(true_min,
                                                            chunk.min())
        m, w = tdigest.insert(m, w, chunk, config=cfg)
    pop = m.numpy()[w.numpy() > 0]
    assert pop.max() == np.float32(true_max)
    assert pop.min() == np.float32(true_min)
    q = tdigest.quantile(m, w, np.array([0.0, 1.0])).numpy()
    assert q[1] == np.float32(true_max)


def test_tdigest_heavy_tail_p9999_bound():
    rng = np.random.default_rng(0)
    for maker in (lambda: (rng.pareto(1.5, 200_000) + 1) * 1e3,
                  lambda: rng.lognormal(5, 2, 200_000)):
        data = maker().astype(np.float32)
        m, w = tdigest.empty(device=CPU)
        for chunk in np.array_split(data, 10):
            m, w = tdigest.insert(m, w, chunk)
        qs = np.array([0.999, 0.9999], dtype=np.float32)
        errs = np.abs(tdigest.quantile(m, w, qs).numpy()
                      / np.quantile(data, qs) - 1)
        assert errs[0] < 0.05 and errs[1] < 0.10, errs


def test_tdigest_powerlaw_never_degrades_light_tails():
    rng = np.random.default_rng(2)
    for data in (rng.uniform(0, 1000, 100_000),
                 rng.normal(100, 15, 100_000)):
        data = np.abs(data).astype(np.float32)
        m, w = tdigest.empty(device=CPU)
        for chunk in np.array_split(data, 10):
            m, w = tdigest.insert(m, w, chunk)
        qs = np.array([0.5, 0.9, 0.99, 0.9999], dtype=np.float32)
        got = tdigest.quantile(m, w, qs).numpy()
        assert np.all(np.abs(got / np.quantile(data, qs) - 1) < 0.01)


def test_tdigest_bimodal_body_guard_points_at_loghist():
    rng = np.random.default_rng(4)
    lo = rng.normal(10.0, 1.0, 50_010).clip(5, 15)
    hi = rng.normal(1000.0, 50.0, 49_990).clip(800, 1200)
    data = np.concatenate([lo, hi]).astype(np.float32)
    want = float(np.quantile(data, 0.5))
    buckets = compress_np(data.astype(np.float64))
    uniq, cnt = np.unique(buckets, return_counts=True)
    sel = uniq[np.searchsorted(np.cumsum(cnt), 0.5 * len(data))]
    assert abs(float(decompress_np(np.array([sel]))[0]) / want - 1) < 0.02
    m, w = tdigest.empty(device=CPU)
    for chunk in np.array_split(data, 10):
        m, w = tdigest.insert(m, w, chunk)
    td_p50 = float(tdigest.quantile(m, w, np.array([0.5]))[0])
    assert data.min() <= td_p50 <= data.max()
    assert abs(td_p50 / want - 1) >= 0.02  # the documented limitation


# ---------------------------- LogHistogram --------------------------- #


def test_loghistogram_counts_equal_jax_but_f1_departures():
    bl = 1024
    rng = np.random.default_rng(4)
    values = np.concatenate([rng.lognormal(3, 1, 20_000),
                             edge_values(bl)]).astype(np.float32)
    h = LogHistogram.empty(MetricConfig(bucket_limit=bl), device=CPU)
    h = h.insert(values)
    jh = JaxLogHistogram.empty(JaxConfig(bucket_limit=bl)).insert(values)
    host = np.clip(compress_np(values), -bl, bl).astype(np.int64) + bl
    jax_idx = np.asarray(jax_bucket_indices(jnp.asarray(values), bl))
    departs = jax_idx != host
    assert 0 < departs.sum() < 0.6 * len(edge_values(bl))
    # the port's counts are the float64 codec's; the reference's differ
    # by exactly its departures
    np.testing.assert_array_equal(
        h.counts.numpy(), np.bincount(host, minlength=2 * bl + 1))
    moved = (np.bincount(jax_idx[departs], minlength=2 * bl + 1)
             - np.bincount(host[departs], minlength=2 * bl + 1))
    np.testing.assert_array_equal(np.asarray(jh.counts) - h.counts.numpy(),
                                  moved)
    assert h.count == jh.count == len(values)


def test_loghistogram_statistics_equal_jax():
    cfg, jcfg = MetricConfig(bucket_limit=1024), JaxConfig(bucket_limit=1024)
    rng = np.random.default_rng(4)
    data = rng.lognormal(3, 1, 10_000).astype(np.float32)
    h = LogHistogram.empty(cfg, device=CPU).insert(data)
    jh = JaxLogHistogram.empty(jcfg).insert(data)
    np.testing.assert_array_equal(h.counts.numpy(), np.asarray(jh.counts))
    ps = [0.0, 0.5, 0.99, 0.9999, 1.0]
    got, want = h.statistics(ps), jh.statistics(ps)
    assert got["count"] == want["count"] == 10_000
    assert got["sum"] == pytest.approx(want["sum"], rel=2e-6)
    np.testing.assert_allclose(got["percentiles"], want["percentiles"],
                               rtol=4e-6)
    for p, q in zip(got["percentiles"][1:3], (0.5, 0.99)):
        assert abs(p / np.quantile(data, q) - 1) < 0.011
    merged = h.merge(LogHistogram.empty(cfg, device=CPU).insert(
        np.array([7.0], dtype=np.float32)))
    assert merged.count == 10_001 and h.count == 10_000  # functional


@pytest.mark.parametrize("n,route", [(4096, "histogram_row"),
                                     (4097, "row_ingest_batch"),
                                     (0, "histogram_row")])
def test_loghistogram_insert_takes_k2a_or_k2b(monkeypatch, n, route):
    """A batch of a multiple of 2048 samples goes through K2a's wrapper,
    any other length through K2b's with an all-zero id column."""
    calls = []
    for name in ("histogram_row", "row_ingest_batch"):
        fn = getattr(loghist, name)

        def spy(*args, _fn=fn, _name=name):
            calls.append((_name, args))
            return _fn(*args)

        monkeypatch.setattr(loghist, name, spy)
    rng = np.random.default_rng(n)
    values = rng.lognormal(0, 2, n).astype(np.float32)
    h = LogHistogram.empty(MetricConfig(bucket_limit=256), device=CPU)
    out = h.insert(values)
    assert [c[0] for c in calls] == ([route] if n else [])
    if route == "row_ingest_batch":
        assert calls[0][1][1].dtype == torch.int32
        assert not calls[0][1][1].any()
    host = np.clip(compress_np(values), -256, 256).astype(np.int64) + 256
    np.testing.assert_array_equal(out.counts.numpy(),
                                  np.bincount(host, minlength=513))
    assert not h.counts.any()  # insert returns a new histogram


def test_loghistogram_insert_splits_what_one_k2_call_refuses(monkeypatch):
    """A batch longer than one K2 call takes (the reference refuses
    2^24 samples a call) goes in pieces: whole pieces through K2a, the
    ragged rest through K2b; the counts are the whole batch's."""
    calls = []
    monkeypatch.setattr(loghist, "_PIECE", 4096)
    for name in ("histogram_row", "row_ingest_batch"):
        fn = getattr(loghist, name)

        def spy(*args, _fn=fn, _name=name):
            calls.append((_name, args[-3].shape[0] if _name ==
                          "row_ingest_batch" else args[1].shape[0]))
            return _fn(*args)

        monkeypatch.setattr(loghist, name, spy)
    values = np.random.default_rng(2).lognormal(0, 2, 10_000).astype(
        np.float32)
    h = LogHistogram.empty(MetricConfig(bucket_limit=256),
                           device=CPU).insert(values)
    assert calls == [("histogram_row", 4096), ("histogram_row", 4096),
                     ("row_ingest_batch", 1808)]
    host = np.clip(compress_np(values), -256, 256).astype(np.int64) + 256
    np.testing.assert_array_equal(h.counts.numpy(),
                                  np.bincount(host, minlength=513))


# ------------------------------- vmap -------------------------------- #


def test_sketches_vmap_over_eight_sketches():
    rng = np.random.default_rng(11)
    data = rng.lognormal(3, 1, (8, 4096)).astype(np.float32)
    x = torch.from_numpy(data)
    cfg, jcfg = (tdigest.TDigestConfig(capacity=64),
                 jtdigest.TDigestConfig(capacity=64))
    m0, w0 = tdigest.empty(cfg, device=CPU)
    ms, ws = m0.expand(8, -1).clone(), w0.expand(8, -1).clone()
    ms2, ws2 = vmap(lambda m, w, v: tdigest.insert(m, w, v, config=cfg))(
        ms, ws, x)
    q = vmap(lambda m, w: tdigest.quantile(m, w, torch.tensor([0.5])))(
        ms2, ws2)
    for i in range(8):
        m1, w1 = tdigest.insert(m0, w0, x[i], config=cfg)
        assert torch.equal(ms2[i], m1) and torch.equal(ws2[i], w1)
        assert torch.equal(q[i], tdigest.quantile(m1, w1,
                                                  torch.tensor([0.5])))
    np.testing.assert_allclose(q[:, 0].numpy(),
                               np.quantile(data, 0.5, axis=1), rtol=0.05)
    jm0, jw0 = jtdigest.empty(jcfg)
    jms2, jws2 = jax.vmap(
        lambda m, w, v: jtdigest.insert(m, w, v, config=jcfg))(
        jnp.broadcast_to(jm0, (8, 64)), jnp.broadcast_to(jw0, (8, 64)),
        jnp.asarray(data))
    jq = jax.vmap(lambda m, w: jtdigest.quantile(m, w, jnp.asarray([0.5])))(
        jms2, jws2)
    np.testing.assert_array_equal(ws2.sum(1).numpy(),
                                  np.asarray(jws2).sum(1))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-4)

    regs = hll.empty(device=CPU).expand(8, -1).clone()
    regs2 = vmap(lambda r, v: hll.insert(r, v))(regs, x)
    est = vmap(hll.estimate)(regs2)
    jregs2 = jax.vmap(lambda r, v: jhll.insert(r, v))(
        jnp.broadcast_to(jhll.empty(), (8, 1 << 14)), jnp.asarray(data))
    np.testing.assert_array_equal(regs2.numpy(), np.asarray(jregs2))
    for i in range(8):
        assert torch.equal(regs2[i], hll.insert(regs[i], x[i]))
        assert torch.equal(est[i], hll.estimate(regs2[i]))
    assert np.all(np.abs(est.numpy() / 4096 - 1) < 0.1)


# ------------------------- mesh merges (11a) ------------------------- #


@pytest.fixture(scope="module")
def sketch_ranks(tmp_path_factory):
    import test_torch_ranks as R

    rng = np.random.default_rng(6)
    inputs = {
        "hll": rng.integers(0, 5000, 1 << 15).astype(np.float32),
        "moments": rng.normal(100.0, 15.0, 1 << 14).astype(np.float32),
        "loghist": rng.lognormal(0.0, 1.0, 1 << 14).astype(np.float32),
    }
    return inputs, R.launch(tmp_path_factory.mktemp("sketches"),
                            R.SK_STREAM, "sketches", inputs)


def test_hll_merges_over_mesh_with_all_reduce_max(sketch_ranks):
    from jax.sharding import PartitionSpec as P

    from loghisto_tpu.parallel.mesh import STREAM_AXIS, make_mesh, shard_map

    import test_torch_ranks as R

    inputs, res = sketch_ranks
    values = inputs["hll"]
    single = hll.insert(hll.empty(device=CPU), values).numpy()

    def local(vals):
        return jax.lax.pmax(jhll.insert(jhll.empty(), vals), STREAM_AXIS)

    pmax = jax.jit(shard_map(
        local, mesh=make_mesh(stream=R.SK_STREAM, metric=1),
        in_specs=P(STREAM_AXIS), out_specs=P()))(values)
    for r in res:
        np.testing.assert_array_equal(r["hll"], single)
        np.testing.assert_array_equal(r["hll"], np.asarray(pmax))
    est = float(hll.estimate(torch.from_numpy(res[0]["hll"])))
    distinct = len(np.unique(values))
    assert abs(est / distinct - 1) < 0.05, (est, distinct)


def test_moments_merge_over_mesh_matches_single_pass(sketch_ranks):
    import test_torch_ranks as R

    inputs, res = sketch_ranks
    values = inputs["moments"]
    fields = ("count", "mean", "m2", "m3", "m4", "scale", "min", "max")
    merged = [moments.MomentsState(**{f: torch.from_numpy(r[f"moments.{f}"])
                                      for f in fields}) for r in res]
    for m in merged[1:]:  # every rank holds the same state
        for f in fields:
            assert torch.equal(getattr(m, f), getattr(merged[0], f)), f
    merged = merged[0]
    jstates = [jmoments.insert(jmoments.empty(), c)
               for c in np.split(values, R.SK_STREAM)]
    while len(jstates) > 1:  # the same tree, in rank order
        jstates = [jmoments.merge(jstates[i], jstates[i + 1])
                   for i in range(0, len(jstates), 2)]
    _assert_moments_equal(merged, jstates[0])
    single = moments.insert(moments.empty(device=CPU), values)
    assert int(moments.count(merged)) == len(values)
    qs = np.array([0.5, 0.99])
    np.testing.assert_allclose(moments.quantile(merged, qs).numpy(),
                               moments.quantile(single, qs).numpy(),
                               rtol=5e-3)


def test_loghistogram_rows_merge_over_mesh_with_an_int32_sum(sketch_ranks):
    inputs, res = sketch_ranks
    cfg = MetricConfig(bucket_limit=256)
    single = LogHistogram.empty(cfg, device=CPU).insert(inputs["loghist"])
    for r in res:
        assert r["loghist"].dtype == np.int32
        np.testing.assert_array_equal(r["loghist"], single.counts.numpy())
