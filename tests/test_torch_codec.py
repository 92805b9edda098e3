"""The port's codec (loghisto_tpu_torch/ops/codec.py) against the host
contract ``compress_np`` and the JAX device codec.

The port computes the codec in float64, so it must equal the float64
host codec EXACTLY on every input.  JAX's device codec is float32 and
departs from ``compress_np`` on some inputs; those departures are
counted, each must be one bucket, and everywhere else the two agree.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loghisto_tpu.ops.codec import compress_np as jax_pkg_compress_np
from loghisto_tpu.ops.ingest import bucket_indices as jax_bucket_indices
from loghisto_tpu_torch.ops import codec
from loghisto_tpu_torch.ops.ingest import bucket_indices

BL = 4096


def _random_values(n, seed=0):
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-4, 14, n)
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    return (sign * mag).astype(np.float32)


def _adversarial():
    f32 = np.finfo(np.float32)
    return np.array(
        [0.0, -0.0, f32.smallest_subnormal, -f32.smallest_subnormal,
         f32.tiny, np.inf, -np.inf, np.nan, 3.4e38, -3.4e38, f32.max,
         0.5, -0.5, 0.51, 1.0, 58.7, 1e-30, 1e30],
        dtype=np.float32,
    )


@pytest.mark.parametrize("name", ["random", "edges", "adversarial"])
def test_compress_equals_compress_np_exactly(name):
    """Exact equality: same float64 math as the host codec."""
    values = {
        "random": lambda: _random_values(500_000),
        "edges": lambda: codec.edge_values(BL),
        "adversarial": _adversarial,
    }[name]()
    got = codec.compress(torch.from_numpy(values)).numpy()
    np.testing.assert_array_equal(got, codec.compress_np(values))
    np.testing.assert_array_equal(got, jax_pkg_compress_np(values))


def test_edge_set_shape():
    edges = codec.edge_values(BL)
    assert edges.dtype == np.float32 and len(edges) == 6 * BL + 3
    # the set straddles every edge: each k has values in buckets k-1 and k
    b = codec.compress_np(edges[edges > 0]).astype(np.int64)
    assert set(range(0, BL + 1)) <= set(b.tolist())


@pytest.mark.parametrize("name,max_fraction", [
    # measured: ~5e-5 of random log-uniform values (97 of 2M)
    ("random", 1e-3),
    # measured: 11,508 of 24,579 edge values (46.8%)
    ("edges", 0.6),
])
def test_jax_float32_departures_are_counted_and_one_bucket(name, max_fraction):
    values = (
        _random_values(500_000, seed=3) if name == "random"
        else codec.edge_values(BL)
    )
    port = bucket_indices(torch.from_numpy(values), BL).numpy()
    jax_idx = np.asarray(jax_bucket_indices(jnp.asarray(values), BL))
    host = np.clip(codec.compress_np(values), -BL, BL).astype(np.int32) + BL
    np.testing.assert_array_equal(port, host)
    departs = jax_idx != host
    delta = (jax_idx - host)[departs]
    assert set(np.unique(delta).tolist()) <= {-1, 1}
    assert departs.sum() < max_fraction * len(values), departs.sum()
    # everywhere else the port and JAX agree exactly
    np.testing.assert_array_equal(port[~departs], jax_idx[~departs])
    if name == "edges":
        assert departs.sum() > 0  # the edge set does reach the f32 gap


def test_decompress_golden_and_float32():
    # reference golden: 58.7 round-trips to 58.7398917 (1e-4)
    b = codec.compress(torch.tensor([58.7]))
    assert b.dtype == torch.int32 and int(b) == 409
    rep = codec.decompress(b)
    assert rep.dtype == torch.float32
    assert abs(float(rep) - 58.7398917) < 1e-4
    # representatives are float64 rounded once to float32
    idx = np.arange(-BL, BL + 1)
    np.testing.assert_array_equal(
        codec.decompress(torch.from_numpy(idx)).numpy(),
        codec.decompress_np(idx).astype(np.float32),
    )


def test_scalar_tier_matches_vector_tier():
    values = [0.0, -0.0, 0.5, -0.51, 1.0, 58.7, -1e6, 1e150, math.inf,
              -math.inf, math.nan]
    vec = codec.compress(torch.tensor(values, dtype=torch.float64)).tolist()
    assert [codec.compress_scalar(v) for v in values] == vec
    assert vec[-3:] == [32767, -32767, 0]  # saturation, NaN -> 0
    for b in (-500, -1, 0, 1, 409, 4096):
        assert codec.decompress_scalar(b) == pytest.approx(
            float(codec.decompress_np(b)), rel=1e-15
        )


@pytest.mark.parametrize("bl", [4096, 512])
def test_bucket_thresholds_are_the_smallest_float32_of_each_bucket(bl):
    """K2's table: t[k] reaches bucket k and the float32 below it does
    not, for every k; t[0] = 0 and the table rises."""
    t = codec.bucket_thresholds(bl)
    assert t.dtype == np.float32 and t.shape == (bl + 1,) and t[0] == 0
    k = np.arange(1, bl + 1)
    tk = t[1:]
    assert (codec.compress_np(tk).astype(np.int64) >= k).all()
    below = np.nextafter(tk, np.float32(0))
    assert (codec.compress_np(below).astype(np.int64) < k).all()
    assert (np.diff(t) > 0).all()


def _all_exponents(n, seed):
    """n float32 bit patterns drawn uniformly: every exponent, both
    signs, NaNs, infinities and subnormals among them."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(
        np.uint32).view(np.float32)


@pytest.mark.parametrize("name", ["edges", "bit_patterns", "specials"])
def test_table_codec_equals_compress_np(name):
    """The plain form of K2's table codec (searchsorted on the
    thresholds, sign, NaN to 0) equals the clipped host codec."""
    f32 = np.finfo(np.float32)
    values = {
        "edges": lambda: codec.edge_values(BL),
        "bit_patterns": lambda: _all_exponents(1 << 20, 9),
        "specials": lambda: np.array(
            [np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0,
             f32.smallest_subnormal, -f32.smallest_subnormal, f32.max,
             -f32.max], np.float32),
    }[name]()
    table = torch.from_numpy(codec.bucket_thresholds(BL))
    got = codec.table_compress(torch.from_numpy(values), table).numpy()
    with np.errstate(invalid="ignore"):
        want = np.clip(codec.compress_np(values), -BL, BL)
    np.testing.assert_array_equal(got, want)
