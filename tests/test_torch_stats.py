"""The port's statistics (loghisto_tpu_torch/ops/stats.py) against the JAX
package's jitted ``dense_stats`` and the host ``dense_stats_np`` on the
same int32 accumulators.

Tolerances:
  * counts and the selected percentile buckets: EQUAL.  The port keeps
    the JAX float32 rank-threshold rule, so the buckets agree with JAX
    at every count, and with the float64 host rule below 2^24.
  * percentile values against dense_stats_np: EQUAL to its float64
    values rounded to float32 (the port's representatives are exactly
    that).  Against JAX: rtol 4e-6, because JAX computes representatives
    with XLA's float32 ``exp``, measured up to 1.4e-6 away from the
    correctly rounded value at large buckets.
  * sums: rtol 1e-6 against dense_stats_np (float32 matvec against a
    float64 one); rtol 2e-6 against JAX (the same representative error
    plus another float32 reduction order; measured 7.8e-7).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loghisto_tpu.ops.stats import dense_stats as jax_dense_stats
from loghisto_tpu_torch.ops.codec import compress_np
from loghisto_tpu_torch.ops.stats import (
    bucket_representatives,
    dense_stats,
    dense_stats_np,
    percentiles_sparse,
    summarize_sparse,
)

PS = np.array([0.0, 0.5, 0.75, 0.9, 0.95, 0.99, 0.999, 0.9999, 1.0],
              dtype=np.float32)


def _accumulator(m, bl, seed, big=False):
    rng = np.random.default_rng(seed)
    b = 2 * bl + 1
    acc = np.zeros((m, b), np.int64)
    for r in range(m):
        kind = r % 5
        if kind == 0:
            continue  # empty row
        if kind == 1:
            acc[r, rng.integers(0, b)] = rng.integers(1, 50)  # one bucket
            continue
        n = int(rng.integers(1, 60000))
        v = rng.lognormal(rng.uniform(-1, 8), rng.uniform(0.1, 3), n)
        v *= np.where(rng.random(n) < 0.2, -1, 1)
        cols = np.clip(compress_np(v), -bl, bl).astype(np.int64) + bl
        acc[r] = np.bincount(cols, minlength=b)
    if big:  # counts past 2^24: the float32 rule's fallback window
        acc[2] *= 997
        acc[3, bl] += (1 << 25) + 3
    return acc.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_stats_fn(bl):
    return jax.jit(functools.partial(jax_dense_stats, bucket_limit=bl))


@pytest.mark.parametrize("m,bl,seed,big", [
    (12, 4096, 0, False), (30, 64, 1, False), (9, 4096, 2, True),
])
def test_dense_stats_equals_jax(m, bl, seed, big):
    acc = _accumulator(m, bl, seed, big)
    want = _jax_stats_fn(bl)(jnp.asarray(acc), jnp.asarray(PS))
    got = dense_stats(torch.from_numpy(acc), PS, bl)
    np.testing.assert_array_equal(got["counts"].numpy(),
                                  np.asarray(want["counts"]))
    jp = np.asarray(want["percentiles"])
    gp = got["percentiles"].numpy()
    np.testing.assert_array_equal(compress_np(gp), compress_np(jp))
    np.testing.assert_allclose(gp, jp, rtol=4e-6, atol=0)
    np.testing.assert_allclose(got["sums"].numpy(), np.asarray(want["sums"]),
                               rtol=2e-6, atol=1e-3)


@pytest.mark.parametrize("m,bl,seed", [(12, 4096, 3), (25, 64, 4)])
def test_dense_stats_equals_host_oracle(m, bl, seed):
    acc = _accumulator(m, bl, seed)
    want = dense_stats_np(acc, PS.astype(np.float64), bl)
    got = dense_stats(torch.from_numpy(acc), PS, bl)
    np.testing.assert_array_equal(got["counts"].numpy(), want["counts"])
    np.testing.assert_array_equal(got["percentiles"].numpy(),
                                  want["percentiles"].astype(np.float32))
    np.testing.assert_allclose(got["sums"].numpy(), want["sums"],
                               rtol=1e-6, atol=1e-3)
    reps = bucket_representatives(bl).numpy()
    sel = got["buckets"].numpy()
    nonempty = want["counts"] > 0
    np.testing.assert_array_equal(reps[sel][nonempty],
                                  got["percentiles"].numpy()[nonempty])


def test_reference_percentile_table():
    """metrics_test.go TestPercentile: {10:9000, 25:900, 33:90, 47:9,
    500:1} -> p99 25, p99.9 33, p99.91 47, max 500 (within 1%)."""
    bl = 4096
    table = {10: 9000, 25: 900, 33: 90, 47: 9, 500: 1}
    acc = np.zeros((1, 2 * bl + 1), np.int32)
    for value, count in table.items():
        acc[0, int(compress_np([value])[0]) + bl] += count
    ps = np.array([0.99, 0.999, 0.9991, 1.0], np.float32)
    got = dense_stats(torch.from_numpy(acc), ps, bl)["percentiles"][0]
    for value, want in zip(got.tolist(), [25, 33, 47, 500]):
        assert value == pytest.approx(want, rel=0.01)
    buckets = np.array([int(compress_np([v])[0]) for v in table])
    sparse = percentiles_sparse(buckets, np.array(list(table.values())),
                                np.array([0.99, 0.999, 0.9991, 1.0]))
    np.testing.assert_array_equal(got.numpy(), sparse.astype(np.float32))
    total, n = summarize_sparse(buckets, np.array(list(table.values())))
    assert n == 10000 and total == pytest.approx(
        float(dense_stats(torch.from_numpy(acc), ps, bl)["sums"][0]),
        rel=1e-6)


def test_empty_accumulator_is_all_zero():
    got = dense_stats(torch.zeros((3, 129), dtype=torch.int32), PS, 64)
    assert not got["counts"].any() and not got["sums"].any()
    assert not got["percentiles"].any()
