"""The port's ingest paths on the CPU — the plain versions of K1 (fused
ingest), K2a/K2b (row histogram) and K3 (sparse triple scatter) — against
the JAX package's oracles and, once each, its Pallas kernels in
interpret mode (M <= 16, bucket_limit <= 64, N <= 4096).

Int32 accumulators must be EQUAL.  The JAX codec is float32 and the
port's float64 (see test_torch_codec.py), so samples on which the two
codecs bucket differently are filtered out first and counted; the
count must stay below 0.1% of the batch (it is 0 on most seeds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loghisto_tpu.ops.fused_ingest import fused_ingest_batch as jax_fused
from loghisto_tpu.ops.ingest import bucket_indices as jax_bucket_indices
from loghisto_tpu.ops.ingest import ingest_batch as jax_ingest_batch
from loghisto_tpu.ops.pallas_kernels import (
    pallas_row_ingest_batch as jax_row_ingest,
)
from loghisto_tpu.ops.sparse_ingest import (
    pallas_sparse_ingest as jax_pallas_sparse,
)
from loghisto_tpu.ops.sparse_ingest import (
    sparse_ingest_batch as jax_sparse_batch,
)
from loghisto_tpu_torch.ops import backend
from loghisto_tpu_torch.ops.fold import fold_packed_numpy, pack_cells
from loghisto_tpu_torch.ops.fused_ingest import (
    K1_BLOCKS_PER_SM,
    K1_CLUSTER,
    K1_MAX_SHARED_BYTES,
    K1_MAX_TABLE_LOG2,
    K1_MIN_CHUNK,
    fused_ingest_batch,
    k1_key_bits,
    make_fused_ingest_fn,
    plan_fused_ingest,
)
from loghisto_tpu_torch.ops.ingest import (
    bucket_indices,
    ingest_batch,
    make_ingest_fn,
    make_packed_ingest_fn,
    make_weighted_ingest_fn,
    merge_accumulators,
)
from loghisto_tpu_torch.ops.row_ingest import histogram_row, row_ingest_batch
from loghisto_tpu_torch.ops.sparse_ingest import (
    MAX_TARGETS,
    sparse_ingest,
    sparse_ingest_batch,
    sparse_ingest_multi,
    sparse_ingest_multi_batch,
)

F32 = np.finfo(np.float32)
ADVERSARIAL = np.array(
    [0.0, -0.0, F32.smallest_subnormal, -F32.smallest_subnormal, F32.tiny,
     np.inf, -np.inf, np.nan, 3.4e38, -3.4e38, -1.0, -58.7, 1e-30],
    dtype=np.float32,
)


def _batch(n, m, bl, seed, adversarial=True):
    """Seeded (ids, values) with ids straddling [0, M) (-1, M, 2^30) and
    the adversarial values, codec-disagreeing samples filtered out.
    Returns (ids, values, departures)."""
    rng = np.random.default_rng(seed)
    values = (rng.lognormal(0.5, 1.5, n) * np.where(
        rng.random(n) < 0.3, -1.0, 1.0)).astype(np.float32)
    ids = rng.integers(-1, m + 1, n).astype(np.int32)
    if adversarial:
        k = len(ADVERSARIAL)
        values[:k] = ADVERSARIAL
        ids[:k] = rng.integers(0, m, k)
        ids[k:k + 3] = [-1, m, 2**30]
    jax_idx = np.asarray(jax_bucket_indices(jnp.asarray(values), bl))
    port_idx = bucket_indices(torch.from_numpy(values), bl).numpy()
    agree = jax_idx == port_idx
    return ids[agree], values[agree], int((~agree).sum())


def _zeros(m, bl):
    return torch.zeros((m, 2 * bl + 1), dtype=torch.int32)


@pytest.mark.parametrize("m,bl,n,seed", [
    (16, 64, 4096, 0), (5, 64, 3000, 1), (3, 4096, 20000, 2),
    (16, 64, 0, 3),
])
def test_fused_plain_equals_jax_ingest_batch(m, bl, n, seed):
    ids, values, departs = _batch(n, m, bl, seed, adversarial=n > 0)
    assert departs <= max(1, n // 1000)
    acc = _zeros(m, bl)
    out = fused_ingest_batch(acc, torch.from_numpy(ids),
                             torch.from_numpy(values), bl)
    assert out is acc  # in place
    want = jax_ingest_batch(jnp.zeros((m, 2 * bl + 1), jnp.int32),
                            jnp.asarray(ids), jnp.asarray(values), bl)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want))
    valid = (ids >= 0) & (ids < m)
    assert int(acc.sum()) == int(valid.sum())


def test_fused_plain_equals_jax_pallas_kernel_interpret():
    m, bl = 16, 64
    ids, values, _ = _batch(4096, m, bl, seed=11)
    acc = _zeros(m, bl)
    acc[3, 7] = 5  # accumulates onto existing counts
    fused_ingest_batch(acc, torch.from_numpy(ids), torch.from_numpy(values),
                       bl)
    start = np.zeros((m, 2 * bl + 1), np.int32)
    start[3, 7] = 5
    want = jax_fused(jnp.asarray(start), jnp.asarray(ids),
                     jnp.asarray(values), bl, interpret=True)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["zipf", "one_cell"])
def test_fused_plain_equals_jax_pallas_interpret_on_skewed_batches(case):
    """The skewed batches K1's cell table is for: Zipf(1.3) ids (row 0
    takes about a quarter) and every sample on one cell, against the JAX
    kernel in interpret mode."""
    m, bl, n = 16, 64, 4096
    rng = np.random.default_rng(31)
    if case == "zipf":
        ids = ((rng.zipf(1.3, n) - 1) % m).astype(np.int32)
        values = rng.lognormal(-1.0, 0.8, n).astype(np.float32)
        ids, values = ids[_codecs_agree(values, bl)], values[
            _codecs_agree(values, bl)]
    else:
        ids = np.full(n, 5, np.int32)
        values = np.full(n, 0.5, np.float32)
    acc = _zeros(m, bl)
    fused_ingest_batch(acc, torch.from_numpy(ids), torch.from_numpy(values),
                       bl)
    want = jax_fused(jnp.zeros((m, 2 * bl + 1), jnp.int32),
                     jnp.asarray(ids), jnp.asarray(values), bl,
                     interpret=True)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want))
    assert int(acc.max()) >= (n if case == "one_cell" else n // 40)


def _codecs_agree(values, bl):
    return (np.asarray(jax_bucket_indices(jnp.asarray(values), bl))
            == bucket_indices(torch.from_numpy(values), bl).numpy())


@pytest.mark.parametrize("n,sms,resident,blocks,chunk,table_log2", [
    (0, 132, None, 8, 1, 8),
    (1, 132, 30, 8, 1, 8),
    (K1_MIN_CHUNK, 132, 30, 8, 256, 9),
    (2400, 132, 30, 8, 300, 10),
    (100_003, 132, 30, 48, 2084, 12),
    (1 << 20, 132, None, 264, 3972, 12),
    (1 << 20, 132, 30, 240, 4370, 12),
    (1 << 22, 132, 30, 240, 17477, 12),
    (1 << 20, 114, 30, 224, 4682, 12),
])
def test_k1_plan_sizes_grid_chunk_and_table(n, sms, resident, blocks,
                                            chunk, table_log2):
    """Whole clusters of K1_CLUSTER blocks, at most K1_BLOCKS_PER_SM an
    SM and no more clusters than the card holds at once, one pass of a
    block (2048 samples) a block at least; the table holds twice the
    chunk within its bounds; every block gets samples and the blocks
    cover the batch."""
    plan = plan_fused_ingest(n, 10_000, 8193, sms,
                             resident_clusters=resident)
    assert (plan.blocks, plan.chunk, plan.table_log2) == (
        blocks, chunk, table_log2)
    assert plan.blocks % K1_CLUSTER == 0
    assert plan.blocks <= max(K1_CLUSTER, sms * K1_BLOCKS_PER_SM)
    assert plan.table_log2 <= K1_MAX_TABLE_LOG2
    assert plan.blocks * plan.chunk >= n
    assert n < blocks * K1_MIN_CHUNK or (plan.blocks - 1) * plan.chunk < n
    assert plan.key_bits == 32


@pytest.mark.parametrize("m", [10_000, 262_200])
def test_k1_plan_pads_shared_memory_to_its_blocks_an_sm(m):
    """The plan asks for more than a 1/(K1_BLOCKS_PER_SM + 1) share of
    an SM's 228 KB (each block also holds 1 KB of the system's), so the
    card places K1_BLOCKS_PER_SM blocks an SM and no more, with 32- or
    64-bit keys."""
    sm_bytes, reserved = 233_472, 1024
    plan = plan_fused_ingest(1 << 20, m, 8193, 132)
    per_block = plan.shared_bytes + reserved
    assert K1_BLOCKS_PER_SM * per_block <= sm_bytes
    assert (K1_BLOCKS_PER_SM + 1) * per_block > sm_bytes
    assert plan.shared_bytes >= (1 << plan.table_log2) * (
        plan.key_bits // 8 + 4)


@pytest.mark.parametrize("m,b,bits", [
    (262_111, 8193, 32), (262_112, 8193, 32), (262_113, 8193, 64),
    (262_200, 8193, 64), ((1 << 30) - 1, 2, 32), (1 << 30, 2, 64),
    (10_000, 8193, 32), (1, 65_537, 32),
])
def test_k1_key_width_around_2_31_cells(m, b, bits):
    """64-bit table keys from M * B >= 2^31 on; the table then still
    fits the card's shared memory at its largest size."""
    assert k1_key_bits(m, b) == bits
    assert (m * b >= 2**31) == (bits == 64)
    plan = plan_fused_ingest(1 << 22, m, b, 132)
    assert plan.key_bits == bits
    assert plan.table_log2 == K1_MAX_TABLE_LOG2
    assert plan.shared_bytes >= (1 << plan.table_log2) * (bits // 8 + 4)
    assert plan.shared_bytes <= K1_MAX_SHARED_BYTES


@pytest.mark.parametrize("args,match", [
    ((-1, 8, 129, 132), "n=-1"),
    ((10, 8, 129, 0), "sm_count=0"),
    ((10, 8, 129, 132, 0), "resident_clusters=0"),
])
def test_k1_plan_refuses_what_it_cannot_plan(args, match):
    with pytest.raises(ValueError, match=match):
        plan_fused_ingest(*args)


def test_fused_casts_float64_values_like_jax():
    ids = np.zeros(4, np.int32)
    v64 = np.array([58.7, 1e-300, 1e300, -2.5])
    with np.errstate(over="ignore"):  # 1e300 -> inf, as JAX casts it
        v32 = v64.astype(np.float32)
    a = fused_ingest_batch(_zeros(1, 64), torch.from_numpy(ids),
                           torch.from_numpy(v64), 64)
    b = fused_ingest_batch(_zeros(1, 64), torch.from_numpy(ids),
                           torch.from_numpy(v32), 64)
    assert torch.equal(a, b)


@pytest.mark.parametrize("n,pad", [(4096, False), (3001, True), (0, True)])
def test_row_ingest_equals_jax(n, pad):
    bl = 64
    ids, values, _ = _batch(n, 1, bl, seed=n, adversarial=n > 0)
    ids = np.where(np.arange(len(ids)) % 3 == 0, ids, 0).astype(np.int32)
    acc = torch.zeros((1, 2 * bl + 1), dtype=torch.int32)
    row_ingest_batch(acc, torch.from_numpy(ids), torch.from_numpy(values), bl)
    want = jax_ingest_batch(jnp.zeros((1, 2 * bl + 1), jnp.int32),
                            jnp.asarray(np.where(ids == 0, 0, -1)),
                            jnp.asarray(values), bl)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want))
    if n == 3001:  # the Pallas K2b kernel itself, ragged N, interpret
        pallas = jax_row_ingest(jnp.zeros((1, 2 * bl + 1), jnp.int32),
                                jnp.asarray(ids), jnp.asarray(values), bl,
                                interpret=True)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(pallas))


def test_histogram_row_equals_masked_path():
    bl = 64
    _, values, _ = _batch(6000, 1, bl, seed=5)
    values = values[:4096]
    row = torch.zeros(2 * bl + 1, dtype=torch.int32)
    histogram_row(row, torch.from_numpy(values), bl)
    want = jax_ingest_batch(jnp.zeros((1, 2 * bl + 1), jnp.int32),
                            jnp.zeros(len(values), jnp.int32),
                            jnp.asarray(values), bl)
    np.testing.assert_array_equal(row.numpy(), np.asarray(want)[0])


@pytest.mark.parametrize("m,bl,seed", [(16, 64, 0), (7, 4096, 1)])
def test_sparse_equals_jax(m, bl, seed):
    rng = np.random.default_rng(seed)
    ids = (rng.zipf(1.3, 4000) - 1).astype(np.int32) % (m + 2) - 1
    values = rng.lognormal(1.0, 2.0, 4000).astype(np.float32)
    packed = fold_packed_numpy(ids, values, bl)
    pad = np.zeros((37, 3), np.int32)
    pad[:, 0] = -1  # pad rows drop
    pad[:5, 2] = 99
    extra = np.array([[0, 10 * bl, 3], [1, -10 * bl, 4], [m, 0, 9]],
                     np.int32)  # clipped buckets, out-of-range id
    packed = np.concatenate([packed, extra, pad])
    acc = _zeros(m, bl)
    sparse_ingest(acc, torch.from_numpy(packed), bl)
    jacc = jnp.zeros((m, 2 * bl + 1), jnp.int32)
    want = jax_sparse_batch(jacc, jnp.asarray(packed), bl)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want))
    plain = sparse_ingest_batch(_zeros(m, bl), torch.from_numpy(packed), bl)
    assert torch.equal(plain, acc)
    if bl == 64:  # the Pallas K3 kernel itself, interpret mode
        pallas = jax_pallas_sparse(jacc, jnp.asarray(packed), bl)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(pallas))


def _multi_triples(rng, n, bl, m_max):
    """n seeded triples with every edge K3 must keep exact: split-count
    duplicates (pack_cells at cap 5, adjacent), count-0 rows, ids -1,
    -7, at and past every target's row count and 2^30, buckets past
    +/-bl."""
    ids = rng.integers(-2, m_max + 3, n)
    ids[5::11] = 2**30
    buckets = rng.integers(-bl - 9, bl + 10, n)
    counts = rng.integers(1, 20, n)
    packed = pack_cells(ids, buckets, counts, cap=5)[:n].copy()
    packed[3::7, 2] = 0
    packed[6::13, 0] = -7
    return packed


def _multi_targets(rng, bl):
    """Targets of different row counts with nonzero contents, one of
    them a ring-slot view; returns (targets, ring)."""
    b = 2 * bl + 1
    ring = torch.from_numpy(rng.integers(0, 9, (3, 5, b)).astype(np.int32))
    targets = [torch.from_numpy(rng.integers(0, 9, (m, b)).astype(np.int32))
               for m in (9, 12, 1)]
    return [targets[0], ring[1], targets[1], targets[2]], ring


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 2500])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_sparse_ingest_multi_equals_jax_per_target(n, offset):
    """One triple array into four targets of 9, 5 (a ring slot), 12 and
    1 rows, from a view at 0, 1 or 3 triples into its buffer: each
    target equals the JAX scatter of the same triples into it alone."""
    bl = 64
    rng = np.random.default_rng(1000 * n + offset)
    buf = _multi_triples(rng, n + offset, bl, 12)
    packed = torch.from_numpy(buf)[offset:]
    targets, ring = _multi_targets(rng, bl)
    before = [t.clone() for t in targets]
    ring_before = ring.clone()
    want = [np.asarray(jax_sparse_batch(jnp.asarray(t.numpy()),
                                        jnp.asarray(packed.numpy()), bl))
            for t in before]
    out = sparse_ingest_multi(targets, packed, bl)
    assert out == targets
    for got, w in zip(targets, want):
        np.testing.assert_array_equal(got.numpy(), w)
    # the ring's other slots are untouched
    assert torch.equal(ring[0], ring_before[0])
    assert torch.equal(ring[2], ring_before[2])
    plain = [t.clone() for t in before]
    sparse_ingest_multi_batch(plain, packed, bl)
    assert all(torch.equal(a, b) for a, b in zip(plain, targets))


def test_sparse_ingest_multi_takes_more_targets_than_one_launch():
    bl = 16
    rng = np.random.default_rng(5)
    packed = torch.from_numpy(_multi_triples(rng, 400, bl, 6))
    targets = [torch.zeros((m, 2 * bl + 1), dtype=torch.int32)
               for m in range(1, MAX_TARGETS + 4)]
    sparse_ingest_multi(targets, packed, bl)
    for t in targets:
        want = sparse_ingest_batch(torch.zeros_like(t), packed, bl)
        assert torch.equal(t, want)


def test_sparse_ingest_multi_checks_every_target():
    bl = 8
    b = 2 * bl + 1
    packed = torch.zeros((4, 3), dtype=torch.int32)
    good = torch.zeros((3, b), dtype=torch.int32)
    with pytest.raises(ValueError, match="at least one target"):
        sparse_ingest_multi([], packed, bl)
    with pytest.raises(ValueError, match="buckets"):
        sparse_ingest_multi([good, torch.zeros((3, b + 2), dtype=torch.int32)],
                            packed, bl)
    with pytest.raises(ValueError, match="int32"):
        sparse_ingest_multi([good, torch.zeros((3, b))], packed, bl)
    with pytest.raises(ValueError, match="contiguous"):
        sparse_ingest_multi([good, torch.zeros((b, 3), dtype=torch.int32).t()],
                            packed, bl)
    with pytest.raises(ValueError, match="\\[M, B\\]"):
        sparse_ingest_multi([good, torch.zeros(b, dtype=torch.int32)],
                            packed, bl)
    with pytest.raises(ValueError, match="share one device"):
        sparse_ingest_multi(
            [good, torch.zeros((3, b), dtype=torch.int32, device="meta")],
            packed, bl)
    with pytest.raises(ValueError, match="\\[n, 3\\]"):
        sparse_ingest_multi([good], packed[:, :2], bl)
    with pytest.raises(ValueError, match="int32"):
        sparse_ingest_multi([good], packed.long(), bl)
    assert not good.any()  # nothing was written before a check failed


def test_fold_matches_plain_ingest():
    """The sparse route's host fold and the raw route bucket alike."""
    m, bl = 9, 4096
    ids, values, _ = _batch(20000, m, bl, seed=9)
    raw = ingest_batch(_zeros(m, bl), torch.from_numpy(ids),
                       torch.from_numpy(values), bl)
    packed = fold_packed_numpy(ids, values, bl)
    folded = sparse_ingest(_zeros(m, bl), torch.from_numpy(packed), bl)
    assert torch.equal(raw, folded)


def test_factories_and_merge_on_cpu():
    m, bl = 4, 64
    ids, values, _ = _batch(2000, m, bl, seed=4)
    a = make_ingest_fn(bl, device="cpu")(_zeros(m, bl), ids, values)
    b = make_fused_ingest_fn(bl, device="cpu")(_zeros(m, bl), ids, values)
    assert torch.equal(a, b)
    packed = fold_packed_numpy(ids, values, bl)
    c = make_packed_ingest_fn(bl, device="cpu")(_zeros(m, bl), packed)
    d = make_weighted_ingest_fn(bl, device="cpu")(
        _zeros(m, bl), packed[:, 0], packed[:, 1], packed[:, 2])
    assert torch.equal(a, c) and torch.equal(a, d)
    merged = merge_accumulators(a.clone(), b)
    assert torch.equal(merged, 2 * a)


def test_wrappers_raise_where_the_reference_raises():
    bl = 64
    row = torch.zeros(2 * bl + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 2048"):
        histogram_row(row, torch.zeros(100), bl)
    with pytest.raises(ValueError, match="2\\^24"):
        histogram_row(row, torch.zeros(1 << 24), bl)
    with pytest.raises(ValueError, match="2\\^24"):
        row_ingest_batch(row[None, :], torch.zeros((1 << 24) - 5,
                         dtype=torch.int32), torch.zeros((1 << 24) - 5), bl)
    with pytest.raises(ValueError, match="single-metric"):
        row_ingest_batch(_zeros(2, bl), torch.zeros(4, dtype=torch.int32),
                         torch.zeros(4), bl)
    with pytest.raises(ValueError, match="buckets"):
        fused_ingest_batch(_zeros(2, bl), torch.zeros(4, dtype=torch.int32),
                           torch.zeros(4), bl + 1)
    with pytest.raises(ValueError, match="\\[n, 3\\]"):
        sparse_ingest(_zeros(2, bl), torch.zeros((4, 2), dtype=torch.int32),
                      bl)
    with pytest.raises(ValueError, match="int32"):
        fused_ingest_batch(_zeros(2, bl), torch.zeros(4, dtype=torch.int64),
                           torch.zeros(4), bl)


def test_non_cpu_non_cuda_tensor_raises_instead_of_plain():
    """The plain version is taken only for CPU tensors."""
    acc = torch.zeros((2, 129), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="plain versions CPU"):
        backend.is_plain(acc, "fused_ingest")
    assert backend.is_plain(torch.zeros(1), "fused_ingest") is True
