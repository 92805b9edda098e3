"""The lifecycle half of the port's paged store, the paged device steps
of the lifecycle and the paged fused commit, against the JAX package on
the CPU, at a small size: bucket_limit 512 (B = 1025, 5 pages a row),
pools of 512 pages (and a 40-page pool that saturates), 64 rows.
Inputs are numpy arrays from a seed.

Tolerances:
  * pools, page tables, codecs, free lists, allocation and release
    counts, host spills, moved totals, rings, activity vectors and the
    decoded cells: EQUAL;
  * host-statistics counts and percentiles: EQUAL; their sums rtol 1e-12
    (the JAX function reduces each row with ``np.dot``, the port with
    ``np.add.reduceat``).

The JAX store runs its jnp tier (``kernel="jnp"``), which the JAX
package pins bit-identical to its Pallas tier.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loghisto_tpu import paging as jpaging
from loghisto_tpu.ops import commit as jcommit
from loghisto_tpu.ops import lifecycle as jlifecycle
from loghisto_tpu_torch import paging
from loghisto_tpu_torch.ops import commit as pcommit
from loghisto_tpu_torch.ops import lifecycle as plifecycle
from loghisto_tpu_torch.ops.backend import kernel_launches

BL = 512
B = 2 * BL + 1
M = 64
POOL = 512
PS = np.array([0.0, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0])
CODECS = ["dense", "loglinear", "polytail", "auto"]


def _stores(pool=POOL, m=M, **cfg):
    jst = jpaging.PagedStore(
        m, BL, config=jpaging.PagedStoreConfig(pool_pages=pool, **cfg),
        kernel="jnp")
    pst = paging.PagedStore(
        m, BL, config=paging.PagedStoreConfig(pool_pages=pool, **cfg),
        device="cpu")
    return jst, pst


def _cells(rng, rows, per_row=24):
    """Packed (row, codec bucket, count) cells: a narrow band (dense
    under "auto"), a wide spread (loglinear) or a tail-heavy one
    (polytail) per row, with repeated cells."""
    out = []
    for r in rows:
        kind = r % 3
        if kind == 0:
            centre = rng.integers(-BL + 40, BL - 40)
            b = centre + rng.integers(-30, 30, per_row)
        elif kind == 1:
            b = rng.integers(-BL, BL + 1, per_row)
        else:
            b = np.where(rng.random(per_row) < 0.7,
                         rng.integers(BL // 2 + 2, BL + 1, per_row),
                         rng.integers(-20, 20, per_row))
        w = rng.integers(1, 1000, per_row)
        out.append(np.stack([np.full(per_row, r), b, w], axis=1))
    packed = np.concatenate(out).astype(np.int32)
    return np.concatenate([packed, packed[::5]])


def _sorted_cells(rows, idx, counts):
    order = np.lexsort((idx, rows))
    return rows[order], idx[order], counts[order]


def _assert_same(jst, pst):
    np.testing.assert_array_equal(pst.page_table, jst.page_table)
    np.testing.assert_array_equal(pst.row_codec, jst.row_codec)
    assert pst.free_list() == jst._free_lists[0]
    assert pst._host_spill == jst._host_spill
    for key in ("allocated_pages", "released_pages", "spilled_cells",
                "overflowed_cells", "commits", "h2d_bytes"):
        assert getattr(pst, key) == getattr(jst, key), key
    np.testing.assert_array_equal(pst._pool.numpy(), np.asarray(jst._pool))
    for g, w in zip(_sorted_cells(*pst.decode_cells()),
                    _sorted_cells(*jst.decode_cells())):
        np.testing.assert_array_equal(g, w)
    got, want = pst.stats(PS, reset=False), jst.stats(PS, reset=False)
    np.testing.assert_array_equal(got["counts"], want["counts"])
    np.testing.assert_array_equal(got["percentiles"], want["percentiles"])
    np.testing.assert_allclose(got["sums"], want["sums"], rtol=1e-12)


@pytest.mark.parametrize("pool", [POOL, 40])
@pytest.mark.parametrize("codec", CODECS)
def test_store_lifecycle_script_equals_jax(codec, pool):
    """One script of commit, spill_cells, fold_rows_into, release_rows,
    drop_rows, apply_permutation, set_row_codec and spill_triples on
    both stores; after each step the page tables, codecs, free lists,
    host spills, pools, decoded cells, statistics and counters are
    equal, and so are the moved totals.  The 40-page pool saturates, so
    translate spills and the fold's recommit spills as well."""
    rng = np.random.default_rng(zlib.crc32(f"{codec}-{pool}".encode()))
    jst, pst = _stores(pool=pool, codec=codec)
    both = (jst, pst)

    def step(fn):
        got = [fn(st) for st in both]
        assert got[0] == got[1]
        _assert_same(jst, pst)
        return got[1]

    cells = _cells(rng, range(0, 40))
    step(lambda st: st.commit(cells))
    spill = (np.array([3, 5, 5, 6, 30]), np.array([7, BL, BL, B - 1, 0]),
             np.array([4, 9, 1, 2 ** 40, 5]))
    step(lambda st: st.spill_cells(*spill))
    moved = step(lambda st: st.fold_rows_into([3, 5, 6, 62], target=60))
    assert moved > 2 ** 40
    # freed slots are reused in the JAX order
    cells = _cells(rng, range(40, 52))
    step(lambda st: st.commit(cells))
    step(lambda st: st.fold_rows_into([60, 7], target=60))
    step(lambda st: st._zero_rows([8, 9]))
    released = step(lambda st: st.release_rows([9, 8, 8]))
    assert released > 0
    step(lambda st: st.drop_rows([10, 30]))
    step(lambda st: st.drop_rows([]))
    live = [r for r in range(M) if pst.row_codec[r] >= 0]
    perm = live + [-1] * (M - len(live))
    step(lambda st: st.apply_permutation(perm, M))
    step(lambda st: st.set_row_codec(M - 1, "polytail"))
    with pytest.raises(ValueError, match="already holds data"):
        pst.set_row_codec(0, "loglinear" if pst.row_codec[0] == 0
                          else "dense")
    cells = _cells(rng, [M - 1, 0, 1])
    step(lambda st: st.commit(cells))
    # spill_triples: the same translated chunk folds back into the spill
    cells = _cells(rng, [2, 4, M - 1], per_row=6)
    trip = [st.translate(cells)[0] for st in both]
    np.testing.assert_array_equal(trip[0], trip[1])
    pad = np.array([[-1, 0, 0], [0, 3, 5]], np.int32)
    step(lambda st: st.spill_triples(np.concatenate([trip[1], pad])))
    assert step(lambda st: st.spill_triples(pad)) == 0
    assert pst.spilled_cells > 0 if pool < POOL else pst.spilled_cells == 0


@pytest.mark.parametrize("codec", CODECS)
def test_extract_rows_equals_jax(codec):
    rng = np.random.default_rng(7)
    jst, pst = _stores(codec=codec)
    packed = _cells(rng, range(M))
    for st in (jst, pst):
        st.commit(packed)
        st.spill_cells(np.array([4]), np.array([BL]), np.array([3]))
    victims = [17, 4, 33, 4, 60]
    got, want = pst._extract_rows(victims), jst._extract_rows(victims)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    _assert_same(jst, pst)
    # the codecs stay, so a recommit lands the rows where they were
    assert (pst.row_codec[[17, 4, 33, 60]] >= 0).all()
    for st in (jst, pst):
        st.commit(want)
    _assert_same(jst, pst)
    assert pst._extract_rows([]).shape == (0, 3)


# -- the reference's own tests of the lifecycle composition ------------------


def test_release_rows_returns_pages_to_free_pool():
    store = paging.PagedStore(8, BL, config=paging.PagedStoreConfig(
        pool_pages=64, codec="dense"), device="cpu")
    packed = np.array([[0, 0, 3], [1, 300, 4], [2, -300, 5]], np.int32)
    store.commit(packed)
    before = store.free_pages
    store._zero_rows([0, 1])
    released = store.release_rows([0, 1])
    assert released > 0
    assert store.free_pages == before + released
    assert store.released_pages >= released
    counts = np.asarray(store.stats(PS, reset=False)["counts"])
    assert counts[0] == 0 and counts[1] == 0 and counts[2] == 5
    store.commit(np.array([[5, 100, 2]], np.int32))
    assert np.asarray(store.stats(PS, reset=False)["counts"])[5] == 2


def test_fold_rows_into_is_count_exact_and_frees_pages():
    store = paging.PagedStore(8, BL, config=paging.PagedStoreConfig(
        pool_pages=64, codec="dense", overflow_row=7), device="cpu")
    store.commit(np.array([[0, 5, 10], [1, -7, 20], [2, 9, 30]], np.int32))
    store.spill_cells(np.array([1]), np.array([BL + 2]), np.array([4]))
    free_before = store.free_pages
    moved = store.fold_rows_into([0, 1], target=7)
    assert moved == 10 + 20 + 4
    assert store.free_pages > free_before
    counts = np.asarray(store.stats(PS, reset=False)["counts"])
    assert counts[0] == 0 and counts[1] == 0
    assert counts[7] == 34 and counts[2] == 30
    assert int(counts.sum()) == 64


def test_apply_permutation_repacks_without_device_traffic():
    store = paging.PagedStore(8, BL, config=paging.PagedStoreConfig(
        pool_pages=64, codec="dense"), device="cpu")
    store.commit(np.array([[3, 11, 6], [6, -11, 8]], np.int32))
    store.spill_cells(np.array([6]), np.array([BL]), np.array([2]))
    h2d_before = store.h2d_bytes
    pool_before = store._pool.clone()
    perm = [3, 6] + [i for i in range(8) if i not in (3, 6)]
    store.apply_permutation(perm, 8)
    assert store.h2d_bytes == h2d_before  # a pure host table permutation
    assert torch.equal(store._pool, pool_before)
    counts = np.asarray(store.stats(PS, reset=False)["counts"])
    assert counts[0] == 6 and counts[1] == 10
    assert counts[2:].sum() == 0


def test_release_after_load_state_grows_the_free_stack():
    _, pst = _stores(codec="dense")
    pst.commit(_cells(np.random.default_rng(3), range(8)))
    fresh = paging.PagedStore(M, BL, config=paging.PagedStoreConfig(
        pool_pages=POOL, codec="dense"), device="cpu")
    fresh.load_state(pst.state())
    n = fresh.free_pages
    freed = fresh.release_rows(range(8))
    assert fresh.free_pages == n + freed == POOL - 1
    assert sorted(fresh.free_list()) == list(range(1, POOL))


def test_lifecycle_changes_reach_the_k4f_mirror():
    """Every table or codec change reaches the device mirrors K4f reads:
    after a release, a fold, an extraction, a permutation and a pinned
    codec, the mirrors equal a fresh build from the host table."""
    rng = np.random.default_rng(5)
    _, pst = _stores(codec="auto")
    pst.commit(_cells(rng, range(M)))
    pst.device_luts()  # the mirror exists from here on

    def check():
        rc, _, tbl = pst.device_luts()
        np.testing.assert_array_equal(rc.numpy(),
                                      pst.row_codec.astype(np.int32))
        np.testing.assert_array_equal(tbl.numpy(), pst.page_table.T)

    pst.fold_rows_into([1, 2, 3], target=0)
    check()
    pst._zero_rows([5])
    pst.release_rows([5])
    check()
    pst.drop_rows([6])
    check()
    pst._extract_rows([7, 9])
    check()
    pst.set_row_codec(5, "polytail")
    check()
    live = [r for r in range(M) if pst.row_codec[r] >= 0]
    pst.apply_permutation(live + [-1] * (M - len(live)), M)
    check()


# -- the paged device steps of the lifecycle ---------------------------------

TIER_SHAPES = ((4, M), (3, M - 8))  # a ring may hold fewer rows


def _rings(rng):
    return [rng.integers(0, 50, (s, m, B)).astype(np.int32)
            for s, m in TIER_SHAPES]


def test_fold_paged_equals_jax():
    rng = np.random.default_rng(11)
    rings = _rings(rng)
    la = rng.integers(0, 10, M).astype(np.int32)
    victims = plifecycle.pad_pow2_ids([3, 9, 60, 40, 41])
    targets = np.full(len(victims), pcommit.DROP_ID, dtype=np.int32)
    targets[:5] = [50, 50, 20, pcommit.DROP_ID, 62]
    want_rings, want_la = jlifecycle.make_fold_evict_fn(2, with_acc=False)(
        tuple(jnp.asarray(r) for r in rings), jnp.asarray(la),
        jnp.asarray(victims), jnp.asarray(targets), np.int32(12))
    got_rings = [torch.from_numpy(r.copy()) for r in rings]
    got_la = torch.from_numpy(la.copy())
    out_rings, out_la = plifecycle.make_fold_evict_fn(2, with_acc=False)(
        got_rings, got_la, victims, targets, 12)
    assert out_la is got_la  # in place
    for g, w in zip(out_rings, want_rings):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(out_la.numpy(), np.asarray(want_la))
    with pytest.raises(ValueError, match="rings for 3 tiers"):
        plifecycle.make_fold_evict_fn(3, with_acc=False)(
            got_rings, got_la, victims, targets, 12)


def test_compact_paged_equals_jax():
    rng = np.random.default_rng(12)
    rings = _rings(rng)
    la = rng.integers(0, 10, M).astype(np.int32)
    perm = np.full(M, pcommit.DROP_ID, dtype=np.int32)
    live = np.sort(rng.choice(M, 40, replace=False))
    perm[:40] = live
    perm[5] = -1  # an explicit hole
    want_rings, want_la = jlifecycle.make_compact_fn(
        2, "jnp", with_acc=False)(
        tuple(jnp.asarray(r) for r in rings), jnp.asarray(la),
        jnp.asarray(perm), np.int32(7))
    got = [torch.from_numpy(r.copy()) for r in rings]
    before = kernel_launches()["compact_rows"]
    out_rings, out_la = plifecycle.make_compact_fn(2, with_acc=False)(
        got, torch.from_numpy(la.copy()), perm, 7)
    assert out_rings is got  # the caller's list, each entry replaced
    assert kernel_launches()["compact_rows"] == before  # plain on a CPU
    for g, w in zip(out_rings, want_rings):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(out_la.numpy(), np.asarray(want_la))


# -- the paged fused commit step ----------------------------------------------


def _commit_operands(rng, n=300):
    pool = rng.integers(0, 100, (POOL, 256)).astype(np.int32)
    pool[0] = 0
    rings = _rings(rng)
    # buckets mostly positive, so the payloads' float32 sums stay well
    # conditioned (the JAX and port reductions sum in different orders)
    for r in rings:
        r[..., : BL - 4] = 0
    la = rng.integers(0, 5, M).astype(np.int32)
    ids = rng.integers(0, M + 4, n).astype(np.int32)  # past the rows drop
    ids[-7:] = pcommit.DROP_ID
    buckets = rng.integers(-4, BL + 1, n).astype(np.int32)
    buckets[:3] = [-BL - 5, BL + 9, -BL]  # past the range: they clip
    weights = rng.integers(0, 1000, n).astype(np.int32)
    triples = np.stack([rng.integers(-1, POOL, n), rng.integers(0, 256, n),
                        rng.integers(0, 1000, n)], axis=1).astype(np.int32)
    triples = np.concatenate([triples, triples[:40]])  # repeated cells
    masks = (np.array([[1, 1, 1, 1], [0, 1, 1, 0]], bool),
             np.array([[1, 1, 1]], bool))
    return pool, rings, la, ids, buckets, weights, triples, masks


@pytest.mark.parametrize("snapshot", [False, True])
@pytest.mark.parametrize("track", [False, True])
def test_paged_fused_commit_step_equals_jax(track, snapshot):
    """The port's paged commit step (K4 into the pool, one K3 into every
    tier's open slot, the activity stamp; the snapshot variant's tier
    payloads) against the JAX paged commit program on the same pool,
    rings, activity vector, cells, triples and masks: integers equal,
    payload sums rtol 1e-5 (float32 matvecs summed in another order)."""
    rng = np.random.default_rng(13 + 2 * track + snapshot)
    pool, rings, la, ids, buckets, weights, triples, masks = \
        _commit_operands(rng)
    slots, keeps = [2, 1], [0, 1]
    if snapshot:
        jfn = jcommit.make_paged_fused_commit_snapshot_fn(
            2, BL, merge_path="jnp", track_activity=track)
        pfn = pcommit.make_paged_fused_commit_snapshot_fn(
            2, BL, track_activity=track)
    else:
        jfn = jcommit.make_paged_fused_commit_fn(2, track)
        pfn = pcommit.make_paged_fused_commit_fn(2, BL, track)
    jargs = [jnp.asarray(pool), tuple(jnp.asarray(r) for r in rings)]
    pargs = [torch.from_numpy(pool.copy()),
             [torch.from_numpy(r.copy()) for r in rings]]
    if track:
        jargs.append(jnp.asarray(la))
        pargs.append(torch.from_numpy(la.copy()))
    jargs += [np.asarray(slots, np.int32), np.asarray(keeps, np.int32),
              # the committer's conversion: dense columns, clipped
              jnp.asarray(ids), jnp.asarray(np.clip(buckets, -BL, BL) + BL),
              jnp.asarray(weights), jnp.asarray(triples)]
    pargs += [slots, keeps,
              torch.from_numpy(np.stack([ids, buckets, weights], axis=1)),
              torch.from_numpy(triples)]
    if track:
        jargs.append(np.int32(9))
        pargs.append(9)
    if snapshot:
        jargs.append(tuple(jnp.asarray(m) for m in masks))
        pargs.append(masks)
    want, got = jfn(*jargs), pfn(*pargs)
    assert len(got) == len(want) == 2 + track + snapshot
    assert got[0] is pargs[0]  # the pool, in place
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if track:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if snapshot:
        for g, w in zip(got[-1], want[-1]):
            np.testing.assert_array_equal(g["cdf"].numpy(),
                                          np.asarray(w["cdf"]))
            np.testing.assert_array_equal(g["counts"].numpy(),
                                          np.asarray(w["counts"]))
            np.testing.assert_allclose(g["sums"].numpy(),
                                       np.asarray(w["sums"]), rtol=1e-5,
                                       atol=1e-6)


def test_paged_triple_ring_waits_and_keeps_what_it_staged():
    ring = pcommit.PagedTripleRing(depth=2, width=4, device="cpu")
    with pytest.raises(ValueError, match="exceeds staging width"):
        ring.stage(np.zeros((5, 3), np.int32))
    a = ring.stage(np.array([[3, 1, 7], [4, 2, 8]], np.int32))
    b = ring.stage(np.array([[5, 0, 9]], np.int32))
    c = ring.stage(np.array([[6, 6, 6]] * 3, np.int32))
    assert a.tolist() == [[3, 1, 7], [4, 2, 8]]  # a's slot was rewritten
    assert b.tolist() == [[5, 0, 9]] and c.shape == (3, 3)
    assert (ring.uploads, ring.bytes_uploaded) == (3, 6 * 12)
