"""Device steps of the metric lifecycle: the activity touch, the
evict-fold and the row repack, K6 (counterpart of
``loghisto_tpu/ops/lifecycle.py``).

An evicted row folds into its overflow row by integer addition
(lossless: log-bucket histograms merge exactly), and a compaction
repacks every structure over one survivor permutation
(``perm[new] = old``; -1, ``DROP_ID`` or any out-of-range entry is an
empty row):

  * ``make_touch_fn`` — the activity stamp of the spill fan-out (the
    fused commit stamps inside its own step, ops/commit.py);
  * ``make_fold_evict_fn`` — victims' rows of the accumulator and of
    every ring added to their overflow rows with ``index_add_``
    (duplicate targets accumulate), then zeroed, and ``last_active``
    stamped; victims and targets are masked per structure, since a ring
    may hold fewer rows than the accumulator.  In place, where the
    reference donates;
  * ``compact_rows`` — the plain repack; ``compact_rows_kernel`` — the
    wrapper of K6 (``csrc/compact_rows.cu``) in place of
    ``compact_rows_pallas``: on a CUDA tensor it launches K6 once per
    array (a whole ring in one launch), on a CPU tensor it takes the
    plain version.  Both run out of place and return a fresh tensor;
  * ``make_compact_fn`` — the accumulator, each ring and
    ``last_active`` over one permutation, the rings one at a time so
    each old ring is released before the next is repacked.

On paged storage (``with_acc=False``) the pool is folded and permuted by
``PagedStore`` on the host, and the two steps take the rings and
``last_active`` only, as the reference's ``fold_paged`` and
``compact_paged`` do.

On a ("stream", "metric") mesh (ROADMAP D10) each rank holds row blocks
of every structure, and a victim, its overflow target, or a survivor and
its new position may lie on different ranks of the metric line:

  * ``make_sharded_fold_evict_fn`` — each rank sums its victims' rows
    per target, sends each sum whose target another rank holds to that
    rank and adds what it holds (``parallel/mesh.fold_rows``: one
    ``all_to_all`` of the line, when a pair crosses), then zeroes its
    victims; for the accumulator block and every ring block;
  * ``make_sharded_compact_fn`` — the survivor permutation is global:
    each rank runs K6 on its block with the rows it keeps and receives
    the rows whose new position it holds from their ranks
    (``parallel/mesh.RowMove``: one ``all_to_all`` of the line, when a
    row crosses); for the accumulator block, ``last_active`` (a gather,
    not K6) and every ring block, whose unwritten slots stay home.

On paged storage on a mesh (ROADMAP D13) both take ``with_acc=False``:
the pool folds and permutes on every rank's host half, and the steps
move the ring blocks and the activity block only.

JAX's ``take(mode="fill")`` wraps negative indices before its bounds
check (the reason for the reference's ``_sanitize_perm``); here every
hole is masked to a zero row explicitly.
"""

from __future__ import annotations

import numpy as np
import torch

from loghisto_tpu_torch.ops.backend import is_plain, launch, to_device
from loghisto_tpu_torch.ops.commit import DROP_ID, stamp_activity
from loghisto_tpu_torch.parallel.mesh import (
    METRIC_AXIS,
    RowMove,
    axis_index,
    fold_rows,
    mesh_reduce,
)

COMPACT_PATH_RULE = (
    "the row repack follows the array's device, as every kernel wrapper "
    "of the port does: a CUDA array launches K6 (csrc/compact_rows.cu) and "
    "a CPU array takes the plain version (ROADMAP D4); pass "
    "compact_path='auto'"
)


def _index(ids, device) -> torch.Tensor:
    return to_device(np.asarray(ids, dtype=np.int64), device)


def make_touch_fn():
    """``touch(last_active, ids, epoch) -> last_active``: stamps
    ``last_active[ids] = max(last_active[ids], epoch)`` in place; ids
    outside the vector (DROP_ID pads) change nothing."""

    def touch(last_active, ids, epoch):
        ids_t = to_device(np.asarray(ids, dtype=np.int32),
                          last_active.device)
        return stamp_activity(last_active, ids_t, int(epoch))

    return touch


def _fold_rings(rings, last_active, v, t, epoch) -> None:
    """The rings' half of the evict-fold (in place): each victim's ring
    rows added to its target's, then zeroed; the victims'
    ``last_active`` stamped ``epoch``.  Victims and targets are masked
    per ring, since a ring may hold fewer rows than the row space."""
    dev = last_active.device
    for ring in rings:
        m_t = ring.shape[1]
        rv_ok = (v >= 0) & (v < m_t)
        pair = rv_ok & (t >= 0) & (t < m_t)
        if pair.any():
            ring.index_add_(1, _index(t[pair], dev),
                            ring.index_select(1, _index(v[pair], dev)))
        ring.index_fill_(1, _index(v[rv_ok], dev), 0)
    la_ok = (v >= 0) & (v < last_active.shape[0])
    last_active.index_fill_(0, _index(v[la_ok], dev), int(epoch))


def make_fold_evict_fn(num_tiers: int, with_acc: bool = True):
    """The evict-fold for ``num_tiers`` rings:
    ``fold(acc, rings, last_active, victims, targets, epoch) -> (acc,
    rings, last_active, victim_counts)``, with acc int32 [M, B], rings
    int32 [S, M_t, B] and last_active int32 [M] updated in place,
    victims/targets host int arrays [E] (DROP_ID pads; a target may be
    DROP_ID when the registry had no room for the overflow name) and
    ``victim_counts`` int64 [E], each victim's bucket total.

    Per structure: gather the victims' rows (a victim past the rows is
    an empty row), add each to its target (targets past the rows drop),
    zero the victims.  Targets are never victims (the policy protects
    overflow names), so add-then-zero is safe.

    ``with_acc=False`` is the paged-storage variant: the lifetime counts
    live in the page pool, which ``PagedStore.fold_rows_into`` folds on
    the host, so the step folds the rings and stamps ``last_active``
    only: ``fold_paged(rings, last_active, victims, targets, epoch) ->
    (rings, last_active)``."""

    def check(rings):
        if len(rings) != num_tiers:
            raise ValueError(f"{len(rings)} rings for {num_tiers} tiers")

    if not with_acc:

        def fold_paged(rings, last_active, victims, targets, epoch):
            check(rings)
            _fold_rings(rings, last_active,
                        np.asarray(victims, dtype=np.int64),
                        np.asarray(targets, dtype=np.int64), epoch)
            return rings, last_active

        return fold_paged

    def fold(acc, rings, last_active, victims, targets, epoch):
        check(rings)
        dev = acc.device
        v = np.asarray(victims, dtype=np.int64)
        t = np.asarray(targets, dtype=np.int64)
        m = acc.shape[0]
        v_ok = (v >= 0) & (v < m)
        rows = acc.index_select(0, _index(v[v_ok], dev))
        counts = torch.zeros(len(v), dtype=torch.int64, device=dev)
        counts[_index(np.flatnonzero(v_ok), dev)] = rows.sum(
            dim=1, dtype=torch.int64)
        t_sel = t[v_ok]
        both = (t_sel >= 0) & (t_sel < m)
        acc.index_add_(0, _index(t_sel[both], dev),
                       rows[_index(np.flatnonzero(both), dev)])
        acc.index_fill_(0, _index(v[v_ok], dev), 0)
        _fold_rings(rings, last_active, v, t, epoch)
        return acc, rings, last_active, counts

    return fold


# -- the repack ------------------------------------------------------------ #


def _sanitize_perm(perm, m: int) -> torch.Tensor:
    """Every out-of-range entry (DROP_ID pad or -1 hole) becomes the
    positive DROP sentinel (int32)."""
    perm = torch.as_tensor(perm)
    return torch.where((perm >= 0) & (perm < m), perm.to(torch.int32),
                       torch.full_like(perm, int(DROP_ID),
                                       dtype=torch.int32))


def _check_compact(arr: torch.Tensor, perm: torch.Tensor) -> None:
    if arr.ndim not in (2, 3):
        raise ValueError(
            f"arr must be [M, B] or [S, M, B]; got {tuple(arr.shape)}")
    if arr.element_size() != 4:
        raise ValueError(f"arr must hold 4-byte elements; got {arr.dtype}")
    if perm.ndim != 1:
        raise ValueError(f"perm must be 1-D; got {tuple(perm.shape)}")


def compact_rows(arr: torch.Tensor, perm) -> torch.Tensor:
    """Plain version: ``out[..., new, :] = arr[..., perm[new], :]`` over
    the row axis (-2), zero rows where ``perm[new]`` is out of range.
    Returns a fresh tensor with ``len(perm)`` rows."""
    perm = to_device(perm, arr.device)
    _check_compact(arr, perm)
    sp = _sanitize_perm(perm, arr.shape[-2])
    valid = sp != int(DROP_ID)
    src = torch.where(valid, sp, torch.zeros_like(sp)).long()
    out = arr.index_select(arr.ndim - 2, src)
    keep = valid.view(-1, 1) if arr.ndim == 2 else valid.view(1, -1, 1)
    return torch.where(keep, out, torch.zeros_like(out))


def compact_rows_kernel(arr: torch.Tensor, perm) -> torch.Tensor:
    """Kernel wrapper, same contract as ``compact_rows``: K6 on a CUDA
    array (one launch, out of place), the plain version on a CPU
    array."""
    perm = to_device(perm, arr.device)
    _check_compact(arr, perm)
    if is_plain(arr, "compact_rows"):
        return compact_rows(arr, perm)
    if not arr.is_contiguous():
        raise ValueError("arr must be contiguous (K6 indexes it flat)")
    perm32 = perm.to(torch.int32).contiguous()
    slots = 1 if arr.ndim == 2 else arr.shape[0]
    m_src, width = arr.shape[-2], arr.shape[-1]
    n_out = perm32.shape[0]
    out = torch.empty((*arr.shape[:-2], n_out, width), dtype=arr.dtype,
                      device=arr.device)
    launch("compact_rows", out.data_ptr(), arr.data_ptr(),
           perm32.data_ptr(), n_out, m_src, width, slots)
    return out


def resolve_compact_path(path: str) -> str:
    """The port's repack dispatch: only "auto" (the array's device
    decides); the reference's "jnp"/"pallas" values raise with the
    rule."""
    if path != "auto":
        raise ValueError(f"compact_path={path!r}: {COMPACT_PATH_RULE}")
    return path


def make_compact_fn(num_tiers: int, path: str = "auto",
                    with_acc: bool = True):
    """The full repack: ``compact(acc, rings, last_active, perm, epoch)
    -> (acc, rings, last_active)`` with ``perm`` host int32 [M]
    (``perm[new] = old``).  ``rings`` is a list the caller owns: each
    entry is replaced by its repacked ring before the next is built, so
    only one ring's copy is alive at a time.  Every output row is a copy
    of one input row or zeros, so survivor histograms — and every
    percentile of them — are bit-identical across the repack.  Freed
    rows get ``last_active = epoch``.

    ``with_acc=False`` is the paged-storage variant: the pool repacks on
    the host (``PagedStore.apply_permutation`` permutes page-table rows,
    no device traffic), so the step repacks the rings (K6 each) and
    ``last_active`` only: ``compact_paged(rings, last_active, perm,
    epoch) -> (rings, last_active)``."""
    resolve_compact_path(path)

    def compact_rings(rings, last_active, perm_t, epoch):
        if len(rings) != num_tiers:
            raise ValueError(f"{len(rings)} rings for {num_tiers} tiers")
        for i in range(num_tiers):
            m_t = rings[i].shape[1]
            rings[i] = compact_rows_kernel(rings[i], perm_t[:m_t])
        n = last_active.shape[0]
        p = perm_t[:n] if perm_t.shape[0] >= n else perm_t
        return rings, _activity_rows(epoch)(last_active, p)

    def perm_on(perm, device):
        return to_device(np.asarray(perm, dtype=np.int32), device)

    if not with_acc:

        def compact_paged(rings, last_active, perm, epoch):
            return compact_rings(rings, last_active,
                                 perm_on(perm, last_active.device), epoch)

        return compact_paged

    def compact(acc, rings, last_active, perm, epoch):
        perm_t = perm_on(perm, acc.device)
        acc = compact_rows_kernel(acc, perm_t)
        rings, la = compact_rings(rings, last_active, perm_t, epoch)
        return acc, rings, la

    return compact


def take_rows(arr: torch.Tensor, perm) -> torch.Tensor:
    """``out[new] = arr[perm[new]]`` on dim 0, zero rows where
    ``perm[new]`` is out of range: the plain row gather for carries K6
    does not take (any element type, e.g. an int64 host spill)."""
    perm = torch.as_tensor(perm, device=arr.device).long()
    valid = (perm >= 0) & (perm < arr.shape[0])
    out = torch.zeros((len(perm), *arr.shape[1:]), dtype=arr.dtype,
                      device=arr.device)
    out[valid] = arr[perm[valid]]
    return out


def _activity_rows(epoch):
    """The activity carry's repack: a gather (``last_active[p]``), the
    empty rows stamped ``epoch``."""

    def repack(la, p):
        empty = (p < 0) | (p >= la.shape[0])
        out = la[torch.where(empty, torch.zeros_like(p), p).long()]
        return torch.where(empty, torch.full_like(out, int(epoch)), out)

    return repack


def make_sharded_fold_evict_fn(mesh, num_tiers: int, with_acc: bool = True):
    """The evict-fold of one rank of a ("stream", "metric") mesh:
    ``fold(acc, rings, last_active, victims, targets, epoch) -> (acc,
    rings, last_active, moved, bytes_sent)`` on the rank's blocks (acc
    ``[M / n_metric, B]``, its stream row's partial; rings ``[S, M_t /
    n_metric, B]``; last_active ``[M / n_metric]``), in place, with
    global victim and target ids (DROP_ID pads).  ``moved`` is the
    victims' accumulator total summed over the whole mesh (int64, exact;
    the reference's ``vcounts`` summed), ``bytes_sent`` what this rank
    sent.  A collective of the mesh: every rank calls it with the same
    ids; each structure's exchange runs over the metric line, then one
    SUM over the mesh.

    ``with_acc=False`` is the paged mesh's variant (ROADMAP D13): the
    pool folds on every rank's host half (``PagedStore.fold_rows_into``,
    whose gathered total stands for ``moved``), so the step folds the
    ring blocks and stamps the activity block only, a collective of the
    metric line: ``fold_paged(rings, last_active, victims, targets,
    epoch) -> (rings, last_active, bytes_sent)``."""

    def fold_rings(rings, last_active, v, t, rows, epoch):
        if len(rings) != num_tiers:
            raise ValueError(f"{len(rings)} rings for {num_tiers} tiers")
        sent = 0
        for ring in rings:
            sent += fold_rows(mesh, ring, 1, v, t, ring.shape[1])
        lo = axis_index(mesh, METRIC_AXIS) * rows
        own = v[(v >= lo) & (v < lo + rows)] - lo
        last_active.index_fill_(0, _index(own, last_active.device),
                                int(epoch))
        return sent

    def ids(victims, targets):
        return (np.asarray(victims, dtype=np.int64),
                np.asarray(targets, dtype=np.int64))

    if not with_acc:

        def fold_paged(rings, last_active, victims, targets, epoch):
            v, t = ids(victims, targets)
            sent = fold_rings(rings, last_active, v, t,
                              last_active.shape[0], epoch)
            return rings, last_active, sent

        return fold_paged

    def fold(acc, rings, last_active, victims, targets, epoch):
        import torch.distributed as dist

        v, t = ids(victims, targets)
        rows = acc.shape[0]
        lo = axis_index(mesh, METRIC_AXIS) * rows
        own = v[(v >= lo) & (v < lo + rows)] - lo
        total = int(acc.index_select(0, _index(own, acc.device)).sum(
            dtype=torch.int64))
        sent = fold_rows(mesh, acc, 0, v, t, rows)
        ring_sent = fold_rings(rings, last_active, v, t, rows, epoch)
        moved = mesh_reduce(mesh, [total], dist.ReduceOp.SUM)[0]
        return acc, rings, last_active, moved, sent + ring_sent

    return fold


def make_sharded_compact_fn(mesh, num_tiers: int, with_acc: bool = True):
    """The repack of one rank of a ("stream", "metric") mesh:
    ``compact(acc, rings, last_active, perm, epoch, written) -> (acc,
    rings, last_active, bytes_sent)`` on the rank's blocks, with the
    global ``perm`` (host int32 [M], ``perm[new] = old``).  K6 repacks
    the accumulator block and each ring block with the rows the rank
    keeps, the crossing rows arrive from their ranks (``RowMove``), and
    ``last_active`` moves the same way through a gather (freed rows
    stamped ``epoch``).  ``written[t]`` lists tier t's written slots:
    only they hold counts, so only their crossing rows travel.
    ``rings`` is a list the caller owns, its entries replaced one at a
    time.  A collective of the metric line.

    ``with_acc=False`` is the paged mesh's variant (ROADMAP D13): the
    pool permutes on every rank's host half
    (``PagedStore.apply_permutation``), so the step repacks the ring
    blocks and the activity block only: ``compact_paged(rings,
    last_active, perm, epoch, written) -> (rings, last_active,
    bytes_sent)``."""

    def compact_rings(move, rows, rings, perm, written):
        if len(rings) != num_tiers:
            raise ValueError(f"{len(rings)} rings for {num_tiers} tiers")
        sent = 0
        for i in range(num_tiers):
            ring_rows = rings[i].shape[1]
            rmove = move if ring_rows == rows else RowMove(
                mesh, perm, ring_rows, ring_rows)
            before = rmove.bytes_sent
            rings[i] = rmove.apply(rings[i], 1, compact_rows_kernel,
                                   lead=written[i])
            sent += rmove.bytes_sent - before
        return sent

    if not with_acc:

        def compact_paged(rings, last_active, perm, epoch, written):
            rows = last_active.shape[0]
            move = RowMove(mesh, perm, rows, rows)
            la = move.apply(last_active, 0, _activity_rows(epoch))
            sent = move.bytes_sent
            sent += compact_rings(move, rows, rings, perm, written)
            return rings, la, sent

        return compact_paged

    def compact(acc, rings, last_active, perm, epoch, written):
        rows = acc.shape[0]
        move = RowMove(mesh, perm, rows, rows)
        acc = move.apply(acc, 0, compact_rows_kernel)
        la = move.apply(last_active, 0, _activity_rows(epoch))
        sent = move.bytes_sent
        sent += compact_rings(move, rows, rings, perm, written)
        return acc, rings, la, sent

    return compact


def pad_pow2_ids(ids, min_width: int = 8) -> np.ndarray:
    """Pad a host id vector to the next power-of-two width with DROP_ID
    (the reference's executable-count bound; kept so victim lists have
    the reference's shapes)."""
    n = len(ids)
    width = max(min_width, 1 << max(0, (int(n) - 1).bit_length()))
    out = np.full(width, DROP_ID, dtype=np.int32)
    out[:n] = np.asarray(ids, dtype=np.int32)
    return out
