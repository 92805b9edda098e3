"""The fused interval commit: one pass over an interval's cells for the
aggregator's accumulator and every retention tier's open slot
(counterpart of ``loghisto_tpu/ops/commit.py``: ``COMMIT_CHUNK``,
``DROP_ID``, ``make_fused_commit_fn``, ``make_fused_commit_snapshot_fn``,
their paged twins ``make_paged_fused_commit_fn`` and
``make_paged_fused_commit_snapshot_fn``, ``CellStagingRing``,
``PagedTripleRing``, and the sharded dense pair
``make_sharded_fused_commit_fn`` and
``make_sharded_fused_commit_snapshot_fn``; a paged mesh rank runs the
paged pair).

The reference jits one donated-carry program per chunk of cells.  The
port runs the same steps eagerly on PyTorch's current stream and updates
the carries IN PLACE where the reference donates them:

  * the ring-wrap clear is ``ring[slot].mul_(keep)`` with keep 0 (a keep
    of 1 is the identity and is skipped), and the interval's first chunk
    clears ``ihist``, both queued before the scatter;
  * the accumulator, each tier's open slot and the drift engine's
    interval histogram ``ihist`` take the chunk in ONE K3 launch
    (``ops/sparse_ingest.sparse_ingest_multi``) from one uploaded int32
    ``(id, codec bucket, count)`` triple array, read once; a tier gets
    the contiguous view ``ring[slot]``, whose row count bounds the ids
    it keeps (K3 drops ids outside each target's ``[0, M_t)``, the
    reference's ``mode="drop"``);
  * the lifecycle's activity stamp is ``scatter_reduce_(..., "amax")``
    of the epoch over the chunk's ids, with ids past the vector masked
    to a neutral value first, so no pad indexes out of range;
  * the final chunk of an interval also builds the snapshot payloads —
    per tier ``ops/window.window_snapshot`` (one K5 for all its views), and
    ``ops/stats.dense_cdf`` of the accumulator — as fresh tensors that no
    later commit writes, and runs the EWMA bank update
    (``ops/anomaly.ewma_bank_update``, plain float32 tensor code).

On paged storage the page pool takes the accumulator's place: each chunk
also arrives as host-translated ``(slot, offset, count)`` triples
(``PagedStore.translate``), which K4 (``ops/paged_store.paged_scatter``)
adds into the pool before the one K3 launch into every tier's open slot;
the final step emits the tier payloads only, since the pool's counts sit
behind per-row codecs and ``PagedStore.query`` / ``stats`` serve them.

On a ("stream", "metric") mesh (ROADMAP D8, D9) a rank's step takes its
stream row's share of the chunk, int32 triples of global ids padded to
``chunk / n_stream`` rows.  It gathers the shares of every stream row
(``parallel/mesh.gather_triples``, one ``all_gather`` over the stream
axis), adds its own share into its block of the accumulator (one K3:
the accumulator stays the stream row's partial, which ``collect()``
reduces) and the gathered chunk into its block of every tier's open
slot (one K3 for every tier; one K3 for all of them on a one-row
stream axis, where the share is the chunk), each keeping the ids of
its block; the final step's payloads are K5 over the rank's ring
blocks, row-sharded like the reference's.  The JAX program psums dense
shard-local deltas instead; int32 adds commute, so the rings are the
same bits.

On paged storage on a mesh (ROADMAP D12) every rank commits the merged
interval's chunk itself, the same cells on every rank, so a step makes
no collective and is the paged pair's: the caller hands it the chunk's
translated triples of the rank's arena (arena-local slots) and the
chunk's cells of the rank's ring blocks (block-local ids), so K4 adds
into the arena, one K3 into every tier's open slot of the ring blocks,
and the final step's payloads are K5 over the ring blocks.  With
lifecycle on (ROADMAP D13) the activity block takes the chunk's ids in
the aggregator's block (``stamp``): the merged chunk is the same on
every rank of a metric column, so no gather is needed.  The
reference's program psums the stream shares' deltas instead; the arena
and the rings are the same bits.

Integer scatter-adds are order-independent, so the fused commit equals
the fan-out path (``merge_raw`` + ``TimeWheel.push``) bit for bit.
``loghisto_tpu_torch.commit.IntervalCommitter`` owns locks, spill policy
and tier metadata.
"""

from __future__ import annotations

import numpy as np
import torch

from loghisto_tpu_torch.config import PRECISION
from loghisto_tpu_torch.ops.backend import resolve_device
from loghisto_tpu_torch.ops.paged_store import paged_scatter
from loghisto_tpu_torch.ops.sparse_ingest import sparse_ingest_multi
from loghisto_tpu_torch.ops.stats import dense_cdf
from loghisto_tpu_torch.ops.window import window_snapshot
from loghisto_tpu_torch.parallel.mesh import (
    METRIC_AXIS,
    STREAM_AXIS,
    axis_index,
    axis_size,
    block_triples,
    gather_triples,
)

# Cells per commit step, matching the aggregator bridge's merge chunk:
# a typical interval is one step, a 10k-metric worst case a handful.
COMMIT_CHUNK = 1 << 16

# Drop sentinel for pad ids: past every row range, so every scatter
# drops it (the lifecycle pads its victim lists with it).
DROP_ID = np.int32(2**30)

_INT32_MIN = -(2**31)


def stamp_activity(last_active: torch.Tensor, ids: torch.Tensor,
                   epoch: int) -> torch.Tensor:
    """``last_active[ids] = max(last_active[ids], epoch)`` in place; ids
    outside ``[0, len(last_active))`` change nothing."""
    valid = (ids >= 0) & (ids < last_active.shape[0])
    idx = torch.where(valid, ids, torch.zeros_like(ids)).long()
    src = torch.full(ids.shape, int(epoch), dtype=torch.int32,
                     device=ids.device)
    src.masked_fill_(~valid, _INT32_MIN)
    return last_active.scatter_reduce_(0, idx, src, "amax")


def _fold_chunk(acc, rings, last_active, ihist, slots, keeps, packed,
                epoch, ifirst, bucket_limit, landed=None, stamp=None):
    """One chunk into every carry (in place): the clears, then one K3
    launch for every target (the accumulator, when there is one, and
    each tier's open slot); ``landed()`` runs right after that launch,
    before the activity stamp of ``packed``'s ids, or of ``stamp`` where
    the activity vector's rows are not the rings' (a paged mesh rank:
    the chunk's ids in the aggregator's block)."""
    targets = [] if acc is None else [acc]
    for ring, slot, keep in zip(rings, slots, keeps):
        view = ring[int(slot)]
        if int(keep) != 1:
            view.mul_(int(keep))  # ring wrap: clear the slot's old life
        targets.append(view)
    if ihist is not None:
        if int(ifirst) == 0:
            ihist.zero_()  # the interval's first chunk: x ifirst = 0
        targets.append(ihist)
    sparse_ingest_multi(targets, packed, bucket_limit)
    if landed is not None:
        landed()
    if last_active is not None:
        stamp_activity(last_active, packed[:, 0] if stamp is None
                       else stamp, epoch)


def _step_fn(fold, num_tiers: int, track_activity: bool,
             track_baseline: bool):
    """A commit step over ``fold(acc, rings, last_active, ihist, slots,
    keeps, packed, epoch, ifirst, **kw)``, which updates the carries in
    place: ``commit(acc, rings, [last_active], [ihist], slots, keeps,
    packed, [epoch], [ifirst], **kw) -> (acc, rings, [last_active],
    [ihist])``."""

    def commit(*args, **kw):
        it = iter(args)
        acc, rings = next(it), tuple(next(it))
        la = next(it) if track_activity else None
        ihist = next(it) if track_baseline else None
        slots, keeps, packed = next(it), next(it), next(it)
        epoch = next(it) if track_activity else None
        ifirst = next(it) if track_baseline else None
        if len(rings) != num_tiers:
            raise ValueError(f"{len(rings)} rings for {num_tiers} tiers")
        fold(acc, rings, la, ihist, slots, keeps, packed, epoch, ifirst,
             **kw)
        out = [acc, rings]
        if track_activity:
            out.append(la)
        if track_baseline:
            out.append(ihist)
        return tuple(out)

    return commit


def _snapshot_step_fn(fold, num_tiers: int, bucket_limit: int,
                      precision: int, track_activity: bool,
                      track_baseline: bool, acc_payload: bool):
    """The final-chunk step over ``fold`` (``_step_fn``'s): the fold,
    then each tier's ``window_snapshot`` (one K5) and, when
    ``acc_payload``, ``dense_cdf`` of the accumulator (else None), and
    the EWMA bank update from the completed ``ihist``:
    ``commit(acc, rings, [last_active], [ihist], [banks], slots, keeps,
    packed, [epoch], masks, [ifirst, bank, decay, min_count], **kw) ->
    (acc, rings, [last_active], [ihist], [banks], tier_payloads,
    acc_payload)``."""
    if track_baseline:
        # deferred: ops.anomaly imports ops.lifecycle, which imports this
        from loghisto_tpu_torch.ops.anomaly import ewma_bank_update

    def commit(*args, **kw):
        it = iter(args)
        acc, rings = next(it), tuple(next(it))
        la = next(it) if track_activity else None
        ihist = next(it) if track_baseline else None
        banks = next(it) if track_baseline else None
        slots, keeps, packed = next(it), next(it), next(it)
        epoch = next(it) if track_activity else None
        masks = next(it)
        if track_baseline:
            ifirst, bank, decay, min_count = (next(it), next(it), next(it),
                                              next(it))
        else:
            ifirst = None
        if len(rings) != num_tiers:
            raise ValueError(f"{len(rings)} rings for {num_tiers} tiers")
        fold(acc, rings, la, ihist, slots, keeps, packed, epoch, ifirst,
             **kw)
        payloads = tuple(
            window_snapshot(ring, masks[t], bucket_limit, precision)
            for t, ring in enumerate(rings)
        )
        out = [acc, rings]
        if track_activity:
            out.append(la)
        if track_baseline:
            out.append(ihist)
            out.append(ewma_bank_update(banks, ihist, bank, decay,
                                        min_count))
        out.extend((payloads, dense_cdf(acc, bucket_limit, precision)
                    if acc_payload else None))
        return tuple(out)

    return commit


def make_fused_commit_fn(
    num_tiers: int,
    bucket_limit: int,
    track_activity: bool = False,
    track_baseline: bool = False,
):
    """The fused commit step for ``num_tiers`` tiers:
    ``commit(acc, rings, [last_active], [ihist], slots, keeps, packed,
    [epoch], [ifirst]) -> (acc, rings, [last_active], [ihist])``

      acc          int32 [M, B]             accumulator (in place)
      rings        sequence of int32 [S_t, M_t, B] tier rings (in place)
      last_active  int32 [M]                activity epochs (in place)
      ihist        int32 [M, B]             interval histogram (in place)
      slots, keeps host ints per tier       open slot; 0 clears it first
      packed       int32 [n, 3]             (id, codec bucket, count)
      epoch        host int                 stamped on the touched rows
      ifirst       host int                 0 on the interval's first
                                            chunk (clears ihist), else 1

    The reference's step is one program that lands whole or not at all;
    this one is a sequence of launches.  ``landed``, when given, is
    called once the chunk sits in the accumulator (right after the K3
    launch, before the activity stamp and any snapshot work), so a
    caller can tell a failure after that point from one before it.
    """

    def fold(*carries, landed=None):
        _fold_chunk(*carries, bucket_limit, landed)

    return _step_fn(fold, num_tiers, track_activity, track_baseline)


def make_fused_commit_snapshot_fn(
    num_tiers: int,
    bucket_limit: int,
    precision: int = PRECISION,
    track_activity: bool = False,
    track_baseline: bool = False,
):
    """The final-chunk variant: the same fold, then the snapshot
    payloads.  ``commit(acc, rings, [last_active], [ihist], [banks],
    slots, keeps, packed, [epoch], masks, [ifirst, bank, decay,
    min_count]) -> (acc, rings, [last_active], [ihist], [banks],
    tier_payloads, acc_payload)``

    ``masks`` holds one host bool ``[V, S_t]`` array per tier (the
    post-close trailing-window masks); each payload is
    ``window_snapshot``'s cdf/counts/sums over the V views, and
    ``acc_payload`` is ``dense_cdf`` of the accumulator.  ``banks`` is
    ``(prof f32 [K, M, B], wsum f32 [K, M])``, updated in place from the
    completed ``ihist`` (``ewma_bank_update``).  ``landed`` is
    ``make_fused_commit_fn``'s."""

    def fold(*carries, landed=None):
        _fold_chunk(*carries, bucket_limit, landed)

    return _snapshot_step_fn(fold, num_tiers, bucket_limit, precision,
                             track_activity, track_baseline, True)


def _sharded_fold(mesh, acc, rings, last_active, ihist, slots, keeps,
                  packed, epoch, ifirst, bucket_limit, landed, gathered):
    """One chunk of a mesh rank (in place): the stream row shares
    gathered, the ring-wrap clears (and, on the interval's first chunk,
    ``ihist``'s), then the rank's own share into its accumulator block,
    the gathered chunk into its block of every tier's open slot and of
    ``ihist`` (acc layout, as the reference's psum'd delta), and the
    activity stamp.  K3 takes every target that shares one triple array
    in one launch: the accumulator and ``ihist`` share the gathered
    chunk where the stream axis is 1 (the share is the chunk), and the
    ring blocks join them where they cover the same rows.  ``landed()``
    runs once the share sits in the accumulator; ``gathered(whole)``
    once the chunk's ``all_gather`` returned."""
    whole = gather_triples(mesh, packed)
    if gathered is not None:
        gathered(whole)
    m = axis_index(mesh, METRIC_AXIS)
    views = []
    for ring, slot, keep in zip(rings, slots, keeps):
        view = ring[int(slot)]
        if int(keep) != 1:
            view.mul_(int(keep))  # ring wrap: clear the slot's old life
        views.append(view)
    if ihist is not None and int(ifirst) == 0:
        ihist.zero_()  # the interval's first chunk: x ifirst = 0
    rows = acc.shape[0]
    # the wheel's tiers all have its rows; the accumulator may have more
    ring_rows = views[0].shape[0] if views else rows
    acc_block = block_triples(whole, m * rows, rows)
    # (targets, triples), the accumulator's first; ``gathered`` is the
    # launch on the gathered chunk in the accumulator's layout
    if axis_size(mesh, STREAM_AXIS) == 1:
        gathered_launch = ([acc], acc_block)
        launches = [gathered_launch]
    else:
        gathered_launch = ([], acc_block)
        launches = [([acc], block_triples(packed, m * rows, rows)),
                    gathered_launch]
    if ihist is not None:
        gathered_launch[0].append(ihist)
    if ring_rows == rows:
        gathered_launch[0].extend(views)
    elif views:
        launches.append((views, block_triples(whole, m * ring_rows,
                                              ring_rows)))
    for k, (targets, triples) in enumerate(launches):
        if targets:
            sparse_ingest_multi(targets, triples, bucket_limit)
        if k == 0 and landed is not None:
            landed()
    if last_active is not None:
        # the ids of the gathered chunk in the accumulator block's rows,
        # at any weight (the reference's psum'd touch markers)
        stamp_activity(last_active, acc_block[:, 0], epoch)


def make_sharded_fused_commit_fn(
    mesh,
    num_tiers: int,
    bucket_limit: int,
    track_activity: bool = False,
    track_baseline: bool = False,
):
    """``make_fused_commit_fn`` for one rank of a ("stream", "metric")
    mesh, with its operands: ``acc`` is the rank's ``[M / n_metric, B]``
    block (its stream row's partial), each ring its ``[S_t, M_t /
    n_metric, B]`` block, ``last_active`` its ``[M / n_metric]`` block
    and ``ihist`` its ``[M / n_metric, B]`` block (both the same on
    every rank of a metric column: they take the gathered chunk), and
    ``packed`` its stream row's share of the chunk (int32 ``[chunk /
    n_stream, 3]``, global ids, pad rows id -1).  A collective of the
    rank's stream line: every rank of it calls the step once per chunk,
    in the same order.  ``landed`` runs once the share sits in the
    accumulator, ``gathered(whole)`` once the chunk's ``all_gather``
    returned (a failing rank still owes its peers the later chunks'
    gathers)."""

    def fold(*carries, landed=None, gathered=None):
        _sharded_fold(mesh, *carries, bucket_limit, landed, gathered)

    return _step_fn(fold, num_tiers, track_activity, track_baseline)


def make_sharded_fused_commit_snapshot_fn(
    mesh,
    num_tiers: int,
    bucket_limit: int,
    precision: int = PRECISION,
    track_activity: bool = False,
    track_baseline: bool = False,
):
    """The final-chunk variant of ``make_sharded_fused_commit_fn``, with
    ``make_fused_commit_snapshot_fn``'s operands and results: each tier
    payload is ``window_snapshot`` (one K5) over the rank's ring block,
    row-sharded as the reference's, and ``banks`` is the rank's block
    ``(prof f32 [K, M / n_metric, B], wsum f32 [K, M / n_metric])``.
    ``acc_payload`` is None: the rank's accumulator is its stream row's
    partial, whose CDF is not the interval's (``collect()`` reduces it),
    so no accumulator snapshot is published on a mesh."""

    def fold(*carries, landed=None, gathered=None):
        _sharded_fold(mesh, *carries, bucket_limit, landed, gathered)

    return _snapshot_step_fn(fold, num_tiers, bucket_limit, precision,
                             track_activity, track_baseline, False)


def make_paged_fused_commit_fn(num_tiers: int, bucket_limit: int,
                               track_activity: bool = False):
    """The fused commit step for a paged aggregator:
    ``commit(pool, rings, [last_active], slots, keeps, packed, triples,
    [epoch]) -> (pool, rings, [last_active])``.  ``pool`` (int32 [P,
    page_size]) takes the accumulator's place and the chunk's translated
    ``triples`` (int32 [n, 3] ``(slot, offset, count)``, slots <= 0
    drop) go into it with one K4 launch; ``packed`` then goes into every
    tier's open slot with one K3 launch, and the activity stamp follows.
    The other operands are ``make_fused_commit_fn``'s; ``landed`` runs
    right after the K4 launch, once the chunk sits in the pool.  On a
    mesh ``packed`` holds the cells of the rank's ring blocks and
    ``stamp`` the chunk's ids in the aggregator's block (block-local; -1
    elsewhere), which the activity block takes (ROADMAP D13)."""

    def commit(*args, landed=None, stamp=None):
        it = iter(args)
        pool, rings = next(it), tuple(next(it))
        la = next(it) if track_activity else None
        slots, keeps, packed, triples = next(it), next(it), next(it), next(it)
        epoch = next(it) if track_activity else None
        if len(rings) != num_tiers:
            raise ValueError(f"{len(rings)} rings for {num_tiers} tiers")
        paged_scatter(pool, triples)
        if landed is not None:
            landed()
        _fold_chunk(None, rings, la, None, slots, keeps, packed, epoch,
                    None, bucket_limit, stamp=stamp)
        out = [pool, rings]
        if track_activity:
            out.append(la)
        return tuple(out)

    return commit


def make_paged_fused_commit_snapshot_fn(
    num_tiers: int,
    bucket_limit: int,
    precision: int = PRECISION,
    track_activity: bool = False,
):
    """The final-chunk variant of ``make_paged_fused_commit_fn``: the
    same step, then every tier's window payload (one K5 a tier).  No
    accumulator payload: the pool's counts are served by
    ``PagedStore.query``.  ``commit(pool, rings, [last_active], slots,
    keeps, packed, triples, [epoch], masks) -> (pool, rings,
    [last_active], tier_payloads)``."""
    step = make_paged_fused_commit_fn(num_tiers, bucket_limit,
                                      track_activity)

    def commit(*args, landed=None, stamp=None):
        *args, masks = args
        out = step(*args, landed=landed, stamp=stamp)
        payloads = tuple(
            window_snapshot(ring, masks[t], bucket_limit, precision)
            for t, ring in enumerate(out[1])
        )
        return (*out, payloads)

    return commit


class CellStagingRing:
    """Depth-D reusable host staging for the commit's cell triples.

    ``stage()`` writes one chunk into the next slot's int32 ``[width, 3]``
    host buffer (pinned when the device is a card), issues its copy to
    the device with ``non_blocking=True`` and records an event behind it.
    A slot's buffer is rewritten only after its event has completed: at
    depth 2 the copy of chunk k+1 overlaps the kernels of chunk k, and a
    rewrite can never race a copy still reading the buffer.  Only the
    chunk's rows travel (the port compiles no fixed shape, so there is
    nothing to pad).  ``uploads`` and ``bytes_uploaded`` feed the
    committer's H2D gauges."""

    def __init__(self, depth: int = 2, width: int = COMMIT_CHUNK,
                 device=None):
        if depth < 2:
            raise ValueError("staging ring depth must be >= 2 (the "
                             "overlap contract needs one slot of slack)")
        self.depth = depth
        self.width = width
        self.device = resolve_device(device)
        pin = self.device.type == "cuda"
        self._slots = [
            torch.empty((width, 3), dtype=torch.int32, pin_memory=pin)
            for _ in range(depth)
        ]
        self._events: list = [None] * depth
        self._next = 0
        self.uploads = 0          # lifetime stage() calls
        self.bytes_uploaded = 0   # lifetime host->device bytes

    def _slot(self, n: int):
        """The next host slot's index and first ``n`` rows, once no copy
        reads it any more."""
        if n > self.width:
            raise ValueError(f"chunk of {n} cells exceeds staging width "
                             f"{self.width}")
        i = self._next
        self._next = (i + 1) % self.depth
        if self._events[i] is not None:
            self._events[i].synchronize()
            self._events[i] = None
        return i, self._slots[i][:n]

    def _send(self, i: int, host: torch.Tensor) -> torch.Tensor:
        """Start the upload of slot ``i``'s rows ``host``; returns the
        device rows."""
        if self.device.type == "cuda":
            dev = host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            self._events[i] = event
        else:
            # the CPU "upload" is a copy: the slot is rewritten while the
            # caller may still hold the tensor
            dev = host.clone()
        self.uploads += 1
        self.bytes_uploaded += host.shape[0] * 12
        return dev

    def stage(self, ids, buckets, weights) -> torch.Tensor:
        """Copy one chunk (ids, codec buckets, counts; len <= width) into
        the next host slot and start its upload; returns the device
        triples ``[n, 3]``."""
        i, host = self._slot(len(ids))
        buf = host.numpy()
        buf[:, 0] = ids
        buf[:, 1] = buckets
        buf[:, 2] = weights
        return self._send(i, host)


class PagedTripleRing(CellStagingRing):
    """``CellStagingRing``'s twin for the paged committer's translated
    ``(slot, offset, count)`` triples: the same depth, width and
    per-slot wait, since consecutive chunks' triples reuse its slots.
    A chunk travels as its rows only, so the reference's pad rows (slot
    -1, which K4 drops) are not needed."""

    def stage(self, triples: np.ndarray) -> torch.Tensor:
        """Copy one translated chunk (int32 [n, 3], n <= width) into the
        next host slot and start its upload; returns the device
        triples."""
        i, host = self._slot(len(triples))
        host.numpy()[:] = triples
        return self._send(i, host)
