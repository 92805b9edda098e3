"""The fused interval commit: one pass over an interval's cells for the
aggregator's accumulator and every retention tier's open slot
(counterpart of ``loghisto_tpu/ops/commit.py``: ``COMMIT_CHUNK``,
``DROP_ID``, ``make_fused_commit_fn``, ``make_fused_commit_snapshot_fn``,
their paged twins ``make_paged_fused_commit_fn`` and
``make_paged_fused_commit_snapshot_fn``, ``CellStagingRing``,
``PagedTripleRing``, and the sharded dense pair
``make_sharded_fused_commit_fn`` and
``make_sharded_fused_commit_snapshot_fn``; the sharded paged pair waits
for ROADMAP Queue 1 item 11c).

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
                epoch, ifirst, bucket_limit, landed=None):
    """One chunk into every carry (in place): the clears, then one K3
    launch for every target (the accumulator, when there is one, and
    each tier's open slot); ``landed()`` runs right after that launch,
    before the activity stamp."""
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
        stamp_activity(last_active, packed[:, 0], epoch)


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

    def commit(*args, landed=None):
        it = iter(args)
        acc, rings = next(it), tuple(next(it))
        la = next(it) if track_activity else None
        ihist = next(it) if track_baseline else None
        slots, keeps, packed = next(it), next(it), next(it)
        epoch = next(it) if track_activity else None
        ifirst = next(it) if track_baseline else None
        if len(rings) != num_tiers:
            raise ValueError(f"{len(rings)} rings for {num_tiers} tiers")
        _fold_chunk(acc, rings, la, ihist, slots, keeps, packed, epoch,
                    ifirst, bucket_limit, landed)
        out = [acc, rings]
        if track_activity:
            out.append(la)
        if track_baseline:
            out.append(ihist)
        return tuple(out)

    return commit


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
    if track_baseline:
        # deferred: ops.anomaly imports ops.lifecycle, which imports this
        from loghisto_tpu_torch.ops.anomaly import ewma_bank_update

    def commit(*args, landed=None):
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
        _fold_chunk(acc, rings, la, ihist, slots, keeps, packed, epoch,
                    ifirst, bucket_limit, landed)
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
        out.extend((payloads, dense_cdf(acc, bucket_limit, precision)))
        return tuple(out)

    return commit


MESH_TRACKING = (
    "the lifecycle's activity carry and the drift engine's banks on a "
    "mesh wait for ROADMAP Queue 1 item 11b-2"
)


def _sharded_fold(mesh, acc, rings, slots, keeps, packed, bucket_limit,
                  landed, gathered):
    """One chunk of a mesh rank (in place): the stream row shares
    gathered, the ring-wrap clears, then the rank's own share into its
    accumulator block and the gathered chunk into its block of every
    tier's open slot.  Those are two K3 launches, or one where the
    stream axis is 1 (the gathered chunk is the share) and the blocks
    cover the same rows.  ``landed()`` runs once the share sits in the
    accumulator."""
    whole = gather_triples(mesh, packed)
    if gathered is not None:
        gathered()
    m = axis_index(mesh, METRIC_AXIS)
    views = []
    for ring, slot, keep in zip(rings, slots, keeps):
        view = ring[int(slot)]
        if int(keep) != 1:
            view.mul_(int(keep))  # ring wrap: clear the slot's old life
        views.append(view)
    rows = acc.shape[0]
    # the wheel's tiers all have its rows; the accumulator may have more
    ring_rows = views[0].shape[0] if views else rows
    if axis_size(mesh, STREAM_AXIS) == 1 and ring_rows == rows:
        sparse_ingest_multi([acc] + views,
                            block_triples(whole, m * rows, rows),
                            bucket_limit)
        if landed is not None:
            landed()
        return
    sparse_ingest_multi([acc], block_triples(packed, m * rows, rows),
                        bucket_limit)
    if landed is not None:
        landed()
    if views:
        sparse_ingest_multi(views,
                            block_triples(whole, m * ring_rows, ring_rows),
                            bucket_limit)


def make_sharded_fused_commit_fn(
    mesh,
    num_tiers: int,
    bucket_limit: int,
    track_activity: bool = False,
    track_baseline: bool = False,
):
    """``make_fused_commit_fn`` for one rank of a ("stream", "metric")
    mesh: ``commit(acc, rings, slots, keeps, packed) -> (acc, rings)``
    with the single-device operands, where ``acc`` is the rank's
    ``[M / n_metric, B]`` block (its stream row's partial), each ring
    its ``[S_t, M_t / n_metric, B]`` block, and ``packed`` its stream
    row's share of the chunk (int32 ``[chunk / n_stream, 3]``, global
    ids, pad rows id -1).  A collective of the rank's stream line: every
    rank of it calls the step once per chunk, in the same order.
    ``landed`` runs once the share sits in the accumulator, ``gathered``
    once the chunk's ``all_gather`` returned (a failing rank still owes
    its peers the later chunks' gathers).  The lifecycle and drift
    carries wait for 11b-2 (``MESH_TRACKING``)."""
    if track_activity or track_baseline:
        raise ValueError(f"sharded fused commit: {MESH_TRACKING}")

    def commit(acc, rings, slots, keeps, packed, *, landed=None,
               gathered=None):
        rings = tuple(rings)
        if len(rings) != num_tiers:
            raise ValueError(f"{len(rings)} rings for {num_tiers} tiers")
        _sharded_fold(mesh, acc, rings, slots, keeps, packed, bucket_limit,
                      landed, gathered)
        return acc, rings

    return commit


def make_sharded_fused_commit_snapshot_fn(
    mesh,
    num_tiers: int,
    bucket_limit: int,
    precision: int = PRECISION,
    track_activity: bool = False,
    track_baseline: bool = False,
):
    """The final-chunk variant of ``make_sharded_fused_commit_fn``:
    ``commit(acc, rings, slots, keeps, packed, masks) -> (acc, rings,
    tier_payloads, acc_payload)``.  Each tier payload is
    ``window_snapshot`` (one K5) over the rank's ring block, row-sharded
    as the reference's.  ``acc_payload`` is None: the rank's accumulator
    is its stream row's partial, whose CDF is not the interval's
    (``collect()`` reduces it), so no accumulator snapshot is
    published on a mesh."""
    step = make_sharded_fused_commit_fn(mesh, num_tiers, bucket_limit,
                                        track_activity, track_baseline)

    def commit(acc, rings, slots, keeps, packed, masks, *, landed=None,
               gathered=None):
        acc, rings = step(acc, rings, slots, keeps, packed, landed=landed,
                          gathered=gathered)
        payloads = tuple(
            window_snapshot(ring, masks[t], bucket_limit, precision)
            for t, ring in enumerate(rings)
        )
        return acc, rings, payloads, None

    return commit


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
    right after the K4 launch, once the chunk sits in the pool."""

    def commit(*args, landed=None):
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
                    None, bucket_limit)
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

    def commit(*args, landed=None):
        *args, masks = args
        out = step(*args, landed=landed)
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
