"""The ("stream", "metric") mesh over ``torch.distributed`` (counterpart
of ``loghisto_tpu/parallel/mesh.py``).

The *stream* axis shards the sample firehose: each stream row buckets
its own samples, valid because histograms are order-free and mergeable.
The *metric* axis shards the dense ``[num_metrics, num_buckets]``
accumulator rows.  Merges ride an int32 ``all_reduce`` over the stream
axis; percentile extraction runs row-parallel on the metric axis.

ROADMAP decision D8, the per-rank mesh.  JAX runs a mesh as ONE process
that drives many devices (SPMD under ``shard_map``); PyTorch's idiom is
one process per device.  So here every rank of the world is one device,
and the reference's names keep their contracts rank by rank:

  * ``make_mesh`` returns a ``DeviceMesh`` (``init_device_mesh`` with
    ``mesh_dim_names=("stream", "metric")``) over the ranks of the
    initialised process group (``parallel.multihost.initialize``); rank
    r sits at ``(r // metric, r % metric)``, row-major, and ranks past
    ``stream * metric`` stay outside the mesh, as the reference uses the
    first ``stream * metric`` devices.  Its device type is "cuda" unless
    the caller asks for "cpu".
  * The canonical shardings become ``RankPart``s: this rank's part of a
    carry.  Each sharded dimension splits into contiguous blocks, as
    ``NamedSharding`` lays them out, so rank (s, m) holds rows
    ``[m * M / n_metric, (m + 1) * M / n_metric)`` of ``acc_sharding``,
    bit for bit the rows JAX puts on the device at that position.
  * Sample arrays are "sharded over stream, replicated over metric": the
    ranks of stream row s all receive that row's samples and each keeps
    the ids of its own block (``block_ids``).

ROADMAP decision D9, the mesh's commit (Queue 1 item 11b-1).  Each stream
row has its own host interval: the ranks of row s commit the raw sets of
that row's samples, and the global interval is the union over the rows.
The reference's sharded commit sums dense shard-local deltas with one
``psum`` per chunk; a rank here ships the chunk's int32 triples instead
(``gather_triples``, an ``all_gather`` over the stream axis of equal
widths, padded with dropped rows), O(cells) rather than O(rows x B), and
keeps the ids of its block (``block_triples``).  Collectives run only at
collective entry points on a rank's main thread, never on a bridge: on a
mesh a bridge queues its intervals (``IntervalQueue``) and the entry
points (``IntervalCommitter.commit``, the system's ``backfill_retention``
and ``device_metrics()``, the wheel's queries) commit the queued
intervals first, in seq order, as many as every rank holds; ``stop()``
commits the most any rank holds, a rank short of it an empty interval
for each it lacks.

ROADMAP decision D10, lifecycle and drift on a mesh (item 11b-2).  The
reference moves sharded rows inside one program; here rows move between
the ranks of a metric line only where an eviction's victim and its
overflow target, or a survivor and its new position, lie in different
blocks: ``fold_rows`` sends one summed row per (rank, target) pair,
``RowMove`` the rows of a permutation that cross ranks, each in one
``all_to_all`` of the line, and each rank then runs the kernels (K6,
K7, K5) on its own blocks, as D8 runs K1.

ROADMAP decision D11, checkpoints and crash recovery on a mesh (item
11b-3).  A save gathers every carry to whole host arrays
(``host_gather`` by its ``RankPart``; the accumulator's stream partials
summed first), rank (0, 0) writes it, and one agreed status
(``agreed``) leaves every rank in the same state; a restore lays each
whole array out again as the rank's part (``global_put``), the
accumulator's rows on stream index 0 alone (``is_stream_lead``).  A
checkpoint's save gathers to rank (0, 0) alone (``first_only``): the
other ranks send their parts and receive nothing.

ROADMAP D12, paged storage on a mesh (item 11c-1).  Page maps and codec
choices follow whole batches, so a rank stages its stream row's input
and, at a collective entry point, every rank gathers each batch over
the stream axis (``gather_rows``, ragged) and translates it whole, as
the reference's one controller does; the committer gathers the rows'
intervals (``all_gather_objects``) and merges them.  Every rank then
holds the same host page table, and its pool is its metric shard's
arena (``pool_sharding``).

``collective_bytes`` counts the bytes of the inputs this rank hands to
the collectives of this module over lines of more than one rank, once a
call (what the backend's algorithm moves in all may differ); the rank
that receives a ``first_only`` gather or reduce counts nothing for it,
its part staying where it is.  ``reset_collective_bytes`` sets the
count to 0.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable, Optional

import numpy as np
import torch

STREAM_AXIS = "stream"
METRIC_AXIS = "metric"
AXES = (STREAM_AXIS, METRIC_AXIS)

_sent = [0]
_sent_lock = threading.Lock()


def collective_bytes() -> int:
    with _sent_lock:
        return _sent[0]


def reset_collective_bytes() -> None:
    with _sent_lock:
        _sent[0] = 0


def _count_sent(group, nbytes: int) -> None:
    import torch.distributed as dist

    if dist.get_world_size(group) > 1:
        with _sent_lock:
            _sent[0] += int(nbytes)


def _first_of(group) -> int:
    """The global rank at coordinate 0 of a line's group."""
    import torch.distributed as dist

    return dist.get_global_rank(group, 0)


def _off_first_lines(mesh, axes) -> bool:
    """Whether this rank is off index 0 of any axis not in ``axes``: it
    is on none of the lines through rank (0, 0) along ``axes``."""
    return any(axis_index(mesh, a) for a in AXES if a not in axes)


def axes_incapability(mesh) -> Optional[str]:
    """Why ``mesh`` is not a ("stream", "metric") mesh, or None (the
    reference's sentence of its mesh-shape edges)."""
    axes = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if axes != AXES:
        return (
            f"mesh shape: mesh axes {axes!r} are not the "
            f"('{STREAM_AXIS}', '{METRIC_AXIS}') layout"
        )
    return None


def check_mesh(mesh) -> None:
    """Raise ValueError unless ``mesh`` is a ("stream", "metric") mesh
    that holds this rank."""
    reason = axes_incapability(mesh)
    if reason is not None:
        raise ValueError(reason)
    if mesh.get_coordinate() is None:
        import torch.distributed as dist

        raise ValueError(
            f"rank {dist.get_rank()} is not in the {axis_size(mesh, STREAM_AXIS)}"
            f"x{axis_size(mesh, METRIC_AXIS)} mesh"
        )


def axis_size(mesh, axis: str) -> int:
    """The mesh's extent along ``axis`` (JAX: ``mesh.shape[axis]``)."""
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (JAX:
    ``jax.lax.axis_index``)."""
    return int(mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)])


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``: the ranks
    an ``all_reduce`` over that axis spans."""
    return mesh.get_group(axis)


def mesh_device(mesh) -> torch.device:
    """This rank's device: the current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def collective_device(group, device: torch.device) -> torch.device:
    """Where a collective's tensors must lie: NCCL takes card tensors,
    gloo reduces card tensors but gathers host ones, so anything but
    NCCL gets the host."""
    import torch.distributed as dist

    if dist.get_backend(group) == "nccl":
        return device
    return torch.device("cpu")


def block_rows(mesh, num_metrics: int) -> tuple[int, int]:
    """(first row, row count) of this rank's block of ``num_metrics``
    rows (``num_metrics`` divisible by the metric axis)."""
    rows = num_metrics // axis_size(mesh, METRIC_AXIS)
    return axis_index(mesh, METRIC_AXIS) * rows, rows


def block_ids(ids, lo: int, rows: int):
    """Ids in the block ``[lo, lo + rows)`` shifted to ``[0, rows)``,
    every other id -1, as the reference's ``sanitize_ids`` after the
    shard offset.  The first block (``lo == 0``) takes the ids as they
    are: every ingest step drops ids outside ``[0, rows)`` itself, so a
    1x1 mesh pays nothing.  Works on int32 tensors and NumPy arrays."""
    if lo == 0:
        return ids
    keep = (ids >= lo) & (ids < lo + rows)
    if isinstance(ids, np.ndarray):
        return np.where(keep, ids - lo, -1).astype(np.int32)
    return torch.where(keep, ids - lo, torch.full_like(ids, -1))


def mesh_reduce(mesh, values, op, axes=AXES) -> list:
    """Small int64 ``values`` reduced with ``op`` (a ``ReduceOp``) over
    ``axes`` in turn: over both, the whole mesh (and no rank outside a
    smaller one).  A collective of every rank of the mesh."""
    import torch.distributed as dist

    t = torch.tensor(values, dtype=torch.int64)
    for axis in axes:
        group = axis_group(mesh, axis)
        t = t.to(collective_device(group, mesh_device(mesh)))
        _count_sent(group, t.numel() * t.element_size())
        dist.all_reduce(t, op=op, group=group)
    return t.cpu().tolist()


def gather_parts(mesh, part: torch.Tensor, axis: str = METRIC_AXIS,
                 dim: int = 0, first_only: bool = False):
    """The parts of every rank of this rank's line along ``axis`` (equal
    shapes), concatenated on ``dim`` in coordinate order, on the
    collective's device.  A collective of that line.  With
    ``first_only`` one ``gather`` to the line's rank at index 0, which
    alone returns the parts; the others return None."""
    import torch.distributed as dist

    group = axis_group(mesh, axis)
    part = part.to(collective_device(group, part.device)).contiguous()
    n = axis_size(mesh, axis)
    first = axis_index(mesh, axis) == 0
    if not (first_only and first):
        _count_sent(group, part.numel() * part.element_size())
    if not first_only:
        parts = [torch.empty_like(part) for _ in range(n)]
        dist.all_gather(parts, part, group=group)
        return torch.cat(parts, dim=dim)
    parts = [torch.empty_like(part) for _ in range(n)] if first else None
    dist.gather(part, parts, dst=_first_of(group), group=group)
    return torch.cat(parts, dim=dim) if first else None


def reduce_parts(mesh, part: torch.Tensor, axis: str = METRIC_AXIS,
                 first_only: bool = False):
    """The elementwise sum of ``part`` over the ranks of this rank's line
    along ``axis`` (equal shapes), on ``part``'s device.  A collective of
    that line.  With ``first_only`` one ``reduce`` to the line's rank at
    index 0, which alone returns the sum; the others return None."""
    import torch.distributed as dist

    group = axis_group(mesh, axis)
    out = part.to(collective_device(group, part.device)).contiguous()
    if out is part:
        out = out.clone()
    first = axis_index(mesh, axis) == 0
    if not (first_only and first):
        _count_sent(group, out.numel() * out.element_size())
    if not first_only:
        dist.all_reduce(out, group=group)
        return out.to(part.device)
    dist.reduce(out, dst=_first_of(group), group=group)
    return out.to(part.device) if first else None


def host_gather(part: torch.Tensor, sharding: "RankPart",
                first_only: bool = False):
    """The whole array as a host NumPy copy, from every rank's part: one
    ``all_gather`` per sharded dimension, over its axis.  A collective:
    every rank of the mesh calls it.  With ``first_only`` rank (0, 0)
    alone receives it and the others return None: one ``gather`` per
    sharded dimension along the lines through rank (0, 0), which the
    ranks off those lines skip."""
    mesh = sharding.mesh
    if first_only and _off_first_lines(mesh, sharding.spec):
        return None
    arr = part
    for dim, axis in enumerate(sharding.spec):
        if axis is not None:
            arr = gather_parts(mesh, arr, axis, dim, first_only)
            if arr is None:
                return None
    return arr.cpu().numpy()


def global_put(host, sharding: "RankPart") -> torch.Tensor:
    """This rank's part of a host array, on its device.  Every rank
    passes the SAME host value (identical host tables, no
    coordination), so placing it takes no collective."""
    host = np.asarray(host)
    part = np.ascontiguousarray(host[sharding.index(host.shape)])
    return torch.from_numpy(part).to(sharding.device)


def is_stream_lead(mesh) -> bool:
    """Whether this rank is at stream index 0: the rank of its metric
    column that takes a whole restored stream partial (ROADMAP D11), so
    the sum over the stream axis counts it once."""
    return axis_index(mesh, STREAM_AXIS) == 0


def is_first_rank(mesh) -> bool:
    """Whether this rank is rank (0, 0), the one that writes a
    checkpoint (ROADMAP D11)."""
    return not any(axis_index(mesh, axis) for axis in AXES)


def agreed(mesh, ok: bool) -> bool:
    """True on every rank when ``ok`` is True on every rank: one MIN over
    the mesh, so one rank's failure leaves every rank in the same state.
    A collective of every rank of the mesh."""
    import torch.distributed as dist

    return bool(mesh_reduce(mesh, [int(bool(ok))], dist.ReduceOp.MIN)[0])


def gather_objects(mesh, obj, axis: str = STREAM_AXIS):
    """``obj`` (any picklable host value) of every rank of the line along
    ``axis`` through rank (0, 0), in coordinate order, on rank (0, 0);
    every other rank returns None, and the ranks off that line make no
    call.  One ``gather_object``, a collective of that line."""
    import pickle

    import torch.distributed as dist

    if _off_first_lines(mesh, (axis,)):
        return None
    group = axis_group(mesh, axis)
    first = axis_index(mesh, axis) == 0
    if not first:
        _count_sent(group, len(pickle.dumps(obj)))
    out = [None] * axis_size(mesh, axis) if first else None
    dist.gather_object(obj, out, dst=_first_of(group), group=group)
    return out


def gather_rows(mesh, rows: np.ndarray, axis: str = METRIC_AXIS,
                first_only: bool = False):
    """The host ``rows`` (dim 0 of any length; the same trailing shape and
    dtype on every rank) of every rank of this rank's line along
    ``axis``, concatenated in coordinate order, on the host: the lengths
    gathered, each part padded to the longest, then one ``all_gather``.
    Two collectives of that line (one when every part is empty).  With
    ``first_only`` the rows go to rank (0, 0) alone (the data's
    collective a ``gather``): the ranks off its line along ``axis`` make
    no call, and every rank but rank (0, 0) returns None."""
    if first_only and _off_first_lines(mesh, (axis,)):
        return None
    rows = np.ascontiguousarray(rows)
    dev = mesh_device(mesh)
    lens = gather_parts(mesh, torch.tensor([len(rows)], dtype=torch.int64,
                                           device=dev), axis).cpu().numpy()
    width = int(lens.max())
    if first_only and axis_index(mesh, axis) and not width:
        return None
    out = rows[:0].copy()
    if width:
        part = np.zeros((width, *rows.shape[1:]), dtype=rows.dtype)
        part[:len(rows)] = rows
        whole = gather_parts(mesh, torch.from_numpy(part).to(dev), axis,
                             first_only=first_only)
        if whole is None:
            return None
        whole = whole.cpu().numpy()
        out = np.concatenate([whole[k * width:k * width + int(n)]
                              for k, n in enumerate(lens)])
    return out


def all_gather_objects(mesh, obj, axis: str = STREAM_AXIS) -> list:
    """``obj`` (any picklable host value) of every rank of this rank's
    line along ``axis``, in coordinate order, on every rank of it.  One
    ``all_gather_object``, a collective of that line."""
    import pickle

    import torch.distributed as dist

    group = axis_group(mesh, axis)
    _count_sent(group, len(pickle.dumps(obj)))
    out = [None] * axis_size(mesh, axis)
    dist.all_gather_object(out, obj, group=group)
    return out


def pad_triples(packed: np.ndarray, rows: int) -> np.ndarray:
    """int32 ``packed`` [n, 3] (n <= rows) padded to ``rows`` rows with
    (-1, 0, 0), a row every scatter drops: the equal widths an
    ``all_gather`` needs."""
    out = np.zeros((rows, 3), dtype=np.int32)
    out[len(packed):, 0] = -1
    out[:len(packed)] = packed
    return out


def gather_triples(mesh, packed: torch.Tensor,
                   axis: str = STREAM_AXIS) -> torch.Tensor:
    """The int32 [W, 3] triples of every rank of this rank's line along
    ``axis`` (equal W), concatenated in coordinate order on this rank's
    device: on the card under NCCL, through the host under gloo.  A
    collective of that line."""
    return gather_parts(mesh, packed.to(mesh_device(mesh)), axis).to(
        mesh_device(mesh))


def ragged_gather_triples(mesh, packed: Optional[np.ndarray],
                          axis: str = STREAM_AXIS) -> Optional[torch.Tensor]:
    """``gather_triples`` of host triples of any length (None is none):
    the ranks agree on the longest (MAX over the line), each pads to it,
    and the gathered triples come back on this rank's device, or None
    when every rank had none.  Two collectives of that line."""
    import torch.distributed as dist

    n = 0 if packed is None else len(packed)
    width = mesh_reduce(mesh, [n], dist.ReduceOp.MAX, (axis,))[0]
    if width == 0:
        return None
    part = pad_triples(np.empty((0, 3), np.int32) if packed is None
                       else packed, width)
    return gather_triples(mesh, torch.from_numpy(part), axis)


def block_triples(packed: torch.Tensor, lo: int, rows: int) -> torch.Tensor:
    """Triples with their ids moved into the block ``[lo, lo + rows)``
    (``block_ids``: ids outside it become -1, which K3 drops); the first
    block takes them as they are, since K3 drops ids past a target's
    rows itself."""
    if lo == 0:
        return packed
    out = packed.clone()
    out[:, 0] = block_ids(packed[:, 0], lo, rows)
    return out


class IntervalQueue:
    """D9's bridge side on a mesh: the bridge thread ``put``s each
    broadcast interval, and ``drain()``, run at a collective entry point
    on the main thread, applies the queued intervals in order.  The
    ranks first agree on how many (MIN over the mesh), so every rank
    commits the same intervals in the same order and a later drain takes
    the rest.  The last drain (``final=True``, at ``stop()``) takes the
    MOST any rank holds instead: a rank with fewer applies ``pad()`` (an
    empty interval) in place of each missing one, so no rank's queued
    interval is left behind and every rank makes the same collectives;
    ``padded`` counts them, and each pad carries the seq its peers
    commit in its place (one more MAX over the mesh), so the ranks'
    checkpoint watermarks stay one seq (ROADMAP D11).  A drain started while one runs (a rule's
    query inside an interval's hooks) returns at once.  The queue has no
    bound: an interval waits here, on the host and not yet queryable,
    until the rank's next collective call (``len()`` is its depth)."""

    def __init__(self, mesh, apply: Callable, pad: Callable):
        self.mesh = mesh
        self._apply = apply
        self._pad = pad
        self._queue: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._draining = False
        self.padded = 0

    def put(self, item) -> None:
        with self._lock:
            self._queue.append(item)

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)

    def drain(self, final: bool = False) -> int:
        """Apply the intervals every rank holds (with ``final``, the most
        any rank holds, padded); returns how many.  A collective of every
        rank of the mesh."""
        import torch.distributed as dist

        if self._draining:
            return 0
        op = dist.ReduceOp.MAX if final else dist.ReduceOp.MIN
        n = mesh_reduce(self.mesh, [len(self)], op)[0]
        seqs = None
        if final and n:
            # a pad carries the seq its peers commit (their latest), so
            # every rank's watermark names the same interval (D11)
            with self._lock:
                mine = [getattr(item, "seq", None) for item in self._queue]
            mine = [-1 if q is None else int(q) for q in mine[:n]]
            seqs = mesh_reduce(self.mesh, mine + [-1] * (n - len(mine)),
                               dist.ReduceOp.MAX)
        self._draining = True
        try:
            for i in range(n):
                with self._lock:
                    item = self._queue.popleft() if self._queue else None
                if item is None:
                    item = self._pad()
                    if seqs is not None and seqs[i] >= 0:
                        item.seq = seqs[i]
                    self.padded += 1
                self._apply(item)
        finally:
            self._draining = False
        return n


def _all_to_all_rows(mesh, rows: torch.Tensor, send_counts, recv_counts,
                     device: torch.device) -> torch.Tensor:
    """Rows (dim 0) of ``rows`` sent to the ranks of this rank's metric
    line in ``send_counts`` (coordinate order), ``recv_counts`` received
    from each; the received rows, on ``device``.  One ``all_to_all`` of
    the line (through the host under gloo)."""
    import torch.distributed as dist

    group = axis_group(mesh, METRIC_AXIS)
    cdev = collective_device(group, device)
    rows = rows.to(cdev).contiguous()
    _count_sent(group, rows.numel() * rows.element_size())
    out = torch.empty((int(sum(recv_counts)), *rows.shape[1:]),
                      dtype=rows.dtype, device=cdev)
    dist.all_to_all_single(out, rows, [int(c) for c in recv_counts],
                           [int(c) for c in send_counts], group=group)
    return out.to(device)


class RowMove:
    """A row permutation of a carry laid out in row blocks over this
    rank's metric line (ROADMAP D10): ``perm[new] = old`` over global
    rows, the old rows in blocks of ``src_rows`` a rank, the new ones in
    blocks of ``dst_rows`` (an entry outside the old rows is an empty
    row).  Every rank of the line builds the same plan from the same
    ``perm``.  ``apply`` repacks the rank's block with the rows it keeps
    (``local``, the repack's permutation, where a row that comes from a
    peer is a hole), sends each row whose new position lies on another
    rank to that rank and writes the rows it receives into place: one
    ``all_to_all`` of the line with split sizes, made only when some row
    of the line crosses ranks, so only crossing rows travel."""

    def __init__(self, mesh, perm, src_rows: int, dst_rows: int):
        self.mesh = mesh
        n = axis_size(mesh, METRIC_AXIS)
        me = axis_index(mesh, METRIC_AXIS)
        full = np.full(n * dst_rows, -1, dtype=np.int64)
        perm = np.asarray(perm, dtype=np.int64)[:n * dst_rows]
        full[:len(perm)] = perm
        g = np.arange(n * dst_rows)
        ok = (full >= 0) & (full < n * src_rows)
        src = np.where(ok, full // src_rows, -1)
        dst = g // dst_rows
        lo_s, lo_d = me * src_rows, me * dst_rows
        keep = ok & (dst == me) & (src == me)
        self.local = np.full(dst_rows, -1, dtype=np.int32)
        self.local[g[keep] - lo_d] = full[keep] - lo_s
        # in order of new position, so grouped by destination rank
        send = ok & (src == me) & (dst != me)
        self.send_idx = full[send] - lo_s
        self.send_counts = np.bincount(dst[send], minlength=n)
        # grouped by source rank, each group in order of new position
        recv = ok & (dst == me) & (src != me)
        order = np.lexsort((g[recv], src[recv]))
        self.recv_pos = (g[recv] - lo_d)[order]
        self.recv_counts = np.bincount(src[recv], minlength=n)
        self.crossing = int((ok & (src != dst)).sum())  # the whole line's
        self.bytes_sent = 0

    def apply(self, block: torch.Tensor, dim: int, repack,
              lead=None) -> torch.Tensor:
        """``block``'s new block: ``repack(block, local)`` (a fresh
        tensor of ``dst_rows`` rows on ``dim``), then the rows from the
        peers written in.  ``lead``, for a ``dim`` of 1, names the
        entries of dim 0 whose crossing rows travel (every other entry
        is zero on every rank of the line, as an unwritten ring slot
        is).  A collective of the line when ``crossing``."""
        dev = block.device
        out = repack(block, torch.from_numpy(self.local).to(dev))
        if not self.crossing or (lead is not None and not len(lead)):
            return out
        src = block
        if lead is not None:
            src = block.index_select(0, torch.as_tensor(
                np.asarray(lead, dtype=np.int64), device=dev))
        rows = src.index_select(dim, torch.from_numpy(self.send_idx)
                                .to(dev)).movedim(dim, 0)
        got = _all_to_all_rows(self.mesh, rows, self.send_counts,
                               self.recv_counts, dev).movedim(0, dim)
        self.bytes_sent += rows.numel() * rows.element_size()
        pos = torch.from_numpy(self.recv_pos).to(dev)
        if lead is None:
            out.index_copy_(dim, pos, got)
        else:
            for j, s in enumerate(np.asarray(lead, dtype=np.int64).tolist()):
                out[s].index_copy_(dim - 1, pos, got[j])
        return out


def fold_rows(mesh, block: torch.Tensor, dim: int, victims, targets,
              rows: int) -> int:
    """The eviction fold of a carry laid out in blocks of ``rows`` rows
    over this rank's metric line, in place on the rank's ``block``: each
    victim's row added into its target's row, then zeroed (global ids;
    a victim or target outside the rows drops, targets are never
    victims).  A rank sums the rows of its victims per target first, so
    one row per (rank, target) pair crosses: one ``all_to_all`` of the
    line, made only when a pair does.  Returns the bytes this rank
    sent."""
    n = axis_size(mesh, METRIC_AXIS)
    me = axis_index(mesh, METRIC_AXIS)
    lo, dev = me * rows, block.device
    v = np.asarray(victims, dtype=np.int64)
    t = np.asarray(targets, dtype=np.int64)
    v_ok = (v >= 0) & (v < n * rows)
    pair = v_ok & (t >= 0) & (t < n * rows)
    vq, tq = v // rows, t // rows
    mine = pair & (vq == me)
    tg, inv = np.unique(t[mine], return_inverse=True)
    sums = None
    if len(tg):
        shape = list(block.shape)
        shape[dim] = len(tg)
        sums = torch.zeros(shape, dtype=block.dtype, device=dev)
        sums.index_add_(dim, torch.from_numpy(inv.reshape(-1)).to(dev),
                        block.index_select(dim, torch.from_numpy(
                            v[mine] - lo).to(dev)))
        here = tg // rows == me
        block.index_add_(dim, torch.from_numpy(tg[here] - lo).to(dev),
                         sums.index_select(dim, torch.from_numpy(
                             np.flatnonzero(here)).to(dev)))
    sent = 0
    if (pair & (vq != tq)).any():  # the same answer on every rank
        there = np.flatnonzero(tg // rows != me)  # by target: by rank
        if sums is None:
            shape = list(block.shape)
            shape[dim] = 0
            sums = torch.zeros(shape, dtype=block.dtype, device=dev)
        out = sums.index_select(dim, torch.from_numpy(there).to(dev)
                                ).movedim(dim, 0)
        send_counts = np.bincount(tg[there] // rows, minlength=n)
        recv_pos, recv_counts = [], np.zeros(n, dtype=np.int64)
        for q in range(n):
            if q != me:
                got = np.unique(t[pair & (vq == q) & (tq == me)])
                recv_pos.append(got - lo)
                recv_counts[q] = len(got)
        got = _all_to_all_rows(mesh, out, send_counts, recv_counts, dev)
        block.index_add_(dim, torch.from_numpy(np.concatenate(recv_pos))
                         .to(dev), got.movedim(0, dim))
        sent = out.numel() * out.element_size()
    own = v_ok & (vq == me)
    block.index_fill_(dim, torch.from_numpy(v[own] - lo).to(dev), 0)
    return sent


@dataclasses.dataclass(frozen=True)
class RankPart:
    """This rank's part of a carry laid out over ``mesh``: ``spec`` names,
    per dimension, the mesh axis it splits over in contiguous blocks, or
    None (whole), as a ``PartitionSpec``."""

    mesh: object
    spec: tuple

    def index(self, shape) -> tuple:
        """The slices of this rank's part of an array of ``shape``."""
        out = []
        for dim, axis in enumerate(self.spec):
            if axis is None:
                out.append(slice(None))
                continue
            n = axis_size(self.mesh, axis)
            if shape[dim] % n:
                raise ValueError(
                    f"dimension {dim} ({shape[dim]}) does not split over "
                    f"the {n}-way {axis} axis"
                )
            size = shape[dim] // n
            k = axis_index(self.mesh, axis)
            out.append(slice(k * size, (k + 1) * size))
        return tuple(out)

    @property
    def device(self) -> torch.device:
        return mesh_device(self.mesh)


# -- canonical carry shardings ---------------------------------------------- #
# The reference's four (and its two paged) layouts, as this rank's part.

def row_vector_sharding(mesh) -> RankPart:
    """int32 [M] carries (the lifecycle activity vector)."""
    return RankPart(mesh, (METRIC_AXIS,))


def acc_sharding(mesh) -> RankPart:
    """[M, B] carries (accumulator, interval histogram)."""
    return RankPart(mesh, (METRIC_AXIS, None))


def ring_sharding(mesh) -> RankPart:
    """[S, M, B] / [K, M, B] carries (tier rings, baseline profiles)."""
    return RankPart(mesh, (None, METRIC_AXIS, None))


def bank_weight_sharding(mesh) -> RankPart:
    """f32 [K, M] carries (baseline bank weight mass)."""
    return RankPart(mesh, (None, METRIC_AXIS))


def cell_sharding(mesh) -> RankPart:
    """Staged interval cell chunks [N]: split over the stream axis."""
    return RankPart(mesh, (STREAM_AXIS,))


def pool_sharding(mesh) -> RankPart:
    """int32 [total_pages, page_size] page pools: one arena per metric
    shard."""
    return RankPart(mesh, (METRIC_AXIS, None))


def triple_sharding(mesh) -> RankPart:
    """Translated commit triples [N, 3]: split over the stream axis."""
    return RankPart(mesh, (STREAM_AXIS, None))


def make_mesh(
    stream: Optional[int] = None,
    metric: int = 1,
    device=None,
):
    """Build a ("stream", "metric") mesh over the ranks of the
    initialised process group (``parallel.multihost.initialize``), one
    device per rank.

    Defaults to every rank on the stream axis.  ``device`` is "cuda"
    (the default) or "cpu"; the card is never swapped for the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from loghisto_tpu_torch.ops.backend import resolve_device

    device_type = resolve_device(device).type
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group: call "
            "loghisto_tpu_torch.parallel.multihost.initialize first"
        )
    world = dist.get_world_size()
    if stream is None:
        if world % metric:
            raise ValueError(
                f"{world} devices not divisible by metric={metric}"
            )
        stream = world // metric
    n = stream * metric
    if n > world:
        raise ValueError(
            f"mesh {stream}x{metric} needs {n} devices, have {world}"
        )
    return init_device_mesh(device_type, (stream, metric),
                            mesh_dim_names=AXES)
