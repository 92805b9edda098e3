"""K8: the metric-tiled multirow ingest (counterpart of
``loghisto_tpu/ops/pallas_multirow.py``; renamed, as ``row_ingest.py``
was, because a PyTorch package has no Pallas).

``preprocess`` is the JAX module's layout step in PyTorch: bucket the
batch, group the samples by row block (``rows_tile`` consecutive rows)
with a STABLE sort, and lay them out so every ``sample_tile`` slots hold
samples of one block; block segments are padded to tile boundaries with
filler entries (row == ``rows_tile``), invalid ids park on the last
block as filler, and tiles past the used range route to the last block.
Its ``(rows, bidx, tile_block)`` equal the JAX layout bit for bit
wherever the two codecs agree (ROADMAP F1).

K8 (``csrc/multirow_ingest.cu``) computes what the Pallas ``_kernel``
computes, not how: for every layout entry j of tile t = j // sample_tile
with rows[j] < rows_tile, acc[tile_block[t] * rows_tile + rows[j],
bidx[j]] += 1.  The TPU kernel adds bf16 one-hot products on the MXU
into a block kept resident across its serial grid, and guards against a
stale aliased input block on a revisit; Hopper adds duplicates exactly
with int32 atomics in place, so neither survives.  A persistent grid of
clusters walks contiguous ranges of tiles: a cluster's longest piece of
a run of one row block, when the whole run spans K8_RUN_MIN tiles (so
many clusters add into the same rows), adds into a histogram held in
the cluster's distributed shared memory and flushed with one global
atomic a live cell; every other entry adds with its own global atomic.
``histogram_runs`` is that choice in NumPy.

Decision D7 (ROADMAP): the accumulator is the canonical int32 [M, B]
and ``finalize`` is the identity.  The JAX [M, H * 128] lane pad exists
only for the TPU's vector layout, and every other consumer of the
aggregator's accumulator (K3, the spill fold, ``collect``, the state,
the committer, K6) reads [M, B].

  * ``multirow_ingest_reference`` — the plain version of K8 (the layout
    accumulation).
  * ``multirow_ingest`` — the K8 wrapper: the kernel on CUDA tensors,
    the plain version on CPU tensors.
  * ``multirow_step`` — preprocess + K8 with the uniform
    ``f(acc, ids, values, bucket_limit, precision)`` contract (the
    aggregator's ``ingest_path="multirow"``).
  * ``multirow_ingest_batch`` — ``multirow_step`` under the JAX name.
  * ``make_multirow_ingest`` — the JAX factory's ``(init, ingest,
    finalize)``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from loghisto_tpu_torch.config import PRECISION
from loghisto_tpu_torch.ops.backend import is_plain, launch, resolve_device
from loghisto_tpu_torch.ops.dispatch import MULTIROW_ROWS_TILE as ROWS_TILE
from loghisto_tpu_torch.ops.fused_ingest import check_acc, check_samples
from loghisto_tpu_torch.ops.ingest import bucket_indices
from loghisto_tpu_torch.ops.row_ingest import SAMPLE_TILE


def check_rows_tile(num_metrics: int, rows_tile: int) -> None:
    if num_metrics % rows_tile:
        raise ValueError(
            f"num_metrics={num_metrics} must divide by rows_tile={rows_tile}"
        )


def preprocess(
    ids: torch.Tensor,
    values: torch.Tensor,
    num_metrics: int,
    rows_tile: int,
    bucket_limit: int,
    precision: int = PRECISION,
    sample_tile: int = SAMPLE_TILE,
):
    """Sort and block-pad one batch.  Returns int32 (layout_rows [G*T],
    layout_bidx [G*T], tile_block [G]) with G = ceil(N/T) + M/rows_tile:
    every tile's samples belong to one block; filler entries carry
    row == rows_tile."""
    n = ids.shape[0]
    t = sample_tile
    n_blocks = num_metrics // rows_tile
    g = (n + t - 1) // t + n_blocks
    dev = ids.device

    bidx = bucket_indices(values, bucket_limit, precision)
    ids = ids.long()
    valid = (ids >= 0) & (ids < num_metrics)
    block = torch.where(
        valid, torch.div(ids, rows_tile, rounding_mode="floor"), n_blocks - 1)
    row_in_block = torch.where(valid, ids - block * rows_tile, rows_tile)

    order = torch.sort(block, stable=True).indices
    sorted_block = block[order]

    counts = torch.bincount(sorted_block, minlength=n_blocks)
    tiles_per_block = (counts + t - 1) // t
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    start_tile = torch.cat([zero, torch.cumsum(tiles_per_block, 0)[:-1]])
    sample_start = torch.cat([zero, torch.cumsum(counts, 0)[:-1]])
    rank = torch.arange(n, device=dev) - sample_start[sorted_block]
    dest = start_tile[sorted_block] * t + rank

    layout_rows = torch.full((g * t,), rows_tile, dtype=torch.int32,
                             device=dev)
    layout_bidx = torch.zeros(g * t, dtype=torch.int32, device=dev)
    layout_rows[dest] = row_in_block[order].to(torch.int32)
    layout_bidx[dest] = bidx[order].to(torch.int32)

    tile_block = torch.searchsorted(
        start_tile, torch.arange(g, device=dev), right=True) - 1
    tile_block = torch.clamp(tile_block, 0, n_blocks - 1).to(torch.int32)
    return layout_rows, layout_bidx, tile_block


def check_layout(acc, rows, bidx, tile_block):
    """Validate a layout against ``acc``; returns it contiguous."""
    for name, t in (("rows", rows), ("bidx", bidx),
                    ("tile_block", tile_block)):
        if t.ndim != 1 or t.dtype != torch.int32:
            raise ValueError(f"{name} must be 1-D int32; got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != acc.device:
            raise ValueError(f"{name} on {t.device}, acc on {acc.device}")
    if rows.shape != bidx.shape:
        raise ValueError(
            f"rows and bidx must have one shape; got {tuple(rows.shape)} "
            f"and {tuple(bidx.shape)}")
    g = tile_block.shape[0]
    if rows.shape[0] != g * SAMPLE_TILE:
        raise ValueError(
            f"a layout of {g} tiles holds {g * SAMPLE_TILE} entries; got "
            f"{rows.shape[0]}")
    return rows.contiguous(), bidx.contiguous(), tile_block.contiguous()


# csrc/multirow_ingest.cu's kRunMin: a cluster's longest piece of a run
# takes the cluster histogram when the whole run of one row block holds
# K8_RUN_MIN tiles or more
K8_RUN_MIN = 32


def device_clusters(tiles: int, rows_tile: int, num_buckets: int,
                    device_index: int = 0):
    """(clusters, tiles a cluster, histogram fits) of a K8 launch over
    ``tiles`` tiles on CUDA device ``device_index``, from the kernel's own
    launch plan (``lh_multirow_clusters``)."""
    from loghisto_tpu_torch.ops import _build

    fn = _build.helper("multirow_ingest", "lh_multirow_clusters", [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)])
    fits = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        clusters = fn(tiles, rows_tile, num_buckets, ctypes.byref(fits))
    if clusters < 0:
        raise RuntimeError(f"lh_multirow_clusters failed: CUDA error "
                           f"{-clusters}")
    return clusters, -(-tiles // clusters), bool(fits.value)


def histogram_runs(tile_block: np.ndarray, clusters: int, span: int,
                   rows_tile: int, num_metrics: int, hist_fits: bool = True):
    """The tile runs [start, end) that K8 adds through its cluster
    histogram: in each cluster's range of ``span`` tiles, the first
    longest run of one tile_block value, where the whole run it belongs
    to (across the range's ends) holds K8_RUN_MIN tiles or more, the
    histogram fits and the run's row block lies inside acc (the kernel's
    own choice, in plain NumPy)."""
    tb = np.asarray(tile_block)
    out = []
    if not hist_fits:
        return out
    for c in range(clusters):
        ts, te = c * span, min(len(tb), (c + 1) * span)
        if ts >= te:
            continue
        part = tb[ts:te]
        starts = np.flatnonzero(np.r_[True, part[1:] != part[:-1]])
        lengths = np.diff(np.r_[starts, len(part)])
        k = int(np.argmax(lengths))
        a, e = ts + int(starts[k]), ts + int(starts[k] + lengths[k])
        blk = int(tb[a])
        left = tb[max(0, a - K8_RUN_MIN):a][::-1] != blk
        right = tb[e:e + K8_RUN_MIN] != blk
        whole = ((left.argmax() if left.any() else len(left)) + (e - a)
                 + (right.argmax() if right.any() else len(right)))
        if (whole >= K8_RUN_MIN and blk >= 0
                and (blk + 1) * rows_tile <= num_metrics):
            out.append((a, e))
    return out


def multirow_ingest_reference(acc, rows, bidx, tile_block, rows_tile):
    """Plain version of K8, in place: every entry with 0 <= rows < rows_tile
    adds 1 at (tile_block[tile] * rows_tile + rows, bidx); entries whose
    cell lies outside acc drop."""
    m, b = acc.shape
    rows = rows.long()
    bidx = bidx.long()
    row = tile_block.long().repeat_interleave(SAMPLE_TILE) * rows_tile + rows
    keep = ((rows >= 0) & (rows < rows_tile) & (row >= 0) & (row < m)
            & (bidx >= 0) & (bidx < b))
    flat = row[keep] * b + bidx[keep]
    acc.view(-1).index_put_(
        (flat,), torch.ones_like(flat, dtype=acc.dtype), accumulate=True)
    return acc


def multirow_ingest(
    acc: torch.Tensor,
    rows: torch.Tensor,
    bidx: torch.Tensor,
    tile_block: torch.Tensor,
    rows_tile: int = ROWS_TILE,
) -> torch.Tensor:
    """K8 wrapper: acc int32 [M, B] += the layout (``preprocess``), in
    place.  One kernel launch on CUDA tensors, the plain version on CPU
    tensors."""
    if acc.ndim != 2 or acc.dtype != torch.int32 or not acc.is_contiguous():
        raise ValueError(
            f"acc must be a contiguous int32 [M, B]; got {tuple(acc.shape)} "
            f"{acc.dtype}")
    check_rows_tile(acc.shape[0], rows_tile)
    rows, bidx, tile_block = check_layout(acc, rows, bidx, tile_block)
    if is_plain(acc, "multirow_ingest"):
        return multirow_ingest_reference(acc, rows, bidx, tile_block,
                                         rows_tile)
    # K8 reads 16 bytes at a time: a view that starts off a 16-byte line
    # is copied to one that does not
    rows, bidx = (t if t.data_ptr() % 16 == 0 else t.clone()
                  for t in (rows, bidx))
    n = rows.shape[0]
    if n:
        launch(
            "multirow_ingest", acc.data_ptr(), rows.data_ptr(),
            bidx.data_ptr(), tile_block.data_ptr(), n, SAMPLE_TILE,
            rows_tile, acc.shape[0], acc.shape[1],
        )
    return acc


def multirow_step(
    acc: torch.Tensor,
    ids: torch.Tensor,
    values: torch.Tensor,
    bucket_limit: int,
    precision: int = PRECISION,
    rows_tile: int = ROWS_TILE,
) -> torch.Tensor:
    """acc [M, B] += the batch through preprocess + K8, in place."""
    check_acc(acc, bucket_limit)
    check_rows_tile(acc.shape[0], rows_tile)
    ids, values = check_samples(acc, ids, values)
    rows, bidx, tile_block = preprocess(
        ids, values, acc.shape[0], rows_tile, bucket_limit, precision)
    return multirow_ingest(acc, rows, bidx, tile_block, rows_tile)


# the JAX module's name for the whole step (on CPU tensors it is the
# plain version: preprocess + multirow_ingest_reference)
multirow_ingest_batch = multirow_step


def make_multirow_ingest(
    num_metrics: int,
    bucket_limit: int,
    precision: int = PRECISION,
    rows_tile: int = ROWS_TILE,
    device=None,
):
    """Build (init, ingest, finalize) for the multirow path on ``device``
    (default the card), as the JAX factory does:

      init() -> acc int32 [num_metrics, 2*bucket_limit+1]
      ingest(acc, ids, values) -> acc     (in place, one K8 launch)
      finalize(acc) -> acc                (the identity: D7)
    """
    check_rows_tile(num_metrics, rows_tile)
    dev = resolve_device(device)
    num_buckets = 2 * bucket_limit + 1

    def init():
        return torch.zeros((num_metrics, num_buckets), dtype=torch.int32,
                           device=dev)

    def ingest(acc, ids, values):
        return multirow_step(
            acc, torch.as_tensor(ids, device=dev),
            torch.as_tensor(values, device=dev), bucket_limit, precision,
            rows_tile,
        )

    def finalize(acc):
        return acc

    return init, ingest, finalize
