"""Host side of paged bucket storage: page table, on-demand allocation,
variable-resolution codecs and the spill policy (counterpart of
``loghisto_tpu/paging.py``; its own copy — nothing is imported from the
JAX package).

``PagedStore`` is the storage="paged" backend behind ``TorchAggregator``.
It owns the device page pool (ops/paged_store.py), the host page table
and the per-row codec choices, and keeps the dense accumulator's
exactness contract: every count lands in a mapped page, the overflow
row, or the exact host spill — never silently dropped.

Codecs (dense, loglinear, polytail) are pairs of LUTs: encode maps a
native dense bucket index to a storage index, decode maps a storage
index back to its representative native index.  ``BucketCodec`` and the
three constructors are copied; their LUTs equal the JAX package's array
for array.

What differs from the JAX store, and why:

  * every per-row or per-pair Python loop of the JAX store is
    vectorized, because at a million live rows they are the interval:
    codec choice (``_assign_codecs``), page allocation (``_alloc_pairs``
    pops the free list in the same order as the JAX ``_alloc`` loop),
    the pool decode (``_decode_pool_cells``: one nonzero pass over the
    pool on its device, owners from the inverted page table) and
    ``sparse_cells_stats``;
  * the device mirrors of (row_codec, enc LUTs, page table) are updated
    in place for the rows and pages a batch newly assigned or mapped,
    instead of re-uploading the whole table (138 MB at 2^20 rows);
  * the free list is an int32 stack (``free_list()`` gives it as the
    JAX list), and the pool is zeroed in place.

``prepare_batch`` keeps the JAX store's +/-1-storage-bucket neighbour
mapping.  The port's device codec is float64 and agrees with the host
codec, so it does not need it for coverage; with it, the port's page
table and ``allocated_pages`` equal the JAX store's for the same stream.

The lifecycle's half (``fold_rows_into``, ``release_rows``,
``drop_rows``, ``apply_permutation``) keeps the JAX store's results: the
same pool, page table, codecs and free list.  Freed slots go onto the
top of the free stack in the JAX order (rows as given, pages
ascending), so the next allocation pops what the JAX list pops.  An
eviction gathers only the victims' pages on the device and decodes
those, where the JAX store decodes the whole pool; the triples it
re-commits are the same set.  Every table or codec change either marks
the rows and (row, page) pairs it touched for the K4f mirrors or drops
them (``apply_permutation``, ``_extract_rows``).

``max_cell``, ``codec_names`` and ``restore_codecs`` are the v3
checkpoint's surface (``utils/checkpoint.py``).

On a ("stream", "metric") mesh (``mesh=``, ROADMAP D12) the store is one
rank's part of the reference's one-controller store.  Metric shard k
owns the rows ``[k * rows_per_shard, (k + 1) * rows_per_shard)`` and the
global slots ``[k * shard_pages, (k + 1) * shard_pages)``, slot
``k * shard_pages`` its zero page, with one free stack per shard in the
JAX order; ``total_pages`` is ``n_metric * shard_pages`` and a row maps
pages from its own shard's arena only.  The host half is the reference
controller's, the same on every rank: the whole page table, ``row_codec``
and every shard's free stack, and every rank makes the same calls with
the same (global) arguments.  The pool tensor is the rank's arena,
``[shard_pages, page_size]`` with its zero page at local slot 0, the same
on every rank of a metric column and bit for bit the JAX pool's block of
that shard: ``commit`` translates the whole batch and lands the triples
of its arena, re-based to its slots (``_arena_triples``, one K4),
``ingest_raw`` the samples of its block (``block_ids``, one K4f; the K4f
mirrors hold the rank's block of ``row_codec`` and of the table, with
arena-local slots).  The kernels' wrappers are the single-device ones.
The host spill is kept per block: a rank holds the spilled cells of its
block's rows (its arena's fold at the int32 envelope, a failed launch's
triples and the translate spills of its rows), so what it reports is its
block.  Rows that change shard (``apply_permutation``, ``grow``) migrate:
the owning ranks extract their cells and spilled cells
(``_extract_rows``), one gather over the metric axis hands every rank
all of them, every rank makes the same host ``commit`` and lands its
arena's share.  The lifecycle's half on a mesh (ROADMAP D13):
``fold_rows_into`` gathers the victims' cells and spilled cells from
their owners' blocks over the metric axis, and every rank re-commits
them under the target's codec and lands its arena's share, the spilled
cells joining the target's block; ``drop_rows`` zeroes the rank's own
slots and purges its own block's spill; ``state`` gathers the arenas
and the blocks' spills into the whole store's state.  Those, the
migrations, ``decode_cells`` and ``query`` are collectives of the rank's
metric line; everything else needs no collective.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from loghisto_tpu_torch.config import PRECISION

CODEC_DENSE = "dense"
CODEC_LOGLINEAR = "loglinear"
CODEC_POLYTAIL = "polytail"


@dataclasses.dataclass(frozen=True)
class BucketCodec:
    """One storage layout: a pair of LUTs plus its error bound.

    enc_lut: int32 [B] — native dense index -> storage index.
    dec_lut: int32 [S] — storage index -> representative native dense
      index (injective, so decoding is an exact scatter).
    max_halfwidth: worst-case distance (native buckets) between a
      bucket and its chunk representative — 0 for the identity codec.
    """

    name: str
    enc_lut: np.ndarray
    dec_lut: np.ndarray
    max_halfwidth: int

    @property
    def storage_buckets(self) -> int:
        return len(self.dec_lut)

    def max_rel_error(self, precision: int = PRECISION) -> float:
        """|decode(encode(v)) - v| <= max_rel_error * (|v| + 1)."""
        if self.max_halfwidth == 0:
            return 0.0
        return math.exp((self.max_halfwidth + 0.5) / precision) - 1.0


def _codec_from_chunks(name: str, chunk_of: np.ndarray) -> BucketCodec:
    """Build a codec from a per-native-bucket chunk id array [B]: each
    chunk becomes one storage bucket represented by its center bucket."""
    chunks, enc = np.unique(chunk_of, return_inverse=True)
    enc = enc.astype(np.int32).reshape(-1)
    dec = np.zeros(len(chunks), dtype=np.int32)
    width = 0
    for s in range(len(chunks)):
        members = np.nonzero(enc == s)[0]
        dec[s] = members[(len(members) - 1) // 2]
        width = max(width, int(members[-1] - dec[s]), int(dec[s] - members[0]))
    return BucketCodec(
        name=name, enc_lut=enc, dec_lut=dec, max_halfwidth=width
    )


def dense_codec(num_buckets: int) -> BucketCodec:
    idx = np.arange(num_buckets, dtype=np.int32)
    return BucketCodec(
        name=CODEC_DENSE, enc_lut=idx, dec_lut=idx.copy(), max_halfwidth=0
    )


def loglinear_codec(bucket_limit: int, factor: int) -> BucketCodec:
    """Sign-mirrored coarsening: native bucket c chunks to
    sign(c) * (|c| // factor)."""
    if factor < 2:
        raise ValueError(f"loglinear factor must be >= 2, got {factor}")
    c = np.arange(-bucket_limit, bucket_limit + 1, dtype=np.int64)
    chunk = np.sign(c) * (np.abs(c) // factor)
    return _codec_from_chunks(CODEC_LOGLINEAR, chunk)


def polytail_codec(
    bucket_limit: int,
    body_halfwidth: int,
    tail_rel_error: float,
    precision: int = PRECISION,
) -> BucketCodec:
    """Exact body, quadratically growing tail chunks capped so the tail
    representative error stays <= tail_rel_error."""
    if not 0 < body_halfwidth < bucket_limit:
        raise ValueError(
            f"body_halfwidth must be in (0, {bucket_limit}); "
            f"got {body_halfwidth}"
        )
    if tail_rel_error <= 0:
        raise ValueError(f"tail_rel_error must be > 0, got {tail_rel_error}")
    cap = max(2, int(2 * (precision * math.log1p(tail_rel_error) - 0.5)))
    c = np.arange(-bucket_limit, bucket_limit + 1, dtype=np.int64)
    mag = np.abs(c)
    bounds = [body_halfwidth]
    k = 1
    while bounds[-1] < bucket_limit:
        bounds.append(bounds[-1] + min(cap, k * k))
        k += 1
    bounds = np.asarray(bounds, dtype=np.int64)
    tail_band = np.searchsorted(bounds, mag, side="left")
    chunk = np.where(
        mag <= body_halfwidth, c, np.sign(c) * (bucket_limit + tail_band)
    )
    return _codec_from_chunks(CODEC_POLYTAIL, chunk)


@dataclasses.dataclass(frozen=True)
class PagedStoreConfig:
    """Knobs of the paged backend (the JAX package's fields and
    defaults).

    pool_pages: pool capacity in pages (slot 0 is the zero page).
    codec: "auto" picks per row by first-touch occupancy; naming one of
      dense/loglinear/polytail pins every row.
    dense_page_budget: auto keeps a row on the exact dense codec while
      its occupied span fits this many pages.
    tail_occupancy: auto prefers polytail when at least this fraction of
      a row's first-touch buckets sit beyond body_halfwidth.
    overflow_row: row that takes cells no page can hold (its pages are
      reserved at construction); None sends them to the host spill.
    """

    page_size: int = 256
    pool_pages: int = 4096
    codec: str = "auto"
    loglinear_factor: int = 4
    body_halfwidth: int = 1024
    tail_rel_error: float = 0.10
    dense_page_budget: int = 4
    tail_occupancy: float = 0.5
    overflow_row: Optional[int] = None

    def __post_init__(self):
        if self.codec not in (
            "auto", CODEC_DENSE, CODEC_LOGLINEAR, CODEC_POLYTAIL
        ):
            raise ValueError(f"unknown paged codec {self.codec!r}")
        if self.dense_page_budget < 1:
            raise ValueError(
                f"dense_page_budget must be >= 1, got {self.dense_page_budget}"
            )


class PagedStore:
    """Paged accumulator: device pool + host page table + codecs.

    Every mutating call runs under the owner's device lock (the
    aggregator's ``_dev_lock``); the internal lock guards the host spill
    for concurrent readers.
    """

    def __init__(
        self,
        num_metrics: int,
        bucket_limit: int,
        precision: int = PRECISION,
        config: PagedStoreConfig = PagedStoreConfig(),
        device=None,
        mesh=None,
    ):
        from loghisto_tpu_torch.ops.backend import resolve_device
        from loghisto_tpu_torch.ops.paged_store import (
            COMMIT_CHUNK,
            validate_pool_shape,
        )

        validate_pool_shape(config.pool_pages, config.page_size)
        self.mesh = mesh
        self._n_shards = self._n_stream = 1
        self._shard = 0
        if mesh is not None:
            from loghisto_tpu_torch.parallel.mesh import (
                METRIC_AXIS,
                STREAM_AXIS,
                axis_index,
                axis_size,
                check_mesh,
                mesh_device,
            )

            check_mesh(mesh)
            if device is None:
                device = mesh.device_type
            if resolve_device(device).type != mesh.device_type:
                raise ValueError(
                    f"device={device!r} but the mesh's devices are "
                    f"{mesh.device_type!r}: a rank's arena lives on its "
                    "mesh device"
                )
            device = mesh_device(mesh)
            self._n_shards = axis_size(mesh, METRIC_AXIS)
            self._n_stream = axis_size(mesh, STREAM_AXIS)
            self._shard = axis_index(mesh, METRIC_AXIS)
            if num_metrics % self._n_shards:
                raise ValueError(
                    f"num_metrics={num_metrics} not divisible by the "
                    f"{self._n_shards}-way metric axis"
                )
            if COMMIT_CHUNK % self._n_stream:
                raise ValueError(
                    f"COMMIT_CHUNK={COMMIT_CHUNK} not divisible by the "
                    f"{self._n_stream}-way stream axis"
                )
        self.device = resolve_device(device)
        self.config = config
        self.bucket_limit = int(bucket_limit)
        self.precision = int(precision)
        self.num_buckets = 2 * self.bucket_limit + 1
        self.num_metrics = int(num_metrics)
        self._lock = threading.Lock()

        self._codecs: List[BucketCodec] = [
            dense_codec(self.num_buckets),
            loglinear_codec(self.bucket_limit, config.loglinear_factor),
            polytail_codec(
                self.bucket_limit,
                # the default suits the 4096-limit codec; clamp for
                # narrow histograms (as the JAX store does)
                min(config.body_halfwidth, max(1, self.bucket_limit // 2)),
                config.tail_rel_error,
                self.precision,
            ),
        ]
        self._codec_ids = {c.name: i for i, c in enumerate(self._codecs)}
        self._enc = np.stack([c.enc_lut for c in self._codecs])
        self._storage_buckets = np.array(
            [c.storage_buckets for c in self._codecs], dtype=np.int64
        )
        # decode LUTs padded to one [C, max S] table for mixed-codec
        # gathers (entries past a codec's S are never read)
        self._dec = np.zeros(
            (len(self._codecs), int(self._storage_buckets.max())),
            dtype=np.int64,
        )
        for i, c in enumerate(self._codecs):
            self._dec[i, : c.storage_buckets] = c.dec_lut
        self.row_codec = np.full(self.num_metrics, -1, dtype=np.int8)

        page = config.page_size
        self.pages_per_row = -(-self.num_buckets // page)
        self.page_table = np.full(
            (self.num_metrics, self.pages_per_row), -1, dtype=np.int32
        )
        # shard k's arena: global slots [k * shard_pages, (k + 1) *
        # shard_pages), its base slot the shard's zero page; one card is
        # the one-shard case, whose arena is the whole pool
        self.rows_per_shard = self.num_metrics // self._n_shards
        self.shard_pages = config.pool_pages
        self.total_pages = self._n_shards * config.pool_pages
        validate_pool_shape(self.total_pages, page)
        # one free-slot stack per arena: the top (index _free_n[k] - 1)
        # is popped first, so slots base + 1, base + 2, ... are handed
        # out in order, as the JAX store's list.pop() does
        sp = self.shard_pages
        self._free = [
            np.arange((k + 1) * sp - 1, k * sp, -1, dtype=np.int32)
            for k in range(self._n_shards)
        ]
        self._free_n = [len(f) for f in self._free]

        # this rank's arena (the whole pool on one card)
        self._pool = torch.zeros(
            (self.shard_pages, page), dtype=torch.int32, device=self.device
        )
        # exact host spill: {(row, native dense idx): int count}
        self._host_spill: Dict[Tuple[int, int], int] = {}
        # a mesh migration's spilled cells on their way to their new block
        self._carried = None

        self.commits = 0
        self.h2d_bytes = 0
        self.last_h2d_bytes = 0
        self.allocated_pages = 0
        self.overflowed_cells = 0
        self.spilled_cells = 0
        self.fused_dispatches = 0
        self.released_pages = 0

        # device mirrors for K4f; built at first use, then updated in
        # place for the rows / (row, page) pairs marked dirty here
        self._mirror = None
        self._dirty_rows: List[np.ndarray] = []
        self._dirty_pairs: List[Tuple[np.ndarray, np.ndarray]] = []

        if config.overflow_row is not None:
            self._reserve_overflow_pages(config.overflow_row)

    # -- codec selection ------------------------------------------------ #

    def _assign_codecs(self, rows: np.ndarray, dense_idx: np.ndarray) -> None:
        """Give every codec-less row of the batch a codec from its
        first-touch buckets (the JAX ``_choose_codec`` rule, per row):
        exact dense while the occupied span fits the page budget, then
        polytail for tail-heavy rows, loglinear otherwise."""
        new = self.row_codec[rows] < 0
        if not new.any():
            return
        r, d = rows[new], dense_idx[new]
        cfg = self.config
        urows, inv = np.unique(r, return_inverse=True)
        inv = inv.reshape(-1)
        if cfg.codec != "auto":
            self.row_codec[urows] = self._codec_ids[cfg.codec]
        else:
            page = cfg.page_size
            pair = np.unique(inv.astype(np.int64) * self.pages_per_row
                             + d // page)
            span = np.bincount(pair // self.pages_per_row,
                               minlength=len(urows))
            tail = np.abs(d - self.bucket_limit) > cfg.body_halfwidth
            frac = (np.bincount(inv, weights=tail, minlength=len(urows))
                    / np.bincount(inv, minlength=len(urows)))
            codec = np.where(
                span <= cfg.dense_page_budget,
                self._codec_ids[CODEC_DENSE],
                np.where(frac >= cfg.tail_occupancy,
                         self._codec_ids[CODEC_POLYTAIL],
                         self._codec_ids[CODEC_LOGLINEAR]),
            )
            self.row_codec[urows] = codec
        self._mark_rows(urows)

    def set_row_codec(self, row: int, name: str) -> None:
        """Pin a row's codec explicitly (checkpoint restore, tests).
        Only legal before the row holds data under a different codec."""
        want = self._codec_ids[name]
        if self.row_codec[row] >= 0 and self.row_codec[row] != want:
            if np.any(self.page_table[row] >= 0):
                raise ValueError(
                    f"row {row} already holds data under codec "
                    f"{self._codecs[self.row_codec[row]].name!r}"
                )
        self.row_codec[row] = want
        self._mark_rows(np.array([row]))

    # -- allocation ----------------------------------------------------- #

    def _reserve_overflow_pages(self, row: int) -> None:
        """Map the overflow row's (loglinear) pages eagerly: the
        catch-all row must never itself fail to allocate."""
        self.row_codec[row] = self._codec_ids[CODEC_LOGLINEAR]
        codec = self._codecs[self.row_codec[row]]
        n_pages = -(-codec.storage_buckets // self.config.page_size)
        pages = np.array(
            [p for p in range(n_pages) if self.page_table[row, p] < 0],
            dtype=np.int64,
        )
        if len(pages) > self._free_n[self._shard_of_row(row)]:
            raise ValueError(
                "pool too small to reserve the overflow row's "
                f"{n_pages} pages; raise pool_pages"
            )
        self._alloc_pairs(np.full(len(pages), row, dtype=np.int64), pages)
        self._mark_rows(np.array([row]))

    def _shard_of_row(self, row):
        """The metric shard (arena) that owns ``row`` (ints or arrays)."""
        return row // self.rows_per_shard

    def _alloc_pairs(self, rows: np.ndarray, pages: np.ndarray) -> int:
        """Map unmapped (row, page) pairs, given in ascending (row, page)
        order, to free slots of each row's own shard arena: the pairs of
        shard k take the successive pops of its free stack, exactly as
        the JAX store's ``_alloc`` loop over the same sorted pairs.  A
        shard's pairs past its free stack's end stay unmapped.  Returns
        the number mapped."""
        if not len(rows):
            return 0
        shard = self._shard_of_row(rows)
        # sorted rows: each shard's pairs are one contiguous run
        bounds = np.searchsorted(shard, np.arange(self._n_shards + 1))
        mapped = 0
        for k in range(self._n_shards):
            lo, hi = int(bounds[k]), int(bounds[k + 1])
            take = min(hi - lo, self._free_n[k])
            if not take:
                continue
            n = self._free_n[k]
            slots = self._free[k][n - take: n][::-1]
            self._free_n[k] = n - take
            r, p = rows[lo:lo + take], pages[lo:lo + take]
            self.page_table[r, p] = slots
            self._mark_pairs(r, p)
            mapped += take
        self.allocated_pages += mapped
        return mapped

    def _alloc_missing(self, pairs: np.ndarray) -> None:
        """Allocate each unique unmapped (row, page) among the given flat
        pair indices (row * pages_per_row + page) once, in ascending
        order."""
        missing = pairs[self.page_table.reshape(-1)[pairs] < 0]
        if not len(missing):
            return
        keys = np.unique(missing)
        self._alloc_pairs(keys // self.pages_per_row,
                          keys % self.pages_per_row)

    def _push_free(self, slots: np.ndarray) -> None:
        """Return slots to the free stack of the arena each came from
        (the row's shard, by the allocation invariant), the last one on
        top (popped first), as the JAX store appends them to its
        lists."""
        slots = np.asarray(slots, dtype=np.int32)
        shard = slots // self.shard_pages
        for k in np.unique(shard).tolist():
            mine = slots[shard == k]
            n, m = self._free_n[k], len(mine)
            if n + m > len(self._free[k]):  # a loaded, shorter stack
                grown = np.empty(self.shard_pages - 1, dtype=np.int32)
                grown[:n] = self._free[k][:n]
                self._free[k] = grown
            self._free[k][n:n + m] = mine
            self._free_n[k] = n + m

    def free_list(self) -> List[int]:
        """The first arena's free slots as the JAX store's list (its
        last entry is popped next): on one card, the whole pool's."""
        return self.free_lists()[0]

    def free_lists(self) -> List[List[int]]:
        """Every arena's free slots, as the JAX store's ``_free_lists``."""
        return [f[:n].tolist() for f, n in zip(self._free, self._free_n)]

    @property
    def free_pages(self) -> int:
        return int(sum(self._free_n))

    @property
    def occupied_pages(self) -> int:
        return self._n_shards * (self.shard_pages - 1) - self.free_pages

    def shard_free_pages(self) -> List[int]:
        """Free pages left in each metric shard's arena (host state: the
        same on every rank, no collective)."""
        return [int(n) for n in self._free_n]

    def shard_occupancy(self) -> List[float]:
        """Occupied fraction of each shard arena (zero page excluded):
        saturation is per arena, so one hot shard spills while the
        average still looks roomy."""
        cap = max(1, self.shard_pages - 1)
        return [1.0 - n / cap for n in self._free_n]

    def pool_saturation(self) -> float:
        """Worst shard-arena occupancy in [0, 1]; the watchdog's
        ``pool_saturation`` invariant reads it."""
        return max(self.shard_occupancy())

    def hbm_bytes(self) -> int:
        """This rank's device footprint: its arena plus its block of the
        page table's mirror (the whole pool and table on one card)."""
        pool = self.shard_pages * self.config.page_size * 4
        return pool + self.rows_per_shard * self.pages_per_row * 4

    def _encode(self, codec, dense_idx: np.ndarray) -> np.ndarray:
        """Storage indices (int64) of native dense indices under the
        given codec ids: one flat gather of the stacked encode LUTs."""
        flat = np.asarray(codec, dtype=np.int64) * self.num_buckets + dense_idx
        return self._enc.reshape(-1)[flat].astype(np.int64)

    # -- device mirrors -------------------------------------------------- #

    def _mark_rows(self, rows: np.ndarray) -> None:
        if self._mirror is not None:
            self._dirty_rows.append(np.asarray(rows, dtype=np.int64))

    def _mark_pairs(self, rows: np.ndarray, pages: np.ndarray) -> None:
        if self._mirror is not None:
            self._dirty_pairs.append((np.asarray(rows, dtype=np.int64),
                                      np.asarray(pages, dtype=np.int64)))

    def _drop_mirror(self) -> None:
        self._mirror = None
        self._dirty_rows, self._dirty_pairs = [], []

    @property
    def _row0(self) -> int:
        """The first row of this rank's block (0 on one card)."""
        return self._shard * self.rows_per_shard

    def _in_block(self, rows: np.ndarray) -> np.ndarray:
        return (rows >= self._row0) & (rows < self._row0 + self.rows_per_shard)

    def _local_slots(self, slots: np.ndarray) -> np.ndarray:
        """Global slots as slots of this rank's arena; -1 for an unmapped
        entry, the arena's zero page and every other arena's slot."""
        local = slots - self._shard * self.shard_pages
        own = (slots >= 0) & (local > 0) & (local < self.shard_pages)
        return np.where(own, local, -1).astype(np.int32)

    def _arena_triples(self, dev: np.ndarray) -> np.ndarray:
        """The translated (global slot, offset, count) triples that land
        in this rank's arena, as (arena slot, offset, count): all of
        them, unchanged, on one card."""
        if self.mesh is None:
            return dev
        local = self._local_slots(dev[:, 0])
        own = local > 0
        out = dev[own]
        out[:, 0] = local[own]
        return out

    def device_luts(self):
        """(row_codec int32 [M], enc_luts int32 [C, B], page_major int32
        [pages_per_row, M]) on the pool's device for K4f.  The page
        table's device mirror is page-major — the transpose of the host
        ``page_table`` — so that samples on the same page index of their
        rows gather from one contiguous slab (``csrc/paged_store.cu``).
        On a mesh they hold the rank's block: ``row_codec[lo:lo + rows]``
        and the table's rows of the block with arena-local slots (every
        other entry -1), so K4f indexes the rank's arena directly.  Built
        once; later host changes are written into them for the dirty
        rows and pages of the block only."""
        dev = self.device
        lo, n = self._row0, self.rows_per_shard
        if self._mirror is None:
            block = self.page_table[lo:lo + n]
            self._mirror = (
                torch.from_numpy(
                    self.row_codec[lo:lo + n].astype(np.int32)).to(dev),
                torch.from_numpy(self._enc.astype(np.int32)).to(dev),
                torch.from_numpy(np.ascontiguousarray(
                    self._local_slots(block).T)).to(dev),
            )
            self._dirty_rows, self._dirty_pairs = [], []
            return self._mirror
        rc, _, tbl = self._mirror
        if self._dirty_rows:
            rows = np.unique(np.concatenate(self._dirty_rows))
            rows = rows[self._in_block(rows)]
            rc[torch.from_numpy(rows - lo).to(dev)] = torch.from_numpy(
                self.row_codec[rows].astype(np.int32)).to(dev)
            self._dirty_rows = []
        if self._dirty_pairs:
            rows = np.concatenate([r for r, _ in self._dirty_pairs])
            pages = np.concatenate([p for _, p in self._dirty_pairs])
            keep = self._in_block(rows)
            rows, pages = rows[keep], pages[keep]
            tbl[torch.from_numpy(pages).to(dev),
                torch.from_numpy(rows - lo).to(dev)] = torch.from_numpy(
                    self._local_slots(self.page_table[rows, pages])).to(dev)
            self._dirty_pairs = []
        return self._mirror

    # -- commit (sparse route) ------------------------------------------ #

    def _spill_add(self, rows, dense_idx, weights) -> None:
        """Exact host-spill add; on a mesh of the block's rows alone (the
        rank reports its block, and a migration carries the rest)."""
        if self.mesh is not None:
            keep = self._in_block(rows)
            rows, dense_idx, weights = (rows[keep], dense_idx[keep],
                                        weights[keep])
        # host arrays: listed before the lock, so it guards only the dict
        cells = list(zip(rows.tolist(), dense_idx.tolist(),
                         weights.tolist()))
        with self._lock:
            for r, d, w in cells:
                key = (r, d)
                self._host_spill[key] = self._host_spill.get(key, 0) + w

    def translate(self, packed: np.ndarray) -> Tuple[np.ndarray, int, int]:
        """Rewrite packed (row, codec_bucket, count) triples into
        (slot, offset, count) triples against the page table, mapping
        pages on demand and applying the spill policy.  Returns
        (device_triples, applied_total, spilled_total); spilled counts
        are already in the host spill."""
        rows = packed[:, 0].astype(np.int64)
        keep = (rows >= 0) & (rows < self.num_metrics)
        rows = rows[keep]
        if not len(rows):
            return np.empty((0, 3), dtype=np.int32), 0, 0
        L = self.bucket_limit
        dense_idx = np.clip(packed[keep, 1].astype(np.int64), -L, L) + L
        weights = packed[keep, 2].astype(np.int64)

        self._assign_codecs(rows, dense_idx)
        storage = self._encode(self.row_codec[rows], dense_idx)
        page = self.config.page_size
        page_idx = storage // page
        offs = (storage % page).astype(np.int32)
        pairs = rows * self.pages_per_row + page_idx
        self._alloc_missing(pairs)
        slots = self.page_table.reshape(-1)[pairs]

        mapped = slots >= 0
        out_slots, out_offs, out_w = slots, offs, weights
        spilled_total = 0
        if not mapped.all():
            um_rows, um_idx, um_w = (rows[~mapped], dense_idx[~mapped],
                                     weights[~mapped])
            ov = self.config.overflow_row
            if ov is not None:
                self.overflowed_cells += len(um_rows)
                ov_storage = self._encode(self.row_codec[ov], um_idx)
                out_slots = np.concatenate(
                    [slots[mapped], self.page_table[ov, ov_storage // page]])
                out_offs = np.concatenate(
                    [offs[mapped], (ov_storage % page).astype(np.int32)])
                out_w = np.concatenate([weights[mapped], um_w])
            else:
                self.spilled_cells += len(um_rows)
                spilled_total = int(um_w.sum())
                self._spill_add(um_rows, um_idx, um_w)
                out_slots, out_offs, out_w = (slots[mapped], offs[mapped],
                                              weights[mapped])

        dev = np.empty((len(out_slots), 3), dtype=np.int32)
        dev[:, 0] = out_slots
        dev[:, 1] = out_offs
        dev[:, 2] = out_w  # the caller keeps each cell < 2^30
        return dev, int(out_w.sum()), spilled_total

    def commit(self, packed: np.ndarray) -> int:
        """Translate and scatter one packed triple batch (K4).  Returns
        the count applied (device + host spill).  Triples pad to
        COMMIT_CHUNK multiples with slot -1, as in the JAX store.  On a
        mesh ``packed`` is the whole batch (the same on every rank): the
        host half translates all of it, and the rank ships and lands the
        triples of its arena."""
        from loghisto_tpu_torch.ops.paged_store import (
            COMMIT_CHUNK,
            paged_scatter,
        )

        dev, applied, spilled = self.translate(
            np.ascontiguousarray(packed, dtype=np.int32)
        )
        dev = self._arena_triples(dev)
        n = len(dev)
        if n:
            padded = -(-n // COMMIT_CHUNK) * COMMIT_CHUNK
            if padded != n:
                pad = np.zeros((padded - n, 3), dtype=np.int32)
                pad[:, 0] = -1
                dev = np.concatenate([dev, pad])
            paged_scatter(self._pool, torch.from_numpy(dev).to(self.device))
            self.commits += 1
            self.h2d_bytes += dev.nbytes
        self.last_h2d_bytes = dev.nbytes if n else 0
        return applied + spilled

    # -- fused direct-to-paged ingest (raw route) ------------------------ #

    def prepare_batch(
        self, ids: np.ndarray, values: np.ndarray
    ) -> Tuple[np.ndarray, int]:
        """Host half of the raw route, before the upload: assign codecs
        and map every page the batch needs (the storage bucket's page and
        its +/-1 storage neighbours' pages), so K4f never consults the
        host.  Returns (ids_rewritten, spilled_sample_count): samples
        whose page cannot be mapped rewrite to the overflow row or, with
        none, fold into the exact host spill and rewrite to -1."""
        from loghisto_tpu_torch.ops.fold import compress_np_host

        out = np.array(ids, dtype=np.int32, copy=True)
        valid = (out >= 0) & (out < self.num_metrics)
        if not valid.any():
            return out, 0
        rows = out[valid].astype(np.int64)
        L = self.bucket_limit
        dense_idx = np.clip(
            compress_np_host(np.asarray(values)[valid], self.precision),
            -L, L,
        ).astype(np.int64) + L
        self._assign_codecs(rows, dense_idx)
        codec = self.row_codec[rows]
        storage = self._encode(codec, dense_idx)
        page = self.config.page_size
        page_idx = storage // page
        off = storage - page_idx * page
        pairs = rows * self.pages_per_row + page_idx
        # the -1 neighbour leaves the page only at offset 0, the +1
        # neighbour only at the last offset below the codec's top bucket
        down = (off == 0) & (storage > 0)
        up = (off == page - 1) & (storage < self._storage_buckets[codec] - 1)
        self._alloc_missing(np.concatenate([pairs, pairs[down] - 1,
                                            pairs[up] + 1]))

        spilled = 0
        unmapped = self.page_table.reshape(-1)[pairs] < 0
        if unmapped.any():
            where = np.nonzero(valid)[0][unmapped]
            ov = self.config.overflow_row
            if ov is not None:
                self.overflowed_cells += len(where)
                out[where] = ov
            else:
                keys, counts = np.unique(
                    rows[unmapped] * self.num_buckets + dense_idx[unmapped],
                    return_counts=True,
                )
                self.spilled_cells += len(keys)
                self._spill_add(keys // self.num_buckets,
                                keys % self.num_buckets, counts)
                out[where] = -1
                spilled = len(where)
        return out, spilled

    def ingest_raw(self, ids_dev: torch.Tensor, values_dev: torch.Tensor) -> None:
        """One K4f launch into the pool; the batch must have gone
        through ``prepare_batch`` (ids it rewrote to -1 drop).  On a mesh
        the ids are global and the rank lands the samples of its block
        (``block_ids``: re-based, every other id -1, which K4f drops).
        The reference's step splits the batch over the stream axis and
        psums the stream deltas; here every rank of a metric column
        ingests the whole batch (ROADMAP D12), so there is no
        collective."""
        from loghisto_tpu_torch.ops.fused_ingest import (
            fused_paged_ingest_batch,
        )
        from loghisto_tpu_torch.parallel.mesh import block_ids

        if self.mesh is not None:
            ids_dev = block_ids(ids_dev, self._row0, self.rows_per_shard)
        fused_paged_ingest_batch(self._pool, ids_dev, values_dev,
                                 *self.device_luts(), self.bucket_limit,
                                 self.precision)
        self.fused_dispatches += 1

    # -- spill / reset ---------------------------------------------------- #

    def pool_deleted(self) -> bool:
        """Whether a failed launch consumed the pool: never in the port.
        The reference donates its JAX pool into each dispatch, and a
        failure may leave it deleted; K4 and K4f update the pool in
        place, so it survives a failed launch."""
        return False

    def reset_pool(self) -> None:
        """Zero the pool; page mappings survive (the device-failure
        recovery's rebuild, and ``spill_pool``'s reset)."""
        self._pool.zero_()

    def spill_pool(self) -> None:
        """Fold every pool count into the exact host spill and zero the
        pool (when an interval's totals could overflow int32 cells)."""
        rows, idx, counts = self._decode_pool_cells()
        self._spill_add(rows, idx, counts)
        self.reset_pool()

    def spill_cells(self, rows, dense_idx, weights) -> None:
        """Exact host-spill add of cells given by dense-axis index."""
        self._spill_add(np.asarray(rows, dtype=np.int64),
                        np.asarray(dense_idx, dtype=np.int64),
                        np.asarray(weights, dtype=np.int64))

    def spill_triples(self, triples: np.ndarray) -> int:
        """Fold translated ``(slot, offset, count)`` triples back into the
        exact host spill through the page table's inverse (slot -> owning
        row and page -> codec decode); returns the count folded.  The
        committer's failure recovery calls it for the one chunk whose
        translate ran but whose commit step failed: spilling that
        chunk's cells would count twice the ones translate already
        spilled.  On a mesh the rank folds the triples of its own arena,
        the ones its failed launch did not land."""
        triples = self._arena_triples(np.asarray(triples))
        triples = triples[triples[:, 0] > 0]
        if not len(triples):
            return 0
        owner_row, owner_page = self._owners()
        # arena slots back to global ones, the owners' index
        slots = (triples[:, 0].astype(np.int64)
                 + self._shard * self.shard_pages)
        rows, idx, counts = self._decode_storage(
            owner_row[slots],
            owner_page[slots] * self.config.page_size + triples[:, 1],
            triples[:, 2].astype(np.int64),
        )
        self._spill_add(rows, idx, counts)
        return int(counts.sum())

    # -- decode / stats -------------------------------------------------- #

    def _owners(self) -> Tuple[np.ndarray, np.ndarray]:
        """Each pool slot's owning (row, page) from the inverted page
        table; row -1 for a slot no row maps."""
        owner_row = np.full(self.total_pages, -1, dtype=np.int64)
        owner_page = np.zeros(self.total_pages, dtype=np.int64)
        rows_of, pages_of = np.nonzero(self.page_table >= 0)
        owned = self.page_table[rows_of, pages_of]
        owner_row[owned] = rows_of
        owner_page[owned] = pages_of
        return owner_row, owner_page

    def _decode_storage(self, rows, storage, counts):
        """Cells given by (row, storage index, count) as (row, native
        dense index, count), under each row's codec.  Unowned slots hold
        nothing K4/K4f wrote; dense pages can overhang the storage axis,
        where translation never writes: both drop."""
        codec = self.row_codec[np.maximum(rows, 0)].astype(np.int64)
        keep = (rows >= 0) & (codec >= 0)
        keep &= storage < self._storage_buckets[np.maximum(codec, 0)]
        rows, storage, codec, counts = (rows[keep], storage[keep],
                                        codec[keep], counts[keep])
        return rows, self._dec[codec, storage], counts

    def _decode_pool_cells(
        self, pool: Optional[torch.Tensor] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Every nonzero pool cell as (row, native dense index, int64
        count), in slot order.  One nonzero pass over the pool on its
        device and one copy of the cells to the host; each slot's owner
        (row, page) comes from the inverted page table.  The same
        multiset of cells as the JAX store's per-page loop.  ``pool``
        decodes another tensor of the pool's shape (a difference of two
        pool states) under this store's table and codecs."""
        pool = self._pool if pool is None else pool
        flat = torch.nonzero(pool.view(-1)).reshape(-1)
        counts = pool.view(-1)[flat].cpu().numpy().astype(np.int64)
        flat = flat.cpu().numpy()
        page = self.config.page_size
        # the arena's local slots as global ones
        slots = flat // page + self._shard * self.shard_pages
        offs = flat % page
        owner_row, owner_page = self._owners()
        return self._decode_storage(owner_row[slots],
                                    owner_page[slots] * page + offs, counts)

    def _row_cells(self, rows) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The nonzero pool cells of ``rows`` as (row, native dense index,
        int64 count), in (row, page, offset) order — the JAX store's
        whole-pool decode restricted to these rows.  Only the rows'
        mapped pages are gathered on the device and copied back.  On a
        mesh, the rows of this rank's block (the pages its arena
        holds)."""
        rows = np.unique(np.asarray(rows, dtype=np.int64))
        if self.mesh is not None:
            rows = rows[self._in_block(rows)]
        tbl = self.page_table[rows]
        r_i, p_i = np.nonzero(tbl >= 0)
        if not len(r_i):
            empty = np.empty(0, dtype=np.int64)
            return empty, empty.copy(), empty.copy()
        slots = torch.from_numpy(self._local_slots(tbl[r_i, p_i]).astype(
            np.int64))
        pages = self._pool.index_select(0, slots.to(self.device)).view(-1)
        flat = torch.nonzero(pages).reshape(-1)
        counts = pages[flat].cpu().numpy().astype(np.int64)
        flat = flat.cpu().numpy()
        page = self.config.page_size
        k = flat // page
        return self._decode_storage(rows[r_i[k]], p_i[k] * page + flat % page,
                                    counts)

    def _spill_cells(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The host spill as (rows, native dense indices, int64 counts)."""
        with self._lock:
            items = list(self._host_spill.items())
        return (np.array([k[0] for k, _ in items], dtype=np.int64),
                np.array([k[1] for k, _ in items], dtype=np.int64),
                np.array([v for _, v in items], dtype=np.int64))

    def _block_cells(
        self, include_spill: bool = True
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """This rank's cells: its arena's and, with ``include_spill``,
        its host spill's (on one card, the whole store's)."""
        rows, idx, counts = self._decode_pool_cells()
        if include_spill and self._host_spill:
            s_rows, s_idx, s_cnt = self._spill_cells()
            rows = np.concatenate([rows, s_rows])
            idx = np.concatenate([idx, s_idx])
            counts = np.concatenate([counts, s_cnt])
        return rows, idx, counts

    def decode_cells(
        self, include_spill: bool = True, first_only: bool = False
    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """(rows, native dense indices, int64 counts) across the pool
        and the host spill.  On a mesh a collective of the rank's metric
        line: every block's cells, gathered in block order.  With
        ``first_only`` (a checkpoint's save) the cells go to rank (0, 0)
        alone, from the ranks of stream index 0 (each arena is the same
        on every rank of its metric column, so one column's copy is the
        whole store); every other rank returns None."""
        if first_only and self.mesh is not None:
            from loghisto_tpu_torch.parallel.mesh import is_stream_lead

            if not is_stream_lead(self.mesh):
                return None
        cells = self._block_cells(include_spill)
        if self.mesh is None:
            return cells
        from loghisto_tpu_torch.parallel.mesh import gather_rows

        whole = gather_rows(self.mesh, np.stack(cells, axis=1),
                            first_only=first_only)
        if whole is None:
            return None
        return whole[:, 0], whole[:, 1], whole[:, 2]

    def decode_dense(self, include_spill: bool = True,
                     first_only: bool = False) -> Optional[np.ndarray]:
        """Dense [M, B] int64 reconstruction (O(M x B) host memory); on a
        mesh a collective (``decode_cells``, whose ``first_only`` leaves
        None on every rank but rank (0, 0))."""
        cells = self.decode_cells(include_spill, first_only)
        if cells is None:
            return None
        acc = np.zeros((self.num_metrics, self.num_buckets), dtype=np.int64)
        np.add.at(acc, cells[:2], cells[2])
        return acc

    def stats(self, ps: np.ndarray, reset: bool = True):
        """Per-row counts/sums/percentiles over every stored cell (pool
        and spill), sparsely — ``sparse_cells_stats`` on the decoded
        cells.  ``reset`` zeroes the pool and clears the spill.  On a
        mesh, the rows of this rank's block (``[rows_per_shard]``
        arrays), from its arena and its spill; no collective."""
        from loghisto_tpu_torch.ops.stats import sparse_cells_stats

        rows, idx, counts = self._block_cells(include_spill=True)
        out = sparse_cells_stats(
            rows - self._row0, idx, counts, self.rows_per_shard,
            np.asarray(ps), self.bucket_limit, self.precision,
        )
        if reset:
            self.reset_pool()
            with self._lock:
                self._host_spill.clear()
        return out

    def query(self, ids: np.ndarray, ps: np.ndarray):
        """Snapshot query over the pool on its device: rows group by
        codec, each group gathers only its rows' pages and runs the
        dense engine's ``snapshot_row_stats``.  Host-spill counts are not
        visible here (as in the JAX store).  On a mesh a collective of
        the rank's metric line: each rank serves the ids of its block
        from its arena, and one sum over the line (every other rank adds
        zeros) gives every rank every answer."""
        from loghisto_tpu_torch.ops.paged_store import paged_query

        ids = np.asarray(ids, dtype=np.int64)
        ps_f = np.asarray(ps, dtype=np.float32)
        n, p_n = len(ids), len(ps_f)
        counts = np.zeros(n, dtype=np.int64)
        sums = np.zeros(n, dtype=np.float64)
        pcts = np.zeros((n, p_n), dtype=np.float64)
        codecs = self.row_codec[ids]
        mine = (np.ones(n, dtype=bool) if self.mesh is None
                else self._in_block(ids))
        for cid in np.unique(codecs[mine]):
            if cid < 0:
                continue  # untouched rows: zeros
            sel = np.nonzero(mine & (codecs == cid))[0]
            out = paged_query(
                self._pool,
                torch.from_numpy(self._local_slots(self.page_table[ids[sel]])),
                torch.from_numpy(self._codecs[cid].dec_lut),
                ps_f, self.bucket_limit, self.precision,
            )
            counts[sel] = out["counts"].cpu().numpy()
            sums[sel] = out["sums"].cpu().numpy()
            pcts[sel] = out["percentiles"].cpu().numpy()
        if self.mesh is not None:
            from loghisto_tpu_torch.parallel.mesh import reduce_parts

            counts, sums, pcts = (
                reduce_parts(self.mesh, torch.from_numpy(a).to(self.device))
                .cpu().numpy() for a in (counts, sums, pcts))
        return {"counts": counts, "sums": sums, "percentiles": pcts}

    # -- lifecycle composition ------------------------------------------ #

    def fold_rows_into(self, victims, target: int) -> int:
        """Count-exact eviction fold: each victim row's cells re-commit
        under the TARGET row's codec and pages (the overflow row), its
        host-spill cells move to the target, and its pages and codec are
        released.  Returns the total count moved.

        On a mesh a collective of the rank's metric line (ROADMAP D13):
        each rank decodes the victims of its block from its arena and
        pops their spilled cells from its block's spill, one gather hands
        every rank all of both, every rank zeroes its own arena's victim
        slots and makes the same host ``commit`` under the target's
        codec (landing its arena's triples with K4), and the spilled
        cells join the target's block.  ``moved`` is the gathered total,
        the same on every rank."""
        victims = [int(v) for v in victims if v != target]
        if not victims:
            return 0
        (rows, idx, counts), spill = self._gather_cells(
            self._row_cells(victims), self._pop_spill(victims))
        moved = int(counts.sum()) + int(spill[2].sum())
        # zero the victim pages BEFORE recommitting, so the fold cannot
        # double-count (commit touches only the target's pages)
        self._zero_rows(victims)
        if len(rows):
            packed = np.empty((len(rows), 3), dtype=np.int32)
            packed[:, 0] = target
            packed[:, 1] = idx - self.bucket_limit
            packed[:, 2] = counts
            self.commit(packed)
        if len(spill[0]):
            self._spill_add(np.full(len(spill[0]), target, dtype=np.int64),
                            spill[1], spill[2])
        self.release_rows(victims)
        return moved

    def _gather_cells(self, pool_cells, spill_cells):
        """(pool cells, spilled cells), each (rows, native dense indices,
        int64 counts): on one card as given; on a mesh every rank's of
        its metric line, in block order (one ``gather_rows``)."""
        if self.mesh is None:
            return pool_cells, spill_cells
        from loghisto_tpu_torch.parallel.mesh import gather_rows

        part = np.concatenate([
            np.stack([np.zeros_like(pool_cells[0]), *pool_cells], axis=1),
            np.stack([np.ones_like(spill_cells[0]), *spill_cells], axis=1)])
        whole = gather_rows(self.mesh, part)
        pool, spill = whole[whole[:, 0] == 0], whole[whole[:, 0] == 1]
        return ((pool[:, 1], pool[:, 2], pool[:, 3]),
                (spill[:, 1], spill[:, 2], spill[:, 3]))

    def _zero_rows(self, rows) -> None:
        """Zero the rows' pages in this rank's arena (the whole pool on
        one card)."""
        slots = self.page_table[np.asarray(rows, dtype=np.int64)].reshape(-1)
        slots = self._local_slots(slots)
        slots = slots[slots > 0]
        if len(slots):
            self._pool.index_fill_(
                0, torch.from_numpy(slots.astype(np.int64)).to(self.device), 0)

    def _free_rows(self, rows) -> np.ndarray:
        """Unmap every page of ``rows`` and push its slot onto the free
        stack (rows in the given order, pages ascending, as the JAX
        store's loops append them).  Returns the rows, deduplicated in
        order."""
        rows = np.asarray(rows, dtype=np.int64).reshape(-1)
        _, first = np.unique(rows, return_index=True)
        rows = rows[np.sort(first)]
        tbl = self.page_table[rows]
        r_i, p_i = np.nonzero(tbl > 0)  # row-major: the loops' order
        self._push_free(tbl[r_i, p_i])
        self.page_table[rows[r_i], p_i] = -1
        self.released_pages += len(r_i)
        self._mark_pairs(rows[r_i], p_i)
        return rows

    def release_rows(self, rows) -> int:
        """Return every page mapped by ``rows`` to the free pool (the
        caller has folded or zeroed them) and unassign their codecs.
        Returns the number of pages freed."""
        before = self.released_pages
        rows = self._free_rows(rows)
        self.row_codec[rows] = -1
        self._mark_rows(rows)
        return self.released_pages - before

    def drop_rows(self, rows) -> None:
        """Discard rows entirely (eviction with a shed target): zero and
        release their pages, clear their codecs and purge their
        host-spill cells.  The caller accounts the shed counts.  On a
        mesh each rank zeroes its own arena's slots and purges its own
        block's spill: no collective."""
        rows = [int(r) for r in rows]
        if not rows:
            return
        self._zero_rows(rows)
        self.release_rows(rows)
        dead = set(rows)
        with self._lock:
            self._host_spill = {
                k: v for k, v in self._host_spill.items() if k[0] not in dead
            }

    def _extract_rows(self, rows, carry=None) -> np.ndarray:
        """Pull the rows' pool cells out as packed (row, centred codec
        bucket, count) int32 triples, zero and free their pages, and
        clear their table entries — KEEPING their codecs, so a later
        ``commit`` re-lands them under the same codec (the cross-shard
        migration of ``apply_permutation`` and ``grow``).

        On a mesh a collective of the rank's metric line: each rank
        extracts the rows of its block from its arena and pops the
        spilled cells of ``carry`` (rows whose shard changes) from its
        host spill, and one gather over the metric axis hands every rank
        all of both, in block order.  The spilled cells wait in
        ``_carried`` for the caller to re-home."""
        rows = [int(r) for r in rows]
        cells = self._row_cells(rows)
        self._zero_rows(rows)
        self._free_rows(rows)
        if self.mesh is not None:
            cells, self._carried = self._gather_cells(
                cells, self._pop_spill([] if carry is None else carry))
        r, idx, counts = cells
        packed = np.empty((len(r), 3), dtype=np.int32)
        packed[:, 0] = r
        packed[:, 1] = idx - self.bucket_limit
        packed[:, 2] = counts
        return packed

    def _pop_spill(self, rows):
        """Remove the host-spill cells of ``rows``; returns them as
        (rows, native dense indices, int64 counts)."""
        out = ([], [], [])
        gone = set(int(r) for r in rows)
        with self._lock:
            for key in [k for k in self._host_spill if k[0] in gone]:
                out[0].append(key[0])
                out[1].append(key[1])
                out[2].append(self._host_spill.pop(key))
        return tuple(np.array(a, dtype=np.int64) for a in out)

    def _rehome_spill(self, remap=None) -> None:
        """Add the spilled cells the last mesh extraction carried under
        their (remapped) rows; ``_spill_add`` keeps this rank's block."""
        rows, idx, counts = self._carried
        self._carried = None
        if remap is not None and len(rows):
            rows = np.array([remap[int(x)] for x in rows], dtype=np.int64)
        if len(rows):
            self._spill_add(rows, idx, counts)

    def apply_permutation(self, perm, m_rows: int) -> None:
        """Survivor repack: row r of the new layout takes old row
        ``perm[r]`` (None or -1 is a hole, left unmapped).  A host table
        permutation: pool pages never move, so compaction costs no
        device traffic.  The host spill follows its rows; the K4f
        mirrors are rebuilt at the next raw batch.

        With more than one shard arena, a survivor whose new row lies in
        another shard cannot keep its old arena's pages: its cells are
        extracted first (codec kept) and committed under the new id
        after the permutation, which maps pages in the new shard's arena
        (the reference's migration).  On a mesh that is a collective of
        the rank's metric line (``_extract_rows``), made when some
        survivor changes shard, which every rank sees alike."""
        p = np.array([-1 if x is None else int(x) for x in perm[:m_rows]],
                     dtype=np.int64)
        new = np.nonzero(p >= 0)[0]
        old = p[new]
        packed = None
        if self._n_shards > 1:
            cross = self._shard_of_row(old) != self._shard_of_row(new)
            movers = old[cross]  # in order of new position, as the JAX loop
            if len(movers):
                packed = self._extract_rows(movers, carry=movers)
                packed[:, 0] = self._remap_ids(packed[:, 0], movers,
                                               new[cross])
        table = np.full_like(self.page_table, -1)
        codec = np.full_like(self.row_codec, -1)
        table[new] = self.page_table[old]
        codec[new] = self.row_codec[old]
        self.page_table, self.row_codec = table, codec
        self._drop_mirror()
        remap = dict(zip(old.tolist(), new.tolist()))
        with self._lock:
            spill: Dict[Tuple[int, int], int] = {}
            for (r, d), v in self._host_spill.items():
                nr = remap.get(r)
                if nr is not None:
                    spill[(nr, d)] = spill.get((nr, d), 0) + v
            self._host_spill = spill
        if packed is not None:
            if self.mesh is not None:
                self._rehome_spill(remap)
            if len(packed):
                self.commit(packed)

    @staticmethod
    def _remap_ids(ids: np.ndarray, old: np.ndarray,
                   new: np.ndarray) -> np.ndarray:
        """``ids`` (each one of ``old``) as the matching ``new`` ids."""
        order = np.argsort(old)
        return new[order][np.searchsorted(old[order], ids)].astype(np.int32)

    # -- growth and state ------------------------------------------------ #

    def grow(self, new_m: int) -> None:
        """Extend the row space: a host page-table extension (the K4f
        mirrors are rebuilt at the next raw batch).  With more than one
        shard arena the shard boundaries are redrawn (``new_m //
        n_shards`` rows a shard): rows whose shard changes migrate, as
        in ``apply_permutation`` (on a mesh a collective of the rank's
        metric line), and the overflow row's pages are re-reserved."""
        if new_m <= self.num_metrics:
            return
        packed = None
        if self._n_shards > 1:
            if new_m % self._n_shards:
                raise ValueError(
                    f"grown num_metrics={new_m} not divisible by the "
                    f"{self._n_shards}-way metric axis"
                )
            r = np.arange(self.num_metrics, dtype=np.int64)
            changers = r[r // self.rows_per_shard
                         != r // (new_m // self._n_shards)]
            movers = changers[(self.page_table[changers] >= 0).any(axis=1)]
            if len(movers) or (self.mesh is not None and len(changers)):
                packed = self._extract_rows(movers, carry=changers)
        extra = new_m - self.num_metrics
        self.page_table = np.concatenate([
            self.page_table,
            np.full((extra, self.pages_per_row), -1, dtype=np.int32),
        ])
        self.row_codec = np.concatenate(
            [self.row_codec, np.full(extra, -1, dtype=np.int8)]
        )
        self.num_metrics = new_m
        self.rows_per_shard = new_m // self._n_shards
        self._drop_mirror()
        if packed is not None:
            if self.mesh is not None:
                self._rehome_spill()
            if len(packed):
                self.commit(packed)
        if self._n_shards > 1 and self.config.overflow_row is not None:
            # a migrated overflow row gets its reserved pages back
            # (nothing to do for an unmoved one)
            self._reserve_overflow_pages(self.config.overflow_row)

    def max_cell(self) -> int:
        """Largest single pool count (the restore's headroom check): one
        reduction over the pool on its device, read back."""
        return int(self._pool.max())

    # -- checkpoint ------------------------------------------------------ #

    def codec_names(self) -> List[Optional[str]]:
        """Each row's codec name (None for a row without one), as a v3
        checkpoint records it."""
        return [
            self._codecs[c].name if c >= 0 else None for c in self.row_codec
        ]

    def restore_codecs(self, names: List[Optional[str]]) -> None:
        """Pin saved codec names onto rows that have none yet; the K4f
        mirrors are rebuilt at the next raw batch."""
        for row, name in enumerate(names[: self.num_metrics]):
            if name is not None and self.row_codec[row] < 0:
                self.row_codec[row] = self._codec_ids[name]
        self._drop_mirror()

    def state(self, first_only: bool = False) -> Optional[dict]:
        """Host copies of the store's state (``load_state`` reads it):
        the pool, the host half, the spill and ``free_list``, or one free
        list per arena (``free_lists``) where there are several.

        On a mesh a collective of the rank's metric line (ROADMAP D13):
        the whole store's state, as the reference's one controller holds
        it, with the arenas gathered in shard order into the whole pool
        and the blocks' spilled cells into one spill; every rank returns
        the same.  With ``first_only`` rank (0, 0) alone gathers and
        returns it (the ranks off stream index 0 make no call) and every
        other rank returns None."""
        with self._lock:
            spill = dict(self._host_spill)
        if self.mesh is None:
            pool = self._pool.cpu().numpy().copy()
        else:
            from loghisto_tpu_torch.parallel.mesh import (
                gather_rows,
                host_gather,
                pool_sharding,
            )

            pool = host_gather(self._pool, pool_sharding(self.mesh),
                               first_only)
            cells = np.array([(r, d, v) for (r, d), v in spill.items()],
                             dtype=np.int64).reshape(-1, 3)
            cells = gather_rows(self.mesh, cells, first_only=first_only)
            if pool is None or cells is None:
                return None
            spill = {(int(r), int(d)): int(v) for r, d, v in cells}
        frees = self.free_lists()
        return {
            "pool": pool,
            "page_table": self.page_table.copy(),
            "row_codec": self.row_codec.copy(),
            "host_spill": spill,
            **({"free_list": frees[0]} if len(frees) == 1
               else {"free_lists": frees}),
            "allocated_pages": int(self.allocated_pages),
        }

    def load_state(self, st: dict) -> None:
        """Replace the store's contents with ``st`` (same page size and
        arena size; the row count is the table's).  ``st`` holds one free
        list (``free_list``) or one per arena (``free_lists``, a JAX mesh
        store's, from ``state.paged_state_from_jax``); on a mesh it must
        hold one per shard of the metric axis, and the rank loads its
        arena's block of the whole pool and its block's spilled cells
        (no collective: every rank loads the same state)."""
        pool = np.ascontiguousarray(st["pool"], dtype=np.int32)
        frees = st.get("free_lists")
        if frees is None:
            frees = [st["free_list"]]
        if len(frees) != self._n_shards:
            raise ValueError(
                f"state holds {len(frees)} page arenas; this store has "
                f"{self._n_shards}"
            )
        want = (self._n_shards * self.shard_pages, self.config.page_size)
        if pool.shape != want:
            raise ValueError(
                f"state pool has shape {pool.shape}; this store's is "
                f"{want}"
            )
        table = np.array(st["page_table"], dtype=np.int32, copy=True)
        if table.ndim != 2 or table.shape[1] != self.pages_per_row:
            raise ValueError(f"state page_table has shape {table.shape}")
        if table.shape[0] % self._n_shards:
            raise ValueError(
                f"state page_table of {table.shape[0]} rows does not split "
                f"over the {self._n_shards}-way metric axis")
        row_codec = np.array(st["row_codec"], dtype=np.int8, copy=True)
        if row_codec.shape != (table.shape[0],):
            raise ValueError(f"state row_codec has shape {row_codec.shape}")
        self.num_metrics = table.shape[0]
        self.rows_per_shard = self.num_metrics // self._n_shards
        self.page_table, self.row_codec = table, row_codec
        self._free = [np.asarray(f, dtype=np.int32).copy() for f in frees]
        self._free_n = [len(f) for f in self._free]
        self.allocated_pages = int(st["allocated_pages"])
        base = self._shard * self.shard_pages
        self._pool.copy_(torch.from_numpy(pool[base:base + self.shard_pages]))
        with self._lock:
            self._host_spill = {}
        spill = dict(st["host_spill"])
        if spill:
            keys = np.array(list(spill), dtype=np.int64).reshape(-1, 2)
            self._spill_add(keys[:, 0], keys[:, 1],
                            np.array(list(spill.values()), dtype=np.int64))
        self._drop_mirror()
