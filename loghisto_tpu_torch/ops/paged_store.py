"""K4: paged bucket storage — the page pool's weighted scatter and the
paged snapshot query (counterpart of ``loghisto_tpu/ops/paged_store.py``).

The dense ``[M, B]`` accumulator becomes

  * a **page pool** ``[P, page_size]`` int32 on the device — fixed-size
    bucket pages allocated on demand, slot 0 reserved as the
    permanently-zero page, so an unmapped page reads as zeros without a
    mask;
  * a host **page table** ``[M, pages_per_row]`` int32 mapping each
    (row, page of the row's storage axis) to a pool slot, -1 unmapped
    (loghisto_tpu_torch/paging.py owns it).

The host translates packed ``(row, codec_bucket, count)`` cells into
``(slot, offset, count)`` triples against the table; the device adds
them into the pool.  ``paged_scatter_batch`` is the plain version (the
JAX jnp tier's math); ``paged_scatter`` launches the Hopper kernel
(``csrc/paged_store.cu``: one thread and one ``atomicAdd`` per triple)
on CUDA tensors and takes the plain version on CPU tensors.  The TPU
kernel round-trips a whole page through VMEM by DMA per cell on a serial
grid, because that is how a TPU adds duplicate cells exactly; int32
atomics do that here, so neither the serial grid nor the padding to
the Pallas triple tile is carried over.

The pool is updated IN PLACE (the JAX step donates it) and returned.
Slots <= 0 (the zero page, pads) and >= P drop; offsets clip to
[0, page_size - 1].
"""

from __future__ import annotations

import numpy as np
import torch

from loghisto_tpu_torch.config import PRECISION
from loghisto_tpu_torch.ops.backend import is_plain, launch

# Buckets per page: 256 int32 = 1 KiB.  At B = 8193 a dense row is 33
# pages, so one latency band of a few hundred buckets costs 1-3 pages
# instead of a 32 KiB dense row.  (ops/dispatch.PAGE_SIZE mirrors it.)
PAGE_SIZE = 256

# Reserved pool slot: permanently zero, never allocated, never written.
ZERO_SLOT = 0

# Commit launch width: every paged commit pads its translated triples to
# a multiple of this, as the JAX store does for its one executable.  The
# kernel needs no fixed width; the padding is kept so both stores ship
# the same wire (and the smoke run holds K4 against pads).
COMMIT_CHUNK = 1 << 14


def validate_pool_shape(pool_pages: int, page_size: int) -> None:
    """Construction-time guard, with the JAX package's ValueErrors, so a
    configuration is valid in both packages or in neither."""
    if page_size < 128 or page_size % 128:
        raise ValueError(
            f"page_size must be a positive multiple of 128 (TPU lane "
            f"alignment); got {page_size}"
        )
    if pool_pages < 2:
        raise ValueError(
            f"pool needs >= 2 pages (slot 0 is the reserved zero page); "
            f"got {pool_pages}"
        )
    if pool_pages * page_size >= 2**31 - 2:
        raise ValueError(
            f"pool of {pool_pages} x {page_size} buckets overflows the "
            "flat int32 cell index; shrink the pool or the page"
        )


def check_pool(pool: torch.Tensor) -> None:
    if pool.ndim != 2 or pool.dtype != torch.int32:
        raise ValueError(
            f"pool must be int32 [P, page_size]; got {pool.dtype} "
            f"{tuple(pool.shape)}"
        )
    if not pool.is_contiguous():
        raise ValueError("pool must be contiguous (the kernel indexes it flat)")


def _check_packed(pool, packed):
    if packed.ndim != 2 or packed.shape[1] != 3:
        raise ValueError(
            f"packed must be [n, 3] (slot, offset, count); "
            f"got {tuple(packed.shape)}"
        )
    if packed.dtype != torch.int32:
        raise ValueError(f"packed must be int32; got {packed.dtype}")
    if packed.device != pool.device:
        raise ValueError(
            f"pool and packed must share one device; got {pool.device} "
            f"and {packed.device}"
        )
    return packed.contiguous()


def paged_scatter_batch(pool: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Plain version: weighted scatter-add of translated ``(slot, offset,
    count)`` triples into the pool, in place."""
    check_pool(pool)
    packed = _check_packed(pool, packed)
    pages, page_size = pool.shape
    slots = packed[:, 0].long()
    offs = torch.clamp(packed[:, 1], 0, page_size - 1).long()
    valid = (slots > ZERO_SLOT) & (slots < pages)
    flat = slots[valid] * page_size + offs[valid]
    pool.view(-1).index_put_((flat,), packed[valid, 2], accumulate=True)
    return pool


def paged_scatter(pool: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """K4 wrapper, same contract as ``paged_scatter_batch``: one kernel
    launch on a CUDA tensor, the plain version on a CPU tensor."""
    check_pool(pool)
    packed = _check_packed(pool, packed)
    if is_plain(pool):
        return paged_scatter_batch(pool, packed)
    n = packed.shape[0]
    if n:
        launch(
            "paged_scatter", pool.data_ptr(), packed.data_ptr(), n,
            pool.shape[0], pool.shape[1],
        )
    return pool


def gather_storage_rows(
    pool: torch.Tensor, table_rows: torch.Tensor, storage_buckets: int
) -> torch.Tensor:
    """Reassemble STORAGE-axis rows from mapped pages: table_rows int32
    [n, pages_per_row] (pool slots, -1 unmapped) -> int32
    [n, storage_buckets].  Unmapped entries clamp onto the zero page."""
    pages = pool[torch.clamp(table_rows.long(), min=ZERO_SLOT)]
    n, ppr, page = pages.shape
    return pages.reshape(n, ppr * page)[:, :storage_buckets]


def paged_query(
    pool: torch.Tensor,
    table_rows: torch.Tensor,
    dec_lut: torch.Tensor,
    ps,
    bucket_limit: int,
    precision: int = PRECISION,
) -> dict:
    """Paged snapshot query on the pool's device: gather the requested
    rows' pages, expand each storage bucket onto its representative
    native bucket through the codec's decode LUT (an exact integer
    scatter — decode LUTs are injective), then the dense engine's
    ``snapshot_row_stats`` over the exact int32 CDF."""
    from loghisto_tpu_torch.ops.stats import row_sums, snapshot_row_stats

    device = pool.device
    num_buckets = 2 * bucket_limit + 1
    dec = torch.as_tensor(dec_lut, device=device).long()
    storage = gather_storage_rows(
        pool, torch.as_tensor(table_rows, device=device), dec.shape[0]
    )
    native = torch.zeros(
        (storage.shape[0], num_buckets), dtype=torch.int32, device=device
    )
    native.index_add_(1, dec, storage)
    cdf = torch.cumsum(native, dim=1, dtype=torch.int32)
    counts = cdf[:, -1].contiguous()
    sums = row_sums(native, bucket_limit, precision)
    return snapshot_row_stats(
        cdf, counts, sums, np.asarray(ps, dtype=np.float32), bucket_limit,
        precision,
    )
