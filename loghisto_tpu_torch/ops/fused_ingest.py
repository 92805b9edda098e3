"""K1: fused raw ingest — codec and scatter-add in one kernel launch
(counterpart of ``loghisto_tpu/ops/fused_ingest.py``).

The Pallas kernel ``_kernel`` sorts and block-pads the raw batch
(``preprocess_values``) and accumulates bf16 one-hot products on the
MXU, because the TPU lacks fast scatter atomics.  The Hopper kernel
(``csrc/fused_ingest.cu``) keeps only what the kernel computes: one
thread per sample runs the float64 codec and ``atomicAdd``s 1 into the
int32 accumulator.  No sort, no padding, no ``M % 8`` row tile.

``fused_ingest_batch`` launches that kernel on CUDA tensors and takes
its plain version, ``ingest_batch`` (re-exported as
``fused_ingest_reference``), on CPU tensors.  ``acc`` is updated IN
PLACE (the JAX step donates it) and returned.

K4f, the direct-to-paged step (``fused_paged_ingest_batch``): raw
(ids, values) straight into the paged pool — codec, clip, codec-encode,
page-translate and scatter in one launch of ``csrc/paged_store.cu``'s
``lh_fused_paged_ingest``.  The JAX step sorts the batch and
segment-sums duplicate cells before its Pallas scatter, because the TPU
kernel's cost grows with unique cells; int32 atomics add duplicates
exactly, so neither the kernel nor the plain version sorts.  The page
table comes page-major, ``[pages_per_row, M]`` (the transpose of the
JAX step's ``[M, pages_per_row]``; ``PagedStore.device_luts`` keeps it),
so that the kernel's page-table gathers fall in contiguous slabs.
"""

from __future__ import annotations

import torch

from loghisto_tpu_torch.config import PRECISION
from loghisto_tpu_torch.ops.backend import is_plain, launch, resolve_device
from loghisto_tpu_torch.ops.ingest import ingest_batch
from loghisto_tpu_torch.ops.ingest import ingest_batch as fused_ingest_reference  # noqa: F401


def check_acc(acc: torch.Tensor, bucket_limit: int) -> None:
    if acc.ndim != 2:
        raise ValueError(f"acc must be [M, B]; got shape {tuple(acc.shape)}")
    if acc.dtype != torch.int32:
        raise ValueError(f"acc must be int32; got {acc.dtype}")
    if acc.shape[1] != 2 * bucket_limit + 1:
        raise ValueError(
            f"acc has {acc.shape[1]} buckets but bucket_limit={bucket_limit} "
            f"implies {2 * bucket_limit + 1}"
        )
    if not acc.is_contiguous():
        raise ValueError("acc must be contiguous (the kernel indexes it flat)")


def check_values(acc, values):
    """Validate a 1-D value batch against ``acc``; returns it contiguous,
    float64 cast to float32 (as JAX canonicalizes it)."""
    if values.ndim != 1:
        raise ValueError(f"values must be 1-D; got {tuple(values.shape)}")
    if values.dtype == torch.float64:
        values = values.to(torch.float32)
    if values.dtype != torch.float32:
        raise ValueError(f"values must be float32; got {values.dtype}")
    if values.device != acc.device:
        raise ValueError(
            f"acc and values must share one device; got {acc.device} and "
            f"{values.device}"
        )
    return values.contiguous()


def check_samples(acc, ids, values):
    """Validate a raw (ids, values) batch against ``acc``; returns both
    contiguous, values as float32."""
    values = check_values(acc, values)
    if ids.shape != values.shape:
        raise ValueError(
            f"ids and values must have one shape; got {tuple(ids.shape)} "
            f"and {tuple(values.shape)}"
        )
    if ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32; got {ids.dtype}")
    if ids.device != acc.device:
        raise ValueError(
            f"acc and ids must share one device; got {acc.device} and "
            f"{ids.device}"
        )
    return ids.contiguous(), values


def fused_ingest_batch(
    acc: torch.Tensor,
    ids: torch.Tensor,
    values: torch.Tensor,
    bucket_limit: int,
    precision: int = PRECISION,
) -> torch.Tensor:
    """acc int32 [M, B] (B = 2*bl+1) += the batch, in place; one kernel
    launch on a CUDA tensor, the plain scatter on a CPU tensor."""
    check_acc(acc, bucket_limit)
    ids, values = check_samples(acc, ids, values)
    if is_plain(acc):
        return ingest_batch(acc, ids, values, bucket_limit, precision)
    n = ids.shape[0]
    if n:
        launch(
            "fused_ingest", acc.data_ptr(), ids.data_ptr(), values.data_ptr(),
            n, acc.shape[0], acc.shape[1], bucket_limit, precision,
        )
    return acc


def check_paged_operands(pool, ids, values, row_codec, enc_luts,
                         page_table, bucket_limit):
    """Validate the operands of the direct-to-paged step; returns them
    contiguous (values as float32)."""
    from loghisto_tpu_torch.ops.paged_store import check_pool

    check_pool(pool)
    ids, values = check_samples(pool, ids, values)
    if page_table.ndim != 2:
        raise ValueError(
            f"page_table must be page-major [pages_per_row, M]; got "
            f"{tuple(page_table.shape)}"
        )
    if enc_luts.ndim != 2 or enc_luts.shape[1] != 2 * bucket_limit + 1:
        raise ValueError(
            f"enc_luts must be [codecs, {2 * bucket_limit + 1}]; got "
            f"{tuple(enc_luts.shape)}"
        )
    if row_codec.shape != (page_table.shape[1],):
        raise ValueError(
            f"row_codec must be [{page_table.shape[1]}]; got "
            f"{tuple(row_codec.shape)}"
        )
    for name, t in (("row_codec", row_codec), ("enc_luts", enc_luts),
                    ("page_table", page_table)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32; got {t.dtype}")
        if t.device != pool.device:
            raise ValueError(
                f"{name} on {t.device}, pool on {pool.device}: one device"
            )
    return (ids, values, row_codec.contiguous(), enc_luts.contiguous(),
            page_table.contiguous())


def fused_paged_ingest_reference(
    pool, ids, values, row_codec, enc_luts, page_table, bucket_limit,
    precision=PRECISION,
):
    """Plain version of K4f, in place: compress -> clip -> encode ->
    translate (``page_table`` page-major, [pages_per_row, M]) -> scatter
    with torch ops.  Samples drop for an id outside
    [0, M), a row with no codec (-1), or a page that is unmapped (-1) or
    the zero page; ``index_put_(accumulate=True)`` adds duplicates."""
    from loghisto_tpu_torch.ops.ingest import bucket_indices
    from loghisto_tpu_torch.ops.paged_store import ZERO_SLOT

    pages, page_size = pool.shape
    pages_per_row, num_metrics = page_table.shape
    dense = bucket_indices(values, bucket_limit, precision).long()
    valid = (ids >= 0) & (ids < num_metrics)
    row = torch.where(valid, ids, torch.zeros_like(ids)).long()
    codec = row_codec[row]
    valid &= (codec >= 0) & (codec < enc_luts.shape[0])
    storage = enc_luts[torch.clamp(codec, 0, enc_luts.shape[0] - 1).long(),
                       dense].long()
    page_idx = torch.div(storage, page_size, rounding_mode="floor")
    valid &= (storage >= 0) & (page_idx < pages_per_row)
    page_idx = torch.clamp(page_idx, 0, pages_per_row - 1)
    slot = page_table[page_idx, row].long()
    valid &= (slot > ZERO_SLOT) & (slot < pages)
    flat = slot * page_size + (storage - page_idx * page_size)
    flat = flat[valid]
    pool.view(-1).index_put_(
        (flat,), torch.ones_like(flat, dtype=torch.int32), accumulate=True
    )
    return pool


def fused_paged_ingest_batch(
    pool: torch.Tensor,
    ids: torch.Tensor,
    values: torch.Tensor,
    row_codec: torch.Tensor,
    enc_luts: torch.Tensor,
    page_table: torch.Tensor,
    bucket_limit: int,
    precision: int = PRECISION,
) -> torch.Tensor:
    """K4f wrapper: pool int32 [P, page_size] += the raw batch, in
    place.  ``row_codec`` int32 [M], ``enc_luts`` int32 [C, B] and
    ``page_table`` int32 [pages_per_row, M] (page-major) are PagedStore's
    device mirrors (``PagedStore.device_luts``).  One kernel launch on
    CUDA tensors, the plain version on CPU tensors."""
    ids, values, row_codec, enc_luts, page_table = check_paged_operands(
        pool, ids, values, row_codec, enc_luts, page_table, bucket_limit
    )
    if is_plain(pool):
        return fused_paged_ingest_reference(
            pool, ids, values, row_codec, enc_luts, page_table,
            bucket_limit, precision,
        )
    n = ids.shape[0]
    if n:
        launch(
            "fused_paged_ingest", pool.data_ptr(), ids.data_ptr(),
            values.data_ptr(), n, row_codec.data_ptr(), enc_luts.data_ptr(),
            page_table.data_ptr(), page_table.shape[1], enc_luts.shape[0],
            page_table.shape[0], pool.shape[0], pool.shape[1], bucket_limit,
            precision,
        )
    return pool


def make_fused_ingest_fn(bucket_limit: int, precision: int = PRECISION,
                         device=None):
    """f(acc [M, B], ids [N], values [N]) -> acc on ``device`` (default
    the card): one kernel launch per call.  Host arrays are moved to the
    device."""
    dev = resolve_device(device)

    def ingest(acc, ids, values):
        return fused_ingest_batch(
            acc, torch.as_tensor(ids, device=dev),
            torch.as_tensor(values, device=dev), bucket_limit, precision,
        )

    return ingest
