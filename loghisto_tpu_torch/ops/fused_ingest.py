"""K1: fused raw ingest — codec and scatter-add in one kernel launch
(counterpart of ``loghisto_tpu/ops/fused_ingest.py``).

The Pallas kernel ``_kernel`` sorts and block-pads the raw batch
(``preprocess_values``) and accumulates bf16 one-hot products on the
MXU, because the TPU lacks fast scatter atomics.  The Hopper kernel
(``csrc/fused_ingest.cu``) keeps only what the kernel computes: the
float64 codec and an int32 add per sample, no sort, no padding, no
``M % 8`` row tile.  A persistent grid of blocks each takes one
contiguous chunk of the batch.  Samples of a row that several lanes of
a warp hold (the hot rows of skewed ids) go into a cell table shared by
a cluster of blocks, which adds each filled slot to the accumulator
with one global atomic at the end; the rest go straight to global
atomics.  A hot cell then costs one global add per cluster instead of
one per sample.  ``plan_fused_ingest`` sizes the grid, the chunk, the
table, the shared memory and the key width; it is plain Python so that
the CPU tests reach it (``device_plan`` adds the card's SM count and
cluster occupancy).

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

On a ("stream", "metric") mesh (ROADMAP D12) K4f runs per rank:
``PagedStore.ingest_raw`` keeps the ids of the rank's row block and
launches K4f on its metric shard's arena with the block's mirrors, an
ordinary launch on the rank's own card (D8).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from loghisto_tpu_torch.config import PRECISION
from loghisto_tpu_torch.ops.backend import is_plain, launch, resolve_device
from loghisto_tpu_torch.ops.ingest import ingest_batch
from loghisto_tpu_torch.ops.ingest import ingest_batch as fused_ingest_reference  # noqa: F401


# K1's launch plan.  csrc/fused_ingest.cu runs 512 threads a block, 4
# samples a thread a pass, in clusters of 8 blocks whose cell tables
# hold at most 2**12 slots each; 2 blocks an SM were chosen on the card
# (PERF.md).
K1_THREADS = 512
K1_MIN_CHUNK = K1_THREADS * 4
K1_CLUSTER = 8
K1_BLOCKS_PER_SM = 2
K1_MIN_TABLE_LOG2 = 8
K1_MAX_TABLE_LOG2 = 12
# 227 KB: the most dynamic shared memory a Hopper block can opt in to
K1_MAX_SHARED_BYTES = 232_448


class FusedIngestPlan(NamedTuple):
    blocks: int       # one contiguous chunk of the batch each
    chunk: int        # samples a block (the last block may take fewer)
    table_log2: int   # the block's cell table has 2**table_log2 slots
    key_bits: int     # 32 while M * B < 2**31, else 64
    shared_bytes: int  # dynamic shared memory a block: at least its table
    #                    (a key and an int32 count a slot) and the share of
    #                    an SM that keeps it to K1_BLOCKS_PER_SM blocks


def k1_key_bits(num_metrics: int, num_buckets: int) -> int:
    """Width of K1's table keys (the flat cell ``id * B + col``): 32 bits
    while every cell index and the empty key 2**32 - 1 fit, 64 from
    M * B >= 2**31 on (an explicitly dense accumulator can be that
    large)."""
    return 64 if num_metrics * num_buckets >= 2**31 else 32


def plan_fused_ingest(n: int, num_metrics: int, num_buckets: int,
                      sm_count: int, resident_clusters: int | None = None,
                      ) -> FusedIngestPlan:
    """Grid, chunk and table of one K1 launch over ``n`` samples: at
    most ``K1_BLOCKS_PER_SM`` blocks an SM and at least one pass of a
    block (``K1_MIN_CHUNK`` samples) a block, the blocks whole clusters
    and, given ``resident_clusters`` (the clusters the card holds at
    once), no more than those: a cluster left for a second wave would
    run its chunks after the rest.  The table holds twice the chunk,
    between 2**K1_MIN_TABLE_LOG2 and 2**K1_MAX_TABLE_LOG2 slots (cells
    that find no slot go to the global atomics)."""
    if n < 0 or sm_count < 1 or (resident_clusters is not None
                                 and resident_clusters < 1):
        raise ValueError(
            f"bad K1 plan input: n={n}, sm_count={sm_count}, "
            f"resident_clusters={resident_clusters}"
        )
    key_bits = k1_key_bits(num_metrics, num_buckets)
    blocks = min(sm_count * K1_BLOCKS_PER_SM, -(-n // K1_MIN_CHUNK))
    if resident_clusters is not None:
        blocks = min(blocks, resident_clusters * K1_CLUSTER)
    blocks = max(K1_CLUSTER, blocks // K1_CLUSTER * K1_CLUSTER)
    chunk = max(1, -(-n // blocks))
    table_log2 = min(K1_MAX_TABLE_LOG2,
                     max(K1_MIN_TABLE_LOG2, (2 * chunk - 1).bit_length()))
    # more than a 1/(K1_BLOCKS_PER_SM + 1) share of the SM's shared
    # memory: the card places no more blocks an SM than planned, and the
    # occupancy query counts the clusters that fit so
    shared = max((1 << table_log2) * (key_bits // 8 + 4),
                 K1_MAX_SHARED_BYTES // (K1_BLOCKS_PER_SM + 1) + 1)
    return FusedIngestPlan(blocks, chunk, table_log2, key_bits, shared)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of CUDA device ``device_index``."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def resident_clusters(device_index: int, key_bits: int,
                      shared_bytes: int) -> int:
    """Clusters of ``K1_CLUSTER`` K1 blocks of ``shared_bytes`` of
    dynamic shared memory each that CUDA device ``device_index`` holds
    at once (the CUDA occupancy query, built with the kernel)."""
    from loghisto_tpu_torch.ops import _build

    query = _build.helper("fused_ingest", "lh_fused_ingest_clusters",
                          [ctypes.c_int, ctypes.c_longlong])
    with torch.cuda.device(device_index):
        got = query(key_bits, shared_bytes)
    if got <= 0:
        raise RuntimeError(
            f"K1 cluster occupancy query failed: CUDA error {-got}"
        )
    return got


def device_plan(n: int, num_metrics: int, num_buckets: int,
                device_index: int) -> FusedIngestPlan:
    """``plan_fused_ingest`` for CUDA device ``device_index``: its SM
    count and the clusters it holds at once."""
    sms = sm_count(device_index)
    plan = plan_fused_ingest(n, num_metrics, num_buckets, sms)
    return plan_fused_ingest(
        n, num_metrics, num_buckets, sms,
        resident_clusters=resident_clusters(
            device_index, plan.key_bits, plan.shared_bytes))


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
    if is_plain(acc, "fused_ingest"):
        return ingest_batch(acc, ids, values, bucket_limit, precision)
    n = ids.shape[0]
    if n:
        # a CUDA tensor's device always carries its index
        plan = device_plan(n, acc.shape[0], acc.shape[1], acc.device.index)
        launch(
            "fused_ingest", acc.data_ptr(), ids.data_ptr(),
            values.data_ptr(), n, acc.shape[0], acc.shape[1], bucket_limit,
            precision, plan.blocks, plan.chunk, plan.table_log2,
            plan.key_bits, plan.shared_bytes,
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
    if is_plain(pool, "fused_paged_ingest"):
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
