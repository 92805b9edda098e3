"""K2: the single-metric row histogram (counterpart of
``loghisto_tpu/ops/pallas_kernels.py``; renamed because a PyTorch
package has no Pallas).

Two entry points share one Hopper kernel (``csrc/row_ingest.cu``):

  * ``histogram_row(acc_row, values)`` — K2a, ``pallas_histogram_row``:
    every value lands in the int32 [B] row.
  * ``row_ingest_batch(acc, ids, values)`` — K2b,
    ``pallas_row_ingest_batch``: the [1, B] accumulator of the uniform
    ``f(acc, ids, values)`` contract; samples with id != 0 drop.

The kernel buckets each value with an exact float32 codec (a float32
estimate, corrected against ``ops/codec.bucket_thresholds`` near a
bucket edge; the table is built once per ``(bucket_limit, precision)``
and kept on the device), adds into one shared-memory histogram a block,
and sums a cluster's histograms in distributed shared memory before one
global atomic per live bin; the bf16 one-hot MXU tiles and the float32
VMEM scratch of the TPU kernels are not carried over.  The reference
refuses N % 2048 != 0 (K2a) and N >= 2^24 per call (both) because of
its tiles and its float32 scratch.
The CUDA kernel needs neither bound; the wrappers keep the same
``ValueError``s so that both packages refuse the same inputs.

Rows are updated IN PLACE and returned.  CPU tensors take the plain
version (``ingest_batch`` on the masked samples).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from loghisto_tpu_torch.config import PRECISION
from loghisto_tpu_torch.ops.backend import is_plain, launch, resolve_device
from loghisto_tpu_torch.ops.codec import bucket_thresholds
from loghisto_tpu_torch.ops.fused_ingest import (
    check_acc,
    check_samples,
    check_values,
)
from loghisto_tpu_torch.ops.ingest import bucket_indices

SAMPLE_TILE = 2048
MAX_SAMPLES_PER_CALL = 1 << 24


def histogram_row_reference(acc_row, values, bucket_limit, precision,
                            ids=None):
    """Plain version of both entry points: acc_row int32 [B] += the
    histogram of ``values`` (of the samples whose id is 0, given ids)."""
    cols = bucket_indices(values, bucket_limit, precision)
    if ids is not None:
        cols = cols[ids == 0]
    acc_row += torch.bincount(
        cols.long(), minlength=acc_row.shape[0]
    ).to(torch.int32)
    return acc_row


@functools.lru_cache(maxsize=None)
def threshold_table(bucket_limit: int, precision: int,
                    device: torch.device) -> torch.Tensor:
    """``bucket_thresholds`` as a float32 tensor on ``device``, built
    once per (bucket_limit, precision, device)."""
    return torch.from_numpy(bucket_thresholds(bucket_limit, precision)).to(
        device)


def _launch_row(acc_row, ids, values, bucket_limit, precision):
    """Launch K2 on a [B] row or a [1, B] accumulator."""
    n = values.shape[0]
    if n:
        table = threshold_table(bucket_limit, precision, acc_row.device)
        launch(
            "row_ingest", acc_row.data_ptr(),
            None if ids is None else ids.data_ptr(), values.data_ptr(),
            table.data_ptr(), n, acc_row.shape[-1], bucket_limit, precision,
        )


def device_blocks(n: int, num_buckets: int, device_index: int = 0) -> int:
    """Blocks (whole clusters of 8) of a masked K2 launch over ``n``
    samples on CUDA device ``device_index``, from the kernel's own launch
    plan (``lh_row_ingest_blocks``)."""
    from loghisto_tpu_torch.ops import _build

    fn = _build.helper("row_ingest", "lh_row_ingest_blocks",
                       [ctypes.c_longlong, ctypes.c_int])
    with torch.cuda.device(device_index):
        blocks = fn(n, num_buckets)
    if blocks < 0:
        raise RuntimeError(f"lh_row_ingest_blocks failed: CUDA error "
                           f"{-blocks}")
    return blocks


def codec_check(start: int, count: int, bucket_limit: int,
                precision: int = PRECISION, device=None):
    """K2's table codec against the float64 codec of ``csrc/codec.cuh``
    on the float32 bit patterns ``start .. start + count - 1``, on the
    card: returns (patterns on which they differ, patterns that read
    the table).  A check, not a kernel of any path: no launch count."""
    from loghisto_tpu_torch.ops import _build

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("codec_check runs the card's codecs: needs CUDA")
    table = threshold_table(bucket_limit, precision, dev)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    fn = _build.helper("row_ingest", "lh_row_codec_check", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    rc = fn(table.data_ptr(), start, count, bucket_limit, precision,
            counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"lh_row_codec_check failed: CUDA error {rc} "
                           f"({_build.error_string('row_ingest', rc)})")
    mismatches, table_reads = counts.tolist()
    return mismatches, table_reads


def histogram_row(
    acc_row: torch.Tensor,
    values: torch.Tensor,
    bucket_limit: int,
    precision: int = PRECISION,
) -> torch.Tensor:
    """acc_row int32 [B] += histogram(values), in place.  N must be a
    multiple of 2048 and below 2^24, as the reference requires."""
    if acc_row.ndim != 1:
        raise ValueError(f"acc_row must be [B]; got {tuple(acc_row.shape)}")
    check_acc(acc_row[None, :], bucket_limit)
    n = values.shape[0]
    if n % SAMPLE_TILE:
        raise ValueError(f"N={n} must be a multiple of {SAMPLE_TILE}")
    if n >= MAX_SAMPLES_PER_CALL:
        raise ValueError(
            f"N={n} >= 2^24: the float32 scratch would silently saturate; "
            "split the batch across calls"
        )
    values = check_values(acc_row[None, :], values)
    if is_plain(acc_row, "row_ingest"):
        return histogram_row_reference(acc_row, values, bucket_limit, precision)
    _launch_row(acc_row, None, values, bucket_limit, precision)
    return acc_row


def row_ingest_batch(
    acc: torch.Tensor,
    ids: torch.Tensor,
    values: torch.Tensor,
    bucket_limit: int,
    precision: int = PRECISION,
) -> torch.Tensor:
    """acc int32 [1, B] += the samples with id 0, in place.  Ragged N is
    fine; N rounded up to 2048 must stay below 2^24, as in the
    reference."""
    if acc.ndim != 2 or acc.shape[0] != 1:
        raise ValueError(
            f"pallas row path needs a single-metric [1, B] accumulator; "
            f"got shape {tuple(acc.shape)}"
        )
    check_acc(acc, bucket_limit)
    ids, values = check_samples(acc, ids, values)
    n = values.shape[0]
    if n + (-n) % SAMPLE_TILE >= MAX_SAMPLES_PER_CALL:
        raise ValueError(
            f"N={n} >= 2^24: the float32 scratch would silently saturate; "
            "split the batch across calls"
        )
    if is_plain(acc, "row_ingest"):
        histogram_row_reference(acc[0], values, bucket_limit, precision, ids)
        return acc
    _launch_row(acc, ids, values, bucket_limit, precision)
    return acc


def make_row_ingest(num_buckets: int, bucket_limit: int,
                    precision: int = PRECISION, device=None):
    """f(acc_row [B], values [N]) -> acc_row on ``device`` (default the
    card), one kernel launch per call."""
    if num_buckets != 2 * bucket_limit + 1:
        raise ValueError(
            f"num_buckets={num_buckets} but bucket_limit={bucket_limit} "
            f"implies {2 * bucket_limit + 1}"
        )
    dev = resolve_device(device)

    def ingest(acc_row, values):
        return histogram_row(
            acc_row, torch.as_tensor(values, device=dev), bucket_limit,
            precision,
        )

    return ingest
