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
PLACE (the JAX step donates it) and returned.  The direct-to-paged
fused step of the JAX module belongs to the paged slice.
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
