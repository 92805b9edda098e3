"""K3: weighted scatter of packed (id, codec_bucket, count) triples — the
device step of the sparse transport (counterpart of
``loghisto_tpu/ops/sparse_ingest.py``).

The sparse transport folds each flush on the host (ops/fold.py) into
unique cells, so the device adds O(cells) weighted rows and runs no
codec.  ``sparse_ingest_batch`` is the plain version (the math of
``make_packed_ingest_fn``); ``sparse_ingest`` launches the Hopper kernel
(``csrc/sparse_ingest.cu``: one thread and one ``atomicAdd`` per triple)
on CUDA tensors and takes the plain version on CPU tensors.  The TPU
kernel's per-cell VMEM row round trip existed only because a serial
grid is how a TPU adds duplicate cells exactly; atomics do that here.

Pad rows use id -1 and drop.  Buckets clip to +/-bucket_limit.  Callers
route counts >= 2^30 to the exact host spill first, so the int32 count
column cannot overflow.  ``acc`` is updated IN PLACE and returned.
"""

from __future__ import annotations

import torch

from loghisto_tpu_torch.ops.backend import is_plain, launch, resolve_device
from loghisto_tpu_torch.ops.fused_ingest import check_acc
from loghisto_tpu_torch.ops.ingest import weighted_ingest_batch


def _check_packed(acc, packed):
    if packed.ndim != 2 or packed.shape[1] != 3:
        raise ValueError(
            f"packed must be [n, 3] (id, bucket, count); "
            f"got {tuple(packed.shape)}"
        )
    if packed.dtype != torch.int32:
        raise ValueError(f"packed must be int32; got {packed.dtype}")
    if packed.device != acc.device:
        raise ValueError(
            f"acc and packed must share one device; got {acc.device} and "
            f"{packed.device}"
        )
    return packed.contiguous()


def sparse_ingest_batch(
    acc: torch.Tensor, packed: torch.Tensor, bucket_limit: int
) -> torch.Tensor:
    """Plain version: weighted scatter-add of packed triples, in place."""
    packed = _check_packed(acc, packed)
    return weighted_ingest_batch(
        acc, packed[:, 0], packed[:, 1], packed[:, 2], bucket_limit
    )


def sparse_ingest(
    acc: torch.Tensor, packed: torch.Tensor, bucket_limit: int
) -> torch.Tensor:
    """Kernel wrapper, same contract as ``sparse_ingest_batch``."""
    check_acc(acc, bucket_limit)
    packed = _check_packed(acc, packed)
    if is_plain(acc):
        return sparse_ingest_batch(acc, packed, bucket_limit)
    n = packed.shape[0]
    if n:
        launch(
            "sparse_ingest", acc.data_ptr(), packed.data_ptr(), n,
            acc.shape[0], acc.shape[1], bucket_limit,
        )
    return acc


def make_sparse_ingest_fn(bucket_limit: int, device=None):
    """f(acc int32 [M, B], packed int32 [n, 3]) -> acc on ``device``
    (default the card); host arrays are moved to the device."""
    dev = resolve_device(device)

    def ingest(acc, packed):
        return sparse_ingest(
            acc, torch.as_tensor(packed, device=dev), bucket_limit
        )

    return ingest
