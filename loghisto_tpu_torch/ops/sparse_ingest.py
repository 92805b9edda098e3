"""K3: weighted scatter of packed (id, codec_bucket, count) triples — the
device step of the sparse transport, the retention push and the fused
commit (counterpart of ``loghisto_tpu/ops/sparse_ingest.py``).

The sparse transport folds each flush on the host (ops/fold.py) into
unique cells, so the device adds O(cells) weighted rows and runs no
codec.  ``sparse_ingest_batch`` is the plain version (the math of
``make_packed_ingest_fn``).  ``sparse_ingest_multi`` adds one triple
array into several accumulators that share B: on CUDA tensors it is one
launch of the Hopper kernel (``csrc/sparse_ingest.cu``: each triple read
once, one ``atomicAdd`` per touched cell of each target) for up to
``MAX_TARGETS`` targets, and on CPU tensors
``sparse_ingest_multi_batch``, the plain version once per target.
``sparse_ingest`` is its one-target case.  The TPU kernel's per-cell
VMEM row round trip existed only because a serial grid is how a TPU adds
duplicate cells exactly; atomics do that here.

Pad rows use id -1 and drop; each target keeps the ids in ``[0, M_t)``
of its own row count.  Buckets clip to +/-bucket_limit.  Callers route
counts >= 2^30 to the exact host spill first, so the int32 count column
cannot overflow.  Targets are updated IN PLACE.
"""

from __future__ import annotations

import ctypes

import torch

from loghisto_tpu_torch.ops.backend import is_plain, launch, resolve_device
from loghisto_tpu_torch.ops.fused_ingest import check_acc
from loghisto_tpu_torch.ops.ingest import weighted_ingest_batch

# targets one launch takes (the kernel's argument block); more take
# several launches
MAX_TARGETS = 8


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


def sparse_ingest_multi_batch(targets, packed: torch.Tensor,
                              bucket_limit: int):
    """Plain version of ``sparse_ingest_multi``: ``sparse_ingest_batch``
    once per target, in place.  Returns ``targets``."""
    for acc in targets:
        sparse_ingest_batch(acc, packed, bucket_limit)
    return targets


def sparse_ingest_multi(targets, packed: torch.Tensor, bucket_limit: int):
    """Scatter ``packed`` int32 [n, 3] into every int32 ``[M_t, B]``
    target (contiguous, on ``packed``'s device, B = 2 * bucket_limit + 1),
    in place: one K3 launch for up to ``MAX_TARGETS`` targets on CUDA
    tensors, the plain version on CPU tensors.  Returns ``targets``."""
    targets = list(targets)
    if not targets:
        raise ValueError("sparse_ingest_multi needs at least one target")
    for acc in targets:
        check_acc(acc, bucket_limit)
        packed = _check_packed(acc, packed)
    if is_plain(packed, "sparse_ingest"):
        return sparse_ingest_multi_batch(targets, packed, bucket_limit)
    n = packed.shape[0]
    if n:
        for i in range(0, len(targets), MAX_TARGETS):
            group = targets[i:i + MAX_TARGETS]
            ptrs = (ctypes.c_void_p * len(group))(
                *(acc.data_ptr() for acc in group))
            rows = (ctypes.c_int * len(group))(
                *(acc.shape[0] for acc in group))
            launch("sparse_ingest", ptrs, rows, len(group),
                   packed.data_ptr(), n, 2 * bucket_limit + 1, bucket_limit)
    return targets


def sparse_ingest(
    acc: torch.Tensor, packed: torch.Tensor, bucket_limit: int
) -> torch.Tensor:
    """Kernel wrapper, same contract as ``sparse_ingest_batch``: the
    one-target case of ``sparse_ingest_multi``."""
    sparse_ingest_multi((acc,), packed, bucket_limit)
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
