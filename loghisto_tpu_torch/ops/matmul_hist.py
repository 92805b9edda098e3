"""One-hot matrix-product histogram accumulation (counterpart of
``loghisto_tpu/ops/matmul_hist.py``).

    flat   = id * num_buckets + bucket            (flat cell index)
    hi, lo = flat // 128, flat % 128              (tile decomposition)
    counts[hi, lo] += onehot(hi)^T @ onehot(lo)   per CHUNK of samples

The JAX package computes the product outside any Pallas kernel (XLA's
dot on the MXU), so here it is ``torch.matmul`` on the tensor's device.
One departure in type: JAX multiplies bfloat16 one-hots into a float32
product; ``torch.matmul`` on bfloat16 returns bfloat16, which rounds
every count above 256, so the operands here are float32 (0 and 1 are
exact in it, and in TF32).  Each CHUNK's product holds at most 4096
counts per cell, exact in float32, and is added into an int32 count
tensor, so the result is exact at any batch size.  It materialises a
[CHUNK, ceil(M * B / 128)] one-hot: a path for small M, as in JAX.
``acc`` is updated IN PLACE.
"""

from __future__ import annotations

import torch

from loghisto_tpu_torch.config import PRECISION
from loghisto_tpu_torch.ops.backend import resolve_device
from loghisto_tpu_torch.ops.ingest import bucket_indices, sanitize_ids

LANES = 128
CHUNK = 4096  # samples per one-hot product; bounds the [CHUNK, H] one-hot


def one_hot_f32(idx: torch.Tensor, width: int) -> torch.Tensor:
    """float32 [len(idx), width] one-hot; an index equal to ``width``
    (the drop slot) gives an all-zero row."""
    out = torch.zeros((idx.shape[0], width + 1), dtype=torch.float32,
                      device=idx.device)
    out.scatter_(1, idx.view(-1, 1), 1.0)
    return out[:, :width]


def ingest_batch_matmul(
    acc: torch.Tensor,
    ids: torch.Tensor,
    values: torch.Tensor,
    bucket_limit: int,
    precision: int = PRECISION,
) -> torch.Tensor:
    """Accumulate one (ids, values) batch into acc [M, B] in place by
    one-hot products; out-of-range ids drop."""
    m, b = acc.shape
    h = (m * b + LANES - 1) // LANES
    flat = (ids.long() * b
            + bucket_indices(values, bucket_limit, precision).long())
    valid = sanitize_ids(ids, m)
    hi = torch.where(valid, flat // LANES, h)  # h: the drop slot
    lo = torch.where(valid, flat % LANES, 0)
    counts = torch.zeros((h, LANES), dtype=torch.int32, device=acc.device)
    for off in range(0, hi.shape[0], CHUNK):
        partial = torch.matmul(
            one_hot_f32(hi[off:off + CHUNK], h).T,
            one_hot_f32(lo[off:off + CHUNK], LANES),
        )
        counts += partial.to(torch.int32)
    acc.view(-1).add_(counts.view(-1)[: m * b])
    return acc


def make_matmul_ingest_fn(bucket_limit: int, precision: int = PRECISION,
                          device=None):
    """f(acc, ids, values) -> acc (in place) through the one-hot product
    on ``device`` (default the card)."""
    dev = resolve_device(device)

    def ingest(acc, ids, values):
        return ingest_batch_matmul(
            acc, torch.as_tensor(ids, device=dev),
            torch.as_tensor(values, device=dev), bucket_limit, precision,
        )

    return ingest
