"""Log-bucket value<->index codec (counterpart of
``loghisto_tpu/ops/codec.py``).

Reference contract (metrics.go:316-332):

    compress(v)   = sign(v) * int16(precision * ln(1 + |v|) + 0.5)
    decompress(c) = sign(c) * (e^(|c| / precision) - 1)

The host tier (``compress_np`` and friends) is copied from the JAX
package: float64 NumPy, the Go reference's math, and the arbiter of
which bucket a value belongs to.

The torch tier differs from the JAX device tier on purpose:

  * ``compress`` computes in float64, not float32.  JAX's float32
    ``log1p`` puts about 1 in 12,000 random values, and about half of
    the float32 values next to a bucket edge, one bucket away from
    ``compress_np``; the host fold of the sparse transport uses the
    float64 codec, so in the JAX package the raw and sparse routes can
    bucket one sample differently.  In float64 the port's raw route,
    sparse route, host fold and the CUDA kernels (csrc/codec.cuh) all
    agree with ``compress_np``.  The tests count the JAX departures.
  * ``decompress`` returns float32 representatives, as JAX's does, but
    rounds them once from float64.  JAX computes ``exp`` in float32, and
    XLA's and PyTorch's float32 ``exp`` disagree in the last bit on 846
    of the 8193 default representatives; the float64 route gives the
    same float32 table on every device.

NaN pins to bucket 0; out-of-range buckets saturate at +/-32767.  The
byte-frame codec of the JAX module belongs to federation, a later slice.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from loghisto_tpu_torch.config import INT16_BUCKET_LIMIT, PRECISION


def compress_scalar(value: float, precision: int = PRECISION) -> int:
    """Scalar compress with exact reference semantics (metrics.go:316-322).
    NaN pins to bucket 0, like every other tier."""
    if math.isnan(value):
        return 0
    if math.isinf(value):  # saturate like the vectorized tiers
        return -INT16_BUCKET_LIMIT if value < 0 else INT16_BUCKET_LIMIT
    i = int(precision * math.log1p(abs(value)) + 0.5)  # floor: arg is >= 0
    i = min(i, INT16_BUCKET_LIMIT)
    return -i if value < 0 else i


def decompress_scalar(bucket: int, precision: int = PRECISION) -> float:
    """Scalar decompress with exact reference semantics (metrics.go:326-332)."""
    f = math.exp(abs(bucket) / precision) - 1.0
    return -f if bucket < 0 else f


def compress_np(values: np.ndarray, precision: int = PRECISION) -> np.ndarray:
    """Vectorized compress -> int16 buckets (host tier).  NaN pins to
    bucket 0, like every other tier."""
    values = np.asarray(values, dtype=np.float64)
    values = np.where(np.isnan(values), 0.0, values)
    mag = np.floor(precision * np.log1p(np.abs(values)) + 0.5)
    mag = np.minimum(mag, INT16_BUCKET_LIMIT)
    return np.where(values < 0, -mag, mag).astype(np.int16)


def decompress_np(buckets: np.ndarray, precision: int = PRECISION) -> np.ndarray:
    """Vectorized decompress -> float64 bucket representatives (host tier)."""
    buckets = np.asarray(buckets)
    mag = np.exp(np.abs(buckets).astype(np.float64) / precision) - 1.0
    return np.where(buckets < 0, -mag, mag)


def edge_values(bucket_limit: int, precision: int = PRECISION) -> np.ndarray:
    """Every float32 value at or next to a bucket edge up to
    ``bucket_limit``: for each edge expm1((k - 0.5) / precision), the
    nearest float32 and its two neighbours, both signs, plus 0.0, -0.0
    and the smallest denormal — 6 * bucket_limit + 3 values, the inputs
    on which a float32 codec departs from ``compress_np``."""
    k = np.arange(1, bucket_limit + 1, dtype=np.float64)
    edge = np.expm1((k - 0.5) / precision).astype(np.float32)
    around = np.concatenate([
        np.nextafter(edge, np.float32(0)), edge,
        np.nextafter(edge, np.float32(np.inf)),
    ])
    tiny = np.float32(np.finfo(np.float32).smallest_subnormal)
    return np.concatenate([
        around, -around, np.array([0.0, -0.0, tiny], dtype=np.float32),
    ]).astype(np.float32)


def bucket_thresholds(bucket_limit: int, precision: int = PRECISION) -> np.ndarray:
    """The threshold table of K2's float32 codec: float32
    [bucket_limit + 1] with t[0] = 0 and, for k = 1 .. bucket_limit, t[k]
    the smallest non-negative float32 whose ``compress_np`` bucket is
    >= k (+inf where no finite float32 reaches k).  Each is found by
    stepping over the float32 neighbours of expm1((k - 0.5) /
    precision).  Because ``compress_np`` is monotone in |v|, the
    clipped bucket of v is the number of t[1:] at or below |v|
    (``table_compress``)."""
    if bucket_limit < 1:
        raise ValueError(f"bucket_limit must be >= 1; got {bucket_limit}")
    k = np.arange(1, bucket_limit + 1, dtype=np.int64)
    with np.errstate(over="ignore"):
        t = np.expm1((k - 0.5) / precision).astype(np.float32)
    zero, inf = np.float32(0), np.float32(np.inf)
    while True:  # up while t's bucket is below k
        low = (compress_np(t, precision).astype(np.int64) < k) & (t < inf)
        if not low.any():
            break
        t[low] = np.nextafter(t[low], inf)
    while True:  # down while the float32 below t still reaches k
        below = np.nextafter(t, zero)
        down = (t > 0) & (compress_np(below, precision).astype(np.int64) >= k)
        if not down.any():
            break
        t[down] = below[down]
    return np.concatenate([np.zeros(1, np.float32), t])


def table_compress(values: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """Plain form of K2's table codec -> int32 buckets clipped to
    +/-bucket_limit (``thresholds`` from ``bucket_thresholds``): the
    number of thresholds t[1:] at or below |v|, with v's sign; NaN is
    bucket 0.  Equals ``clip(compress_np(v), -bucket_limit,
    bucket_limit)`` on every float32."""
    v = torch.as_tensor(values).to(torch.float32)
    k = torch.searchsorted(thresholds[1:].to(v.device), v.abs(), right=True)
    k = torch.where(torch.isnan(v), torch.zeros_like(k), k)
    return torch.where(v < 0, -k, k).to(torch.int32)


def compress(values: torch.Tensor, precision: int = PRECISION) -> torch.Tensor:
    """Vectorized compress on the tensor's device -> int32 buckets,
    computed in float64 (equal to ``compress_np`` on every input)."""
    v = torch.as_tensor(values).to(torch.float64)
    v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
    mag = torch.floor(precision * torch.log1p(v.abs()) + 0.5)
    mag = torch.clamp(mag, max=float(INT16_BUCKET_LIMIT))
    return torch.where(v < 0, -mag, mag).to(torch.int32)


def decompress(buckets: torch.Tensor, precision: int = PRECISION) -> torch.Tensor:
    """Vectorized decompress -> float32 representatives, rounded once
    from float64."""
    b = torch.as_tensor(buckets)
    mag = torch.exp(b.abs().to(torch.float64) / precision) - 1.0
    return torch.where(b < 0, -mag, mag).to(torch.float32)
