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

NaN pins to bucket 0; out-of-range buckets saturate at +/-32767.

Only ``table_compress``, ``compress`` and ``decompress`` need torch, and
they import it when called, as the JAX module imports jax inside its
device functions: the host tier and the frame codec load without it, so
the torch-free emitter tier (``federation.emitter``, ``metrics``,
``obs.spans``, ``submitter``) can use them.

The byte-frame codec at the end of the module is the JAX module's,
copied: ``utils/journal.FrameJournal`` writes it, and the federation
wire (``federation/wire.py``) ships the same frames.  A frame written
by either package decodes in the other.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

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
    import torch

    v = torch.as_tensor(values).to(torch.float32)
    k = torch.searchsorted(thresholds[1:].to(v.device), v.abs(), right=True)
    k = torch.where(torch.isnan(v), torch.zeros_like(k), k)
    return torch.where(v < 0, -k, k).to(torch.int32)


def compress(values: torch.Tensor, precision: int = PRECISION) -> torch.Tensor:
    """Vectorized compress on the tensor's device -> int32 buckets,
    computed in float64 (equal to ``compress_np`` on every input)."""
    import torch

    v = torch.as_tensor(values).to(torch.float64)
    v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
    mag = torch.floor(precision * torch.log1p(v.abs()) + 0.5)
    mag = torch.clamp(mag, max=float(INT16_BUCKET_LIMIT))
    return torch.where(v < 0, -mag, mag).to(torch.int32)


def decompress(buckets: torch.Tensor, precision: int = PRECISION) -> torch.Tensor:
    """Vectorized decompress -> float32 representatives, rounded once
    from float64."""
    import torch

    b = torch.as_tensor(buckets)
    mag = torch.exp(b.abs().to(torch.float64) / precision) - 1.0
    return torch.where(b < 0, -mag, mag).to(torch.float32)


# -- byte-frame codec ------------------------------------------------------ #
#
# One frame on the wire / in the binary journal:
#
#     +----+---+----+-----------+----------+===================+
#     | LH | v | k  | len (u32) | crc (u32)|  payload (len B)  |
#     +----+---+----+-----------+----------+===================+
#      2B   1B  1B      4B          4B       variable
#
# little-endian throughout; ``crc`` is CRC32 over (version, kind, payload)
# so a bit flip anywhere (a flipped length changes which bytes the CRC
# covers) fails closed with FrameError instead of mis-merging.  ``kind``
# namespaces payload schemas; unknown kinds decode fine and are the
# consumer's problem, unknown VERSIONS are this layer's.

FRAME_MAGIC = b"LH"
FRAME_VERSION = 1
FRAME_HEADER = struct.Struct("<2sBBII")
# corrupt length fields must fail the CRC, not allocate gigabytes first
MAX_FRAME_PAYLOAD = 1 << 28


class FrameError(ValueError):
    """A frame that must not be applied: bad magic, unsupported version,
    implausible length, or CRC mismatch."""


class FrameTruncated(FrameError):
    """The buffer ends mid-frame.  Streaming decoders treat this as
    "need more bytes"; at end-of-input it is the torn tail of a crash
    mid-write (tolerated by the journal)."""


def _frame_crc(kind: int, payload: bytes) -> int:
    return zlib.crc32(payload, zlib.crc32(bytes((FRAME_VERSION, kind))))


def encode_frame(kind: int, payload: bytes) -> bytes:
    """Wrap ``payload`` in one framed record (header diagram above)."""
    if not 0 <= kind <= 0xFF:
        raise ValueError(f"frame kind must be a u8, got {kind}")
    if len(payload) > MAX_FRAME_PAYLOAD:
        raise ValueError(
            f"frame payload {len(payload)} B exceeds the "
            f"{MAX_FRAME_PAYLOAD} B cap"
        )
    return FRAME_HEADER.pack(
        FRAME_MAGIC, FRAME_VERSION, kind, len(payload),
        _frame_crc(kind, payload),
    ) + payload


def decode_frame(buf, offset: int = 0) -> tuple[int, bytes, int]:
    """Decode one frame at ``buf[offset:]``.  Returns
    ``(kind, payload, next_offset)``.  Raises FrameTruncated when the
    buffer ends mid-frame and FrameError for anything that must never be
    applied."""
    end = offset + FRAME_HEADER.size
    if end > len(buf):
        raise FrameTruncated(
            f"{len(buf) - offset} B at offset {offset} is shorter than "
            f"the {FRAME_HEADER.size} B frame header"
        )
    magic, version, kind, length, crc = FRAME_HEADER.unpack(
        bytes(buf[offset:end])
    )
    if magic != FRAME_MAGIC:
        raise FrameError(f"bad frame magic {magic!r} at offset {offset}")
    if version != FRAME_VERSION:
        raise FrameError(f"unsupported frame version {version}")
    if length > MAX_FRAME_PAYLOAD:
        raise FrameError(
            f"frame length {length} exceeds the {MAX_FRAME_PAYLOAD} B cap"
        )
    if end + length > len(buf):
        raise FrameTruncated(
            f"frame at offset {offset} declares {length} B payload but "
            f"only {len(buf) - end} B remain"
        )
    payload = bytes(buf[end:end + length])
    if _frame_crc(kind, payload) != crc:
        raise FrameError(f"frame CRC mismatch at offset {offset}")
    return kind, payload, end + length


def iter_frames(buf):
    """Yield every ``(kind, payload)`` in a byte buffer of back-to-back
    frames.  Strict: any corruption, a torn tail included, raises;
    torn-tolerant consumers (the frame journal) decode by hand and catch
    FrameTruncated at the end of the buffer."""
    offset = 0
    while offset < len(buf):
        kind, payload, offset = decode_frame(buf, offset)
        yield kind, payload
