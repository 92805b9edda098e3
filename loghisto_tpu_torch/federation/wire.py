"""Federation payload schema: the DELTA frame (counterpart of
``loghisto_tpu/federation/wire.py``).

One frame carries one emitter interval, self-describing given the
frames before it from the same emitter:

    <u64 emitter_id> <u64 seq> <u32 n_names> <u32 n_rows>
    n_names x ( <u32 local_id> <u16 len> <len B utf-8 name> )
    n_rows  x ( <i32 local_id> <i32 codec_bucket> <i32 count> )

* ``emitter_id`` is a random u64 minted per emitter process; the
  receiver keys sequence tracking and the local-id -> row map on it.
* ``seq`` is monotonic from 1 per emitter.  The receiver applies each
  seq at most once (re-delivery is idempotent) and counts gaps.
* The name dictionary is a delta: only names first shipped in this
  frame appear, so a steady emitter pays about no dictionary bytes.
  Row triples carry emitter-local ids; the receiver interns the names
  into aggregator rows and rewrites the id column.
* Triples are the packed ``[n, 3]`` int32 layout of the sparse
  transport (``ops/fold.py``), little-endian ``tobytes()`` out and
  ``frombuffer`` in.  Counts are positive and below 2^30 (the packed
  row cap), so the receiver's scatter-add cannot overflow mid-merge.

The framing (magic, version, length, CRC32) is ``ops/codec.py``'s; this
module owns the DELTA payload bytes only.  Decode is strict: every
declared length must land exactly on the payload end, and a violation
raises ``WireError``, which the receiver counts as a decode error and
does not apply (a mis-split triple array would merge garbage counts).

Wire v2 (``KIND_DELTA2``) puts observability fields before the same
body:

    <u64 emitter_id> <u64 seq>
    <u64 mono_ns> <u64 wall_ns>          capture stamps (emitter clocks)
    <u32 health_len> health_len B json   compact emitter health summary
    <u32 n_names> <u32 n_rows> ...       the v1 body

``mono_ns`` and ``wall_ns`` are the emitter's monotonic and wall clocks
when the interval's first sample was staged (flush time for an empty
heartbeat).  A monotonic stamp compares only with stamps of the same
process: the receiver anchors them per emitter and works in deltas,
and reads the wall stamp only to detect clock skew.  The payload
version rides on the frame kind, never on the codec's FRAME_VERSION
(which old decoders refuse), so a v1 receiver skips v2 frames as
unknown kinds and a v2 receiver applies v1 frames without freshness or
health.  Frames are byte-identical to the JAX package's for the same
inputs, in both versions.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Optional

import numpy as np

# frame ``kind`` bytes (ops.codec.encode_frame) of DELTA payloads
KIND_DELTA = 1   # v1: id/seq + dictionary + rows
KIND_DELTA2 = 2  # v2: v1 + capture stamps + health summary

_DELTA_HEAD = struct.Struct("<QQII")
_DELTA2_HEAD = struct.Struct("<QQQQI")  # emitter_id, seq, mono, wall, health_len
_NAME_HEAD = struct.Struct("<IH")
_MAX_NAME_BYTES = 4096
_MAX_HEALTH_BYTES = 65536


class WireError(ValueError):
    """A structurally invalid DELTA payload (the frame CRC passed, so
    this is a schema bug or version skew, not line noise)."""


@dataclasses.dataclass
class DeltaFrame:
    emitter_id: int
    seq: int
    names: list  # [(local_id, name), ...] first shipped in this frame
    packed: np.ndarray  # int32 [n, 3] (local_id, codec_bucket, count)
    # v2 fields; None when decoded from a v1 frame
    mono_ns: Optional[int] = None  # emitter monotonic clock at capture
    wall_ns: Optional[int] = None  # emitter wall clock at capture
    health: Optional[dict] = None  # compact emitter health summary

    @property
    def samples(self) -> int:
        return int(self.packed[:, 2].sum(dtype=np.int64))


def fed_flow_id(emitter_id: int, seq: int) -> int:
    """Perfetto flow id of one (emitter, interval) frame.  Both sides of
    the process boundary derive it from fields already on the wire, and
    it stays below 2^53 so a JSON round trip keeps it exact."""
    return ((emitter_id & 0x1FFFFF) << 32) | (seq & 0xFFFFFFFF)


def _encode_body(names, packed: np.ndarray) -> list:
    """The v1/v2 tail: <u32 n_names> <u32 n_rows> dictionary rows."""
    packed = np.ascontiguousarray(packed, dtype=np.int32)
    if packed.ndim != 2 or packed.shape[1] != 3:
        raise ValueError(
            f"packed must be [n, 3] (id, bucket, count); got {packed.shape}"
        )
    parts = [struct.pack("<II", len(names), len(packed))]
    for local_id, name in names:
        raw = name.encode("utf-8")
        if len(raw) > _MAX_NAME_BYTES:
            raise ValueError(
                f"metric name {name[:40]!r}... is {len(raw)} B "
                f"(cap {_MAX_NAME_BYTES})"
            )
        parts.append(_NAME_HEAD.pack(local_id, len(raw)))
        parts.append(raw)
    if not packed.dtype.isnative:
        packed = packed.astype("<i4")
    parts.append(packed.tobytes())
    return parts


def encode_delta(
    emitter_id: int, seq: int, names, packed: np.ndarray
) -> bytes:
    """One v1 DELTA payload (the module docstring's layout)."""
    body = _encode_body(names, packed)
    return b"".join([struct.pack("<QQ", emitter_id, seq)] + body)


def encode_delta2(
    emitter_id: int,
    seq: int,
    names,
    packed: np.ndarray,
    mono_ns: int,
    wall_ns: int,
    health: Optional[dict] = None,
) -> bytes:
    """One v2 DELTA payload: capture stamps, health, the v1 body."""
    raw_health = b""
    if health:
        raw_health = json.dumps(
            health, separators=(",", ":"), sort_keys=True
        ).encode("utf-8")
        if len(raw_health) > _MAX_HEALTH_BYTES:
            raise ValueError(
                f"health summary is {len(raw_health)} B "
                f"(cap {_MAX_HEALTH_BYTES})"
            )
    head = _DELTA2_HEAD.pack(
        emitter_id, seq, int(mono_ns), int(wall_ns), len(raw_health)
    )
    body = _encode_body(names, packed)
    return b"".join([head, raw_health] + body)


def _decode_body(payload: bytes, off: int):
    """Parse <u32 n_names> <u32 n_rows> dictionary rows from ``off`` to
    exactly the payload end; returns (names, packed)."""
    if off + 8 > len(payload):
        raise WireError(
            f"DELTA payload {len(payload)} B is shorter than its header"
        )
    n_names, n_rows = struct.unpack_from("<II", payload, off)
    off += 8
    names = []
    for _ in range(n_names):
        if off + _NAME_HEAD.size > len(payload):
            raise WireError("DELTA name dictionary overruns the payload")
        local_id, name_len = _NAME_HEAD.unpack_from(payload, off)
        off += _NAME_HEAD.size
        if name_len > _MAX_NAME_BYTES or off + name_len > len(payload):
            raise WireError("DELTA name entry overruns the payload")
        try:
            name = payload[off:off + name_len].decode("utf-8")
        except UnicodeDecodeError as e:
            raise WireError(f"DELTA name is not utf-8: {e}") from e
        off += name_len
        names.append((local_id, name))
    rows_bytes = n_rows * 12
    if off + rows_bytes != len(payload):
        raise WireError(
            f"DELTA declares {n_rows} rows ({rows_bytes} B) but "
            f"{len(payload) - off} B remain past the dictionary"
        )
    # a native, writable copy: the receiver rewrites the id column
    packed = (
        np.frombuffer(payload, dtype="<i4", count=n_rows * 3, offset=off)
        .reshape(n_rows, 3)
        .astype(np.int32)
    )
    return names, packed


def decode_delta(payload: bytes) -> DeltaFrame:
    """Parse one v1 DELTA payload; any structural violation raises
    WireError instead of returning a best guess."""
    if len(payload) < _DELTA_HEAD.size:
        raise WireError(
            f"DELTA payload {len(payload)} B is shorter than its "
            f"{_DELTA_HEAD.size} B header"
        )
    emitter_id, seq = struct.unpack_from("<QQ", payload, 0)
    names, packed = _decode_body(payload, 16)
    return DeltaFrame(
        emitter_id=emitter_id, seq=seq, names=names, packed=packed
    )


def decode_delta2(payload: bytes) -> DeltaFrame:
    """Parse one v2 DELTA payload (stamps, health, the v1 body)."""
    if len(payload) < _DELTA2_HEAD.size:
        raise WireError(
            f"DELTA2 payload {len(payload)} B is shorter than its "
            f"{_DELTA2_HEAD.size} B header"
        )
    emitter_id, seq, mono_ns, wall_ns, health_len = _DELTA2_HEAD.unpack_from(
        payload, 0
    )
    off = _DELTA2_HEAD.size
    if health_len > _MAX_HEALTH_BYTES or off + health_len > len(payload):
        raise WireError(
            f"DELTA2 health blob of {health_len} B overruns the payload"
        )
    health = None
    if health_len:
        try:
            health = json.loads(payload[off:off + health_len])
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise WireError(f"DELTA2 health blob is not json: {e}") from e
        if not isinstance(health, dict):
            raise WireError("DELTA2 health blob must be a json object")
    off += health_len
    names, packed = _decode_body(payload, off)
    return DeltaFrame(
        emitter_id=emitter_id,
        seq=seq,
        names=names,
        packed=packed,
        mono_ns=mono_ns,
        wall_ns=wall_ns,
        health=health,
    )


def decode_payload(kind: int, payload: bytes) -> DeltaFrame:
    """Decode by the frame's kind byte; a kind this receiver does not
    speak raises WireError (counted and dropped, never a crash)."""
    if kind == KIND_DELTA:
        return decode_delta(payload)
    if kind == KIND_DELTA2:
        return decode_delta2(payload)
    raise WireError(f"unknown DELTA frame kind {kind}")
