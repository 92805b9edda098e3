"""Raw-interval journal: persist RawMetricSets as JSON lines and replay
them later (counterpart of ``loghisto_tpu/utils/journal.py``).

The reference streams intervals to subscribers and the data is gone;
the journal is the durable option next to live broadcast and
checkpointing: every interval's sparse histograms, counters, rates and
gauges append to a JSONL file, and ``replay()`` rebuilds RawMetricSets
that feed anything the live stream feeds: ``process_metrics``,
``merge_raw_metric_sets``, ``TorchAggregator.merge_raw`` or
``TorchMetricSystem.backfill_retention``.  A line carries the interval's
``duration`` and ``seq``, so a replay's rates, lifecycle epochs and
drift baselines rebuild as they did live.

The format is line-delimited JSON, one interval per line, append-only:
``dump_line`` writes the same string as the JAX package's for the same
interval, so a journal written by either package replays in the other.
A torn final line (a crash mid-append) is skipped on replay with a
warning.

On a ("stream", "metric") mesh each stream row has its own host interval
(ROADMAP D9), so each row keeps its own journal (D11): rank (s, 0)
writes ``row_journal_path(path, s, n)``, ``<path>.row<s>of<n>``, and the
other ranks of the row, whose raw sets are the same, journal nothing.
``row_journals(path)`` finds every row's file (the plain ``path``, the
JAX package's or a single device's, reads as row 0 of 1); the line
format is unchanged, so each file replays in either package.  ``FrameJournal`` is the binary journal of ``(kind, payload)``
records in the byte-frame format of ``ops/codec.py``.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import os
import re
import threading
from typing import Iterator, Optional

from loghisto_tpu_torch.channel import ChannelClosed, ResilientSubscription
from loghisto_tpu_torch.metrics import RawMetricSet
from loghisto_tpu_torch.ops.codec import (
    FrameError,
    FrameTruncated,
    decode_frame,
    encode_frame,
)

logger = logging.getLogger("loghisto_tpu_torch")

FORMAT_VERSION = 1

# process-wide corrupt-line ledger (the journal.CorruptLines gauge)
_corrupt_lock = threading.Lock()
_corrupt_lines = 0


def corrupt_lines_total() -> int:
    """Corrupt or torn journal records skipped by replay, process-wide."""
    with _corrupt_lock:
        return _corrupt_lines


def _note_corrupt_line() -> None:
    global _corrupt_lines
    with _corrupt_lock:
        _corrupt_lines += 1


class JournalCorruptError(Exception):
    """A corrupt NON-final journal record under ``replay(strict=True)``:
    corruption mid-file is lost data, which a torn final line is not."""


class JournalVersionError(Exception):
    """The journal was written by an incompatible format version; raised
    by replay rather than silently skipping every line."""


def row_journal_path(path: str, row: int, rows: int) -> str:
    """The journal of stream row ``row`` of ``rows`` on a mesh."""
    return f"{path}.row{row}of{rows}"


def row_journals(path: str) -> list:
    """``(row, rows, file)`` of every journal under ``path``: the rows'
    files of any mesh (``row_journal_path``), sorted, and ``path`` itself
    as row 0 of 1 where it exists."""
    out = []
    if os.path.exists(path):
        out.append((0, 1, path))
    directory = os.path.dirname(os.path.abspath(path))
    pattern = re.compile(re.escape(os.path.basename(path))
                         + r"\.row(\d+)of(\d+)$")
    try:
        entries = os.listdir(directory)
    except OSError:
        entries = []
    for entry in sorted(entries):
        m = pattern.match(entry)
        if m and int(m.group(1)) < int(m.group(2)):
            out.append((int(m.group(1)), int(m.group(2)),
                        os.path.join(directory, entry)))
    return sorted(out, key=lambda t: (t[1], t[0]))


def dump_line(raw: RawMetricSet) -> str:
    """One interval as a JSON line (no newline).  ``interval`` (the
    duration in seconds) and ``seq`` are optional keys of the same
    format version: older lines replay with both None."""
    obj = {
        "v": FORMAT_VERSION,
        "time": raw.time.timestamp(),
        "counters": raw.counters,
        "rates": raw.rates,
        # JSON keys are strings; bucket indices round-trip through int()
        "histograms": {
            name: {str(b): c for b, c in buckets.items()}
            for name, buckets in raw.histograms.items()
        },
        "gauges": raw.gauges,
    }
    if raw.duration is not None:
        obj["interval"] = raw.duration
    if raw.seq is not None:
        obj["seq"] = raw.seq
    return json.dumps(obj, separators=(",", ":"))


def parse_line(line: str) -> RawMetricSet:
    obj = json.loads(line)
    if not isinstance(obj, dict):
        raise ValueError(f"journal line is not an object: {type(obj)}")
    if obj.get("v") != FORMAT_VERSION:
        raise JournalVersionError(
            f"unsupported journal version {obj.get('v')}"
        )
    return RawMetricSet(
        time=_dt.datetime.fromtimestamp(obj["time"], tz=_dt.timezone.utc),
        counters={k: int(v) for k, v in obj["counters"].items()},
        rates={k: int(v) for k, v in obj["rates"].items()},
        histograms={
            name: {int(b): int(c) for b, c in buckets.items()}
            for name, buckets in obj["histograms"].items()
        },
        # coerced like the other fields, so a corrupt gauges value fails
        # here, inside replay's skip-and-warn net
        gauges={k: float(v) for k, v in obj["gauges"].items()},
        duration=(
            float(obj["interval"]) if obj.get("interval") is not None
            else None
        ),
        seq=int(obj["seq"]) if obj.get("seq") is not None else None,
    )


def replay(path: str, strict: bool = False) -> Iterator[RawMetricSet]:
    """Yield every interval in the journal.  A format-version mismatch
    raises JournalVersionError in either mode.

    A torn FINAL line is skipped with a warning in both modes.  A
    corrupt line with valid lines after it is skipped with a counted
    warning when ``strict`` is False, and raises JournalCorruptError
    when it is True.  Both count in ``corrupt_lines_total``."""
    # a corrupt line is provably non-final only once a later non-empty
    # line shows up, so its error is held until then
    pending: Optional[tuple] = None
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            if pending is not None:
                p_lineno, p_err = pending
                pending = None
                _note_corrupt_line()
                if strict:
                    raise JournalCorruptError(
                        f"journal {path} line {p_lineno} corrupt mid-file"
                        f" ({p_err})"
                    ) from p_err
                logger.warning(
                    "journal %s line %d unreadable (%s); skipping",
                    path, p_lineno, p_err,
                )
            try:
                yield parse_line(line)
            except JournalVersionError:
                raise
            except (json.JSONDecodeError, AttributeError, KeyError,
                    TypeError, ValueError) as e:
                pending = (lineno, e)
    if pending is not None:
        p_lineno, p_err = pending
        _note_corrupt_line()
        logger.warning(
            "journal %s line %d unreadable (%s); skipping torn tail",
            path, p_lineno, p_err,
        )


class RawJournal:
    """A raw-metrics subscriber that appends every interval to a JSONL
    file, on its own thread (never in the reaper).  It subscribes in
    ``start()``, through a ``ResilientSubscription``, so a strike
    eviction re-subscribes instead of ending the journal."""

    def __init__(self, metric_system, path: str, channel_capacity: int = 16):
        self.path = path
        self._ms = metric_system
        self._capacity = channel_capacity
        self._ch: Optional[ResilientSubscription] = None
        self._thread: Optional[threading.Thread] = None
        # fault hook: ``mangle("journal.append", line)`` may tear or
        # corrupt a serialized line before it is written
        self.fault_injector = None

    def start(self) -> None:
        """Open the file and subscribe.  An unopenable path raises here,
        to the caller, not on the writer thread.  A torn final line of an
        earlier run is terminated first, so the next record starts on a
        line of its own."""
        if self._thread is not None:
            return
        f = open(self.path, "a+")
        f.seek(0, 2)
        if f.tell() > 0:
            f.seek(f.tell() - 1)
            if f.read(1) != "\n":
                f.write("\n")
        self._ch = ResilientSubscription(
            self._ms.subscribe_to_raw_metrics,
            self._ms.unsubscribe_from_raw_metrics,
            self._capacity,
        )
        self._thread = threading.Thread(
            target=self._run, args=(f, self._ch), daemon=True,
            name="loghisto-journal",
        )
        self._thread.start()

    def _run(self, f, ch: ResilientSubscription) -> None:
        with f:
            while True:
                try:
                    raw = ch.get()
                except ChannelClosed:
                    return
                try:
                    line = dump_line(raw) + "\n"
                    inj = self.fault_injector
                    if inj is not None:
                        line = inj.mangle("journal.append", line)
                    f.write(line)
                    f.flush()
                except OSError:
                    logger.exception("journal write failed; interval lost")

    def stop(self) -> None:
        """Unsubscribe, let the writer take what its channel holds, and
        join it.  Safe on a journal that never started."""
        if self._ch is not None:
            self._ch.close()
            self._ch = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class FrameJournal:
    """Binary framed journal: append-only ``(kind, payload)`` records in
    the byte-frame format of ``ops/codec.py`` (versioned header, length
    prefix, CRC32), the format the federation wire ships.

    Replay tolerates a torn tail like the JSONL journal: a frame cut
    short at the end of the file is skipped with a counted warning.
    CORRUPT bytes mid-file stop the replay there (a byte stream offers
    no resync point past a bad length field), counted as one corrupt
    record; ``strict=True`` raises JournalCorruptError instead.  Both
    feed ``corrupt_lines_total``."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "ab")
        self.frames_appended = 0

    def append(self, kind: int, payload: bytes) -> None:
        frame = encode_frame(kind, payload)
        with self._lock:
            self._f.write(frame)
            self._f.flush()
            self.frames_appended += 1

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    @staticmethod
    def replay(path: str, strict: bool = False):
        """Yield every ``(kind, payload)`` in the journal file (the class
        docstring gives the torn and corrupt rules)."""
        with open(path, "rb") as f:
            buf = f.read()
        offset = 0
        while offset < len(buf):
            try:
                kind, payload, offset = decode_frame(buf, offset)
            except FrameTruncated as e:
                _note_corrupt_line()
                logger.warning(
                    "frame journal %s torn at offset %d (%s); skipping "
                    "tail", path, offset, e,
                )
                return
            except FrameError as e:
                _note_corrupt_line()
                if strict:
                    raise JournalCorruptError(
                        f"frame journal {path} corrupt at offset {offset}"
                        f" ({e})"
                    ) from e
                logger.warning(
                    "frame journal %s corrupt at offset %d (%s); "
                    "abandoning the remaining %d B (no resync point in "
                    "a binary stream)", path, offset, e, len(buf) - offset,
                )
                return
            yield kind, payload
