"""Closeable bounded channel — the subscription primitive (counterpart of
``loghisto_tpu/channel.py``, copied).

The reference's subscription boundary is a Go buffered channel: broadcast is
non-blocking (`select` with `default`), and a subscriber that repeatedly
fails to drain is evicted by *closing its channel* (metrics.go:565-581).
Python's ``queue.Queue`` has no close semantics, so this wraps one with a
closed flag + sentinel wake-up, giving subscribers the same contract:

    ch = Channel(capacity=60)
    for metric_set in ch:   # terminates when the producer closes the channel
        ...

Designed for the single-reader case (every reference usage is one reader per
channel); multiple blocked readers may not all wake on close.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator


class ChannelClosed(Exception):
    """Raised by get() on a closed, drained channel."""


class ResilientSubscription:
    """A subscription that survives strike-eviction.

    The reference's contract closes a slow subscriber's channel and
    forgets it (metrics.go:565-581) — correct shedding for arbitrary
    user channels, but a long-lived infrastructure consumer (exporter,
    journal) that dies permanently because of one transient stall is an
    operational hazard.  This wrapper's ``get`` transparently
    re-subscribes on a fresh channel after an eviction (the stalled
    intervals stay dropped — shed-don't-block is preserved) unless
    ``close`` was called, in which case ChannelClosed propagates.
    ``evictions`` counts occurrences for observability."""

    def __init__(self, subscribe, unsubscribe, capacity: int):
        self._subscribe = subscribe
        self._unsubscribe = unsubscribe
        self.capacity = capacity
        self._lock = threading.Lock()
        self._stopped = False
        self.evictions = 0
        ch = Channel(capacity)
        subscribe(ch)
        self._ch = ch

    def get(self, block: bool = True, timeout: float | None = None) -> Any:
        """Like Channel.get, but an eviction re-subscribes and retries.
        Raises ChannelClosed only after close(); queue.Empty on timeout."""
        while True:
            with self._lock:
                ch = self._ch
            try:
                return ch.get(block=block, timeout=timeout)
            except ChannelClosed:
                with self._lock:
                    if self._stopped:
                        raise
                    if self._ch is ch:  # first getter to notice re-subs
                        self.evictions += 1
                        fresh = Channel(self.capacity)
                        self._subscribe(fresh)
                        self._ch = fresh

    def close(self) -> None:
        """Unsubscribe and close; get() raises ChannelClosed afterwards.
        Idempotent."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            ch = self._ch
        self._unsubscribe(ch)
        ch.close()


class Channel:
    _SENTINEL = object()

    def __init__(self, capacity: int = 1):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._q: queue.Queue = queue.Queue(capacity)
        self._closed = threading.Event()

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def offer(self, item: Any) -> bool:
        """Non-blocking put. Returns False when full or closed — the caller
        (the reaper) never blocks on a slow subscriber."""
        if self.closed:
            return False
        try:
            self._q.put_nowait(item)
        except queue.Full:
            return False
        if self.closed:
            # close() raced us: the item may sit behind the close sentinel
            # and never be delivered, so don't claim acceptance.
            return False
        return True

    def get(self, block: bool = True, timeout: float | None = None) -> Any:
        """Blocking get; raises ChannelClosed once closed and drained,
        queue.Empty on timeout."""
        while True:
            try:
                item = self._q.get(block=False)
            except queue.Empty:
                if self.closed:
                    raise ChannelClosed
                if not block:
                    raise
                try:
                    item = self._q.get(block=True, timeout=timeout)
                except queue.Empty:
                    if self.closed:
                        raise ChannelClosed
                    raise
            if item is self._SENTINEL:
                # propagate the wake-up to any other blocked reader
                try:
                    self._q.put_nowait(self._SENTINEL)
                except queue.Full:
                    pass
                raise ChannelClosed
            return item

    def close(self) -> None:
        """Close the channel; wakes a blocked reader. Idempotent."""
        if not self._closed.is_set():
            self._closed.set()
            try:
                self._q.put_nowait(self._SENTINEL)
            except queue.Full:
                pass

    def __iter__(self) -> Iterator[Any]:
        while True:
            try:
                yield self.get()
            except ChannelClosed:
                return

    def __len__(self) -> int:
        return self._q.qsize()
