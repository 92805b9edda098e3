"""Immutable commit-time snapshot handles of the wheel's query engine
(counterpart of ``loghisto_tpu/window/snapshot.py``).

Every push ends by publishing one ``Snapshot``: per tier, the exact
bucket prefix sums (CDF), counts and representative sums of each
materialized window view, versioned by the wheel's commit epoch
(``intervals_pushed``).  The handle is frozen and its tensors are fresh
outputs of the snapshot merge that no later push writes (they are never
views of a ring), so a query that has read the handle runs its gather
outside the store lock; a concurrent push publishes a new handle.

Views: each tier carries the full written span (``window_s is None``)
plus one view per pinned window.  A query routes to the full view when
the requested window covers the whole retained span, to a pinned view
on an exact window match, and otherwise falls back to the locked
recompute, pinning the window for the next commit.

``QueryPlanCache`` pads the id operand to the next power of two and
counts (tier, n_ids-bucket, P) plan keys for the self-metrics.  The
aggregator-side ``AccSnapshot`` comes with the fused interval committer
(ROADMAP Queue 1 slice 7b).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SnapshotView:
    """One materialized window of one tier.  ``window_s is None`` marks
    the full written span; ``mask``/``covered_s``/``slots`` record what
    the view merged (the same values the locked recompute would report).
    cdf int32 [M, B], counts int32 [M], sums float32 [M] — tensors on the
    wheel's device."""

    window_s: Optional[float]
    mask: np.ndarray
    covered_s: float
    slots: int
    cdf: object
    counts: object
    sums: object


@dataclasses.dataclass(frozen=True)
class TierSnapshot:
    """All views of one tier at one epoch."""

    tier: int
    views: Tuple[SnapshotView, ...]

    def view_for(self, window_s: float) -> Optional[SnapshotView]:
        """Route a requested window to a view: the full span when the
        request covers everything retained (the mask walk would select
        the same slots), else an exactly-pinned window."""
        full = self.views[0]
        if window_s >= full.covered_s - 1e-9:
            return full
        for v in self.views[1:]:
            if v.window_s is not None and abs(v.window_s - window_s) < 1e-9:
                return v
        return None


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """Epoch-versioned, immutable read handle published by the commit
    path.  ``epoch`` == the wheel's ``intervals_pushed`` at publication;
    a host result cache keyed on it serves repeat queries with zero
    dispatch until the next interval lands."""

    epoch: int
    time: Optional[_dt.datetime]
    interval: float
    tiers: Tuple[TierSnapshot, ...]


class QueryPlanCache:
    """Pow-2 id-operand padding + (tier, n_ids-bucket, P) plan-key
    accounting.  PyTorch runs eagerly, so there is no executable to
    warm; the padding and the hit/miss counters are kept so the gather
    shapes and the commit.query_* gauges match the reference's."""

    def __init__(self) -> None:
        self.hits = 0
        self.misses = 0
        self._seen: set = set()

    @staticmethod
    def pad_ids(ids: np.ndarray) -> Tuple[np.ndarray, int]:
        """Pad int32 ids up to the next power of two with row 0 (a
        always-valid row; its extra stats are sliced off after
        readback).  Returns (padded ids, padded length)."""
        n = len(ids)
        nb = 1 if n <= 1 else 1 << (n - 1).bit_length()
        padded = np.zeros(nb, dtype=np.int32)
        padded[:n] = ids
        return padded, nb

    def note(self, tier: int, n_bucket: int, n_ps: int) -> bool:
        """Record one plan lookup; returns True on a hit (the padded
        shape has been served before)."""
        key = (tier, n_bucket, n_ps)
        if key in self._seen:
            self.hits += 1
            return True
        self._seen.add(key)
        self.misses += 1
        return False
