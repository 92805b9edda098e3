"""Metric name <-> dense row id registry (counterpart of
``loghisto_tpu/registry.py``, copied).

The reference keys everything by string name in sparse maps
(metrics.go:112-126).  The device tier stores bucket counts in a dense
``[num_metrics, num_buckets]`` tensor, so names map to stable integer
rows.  The registry is thread-safe and bounded; the aggregator grows it
together with the accumulator.  The lifecycle retires names
(``evict``) and repacks the rows (``apply_permutation``); ``generation``
bumps on every eviction, permutation and free-slot reuse, and keys every
cache that maps ids to names (glob resolutions, drift scores).
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence


class RegistryFullError(RuntimeError):
    pass


class MetricRegistry:
    def __init__(self, capacity: int = 16384):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._name_to_id: Dict[str, int] = {}
        # dense id -> name table; None marks a freed slot
        self._names: List[Optional[str]] = []
        # freed slot ids, reused LIFO before the table grows a new row
        self._free: List[int] = []
        self._generation = 0

    @classmethod
    def from_names(
        cls, names: Sequence[Optional[str]], capacity: int
    ) -> "MetricRegistry":
        """A registry whose id -> name table is ``names`` (None = hole,
        joining the free-list) — how carried-over state restores its
        rows without renumbering them."""
        if len(names) > capacity:
            raise ValueError(
                f"{len(names)} names exceed registry capacity {capacity}"
            )
        reg = cls(capacity)
        reg._names = list(names)
        reg._name_to_id = {
            name: mid for mid, name in enumerate(names) if name is not None
        }
        if len(reg._name_to_id) != sum(n is not None for n in names):
            raise ValueError("names table holds a duplicate name")
        reg._free = [mid for mid, name in enumerate(names) if name is None]
        if reg._free:
            reg._generation = 1
        return reg

    @property
    def generation(self) -> int:
        """Structural generation: bumped whenever an existing id's
        meaning changes (free-slot reuse) — NOT on pure appends."""
        return self._generation

    def id_for(self, name: str) -> int:
        """Return the row id for `name`, registering it on first use.
        Freed slots are reused (LIFO) before the table grows."""
        existing = self._name_to_id.get(name)
        if existing is not None:
            return existing
        with self._lock:
            existing = self._name_to_id.get(name)
            if existing is not None:
                return existing
            if self._free:
                new_id = self._free.pop()
                self._names[new_id] = name
                self._generation += 1
            else:
                if len(self._names) >= self.capacity:
                    raise RegistryFullError(
                        f"metric registry is full ({self.capacity} names)"
                    )
                new_id = len(self._names)
                self._names.append(name)
            self._name_to_id[name] = new_id
            return new_id

    def grow(self, new_capacity: int) -> None:
        """Raise capacity (never shrinks).  Used by the aggregator's
        on_registry_full="grow" policy — the reference admits new names
        forever (metrics.go:281-294)."""
        with self._lock:
            if new_capacity > self.capacity:
                self.capacity = new_capacity

    def evict(self, ids: Iterable[int]) -> List[str]:
        """Release the given ids: their names unregister, the slots join
        the free-list, and the generation bumps once.  Unknown / already
        free ids are ignored.  Returns the evicted names."""
        evicted: List[str] = []
        with self._lock:
            for mid in ids:
                mid = int(mid)
                if not 0 <= mid < len(self._names):
                    continue
                name = self._names[mid]
                if name is None:
                    continue
                del self._name_to_id[name]
                self._names[mid] = None
                self._free.append(mid)
                evicted.append(name)
            if evicted:
                self._generation += 1
        return evicted

    def apply_permutation(
        self, perm: Sequence[int], new_capacity: Optional[int] = None
    ) -> None:
        """Remap every live id after a device compaction: ``perm[new]``
        is the OLD id now living at row ``new`` (negative or past the
        table = empty row).  Every old live id must appear exactly once
        (validated); the free-list is rebuilt from the holes and the
        generation bumps."""
        with self._lock:
            old_live = {
                mid for mid, name in enumerate(self._names)
                if name is not None
            }
            sources = [
                int(p) for p in perm
                if 0 <= int(p) < len(self._names)
            ]
            if len(sources) != len(set(sources)):
                raise ValueError("compaction permutation duplicates a row")
            live_sources = {s for s in sources if s in old_live}
            if live_sources != old_live:
                missing = sorted(old_live - live_sources)[:8]
                raise ValueError(
                    f"compaction permutation drops live ids {missing}"
                )
            cap = int(new_capacity) if new_capacity is not None \
                else self.capacity
            if cap < len(perm):
                raise ValueError(
                    f"new capacity {cap} below permutation length "
                    f"{len(perm)}"
                )
            names: List[Optional[str]] = [None] * len(perm)
            for new_id, old_id in enumerate(perm):
                old_id = int(old_id)
                if old_id < 0 or old_id >= len(self._names):
                    continue
                names[new_id] = self._names[old_id]
            # trim trailing holes so append-path ids stay dense
            while names and names[-1] is None:
                names.pop()
            self._names = names
            self._name_to_id = {
                name: mid for mid, name in enumerate(names)
                if name is not None
            }
            self._free = [
                mid for mid, name in enumerate(names) if name is None
            ]
            self.capacity = cap
            self._generation += 1

    def lookup(self, name: str) -> Optional[int]:
        return self._name_to_id.get(name)

    def name_for(self, metric_id: int) -> Optional[str]:
        """Name at a row id, or None for a freed / never-used slot."""
        if 0 <= metric_id < len(self._names):
            return self._names[metric_id]
        return None

    def names(self) -> List[Optional[str]]:
        """Dense id -> name table; freed slots hold None."""
        with self._lock:
            return list(self._names)

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def live_count(self) -> int:
        with self._lock:
            return len(self._name_to_id)

    def __len__(self) -> int:
        """High-water row count (table length including freed holes)."""
        return len(self._names)
