"""Metric name <-> dense row id registry (counterpart of
``loghisto_tpu/registry.py``, copied).

The reference keys everything by string name in sparse maps
(metrics.go:112-126).  The device tier stores bucket counts in a dense
``[num_metrics, num_buckets]`` tensor, so names map to stable integer
rows.  The registry is thread-safe and bounded; the aggregator grows it
together with the accumulator.  ``generation`` is kept for parity: this
slice has no eviction, so it only moves when ``from_names`` installs a
table with holes.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence


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

    def lookup(self, name: str) -> Optional[int]:
        return self._name_to_id.get(name)

    def names(self) -> List[Optional[str]]:
        """Dense id -> name table; freed slots hold None."""
        with self._lock:
            return list(self._names)
