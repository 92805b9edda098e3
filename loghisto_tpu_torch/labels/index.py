"""Host-side inverted label index over the metric registry (counterpart
of ``loghisto_tpu/labels/index.py``, copied: pure host code).

Maps ``label key=value`` -> row-id set and ``base name`` -> row-id set,
so a selector query (``http.latency{route=/api,code=~5..}``) compiles
down to the id list the wheel's sparse-gather query path consumes; the
device never learns that labels exist.

The index is valid for one ``(registry.generation, high_water)`` pair,
the key of the wheel's glob cache:

  * same generation, grown high water -> a tail scan of the new rows
    (pure appends never change existing ids), so steady-state label-set
    creation costs O(new rows), not O(live rows);
  * generation bump (evict, free-slot reuse, compaction) -> full
    rebuild and selector-cache flush: an id resolved under generation g
    is never served once the registry moves past g.

``select`` first tries a lock-free cache probe: it reads
``(generation, len(registry))`` (two O(1) reads, no name-table copy, no
index lock) and returns the cached id tuple when both the cache entry
and the index were built at exactly that version, so serving threads do
not queue on one mutex while the commit thread appends rows.
"""

from __future__ import annotations

import fnmatch
import threading
from typing import Dict, List, Optional, Set, Tuple, Union

from loghisto_tpu_torch.labels.model import parse_canonical
from loghisto_tpu_torch.labels.selector import Selector, parse_selector

# one resolved selector: ((rgen, hw, max_id) it was computed at, matches)
_CacheEntry = Tuple[Tuple[int, int, Optional[int]], Tuple[Tuple[int, str], ...]]

_SEL_CACHE_CAP = 256


class LabelIndex:
    """Inverted index: base -> ids, (key, value) -> ids, id -> parsed
    labels.  One instance per registry; shared by the wheel's query
    path, ``query_group_by``, and the ``labels.*`` gauges."""

    def __init__(self, registry) -> None:
        self.registry = registry
        self._lock = threading.Lock()
        # version the structures below were built at; None = never built
        self._gen: Optional[Tuple[int, int]] = None
        self._rows: Dict[int, Tuple[str, str, Dict[str, str]]] = {}
        self._by_base: Dict[str, Set[int]] = {}
        self._by_label: Dict[Tuple[str, str], Set[int]] = {}
        self._sel_cache: Dict[str, _CacheEntry] = {}
        # self-metrics (read by the labels.* gauges and debug_dump)
        self.sel_cache_hits = 0
        self.sel_cache_misses = 0
        self.rebuilds = 0
        self.tail_scans = 0

    # ------------------------------------------------------------------
    # build / refresh

    def _current_version(self) -> Tuple[int, int]:
        """O(1), lock-free read of (generation, high_water).  Re-reads
        the generation to guard the torn case where an evict lands
        between the two loads — a torn pair could otherwise validate a
        cache entry built pre-evict against a post-evict high water."""
        reg = self.registry
        while True:
            g0 = reg.generation
            hw = len(reg)
            if reg.generation == g0:
                return (g0, hw)

    def _index_row(self, mid: int, name: str) -> None:
        base, pairs = parse_canonical(name)
        labels = dict(pairs)
        self._rows[mid] = (name, base, labels)
        self._by_base.setdefault(base, set()).add(mid)
        for kv in pairs:
            self._by_label.setdefault(kv, set()).add(mid)

    def _refresh_locked(self) -> Tuple[int, int]:
        """Bring the index up to the registry's current version (caller
        holds ``self._lock``).  Returns the version indexed."""
        reg = self.registry
        while True:
            g0 = reg.generation
            names = reg.names()  # consistent copy under registry lock
            if reg.generation == g0:
                break
        gen = (g0, len(names))
        if self._gen == gen:
            return gen
        if self._gen is not None and self._gen[0] == gen[0] \
                and gen[1] >= self._gen[1]:
            # pure appends since last refresh: scan only the new tail
            self.tail_scans += 1
            for mid in range(self._gen[1], gen[1]):
                name = names[mid]
                if name is not None:
                    self._index_row(mid, name)
        else:
            # generation bump: every cached id is suspect — rebuild
            self.rebuilds += 1
            self._rows.clear()
            self._by_base.clear()
            self._by_label.clear()
            self._sel_cache.clear()
            for mid, name in enumerate(names):
                if name is not None:
                    self._index_row(mid, name)
        self._gen = gen
        return gen

    # ------------------------------------------------------------------
    # query

    def select(
        self,
        selector: Union[str, Selector],
        max_id: Optional[int] = None,
    ) -> Tuple[Tuple[int, int], Tuple[Tuple[int, str], ...]]:
        """Resolve a selector to ``(version, ((mid, name), ...))`` with
        mids ascending.  ``version`` is the (generation, high_water)
        pair the answer is valid for — result caches key on it the same
        way they key on the glob cache's generation.  ``max_id`` bounds
        ids to a consumer's row space (the wheel passes its
        ``num_metrics``)."""
        sel = parse_selector(selector) if isinstance(selector, str) \
            else selector
        ckey = sel.text
        ver = self._current_version()
        want = (ver[0], ver[1], max_id)
        # lock-free fast path: entry AND index both at the live version
        ent = self._sel_cache.get(ckey)
        if ent is not None and ent[0] == want \
                and self._gen == (want[0], want[1]):
            self.sel_cache_hits += 1
            return (want[0], want[1]), ent[1]
        with self._lock:
            gen = self._refresh_locked()
            want = (gen[0], gen[1], max_id)
            ent = self._sel_cache.get(ckey)
            if ent is not None and ent[0] == want:
                self.sel_cache_hits += 1
                return gen, ent[1]
            self.sel_cache_misses += 1
            matches = self._select_locked(sel, max_id)
            if len(self._sel_cache) >= _SEL_CACHE_CAP:
                self._sel_cache.clear()
            self._sel_cache[ckey] = (want, matches)
            return gen, matches

    def _select_locked(
        self, sel: Selector, max_id: Optional[int]
    ) -> Tuple[Tuple[int, str], ...]:
        # candidate narrowing: postings for exact k=v clauses (rows
        # missing the label can't match a non-empty exact value), then
        # the base posting(s); full matcher evaluation runs only over
        # the narrowed set.
        candidates: Optional[Set[int]] = None
        for m in sel.exact_matchers():
            posting = self._by_label.get((m.key, m.value), set())
            candidates = posting if candidates is None \
                else candidates & posting
            if not candidates:
                return ()
        if sel.base_is_glob:
            base_ids: Set[int] = set()
            for base, ids in self._by_base.items():
                if fnmatch.fnmatchcase(base, sel.base):
                    base_ids |= ids
        else:
            base_ids = self._by_base.get(sel.base, set())
        candidates = base_ids if candidates is None \
            else candidates & base_ids
        out: List[Tuple[int, str]] = []
        for mid in candidates:
            if max_id is not None and mid >= max_id:
                continue
            name, _base, labels = self._rows[mid]
            if sel.match_labels(labels):
                out.append((mid, name))
        out.sort()
        return tuple(out)

    # ------------------------------------------------------------------
    # introspection

    def stats(self) -> Dict[str, object]:
        with self._lock:
            self._refresh_locked()
            labeled = sum(
                1 for (_n, _b, labels) in self._rows.values() if labels
            )
            return {
                "generation": self._gen,
                "rows": len(self._rows),
                "labeled_rows": labeled,
                "bases": len(self._by_base),
                "postings": len(self._by_label),
                "posting_ids": sum(
                    len(s) for s in self._by_label.values()
                ),
                "selector_cache_entries": len(self._sel_cache),
                "selector_cache_hits": self.sel_cache_hits,
                "selector_cache_misses": self.sel_cache_misses,
                "rebuilds": self.rebuilds,
                "tail_scans": self.tail_scans,
            }

    def cardinality_by_prefix(self) -> Dict[str, int]:
        """Live label-set count per first-dot prefix of the base name —
        the operator's view of which subsystem is exploding (the same
        prefix grain the lifecycle budgets use)."""
        with self._lock:
            self._refresh_locked()
            out: Dict[str, int] = {}
            for (_name, base, labels) in self._rows.values():
                if not labels:
                    continue
                prefix = base.split(".", 1)[0]
                out[prefix] = out.get(prefix, 0) + 1
            return dict(sorted(out.items()))

    def register_gauges(self, ms) -> None:
        """Publish the labels.* self-metrics on a MetricSystem."""
        ms.register_gauge_func(
            "labels.LiveLabelSets",
            lambda: self.stats()["labeled_rows"],
        )
        ms.register_gauge_func(
            "labels.IndexPostings",
            lambda: self.stats()["posting_ids"],
        )
        ms.register_gauge_func(
            "labels.SelectorCacheHits", lambda: self.sel_cache_hits
        )
        ms.register_gauge_func(
            "labels.SelectorCacheMisses", lambda: self.sel_cache_misses
        )
        ms.register_gauge_func(
            "labels.IndexRebuilds", lambda: self.rebuilds
        )
