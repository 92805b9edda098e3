"""Eviction policy layer: host-side victim selection (counterpart of
``loghisto_tpu/lifecycle/policy.py``, copied: pure host code).

Policies are pure functions over host data — the device never decides
who dies.  Two policies compose (union of victims):

  * TTL/idle: a live series whose ``last_active`` epoch is more than
    ``ttl_intervals`` behind the current epoch is idle — retire it.
  * max-cardinality: a global ``max_live`` budget plus per-prefix
    budgets keyed by glob; over-budget populations shed their LEAST
    recently active members first (the same recency signal, reused).

Victims are folded into a catch-all overflow series named by
``overflow_name`` (default: ``_overflow.<first dot segment>``), so the
per-prefix total stays exact even though per-series identity is gone —
the log-bucket merge-by-addition property is what makes the fold
lossless at the bucket level.  Overflow series and anything matching a
``protect`` glob are never victims (an overflow that evicted itself
into itself would be a livelock, not a policy).
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

OVERFLOW_PREFIX = "_overflow."


def default_overflow_name(name: str) -> str:
    """``api.users.u12345.latency`` -> ``_overflow.api`` — one catch-all
    per top-level dot segment, so dashboards keep a per-subsystem total
    after per-user identity is dropped.  Labeled series (canonical
    ``base;k=v`` rows) shed their label tail first:
    ``http.latency;route=/api;user=u99`` folds into ``_overflow.http``,
    so a cardinality explosion across label sets still lands in ONE
    count-exact catch-all per subsystem."""
    base = name.split(";", 1)[0]
    return OVERFLOW_PREFIX + base.split(".", 1)[0]


@dataclass(frozen=True)
class LifecycleConfig:
    """Knobs for the lifecycle subsystem.  All policies are optional;
    with neither ``ttl_intervals`` nor a budget set, the subsystem only
    tracks activity (and compaction can still be invoked manually).

    ttl_intervals     — evict a series idle for more than this many
                        committed intervals (None disables TTL)
    max_live          — global live-series budget (None = unbounded)
    prefix_budgets    — glob -> live budget for the matching population
    label_budgets     — base-name glob -> max live LABEL SETS per
                        matching base: every label set is a
                        registry row, so a runaway label dimension is
                        the cardinality failure mode — an over-budget
                        base sheds its least recently active label sets
                        into the overflow catch-all, count-exactly,
                        while flat series and other bases are untouched
    overflow_name     — victim name -> catch-all name its lifetime
                        state folds into
    protect           — globs never evicted (overflow names are always
                        protected, no need to list them)
    check_every       — run the policies every N committed intervals
    auto_compact_fragmentation — repack the device rows when freed
                        slots exceed this fraction of the high-water
                        row count (0 disables auto-compaction)
    min_compact_rows  — never auto-compact below this many freed rows
                        (a repack has a fixed dispatch cost; reclaiming
                        a handful of rows is not worth it)
    compact_path      — repack dispatch; the port takes only "auto" (the
                        device decides, ops.lifecycle.resolve_compact_path)
    """

    ttl_intervals: Optional[int] = None
    max_live: Optional[int] = None
    prefix_budgets: Dict[str, int] = field(default_factory=dict)
    label_budgets: Dict[str, int] = field(default_factory=dict)
    overflow_name: Callable[[str], str] = default_overflow_name
    protect: Tuple[str, ...] = ()
    check_every: int = 8
    auto_compact_fragmentation: float = 0.5
    min_compact_rows: int = 64
    compact_path: str = "auto"

    def __post_init__(self):
        if self.ttl_intervals is not None and self.ttl_intervals < 1:
            raise ValueError("ttl_intervals must be >= 1")
        if self.max_live is not None and self.max_live < 1:
            raise ValueError("max_live must be >= 1")
        for pat, budget in self.prefix_budgets.items():
            if budget < 0:
                raise ValueError(f"prefix budget {pat!r} is negative")
        for pat, budget in self.label_budgets.items():
            if budget < 0:
                raise ValueError(f"label budget {pat!r} is negative")
        if self.check_every < 1:
            raise ValueError("check_every must be >= 1")

    def is_protected(self, name: str) -> bool:
        if name.startswith(OVERFLOW_PREFIX):
            return True
        return any(fnmatch.fnmatch(name, pat) for pat in self.protect)


def decide_victims(
    names: Sequence[Optional[str]],
    last_active: Sequence[int],
    epoch: int,
    config: LifecycleConfig,
) -> List[int]:
    """Pure victim selection: dense id -> name table (None = free
    slot), per-id last-active epochs, and the current epoch in, sorted
    victim ids out.  Ids beyond ``len(last_active)`` have no device row
    yet (registry ran ahead of the accumulator) and are never victims.
    """
    live: List[Tuple[int, str, int]] = []  # (mid, name, last_active)
    for mid, name in enumerate(names):
        if name is None or config.is_protected(name):
            continue
        if mid >= len(last_active):
            continue
        live.append((mid, name, int(last_active[mid])))

    victims: set[int] = set()
    if config.ttl_intervals is not None:
        cutoff = epoch - config.ttl_intervals
        victims.update(m for m, _, la in live if la < cutoff)

    # budget passes see the TTL victims as already gone, so a combined
    # policy never over-evicts
    def over_budget(pop: List[Tuple[int, str, int]], budget: int):
        pop = [e for e in pop if e[0] not in victims]
        excess = len(pop) - budget
        if excess <= 0:
            return
        pop.sort(key=lambda e: e[2])  # least recently active first
        victims.update(m for m, _, _ in pop[:excess])

    for pat, budget in config.prefix_budgets.items():
        over_budget(
            [e for e in live if fnmatch.fnmatch(e[1], pat)], budget
        )
    # label-cardinality budgets: each budget caps the LABEL
    # SETS of every base name matching its glob, independently per base
    # — ``{"http.*": 100}`` lets http.latency AND http.bytes each keep
    # 100 label sets.  Only labeled rows (canonical ``base;k=v``) count
    # toward or fall to a label budget; the flat base row is exempt.
    if config.label_budgets:
        by_base: Dict[str, List[Tuple[int, str, int]]] = {}
        for e in live:
            if ";" not in e[1]:
                continue
            by_base.setdefault(e[1].split(";", 1)[0], []).append(e)
        for pat, budget in config.label_budgets.items():
            for base, pop in by_base.items():
                if fnmatch.fnmatch(base, pat):
                    over_budget(pop, budget)
    if config.max_live is not None:
        over_budget(list(live), config.max_live)
    return sorted(victims)
