"""Deterministic fault injection for the chaos drills (counterpart of
``loghisto_tpu/resilience/faults.py``, copied: the same seed fires the
same sites on the same calls and ``mangle`` gives the same bytes).

Failure paths — a device failure mid-commit, a wedged transfer worker,
a crash between a journal append and a checkpoint rename — are code
that never runs in a clean test.  The ``FaultInjector`` scripts them:
every hook site calls ``check(site)`` (or ``mangle(site, text)`` for
data corruption) through one attribute read, and a seeded plan decides
which call at which site fires which fault.  Components hold
``fault_injector = None`` by default, so a disabled hook is one
attribute load and an ``is None`` test.

Hook sites in the port:

    commit.dispatch    inside the fused commit's try, before a chunk
    commit.bridge      committer bridge loop, outside the per-commit try
    agg.ingest         transfer worker's per-chunk device ingest
    agg.xfer_worker    transfer worker loop top (wedge / crash)
    wheel.push         time-wheel tier push
    checkpoint.write   before the npz payload is written
    checkpoint.rename  after fsync, before the atomic rename
    journal.append     mangle() over the serialized line (torn/corrupt)
    export.send        submitter send path
    recovery.tick      recovery manager's cadenced checkpoint

(The reference's ``fed.*`` sites come with federation.)

Actions: ``raise`` (InjectedFault), ``delay`` (sleep ``delay_s``),
``wedge`` (block until ``release_wedges()``, bounded by
``wedge_timeout_s``), ``clock_step`` (arm a clock offset readable via
``clock_offset()``), and for ``mangle`` ``corrupt`` and ``truncate``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


class InjectedFault(RuntimeError):
    """A scripted fault fired at a hook site.  Deliberately a RuntimeError
    subclass so the pipeline's real except-nets treat it exactly like the
    organic failure it stands in for."""


@dataclass
class FaultRule:
    site: str
    action: str = "raise"          # raise | delay | wedge | clock_step
    on_call: Optional[int] = None  # fire on the Nth check() at this site
    every: Optional[int] = None    # or on every Nth call
    times: int = 1                 # stop after firing this many times
    delay_s: float = 0.05          # for action="delay"
    step_s: float = -60.0          # for action="clock_step"
    calls: int = 0
    fires: int = 0

    def should_fire(self) -> bool:
        self.calls += 1
        if self.fires >= self.times:
            return False
        if self.on_call is not None and self.calls != self.on_call:
            return False
        if self.every is not None and self.calls % self.every != 0:
            return False
        if self.on_call is None and self.every is None and self.calls != 1:
            return False
        self.fires += 1
        return True


class FaultInjector:
    """Seeded, scripted fault plans keyed by hook site.

    >>> inj = FaultInjector(seed=7)
    >>> inj.plan("commit.dispatch", on_call=3)          # doctest: +SKIP
    >>> inj.plan("journal.append", action="corrupt", on_call=2)

    Thread-safe: hook sites fire from the bridge / transfer-worker /
    reaper threads concurrently.  ``fired`` records every fault that
    fired as ``(site, action, call_number)`` for test assertions.
    """

    def __init__(self, seed: int = 0, wedge_timeout_s: float = 30.0):
        self.seed = seed
        self.wedge_timeout_s = wedge_timeout_s
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._rules: Dict[str, List[FaultRule]] = {}
        self._wedge_release = threading.Event()
        self._clock_offset = 0.0
        self.fired: List[Tuple[str, str, int]] = []
        self.faults_injected = 0
        self.wedged_now = 0

    # -- plan construction -------------------------------------------- #

    def plan(
        self,
        site: str,
        action: str = "raise",
        *,
        on_call: Optional[int] = None,
        every: Optional[int] = None,
        times: int = 1,
        delay_s: float = 0.05,
        step_s: float = -60.0,
    ) -> "FaultInjector":
        """Script a fault at ``site``; returns self for chaining.  With
        neither ``on_call`` nor ``every``, fires on the first call."""
        if action not in ("raise", "delay", "wedge", "clock_step",
                          "corrupt", "truncate"):
            raise ValueError(f"unknown fault action {action!r}")
        rule = FaultRule(
            site=site, action=action, on_call=on_call, every=every,
            times=times, delay_s=delay_s, step_s=step_s,
        )
        with self._lock:
            self._rules.setdefault(site, []).append(rule)
        return self

    def reset(self) -> None:
        with self._lock:
            self._rules.clear()
            self.fired.clear()
            self._clock_offset = 0.0
        self.release_wedges()
        self._wedge_release.clear()

    # -- hook-site API -------------------------------------------------- #

    def check(self, site: str) -> None:
        """Hot hook: fire any scripted fault due at ``site``.  Raises
        InjectedFault for action="raise"; blocks for delay/wedge; arms
        the clock offset for clock_step."""
        with self._lock:
            rules = self._rules.get(site)
            if not rules:
                return
            due = None
            for rule in rules:
                if rule.should_fire():
                    due = rule
                    break
            if due is None:
                return
            self.fired.append((site, due.action, due.calls))
            self.faults_injected += 1
            if due.action == "clock_step":
                self._clock_offset += due.step_s
                return
        # block/raise outside the lock: a wedged worker must not wedge
        # every other hook site with it
        if due.action == "raise":
            raise InjectedFault(f"injected fault at {site} "
                                f"(call {due.calls})")
        if due.action == "delay":
            time.sleep(due.delay_s)
            return
        if due.action == "wedge":
            self.wedged_now += 1
            try:
                self._wedge_release.wait(timeout=self.wedge_timeout_s)
            finally:
                self.wedged_now -= 1
            return

    def mangle(self, site: str, text: str) -> str:
        """Data-corruption hook (journal append): return ``text`` mangled
        per any due rule at ``site``.  action="truncate" tears the line
        at a seeded offset (crash mid-append); action="corrupt" flips it
        into non-JSON junk."""
        with self._lock:
            rules = self._rules.get(site)
            if not rules:
                return text
            due = None
            for rule in rules:
                if rule.action in ("corrupt", "truncate") \
                        and rule.should_fire():
                    due = rule
                    break
            if due is None:
                return text
            self.fired.append((site, due.action, due.calls))
            self.faults_injected += 1
            if due.action == "truncate":
                cut = int(self._rng.integers(1, max(len(text) - 1, 2)))
                return text[:cut]
            return "\x00corrupt " + text[: max(len(text) // 4, 1)]

    def clock_offset(self) -> float:
        """Armed backward/forward clock step (seconds), consumed by
        time-sensitive sites (recovery cadence, breaker windows)."""
        with self._lock:
            return self._clock_offset

    def release_wedges(self) -> None:
        """Un-wedge every blocked hook site (chaos-test recovery step)."""
        self._wedge_release.set()

    # -- introspection -------------------------------------------------- #

    def fires_at(self, site: str) -> int:
        with self._lock:
            return sum(r.fires for r in self._rules.get(site, ()))
