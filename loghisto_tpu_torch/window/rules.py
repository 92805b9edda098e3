"""Rule engine over the timewheel: threshold, rate-of-change,
multiwindow SLO burn-rate and distribution-drift alerting (counterpart
of ``loghisto_tpu/window/rules.py``, host logic over ``TimeWheel.query``,
``window_rate``, the drift engine's scores and the federation receiver's
freshness totals).

Rules are evaluated once per pushed interval against the wheel's
windowed views — the wheel, not the live interval, is what makes them
meaningful: "p99 over 5 minutes above 250ms" and "error budget burning
14.4x" are window statements, and the wheel answers them with one device
reduction each.

Alert delivery rides the repo's two existing export paths:

  * a subscriber channel (``RuleEngine.subscribe``) carrying ``Alert``
    events with the same non-blocking strike-eviction contract as the
    MetricSystem broadcast, and
  * gauges — ``register_gauges(ms)`` publishes ``alert.<rule>`` (0/1
    firing state) and ``alert.<rule>.value`` per rule, so the
    Prometheus/Graphite/OpenTSDB exporters carry alert state with zero
    new protocol code.

``slo_burn_rate`` follows the multiwindow discipline: fire only when the
budget burns hot over BOTH the long window (sustained, not a blip) and
the short window (still happening, not stale) — the standard fast-burn
page shape (e.g. 14.4x over 1h AND 5m for a 99.9% SLO).
"""

from __future__ import annotations

import collections
import dataclasses
import datetime as _dt
import logging
import threading
import time
from typing import Callable, Deque, Dict, List, Optional

from loghisto_tpu_torch.channel import Channel
from loghisto_tpu_torch.window.store import TimeWheel, pct_key

logger = logging.getLogger("loghisto_tpu_torch")

FIRING = "firing"
RESOLVED = "resolved"

_ALERT_EVICTION_STRIKES = 2  # reference eviction contract (metrics.go:574)


@dataclasses.dataclass
class Alert:
    """One alert transition event (fired or resolved)."""

    time: _dt.datetime
    rule: str
    state: str            # FIRING | RESOLVED
    value: Optional[float]
    threshold: float
    message: str


class Rule:
    """One named condition over the wheel.

    ``for_intervals`` is the consecutive-breach count required before the
    rule fires (debounce); a single non-breaching evaluation resolves
    it.  Subclasses implement ``observe(wheel) -> (value, breach)``;
    value may be None when the wheel has no covering data yet (treated
    as not breaching — an empty wheel must not page)."""

    def __init__(self, name: str, threshold: float, for_intervals: int = 1):
        if not name:
            raise ValueError("rule name must be non-empty")
        if for_intervals < 1:
            raise ValueError("for_intervals must be >= 1")
        self.name = name
        self.threshold = float(threshold)
        self.for_intervals = int(for_intervals)
        self.firing = False
        self.last_value: Optional[float] = None
        self._streak = 0

    def observe(self, wheel: TimeWheel):
        raise NotImplementedError

    def describe(self) -> str:
        raise NotImplementedError

    def device_windows(self) -> tuple:
        """Trailing windows (seconds) this rule queries on DEVICE (via
        ``wheel.query``) — the engine pins them so the commit path
        materializes snapshot views and evaluation costs one sparse
        gather instead of a full recompute.  Host-side counter rules
        (``window_counter``) return () — nothing to pin."""
        return ()

    def evaluate(self, wheel: TimeWheel, now: _dt.datetime) -> Optional[Alert]:
        """Run one evaluation step; returns a transition Alert or None."""
        value, breach = self.observe(wheel)
        self.last_value = value
        if breach:
            self._streak += 1
            if not self.firing and self._streak >= self.for_intervals:
                self.firing = True
                return Alert(
                    time=now, rule=self.name, state=FIRING, value=value,
                    threshold=self.threshold,
                    message=f"{self.describe()}: value={value}",
                )
        else:
            self._streak = 0
            if self.firing:
                self.firing = False
                return Alert(
                    time=now, rule=self.name, state=RESOLVED, value=value,
                    threshold=self.threshold,
                    message=f"{self.describe()}: recovered, value={value}",
                )
        return None


class ThresholdRule(Rule):
    """Fire when a windowed statistic of one metric crosses a limit.

    ``stat`` is any key a wheel query emits for the metric: "p99" (any
    ``pXX[.X]`` percentile), "count", "sum", or "avg".  ``op`` is ">" or
    "<"."""

    def __init__(
        self,
        name: str,
        metric: str,
        stat: str,
        window: float,
        threshold: float,
        op: str = ">",
        for_intervals: int = 1,
    ):
        super().__init__(name, threshold, for_intervals)
        if op not in (">", "<"):
            raise ValueError(f"op must be '>' or '<', got {op!r}")
        self.metric = metric
        self.stat = stat
        self.window = float(window)
        self.op = op
        self._ps: tuple[float, ...] = ()
        if stat.startswith("p"):
            try:
                q = float(stat[1:]) / 100.0
            except ValueError:
                raise ValueError(f"unrecognized stat {stat!r}") from None
            if not 0.0 <= q <= 1.0:
                raise ValueError(f"percentile stat {stat!r} out of range")
            # normalize the key through pct_key so "p99.0" finds "p99"
            self.stat = pct_key(q)
            self._ps = (q,)
        elif stat not in ("count", "sum", "avg"):
            raise ValueError(f"unrecognized stat {stat!r}")

    def observe(self, wheel: TimeWheel):
        res = wheel.query(self.metric, self.window, percentiles=self._ps)
        entry = res.metrics.get(self.metric)
        if entry is None:
            return None, False
        value = entry[self.stat]
        breach = value > self.threshold if self.op == ">" else (
            value < self.threshold
        )
        return value, breach

    def describe(self) -> str:
        return (
            f"{self.metric} {self.stat} over {self.window:g}s "
            f"{self.op} {self.threshold:g}"
        )

    def device_windows(self) -> tuple:
        return (self.window,)


class RateOfChangeRule(Rule):
    """Fire when a counter's rate jumps relative to the preceding window.

    Compares events/s over the trailing ``window`` against events/s over
    the window immediately before it (both served by the wheel's
    per-slot counter vectors); fires when the delta exceeds
    ``threshold`` (absolute delta when ``absolute=True``, catching
    cliffs in either direction)."""

    def __init__(
        self,
        name: str,
        counter: str,
        window: float,
        threshold: float,
        absolute: bool = False,
        for_intervals: int = 1,
    ):
        super().__init__(name, threshold, for_intervals)
        self.counter = counter
        self.window = float(window)
        self.absolute = absolute

    def observe(self, wheel: TimeWheel):
        total_2w, cov_2w = wheel.window_counter(self.counter, 2 * self.window)
        total_w, cov_w = wheel.window_counter(self.counter, self.window)
        prev_cov = cov_2w - cov_w
        if cov_w <= 0 or prev_cov <= 0:
            return None, False  # not enough history for a comparison yet
        rate_now = total_w / cov_w
        rate_prev = (total_2w - total_w) / prev_cov
        delta = rate_now - rate_prev
        value = abs(delta) if self.absolute else delta
        return value, value > self.threshold

    def describe(self) -> str:
        kind = "|Δrate|" if self.absolute else "Δrate"
        return (
            f"{self.counter} {kind} over {self.window:g}s "
            f"> {self.threshold:g}/s"
        )


class SloBurnRateRule(Rule):
    """Multiwindow error-budget burn-rate rule.

    burn(w) = (errors/total over w) / (1 - objective); a burn rate of 1
    spends the budget exactly over the SLO period.  Fires when burn
    exceeds ``threshold`` over BOTH ``long_window`` (sustained) and
    ``short_window`` (still happening) — the classic fast-burn pairing
    is threshold=14.4, long=1h, short=5m for a 99.9% objective.

    The reported value is the long-window burn (the budget statement);
    both burns are kept on the rule for inspection."""

    def __init__(
        self,
        name: str,
        error_counter: str,
        total_counter: str,
        objective: float,
        long_window: float,
        short_window: float,
        threshold: float = 14.4,
        for_intervals: int = 1,
    ):
        super().__init__(name, threshold, for_intervals)
        if not 0.0 < objective < 1.0:
            raise ValueError("objective must be in (0, 1), e.g. 0.999")
        if short_window >= long_window:
            raise ValueError("short_window must be < long_window")
        self.error_counter = error_counter
        self.total_counter = total_counter
        self.objective = float(objective)
        self.long_window = float(long_window)
        self.short_window = float(short_window)
        self.long_burn: Optional[float] = None
        self.short_burn: Optional[float] = None

    def _burn(self, wheel: TimeWheel, window: float) -> Optional[float]:
        errors, _ = wheel.window_counter(self.error_counter, window)
        total, _ = wheel.window_counter(self.total_counter, window)
        if total <= 0:
            return None
        return (errors / total) / (1.0 - self.objective)

    def observe(self, wheel: TimeWheel):
        self.long_burn = self._burn(wheel, self.long_window)
        self.short_burn = self._burn(wheel, self.short_window)
        if self.long_burn is None or self.short_burn is None:
            return self.long_burn, False
        breach = (
            self.long_burn > self.threshold
            and self.short_burn > self.threshold
        )
        return self.long_burn, breach

    def describe(self) -> str:
        return (
            f"{self.error_counter}/{self.total_counter} burn rate > "
            f"{self.threshold:g}x over both {self.long_window:g}s and "
            f"{self.short_window:g}s (objective {self.objective})"
        )


class DistributionDriftRule(Rule):
    """Fire when a metric's distribution SHAPE drifts from its EWMA
    baseline — the drift engine's divergence scores
    (``loghisto_tpu_torch.anomaly``), not a scalar statistic: a bimodal
    latency regression pages while p50 sits flat, and a pure rate change
    (same shape, more traffic) does not.

    ``stat`` is "jsd" (Jensen-Shannon, [0, 1], the default), "ks" (max
    CDF gap, [0, 1]) or "emd" (bucket-space earth-mover's, in bucket
    steps); the threshold is in its units.  The rule reads
    ``AnomalyManager.scores_for`` (generation-keyed: a dead or reused id
    reads as no data); an unbound rule or an unscored metric observes
    None and does not page.  ``TorchMetricSystem.add_rule`` binds the
    system's manager; standalone use passes ``manager=``."""

    kind = "distribution_drift"

    def __init__(
        self,
        name: str,
        metric: str,
        stat: str = "jsd",
        threshold: float = 0.1,
        for_intervals: int = 1,
        manager=None,
    ):
        super().__init__(name, threshold, for_intervals)
        if stat not in ("ks", "jsd", "emd"):
            raise ValueError(
                f"stat must be 'ks', 'jsd', or 'emd', got {stat!r}"
            )
        self.metric = metric
        self.stat = stat
        self._manager = manager

    def bind(self, manager) -> None:
        """Attach the AnomalyManager serving this rule's scores."""
        self._manager = manager

    def observe(self, wheel: TimeWheel):
        if self._manager is None:
            return None, False
        scores = self._manager.scores_for(self.metric)
        if scores is None:
            return None, False
        value = scores[self.stat]
        return value, value > self.threshold

    def describe(self) -> str:
        return (
            f"{self.metric} distribution drift {self.stat} > "
            f"{self.threshold:g}"
        )


class FreshnessSloRule(Rule):
    """Multiwindow SLO-burn rule over federation END-TO-END FRESHNESS
    (record → queryable latency) instead of an error counter.

    An "error" is a freshness sample whose log-bucket lies above
    ``budget_us``; burn(w) = (errors/total over w) / (1 - objective).
    Totals come from the receiver's freshness histograms
    (``FederationReceiver.freshness_totals`` — fleet-wide, or one
    emitter with ``emitter_id``), which only ever grow, so trailing
    windows are computed by differencing snapshots the rule takes at
    each evaluation — no wheel queries, no device work.  Fires when
    burn exceeds ``threshold`` over BOTH ``long_window`` (sustained)
    and ``short_window`` (still happening), like ``SloBurnRateRule``.

    ``TorchMetricSystem.add_rule`` binds the system's federation receiver
    automatically; standalone use passes ``receiver=`` directly.
    Unbound rules (or ones whose windows have seen no new samples)
    observe None — no data must not page."""

    kind = "freshness"

    def __init__(
        self,
        name: str,
        budget_us: float,
        objective: float = 0.99,
        long_window: float = 300.0,
        short_window: float = 60.0,
        threshold: float = 2.0,
        emitter_id: Optional[int] = None,
        for_intervals: int = 1,
        receiver=None,
    ):
        super().__init__(name, threshold, for_intervals)
        if budget_us <= 0:
            raise ValueError("budget_us must be > 0")
        if not 0.0 < objective < 1.0:
            raise ValueError("objective must be in (0, 1), e.g. 0.99")
        if short_window >= long_window:
            raise ValueError("short_window must be < long_window")
        self.budget_us = float(budget_us)
        self.objective = float(objective)
        self.long_window = float(long_window)
        self.short_window = float(short_window)
        self.emitter_id = emitter_id
        self._receiver = receiver
        # (monotonic t, total, over-budget) snapshots, oldest first; one
        # snapshot older than long_window is kept as the baseline
        self._snaps: collections.deque = collections.deque()
        self.long_burn: Optional[float] = None
        self.short_burn: Optional[float] = None

    def bind(self, receiver) -> None:
        """Attach the FederationReceiver serving this rule's totals."""
        self._receiver = receiver

    def _burn(self, now: float, window: float) -> Optional[float]:
        base = None
        for t, tot, ab in self._snaps:
            if now - t >= window:
                base = (tot, ab)
            else:
                break
        if base is None:
            if len(self._snaps) < 2:
                return None  # no history to difference against yet
            _, tot, ab = self._snaps[0]
            base = (tot, ab)
        _, cur_total, cur_above = self._snaps[-1]
        d_total = cur_total - base[0]
        if d_total <= 0:
            return None
        frac = (cur_above - base[1]) / d_total
        return frac / (1.0 - self.objective)

    def observe(self, wheel: TimeWheel):
        if self._receiver is None:
            return None, False
        total, above = self._receiver.freshness_totals(
            self.budget_us, self.emitter_id
        )
        now = time.monotonic()
        self._snaps.append((now, total, above))
        while (len(self._snaps) >= 2
               and now - self._snaps[1][0] >= self.long_window):
            self._snaps.popleft()
        self.long_burn = self._burn(now, self.long_window)
        self.short_burn = self._burn(now, self.short_window)
        if self.long_burn is None or self.short_burn is None:
            return self.long_burn, False
        breach = (
            self.long_burn > self.threshold
            and self.short_burn > self.threshold
        )
        return self.long_burn, breach

    def describe(self) -> str:
        scope = (
            f"emitter {self.emitter_id:016x}" if self.emitter_id is not None
            else "fleet"
        )
        return (
            f"{scope} freshness > {self.budget_us:g}us burn rate > "
            f"{self.threshold:g}x over both {self.long_window:g}s and "
            f"{self.short_window:g}s (objective {self.objective})"
        )

    def device_windows(self) -> tuple:
        # totals come from the receiver's host-side histograms; the
        # rule queries nothing on device
        return ()


class RuleEngine:
    """Evaluates registered rules against a wheel each interval and
    broadcasts alert transitions.

    ``attach()`` hooks the wheel's interval push, so evaluation runs on
    the wheel's bridge thread right after the interval lands — rules see
    a window whose trailing edge includes the interval that triggered
    them."""

    def __init__(self, wheel: TimeWheel, history: int = 256):
        self.wheel = wheel
        self._rules: Dict[str, Rule] = {}
        self._lock = threading.Lock()
        self._subscribers: Dict[Channel, int] = {}
        self.history: Deque[Alert] = collections.deque(maxlen=history)
        self._attached = False

    def add(self, rule: Rule) -> Rule:
        with self._lock:
            if rule.name in self._rules:
                raise ValueError(f"rule {rule.name!r} already registered")
            self._rules[rule.name] = rule
        # materialize the rule's query windows as snapshot views, so
        # per-interval evaluation serves from the commit-time snapshot
        # (a sparse gather, or the cached result) instead of a full
        # locked recompute per rule per interval
        for w in rule.device_windows():
            self.wheel.pin_window(w)
        return rule

    def remove(self, name: str) -> None:
        with self._lock:
            self._rules.pop(name, None)

    def rules(self) -> List[Rule]:
        with self._lock:
            return list(self._rules.values())

    def active(self) -> List[str]:
        """Names of currently-firing rules."""
        with self._lock:
            return [r.name for r in self._rules.values() if r.firing]

    # -- evaluation ----------------------------------------------------- #

    def evaluate(self, now: Optional[_dt.datetime] = None) -> List[Alert]:
        """Evaluate every rule once; returns (and broadcasts) the alert
        transitions this step produced.  A raising rule is logged and
        skipped — one bad rule must not silence the rest."""
        if now is None:
            now = _dt.datetime.now(tz=_dt.timezone.utc)
        events: List[Alert] = []
        for rule in self.rules():
            try:
                alert = rule.evaluate(self.wheel, now)
            except Exception:
                logger.exception("rule %r evaluation failed", rule.name)
                continue
            if alert is not None:
                events.append(alert)
        for alert in events:
            logger.warning("alert %s: %s", alert.state, alert.message)
            self.history.append(alert)
            self._broadcast(alert)
        return events

    def attach(self) -> None:
        """Evaluate after every interval the wheel ingests."""
        if self._attached:
            return
        self._attached = True
        self.wheel.add_interval_hook(lambda raw: self.evaluate(raw.time))

    # -- delivery ------------------------------------------------------- #

    def subscribe(self, ch: Channel) -> None:
        with self._lock:
            self._subscribers.setdefault(ch, 0)

    def unsubscribe(self, ch: Channel) -> None:
        with self._lock:
            self._subscribers.pop(ch, None)

    def _broadcast(self, alert: Alert) -> None:
        """Non-blocking, strike-evicting delivery — same shed-don't-block
        contract as the MetricSystem broadcast."""
        with self._lock:
            evict = []
            for ch in self._subscribers:
                if ch.closed:
                    evict.append(ch)
                    continue
                if ch.offer(alert):
                    self._subscribers[ch] = 0
                else:
                    self._subscribers[ch] += 1
                    logger.error(
                        "alert subscriber channel full; dropping %s",
                        alert.rule,
                    )
                    if self._subscribers[ch] >= _ALERT_EVICTION_STRIKES:
                        evict.append(ch)
            for ch in evict:
                del self._subscribers[ch]
                ch.close()

    # -- exporter integration ------------------------------------------- #

    def register_gauges(self, ms) -> None:
        """Publish engine state as gauges on a MetricSystem, so every
        existing exporter (Prometheus endpoint, Graphite/OpenTSDB
        submitters) carries alert state: ``alert.<rule>`` is 1 while
        firing, ``alert.<rule>.value`` is the rule's last observation,
        and ``alerts.firing`` counts active alerts."""
        engine = self

        def make_state(name: str) -> Callable[[], float]:
            return lambda: (
                1.0 if (r := engine._rules.get(name)) and r.firing else 0.0
            )

        def make_value(name: str) -> Callable[[], float]:
            def value() -> float:
                r = engine._rules.get(name)
                v = r.last_value if r is not None else None
                return float(v) if v is not None else 0.0
            return value

        with self._lock:
            names = list(self._rules)
        for name in names:
            ms.register_gauge_func(f"alert.{name}", make_state(name))
            ms.register_gauge_func(f"alert.{name}.value", make_value(name))
        ms.register_gauge_func(
            "alerts.firing", lambda: float(len(engine.active()))
        )
