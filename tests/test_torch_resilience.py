"""The resilience primitives (``loghisto_tpu_torch.resilience``) against
the JAX package's (``loghisto_tpu.resilience``): capped backoff, the
circuit breaker's state machine, fault-injector plans and supervised
threads.  Port copies of ``tests/test_resilience.py``: every scenario
runs in both packages and the observable results (delays, states,
``fired`` ledgers, ``mangle`` bytes, restart ledgers) are EQUAL.

No assertion reads the wall clock: the breaker's window and open time
run on a patched clock, wedges are released by hand, and every wait is
on a counter with a 30 s deadline."""

import json
import threading
import time

import numpy as np
import pytest

import loghisto_tpu.resilience as jax_res
import loghisto_tpu.resilience.recovery as jax_recovery
import loghisto_tpu_torch.resilience as port_res
import loghisto_tpu_torch.resilience.recovery as port_recovery

PACKAGES = (jax_res, port_res)
DEADLINE_S = 30.0


def _wait(cond, what):
    deadline = time.monotonic() + DEADLINE_S
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


def _both(fn):
    """fn(package) in the JAX package and the port; the results must be
    equal, and the port's is returned."""
    want, got = fn(jax_res), fn(port_res)
    assert got == want
    return got


class FakeClock:
    """``time.monotonic`` for the breaker, moved by hand."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def perf_counter(self):
        return time.perf_counter()


@pytest.fixture
def clock(monkeypatch):
    fake = FakeClock()
    for mod in (jax_recovery, port_recovery):
        monkeypatch.setattr(mod, "time", fake)
    return fake


# -- Backoff ----------------------------------------------------------------


def test_backoff_grows_and_caps():
    def run(pkg):
        bo = pkg.Backoff(base_s=0.1, cap_s=0.8, multiplier=2.0, jitter=0.0)
        delays = [bo.next_delay() for _ in range(5)]
        bo.reset()
        return delays, bo.next_delay()

    delays, after_reset = _both(run)
    assert delays == [0.1, 0.2, 0.4, 0.8, 0.8]
    assert after_reset == 0.1


def test_backoff_jitter_is_seeded_and_bounded():
    def run(pkg):
        a = pkg.Backoff(base_s=1.0, cap_s=1.0, jitter=0.25, seed=7)
        b = pkg.Backoff(base_s=1.0, cap_s=1.0, jitter=0.25, seed=7)
        return a.next_delay(), b.next_delay()

    da, db = _both(run)
    assert da == db
    assert 0.75 <= da <= 1.25


@pytest.mark.parametrize("kw", [dict(base_s=0.0),
                                dict(base_s=2.0, cap_s=1.0),
                                dict(multiplier=0.5)])
def test_backoff_validates_params(kw):
    for pkg in PACKAGES:
        with pytest.raises(ValueError):
            pkg.Backoff(**kw)


# -- CircuitBreaker ---------------------------------------------------------


def test_breaker_opens_at_threshold_and_recloses(clock):
    def run(pkg):
        br = pkg.CircuitBreaker(threshold=3, window_s=30.0, open_s=0.05)
        trace = [br.state, br.record_failure(), br.record_failure(),
                 br.record_failure(), br.state, br.opened_total, br.is_open()]
        clock.now += 0.06
        # open_s passed: is_open() lets ONE trial through (half-open)
        trace += [br.is_open(), br.state]
        br.record_success()
        trace.append(br.state)
        clock.now -= 0.06
        return trace

    assert _both(run) == ["closed", False, False, True, "open", 1, True,
                          False, "half-open", "closed"]


def test_breaker_half_open_failure_reopens(clock):
    def run(pkg):
        br = pkg.CircuitBreaker(threshold=1, window_s=30.0, open_s=0.01)
        br.record_failure()
        trace = [br.state]
        clock.now += 0.02
        trace += [br.is_open(), br.record_failure(), br.state,
                  br.opened_total]
        return trace

    assert _both(run) == ["open", False, True, "open", 2]


def test_breaker_window_prunes_stale_failures(clock):
    def run(pkg):
        br = pkg.CircuitBreaker(threshold=3, window_s=0.05, open_s=1.0)
        br.record_failure()
        br.record_failure()
        clock.now += 0.08  # both age out of the window
        return br.record_failure(), br.state, br.failures_total

    assert _both(run) == (False, "closed", 3)


# -- FaultInjector ----------------------------------------------------------


def test_injector_fires_on_scripted_call():
    def run(pkg):
        inj = pkg.FaultInjector()
        inj.plan("site.a", "raise", on_call=3)
        inj.check("site.a")
        inj.check("site.a")
        with pytest.raises(pkg.InjectedFault):
            inj.check("site.a")
        inj.check("site.a")  # times=1 spent: never fires again
        return list(inj.fired), inj.faults_injected

    assert _both(run) == ([("site.a", "raise", 3)], 1)


def test_injector_every_with_times_budget():
    def run(pkg):
        inj = pkg.FaultInjector()
        inj.plan("s", "raise", every=1, times=2)
        raised = []
        for _ in range(4):
            try:
                inj.check("s")
                raised.append(False)
            except pkg.InjectedFault:
                raised.append(True)
        return raised, inj.fires_at("s")

    assert _both(run) == ([True, True, False, False], 2)


def test_injector_unknown_action_rejected():
    for pkg in PACKAGES:
        with pytest.raises(ValueError):
            pkg.FaultInjector().plan("s", "explode")


def test_injector_disabled_site_is_noop():
    def run(pkg):
        inj = pkg.FaultInjector()
        inj.plan("other.site", "raise")
        inj.check("never.planned")  # no rules here: returns silently
        return inj.faults_injected, inj.fires_at("other.site")

    assert _both(run) == (0, 0)


def test_injector_truncate_always_tears_the_line():
    line = '{"v":1,"counters":{"x":1}}\n'

    def run(pkg):
        inj = pkg.FaultInjector(seed=5)
        inj.plan("journal.append", "truncate")
        torn = inj.mangle("journal.append", line)
        return torn, inj.mangle("journal.append", line)

    torn, after = _both(run)
    assert torn != line and len(torn) < len(line) - 1
    assert after == line  # rules spent: later lines pass untouched


def test_injector_corrupt_produces_non_json():
    def run(pkg):
        inj = pkg.FaultInjector()
        inj.plan("journal.append", "corrupt")
        return inj.mangle("journal.append", '{"v":1}\n')

    out = _both(run)
    with pytest.raises(json.JSONDecodeError):
        json.loads(out)


def test_injector_clock_step_accumulates():
    def run(pkg):
        inj = pkg.FaultInjector()
        inj.plan("recovery.tick", "clock_step", step_s=-60.0)
        before = inj.clock_offset()
        inj.check("recovery.tick")
        return before, inj.clock_offset()

    assert _both(run) == (0.0, -60.0)


def test_injector_wedge_releases():
    def run(pkg):
        inj = pkg.FaultInjector(wedge_timeout_s=DEADLINE_S)
        inj.plan("w", "wedge")
        t = threading.Thread(target=inj.check, args=("w",), daemon=True)
        t.start()
        _wait(lambda: inj.wedged_now == 1, "the wedge")
        wedged = inj.wedged_now
        inj.release_wedges()
        t.join(timeout=DEADLINE_S)
        return wedged, t.is_alive(), inj.wedged_now

    assert _both(run) == (1, False, 0)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_injector_plan_parity_fires_and_mangles(seed):
    """A seeded random plan over several sites and actions: the same
    calls fire in both packages, and every mangled line is the same
    bytes."""
    rng = np.random.default_rng(seed)
    plans = []
    for site in ("commit.dispatch", "agg.ingest", "wheel.push"):
        for _ in range(int(rng.integers(1, 4))):
            kind = int(rng.integers(0, 3))
            kw = ({"on_call": int(rng.integers(1, 20))} if kind == 0
                  else {"every": int(rng.integers(1, 5)),
                        "times": int(rng.integers(1, 6))} if kind == 1
                  else {})
            plans.append((site, "raise", kw))
    for _ in range(int(rng.integers(2, 5))):
        action = ("truncate", "corrupt")[int(rng.integers(0, 2))]
        plans.append(("journal.append", action,
                      {"every": int(rng.integers(1, 4)),
                       "times": int(rng.integers(1, 4))}))
    calls = rng.choice(["commit.dispatch", "agg.ingest", "wheel.push",
                        "journal.append"], 200)
    lines = [json.dumps({"seq": i, "v": rng.integers(0, 1 << 30, 8).tolist()})
             for i in range(len(calls))]

    def run(pkg):
        inj = pkg.FaultInjector(seed=seed)
        for site, action, kw in plans:
            inj.plan(site, action, **kw)
        outcomes = []
        for site, line in zip(calls, lines):
            if site == "journal.append":
                outcomes.append(inj.mangle(site, line))
                continue
            try:
                inj.check(site)
                outcomes.append(None)
            except pkg.InjectedFault:
                outcomes.append("raised")
        fires = {s: inj.fires_at(s) for s in set(calls)}
        return outcomes, list(inj.fired), fires, inj.faults_injected

    outcomes, fired, fires, total = _both(run)
    assert total == len(fired) > 0


# -- SupervisedThread -------------------------------------------------------


def test_supervised_thread_restarts_after_crash():
    def run(pkg):
        sup = pkg.ThreadSupervisor(base_backoff_s=0.005, max_backoff_s=0.02)
        runs = []
        done = threading.Event()

        def target():
            runs.append(1)
            if len(runs) < 3:
                raise RuntimeError("boom")
            done.set()

        t = sup.spawn(target, "flaky")
        assert done.wait(DEADLINE_S)
        t.join(timeout=DEADLINE_S)
        return len(runs), sup.total_restarts, dict(sup.restarts_by_name)

    assert _both(run) == (3, 2, {"flaky": 2})


def test_supervised_thread_clean_return_never_restarts():
    def run(pkg):
        sup = pkg.ThreadSupervisor()
        runs = []
        t = sup.spawn(lambda: runs.append(1), "clean")
        t.join(timeout=DEADLINE_S)
        return runs, sup.total_restarts, t.is_alive()

    assert _both(run) == ([1], 0, False)


def test_supervised_thread_stop_wakes_backoff_nap():
    def run(pkg):
        # an hour's nap: only stop() can end it inside the join below
        sup = pkg.ThreadSupervisor(base_backoff_s=3600.0,
                                   max_backoff_s=3600.0)

        def always_crash():
            raise RuntimeError("boom")

        t = sup.spawn(always_crash, "crasher")
        _wait(lambda: sup.total_restarts >= 1, "the first restart")
        t.stop()
        t.join(timeout=DEADLINE_S)
        return t.is_alive(), sup.total_restarts, sup.current_backoff_ms() > 0

    assert _both(run) == (False, 1, True)


def test_supervised_thread_is_drop_in_for_thread_handle():
    def run(pkg):
        sup = pkg.ThreadSupervisor()
        gate = threading.Event()
        t = sup.spawn(gate.wait, "handle")
        before = (t.is_alive(), t.daemon, t.name)
        gate.set()
        t.join(timeout=DEADLINE_S)
        return before, t.is_alive()

    assert _both(run) == ((True, True, "handle"), False)


def test_supervised_join_from_inside_target_is_safe():
    def run(pkg):
        sup = pkg.ThreadSupervisor()
        handle = {}
        joined = threading.Event()

        def target():
            handle["t"].join(timeout=1.0)  # joining yourself must not raise
            joined.set()

        t = pkg.SupervisedThread(target, "selfjoin", sup,
                                 pkg.Backoff(base_s=0.01, cap_s=0.01))
        handle["t"] = t
        t.start()
        return joined.wait(DEADLINE_S), sup.total_restarts

    assert _both(run) == (True, 0)


def test_external_restart_counts_on_the_ledger():
    def run(pkg):
        sup = pkg.ThreadSupervisor()
        sup.note_external_restart("worker")
        sup.note_external_restart("worker")
        return sup.total_restarts, dict(sup.restarts_by_name)

    assert _both(run) == (2, {"worker": 2})


def test_resilience_gauges_match_the_reference():
    from loghisto_tpu.metrics import MetricSystem as JaxMetricSystem
    from loghisto_tpu_torch.metrics import MetricSystem

    def gauges(pkg, ms):
        sup = pkg.ThreadSupervisor()
        sup.note_external_restart("w")
        br = pkg.CircuitBreaker(threshold=1)
        br.record_failure()
        inj = pkg.FaultInjector()
        inj.plan("s", "clock_step")
        inj.check("s")
        pkg.register_resilience_gauges(ms, supervisor=sup, breaker=br,
                                       injector=inj)
        return {k: v for k, v in ms.collect_raw_metrics().gauges.items()
                if k.startswith(("resilience.", "journal."))
                and k != "journal.CorruptLines"}

    want = gauges(jax_res, JaxMetricSystem(interval=1e-6, sys_stats=False))
    got = gauges(port_res, MetricSystem(interval=1e-6, sys_stats=False))
    assert got == want
    assert got["resilience.ThreadRestarts"] == 1.0
    assert got["resilience.BreakerOpen"] == 1.0
