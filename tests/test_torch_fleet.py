"""Federation wired into ``TorchMetricSystem`` against the JAX package's
``TPUMetricSystem(federation=...)``, on the CPU.

  * ``FreshnessSloRule``: one script of freshness totals and clock steps
    gives EQUAL (burn, breach) readings from both packages' rules; both
    refuse the same arguments with the same words; an unbound rule
    observes no data;
  * ``add_rule``: a freshness rule without a federation tier raises the
    reference's words (``TorchMetricSystem`` in place of
    ``TPUMetricSystem``); with one, it binds the system's receiver;
  * the wiring: the receiver's publisher, thresholds, span ring and
    watchdog input, its gauge family and ``debug_dump()["federation"]``
    are the reference system's;
  * freshness completes at publish: frames applied before a commit stay
    pending until the commit's freshness hook runs, then the two
    systems' ledgers, gauges and dumps are EQUAL;
  * ``/fleetz`` answers 404 without a federation tier and 200 with one,
    with the reference's document;
  * the watchdog's ``emitter_starvation``, reached by moving the
    receivers' clocks;
  * a 4-emitter drill (one emitter falls silent after the first phase)
    whose frames go through ``_drain_buffer`` into both systems, an
    interval committed by hand after each phase: the processed metric
    sets of the drill's names, the freshness ledgers and totals, the
    rule states and the fleet reports are EQUAL, and the served
    ``fed.FreshnessUs`` p99 equals the host oracle over the ledger.

Clocks: each package's receiver and rule modules read one ``FakeTime``
(from ``test_torch_federation``: every read advances one microsecond), so
the two systems see the same instants.  No test sleeps, asserts a time or
starts a subprocess; the JAX commit steps are waited for
(``_synchronised``, ROADMAP F3).
"""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.federation import FederationConfig as JaxFedConfig
from loghisto_tpu.federation import receiver as jax_receiver_mod
from loghisto_tpu.federation import wire as jwire
from loghisto_tpu.metrics import MetricSystem as JaxMetricSystem
from loghisto_tpu.ops.codec import encode_frame as jax_encode_frame
from loghisto_tpu.prometheus import PrometheusEndpoint as JaxEndpoint
from loghisto_tpu.system import TPUMetricSystem
from loghisto_tpu.window import rules as jax_rules
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.federation import FederationConfig, wire
from loghisto_tpu_torch.federation import receiver as receiver_mod
from loghisto_tpu_torch.metrics import MetricSystem
from loghisto_tpu_torch.obs.perfetto import dump_perfetto, merge_traces
from loghisto_tpu_torch.obs.spans import SpanRecorder
from loghisto_tpu_torch.ops.codec import compress_np, encode_frame
from loghisto_tpu_torch.ops.stats import bucket_representatives
from loghisto_tpu_torch.prometheus import PrometheusEndpoint
from loghisto_tpu_torch.system import TorchMetricSystem
from loghisto_tpu_torch.window import rules

from test_torch_federation import FakeTime  # tests/ is on sys.path

BL = 128
M = 32
TIERS = ((8, 1),)
EMITTERS = 4
PHASES = 3
SILENT = 3          # the emitter that goes silent after phase 0
EMITTER0 = 10_000
SAMPLES = 400       # per emitter per phase, as the reference's drill


@pytest.fixture
def clocks(monkeypatch):
    """One fake clock per package for its receiver and rule modules:
    returns (port clock, JAX clock)."""
    port_t, jax_t = FakeTime(), FakeTime()
    for mod, clock in ((receiver_mod, port_t), (rules, port_t),
                       (jax_receiver_mod, jax_t), (jax_rules, jax_t)):
        monkeypatch.setattr(mod, "time", clock)
    return port_t, jax_t


def _synchronised(com):
    """Wait for each JAX commit step before the next is staged (ROADMAP
    F3: on the CPU ``jax.device_put`` reads the staging slot after it
    returns)."""
    for attr in ("_fused", "_fused_snap"):
        step = getattr(com, attr)
        setattr(com, attr,
                lambda *a, _step=step: jax.block_until_ready(_step(*a)))
    return com


def _systems(**fed):
    """(port system, JAX system), each with retention, observability and
    a federation tier of ``FederationConfig(**fed)``."""
    port = TorchMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=M,
        config=MetricConfig(bucket_limit=BL), retention=TIERS,
        observability=True, federation=FederationConfig(**fed),
        device="cpu")
    ref = TPUMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=M,
        config=JaxConfig(bucket_limit=BL), retention=TIERS,
        observability=True, federation=JaxFedConfig(**fed))
    _synchronised(ref.committer)
    return port, ref


def _commit(ms):
    """One interval by hand: every merge landed, then the commit (whose
    freshness hook completes the frames applied before it)."""
    assert ms.aggregator.wait_transfers(30.0)
    assert ms.backfill_retention([ms.collect_raw_metrics()]) == 1


def _fed_gauges(ms):
    with ms._gauge_lock:
        return sorted(k for k in ms._gauge_funcs
                      if k.startswith(("fed", "health.fleet",
                                       "health.emitter", "obs.Spans")))


# -- FreshnessSloRule ----------------------------------------------------- #


class _Totals:
    """A receiver that serves scripted freshness totals."""

    def __init__(self):
        self.total, self.above = 0, 0
        self.asked = []

    def freshness_totals(self, budget_us, emitter_id=None):
        self.asked.append((budget_us, emitter_id))
        return self.total, self.above


# (seconds to advance, total, over budget): a burn, a flood of clean
# traffic, a second burn, then quiet windows past the short and the
# long window
RULE_SCRIPT = ((0.0, 0, 0), (10.0, 100, 50), (10.0, 10_000, 50),
               (70.0, 20_000, 5_000), (30.0, 20_400, 5_400),
               (400.0, 20_400, 5_400), (30.0, 20_500, 5_401),
               (61.0, 20_600, 5_402))


def _rule_readings(rule_cls, clock, **kw):
    stub = _Totals()
    rule = rule_cls("fresh", budget_us=1000.0, objective=0.99,
                    threshold=2.0, receiver=stub, **kw)
    out = []
    for dt, total, above in RULE_SCRIPT:
        clock.advance(dt)
        stub.total, stub.above = total, above
        value, breach = rule.observe(None)
        out.append((value, breach, rule.long_burn, rule.short_burn))
    return out, rule.describe(), rule.device_windows(), stub.asked


@pytest.mark.parametrize("emitter_id", (None, 0xABC))
def test_freshness_rule_fires_and_resolves_as_jax(clocks, emitter_id):
    got = _rule_readings(rules.FreshnessSloRule, clocks[0],
                         emitter_id=emitter_id)
    want = _rule_readings(jax_rules.FreshnessSloRule, clocks[1],
                          emitter_id=emitter_id)
    assert got == want
    readings = got[0]
    assert readings[0][:2] == (None, False)  # one snapshot: no data
    assert readings[1][0] == pytest.approx(50.0) and readings[1][1]
    # clean traffic floods in: the trailing fraction dilutes, resolved
    assert readings[2][0] == pytest.approx(0.5) and not readings[2][1]
    assert any(r[1] for r in readings[3:])
    assert got[2] == ()
    assert ("fleet" if emitter_id is None else f"{emitter_id:016x}") \
        in got[1]
    assert set(got[3]) == {(1000.0, emitter_id)}


BAD_RULES = ({"budget_us": 0.0}, {"budget_us": 1.0, "objective": 1.5},
             {"budget_us": 1.0, "objective": 0.0},
             {"budget_us": 1.0, "short_window": 400.0})


@pytest.mark.parametrize("kw", BAD_RULES)
def test_freshness_rule_validation_equals_jax(kw):
    with pytest.raises(ValueError) as got:
        rules.FreshnessSloRule("r", **kw)
    with pytest.raises(ValueError) as want:
        jax_rules.FreshnessSloRule("r", **kw)
    assert str(got.value) == str(want.value)


def test_freshness_rule_binding(clocks):
    rule = rules.FreshnessSloRule("r", budget_us=1.0)
    assert rule.kind == jax_rules.FreshnessSloRule.kind == "freshness"
    assert rule.observe(None) == (None, False)  # unbound: no data
    stub = _Totals()
    rule.bind(stub)
    stub.total, stub.above = 10, 10
    assert rule.observe(None) == (None, False)  # no history yet
    stub.total, stub.above = 20, 20
    assert rule.observe(None) == (pytest.approx(100.0), True)


def test_add_rule_requires_federation_in_the_reference_words():
    port = TorchMetricSystem(interval=1.0, sys_stats=False, num_metrics=16,
                             retention=TIERS, device="cpu")
    ref = TPUMetricSystem(interval=1.0, sys_stats=False, num_metrics=16,
                          retention=TIERS)
    try:
        with pytest.raises(ValueError) as got:
            port.add_rule(rules.FreshnessSloRule("fresh", budget_us=1e6))
        with pytest.raises(ValueError) as want:
            ref.add_rule(jax_rules.FreshnessSloRule("fresh", budget_us=1e6))
        assert "federation" in str(got.value)
        assert str(got.value) == str(want.value).replace(
            "TPUMetricSystem", "TorchMetricSystem")
    finally:
        port.stop()
        ref.stop()


# -- the system wiring ---------------------------------------------------- #


def test_wiring_equals_the_reference_system():
    fed = {"expected_emitters": 3, "starvation_intervals": 2.0,
           "skew_tolerance_s": 0.5}
    port, ref = _systems(**fed)
    try:
        for ms in (port, ref):
            rx = ms.federation
            assert rx.has_publisher
            assert ms.committer.freshness_hook == rx.note_publish
            assert (rx.starvation_s, rx.skew_tolerance_s) == (2.0, 0.5)
            assert rx.expected_emitters == 3
            assert rx.obs_recorder is ms.obs
            assert ms.health._federation is rx
            assert ms.health.federation_starvation_intervals == 2.0
            assert ms.health.federation_skew_tolerance_s == 0.5
            assert ms.federation_config.expected_emitters == 3
            rule = ms.add_rule(
                (rules if ms is port else jax_rules).FreshnessSloRule(
                    "fresh", budget_us=1e6))
            assert rule._receiver is rx
        assert _fed_gauges(port) == _fed_gauges(ref)
        pd, rd = port.debug_dump(), ref.debug_dump()
        assert set(pd) == set(rd)
        assert set(pd["federation"]) == set(rd["federation"])
        assert port.federation_config == FederationConfig(**fed)
    finally:
        port.stop()
        ref.stop()


def test_federation_true_takes_the_default_config():
    port = TorchMetricSystem(interval=2.0, sys_stats=False, num_metrics=16,
                             federation=True, device="cpu")
    try:
        assert port.federation_config == FederationConfig()
        assert port.federation.starvation_s == 3.0 * 2.0
        # no retention: no publisher, frames complete at apply
        assert port.committer is None and not port.federation.has_publisher
        assert port.health is None and "federation" in port.debug_dump()
    finally:
        port.stop()


def test_fanout_commit_publishes_through_the_wheel_hook():
    port = TorchMetricSystem(interval=1.0, sys_stats=False, num_metrics=16,
                             config=MetricConfig(bucket_limit=BL),
                             retention=TIERS, commit="fanout",
                             federation=FederationConfig(), device="cpu")
    try:
        rx = port.federation
        assert port.committer is None and rx.has_publisher
        rx._drain_buffer(bytearray(_frame(wire, encode_frame, 5, 1, 1.0,
                                          [(0, "fan.lat")], [(0, 3, 2)])))
        assert rx.stats()["freshness_pending"] == 1
        port.retention.push(port.collect_raw_metrics())
        assert rx.stats()["freshness_pending"] == 0
        assert rx.stats()["freshness_samples"] == 1
    finally:
        port.stop()


def _frame(w, enc, eid, seq, t_s, names=(), rows=(), health=None):
    """A v2 frame captured at ``t_s`` on a monotonic clock that started
    at 1000 s and a wall clock 4000 s ahead of it."""
    packed = np.array(rows, np.int32).reshape(-1, 3)
    return enc(w.KIND_DELTA2, w.encode_delta2(
        eid, seq, list(names), packed, int((1000.0 + t_s) * 1e9),
        int((5000.0 + t_s) * 1e9), health))


def test_freshness_completes_at_publish_as_the_reference(clocks):
    port, ref = _systems(expected_emitters=1)
    try:
        out = []
        for ms, w, enc, clock in ((port, wire, encode_frame, clocks[0]),
                                  (ref, jwire, jax_encode_frame, clocks[1])):
            rx = ms.federation
            got = {}
            # the anchor frame, then two frames captured 1 s and 1.5 s
            # after it, arriving 2 s after it
            rx._drain_buffer(bytearray(_frame(w, enc, 55, 1, 0.0,
                                              [(0, "fed.sys.lat")],
                                              [(0, 40, 3)])))
            clock.advance(2.0)
            for seq, t in ((2, 1.0), (3, 1.5)):
                rx._drain_buffer(bytearray(_frame(w, enc, 55, seq, t, (),
                                                  [(0, 50 + seq, 2)])))
            got["before"] = dict(rx.stats())
            clock.advance(0.25)
            _commit(ms)
            got["after"] = rx.stats()
            got["values"] = list(rx.freshness_values)
            got["dump"] = ms.debug_dump()["federation"]
            _commit(ms)  # the fed.FreshnessUs samples land
            got["hist"] = {k: v for k, v in
                           ms.device_metrics(reset=False).metrics.items()
                           if k.startswith(("fed.", "fed.sys"))}
            out.append(got)
        got, want = out
        assert got["before"]["freshness_pending"] == 3
        assert got["before"]["freshness_samples"] == 0
        assert got["after"]["freshness_pending"] == 0
        assert got["after"]["freshness_samples"] == 3
        assert got["values"] == want["values"]
        # captured 1 s / 0.5 s before arrival, published 0.25 s later
        assert got["values"][1] == pytest.approx(1.25e6, rel=1e-4)
        assert got["values"][2] == pytest.approx(0.75e6, rel=1e-4)
        for key in ("after", "dump"):
            assert set(got[key]) == set(want[key])
            for k in ("freshness_samples", "freshness_pending",
                      "freshness_dropped", "samples_merged",
                      "frames_received", "emitters"):
                assert got[key][k] == want[key][k], (key, k)
        assert set(got["hist"]) == set(want["hist"])
        for k, v in want["hist"].items():
            if k.endswith("_count"):
                assert got["hist"][k] == v, k
            else:
                assert got["hist"][k] == pytest.approx(v, rel=4e-6), k
        assert got["hist"]["fed.FreshnessUs_count"] == 3.0
        assert got["hist"]["fed.sys.lat_count"] == 7.0
    finally:
        port.stop()
        ref.stop()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_fleetz_404_without_federation_200_with_it(clocks):
    plain = [(MetricSystem(interval=60.0, sys_stats=False),
              PrometheusEndpoint),
             (JaxMetricSystem(interval=60.0, sys_stats=False), JaxEndpoint)]
    docs = []
    for ms, ep_cls in plain:
        ep = ep_cls(ms, port=0, host="127.0.0.1")
        try:
            ep.start()
            docs.append(_get(f"http://127.0.0.1:{ep.port}/fleetz"))
        finally:
            ep.stop()
            ms.stop()
    assert docs[0][0] == docs[1][0] == 404
    assert "no federation tier" in docs[0][1]

    port, ref = _systems(expected_emitters=2)
    docs = []
    try:
        for ms, ep_cls, w, enc in ((port, PrometheusEndpoint, wire,
                                    encode_frame),
                                   (ref, JaxEndpoint, jwire,
                                    jax_encode_frame)):
            rx = ms.federation
            for eid in (7, 8):
                rx._drain_buffer(bytearray(_frame(
                    w, enc, eid, 1, 0.0, [(0, f"fz.{eid}")], [(0, 4, 1)],
                    health={"p99_us": {"fold": 3.0}})))
            ep = ep_cls(ms, port=0, host="127.0.0.1")
            try:
                ep.start()
                docs.append(_get(f"http://127.0.0.1:{ep.port}/fleetz"))
            finally:
                ep.stop()
    finally:
        port.stop()
        ref.stop()
    (status, doc), (jstatus, jdoc) = docs
    assert status == jstatus == 200
    assert doc == jdoc
    assert set(doc["emitters"]) == {f"{7:016x}", f"{8:016x}"}
    assert doc["emitters"][f"{7:016x}"]["stage_p99_us"] == {"fold": 3.0}


def test_watchdog_emitter_starvation_by_moving_its_clock(clocks):
    port, ref = _systems(expected_emitters=2, starvation_intervals=3.0)
    try:
        out = []
        for ms, w, enc, clock in ((port, wire, encode_frame, clocks[0]),
                                  (ref, jwire, jax_encode_frame, clocks[1])):
            rx = ms.federation
            rx.start()  # the listener's start is the starvation origin
            _commit(ms)
            codes = [ms.health.report().reason_codes()]
            clock.advance(3.5)  # past 3 intervals of 1 s: starved
            report = ms.health.report()
            codes.append(report.reason_codes())
            detail = [r["detail"] for r in report.reasons
                      if r["code"] == "emitter_starvation"]
            rx._drain_buffer(bytearray(_frame(w, enc, 9, 1, 0.0,
                                              [(0, "st.lat")], [(0, 2, 1)])))
            codes.append(ms.health.report().reason_codes())
            out.append((codes, detail))
    finally:
        port.stop()
        ref.stop()
    assert out[0] == out[1]
    codes, detail = out[0]
    assert "emitter_starvation" not in codes[0]
    assert "emitter_starvation" in codes[1]
    assert "emitter_starvation" not in codes[2]
    assert "0 emitter(s) seen of 2 expected" in detail[0]


# -- the 4-emitter drill -------------------------------------------------- #


def _drill_names(idx):
    # a fleet-shared name, a name per pair of emitters, one per emitter
    return ["fed.shared.lat", f"fed.group{idx % 2}.lat", f"fed.e{idx}.bytes"]


PHASE_S = 0.5 * EMITTERS + 1.5  # a phase on the receivers' clocks


def _drill_frame(w, enc, idx, phase):
    """Emitter ``idx``'s frame of ``phase``: its names on its first
    frame, ``SAMPLES`` seeded samples folded into (local id, codec
    bucket, count) triples, captured 0.2 s before it arrives (emitter
    ``idx`` sends 0.5 s after emitter ``idx - 1``)."""
    rng = np.random.default_rng([19, idx, phase])
    lids = rng.integers(0, 3, SAMPLES)
    buckets = compress_np(rng.lognormal(3.0 + lids, 1.0, SAMPLES))
    keys, counts = np.unique(np.stack([lids, np.clip(buckets, -BL, BL)], 1),
                             axis=0, return_counts=True)
    rows = np.column_stack([keys, counts]).astype(np.int32)
    names = list(enumerate(_drill_names(idx))) if phase == 0 else []
    health = {"p99_us": {"fold": 10.0 + idx}, "backlog": 0}
    return _frame(w, enc, EMITTER0 + idx, phase + 1,
                  PHASE_S * phase + 0.5 * (idx + 1) - 0.2, names, rows,
                  health)


def _drill(ms, w, enc, clock, trace_path):
    """The phases through ``_drain_buffer``, one interval committed by
    hand after each; returns the readings."""
    rx = ms.federation
    rx.starvation_s = 5.0  # live emitters lag at most one phase
    ms.add_rule((rules if isinstance(ms, TorchMetricSystem)
                 else jax_rules).FreshnessSloRule(
        "fresh", budget_us=2e5, long_window=30.0, short_window=10.0))
    out = {}
    for phase in range(PHASES):
        for idx in range(EMITTERS):
            clock.advance(0.5)
            if idx == SILENT and phase > 0:
                continue
            assert rx._drain_buffer(bytearray(_drill_frame(w, enc, idx,
                                                           phase)))
        clock.advance(1.0)
        _commit(ms)
        out[f"rules_{phase}"] = sorted(ms.rule_engine.active())
        clock.advance(0.5)
    _commit(ms)  # the last publish's fed.FreshnessUs samples land
    _commit(ms)
    out["rules_end"] = sorted(ms.rule_engine.active())
    out["stats"] = rx.stats()
    out["values"] = list(rx.freshness_values)
    out["totals"] = [rx.freshness_totals(b, e)
                     for b in (1e5, 2e5, 1e6, 1e7)
                     for e in (None, *(EMITTER0 + i
                                       for i in range(EMITTERS)))]
    out["report"] = rx.fleet_report()
    names = {n for i in range(EMITTERS) for n in _drill_names(i)}
    names.add("fed.FreshnessUs")
    metrics = ms.device_metrics(reset=False).metrics
    out["metrics"] = {k: v for k, v in metrics.items()
                      if k.rsplit("_", 1)[0] in names
                      or k.rsplit("_", 2)[0] in names}
    res = ms.retention.query("fed.FreshnessUs", 1e9, percentiles=(0.99,))
    out["served"] = res.metrics["fed.FreshnessUs"]
    out["trace"] = dump_perfetto(ms.obs, trace_path,
                                 process_name="aggregator")
    return out


def test_four_emitter_drill_equals_the_reference(clocks, tmp_path):
    port, ref = _systems(expected_emitters=EMITTERS)
    try:
        got = _drill(port, wire, encode_frame, clocks[0],
                     str(tmp_path / "port.json"))
        want = _drill(ref, jwire, jax_encode_frame, clocks[1],
                      str(tmp_path / "jax.json"))
    finally:
        port.stop()
        ref.stop()
    merged = (EMITTERS * SAMPLES
              + (PHASES - 1) * (EMITTERS - 1) * SAMPLES)
    assert got["stats"]["samples_merged"] == merged
    for key in ("values", "totals", "report"):
        assert got[key] == want[key], key
    for key in [k for k in got if k.startswith("rules")]:
        assert got[key] == want[key], key
    assert got["rules_end"] == ["fresh"]
    assert set(got["stats"]) == set(want["stats"])
    for k in ("samples_merged", "frames_received", "freshness_samples",
              "freshness_pending", "freshness_dropped", "emitters"):
        assert got["stats"][k] == want["stats"][k], k
    assert got["stats"]["freshness_pending"] == 0
    assert got["stats"]["freshness_samples"] == len(got["values"]) \
        == EMITTERS + (PHASES - 1) * (EMITTERS - 1)
    # the processed metric set of the drill's names: counts EQUAL, sums
    # rtol 2e-6, percentile values in the same bucket within rtol 4e-6
    # (ROADMAP F1: XLA's float32 exp)
    assert set(got["metrics"]) == set(want["metrics"])
    for key, w in want["metrics"].items():
        g = got["metrics"][key]
        if key.endswith("_count"):
            assert g == w, key
        elif key.endswith(("_sum", "_avg")):
            assert g == pytest.approx(w, rel=2e-6), key
        else:
            assert int(compress_np([g])[0]) == int(compress_np([w])[0]), key
            assert g == pytest.approx(w, rel=4e-6), key
    # the silent emitter is named
    report = got["report"]
    silent = f"{EMITTER0 + SILENT:016x}"
    assert report["flags"]["starved"] == [silent]
    assert report["emitters"][silent]["stalled"]
    assert report["fleet"]["emitters"] == EMITTERS
    # fed.FreshnessUs p99 served through the window query equals the
    # host oracle over the ledger: float64 bucket selection, float32
    # representative
    vals = np.asarray(got["values"], dtype=np.float64)
    served = got["served"]
    assert served["count"] == len(vals)
    buckets, counts = np.unique(np.clip(compress_np(vals), -BL, BL),
                                return_counts=True)
    cdf = np.cumsum(counts)
    sel = int(np.searchsorted(cdf / cdf[-1], 0.99, side="left"))
    oracle = float(bucket_representatives(BL).numpy()[
        int(buckets[min(sel, len(buckets) - 1)]) + BL])
    assert served["p99"] == oracle
    assert served["p99"] == pytest.approx(want["served"]["p99"], rel=4e-6)
    # the ring's fed spans carry the frames' flow ids; merged with an
    # emitter process's trace, a frame's flow crosses the processes
    assert got["trace"] > 0
    doc = json.load(open(tmp_path / "port.json"))
    flows = [e for e in doc["traceEvents"] if e.get("cat") == "fed"]
    applied = {wire.fed_flow_id(EMITTER0 + i, p + 1)
               for i in range(EMITTERS) for p in range(PHASES)}
    assert flows and {e["id"] for e in flows} <= applied
    fid = flows[0]["id"]
    emitter = SpanRecorder(64)
    emitter.record("fed.flush", 1, 2, None, fid)  # before every apply
    dump_perfetto(emitter, str(tmp_path / "em.json"), process_name="em")
    merged_doc = merge_traces([str(tmp_path / "em.json"),
                               str(tmp_path / "port.json")])
    joined = sorted((e for e in merged_doc["traceEvents"]
                     if e.get("cat") == "fed" and e["id"] == fid),
                    key=lambda e: e["ts"])
    assert [e["pid"] for e in joined][:2] == [1, 2]
    assert joined[0]["ph"] == "s" and {e["ph"] for e in joined[1:]} == {"t"}
