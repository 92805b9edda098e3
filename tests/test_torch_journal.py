"""The port's journals (``loghisto_tpu_torch.utils.journal``) and byte
frames (``loghisto_tpu_torch.ops.codec``) against the JAX package's, on
the CPU, at small sizes (bucket_limit 64, 32 rows, tiers (4, 1), (3, 2)).
Inputs are bucket maps and values from a seed.

Tolerances:
  * EQUAL: every journal line and frame (as strings and bytes), every
    replayed interval, the corrupt-record ledger's counts, and after a
    replay the accumulators, rings, slot state and activity vectors;
  * rtol 1e-12: host statistics of replayed intervals against the live
    ones (the same float64 NumPy in both).
"""

import datetime as dt
import functools
import json
import queue
import time

import jax
import numpy as np
import pytest

from loghisto_tpu import MetricSystem as JaxMetricSystem
from loghisto_tpu import TPUMetricSystem
from loghisto_tpu import merge_raw_metric_sets as jax_merge_sets
from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.lifecycle import LifecycleConfig as JaxLifecycleConfig
from loghisto_tpu.metrics import RawMetricSet as JaxRaw
from loghisto_tpu.ops import codec as jcodec
from loghisto_tpu.parallel.aggregator import TPUAggregator
from loghisto_tpu.utils import journal as jjournal
from loghisto_tpu_torch import TorchMetricSystem
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.lifecycle import LifecycleConfig
from loghisto_tpu_torch.metrics import MetricSystem, RawMetricSet, \
    merge_raw_metric_sets
from loghisto_tpu_torch.ops import codec
from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
from loghisto_tpu_torch.utils import journal

BL = 64
M = 32
TIERS = ((4, 1), (3, 2))
T0 = dt.datetime(2026, 1, 1, 12, 30, 15, 250000, tzinfo=dt.timezone.utc)


def _fields(rng, i, names=("rpc.lat", "db.lat"), **extra):
    hists = {}
    for name in names:
        b = rng.integers(-BL, BL + 1, 6).tolist()
        hists[name] = {bb: int(c) for bb, c in
                       zip(b, rng.integers(1, 50, len(b)).tolist())}
    out = dict(time=T0 + dt.timedelta(seconds=i),
               counters={"reqs": int(rng.integers(1, 100))},
               rates={"reqs": int(rng.integers(1, 100))},
               histograms=hists,
               gauges={"sys.Alloc": float(rng.random() * 1e6),
                       "queue.depth": 3.0})
    out.update(extra)
    return out


def _same_interval(got, want):
    for key in ("time", "counters", "rates", "histograms", "gauges",
                "duration", "seq"):
        assert getattr(got, key) == getattr(want, key), key


@pytest.mark.parametrize("extra", [
    {}, {"duration": 1.0}, {"seq": 7}, {"duration": 0.25, "seq": 12},
])
def test_dump_line_is_the_jax_string(extra):
    rng = np.random.default_rng(1)
    fields = _fields(rng, 3, **extra)
    line = journal.dump_line(RawMetricSet(**fields))
    assert line == jjournal.dump_line(JaxRaw(**fields))
    assert ("interval" in json.loads(line)) == ("duration" in extra)
    assert ("seq" in json.loads(line)) == ("seq" in extra)
    _same_interval(journal.parse_line(line),
                   jjournal.parse_line(line))


def test_journals_replay_across_packages(tmp_path):
    """A journal written by the JAX package replays in the port and the
    reverse, interval for interval."""
    rng = np.random.default_rng(2)
    sets = [_fields(rng, i, duration=1.0, seq=i + 1) for i in range(5)]
    jpath, ppath = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    jpath.write_text("".join(jjournal.dump_line(JaxRaw(**f)) + "\n"
                             for f in sets))
    ppath.write_text("".join(journal.dump_line(RawMetricSet(**f)) + "\n"
                             for f in sets))
    assert jpath.read_text() == ppath.read_text()
    got = list(journal.replay(str(jpath)))
    back = list(jjournal.replay(str(ppath)))
    assert len(got) == len(back) == 5
    for g, b, f in zip(got, back, sets):
        assert isinstance(g, RawMetricSet)
        _same_interval(g, b)
        _same_interval(g, RawMetricSet(**f))


def _corrupt_file(tmp_path, name, lines):
    path = tmp_path / name
    path.write_text("".join(lines))
    return str(path)


@pytest.mark.parametrize("case", [
    "torn_tail", "non_object", "corrupt_gauges", "mid_file", "blank_lines",
])
def test_corrupt_journals_replay_as_in_jax(tmp_path, case, caplog):
    """Each damaged journal replays to the same intervals in both
    packages, both ledgers move by the same count, and strict mode raises
    where the JAX replay raises."""
    good = journal.dump_line(RawMetricSet(**_fields(
        np.random.default_rng(3), 0, seq=1)))
    lines = {
        "torn_tail": [good + "\n", '{"v":1,"time":123,"counters":{"x"'],
        "non_object": ["null\n", "42\n", good + "\n"],
        "corrupt_gauges": ['{"v":1,"time":1,"counters":{},"rates":{},'
                           '"histograms":{},"gauges":null}\n', good + "\n"],
        "mid_file": [good + "\n", "garbage not json\n", good + "\n",
                     '{"torn'],
        "blank_lines": ["\n", good + "\n", "   \n", good + "\n"],
    }[case]
    path = _corrupt_file(tmp_path, "j.jsonl", lines)
    for strict in (False, True):
        p0, j0 = journal.corrupt_lines_total(), jjournal.corrupt_lines_total()
        try:
            want = [r.seq for r in jjournal.replay(path, strict=strict)]
        except jjournal.JournalCorruptError:
            want = "corrupt"
        try:
            with caplog.at_level("WARNING", logger="loghisto_tpu_torch"):
                got = [r.seq for r in journal.replay(path, strict=strict)]
        except journal.JournalCorruptError:
            got = "corrupt"
        assert got == want, strict
        assert (journal.corrupt_lines_total() - p0
                == jjournal.corrupt_lines_total() - j0)
    if case == "torn_tail":
        assert any("unreadable" in r.message for r in caplog.records)
    if case == "mid_file":
        assert want == "corrupt"  # strict refuses mid-file corruption


def test_version_mismatch_raises_in_both_modes(tmp_path):
    path = _corrupt_file(tmp_path, "future.jsonl", [
        '{"v":2,"time":1,"counters":{},"rates":{},"histograms":{},'
        '"gauges":{}}\n'])
    for strict in (False, True):
        with pytest.raises(journal.JournalVersionError):
            list(journal.replay(path, strict=strict))
        with pytest.raises(jjournal.JournalVersionError):
            list(jjournal.replay(path, strict=strict))


def _wait_for(path, n, deadline=10.0):
    end = time.time() + deadline
    got = []
    while time.time() < end:
        try:
            got = list(journal.replay(path))
        except FileNotFoundError:
            got = []
        if len(got) >= n:
            return got
        time.sleep(0.05)
    return got


def test_live_journal_on_the_port_metric_system(tmp_path):
    path = str(tmp_path / "live.jsonl")
    ms = MetricSystem(interval=0.05, sys_stats=False)
    j = journal.RawJournal(ms, path)
    ms.counter("c", 7)
    ms.histogram("h", 0.5)
    j.start()  # subscribed before the first tick
    ms.start()
    try:
        got = _wait_for(path, 2)
    finally:
        j.stop()
        ms.stop()
    assert len(got) >= 2
    assert got[0].counters["c"] == 7 and got[0].duration == 0.05
    seqs = [r.seq for r in got]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)


def test_restart_after_a_torn_tail_keeps_new_records(tmp_path):
    good = journal.dump_line(RawMetricSet(**_fields(
        np.random.default_rng(4), 0)))
    path = _corrupt_file(tmp_path, "restart.jsonl",
                         [good + "\n", '{"v":1,"time":123,"coun'])
    ms = MetricSystem(interval=0.05, sys_stats=False)
    j = journal.RawJournal(ms, path)
    ms.counter("after", 5)
    j.start()
    ms.start()
    try:
        got = _wait_for(path, 2)
    finally:
        j.stop()
        ms.stop()
    assert len(got) >= 2
    assert got[1].counters.get("after") == 5


def test_unstarted_journal_never_subscribes(tmp_path):
    ms = MetricSystem(interval=0.02, sys_stats=False)
    journal.RawJournal(ms, str(tmp_path / "late.jsonl"))
    ms.counter("c", 1)
    ms.start()
    time.sleep(0.2)
    ms.stop()
    with ms._subscribers_lock:
        assert not ms._raw_subscribers
    j = journal.RawJournal(ms, str(tmp_path / "no_dir" / "x.jsonl"))
    with pytest.raises(OSError):
        j.start()
    j.stop()  # safe on a journal that never started


class _Mangle:
    """A duck-typed fault injector that tears the second appended line."""

    def __init__(self):
        self.calls = 0

    def mangle(self, site, line):
        assert site == "journal.append"
        self.calls += 1
        return line[: len(line) // 2] if self.calls == 2 else line


def test_mangled_append_recovers_on_replay(tmp_path):
    path = str(tmp_path / "torn_live.jsonl")
    ms = MetricSystem(interval=0.02, sys_stats=False)
    ms.counter("c", 7)
    j = journal.RawJournal(ms, path)
    j.fault_injector = _Mangle()
    q = queue.Queue(64)
    j.start()
    try:
        for _ in range(4):
            ms._tick(q)
        got = _wait_for(path, 2)
        time.sleep(0.2)
    finally:
        j.stop()
    assert j.fault_injector.calls == 4
    # the torn second line has no newline, so the third record lands on
    # its line and is lost with it, as a crash mid-append loses it
    got = list(journal.replay(path))
    assert [r.seq for r in got] == [1, 4]
    assert got[0].counters["c"] == 7


def test_replay_into_merge_raw_equals_jax(tmp_path):
    """The same journal replayed into the port's and the JAX
    ``merge_raw``: equal accumulators and registries, and host statistics
    of the merged intervals equal to the live ones."""
    rng = np.random.default_rng(5)
    sets = [_fields(rng, i, names=[f"m{k}" for k in range(6)], seq=i + 1,
                    duration=1.0) for i in range(4)]
    path = tmp_path / "j.jsonl"
    path.write_text("".join(jjournal.dump_line(JaxRaw(**f)) + "\n"
                            for f in sets))
    jagg = TPUAggregator(num_metrics=8, config=JaxConfig(bucket_limit=BL),
                         storage="dense")
    pagg = TorchAggregator(num_metrics=8, config=MetricConfig(bucket_limit=BL),
                           device="cpu")
    for raw in jjournal.replay(str(path)):
        jagg.merge_raw(raw)
    replayed = list(journal.replay(str(path)))
    for raw in replayed:
        pagg.merge_raw(raw)
    assert pagg.registry.names() == jagg.registry.names()
    np.testing.assert_array_equal(pagg._acc.numpy(), np.asarray(jagg._acc))
    ms, jms = MetricSystem(sys_stats=False), JaxMetricSystem(sys_stats=False)
    got = ms.process_metrics(
        functools.reduce(merge_raw_metric_sets, replayed)).metrics
    want = jms.process_metrics(functools.reduce(
        jax_merge_sets, [JaxRaw(**f) for f in sets])).metrics
    assert set(got) == set(want)
    for key, v in want.items():
        assert got[key] == pytest.approx(v, rel=1e-12), key


def _systems():
    kw = dict(interval=1.0, sys_stats=False, num_metrics=M, retention=TIERS,
              storage="dense")
    lc = dict(ttl_intervals=2, check_every=1, auto_compact_fragmentation=0.0)
    jms = TPUMetricSystem(config=JaxConfig(bucket_limit=BL),
                          lifecycle=JaxLifecycleConfig(**lc), **kw)
    pms = TorchMetricSystem(config=MetricConfig(bucket_limit=BL),
                            lifecycle=LifecycleConfig(**lc), device="cpu",
                            **kw)
    for attr in ("_fused", "_fused_snap"):  # ROADMAP F3
        step = getattr(jms.committer, attr)
        setattr(jms.committer, attr,
                lambda *a, _step=step: jax.block_until_ready(_step(*a)))
    return jms, pms


def test_backfill_of_a_journal_equals_the_jax_system(tmp_path):
    """A port-written journal of churning intervals, replayed through
    ``backfill_retention`` of the port's system and of the JAX system:
    rings (every tier and slot), slot state, accumulator and activity
    vector equal; the journaled duration and seq are what each commit
    took."""
    rng = np.random.default_rng(6)
    path = tmp_path / "j.jsonl"
    lines = []
    for i in range(9):
        names = ["svc.a", "svc.b"] + [f"api.u{i}.{k}" for k in range(3)]
        lines.append(journal.dump_line(RawMetricSet(**_fields(
            rng, i, names=names, duration=0.5 + 0.25 * (i % 3),
            seq=100 + i))) + "\n")
    path.write_text("".join(lines))
    jms, pms = _systems()
    try:
        assert pms.commit_path == jms.commit_path == "fused"
        durations = []
        commit = pms.committer.commit

        def spy(raw, duration=None):
            durations.append((raw.duration, raw.seq))
            return commit(raw, duration)
        pms.committer.commit = spy
        assert pms.backfill_retention(journal.replay(str(path))) == 9
        assert jms.backfill_retention(jjournal.replay(str(path))) == 9
        assert durations == [(0.5 + 0.25 * (i % 3), 100 + i)
                             for i in range(9)]
        assert pms.lifecycle.evicted_series == jms.lifecycle.evicted_series > 0
        pagg, jagg = pms.aggregator, jms.aggregator
        assert pagg.registry.names() == jagg.registry.names()
        np.testing.assert_array_equal(pagg._acc.numpy(),
                                      np.asarray(jagg._acc))
        np.testing.assert_array_equal(pms.lifecycle._la.numpy(),
                                      np.asarray(jms.lifecycle._la))
        for pt, jt in zip(pms.retention._tiers, jms.retention._tiers):
            np.testing.assert_array_equal(pt.ring.numpy(),
                                          np.asarray(jt.ring))
            np.testing.assert_array_equal(pt.durations, jt.durations)
            assert (pt.slot, pt.in_slot) == (jt.slot, jt.in_slot)
    finally:
        pms.stop()
        jms.stop()


# -- the byte frames and the frame journal ----------------------------------


def _payloads(rng, n=6):
    return [(int(k), rng.bytes(int(s))) for k, s in
            zip(rng.integers(0, 256, n), rng.integers(0, 300, n))] + [
        (0, b""), (255, b"\x00" * 17)]


def test_frames_are_the_jax_bytes():
    rng = np.random.default_rng(7)
    items = _payloads(rng)
    buf = b"".join(codec.encode_frame(k, p) for k, p in items)
    assert buf == b"".join(jcodec.encode_frame(k, p) for k, p in items)
    assert list(codec.iter_frames(buf)) == list(jcodec.iter_frames(buf))
    assert list(codec.iter_frames(buf)) == items
    assert codec.FRAME_HEADER.size == jcodec.FRAME_HEADER.size == 12
    assert (codec.FRAME_MAGIC, codec.FRAME_VERSION, codec.MAX_FRAME_PAYLOAD) \
        == (jcodec.FRAME_MAGIC, jcodec.FRAME_VERSION, jcodec.MAX_FRAME_PAYLOAD)
    for bad in (-1, 256):
        with pytest.raises(ValueError, match="u8"):
            codec.encode_frame(bad, b"")


@pytest.mark.parametrize("damage", ["magic", "version", "crc", "length",
                                    "header_cut", "payload_cut"])
def test_damaged_frames_fail_as_in_jax(damage):
    frame = bytearray(codec.encode_frame(9, b"payload bytes"))
    if damage == "magic":
        frame[0] ^= 1
    elif damage == "version":
        frame[2] = 2
    elif damage == "crc":
        frame[-1] ^= 1
    elif damage == "length":
        frame[4:8] = (1 << 29).to_bytes(4, "little")
    elif damage == "header_cut":
        frame = frame[:7]
    else:
        frame = frame[:-3]
    buf = bytes(frame)
    with pytest.raises(jcodec.FrameError) as want:
        jcodec.decode_frame(buf)
    with pytest.raises(codec.FrameError) as got:
        codec.decode_frame(buf)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, codec.FrameTruncated) == isinstance(
        want.value, jcodec.FrameTruncated)


def test_frame_journal_replays_across_packages(tmp_path):
    rng = np.random.default_rng(8)
    items = _payloads(rng)
    jpath, ppath = str(tmp_path / "j.bin"), str(tmp_path / "p.bin")
    jj, pj = jjournal.FrameJournal(jpath), journal.FrameJournal(ppath)
    for k, p in items:
        jj.append(k, p)
        pj.append(k, p)
    jj.close()
    pj.close()
    assert pj.frames_appended == len(items)
    assert open(jpath, "rb").read() == open(ppath, "rb").read()
    assert list(journal.FrameJournal.replay(jpath)) == items
    assert list(jjournal.FrameJournal.replay(ppath)) == items


@pytest.mark.parametrize("damage", ["torn", "corrupt"])
def test_frame_journal_torn_and_corrupt_replay(tmp_path, damage):
    rng = np.random.default_rng(9)
    items = _payloads(rng)
    buf = bytearray(b"".join(codec.encode_frame(k, p) for k, p in items))
    cut = len(codec.encode_frame(*items[0])) + len(
        codec.encode_frame(*items[1]))
    if damage == "torn":
        buf = buf[:-5]
        keep = len(items) - 1
    else:
        buf[cut + 13] ^= 0xFF  # the third frame's payload
        keep = 2
    path = tmp_path / "f.bin"
    path.write_bytes(bytes(buf))
    for strict in (False, True):
        p0, j0 = journal.corrupt_lines_total(), jjournal.corrupt_lines_total()
        try:
            want = list(jjournal.FrameJournal.replay(str(path), strict))
        except jjournal.JournalCorruptError:
            want = "corrupt"
        try:
            got = list(journal.FrameJournal.replay(str(path), strict))
        except journal.JournalCorruptError:
            got = "corrupt"
        assert got == want
        assert (journal.corrupt_lines_total() - p0
                == jjournal.corrupt_lines_total() - j0 == 1)
        if damage == "torn" or not strict:
            assert got == items[:keep]
        else:
            assert got == "corrupt"


def test_journal_corrupt_lines_gauge_registered():
    """Port copy of the JAX test that waited for resilience: the
    process-wide corrupt-line ledger rides register_resilience_gauges as
    ``journal.CorruptLines``, in both packages."""
    from loghisto_tpu.resilience import register_resilience_gauges as jreg
    from loghisto_tpu_torch.resilience import register_resilience_gauges

    for ms, reg, ledger in (
            (MetricSystem(interval=1e-6, sys_stats=False),
             register_resilience_gauges, journal.corrupt_lines_total),
            (JaxMetricSystem(interval=1e-6, sys_stats=False), jreg,
             jjournal.corrupt_lines_total)):
        reg(ms)
        raw = ms.collect_raw_metrics()
        assert "journal.CorruptLines" in raw.gauges
        assert raw.gauges["journal.CorruptLines"] >= 0.0
        assert raw.gauges["journal.CorruptLines"] <= ledger()
