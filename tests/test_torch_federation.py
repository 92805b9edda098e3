"""The federation transport of the port (``loghisto_tpu_torch.federation``)
against the JAX package's (``loghisto_tpu.federation``), on the CPU.

  * wire: the two packages encode the same v1 and v2 inputs to EQUAL
    bytes and decode each other's frames; every truncation of a frame
    raises ``FrameTruncated``, every single-bit flip fails closed, every
    cut of a payload raises ``WireError``;
  * receiver: one seeded frame sequence (duplicates, a gap filled late,
    a dictionary frame after its rows, unknown ids, a corrupt frame, an
    unknown kind, v1 frames, rows parked at ``stop()``) goes to a JAX
    receiver over a ``TPUAggregator`` and to the port's over a
    ``TorchAggregator(device="cpu")``, dense and paged.  Accumulators
    (dense) and pools, page tables and codecs (paged) are EQUAL;
    ``collect()``'s counts EQUAL, percentile values rtol 4e-6 (ROADMAP
    F1: JAX's representatives come from XLA's float32 ``exp``), sums
    rtol 2e-6; the receivers' counters EQUAL;
  * journal: a frame journal written by either package replays into the
    other to an equal state; a replay into a live receiver is all
    duplicates;
  * emitter: the same records through both emitters give EQUAL frames,
    with ``emitter_id`` fixed and both modules' clocks replaced by one
    fake clock each; one TCP run port to port against a host oracle;
    the three fault sites (``fed.send``, ``fed.decode``, ``fed.accept``
    under the port's ``ThreadSupervisor``);
  * freshness, lag and skew of a standalone receiver, from injected
    stamps and a fake receiver clock: ``stats()``, ``fleet_report()`` and
    the ``register_gauges`` family EQUAL to the JAX receiver's.

No test asserts a time or sleeps for one: frames that are not about the
socket go through the receiver's ``_drain_buffer`` (one buffer per
connection), socket tests wait on counters with 30 s deadlines on port
0, and every receiver, emitter and aggregator closes in ``finally``.
"""

import dataclasses
import queue
import socket
import time
import types

import numpy as np
import pytest

from loghisto_tpu.config import MetricConfig as JaxConfig
from loghisto_tpu.federation import emitter as jax_emitter_mod
from loghisto_tpu.federation import receiver as jax_receiver_mod
from loghisto_tpu.federation import wire as jwire
from loghisto_tpu.metrics import MetricSystem as JaxMetricSystem
from loghisto_tpu.ops.codec import encode_frame as jax_encode_frame
from loghisto_tpu.paging import PagedStoreConfig as JaxPagedConfig
from loghisto_tpu.parallel.aggregator import TPUAggregator
import loghisto_tpu.federation as jax_fed

import loghisto_tpu_torch.federation as fed
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.federation import emitter as emitter_mod
from loghisto_tpu_torch.federation import receiver as receiver_mod
from loghisto_tpu_torch.federation import wire
from loghisto_tpu_torch.metrics import MetricSystem
from loghisto_tpu_torch.ops.codec import (
    FrameError,
    FrameTruncated,
    compress_np,
    decode_frame,
    encode_frame,
)
from loghisto_tpu_torch.paging import PagedStoreConfig
from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
from loghisto_tpu_torch.resilience import FaultInjector, ThreadSupervisor

BL = 128  # the narrowest bucket axis paged storage admits (B = 257)
M = 48
POOL = 512
DEADLINE_S = 30.0


def _wait(cond, what):
    deadline = time.monotonic() + DEADLINE_S
    while not cond():
        if time.monotonic() >= deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _send_raw(port, data):
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(data)


class FakeTime:
    """A stand-in for a module's ``time``: every read advances one
    microsecond, ``advance`` jumps.  Two instances driven through the
    same code return the same instants, so the two packages' stamps,
    latencies and lags are equal."""

    def __init__(self):
        self.ns = 10**12
        self.wall_offset = 1_767_225_600 * 10**9 - self.ns

    def _read(self) -> int:
        self.ns += 1000
        return self.ns

    def monotonic_ns(self):
        return self._read()

    def monotonic(self):
        return self._read() / 1e9

    def perf_counter_ns(self):
        return self._read()

    def perf_counter(self):
        return self._read() / 1e9

    def time_ns(self):
        return self._read() + self.wall_offset

    def time(self):
        return self.time_ns() / 1e9

    def sleep(self, s):
        self.ns += int(s * 1e9)

    def advance(self, s):
        self.ns += int(round(s * 1e9))


@pytest.fixture
def clocks(monkeypatch):
    """One fake clock per package, for the emitter and receiver modules
    of each: returns (port clock, JAX clock)."""
    port_t, jax_t = FakeTime(), FakeTime()
    for mod, clock in ((emitter_mod, port_t), (receiver_mod, port_t),
                       (jax_emitter_mod, jax_t), (jax_receiver_mod, jax_t)):
        monkeypatch.setattr(mod, "time", clock)
    return port_t, jax_t


class StubAgg:
    """Interning and merge recording without a device (the JAX tests'
    stub): rows are assigned in first-seen order."""

    def __init__(self):
        self.rows = {}
        self.merged = []

    def _id_for(self, name, samples=1):
        return self.rows.setdefault(name, len(self.rows))

    def merge_packed(self, packed, wait=False):
        self.merged.append(np.array(packed))

    def merged_samples(self):
        return sum(int(m[:, 2].sum()) for m in self.merged)


# -- wire ---------------------------------------------------------------- #

HEALTH = {"p99_us": {"fold": 12.5, "encode": 3.0}, "backlog": 2, "fail": 0,
          "restarts": 1, "up_s": 3.5, "frames": 9, "samples": 400}

WIRE_CASES = {
    "v1": (1, [(0, "m.a"), (1, "m.b;route=/x")],
           [[0, 10, 3], [1, -4, 2], [0, BL, 7]], None),
    "v1_heartbeat": (1, [], [], None),
    "v2": (2, [(0, "m.a"), (7, "héllo.λ")],
           [[0, 10, 3], [7, -4, (1 << 30) - 1]], HEALTH),
    "v2_no_health": (2, [(3, "m.c")], [[3, 0, 1]], None),
    "v2_heartbeat": (2, [], [], None),
}


def _payloads(case, w):
    version, names, rows, health = WIRE_CASES[case]
    packed = np.array(rows, dtype=np.int32).reshape(-1, 3)
    if version == 1:
        return w.KIND_DELTA, w.encode_delta(0xDEADBEEF, 17, names, packed)
    return w.KIND_DELTA2, w.encode_delta2(
        0xDEADBEEF, 17, names, packed, 123_456_789, 987_654_321, health)


def _same_delta(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "packed":
            np.testing.assert_array_equal(g, w)
            assert g.dtype == np.int32 and g.flags.writeable
        else:
            assert g == w, f.name


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_wire_bytes_equal_jax_and_decode_both_ways(case):
    kind, payload = _payloads(case, wire)
    jkind, jpayload = _payloads(case, jwire)
    assert (kind, payload) == (jkind, jpayload)
    assert encode_frame(kind, payload) == jax_encode_frame(jkind, jpayload)
    got = wire.decode_payload(kind, jpayload)
    want = jwire.decode_payload(jkind, payload)
    _same_delta(got, want)
    assert got.samples == want.samples
    assert (got.mono_ns is None) == (kind == wire.KIND_DELTA)
    if case == "v2":
        assert got.health == HEALTH and got.names[1] == (7, "héllo.λ")


@pytest.mark.parametrize("case", ("v1", "v2"))
def test_every_frame_truncation_raises_truncated(case):
    frame = encode_frame(*_payloads(case, wire))
    for cut in range(len(frame)):
        with pytest.raises(FrameTruncated):
            decode_frame(frame[:cut])


@pytest.mark.parametrize("case", ("v1", "v2"))
def test_every_bit_flip_fails_closed(case):
    """No single-bit flip anywhere in a frame decodes to a payload:
    header flips fail structurally (or truncate, for a length flip),
    payload flips fail the CRC."""
    frame = encode_frame(*_payloads(case, wire))
    for i in range(len(frame)):
        for bit in range(8):
            bad = bytearray(frame)
            bad[i] ^= 1 << bit
            with pytest.raises((FrameError, FrameTruncated)):
                decode_frame(bytes(bad))


@pytest.mark.parametrize("case", ("v1", "v2"))
def test_every_payload_cut_raises_wire_error(case):
    kind, payload = _payloads(case, wire)
    for cut in range(len(payload)):
        with pytest.raises(wire.WireError):
            wire.decode_payload(kind, payload[:cut])
    with pytest.raises(wire.WireError):
        wire.decode_payload(kind, payload + b"\x00")  # trailing garbage
    with pytest.raises(wire.WireError):
        wire.decode_payload(99, payload)  # unknown kind fails closed


def test_wire_rejects_what_the_reference_rejects():
    packed = np.zeros((1, 3), np.int32)
    for w in (wire, jwire):
        with pytest.raises(ValueError, match=r"\[n, 3\]"):
            w.encode_delta(1, 1, [], packed[:, :2])
        with pytest.raises(ValueError, match="cap 4096"):
            w.encode_delta(1, 1, [(0, "x" * 4097)], packed)
        with pytest.raises(ValueError, match="cap 65536"):
            w.encode_delta2(1, 1, [], packed, 0, 0, {"x": "y" * 70000})
        bad_json = w.encode_delta2(1, 1, [], packed, 0, 0, {"a": 1})
        bad_json = bad_json.replace(b'{"a":1}', b'["a",1]')
        with pytest.raises(w.WireError, match="json object"):
            w.decode_delta2(bad_json)
        bad_utf8 = w.encode_delta(1, 1, [(0, "ab")], packed)
        bad_utf8 = bad_utf8.replace(b"ab", b"\xff\xfe")
        with pytest.raises(w.WireError, match="utf-8"):
            w.decode_delta(bad_utf8)


def test_flow_id_equals_jax_and_survives_json():
    for eid, seq in ((2**64 - 1, 2**32 - 1), (0, 1), (123456, 999),
                     (7, 2**40 + 3)):
        fid = wire.fed_flow_id(eid, seq)
        assert fid == jwire.fed_flow_id(eid, seq)
        assert 0 <= fid < 2**53


# -- the receiver against the JAX receiver ------------------------------- #


def _rows(rng, lids, n):
    return np.stack([
        rng.choice(np.asarray(lids), n),
        rng.integers(-BL // 4, BL + 1, n),
        rng.integers(1, 60, n),
    ], axis=1).astype(np.int32)


def _sequence(w, encode, seed=5):
    """The seeded delivery order: a list of byte buffers, one per
    connection, built with the given package's wire and frame codec."""
    rng = np.random.default_rng(seed)

    def v2(eid, seq, names, packed, mono_s=1000.0, wall_s=5000.0):
        return encode(w.KIND_DELTA2, w.encode_delta2(
            eid, seq, names, packed, int(mono_s * 1e9) + seq,
            int(wall_s * 1e9) + seq))

    def v1(eid, seq, names, packed):
        return encode(w.KIND_DELTA, w.encode_delta(eid, seq, names, packed))

    a_names = [(i, f"fed.a{i}.lat") for i in range(8)]
    a = {1: v2(0xA, 1, a_names[:5], _rows(rng, range(5), 40))}
    a[2] = v2(0xA, 2, [], _rows(rng, range(5), 30))
    a[3] = v2(0xA, 3, a_names[5:], _rows(rng, range(8), 40))
    for s in (4, 5, 6):
        a[s] = v2(0xA, s, [], _rows(rng, range(8), 50))
    b1 = v2(0xB, 1, [(0, "fed.b0"), (1, "fed.b1")], _rows(rng, [0], 5))
    b2 = v2(0xB, 2, [], _rows(rng, [0, 1], 20))  # its names are in b1
    # local id 9 never gets a name and no gap can explain it: shed
    c1 = v2(0xC, 1, [(0, "fed.c0")], _rows(rng, [0, 9], 12))
    d1 = v1(0xD, 1, [(0, "fed.d0")], _rows(rng, [0], 9))
    d2 = v1(0xD, 2, [(1, "fed.d1")], _rows(rng, [0, 1], 9))
    e1 = v2(0xE, 1, [(0, "fed.e0")], _rows(rng, [0], 8))
    corrupt = bytearray(e1)
    corrupt[len(corrupt) // 2] ^= 0x10
    # f3's local id 1 is named in f2, which never arrives: parked, and
    # shed at stop()
    f1 = v2(0xF, 1, [(0, "fed.f0")], _rows(rng, [0], 6))
    f3 = v2(0xF, 3, [], _rows(rng, [0, 1], 10))
    unknown_kind = encode(7, b"not a delta")
    return [a[1], a[2], a[4], a[2], b2, a[3], c1, bytes(corrupt), b1,
            d1 + d2, a[6], e1, f1, f3, unknown_kind, a[5], e1]


def _jax_agg(storage):
    kw = {}
    if storage == "paged":
        kw["paged_config"] = JaxPagedConfig(pool_pages=POOL)
    return TPUAggregator(num_metrics=M, config=JaxConfig(bucket_limit=BL),
                         storage=storage, **kw)


def _port_agg(storage, device="cpu"):
    kw = {}
    if storage == "paged":
        kw["paged_config"] = PagedStoreConfig(pool_pages=POOL)
    return TorchAggregator(num_metrics=M, config=MetricConfig(bucket_limit=BL),
                           storage=storage, device=device, **kw)


def _feed(rx, buffers):
    """One ``_drain_buffer`` per connection; returns which buffers the
    receiver refused (a corrupt stream drops its connection)."""
    return [rx._drain_buffer(bytearray(b)) for b in buffers]


COUNTERS = ("frames_received", "duplicate_frames", "seq_gaps",
            "samples_merged", "samples_shed", "samples_parked",
            "decode_errors", "frames_v1", "frames_replayed")


def _assert_same_counters(port_rx, jax_rx):
    got, want = port_rx.stats(), jax_rx.stats()
    for key in COUNTERS:
        assert got[key] == want[key], key
    assert got["emitters"] == want["emitters"]


def _assert_same_metrics(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if key.endswith(("_count", "_agg_count")):
            assert g == w, key
        elif key.endswith(("_sum", "_avg")):
            assert g == pytest.approx(w, rel=2e-6, abs=1e-6), key
        else:  # a percentile: same bucket, value within XLA's exp error
            assert int(compress_np([g])[0]) == int(compress_np([w])[0]), key
            assert g == pytest.approx(w, rel=4e-6, abs=0), key


def _cells(store):
    rows, idx, counts = store.decode_cells()
    order = np.lexsort((idx, rows))
    return rows[order], idx[order], counts[order]


def _assert_same_state(port_agg, jax_agg):
    """Drain both transfer queues, then hold the storage EQUAL."""
    assert port_agg.wait_transfers(DEADLINE_S)
    assert jax_agg.wait_transfers(DEADLINE_S)
    port_agg.flush(force=True)
    jax_agg.flush(force=True)
    assert port_agg.registry.names() == jax_agg.registry.names()
    if port_agg.paged is None:
        acc = port_agg._acc.cpu().numpy()
        np.testing.assert_array_equal(acc, np.asarray(jax_agg._acc))
        np.testing.assert_array_equal(np.cumsum(acc, axis=1, dtype=np.int64),
                                      np.cumsum(np.asarray(jax_agg._acc),
                                                axis=1, dtype=np.int64))
    else:
        pst, jst = port_agg.paged, jax_agg.paged
        np.testing.assert_array_equal(pst.page_table, jst.page_table)
        np.testing.assert_array_equal(pst.row_codec, jst.row_codec)
        np.testing.assert_array_equal(pst._pool.cpu().numpy(),
                                      np.asarray(jst._pool))
        for g, w in zip(_cells(pst), _cells(jst)):
            np.testing.assert_array_equal(g, w)


def _run_pair(storage, journal_dir=None):
    """The sequence through a JAX receiver and the port's; returns
    ((port_rx, port_agg), (jax_rx, jax_agg)), receivers stopped."""
    jagg, pagg = _jax_agg(storage), _port_agg(storage)
    sides = []
    for rx_cls, agg, w, enc, tag in (
            (jax_fed.FederationReceiver, jagg, jwire, jax_encode_frame, "jax"),
            (fed.FederationReceiver, pagg, wire, encode_frame, "port")):
        path = None if journal_dir is None else str(journal_dir / f"{tag}.j")
        rx = rx_cls(agg, journal_path=path)
        if path is not None:
            rx.start()  # opens the journal; the socket stays unused
        try:
            accepted = _feed(rx, _sequence(w, enc))
        finally:
            rx.stop()
        sides.append((rx, agg, accepted))
    (jrx, jagg, jacc), (prx, pagg, pacc) = sides
    assert pacc == jacc
    return (prx, pagg), (jrx, jagg)


@pytest.mark.parametrize("storage", ("dense", "paged"))
def test_receiver_over_torch_aggregator_equals_jax(clocks, storage):
    (prx, pagg), (jrx, jagg) = _run_pair(storage)
    try:
        _assert_same_counters(prx, jrx)
        st = prx.stats()
        # the script's shape: one dup, gaps a5 and f2 left at the end
        # but a5 came late, a dict frame after its rows, c1's id 9 shed,
        # f3's id 1 parked then shed at stop(), one corrupt frame and one
        # unknown kind, two v1 frames in one buffer, e1 re-delivered
        assert st["duplicate_frames"] == 2
        assert st["seq_gaps"] == 1
        assert st["decode_errors"] == 2
        assert st["frames_v1"] == 2
        assert st["samples_parked"] == 0 and st["samples_shed"] > 0
        assert st["emitters"][f"{0xA:016x}"]["gaps"] == 0
        assert st["emitters"][f"{0xF:016x}"]["gaps"] == 1
        _assert_same_state(pagg, jagg)
        _assert_same_metrics(pagg.collect().metrics, jagg.collect().metrics)
    finally:
        pagg.close()
        jagg.close()


def test_merges_reach_the_aggregator_once_per_frame(clocks):
    """Every applied frame hands its rows to ``merge_packed`` once, in
    the aggregator's row space; the merged total is ``samples_merged``."""
    agg = StubAgg()
    rx = fed.FederationReceiver(agg)
    try:
        _feed(rx, _sequence(wire, encode_frame))
    finally:
        rx.stop()
    assert agg.merged_samples() == rx.samples_merged
    for packed in agg.merged:
        assert packed.dtype == np.int32 and packed.shape[1] == 3
        assert (packed[:, 0] >= 0).all()
        assert (packed[:, 0] < len(agg.rows)).all()


@pytest.mark.parametrize("direction", ("jax_to_port", "port_to_jax"))
def test_journal_replays_across_packages(clocks, tmp_path, direction):
    storage = "dense"
    (prx, pagg), (jrx, jagg) = _run_pair(storage, journal_dir=tmp_path)
    fresh_p, fresh_j = _port_agg(storage), _jax_agg(storage)
    try:
        if direction == "jax_to_port":
            src_rx, src_agg, path = jrx, jagg, tmp_path / "jax.j"
            dst_rx = fed.FederationReceiver(fresh_p)
            dst_agg, other = fresh_p, jagg
        else:
            src_rx, src_agg, path = prx, pagg, tmp_path / "port.j"
            dst_rx = jax_fed.FederationReceiver(fresh_j)
            dst_agg, other = fresh_j, pagg
        # every frame that passed its decode was journaled, dups too
        n = dst_rx.replay_journal(str(path))
        dst_rx.stop()
        assert n == dst_rx.frames_replayed > 0
        for key in ("frames_received", "duplicate_frames", "seq_gaps",
                    "samples_merged", "samples_shed", "frames_v1"):
            assert getattr(dst_rx, key) == getattr(src_rx, key), key
        if direction == "jax_to_port":
            _assert_same_state(dst_agg, other)
        else:
            _assert_same_state(src_agg, dst_agg)
    finally:
        for agg in (pagg, jagg, fresh_p, fresh_j):
            agg.close()


def test_journal_replay_into_a_live_receiver_is_all_duplicates(clocks,
                                                               tmp_path):
    agg = _port_agg("dense")
    rx = fed.FederationReceiver(agg, journal_path=str(tmp_path / "f.j"))
    rx.start()
    try:
        _feed(rx, _sequence(wire, encode_frame))
        agg.wait_transfers(DEADLINE_S)
        before = agg._acc.clone()
        merged, dups = rx.samples_merged, rx.duplicate_frames
        n = rx.replay_journal()
        assert n == rx._journal.frames_appended
        assert rx.duplicate_frames == dups + n
        assert rx.samples_merged == merged
        assert agg.wait_transfers(DEADLINE_S)
        assert bool((agg._acc == before).all())
    finally:
        rx.stop()
        agg.close()


def test_restart_replays_the_journal_on_start(clocks, tmp_path):
    path = str(tmp_path / "f.j")
    agg1, agg2 = _port_agg("dense"), _port_agg("dense")
    try:
        rx1 = fed.FederationReceiver(agg1, journal_path=path)
        rx1.start()
        try:
            _feed(rx1, _sequence(wire, encode_frame)[:6])
        finally:
            rx1.stop()
        rx2 = fed.FederationReceiver(agg2, journal_path=path,
                                     replay_on_start=True)
        rx2.start()
        try:
            assert rx2.frames_replayed == 6
            assert rx2.samples_merged == rx1.samples_merged
            # the rebuilt seq state deduplicates a live re-delivery
            _feed(rx2, _sequence(wire, encode_frame)[1:2])
            assert rx2.duplicate_frames == rx1.duplicate_frames + 1
        finally:
            rx2.stop()
        assert agg1.wait_transfers(DEADLINE_S)
        assert agg2.wait_transfers(DEADLINE_S)
        assert bool((agg1._acc == agg2._acc).all())
    finally:
        agg1.close()
        agg2.close()


# -- the emitter against the JAX emitter ---------------------------------- #


def _emit_script(e, clock, rng):
    """Records through every surface, with flushes between."""
    e.record("svc.lat", 1.5)
    e.record("svc.lat", 0.25, labels={"route": "/b", "code": "200"})
    e.record("svc.lat", 0.5, labels={"code": "200", "route": "/b"})
    v = rng.lognormal(-1.0, 1.5, 5000).astype(np.float32)
    v[:4] = [0.0, -2.0, np.nan, 1e30]
    e.record_batch(np.full(len(v), e.local_id("svc.size"), np.int32), v)
    e.flush()
    clock.advance(2.0)
    e.flush()  # an empty heartbeat, with a health summary
    e.stage_raw(types.SimpleNamespace(histograms={
        "svc.lat": {3: 2, 900: 1, -7: 4}, "app.new": {-5: 4}, "app.none": {}}))
    ids = rng.integers(0, 2, 300).astype(np.int32)
    e.record_batch(ids, rng.uniform(0.0, 3.0, 300).astype(np.float32))
    e.flush()
    assert e.flush(heartbeat=False) == 0  # nothing staged, no frame
    return list(e._sender._backlog)


@pytest.mark.parametrize("version", (1, 2))
def test_emitter_frames_equal_jax(clocks, version):
    frames = []
    for cls, cfg, clock in (
            (fed.FederationEmitter, MetricConfig(bucket_limit=BL), clocks[0]),
            (jax_fed.FederationEmitter, JaxConfig(bucket_limit=BL),
             clocks[1])):
        e = cls(("127.0.0.1", 9), config=cfg, emitter_id=0x5EED,
                wire_version=version)
        frames.append(_emit_script(e, clock, np.random.default_rng(3)))
        assert e.frames_shipped == 3
        assert e.samples_shipped == e.samples_recorded == 5314
    assert len(frames[0]) == 3
    assert frames[0] == frames[1]
    kinds = set()
    for frame in frames[0]:
        kind, payload, _ = decode_frame(frame)
        kinds.add(kind)
        _same_delta(wire.decode_payload(kind, payload),
                    jwire.decode_payload(kind, payload))
    assert kinds == {version}
    if version == 2:
        health = [wire.decode_payload(2, decode_frame(f)[1]).health
                  for f in frames[0]]
        assert health[0] is not None and health[1] is not None
        assert health[2] is None  # within health_interval_s of the last


def test_attach_ships_a_host_systems_intervals(clocks):
    """``attach`` re-ships each interval of the host system's raw
    broadcast as cells; the frame equals the JAX emitter's ``stage_raw``
    of the same set."""
    ms = MetricSystem(interval=1.0, sys_stats=False)
    raws = []
    collect = ms.collect_raw_metrics
    ms.collect_raw_metrics = lambda: raws.append(collect()) or raws[-1]
    e = fed.FederationEmitter(("127.0.0.1", 9),
                              config=MetricConfig(bucket_limit=BL),
                              emitter_id=0xA77)
    je = jax_fed.FederationEmitter(("127.0.0.1", 9),
                                   config=JaxConfig(bucket_limit=BL),
                                   emitter_id=0xA77)
    try:
        e.attach(ms)
        for v in (0.5, 1.0, 1.0, 300.0):
            ms.histogram("host.lat", v)
        ms.histogram("host.err", -1.0)
        ms._tick(queue.Queue())  # applies the subscription, broadcasts
        _wait(lambda: e.samples_recorded == 5, "the attached interval")
        je.stage_raw(raws[0])
        for em in (e, je):
            em.flush()
        assert list(e._sender._backlog) == list(je._sender._backlog)
        delta = wire.decode_payload(*decode_frame(e._sender._backlog[0])[:2])
        assert sorted(n for _, n in delta.names) == ["host.err", "host.lat"]
        assert delta.samples == 5 and delta.packed[:, 1].max() == BL
    finally:
        e.close(drain_timeout=0.0)
        ms.stop()


def test_emitter_over_tcp_port_to_port():
    agg = _port_agg("dense")
    rx = fed.FederationReceiver(agg)
    rx.start()
    e = fed.FederationEmitter(("127.0.0.1", rx.port), interval=0.2,
                              config=MetricConfig(bucket_limit=BL),
                              emitter_id=42)
    try:
        e.start()
        rng = np.random.default_rng(11)
        values = {"fed.lat": rng.lognormal(-1, 1, 3000),
                  "fed.size": rng.uniform(0, 2, 2000)}
        for name, v in values.items():
            e.record_batch(np.full(len(v), e.local_id(name), np.int32),
                           v.astype(np.float32))
        e.record("fed.lat", 1.0)
        e.flush()
        assert e.drain(DEADLINE_S)
        _wait(lambda: rx.samples_merged == 5001, "the merge")
        assert e.bytes_sent > 0 and rx.bytes_received > 0
        assert rx.decode_errors == 0 and rx.samples_shed == 0
        assert agg.wait_transfers(DEADLINE_S)
        agg.flush(force=True)
        values["fed.lat"] = np.append(values["fed.lat"], 1.0)
        acc = agg._acc.numpy()
        for name, v in values.items():
            want = np.zeros(2 * BL + 1, np.int64)
            b = np.clip(compress_np(v.astype(np.float32)), -BL, BL) + BL
            np.add.at(want, b, 1)
            np.testing.assert_array_equal(
                acc[agg.registry.id_for(name)], want)
        assert e.close()
    finally:
        e.close(drain_timeout=0.0)
        rx.stop()
        agg.close()


def _frame(seq=1, eid=7, names=((0, "m.a"), (1, "m.b")),
           rows=((0, 10, 3), (1, -4, 2))):
    return encode_frame(wire.KIND_DELTA, wire.encode_delta(
        eid, seq, list(names), np.array(rows, np.int32).reshape(-1, 3)))


def test_fed_send_fault_retries_from_the_backlog():
    agg = StubAgg()
    rx = fed.FederationReceiver(agg)
    rx.start()
    inj = FaultInjector().plan("fed.send", "raise", on_call=1)
    e = fed.FederationEmitter(("127.0.0.1", rx.port), interval=0.2,
                              emitter_id=45, fault_injector=inj)
    try:
        e.record("fed.lat", 1.0)
        e.flush()
        assert e.drain(DEADLINE_S)  # the injected failure, then the retry
        assert e.send_failures == 1 and inj.fires_at("fed.send") == 1
        _wait(lambda: rx.samples_merged == 1, "the retried delivery")
    finally:
        e.close(drain_timeout=0.0)
        rx.stop()


def test_fed_decode_fault_counts_and_drops_the_connection():
    agg = StubAgg()
    inj = FaultInjector().plan("fed.decode", "raise", on_call=1)
    rx = fed.FederationReceiver(agg, fault_injector=inj)
    rx.start()
    try:
        _send_raw(rx.port, _frame(seq=1) + _frame(seq=2, names=()))
        _wait(lambda: rx.decode_errors == 1, "the injected decode error")
        _wait(lambda: rx.connections_active == 0, "the dropped connection")
        assert agg.merged_samples() == 0 and rx.frames_received == 0
        _send_raw(rx.port, _frame(seq=1))  # the emitter re-delivers
        _wait(lambda: rx.frames_received == 1, "the re-delivery")
        assert agg.merged_samples() == 5
    finally:
        rx.stop()


def test_fed_accept_fault_restarts_the_supervised_accept_loop():
    agg = StubAgg()
    sup = ThreadSupervisor(base_backoff_s=0.01, max_backoff_s=0.05)
    inj = FaultInjector().plan("fed.accept", "raise", on_call=1)
    rx = fed.FederationReceiver(agg, supervisor=sup, fault_injector=inj)
    rx.start()
    try:
        try:
            _send_raw(rx.port, _frame(seq=1))  # crashes the accept loop
        except OSError:
            pass  # the reset may reach the sender
        _wait(lambda: sup.total_restarts >= 1, "the supervised restart")
        assert sup.restarts_by_name == {"loghisto-fed-accept": 1}
        _send_raw(rx.port, _frame(seq=1))  # the retry gets through
        _wait(lambda: rx.frames_received == 1, "the post-restart frame")
        assert agg.merged_samples() == 5
    finally:
        rx.stop()


def test_torn_frame_at_eof_counts_and_merges_nothing():
    agg = StubAgg()
    rx = fed.FederationReceiver(agg)
    rx.start()
    try:
        frame = _frame()
        _send_raw(rx.port, frame[: len(frame) // 2])  # a crash mid-send
        _wait(lambda: rx.decode_errors == 1, "the torn-frame count")
        assert rx.frames_received == 0 and agg.merged_samples() == 0
        _send_raw(rx.port, frame)
        _wait(lambda: rx.frames_received == 1, "the clean retry")
        assert agg.merged_samples() == 5
    finally:
        rx.stop()


# -- freshness, lag and skew of a standalone receiver --------------------- #


def _v2(w, enc, eid, seq, mono_s, wall_s, names=(), health=None, rows=()):
    packed = np.array(rows, np.int32).reshape(-1, 3)
    return enc(w.KIND_DELTA2, w.encode_delta2(
        eid, seq, list(names), packed, int(mono_s * 1e9),
        int(wall_s * 1e9), health))


def _fleet_script(rx, w, enc, clock):
    """Anchors, lag, a wall step, skew, a silent emitter, a v1 emitter,
    health piggyback and the publisher mode, on a fake receiver clock.
    Returns the readings taken along the way."""
    out = {}
    rx.starvation_s = 0.2
    health = {"p99_us": {"fold": 42.0, "encode": 7.0}, "backlog": 3,
              "fail": 1, "restarts": 2, "up_s": 60.0}

    def feed(*buffers):
        _feed(rx, buffers)

    feed(_v2(w, enc, 1, 1, 100.0, 5000.0, [(0, "m.a")], health,
             [(0, 10, 3)]))
    feed(_v2(w, enc, 2, 1, 7.0, 9000.0, [(0, "m.b")], None, [(0, 1, 1)]))
    out["fresh_after_anchor"] = list(rx.freshness_values)
    clock.advance(2.0)
    # emitter 1: captured 1 s after its anchor, arrives 2 s after it
    feed(_v2(w, enc, 1, 2, 101.0, 5001.0))
    out["lag_1"] = rx.stats()["emitters"][f"{1:016x}"]["lag_s"]
    out["fresh_1"] = rx.freshness_values[-1]
    # its wall clock steps back a minute: skew, never a negative lag
    clock.advance(0.5)
    feed(_v2(w, enc, 1, 3, 101.5, 4941.5))
    out["stepped"] = rx.stats()["emitters"][f"{1:016x}"]
    out["max_skew"] = rx.max_emitter_skew_s()
    feed(_v1(w, enc, 3, 1))
    clock.advance(1.0)
    # emitter 1 keeps up; emitters 2 and 3 fall silent
    feed(_v2(w, enc, 1, 4, 103.5, 4943.5))
    out["report"] = rx.fleet_report()
    out["max_lag"] = rx.max_emitter_lag_s()
    out["frame_age"] = rx.last_frame_age_s()
    out["totals"] = (rx.freshness_totals(1.5e6),
                     rx.freshness_totals(1.5e6, emitter_id=1),
                     rx.freshness_totals(1.0, emitter_id=99))
    # publisher mode: pending until note_publish
    rx.has_publisher = True
    feed(_v2(w, enc, 1, 5, 103.6, 4943.6))
    out["pending"] = rx.stats()["freshness_pending"]
    clock.advance(0.25)
    out["pending_age"] = rx.oldest_pending_age_s()
    out["published"] = rx.note_publish(7)
    out["after_publish"] = rx.stats()
    return out


def _v1(w, enc, eid, seq):
    return enc(w.KIND_DELTA, w.encode_delta(
        eid, seq, [(0, "m.v1")], np.array([[0, 3, 4]], np.int32)))


def test_freshness_lag_and_skew_equal_jax(clocks):
    got = want = None
    pms, jms = (MetricSystem(interval=1.0, sys_stats=False),
                JaxMetricSystem(interval=1.0, sys_stats=False))
    try:
        for rx_cls, w, enc, clock, ms in (
                (fed.FederationReceiver, wire, encode_frame, clocks[0], pms),
                (jax_fed.FederationReceiver, jwire, jax_encode_frame,
                 clocks[1], jms)):
            rx = rx_cls(StubAgg())
            rx.register_gauges(ms)
            out = _fleet_script(rx, w, enc, clock)
            with ms._gauge_lock:
                funcs = dict(ms._gauge_funcs)
            out["gauges"] = {k: f() for k, f in sorted(funcs.items())
                             if k.startswith(("fed", "federation"))}
            out["hist"] = ms.collect_raw_metrics().histograms
            rx.stop()
            got, want = (out, want) if got is None else (got, out)
    finally:
        pms.stop()
        jms.stop()
    assert got == want
    # and the readings mean what they say
    assert got["fresh_after_anchor"] == [0.0, 0.0]
    assert got["lag_1"] == pytest.approx(1.0, abs=1e-3)
    assert got["fresh_1"] == pytest.approx(1e6, rel=1e-4)
    assert 0.0 <= got["stepped"]["lag_s"] < 2.0
    assert got["stepped"]["skew_s"] == pytest.approx(-60.0, abs=1e-3)
    assert got["max_skew"] == pytest.approx(60.0, abs=1e-3)
    rep = got["report"]
    e1, e2, e3 = (f"{i:016x}" for i in (1, 2, 3))
    assert rep["flags"]["clock_skew"] == [e1]
    assert rep["flags"]["starved"] == [e2, e3]
    assert got["max_lag"] == pytest.approx(3.5, abs=1e-3)
    assert got["frame_age"] == pytest.approx(0.0, abs=1e-3)
    assert rep["emitters"][e3]["wire_v"] == 1
    assert rep["emitters"][e1]["stage_p99_us"] == {"fold": 42.0,
                                                   "encode": 7.0}
    assert rep["top"]["slowest"] == [e1] and rep["top"]["flappiest"] == [e1]
    assert rep["fleet"]["emitters"] == 3 and rep["fleet"]["seq_gaps"] == 0
    assert got["totals"][2] == (0, 0)
    assert got["totals"][0] == (5, 0) and got["totals"][1] == (4, 0)
    assert rep["fleet"]["freshness_samples"] == 5
    assert got["pending"] == 1 and got["published"] == 1
    assert got["pending_age"] == pytest.approx(0.25, abs=1e-3)
    after = got["after_publish"]
    assert after["freshness_pending"] == 0 and after["freshness_samples"] == 6
    assert after["frames_v1"] == 1
    assert got["gauges"]["federation.ConnectedEmitters"] == 3.0
    assert f"federation.emitter.{2:016x}.LagS" in got["gauges"]
    assert sum(got["hist"]["fed.FreshnessUs"].values()) == 6
