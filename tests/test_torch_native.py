"""The port's native host tier (``loghisto_tpu_torch/_native``) against
the JAX package's (``loghisto_tpu/_native``) on the same seeded inputs.

Integer outputs are held EQUAL: the codec bit for bit (the NaN contract
included), cell stores and folds as cell multisets (the same (id,
bucket) -> total count, however the rows split across shards, threads
or the int32 cap), staging buffers by content and shed count.  Nothing
here asserts a time or a rate, thread counts are explicit (1, 2 or 4)
and sharded stores hold at most 4 shards.
"""

import ctypes
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from loghisto_tpu import _native as jax_native
from loghisto_tpu.ops.codec import compress_np
from loghisto_tpu_torch import _native

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _both_built():
    # both libraries build here (g++); a failure names its stderr
    assert _native.available(), _native.build_error()
    assert jax_native.available(), jax_native.build_error()


class _cells:
    """A packed [m, 3] array as its cell multiset: the sorted unique
    (id, bucket) keys and their total counts, however the rows split."""

    def __init__(self, packed):
        p = np.asarray(packed, dtype=np.int64).reshape(-1, 3)
        keys = (p[:, 0] << 16) | (p[:, 1] + 32768)
        self.keys, inv = np.unique(keys, return_inverse=True)
        self.counts = np.bincount(inv, weights=p[:, 2],
                                  minlength=len(self.keys)).astype(np.int64)
        self.buckets = (self.keys & 0xFFFF) - 32768

    def __eq__(self, other):
        return (np.array_equal(self.keys, other.keys)
                and np.array_equal(self.counts, other.counts))


def _columns(ids, buckets, counts):
    return _cells(np.stack([ids, buckets, counts], axis=1))


def _stream(seed, n, m=40, bl=512):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, m, n).astype(np.int32)  # -1: shed ids
    vals = np.concatenate([
        rng.lognormal(3, 2, n - 6) * np.where(rng.random(n - 6) < 0.2,
                                               -1, 1),
        [0.0, -0.0, np.nan, np.inf, -np.inf, 1e30],
    ]).astype(np.float32)
    return ids, vals


def test_compress_bit_equal_to_jax_and_numpy():
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.uniform(-1e6, 1e6, 5000), rng.lognormal(0, 3, 5000),
        [0.0, -0.0, 1.0, -1.0, 1e300, -1e300, np.nan, -np.nan, np.inf,
         -np.inf, 5e-324],
    ])
    got = _native.compress(vals)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, jax_native.compress(vals))
    nan = np.isnan(vals)
    np.testing.assert_array_equal(got[~nan], compress_np(vals[~nan]))
    assert (got[nan] == 0).all()  # NaN pins to bucket 0


@pytest.mark.parametrize("values", ["stream", "nan"])
def test_preaggregate_equal_to_jax(values):
    if values == "nan":
        ids = np.zeros(3, np.int32)
        vals = np.full(3, np.nan, np.float32)
    else:
        ids, vals = _stream(2, 50_000)
    got = _native.preaggregate(ids, vals, 512)
    want = jax_native.preaggregate(ids, vals, 512)
    assert [a.dtype for a in got] == [np.int32, np.int32, np.int64]
    assert _columns(*got) == _columns(*want)
    assert int(got[2].sum()) == int((ids >= 0).sum())
    if values == "nan":
        cells = _columns(*got)
        assert (cells.keys.tolist(), cells.counts.tolist()) == (
            [32768], [3])  # id 0, bucket 0


def test_accumulate_dense_equal_to_jax():
    rng = np.random.default_rng(1)
    m, bl = 16, 512
    ids = rng.integers(-1, m + 1, 20_000).astype(np.int32)  # some OOB
    vals = rng.lognormal(3, 2, 20_000)
    got = _native.accumulate_dense(ids, vals, m, bl)
    np.testing.assert_array_equal(
        got, jax_native.accumulate_dense(ids, vals, m, bl))
    assert int(got.sum()) == int(((ids >= 0) & (ids < m)).sum())
    again = _native.accumulate_dense(ids, vals, m, bl, acc=got)
    assert again is got and int(got.sum()) == 2 * int(
        ((ids >= 0) & (ids < m)).sum())
    with pytest.raises(ValueError, match="contiguous uint32"):
        _native.accumulate_dense(ids, vals, m, bl,
                                 acc=np.zeros((m, 2 * bl + 1), np.int64))


@pytest.mark.parametrize("drain", ["drain", "drain_packed"])
def test_cell_store_drains_equal_to_jax(drain):
    ids, vals = _stream(7, 60_000, m=3000, bl=4096)
    port = _native.CellStore(4096, initial_capacity=1024)
    ref = jax_native.CellStore(4096, initial_capacity=1024)
    try:
        for lo in range(0, len(ids), 20_000):  # counts add across adds
            sl = slice(lo, lo + 20_000)
            assert port.add(ids[sl], vals[sl]) == 20_000
            assert ref.add(ids[sl], vals[sl]) == 20_000
        assert len(port) == len(ref) > 1024  # grew past its first table
        if drain == "drain":
            got, want = _columns(*port.drain()), _columns(*ref.drain())
        else:
            packed = port.drain_packed()
            assert packed.dtype == np.int32 and packed.shape[1] == 3
            got, want = _cells(packed), _cells(ref.drain_packed())
        assert got == want
        assert int(got.counts.sum()) == int((ids >= 0).sum())
        assert (got.buckets < 0).any() and (got.buckets > 0).any()
        assert len(port) == 0 and len(port.drain_packed()) == 0
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_sharded_cell_store_equal_to_jax(backend):
    """Four writer threads per store, each on its own shard; the drained
    cell multiset equals the JAX store's and the single-table oracle."""
    batches = [_stream(20 + k, 8000, m=500) for k in range(8)]
    stores = [
        _native.ShardedCellStore(512, num_shards=4, backend=backend),
        jax_native.ShardedCellStore(512, num_shards=4, backend=backend),
    ]
    try:
        for store in stores:
            assert store.backend == backend

            def writer(k, store=store):
                for ids, vals in batches[k::4]:
                    assert store.add(ids, vals) == len(ids)

            threads = [threading.Thread(target=writer, args=(k,))
                       for k in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
        got, want = (_cells(s.drain_packed_all()) for s in stores)
        ids = np.concatenate([b[0] for b in batches])
        vals = np.concatenate([b[1] for b in batches])
        assert got == want == _columns(*jax_native.preaggregate(ids, vals,
                                                                512))
        assert len(stores[0]) == 0
        assert len(stores[0].drain_packed_all()) == 0
    finally:
        for s in stores:
            s.close()


def test_sharded_drain_concurrent_with_writers_exact():
    """A drainer swaps the double buffers while four writers fold: no
    sample is lost or counted twice."""
    store = _native.ShardedCellStore(1024, num_shards=4)
    drained, stop = [], threading.Event()

    def writer(seed):
        r = np.random.default_rng(seed)
        for _ in range(25):
            ids = r.integers(0, 500, 2000).astype(np.int32)
            vals = r.lognormal(4, 1, 2000).astype(np.float32)
            assert store.add(ids, vals) == 2000

    def drainer():
        while not stop.is_set():
            drained.append(store.drain_packed_all())

    d = threading.Thread(target=drainer)
    writers = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    d.start()
    for w in writers:
        w.start()
    for w in writers:
        w.join(timeout=60)
        assert not w.is_alive()
    stop.set()
    d.join(timeout=60)
    assert not d.is_alive()
    drained.append(store.drain_packed_all())
    total = sum(int(p[:, 2].sum(dtype=np.int64)) for p in drained)
    assert total == 4 * 25 * 2000
    store.close()


def _small_cap_lib(tmp_path, cap):
    """The port's ingest library built with the packed count cap lowered
    to ``cap`` (the same source and loader; a separate file)."""
    flags = [*_native.INGEST_FLAGS, f"-DLH_PACKED_COUNT_CAP_VALUE={cap}"]
    out = tmp_path / "libloghisto_ingest_cap.so"
    err = _native._compile(_native.INGEST_SRC, flags, out)
    assert err is None, err
    lib = ctypes.CDLL(str(out))
    for name, (restype, argtypes) in _native._SIGNATURES.items():
        getattr(lib, name).restype = restype
        getattr(lib, name).argtypes = argtypes
    return lib


def test_packed_drains_split_counts_at_the_cap(tmp_path, monkeypatch):
    """A cell above the packed cap leaves every drain as several rows of
    at most the cap, the int64 total exact: ``drain_packed`` (rows left
    in the table, drained in passes), the sharded whole-set drain and the
    fold.  With the cap lowered to 1000 the split rows equal the JAX
    package's ``pack_cells(cap=1000)`` row multiset; at the real cap the
    NumPy split rule equals the JAX package's on counts past 2^31."""
    cap = 1000
    monkeypatch.setattr(_native, "_lib", _small_cap_lib(tmp_path, cap))
    rng = np.random.default_rng(4)
    ids = np.repeat(np.arange(6, dtype=np.int32), [1, 999, 1000, 1001,
                                                   2500, 7000])
    vals = np.full(len(ids), 10.0, np.float32)
    vals[::3] = 123.0
    perm = rng.permutation(len(ids))
    ids, vals = ids[perm], vals[perm]
    keys, counts = np.unique(
        np.stack([ids, np.clip(compress_np(vals), -512, 512)], 1), axis=0,
        return_counts=True)
    want = sorted(map(tuple, jax_native.pack_cells(
        keys[:, 0], keys[:, 1], counts, cap=cap).tolist()))

    store = _native.CellStore(512)
    assert store.add(ids, vals) == len(ids)
    got = store.drain_packed()
    assert len(store) == 0
    sharded = _native.ShardedCellStore(512, num_shards=2)
    assert sharded.add(ids, vals) == len(ids)
    folded = _native.fold_packed_native(ids, vals, 512, num_threads=1)
    for rows in (got, sharded.drain_packed_all(), folded):
        assert rows.dtype == np.int32 and int(rows[:, 2].max()) == cap
        assert sorted(map(tuple, rows.tolist())) == want
    store.close()
    sharded.close()

    big = np.array([3, (1 << 31) + 5, _native.PACKED_COUNT_CAP], np.int64)
    np.testing.assert_array_equal(
        _native.pack_cells(np.arange(3), np.array([0, -7, 9]), big),
        jax_native.pack_cells(np.arange(3), np.array([0, -7, 9]), big))


@pytest.mark.parametrize("threads", [1, 2, 4])
def test_fold_packed_native_equal_to_jax_and_numpy(threads):
    ids, vals = _stream(30, 300_000, m=2000, bl=1024)
    got = _native.fold_packed_native(ids, vals, 1024, num_threads=threads)
    assert got.dtype == np.int32 and got.shape[1] == 3
    want = _cells(jax_native.fold_packed_native(ids, vals, 1024,
                                                num_threads=threads))
    assert _cells(got) == want
    assert _cells(_native.fold_packed_numpy(ids, vals, 1024)) == want
    assert _cells(jax_native.fold_packed_numpy(ids, vals, 1024)) == want
    # the route choice takes the native tier here
    assert _cells(_native.fold_packed(ids, vals, 1024,
                                      num_threads=threads)) == want
    assert len(_native.fold_packed_native(ids[:0], vals[:0], 1024, 1)) == 0


def test_native_ingest_buffer_equal_to_jax():
    port = _native.NativeIngestBuffer(num_shards=4, capacity_per_shard=1000)
    ref = jax_native.NativeIngestBuffer(num_shards=4,
                                        capacity_per_shard=1000)
    for buf in (port, ref):
        buf.record(3, 42.0)
        buf.record_batch(np.array([1, 2], np.int32), np.array([7.0, 8.0]))
    (pi, pv), (ri, rv) = port.drain(), ref.drain()
    assert pi.dtype == np.int32 and pv.dtype == np.float64
    assert sorted(zip(pi.tolist(), pv.tolist())) == sorted(
        zip(ri.tolist(), rv.tolist())) == [(1, 7.0), (2, 8.0), (3, 42.0)]
    assert len(port.drain()[0]) == 0
    port.close()
    ref.close()

    port = _native.NativeIngestBuffer(num_shards=1, capacity_per_shard=10)
    ref = jax_native.NativeIngestBuffer(num_shards=1, capacity_per_shard=10)
    for buf in (port, ref):
        assert buf.record_batch(np.zeros(25, np.int32), np.ones(25)) == 10
        assert buf.record(0, 1.0) == 0
    assert port.dropped == ref.dropped == 16
    assert len(port.drain()[0]) == len(ref.drain()[0]) == 10
    port.close()
    ref.close()


def test_native_ingest_buffer_concurrent_writers_exact():
    buf = _native.NativeIngestBuffer(num_shards=4, capacity_per_shard=1 << 16)

    def writer(k):
        ids = np.full(100, k, np.int32)
        for _ in range(50):
            assert buf.record_batch(ids, np.full(100, 5.0)) == 100

    threads = [threading.Thread(target=writer, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    ids, values = buf.drain()
    assert buf.dropped == 0
    assert np.bincount(ids).tolist() == [5000] * 4
    assert (values == 5.0).all()
    buf.close()


def test_close_twice_and_use_after_close():
    for obj in (_native.CellStore(64), _native.NativeIngestBuffer(1, 16),
                _native.ShardedCellStore(64, num_shards=2)):
        obj.close()
        obj.close()  # a second close frees nothing
    store = _native.CellStore(64)
    store.close()
    with pytest.raises(ValueError, match="closed"):
        store.add(np.zeros(1, np.int32), np.ones(1, np.float32))
    with pytest.raises(ValueError, match="closed"):
        len(store)
    buf = _native.NativeIngestBuffer(1, 16)
    buf.close()
    with pytest.raises(ValueError, match="closed"):
        buf.drain()
    with pytest.raises(ValueError, match="same shape"):
        _native.CellStore(64).add(np.zeros(2, np.int32),
                                  np.ones(3, np.float32))


def test_first_build_by_four_processes_at_once(tmp_path):
    """Four processes start a first build of the ingest library into one
    empty directory at once: they take turns on the lock, each loads the
    one hash-named library and computes with it, and only the library
    and its lock file are left (no temporary)."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "import numpy as np\n"
        "from loghisto_tpu_torch import _native\n"
        "_native.BUILD_DIR = Path(sys.argv[1])\n"
        "assert _native.available(), _native.build_error()\n"
        "got = _native.compress(np.array([0.0, 10.0, -10.0]))\n"
        "assert got.tolist() == [0, 240, -240], got\n"
        "print(_native._lib._name)\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    loaded = {out.strip() for out, _ in outs}
    assert len(loaded) == 1, loaded
    name = Path(loaded.pop()).name
    files = sorted(f.name for f in tmp_path.iterdir())
    assert files == [name, name + ".lock"], files


def test_both_fastpath_extensions_in_one_process():
    port, ref = _native.fastpath_module(), jax_native.fastpath_module()
    assert port.__name__ == "loghisto_torch_fastpath"
    assert ref.__name__ == "loghisto_fastpath"
    pbuf, rbuf = port.create(8), ref.create(8)
    for mod, buf in ((port, pbuf), (ref, rbuf)):
        mod.record(buf, 1, 2.5)
        assert mod.record_sized(buf, 2, 3.5) == 2
        assert mod.size(buf) == 2
    (pi, pv, pd), (ri, rv, rd) = port.drain(pbuf), ref.drain(rbuf)
    assert (pi, pv, pd) == (ri, rv, rd)
    assert np.frombuffer(pi, np.int32).tolist() == [1, 2]
    # each extension refuses the other's capsule
    with pytest.raises(ValueError):
        port.record(rbuf, 1, 1.0)
    with pytest.raises(ValueError):
        ref.record(pbuf, 1, 1.0)


@pytest.mark.parametrize("fault", ["no_compiler", "compile_error"])
def test_without_the_library_the_numpy_and_python_tiers_serve(tmp_path,
                                                              fault):
    """No g++ on PATH, or a build that g++ refuses: ``available()`` is
    False, the error (g++'s stderr for a refused build) is logged and
    kept, and the NumPy cell store, the NumPy fold, Python staging and
    the Python host path serve with the same results."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "import numpy as np\n"
        "from loghisto_tpu_torch import _native\n"
        "_native.BUILD_DIR = Path(sys.argv[1])\n"
        "if sys.argv[2] == 'compile_error':\n"
        "    _native.INGEST_FLAGS = [*_native.INGEST_FLAGS, '-fno-such-flag']\n"
        "    _native.FASTPATH_FLAGS = [*_native.FASTPATH_FLAGS,"
        " '-fno-such-flag']\n"
        "assert not _native.available() and not _native.fastpath_available()\n"
        "err = _native.build_error()\n"
        "assert ('-fno-such-flag' in err) if sys.argv[2] == 'compile_error'"
        " else ('g++' in err), err\n"
        "from loghisto_tpu_torch.metrics import MetricSystem\n"
        "from loghisto_tpu_torch.parallel.aggregator import TorchAggregator\n"
        "ids = np.arange(300, dtype=np.int32) % 3\n"
        "vals = np.linspace(1, 50, 300, dtype=np.float32)\n"
        "cells = _native.fold_packed(ids, vals, 64)\n"
        "assert int(cells[:, 2].sum()) == 300\n"
        "for kw in ({'transport': 'preagg'}, {'transport': 'sparse'},"
        " {'native_staging': True}):\n"
        "    agg = TorchAggregator(num_metrics=4, batch_size=64,"
        " device='cpu', **kw)\n"
        "    assert agg._native_buf is None\n"
        "    if agg._cell_store is not None:\n"
        "        assert agg._cell_store.backend == 'numpy'\n"
        "    agg.registry.id_for('x')\n"
        "    agg.record_batch(ids, vals)\n"
        "    assert agg.collect().metrics['x_count'] == 100.0\n"
        "    agg.close()\n"
        "ms = MetricSystem(sys_stats=False, fast_ingest=True)\n"
        "assert ms._fast_record is None\n"
        "ms.recorder('r').record(1.0)\n"
        "assert sum(ms.collect_raw_metrics().histograms['r'].values()) == 1\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    if fault == "no_compiler":
        env["PATH"] = str(tmp_path)  # an empty directory: no g++
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "build"), fault],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    assert "native host tier unavailable" in out.stderr
    assert "fast-ingest extension unavailable" in out.stderr
