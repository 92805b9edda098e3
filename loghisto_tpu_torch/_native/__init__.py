"""The native host tier of the port: ctypes loader and wrappers of
``ingest.cpp`` and the ``fastpath.cpp`` CPython extension (counterpart of
``loghisto_tpu/_native/__init__.py``; the C++ sources are the port's own
copies, with the extension's module and capsule renamed so that both
packages' extensions load in one process).

Both sources are built with ``g++`` at first use into
``build/loghisto_tpu_torch/native/`` (git-ignored).  A library's file
name carries a hash of its source, the flags, ``EXT_SUFFIX``, ``g++
--version`` and the host's CPU model and flags (``-march=native``
code runs only where it was built), so an edited source or another host
rebuilds and a stale library is never loaded.  Processes that start one
build at once take turns on a lock file beside it, so one runs ``g++``
and the rest load its result; each build writes a private temporary
file and ``os.replace``s it into place, so no process can load half a
library.

This is host code, not a device kernel.  Every entry point degrades as
the reference's does: with no compiler ``available()`` is False, the
build error (``g++``'s stderr) is logged and kept in ``build_error()``,
and callers take the NumPy tier (``ops/fold.py``, ``NumpyCellStore``)
or the Python staging path.

Every pointer handed to C is a contiguous array of the checked dtype,
its length taken from the array, and the array is held by a local
across the call.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import importlib.util
import logging
import os
import subprocess
import sysconfig
import tempfile
import threading
from pathlib import Path

import numpy as np

from loghisto_tpu_torch.ops._build import BUILD_DIR as _KERNEL_BUILD_DIR
from loghisto_tpu_torch.ops.fold import (  # noqa: F401  (re-exported)
    PACKED_COUNT_CAP,
    compress_np_host,
    fold_packed,
    fold_packed_numpy,
    pack_cells,
    unpack_cells,
)

logger = logging.getLogger("loghisto_tpu_torch")

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _KERNEL_BUILD_DIR / "native"
INGEST_SRC = _HERE / "ingest.cpp"
FASTPATH_SRC = _HERE / "fastpath.cpp"
FASTPATH_MODULE = "loghisto_torch_fastpath"
EXT_SUFFIX = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
# -pthread: the parallel fold and drain entry points spawn std::threads
INGEST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-march=native",
                "-pthread"]
FASTPATH_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17",
                  f"-I{sysconfig.get_paths()['include']}"]

_lock = threading.Lock()
_lib = None
_build_error: str | None = None
_fastpath = None
_fastpath_error: str | None = None


def _host_key() -> bytes:
    """What ``-march=native`` code depends on besides its source: the
    compiler and the host's CPU model and feature flags."""
    try:
        gxx = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        gxx = "no g++"
    cpu = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    cpu.append(line.strip())
                    if len(cpu) == 2:
                        break
    except OSError:
        pass
    return (gxx + "\n".join(cpu)).encode()


def _lib_path(src: Path, flags: list, stem: str, suffix: str) -> Path:
    """The hash-named library file of ``src`` built with ``flags``."""
    h = hashlib.sha256()
    h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(EXT_SUFFIX.encode())
    h.update(_host_key())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}{suffix}"


def _compile(src: Path, flags: list, out: Path) -> str | None:
    """Build ``src`` into ``out`` under an exclusive lock on
    ``out.lock``, through a private temporary file and an atomic rename
    (a library already there is kept).  Returns the error (``g++``'s
    stderr) or None."""
    if out.exists():
        return None
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        lock = open(out.with_name(out.name + ".lock"), "a")
    except OSError as e:
        return f"cannot build into {out.parent}: {e}"
    with lock:
        # held until the file closes; the kernel drops it if we die
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while we waited
            return None
        return _compile_locked(src, flags, out)


def _compile_locked(src: Path, flags: list, out: Path) -> str | None:
    """``g++`` into a private temporary file, renamed onto ``out``."""
    fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", *flags, "-o", tmp, str(src)],
            capture_output=True, text=True, timeout=300,
        )
        if proc.returncode != 0:
            return f"g++ failed building {src.name}: {proc.stderr[-4000:]}"
        os.replace(tmp, out)
        return None
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ invocation failed building {src.name}: {e}"
    finally:
        try:
            os.unlink(tmp)
        except FileNotFoundError:
            pass


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_PI32 = ctypes.POINTER(ctypes.c_int32)
_PF32 = ctypes.POINTER(ctypes.c_float)
_PF64 = ctypes.POINTER(ctypes.c_double)
_PI16 = ctypes.POINTER(ctypes.c_int16)
_PPI32 = ctypes.POINTER(_PI32)

# C entry point -> (restype, argtypes)
_SIGNATURES = {
    "lh_create": (_P, [_I, _I64]),
    "lh_destroy": (None, [_P]),
    "lh_num_shards": (_I, [_P]),
    "lh_record": (_I64, [_P, _I, ctypes.c_int32, ctypes.c_double]),
    "lh_record_batch": (_I64, [_P, _I, _PI32, _PF64, _I64]),
    "lh_drain": (_I64, [_P, _I, _PI32, _PF64, _I64]),
    "lh_dropped": (ctypes.c_uint64, [_P]),
    "lh_compress": (None, [_PF64, _I64, _I, _PI16]),
    "lh_decompress": (None, [_PI16, _I64, _I, _PF64]),
    "lh_accumulate_dense": (None, [_PI32, _PF64, _I64, _I, _I,
                                   ctypes.POINTER(ctypes.c_uint32),
                                   ctypes.c_int32]),
    "lh_cells_create": (_P, [_I64]),
    "lh_cells_destroy": (None, [_P]),
    "lh_cells_size": (_I64, [_P]),
    "lh_cells_add": (_I64, [_P, _PI32, _PF32, _I64, _I, _I]),
    "lh_cells_drain": (_I64, [_P, _PI32, _PI32,
                              ctypes.POINTER(ctypes.c_int64)]),
    "lh_cells_drain_packed": (_I64, [_P, _PI32]),
    "lh_packed_free": (None, [_PI32]),
    "lh_fold_packed": (_I64, [_PI32, _PF32, _I64, _I, _I, _I, _PPI32]),
    "lh_cells_drain_packed_multi": (_I64, [ctypes.POINTER(_P), _I, _I,
                                           _PPI32]),
}


def _load():
    """The ingest library, built and loaded once; None (with the error
    logged and kept) when it cannot be."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        out = _lib_path(INGEST_SRC, INGEST_FLAGS, "libloghisto_ingest", ".so")
        err = _compile(INGEST_SRC, INGEST_FLAGS, out)
        if err is None:
            try:
                lib = ctypes.CDLL(str(out))
            except OSError as e:
                err = f"dlopen failed: {e}"
        if err is not None:
            _build_error = err
            logger.warning("native host tier unavailable; the NumPy tier "
                           "serves: %s", err)
            return None
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def _load_fastpath():
    """The per-call staging extension, built and imported once; None
    (with the error logged and kept) when it cannot be."""
    global _fastpath, _fastpath_error
    with _lock:
        if _fastpath is not None or _fastpath_error is not None:
            return _fastpath
        out = _lib_path(FASTPATH_SRC, FASTPATH_FLAGS, FASTPATH_MODULE,
                       EXT_SUFFIX)
        err = _compile(FASTPATH_SRC, FASTPATH_FLAGS, out)
        if err is None:
            try:
                spec = importlib.util.spec_from_file_location(
                    FASTPATH_MODULE, out)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
            except (ImportError, OSError) as e:
                err = f"import failed: {e}"
        if err is not None:
            _fastpath_error = err
            logger.warning("fast-ingest extension unavailable; the Python "
                           "path serves: %s", err)
            return None
        _fastpath = mod
        return _fastpath


def fastpath_available() -> bool:
    return _load_fastpath() is not None


def fastpath_error() -> str | None:
    _load_fastpath()
    return _fastpath_error


def fastpath_module():
    mod = _load_fastpath()
    if mod is None:
        raise RuntimeError(f"fastpath unavailable: {_fastpath_error}")
    return mod


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _pair(ids, values, value_dtype):
    """(ids int32, values value_dtype), contiguous and of one shape."""
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    values = np.ascontiguousarray(values, dtype=value_dtype)
    if ids.shape != values.shape or ids.ndim != 1:
        raise ValueError("ids and values must be 1-D and of the same shape")
    return ids, values


def _take_packed(lib, out_ptr, rows: int) -> np.ndarray:
    """Copy a C-allocated [rows, 3] int32 buffer out and free it."""
    try:
        if rows == 0:
            return np.empty((0, 3), dtype=np.int32)
        return np.ctypeslib.as_array(out_ptr, shape=(rows, 3)).copy()
    finally:
        lib.lh_packed_free(out_ptr)


def compress(values: np.ndarray, precision: int = 100) -> np.ndarray:
    """Native vectorized codec: int16 buckets, bit for bit
    ``ops.codec.compress_np`` (NaN pins to bucket 0)."""
    lib = _require()
    values = np.ascontiguousarray(values, dtype=np.float64).ravel()
    out = np.empty(len(values), dtype=np.int16)
    lib.lh_compress(_ptr(values, ctypes.c_double), len(values), precision,
                    _ptr(out, ctypes.c_int16))
    return out


def preaggregate(
    ids: np.ndarray, values: np.ndarray, bucket_limit: int,
    precision: int = 100,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-shot compress + dedup of a batch into unique (id, codec_bucket,
    count) cells, through a ``CellStore``.  Returns (ids int32[m],
    codec_buckets int32[m], counts int64[m])."""
    store = CellStore(bucket_limit, precision,
                      initial_capacity=max(1024, 2 * len(ids)))
    try:
        if store.add(ids, values) < len(ids):
            raise MemoryError("cell table allocation failed")
        return store.drain()
    finally:
        store.close()


def accumulate_dense(
    ids: np.ndarray, values: np.ndarray, num_metrics: int,
    bucket_limit: int, precision: int = 100,
    acc: np.ndarray | None = None,
) -> np.ndarray:
    """Native dense accumulate into uint32 [num_metrics, 2 bl + 1]: the
    host verification twin of the card's ingest kernels."""
    lib = _require()
    ids, values = _pair(ids, values, np.float64)
    shape = (num_metrics, 2 * bucket_limit + 1)
    if acc is None:
        acc = np.zeros(shape, dtype=np.uint32)
    elif (acc.shape != shape or acc.dtype != np.uint32
          or not acc.flags.c_contiguous):
        raise ValueError(f"acc must be a contiguous uint32 {shape} array")
    lib.lh_accumulate_dense(
        _ptr(ids, ctypes.c_int32), _ptr(values, ctypes.c_double), len(ids),
        precision, bucket_limit, _ptr(acc, ctypes.c_uint32), num_metrics,
    )
    return acc


class _Handle:
    """A C object owned by one Python object: ``close`` frees it once,
    a second ``close`` is a no-op, a call after ``close`` raises instead
    of handing C a freed pointer, and ``__del__`` is safe at interpreter
    exit (the library is held by the instance, not read from a module
    global)."""

    _handle = None
    _destroy = None

    def _live(self):
        handle = self._handle
        if not handle:
            raise ValueError(f"{type(self).__name__} is closed")
        return handle

    def close(self) -> None:
        handle, self._handle = self._handle, None
        if handle:
            self._destroy(handle)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class CellStore(_Handle):
    """Persistent (id, codec_bucket) -> count host accumulator (an
    open-addressing table in C).  Batches fold in across flushes
    (``add``); ``drain`` empties it into unique-cell arrays for one
    weighted merge on the card (K3).  The wire then carries the
    interval's unique cells, however many samples they absorbed.  One
    writer at a time: ``ShardedCellStore`` serializes its shards."""

    def __init__(self, bucket_limit: int, precision: int = 100,
                 initial_capacity: int = 1 << 16):
        lib = _require()
        self._lib = lib
        self._destroy = lib.lh_cells_destroy
        handle = lib.lh_cells_create(int(initial_capacity))
        if not handle:
            raise MemoryError("lh_cells_create failed")
        self._handle = handle
        self.bucket_limit = bucket_limit
        self.precision = precision

    def __len__(self) -> int:
        return int(self._lib.lh_cells_size(self._live()))

    def add(self, ids: np.ndarray, values: np.ndarray) -> int:
        """Fold a batch in.  Returns the number of samples CONSUMED from
        the front of the batch: len(ids), or fewer only when the table
        could not grow — the consumed prefix is folded exactly once, so
        the caller retries ids[consumed:].  Negative ids are consumed
        but skipped."""
        ids, values = _pair(ids, values, np.float32)
        return int(self._lib.lh_cells_add(
            self._live(), _ptr(ids, ctypes.c_int32),
            _ptr(values, ctypes.c_float), len(ids), self.precision,
            self.bucket_limit,
        ))

    def drain(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Empty the store; returns (ids, codec_buckets, counts)."""
        m = len(self)
        ids_out = np.empty(m, dtype=np.int32)
        buckets_out = np.empty(m, dtype=np.int32)
        counts_out = np.empty(m, dtype=np.int64)
        got = self._lib.lh_cells_drain(
            self._live(), _ptr(ids_out, ctypes.c_int32),
            _ptr(buckets_out, ctypes.c_int32),
            _ptr(counts_out, ctypes.c_int64),
        )
        return ids_out[:got], buckets_out[:got], counts_out[:got]

    def drain_packed(self) -> np.ndarray:
        """Empty the store into one int32 [m, 3] array of (id,
        codec_bucket, count) rows.  A cell whose count exceeds
        ``PACKED_COUNT_CAP`` comes out as several rows over several C
        passes (merges are additive, so split rows stay exact)."""
        parts = []
        while True:
            m = len(self)
            if m == 0:
                break
            out = np.empty((m, 3), dtype=np.int32)
            got = self._lib.lh_cells_drain_packed(
                self._live(), _ptr(out, ctypes.c_int32))
            parts.append(out[:got])
        if not parts:
            return np.empty((0, 3), dtype=np.int32)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)


class NumpyCellStore:
    """Pure-NumPy twin of ``CellStore`` (the same add / drain /
    consumed-prefix contract), so transport="preagg" works without a
    compiler.  Each add deduplicates the batch (``np.unique``) and folds
    the unique cells into a dict keyed like the C table."""

    def __init__(self, bucket_limit: int, precision: int = 100,
                 initial_capacity: int = 1 << 16):
        self._counts: dict[int, int] = {}
        self.bucket_limit = bucket_limit
        self.precision = precision

    def __len__(self) -> int:
        return len(self._counts)

    def add(self, ids: np.ndarray, values: np.ndarray) -> int:
        ids = np.asarray(ids, dtype=np.int32)
        values = np.asarray(values, dtype=np.float32)
        if ids.shape != values.shape:
            raise ValueError("ids and values must have the same shape")
        keep = ids >= 0
        kept_ids, kept_values = ids[keep], values[keep]
        if len(kept_ids):
            b = np.clip(compress_np_host(kept_values, self.precision),
                        -self.bucket_limit, self.bucket_limit)
            keys = ((kept_ids.astype(np.int64) << 16)
                    | (b.astype(np.int64) + 32768))
            ukeys, counts = np.unique(keys, return_counts=True)
            store = self._counts
            for k, c in zip(ukeys.tolist(), counts.tolist()):
                store[k] = store.get(k, 0) + c
        return len(ids)  # dict growth cannot fail part-way

    def drain_packed(self) -> np.ndarray:
        if not self._counts:
            return np.empty((0, 3), dtype=np.int32)
        n = len(self._counts)
        keys = np.fromiter(self._counts.keys(), dtype=np.int64, count=n)
        counts = np.fromiter(self._counts.values(), dtype=np.int64, count=n)
        self._counts = {}
        return pack_cells(keys >> 16, (keys & 0xFFFF) - 32768, counts)

    def drain(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return unpack_cells(self.drain_packed())

    def close(self) -> None:
        self._counts = {}


class ShardedCellStore:
    """K independent cell stores, each behind its own lock, with
    double-buffered draining.

    * ``add(ids, values)`` folds into the CALLING THREAD's shard (sticky
      round-robin): the C fold releases the GIL, so writer threads fold
      in parallel instead of queueing on one table lock.
    * ``drain_packed_all()`` swaps each shard's active store with its
      empty spare under the shard lock (an O(1) critical section) and
      scans the detached tables outside the locks, in one GIL-released
      parallel C call on the native backend.

    Counts stay exact: one (key -> count) cell may sit in several shards;
    the merge on the card is additive, so duplicates cost wire rows
    only."""

    def __init__(self, bucket_limit: int, precision: int = 100,
                 num_shards: int | None = None,
                 initial_capacity: int = 1 << 14,
                 backend: str = "auto"):
        """``backend``: "native" (C tables, raises without a compiler),
        "numpy" (``NumpyCellStore``) or "auto" (native when it builds,
        NumPy otherwise)."""
        if backend not in ("auto", "native", "numpy"):
            raise ValueError(
                f"backend={backend!r}: expected 'auto', 'native', or 'numpy'"
            )
        if backend == "auto":
            backend = "native" if available() else "numpy"
        self.backend = backend
        store_cls = CellStore if backend == "native" else NumpyCellStore
        if num_shards is None:
            num_shards = min(8, os.cpu_count() or 1)
        self.num_shards = max(1, int(num_shards))
        self._locks = [threading.Lock() for _ in range(self.num_shards)]
        self._active = [store_cls(bucket_limit, precision, initial_capacity)
                        for _ in range(self.num_shards)]
        self._spare = [store_cls(bucket_limit, precision, initial_capacity)
                       for _ in range(self.num_shards)]
        # one drainer at a time owns the spare set
        self._drain_lock = threading.Lock()
        self._tl = threading.local()
        self._assign = 0

    def _shard_idx(self) -> int:
        idx = getattr(self._tl, "idx", None)
        if idx is None:
            idx = self._assign % self.num_shards
            self._assign += 1  # a racy placement heuristic only
            self._tl.idx = idx
        return idx

    def __len__(self) -> int:
        # a racy sum: the watermark heuristic, not an invariant
        return sum(len(s) for s in self._active)

    def add(self, ids: np.ndarray, values: np.ndarray) -> int:
        """Fold a batch into this thread's shard; returns the consumed
        prefix length (``CellStore.add``'s contract)."""
        i = self._shard_idx()
        with self._locks[i]:
            return self._active[i].add(ids, values)

    def drain_packed_all(self) -> np.ndarray:
        """Drain every shard into one int32 [m, 3] packed array."""
        with self._drain_lock:
            detached = []
            for i in range(self.num_shards):
                with self._locks[i]:
                    self._active[i], self._spare[i] = (
                        self._spare[i], self._active[i])
                detached.append(self._spare[i])  # the old active
            if self.backend == "native":
                packed = self._drain_native_multi(detached)
                if packed is not None:
                    return packed
            parts = [p for p in (s.drain_packed() for s in detached)
                     if len(p)]
        if not parts:
            return np.empty((0, 3), dtype=np.int32)
        return np.concatenate(parts) if len(parts) > 1 else parts[0]

    @staticmethod
    def _drain_native_multi(stores) -> np.ndarray | None:
        """One parallel C drain of the detached native stores; None when
        its allocation failed (the stores are then untouched and the
        caller drains them one by one)."""
        lib = _require()
        handles = (ctypes.c_void_p * len(stores))(
            *[s._live() for s in stores])
        threads = min(len(stores), os.cpu_count() or 1)
        out_ptr = _PI32()
        rows = lib.lh_cells_drain_packed_multi(
            handles, len(stores), threads, ctypes.byref(out_ptr))
        if rows < 0:
            return None
        return _take_packed(lib, out_ptr, rows)

    def drain(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``drain_packed_all`` as (ids, buckets, counts) columns."""
        return unpack_cells(self.drain_packed_all())

    def close(self) -> None:
        for s in self._active + self._spare:
            s.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def fold_packed_native(
    ids: np.ndarray, values: np.ndarray, bucket_limit: int,
    precision: int = 100, num_threads: int | None = None,
) -> np.ndarray:
    """Parallel native fold (``lh_fold_packed``): ``num_threads``
    thread-local hash tables over disjoint slices of the batch (at most
    one per 2^16 samples), the GIL released for the whole call.  Raises
    MemoryError when a table or the output could not be allocated."""
    lib = _require()
    ids, values = _pair(ids, values, np.float32)
    if num_threads is None:
        num_threads = min(8, os.cpu_count() or 1)
    out_ptr = _PI32()
    rows = lib.lh_fold_packed(
        _ptr(ids, ctypes.c_int32), _ptr(values, ctypes.c_float), len(ids),
        precision, bucket_limit, int(num_threads), ctypes.byref(out_ptr),
    )
    if rows < 0:
        raise MemoryError("lh_fold_packed allocation failed")
    return _take_packed(lib, out_ptr, rows)


class NativeIngestBuffer(_Handle):
    """Lock-striped native staging buffer of (metric_id, value) samples.

    Writers call ``record`` / ``record_batch`` (the GIL released inside
    the C call); the transfer path drains every shard.  A full shard
    sheds and counts (``dropped``), the reference's shed-don't-block
    policy."""

    def __init__(self, num_shards: int = 16,
                 capacity_per_shard: int = 1 << 20):
        lib = _require()
        self._lib = lib
        self._destroy = lib.lh_destroy
        handle = lib.lh_create(int(num_shards), int(capacity_per_shard))
        if not handle:
            raise MemoryError("lh_create failed")
        self._handle = handle
        self.num_shards = int(num_shards)
        self.capacity_per_shard = int(capacity_per_shard)
        self._shard_counter = 0
        self._tl = threading.local()

    def _shard(self) -> int:
        idx = getattr(self._tl, "idx", None)
        if idx is None:
            idx = self._shard_counter % self.num_shards
            self._shard_counter += 1
            self._tl.idx = idx
        return idx

    def record(self, metric_id: int, value: float) -> int:
        return int(self._lib.lh_record(
            self._live(), self._shard(), metric_id, value))

    def record_batch(self, ids: np.ndarray, values: np.ndarray) -> int:
        """Stage a batch into this thread's shard; returns the samples
        accepted (the rest were shed and counted)."""
        ids, values = _pair(ids, values, np.float64)
        return int(self._lib.lh_record_batch(
            self._live(), self._shard(), _ptr(ids, ctypes.c_int32),
            _ptr(values, ctypes.c_double), len(ids),
        ))

    def drain(self) -> tuple[np.ndarray, np.ndarray]:
        """Swap out and return every shard's staged samples."""
        cap = self.capacity_per_shard
        all_ids, all_values = [], []
        ids = np.empty(cap, dtype=np.int32)
        values = np.empty(cap, dtype=np.float64)
        for shard in range(self.num_shards):
            n = self._lib.lh_drain(
                self._live(), shard, _ptr(ids, ctypes.c_int32),
                _ptr(values, ctypes.c_double), cap,
            )
            if n > 0:
                all_ids.append(ids[:n].copy())
                all_values.append(values[:n].copy())
        if not all_ids:
            return (np.empty(0, dtype=np.int32),
                    np.empty(0, dtype=np.float64))
        return np.concatenate(all_ids), np.concatenate(all_values)

    @property
    def dropped(self) -> int:
        return int(self._lib.lh_dropped(self._live()))
