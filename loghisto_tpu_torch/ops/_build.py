"""Build and bind the Hopper kernels of ``loghisto_tpu_torch/csrc``.

Each kernel source is compiled on its own by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Pointers
come from ``Tensor.data_ptr()``, the stream from
``torch.cuda.current_stream().cuda_stream``; every C entry point returns
``cudaGetLastError()`` after its launch.

Libraries go into ``build/loghisto_tpu_torch/`` beside the package (the
directory is git-ignored), one per source: kernels that share a source
(K4 and K4f in ``paged_store.cu``) share its library.  A library's file
name carries the hash of its sources and flags, so an edited source
rebuilds at first use and a stale library is never loaded.  Only the
sources in ``csrc/`` are built.  A failed build raises with nvcc's
stderr.

Nothing here runs at import time: ``entry`` builds (or finds) and loads
a kernel at its first launch, and ``build_all`` builds every kernel at
once, one ``nvcc`` per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "loghisto_tpu_torch"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# kernel name -> (source, C entry point, argtypes before the stream)
KERNEL_SPECS = {
    "fused_ingest": (
        "fused_ingest.cu", "lh_fused_ingest",
        # acc, ids, values, n, num_metrics, num_buckets, bucket_limit,
        # precision
        [_P, _P, _P, _LL, _I, _I, _I, _I],
    ),
    "row_ingest": (
        "row_ingest.cu", "lh_row_ingest",
        # acc_row, ids (NULL = no mask), values, n, num_buckets,
        # bucket_limit, precision
        [_P, _P, _P, _LL, _I, _I, _I],
    ),
    "sparse_ingest": (
        "sparse_ingest.cu", "lh_sparse_ingest",
        # acc, packed, n, num_metrics, num_buckets, bucket_limit
        [_P, _P, _LL, _I, _I, _I],
    ),
    "paged_scatter": (
        "paged_store.cu", "lh_paged_scatter",
        # pool, packed, n, pool_pages, page_size
        [_P, _P, _LL, _I, _I],
    ),
    "fused_paged_ingest": (
        "paged_store.cu", "lh_fused_paged_ingest",
        # pool, ids, values, n, row_codec, enc_luts, page_table,
        # num_metrics, num_codecs, pages_per_row, pool_pages, page_size,
        # bucket_limit, precision
        [_P, _P, _P, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I],
    ),
    "window_merge": (
        "window_merge.cu", "lh_window_merge",
        # out, ring, slot list (host int32), n, num_slots, M * B
        [_P, _P, _P, _I, _I, _LL],
    ),
}
_SHARED_HEADERS = ("codec.cuh",)

_lock = threading.Lock()
_libs: dict = {}
# ptxas resource report of each build, kept for chip_smoke.py's log
BUILD_LOGS: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.exists():
            return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the Hopper kernels are built "
        "from csrc/ at first use and need the CUDA toolkit"
    )


def _lib_path(source: str) -> Path:
    h = hashlib.sha256()
    for part in (source, *_SHARED_HEADERS):
        h.update((CSRC / part).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lh_{Path(source).stem}_{h.hexdigest()[:16]}.so"


def _start_build(source: str):
    """Start nvcc for one source; returns (Popen, tmp path, final path)
    or None when its library is already built."""
    out = _lib_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [
        nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC),
        "-o", str(tmp), str(CSRC / source),
    ]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )
    return proc, tmp, out


def _finish_build(source: str, started) -> None:
    proc, tmp, out = started
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed building {source!r} (exit "
            f"{proc.returncode}):\n{stderr}{stdout}"
        )
    BUILD_LOGS[source] = stderr + stdout
    os.replace(tmp, out)


def build_all(names=None) -> dict:
    """Build every kernel (or ``names``) in parallel: one nvcc per
    source, all started together.  Returns {source: seconds} of the
    builds that ran (0.0 for a library already built)."""
    names = list(KERNEL_SPECS if names is None else names)
    sources = sorted({KERNEL_SPECS[n][0] for n in names})
    with _lock:
        t0 = time.perf_counter()
        started = {src: _start_build(src) for src in sources}
        errors = []
        for src, s in started.items():
            if s is None:
                continue
            try:
                _finish_build(src, s)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        dt = time.perf_counter() - t0
    return {src: (0.0 if started[src] is None else dt) for src in sources}


def _load(name: str) -> ctypes.CDLL:
    """The library holding kernel ``name``, built and loaded once per
    source; binds the kernel's C entry point."""
    source, symbol, argtypes = KERNEL_SPECS[name]
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            started = _start_build(source)
            if started is not None:
                _finish_build(source, started)
            lib = ctypes.CDLL(str(_lib_path(source)))
            err = lib.lh_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[source] = lib
        fn = getattr(lib, symbol)
        if fn.argtypes is None:
            fn.argtypes = [*argtypes, _P]
            fn.restype = ctypes.c_int
        return lib


def entry(name: str):
    """The C entry point of kernel ``name``, built and loaded on first
    use."""
    lib = _load(name)
    return getattr(lib, KERNEL_SPECS[name][1])


def error_string(name: str, code: int) -> str:
    return _load(name).lh_error_string(code).decode()
