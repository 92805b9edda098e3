"""Profiling hooks over ``torch.profiler`` (counterpart of
``loghisto_tpu/utils/trace.py``, which wraps ``jax.profiler``).

  * ``profile_region("ingest")``: a context manager that names a block
    with ``torch.profiler.record_function``, so it shows up in a
    profiler trace as a user annotation;
  * ``capture(path)``: records a ``torch.profiler`` trace of the
    enclosed block (CPU activity, and CUDA activity when a card is
    present) and writes it as a Chrome trace to ``path``, also when the
    block raises;
  * with ``LOGHISTO_TRACE_DIR`` set, ``TorchAggregator.collect()``
    captures itself: one Chrome trace per call under
    ``$LOGHISTO_TRACE_DIR/loghisto_collect/``, holding the region, the
    flush's ingest kernels and the statistics' launches.

The fresh-process rule (ROADMAP F7): in a process that has run the
firehose's profiled sequence (``chip_smoke.phase_firehose``), later
captures keep the cluster kernels' launch records
(``cudaLaunchKernelExC``: K1, K2b) but lose their kernel records, while
``<<<>>>`` kernels (K3) and PyTorch's own stay; a synchronize before
``stop()`` does not bring them back (``scripts/torch_profiler_split.py``).
A trace that must hold the cluster kernels is taken in a fresh process.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator


@contextlib.contextmanager
def profile_region(name: str) -> Iterator[None]:
    import torch.profiler

    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def capture(path: str) -> Iterator[None]:
    """Record a torch.profiler trace of the enclosed block to ``path``
    (Chrome trace JSON)."""
    import torch
    import torch.profiler

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)


@contextlib.contextmanager
def maybe_capture(region: str) -> Iterator[None]:
    """Capture a trace of the region when LOGHISTO_TRACE_DIR is set (one
    file per call, ``<dir>/<region>/<pid>.<time_ns>.pt.trace.json``);
    otherwise just annotate it.  Take a trace that must hold K1 or K2b in
    a fresh process (the module docstring's F7 rule)."""
    trace_dir = os.environ.get("LOGHISTO_TRACE_DIR")
    if trace_dir:
        region_dir = os.path.join(trace_dir, region)
        os.makedirs(region_dir, exist_ok=True)
        path = os.path.join(
            region_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json")
        with capture(path), profile_region(region):
            yield
    else:
        with profile_region(region):
            yield
