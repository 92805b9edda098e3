#!/usr/bin/env python3
"""Which ``torch.profiler`` session makes the hand-built kernels vanish
from later traces (ROADMAP F7), split by launch API.

K1 and K2b launch through ``cudaLaunchKernelEx`` with a cluster
attribute; K3 launches with ``<<<>>>``; PyTorch's own reduction kernel
is the control.  Each mode runs in a fresh process:

  * ``captures``: ``utils.trace.capture`` over one probe, eight times;
  * ``scheduled``: one capture, then six scheduled ``profile`` sessions
    (warmup 1, active 1, ``on_trace_ready`` reading ``events()``) as
    ``chip_smoke._device_busy`` opens them, each followed by a capture;
  * ``scheduled_quiet``: the same sessions with an ``on_trace_ready``
    that reads nothing;
  * ``plain_sessions``: the same count of unscheduled sessions;
  * ``firehose``: ``chip_smoke``'s firehose sequence itself (the K1
    firehose step at 10,000 metrics under ``_device_busy``, three
    readings), then a capture;
  * ``firehose_run``: ``run_firehose`` on the K1 path at 10,000 metrics
    for 3 s (its threads and its OpenTSDB export), then a capture;
  * ``firehose_phase``: ``chip_smoke.phase_firehose`` whole, then a
    capture.

Every capture is taken three times: as ``capture`` takes it (the
probe's launches are not waited for before ``stop()``), with a
``torch.cuda.synchronize()`` before ``stop()``, and as
``TorchAggregator.collect()`` takes it under ``LOGHISTO_TRACE_DIR``
(K1 launched by the transfer worker's thread).  A capture's record is
the set of probe kernels its Chrome trace holds as ``cat == "kernel"``
events; its launch records (``cudaLaunchKernel``/``Ex``) are listed
beside them.

    python3 scripts/torch_profiler_split.py            # every mode
    python3 scripts/torch_profiler_split.py scheduled  # one mode

Prints one JSON object a mode and, with no mode named, a summary line.
Needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

MODES = ("captures", "scheduled", "scheduled_quiet", "plain_sessions",
         "firehose", "firehose_run", "firehose_phase")
PROBE = {
    "K1": "lh_fused_ingest_kernel",     # cudaLaunchKernelEx, cluster 8
    "K2b": "lh_row_ingest_kernel",      # cudaLaunchKernelEx, cluster 8
    "K3": "lh_sparse_ingest_kernel",    # <<<>>>
    "torch_sum": "reduce_kernel",       # PyTorch's own launch
}
SESSIONS = 6
BL = 4096
M = 1024
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _setup(torch):
    from loghisto_tpu_torch.ops.fused_ingest import fused_ingest_batch
    from loghisto_tpu_torch.ops.row_ingest import row_ingest_batch
    from loghisto_tpu_torch.ops.sparse_ingest import sparse_ingest

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    n = 1 << 18
    ids = torch.from_numpy(rng.integers(0, M, n).astype(np.int32)).to(dev)
    values = torch.from_numpy(
        rng.lognormal(2.0, 1.0, n).astype(np.float32)).to(dev)
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    packed = np.stack([rng.integers(0, M, n), rng.integers(-BL, BL + 1, n),
                       np.ones(n, dtype=np.int64)], axis=1).astype(np.int32)
    packed = torch.from_numpy(packed).to(dev)
    acc = torch.zeros((M, 2 * BL + 1), dtype=torch.int32, device=dev)
    row = torch.zeros((1, 2 * BL + 1), dtype=torch.int32, device=dev)

    def probe(sync: bool = True):
        fused_ingest_batch(acc, ids, values, BL)
        row_ingest_batch(row, zeros, values, BL)
        sparse_ingest(acc, packed, BL)
        acc.sum()
        if sync:
            torch.cuda.synchronize()

    probe()
    return probe


def _names(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    launches = sorted({e.get("name", "") for e in events
                       if e.get("name", "").startswith("cudaLaunchKernel")})
    return kernels, launches


def _seen(kernel_names):
    return sorted(k for k, pat in PROBE.items()
                  if any(pat in n for n in kernel_names))


def _capture(torch, probe, synced: bool):
    """One trace of the unsynchronised probe: ``utils.trace.capture`` as
    it is, or the same recorder with a synchronize before ``stop()``."""
    from torch.profiler import ProfilerActivity, profile

    from loghisto_tpu_torch.utils.trace import capture

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.json")
        if synced:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
            probe(sync=False)
            torch.cuda.synchronize()
            prof.stop()
            prof.export_chrome_trace(path)
        else:
            with capture(path):
                probe(sync=False)
            torch.cuda.synchronize()
        kernels, launches = _names(path)
    return {"kernels": _seen(kernels), "launch_records": launches}


def _collect_capture(torch):
    """One ``collect()`` under LOGHISTO_TRACE_DIR: the buffered batch
    ships inside the capture, and the worker thread launches K1."""
    import glob

    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    rng = np.random.default_rng(11)
    agg = TorchAggregator(num_metrics=M, batch_size=1 << 20)
    n = 1 << 18
    agg.record_batch(rng.integers(0, M, n).astype(np.int32),
                     rng.lognormal(2.0, 1.0, n).astype(np.float32))
    old = os.environ.get("LOGHISTO_TRACE_DIR")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.environ["LOGHISTO_TRACE_DIR"] = tmp
            agg.collect()
            (path,) = glob.glob(os.path.join(tmp, "loghisto_collect",
                                             "*.json"))
            kernels, launches = _names(path)
    finally:
        if old is None:
            os.environ.pop("LOGHISTO_TRACE_DIR", None)
        else:
            os.environ["LOGHISTO_TRACE_DIR"] = old
        agg.close()
    return {"kernels": _seen(kernels), "launch_records": launches}


def _captures(torch, probe):
    return {"as_is": _capture(torch, probe, False),
            "synced": _capture(torch, probe, True),
            "collect": _collect_capture(torch)}


def _firehose_run(torch):
    """run_firehose on the K1 path at 10,000 metrics, as
    ``chip_smoke.phase_firehose`` runs it (export to a local sink)."""
    import io

    import chip_smoke
    from loghisto_tpu_torch.firehose import run_firehose

    sink = chip_smoke._Sink()
    try:
        summary = run_firehose(num_metrics=chip_smoke.M,
                               batch=chip_smoke.FH_BATCH,
                               seconds=chip_smoke.FH_SECONDS, interval=1.0,
                               sink=sink.address, ingest_path="auto",
                               out=io.StringIO(), seed=chip_smoke.SEED)
    finally:
        sink.close()
    return summary["intervals"]


def _scheduled(torch, probe, read_events: bool):
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []

    def ready(p):
        if read_events:
            traced.extend(p.events())

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=ready) as prof:
        probe()
        prof.step()
        probe()
        prof.step()
    names = [e.name for e in traced
             if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return _seen(names) if read_events else None


def _plain_session(torch, probe):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        probe()
    return _seen([e.key for e in prof.key_averages()])


def _firehose(torch):
    """chip_smoke's firehose sequence: the K1 firehose step at 10,000
    metrics, three ``_device_busy`` readings of its steady loop."""
    import chip_smoke
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.firehose import make_firehose_step

    dev = torch.device("cuda")
    step = make_firehose_step(chip_smoke.M, chip_smoke.FH_BATCH,
                              MetricConfig(), ingest_path="auto")
    acc = torch.zeros((chip_smoke.M, chip_smoke.B), dtype=torch.int32,
                      device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def interval():
        for _ in range(8):
            step(acc, gen)
        torch.cuda.synchronize()

    tops = []
    for _ in range(chip_smoke.PROFILE_READINGS):
        r = chip_smoke._device_busy(torch, interval)
        tops.append(sorted(r["top_kernels_ms"])[:3])
    return tops


def run_mode(mode: str) -> dict:
    import torch

    probe = _setup(torch)
    out = {"mode": mode, "device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "before": _captures(torch, probe), "after": []}
    if mode == "captures":
        for _ in range(SESSIONS + 2):
            out["after"].append(_captures(torch, probe))
    elif mode in ("scheduled", "scheduled_quiet", "plain_sessions"):
        for _ in range(SESSIONS):
            if mode == "plain_sessions":
                inside = _plain_session(torch, probe)
            else:
                inside = _scheduled(torch, probe, mode == "scheduled")
            out["after"].append({"session_saw": inside,
                                 **_captures(torch, probe)})
    elif mode == "firehose":
        out["firehose_top_kernels"] = _firehose(torch)
        out["after"].append(_captures(torch, probe))
    elif mode == "firehose_run":
        out["firehose_intervals"] = _firehose_run(torch)
        out["after"].append(_captures(torch, probe))
    elif mode == "firehose_phase":
        import chip_smoke

        chip_smoke.phase_firehose(torch)
        out["after"].append(_captures(torch, probe))
    else:
        raise SystemExit(f"unknown mode {mode!r}; modes: {MODES}")
    # the first capture after which each probe kernel is missing
    first_gone = {}
    for i, entry in enumerate(out["after"]):
        for how in ("as_is", "synced", "collect"):
            # collect() launches K1 and PyTorch's kernels only
            for k in (("K1", "torch_sum") if how == "collect" else PROBE):
                key = f"{k}/{how}"
                if key not in first_gone and k not in entry[how]["kernels"]:
                    first_gone[key] = i
    out["first_capture_without"] = first_gone
    return out


def main(argv) -> int:
    if argv:
        for mode in argv:
            print(json.dumps(run_mode(mode)), flush=True)
        return 0
    summary, rc = {}, 0
    for mode in MODES:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               mode], capture_output=True, text=True,
                              timeout=600)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            summary[mode] = {"rc": proc.returncode}
            rc = 1
            continue
        summary[mode] = json.loads(proc.stdout.strip().splitlines()[-1])[
            "first_capture_without"]
    print(json.dumps({"summary": summary}), flush=True)
    return rc


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        sys.exit(main(sys.argv[1:]))
