#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``loghisto_tpu_torch``) on one
NVIDIA card: builds the Hopper kernels from ``loghisto_tpu_torch/csrc``
and the native host tier from ``loghisto_tpu_torch/_native`` (g++),
holds each against its plain PyTorch version at the main paths' shapes,
then drives the main paths through ``TorchAggregator`` — record_batch ->
transfer worker -> kernels -> ``collect()`` — and checks their output
against host oracles:

  * the port's static analyzer (``analysis``, before the main paths):
    ``python -m loghisto_tpu_torch.analysis`` in a subprocess (its lazy
    surfaces resolved under the CUDA build of PyTorch with Triton, the
    program registry's mesh entries on four gloo ranks), no finding past
    the reviewed baseline; meanwhile each one-device registry entry on
    the card (K1, K3, K4, K4f, K5, K6, K7): launches equal to its wrapper
    entries and its contract, no synchronisation in a warm call under
    ``torch.cuda.set_sync_debug_mode("error")``, outputs equal to the
    CPU's;
  * dense storage (``main_path``) at 10,000 metrics x 8193 buckets: K1
    on the raw route, K3 on the sparse route, the default
    transport="auto" (which the card's measured crossover keeps on raw),
    K2 on the single row; ``transport_crossover`` measures that
    crossover (raw and sparse, with the native fold, at five cell
    densities) and sweeps the batch size at which K4f beats the sparse
    route on paged storage;
  * the native host tier (``native_host_main_path``) at the same width:
    transport="preagg" from 4 recording threads (K3), the sparse route
    through the native fold (K3), native staging on the raw route at
    10,000 rows (K1) and at one (K2b), each beside a Python-staged raw
    twin (accumulators equal), ``fast_ingest=True`` from 8 threads over
    1,000 names (exact counts, percentiles within the codec's 1%), the
    host fold's rate native against NumPy, and the crossover the native
    fold implies; a route that takes the NumPy or Python tier fails it;
  * paged storage (``paged_main_path``) at 2^20 live rows x 8193 buckets
    (page pool of 2^21 pages), the reference's paged headline: K4f on
    the raw route, K4 on the sparse route, a snapshot query of 4096
    rows on each; plus the dense route on the same workload at 65,536
    rows for contrast;
  * retention (``retention_main_path``): ``TorchMetricSystem(interval=
    1.0, num_metrics=1024, retention=True)`` at the reference's default
    tiers (144 ring slots of [1024, 8193] int32, 4.83 GB): live
    intervals through the reaper and both bridges, then 75 intervals of
    2^20 samples through ``backfill_retention`` and ``merge_raw``; K3
    scatters each interval into every tier's ring slot and K5 (phase
    ``k5_window_merge`` at the 60 x 1024 x 8193 tier-0 ring, and at
    1440 slots) merges every snapshot view of a tier in one launch and
    recomputes windows;
  * the fused commit with lifecycle and drift
    (``lifecycle_drift_main_path``, K6 and K7);
  * every dense ingest path (``ingest_paths_main_path``):
    ``TorchAggregator(ingest_path=p)`` at M = 1, 16, 256 and 10,000 for
    each path the dispatch table admits there — K1, K2b, K8 (phase
    ``k8_multirow_ingest``) and the JAX package's XLA paths in PyTorch —
    2 intervals of 2^22 Zipf(1.3) samples each against the host oracle;
  * checkpoints and journals (``checkpoint_journal_main_path``): a
    dense restart at 10,000 rows into a dense target (remap by name) and
    a paged one (K4), a paged restart at 2^16 rows after the churn
    stream, and a journal and watermark restart of the retention system
    with lifecycle and drift (replays through the fused commit);
  * observability (``observability_main_path``): the retention system
    with ``observability=True`` through the reaper (every commit's nested
    spans, the dogfooded rows, ``/healthz`` across an induced stall, the
    Perfetto dump, ``debug_dump``, the commit's p50/p99 beside the same
    system without observability), ``paged_lifecycle_main_path``'s
    system with a pool past 90% (the watchdog's ``pool_saturation``), a
    ``LOGHISTO_TRACE_DIR``
    capture of the headline ``collect()`` holding K1, PrintBenchmark on
    the card and the Submitter across a listener outage;
  * federation (``federation_main_path``): 8 torch-free emitter
    processes into a FederationReceiver over the dense aggregator (K3),
    the journal's replay and a paged interval (K4); then
    ``federation_system_main_path``: TorchMetricSystem(retention=True,
    observability=, federation=) with its reaper running, 32 paced
    emitter processes, one falling silent (/fleetz, /healthz), the
    served fed.FreshnessUs p99 against the host oracle, a
    FreshnessSloRule, the merged Perfetto trace (K3, K5);
  * the sketches (``sketches_main_path``): LogHistogram through K2a and
    K2b, t-digest, HLL, moments and 10,000 stacked sketches under
    torch.func.vmap, against the CPU and numpy;
  * the mesh over torch.distributed (``mesh_main_path``): world size 1
    under NCCL (TorchAggregator(mesh=make_mesh(1, 1)), the per-batch and
    interval steps, 16 batches of 2^20 at the headline width), two
    child ranks on the one card under gloo on meshes (2, 1) and (1, 2)
    (raw and sparse), every block and collected set against the
    single-device oracle, run_firehose(mesh=) with its counts
    conserved, and the mesh's fused commit: TorchMetricSystem(mesh=,
    retention=True) at 1024 rows and the default tiers on (1, 1), (2, 1)
    and (1, 2), every rank's ring blocks and served query against a
    single-device system on the card, K3 and K5 on every rank; then
    lifecycle and drift (e), checkpoints and recovery (f), paged storage
    (g) and, part (h), lifecycle, checkpoints and recovery on paged
    storage (an eviction across the arenas, a compaction with K6 on
    every rank, a save restored onto another shape and one device, a
    recovery from a checkpoint and a journal);
  * the firehose (``firehose_main_path``): samples made on the card and
    accumulated by each path's step, conservation and path equality on
    one generator seed, then ``run_firehose`` for 3 s per path with its
    OpenTSDB export to an in-process TCP listener.

    python3 chip_smoke.py [phase ...]

With phase names (``k5_window_merge main_path`` ...) it runs the card
phase and those phases only, and prints no kernels line and no result.
Needs a CUDA device (exits nonzero, printing no result, without one, or
without the package beside it).  Imports nothing of JAX.  Each phase
prints one JSON line; a failed phase makes the script exit 1.  The card
line (``nvidia-smi`` name and power limit), the ``kernels`` line and, as
the last line, ``{"ok": true, "device": {...}}`` close a passing run.

Kernel times are CUDA-event means over repeated launches after a warm-up,
queued behind a sleep kernel so that they time the card and not the
host's launch pace (``time_ms``; ``hold=False`` is the earlier rule);
``bound_ms`` is the larger of the bytes the call must move over the
card's memory rate and its operations over the peak rate for their type
(H100 SXM data sheet).  Data-dependent work is counted from this run's
inputs: a scatter moves only the cells it touches.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime as _dt
import functools
import gc
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

# H100 SXM data sheet (dense, full 700 W): HBM3 rate and the float64
# rate outside the tensor cores, which the float64 codec runs at.
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
# float64 operations of one codec evaluation: log1p (~20) + mul, add,
# floor, min, sign
CODEC_OPS = 25

BL = 4096
B = 2 * BL + 1
M = 10_000
BATCH = 1 << 20
SEED = 20261016
PS = np.array([0.0, 0.5, 0.75, 0.9, 0.95, 0.99, 0.999, 0.9999, 1.0])

# paged headline (the reference's benchmarks/paged_store.py): 2^20 live
# rows, the pool sized as there, the band workload of 64 samples per row
# per interval in 4 adjacent codec buckets
PAGED_M = 1 << 20
PAGED_POOL = 1 << max(12, (2 * PAGED_M - 1).bit_length())
SAMPLES_PER_ROW = 64
BUCKETS_PER_ROW = 4
DENSE_CONTRAST_M = 1 << 16
QUERY_IDS = 4096

# retention: TorchMetricSystem(interval=1.0, num_metrics=1024,
# retention=True) with the reference's DEFAULT_TIERS (60 x 1 s, 60 x 1 min,
# 24 x 1 h) at bucket_limit 4096: 144 ring slots of [1024, 8193] int32
RET_M = 1024
RET_TIERS = ((60, 1), (60, 60), (24, 3600))
RET_BACKFILL = 75
RET_SAMPLES = 1 << 20

# lifecycle and drift: the reference's churn workload
# (benchmarks/cardinality_churn.py:6-13, :108-117) on the retention
# system above, with 24 hourly baseline banks (anomaly/config.py:27-30)
LD_STEADY = 512
LD_FRESH = 96
LD_LIVE = 5
LD_BACKFILL = 75
LD_SHIFT_AT = 40
LD_COMPACT_EVERY = 8
LD_BANKS = 24

# labels and group-by: the retention system above with 1024 labeled
# series of rpc.latency, route x code x method
LG_ROUTES = 32
LG_CODES = ("200", "201", "204", "301", "404", "429", "500", "503")
LG_METHODS = ("GET", "POST", "PUT", "DELETE")
LG_LIVE = 4
LG_BACKFILL = 70
LG_SAMPLES = 1 << 20
# at or past a tier's written span a window is served by its full view,
# so an unpinned window must lie inside tier 0's 60 s
LG_UNPINNED = 45

RESULTS: dict = {}
_ONE_SECOND = _dt.timedelta(seconds=1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, ops: float = 0.0, ops_rate: float = FP64_OPS_PER_S):
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_rate * 1e3
    return max(byte_ms, ops_ms), ("bytes" if byte_ms >= ops_ms else "operations")


# SM clock cycles a millisecond at the H100 SXM's boost clock, for the
# sleep kernel that holds the stream while launches are queued
SLEEP_CYCLES_PER_MS = 1_980_000


def hold_stream(torch, ms: float) -> None:
    """Queue a kernel that spins for about ``ms``: the launches queued
    behind it then run back to back, whatever the host's pace."""
    torch.cuda._sleep(int(ms * SLEEP_CYCLES_PER_MS))


def time_ms(torch, fn, reps: int = 20, warmup: int = 3,
            hold: bool = True) -> float:
    """Device time of ``fn``: CUDA events around ``reps`` calls, queued
    behind a sleep kernel long enough for the host to queue them all, so
    a kernel shorter than its wrapper's host time is timed on the card,
    not at the host's launch pace.  ``hold=False`` is the earlier rule:
    calls queued at the host's pace, the slower of the two sets the
    time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:
        hold_stream(torch, 1.0 + 0.1 * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_cold_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of ``fn`` with the 50 MB L2 flushed before each call
    (a 256 MB write between launches); each call between its own pair
    of events, queued behind a hold."""
    flush = torch.empty(1 << 26, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        hold_stream(torch, 0.2)
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        fn()
        pair[1].record()
        pairs.append(pair)
    torch.cuda.synchronize()
    del flush
    return float(np.mean([a.elapsed_time(b) for a, b in pairs]))


def zipf_ids(rng, n, m, a=1.3):
    return ((rng.zipf(a, n) - 1) % m).astype(np.int32)


def lognormal_values(rng, n):
    return rng.lognormal(4.0, 2.0, n).astype(np.float32)


def band_workload(rng, m_rows):
    """One interval of the reference's band workload (shuffled): every
    row gets 64 samples in 4 adjacent codec buckets from base ~ U[0, 400),
    values expm1(bucket / 100) as float32."""
    base = rng.integers(0, 400, m_rows)
    ids = np.repeat(np.arange(m_rows, dtype=np.int32), SAMPLES_PER_ROW)
    buckets = base.repeat(SAMPLES_PER_ROW) + rng.integers(
        0, BUCKETS_PER_ROW, len(ids))
    values = np.expm1(buckets / 100.0).astype(np.float32)
    perm = rng.permutation(len(ids))
    return ids[perm], values[perm]


def band_batch(rng, n, m_rows):
    """A batch of the band workload: n samples of uniformly drawn rows,
    each in its row's 4-bucket band."""
    base = rng.integers(0, 400, m_rows)
    ids = rng.integers(0, m_rows, n).astype(np.int32)
    buckets = base[ids] + rng.integers(0, BUCKETS_PER_ROW, n)
    return ids, np.expm1(buckets / 100.0).astype(np.float32)


def touched_cells(ids, cols, m):
    keep = (ids >= 0) & (ids < m)
    return len(np.unique(ids[keep].astype(np.int64) * B + cols[keep]))


# -- phases ----------------------------------------------------------------


def phase_card(torch):
    from loghisto_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
        f"nvidia-smi failed: {smi.stderr.strip()}")
    print(card, flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    # the native host tier (g++, host code): built here so its build time
    # is reported; native_host_main_path fails if it did not build
    from loghisto_tpu_torch import _native

    t0 = time.perf_counter()
    native = {"ingest": _native.available(),
              "fastpath": _native.fastpath_available()}
    native["build_s"] = round(time.perf_counter() - t0, 3)
    native["errors"] = [e for e in (_native.build_error(),
                                    _native.fastpath_error()) if e]
    ptxas = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln]
        for name, log in _build.BUILD_LOGS.items()
    }
    RESULTS["card"] = card
    return {"card": card, "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(0),
            "build_s": round(build_s, 3), "built": built, "ptxas": ptxas,
            "native_host_tier": native}


def phase_codec(torch):
    from loghisto_tpu_torch.ops.codec import compress, compress_np, edge_values
    from loghisto_tpu_torch.ops.fused_ingest import fused_ingest_batch
    from loghisto_tpu_torch.ops.row_ingest import codec_check, histogram_row

    dev = torch.device("cuda")
    edges = edge_values(BL)
    want = np.clip(compress_np(edges), -BL, BL).astype(np.int64) + BL
    m = len(edges)
    acc = torch.zeros((m, B), dtype=torch.int32, device=dev)
    fused_ingest_batch(
        acc, torch.arange(m, dtype=torch.int32, device=dev),
        torch.from_numpy(edges).to(dev), BL,
    )
    torch.cuda.synchronize()
    one_each = bool((acc.sum(dim=1) == 1).all())
    got = acc.argmax(dim=1).cpu().numpy()
    k1_edge_mismatch = int((got != want).sum()) + (0 if one_each else m)
    del acc
    plain_edge_mismatch = int((
        compress(torch.from_numpy(edges).to(dev)).cpu().numpy()
        != compress_np(edges)).sum())

    rng = np.random.default_rng(SEED)
    n = 1 << 21
    mag = 10.0 ** rng.uniform(-4, 14, n)
    values = (mag * np.where(rng.random(n) < 0.5, -1, 1)).astype(np.float32)
    row = torch.zeros(B, dtype=torch.int32, device=dev)
    histogram_row(row, torch.from_numpy(values).to(dev), BL)
    cols = np.clip(compress_np(values), -BL, BL).astype(np.int64) + BL
    k2_random_mismatch = int(
        np.abs(row.cpu().numpy() - np.bincount(cols, minlength=B)).sum())
    # K2's table codec against the float64 codec on every float32 pattern
    t0 = time.perf_counter()
    table_mismatch = table_reads = 0
    for start in range(0, 1 << 32, 1 << 30):
        bad, reads = codec_check(start, 1 << 30, BL)
        table_mismatch += bad
        table_reads += reads
    out = {
        "edge_values": m, "k1_edge_mismatch": k1_edge_mismatch,
        "plain_edge_mismatch": plain_edge_mismatch,
        "random_values": n, "k2_random_mismatch": k2_random_mismatch,
        "table_codec_patterns": 1 << 32,
        "table_codec_mismatch": table_mismatch,
        "table_codec_table_reads": table_reads,
        "table_codec_check_s": time.perf_counter() - t0,
    }
    if (k1_edge_mismatch or plain_edge_mismatch or k2_random_mismatch
            or table_mismatch):
        raise AssertionError(f"codec mismatches on the card: {out}")
    return out


ANALYSIS_TIMEOUT_S = 180
# the registry's float outputs on the card against the CPU's: the
# float32 row sums (a matvec whose order the device picks) within the
# rtol every sums comparison of this script uses, K7's scores within
# K7_TOL at the registry's 129 buckets; every integer output bit-equal
REGISTRY_SUMS_TOL = (1e-5, 1e-3)
REGISTRY_K7_TOL = {"ks": (0.0, 2e-6), "jsd": (0.0, 1e-5),
                   "emd": (1e-4, 129 * 2.0**-23)}


def _registry_outputs_match(torch, name, got, want):
    """Largest float difference of a registry entry's card outputs
    against its CPU outputs; raises on any integer difference or a float
    one past its tolerance."""
    from loghisto_tpu_torch.analysis.program_audit import tensor_leaves

    got_l, want_l = list(tensor_leaves(got)), list(tensor_leaves(want))
    if len(got_l) != len(want_l):
        raise AssertionError(f"{name}: {len(got_l)} card outputs against "
                             f"{len(want_l)} on the CPU")
    keys = list(want.keys()) if isinstance(want, dict) else [None] * len(
        want_l)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        g = g.detach().cpu()
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name} output {i}: {g.dtype} "
                                 f"{tuple(g.shape)} against {w.dtype} "
                                 f"{tuple(w.shape)}")
        if torch.equal(g, w):
            continue
        if not g.dtype.is_floating_point:
            raise AssertionError(f"{name} output {i} differs on the card")
        key = keys[i] if i < len(keys) else None
        rtol, atol = REGISTRY_K7_TOL.get(key, REGISTRY_SUMS_TOL)
        err = (g.double() - w.double()).abs()
        worst = max(worst, float(err.max()))
        if not bool((err <= atol + rtol * w.double().abs()).all()):
            raise AssertionError(f"{name} output {i} ({key}): max error "
                                 f"{float(err.max())}")
    return worst


def _registry_on_card(torch):
    """Every one-device entry of the program registry
    (``analysis/program_audit.PROGRAMS``) built on the card: its contract
    held by the recorder there, the ``kernel_launches()`` delta equal to
    the ``wrapper_entries()`` delta and to the contract's ``launches``,
    a warm second call under ``torch.cuda.set_sync_debug_mode("error")``
    raising nothing, and both calls' outputs equal to the CPU's."""
    from loghisto_tpu_torch.analysis import program_audit as pa
    from loghisto_tpu_torch.ops.backend import (kernel_launches,
                                                wrapper_entries)

    def delta(before, after):
        return {k: after[k] - before[k] for k in after if after[k] != before[k]}

    rows, failures = [], []
    for spec in pa.PROGRAMS:
        if spec.mesh:
            continue
        t0 = time.perf_counter()
        _, want, _ = pa.run_spec(spec, "cpu")
        k0, e0 = kernel_launches(), wrapper_entries()
        findings, cold, _ = pa.run_spec(spec, "cuda")
        torch.cuda.synchronize()
        launched = delta(k0, kernel_launches())
        entered = delta(e0, wrapper_entries())
        step, args = spec.build("cuda")
        torch.cuda.synchronize()
        sync_error = None
        torch.cuda.set_sync_debug_mode("error")
        try:
            warm = step(*args)
        except RuntimeError as e:
            sync_error, warm = repr(e)[:400], None
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        row = {"analysis_entry": spec.name, "launches": launched,
               "wrapper_entries": entered,
               "contract": dict(spec.contract.launches),
               "findings": [f.render() for f in findings],
               "sync_error": sync_error}
        try:
            row["max_float_err"] = max(
                _registry_outputs_match(torch, spec.name, cold, want),
                0.0 if warm is None else _registry_outputs_match(
                    torch, spec.name, warm, want))
        except AssertionError as e:
            row["mismatch"] = str(e)
        row["s"] = round(time.perf_counter() - t0, 3)
        emit(row)
        if (findings or sync_error or "mismatch" in row
                or launched != entered or entered != {
                    k: v for k, v in spec.contract.launches.items() if v}):
            failures.append(spec.name)
        rows.append(row)
    if failures:
        raise AssertionError(f"registry entries failed on the card: "
                             f"{failures}")
    return {"entries": len(rows),
            "launches": {r["analysis_entry"]: r["launches"] for r in rows}}


def phase_analysis(torch):
    """The port's static analyzer, ``python -m loghisto_tpu_torch.analysis``
    (the import lint, its lazy surfaces resolved under this host's CUDA
    build of PyTorch and Triton, the lock lint, and the program registry
    on the CPU with its mesh entries on four gloo ranks), in a
    subprocess: it must exit 0, with no finding past the reviewed
    baseline; meanwhile every one-device registry entry on the card
    (``_registry_on_card``)."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "loghisto_tpu_torch.analysis"], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        t1 = time.perf_counter()
        registry = _registry_on_card(torch)
        registry_s = time.perf_counter() - t1
        stdout, stderr = proc.communicate(timeout=ANALYSIS_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - t0
    summary = [ln for ln in stderr.splitlines()
               if ln.startswith("analysis: ")]
    words = summary[-1].split() if summary else []
    out = {
        "exit_code": proc.returncode,
        "findings": int(words[1]) if len(words) > 3 else None,
        "suppressed": int(words[3]) if len(words) > 3 else None,
        "passes": words[-1] if words else None,
        "analysis_s": seconds,
        "registry": registry,
        "registry_s": registry_s,
    }
    if proc.returncode != 0 or out["findings"] != 0:
        raise AssertionError(
            f"the analyzer failed: {out} {stdout[-3000:]} {stderr[-3000:]}")
    return out


def _adversarial_block(rng, m):
    f32 = np.finfo(np.float32)
    values = np.array(
        [f32.smallest_subnormal, -f32.smallest_subnormal, f32.tiny, 0.0,
         -0.0, np.inf, -np.inf, np.nan, 3.4e38, -3.4e38, f32.max, -f32.max],
        dtype=np.float32)
    ids = rng.integers(0, m, len(values)).astype(np.int32)
    bad_ids = np.array([-1, m, 2**30, -(2**31)], dtype=np.int32)
    return (np.concatenate([ids, bad_ids]),
            np.concatenate([values, rng.lognormal(1, 1, 4).astype(np.float32)]))


def phase_k1(torch):
    from loghisto_tpu_torch.ops.backend import kernel_launches
    from loghisto_tpu_torch.ops.codec import compress_np
    from loghisto_tpu_torch.ops.fused_ingest import (
        device_plan,
        fused_ingest_batch,
    )
    from loghisto_tpu_torch.ops.ingest import ingest_batch

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    batches = {
        "zipf": (zipf_ids(rng, BATCH, M), lognormal_values(rng, BATCH)),
        "uniform": (rng.integers(0, M, BATCH).astype(np.int32),
                    lognormal_values(rng, BATCH)),
    }
    adv_ids, adv_vals = _adversarial_block(rng, M)
    ids, vals = batches["uniform"]
    ids, vals = ids.copy(), vals.copy()
    ids[:len(adv_ids)], vals[:len(adv_vals)] = adv_ids, adv_vals
    batches["adversarial"] = (ids, vals)
    # the firehose's batch size, and every sample on one cell
    batches["zipf_2^22"] = (zipf_ids(rng, FH_BATCH, M),
                            lognormal_values(rng, FH_BATCH))
    batches["one_cell"] = (np.full(BATCH, 7, np.int32),
                           np.full(BATCH, 58.7, np.float32))

    acc_k = torch.zeros((M, B), dtype=torch.int32, device=dev)
    acc_p = torch.zeros_like(acc_k)
    before = kernel_launches()["fused_ingest"]
    per_batch = {}
    for name, (ids, vals) in batches.items():
        ids_d = torch.from_numpy(ids).to(dev)
        vals_d = torch.from_numpy(vals).to(dev)
        fused_ingest_batch(acc_k, ids_d, vals_d, BL)
        ingest_batch(acc_p, ids_d, vals_d, BL)
        torch.cuda.synchronize()
        per_batch[name] = bool(torch.equal(acc_k, acc_p))
    max_err = int((acc_k - acc_p).abs().max())
    if not all(per_batch.values()):
        raise AssertionError(f"K1 differs from its plain version: {per_batch}")
    # the one call: +1 per valid sample, codec included
    valid = sum(int(((i >= 0) & (i < M)).sum()) for i, _ in batches.values())
    assert int(acc_k.sum()) == valid

    timings = {}
    for name in ("zipf", "uniform", "zipf_2^22", "one_cell"):
        ids, vals = batches[name]
        n = len(ids)
        ids_d = torch.from_numpy(ids).to(dev)
        vals_d = torch.from_numpy(vals).to(dev)
        cols = np.clip(compress_np(vals), -BL, BL).astype(np.int64) + BL
        cols_d = torch.from_numpy(cols).to(dev)
        ones = torch.ones(n, dtype=torch.int32, device=dev)
        ids_l = ids_d.long()
        acc = torch.zeros((M, B), dtype=torch.int32, device=dev)
        k_ms = time_ms(torch, lambda: fused_ingest_batch(acc, ids_d, vals_d, BL))
        p_ms = lib_ms = None  # one cell: the plain scatter serialises (~95 ms)
        if name != "one_cell":
            p_ms = time_ms(torch, lambda: ingest_batch(acc, ids_d, vals_d, BL))
            lib_ms = time_ms(torch, lambda: acc.index_put_(
                (ids_l, cols_d), ones, accumulate=True))
        cells = touched_cells(ids, cols, M)
        b_ms, b_by = bound_ms(n * 8 + cells * 8, n * CODEC_OPS)
        timings[name] = {"samples": n, "ms": k_ms, "plain_ms": p_ms,
                         "library_ms": lib_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "touched_cells": cells,
                         "plan": device_plan(
                             n, M, B, torch.cuda.current_device())._asdict()}
        del acc
    compare_launches = kernel_launches()["fused_ingest"] - before
    RESULTS["fused_ingest"] = {"max_abs_err": max_err, **timings["zipf"]}
    return {"M": M, "B": B, "batch": BATCH, "equal": per_batch,
            "max_abs_err": max_err, "timings": timings,
            "compare_launches": compare_launches,
            "library_call": "acc.index_put_((ids, cols), 1, accumulate=True)"
                            " on precomputed bucket columns (no codec)"}


def phase_k2(torch):
    from loghisto_tpu_torch.ops.codec import compress_np
    from loghisto_tpu_torch.ops.row_ingest import (
        device_blocks,
        histogram_row,
        histogram_row_reference,
        row_ingest_batch,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    n = 1 << 22
    vals = lognormal_values(rng, n)
    ids = np.where(rng.random(n) < 0.1, rng.integers(-1, 3, n), 0)
    ids = ids.astype(np.int32)
    ids_d = torch.from_numpy(ids).to(dev)
    vals_d = torch.from_numpy(vals).to(dev)
    # K2a: unpadded, no mask
    row_k = torch.zeros(B, dtype=torch.int32, device=dev)
    row_p = torch.zeros_like(row_k)
    histogram_row(row_k, vals_d, BL)
    histogram_row_reference(row_p, vals_d, BL, 100)
    torch.cuda.synchronize()
    eq_a = bool(torch.equal(row_k, row_p))
    # K2b: ragged N (the reference pads it), masked ids
    ragged = n - 777
    acc_k = torch.zeros((1, B), dtype=torch.int32, device=dev)
    acc_p = torch.zeros_like(acc_k)
    row_ingest_batch(acc_k, ids_d[:ragged], vals_d[:ragged], BL)
    histogram_row_reference(acc_p[0], vals_d[:ragged], BL, 100, ids_d[:ragged])
    torch.cuda.synchronize()
    eq_b = bool(torch.equal(acc_k, acc_p))
    max_err = max(int((row_k - row_p).abs().max()),
                  int((acc_k - acc_p).abs().max()))
    want = np.bincount(
        np.clip(compress_np(vals[:ragged][ids[:ragged] == 0]), -BL, BL)
        .astype(np.int64) + BL, minlength=B)
    eq_host = bool((acc_k[0].cpu().numpy() == want).all())
    if not (eq_a and eq_b and eq_host):
        raise AssertionError(
            f"K2 differs: unmasked {eq_a}, masked {eq_b}, host {eq_host}")

    cols = np.clip(compress_np(vals), -BL, BL).astype(np.int64) + BL
    cols_masked = torch.from_numpy(cols[ids == 0]).to(dev)
    acc = torch.zeros((1, B), dtype=torch.int32, device=dev)
    k_ms = time_ms(torch, lambda: row_ingest_batch(acc, ids_d, vals_d, BL))
    k_cold = time_cold_ms(torch, lambda: row_ingest_batch(acc, ids_d, vals_d,
                                                          BL))
    p_ms = time_ms(torch, lambda: histogram_row_reference(
        acc[0], vals_d, BL, 100, ids_d))
    lib_ms = time_ms(torch, lambda: torch.bincount(cols_masked, minlength=B))
    b_ms, b_by = bound_ms(n * 8 + B * 8, n * CODEC_OPS)
    RESULTS["row_ingest"] = {"max_abs_err": max_err, "ms": k_ms,
                             "plain_ms": p_ms, "library_ms": lib_ms,
                             "bound_ms": b_ms, "bound_by": b_by}
    # K2a, the unmasked entry point (pallas_kernels.py:46), same shape
    cols_all = torch.from_numpy(cols).to(dev)
    row = torch.zeros(B, dtype=torch.int32, device=dev)
    a_ms = time_ms(torch, lambda: histogram_row(row, vals_d, BL))
    a_cold = time_cold_ms(torch, lambda: histogram_row(row, vals_d, BL))
    a_plain = time_ms(torch, lambda: histogram_row_reference(
        row, vals_d, BL, 100))
    a_lib = time_ms(torch, lambda: torch.bincount(cols_all, minlength=B))
    a_bound, a_by = bound_ms(n * 4 + B * 8, n * CODEC_OPS)
    k2a = {"ms": a_ms, "time_cold_ms": a_cold, "plain_ms": a_plain,
           "library_ms": a_lib,
           "bound_ms": a_bound, "bound_by": a_by,
           "library_call": "torch.bincount on precomputed bucket columns "
                           "(no codec)"}
    return {"N": n, "ragged_N": ragged, "equal_unmasked": eq_a,
            "equal_masked": eq_b, "equal_host": eq_host,
            "max_abs_err": max_err, **RESULTS["row_ingest"],
            "time_cold_ms": k_cold, "blocks": device_blocks(n, B),
            "cluster": 8, "table_codec": True,
            "library_call": "torch.bincount on precomputed bucket columns "
                            "of the id-0 samples (no codec)",
            "k2a_unmasked": k2a}


def _commit_chunk_cells(rng):
    """One interval's cells of ``lifecycle_drift_main_path``'s churn
    workload (512 steady and 96 fresh names, 2^20 lognormal samples,
    per-name mu ~ U[2, 6), sigma ~ U[0.3, 1)) as folded (id, codec
    bucket, count) triples over ids 0..607."""
    from loghisto_tpu_torch.ops.fold import fold_packed_numpy

    n_names = LD_STEADY + LD_FRESH
    mu = rng.uniform(2.0, 6.0, n_names)
    sigma = rng.uniform(0.3, 1.0, n_names)
    ids = rng.integers(0, n_names, RET_SAMPLES)
    return fold_packed_numpy(ids, rng.lognormal(mu[ids], sigma[ids]), BL)


def _k3_multi(torch, rng):
    """K3 at the fused commit's shape: one interval's cells into acc, 3
    tier slots and ihist (1024 x 8193 each) in one launch, against five
    one-target launches and the plain version; EQUAL to the plain
    version target by target."""
    from loghisto_tpu_torch.ops.backend import kernel_launches
    from loghisto_tpu_torch.ops.sparse_ingest import (
        sparse_ingest,
        sparse_ingest_multi,
        sparse_ingest_multi_batch,
    )

    dev = torch.device("cuda")
    packed = _commit_chunk_cells(rng)
    packed_d = torch.from_numpy(packed).to(dev)
    acc = torch.zeros((RET_M, B), dtype=torch.int32, device=dev)
    rings = torch.zeros((3, 2, RET_M, B), dtype=torch.int32, device=dev)
    ihist = torch.zeros_like(acc)
    targets = [acc, rings[0, 1], rings[1, 1], rings[2, 1], ihist]
    plain = [torch.zeros_like(acc) for _ in targets]
    before = kernel_launches()["sparse_ingest"]
    sparse_ingest_multi(targets, packed_d, BL)
    launches = kernel_launches()["sparse_ingest"] - before
    sparse_ingest_multi_batch(plain, packed_d, BL)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(targets, plain))
    if not equal or launches != 1 or int(rings[:, 0].abs().sum()):
        raise AssertionError(f"multi-target K3: equal={equal}, "
                             f"{launches} launches")

    def five():
        for t in targets:
            sparse_ingest(t, packed_d, BL)

    keep = (packed[:, 0] >= 0) & (packed[:, 0] < RET_M) & (packed[:, 2] != 0)
    b_ms, b_by = bound_ms(len(packed) * 12 + len(targets) * int(keep.sum()) * 8)
    out = {"triples": len(packed), "targets": len(targets),
           "equal": equal, "launches": launches,
           "ms": time_ms(torch, lambda: sparse_ingest_multi(
               targets, packed_d, BL)),
           "five_launches_ms": time_ms(torch, five),
           "cold_ms": time_cold_ms(torch, lambda: sparse_ingest_multi(
               targets, packed_d, BL)),
           "paced_ms": time_ms(torch, lambda: sparse_ingest_multi(
               targets, packed_d, BL), hold=False),
           "plain_ms": time_ms(torch, lambda: sparse_ingest_multi_batch(
               targets, packed_d, BL)),
           "bound_ms": b_ms, "bound_by": b_by}
    del acc, rings, ihist, targets, plain
    return out


def phase_k3(torch):
    from loghisto_tpu_torch.ops.fold import fold_packed_numpy
    from loghisto_tpu_torch.ops.sparse_ingest import (
        sparse_ingest,
        sparse_ingest_batch,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 3)
    n = 1 << 22
    packed = fold_packed_numpy(zipf_ids(rng, n, M), lognormal_values(rng, n),
                               BL)
    pad = np.zeros((1000, 3), dtype=np.int32)
    pad[:, 0] = -1
    pad[:10, 2] = 7
    extra = np.array([[0, 5 * BL, 3], [1, -5 * BL, 4], [M, 0, 5]], np.int32)
    packed = np.ascontiguousarray(np.concatenate([packed, extra, pad]))
    packed_d = torch.from_numpy(packed).to(dev)
    acc_k = torch.zeros((M, B), dtype=torch.int32, device=dev)
    acc_p = torch.zeros_like(acc_k)
    sparse_ingest(acc_k, packed_d, BL)
    sparse_ingest_batch(acc_p, packed_d, BL)
    torch.cuda.synchronize()
    equal = bool(torch.equal(acc_k, acc_p))
    max_err = int((acc_k - acc_p).abs().max())
    total_ok = int(acc_k.sum()) == n + 7
    # the same triples from a view 12 bytes off a 16-byte boundary
    acc_k.zero_()
    acc_p.zero_()
    sparse_ingest(acc_k, packed_d[1:], BL)
    sparse_ingest_batch(acc_p, packed_d[1:], BL)
    torch.cuda.synchronize()
    equal_view = bool(torch.equal(acc_k, acc_p))
    keep = (packed[:, 0] >= 0) & (packed[:, 0] < M)
    if not (equal and equal_view and total_ok) or int(acc_k.sum()) != int(
            packed[1:, 2][keep[1:]].sum()):
        raise AssertionError(f"K3 differs: equal={equal}, view={equal_view}")
    ids_l = torch.from_numpy(packed[keep, 0].astype(np.int64)).to(dev)
    cols_l = torch.from_numpy(
        np.clip(packed[keep, 1], -BL, BL).astype(np.int64) + BL).to(dev)
    w = torch.from_numpy(packed[keep, 2]).to(dev)
    acc = torch.zeros((M, B), dtype=torch.int32, device=dev)
    k_ms = time_ms(torch, lambda: sparse_ingest(acc, packed_d, BL))
    cold_ms = time_cold_ms(torch, lambda: sparse_ingest(acc, packed_d, BL))
    paced_ms = time_ms(torch, lambda: sparse_ingest(acc, packed_d, BL),
                       hold=False)
    p_ms = time_ms(torch, lambda: sparse_ingest_batch(acc, packed_d, BL))
    lib_ms = time_ms(torch, lambda: acc.index_put_(
        (ids_l, cols_l), w, accumulate=True))
    rows = len(packed)
    b_ms, b_by = bound_ms(rows * 12 + int(keep.sum()) * 8)
    RESULTS["sparse_ingest"] = {"max_abs_err": max_err, "ms": k_ms,
                                "plain_ms": p_ms, "library_ms": lib_ms,
                                "bound_ms": b_ms, "bound_by": b_by}
    del acc, acc_k, acc_p
    multi = _k3_multi(torch, rng)
    return {"samples": n, "triples": rows, "equal": equal,
            "equal_from_view_1": equal_view,
            "max_abs_err": max_err, **RESULTS["sparse_ingest"],
            "cold_ms": cold_ms, "paced_ms": paced_ms,
            "library_call": "acc.index_put_((ids, cols), counts, "
                            "accumulate=True) on pre-clipped columns",
            "multi_target": multi}


def _drive(torch, num_metrics, transport, interval_samples, kernel):
    """One main-path run: 3 intervals through record_batch + collect(),
    each checked against a host compress_np / dense_stats_np oracle."""
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )
    from loghisto_tpu_torch.ops.codec import compress_np
    from loghisto_tpu_torch.ops.stats import dense_stats_np
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    rng = np.random.default_rng(SEED + 10 + num_metrics)
    labels = ["min", "50", "75", "90", "95", "99", "99.9", "99.99", "max"]
    agg = TorchAggregator(num_metrics=num_metrics, batch_size=BATCH,
                          transport=transport)
    names = [f"m{i}" for i in range(num_metrics)]
    for name in names:
        agg.registry.id_for(name)
    lifetime_count = np.zeros(num_metrics, np.int64)
    lifetime_sum = np.zeros(num_metrics, np.float64)
    ingest_s, collect_ms, checked = [], [], 0
    reset_kernel_launches()
    try:
        for _ in range(3):
            if num_metrics == 1:
                ids = np.zeros(interval_samples, np.int32)
                ids[rng.random(interval_samples) < 0.01] = -1
            else:
                ids = zipf_ids(rng, interval_samples, num_metrics)
            values = lognormal_values(rng, interval_samples)
            values[rng.random(interval_samples) < 0.05] *= -1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for off in range(0, interval_samples, BATCH):
                agg.record_batch(ids[off:off + BATCH],
                                 values[off:off + BATCH])
            agg.flush(force=True)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            metrics = agg.collect().metrics
            t2 = time.perf_counter()
            ingest_s.append(t1 - t0)
            collect_ms.append((t2 - t1) * 1e3)

            keep = ids >= 0
            cols = np.clip(compress_np(values[keep]), -BL, BL).astype(
                np.int64) + BL
            oracle = np.bincount(
                ids[keep].astype(np.int64) * B + cols,
                minlength=num_metrics * B).reshape(num_metrics, B)
            want = dense_stats_np(oracle, PS, BL)
            lifetime_count += want["counts"]
            for i, name in enumerate(names):
                count = int(want["counts"][i])
                if count == 0:
                    assert f"{name}_count" not in metrics, name
                    continue
                assert metrics[f"{name}_count"] == count, name
                for label, value in zip(labels, want["percentiles"][i]):
                    got = metrics[f"{name}_{label}"]
                    assert got == float(np.float32(value)), (name, label)
                s = metrics[f"{name}_sum"]
                assert abs(s - want["sums"][i]) <= 1e-5 * abs(want["sums"][i]) + 1e-3
                lifetime_sum[i] += s
                checked += 1
            for i, name in enumerate(names):
                if lifetime_count[i] == 0:
                    continue
                assert metrics[f"{name}_agg_count"] == lifetime_count[i]
                assert abs(metrics[f"{name}_agg_sum"] - lifetime_sum[i]) <= (
                    1e-9 * abs(lifetime_sum[i]) + 1e-6)
                avg = lifetime_sum[i] / lifetime_count[i]
                assert abs(metrics[f"{name}_agg_avg"] - avg) <= 1e-9 * abs(avg)
    finally:
        agg.close()
    launches = kernel_launches()
    if kernel is None:  # "auto": the kernel of the transport it chose
        kernel = TRANSPORT_KERNEL[agg.transport]
    if launches[kernel] <= 0:
        raise AssertionError(f"{kernel} was not launched on the main path")
    total = 3 * interval_samples
    return {
        "num_metrics": num_metrics, "transport": agg.transport,
        "probe_density": agg.probe_density,
        "ingest_path": agg.ingest_path, "samples": total,
        "samples_per_s": total / sum(ingest_s),
        "ingest_s": ingest_s, "collect_ms": collect_ms,
        "rows_checked": checked, "launches": launches,
    }


TRANSPORT_KERNEL = {"raw": "fused_ingest", "sparse": "sparse_ingest"}


def phase_main(torch):
    """The dense main path at the headline shape: raw (K1), sparse (K3),
    the default transport="auto" (its probe and the card's crossover
    decide; the kernel of the transport it chose must run) and the
    single row (K2b)."""
    from loghisto_tpu_torch.ops import dispatch

    runs = {
        "raw": _drive(torch, M, "raw", 1 << 24, "fused_ingest"),
        "sparse": _drive(torch, M, "sparse", 1 << 24, "sparse_ingest"),
        "auto": _drive(torch, M, "auto", 1 << 24, None),
        "single": _drive(torch, 1, "raw", 1 << 22, "row_ingest"),
    }
    auto = runs["auto"]
    # with the card's crossover at 0.0 no density can switch it, so the
    # aggregator skips the host probe (probe_density stays None)
    want = dispatch.choose_transport("cuda", auto["probe_density"])
    if auto["transport"] != want:
        raise AssertionError(
            f"'auto' at density {auto['probe_density']} took "
            f"{auto['transport']}; the card's crossover "
            f"{dispatch.sparse_density_crossover('cuda')} picks {want}")
    if want == "raw" and auto["launches"]["sparse_ingest"]:
        raise AssertionError("'auto' stayed raw but launched K3")
    assert runs["single"]["ingest_path"] == "row"
    for kernel, run in (("fused_ingest", "raw"), ("sparse_ingest", "sparse"),
                        ("row_ingest", "single")):
        RESULTS.setdefault(kernel, {})["launches"] = runs[run]["launches"][
            kernel]
    return runs


# transport crossover: the headline generator (Zipf(1.3) ids over M,
# lognormal(4, 2) values) narrowed in id range or value spread, or with a
# flatter Zipf, for cell densities (unique cells / samples of a 2^20-sample
# item, the probe's measure) of about 0.02, 0.05, 0.19, 0.26 and 0.5
XO_STREAMS = (("ids_over_20", {"m_ids": 20}), ("ids_over_60", {"m_ids": 60}),
              ("sigma_0.5", {"sigma": 0.5}), ("headline", {}),
              ("zipf_1.15", {"a": 1.15}))
XO_SAMPLES = 1 << 24
# FUSED_MIN_BATCH sweep: K4f vs the sparse route on paged storage at
# 2^20 rows, per batch size, on the band workload
FMB_BATCHES = tuple(1 << k for k in range(12, 21, 2))
FMB_SAMPLES = 1 << 21


def _xo_stream(rng, n, m_ids=M, sigma=2.0, a=1.3):
    ids = ((rng.zipf(a, n) - 1) % m_ids).astype(np.int32)
    return ids, rng.lognormal(4.0, sigma, n).astype(np.float32)


def _cell_density(ids, values):
    """The transport probe's measure: unique (id, bucket) / samples."""
    from loghisto_tpu_torch.ops.codec import compress_np

    keys = (ids.astype(np.int64) << 16) | (
        compress_np(values).astype(np.int64) + 32768)
    return len(np.unique(keys)) / len(ids)


def _timed_ingest(torch, agg, ids, values, item):
    """Host wall clock of record_batch in ``item``-sample pieces through
    flush(force=True) and a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for off in range(0, len(ids), item):
        agg.record_batch(ids[off:off + item], values[off:off + item])
    agg.flush(force=True)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


@contextlib.contextmanager
def native_tiers_only():
    """Fail any route that takes the NumPy fold tier while this holds:
    the native host tier must have built and must serve the sparse fold
    (ops/fold.fold_packed falls back to ``fold_packed_numpy`` only when it
    cannot)."""
    from loghisto_tpu_torch import _native
    from loghisto_tpu_torch.ops import fold

    if not _native.available():
        raise AssertionError(
            f"the native host tier did not build: {_native.build_error()}")

    def refuse(*args, **kwargs):
        raise AssertionError("a route took the NumPy fold tier")

    numpy_fold = fold.fold_packed_numpy
    fold.fold_packed_numpy = refuse
    try:
        yield numpy_fold
    finally:
        fold.fold_packed_numpy = numpy_fold


def _xo_dense(torch, ids, values):
    """Raw (staging + K1) and sparse (native fold + K3) through
    TorchAggregator at M = 10,000 on the same stream, fed twice: the
    second pass is timed, and the two accumulators must be equal."""
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    out, accs = {}, {}
    for transport in ("raw", "sparse"):
        agg = TorchAggregator(num_metrics=M, batch_size=BATCH,
                              transport=transport)
        try:
            _timed_ingest(torch, agg, ids, values, BATCH)
            dt = _timed_ingest(torch, agg, ids, values, BATCH)
            accs[transport] = agg._acc.clone()
        finally:
            agg.close()
        out[transport] = len(ids) / dt
    if not torch.equal(accs["raw"], accs["sparse"]):
        raise AssertionError("raw and sparse accumulators differ")
    if int(accs["raw"].sum(dtype=torch.int64)) != 2 * len(ids):
        raise AssertionError("the accumulator lost samples")
    return out


def _fmb_paged(torch, batch, ids, values):
    """K4f (transport="raw", ingest_path="fused") against the sparse
    route (fold + translate + K4) on paged storage at 2^20 rows, with
    aggregator batches and record_batch items of ``batch`` samples; the
    stream is fed twice and the second pass timed.  Both stores must
    hold every sample and answer a 1024-row query alike."""
    from loghisto_tpu_torch.paging import PagedStoreConfig
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    out, answers = {}, {}
    q_ids = np.random.default_rng(SEED + 41).choice(PAGED_M, 1024,
                                                    replace=False)
    for route, kw in (("k4f", {"transport": "raw", "ingest_path": "fused"}),
                      ("sparse", {"transport": "sparse"})):
        agg = TorchAggregator(
            num_metrics=PAGED_M, batch_size=batch, storage="paged",
            paged_config=PagedStoreConfig(pool_pages=PAGED_POOL), **kw)
        # the rate is read with every sample kept: past max_pending_samples
        # (32 batches) the aggregator sheds its oldest samples, as the
        # reference does, and small batches reach it while the worker
        # prepares K4f's pages on the host
        agg.max_pending_samples = 2 * len(ids)
        try:
            if agg.fused_paged != (route == "k4f"):
                raise AssertionError(f"{route} at batch {batch}: fused_paged "
                                     f"is {agg.fused_paged}")
            _timed_ingest(torch, agg, ids, values, batch)
            dt = _timed_ingest(torch, agg, ids, values, batch)
            total = int(agg.paged._pool.sum(dtype=torch.int64))
            answers[route] = agg.paged.query(q_ids, PS)
        finally:
            agg.close()
            del agg
            torch.cuda.empty_cache()
        if total != 2 * len(ids):
            raise AssertionError(f"{route} at batch {batch}: pool holds "
                                 f"{total} of {2 * len(ids)} samples")
        out[route] = len(ids) / dt
    for key in ("counts", "percentiles"):
        if not np.array_equal(answers["k4f"][key], answers["sparse"][key]):
            raise AssertionError(f"batch {batch}: the routes' {key} differ")
    return out


def xo_points(torch, rng):
    """The dense raw and sparse transports (the sparse fold held to the
    native tier) through TorchAggregator on the five crossover streams;
    returns the points and the crossover they imply: the highest density
    at which sparse beats raw, 0.0 if it wins nowhere."""
    points = []
    with native_tiers_only():
        for name, kw in XO_STREAMS:
            ids, values = _xo_stream(rng, XO_SAMPLES, **kw)
            density = _cell_density(ids[:BATCH], values[:BATCH])
            rates = _xo_dense(torch, ids, values)
            points.append({"stream": name, "density": density,
                           "raw_samples_per_s": rates["raw"],
                           "sparse_samples_per_s": rates["sparse"]})
    wins = [p["density"] for p in points
            if p["sparse_samples_per_s"] > p["raw_samples_per_s"]]
    return points, (max(wins) if wins else 0.0)


def phase_transport_crossover(torch):
    """F4's measurement: the dense raw and sparse (native fold + K3)
    transports through TorchAggregator on the same streams at five cell
    densities (2^24 samples each, M = 10,000); the card's crossover is
    the highest density at which sparse beats raw (0.0 if it wins
    nowhere) and must be the one ops/dispatch.py states.  Then the
    FUSED_MIN_BATCH sweep: K4f against the sparse route on paged storage
    (2^20 rows) at batch sizes 2^12 ... 2^20."""
    from loghisto_tpu_torch.ops import dispatch

    rng = np.random.default_rng(SEED + 40)
    points, measured = xo_points(torch, rng)
    RESULTS["xo"] = {"points": points, "measured_crossover": measured}
    stated = dispatch.sparse_density_crossover("cuda")
    if (measured > 0.0) != (stated > 0.0) or measured > stated:
        raise AssertionError(f"measured crossover {measured} on the card; "
                             f"ops/dispatch.py states {stated}; points "
                             f"{json.dumps(points)}")

    sweep = []
    for batch in FMB_BATCHES:
        ids, values = band_batch(rng, FMB_SAMPLES, PAGED_M)
        rates = _fmb_paged(torch, batch, ids, values)
        sweep.append({"batch": batch,
                      "k4f_samples_per_s": rates["k4f"],
                      "sparse_samples_per_s": rates["sparse"]})
    k4f_from = next((p["batch"] for i, p in enumerate(sweep)
                     if all(q["k4f_samples_per_s"] > q["sparse_samples_per_s"]
                            for q in sweep[i:])), None)
    return {"samples": XO_SAMPLES, "fold_tier": "native", "points": points,
            "measured_crossover": measured, "stated_crossover": stated,
            "fused_min_batch_sweep": {
                "samples": FMB_SAMPLES, "rows": PAGED_M, "points": sweep,
                "k4f_wins_from_batch": k4f_from,
                "stated": dispatch.fused_min_batch_for("cuda")}}


# the native host tier at the main path's width: M = 10,000 rows x 8193
# buckets, 2^24 Zipf(1.3) samples per interval, 3 intervals; the single
# row at 2^22 samples; fast ingest over 1,000 names from 8 threads
NH_SAMPLES = 1 << 24
NH_INTERVALS = 3
NH_ROW_SAMPLES = 1 << 22
NH_WRITERS = 4
FI_NAMES = 1000
FI_THREADS = 8
FI_INTERVALS = 2
FI_RECORDS = 40_000  # per thread per interval, spread over 3 handle kinds
FI_LABELS = ["min", "50", "75", "90", "95", "99", "99.9", "99.99", "max"]


def _nh_stream(rng, n, m):
    """One interval: Zipf(1.3) ids over m rows (1% dropped ids when m is
    1), lognormal values with 5% negated."""
    if m == 1:
        ids = np.zeros(n, np.int32)
        ids[rng.random(n) < 0.01] = -1
    else:
        ids = zipf_ids(rng, n, m)
    values = lognormal_values(rng, n)
    values[rng.random(n) < 0.05] *= -1
    return ids, values


def _cell_counts(packed):
    """A packed [n, 3] array as sorted unique (id << 16 | bucket + 2^15)
    keys and their total counts (rows split across threads summed)."""
    keys = (packed[:, 0].astype(np.int64) << 16) | (
        packed[:, 1].astype(np.int64) + 32768)
    uk, inv = np.unique(keys, return_inverse=True)
    return uk, np.bincount(inv, weights=packed[:, 2]).astype(np.int64)


def _nh_feed(torch, agg, ids, values, writers=1):
    """record_batch in BATCH pieces from ``writers`` threads, then
    flush(force=True) and a synchronize; returns the wall seconds."""
    import threading

    pieces = [(off, off + BATCH) for off in range(0, len(ids), BATCH)]
    errors = []

    def write(k):
        try:
            for lo, hi in pieces[k::writers]:
                agg.record_batch(ids[lo:hi], values[lo:hi])
        except Exception as e:  # re-raised below, on the caller's thread
            errors.append(e)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if writers == 1:
        write(0)
    else:
        threads = [threading.Thread(target=write, args=(k,))
                   for k in range(writers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            if t.is_alive():
                raise AssertionError("a recording thread did not finish")
    if errors:
        raise errors[0]
    agg.flush(force=True)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _nh_routes(torch, m, samples, routes, rng):
    """Every route of ``routes`` (name -> (TorchAggregator kwargs,
    writers)) beside the Python-staged raw twin, NH_INTERVALS intervals
    of the same stream: each route's accumulator torch.equal to the
    twin's and its collect() equal to the twin's, the twin's counts to
    the host oracle.  Returns samples/s per route."""
    from loghisto_tpu_torch.ops.codec import compress_np
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    aggs = {"python_staged_raw": TorchAggregator(
        num_metrics=m, batch_size=BATCH, transport="raw")}
    for name, (kw, _) in routes.items():
        aggs[name] = TorchAggregator(num_metrics=m, batch_size=BATCH, **kw)
    for agg in aggs.values():
        for i in range(m):
            agg.registry.id_for(f"m{i}")
    writers = {"python_staged_raw": 1,
               **{n: w for n, (_, w) in routes.items()}}
    seconds = collections.defaultdict(float)
    out = {}
    try:
        for name, agg in aggs.items():
            if name.startswith("native_staged") and agg._native_buf is None:
                raise AssertionError(f"{name}: native staging fell back to "
                                     "Python staging")
            if name == "preagg" and agg._cell_store.backend != "native":
                raise AssertionError("preagg took the NumPy cell store")
        for _ in range(NH_INTERVALS):
            ids, values = _nh_stream(rng, samples, m)
            for name, agg in aggs.items():
                seconds[name] += _nh_feed(torch, agg, ids, values,
                                          writers[name])
            twin = aggs["python_staged_raw"]._acc
            for name, agg in aggs.items():
                if not torch.equal(agg._acc, twin):
                    raise AssertionError(f"{name}: accumulator differs from "
                                         "the Python-staged raw twin's")
            keep = ids >= 0
            want = np.bincount(ids[keep], minlength=m)
            got = {name: agg.collect().metrics for name, agg in aggs.items()}
            ref = got["python_staged_raw"]
            counts = np.array([ref.get(f"m{i}_count", 0.0)
                               for i in range(m)])
            if not np.array_equal(counts, want):
                raise AssertionError("the twin's counts differ from the "
                                     "host oracle's")
            # spot-check the codec: the twin's max of row 0 is the largest
            # value's bucket representative
            top = float(np.max(values[ids == 0]))
            if int(compress_np([ref["m0_max"]])[0]) != int(
                    compress_np([top])[0]):
                raise AssertionError("row 0's max is not its largest "
                                     "value's bucket")
            for name, metrics in got.items():
                if metrics != ref:
                    raise AssertionError(f"{name}: collect() differs from "
                                         "the Python-staged raw twin's")
        for name, agg in aggs.items():
            out[name] = {"samples_per_s": NH_INTERVALS * samples
                         / seconds[name],
                         "transport": agg.transport,
                         "ingest_path": agg.ingest_path,
                         "transport_stats": agg.transport_stats()}
            if agg._native_buf is not None:
                out[name]["dropped"] = agg._native_buf.dropped
    finally:
        for agg in aggs.values():
            agg.close()
        del aggs
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _fold_rates(rng):
    """The host fold at 2^24 samples of the headline stream: the native
    fold (8 threads and 1) against fold_packed_numpy, their cell sets
    equal; samples/s each."""
    from loghisto_tpu_torch import _native

    ids, values = _nh_stream(rng, NH_SAMPLES, M)
    out, cells = {}, {}
    for name, fn in (
            ("native_8_threads", lambda: _native.fold_packed_native(
                ids, values, BL, num_threads=8)),
            ("native_1_thread", lambda: _native.fold_packed_native(
                ids, values, BL, num_threads=1)),
            ("numpy", lambda: _native.fold_packed_numpy(ids, values, BL))):
        fn()  # warm: page-in and table growth
        t0 = time.perf_counter()
        packed = fn()
        dt = time.perf_counter() - t0
        cells[name] = _cell_counts(packed)
        out[name] = {"samples_per_s": NH_SAMPLES / dt, "s": dt,
                     "rows": len(packed)}
    uk, cnt = cells["numpy"]
    for name in ("native_8_threads", "native_1_thread"):
        if not (np.array_equal(cells[name][0], uk)
                and np.array_equal(cells[name][1], cnt)):
            raise AssertionError(f"{name}: cell set differs from "
                                 "fold_packed_numpy's")
    if int(cnt.sum()) != int((ids >= 0).sum()):
        raise AssertionError("the fold lost samples")
    out["unique_cells"] = len(uk)
    return out


def _fast_ingest_run(torch):
    """TorchMetricSystem(fast_ingest=True): 8 threads record through
    FastRecorder, FastTimer and FastCounter handles over 1,000 names for
    2 intervals; each interval's raw set lands on the card through
    merge_raw (K3).  Counts and counters exact against the host oracle,
    percentiles equal to the codec oracle's and within 1% of 1 + |v| of
    the recorded sample at the same rank (the codec's bound)."""
    import threading

    from loghisto_tpu_torch.metrics import (
        FastCounter,
        FastRecorder,
        FastTimer,
    )
    from loghisto_tpu_torch.ops.codec import compress_np
    from loghisto_tpu_torch.system import TorchMetricSystem

    names = [f"fi{i}" for i in range(FI_NAMES)]
    ms = TorchMetricSystem(interval=1.0, num_metrics=FI_NAMES + 8,
                           sys_stats=False, fast_ingest=True)
    if ms._fast_record is None:
        raise AssertionError("fast_ingest fell back to the Python path")
    rows, rates, ties = 0, [], 0
    try:
        for interval in range(FI_INTERVALS):
            recorded = [[] for _ in range(FI_THREADS)]
            counted = [collections.Counter() for _ in range(FI_THREADS)]
            errors = []

            def writer(k, interval=interval):
                try:
                    rng = np.random.default_rng(SEED + 60 + 8 * interval + k)
                    pick = rng.integers(0, FI_NAMES, FI_RECORDS)
                    vals = rng.lognormal(3.0, 1.5, FI_RECORDS)
                    recs = {n: ms.recorder(n) for n in names}
                    timers = {n: ms.timer(n) for n in names[:100]}
                    ctrs = [ms.counter_handle(f"fi.count{j}")
                            for j in range(8)]
                    if not (isinstance(recs[names[0]], FastRecorder)
                            and isinstance(timers[names[0]], FastTimer)
                            and isinstance(ctrs[0], FastCounter)):
                        raise AssertionError("a handle is not the fast one")
                    out, cnt = recorded[k], counted[k]
                    for i in range(FI_RECORDS):
                        name = names[pick[i]]
                        if i % 5 == 0 and pick[i] < 100:
                            t = timers[name]
                            out.append((name, float(t.stop(t.start()))))
                        else:
                            recs[name].record(float(vals[i]))
                            out.append((name, float(vals[i])))
                        ctrs[i % 8].add(1 + i % 3)
                        cnt[f"fi.count{i % 8}"] += 1 + i % 3
                except Exception as e:
                    errors.append(e)

            threads = [threading.Thread(target=writer, args=(k,))
                       for k in range(FI_THREADS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
                if t.is_alive():
                    raise AssertionError("a fast-ingest writer hung")
            rates.append(FI_THREADS * FI_RECORDS
                         / (time.perf_counter() - t0))
            if errors:
                raise errors[0]
            if any(sh.histograms or sh.counters or sh.bucket_counts
                   for sh in ms._shards):
                raise AssertionError("a sample took the Python path")
            raw = ms.collect_raw_metrics()
            ms.aggregator.merge_raw(raw)
            metrics = ms.device_metrics().metrics
            if ms._fast_dropped_total or ms._fast_counter_dropped_total:
                raise AssertionError("the fast staging buffers shed")
            want_ctr = sum(counted, collections.Counter())
            if {k: raw.rates[k] for k in want_ctr} != dict(want_ctr):
                raise AssertionError("fast counters are not exact")
            by_name = collections.defaultdict(list)
            for out in recorded:
                for name, v in out:
                    by_name[name].append(v)
            hist = np.zeros((FI_NAMES, B), np.int64)
            for i, name in enumerate(names):
                v = np.asarray(by_name[name])
                cols = np.clip(compress_np(v), -BL, BL).astype(np.int64) + BL
                hist[i] = np.bincount(cols, minlength=B)
            want, t = _oracle_stats(hist)
            ties += t
            for i, name in enumerate(names):
                n = int(want["counts"][i])
                if metrics.get(f"{name}_count", 0.0) != n:
                    raise AssertionError(f"{name}: count differs")
                if not n:
                    continue
                v = np.sort(np.asarray(by_name[name]))
                for j, (label, p) in enumerate(zip(FI_LABELS, PS)):
                    got = metrics[f"{name}_{label}"]
                    if got != float(np.float32(want["percentiles"][i, j])):
                        raise AssertionError(f"{name}_{label}: not the "
                                             "codec oracle's value")
                    # the float64 rank; at a float32 rank tie the device
                    # takes a neighbouring one (_oracle_stats)
                    k = min(n, max(1, int(np.ceil(p * n))))
                    near = v[max(0, k - 2):k + 1]
                    if np.min(np.abs(got - near)
                              - 0.01 * (1.0 + np.abs(near))) > 0:
                        raise AssertionError(
                            f"{name}_{label}: {got} is not within 1% of "
                            f"the rank-{k} sample {v[k - 1]}")
                rows += 1
    finally:
        ms.stop()
    return {"names": FI_NAMES, "threads": FI_THREADS,
            "intervals": FI_INTERVALS, "rows_checked": rows,
            "rank_ties": ties, "records_per_s": rates}


def phase_native_host(torch):
    """The native host tier on the card's host, at the main path's
    width (M = 10,000, bucket_limit 4096, 2^24 Zipf(1.3) samples per
    interval): (a) transport="preagg" fed by 4 recording threads, (b)
    transport="sparse" through the native fold, (c) native staging on the
    raw route at M = 10,000 (K1) and M = 1 (K2b), each beside the
    Python-staged raw twin on the same stream (accumulators torch.equal,
    collect() equal), (d) TorchMetricSystem(fast_ingest=True) from 8
    threads over 1,000 names.  Then the host fold's rate (native against
    NumPy at 2^24) and the transport crossover the native fold implies
    (transport_crossover's points when that phase ran, else measured
    here).  Any route that takes the NumPy or Python tier fails the
    phase."""
    from loghisto_tpu_torch import _native
    from loghisto_tpu_torch.ops import dispatch
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )

    if not (_native.available() and _native.fastpath_available()):
        raise AssertionError(
            f"the native host tier did not build: {_native.build_error()} "
            f"{_native.fastpath_error()}")
    rng = np.random.default_rng(SEED + 50)
    reset_kernel_launches()
    with native_tiers_only():
        wide = _nh_routes(torch, M, NH_SAMPLES, {
            "preagg": ({"transport": "preagg"}, NH_WRITERS),
            "sparse_native_fold": ({"transport": "sparse"}, 1),
            "native_staged_raw": ({"transport": "raw",
                                   "native_staging": True}, 1),
        }, rng)
        row = _nh_routes(torch, 1, NH_ROW_SAMPLES, {
            "native_staged_row": ({"transport": "raw",
                                   "native_staging": True}, 1),
        }, rng)
        fast = _fast_ingest_run(torch)
    launches = kernel_launches()
    for kernel in ("fused_ingest", "row_ingest", "sparse_ingest"):
        if launches[kernel] <= 0:
            raise AssertionError(f"{kernel} was not launched on the native "
                                 "routes")
        RESULTS.setdefault(kernel, {})["launches"] = (
            RESULTS.get(kernel, {}).get("launches", 0) + launches[kernel])
    if row["native_staged_row"]["ingest_path"] != "row":
        raise AssertionError("the single row did not take K2b")
    fold = _fold_rates(rng)
    xo = RESULTS.get("xo")
    if xo is None:
        points, measured = xo_points(torch, np.random.default_rng(SEED + 40))
        xo = {"points": points, "measured_crossover": measured}
    return {"samples_per_interval": NH_SAMPLES, "intervals": NH_INTERVALS,
            "num_metrics": M, "routes": wide, "single_row": row,
            "fast_ingest": fast, "host_fold_2p24": fold,
            "crossover": {**xo, "stated": dispatch.sparse_density_crossover(
                "cuda")},
            "launches": {k: v for k, v in launches.items() if v}}


def _paged_store(torch, m):
    from loghisto_tpu_torch.paging import PagedStore, PagedStoreConfig

    return PagedStore(m, BL, config=PagedStoreConfig(pool_pages=PAGED_POOL),
                      device=torch.device("cuda"))


def _pad_chunk(triples):
    from loghisto_tpu_torch.ops.paged_store import COMMIT_CHUNK

    padded = -(-len(triples) // COMMIT_CHUNK) * COMMIT_CHUNK
    pad = np.zeros((padded - len(triples), 3), dtype=np.int32)
    pad[:, 0] = -1
    return np.ascontiguousarray(np.concatenate([triples, pad]))


def row_grouped_triples(torch, rng):
    """What ``merge_raw`` hands K4 at the paged threshold: one interval of
    the band workload over 2^16 rows (64 samples a row), folded and
    translated against a fresh 2^16-row store (a 2^21-page pool): about
    262,144 triples grouped by row, several cells of a row on one page."""
    from loghisto_tpu_torch.ops.fold import fold_packed_numpy

    store = _paged_store(torch, 1 << 16)
    ids, vals = band_workload(rng, 1 << 16)
    triples, _, _ = store.translate(fold_packed_numpy(ids, vals, BL))
    del store
    return _pad_chunk(triples)


def k4_cells(triples, page_size=256):
    """Flat pool cells of the triples K4 adds (0 < slot < the pool,
    count != 0), in their order."""
    keep = ((triples[:, 0] > 0) & (triples[:, 0] < PAGED_POOL)
            & (triples[:, 2] != 0))
    return (triples[keep, 0].astype(np.int64) * page_size
            + np.clip(triples[keep, 1], 0, page_size - 1))


def sector_floor_ms(cells):
    """The DRAM traffic the cells' scatter cannot avoid when the pool is
    far larger than the L2: each distinct 32-byte sector read and written
    back once (64 B), over the card's memory rate."""
    sectors = len(np.unique(cells // 8))
    return sectors * 64 / HBM_BYTES_PER_S * 1e3, sectors


def phase_k4(torch):
    """K4 against its plain version on the triples the paged sparse
    route gives it at the headline shape: one 2^20-sample batch of the
    band workload and of a uniform workload, folded and translated
    against a 2^20-row store with a 2^21-page pool, the row-grouped
    triples of one band interval at 2^16 rows (``row_grouped_triples``),
    and an adversarial batch.  Times on the band batch (the kernel
    table's row) and the row-grouped one, each beside its byte bound and
    its sector floor."""
    from loghisto_tpu_torch.ops.fold import fold_packed_numpy
    from loghisto_tpu_torch.ops.paged_store import (
        paged_scatter,
        paged_scatter_batch,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 4)
    store = _paged_store(torch, PAGED_M)
    batches = {}
    for name, (ids, vals) in (
        ("band", band_batch(rng, BATCH, PAGED_M)),
        ("uniform", (rng.integers(0, PAGED_M, BATCH).astype(np.int32),
                     lognormal_values(rng, BATCH))),
    ):
        dev_triples, _, _ = store.translate(
            fold_packed_numpy(ids, vals, BL))
        batches[name] = _pad_chunk(dev_triples)
    batches["row_grouped"] = row_grouped_triples(torch, rng)
    band = batches["band"]
    live = band[band[:, 0] > 0]
    hot = np.repeat(live[:1], 1 << 16, axis=0)
    hot[:, 2] = 1  # one cell takes 2^16 adds
    bad = np.array([[-1, 0, 9], [0, 3, 9], [PAGED_POOL, 0, 9],
                    [PAGED_POOL + 5, 1, 9], [2**30, 0, 9], [-(2**31), 0, 9],
                    [live[1, 0], -5, 7], [live[1, 0], 256, 7],
                    [live[2, 0], 10**6, 7], [live[3, 0], 4, 0]], np.int32)
    batches["adversarial"] = _pad_chunk(np.concatenate([live[:5000], bad, hot]))
    pool_k = store._pool
    pool_p = torch.zeros_like(pool_k)
    equal = {}
    for name, triples in batches.items():
        d = torch.from_numpy(triples).to(dev)
        paged_scatter(pool_k, d)
        paged_scatter_batch(pool_p, d)
        torch.cuda.synchronize()
        equal[name] = bool(torch.equal(pool_k, pool_p))
    max_err = int((pool_k - pool_p).abs().max())
    if not all(equal.values()) or pool_k[0].any():
        raise AssertionError(f"K4 differs from its plain version: {equal}")
    want_total = sum(int(t[(t[:, 0] > 0) & (t[:, 0] < PAGED_POOL), 2].sum(
        dtype=np.int64)) for t in batches.values())
    assert int(pool_k.sum(dtype=torch.int64)) == want_total

    timings = {}
    for name in ("band", "row_grouped"):
        triples = batches[name]
        d = torch.from_numpy(triples).to(dev)
        valid = (triples[:, 0] > 0) & (triples[:, 0] < PAGED_POOL)
        flat = torch.from_numpy(triples[valid, 0].astype(np.int64) * 256
                                + np.clip(triples[valid, 1], 0, 255)).to(dev)
        w = torch.from_numpy(triples[valid, 2]).to(dev)
        k_ms = time_ms(torch, lambda: paged_scatter(pool_k, d))
        cold_ms = time_cold_ms(torch, lambda: paged_scatter(pool_k, d))
        p_ms = time_ms(torch, lambda: paged_scatter_batch(pool_p, d))
        lib_ms = time_ms(torch, lambda: pool_p.view(-1).index_put_(
            (flat,), w, accumulate=True))
        cells = k4_cells(triples)
        n_cells = len(np.unique(cells))
        b_ms, b_by = bound_ms(len(triples) * 12 + n_cells * 8)
        floor_ms, sectors = sector_floor_ms(cells)
        timings[name] = {"triples": len(triples), "ms": k_ms,
                         "l2_flushed_ms": cold_ms, "plain_ms": p_ms,
                         "library_ms": lib_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "touched_cells": n_cells,
                         "sectors": sectors, "sector_floor_ms": floor_ms}
    RESULTS["paged_scatter"] = {"max_abs_err": max_err, **{
        k: timings["band"][k] for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by")}}
    out = {"M": PAGED_M, "pool_pages": PAGED_POOL, "batch_samples": BATCH,
           "triples": {k: len(v) for k, v in batches.items()},
           "equal": equal, "max_abs_err": max_err, "timings": timings,
           "library_call": "pool.view(-1).index_put_((flat,), counts, "
                           "accumulate=True) on a precomputed flat index"}
    del store, pool_k, pool_p
    return out


def phase_k4f(torch):
    """K4f against its plain version at the headline shape: 2^20-sample
    batches through prepare_batch on a 2^20-row store (2^21-page pool):
    the band workload, a uniform workload, and an adversarial batch
    (-1 ids, rows with no codec, unmapped pages, a hot cell).  Times on
    the band and uniform batches, each beside K4 on the batch's own
    translated (slot, offset, 1) cells: the scatter alone."""
    from loghisto_tpu_torch.ops.fused_ingest import (
        fused_paged_ingest_batch,
        fused_paged_ingest_reference,
    )
    from loghisto_tpu_torch.ops.paged_store import paged_scatter

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 5)
    store = _paged_store(torch, PAGED_M)
    batches = {}
    # the last 1000 rows are never prepared: they keep no codec
    touched = PAGED_M - 1000
    band_ids, band_vals = band_batch(rng, BATCH, touched)
    batches["band"] = (store.prepare_batch(band_ids, band_vals)[0], band_vals)
    uni_ids = rng.integers(0, touched, BATCH).astype(np.int32)
    uni_vals = lognormal_values(rng, BATCH)
    batches["uniform"] = (store.prepare_batch(uni_ids, uni_vals)[0], uni_vals)
    ids, vals = batches["band"][0].copy(), band_vals.copy()
    n_adv = 1 << 17
    ids[:1000] = -1
    assert (store.row_codec[touched:] < 0).all()
    ids[1000:2000] = np.arange(touched, PAGED_M)  # rows with no codec
    # band rows are dense-coded around storage 4096..4499: 1e15 sits in
    # bucket ~3454, a page no band row mapped
    ids[2000:3000] = band_ids[:1000]
    vals[2000:3000] = 1e15
    assert (store.page_table[band_ids[:1000], (3454 + BL) // 256] < 0).all()
    ids[3000:3000 + (1 << 16)] = band_ids[0]  # one cell takes 2^16 samples
    vals[3000:3000 + (1 << 16)] = band_vals[0]
    batches["adversarial"] = (ids[:n_adv], vals[:n_adv])
    luts = store.device_luts()
    pool_k = store._pool
    pool_p = torch.zeros_like(pool_k)
    equal = {}
    for name, (i, v) in batches.items():
        i_d, v_d = torch.from_numpy(i).to(dev), torch.from_numpy(v).to(dev)
        fused_paged_ingest_batch(pool_k, i_d, v_d, *luts, BL)
        fused_paged_ingest_reference(pool_p, i_d, v_d, *luts, BL)
        torch.cuda.synchronize()
        equal[name] = bool(torch.equal(pool_k, pool_p))
    max_err = int((pool_k - pool_p).abs().max())
    if not all(equal.values()) or pool_k[0].any():
        raise AssertionError(f"K4f differs from its plain version: {equal}")
    hot = int(pool_k.max())
    assert hot >= 1 << 16, hot

    timings = {}
    for name in ("band", "uniform"):
        ids, vals = batches[name]
        i_d = torch.from_numpy(ids).to(dev)
        v_d = torch.from_numpy(vals).to(dev)
        # the batch's own cells, translated on the host from the store's
        # tables: one (slot, offset, 1) triple per sample for K4
        cells, need = _k4f_cells(store, ids, vals)
        packed = np.ascontiguousarray(np.stack(
            [cells // 256, cells % 256, np.ones_like(cells)],
            axis=1).astype(np.int32))
        packed_d = torch.from_numpy(packed).to(dev)
        n_cells = len(np.unique(cells))
        k_ms = time_ms(torch, lambda: fused_paged_ingest_batch(
            pool_k, i_d, v_d, *luts, BL))
        k4_ms = time_ms(torch, lambda: paged_scatter(pool_p, packed_d))
        p_ms = time_ms(torch, lambda: fused_paged_ingest_reference(
            pool_p, i_d, v_d, *luts, BL))
        # the bytes the work needs: 8 B per sample in, the table entries
        # the inputs need (row codec per distinct id, encode LUT per distinct
        # (codec, col), page table per distinct (id, page)), 8 B of
        # read-modify-write per touched cell
        b_ms, b_by = bound_ms(len(ids) * 8 + need * 4 + n_cells * 8,
                              len(ids) * CODEC_OPS)
        k4_bound, _ = bound_ms(len(packed) * 12 + n_cells * 8)
        timings[name] = {
            "ms": k_ms, "plain_ms": p_ms, "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by, "touched_cells": n_cells,
            "table_entries": need, "k4_same_cells_ms": k4_ms,
            "k4_same_cells_bound_ms": k4_bound, "k4_triples": len(packed),
            "ratio_to_k4": k_ms / k4_ms,
        }
    RESULTS["fused_paged_ingest"] = {
        "max_abs_err": max_err,
        **{k: timings["band"][k] for k in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")}}
    out = {"M": PAGED_M, "pool_pages": PAGED_POOL, "batch": BATCH,
           "adversarial_samples": n_adv, "hot_cell": hot, "equal": equal,
           "allocated_pages": int(store.allocated_pages),
           "max_abs_err": max_err, "timings": timings,
           "library_call": "none: no single PyTorch call computes codec, "
                           "encode, translate and scatter"}
    del store, pool_k, pool_p
    return out


def _k4f_cells(store, ids, vals):
    """The flat pool cells (slot * 256 + offset) of a prepared batch's
    valid samples, and the number of distinct table entries the batch
    needs (row codecs, encode LUT entries, page-table entries), from the
    store's host tables."""
    from loghisto_tpu_torch.ops.codec import compress_np

    keep = ids >= 0
    rows = ids[keep].astype(np.int64)
    dense = np.clip(compress_np(vals[keep]), -BL, BL).astype(np.int64) + BL
    codec = store.row_codec[rows].astype(np.int64)
    storage = store._enc[codec, dense].astype(np.int64)
    page = storage // 256
    slot = store.page_table[rows, page].astype(np.int64)
    ok = slot > 0
    need = (len(np.unique(rows)) + len(np.unique(codec * B + dense))
            + len(np.unique(rows * store.pages_per_row + page)))
    return (slot * 256 + storage % 256)[ok], need


class _Timers:
    """Host-clock and CUDA-event timers wrapped around the functions the
    paged main path calls (the wrapped functions run unchanged)."""

    def __init__(self, torch):
        self.torch = torch
        self.host = collections.defaultdict(float)
        self.events = collections.defaultdict(list)

    def host_wrap(self, name, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.host[name] += time.perf_counter() - t0
        return wrapped

    def dev_wrap(self, name, fn):
        def wrapped(*a, **k):
            e0 = self.torch.cuda.Event(enable_timing=True)
            e1 = self.torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            self.events[name].append((e0, e1))
            return out
        return wrapped

    def take(self):
        self.torch.cuda.synchronize()
        out = {f"{k}_s": v for k, v in self.host.items()}
        for k, pairs in self.events.items():
            out[f"{k}_kernel_ms"] = sum(a.elapsed_time(b) for a, b in pairs)
            out[f"{k}_launches"] = len(pairs)
        self.host.clear()
        self.events.clear()
        return out


def synced(torch, split, key, fn):
    """``fn`` timed on the host clock between two device
    synchronisations; each call's ms is appended to ``split[key]``."""
    def wrapped(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        split[key].append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapped


def _h2d_ms(torch, nbytes, pinned):
    """Measured time of one host->device copy of nbytes."""
    host = torch.empty(nbytes // 4, dtype=torch.int32, pin_memory=pinned)
    dev = torch.empty_like(host, device="cuda")
    return time_ms(torch, lambda: dev.copy_(host, non_blocking=pinned),
                   reps=10, warmup=2)


def _paged_oracle(ids, values, store, m):
    """compress_np -> the store's codec LUTs (the identity without a
    store) -> sparse_cells_stats, from the numpy samples (neither the
    pool nor the accumulator is read)."""
    import torch

    from loghisto_tpu_torch.ops.codec import compress_np
    from loghisto_tpu_torch.ops.stats import sparse_cells_stats

    dense = np.clip(compress_np(values), -BL, BL).astype(np.int64) + BL
    keys = torch.from_numpy(ids.astype(np.int64) * B + dense).cuda()
    uniq, counts = torch.unique(keys, return_counts=True)
    del keys
    uniq, counts = uniq.cpu().numpy(), counts.cpu().numpy()
    rows, cell = uniq // B, uniq % B
    if store is not None:
        codec = store.row_codec[rows].astype(np.int64)
        assert (codec >= 0).all()
        cell = store._dec[codec, store._enc[codec, cell]]
    return sparse_cells_stats(rows, cell, counts, m, PS, BL)


def _check_interval(metrics, names, want, lifetime, exact_pcts):
    """Every row's count and percentiles against the oracle (exactly, or
    as the float32 the dense route reports), sums within rtol 1e-12
    (1e-5 for the dense float32 sums), and the lifetime _agg_* values."""
    labels = ["min", "50", "75", "90", "95", "99", "99.9", "99.99", "max"]
    got_count = np.array([metrics.get(f"{n}_count", 0.0) for n in names])
    if not (got_count == want["counts"]).all():
        bad = int((got_count != want["counts"]).sum())
        raise AssertionError(f"{bad} rows' counts differ from the oracle")
    live = np.nonzero(want["counts"])[0]
    live_names = [names[i] for i in live]
    for j, label in enumerate(labels):
        got = np.array([metrics[f"{n}_{label}"] for n in live_names])
        w = want["percentiles"][live, j]
        if not exact_pcts:
            w = w.astype(np.float32).astype(np.float64)
        if not (got == w).all():
            raise AssertionError(
                f"p{label}: {int((got != w).sum())} rows differ")
    sums = np.array([metrics[f"{n}_sum"] for n in live_names])
    rtol = 1e-12 if exact_pcts else 1e-5
    np.testing.assert_allclose(sums, want["sums"][live], rtol=rtol,
                               atol=1e-3 if not exact_pcts else 0)
    lifetime["count"] += want["counts"]
    lifetime["sum"][live] += sums
    lc = lifetime["count"][live]
    agg_count = np.array([metrics[f"{n}_agg_count"] for n in live_names])
    agg_sum = np.array([metrics[f"{n}_agg_sum"] for n in live_names])
    agg_avg = np.array([metrics[f"{n}_agg_avg"] for n in live_names])
    assert (agg_count == lc).all()
    np.testing.assert_allclose(agg_sum, lifetime["sum"][live], rtol=1e-9)
    np.testing.assert_allclose(agg_avg, lifetime["sum"][live] / lc,
                               rtol=1e-9)
    return len(live)


def _check_query(query, q_ids, want):
    """PagedStore.query's rows against the oracle: counts exact,
    percentiles as the float32 the device rank rule reports (the dense
    route's check), float32 sums within rtol 1e-5."""
    if not (query["counts"] == want["counts"][q_ids]).all():
        raise AssertionError("query counts differ from the oracle")
    w = want["percentiles"][q_ids].astype(np.float32).astype(np.float64)
    if not (query["percentiles"] == w).all():
        bad = int((query["percentiles"] != w).any(axis=1).sum())
        raise AssertionError(f"query percentiles: {bad} rows differ")
    np.testing.assert_allclose(query["sums"], want["sums"][q_ids],
                               rtol=1e-5, atol=1e-3)


def _drive_paged(torch, transport, intervals, m, storage="auto"):
    """One run of the paged (or, for contrast, dense) main path: the band
    workload through record_batch + collect(), each interval checked
    against the host oracle; returns rates, the time split and the pool
    occupancy."""
    from loghisto_tpu_torch.ops import fused_ingest as fused_mod
    from loghisto_tpu_torch.ops import paged_store as paged_mod
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )
    from loghisto_tpu_torch.paging import PagedStoreConfig
    from loghisto_tpu_torch.parallel import aggregator as agg_mod
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    rng = np.random.default_rng(SEED + 20 + m)
    agg = TorchAggregator(
        num_metrics=m, batch_size=BATCH, transport=transport, storage=storage,
        paged_config=PagedStoreConfig(pool_pages=PAGED_POOL),
    )
    timers = _Timers(torch)
    saved = (fused_mod.fused_paged_ingest_batch, paged_mod.paged_scatter,
             agg_mod.fold_packed)
    if agg.paged is not None:
        fused_mod.fused_paged_ingest_batch = timers.dev_wrap(
            "k4f", saved[0])
        paged_mod.paged_scatter = timers.dev_wrap("k4", saved[1])
        agg_mod.fold_packed = timers.host_wrap("fold", saved[2])
        agg.paged.prepare_batch = timers.host_wrap(
            "prepare_batch", agg.paged.prepare_batch)
        agg.paged.translate = timers.host_wrap(
            "translate", agg.paged.translate)
        agg.paged.commit = timers.host_wrap("commit", agg.paged.commit)
    names = [f"r{i}" for i in range(m)]
    for name in names:
        agg.registry.id_for(name)
    lifetime = {"count": np.zeros(m, np.int64),
                "sum": np.zeros(m, np.float64)}
    per_interval = []
    reset_kernel_launches()
    try:
        for _ in range(intervals):
            ids, values = band_workload(rng, m)
            n = len(ids)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for off in range(0, n, BATCH):
                agg.record_batch(ids[off:off + BATCH], values[off:off + BATCH])
            agg.flush(force=True)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            query = {}
            if agg.paged is not None:
                # a snapshot query of QUERY_IDS rows on the card, before
                # collect() closes the interval
                q_ids = rng.choice(m, QUERY_IDS, replace=False)
                query = agg.paged.query(q_ids, PS)
                torch.cuda.synchronize()
                query["ms"] = (time.perf_counter() - t1) * 1e3
            tc = time.perf_counter()
            metrics = agg.collect().metrics
            t2 = time.perf_counter()
            split = timers.take()
            want = _paged_oracle(ids, values, agg.paged, m)
            checked = _check_interval(metrics, names, want, lifetime,
                                      exact_pcts=agg.paged is not None)
            if query:
                _check_query(query, q_ids, want)
            per_interval.append({
                "samples": n, "ingest_s": t1 - t0,
                "samples_per_s": n / (t1 - t0), "collect_ms": (t2 - tc) * 1e3,
                "rows_checked": checked, **split,
                **({"query_ids": QUERY_IDS, "query_ms": query["ms"]}
                   if query else {}),
            })
            del metrics
    finally:
        agg.close()
        (fused_mod.fused_paged_ingest_batch, paged_mod.paged_scatter,
         agg_mod.fold_packed) = saved
    launches = kernel_launches()
    out = {"num_metrics": m, "storage": agg.storage,
           "transport": agg.transport, "ingest_path": agg.ingest_path,
           "fused_paged": agg.fused_paged, "intervals": per_interval,
           "launches": launches}
    if agg.paged is not None:
        st = agg.paged
        live_rows = int((st.row_codec >= 0).sum())
        out.update({
            "pool_pages": st.total_pages,
            "allocated_pages": int(st.allocated_pages),
            "pool_saturation": st.pool_saturation(),
            "live_rows": live_rows,
            "pages_per_live_row": st.allocated_pages / max(1, live_rows),
            "codecs": {c.name: int((st.row_codec == i).sum())
                       for i, c in enumerate(st._codecs)},
            "hbm_bytes": st.hbm_bytes(), "spilled_cells": st.spilled_cells,
            "commits": st.commits, "fused_dispatches": st.fused_dispatches,
            "h2d_bytes": st.h2d_bytes,
        })
    else:
        out["hbm_bytes"] = m * B * 4
    del agg
    torch.cuda.empty_cache()
    return out


def phase_paged_main(torch):
    raw = _drive_paged(torch, "auto", 1, PAGED_M)
    if not (raw["storage"] == "paged" and raw["fused_paged"]
            and raw["transport"] == "raw"):
        raise AssertionError(f"2^20 rows did not resolve to paged + K4f: {raw}")
    if raw["launches"]["fused_paged_ingest"] <= 0:
        raise AssertionError("K4f was not launched on the paged raw route")
    sparse = _drive_paged(torch, "sparse", 1, PAGED_M)
    if sparse["storage"] != "paged" or sparse["ingest_path"] != "packed":
        raise AssertionError(f"the sparse route is not paged: {sparse}")
    if sparse["launches"]["paged_scatter"] <= 0:
        raise AssertionError("K4 was not launched on the paged sparse route")
    dense = _drive_paged(torch, "raw", 2, DENSE_CONTRAST_M, storage="dense")
    RESULTS.setdefault("fused_paged_ingest", {})["launches"] = raw[
        "launches"]["fused_paged_ingest"]
    RESULTS.setdefault("paged_scatter", {})["launches"] = sparse[
        "launches"]["paged_scatter"]
    batches = -(-PAGED_M * SAMPLES_PER_ROW // BATCH)
    h2d = {
        "raw_batch_pinned_ms": _h2d_ms(torch, BATCH * 8, True),
        "raw_interval_batches": batches,
    }
    h2d["raw_interval_ms"] = h2d["raw_batch_pinned_ms"] * batches
    commit_bytes = sparse["h2d_bytes"]
    h2d["sparse_interval_pageable_ms"] = _h2d_ms(torch, commit_bytes, False)
    return {"raw": raw, "sparse": sparse, "dense_contrast": dense,
            "h2d_measured": h2d}


# the retention phase's snapshot views of a tier: the full span, then its
# five pinned windows
RET_VIEW_WINDOWS = (np.inf, 1.0, 5.0, 30.0, 60.0, 3600.0)


def _wheel_1440(torch):
    """A small wheel with a 24 h tier at minute resolution (1440 slots,
    past the 1000 slots the first K5 took) pushed past its ring wrap on the
    card: every push refreshes the snapshot through one K5 per tier; the
    served windows equal the recompute and a host count oracle."""
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.ops.backend import kernel_launches
    from loghisto_tpu_torch.window.store import TimeWheel

    pushes, slots = 1500, 1440
    wheel = TimeWheel(num_metrics=8, config=MetricConfig(bucket_limit=64),
                      tiers=((slots, 1), (24, 60)))
    for w in (60.0, 1440.0):
        wheel.pin_window(w)
    t0 = _dt.datetime(2026, 1, 1, tzinfo=_dt.timezone.utc)
    counts = []
    before = kernel_launches()["window_merge"]
    t_push = time.perf_counter()
    for i in range(pushes):
        a = 1 + i % 7
        counts.append(a + 1)
        wheel.push(RawMetricSet(t0 + i * _ONE_SECOND, {}, {"req": 3}, {
            "a": {1: a, 40: 1}, "b": {-3: 2, 60: i % 5}}, {}, 1.0))
    torch.cuda.synchronize()
    push_ms = (time.perf_counter() - t_push) * 1e3 / pushes
    k5 = kernel_launches()["window_merge"] - before
    if k5 != 2 * pushes:
        raise AssertionError(f"{k5} K5 launches for {pushes} pushes of a "
                             "2-tier wheel, not 1 per tier")
    served = {}
    for w in (60.0, 1440.0):
        res = wheel.query("*", w)
        oracle = wheel._query_recompute("*", res.window_s,
                                        wheel.percentiles, res.tier)
        if res.metrics != oracle.metrics:
            raise AssertionError(f"1440-slot wheel, window {w}: snapshot "
                                 "serve != recompute")
        want = sum(counts[-int(w):])
        if res.tier != 0 or res.metrics["a"]["count"] != want:
            raise AssertionError(f"1440-slot wheel, window {w}: count "
                                 f"{res.metrics['a']['count']} != {want}")
        served[str(w)] = res.metrics["a"]["count"]
    del wheel
    return {"slots": slots, "pushes": pushes, "k5_launches": k5,
            "push_ms": push_ms, "counts": served}


def phase_k5(torch):
    """K5 against its plain version at the default tier-0 ring, 60 x 1024
    x 8193 int32 (2.01 GB) from a seeded generator: one view at a time
    (all slots, one slot, a 5-slot trailing window wrapping past slot 0,
    a random mask, the empty mask), the retention phase's six nested
    views in one launch, six random (not nested) views; a 7 x 999 x 8193
    ring (odd M*B, the scalar path), a ring built to wrap int32, a
    1440-slot ring of a few rows, and a small wheel with a 1440-slot
    tier.  Times: all 60 slots in turns with ``ring.sum(0)``; the six
    views in one launch against their bound, their plain version and
    one launch per view (the earlier call pattern)."""
    from loghisto_tpu_torch.ops.window import (
        merge_plan,
        window_merge,
        window_merge_kernel,
        window_merge_views,
    )
    from loghisto_tpu_torch.window.store import trailing_mask

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    s = RET_TIERS[0][0]
    ring = torch.randint(0, 1 << 16, (s, RET_M, B), dtype=torch.int32,
                         device=dev, generator=gen)
    rng = np.random.default_rng(SEED + 6)
    # slot 2 open with nothing in it: the trailing walk goes 1, 0, 59, ...
    written = np.ones(s, bool)
    masks = {
        "all": np.ones(s, bool),
        "one": np.arange(s) == 17,
        "trailing5": trailing_mask(written, np.ones(s), 2, 0, s, 5.0),
        "random": rng.random(s) < 0.5,
        "empty": np.zeros(s, bool),
    }
    assert masks["trailing5"].sum() == 5 and masks["trailing5"][[0, 59]].all()
    views = np.stack([trailing_mask(written, np.ones(s), 2, 0, s, w)
                      for w in RET_VIEW_WINDOWS])
    order, table = merge_plan(views)
    assert len(order) == s and set(table[:, 1].tolist()) == {0}
    equal, max_err = {}, 0

    def note(name, got, want):
        nonlocal max_err
        torch.cuda.synchronize()
        equal[name] = bool(torch.equal(got, want))
        max_err = max(max_err, int((got.long() - want.long()).abs().max()))
        return got

    def check(name, r, mask):
        return note(name, window_merge_kernel(r, mask), window_merge(r, mask))

    def check_views(name, r, vmasks):
        return note(name, window_merge_views(r, vmasks),
                    torch.stack([window_merge(r, m) for m in vmasks]))

    for name, mask in masks.items():
        check(name, ring, mask)
    check_views("views6_nested", ring, views)
    check_views("views6_random", ring, rng.random((6, s)) < 0.5)
    odd = torch.randint(-(1 << 20), 1 << 20, (7, 999, B), dtype=torch.int32,
                        device=dev, generator=gen)
    check("odd_all", odd, np.ones(7, bool))
    check("odd_random", odd, rng.random(7) < 0.5)
    check_views("odd_views", odd, np.tril(np.ones((7, 7), bool)))
    del odd
    wrap = torch.zeros((3, 8, B), dtype=torch.int32, device=dev)
    wrap[:2, 0, 5] = (1 << 30) + 5
    wrap[:, 1, :] = 2**31 - 1
    got = check("int32_wrap", wrap, np.ones(3, bool))
    if int(got[0, 5]) != -(1 << 31) + 10:
        raise AssertionError(f"K5 did not wrap int32: {int(got[0, 5])}")
    big = torch.randint(-(1 << 30), 1 << 30, (1440, 4, 129),
                        dtype=torch.int32, device=dev, generator=gen)
    big_written = rng.random(1440) < 0.97
    big_written[700] = True
    check_views("s1440_nested", big, np.stack([
        trailing_mask(big_written, np.ones(1440), 700, 1, 1440, w)
        for w in RET_VIEW_WINDOWS]))
    check_views("s1440_random", big, rng.random((6, 1440)) < 0.4)
    check("s1440_one_view", big[:, :3].contiguous(), big_written)
    del big
    if not all(equal.values()):
        raise AssertionError(f"K5 differs from its plain version: {equal}")
    wheel = _wheel_1440(torch)

    mb4 = RET_M * B * 4
    all_mask = masks["all"]
    k_ms = lambda: time_ms(torch, lambda: window_merge_kernel(  # noqa: E731
        ring, all_mask))
    lib_ms = lambda: time_ms(torch, lambda: ring.sum(  # noqa: E731
        0, dtype=torch.int32))
    # in turns: library, kernel, kernel, library
    turns = [("library", lib_ms()), ("kernel", k_ms()), ("kernel", k_ms()),
             ("library", lib_ms())]
    k_all = [t for who, t in turns if who == "kernel"]
    lib_all = [t for who, t in turns if who == "library"]
    b_all, b_all_by = bound_ms((s + 1) * mb4)
    one_view = {
        "slots": s, "ms_turns": k_all, "library_ms_turns": lib_all,
        "library_call": "ring.sum(0, dtype=torch.int32)",
        "plain_ms": time_ms(torch, lambda: window_merge(ring, all_mask)),
        "bound_ms": b_all, "bound_by": b_all_by,
    }
    trailing5 = masks["trailing5"]
    idx = torch.from_numpy(np.flatnonzero(trailing5)).to(dev)
    b5, _ = bound_ms(6 * mb4)
    five = {"slots": 5,
            "ms": time_ms(torch, lambda: window_merge_kernel(ring, trailing5)),
            "library_ms": time_ms(torch, lambda: ring[idx].sum(
                0, dtype=torch.int32)),
            "library_call": "ring[idx].sum(0, dtype=torch.int32)",
            "bound_ms": b5}
    b6, b6_by = bound_ms((s + len(views)) * mb4)
    six = {
        "windows": [str(w) for w in RET_VIEW_WINDOWS],
        "slots_per_view": views.sum(axis=1).tolist(),
        "distinct_slots": int(views.any(axis=0).sum()),
        "ms": time_ms(torch, lambda: window_merge_views(ring, views)),
        "per_view_launches_ms": time_ms(torch, lambda: [
            window_merge_kernel(ring, m) for m in views]),
        "plain_ms": time_ms(torch, lambda: torch.stack([
            window_merge(ring, m) for m in views]), reps=5, warmup=1),
        "bound_ms": b6, "bound_by": b6_by,
        "bytes": (s + len(views)) * mb4,
    }
    RESULTS["window_merge"] = {
        "max_abs_err": max_err, "ms": float(np.mean(k_all)),
        "plain_ms": one_view["plain_ms"],
        "library_ms": float(np.mean(lib_all)), "bound_ms": b_all,
        "bound_by": b_all_by,
    }
    del ring
    return {"ring": [s, RET_M, B], "ring_bytes": s * mb4, "equal": equal,
            "max_abs_err": max_err, "all_slots": one_view,
            "trailing5": five, "six_views": six, "wheel_1440": wheel}


def _raw_interval(rng, names, mu, sigma, t, seq, n):
    """One seeded backfill interval: n samples over the metrics (uniform
    ids, lognormal values with per-metric parameters) as a RawMetricSet
    of compress_np buckets, plus its counter."""
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.ops.codec import compress_np

    ids = rng.integers(0, len(names), n)
    values = rng.lognormal(mu[ids], sigma[ids])
    keys = ids.astype(np.int64) * 65536 + compress_np(values).astype(
        np.int64) + 32768
    uniq, counts = np.unique(keys, return_counts=True)
    rows = uniq >> 16
    buckets = (uniq & 0xFFFF) - 32768
    bounds = np.searchsorted(rows, np.arange(len(names) + 1))
    hists = {}
    for i, name in enumerate(names):
        lo, hi = bounds[i], bounds[i + 1]
        if hi > lo:
            hists[name] = dict(zip(buckets[lo:hi].tolist(),
                                   counts[lo:hi].tolist()))
    rates = {"requests": int(rng.integers(900, 1100))}
    return RawMetricSet(time=t, counters=dict(rates), rates=rates,
                        histograms=hists, gauges={}, duration=1.0, seq=seq)


def _cells(raw, registry):
    """A RawMetricSet's cells as (flat [M, B] index, count) int64 arrays,
    buckets clipped to +/-BL (the oracle's side of the codec)."""
    flat, counts = [], []
    for name, hist in raw.histograms.items():
        mid = registry.lookup(name)
        b = np.fromiter(hist.keys(), np.int64, len(hist))
        flat.append(mid * B + np.clip(b, -BL, BL) + BL)
        counts.append(np.fromiter(hist.values(), np.int64, len(hist)))
    if not flat:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(flat), np.concatenate(counts)


def _hist(cells_list, m):
    """Oracle histogram: the intervals' cells summed in int64 [m, B]."""
    flat = np.concatenate([c[0] for c in cells_list])
    w = np.concatenate([c[1] for c in cells_list])
    return np.bincount(flat, weights=w, minlength=m * B).astype(
        np.int64).reshape(m, B)


def _oracle_stats(hist, ps=PS):
    """dense_stats_np of an oracle histogram, with each percentile's rank
    taken by the float32 threshold rule the device keeps (the JAX
    ``dense_stats`` rule: k0 = ceil(p * total), the first of k0 - 1, k0,
    k0 + 1 with k / total >= p, all in float32) in place of the float64
    ratio.  The two rules pick neighbouring ranks at rare ties (count
    9,999 at p99.99: 9998/9999 equals float32(0.9999)); returns the stats
    and the number of (row, p) ties.  ``ps`` defaults to PS."""
    from loghisto_tpu_torch.ops.codec import decompress_np
    from loghisto_tpu_torch.ops.stats import dense_stats_np

    want = dense_stats_np(hist, ps, BL)
    cdf = np.cumsum(hist, axis=1)
    total = np.maximum(cdf[:, -1], 1)
    ps = np.asarray(ps, np.float64)
    p32 = ps.astype(np.float32)
    tot_f = total.astype(np.float32)[:, None]
    k0 = np.ceil(p32[None, :] * tot_f)
    cands = k0[:, :, None] + np.array([-1, 0, 1], np.float32)
    ok = (cands / tot_f[:, :, None] >= p32[None, :, None]) & (cands >= 1)
    best = np.where(ok, cands, np.float32(np.inf)).min(axis=2)
    k_f = np.clip(np.where(np.isfinite(best), best, k0), 1,
                  np.float32(2**31 - 256))
    k = np.minimum(k_f.astype(np.int64), total[:, None])
    k = np.where(ps[None, :] <= 0, 1,
                 np.where(ps[None, :] >= 1, total[:, None], k))
    idx = np.stack([np.searchsorted(cdf[r], k[r], side="left")
                    for r in range(len(cdf))])
    reps = decompress_np(np.arange(-BL, BL + 1))
    pct = reps[np.minimum(idx, B - 1)]
    pct[cdf[:, -1] == 0] = 0.0
    ties = int((pct != want["percentiles"]).sum())
    want["percentiles"] = pct
    return want, ties


def _check_window(res, names, want):
    """A query_window result against dense_stats_np of the oracle."""
    from loghisto_tpu_torch.window.store import pct_key

    keys = [pct_key(p) for p in PS]
    checked = 0
    for i, name in enumerate(names):
        count = int(want["counts"][i])
        if count == 0:
            assert name not in res.metrics, name
            continue
        got = res.metrics[name]
        assert got["count"] == count, name
        for key, value in zip(keys, want["percentiles"][i]):
            assert got[key] == float(np.float32(value)), (name, key)
        np.testing.assert_allclose(got["sum"], want["sums"][i], rtol=1e-5,
                                   atol=1e-3)
        checked += 1
    return checked


def phase_retention(torch):
    """The retention path through TorchMetricSystem(interval=1.0,
    num_metrics=1024, retention=True, commit="fanout") at the reference's
    defaults (DEFAULT_TIERS, bucket_limit 4096): >= 4 live
    intervals at the system's own 1 s interval (histogram_batch and
    counter through the reaper and both bridges), then 75 seeded
    intervals of 2^20 samples through backfill_retention and
    aggregator.merge_raw (past tier 0's ring wrap, closing tier 1's first
    slot); rings, queries, window_rate and device_metrics against a host
    oracle (compress_np cells summed in int64, dense_stats_np with the
    device's float32 rank rule, ``_oracle_stats``)."""
    from loghisto_tpu_torch import TorchMetricSystem
    from loghisto_tpu_torch.channel import Channel
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )

    names = [f"g{i // 64:02d}.m{i % 64:02d}" for i in range(RET_M)]
    rng = np.random.default_rng(SEED + 30)
    mu = rng.uniform(2.0, 8.0, RET_M)
    sigma = rng.uniform(0.3, 1.5, RET_M)
    ms = TorchMetricSystem(interval=1.0, num_metrics=RET_M, retention=True,
                           commit="fanout")
    wheel = ms.retention
    assert ms.commit_path == "fanout"
    assert [tuple(t) for t in wheel.tiers] == [tuple(t) for t in RET_TIERS]
    for name in names:
        ms.metric_id(name)
    windows = RET_VIEW_WINDOWS[1:]  # the full span is always a view
    for w in windows:
        wheel.pin_window(w)
    capture = Channel(256)
    ms.subscribe_to_raw_metrics(capture)

    split = collections.defaultdict(list)
    wheel._cells_from_raw = synced(torch, split, "cells_ms",
                                   wheel._cells_from_raw)
    wheel._tiers_push_locked = synced(torch, split, "scatter_clear_ms",
                                      wheel._tiers_push_locked)
    wheel._refresh_snapshot_locked = synced(torch, split, "snapshot_ms",
                                            wheel._refresh_snapshot_locked)

    reset_kernel_launches()
    # -- live: the reaper at 1 s, both bridges ------------------------------
    t_live = time.perf_counter()
    ms.start()
    deadline = time.monotonic() + 30.0
    try:
        while wheel.intervals_pushed < 5 or time.perf_counter() - t_live < 5.0:
            if time.monotonic() > deadline:
                raise AssertionError("live intervals did not arrive")
            for i, name in enumerate(names):
                ms.histogram_batch(name, rng.lognormal(mu[i], sigma[i], 16))
            ms.counter("requests", 1000)
            time.sleep(0.2)
    finally:
        ms.stop()
    live_s = time.perf_counter() - t_live
    live = []
    while len(capture):
        live.append(capture.get(block=False))
    if len(live) != wheel.intervals_pushed or len(live) < 4:
        raise AssertionError(
            f"captured {len(live)} intervals, the wheel took "
            f"{wheel.intervals_pushed}")
    if ms.aggregator.bridge_error or wheel.bridge_error:
        raise AssertionError("a bridge failed on the live intervals")
    registry = ms.aggregator.registry
    cells = [_cells(raw, registry) for raw in live]
    live_metrics = ms.device_metrics().metrics
    want, ties = _oracle_stats(_hist(cells, RET_M))
    rank_ties = {"live": ties}
    lifetime = {"count": np.zeros(RET_M, np.int64),
                "sum": np.zeros(RET_M, np.float64)}
    live_rows = _check_interval(live_metrics, names, want, lifetime,
                                exact_pcts=False)
    live_samples = int(sum(c[1].sum() for c in cells))
    for key in split:
        split[key].clear()

    # -- backfill: 75 intervals of 2^20 samples ------------------------------
    rates = [raw.rates.get("requests", 0) for raw in live]
    t_base = live[-1].time
    before = kernel_launches()
    k3_wheel = k5_wheel = 0
    merge_ms = []
    for k in range(RET_BACKFILL):
        raw = _raw_interval(rng, names, mu, sigma,
                            t_base + (k + 1) * _ONE_SECOND,
                            live[-1].seq + k + 1, RET_SAMPLES)
        a = kernel_launches()
        ms.backfill_retention([raw])
        b = kernel_launches()
        k3_wheel += b["sparse_ingest"] - a["sparse_ingest"]
        k5_wheel += b["window_merge"] - a["window_merge"]
        t0 = time.perf_counter()
        ms.aggregator.merge_raw(raw)
        torch.cuda.synchronize()
        merge_ms.append((time.perf_counter() - t0) * 1e3)
        cells.append(_cells(raw, registry))
        rates.append(raw.rates["requests"])
    n = len(cells)
    if k5_wheel != len(RET_TIERS) * RET_BACKFILL:
        raise AssertionError(
            f"{k5_wheel} K5 launches in {RET_BACKFILL} pushes: the snapshot "
            "refresh should launch one per tier for all its views")
    if k3_wheel != RET_BACKFILL:
        raise AssertionError(
            f"{k3_wheel} K3 launches in {RET_BACKFILL} pushes: one launch "
            "should scatter each push into every tier")
    backfill_metrics = ms.device_metrics().metrics
    want, rank_ties["backfill"] = _oracle_stats(_hist(cells[len(live):],
                                                      RET_M))
    backfill_rows = _check_interval(backfill_metrics, names, want, lifetime,
                                    exact_pcts=False)

    # -- rings against the oracle -------------------------------------------
    tiers = wheel._tiers
    s0 = RET_TIERS[0][0]
    for k in range(n - s0, n):
        got = tiers[0].ring[k % s0].cpu().numpy()
        if not np.array_equal(got, _hist([cells[k]], RET_M)):
            raise AssertionError(f"tier-0 slot {k % s0} != interval {k}")
    res1 = RET_TIERS[1][1]
    if not np.array_equal(tiers[1].ring[0].cpu().numpy(),
                          _hist(cells[:res1], RET_M)):
        raise AssertionError("tier 1's closed slot != its 60 intervals")
    if not np.array_equal(tiers[1].ring[1].cpu().numpy(),
                          _hist(cells[res1:], RET_M)):
        raise AssertionError("tier 1's open slot != its intervals")
    if not np.array_equal(tiers[2].ring[0].cpu().numpy(), _hist(cells, RET_M)):
        raise AssertionError("tier 2's open slot != every interval")

    # -- query timings (a fresh epoch: each first call is a serve) -----------
    ps = list(PS)
    query_ms = {}
    for rows, pattern in ((1, names[0]), (64, "g00.*"), (RET_M, "*")):
        t0 = time.perf_counter()
        res = ms.query_window(pattern, 60.0, percentiles=ps)
        query_ms[f"rows_{rows}"] = (time.perf_counter() - t0) * 1e3
        assert len(res.metrics) == rows
    t0 = time.perf_counter()
    again = ms.query_window("*", 60.0, percentiles=ps)
    query_ms["result_cache_hit"] = (time.perf_counter() - t0) * 1e3
    assert again is res
    hits0, falls0 = wheel.query_snapshot_hits, wheel.query_fallbacks

    # -- every window against the oracle; snapshot serve == recompute -------
    per_window = {}
    for w in (*windows, None):
        res = ms.query_window("*", w, percentiles=ps)
        span = n if w is None or w > s0 else int(w)
        want, rank_ties[str(w)] = _oracle_stats(_hist(cells[n - span:],
                                                      RET_M))
        rows = _check_window(res, names, want)
        t0 = time.perf_counter()
        oracle = wheel._query_recompute("*", res.window_s, tuple(ps), res.tier)
        recompute_ms = (time.perf_counter() - t0) * 1e3
        if res.metrics != oracle.metrics:
            raise AssertionError(f"window {w}: snapshot serve != recompute")
        rate = ms.window_rate("requests", w or res.window_s)
        if rate != sum(rates[n - span:]) / float(span):
            raise AssertionError(f"window {w}: window_rate {rate} differs")
        per_window[str(w)] = {"tier": res.tier, "slots": res.slots,
                              "covered_s": res.covered_s,
                              "rows_checked": rows, "rate": rate,
                              "recompute_ms": recompute_ms}
    if wheel.query_fallbacks != falls0 or wheel.query_snapshot_hits <= hits0:
        raise AssertionError("a pinned window was not served from a snapshot")
    launches = kernel_launches()
    for kernel in ("sparse_ingest", "window_merge"):
        if launches[kernel] <= 0:
            raise AssertionError(f"{kernel} was not launched on the "
                                 "retention path")
    if ms.aggregator.bridge_error or wheel.bridge_error:
        raise AssertionError("a bridge error was kept")
    RESULTS.setdefault("window_merge", {})["launches"] = launches[
        "window_merge"]
    hbm = wheel.hbm_bytes()
    assert hbm == sum(s for s, _ in RET_TIERS) * RET_M * B * 4
    # per push: one cell build, one scatter (every tier) with its clears,
    # one refresh
    mean = {k: float(np.sum(v)) / RET_BACKFILL for k, v in split.items()}
    out = {
        "num_metrics": RET_M, "tiers": [list(t) for t in RET_TIERS],
        "commit_path": ms.commit_path, "hbm_bytes": hbm,
        "live": {"intervals": len(live), "wall_s": live_s,
                 "samples": live_samples, "rows_checked": live_rows},
        "backfill": {"intervals": RET_BACKFILL, "samples_each": RET_SAMPLES,
                     "rows_checked": backfill_rows,
                     "merge_raw_ms": float(np.mean(merge_ms))},
        "intervals_pushed": wheel.intervals_pushed,
        "push_ms": {**mean, "total_ms": sum(mean.values())},
        "launches_per_push": {"sparse_ingest": k3_wheel / RET_BACKFILL,
                              "window_merge": k5_wheel / RET_BACKFILL},
        "views_per_tier": 1 + len(wheel.pinned_windows()),
        "query_ms": query_ms, "windows": per_window,
        "rank_ties_vs_float64_rule": rank_ties,
        "launches": launches,
        "bridge_errors": [repr(ms.aggregator.bridge_error),
                          repr(wheel.bridge_error)],
    }
    del ms, wheel, tiers
    torch.cuda.empty_cache()
    return out


# -- lifecycle and drift (K6, K7) --------------------------------------------


def _holey_perm(rng, m):
    """A shuffle of m rows with ~40% holes: -1, DROP_ID and out-of-range
    entries mixed."""
    from loghisto_tpu_torch.ops.commit import DROP_ID

    perm = rng.permutation(m).astype(np.int64)
    holes = rng.random(m) < 0.4
    perm[holes] = rng.choice(np.array([-1, int(DROP_ID), m, m + 12345]),
                             int(holes.sum()))
    return perm.astype(np.int32)


def phase_k6(torch):
    """K6 against its plain version (torch.equal) on the accumulator
    [1024, 8193], the tier-0 ring [60, 1024, 8193], a float32 bank
    [24, 1024, 8193] and an odd [7, 999, 8193] ring, each through a
    permutation with ~40% holes."""
    from loghisto_tpu_torch.ops.lifecycle import (
        compact_rows,
        compact_rows_kernel,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    rng = np.random.default_rng(SEED + 7)
    shapes = {
        "acc": (RET_M, B), "tier0_ring": (RET_TIERS[0][0], RET_M, B),
        "bank_f32": (LD_BANKS, RET_M, B), "odd_ring": (7, 999, B),
    }
    equal, timings, holes = {}, {}, {}
    for name, shape in shapes.items():
        if name == "bank_f32":
            arr = torch.rand(shape, device=dev, generator=gen)
        else:
            arr = torch.randint(-(1 << 20), 1 << 20, shape, dtype=torch.int32,
                                device=dev, generator=gen)
        m = shape[-2]
        perm = _holey_perm(rng, m)
        holes[name] = float(1.0 - ((perm >= 0) & (perm < m)).mean())
        got = compact_rows_kernel(arr, perm)
        want = compact_rows(arr, perm)
        torch.cuda.synchronize()
        equal[name] = bool(torch.equal(got, want))
        if not equal[name]:
            raise AssertionError(
                f"K6 differs from its plain version on {name}: "
                f"{int((got != want).sum())} elements")
        del got, want
        if name in ("acc", "tier0_ring"):
            perm_d = torch.from_numpy(perm).to(dev)
            axis = arr.ndim - 2
            live = int(((perm >= 0) & (perm < m)).sum())
            slots = 1 if arr.ndim == 2 else shape[0]
            padded = torch.cat([arr, torch.zeros_like(arr.narrow(axis, 0, 1))],
                               dim=axis)
            idx = torch.where((perm_d >= 0) & (perm_d < m), perm_d,
                              m).long()
            b_ms, b_by = bound_ms((m + live) * slots * B * 4 + m * 4)
            timings[name] = {
                "ms": time_ms(torch, lambda: compact_rows_kernel(arr, perm_d)),
                "plain_ms": time_ms(torch, lambda: compact_rows(arr, perm_d),
                                    reps=5, warmup=1),
                "library_ms": time_ms(torch, lambda: padded.index_select(
                    axis, idx)),
                "bound_ms": b_ms, "bound_by": b_by, "live_rows": live,
            }
            del padded
        del arr
        torch.cuda.empty_cache()
    t = timings["tier0_ring"]
    RESULTS["compact_rows"] = {
        "max_abs_err": 0,
        **{k: t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                             "bound_by")}}
    return {"shapes": {k: list(v) for k, v in shapes.items()},
            "hole_share": holes, "equal": equal, "max_abs_err": 0,
            "timings": timings,
            "library_call": "x.index_select(row_axis, idx) on a copy with a "
                            "zero row appended for the holes"}


# K7's tolerance against its plain version (tests/test_torch_anomaly.py
# states the reason of each): ks atol, jsd atol, emd rtol + B * 2^-23
K7_TOL = {"ks": (0.0, 2e-6), "jsd": (0.0, 1e-5), "emd": (1e-4, B * 2.0**-23)}
# the float64 oracle: float32 scores of 8193-bucket rows
K7_ORACLE_TOL = {"ks": (0.0, 1e-5), "jsd": (0.0, 2e-5), "emd": (1e-4, 1e-2)}


def _drift_inputs(torch, m, gen, min_samples):
    """Seeded drift inputs on the card: each live row a Gaussian bump in
    bucket space with Poisson counts, each baseline a shifted bump as a
    pmf times its weight (bank 1 of 2); edge rows 0..3: count 0, weight
    0, a one-hot live pmf, identical live and baseline shapes."""
    dev = torch.device("cuda")
    cols = torch.arange(B, device=dev, dtype=torch.float32)

    def bumps(center, width):
        g = torch.exp(-0.5 * ((cols - center[:, None]) / width[:, None]) ** 2)
        g = torch.where(g < 1e-30, torch.zeros_like(g), g)  # no subnormals
        return g / g.sum(dim=1, keepdim=True)

    center = BL + 200 + torch.rand(m, device=dev, generator=gen) * 2500
    width = 10 + torch.rand(m, device=dev, generator=gen) * 200
    size = 50 + torch.rand(m, device=dev, generator=gen) * 2e5
    bins = torch.poisson(bumps(center, width) * size[:, None],
                         generator=gen).to(torch.int32)
    base = bumps(center + torch.randn(m, device=dev, generator=gen) * 40,
                 width * (0.8 + 0.4 * torch.rand(m, device=dev,
                                                 generator=gen)))
    w = 0.1 + 0.9 * torch.rand(m, device=dev, generator=gen)
    bins[0] = 0
    bins[2] = 0
    bins[2, BL + 900] = 5000
    bins[3] = torch.poisson(base[3] * 1e5, generator=gen).to(torch.int32)
    base[3] = bins[3].float() / bins[3].sum()
    w[1], w[3] = 0.0, 1.0
    prof = torch.zeros((2, m, B), device=dev)
    wsum = torch.zeros((2, m), device=dev)
    prof[1] = base * w[:, None]
    wsum[1] = w
    cdf = torch.cumsum(bins, dim=1, dtype=torch.int32)
    counts = cdf[:, -1].contiguous()
    assert int(counts[4:].min()) >= min_samples
    return cdf, counts, prof, wsum


def _oracle_divergence(cdf, counts, prof, w, min_samples):
    """KS / JSD / EMD in float64 NumPy, from the same inputs."""
    tot = np.maximum(counts, 1).astype(np.float64)[:, None]
    live_cdf = cdf / tot
    bins = np.diff(cdf.astype(np.int64), axis=1, prepend=0)
    live_pmf = bins / tot
    base_pmf = prof.astype(np.float64) / np.maximum(
        w.astype(np.float64), 1e-30)[:, None]
    diff = np.abs(live_cdf - np.cumsum(base_pmf, axis=1))
    mid = 0.5 * (live_pmf + base_pmf)
    with np.errstate(divide="ignore", invalid="ignore"):
        kl = [np.where(p > 0, p * np.log2(p / mid), 0.0).sum(axis=1)
              for p in (live_pmf, base_pmf)]
    valid = (counts >= min_samples) & (w > 0)
    out = {"ks": diff.max(axis=1), "jsd": 0.5 * (kl[0] + kl[1]),
           "emd": diff.sum(axis=1)}
    return {k: np.where(valid, v, 0.0) for k, v in out.items()}


def _close(got, want, tol):
    """Max error of each score and whether all lie within tol."""
    out, ok = {}, True
    for key, (rtol, atol) in tol.items():
        g, w = np.asarray(got[key], np.float64), np.asarray(want[key],
                                                            np.float64)
        err = np.abs(g - w)
        out[key] = float(err.max())
        ok &= bool((err <= atol + rtol * np.abs(w)).all())
    return out, ok


def phase_k7(torch):
    """K7 against its plain version within K7_TOL at 1024 x 8193 and
    1000 x 8193 (edge rows: count 0, weight 0, one-hot pmf, identical
    shapes; masked rows exactly 0), and 64 rows against a float64 NumPy
    oracle."""
    from loghisto_tpu_torch.ops.anomaly import (
        divergence_kernel,
        divergence_plain,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 8)
    min_samples = 64
    out, ok, timings = {}, True, {}
    for m in (RET_M, 1000):
        cdf, counts, prof, wsum = _drift_inputs(torch, m, gen, min_samples)
        args = (cdf, counts, prof[1], wsum[1], min_samples)
        got = divergence_kernel(*args)
        want = divergence_plain(*args)
        torch.cuda.synchronize()
        got = {k: v.cpu().numpy() for k, v in got.items()}
        want = {k: v.cpu().numpy() for k, v in want.items()}
        errs, close = _close(got, want, K7_TOL)
        masked_zero = all(got[k][i] == 0.0 and want[k][i] == 0.0
                          for k in got for i in (0, 1))
        out[str(m)] = {"max_err": errs, "within_tol": close,
                       "masked_rows_zero": masked_zero,
                       "identical_row_ks": float(got["ks"][3]),
                       "one_hot_row": {k: float(got[k][2]) for k in got}}
        ok &= close and masked_zero and got["ks"][3] < 1e-5
        if m == RET_M:
            rows = 64
            oracle = _oracle_divergence(
                cdf[:rows].cpu().numpy(), counts[:rows].cpu().numpy(),
                prof[1, :rows].cpu().numpy(), wsum[1, :rows].cpu().numpy(),
                min_samples)
            oerr, oclose = _close({k: v[:rows] for k, v in got.items()},
                                  oracle, K7_ORACLE_TOL)
            out["oracle_64_rows"] = {"max_err": oerr, "within_tol": oclose}
            ok &= oclose
            unmasked = int(((counts >= min_samples) & (wsum[1] > 0)).sum())
            b_ms, b_by = bound_ms(unmasked * B * 8 + m * 20)
            timings = {
                "ms": time_ms(torch, lambda: divergence_kernel(*args)),
                "paced_ms": time_ms(
                    torch, lambda: divergence_kernel(*args), hold=False),
                "plain_ms": time_ms(torch, lambda: divergence_plain(*args)),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            }
            RESULTS["divergence"] = {"max_abs_err": max(errs.values()),
                                     **timings}
        del cdf, counts, prof, wsum
    if not ok:
        raise AssertionError(f"K7 outside its tolerance: {out}")
    return {"B": B, "tolerance": K7_TOL, "oracle_tolerance": K7_ORACLE_TOL,
            "checks": out, **timings,
            "library_call": "none: no single PyTorch call computes the "
                            "three scores"}


def _ld_interval(rng, names, mu, sigma, weight, bimodal, t, seq, n):
    """One seeded interval of the churn workload: n lognormal samples
    over ``names`` (ids drawn with ``weight``), 40% of the samples of
    ``bimodal`` ids at 8x; returned as a RawMetricSet of compress_np
    buckets and as per-name totals."""
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.ops.codec import compress_np

    ids = rng.choice(len(names), n, p=weight / weight.sum())
    values = rng.lognormal(mu[ids], sigma[ids])
    if len(bimodal):
        hit = np.isin(ids, bimodal) & (rng.random(n) < 0.4)
        values[hit] *= 8.0
    keys = ids.astype(np.int64) * 65536 + compress_np(values).astype(
        np.int64) + 32768
    uniq, counts = np.unique(keys, return_counts=True)
    rows = uniq >> 16
    buckets = (uniq & 0xFFFF) - 32768
    bounds = np.searchsorted(rows, np.arange(len(names) + 1))
    hists = {}
    for i, name in enumerate(names):
        lo, hi = bounds[i], bounds[i + 1]
        if hi > lo:
            hists[name] = dict(zip(buckets[lo:hi].tolist(),
                                   counts[lo:hi].tolist()))
    return RawMetricSet(time=t, counters={}, rates={}, histograms=hists,
                        gauges={}, duration=1.0, seq=seq)


def _dense_hist(hist):
    """A sparse bucket dict as a dense int64 [B] row (clipped)."""
    row = np.zeros(B, np.int64)
    if hist:
        b = np.fromiter(hist.keys(), np.int64, len(hist))
        np.add.at(row, np.clip(b, -BL, BL) + BL,
                  np.fromiter(hist.values(), np.int64, len(hist)))
    return row


def _snapshot_rows(torch, ms, ids):
    """Every carry's rows at ``ids`` (device copies)."""
    idx = torch.as_tensor(ids, dtype=torch.long, device="cuda")
    an, lc = ms.anomaly, ms.lifecycle
    return {
        "acc": ms.aggregator._acc.index_select(0, idx),
        "rings": [t.ring.index_select(1, idx) for t in ms.retention._tiers],
        "prof": an._prof.index_select(1, idx),
        "wsum": an._wsum.index_select(1, idx),
        "ihist": an._ihist.index_select(0, idx),
        "la": lc._la.index_select(0, idx),
    }


def _compact_checked(torch, ms):
    """One compaction, with every survivor's rows (accumulator, rings,
    banks, interval histogram, activity) equal by name across it and
    the freed rows zero.  Returns (rows moved, live rows)."""
    reg = ms.aggregator.registry
    if ms.aggregator.num_metrics != ms.retention.num_metrics:
        raise AssertionError("the row space grew past the wheel's rows")
    live = [(m, n) for m, n in enumerate(reg.names()) if n is not None]
    before = _snapshot_rows(torch, ms, [m for m, _ in live])
    moved = sum(1 for new, (old, _) in enumerate(live) if new != old)
    if not ms.lifecycle.compact():
        raise AssertionError("compaction did not run")
    new_ids = [reg.lookup(n) for _, n in live]
    if new_ids != list(range(len(live))):
        raise AssertionError("survivors are not the dense prefix")
    after = _snapshot_rows(torch, ms, new_ids)
    for key in ("acc", "prof", "wsum", "ihist", "la"):
        if not torch.equal(before[key], after[key]):
            raise AssertionError(f"compaction changed survivors' {key} rows")
    for a, b in zip(before["rings"], after["rings"]):
        if not torch.equal(a, b):
            raise AssertionError("compaction changed survivors' ring rows")
    n = len(live)
    agg, an = ms.aggregator, ms.anomaly
    freed_zero = (not agg._acc[n:].any() and not an._prof[:, n:].any()
                  and not an._wsum[:, n:].any() and not an._ihist[n:].any()
                  and all(not t.ring[:, n:].any()
                          for t in ms.retention._tiers))
    if not freed_zero:
        raise AssertionError("freed rows are not zero after compaction")
    return moved, n


def phase_lifecycle_drift(torch):
    """The fused commit with lifecycle and drift scoring:
    TorchMetricSystem(interval=1.0, num_metrics=1024, retention=True,
    lifecycle=LifecycleConfig(ttl_intervals=2, check_every=1,
    auto_compact_fragmentation=0.0), anomaly=AnomalyConfig(banks=24,
    bank_of=hourly_bank, decay=0.97, min_samples=64, window=6.0)) under
    the reference's churn workload (benchmarks/cardinality_churn.py):
    512 steady svc.<k>.latency names and 96 fresh api.u<uid>.lat names
    per interval, 2^20 lognormal samples per backfilled interval.  From
    interval 40, 8 steady names turn bimodal (40% of samples at 8x) and
    8 others take 4x the samples in the same shape.  5 live intervals
    through the reaper and the committer, then 75 through
    backfill_retention (the last 4 bring no fresh names, so the final
    snapshot survives the last lifecycle tick); compaction every 8
    intervals."""
    from loghisto_tpu_torch import TorchMetricSystem
    from loghisto_tpu_torch.anomaly import AnomalyConfig, hourly_bank
    from loghisto_tpu_torch.channel import Channel
    from loghisto_tpu_torch.lifecycle import LifecycleConfig
    from loghisto_tpu_torch.ops import anomaly as an_mod
    from loghisto_tpu_torch.ops import lifecycle as lc_mod
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )
    from loghisto_tpu_torch.ops.commit import COMMIT_CHUNK
    from loghisto_tpu_torch.window import DistributionDriftRule

    rng = np.random.default_rng(SEED + 40)
    steady = [f"svc.{k}.latency" for k in range(LD_STEADY)]
    mu_s = rng.uniform(2.0, 6.0, LD_STEADY)
    sigma_s = rng.uniform(0.3, 1.0, LD_STEADY)
    shift_ids = np.arange(100, 108)
    surge_ids = np.arange(200, 208)
    # the watched names get a typical service-latency spread
    sigma_s[shift_ids] = sigma_s[surge_ids] = 0.4
    ewma_ids = np.arange(64)
    decay = np.float32(0.97)
    min_samples = 64
    ms = TorchMetricSystem(
        interval=1.0, num_metrics=RET_M, retention=True,
        lifecycle=LifecycleConfig(ttl_intervals=2, check_every=1,
                                  auto_compact_fragmentation=0.0),
        anomaly=AnomalyConfig(banks=LD_BANKS, bank_of=hourly_bank,
                              decay=float(decay), min_samples=min_samples,
                              window=6.0))
    agg, wheel, com, lc, an = (ms.aggregator, ms.retention, ms.committer,
                               ms.lifecycle, ms.anomaly)
    if ms.commit_path != "fused":
        raise AssertionError(f"commit path {ms.commit_path}")
    for name in steady:
        ms.metric_id(name)
    wheel.pin_window(60.0)
    rules = {
        "bimodal": ms.add_rule(DistributionDriftRule(
            "drift_bimodal", steady[shift_ids[0]], stat="jsd",
            threshold=0.05, for_intervals=2)),
        "surge": ms.add_rule(DistributionDriftRule(
            "drift_surge", steady[surge_ids[0]], stat="jsd",
            threshold=0.05, for_intervals=2)),
    }
    capture = Channel(256)
    ms.subscribe_to_raw_metrics(capture)

    # timers around the functions the path calls (each runs unchanged)
    split = collections.defaultdict(list)
    timers = _Timers(torch)
    com._cells_from_raw = synced(torch, split, "cells_ms",
                                 com._cells_from_raw)
    com._fused_dispatch_locked = synced(torch, split, "device_ms",
                                        com._fused_dispatch_locked)
    lc.evict_ids = synced(torch, split, "evict_ms", lc.evict_ids)
    lc.compact = synced(torch, split, "compact_ms", lc.compact)
    an.score_now = synced(torch, split, "score_ms", an.score_now)
    saved = (lc_mod.compact_rows_kernel, an_mod.compact_rows_kernel,
             an_mod.divergence_kernel)
    lc_mod.compact_rows_kernel = timers.dev_wrap("k6", saved[0])
    an_mod.compact_rows_kernel = timers.dev_wrap("k6", saved[1])
    an_mod.divergence_kernel = timers.dev_wrap("k7", saved[2])

    # host oracle state
    samples = collections.Counter()   # name -> samples committed
    steady_cells = collections.deque(maxlen=60)  # per interval [512, B]
    ewma = {}                         # bank -> (prof [64, B], w [64]) f64
    gain = float(np.float32(1.0) - decay)

    def account(raw):
        for name, h in raw.histograms.items():
            samples[name] += int(sum(h.values()))
        dense = np.zeros((LD_STEADY, B), np.int32)
        for i, name in enumerate(steady):
            h = raw.histograms.get(name)
            if h:
                dense[i] = _dense_hist(h)
        steady_cells.append(dense)
        bank = raw.time.hour % LD_BANKS
        prof, w = ewma.setdefault(bank, (np.zeros((len(ewma_ids), B)),
                                         np.zeros(len(ewma_ids))))
        rows = dense[ewma_ids]
        cnt = rows.sum(axis=1)
        upd = cnt >= min_samples
        pmf = rows / np.maximum(cnt, 1)[:, None]
        prof[upd] = float(decay) * prof[upd] + gain * pmf[upd]
        w[upd] = float(decay) * w[upd] + gain

    reset_kernel_launches()
    rows_checked = {"num_metrics": []}
    # -- live: the reaper at 1 s, the committer's bridge ----------------------
    t_live = time.perf_counter()
    ms.start()
    deadline = time.monotonic() + 30.0
    c = 0
    try:
        while com.intervals_committed < LD_LIVE or \
                time.perf_counter() - t_live < 5.0:
            if time.monotonic() > deadline:
                raise AssertionError("live intervals did not arrive")
            for i, name in enumerate(steady):
                ms.histogram_batch(name, rng.lognormal(mu_s[i], sigma_s[i],
                                                       16))
            for _ in range(max(1, LD_FRESH // 6)):  # ~LD_FRESH a second
                ms.histogram_batch(f"api.live{c}.lat",
                                   rng.lognormal(3.0, 0.5, 16))
                c += 1
            time.sleep(0.2)
    finally:
        ms.stop()
    live = []
    while len(capture):
        live.append(capture.get(block=False))
    if len(live) != com.intervals_committed:
        raise AssertionError(f"captured {len(live)} intervals, the committer "
                             f"took {com.intervals_committed}")
    for raw in live:
        account(raw)
    live_s = time.perf_counter() - t_live
    n_live = len(live)

    # -- backfill: the churn workload --------------------------------------------
    hour = (live[-1].time + _dt.timedelta(hours=1)).replace(
        minute=0, second=0, microsecond=0)
    fired_at, early, surge_fired, dispatch_ok = None, [], False, True
    jsd_seen = {key: [] for key in rules}  # each rule's value per interval
    commit_ms, per_interval = [], []
    k3_chunks = [0, 0]  # K3 launches, commit chunks of the backfill
    compactions = []
    uid = 0
    for k in range(LD_BACKFILL):
        g = n_live + k  # global interval index
        fresh = [] if k >= LD_BACKFILL - 4 else [
            f"api.u{uid + j}.lat" for j in range(LD_FRESH)]
        uid += len(fresh)
        names = steady + fresh
        mu = np.concatenate([mu_s, rng.uniform(2.0, 6.0, len(fresh))])
        sigma = np.concatenate([sigma_s, rng.uniform(0.3, 1.0, len(fresh))])
        weight = np.ones(len(names))
        bimodal = np.zeros(0, np.int64)
        if g >= LD_SHIFT_AT:
            weight[surge_ids] = 4.0
            bimodal = shift_ids
        raw = _ld_interval(rng, names, mu, sigma, weight, bimodal,
                           hour + k * _ONE_SECOND, live[-1].seq + k + 1,
                           RET_SAMPLES)
        cells = sum(len(h) for h in raw.histograms.values())
        torch.cuda.synchronize()
        k3_before = kernel_launches()["sparse_ingest"]
        t0 = time.perf_counter()
        ms.backfill_retention([raw])
        torch.cuda.synchronize()
        commit_ms.append((time.perf_counter() - t0) * 1e3)
        k3_chunks[0] += kernel_launches()["sparse_ingest"] - k3_before
        k3_chunks[1] += com.last_dispatches
        account(raw)
        dispatch_ok &= com.last_dispatches == -(-cells // COMMIT_CHUNK)
        rows_checked["num_metrics"].append(agg.num_metrics)
        active = ms.rule_engine.active()
        for key, rule in rules.items():
            jsd_seen[key].append(rule.last_value)
        if "drift_bimodal" in active:
            if g < LD_SHIFT_AT:
                early.append(g)
            elif fired_at is None:
                fired_at = g
        surge_fired |= "drift_surge" in active
        per_interval.append({"cells": cells, "live_rows":
                             agg.registry.live_count(),
                             "evicted_total": lc.evicted_series})
        if (g + 1) % LD_COMPACT_EVERY == 0:
            compactions.append(_compact_checked(torch, ms))
    torch.cuda.synchronize()
    lc_mod.compact_rows_kernel, an_mod.compact_rows_kernel, \
        an_mod.divergence_kernel = saved
    launches = kernel_launches()
    committed = n_live + LD_BACKFILL

    # -- checks ----------------------------------------------------------------
    reg = agg.registry
    if com.fused_intervals != committed or com.fanout_intervals:
        raise AssertionError(f"fused {com.fused_intervals}, fanout "
                             f"{com.fanout_intervals} of {committed}")
    if not dispatch_ok:
        raise AssertionError("last_dispatches != ceil(cells / COMMIT_CHUNK)")
    if k3_chunks[0] != k3_chunks[1]:
        raise AssertionError(f"{k3_chunks[0]} K3 launches for {k3_chunks[1]} "
                             "commit chunks: one launch should take every "
                             "target of a chunk")
    if set(rows_checked["num_metrics"]) != {RET_M}:
        raise AssertionError("the row space grew")
    acc_rows = agg._acc.sum(dim=1, dtype=torch.int64).cpu().numpy()
    if int(acc_rows.sum()) != sum(samples.values()):
        raise AssertionError("accumulator total != samples committed")
    names_now = reg.names()
    evicted = [n for n in samples if reg.lookup(n) is None]
    for m_id, name in enumerate(names_now):
        if name is not None and not name.startswith("_overflow.") and \
                int(acc_rows[m_id]) != samples[name]:
            raise AssertionError(f"{name}: row total != samples committed")
    overflow = {n: int(acc_rows[m]) for m, n in enumerate(names_now)
                if n is not None and n.startswith("_overflow.")}
    api_evicted = sum(samples[n] for n in evicted if n.startswith("api."))
    if overflow.get("_overflow.api") != api_evicted:
        raise AssertionError("_overflow.api != the evicted api samples")
    if sum(overflow.values()) != lc.overflowed_samples:
        raise AssertionError("overflow rows != lifecycle.overflowed_samples")
    # windows over the steady names against the oracle; snapshot serve ==
    # recompute; evicted names absent
    windows = {}
    for w in (6.0, 60.0):
        hist = np.sum(list(steady_cells)[-int(w):], axis=0, dtype=np.int64)
        want, ties = _oracle_stats(hist)
        res = ms.query_window("svc.*", w, percentiles=list(PS))
        rows = _check_window(res, steady, want)
        full = ms.query_window("*", w, percentiles=list(PS))
        oracle = wheel._query_recompute("*", full.window_s, tuple(PS),
                                        full.tier)
        if full.metrics != oracle.metrics:
            raise AssertionError(f"window {w}: snapshot serve != recompute")
        if set(full.metrics) & set(evicted):
            raise AssertionError(f"window {w} serves evicted names")
        windows[str(w)] = {"rows_checked": rows, "rank_ties": ties,
                           "served_rows": len(full.metrics)}
    # EWMA banks of 64 steady rows against the float64 host EWMA
    ids = [reg.lookup(steady[i]) for i in ewma_ids]
    ewma_err = 0.0
    for bank, (prof, w) in ewma.items():
        got_p = an._prof[bank, ids].double().cpu().numpy()
        got_w = an._wsum[bank, ids].double().cpu().numpy()
        np.testing.assert_allclose(got_p, prof, rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(got_w, w, rtol=1e-5, atol=1e-9)
        ewma_err = max(ewma_err, float(np.abs(got_p - prof).max()))
    if fired_at is None or fired_at >= LD_SHIFT_AT + 8:
        raise AssertionError(f"the bimodal drift rule fired at {fired_at}")
    if surge_fired:
        raise AssertionError("the rate-surge drift rule fired")
    if an.scored_intervals != committed:
        raise AssertionError(f"scored {an.scored_intervals} of {committed}")
    for kernel in ("sparse_ingest", "window_merge", "compact_rows",
                   "divergence"):
        if launches[kernel] <= 0:
            raise AssertionError(f"{kernel} was not launched on the "
                                 "lifecycle/drift path")
    if com.bridge_error or agg.bridge_error or wheel.bridge_error:
        raise AssertionError("a bridge error was kept")
    for kernel in ("compact_rows", "divergence"):
        RESULTS.setdefault(kernel, {})["launches"] = launches[kernel]

    bf = LD_BACKFILL
    k6_ms = [a.elapsed_time(b) for a, b in timers.events["k6"]]
    k7_ms = [a.elapsed_time(b) for a, b in timers.events["k7"]]
    out = {
        "num_metrics": RET_M, "tiers": [list(t) for t in RET_TIERS],
        "commit_path": ms.commit_path, "live_intervals": n_live,
        "live_wall_s": live_s, "backfill_intervals": bf,
        "samples_per_interval": RET_SAMPLES, "intervals_committed": committed,
        "fused_intervals": com.fused_intervals,
        "fanout_intervals": com.fanout_intervals,
        "cells_per_interval": float(np.mean([p["cells"]
                                             for p in per_interval])),
        "live_rows_max": max(p["live_rows"] for p in per_interval),
        "evicted_series": lc.evicted_series, "evictions": lc.evictions,
        "overflowed_samples": lc.overflowed_samples, "overflow_rows": overflow,
        "compactions": [{"moved_rows": a, "live_rows": b}
                        for a, b in compactions],
        "windows": windows, "ewma_max_abs_err": ewma_err,
        "ewma_banks_checked": sorted(ewma), "drift_fired_at": fired_at,
        "drift_firing_before_shift": early,
        "shift_at": LD_SHIFT_AT,
        "rule_jsd_from_shift": {k: v[LD_SHIFT_AT - n_live:]
                                for k, v in jsd_seen.items()},
        "rule_jsd_max_before_shift": {
            k: max((x or 0.0) for x in v[:LD_SHIFT_AT - n_live])
            for k, v in jsd_seen.items()},
        "scored_intervals": an.scored_intervals,
        "ms_per_interval": {
            "commit_total": float(np.mean(commit_ms[-bf:])),
            "host_cells": float(np.mean(split["cells_ms"][-bf:])),
            "device_commit": float(np.mean(split["device_ms"][-bf:])),
            "scoring": float(np.mean(split["score_ms"][-bf:])),
            "k7_in_scoring": float(np.mean(k7_ms[-bf:])),
            "eviction": float(np.sum(split["evict_ms"])) / committed,
            "eviction_per_batch": float(np.mean(split["evict_ms"])),
        },
        "compaction_ms": split["compact_ms"],
        "k6_ms_per_compaction": float(np.sum(k6_ms)) / max(1, len(
            split["compact_ms"])),
        "k6_launches_per_compaction": len(k6_ms) / max(1, len(
            split["compact_ms"])),
        "launches": launches,
        "launches_per_interval": {k: v / committed
                                  for k, v in launches.items() if v},
        "k3_launches_per_chunk": k3_chunks[0] / max(1, k3_chunks[1]),
        "hbm_bytes": {"rings": wheel.hbm_bytes(),
                      "banks": an._prof.numel() * 4 + an._wsum.numel() * 4,
                      "acc": agg._acc.numel() * 4,
                      "ihist": an._ihist.numel() * 4,
                      "max_allocated": torch.cuda.max_memory_allocated()},
    }
    del ms, agg, wheel, com, lc, an
    torch.cuda.empty_cache()
    return out


# -- paged lifecycle and the paged fused commit -------------------------------

# TorchMetricSystem at PAGED_MIN_METRICS rows, where storage="auto" pages,
# with the reference's tiers for the paged fused commit
# (benchmarks/mesh_paged.py:68) and its churn lifecycle
# (benchmarks/cardinality_churn.py:91-97, :108-117, :127-128)
PL_M = 1 << 16
PL_POOL = 1 << 20
PL_TIERS = ((8, 1), (4, 8))
# 2^15 - 1 steady names: while an interval commits, the row space holds
# them, four fresh batches (ttl 2 keeps three past the tick; the fourth
# registers before it) and _overflow.api, 2^16 rows exactly
PL_STEADY = (1 << 15) - 1
PL_FRESH = 1 << 13
PL_SAMPLES = 1 << 20
PL_INTERVALS = 24
PL_COMPACT_EVERY = 4
PL_K4F_AFTER = (0, 21, 23, 24)  # K4f batches after these intervals
PL_PS = (0.5, 0.99, 0.9999)
PL_SAMPLED = 256      # whole ring rows compared with the dense twin
PL_QUERIED = 8192     # survivors queried across each compaction
PL_KEY = 1 << 14      # oracle key: name index * PL_KEY + dense bucket


def _pl_stream(k, mu, sigma, steady, fresh, samples, t0):
    """Interval k of the churn stream, from its own seed: ``samples``
    lognormal samples over the steady names api.s<i>.lat (mu, sigma per
    row) and ``fresh`` new names api.u<uid>.lat with one uniform bucket
    and a count of 1-7 each.  Returns the RawMetricSet and its cells as
    (name index, dense bucket, count) oracle keys: steady name i is
    index i, fresh uid u is steady + u."""
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.ops.codec import compress_np

    rng = np.random.default_rng((SEED, 60, k))
    ids = rng.integers(0, steady, samples)
    buckets = np.clip(compress_np(rng.lognormal(mu[ids], sigma[ids])),
                      -BL, BL).astype(np.int64)
    uniq, counts = np.unique(ids * PL_KEY + buckets + BL, return_counts=True)
    rows, dense = uniq // PL_KEY, uniq % PL_KEY
    bounds = np.searchsorted(rows, np.arange(steady + 1))
    hists = {}
    for i in range(steady):
        lo, hi = bounds[i], bounds[i + 1]
        if hi > lo:
            hists[f"api.s{i}.lat"] = dict(zip(
                (dense[lo:hi] - BL).tolist(), counts[lo:hi].tolist()))
    f_b = rng.integers(-BL, BL, fresh)
    f_c = rng.integers(1, 8, fresh)
    uid0 = k * fresh
    for j, (b, c) in enumerate(zip(f_b.tolist(), f_c.tolist())):
        hists[f"api.u{uid0 + j}.lat"] = {b: c}
    keys = np.concatenate([
        uniq, (steady + uid0 + np.arange(fresh)) * PL_KEY + f_b + BL])
    raw = RawMetricSet(time=t0 + k * _ONE_SECOND, counters={}, rates={},
                       histograms=hists, gauges={}, duration=1.0, seq=k + 1)
    return raw, keys, np.concatenate([counts, f_c]).astype(np.int64)


def _pl_ring_digests(torch, rings, rows=4096):
    """Per (slot, row) int64 count and sum of bucket x count of each
    ring, computed on the ring's device a row block at a time."""
    out = []
    for ring in rings:
        w = torch.arange(ring.shape[2], device=ring.device,
                         dtype=torch.int64)
        cnt, wsum = [], []
        for m0 in range(0, ring.shape[1], rows):
            sub = ring[:, m0:m0 + rows].to(torch.int64)
            cnt.append(sub.sum(dim=2))
            wsum.append((sub * w).sum(dim=2))
            del sub
        out.append((torch.cat(cnt, 1).cpu().numpy(),
                    torch.cat(wsum, 1).cpu().numpy()))
    return out


def _pl_pool_cells(store, pool):
    """The nonzero cells of ``pool`` (the store's pool or a difference of
    it) under the store's page table and codecs, as sorted unique
    (row * B + dense bucket) keys and int64 counts."""
    rows, idx, counts = store._decode_pool_cells(pool)
    return _pl_sum_keys(rows * B + idx, counts)


def _pl_sum_keys(keys, counts):
    uniq, inv = np.unique(keys, return_inverse=True)
    return uniq, np.bincount(inv.reshape(-1), weights=counts,
                             minlength=len(uniq)).astype(np.int64)


def _pl_encoded(store, rows, dense, counts):
    """Oracle cells under each row's codec (encode, then the decode
    LUT's representative), summed per (row, bucket)."""
    codec = store.row_codec[rows].astype(np.int64)
    if (codec < 0).any():
        raise AssertionError("an oracle row has no codec")
    cell = store._dec[codec, store._enc[codec, dense]]
    return _pl_sum_keys(rows * B + cell, counts)


def _pl_same(got, want, what):
    if not (np.array_equal(got[0], want[0])
            and np.array_equal(got[1], want[1])):
        raise AssertionError(f"{what}: cells differ from the oracle")


def _drop_system(torch, ms):
    """Stop a TorchMetricSystem and free its device state by hand (the
    timers' wrappers can hold it in reference cycles)."""
    ms.stop()
    wheel, agg = ms.retention, ms.aggregator
    for t in wheel._tiers:
        t.ring = None
    if agg.paged is not None:
        agg.paged._pool = None
    agg._acc = agg.stats_snapshot = None
    if ms.lifecycle is not None:
        ms.lifecycle._la = None
    if ms.anomaly is not None:
        ms.anomaly._prof = ms.anomaly._wsum = None
    wheel.invalidate_snapshot_locked()
    gc.collect()
    if agg.device.type == "cuda":
        torch.cuda.empty_cache()


def _pl_run(torch, dev, storage, m, pool, steady, fresh, samples,
            intervals, k4f_after):
    """One run of the churn stream through TorchMetricSystem(storage=...,
    retention=PL_TIERS, lifecycle=...): backfill_retention per interval
    (the committer, then the lifecycle tick), compact() every
    PL_COMPACT_EVERY intervals.  On paged storage it checks conservation
    after every interval, the survivors across every compaction, the
    pool against the host oracle at the end and a K4f batch after each
    interval in ``k4f_after``; it returns what the dense twin is held
    to."""
    from loghisto_tpu_torch import TorchMetricSystem
    from loghisto_tpu_torch.lifecycle import LifecycleConfig
    from loghisto_tpu_torch.ops import lifecycle as lc_mod
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )
    from loghisto_tpu_torch.ops.codec import compress_np
    from loghisto_tpu_torch.paging import PagedStoreConfig
    from loghisto_tpu_torch.window.store import pct_key

    on_card = dev == "cuda"
    rng = np.random.default_rng((SEED, 61))
    mu = rng.uniform(2.0, 6.0, steady)
    sigma = rng.uniform(0.3, 1.0, steady)
    t0 = _dt.datetime(2026, 10, 17, tzinfo=_dt.timezone.utc)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ms = TorchMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=m, retention=PL_TIERS,
        storage=storage, paged_config=PagedStoreConfig(pool_pages=pool,
                                                       codec="auto"),
        lifecycle=LifecycleConfig(ttl_intervals=2, check_every=1,
                                  auto_compact_fragmentation=0.0),
        device=dev)
    agg, wheel, com, lc = (ms.aggregator, ms.retention, ms.committer,
                           ms.lifecycle)
    paged = agg.paged
    if (storage == "dense") != (paged is None):
        raise AssertionError(f"storage resolved to {agg.storage}")
    if ms.commit_path != "fused" or com is None:
        raise AssertionError(f"commit path {ms.commit_path}")
    reg = agg.registry
    steady_names = [f"api.s{i}.lat" for i in range(steady)]
    for name in steady_names:
        ms.metric_id(name)

    split = collections.defaultdict(list)
    timers = _Timers(torch)
    in_dispatch = [False]
    if paged is not None:
        translate = paged.translate

        def timed_translate(packed):
            t1 = time.perf_counter()
            try:
                return translate(packed)
            finally:
                if in_dispatch[0]:
                    split["translate_ms"][-1] += (
                        time.perf_counter() - t1) * 1e3
        paged.translate = timed_translate
        paged.fold_rows_into = synced(torch, split, "fold_rows_into_ms",
                                      paged.fold_rows_into)
    dispatch = synced(torch, split, "dispatch_ms", com._fused_dispatch_locked)

    def dispatch_marked(*a, **k):
        split["translate_ms"].append(0.0)
        in_dispatch[0] = True
        try:
            return dispatch(*a, **k)
        finally:
            in_dispatch[0] = False
    com._fused_dispatch_locked = dispatch_marked
    com._cells_from_raw = synced(torch, split, "cells_ms",
                                 com._cells_from_raw)
    lc.evict_ids = synced(torch, split, "evict_ms", lc.evict_ids)
    lc._fold = synced(torch, split, "fold_rings_ms", lc._fold)
    saved_k6 = lc_mod.compact_rows_kernel
    lc_mod.compact_rows_kernel = timers.dev_wrap("k6", saved_k6)

    oracle_keys, oracle_counts = [], []  # every sample the pool took
    stream_cells = []                    # the stream's, per interval
    total = 0
    checks = {"conservation": 0, "compactions": [], "k4f": []}
    survivors_rng = np.random.default_rng((SEED, 62))

    def k4f_batch(tag):
        """One raw batch through agg.record_batch on the paged raw route,
        held to the oracle: the pool's difference decodes to exactly the
        batch's cells under the current page table and codecs."""
        nonlocal total
        brng = np.random.default_rng((SEED, 63, tag))
        names = brng.integers(0, steady, PL_SAMPLES)
        values = brng.lognormal(mu[names], sigma[names]).astype(np.float32)
        ids = np.array([reg.lookup(n) for n in steady_names],
                       np.int32)[names]
        mirror = ("none" if paged._mirror is None else
                  f"{sum(len(r) for r, _ in paged._dirty_pairs)} dirty pairs")
        before = paged._pool.clone()
        k4f0 = kernel_launches()["fused_paged_ingest"]
        d0 = paged.fused_dispatches
        agg.record_batch(ids, values)
        agg.flush(force=True)
        agg.wait_transfers()
        if on_card:
            torch.cuda.synchronize()
        dense = np.clip(compress_np(values), -BL, BL).astype(np.int64) + BL
        _pl_same(_pl_pool_cells(paged, paged._pool - before),
                 _pl_encoded(paged, ids.astype(np.int64), dense,
                             np.ones(len(ids), np.int64)),
                 f"K4f batch after interval {tag}")
        del before
        oracle_keys.append(names * PL_KEY + dense)
        oracle_counts.append(np.ones(len(names), np.int64))
        total += len(names)
        launches = kernel_launches()["fused_paged_ingest"] - k4f0
        if on_card and (not agg.fused_paged or launches <= 0
                        or launches != paged.fused_dispatches - d0):
            raise AssertionError(f"the K4f batch took {launches} K4f "
                                 "launches")
        checks["k4f"].append({"after_interval": tag, "samples": len(names),
                              "launches": launches, "mirror_before": mirror})

    reset_kernel_launches()
    if paged is not None and 0 in k4f_after:
        k4f_batch(0)
    commit_ms, per_interval, chunks = [], [], 0
    pool_commits0 = paged.commits if paged is not None else 0
    for k in range(intervals):
        raw, keys, counts = _pl_stream(k, mu, sigma, steady, fresh, samples,
                                       t0)
        oracle_keys.append(keys)
        oracle_counts.append(counts)
        stream_cells.append((keys, counts))
        total += int(counts.sum())
        if on_card:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        ms.backfill_retention([raw])
        if on_card:
            torch.cuda.synchronize()
        commit_ms.append((time.perf_counter() - t1) * 1e3)
        chunks += com.last_dispatches
        if agg.num_metrics != m or len(reg) > m:
            raise AssertionError("the row space grew")
        if paged is not None:
            with paged._lock:
                spilled = sum(paged._host_spill.values())
            if int(paged._pool.sum(dtype=torch.int64)) + spilled != total:
                raise AssertionError(f"interval {k + 1}: pool + spill != "
                                     "samples committed")
            checks["conservation"] += 1
        per_interval.append({"cells": sum(len(h) for h in
                                          raw.histograms.values()),
                             "live_rows": reg.live_count(),
                             "evicted_total": lc.evicted_series})
        if (k + 1) % PL_COMPACT_EVERY == 0:
            checks["compactions"].append(_pl_compact_checked(
                torch, ms, split, survivors_rng))
        if paged is not None and k + 1 in k4f_after:
            k4f_batch(k + 1)
    if on_card:
        torch.cuda.synchronize()
    lc_mod.compact_rows_kernel = saved_k6
    launches = kernel_launches()
    if com.fused_intervals != intervals or com.fanout_intervals:
        raise AssertionError(f"fused {com.fused_intervals}, fanout "
                             f"{com.fanout_intervals} of {intervals}")
    out = {"storage": agg.storage, "num_metrics": m,
           "commit_path": ms.commit_path, "intervals": intervals,
           "evicted_series": lc.evicted_series, "evictions": lc.evictions,
           "overflowed_samples": lc.overflowed_samples,
           "compactions": lc.compactions, "checks": checks,
           "live_rows_max": max(p["live_rows"] for p in per_interval),
           "cells_per_interval": float(np.mean([p["cells"]
                                                for p in per_interval])),
           "commit_chunks": chunks,
           "launches": {k: v for k, v in launches.items() if v}}
    if on_card:
        k6 = [a.elapsed_time(b) for a, b in timers.events["k6"]]
        n_c = max(1, lc.compactions)
        dev_ms = [d - t for d, t in zip(split["dispatch_ms"],
                                        split["translate_ms"])]
        out["ms_per_interval"] = {
            "commit_total": commit_ms, "host_cells": split["cells_ms"],
            "translate": split["translate_ms"], "device_commit": dev_ms,
            "eviction": split["evict_ms"],
            "eviction_pool_fold": split.get("fold_rows_into_ms", []),
            "eviction_ring_fold": split["fold_rings_ms"]}
        out["compaction_ms"] = split["compact_ms"]
        out["k6_ms_per_compaction"] = float(np.sum(k6)) / n_c
        out["k6_launches_per_compaction"] = len(k6) / n_c
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        out["ring_bytes"] = wheel.hbm_bytes()

    # -- launches on the path ------------------------------------------------
    if on_card:
        expect = {"sparse_ingest": chunks,
                  "window_merge": len(PL_TIERS) * intervals,
                  "compact_rows": len(PL_TIERS) * lc.compactions,
                  "divergence": 0}
        if paged is not None:
            expect["paged_scatter"] = chunks + paged.commits - pool_commits0
            if paged.commits - pool_commits0 > lc.evictions:
                raise AssertionError("more pool folds than eviction batches")
        else:
            expect["compact_rows"] += lc.compactions  # the accumulator
        for kernel, n in expect.items():
            if launches[kernel] != n:
                raise AssertionError(f"{kernel}: {launches[kernel]} "
                                     f"launches, expected {n}")

    # -- the pool against the host oracle -----------------------------------
    if paged is not None:
        keys = np.concatenate(oracle_keys)
        w = np.concatenate(oracle_counts)
        names, dense = keys // PL_KEY, keys % PL_KEY
        uniq_names = np.unique(names)
        row_of = np.full(int(uniq_names.max()) + 1, -1, np.int64)
        ov = reg.lookup("_overflow.api")
        evicted = 0
        for i in uniq_names.tolist():
            name = (steady_names[i] if i < steady
                    else f"api.u{i - steady}.lat")
            rid = reg.lookup(name)
            row_of[i] = ov if rid is None else rid
        rows = row_of[names]
        evicted = int(w[rows == ov].sum())
        if ov is None or (rows < 0).any():
            raise AssertionError("an oracle name has no row")
        want = _pl_encoded(paged, rows, dense, w)
        got = _pl_pool_cells(paged, paged._pool)
        with paged._lock:
            if paged._host_spill:
                raise AssertionError("cells reached the host spill")
        _pl_same(got, want, "the pool's lifetime histograms")
        if int(got[1].sum()) != total:
            raise AssertionError("pool decode != samples committed")
        if evicted != lc.overflowed_samples:
            raise AssertionError("_overflow.api != the evicted samples")
        out["pool"] = {"cells": len(got[0]), "occupied_pages":
                       paged.occupied_pages, "total_pages": paged.total_pages,
                       "occupancy": paged.pool_saturation(),
                       "allocated_pages": paged.allocated_pages,
                       "released_pages": paged.released_pages,
                       "pool_folds": paged.commits - pool_commits0,
                       "overflow_row_samples": evicted}

    # -- what the dense twin is held to ---------------------------------------
    live = [i for i, n in enumerate(reg.names()) if n is not None]
    srows = np.sort(np.random.default_rng((SEED, 64)).choice(
        live, min(PL_SAMPLED, len(live)), replace=False))
    sidx = torch.as_tensor(srows, device=dev)
    res = ms.query_window("api.s*", 8.0, percentiles=list(PL_PS))
    oracle_names = steady_names[:PL_SAMPLED]
    wk = np.concatenate([c[0] for c in stream_cells[-8:]])
    wc = np.concatenate([c[1] for c in stream_cells[-8:]])
    sel = wk // PL_KEY < PL_SAMPLED
    hist = np.bincount(wk[sel], weights=wc[sel],
                       minlength=PL_SAMPLED * PL_KEY).astype(
        np.int64).reshape(PL_SAMPLED, PL_KEY)[:, :B]
    want_w, ties = _oracle_stats(hist, np.asarray(PL_PS))
    keys_p = [pct_key(p) for p in PL_PS]
    for i, name in enumerate(oracle_names):
        got_w = res.metrics[name]
        if got_w["count"] != int(want_w["counts"][i]):
            raise AssertionError(f"window 8 s {name}: count")
        for key, value in zip(keys_p, want_w["percentiles"][i]):
            if got_w[key] != float(np.float32(value)):
                raise AssertionError(f"window 8 s {name}: {key}")
    out["window_8s"] = {"rows": len(res.metrics),
                        "oracle_rows": len(oracle_names), "rank_ties": ties}
    twin = {"names": reg.names(),
            "digests": _pl_ring_digests(torch, [t.ring for t in
                                                wheel._tiers]),
            "rows": srows,
            "sampled": [t.ring.index_select(1, sidx).cpu()
                        for t in wheel._tiers],
            "window": res.metrics,
            "la": lc._la.cpu().numpy()}
    # the timers' wrappers tie the system into reference cycles: drop
    # the device state by hand, so the twin finds the card empty
    _drop_system(torch, ms)
    del ms, agg, wheel, com, lc, paged, res
    gc.collect()
    return out, twin


def _pl_compact_checked(torch, ms, split, rng):
    """One compaction on the paged or dense system: survivors' stats
    equal by name across it (PagedStore.query on paged storage), the
    pool untouched and no host->device bytes, ids a dense prefix."""
    agg, reg, lc = ms.aggregator, ms.aggregator.registry, ms.lifecycle
    paged = agg.paged
    live = [(i, n) for i, n in enumerate(reg.names()) if n is not None]
    pick = [live[j] for j in np.sort(rng.choice(
        len(live), min(PL_QUERIED, len(live)), replace=False))]
    ps = np.asarray(PL_PS)
    if paged is not None:
        before = paged.query(np.array([i for i, _ in pick]), ps)
        pool_before = paged._pool.clone()
        h2d = paged.h2d_bytes
    t1 = time.perf_counter()
    if not lc.compact():
        raise AssertionError("compaction did not run")
    split["compact_ms"].append((time.perf_counter() - t1) * 1e3)
    n = reg.live_count()
    names = reg.names()
    if names[:n].count(None) or any(x is not None for x in names[n:]):
        raise AssertionError("survivors are not the dense prefix")
    out = {"live_rows": n, "moved_rows": sum(
        1 for new, (old, _) in enumerate(live) if new != old)}
    if paged is not None:
        if paged.h2d_bytes != h2d:
            raise AssertionError("the pool's permutation moved bytes")
        if not torch.equal(paged._pool, pool_before):
            raise AssertionError("compaction changed the pool")
        del pool_before
        after = paged.query(np.array([reg.lookup(nm) for _, nm in pick]),
                            ps)
        for key in ("counts", "sums", "percentiles"):
            if not np.array_equal(before[key], after[key]):
                raise AssertionError(f"compaction changed survivors' {key}")
        out["queried_rows"] = len(pick)
    return out


def _pl_compare(paged, dense):
    """The paged run's rings, registry, activity and window query
    against the dense twin's."""
    if paged["names"] != dense["names"]:
        raise AssertionError("registries differ from the dense twin")
    if not np.array_equal(paged["la"], dense["la"]):
        raise AssertionError("activity vectors differ from the dense twin")
    for ti, ((pc, pw), (dc, dw)) in enumerate(zip(paged["digests"],
                                                   dense["digests"])):
        if not (np.array_equal(pc, dc) and np.array_equal(pw, dw)):
            bad = int(((pc != dc) | (pw != dw)).sum())
            raise AssertionError(f"tier {ti}: {bad} (slot, row) digests "
                                 "differ from the dense twin")
    for ti, (a, b) in enumerate(zip(paged["sampled"], dense["sampled"])):
        if not np.array_equal(a.numpy(), b.numpy()):
            raise AssertionError(f"tier {ti}: sampled rows differ")
    if paged["window"] != dense["window"]:
        raise AssertionError("the 8 s window differs from the dense twin")
    return {"digests": [list(d[0].shape) for d in paged["digests"]],
            "sampled_rows": len(paged["rows"]),
            "window_rows": len(paged["window"])}


def phase_paged_lifecycle(torch):
    """Paged storage with lifecycle and the paged fused commit:
    TorchMetricSystem(num_metrics=2^16 (PAGED_MIN_METRICS, so
    storage="auto" pages), bucket_limit 4096, PagedStoreConfig(
    pool_pages=2^20, codec="auto"), retention ((8, 1), (4, 8)),
    lifecycle=LifecycleConfig(ttl_intervals=2, check_every=1,
    auto_compact_fragmentation=0.0)), 24 intervals through
    backfill_retention: 2^20 lognormal samples over 2^15 - 1 steady
    names and 2^13 fresh names of one bucket each (196,608 in all, three
    times the row space), compact() every 4 intervals; K4f batches of 2^20
    before the stream and after intervals 21, 23 and 24.  Then the same
    stream through a storage="dense" twin (run after the paged system is
    freed) whose rings, registry, activity and 8 s window must equal."""
    from loghisto_tpu_torch.ops.dispatch import PAGED_MIN_METRICS

    if PL_M != PAGED_MIN_METRICS:
        raise AssertionError("the phase must sit at PAGED_MIN_METRICS")
    args = ("cuda", PL_M, PL_POOL, PL_STEADY, PL_FRESH, PL_SAMPLES,
            PL_INTERVALS)
    t1 = time.perf_counter()
    out, twin = _pl_run(torch, args[0], "auto", *args[1:],
                        k4f_after=PL_K4F_AFTER)
    paged_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    dense_out, dense_twin = _pl_run(torch, args[0], "dense", *args[1:],
                                    k4f_after=())
    twin_s = time.perf_counter() - t1
    out["dense_twin"] = {"equal": _pl_compare(twin, dense_twin),
                         "launches": dense_out["launches"],
                         "peak_device_bytes": dense_out["peak_device_bytes"],
                         "ms_per_interval": {
                             "commit_total": dense_out["ms_per_interval"][
                                 "commit_total"]},
                         "compaction_ms": dense_out["compaction_ms"]}
    out["paged_s"], out["twin_s"] = paged_s, twin_s
    out["tiers"] = [list(t) for t in PL_TIERS]
    out["pool_pages"] = PL_POOL
    out["samples_per_interval"] = PL_SAMPLES
    out["fresh_per_interval"] = PL_FRESH
    return out


# -- checkpoints and journals -----------------------------------------------

CJ_OTHER = 1000          # (a) names the dense target registers first
CJ_BATCHES = 4           # (a) 2^20-sample batches before the save
CJ_PAGED_POOL = 1 << 19  # (a) the paged target: 10,000 rows of dense pages
CJ_INTERVALS = 8         # (b) the paged lifecycle churn stream, cut from 24
CJ_LIVE = 16             # (c) live intervals under the journal
CJ_WATERMARK = 8         # (c) the checkpoint's seq watermark
CJ_COLLECT_AT = 4        # (c) the live interval report before it
CJ_FRESH_SAMPLES = 8     # (c) samples of each fresh name


def _peak_rss_gb():
    """The process's peak resident host memory so far (GB)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _paged_named(agg, acc):
    """What a paged aggregator's ``collect()`` reports for the cells of a
    dense [m, B] host array of its first m rows (its host statistics,
    named as collect names them), without the lifetime keys."""
    from loghisto_tpu_torch.ops.stats import sparse_cells_stats

    labels = [lb for lb, p in agg.percentiles.items() if 0.0 <= p <= 1.0]
    ps = [p for p in agg.percentiles.values() if 0.0 <= p <= 1.0]
    rows, cols = np.nonzero(acc)
    st = sparse_cells_stats(rows, cols, acc[rows, cols].astype(np.int64),
                            acc.shape[0], np.asarray(ps),
                            agg.config.bucket_limit, agg.config.precision)
    names = agg.registry.names()
    out = {}
    for mid in np.nonzero(st["counts"])[0].tolist():
        name, count = names[mid], int(st["counts"][mid])
        total = float(st["sums"][mid])
        out[f"{name}_count"] = float(count)
        out[f"{name}_sum"] = total
        out[f"{name}_avg"] = total / count
        for label, v in zip(labels, st["percentiles"][mid].tolist()):
            out[label % name] = v
    return out


def _cj_same_collect(got, want, what):
    """Two collect() outputs EQUAL, key for key.  The float32 row sums
    (``acc.float() @ reps``) follow the accumulator's shape on a CPU; on
    the card they came out bit-equal for rows at other ids of a larger
    accumulator, and are held to that."""
    if got != want:
        bad = sorted(k for k in set(got) | set(want)
                     if got.get(k) != want.get(k))
        raise AssertionError(f"{what}: collect() differs in {len(bad)} "
                             f"keys, e.g. {bad[:3]}")
    return len(want)


def _cj_compare_paged(got, src_out, want_named):
    """A paged target's collect() against the dense source's: the
    statistics keys equal the paged statistics of the source's cells
    exactly, the lifetime counts equal the source's, the lifetime sums
    within rtol 1e-6 (float32 device sums in the source, float64 host
    sums in the paged target)."""
    stat_keys = {k for k in got if "_agg_" not in k}
    if stat_keys != set(want_named):
        raise AssertionError("paged target: statistics keys differ")
    bad = [k for k in stat_keys if got[k] != want_named[k]]
    if bad:
        raise AssertionError(f"paged target: {len(bad)} values differ "
                             f"from the source cells' statistics")
    agg_keys = {k for k in src_out if "_agg_" in k}
    if agg_keys != {k for k in got if "_agg_" in k}:
        raise AssertionError("paged target: lifetime keys differ")
    for k in agg_keys:
        if k.endswith("_agg_count"):
            if got[k] != src_out[k]:
                raise AssertionError(f"paged target: {k}")
        elif abs(got[k] - src_out[k]) > 1e-6 * abs(src_out[k]) + 1e-9:
            raise AssertionError(f"paged target: {k} past rtol 1e-6")
    return len(stat_keys)


def _cj_dense_restart(torch, tmp):
    """(a) The README headline: M = 10,000 x 8193 on dense storage, four
    2^20 Zipf(1.3) lognormal batches through record_batch (K1), saved,
    then restored into a dense aggregator holding 1,000 other names
    (remap by name, growth) and a paged aggregator of 2^16 rows
    (translate + K4); their collect() against the source's, then once
    more after one more batch into each (K1, K1, K4f)."""
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.ops.backend import kernel_launches
    from loghisto_tpu_torch.paging import PagedStoreConfig
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.utils import checkpoint

    cfg = MetricConfig(bucket_limit=BL)
    names = [f"svc.{k}.latency" for k in range(M)]
    rng = np.random.default_rng((SEED, 70))
    k0 = kernel_launches()
    src = TorchAggregator(num_metrics=M, config=cfg, batch_size=BATCH)
    for name in names:
        src.registry.id_for(name)
    for _ in range(CJ_BATCHES):
        src.record_batch(zipf_ids(rng, BATCH, M), lognormal_values(rng, BATCH))
    src.flush(force=True)
    torch.cuda.synchronize()
    path = f"{tmp}/dense.npz"
    t1 = time.perf_counter()
    checkpoint.save(path, aggregator=src)
    save_s = time.perf_counter() - t1

    dense = TorchAggregator(num_metrics=M, config=cfg, batch_size=BATCH)
    for k in range(CJ_OTHER):
        dense.registry.id_for(f"other.{k}")
    paged = TorchAggregator(num_metrics=PL_M, config=cfg, batch_size=BATCH,
                            storage="paged", paged_config=PagedStoreConfig(
                                pool_pages=CJ_PAGED_POOL, codec="dense"))
    if paged.storage != "paged" or not paged.fused_paged:
        raise AssertionError("the paged target is not on the K4f route")
    restore_s = {}
    for key, agg in (("dense", dense), ("paged", paged)):
        k4 = kernel_launches()["paged_scatter"]
        t1 = time.perf_counter()
        if checkpoint.restore(path, aggregator=agg) is not None:
            raise AssertionError("an unstamped save restored a watermark")
        torch.cuda.synchronize()
        restore_s[key] = time.perf_counter() - t1
        k4 = kernel_launches()["paged_scatter"] - k4
        if k4 != (1 if key == "paged" else 0):
            raise AssertionError(f"{key} restore took {k4} K4 launches")
    if dense.num_metrics <= M or dense.registry.lookup(names[0]) != CJ_OTHER:
        raise AssertionError("the dense restore did not remap by name")
    if paged.registry.names()[:M] != names:
        raise AssertionError("the paged target's rows are not the source's")

    checks = []
    for rnd in range(2):
        if rnd:  # one more batch into the source and both targets
            ids = zipf_ids(rng, BATCH, M)
            values = lognormal_values(rng, BATCH)
            remap = np.array([dense.registry.lookup(n) for n in names],
                             np.int32)
            for agg, batch_ids in ((src, ids), (dense, remap[ids]),
                                   (paged, ids)):
                agg.record_batch(batch_ids, values)
                agg.flush(force=True)
            torch.cuda.synchronize()
        src_acc = src._acc.cpu().numpy()
        rows = torch.as_tensor([dense.registry.lookup(n) for n in names],
                               device=dense._acc.device)
        if not torch.equal(dense._acc.index_select(0, rows), src._acc):
            raise AssertionError(f"round {rnd}: dense target rows differ")
        got_cells = _pl_pool_cells(paged.paged, paged.paged._pool)
        r_, c_ = np.nonzero(src_acc)
        want_cells = (r_.astype(np.int64) * B + c_,
                      src_acc[r_, c_].astype(np.int64))
        _pl_same(got_cells, want_cells, f"round {rnd}: the paged pool")
        want_named = _paged_named(paged, src_acc)
        src_out = src.collect().metrics
        dense_out = dense.collect().metrics
        paged_out = paged.collect().metrics
        _cj_same_collect(dense_out, src_out, f"round {rnd}: the dense "
                         "target")
        checks.append({"keys": len(src_out), "cells": len(want_cells[0]),
                       "paged_stat_keys": _cj_compare_paged(
                           paged_out, src_out, want_named)})
    launches = {k: v - k0[k] for k, v in kernel_launches().items()}
    # the source took CJ_BATCHES + 1 batches, the dense target 1
    if launches["fused_ingest"] != CJ_BATCHES + 2:
        raise AssertionError(f"K1 took {launches['fused_ingest']} launches")
    if launches["fused_paged_ingest"] < 1:
        raise AssertionError("the paged target's batch took no K4f launch")
    out = {"m": M, "batches": CJ_BATCHES, "other_names": CJ_OTHER,
           "file_bytes": os.path.getsize(path), "save_s": save_s,
           "restore_s": restore_s, "dense_rows_after": dense.num_metrics,
           "paged_pool_pages": CJ_PAGED_POOL, "checks": checks,
           "launches": {k: v for k, v in launches.items() if v}}
    for agg in (src, dense, paged):
        agg.close()
    del src, dense, paged
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _cj_system(torch, storage, m=PL_M):
    from loghisto_tpu_torch import TorchMetricSystem
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.lifecycle import LifecycleConfig
    from loghisto_tpu_torch.paging import PagedStoreConfig

    return TorchMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=m, retention=PL_TIERS,
        config=MetricConfig(bucket_limit=BL),
        storage=storage, paged_config=PagedStoreConfig(pool_pages=PL_POOL,
                                                       codec="auto"),
        lifecycle=LifecycleConfig(ttl_intervals=2, check_every=1,
                                  auto_compact_fragmentation=0.0))


def _cj_paged_restart(torch, tmp):
    """(b) The paged lifecycle phase's churn stream at 2^16 paged rows
    (codec "auto", churn lifecycle) for CJ_INTERVALS intervals, saved
    with its lifecycle and watermark, restored into a fresh paged system
    and into a dense aggregator of 2^16 rows; the decoded cells, codecs,
    activity, counters and generation against the source's by name, and
    a K4f batch after the restore."""
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.ops import paged_store as ps_mod
    from loghisto_tpu_torch.ops.backend import kernel_launches
    from loghisto_tpu_torch.ops.codec import compress_np
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.utils import checkpoint

    rng = np.random.default_rng((SEED, 61))
    mu = rng.uniform(2.0, 6.0, PL_STEADY)
    sigma = rng.uniform(0.3, 1.0, PL_STEADY)
    t0 = _dt.datetime(2026, 10, 17, tzinfo=_dt.timezone.utc)
    k0 = kernel_launches()
    src = _cj_system(torch, "auto")
    agg, lc = src.aggregator, src.lifecycle
    if agg.paged is None:
        raise AssertionError(f"storage resolved to {agg.storage}")
    steady = [f"api.s{i}.lat" for i in range(PL_STEADY)]
    for name in steady:
        src.metric_id(name)
    t1 = time.perf_counter()
    for k in range(CJ_INTERVALS):
        raw = _pl_stream(k, mu, sigma, PL_STEADY, PL_FRESH, PL_SAMPLES,
                         t0)[0]
        src.backfill_retention([raw])
        if (k + 1) % PL_COMPACT_EVERY == 0:
            lc.compact()
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t1
    run_launches = {k: v - k0[k] for k, v in kernel_launches().items()}

    split = collections.defaultdict(list)
    kept = {}
    decode = agg.paged.decode_dense

    def decode_kept(*a, **k):
        kept["acc"] = synced(torch, split, "decode", decode)(*a, **k)
        return kept["acc"]
    agg.paged.decode_dense = decode_kept
    path = f"{tmp}/paged.npz"
    t1 = time.perf_counter()
    checkpoint.save(path, aggregator=agg, lifecycle=lc,
                    seq_watermark=CJ_INTERVALS)
    save_s = time.perf_counter() - t1
    rss_save = _peak_rss_gb()
    want = kept.pop("acc")
    src_names = agg.registry.names()
    src_codecs = agg.paged.codec_names()
    src_la = lc._la.cpu().numpy()
    src_gen = agg.registry.generation
    src_counters = (lc.evicted_series, lc.overflowed_samples, lc.evictions,
                    lc.compactions)
    if lc.evicted_series <= 0:
        raise AssertionError("the churn stream evicted nothing")
    _drop_system(torch, src)
    del src, agg, lc

    # -- restore into a fresh paged system --------------------------------
    saved_ids = [i for i, n in enumerate(src_names) if n is not None]
    tgt = _cj_system(torch, "auto")
    tagg, tlc = tgt.aggregator, tgt.lifecycle
    pg = tagg.paged
    rsplit = collections.defaultdict(list)
    remap_fn = checkpoint._remap_rows
    delta_fn = checkpoint._restore_paged_delta
    scatter_fn = ps_mod.paged_scatter
    checkpoint._remap_rows = synced(torch, rsplit, "remap", remap_fn)
    checkpoint._restore_paged_delta = synced(torch, rsplit, "delta",
                                             delta_fn)
    pg.translate = synced(torch, rsplit, "translate", pg.translate)
    ps_mod.paged_scatter = synced(torch, rsplit, "k4", scatter_fn)
    k4 = kernel_launches()["paged_scatter"]
    try:
        t1 = time.perf_counter()
        wm = checkpoint.restore(path, aggregator=tagg, lifecycle=tlc)
        torch.cuda.synchronize()
        rtotal = time.perf_counter() - t1
    finally:
        checkpoint._remap_rows = remap_fn
        checkpoint._restore_paged_delta = delta_fn
        ps_mod.paged_scatter = scatter_fn
        del pg.translate
    k4 = kernel_launches()["paged_scatter"] - k4
    if wm != CJ_INTERVALS or k4 != 1:
        raise AssertionError(f"watermark {wm}, {k4} K4 launches")
    treg = tagg.registry
    tids = [treg.lookup(src_names[i]) for i in saved_ids]
    if None in tids:
        raise AssertionError("a saved name is missing from the target")
    got = pg.decode_dense()
    if not np.array_equal(got[tids], want[saved_ids]):
        raise AssertionError("paged target: decoded cells differ")
    if got.sum() != want.sum():
        raise AssertionError("paged target: cells outside the saved rows")
    del got
    tcodecs = pg.codec_names()
    if [tcodecs[t] for t in tids] != [src_codecs[i] for i in saved_ids]:
        raise AssertionError("paged target: codec choices differ")
    if not np.array_equal(tlc._la.cpu().numpy()[tids], src_la[saved_ids]):
        raise AssertionError("paged target: activity not remapped by name")
    if (tlc.evicted_series, tlc.overflowed_samples, tlc.evictions,
            tlc.compactions) != src_counters:
        raise AssertionError("paged target: churn counters differ")
    if treg.generation < src_gen:
        raise AssertionError("paged target: registry generation went back")
    mirror_before = pg._mirror is None
    brng = np.random.default_rng((SEED, 71))
    pick = brng.integers(0, PL_STEADY, PL_SAMPLES)
    values = brng.lognormal(mu[pick], sigma[pick]).astype(np.float32)
    ids = np.array([treg.lookup(n) for n in steady], np.int32)[pick]
    before = pg._pool.clone()
    k4f = kernel_launches()["fused_paged_ingest"]
    tagg.record_batch(ids, values)
    tagg.flush(force=True)
    torch.cuda.synchronize()
    k4f = kernel_launches()["fused_paged_ingest"] - k4f
    dense_idx = np.clip(compress_np(values), -BL, BL).astype(np.int64) + BL
    _pl_same(_pl_pool_cells(pg, pg._pool - before),
             _pl_encoded(pg, ids.astype(np.int64), dense_idx,
                         np.ones(len(ids), np.int64)),
             "K4f batch after the restore")
    del before
    if not mirror_before or pg._mirror is None or k4f < 1:
        raise AssertionError("the K4f batch did not rebuild the mirror")
    _drop_system(torch, tgt)
    del tgt, tagg, tlc, pg

    # -- restore into a dense aggregator of 2^16 rows ----------------------
    dense = TorchAggregator(num_metrics=PL_M, config=MetricConfig(
        bucket_limit=BL), storage="dense", batch_size=BATCH)
    dsplit = collections.defaultdict(list)
    dense_fn = checkpoint._restore_dense_delta
    checkpoint._remap_rows = synced(torch, dsplit, "remap", remap_fn)
    checkpoint._restore_dense_delta = synced(torch, dsplit, "merge",
                                             dense_fn)
    try:
        t1 = time.perf_counter()
        checkpoint.restore(path, aggregator=dense)
        torch.cuda.synchronize()
        dtotal = time.perf_counter() - t1
    finally:
        checkpoint._remap_rows = remap_fn
        checkpoint._restore_dense_delta = dense_fn
    if dense._spill is not None:
        raise AssertionError("the dense restore took the host spill")
    dids = [dense.registry.lookup(src_names[i]) for i in saved_ids]
    dacc = dense._acc.cpu().numpy()
    if not np.array_equal(dacc[dids], want[saved_ids]) or \
            dacc.sum(dtype=np.int64) != want.sum():
        raise AssertionError("dense target: cells differ")
    del dacc, want
    dense.close()
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: v - k0[k] for k, v in kernel_launches().items()}
    def sec(d, key):
        return sum(d[key]) / 1e3

    return {
        "rows": PL_M, "intervals": CJ_INTERVALS, "stream_s": stream_s,
        "evicted_series": src_counters[0], "compactions": src_counters[3],
        "saved_rows": len(saved_ids), "file_bytes": os.path.getsize(path),
        "peak_rss_gb_after_save": rss_save, "peak_rss_gb": _peak_rss_gb(),
        "save_s": {"total": save_s, "decode": sec(split, "decode"),
                   "compress_write": save_s - sec(split, "decode")},
        "restore_paged_s": {
            "total": rtotal, "remap": sec(rsplit, "remap"),
            "translate": sec(rsplit, "translate"), "k4": sec(rsplit, "k4"),
            "cells_and_codecs": sec(rsplit, "delta")
            - sec(rsplit, "translate") - sec(rsplit, "k4"),
            "load": rtotal - sec(rsplit, "remap") - sec(rsplit, "delta")},
        "restore_dense_s": {
            "total": dtotal, "remap": sec(dsplit, "remap"),
            "merge": sec(dsplit, "merge"),
            "load": dtotal - sec(dsplit, "remap") - sec(dsplit, "merge")},
        "k4f_after_restore": {"launches": k4f, "mirror_rebuilt": True},
        "stream_launches": {k: v for k, v in run_launches.items() if v},
        "launches": {k: v for k, v in launches.items() if v}}


def _cj_retention_system(torch, **kw):
    """The retention system with the fused commit, churn lifecycle and 24
    drift banks; ``kw`` goes to TorchMetricSystem (``resilience=``,
    ``observability=``)."""
    from loghisto_tpu_torch import TorchMetricSystem
    from loghisto_tpu_torch.anomaly import AnomalyConfig, hourly_bank
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.lifecycle import LifecycleConfig

    ms = TorchMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=RET_M, retention=True,
        config=MetricConfig(bucket_limit=BL), commit="auto",
        lifecycle=LifecycleConfig(ttl_intervals=2, check_every=1,
                                  auto_compact_fragmentation=0.1,
                                  min_compact_rows=64),
        anomaly=AnomalyConfig(banks=LD_BANKS, bank_of=hourly_bank,
                              decay=0.97, min_samples=64, window=6.0),
        **kw)
    if ms.commit_path != "fused":
        raise AssertionError(f"commit path {ms.commit_path}")
    evicted = []
    evict = ms.lifecycle.evict_ids

    def evict_logged(ids):
        names = evict(ids)
        evicted.append((ms.retention.intervals_pushed, list(names)))
        return names
    ms.lifecycle.evict_ids = evict_logged
    return ms, evicted


def _cj_record(ms, rng, k, names, mu, sigma):
    """Interval k of the journaled stream into the host system: 2^20
    lognormal samples over the steady names and CJ_FRESH_SAMPLES each for
    LD_FRESH new api.u<uid>.lat names, one ``histogram_batch`` a name."""
    n = RET_SAMPLES - LD_FRESH * CJ_FRESH_SAMPLES
    ids = rng.integers(0, len(names), n)
    values = rng.lognormal(mu[ids], sigma[ids])
    order = np.argsort(ids, kind="stable")
    bounds = np.searchsorted(ids[order], np.arange(len(names) + 1))
    for i, name in enumerate(names):
        ms.histogram_batch(name, values[order[bounds[i]:bounds[i + 1]]])
    for u in range(LD_FRESH):
        ms.histogram_batch(f"api.u{k * LD_FRESH + u}.lat",
                           rng.lognormal(3.0, 0.5, CJ_FRESH_SAMPLES))


def _cj_same_system(torch, got, want):
    """Restart 1 against the live system: registry, accumulator,
    activity, every ring and slot, the wheel's host state EQUAL; drift
    banks within rtol 1e-6 (tests/test_torch_anomaly.py)."""
    ga, wa = got.aggregator, want.aggregator
    if ga.registry.names() != wa.registry.names():
        raise AssertionError("restart 1: registries differ")
    if not torch.equal(ga._acc, wa._acc):
        raise AssertionError("restart 1: accumulators differ")
    if not torch.equal(got.lifecycle._la, want.lifecycle._la):
        raise AssertionError("restart 1: activity vectors differ")
    for i, (gt, wt) in enumerate(zip(got.retention._tiers,
                                     want.retention._tiers)):
        if not torch.equal(gt.ring, wt.ring):
            raise AssertionError(f"restart 1: tier {i} ring differs")
        if (gt.slot, gt.in_slot) != (wt.slot, wt.in_slot) or not \
                np.array_equal(gt.durations, wt.durations):
            raise AssertionError(f"restart 1: tier {i} slot state differs")
    ga_n, wa_n = got.anomaly, want.anomaly
    torch.testing.assert_close(ga_n._prof, wa_n._prof, rtol=1e-6, atol=0)
    torch.testing.assert_close(ga_n._wsum, wa_n._wsum, rtol=1e-6, atol=0)
    return {"banks_bit_equal": bool(torch.equal(ga_n._prof, wa_n._prof)
                                    and torch.equal(ga_n._wsum, wa_n._wsum)),
            "rings_bytes": sum(t.ring.numel() * 4
                               for t in want.retention._tiers)}


def _cj_compare_restart2(live_out, r2_out, held, overflow_prefix):
    """Restart 2's collect() against the live one.  The lifecycle clock
    is the wheel's interval count, which a restore does not carry (as in
    the reference): names alive at the checkpoint outlive their TTL in
    the restarted system, so the live system folds into its overflow row
    names that restart 2 still ``held``.  Every other key is EQUAL; the
    held names' counts plus restart 2's overflow counts equal the live
    overflow counts exactly."""
    def owner(key, names):
        return next((n for n in names if key.startswith(n + "_")), None)

    def rest(out):
        return {k: v for k, v in out.items()
                if not k.startswith(overflow_prefix) and not owner(k, held)}

    _cj_same_collect(rest(r2_out), rest(live_out), "restart 2")
    for suffix in ("_count", "_agg_count"):
        held_total = sum(r2_out[f"{n}{suffix}"] for n in held)
        if live_out[overflow_prefix + suffix] != \
                r2_out.get(overflow_prefix + suffix, 0.0) + held_total:
            raise AssertionError(f"restart 2: overflow{suffix} does not "
                                 "account for the held names")
    total = [sum(v for k, v in out.items() if k.endswith("_count")
                 and not k.endswith("_agg_count"))
             for out in (live_out, r2_out)]
    if total[0] != total[1]:
        raise AssertionError("restart 2: interval counts not conserved")
    return {"keys": len(live_out), "held_names": len(held),
            "interval_samples": total[0]}


def _cj_journal_restart(torch, tmp):
    """(c) The retention system with the fused commit, churn lifecycle
    and 24 drift banks: CJ_LIVE live intervals through the reaper's tick
    with a RawJournal attached, an interval report after interval
    CJ_COLLECT_AT and a checkpoint stamped CJ_WATERMARK between two
    commits; restart 1 replays the whole journal into a fresh system
    (rings, accumulator, activity EQUAL, banks within tolerance), restart
    2 restores the checkpoint into another and replays the lines past
    the watermark (collect() EQUAL but for the names the restarted
    lifecycle clock keeps, which are accounted exactly)."""
    import itertools
    import queue

    from loghisto_tpu_torch.ops.backend import kernel_launches
    from loghisto_tpu_torch.utils import checkpoint, journal

    rng = np.random.default_rng((SEED, 72))
    steady = [f"svc.{k}.latency" for k in range(LD_STEADY)]
    mu = rng.uniform(2.0, 6.0, LD_STEADY)
    sigma = rng.uniform(0.3, 1.0, LD_STEADY)
    jpath, cpath = f"{tmp}/raw.jsonl", f"{tmp}/ret.npz"
    live, live_evicted = _cj_retention_system(torch)
    com = live.committer
    jr = journal.RawJournal(live, jpath)
    jr.start()
    tick_q = queue.Queue()  # the processed half is never drained here
    saved_names = None
    t1 = time.perf_counter()
    for k in range(1, CJ_LIVE + 1):
        _cj_record(live, rng, k, steady, mu, sigma)
        live._tick(tick_q)
        deadline = time.monotonic() + 60.0
        while com.intervals_committed < k:
            if com.bridge_error is not None:
                raise RuntimeError("the live commit failed") from \
                    com.bridge_error
            if time.monotonic() > deadline:
                raise AssertionError(f"interval {k} was not committed")
            time.sleep(0.002)
        if k == CJ_COLLECT_AT:
            live.aggregator.collect()
        if k == CJ_WATERMARK:
            t2 = time.perf_counter()
            checkpoint.save(cpath, aggregator=live.aggregator,
                            lifecycle=live.lifecycle, anomaly=live.anomaly,
                            seq_watermark=CJ_WATERMARK)
            save_s = time.perf_counter() - t2
            saved_names = set(n for n in live.aggregator.registry.names()
                              if n is not None)
    live_s = time.perf_counter() - t1
    jr.stop()
    if com.fused_intervals != CJ_LIVE:
        raise AssertionError(f"{com.fused_intervals} fused live intervals")
    lines = list(journal.replay(jpath))
    if [r.seq for r in lines] != list(range(1, CJ_LIVE + 1)) or any(
            r.duration != 1.0 for r in lines):
        raise AssertionError("the journal's seqs or durations differ")
    del lines

    # restart 1: the whole journal from empty
    r1, _ = _cj_retention_system(torch)
    torch.cuda.synchronize()
    k0 = kernel_launches()
    t1 = time.perf_counter()
    replayed = journal.replay(jpath)
    n1 = r1.backfill_retention(itertools.islice(replayed, CJ_COLLECT_AT))
    r1.aggregator.collect()
    n1 += r1.backfill_retention(replayed)
    torch.cuda.synchronize()
    r1_s = time.perf_counter() - t1
    r1_launches = {k: v - k0[k] for k, v in kernel_launches().items()}
    if n1 != CJ_LIVE:
        raise AssertionError(f"restart 1 replayed {n1} intervals")
    for kernel in ("sparse_ingest", "window_merge", "compact_rows",
                   "divergence"):
        if r1_launches[kernel] <= 0:
            raise AssertionError(f"the replay launched no {kernel}")
    same = _cj_same_system(torch, r1, live)

    # restart 2: the checkpoint, then the lines past its watermark
    r2, r2_evicted = _cj_retention_system(torch)
    t1 = time.perf_counter()
    wm = checkpoint.restore(cpath, aggregator=r2.aggregator,
                            lifecycle=r2.lifecycle, anomaly=r2.anomaly)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    if wm != CJ_WATERMARK:
        raise AssertionError(f"watermark {wm}")
    t1 = time.perf_counter()
    n2 = r2.backfill_retention(r for r in journal.replay(jpath)
                               if r.seq > wm)
    torch.cuda.synchronize()
    r2_s = time.perf_counter() - t1

    live_out = live.aggregator.collect().metrics
    if r1.aggregator.collect().metrics != live_out:
        raise AssertionError("restart 1: collect() differs")
    r2_out = r2.aggregator.collect().metrics
    live_after = {n for e, names in live_evicted if e > wm for n in names}
    r2_gone = {n for _, names in r2_evicted for n in names}
    held = sorted(live_after - r2_gone)
    if not set(held) <= saved_names:
        raise AssertionError("restart 2 holds names the checkpoint lacks")
    if r2_gone - live_after:
        raise AssertionError("restart 2 evicted names the live run kept")
    cmp2 = _cj_compare_restart2(live_out, r2_out, held, "_overflow.api")
    journal_bytes = os.path.getsize(jpath)
    for ms in (live, r1, r2):
        _drop_system(torch, ms)
    del live, r1, r2
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "metrics": RET_M, "tiers": [list(t) for t in RET_TIERS],
        "samples_per_interval": RET_SAMPLES, "live_intervals": CJ_LIVE,
        "watermark": CJ_WATERMARK, "live_s": live_s, "save_s": save_s,
        "checkpoint_bytes": os.path.getsize(cpath),
        "journal_bytes_per_interval": journal_bytes / CJ_LIVE,
        "restart1": {"intervals": n1, "s": r1_s,
                     "intervals_per_s": n1 / r1_s, **same,
                     "launches": {k: v for k, v in r1_launches.items()
                                  if v}},
        "restart2": {"restore_s": restore_s, "intervals": n2, "s": r2_s,
                     "intervals_per_s": n2 / r2_s, **cmp2,
                     "evicted_live_after_watermark": len(live_after)}}


def phase_checkpoint_journal(torch):
    """Checkpoints and journals on the card: (a) a dense restart at the
    README headline into a dense and a paged target, (b) a paged restart
    at 2^16 rows after the paged lifecycle churn stream into a paged
    system and a dense aggregator, (c) a journal and watermark restart
    of the retention system with the fused commit, lifecycle and drift.
    Each part prints its own line; the phase line carries every launch."""
    import shutil
    import tempfile

    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )

    tmp = tempfile.mkdtemp(prefix="loghisto-cj-")
    reset_kernel_launches()
    parts = {}
    try:
        for key, fn in (("a_dense_restart", _cj_dense_restart),
                        ("b_paged_restart", _cj_paged_restart),
                        ("c_journal_restart", _cj_journal_restart)):
            t1 = time.perf_counter()
            out = fn(torch, tmp)
            out["part_s"] = time.perf_counter() - t1
            emit({"part": key, **out})
            parts[key] = out["part_s"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = kernel_launches()
    for kernel in ("fused_ingest", "sparse_ingest", "paged_scatter",
                   "fused_paged_ingest", "window_merge", "compact_rows",
                   "divergence"):
        if launches[kernel] <= 0:
            raise AssertionError(f"the phase launched no {kernel}")
    return {"parts_s": parts, "peak_rss_gb": _peak_rss_gb(),
            "launches": {k: v for k, v in launches.items() if v}}


# -- labels and group-by ----------------------------------------------------


def _lg_names():
    """The 1024 labeled series of ``labels_group_by_main_path``:
    rpc.latency over route (32) x code (8) x method (4), in registration
    order."""
    from loghisto_tpu_torch.labels import canonical_name

    return [canonical_name("rpc.latency", {"route": f"/r{r:02d}",
                                           "code": c, "method": m})
            for r in range(LG_ROUTES) for c in LG_CODES
            for m in LG_METHODS]


def _lg_cells(raw, registry):
    """``_cells`` of the labeled rows only (the committer's own
    commit.LatencyUs row lies past the wheel's rows)."""
    return _cells(dataclasses.replace(raw, histograms={
        k: v for k, v in raw.histograms.items()
        if k.startswith("rpc.latency;")}), registry)


def _lg_group_oracle(hist, names, rows, by, ps, reps):
    """Per group of ``rows`` (registry ids of ``names``) by the ``by``
    keys: merge_groups_host with the float32 representative table (the
    float64 rank rule) and the int64 group histogram's ``_oracle_stats``
    (the device's float32 rank rule)."""
    from loghisto_tpu_torch.config import PRECISION
    from loghisto_tpu_torch.labels.groupby import (
        assign_groups,
        merge_groups_host,
    )

    keys, gids = assign_groups([(r, names[r]) for r in rows], by)
    ghist = np.zeros((len(keys), B), np.int64)
    np.add.at(ghist, np.asarray(gids), hist[rows])
    sparse = {}
    for r in rows:
        nz = np.flatnonzero(hist[r])
        sparse[names[r]] = dict(zip((nz - BL).tolist(),
                                    hist[r][nz].tolist()))
    merged = merge_groups_host(sparse, by, ps, PRECISION,
                               value_of=lambda b: reps[np.asarray(b) + BL])
    rule32, _ = _oracle_stats(ghist, ps)
    return keys, gids, merged, rule32


def _lg_check_groups(gs, oracle, ps, depth):
    """A GroupStats against the oracle: keys, order and sizes equal,
    counts exact, every percentile and edge bit-equal to the device's
    float32 rank rule and to merge_groups_host wherever the two rules
    pick the same rank, sums rtol 1e-5.  Returns (groups, percentile
    values checked, float64-rule ties)."""
    from loghisto_tpu_torch.labels.groupby import pct_key

    keys, gids, merged, rule32 = oracle
    assert list(gs.groups) == keys, "group order"
    assert gs.sizes == {k: gids.count(i) for i, k in enumerate(keys)}
    n_ps = len(ps) - (depth - 1 if depth else 0)
    checked = ties = 0
    for gi, gk in enumerate(keys):
        got, ref = gs.groups[gk], merged[gk]
        assert got["count"] == ref["count"] == rule32["counts"][gi], gk
        np.testing.assert_allclose(got["sum"], ref["sum"], rtol=1e-5)
        values = [got[pct_key(p)] for p in ps[:n_ps]] + list(
            got.get("edges", ()))
        assert len(values) == len(ps)
        for j, p in enumerate(ps):
            want32 = float(np.float32(rule32["percentiles"][gi, j]))
            assert values[j] == want32, (gk, p, values[j], want32)
            if values[j] != ref[pct_key(p)]:
                ties += 1
            checked += 1
    return len(keys), checked, ties


def phase_labels_group_by(torch):
    """Labels, selectors and group-by on the card:
    TorchMetricSystem(interval=1.0, num_metrics=1024, retention=True) at
    the reference's defaults (DEFAULT_TIERS, bucket_limit 4096, the fused
    commit) with 1024 labeled series of rpc.latency (route x code x
    method).  >= 4 live intervals through recorder(labels=) and
    histogram(labels=), the reaper and the committer, then 70 seeded
    intervals of 2^20 samples through backfill_retention; group_by by
    route, by (route, code) and over code=~5.. with depth=4, and a
    selector query, at 60 s (tier 0's full view) and 300 s (tier 1's,
    every interval), and a 45 s window nobody pinned (one K5 fallback,
    then the snapshot after the next commit); the windowed Prometheus
    exposition.  Held against a host oracle (the intervals' cells summed
    in int64)."""
    from loghisto_tpu_torch import TorchMetricSystem
    from loghisto_tpu_torch.channel import Channel
    from loghisto_tpu_torch.labels import LabelIndex, labels_of
    from loghisto_tpu_torch.labels.groupby import equidepth_ranks
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )
    from loghisto_tpu_torch.ops.stats import bucket_representatives
    from loghisto_tpu_torch.prometheus import windowed_exposition
    from loghisto_tpu_torch.window.store import pct_key

    names = _lg_names()
    m = len(names)
    rng = np.random.default_rng(SEED + 50)
    mu = rng.uniform(2.0, 8.0, m)
    sigma = rng.uniform(0.3, 1.5, m)
    ms = TorchMetricSystem(interval=1.0, num_metrics=m, retention=True)
    wheel, com = ms.retention, ms.committer
    assert ms.commit_path == "fused" and wheel.label_index is ms.label_index
    assert [tuple(t) for t in wheel.tiers] == [tuple(t) for t in RET_TIERS]
    for name in names:
        ms.metric_id(name)
    registry = ms.aggregator.registry
    assert [registry.lookup(n) for n in names] == list(range(m))
    capture = Channel(256)
    ms.subscribe_to_raw_metrics(capture)
    labels = [labels_of(n) for n in names]

    reset_kernel_launches()
    # -- live: recorder(labels=) and histogram(labels=), the reaper -------
    t_live = time.perf_counter()
    ms.start()
    deadline = time.monotonic() + 30.0
    try:
        while (com.fused_intervals < LG_LIVE
               or time.perf_counter() - t_live < LG_LIVE + 1.0):
            if time.monotonic() > deadline:
                raise AssertionError("live intervals did not arrive")
            for i in range(m):
                v = float(rng.lognormal(mu[i], sigma[i]))
                if i % 2:
                    ms.histogram("rpc.latency", v, labels=labels[i])
                else:
                    ms.recorder("rpc.latency", labels=labels[i]).record(v)
            time.sleep(0.1)
    finally:
        ms.stop()
    live_s = time.perf_counter() - t_live
    live = []
    while len(capture):
        live.append(capture.get(block=False))
    if len(live) != com.fused_intervals or len(live) < LG_LIVE:
        raise AssertionError(f"captured {len(live)} intervals, the "
                             f"committer took {com.fused_intervals}")
    if com.bridge_error is not None:
        raise AssertionError(f"bridge failed: {com.bridge_error!r}")
    cells = [_lg_cells(raw, registry) for raw in live]
    live_samples = int(sum(c[1].sum() for c in cells))

    # -- backfill: 70 intervals of 2^20 samples ------------------------------
    t_base, seq = live[-1].time, live[-1].seq
    commit_ms = []
    for k in range(LG_BACKFILL):
        raw = _raw_interval(rng, names, mu, sigma,
                            t_base + (k + 1) * _ONE_SECOND, seq + k + 1,
                            LG_SAMPLES)
        t0 = time.perf_counter()
        ms.backfill_retention([raw])
        torch.cuda.synchronize()
        commit_ms.append((time.perf_counter() - t0) * 1e3)
        cells.append(_lg_cells(raw, registry))
    n = len(cells)
    path_launches = kernel_launches()
    for kernel in ("sparse_ingest", "window_merge"):
        if path_launches[kernel] <= 0:
            raise AssertionError(f"{kernel} was not launched on the labels "
                                 "path")
    if com.fanout_intervals or com.fused_intervals != n:
        raise AssertionError(f"{com.fused_intervals} fused, "
                             f"{com.fanout_intervals} fan-out of {n}")

    # -- queries at this epoch ----------------------------------------------
    reps = bucket_representatives(BL).numpy()
    ps = tuple(float(p) for p in PS)
    queries = (("by_route", "rpc.latency{}", ("route",), None, LG_ROUTES),
               ("by_route_code", "rpc.latency{}", ("route", "code"), None,
                LG_ROUTES * len(LG_CODES)),
               ("5xx_depth4", "rpc.latency{code=~5..}", ("route",), 4,
                LG_ROUTES))
    windows = {60.0: n - RET_TIERS[0][0], 300.0: 0}
    hists = {w: _hist(cells[lo:], m) for w, lo in windows.items()}
    lat = collections.defaultdict(list)
    checks, n_ties = {}, 0
    for w, hist in hists.items():
        for qname, sel, by, depth, n_groups in queries:
            qps = ps + (equidepth_ranks(depth) if depth else ())
            t0 = time.perf_counter()
            _, matches = wheel._resolve_matches(sel)
            lat["resolve_ms"].append((time.perf_counter() - t0) * 1e3)
            before, hits = kernel_launches(), wheel.query_result_cache_hits
            t0 = time.perf_counter()
            gs = ms.query_group_by(sel, by=by, window=w, percentiles=ps,
                                   depth=depth)
            lat["cold_ms"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            again = ms.query_group_by(sel, by=by, window=w, percentiles=ps,
                                      depth=depth)
            lat["warm_ms"].append((time.perf_counter() - t0) * 1e3)
            if (again is not gs or kernel_launches() != before
                    or wheel.query_result_cache_hits != hits + 1):
                raise AssertionError(f"{qname} {w}: a warm repeat did work")
            rows = [mid for mid, _ in matches]
            want_rows = [i for i, n_ in enumerate(names)
                         if wheel._match_predicate(sel)(n_)]
            assert rows == want_rows, (qname, "selector rows")
            oracle = _lg_group_oracle(hist, names, rows, by, qps, reps)
            groups, checked, ties = _lg_check_groups(gs, oracle, qps, depth)
            if groups != n_groups:
                raise AssertionError(f"{qname} {w}: {groups} groups")
            n_ties += ties
            checks[f"{qname}@{w:g}"] = {
                "groups": groups, "rows": len(rows), "tier": gs.tier,
                "slots": gs.slots, "values_checked": checked,
                "float64_rule_ties": ties,
                "max_group_count": max(e["count"]
                                       for e in gs.groups.values())}
        # the selector query against a Python filter and the oracle
        sel = f"rpc.latency{{route=/r{7 % LG_ROUTES:02d},method!=GET}}"
        res = ms.query(sel, w, percentiles=ps)
        want_names = [n_ for n_, lab in zip(names, labels)
                      if lab["route"] == f"/r{7 % LG_ROUTES:02d}"
                      and lab["method"] != "GET"]
        if sorted(res.metrics) != sorted(want_names):
            raise AssertionError(f"selector {sel} rows differ")
        want, ties = _oracle_stats(hist)
        mask = np.zeros(m, bool)
        mask[[names.index(n_) for n_ in want_names]] = True
        sub = {k: v[mask] for k, v in want.items()}
        _check_window(res, want_names, sub)
        n_ties += ties
        checks[f"selector@{w:g}"] = {"rows": len(res.metrics)}

    # -- selector resolution on a fresh index ---------------------------------
    idx = LabelIndex(registry)
    t0 = time.perf_counter()
    idx.select("rpc.latency{code=~5..}", max_id=m)
    t1 = time.perf_counter()
    idx.select("rpc.latency{route=/r01,method!=GET}", max_id=m)
    t2 = time.perf_counter()
    idx.select("rpc.latency{route=/r01,method!=GET}", max_id=m)
    t3 = time.perf_counter()
    resolve = {"index_build_and_miss_ms": (t1 - t0) * 1e3,
               "miss_ms": (t2 - t1) * 1e3, "hit_ms": (t3 - t2) * 1e3,
               "wheel_resolve_ms": lat.pop("resolve_ms")}

    # -- the windowed Prometheus exposition -----------------------------------
    t0 = time.perf_counter()
    text = windowed_exposition(wheel, windows=(60.0, 300.0)).decode()
    expo_ms = (time.perf_counter() - t0) * 1e3
    types = [ln for ln in text.splitlines() if ln.startswith("# TYPE")]
    if types != ["# TYPE rpc_latency_w1m summary",
                 "# TYPE rpc_latency_w5m summary"]:
        raise AssertionError(f"exposition families {types}")
    for w, tag in ((60.0, "1m"), (300.0, "5m")):
        res = ms.query("*", w, percentiles=(0.5, 0.9, 0.99))
        counts = {}
        for ln in text.splitlines():
            head = f"rpc_latency_w{tag}_count{{"
            if ln.startswith(head):
                lstr, value = ln[len(head):].rsplit("} ", 1)
                counts[lstr] = float(value)
        want = {",".join(f'{k}="{v}"' for k, v in sorted(lab.items())):
                res.metrics[n_]["count"] for n_, lab in zip(names, labels)}
        if counts != want:
            raise AssertionError(f"exposition {tag} counts differ")

    # -- an unpinned window: one K5 fallback, then the snapshot ---------------
    w = float(LG_UNPINNED)
    assert w not in wheel.pinned_windows()
    sel, by = "rpc.latency{}", ("route",)
    before, falls = kernel_launches(), wheel.query_fallbacks
    t0 = time.perf_counter()
    gs = ms.query_group_by(sel, by=by, window=w, percentiles=ps)
    fallback_ms = (time.perf_counter() - t0) * 1e3
    after = kernel_launches()
    k5_fallback = after["window_merge"] - before["window_merge"]
    if wheel.query_fallbacks != falls + 1 or k5_fallback != 1:
        raise AssertionError(f"the fallback ran {k5_fallback} K5 launches")
    oracle = _lg_group_oracle(_hist(cells[n - int(w):], m), names,
                              list(range(m)), by, ps, reps)
    n_ties += _lg_check_groups(gs, oracle, ps, None)[2]
    raw = _raw_interval(rng, names, mu, sigma,
                        t_base + (LG_BACKFILL + 1) * _ONE_SECOND,
                        seq + LG_BACKFILL + 1, LG_SAMPLES)
    ms.backfill_retention([raw])
    cells.append(_lg_cells(raw, registry))
    before = kernel_launches()
    t0 = time.perf_counter()
    gs = ms.query_group_by(sel, by=by, window=w, percentiles=ps)
    pinned_cold_ms = (time.perf_counter() - t0) * 1e3
    if (wheel.query_fallbacks != falls + 1
            or kernel_launches()["window_merge"] != before["window_merge"]):
        raise AssertionError("the pinned window was not served from the "
                             "snapshot")
    oracle = _lg_group_oracle(_hist(cells[len(cells) - int(w):], m), names,
                              list(range(m)), by, ps, reps)
    n_ties += _lg_check_groups(gs, oracle, ps, None)[2]
    launches = kernel_launches()
    gauges = ms.collect_raw_metrics().gauges
    out = {
        "card": RESULTS.get("card"), "num_metrics": m,
        "tiers": [list(t) for t in RET_TIERS],
        "commit_path": ms.commit_path,
        "live": {"intervals": len(live), "wall_s": live_s,
                 "samples": live_samples},
        "backfill": {"intervals": LG_BACKFILL, "samples_each": LG_SAMPLES,
                     "commit_ms": float(np.mean(commit_ms))},
        "intervals_committed": com.fused_intervals,
        "launches_on_path": {k: v for k, v in path_launches.items() if v},
        "launches_per_interval": {k: v / n for k, v in path_launches.items()
                                  if v},
        "launches": {k: v for k, v in launches.items() if v},
        "group_by_ms": {"cold": lat["cold_ms"], "warm": lat["warm_ms"],
                        "fallback": fallback_ms,
                        "after_pin_cold": pinned_cold_ms},
        "selector_resolution": resolve, "exposition_ms": expo_ms,
        "exposition_bytes": len(text), "k5_fallback_launches": k5_fallback,
        "checks": checks, "float64_rule_ties": n_ties,
        "gauges": {k: v for k, v in gauges.items()
                   if k.startswith(("labels.", "commit.query_"))},
        "hbm_bytes": wheel.hbm_bytes(),
    }
    del ms, wheel, com
    torch.cuda.empty_cache()
    return out


# -- every dense ingest path, K8 and the firehose --------------------------

# (M, paths) of ingest_paths_main_path: every path the dispatch table
# admits at M, but matmul only where the JAX "auto" would consider it
# (M * B <= MATMUL_MAX_CELLS = 2^21); at 10,000 rows its one-hot would be
# 640k columns wide
IP_SHAPES = (
    (1, ("auto", "pallas", "scatter", "sort", "sortscan", "matmul",
         "hybrid", "fused")),
    (16, ("auto", "multirow", "scatter", "sort", "sortscan", "matmul",
          "hybrid")),
    (256, ("auto", "multirow", "scatter", "sort", "sortscan", "hybrid")),
    (M, ("auto", "multirow", "scatter", "sort", "sortscan", "hybrid")),
)
IP_INTERVALS = 2
IP_SAMPLES = 1 << 22
# the kernel each path must launch on the main path (None: the JAX
# package's XLA paths, plain PyTorch on the card)
PATH_KERNEL = {"fused": "fused_ingest", "row": "row_ingest",
               "pallas": "row_ingest", "multirow": "multirow_ingest"}
FH_BATCH = 1 << 22
FH_SHAPES = ((M, ("auto", "scatter", "sort", "sortscan", "hybrid")),
             (1, ("auto", "matmul")))
FH_SECONDS = 3.0
# independent profiler readings of the firehose's steady loop per path
PROFILE_READINGS = 3


def _k8_batches(rng, m):
    """Zipf(1.3), uniform and the adversarial inputs of K8 at M rows."""
    out = {
        "zipf": (zipf_ids(rng, BATCH, m), lognormal_values(rng, BATCH)),
        "uniform": (rng.integers(0, m, BATCH).astype(np.int32),
                    lognormal_values(rng, BATCH)),
    }
    ids, vals = out["uniform"][0].copy(), lognormal_values(rng, BATCH)
    adv_ids, adv_vals = _adversarial_block(rng, m)
    ids[:len(adv_ids)], vals[:len(adv_vals)] = adv_ids, adv_vals
    ids[len(adv_ids):len(adv_ids) + 1000] = -5   # more ids < 0 ...
    ids[len(adv_ids) + 1000:len(adv_ids) + 2000] = m + 3  # ... and >= M
    out["adversarial"] = (ids, vals)
    out["single"] = (np.array([m - 1], np.int32),
                     np.array([1.0], np.float32))
    # every sample in block 0: the M / 8 tail tiles are all filler
    out["one_block"] = (rng.integers(0, 8, BATCH).astype(np.int32),
                        lognormal_values(rng, BATCH))
    return out


def phase_k8(torch):
    from loghisto_tpu_torch.ops.codec import compress_np
    from loghisto_tpu_torch.ops.fused_ingest import fused_ingest_batch
    from loghisto_tpu_torch.ops.multirow_ingest import (
        ROWS_TILE,
        SAMPLE_TILE,
        device_clusters,
        histogram_runs,
        multirow_ingest,
        multirow_ingest_reference,
        preprocess,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 8)
    per_m, max_err = {}, 0
    for m in (16, 256, M):
        equal = {}
        for name, (ids, vals) in _k8_batches(rng, m).items():
            ids_d = torch.from_numpy(ids).to(dev)
            vals_d = torch.from_numpy(vals).to(dev)
            rows, bidx, tb = preprocess(ids_d, vals_d, m, ROWS_TILE, BL)
            acc_k = torch.zeros((m, B), dtype=torch.int32, device=dev)
            acc_p, acc_1 = torch.zeros_like(acc_k), torch.zeros_like(acc_k)
            multirow_ingest(acc_k, rows, bidx, tb)
            multirow_ingest_reference(acc_p, rows, bidx, tb, ROWS_TILE)
            fused_ingest_batch(acc_1, ids_d, vals_d, BL)
            torch.cuda.synchronize()
            equal[name] = (bool(torch.equal(acc_k, acc_p))
                           and bool(torch.equal(acc_k, acc_1)))
            max_err = max(max_err, int((acc_k - acc_p).abs().max()),
                          int((acc_k - acc_1).abs().max()))
            keep = (ids >= 0) & (ids < m)
            if int(acc_k.sum()) != int(keep.sum()):
                equal[name] = False
        if not all(equal.values()):
            raise AssertionError(f"K8 differs at M={m}: {equal}")

        ids, vals = _k8_batches(np.random.default_rng(SEED + 80 + m),
                                m)["zipf"]
        ids_d = torch.from_numpy(ids).to(dev)
        vals_d = torch.from_numpy(vals).to(dev)
        rows, bidx, tb = preprocess(ids_d, vals_d, m, ROWS_TILE, BL)
        g = tb.shape[0]
        row = tb.long().repeat_interleave(SAMPLE_TILE) * ROWS_TILE + rows
        real = rows < ROWS_TILE
        flat = row[real] * B + bidx[real].long()
        ones = torch.ones_like(flat, dtype=torch.int32)
        acc = torch.zeros((m, B), dtype=torch.int32, device=dev)
        k_ms = time_ms(torch, lambda: multirow_ingest(acc, rows, bidx, tb))
        k_cold = time_cold_ms(torch, lambda: multirow_ingest(acc, rows, bidx,
                                                             tb))
        # the route K8 chose: the runs that took the cluster histogram
        tb_np = tb.cpu().numpy()
        starts = np.flatnonzero(np.r_[True, tb_np[1:] != tb_np[:-1]])
        lengths, runs_of = np.unique(np.diff(np.r_[starts, g]),
                                     return_counts=True)
        clusters, span, fits = device_clusters(g, ROWS_TILE, B)
        hist_runs = histogram_runs(tb_np, clusters, span, ROWS_TILE, m, fits)
        per_tile = real.view(g, SAMPLE_TILE).sum(1).cpu().numpy()
        hist_share = float(sum(per_tile[a:e].sum() for a, e in hist_runs)
                           / max(1, per_tile.sum()))
        p_ms = time_ms(torch, lambda: multirow_ingest_reference(
            acc, rows, bidx, tb, ROWS_TILE))
        lib_ms = time_ms(torch, lambda: acc.view(-1).index_put_(
            (flat,), ones, accumulate=True))
        pre_ms = time_ms(torch, lambda: preprocess(
            ids_d, vals_d, m, ROWS_TILE, BL))
        cols = np.clip(compress_np(vals), -BL, BL).astype(np.int64) + BL
        cells = touched_cells(ids, cols, m)
        n_valid = int(((ids >= 0) & (ids < m)).sum())
        # rows of every entry, bidx and the tile's block only of the real
        # entries (the kernel skips filler), each touched cell's RMW
        b_ms, b_by = bound_ms(4 * g * SAMPLE_TILE + 4 * n_valid + 4 * g
                              + 8 * cells)
        per_m[str(m)] = {
            "equal": equal, "tiles": g, "layout_entries": g * SAMPLE_TILE,
            "layout_over_batch": g * SAMPLE_TILE / BATCH,
            "touched_cells": cells, "ms": k_ms, "time_cold_ms": k_cold,
            "run_lengths": {int(a): int(c) for a, c in zip(lengths, runs_of)},
            "clusters": clusters, "tiles_a_cluster": span,
            "histogram_runs": len(hist_runs),
            "histogram_entry_share": hist_share, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "preprocess_ms": pre_ms,
        }
        del acc, row, flat, ones
    RESULTS["multirow_ingest"] = {
        "max_abs_err": max_err,
        **{k: per_m[str(M)][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
    }
    return {"B": B, "batch": BATCH, "rows_tile": ROWS_TILE,
            "max_abs_err": max_err, "per_M": per_m,
            "library_call": "acc.view(-1).index_put_((flat,), 1, "
                            "accumulate=True) on the layout's precomputed "
                            "flat cells"}


def _ip_stream(rng, m):
    """IP_INTERVALS intervals of IP_SAMPLES samples: Zipf(1.3) ids (at
    M = 1: id 0, 1% dropped as -1) and lognormal values, 5% negated;
    each with its oracle statistics."""
    from loghisto_tpu_torch.ops.codec import compress_np

    out = []
    for _ in range(IP_INTERVALS):
        if m == 1:
            ids = np.zeros(IP_SAMPLES, np.int32)
            ids[rng.random(IP_SAMPLES) < 0.01] = -1
        else:
            ids = zipf_ids(rng, IP_SAMPLES, m)
        values = lognormal_values(rng, IP_SAMPLES)
        values[rng.random(IP_SAMPLES) < 0.05] *= -1
        keep = ids >= 0
        cols = np.clip(compress_np(values[keep]), -BL, BL).astype(
            np.int64) + BL
        hist = np.bincount(ids[keep].astype(np.int64) * B + cols,
                           minlength=m * B).reshape(m, B)
        out.append((ids, values, _oracle_stats(hist)[0]))
    return out


def _drive_path(torch, m, path, stream):
    """One (M, path) run: IP_INTERVALS intervals through record_batch +
    collect(), each checked against the host oracle; the launch counts
    are reset just before and read just after."""
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    agg = TorchAggregator(num_metrics=m, batch_size=BATCH, transport="raw",
                          ingest_path=path)
    names = [f"m{i}" for i in range(m)]
    for name in names:
        agg.registry.id_for(name)
    lifetime = {"count": np.zeros(m, np.int64),
                "sum": np.zeros(m, np.float64)}
    ingest_s, collect_ms = [], []
    reset_kernel_launches()
    try:
        for ids, values, want in stream:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for off in range(0, len(ids), BATCH):
                agg.record_batch(ids[off:off + BATCH],
                                 values[off:off + BATCH])
            agg.flush(force=True)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            metrics = agg.collect().metrics
            collect_ms.append((time.perf_counter() - t1) * 1e3)
            ingest_s.append(t1 - t0)
            _check_interval(metrics, names, want, lifetime, exact_pcts=False)
    finally:
        agg.close()
    launches = kernel_launches()
    kernel = PATH_KERNEL.get(agg.ingest_path)
    if kernel is not None and launches[kernel] <= 0:
        raise AssertionError(f"{kernel} was not launched on the {path} path")
    if kernel is None and any(launches.values()):
        raise AssertionError(f"the XLA path {path} launched {launches}")
    total = sum(len(s[0]) for s in stream)
    return {"ingest_path": agg.ingest_path,
            "samples_per_s": total / sum(ingest_s),
            # the last interval, after the first one's one-time costs
            "warm_samples_per_s": len(stream[-1][0]) / ingest_s[-1],
            "collect_ms": collect_ms,
            "multirow_launches": launches["multirow_ingest"],
            "fused_launches": launches["fused_ingest"],
            "row_launches": launches["row_ingest"]}


def phase_ingest_paths(torch):
    rng = np.random.default_rng(SEED + 50)
    columns = ("M", "path", "ingest_path", "samples_per_s",
               "warm_samples_per_s", "collect_ms", "multirow_launches",
               "fused_launches", "row_launches")
    table, k8_launches = [], 0
    for m, paths in IP_SHAPES:
        stream = _ip_stream(rng, m)
        for path in paths:
            run = {"M": m, "path": path, **_drive_path(torch, m, path, stream)}
            table.append([run[c] for c in columns])
            k8_launches += run["multirow_launches"]
        del stream
    RESULTS.setdefault("multirow_ingest", {})["launches"] = k8_launches
    return {"intervals": IP_INTERVALS, "samples_per_interval": IP_SAMPLES,
            "batch_size": BATCH, "transport": "raw", "columns": columns,
            "table": table}


class _Sink:
    """An in-process TCP listener that keeps every byte it is sent, one
    entry per connection; ``port`` rebinds a port a closed sink held."""

    def __init__(self, port=0):
        import socket
        import threading

        self._srv = socket.create_server(("127.0.0.1", port))
        self._srv.settimeout(0.2)
        self.address = self._srv.getsockname()
        self.data = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        import socket

        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            with conn:
                chunks = []
                while True:
                    chunk = conn.recv(1 << 16)
                    if not chunk:
                        break
                    chunks.append(chunk)
                self.data.append(b"".join(chunks))

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._srv.close()


def _parse_opentsdb(payload: bytes) -> int:
    """Lines of one export, each ``put <metric> <ts> <value> host=<h>``;
    returns how many."""
    import re

    line_re = re.compile(r"put firehose_\d+_\S+ \d+ -?\d+\.\d{6} host=\S+\Z")
    lines = payload.decode().splitlines()
    bad = [ln for ln in lines if not line_re.match(ln)]
    if not lines or bad:
        raise AssertionError(f"malformed OpenTSDB export: {bad[:3]}")
    return len(lines)


def _device_busy(torch, fn):
    """Device busy and idle share over one call of ``fn`` (which ends in
    a synchronize): the summed time of the card's kernels in a
    ``torch.profiler`` trace of one call against the host wall clock of
    the call without the profiler (the median of 3; the profiler's own
    host cost would inflate it), and the kernels that took most of it.
    A first, unrecorded call takes the profiler's start-up out of the
    trace.  CUPTI on the card's machine now and then hands back a trace
    with no device activity at all; such a trace is taken again, up to
    three times, and counted in ``empty_traces``; three empty traces
    fail."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(walls)[1]
    for empty in range(3):
        traced = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: traced.extend(p.events())) as prof:
            fn()
            prof.step()
            t0 = time.perf_counter()
            fn()
            profiled_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
        kernels = collections.Counter()
        for e in traced:
            # device-side events, but not the profiler's own step annotation
            if (str(getattr(e, "device_type", "")).endswith("CUDA")
                    and not e.name.startswith("ProfilerStep")):
                kernels[e.name] += e.time_range.elapsed_us() / 1e3
        if kernels:
            break
    else:
        raise RuntimeError("three traces held no kernel of the card")
    busy_ms = sum(kernels.values())
    return {"wall_ms": wall_ms, "profiled_wall_ms": profiled_ms,
            "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "empty_traces": empty,
            "top_kernels_ms": dict(kernels.most_common(5))}


def phase_firehose(torch):
    import io

    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.firehose import (
        _make_sample_generator,
        make_firehose_step,
        run_firehose,
    )
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )

    dev = torch.device("cuda")
    cfg = MetricConfig()
    steps, out = 2, {}
    for m, paths in FH_SHAPES:
        accs = {}
        generate = _make_sample_generator(m, 10.0, 2.0, dev)
        gen = torch.Generator(device=dev)
        gen_ms = time_ms(torch, lambda: generate(gen, FH_BATCH), reps=10)
        out[f"{m}/generate"] = {"ms": gen_ms}
        for path in paths:
            step = make_firehose_step(m, FH_BATCH, cfg, ingest_path=path)
            acc = torch.zeros((m, B), dtype=torch.int32, device=dev)
            gen = torch.Generator(device=dev)
            gen.manual_seed(SEED)
            for _ in range(steps):
                acc, gen = step(acc, gen)
            torch.cuda.synchronize()
            if int(acc.sum()) != steps * FH_BATCH:
                raise AssertionError(
                    f"firehose {m}/{path} lost samples: {int(acc.sum())}")
            accs[path] = acc.clone()
            step_ms = time_ms(torch, lambda: step(acc, gen), reps=5,
                              warmup=1)
            out[f"{m}/{path}"] = {"ingest_path": step.ingest_path,
                                  "step_ms": step_ms,
                                  "accumulate_ms": step_ms - gen_ms,
                                  "device_samples_per_s":
                                      FH_BATCH / step_ms * 1e3}
            if path == "auto":
                # run_firehose's steady loop: max_inflight (8) steps,
                # then a synchronize
                def interval():
                    for _ in range(8):
                        step(acc, gen)
                    torch.cuda.synchronize()

                runs = [_device_busy(torch, interval)
                        for _ in range(PROFILE_READINGS)]
                idle = [r["idle_share"] for r in runs]
                out[f"{m}/{path}"]["profile"] = {
                    "idle_share": idle, "idle_spread": max(idle) - min(idle),
                    "readings": runs}
        ref = "scatter" if "scatter" in accs else "auto"
        for path, acc in accs.items():
            if not torch.equal(acc, accs[ref]):
                raise AssertionError(f"firehose {m}/{path} != {m}/{ref}")
        del accs

    sink = _Sink()
    try:
        for m, paths in FH_SHAPES:
            for path in paths:
                text = io.StringIO()
                n_before = len(sink.data)
                reset_kernel_launches()
                summary = run_firehose(
                    num_metrics=m, batch=FH_BATCH, seconds=FH_SECONDS,
                    interval=1.0, sink=sink.address, ingest_path=path,
                    out=text, seed=SEED)
                launches = kernel_launches()
                deadline = time.time() + 5.0
                while (len(sink.data) < n_before + summary["intervals"]
                       and time.time() < deadline):
                    time.sleep(0.05)
                payloads = sink.data[n_before:]
                if len(payloads) != summary["intervals"] or (
                        "error" in text.getvalue()):
                    raise AssertionError(
                        f"firehose {m}/{path}: {len(payloads)} exports for "
                        f"{summary['intervals']} intervals: "
                        f"{text.getvalue()}")
                lines = [_parse_opentsdb(p) for p in payloads]
                kernel = PATH_KERNEL.get(summary["ingest_path"])
                if kernel is not None and launches[kernel] <= 0:
                    raise AssertionError(
                        f"{kernel} was not launched by the firehose")
                out[f"{m}/{path}"].update({
                    "run_samples_per_s": summary["samples_per_s"],
                    "intervals": summary["intervals"],
                    "total_samples": summary["total_samples"],
                    "export_lines": lines, "launches": {
                        k: v for k, v in launches.items() if v}})
    finally:
        sink.close()
    return {"batch": FH_BATCH, "seconds": FH_SECONDS, "steps_checked": steps,
            "runs": out}


# -- observability, PrintBenchmark and the Submitter ------------------------

# (a) the retention system of retention_main_path with observability=True:
# live intervals of 2^20 lognormal samples through the reaper, each fed
# half an interval after its boundary; (e) its processed intervals shipped
# by the Submitter, the listener down for OB_DOWN intervals; (b) the paged
# lifecycle phase's system (2^16 rows, PL_TIERS, the churn stream, no
# lifecycle) in two passes, the second with a pool that its live pages
# fill to OB_PAGED_FILL; (c) one collect() of the headline aggregator
# under LOGHISTO_TRACE_DIR; (d) PrintBenchmark
# on the card in token and handle modes
OB_INTERVALS = 8
OB_SAMPLES = 1 << 20
OB_DOWN = 3
OB_PAGED_INTERVALS = 4
OB_PAGED_FILL = 0.95
OB_PRINT_S = 10.0
OB_CONCURRENCY = 8
OB_STAGES = ("commit.cells", "commit.upload", "commit.dispatch",
             "commit.device_sync", "commit.snapshot_publish")
OB_DUMP_KEYS = {"commit_path", "commit_path_reason", "mesh", "registry",
                "rings", "transport", "query", "labels", "commit", "obs",
                "health"}


def _ob_wait(cond, what, limit=60.0, counters=None):
    """Poll ``cond`` until ``limit`` s pass; at the deadline the error
    carries ``counters()`` (a dict) when given."""
    deadline = time.monotonic() + limit
    while not cond():
        if time.monotonic() > deadline:
            extra = "" if counters is None else f"; {json.dumps(counters())}"
            raise AssertionError(
                f"{what} did not happen within {limit} s{extra}")
        time.sleep(0.02)


class _ObFeeder:
    """Feeds OB_SAMPLES lognormal samples over the names through
    histogram_batch once an interval: the first batch at start, then one
    half an interval past each boundary, so that it neither races the
    reaper's collection nor shares the host with the commit that
    follows it."""

    def __init__(self, ms, names, seed):
        import threading

        self.ms, self.names = ms, names
        self.rng = np.random.default_rng(seed)
        self.mu = self.rng.uniform(2.0, 8.0, len(names))
        self.sigma = self.rng.uniform(0.3, 1.5, len(names))
        self.batches = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ob-feeder")

    def feed(self):
        per = OB_SAMPLES // len(self.names)
        for i, name in enumerate(self.names):
            self.ms.histogram_batch(
                name, self.rng.lognormal(self.mu[i], self.sigma[i], per))
        self.batches += 1

    def _run(self):
        # the reaper's intervals, not the commits: a stalled commit must
        # not starve the intervals of samples
        while not self._stop.is_set():
            interval = self.ms.interval
            self._stop.wait((0.5 * interval - time.time()) % interval)
            if not self._stop.is_set():
                self.feed()

    def start(self):
        self.feed()
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=30.0)


def _ob_graphite_ts(payload: bytes) -> int:
    """The one timestamp of a Graphite payload (one interval's lines)."""
    stamps = {ln.rsplit(" ", 1)[1] for ln in payload.decode().splitlines()}
    if len(stamps) != 1:
        raise AssertionError(f"a payload holds {len(stamps)} timestamps")
    return int(stamps.pop())


def _ob_get(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _ob_percentiles(hist):
    return {"p50_us": hist.percentile(50.0), "p99_us": hist.percentile(99.0),
            "count": hist.count}


def _ob_retention(torch, observed):
    """(a), and (e) when observed; returns the phase's report of it."""
    import tempfile

    from loghisto_tpu_torch import TorchMetricSystem
    from loghisto_tpu_torch.channel import Channel
    from loghisto_tpu_torch.graphite import graphite_protocol
    from loghisto_tpu_torch.obs import dump_perfetto
    from loghisto_tpu_torch.prometheus import PrometheusEndpoint
    from loghisto_tpu_torch.submitter import new_submitter

    names = [f"g{i // 64:02d}.m{i % 64:02d}" for i in range(RET_M)]
    ms = TorchMetricSystem(interval=1.0, num_metrics=RET_M, retention=True,
                           observability=True if observed else None)
    com = ms.committer
    if ms.commit_path != "fused" or com is None:
        raise AssertionError(f"commit path {ms.commit_path}")
    if [tuple(t) for t in ms.retention.tiers] != [tuple(t)
                                                  for t in RET_TIERS]:
        raise AssertionError("not the reference's default tiers")
    for name in names:
        ms.metric_id(name)
    feeder = _ObFeeder(ms, names, SEED + 70)
    if not observed:
        ms.start()
        feeder.start()
        try:
            _ob_wait(lambda: com.intervals_committed >= OB_INTERVALS,
                     "the unobserved commits")
        finally:
            feeder.stop()
            ms.stop()
        out = {"commit": _ob_percentiles(com._latency_hist),
               "intervals": com.intervals_committed}
        del ms, com
        gc.collect()
        torch.cuda.empty_cache()
        return out

    processed = Channel(512)
    ms.subscribe_to_processed_metrics(processed)
    serialized = []  # (interval timestamp, listener up?) in send order
    sink = [_Sink()]
    addr = sink[0].address
    up = [True]

    def serializer(pms):
        payload = graphite_protocol(pms)
        serialized.append((_ob_graphite_ts(payload), up[0]))
        return payload

    sub = new_submitter(ms, serializer, "tcp", addr)
    sub.register_gauges()
    ep = PrometheusEndpoint(ms, port=0, host="127.0.0.1")
    url = None
    depth_max = 0
    try:
        ep.start()
        url = f"http://127.0.0.1:{ep.port}/healthz"
        ms.start()
        sub.start()
        feeder.start()

        def committed(n):
            _ob_wait(lambda: com.intervals_committed >= n,
                     f"{n} committed intervals")

        committed(2)
        _ob_wait(lambda: len(sink[0].data) >= 1, "a delivery")
        # (e) the listener goes down for OB_DOWN intervals
        sink[0].close()
        up[0] = False
        n_down = com.intervals_committed
        while com.intervals_committed < n_down + OB_DOWN:
            depth_max = max(depth_max, sub.backlog_depth())
            time.sleep(0.05)
        depth_max = max(depth_max, sub.backlog_depth())
        failures_down = sub.send_failures
        sink.append(_Sink(port=addr[1]))
        up[0] = True
        committed(OB_INTERVALS)
        report_ok = ms.health.report()
        if not report_ok.ok:
            raise AssertionError(f"health not ok: {report_ok.as_dict()}")
        status_ok, doc_ok = _ob_get(url)
        # (a) a stall: the bridge takes intervals and commits none
        real_commit = com.commit
        com.commit = lambda raw: None
        t_stall = time.perf_counter()
        _ob_wait(lambda: ms.health.report().status == "stalled",
                 "the stall report", limit=30.0)
        stall_s = time.perf_counter() - t_stall
        status_stall, doc_stall = _ob_get(url)
        com.commit = real_commit
        n_resume = com.intervals_committed
        committed(n_resume + 2)
        status_back, doc_back = _ob_get(url)
        # (e) the backlog drains: its gauge returns to 0
        depth_gauge = ms._gauge_funcs["export.BacklogDepth"]
        _ob_wait(lambda: depth_gauge() == 0.0, "the backlog drain")
        committed(com.intervals_committed + 2)
        _ob_wait(lambda: sub.backlog_depth() == 0, "the last sends")
    finally:
        feeder.stop()
        sub.shutdown()
        ep.stop()
        ms.stop()
        for s in sink:
            s.close()
    spans = ms.obs.spans()
    by_seq = collections.defaultdict(list)
    for s in spans:
        by_seq[s.seq].append(s)
    e2e = [s for s in spans if s.stage == "commit.e2e"]
    if len(e2e) != com.intervals_committed:
        raise AssertionError(f"{len(e2e)} e2e spans for "
                             f"{com.intervals_committed} commits")
    seqs = [s.seq for s in e2e]
    if any(b <= a for a, b in zip(seqs, seqs[1:])) or seqs[0] < 1:
        raise AssertionError(f"e2e seqs not strictly increasing: {seqs}")
    stage_us = collections.defaultdict(list)
    for parent in e2e:
        kids = [s for s in by_seq[parent.seq] if s is not parent
                and s.stage.startswith("commit.")]
        missing = set(OB_STAGES) - {s.stage for s in kids}
        if missing:
            raise AssertionError(f"seq {parent.seq} lacks {missing}")
        for s in kids:
            if s.thread != parent.thread or not (
                    parent.start_ns <= s.start_ns <= s.end_ns
                    <= parent.end_ns):
                raise AssertionError(f"{s.stage} of seq {parent.seq} is "
                                     "not inside its commit.e2e")
            stage_us[s.stage].append(s.duration_us)
        stage_us["commit.e2e"].append(parent.duration_us)
    # what the self-observer was handed: each seq's spans closed by the
    # end of its commit.e2e (the hand-over follows it)
    handed = sum(1 for parent in e2e for s in by_seq[parent.seq]
                 if s.end_ns <= parent.end_ns)
    if ms.self_observer.reingested != handed or not handed:
        raise AssertionError(f"reingested {ms.self_observer.reingested} "
                             f"of {handed} spans")
    if ms.obs.dropped:
        raise AssertionError(f"{ms.obs.dropped} spans dropped")
    sets = []
    while len(processed):
        sets.append(processed.get(block=False).metrics)
    e2e_rows = [m.get("obs.commit.e2e.LatencyUs_count", 0.0) for m in sets]
    if not any(e2e_rows):
        raise AssertionError("obs.commit.e2e.LatencyUs reached no "
                             "processed set")
    # the gauge as the intervals read it: it rose while the listener was
    # down (one payload a boundary in flight is normal, so >= 2)
    depths = [m.get("export.BacklogDepth", 0.0) for m in sets]
    if max(depths) < 2.0:
        raise AssertionError(f"export.BacklogDepth {depths}")
    if any(m.get("obs.SpansDropped") for m in sets):
        raise AssertionError("obs.SpansDropped is not 0")
    # /healthz across the stall
    if (status_ok, status_stall, status_back) != (200, 503, 200):
        raise AssertionError(f"/healthz {status_ok} {status_stall} "
                             f"{status_back}")
    if doc_stall["reasons"][0]["code"] != "no_commit" or \
            doc_back["status"] != "ok":
        raise AssertionError(f"/healthz documents {doc_stall} {doc_back}")
    # (e) every interval serialized, delivered exactly once and in order;
    # those serialized while the listener was down arrive after it returns
    got = [_ob_graphite_ts(p) for s in sink for p in s.data]
    sent = [ts for ts, _ in serialized]
    # at most the payload serialized after the last send is undelivered
    if got != sent[:len(got)] or len(sent) - len(got) > 1:
        raise AssertionError(f"delivered {got} != serialized {sent}")
    while_down = [ts for ts, was_up in serialized if not was_up]
    after = {_ob_graphite_ts(p) for p in sink[1].data}
    if not while_down or not set(while_down) <= after:
        raise AssertionError(f"intervals sent while down {while_down} did "
                             "not arrive after the return")
    if not 0 < depth_max < 60:
        raise AssertionError(f"backlog depth {depth_max} while down")
    # Perfetto: one event per span
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "obs_trace.json")
        n_events = dump_perfetto(ms.obs, path)
        with open(path) as f:
            doc = json.load(f)
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    if len(xs) != len(spans) or n_events != len(doc["traceEvents"]):
        raise AssertionError(f"{len(xs)} trace events for {len(spans)} "
                             "spans")
    dump = ms.debug_dump()
    if set(dump) != OB_DUMP_KEYS or not dump["obs"]["enabled"]:
        raise AssertionError(f"debug_dump keys {sorted(dump)}")
    out = {
        "intervals_committed": com.intervals_committed,
        "batches_fed": feeder.batches, "samples_per_batch": OB_SAMPLES,
        "seqs": seqs, "spans": len(spans),
        "reingested": ms.self_observer.reingested,
        "spans_dropped": ms.obs.dropped,
        "stage_us_median": {k: float(np.median(v))
                            for k, v in stage_us.items()},
        "stage_us_max": {k: float(np.max(v)) for k, v in stage_us.items()},
        "commit": _ob_percentiles(com._latency_hist),
        "e2e_self_observed": _ob_percentiles(
            ms.self_observer.commit_latency),
        "healthz": {"ok": status_ok, "stalled": status_stall,
                    "resumed": status_back, "stall_detected_s": stall_s,
                    "stall_reason": doc_stall["reasons"][0]},
        "submitter": {"serialized": len(sent), "delivered": len(got),
                      "backlog_gauge": depths,
                      "while_down": len(while_down),
                      "backlog_depth_max": depth_max,
                      "send_failures": sub.send_failures,
                      "failures_while_down": failures_down,
                      "bytes_sent": sub.bytes_sent},
        "perfetto_events": n_events,
        "debug_dump": {"commit": dump["commit"], "obs": dump["obs"],
                       "health": dump["health"]["status"]},
    }
    del ms, com
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ob_paged_pass(torch, pool):
    """The churn stream's first OB_PAGED_INTERVALS intervals through
    paged_lifecycle_main_path's system with observability; returns its
    pool state and the watchdog's report."""
    from loghisto_tpu_torch import TorchMetricSystem
    from loghisto_tpu_torch.paging import PagedStoreConfig

    rng = np.random.default_rng((SEED, 61))
    mu = rng.uniform(2.0, 6.0, PL_STEADY)
    sigma = rng.uniform(0.3, 1.0, PL_STEADY)
    t0 = _dt.datetime(2026, 10, 17, tzinfo=_dt.timezone.utc)
    ms = TorchMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=PL_M, retention=PL_TIERS,
        storage="paged", paged_config=PagedStoreConfig(pool_pages=pool,
                                                       codec="auto"),
        observability=True)
    paged = ms.aggregator.paged
    if paged is None or ms.commit_path != "fused":
        raise AssertionError("not the paged fused commit")
    for name in (f"api.s{i}.lat" for i in range(PL_STEADY)):
        ms.metric_id(name)
    t1 = time.perf_counter()
    for k in range(OB_PAGED_INTERVALS):
        raw, _, _ = _pl_stream(k, mu, sigma, PL_STEADY, PL_FRESH, PL_SAMPLES,
                               t0)
        ms.backfill_retention([raw])
    torch.cuda.synchronize()
    commit_s = time.perf_counter() - t1
    if paged._host_spill or paged.spilled_cells or paged.overflowed_cells:
        raise AssertionError("cells left the pool")
    rep = ms.health.report()
    out = {"pool_pages": pool, "occupied_pages": paged.occupied_pages,
           "saturation": paged.pool_saturation(),
           "shard_occupancy": paged.shard_occupancy(),
           "live_rows": len(ms.aggregator.registry),
           "report": rep.as_dict(), "commit_s": commit_s}
    ms.stop()
    del ms, paged
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ob_trace(torch):
    """(c): one collect() of the headline aggregator under
    LOGHISTO_TRACE_DIR; the buffered batch ships inside the capture.
    CUPTI on the card's machine now and then hands back a trace with no
    device activity at all (``_device_busy``); such a capture is taken
    again with a fresh batch, up to three times, and counted in
    ``empty_traces``; three empty traces fail."""
    import glob
    import tempfile

    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    rng = np.random.default_rng(SEED + 71)
    # a batch_size past the batch: record_batch only buffers it
    agg = TorchAggregator(num_metrics=M, batch_size=2 * BATCH)
    for i in range(M):
        agg.registry.id_for(f"m{i}")
    old = os.environ.get("LOGHISTO_TRACE_DIR")
    try:
        for empty in range(3):
            agg.record_batch(zipf_ids(rng, BATCH, M),
                             lognormal_values(rng, BATCH))
            with tempfile.TemporaryDirectory() as tmp:
                os.environ["LOGHISTO_TRACE_DIR"] = tmp
                t0 = time.perf_counter()
                metrics = agg.collect().metrics
                collect_s = time.perf_counter() - t0
                paths = glob.glob(os.path.join(tmp, "loghisto_collect",
                                               "*.json"))
                if len(paths) != 1:
                    raise AssertionError(f"{len(paths)} trace files written")
                size = os.path.getsize(paths[0])
                with open(paths[0]) as f:
                    events = json.load(f)["traceEvents"]
            total = sum(metrics.get(f"m{i}_count", 0.0) for i in range(M))
            if total != BATCH:
                raise AssertionError(f"collect counted {total} of {BATCH}")
            kernels = [e for e in events if e.get("cat") == "kernel"]
            if kernels:
                break
        else:
            raise AssertionError("three traces held no kernel of the card")
    finally:
        if old is None:
            os.environ.pop("LOGHISTO_TRACE_DIR", None)
        else:
            os.environ["LOGHISTO_TRACE_DIR"] = old
        agg.close()
    names = [e.get("name", "") for e in events]
    k1 = [e for e in kernels if "lh_fused_ingest_kernel" in e["name"]]
    if "loghisto_collect" not in names:
        raise AssertionError("the trace lacks the loghisto_collect region")
    if not k1:
        seen = sorted({e["name"][:60] for e in kernels})
        raise AssertionError(f"the trace lacks K1's kernel: {seen}")
    return {"events": len(events), "bytes": size,
            "kernel_events": len(kernels), "empty_traces": empty,
            "k1_events": len(k1), "k1_device_us": sum(e.get("dur", 0.0)
                                                      for e in k1),
            "kernel_names": sorted({e["name"][:60] for e in kernels}),
            "collect_s_with_capture": collect_s}


def _ob_print_benchmark(handles):
    """(d): print_benchmark(device=True) for OB_PRINT_S seconds."""
    import io

    from loghisto_tpu_torch.print_benchmark import (
        _interesting_metrics,
        print_benchmark,
    )

    out = io.StringIO()
    t0 = time.perf_counter()
    print_benchmark("bench_op", concurrency=OB_CONCURRENCY, op=lambda: None,
                    duration=OB_PRINT_S, interval=1.0, out=out, device=True,
                    handles=handles)
    wall_s = time.perf_counter() - t0
    want = _interesting_metrics("bench_op")
    text = out.getvalue()
    if not text.endswith("\n\n"):
        raise AssertionError("a block was cut")
    counts, lifetime = [], 0.0
    blocks = [b.split("\n") for b in text.split("\n\n") if b]
    for block in blocks:
        if [ln.split(":")[0] for ln in block[1:]] != want:
            raise AssertionError(f"a block is not the 19 lines: {block}")
        v = {k.strip().rstrip(":"): float(x)
             for k, x in (ln.split("\t") for ln in block[1:])}
        if v["bench_op_count"]:
            if not (v["bench_op_min"] <= v["bench_op_50"]
                    <= v["bench_op_99"] <= v["bench_op_max"]):
                raise AssertionError(f"percentiles out of order: {v}")
            counts.append(v["bench_op_count"])
        lifetime = max(lifetime, v["bench_op_agg_count"])
    if len(counts) < 3:
        raise AssertionError(f"{len(counts)} blocks with samples")
    # a block holds what the card merged since the last one (none, one or
    # two intervals, and the host's count when none): the rate is the
    # largest lifetime count printed over the run's wall time, a lower
    # bound (the last interval is never printed)
    return {"blocks": len(blocks), "nonzero_blocks": len(counts),
            "ops_per_block": counts, "ops_per_s": lifetime / wall_s,
            "wall_s": wall_s}


def phase_observability(torch):
    """Observability on the card: (a) TorchMetricSystem(interval=1.0,
    num_metrics=1024, retention=True, observability=True) at the
    reference's default tiers, OB_INTERVALS live intervals of 2^20
    lognormal samples through the reaper and the fused commit (K3, K5):
    every committed interval's complete nested span set, the dogfooded
    obs.commit.e2e rows, the watchdog ok, a stall (a no-op commit)
    answered 503 no_commit on /healthz and 200 once commits resume, the
    Perfetto dump, debug_dump, no span dropped, and the commit's p50/p99
    beside an identical system without observability; (b) the paged
    system with a pool that its live pages fill past 90% (K4): the
    watchdog's pool_saturation equals the store's; (c) a
    LOGHISTO_TRACE_DIR capture of collect() holding the region and K1;
    (d) print_benchmark(device=True) in both modes; (e) the Submitter
    ships (a)'s intervals, the listener down OB_DOWN intervals, every one
    delivered once and in order."""
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )

    reset_kernel_launches()
    t0 = time.perf_counter()
    observed = _ob_retention(torch, observed=True)
    plain = _ob_retention(torch, observed=False)
    retention_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    first = _ob_paged_pass(torch, PL_POOL)
    pool = int(first["occupied_pages"] / OB_PAGED_FILL) + 1
    second = _ob_paged_pass(torch, pool)
    if second["occupied_pages"] != first["occupied_pages"]:
        raise AssertionError("the second pass mapped other pages")
    rep = second["report"]
    sat = [r for r in rep["reasons"] if r["code"] == "pool_saturation"]
    if not sat or sat[0]["value"] != second["saturation"] \
            or second["saturation"] < 0.9 or rep["status"] != "degraded":
        raise AssertionError(f"pool_saturation not reported: {rep}")
    if first["report"]["status"] != "ok":
        raise AssertionError(f"the roomy pool is not ok: {first['report']}")
    paged_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    traced = _ob_trace(torch)
    trace_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    bench = {mode: _ob_print_benchmark(handles)
             for mode, handles in (("tokens", False), ("handles", True))}
    bench_s = time.perf_counter() - t0

    launches = kernel_launches()
    for kernel in ("fused_ingest", "sparse_ingest", "paged_scatter",
                   "window_merge"):
        if launches[kernel] <= 0:
            raise AssertionError(f"{kernel} was not launched")
        RESULTS.setdefault(kernel, {})["launches"] = (
            RESULTS.get(kernel, {}).get("launches", 0) + launches[kernel])
    return {
        "retention": {"observed": observed, "unobserved": plain,
                      "s": retention_s},
        "paged": {"roomy": {k: v for k, v in first.items()
                            if k != "report"},
                  "saturated": second, "s": paged_s},
        "trace": {**traced, "s": trace_s},
        "print_benchmark": {**bench, "s": bench_s},
        "launches": {k: launches[k] for k in (
            "fused_ingest", "sparse_ingest", "paged_scatter",
            "window_merge")},
    }


KERNEL_META = {
    "fused_ingest": ("loghisto_tpu_torch/csrc/fused_ingest.cu",
                     "loghisto_tpu/ops/fused_ingest.py:169", None),
    "row_ingest": ("loghisto_tpu_torch/csrc/row_ingest.cu",
                   "loghisto_tpu/ops/pallas_kernels.py:158",
                   "loghisto_tpu/ops/pallas_kernels.py:46"),
    "sparse_ingest": ("loghisto_tpu_torch/csrc/sparse_ingest.cu",
                      "loghisto_tpu/ops/sparse_ingest.py:66", None),
    "paged_scatter": ("loghisto_tpu_torch/csrc/paged_store.cu",
                      "loghisto_tpu/ops/paged_store.py:115", None),
    "fused_paged_ingest": ("loghisto_tpu_torch/csrc/paged_store.cu",
                           "loghisto_tpu/ops/fused_ingest.py:301", None),
    "window_merge": ("loghisto_tpu_torch/csrc/window_merge.cu",
                     "loghisto_tpu/ops/window.py:62", None),
    "compact_rows": ("loghisto_tpu_torch/csrc/compact_rows.cu",
                     "loghisto_tpu/ops/lifecycle.py:166", None),
    "divergence": ("loghisto_tpu_torch/csrc/divergence.cu",
                   "loghisto_tpu/ops/anomaly.py:141", None),
    "multirow_ingest": ("loghisto_tpu_torch/csrc/multirow_ingest.cu",
                        "loghisto_tpu/ops/pallas_multirow.py:106", None),
}


# -- resilience ----------------------------------------------------------------

# (a) the retention system of checkpoint_journal_main_path (c) with
# resilience= (checkpoint every RS_CKPT_EVERY intervals, the journal): a
# spawned child fed by hand is SIGKILLed once its journal holds seq
# RS_KILL_AT, and a fresh system recovers its files; (b) a chaos drill on
# the same system through the reaper's tick, RS_DRILL_SAMPLES samples an
# interval; (c) D6: a fused commit failing before chunk RS_D6_CHUNK of an
# interval, on the default-tier system without lifecycle; (d) an
# agg.ingest failure in the middle of an RS_REQUEUE_SAMPLES interval at
# the headline width (K1); (e) a wedged transfer worker past
# max_pending_samples; (f) the commit's p50 / p99 with resilience= and no
# injector against the same system without it, RS_COST_INTERVALS
# intervals each, then RS_COST_SPLIT intervals split by span (48: over
# 8-12 intervals one system's p50 stood 2.5-8 ms off two identical ones,
# over 48 none did; scripts/torch_resilience_cost.py)
RS_KILL_AT = 7
RS_CHILD_MAX = 20
RS_CKPT_EVERY = 2
RS_DRILL_NAMES = 64
RS_DRILL_SAMPLES = 1 << 16
RS_BREAKER = 3
RS_OPEN_S = 1.0
RS_D6_CHUNK = 1
RS_REQUEUE_SAMPLES = 1 << 24
RS_COOLDOWN_S = 2.0
RS_WEDGE_SAMPLES = 1 << 23
RS_COST_INTERVALS = 48
RS_COST_SPLIT = 6


def _rs_stream():
    rng = np.random.default_rng((SEED, 91))
    steady = [f"svc.{k}.latency" for k in range(LD_STEADY)]
    return (rng, steady, rng.uniform(2.0, 6.0, LD_STEADY),
            rng.uniform(0.3, 1.0, LD_STEADY))


def _rs_child(tmp, ticked):
    """(a)'s child: the resilient retention system, one 2^20-sample
    interval after another through the reaper's tick, until it is
    killed.  ``ticked`` holds the seq of the last interval it minted."""
    import queue

    import torch

    from loghisto_tpu_torch.resilience import ResilienceConfig

    ms, _ = _cj_retention_system(torch, resilience=ResilienceConfig(
        checkpoint_path=f"{tmp}/state.npz", journal_path=f"{tmp}/raw.jsonl",
        checkpoint_every_intervals=RS_CKPT_EVERY, recover_on_start=False))
    ms.recovery.start()  # the journal's subscriber
    rng, steady, mu, sigma = _rs_stream()
    q, com = queue.Queue(), ms.committer
    for k in range(1, RS_CHILD_MAX + 1):
        _cj_record(ms, rng, k, steady, mu, sigma)
        ticked.value = k
        ms._tick(q)
        deadline = time.monotonic() + 60.0
        while com.intervals_committed < k and time.monotonic() < deadline:
            time.sleep(0.002)
    while True:  # wait for the kill
        time.sleep(1.0)


def _rs_journal_lines(path):
    try:
        with open(path, "rb") as f:
            return f.read().count(b"\n")
    except FileNotFoundError:
        return 0


def _rs_crash(torch, tmp):
    """(a): the SIGKILLed child's files recovered in this process against
    an oracle that commits exactly the journal's surviving lines."""
    import multiprocessing
    import signal

    from loghisto_tpu_torch.ops.backend import kernel_launches
    from loghisto_tpu_torch.resilience import ResilienceConfig
    from loghisto_tpu_torch.utils import journal

    jpath, cpath = f"{tmp}/raw.jsonl", f"{tmp}/state.npz"
    ctx = multiprocessing.get_context("spawn")  # CUDA cannot fork
    ticked = ctx.Value("i", 0)
    child = ctx.Process(target=_rs_child, args=(tmp, ticked), daemon=True)
    t0 = time.perf_counter()
    child.start()
    try:
        deadline = time.monotonic() + 300.0
        while _rs_journal_lines(jpath) < RS_KILL_AT:
            if not child.is_alive():
                raise AssertionError(f"the child exited {child.exitcode}")
            if time.monotonic() > deadline:
                raise AssertionError("the child's journal never reached "
                                     f"seq {RS_KILL_AT}")
            time.sleep(0.02)
        os.kill(child.pid, signal.SIGKILL)
        child.join(60.0)
    finally:
        if child.is_alive():
            child.kill()
            child.join(60.0)
    child_s = time.perf_counter() - t0
    if child.exitcode != -signal.SIGKILL:
        raise AssertionError(f"the child exited {child.exitcode}")
    minted = ticked.value
    lines = list(journal.replay(jpath))
    seqs = [r.seq for r in lines]
    if seqs != list(range(1, len(seqs) + 1)) or len(seqs) < RS_KILL_AT:
        raise AssertionError(f"the journal's seqs: {seqs}")
    lost = minted - seqs[-1]
    if not 0 <= lost <= 1:
        raise AssertionError(f"{lost} intervals lost ({minted} minted)")

    rms, rec_evicted = _cj_retention_system(
        torch, resilience=ResilienceConfig(
            checkpoint_path=cpath, journal_path=jpath,
            checkpoint_every_intervals=RS_CKPT_EVERY,
            recover_on_start=False))
    torch.cuda.synchronize()
    k0 = kernel_launches()
    t1 = time.perf_counter()
    report = rms.recover()
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t1
    launches = {k: v - k0[k] for k, v in kernel_launches().items()}
    if not (report.checkpoint_found and report.journal_found
            and report.watermark is not None):
        raise AssertionError(f"recovery report {report}")
    if report.skipped_intervals != report.watermark or \
            report.replayed_intervals != len(lines) - report.watermark:
        raise AssertionError(f"recovery report {report}")
    if rms.retention.intervals_pushed != report.replayed_intervals:
        raise AssertionError("the wheel's pushes differ from the replay")
    if report.replayed_intervals and (launches["sparse_ingest"] <= 0
                                      or launches["window_merge"] <= 0):
        raise AssertionError(f"the replay's launches {launches}")
    if next(rms._interval_seq) != seqs[-1] + 1:
        raise AssertionError("the seq counter did not move past the replay")

    ora, ora_evicted = _cj_retention_system(torch)
    ora.backfill_retention(lines)
    rec_out = rms.aggregator.collect(reset=False).metrics
    ora_out = ora.aggregator.collect(reset=False).metrics
    wm = report.watermark
    after = {n for e, names in ora_evicted if e > wm for n in names}
    gone = {n for _, names in rec_evicted for n in names}
    if gone - after:
        raise AssertionError("the recovery evicted names the oracle kept")
    # EQUAL key for key (percentiles too) but for the names the recovered
    # lifecycle clock still holds, accounted exactly
    cmp = _cj_compare_restart2(ora_out, rec_out, sorted(after - gone),
                               "_overflow.api")
    rms.recovery.checkpoint_path = None  # no final checkpoint at the drop
    for ms in (rms, ora):
        _drop_system(torch, ms)
    return {"child_s": child_s, "minted": minted, "journal_lines": len(seqs),
            "lost": lost, "watermark": wm,
            "replayed": report.replayed_intervals,
            "skipped": report.skipped_intervals,
            "corrupt_lines": report.corrupt_lines,
            "recover_s": recover_s, "report_wall_s": report.wall_time_s,
            "checkpoint_bytes": os.path.getsize(cpath),
            "launches": {k: v for k, v in launches.items() if v}, **cmp}


def _rs_record(ms, rng, names):
    """One drill interval: RS_DRILL_SAMPLES lognormal samples over the
    drill's names; returns the count of each."""
    ids = rng.integers(0, len(names), RS_DRILL_SAMPLES)
    values = rng.lognormal(3.0, 0.8, RS_DRILL_SAMPLES)
    per = np.bincount(ids, minlength=len(names))
    order = np.argsort(ids, kind="stable")
    bounds = np.concatenate([[0], np.cumsum(per)])
    for i, name in enumerate(names):
        ms.histogram_batch(name, values[order[bounds[i]:bounds[i + 1]]])
    return per


def _rs_chaos(torch):
    """(b): a bridge crash the supervisor restarts, RS_BREAKER failed
    commits that open the breaker (/healthz degraded with breaker_open),
    a pinned fan-out commit on K3, a half-open trial that closes it; the
    debug dump and the resilience.* gauges against these events, and
    every sample of every committed interval in collect()."""
    import queue

    from loghisto_tpu_torch.ops.backend import kernel_launches
    from loghisto_tpu_torch.prometheus import PrometheusEndpoint
    from loghisto_tpu_torch.resilience import FaultInjector, ResilienceConfig

    inj = FaultInjector(seed=SEED)
    inj.plan("commit.bridge", "raise", on_call=2)
    ms, _ = _cj_retention_system(
        torch, observability=True, resilience=ResilienceConfig(
            restart_backoff_s=0.01, restart_backoff_cap_s=0.05,
            breaker_threshold=RS_BREAKER, breaker_window_s=600.0,
            breaker_open_s=RS_OPEN_S, fault_injector=inj))
    ms.aggregator.retry_cooldown = 0.0
    names = [f"drill.{k}.lat" for k in range(RS_DRILL_NAMES)]
    rng = np.random.default_rng((SEED, 92))
    want = np.zeros(len(names), np.int64)
    com, br, sup = ms.committer, ms.device_breaker, ms.supervisor
    q = queue.Queue()
    ep = PrometheusEndpoint(ms, port=0, host="127.0.0.1")
    ep.start()
    url = f"http://127.0.0.1:{ep.port}/healthz"
    steps = {}
    try:
        def tick(lost=False):
            per = _rs_record(ms, rng, names)
            before = com.intervals_committed
            ms._tick(q)
            if lost:
                _ob_wait(lambda: sup.total_restarts >= 1, "the restart")
            else:
                _ob_wait(lambda: com.intervals_committed > before,
                         "a commit")
                want[:] += per

        tick()
        tick(lost=True)   # commit.bridge: the interval dies with the bridge
        tick()            # the restarted bridge commits
        steps["restart"] = {
            "restarts": dict(sup.restarts_by_name),
            "health": ms.health.report().reason_codes()}
        if sup.restarts_by_name != {"loghisto-torch-commit": 1} or \
                "thread_restarted" not in steps["restart"]["health"]:
            raise AssertionError(f"restart step {steps['restart']}")
        inj.plan("commit.dispatch", "raise", every=1, times=RS_BREAKER)
        for _ in range(RS_BREAKER):
            tick()
        code, body = _ob_get(url)
        codes = [r["code"] for r in body["reasons"]]
        steps["open"] = {"state": br.state, "failures": br.failures_total,
                         "healthz": code, "status": body["status"],
                         "reasons": codes}
        if br.state != "open" or "breaker_open" not in codes:
            raise AssertionError(f"open step {steps['open']}")
        fan0, k0 = com.fanout_intervals, kernel_launches()
        tick()            # pinned: the fan-out path
        k3 = kernel_launches()["sparse_ingest"] - k0["sparse_ingest"]
        steps["pinned"] = {"fanout": com.fanout_intervals - fan0,
                           "k3_launches": k3,
                           "dispatch_fires": inj.fires_at("commit.dispatch")}
        if steps["pinned"]["fanout"] != 1 or k3 <= 0 or \
                steps["pinned"]["dispatch_fires"] != RS_BREAKER:
            raise AssertionError(f"pinned step {steps['pinned']}")
        time.sleep(RS_OPEN_S + 0.05)
        fused0 = com.fused_intervals
        tick()            # the half-open trial, a real fused commit
        code, body = _ob_get(url)
        codes = [r["code"] for r in body["reasons"]]
        steps["closed"] = {"state": br.state,
                           "fused": com.fused_intervals - fused0,
                           "healthz": code, "reasons": codes}
        if br.state != "closed" or "breaker_open" in codes or \
                steps["closed"]["fused"] != 1:
            raise AssertionError(f"closed step {steps['closed']}")
        dump = ms.debug_dump()["resilience"]
        expect = {"thread_restarts": {"loghisto-torch-commit": 1},
                  "breaker_state": "closed", "breaker_opened_total": 1,
                  "checkpoints_taken": 0, "checkpoint_errors": 0,
                  "last_checkpoint_seq": None,
                  "recovery_in_progress": False,
                  "faults_injected": 1 + RS_BREAKER}
        if dump != expect:
            raise AssertionError(f"debug_dump resilience {dump}")
        gauges = {k: f() for k, f in ms._gauge_funcs.items()
                  if k.startswith("resilience.")}
        if (gauges["resilience.ThreadRestarts"], gauges[
                "resilience.BreakerOpen"], gauges[
                "resilience.BreakerOpenedTotal"], gauges[
                "resilience.BreakerFailures"], gauges[
                "resilience.FaultsInjected"]) != (1.0, 0.0, 1.0,
                                                  float(RS_BREAKER),
                                                  float(1 + RS_BREAKER)):
            raise AssertionError(f"resilience gauges {gauges}")
        # the failed commits stamped no activity (their first chunk never
        # ran), so the lifecycle may have folded drill names into their
        # overflow row, as the reference's does: conservation is over
        # the names and that row
        out = ms.aggregator.collect(reset=False).metrics
        got = sum(out.get(f"{n}_count", 0.0) for n in names) + out.get(
            "_overflow.drill_count", 0.0)
        if got != want.sum():
            raise AssertionError(f"collect() holds {got} drill samples of "
                                 f"{int(want.sum())}")
    finally:
        ep.stop()
        _drop_system(torch, ms)
    return {"steps": steps, "gauges": gauges,
            "samples_checked": int(want.sum()),
            "overflowed": out.get("_overflow.drill_count", 0.0)}


def _rs_d6(torch):
    """(c): commit.dispatch fires before chunk RS_D6_CHUNK of the second
    interval: the accumulator plus the host spill hold every sample of
    both intervals, each tier's open slot the chunks that landed (the
    reference's rule), nothing twice; the next commit publishes again."""
    from loghisto_tpu_torch import TorchMetricSystem
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.ops.backend import kernel_launches
    from loghisto_tpu_torch.resilience import FaultInjector, ResilienceConfig

    inj = FaultInjector()
    ms = TorchMetricSystem(interval=1.0, sys_stats=False, num_metrics=RET_M,
                           retention=True, config=MetricConfig(bucket_limit=BL),
                           resilience=ResilienceConfig(fault_injector=inj))
    com, agg, wheel = ms.committer, ms.aggregator, ms.retention
    rng = np.random.default_rng((SEED, 93))
    names = [f"d6.{k}" for k in range(RET_M)]
    mu = rng.uniform(1.0, 7.0, RET_M)
    sigma = rng.uniform(0.3, 1.5, RET_M)
    t0 = _dt.datetime(2026, 1, 1, tzinfo=_dt.timezone.utc)
    raws = [_raw_interval(rng, names, mu, sigma, t0 + k * _ONE_SECOND, k + 1,
                          RET_SAMPLES) for k in range(3)]
    k0 = kernel_launches()
    try:
        ms.backfill_retention(raws[:1])
        cells = com._cells_from_raw(raws[1])
        ids, idx, w32 = com._dense_cells(cells)
        chunks = -(-len(ids) // com.chunk)
        k = min(RS_D6_CHUNK, chunks - 1)
        if k < 1:
            raise AssertionError(f"interval 2 has {chunks} commit chunk(s)")
        # the rule counts the calls after it is planned
        inj.plan("commit.dispatch", "raise", on_call=k + 1)
        nb = agg.config.num_buckets
        torch.cuda.synchronize()
        acc0 = agg._acc.cpu().numpy().astype(np.int64)
        slots0 = [(t.slot, t.ring[t.slot].cpu().numpy().astype(np.int64))
                  for t in wheel._tiers]
        mode = com.commit(raws[1])
        torch.cuda.synchronize()
        if mode != "fused" or inj.fires_at("commit.dispatch") != 1:
            raise AssertionError(f"the failed commit: {mode}, {inj.fired}")
        full = np.zeros((RET_M, nb), np.int64)
        np.add.at(full, (ids, idx), cells[2])
        landed = np.zeros((RET_M, nb), np.int64)
        cut = k * com.chunk
        np.add.at(landed, (ids[:cut], idx[:cut]), w32[:cut])
        spill = agg._spill if agg._spill is not None else 0
        total = agg._acc.cpu().numpy().astype(np.int64) + spill
        if not np.array_equal(total, acc0 + full):
            raise AssertionError("accumulator + spill != the host oracle")
        for (slot, before), t in zip(slots0, wheel._tiers):
            after = t.ring[slot].cpu().numpy().astype(np.int64)
            if not np.array_equal(after, before + landed):
                raise AssertionError("a tier slot != its landed chunks")
        if wheel.snapshot is not None or agg.stats_snapshot is not None:
            raise AssertionError("the failed commit left a snapshot")
        spilled = int(np.asarray(spill).sum())
        if com.commit(raws[2]) != "fused" or wheel.snapshot is None:
            raise AssertionError("the next commit did not publish")
        hist = np.zeros((RET_M, nb), np.int64)
        for raw in raws:
            c = com._cells_from_raw(raw)
            i2, x2, _ = com._dense_cells(c)
            np.add.at(hist, (i2, x2), c[2])
        spill = agg._spill if agg._spill is not None else 0
        if not np.array_equal(agg._acc.cpu().numpy().astype(np.int64) + spill,
                              hist):
            raise AssertionError("three intervals: acc + spill != oracle")
        launches = {key: v - k0[key] for key, v in kernel_launches().items()}
    finally:
        _drop_system(torch, ms)
    return {"cells": len(ids), "chunks": chunks, "failed_chunk": k,
            "spilled_samples": spilled, "launches":
                {key: v for key, v in launches.items() if v}}


def _rs_oracle_check(metrics, ids, values, m, what):
    """collect() of one interval against the host compress_np /
    dense_stats_np oracle (counts EQUAL, percentiles the float32 of the
    oracle's, sums within 1e-5)."""
    from loghisto_tpu_torch.ops.codec import compress_np
    from loghisto_tpu_torch.ops.stats import dense_stats_np

    labels = ["min", "50", "75", "90", "95", "99", "99.9", "99.99", "max"]
    cols = np.clip(compress_np(values), -BL, BL).astype(np.int64) + BL
    oracle = np.bincount(ids.astype(np.int64) * B + cols,
                         minlength=m * B).reshape(m, B)
    want = dense_stats_np(oracle, PS, BL)
    for i in np.nonzero(want["counts"])[0].tolist():
        name = f"m{i}"
        if metrics[f"{name}_count"] != int(want["counts"][i]):
            raise AssertionError(f"{what}: {name} count")
        for label, value in zip(labels, want["percentiles"][i]):
            if metrics[f"{name}_{label}"] != float(np.float32(value)):
                raise AssertionError(f"{what}: {name}_{label}")
        s = metrics[f"{name}_sum"]
        if abs(s - want["sums"][i]) > 1e-5 * abs(want["sums"][i]) + 1e-3:
            raise AssertionError(f"{what}: {name} sum")
    return int(want["counts"].sum())


def _rs_requeue(torch):
    """(d): agg.ingest fires on the middle chunk of one interval at the
    headline width: the first half lands through K1, the rest is
    requeued; once the cooldown passes a flush lands it, and collect()
    equals the host oracle."""
    from loghisto_tpu_torch.ops.backend import kernel_launches
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.resilience import FaultInjector

    rng = np.random.default_rng((SEED, 94))
    agg = TorchAggregator(num_metrics=M, batch_size=1 << 16, transport="raw")
    for i in range(M):
        agg.registry.id_for(f"m{i}")
    inj = FaultInjector()
    chunks = RS_REQUEUE_SAMPLES // agg.batch_size
    inj.plan("agg.ingest", "raise", on_call=chunks // 2 + 1)
    agg.fault_injector = inj
    agg.retry_cooldown = RS_COOLDOWN_S
    agg.max_pending_samples = RS_REQUEUE_SAMPLES  # no shed in this check
    ids = zipf_ids(rng, RS_REQUEUE_SAMPLES, M)
    values = lognormal_values(rng, RS_REQUEUE_SAMPLES)
    k0 = kernel_launches()
    try:
        agg.record_batch(ids, values)
        agg.wait_transfers()
        requeued = agg.pending_samples
        if requeued != RS_REQUEUE_SAMPLES - (chunks // 2) * agg.batch_size:
            raise AssertionError(f"{requeued} samples requeued")
        if time.monotonic() >= agg._device_down_until:
            raise AssertionError("the cooldown was not armed")
        agg.flush()  # inside the cooldown: the samples stay buffered
        if agg.pending_samples != requeued:
            raise AssertionError("a flush inside the cooldown shipped")
        time.sleep(max(0.0, agg._device_down_until - time.monotonic()) + 0.01)
        agg.flush()
        agg.wait_transfers()
        if agg.pending_samples or agg._shed_samples:
            raise AssertionError("the requeue did not land")
        metrics = agg.collect().metrics
        k1 = kernel_launches()["fused_ingest"] - k0["fused_ingest"]
        checked = _rs_oracle_check(metrics, ids, values, M, "requeue")
    finally:
        agg.close()
    if checked != RS_REQUEUE_SAMPLES or k1 != chunks:
        raise AssertionError(f"{checked} samples, {k1} K1 launches")
    return {"samples": checked, "requeued": requeued, "k1_launches": k1,
            "fires": inj.fires_at("agg.ingest")}


def _rs_wedge(torch):
    """(e): agg.xfer_worker wedges the worker; the queue fills to
    max_pending_samples, later flushes return at once and the host buffer
    sheds its oldest samples: shed + counted = recorded, and the counted
    ones are the first queued and the last buffered."""
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.resilience import FaultInjector

    rng = np.random.default_rng((SEED, 95))
    agg = TorchAggregator(num_metrics=M, batch_size=1 << 16, transport="raw")
    for i in range(M):
        agg.registry.id_for(f"m{i}")
    inj = FaultInjector(wedge_timeout_s=300.0)
    inj.plan("agg.xfer_worker", "wedge", on_call=1)
    agg.fault_injector = inj
    ids = zipf_ids(rng, RS_WEDGE_SAMPLES, M)
    values = lognormal_values(rng, RS_WEDGE_SAMPLES)
    bs = agg.batch_size
    try:
        t0 = time.perf_counter()
        for off in range(0, RS_WEDGE_SAMPLES, bs):
            agg.record_batch(ids[off:off + bs], values[off:off + bs])
        record_s = time.perf_counter() - t0
        _ob_wait(lambda: inj.wedged_now == 1, "the wedge")
        queued, pending = agg._xfer_queued_samples, agg.pending_samples
        shed = agg._shed_samples
        cap = agg.max_pending_samples
        if (queued, pending, shed) != (cap, cap,
                                       RS_WEDGE_SAMPLES - 2 * cap):
            raise AssertionError(f"queued {queued}, pending {pending}, "
                                 f"shed {shed}")
        inj.release_wedges()
        metrics = agg.collect().metrics
        keep = np.r_[0:queued, RS_WEDGE_SAMPLES - pending:RS_WEDGE_SAMPLES]
        counted = _rs_oracle_check(metrics, ids[keep], values[keep], M,
                                   "wedge")
    finally:
        inj.release_wedges()
        agg.close()
    if counted + shed != RS_WEDGE_SAMPLES:
        raise AssertionError(f"{counted} + {shed} != {RS_WEDGE_SAMPLES}")
    return {"recorded": RS_WEDGE_SAMPLES, "queued": queued,
            "pending": pending, "shed": shed, "counted": counted,
            "record_s": record_s}


def _rs_cost(torch):
    """(f): the commit's p50 / p99 with resilience= and no injector
    against the same retention system without it.  The three systems
    (plain, resilience, plain again) live at once and each interval is
    committed to all three in a rotating order, so build order, the
    allocator's cache and the host's drift fall on each alike; the
    host's noise is the spread of the two plain systems.  Then
    RS_COST_SPLIT more intervals with a span recorder on each system
    give every commit stage's p50 per system, and the breaker's own
    calls on the commit path (is_open, record_success) are timed
    alone."""
    from loghisto_tpu_torch.obs.spans import SpanRecorder
    from loghisto_tpu_torch.resilience import ResilienceConfig

    rng, steady, mu, sigma = _rs_stream()
    t0 = _dt.datetime(2026, 1, 1, tzinfo=_dt.timezone.utc)
    raws = [_raw_interval(rng, steady, mu, sigma, t0 + k * _ONE_SECOND,
                          k + 1, RET_SAMPLES)
            for k in range(RS_COST_INTERVALS + RS_COST_SPLIT)]
    labels = ("plain", "resilience", "plain_again")
    systems = {}
    times = {label: [] for label in labels}
    try:
        for label in labels:
            kw = ({"resilience": ResilienceConfig()}
                  if label == "resilience" else {})
            systems[label] = _cj_retention_system(torch, **kw)[0]
        recs = {}
        for k, raw in enumerate(raws):
            if k == RS_COST_INTERVALS:
                for label, ms in systems.items():
                    rec = recs[label] = SpanRecorder(1 << 14)
                    for part in (ms.aggregator, ms.retention, ms.lifecycle,
                                 ms.anomaly, ms.committer):
                        part.obs_recorder = rec
            for j in range(len(labels)):
                label = labels[(k + j) % len(labels)]
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                systems[label].committer.commit(raw)
                torch.cuda.synchronize()
                if k < RS_COST_INTERVALS:
                    times[label].append((time.perf_counter() - t1) * 1e3)
        br = systems["resilience"].device_breaker
        t1 = time.perf_counter()
        for _ in range(100_000):
            br.is_open()
            br.record_success()
        breaker_us = (time.perf_counter() - t1) * 10.0
        modes = {label: [ms.committer.fused_intervals,
                         ms.committer.fanout_intervals]
                 for label, ms in systems.items()}
        stages = {}
        for label, rec in recs.items():
            by = {}
            for sp in rec.spans():
                by.setdefault(sp.stage, []).append(
                    (sp.end_ns - sp.start_ns) / 1e6)
            stages[label] = {st: float(np.median(v))
                             for st, v in sorted(by.items())}
    finally:
        for ms in systems.values():
            _drop_system(torch, ms)
    if any(fanout for _, fanout in modes.values()):
        raise AssertionError(f"a cost system left the fused path: {modes}")
    out = {label: {"p50_ms": float(np.percentile(ts, 50)),
                   "p99_ms": float(np.percentile(ts, 99)), "ms": ts}
           for label, ts in times.items()}
    out["host_noise_p50_ms"] = abs(out["plain"]["p50_ms"]
                                   - out["plain_again"]["p50_ms"])
    out["order"] = "interleaved, rotating"
    out["stage_p50_ms"] = stages
    out["breaker_us_per_commit"] = breaker_us
    out["fused_fanout"] = modes
    return out


def phase_resilience(torch):
    """Resilience on the card, (a) to (f); each part prints its own line,
    the phase line carries every launch."""
    import shutil
    import tempfile

    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )

    tmp = tempfile.mkdtemp(prefix="loghisto-rs-")
    reset_kernel_launches()
    parts = {}
    try:
        for key, fn in (("a_crash", lambda t: _rs_crash(t, tmp)),
                        ("b_chaos", _rs_chaos), ("c_d6", _rs_d6),
                        ("d_requeue", _rs_requeue), ("e_wedge", _rs_wedge),
                        ("f_cost", _rs_cost)):
            t1 = time.perf_counter()
            out = fn(torch)
            out["part_s"] = time.perf_counter() - t1
            emit({"part": key, **out})
            parts[key] = out["part_s"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = kernel_launches()
    for kernel in ("fused_ingest", "sparse_ingest", "window_merge",
                   "divergence"):
        if launches[kernel] <= 0:
            raise AssertionError(f"the phase launched no {kernel}")
    return {"parts_s": parts,
            "launches": {k: v for k, v in launches.items() if v}}


# -- federation: emitter processes -> receiver -> K3 / K4 ------------------
#
# 8 torch-free emitter processes (seven on wire v2, one on v1) each
# record 4 intervals of 2^20 lognormal samples over a Zipf draw of 10,000
# shared names and 1,000 names of their own, and ship a frame an
# interval to a FederationReceiver over a dense TorchAggregator at the
# full width (10,000 rows that grow to hold the 18,000 names).

FED_CHILDREN = 8
FED_INTERVALS = 4
FED_SAMPLES = 1 << 20
FED_SHARED = 10_000
FED_OWN = 1_000
FED_OWN_SHARE = 0.1      # of each child's samples, on its own names
FED_EMITTER0 = 0xFED0000
FED_PARENT = 0xFED0FFF   # the parent's own frames: the re-send, the flip
FED_PAGED_M = 1 << 16
FED_PAGED_POOL = 1 << 18
FED_DEADLINE_S = 30.0
FED_FOREIGN = ("torch", "jax", "jaxlib", "loghisto_tpu")


def _fed_names(idx):
    """Child ``idx``'s names in local-id order: the shared ones, then
    its own."""
    return ([f"fed.shared.{k}" for k in range(FED_SHARED)]
            + [f"fed.e{idx}.own.{k}" for k in range(FED_OWN)])


def _fed_samples(idx, interval):
    """Child ``idx``'s samples of one interval, as (local ids, values):
    the parent regenerates them for its oracle."""
    rng = np.random.default_rng([SEED, 18, idx, interval])
    own = rng.random(FED_SAMPLES) < FED_OWN_SHARE
    ids = np.where(own, FED_SHARED + rng.integers(0, FED_OWN, FED_SAMPLES),
                   zipf_ids(rng, FED_SAMPLES, FED_SHARED))
    return ids.astype(np.int32), lognormal_values(rng, FED_SAMPLES)


def _fed_child(argv):
    """One emitter process (``python -c``, no torch): asserts that
    nothing of torch, JAX or the JAX package is loaded, then records and
    ships its 4 intervals and prints one JSON line."""
    port, idx, version = (int(a) for a in argv)
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.federation.emitter import FederationEmitter

    def foreign():
        return sorted(k for k in sys.modules
                      if k.split(".")[0] in FED_FOREIGN)

    if foreign():
        print(json.dumps({"child": idx, "foreign": foreign()}), flush=True)
        return 3
    e = FederationEmitter(("127.0.0.1", port),
                          config=MetricConfig(bucket_limit=BL),
                          emitter_id=FED_EMITTER0 + idx,
                          wire_version=version)
    for name in _fed_names(idx):
        e.local_id(name)
    batches = [_fed_samples(idx, k) for k in range(FED_INTERVALS)]
    t_first = time.monotonic()
    for ids, values in batches:
        e.record_batch(ids, values)
        e.flush()
        e._sender.retry_backlog()  # ship now, not at the next boundary
    ok = e.close(drain_timeout=60.0)
    print(json.dumps({
        "child": idx, "ok": ok, "foreign": foreign(), "wire": version,
        "samples": e.samples_shipped, "frames": e.frames_shipped,
        "bytes": e.bytes_sent, "send_failures": e.send_failures,
        "t_first": t_first}), flush=True)
    return 0 if ok and not foreign() else 1


def _fed_send(port, data):
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(data)


def _fed_parent_frames():
    """The parent's three frames (v2): P1 (sent twice), P2 with the name
    P3's rows need, P3 (sent before P2); and a copy of P1 with one bit
    flipped.  Returns (p1, p2, p3, flipped, [(name, values), ...])."""
    from loghisto_tpu_torch.federation import wire
    from loghisto_tpu_torch.ops.codec import encode_frame
    from loghisto_tpu_torch.ops.fold import fold_packed_numpy

    rng = np.random.default_rng([SEED, 18, 99])
    names = ["fed.shared.0", "fed.parent.only", "fed.parent.late"]
    sent = []

    def frame(seq, dict_ids, lids):
        ids = rng.choice(np.asarray(lids, np.int32), 4096).astype(np.int32)
        values = lognormal_values(rng, len(ids))
        for lid in lids:
            sent.append((names[lid], values[ids == lid]))
        packed = fold_packed_numpy(ids, values, BL)
        return encode_frame(wire.KIND_DELTA2, wire.encode_delta2(
            FED_PARENT, seq, [(i, names[i]) for i in dict_ids], packed,
            time.monotonic_ns(), time.time_ns()))

    p1 = frame(1, (0, 1), (0, 1))
    p2 = frame(2, (2,), (0,))
    p3 = frame(3, (), (0, 1, 2))
    flipped = bytearray(p1)
    flipped[len(flipped) // 2] ^= 0x04
    return p1, p2, p3, bytes(flipped), sent


def _fed_oracle_keys(registry, parent_sent, intervals):
    """Host oracle: the flat cell (row * B + dense bucket) of every
    sample of every child in ``intervals``, regenerated from its seed,
    and of the parent's, through compress_np, in the aggregator's rows
    (by name)."""
    from loghisto_tpu_torch.ops.codec import compress_np

    keys = []
    for idx in range(FED_CHILDREN):
        rows = np.array([registry.id_for(n) for n in _fed_names(idx)],
                        dtype=np.int64)
        for k in intervals:
            ids, values = _fed_samples(idx, k)
            keys.append(rows[ids] * B + np.clip(
                compress_np(values), -BL, BL).astype(np.int64) + BL)
    for name, values in parent_sent:
        keys.append(registry.id_for(name) * B + np.clip(
            compress_np(values), -BL, BL).astype(np.int64) + BL)
    return np.concatenate(keys)


def _fed_paged(torch, journal, parent_sent):
    """The first interval's frames of every child from the live
    journal, through a receiver over a paged TorchAggregator at 2^16
    rows: K4 launches, and the pool's cells, mapped through each row's
    codec, equal the oracle's."""
    import struct

    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.federation import FederationReceiver
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )
    from loghisto_tpu_torch.ops.codec import encode_frame
    from loghisto_tpu_torch.paging import PagedStoreConfig
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.utils.journal import FrameJournal

    t0 = time.perf_counter()
    agg = TorchAggregator(num_metrics=FED_PAGED_M,
                          config=MetricConfig(bucket_limit=BL),
                          storage="paged",
                          paged_config=PagedStoreConfig(
                              pool_pages=FED_PAGED_POOL))
    if agg.paged is None or agg.paged._pool.device.type != "cuda":
        raise AssertionError("the paged aggregator is not on cuda")
    children = {FED_EMITTER0 + i for i in range(FED_CHILDREN)}
    rx = FederationReceiver(agg)
    try:
        frames = [encode_frame(kind, payload)
                  for kind, payload in FrameJournal.replay(journal)
                  if struct.unpack_from("<QQ", payload) in
                  {(eid, 1) for eid in children}]
        if len(frames) != FED_CHILDREN:
            raise AssertionError(f"{len(frames)} first-interval frames")
        reset_kernel_launches()
        for f in frames:
            if not rx._drain_buffer(bytearray(f)):
                raise AssertionError("a journaled frame did not decode")
        if not agg.wait_transfers(60.0):
            raise AssertionError("the paged merges did not drain")
        torch.cuda.synchronize()
        k4 = kernel_launches()["paged_scatter"]
        if k4 <= 0:
            raise AssertionError("the paged merges launched no K4")
        store = agg.paged
        keys, counts = np.unique(_fed_oracle_keys(agg.registry, [], (0,)),
                                 return_counts=True)
        rows, cell = keys // B, keys % B
        codec = store.row_codec[rows].astype(np.int64)
        if (codec < 0).any():
            raise AssertionError("a sampled row holds no codec")
        mapped = rows * B + store._dec[codec, store._enc[codec, cell]]
        want_keys, inv = np.unique(mapped, return_inverse=True)
        want_counts = np.bincount(inv, weights=counts).astype(np.int64)
        g_rows, g_idx, g_counts = store.decode_cells()
        got_keys, ginv = np.unique(g_rows * B + g_idx, return_inverse=True)
        got_counts = np.bincount(ginv, weights=g_counts).astype(np.int64)
        if not (np.array_equal(got_keys, want_keys)
                and np.array_equal(got_counts, want_counts)):
            raise AssertionError("the paged pool differs from the oracle")
        st = rx.stats()
        if st["samples_merged"] != FED_CHILDREN * FED_SAMPLES:
            raise AssertionError(f"paged merged {st['samples_merged']}")
        return {"k4_launches": k4, "frames": len(frames),
                "cells": int(len(got_keys)),
                "spilled_cells": store.spilled_cells,
                "s": time.perf_counter() - t0}
    finally:
        rx.stop()
        agg.close()


def phase_federation(torch):
    """The federation transport on the card: 8 emitter processes ->
    FederationReceiver -> TorchAggregator.merge_packed -> K3, against a
    host oracle, then the journal's replay and the paged route (K4)."""
    import shutil
    import tempfile

    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.federation import FederationReceiver
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    card = RESULTS["card"]  # nvidia-smi's name and power limit
    print(card, flush=True)
    tmp = tempfile.mkdtemp(prefix="loghisto-fed-")
    journal = os.path.join(tmp, "fed.journal")
    agg = TorchAggregator(num_metrics=M, config=MetricConfig(bucket_limit=BL),
                          storage="dense")
    if agg.device.type != "cuda" or agg._acc.device.type != "cuda":
        raise AssertionError("the aggregator is not on cuda")
    rx = FederationReceiver(agg, journal_path=journal)
    procs = []
    out = {"card": card}
    try:
        rx.start()
        p1, p2, p3, flipped, parent_sent = _fed_parent_frames()
        root = os.path.dirname(os.path.abspath(__file__))
        code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "import chip_smoke; "
                "sys.exit(chip_smoke._fed_child(sys.argv[2:]))")
        reset_kernel_launches()
        t_spawn = time.monotonic()
        for idx in range(FED_CHILDREN):
            version = 1 if idx == FED_CHILDREN - 1 else 2
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, root, str(rx.port), str(idx),
                 str(version)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        # the parent's frames, among the children's: a re-send, a
        # flipped bit, and rows whose name comes in a later frame
        for data in (p1, p1, flipped, p3):
            _fed_send(rx.port, data)
        _ob_wait(lambda: rx.samples_parked > 0, "the parked rows",
                 FED_DEADLINE_S)
        _fed_send(rx.port, p2)
        children = []
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
            if p.returncode != 0 or not lines:
                raise AssertionError(
                    f"emitter child failed ({p.returncode}): "
                    f"{stdout[-2000:]} {stderr[-2000:]}")
            children.append(json.loads(lines[-1]))
        if any(c["foreign"] for c in children):
            raise AssertionError(f"an emitter child loaded "
                                 f"{[c['foreign'] for c in children]}")
        sent = sum(c["samples"] for c in children) + sum(
            len(v) for _, v in parent_sent)
        t_children = time.monotonic()

        def merge_counters():
            st = rx.stats()
            return {
                "frames_received": st["frames_received"],
                "duplicate_frames": st["duplicate_frames"],
                "decode_errors": st["decode_errors"],
                "samples_merged": st["samples_merged"],
                "samples_shed": st["samples_shed"],
                "sent": sent,
                "children_samples": [c["samples"] for c in children],
                "agg_queued_samples": agg._xfer_queued_samples,
            }

        for what, cond in (
                ("every sample merged", lambda: rx.samples_merged >= sent),
                ("the duplicate", lambda: rx.duplicate_frames >= 1),
                ("the decode error", lambda: rx.decode_errors >= 1)):
            _ob_wait(cond, what, FED_DEADLINE_S, merge_counters)
        t_applied = time.monotonic()
        if not agg.wait_transfers(60.0):
            raise AssertionError("the merges did not drain")
        agg.flush(force=True)
        torch.cuda.synchronize()
        t_drained = time.monotonic()
        k3 = kernel_launches()["sparse_ingest"]
        acc = agg._acc.cpu().numpy()
        t_collect = time.monotonic()
        metrics = agg.collect().metrics
        t_end = time.monotonic()
        st = rx.stats()
        t_first = min(c["t_first"] for c in children)
        frames = FED_CHILDREN * FED_INTERVALS + 3
        checks = {
            "samples_merged": (st["samples_merged"], sent),
            "frames_received": (st["frames_received"], frames),
            "duplicate_frames": (st["duplicate_frames"], 1),
            "decode_errors": (st["decode_errors"], 1),
            "seq_gaps": (st["seq_gaps"], 0),
            "samples_shed": (st["samples_shed"], 0),
            "samples_parked": (st["samples_parked"], 0),
            "frames_v1": (st["frames_v1"], FED_INTERVALS),
            "tpu.SamplesShed": (agg._shed_samples, 0),
            "registry_shed": (agg._registry_shed_samples, 0),
        }
        bad = {k: v for k, v in checks.items() if v[0] != v[1]}
        if bad:
            raise AssertionError(f"receiver counters (got, want): {bad}")
        if k3 <= 0:
            raise AssertionError("the receiver's merges launched no K3")
        if agg._spill is not None and agg._spill.any():
            raise AssertionError("the merges spilled to the host")
        m_rows = agg.num_metrics
        want = np.bincount(
            _fed_oracle_keys(agg.registry, parent_sent, range(FED_INTERVALS)),
            minlength=m_rows * B)
        if not np.array_equal(acc.reshape(-1), want):
            diff = np.flatnonzero(acc.reshape(-1) != want)
            raise AssertionError(f"{len(diff)} cells differ from the "
                                 f"oracle, first rows {diff[:5] // B}")
        names = sorted({n for i in range(FED_CHILDREN)
                        for n in _fed_names(i)}
                       | {n for n, _ in parent_sent})
        row_sums = want.reshape(m_rows, B).sum(axis=1)
        for name in names:
            got = metrics.get(f"{name}_count", 0.0)
            if got != float(row_sums[agg.registry.id_for(name)]):
                raise AssertionError(f"collect() count of {name}: {got}")
        out.update({
            "children": len(children), "names": len(names),
            "rows": m_rows, "samples_merged": st["samples_merged"],
            "frames": st["frames_received"],
            "bytes_received": st["bytes_received"],
            "frames_per_s": st["frames_received"] / (t_end - t_first),
            "samples_merged_per_s": st["samples_merged"] / (t_end - t_first),
            "first_send_to_collect_s": t_end - t_first,
            # the window's parts: the children's first sends (spread),
            # their exits, every frame applied, the merges landed, collect
            "spawn_to_first_send_s": t_first - t_spawn,
            "first_send_spread_s": max(c["t_first"] for c in children)
            - t_first,
            "first_send_to_children_done_s": t_children - t_first,
            "children_done_to_applied_s": t_applied - t_children,
            "applied_to_drained_s": t_drained - t_applied,
            "collect_s": t_end - t_collect,
            "k3_launches": k3,
            "child_bytes_sent": sum(c["bytes"] for c in children),
            "child_send_failures": sum(c["send_failures"] for c in children),
        })
        rx.stop()

        # the journal replays into a fresh aggregator on the card: EQUAL
        # to the live state, row by name
        t0 = time.perf_counter()
        fresh = TorchAggregator(num_metrics=M,
                                config=MetricConfig(bucket_limit=BL),
                                storage="dense")
        rx2 = FederationReceiver(fresh)
        try:
            replayed = rx2.replay_journal(journal)
            rx2.stop()
            if not fresh.wait_transfers(60.0):
                raise AssertionError("the replay's merges did not drain")
            fresh.flush(force=True)
            live_ids = np.array([agg.registry.id_for(n) for n in names])
            rep_ids = np.array([fresh.registry.id_for(n) for n in names])
            rep = fresh._acc.cpu().numpy()
            if not np.array_equal(rep[rep_ids], acc[live_ids]):
                raise AssertionError("the journal replay differs from the "
                                     "live state")
            if (rx2.samples_merged, rx2.duplicate_frames) != (sent, 1):
                raise AssertionError(f"replay counters "
                                     f"{rx2.samples_merged}, "
                                     f"{rx2.duplicate_frames}")
        finally:
            fresh.close()
        out["replay"] = {"frames": replayed, "s": time.perf_counter() - t0}
        del acc, want, rep
        out["paged"] = _fed_paged(torch, journal, parent_sent)
        out["k4_launches"] = out["paged"]["k4_launches"]
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        rx.stop()
        agg.close()
        shutil.rmtree(tmp, ignore_errors=True)


# -- federation wired into the system ------------------------------------------

# The reference's fleet drill (tests/test_fleet_obs.py:511, and
# examples/federation_demo.py) at the retention smoke width: FS_EMITTERS
# torch-free emitter processes, paced by their FS_FLUSH_S ticker, each
# ship FS_PHASES phases of FS_SAMPLES Zipf(1.3)/lognormal samples over
# FS_NAMES shared names (2^20 samples a phase, the retention default an
# interval) into TorchMetricSystem(retention=True, observability=,
# federation=) running its reaper at 1 s; emitter FS_SILENT goes silent
# after phase 0 and the first FS_TRACED dump their span rings.
FS_EMITTERS = 32
FS_PHASES = 3
FS_SAMPLES = 1 << 15
FS_NAMES = 1024
FS_SILENT = 31
FS_TRACED = 4
FS_EMITTER0 = 0xF5000
FS_FLUSH_S = 0.5
FS_BUDGET_US = 1000.0     # a freshness budget below any paced p99
FS_LAX_US = 60e6          # one no frame misses
FS_DEADLINE_S = 120.0


def _fs_names():
    return [f"fed.sys.{k}" for k in range(FS_NAMES)]


def _fs_samples(idx, phase):
    """Emitter ``idx``'s samples of ``phase`` as (name index, value): the
    parent regenerates them for its oracle."""
    rng = np.random.default_rng([SEED, 19, idx, phase])
    return zipf_ids(rng, FS_SAMPLES, FS_NAMES), lognormal_values(
        rng, FS_SAMPLES)


def _fs_child(argv):
    """One paced emitter process (``python -c``, no torch): its ticker
    flushes every FS_FLUSH_S (a heartbeat frame when idle); per phase it
    records and ships its samples, prints one JSON line and waits for a
    line on stdin.  Emitter FS_SILENT stops its ticker and records
    nothing after phase 0.  With a trace path it dumps its span ring."""
    port, idx = int(argv[0]), int(argv[1])
    trace = argv[2] if len(argv) > 2 and argv[2] != "-" else None
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.federation.emitter import FederationEmitter

    def foreign():
        return sorted(k for k in sys.modules
                      if k.split(".")[0] in FED_FOREIGN)

    if foreign():
        print(json.dumps({"child": idx, "foreign": foreign()}), flush=True)
        return 3
    e = FederationEmitter(("127.0.0.1", port), interval=FS_FLUSH_S,
                          config=MetricConfig(bucket_limit=BL),
                          emitter_id=FS_EMITTER0 + idx)
    e.start()
    lids = np.array([e.local_id(n) for n in _fs_names()], dtype=np.int32)
    ok = True
    for phase in range(FS_PHASES):
        t_send = time.monotonic()
        if idx == FS_SILENT and phase > 0:
            e._stop.set()  # silent: no records, no flushes, no heartbeats
        else:
            ids, values = _fs_samples(idx, phase)
            e.record_batch(lids[ids], values)
            e.flush()
            ok = e.drain(60.0) and ok
        print(json.dumps({"child": idx, "phase": phase, "t_send": t_send}),
              flush=True)
        if phase + 1 < FS_PHASES and not sys.stdin.readline():
            return 1  # the parent is gone
    if trace:
        from loghisto_tpu_torch.obs.perfetto import dump_perfetto

        dump_perfetto(e.obs, trace, process_name=f"emitter-{idx}")
    ok = e.close(drain_timeout=60.0) and ok
    print(json.dumps({
        "child": idx, "ok": ok, "foreign": foreign(),
        "samples": e.samples_shipped, "frames": e.frames_shipped,
        "bytes": e.bytes_sent, "send_failures": e.send_failures}),
        flush=True)
    return 0 if ok and not foreign() else 1


def _fs_oracle(registry):
    """The federated rows the fleet's samples make, regenerated from
    their seeds through compress_np: int64 [FS_NAMES, B], and the rows'
    ids in the system's registry."""
    from loghisto_tpu_torch.ops.codec import compress_np

    keys = []
    for idx in range(FS_EMITTERS):
        for phase in range(1 if idx == FS_SILENT else FS_PHASES):
            ids, values = _fs_samples(idx, phase)
            keys.append(ids.astype(np.int64) * B + np.clip(
                compress_np(values), -BL, BL).astype(np.int64) + BL)
    want = np.bincount(np.concatenate(keys), minlength=FS_NAMES * B)
    rows = np.array([registry.id_for(n) for n in _fs_names()])
    return want.reshape(FS_NAMES, B), rows


def _fs_freshness_oracle(values):
    """The reference drill's oracle of the served p99: the ledger folded
    through compress_np (float64), the p99 bucket by the float64 cumsum
    rule, decoded through the float32 representatives the query
    serves."""
    from loghisto_tpu_torch.ops.codec import compress_np
    from loghisto_tpu_torch.ops.stats import bucket_representatives

    folded = np.clip(compress_np(np.asarray(values, np.float64)), -BL, BL)
    buckets, counts = np.unique(folded, return_counts=True)
    cdf = np.cumsum(counts.astype(np.uint64))
    sel = int(np.searchsorted(cdf.astype(np.float64) / float(cdf[-1]), 0.99,
                              side="left"))
    bucket = int(buckets[min(sel, len(buckets) - 1)])
    return float(bucket_representatives(BL).numpy()[bucket + BL])


def phase_federation_system(torch):
    """TorchMetricSystem(federation=FederationConfig(expected_emitters=
    32)) on the card with its reaper running: the fleet's frames merge
    through K3, each 1 s commit publishes through K3 and K5 and
    completes the frames' freshness; every sample merged once and every
    federated cell equal to the host oracle, /fleetz naming the silent
    emitter, /healthz reporting emitter_starvation once the fleet is
    gone, the served fed.FreshnessUs p99 equal to the host oracle over
    the receiver's ledger, a FreshnessSloRule firing on a budget below
    it, and fed flows crossing processes in the merged trace."""
    import shutil
    import tempfile

    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.federation import FederationConfig
    from loghisto_tpu_torch.obs import ObsConfig
    from loghisto_tpu_torch.obs.perfetto import dump_perfetto, merge_traces
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )
    from loghisto_tpu_torch.prometheus import PrometheusEndpoint
    from loghisto_tpu_torch.system import TorchMetricSystem
    from loghisto_tpu_torch.window.rules import FreshnessSloRule

    card = RESULTS["card"]  # nvidia-smi's name and power limit
    print(card, flush=True)
    tmp = tempfile.mkdtemp(prefix="loghisto-fs-")
    ms = TorchMetricSystem(
        interval=1.0, num_metrics=RET_M, config=MetricConfig(bucket_limit=BL),
        retention=True, observability=ObsConfig(capacity=16384),
        federation=FederationConfig(expected_emitters=FS_EMITTERS))
    if (ms.device.type != "cuda" or ms.commit_path != "fused"
            or ms.committer.freshness_hook != ms.federation.note_publish):
        raise AssertionError("the federated system is not wired on cuda")
    # the wheel keeps the first RET_M rows, and the fleet's names and the
    # system's own outnumber them: register the freshness row first so
    # that the window serves it
    ms.metric_id("fed.FreshnessUs")
    tight = ms.add_rule(FreshnessSloRule("fed.fresh.tight", FS_BUDGET_US))
    lax = ms.add_rule(FreshnessSloRule("fed.fresh.lax", FS_LAX_US))
    rx = ms.federation
    procs, ep, out, stopped = [], None, {"card": card}, False
    try:
        reset_kernel_launches()
        t_start = time.monotonic()
        ms.start()
        ep = PrometheusEndpoint(ms, port=0, host="127.0.0.1")
        ep.start()
        url = f"http://127.0.0.1:{ep.port}"
        root = os.path.dirname(os.path.abspath(__file__))
        code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "import chip_smoke; "
                "sys.exit(chip_smoke._fs_child(sys.argv[2:]))")
        for idx in range(FS_EMITTERS):
            trace = (os.path.join(tmp, f"em{idx}.json")
                     if idx < FS_TRACED else "-")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, root, str(rx.port), str(idx),
                 trace], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        live = FS_EMITTERS - 1
        want_merged = [FS_SAMPLES * (FS_EMITTERS + live * p)
                       for p in range(FS_PHASES)]
        t_fan = []
        silent = f"{FS_EMITTER0 + FS_SILENT:016x}"
        for phase in range(FS_PHASES):
            t_go = time.monotonic()
            _ob_wait(lambda: rx.samples_merged >= want_merged[phase],
                     f"phase {phase}'s fan-in", FS_DEADLINE_S)
            t_fan.append((t_go, time.monotonic()))
            if phase == 1:
                # the fleet heartbeats while the silent emitter ages
                # past starvation_intervals x interval
                _ob_wait(lambda: silent in _ob_get(
                    f"{url}/fleetz")[1]["flags"]["starved"],
                    "the silent emitter in /fleetz", 30.0)
                status, fleet = _ob_get(f"{url}/fleetz")
                live_rows = [r for e, r in fleet["emitters"].items()
                             if e != silent]
                if (status != 200 or fleet["flags"]["starved"] != [silent]
                        or fleet["fleet"]["emitters"] != FS_EMITTERS
                        or any(r["stalled"] for r in live_rows)):
                    raise AssertionError(f"/fleetz: {status} "
                                         f"{fleet['flags']}")
                out["fleetz"] = {"status": status, "flags": fleet["flags"],
                                 "top": fleet["top"]}
            if phase + 1 < FS_PHASES:
                for p in procs:
                    p.stdin.write("go\n")
                    p.stdin.flush()
        children = []
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            lines = [json.loads(ln) for ln in stdout.splitlines()
                     if ln.startswith("{")]
            if p.returncode != 0 or not lines or "ok" not in lines[-1]:
                raise AssertionError(f"emitter child failed ({p.returncode})"
                                     f": {stdout[-2000:]} {stderr[-2000:]}")
            children.append(lines)
        t_done = time.monotonic()
        if any(c[-1]["foreign"] for c in children):
            raise AssertionError("an emitter child loaded torch or JAX")
        t_first = min(c[0]["t_send"] for c in children)
        t_fan[0] = (t_first, t_fan[0][1])
        # the fleet is gone: pending frames publish, the watchdog sees
        # the silence, the last freshness samples land in the window
        _ob_wait(lambda: rx.stats()["freshness_pending"] == 0,
                 "every frame published", 30.0)

        def served():
            res = ms.query_window("fed.FreshnessUs", 3600.0,
                                  percentiles=(0.99,))
            return res.metrics.get("fed.FreshnessUs") or {}

        _ob_wait(lambda: served().get("count") == len(rx.freshness_values),
                 "the freshness samples in the window", 30.0)
        _ob_wait(lambda: "emitter_starvation" in [
            r["code"] for r in _ob_get(f"{url}/healthz")[1]["reasons"]],
            "emitter_starvation in /healthz", 30.0)
        health_status, health = _ob_get(f"{url}/healthz")
        fresh = np.asarray(rx.freshness_values, dtype=np.float64)
        p99 = served()["p99"]
        oracle = _fs_freshness_oracle(fresh)
        active = set(ms.rule_engine.active())
        st = rx.stats()
        dump = ms.debug_dump()
        k = kernel_launches()
        rx_trace = os.path.join(tmp, "rx.json")
        dump_perfetto(ms.obs, rx_trace, process_name="aggregator")
        commit_p50 = ms.committer._latency_hist.percentile(50.0)
        fanout = ms.committer.fanout_intervals
        ep.stop()
        ep, stopped = None, True
        ms.stop()
        torch.cuda.synchronize()
        total = want_merged[-1]
        checks = {
            "samples_merged": (st["samples_merged"], total),
            "child samples": (sum(c[-1]["samples"] for c in children),
                              total),
            "decode_errors": (st["decode_errors"], 0),
            "samples_shed": (st["samples_shed"], 0),
            "freshness_dropped": (st["freshness_dropped"], 0),
            "freshness_samples": (st["freshness_samples"], len(fresh)),
            "fanout_intervals": (fanout, 0),
            "served p99": (p99, oracle),
            "debug_dump federation merged": (
                dump.get("federation", {}).get("samples_merged"), total),
        }
        bad = {k_: v for k_, v in checks.items() if v[0] != v[1]}
        if bad:
            raise AssertionError(f"(got, want): {bad}")
        if k["sparse_ingest"] <= 0 or k["window_merge"] <= 0:
            raise AssertionError(f"launches {k}")
        measured_p99 = float(np.percentile(fresh, 99))
        if not (FS_BUDGET_US < measured_p99 and tight.name in active
                and lax.name not in active):
            raise AssertionError(f"rules {sorted(active)} at p99 "
                                 f"{measured_p99} us")
        want, rows = _fs_oracle(ms.aggregator.registry)
        acc = ms.aggregator._acc[torch.from_numpy(rows).to(
            ms.aggregator._acc.device)].cpu().numpy()
        if ms.aggregator._spill is not None and \
                ms.aggregator._spill[rows].any():
            raise AssertionError("federated rows spilled to the host")
        if not np.array_equal(acc, want):
            diff = np.flatnonzero((acc != want).any(axis=1))
            raise AssertionError(f"{len(diff)} federated rows differ from "
                                 f"the oracle, first {diff[:5]}")
        traces = sorted(os.path.join(tmp, f) for f in os.listdir(tmp)
                        if f.startswith("em"))
        merged = merge_traces(traces + [rx_trace])
        by_flow = collections.defaultdict(set)
        for ev in merged["traceEvents"]:
            if ev.get("cat") == "fed":
                by_flow[ev["id"]].add(ev["pid"])
        crossing = sum(1 for pids in by_flow.values() if len(pids) > 1)
        if len(traces) != FS_TRACED or crossing == 0:
            raise AssertionError(f"{len(traces)} emitter traces, {crossing} "
                                 "flows across processes")
        fan_s = sum(b - a for a, b in t_fan)
        out.update({
            "emitters": FS_EMITTERS, "names": FS_NAMES,
            "rows": ms.aggregator.num_metrics,
            "samples_merged": st["samples_merged"],
            "frames": st["frames_received"],
            # a frame sent twice (the sender thread's retry racing the
            # emitter's drain) merges once: deduplicated by seq
            "duplicate_frames": st["duplicate_frames"],
            "bytes_received": st["bytes_received"],
            "fan_in_s": [round(b - a, 4) for a, b in t_fan],
            "samples_merged_per_s": total / fan_s,
            "frames_per_s": st["frames_received"] / (t_done - t_first),
            "spawn_to_first_send_s": t_first - t_start,
            "freshness_us": {"count": len(fresh),
                             "p50": float(np.percentile(fresh, 50)),
                             "p99": measured_p99,
                             "served_p99": p99},
            "commit_p50_us": commit_p50,
            "rules_firing": sorted(active),
            "healthz": {"status": health_status,
                        "reasons": [r["code"] for r in health["reasons"]]},
            "flows_across_processes": crossing,
            "k3_launches": k["sparse_ingest"],
            "k5_launches": k["window_merge"],
            "launches": {n: v for n, v in k.items() if v},
        })
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if ep is not None:
            ep.stop()
        if not stopped:
            ms.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# -- the sketches -----------------------------------------------------------------

# LogHistogram at the headline's bucket_limit fed SK_VALUES lognormal
# values through K2a and K2b; a t-digest (capacity 512) fed them in
# SK_TD_BATCHES batches; HLL p=14 over SK_HLL_DISTINCT distinct values
# (each twice); moments over SK_VALUES normal values; SK_STACK stacked
# t-digests (capacity 64) and HLLs fed SK_STACK_VALUES values each in one
# torch.func.vmap call, SK_CHECKED of them held against single CPU calls.
SK_VALUES = 1 << 22
SK_TD_BATCHES = 64
SK_HLL_DISTINCT = 10 ** 6
SK_STACK = 10_000
SK_STACK_VALUES = 4096
SK_CHECKED = 64
SK_QS = (0.0, 0.001, 0.01, 0.25, 0.5, 0.75, 0.9, 0.99, 0.999, 0.9999, 1.0)


def _sk_digest_close(got, want, span, what):
    """t-digest quantiles within the CPU tests' tolerance: rtol 1e-4 plus
    1e-6 of the data's range."""
    if not np.allclose(got, want, rtol=1e-4, atol=1e-6 * span):
        raise AssertionError(f"{what}: {got} against {want}")


def phase_sketches(torch):
    """The sketches on the card (``loghisto_tpu_torch.models``): each
    result against the same port function on the CPU (integers EQUAL,
    floats within the tolerances tests/test_torch_sketches.py states)
    and against numpy truth within the JAX tests' accuracy bounds; the
    LogHistogram's counts EQUAL to compress_np's histogram and its
    inserts launching K2a, then K2b."""
    from torch.func import vmap

    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.models import LogHistogram, hll, moments, tdigest
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )
    from loghisto_tpu_torch.ops.codec import compress_np

    card = RESULTS["card"]  # nvidia-smi's name and power limit
    print(card, flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng([SEED, 19, 12])
    op_ms = {}

    def timed(name, fn):
        """fn's ms on its first call (a first use builds PyTorch's
        kernels: jiterator, NVRTC) and on a second, warm one."""
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        op_ms[name] = {"first": round(times[0], 3), "warm": round(times[1], 3)}
        return result

    # LogHistogram: a multiple of 2048 samples through K2a, then two
    # ragged pieces through K2b
    cfg = MetricConfig(bucket_limit=BL)
    values = lognormal_values(rng, SK_VALUES)
    v = torch.from_numpy(values).to(dev)
    cut, tail = SK_VALUES // 2, SK_VALUES - 1000
    reset_kernel_launches()
    h = LogHistogram.empty(cfg, device=dev)
    h = timed("loghist_insert_k2a", lambda: h.insert(v[:cut]))
    k2a = kernel_launches()["row_ingest"]
    h = timed("loghist_insert_k2b", lambda: h.insert(v[cut:tail]))
    h = h.insert(v[tail:])
    k2 = kernel_launches()["row_ingest"]
    if (k2a, k2) != (2, 5):  # each timed insert runs twice
        raise AssertionError(f"K2 launches {k2a}, {k2}: want 2, then 5")
    want = np.bincount(np.clip(compress_np(values), -BL, BL).astype(np.int64)
                       + BL, minlength=B)
    cpu_h = LogHistogram.empty(cfg, device="cpu").insert(values)
    got = h.counts.cpu().numpy()
    if not (np.array_equal(got, want)
            and np.array_equal(cpu_h.counts.numpy(), want)
            and h.count == SK_VALUES):
        raise AssertionError("LogHistogram counts differ from compress_np's")
    stats = timed("loghist_statistics", lambda: h.statistics(list(PS)))
    cpu_stats = cpu_h.statistics(list(PS))
    if not (stats["count"] == cpu_stats["count"] == SK_VALUES
            and np.array_equal(stats["percentiles"], cpu_stats["percentiles"])
            and np.isclose(stats["sum"], cpu_stats["sum"], rtol=1e-5)):
        raise AssertionError(f"statistics {stats} against {cpu_stats}")
    rel = np.abs(stats["percentiles"][[1, 5]]
                 / np.quantile(values, PS[[1, 5]]) - 1)
    if rel.max() >= 0.011:  # p50 and p99 within the codec's 1%
        raise AssertionError(f"LogHistogram percentiles off by {rel}")

    # t-digest (capacity 512): the same values in 64 batches
    tcfg = tdigest.TDigestConfig(capacity=512)
    qs = np.asarray(SK_QS, dtype=np.float32)

    def digest(batches, device):
        m, w = tdigest.empty(tcfg, device=device)
        for b in batches:
            m, w = tdigest.insert(m, w, b, config=tcfg)
        return m, w

    span = float(values.max() - values.min())
    td = timed("tdigest_64_inserts", lambda: digest(
        v.view(SK_TD_BATCHES, -1), dev))
    td_q = timed("tdigest_quantile", lambda: tdigest.quantile(
        *td, torch.from_numpy(qs).to(dev))).cpu().numpy()
    cpu_td = digest(torch.from_numpy(values).view(SK_TD_BATCHES, -1), "cpu")
    w, cpu_w = td[1].cpu().numpy(), cpu_td[1].numpy()
    pop = td[0].cpu().numpy()[w > 0]
    if not (w.sum() == cpu_w.sum() == SK_VALUES
            and pop.min() == values.min() and pop.max() == values.max()):
        raise AssertionError("t-digest total weight or range")
    _sk_digest_close(td_q, tdigest.quantile(*cpu_td, qs).numpy(), span,
                     "t-digest on the card against the CPU")
    truth = np.quantile(values, qs)
    td_err = np.abs(td_q / truth - 1)
    if td_err[qs == np.float32(0.999)][0] >= 0.05 or \
            td_err[qs == np.float32(0.9999)][0] >= 0.10:
        raise AssertionError(f"t-digest tail errors {td_err}")

    # HyperLogLog p=14 over 10^6 distinct values, each twice
    distinct = rng.permutation(SK_HLL_DISTINCT).astype(np.float32)
    stream = np.concatenate([distinct, rng.permutation(distinct)])
    hv = torch.from_numpy(stream).to(dev)
    regs = timed("hll_insert", lambda: hll.insert(hll.empty(device=dev), hv))
    est = float(timed("hll_estimate", lambda: hll.estimate(regs)))
    cpu_regs = hll.insert(hll.empty(device="cpu"), stream)
    if not torch.equal(regs.cpu(), cpu_regs):
        raise AssertionError("HLL registers differ from the CPU's")
    if not (np.isclose(est, float(hll.estimate(cpu_regs)), rtol=1e-6)
            and abs(est / SK_HLL_DISTINCT - 1) < 0.05):
        raise AssertionError(f"HLL estimate {est}")

    # moments over 2^22 normal values
    mv = rng.normal(100.0, 15.0, SK_VALUES).astype(np.float32)
    st = timed("moments_insert", lambda: moments.insert(
        moments.empty(device=dev), torch.from_numpy(mv).to(dev)))
    mq = timed("moments_quantile", lambda: moments.quantile(
        st, [0.5, 0.9, 0.99])).cpu().numpy()
    cpu_st = moments.insert(moments.empty(device="cpu"), mv)
    n = SK_VALUES
    sigma = (float(cpu_st.m2) / n) ** 0.5
    if not int(st.count) == int(cpu_st.count) == n or any(
            float(getattr(st, f)) != float(getattr(cpu_st, f))
            for f in ("scale", "min", "max")):
        raise AssertionError("moments count, scale or range")
    # rtol 1e-5, or within 1e-5 of n * sigma^k: at 2^22 samples the batch
    # mean's float32 sum rounds by ~1e-7 of the mean on either device,
    # which moves M3 by 3 * dmean * M2, 1e-6-1e-5 of n * sigma^3
    for field, atol in (("mean", 1e-6 * sigma),
                        ("m2", 1e-5 * n * sigma ** 2),
                        ("m3", 1e-5 * n * sigma ** 3),
                        ("m4", 1e-5 * n * sigma ** 4)):
        got_f, want_f = float(getattr(st, field)), float(getattr(cpu_st,
                                                                 field))
        if not np.isclose(got_f, want_f, rtol=1e-5, atol=atol):
            raise AssertionError(f"moments {field}: {got_f} against "
                                 f"{want_f} (atol {atol})")
    mean, std, skew, kurt = (float(x)
                             for x in moments.standardized_moments(st))
    if not (abs(mean - mv.mean(dtype=np.float64)) < 0.5
            and abs(std - mv.std(dtype=np.float64)) < 0.5
            and abs(skew) < 0.1 and abs(kurt - 3.0) < 0.1
            and np.abs(mq - np.quantile(mv, [0.5, 0.9, 0.99])).max() < 1.0):
        raise AssertionError(f"moments {mean} {std} {skew} {kurt} {mq}")

    # SK_STACK t-digests (capacity 64) and HLLs, one vmap call each
    sv = rng.lognormal(3.0, 1.0, (SK_STACK, SK_STACK_VALUES)).astype(
        np.float32)
    sx = torch.from_numpy(sv).to(dev)
    small = tdigest.TDigestConfig(capacity=64)
    m0, w0 = tdigest.empty(small, device=dev)
    vq = torch.tensor([0.5, 0.99], device=dev)
    ms2, ws2 = timed("tdigest_vmap_insert", lambda: vmap(
        lambda m, w, x: tdigest.insert(m, w, x, config=small))(
        m0.expand(SK_STACK, -1).clone(), w0.expand(SK_STACK, -1).clone(),
        sx))
    vq_out = timed("tdigest_vmap_quantile", lambda: vmap(
        lambda m, w: tdigest.quantile(m, w, vq))(ms2, ws2)).cpu().numpy()
    regs2 = timed("hll_vmap_insert", lambda: vmap(hll.insert)(
        hll.empty(device=dev).expand(SK_STACK, -1).clone(), sx))
    est2 = timed("hll_vmap_estimate", lambda: vmap(hll.estimate)(
        regs2)).cpu().numpy()
    checked = rng.choice(SK_STACK, SK_CHECKED, replace=False)
    cpu_m0, cpu_w0 = tdigest.empty(small, device="cpu")
    for i in checked:
        x = torch.from_numpy(sv[i])
        cm, cw = tdigest.insert(cpu_m0, cpu_w0, x, config=small)
        if not float(ws2[i].sum()) == float(cw.sum()) == SK_STACK_VALUES:
            raise AssertionError(f"stacked t-digest {i}: total weight")
        _sk_digest_close(vq_out[i], tdigest.quantile(cm, cw, vq.cpu()).numpy(),
                         float(sv[i].max() - sv[i].min()),
                         f"stacked t-digest {i}")
        cregs = hll.insert(hll.empty(device="cpu"), x)
        if not torch.equal(regs2[i].cpu(), cregs):
            raise AssertionError(f"stacked HLL {i}: registers")
        if not np.isclose(est2[i], float(hll.estimate(cregs)), rtol=1e-6):
            raise AssertionError(f"stacked HLL {i}: estimate")
    srt = np.sort(sv, axis=1)
    distinct_rows = 1 + (np.diff(srt, axis=1) != 0).sum(axis=1)
    hll_err = np.abs(est2 / distinct_rows - 1)
    td_rel = np.abs(vq_out[:, 0] / np.quantile(sv, 0.5, axis=1) - 1)
    if hll_err.max() >= 0.1 or td_rel.max() >= 0.05:
        raise AssertionError(f"stacked sketches: HLL {hll_err.max()}, "
                             f"t-digest p50 {td_rel.max()}")
    return {
        "card": card, "ms": op_ms,
        "k2_launches": k2, "loghist_count": h.count,
        "tdigest_q_err": {f"{q:g}": float(e) for q, e in zip(SK_QS, td_err)},
        "hll_estimate": est, "moments": [mean, std, skew, kurt],
        "stacked": {"sketches": SK_STACK, "checked": SK_CHECKED,
                    "hll_err_max": float(hll_err.max()),
                    "tdigest_p50_err_max": float(td_rel.max())},
        "launches": {k: v for k, v in kernel_launches().items() if v},
    }


# -- the mesh over torch.distributed (ROADMAP D8, item 11a) ---------------

# (a) world size 1 under NCCL at the headline width: MS_BATCHES batches of
# BATCH Zipf(1.3) samples through TorchAggregator(mesh=make_mesh(1, 1))
# beside the single-device oracle, and the per-batch and interval steps
# (collect.start in flight while the next batch folds); (b) two ranks on
# the one card under gloo (NCCL refuses two ranks on one GPU), meshes
# (2, 1) and (1, 2), MS_ROW_BATCHES batches for each stream row (row s
# takes batches s * MS_ROW_BATCHES ...), raw (K1) and sparse (K3)
# transports, every rank's reduced block and collected set against the
# oracle; (c) run_firehose(mesh=make_mesh(1, 1)) under NCCL; (d) the
# mesh's fused commit (ROADMAP D9, item 11b-1): TorchMetricSystem(mesh=,
# retention=True, commit="auto") at the system's defaults (MC_M rows, the
# 60x1 / 60x60 / 24x3600 tiers, bucket_limit 4096) on (1, 1) under NCCL and
# on (2, 1) and (1, 2) in the two gloo ranks, MC_INTERVALS intervals of each
# rank's stream row, the first MC_LIVE broadcast through the committer's
# bridge (queued, D9) and committed by a query, the rest through
# backfill_retention; every rank's written ring
# slots (sha256 of its block) and its served query against a single-device
# TorchMetricSystem on the card fed the merged intervals, K3 and K5
# launched on every rank; (e) lifecycle and drift on the mesh (ROADMAP D10,
# item 11b-2): lifecycle_drift_main_path's system (ttl 2, 24 hourly banks,
# decay 0.97, min_samples 64) with mesh= at MC_M rows and the default tiers,
# on the same three meshes, ML_INTERVALS churn intervals (ML_STEADY steady
# names, ML_FRESH fresh ones an interval, the shape shift at ML_SHIFT_AT,
# one explicit compaction after ML_COMPACT_AT); "_overflow.api" is
# registered first (block 0), so on (1, 2) the fresh victims (block 1)
# fold across ranks, which the phase checks; every rank's activity block,
# bank blocks, interval histogram block, ring blocks (sha256) and served
# scores against a single-device system on the card, K6 and K7 launched
# on every rank.  One card: no figure here is a scaling figure, the ranks
# share its SMs.
MS_BATCHES = 16
MS_ROW_BATCHES = 8
MS_SHAPES = ((2, 1), (1, 2))
MS_DEADLINE_S = 300.0
MS_FH_SECONDS = 1.0
MC_M = 1024
MC_INTERVALS = 8
MC_LIVE = 3  # of them broadcast through the bridge, committed by a query
MC_CELLS = 16  # cells of each name in each stream row's interval
MC_PS = (0.5, 0.99, 1.0)
MC_GATHER_REPS = 5
ML_STEADY = 384
ML_FRESH = 96
ML_INTERVALS = 16
ML_SHIFT_AT = 8
ML_COMPACT_AT = 12
ML_SAMPLES = 1 << 17  # a stream row's samples an interval
ML_HOUR = _dt.datetime(2026, 1, 1, 9, tzinfo=_dt.timezone.utc)


def _ms_batch(k):
    """Batch k of the mesh phase's stream (the parent and the ranks
    regenerate it from its seed)."""
    rng = np.random.default_rng([SEED, 20, k])
    return zipf_ids(rng, BATCH, M), lognormal_values(rng, BATCH)


def _ms_aggregator(mesh=None, transport="raw"):
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    agg = TorchAggregator(num_metrics=M, batch_size=BATCH,
                          transport=transport, mesh=mesh, max_metrics=M)
    for i in range(M):
        agg.registry.id_for(f"m{i}")
    return agg


def _ms_digest(t):
    import hashlib

    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def _mc_raw(k, rows):
    """Interval k of the mesh commit holding the merged cells of the
    stream rows ``rows``: every name, in order (the ranks' registries
    intern them alike), and the rows' ``req`` counter."""
    from loghisto_tpu_torch.metrics import RawMetricSet

    hists = {f"m{i}": {} for i in range(MC_M)}
    for s in rows:
        rng = np.random.default_rng([SEED, 21, k, s])
        buckets = np.clip(np.round(rng.normal(800.0, 600.0,
                                              (MC_M, MC_CELLS))), -BL, BL)
        counts = rng.integers(1, 100, (MC_M, MC_CELLS))
        for i, (bs, cs) in enumerate(zip(buckets.astype(np.int64).tolist(),
                                         counts.tolist())):
            h = hists[f"m{i}"]
            for b, c in zip(bs, cs):
                h[b] = h.get(b, 0) + c
    return RawMetricSet(
        _dt.datetime(2026, 1, 1, tzinfo=_dt.timezone.utc)
        + k * _ONE_SECOND, {}, {"req": k + sum(rows)}, hists, {}, 1.0)


def _mc_system(mesh=None):
    from loghisto_tpu_torch import TorchMetricSystem

    return TorchMetricSystem(interval=1.0, sys_stats=False, num_metrics=MC_M,
                             retention=True, commit="auto", mesh=mesh)


def _mc_digests(torch, wheel, blocks=1):
    """Per tier, per block of ``blocks`` equal row blocks: sha256 of the
    written slots; the unwritten slots must be zero."""
    import hashlib

    out = []
    for t in wheel._tiers:
        written = np.nonzero(t.written)[0]
        slots = t.ring[torch.from_numpy(written).to(t.ring.device)]
        nonzero = int(torch.count_nonzero(t.ring))
        if nonzero != int(torch.count_nonzero(slots)):
            raise AssertionError("an unwritten ring slot holds counts")
        rows = slots.shape[1] // blocks
        out.append([hashlib.sha256(
            slots[:, b * rows:(b + 1) * rows].contiguous().cpu().numpy()
            .tobytes()).hexdigest() for b in range(blocks)])
        del slots
    return out


def _mc_served(ms):
    """The served full-span query of every name."""
    return {name: entry for name, entry in sorted(
        ms.query("*", percentiles=MC_PS).metrics.items())}


def _mc_same_served(got, want, what):
    if set(got) != set(want):
        raise AssertionError(f"{what}: served names differ")
    for name, w in want.items():
        g = got[name]
        for key, value in w.items():
            if key in ("sum", "avg"):
                ok = abs(g[key] - value) <= 1e-5 * abs(value) + 1e-6
            else:  # counts and percentiles (bucket representatives)
                ok = g[key] == value
            if not ok:
                raise AssertionError(f"{what}: {name} {key} {g[key]} != "
                                     f"{value}")


def _mc_oracles(torch):
    """The single-device committer on the card fed the merged intervals:
    for (2, 1) stream rows 0 and 1, for (1, 1) and (1, 2) row 0 alone.
    Returns {rows: (digests per tier for 1 and 2 row blocks, served)}."""
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )

    out = {}
    for rows in ((0, 1), (0,)):
        ms = _mc_system()
        try:
            reset_kernel_launches()
            ms.backfill_retention([_mc_raw(k, rows)
                                   for k in range(MC_INTERVALS)])
            if ms.committer.fused_intervals != MC_INTERVALS:
                raise AssertionError("the oracle did not commit fused")
            launched = kernel_launches()
            out[rows] = ({1: _mc_digests(torch, ms.retention),
                          2: _mc_digests(torch, ms.retention, 2)},
                         _mc_served(ms),
                         {k: v for k, v in launched.items() if v})
        finally:
            ms.stop()
            del ms
            torch.cuda.empty_cache()
    return out


def _mc_run(torch, mesh, rows):
    """Part (d) on one rank: MC_INTERVALS intervals of this rank's stream
    row, the first MC_LIVE of them broadcast through the committer's
    subscription (the live path: the bridge queues them, D9, and the
    first query commits them), the rest through backfill_retention, one
    at a time; the live drain's time, per-interval commit times, the
    stream gather's time, the launches, the digests of the rank's ring
    blocks and the served query."""
    import torch.distributed as dist

    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )
    from loghisto_tpu_torch.parallel.mesh import (
        STREAM_AXIS,
        axis_size,
        gather_triples,
        pad_triples,
    )

    ms = _mc_system(mesh)
    try:
        if ms.commit_path != "fused" or ms.debug_dump()["mesh"] is None:
            raise AssertionError(f"the mesh resolved {ms.commit_path}")
        raws = [_mc_raw(k, rows) for k in range(MC_INTERVALS)]
        reset_kernel_launches()
        ms._update_subscribers()  # the committer's subscription
        for raw in raws[:MC_LIVE]:
            with ms._subscribers_lock:
                ms._broadcast(ms._raw_subscribers, raw)
        end = time.monotonic() + 60.0
        while ms.committer.queued_intervals < MC_LIVE:
            if time.monotonic() > end:
                raise AssertionError("the bridge did not queue the "
                                     "broadcast intervals")
            time.sleep(0.01)
        if ms.committer.intervals_committed:
            raise AssertionError("the bridge committed off the main thread")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms.query("m0")  # commits the queued intervals, then serves
        torch.cuda.synchronize()
        drain_ms = (time.perf_counter() - t0) * 1e3
        if (ms.committer.intervals_committed != MC_LIVE
                or ms.debug_dump()["queued_intervals"]):
            raise AssertionError("the query did not commit the queued "
                                 "intervals")
        commit_ms = []
        for raw in raws[MC_LIVE:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ms.backfill_retention([raw])
            torch.cuda.synchronize()
            commit_ms.append((time.perf_counter() - t0) * 1e3)
        launched = {k: v for k, v in kernel_launches().items() if v}
        for kernel in ("sparse_ingest", "window_merge"):
            if launched.get(kernel, 0) <= 0:
                raise AssertionError(f"{kernel} not launched on the mesh "
                                     "commit")
        if ms.aggregator.stats_snapshot is not None:
            raise AssertionError("a mesh rank published an acc snapshot")
        # the stream gather of one chunk's shares, alone
        width = ms.committer._staging.width
        share = torch.from_numpy(pad_triples(np.zeros((0, 3), np.int32),
                                             width)).cuda()
        gather_ms = []
        for _ in range(MC_GATHER_REPS + 1):
            torch.cuda.synchronize()
            dist.barrier(group=mesh.get_group(STREAM_AXIS))
            t0 = time.perf_counter()
            gather_triples(mesh, share)
            torch.cuda.synchronize()
            gather_ms.append((time.perf_counter() - t0) * 1e3)
        return {
            "commit_path": ms.commit_path,
            "mesh": ms.debug_dump()["mesh"],
            "live_drain_ms": drain_ms,
            "commit_ms": commit_ms, "gather_ms": gather_ms[1:],
            "gather_cells": width * axis_size(mesh, STREAM_AXIS),
            "steps": ms.committer.last_dispatches,
            "ring_gb": ms.retention.hbm_bytes() / 1e9,
            "launches": launched,
            "digests": _mc_digests(torch, ms.retention),
            "served": _mc_served(ms),
        }
    finally:
        ms.stop()
        del ms
        torch.cuda.empty_cache()


def _mc_check(got, oracle, block, blocks, what):
    """One rank's part (d) against the oracle of its stream rows."""
    digests, served, _ = oracle
    want = [tier[block] for tier in digests[blocks]]
    if [tier[0] for tier in got["digests"]] != want:
        raise AssertionError(f"{what}: the ring blocks differ from the "
                             "single-device committer's")
    _mc_same_served(got["served"], served, what)
    return {k: v for k, v in got.items() if k not in ("digests", "served")}


@functools.lru_cache(maxsize=None)
def _ml_cells(k, s):
    """Stream row s's cells of churn interval k: int64 [n, 3] (name
    index, codec bucket, count) over ``_ml_names(k)``, ML_SAMPLES
    lognormal samples, 40% of the samples of names 100-107 at 8x from
    ML_SHIFT_AT."""
    from loghisto_tpu_torch.ops.codec import compress_np

    base = np.random.default_rng([SEED, 22])
    mu = base.uniform(2.0, 6.0, ML_STEADY + ML_FRESH)
    sigma = base.uniform(0.3, 1.0, ML_STEADY + ML_FRESH)
    rng = np.random.default_rng([SEED, 22, k, s])
    ids = rng.integers(0, ML_STEADY + ML_FRESH, ML_SAMPLES)
    values = rng.lognormal(mu[ids], sigma[ids])
    if k >= ML_SHIFT_AT:
        hit = (ids >= 100) & (ids < 108) & (rng.random(ML_SAMPLES) < 0.4)
        values[hit] *= 8.0
    keys = ids.astype(np.int64) * 65536 + compress_np(values).astype(
        np.int64) + 32768
    uniq, counts = np.unique(keys, return_counts=True)
    return np.stack([uniq >> 16, (uniq & 0xFFFF) - 32768, counts], axis=1)


def _ml_names(k):
    return ([f"svc.{i}.latency" for i in range(ML_STEADY)]
            + [f"api.u{k * ML_FRESH + j}.lat" for j in range(ML_FRESH)])


def _ml_raw(k, rows):
    """Interval k of part (e) holding the merged cells of the stream rows
    ``rows``: every name of the interval, in order (the ranks'
    registries intern them alike)."""
    from loghisto_tpu_torch.metrics import RawMetricSet

    names = _ml_names(k)
    cells = np.concatenate([_ml_cells(k, s) for s in rows])
    keys = cells[:, 0] * 65536 + cells[:, 1] + 32768
    uniq, inv = np.unique(keys, return_inverse=True)
    counts = np.bincount(inv.reshape(-1), weights=cells[:, 2]).astype(
        np.int64)
    rows_of = uniq >> 16
    bounds = np.searchsorted(rows_of, np.arange(len(names) + 1))
    buckets = ((uniq & 0xFFFF) - 32768).tolist()
    counts = counts.tolist()
    hists = {name: dict(zip(buckets[bounds[i]:bounds[i + 1]],
                            counts[bounds[i]:bounds[i + 1]]))
             for i, name in enumerate(names)}
    return RawMetricSet(time=ML_HOUR + k * _ONE_SECOND, counters={},
                        rates={}, histograms=hists, gauges={}, duration=1.0)


def _ml_system(mesh=None, resilience=None):
    from loghisto_tpu_torch import TorchMetricSystem
    from loghisto_tpu_torch.anomaly import AnomalyConfig, hourly_bank
    from loghisto_tpu_torch.lifecycle import LifecycleConfig

    ms = TorchMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=MC_M, retention=True,
        commit="auto", mesh=mesh, resilience=resilience,
        lifecycle=LifecycleConfig(ttl_intervals=2, check_every=1,
                                  auto_compact_fragmentation=0.0),
        anomaly=AnomalyConfig(banks=LD_BANKS, bank_of=hourly_bank,
                              decay=0.97, min_samples=64, window=6.0))
    # the overflow row in block 0, the fresh names (and so the victims)
    # past the steady ones
    ms.metric_id("_overflow.api")
    for i in range(ML_STEADY):
        ms.metric_id(f"svc.{i}.latency")
    return ms


def _ml_state(torch, ms, blocks=1):
    """Digests of every carry per block of ``blocks`` equal row blocks
    (the activity vector, the active bank's profile and weight, the
    interval histogram, the rings' written slots), the other banks'
    emptiness, the registry's digest, the counters and the scores."""
    import hashlib

    lc, an = ms.lifecycle, ms.anomaly
    bank = ML_HOUR.hour % LD_BANKS
    others = torch.ones(LD_BANKS, dtype=torch.bool)
    others[bank] = False
    if int(torch.count_nonzero(an._prof[others.to(an._prof.device)])):
        raise AssertionError("a bank other than the active one holds mass")

    def per_block(t, dim=0):
        rows = t.shape[dim] // blocks
        return [_ms_digest(t.narrow(dim, b * rows, rows))
                for b in range(blocks)]

    names = "\n".join("" if n is None else n
                       for n in ms.aggregator.registry.names())
    return {
        "la": per_block(lc._la), "prof": per_block(an._prof[bank]),
        "wsum": per_block(an._wsum[bank]), "ihist": per_block(an._ihist),
        "rings": _mc_digests(torch, ms.retention, blocks),
        "names": hashlib.sha256(names.encode()).hexdigest(),
        "counters": [lc.evicted_series, lc.overflowed_samples,
                     lc.evictions, lc.compactions],
        "scores": {k: v.tolist() for k, v in an._scores.items()},
    }


def _ml_feed(torch, ms, rows):
    """Part (e)'s intervals through backfill_retention, one at a time,
    an explicit compaction after ML_COMPACT_AT; per-call times."""
    lc, an = ms.lifecycle, ms.anomaly
    times = collections.defaultdict(list)
    sent = {"evict": [], "compact": []}

    def timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    evict = timed("evict_ms", lc.evict_ids)

    def evict_ids(victims):
        out = evict(victims)
        sent["evict"].append(lc.last_evict_bytes)
        return out

    lc.evict_ids = evict_ids
    an.score_now = timed("score_ms", an.score_now)
    commit = timed("commit_ms", ms.backfill_retention)
    for k in range(ML_INTERVALS):
        commit([_ml_raw(k, rows)])
        if k == ML_COMPACT_AT:
            if not timed("compact_ms", lc.compact)():
                raise AssertionError("the compaction did not run")
            sent["compact"].append(lc.last_compaction_bytes)
    return dict(times), sent


def _ml_oracles(torch):
    """The single-device system on the card fed part (e)'s merged
    intervals, for stream rows (0, 1) and (0,): digests per 1 and 2
    blocks and the scores."""
    out = {}
    for rows in ((0, 1), (0,)):
        ms = _ml_system()
        try:
            _ml_feed(torch, ms, rows)
            if ms.committer.fused_intervals != ML_INTERVALS:
                raise AssertionError("the oracle did not commit fused")
            out[rows] = {b: _ml_state(torch, ms, b) for b in (1, 2)}
        finally:
            ms.stop()
            del ms
            torch.cuda.empty_cache()
    return out


def _ml_run(torch, mesh, rows):
    """Part (e) on one rank: the intervals of this rank's stream row
    through the mesh system; its digests, scores, the launches of the
    path and the eviction, compaction and scoring figures."""
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )
    from loghisto_tpu_torch.parallel.mesh import METRIC_AXIS, axis_size

    ms = _ml_system(mesh)
    try:
        if ms.commit_path != "fused":
            raise AssertionError(f"the mesh resolved {ms.commit_path}")
        reset_kernel_launches()
        t0 = time.perf_counter()
        times, sent = _ml_feed(torch, ms, rows)
        feed_s = time.perf_counter() - t0
        launched = {k: v for k, v in kernel_launches().items() if v}
        for kernel in ("sparse_ingest", "window_merge", "compact_rows",
                       "divergence"):
            if launched.get(kernel, 0) <= 0:
                raise AssertionError(f"{kernel} not launched on the mesh "
                                     "lifecycle path")
        if ms.committer.fused_intervals != ML_INTERVALS:
            raise AssertionError("the mesh did not commit fused")
        if ms.anomaly.scored_intervals < ML_INTERVALS - 1:
            raise AssertionError("the mesh skipped scoring passes")
        state = _ml_state(torch, ms, 1)
        return {"feed_s": feed_s, **times, "evict_bytes": sent["evict"],
                "compact_bytes": sent["compact"], "launches": launched,
                "n_metric": axis_size(mesh, METRIC_AXIS),
                "scored": ms.anomaly.scored_intervals, "state": state}
    finally:
        ms.stop()
        del ms
        torch.cuda.empty_cache()


def _ml_check(got, oracle, block, blocks, what):
    """One rank's part (e) against the oracle of its stream rows: the
    digests of its blocks equal, the scores within rel 1e-6, abs 1e-7
    (the CPU tests' mesh-against-single-device tolerance)."""
    state, want = got["state"], oracle[blocks]
    for key in ("la", "prof", "wsum", "ihist"):
        if state[key][0] != want[key][block]:
            raise AssertionError(f"{what}: the {key} block differs from "
                                 "the single-device system's")
    if [tier[0] for tier in state["rings"]] != [
            tier[block] for tier in want["rings"]]:
        raise AssertionError(f"{what}: the ring blocks differ")
    for key in ("names", "counters"):
        if state[key] != want[key]:
            raise AssertionError(f"{what}: {key} differ")
    for key, w in want["scores"].items():
        g = np.asarray(state["scores"][key])
        if not np.allclose(g, w, rtol=1e-6, atol=1e-7):
            raise AssertionError(f"{what}: {key} scores differ by "
                                 f"{float(np.abs(g - w).max())}")
    if state["counters"][0] <= 0:
        raise AssertionError(f"{what}: nothing was evicted")
    return {k: v for k, v in got.items() if k != "state"} | {
        "evicted_series": state["counters"][0],
        "overflowed_samples": state["counters"][1]}


# Part (f) of mesh_main_path: checkpoints, the journal and crash recovery
# across mesh shapes (ROADMAP D11, item 11b-3).  Part (e)'s system with
# resilience=ResilienceConfig(checkpoint_every_intervals=MF_EVERY): two gloo
# ranks on (2, 1) drive MF_CRASH of part (e)'s intervals by hand (each
# broadcast to its row's journal and the committer's queue, one collective
# drain commits them, the checkpoint lands at MF_EVERY), then the parent
# SIGKILLs both; two fresh gloo ranks on (1, 2) recover from the
# checkpoint and both rows' journals and take MF_AFTER intervals more; a
# (1, 1) rank under NCCL crashes and recovers the same way in the parent;
# one device with no mesh recovers from the (2, 1) files.  Every recovered
# rank's blocks against the single-device system that crashed and
# recovered on the merged intervals, the collected counts against the
# cells' host sums (the uncrashed oracle).
MF_CRASH = 12
MF_EVERY = 8
MF_AFTER = 4
MF_ROWS = (0, 1)  # the crash's stream rows: every target replays both
MF_DEADLINE_S = 300.0


def _mf_raw(k, rows):
    """Part (e)'s interval k of the stream rows ``rows``, seq k + 1."""
    return dataclasses.replace(_ml_raw(k, rows), seq=k + 1)


def _mf_system(d, mesh=None):
    from loghisto_tpu_torch.resilience import ResilienceConfig

    return _ml_system(mesh, resilience=ResilienceConfig(
        checkpoint_path=os.path.join(d, "ck.npz"),
        journal_path=os.path.join(d, "jl.log"),
        checkpoint_every_intervals=MF_EVERY, recover_on_start=False))


def _mf_counted(module, name, sink, key):
    """``module.name`` wrapped so that each call adds its seconds (the
    card synchronised around it) and the bytes this rank hands to the
    mesh's collectives during it (``collective_bytes``, counted at each
    collective) to ``sink[key + "_s"]`` / ``sink[key + "_bytes"]``;
    returns the original, to put back."""
    import torch

    from loghisto_tpu_torch.parallel.mesh import collective_bytes

    orig = getattr(module, name)

    def counted(*a, **kw):
        torch.cuda.synchronize()
        sent, t0 = collective_bytes(), time.perf_counter()
        try:
            return orig(*a, **kw)
        finally:
            torch.cuda.synchronize()
            sink[key + "_s"] = time.perf_counter() - t0
            sink[key + "_bytes"] = collective_bytes() - sent

    setattr(module, name, counted)
    return orig


def _mf_lines(path):
    try:
        with open(path, "rb") as f:
            return f.read().count(b"\n")
    except OSError:
        return 0


def _mf_crash(torch, d, mesh=None, rows=MF_ROWS, crash=True):
    """MF_CRASH intervals of ``rows`` driven by hand through the system's
    subscribers (the row's journal, the committer); its figures.  With
    ``crash`` the system is then left as a killed process leaves it: its
    journal closed, no stop(), no final checkpoint."""
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )

    from loghisto_tpu_torch.utils import checkpoint

    ms = _mf_system(d, mesh)
    if ms.commit_path != "fused":
        raise AssertionError(f"part (f) resolved {ms.commit_path}")
    figures = {}
    save = _mf_counted(checkpoint, "save", figures, "save")
    try:
        ms.recovery.start()
        journal = ms.recovery._journal
        ms._update_subscribers()
        reset_kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(MF_CRASH):
            with ms._subscribers_lock:
                ms._broadcast(ms._raw_subscribers, _mf_raw(k, rows))
        end = time.monotonic() + 120.0
        # the journal's lines are counted only once the commits are in,
        # so the poll does not hold the interpreter from the bridge thread
        while ((ms.committer.intervals_committed if mesh is None
                else ms.committer.queued_intervals) < MF_CRASH
               or (journal is not None
                   and _mf_lines(journal.path) < MF_CRASH)):
            if time.monotonic() > end:
                raise AssertionError("part (f): the intervals were not "
                                     "committed or queued, and journaled")
            time.sleep(0.05)
        if mesh is not None:
            ms.committer.drain()  # D9: the collective commit
        torch.cuda.synchronize()
    finally:
        checkpoint.save = save
    drive_s = time.perf_counter() - t0
    rec = ms.recovery
    if (ms.committer.intervals_committed, rec.checkpoints_taken,
            rec.last_checkpoint_seq) != (MF_CRASH, 1, MF_EVERY):
        raise AssertionError(
            f"part (f): {ms.committer.intervals_committed} committed, "
            f"{rec.checkpoints_taken} checkpoints at "
            f"{rec.last_checkpoint_seq}")
    figures |= {
        "drive_s": drive_s, "save_ms": rec.checkpoint_last_ms,
        "checkpoint_file_bytes": os.path.getsize(rec.checkpoint_path),
        "journal": None if journal is None
        else os.path.basename(journal.path),
        "journal_bytes": 0 if journal is None
        else os.path.getsize(journal.path),
        "launches": {k: v for k, v in kernel_launches().items() if v}}
    if crash:
        if journal is not None:
            journal.stop()
        ms.committer.detach()
        ms.aggregator.close()
        del ms
        gc.collect()
        torch.cuda.empty_cache()
    return figures


def _mf_counts():
    """The uncrashed oracle's collected counts, from the merged intervals'
    cells on the host: per steady name, and in all."""
    per = np.zeros(ML_STEADY, np.int64)
    total = 0
    for k in range(MF_CRASH + MF_AFTER):
        for s in MF_ROWS:
            c = _ml_cells(k, s)
            steady = c[:, 0] < ML_STEADY
            per += np.bincount(c[steady, 0], weights=c[steady, 2],
                               minlength=ML_STEADY).astype(np.int64)
            total += int(c[:, 2].sum())
    return per, total


def _mf_recover(torch, d, mesh=None, rows=MF_ROWS, blocks=(1,),
                final=False):
    """A fresh system recovers from ``d``'s files (``recover()`` and the
    restore inside it timed, the replay's launches counted), takes
    MF_AFTER intervals of ``rows``, and reports part (e)'s state per
    ``blocks``, its collected counts and, with ``final``, its stop()'s
    checkpoint (a collective on a mesh)."""
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )
    from loghisto_tpu_torch.utils import checkpoint

    ms = _mf_system(d, mesh)
    times = {}
    restore = _mf_counted(checkpoint, "restore", times, "restore")
    save = _mf_counted(checkpoint, "save", times, "final_save")
    try:
        reset_kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = ms.recover()
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
        replay = {k: v for k, v in kernel_launches().items() if v}
        if (rep.watermark, rep.replayed_intervals) != (
                MF_EVERY, MF_CRASH - MF_EVERY):
            raise AssertionError(f"part (f): recovered {rep}")
        for kernel in ("sparse_ingest", "window_merge", "divergence"):
            if replay.get(kernel, 0) <= 0:
                raise AssertionError(f"{kernel} not launched in the replay")
        ms.backfill_retention([_mf_raw(k, rows) for k in range(
            MF_CRASH, MF_CRASH + MF_AFTER)])
        states = {b: _ml_state(torch, ms, b) for b in blocks}
        counts = {k: v for k, v in ms.device_metrics(
            reset=False).metrics.items()
            if k.endswith("_count") and not k.endswith("_agg_count")}
        out = {"recover_s": recover_s, **times,
               "replayed": rep.replayed_intervals,
               "skipped_lines": rep.skipped_intervals,
               "replay_launches": replay, "states": states,
               "counts": counts}
        if not final:
            ms.recovery.checkpoint_path = None  # no stop() checkpoint
    finally:
        checkpoint.restore = restore
        try:
            ms.stop()
        finally:
            checkpoint.save = save
    if final:
        out["final_save_s"] = times["final_save_s"]
        out["final_save_bytes"] = times["final_save_bytes"]
        if ms.recovery.checkpoints_taken != 1:
            raise AssertionError("part (f): stop() took no checkpoint")
    del ms
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mf_check(got, oracle, counts, block, blocks, what):
    """One recovered rank against the single-device recovered oracle
    (part (e)'s digests and score tolerance) and its collected counts
    against the uncrashed oracle's."""
    states = {int(b): v for b, v in oracle["states"].items()}
    mine = {int(b): v for b, v in got["states"].items()}
    _ml_check({"state": mine[1]}, states, block, blocks, what)
    per, total = counts
    got_counts = got["counts"]
    for i in range(ML_STEADY):
        if got_counts.get(f"svc.{i}.latency_count") != per[i]:
            raise AssertionError(f"{what}: svc.{i}.latency's count differs "
                                 "from the uncrashed oracle's")
    if int(sum(got_counts.values())) != total:
        raise AssertionError(f"{what}: {int(sum(got_counts.values()))} "
                             f"samples collected, the oracle's {total}")
    return {k: v for k, v in got.items() if k not in ("states", "counts")}


def _mf_child(argv):
    """One gloo rank of part (f): ``crash`` on (2, 1) (drive, report, then
    wait for the parent's SIGKILL) or ``recover`` on (1, 2).  It starts
    early and waits for the parent's go file, so its start overlaps the
    parent's earlier work."""
    mode, rank, d = argv[0], int(argv[1]), argv[2]
    import torch

    from loghisto_tpu_torch.parallel import multihost
    from loghisto_tpu_torch.parallel.mesh import (
        STREAM_AXIS,
        axis_index,
        make_mesh,
    )

    torch.zeros(1, device="cuda")  # the context, before the gate
    go, end = os.path.join(d, f"go-{mode}"), time.monotonic() + MF_DEADLINE_S
    while not os.path.exists(go):  # the parent releases the ranks
        if time.monotonic() > end:
            return 3
        time.sleep(0.02)
    multihost.initialize(f"file://{d}/rdzv-{mode}", 2, rank, device="cuda",
                         backend="gloo", timeout_s=120.0)
    if mode == "crash":
        mesh = make_mesh(2, 1)
        out = _mf_crash(torch, d, mesh, rows=(axis_index(mesh, STREAM_AXIS),),
                        crash=False)
    else:
        out = _mf_recover(torch, d, make_mesh(1, 2), blocks=(1,),
                          final=True)
    path = os.path.join(d, f"{mode}-{rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)
    if mode == "crash":
        while True:  # the state a crash finds: the parent SIGKILLs us
            time.sleep(1.0)
    multihost.shutdown()
    return 0


def _mf_spawn(mode, d, root):
    """Part (f)'s two gloo ranks of ``mode``, started; they wait for
    ``_mf_reports``."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; "
            "sys.exit(chip_smoke._mf_child(sys.argv[2:]))")
    return [subprocess.Popen(
        [sys.executable, "-c", code, root, mode, str(r), d],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]


def _mf_reports(procs, mode, d):
    """Release the ranks of ``mode`` and wait for their reports; a
    crash's ranks are SIGKILLed once both reported."""
    import signal

    open(os.path.join(d, f"go-{mode}"), "w").close()
    paths = [os.path.join(d, f"{mode}-{r}.json") for r in range(2)]
    end = time.monotonic() + MF_DEADLINE_S
    while not all(os.path.exists(p) for p in paths):
        failed = [p for p in procs if p.poll() not in (None, 0)]
        if failed or time.monotonic() > end:
            err = failed[0].communicate()[1] if failed else "deadline"
            raise AssertionError(f"part (f) {mode} rank failed: "
                                 f"{err[-3000:]}")
        time.sleep(0.05)
    if mode == "crash":
        for p in procs:
            p.send_signal(signal.SIGKILL)
    for p in procs:
        p.communicate(timeout=60.0)
        if mode != "crash" and p.returncode != 0:
            raise AssertionError(f"part (f) {mode} rank exit "
                                 f"{p.returncode}")
    reports = []
    for p in paths:
        with open(p) as f:
            reports.append(json.load(f))
    return reports


def _mf_part(torch, tmp, root):
    """Part (f) of mesh_main_path (the parent is outside any process
    group on entry and on return)."""
    import shutil

    from loghisto_tpu_torch.parallel import multihost
    from loghisto_tpu_torch.parallel.mesh import make_mesh

    out, t = {}, time.perf_counter()
    counts = _mf_counts()
    dirs = {k: os.path.join(tmp, f"f-{k}") for k in ("oracle", "mesh",
                                                     "1x1")}
    for path in dirs.values():
        os.makedirs(path)
    procs = _mf_spawn("crash", dirs["mesh"], root)
    try:
        out["oracle_crash"] = _mf_crash(torch, dirs["oracle"])
        oracle = _mf_recover(torch, dirs["oracle"], blocks=(1, 2))
        out["oracle_recover"] = _mf_check(oracle, oracle, counts, 0, 1,
                                          "the oracle")
        out["oracle_s"] = time.perf_counter() - t
        t = time.perf_counter()
        crash, procs = procs, procs + _mf_spawn("recover", dirs["mesh"],
                                                root)
        out["crash_2x1"] = _mf_reports(crash, "crash", dirs["mesh"])
        keep = os.path.join(dirs["mesh"], "crash")
        os.makedirs(keep)
        for name in ("ck.npz", "jl.log.row0of2", "jl.log.row1of2"):
            shutil.copy(os.path.join(dirs["mesh"], name), keep)
        recovered = _mf_reports(procs[2:], "recover", dirs["mesh"])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out["recover_1x2"] = [
        _mf_check(r, oracle, counts, rank, 2, f"1x2 recovery rank {rank}")
        for rank, r in enumerate(recovered)]
    out["gloo_s"] = time.perf_counter() - t
    t = time.perf_counter()
    multihost.initialize(f"file://{tmp}/rdzv-f", 1, 0, timeout_s=120.0)
    try:
        mesh = make_mesh(1, 1)
        out["crash_1x1"] = _mf_crash(torch, dirs["1x1"], mesh)
        one = _mf_recover(torch, dirs["1x1"], mesh)
        out["recover_1x1"] = _mf_check(one, oracle, counts, 0, 1,
                                       "1x1 recovery")
    finally:
        multihost.shutdown()
    single = _mf_recover(torch, keep)
    out["recover_single_from_2x1"] = _mf_check(
        single, oracle, counts, 0, 1, "one device from the 2x1 files")
    out["nccl_and_single_s"] = time.perf_counter() - t
    for kernel in ("sparse_ingest", "window_merge", "divergence",
                   "compact_rows"):
        entry = RESULTS.setdefault(kernel, {})
        entry["launches"] = (entry.get("launches", 0)
                             + one["replay_launches"].get(kernel, 0))
        entry.setdefault("recovery_launches_per_rank", {}).update({
            "1x1": [one["replay_launches"].get(kernel, 0)],
            "1x2": [r["replay_launches"].get(kernel, 0)
                    for r in recovered]})
    return out


# (g) paged storage on the mesh (ROADMAP D12, item 11c-1): paged_lifecycle_
# main_path's sizes (PL_M rows, a PL_POOL-page arena a shard, 1 GiB a rank,
# PL_TIERS) through TorchMetricSystem(mesh=, storage="paged"), MP_INTERVALS
# intervals of PL_SAMPLES Zipf(1.3) / lognormal samples a stream row, and
# TorchAggregator(mesh=, storage="paged") on the raw (K4f) and sparse (K4)
# transports, MP_AGG_BATCHES batches of MP_AGG_BATCH samples a row; on the
# (1, 1) world and on both meshes of the two gloo ranks, against the
# single-device store fed the merged intervals and the global batches.
MP_INTERVALS = 3
MP_AGG_BATCH = 1 << 16
MP_AGG_BATCHES = PL_SAMPLES // MP_AGG_BATCH
MP_QUERIES = ("mp12*", "mp3")
MP_SAMPLED = np.unique(np.concatenate([
    np.arange(PL_SAMPLED // 2),
    np.linspace(0, PL_M - 1, PL_SAMPLED // 2).astype(np.int64)]))
MP_KERNELS = ("paged_scatter", "fused_paged_ingest", "sparse_ingest",
              "window_merge")


def _mp_names():
    return [f"mp{i}" for i in range(PL_M)]


def _mp_raw(k, rows):
    """Interval k of the stream rows ``rows``: each row's PL_SAMPLES
    samples (its own seed), as the rows' intervals merged in row order
    (``merge_raw_metric_sets``), seq k + 1."""
    from loghisto_tpu_torch.metrics import RawMetricSet, merge_raw_metric_sets
    from loghisto_tpu_torch.ops.fold import compress_np_host

    merged = None
    for s in rows:
        rng = np.random.default_rng([SEED, 80, k, s])
        ids = zipf_ids(rng, PL_SAMPLES, PL_M).astype(np.int64)
        buckets = np.clip(compress_np_host(lognormal_values(
            rng, PL_SAMPLES)), -BL, BL).astype(np.int64)
        uniq, first, counts = np.unique(ids * PL_KEY + buckets + BL,
                                        return_index=True,
                                        return_counts=True)
        # in order of first appearance, as a host MetricSystem's dicts
        order = np.argsort(first, kind="stable")
        uniq, counts = uniq[order], counts[order]
        hists = {}
        for key, c in zip(uniq.tolist(), counts.tolist()):
            hists.setdefault(f"mp{key // PL_KEY}", {})[
                key % PL_KEY - BL] = c
        raw = RawMetricSet(time=_dt.datetime(2026, 1, 1,
                                             tzinfo=_dt.timezone.utc)
                           + k * _ONE_SECOND, counters={}, rates={},
                           histograms=hists, gauges={}, duration=1.0,
                           seq=k + 1)
        merged = raw if merged is None else merge_raw_metric_sets(merged,
                                                                  raw)
    return merged


def _mp_batch(k, s):
    """Row s's aggregator batch k."""
    rng = np.random.default_rng([SEED, 81, k, s])
    return (zipf_ids(rng, MP_AGG_BATCH, PL_M),
            lognormal_values(rng, MP_AGG_BATCH))


def _mp_system(mesh=None):
    from loghisto_tpu_torch import TorchMetricSystem
    from loghisto_tpu_torch.paging import PagedStoreConfig

    ms = TorchMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=PL_M, storage="paged",
        paged_config=PagedStoreConfig(pool_pages=PL_POOL),
        retention=PL_TIERS, mesh=mesh)
    for name in _mp_names():
        ms.metric_id(name)
    return ms


def _mp_aggregator(transport, batch, mesh=None):
    from loghisto_tpu_torch.paging import PagedStoreConfig
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    agg = TorchAggregator(
        num_metrics=PL_M, storage="paged", transport=transport,
        paged_config=PagedStoreConfig(pool_pages=PL_POOL), batch_size=batch,
        max_metrics=PL_M, mesh=mesh)
    for name in _mp_names():
        agg.registry.id_for(name)
    return agg


def _mp_host_digest(store):
    """sha256 of the host half: page table, codecs, every free list."""
    import hashlib

    h = hashlib.sha256(store.page_table.tobytes())
    h.update(store.row_codec.tobytes())
    for f in store.free_lists():
        h.update(np.asarray(f, np.int32).tobytes())
    return h.hexdigest()


def _mp_store_figures(torch, store):
    """The store's digests and its block's sampled rows' decoded cells
    (sorted row * B + dense bucket keys and counts)."""
    rows = MP_SAMPLED[store._in_block(MP_SAMPLED)]
    r, idx, counts = store._row_cells(rows)
    keys, cnt = _pl_sum_keys(r * B + idx, counts)
    return {"host": _mp_host_digest(store), "arena": _ms_digest(store._pool),
            "sampled_keys": keys.tolist(), "sampled_counts": cnt.tolist(),
            "occupancy": store.shard_occupancy(),
            "allocated": int(store.allocated_pages),
            "block": [store._row0, store.rows_per_shard]}


def _mp_served(ms):
    return {q: {n: e for n, e in sorted(
        ms.query(q, percentiles=PL_PS).metrics.items())} for q in MP_QUERIES}


def _mp_kernels_equal_plain(torch, store, rng):
    """K4 and K4f on the rank's arena against their plain versions on
    the same inputs (clones of the arena): translated triples over its
    mapped pages, and a Zipf batch of its block's rows.  Returns the
    largest absolute difference (0 required)."""
    from loghisto_tpu_torch.ops.fused_ingest import (
        fused_paged_ingest_batch,
        fused_paged_ingest_reference,
    )
    from loghisto_tpu_torch.ops.paged_store import (
        paged_scatter,
        paged_scatter_batch,
    )

    dev = store.device
    block = store.page_table[store._row0:store._row0 + store.rows_per_shard]
    # the block's rows map pages of the rank's arena: its slots
    slots = block[block >= 0] - store._shard * store.shard_pages
    n = 1 << 20
    trip = np.empty((n, 3), np.int32)
    trip[:, 0] = rng.choice(slots, n)
    trip[:, 1] = rng.integers(0, 256, n)
    trip[:, 2] = rng.integers(1, 100, n)
    trip = torch.from_numpy(trip).to(dev)
    err = 0
    a, p = store._pool.clone(), store._pool.clone()
    paged_scatter(a, trip)
    paged_scatter_batch(p, trip)
    err = max(err, int((a - p).abs().max()))
    del a, p
    # the block's local ids (what ingest_raw hands K4f on a mesh)
    ids = torch.from_numpy(zipf_ids(rng, n, store.rows_per_shard)).to(dev)
    vals = torch.from_numpy(lognormal_values(rng, n)).to(dev)
    luts = store.device_luts()
    a, p = store._pool.clone(), store._pool.clone()
    fused_paged_ingest_batch(a, ids, vals, *luts, BL)
    fused_paged_ingest_reference(p, ids, vals, *luts, BL)
    err = max(err, int((a - p).abs().max()))
    del a, p
    torch.cuda.synchronize()
    return err


def _mp_timed(module, name, sink, key):
    """``module.name`` wrapped so that each call ADDS its seconds (the
    card synchronised around it) to ``sink[key]``; returns the original,
    to put back."""
    import torch

    orig = getattr(module, name)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return orig(*a, **kw)
        finally:
            torch.cuda.synchronize()
            sink[key] = sink.get(key, 0.0) + time.perf_counter() - t0

    setattr(module, name, timed)
    return orig


def _mp_run(torch, mesh, rows):
    """Part (g) on one rank (or one device, ``mesh`` None, ``rows`` the
    stream rows it takes merged): the system's MP_INTERVALS intervals
    and the aggregator's raw and sparse runs, with the kernel counts set
    to 0 before and read after; each store's figures, the served
    queries, the collected sets' digests, the seconds of the gathers and
    the translates, the bytes this rank sent and K4 / K4f against their
    plain versions."""
    import hashlib

    from loghisto_tpu_torch import commit as commit_mod
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )
    from loghisto_tpu_torch.paging import PagedStore
    from loghisto_tpu_torch.parallel import aggregator as agg_mod
    from loghisto_tpu_torch.parallel import mesh as mesh_mod
    from loghisto_tpu_torch.parallel.mesh import (
        collective_bytes,
        reset_collective_bytes,
    )

    times: dict = {}
    wrapped = [(mod, name, _mp_timed(mod, name, times, key))
               for mod, name, key in (
                   (commit_mod, "all_gather_objects", "gather_s"),
                   (mesh_mod, "gather_rows", "gather_s"),
                   (agg_mod, "gather_parts", "gather_s"),
                   (PagedStore, "translate", "translate_s"),
                   (PagedStore, "prepare_batch", "translate_s"))]
    # a failed commit step or aggregator launch recovers (D6, the exact
    # host spill) and would hide here: count every call of either handler
    failures = []
    for cls, name in ((commit_mod.IntervalCommitter,
                       "_on_fused_failure_locked"),
                      (agg_mod.TorchAggregator, "_on_device_failure_locked")):
        def failed(self, *a, _orig=getattr(cls, name), _name=name, **kw):
            failures.append(f"{_name}: {sys.exc_info()[1]!r}")
            return _orig(self, *a, **kw)

        wrapped.append((cls, name, getattr(cls, name)))
        setattr(cls, name, failed)
    # the card is shared with the other rank: give back what earlier parts
    # left in this process's cache first
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"rows": list(rows),
           "free_gb_at_start": torch.cuda.mem_get_info()[0] / 2**30}
    launched = collections.Counter()
    try:
        reset_collective_bytes()
        ms = _mp_system(mesh)
        try:
            raws = [_mp_raw(k, rows) for k in range(MP_INTERVALS)] \
                if mesh is None else \
                [_mp_raw(k, (mesh.get_coordinate()[0],))
                 for k in range(MP_INTERVALS)]
            torch.cuda.synchronize()
            reset_kernel_launches()
            t0 = time.perf_counter()
            ms.backfill_retention(raws)
            served = _mp_served(ms)
            torch.cuda.synchronize()
            out["system_s"] = time.perf_counter() - t0
            launched.update(kernel_launches())
            if ms.committer.fused_intervals != MP_INTERVALS:
                raise AssertionError("part (g) did not commit fused")
            out["system"] = _mp_store_figures(torch, ms.aggregator.paged)
            out["served"] = served
            out["query_fallbacks"] = ms.retention.query_fallbacks
            out["max_abs_err"] = _mp_kernels_equal_plain(
                torch, ms.aggregator.paged,
                np.random.default_rng([SEED, 82]))
        finally:
            _drop_system(torch, ms)
        batch = MP_AGG_BATCH * (len(rows) if mesh is None else 1)
        for transport in ("raw", "sparse"):
            agg = _mp_aggregator(transport, batch, mesh)
            try:
                torch.cuda.synchronize()
                reset_kernel_launches()
                t0 = time.perf_counter()
                for k in range(MP_AGG_BATCHES):
                    if mesh is None:
                        parts = [_mp_batch(k, s) for s in rows]
                        agg.record_batch(np.concatenate([i for i, _ in parts]),
                                         np.concatenate([v for _, v in parts]))
                        agg.flush(force=True)
                    else:
                        agg.record_batch(*_mp_batch(
                            k, mesh.get_coordinate()[0]))
                metrics = agg.collect().metrics
                torch.cuda.synchronize()
                out[f"{transport}_s"] = time.perf_counter() - t0
                launched.update(kernel_launches())
                out[transport] = hashlib.sha256(json.dumps(
                    metrics, sort_keys=True).encode()).hexdigest()
                out[f"{transport}_path"] = agg.ingest_path
                out[f"{transport}_host"] = _mp_host_digest(agg.paged)
                if agg.paged._n_shards == 1:  # compared with one device's
                    out[f"{transport}_arena"] = _ms_digest(agg.paged._pool)
            finally:
                agg.close()
                agg.paged._pool = None
                gc.collect()
                torch.cuda.empty_cache()
        out["sent_bytes"] = collective_bytes()
    finally:
        for mod, name, orig in wrapped:
            setattr(mod, name, orig)
    out.update(times)
    out["failures"] = failures
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    out["launches"] = {k: launched[k] for k in MP_KERNELS}
    return out


def _mp_oracles(torch):
    """Part (g)'s single-device runs on the card: for (2, 1) stream rows
    0 and 1 merged, for (1, 1) and (1, 2) row 0."""
    return {rows: _mp_run(torch, None, rows) for rows in ((0, 1), (0,))}


def _mp_check(got, oracle, n_metric, what):
    """A rank's part (g) against the single-device oracle: the sampled
    rows of its block, the served queries and the collected sets always;
    the arenas and the host halves (the system's, the raw and the sparse
    aggregator's) where the mesh has one metric shard (its arena is then
    the single-device pool); K4 and K4f equal their plain versions; no
    failure handler called; the path's four kernels launched."""
    sys_got, sys_want = got["system"], oracle["system"]
    keys = np.asarray(sys_got["sampled_keys"], np.int64)
    mine = np.isin(keys // B, MP_SAMPLED)
    want_keys = np.asarray(sys_want["sampled_keys"], np.int64)
    if n_metric == 1:
        for key in ("host", "arena"):
            if sys_got[key] != sys_want[key]:
                raise AssertionError(f"{what}: the {key} digest differs "
                                     "from one device's")
        for transport in ("raw", "sparse"):
            for key in ("host", "arena"):
                if (got[f"{transport}_{key}"]
                        != oracle[f"{transport}_{key}"]):
                    raise AssertionError(f"{what}: {transport} {key} "
                                         "digest differs from one "
                                         "device's")
    lo, n = sys_got["block"]
    sel = (want_keys // B >= lo) & (want_keys // B < lo + n)
    if not (mine.all() and len(keys) and
            np.array_equal(keys, want_keys[sel]) and
            sys_got["sampled_counts"] == np.asarray(
                sys_want["sampled_counts"])[sel].tolist()):
        raise AssertionError(f"{what}: the sampled rows differ")
    for q in MP_QUERIES:
        _mc_same_served(got["served"][q], oracle["served"][q],
                        f"{what} query {q}")
    for transport in ("raw", "sparse"):
        if got[transport] != oracle[transport]:
            raise AssertionError(f"{what}: the {transport} collected set "
                                 "differs from one device's")
    if got["max_abs_err"] != 0:
        raise AssertionError(f"{what}: K4 or K4f differs from its plain "
                             "version")
    if got["failures"] or got["query_fallbacks"]:
        raise AssertionError(f"{what}: failed steps or launches "
                             f"{got['failures'][:2]}, query fallbacks "
                             f"{got['query_fallbacks']}")
    for kernel in MP_KERNELS:
        if got["launches"][kernel] <= 0:
            raise AssertionError(f"{what}: {kernel} was not launched")
    if got["raw_path"] != "fused_paged" or got["sparse_path"] != "packed":
        raise AssertionError(f"{what}: paths {got['raw_path']}, "
                             f"{got['sparse_path']}")
    return {k: got[k] for k in ("launches", "system_s", "raw_s", "sparse_s",
                                "sent_bytes", "gather_s", "translate_s",
                                "max_abs_err", "peak_gb", "free_gb_at_start")
            if k in got} | {
        "occupancy": sys_got["occupancy"]}


# (h) lifecycle, checkpoints and recovery on the paged mesh (ROADMAP D13):
# part (g)'s generator and width (bucket_limit 4096, PL_TIERS) at a quarter
# of its depth, MH_M rows and an arena scaled with them (two (2, 1) ranks
# share the one card, and K6 copies a ring block while it repacks), through
# TorchMetricSystem(mesh=, storage="paged", lifecycle=, resilience=):
# MH_INTERVALS intervals of MH_SAMPLES Zipf(1.3) / lognormal samples a
# stream row, after MH_BEFORE of them an eviction across shards into new
# overflow rows, a compaction and a recorded batch (K4f).  The (2, 1) ranks
# then save, and their save restores onto (1, 2) and onto one device; the
# (1, 1) rank checkpoints at MH_EVERY and recovers from that checkpoint and
# its journal.
MH_M = 1 << 14
MH_POOL = PL_POOL >> 2
MH_NAMES = MH_M - 64  # room for the overflow rows
MH_SAMPLES = 1 << 18
MH_INTERVALS = 5
MH_BEFORE = 2
MH_EVERY = 3  # the recovering run's cadence: the watermark stands at 3
MH_RECORD = 1 << 15  # a row's recorded samples: the rows' batch is one
MH_VICTIMS = (100, 2000, 4000, 6000, 9000, 11000, 13000, 15000)
MH_WINDOW = 2.0  # the served window the recovered wheel holds whole
MH_QUERIES = ("mh12*", "mh3")
MH_SAMPLED = np.unique(np.concatenate([
    np.arange(128), np.linspace(0, MH_M - 1, 128).astype(np.int64),
    np.asarray(MH_VICTIMS)]))
MH_KERNELS = ("paged_scatter", "fused_paged_ingest", "sparse_ingest",
              "window_merge", "compact_rows")


def _mh_raw(k, rows):
    """Interval k of the stream rows ``rows``: each row's MH_SAMPLES
    samples, the rows' intervals merged in row order, seq k + 1."""
    from loghisto_tpu_torch.metrics import RawMetricSet, merge_raw_metric_sets
    from loghisto_tpu_torch.ops.fold import compress_np_host

    merged = None
    for s in rows:
        rng = np.random.default_rng([SEED, 90, k, s])
        ids = zipf_ids(rng, MH_SAMPLES, MH_NAMES).astype(np.int64)
        buckets = np.clip(compress_np_host(lognormal_values(
            rng, MH_SAMPLES)), -BL, BL).astype(np.int64)
        uniq, first, counts = np.unique(ids * PL_KEY + buckets + BL,
                                        return_index=True,
                                        return_counts=True)
        order = np.argsort(first, kind="stable")
        hists = {}
        for key, c in zip(uniq[order].tolist(), counts[order].tolist()):
            hists.setdefault(f"mh{key // PL_KEY}", {})[
                key % PL_KEY - BL] = c
        raw = RawMetricSet(time=_dt.datetime(2026, 1, 1,
                                             tzinfo=_dt.timezone.utc)
                           + k * _ONE_SECOND, counters={}, rates={},
                           histograms=hists, gauges={}, duration=1.0,
                           seq=k + 1)
        merged = raw if merged is None else merge_raw_metric_sets(merged,
                                                                  raw)
    return merged


def _mh_record(rows):
    """The recorded batch of the stream rows ``rows``, concatenated."""
    parts = []
    for s in rows:
        rng = np.random.default_rng([SEED, 91, s])
        parts.append((zipf_ids(rng, MH_RECORD, MH_NAMES),
                      lognormal_values(rng, MH_RECORD)))
    return (np.concatenate([i for i, _ in parts]),
            np.concatenate([v for _, v in parts]))


def _mh_system(d, mesh=None, every=10 ** 6, names=True):
    from loghisto_tpu_torch import TorchMetricSystem
    from loghisto_tpu_torch.lifecycle import LifecycleConfig
    from loghisto_tpu_torch.paging import PagedStoreConfig
    from loghisto_tpu_torch.resilience import ResilienceConfig

    ms = TorchMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=MH_M, storage="paged",
        paged_config=PagedStoreConfig(pool_pages=MH_POOL),
        retention=PL_TIERS, mesh=mesh,
        lifecycle=LifecycleConfig(check_every=1,
                                  auto_compact_fragmentation=0.0),
        resilience=ResilienceConfig(
            checkpoint_path=os.path.join(d, "ck.npz"),
            journal_path=os.path.join(d, "jl.log"),
            checkpoint_every_intervals=every, recover_on_start=False))
    for i in range(MH_NAMES if names else 0):
        ms.metric_id(f"mh{i}")
    # the windowed query is served from the commit's snapshot views
    ms.retention.pin_window(MH_WINDOW)
    return ms


def _mh_feed(ms, mesh, rows, lo, hi):
    """Intervals [lo, hi) of ``rows`` broadcast to the system's
    subscribers (the row's journal, the committer), then committed: by
    the bridge on one device, by one collective drain on a mesh."""
    journal = ms.recovery._journal
    for k in range(lo, hi):
        with ms._subscribers_lock:
            ms._broadcast(ms._raw_subscribers, _mh_raw(k, rows))
    end = time.monotonic() + 120.0
    while ((ms.committer.intervals_committed if mesh is None
            else ms.committer.queued_intervals + lo) < hi
           or (journal is not None and _mf_lines(journal.path) < hi)):
        if time.monotonic() > end:
            raise AssertionError("part (h): the intervals were not "
                                 "committed or queued, and journaled")
        time.sleep(0.05)
    if mesh is not None:
        ms.committer.drain()


def _mh_figures(store):
    """A paged store's host digest, arena digest and the decoded cells
    of its block's sampled rows."""
    rows = MH_SAMPLED[store._in_block(MH_SAMPLED)]
    r, idx, counts = store._row_cells(rows)
    keys, cnt = _pl_sum_keys(r * B + idx, counts)
    return {"host": _mp_host_digest(store), "arena": _ms_digest(store._pool),
            "sampled_keys": keys.tolist(), "sampled_counts": cnt.tolist(),
            "block": [store._row0, store.rows_per_shard],
            "occupancy": store.shard_occupancy()}


def _mh_served(ms):
    return {f"{q}@{w}": {n: e for n, e in sorted(ms.query(
        q, window=w, percentiles=PL_PS).metrics.items())}
        for q in MH_QUERIES for w in (None, MH_WINDOW)}


def _mh_ring_kernels(torch, wheel, rng):
    """K6 and K5 on the rank's tier-1 ring block against their plain
    versions on the same input: a permutation with holes, a slot mask.
    Returns the largest absolute difference (0 required)."""
    from loghisto_tpu_torch.ops.lifecycle import (
        compact_rows,
        compact_rows_kernel,
    )
    from loghisto_tpu_torch.ops.window import (
        window_merge,
        window_merge_kernel,
    )

    ring = wheel._tiers[1].ring
    perm = _holey_perm(rng, ring.shape[1])
    a = compact_rows_kernel(ring, perm)
    err = int((a - compact_rows(ring, perm)).abs().max())
    del a
    mask = rng.random(ring.shape[0]) < 0.6
    err = max(err, int((window_merge_kernel(ring, mask)
                        - window_merge(ring, mask)).abs().max()))
    torch.cuda.synchronize()
    return err


def _mh_restore(torch, mesh, path):
    """``checkpoint.restore`` of ``path`` onto a fresh paged aggregator
    (a collective on a mesh), timed; the store's figures."""
    from loghisto_tpu_torch.paging import PagedStoreConfig
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.utils import checkpoint

    agg = TorchAggregator(num_metrics=MH_M, storage="paged",
                          paged_config=PagedStoreConfig(pool_pages=MH_POOL),
                          mesh=mesh)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.restore(path, aggregator=agg)
        torch.cuda.synchronize()
        out = {"restore_s": time.perf_counter() - t0}
        out.update(_mh_figures(agg.paged))
    finally:
        agg.close()
        agg.paged._pool = None
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _mh_run(torch, mesh, rows, d, save=None, recover=False):
    """Part (h) on one rank (or one device, ``mesh`` None, ``rows`` the
    stream rows it takes merged), its files in ``d``: the system's
    intervals, eviction, compaction and recorded batch with the kernel
    counts set to 0 before and read after; the store's figures, the
    served queries, K4 / K4f / K6 / K5 against their plain versions;
    with ``save`` a save there; the system then dropped with no final
    checkpoint; with ``recover`` a fresh system recovers from the
    cadence checkpoint and the journal (launches counted apart)."""
    from loghisto_tpu_torch import commit as commit_mod
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )
    from loghisto_tpu_torch.parallel import aggregator as agg_mod
    from loghisto_tpu_torch.parallel.mesh import (
        collective_bytes,
        reset_collective_bytes,
    )
    from loghisto_tpu_torch.utils import checkpoint

    own = rows if mesh is None else (mesh.get_coordinate()[0],)
    times: dict = {}
    wrapped = [(checkpoint, "restore",
                _mf_counted(checkpoint, "restore", times, "restore"))]
    failures = []
    for cls, name in ((commit_mod.IntervalCommitter,
                       "_on_fused_failure_locked"),
                      (agg_mod.TorchAggregator, "_on_device_failure_locked")):
        def failed(self, *a, _orig=getattr(cls, name), _name=name, **kw):
            failures.append(f"{_name}: {sys.exc_info()[1]!r}")
            return _orig(self, *a, **kw)

        wrapped.append((cls, name, getattr(cls, name)))
        setattr(cls, name, failed)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"rows": list(rows)}
    try:
        reset_collective_bytes()
        ms = _mh_system(d, mesh, MH_EVERY if recover else 10 ** 6)
        try:
            lc = ms.lifecycle
            ms.recovery.start()
            ms._update_subscribers()
            torch.cuda.synchronize()
            reset_kernel_launches()
            t0 = time.perf_counter()
            _mh_feed(ms, mesh, own, 0, MH_BEFORE)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            evicted = lc.evict_ids([ms.aggregator.registry.lookup(f"mh{v}")
                                    for v in MH_VICTIMS])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if not lc.compact():
                raise AssertionError("part (h): the compaction did not run")
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            ms.record_batch(*_mh_record(own))
            if mesh is None:  # a mesh rank's next commit lands it
                ms.aggregator.flush(force=True)
                ms.aggregator.wait_transfers()
            _mh_feed(ms, mesh, own, MH_BEFORE, MH_INTERVALS)
            served = _mh_served(ms)
            torch.cuda.synchronize()
            out |= {"system_s": time.perf_counter() - t0,
                    "evict_s": t2 - t1, "compact_s": t3 - t2,
                    "evicted": len(evicted),
                    "evict_bytes": lc.last_evict_bytes,
                    "compact_bytes": lc.last_compaction_bytes,
                    "moved": lc.overflowed_samples}
            launched = kernel_launches()
            out["launches"] = {k: launched[k] for k in MH_KERNELS}
            if ms.committer.fused_intervals != MH_INTERVALS:
                raise AssertionError("part (h) did not commit fused")
            out["system"] = _mh_figures(ms.aggregator.paged)
            out["served"] = served
            out["query_fallbacks"] = ms.retention.query_fallbacks
            rng = np.random.default_rng([SEED, 92])
            out["max_abs_err"] = max(
                _mp_kernels_equal_plain(torch, ms.aggregator.paged, rng),
                _mh_ring_kernels(torch, ms.retention, rng))
            if save is not None:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                checkpoint.save(save, aggregator=ms.aggregator,
                                lifecycle=lc)
                out["save_s"] = time.perf_counter() - t0
            if recover:
                out["checkpoint"] = [ms.recovery.checkpoints_taken,
                                     ms.recovery.last_checkpoint_seq]
                out["save_s"] = ms.recovery.checkpoint_last_ms / 1e3
        finally:
            ms.recovery.checkpoint_path = None  # a crash: no final save
            _drop_system(torch, ms)
        if recover:
            # the names come back from the checkpoint, in its order
            ms = _mh_system(d, mesh, MH_EVERY, names=False)
            try:
                torch.cuda.synchronize()
                reset_kernel_launches()
                t0 = time.perf_counter()
                rep = ms.recover()
                torch.cuda.synchronize()
                out["recover_s"] = time.perf_counter() - t0
                launched = kernel_launches()
                out["recovery_launches"] = {k: launched[k]
                                            for k in MH_KERNELS}
                if (rep.watermark, rep.replayed_intervals) != (
                        MH_EVERY, MH_INTERVALS - MH_EVERY):
                    raise AssertionError(f"part (h): recovered {rep}")
                out["recovered"] = _mh_figures(ms.aggregator.paged)
                out["recovered_served"] = {
                    q: e for q, e in _mh_served(ms).items()
                    if q.endswith(f"@{MH_WINDOW}")}
            finally:
                ms.recovery.checkpoint_path = None
                _drop_system(torch, ms)
        out["sent_bytes"] = collective_bytes()
    finally:
        for mod, name, orig in wrapped:
            setattr(mod, name, orig)
    out.update(times)
    out["failures"] = failures
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _mh_oracles(torch, tmp):
    """Part (h)'s single-device runs on the card: for (2, 1) stream rows
    0 and 1 merged, for (1, 1) and (1, 2) row 0."""
    out = {}
    for rows in ((0, 1), (0,)):
        d = os.path.join(tmp, "h-one-" + "".join(map(str, rows)))
        os.makedirs(d)
        out[rows] = _mh_run(torch, None, rows, d)
    return out


def _mh_same_rows(got, want, what):
    """A block's sampled rows against the oracle's rows of that block."""
    keys = np.asarray(got["sampled_keys"], np.int64)
    want_keys = np.asarray(want["sampled_keys"], np.int64)
    lo, n = got["block"]
    sel = (want_keys // B >= lo) & (want_keys // B < lo + n)
    if not (len(keys) and np.array_equal(keys, want_keys[sel])
            and got["sampled_counts"] == np.asarray(
                want["sampled_counts"])[sel].tolist()):
        raise AssertionError(f"{what}: the sampled rows differ")


def _mh_check(got, oracle, n_metric, what):
    """A rank's part (h) against the single-device oracle: the sampled
    rows of its block and the served queries always, the arena and the
    host half where the mesh has one metric shard; K4 / K4f / K6 / K5
    equal their plain versions; no failure handler called, no query
    fallback; the path's kernels launched; a recovered rank's sampled
    rows and served window as its uncrashed run's."""
    if n_metric == 1:
        for key in ("host", "arena"):
            if got["system"][key] != oracle["system"][key]:
                raise AssertionError(f"{what}: the {key} digest differs "
                                     "from one device's")
    _mh_same_rows(got["system"], oracle["system"], what)
    for q, want in oracle["served"].items():
        _mc_same_served(got["served"][q], want, f"{what} query {q}")
    if got["max_abs_err"] != 0:
        raise AssertionError(f"{what}: K4, K4f, K6 or K5 differs from its "
                             "plain version")
    if got["failures"] or got["query_fallbacks"]:
        raise AssertionError(f"{what}: failed steps or launches "
                             f"{got['failures'][:2]}, query fallbacks "
                             f"{got['query_fallbacks']}")
    for kernel in MH_KERNELS:
        if got["launches"][kernel] <= 0:
            raise AssertionError(f"{what}: {kernel} was not launched")
    if (got["evicted"], got["moved"]) != (len(MH_VICTIMS), oracle["moved"]):
        raise AssertionError(f"{what}: evicted {got['evicted']}, moved "
                             f"{got['moved']} (one device {oracle['moved']})")
    if "recovered" in got:
        _mh_same_rows(got["recovered"], got["system"], f"{what} recovered")
        for q, want in got["recovered_served"].items():
            _mc_same_served(want, got["served"][q],
                            f"{what} recovered query {q}")
        for kernel in ("paged_scatter", "sparse_ingest", "window_merge"):
            if got["recovery_launches"][kernel] <= 0:
                raise AssertionError(f"{what}: {kernel} not launched in "
                                     "the replay")
    return {k: got[k] for k in (
        "launches", "recovery_launches", "system_s", "evict_s", "compact_s",
        "save_s", "restore_s", "recover_s", "evict_bytes", "compact_bytes",
        "sent_bytes", "max_abs_err", "peak_gb", "checkpoint") if k in got}


def _ms_child(argv):
    """One rank of part (b): both meshes of two ranks, raw and sparse;
    prints one JSON line of digests, times and launches, and writes each
    collected set to ``<tmp>/<shape>-<transport>-<rank>.json``."""
    rank, tmp = int(argv[0]), argv[1]
    import torch
    import torch.distributed as dist

    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )
    from loghisto_tpu_torch.parallel import multihost
    from loghisto_tpu_torch.parallel.mesh import (
        STREAM_AXIS,
        axis_group,
        axis_index,
        make_mesh,
    )

    multihost.initialize(f"file://{tmp}/rdzv", 2, rank, device="cuda",
                         backend="gloo", timeout_s=120.0)
    out = {"rank": rank}
    try:
        for shape in MS_SHAPES:
            mesh = make_mesh(*shape)
            s = axis_index(mesh, STREAM_AXIS)
            batches = [_ms_batch(s * MS_ROW_BATCHES + k)
                       for k in range(MS_ROW_BATCHES)]
            for transport in ("raw", "sparse"):
                key = f"{shape[0]}x{shape[1]}-{transport}"
                agg = _ms_aggregator(mesh, transport)
                try:
                    reset_kernel_launches()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for ids, values in batches:
                        agg.record_batch(ids, values)
                    agg.flush(force=True)
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    launches = kernel_launches()
                    reduced = agg._acc.clone()
                    dist.all_reduce(reduced,
                                    group=axis_group(mesh, STREAM_AXIS))
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    digest = _ms_digest(reduced)
                    del reduced
                    t3 = time.perf_counter()
                    metrics = agg.collect().metrics
                    t4 = time.perf_counter()
                finally:
                    agg.close()
                with open(os.path.join(tmp, f"{key}-{rank}.json"), "w") as f:
                    json.dump(metrics, f)
                out[key] = {
                    "coord": list(mesh.get_coordinate()),
                    "digest": digest, "ingest_s": t1 - t0,
                    "gloo_reduce_ms": (t2 - t1) * 1e3,
                    "collect_ms": (t4 - t3) * 1e3,
                    "transport": agg.transport, "ingest_path":
                        agg.ingest_path,
                    "launches": {k: v for k, v in launches.items() if v}}
            commit = _mc_run(torch, mesh, (s,))
            with open(os.path.join(
                    tmp, f"{shape[0]}x{shape[1]}-commit-{rank}.json"),
                    "w") as f:
                json.dump(commit, f)
            life = _ml_run(torch, mesh, (s,))
            with open(os.path.join(
                    tmp, f"{shape[0]}x{shape[1]}-lifecycle-{rank}.json"),
                    "w") as f:
                json.dump(life, f)
            paged = _mp_run(torch, mesh, (s,))
            with open(os.path.join(
                    tmp, f"{shape[0]}x{shape[1]}-paged-{rank}.json"),
                    "w") as f:
                json.dump(paged, f)
            d = os.path.join(tmp, f"h-{shape[0]}x{shape[1]}")
            os.makedirs(d, exist_ok=True)
            plc = _mh_run(torch, mesh, (s,), d, save=os.path.join(
                d, "final.npz") if shape == (2, 1) else None)
            if shape == (1, 2):  # the (2, 1) ranks' save, restored here
                plc["restored"] = _mh_restore(torch, mesh, os.path.join(
                    tmp, "h-2x1", "final.npz"))
            with open(os.path.join(
                    tmp, f"{shape[0]}x{shape[1]}-plc-{rank}.json"),
                    "w") as f:
                json.dump(plc, f)
    finally:
        multihost.shutdown()
    print(json.dumps(out), flush=True)
    return 0


def _ms_same(got, want, what):
    if got != want:
        diff = sorted(k for k in set(got) | set(want)
                      if got.get(k) != want.get(k))
        raise AssertionError(f"{what}: {len(diff)} keys differ, first "
                             f"{[(k, got.get(k), want.get(k)) for k in diff[:3]]}")


def _ms_world1(torch, batches, acc16, want16):
    """Part (a): the mesh aggregator and the steps at world size 1 under
    NCCL against the oracle; returns the phase's figures."""
    import torch.distributed as dist

    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )
    from loghisto_tpu_torch.parallel.aggregator import (
        make_distributed_step,
        make_interval_distributed_step,
        make_sharded_accumulator,
    )
    from loghisto_tpu_torch.parallel.mesh import (
        STREAM_AXIS,
        axis_group,
        make_mesh,
    )

    mesh = make_mesh(1, 1)
    out = {"backend": dist.get_backend()}
    agg = _ms_aggregator(mesh)
    try:
        reset_kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for ids, values in batches:
            agg.record_batch(ids, values)
        agg.flush(force=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = kernel_launches()
        if launches["fused_ingest"] <= 0:
            raise AssertionError("K1 was not launched on the mesh path")
        if not torch.equal(agg._acc, acc16):
            raise AssertionError("the 1x1 block differs from the oracle")
        # the stream all_reduce of the 328 MB partial, alone
        part = agg._acc.clone()
        group = axis_group(mesh, STREAM_AXIS)
        reduce_ms = time_ms(torch, lambda: dist.all_reduce(part, group=group),
                            reps=5, warmup=1, hold=False)
        del part
        t2 = time.perf_counter()
        metrics = agg.collect().metrics
        t3 = time.perf_counter()
    finally:
        agg.close()
    _ms_same(metrics, want16, "world 1 collect")
    out["aggregator"] = {
        "samples": len(batches) * BATCH, "ingest_s": t1 - t0,
        "samples_per_s": len(batches) * BATCH / (t1 - t0),
        "collect_ms": (t3 - t2) * 1e3, "all_reduce_ms": reduce_ms,
        "all_reduce_bytes": M * B * 4,
        "launches": {k: v for k, v in launches.items() if v}}

    dev = torch.device("cuda")
    steps = [(torch.from_numpy(i).to(dev), torch.from_numpy(v).to(dev))
             for i, v in batches]
    reset_kernel_launches()
    step = make_distributed_step(mesh, M, BL, PS, batch_size=BATCH)
    acc = make_sharded_accumulator(mesh, M, B)
    for ids, values in steps:
        acc, _ = step(acc, ids, values)
    ingest, collect, make_partial = make_interval_distributed_step(
        mesh, M, BL, PS, batch_size=BATCH)
    acc2 = make_sharded_accumulator(mesh, M, B)
    partial = make_partial()
    half = len(steps) // 2
    for ids, values in steps[:half]:
        partial = ingest(partial, ids, values)
    pending = collect.start(acc2, partial)
    fresh = make_partial()  # the second half folds while it is in flight
    for ids, values in steps[half:]:
        fresh = ingest(fresh, ids, values)
    acc2, _ = pending.wait()
    acc2, _, stats = collect(acc2, fresh)
    torch.cuda.synchronize()
    for name, got in (("per-batch step", acc), ("interval step", acc2)):
        if not torch.equal(got, acc16):
            raise AssertionError(f"the {name}'s block differs from the oracle")
    if int(stats["counts"].sum()) != len(batches) * BATCH:
        raise AssertionError("the interval step lost samples")
    out["steps"] = {"ingest_path": step.ingest_path, "launches": {
        k: v for k, v in kernel_launches().items() if v}}
    return mesh, out


def _ms_firehose(torch, mesh):
    """Part (c): run_firehose over the 1x1 mesh, counts conserved, and
    the mesh step's device rate beside the single-device step's."""
    import io

    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.firehose import (
        make_firehose_step,
        make_mesh_firehose_interval_step,
        run_firehose,
        stream_generator,
    )
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )

    cfg = MetricConfig()
    ingest, _, make_partial = make_mesh_firehose_interval_step(
        mesh, M, FH_BATCH, cfg)
    partial, gen = make_partial(), stream_generator(mesh, SEED)
    mesh_ms = time_ms(torch, lambda: ingest(partial, gen), reps=5, warmup=1)
    step = make_firehose_step(M, FH_BATCH, cfg)
    acc = torch.zeros((M, B), dtype=torch.int32, device="cuda")
    gen1 = torch.Generator(device="cuda")
    single_ms = time_ms(torch, lambda: step(acc, gen1), reps=5, warmup=1)
    del partial, acc
    reset_kernel_launches()
    summary = run_firehose(num_metrics=M, batch=FH_BATCH,
                           seconds=MS_FH_SECONDS, interval=0.5, mesh=mesh,
                           out=io.StringIO(), seed=SEED)
    launches = kernel_launches()
    if summary["collected_samples"] != summary["total_samples"]:
        raise AssertionError(f"the mesh firehose lost samples: {summary}")
    if launches["fused_ingest"] <= 0:
        raise AssertionError("K1 was not launched by the mesh firehose")
    return {**summary, "device_samples_per_s": FH_BATCH / mesh_ms * 1e3,
            "single_device_samples_per_s": FH_BATCH / single_ms * 1e3,
            "step_ms": mesh_ms, "single_step_ms": single_ms,
            "launches": {k: v for k, v in launches.items() if v}}


def phase_mesh(torch):
    """The mesh over torch.distributed on the one card: (a) world size 1
    under NCCL, (b) two ranks under gloo, (c) the mesh firehose."""
    import shutil
    import tempfile

    from loghisto_tpu_torch.parallel import multihost

    card = RESULTS["card"]  # nvidia-smi's name and power limit
    tmp = tempfile.mkdtemp(prefix="loghisto-mesh-")
    batches = [_ms_batch(k) for k in range(MS_BATCHES)]
    single = _ms_aggregator()
    try:
        for k, (ids, values) in enumerate(batches):
            single.record_batch(ids, values)
            if k + 1 == MS_ROW_BATCHES:
                single.flush(force=True)
                acc8 = single._acc.clone()
                want8 = single.collect(reset=False).metrics
        single.flush(force=True)
        acc16 = single._acc.clone()
        want16 = single.collect().metrics
    finally:
        single.close()
    rows = M // 2
    want = {  # (shape, transport) -> per rank (digest, collected set)
        "2x1": ([_ms_digest(acc16)] * 2, want16),
        "1x2": ([_ms_digest(acc8[:rows]), _ms_digest(acc8[rows:])], want8),
    }
    out = {"card": card, "batches": MS_BATCHES, "batch": BATCH}
    procs = []
    try:
        t_oracle = time.perf_counter()
        oracles = _mc_oracles(torch)
        out["commit_oracle"] = {
            "s": time.perf_counter() - t_oracle,
            "launches": {str(k): v[2] for k, v in oracles.items()}}
        t_oracle = time.perf_counter()
        ml_oracles = _ml_oracles(torch)
        out["lifecycle_oracle_s"] = time.perf_counter() - t_oracle
        t_oracle = time.perf_counter()
        mp_oracles = _mp_oracles(torch)
        out["paged_oracle"] = {
            "s": time.perf_counter() - t_oracle,
            "launches": {str(k): v["launches"] for k, v in mp_oracles.items()}}
        t_oracle = time.perf_counter()
        mh_oracles = _mh_oracles(torch, tmp)
        out["paged_lifecycle_oracle"] = {
            "s": time.perf_counter() - t_oracle,
            "launches": {str(k): v["launches"] for k, v in mh_oracles.items()},
            **{k: mh_oracles[(0,)][k] for k in (
                "system_s", "evict_s", "compact_s")}}
        multihost.initialize(f"file://{tmp}/rdzv1", 1, 0, timeout_s=120.0)
        try:
            mesh, out["world1"] = _ms_world1(torch, batches, acc16, want16)
            out["firehose"] = _ms_firehose(torch, mesh)
            t_commit = time.perf_counter()
            one = _mc_check(_mc_run(torch, mesh, (0,)), oracles[(0,)], 0, 1,
                            "1x1 commit")
            out["commit_1x1"] = {**one, "s": time.perf_counter() - t_commit}
            for kernel in ("sparse_ingest", "window_merge"):
                RESULTS.setdefault(kernel, {})["launches"] = (
                    RESULTS.get(kernel, {}).get("launches", 0)
                    + one["launches"][kernel])
            t_life = time.perf_counter()
            life = _ml_check(_ml_run(torch, mesh, (0,)), ml_oracles[(0,)], 0,
                             1, "1x1 lifecycle")
            out["lifecycle_1x1"] = {**life, "s": time.perf_counter() - t_life}
            for kernel in ("compact_rows", "divergence"):
                entry = RESULTS.setdefault(kernel, {})
                entry["launches"] = (entry.get("launches", 0)
                                     + life["launches"][kernel])
                entry.setdefault("mesh_launches_per_rank", {})["1x1"] = [
                    life["launches"][kernel]]
            t_paged = time.perf_counter()
            paged = _mp_check(_mp_run(torch, mesh, (0,)), mp_oracles[(0,)],
                              1, "1x1 paged")
            out["paged_1x1"] = {**paged, "s": time.perf_counter() - t_paged}
            # K4 / K4f's "launches" stay paged_main_path's own count
            for kernel in MP_KERNELS:
                entry = RESULTS.setdefault(kernel, {})
                entry.setdefault("mesh_launches_per_rank", {})[
                    "paged 1x1"] = [paged["launches"][kernel]]
            t_plc = time.perf_counter()
            d = os.path.join(tmp, "h-1x1")
            os.makedirs(d)
            plc = _mh_check(_mh_run(torch, mesh, (0,), d, recover=True),
                            mh_oracles[(0,)], 1, "1x1 paged lifecycle")
            out["paged_lifecycle_1x1"] = {**plc,
                                          "s": time.perf_counter() - t_plc}
            for kernel in MH_KERNELS:
                entry = RESULTS.setdefault(kernel, {})
                entry.setdefault("mesh_launches_per_rank", {})[
                    "paged lifecycle 1x1"] = [plc["launches"][kernel]]
                entry.setdefault("recovery_launches_per_rank", {})[
                    "paged 1x1"] = [plc["recovery_launches"][kernel]]
        finally:
            multihost.shutdown()
        del acc8, acc16, batches
        torch.cuda.empty_cache()

        root = os.path.dirname(os.path.abspath(__file__))
        code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "import chip_smoke; "
                "sys.exit(chip_smoke._ms_child(sys.argv[2:]))")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, root, str(r), tmp],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        ranks = []
        for p in procs:
            stdout, stderr = p.communicate(
                timeout=max(1.0, MS_DEADLINE_S - (time.perf_counter() - t0)))
            if p.returncode != 0:
                raise AssertionError(f"a rank failed ({p.returncode}): "
                                     f"{stderr[-3000:]}")
            ranks.append(json.loads(stdout.strip().splitlines()[-1]))
        out["ranks_s"] = time.perf_counter() - t0
        for key, (digests, want_set) in want.items():
            for transport in ("raw", "sparse"):
                for r in ranks:
                    got = r[f"{key}-{transport}"]
                    if got["digest"] != digests[r["rank"]]:
                        raise AssertionError(
                            f"{key} {transport}: rank {r['rank']}'s block "
                            "differs from the oracle's rows")
                    kernel = TRANSPORT_KERNEL[transport]
                    if got["launches"].get(kernel, 0) <= 0:
                        raise AssertionError(
                            f"{key} {transport}: {kernel} not launched")
                    with open(os.path.join(
                            tmp, f"{key}-{transport}-{r['rank']}.json")) as f:
                        _ms_same(json.load(f), want_set,
                                 f"{key} {transport} rank {r['rank']}")
        out["two_ranks"] = {
            f"{key}-{transport}": [r[f"{key}-{transport}"] for r in ranks]
            for key in want for transport in ("raw", "sparse")}
        for shape in MS_SHAPES:
            key = f"{shape[0]}x{shape[1]}"
            stream_rows = (0, 1) if shape[0] == 2 else (0,)
            checked = []
            for r in ranks:
                with open(os.path.join(tmp, f"{key}-commit-{r['rank']}.json")
                          ) as f:
                    got = json.load(f)
                block = r["rank"] if shape[1] == 2 else 0
                checked.append(_mc_check(
                    got, oracles[stream_rows], block, shape[1],
                    f"{key} commit rank {r['rank']}"))
            out[f"commit_{key}"] = checked
            checked = []
            for r in ranks:
                with open(os.path.join(
                        tmp, f"{key}-lifecycle-{r['rank']}.json")) as f:
                    got = json.load(f)
                block = r["rank"] if shape[1] == 2 else 0
                checked.append(_ml_check(
                    got, ml_oracles[stream_rows], block, shape[1],
                    f"{key} lifecycle rank {r['rank']}"))
            if shape[1] == 2 and not any(sum(c["evict_bytes"])
                                         for c in checked):
                raise AssertionError(f"{key}: no victim folded across "
                                     "ranks")
            for kernel in ("compact_rows", "divergence"):
                RESULTS[kernel]["mesh_launches_per_rank"][key] = [
                    c["launches"][kernel] for c in checked]
            out[f"lifecycle_{key}"] = checked
            checked, hosts = [], set()
            for r in ranks:
                with open(os.path.join(
                        tmp, f"{key}-paged-{r['rank']}.json")) as f:
                    got = json.load(f)
                hosts.add((got["system"]["host"], got["raw_host"],
                           got["sparse_host"]))
                checked.append(_mp_check(
                    got, mp_oracles[stream_rows], shape[1],
                    f"{key} paged rank {r['rank']}"))
            if len(hosts) != 1:
                raise AssertionError(f"{key} paged: the ranks' host halves "
                                     "differ")
            for kernel in MP_KERNELS:
                RESULTS[kernel]["mesh_launches_per_rank"][f"paged {key}"] = [
                    c["launches"][kernel] for c in checked]
            out[f"paged_{key}"] = checked
            checked, hosts = [], set()
            for r in ranks:
                with open(os.path.join(
                        tmp, f"{key}-plc-{r['rank']}.json")) as f:
                    got = json.load(f)
                hosts.add(got["system"]["host"])
                one = _mh_check(got, mh_oracles[stream_rows], shape[1],
                                f"{key} paged lifecycle rank {r['rank']}")
                if "restored" in got:
                    _mh_same_rows(got["restored"], mh_oracles[(0, 1)][
                        "system"], f"{key} restored rank {r['rank']}")
                    hosts.add(("restored", got["restored"]["host"]))
                    one["restore_s"] = got["restored"]["restore_s"]
                checked.append(one)
            if len(hosts) != (2 if shape == (1, 2) else 1):
                raise AssertionError(f"{key} paged lifecycle: the ranks' "
                                     "host halves differ")
            if shape[1] == 2 and not any(c["evict_bytes"] for c in checked):
                raise AssertionError(f"{key}: no victim folded across "
                                     "ranks")
            for kernel in MH_KERNELS:
                RESULTS[kernel]["mesh_launches_per_rank"][
                    f"paged lifecycle {key}"] = [
                    c["launches"][kernel] for c in checked]
            out[f"paged_lifecycle_{key}"] = checked
        t_one = time.perf_counter()
        one = _mh_restore(torch, None, os.path.join(tmp, "h-2x1",
                                                    "final.npz"))
        _mh_same_rows(one, mh_oracles[(0, 1)]["system"],
                      "the (2, 1) save on one device")
        out["paged_lifecycle_one_device_restore"] = {
            "restore_s": one["restore_s"], "s": time.perf_counter() - t_one}
        t_f = time.perf_counter()
        out["recovery"] = _mf_part(torch, tmp, root)
        out["recovery"]["s"] = time.perf_counter() - t_f
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def kernels_line():
    out = []
    for name, (source, replaces, also) in KERNEL_META.items():
        r = RESULTS[name]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        }
        if also:
            entry["also_replaces"] = also
        if "mesh_launches_per_rank" in r:
            # mesh_main_path's parts (e), (g) and (h): launches of each
            # rank, by mesh
            entry["mesh_launches_per_rank"] = r["mesh_launches_per_rank"]
        if "recovery_launches_per_rank" in r:
            # parts (f) and (h): each recovered rank's launches in its
            # replay
            entry["recovery_launches_per_rank"] = r[
                "recovery_launches_per_rank"]
        out.append(entry)
    return {"kernels": out}


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: PyTorch is missing: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import loghisto_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the loghisto_tpu_torch package is not beside "
              f"this script: {e}", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    failed = []
    only = set(sys.argv[1:])
    for name, phase in (("card", phase_card), ("codec", phase_codec),
                        ("analysis", phase_analysis),
                        ("k1_fused_ingest", phase_k1),
                        ("k2_row_ingest", phase_k2),
                        ("k3_sparse_ingest", phase_k3),
                        ("k4_paged_scatter", phase_k4),
                        ("k4f_fused_paged_ingest", phase_k4f),
                        ("k5_window_merge", phase_k5),
                        ("main_path", phase_main),
                        ("transport_crossover", phase_transport_crossover),
                        ("native_host_main_path", phase_native_host),
                        ("paged_main_path", phase_paged_main),
                        ("retention_main_path", phase_retention),
                        ("k6_compact_rows", phase_k6),
                        ("k7_divergence", phase_k7),
                        ("lifecycle_drift_main_path",
                         phase_lifecycle_drift),
                        ("paged_lifecycle_main_path",
                         phase_paged_lifecycle),
                        ("checkpoint_journal_main_path",
                         phase_checkpoint_journal),
                        ("labels_group_by_main_path",
                         phase_labels_group_by),
                        ("k8_multirow_ingest", phase_k8),
                        ("ingest_paths_main_path", phase_ingest_paths),
                        # before the firehose: after its profiled
                        # intervals, later torch.profiler captures in the
                        # process lose the hand-built kernels' records
                        # (PERF.md §7)
                        ("observability_main_path",
                         phase_observability),
                        ("resilience_main_path", phase_resilience),
                        ("federation_main_path", phase_federation),
                        ("federation_system_main_path",
                         phase_federation_system),
                        ("sketches_main_path", phase_sketches),
                        ("mesh_main_path", phase_mesh),
                        ("firehose_main_path", phase_firehose)):
        if only and name != "card" and name not in only:
            continue
        t0 = time.perf_counter()
        try:
            out = phase(torch)
            emit({"phase": name, "ok": True,
                  "s": round(time.perf_counter() - t0, 3), **out})
        except Exception as e:  # report every phase, then fail the run
            traceback.print_exc()
            emit({"phase": name, "ok": False, "error": repr(e)})
            failed.append(name)
            if name == "card":
                break
        torch.cuda.empty_cache()
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    if only:  # a subset of phases: no kernels line, no result
        return 0
    print(RESULTS["card"], flush=True)
    emit({"total_s": round(time.perf_counter() - t_start, 3)})
    emit(kernels_line())
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
