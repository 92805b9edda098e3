#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``loghisto_tpu_torch``) on one
NVIDIA card: builds the Hopper kernels from ``loghisto_tpu_torch/csrc``,
holds each against its plain PyTorch version at the main paths' shapes,
then drives the main paths through ``TorchAggregator`` — record_batch ->
transfer worker -> kernels -> ``collect()`` — and checks their output
against host oracles:

  * dense storage (``main_path``) at 10,000 metrics x 8193 buckets: K1
    on the raw route, K3 on the sparse route, the default
    transport="auto" (which the card's measured crossover keeps on raw),
    K2 on the single row; ``transport_crossover`` measures that
    crossover (raw and sparse at five cell densities) and sweeps the
    batch size at which K4f beats the sparse route on paged storage;
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
import dataclasses
import datetime as _dt
import json
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
    ptxas = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln]
        for name, log in _build.BUILD_LOGS.items()
    }
    RESULTS["card"] = card
    return {"card": card, "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(0),
            "build_s": round(build_s, 3), "built": built, "ptxas": ptxas}


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


def _xo_dense(torch, ids, values):
    """Raw (staging + K1) and sparse (NumPy fold + K3) through
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


def phase_transport_crossover(torch):
    """F4's measurement: the dense raw and sparse transports through
    TorchAggregator on the same streams at five cell densities (2^24
    samples each, M = 10,000); the card's crossover is the highest
    density at which sparse beats raw (0.0 if it wins nowhere) and must
    be the one ops/dispatch.py states.  Then the FUSED_MIN_BATCH sweep:
    K4f against the sparse route on paged storage (2^20 rows) at batch
    sizes 2^12 ... 2^20."""
    from loghisto_tpu_torch.ops import dispatch

    rng = np.random.default_rng(SEED + 40)
    points = []
    for name, kw in XO_STREAMS:
        ids, values = _xo_stream(rng, XO_SAMPLES, **kw)
        density = _cell_density(ids[:BATCH], values[:BATCH])
        rates = _xo_dense(torch, ids, values)
        points.append({"stream": name, "density": density,
                       "raw_samples_per_s": rates["raw"],
                       "sparse_samples_per_s": rates["sparse"]})
    wins = [p["density"] for p in points
            if p["sparse_samples_per_s"] > p["raw_samples_per_s"]]
    measured = max(wins) if wins else 0.0
    stated = dispatch.sparse_density_crossover("cuda")
    if (measured > 0.0) != (stated > 0.0) or measured > stated:
        raise AssertionError(f"measured crossover {measured} on the card; "
                             f"ops/dispatch.py states {stated}")

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
    return {"samples": XO_SAMPLES, "points": points,
            "measured_crossover": measured, "stated_crossover": stated,
            "fused_min_batch_sweep": {
                "samples": FMB_SAMPLES, "rows": PAGED_M, "points": sweep,
                "k4f_wins_from_batch": k4f_from,
                "stated": dispatch.fused_min_batch_for("cuda")}}


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
             agg_mod.fold_packed_numpy)
    if agg.paged is not None:
        fused_mod.fused_paged_ingest_batch = timers.dev_wrap(
            "k4f", saved[0])
        paged_mod.paged_scatter = timers.dev_wrap("k4", saved[1])
        agg_mod.fold_packed_numpy = timers.host_wrap("fold", saved[2])
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
         agg_mod.fold_packed_numpy) = saved
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
    raw = _drive_paged(torch, "auto", 2, PAGED_M)
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
    """An in-process TCP listener that keeps every byte it is sent."""

    def __init__(self):
        import socket
        import threading

        self._srv = socket.create_server(("127.0.0.1", 0))
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
                        ("k1_fused_ingest", phase_k1),
                        ("k2_row_ingest", phase_k2),
                        ("k3_sparse_ingest", phase_k3),
                        ("k4_paged_scatter", phase_k4),
                        ("k4f_fused_paged_ingest", phase_k4f),
                        ("k5_window_merge", phase_k5),
                        ("main_path", phase_main),
                        ("transport_crossover", phase_transport_crossover),
                        ("paged_main_path", phase_paged_main),
                        ("retention_main_path", phase_retention),
                        ("k6_compact_rows", phase_k6),
                        ("k7_divergence", phase_k7),
                        ("lifecycle_drift_main_path",
                         phase_lifecycle_drift),
                        ("labels_group_by_main_path",
                         phase_labels_group_by),
                        ("k8_multirow_ingest", phase_k8),
                        ("ingest_paths_main_path", phase_ingest_paths),
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
