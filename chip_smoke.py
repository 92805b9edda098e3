#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``loghisto_tpu_torch``) on one
NVIDIA card: builds the Hopper kernels from ``loghisto_tpu_torch/csrc``,
holds each against its plain PyTorch version at the main paths' shapes,
then drives the main paths through ``TorchAggregator`` — record_batch ->
transfer worker -> kernels -> ``collect()`` — and checks their output
against host oracles:

  * dense storage (``main_path``) at 10,000 metrics x 8193 buckets: K1
    on the raw route, K3 on the sparse route, K2 on the single row;
  * paged storage (``paged_main_path``) at 2^20 live rows x 8193 buckets
    (page pool of 2^21 pages), the reference's paged headline: K4f on
    the raw route, K4 on the sparse route, a snapshot query of 4096
    rows on each; plus the dense route on the same workload at 65,536
    rows for contrast.

    python3 chip_smoke.py

Needs a CUDA device (exits nonzero, printing no result, without one, or
without the package beside it).  Imports nothing of JAX.  Each phase
prints one JSON line; a failed phase makes the script exit 1.  The card
line (``nvidia-smi`` name and power limit), the ``kernels`` line and, as
the last line, ``{"ok": true, "device": {...}}`` close a passing run.

Kernel times are CUDA-event means over repeated launches after a warm-up;
``bound_ms`` is the larger of the bytes the call must move over the
card's memory rate and its operations over the peak rate for their type
(H100 SXM data sheet).  Data-dependent work is counted from this run's
inputs: a scatter moves only the cells it touches.
"""

from __future__ import annotations

import collections
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

RESULTS: dict = {}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, ops: float = 0.0, ops_rate: float = FP64_OPS_PER_S):
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_rate * 1e3
    return max(byte_ms, ops_ms), ("bytes" if byte_ms >= ops_ms else "operations")


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
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
    from loghisto_tpu_torch.ops.row_ingest import histogram_row

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
    out = {
        "edge_values": m, "k1_edge_mismatch": k1_edge_mismatch,
        "plain_edge_mismatch": plain_edge_mismatch,
        "random_values": n, "k2_random_mismatch": k2_random_mismatch,
    }
    if k1_edge_mismatch or plain_edge_mismatch or k2_random_mismatch:
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
    from loghisto_tpu_torch.ops.fused_ingest import fused_ingest_batch
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
    for name in ("zipf", "uniform"):
        ids, vals = batches[name]
        ids_d = torch.from_numpy(ids).to(dev)
        vals_d = torch.from_numpy(vals).to(dev)
        cols = np.clip(compress_np(vals), -BL, BL).astype(np.int64) + BL
        cols_d = torch.from_numpy(cols).to(dev)
        ones = torch.ones(BATCH, dtype=torch.int32, device=dev)
        ids_l = ids_d.long()
        acc = torch.zeros((M, B), dtype=torch.int32, device=dev)
        k_ms = time_ms(torch, lambda: fused_ingest_batch(acc, ids_d, vals_d, BL))
        p_ms = time_ms(torch, lambda: ingest_batch(acc, ids_d, vals_d, BL))
        lib_ms = time_ms(torch, lambda: acc.index_put_(
            (ids_l, cols_d), ones, accumulate=True))
        cells = touched_cells(ids, cols, M)
        b_ms, b_by = bound_ms(BATCH * 8 + cells * 8, BATCH * CODEC_OPS)
        timings[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "touched_cells": cells}
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
    a_plain = time_ms(torch, lambda: histogram_row_reference(
        row, vals_d, BL, 100))
    a_lib = time_ms(torch, lambda: torch.bincount(cols_all, minlength=B))
    a_bound, a_by = bound_ms(n * 4 + B * 8, n * CODEC_OPS)
    k2a = {"ms": a_ms, "plain_ms": a_plain, "library_ms": a_lib,
           "bound_ms": a_bound, "bound_by": a_by,
           "library_call": "torch.bincount on precomputed bucket columns "
                           "(no codec)"}
    return {"N": n, "ragged_N": ragged, "equal_unmasked": eq_a,
            "equal_masked": eq_b, "equal_host": eq_host,
            "max_abs_err": max_err, **RESULTS["row_ingest"],
            "library_call": "torch.bincount on precomputed bucket columns "
                            "of the id-0 samples (no codec)",
            "k2a_unmasked": k2a}


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
    if not equal or int(acc_k.sum()) != n + 7:
        raise AssertionError(f"K3 differs: equal={equal}")
    keep = (packed[:, 0] >= 0) & (packed[:, 0] < M)
    ids_l = torch.from_numpy(packed[keep, 0].astype(np.int64)).to(dev)
    cols_l = torch.from_numpy(
        np.clip(packed[keep, 1], -BL, BL).astype(np.int64) + BL).to(dev)
    w = torch.from_numpy(packed[keep, 2]).to(dev)
    acc = torch.zeros((M, B), dtype=torch.int32, device=dev)
    k_ms = time_ms(torch, lambda: sparse_ingest(acc, packed_d, BL))
    p_ms = time_ms(torch, lambda: sparse_ingest_batch(acc, packed_d, BL))
    lib_ms = time_ms(torch, lambda: acc.index_put_(
        (ids_l, cols_l), w, accumulate=True))
    rows = len(packed)
    b_ms, b_by = bound_ms(rows * 12 + int(keep.sum()) * 8)
    RESULTS["sparse_ingest"] = {"max_abs_err": max_err, "ms": k_ms,
                                "plain_ms": p_ms, "library_ms": lib_ms,
                                "bound_ms": b_ms, "bound_by": b_by}
    return {"samples": n, "triples": rows, "equal": equal,
            "max_abs_err": max_err, **RESULTS["sparse_ingest"],
            "library_call": "acc.index_put_((ids, cols), counts, "
                            "accumulate=True) on pre-clipped columns"}


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
    if launches[kernel] <= 0:
        raise AssertionError(f"{kernel} was not launched on the main path")
    total = 3 * interval_samples
    return {
        "num_metrics": num_metrics, "transport": agg.transport,
        "ingest_path": agg.ingest_path, "samples": total,
        "samples_per_s": total / sum(ingest_s),
        "ingest_s": ingest_s, "collect_ms": collect_ms,
        "rows_checked": checked, "launches": launches,
    }


def phase_main(torch):
    runs = {
        "raw": _drive(torch, M, "raw", 1 << 24, "fused_ingest"),
        "sparse": _drive(torch, M, "sparse", 1 << 24, "sparse_ingest"),
        "single": _drive(torch, 1, "raw", 1 << 22, "row_ingest"),
    }
    assert runs["single"]["ingest_path"] == "row"
    for kernel, run in (("fused_ingest", "raw"), ("sparse_ingest", "sparse"),
                        ("row_ingest", "single")):
        RESULTS.setdefault(kernel, {})["launches"] = runs[run]["launches"][
            kernel]
    return runs


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


def phase_k4(torch):
    """K4 against its plain version on the triples the paged sparse
    route gives it at the headline shape: one 2^20-sample batch of the
    band workload and of a uniform workload, folded and translated
    against a 2^20-row store with a 2^21-page pool, and an adversarial
    batch."""
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

    d = torch.from_numpy(band).to(dev)
    valid = (band[:, 0] > 0) & (band[:, 0] < PAGED_POOL)
    flat = torch.from_numpy(band[valid, 0].astype(np.int64) * 256
                            + np.clip(band[valid, 1], 0, 255)).to(dev)
    w = torch.from_numpy(band[valid, 2]).to(dev)
    k_ms = time_ms(torch, lambda: paged_scatter(pool_k, d))
    p_ms = time_ms(torch, lambda: paged_scatter_batch(pool_p, d))
    lib_ms = time_ms(torch, lambda: pool_p.view(-1).index_put_(
        (flat,), w, accumulate=True))
    cells = len(np.unique(band[valid & (band[:, 2] != 0), 0].astype(np.int64)
                          * 256 + np.clip(band[valid & (band[:, 2] != 0), 1],
                                          0, 255)))
    b_ms, b_by = bound_ms(len(band) * 12 + cells * 8)
    RESULTS["paged_scatter"] = {"max_abs_err": max_err, "ms": k_ms,
                                "plain_ms": p_ms, "library_ms": lib_ms,
                                "bound_ms": b_ms, "bound_by": b_by}
    out = {"M": PAGED_M, "pool_pages": PAGED_POOL, "batch_samples": BATCH,
           "triples": {k: len(v) for k, v in batches.items()},
           "touched_cells": cells, "equal": equal,
           **RESULTS["paged_scatter"],
           "library_call": "pool.view(-1).index_put_((flat,), counts, "
                           "accumulate=True) on a precomputed flat index"}
    del store, pool_k, pool_p
    return out


def phase_k4f(torch):
    """K4f against its plain version at the headline shape: 2^20-sample
    batches through prepare_batch on a 2^20-row store (2^21-page pool):
    the band workload, a uniform workload, and an adversarial batch
    (-1 ids, rows with no codec, unmapped pages, a hot cell)."""
    from loghisto_tpu_torch.ops.fused_ingest import (
        fused_paged_ingest_batch,
        fused_paged_ingest_reference,
    )

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

    i_d = torch.from_numpy(batches["band"][0]).to(dev)
    v_d = torch.from_numpy(band_vals).to(dev)
    fresh = torch.zeros_like(pool_p)
    fused_paged_ingest_reference(fresh, i_d, v_d, *luts, BL)
    cells = int((fresh != 0).sum())
    del fresh
    k_ms = time_ms(torch, lambda: fused_paged_ingest_batch(
        pool_k, i_d, v_d, *luts, BL))
    p_ms = time_ms(torch, lambda: fused_paged_ingest_reference(
        pool_p, i_d, v_d, *luts, BL))
    # 8 B/sample in, 8 B of table gathers per sample (row codec + page
    # table entry; the 98 KB of encode LUTs stay in L2), 8 B of
    # read-modify-write per touched cell
    b_ms, b_by = bound_ms(BATCH * 16 + cells * 8, BATCH * CODEC_OPS)
    RESULTS["fused_paged_ingest"] = {"max_abs_err": max_err, "ms": k_ms,
                                     "plain_ms": p_ms, "library_ms": None,
                                     "bound_ms": b_ms, "bound_by": b_by}
    out = {"M": PAGED_M, "pool_pages": PAGED_POOL, "batch": BATCH,
           "adversarial_samples": n_adv, "touched_cells": cells,
           "hot_cell": hot, "equal": equal,
           "allocated_pages": int(store.allocated_pages),
           **RESULTS["fused_paged_ingest"],
           "library_call": "none: no single PyTorch call computes codec, "
                           "encode, translate and scatter"}
    del store, pool_k, pool_p
    return out


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
    for name, phase in (("card", phase_card), ("codec", phase_codec),
                        ("k1_fused_ingest", phase_k1),
                        ("k2_row_ingest", phase_k2),
                        ("k3_sparse_ingest", phase_k3),
                        ("k4_paged_scatter", phase_k4),
                        ("k4f_fused_paged_ingest", phase_k4f),
                        ("main_path", phase_main),
                        ("paged_main_path", phase_paged_main)):
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
    print(RESULTS["card"], flush=True)
    emit({"total_s": round(time.perf_counter() - t_start, 3)})
    emit(kernels_line())
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
