#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``loghisto_tpu_torch``) on one
NVIDIA card: builds the Hopper kernels from ``loghisto_tpu_torch/csrc``,
holds each against its plain PyTorch version at the main path's shapes,
then drives the main path — ``TorchAggregator.record_batch`` -> transfer
worker -> kernels -> ``collect()`` — at the headline shape of 10,000
metrics x 8193 buckets and checks its output against a host oracle.

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
    return {"N": n, "ragged_N": ragged, "equal_unmasked": eq_a,
            "equal_masked": eq_b, "equal_host": eq_host,
            "max_abs_err": max_err, **RESULTS["row_ingest"],
            "library_call": "torch.bincount on precomputed bucket columns "
                            "of the id-0 samples (no codec)"}


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


KERNEL_META = {
    "fused_ingest": ("loghisto_tpu_torch/csrc/fused_ingest.cu",
                     "loghisto_tpu/ops/fused_ingest.py:169", None),
    "row_ingest": ("loghisto_tpu_torch/csrc/row_ingest.cu",
                   "loghisto_tpu/ops/pallas_kernels.py:158",
                   "loghisto_tpu/ops/pallas_kernels.py:46"),
    "sparse_ingest": ("loghisto_tpu_torch/csrc/sparse_ingest.cu",
                      "loghisto_tpu/ops/sparse_ingest.py:66", None),
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
                        ("main_path", phase_main)):
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
