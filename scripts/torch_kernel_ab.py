#!/usr/bin/env python3
"""Time the port's kernels against an earlier revision of the same
kernels, in one process on one NVIDIA card, in turns (old, new, new,
old), at the shapes of chip_smoke.py.

    git archive <rev> loghisto_tpu_torch/csrc | tar -x -C build/ab_parent
    python3 scripts/torch_kernel_ab.py build/ab_parent [k8 k2 k1 k4 k7 k3 k4f k5]

The earlier sources are built with the same nvcc flags as the package's
own (``ops/_build.py``) into ``build/ab/``.  Each comparison calls the
earlier entry point with that revision's signature:

  * ``k8`` and ``k2`` (the default) take the revision before K8's
    cluster histogram and K2's table codec (9e897f6): K8
    ``lh_multirow_ingest``, one thread an entry, and K2
    ``lh_row_ingest`` with the float64 codec and no table.  K8 is timed
    on phase k8's timed Zipf batch and a uniform batch at M = 16, 256
    and 10,000, warm and L2-flushed, beside its diagnoses: the atomics
    alone on the layout's flat cells, without the two most frequent
    rows, the walk alone (``diag_k8_walk``), and the run lengths and
    the share of entries that took the cluster histogram.  K2 is timed
    masked and unmasked on phase k2's 2^22 batch, beside the float64
    and the table codec alone, shared-memory atomics alone on the
    earlier grid, that grid's zero and flush alone, and the firehose's
    step at one metric with each revision's K2.
  * ``k1`` and ``k4`` take the revision before K1's cell
    table and K4's shared triple loop (fd1717c): K1 ``lh_fused_ingest``
    and K4 ``lh_paged_scatter``, one thread an item in a grid-stride
    loop.  K1 is timed on phase k1's Zipf and uniform 2^20 batches and
    a Zipf 2^22 batch, warm and with the L2 flushed, and in the
    firehose's step at 10,000 metrics and batch 2^22 (generation on the
    card, then K1: the step with each revision's K1, in turns).  K4 is
    timed on phase k4's band batch and the row-grouped interval
    (``chip_smoke.row_grouped_triples``), warm and L2-flushed.
    Diagnosis kernels that exist only here (``DIAG_SOURCE``) time K1's
    atomics alone on precomputed cells and its codec alone, and K4 with
    a store in place of the atomic and with a plain read-modify-write
    (the random-access time of the same cells); K4 is also timed on its
    triples in a random order and with their slots renumbered into a
    pool of only the touched pages.
  * ``k7`` and ``k3`` take the revision before K7's streamed rows and
    K3's multi-target launch (98f588e): K7 ``lh_divergence`` staging a
    whole row in shared memory, K3 ``lh_sparse_ingest`` with one target
    and one thread a triple.  K3 is timed at phase k3's batch with the
    L2 as the table leaves it and flushed before each launch, and at the
    fused commit's shape: one launch into five targets against five
    earlier launches.
  * ``k4f`` and ``k5`` take a revision before those kernels' redesign
    (7de23b8): K4f ``lh_fused_paged_ingest`` reading an
    ``[M, pages_per_row]`` page table, K5 ``lh_window_merge`` taking a
    host slot list of at most 1000 slots (one launch per view).

Both revisions must agree (int32 outputs equal, K7 within chip_smoke's
K7_TOL) before anything is timed.  Times are ``chip_smoke.time_ms``'s
device times.  Prints one JSON line per comparison, the card's name and
power limit first.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the smoke's shapes and helpers)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# comparison -> (earlier source, its entry point, its argtypes)
OLD_ENTRIES = {
    "k1": ("fused_ingest.cu", "lh_fused_ingest",
           [_P, _P, _P, _LL, _I, _I, _I, _I, _P]),
    "k4": ("paged_store.cu", "lh_paged_scatter", [_P, _P, _LL, _I, _I, _P]),
    "k7": ("divergence.cu", "lh_divergence",
           [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "k3": ("sparse_ingest.cu", "lh_sparse_ingest",
           [_P, _P, _LL, _I, _I, _I, _P]),
    "k4f": ("paged_store.cu", "lh_fused_paged_ingest",
            [_P, _P, _P, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "k5": ("window_merge.cu", "lh_window_merge",
           [_P, _P, _P, _I, _I, _LL, _P]),
    "k8": ("multirow_ingest.cu", "lh_multirow_ingest",
           [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P]),
    "k2": ("row_ingest.cu", "lh_row_ingest", [_P, _P, _P, _LL, _I, _I, _I, _P]),
}


# Diagnosis kernels of K1, K4, K8 and K2: they exist only in this script,
# never in the package (the source includes csrc/row_ingest.cu for K2's
# table codec).  K8 and K2 also use K1 (a) and (b).  K1 (a): one atomic a sample on precomputed flat cells
# (int64, -1 drops), in the earlier kernel's grid-stride layout; K1 (b):
# the codec alone, each sample's column written to a buffer.  K4 (c): a
# store in place of the atomic; and a plain (not atomic) read-modify-
# write of each cell; both in K4's own triple loop, with K4's filters
# and clip.  The store and the plain add race on repeated
# cells, so their pools are never compared.
DIAG_SOURCE = r"""
#include "row_ingest.cu"
#include "triple_scatter.cuh"

__global__ void diag_k1_atomics(int* acc, const long long* cells, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const long long c = cells[i];
    if (c >= 0) atomicAdd(acc + c, 1);
  }
}

__global__ void diag_k1_codec(int* out, const float* values, long long n, int bl,
                              int precision) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = lh_dense_col(values[i], bl, precision);
  }
}

template <bool kStore>
__global__ void __launch_bounds__(128)
diag_k4(int* pool, const int* packed, long long n, int pool_pages, int page_size) {
  lh_scatter_triples<128, 4>(packed, n, [&](int slot, int off, int count) {
    if (count == 0 || slot <= 0 || slot >= pool_pages) return;
    off = off < 0 ? 0 : (off >= page_size ? page_size - 1 : off);
    int* cell = pool + static_cast<long long>(slot) * page_size + off;
    if (kStore) {
      *cell = count;
    } else {
      *cell += count;
    }
  });
}

// K8 (c): the walk alone: every entry's row and the bucket of every
// 4-entry group that holds a real one, 16 bytes at a time, nothing added
__global__ void diag_k8_walk(int* sink, const int4* rows, const int4* bidx, long long quads,
                             int rows_tile) {
  int x = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       q < quads; q += stride) {
    const int4 r = __ldg(rows + q);
    x ^= r.x ^ r.y ^ r.z ^ r.w;
    if (min(min(r.x, r.y), min(r.z, r.w)) < rows_tile) {
      const int4 b = __ldg(bidx + q);
      x ^= b.x ^ b.y ^ b.z ^ b.w;
    }
  }
  if (x == 0x7fffffff) sink[0] = x;  // keeps the loads
}

// K2 (d): the table codec alone, one column written a sample
__global__ void diag_k2_table_codec(int* out, const float* values, const float* table,
                                    long long n, int bl, int precision) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = lh_table_col(values[i], table, bl, static_cast<float>(precision));
  }
}

// K2 (b): shared-memory atomics alone on precomputed columns, on the
// earlier kernel's grid (zero, add, flush a block); (c): the zero and the
// flush alone, each block's histogram loaded from `live` (one block's
// share of the batch)
__global__ void diag_k2_smem(int* acc_row, const int* cols, long long n, const int* live,
                             int num_buckets) {
  extern __shared__ int hist[];
  for (int b = threadIdx.x; b < num_buckets; b += blockDim.x) {
    hist[b] = live != nullptr ? live[b] : 0;
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    atomicAdd(hist + cols[i], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < num_buckets; b += blockDim.x) {
    const int c = hist[b];
    if (c) atomicAdd(acc_row + b, c);
  }
}

__global__ void diag_empty() {}

// an empty kernel of `blocks` 512-thread blocks in clusters of `cluster`
extern "C" int diag_empty_launch(int blocks, int cluster, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(512);
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, diag_empty);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" int diag_k8_walk_launch(void* sink, const void* rows, const void* bidx,
                                   long long quads, int rows_tile, void* stream) {
  diag_k8_walk<<<lh_grid(quads, 256, 8), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(sink), static_cast<const int4*>(rows),
      static_cast<const int4*>(bidx), quads, rows_tile);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int diag_k2_table_codec_launch(void* out, const void* values, const void* table,
                                          long long n, int bl, int precision,
                                          void* stream) {
  diag_k2_table_codec<<<lh_grid(n, 256, 16), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), static_cast<const float*>(values),
      static_cast<const float*>(table), n, bl, precision);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int diag_k2_smem_launch(void* acc_row, const void* cols, long long n,
                                   const void* live, long long grid_n, int num_buckets,
                                   void* stream) {
  const unsigned grid = lh_grid((grid_n + 4095) / 4096, 1, 4);  // the earlier grid
  diag_k2_smem<<<grid, 512, num_buckets * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(acc_row), static_cast<const int*>(cols), n,
      static_cast<const int*>(live), num_buckets);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int diag_k1_atomics_launch(void* acc, const void* cells, long long n,
                                      void* stream) {
  diag_k1_atomics<<<lh_grid(n, 256, 16), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(acc), static_cast<const long long*>(cells), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int diag_k1_codec_launch(void* out, const void* values, long long n, int bl,
                                    int precision, void* stream) {
  diag_k1_codec<<<lh_grid(n, 256, 16), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), static_cast<const float*>(values), n, bl, precision);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int diag_k4_launch(void* pool, const void* packed, long long n, int pool_pages,
                              int page_size, int store, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (store) {
    diag_k4<true><<<lh_triple_blocks<128, 4>(n), 128, 0, st>>>(
        static_cast<int*>(pool), static_cast<const int*>(packed), n, pool_pages, page_size);
  } else {
    diag_k4<false><<<lh_triple_blocks<128, 4>(n), 128, 0, st>>>(
        static_cast<int*>(pool), static_cast<const int*>(packed), n, pool_pages, page_size);
  }
  return static_cast<int>(cudaGetLastError());
}
"""
DIAG_ENTRIES = {
    "diag_k1_atomics_launch": [_P, _P, _LL, _P],
    "diag_k1_codec_launch": [_P, _P, _LL, _I, _I, _P],
    "diag_k4_launch": [_P, _P, _LL, _I, _I, _I, _P],
    "diag_k8_walk_launch": [_P, _P, _P, _LL, _I, _P],
    "diag_empty_launch": [_I, _I, _P],
    "diag_k2_table_codec_launch": [_P, _P, _P, _LL, _I, _I, _P],
    "diag_k2_smem_launch": [_P, _P, _LL, _P, _LL, _I, _P],
}


def build_old(parent: Path, names) -> dict:
    """The earlier entry points of ``names`` and, for ``k1`` or ``k4``,
    the diagnosis kernels (``fns["diag"]``), one nvcc per source, all
    started together."""
    from loghisto_tpu_torch.ops import _build

    csrc = parent / "loghisto_tpu_torch" / "csrc"
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)

    def nvcc(include, lib, source):
        return subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(include),
             "-o", str(lib), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    procs = {}
    for name in set(names) & set(OLD_ENTRIES):
        source = OLD_ENTRIES[name][0]
        lib = out_dir / f"old_{name}_{Path(source).stem}.so"
        procs[name] = (lib, nvcc(csrc, lib, csrc / source))
    if {"k1", "k4", "k8", "k2", "designs"} & set(names):
        diag_src = out_dir / "diag.cu"
        diag_src.write_text(DIAG_SOURCE)
        procs["diag"] = (out_dir / "diag.so",
                         nvcc(_build.CSRC, out_dir / "diag.so", diag_src))
    fns = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}'s source:\n{err}")
        cdll = ctypes.CDLL(str(lib))
        if name == "diag":
            for symbol, argtypes in DIAG_ENTRIES.items():
                fn = getattr(cdll, symbol)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[name] = cdll
            continue
        _, symbol, argtypes = OLD_ENTRIES[name]
        fn = getattr(cdll, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def _call(fn, *args):
    import torch

    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"earlier kernel failed: CUDA error {rc}")


def in_turns(torch, old, new, reps=20, timer=None):
    """old, new, new, old; returns the two times of each."""
    timer = timer or cs.time_ms
    t = [timer(torch, f, reps=reps) for f in (old, new, new, old)]
    return {"old_ms": [t[0], t[3]], "new_ms": [t[1], t[2]]}


def _k1_batches(rng):
    """Phase k1's batches in its draw order: Zipf and uniform 2^20, then
    (after the adversarial block's draws) Zipf 2^22."""
    out = {"zipf": (cs.zipf_ids(rng, cs.BATCH, cs.M),
                    cs.lognormal_values(rng, cs.BATCH)),
           "uniform": (rng.integers(0, cs.M, cs.BATCH).astype(np.int32),
                       cs.lognormal_values(rng, cs.BATCH))}
    cs._adversarial_block(rng, cs.M)
    out["zipf_2^22"] = (cs.zipf_ids(rng, cs.FH_BATCH, cs.M),
                        cs.lognormal_values(rng, cs.FH_BATCH))
    return out


def ab_k1(torch, old_fn, diag):
    """K1 at phase k1's batches: the revisions in turns (warm, L2
    flushed), the diagnosis kernels, then the firehose's step at 10,000
    metrics and batch 2^22 with each revision's K1."""
    from loghisto_tpu_torch.firehose import _make_sample_generator
    from loghisto_tpu_torch.ops.codec import compress_np
    from loghisto_tpu_torch.ops.fused_ingest import (
        device_plan,
        fused_ingest_batch,
        sm_count,
    )
    from loghisto_tpu_torch.ops.ingest import ingest_batch

    dev = torch.device("cuda")
    sms = sm_count(torch.cuda.current_device())
    rng = np.random.default_rng(cs.SEED + 1)
    acc = torch.zeros((cs.M, cs.B), dtype=torch.int32, device=dev)
    acc_old = torch.zeros_like(acc)
    want = torch.zeros_like(acc)

    def old(target, i_d, v_d):
        _call(old_fn, target.data_ptr(), i_d.data_ptr(), v_d.data_ptr(),
              i_d.shape[0], cs.M, cs.B, cs.BL, 100)

    out = {"sms": sms}
    for name, (ids, vals) in _k1_batches(rng).items():
        n = len(ids)
        i_d = torch.from_numpy(ids).to(dev)
        v_d = torch.from_numpy(vals).to(dev)
        for t in (acc, acc_old, want):
            t.zero_()
        fused_ingest_batch(acc, i_d, v_d, cs.BL)
        old(acc_old, i_d, v_d)
        ingest_batch(want, i_d, v_d, cs.BL)
        torch.cuda.synchronize()
        if not (torch.equal(acc, want) and torch.equal(acc_old, want)):
            raise AssertionError(f"K1 {name}: the revisions differ")
        res = {"samples": n, "plan": device_plan(
                   n, cs.M, cs.B, torch.cuda.current_device())._asdict(),
               "warm": in_turns(torch, lambda: old(acc_old, i_d, v_d),
                                lambda: fused_ingest_batch(acc, i_d, v_d,
                                                           cs.BL)),
               "l2_flushed": in_turns(
                   torch, lambda: old(acc_old, i_d, v_d),
                   lambda: fused_ingest_batch(acc, i_d, v_d, cs.BL),
                   timer=cs.time_cold_ms)}
        res["speedup"] = float(np.mean(res["warm"]["old_ms"])) / float(
            np.mean(res["warm"]["new_ms"]))
        # (a) the atomics alone on precomputed cells, (b) the codec alone
        cols = np.clip(compress_np(vals), -cs.BL, cs.BL).astype(np.int64) + cs.BL
        keep = (ids >= 0) & (ids < cs.M)
        cells = torch.from_numpy(np.where(keep, ids.astype(np.int64) * cs.B
                                          + cols, -1)).to(dev)
        cols_out = torch.empty(n, dtype=torch.int32, device=dev)
        res["atomics_only_ms"] = [cs.time_ms(torch, lambda: _call(
            diag.diag_k1_atomics_launch, acc.data_ptr(), cells.data_ptr(), n))
            for _ in range(2)]
        # the atomics alone without the two most frequent rows
        top = np.bincount(ids[keep], minlength=cs.M).argsort()[-2:]
        cold = torch.from_numpy(np.where(keep & ~np.isin(ids, top),
                                         ids.astype(np.int64) * cs.B + cols,
                                         -1)).to(dev)
        res["atomics_only_without_top2_rows_ms"] = [cs.time_ms(
            torch, lambda: _call(diag.diag_k1_atomics_launch, acc.data_ptr(),
                                 cold.data_ptr(), n)) for _ in range(2)]
        res["top2_rows_share"] = float(np.isin(ids[keep], top).mean())
        res["codec_only_ms"] = [cs.time_ms(torch, lambda: _call(
            diag.diag_k1_codec_launch, cols_out.data_ptr(), v_d.data_ptr(), n,
            cs.BL, 100)) for _ in range(2)]
        if not torch.equal(cols_out.cpu().long(), torch.from_numpy(cols)):
            raise AssertionError(f"K1 {name}: the codec-only columns differ")
        res["touched_cells"] = cs.touched_cells(ids, cols, cs.M)
        res["bound_ms"] = cs.bound_ms(n * 8 + res["touched_cells"] * 8,
                                      n * cs.CODEC_OPS)[0]
        out[name] = res
        del cells, cols_out, cold

    # the firehose's step: generation on the card, then K1
    generate = _make_sample_generator(cs.M, 10.0, 2.0, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    ids_f, vals_f = generate(gen, cs.FH_BATCH)
    for t in (acc, acc_old, want):
        t.zero_()
    fused_ingest_batch(acc, ids_f, vals_f, cs.BL)
    old(acc_old, ids_f, vals_f)
    ingest_batch(want, ids_f, vals_f, cs.BL)
    torch.cuda.synchronize()
    if not (torch.equal(acc, want) and torch.equal(acc_old, want)):
        raise AssertionError("K1 on a firehose batch: the revisions differ")

    def step_old():
        i_d, v_d = generate(gen, cs.FH_BATCH)
        old(acc_old, i_d, v_d)

    def step_new():
        i_d, v_d = generate(gen, cs.FH_BATCH)
        fused_ingest_batch(acc, i_d, v_d, cs.BL)

    fh = {"metrics": cs.M, "batch": cs.FH_BATCH,
          "generate_ms": [cs.time_ms(torch, lambda: generate(gen, cs.FH_BATCH),
                                     reps=10) for _ in range(2)],
          "step": in_turns(torch, step_old, step_new, reps=10),
          "k1": in_turns(torch, lambda: old(acc_old, ids_f, vals_f),
                         lambda: fused_ingest_batch(acc, ids_f, vals_f,
                                                    cs.BL))}
    for rev in ("old", "new"):
        step_ms = float(np.mean(fh["step"][f"{rev}_ms"]))
        fh[f"{rev}_k1_share"] = float(np.mean(fh["k1"][f"{rev}_ms"])) / step_ms
        fh[f"{rev}_samples_per_s"] = [cs.FH_BATCH / t * 1e3
                                      for t in fh["step"][f"{rev}_ms"]]
    out["firehose_step"] = fh
    del acc, acc_old, want
    torch.cuda.empty_cache()
    return out


def run_lengths(tile_block):
    """{run length in tiles: runs} of one tile_block value."""
    tb = np.asarray(tile_block)
    starts = np.flatnonzero(np.r_[True, tb[1:] != tb[:-1]])
    lengths = np.diff(np.r_[starts, len(tb)])
    values, counts = np.unique(lengths, return_counts=True)
    return {int(v): int(c) for v, c in zip(values, counts)}


def ab_k8(torch, old_fn, diag):
    """K8 on phase k8's timed Zipf batch and a uniform batch at M = 16,
    256 and 10,000: the revisions in turns (warm, L2 flushed); the
    diagnoses: (a) the atomics alone on the layout's flat cells, (b) the
    same without the two most frequent rows, (c) the walk alone (every
    entry's row, the buckets of groups with a real entry, nothing
    added), (d) the run lengths in tiles and the share of real entries
    that took the cluster histogram."""
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
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    out = {}
    for m in (16, 256, cs.M):
        batches = cs._k8_batches(np.random.default_rng(cs.SEED + 80 + m), m)
        for name in ("zipf", "uniform"):
            ids, vals = batches[name]
            ids_d = torch.from_numpy(ids).to(dev)
            vals_d = torch.from_numpy(vals).to(dev)
            rows, bidx, tb = preprocess(ids_d, vals_d, m, ROWS_TILE, cs.BL)
            acc = torch.zeros((m, cs.B), dtype=torch.int32, device=dev)
            acc_old, want = torch.zeros_like(acc), torch.zeros_like(acc)

            def old(target):
                _call(old_fn, target.data_ptr(), rows.data_ptr(),
                      bidx.data_ptr(), tb.data_ptr(), rows.shape[0],
                      SAMPLE_TILE, ROWS_TILE, m, cs.B)

            multirow_ingest(acc, rows, bidx, tb)
            old(acc_old)
            multirow_ingest_reference(want, rows, bidx, tb, ROWS_TILE)
            torch.cuda.synchronize()
            if not (torch.equal(acc, want) and torch.equal(acc_old, want)):
                raise AssertionError(f"K8 M={m} {name}: the revisions differ")
            g = tb.shape[0]
            row = (tb.long().repeat_interleave(SAMPLE_TILE) * ROWS_TILE
                   + rows.long())
            real = rows < ROWS_TILE
            flat = (row * cs.B + bidx.long())[real]
            res = {"tiles": g, "real_entries": int(real.sum()),
                   "warm": in_turns(torch, lambda: old(acc_old),
                                    lambda: multirow_ingest(acc, rows, bidx,
                                                            tb)),
                   "l2_flushed": in_turns(
                       torch, lambda: old(acc_old),
                       lambda: multirow_ingest(acc, rows, bidx, tb),
                       timer=cs.time_cold_ms)}
            res["speedup"] = float(np.mean(res["warm"]["old_ms"])) / float(
                np.mean(res["warm"]["new_ms"]))
            n_flat = flat.shape[0]
            res["atomics_only_ms"] = [cs.time_ms(torch, lambda: _call(
                diag.diag_k1_atomics_launch, acc.data_ptr(), flat.data_ptr(),
                n_flat)) for _ in range(2)]
            hot = torch.bincount(row[real], minlength=m).argsort()[-2:]
            cold = torch.where(torch.isin(row[real], hot),
                               torch.full_like(flat, -1), flat)
            res["atomics_only_without_top2_rows_ms"] = [cs.time_ms(
                torch, lambda: _call(diag.diag_k1_atomics_launch,
                                     acc.data_ptr(), cold.data_ptr(), n_flat))
                for _ in range(2)]
            res["top2_rows_share"] = float(
                torch.isin(row[real], hot).float().mean())
            res["walk_only_ms"] = [cs.time_ms(torch, lambda: _call(
                diag.diag_k8_walk_launch, sink.data_ptr(), rows.data_ptr(),
                bidx.data_ptr(), rows.shape[0] // 4, ROWS_TILE))
                for _ in range(2)]
            tb_np = tb.cpu().numpy()
            clusters, span, fits = device_clusters(g, ROWS_TILE, cs.B)
            runs = histogram_runs(tb_np, clusters, span, ROWS_TILE, m, fits)
            per_tile = real.view(g, SAMPLE_TILE).sum(1).cpu().numpy()
            res.update(
                run_lengths=run_lengths(tb_np), clusters=clusters,
                tiles_a_cluster=span, histogram_runs=len(runs),
                histogram_share=float(sum(per_tile[a:b].sum()
                                          for a, b in runs)
                                      / max(1, per_tile.sum())))
            out[f"{m}/{name}"] = res
            del acc, acc_old, want, row, flat, cold
    torch.cuda.empty_cache()
    return out


def ab_k2(torch, old_fn, diag):
    """K2 at phase k2's 2^22 lognormal batch, masked (K2b) and unmasked
    (K2a): the revisions in turns (warm, L2 flushed); the diagnoses: (a)
    the float64 codec alone, (d) the table codec alone, (b) shared-memory
    atomics alone on precomputed columns on the earlier grid, (c) the
    earlier grid's zero and flush alone; then the firehose's step at one
    metric and batch 2^22 with each revision's K2."""
    from loghisto_tpu_torch.firehose import _make_sample_generator
    from loghisto_tpu_torch.ops.codec import compress_np
    from loghisto_tpu_torch.ops.row_ingest import (
        device_blocks,
        histogram_row,
        histogram_row_reference,
        row_ingest_batch,
        threshold_table,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED + 2)
    n = 1 << 22
    vals = cs.lognormal_values(rng, n)
    ids = np.where(rng.random(n) < 0.1, rng.integers(-1, 3, n), 0).astype(
        np.int32)
    ids_d = torch.from_numpy(ids).to(dev)
    vals_d = torch.from_numpy(vals).to(dev)
    acc = torch.zeros((1, cs.B), dtype=torch.int32, device=dev)
    acc_old, want = torch.zeros_like(acc), torch.zeros_like(acc)

    def old(target, i_d, v_d):
        _call(old_fn, target.data_ptr(),
              None if i_d is None else i_d.data_ptr(), v_d.data_ptr(),
              v_d.shape[0], cs.B, cs.BL, 100)

    out = {"blocks": device_blocks(n, cs.B), "cluster": 8,
           "table_codec": True}
    for name, i_d in (("masked", ids_d), ("unmasked", None)):
        for t in (acc, acc_old, want):
            t.zero_()
        if i_d is None:
            def new():
                histogram_row(acc[0], vals_d, cs.BL)
            histogram_row_reference(want[0], vals_d, cs.BL, 100)
        else:
            def new():
                row_ingest_batch(acc, ids_d, vals_d, cs.BL)
            histogram_row_reference(want[0], vals_d, cs.BL, 100, ids_d)
        new()
        old(acc_old, i_d, vals_d)
        torch.cuda.synchronize()
        if not (torch.equal(acc, want) and torch.equal(acc_old, want)):
            raise AssertionError(f"K2 {name}: the revisions differ")
        res = {"warm": in_turns(torch, lambda: old(acc_old, i_d, vals_d), new),
               "l2_flushed": in_turns(torch,
                                      lambda: old(acc_old, i_d, vals_d), new,
                                      timer=cs.time_cold_ms)}
        res["speedup"] = float(np.mean(res["warm"]["old_ms"])) / float(
            np.mean(res["warm"]["new_ms"]))
        out[name] = res

    cols = np.clip(compress_np(vals), -cs.BL, cs.BL).astype(np.int64) + cs.BL
    cols_out = torch.empty(n, dtype=torch.int32, device=dev)
    table = threshold_table(cs.BL, 100, dev)
    out["f64_codec_only_ms"] = [cs.time_ms(torch, lambda: _call(
        diag.diag_k1_codec_launch, cols_out.data_ptr(), vals_d.data_ptr(), n,
        cs.BL, 100)) for _ in range(2)]
    out["table_codec_only_ms"] = [cs.time_ms(torch, lambda: _call(
        diag.diag_k2_table_codec_launch, cols_out.data_ptr(),
        vals_d.data_ptr(), table.data_ptr(), n, cs.BL, 100))
        for _ in range(2)]
    if not torch.equal(cols_out.cpu().long(), torch.from_numpy(cols)):
        raise AssertionError("K2: the table codec's columns differ")
    masked = torch.from_numpy(cols[ids == 0].astype(np.int32)).to(dev)
    out["smem_atomics_only_ms"] = [cs.time_ms(torch, lambda: _call(
        diag.diag_k2_smem_launch, acc.data_ptr(), masked.data_ptr(),
        masked.shape[0], None, n, cs.B)) for _ in range(2)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_block = n // min(-(-n // 4096), sms * 4)  # the earlier grid's share
    live = torch.from_numpy((np.bincount(cols[:per_block], minlength=cs.B)
                             > 0).astype(np.int32)).to(dev)
    out["live_bins_a_block"] = int(live.sum())
    out["zero_flush_only_ms"] = [cs.time_ms(torch, lambda: _call(
        diag.diag_k2_smem_launch, acc.data_ptr(), masked.data_ptr(), 0,
        live.data_ptr(), n, cs.B)) for _ in range(2)]
    out["bound_ms"] = {"masked": cs.bound_ms(n * 8 + cs.B * 8)[0],
                       "unmasked": cs.bound_ms(n * 4 + cs.B * 8)[0]}

    # the firehose's step at one metric: generation on the card, then K2b
    generate = _make_sample_generator(1, 10.0, 2.0, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)

    def step_old():
        i_d, v_d = generate(gen, cs.FH_BATCH)
        old(acc_old, i_d, v_d)

    def step_new():
        i_d, v_d = generate(gen, cs.FH_BATCH)
        row_ingest_batch(acc, i_d, v_d, cs.BL)

    ids_f, vals_f = generate(gen, cs.FH_BATCH)
    fh = {"metrics": 1, "batch": cs.FH_BATCH,
          "generate_ms": [cs.time_ms(torch, lambda: generate(gen, cs.FH_BATCH),
                                     reps=10) for _ in range(2)],
          "step": in_turns(torch, step_old, step_new, reps=10),
          "k2": in_turns(torch, lambda: old(acc_old, ids_f, vals_f),
                         lambda: row_ingest_batch(acc, ids_f, vals_f, cs.BL))}
    for rev in ("old", "new"):
        step_ms = float(np.mean(fh["step"][f"{rev}_ms"]))
        fh[f"{rev}_k2_share"] = float(np.mean(fh["k2"][f"{rev}_ms"])) / step_ms
        fh[f"{rev}_samples_per_s"] = [cs.FH_BATCH / t * 1e3
                                      for t in fh["step"][f"{rev}_ms"]]
    out["firehose_step"] = fh
    del acc, acc_old, want, cols_out, masked
    torch.cuda.empty_cache()
    return out


def ab_k4(torch, old_fn, diag):
    """K4 on phase k4's band batch and the row-grouped interval: the
    revisions in turns (warm, L2 flushed); then the diagnoses: (b) the
    same triples in a random order, (a) their slots renumbered densely
    into a pool of only the touched pages, (c) a store in place of the
    atomic, and a plain read-modify-write of the same cells (the
    random-access time of these cells), beside the computed sector
    floor."""
    from loghisto_tpu_torch.ops.fold import fold_packed_numpy
    from loghisto_tpu_torch.ops.paged_store import (
        paged_scatter,
        paged_scatter_batch,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED + 4)
    store = cs._paged_store(torch, cs.PAGED_M)
    ids, vals = cs.band_batch(rng, cs.BATCH, cs.PAGED_M)
    shapes = {"band": cs._pad_chunk(store.translate(
        fold_packed_numpy(ids, vals, cs.BL))[0])}
    # phase k4's uniform batch, drawn so that the row-grouped interval
    # below is the phase's own
    rng.integers(0, cs.PAGED_M, cs.BATCH)
    cs.lognormal_values(rng, cs.BATCH)
    shapes["row_grouped"] = cs.row_grouped_triples(torch, rng)
    pool = store._pool
    pool_old = torch.zeros_like(pool)
    pool_p = torch.zeros_like(pool)
    page = pool.shape[1]

    def old(target, d):
        _call(old_fn, target.data_ptr(), d.data_ptr(), d.shape[0],
              target.shape[0], target.shape[1])

    def diag_k4(target, d, store_only):
        _call(diag.diag_k4_launch, target.data_ptr(), d.data_ptr(),
              d.shape[0], target.shape[0], target.shape[1], int(store_only))

    out = {}
    for name, triples in shapes.items():
        d = torch.from_numpy(triples).to(dev)
        for t in (pool, pool_old, pool_p):
            t.zero_()
        paged_scatter(pool, d)
        old(pool_old, d)
        paged_scatter_batch(pool_p, d)
        torch.cuda.synchronize()
        if not (torch.equal(pool, pool_p) and torch.equal(pool_old, pool_p)):
            raise AssertionError(f"K4 {name}: the revisions differ")
        cells = cs.k4_cells(triples, page)
        floor_ms, sectors = cs.sector_floor_ms(cells)
        res = {"triples": len(triples), "touched_cells": len(np.unique(cells)),
               "sectors": sectors, "sector_floor_ms": floor_ms,
               "bound_ms": cs.bound_ms(len(triples) * 12
                                       + len(np.unique(cells)) * 8)[0],
               "warm": in_turns(torch, lambda: old(pool_old, d),
                                lambda: paged_scatter(pool, d)),
               "l2_flushed": in_turns(torch, lambda: old(pool_old, d),
                                      lambda: paged_scatter(pool, d),
                                      timer=cs.time_cold_ms)}
        res["speedup"] = float(np.mean(res["warm"]["old_ms"])) / float(
            np.mean(res["warm"]["new_ms"]))
        # (b) a random order
        shuffled = torch.from_numpy(np.ascontiguousarray(
            triples[rng.permutation(len(triples))])).to(dev)
        res["random_order"] = in_turns(torch, lambda: old(pool_old, shuffled),
                                       lambda: paged_scatter(pool, shuffled))
        # (a) the touched pages renumbered densely: slot k of the sorted
        # touched slots becomes k + 1 (pads keep slot -1)
        live = (triples[:, 0] > 0) & (triples[:, 0] < cs.PAGED_POOL)
        touched, rank = np.unique(triples[live, 0], return_inverse=True)
        dense = triples.copy()
        dense[live, 0] = rank + 1
        dense_d = torch.from_numpy(dense).to(dev)
        small = torch.zeros((len(touched) + 1, page), dtype=torch.int32,
                            device=dev)
        small_old = torch.zeros_like(small)
        res["dense_pool_pages"] = len(touched) + 1
        res["dense_pool"] = in_turns(torch, lambda: old(small_old, dense_d),
                                     lambda: paged_scatter(small, dense_d))
        res["dense_pool_l2_flushed"] = in_turns(
            torch, lambda: old(small_old, dense_d),
            lambda: paged_scatter(small, dense_d), timer=cs.time_cold_ms)
        # (c) a store in place of the atomic; the plain read-modify-write
        res["store_ms"] = [cs.time_ms(torch, lambda: diag_k4(pool_p, d, True))
                           for _ in range(2)]
        res["plain_rmw_ms"] = [cs.time_ms(torch, lambda: diag_k4(pool_p, d,
                                                                 False))
                               for _ in range(2)]
        res["plain_rmw_l2_flushed_ms"] = [cs.time_cold_ms(
            torch, lambda: diag_k4(pool_p, d, False)) for _ in range(2)]
        out[name] = res
        del small, small_old
    del store, pool, pool_old, pool_p
    torch.cuda.empty_cache()
    return out


def ab_k7(torch, old_fn):
    """K7 at phase k7's 1024 x 8193 inputs."""
    from loghisto_tpu_torch.ops.anomaly import (
        divergence_kernel,
        divergence_plain,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 8)
    cdf, counts, prof, wsum = cs._drift_inputs(torch, cs.RET_M, gen, 64)
    args = (cdf, counts, prof[1], wsum[1], 64)
    m, b = cdf.shape
    out_old = torch.empty((3, m), dtype=torch.float32, device="cuda")

    def old():
        _call(old_fn, cdf.data_ptr(), counts.data_ptr(), prof[1].data_ptr(),
              wsum[1].data_ptr(), out_old.data_ptr(), m, m, b, 64)

    old()
    new = divergence_kernel(*args)
    plain = divergence_plain(*args)
    torch.cuda.synchronize()
    errs = {}
    for rev, got in (("old", dict(zip(("ks", "jsd", "emd"), out_old))),
                     ("new", new)):
        errs[rev], ok = cs._close(
            {k: v.cpu().numpy() for k, v in got.items()},
            {k: v.cpu().numpy() for k, v in plain.items()}, cs.K7_TOL)
        if not ok:
            raise AssertionError(f"K7 {rev}: outside K7_TOL: {errs[rev]}")
    unmasked = int(((counts >= 64) & (wsum[1] > 0)).sum())
    out = in_turns(torch, old, lambda: divergence_kernel(*args))
    out.update(max_err_vs_plain=errs,
               bound_ms=cs.bound_ms(unmasked * b * 8 + m * 20)[0])
    del cdf, counts, prof, wsum, out_old
    torch.cuda.empty_cache()
    return out


def ab_k3(torch, old_fn):
    """K3 at phase k3's batch (one target, the L2 as the table leaves it
    and flushed before each launch), then at the fused commit's shape:
    one launch into five targets against five earlier launches."""
    from loghisto_tpu_torch.ops.fold import fold_packed_numpy
    from loghisto_tpu_torch.ops.sparse_ingest import (
        sparse_ingest,
        sparse_ingest_multi,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED + 3)
    n = 1 << 22
    packed = torch.from_numpy(fold_packed_numpy(
        cs.zipf_ids(rng, n, cs.M), cs.lognormal_values(rng, n),
        cs.BL)).to(dev)
    acc = torch.zeros((cs.M, cs.B), dtype=torch.int32, device=dev)
    acc_old = torch.zeros_like(acc)

    def old_into(target, p):
        _call(old_fn, target.data_ptr(), p.data_ptr(), p.shape[0],
              target.shape[0], cs.B, cs.BL)

    old_into(acc_old, packed)
    sparse_ingest(acc, packed, cs.BL)
    torch.cuda.synchronize()
    if not torch.equal(acc, acc_old):
        raise AssertionError("K3: the revisions differ on one target")
    out = {"triples": packed.shape[0],
           "one_target": in_turns(torch, lambda: old_into(acc_old, packed),
                                  lambda: sparse_ingest(acc, packed, cs.BL)),
           "one_target_l2_flushed": in_turns(
               torch, lambda: old_into(acc_old, packed),
               lambda: sparse_ingest(acc, packed, cs.BL),
               timer=cs.time_cold_ms)}
    del acc, acc_old

    chunk = torch.from_numpy(cs._commit_chunk_cells(rng)).to(dev)
    new_t = [torch.zeros((cs.RET_M, cs.B), dtype=torch.int32, device=dev)
             for _ in range(5)]
    old_t = [torch.zeros_like(t) for t in new_t]

    def old_five():
        for t in old_t:
            old_into(t, chunk)

    old_five()
    sparse_ingest_multi(new_t, chunk, cs.BL)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(new_t, old_t)):
        raise AssertionError("K3: one multi-target launch != five launches")
    five = in_turns(torch, old_five,
                    lambda: sparse_ingest_multi(new_t, chunk, cs.BL))
    five["new_five_one_target_ms"] = [cs.time_ms(torch, lambda: [
        sparse_ingest(t, chunk, cs.BL) for t in new_t]) for _ in range(2)]
    five["speedup"] = float(np.mean(five["old_ms"])) / float(
        np.mean(five["new_ms"]))
    out["commit_chunk_five_targets"] = {"triples": chunk.shape[0], **five}
    del new_t, old_t
    torch.cuda.empty_cache()
    return out


def ab_k4f(torch, old_fn):
    from loghisto_tpu_torch.ops.fused_ingest import fused_paged_ingest_batch
    from loghisto_tpu_torch.ops.paged_store import paged_scatter

    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED + 5)
    store = cs._paged_store(torch, cs.PAGED_M)
    rows = cs.PAGED_M - 1000
    band_ids, band_vals = cs.band_batch(rng, cs.BATCH, rows)
    uni_ids = rng.integers(0, rows, cs.BATCH).astype(np.int32)
    uni_vals = cs.lognormal_values(rng, cs.BATCH)
    batches = {
        "band": (store.prepare_batch(band_ids, band_vals)[0], band_vals),
        "uniform": (store.prepare_batch(uni_ids, uni_vals)[0], uni_vals),
    }
    rc, enc, page_major = store.device_luts()
    row_major = page_major.t().contiguous()
    pool = store._pool
    scratch = torch.zeros_like(pool)
    ppr, m = page_major.shape

    def old(i_d, v_d, target):
        _call(old_fn, target.data_ptr(), i_d.data_ptr(), v_d.data_ptr(),
              i_d.shape[0], rc.data_ptr(), enc.data_ptr(),
              row_major.data_ptr(), m, enc.shape[0], ppr, target.shape[0],
              target.shape[1], cs.BL, 100)

    out = {}
    for name, (ids, vals) in batches.items():
        i_d = torch.from_numpy(ids).to(dev)
        v_d = torch.from_numpy(vals).to(dev)
        pool.zero_()
        scratch.zero_()
        fused_paged_ingest_batch(pool, i_d, v_d, rc, enc, page_major, cs.BL)
        old(i_d, v_d, scratch)
        torch.cuda.synchronize()
        if not torch.equal(pool, scratch):
            raise AssertionError(f"K4f {name}: the revisions differ")
        cells, _ = cs._k4f_cells(store, ids, vals)
        packed = torch.from_numpy(np.ascontiguousarray(np.stack(
            [cells // 256, cells % 256, np.ones_like(cells)],
            axis=1).astype(np.int32))).to(dev)
        times = in_turns(
            torch, lambda: old(i_d, v_d, scratch),
            lambda: fused_paged_ingest_batch(pool, i_d, v_d, rc, enc,
                                             page_major, cs.BL))
        times["k4_same_cells_ms"] = [
            cs.time_ms(torch, lambda: paged_scatter(scratch, packed))
            for _ in range(2)]
        k4 = float(np.mean(times["k4_same_cells_ms"]))
        times["old_ratio_to_k4"] = float(np.mean(times["old_ms"])) / k4
        times["new_ratio_to_k4"] = float(np.mean(times["new_ms"])) / k4
        out[name] = times
    del store, pool, scratch
    torch.cuda.empty_cache()
    return out


def ab_k5(torch, old_fn):
    from loghisto_tpu_torch.ops.window import (
        window_merge_kernel,
        window_merge_views,
    )
    from loghisto_tpu_torch.window.store import trailing_mask

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 6)
    s, mb = cs.RET_TIERS[0][0], cs.RET_M * cs.B
    ring = torch.randint(0, 1 << 16, (s, cs.RET_M, cs.B), dtype=torch.int32,
                         device=dev, generator=gen)
    written = np.ones(s, bool)
    views = np.stack([trailing_mask(written, np.ones(s), 2, 0, s, w)
                      for w in cs.RET_VIEW_WINDOWS])
    slot_lists = [np.ascontiguousarray(np.flatnonzero(v), dtype=np.int32)
                  for v in views]
    out_old = torch.empty((len(views), cs.RET_M, cs.B), dtype=torch.int32,
                          device=dev)

    def old_views():
        for k, idx in enumerate(slot_lists):
            _call(old_fn, out_old[k].data_ptr(), ring.data_ptr(),
                  idx.ctypes.data, len(idx), s, mb)

    old_views()
    new = window_merge_views(ring, views)
    torch.cuda.synchronize()
    if not torch.equal(new, out_old):
        raise AssertionError("K5: the revisions differ on the six views")
    all_mask = np.ones(s, bool)
    out = {
        "six_views": in_turns(torch, old_views,
                              lambda: window_merge_views(ring, views)),
        "all_slots": in_turns(torch, lambda: _call(
            old_fn, out_old[0].data_ptr(), ring.data_ptr(),
            slot_lists[0].ctypes.data, s, s, mb),
            lambda: window_merge_kernel(ring, all_mask)),
    }
    out["all_slots"]["library_ms"] = [
        cs.time_ms(torch, lambda: ring.sum(0, dtype=torch.int32))
        for _ in range(2)]
    out["six_views"]["bound_ms"] = cs.bound_ms((s + len(views)) * mb * 4)[0]
    out["all_slots"]["bound_ms"] = cs.bound_ms((s + 1) * mb * 4)[0]
    del ring, out_old, new
    torch.cuda.empty_cache()
    return out


# K8 and K2 design variants: the package's own source with one choice
# changed by a text edit, built beside it ("designs").  A variant marked
# timing-only computes a wrong result on purpose (it adds into the
# block's own shared memory in place of the owner's, or skips the
# histogram's flush) and is never compared.
_MATCH_HIST = """          const unsigned peers = __match_any_sync(0xffffffffu, key);
          if (ok && (threadIdx.x & 31) == __ffs(peers) - 1) {
            int* owner = cluster.map_shared_rank(hist, bb[e] % kCluster);
            atomicAdd(owner + rr[e] * hist_row + bb[e] / kCluster, __popc(peers));
          }"""
_DIRECT = """          if (cell >= 0) atomicAdd(acc + cell, 1);"""
_DIRECT_FOLD = """          const unsigned peers = __match_any_sync(0xffffffffu, cell);
          if (cell >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
            atomicAdd(acc + cell, __popc(peers));
          }"""
_TWO_AN_SM = [("kBlocksPerSm = 4;", "kBlocksPerSm = 2;"),
              ("kInFlight = 1;", "kInFlight = 4;")]
_RED_PTX = """            int* owner = cluster.map_shared_rank(hist, bb[e] % kCluster);
            atomicAdd(owner + rr[e] * hist_row + bb[e] / kCluster, __popc(peers));"""
K8_DESIGNS = {
    "kernel": [],
    "direct_fold": [(_DIRECT, _DIRECT_FOLD)],
    "hist_no_fold": [(_MATCH_HIST, """          if (ok) {
            int* owner = cluster.map_shared_rank(hist, bb[e] % kCluster);
            atomicAdd(owner + rr[e] * hist_row + bb[e] / kCluster, 1);
          }""")],
    "hist_red_ptx": [(_RED_PTX, """            unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(
                hist + rr[e] * hist_row + bb[e] / kCluster));
            unsigned remote;
            asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                         : "=r"(remote) : "r"(a), "r"(bb[e] % kCluster));
            asm volatile("red.shared::cluster.add.u32 [%0], %1;"
                         :: "r"(remote), "r"(__popc(peers)) : "memory");""")],
    "hist_local_timing_only": [(
        "cluster.map_shared_rank(hist, bb[e] % kCluster)", "hist")],
    "no_flush_timing_only": [("if (v) atomicAdd(acc", "if (v == -7) atomicAdd(acc")],
    "all_direct": [("const bool use = hist_ok &&", "const bool use = false &&")],
    "run_min_8": [("kRunMin = 32;", "kRunMin = 8;")],
    "run_min_16": [("kRunMin = 32;", "kRunMin = 16;")],
    "run_min_24": [("kRunMin = 32;", "kRunMin = 24;")],
    "piece_run_min_8": [("kRunMin = 32;", "kRunMin = 8;"),
                        ("p.whole >= kRunMin", "p.end - p.start >= kRunMin")],
    "in_flight_2": [("kInFlight = 1;", "kInFlight = 2;")],
    **{f"min_span_{k}": [("kMinSpan = 16;", f"kMinSpan = {k};")]
       for k in (8, 24, 32)},
    "2_an_sm_in_flight_4": _TWO_AN_SM,
    "2_an_sm_in_flight_4_direct_fold": [*_TWO_AN_SM, (_DIRECT, _DIRECT_FOLD)],
}
K2_DESIGNS = {
    "kernel": [],
    "1_an_sm": [("kBlocksPerSm = 2;", "kBlocksPerSm = 1;")],
    "4_an_sm": [("kBlocksPerSm = 2;", "kBlocksPerSm = 4;")],
    "unroll_2": [("kUnroll = 1;", "kUnroll = 2;")],
    "unroll_4": [("kUnroll = 1;", "kUnroll = 4;")],
}


def build_designs(source, designs, symbol, argtypes):
    """One library a design of csrc/<source>, built in parallel; returns
    {design: entry point}."""
    from loghisto_tpu_torch.ops import _build

    text = (_build.CSRC / source).read_text()
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in designs.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"design {name}: {old!r} not in {source}")
            src = src.replace(old, new)
        path = out_dir / f"design_{Path(source).stem}_{name}.cu"
        path.write_text(src)
        lib = path.with_suffix(".so")
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on design {name}:\n{err}")
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def designs(torch, diag):
    """K8's and K2's design variants timed in turns at the A/B shapes:
    K8 on Zipf and uniform batches at M = 16, 256 and 10,000, K2b and
    K2a on phase k2's 2^22 batch and K2b over a range of N (its fixed
    cost)."""
    from loghisto_tpu_torch.ops.multirow_ingest import (
        ROWS_TILE,
        SAMPLE_TILE,
        multirow_ingest_reference,
        preprocess,
    )
    from loghisto_tpu_torch.ops.row_ingest import (
        device_blocks,
        histogram_row_reference,
        threshold_table,
    )

    dev = torch.device("cuda")
    k8 = build_designs("multirow_ingest.cu", K8_DESIGNS, "lh_multirow_ingest",
                       OLD_ENTRIES["k8"][2])
    k2 = build_designs("row_ingest.cu", K2_DESIGNS, "lh_row_ingest",
                       [_P, _P, _P, _P, _LL, _I, _I, _I, _P])
    out = {"k8": {}, "k2": {}}
    for m in (16, 256, cs.M):
        batches = cs._k8_batches(np.random.default_rng(cs.SEED + 80 + m), m)
        for name in ("zipf", "uniform"):
            ids, vals = batches[name]
            rows, bidx, tb = preprocess(torch.from_numpy(ids).to(dev),
                                        torch.from_numpy(vals).to(dev), m,
                                        ROWS_TILE, cs.BL)
            want = torch.zeros((m, cs.B), dtype=torch.int32, device=dev)
            multirow_ingest_reference(want, rows, bidx, tb, ROWS_TILE)
            acc = torch.zeros_like(want)
            res = {}
            for design, fn in k8.items():
                def run(fn=fn, rows=rows, bidx=bidx, tb=tb, acc=acc, m=m):
                    _call(fn, acc.data_ptr(), rows.data_ptr(),
                          bidx.data_ptr(), tb.data_ptr(), rows.shape[0],
                          SAMPLE_TILE, ROWS_TILE, m, cs.B)
                acc.zero_()
                run()
                torch.cuda.synchronize()
                if "timing_only" not in design and not torch.equal(acc, want):
                    raise AssertionError(f"K8 design {design} differs")
                res[design] = run
            times = {d: [] for d in res}
            for order in (list(res), list(res)[::-1]):
                for d in order:
                    times[d].append(cs.time_ms(torch, res[d]))
            out["k8"][f"{m}/{name}"] = times
            del want, acc
    rng = np.random.default_rng(cs.SEED + 2)
    n = 1 << 22
    vals = torch.from_numpy(cs.lognormal_values(rng, n)).to(dev)
    ids = torch.from_numpy(np.where(rng.random(n) < 0.1, rng.integers(
        -1, 3, n), 0).astype(np.int32)).to(dev)
    table = threshold_table(cs.BL, 100, dev)
    acc = torch.zeros(cs.B, dtype=torch.int32, device=dev)
    want = torch.zeros_like(acc)
    for label, i_d, count in (("masked", ids, n), ("unmasked", None, n),
                              *((f"masked_n=2^{k}", ids, 1 << k)
                                for k in (12, 16, 18, 20))):
        runs = {}
        for design, fn in k2.items():
            def run(fn=fn, i_d=i_d, count=count):
                _call(fn, acc.data_ptr(),
                      None if i_d is None else i_d.data_ptr(),
                      vals.data_ptr(), table.data_ptr(), count, cs.B, cs.BL,
                      100)
            acc.zero_()
            want.zero_()
            run()
            histogram_row_reference(want, vals[:count], cs.BL, 100,
                                    None if i_d is None else i_d[:count])
            torch.cuda.synchronize()
            if not torch.equal(acc, want):
                raise AssertionError(f"K2 design {design} differs")
            runs[design] = run
        times = {d: [] for d in runs}
        for order in (list(runs), list(runs)[::-1]):
            for d in order:
                times[d].append(cs.time_ms(torch, runs[d]))
        out["k2"][label] = times
    # the launch floor: an empty kernel on K2's grid, with and without
    # clusters of 8
    blocks = device_blocks(n, cs.B)
    out["empty_kernel_ms"] = {
        f"{blocks}_blocks_clusters_of_{c}": [cs.time_ms(torch, lambda c=c: _call(
            diag.diag_empty_launch, blocks, c)) for _ in range(2)]
        for c in (1, 8)}
    return out


def main() -> int:
    import torch

    names = sys.argv[2:] or ["k8", "k2"]
    if (len(sys.argv) < 2 or not torch.cuda.is_available()
            or set(names) - set(OLD_ENTRIES) - {"designs"}):
        print(__doc__, file=sys.stderr)
        return 2
    old = build_old(Path(sys.argv[1]), names)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    with_diag = {"k1": ab_k1, "k4": ab_k4, "k8": ab_k8, "k2": ab_k2}
    runs = {"k7": ab_k7, "k3": ab_k3, "k4f": ab_k4f, "k5": ab_k5}
    for name in names:
        if name == "designs":
            res = designs(torch, old["diag"])
        elif name in with_diag:
            res = with_diag[name](torch, old[name], old["diag"])
        else:
            res = runs[name](torch, old[name])
        cs.emit({"ab": name, "card": card, **res})
    return 0


if __name__ == "__main__":
    sys.exit(main())
