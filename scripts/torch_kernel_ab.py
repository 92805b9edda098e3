#!/usr/bin/env python3
"""Time the port's kernels against an earlier revision of the same
kernels, in one process on one NVIDIA card, in turns (old, new, new,
old), at the shapes of chip_smoke.py.

    git archive <rev> loghisto_tpu_torch/csrc | tar -x -C build/ab_parent
    python3 scripts/torch_kernel_ab.py build/ab_parent [k7 k3 k4f k5]

The earlier sources are built with the same nvcc flags as the package's
own (``ops/_build.py``) into ``build/ab/``.  Each comparison calls the
earlier entry point with that revision's signature:

  * ``k7`` and ``k3`` (the default) take the revision before K7's
    streamed rows and K3's multi-target launch (98f588e): K7
    ``lh_divergence`` staging a whole row in shared memory, K3
    ``lh_sparse_ingest`` with one target and one thread a triple.  K3
    is timed at phase k3's batch with the L2 as the table leaves it and
    flushed before each launch, and at the fused commit's shape: one
    launch into five targets against five earlier launches.
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
    "k7": ("divergence.cu", "lh_divergence",
           [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "k3": ("sparse_ingest.cu", "lh_sparse_ingest",
           [_P, _P, _LL, _I, _I, _I, _P]),
    "k4f": ("paged_store.cu", "lh_fused_paged_ingest",
            [_P, _P, _P, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "k5": ("window_merge.cu", "lh_window_merge",
           [_P, _P, _P, _I, _I, _LL, _P]),
}


def build_old(parent: Path, names) -> dict:
    """The earlier entry points of ``names``, one nvcc per source, all
    started together."""
    from loghisto_tpu_torch.ops import _build

    csrc = parent / "loghisto_tpu_torch" / "csrc"
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        source = OLD_ENTRIES[name][0]
        lib = out_dir / f"old_{Path(source).stem}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(lib), str(csrc / source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        source, symbol, argtypes = OLD_ENTRIES[name]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the earlier {source}:\n{err}")
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
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


def main() -> int:
    import torch

    names = sys.argv[2:] or ["k7", "k3"]
    if (len(sys.argv) < 2 or not torch.cuda.is_available()
            or set(names) - set(OLD_ENTRIES)):
        print(__doc__, file=sys.stderr)
        return 2
    old = build_old(Path(sys.argv[1]), names)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    runs = {"k7": ab_k7, "k3": ab_k3, "k4f": ab_k4f, "k5": ab_k5}
    for name in names:
        cs.emit({"ab": name, "card": card, **runs[name](torch, old[name])})
    return 0


if __name__ == "__main__":
    sys.exit(main())
