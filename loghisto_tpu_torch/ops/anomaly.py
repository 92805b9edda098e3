"""Device steps of the distribution drift engine: the EWMA baseline
banks and the per-row drift scores, K7 (counterpart of
``loghisto_tpu/ops/anomaly.py``).

  * ``ewma_bank_update`` — one EWMA step of the active bank from the
    completed interval histogram: plain float32 tensor code in the
    reference's order of operations, run by the fused commit's final
    step, in place.
  * ``divergence_scores`` — each row's live window CDF (the snapshot
    payload) against its bias-corrected baseline pmf: Kolmogorov-Smirnov
    distance, Jensen-Shannon divergence (log2, in [0, 1]) and
    bucket-space earth-mover's distance, exactly 0 below the min-sample
    floor or without a baseline.  On a CUDA tensor it launches K7
    (``csrc/divergence.cu``, ``divergence_kernel`` in place of
    ``divergence_pallas``) on a view of the bank's rows; on a CPU tensor
    it takes the plain version (``_row_divergence`` and the floor mask).
    The kernel's block scan sums in another order than the plain
    ``cumsum``, so the two agree within a float32 tolerance.
  * ``make_bank_evict_fn`` / ``make_bank_compact_fn`` — victims' bank
    rows zeroed in place; the survivor permutation applied to every bank
    carry through K6 (the same row gather over 4-byte elements).

On a ("stream", "metric") mesh (ROADMAP D10) a rank holds the bank
block of its accumulator rows (``[K, M / n_metric, B]``) and scores its
view block (the ring rows, ``[M_w / n_metric, B]``):
``make_sharded_bank_compact_fn`` moves crossing bank rows like the
rings (``parallel/mesh.RowMove``, K6 on each block), and
``make_sharded_divergence_fn`` runs K7 on the rank's view block against
the bank rows of the same global rows (fetched from their ranks when
growth made the accumulator's blocks larger than the wheel's), then one
``all_gather`` over the metric axis gives every rank the ``[M_w]``
scores.

Definitions, in dense bucket space:

  ks  = max_b |F_live(b) - F_base(b)|            in [0, 1]
  emd = sum_b |F_live(b) - F_base(b)|            bucket-index units
  jsd = JS divergence of the pmfs, log base 2    in [0, 1]
"""

from __future__ import annotations

import numpy as np
import torch

from loghisto_tpu_torch.ops.backend import is_plain, launch, to_device
from loghisto_tpu_torch.ops.lifecycle import compact_rows_kernel
from loghisto_tpu_torch.parallel.mesh import (
    METRIC_AXIS,
    RowMove,
    axis_size,
    gather_parts,
)

DIVERGENCE_PATH_RULE = (
    "the drift scores follow the tensors' device, as every kernel wrapper "
    "of the port does: CUDA tensors launch K7 (csrc/divergence.cu) and CPU "
    "tensors take the plain version (ROADMAP D4); pass "
    "divergence_path='auto'"
)

SCORE_KEYS = ("ks", "jsd", "emd")


def ewma_bank_update(banks, ihist, bank, decay, min_count):
    """One EWMA step of bank ``bank`` (host int) from the interval
    histogram ``ihist`` int32 [M, B], in place on ``banks = (prof f32
    [K, M, B], wsum f32 [K, M])``; rows with fewer than ``min_count``
    interval samples keep their baseline.  ``prof / wsum`` stays a
    bias-corrected pmf.  Returns ``banks``."""
    prof, wsum = banks
    decay = float(np.float32(decay))
    gain = float(np.float32(1.0) - np.float32(decay))
    counts = ihist.sum(dim=1, dtype=torch.int32)
    upd = counts >= int(min_count)
    tot = torch.clamp(counts, min=1).to(torch.float32)[:, None]
    pmf = ihist.to(torch.float32) / tot
    old_p = prof[int(bank)]
    old_w = wsum[int(bank)]
    old_p.copy_(torch.where(upd[:, None], decay * old_p + gain * pmf, old_p))
    old_w.copy_(torch.where(upd, decay * old_w + gain, old_w))
    return prof, wsum


def _row_divergence(cdf, counts, prof, w):
    """Raw per-row scores (no floor mask): cdf int32 [R, B], counts
    int32 [R], prof f32 [R, B], w f32 [R] -> (ks, jsd, emd), f32 [R]
    each."""
    total = torch.clamp(counts, min=1).to(torch.float32)[:, None]
    live_cdf = cdf.to(torch.float32) / total
    # exact integer bin counts first, divide after
    bins = cdf - torch.cat([torch.zeros_like(cdf[:, :1]), cdf[:, :-1]], 1)
    live_pmf = bins.to(torch.float32) / total
    base_pmf = prof / torch.clamp(w, min=1e-30)[:, None]
    base_cdf = torch.cumsum(base_pmf, dim=1)
    diff = torch.abs(live_cdf - base_cdf)
    ks = diff.amax(dim=1)
    emd = diff.sum(dim=1)
    mid = 0.5 * (live_pmf + base_pmf)

    def kl_to_mid(p):
        # 0 * log(0) := 0; where p > 0, mid >= p / 2 > 0 — unless p is
        # the smallest subnormal and p / 2 rounds to 0: that term (below
        # 1e-44) is skipped too, where the quotient would be infinite
        return torch.where((p > 0) & (mid > 0), p * torch.log2(p / mid),
                           torch.zeros_like(p)).sum(dim=1)

    jsd = 0.5 * (kl_to_mid(live_pmf) + kl_to_mid(base_pmf))
    return ks, jsd, emd


def divergence_plain(cdf, counts, prof, w, min_samples):
    """Plain version of the scoring pass over one bank's rows (prof
    [Mb, B], w [Mb]): the bank padded or cut to the view's M rows (rows
    past the bank have no baseline), ``_row_divergence``, and the floor
    mask (counts >= min_samples and w > 0), which gives exact zeros."""
    m, mb = cdf.shape[0], prof.shape[0]
    if mb < m:
        prof = torch.nn.functional.pad(prof, (0, 0, 0, m - mb))
        w = torch.nn.functional.pad(w, (0, m - mb))
    else:
        prof, w = prof[:m], w[:m]
    ks, jsd, emd = _row_divergence(cdf, counts, prof, w)
    valid = (counts >= int(min_samples)) & (w > 0)
    zero = torch.zeros((), dtype=torch.float32, device=cdf.device)
    return {
        "ks": torch.where(valid, ks, zero),
        "jsd": torch.where(valid, jsd, zero),
        "emd": torch.where(valid, emd, zero),
    }


def _check_scores(cdf, counts, prof, w):
    if cdf.ndim != 2 or cdf.dtype != torch.int32:
        raise ValueError(f"cdf must be int32 [M, B]; got {cdf.dtype} "
                         f"{tuple(cdf.shape)}")
    if counts.shape != cdf.shape[:1] or counts.dtype != torch.int32:
        raise ValueError("counts must be int32 [M]")
    if (prof.ndim != 2 or prof.shape[1] != cdf.shape[1]
            or prof.dtype != torch.float32):
        raise ValueError(f"prof must be float32 [Mb, {cdf.shape[1]}]")
    if w.shape != prof.shape[:1] or w.dtype != torch.float32:
        raise ValueError("w must be float32 [Mb]")
    if len({t.device for t in (cdf, counts, prof, w)}) != 1:
        raise ValueError("cdf, counts, prof and w must share one device")


def divergence_kernel(cdf, counts, prof, w, min_samples):
    """Kernel wrapper, same contract as ``divergence_plain``: K7 on CUDA
    tensors (one block per row, the bank rows read in place), the plain
    version on CPU tensors.  Returns {"ks", "jsd", "emd"}, f32 [M]."""
    _check_scores(cdf, counts, prof, w)
    if is_plain(cdf, "divergence"):
        return divergence_plain(cdf, counts, prof, w, min_samples)
    for name, t in (("cdf", cdf), ("counts", counts), ("prof", prof),
                    ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (K7 indexes it "
                             "flat)")
    m, b = cdf.shape
    out = torch.empty((3, m), dtype=torch.float32, device=cdf.device)
    launch("divergence", cdf.data_ptr(), counts.data_ptr(), prof.data_ptr(),
           w.data_ptr(), out.data_ptr(), m, prof.shape[0], b,
           int(min_samples))
    return dict(zip(SCORE_KEYS, out))


def resolve_divergence_path(path: str) -> str:
    """The port's scoring dispatch: only "auto" (the tensors' device
    decides); the reference's "jnp"/"pallas" values raise with the
    rule."""
    if path != "auto":
        raise ValueError(f"divergence_path={path!r}: {DIVERGENCE_PATH_RULE}")
    return path


def divergence_scores(cdf, counts, prof, wsum, bank, min_samples):
    """The scoring pass: live view CDF (int32 [M, B]) and totals (int32
    [M]) against bank ``bank`` of ``prof`` f32 [K, Mb, B] / ``wsum`` f32
    [K, Mb].  ``prof[bank]`` is a view, not a copy."""
    return divergence_kernel(cdf, counts, prof[int(bank)],
                             wsum[int(bank)], min_samples)


def make_sharded_divergence_fn(mesh, path: str = "auto"):
    """``make_divergence_fn`` for one rank of a ("stream", "metric")
    mesh: ``div(cdf, counts, prof, wsum, bank, min_samples)`` with the
    rank's view block (cdf int32 ``[M_w / n_metric, B]``, counts) and
    bank block (prof f32 ``[K, M / n_metric, B]``, wsum), returning
    every rank the scores of all ``M_w`` rows.  Where the blocks differ
    (the accumulator grew past the wheel's rows) the bank rows of the
    view block's global rows come from their ranks first (a
    ``RowMove``, K6 on the rows kept).  K7 on the rank's block, then one
    ``all_gather`` over the metric axis: a collective of the metric
    line."""
    resolve_divergence_path(path)

    def div(cdf, counts, prof, wsum, bank, min_samples):
        p, w = prof[int(bank)], wsum[int(bank)]
        rows = cdf.shape[0]
        if p.shape[0] != rows:
            move = RowMove(mesh, np.arange(axis_size(mesh, METRIC_AXIS)
                                           * rows), p.shape[0], rows)
            p = move.apply(p, 0, compact_rows_kernel)
            w = move.apply(w[:, None], 0, compact_rows_kernel)[:, 0]
        scores = divergence_kernel(cdf, counts, p, w, min_samples)
        whole = gather_parts(mesh, torch.stack([scores[k]
                                                for k in SCORE_KEYS]),
                             METRIC_AXIS, dim=1)
        return dict(zip(SCORE_KEYS, whole.to(cdf.device)))

    return div


def make_divergence_fn(path: str = "auto"):
    """``div(cdf, counts, prof, wsum, bank, min_samples) -> {"ks",
    "jsd", "emd"}`` — the drift engine's one scoring pass per interval.
    Nothing is written: the snapshot payloads back lock-free queries."""
    resolve_divergence_path(path)
    return divergence_scores


# -- lifecycle integration: bank eviction + compaction ------------------- #


def make_bank_evict_fn():
    """``evict(prof, wsum, ihist, victims) -> (prof, wsum, ihist)``:
    zero the victims' baselines (every bank) and interval-histogram
    rows, in place; victims past a carry's rows (DROP_ID pads) change
    nothing.  A freed row's next tenant builds its baseline from
    scratch."""

    def evict(prof, wsum, ihist, victims):
        v = np.asarray(victims, dtype=np.int64)
        dev = prof.device
        vb = to_device(v[(v >= 0) & (v < prof.shape[1])], dev)
        prof.index_fill_(1, vb, 0.0)
        wsum.index_fill_(1, vb, 0.0)
        vi = to_device(v[(v >= 0) & (v < ihist.shape[0])], dev)
        ihist.index_fill_(0, vi, 0)
        return prof, wsum, ihist

    return evict


def make_bank_compact_fn():
    """``compact(prof, wsum, ihist, perm) -> (prof, wsum, ihist)``: the
    lifecycle's survivor permutation (``perm[new] = old``, host int32;
    holes give zero rows) applied to every bank carry through K6 — fresh
    tensors, so baselines follow their rows and freed rows come back
    cold."""

    def compact(prof, wsum, ihist, perm):
        perm_t = to_device(np.asarray(perm, dtype=np.int32), prof.device)
        mb, mi = prof.shape[1], ihist.shape[0]
        prof = compact_rows_kernel(prof, perm_t[:mb])
        wsum = compact_rows_kernel(wsum[:, :, None], perm_t[:mb])[:, :, 0]
        ihist = compact_rows_kernel(ihist, perm_t[:mi])
        return prof, wsum, ihist

    return compact


def make_sharded_bank_compact_fn(mesh):
    """``make_bank_compact_fn`` for one rank of a ("stream", "metric")
    mesh: ``compact(prof, wsum, ihist, perm) -> (prof, wsum, ihist,
    bytes_sent)`` on the rank's bank blocks (the accumulator's rows)
    with the global ``perm``: K6 on each block with the rows it keeps,
    the crossing rows from their ranks (``RowMove``).  A collective of
    the metric line."""

    def compact(prof, wsum, ihist, perm):
        rows = prof.shape[1]
        move = RowMove(mesh, perm, rows, rows)
        prof = move.apply(prof, 1, compact_rows_kernel)
        wsum = move.apply(wsum[:, :, None], 1, compact_rows_kernel)[:, :, 0]
        ihist = move.apply(ihist, 0, compact_rows_kernel)
        return prof, wsum, ihist, move.bytes_sent

    return compact
