"""t-digest sketch as static-shape PyTorch ops (counterpart of
``loghisto_tpu/models/tdigest.py``).

Dunning's merging t-digest in fixed-size arrays ``means[C], weights[C]``
(unused slots weight 0).  A batch insert is

    concatenate -> stable sort by mean -> k-scale clustering -> segment sum

with no data-dependent control flow, so ``torch.func.vmap`` runs insert,
quantile and estimate over stacked sketches with no host sync.  The k1
scale ``k(q) = (delta / 2pi) * asin(2q - 1)`` bounds the cluster count by
~delta while keeping tail clusters small.

Where the reference differs from PyTorch:
  * ``lax.cond`` between the small-N branch (every centroid a singleton,
    exact) and the clustering branch becomes a ``torch.where`` of both;
  * ``jax.ops.segment_sum`` becomes a segmented scan: cluster ids are
    nondecreasing in sorted order, so every cluster is one contiguous
    run, summed by a log-depth scan in a fixed order (CUDA's
    ``index_add_`` adds floats in no fixed order).  A singleton's sum is
    its own value, so the extreme singletons keep the observed min and
    max exactly;
  * ``_pad_pow2`` existed for jit's compile cache and is gone: weight-0
    entries sort last and change no result.
Below capacity the digest equals the reference bit for bit.  Above it,
the floored k-scale of a centroid at a cluster edge can land on the
other side (the two frameworks' float32 ``asin`` and sums round
differently), so total weight, min and max are exact and quantiles agree
within a tolerance.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from loghisto_tpu_torch.ops.backend import resolve_device

_F32_MAX = torch.finfo(torch.float32).max


@dataclasses.dataclass(frozen=True)
class TDigestConfig:
    # 512 centroid slots (static shape): 4 KB of state, the reference's
    # default (its heavy-tail p9999 bound holds at 512 with the
    # power-law tail interpolation)
    capacity: int = 512
    # compression parameter; the k1 scale spans delta/2 clusters, so the
    # default fills ~80% of capacity (delta = 1.6 * capacity)
    delta: float = 0.0  # 0 -> derived from capacity

    def __post_init__(self):
        if self.capacity < 16:
            raise ValueError("capacity must be >= 16")
        if self.delta == 0.0:
            # fill ~80% of capacity, bounded so the two reserved extreme
            # singleton slots (+1 rounding slot) always fit
            object.__setattr__(
                self,
                "delta",
                min(1.6 * self.capacity, 2.0 * (self.capacity - 3)),
            )
        if self.delta < 8:
            raise ValueError("delta must be >= 8")
        if self.delta / 2 + 3 > self.capacity:
            raise ValueError(
                f"delta={self.delta} needs ~{int(self.delta // 2) + 3} "
                f"cluster slots, more than capacity={self.capacity}"
            )


def empty(config: TDigestConfig = TDigestConfig(), device=None):
    """(means, weights) of an empty digest on ``device`` (default the
    card)."""
    dev = resolve_device(device)
    return (
        torch.zeros(config.capacity, dtype=torch.float32, device=dev),
        torch.zeros(config.capacity, dtype=torch.float32, device=dev),
    )


def _k_scale(q: torch.Tensor, delta: float) -> torch.Tensor:
    q = torch.clamp(q, 0.0, 1.0)
    return (delta / (2.0 * math.pi)) * torch.asin(2.0 * q - 1.0)


def _segment_scan(x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Inclusive sum of ``x`` within runs of equal ``seg`` (runs are
    contiguous): a Hillis-Steele scan, log2(n) steps in a fixed order."""
    n = x.shape[-1]
    d = 1
    while d < n:
        same = seg[d:] == seg[:-d]
        add = torch.where(same, x[:-d], torch.zeros_like(x[:-d]))
        x = torch.cat([x[:d], x[d:] + add])
        d *= 2
    return x


def _compress(means, weights, capacity: int, delta: float):
    """Cluster sorted centroids by k-scale index and reduce each cluster.

    The lowest and highest populated entries are forced into their own
    singleton clusters (slots 0 and capacity-1) — Dunning's extreme-
    centroid rule — so the observed min and max survive every
    compression exactly, and tail quantiles interpolate toward the true
    max."""
    total = torch.clamp(weights.sum(), min=1e-30)
    # midpoint quantile of each centroid
    cum = torch.cumsum(weights, 0) - weights / 2.0
    q = cum / total
    k = _k_scale(q, delta)
    k0 = _k_scale(torch.zeros((), dtype=torch.float32,
                              device=weights.device), delta)
    cluster = torch.floor(k - k0).to(torch.int64)
    # interior clusters live in [1, capacity-2]; 0 and capacity-1 are the
    # reserved extreme singletons
    cluster = torch.clamp(cluster + 1, 1, capacity - 2)
    n = weights.shape[0]
    pos = torch.arange(n, device=weights.device)
    n_pop = (weights > 0).sum()
    last = torch.full_like(cluster, capacity - 1)
    cluster = torch.where(pos == 0, torch.zeros_like(cluster), cluster)
    cluster = torch.where((pos == n_pop - 1) & (pos > 0), last, cluster)
    # zero-weight slots: parked in the last cluster with zero weight
    cluster = torch.where(weights > 0, cluster, last)
    # every cluster is a contiguous run: its sum is the scan at its end
    ends = torch.full((capacity,), -1, dtype=torch.int64,
                      device=weights.device).scatter_reduce(
        0, cluster, pos, "amax", include_self=True)
    present = ends >= 0
    at = torch.clamp(ends, min=0)
    new_w = torch.where(present, _segment_scan(weights, cluster)[at], 0.0)
    new_mw = torch.where(
        present, _segment_scan(weights * means, cluster)[at], 0.0)
    new_m = torch.where(new_w > 0, new_mw / torch.clamp(new_w, min=1e-30),
                        torch.zeros_like(new_w))
    return new_m, new_w


def _insert(means, weights, values, sample_weights, capacity, delta):
    all_m = torch.cat([means, values])
    all_w = torch.cat([weights, sample_weights])
    # stable sort by mean, zero-weight entries pushed to the end
    key = torch.where(all_w > 0, all_m, torch.full_like(all_m, math.inf))
    order = torch.argsort(key, stable=True)
    sm, sw = all_m[order], all_w[order]
    # small-N exactness: while every populated centroid fits in the slot
    # array, keep them as singletons (populated entries sort first, so
    # the cut is lossless); k-scale smearing begins only when needed
    small = (sw > 0).sum() <= capacity
    cm, cw = _compress(sm, sw, capacity, delta)
    return (torch.where(small, sm[:capacity], cm),
            torch.where(small, sw[:capacity], cw))


def insert(
    means, weights, values, sample_weights=None,
    config: TDigestConfig = TDigestConfig(),
):
    """Insert a batch of samples (optionally weighted) into the digest;
    returns the new (means, weights)."""
    if not isinstance(values, torch.Tensor):
        values = torch.as_tensor(values, dtype=torch.float32,
                                 device=means.device)
    values = values.to(torch.float32).reshape(-1)
    # NaN/inf policy (the codec's): NaN -> 0.0, +/-inf -> float32
    # extremes, so no sample sorts past the zero-weight sentinels
    values = torch.nan_to_num(values, nan=0.0, posinf=_F32_MAX,
                              neginf=-_F32_MAX)
    if sample_weights is None:
        sample_weights = torch.ones_like(values)
    elif not isinstance(sample_weights, torch.Tensor):
        sample_weights = torch.as_tensor(sample_weights, dtype=torch.float32,
                                         device=means.device)
    sample_weights = sample_weights.to(torch.float32).reshape(-1)
    return _insert(means, weights, values, sample_weights,
                   capacity=config.capacity, delta=config.delta)


def merge(a, b, config: TDigestConfig = TDigestConfig()):
    """Merge two digests — associative."""
    return insert(a[0], a[1], b[0], b[1], config=config)


def quantile(means, weights, qs):
    """Interpolated quantile estimates from a digest.

    TAIL quantiles (q >= 0.9) between positive increasing centroids use
    a POWER-LAW fit: linear in (log survival, log value) space, exact for
    pareto tails, within noise of linear on uniform/normal tails.  BODY
    quantiles (q < 0.9) and segments touching zero/negative means keep
    plain linear interpolation, so a two-sample {1, 1000} digest reports
    q50 ~ 500.5.  A body quantile inside a density gap of multi-modal
    data has no unique answer: the digest returns a value between the
    gap's centroids, and the log-bucket histogram is the tool for such
    data (the reference's applicability note)."""
    key = torch.where(weights > 0, means, torch.full_like(means, math.inf))
    order = torch.argsort(key, stable=True)
    m, w = means[order], weights[order]
    total = torch.clamp(w.sum(), min=1e-30)
    cum = torch.cumsum(w, 0) - w / 2.0
    qpos = cum / total
    if not isinstance(qs, torch.Tensor):
        qs = torch.as_tensor(qs, dtype=torch.float32, device=means.device)
    qq = qs.to(torch.float32).reshape(-1)
    # last populated slot; empty tail slots carry qpos == 1.0
    last = torch.clamp((w > 0).sum() - 1, min=0)
    idx = torch.searchsorted(qpos, qq)
    lo = torch.minimum(torch.clamp(idx - 1, min=0), last)
    hi = torch.minimum(idx, last)
    q_lo, q_hi, m_lo, m_hi = qpos[lo], qpos[hi], m[lo], m[hi]
    span = torch.clamp(q_hi - q_lo, min=1e-30)
    frac = torch.clamp((qq - q_lo) / span, 0.0, 1.0)
    linear = m_lo + frac * (m_hi - m_lo)
    # power-law branch (guarded logs; where picks per element)
    s_lo = torch.clamp(1.0 - q_lo, min=1e-12)
    s_hi = torch.clamp(1.0 - q_hi, min=1e-12)
    s_q = torch.clamp(1.0 - qq, min=1e-12)
    denom = torch.clamp(torch.log(s_hi) - torch.log(s_lo), max=-1e-12)
    pfrac = torch.clamp((torch.log(s_q) - torch.log(s_lo)) / denom, 0.0, 1.0)
    log_lo = torch.log(torch.clamp(m_lo, min=1e-30))
    log_hi = torch.log(torch.clamp(m_hi, min=1e-30))
    powerlaw = torch.exp(log_lo + pfrac * (log_hi - log_lo))
    in_tail = qq >= 0.9
    return torch.where(in_tail & (m_lo > 0) & (m_hi > m_lo), powerlaw,
                       linear)


def count(weights) -> torch.Tensor:
    return weights.sum()
