"""Moments quantile sketch in PyTorch (counterpart of
``loghisto_tpu/models/moments.py``; cf. "Moment-Based Quantile Sketches
for Efficient High Cardinality Aggregation Queries", PAPERS.md).

The cheapest mergeable sketch of all: count, mean and *central* power
sums M2..M4 plus min/max.  Insert is a handful of multiply-adds per
sample, merge is Pebay's parallel combination (exact and associative),
and the state is O(1).

Numerical design, float32 throughout as in the reference:
  * central moments (not raw power sums) — raw sums cancel
    catastrophically when mean >> std;
  * values are normalized by a running scale (max |x| seen), and the
    stored mean/M2..M4 are rescaled when the scale grows — no overflow at
    any magnitude;
  * counts are int32 (exact to 2^31; float32 would stop counting at
    2^24);
  * NaN samples are pinned to 0.0, as ``ops/ingest.bucket_indices``.

Quantile estimates use a Cornish-Fisher expansion from the standardized
moments (``torch.special.ndtri`` for the normal quantile), clamped to
[min, max], with exact observed endpoints at q=0/1.  Accuracy is
distribution-dependent; the log-bucket histogram remains the <=1% tool.
"""

from __future__ import annotations

import dataclasses

import torch

from loghisto_tpu_torch.ops.backend import resolve_device


@dataclasses.dataclass
class MomentsState:
    count: torch.Tensor  # int32 scalar
    mean: torch.Tensor   # f32 scalar, of scaled values
    m2: torch.Tensor     # f32 central sums of scaled values
    m3: torch.Tensor
    m4: torch.Tensor
    scale: torch.Tensor  # f32 scalar >= max |x| seen
    min: torch.Tensor    # f32 scalar, original units
    max: torch.Tensor    # f32 scalar, original units


def _f32(value, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def empty(device=None) -> MomentsState:
    """An empty sketch on ``device`` (default the card)."""
    dev = resolve_device(device)
    return MomentsState(
        count=torch.tensor(0, dtype=torch.int32, device=dev),
        mean=_f32(0.0, dev), m2=_f32(0.0, dev), m3=_f32(0.0, dev),
        m4=_f32(0.0, dev), scale=_f32(1.0, dev),
        min=_f32(float("inf"), dev), max=_f32(float("-inf"), dev),
    )


def _rescaled(state: MomentsState, new_scale: torch.Tensor) -> MomentsState:
    r = state.scale / new_scale
    return MomentsState(
        count=state.count,
        mean=state.mean * r,
        m2=state.m2 * r ** 2,
        m3=state.m3 * r ** 3,
        m4=state.m4 * r ** 4,
        scale=new_scale,
        min=state.min,
        max=state.max,
    )


def _combine(a: MomentsState, b: MomentsState) -> MomentsState:
    """Pebay's parallel central-moment combination; a and b must share a
    scale."""
    na = a.count.to(torch.float32)
    nb = b.count.to(torch.float32)
    n = torch.clamp(na + nb, min=1.0)
    delta = b.mean - a.mean
    mean = a.mean + delta * nb / n
    m2 = a.m2 + b.m2 + delta ** 2 * na * nb / n
    m3 = (
        a.m3 + b.m3
        + delta ** 3 * na * nb * (na - nb) / n ** 2
        + 3.0 * delta * (na * b.m2 - nb * a.m2) / n
    )
    m4 = (
        a.m4 + b.m4
        + delta ** 4 * na * nb * (na ** 2 - na * nb + nb ** 2) / n ** 3
        + 6.0 * delta ** 2 * (na ** 2 * b.m2 + nb ** 2 * a.m2) / n ** 2
        + 4.0 * delta * (na * b.m3 - nb * a.m3) / n
    )
    total = a.count + b.count
    return MomentsState(
        count=total,
        mean=torch.where(total > 0, mean, torch.zeros_like(mean)),
        m2=m2, m3=m3, m4=m4,
        scale=a.scale,
        min=torch.minimum(a.min, b.min),
        max=torch.maximum(a.max, b.max),
    )


def insert(state: MomentsState, values) -> MomentsState:
    """Insert a batch; returns the new state."""
    x = torch.as_tensor(values, dtype=torch.float32,
                        device=state.count.device).reshape(-1)
    if x.shape[0] == 0:
        return dataclasses.replace(state)
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    new_scale = torch.maximum(state.scale, x.abs().max())
    xs = x / new_scale
    bmean = xs.sum() / x.shape[0]
    d = xs - bmean
    batch = MomentsState(
        count=torch.tensor(x.shape[0], dtype=torch.int32, device=x.device),
        mean=bmean,
        m2=(d ** 2).sum(),
        m3=(d ** 3).sum(),
        m4=(d ** 4).sum(),
        scale=new_scale,
        min=x.min(),
        max=x.max(),
    )
    return _combine(_rescaled(state, new_scale), batch)


def merge(a: MomentsState, b: MomentsState) -> MomentsState:
    scale = torch.maximum(a.scale, b.scale)
    return _combine(_rescaled(a, scale), _rescaled(b, scale))


def standardized_moments(state: MomentsState):
    """(mean, std, skewness, kurtosis) in original units."""
    n = torch.clamp(state.count.to(torch.float32), min=1.0)
    var = state.m2 / n
    # degenerate distributions (0/1 samples, all-equal values): report
    # Gaussian shape so the expansion stays finite instead of 0/0
    degenerate = var <= 1e-14
    var_s = torch.clamp(var, min=1e-14)
    std = torch.sqrt(var_s)
    skew = torch.where(degenerate, torch.zeros_like(var),
                       (state.m3 / n) / std ** 3)
    kurt = torch.where(degenerate, torch.full_like(var, 3.0),
                       (state.m4 / n) / var_s ** 2)
    std = torch.where(degenerate, torch.zeros_like(std), std)
    return state.mean * state.scale, std * state.scale, skew, kurt


def quantile(state: MomentsState, qs) -> torch.Tensor:
    """Cornish-Fisher quantile estimates, clamped to the observed
    range."""
    mean, std, skew, kurt = standardized_moments(state)
    qs_raw = torch.as_tensor(qs, dtype=torch.float32,
                             device=state.count.device)
    z = torch.special.ndtri(torch.clamp(qs_raw, 1e-6, 1 - 1e-6))
    g1, g2 = skew, kurt - 3.0
    w = (
        z
        + (z ** 2 - 1) * g1 / 6.0
        + (z ** 3 - 3 * z) * g2 / 24.0
        - (2 * z ** 3 - 5 * z) * g1 ** 2 / 36.0
    )
    est = torch.minimum(torch.maximum(mean + std * w, state.min), state.max)
    # exact endpoints (CF is unreliable at extreme z with strong skew)
    est = torch.where(qs_raw <= 0.0, state.min, est)
    est = torch.where(qs_raw >= 1.0, state.max, est)
    # an empty sketch has no observed range: 0, as the other sketches
    return torch.where(state.count > 0, est, torch.zeros_like(est))


def count(state: MomentsState) -> torch.Tensor:
    return state.count
