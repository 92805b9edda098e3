"""group_by rollup results and the host-side merge oracle (counterpart
of ``loghisto_tpu/labels/groupby.py``).

``TimeWheel.query_group_by(selector, by=["route"])`` merges every
matching labeled row into one histogram per distinct value-tuple of
the ``by`` keys on the snapshot's device: a row gather, a segment sum
and the rank search (``ops.stats.make_group_query_fn``).  This module
holds the result type, the group-key assignment (pure string work over
canonical names) and the float64 merge oracle the rollup is held
against.

Merging is exact because log-bucket histograms merge by bucket-count
addition (the property the wheel's tier promotion relies on): grouping
adds no sketch error, and an equi-depth summary of a merged group is
its percentiles at ranks j/depth (equi-depth boundaries are quantiles),
which is how ``depth=`` rides the same rollup as the percentile list.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from loghisto_tpu_torch.labels.model import parse_canonical
from loghisto_tpu_torch.ops.codec import decompress_np

GroupKey = Tuple[str, ...]


@dataclasses.dataclass
class GroupStats:
    """Result of one group_by rollup.  ``groups`` maps the value-tuple
    of the ``by`` keys (missing label -> "") to the merged stat dict
    ({"count", "sum", "avg", "p50", ..., optionally "edges"}); ``sizes``
    records how many rows merged into each group."""

    time: _dt.datetime
    window_s: float
    covered_s: float
    tier: int
    slots: int
    by: Tuple[str, ...]
    groups: Dict[GroupKey, Dict[str, object]]
    sizes: Dict[GroupKey, int]


def group_key_for(name: str, by: Sequence[str]) -> GroupKey:
    """The group a canonical name rolls into: its label values at the
    ``by`` keys, missing labels reading as "" (Prometheus semantics —
    the flat base row groups under ("", ..., "")), so group_by is total
    over every selected row."""
    labels = dict(parse_canonical(name)[1])
    return tuple(labels.get(k, "") for k in by)


def assign_groups(
    matches: Sequence[Tuple[int, str]], by: Sequence[str]
) -> Tuple[List[GroupKey], List[int]]:
    """Deterministically number the groups of ``matches``: returns
    (ordered distinct group keys, per-match group index).  Keys are
    ordered by first appearance of ascending mid, so the device gids
    and the host oracle agree without a sort."""
    keys: List[GroupKey] = []
    index: Dict[GroupKey, int] = {}
    gids: List[int] = []
    for _mid, name in matches:
        gk = group_key_for(name, by)
        gi = index.get(gk)
        if gi is None:
            gi = len(keys)
            index[gk] = gi
            keys.append(gk)
        gids.append(gi)
    return keys, gids


def equidepth_ranks(depth: int) -> Tuple[float, ...]:
    """The interior quantile ranks of an equi-depth summary: ``depth``
    equal-count bins need the ``depth - 1`` boundaries at j/depth."""
    if depth < 2:
        raise ValueError("equi-depth summaries need depth >= 2")
    return tuple(j / depth for j in range(1, depth))


def merge_groups_host(
    histograms: Mapping[str, Mapping[int, int]],
    by: Sequence[str],
    ps: Sequence[float],
    precision: int,
    value_of=None,
) -> Dict[GroupKey, Dict[str, float]]:
    """Float64 merge oracle: group the sparse per-name interval
    histograms (name -> {codec bucket: count}) by ``by``, merge bucket
    counts per group, and answer count/sum/percentiles via the host
    reference selection rule (first bucket where float64(cum)/total >=
    p, endpoints at first/last populated bucket — the same rule
    ``percentiles_sparse`` implements).  The device group_by must pick
    the SAME BUCKET for every (group, p) for dense-codec rows.

    ``value_of(buckets) -> values`` maps codec bucket indices to
    representative values; defaults to the host float64 decompress.
    Parity checks pass the device's own float32 rep table
    (``lambda b: bucket_representatives(bl, prec).numpy()[b + bl]``), so
    bucket-identical selection becomes bit-identical float equality.
    """
    if value_of is None:
        value_of = lambda b: decompress_np(b, precision)  # noqa: E731

    merged: Dict[GroupKey, Dict[int, int]] = {}
    for name, buckets in histograms.items():
        gk = group_key_for(name, by)
        dst = merged.setdefault(gk, {})
        for b, c in buckets.items():
            dst[b] = dst.get(b, 0) + c
    ps_arr = np.asarray(ps, dtype=np.float64)
    out: Dict[GroupKey, Dict[str, float]] = {}
    for gk, buckets in merged.items():
        if not buckets:
            continue
        barr = np.asarray(sorted(buckets.keys()), dtype=np.int64)
        carr = np.asarray(
            [buckets[int(b)] for b in barr], dtype=np.int64
        )
        total_count = int(carr.sum())
        if total_count == 0:
            continue
        values = np.asarray(value_of(barr), dtype=np.float64)
        total_sum = float(np.dot(values, carr.astype(np.float64)))
        cdf = np.cumsum(carr)
        cdfn = cdf.astype(np.float64) / float(total_count)
        pos = np.minimum(
            np.searchsorted(cdfn, ps_arr, side="left"), len(barr) - 1
        )
        idx = np.where(
            ps_arr <= 0, 0, np.where(ps_arr >= 1, len(barr) - 1, pos)
        )
        entry: Dict[str, float] = {
            "count": float(total_count),
            "sum": total_sum,
            "avg": total_sum / total_count,
        }
        for p, v in zip(ps, values[idx]):
            entry[pct_key(float(p))] = float(v)
        out[gk] = entry
    return out


def pct_key(q: float) -> str:
    """0.99 -> "p99", 0.999 -> "p99.9", 0.5 -> "p50": the stat key of a
    percentile in window and group results."""
    s = f"{q * 100:.4f}".rstrip("0").rstrip(".")
    return f"p{s}"
