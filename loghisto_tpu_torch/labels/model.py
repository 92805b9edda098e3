"""Label data model: canonical encoding of dimensioned metric names
(counterpart of ``loghisto_tpu/labels/model.py``, copied: pure host
code).

A labeled metric (``http.latency{route=/api,code=500}``) is not a new
storage concept: it is exactly one registry row under a canonical flat
encoding:

    http.latency;code=500;route=/api

Keys are sorted, so every permutation of the same label set produces
the same canonical name: one registry row, one device histogram row.
Everything underneath the name layer (the host ingest shards, the fused
commit, the wheel's rings, lifecycle folds) works on opaque flat names
and therefore on labeled metrics unchanged; the label subsystem lives
on the host, above the registry.

Grammar (validated at record time, the only place a label set enters
the system):

  * base name: any non-empty string without ``;`` (the pair
    separator), ``{``/``}`` (reserved for selector syntax), or
    newlines.
  * label key: ``[A-Za-z_][A-Za-z0-9_.]*`` (Prometheus-style, dots
    allowed; exporters sanitize per their own grammar).
  * label value: any string (including empty) free of the structural
    characters ``; = , { } "`` and whitespace, so canonical names
    survive every wire format (graphite tagged series, OpenTSDB tag
    maps, the Prometheus exposition) without escaping.
"""

from __future__ import annotations

import functools
import re
from typing import Dict, Mapping, Optional, Tuple

LABEL_SEP = ";"

_KEY_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_.]*\Z")
# structural characters no canonical value may carry (selector syntax,
# pair separators, exposition quoting, whitespace of any kind)
_BAD_VALUE_RE = re.compile(r"[;=,{}\"\s]")

# suffixes the processing layer appends AFTER the label tail
# (metrics.py naming scheme: <name>_count/_sum/_avg, lifetime _agg_*,
# counter _rate, percentile labels <name>_<NN>).  Longest first so
# ``_agg_count`` never half-matches as ``_count``.
_PROCESSED_SUFFIXES = (
    "_agg_count", "_agg_avg", "_agg_sum", "_count", "_rate", "_avg",
    "_sum", "_min", "_max",
)
_QUANTILE_TAIL_RE = re.compile(r"_(\d+(?:\.\d+)?)\Z")


class LabelError(ValueError):
    """A name or label set that violates the canonical grammar."""


@functools.lru_cache(maxsize=65536)
def _checked_pair(key: str, value: str) -> str:
    """Validate one (key, value) pair and return its ``;k=v`` fragment.
    Cached: hot ingest paths re-send the same few pairs forever."""
    if not _KEY_RE.match(key):
        raise LabelError(
            f"invalid label key {key!r}: keys must match "
            "[A-Za-z_][A-Za-z0-9_.]*"
        )
    if _BAD_VALUE_RE.search(value):
        raise LabelError(
            f"invalid label value {value!r} for key {key!r}: values may "
            "not contain ';', '=', ',', '{', '}', '\"', or whitespace"
        )
    return f"{LABEL_SEP}{key}={value}"


def check_base_name(name: str) -> str:
    if not name or LABEL_SEP in name or "{" in name or "}" in name \
            or "\n" in name:
        raise LabelError(
            f"invalid metric base name {name!r}: must be non-empty and "
            "free of ';', '{', '}', and newlines"
        )
    return name


def canonical_name(name: str, labels: Optional[Mapping[str, str]]) -> str:
    """``("http.latency", {"route": "/api", "code": "500"})`` ->
    ``"http.latency;code=500;route=/api"``.  Sorted keys make the
    encoding canonical: every insertion order of the same label set is
    ONE registry row.  ``labels`` empty/None returns the flat name
    unchanged (a labeled API call with no labels IS the flat metric)."""
    if not labels:
        return name
    check_base_name(name)
    items = sorted(labels.items())
    return name + "".join(
        _checked_pair(k, str(v)) for k, v in items
    )


class LabelSet:
    """An interned, sorted label set.  Equality/hash are by canonical
    encoding, so two LabelSets built from permuted dicts are the same
    object key.  Use ``canonical_name`` directly on hot paths — this
    class exists for callers that hold a label set as a value."""

    __slots__ = ("pairs", "_encoded")

    def __init__(self, labels: Optional[Mapping[str, str]] = None):
        items = sorted((labels or {}).items())
        self.pairs: Tuple[Tuple[str, str], ...] = tuple(
            (k, str(v)) for k, v in items
        )
        self._encoded = "".join(
            _checked_pair(k, v) for k, v in self.pairs
        )

    def encode(self) -> str:
        """The ``;k=v;k2=v2`` canonical tail ('' for the empty set)."""
        return self._encoded

    def apply(self, base: str) -> str:
        """The full canonical name for this set under ``base``."""
        check_base_name(base)
        return base + self._encoded

    def as_dict(self) -> Dict[str, str]:
        return dict(self.pairs)

    def __eq__(self, other) -> bool:
        return isinstance(other, LabelSet) and self.pairs == other.pairs

    def __hash__(self) -> int:
        return hash(self.pairs)

    def __repr__(self) -> str:
        return f"LabelSet({dict(self.pairs)!r})"


def is_labeled(name: str) -> bool:
    """True when ``name`` is a canonical labeled name."""
    return LABEL_SEP in name


@functools.lru_cache(maxsize=65536)
def parse_canonical(
    name: str,
) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
    """Canonical name -> ``(base, ((key, value), ...))``.  A flat name
    returns ``(name, ())``.  Tolerant of foreign names that merely
    contain ``;`` without forming valid pairs: those parse as a flat
    name (the label layer must never make an unlabeled registry row
    unqueryable).  Cached — the inverted index and exporters re-parse
    the same live names every generation."""
    if LABEL_SEP not in name:
        return name, ()
    base, _, tail = name.partition(LABEL_SEP)
    pairs = []
    for frag in tail.split(LABEL_SEP):
        key, eq, value = frag.partition("=")
        if not eq or not _KEY_RE.match(key):
            return name, ()  # not a canonical tail; treat as flat
        pairs.append((key, value))
    return base, tuple(pairs)


def labels_of(name: str) -> Dict[str, str]:
    """The label mapping of a canonical name ({} for flat names)."""
    return dict(parse_canonical(name)[1])


def base_of(name: str) -> str:
    """The base (unlabeled) metric name of a canonical name."""
    return parse_canonical(name)[0]


def split_processed(
    name: str,
) -> Optional[Tuple[str, Tuple[Tuple[str, str], ...], str]]:
    """Parse a PROCESSED metric name that carries a label tail:
    ``http.latency;code=200;route=/api_99`` ->
    ``("http.latency", (("code","200"),("route","/api")), "_99")``.

    The processing layer appends its suffix (``_count``, ``_99``, ...)
    AFTER the canonical tail, so the suffix rides the last label value;
    this is the one place that seam is undone, shared by every exporter
    (Prometheus exposition, graphite tagged series, OpenTSDB tag maps).
    Known suffixes are matched longest-first; a purely numeric ``_NN``
    tail is treated as a percentile suffix.  Returns None when ``name``
    has no label separator or its tail is not canonical.  Limitation
    (documented): a label value that itself ends in a known suffix
    (e.g. ``stage=pre_count``) is mis-split — don't name values after
    the processing suffixes.
    """
    if LABEL_SEP not in name:
        return None
    suffix = ""
    body = name
    for s in _PROCESSED_SUFFIXES:
        if body.endswith(s):
            suffix = s
            body = body[: -len(s)]
            break
    else:
        m = _QUANTILE_TAIL_RE.search(body)
        if m:
            suffix = m.group(0)
            body = body[: m.start()]
    base, pairs = parse_canonical(body)
    if not pairs:
        return None
    return base, pairs, suffix
