"""OpenTSDB telnet-protocol serializer (counterpart of
``loghisto_tpu/opentsdb.py``: ``opentsdb_protocol``; ``push_opentsdb``
comes with the resilience slice, which ports its backoff).

Wire format (reference opentsdb.go:45-55): one line per metric,

    put <metric> <unix_ts> <value> <tag>=<value> ...\\n

with a ``host=<hostname>`` tag by default.  Values use ``%f`` to match the
reference's wire bytes.

``labeled_tags=True`` re-renders canonical labeled metric names
(``name;k=v;...`` with the processing suffix after the tail) as native
OpenTSDB tag maps: the pairs leave the metric name and join the line's
tags, key-sorted after the static tags, a label value overriding a
clashing static key.  ``split_processed`` and the grammar it needs are a
copy of ``loghisto_tpu/labels/model.py``'s until the label slice ports
that module.
"""

from __future__ import annotations

import functools
import re
import socket
from typing import Mapping, Optional, Tuple

from loghisto_tpu_torch.metrics import ProcessedMetricSet

LABEL_SEP = ";"
_KEY_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_.]*\Z")
# suffixes the processing layer appends AFTER the label tail, longest
# first so ``_agg_count`` never half-matches as ``_count``
_PROCESSED_SUFFIXES = (
    "_agg_count", "_agg_avg", "_agg_sum", "_count", "_rate", "_avg",
    "_sum", "_min", "_max",
)
_QUANTILE_TAIL_RE = re.compile(r"_(\d+(?:\.\d+)?)\Z")


@functools.lru_cache(maxsize=65536)
def parse_canonical(name: str) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
    """Canonical name -> ``(base, ((key, value), ...))``; a flat name,
    or one whose tail is not canonical, returns ``(name, ())``."""
    if LABEL_SEP not in name:
        return name, ()
    base, _, tail = name.partition(LABEL_SEP)
    pairs = []
    for frag in tail.split(LABEL_SEP):
        key, eq, value = frag.partition("=")
        if not eq or not _KEY_RE.match(key):
            return name, ()
        pairs.append((key, value))
    return base, tuple(pairs)


def split_processed(
    name: str,
) -> Optional[Tuple[str, Tuple[Tuple[str, str], ...], str]]:
    """``http.latency;code=200;route=/api_99`` ->
    ``("http.latency", (("code", "200"), ("route", "/api")), "_99")``;
    None when ``name`` carries no canonical label tail.  A known suffix
    is matched longest first; a purely numeric ``_NN`` tail is a
    percentile suffix."""
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


def _tags_to_wire(tags: Mapping[str, str]) -> str:
    return " ".join(f"{tag}={value}" for tag, value in tags.items())


def opentsdb_protocol(
    metric_set: ProcessedMetricSet,
    tags: Mapping[str, str] | None = None,
    hostname: str | None = None,
    labeled_tags: bool = False,
) -> bytes:
    """Serialize a ProcessedMetricSet for an OpenTSDB/KairosDB instance."""
    if hostname is None:
        hostname = socket.gethostname() or "unknown"
    if tags is None:
        tags = {"host": hostname}
    ts = int(metric_set.time.timestamp())
    wire_tags = _tags_to_wire(tags)
    lines = []
    for metric, value in metric_set.metrics.items():
        line_tags = wire_tags
        if labeled_tags:
            sp = split_processed(metric)
            if sp is not None:
                base, pairs, suffix = sp
                merged = dict(tags)
                for k, v in sorted(dict(pairs).items()):
                    merged.pop(k, None)
                    merged[k] = v
                line_tags = _tags_to_wire(merged)
                metric = base + suffix
        lines.append("put %s %d %f %s\n" % (metric, ts, value, line_tags))
    return "".join(lines).encode()


# Reference-style alias: usable directly as a submitter serializer.
OpenTSDBProtocol = opentsdb_protocol
