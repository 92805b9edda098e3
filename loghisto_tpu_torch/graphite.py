"""Graphite plaintext-protocol serializer (counterpart of
``loghisto_tpu/graphite.py``; reference layer L4).

Wire format (reference graphite.go:40-47): one line per metric,

    cockroach.<host>.<metric with _ -> .> <value> <unix_ts>\n

The hardcoded ``cockroach.`` prefix is part of the reference's observed
behavior; here it is the *default* of a configurable prefix (the
reference has a TODO for custom tags/prefixes — resolved here).  Values
are rendered with ``%f`` exactly like Go's ``fmt.Sprintf("%f")`` (six
decimal places) so the wire bytes match.

Tag support follows the Graphite 1.1+ tagged-series form: a static
``tags`` mapping renders as ``;key=value`` appended to the metric path,
sorted by key for a deterministic wire format:

    cockroach.<host>.<metric> ;dc=us-east;env=prod <value> <ts>\n

(without the space — ``path;k=v <value> <ts>``).  The default (no tags,
``cockroach`` prefix) is byte-identical to the reference's output.

``labeled_tags=True`` additionally re-renders canonical
labeled metric names (``http.latency;route=/api`` + processed suffix)
as native tagged series: the label pairs move out of the path and into
``;k=v`` tags merged over the static set, so Graphite sees
``cockroach.<host>.http.latency.99;route=/api``.  Off by default — the
flat wire format stays byte-identical.
"""

from __future__ import annotations

import socket
from typing import Mapping, Optional

from loghisto_tpu_torch.labels.model import split_processed
from loghisto_tpu_torch.metrics import ProcessedMetricSet
from loghisto_tpu_torch.resilience.backoff import Backoff, send_with_backoff


def _render_tags(tags: Optional[Mapping[str, str]]) -> str:
    if not tags:
        return ""
    for k, v in tags.items():
        if not k or any(c in ";! " for c in k) or ";" in str(v):
            # the tagged-series grammar reserves ';' (and a leading '!'
            # / empty names); a malformed static tag is a config error
            raise ValueError(f"invalid graphite tag {k!r}={v!r}")
    return "".join(f";{k}={tags[k]}" for k in sorted(tags))


def graphite_protocol(
    metric_set: ProcessedMetricSet,
    prefix: str = "cockroach",
    hostname: str | None = None,
    tags: Optional[Mapping[str, str]] = None,
    labeled_tags: bool = False,
) -> bytes:
    """Serialize a ProcessedMetricSet for a Graphite Carbon instance.
    With ``labeled_tags`` labeled metric names render their label pairs
    as per-line tagged-series tags (label values override a clashing
    static tag — the row-level value is the more specific one)."""
    if hostname is None:
        hostname = socket.gethostname() or "unknown"
    ts = int(metric_set.time.timestamp())
    tag_str = _render_tags(tags)
    lines = []
    for metric, value in metric_set.metrics.items():
        line_tags = tag_str
        if labeled_tags:
            sp = split_processed(metric)
            if sp is not None:
                base, pairs, suffix = sp
                merged = dict(tags or {})
                merged.update(pairs)
                line_tags = "".join(
                    f";{k}={merged[k]}" for k in sorted(merged)
                )
                metric = base + suffix
        lines.append(
            "%s.%s.%s%s %f %d\n"
            % (prefix, hostname, metric.replace("_", "."), line_tags,
               value, ts)
        )
    return "".join(lines).encode()


def make_graphite_serializer(
    prefix: str = "cockroach",
    hostname: str | None = None,
    tags: Optional[Mapping[str, str]] = None,
    labeled_tags: bool = False,
):
    """Bind a custom prefix / static tag set into a serializer (the
    constructor configuration the reference's TODO asked for).  Tags are
    validated once here, not per interval."""
    _render_tags(tags)  # fail fast on malformed tags
    def serialize(metric_set: ProcessedMetricSet) -> bytes:
        return graphite_protocol(
            metric_set, prefix, hostname, tags, labeled_tags
        )
    return serialize


def push_graphite(
    address: tuple[str, int],
    metric_set: ProcessedMetricSet,
    prefix: str = "cockroach",
    hostname: str | None = None,
    tags: Optional[Mapping[str, str]] = None,
    attempts: int = 3,
    backoff: Optional[Backoff] = None,
    labeled_tags: bool = False,
) -> Optional[Exception]:
    """Serialize and deliver one metric set to a Carbon instance under
    the shared capped-exponential backoff (``resilience/backoff.py``).
    Returns the last error or None."""
    payload = graphite_protocol(
        metric_set, prefix, hostname, tags, labeled_tags
    )
    return send_with_backoff(
        "tcp", address, payload, attempts=attempts, backoff=backoff
    )


# Reference-style alias: usable directly as a submitter serializer.
GraphiteProtocol = graphite_protocol
