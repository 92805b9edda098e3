"""OpenTSDB telnet-protocol serializer (counterpart of
``loghisto_tpu/opentsdb.py``): ``opentsdb_protocol`` and the retrying
``push_opentsdb``.

Wire format (reference opentsdb.go:45-55): one line per metric,

    put <metric> <unix_ts> <value> <tag>=<value> ...\\n

with a ``host=<hostname>`` tag by default.  Values use ``%f`` to match the
reference's wire bytes.

``labeled_tags=True`` re-renders canonical labeled metric names
(``name;k=v;...`` with the processing suffix after the tail) as native
OpenTSDB tag maps: the pairs leave the metric name and join the line's
tags, key-sorted after the static tags, a label value overriding a
clashing static key; ``labels.model.split_processed`` undoes the
processing suffix.  Off by default: flat output stays byte-identical.
"""

from __future__ import annotations

import socket
from typing import Mapping, Optional

from loghisto_tpu_torch.labels.model import split_processed
from loghisto_tpu_torch.metrics import ProcessedMetricSet
from loghisto_tpu_torch.resilience.backoff import Backoff, send_with_backoff


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


def push_opentsdb(
    address: tuple[str, int],
    metric_set: ProcessedMetricSet,
    tags: Mapping[str, str] | None = None,
    hostname: str | None = None,
    attempts: int = 3,
    backoff: Optional[Backoff] = None,
    labeled_tags: bool = False,
) -> Optional[Exception]:
    """Serialize and deliver one metric set to an OpenTSDB/KairosDB
    instance under the shared capped-exponential backoff
    (``resilience/backoff.py``).  Returns the last error or None."""
    payload = opentsdb_protocol(metric_set, tags, hostname, labeled_tags)
    return send_with_backoff(
        "tcp", address, payload, attempts=attempts, backoff=backoff
    )


# Reference-style alias: usable directly as a submitter serializer.
OpenTSDBProtocol = opentsdb_protocol
