"""Configuration (counterpart of ``loghisto_tpu/config.py``, copied).

The Go reference has no config system: its only knobs are the constructor
arguments ``(interval, sysStats)`` (reference metrics.go:143), the
``SpecifyPercentiles`` override (metrics.go:199-201) and the compile-time
``precision = 100`` constant (metrics.go:40-43).  The defaults match the
reference exactly; the dense bucket range is the one device-specific knob.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

# Default percentile label -> quantile mapping, identical to the reference
# (metrics.go:145-155).  Labels are %-format templates applied to the metric
# name, e.g. "%s_99.9" % "latency" -> "latency_99.9".
DEFAULT_PERCENTILES: Mapping[str, float] = {
    "%s_min": 0.0,
    "%s_50": 0.5,
    "%s_75": 0.75,
    "%s_90": 0.9,
    "%s_95": 0.95,
    "%s_99": 0.99,
    "%s_99.9": 0.999,
    "%s_99.99": 0.9999,
    "%s_max": 1.0,
}

# Bucketing precision: bucket = round(precision * ln(1 + |v|)), giving bucket
# boundary ratio e^(1/precision) ~= 1.01, i.e. <=1% relative error
# (reference metrics.go:40-43, 316-332).
PRECISION = 100

# Full int16 bucket span of the reference codec.
INT16_BUCKET_LIMIT = 32767


@dataclasses.dataclass(frozen=True)
class MetricConfig:
    """Numeric / behavioral configuration.

    Attributes:
      precision: log-bucketing precision (reference: fixed at 100).
      bucket_limit: maximum absolute bucket index for the dense device-side
        accumulator.  The default +/-4096 covers |v| up to e^40.96 ~= 6.2e17
        at a dense cost of (2*4096+1) * 4 bytes = 32 KB per metric.
      eviction_strikes: consecutive failed deliveries before a subscriber is
        evicted.  The reference's docs say 3 (metrics.go:18-23) but its code
        evicts on the 2nd (metrics.go:574,620); the default follows the code.
      go_compat: reproduce the reference's integer quirks bit-for-bit:
        lifetime histogram sums accumulated via uint64 truncation
        (metrics.go:374) and ``_agg_avg`` computed with integer division
        (metrics.go:601-602).
      ingest_buffer_cap: raw histogram samples per metric buffered in a
        host shard before they are folded into sparse bucket counts.
    """

    precision: int = PRECISION
    bucket_limit: int = 4096
    eviction_strikes: int = 2
    go_compat: bool = False
    ingest_buffer_cap: int = 65536

    def __post_init__(self):
        if not 0 < self.bucket_limit <= 8192:
            # exp(bucket/precision) overflows float32 at bucket ~8873; cap
            # below that so dense representatives stay finite on device.
            raise ValueError(
                "bucket_limit must be in (0, 8192] — float32 representatives "
                f"overflow beyond that; got {self.bucket_limit}"
            )
        if self.precision <= 0:
            raise ValueError(f"precision must be positive, got {self.precision}")
        if self.ingest_buffer_cap < 64:
            # below this the per-sample fold overhead dominates the hot path
            raise ValueError(
                "ingest_buffer_cap must be >= 64, got "
                f"{self.ingest_buffer_cap}"
            )
        if self.eviction_strikes < 1:
            raise ValueError(
                f"eviction_strikes must be >= 1, got {self.eviction_strikes}"
            )

    @property
    def num_buckets(self) -> int:
        """Dense bucket-axis size: indices -bucket_limit..+bucket_limit."""
        return 2 * self.bucket_limit + 1


DEFAULT_CONFIG = MetricConfig()
