"""Configuration for the distribution drift engine (counterpart of
``loghisto_tpu/anomaly/config.py``, copied: pure host code).

Pure host-side dataclass, mirroring ``lifecycle.policy.LifecycleConfig``:
all device behavior (bank shapes, decay, floors, dispatch tier) is
parameterized here and validated at construction, so a bad knob fails at
``TorchMetricSystem(anomaly=...)`` time, not intervals later on the bridge
thread.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass
from typing import Callable, Optional


def hourly_bank(t: _dt.datetime) -> int:
    """Example ``bank_of`` for seasonal traffic: one baseline per UTC
    hour of day (use with ``banks=24``)."""
    return t.hour


@dataclass(frozen=True)
class AnomalyConfig:
    """Knobs for the drift engine.

    banks         — number of EWMA baseline profiles kept per metric row
                    (1 = a single global baseline; 24 + ``bank_of=
                    hourly_bank`` = per-hour seasonal baselines)
    bank_of       — interval time -> bank index (clamped mod ``banks``);
                    None always uses bank 0
    decay         — EWMA retain factor in [0, 1): baseline_{t+1} =
                    decay * baseline_t + (1-decay) * interval_pmf.  0.9
                    means an interval's shape decays to ~35% influence
                    after 10 intervals
    min_samples   — rows with fewer interval samples neither update
                    their baseline nor score (the min-sample floor: a
                    quiet metric must not page on noise)
    check_every   — score every N committed intervals (1 = every
                    interval; scoring is one fused dispatch either way)
    tier          — retention tier whose snapshot views feed scoring
    window        — trailing window (seconds) to score against; None
                    scores the tier's full covered span.  The manager
                    pins it so the commit path materializes the view
    divergence_path — scoring dispatch; the port takes only "auto" (the
                    device decides, ops.anomaly.resolve_divergence_path)
    export_glob   — metrics matching this glob export per-metric
                    ``anomaly.<name>.{ks,jsd,emd}`` gauges (None
                    disables per-metric gauges; the family counters
                    always export)
    max_export    — cap on per-metric gauge registrations (gauge
                    funcs are never unregistered, so unbounded export
                    under name churn would leak)
    """

    banks: int = 1
    bank_of: Optional[Callable[[_dt.datetime], int]] = None
    decay: float = 0.9
    min_samples: int = 64
    check_every: int = 1
    tier: int = 0
    window: Optional[float] = None
    divergence_path: str = "auto"
    export_glob: Optional[str] = "*"
    max_export: int = 256

    def __post_init__(self):
        if self.banks < 1:
            raise ValueError("banks must be >= 1")
        if not 0.0 <= self.decay < 1.0:
            raise ValueError("decay must be in [0, 1)")
        if self.min_samples < 1:
            # 0 would let the all-zero warmup histogram "update" the
            # baseline toward an empty profile
            raise ValueError("min_samples must be >= 1")
        if self.check_every < 1:
            raise ValueError("check_every must be >= 1")
        if self.tier < 0:
            raise ValueError("tier must be >= 0")
        if self.window is not None and self.window <= 0:
            raise ValueError("window must be positive")
        if self.max_export < 0:
            raise ValueError("max_export must be >= 0")
