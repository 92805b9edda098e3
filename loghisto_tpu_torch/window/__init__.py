"""Windowed retention and rules (counterpart of ``loghisto_tpu/window``):
the retention wheel (store.TimeWheel) on K3 and K5, its snapshot
handles, and the rule engine (rules.RuleEngine).  Wired into
``TorchMetricSystem`` via ``retention=``."""

from loghisto_tpu_torch.window.rules import (
    Alert,
    DistributionDriftRule,
    FIRING,
    RESOLVED,
    RateOfChangeRule,
    Rule,
    RuleEngine,
    SloBurnRateRule,
    ThresholdRule,
)
from loghisto_tpu_torch.window.snapshot import (
    AccSnapshot,
    QueryPlanCache,
    Snapshot,
    SnapshotView,
    TierSnapshot,
)
from loghisto_tpu_torch.window.store import (
    DEFAULT_TIERS,
    TierSpec,
    TimeWheel,
    WindowStats,
    pct_key,
)

__all__ = [
    "AccSnapshot",
    "Alert",
    "DEFAULT_TIERS",
    "DistributionDriftRule",
    "FIRING",
    "RESOLVED",
    "QueryPlanCache",
    "RateOfChangeRule",
    "Rule",
    "RuleEngine",
    "SloBurnRateRule",
    "Snapshot",
    "SnapshotView",
    "ThresholdRule",
    "TierSnapshot",
    "TierSpec",
    "TimeWheel",
    "WindowStats",
    "pct_key",
]
