"""Metric lifecycle (counterpart of ``loghisto_tpu/lifecycle``): TTL and
budget eviction into count-exact overflow rows, and the row repack (K6)
that keeps the device row space bounded under name churn.

    from loghisto_tpu_torch.lifecycle import LifecycleConfig
    ms = TorchMetricSystem(retention=True,
                           lifecycle=LifecycleConfig(ttl_intervals=60))
"""

from loghisto_tpu_torch.lifecycle.policy import (
    LifecycleConfig,
    decide_victims,
    default_overflow_name,
)
from loghisto_tpu_torch.lifecycle.manager import LifecycleManager

__all__ = [
    "LifecycleConfig",
    "LifecycleManager",
    "decide_victims",
    "default_overflow_name",
]
