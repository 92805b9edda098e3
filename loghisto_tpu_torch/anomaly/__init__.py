"""Distribution drift engine (counterpart of ``loghisto_tpu/anomaly``):
EWMA baseline banks kept by the fused interval commit, one scoring pass
per interval (KS / JSD / bucket-space EMD, K7), and generation-keyed
scores for ``DistributionDriftRule`` and the per-metric gauges; wired by
``TorchMetricSystem(anomaly=AnomalyConfig())``."""

from loghisto_tpu_torch.anomaly.config import AnomalyConfig, hourly_bank
from loghisto_tpu_torch.anomaly.manager import AnomalyManager

__all__ = ["AnomalyConfig", "AnomalyManager", "hourly_bank"]
