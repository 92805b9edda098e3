"""Resilience subsystem (counterpart of ``loghisto_tpu/resilience``):
fault injection, crash-safe recovery, thread supervision, circuit
breaking, and the shared capped-exponential ``Backoff``.

    from loghisto_tpu_torch.resilience import ResilienceConfig, FaultInjector
    ms = TorchMetricSystem(..., resilience=ResilienceConfig(
        checkpoint_path="state.npz", journal_path="intervals.jsonl"))
    ms.recover()   # restore + replay: at most one interval lost
"""

from loghisto_tpu_torch.resilience.backoff import Backoff, send_with_backoff
from loghisto_tpu_torch.resilience.faults import FaultInjector, InjectedFault
from loghisto_tpu_torch.resilience.recovery import (
    CircuitBreaker,
    RecoveryManager,
    RecoveryReport,
    ResilienceConfig,
    register_resilience_gauges,
)
from loghisto_tpu_torch.resilience.supervise import (
    SupervisedThread,
    ThreadSupervisor,
)

__all__ = [
    "Backoff",
    "CircuitBreaker",
    "FaultInjector",
    "InjectedFault",
    "RecoveryManager",
    "RecoveryReport",
    "ResilienceConfig",
    "SupervisedThread",
    "ThreadSupervisor",
    "register_resilience_gauges",
    "send_with_backoff",
]
