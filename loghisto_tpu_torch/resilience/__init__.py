"""Resilience helpers (counterpart of ``loghisto_tpu/resilience``): the
shared capped-exponential ``Backoff`` and ``send_with_backoff``.  The
fault injector, the supervisor, the breaker and recovery come with
ROADMAP Queue 1 slice 6c."""

from loghisto_tpu_torch.resilience.backoff import Backoff, send_with_backoff

__all__ = ["Backoff", "send_with_backoff"]
