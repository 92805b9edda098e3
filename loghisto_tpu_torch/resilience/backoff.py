"""Capped exponential backoff with jitter (counterpart of
``loghisto_tpu/resilience/backoff.py``, copied): the retry cadence of
the exporters' one-shot pushes (``push_graphite``, ``push_opentsdb``).

delay_k = min(cap, base * mult^k), jittered by +/- ``jitter`` of itself
with a seeded RNG so tests are reproducible.  ``current_ms`` is the
delay last handed out.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from loghisto_tpu_torch.submitter import send_once


class Backoff:
    def __init__(
        self,
        base_s: float = 0.05,
        cap_s: float = 5.0,
        multiplier: float = 2.0,
        jitter: float = 0.1,
        seed: Optional[int] = None,
    ):
        if base_s <= 0 or cap_s < base_s or multiplier < 1.0:
            raise ValueError("backoff wants 0 < base_s <= cap_s, mult >= 1")
        self.base_s = base_s
        self.cap_s = cap_s
        self.multiplier = multiplier
        self.jitter = jitter
        self._rng = np.random.default_rng(seed)
        self._attempt = 0
        self._current_s = 0.0

    def next_delay(self) -> float:
        """The delay (seconds) to sleep before the next retry; advances
        the attempt counter."""
        raw = min(self.cap_s, self.base_s * self.multiplier ** self._attempt)
        self._attempt += 1
        if self.jitter > 0.0:
            raw *= 1.0 + self.jitter * float(self._rng.uniform(-1.0, 1.0))
        self._current_s = min(raw, self.cap_s)
        return self._current_s

    def reset(self) -> None:
        """Back to the base delay after a success (or a healthy run)."""
        self._attempt = 0
        self._current_s = 0.0

    @property
    def attempt(self) -> int:
        return self._attempt

    @property
    def current_s(self) -> float:
        return self._current_s

    @property
    def current_ms(self) -> float:
        return self._current_s * 1000.0


def send_with_backoff(
    network: str,
    address,
    payload: bytes,
    attempts: int = 3,
    backoff: Optional[Backoff] = None,
    timeout: float = 5.0,
) -> Optional[Exception]:
    """Push ``payload`` with up to ``attempts`` tries under the backoff
    policy; returns the last error or None (``send_once``'s error
    contract)."""
    bo = backoff if backoff is not None else Backoff()
    err: Optional[Exception] = None
    for attempt in range(max(attempts, 1)):
        err = send_once(network, address, payload, timeout=timeout)
        if err is None:
            bo.reset()
            return None
        if attempt + 1 < attempts:
            time.sleep(bo.next_delay())
    return err
