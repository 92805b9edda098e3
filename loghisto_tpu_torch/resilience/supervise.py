"""Thread supervision (counterpart of
``loghisto_tpu/resilience/supervise.py``, copied): pipeline threads
restart instead of silently dying.

The reaper, the committer's bridge, the time wheel's and the
aggregator's bridges are daemon threads whose death would leave the
pipeline quiet.  ``ThreadSupervisor.spawn`` wraps the target in a
restart loop: a normal return (``ChannelClosed`` after detach) ends the
thread; an exception logs, counts a restart, sleeps a capped
exponential backoff and re-enters the target.  A run that stays
healthy for ``healthy_after_s`` resets the backoff.

A restarted target is the same closure: it reads the same component
state (the committer's staging rings and their events, the
aggregator's accumulator on its device), so the thread that replaces a
dead one runs on the same device and streams.  ``torch.cuda``'s
current stream is per thread and defaults to the device's default
stream, the one every pipeline thread uses.

The returned ``SupervisedThread`` is drop-in for ``threading.Thread``:
``is_alive()``, ``join()``, ``name``, ``daemon``, plus ``stop()``,
which wakes a backoff sleep at once.  ``spawn_thread`` starts a
pipeline thread supervised or plain; either handle has ``stop()``, so
detach paths call it unconditionally.

Restart counts surface as ``resilience.ThreadRestarts`` and latch the
watchdog's ``thread_restarted`` invariant.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional

from loghisto_tpu_torch.resilience.backoff import Backoff

logger = logging.getLogger("loghisto_tpu_torch")


class SupervisedThread:
    """Restart-looping thread handle (see module docstring)."""

    def __init__(
        self,
        target: Callable[[], None],
        name: str,
        supervisor: "ThreadSupervisor",
        backoff: Backoff,
        healthy_after_s: float = 5.0,
    ):
        self._target = target
        self.name = name
        self._supervisor = supervisor
        self._backoff = backoff
        self._healthy_after_s = healthy_after_s
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=name
        )

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        """Ask the restart loop to exit: wakes any backoff sleep and
        prevents further restarts.  The target itself is interrupted by
        its own shutdown contract (closed subscription etc.)."""
        self._stop.set()

    def join(self, timeout: Optional[float] = None) -> None:
        # call sites compare their stored handle against
        # threading.current_thread() before joining; with a handle that
        # check can't match the inner thread, so guard here instead
        if self._thread is threading.current_thread():
            return
        self._thread.join(timeout)

    def is_alive(self) -> bool:
        return self._thread.is_alive()

    @property
    def daemon(self) -> bool:
        return self._thread.daemon

    def _run(self) -> None:
        while not self._stop.is_set():
            started = time.monotonic()
            try:
                self._target()
                return  # clean exit (ChannelClosed path) — do not restart
            except BaseException:
                if self._stop.is_set():
                    return
                logger.exception(
                    "supervised thread %s crashed; restarting", self.name
                )
                if time.monotonic() - started >= self._healthy_after_s:
                    self._backoff.reset()
                self._supervisor._note_restart(self.name)
                if self._stop.wait(timeout=self._backoff.next_delay()):
                    return


class ThreadSupervisor:
    """Factory + restart ledger for the pipeline's bridge threads."""

    def __init__(
        self,
        base_backoff_s: float = 0.05,
        max_backoff_s: float = 2.0,
        seed: int = 0,
    ):
        self.base_backoff_s = base_backoff_s
        self.max_backoff_s = max_backoff_s
        self._seed = seed
        self._lock = threading.Lock()
        self.total_restarts = 0
        self.restarts_by_name: Dict[str, int] = {}
        self._last_backoff: Optional[Backoff] = None

    def spawn(
        self, target: Callable[[], None], name: str, start: bool = True
    ) -> SupervisedThread:
        backoff = Backoff(
            base_s=self.base_backoff_s, cap_s=self.max_backoff_s,
            seed=self._seed + len(self.restarts_by_name),
        )
        with self._lock:
            self._last_backoff = backoff
        t = SupervisedThread(target, name, self, backoff)
        if start:
            t.start()
        return t

    def _note_restart(self, name: str) -> None:
        with self._lock:
            self.total_restarts += 1
            self.restarts_by_name[name] = \
                self.restarts_by_name.get(name, 0) + 1

    def note_external_restart(self, name: str) -> None:
        """Ledger entry for a component that respawns its own thread
        (the aggregator's lazily-revived transfer worker) so every
        restart in the process shows on one gauge."""
        self._note_restart(name)

    def current_backoff_ms(self) -> float:
        with self._lock:
            bo = self._last_backoff
        return bo.current_ms if bo is not None else 0.0


class _PlainThread(threading.Thread):
    """A daemon thread with ``SupervisedThread``'s ``stop()``, a no-op:
    a plain thread has no restart loop to end."""

    def __init__(self, target: Callable[[], None], name: str):
        super().__init__(target=target, daemon=True, name=name)

    def stop(self) -> None:
        pass


def spawn_thread(supervisor: Optional[ThreadSupervisor],
                 target: Callable[[], None], name: str):
    """Start ``target`` on a daemon thread named ``name``: restarted on
    a crash when ``supervisor`` is given, plain otherwise.  The handle
    has ``stop()`` either way."""
    if supervisor is not None:
        return supervisor.spawn(target, name)
    t = _PlainThread(target, name)
    t.start()
    return t
