"""Federation tier: many emitter processes, one aggregator host
(counterpart of ``loghisto_tpu/federation/__init__.py``).

``FederationEmitter`` runs inside any frontend process and loads no
torch: this package imports it lazily, and everything on its import
path (``ops/fold.py``, the host tier of ``ops/codec.py``,
``obs/spans.py``, ``submitter.py``, ``labels/model.py``) is torch-free.
Once an interval it folds the samples recorded since the last flush
into packed ``[n, 3]`` int32 (id, codec_bucket, count) triples, frames
them (``wire.py``: versioned header, name-dictionary delta, CRC32) and
ships them over TCP through ``submitter.BacklogSender``.

``FederationReceiver`` runs next to a ``TorchAggregator``: accept and
decode threads (supervised when a supervisor is given), sequence
tracking per emitter with gap counts and idempotent re-delivery, names
interned into aggregator rows, and the decoded triples drained through
``TorchAggregator.merge_packed``: K3 on dense storage, the paged commit
and K4 on paged storage.  int32 scatter-adds are order-free, so the
aggregate equals a single-process oracle whatever the arrival order.

Fault sites ``fed.accept``, ``fed.decode`` and ``fed.send``.
``TorchMetricSystem(federation=FederationConfig(...))`` runs a receiver
over the system's aggregator: the committer's freshness hook completes
frames at publish, the watchdog reads the fleet invariants,
``FreshnessSloRule`` binds to it and ``/fleetz`` serves its report.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class FederationConfig:
    """Receiver-side federation settings of a metric system.

    Attributes:
      host/port: TCP listen address; port 0 binds an ephemeral port
        (the receiver's ``port`` holds it after ``start()``).
      expected_emitters: how many distinct emitters should feed this
        host.  Zero means "whatever shows up"; nonzero arms the
        ``emitter_starvation`` health reason before the first frame, so
        a host that never hears from its fleet pages.
      journal_path: append every applied frame to a binary frame
        journal (``utils/journal.FrameJournal``) for restart replay.
      replay_on_start: re-apply the journal into the (fresh) aggregator
        when the receiver starts.  Leave False when a checkpoint
        recovery restores the aggregator (replaying on top would count
        twice).
      starvation_intervals: system intervals of frame silence before
        ``emitter_starvation`` trips.
      skew_tolerance_s: how far an emitter's wall clock may drift from
        its monotonic clock (since its anchor frame) before the
        ``emitter_clock_skew`` reason trips and the emitter is flagged.
    """

    host: str = "127.0.0.1"
    port: int = 0
    expected_emitters: int = 0
    journal_path: Optional[str] = None
    replay_on_start: bool = False
    starvation_intervals: float = 3.0
    skew_tolerance_s: float = 1.0


def __getattr__(name):
    # lazy (PEP 562): the config alone pulls in neither the receiver
    # nor the emitter
    if name == "FederationEmitter":
        from loghisto_tpu_torch.federation.emitter import FederationEmitter

        return FederationEmitter
    if name == "FederationReceiver":
        from loghisto_tpu_torch.federation.receiver import FederationReceiver

        return FederationReceiver
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["FederationConfig", "FederationEmitter", "FederationReceiver"]
