"""Sketch model families (counterpart of ``loghisto_tpu/models``): the
dense log-bucket histogram as a standalone sketch (``LogHistogram``,
whose insert runs K2 on the card), t-digest, HyperLogLog and the
moments sketch — all mergeable, all PyTorch on the sketch's device.

The names are the reference's ``__all__`` and load on first use
(PEP 562): the modules import torch."""

import importlib

_MODULES = ("hll", "moments", "tdigest")

__all__ = ["LogHistogram", "hll", "moments", "tdigest"]


def __getattr__(name):
    if name == "LogHistogram":
        from loghisto_tpu_torch.models.loghist import LogHistogram

        return LogHistogram
    if name in _MODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
