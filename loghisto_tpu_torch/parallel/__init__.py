"""Distributed aggregation (counterpart of ``loghisto_tpu/parallel``):
the ("stream", "metric") mesh over ``torch.distributed`` (``mesh.py``,
``multihost.py``; ROADMAP D8), the mesh steps and the
``TorchAggregator`` runtime (``aggregator.py``).  The reference's
``__all__`` loads on first use (PEP 562), so importing a submodule does
not import torch's distributed package."""

import importlib

_LAZY = {
    "METRIC_AXIS": "loghisto_tpu_torch.parallel.mesh",
    "STREAM_AXIS": "loghisto_tpu_torch.parallel.mesh",
    "make_mesh": "loghisto_tpu_torch.parallel.mesh",
    "TorchAggregator": "loghisto_tpu_torch.parallel.aggregator",
    "make_distributed_step": "loghisto_tpu_torch.parallel.aggregator",
    "make_interval_distributed_step":
        "loghisto_tpu_torch.parallel.aggregator",
    "make_sharded_accumulator": "loghisto_tpu_torch.parallel.aggregator",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
