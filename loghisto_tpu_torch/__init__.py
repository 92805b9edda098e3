"""loghisto_tpu_torch — the PyTorch/CUDA port of ``loghisto_tpu``.

The JAX package ``loghisto_tpu`` is the reference; this package mirrors
its module paths (each module's docstring names its counterpart) and is
held against it by ``tests/test_torch_*.py``.  It imports ``torch`` and
``numpy`` only: never ``jax``, and no module of ``loghisto_tpu``.

Entry points (``TorchMetricSystem``, ``TimeWheel``, ``TorchAggregator``
and the ``make_*`` factories) run on
the card (``device="cuda"``) unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit ``device=``, they raise.  On a CUDA
tensor every kernel wrapper launches its hand-written Hopper kernel
(``csrc/``) or raises; the plain PyTorch versions serve CPU tensors
only.

The package-level names are the reference's: the host tier
(``MetricSystem``, ``Channel``, ``RawMetricSet`` ...), the default
system ``Metrics`` (``MetricSystem(interval=60.0, sys_stats=True)``,
built on first use and not started) and ``TorchMetricSystem`` in the
place of ``TPUMetricSystem``, and the fast-ingest handles
(``FastCounter``, ``FastRecorder``, ``FastTimer``, ``FastTimerToken``)
that ``MetricSystem(fast_ingest=True)`` hands out.  Every name loads on
first use (PEP 562), so importing one submodule does not import the
whole system.
"""

import importlib
import threading

__version__ = "0.1.0"

_LAZY = {
    "Channel": "loghisto_tpu_torch.channel",
    "ChannelClosed": "loghisto_tpu_torch.channel",
    "DEFAULT_PERCENTILES": "loghisto_tpu_torch.config",
    "FastCounter": "loghisto_tpu_torch.metrics",
    "FastRecorder": "loghisto_tpu_torch.metrics",
    "FastTimer": "loghisto_tpu_torch.metrics",
    "FastTimerToken": "loghisto_tpu_torch.metrics",
    "MetricConfig": "loghisto_tpu_torch.config",
    "MetricSystem": "loghisto_tpu_torch.metrics",
    "ProcessedMetricSet": "loghisto_tpu_torch.metrics",
    "RawMetricSet": "loghisto_tpu_torch.metrics",
    "TimerToken": "loghisto_tpu_torch.metrics",
    "merge_raw_metric_sets": "loghisto_tpu_torch.metrics",
    "TimeWheel": "loghisto_tpu_torch.window.store",
    "TorchMetricSystem": "loghisto_tpu_torch.system",
}

__all__ = sorted([*_LAZY, "Metrics"])

_metrics_lock = threading.Lock()


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    if name == "Metrics":
        # the reference's `var Metrics = NewMetricSystem(60*time.Second,
        # true)`: built once, then served from the module's globals
        with _metrics_lock:
            if "Metrics" not in globals():
                from loghisto_tpu_torch.metrics import MetricSystem

                globals()["Metrics"] = MetricSystem(interval=60.0,
                                                    sys_stats=True)
        return globals()["Metrics"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
