"""The port's packages export the reference's package-level names
(``__all__`` of ``loghisto_tpu``, ``loghisto_tpu.ops``,
``loghisto_tpu.obs``, ``loghisto_tpu.resilience``,
``loghisto_tpu.federation``, ``loghisto_tpu.models`` and
``loghisto_tpu.parallel``): every name
with a ported counterpart resolves on
the matching package of ``loghisto_tpu_torch``, and the names still
waiting for a slice are listed below with that slice."""

import importlib
from pathlib import Path

import pytest

import loghisto_tpu
import loghisto_tpu.federation
import loghisto_tpu.models
import loghisto_tpu.obs
import loghisto_tpu.ops
import loghisto_tpu.parallel
import loghisto_tpu.resilience

PACKAGES = ("", ".ops", ".obs", ".resilience", ".federation", ".models",
            ".parallel")

# reference name -> the port's counterpart where the names differ
RENAMED = {"TPUMetricSystem": "TorchMetricSystem",
           "TPUAggregator": "TorchAggregator"}

# names that wait, each with the ROADMAP Queue 1 slice that ports it
WAITING = {
    "": {},
    ".ops": {},
    ".obs": {},
    ".resilience": {},
    ".federation": {},
    ".models": {},
    ".parallel": {},
}


@pytest.mark.parametrize("sub", PACKAGES)
def test_every_ported_reference_name_resolves(sub):
    ref = importlib.import_module("loghisto_tpu" + sub)
    port = importlib.import_module("loghisto_tpu_torch" + sub)
    waiting = WAITING[sub]
    assert set(waiting) <= set(ref.__all__), "a waiting name left"
    missing = []
    for name in ref.__all__:
        if name in waiting:
            continue
        ported = RENAMED.get(name, name)
        if ported not in port.__all__ or getattr(port, ported, None) is None:
            missing.append(name)
    assert not missing, missing
    for name in waiting:
        assert not hasattr(port, name), f"{name} is ported: unlist it"


def test_resilience_all_equals_the_reference():
    import loghisto_tpu_torch.resilience as port

    assert port.__all__ == loghisto_tpu.resilience.__all__
    for name in port.__all__:
        assert getattr(port, name).__module__.startswith(
            "loghisto_tpu_torch.resilience.")


def test_values_are_the_port_modules_own():
    import loghisto_tpu_torch as lh
    from loghisto_tpu_torch import channel, config, metrics, ops, obs
    from loghisto_tpu_torch.obs import health, perfetto, spans
    from loghisto_tpu_torch.ops import codec, stats

    assert lh.MetricSystem is metrics.MetricSystem
    for name in ("FastCounter", "FastRecorder", "FastTimer",
                 "FastTimerToken"):
        assert getattr(lh, name) is getattr(metrics, name)
    assert lh.Channel is channel.Channel
    assert lh.DEFAULT_PERCENTILES is config.DEFAULT_PERCENTILES
    assert lh.DEFAULT_PERCENTILES == loghisto_tpu.DEFAULT_PERCENTILES
    assert ops.dense_stats is stats.dense_stats
    assert ops.compress_np is codec.compress_np
    assert ops.encode_frame is codec.encode_frame
    assert ops.FrameTruncated is codec.FrameTruncated
    assert obs.LatencyHistogram is spans.LatencyHistogram
    assert obs.NULL_RECORDER is spans.NULL_RECORDER
    assert obs.SpanRecorder is spans.SpanRecorder
    assert obs.HealthWatchdog is health.HealthWatchdog
    assert obs.dump_perfetto is perfetto.dump_perfetto
    with pytest.raises(AttributeError):
        lh.no_such_name
    with pytest.raises(AttributeError):
        ops.no_such_name


def test_package_default_system():
    import loghisto_tpu_torch as lh
    from loghisto_tpu_torch.metrics import MetricSystem

    assert lh.Metrics is lh.Metrics
    assert isinstance(lh.Metrics, MetricSystem)
    assert lh.Metrics.interval == loghisto_tpu.Metrics.interval == 60.0


def test_federation_all_equals_the_reference_and_stays_lazy():
    """The federation package exports the reference's ``__all__``; its
    config imports without the receiver or torch (PEP 562), and the
    config's fields and defaults are the reference's."""
    import dataclasses
    import subprocess
    import sys

    import loghisto_tpu_torch.federation as port
    from loghisto_tpu_torch.federation import emitter, receiver

    assert port.__all__ == loghisto_tpu.federation.__all__
    assert port.FederationEmitter is emitter.FederationEmitter
    assert port.FederationReceiver is receiver.FederationReceiver
    with pytest.raises(AttributeError):
        port.no_such_name
    fields = [(f.name, f.default)
              for f in dataclasses.fields(port.FederationConfig)]
    assert fields == [
        (f.name, f.default) for f in dataclasses.fields(
            loghisto_tpu.federation.FederationConfig)]
    code = ("import sys\n"
            "from loghisto_tpu_torch.federation import FederationConfig\n"
            "FederationConfig(port=9)\n"
            "bad = [k for k in sys.modules if k == 'torch' or"
            " k.endswith('federation.receiver')]\n"
            "assert not bad, bad\n")
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_models_all_equals_the_reference_and_loads_lazily():
    """The sketches export the reference's ``__all__``: ``LogHistogram``
    and the ``hll``, ``moments`` and ``tdigest`` modules, each the
    port's own, loaded on first use."""
    import subprocess
    import sys

    import loghisto_tpu_torch.models as port
    from loghisto_tpu_torch.models import hll, loghist, moments, tdigest

    assert port.__all__ == loghisto_tpu.models.__all__
    assert port.LogHistogram is loghist.LogHistogram
    assert (port.hll, port.moments, port.tdigest) == (hll, moments, tdigest)
    for mod in (hll, moments, tdigest):
        assert mod.__name__.startswith("loghisto_tpu_torch.models.")
    with pytest.raises(AttributeError):
        port.no_such_name
    code = ("import sys\n"
            "import loghisto_tpu_torch.models\n"
            "bad = [k for k in sys.modules"
            " if k.startswith('loghisto_tpu_torch.models.')]\n"
            "assert not bad, bad\n")
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_parallel_all_is_the_reference_s_and_loads_lazily():
    """``parallel`` exports the reference's ``__all__`` (the aggregator
    under its port name), each the port's own, loaded on first use: a
    bare import of the package loads neither its submodules nor
    ``torch.distributed``."""
    import subprocess
    import sys

    import loghisto_tpu_torch.parallel as port
    from loghisto_tpu_torch.parallel import aggregator, mesh

    assert port.__all__ == sorted(
        RENAMED.get(n, n) for n in loghisto_tpu.parallel.__all__)
    assert port.TorchAggregator is aggregator.TorchAggregator
    assert port.make_mesh is mesh.make_mesh
    assert (port.STREAM_AXIS, port.METRIC_AXIS) == ("stream", "metric")
    for name in ("make_distributed_step", "make_interval_distributed_step",
                 "make_sharded_accumulator"):
        assert getattr(port, name) is getattr(aggregator, name)
    with pytest.raises(AttributeError):
        port.no_such_name
    code = ("import sys\n"
            "import loghisto_tpu_torch.parallel\n"
            "bad = [k for k in sys.modules if k.startswith("
            "('loghisto_tpu_torch.parallel.', 'torch.distributed'))]\n"
            "assert not bad, bad\n")
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
