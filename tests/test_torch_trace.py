"""``loghisto_tpu_torch/utils/trace.py`` over ``torch.profiler``: region
annotation, start/stop pairing (also when the block raises), the
``LOGHISTO_TRACE_DIR`` routing of ``maybe_capture`` and nesting, with
``torch.profiler`` monkeypatched as the JAX package's ``test_trace.py``
patches ``jax.profiler``; then one real CPU capture, and a CPU
``TorchAggregator.collect()`` under ``LOGHISTO_TRACE_DIR``, each writing
a Chrome trace that holds the region."""

import glob
import json
import os

import numpy as np
import pytest
import torch.profiler

from loghisto_tpu_torch.utils import trace


@pytest.fixture
def profiler_log(monkeypatch):
    """Replace torch.profiler's entry points with call recorders."""
    calls = []

    class FakeProfile:
        def __init__(self, activities):
            calls.append(("profile", tuple(a.name for a in activities)))

        def start(self):
            calls.append(("start",))

        def stop(self):
            calls.append(("stop",))

        def export_chrome_trace(self, path):
            calls.append(("export", path))

    class FakeRecordFunction:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            calls.append(("annot_enter", self.name))
            return self

        def __exit__(self, *exc):
            calls.append(("annot_exit", self.name))

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.profiler, "record_function",
                        FakeRecordFunction)
    return calls


def test_profile_region_annotates(profiler_log):
    with trace.profile_region("ingest"):
        profiler_log.append(("body",))
    assert profiler_log == [
        ("annot_enter", "ingest"), ("body",), ("annot_exit", "ingest"),
    ]


def test_capture_pairs_start_stop(profiler_log):
    with trace.capture("/t/x.json"):
        profiler_log.append(("body",))
    assert profiler_log[1:] == [("start",), ("body",), ("stop",),
                                ("export", "/t/x.json")]
    acts = profiler_log[0][1]
    assert acts[0] == "CPU"
    assert ("CUDA" in acts) is torch.cuda.is_available()


def test_capture_stops_and_exports_on_exception(profiler_log):
    with pytest.raises(RuntimeError):
        with trace.capture("/t/x.json"):
            raise RuntimeError("boom")
    assert profiler_log[1:] == [("start",), ("stop",),
                                ("export", "/t/x.json")]


def test_maybe_capture_routes_to_capture_when_env_set(
    profiler_log, monkeypatch, tmp_path
):
    monkeypatch.setenv("LOGHISTO_TRACE_DIR", str(tmp_path))
    with trace.maybe_capture("collect"):
        pass
    (path,) = [c[1] for c in profiler_log if c[0] == "export"]
    assert os.path.dirname(path) == os.path.join(str(tmp_path), "collect")
    assert os.path.isdir(os.path.dirname(path))
    assert path.endswith(".pt.trace.json")
    assert profiler_log[1:] == [
        ("start",), ("annot_enter", "collect"), ("annot_exit", "collect"),
        ("stop",), ("export", path),
    ]


def test_maybe_capture_routes_to_annotation_when_env_unset(
    profiler_log, monkeypatch
):
    monkeypatch.delenv("LOGHISTO_TRACE_DIR", raising=False)
    with trace.maybe_capture("collect"):
        pass
    assert profiler_log == [
        ("annot_enter", "collect"), ("annot_exit", "collect"),
    ]


def test_maybe_capture_treats_empty_env_as_unset(profiler_log, monkeypatch):
    monkeypatch.setenv("LOGHISTO_TRACE_DIR", "")
    with trace.maybe_capture("collect"):
        pass
    assert ("annot_enter", "collect") in profiler_log
    assert not any(c[0] == "start" for c in profiler_log)


def test_profile_region_nests_inside_capture(profiler_log, monkeypatch,
                                             tmp_path):
    monkeypatch.setenv("LOGHISTO_TRACE_DIR", str(tmp_path))
    with trace.maybe_capture("outer"):
        with trace.profile_region("inner"):
            profiler_log.append(("body",))
    assert [c[0] for c in profiler_log] == [
        "profile", "start", "annot_enter", "annot_enter", "body",
        "annot_exit", "annot_exit", "stop", "export"]
    assert [c[1] for c in profiler_log if c[0] == "annot_enter"] == [
        "outer", "inner"]


def _trace_names(path):
    with open(path) as f:
        doc = json.load(f)
    return {e.get("name") for e in doc["traceEvents"]}


def test_a_real_cpu_capture_writes_a_chrome_trace(tmp_path):
    path = str(tmp_path / "region.json")
    with trace.capture(path):
        with trace.profile_region("loghisto_region"):
            torch.ones(64).cumsum(0)
    assert "loghisto_region" in _trace_names(path)


def test_collect_captures_itself_under_the_env(monkeypatch, tmp_path):
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    monkeypatch.setenv("LOGHISTO_TRACE_DIR", str(tmp_path))
    agg = TorchAggregator(num_metrics=4, batch_size=64, device="cpu")
    try:
        agg.record_batch(np.full(100, agg.registry.id_for("x"), np.int32),
                         np.linspace(1, 100, 100, dtype=np.float32))
        assert agg.collect().metrics["x_count"] == 100.0
    finally:
        agg.close()
    (path,) = glob.glob(str(tmp_path / "loghisto_collect" / "*.json"))
    assert "loghisto_collect" in _trace_names(path)
