"""The port's PrintBenchmark (``loghisto_tpu_torch/print_benchmark.py``)
against the reference's: the metric list is EQUAL to the JAX package's,
a block formatted from a hand-built set follows the reference's line
rule, and host and ``device="cpu"`` runs return, leave none of their
threads alive and print only whole blocks.

A run asserts only what any window gives: how many blocks a short run
prints depends on the host's load, so no count of blocks or samples is
asserted.
"""

import datetime as dt
import io
import threading

import pytest
import torch

from loghisto_tpu.print_benchmark import _interesting_metrics as jax_list
from loghisto_tpu_torch.metrics import ProcessedMetricSet
from loghisto_tpu_torch.print_benchmark import (
    _interesting_metrics,
    format_block,
    main,
    print_benchmark,
)


def _bench_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("loghisto-bench-") and t.is_alive()]


def _blocks(report):
    """The printed blocks, each a list of lines; asserts the text is
    whole blocks separated by blank lines."""
    assert report == "" or report.endswith("\n\n"), report[-200:]
    return [b.split("\n") for b in report.split("\n\n") if b]


def _assert_whole(report, name):
    want = _interesting_metrics(name)
    blocks = _blocks(report)
    for block in blocks:
        assert len(block) == 1 + len(want), block
        dt.datetime.fromisoformat(block[0])  # the interval's time
        assert [ln.split(":")[0] for ln in block[1:]] == want
        for ln in block[1:]:
            float(ln.split("\t")[-1])
    return blocks


@pytest.mark.parametrize("name", ["bench_op", "x"])
def test_metric_list_equals_the_jax_list(name):
    assert _interesting_metrics(name) == jax_list(name)
    assert len(_interesting_metrics(name)) == 19


def test_block_follows_the_reference_line_rule():
    t = dt.datetime(2026, 2, 3, 4, 5, 6, tzinfo=dt.timezone.utc)
    metrics = {"op_count": 12.0, "op_99.9": 3.25, "sys.NumGC": 7.0,
               "other": 1.0}
    pms = ProcessedMetricSet(time=t, metrics=metrics)
    names = jax_list("op")
    width = max(len(m) for m in names) + 1
    # print_benchmark.go's tabwriter rule as the reference's rebuild
    # writes it: name and colon left-aligned to the widest, a tab, the
    # value (0 when the interval has none)
    want = "\n".join([str(t)] + [
        f"{m + ':':<{width}}\t{metrics.get(m, 0)}" for m in names
    ]) + "\n\n"
    assert format_block(pms.time, pms.metrics, names) == want
    (block,) = _assert_whole(want, "op")
    assert block[1] == "op_count:".ljust(width) + "\t12.0"
    assert block[-1] == "sys.NumGoroutine:".ljust(width) + "\t0"


@pytest.mark.parametrize("device,handles", [(False, False), (False, True),
                                            ("cpu", False)])
def test_a_run_returns_and_prints_whole_blocks(device, handles):
    out = io.StringIO()
    print_benchmark("run_op", concurrency=2, op=lambda: None,
                    duration=0.6, interval=0.2, out=out, device=device,
                    handles=handles)
    assert not _bench_threads()
    for block in _assert_whole(out.getvalue(), "run_op"):
        values = {k.strip().rstrip(":"): float(v)
                  for k, v in (ln.split("\t") for ln in block[1:])}
        if values["run_op_count"]:
            assert values["run_op_min"] <= values["run_op_50"] \
                <= values["run_op_max"]


def test_device_true_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=True runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        print_benchmark("x", concurrency=1, op=lambda: None, duration=0.1,
                        interval=0.1, out=io.StringIO(), device=True)
    assert not _bench_threads()


@pytest.mark.parametrize("extra", [[], ["--device", "cpu", "--handles"]])
def test_cli_smoke(extra, capsys):
    main(["--concurrency", "2", "--seconds", "0.3", "--interval", "0.1",
          *extra])
    out = capsys.readouterr().out
    _assert_whole(out, "benchmark_op")
    assert "benchmark_op_count:" in out or out == ""
    assert not _bench_threads()
