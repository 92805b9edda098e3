"""The port stands alone: ``loghisto_tpu_torch`` imports neither ``jax``
nor any module of ``loghisto_tpu``, runs a dense and a paged interval, a
wheel push and query and a ``TorchMetricSystem`` interval on the CPU
without either in ``sys.modules``, and never falls back to the CPU on its
own."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "loghisto_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "loghisto_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):  # includes imports inside functions
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 15
    bad = [
        (f.relative_to(ROOT), mod)
        for f in files for mod in _imported_modules(f)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_interval_runs_without_jax_in_sys_modules():
    code = (
        "import sys, numpy as np\n"
        "from loghisto_tpu_torch.parallel.aggregator import TorchAggregator\n"
        "agg = TorchAggregator(num_metrics=4, batch_size=64, device='cpu')\n"
        "agg.record_batch(np.array([agg.registry.id_for('x')] * 100,"
        " np.int32), np.linspace(1, 100, 100, dtype=np.float32))\n"
        "m = agg.collect().metrics\n"
        "agg.close()\n"
        "assert m['x_count'] == 100.0, m\n"
        "import loghisto_tpu_torch.paging, loghisto_tpu_torch.ops.paged_store\n"
        "for tr, ip in (('sparse', 'auto'), ('raw', 'fused')):\n"
        "    agg = TorchAggregator(num_metrics=4, batch_size=64, device='cpu',"
        " storage='paged', transport=tr, ingest_path=ip)\n"
        "    agg.record_batch(np.array([agg.registry.id_for('x')] * 100,"
        " np.int32), np.linspace(1, 100, 100, dtype=np.float32))\n"
        "    m = agg.collect().metrics\n"
        "    agg.close()\n"
        "    assert agg.storage == 'paged' and m['x_count'] == 100.0, m\n"
        "from loghisto_tpu_torch import TimeWheel, TorchMetricSystem\n"
        "from loghisto_tpu_torch.config import MetricConfig\n"
        "from loghisto_tpu_torch.metrics import RawMetricSet\n"
        "import datetime as dt\n"
        "w = TimeWheel(num_metrics=4, config=MetricConfig(bucket_limit=64),"
        " tiers=((3, 1), (2, 2)), device='cpu')\n"
        "t = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)\n"
        "for i in range(4):\n"
        "    w.push(RawMetricSet(t, {}, {'req': 5}, {'x': {3: 2, 9: 1}}, {},"
        " 1.0))\n"
        "assert w.query('x', 2.0).metrics['x']['count'] == 6.0\n"
        "assert w.window_rate('req', 3.0) == 5.0\n"
        "ms = TorchMetricSystem(interval=1.0, num_metrics=4, device='cpu',"
        " config=MetricConfig(bucket_limit=64), retention=((3, 1),))\n"
        "ms.histogram('y', 0.5)\n"
        "raw = ms.collect_raw_metrics()\n"
        "ms.retention.push(raw)\n"
        "ms.aggregator.merge_raw(raw)\n"
        "assert ms.device_metrics().metrics['y_count'] == 1.0\n"
        "assert ms.query_window('y', 1.0).metrics['y']['count'] == 1.0\n"
        "ms.stop()\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'loghisto_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_the_card():
    from loghisto_tpu_torch.ops.fused_ingest import make_fused_ingest_fn
    from loghisto_tpu_torch.ops.row_ingest import make_row_ingest
    from loghisto_tpu_torch.paging import PagedStore
    from loghisto_tpu_torch.ops.sparse_ingest import make_sparse_ingest_fn
    from loghisto_tpu_torch import TimeWheel, TorchMetricSystem
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    factories = [
        lambda: TimeWheel(num_metrics=4),
        lambda: TorchMetricSystem(num_metrics=4, retention=True),
        lambda: TorchAggregator(num_metrics=2),
        lambda: make_fused_ingest_fn(64),
        lambda: make_row_ingest(129, 64),
        lambda: make_sparse_ingest_fn(64),
        lambda: PagedStore(4, 64),
        lambda: TorchAggregator(num_metrics=1 << 20),
    ]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is real")
    for make in factories:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
