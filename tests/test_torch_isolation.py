"""The port stands alone: ``loghisto_tpu_torch`` imports neither ``jax``
nor any module of ``loghisto_tpu``, runs a dense and a paged interval, a
wheel push and query, a ``TorchMetricSystem`` interval, a fused commit
with lifecycle and drift, a multirow interval, a firehose run with its
OpenTSDB export, and a labeled interval with a group_by, a selector
query and a windowed Prometheus exposition on the CPU without either in
``sys.modules``, and never falls back to the CPU on its own."""

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
        "from loghisto_tpu_torch.lifecycle import LifecycleConfig\n"
        "from loghisto_tpu_torch.anomaly import AnomalyConfig\n"
        "from loghisto_tpu_torch.window import DistributionDriftRule\n"
        "ms = TorchMetricSystem(interval=1.0, num_metrics=8, device='cpu',"
        " config=MetricConfig(bucket_limit=64), retention=((3, 1),),"
        " lifecycle=LifecycleConfig(ttl_intervals=1, check_every=1),"
        " anomaly=AnomalyConfig(min_samples=1))\n"
        "ms.add_rule(DistributionDriftRule('d', 'y'))\n"
        "for i in range(3):\n"
        "    ms.histogram('y', 0.5)\n"
        "    ms.histogram(f'api.u{i}', 0.5)\n"
        "    assert ms.committer.commit(ms.collect_raw_metrics()) == 'fused'\n"
        "assert ms.lifecycle.evicted_series > 0\n"
        "assert ms.anomaly.scored_intervals == 3\n"
        "ms.stop()\n"
        "agg = TorchAggregator(num_metrics=8, batch_size=64, device='cpu',"
        " ingest_path='multirow')\n"
        "agg.record_batch(np.array([agg.registry.id_for('x')] * 100,"
        " np.int32), np.linspace(1, 100, 100, dtype=np.float32))\n"
        "assert agg.collect().metrics['x_count'] == 100.0\n"
        "agg.close()\n"
        "import io\n"
        "import loghisto_tpu_torch.opentsdb, loghisto_tpu_torch.submitter\n"
        "from loghisto_tpu_torch.firehose import run_firehose\n"
        "s = run_firehose(num_metrics=16, batch=1024, seconds=0.2,"
        " interval=0.1, config=MetricConfig(bucket_limit=64),"
        " out=io.StringIO(), device='cpu')\n"
        "assert s['total_samples'] > 0, s\n"
        "from loghisto_tpu_torch.prometheus import windowed_exposition\n"
        "ms = TorchMetricSystem(interval=1.0, num_metrics=16, device='cpu',"
        " config=MetricConfig(bucket_limit=64), retention=((3, 1),),"
        " sys_stats=False)\n"
        "for r in ('/a', '/b'):\n"
        "    ms.histogram('rpc.lat', 0.5, labels={'route': r, 'code': '500'})\n"
        "ms.recorder('rpc.lat', labels={'code': '200', 'route': '/a'})"
        ".record(0.25)\n"
        "ms.backfill_retention([ms.collect_raw_metrics()])\n"
        "gs = ms.query_group_by('rpc.lat{}', by=['route'], window=1.0,"
        " depth=2)\n"
        "assert gs.sizes == {('/a',): 2, ('/b',): 1}, gs.sizes\n"
        "assert gs.groups[('/a',)]['count'] == 2.0\n"
        "assert set(ms.query('rpc.lat{code=500}', 1.0).metrics) == {"
        "'rpc.lat;code=500;route=/a', 'rpc.lat;code=500;route=/b'}\n"
        "text = windowed_exposition(ms.retention, windows=(1.0,)).decode()\n"
        "assert 'rpc_lat_w1s_count{code=\"200\",route=\"/a\"} 1.0' in text,"
        " text\n"
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
    from loghisto_tpu_torch.anomaly import AnomalyConfig
    from loghisto_tpu_torch.lifecycle import LifecycleConfig
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.firehose import make_firehose_step, run_firehose
    from loghisto_tpu_torch.ops.multirow_ingest import make_multirow_ingest
    from loghisto_tpu_torch.ops.sort_ingest import make_sort_ingest_fn
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    factories = [
        lambda: TimeWheel(num_metrics=4),
        lambda: TorchMetricSystem(num_metrics=4, retention=True),
        lambda: TorchMetricSystem(num_metrics=4, retention=True,
                                  lifecycle=LifecycleConfig(),
                                  anomaly=AnomalyConfig()),
        lambda: TorchAggregator(num_metrics=2),
        lambda: make_fused_ingest_fn(64),
        lambda: make_row_ingest(129, 64),
        lambda: make_sparse_ingest_fn(64),
        lambda: PagedStore(4, 64),
        lambda: TorchAggregator(num_metrics=1 << 20),
        lambda: TorchAggregator(num_metrics=8, ingest_path="multirow"),
        lambda: make_multirow_ingest(8, 64),
        lambda: make_sort_ingest_fn(64),
        lambda: make_firehose_step(16, 1024, MetricConfig()),
        lambda: run_firehose(num_metrics=16, batch=1024, seconds=0.1),
    ]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is real")
    for make in factories:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
