"""The firehose, its dispatched steps and the OpenTSDB export, against
the JAX package.

  * ``zipf_cdf``: EQUAL to the JAX package's.
  * ``ingest_step_fn(p)``: the port's step and the JAX package's on one
    numpy batch give EQUAL accumulators, for every path with a step form
    (JAX's Pallas steps, "pallas" and "fused", in interpret mode).
  * The firehose's generator is a ``torch.Generator``, not the JAX key
    stream, so the two firehoses agree in distribution only: the paths
    are held EQUAL to one another on one generator seed, and the
    generated ids and values against the Zipf(1.3) CDF and the lognormal
    parameters (tolerances stated at each check).
  * ``opentsdb_protocol``: the same BYTES as the JAX package's on the same
    metrics, timestamp and hostname, with and without ``labeled_tags``.
  * The mesh firehose (ROADMAP D8) on a (2, 2) mesh of four gloo ranks
    (``test_torch_ranks.launch``, one launch for the module): the ranks
    of a stream row draw the same samples and the rows different ones;
    the blocks of every dispatched path are EQUAL to "scatter"'s and
    conserve the two batches; ``run_firehose(mesh=)`` runs end to end
    with every interval's counts conserved, and only rank 0 sends.
"""

import datetime as dt
import io
import re
import socket
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loghisto_tpu.firehose import zipf_cdf as jax_zipf_cdf
from loghisto_tpu.labels.model import split_processed as jax_split_processed
from loghisto_tpu.metrics import ProcessedMetricSet as JaxProcessedMetricSet
from loghisto_tpu.ops.codec import compress_np
from loghisto_tpu.ops.dispatch import ingest_step_fn as jax_ingest_step_fn
from loghisto_tpu.ops.ingest import bucket_indices as jax_bucket_indices
from loghisto_tpu.opentsdb import opentsdb_protocol as jax_opentsdb_protocol
from loghisto_tpu_torch import firehose
from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.firehose import (
    _make_sample_generator,
    main,
    make_firehose_step,
    run_firehose,
    zipf_cdf,
)
from loghisto_tpu_torch.metrics import ProcessedMetricSet
from loghisto_tpu_torch.ops.dispatch import ingest_step_fn
from loghisto_tpu_torch.opentsdb import (
    OpenTSDBProtocol,
    opentsdb_protocol,
    split_processed,
)
from loghisto_tpu_torch.submitter import send_once


@pytest.mark.parametrize("m", [1, 2, 100, 10_000])
def test_zipf_cdf_equals_jax(m):
    got, want = zipf_cdf(m), jax_zipf_cdf(m)
    assert got.dtype == np.float32 and got[-1] == 1.0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("path,m", [
    ("scatter", 37), ("sort", 37), ("sortscan", 37), ("hybrid", 37),
    ("matmul", 37), ("fused", 16), ("pallas", 1),
])
def test_ingest_step_fn_equals_jax(path, m):
    bl = 256
    rng = np.random.default_rng(3)
    values = rng.lognormal(3, 2, 12_000).astype(np.float32)
    values[:32] = np.nan
    values[32:64] *= -1
    jidx = np.asarray(jax_bucket_indices(jnp.asarray(values), bl)) - bl
    values = values[jidx == np.clip(compress_np(values), -bl, bl)][:5000]
    ids = rng.integers(-1, m + 2, len(values)).astype(np.int32)
    start = rng.integers(0, 50, (m, 2 * bl + 1)).astype(np.int32)
    want = jax_ingest_step_fn(path)(
        jnp.asarray(start), jnp.asarray(ids), jnp.asarray(values), bl, 100)
    got = ingest_step_fn(path)(
        torch.from_numpy(start.copy()), torch.from_numpy(ids),
        torch.from_numpy(values), bl, 100)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_firehose_step_accumulates_a_zipf_load():
    cfg = MetricConfig(bucket_limit=1024)
    step = make_firehose_step(64, 4096, cfg, device="cpu")
    acc = torch.zeros((64, cfg.num_buckets), dtype=torch.int32)
    gen = torch.Generator().manual_seed(1)
    acc, gen = step(acc, gen)
    acc, gen = step(acc, gen)
    assert int(acc.sum()) == 2 * 4096
    rows = acc.sum(dim=1)
    assert int(rows[0]) == int(rows.max())  # metric 0 is hottest
    assert step.ingest_path == "fused"


def test_generator_follows_the_zipf_cdf_and_the_lognormal():
    """Each id's share within 5 binomial sigmas of its Zipf(1.3)
    probability; the mean and std of log(values) within 1% of 10 and 2
    (the JAX generator's parameters)."""
    m, n = 50, 1 << 18
    gen = torch.Generator().manual_seed(5)
    ids, values = _make_sample_generator(m, 10.0, 2.0,
                                         torch.device("cpu"))(gen, n)
    assert ids.dtype == torch.int32 and values.dtype == torch.float32
    assert int(ids.min()) >= 0 and int(ids.max()) < m
    p = np.diff(np.concatenate([[0.0], jax_zipf_cdf(m).astype(np.float64)]))
    share = np.bincount(ids.numpy(), minlength=m) / n
    assert (np.abs(share - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-9).all()
    logs = np.log(values.numpy().astype(np.float64))
    assert logs.mean() == pytest.approx(10.0, rel=0.01)
    assert logs.std() == pytest.approx(2.0, rel=0.01)


@pytest.mark.parametrize("m,paths", [
    (64, ("auto", "scatter", "sort", "sortscan", "hybrid", "matmul")),
    (1, ("auto", "pallas", "matmul", "scatter")),
])
def test_firehose_paths_agree_on_one_seed(m, paths):
    cfg = MetricConfig(bucket_limit=512)
    accs = {}
    for path in paths:
        step = make_firehose_step(m, 2048, cfg, ingest_path=path,
                                  device="cpu")
        acc = torch.zeros((m, cfg.num_buckets), dtype=torch.int32)
        acc, _ = step(acc, torch.Generator().manual_seed(7))
        accs[path] = acc
    for path in paths:
        assert torch.equal(accs[path], accs["auto"]), path
    assert int(accs["auto"].sum()) == 2048


def test_firehose_refuses_multirow_and_a_mesh():
    cfg = MetricConfig(bucket_limit=64)
    with pytest.raises(ValueError, match="multirow"):
        make_firehose_step(16, 2048, cfg, ingest_path="multirow",
                           device="cpu")
    # a mesh whose axes are not ("stream", "metric"), in the reference's
    # words of its mesh-shape edges
    wrong = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    with pytest.raises(ValueError, match=re.escape(
            "mesh shape: mesh axes ('data', 'model') are not the "
            "('stream', 'metric') layout")):
        run_firehose(num_metrics=16, batch=1024, seconds=0.1, config=cfg,
                     mesh=wrong, device="cpu")


def test_run_firehose_end_to_end():
    out = io.StringIO()
    summary = run_firehose(
        num_metrics=64, batch=4096, seconds=0.6, interval=0.2,
        config=MetricConfig(bucket_limit=1024), out=out, device="cpu",
    )
    assert summary["total_samples"] > 0 and summary["intervals"] >= 1
    assert summary["platform"] == "cpu"
    report = out.getvalue()
    assert "samples" in report and "bytes serialized" in report


class _StepClock:
    """A stand-in for ``firehose.time``: every ``perf_counter()`` read
    (one a step of the interval loop) moves the clock ``tick`` seconds,
    so the loop's shape does not depend on how fast the host runs."""

    def __init__(self, tick):
        self.t = 0.0
        self.tick = tick

    def perf_counter(self):
        self.t += self.tick
        return self.t

    def perf_counter_ns(self):
        return int(self.t * 1e9)


def test_firehose_int32_budget_closes_interval_early(monkeypatch):
    # a 0.6 s interval spans about 5 reads of a 0.1 s step clock, room
    # for 4-5 steps of 4096: the 8192-sample budget closes it after 2
    monkeypatch.setattr(firehose, "time", _StepClock(0.1))
    out = io.StringIO()
    summary = run_firehose(
        num_metrics=16, batch=4096, seconds=1.2, interval=0.6,
        config=MetricConfig(bucket_limit=128), out=out,
        max_interval_samples=8192, device="cpu",
    )
    assert "int32 accumulator budget" in out.getvalue()
    reports = re.findall(r"^interval \d+: ([\d,]+) samples", out.getvalue(),
                         re.M)
    assert reports and summary["intervals"] >= 1
    for count in reports:
        assert int(count.replace(",", "")) <= 8192 + 4096


class _Listener:
    def __init__(self):
        self.srv = socket.create_server(("127.0.0.1", 0))
        self.srv.settimeout(0.2)
        self.address = self.srv.getsockname()
        self.payloads = []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        while not self.stop.is_set():
            try:
                conn, _ = self.srv.accept()
            except socket.timeout:
                continue
            with conn:
                chunks = []
                while chunk := conn.recv(1 << 16):
                    chunks.append(chunk)
                self.payloads.append(b"".join(chunks))

    def close(self):
        self.stop.set()
        self.thread.join(timeout=5.0)
        assert not self.thread.is_alive()
        self.srv.close()


def test_run_firehose_exports_opentsdb_lines_to_a_sink():
    sink = _Listener()
    try:
        out = io.StringIO()
        summary = run_firehose(
            num_metrics=32, batch=2048, seconds=0.5, interval=0.25,
            config=MetricConfig(bucket_limit=256), out=out, device="cpu",
            sink=sink.address,
        )
        assert "export sent" in out.getvalue()
    finally:
        sink.close()
    assert len(sink.payloads) == summary["intervals"]
    line = re.compile(r"put firehose_\d+_\S+ \d+ -?\d+\.\d{6} host=\S+\Z")
    for payload in sink.payloads:
        lines = payload.decode().splitlines()
        assert lines and all(line.match(ln) for ln in lines)
        assert any(ln.startswith("put firehose_0_count ") for ln in lines)


def test_send_once_reports_a_refused_dial():
    probe = socket.create_server(("127.0.0.1", 0))
    address = probe.getsockname()
    probe.close()
    assert isinstance(send_once("tcp", address, b"x", timeout=1.0), OSError)


NAMES = {
    "http.latency;code=500;route=/api_99": 12.5,
    "http.latency;code=500;route=/api_count": 3.0,
    "http.latency;code=500;route=/api_agg_count": 9.0,
    "http.latency;code=500;route=/api_min": 0.25,
    "http.latency;host=pod7_99.9": 1.0,
    "flat.metric_sum": 331132.69,
    "flat_rate": -2.0,
    "weird;notapair_max": 4.0,
}


@pytest.mark.parametrize("labeled", [False, True])
@pytest.mark.parametrize("tags", [None, {"host": "h1", "dc": "east"}])
def test_opentsdb_bytes_equal_jax(labeled, tags):
    t = dt.datetime(2026, 10, 16, 12, 0, 0, tzinfo=dt.timezone.utc)
    got = opentsdb_protocol(ProcessedMetricSet(time=t, metrics=dict(NAMES)),
                            tags=tags, hostname="box", labeled_tags=labeled)
    want = jax_opentsdb_protocol(
        JaxProcessedMetricSet(time=t, metrics=dict(NAMES)), tags=tags,
        hostname="box", labeled_tags=labeled)
    assert got == want
    assert OpenTSDBProtocol is opentsdb_protocol


def test_split_processed_equals_jax():
    for name in [*NAMES, "a;b=c", "a;=c_count", "x;k=v;k2=v2_50", "plain"]:
        assert split_processed(name) == jax_split_processed(name), name


def test_cli_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is real")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--metrics", "16", "--seconds", "0.1", "--batch", "1024"])
    with pytest.raises(RuntimeError, match="device='cpu'"):  # NCCL's card
        main(["--metrics", "16", "--seconds", "0.1", "--mesh"])
    assert jax.devices()[0].platform == "cpu"


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    import test_torch_ranks as R

    sink = _Listener()
    try:
        res = R.launch(tmp_path_factory.mktemp("firehose"),
                       R.FH_SHAPE[0] * R.FH_SHAPE[1], "firehose",
                       {"sink_port": np.array(sink.address[1])})
    finally:
        sink.close()
    return res, sink.payloads


def test_mesh_ranks_of_a_stream_row_draw_the_same_samples(mesh_ranks):
    res, _ = mesh_ranks
    draws = {tuple(r["coord"].tolist()): r["first_draw"] for r in res}
    np.testing.assert_array_equal(draws[(0, 0)], draws[(0, 1)])
    np.testing.assert_array_equal(draws[(1, 0)], draws[(1, 1)])
    assert not np.array_equal(draws[(0, 0)], draws[(1, 0)])


def test_mesh_firehose_dispatched_path_matches_scatter(mesh_ranks):
    import test_torch_ranks as R

    res, _ = mesh_ranks
    blocks = {}
    for r in res:
        s, m = r["coord"].tolist()
        for path in R.FH_PATHS:
            np.testing.assert_array_equal(r[f"{path}.acc"],
                                          r["scatter.acc"])
            assert int(r[f"{path}.fresh_sum"]) == 0
        assert str(r["auto.path"]) == "fused"
        blocks.setdefault(m, r["scatter.acc"])
        np.testing.assert_array_equal(blocks[m], r["scatter.acc"])
    # two batches over the whole mesh, every sample in one block
    assert sum(int(b.sum()) for b in blocks.values()) == 2 * R.FH_BATCH


def test_run_firehose_over_a_mesh_end_to_end(mesh_ranks):
    res, payloads = mesh_ranks
    for r in res:
        assert int(r["run.intervals"]) >= 1
        assert int(r["run.total_samples"]) > 0
        assert int(r["run.collected_samples"]) == int(r["run.total_samples"])
        assert str(r["run.platform"]) == "cpu"
        for key in ("run.intervals", "run.total_samples"):
            assert int(r[key]) == int(res[0][key])  # the mesh's summary
    assert len(payloads) == int(res[0]["run.intervals"])  # rank 0 only
    assert all(p.startswith(b"put firehose_") for p in payloads)
