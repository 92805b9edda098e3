"""Synthetic latency firehose: on-device sample generation -> dense
aggregation -> per-interval export replay (counterpart of
``loghisto_tpu/firehose.py``; BASELINE configuration 4, "1B-sample/sec
synthetic latency firehose -> OpenTSDB submitter replay").

A host cannot ship a billion samples a second to the card, so the
firehose makes them on the card — Zipf(1.3) metric ids by inverse-CDF
``searchsorted`` on the float32 CDF, lognormal latencies
``exp(mean + sigma * normal)`` in float32 — and accumulates each batch
with the step of the chosen ingest path (ops/dispatch.py
``ingest_step_fn``).  There is no host staging and no host-to-device
copy: only each interval's statistics leave the card, serialized with
the OpenTSDB protocol and sent to a sink or summarized.

Random numbers come from an explicit ``torch.Generator`` on the device,
seeded from ``seed``.  They are not the JAX key stream's numbers, so the
two packages' firehoses agree in distribution, not sample for sample.

Over a ("stream", "metric") mesh (``mesh=``, ROADMAP D8) every rank
makes its stream row's share of each batch with a generator seeded from
``(seed, stream row)`` (``stream_generator``: the ranks of one row draw
the same samples, as the reference's ``fold_in(key, stream index)``),
keeps the ids of its metric block and folds them into its partial with
zero collectives; one int32 ``all_reduce`` over the stream axis per
interval merges the partials (``make_mesh_firehose_interval_step``).
One program drives every device in the reference; here each rank runs
its own clock, so at each interval's end the ranks of a stream row
catch up to the row's step count (one small ``all_reduce`` over the
metric axis), and all ranks agree whether to run another interval, so
they make the same collectives.  Only rank 0 sends to the sink.

CLI: python -m loghisto_tpu_torch.firehose --metrics 10000 --seconds 5
     [--batch 4194304] [--interval 1.0] [--sink host:port]
     [--ingest-path auto] [--seed 0] [--mesh [--mesh-metric 1]]
     (``--mesh`` joins the process group the launcher's environment
     names, as torchrun sets it, one card per rank)
"""

from __future__ import annotations

import datetime as _dt
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from loghisto_tpu_torch.config import DEFAULT_PERCENTILES, MetricConfig
from loghisto_tpu_torch.metrics import ProcessedMetricSet
from loghisto_tpu_torch.opentsdb import opentsdb_protocol
from loghisto_tpu_torch.parallel.mesh import (
    METRIC_AXIS,
    STREAM_AXIS,
    axis_group,
    axis_index,
    axis_size,
    block_ids,
    block_rows,
    check_mesh,
    gather_parts,
    mesh_device,
    mesh_reduce,
)


def zipf_cdf(num_metrics: int, s: float = 1.3) -> np.ndarray:
    weights = 1.0 / np.arange(1, num_metrics + 1, dtype=np.float64) ** s
    cdf = np.cumsum(weights)
    return (cdf / cdf[-1]).astype(np.float32)


def _make_sample_generator(num_metrics: int, mean: float, sigma: float,
                           device: torch.device):
    """generate(gen, n) -> (ids int32 [n], values float32 [n]) on
    ``device``: Zipf-skewed ids (first CDF entry >= u, as
    ``jnp.searchsorted``'s side "left") and lognormal values."""
    cdf = torch.from_numpy(zipf_cdf(num_metrics)).to(device)

    def generate(gen: torch.Generator, n: int):
        u = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
        ids = torch.searchsorted(cdf, u).to(torch.int32)
        normal = torch.randn(n, generator=gen, device=device,
                             dtype=torch.float32)
        values = torch.exp(mean + sigma * normal)
        return ids, values

    return generate


def make_firehose_step(
    num_metrics: int,
    batch: int,
    config: MetricConfig,
    mean: float = 10.0,
    sigma: float = 2.0,
    ingest_path: str = "auto",
    device=None,
):
    """step(acc, gen) -> (acc, gen): generate one batch on ``device``
    (default the card) with the generator ``gen`` and accumulate it into
    acc int32 [M, B] in place, through the resolved path's step."""
    from loghisto_tpu_torch.ops.backend import resolve_device
    from loghisto_tpu_torch.ops.dispatch import (
        ingest_step_fn,
        resolve_ingest_path,
    )

    dev = resolve_device(device)
    ingest_path = resolve_ingest_path(
        ingest_path, num_metrics, batch_size=batch,
        num_buckets=config.num_buckets,
    )
    accumulate = ingest_step_fn(ingest_path)
    generate = _make_sample_generator(num_metrics, mean, sigma, dev)

    def step(acc, gen):
        ids, values = generate(gen, batch)
        acc = accumulate(acc, ids, values, config.bucket_limit,
                         config.precision)
        return acc, gen

    step.ingest_path = ingest_path
    return step


def stream_generator(mesh, seed: int = 0) -> torch.Generator:
    """This rank's sample generator on its mesh device, seeded from
    ``(seed, stream row)``: the ranks of one stream row draw the same
    samples, and different rows draw independent ones."""
    check_mesh(mesh)
    row_seed = np.random.SeedSequence(
        [seed, axis_index(mesh, STREAM_AXIS)]).generate_state(1, np.uint64)
    gen = torch.Generator(device=mesh_device(mesh))
    gen.manual_seed(int(row_seed[0]) & ((1 << 63) - 1))
    return gen


def make_mesh_firehose_interval_step(
    mesh,
    num_metrics: int,
    batch: int,
    config: MetricConfig,
    mean: float = 10.0,
    sigma: float = 2.0,
    ingest_path: str = "auto",
):
    """Interval-amortized distributed firehose (the firehose twin of
    ``parallel.aggregator.make_interval_distributed_step``): each rank
    makes its stream row's ``batch / n_stream`` samples with its
    ``stream_generator`` and folds the ids of its metric block into its
    partial block with ZERO collectives; the stream-axis ``all_reduce``
    runs once per collect, into the block of the accumulator.

    Returns (ingest, collect, make_partial):
      ingest(partial, gen) -> (partial, gen)   collective-free batch
      collect(acc, partial) -> (acc, fresh_partial)  one all_reduce
    """
    from loghisto_tpu_torch.ops.dispatch import (
        ingest_step_fn,
        resolve_ingest_path,
    )

    check_mesh(mesh)
    n_stream = axis_size(mesh, STREAM_AXIS)
    n_metric = axis_size(mesh, METRIC_AXIS)
    if num_metrics % n_metric or batch % n_stream:
        raise ValueError("metrics/batch must divide the mesh axes")
    lo, rows = block_rows(mesh, num_metrics)
    local_batch = batch // n_stream
    dev = mesh_device(mesh)
    ingest_path = resolve_ingest_path(
        ingest_path, num_metrics, batch_size=local_batch,
        num_buckets=config.num_buckets, mesh=mesh,
    )
    accumulate = ingest_step_fn(ingest_path)
    generate = _make_sample_generator(num_metrics, mean, sigma, dev)
    stream_group = axis_group(mesh, STREAM_AXIS)

    def ingest(partial, gen):
        ids, values = generate(gen, local_batch)
        accumulate(partial, block_ids(ids, lo, rows), values,
                   config.bucket_limit, config.precision)
        return partial, gen

    def collect(acc, partial):
        dist.all_reduce(partial, group=stream_group)
        acc += partial
        return acc, partial.zero_()

    def make_partial() -> torch.Tensor:
        return torch.zeros((rows, config.num_buckets), dtype=torch.int32,
                           device=dev)

    ingest.ingest_path = ingest_path
    return ingest, collect, make_partial


def run_firehose(
    num_metrics: int = 10_000,
    batch: int = 1 << 22,
    seconds: float = 5.0,
    interval: float = 1.0,
    sink: Optional[tuple[str, int]] = None,
    config: Optional[MetricConfig] = None,
    mesh=None,
    out=sys.stdout,
    max_inflight: int = 8,
    ingest_path: str = "auto",
    max_interval_samples: Optional[int] = None,
    recorder=None,
    device=None,
    seed: int = 0,
) -> dict:
    """Run the firehose on ``device`` (default the card); returns a
    summary dict (samples/s, intervals, and ``collected_samples``, the
    count the intervals' statistics hold).  With ``mesh`` every rank of
    the mesh runs it (on the mesh's device) and the summary is the
    mesh's.  ``max_interval_samples`` overrides the int32-exactness
    early-close budget (default 2^31 - batch; on a mesh each stream
    row keeps its share).  ``recorder`` records a span per step, per interval
    and per export (the no-op recorder by default).  ``max_inflight``
    bounds the steps queued on the card: every ``max_inflight`` steps
    the host waits for the device, so an interval's count is work the
    card kept up with, not a backlog."""
    from loghisto_tpu_torch.obs.spans import NULL_RECORDER
    from loghisto_tpu_torch.ops.backend import resolve_device
    from loghisto_tpu_torch.ops.stats import dense_stats

    rec = recorder if recorder is not None else NULL_RECORDER
    config = config or MetricConfig()
    if mesh is not None:
        from loghisto_tpu_torch.parallel.aggregator import (
            make_sharded_accumulator,
        )

        ingest, collect, make_partial = make_mesh_firehose_interval_step(
            mesh, num_metrics, batch, config, ingest_path=ingest_path)
        dev = mesh_device(mesh)
        n_stream = axis_size(mesh, STREAM_AXIS)
        sender = dist.get_rank() == 0
        path = ingest.ingest_path
    else:
        dev = resolve_device(device)
        step = make_firehose_step(
            num_metrics, batch, config, ingest_path=ingest_path, device=dev
        )
        n_stream, sender, path = 1, True, step.ingest_path

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    labels, ps = zip(*(
        (label, p) for label, p in DEFAULT_PERCENTILES.items()
        if 0.0 <= p <= 1.0
    ))
    ps = np.asarray(ps, dtype=np.float32)

    if mesh is not None:
        acc = make_sharded_accumulator(mesh, num_metrics, config.num_buckets)
        partial = make_partial()
        gen = stream_generator(mesh, seed)
        partial, gen = ingest(partial, gen)  # warm-up: both programs
        acc, partial = collect(acc, partial)

        def step(acc, gen):  # the partial folds; acc waits for collect
            ingest(partial, gen)
            return acc, gen
    else:
        acc = torch.zeros((num_metrics, config.num_buckets),
                          dtype=torch.int32, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        acc, gen = step(acc, gen)  # warm-up: kernels built and loaded
    sync()
    acc.zero_()  # discard the warm-up samples

    # int32-exactness budget: the worst case puts every sample of an
    # interval in one cell, so the interval closes before 2^31 instead
    # of wrapping (the aggregator spills to host int64 for the same
    # reason; the synthetic load just closes the interval, which is
    # exact).  The stream all_reduce sums n_stream partials, so each
    # stream row keeps its share.
    if max_interval_samples is None:
        max_interval_samples = (1 << 31) - batch
    local_batch = batch // n_stream
    local_budget = max_interval_samples // n_stream

    def more():
        """Another interval?  On a mesh the ranks agree (any rank whose
        clock ran out ends it for all), so they make one collect each."""
        done = time.perf_counter() - t_start >= seconds
        if mesh is not None:
            done = bool(mesh_reduce(mesh, [done], dist.ReduceOp.MAX)[0])
        return not done

    total_samples = 0
    collected_samples = 0
    intervals = 0
    t_start = time.perf_counter()
    while more():
        rec.begin_interval()
        t_int_ns = time.perf_counter_ns()
        t_int = time.perf_counter()
        interval_samples = 0
        inflight = 0
        while time.perf_counter() - t_int < interval:
            if interval_samples >= local_budget:
                out.write(
                    "interval closing early: int32 accumulator budget "
                    f"({interval_samples:,} samples)\n"
                )
                break
            step_ns = time.perf_counter_ns()
            acc, gen = step(acc, gen)
            rec.record("firehose.step", step_ns, time.perf_counter_ns())
            interval_samples += local_batch
            inflight += 1
            if inflight >= max_inflight:
                sync()
                inflight = 0
        if mesh is not None:
            # the ranks of a stream row share its samples: the ones whose
            # clock ran out first catch up to the row's step count (the
            # same generator stream gives the same batches)
            steps = interval_samples // local_batch
            behind = mesh_reduce(mesh, [steps], dist.ReduceOp.MAX,
                                 (METRIC_AXIS,))[0] - steps
            for _ in range(behind):
                acc, gen = step(acc, gen)
            interval_samples += behind * local_batch
            acc, partial = collect(acc, partial)
            # the stream rows' samples: one rank of each row counts them
            own = interval_samples if axis_index(mesh, METRIC_AXIS) == 0 else 0
            interval_samples = mesh_reduce(mesh, [own], dist.ReduceOp.SUM)[0]
            stats = dense_stats(acc, ps, config.bucket_limit,
                                config.precision)
            counts, pcts, sums = (
                gather_parts(mesh, stats[k]).cpu().numpy()
                for k in ("counts", "percentiles", "sums"))
        else:
            stats = dense_stats(acc, ps, config.bucket_limit,
                                config.precision)
            counts = stats["counts"].cpu().numpy()
            pcts = stats["percentiles"].cpu().numpy()
            sums = stats["sums"].cpu().numpy()
        acc.zero_()
        intervals += 1
        total_samples += interval_samples
        collected_samples += int(counts.sum(dtype=np.int64))

        # serialize the hottest metrics for the export replay
        with rec.span("firehose.export"):
            metrics = {}
            hot = np.argsort(counts)[::-1][:16]
            for mid in hot:
                if counts[mid] == 0:
                    continue
                name = f"firehose_{mid}"
                metrics[f"{name}_count"] = float(counts[mid])
                metrics[f"{name}_sum"] = float(sums[mid])
                for label, value in zip(labels, pcts[mid]):
                    metrics[label % name] = float(value)
            pms = ProcessedMetricSet(
                time=_dt.datetime.now(tz=_dt.timezone.utc), metrics=metrics
            )
            payload = opentsdb_protocol(pms)
            if sink is not None and sender:
                from loghisto_tpu_torch.submitter import send_once

                err = send_once("tcp", sink, payload)
                status = "sent" if err is None else f"error: {err}"
            else:
                status = f"{len(payload)} bytes serialized"
        rec.record("firehose.interval", t_int_ns, time.perf_counter_ns())
        rate = interval_samples / (time.perf_counter() - t_int)
        out.write(
            f"interval {intervals}: {interval_samples:,} samples "
            f"({rate/1e6:.1f}M/s), export {status}\n"
        )
        out.flush()

    elapsed = time.perf_counter() - t_start
    summary = {
        "samples_per_s": total_samples / elapsed,
        "total_samples": total_samples,
        "collected_samples": collected_samples,
        "intervals": intervals,
        "platform": dev.type,
        "ingest_path": path,
    }
    out.write(
        f"firehose: {summary['samples_per_s']/1e6:.1f}M samples/s over "
        f"{intervals} intervals on {summary['platform']}\n"
    )
    return summary


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--metrics", type=int, default=10_000)
    parser.add_argument("--batch", type=int, default=1 << 22)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--interval", type=float, default=1.0)
    parser.add_argument("--sink", default=None,
                        help="host:port OpenTSDB sink (optional)")
    parser.add_argument("--ingest-path", default="auto",
                        help="auto or a name of ops/dispatch.INGEST_PATHS "
                             "other than multirow")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--mesh", action="store_true",
                        help="run over every rank of the process group the "
                             "launcher's environment names (all_reduce "
                             "merges)")
    parser.add_argument("--mesh-metric", type=int, default=1,
                        help="metric-axis size of the mesh")
    args = parser.parse_args(argv)
    sink = None
    if args.sink:
        host, port = args.sink.rsplit(":", 1)
        sink = (host, int(port))
    mesh = None
    if args.mesh:
        from loghisto_tpu_torch.parallel import multihost

        multihost.initialize()
        mesh = multihost.global_mesh(metric=args.mesh_metric)
    try:
        run_firehose(
            num_metrics=args.metrics, batch=args.batch,
            seconds=args.seconds, interval=args.interval, sink=sink,
            ingest_path=args.ingest_path, seed=args.seed, mesh=mesh,
        )
    finally:
        if mesh is not None:
            multihost.shutdown()


if __name__ == "__main__":
    main()
