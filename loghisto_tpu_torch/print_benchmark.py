"""PrintBenchmark: live benchmark harness printing per-interval statistics
(counterpart of ``loghisto_tpu/print_benchmark.py``; reference
print_benchmark.go:49-106).

Spawns ``concurrency`` worker threads looping start_timer -> op -> stop
on a MetricSystem, subscribes to processed metrics, and prints the
fixed metric list each interval in aligned columns.  As in the
reference's rebuild: an optional ``duration`` bound (the reference
blocks forever), ``device=`` to aggregate on a ``TorchMetricSystem``,
and the column alignment computed directly instead of Go's tabwriter.

``device=True`` runs on the card (and raises without CUDA, the port's
entry-point rule); a device string (``device="cpu"``) picks that device.

CLI:  python -m loghisto_tpu_torch.print_benchmark --concurrency 100 \\
          --seconds 10 [--device [cuda|cpu]]
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Mapping, Optional, TextIO, Union

from loghisto_tpu_torch.channel import Channel, ChannelClosed
from loghisto_tpu_torch.metrics import MetricSystem

# joins of the harness's own threads at the end of a run: workers only
# finish their current op, so this bounds a wedged op, not a slow host
_JOIN_S = 30.0


def _interesting_metrics(name: str) -> list[str]:
    return [
        f"{name}_count",
        f"{name}_max",
        f"{name}_99.99",
        f"{name}_99.9",
        f"{name}_99",
        f"{name}_95",
        f"{name}_90",
        f"{name}_75",
        f"{name}_50",
        f"{name}_min",
        f"{name}_sum",
        f"{name}_avg",
        f"{name}_agg_avg",
        f"{name}_agg_count",
        f"{name}_agg_sum",
        "sys.Alloc",
        "sys.NumGC",
        "sys.PauseTotalNs",
        "sys.NumGoroutine",
    ]


def format_block(time_stamp, metrics: Mapping[str, float],
                 interesting: list[str]) -> str:
    """One printed interval: its time, then one ``name:<pad>\\tvalue``
    line per interesting metric (0 when absent), and a blank line."""
    width = max(len(m) for m in interesting) + 1
    lines = [str(time_stamp)]
    for metric in interesting:
        lines.append(f"{metric + ':':<{width}}\t{metrics.get(metric, 0)}")
    return "\n".join(lines) + "\n\n"


def print_benchmark(
    name: str,
    concurrency: int,
    op: Callable[[], None],
    duration: Optional[float] = None,
    interval: float = 1.0,
    out: Optional[TextIO] = None,
    fast_ingest: bool = True,
    device: Union[bool, str] = False,
    handles: bool = False,
) -> None:
    """Run ``op`` at ``concurrency`` and print statistics each interval.

    Blocks for ``duration`` seconds (forever when None, like the
    reference).  Uses the C staging buffers of the fast ingest path
    (``fast_ingest=False`` benchmarks the pure-Python hot path).
    ``device`` runs the same harness on a ``TorchMetricSystem`` and
    prints the statistics of its device aggregation: ``True`` for the
    card, or a device string.  ``handles=True`` times each op with the
    reusable per-name timer handle (``system.timer(name)``) instead of
    per-measurement tokens.  ``out`` defaults to the standard output at
    the time of the call.
    """
    out = sys.stdout if out is None else out
    if device is not False and device is not None:
        from loghisto_tpu_torch.system import TorchMetricSystem

        ms = TorchMetricSystem(
            interval=interval, sys_stats=True, fast_ingest=fast_ingest,
            device=None if device is True else device,
        )
        ms.device_metrics()  # build the stats path before ticking starts
        on_device = True
    else:
        ms = MetricSystem(
            interval=interval, sys_stats=True, fast_ingest=fast_ingest
        )
        on_device = False
    # device mode drains slower (a device statistics round trip per
    # interval): a little slack keeps the reaper from evicting the
    # subscriber
    mc = Channel(4 if on_device else 1)
    ms.subscribe_to_processed_metrics(mc)
    ms.start()
    stop = threading.Event()
    interesting = _interesting_metrics(name)

    def receiver():
        while True:
            try:
                pms = mc.get(timeout=0.5)
            except ChannelClosed:
                return
            except Exception:
                if stop.is_set():
                    return
                continue
            metrics = pms.metrics
            if on_device:
                # the device aggregation's statistics (reset=True: one
                # interval's, as in host mode) over the host's counters
                # and gauges
                metrics = dict(metrics)
                metrics.update(ms.device_metrics(reset=True).metrics)
            out.write(format_block(pms.time, metrics, interesting))
            out.flush()

    recv_thread = threading.Thread(target=receiver, daemon=True,
                                   name="loghisto-bench-recv")
    recv_thread.start()

    def worker():
        if handles:
            t = ms.timer(name)
            tstart, tstop = t.start, t.stop
            while not stop.is_set():
                s = tstart()
                op()
                tstop(s)
        else:
            while not stop.is_set():
                token = ms.start_timer(name)
                op()
                token.stop()

    workers = [
        threading.Thread(target=worker, daemon=True,
                         name="loghisto-bench-worker")
        for _ in range(concurrency)
    ]
    for w in workers:
        w.start()

    try:
        if duration is None:
            while True:  # the reference blocks forever
                time.sleep(3600)
        else:
            time.sleep(duration)
    finally:
        stop.set()
        for w in workers:
            w.join(timeout=_JOIN_S)
        ms.stop()
        mc.close()
        recv_thread.join(timeout=_JOIN_S)


def main(argv: Optional[list[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--name", default="benchmark_op")
    parser.add_argument("--concurrency", type=int, default=10)
    parser.add_argument(
        "--seconds", type=float, default=None,
        help="run time (default: forever, like the reference)",
    )
    parser.add_argument("--interval", type=float, default=1.0)
    parser.add_argument(
        "--no-fast", action="store_true",
        help="benchmark the pure-Python hot path",
    )
    parser.add_argument(
        "--device", nargs="?", const=True, default=False,
        help="aggregate on the device (TorchMetricSystem): the card, or "
             "the device named (cuda, cpu)",
    )
    parser.add_argument(
        "--handles", action="store_true",
        help="time with the reusable per-name handle (product hot loop) "
             "instead of per-measurement tokens",
    )
    args = parser.parse_args(argv)

    def op() -> None:
        pass  # time the measurement overhead itself

    print_benchmark(
        args.name, args.concurrency, op,
        duration=args.seconds, interval=args.interval,
        fast_ingest=not args.no_fast, device=args.device,
        handles=args.handles,
    )


if __name__ == "__main__":
    main()
