#!/usr/bin/env python3
"""The fused commit's cost with and without ``resilience=`` on the card.

``chip_smoke.py``'s retention system (1024 metrics, the default tiers,
the churn lifecycle, 24 drift banks, the fused commit) is built three
times in one process: plain, with ``resilience=ResilienceConfig()`` and
no injector, and plain again.  Every interval (2^20 lognormal samples)
is committed to the three in a rotating order, so the host's drift and
the allocator's cache fall on each alike.  Two build orders run, each
with fresh systems: the resilience system built second, then first.

    python3 scripts/torch_resilience_cost.py [intervals]   # default 48

Prints the card's name and power limit, then one JSON line per build
order: each system's p25 / p50 / p75 / p99 commit time in ms (host
clock, the card synchronized before and after each commit), its fused
and fan-out interval counts, and the host's noise (the two plain
systems' p50 apart).  Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

ORDERS = (("plain", "resilience", "plain_again"),
          ("resilience", "plain", "plain_again"))


def run(torch, cs, order, intervals):
    """One build order: build the three systems, commit every interval
    to each in turn, drop them."""
    from loghisto_tpu_torch.resilience import ResilienceConfig

    rng, steady, mu, sigma = cs._rs_stream()
    t0 = cs._dt.datetime(2026, 1, 1, tzinfo=cs._dt.timezone.utc)
    raws = [cs._raw_interval(rng, steady, mu, sigma,
                             t0 + k * cs._ONE_SECOND, k + 1, cs.RET_SAMPLES)
            for k in range(intervals)]
    systems = {}
    times = {label: [] for label in order}
    try:
        for label in order:
            kw = ({"resilience": ResilienceConfig()}
                  if label == "resilience" else {})
            systems[label] = cs._cj_retention_system(torch, **kw)[0]
        for k, raw in enumerate(raws):
            for j in range(len(order)):
                label = order[(k + j) % len(order)]
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                systems[label].committer.commit(raw)
                torch.cuda.synchronize()
                times[label].append((time.perf_counter() - t1) * 1e3)
        modes = {label: [ms.committer.fused_intervals,
                         ms.committer.fanout_intervals]
                 for label, ms in systems.items()}
    finally:
        for ms in systems.values():
            cs._drop_system(torch, ms)
    out = {"build_order": list(order), "intervals": intervals,
           "fused_fanout": modes}
    for label, ts in times.items():
        q = np.percentile(ts, [25, 50, 75, 99])
        out[label] = {"p25_ms": float(q[0]), "p50_ms": float(q[1]),
                      "p75_ms": float(q[2]), "p99_ms": float(q[3]),
                      "ms": ts}
    out["host_noise_p50_ms"] = abs(out["plain"]["p50_ms"]
                                   - out["plain_again"]["p50_ms"])
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_resilience_cost: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    intervals = int(sys.argv[1]) if len(sys.argv) > 1 else 48
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    for order in ORDERS:
        print(json.dumps(run(torch, cs, order, intervals)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
