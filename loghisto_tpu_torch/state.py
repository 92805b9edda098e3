"""Carrying aggregator state across from the JAX package — the metrics
system's counterpart of carrying weights across.

``state_from_jax`` takes plain host values read off a
``loghisto_tpu.parallel.aggregator.TPUAggregator`` (the caller reads
them; this module imports nothing of the JAX package) and builds the
state dict that ``TorchAggregator.load_state_dict`` reads and
``TorchAggregator.state_dict`` writes:

    acc      = np.asarray(jax_agg._acc)          # int32 [M, B]
    names    = jax_agg.registry.names()          # id -> name (None = hole)
    lifetime = jax_agg._agg                      # id -> [sum, count]
    spill    = jax_agg._spill                    # int64 [M, B] or None

After the load, the port's ``collect()`` equals the JAX aggregator's
``collect()`` from the same state.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from loghisto_tpu_torch.config import PRECISION
from loghisto_tpu_torch.parallel.aggregator import STATE_FORMAT


def state_from_jax(
    acc: np.ndarray,
    names: Sequence[Optional[str]],
    lifetime: Mapping[int, Sequence],
    spill: Optional[np.ndarray] = None,
    precision: int = PRECISION,
) -> dict:
    """Build a ``TorchAggregator`` state dict from a JAX aggregator's
    accumulator, registry names, lifetime store and spill."""
    acc = np.array(acc, dtype=np.int32, copy=True)
    if acc.ndim != 2 or acc.shape[1] % 2 != 1:
        raise ValueError(
            f"acc must be int32 [M, 2*bucket_limit+1]; got {acc.shape}"
        )
    names = list(names)
    if len(names) > acc.shape[0]:
        raise ValueError(
            f"{len(names)} names for an accumulator of {acc.shape[0]} rows"
        )
    if spill is not None:
        spill = np.array(spill, dtype=np.int64, copy=True)
        if spill.shape != acc.shape:
            raise ValueError(
                f"spill shape {spill.shape} != acc shape {acc.shape}"
            )
    return {
        "format": STATE_FORMAT,
        "bucket_limit": (acc.shape[1] - 1) // 2,
        "precision": precision,
        "acc": acc,
        "names": names,
        "agg": {int(mid): [e[0], e[1]] for mid, e in lifetime.items()},
        "spill": spill,
    }
