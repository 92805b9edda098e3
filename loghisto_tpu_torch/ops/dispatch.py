"""Capability table of the port's ingest paths and transports
(counterpart of ``loghisto_tpu/ops/dispatch.py``: ``resolve_ingest_path``,
``choose_transport`` and ``SPARSE_DENSITY_CROSSOVER``).

Dense ingest paths, all on the same int32 [M, B] accumulator:

  * ``"fused"`` — K1 (ops/fused_ingest.py).  Global atomics serve any
    row count, so unlike the Pallas kernel there is no ``M % 8`` rule.
  * ``"row"``   — K2 (ops/row_ingest.py), the single-metric row.

On ``cuda``, "auto" resolves to the row kernel when the accumulator has
one row and to the fused kernel otherwise; registry growth past one row
re-resolves (the aggregator swaps K2 for K1).  On ``cpu`` every path is
served by the wrappers' plain versions — the table still resolves, so
the CPU runs the same control flow as the card.

Each decline reason is a sentence, as in the JAX table.
"""

from __future__ import annotations

# Host->device transport crossover: "auto" transport folds the first
# large raw item on the host and measures cell density = unique cells /
# samples.  At or below the crossover, shipping packed [n, 3] triples
# (12 B/cell, transport="sparse") beats shipping every sample
# (8 B/sample); above it raw stays.  Copied from the JAX table.
SPARSE_DENSITY_CROSSOVER = 0.5

INGEST_PATHS = ("fused", "row")

# the row kernel's per-call bound, kept from the reference's contract
ROW_MAX_BATCH = 1 << 24


def ingest_incapability(
    path: str, num_metrics: int, batch_size: int | None = None
) -> str | None:
    """Why ``path`` cannot serve this shape, or None when it can."""
    if path == "fused":
        return None
    if path == "row":
        if num_metrics != 1:
            return (
                "the row kernel serves a single-metric [1, B] accumulator; "
                f"this one has {num_metrics} rows."
            )
        if batch_size is not None and batch_size >= ROW_MAX_BATCH:
            return (
                "row batches must stay below 2^24 samples, the bound the "
                f"reference's row kernel keeps; batch_size is {batch_size}."
            )
        return None
    raise ValueError(
        f"unknown ingest_path {path!r}: expected 'auto', 'fused' or 'row'"
    )


def resolve_ingest_path(
    path: str, num_metrics: int, batch_size: int | None = None
) -> str:
    """Resolve "auto"; an explicit path the shape cannot serve raises
    with its reason."""
    if path == "auto":
        if ingest_incapability("row", num_metrics, batch_size) is None:
            return "row"
        return "fused"
    reason = ingest_incapability(path, num_metrics, batch_size)
    if reason is not None:
        raise ValueError(f"ingest_path={path!r} unavailable: {reason}")
    return path


def kernel_tier(device_type: str) -> str:
    """Which tier the wrappers run on this device: the Hopper kernels on
    "cuda", the plain PyTorch versions on "cpu"."""
    if device_type == "cuda":
        return "cuda"
    if device_type == "cpu":
        return "plain"
    raise ValueError(f"unsupported device type {device_type!r}")


def choose_transport(density: float | None = None) -> str:
    """transport="auto": start on "raw" and switch to "sparse" once a
    probe shows the load is skewed (density <= the crossover)."""
    if density is not None and density <= SPARSE_DENSITY_CROSSOVER:
        return "sparse"
    return "raw"
