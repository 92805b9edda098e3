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

``resolve_commit_path`` resolves the interval commit: the fan-out path
until the fused committer is ported (ROADMAP D3).

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


# -- the storage axis: dense [M, B] accumulator or paged pool ----------- #
#
# Counterpart of the JAX table's ("storage", "paged") and
# ("ingest", "fused_paged") rows.  The reason sentences are copied
# verbatim, so an operator reads the same words from both packages.  One
# planned departure: the platform edge admits "cuda" where the JAX
# package admits "tpu" (the card is where K4f runs); on "cpu", "auto"
# keeps the JAX package's CPU route — paged storage on the sparse
# transport, no fused step — so the CPU tests walk the same route as the
# reference on the CPU.

# Metric-row crossover for storage="auto": at M = 2^16 x B = 8193 the
# dense int32 accumulator is ~2.1 GiB and the page pool wins on sparse
# occupancy; below it dense wins on simplicity (JAX table value).
PAGED_MIN_METRICS = 1 << 16

# Buckets per pool page (ops/paged_store.PAGE_SIZE).
PAGE_SIZE = 256

# Fixed paged-commit launch width (ops/paged_store.COMMIT_CHUNK).
PAGED_COMMIT_CHUNK = 1 << 14

# Smallest batch for which "auto" takes the direct-to-paged fused step
# on "cuda".  The JAX value (2^17) is the batch its sort + layout
# preprocess amortizes over; K4f has no preprocess — one thread per
# sample — so the card's bound is launch overhead.  2^16 samples keep
# the launch (~5 us) under the 8 B/sample bytes it moves at 3.35 TB/s
# plus the host's staging of the batch; it also equals the port's
# default batch_size, so a default-configured aggregator qualifies.
# Reasoned, not swept: chip_smoke.py times K4f at batch 2^20 only.
FUSED_MIN_BATCH_BY_PLATFORM = {"cuda": 1 << 16}
FUSED_MIN_BATCH = 1 << 17


def fused_min_batch_for(platform: str | None) -> int:
    return FUSED_MIN_BATCH_BY_PLATFORM.get(platform, FUSED_MIN_BATCH)


def _ck_fused_batch(platform, batch_size) -> str | None:
    min_batch = fused_min_batch_for(platform)
    if batch_size is None:
        return (
            "batch too small: batch size unknown, cannot prove the "
            f"sort+layout preprocess amortizes (needs >= {min_batch} "
            "samples/batch)"
        )
    if batch_size < min_batch:
        return (
            f"batch too small: {batch_size} samples/batch does not "
            "amortize the fused kernel's sort+layout preprocess "
            f"(measured crossover {min_batch})"
        )
    return None


def _ck_paged_transport(transport, fused_ok) -> str | None:
    allowed = ("sparse", "auto", "raw") if fused_ok else ("sparse", "auto")
    if transport not in allowed:
        return (
            f"transport: paged storage commits through the packed "
            f"[n,3] sparse-triple fold (transport='sparse'); "
            f"transport={transport!r} ships whole batches with no host "
            "fold, so there is no translate step to route cells through "
            "the page table"
        )
    return None


def _ck_paged_bucket_axis(num_buckets) -> str | None:
    if num_buckets is not None and num_buckets < PAGE_SIZE:
        return (
            f"bucket axis: num_buckets={num_buckets} is smaller than "
            f"one {PAGE_SIZE}-bucket page — the dense row is already "
            "cheaper than any page table"
        )
    return None


def _ck_paged_crossover(num_metrics) -> str | None:
    if num_metrics < PAGED_MIN_METRICS:
        return (
            f"below crossover: {num_metrics} metric rows — the dense "
            f"accumulator fits HBM trivially below {PAGED_MIN_METRICS} "
            "rows and its donated in-place commit wins (PAGED_STORE_r14)"
        )
    return None


def _ck_fused_paged_transport(transport) -> str | None:
    if transport not in ("raw", "auto"):
        return (
            "transport: the direct-to-paged fused kernel ingests RAW "
            "samples (compress, codec-encode, and page-translate all "
            f"happen on device in one dispatch); transport="
            f"{transport!r} folds cells on host first, leaving the "
            "one-dispatch path nothing to fuse — the folded route keeps "
            "the translate + packed pool commit"
        )
    return None


def _ck_fused_paged_platform(platform) -> str | None:
    # the departure: "cuda" where the JAX edge names "tpu"
    if platform is not None and platform != "cuda":
        return (
            f"platform: {platform} — auto only picks the direct-to-"
            "paged fused kernel on CUDA (the plain PyTorch tier is "
            "parity-only; explicit selection remains the opt-in)"
        )
    return None


def fused_paged_incapability(
    num_metrics: int,
    num_buckets: int | None = None,
    batch_size: int | None = None,
    transport: str = "auto",
    platform: str | None = None,
    crossover: bool = True,
) -> str | None:
    """Why a configuration cannot (or should not) take the direct-to-
    paged fused ingest (K4f), or None.  ``crossover=False`` skips the
    policy edges (platform preference, batch amortization), as an
    explicit ``ingest_path="fused"`` does.  Edge order as in the JAX
    row: bucket axis, transport, platform, batch (the mesh edges wait
    for the mesh slice; the JAX threshold-table switch has no port)."""
    del num_metrics  # no row-count edge on this row, as in the JAX table
    reason = (
        _ck_paged_bucket_axis(num_buckets)
        or _ck_fused_paged_transport(transport)
    )
    if reason is None and crossover:
        reason = (
            _ck_fused_paged_platform(platform)
            or _ck_fused_batch(platform, batch_size)
        )
    return reason


def paged_storage_incapability(
    num_metrics: int,
    num_buckets: int | None = None,
    transport: str = "sparse",
    crossover: bool = True,
    fused_ok: bool = False,
) -> str | None:
    """Why a configuration cannot (or should not) run paged storage, or
    None.  ``crossover=False`` skips the metric-cardinality policy edge
    (an explicit ``storage="paged"`` may page a small deployment);
    ``fused_ok`` admits the raw transport (K4f ingests raw batches)."""
    reason = (
        _ck_paged_transport(transport, fused_ok)
        or _ck_paged_bucket_axis(num_buckets)
    )
    if reason is None and crossover:
        reason = _ck_paged_crossover(num_metrics)
    return reason


def resolve_storage_path(
    storage: str,
    num_metrics: int,
    num_buckets: int,
    platform: str,
    transport: str = "sparse",
    fused_ok: bool = False,
) -> tuple[str, str | None]:
    """Resolve the storage backend, "dense" or "paged".  Returns
    ``(resolved, reason)``: "auto" degrades to dense with the reason; an
    explicit "paged" that a capability blocker rules out raises it.

    ``num_metrics`` counts registry rows: every distinct label set of a
    base name is its own row, so label cardinality drives the
    crossover."""
    del platform  # both backends run on every device (plain tier on CPU)
    if storage == "auto":
        reason = paged_storage_incapability(
            num_metrics, num_buckets, transport=transport, fused_ok=fused_ok,
        )
        if reason is not None:
            return "dense", reason
        return "paged", None
    if storage not in ("dense", "paged"):
        raise ValueError(
            f"unknown storage {storage!r}: expected 'auto', 'dense', or "
            "'paged'"
        )
    if storage == "paged":
        reason = paged_storage_incapability(
            num_metrics, num_buckets, transport=transport, crossover=False,
            fused_ok=fused_ok,
        )
        if reason is not None:
            raise ValueError(f"paged storage unavailable: {reason}")
    return storage, None


# -- the interval commit (ROADMAP D3) ----------------------------------- #

FUSED_COMMIT_SLICE = (
    "the fused IntervalCommitter (loghisto_tpu/commit.py, ops/commit.py) is "
    "not ported yet: it comes with ROADMAP Queue 1 slice 7b, and until then "
    "the port commits each interval through the fan-out path (the "
    "aggregator's and the wheel's bridges), which the reference's fused "
    "path equals bit for bit."
)


def resolve_commit_path(path: str) -> str:
    """Resolve the interval-commit path.  "auto" and "fanout" give
    "fanout" (decision D3: the reference's "auto" picks the fused
    committer on a TPU, and the fused and fan-out paths compute the same
    bits); "fused" raises until the committer is ported."""
    if path in ("auto", "fanout"):
        return "fanout"
    if path == "fused":
        raise ValueError(f"commit='fused' unavailable: {FUSED_COMMIT_SLICE}")
    raise ValueError(
        f"unknown commit path {path!r}: expected 'auto', 'fused', or 'fanout'"
    )
