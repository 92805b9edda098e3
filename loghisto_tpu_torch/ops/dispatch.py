"""Capability table of the port's ingest paths and transports
(counterpart of ``loghisto_tpu/ops/dispatch.py``: ``resolve_ingest_path``,
``ingest_step_fn``, ``choose_transport`` and ``SPARSE_DENSITY_CROSSOVER``).

Dense ingest paths, all on the same int32 [M, B] accumulator:

  * ``"fused"``    — K1 (ops/fused_ingest.py).  Global atomics serve any
    row count, so unlike the Pallas kernel there is no ``M % 8`` rule.
  * ``"row"``      — K2 (ops/row_ingest.py), the single-metric row;
    ``"pallas"`` is the JAX package's name for the same step.
  * ``"multirow"`` — K8 (ops/multirow_ingest.py): preprocess + the
    layout kernel; ``M % 8 == 0`` and dense storage.
  * ``"scatter"``, ``"sort"``, ``"sortscan"``, ``"matmul"``, ``"hybrid"``
    — the JAX package's XLA paths (ops/ingest.py, ops/sort_ingest.py,
    ops/matmul_hist.py, ops/hybrid_hist.py).  They have no Pallas kernel,
    so their PyTorch form runs on the card as well: that is the
    reference's path, not a fallback.

On ``cuda``, "auto" resolves to the row kernel when the accumulator has
one row and to the fused kernel otherwise; registry growth past one row
re-resolves (the aggregator swaps K2 for K1).  Like the JAX "auto", it
never picks multirow, and it picks none of the XLA paths (whether one
should win on the card is for a measured table).  On ``cpu`` every path
is served by the wrappers' plain versions — the table still resolves, so
the CPU runs the same control flow as the card.

``resolve_commit_path`` resolves the interval commit: the fused
committer on dense and on paged storage, and on a mesh (ROADMAP D9)
unless ``mesh_commit_incapability`` names the reference's reason.
``resolve_full_path`` walks all four axes together (transport, ingest,
storage, commit), as the reference's composed resolver does.

On a ("stream", "metric") mesh (ROADMAP D8) a rank's fold is an ordinary
launch on its own card, so the paths resolve on the rank's block of
``num_metrics / n_metric`` rows: "auto" takes K2b for a one-row block
and K1 otherwise.  The reference's fused-kernel mesh edge declines K1
"inside a shard_map-embedded step"; the port has no ``shard_map``, and
its edge admits K1 per rank and declines only a mesh whose axes are not
("stream", "metric").  Explicit "scatter", "sort" and "hybrid" run on a
mesh as in the reference.  Paged storage resolves on a mesh by the
reference's table, its mesh-shape edges included (ROADMAP D12: per-shard
arenas, K4 and K4f per rank), and lifecycle, checkpoints and
``resilience=`` run there (ROADMAP D13).

Each decline reason is a sentence, as in the JAX table; the shape
preconditions of the JAX paths keep the JAX package's sentences.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

# Host->device transport crossover: "auto" transport folds the first
# large raw item on the host and measures cell density = unique cells /
# samples.  At or below the crossover, shipping packed [n, 3] triples
# (12 B/cell, transport="sparse") beats shipping every sample
# (8 B/sample); above it raw stays.  Copied from the JAX table, which
# reasons it from wire bytes alone; the CPU keeps it, so the port's CPU
# runs choose the JAX package's transport.
SPARSE_DENSITY_CROSSOVER = 0.5
# On the card the sparse route is held by the host fold, not by wire
# bytes.  chip_smoke.py's transport_crossover phase runs both transports
# through TorchAggregator at cell densities 0.02-0.49 (2^24 samples per
# interval, 10,000 metrics).  On NVIDIA H100 80GB HBM3, 700.00 W, with
# the native fold on 8 host threads (ops/fold.fold_packed), sparse (fold +
# K3) ran 28.7-64.2 M samples/s and raw (staging + K1) 468-766 M, so
# sparse wins at no density and the crossover stays 0.0: raw always.
# (The NumPy fold before it: sparse 14-35 M against raw 372-967 M.)
SPARSE_DENSITY_CROSSOVER_BY_DEVICE = {"cuda": 0.0}

INGEST_PATHS = ("fused", "row", "scatter", "sort", "sortscan", "matmul",
                "hybrid", "pallas", "multirow")

# the row kernel's per-call bound, kept from the reference's contract
ROW_MAX_BATCH = 1 << 24

# the multirow step's row block, the JAX factory's default rows_tile
MULTIROW_ROWS_TILE = 8


def ingest_incapability(
    path: str,
    num_metrics: int,
    batch_size: int | None = None,
    num_buckets: int | None = None,
    guard_metrics: int | None = None,
) -> str | None:
    """Why ``path`` cannot serve this shape, or None when it can.
    ``guard_metrics`` is the row count the flat-cell bound is held
    against when it exceeds ``num_metrics`` (the aggregator's growth
    cap), as in the JAX ``resolve_ingest_path``."""
    if path in ("fused", "scatter"):
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
    if path in ("sort", "sortscan", "matmul"):
        if num_buckets is None:
            return None
        from loghisto_tpu_torch.ops.sort_ingest import flat_cell_incapability

        return flat_cell_incapability(
            max(num_metrics, guard_metrics or 0), num_buckets, path)
    if path in ("hybrid", "pallas"):
        if batch_size is not None and batch_size >= ROW_MAX_BATCH:
            return (
                f"{path} ingest batches must stay < 2^24 samples (float32 "
                f"accumulation exactness); got batch_size={batch_size}"
            )
        if path == "pallas" and num_metrics != 1:
            return (
                "ingest_path='pallas' is the single-metric row kernel; got "
                f"num_metrics={num_metrics} (growth past 1 row swaps kernels "
                "automatically, but the starting shape must be [1, B])"
            )
        return None
    if path == "multirow":
        if num_metrics % MULTIROW_ROWS_TILE:
            return (
                f"num_metrics={num_metrics} must divide by "
                f"rows_tile={MULTIROW_ROWS_TILE}"
            )
        return None
    raise ValueError(
        f"unknown ingest_path {path!r}: expected 'auto' or one of "
        f"{', '.join(repr(p) for p in INGEST_PATHS)}"
    )


def _ck_fused_mesh(mesh) -> str | None:
    # the departure (D8): K1 runs per rank, so only the axis layout
    # declines, in the reference's words of its mesh-shape edges
    from loghisto_tpu_torch.parallel.mesh import axes_incapability

    return axes_incapability(mesh)


def resolve_ingest_path(
    path: str,
    num_metrics: int,
    batch_size: int | None = None,
    num_buckets: int | None = None,
    guard_metrics: int | None = None,
    mesh=None,
) -> str:
    """Resolve "auto"; an explicit path the shape cannot serve raises
    with its reason.  With ``mesh`` the path serves this rank's block of
    ``num_metrics / n_metric`` rows (divisibility is the caller's
    check)."""
    if mesh is not None:
        from loghisto_tpu_torch.parallel.mesh import METRIC_AXIS, axis_size

        reason = _ck_fused_mesh(mesh)
        if reason is not None:
            raise ValueError(f"ingest_path={path!r} unavailable: {reason}")
        n_metric = axis_size(mesh, METRIC_AXIS)
        num_metrics //= n_metric
        if guard_metrics is not None:
            guard_metrics //= n_metric
    if path == "auto":
        if ingest_incapability("row", num_metrics, batch_size) is None:
            return "row"
        return "fused"
    reason = ingest_incapability(path, num_metrics, batch_size, num_buckets,
                                 guard_metrics)
    if reason is not None:
        raise ValueError(f"ingest_path={path!r} unavailable: {reason}")
    return path


def ingest_step_fn(path: str):
    """The per-batch accumulation function of a named path, with the
    uniform ``f(acc, ids, values, bucket_limit, precision) -> acc``
    contract (in place).  As in the JAX package there is no "multirow"
    entry: its step takes a row tile and a layout
    (ops/multirow_ingest.multirow_step); "row" and "pallas" need a
    [1, B] accumulator."""
    if path == "sort":
        from loghisto_tpu_torch.ops.sort_ingest import sort_ingest_batch

        return sort_ingest_batch
    if path == "sortscan":
        from loghisto_tpu_torch.ops.sort_ingest import sortscan_ingest_batch

        return sortscan_ingest_batch
    if path == "hybrid":
        from loghisto_tpu_torch.ops.hybrid_hist import ingest_batch_hybrid

        return ingest_batch_hybrid
    if path == "matmul":
        from loghisto_tpu_torch.ops.matmul_hist import ingest_batch_matmul

        return ingest_batch_matmul
    if path in ("pallas", "row"):
        from loghisto_tpu_torch.ops.row_ingest import row_ingest_batch

        return row_ingest_batch
    if path == "fused":
        from loghisto_tpu_torch.ops.fused_ingest import fused_ingest_batch

        return fused_ingest_batch
    if path != "scatter":
        raise ValueError(
            f"no pure step form for ingest_path {path!r}: expected "
            "'scatter', 'sort', 'sortscan', 'hybrid', 'matmul', "
            "'pallas', 'row', or 'fused'"
        )
    from loghisto_tpu_torch.ops.ingest import ingest_batch

    return ingest_batch


def kernel_tier(device_type: str) -> str:
    """Which tier the wrappers run on this device: the Hopper kernels on
    "cuda", the plain PyTorch versions on "cpu"."""
    if device_type == "cuda":
        return "cuda"
    if device_type == "cpu":
        return "plain"
    raise ValueError(f"unsupported device type {device_type!r}")


def sparse_density_crossover(platform: str) -> float:
    """The cell density at or below which "auto" takes the sparse
    transport on this device type (0.0: never)."""
    return SPARSE_DENSITY_CROSSOVER_BY_DEVICE.get(
        platform, SPARSE_DENSITY_CROSSOVER)


def choose_transport(
    platform: str, density: float | None = None, native_ok: bool = True
) -> str:
    """transport="auto": start on "raw" and switch to "sparse" once a
    probe shows the load is skewed (density <= the crossover of the
    device type ``platform``; a crossover of 0.0 keeps raw for any
    load).  "preagg" is never picked: its record-time fold pays only
    when the recording threads are the bottleneck, which no flush-side
    probe sees.  ``native_ok=False`` (no host fold tier at all; the
    NumPy tier always exists, so never today) pins raw, as in the JAX
    rule."""
    if not native_ok:
        return "raw"
    crossover = sparse_density_crossover(platform)
    if density is not None and crossover > 0.0 and density <= crossover:
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
# sample.  Swept on the card (chip_smoke.py transport_crossover, NVIDIA
# H100 80GB HBM3, 700.00 W, 2^20 rows, band workload): the K4f route
# (prepare_batch + K4f) beat the sparse route (fold + translate + K4) at
# every batch from 2^12 to 2^20 in three runs, 1.22-2.11x, both held by
# the host, so the edge sits at the smallest batch swept.
FUSED_MIN_BATCH_BY_PLATFORM = {"cuda": 1 << 12}
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


def _ck_paged_mesh(mesh, num_metrics) -> str | None:
    # the reference's edge and sentences: the mesh SHAPES per-shard
    # arenas cannot take
    if mesh is None:
        return None
    from loghisto_tpu_torch.parallel.mesh import (
        AXES,
        METRIC_AXIS,
        STREAM_AXIS,
        axis_size,
    )

    axes = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if axes != AXES:
        return (
            f"mesh shape: mesh axes {axes!r} are not the "
            f"('{STREAM_AXIS}', '{METRIC_AXIS}') layout the per-shard "
            "page arenas partition over"
        )
    n_metric = axis_size(mesh, METRIC_AXIS)
    if num_metrics and num_metrics % n_metric:
        return (
            f"mesh shape: num_metrics={num_metrics} rows don't "
            f"shard evenly over the {n_metric}-way metric axis, so the "
            "page arenas cannot split per shard"
        )
    n_stream = axis_size(mesh, STREAM_AXIS)
    if PAGED_COMMIT_CHUNK % n_stream:
        return (
            f"mesh shape: the {PAGED_COMMIT_CHUNK}-triple paged commit "
            f"chunk does not split over the {n_stream}-way stream axis"
        )
    return None


def _ck_fused_paged_mesh(mesh, batch_size) -> str | None:
    if mesh is None:
        return None
    from loghisto_tpu_torch.parallel.mesh import AXES, STREAM_AXIS, axis_size

    if tuple(getattr(mesh, "mesh_dim_names", None) or ()) != AXES:
        return None  # the pool-mesh edge names the axis-layout reason
    n_stream = axis_size(mesh, STREAM_AXIS)
    if batch_size is not None and batch_size % n_stream:
        return (
            f"mesh shape: batch_size={batch_size} samples don't "
            f"split over the {n_stream}-way stream axis for the "
            "shard_map-embedded direct-to-paged step"
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
    mesh=None,
) -> str | None:
    """Why a configuration cannot (or should not) take the direct-to-
    paged fused ingest (K4f), or None.  ``crossover=False`` skips the
    policy edges (platform preference, batch amortization), as an
    explicit ``ingest_path="fused"`` does.  Edge order as in the JAX
    row: mesh, pool mesh, bucket axis, transport, platform, batch (the
    JAX threshold-table switch has no port)."""
    reason = (
        _ck_fused_paged_mesh(mesh, batch_size)
        or _ck_paged_mesh(mesh, num_metrics)
        or _ck_paged_bucket_axis(num_buckets)
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
    mesh=None,
) -> str | None:
    """Why a configuration cannot (or should not) run paged storage, or
    None.  ``crossover=False`` skips the metric-cardinality policy edge
    (an explicit ``storage="paged"`` may page a small deployment);
    ``fused_ok`` admits the raw transport (K4f ingests raw batches);
    ``mesh`` adds the reference's mesh-shape edge."""
    reason = (
        _ck_paged_mesh(mesh, num_metrics)
        or _ck_paged_transport(transport, fused_ok)
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
    mesh=None,
) -> tuple[str, str | None]:
    """Resolve the storage backend, "dense" or "paged".  Returns
    ``(resolved, reason)``: "auto" degrades to dense with the reason; an
    explicit "paged" that a capability blocker rules out raises it.
    With ``mesh`` the reference's mesh-shape edge joins the table.

    ``num_metrics`` counts registry rows: every distinct label set of a
    base name is its own row, so label cardinality drives the
    crossover."""
    del platform  # both backends run on every device (plain tier on CPU)
    if storage == "auto":
        reason = paged_storage_incapability(
            num_metrics, num_buckets, transport=transport, fused_ok=fused_ok,
            mesh=mesh,
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
            fused_ok=fused_ok, mesh=mesh,
        )
        if reason is not None:
            raise ValueError(f"paged storage unavailable: {reason}")
    return storage, None


# -- the interval commit (ROADMAP D3, D9) ------------------------------ #


def _ck_commit_axes(mesh) -> str | None:
    from loghisto_tpu_torch.parallel.mesh import METRIC_AXIS, STREAM_AXIS

    axes = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if STREAM_AXIS not in axes or METRIC_AXIS not in axes:
        return (
            f"mesh axes {axes!r} are not the ('{STREAM_AXIS}', "
            f"'{METRIC_AXIS}') commit layout"
        )
    return None


def _ck_commit_rows(mesh, num_metrics) -> str | None:
    from loghisto_tpu_torch.parallel.mesh import METRIC_AXIS, axis_size

    n_metric = axis_size(mesh, METRIC_AXIS)
    if num_metrics and num_metrics % n_metric:
        return (
            f"num_metrics={num_metrics} rows don't shard evenly over "
            f"the {n_metric}-way metric axis"
        )
    return None


def mesh_commit_incapability(mesh, num_metrics=None) -> str | None:
    """Why a mesh cannot run the sharded fused commit, as the
    reference's sentence, or None when it can (``mesh=None`` always
    can).  The reference's two edges: the mesh must carry the
    ("stream", "metric") commit layout (the cells merge over stream,
    every carry splits over metric), and ``num_metrics``, when known,
    must split evenly over the metric axis."""
    if mesh is None:
        return None
    return _ck_commit_axes(mesh) or _ck_commit_rows(mesh, num_metrics)


def resolve_commit_path(path: str, *, mesh=None,
                        num_metrics: int | None = None) -> str:
    """Resolve the interval-commit path, "fused" (one
    ``IntervalCommitter`` for the aggregator and every retention tier)
    or "fanout" (the aggregator's and the wheel's bridges).  "auto"
    gives "fused", as the reference's "auto" does, on dense and on
    paged storage alike (the paged committer carries the pool in the
    accumulator's place) and on every device.  With ``mesh`` (a
    ("stream", "metric") mesh) "auto" degrades to "fanout" where
    ``mesh_commit_incapability`` gives a reason, and an explicit
    "fused" raises with it.  A system without retention has one
    consumer and commits through the fan-out whatever this returns
    (``TorchMetricSystem``).  The reference's ``platform`` argument has
    no role here and is not taken."""
    reason = mesh_commit_incapability(mesh, num_metrics)
    if path == "auto":
        return "fanout" if reason is not None else "fused"
    if path not in ("fused", "fanout"):
        raise ValueError(
            f"unknown commit path {path!r}: expected 'auto', 'fused', or "
            "'fanout'"
        )
    if path == "fused" and reason is not None:
        raise ValueError(f"fused commit unavailable on this mesh: {reason}")
    return path


class FullPath(NamedTuple):
    """One resolved end-to-end dispatch: the wire the samples ride
    (transport), the kernel that consumes them (ingest), the layout that
    accumulates them (storage) and the program that closes the interval
    (commit), with every reason the walk declined a more capable
    contender, keyed "axis:contender"."""

    transport: str
    ingest: str
    storage: str
    commit: str
    reasons: Dict[str, str]


def resolve_full_path(
    num_metrics: int,
    num_buckets: int,
    platform: str,
    ingest: str = "auto",
    storage: str = "auto",
    transport: str = "auto",
    commit: str = "auto",
    batch_size: int | None = None,
    mesh=None,
    guard_metrics: int | None = None,
    density: float | None = None,
) -> FullPath:
    """The reference's composed resolver: one walk of the four axes,
    which depend on each other (paged storage without K4f pins the
    sparse transport, a capable K4f takes raw samples straight into the
    pool).  ``platform`` is the device type ("cuda" where the reference
    names "tpu", the one departure of the fused paged edge); ``mesh`` a
    ("stream", "metric") mesh or None."""
    reasons: Dict[str, str] = {}
    fp_reason = fused_paged_incapability(
        num_metrics, num_buckets, batch_size=batch_size,
        transport=transport, platform=platform,
        crossover=(ingest == "auto"), mesh=mesh,
    )
    fused_ok = fp_reason is None and ingest in ("auto", "fused")
    if fp_reason is not None:
        reasons["ingest:fused_paged"] = fp_reason
    storage_res, s_reason = resolve_storage_path(
        storage, num_metrics, num_buckets, platform, transport=transport,
        fused_ok=fused_ok, mesh=mesh,
    )
    if s_reason is not None:
        reasons["storage:paged"] = s_reason
    if storage_res == "paged":
        if ingest == "fused" and fp_reason is not None:
            raise ValueError(f"fused paged ingest unavailable: {fp_reason}")
        # K4f takes the raw batch; without it the host fold feeds K4
        ingest_res, transport_res = (("fused_paged", "raw") if fused_ok
                                     else ("packed", "sparse"))
    else:
        ingest_res = resolve_ingest_path(
            ingest, num_metrics, batch_size, num_buckets,
            guard_metrics=guard_metrics, mesh=mesh,
        )
        transport_res = (choose_transport(platform, density=density)
                         if transport == "auto" else transport)
    commit_reason = mesh_commit_incapability(mesh, num_metrics)
    if commit_reason is not None:
        reasons["commit:fused"] = commit_reason
    commit_res = resolve_commit_path(commit, mesh=mesh,
                                     num_metrics=num_metrics)
    return FullPath(transport_res, ingest_res, storage_res, commit_res,
                    reasons)
