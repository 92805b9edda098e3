"""The multi-rank launcher of the port's mesh tests and the scenarios each
rank runs (``tests/test_torch_mesh.py``, ``test_torch_multihost.py``,
``test_torch_firehose.py``, ``test_torch_sketches.py`` and the mesh
commit, lifecycle, recovery and paged files hold the results against
the JAX package in the test process; ``test_torch_contracts.py`` holds
the program registry's mesh entries, job ``programs``, against their
one-device twins).

``launch(tmp, world, job, inputs)`` starts ``world`` fresh interpreters
that rendezvous through a ``FileStore`` in ``tmp`` (gloo on the CPU,
``parallel.multihost.initialize(f"file://...")``), read their inputs from
``tmp/inputs.npz``, run every scenario of ``job`` and write their
results to ``tmp/rank<r>.npz``.  Each rank runs one torch thread, loads
no JAX (checked at its end) and runs collectives only on its main thread
(a guard wraps them, so a transfer worker that made one fails the
launch instead of hanging it).  A rank that fails ends the launch: the
others get 5 s to exit, then are killed, and every failed rank's output
(its traceback) goes into the failure.  At the deadline (120 s) every
rank is killed.

This file imports no JAX (and pytest only inside its tests): the ranks
import it.  Its own tests hold the launcher to that contract."""

import io
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent
DEADLINE_S = 120.0
FOREIGN = ("jax", "jaxlib", "loghisto_tpu")

_RANK_CODE = (
    "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
    "import test_torch_ranks as t; sys.exit(t._rank_main(sys.argv[3:]))"
)


def launch(tmp, world: int, job: str, inputs=None,
           deadline: float = DEADLINE_S, device: str = "cpu") -> list:
    """Run ``job`` on ``world`` ranks; each rank's results as a dict of
    arrays, in rank order.  ``device="cuda"`` puts every rank on the card
    (gloo still: NCCL refuses two ranks on one GPU)."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    if inputs is not None:
        np.savez(tmp / "inputs.npz", **inputs)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    procs, logs = [], []
    try:
        for r in range(world):
            logs.append(open(tmp / f"rank{r}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK_CODE, str(TESTS), str(ROOT),
                 str(r), str(world), str(tmp), job, device],
                stdout=logs[-1], stderr=subprocess.STDOUT, cwd=ROOT,
                env=env))
        end = time.monotonic() + deadline
        while time.monotonic() < end:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                break
            if any(codes):  # one failed: the rest cannot finish, but
                # give them a moment to exit with their own tracebacks
                end = min(end, time.monotonic() + 5.0)
            time.sleep(0.02)
    finally:
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        msg = [f"job {job!r} on {world} ranks failed"]
        for r in failed:
            why = ("killed at the deadline" if r in hung
                   else f"exit {procs[r].returncode}")
            text = (tmp / f"rank{r}.log").read_text()[-4000:]
            msg.append(f"--- rank {r} ({why}):\n{text}")
        if hung:
            msg.append(f"ranks killed: {hung}")
        raise AssertionError("\n".join(msg))
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


def _guard_collectives() -> None:
    """Collectives run only on the main thread: the entry points that
    make them are the caller's (collect(), a step's collect)."""
    import threading

    import torch.distributed as dist

    main = threading.main_thread()
    for name in ("all_reduce", "all_gather", "broadcast", "barrier",
                 "all_gather_object", "reduce_scatter", "all_to_all_single"):
        fn = getattr(dist, name)

        def guarded(*a, _fn=fn, _name=name, **kw):
            if threading.current_thread() is not main:
                raise AssertionError(
                    f"{_name} on thread {threading.current_thread().name}")
            return _fn(*a, **kw)

        setattr(dist, name, guarded)


def _rank_main(argv) -> int:
    rank, world, tmp, job = int(argv[0]), int(argv[1]), Path(argv[2]), argv[3]
    torch.set_num_threads(1)
    _guard_collectives()
    from loghisto_tpu_torch.parallel import multihost

    multihost.initialize(f"file://{tmp / 'rdzv'}", world, rank,
                         device=argv[4], backend="gloo", timeout_s=60.0)
    try:
        path = tmp / "inputs.npz"
        inputs = dict(np.load(path)) if path.exists() else {}
        kind, _, arg = job.partition(":")
        out = {}
        JOBS[kind](out, rank, arg, inputs)
        bad = [k for k in sys.modules if k.split(".")[0] in FOREIGN]
        if bad:
            raise AssertionError(f"rank {rank} loaded {sorted(bad)[:5]}")
        np.savez(tmp / f"rank{rank}.npz", **out)
    finally:
        multihost.shutdown()
    return 0


# -- result helpers ------------------------------------------------------------

def put_metrics(out, key, metrics) -> None:
    names = sorted(metrics)
    out[key + ".keys"] = np.array(names, dtype=str)
    out[key + ".values"] = np.array([metrics[n] for n in names],
                                    dtype=np.float64)


def get_metrics(res, key) -> dict:
    return dict(zip(res[key + ".keys"].tolist(),
                    res[key + ".values"].tolist()))


def _raises(fn) -> np.ndarray:
    """The message of the ValueError ``fn`` raises ('' if none)."""
    try:
        fn()
    except ValueError as e:
        return np.array(str(e))
    return np.array("")


# -- the mesh module (tests/test_torch_mesh.py) --------------------------------

SHAPES = ((2, 1), (1, 2), (2, 2), (4, 1), (1, 4))
MESH_M = 16
MESH_BL = 256
MESH_B = 2 * MESH_BL + 1
MESH_PS = np.array([0.0, 0.5, 0.99, 1.0], dtype=np.float32)
MESH_NAMES = [f"m{i}" for i in range(MESH_M - 1)]  # the last row unnamed
STEP_N = 4096
STEPS = 2
STEP_PATHS = ("auto", "scatter", "sort", "hybrid")
AGG_INTERVALS = 2
AGG_BATCH = 1024
SPILL_THRESHOLD = 1500
GROW_M0 = 8
GROW_MAX = 32
GROW_NAMES = [f"g{i}" for i in range(20)]
GROW_SEEN = (12, 20)  # names by the end of each interval: 8 -> 16 -> 32


def grow_feed(agg, inputs, s, i, raw_cls):
    """Interval i of the growth scenario for stream row s: one sample of
    every name so far through ``record`` (the names interned in the same
    order on every rank, growing the registry), the row's samples, and
    in the second interval a ``merge_raw`` of cells on the grown rows."""
    probe = inputs["grow.probe"]
    for k, name in enumerate(GROW_NAMES[:GROW_SEEN[i]]):
        agg.record(name, float(probe[k]))
    ids, values = inputs[f"grow.{i}.{s}.ids"], inputs[f"grow.{i}.{s}.values"]
    for off in range(0, len(ids), feed_chunk(s)):
        agg.record_batch(ids[off:off + feed_chunk(s)],
                         values[off:off + feed_chunk(s)])
    if i:
        agg.merge_raw(raw_from_cells(inputs[f"grow.cells.{s}"], raw_cls,
                                     GROW_NAMES))


def agg_rows(s: int, i: int) -> int:
    """Samples of stream row s in interval i: uneven across rows."""
    return 2000 + 900 * s + 300 * i


def feed_chunk(s: int) -> int:
    """record_batch piece size of stream row s: uneven across rows."""
    return 700 + 250 * s


def raw_from_cells(cells, raw_cls, names=MESH_NAMES):
    """A RawMetricSet of ``cells`` (name index, codec bucket, count)."""
    import datetime as dt

    hists = {}
    for k, b, c in cells.tolist():
        row = hists.setdefault(names[k], {})
        row[b] = row.get(b, 0) + c
    return raw_cls(dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc), {}, {},
                   hists, {}, 1.0)


def _mesh_steps(out, mesh, inputs):
    from loghisto_tpu_torch.parallel.aggregator import (
        make_distributed_step,
        make_interval_distributed_step,
        make_sharded_accumulator,
    )
    from loghisto_tpu_torch.parallel.mesh import METRIC_AXIS, axis_size
    from loghisto_tpu_torch.parallel.multihost import local_sample_shard

    start, size = local_sample_shard(STEP_N, mesh)
    ids = torch.from_numpy(inputs["step.ids"][:, start:start + size].copy())
    values = torch.from_numpy(
        inputs["step.values"][:, start:start + size].copy())
    for path in STEP_PATHS:
        step = make_distributed_step(mesh, MESH_M, MESH_BL, MESH_PS,
                                     ingest_path=path, batch_size=size)
        acc = make_sharded_accumulator(mesh, MESH_M, MESH_B)
        for k in range(STEPS):
            acc, st = step(acc, ids[k], values[k])
            out[f"step.{path}.acc.{k}"] = acc.cpu().numpy().copy()
            out[f"step.{path}.counts.{k}"] = st["counts"].numpy()
            out[f"step.{path}.pcts.{k}"] = st["percentiles"].numpy()
        out[f"step.{path}.path"] = np.array(step.ingest_path)

    # a block of one row: "auto" takes the row kernel (K2b) per rank
    one = axis_size(mesh, METRIC_AXIS)
    step = make_distributed_step(mesh, one, MESH_BL, MESH_PS,
                                 batch_size=size)
    acc = make_sharded_accumulator(mesh, one, MESH_B)
    acc, _ = step(acc, ids[0] % one, values[0])
    out["step.row.acc"] = acc.numpy().copy()
    out["step.row.path"] = np.array(step.ingest_path)

    ingest, collect, make_partial = make_interval_distributed_step(
        mesh, MESH_M, MESH_BL, MESH_PS, batch_size=size)
    acc = make_sharded_accumulator(mesh, MESH_M, MESH_B)
    partial = ingest(make_partial(), ids[0], values[0])
    pending = collect.start(acc, partial)
    # the next batch folds into a fresh partial while the reduction is
    # in flight
    fresh = ingest(make_partial(), ids[1], values[1])
    acc, st = pending.wait()
    out["interval.acc.0"] = acc.numpy().copy()
    acc, partial, st = collect(acc, fresh)
    out["interval.acc.1"] = acc.numpy().copy()
    out["interval.counts"] = st["counts"].numpy()
    out["interval.fresh_sum"] = np.array(int(partial.sum()))
    acc, partial, st = collect(acc, partial)  # nothing carries over
    out["interval.acc.2"] = acc.numpy().copy()


def _mesh_aggregator(out, mesh, inputs, tag, transport, **kw):
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.parallel.mesh import STREAM_AXIS, axis_index

    s = axis_index(mesh, STREAM_AXIS)
    agg = TorchAggregator(
        num_metrics=MESH_M, config=MetricConfig(bucket_limit=MESH_BL),
        transport=transport, batch_size=AGG_BATCH, mesh=mesh,
        max_metrics=MESH_M, **kw)

    def close_interval(key):
        agg.flush(force=True)
        partial = agg._acc.cpu().numpy().astype(np.int64)
        if agg._spill is not None:
            partial = partial + agg._spill
        out[f"{key}.partial"] = partial
        out[f"{key}.spilled"] = np.array(agg._spill is not None)
        put_metrics(out, key, agg.collect().metrics)

    try:
        for name in MESH_NAMES:
            agg.registry.id_for(name)
        chunk = feed_chunk(s)
        for i in range(AGG_INTERVALS):
            ids = inputs[f"agg.{i}.{s}.ids"]
            values = inputs[f"agg.{i}.{s}.values"]
            for off in range(0, len(ids), chunk):
                agg.record_batch(ids[off:off + chunk],
                                 values[off:off + chunk])
            close_interval(f"{tag}.{i}")
        if transport == "sparse":
            agg.merge_raw(raw_from_cells(inputs[f"cells.{s}"], RawMetricSet))
            agg.merge_packed(inputs[f"packed.{s}"])
            close_interval(f"{tag}.cells")
        out[f"{tag}.path"] = np.array(agg.ingest_path)
        out[f"{tag}.transport"] = np.array(agg.transport)
    finally:
        agg.close()


def _mesh_growth(out, mesh, inputs):
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.parallel.mesh import STREAM_AXIS, axis_index

    s = axis_index(mesh, STREAM_AXIS)
    agg = TorchAggregator(
        num_metrics=GROW_M0, config=MetricConfig(bucket_limit=MESH_BL),
        transport="raw", batch_size=AGG_BATCH, mesh=mesh,
        max_metrics=GROW_MAX)
    try:
        for i in range(len(GROW_SEEN)):
            grow_feed(agg, inputs, s, i, RawMetricSet)
            out[f"grow.{i}.capacity"] = np.array(agg.registry.capacity)
            put_metrics(out, f"grow.{i}", agg.collect().metrics)
            out[f"grow.{i}.rows"] = np.array(agg._acc.shape[0])
            out[f"grow.{i}.m"] = np.array(agg.num_metrics)
    finally:
        agg.close()


def _mesh_refusals(out, mesh):
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.parallel.aggregator import (
        TorchAggregator,
        make_distributed_step,
        make_interval_distributed_step,
    )
    from loghisto_tpu_torch.parallel.mesh import (
        METRIC_AXIS,
        axis_size,
        make_mesh,
    )

    cfg = MetricConfig(bucket_limit=MESH_BL)
    odd = 2 * axis_size(mesh, METRIC_AXIS) + 1
    out["refuse.mesh"] = _raises(lambda: make_mesh(stream=7, metric=3,
                                                   device="cpu"))
    out["refuse.step_rows"] = _raises(
        lambda: make_distributed_step(mesh, odd, MESH_BL, MESH_PS))
    out["refuse.interval_rows"] = _raises(
        lambda: make_interval_distributed_step(mesh, odd, MESH_BL, MESH_PS))
    out["refuse.agg_rows"] = _raises(lambda: TorchAggregator(
        num_metrics=odd, config=cfg, device="cpu", mesh=mesh,
        max_metrics=odd))
    out["refuse.paged"] = _raises(lambda: TorchAggregator(
        num_metrics=MESH_M, config=cfg, device="cpu", mesh=mesh,
        max_metrics=MESH_M, storage="paged").close())
    big = 1 << 16
    out["refuse.auto_paged"] = _raises(lambda: TorchAggregator(
        num_metrics=big, config=cfg, device="cpu", mesh=mesh,
        max_metrics=big, transport="sparse").close())
    out["refuse.multirow"] = _raises(lambda: TorchAggregator(
        num_metrics=MESH_M, config=cfg, device="cpu", mesh=mesh,
        max_metrics=MESH_M, ingest_path="multirow"))
    agg = TorchAggregator(num_metrics=MESH_M, config=cfg, device="cpu",
                          mesh=mesh, on_registry_full="error")
    # the state round-trips on a mesh since 11b-3 (ROADMAP D11)
    out["refuse.state"] = _raises(
        lambda: agg.load_state_dict(agg.state_dict()))
    out["state.same"] = np.array(_same_state(agg.state_dict(),
                                             agg.state_dict()))
    from loghisto_tpu_torch.commit import IntervalCommitter
    from loghisto_tpu_torch.window.store import TimeWheel

    from loghisto_tpu_torch.metrics import RawMetricSet

    # the mesh's fused commit (11b-1): the pair on one mesh commits
    wheel = TimeWheel(num_metrics=MESH_M, config=cfg, tiers=((2, 1),),
                      registry=agg.registry, mesh=mesh)
    cells = np.array([[0, 3, 5], [MESH_M // 2, -4, 2]], np.int64)
    out["commit.mode"] = np.array(IntervalCommitter(agg, wheel).commit(
        raw_from_cells(cells, RawMetricSet)))
    agg.close()


def _card_job(out, rank, arg, inputs):
    """Two ranks on the one card (``tests/test_torch_cuda.py``): both
    meshes of two ranks, the raw and sparse aggregators, the steps and
    growth, each rank's blocks, sets and launches."""
    import torch.distributed as dist

    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )
    from loghisto_tpu_torch.parallel.aggregator import (
        make_distributed_step,
        make_sharded_accumulator,
    )
    from loghisto_tpu_torch.parallel.mesh import (
        STREAM_AXIS,
        axis_group,
        make_mesh,
    )
    from loghisto_tpu_torch.parallel.multihost import local_sample_shard

    for shape in ((2, 1), (1, 2)):
        mesh = make_mesh(*shape, device=arg)
        tag = f"{shape[0]}x{shape[1]}"
        out[f"{tag}.coord"] = np.array(mesh.get_coordinate())
        for transport in ("raw", "sparse"):
            reset_kernel_launches()
            _mesh_aggregator(out, mesh, inputs, f"{tag}.{transport}",
                             transport)
            launched = kernel_launches()
            out[f"{tag}.{transport}.k1"] = np.array(launched["fused_ingest"])
            out[f"{tag}.{transport}.k3"] = np.array(
                launched["sparse_ingest"])
        start, size = local_sample_shard(STEP_N, mesh)
        step = make_distributed_step(mesh, MESH_M, MESH_BL, MESH_PS,
                                     batch_size=size)
        acc = make_sharded_accumulator(mesh, MESH_M, MESH_B)
        dev = acc.device
        for k in range(STEPS):
            acc, _ = step(acc, torch.from_numpy(
                inputs["step.ids"][k, start:start + size].copy()).to(dev),
                torch.from_numpy(inputs["step.values"][
                    k, start:start + size].copy()).to(dev))
        out[f"{tag}.step.acc"] = acc.cpu().numpy()
        out[f"{tag}.step.device"] = np.array(str(dev))
        grown = {}
        _mesh_growth(grown, mesh, inputs)
        out.update({f"{tag}.{k}": v for k, v in grown.items()})
        dist.barrier(group=axis_group(mesh, STREAM_AXIS))


def _mesh_job(out, rank, arg, inputs):
    from loghisto_tpu_torch.parallel.mesh import make_mesh

    stream, metric = map(int, arg.split("x"))
    mesh = make_mesh(stream, metric, device="cpu")
    out["coord"] = np.array(mesh.get_coordinate())
    _mesh_steps(out, mesh, inputs)
    _mesh_aggregator(out, mesh, inputs, "raw", "raw")
    _mesh_aggregator(out, mesh, inputs, "sparse", "sparse")
    _mesh_aggregator(out, mesh, inputs, "spill", "raw",
                     spill_threshold=SPILL_THRESHOLD)
    _mesh_growth(out, mesh, inputs)
    _mesh_refusals(out, mesh)


# -- the multihost module (tests/test_torch_multihost.py) ----------------------

MH_WORLD = 2
MH_M = 8
MH_BL = 128
MH_BATCH = 4096


def _multihost_job(out, rank, arg, inputs):
    import torch.distributed as dist

    from loghisto_tpu_torch.parallel import multihost
    from loghisto_tpu_torch.parallel.aggregator import (
        make_distributed_step,
        make_interval_distributed_step,
        make_sharded_accumulator,
    )
    from loghisto_tpu_torch.parallel.mesh import (
        acc_sharding,
        axis_size,
        row_vector_sharding,
    )

    out["shard"] = np.array(multihost.local_sample_shard(800))
    out["refuse.shard"] = _raises(lambda: multihost.local_sample_shard(801))
    ps = np.array([0.5, 1.0], dtype=np.float32)
    ids_all, values_all = inputs["mh.ids"], inputs["mh.values"]
    for metric in (1, 2):
        mesh = multihost.global_mesh(metric=metric, device="cpu")
        tag = f"mh{metric}"
        out[f"{tag}.shape"] = np.array([axis_size(mesh, "stream"),
                                        axis_size(mesh, "metric")])
        start, size = multihost.local_sample_shard(MH_BATCH, mesh)
        out[f"{tag}.slice"] = np.array([start, size])
        gids, gvalues = multihost.make_global_arrays(
            mesh, ids_all[start:start + size], values_all[start:start + size])
        step = make_distributed_step(mesh, MH_M, MH_BL, ps)
        acc = make_sharded_accumulator(mesh, MH_M, 2 * MH_BL + 1)
        acc, stats = step(acc, gids, gvalues)
        out[f"{tag}.counts"] = multihost.host_gather(
            stats["counts"], row_vector_sharding(mesh))
        out[f"{tag}.acc"] = multihost.host_gather(acc, acc_sharding(mesh))
        ingest, collect, make_partial = make_interval_distributed_step(
            mesh, MH_M, MH_BL, ps)
        partial = ingest(make_partial(), gids, gvalues)
        partial = ingest(partial, gids, gvalues)
        acc2 = make_sharded_accumulator(mesh, MH_M, 2 * MH_BL + 1)
        acc2, partial, stats2 = collect(acc2, partial)
        out[f"{tag}.counts2"] = multihost.host_gather(
            stats2["counts"], row_vector_sharding(mesh))
        table = np.arange(MH_M * 3, dtype=np.int64).reshape(MH_M, 3)
        part = multihost.global_put(table, acc_sharding(mesh))
        out[f"{tag}.put"] = part.numpy()
        out[f"{tag}.gather"] = multihost.host_gather(part, acc_sharding(mesh))
    mesh = multihost.global_mesh(device="cpu")
    n = 10 + 2 * dist.get_rank()
    out["refuse.global"] = _raises(lambda: multihost.make_global_arrays(
        mesh, np.zeros(n, np.int32), np.zeros(n, np.float32)))


# -- the firehose module (tests/test_torch_firehose.py) ------------------------

FH_SHAPE = (2, 2)
FH_M = 16
FH_BL = 128
FH_BATCH = 1024
FH_SEED = 5
FH_PATHS = ("auto", "scatter", "sort")


def _firehose_job(out, rank, arg, inputs):
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.firehose import (
        make_mesh_firehose_interval_step,
        run_firehose,
        stream_generator,
    )
    from loghisto_tpu_torch.parallel.aggregator import (
        make_sharded_accumulator,
    )
    from loghisto_tpu_torch.parallel.mesh import make_mesh

    cfg = MetricConfig(bucket_limit=FH_BL)
    mesh = make_mesh(*FH_SHAPE, device="cpu")
    out["coord"] = np.array(mesh.get_coordinate())
    gen = stream_generator(mesh, FH_SEED)
    out["first_draw"] = torch.rand(8, generator=gen).numpy()
    for path in FH_PATHS:
        ingest, collect, make_partial = make_mesh_firehose_interval_step(
            mesh, FH_M, FH_BATCH, cfg, ingest_path=path)
        gen = stream_generator(mesh, FH_SEED)
        partial, gen = ingest(make_partial(), gen)
        partial, gen = ingest(partial, gen)
        acc = make_sharded_accumulator(mesh, FH_M, cfg.num_buckets)
        acc, partial = collect(acc, partial)
        out[f"{path}.acc"] = acc.numpy().copy()
        out[f"{path}.fresh_sum"] = np.array(int(partial.sum()))
        out[f"{path}.path"] = np.array(ingest.ingest_path)
    sink = ("127.0.0.1", int(inputs["sink_port"]))
    summary = run_firehose(num_metrics=FH_M, batch=FH_BATCH, seconds=0.6,
                           interval=0.2, config=cfg, mesh=mesh, sink=sink,
                           out=io.StringIO(), seed=FH_SEED)
    for key in ("total_samples", "collected_samples", "intervals"):
        out[f"run.{key}"] = np.array(summary[key])
    out["run.platform"] = np.array(summary["platform"])


# -- the sketches module (tests/test_torch_sketches.py) ------------------------

SK_STREAM = 4


def _sketches_job(out, rank, arg, inputs):
    import torch.distributed as dist

    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.models import LogHistogram, hll, moments
    from loghisto_tpu_torch.parallel.mesh import (
        STREAM_AXIS,
        axis_group,
        make_mesh,
    )
    from loghisto_tpu_torch.parallel.multihost import local_sample_shard

    mesh = make_mesh(SK_STREAM, 1, device="cpu")
    group = axis_group(mesh, STREAM_AXIS)

    def mine(key):
        values = inputs[key]
        start, size = local_sample_shard(len(values), mesh)
        return torch.from_numpy(values[start:start + size].copy())

    regs = hll.insert(hll.empty(device="cpu"), mine("hll"))
    dist.all_reduce(regs, op=dist.ReduceOp.MAX, group=group)
    out["hll"] = regs.numpy()

    state = moments.insert(moments.empty(device="cpu"), mine("moments"))
    fields = [f.name for f in moments.MomentsState.__dataclass_fields__
              .values()]
    gathered = {}
    for name in fields:
        mine_t = getattr(state, name).reshape(1)
        parts = [torch.empty_like(mine_t) for _ in range(SK_STREAM)]
        dist.all_gather(parts, mine_t, group=group)
        gathered[name] = parts
    states = [moments.MomentsState(**{n: gathered[n][r][0] for n in fields})
              for r in range(SK_STREAM)]
    while len(states) > 1:  # a tree in rank order: (0 1) (2 3), then up
        states = [moments.merge(states[i], states[i + 1])
                  for i in range(0, len(states), 2)]
    for name in fields:
        out[f"moments.{name}"] = getattr(states[0], name).numpy()

    cfg = MetricConfig(bucket_limit=256)
    h = LogHistogram.empty(cfg, device="cpu").insert(mine("loghist"))
    dist.all_reduce(h.counts, group=group)
    out["loghist"] = h.counts.numpy()


# -- the launcher's own contract -----------------------------------------------

def _selftest_job(out, rank, arg, inputs):
    import threading

    import torch.distributed as dist

    if arg == "raise" and rank == 1:
        raise ValueError("boom from rank 1")
    if arg == "worker":  # a collective off the main thread must fail
        err = []

        def run():
            try:
                dist.barrier()
            except AssertionError as e:
                err.append(str(e))

        t = threading.Thread(target=run, name="not-main")
        t.start()
        t.join(30.0)
        out["err"] = np.array(err[0] if err else "")
    if arg == "hang":
        time.sleep(600)
    dist.barrier()
    out["rank"] = np.array(rank)


# -- the mesh's fused commit (tests/test_torch_mesh_commit.py) ------------------

MC_SHAPES = ((2, 1), (1, 2), (2, 2))
MC_M = 16
MC_BL = 256
MC_TIERS = ((3, 1), (2, 3))
MC_CHUNK = 8
MC_INTERVALS = 7
MC_BROADCAST = 3  # the system scenario's first intervals ride the bridge
MC_STOP = 2  # rank (s, m) queues MC_STOP + s + m intervals before stop()
MC_PS = (0.0, 0.5, 0.9, 0.99, 1.0)
# (pattern, window): the full span (a snapshot view), a window no view
# covers (the locked recompute, which pins it), a selector, a glob
MC_QUERIES = (("*", None), ("svc.*", 2.5), ("api.lat{code=500}", None),
              ("svc.m1", 2.0))
MC_GROW_M0 = 8
MC_GROW_MAX = 32
MC_GROW_INTERVALS = 6
MC_STREAM_ROWS = 2  # inputs are made for up to two stream rows


def mc_names() -> list:
    """The main scenario's 14 names, in registration order: six labeled
    series (rows 0-5) and eight plain ones, so both blocks of a two-way
    metric axis hold rows."""
    from loghisto_tpu_torch.labels.model import canonical_name

    labeled = [canonical_name("api.lat", {"route": f"/r{k % 3}",
                                          "code": str(200 + 300 * (k // 3))})
               for k in range(6)]
    return labeled + [f"svc.m{k}" for k in range(8)]


def mc_grow_names(i: int) -> list:
    return [f"grow{j}" for j in range(i + 4)]


def mc_raw(raw_cls, rows, names, i):
    """Interval i as one RawMetricSet: every name, in order (so each
    registry interns them alike), holding the merged cells (name index,
    codec bucket, count) of the stream rows ``rows`` ((s, cells) pairs),
    and the rows' ``req`` counter."""
    import datetime as dt

    hists = {name: {} for name in names}
    rate = 0
    for s, cells in rows:
        for k, b, c in cells.tolist():
            h = hists[names[k]]
            h[b] = h.get(b, 0) + c
        rate += i + s
    return raw_cls(
        dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
        + dt.timedelta(seconds=i), {}, {"req": rate}, hists, {}, 1.0)


def _put_window(out, key, ws) -> None:
    """A WindowStats (or GroupStats) as flat arrays."""
    flat = {}
    entries = ws.metrics if hasattr(ws, "metrics") else {
        "|".join(k): v for k, v in ws.groups.items()}
    for name, entry in entries.items():
        for stat, value in entry.items():
            if stat == "edges":
                for j, v in enumerate(value):
                    flat[f"{name}.edge{j}"] = v
            else:
                flat[f"{name}.{stat}"] = value
    put_metrics(out, key, flat)
    out[key + ".meta"] = np.array([ws.covered_s, ws.tier, ws.slots])


def _put_wheel(out, key, wheel) -> None:
    for t, tier in enumerate(wheel._tiers):
        out[f"{key}.ring{t}"] = tier.ring.cpu().numpy().copy()
        out[f"{key}.state{t}"] = np.array(
            [tier.slot, tier.in_slot, *tier.written.astype(int)])
        out[f"{key}.durations{t}"] = tier.durations.copy()


def _mc_serve(out, key, query, group_by, rate) -> None:
    """The served results the test holds against JAX: every query of
    MC_QUERIES, a group-by with equi-depth edges, a counter rate."""
    for q, (pattern, window) in enumerate(MC_QUERIES):
        _put_window(out, f"{key}.q{q}", query(pattern, window, MC_PS))
    _put_window(out, f"{key}.group", group_by(
        "api.lat{}", ["route"], window=None, percentiles=MC_PS, depth=4))
    out[f"{key}.rate"] = np.array(rate("req", 3.0))


def _mc_fused(out, mesh, inputs, s) -> None:
    """The committer by hand on the aggregator and the wheel."""
    from loghisto_tpu_torch.commit import IntervalCommitter
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.labels import LabelIndex
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.window.store import TimeWheel

    cfg = MetricConfig(bucket_limit=MC_BL)
    agg = TorchAggregator(num_metrics=MC_M, config=cfg, mesh=mesh,
                          max_metrics=MC_M)
    wheel = TimeWheel(num_metrics=MC_M, config=cfg, interval=1.0,
                      tiers=MC_TIERS, registry=agg.registry, mesh=mesh)
    wheel.label_index = LabelIndex(wheel.registry)
    com = IntervalCommitter(agg, wheel, chunk=MC_CHUNK)
    names = mc_names()
    try:
        modes, steps = [], []
        for i in range(MC_INTERVALS):
            raw = mc_raw(RawMetricSet, [(s, inputs[f"mc.{i}.{s}"])], names, i)
            modes.append(com.commit(raw))
            steps.append(com.last_dispatches)
        out["fused.modes"] = np.array(modes)
        out["fused.steps"] = np.array(steps)
        out["fused.snapshot_none"] = np.array(agg.stats_snapshot is None)
        out["fused.hbm"] = np.array(wheel.hbm_bytes())
        _put_wheel(out, "fused", wheel)
        _mc_serve(out, "fused", wheel.query, wheel.query_group_by,
                  wheel.window_rate)
        put_metrics(out, "fused.collect", agg.collect(reset=False).metrics)
        out["fused.acc"] = agg._acc.cpu().numpy().copy()
    finally:
        agg.close()


def _mc_failure(out, mesh, inputs, s, rank) -> None:
    """Rank 0's commit fails before its first step (the fault injector's
    ``commit.dispatch``): it spills the cells not applied and still
    sends every share; a query right after it (rank 0 has no
    snapshot, its peers do) takes one serve path on every rank."""
    from loghisto_tpu_torch.commit import IntervalCommitter
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.resilience import FaultInjector
    from loghisto_tpu_torch.window.store import TimeWheel

    cfg = MetricConfig(bucket_limit=MC_BL)
    agg = TorchAggregator(num_metrics=MC_M, config=cfg, mesh=mesh,
                          max_metrics=MC_M)
    wheel = TimeWheel(num_metrics=MC_M, config=cfg, interval=1.0,
                      tiers=MC_TIERS, registry=agg.registry, mesh=mesh)
    com = IntervalCommitter(agg, wheel, chunk=MC_CHUNK)
    if rank == 0:
        com.fault_injector = FaultInjector().plan("commit.dispatch",
                                                  on_call=1)
    names = mc_names()
    try:
        for i in range(MC_INTERVALS):
            com.commit(mc_raw(RawMetricSet, [(s, inputs[f"mc.{i}.{s}"])],
                              names, i))
            if i == 0:
                out["failure.snapshot"] = np.array(wheel.snapshot is not None)
                out["failure.total0"] = np.array(
                    sum(int(t.ring.sum()) for t in wheel._tiers))
                _put_window(out, "failure.q", wheel.query("*", None, MC_PS))
        out["failure.spilled"] = np.array(agg._spill is not None)
        _put_wheel(out, "failure", wheel)
        put_metrics(out, "failure.collect", agg.collect(reset=False).metrics)
    finally:
        agg.close()


def _mc_growth(out, mesh, inputs, s) -> None:
    """Registry growth past the wheel's rows: the accumulator's blocks
    grow at collect(), the rings keep their rows."""
    from loghisto_tpu_torch.commit import IntervalCommitter
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.window.store import TimeWheel

    cfg = MetricConfig(bucket_limit=MC_BL)
    agg = TorchAggregator(num_metrics=MC_GROW_M0, config=cfg, mesh=mesh,
                          max_metrics=MC_GROW_MAX)
    wheel = TimeWheel(num_metrics=MC_GROW_M0, config=cfg, interval=1.0,
                      tiers=MC_TIERS, registry=agg.registry, mesh=mesh)
    com = IntervalCommitter(agg, wheel, chunk=MC_CHUNK)
    try:
        for i in range(MC_GROW_INTERVALS):
            com.commit(mc_raw(RawMetricSet, [(s, inputs[f"mcg.{i}.{s}"])],
                              mc_grow_names(i), i))
        out["grow.capacity"] = np.array(agg.registry.capacity)
        _put_wheel(out, "grow", wheel)
        put_metrics(out, "grow.collect", agg.collect(reset=False).metrics)
        out["grow.acc"] = agg._acc.cpu().numpy().copy()
        out["grow.m"] = np.array(agg.num_metrics)
    finally:
        agg.close()


def _mc_system(out, mesh, inputs, s) -> None:
    """TorchMetricSystem(mesh=, commit="auto"): the first intervals ride
    the committer's bridge (queued, D9) and the first query commits them;
    the rest replay through backfill_retention."""
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.system import TorchMetricSystem

    ms = TorchMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=MC_M,
        config=MetricConfig(bucket_limit=MC_BL), retention=MC_TIERS,
        mesh=mesh, observability=True)
    names = mc_names()
    raws = [mc_raw(RawMetricSet, [(s, inputs[f"mc.{i}.{s}"])], names, i)
            for i in range(MC_INTERVALS)]
    try:
        out["system.path"] = np.array(
            [ms.commit_path, str(ms.commit_path_reason)])
        dump = ms.debug_dump()["mesh"]
        out["system.mesh"] = np.array([dump["stream"], dump["metric"]])
        ms._update_subscribers()  # the committer's subscription
        for raw in raws[:MC_BROADCAST]:
            with ms._subscribers_lock:
                ms._broadcast(ms._raw_subscribers, raw)
        end = time.monotonic() + 30.0
        while len(ms.committer._queue) < MC_BROADCAST:
            if time.monotonic() > end:
                raise AssertionError("the bridge did not queue the intervals")
            time.sleep(0.01)
        out["system.queued"] = np.array(ms.committer.intervals_committed)
        ms.query("*")  # commits the queued intervals, then serves
        out["system.drained"] = np.array(ms.committer.intervals_committed)
        out["system.backfilled"] = np.array(
            ms.backfill_retention(raws[MC_BROADCAST:]))
        _put_wheel(out, "system", ms.retention)
        _mc_serve(out, "system", ms.query, ms.query_group_by, ms.window_rate)
        put_metrics(out, "system.collect",
                    ms.device_metrics(reset=False).metrics)
        out["system.acc"] = ms.aggregator._acc.cpu().numpy().copy()
        out["system.health"] = np.array(
            ms.health.report().reason_codes(), dtype=str)
    finally:
        ms.stop()


def _mc_fanout(out, mesh, inputs, s) -> None:
    """commit="fanout" on the mesh: the wheel's push gathers the stream
    rows' cells, the aggregator merges its row's."""
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.system import TorchMetricSystem

    ms = TorchMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=MC_M,
        config=MetricConfig(bucket_limit=MC_BL), retention=MC_TIERS,
        mesh=mesh, commit="fanout")
    names = mc_names()
    raws = [mc_raw(RawMetricSet, [(s, inputs[f"mc.{i}.{s}"])], names, i)
            for i in range(MC_INTERVALS)]
    try:
        out["fanout.path"] = np.array([ms.commit_path,
                                       str(ms.committer is None)])
        ms.backfill_retention(raws)
        for raw in raws:
            ms.aggregator.merge_raw(raw)
        _put_wheel(out, "fanout", ms.retention)
        _mc_serve(out, "fanout", ms.query, ms.query_group_by, ms.window_rate)
        put_metrics(out, "fanout.collect",
                    ms.device_metrics(reset=False).metrics)
        out["fanout.acc"] = ms.aggregator._acc.cpu().numpy().copy()
    finally:
        ms.stop()


def mc_stop_count(s: int, m: int) -> int:
    return MC_STOP + s + m


def _mc_stop(out, mesh, inputs, s, commit) -> None:
    """stop() with unequal queues: rank (s, m) broadcasts
    ``mc_stop_count(s, m)`` intervals of its stream row through the
    bridge (the committer's, or the wheel's on the fan-out path) and
    stops; the last drain commits the most any rank holds, a rank short
    of it an empty interval for each it lacks.  Then the rings and the
    collected accumulator, read after stop()."""
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.parallel.mesh import METRIC_AXIS, axis_index
    from loghisto_tpu_torch.system import TorchMetricSystem

    key = f"stop_{commit}"
    n = mc_stop_count(s, axis_index(mesh, METRIC_AXIS))
    ms = TorchMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=MC_M,
        config=MetricConfig(bucket_limit=MC_BL), retention=MC_TIERS,
        mesh=mesh, commit=commit, observability=True)
    part = ms.committer if ms.committer is not None else ms.retention
    names = mc_names()
    for name in names:
        # the two bridges of the fan-out path race to intern a raw set's
        # names: registered up front, every rank's registry is the same
        ms.metric_id(name)
    try:
        ms._update_subscribers()
        for i in range(n):
            with ms._subscribers_lock:
                ms._broadcast(ms._raw_subscribers, mc_raw(
                    RawMetricSet, [(s, inputs[f"mc.{i}.{s}"])], names, i))
        end = time.monotonic() + 30.0
        while part.queued_intervals < n:
            if time.monotonic() > end:
                raise AssertionError("the bridge did not queue the intervals")
            time.sleep(0.01)
        out[f"{key}.queued"] = np.array(ms.debug_dump()["queued_intervals"])
        out[f"{key}.health"] = np.array(
            ms.health.report().reason_codes(), dtype=str)
    finally:
        ms.stop()
    out[f"{key}.padded"] = np.array(part._queue.padded)
    out[f"{key}.pushed"] = np.array(ms.retention.intervals_pushed)
    _put_wheel(out, key, ms.retention)
    ms.device_metrics(reset=False)
    out[f"{key}.acc"] = ms.aggregator._acc.cpu().numpy().copy()


def mc_incapable(orig):
    """A ``mesh_commit_incapability`` that counts one row more than the
    system has: the reference's reason for an indivisible row count, on
    a mesh whose aggregator must divide its rows (both packages' tests
    patch their own the same way)."""
    return lambda mesh, num_metrics=None: orig(mesh, (num_metrics or 0) + 1)


def _mc_degraded(out, mesh) -> None:
    """An incapable mesh: "auto" degrades with the reason (also the
    watchdog's), an explicit "fused" raises it."""
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.ops import dispatch
    from loghisto_tpu_torch.system import TorchMetricSystem

    orig = dispatch.mesh_commit_incapability
    dispatch.mesh_commit_incapability = mc_incapable(orig)
    kw = dict(interval=1.0, sys_stats=False, num_metrics=MC_M,
              config=MetricConfig(bucket_limit=MC_BL), retention=MC_TIERS,
              mesh=mesh)
    try:
        ms = TorchMetricSystem(observability=True, **kw)
        try:
            out["degraded.path"] = np.array(
                [ms.commit_path, str(ms.commit_path_reason)])
            details = [r["detail"] for r in ms.health.report().reasons
                       if r["code"] == "fused_degraded"]
            out["degraded.health"] = np.array(details, dtype=str)
        finally:
            ms.stop()
        out["degraded.explicit"] = _raises(
            lambda: TorchMetricSystem(commit="fused", **kw).stop())
    finally:
        dispatch.mesh_commit_incapability = orig


def _mc_refusals(out, mesh) -> None:
    from loghisto_tpu_torch.anomaly import AnomalyConfig, AnomalyManager
    from loghisto_tpu_torch.commit import IntervalCommitter
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.lifecycle import LifecycleConfig, LifecycleManager
    from loghisto_tpu_torch.ops import dispatch
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.parallel.mesh import METRIC_AXIS, axis_size
    from loghisto_tpu_torch.resilience import ResilienceConfig
    from loghisto_tpu_torch.system import TorchMetricSystem
    from loghisto_tpu_torch.window.store import TimeWheel

    cfg = MetricConfig(bucket_limit=MC_BL)
    agg = TorchAggregator(num_metrics=MC_M, config=cfg, mesh=mesh,
                          max_metrics=MC_M)
    wheel = TimeWheel(num_metrics=MC_M, config=cfg, tiers=MC_TIERS,
                      registry=agg.registry, mesh=mesh)
    plain = TimeWheel(num_metrics=MC_M, config=cfg, tiers=MC_TIERS,
                      registry=agg.registry, device="cpu")
    try:
        out["refuse.chunk"] = _raises(
            lambda: IntervalCommitter(agg, wheel, chunk=MC_CHUNK - 1))
        out["refuse.meshes"] = _raises(lambda: IntervalCommitter(agg, plain))
        out["refuse.lifecycle"] = _raises(lambda: IntervalCommitter(
            agg, wheel, lifecycle=LifecycleManager(agg, wheel,
                                                   LifecycleConfig())))
        out["refuse.anomaly"] = _raises(lambda: IntervalCommitter(
            agg, wheel, anomaly=AnomalyManager(agg, wheel, AnomalyConfig())))
        # the state on a mesh since 11b-3 (ROADMAP D11)
        out["refuse.agg_state"] = _raises(agg.state_dict)
        out["refuse.wheel_state"] = _raises(wheel.state_dict)
        out["refuse.wheel_rows"] = _raises(lambda: TimeWheel(
            num_metrics=2 * axis_size(mesh, METRIC_AXIS) + 1, config=cfg,
            tiers=MC_TIERS, mesh=mesh))
    finally:
        agg.close()
    kw = dict(interval=1.0, sys_stats=False, num_metrics=MC_M, config=cfg,
              retention=MC_TIERS, mesh=mesh)
    # lifecycle and drift on a mesh construct since item 11b-2
    out["refuse.sys_lifecycle"] = _raises(lambda: TorchMetricSystem(
        lifecycle=LifecycleConfig(), **kw).stop())
    out["refuse.sys_anomaly"] = _raises(lambda: TorchMetricSystem(
        anomaly=AnomalyConfig(), **kw).stop())
    with tempfile.TemporaryDirectory() as d:
        # crash recovery on a mesh since 11b-3: stop() checkpoints
        ms = None

        def recovering():
            nonlocal ms
            ms = TorchMetricSystem(resilience=ResilienceConfig(
                checkpoint_path=os.path.join(d, "ck.npz")), **kw)
            ms.stop()

        out["refuse.sys_recovery"] = _raises(recovering)
        out["sys_recovery.checkpoints"] = np.array(
            ms.recovery.checkpoints_taken)
    out["refuse.sys_paged"] = _raises(lambda: TorchMetricSystem(
        storage="paged", **kw).stop())
    odd = 2 * axis_size(mesh, METRIC_AXIS) + 1
    out["dispatch.reasons"] = np.array([
        str(dispatch.mesh_commit_incapability(mesh, MC_M)),
        str(dispatch.mesh_commit_incapability(mesh, odd)),
        dispatch.resolve_commit_path("auto", mesh=mesh,
                                     num_metrics=MC_M),
        dispatch.resolve_commit_path("auto", mesh=mesh,
                                     num_metrics=odd),
        dispatch.resolve_commit_path("fanout", mesh=mesh,
                                     num_metrics=odd),
    ])
    out["dispatch.explicit"] = _raises(lambda: dispatch.resolve_commit_path(
        "fused", mesh=mesh, num_metrics=odd))


def _mesh_commit_job(out, rank, arg, inputs):
    from loghisto_tpu_torch.parallel.mesh import (
        STREAM_AXIS,
        axis_index,
        make_mesh,
    )

    stream, metric = map(int, arg.split("x"))
    mesh = make_mesh(stream, metric, device="cpu")
    out["coord"] = np.array(mesh.get_coordinate())
    s = axis_index(mesh, STREAM_AXIS)
    _mc_fused(out, mesh, inputs, s)
    _mc_failure(out, mesh, inputs, s, rank)
    _mc_growth(out, mesh, inputs, s)
    _mc_system(out, mesh, inputs, s)
    _mc_fanout(out, mesh, inputs, s)
    for commit in ("auto", "fanout"):
        _mc_stop(out, mesh, inputs, s, commit)
    _mc_degraded(out, mesh)
    _mc_refusals(out, mesh)


# -- lifecycle and drift on a mesh (tests/test_torch_mesh_lifecycle.py) --------

ML_M = 32
ML_BL = 256
ML_TIERS = ((4, 2), (2, 3))
ML_CHUNK = 8
ML_INTERVALS = 10
ML_FRESH = 6  # fresh names an interval: ids spread over both blocks
ML_COMPACT_AT = 5  # an explicit compaction after this interval, and last
ML_DRIFT_M = 16
ML_DRIFT_NAMES = 12  # rows in both blocks of a two-way metric axis
ML_DRIFT_INTERVALS = 6
ML_SHIFT_AT = 4
ML_DRIFT_TIERS = ((4, 1),)
ML_GROW_M0 = 8
ML_GROW_MAX = 32
ML_GROW_INTERVALS = 6


def ml_names(i: int) -> list:
    """Interval i's names of the churn scenario, in order: ML_FRESH fresh
    ones, then the steady name."""
    return [f"api.u{i}_{j}.lat" for j in range(ML_FRESH)] + ["api.steady"]


def ml_drift_names(i: int = 0) -> list:
    return [f"lat{k}" for k in range(ML_DRIFT_NAMES)]


def ml_lifecycle_config(cls, ttl: int = 2):
    return cls(ttl_intervals=ttl, check_every=1,
               auto_compact_fragmentation=0.0)


def ml_anomaly_config(cls):
    return cls(decay=0.8, min_samples=16)


def _ml_pipeline(mesh, m0, tiers, max_metrics=None, lifecycle=None,
                 anomaly=None, **agg_kw):
    """The committer by hand on a mesh rank's aggregator and wheel, with
    the lifecycle and drift managers."""
    from loghisto_tpu_torch.anomaly import AnomalyManager
    from loghisto_tpu_torch.commit import IntervalCommitter
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.lifecycle import LifecycleManager
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.window.store import TimeWheel

    cfg = MetricConfig(bucket_limit=ML_BL)
    agg = TorchAggregator(num_metrics=m0, config=cfg, mesh=mesh,
                          max_metrics=max_metrics or m0, **agg_kw)
    wheel = TimeWheel(num_metrics=m0, config=cfg, interval=1.0, tiers=tiers,
                      registry=agg.registry, mesh=mesh)
    lc = LifecycleManager(agg, wheel, lifecycle) if lifecycle else None
    an = AnomalyManager(agg, wheel, anomaly) if anomaly else None
    if lc is not None and an is not None:
        lc.anomaly = an
    com = IntervalCommitter(agg, wheel, chunk=ML_CHUNK, lifecycle=lc,
                            anomaly=an)
    return com, agg, wheel, lc, an


def _put_carries(out, key, agg, wheel, lc=None, an=None) -> None:
    """A rank's blocks of every carry and the lifecycle's counters."""
    _put_wheel(out, key, wheel)
    out[f"{key}.acc"] = agg._acc.cpu().numpy().astype(np.int64) + (
        0 if agg._spill is None else agg._spill)
    out[f"{key}.names"] = np.array(
        ["" if n is None else n for n in agg.registry.names()], dtype=str)
    out[f"{key}.m"] = np.array(agg.num_metrics)
    if lc is not None:
        out[f"{key}.la"] = lc._la.cpu().numpy().copy()
        out[f"{key}.counters"] = np.array(
            [lc.evicted_series, lc.overflowed_samples, lc.evictions,
             lc.compactions])
    if an is not None:
        out[f"{key}.prof"] = an._prof.cpu().numpy().copy()
        out[f"{key}.wsum"] = an._wsum.cpu().numpy().copy()
        if an._ihist is not None:  # none after a restore, as in JAX
            out[f"{key}.ihist"] = an._ihist.cpu().numpy().copy()
        out[f"{key}.scored"] = np.array([an.scored_intervals,
                                         an.skipped_intervals])
        if an._scores is not None:
            for k, v in an._scores.items():
                out[f"{key}.scores.{k}"] = v.copy()


def _ml_churn(out, mesh, inputs, s, key, compact=True, fail_rank=None,
              **agg_kw) -> None:
    """The churn scenario: ML_FRESH fresh names an interval under a TTL
    of 2, an explicit compaction after interval ML_COMPACT_AT and after
    the last; the carries before and after the last compaction, the
    bytes each eviction and compaction sent."""
    import torch.distributed as dist

    from loghisto_tpu_torch.lifecycle import LifecycleConfig
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.resilience import FaultInjector

    com, agg, wheel, lc, _ = _ml_pipeline(
        mesh, ML_M, ML_TIERS, lifecycle=ml_lifecycle_config(LifecycleConfig),
        **agg_kw)
    if fail_rank is not None and dist.get_rank() == fail_rank:
        com.fault_injector = FaultInjector().plan("commit.dispatch",
                                                  on_call=1)
    evict_bytes, compact_bytes, modes = [], [], []
    real_evict = lc.evict_ids

    def evict_ids(victims):
        names = real_evict(victims)
        evict_bytes.append(lc.last_evict_bytes)
        return names

    lc.evict_ids = evict_ids
    try:
        for i in range(ML_INTERVALS):
            modes.append(com.commit(mc_raw(
                RawMetricSet, [(s, inputs[f"ml.{i}.{s}"])], ml_names(i), i)))
            if i == ML_COMPACT_AT and compact:
                lc.compact()
                compact_bytes.append(lc.last_compaction_bytes)
        _put_carries(out, f"{key}.pre", agg, wheel, lc)
        if compact:
            out[f"{key}.compacted"] = np.array(lc.compact())
            compact_bytes.append(lc.last_compaction_bytes)
            _put_carries(out, f"{key}.post", agg, wheel, lc)
        out[f"{key}.modes"] = np.array(modes)
        out[f"{key}.evict_bytes"] = np.array(evict_bytes, dtype=np.int64)
        out[f"{key}.compact_bytes"] = np.array(compact_bytes, dtype=np.int64)
        put_metrics(out, f"{key}.collect", agg.collect(reset=False).metrics)
    finally:
        agg.close()


def _ml_drift(out, mesh, inputs, s) -> None:
    """Drift scoring after a shape change: ML_DRIFT_NAMES names over both
    blocks, unimodal until ML_SHIFT_AT, then half of them bimodal."""
    from loghisto_tpu_torch.anomaly import AnomalyConfig
    from loghisto_tpu_torch.metrics import RawMetricSet

    com, agg, wheel, _, an = _ml_pipeline(
        mesh, ML_DRIFT_M, ML_DRIFT_TIERS,
        anomaly=ml_anomaly_config(AnomalyConfig))
    try:
        for i in range(ML_DRIFT_INTERVALS):
            com.commit(mc_raw(RawMetricSet, [(s, inputs[f"mld.{i}.{s}"])],
                              ml_drift_names(), i))
        _put_carries(out, "drift", agg, wheel, an=an)
        got = [an.scores_for(n) for n in ml_drift_names()]
        out["drift.served"] = np.array(
            [[g[k] for k in ("ks", "jsd", "emd")] if g else [-1.0] * 3
             for g in got])
    finally:
        agg.close()


def _ml_grow(out, mesh, inputs, s) -> None:
    """Growth past the wheel's rows with lifecycle and drift on: the
    accumulator's blocks, the activity block and the banks grow
    together; K7 scores each view block against the bank rows of the
    same global rows."""
    from loghisto_tpu_torch.anomaly import AnomalyConfig
    from loghisto_tpu_torch.lifecycle import LifecycleConfig
    from loghisto_tpu_torch.metrics import RawMetricSet

    com, agg, wheel, lc, an = _ml_pipeline(
        mesh, ML_GROW_M0, ML_DRIFT_TIERS, max_metrics=ML_GROW_MAX,
        lifecycle=ml_lifecycle_config(LifecycleConfig, ttl=3),
        anomaly=ml_anomaly_config(AnomalyConfig))
    try:
        for i in range(ML_GROW_INTERVALS):
            com.commit(mc_raw(RawMetricSet, [(s, inputs[f"mlg.{i}.{s}"])],
                              mc_grow_names(i), i))
        _put_carries(out, "grow", agg, wheel, lc, an)
        out["grow.wheel_m"] = np.array(wheel.num_metrics)
    finally:
        agg.close()


def _ml_system(out, mesh, inputs, s) -> None:
    """TorchMetricSystem(mesh=, retention=, lifecycle=, anomaly=): "auto"
    resolves the fused commit; the intervals replay through
    backfill_retention, then an explicit compaction."""
    from loghisto_tpu_torch.anomaly import AnomalyConfig
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.lifecycle import LifecycleConfig
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.system import TorchMetricSystem

    ms = TorchMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=ML_M,
        config=MetricConfig(bucket_limit=ML_BL), retention=ML_TIERS,
        mesh=mesh, lifecycle=ml_lifecycle_config(LifecycleConfig),
        anomaly=AnomalyConfig(decay=0.8, min_samples=4))
    try:
        out["system.path"] = np.array(
            [ms.commit_path, str(ms.commit_path_reason)])
        out["system.wired"] = np.array(ms.lifecycle.anomaly is ms.anomaly)
        out["system.backfilled"] = np.array(ms.backfill_retention(
            [mc_raw(RawMetricSet, [(s, inputs[f"ml.{i}.{s}"])], ml_names(i),
                    i) for i in range(ML_INTERVALS)]))
        out["system.compacted"] = np.array(ms.lifecycle.compact())
        _put_carries(out, "system", ms.aggregator, ms.retention,
                     ms.lifecycle, ms.anomaly)
        _put_window(out, "system.q", ms.query("*", None, MC_PS))
        gauges = ms.collect_raw_metrics().gauges
        put_metrics(out, "system.gauges", {
            k: v for k, v in gauges.items()
            if k.startswith(("lifecycle.", "anomaly."))
            and "Compaction" not in k})
        out["system.dump_keys"] = np.array(sorted(ms.debug_dump()),
                                           dtype=str)
    finally:
        ms.stop()


def _same_state(a: dict, b: dict) -> bool:
    """Two aggregator or wheel states hold the same values."""
    if a.keys() != b.keys():
        return False
    for key, v in a.items():
        w = b[key]
        if isinstance(v, np.ndarray) or isinstance(w, np.ndarray):
            if not np.array_equal(v, w):
                return False
        elif isinstance(v, list) and v and isinstance(v[0], np.ndarray):
            if not all(np.array_equal(x, y) for x, y in zip(v, w)):
                return False
        elif v != w:
            return False
    return True


def _ml_refusals(out, mesh) -> None:
    """What item 11b-3 lifted on a mesh (ROADMAP D11): the aggregator's
    and the wheel's state round trip, a system with a checkpoint path
    and one with a journal path."""
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.resilience import ResilienceConfig
    from loghisto_tpu_torch.system import TorchMetricSystem
    from loghisto_tpu_torch.window.store import TimeWheel

    cfg = MetricConfig(bucket_limit=ML_BL)
    agg = TorchAggregator(num_metrics=ML_M, config=cfg, mesh=mesh,
                          max_metrics=ML_M)
    wheel = TimeWheel(num_metrics=ML_M, config=cfg, tiers=ML_TIERS,
                      registry=agg.registry, mesh=mesh)
    try:
        states = []
        out["refuse.agg_state"] = _raises(
            lambda: states.append(agg.state_dict()))
        out["refuse.agg_load"] = _raises(
            lambda: agg.load_state_dict(states[0]))
        out["refuse.wheel_state"] = _raises(
            lambda: states.append(wheel.state_dict()))
        out["refuse.wheel_load"] = _raises(
            lambda: wheel.load_state_dict(states[1]))
        out["state.same"] = np.array(
            _same_state(states[0], agg.state_dict())
            and _same_state(states[1], wheel.state_dict()))
    finally:
        agg.close()
    kw = dict(interval=1.0, sys_stats=False, num_metrics=ML_M, config=cfg,
              retention=ML_TIERS, mesh=mesh)
    with tempfile.TemporaryDirectory() as d:
        systems = []

        def system(**res):
            systems.append(TorchMetricSystem(
                resilience=ResilienceConfig(**res), **kw))
            if res.get("journal_path"):
                systems[-1].recovery.start()
                journal = systems[-1].recovery._journal
                out["sys_journal.path"] = np.array(
                    [] if journal is None else
                    [os.path.basename(journal.path)], dtype=str)
            systems[-1].stop()

        out["refuse.sys_checkpoint"] = _raises(lambda: system(
            checkpoint_path=os.path.join(d, "ck.npz")))
        out["sys_checkpoint.taken"] = np.array(
            systems[0].recovery.checkpoints_taken)
        out["refuse.sys_journal"] = _raises(lambda: system(
            journal_path=os.path.join(d, "j.log")))


def _mesh_lifecycle_job(out, rank, arg, inputs):
    from loghisto_tpu_torch.parallel.mesh import (
        STREAM_AXIS,
        axis_index,
        make_mesh,
    )

    stream, metric = map(int, arg.split("x"))
    mesh = make_mesh(stream, metric, device="cpu")
    out["coord"] = np.array(mesh.get_coordinate())
    s = axis_index(mesh, STREAM_AXIS)
    _ml_churn(out, mesh, inputs, s, "churn")
    # every interval takes the fan-out (the exact host spill)
    _ml_churn(out, mesh, inputs, s, "fanout", spill_threshold=1)
    _ml_churn(out, mesh, inputs, s, "failure", compact=False, fail_rank=0)
    _ml_drift(out, mesh, inputs, s)
    _ml_grow(out, mesh, inputs, s)
    _ml_system(out, mesh, inputs, s)
    _ml_refusals(out, mesh)


# -- checkpoints and crash recovery across mesh shapes
#    (tests/test_torch_mesh_recovery.py) ----------------------------------------
MR_LAUNCHES = ("2x1,1x2", "2x2,4x1")  # (save mesh, target mesh) a launch
MR_M = 16
MR_BL = 256
MR_TIERS = ((4, 1),)
MR_NAMES = 12  # rows in both blocks of a two-way metric axis
MR_SAVED = 6  # intervals committed before the save
MR_OTHERS = 10  # names the growth target holds before its restore
MR_GROW_MAX = 64
MR_CRASH = 12  # intervals the crashed system drives by hand
MR_EVERY = 8  # its checkpoint cadence: the watermark stands at 8
MR_AFTER = 4  # intervals after the recovery
MR_STREAM_ROWS = 4


def mr_names(i: int = 0) -> list:
    return [f"lat{k}" for k in range(MR_NAMES)]


def mr_raw(raw_cls, inputs, rows, i):
    """Interval i (seq i + 1) holding the merged cells of stream rows
    ``rows``."""
    import dataclasses

    return dataclasses.replace(
        mc_raw(raw_cls, [(s, inputs[f"mr.{i}.{s}"]) for s in rows],
               mr_names(), i), seq=i + 1)


def mr_shapes(arg: str) -> list:
    return [tuple(map(int, part.split("x"))) for part in arg.split(",")]


def _mr_pipeline(mesh, m0=MR_M, max_metrics=None):
    from loghisto_tpu_torch.anomaly import AnomalyConfig
    from loghisto_tpu_torch.lifecycle import LifecycleConfig

    return _ml_pipeline(mesh, m0, MR_TIERS, max_metrics=max_metrics,
                        lifecycle=ml_lifecycle_config(LifecycleConfig),
                        anomaly=ml_anomaly_config(AnomalyConfig))


def _put_states(out, key, agg, wheel, lc, an) -> tuple:
    """The gathered states (collectives; every rank returns the same),
    recorded and returned."""
    st, ws, lst, ast = (agg.state_dict(), wheel.state_dict(),
                        lc.state_dict(), an.state_dict())
    out[f"{key}.acc"] = st["acc"]
    out[f"{key}.spill"] = (np.zeros(0, np.int64) if st["spill"] is None
                           else st["spill"])
    for t, ring in enumerate(ws["rings"]):
        out[f"{key}.ring{t}"] = ring
    out[f"{key}.la"] = lst["last_active"]
    out[f"{key}.prof"], out[f"{key}.wsum"] = ast["prof"], ast["wsum"]
    return st, ws, lst, ast


def _mr_save(out, mesh, inputs, s, path):
    """The lifecycle-drift pipeline on the saving mesh: MR_SAVED
    intervals of row s, then ``checkpoint.save`` (a collective) and the
    gathered states."""
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.utils import checkpoint

    from loghisto_tpu_torch.parallel.mesh import (
        collective_bytes,
        reset_collective_bytes,
    )

    com, agg, wheel, lc, an = _mr_pipeline(mesh)
    try:
        for i in range(MR_SAVED):
            com.commit(mr_raw(RawMetricSet, inputs, (s,), i))
        reset_collective_bytes()
        checkpoint.save(path, metric_system=_mr_host(s), aggregator=agg,
                        lifecycle=lc, anomaly=an, seq_watermark=MR_SAVED)
        out["save.sent"] = np.array(collective_bytes())
        _put_carries(out, "save", agg, wheel, lc, an)
        states = _put_states(out, "save.state", agg, wheel, lc, an)
        # the save's gathers: to rank (0, 0) alone, the same state there
        firsts = [part.state_dict(first_only=True) for part in (agg, lc, an)]
        out["save.first_only"] = np.array([st is not None for st in firsts])
        if firsts[0] is not None:
            out["save.first_same"] = np.array([
                np.array_equal(firsts[0]["acc"], states[0]["acc"]),
                firsts[0]["names"] == states[0]["names"],
                np.array_equal(firsts[1]["last_active"],
                               states[2]["last_active"]),
                np.array_equal(firsts[2]["prof"], states[3]["prof"]),
                np.array_equal(firsts[2]["wsum"], states[3]["wsum"])])
        put_metrics(out, "save.collect", agg.collect(reset=False).metrics)
    finally:
        agg.close()
    return states


def _mr_host(s):
    """A host MetricSystem holding stream row s's lifetime stores: a
    counter and a histogram recorded and folded (one collection)."""
    from loghisto_tpu_torch.metrics import MetricSystem

    ms = MetricSystem(interval=1.0, sys_stats=False)
    ms.counter("req", 3 + s)
    ms.counter(f"row{s}", 1)
    for v in (1.0 + s, 10.0, 250.0):
        ms.histogram("lat", v)
    ms.collect_raw_metrics()
    return ms


def _put_host(out, key, ms) -> None:
    with ms._store_lock:
        put_metrics(out, f"{key}.counters", {
            k: float(v) for k, v in ms._counter_store.items()})
        put_metrics(out, f"{key}.hist", {
            f"{k}.{i}": float(x) for k, e in ms._histogram_agg_store.items()
            for i, x in enumerate(e)})


def _mr_restore(out, mesh, inputs, s, key, path, grow=False):
    """A fresh pipeline on ``mesh`` and a fresh host MetricSystem restore
    ``path`` (a collective), then commit one more interval; with
    ``grow`` it holds MR_OTHERS names first and may grow to MR_GROW_MAX
    rows."""
    from loghisto_tpu_torch.metrics import MetricSystem, RawMetricSet
    from loghisto_tpu_torch.utils import checkpoint

    com, agg, wheel, lc, an = _mr_pipeline(
        mesh, max_metrics=MR_GROW_MAX if grow else None)
    host = MetricSystem(interval=1.0, sys_stats=False)
    try:
        if grow:
            for k in range(MR_OTHERS):
                agg._id_for(f"other{k}")
        out[f"{key}.watermark"] = np.array(checkpoint.restore(
            path, metric_system=host, aggregator=agg, lifecycle=lc,
            anomaly=an))
        _put_host(out, key, host)
        _put_carries(out, key, agg, wheel, lc, an)
        put_metrics(out, f"{key}.collect", agg.collect(reset=False).metrics)
        out[f"{key}.mode"] = np.array(com.commit(mr_raw(
            RawMetricSet, inputs, (s,), MR_SAVED)))
    finally:
        agg.close()


def _mr_load(out, mesh, states) -> None:
    """The saving mesh's gathered states loaded onto ``mesh``: every
    rank's blocks."""
    st, ws, lst, ast = states
    com, agg, wheel, lc, an = _mr_pipeline(mesh)
    try:
        agg.load_state_dict(st)
        wheel.load_state_dict(ws)
        lc.load_state(lst)
        an.load_state(ast)
        _put_carries(out, "load", agg, wheel, lc, an)
        put_metrics(out, "load.collect", agg.collect(reset=False).metrics)
    finally:
        agg.close()


def _mr_load_jax(out, mesh, path) -> None:
    """The JAX 2x4 pipeline's states, carried across by ``state.py``
    (``state_from_jax``, ``wheel_state_from_jax``,
    ``lifecycle_state_from_jax``, ``anomaly_state_from_jax``; pickled by
    the test process), loaded onto ``mesh``."""
    import pickle

    with open(path, "rb") as f:
        st, ws, lst, ast = pickle.load(f)
    com, agg, wheel, lc, an = _mr_pipeline(mesh)
    try:
        agg.load_state_dict(st)
        wheel.load_state_dict(ws)
        lc.load_state(lst)
        an.load_state(ast)
        _put_carries(out, "jaxstate", agg, wheel, lc, an)
        put_metrics(out, "jaxstate.collect",
                    agg.collect(reset=False).metrics)
    finally:
        agg.close()


def _mr_faults(out, mesh, rank, path) -> None:
    """``checkpoint_now`` with a fault at "checkpoint.write", then at
    "checkpoint.rename", planned on rank (0, 0) alone: every rank
    reports the failure, counts it and keeps making the same
    collectives; the previous file stays; the next checkpoint lands."""
    from loghisto_tpu_torch.resilience import FaultInjector, RecoveryManager

    com, agg, wheel, lc, an = _mr_pipeline(mesh)
    inj = FaultInjector()
    if rank == 0:
        inj.plan("checkpoint.write", on_call=2)
        inj.plan("checkpoint.rename", on_call=2)
    rec = RecoveryManager(None, aggregator=agg, committer=com, lifecycle=lc,
                          anomaly=an, checkpoint_path=path,
                          fault_injector=inj)
    try:
        got, sizes = [], []
        for k in range(4):
            rec.last_seq = k + 1
            got.append(rec.checkpoint_now())
            with open(path, "rb") as f:
                sizes.append(len(f.read()))
            if k == 0:
                with open(path, "rb") as f:
                    first = f.read()
            if k == 2:
                with open(path, "rb") as f:
                    out["faults.kept"] = np.array(f.read() == first)
        out["faults.ok"] = np.array(got)
        out["faults.counts"] = np.array([rec.checkpoints_taken,
                                         rec.checkpoint_errors,
                                         rec.last_checkpoint_seq])
        # a watermark one rank has not committed is refused everywhere
        rec.last_seq = 9 + rank
        out["faults.split_watermark"] = np.array(rec.checkpoint_now())
        out["faults.errors"] = np.array(rec.checkpoint_errors)
    finally:
        agg.close()


def _mr_system(mesh, path_ck, path_jl, recover_on_start=False):
    from loghisto_tpu_torch.anomaly import AnomalyConfig
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.lifecycle import LifecycleConfig
    from loghisto_tpu_torch.resilience import ResilienceConfig
    from loghisto_tpu_torch.system import TorchMetricSystem

    return TorchMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=MR_M,
        config=MetricConfig(bucket_limit=MR_BL), retention=MR_TIERS,
        mesh=mesh, lifecycle=ml_lifecycle_config(LifecycleConfig),
        anomaly=ml_anomaly_config(AnomalyConfig),
        resilience=ResilienceConfig(
            checkpoint_path=path_ck, journal_path=path_jl,
            checkpoint_every_intervals=MR_EVERY,
            recover_on_start=recover_on_start))


def _mr_crash(out, mesh, inputs, s, path_ck, path_jl,
              key: str = "crash") -> None:
    """TorchMetricSystem(mesh=, lifecycle=, anomaly=, resilience=) drives
    MR_CRASH intervals of row s by hand (broadcast to its subscribers:
    the row's journal and the committer's queue; one collective drain
    commits them, the cadence checkpointing at MR_EVERY), then crashes:
    no stop(), no final checkpoint, its journal closed as a killed
    process closes it."""
    import shutil

    import torch.distributed as dist

    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.parallel.mesh import (
        METRIC_AXIS,
        agreed,
        axis_index,
    )
    from loghisto_tpu_torch.utils.journal import row_journals

    ms = _mr_system(mesh, path_ck, path_jl)
    ms.recovery.start()  # the row's journal, without the reaper
    ms._update_subscribers()
    for i in range(MR_CRASH):
        with ms._subscribers_lock:
            ms._broadcast(ms._raw_subscribers,
                          mr_raw(RawMetricSet, inputs, (s,), i))
    end = time.monotonic() + 30.0
    journal = ms.recovery._journal
    while ms.committer.queued_intervals < MR_CRASH or (
            journal is not None and _lines(journal.path) < MR_CRASH):
        if time.monotonic() > end:
            raise AssertionError("the intervals were not queued and "
                                 "journaled")
        time.sleep(0.01)
    out[f"{key}.committed"] = np.array(ms.committer.drain())
    out[f"{key}.checkpoints"] = np.array(
        [ms.recovery.checkpoints_taken, ms.recovery.last_checkpoint_seq,
         ms.recovery.last_seq])
    out[f"{key}.journal"] = np.array(
        [] if journal is None else [journal.path], dtype=str)
    out[f"{key}.metric_index"] = np.array(axis_index(mesh, METRIC_AXIS))
    journal.stop() if journal is not None else None
    ms.committer.detach()
    ms.aggregator.close()
    agreed(mesh, True)  # every row's journal is whole
    files = row_journals(path_jl)
    out[f"{key}.files"] = np.array([os.path.basename(f) for _, _, f in files],
                                  dtype=str)
    if dist.get_rank() == 0:  # the files as the crash left them
        keep = os.path.join(os.path.dirname(path_ck), "crash")
        os.makedirs(keep)
        for f in [path_ck] + [f for _, _, f in files]:
            shutil.copy(f, keep)


def _lines(path) -> int:
    try:
        with open(path) as f:
            return sum(1 for line in f if line.strip())
    except OSError:
        return 0


def _mr_recover(out, mesh, inputs, s, path_ck, path_jl, saved_rows) -> None:
    """A fresh system on another mesh recovers (a collective), then takes
    MR_AFTER intervals through backfill_retention: row s those of the
    saved rows j with j % rows == s, as the replay merges them."""
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.parallel.mesh import STREAM_AXIS, axis_size

    n = axis_size(mesh, STREAM_AXIS)
    mine = [j for j in range(saved_rows) if j % n == s]
    ms = _mr_system(mesh, path_ck, path_jl)
    try:
        rep = ms.recover()
        out["recover.report"] = np.array(
            [-1 if rep.watermark is None else rep.watermark,
             rep.replayed_intervals, rep.skipped_intervals,
             int(rep.checkpoint_found), int(rep.journal_found)])
        out["recover.seq_next"] = np.array(next(ms._interval_seq))
        ms.backfill_retention([mr_raw(RawMetricSet, inputs, mine, i)
                               for i in range(MR_CRASH,
                                              MR_CRASH + MR_AFTER)])
        _put_carries(out, "recover", ms.aggregator, ms.retention,
                     ms.lifecycle, ms.anomaly)
        put_metrics(out, "recover.collect",
                    ms.aggregator.collect(reset=False).metrics)
        dump = ms.debug_dump()
        out["recover.dump"] = np.array(sorted(dump["resilience"]), dtype=str)
    finally:
        ms.stop()
    out["recover.final"] = np.array([ms.recovery.checkpoints_taken,
                                     ms.recovery.checkpoint_errors])


def _mesh_recovery_job(out, rank, arg, inputs):
    """Every scenario of one launch: the save on the first mesh of
    ``arg``, its restore onto the second and onto the first, the JAX
    mesh save onto both, the gathered states loaded onto the second, a
    restore that grows the registry, the faults, the crash on the first
    mesh and its recovery onto the second, and where the second has one
    stream row a crash on it."""
    from loghisto_tpu_torch.parallel.mesh import STREAM_AXIS, axis_index
    from loghisto_tpu_torch.parallel.mesh import make_mesh

    d = str(inputs["mr.dir"])
    (s0, m0), (s1, m1) = mr_shapes(arg)
    src = make_mesh(s0, m0, device="cpu")
    dst = make_mesh(s1, m1, device="cpu")
    a, b = axis_index(src, STREAM_AXIS), axis_index(dst, STREAM_AXIS)
    out["coord.src"] = np.array(src.get_coordinate())
    out["coord.dst"] = np.array(dst.get_coordinate())
    port = os.path.join(d, "port.npz")
    states = _mr_save(out, src, inputs, a, port)
    _mr_restore(out, dst, inputs, b, "restore", port)
    _mr_restore(out, src, inputs, a, "same", port)
    jax_file = os.path.join(d, "jax.npz")
    _mr_restore(out, dst, inputs, b, "jax", jax_file)
    _mr_restore(out, src, inputs, a, "jax_src", jax_file)
    _mr_load(out, dst, states)
    _mr_load_jax(out, dst, os.path.join(d, "jax_state.pkl"))
    _mr_restore(out, dst, inputs, b, "grow", port, grow=True)
    _mr_faults(out, dst, rank, os.path.join(d, "faults.npz"))
    path_ck, path_jl = os.path.join(d, "ck.npz"), os.path.join(d, "jl.log")
    _mr_crash(out, src, inputs, a, path_ck, path_jl)
    _mr_recover(out, dst, inputs, b, path_ck, path_jl, s0)
    if s1 == 1:
        # a crash on a mesh of one stream row, for one device to recover
        one = os.path.join(d, "onerow")
        os.makedirs(one, exist_ok=True)
        _mr_crash(out, dst, inputs, b, os.path.join(one, "ck.npz"),
                  os.path.join(one, "jl.log"), key="onerow")


# -- paged storage on a mesh (tests/test_torch_mesh_paged.py) -----------------

MP_SHAPES = ((2, 1), (1, 2), (2, 2))
MP_M = 64
MP_BL = 128
MP_POOL = 256
MP_SAT_POOL = 12  # an arena that saturates: cells spill to the host
MP_BATCH = 512  # a row's share of each global batch (the batch_size)
MP_BATCHES = 3  # global batches an interval
MP_CONSERVE = 40  # batches staged before one collect(): past the 32 bound
MP_CONSERVE_BATCH = 64
MP_STAGE_CAP = 3  # batches the stage-cap scenario's stage holds
MP_PS = (0.0, 0.5, 0.9, 0.99, 1.0)
# the committer and the system: a wide bucket axis, so codecs differ
MP_C_BL = 512
MP_C_POOL = 256
MP_C_SAT_POOL = 24
MP_C_TIERS = ((4, 1), (2, 3))
MP_C_CHUNK = 32  # cells a commit step: an interval takes several
MP_C_INTERVALS = 5
MP_FLIP_ROW = 5  # first touched in both stream rows (the codec flip)
MP_C_QUERIES = (("*", None), ("p*", 2.5), ("p5", None))
MP_STREAM_ROWS = 2  # inputs are made for up to two stream rows


def mp_names(m: int = MP_M) -> list:
    return [f"p{k}" for k in range(m)]


def mp_paged_config(cls, pool: int, **kw):
    """The committer's paged config: one dense page a row at most, a
    narrow body, so first-touch cells choose among all three codecs."""
    return cls(pool_pages=pool, dense_page_budget=1, body_halfwidth=256,
               **kw)


def mp_raw(raw_cls, rows, i, names=None):
    """Interval i holding the merged cells (name index, codec bucket,
    count) of ``rows`` ((s, cells) pairs), every name in order."""
    return mc_raw(raw_cls, rows, names or mp_names(), i)


def _put_store(out, key, st) -> None:
    """A store's arena and host half; its block's spilled cells."""
    out[f"{key}.arena"] = st._pool.cpu().numpy().copy()
    out[f"{key}.table"] = st.page_table.copy()
    out[f"{key}.codec"] = st.row_codec.copy()
    frees = st.free_lists()
    out[f"{key}.free"] = np.array([x for f in frees for x in f], np.int64)
    out[f"{key}.free_n"] = np.array([len(f) for f in frees], np.int64)
    spill = sorted((r, d, v) for (r, d), v in st._host_spill.items())
    out[f"{key}.spill"] = np.array(spill, np.int64).reshape(-1, 3)
    out[f"{key}.counters"] = np.array([
        st.allocated_pages, st.spilled_cells, st.overflowed_cells,
        st.free_pages, st.occupied_pages, st.hbm_bytes(),
        st.rows_per_shard, st.num_metrics, st.total_pages])
    out[f"{key}.occ"] = np.array(st.shard_occupancy() + [
        st.pool_saturation()])


def _mp_store(out, mesh, inputs) -> None:
    """The store on its own: the commit, a saturated arena with and
    without the overflow row, the raw route, growth and a cross-shard
    permutation, each rank's arena and host half after each."""
    from loghisto_tpu_torch.paging import PagedStore, PagedStoreConfig

    def store(m, pool, **kw):
        return PagedStore(m, MP_BL, config=PagedStoreConfig(
            pool_pages=pool, **kw), mesh=mesh)

    st = store(MP_M, MP_POOL)
    out["store.applied"] = np.array(st.commit(inputs["mp.packed"]))
    _put_store(out, "store", st)
    out["store.dense"] = st.decode_dense()
    for key, kw in (("sat", {}), ("ov", {"overflow_row": MP_M - 1})):
        st = store(MP_M, MP_SAT_POOL, **kw)
        out[f"{key}.applied"] = np.array(st.commit(inputs["mp.packed"]))
        _put_store(out, key, st)
        out[f"{key}.dense"] = st.decode_dense()
    st = store(MP_M, MP_POOL)
    for k in range(2):
        ids, spilled = st.prepare_batch(inputs[f"mp.raw.{k}.ids"],
                                        inputs[f"mp.raw.{k}.values"])
        out[f"raw.{k}.ids"], out[f"raw.{k}.spilled"] = ids, np.array(spilled)
        st.ingest_raw(torch.from_numpy(ids).to(st.device),
                      torch.from_numpy(inputs[f"mp.raw.{k}.values"]).to(
                          st.device))
    _put_store(out, "raw", st)
    st = store(32, 128)
    st.commit(inputs["mp.g.packed"])
    _put_store(out, "g0", st)
    st.grow(64)
    _put_store(out, "g1", st)
    out["g1.dense"] = st.decode_dense()
    st.commit(inputs["mp.g.packed2"])
    _put_store(out, "g2", st)
    st.apply_permutation(inputs["mp.g.perm"].tolist(), 64)
    _put_store(out, "g3", st)
    out["g3.dense"] = st.decode_dense()
    out["g3.query"] = np.concatenate([
        v.reshape(len(inputs["mp.g.perm"]), -1) for v in st.query(
            inputs["mp.g.perm"], np.array(MP_PS)).values()], axis=1)


def _mp_agg(out, mesh, inputs, s, transport) -> None:
    """TorchAggregator(mesh=, storage="paged") on the raw (K4f) or the
    sparse (K4) transport: two intervals of MP_BATCHES batches of the
    row's share, in uneven record pieces; the second (sparse) adds a
    merge_raw and a merge_packed."""
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.paging import PagedStoreConfig
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    agg = TorchAggregator(
        num_metrics=MP_M, config=MetricConfig(bucket_limit=MP_BL),
        storage="paged", paged_config=PagedStoreConfig(pool_pages=MP_POOL),
        transport=transport, batch_size=MP_BATCH, max_metrics=MP_M,
        ingest_path="fused" if transport == "raw" else "auto", mesh=mesh)
    key = f"agg.{transport}"
    try:
        for name in mp_names():
            agg.registry.id_for(name)
        for i in range(2):
            for k in range(MP_BATCHES):
                ids = inputs[f"mp.agg.{i}.{k}.{s}.ids"]
                values = inputs[f"mp.agg.{i}.{k}.{s}.values"]
                step = feed_chunk(s)
                for off in range(0, len(ids), step):
                    agg.record_batch(ids[off:off + step],
                                     values[off:off + step])
            if i and transport == "sparse":
                agg.merge_raw(raw_from_cells(inputs[f"mp.cells.{s}"],
                                             RawMetricSet, mp_names()))
                agg.merge_packed(inputs[f"mp.packed.{s}"])
            put_metrics(out, f"{key}.{i}", agg.collect(reset=not i).metrics)
            if not i:
                _put_store(out, f"{key}.{i}", agg.paged)
        out[f"{key}.path"] = np.array([agg.ingest_path, agg.transport,
                                       agg.storage])
        out[f"{key}.shed"] = np.array(agg._shed_samples)
    finally:
        agg.close()


def _mp_conserve(out, mesh, inputs, s) -> None:
    """More than 32 batches between two collect() calls: the stage holds
    them all (the F8 bound sheds only the host buffer in front of the
    worker), and every sample is counted."""
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.paging import PagedStoreConfig
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    agg = TorchAggregator(
        num_metrics=MP_M, config=MetricConfig(bucket_limit=MP_BL),
        storage="paged", paged_config=PagedStoreConfig(pool_pages=MP_POOL),
        transport="raw", ingest_path="fused", batch_size=MP_CONSERVE_BATCH,
        max_metrics=MP_M, mesh=mesh)
    try:
        for name in mp_names():
            agg.registry.id_for(name)
        ids = inputs[f"mp.cons.{s}.ids"]
        values = inputs[f"mp.cons.{s}.values"]
        for k in range(MP_CONSERVE):
            sl = slice(k * MP_CONSERVE_BATCH, (k + 1) * MP_CONSERVE_BATCH)
            agg.record_batch(ids[sl], values[sl])
            agg.wait_transfers()
        out["cons.staged"] = np.array(agg.staged_samples)
        out["cons.bound"] = np.array(agg.max_pending_samples)
        put_metrics(out, "cons", agg.collect().metrics)
        out["cons.shed"] = np.array(agg._shed_samples)
    finally:
        agg.close()


def _mp_stage_cap(out, mesh, inputs, s) -> None:
    """The stage's cap (D12): with ``max_staged_samples`` at
    MP_STAGE_CAP batches, the batch past it raises whole, the gauge and
    the watchdog see the full stage, and collect() lands every accepted
    sample, after which the stage takes batches again."""
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.metrics import MetricSystem
    from loghisto_tpu_torch.obs.health import HealthWatchdog
    from loghisto_tpu_torch.paging import PagedStoreConfig
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    class Com:
        fanout_intervals = bridge_evictions = intervals_committed = 0

    agg = TorchAggregator(
        num_metrics=MP_M, config=MetricConfig(bucket_limit=MP_BL),
        storage="paged", paged_config=PagedStoreConfig(pool_pages=MP_POOL),
        transport="raw", ingest_path="fused", batch_size=MP_CONSERVE_BATCH,
        max_metrics=MP_M, mesh=mesh)
    agg.max_staged_samples = MP_STAGE_CAP * MP_CONSERVE_BATCH
    ms = MetricSystem(interval=0.05, sys_stats=False)
    agg.register_device_gauges(ms)
    wd = HealthWatchdog(Com(), agg, interval=0.05)
    wd.note_commit(1)
    try:
        for name in mp_names():
            agg.registry.id_for(name)
        ids = inputs[f"mp.cons.{s}.ids"]
        values = inputs[f"mp.cons.{s}.values"]
        accepted, refused = 0, ""
        for k in range(MP_STAGE_CAP + 1):
            sl = slice(k * MP_CONSERVE_BATCH, (k + 1) * MP_CONSERVE_BATCH)
            try:
                agg.record_batch(ids[sl], values[sl])
            except RuntimeError as e:
                refused = str(e)
                break
            agg.wait_transfers()
            accepted += MP_CONSERVE_BATCH
        out["cap.accepted"] = np.array(accepted)
        out["cap.refused"] = np.array(refused)
        out["cap.staged"] = np.array(agg.staged_samples)
        out["cap.gauge"] = np.array(
            ms.collect_raw_metrics().gauges["tpu.MeshStagedSamples"])
        out["cap.codes"] = np.array(",".join(wd.report().reason_codes()))
        put_metrics(out, "cap", agg.collect().metrics)
        out["cap.after"] = np.array([agg.staged_samples, ",".join(
            wd.report().reason_codes())])
        agg.record_batch(ids[:MP_CONSERVE_BATCH], values[:MP_CONSERVE_BATCH])
        agg.wait_transfers()
        out["cap.again"] = np.array(agg.staged_samples)
    finally:
        agg.close()


def _mp_k4f_failure(out, mesh, inputs, s) -> None:
    """A K4f chunk that fails while the stage lands (an ``agg.ingest``
    fault on every rank's second chunk) raises from collect() on every
    rank, and nothing of the batch's rest is folded on the host."""
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.paging import PagedStoreConfig
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.resilience.faults import FaultInjector

    agg = TorchAggregator(
        num_metrics=MP_M, config=MetricConfig(bucket_limit=MP_BL),
        storage="paged", paged_config=PagedStoreConfig(pool_pages=MP_POOL),
        transport="raw", ingest_path="fused", batch_size=MP_CONSERVE_BATCH,
        max_metrics=MP_M, mesh=mesh)
    agg.fault_injector = FaultInjector().plan("agg.ingest", on_call=2)
    try:
        for name in mp_names():
            agg.registry.id_for(name)
        n = 2 * MP_CONSERVE_BATCH
        agg.record_batch(inputs[f"mp.cons.{s}.ids"][:n],
                         inputs[f"mp.cons.{s}.values"][:n])
        try:
            agg.collect()
            out["k4f.raised"] = np.array("")
        except RuntimeError as e:
            out["k4f.raised"] = np.array(str(e))
        out["k4f.host"] = np.array([agg._spilled_samples,
                                    agg.paged.spilled_cells,
                                    len(agg.paged._host_spill),
                                    agg.paged.fused_dispatches])
        out["k4f.arena"] = np.array(int(agg.paged._pool.sum()))
    finally:
        agg.close()


def _mp_pipeline(mesh, pool):
    from loghisto_tpu_torch.commit import IntervalCommitter
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.paging import PagedStoreConfig
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.window.store import TimeWheel

    cfg = MetricConfig(bucket_limit=MP_C_BL)
    agg = TorchAggregator(
        num_metrics=MP_M, config=cfg, storage="paged",
        paged_config=mp_paged_config(PagedStoreConfig, pool),
        max_metrics=MP_M, mesh=mesh)
    wheel = TimeWheel(num_metrics=MP_M, config=cfg, interval=1.0,
                      tiers=MP_C_TIERS, registry=agg.registry, mesh=mesh)
    return agg, wheel, IntervalCommitter(agg, wheel, chunk=MP_C_CHUNK)


def _mp_commit(out, mesh, inputs, s) -> None:
    """The committer and the wheel on paged storage: each rank commits
    its row's intervals, every rank lands the merged ones; then a
    saturated arena."""
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.ops.backend import (
        kernel_launches,
        reset_kernel_launches,
    )

    for key, pool in (("commit", MP_C_POOL), ("csat", MP_C_SAT_POOL)):
        agg, wheel, com = _mp_pipeline(mesh, pool)
        try:
            modes, steps = [], []
            reset_kernel_launches()
            for i in range(MP_C_INTERVALS):
                raw = mp_raw(RawMetricSet, [(s, inputs[f"mp.c.{i}.{s}"])], i)
                modes.append(com.commit(raw))
                steps.append(com.last_dispatches)
            out[f"{key}.modes"] = np.array(modes)
            out[f"{key}.steps"] = np.array(steps)
            out[f"{key}.launches"] = np.array(
                [kernel_launches()[k] for k in ("paged_scatter",
                                                "sparse_ingest")])
            _put_wheel(out, key, wheel)
            _put_store(out, key, agg.paged)
            put_metrics(out, f"{key}.collect",
                        agg.collect(reset=False).metrics)
        finally:
            agg.close()


def _mp_system(out, mesh, inputs, s) -> None:
    """TorchMetricSystem(mesh=, storage="paged", retention=): the row's
    intervals through backfill_retention, then samples recorded on the
    row that the first query lands (D12), the served queries and the
    collected set."""
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.paging import PagedStoreConfig
    from loghisto_tpu_torch.system import TorchMetricSystem

    ms = TorchMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=MP_M,
        config=MetricConfig(bucket_limit=MP_C_BL), storage="paged",
        paged_config=mp_paged_config(PagedStoreConfig, MP_C_POOL),
        retention=MP_C_TIERS, mesh=mesh)
    try:
        for name in mp_names():
            ms.metric_id(name)
        out["system.path"] = np.array([ms.commit_path,
                                       ms.aggregator.storage])
        ms.backfill_retention(
            [mp_raw(RawMetricSet, [(s, inputs[f"mp.c.{i}.{s}"])], i)
             for i in range(MP_C_INTERVALS)])
        ms.record_batch(inputs[f"mp.sys.{s}.ids"], inputs[f"mp.sys.{s}.values"])
        for q, (pattern, window) in enumerate(MP_C_QUERIES):
            _put_window(out, f"system.q{q}",
                        ms.query(pattern, window, MP_PS))
        out["system.staged"] = np.array(ms.aggregator.staged_samples)
        _put_wheel(out, "system", ms.retention)
        put_metrics(out, "system.collect",
                    ms.device_metrics(reset=False).metrics)
        _put_store(out, "system", ms.aggregator.paged)
    finally:
        ms.stop()


def _mp_health(out, mesh, inputs) -> None:
    """The watchdog names the hottest shard; the paging gauges."""
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.metrics import MetricSystem
    from loghisto_tpu_torch.obs.health import HealthWatchdog
    from loghisto_tpu_torch.paging import PagedStore, PagedStoreConfig
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    class Com:
        fanout_intervals = bridge_evictions = intervals_committed = 0

    class Agg:
        max_pending_samples = 100
        pending_samples = _xfer_queued_samples = 0
        _device_down_until = 0.0

    st = PagedStore(MP_M, MP_BL, config=PagedStoreConfig(pool_pages=128),
                    mesh=mesh)
    st.commit(inputs["mp.packed"])
    sat = st.pool_saturation()
    fake = Agg()
    fake.paged = st
    reports = []
    for frac in (min(sat + 0.01, 1.0), max(sat - 0.01, 0.0)):
        wd = HealthWatchdog(Com(), fake, interval=0.05,
                            pool_saturation_fraction=frac)
        wd.note_commit(1)
        reports.append(wd.report())
    out["health.codes"] = np.array([",".join(r.reason_codes())
                                    for r in reports])
    out["health.detail"] = np.array(
        [r["detail"] for r in reports[1].reasons
         if r["code"] == "pool_saturation"])
    st.release_rows(list(range(MP_M)))
    out["health.released"] = np.array(
        ",".join(wd.report().reason_codes()))
    ms = MetricSystem(interval=0.05, sys_stats=False)
    agg = TorchAggregator(
        num_metrics=MP_M, config=MetricConfig(bucket_limit=MP_BL),
        storage="paged", paged_config=PagedStoreConfig(pool_pages=MP_POOL),
        max_metrics=MP_M, mesh=mesh)
    agg.paged.commit(inputs["mp.g.packed"])
    agg.register_device_gauges(ms)
    gauges = ms.collect_raw_metrics().gauges
    names = sorted(g for g in gauges if g.startswith(("paging.", "tpu.Paged")))
    out["gauges.names"] = np.array(names)
    out["gauges.values"] = np.array(
        [gauges[g] for g in names if g != "paging.PageAllocRate"])
    agg.close()


def _mp_lifted(out, mesh) -> None:
    """What a paged mesh refused before ROADMAP D13 builds and
    runs: a LifecycleManager, the aggregator's state, a checkpoint's
    save, and systems with lifecycle= and resilience=; drift keeps the
    reference's dense-only refusal."""
    from loghisto_tpu_torch.anomaly import AnomalyConfig
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.lifecycle import LifecycleConfig, LifecycleManager
    from loghisto_tpu_torch.paging import PagedStoreConfig
    from loghisto_tpu_torch.resilience import ResilienceConfig
    from loghisto_tpu_torch.system import TorchMetricSystem
    from loghisto_tpu_torch.utils import checkpoint

    agg, wheel, com = _mp_pipeline(mesh, MP_C_POOL)
    with tempfile.TemporaryDirectory() as d:
        try:
            out["lifted.lifecycle"] = _raises(lambda: LifecycleManager(
                agg, wheel, LifecycleConfig()))
            states = []
            out["lifted.state"] = _raises(lambda: states.append(
                agg.state_dict()))
            out["lifted.state_storage"] = np.array(states[0]["storage"])
            out["lifted.save"] = _raises(lambda: checkpoint.save(
                os.path.join(d, "ck.npz"), aggregator=agg))
            out["lifted.saved"] = np.array(
                os.path.exists(os.path.join(d, "ck.npz")))
        finally:
            agg.close()
        kw = dict(interval=1.0, sys_stats=False, num_metrics=MP_M,
                  config=MetricConfig(bucket_limit=MP_C_BL), storage="paged",
                  paged_config=mp_paged_config(PagedStoreConfig, MP_C_POOL),
                  retention=MP_C_TIERS, mesh=mesh)
        built = []

        def system(**extra):
            ms = TorchMetricSystem(**kw, **extra)
            built.append(ms.aggregator.storage)
            ms.stop()

        out["lifted.sys_lifecycle"] = _raises(lambda: system(
            lifecycle=LifecycleConfig()))
        out["lifted.sys_resilience"] = _raises(lambda: system(
            resilience=ResilienceConfig(
                checkpoint_path=os.path.join(d, "x.npz"))))
        out["lifted.built"] = np.array(built)
        out["lifted.sys_anomaly"] = _raises(lambda: TorchMetricSystem(
            anomaly=AnomalyConfig(), **kw))


def _mp_state(out, mesh, inputs) -> None:
    """A JAX (2, 4) mesh store's state (``paged_state_from_jax``) on a
    port mesh of four metric shards: each rank loads its arena, then
    commits the same batch as the JAX store."""
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.paging import PagedStoreConfig
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.state import paged_state_from_jax

    lens = inputs["mp.js.free_n"]
    frees = np.split(inputs["mp.js.free"], np.cumsum(lens)[:-1])
    spill = {(int(r), int(d)): int(v) for r, d, v in inputs["mp.js.spill"]}
    state = paged_state_from_jax(
        inputs["mp.js.pool"], inputs["mp.js.table"], inputs["mp.js.codec"],
        spill, frees, int(inputs["mp.js.allocated"]), mp_names(), {},
        bucket_limit=MP_BL)
    agg = TorchAggregator(
        num_metrics=MP_M, config=MetricConfig(bucket_limit=MP_BL),
        storage="paged", paged_config=PagedStoreConfig(pool_pages=MP_POOL),
        max_metrics=MP_M, mesh=mesh)
    agg.load_state_dict(state)
    _put_store(out, "state.0", agg.paged)
    agg.paged.commit(inputs["mp.packed"])
    _put_store(out, "state.1", agg.paged)
    put_metrics(out, "state", agg.collect(reset=False).metrics)
    agg.close()


def _mesh_paged_job(out, rank, arg, inputs):
    from loghisto_tpu_torch.parallel.mesh import (
        STREAM_AXIS,
        axis_index,
        make_mesh,
    )

    stream, metric = map(int, arg.split("x"))
    mesh = make_mesh(stream, metric, device="cpu")
    out["coord"] = np.array(mesh.get_coordinate())
    s = axis_index(mesh, STREAM_AXIS)
    _mp_store(out, mesh, inputs)
    for transport in ("raw", "sparse"):
        _mp_agg(out, mesh, inputs, s, transport)
    _mp_conserve(out, mesh, inputs, s)
    _mp_stage_cap(out, mesh, inputs, s)
    _mp_k4f_failure(out, mesh, inputs, s)
    _mp_commit(out, mesh, inputs, s)
    _mp_system(out, mesh, inputs, s)
    _mp_health(out, mesh, inputs)
    _mp_lifted(out, mesh)
    if stream * metric == 4:
        four = make_mesh(1, 4, device="cpu")
        out["coord.four"] = np.array(four.get_coordinate())
        _mp_state(out, four, inputs)


# -- lifecycle, checkpoints and recovery on a paged mesh
#    (tests/test_torch_mesh_paged_lifecycle.py) --------------------------------

PL_SHAPES = ((2, 2), (2, 1), (1, 2))  # launched in this order (see PL_SAVER)
PL_SAVER = (2, 2)  # its launch writes the mesh save the others restore
PL_CRASHER = (2, 1)  # its launch crashes the system (1, 2) recovers
PL_M = 64
PL_MAX = 128
PL_BL = 128
PL_POOL = 256
PL_SAT_POOL = 24  # 32 rows of two pages saturate a shard's arena
PL_TIERS = ((4, 2), (3, 4))
PL_CHUNK = 32  # cells a commit step: an interval takes several
PL_NAMES = 40  # rows 0-39: both blocks of a two-way metric axis
PL_BEFORE = 3  # intervals before the eviction and the compaction
PL_AFTER = 3  # intervals after them, each with PL_FRESH fresh names
PL_FRESH = 10  # 40 - 4 + 4 + 30 names pass 64 rows: growth to 128
PL_VICTIMS = (20, 25, 33, 35)  # each its own overflow row, codec-less
PL_SHED_VICTIMS = (5, 40)  # one free row: the first folds, the second sheds
PL_CK_NAMES = 32
PL_CK_POOL = 12  # the saved store spills: the save holds spilled cells
PL_BIG = (1 << 30) - 1024  # a cell that fails a restore's headroom
PL_BIG_ROW = 40  # in the second block of a two-way metric axis
PL_SYS_TIERS = ((4, 1),)
PL_SYS_BEFORE = 4  # the system evicts and compacts after 4 intervals
PL_SYS_VICTIMS = (2, 34)
PL_SYS_CRASH = 9  # intervals before the crash
PL_SYS_EVERY = 6  # the checkpoint cadence: the watermark stands at 6
PL_SYS_AFTER = 2  # intervals after the recovery
PL_SYS_QUERIES = (("p*", None), ("p3", 2.0), ("f*", None))
PL_STREAM_ROWS = 2


def pl_names(i: int, before: int = PL_BEFORE,
             victims=PL_VICTIMS) -> list:
    """Interval i's names, in order: the PL_NAMES base names (the victims
    left out from interval ``before`` on, once evicted), then the fresh
    names of the intervals since ``before``."""
    base = [f"p{k}" for k in range(PL_NAMES)]
    if i < before:
        return base
    gone = {f"p{v}" for v in victims}
    return [n for n in base if n not in gone] + [
        f"f{j}" for j in range(PL_FRESH * (i - before + 1))]


def pl_raw(raw_cls, rows, i, names, seq=None):
    """Interval i of ``names`` holding the merged cells of ``rows`` ((s,
    cells) pairs), stamped with ``seq`` when given."""
    import dataclasses

    raw = mc_raw(raw_cls, rows, names, i)
    return raw if seq is None else dataclasses.replace(raw, seq=seq)


def _pl_pipeline(mesh, pool, max_metrics=PL_MAX):
    """A paged mesh rank's aggregator, wheel, LifecycleManager and
    committer, the JAX package's ``_run_lifecycle`` pipeline."""
    from loghisto_tpu_torch.commit import IntervalCommitter
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.lifecycle import LifecycleConfig, LifecycleManager
    from loghisto_tpu_torch.paging import PagedStoreConfig
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator
    from loghisto_tpu_torch.window.store import TimeWheel

    cfg = MetricConfig(bucket_limit=PL_BL)
    agg = TorchAggregator(
        num_metrics=PL_M, config=cfg, storage="paged",
        paged_config=PagedStoreConfig(pool_pages=pool),
        max_metrics=max_metrics, mesh=mesh)
    wheel = TimeWheel(num_metrics=PL_M, config=cfg, interval=1.0,
                      tiers=PL_TIERS, registry=agg.registry, mesh=mesh)
    lc = LifecycleManager(agg, wheel, LifecycleConfig())
    return agg, wheel, lc, IntervalCommitter(agg, wheel, lifecycle=lc,
                                             chunk=PL_CHUNK)


def _put_lc(out, key, agg, wheel, lc) -> None:
    """The rank's arena and host half, ring blocks, activity block,
    registry and the lifecycle's counters."""
    _put_store(out, key, agg.paged)
    _put_wheel(out, key, wheel)
    out[f"{key}.la"] = lc._la.cpu().numpy().copy()
    out[f"{key}.names"] = np.array(
        ["" if n is None else n for n in agg.registry.names()], dtype=str)
    out[f"{key}.lc_counters"] = np.array(
        [lc.evicted_series, lc.overflowed_samples, lc.evictions,
         lc.compactions])


def _pl_lifecycle(out, mesh, inputs, s, key, pool) -> None:
    """JAX ``tests/test_mesh_paged.py:140-171`` on a rank: PL_BEFORE
    commits, ``evict_ids`` of the victims (each folds into a new,
    codec-less overflow row, across shards on a two-way metric axis),
    ``compact()``, then PL_AFTER commits whose fresh names grow the
    registry past its rows; the carries after each step."""
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.parallel.mesh import (
        collective_bytes,
        reset_collective_bytes,
    )

    agg, wheel, lc, com = _pl_pipeline(mesh, pool)

    def land_raw(k):
        # a raw batch through the store's K4f route: the first builds the
        # K4f mirrors, the second reads them after the fold, the drop
        # and the permutation changed the table and the codecs
        st = agg.paged
        ids, _ = st.prepare_batch(inputs[f"pl.raw.{k}.ids"],
                                  inputs[f"pl.raw.{k}.values"])
        st.ingest_raw(torch.from_numpy(ids).to(st.device), torch.from_numpy(
            inputs[f"pl.raw.{k}.values"]).to(st.device))

    try:
        modes = []
        for i in range(PL_BEFORE + PL_AFTER):
            if i == 1:
                land_raw(0)
            if i == PL_BEFORE:
                reset_collective_bytes()
                moved = lc.overflowed_samples
                evicted = lc.evict_ids([agg.registry.lookup(f"p{v}")
                                        for v in PL_VICTIMS])
                out[f"{key}.evicted"] = np.array(evicted)
                out[f"{key}.moved"] = np.array(lc.overflowed_samples - moved)
                _put_lc(out, f"{key}.ev", agg, wheel, lc)
                out[f"{key}.compacted"] = np.array(lc.compact())
                out[f"{key}.sent"] = np.array(
                    [lc.last_evict_bytes, lc.last_compaction_bytes,
                     collective_bytes()])
                _put_lc(out, f"{key}.cp", agg, wheel, lc)
                land_raw(1)
            modes.append(com.commit(pl_raw(
                RawMetricSet, [(s, inputs[f"pl.{i}.{s}"])], i, pl_names(i))))
        _put_lc(out, f"{key}.end", agg, wheel, lc)
        out[f"{key}.m"] = np.array([agg.num_metrics, agg.paged.num_metrics])
        out[f"{key}.modes"] = np.array(modes)
        out[f"{key}.fanout"] = np.array(com.fanout_intervals)
        put_metrics(out, f"{key}.collect", agg.collect(reset=False).metrics)
    finally:
        agg.close()


def pl_shed_names(i: int) -> list:
    names = [f"p{k}" for k in range(PL_M - 1)]
    if i < 2:
        return names
    return [n for n in names if int(n[1:]) not in PL_SHED_VICTIMS]


def _pl_shed(out, mesh, inputs, s) -> None:
    """A registry one row short of full at its growth cap: the first
    victim's overflow row takes the free row, the second's is shed (its
    victim dropped from the arena and its spill)."""
    from loghisto_tpu_torch.metrics import RawMetricSet

    agg, wheel, lc, com = _pl_pipeline(mesh, PL_SAT_POOL, max_metrics=PL_M)
    try:
        for i in range(3):
            if i == 2:
                out["shed.evicted"] = np.array(lc.evict_ids(
                    [agg.registry.lookup(f"p{v}") for v in PL_SHED_VICTIMS]))
                _put_lc(out, "shed.ev", agg, wheel, lc)
            com.commit(pl_raw(RawMetricSet, [(s, inputs[f"pls.{i}.{s}"])],
                              i, pl_shed_names(i)))
        _put_lc(out, "shed.end", agg, wheel, lc)
    finally:
        agg.close()


def _pl_agg(mesh, pool=PL_POOL, storage="paged"):
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.paging import PagedStoreConfig
    from loghisto_tpu_torch.parallel.aggregator import TorchAggregator

    return TorchAggregator(
        num_metrics=PL_M, config=MetricConfig(bucket_limit=PL_BL),
        storage=storage, paged_config=PagedStoreConfig(pool_pages=pool),
        mesh=mesh, device="cpu")


def _put_state(out, key, st) -> None:
    """A paged aggregator state's store half."""
    pst = st["paged"]
    out[f"{key}.pool"] = pst["pool"]
    out[f"{key}.table"] = pst["page_table"]
    out[f"{key}.codec"] = pst["row_codec"]
    frees = pst.get("free_lists") or [pst["free_list"]]
    out[f"{key}.free"] = np.array([x for f in frees for x in f], np.int64)
    out[f"{key}.free_n"] = np.array([len(f) for f in frees], np.int64)
    out[f"{key}.spill"] = np.array(sorted(
        (r, d, v) for (r, d), v in pst["host_spill"].items()),
        np.int64).reshape(-1, 3)
    out[f"{key}.names"] = np.array(
        ["" if n is None else n for n in st["names"]], dtype=str)


def _pl_state(out, key, agg, mesh) -> None:
    """``state_dict`` on every rank (a collective), its ``first_only``
    form, and its ``load_state_dict`` onto a fresh aggregator on the same
    mesh."""
    st = agg.state_dict()
    _put_state(out, f"{key}.state", st)
    first = agg.state_dict(first_only=True)
    out[f"{key}.first"] = np.array(
        -1 if first is None else int(np.array_equal(
            first["paged"]["pool"], st["paged"]["pool"])))
    fresh = _pl_agg(mesh)
    try:
        fresh.load_state_dict(st)
        _put_store(out, f"{key}.load", fresh.paged)
        put_metrics(out, f"{key}.load.collect",
                    fresh.collect(reset=False).metrics)
    finally:
        fresh.close()


def _pl_save(out, mesh, inputs, path) -> None:
    """The mesh save the other launches restore: PL_CK_NAMES names and a
    packed batch into arenas that spill, its state, and ``checkpoint.save``
    (the cells to rank (0, 0) alone)."""
    from loghisto_tpu_torch.parallel.mesh import (
        collective_bytes,
        reset_collective_bytes,
    )
    from loghisto_tpu_torch.utils import checkpoint

    agg = _pl_agg(mesh, PL_CK_POOL)
    try:
        for j in range(PL_CK_NAMES):
            agg._id_for(f"h{j}")
        agg.paged.commit(inputs["pl.ck.packed"])
        _put_store(out, "cksrc", agg.paged)
        _pl_state(out, "cksrc", agg, mesh)
        reset_collective_bytes()
        checkpoint.save(path, aggregator=agg)
        out["cksrc.sent"] = np.array(collective_bytes())
    finally:
        agg.close()


def _pl_restore(out, mesh, key, path, big=False, resave=None) -> None:
    """``checkpoint.restore`` of ``path`` onto a fresh paged aggregator on
    ``mesh`` (with ``big``, one cell near 2^30 in a row of the second
    block first, so the restore's headroom check fails on the pool's
    agreed maximum); the rank's arena and host half, the decoded pool
    and the codecs after it, and with ``resave`` a save of it there."""
    from loghisto_tpu_torch.utils import checkpoint

    agg = _pl_agg(mesh)
    try:
        if big:
            agg.paged.commit(np.array([[PL_BIG_ROW, 0, PL_BIG]], np.int32))
        checkpoint.restore(path, aggregator=agg)
        _put_store(out, key, agg.paged)
        out[f"{key}.dense"] = agg.paged.decode_dense()
        out[f"{key}.codecs"] = np.array(
            ["" if c is None else c for c in agg.paged.codec_names()])
        put_metrics(out, f"{key}.collect", agg.collect(reset=False).metrics)
        if resave is not None:
            _pl_state(out, key, agg, mesh)
            checkpoint.save(resave, aggregator=agg)
    finally:
        agg.close()


def _pl_system(mesh, ck, jl):
    from loghisto_tpu_torch.config import MetricConfig
    from loghisto_tpu_torch.lifecycle import LifecycleConfig
    from loghisto_tpu_torch.paging import PagedStoreConfig
    from loghisto_tpu_torch.resilience import ResilienceConfig
    from loghisto_tpu_torch.system import TorchMetricSystem

    return TorchMetricSystem(
        interval=1.0, sys_stats=False, num_metrics=PL_M,
        config=MetricConfig(bucket_limit=PL_BL), storage="paged",
        paged_config=PagedStoreConfig(pool_pages=PL_POOL),
        retention=PL_SYS_TIERS, mesh=mesh, device=None if mesh else "cpu",
        lifecycle=LifecycleConfig(check_every=1,
                                  auto_compact_fragmentation=0.0),
        resilience=ResilienceConfig(
            checkpoint_path=ck, journal_path=jl,
            checkpoint_every_intervals=PL_SYS_EVERY,
            recover_on_start=False))


def pl_sys_raw(raw_cls, inputs, rows, i):
    """The system's interval i (seq i + 1): the merged cells of ``rows``."""
    return pl_raw(raw_cls, [(s, inputs[f"plsys.{i}.{s}"]) for s in rows], i,
                  pl_names(i, PL_SYS_BEFORE, PL_SYS_VICTIMS), seq=i + 1)


def _pl_crash(out, mesh, inputs, s, d) -> None:
    """TorchMetricSystem(mesh=, storage="paged", lifecycle=, resilience=)
    takes PL_SYS_BEFORE intervals of row s (broadcast to the row's
    journal and the committer's queue, committed by one collective
    drain), evicts and compacts by hand, takes the rest (the cadence
    checkpointing at PL_SYS_EVERY), then crashes: no stop(), no final
    checkpoint.  Rank 0 keeps the files as the crash left them in
    ``<d>/crash``."""
    import shutil

    import torch.distributed as dist

    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.parallel.mesh import agreed
    from loghisto_tpu_torch.utils.journal import row_journals

    ck, jl = os.path.join(d, "ck.npz"), os.path.join(d, "jl.log")
    ms = _pl_system(mesh, ck, jl)
    ms.recovery.start()
    ms._update_subscribers()
    journal = ms.recovery._journal

    def feed(lo, hi):
        for i in range(lo, hi):
            with ms._subscribers_lock:
                ms._broadcast(ms._raw_subscribers,
                              pl_sys_raw(RawMetricSet, inputs, (s,), i))
        end = time.monotonic() + 30.0
        while ms.committer.queued_intervals < hi - lo or (
                journal is not None and _lines(journal.path) < hi):
            if time.monotonic() > end:
                raise AssertionError("the intervals were not queued and "
                                     "journaled")
            time.sleep(0.01)
        return ms.committer.drain()

    committed = feed(0, PL_SYS_BEFORE)
    lc = ms.lifecycle
    out["crash.evicted"] = np.array(lc.evict_ids(
        [ms.aggregator.registry.lookup(f"p{v}") for v in PL_SYS_VICTIMS]))
    out["crash.compacted"] = np.array(lc.compact())
    committed += feed(PL_SYS_BEFORE, PL_SYS_CRASH)
    out["crash.committed"] = np.array(committed)
    out["crash.checkpoints"] = np.array(
        [ms.recovery.checkpoints_taken, ms.recovery.last_checkpoint_seq,
         ms.recovery.last_seq])
    journal.stop()
    ms.committer.detach()
    ms.aggregator.close()
    agreed(mesh, True)  # every row's journal is whole
    files = row_journals(jl)
    out["crash.files"] = np.array([os.path.basename(f) for _, _, f in files],
                                  dtype=str)
    if dist.get_rank() == 0:
        keep = os.path.join(d, "crash")
        os.makedirs(keep)
        for f in [ck] + [f for _, _, f in files]:
            shutil.copy(f, keep)


def pl_recovered(ms, inputs, rows, out=None, key="recover") -> None:
    """After ``recover()``: PL_SYS_AFTER more intervals of ``rows``
    through backfill_retention; with ``out``, the rank's arena and host
    half, the decoded pool, the served queries and the collected set."""
    from loghisto_tpu_torch.metrics import RawMetricSet

    ms.backfill_retention([pl_sys_raw(RawMetricSet, inputs, rows, i)
                           for i in range(PL_SYS_CRASH,
                                          PL_SYS_CRASH + PL_SYS_AFTER)])
    if out is None:
        return
    _put_store(out, key, ms.aggregator.paged)
    _put_wheel(out, key, ms.retention)
    out[f"{key}.dense"] = ms.aggregator.paged.decode_dense()
    for q, (pattern, window) in enumerate(PL_SYS_QUERIES):
        _put_window(out, f"{key}.q{q}", ms.query(pattern, window, MP_PS))
    put_metrics(out, f"{key}.collect",
                ms.device_metrics(reset=False).metrics)


def _pl_recover(out, mesh, inputs, s, d) -> None:
    """The crashed (PL_CRASHER) system's files, copied, recovered onto
    this mesh (a collective), then PL_SYS_AFTER more intervals: row s
    takes the saved rows j with j % rows == s."""
    import shutil

    import torch.distributed as dist

    from loghisto_tpu_torch.parallel.mesh import STREAM_AXIS, axis_size

    # each rank recovers from its own copy of the files
    here = os.path.join(d, f"recover{dist.get_rank()}")
    os.makedirs(here)
    for f in os.listdir(os.path.join(d, "crash")):
        shutil.copy(os.path.join(d, "crash", f), here)
    n = axis_size(mesh, STREAM_AXIS)
    mine = [j for j in range(PL_CRASHER[0]) if j % n == s]
    ms = _pl_system(mesh, os.path.join(here, "ck.npz"),
                    os.path.join(here, "jl.log"))
    try:
        rep = ms.recover()
        out["recover.report"] = np.array(
            [-1 if rep.watermark is None else rep.watermark,
             rep.replayed_intervals, rep.skipped_intervals,
             int(rep.checkpoint_found), int(rep.journal_found)])
        pl_recovered(ms, inputs, mine, out)
    finally:
        ms.recovery.checkpoint_path = None  # leave the files as they are
        ms.stop()


def _mesh_paged_lc_job(out, rank, arg, inputs):
    """Every scenario of one launch: the lifecycle pipeline with a roomy
    and a saturated arena, the shed target, the restores of the saving
    mesh's file, of a JAX (2, 4) file and of a dense file (and the
    agreed spill), and the system: the saving launch saves, the crashing
    launch crashes, the (1, 2) launch recovers."""
    from loghisto_tpu_torch.parallel.mesh import (
        STREAM_AXIS,
        axis_index,
        make_mesh,
    )

    shape = tuple(map(int, arg.split("x")))
    mesh = make_mesh(*shape, device="cpu")
    out["coord"] = np.array(mesh.get_coordinate())
    s = axis_index(mesh, STREAM_AXIS)
    d = str(inputs["pl.dir"])
    _pl_lifecycle(out, mesh, inputs, s, "lc", PL_POOL)
    _pl_lifecycle(out, mesh, inputs, s, "lcsat", PL_SAT_POOL)
    _pl_shed(out, mesh, inputs, s)
    tag = f"{shape[0]}x{shape[1]}"
    if shape == PL_SAVER:
        _pl_save(out, mesh, inputs, os.path.join(d, "port_save.npz"))
    _pl_restore(out, mesh, "ckport", os.path.join(d, "port_save.npz"),
                resave=os.path.join(d, f"port_{tag}.npz"))
    _pl_restore(out, mesh, "ckjax", os.path.join(d, "jax_save.npz"))
    _pl_restore(out, mesh, "ckdense", os.path.join(d, "dense_save.npz"))
    _pl_restore(out, mesh, "ckbig", os.path.join(d, "port_save.npz"),
                big=True)
    if shape == PL_CRASHER:
        _pl_crash(out, mesh, inputs, s, d)
    elif shape == (1, 2):
        _pl_recover(out, mesh, inputs, s, d)


# -- the locks narrowed at the mesh's entry points
#    (tests/test_torch_mesh_locks.py) ---------------------------------------------
LK_SHAPES = ((2, 1), (1, 2))
LK_INTERVALS = 3
LK_ROUNDS = 2
LK_PROBE = 512  # samples of one probe batch: one raw item a probe
LK_CELLS = 64
LK_SEED = 11
LK_WAIT_S = 30.0


def lk_cells(s: int, i: int) -> np.ndarray:
    """Interval i's cells (name index, codec bucket, count) of stream row
    s: the same on every rank of the row."""
    rng = np.random.default_rng((LK_SEED, s, i))
    return np.stack([rng.integers(0, ML_DRIFT_NAMES, LK_CELLS),
                     rng.integers(-50, 200, LK_CELLS),
                     rng.integers(1, 6, LK_CELLS)], axis=1)


def _lk_narrowed(out, mesh, s) -> None:
    """The entry points whose collectives left their locks, driven while
    the transfer worker records: each collective they make first records
    one probe batch on this thread and waits (on the worker's counters,
    LK_WAIT_S) until the worker has folded it into the accumulator under
    ``_dev_lock``, which only returns in time if the entry point does not
    hold that lock across the collective.  Then every count: the probes'
    row, each state's snapshot of it (taken before the probes of its own
    collectives), and the committed names'."""
    import torch.distributed as dist

    import loghisto_tpu_torch.anomaly.manager as an_mod
    import loghisto_tpu_torch.lifecycle.manager as lc_mod
    import loghisto_tpu_torch.parallel.aggregator as agg_mod
    import loghisto_tpu_torch.window.store as wheel_mod
    from loghisto_tpu_torch.anomaly import AnomalyConfig
    from loghisto_tpu_torch.lifecycle import LifecycleConfig
    from loghisto_tpu_torch.metrics import RawMetricSet
    from loghisto_tpu_torch.parallel.mesh import STREAM_AXIS, axis_size

    n_stream = axis_size(mesh, STREAM_AXIS)
    com, agg, wheel, lc, an = _ml_pipeline(
        mesh, ML_DRIFT_M, ML_DRIFT_TIERS, batch_size=LK_PROBE,
        lifecycle=LifecycleConfig(ttl_intervals=100, check_every=1,
                                  auto_compact_fragmentation=0.0),
        anomaly=ml_anomaly_config(AnomalyConfig))
    names = ml_drift_names()
    probe_id = agg.registry.id_for("probe")
    armed, applied = [False], []

    def probe():
        if not armed[0]:
            return
        agg.record_batch(np.full(LK_PROBE, probe_id, dtype=np.int32),
                         np.linspace(1.0, 50.0, LK_PROBE, dtype=np.float32))
        agg.flush()
        ok = agg.wait_transfers(LK_WAIT_S)
        applied.append(ok)
        armed[0] = ok  # a held lock fails once, not at every collective

    patched = []
    for mod, name in ((agg_mod, "reduce_parts"), (agg_mod, "host_gather"),
                      (lc_mod, "gather_parts"), (lc_mod, "host_gather"),
                      (an_mod, "host_gather"), (wheel_mod, "gather_parts"),
                      (wheel_mod, "host_gather")):
        real = getattr(mod, name)

        def wrapped(*a, _real=real, **kw):
            probe()
            return _real(*a, **kw)

        setattr(mod, name, wrapped)
        patched.append((mod, name, real))
    try:
        for i in range(LK_INTERVALS):
            com.commit(mc_raw(RawMetricSet, [(s, lk_cells(s, i))], names,
                              i))
        snaps = []
        for _ in range(LK_ROUNDS):
            before = len(applied)
            armed[0] = True
            st = agg.state_dict()
            lc.check()
            la = lc.state_dict()["last_active"]
            banks = an.state_dict()
            ws = wheel.state_dict()
            res = wheel._query_recompute("*", 1.0, (0.5,), 0)
            armed[0] = False
            snaps.append([int(st["acc"][probe_id].sum()),
                          before * LK_PROBE * n_stream])
            if len(la) < len(names) or banks["prof"].shape[1] < len(names):
                raise AssertionError("a state lost rows")
            if len(ws["rings"]) != len(ML_DRIFT_TIERS):
                raise AssertionError("the wheel's state lost a tier")
            if sorted(res.metrics) != sorted(names):
                raise AssertionError(f"recompute served {sorted(res.metrics)}")
        dist.barrier()
        m = agg.collect(reset=False).metrics
    finally:
        for mod, name, real in patched:
            setattr(mod, name, real)
        agg.close()
    want = np.zeros(len(names), dtype=np.int64)
    for i in range(LK_INTERVALS):
        for row in range(n_stream):
            cells = lk_cells(row, i)
            np.add.at(want, cells[:, 0], cells[:, 2])
    out["lk.applied"] = np.array(applied)
    out["lk.probe"] = np.array([m.get("probe_count", 0.0),
                                len(applied) * LK_PROBE * n_stream])
    out["lk.snaps"] = np.array(snaps, dtype=np.int64)
    out["lk.counts"] = np.array([[m.get(f"{n}_count", 0.0), w]
                                 for n, w in zip(names, want)])


def _mesh_locks_job(out, rank, arg, inputs):
    from loghisto_tpu_torch.parallel.mesh import (
        STREAM_AXIS,
        axis_index,
        make_mesh,
    )

    stream, metric = map(int, arg.split("x"))
    mesh = make_mesh(stream, metric, device="cpu")
    out["coord"] = np.array(mesh.get_coordinate())
    _lk_narrowed(out, mesh, axis_index(mesh, STREAM_AXIS))


def _programs_job(out, rank, arg, inputs):
    """Every mesh entry of the program registry
    (``analysis/program_audit.py``) on this rank of the (2, 2) mesh: its
    findings, collective census and payload dtypes, wrapper entries,
    output shapes, and outputs."""
    import json

    from loghisto_tpu_torch.analysis import program_audit as pa

    results = pa.mesh_rank_results(pa.mesh_names())
    out["coord"] = np.array(pa.coordinate())
    for name, r in results.items():
        out[f"{name}.report"] = np.array(json.dumps(
            {k: v for k, v in r.items() if k != "outputs"}))
        for i, a in enumerate(r["outputs"]):
            out[f"{name}.out{i}"] = a


JOBS = {
    "card": _card_job,
    "mesh": _mesh_job,
    "multihost": _multihost_job,
    "firehose": _firehose_job,
    "sketches": _sketches_job,
    "mesh_commit": _mesh_commit_job,
    "mesh_lifecycle": _mesh_lifecycle_job,
    "mesh_recovery": _mesh_recovery_job,
    "mesh_paged": _mesh_paged_job,
    "mesh_paged_lc": _mesh_paged_lc_job,
    "mesh_locks": _mesh_locks_job,
    "selftest": _selftest_job,
    "programs": _programs_job,
}




def test_a_failed_rank_ends_the_launch_with_its_traceback(tmp_path):
    import pytest

    t0 = time.monotonic()
    with pytest.raises(AssertionError, match="boom from rank 1") as info:
        launch(tmp_path, 2, "selftest:raise")
    assert "Traceback" in str(info.value)
    assert time.monotonic() - t0 < 60.0  # rank 0's barrier was not awaited


def test_the_deadline_kills_every_rank(tmp_path):
    import pytest

    with pytest.raises(AssertionError, match="killed at the deadline"):
        launch(tmp_path, 2, "selftest:hang", deadline=3.0)


def test_ranks_return_in_order_and_collectives_stay_on_the_main_thread(
        tmp_path):
    res = launch(tmp_path, 2, "selftest:worker")
    assert [int(r["rank"]) for r in res] == [0, 1]
    for r in res:
        assert "barrier on thread not-main" in str(r["err"])
