"""Multi-host distributed aggregation over ``torch.distributed``
(counterpart of ``loghisto_tpu/parallel/multihost.py``).

Histogram merge is an elementwise add, which an ``all_reduce`` performs
the same within a host (NVLink) and across hosts once the process group
is up.  One process drives one device (ROADMAP D8, ``parallel/mesh.py``),
so this module provides the thin host-side pieces:

  * ``initialize(...)`` wraps ``init_process_group``: NCCL for "cuda",
    gloo for "cpu", or the backend the caller names.  A failure raises;
    it never retries on another backend.  After it,
    ``parallel.mesh.make_mesh()`` gives the global ("stream", "metric")
    mesh and the steps of ``parallel.aggregator`` run unchanged.
  * ``local_sample_shard(...)`` carves this rank's stream row out of a
    global batch axis.  The ranks of one stream row receive the SAME
    slice: samples are sharded over stream and replicated over metric.
  * ``global_put`` / ``host_gather`` move a host array to this rank's
    part (``mesh.RankPart``) and the parts back to one host array.

There is no RPC layer: the submitter is one-way export, and every
peer-to-peer transfer is a collective.  Collectives run only at the
collective entry points (``collect()``, a step factory's ``collect``),
which every rank calls in the same order.
"""

from __future__ import annotations

import datetime as _dt
from typing import Optional

import numpy as np
import torch

from loghisto_tpu_torch.parallel.mesh import (  # noqa: F401 - re-exported
    STREAM_AXIS,
    RankPart,
    axis_index,
    axis_size,
    check_mesh,
    global_put,
    host_gather,
    make_mesh,
    mesh_device,
    mesh_reduce,
)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
    timeout_s: Optional[float] = None,
) -> None:
    """Bring up the process group.

    ``coordinator_address`` is "host:port" (a TCP rendezvous), any
    ``init_method`` URL ("tcp://host:port", "file:///path" for a
    ``FileStore``), or None for the launcher's environment (``env://``,
    as torchrun sets it).  ``device`` is "cuda" (the default: NCCL, and
    the card ``process_id % device_count`` becomes the current one) or
    "cpu" (gloo).  ``backend`` overrides the backend ("gloo" for several
    ranks on one card, which NCCL refuses)."""
    import torch.distributed as dist

    from loghisto_tpu_torch.ops.backend import resolve_device

    dev = resolve_device(device)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = _dt.timedelta(seconds=timeout_s)
    if dev.type == "cuda" and process_id is not None:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method, world_size=num_processes or -1,
        rank=-1 if process_id is None else process_id, **kwargs,
    )
    if dev.type == "cuda" and process_id is None:
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def shutdown() -> None:
    """Destroy the process group (and every mesh group with it), if one
    is up."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(metric: int = 1, device=None):
    """The global ("stream", "metric") mesh over every rank.  Call after
    initialize()."""
    return make_mesh(metric=metric, device=device)


def local_sample_shard(global_batch: int, mesh=None) -> tuple[int, int]:
    """(start, size) of this rank's slice of a ``global_batch``-sized
    sample axis: its stream row's contiguous share.  Without a mesh every
    rank is its own stream row (the stream-only mesh); that needs no
    collective."""
    import torch.distributed as dist

    if mesh is None:
        n_stream, row = dist.get_world_size(), dist.get_rank()
    else:
        check_mesh(mesh)
        n_stream = axis_size(mesh, STREAM_AXIS)
        row = axis_index(mesh, STREAM_AXIS)
    if global_batch % n_stream:
        raise ValueError(
            f"global_batch={global_batch} not divisible by the stream "
            f"axis ({n_stream})"
        )
    size = global_batch // n_stream
    return row * size, size


def make_global_arrays(mesh, ids_local, values_local):
    """This rank's sample arrays on its device, from its stream row's
    local shard: each host supplies only its own samples and no host
    holds the global batch.  With one device per rank the "global array"
    a step reads on this rank IS the local shard (replicated over
    metric).  Every rank must pass a shard of the same size: checked
    with one small collective."""
    import torch.distributed as dist

    check_mesh(mesh)
    ids_local = np.asarray(ids_local, dtype=np.int32)
    values_local = np.asarray(values_local, dtype=np.float32)
    if ids_local.shape != values_local.shape or ids_local.ndim != 1:
        raise ValueError("ids and values must be 1-D and of one shape")
    n_local = ids_local.shape[0]
    most, least = mesh_reduce(mesh, [n_local, -n_local], dist.ReduceOp.MAX)
    if most != n_local or -least != n_local:
        raise ValueError(
            f"local shard has {n_local} samples but the ranks' shards span "
            f"[{-least}, {most}] (equal per-process shards required)"
        )
    dev = mesh_device(mesh)
    return (torch.from_numpy(ids_local).to(dev),
            torch.from_numpy(values_local).to(dev))
