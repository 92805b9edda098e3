"""Program contract auditor of the port (counterpart of
``loghisto_tpu/analysis/jaxpr_audit.py``): one declarative registry
mapping every device step of the port to its contract, checked by
running the step once at a small seeded geometry under a recorder.

The reference traces each compiled program to a jaxpr and reads its
equations.  The port has no program to trace: its steps run eagerly, a
sequence of launches on the current stream.  So each entry's
``build(device)`` returns the step and its operands, and the audit calls
the step once while two hooks record it:

  * a ``TorchDispatchMode`` sees every aten op, its operands and its
    outputs (shapes, dtypes, devices);
  * ``ops/backend.set_entry_observer`` sees every entry to a kernel's
    wrapper (its ``is_plain`` call), on either device: on the card the
    entry launches the kernel, on the CPU it takes the plain version;
  * on a mesh, the ``torch.distributed`` functions that
    ``parallel/mesh.py`` reaches are wrapped for the span of the step.

A ``Contract`` pins, per step, each field exactly (``None`` disables a
check, for ad-hoc audits only; every registry entry declares them all):

  * ``launches``      — wrapper entries per kernel in one call of the
                        step (the reference's ``pallas_calls``); on the
                        card, ``kernel_launches()`` must move by the
                        same counts
  * ``in_place``      — operand tensors returned as the same tensor
                        (same storage pointer, shape and dtype; the
                        reference's ``donated``).  A carry that comes
                        back as a new tensor is a "dropped in-place
                        update": the carry double-buffers.  The repacks
                        (``compact``, ``bank_compact``, K6) return fresh
                        tensors by design and pin 0
  * ``collectives``   — ``torch.distributed`` calls per step by (op,
                        mesh axis of their group) (the reference's
                        ``stream_psums``); integer payloads must be
                        int32
  * ``int32_scatter_shapes`` — every scatter or index-add op
                        (``index_put_``, ``index_add_``, ``scatter_add_``,
                        ``scatter_reduce_``) whose output, or the tensor
                        the output views, has a listed carry shape must
                        be int32 (integer adds commute, float adds do
                        not)
  * ``forbidden_shapes`` — no op output of these shapes (the paged routes
                        pin the dense ``[PM, B]`` and the shard-local
                        ``[PM / n_metric, B]``)

plus the global rule that replaces the reference's "host-callback": no
op that synchronises the host with a card may run inside a step
(``_local_scalar_dense`` — ``.item()``, ``int(t)``, ``bool(t)`` —
``nonzero``, ``masked_select``, ``unique``, ``bincount``, boolean-mask
indexing, and on the card a blocking copy between host and device).  A
wrapper's plain version runs only on CPU tensors, so its ops are exempt
from this rule (they never run on the card); on the card the stronger
check is ``torch.cuda.set_sync_debug_mode("error")`` around a warm call
(``chip_smoke.py`` phase ``analysis``), which also sees the blocking
uploads that no dispatch mode sees.

The reference's ``dispatches`` has no counterpart: eager PyTorch has no
one-program budget.  ``census`` reports each step's aten op counts, but
nothing pins them: torch versions decompose ops differently.

The reference's ``constant_findings`` (Pallas float32 in-tile partial
sums exact below 2^24) becomes the int32 bound: every kernel of the port
keeps integer partials (K2's shared-memory histograms among them), so
``constant_findings`` checks that the most samples one K2 call can add
into one block's int32 partial (``ops/row_ingest.MAX_SAMPLES_PER_CALL``,
which the wrappers enforce; ``SAMPLE_TILE`` is below it) stays under
2^31.

Mesh entries (``sharded_*``) run on a (2, 2) gloo mesh of four fresh
interpreters (``run_mesh``: a ``FileStore`` in a temporary directory, a
120 s deadline; rank 0 reports), never in the calling process.  This
module imports torch only inside its functions, so the analyzer keeps
loading without torch; ``analysis/__init__.py`` does not import it.

``assert_contract(name)`` is the per-test entry point; ``audit_all()``
feeds the CLI gate's ``programs`` pass.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import importlib
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional, Sequence

from loghisto_tpu_torch.analysis import REPO_ROOT, Finding, relpath

PASS = "programs"
STREAM_AXIS = "stream"   # parallel/mesh.py's axes (that module imports torch)
METRIC_AXIS = "metric"

# Integer partials are exact while a partial's population stays under
# 2^31 (the int32 bound the reference's float32 tile rule becomes).
INT32_EXACT_BOUND = 1 << 31

MESH_DEADLINE_S = 120.0


@dataclasses.dataclass(frozen=True)
class Contract:
    """Contract of one step.  ``None`` disables a check (ad-hoc audits
    only: every registry entry declares every field)."""

    launches: Optional[dict] = None          # {kernel: wrapper entries}
    in_place: Optional[int] = None
    collectives: Optional[dict] = None       # {(op, axis): calls}
    int32_scatter_shapes: Optional[tuple] = None
    forbidden_shapes: Optional[tuple] = None
    description: str = ""


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    name: str
    factory: str       # the port's factory or wrapper, for the docs table
    build: Callable    # (device) -> (step, args tuple)
    contract: Contract
    reference: tuple = ()   # the JAX programs (jaxpr_audit names) it answers
    mesh: bool = False      # runs on the (2, 2) mesh ranks


# ---------------------------------------------------------------------- #
# the recorder
# ---------------------------------------------------------------------- #

# aten ops (overload packet names) that read a device value on the host
SYNC_OPS = frozenset((
    "_local_scalar_dense", "item", "is_nonzero", "equal", "nonzero",
    "argwhere", "masked_select", "_unique", "_unique2", "unique_dim",
    "unique_consecutive", "unique_dim_consecutive", "bincount",
    "repeat_interleave",
))
SCATTER_OPS = ("index_put", "_index_put_impl", "index_add",
               "scatter_add", "scatter_reduce")
# the torch.distributed functions parallel/mesh.py reaches, and their
# kin; (name, index of the payload tensor argument, or None for objects)
COLLECTIVES = {
    "all_reduce": 0, "reduce": 0, "broadcast": 0, "all_gather": 1,
    "gather": 0, "scatter": 0, "reduce_scatter": 0,
    "all_gather_into_tensor": 1, "reduce_scatter_tensor": 1,
    "all_to_all_single": 1, "all_to_all": 1, "all_gather_object": None,
    "gather_object": None, "broadcast_object_list": None, "barrier": None,
}


class _Recording:
    def __init__(self):
        self.ops = collections.Counter()          # op name -> calls
        self.outputs = []                         # (op, shape, dtype, base shape)
        self.entries = collections.Counter()      # kernel -> wrapper entries
        self.collectives = collections.Counter()  # (op, axis) -> calls
        self.payloads = []                        # (op, axis, dtype)
        self.syncs = []                           # op names
        self.plain_frames = {}                    # id -> frame (kept alive)
        self.launched = {}

    def in_plain(self) -> bool:
        """Whether the op being recorded runs inside a wrapper's plain
        version (a frame of the stack is one that took it)."""
        frame = sys._getframe(2)
        while frame is not None:
            if id(frame) in self.plain_frames:
                return True
            frame = frame.f_back
        return False


def tensor_leaves(obj):
    """The tensors of a step's operands or outputs (nested tuples,
    lists and dicts), in order."""
    import torch

    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tensor_leaves(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from tensor_leaves(v)


def _is_sync(name, args, kwargs, out) -> bool:
    import torch

    if name in SYNC_OPS:
        return True
    if name in ("index", "index_put", "index_put_", "_index_put_impl_"):
        indices = args[1] if len(args) > 1 else kwargs.get("indices", ())
        return any(isinstance(t, torch.Tensor)
                   and t.dtype in (torch.bool, torch.uint8)
                   for t in (indices or ()))
    if name in ("_to_copy", "copy_"):
        # a blocking copy between the host and a card
        devs = {t.device.type for t in (*tensor_leaves(args),
                                        *tensor_leaves(out))}
        blocking = not kwargs.get("non_blocking", False) and not (
            name == "copy_" and len(args) > 2 and args[2])
        return "cuda" in devs and "cpu" in devs and blocking
    return False


def _mode(rec: _Recording):
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func.overloadpacket.__name__
            rec.ops[name] += 1
            for t in tensor_leaves(out):
                base = t._base if t._base is not None else t
                rec.outputs.append((name, tuple(t.shape), t.dtype,
                                    tuple(base.shape)))
            if _is_sync(name, args, kwargs, out) and not rec.in_plain():
                rec.syncs.append(name)
            return out

    return _Mode()


def _axis_of(group) -> str:
    mesh = _MESH.get("mesh")
    if group is None or mesh is None:
        return "world"
    for axis in (STREAM_AXIS, METRIC_AXIS):
        if mesh.get_group(axis) is group:
            return axis
    return "other"


def _wrap_collectives(rec: _Recording):
    """Wrap the torch.distributed functions; returns the undo."""
    import torch.distributed as dist

    saved = {}
    for op, arg in COLLECTIVES.items():
        fn = getattr(dist, op, None)
        if fn is None:
            continue
        saved[op] = fn

        def wrapped(*a, _fn=fn, _op=op, _arg=arg, **kw):
            axis = _axis_of(kw.get("group"))
            rec.collectives[(_op, axis)] += 1
            if _arg is not None and len(a) > _arg:
                for t in tensor_leaves(a[_arg]):
                    rec.payloads.append((_op, axis, t.dtype))
            return _fn(*a, **kw)

        setattr(dist, op, wrapped)

    def undo():
        for op, fn in saved.items():
            setattr(dist, op, fn)

    return undo


def record(step, args, kwargs=None):
    """Run ``step(*args, **kwargs)`` once under the recorder; returns
    (outputs, recording, the operands' (data_ptr, shape, dtype) before
    the call)."""
    import torch
    import torch.distributed as dist

    from loghisto_tpu_torch.ops import backend

    rec = _Recording()
    before = [(t.data_ptr(), tuple(t.shape), t.dtype)
              for t in tensor_leaves(args) if t.numel()]

    def observe(kernel, plain, frame):
        rec.entries[kernel] += 1
        if plain:
            rec.plain_frames[id(frame)] = frame

    launched = backend.kernel_launches()
    previous = backend.set_entry_observer(observe)
    undo = (_wrap_collectives(rec) if dist.is_available()
            and dist.is_initialized() else (lambda: None))
    try:
        with _mode(rec):
            out = step(*args, **(kwargs or {}))
        if any(t.is_cuda for t in tensor_leaves(out)):
            torch.cuda.synchronize()
    finally:
        undo()
        backend.set_entry_observer(previous)
        rec.plain_frames.clear()
    after = backend.kernel_launches()
    rec.launched = {k: after[k] - launched[k] for k in after
                    if after[k] != launched[k]}
    return out, rec, before


def _nonzero(counts) -> dict:
    return {k: v for k, v in dict(counts).items() if v}


def check(out, rec: _Recording, before, contract: Contract, name: str,
          path: str = "", line: int = 0, device: str = "cpu"
          ) -> list[Finding]:
    """Hold one recorded call against its contract; returns findings
    (empty = the contract holds)."""
    import torch

    def finding(detail, reason):
        return Finding(PASS, path, line, name, detail, reason)

    found: list[Finding] = []

    # -- kernel wrapper entries (the reference's pallas_call census) --
    if contract.launches is not None:
        want, got = _nonzero(contract.launches), _nonzero(rec.entries)
        for kernel in sorted(set(want) | set(got)):
            if want.get(kernel, 0) != got.get(kernel, 0):
                found.append(finding(
                    f"launch-count:{kernel}",
                    f"contract pins {want.get(kernel, 0)} entr"
                    f"{'y' if want.get(kernel, 0) == 1 else 'ies'} to "
                    f"{kernel}'s wrapper a call, the step made "
                    f"{got.get(kernel, 0)}",
                ))
    if device == "cuda":
        for kernel in sorted(set(rec.launched) | set(_nonzero(rec.entries))):
            if rec.launched.get(kernel, 0) != rec.entries.get(kernel, 0):
                found.append(finding(
                    f"launch-entry-mismatch:{kernel}",
                    f"{kernel}: {rec.entries.get(kernel, 0)} wrapper "
                    f"entries on the card but {rec.launched.get(kernel, 0)}"
                    " kernel launches",
                ))

    # -- in-place carries (the reference's donation-alias) --
    if contract.in_place is not None:
        outs = [(t.data_ptr(), tuple(t.shape), t.dtype)
                for t in tensor_leaves(out) if t.numel()]
        kept, unmatched = 0, []
        pool = list(outs)
        for sig in before:
            if sig in pool:
                pool.remove(sig)   # each output answers one operand
                kept += 1
            else:
                unmatched.append(sig)
        if kept < contract.in_place:
            fresh = sorted({
                f"{list(s)}:{str(d).replace('torch.', '')}"
                for _, s, d in pool
                if any((s, d) == (us, ud) for _, us, ud in unmatched)
            })
            found.append(finding(
                "in-place-dropped",
                f"contract pins {contract.in_place} carr"
                f"{'y' if contract.in_place == 1 else 'ies'} updated in "
                f"place, the step returned {kept} of its operands; new "
                f"tensors in a carry's shape: {fresh or 'none'} — a dropped "
                "in-place update, the carry double-buffers",
            ))
        elif kept > contract.in_place:
            found.append(finding(
                "in-place-count",
                f"contract pins {contract.in_place} carries updated in "
                f"place, the step returned {kept} of its operands",
            ))

    # -- collectives per step (the reference's stream psums) --
    if contract.collectives is not None:
        want = _nonzero(contract.collectives)
        got = _nonzero(rec.collectives)
        for key in sorted(set(want) | set(got)):
            if want.get(key, 0) != got.get(key, 0):
                found.append(finding(
                    f"collective-count:{key[0]}:{key[1]}",
                    f"contract pins {want.get(key, 0)} {key[0]} over "
                    f"{key[1]} a step, the step made {got.get(key, 0)}",
                ))
    bad = sorted({(op, str(dt).replace("torch.", ""))
                  for op, _, dt in rec.payloads
                  if not dt.is_floating_point and not dt.is_complex
                  and dt not in (torch.int32, torch.bool)})
    for op, dt in bad:
        found.append(finding(
            f"collective-dtype:{op}",
            f"{op} moves an {dt} payload; integer collectives must be "
            "int32 for bit-identity with the one-device path",
        ))

    # -- int32 accumulation on the declared carry shapes --
    carries = set(contract.int32_scatter_shapes or ())
    hit = set()
    for op, shape, dtype, base in rec.outputs:
        if not op.startswith(SCATTER_OPS):
            continue
        if (shape in carries or base in carries) and dtype != torch.int32:
            key = (op, base if base in carries else shape, dtype)
            if key in hit:
                continue
            hit.add(key)
            found.append(finding(
                "scatter-dtype",
                f"`{op}` into carry shape {key[1]} is "
                f"{str(dtype).replace('torch.', '')}; the accumulation "
                "contract requires int32 (integer adds commute, float "
                "adds do not)",
            ))

    # -- forbidden intermediates (dense [M, B] on a paged route) --
    forbidden = set(contract.forbidden_shapes or ())
    seen = set()
    for op, shape, _, _ in rec.outputs:
        if shape in forbidden and shape not in seen:
            seen.add(shape)
            found.append(finding(
                "forbidden-shape",
                f"forbidden dense intermediate {shape} materialized by "
                f"`{op}` — the paged route must never build an [M, B] "
                "tensor",
            ))

    # -- no host sync inside a step (the reference's host-callback) --
    for op in sorted(set(rec.syncs)):
        found.append(finding(
            f"host-sync:{op}",
            f"`{op}` synchronises the host with the card inside the step "
            f"({rec.syncs.count(op)} call(s)) — every audited step must "
            "queue its work without waiting on the device",
        ))
    return found


# ---------------------------------------------------------------------- #
# geometry and seeded operands
# ---------------------------------------------------------------------- #
#
# The reference's trace geometry (jaxpr_audit.py:304-321): dense rows
# M = 32, buckets B = 129, tier rings of 3 slots and 32 / 16 rows, a
# batch of N = 256; paged rows PM = 40 and the shard-local PM / 2 = 20
# collide with no other dimension, so forbidding (40, 129) / (20, 129)
# pins "no dense [M, B] on the paged route" without false positives.
# The mesh is (2, 2), so n_metric = 2 keeps the shard-local (20, 129).
# On a mesh every tier has the wheel's rows (ops/commit.py
# ``_sharded_fold`` maps one block layout onto every ring), so the mesh
# entries' rings have 32 (dense) and 24 (paged) rows in both tiers.
# Operands come from a seeded generator, not zeros: a dropped scatter
# changes an output.

BL = 64
B = 2 * BL + 1            # 129
M = 32
N = 256
TIERS = 2
RING_ROWS = (32, 16)
SLOTS = 3
VIEWS = 1
PM = 40                   # paged metric rows
PPR = 2                   # page-table pages per row
POOL_PAGES = 48
PAGE = 256                # ops/paged_store.PAGE_SIZE
PAGED_RING_ROWS = (24, 16)
BANKS = 2
MESH_SHAPE = (2, 2)       # (stream, metric)
SEED = 20261019
DROP_ID = 2**30           # ops/commit.DROP_ID
EPOCH = 12

_DENSE_CARRIES = ((M, B), (SLOTS, RING_ROWS[0], B), (SLOTS, RING_ROWS[1], B))
_POOL_CARRY = ((POOL_PAGES, PAGE),)
_NO_DENSE_MB = ((PM, B), (PM // MESH_SHAPE[1], B))


def _rng():
    import numpy as np

    return np.random.default_rng(SEED)


def _cells(rng, rows: int, n: int = N):
    """(ids, dense bucket, count) int32 [n] each: ids in [0, rows) with
    one in eight a DROP_ID pad."""
    import numpy as np

    ids = rng.integers(0, rows, n).astype(np.int32)
    ids[rng.random(n) < 0.125] = DROP_ID
    idx = rng.integers(0, B, n).astype(np.int32)
    w = rng.integers(1, 10, n).astype(np.int32)
    return ids, idx, w


def _perm(rng, rows: int):
    """A survivor permutation ``perm[new] = old``: a sorted subset of
    the rows packed to the front, holes (-1) after."""
    import numpy as np

    keep = np.sort(rng.choice(rows, rows * 5 // 8, replace=False))
    perm = np.full(rows, -1, dtype=np.int32)
    perm[:len(keep)] = keep
    return perm


def _evictions(rng, rows: int):
    """Victims and their overflow targets [4] (the last a DROP_ID pad):
    three distinct victims, targets drawn from two rows that are never
    victims."""
    import numpy as np

    order = rng.permutation(rows)
    victims = np.full(4, DROP_ID, dtype=np.int32)
    targets = np.full(4, DROP_ID, dtype=np.int32)
    victims[:3] = order[2:5]
    targets[:3] = rng.choice(order[:2], 3)
    return victims, targets


def _masks(rng):
    import numpy as np

    masks = []
    for _ in range(TIERS):
        m = rng.random((VIEWS, SLOTS)) < 0.6
        m[:, 0] = True
        masks.append(m)
    return tuple(masks)


def dense_whole(ring_rows=RING_ROWS) -> dict:
    """The dense entries' seeded operands, whole, as host NumPy arrays
    (the mesh entries cut each rank's blocks from these)."""
    import numpy as np

    rng = _rng()
    ids, idx, w = _cells(rng, M)
    acc = rng.integers(0, 6, (M, B)).astype(np.int32)
    snap = np.cumsum(rng.integers(0, 6, (M, B)), axis=1).astype(np.int32)
    snap[3] = 0   # an empty row
    prof = rng.random((BANKS, M, B)).astype(np.float32)
    wsum = rng.uniform(0.5, 1.0, (BANKS, M)).astype(np.float32)
    wsum[:, 5] = 0.0   # rows with no baseline
    prof /= prof.sum(axis=2, keepdims=True) / wsum[:, :, None].clip(1e-3)
    victims, targets = _evictions(rng, M)
    return {
        "acc": acc,
        "rings": tuple(rng.integers(0, 6, (SLOTS, r, B)).astype(np.int32)
                       for r in ring_rows),
        "last_active": rng.integers(0, 10, M).astype(np.int32),
        "ihist": rng.integers(0, 6, (M, B)).astype(np.int32),
        "ids": ids, "idx": idx, "w": w,
        "packed": np.stack([ids, idx - BL, w], axis=1).astype(np.int32),
        "slots": (1, 2), "keeps": (1, 0),
        "masks": _masks(rng),
        "prof": prof, "wsum": wsum, "bank": 1, "decay": 0.5,
        "min_count": 10,
        "cdf": snap, "counts": snap[:, -1].copy(),
        "sums": rng.uniform(0, 1e4, M).astype(np.float32),
        "query_ids": rng.integers(0, M, 8).astype(np.int32),
        "gids": rng.integers(0, 4, 8).astype(np.int32),
        "ps": np.array([0.5, 0.9, 0.99], dtype=np.float32),
        "raw_ids": np.where(rng.random(N) < 0.06, M + 1,
                            rng.integers(0, M, N)).astype(np.int32),
        "values": (rng.lognormal(2.0, 2.0, N)
                   * np.where(rng.random(N) < 0.2, -1, 1)
                   ).astype(np.float32),
        "victims": victims, "targets": targets,
        "perm": _perm(rng, M),
        "written": tuple([0, 1, 2] for _ in range(TIERS)),
        "min_samples": 10,
    }


def paged_whole(ring_rows=PAGED_RING_ROWS) -> dict:
    """The paged entries' seeded operands, whole, as host NumPy arrays.
    Pool slots that are an arena's zero page on the (2, 2) mesh (0 and
    POOL_PAGES / 2) stay zero and are never addressed, and each row's
    pages lie in its metric shard's arena, so a rank's cut is the same
    storage."""
    import numpy as np

    rng = _rng()
    arena = POOL_PAGES // MESH_SHAPE[1]
    block = PM // MESH_SHAPE[1]
    pool = rng.integers(0, 4, (POOL_PAGES, PAGE)).astype(np.int32)
    pool[::arena] = 0
    live = [s for s in range(POOL_PAGES) if s % arena]
    tri = np.zeros((N, 3), dtype=np.int32)
    tri[:, 0] = rng.choice(live, N)
    tri[rng.random(N) < 0.1, 0] = -1          # pads drop
    tri[:, 1] = rng.integers(0, PAGE, N)
    tri[:4, 1] = (-3, PAGE, PAGE + 7, -1)     # offsets clip
    tri[:, 2] = rng.integers(1, 10, N)
    ids, idx, w = _cells(rng, ring_rows[0])
    table = np.zeros((PM, PPR), dtype=np.int32)
    for r in range(PM):
        lo = (r // block) * arena
        table[r] = lo + rng.choice(np.arange(1, arena), PPR, replace=False)
    table[rng.random((PM, PPR)) < 0.1] = -1   # unmapped pages
    row_codec = rng.integers(0, 3, PM).astype(np.int32)
    row_codec[rng.random(PM) < 0.1] = -1      # no codec yet
    dense = np.arange(B, dtype=np.int32)
    enc_luts = np.stack([dense, dense + 200, 2 * dense + 100]).astype(
        np.int32)
    victims, targets = _evictions(rng, PM)
    return {
        "pool": pool, "triples": tri,
        "rings": tuple(rng.integers(0, 6, (SLOTS, r, B)).astype(np.int32)
                       for r in ring_rows),
        "last_active": rng.integers(0, 10, PM).astype(np.int32),
        "ids": ids, "idx": idx, "w": w,
        "packed": np.stack([ids, idx - BL, w], axis=1).astype(np.int32),
        "slots": (2, 0), "keeps": (0, 1),
        "masks": _masks(rng),
        "raw_ids": np.where(rng.random(N) < 0.06, PM + 3,
                            rng.integers(0, PM, N)).astype(np.int32),
        "values": rng.lognormal(2.0, 1.5, N).astype(np.float32),
        "row_codec": row_codec, "enc_luts": enc_luts, "table": table,
        "query_rows": table[rng.integers(0, PM, 5)],
        "dec_lut": rng.permutation(B).astype(np.int32),
        "ps": np.array([0.5, 0.9, 0.99], dtype=np.float32),
        "victims": victims, "targets": targets,
        "perm": _perm(rng, PM),
        "written": tuple([0, 1, 2] for _ in range(TIERS)),
    }


def _on(device):
    import numpy as np
    import torch

    def put(x):
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    return put


# ---------------------------------------------------------------------- #
# the registry's builders: build(device) -> (step, args)
# ---------------------------------------------------------------------- #


def _dense_commit(device, full: bool, snapshot: bool):
    from loghisto_tpu_torch.ops import commit

    d, t = dense_whole(), _on(device)
    acc, rings = t(d["acc"]), tuple(t(r) for r in d["rings"])
    if snapshot:
        step = commit.make_fused_commit_snapshot_fn(
            TIERS, BL, track_activity=full, track_baseline=full)
    else:
        step = commit.make_fused_commit_fn(TIERS, BL, track_activity=full,
                                           track_baseline=full)
    args = [acc, rings]
    if full:
        args += [t(d["last_active"]), t(d["ihist"])]
        if snapshot:
            args.append((t(d["prof"]), t(d["wsum"])))
    args += [d["slots"], d["keeps"], t(d["packed"])]
    if full:
        args.append(EPOCH)
    if snapshot:
        args.append(d["masks"])
        if full:
            args += [0, d["bank"], d["decay"], d["min_count"]]
    elif full:
        args.append(1)
    return step, tuple(args)


def _paged_commit_step(device, snapshot: bool):
    from loghisto_tpu_torch.ops import commit

    d, t = paged_whole(), _on(device)
    step = (commit.make_paged_fused_commit_snapshot_fn(TIERS, BL) if snapshot
            else commit.make_paged_fused_commit_fn(TIERS, BL))
    args = [t(d["pool"]), tuple(t(r) for r in d["rings"]), d["slots"],
            d["keeps"], t(d["packed"]), t(d["triples"])]
    if snapshot:
        args.append(d["masks"])
    return step, tuple(args)


def _build_fused_ingest(device):
    from loghisto_tpu_torch.ops.fused_ingest import make_fused_ingest_fn

    d, t = dense_whole(), _on(device)
    step = make_fused_ingest_fn(BL, device=device)
    return step, (t(d["acc"]), t(d["raw_ids"]), t(d["values"]))


def _paged_ingest_step(bucket_limit):
    from loghisto_tpu_torch.ops.fused_ingest import fused_paged_ingest_batch

    def ingest(pool, ids, values, row_codec, enc_luts, page_table):
        return fused_paged_ingest_batch(pool, ids, values, row_codec,
                                        enc_luts, page_table, bucket_limit)

    return ingest


def _build_fused_paged_ingest(device):
    d, t = paged_whole(), _on(device)
    return _paged_ingest_step(BL), (
        t(d["pool"]), t(d["raw_ids"]), t(d["values"]), t(d["row_codec"]),
        t(d["enc_luts"]), t(d["table"].T))


def _build_sparse_ingest(device):
    from loghisto_tpu_torch.ops.sparse_ingest import make_sparse_ingest_fn

    d, t = dense_whole(), _on(device)
    return make_sparse_ingest_fn(BL, device=device), (t(d["acc"]),
                                                     t(d["packed"]))


def _build_paged_commit(device):
    from loghisto_tpu_torch.ops.paged_store import paged_scatter

    d, t = paged_whole(), _on(device)
    return paged_scatter, (t(d["pool"]), t(d["triples"]))


def _paged_query_step(bucket_limit):
    from loghisto_tpu_torch.ops.paged_store import paged_query

    def query(pool, table_rows, dec_lut, ps):
        return paged_query(pool, table_rows, dec_lut, ps, bucket_limit)

    return query


def _build_paged_query(device):
    d, t = paged_whole(), _on(device)
    # host rows and LUT, as PagedStore.query passes them
    return _paged_query_step(BL), (t(d["pool"]), d["query_rows"],
                                   d["dec_lut"], d["ps"])


def _build_snapshot_query(device):
    from loghisto_tpu_torch.ops.stats import make_snapshot_query_fn

    d, t = dense_whole(), _on(device)
    return make_snapshot_query_fn(BL), (
        t(d["cdf"]), t(d["counts"]), t(d["sums"]), d["query_ids"], d["ps"])


def _build_group_query(device):
    from loghisto_tpu_torch.ops.stats import make_group_query_fn

    d, t = dense_whole(), _on(device)
    fn = make_group_query_fn(BL)

    def group_query(*a):
        return fn(*a, num_groups=4)

    return group_query, (t(d["cdf"]), t(d["counts"]), t(d["sums"]),
                         d["query_ids"], d["gids"], d["ps"])


def _build_fold_evict(device):
    from loghisto_tpu_torch.ops.lifecycle import make_fold_evict_fn

    d, t = dense_whole(), _on(device)
    return make_fold_evict_fn(TIERS), (
        t(d["acc"]), tuple(t(r) for r in d["rings"]), t(d["last_active"]),
        d["victims"], d["targets"], EPOCH)


def _build_fold_evict_paged(device):
    from loghisto_tpu_torch.ops.lifecycle import make_fold_evict_fn

    d, t = paged_whole(), _on(device)
    return make_fold_evict_fn(TIERS, with_acc=False), (
        tuple(t(r) for r in d["rings"]), t(d["last_active"]), d["victims"],
        d["targets"], EPOCH)


def _build_compact(device):
    from loghisto_tpu_torch.ops.lifecycle import make_compact_fn

    d, t = dense_whole(), _on(device)
    return make_compact_fn(TIERS), (
        t(d["acc"]), [t(r) for r in d["rings"]], t(d["last_active"]),
        d["perm"], EPOCH)


def _build_divergence(device):
    from loghisto_tpu_torch.ops.anomaly import make_divergence_fn

    d, t = dense_whole(), _on(device)
    return make_divergence_fn(), (
        t(d["cdf"]), t(d["counts"]), t(d["prof"]), t(d["wsum"]), d["bank"],
        d["min_samples"])


def _build_bank_evict(device):
    from loghisto_tpu_torch.ops.anomaly import make_bank_evict_fn

    d, t = dense_whole(), _on(device)
    return make_bank_evict_fn(), (t(d["prof"]), t(d["wsum"]), t(d["ihist"]),
                                  d["victims"])


def _build_bank_compact(device):
    from loghisto_tpu_torch.ops.anomaly import make_bank_compact_fn

    d, t = dense_whole(), _on(device)
    return make_bank_compact_fn(), (t(d["prof"]), t(d["wsum"]),
                                    t(d["ihist"]), d["perm"])


# -- mesh entries: the rank's cut of the whole operands ------------------ #

_MESH: dict = {}


class AuditEnvironmentError(RuntimeError):
    pass


def _mesh():
    """The (2, 2) mesh of the initialised process group (on the CPU)."""
    if "mesh" not in _MESH:
        import torch.distributed as dist

        need = MESH_SHAPE[0] * MESH_SHAPE[1]
        if not dist.is_available() or not dist.is_initialized() \
                or dist.get_world_size() != need:
            raise AuditEnvironmentError(
                f"the mesh entries run on a {MESH_SHAPE} mesh of {need} "
                "ranks (``run_mesh`` launches them); no such process group "
                "here")
        from loghisto_tpu_torch.parallel.mesh import make_mesh

        _MESH["mesh"] = make_mesh(*MESH_SHAPE, device="cpu")
    return _MESH["mesh"]


def coordinate() -> tuple:
    """This rank's (stream, metric) coordinate on the audit mesh."""
    from loghisto_tpu_torch.parallel.mesh import axis_index

    mesh = _mesh()
    return axis_index(mesh, STREAM_AXIS), axis_index(mesh, METRIC_AXIS)


def _rows(x, lo: int, n: int, dim: int = 0):
    import numpy as np

    return np.ascontiguousarray(np.take(x, np.arange(lo, lo + n), axis=dim))


def _local_ids(ids, lo: int, n: int):
    """Global ids in the block [lo, lo + n) shifted to [0, n), others
    -1 (dropped)."""
    import numpy as np

    return np.where((ids >= lo) & (ids < lo + n), ids - lo,
                    -1).astype(np.int32)


def _dense_mesh(device, snapshot: bool):
    import numpy as np

    from loghisto_tpu_torch.ops import commit

    mesh = _mesh()
    s, m = coordinate()
    d, t = dense_whole((M, M)), _on(device)
    rows, share = M // MESH_SHAPE[1], N // MESH_SHAPE[0]
    acc = _rows(d["acc"], m * rows, rows)
    if s:
        acc = np.zeros_like(acc)   # the stream rows' partials sum to it
    rings = tuple(t(_rows(r, m * rows, rows, 1)) for r in d["rings"])
    packed = d["packed"][s * share:(s + 1) * share]
    if snapshot:
        step = commit.make_sharded_fused_commit_snapshot_fn(mesh, TIERS, BL)
        return step, (t(acc), rings, d["slots"], d["keeps"], t(packed),
                      d["masks"])
    step = commit.make_sharded_fused_commit_fn(mesh, TIERS, BL)
    return step, (t(acc), rings, d["slots"], d["keeps"], t(packed))


def _paged_cut():
    """The rank's cut of the paged operands (ROADMAP D12): its arena of
    the pool with the triples re-based to it, its ring blocks with the
    chunk's ids made block-local, its block of the page table, codecs
    and raw ids."""
    import numpy as np

    _, m = coordinate()
    d = paged_whole((PAGED_RING_ROWS[0],) * TIERS)
    arena, block = POOL_PAGES // MESH_SHAPE[1], PM // MESH_SHAPE[1]
    ring_rows = PAGED_RING_ROWS[0] // MESH_SHAPE[1]
    tri = d["triples"].copy()
    mine = (tri[:, 0] >= m * arena) & (tri[:, 0] < (m + 1) * arena)
    tri[:, 0] = np.where(mine, tri[:, 0] - m * arena, -1)
    packed = d["packed"].copy()
    packed[:, 0] = _local_ids(packed[:, 0], m * ring_rows, ring_rows)
    table = _rows(d["table"], m * block, block)
    return {
        "pool": _rows(d["pool"], m * arena, arena), "triples": tri,
        "rings": tuple(_rows(r, m * ring_rows, ring_rows, 1)
                       for r in d["rings"]),
        "packed": packed, "slots": d["slots"], "keeps": d["keeps"],
        "masks": d["masks"],
        "raw_ids": _local_ids(d["raw_ids"], m * block, block),
        "values": d["values"],
        "row_codec": _rows(d["row_codec"], m * block, block),
        "enc_luts": d["enc_luts"],
        "table": np.where(table > 0, table - m * arena, -1).astype(np.int32),
    }


def _paged_mesh_commit(device, snapshot: bool):
    from loghisto_tpu_torch.ops import commit

    c, t = _paged_cut(), _on(device)
    step = (commit.make_paged_fused_commit_snapshot_fn(TIERS, BL) if snapshot
            else commit.make_paged_fused_commit_fn(TIERS, BL))
    args = [t(c["pool"]), tuple(t(r) for r in c["rings"]), c["slots"],
            c["keeps"], t(c["packed"]), t(c["triples"])]
    if snapshot:
        args.append(c["masks"])
    return step, tuple(args)


def _build_sharded_fused_paged_ingest(device):
    c, t = _paged_cut(), _on(device)
    return _paged_ingest_step(BL), (
        t(c["pool"]), t(c["raw_ids"]), t(c["values"]), t(c["row_codec"]),
        t(c["enc_luts"]), t(c["table"].T))


def _build_sharded_paged_commit(device):
    from loghisto_tpu_torch.ops.paged_store import paged_scatter

    c, t = _paged_cut(), _on(device)
    return paged_scatter, (t(c["pool"]), t(c["triples"]))


def _dense_blocks(device):
    """The rank's blocks of the dense lifecycle and drift carries: the
    accumulator (stream index 0 holds the rows, the other stream rows a
    zero partial), the rings, the activity, the banks and ``ihist``."""
    import numpy as np

    s, m = coordinate()
    d, t = dense_whole((M, M)), _on(device)
    rows = M // MESH_SHAPE[1]
    lo = m * rows
    acc = _rows(d["acc"], lo, rows)
    return d, {
        "acc": t(acc if s == 0 else np.zeros_like(acc)),
        "rings": [t(_rows(r, lo, rows, 1)) for r in d["rings"]],
        "last_active": t(_rows(d["last_active"], lo, rows)),
        "prof": t(_rows(d["prof"], lo, rows, 1)),
        "wsum": t(_rows(d["wsum"], lo, rows, 1)),
        "ihist": t(_rows(d["ihist"], lo, rows)),
        "cdf": t(_rows(d["cdf"], lo, rows)),
        "counts": t(_rows(d["counts"], lo, rows)),
    }


def _build_sharded_fold_evict(device):
    from loghisto_tpu_torch.ops.lifecycle import make_sharded_fold_evict_fn

    d, b = _dense_blocks(device)
    return make_sharded_fold_evict_fn(_mesh(), TIERS), (
        b["acc"], tuple(b["rings"]), b["last_active"], d["victims"],
        d["targets"], EPOCH)


def _paged_blocks(device):
    """The rank's ring blocks and activity block of the paged carries."""
    _, m = coordinate()
    d, t = paged_whole((PAGED_RING_ROWS[0],) * TIERS), _on(device)
    ring_rows = PAGED_RING_ROWS[0] // MESH_SHAPE[1]
    block = PM // MESH_SHAPE[1]
    return d, [t(_rows(r, m * ring_rows, ring_rows, 1))
               for r in d["rings"]], t(_rows(d["last_active"], m * block,
                                             block))


def _build_sharded_fold_evict_paged(device):
    from loghisto_tpu_torch.ops.lifecycle import make_sharded_fold_evict_fn

    d, rings, la = _paged_blocks(device)
    return make_sharded_fold_evict_fn(_mesh(), TIERS, with_acc=False), (
        tuple(rings), la, d["victims"], d["targets"], EPOCH)


def _build_sharded_compact(device):
    from loghisto_tpu_torch.ops.lifecycle import make_sharded_compact_fn

    d, b = _dense_blocks(device)
    return make_sharded_compact_fn(_mesh(), TIERS), (
        b["acc"], b["rings"], b["last_active"], d["perm"], EPOCH,
        d["written"])


def _build_sharded_compact_paged(device):
    from loghisto_tpu_torch.ops.lifecycle import make_sharded_compact_fn

    d, rings, la = _paged_blocks(device)
    return make_sharded_compact_fn(_mesh(), TIERS, with_acc=False), (
        rings, la, d["perm"], EPOCH, d["written"])


def _build_sharded_divergence(device):
    from loghisto_tpu_torch.ops.anomaly import make_sharded_divergence_fn

    d, b = _dense_blocks(device)
    return make_sharded_divergence_fn(_mesh()), (
        b["cdf"], b["counts"], b["prof"], b["wsum"], d["bank"],
        d["min_samples"])


def _build_sharded_bank_compact(device):
    from loghisto_tpu_torch.ops.anomaly import make_sharded_bank_compact_fn

    d, b = _dense_blocks(device)
    return make_sharded_bank_compact_fn(_mesh()), (
        b["prof"], b["wsum"], b["ihist"], d["perm"])


# ---------------------------------------------------------------------- #
# the registry
# ---------------------------------------------------------------------- #


def _spec(name, factory, build, reference, *, launches, in_place,
          collectives=None, int32_scatter_shapes=(), forbidden_shapes=(),
          description, mesh=False):
    return ProgramSpec(
        name, factory, build,
        Contract(launches=dict(launches), in_place=in_place,
                 collectives=dict(collectives or {}),
                 int32_scatter_shapes=tuple(int32_scatter_shapes),
                 forbidden_shapes=tuple(forbidden_shapes),
                 description=description),
        tuple(reference), mesh)


K1, K3, K4, K4F = ("fused_ingest", "sparse_ingest", "paged_scatter",
                   "fused_paged_ingest")
K5, K6, K7 = "window_merge", "compact_rows", "divergence"
_GATHER_STREAM = {("all_gather", STREAM_AXIS): 1}
_MESH_RING = (SLOTS, M // MESH_SHAPE[1], B)

PROGRAMS: tuple[ProgramSpec, ...] = (
    # -- fused commit, dense carries ---------------------------------- #
    _spec("fused_commit", "ops.commit.make_fused_commit_fn",
          functools.partial(_dense_commit, full=False, snapshot=False),
          ("fused_commit",), launches={K3: 1}, in_place=3,
          int32_scatter_shapes=_DENSE_CARRIES,
          description="chunk commit: the wrap clear, then one K3 into the "
                      "accumulator and every tier's open slot"),
    _spec("fused_commit_full", "ops.commit.make_fused_commit_fn[act,base]",
          functools.partial(_dense_commit, full=True, snapshot=False),
          ("fused_commit_full",), launches={K3: 1}, in_place=5,
          int32_scatter_shapes=_DENSE_CARRIES,
          description="commit + ihist in the same K3 + the activity "
                      "stamp (scatter_reduce amax)"),
    _spec("fused_commit_snapshot",
          "ops.commit.make_fused_commit_snapshot_fn",
          functools.partial(_dense_commit, full=False, snapshot=True),
          ("fused_commit_snapshot",), launches={K3: 1, K5: TIERS},
          in_place=3, int32_scatter_shapes=_DENSE_CARRIES,
          description="final-chunk commit + one K5 a tier for every view "
                      "+ dense_cdf of the accumulator, fresh payloads"),
    _spec("fused_commit_snapshot_full",
          "ops.commit.make_fused_commit_snapshot_fn[act,base]",
          functools.partial(_dense_commit, full=True, snapshot=True),
          ("fused_commit_snapshot_full",), launches={K3: 1, K5: TIERS},
          in_place=7, int32_scatter_shapes=_DENSE_CARRIES,
          description="final chunk + activity + the EWMA bank update "
                      "in place"),
    # -- fused commit, paged pool carries ----------------------------- #
    _spec("paged_fused_commit", "ops.commit.make_paged_fused_commit_fn",
          functools.partial(_paged_commit_step, snapshot=False),
          ("paged_fused_commit",), launches={K4: 1, K3: 1}, in_place=3,
          int32_scatter_shapes=_POOL_CARRY, forbidden_shapes=_NO_DENSE_MB,
          description="K4 of the translated triples into the pool, one K3 "
                      "into every tier's open slot"),
    _spec("paged_fused_commit_snapshot",
          "ops.commit.make_paged_fused_commit_snapshot_fn",
          functools.partial(_paged_commit_step, snapshot=True),
          ("paged_fused_commit_snapshot",),
          launches={K4: 1, K3: 1, K5: TIERS}, in_place=3,
          int32_scatter_shapes=_POOL_CARRY, forbidden_shapes=_NO_DENSE_MB,
          description="paged final-chunk commit + one K5 a tier; no "
                      "accumulator payload"),
    # -- ingest ------------------------------------------------------- #
    _spec("fused_ingest", "ops.fused_ingest.make_fused_ingest_fn",
          _build_fused_ingest, ("fused_ingest",), launches={K1: 1},
          in_place=1, int32_scatter_shapes=((M, B),),
          description="codec and scatter of the raw batch in one K1"),
    _spec("fused_paged_ingest",
          "ops.fused_ingest.fused_paged_ingest_batch",
          _build_fused_paged_ingest, ("fused_paged_ingest",),
          launches={K4F: 1}, in_place=1, int32_scatter_shapes=_POOL_CARRY,
          forbidden_shapes=_NO_DENSE_MB,
          description="codec, encode, translate and scatter straight into "
                      "the pool in one K4f"),
    _spec("sparse_ingest", "ops.sparse_ingest.make_sparse_ingest_fn",
          _build_sparse_ingest,
          ("sparse_ingest_jnp", "sparse_ingest_pallas"), launches={K3: 1},
          in_place=1, int32_scatter_shapes=((M, B),),
          description="packed [n, 3] sparse merge, one K3 (the device "
                      "picks the route, D4)"),
    # -- paged storage ------------------------------------------------ #
    _spec("paged_commit", "ops.paged_store.paged_scatter",
          _build_paged_commit, ("paged_commit_jnp", "paged_commit_pallas"),
          launches={K4: 1}, in_place=1, int32_scatter_shapes=_POOL_CARRY,
          forbidden_shapes=_NO_DENSE_MB,
          description="translated-triple pool commit, one K4"),
    _spec("paged_query", "ops.paged_store.paged_query", _build_paged_query,
          ("paged_query",), launches={}, in_place=0,
          forbidden_shapes=_NO_DENSE_MB,
          description="page gather + codec decode + row stats; dense only "
                      "in the requested [n, B] rows, never [PM, B]"),
    # -- query engine ------------------------------------------------- #
    _spec("snapshot_query", "ops.stats.make_snapshot_query_fn",
          _build_snapshot_query, ("snapshot_query",), launches={},
          in_place=0,
          description="row gather + percentile selection over the "
                      "snapshot payload, which nothing writes"),
    _spec("group_query", "ops.stats.make_group_query_fn",
          _build_group_query, ("group_query",), launches={}, in_place=0,
          int32_scatter_shapes=((4, B),),
          description="int32 index_add_ of the matched CDF rows per "
                      "group + row stats"),
    # -- lifecycle ---------------------------------------------------- #
    _spec("fold_evict", "ops.lifecycle.make_fold_evict_fn",
          _build_fold_evict, ("fold_evict",), launches={}, in_place=4,
          int32_scatter_shapes=_DENSE_CARRIES,
          description="victims' rows added to their overflow rows and "
                      "zeroed in every carry, the activity stamped"),
    _spec("fold_evict_paged", "ops.lifecycle.make_fold_evict_fn[paged]",
          _build_fold_evict_paged, ("fold_evict_paged",), launches={},
          in_place=3, forbidden_shapes=_NO_DENSE_MB,
          description="ring-only fold (the pool folds on the host)"),
    _spec("compact", "ops.lifecycle.make_compact_fn", _build_compact,
          ("compact",), launches={K6: 1 + TIERS}, in_place=0,
          description="survivor-permutation repack: K6 over the "
                      "accumulator and each ring, out of place by design "
                      "(fresh tensors, each old ring released in turn)"),
    # -- drift engine ------------------------------------------------- #
    _spec("divergence", "ops.anomaly.make_divergence_fn",
          _build_divergence, ("divergence",), launches={K7: 1}, in_place=0,
          description="KS/JSD/EMD against bank rows read in place, one "
                      "K7; nothing written"),
    _spec("bank_evict", "ops.anomaly.make_bank_evict_fn",
          _build_bank_evict, ("bank_evict",), launches={}, in_place=3,
          description="victims' baselines and interval rows zeroed in "
                      "place"),
    _spec("bank_compact", "ops.anomaly.make_bank_compact_fn",
          _build_bank_compact, ("bank_compact",), launches={K6: 3},
          in_place=0,
          description="survivor permutation over the bank carries, K6 "
                      "each, out of place by design (fresh tensors)"),
    # -- the mesh (2, 2): D9, D10, D12, D13 ----------------------------- #
    _spec("sharded_fused_commit",
          "ops.commit.make_sharded_fused_commit_fn",
          functools.partial(_dense_mesh, snapshot=False),
          ("sharded_fused_commit",), launches={K3: 2}, in_place=3,
          collectives=_GATHER_STREAM,
          int32_scatter_shapes=((M // 2, B), _MESH_RING),
          description="one int32 all_gather of the chunk's triples over "
                      "stream (D9), K3 of the share into the acc block, K3 "
                      "of the chunk into the ring blocks", mesh=True),
    _spec("sharded_fused_commit_snapshot",
          "ops.commit.make_sharded_fused_commit_snapshot_fn",
          functools.partial(_dense_mesh, snapshot=True),
          ("sharded_fused_commit_snapshot",), launches={K3: 2, K5: TIERS},
          in_place=3, collectives=_GATHER_STREAM,
          int32_scatter_shapes=((M // 2, B), _MESH_RING),
          description="the mesh final chunk + K5 over each ring block",
          mesh=True),
    _spec("sharded_paged_fused_commit",
          "ops.commit.make_paged_fused_commit_fn[rank cut]",
          functools.partial(_paged_mesh_commit, snapshot=False),
          ("sharded_paged_fused_commit",), launches={K4: 1, K3: 1},
          in_place=3, collectives={},
          int32_scatter_shapes=((POOL_PAGES // 2, PAGE),),
          forbidden_shapes=_NO_DENSE_MB,
          description="the one-card paged step on the rank's arena and "
                      "ring blocks: no collective, a chunk is global "
                      "already (D12)", mesh=True),
    _spec("sharded_paged_fused_commit_snapshot",
          "ops.commit.make_paged_fused_commit_snapshot_fn[rank cut]",
          functools.partial(_paged_mesh_commit, snapshot=True),
          ("sharded_paged_fused_commit_snapshot",),
          launches={K4: 1, K3: 1, K5: TIERS}, in_place=3, collectives={},
          int32_scatter_shapes=((POOL_PAGES // 2, PAGE),),
          forbidden_shapes=_NO_DENSE_MB,
          description="the paged final chunk on the rank's cut (D12)",
          mesh=True),
    _spec("sharded_fused_paged_ingest",
          "ops.fused_ingest.fused_paged_ingest_batch[rank cut]",
          _build_sharded_fused_paged_ingest,
          ("sharded_fused_paged_ingest",), launches={K4F: 1}, in_place=1,
          collectives={}, int32_scatter_shapes=((POOL_PAGES // 2, PAGE),),
          forbidden_shapes=_NO_DENSE_MB,
          description="K4f into the rank's arena; the stage's gathers run "
                      "in land_staged, not here (D12)", mesh=True),
    _spec("sharded_paged_commit", "ops.paged_store.paged_scatter[rank cut]",
          _build_sharded_paged_commit, ("sharded_paged_commit",),
          launches={K4: 1}, in_place=1, collectives={},
          int32_scatter_shapes=((POOL_PAGES // 2, PAGE),),
          forbidden_shapes=_NO_DENSE_MB,
          description="K4 of the arena's re-based triples (D12)",
          mesh=True),
    _spec("sharded_fold_evict", "ops.lifecycle.make_sharded_fold_evict_fn",
          _build_sharded_fold_evict, ("fold_evict",), launches={},
          in_place=4,
          collectives={("all_to_all_single", METRIC_AXIS): 1 + TIERS,
                       ("all_reduce", STREAM_AXIS): 1,
                       ("all_reduce", METRIC_AXIS): 1},
          int32_scatter_shapes=((M // 2, B), _MESH_RING),
          description="fold_rows: one all_to_all of the metric line a "
                      "carry with crossing pairs, then the moved total's "
                      "SUM over the mesh (D10)", mesh=True),
    _spec("sharded_fold_evict_paged",
          "ops.lifecycle.make_sharded_fold_evict_fn[paged]",
          _build_sharded_fold_evict_paged, ("fold_evict_paged",),
          launches={}, in_place=3,
          collectives={("all_to_all_single", METRIC_AXIS): TIERS},
          forbidden_shapes=_NO_DENSE_MB,
          description="the ring blocks' fold, one all_to_all a ring "
                      "(D13)", mesh=True),
    _spec("sharded_compact", "ops.lifecycle.make_sharded_compact_fn",
          _build_sharded_compact, ("compact",), launches={K6: 1 + TIERS},
          in_place=0,
          collectives={("all_to_all_single", METRIC_AXIS): 2 + TIERS},
          description="RowMove: K6 on the rows a rank keeps, one "
                      "all_to_all a carry for the crossing rows (D10); out "
                      "of place by design", mesh=True),
    _spec("sharded_compact_paged",
          "ops.lifecycle.make_sharded_compact_fn[paged]",
          _build_sharded_compact_paged, ("compact",), launches={K6: TIERS},
          in_place=0,
          collectives={("all_to_all_single", METRIC_AXIS): 1 + TIERS},
          forbidden_shapes=_NO_DENSE_MB,
          description="the ring blocks and the activity block moved "
                      "(D13); out of place by design", mesh=True),
    _spec("sharded_divergence", "ops.anomaly.make_sharded_divergence_fn",
          _build_sharded_divergence, ("divergence",), launches={K7: 1},
          in_place=0, collectives={("all_gather", METRIC_AXIS): 1},
          description="K7 on the rank's view block, one float32 gather of "
                      "the scores over metric (D10)", mesh=True),
    _spec("sharded_bank_compact",
          "ops.anomaly.make_sharded_bank_compact_fn",
          _build_sharded_bank_compact, ("bank_compact",), launches={K6: 3},
          in_place=0,
          collectives={("all_to_all_single", METRIC_AXIS): 3},
          description="RowMove over the bank blocks, K6 each (D10); out "
                      "of place by design", mesh=True),
)

_BY_NAME = {spec.name: spec for spec in PROGRAMS}

def program_names() -> tuple:
    return tuple(spec.name for spec in PROGRAMS)


def get_spec(name: str) -> ProgramSpec:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise KeyError(
            f"unknown audited program {name!r}; registered: "
            f"{', '.join(sorted(_BY_NAME))}"
        ) from None


def factory_origin(factory: str) -> tuple[str, int]:
    """(repo-relative path, line) of a registry factory string such as
    ``ops.commit.make_fused_commit_fn[act,base]``."""
    dotted = factory.split("[", 1)[0]
    module, _, attr = dotted.rpartition(".")
    try:
        mod = importlib.import_module(f"loghisto_tpu_torch.{module}")
        fn = getattr(mod, attr)
        return relpath(inspect.getsourcefile(fn)), \
            inspect.getsourcelines(fn)[1]
    except Exception:
        return f"loghisto_tpu_torch/{module.replace('.', '/')}.py", 0


def _origin(spec: ProgramSpec) -> tuple[str, int]:
    if spec.factory.startswith(("ops.", "parallel.", "window.")):
        return factory_origin(spec.factory)
    try:
        fn = spec.build
        target = getattr(fn, "func", fn)
        return relpath(inspect.getsourcefile(target)), \
            inspect.getsourcelines(target)[1]
    except Exception:
        return "loghisto_tpu_torch/analysis/program_audit.py", 0


def run_spec(spec: ProgramSpec, device: str = "cpu"):
    """Build ``spec`` on ``device`` and run its step once under the
    recorder: (findings, outputs, recording)."""
    step, args = spec.build(device)
    out, rec, before = record(step, args)
    path, line = _origin(spec)
    return check(out, rec, before, spec.contract, spec.name, path, line,
                 str(device).split(":")[0]), out, rec


def audit_spec(spec: ProgramSpec, device: str = "cpu") -> list[Finding]:
    """Audit an out-of-registry ProgramSpec (fixture steps, ad-hoc guards
    over other shapes)."""
    return run_spec(spec, device)[0]


def audit_program(name: str, device: str = "cpu") -> list[Finding]:
    """Audit one registry entry in this process.  A mesh entry needs the
    (2, 2) process group (``run_mesh`` provides it)."""
    return audit_spec(get_spec(name), device)


def assert_contract(name: str, device: str = "cpu") -> None:
    """The per-test entry point: raise AssertionError listing every
    violated contract clause for ``name``."""
    findings = audit_program(name, device)
    if findings:
        raise AssertionError(
            f"contract violated for step {name!r}:\n"
            + "\n".join("  " + f.render() for f in findings)
        )


def census(name: str, device: str = "cpu") -> dict:
    """What one call of a one-device entry did: wrapper entries, aten op
    counts (reported, never pinned) and collectives."""
    _, _, rec = run_spec(get_spec(name), device)
    return {"launches": dict(_nonzero(rec.entries)),
            "aten_ops": dict(sorted(rec.ops.items())),
            "collectives": {f"{k[0]}:{k[1]}": v
                            for k, v in _nonzero(rec.collectives).items()}}


def constant_findings() -> list[Finding]:
    """The int32 partial-sum bound (see the module docstring)."""
    from loghisto_tpu_torch.ops import row_ingest

    most = max(row_ingest.SAMPLE_TILE, row_ingest.MAX_SAMPLES_PER_CALL)
    if most < INT32_EXACT_BOUND:
        return []
    return [Finding(
        PASS, "loghisto_tpu_torch/ops/row_ingest.py", 0, "SAMPLE_TILE",
        "int32-partial-bound",
        f"one K2 call may add {most} samples into one block's int32 "
        "partial, past the 2^31 exactness bound",
    )]


# ---------------------------------------------------------------------- #
# the mesh ranks
# ---------------------------------------------------------------------- #


def mesh_names() -> tuple:
    return tuple(spec.name for spec in PROGRAMS if spec.mesh)


def run_mesh(names: Optional[Sequence[str]] = None,
             deadline: float = MESH_DEADLINE_S) -> list[Finding]:
    """Audit the mesh entries on a (2, 2) gloo mesh of four fresh
    interpreters (a ``FileStore`` in a temporary directory); rank 0
    reports the findings.  A rank that fails or outlives ``deadline``
    is itself a finding."""
    names = list(names or mesh_names())
    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory(prefix="program_audit_") as tmp:
        procs, logs = [], []
        try:
            for r in range(world):
                logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w"))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "loghisto_tpu_torch.analysis.program_audit", "--rank",
                     str(r), "--world", str(world), "--dir", tmp, *names],
                    stdout=logs[-1], stderr=subprocess.STDOUT, cwd=REPO_ROOT,
                    env=env))
            end = time.monotonic() + deadline
            while time.monotonic() < end:
                codes = [p.poll() for p in procs]
                if all(c is not None for c in codes):
                    break
                if any(codes):
                    end = min(end, time.monotonic() + 5.0)
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in logs:
                f.close()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        report = os.path.join(tmp, "findings.json")
        if failed or not os.path.exists(report):
            tails = []
            for r in failed or range(world):
                with open(os.path.join(tmp, f"rank{r}.log")) as f:
                    tails.append(f"rank {r}: {f.read()[-1500:]}")
            return [Finding(
                PASS, "loghisto_tpu_torch/analysis/program_audit.py", 0,
                "run_mesh", "mesh-run-failed",
                f"the {MESH_SHAPE} mesh ranks failed ({failed or 'no report'}"
                f"): {' | '.join(tails)}",
            )]
        with open(report) as f:
            return [Finding(**item) for item in json.load(f)]


def mesh_rank_results(names: Sequence[str]) -> dict:
    """On a rank of the (2, 2) mesh: every named mesh entry's findings,
    collective census and outputs (host NumPy leaves)."""
    import numpy as np

    out = {}
    for name in names:
        findings, result, rec = run_spec(get_spec(name), "cpu")
        out[name] = {
            "findings": [dataclasses.asdict(f) for f in findings],
            "collectives": {f"{k[0]}:{k[1]}": v
                            for k, v in _nonzero(rec.collectives).items()},
            "payloads": sorted({f"{op}:{axis}:{str(dt).replace('torch.', '')}"
                                for op, axis, dt in rec.payloads}),
            "launches": dict(_nonzero(rec.entries)),
            "shapes": sorted({str(list(s)) for _, s, _, _ in rec.outputs}),
            "outputs": [np.asarray(t.detach().cpu().numpy())
                        for t in tensor_leaves(result)],
            "scalars": [v for v in (result if isinstance(result, tuple)
                                    else ())
                        if isinstance(v, (int, float))],
        }
    return out


def _rank_main(argv: Sequence[str]) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--dir", required=True)
    parser.add_argument("names", nargs="*")
    args = parser.parse_args(argv)
    torch.set_num_threads(1)
    from loghisto_tpu_torch.parallel import multihost

    multihost.initialize(f"file://{os.path.join(args.dir, 'rdzv')}",
                         args.world, args.rank, device="cpu",
                         backend="gloo", timeout_s=60.0)
    try:
        results = mesh_rank_results(args.names or mesh_names())
        if args.rank == 0:
            found = [f for r in results.values() for f in r["findings"]]
            tmp = os.path.join(args.dir, "findings.json.tmp")
            with open(tmp, "w") as f:
                json.dump(found, f)
            os.replace(tmp, os.path.join(args.dir, "findings.json"))
    finally:
        multihost.shutdown()
    return 0


def audit_all(names: Optional[Sequence[str]] = None,
              mesh: bool = True, device: str = "cpu") -> list[Finding]:
    """Audit the registry (the CLI gate's programs pass): the one-device
    entries here, the mesh entries on the (2, 2) ranks (``mesh=False``
    skips them), and, when no names are given, the constants."""
    selected = [get_spec(n) for n in (names or program_names())]
    out: list[Finding] = []
    for spec in selected:
        if not spec.mesh:
            out.extend(audit_spec(spec, device))
    sharded = [s.name for s in selected if s.mesh]
    if mesh and sharded:
        out.extend(run_mesh(sharded))
    if names is None:
        out.extend(constant_findings())
    return out


def describe(spec: ProgramSpec, census: bool = False) -> str:
    """One line of ``--list``: the entry, its contract, its factory and
    the JAX programs it answers; with ``census``, the aten ops one call
    on the CPU ran (reported, never pinned)."""
    c = spec.contract
    launches = ",".join(f"{k}x{v}" for k, v in sorted(
        (c.launches or {}).items())) or "none"
    coll = ",".join(f"{k[0]}:{k[1]}x{v}" for k, v in sorted(
        (c.collectives or {}).items())) or "none"
    forbidden = ",".join(str(s) for s in c.forbidden_shapes or ()) or "none"
    line = (f"{spec.name}{' [mesh 2x2]' if spec.mesh else ''}: "
            f"launches={launches} in_place={c.in_place} "
            f"collectives={coll} forbidden={forbidden} "
            f"factory={spec.factory} reference={','.join(spec.reference)}")
    if census:
        ops = globals()["census"](spec.name)["aten_ops"]
        line += (f" aten_ops={sum(ops.values())}:"
                 + ",".join(f"{k}x{v}" for k, v in ops.items()))
    return line


if __name__ == "__main__":
    raise SystemExit(_rank_main(sys.argv[1:]))
