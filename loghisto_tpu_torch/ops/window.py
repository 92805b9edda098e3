"""K5: the masked ring merge of the retention wheel, and the window
statistics built on it (counterpart of ``loghisto_tpu/ops/window.py``).

Log-bucket histograms merge exactly by elementwise addition, so "p99
over the last W intervals" is one masked reduction over the slot axis
of a dense int32 ``[S, M, B]`` ring followed by the CDF scan of
ops/stats.py.

  * ``window_merge`` — the plain version of one view: ``torch.where``
    on the mask and an int32 sum over the slot axis (wrapping in two's
    complement as ``jnp.sum(..., dtype=int32)`` does).  It serves the
    CPU and the tests, never the card's path.
  * ``window_merge_views(ring, masks)`` — every view of a tier in one
    pass: int32 ``[V, M, B]`` with ``out[v]`` the sum of the slots of
    ``masks[v]``.  On a CUDA ring it launches K5 (``csrc/window_merge.cu``,
    in place of one ``window_merge_pallas`` call per view) once, with the
    plan of ``merge_plan`` in a device buffer; on a CPU ring it is a
    stack of ``window_merge`` calls.  ``window_merge_kernel(ring, mask)``
    is its V = 1 case.

The merge tier follows the ring's device, as every wrapper of the port
does (ROADMAP D4): ``resolve_merge_path`` accepts only "auto".

``window_stats`` is merge + ``dense_stats`` (the recompute path of a
query); ``window_snapshot`` is one ``window_merge_views`` launch per tier
+ ``dense_cdf`` over the views (the commit-time snapshot payload).  Both
take the same int32 sums and the same float32 sums helper, so a snapshot
serve and a recompute over the same mask give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from loghisto_tpu_torch.config import PRECISION
from loghisto_tpu_torch.ops.backend import is_plain, launch
from loghisto_tpu_torch.ops.stats import dense_stats, row_sums

MERGE_PATH_RULE = (
    "the window merge follows the ring's device, as every kernel wrapper "
    "of the port does: a CUDA ring launches K5 (csrc/window_merge.cu) and a "
    "CPU ring takes the plain version (ROADMAP D4); pass merge_path='auto'"
)


def resolve_merge_path(path: str) -> str:
    """The port's merge dispatch: only "auto" (the tensor's device
    decides).  The reference's "jnp"/"pallas" choice has no counterpart
    here, so any other value raises with the rule."""
    if path != "auto":
        raise ValueError(f"merge_path={path!r}: {MERGE_PATH_RULE}")
    return path


def _check_ring(ring: torch.Tensor) -> None:
    if ring.ndim != 3:
        raise ValueError(f"ring must be [S, M, B]; got {tuple(ring.shape)}")
    if ring.dtype != torch.int32:
        raise ValueError(f"ring must be int32; got {ring.dtype}")
    if not ring.is_contiguous():
        raise ValueError("ring must be contiguous (the kernel indexes it flat)")


def _host_mask(mask, slots: int) -> np.ndarray:
    """The mask as a host bool array of length ``slots``.  A CUDA tensor
    is refused: reading it would synchronise every merge."""
    if isinstance(mask, torch.Tensor):
        if mask.device.type != "cpu":
            raise ValueError(
                "the window mask must be a host array: a mask on "
                f"{mask.device} would synchronise every merge"
            )
        mask = mask.numpy()
    mask = np.asarray(mask).astype(bool).reshape(-1)
    if mask.shape[0] != slots:
        raise ValueError(f"mask has {mask.shape[0]} entries for {slots} slots")
    return mask


def window_merge(ring: torch.Tensor, mask) -> torch.Tensor:
    """Plain version: int32 [M, B] = sum of the masked ring slots."""
    _check_ring(ring)
    keep = torch.as_tensor(
        _host_mask(mask, ring.shape[0]), device=ring.device
    )[:, None, None]
    return torch.where(keep, ring, 0).sum(dim=0, dtype=torch.int32)


def merge_plan(masks: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """K5's plan of host bool masks [V, S]: ``(order, views)`` with
    ``order`` int32 slot indices and ``views`` int32 [V, 3] rows
    ``(v, start, k)`` such that ``out[v]`` is the sum of the slots
    ``order[start:start + k]``, sorted by (start, k).

    The views are chained greedily by mask size: a view joins the first
    chain whose largest mask it contains, so nested masks (every
    trailing window of a tier) give one chain and each slot is listed
    once; masks that are not nested give several chains, each listed
    after the last.  Within a chain each view's slots are a prefix of
    the chain's order."""
    masks = np.asarray(masks, dtype=bool)
    counts = masks.sum(axis=1)
    chains: list[list[int]] = []
    for v in np.argsort(counts, kind="stable").tolist():
        for chain in chains:
            if not (masks[chain[-1]] & ~masks[v]).any():
                chain.append(v)
                break
        else:
            chains.append([v])
    order, views = [], []
    for chain in chains:
        start = sum(len(o) for o in order)
        prev = np.zeros(masks.shape[1], dtype=bool)
        for v in chain:
            order.append(np.flatnonzero(masks[v] & ~prev))
            views.append((v, start, int(counts[v])))
            prev = masks[v]
    order = np.concatenate(order).astype(np.int32) if order else np.zeros(
        0, np.int32)
    return order, np.asarray(views, dtype=np.int32).reshape(-1, 3)


def _host_masks(masks, slots: int) -> np.ndarray:
    """The masks as a host bool array [V, slots]; a 1-D mask is one
    view.  A CUDA tensor is refused (see ``_host_mask``)."""
    if isinstance(masks, torch.Tensor):
        if masks.device.type != "cpu":
            raise ValueError(
                "the window masks must be a host array: masks on "
                f"{masks.device} would synchronise every merge"
            )
        masks = masks.numpy()
    masks = np.asarray(masks).astype(bool)
    if masks.ndim == 1:
        masks = masks[None]
    if masks.ndim != 2 or masks.shape[1] != slots:
        raise ValueError(
            f"masks must be [V, {slots}] for {slots} slots; got {masks.shape}")
    return masks


def window_merge_views(ring: torch.Tensor, masks) -> torch.Tensor:
    """int32 [V, M, B]: ``out[v]`` = the sum of the ring slots of
    ``masks[v]`` (host bool [V, S]).  One K5 launch on a CUDA ring; a
    stack of ``window_merge`` calls (the plain version) on a CPU ring.
    Returns a fresh tensor that no later push writes."""
    _check_ring(ring)
    slots, m, b = ring.shape
    masks = _host_masks(masks, slots)
    if is_plain(ring, "window_merge"):
        if not len(masks):
            return torch.zeros((0, m, b), dtype=torch.int32)
        return torch.stack([window_merge(ring, mask) for mask in masks])
    order, views = merge_plan(masks)
    out = torch.empty((len(masks), m, b), dtype=torch.int32,
                      device=ring.device)
    if not len(masks):
        return out
    # the plan goes up from pinned memory on the current stream without a
    # synchronisation; the caching host allocator records the copy on that
    # stream, so the pinned block is not handed out again (and rewritten)
    # before the copy has read it, even once this tensor is dropped
    host = torch.empty(len(order) + views.size, dtype=torch.int32,
                       pin_memory=True)
    host.numpy()[:len(order)] = order
    host.numpy()[len(order):] = views.reshape(-1)
    plan = host.to(ring.device, non_blocking=True)
    launch("window_merge", out.data_ptr(), ring.data_ptr(), plan.data_ptr(),
           len(order), len(masks), m * b)
    return out


def window_merge_kernel(ring: torch.Tensor, mask) -> torch.Tensor:
    """Kernel wrapper, same contract as ``window_merge``: the V = 1 case
    of ``window_merge_views`` (K5 on a CUDA ring, the plain version on a
    CPU ring).  Returns a fresh tensor (never a view of the ring)."""
    _check_ring(ring)
    return window_merge_views(ring, _host_mask(mask, ring.shape[0])[None])[0]


def window_stats(
    ring: torch.Tensor,
    mask,
    ps,
    bucket_limit: int,
    precision: int = PRECISION,
) -> dict[str, torch.Tensor]:
    """Window query by recompute: masked merge + ``dense_stats`` —
    counts [M], sums [M], percentiles [M, P] of every row over the
    masked slots."""
    merged = window_merge_kernel(ring, mask)
    return dense_stats(merged, ps, bucket_limit, precision)


def window_snapshot(
    ring: torch.Tensor,
    masks,
    bucket_limit: int,
    precision: int = PRECISION,
) -> dict[str, torch.Tensor]:
    """Commit-time snapshot payload of a tier: the V views (rows of
    ``masks``, host bool [V, S]) merged in one ``window_merge_views``
    pass, then ``dense_cdf``'s payload over them.  Returns cdf int32
    [V, M, B], counts int32 [V, M] and sums float32 [V, M] — fresh
    tensors that no later push writes.  The merged views are this
    call's own, so their prefix sums are taken in place, after the sums:
    one [V, M, B] tensor fewer at the peak (2 GiB a view at 2^16 rows)."""
    masks = np.asarray(masks).astype(bool)
    if masks.ndim != 2:
        raise ValueError(f"masks must be [V, S]; got {masks.shape}")
    merged = window_merge_views(ring, masks)
    sums = torch.stack([row_sums(a, bucket_limit, precision) for a in merged])
    cdf = merged.cumsum_(dim=-1)
    return {"cdf": cdf, "counts": cdf[..., -1].contiguous(), "sums": sums}
