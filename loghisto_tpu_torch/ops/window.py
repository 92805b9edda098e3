"""K5: the masked ring merge of the retention wheel, and the window
statistics built on it (counterpart of ``loghisto_tpu/ops/window.py``).

Log-bucket histograms merge exactly by elementwise addition, so "p99
over the last W intervals" is one masked reduction over the slot axis
of a dense int32 ``[S, M, B]`` ring followed by the CDF scan of
ops/stats.py.

  * ``window_merge`` — the plain version: ``torch.where`` on the mask
    and an int32 sum over the slot axis (wrapping in two's complement as
    ``jnp.sum(..., dtype=int32)`` does).  It serves the CPU and the
    tests, never the card's path.
  * ``window_merge_kernel`` — the wrapper of the Hopper kernel
    (``csrc/window_merge.cu``), in place of ``window_merge_pallas``.  On
    a CUDA ring it launches K5 with the compact list of masked slots
    (read from a host mask, passed by value in the launch arguments: no
    synchronising copy); on a CPU ring it takes the plain version.

The merge tier follows the ring's device, as every wrapper of the port
does (ROADMAP D4): ``resolve_merge_path`` accepts only "auto".

``window_stats`` is merge + ``dense_stats`` (the recompute path of a
query); ``window_snapshot`` is merge + ``dense_cdf`` per view (the
commit-time snapshot payload), one K5 launch per view.  Both go through
the same merge and the same sums helper, so a snapshot serve and a
recompute over the same mask give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from loghisto_tpu_torch.config import PRECISION
from loghisto_tpu_torch.ops.backend import is_plain, launch
from loghisto_tpu_torch.ops.stats import dense_cdf, dense_stats

# Slots the kernel's argument block holds (csrc/window_merge.cu
# LH_MAX_WINDOW_SLOTS); a larger ring raises instead of truncating.
MAX_WINDOW_SLOTS = 1000

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


def window_merge_kernel(ring: torch.Tensor, mask) -> torch.Tensor:
    """Kernel wrapper, same contract as ``window_merge``: K5 on a CUDA
    ring, the plain version on a CPU ring.  Returns a fresh tensor (never
    a view of the ring)."""
    _check_ring(ring)
    if is_plain(ring):
        return window_merge(ring, mask)
    slots, m, b = ring.shape
    if slots > MAX_WINDOW_SLOTS:
        raise ValueError(
            f"ring of {slots} slots: K5 passes the slot list in its launch "
            f"arguments, which hold at most {MAX_WINDOW_SLOTS} slots"
        )
    idx = np.ascontiguousarray(
        np.flatnonzero(_host_mask(mask, slots)), dtype=np.int32)
    out = torch.empty((m, b), dtype=torch.int32, device=ring.device)
    launch("window_merge", out.data_ptr(), ring.data_ptr(), idx.ctypes.data,
           len(idx), slots, m * b)
    return out


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
    """Commit-time snapshot payload of a tier: for each of the V views
    (rows of ``masks``, host bool [V, S]) merge the masked slots and take
    ``dense_cdf``.  Returns cdf int32 [V, M, B], counts int32 [V, M] and
    sums float32 [V, M] — fresh tensors that no later push writes."""
    masks = np.asarray(masks).astype(bool)
    if masks.ndim != 2:
        raise ValueError(f"masks must be [V, S]; got {masks.shape}")
    views = [
        dense_cdf(window_merge_kernel(ring, mask), bucket_limit, precision)
        for mask in masks
    ]
    return {
        key: torch.stack([v[key] for v in views])
        for key in ("cdf", "counts", "sums")
    }
