"""Device resolution and kernel launch bookkeeping (counterpart of
``loghisto_tpu/ops/backend.py``).

The JAX module answers "is the default backend a TPU?" and quietly runs
Pallas in interpret mode when it is not.  The port has no such escape:

  * ``resolve_device(None)`` means the card.  With no CUDA device it
    raises — an entry point never carries on quietly on the CPU.  The
    CPU is reached only by asking for it (``device="cpu"``), which is
    what the CPU tests do.
  * A kernel wrapper takes its plain PyTorch version only for a tensor
    that lies on the CPU; on a CUDA tensor it launches its kernel
    (``launch``) or raises.

``KERNEL_LAUNCHES`` counts launches per kernel: each wrapper adds one
where it launches its kernel, and nowhere else, so a run can show that
its main path went through the kernels.  ``WRAPPER_ENTRIES`` counts the
entries to each kernel's wrapper (its ``is_plain`` call), on either
device: on the card an entry launches the kernel, on the CPU it takes
the plain version, so the entries pin a step's kernels where no launch
can be seen (``analysis/program_audit.py``).  The counters are
process-wide integers; ``reset_kernel_launches`` sets both to 0.

``to_device`` uploads a host array without a synchronisation: on the
card through pinned memory and a non-blocking copy on the current
stream, so a step that takes host indices does not stall the stream.
"""

from __future__ import annotations

import sys
import threading

import numpy as np
import torch

KERNELS = ("fused_ingest", "row_ingest", "sparse_ingest", "paged_scatter",
           "fused_paged_ingest", "window_merge", "compact_rows", "divergence",
           "multirow_ingest")

KERNEL_LAUNCHES = {name: 0 for name in KERNELS}
WRAPPER_ENTRIES = {name: 0 for name in KERNELS}
_launch_lock = threading.Lock()

# Called as observer(kernel, plain, caller frame) at every wrapper entry
# while set (the program auditor's recorder); None otherwise.
_entry_observer = None


def reset_kernel_launches() -> None:
    with _launch_lock:
        for name in KERNELS:
            KERNEL_LAUNCHES[name] = 0
            WRAPPER_ENTRIES[name] = 0


def kernel_launches() -> dict:
    with _launch_lock:
        return dict(KERNEL_LAUNCHES)


def wrapper_entries() -> dict:
    with _launch_lock:
        return dict(WRAPPER_ENTRIES)


def set_entry_observer(observer):
    """Install ``observer(kernel, plain, frame)`` (None removes it);
    returns the one it replaces."""
    global _entry_observer
    previous, _entry_observer = _entry_observer, observer
    return previous


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card.  Raises when CUDA is asked for (explicitly
    or by default) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "loghisto_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev


def is_plain(tensor: torch.Tensor, kernel: str) -> bool:
    """The entry of ``kernel``'s wrapper (one of ``KERNELS``): True when
    it must take its plain version, the tensor lying on the CPU.  A CUDA
    tensor launches the kernel; anything else raises.  Counts the entry
    in ``WRAPPER_ENTRIES``."""
    if tensor.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"tensor on {tensor.device}: kernels take CUDA tensors, plain "
            "versions CPU tensors"
        )
    plain = tensor.device.type == "cpu"
    with _launch_lock:
        WRAPPER_ENTRIES[kernel] += 1
    observer = _entry_observer
    if observer is not None:
        observer(kernel, plain, sys._getframe(1))
    return plain


def to_device(values, device, dtype=None) -> torch.Tensor:
    """``values`` (a host array, a sequence or a tensor) as a tensor of
    ``dtype`` on ``device``.  A host array bound for the card goes
    through pinned memory with a non-blocking copy on the current
    stream: no synchronisation, and the caching host allocator keeps the
    pinned block until the copy has read it.  A tensor already there is
    returned as it is."""
    device = torch.device(device)
    if isinstance(values, torch.Tensor):
        t = values
    else:
        t = torch.from_numpy(np.ascontiguousarray(values))
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    if t.device.type == device.type and (device.index is None
                                         or t.device == device):
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` through its C entry point on the current
    stream, raise on a nonzero ``cudaGetLastError()``, count it."""
    from loghisto_tpu_torch.ops import _build

    fn = _build.entry(name)
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {rc} "
            f"({_build.error_string(name, rc)})"
        )
    with _launch_lock:
        KERNEL_LAUNCHES[name] += 1
