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
its main path went through the kernels.  The counters are process-wide
integers; ``reset_kernel_launches`` sets them to 0.
"""

from __future__ import annotations

import threading

import torch

KERNELS = ("fused_ingest", "row_ingest", "sparse_ingest", "paged_scatter",
           "fused_paged_ingest", "window_merge")

KERNEL_LAUNCHES = {name: 0 for name in KERNELS}
_launch_lock = threading.Lock()


def reset_kernel_launches() -> None:
    with _launch_lock:
        for name in KERNELS:
            KERNEL_LAUNCHES[name] = 0


def kernel_launches() -> dict:
    with _launch_lock:
        return dict(KERNEL_LAUNCHES)


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


def is_plain(tensor: torch.Tensor) -> bool:
    """True when a wrapper must take its plain version: the tensor lies
    on the CPU.  A CUDA tensor launches the kernel; anything else raises."""
    if tensor.device.type == "cpu":
        return True
    if tensor.device.type == "cuda":
        return False
    raise ValueError(
        f"tensor on {tensor.device}: kernels take CUDA tensors, plain "
        "versions CPU tensors"
    )


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
