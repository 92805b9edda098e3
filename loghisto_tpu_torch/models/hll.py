"""HyperLogLog cardinality sketch in PyTorch (counterpart of
``loghisto_tpu/models/hll.py``).

Estimates the number of *distinct* values in a stream — the one statistic
log-bucket histograms cannot provide.  Batch insertion is a hash and a
scatter-max over 2^p registers, so it vectorizes (``torch.func.vmap``
runs it over stacked sketches) and, like the histogram and the t-digest,
merges associatively: merge = elementwise register max.

The hash is the reference's 32-bit murmur-style finalizer over the
float32 bit pattern, so registers equal the reference's bit for bit.
PyTorch has few ``uint32`` kernels, so the hash runs in int64 with every
product taken modulo 2^32 from two 16-bit halves (no product reaches
2^48): the wrap-around of the reference's ``uint32`` multiplies, exactly.
Reliable up to ~1e6 distinct values at the default p=14 (2^14
registers, ~0.8% relative error); beyond that the 32-bit hash space
itself starts to saturate.
"""

from __future__ import annotations

import dataclasses

import torch

from loghisto_tpu_torch.ops.backend import resolve_device

_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class HLLConfig:
    p: int = 14  # 2^p registers

    def __post_init__(self):
        if not 4 <= self.p <= 18:
            raise ValueError("p must be in [4, 18]")

    @property
    def num_registers(self) -> int:
        return 1 << self.p


def empty(config: HLLConfig = HLLConfig(), device=None) -> torch.Tensor:
    """Zeroed int32 registers on ``device`` (default the card)."""
    return torch.zeros(config.num_registers, dtype=torch.int32,
                       device=resolve_device(device))


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 ``h`` in [0, 2^32): the low and high
    16-bit halves of ``h`` times ``c`` stay below 2^48."""
    lo = (h & 0xFFFF) * c
    hi = ((h >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3-finalizer-style avalanche over float32 bit patterns, as
    int64 values in [0, 2^32)."""
    # the bit pattern through view_copy, not view: torch.func.vmap has
    # no batching rule for a dtype view, and runs view_copy slice by
    # slice (with a one-time performance warning)
    bits = torch.ops.aten.view_copy.dtype(x.to(torch.float32), torch.int32)
    h = bits.to(torch.int64) & _MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _trailing_zeros(lowbit: torch.Tensor) -> torch.Tensor:
    """log2 of int64 powers of two below 2^32, by halving."""
    k = torch.zeros_like(lowbit)
    for s in (16, 8, 4, 2, 1):
        big = lowbit >= (1 << s)
        k = k + big.to(torch.int64) * s
        lowbit = torch.where(big, lowbit >> s, lowbit)
    return k


def insert(
    registers: torch.Tensor, values, config: HLLConfig = HLLConfig()
) -> torch.Tensor:
    """Add a batch of values to the sketch; returns new registers."""
    if not isinstance(values, torch.Tensor):
        values = torch.as_tensor(values, dtype=torch.float32,
                                 device=registers.device)
    p = config.p
    m = 1 << p
    h = _hash32(values.reshape(-1))
    idx = h & (m - 1)
    rest = h >> p
    # rho: position of the first set bit of the remaining (32 - p) bits,
    # from 1; an all-zero rest gets the maximum 32 - p + 1
    rho = torch.where(rest == 0, 32 - p + 1,
                      _trailing_zeros(rest & -rest) + 1).to(torch.int32)
    maxes = torch.zeros(m, dtype=torch.int32, device=registers.device)
    maxes = maxes.scatter_reduce(0, idx, rho, "amax", include_self=True)
    return torch.maximum(registers, maxes)


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Union of two sketches — elementwise max."""
    return torch.maximum(a, b)


def estimate(registers: torch.Tensor) -> torch.Tensor:
    """Distinct-count estimate with linear-counting small-range
    correction (float32, as the reference)."""
    m = registers.shape[-1]
    alpha = 0.7213 / (1.0 + 1.079 / m)

    def f32(c):  # a float32 numerator, as the reference's weak scalar
        return torch.tensor(c, dtype=torch.float32, device=registers.device)

    inv = torch.exp2(-registers.to(torch.float32)).sum(-1)
    raw = f32(alpha * m * m) / inv
    zeros = (registers == 0).sum(-1)
    linear = m * torch.log(f32(m) / torch.clamp(zeros, min=1).to(
        torch.float32))
    use_linear = (raw <= 2.5 * m) & (zeros > 0)
    return torch.where(use_linear, linear, raw)
