"""loghisto_tpu_torch — the PyTorch/CUDA port of ``loghisto_tpu``.

The JAX package ``loghisto_tpu`` is the reference; this package mirrors
its module paths (each module's docstring names its counterpart) and is
held against it by ``tests/test_torch_*.py``.  It imports ``torch`` and
``numpy`` only: never ``jax``, and no module of ``loghisto_tpu``.

Entry points (``TorchAggregator`` and the ``make_*`` factories) run on
the card (``device="cuda"``) unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit ``device=``, they raise.  On a CUDA
tensor every kernel wrapper launches its hand-written Hopper kernel
(``csrc/``) or raises; the plain PyTorch versions serve CPU tensors
only.
"""

__version__ = "0.1.0"
