"""openlbmpm_torch: the PyTorch/CUDA port of openlbmpm_tpu for NVIDIA Hopper.

The JAX package ``openlbmpm_tpu`` stays the reference; this package mirrors
its module names (``ops/``, ``models/``) and replaces each Pallas TPU kernel
with a hand-written CUDA kernel under ``csrc/`` (wrappers in ``kernels/``).

The numpy-only modules ``lattice``, ``geometry`` and ``io`` are the port's
own copies of the JAX package's; nothing in this package imports ``jax`` or
``openlbmpm_tpu``.  Models and entry points run on the card (``device``
defaults to ``"cuda"``, which raises without one) unless the caller asks
for the CPU.
"""

from . import geometry, lattice
from .lattice import D2Q5, D2Q9

from ._device import resolve_device, resolve_dtype

__all__ = ["geometry", "lattice", "D2Q5", "D2Q9", "resolve_device",
           "resolve_dtype"]

__version__ = "0.1.0"
