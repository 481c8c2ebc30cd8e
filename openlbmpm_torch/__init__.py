"""openlbmpm_torch: the PyTorch/CUDA port of openlbmpm_tpu for NVIDIA Hopper.

The JAX package ``openlbmpm_tpu`` stays the reference; this package mirrors
its module names (``ops/``, ``models/``) and replaces each Pallas TPU kernel
with a hand-written CUDA kernel under ``csrc/`` (wrappers in ``kernels/``).

The lattice tables and geometry helpers are numpy-only and are reused from
the reference package rather than copied: ``openlbmpm_torch.lattice`` and
``openlbmpm_torch.geometry`` re-export ``openlbmpm_tpu.lattice`` and
``openlbmpm_tpu.geometry``, which import numpy and nothing of JAX.  Nothing
in this package imports ``jax``.
"""

from . import geometry, lattice
from .lattice import D2Q9

from ._device import resolve_device, resolve_dtype

__all__ = ["geometry", "lattice", "D2Q9", "resolve_device", "resolve_dtype"]

__version__ = "0.1.0"
