"""Lattice descriptors: the JAX package's numpy-only ``lattice`` module,
reused as it is (one source of truth for the velocity sets, weights and MRT
matrices; it imports numpy and nothing of JAX)."""

from openlbmpm_tpu.lattice import *  # noqa: F401,F403
from openlbmpm_tpu.lattice import __all__  # noqa: F401
