"""Geometry: the JAX package's numpy-only ``geometry`` module, reused as it
is (masks, pore images, wetting metadata; it imports numpy and nothing of
JAX)."""

from openlbmpm_tpu.geometry import *  # noqa: F401,F403
from openlbmpm_tpu.geometry import __all__  # noqa: F401
