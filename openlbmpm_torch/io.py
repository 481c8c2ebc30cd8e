"""Result output: the JAX package's numpy-only ``io`` module, reused as it is
(the reference's HDF5 dataset naming with an npz fallback, PNG snapshots;
it imports numpy and, inside ``save_png_field``, matplotlib, and nothing of
JAX).  Pass it host numpy arrays."""

from openlbmpm_tpu.io import *  # noqa: F401,F403
from openlbmpm_tpu.io import __all__  # noqa: F401
