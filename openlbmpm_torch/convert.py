"""State and parameters carried across between the JAX package and the port.

The geometry needs no conversion: both packages use the same numpy
``openlbmpm_tpu.geometry.Geometry``.  Arrays cross as numpy arrays, so
nothing here imports JAX; a bfloat16 array from JAX arrives as an
``ml_dtypes.bfloat16`` numpy array and crosses bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._device import resolve_device, resolve_dtype
from .models.colorgradient import CGBoundaryConfig, ColorGradientParams

__all__ = ["params_from_jax", "state_from_numpy", "state_to_numpy"]


def params_from_jax(p):
    """The port's ColorGradientParams or CGBoundaryConfig with the field
    values of `p`, any object carrying the fields of either."""
    for cls in (ColorGradientParams, CGBoundaryConfig):
        names = [f.name for f in dataclasses.fields(cls)]
        if all(hasattr(p, n) for n in names):
            vals = {n: getattr(p, n) for n in names}
            if "body_force" in vals:
                vals["body_force"] = tuple(float(v)
                                           for v in vals["body_force"])
            return cls(**vals)
    raise TypeError(f"{type(p).__name__} has the fields of neither "
                    "ColorGradientParams nor CGBoundaryConfig")


def _one_from_numpy(a, device, dtype):
    a = np.array(a)   # a writable contiguous copy
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    t = torch.from_numpy(a)
    return t.to(device=device, dtype=resolve_dtype(dtype) if dtype else None)


def state_from_numpy(arrays, device="cpu", dtype=None):
    """A state as torch tensors on `device`: a (10, ny, nx) compressed
    array, an (11, ny, nx) bfloat16 array (kept bfloat16), or an
    (f_r, f_b) pair of (9, ny, nx) arrays (returned as a tuple).  `dtype`
    casts the non-bfloat16 layouts; None keeps the array's own type."""
    dev = resolve_device(device)
    if isinstance(arrays, (tuple, list)):
        return tuple(_one_from_numpy(a, dev, dtype) for a in arrays)
    return _one_from_numpy(arrays, dev, dtype)


def _one_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def state_to_numpy(state):
    """Inverse of ``state_from_numpy``: numpy arrays on the host."""
    if isinstance(state, (tuple, list)):
        return tuple(_one_to_numpy(t) for t in state)
    return _one_to_numpy(state)
