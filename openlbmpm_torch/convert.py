"""State and parameters carried across between the JAX package and the port.

The geometry needs no conversion: the port's ``geometry.Geometry`` has the
JAX package's fields (numpy masks), and the models read only those.
Arrays cross as numpy arrays, so nothing here imports JAX; a bfloat16 array
from JAX arrives as an ``ml_dtypes.bfloat16`` numpy array and crosses bit
for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._device import resolve_device, resolve_dtype
from .models.colorgradient import CGBoundaryConfig, ColorGradientParams
from .models.flow3d import (CG3DBoundaryConfig, ColorGradientParams3D,
                            ShanChenParams3D)
from .models.shanchen import SCBoundaryConfig, ShanChenParams
from .models.single_phase import BoundaryConfig
from .models.transport import TransportParams, TransportState

# the class of `p`'s own name, else the first whose fields `p` all carries:
# the 3-D classes come last, since a 2-D ColorGradientParams carries every
# field of ColorGradientParams3D, an SCBoundaryConfig every field of
# CG3DBoundaryConfig and of the single-phase BoundaryConfig, and a
# ShanChenParams every field of ShanChenParams3D
_PARAMS = (ColorGradientParams, CGBoundaryConfig, TransportParams,
           ShanChenParams, SCBoundaryConfig, ColorGradientParams3D,
           CG3DBoundaryConfig, ShanChenParams3D, BoundaryConfig)

__all__ = ["params_from_jax", "transport3d_args_from_jax",
           "single_phase_args_from_jax", "state_from_numpy",
           "state_to_numpy"]


def _plain(v):
    """Tuple fields as nested tuples of floats (strings kept: the
    Peng-Robinson override names)."""
    if isinstance(v, (tuple, list, np.ndarray)):
        return tuple(_plain(x) for x in v)
    return v if isinstance(v, str) else float(v)


def params_from_jax(p):
    """The port's ColorGradientParams(3D), CGBoundaryConfig,
    CG3DBoundaryConfig, TransportParams, ShanChenParams(3D),
    SCBoundaryConfig or single-phase BoundaryConfig with the field values of
    `p`: the class named as `p`'s is, else the first whose fields `p` all
    carries (tuple fields become nested tuples of floats)."""
    named = [c for c in _PARAMS if c.__name__ == type(p).__name__]
    for cls in named + [c for c in _PARAMS if c not in named]:
        names = [f.name for f in dataclasses.fields(cls)]
        if all(hasattr(p, n) for n in names):
            vals = {n: getattr(p, n) for n in names}
            for n, v in vals.items():
                if isinstance(v, (tuple, list)):
                    vals[n] = _plain(v)
            return cls(**vals)
    raise TypeError(f"{type(p).__name__} has the fields of none of " +
                    ", ".join(c.__name__ for c in _PARAMS))


def transport3d_args_from_jax(model) -> dict:
    """Keyword arguments of the port's ``TransportRK3D`` (besides the
    geometry, dtype, device and storage) from a JAX ``TransportRK3D``: its
    flow's parameters and boundaries, and its tracers' count, tau, J_0,
    criteria and interface mode."""
    tr = model.transport
    return {"flow_params": params_from_jax(model.flow.p),
            "boundaries": params_from_jax(model.flow.bcs),
            "num_tracers": int(tr.num_tracers),
            "tau": tuple(float(t) for t in np.atleast_1d(tr.tau)),
            "j0": tuple(float(j) for j in np.asarray(tr.j_coeffs)[:, 0]),
            "criteria": float(tr.criteria),
            "interface_mode": tr.interface_mode}


def single_phase_args_from_jax(model) -> dict:
    """Keyword arguments of the port's ``SinglePhaseD2Q9`` or
    ``SinglePhaseD3Q19`` (besides the geometry, dtype, device and storage)
    from a JAX model of the same name: tau, collision and body force, and
    in 2-D the boundaries and the wall velocity.  The moving-wall mask is
    not kept by the JAX model; pass it to both."""
    kw = {"tau": float(model.tau), "collision": model.collision,
          "body_force": tuple(float(v) for v in model.body_force)}
    if hasattr(model, "bcs"):
        kw["boundaries"] = params_from_jax(model.bcs)
        kw["wall_velocity"] = tuple(float(v) for v in model.wall_velocity)
    return kw


def _one_from_numpy(a, device, dtype):
    a = np.array(a)   # a writable contiguous copy
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    t = torch.from_numpy(a)
    return t.to(device=device, dtype=resolve_dtype(dtype) if dtype else None)


def state_from_numpy(arrays, device="cuda", dtype=None):
    """A state as torch tensors on `device`: a (10, ny, nx) or
    (20, nz, ny, nx) compressed array, a Shan-Chen (K, 9, ny, nx) or
    (K, 19, nz, ny, nx) array, a single-phase (9, ny, nx) or
    (19, nz, ny, nx) array, an (11, ny, nx), (21, nz, ny, nx),
    (K, 11, ny, nx) or (K, 21, nz, ny, nx) bfloat16 array (kept
    bfloat16), a tuple of arrays such as an (f_r, f_b) pair, a coupled
    (s, g) pair or a 3-D coupled (f_r, f_b, g) triple (returned as a
    tuple), or a split TransportState (f_r, f_b, g, mass0), returned
    as the port's ``TransportState`` (``TransportRK.pack`` packs it to
    (s, g)).  `dtype` casts the non-bfloat16 arrays; None keeps each
    array's own type."""
    dev = resolve_device(device)
    if getattr(arrays, "_fields", None) == TransportState._fields:
        return TransportState(*(_one_from_numpy(a, dev, dtype)
                                for a in arrays))
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
    """Inverse of ``state_from_numpy``: numpy arrays on the host (a
    TransportState stays a TransportState, of numpy arrays)."""
    if isinstance(state, TransportState):
        return TransportState(*(_one_to_numpy(t) for t in state))
    if isinstance(state, (tuple, list)):
        return tuple(_one_to_numpy(t) for t in state)
    return _one_to_numpy(state)
