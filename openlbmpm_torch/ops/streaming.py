"""Pull streaming with half-way bounce-back (counterpart of
``openlbmpm_tpu/ops/streaming.py``):

    f_i'(x) = f_i(x - e_i)      if x - e_i is fluid
            = f_opp(i)(x)       if x - e_i is solid
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice import Lattice
from .common import pull

__all__ = ["upwind_solid_masks", "stream", "stream_moving_wall"]


def upwind_solid_masks(lat: Lattice, is_solid: np.ndarray) -> np.ndarray:
    """(Q, *spatial) bool: is the upwind source x - e_i a solid node?
    is_solid is (ny, nx) or, on a 3-D lattice, (nz, ny, nx)."""
    is_solid = np.asarray(is_solid, dtype=bool)
    masks = [np.zeros_like(is_solid)]  # the rest population never bounces
    for i in range(1, lat.q):
        d = [int(c) for c in lat.e[i]]
        masks.append(np.roll(is_solid, shift=tuple(d[::-1]),
                             axis=tuple(range(lat.dim))))
    return np.stack(masks)


def _pull_e(a: torch.Tensor, lat: Lattice, i: int) -> torch.Tensor:
    return pull(a, *(int(c) for c in lat.e[i]))


def stream(f: torch.Tensor, lat: Lattice,
           upwind_solid: torch.Tensor) -> torch.Tensor:
    """Stream a (..., Q, *spatial) PDF stack (leading axes batch fluids or
    tracers); values on solid nodes are not meaningful (callers mask
    them)."""
    qax = -(lat.dim + 1)
    outs = [f.select(qax, 0)]
    for i in range(1, lat.q):
        pulled = _pull_e(f.select(qax, i), lat, i)
        outs.append(torch.where(upwind_solid[i],
                                f.select(qax, int(lat.opp[i])), pulled))
    return torch.stack(outs, dim=qax)


def stream_moving_wall(f: torch.Tensor, lat: Lattice,
                       upwind_solid: torch.Tensor, rho: torch.Tensor,
                       u_wall, upwind_moving: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Pull streaming with moving-wall link bounce-back: a population
    bounced at a moving wall gains 6 w_i rho (e_i . u_wall), with rho
    (..., ny, nx) the density of the bouncing fluid.  `upwind_moving`
    (Q, ny, nx) bool restricts the term to links whose upwind solid node
    belongs to the moving wall; without it every solid wall moves."""
    outs = [f[..., 0, :, :]]
    for i in range(1, lat.q):
        e_dot_uw = sum(float(lat.e[i, k]) * u_wall[k] for k in range(lat.dim))
        term = 6.0 * float(lat.w[i]) * rho * e_dot_uw
        if upwind_moving is not None:
            term = torch.where(upwind_moving[i], term, torch.zeros_like(term))
        bounced = f[..., int(lat.opp[i]), :, :] + term
        pulled = pull(f[..., i, :, :], int(lat.e[i, 0]), int(lat.e[i, 1]))
        outs.append(torch.where(upwind_solid[i], bounced, pulled))
    return torch.stack(outs, dim=-3)
