"""Shared helpers: periodic shifts and lattice-constant broadcasting
(counterpart of ``openlbmpm_tpu/ops/common.py``).

Fields are (..., ny, nx) in 2-D and (..., nz, ny, nx) in 3-D; PDF stacks
put the direction axis Q at -(dim + 1)."""

from __future__ import annotations

import numpy as np
import torch

from ..lattice import Lattice

__all__ = ["shift", "pull", "bcast_1d", "e_dot_u"]


def shift(a: torch.Tensor, dx: int, dy: int, dz: int | None = None
          ) -> torch.Tensor:
    """Value at x of a(x + d), periodic on the trailing (ny, nx) axes, or on
    (nz, ny, nx) when dz is given:
    ``shift(a, dx, dy)[..., y, x] == a[..., y + dy, x + dx]``."""
    if dz is None:
        return torch.roll(a, shifts=(-dy, -dx), dims=(-2, -1))
    return torch.roll(a, shifts=(-dz, -dy, -dx), dims=(-3, -2, -1))


def pull(a: torch.Tensor, dx: int, dy: int, dz: int | None = None
         ) -> torch.Tensor:
    """Value at x of a(x - d): the pull-streaming gather for velocity d."""
    if dz is None:
        return torch.roll(a, shifts=(dy, dx), dims=(-2, -1))
    return torch.roll(a, shifts=(dz, dy, dx), dims=(-3, -2, -1))


def bcast_1d(v, like: torch.Tensor, spatial_ndim: int = 2) -> torch.Tensor:
    """Per-direction constant (Q,) as a (Q, 1, ..., 1) tensor, one unit axis
    per spatial axis, in the type and on the device of `like`."""
    return torch.as_tensor(np.asarray(v, np.float64), dtype=like.dtype,
                           device=like.device).reshape(
                               (-1,) + (1,) * spatial_ndim)


def e_dot_u(lat: Lattice, u) -> torch.Tensor:
    """(..., Q, *spatial) tensor of e_i . u for u = (ux, uy[, uz]), each
    (..., *spatial) (leading axes batch fluids or tracers); the direction
    axis sits at -(lat.dim + 1)."""
    qax = -(lat.dim + 1)
    acc = 0.0
    for d in range(lat.dim):
        acc = acc + bcast_1d(lat.e[:, d], u[d], lat.dim) * u[d].unsqueeze(qax)
    return acc
