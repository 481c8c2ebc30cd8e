"""Shared helpers: periodic shifts and lattice-constant broadcasting
(counterpart of ``openlbmpm_tpu/ops/common.py``; 2-D only for now)."""

from __future__ import annotations

import numpy as np
import torch

from ..lattice import Lattice

__all__ = ["shift", "pull", "bcast_1d", "e_dot_u"]


def shift(a: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """Value at x of a(x + d), periodic on the trailing (ny, nx) axes:
    ``shift(a, dx, dy)[..., y, x] == a[..., y + dy, x + dx]``."""
    return torch.roll(a, shifts=(-dy, -dx), dims=(-2, -1))


def pull(a: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """Value at x of a(x - d): the pull-streaming gather for velocity d."""
    return torch.roll(a, shifts=(dy, dx), dims=(-2, -1))


def bcast_1d(v, like: torch.Tensor) -> torch.Tensor:
    """Per-direction constant (Q,) as a (Q, 1, 1) tensor matching `like`."""
    return torch.as_tensor(np.asarray(v, np.float64), dtype=like.dtype,
                           device=like.device).reshape(-1, 1, 1)


def e_dot_u(lat: Lattice, u) -> torch.Tensor:
    """(..., Q, ny, nx) tensor of e_i . u for u = (ux, uy), each (..., ny,
    nx) (leading axes batch fluids or tracers)."""
    return bcast_1d(lat.e[:, 0], u[0]) * u[0].unsqueeze(-3) + \
        bcast_1d(lat.e[:, 1], u[1]) * u[1].unsqueeze(-3)
