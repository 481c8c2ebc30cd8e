"""Equilibrium distributions (counterpart of
``openlbmpm_tpu/ops/equilibrium.py``)."""

from __future__ import annotations

import torch

from ..lattice import Lattice
from .common import bcast_1d, e_dot_u

__all__ = ["feq_quadratic"]


def feq_quadratic(lat: Lattice, rho: torch.Tensor, u) -> torch.Tensor:
    """w_i rho (1 + 3 e.u + 4.5 (e.u)^2 - 1.5 u.u), shape (Q, ny, nx)."""
    eu = e_dot_u(lat, u)
    uu = (u[0] * u[0] + u[1] * u[1])[None]
    return bcast_1d(lat.w, rho) * rho[None] * \
        (1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * uu)
