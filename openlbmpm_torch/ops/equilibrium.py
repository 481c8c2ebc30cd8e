"""Equilibrium distributions (counterpart of
``openlbmpm_tpu/ops/equilibrium.py``).

The transport equilibria take concentrations with leading tracer axes,
conc (..., ny, nx), and return (..., Q, ny, nx); ``feq_transport_j`` also
takes 3-D concentrations (..., nz, ny, nx) on D3Q7 and returns
(..., 7, nz, ny, nx)."""

from __future__ import annotations

import numpy as np
import torch

from ..lattice import Lattice
from .common import bcast_1d, e_dot_u

__all__ = ["feq_quadratic", "feq_rk_original", "feq_transport_j",
           "feq_transport_linear", "feq_transport_quadratic", "rk_constants"]


def feq_quadratic(lat: Lattice, rho: torch.Tensor, u) -> torch.Tensor:
    """w_i rho (1 + 3 e.u + 4.5 (e.u)^2 - 1.5 u.u), shape (..., Q, *spatial)
    for rho and the lat.dim components of u of shape (..., *spatial)."""
    qax = -(lat.dim + 1)
    eu = e_dot_u(lat, u)
    uu = u[0] * u[0]
    for d in range(1, lat.dim):
        uu = uu + u[d] * u[d]
    return bcast_1d(lat.w, rho, lat.dim) * rho.unsqueeze(qax) * \
        (1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * uu.unsqueeze(qax))


def rk_constants(alpha: float) -> np.ndarray:
    """Density-ratio constants C_i of the RK equilibrium (D2Q9): C_0 =
    alpha, C_1..4 = (1 - alpha)/5, C_5..8 = (1 - alpha)/20."""
    c = np.zeros(9, dtype=np.float64)
    c[0] = alpha
    c[1:5] = (1.0 - alpha) / 5.0
    c[5:] = (1.0 - alpha) / 20.0
    return c


def feq_rk_original(lat: Lattice, rho: torch.Tensor, u,
                    constants) -> torch.Tensor:
    """rho (C_i + w_i (3 e.u + 4.5 (e.u)^2 - 1.5 u.u)), shape (Q, ny, nx),
    with the constants C_i of ``rk_constants``."""
    eu = e_dot_u(lat, u)
    uu = (u[0] * u[0] + u[1] * u[1])[None]
    return rho[None] * (bcast_1d(constants, rho) + bcast_1d(lat.w, rho) *
                        (3.0 * eu + 4.5 * eu * eu - 1.5 * uu))


def feq_transport_j(lat: Lattice, conc: torch.Tensor, u,
                    j_coeffs) -> torch.Tensor:
    """C (J_i + (e.u) / 2): the J-scheme equilibrium, with j_coeffs (Q,) =
    (J0, (1 - J0)/4, ...) on D2Q5 or (J0, (1 - J0)/6, ...) on D3Q7; the Q
    axis sits at -(lat.dim + 1)."""
    eu = e_dot_u(lat, u)
    return conc.unsqueeze(-(lat.dim + 1)) * \
        (bcast_1d(j_coeffs, conc, lat.dim) + 0.5 * eu)


def feq_transport_linear(lat: Lattice, conc: torch.Tensor, u) -> torch.Tensor:
    """C w_i (1 + 3 e.u)."""
    eu = e_dot_u(lat, u)
    return conc.unsqueeze(-3) * bcast_1d(lat.w, conc) * (1.0 + 3.0 * eu)


def feq_transport_quadratic(lat: Lattice, conc: torch.Tensor,
                            u) -> torch.Tensor:
    """C w_i (1 + 3 e.u + 4.5 (e.u)^2 - 1.5 u.u)."""
    eu = e_dot_u(lat, u)
    uu = (u[0] * u[0] + u[1] * u[1])[None]
    return conc.unsqueeze(-3) * bcast_1d(lat.w, conc) * \
        (1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * uu)
