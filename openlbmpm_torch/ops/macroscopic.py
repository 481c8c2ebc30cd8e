"""Macroscopic moments (counterpart of ``openlbmpm_tpu/ops/macroscopic.py``).

PDF stacks are f = (..., Q, ny, nx); leading axes batch fluids."""

from __future__ import annotations

import numpy as np
import torch

from ..lattice import Lattice
from .common import bcast_1d

__all__ = ["density", "momentum", "sc_common_velocity", "pressure_sc"]


def density(f: torch.Tensor) -> torch.Tensor:
    """rho = sum_i f_i over the Q axis of f = (..., Q, ny, nx)."""
    return torch.sum(f, dim=-3)


def momentum(lat: Lattice, f: torch.Tensor):
    """(sum_i f_i e_ix, sum_i f_i e_iy)."""
    return tuple(torch.sum(bcast_1d(lat.e[:, d], f) * f, dim=-3)
                 for d in range(lat.dim))


def sc_common_velocity(lat: Lattice, f_k: torch.Tensor, rho_k: torch.Tensor,
                       tau_k):
    """Shan-Chen common velocity
    u' = sum_k (sum_i f_ki e_i / tau_k) / sum_k (rho_k / tau_k), the
    denominator guarded against 0.  f_k: (K, Q, ny, nx); rho_k: (K, ny, nx);
    tau_k: (K,)."""
    inv_tau = torch.as_tensor(1.0 / np.asarray(tau_k, np.float64),
                              dtype=f_k.dtype, device=f_k.device)
    itau = inv_tau.reshape(-1, 1, 1)
    denom = torch.sum(rho_k * itau, dim=0)
    denom = torch.where(denom != 0, denom, torch.ones_like(denom))
    return tuple(torch.sum(m * itau, dim=0) / denom
                 for m in momentum(lat, f_k))


def pressure_sc(rho_k: torch.Tensor, g_matrix) -> torch.Tensor:
    """P = rho_tot / 3 + (3/2) sum_{i<j} G_ij rho_i rho_j."""
    k = rho_k.shape[0]
    p = torch.sum(rho_k, dim=0) / 3.0
    for i in range(k - 1):
        for j in range(i + 1, k):
            p = p + 1.5 * float(g_matrix[i][j]) * rho_k[i] * rho_k[j]
    return p
