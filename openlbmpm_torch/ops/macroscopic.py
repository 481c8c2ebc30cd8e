"""Macroscopic moments (counterpart of ``openlbmpm_tpu/ops/macroscopic.py``).

PDF stacks are f = (..., Q, *spatial) with Q at -(dim + 1); leading axes
batch fluids."""

from __future__ import annotations

import numpy as np
import torch

from ..lattice import Lattice
from .common import bcast_1d

__all__ = ["density", "momentum", "ordered_sum", "velocity",
           "sc_common_velocity", "pressure_sc"]


def ordered_sum(terms: torch.Tensor, axis: int) -> torch.Tensor:
    """Sum over `axis` in index order, as XLA reduces it and the kernels
    add (torch.sum adds in another order, an ulp apart; a wetting rotation
    near its threshold turns that ulp into a visible difference)."""
    out = terms.select(axis, 0)
    for i in range(1, terms.shape[axis]):
        out = out + terms.select(axis, i)
    return out


def density(f: torch.Tensor, spatial_dim: int) -> torch.Tensor:
    """rho = sum_i f_i over the Q axis of f = (..., Q, *spatial), with
    `spatial_dim` spatial axes (the Q axis is -(spatial_dim + 1))."""
    return ordered_sum(f, -1 - spatial_dim)


def momentum(lat: Lattice, f: torch.Tensor):
    """(sum_i f_i e_ix, sum_i f_i e_iy[, sum_i f_i e_iz]) over the Q axis at
    -(lat.dim + 1)."""
    return tuple(ordered_sum(bcast_1d(lat.e[:, d], f, lat.dim) * f,
                             -1 - lat.dim) for d in range(lat.dim))


def velocity(lat: Lattice, f: torch.Tensor, rho: torch.Tensor, force=None):
    """u = (sum_i f_i e_i + F/2) / rho, rho guarded against 0; `force` is
    None or one field per axis."""
    mom = momentum(lat, f)
    if force is not None:
        mom = tuple(m + 0.5 * g for m, g in zip(mom, force))
    rho_safe = torch.where(rho > 0, rho, torch.ones_like(rho))
    return tuple(m / rho_safe for m in mom)


def sc_common_velocity(lat: Lattice, f_k: torch.Tensor, rho_k: torch.Tensor,
                       tau_k):
    """Shan-Chen common velocity
    u' = sum_k (sum_i f_ki e_i / tau_k) / sum_k (rho_k / tau_k), the
    denominator guarded against 0.  f_k: (K, Q, *spatial); rho_k:
    (K, *spatial); tau_k: (K,)."""
    inv_tau = torch.as_tensor(1.0 / np.asarray(tau_k, np.float64),
                              dtype=f_k.dtype, device=f_k.device)
    itau = inv_tau.reshape((-1,) + (1,) * (rho_k.dim() - 1))
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
