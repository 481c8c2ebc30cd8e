"""Forcing schemes: the Guo source term and the EFS force distribution
(counterpart of ``openlbmpm_tpu/ops/forcing.py``).  Fields may carry
leading axes (fluids): u and F components (..., *spatial), results
(..., Q, *spatial)."""

from __future__ import annotations

import torch

from ..lattice import Lattice
from .common import bcast_1d, e_dot_u

__all__ = ["guo_source", "efs_force_pdf"]


def guo_source(lat: Lattice, u, force, prefactor=None) -> torch.Tensor:
    """S_i = w_i [3 (e_i - u) + 9 e_i (e_i . u)] . F, times `prefactor`
    (a scalar or a (..., *spatial) field) when given; Q at -(lat.dim + 1)."""
    qax = -(lat.dim + 1)
    eu = e_dot_u(lat, u)
    acc = 0.0
    for d in range(lat.dim):
        ed = bcast_1d(lat.e[:, d], u[d], lat.dim)
        acc = acc + (3.0 * (ed - u[d].unsqueeze(qax)) + 9.0 * ed * eu) * \
            force[d].unsqueeze(qax)
    src = bcast_1d(lat.w, u[0], lat.dim) * acc
    if prefactor is not None:
        pf = prefactor.unsqueeze(qax) if torch.is_tensor(prefactor) and \
            prefactor.dim() > 0 else prefactor
        src = src * pf
    return src


def efs_force_pdf(lat: Lattice, feq, rho, u, force) -> torch.Tensor:
    """f^F_i = (F . (e_i - u)) f^eq_i / (rho c_s^2) with c_s^2 = 1/3 (the
    Porter 2012 explicit-forcing distribution); rho guarded against 0."""
    acc = 0.0
    for d in range(lat.dim):
        ed = bcast_1d(lat.e[:, d], feq)
        acc = acc + force[d].unsqueeze(-3) * (ed - u[d].unsqueeze(-3))
    rho_safe = torch.where(rho > 0, rho, torch.ones_like(rho))
    return acc * feq * (3.0 / rho_safe.unsqueeze(-3))
