"""Guo forcing source term (counterpart of ``openlbmpm_tpu/ops/forcing.py``)."""

from __future__ import annotations

import torch

from ..lattice import Lattice
from .common import bcast_1d, e_dot_u

__all__ = ["guo_source"]


def guo_source(lat: Lattice, u, force, prefactor=None) -> torch.Tensor:
    """S_i = w_i [3 (e_i - u) + 9 e_i (e_i . u)] . F, times `prefactor`
    (a scalar or a (ny, nx) field) when given."""
    eu = e_dot_u(lat, u)
    acc = 0.0
    for d in range(lat.dim):
        ed = bcast_1d(lat.e[:, d], u[d])
        acc = acc + (3.0 * (ed - u[d][None]) + 9.0 * ed * eu) * force[d][None]
    src = bcast_1d(lat.w, u[0]) * acc
    if prefactor is not None:
        pf = prefactor[None] if torch.is_tensor(prefactor) and \
            prefactor.dim() > 0 else prefactor
        src = src * pf
    return src
