"""Macroscopic moments (counterpart of ``openlbmpm_tpu/ops/macroscopic.py``)."""

from __future__ import annotations

import torch

from ..lattice import Lattice
from .common import bcast_1d

__all__ = ["density", "momentum"]


def density(f: torch.Tensor) -> torch.Tensor:
    """rho = sum_i f_i over the Q axis of f = (..., Q, ny, nx)."""
    return torch.sum(f, dim=-3)


def momentum(lat: Lattice, f: torch.Tensor):
    """(sum_i f_i e_ix, sum_i f_i e_iy)."""
    return tuple(torch.sum(bcast_1d(lat.e[:, d], f) * f, dim=-3)
                 for d in range(lat.dim))
