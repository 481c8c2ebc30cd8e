"""Collision operators on the total PDF (counterpart of
``openlbmpm_tpu/ops/collision.py``): BGK with a per-node tau and the RK
colour-gradient MRT with per-node shear rates, in the dense M^-1 S M form."""

from __future__ import annotations

import numpy as np
import torch

from ..lattice import Lattice

__all__ = ["bgk_field_tau", "mrt_variable_nu", "mrt_force_transform_variable",
           "mrt_relaxation_d2q9_rk"]


def bgk_field_tau(f, feq, tau_field):
    """BGK with a per-node relaxation time: f - (f - feq) / tau(x)."""
    return f - (f - feq) / tau_field[None]


def _moments(M: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """(Q, ny, nx) -> (Q, ny, nx) moment transform M @ x."""
    Mt = torch.as_tensor(M, dtype=x.dtype, device=x.device)
    return (Mt @ x.reshape(x.shape[0], -1)).reshape(x.shape)


def _relax(m, s_base, inv_tau_field, nu_indices):
    """diag(s) m with s_nu = 1/tau(x) on the shear moments."""
    s = np.asarray(s_base, np.float64).copy()
    s[list(nu_indices)] = 0.0
    nu_sel = np.zeros(m.shape[0], np.float64)
    nu_sel[list(nu_indices)] = 1.0
    shape = (-1, 1, 1)
    sm = torch.as_tensor(s, dtype=m.dtype, device=m.device).reshape(shape) * m
    sel = torch.as_tensor(nu_sel, dtype=m.dtype, device=m.device).reshape(shape)
    return sm + sel * inv_tau_field[None] * m


def mrt_variable_nu(f, feq, lat: Lattice, s_base: np.ndarray, inv_tau_field,
                    nu_indices: tuple[int, ...] = (7, 8)):
    """f - M^-1 S(x) M (f - feq) with s_7 = s_8 = 1/tau(x)."""
    m = _moments(lat.M, f - feq)
    return f - _moments(lat.M_inv,
                        _relax(m, s_base, inv_tau_field, nu_indices))


def mrt_force_transform_variable(src, lat: Lattice, s_base: np.ndarray,
                                 inv_tau_field,
                                 nu_indices: tuple[int, ...] = (7, 8)):
    """M^-1 (I - S(x)/2) M src with per-node shear rates 1/tau(x)."""
    m = _moments(lat.M, src)
    return src - 0.5 * _moments(lat.M_inv,
                                _relax(m, s_base, inv_tau_field, nu_indices))


def mrt_relaxation_d2q9_rk(tau: float | None = None) -> np.ndarray:
    """RK colour-gradient MRT vector: s1=1.64, s2=1.54, s4=s6=1.9; the
    shear rates are 1/tau when given."""
    s = np.zeros(9, np.float64)
    s[1] = 1.64
    s[2] = 1.54
    s[4] = s[6] = 1.9
    if tau is not None:
        s[7] = s[8] = 1.0 / tau
    return s
