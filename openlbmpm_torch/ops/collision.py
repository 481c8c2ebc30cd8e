"""Collision operators (counterpart of ``openlbmpm_tpu/ops/collision.py``):
BGK with a constant or per-node tau, TRT and its force correction, the RK
colour-gradient MRT with per-node shear rates, and the constant-matrix MRT
of the Shan-Chen family, the MRT forms in the dense M^-1 S M form."""

from __future__ import annotations

import numpy as np
import torch

from ..lattice import Lattice

__all__ = ["bgk", "bgk_field_tau", "trt", "trt_force_transform", "mrt",
           "mrt_force_transform", "mrt_variable_nu",
           "mrt_force_transform_variable", "mrt_relaxation_d2q9_sc",
           "mrt_relaxation_d2q9_rk"]


def bgk(f, feq, tau: float):
    """f - (f - feq) / tau with one relaxation time."""
    return f - (f - feq) / tau


def _trt_rates(tau: float, magic: float):
    """(omega_+, omega_-) of the TRT operator with the magic parameter
    Lambda = (tau_+ - 1/2)(tau_- - 1/2)."""
    return 1.0 / tau, 1.0 / (magic / (tau - 0.5) + 0.5)


def _opposite(x, lat: Lattice):
    """x with its Q axis (axis 0) in the order of the opposite directions."""
    return x[torch.as_tensor(np.asarray(lat.opp), device=x.device)]


def trt(f, feq, lat: Lattice, tau: float, magic: float = 3.0 / 16.0):
    """Two-relaxation-time collision of f and feq (Q first): the symmetric
    part of f - feq relaxes at omega_+ = 1/tau, the antisymmetric part at
    omega_- = 1/(magic/(tau - 1/2) + 1/2)."""
    omega_p, omega_m = _trt_rates(tau, magic)
    f_opp, feq_opp = _opposite(f, lat), _opposite(feq, lat)
    f_sym = 0.5 * (f + f_opp)
    f_asym = 0.5 * (f - f_opp)
    feq_sym = 0.5 * (feq + feq_opp)
    feq_asym = 0.5 * (feq - feq_opp)
    return f - omega_p * (f_sym - feq_sym) - omega_m * (f_asym - feq_asym)


def trt_force_transform(src, lat: Lattice, tau: float,
                        magic: float = 3.0 / 16.0):
    """The TRT force correction: the even part of src scaled by
    (1 - omega_+/2), the odd part by (1 - omega_-/2)."""
    omega_p, omega_m = _trt_rates(tau, magic)
    src_opp = _opposite(src, lat)
    even = 0.5 * (src + src_opp)
    odd = 0.5 * (src - src_opp)
    return (1.0 - 0.5 * omega_p) * even + (1.0 - 0.5 * omega_m) * odd


def bgk_field_tau(f, feq, tau_field):
    """BGK with a per-node relaxation time: f - (f - feq) / tau(x)."""
    return f - (f - feq) / tau_field[None]


def _moments(M: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """(Q, ny, nx) -> (Q, ny, nx) moment transform M @ x."""
    Mt = torch.as_tensor(M, dtype=x.dtype, device=x.device)
    return (Mt @ x.reshape(x.shape[0], -1)).reshape(x.shape)


def mrt(f, feq, lat: Lattice, s):
    """f - M^-1 diag(s) M (f - feq) with a constant relaxation vector s;
    f and feq (Q, ny, nx)."""
    C = lat.M_inv @ (np.diag(np.asarray(s, np.float64)) @ lat.M)
    return f - _moments(C, f - feq)


def mrt_force_transform(src, lat: Lattice, s):
    """M^-1 (I - S/2) M src: the MRT Guo-force correction, (1 - s_i/2) per
    moment."""
    C = lat.M_inv @ ((np.eye(lat.q) - 0.5 * np.diag(np.asarray(s, np.float64)))
                     @ lat.M)
    return _moments(C, src)


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


def mrt_relaxation_d2q9_sc(tau: float) -> np.ndarray:
    """Shan-Chen / EFS MRT vector: conserved moments 0, s1 = 0.6,
    s2 = 1.5, s4 = s6 = 1.2, shear s7 = s8 = 1/tau."""
    s = np.zeros(9, np.float64)
    s[1] = 0.6
    s[2] = 1.5
    s[4] = s[6] = 1.2
    s[7] = s[8] = 1.0 / tau
    return s


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
