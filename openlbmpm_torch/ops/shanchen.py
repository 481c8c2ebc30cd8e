"""Shan-Chen pseudopotential ops: psi, the interaction forces and the
per-geometry adhesion fields (counterpart of
``openlbmpm_tpu/ops/shanchen.py``).

psi is zero on solid nodes, so the fluid-fluid sums over existing
neighbours are plain weighted shifted sums; the fluid-solid adhesion is a
constant vector field of the geometry times G_s psi_k(x).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..lattice import D2Q9, IsoStencil, ISO_STENCILS
from .common import shift

__all__ = ["psi_identity", "psi_peng_robinson", "InteractionFields",
           "build_interaction_fields", "stencil_weighted_grad",
           "interaction_force_sc", "interaction_force_efs"]

# the original SC force uses the D2Q9 weights (1/9, 1/36) on the nearest
# neighbours, not the iso-4 ones (1/3, 1/12)
D2Q9_STENCIL = IsoStencil(order=0, offsets=D2Q9.e[1:], weights=D2Q9.w[1:])


def psi_identity(rho):
    return rho


def psi_peng_robinson(rho, const_r=1.0, temperature=0.06, coeff_a=1.0,
                      coeff_b=4.0, alpha=1.0, c0=6.0, g=-1.0):
    """psi = sqrt(2 (P_PR - rho/3) / (c0 g)), clipped at 0; psi(0) = 0."""
    p = (rho * const_r * temperature) / (1.0 - coeff_b * rho) - \
        (coeff_a * alpha * rho * rho) / \
        (1.0 + 2.0 * coeff_b * rho - coeff_b * coeff_b * rho * rho)
    arg = 2.0 / (c0 * g) * (p - rho / 3.0)
    return torch.sqrt(torch.clamp_min(arg, 0.0))


@dataclasses.dataclass(frozen=True)
class InteractionFields:
    """Per-geometry constants of the interaction force (float64 numpy
    arrays from ``build_interaction_fields``; a model keeps them as tensors
    on its device).

    adhesion: (2, ny, nx) sum_dir w_dir e_dir [solid at x + e] with the
      D2Q9 weights (original SC solid term).
    adhesion_st: the same with the interaction-stencil weights (EFS).
    fluid_vec: (2, ny, nx) sum_dir w_dir e_dir [fluid at x + e] over the
      interaction stencil (the EFS difference form).
    """

    stencil: IsoStencil
    adhesion: np.ndarray
    adhesion_st: np.ndarray
    fluid_vec: np.ndarray


def _vec_stencil_sum(mask: np.ndarray, offsets, weights) -> np.ndarray:
    out = np.zeros((2,) + mask.shape, dtype=np.float64)
    m = mask.astype(np.float64)
    for (dx, dy), w in zip(offsets, weights):
        s = np.roll(np.roll(m, -int(dy), axis=0), -int(dx), axis=1)
        out[0] += w * dx * s
        out[1] += w * dy * s
    return out


def build_interaction_fields(is_solid: np.ndarray,
                             order: int = 4) -> InteractionFields:
    st = ISO_STENCILS[order]
    is_solid = np.asarray(is_solid, bool)
    return InteractionFields(
        stencil=st,
        adhesion=_vec_stencil_sum(is_solid, D2Q9_STENCIL.offsets,
                                  D2Q9_STENCIL.weights),
        adhesion_st=_vec_stencil_sum(is_solid, st.offsets, st.weights),
        fluid_vec=_vec_stencil_sum(~is_solid, st.offsets, st.weights))


def stencil_weighted_grad(field: torch.Tensor, st: IsoStencil):
    """(sum_dir w e_x field(x + e), sum_dir w e_y field(x + e)) of a field
    (..., ny, nx) that is zero on solid nodes."""
    gx = torch.zeros_like(field)
    gy = torch.zeros_like(field)
    for (dx, dy), w in zip(st.offsets, st.weights):
        s = shift(field, int(dx), int(dy))
        if dx:
            gx = gx + (float(w) * float(dx)) * s
        if dy:
            gy = gy + (float(w) * float(dy)) * s
    return gx, gy


def _mix(g_matrix, v):
    """sum_j G_kj v_j for v (K, ny, nx)."""
    g = torch.as_tensor(np.asarray(g_matrix, np.float64), dtype=v.dtype,
                        device=v.device)
    return torch.einsum("kj,jyx->kyx", g, v)


def _per_fluid(values, like):
    return torch.as_tensor(np.asarray(values, np.float64), dtype=like.dtype,
                           device=like.device).reshape(-1, 1, 1)


def _field(a, like):
    """A fields plane as a tensor in the type and on the device of `like`
    (no copy when it already is one)."""
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def interaction_force_sc(psi_k: torch.Tensor, g_matrix, g_solid,
                         fields: InteractionFields):
    """Original Shan-Chen force on psi_k (K, ny, nx), zero on solid:
    F_k = -psi_k (sum_j G_kj sum_dir w_dir psi_j(x + e) e + G_ks adh(x)).
    `fields` may hold numpy arrays or tensors.  Returns (fx, fy), each
    (K, ny, nx)."""
    vx, vy = stencil_weighted_grad(psi_k, D2Q9_STENCIL)
    gs = _per_fluid(g_solid, psi_k)
    adh = _field(fields.adhesion, psi_k)
    fx = -psi_k * (_mix(g_matrix, vx) + gs * adh[0])
    fy = -psi_k * (_mix(g_matrix, vy) + gs * adh[1])
    return fx, fy


def interaction_force_efs(psi_k: torch.Tensor, g_matrix, g_solid,
                          fields: InteractionFields):
    """Explicit-forcing-scheme force (Porter et al. 2012, iso-4/8/10):
    F_k = -6 psi_k sum_j G_kj sum_dir(fluid) w (psi_j(x + e) - psi_j(x)) e
          - G_ks psi_k adh_st(x)."""
    vx, vy = stencil_weighted_grad(psi_k, fields.stencil)
    fvec = _field(fields.fluid_vec, psi_k)
    adh = _field(fields.adhesion_st, psi_k)
    dvx = vx - psi_k * fvec[0]
    dvy = vy - psi_k * fvec[1]
    gs = _per_fluid(g_solid, psi_k)
    fx = -6.0 * psi_k * _mix(g_matrix, dvx) - gs * psi_k * adh[0]
    fy = -6.0 * psi_k * _mix(g_matrix, dvy) - gs * psi_k * adh[1]
    return fx, fy
