"""Rothman-Keller colour-gradient ops (counterpart of
``openlbmpm_tpu/ops/colorgrad.py``): phase field, solid-phi extrapolation,
isotropic gradient, contact-angle rotations (Xu 2017, Akai 2018), curvature
and CSF force, the CSF and Grunau tau(phi), Latva-Kokko-Rothman
recolouring, and the Perturbation variant's perturbation operator and
RK-original recolouring.  The ``*_nd`` forms, the extrapolation and the
gradient take any lattice dimension (fields (ny, nx) or (nz, ny, nx))."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..lattice import D2Q9, Lattice
from .common import bcast_1d, shift

__all__ = [
    "phase_field", "solid_phi_extrapolate", "color_gradient",
    "contact_angle_terms", "rotate_gradient_on_wetting_xu", "rotate_gradient_on_wetting_akai",
    "rotate_gradient_on_wetting_akai_nd", "csf_force", "csf_force_nd",
    "tau_interp_csf", "tau_interp_grunau", "perturbation", "recolor_lkr",
    "recolor_lkr_nd", "recolor_rk_original", "B_CONSTANTS", "B_CONSTANTS_LIU",
]

# Perturbation constants B_i, and the Liu et al. 2014 alternative
B_CONSTANTS = np.array([-4 / 27] + [2 / 27] * 4 + [5 / 108] * 4, np.float64)
B_CONSTANTS_LIU = np.array([-2 / 9] + [1 / 9] * 4 + [1 / 36] * 4, np.float64)

_EPS = 1.0e-8


def _safe(x, ok):
    """x where ok, else 1 (a guarded divisor)."""
    return torch.where(ok, x, torch.ones_like(x))


def contact_angle_terms(contact_angle_deg: float, wetting_type: int):
    """(cos_t, sin_t) the wetting rotations take.  contact_angle_deg is the
    red phase's angle; the Akai rotation (wetting_type 2) constrains the
    into-blue normal, so its cosine flips sign."""
    theta = math.radians(contact_angle_deg)
    flip = -1.0 if wetting_type == 2 else 1.0
    return flip * math.cos(theta), math.sin(theta)


def phase_field(rho_r, rho_b):
    """phi = (rho_R - rho_B) / (rho_R + rho_B), 0 where both vanish."""
    s = rho_r + rho_b
    ok = s != 0
    return torch.where(ok, (rho_r - rho_b) / _safe(s, ok),
                       torch.zeros_like(s))


def _shift_e(a, lat: Lattice, i: int):
    """a(x + e_i) on the lattice's spatial axes."""
    return shift(a, *(int(c) for c in lat.e[i]))


def solid_phi_extrapolate(phi, is_fluid, lat: Lattice = D2Q9):
    """phi on fluid nodes; on solid nodes the w-weighted average of the
    fluid neighbours (0 where a solid node has none)."""
    fl = is_fluid.to(phi.dtype)
    num = torch.zeros_like(phi)
    den = torch.zeros_like(phi)
    for i in range(1, lat.q):
        w = float(lat.w[i])
        fl_n = _shift_e(fl, lat, i)
        num = num + w * fl_n * _shift_e(phi, lat, i)
        den = den + w * fl_n
    ok = den > 0
    phi_solid = torch.where(ok, num / _safe(den, ok), torch.zeros_like(phi))
    return torch.where(is_fluid, phi, phi_solid)


def color_gradient(phi_ext, lat: Lattice = D2Q9):
    """grad phi = 3 sum_i w_i e_i phi(x + e_i); returns the lat.dim
    components (gx, gy[, gz])."""
    g = [torch.zeros_like(phi_ext) for _ in range(lat.dim)]
    for i in range(1, lat.q):
        w = float(lat.w[i])
        s = _shift_e(phi_ext, lat, i)
        for d in range(lat.dim):
            ed = int(lat.e[i, d])
            if ed:
                g[d] = g[d] + (w * ed) * s
    return tuple(3.0 * c for c in g)


def rotate_gradient_on_wetting_xu(gx, gy, nsx, nsy, cos_t, sin_t, wet_mask):
    """Xu 2017: on wetting fluid nodes the gradient takes the direction of
    n_s rotated by +-theta, whichever is closer to its current direction."""
    n1x = nsx * cos_t - nsy * sin_t
    n1y = nsy * cos_t + nsx * sin_t
    n2x = nsx * cos_t + nsy * sin_t
    n2y = nsy * cos_t - nsx * sin_t
    norm = torch.sqrt(gx * gx + gy * gy)
    ok = norm > _EPS
    zero = torch.zeros_like(gx)
    ux = torch.where(ok, gx / _safe(norm, ok), zero)
    uy = torch.where(ok, gy / _safe(norm, ok), zero)
    d1 = torch.sqrt((ux - n1x) ** 2 + (uy - n1y) ** 2)
    d2 = torch.sqrt((ux - n2x) ** 2 + (uy - n2y) ** 2)
    mx = torch.where(d1 < d2, n1x, torch.where(d1 > d2, n2x, nsx))
    my = torch.where(d1 < d2, n1y, torch.where(d1 > d2, n2y, nsy))
    return (torch.where(wet_mask, norm * mx, gx),
            torch.where(wet_mask, norm * my, gy))


def rotate_gradient_on_wetting_akai(gx, gy, nsx, nsy, cos_t, sin_t, wet_mask):
    """Akai 2018: with the inward normal n = -g/|g|, build the two
    directions at angle theta from n_s in the (n_s, n) plane and keep the
    nearer; nodes where the distances tie keep their gradient."""
    norm = torch.sqrt(gx * gx + gy * gy)
    ok = norm > _EPS
    zero = torch.zeros_like(gx)
    ux = torch.where(ok, -gx / _safe(norm, ok), zero)
    uy = torch.where(ok, -gy / _safe(norm, ok), zero)
    dot = torch.clamp(ux * nsx + uy * nsy, -1.0, 1.0)
    theta_gs = torch.arccos(dot)
    sin_gs = torch.sin(theta_gs)
    ok_s = torch.abs(sin_gs) > 1.0e-9
    sin_safe = _safe(sin_gs, ok_s)
    c1 = torch.where(ok_s, sin_t * torch.cos(theta_gs) / sin_safe, zero)
    c2 = torch.where(ok_s, sin_t / sin_safe, zero)
    n1x = (cos_t - c1) * nsx + c2 * ux
    n1y = (cos_t - c1) * nsy + c2 * uy
    n2x = (cos_t + c1) * nsx - c2 * ux
    n2y = (cos_t + c1) * nsy - c2 * uy
    d1 = torch.sqrt((n1x - ux) ** 2 + (n1y - uy) ** 2)
    d2 = torch.sqrt((n2x - ux) ** 2 + (n2y - uy) ** 2)
    pick1 = d1 < d2
    tie = d1 == d2
    gx_new = torch.where(tie, gx, -norm * torch.where(pick1, n1x, n2x))
    gy_new = torch.where(tie, gy, -norm * torch.where(pick1, n1y, n2y))
    return (torch.where(wet_mask, gx_new, gx),
            torch.where(wet_mask, gy_new, gy))


def csf_force(gx, gy, sigma, is_fluid, inward_normal: bool = False,
              lat: Lattice = D2Q9):
    """Continuum surface force F = +-(1/2) sigma kappa grad(phi), with
    kappa = nx ny (dx ny + dy nx) - ny^2 dx nx - nx^2 dy ny of the unit
    normal (outward, or inward -g/|g| for Akai wetting) masked to fluid.
    Returns (fx, fy, kappa)."""
    sign = -1.0 if inward_normal else 1.0
    norm = torch.sqrt(gx * gx + gy * gy)
    ok = norm > (_EPS if inward_normal else 0.0)
    zero = torch.zeros_like(gx)
    fl = is_fluid.to(gx.dtype)
    nhx = torch.where(ok, sign * gx / _safe(norm, ok), zero) * fl
    nhy = torch.where(ok, sign * gy / _safe(norm, ok), zero) * fl
    dx_ny = torch.zeros_like(gx)
    dy_nx = torch.zeros_like(gx)
    dx_nx = torch.zeros_like(gx)
    dy_ny = torch.zeros_like(gx)
    for i in range(1, lat.q):
        dx, dy = int(lat.e[i, 0]), int(lat.e[i, 1])
        w3 = 3.0 * float(lat.w[i])
        sx = shift(nhx, dx, dy)
        sy = shift(nhy, dx, dy)
        if dx:
            dx_ny = dx_ny + (w3 * dx) * sy
            dx_nx = dx_nx + (w3 * dx) * sx
        if dy:
            dy_nx = dy_nx + (w3 * dy) * sx
            dy_ny = dy_ny + (w3 * dy) * sy
    kappa = nhx * nhy * (dx_ny + dy_nx) - nhy * nhy * dx_nx - nhx * nhx * dy_ny
    fx = sign * 0.5 * sigma * kappa * gx
    fy = sign * 0.5 * sigma * kappa * gy
    return fx, fy, kappa


def tau_interp_csf(phi, rho_r, rho_b, tau_r, tau_b, delta, option: int = 1):
    """tau(phi) for the CSF total-PDF collision: option 1 interpolates
    1/(tau - 1/2) linearly in phi, option 2 mixes viscosities harmonically
    by density fraction; |phi| > delta takes the pure-fluid tau."""
    if option == 1:
        tau_mid = 0.5 + 1.0 / ((1.0 + phi) / (2.0 * (tau_r - 0.5)) +
                               (1.0 - phi) / (2.0 * (tau_b - 0.5)))
    elif option == 2:
        s = rho_r + rho_b
        s = _safe(s, s != 0)
        mu_r = 3.0 / (tau_r - 0.5)
        mu_b = 3.0 / (tau_b - 0.5)
        mu = 1.0 / ((rho_r / s) * mu_r + (rho_b / s) * mu_b)
        tau_mid = 3.0 * mu + 0.5
    else:
        raise ValueError(f"unknown tau option {option}")
    return torch.where(phi > delta, torch.full_like(phi, tau_r),
                       torch.where(phi < -delta, torch.full_like(phi, tau_b),
                                   tau_mid))


def tau_interp_grunau(phi, tau_r, tau_b, delta):
    """Grunau et al. quadratic tau(phi) of the Perturbation variant: tau_r
    for phi > delta, one quadratic for 0 < phi <= delta, another for
    -delta <= phi <= 0, tau_b below."""
    s1 = 2.0 * tau_r * tau_b / (tau_r + tau_b)
    s2 = 2.0 * (tau_r - s1) / delta
    s3 = -s2 / (2.0 * delta)
    tau1 = s1 + s2 * phi + s3 * phi * phi
    t2 = 2.0 * (s1 - tau_b) / delta
    t3 = t2 / (2.0 * delta)
    tau2 = s1 + t2 * phi + t3 * phi * phi
    return torch.where(phi > delta, torch.full_like(phi, tau_r),
                       torch.where(phi > 0.0, tau1,
                                   torch.where(phi >= -delta, tau2,
                                               torch.full_like(phi, tau_b))))


def _e_dot_g(gx, gy, lat: Lattice):
    """(Q, ny, nx) e_i . g."""
    return bcast_1d(lat.e[:, 0], gx) * gx[None] + \
        bcast_1d(lat.e[:, 1], gx) * gy[None]


def perturbation(gx, gy, a_coeff, b_constants, lat: Lattice = D2Q9):
    """(A/2) |g| (w_i (e_i . g)^2 / |g|^2 - B_i), (Q, ny, nx); zero where
    |g| = 0."""
    g2 = gx * gx + gy * gy
    norm = torch.sqrt(g2)
    ok = g2 > 0
    eg = _e_dot_g(gx, gy, lat)
    pert = 0.5 * a_coeff * norm[None] * (
        bcast_1d(lat.w, gx) * eg * eg / _safe(g2, ok)[None] -
        bcast_1d(b_constants, gx))
    return torch.where(ok[None], pert, torch.zeros_like(pert))


def _cos_theta_times_enorm(gx, gy, lat: Lattice):
    """(e_i . g)/|g| per direction (cos(theta_i) |e_i|), zero where
    |g| <= 1e-8."""
    norm = torch.sqrt(gx * gx + gy * gy)
    ok = norm > _EPS
    eg = _e_dot_g(gx, gy, lat)
    return torch.where(ok[None], eg / _safe(norm, ok)[None],
                       torch.zeros_like(eg))


def recolor_rk_original(f_total, rho_r, rho_b, gx, gy, beta, const_cr,
                        const_cb, lat: Lattice = D2Q9):
    """Perturbation-variant recolouring of the total PDF:
    f_R = rho_R/rho f + beta rho_R rho_B / rho^2 (rho_R C_R,i +
    rho_B C_B,i) cos(theta_i), cos(theta_i) = (e_i . g)/(|e_i| |g|);
    f_B = (1 - rho_R/rho) f - (the same term).  Returns (f_R, f_B)."""
    rho = rho_r + rho_b
    rho_safe = _safe(rho, rho != 0)
    frac_r = rho_r / rho_safe
    e_norm = lat.e_norm.copy()
    e_norm[e_norm == 0] = 1.0
    cos_t = _cos_theta_times_enorm(gx, gy, lat) / bcast_1d(e_norm, gx)
    feq_rho = rho_r[None] * bcast_1d(const_cr, gx) + \
        rho_b[None] * bcast_1d(const_cb, gx)
    seg = (beta * rho_r * rho_b / (rho_safe * rho_safe))[None] * feq_rho * \
        cos_t
    f_r = frac_r[None] * f_total + seg
    f_b = (1.0 - frac_r)[None] * f_total - seg
    return f_r, f_b


def recolor_lkr(f_total, rho_r, rho_b, gx, gy, beta, lat: Lattice = D2Q9):
    """Latva-Kokko-Rothman segregation of the total PDF:
    f_R = rho_R/rho f + beta rho_R rho_B / rho w_i cos(theta_i) |e_i|,
    f_B = f - f_R.  Returns (f_R, f_B)."""
    rho = rho_r + rho_b
    rho_safe = _safe(rho, rho != 0)
    frac_r = rho_r / rho_safe
    norm = torch.sqrt(gx * gx + gy * gy)
    ok = norm > _EPS
    eg = bcast_1d(lat.e[:, 0], gx) * gx[None] + \
        bcast_1d(lat.e[:, 1], gx) * gy[None]
    cos_enorm = torch.where(ok[None], eg / _safe(norm, ok)[None],
                            torch.zeros_like(eg))
    seg = (beta * rho_r * rho_b / rho_safe)[None] * \
        bcast_1d(lat.w, gx) * cos_enorm
    f_r = frac_r[None] * f_total + seg
    f_b = (1.0 - frac_r)[None] * f_total - seg
    return f_r, f_b


def csf_force_nd(g, sigma, is_fluid, inward_normal: bool = False,
                 lat: Lattice = D2Q9):
    """Dimension-generic CSF force F = +-(1/2) sigma kappa grad(phi) with
    kappa = sum_ab (n_a n_b - delta_ab) d_a n_b of the unit normal masked to
    fluid, the partials by the isotropic stencil.  g: the lat.dim gradient
    components.  Returns (force components, kappa)."""
    dim = lat.dim
    sign = -1.0 if inward_normal else 1.0
    norm = torch.sqrt(sum(c * c for c in g))
    ok = norm > (_EPS if inward_normal else 0.0)
    norm_s = _safe(norm, ok)
    zero = torch.zeros_like(norm)
    fl = is_fluid.to(g[0].dtype)
    nh = [torch.where(ok, sign * c / norm_s, zero) * fl for c in g]
    dn = [[torch.zeros_like(norm) for _ in range(dim)] for _ in range(dim)]
    for i in range(1, lat.q):
        w3 = 3.0 * float(lat.w[i])
        shifted = [_shift_e(nh[b], lat, i) for b in range(dim)]
        for a in range(dim):
            ea = int(lat.e[i, a])
            if not ea:
                continue
            for b in range(dim):
                dn[a][b] = dn[a][b] + (w3 * ea) * shifted[b]
    kappa = torch.zeros_like(norm)
    for a in range(dim):
        for b in range(dim):
            coef = nh[a] * nh[b] - (1.0 if a == b else 0.0)
            kappa = kappa + coef * dn[a][b]
    force = tuple(sign * 0.5 * sigma * kappa * c for c in g)
    return force, kappa


def rotate_gradient_on_wetting_akai_nd(g, ns, cos_t, sin_t, wet_mask):
    """Dimension-generic Akai 2018 rotation: in the plane of (n_s, n = -g/|g|)
    the two directions at angle theta from n_s are (cos_t -+ c1) n_s +- c2 n
    with c1 = sin_t cos(theta_gs) / sin(theta_gs), c2 = sin_t /
    sin(theta_gs), sin(theta_gs) = sqrt(1 - (n . n_s)^2); the nearer one
    wins on wetting fluid nodes, and ties keep their gradient."""
    dim = len(g)
    norm = torch.sqrt(sum(c * c for c in g))
    ok = norm > _EPS
    norm_s = _safe(norm, ok)
    zero = torch.zeros_like(norm)
    u = [torch.where(ok, -c / norm_s, zero) for c in g]
    dot = torch.clamp(sum(u[d] * ns[d] for d in range(dim)), -1.0, 1.0)
    sin_gs = torch.sqrt(torch.clamp_min(1.0 - dot * dot, 0.0))
    ok_s = sin_gs > 1.0e-9
    sin_ok = _safe(sin_gs, ok_s)
    c1 = torch.where(ok_s, sin_t * dot / sin_ok, zero)
    c2 = torch.where(ok_s, sin_t / sin_ok, zero)
    n1 = [(cos_t - c1) * ns[d] + c2 * u[d] for d in range(dim)]
    n2 = [(cos_t + c1) * ns[d] - c2 * u[d] for d in range(dim)]
    d1 = torch.sqrt(sum((n1[d] - u[d]) ** 2 for d in range(dim)))
    d2 = torch.sqrt(sum((n2[d] - u[d]) ** 2 for d in range(dim)))
    pick1 = d1 < d2
    tie = d1 == d2
    out = []
    for d in range(dim):
        rotated = torch.where(tie, g[d],
                              -norm * torch.where(pick1, n1[d], n2[d]))
        out.append(torch.where(wet_mask, rotated, g[d]))
    return tuple(out)


def recolor_lkr_nd(f_total, rho_r, rho_b, g, beta, lat: Lattice):
    """Dimension-generic Latva-Kokko-Rothman segregation of the total PDF
    (Q at -(lat.dim + 1)): f_R = rho_R/rho f + beta rho_R rho_B / rho w_i
    (e_i . g)/|g|, f_B = (1 - rho_R/rho) f - (the same term).  Returns
    (f_R, f_B)."""
    dim = lat.dim
    qax = -(dim + 1)
    rho = rho_r + rho_b
    rho_safe = _safe(rho, rho != 0)
    frac_r = rho_r / rho_safe
    norm = torch.sqrt(sum(c * c for c in g))
    ok = norm > _EPS
    eg = sum(bcast_1d(lat.e[:, d], g[d], dim) * g[d].unsqueeze(qax)
             for d in range(dim))
    cos_enorm = torch.where(ok.unsqueeze(qax),
                            eg / _safe(norm, ok).unsqueeze(qax),
                            torch.zeros_like(eg))
    seg = (beta * rho_r * rho_b / rho_safe).unsqueeze(qax) * \
        bcast_1d(lat.w, f_total, dim) * cos_enorm
    qx = frac_r.unsqueeze(qax)
    return qx * f_total + seg, (1.0 - qx) * f_total - seg
