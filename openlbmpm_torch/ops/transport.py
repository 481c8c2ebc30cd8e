"""Solute-transport ops: D2Q5/D2Q9 tracer lattices confined to one fluid
phase (counterpart of ``openlbmpm_tpu/ops/transport.py``; the 3-D form of
``interface_bounce_back`` is ``TransportD3Q7``'s repair).

Tracer PDFs are g (T, Q, ny, nx), or (T, 7, nz, ny, nx) on D3Q7.  The
numpy table builders (``j_coefficients``, ``mrt_matrices_*``) are ported
rather than imported, because the JAX module that holds them imports jax.
The split step's
repairs (``redistribute_on_interface_motion``,
``renormalize_concentration``) keep every total on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice import D2Q5, D2Q9, Lattice
from .common import bcast_1d, e_dot_u, pull, shift

__all__ = [
    "j_coefficients", "mrt_matrices_d2q5", "mrt_matrices_d2q9",
    "mrt_collide", "transport_domain_mask", "interface_partition",
    "interface_bounce_back", "bilinear_reaction", "inamuro_inlet",
    "anti_bounce_back_inlet", "zero_concentration_inlet", "free_flow_outlet",
    "redistribute_on_interface_motion", "renormalize_concentration",
]

_EPS = 1.0e-8


def j_coefficients(j0) -> np.ndarray:
    """(T, 5) J-scheme coefficients: J_0 = j0, J_i = (1 - j0)/4.
    Diffusion D = (1 - J0)(tau - 1/2)/2."""
    j0 = np.atleast_1d(np.asarray(j0, np.float64))
    out = np.empty((j0.size, 5))
    out[:, 0] = j0
    out[:, 1:] = ((1.0 - j0) / 4.0)[:, None]
    return out


def _mrt_matrices(lat: Lattice, flux_x, flux_y, diff_x, diff_y, diff_xy,
                  diff_yx) -> np.ndarray:
    """(T, Q, Q) update matrices -M^-1 S^-1 M, with tau_D = 1/2 + 3 D on
    the flux moments `flux_x` / `flux_y` and the anisotropic coupling
    3 D_xy, 3 D_yx between the first x and y flux moments."""
    diff_x, diff_y, diff_xy, diff_yx = (
        np.atleast_1d(np.asarray(a, np.float64))
        for a in (diff_x, diff_y, diff_xy, diff_yx))
    out = np.empty((diff_x.size, lat.q, lat.q))
    for i in range(diff_x.size):
        S = np.eye(lat.q)
        for r in flux_x:
            S[r, r] = 0.5 + 3.0 * diff_x[i]
        for r in flux_y:
            S[r, r] = 0.5 + 3.0 * diff_y[i]
        S[flux_x[0], flux_y[0]] = 3.0 * diff_xy[i]
        S[flux_y[0], flux_x[0]] = 3.0 * diff_yx[i]
        out[i] = -(lat.M_inv @ np.linalg.inv(S) @ lat.M)
    return out


def mrt_matrices_d2q5(diff_x, diff_y, diff_xy, diff_yx) -> np.ndarray:
    """(T, 5, 5) transport MRT update matrices for the D2Q5 scheme; the
    collision applied is g += U (g - geq)."""
    return _mrt_matrices(D2Q5, (1,), (2,), diff_x, diff_y, diff_xy, diff_yx)


def mrt_matrices_d2q9(diff_x, diff_y, diff_xy, diff_yx) -> np.ndarray:
    """(T, 9, 9) transport MRT update matrices for the D2Q9 scheme."""
    return _mrt_matrices(D2Q9, (3, 4), (5, 6), diff_x, diff_y, diff_xy,
                         diff_yx)


def mrt_collide(g, geq, update_matrices: np.ndarray):
    """g += U (g - geq) per tracer; U (T, Q, Q)."""
    u = torch.as_tensor(update_matrices, dtype=g.dtype, device=g.device)
    return g + torch.einsum("tab,tbyx->tayx", u, g - geq)


def transport_domain_mask(rho_r, criteria: float = 0.5):
    """(in_domain bool, value): tracers live where rho_r < criteria;
    value = -1 inside the transport domain, 0 outside."""
    inside = rho_r < criteria
    value = torch.where(inside, -1.0, 0.0).to(rho_r.dtype)
    return inside, value


def _unit_inward_gradient(gx, gy):
    norm = torch.sqrt(gx * gx + gy * gy)
    safe = norm > _EPS
    n = torch.where(safe, norm, torch.ones_like(norm))
    zero = torch.zeros_like(gx)
    return (torch.where(safe, -gx / n, zero), torch.where(safe, -gy / n, zero),
            safe)


def interface_partition(g, conc, gx, gy, value_domain, beta, lat: Lattice):
    """Semi-permeable interface: g_i += beta_t * value * w_i C cos(theta_i),
    theta_i the angle of e_i to the inward colour-gradient direction."""
    ux, uy, safe = _unit_inward_gradient(gx, gy)
    e_norm = lat.e_norm.copy()
    e_norm[e_norm == 0] = 1.0
    cos_t = (bcast_1d(lat.e[:, 0], g) * ux[None] +
             bcast_1d(lat.e[:, 1], g) * uy[None]) / bcast_1d(e_norm, g)
    cos_t = torch.where(safe[None], cos_t, torch.zeros_like(cos_t))
    moving = np.ones(lat.q)
    moving[0] = 0.0                                       # rest direction
    cos_t = cos_t * bcast_1d(moving, g)
    beta_b = torch.as_tensor(np.atleast_1d(np.asarray(beta, np.float64)),
                             dtype=g.dtype, device=g.device).reshape(-1, 1, 1, 1)
    return g + beta_b * value_domain[None, None] * \
        (bcast_1d(lat.w, g) * cos_t)[None] * conc[:, None]


def interface_bounce_back(g, in_domain, lat: Lattice):
    """Hard interface, after streaming: a population that left a
    transport-domain node x for an outside neighbour y = x + e_i returns
    into the opposite slot at x and is zeroed at y.  g (T, Q, ny, nx) with
    in_domain (ny, nx), or on D3Q7 g (T, 7, nz, ny, nx) with in_domain
    (nz, ny, nx) (``TransportD3Q7._step_impl``).  Direction i reads g_i
    only outside the domain and writes only inside it (slot opp(i)) or
    zeroes outside it (slot i), so reading the unrepaired g gives the
    JAX loop's in-place result."""
    dom = in_domain
    out = g.clone()
    for i in range(1, lat.q):
        d = [int(c) for c in lat.e[i]]
        o = int(lat.opp[i])
        nbr_out = dom & ~shift(dom, *d)
        leaked_at_x = shift(g[:, i], *d)   # g_i at y = x + e_i
        out[:, o] = torch.where(nbr_out, leaked_at_x, out[:, o])
        recv_from_inside = ~dom & pull(dom, *d)
        out[:, i] = torch.where(recv_from_inside, 0.0, out[:, i])
    return out


def bilinear_reaction(g, conc, rate: float, j_coeffs: np.ndarray, stoich):
    """A + B -> C source S_t = stoich_t k C_0 C_1, spread with the J (or
    lattice) weights j_coeffs (T, Q)."""
    r = rate * conc[0] * conc[1]
    st = torch.as_tensor(np.asarray(stoich, np.float64), dtype=g.dtype,
                         device=g.device).reshape(-1, 1, 1)
    j = torch.as_tensor(np.asarray(j_coeffs, np.float64), dtype=g.dtype,
                        device=g.device)[:, :, None, None]
    return g + j * (st * r[None])[:, None]


def _per_tracer_column(values, g):
    return torch.as_tensor(np.asarray(values, np.float64), dtype=g.dtype,
                           device=g.device).reshape(-1, 1)


def inamuro_inlet(g, conc_target, row, mask):
    """Constant-concentration inlet: the unknown population (slot 4, -y
    on D2Q5) absorbs the deficit."""
    known = g[:, 0, row] + g[:, 1, row] + g[:, 2, row] + g[:, 3, row]
    out = g.clone()
    out[:, 4, row] = torch.where(
        mask, _per_tracer_column(conc_target, g) - known, g[:, 4, row])
    return out


def anti_bounce_back_inlet(g, conc_target, row, mask, w3: float = 1.0 / 6.0):
    """Anti-bounce-back constant concentration: the row above `row` gets
    g_4 = -g_3(row) + 2 w_3 C."""
    new = -g[:, 3, row] + 2.0 * w3 * _per_tracer_column(conc_target, g)
    out = g.clone()
    out[:, 4, row + 1] = torch.where(mask, new, g[:, 4, row + 1])
    return out


def zero_concentration_inlet(g, row, mask):
    """`row` copies the full PDF set from the row below."""
    out = g.clone()
    out[:, :, row] = torch.where(mask, g[:, :, row - 1], g[:, :, row])
    return out


def free_flow_outlet(g, rows, mask_rows):
    """Free-flow outlet: each of `rows`, in order, copies the full PDF set
    from the (already rewritten) row above."""
    g = g.clone()
    for row, m in zip(rows, mask_rows):
        g[:, :, row] = torch.where(m, g[:, :, row + 1], g[:, :, row])
    return g


def redistribute_on_interface_motion(g, in_domain_new, in_domain_old,
                                     j_coeffs, lat: Lattice):
    """Tracer repair when the phase interface moves: nodes that left the
    transport domain hand their concentration in equal shares to their
    new-domain neighbours; nodes that entered it take the mean
    concentration of their staying neighbours (the donors), which is
    deducted from those donors.  Entered nodes restart at the equilibrium
    conc * j_coeffs (T, Q); exited nodes are emptied.  g (T, Q, ny, nx);
    in_domain_new/old (ny, nx) bool."""
    conc = torch.sum(g, dim=1)
    exited = in_domain_old & ~in_domain_new
    entered = in_domain_new & ~in_domain_old
    dom_new_f = in_domain_new.to(g.dtype)
    dom_old_f = in_domain_old.to(g.dtype)
    dirs = [(int(lat.e[i, 0]), int(lat.e[i, 1])) for i in range(1, lat.q)]
    one = torch.ones_like(dom_new_f)
    zero = torch.zeros_like(conc)

    nbr_new = torch.zeros_like(dom_new_f)
    for dx, dy in dirs:
        nbr_new = nbr_new + shift(dom_new_f, dx, dy)
    share = torch.where(exited & (nbr_new > 0),
                        conc / torch.where(nbr_new > 0, nbr_new, one), zero)
    received = torch.zeros_like(conc)
    for dx, dy in dirs:
        received = received + shift(share, dx, dy)
    received = received * dom_new_f

    remain_f = dom_old_f * dom_new_f
    nbr_old = torch.zeros_like(dom_old_f)
    donor_sum = torch.zeros_like(conc)
    for dx, dy in dirs:
        nbr_old = nbr_old + shift(remain_f, dx, dy)
        donor_sum = donor_sum + shift(conc * remain_f, dx, dy)
    n_don = torch.where(nbr_old > 0, nbr_old, one)
    borrowed = torch.where((entered & (nbr_old > 0))[None], donor_sum / n_don,
                           zero)
    per_donor = borrowed / n_don
    deduction = torch.zeros_like(conc)
    for dx, dy in dirs:
        deduction = deduction + shift(per_donor, -dx, -dy)
    deduction = deduction * remain_f

    conc_new = torch.where(in_domain_new[None],
                           conc + received + borrowed - deduction, zero)
    j = torch.as_tensor(np.asarray(j_coeffs, np.float64), dtype=g.dtype,
                        device=g.device)[:, :, None, None]
    out = torch.where(exited[None, None], torch.zeros_like(g), g)
    out = torch.where(entered[None, None], conc_new[:, None] * j, out)
    delta = (received + borrowed - deduction)[:, None] * j
    interior = in_domain_new & ~entered
    return torch.where(interior[None, None], out + delta, out)


def renormalize_concentration(g, conc, mass0, in_domain, u_norm_sq,
                              j_or_w, u, lat: Lattice,
                              quadratic: bool = False):
    """The reference's mass repair, as written: on transport-domain nodes
    where the flow moves (|u|^2 > 1e-20) the concentration becomes
    conc + conc * mass0 / total, with total the tracer mass in the domain,
    and the PDFs restart at w_i C (1 + 3 e.u) (plus the quadratic terms
    with `quadratic`).  `mass0` (T,) stays a tensor: nothing leaves the
    device.  `j_or_w` is accepted and unused, as in the reference.
    Returns (g, conc)."""
    total = torch.sum(conc * in_domain[None], dim=(-2, -1))
    total = torch.where(total != 0, total, torch.ones_like(total))
    extra = conc * (mass0.to(conc.dtype) / total).reshape(-1, 1, 1)
    active = in_domain & (u_norm_sq > 1e-20)
    conc_new = torch.where(active[None], conc + extra, conc)
    eu = e_dot_u(lat, u)
    eq_factor = bcast_1d(lat.w, conc) * (1.0 + 3.0 * eu)
    if quadratic:
        uu = (u[0] * u[0] + u[1] * u[1])[None]
        eq_factor = bcast_1d(lat.w, conc) * \
            (1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * uu)
    geq = conc_new[:, None] * eq_factor[None]
    return torch.where(active[None, None], geq, g), conc_new
