"""Boundary conditions as masked row updates (counterpart of
``openlbmpm_tpu/ops/boundaries.py``), on the split (f_r, f_b) state, on
the compressed state and on the Shan-Chen stack of fluids.

The split state is a pair of (9, ny, nx) colour PDFs; the compressed state
is s = (10, ny, nx): planes 0-8 the total PDF, plane 9 the red density;
the Shan-Chen state is f = (K, 9, ny, nx), and its per-fluid rows take
targets that broadcast against (K, nx), such as a (K, 1) tensor.
y = 0 is the outlet side and y = ny - 1 the inlet side.  Each function
returns new tensors; the inputs are not modified.
"""

from __future__ import annotations

import torch

__all__ = ["total_velocity_inlet_top", "total_pressure_outlet_bottom",
           "zou_he_velocity_top", "zou_he_pressure_top",
           "zou_he_pressure_bottom", "split_inlet_density_error",
           "total_velocity_inlet_top_c", "zou_he_pressure_top_total_c",
           "total_pressure_outlet_bottom_c", "chang_velocity_top",
           "chang_pressure_top", "chang_pressure_bottom", "copy_row",
           "copy_rows_from_above", "convective_outlet_rows",
           "modified_periodic_color_swap"]


_ZERO_TARGET = (
    "a target density of 0 has no reference: the JAX jnp op "
    "(ops/boundaries.py::zou_he_pressure_top) divides by it and writes NaN "
    "into f4, f7 and f8 of that colour, and the JAX Pallas split kernel "
    "(pallas/csf.py::_apply_bcs_window) divides by 1 instead and writes "
    "f4 = 2/3, f7 = f8 = 1/6, injecting that colour at the inlet")


def split_inlet_density_error(rho_r: float, rho_b: float) -> str | None:
    """Why the split per-colour Zou-He pressure inlet refuses these colour
    target densities, or None when both are nonzero."""
    zero = [f"inlet_density_{c} = 0" for c, v in (("r", rho_r), ("b", rho_b))
            if v == 0]
    if not zero:
        return None
    return (f"split Dirichlet inlet with {' and '.join(zero)}: "
            f"{_ZERO_TARGET}. Give both colours a nonzero inlet density, or "
            "use the compressed step (step_c), which imposes their sum.")


def _set_rows(f, row, news, mask):
    """f (..., 9, ny, nx) with populations {i: value} replaced on `row`
    where `mask`."""
    out = f.clone()
    for i, v in news.items():
        out[..., i, row, :] = torch.where(mask, v, f[..., i, row, :])
    return out


def _split_rows(f_r, f_b, row, news, mask):
    """Total-PDF row values {i: value} split between the colours by the
    row's red fraction, taken before the row is rewritten."""
    rho_r = torch.sum(f_r[:, row, :], dim=0)
    rho_b = torch.sum(f_b[:, row, :], dim=0)
    tot = rho_r + rho_b
    ratio_r = rho_r / torch.where(tot != 0, tot, torch.ones_like(tot))
    ratio_b = 1.0 - ratio_r
    return (_set_rows(f_r, row, {i: ratio_r * v for i, v in news.items()},
                      mask),
            _set_rows(f_b, row, {i: ratio_b * v for i, v in news.items()},
                      mask))


def total_velocity_inlet_top(f_r, f_b, vy, row, mask):
    """Total-momentum velocity inlet (non-equilibrium bounce-back) on a
    top-side row of the split state: the unknown total populations 4, 7, 8
    from f_i = feq_i + (f_opp - feq_opp) at the Zou-He density, split by
    the row's red fraction.  Returns (f_r, f_b)."""
    ft = f_r[:, row, :] + f_b[:, row, :]
    rho = (ft[0] + ft[1] + ft[3] + 2.0 * (ft[2] + ft[5] + ft[6])) / (1.0 + vy)

    def feq(ey, w):
        return _feq_row_1d(rho, w, ey, vy)

    news = {4: feq(-1.0, 1 / 9) + (ft[2] - feq(1.0, 1 / 9)),
            7: feq(-1.0, 1 / 36) + (ft[5] - feq(1.0, 1 / 36)),
            8: feq(-1.0, 1 / 36) + (ft[6] - feq(1.0, 1 / 36))}
    return _split_rows(f_r, f_b, row, news, mask)


def total_pressure_outlet_bottom(f_r, f_b, rho_target, row, mask):
    """Total-PDF Zou-He pressure outlet on a bottom-side row of the split
    state, split by the row's red fraction.  Returns (f_r, f_b)."""
    ft = f_r[:, row, :] + f_b[:, row, :]
    vy = 1.0 - (ft[0] + ft[1] + ft[3] +
                2.0 * (ft[4] + ft[7] + ft[8])) / rho_target
    d31 = 0.5 * (ft[3] - ft[1])
    rv = rho_target * vy
    news = {2: ft[4] + (2.0 / 3.0) * rv,
            5: ft[7] + d31 + rv / 6.0,
            6: ft[8] - d31 + rv / 6.0}
    return _split_rows(f_r, f_b, row, news, mask)


def _row(f, row):
    """The populations of `row`, Q first: (9, ..., nx)."""
    return f[..., row, :].movedim(-2, 0)


def zou_he_velocity_top(f, vy, row, mask):
    """Zou-He velocity (Neumann) inlet on a top-side row of f (..., 9, ny,
    nx); unknowns f4, f7, f8.  Returns (f, rho_row), the Zou-He density of
    the row."""
    r = _row(f, row)
    rho = (r[0] + r[1] + r[3] + 2.0 * (r[2] + r[5] + r[6])) / (1.0 + vy)
    d13 = 0.5 * (r[1] - r[3])
    return _set_rows(f, row, {4: r[2] - (2.0 / 3.0) * rho * vy,
                              7: r[5] + d13 - rho * vy / 6.0,
                              8: r[6] - d13 - rho * vy / 6.0}, mask), rho


def zou_he_pressure_top(f, rho_target, row, mask):
    """Zou-He pressure inlet on a top-side row of f (..., 9, ny, nx);
    unknowns f4, f7, f8.  A number target of 0 raises ValueError (callers
    passing per-fluid tensors check their targets first)."""
    if not torch.is_tensor(rho_target) and rho_target == 0:
        raise ValueError(f"zou_he_pressure_top: {_ZERO_TARGET}")
    r = _row(f, row)
    vy = -1.0 + (r[0] + r[1] + r[3] +
                 2.0 * (r[2] + r[5] + r[6])) / rho_target
    d13 = 0.5 * (r[1] - r[3])
    rv = rho_target * vy
    return _set_rows(f, row, {4: r[2] - (2.0 / 3.0) * rv,
                              7: r[5] + d13 - rv / 6.0,
                              8: r[6] - d13 - rv / 6.0}, mask)


def zou_he_pressure_bottom(f, rho_target, row, mask):
    """Zou-He pressure outlet on a bottom-side row of f (..., 9, ny, nx);
    unknowns f2, f5, f6."""
    r = _row(f, row)
    vy = 1.0 - (r[0] + r[1] + r[3] +
                2.0 * (r[4] + r[7] + r[8])) / rho_target
    d31 = 0.5 * (r[3] - r[1])
    rv = rho_target * vy
    return _set_rows(f, row, {2: r[4] + (2.0 / 3.0) * rv,
                              5: r[7] + d31 + rv / 6.0,
                              6: r[8] - d31 + rv / 6.0}, mask)


def chang_velocity_top(f_new, f_old, vy, row, mask):
    """Chang et al. 2009 corrector velocity inlet on a top-side row, from
    the post-stream PDFs f_new and the pre-collision PDFs f_old (the force
    terms zeroed, as the reference does)."""
    n, o = _row(f_new, row), _row(f_old, row)
    rho = (n[0] + n[1] + n[3] + 2.0 * (n[2] + n[5] + n[6])) / (1.0 + vy)
    rv = rho * vy
    new4 = o[4] - (2.0 / 3.0) * (rv + o[4] + o[7] + o[8]) + \
        (2.0 / 3.0) * (n[2] + n[5] + n[6])
    new7 = o[7] + 0.5 * (n[1] - n[3]) + (n[2] - o[4]) / 6.0 + \
        (2.0 / 3.0) * (n[5] - o[7]) - (n[6] - o[8]) / 3.0 - rv / 6.0
    new8 = o[8] - rv / 6.0 - 0.5 * (n[1] - n[3]) + (n[2] - o[4]) / 6.0 - \
        (n[5] - o[7]) / 3.0 + (2.0 / 3.0) * (n[6] - o[8])
    return _set_rows(f_new, row, {4: new4, 7: new7, 8: new8}, mask)


def chang_pressure_top(f_new, f_old, rho_frac_target, row, mask):
    """Chang et al. 2009 pressure inlet on a top-side row; the per-fluid
    target rho_frac_target (..., nx) is the specified total split by the
    local density fraction."""
    n, o = _row(f_new, row), _row(f_old, row)
    rt = torch.where(rho_frac_target != 0, rho_frac_target,
                     torch.ones_like(rho_frac_target))
    vy = -1.0 + (n[0] + n[1] + n[3] + 2.0 * (n[2] + n[5] + n[6])) / rt
    rv = rho_frac_target * vy
    bal_y = rv + o[7] + o[8] + o[4] - n[2] - n[5] - n[6]
    bal_x = n[3] + n[6] + o[7] - n[1] - n[5] - o[8]
    new4 = o[4] - (2.0 / 3.0) * bal_y
    new7 = o[7] - 0.5 * bal_x - bal_y / 6.0
    # the reference's f8 expression uses f5_old in its balance term
    bal_y8 = rv + o[7] + o[8] + o[4] - n[2] - o[5] - n[6]
    new8 = o[8] + 0.5 * bal_x - bal_y8 / 6.0
    return _set_rows(f_new, row, {4: new4, 7: new7, 8: new8}, mask)


def chang_pressure_bottom(f_new, f_old, rho_frac_target, row, mask):
    """Chang et al. 2009 pressure outlet on a bottom-side row."""
    n, o = _row(f_new, row), _row(f_old, row)
    rt = torch.where(rho_frac_target != 0, rho_frac_target,
                     torch.ones_like(rho_frac_target))
    vy = 1.0 - (n[0] + n[1] + n[3] + 2.0 * (n[4] + n[7] + n[8])) / rt
    rv = rho_frac_target * vy
    bal_y = rv - o[2] + n[4] - o[5] - o[6] + n[7] + n[8]
    bal_x = -n[1] + n[3] - o[5] + o[6] + n[7] - n[8]
    new2 = o[2] + (2.0 / 3.0) * bal_y
    new5 = o[5] + 0.5 * bal_x + bal_y / 6.0
    new6 = o[6] - 0.5 * bal_x + bal_y / 6.0
    return _set_rows(f_new, row, {2: new2, 5: new5, 6: new6}, mask)


def _update_rows_c(s, row, news, mask):
    """Replace total-PDF populations {i: value} on `row` where `mask`, and
    move rho_r by the local red fraction of the change (exact when the row
    is single-phase)."""
    ft = s[..., row, :]
    rho_row = torch.sum(ft[:9], dim=0)
    rho_s = torch.where(rho_row != 0, rho_row, torch.ones_like(rho_row))
    ratio_r = ft[9] / rho_s
    delta = sum(v - ft[i] for i, v in news.items())
    out = s.clone()
    for i, v in news.items():
        out[i, row] = torch.where(mask, v, ft[i])
    out[9, row] = torch.where(mask, ft[9] + ratio_r * delta, ft[9])
    return out


def _feq_row_1d(rho, w_i, ey_i, vy):
    """Row equilibrium for u = (0, vy) in a direction with y-component ey."""
    eu = ey_i * vy
    return rho * w_i * (1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * vy * vy)


def total_velocity_inlet_top_c(s, vy, row, mask):
    """Total-momentum velocity inlet (non-equilibrium bounce-back) on a
    top-side row: the Zou-He density of the total PDF, then
    f_i = feq_i + (f_opp - feq_opp) for the unknowns 4, 7, 8."""
    ft = s[:, row, :]
    rho = (ft[0] + ft[1] + ft[3] + 2.0 * (ft[2] + ft[5] + ft[6])) / (1.0 + vy)

    def feq(ey, w):
        return _feq_row_1d(rho, w, ey, vy)

    news = {4: feq(-1.0, 1 / 9) + (ft[2] - feq(1.0, 1 / 9)),
            7: feq(-1.0, 1 / 36) + (ft[5] - feq(1.0, 1 / 36)),
            8: feq(-1.0, 1 / 36) + (ft[6] - feq(1.0, 1 / 36))}
    return _update_rows_c(s, row, news, mask)


def zou_he_pressure_top_total_c(s, rho_target, row, mask):
    """Total-PDF Zou-He pressure inlet at the summed target density."""
    ft = s[:, row, :]
    vy = -1.0 + (ft[0] + ft[1] + ft[3] +
                 2.0 * (ft[2] + ft[5] + ft[6])) / rho_target
    d13 = 0.5 * (ft[1] - ft[3])
    rv = rho_target * vy
    news = {4: ft[2] - (2.0 / 3.0) * rv,
            7: ft[5] + d13 - rv / 6.0,
            8: ft[6] - d13 - rv / 6.0}
    return _update_rows_c(s, row, news, mask)


def total_pressure_outlet_bottom_c(s, rho_target, row, mask):
    """Total-PDF Zou-He pressure outlet on a bottom-side row."""
    ft = s[:, row, :]
    vy = 1.0 - (ft[0] + ft[1] + ft[3] +
                2.0 * (ft[4] + ft[7] + ft[8])) / rho_target
    d31 = 0.5 * (ft[3] - ft[1])
    rv = rho_target * vy
    news = {2: ft[4] + (2.0 / 3.0) * rv,
            5: ft[7] + d31 + rv / 6.0,
            6: ft[8] - d31 + rv / 6.0}
    return _update_rows_c(s, row, news, mask)


def copy_row(f, dst_row, src_row, mask):
    """Copy every plane of src_row into dst_row where mask (ghost rows)."""
    out = f.clone()
    out[..., dst_row, :] = torch.where(mask, f[..., src_row, :],
                                       f[..., dst_row, :])
    return out


def copy_rows_from_above(f, rows, mask_rows):
    """Plain convective outlet: each listed row copies the row above, in
    order (rows (2, 1, 0) each pick up the fresh copy above them)."""
    for row, m in zip(rows, mask_rows):
        f = copy_row(f, row, row + 1, m)
    return f


def convective_outlet_rows(f_new, f_old, vy_row, rows, mask_rows):
    """True convective outlet: each listed row, in order, becomes
    (f_old + |v| f_above) / (1 + |v|) with f_above the row above it in
    f_new (already rewritten) and vy_row (nx,) the reference row's
    velocity."""
    speed = torch.abs(vy_row)
    for row, m in zip(rows, mask_rows):
        val = (f_old[..., row, :] + speed * f_new[..., row + 1, :]) / \
            (1.0 + speed)
        f_new = f_new.clone()
        f_new[..., row, :] = torch.where(m, val, f_new[..., row, :])
    return f_new


def modified_periodic_color_swap(f_r, f_b, mask_bottom, mask_top):
    """Swap the incoming populations between the colours at the periodic
    seam: on row 0 the upward ones (2, 5, 6) where mask_bottom, on row
    ny - 1 the downward ones (4, 7, 8) where mask_top.  Returns
    (f_r, f_b)."""
    ny = f_r.shape[-2]
    out_r, out_b = f_r.clone(), f_b.clone()
    for row, pops, m in ((0, (2, 5, 6), mask_bottom),
                         (ny - 1, (4, 7, 8), mask_top)):
        for i in pops:
            r, b = f_r[..., i, row, :], f_b[..., i, row, :]
            out_r[..., i, row, :] = torch.where(m, b, r)
            out_b[..., i, row, :] = torch.where(m, r, b)
    return out_r, out_b
