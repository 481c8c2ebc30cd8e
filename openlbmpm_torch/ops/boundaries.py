"""Boundary conditions as masked row updates on the compressed state
(counterpart of the ``_c`` rows of ``openlbmpm_tpu/ops/boundaries.py``).

The compressed state is s = (10, ny, nx): planes 0-8 the total PDF, plane 9
the red density.  y = 0 is the outlet side and y = ny - 1 the inlet side.
Each function returns a new tensor; the input is not modified.
"""

from __future__ import annotations

import torch

__all__ = ["total_velocity_inlet_top_c", "zou_he_pressure_top_total_c",
           "total_pressure_outlet_bottom_c", "copy_row",
           "copy_rows_from_above"]


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
