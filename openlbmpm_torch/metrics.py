"""Structured run metrics: JSONL logging, flow diagnostics, breakthrough
and steady-state detection (counterpart of ``openlbmpm_tpu/metrics.py``).

The diagnostics take tensors on any device and return Python scalars; the
reductions run on the tensors' device and only the scalars cross to the
host.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

__all__ = ["MetricsLogger", "flow_diagnostics", "steady_state_criterion",
           "measured_contact_angle", "analytic_sc_contact_angle"]


def analytic_sc_contact_angle(g_solid_0: float, g_solid_1: float,
                              g_fluid: float, rho_main: float,
                              rho_dissolved: float) -> float:
    """Analytic Shan-Chen contact angle (Huang et al. 2007), degrees:
    cos(theta) = (G_s1 - G_s0) / (G (rho_main - rho_dissolved) / 2)."""
    cos_t = (g_solid_1 - g_solid_0) / (
        g_fluid * (rho_main - rho_dissolved) / 2.0)
    return float(np.degrees(np.arccos(np.clip(cos_t, -1.0, 1.0))))


def measured_contact_angle(drop_mask: np.ndarray, wall_row: int) -> float:
    """Spherical-cap contact angle from the base chord and the cap height
    of a droplet, degrees.  drop_mask: (ny, nx) bool of droplet nodes;
    wall_row: the first fluid row above the wall."""
    drop = np.asarray(drop_mask, bool).copy()
    drop[:wall_row] = False
    base = float(drop[wall_row].sum())
    height = float(drop.any(axis=1).sum())
    if height == 0 or base == 0:
        return float("nan")
    r_cap = (base ** 2 / 4.0 + height ** 2) / (2.0 * height)
    cos_theta = np.clip((r_cap - height) / r_cap, -1.0, 1.0)
    return float(np.degrees(np.arccos(cos_theta)))


def flow_diagnostics(rho_inv, rho_def, ux, uy, is_fluid,
                     front_threshold: float = 0.5,
                     breakthrough_row: int = 1) -> dict:
    """Scalar diagnostics of a two-fluid field.

    rho_inv / rho_def: invading and defending fluid densities (ny, nx);
    is_fluid: (ny, nx) bool, a tensor or numpy array.  The front is the
    lowest row the invading fluid has reached (the flow runs toward -y,
    the inlet at the top)."""
    fl = torch.as_tensor(is_fluid, device=rho_inv.device)
    m_inv = float(torch.sum(rho_inv * fl))
    m_def = float(torch.sum(rho_def * fl))
    occupied = (rho_inv > front_threshold) & fl
    rows = torch.any(occupied, dim=-1)
    ny = rows.shape[0]
    ids = torch.arange(ny, device=rows.device)
    front = int(torch.min(torch.where(rows, ids, torch.full_like(ids, ny))))
    umax = float(torch.max(torch.sqrt(ux * ux + uy * uy)))
    sat = m_inv / (m_inv + m_def) if (m_inv + m_def) else 0.0
    return {
        "mass_invading": m_inv,
        "mass_defending": m_def,
        "saturation": sat,
        "front_row": front,
        "breakthrough": bool(front <= breakthrough_row),
        "umax": umax,
    }


def steady_state_criterion(ux, uy, ux_prev, uy_prev) -> float:
    """Relative L2 velocity change between two observations."""
    num = torch.sqrt(torch.sum((ux - ux_prev) ** 2 + (uy - uy_prev) ** 2))
    den = torch.sqrt(torch.sum(ux * ux + uy * uy))
    return float(num / torch.where(den > 0, den, torch.ones_like(den)))


class MetricsLogger:
    """JSONL metrics stream + MLUPS meter (the JAX package's record
    format: ``step``, the scalars, then ``mlups`` and ``steps_per_s`` over
    the host time since the previous record)."""

    def __init__(self, path: str | None, active_sites: int,
                 echo: bool = False):
        self.path = path
        self.active_sites = int(active_sites)
        self.echo = echo
        self._fh = open(path, "a") if path else None
        self._t_last = None
        self._steps_last = 0
        self.breakthrough_step = None

    def log(self, step: int, **scalars):
        now = time.perf_counter()
        rec = {"step": int(step), **scalars}
        if self._t_last is not None and step > self._steps_last:
            dt = now - self._t_last
            rec["mlups"] = round(
                self.active_sites * (step - self._steps_last) / dt / 1e6, 2)
            rec["steps_per_s"] = round((step - self._steps_last) / dt, 2)
        self._t_last = now
        self._steps_last = step
        if scalars.get("breakthrough") and self.breakthrough_step is None:
            self.breakthrough_step = int(step)
            rec["breakthrough_step"] = self.breakthrough_step
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.echo:
            print(line, flush=True)
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
