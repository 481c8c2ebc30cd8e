"""Rothman-Keller colour-gradient two-phase flow, CSF and Perturbation
variants (counterpart of ``openlbmpm_tpu/models/colorgradient.py``), on two
state layouts:

* split: the colour PDFs (f_r, f_b), each (9, ny, nx) -- ``step``, the
  state the CLI runs, checkpoints and writes;
* compressed: (f_total, rho_r) as 10 planes, or 11 bfloat16 planes --
  ``step_c``.

CSF step, in the reference's op order: boundary rows, phase field (with
the outlet phi repair), solid-phi extrapolation, isotropic gradient,
contact-angle rotation, CSF force, SRT or MRT collision on the total PDF
with the Guo source, LKR recolouring, pull streaming with half-way
bounce-back.  Perturbation step (Liu et al. 2014): boundary rows, phi (with
the repair), u = m / rho, Grunau tau(phi), RK-original equilibria, SRT or
MRT per colour (split) or on the total PDF (compressed), the perturbation
operator on the gradient of rho_r - rho_b (solid_phi on solids), RK-original
recolouring, pull streaming.  The split layout applies the boundary rows
per colour (the per-colour Zou-He pressure and velocity inlets; the
total-momentum inlet and the total-pressure outlet split by the row's red
fraction); the compressed one can only impose them on the total PDF
(DEVIATIONS.md, "Compressed (f_total, rho_r) state layout") and refuses
the per-colour velocity inlet.  The averaged convective outlet and the
modified periodic seam act after streaming on the split state only.

``path`` says which step runs: "kernel" on a card (one call of the
hand-written kernel, ``kernels/csf.py``: K1/K2/K6 for CSF, K4 for
Perturbation), "plain" on the CPU and, on every device, for the
convective_average and modified_periodic outlets, which the JAX package
also keeps off its kernel.  The plain step is PyTorch composed from
``ops/``; it never stands in for a kernel that fails.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch
from torch import nn

from ..geometry import Geometry, wetting_masks
from ..lattice import D2Q9
from .._device import resolve_device, resolve_dtype
from ..kernels.csf import (csf_block_compressed, csf_block_split,
                           csf_step_compressed, csf_step_split, geo_stack,
                           kernel_params, pert_block_compressed,
                           pert_block_split, pert_step_compressed,
                           pert_step_split)
from ..ops import boundaries as bc
from ..ops import collision as col
from ..ops import colorgrad as cg
from ..ops import equilibrium as eq
from ..ops import macroscopic as mac
from ..ops.common import shift
from ..ops.forcing import guo_source
from ..ops.streaming import stream, upwind_solid_masks
from .base import block_args, t_step

__all__ = ["ColorGradientParams", "CGBoundaryConfig", "ColorGradientRK"]

INLETS = ("periodic", "neumann", "neumann_per_color", "dirichlet")
OUTLETS = ("periodic", "convective", "convective_average", "dirichlet",
           "modified_periodic")
# the outlets the JAX package keeps on its jnp path (colorgradient.py:179)
PLAIN_OUTLETS = ("convective_average", "modified_periodic")
# the rows the T-step kernel rewrites between sub-steps (pallas/csf.py:274-278
# builds no kernel for the others)
BLOCK_INLETS = ("periodic", "neumann", "dirichlet")
BLOCK_OUTLETS = ("periodic", "convective", "dirichlet")


@dataclasses.dataclass(frozen=True)
class ColorGradientParams:
    """Same fields and defaults as the JAX package's ColorGradientParams."""
    tau_r: float = 1.0
    tau_b: float = 1.0
    surface_tension: float = 0.1
    contact_angle_deg: float = 60.0
    beta: float = 0.7                # LKR interface-thickness parameter
    delta: float = 0.98              # tau-interpolation half-width
    tau_type: int = 1                # 1 | 2 (CSF tau(phi) option)
    wetting_type: int = 2            # 1 = Xu 2017 | 2 = Akai 2018
    variant: Literal["CSF", "Perturbation"] = "CSF"
    collision: Literal["SRT", "MRT"] = "SRT"
    solid_phi: float = 0.5           # solid colour diff (Perturbation)
    alpha_r: float = 0.92            # RK equilibrium constants (Perturbation)
    alpha_b: float = 0.2
    a_kr: float = 0.0001             # perturbation strength (Perturbation)
    a_kb: float = 0.0001
    body_force: tuple[float, float] = (0.0, 0.0)
    gradient_type: str = "Isotropic"  # Perturbation gradient weights


@dataclasses.dataclass(frozen=True)
class CGBoundaryConfig:
    """Same fields and defaults as the JAX package's CGBoundaryConfig.

    inlet:  periodic | neumann (total-momentum velocity at inlet_velocity)
            | neumann_per_color (per-colour Zou-He velocity at
            inlet_velocity_r / inlet_velocity_b; split state only) |
            dirichlet (per-colour Zou-He pressure at inlet_density_r /
            inlet_density_b on the split state, their sum on the
            compressed one)
    outlet: periodic | convective (copy trio) | convective_average (after
            streaming, rows 2, 1, 0 become (f_old + |v| f_above) / (1 +
            |v|), v the y velocity of row 3; split state only) | dirichlet
            (total-PDF pressure at outlet_density_r + outlet_density_b) |
            modified_periodic (after streaming, the populations entering
            through the periodic seam swap colours; split state only)
    phi_outlet_repair: at a Dirichlet outlet, phi on rows 1 and 0 is
            replaced by phi on row 2 before the gradient is taken.
    """
    inlet: str = "periodic"
    outlet: str = "periodic"
    phi_outlet_repair: bool = True
    inlet_velocity: float = 0.0
    inlet_velocity_r: float = 0.0
    inlet_velocity_b: float = 0.0
    inlet_density_r: float = 1.0
    inlet_density_b: float = 0.0
    outlet_density_r: float = 0.0
    outlet_density_b: float = 1.0


class ColorGradientRK(nn.Module):
    """Two-phase colour-gradient solver (CSF or Perturbation variant) on a
    dense masked D2Q9 grid.

    ``dtype`` is the arithmetic type (float32 or float64) and the type of
    the split state (f_r, f_b) that ``step`` maps.  ``storage`` picks the
    layout ``step_c`` maps: "f32" the (10, ny, nx) state in ``dtype``,
    "bf16" the (11, ny, nx) bfloat16 state of ``pack_state_bf16`` (float32
    arithmetic); the split state has no bf16 form.  The geometry planes
    are buffers on ``device``.

    A Dirichlet inlet with a zero colour density is refused by the split
    step (plain and kernel alike, ValueError): neither JAX path gives a
    reference for it (``ops/boundaries.py::split_inlet_density_error``).
    The compressed step imposes the summed density and takes it.  The
    compressed step refuses the neumann_per_color inlet (ValueError) and
    the convective_average and modified_periodic outlets
    (NotImplementedError): ``check_compressed``.
    """

    def __init__(self, geometry: Geometry,
                 params: ColorGradientParams = ColorGradientParams(),
                 boundaries: CGBoundaryConfig = CGBoundaryConfig(),
                 dtype=torch.float32, device="cuda", storage: str = "f32",
                 use_kernel: bool = True):
        super().__init__()
        if params.variant not in ("CSF", "Perturbation"):
            raise ValueError(f"variant {params.variant!r}: CSF | Perturbation")
        if boundaries.inlet not in INLETS:
            raise NotImplementedError(f"inlet {boundaries.inlet!r}")
        if boundaries.outlet not in OUTLETS:
            raise NotImplementedError(f"outlet {boundaries.outlet!r}")
        if storage not in ("f32", "bf16"):
            raise ValueError(f"storage {storage!r}: f32 | bf16")
        dtype = resolve_dtype(dtype)
        if storage == "bf16" and dtype != torch.float32:
            raise ValueError("storage='bf16' computes in float32")
        dev = resolve_device(device)
        self.lat = D2Q9
        self.geo = geometry
        self.p = params
        self.bcs = boundaries
        self.dtype = dtype
        self.storage = storage

        # geo_planes: is_fluid, wet_fluid, nsx, nsy, den_inv (geo_stack);
        # the kernel reads them all, the plain path the first four
        self.register_buffer("geo_planes", torch.as_tensor(
            geo_stack(geometry), dtype=dtype, device=dev))
        self.register_buffer("upwind_solid", torch.as_tensor(
            upwind_solid_masks(self.lat, geometry.is_solid), device=dev))
        self.has_wetting = bool(wetting_masks(geometry.is_solid)[1].any())
        self.cos_t, self.sin_t = cg.contact_angle_terms(
            params.contact_angle_deg, params.wetting_type)
        self._mrt_s = col.mrt_relaxation_d2q9_rk()
        if params.variant == "Perturbation":
            self.const_cr = eq.rk_constants(params.alpha_r)
            self.const_cb = eq.rk_constants(params.alpha_b)
            # gradient weights of rho_r - rho_b (1/3 on the axes for
            # "Anisotropic", as the reference names them)
            gs = np.array([0.0] + [1 / 3] * 4 + [1 / 12] * 4) \
                if params.gradient_type == "Anisotropic" else \
                np.array([0.0] + [1.0] * 8)
            self._grad_scheme = gs
        self._phi_repair = (boundaries.outlet == "dirichlet"
                            and boundaries.phi_outlet_repair)
        plain_bcs = boundaries.outlet in PLAIN_OUTLETS
        self.use_kernel = bool(use_kernel)
        self.path = "kernel" if dev.type == "cuda" and not plain_bcs \
            and self.use_kernel else "plain"
        self.kernel_params = None if plain_bcs else \
            kernel_params(params, boundaries, geometry)
        self._split_error = bc.split_inlet_density_error(
            boundaries.inlet_density_r, boundaries.inlet_density_b) \
            if boundaries.inlet == "dirichlet" else None

    @property
    def device(self) -> torch.device:
        return self.geo_planes.device

    @property
    def fluid_mask(self):
        return self.geo_planes[0]

    @property
    def is_fluid(self):
        return self.geo_planes[0] > 0

    @property
    def wet_fluid(self):
        return self.geo_planes[1] > 0

    @property
    def nsx(self):
        return self.geo_planes[2]

    @property
    def nsy(self):
        return self.geo_planes[3]

    def _row_mask(self, r):
        return self.is_fluid[r]

    # -- initial conditions ----------------------------------------------
    def init_state_layers(self, rho_r: float = 1.0, rho_b: float = 1.0,
                          invading_rows: int = 10, background: float = 0.0):
        """Red occupies the top `invading_rows` rows; returns (f_r, f_b)."""
        ny, nx = self.geo.shape
        y = np.arange(ny).reshape(-1, 1)
        top = np.broadcast_to(y >= ny - invading_rows, (ny, nx))
        r = np.where(top, rho_r, background) * self.geo.is_fluid
        b = np.where(top, background, rho_b) * self.geo.is_fluid
        return self._feq_init(r, b)

    def init_state_droplet(self, rho_r: float = 1.0, rho_b: float = 1.0,
                           center=None, radius: float = 16.0,
                           background: float = 0.0):
        """A red disc in blue; returns (f_r, f_b)."""
        ny, nx = self.geo.shape
        if center is None:
            center = (ny / 2.0, nx / 2.0)
        yy, xx = np.mgrid[0:ny, 0:nx]
        inside = (yy - center[0]) ** 2 + (xx - center[1]) ** 2 <= radius ** 2
        r = np.where(inside, rho_r, background) * self.geo.is_fluid
        b = np.where(inside, background, rho_b) * self.geo.is_fluid
        return self._feq_init(r, b)

    def _feq_init(self, rho_r, rho_b):
        rr = torch.as_tensor(rho_r, dtype=self.dtype, device=self.device)
        rb = torch.as_tensor(rho_b, dtype=self.dtype, device=self.device)
        zeros = torch.zeros_like(rr)
        if self.p.variant == "Perturbation":
            f_r = eq.feq_rk_original(self.lat, rr, (zeros, zeros),
                                     self.const_cr)
            f_b = eq.feq_rk_original(self.lat, rb, (zeros, zeros),
                                     self.const_cb)
        else:
            f_r = eq.feq_quadratic(self.lat, rr, (zeros, zeros))
            f_b = eq.feq_quadratic(self.lat, rb, (zeros, zeros))
        return f_r * self.fluid_mask, f_b * self.fluid_mask

    # -- split state (f_r, f_b) ---------------------------------------------
    def _apply_inlet(self, f_r, f_b):
        ny = self.geo.ny
        m = self._row_mask
        if self.bcs.inlet == "neumann":
            f_r, f_b = bc.total_velocity_inlet_top(
                f_r, f_b, self.bcs.inlet_velocity, ny - 2, m(ny - 2))
        elif self.bcs.inlet == "neumann_per_color":
            f_r, _ = bc.zou_he_velocity_top(f_r, self.bcs.inlet_velocity_r,
                                            ny - 2, m(ny - 2))
            f_b, _ = bc.zou_he_velocity_top(f_b, self.bcs.inlet_velocity_b,
                                            ny - 2, m(ny - 2))
        elif self.bcs.inlet == "dirichlet":
            f_r = bc.zou_he_pressure_top(f_r, self.bcs.inlet_density_r,
                                         ny - 2, m(ny - 2))
            f_b = bc.zou_he_pressure_top(f_b, self.bcs.inlet_density_b,
                                         ny - 2, m(ny - 2))
        if self.bcs.inlet != "periodic":
            f_r = bc.copy_row(f_r, ny - 1, ny - 2, m(ny - 1))
            f_b = bc.copy_row(f_b, ny - 1, ny - 2, m(ny - 1))
        return f_r, f_b

    def _apply_outlet(self, f_r, f_b):
        m = self._row_mask
        if self.bcs.outlet == "convective":
            masks = (m(2), m(1), m(0))
            f_r = bc.copy_rows_from_above(f_r, (2, 1, 0), masks)
            f_b = bc.copy_rows_from_above(f_b, (2, 1, 0), masks)
        elif self.bcs.outlet == "dirichlet":
            rho_t = self.bcs.outlet_density_r + self.bcs.outlet_density_b
            f_r, f_b = bc.total_pressure_outlet_bottom(f_r, f_b, rho_t, 1,
                                                       m(1))
            f_r = bc.copy_row(f_r, 0, 1, m(0))
            f_b = bc.copy_row(f_b, 0, 1, m(0))
        return f_r, f_b

    def _post_stream(self, f_r, f_b):
        """The modified periodic seam: after streaming, the populations
        entering rows 0 and ny - 1 across the seam swap colours."""
        if self.bcs.outlet == "modified_periodic":
            ny = self.geo.ny
            f_r, f_b = bc.modified_periodic_color_swap(
                f_r, f_b, self._row_mask(0), self._row_mask(ny - 1))
        return f_r, f_b

    def _apply_convective_average(self, f_r, f_b, f_old, uy):
        """Averaged convective outlet: after streaming, rows 2, 1, 0 (in
        that order) blend their pre-step PDFs f_old (after the boundary
        rows) with the fresh row above, f = (f_old + |v| f_up)/(1 + |v|),
        v the step's y velocity on row 3."""
        m = self._row_mask
        rows, masks = (2, 1, 0), (m(2), m(1), m(0))
        return (bc.convective_outlet_rows(f_r, f_old[0], uy[3], rows, masks),
                bc.convective_outlet_rows(f_b, f_old[1], uy[3], rows, masks))

    def _finish_split(self, f_r, f_b, f_old, uy):
        """Stream both colours, mask to fluid, then the post-stream
        boundaries (modified periodic seam, averaged convective rows)."""
        fl = self.fluid_mask
        f_r = stream(f_r, self.lat, self.upwind_solid) * fl
        f_b = stream(f_b, self.lat, self.upwind_solid) * fl
        f_r, f_b = self._post_stream(f_r, f_b)
        if f_old is not None:
            f_r, f_b = self._apply_convective_average(f_r, f_b, f_old, uy)
        return f_r, f_b

    def color_force_fields(self, f_r, f_b):
        """(rho_r, rho_b, phi, gx, gy, fx, fy) from the colour PDFs."""
        rho_r = mac.density(f_r, 2)
        rho_b = mac.density(f_b, 2)
        return (rho_r, rho_b) + self.color_force_fields_from_rho(rho_r, rho_b)

    def check_split(self):
        """Raise ValueError for a configuration the split step refuses."""
        if self._split_error is not None:
            raise ValueError(self._split_error)

    def _step_csf(self, f_r, f_b):
        """One step of the split state composed from ``ops/``: the plain
        version of the split kernel (the jnp ``_step_csf``)."""
        lat, p = self.lat, self.p
        f_r, f_b = self._apply_inlet(f_r, f_b)
        f_r, f_b = self._apply_outlet(f_r, f_b)
        f_old = (f_r, f_b) if self.bcs.outlet == "convective_average" \
            else None
        rho_r, rho_b, phi, gx, gy, fx, fy = self.color_force_fields(f_r, f_b)
        f_tot = f_r + f_b
        u = self._velocity(f_tot, rho_r + rho_b, fx, fy)
        feq = eq.feq_quadratic(lat, rho_r, u) + eq.feq_quadratic(lat, rho_b, u)
        f_tot = self._collide(f_tot, feq, u, fx, fy, phi, rho_r, rho_b)
        f_r, f_b = cg.recolor_lkr(f_tot, rho_r, rho_b, gx, gy, p.beta, lat)
        return self._finish_split(f_r, f_b, f_old, u[1])

    # -- the Perturbation variant -------------------------------------------
    def _pert_gradient(self, rho_r, rho_b):
        """Gradient of rho_r - rho_b, solid_phi on solid cells, with the
        weights of ``gradient_type`` (no factor 3, no wetting)."""
        fl = self.fluid_mask
        diff = (rho_r - rho_b) * fl + self.p.solid_phi * (1.0 - fl)
        gx = torch.zeros_like(diff)
        gy = torch.zeros_like(diff)
        for i in range(1, 9):
            dx, dy = int(self.lat.e[i, 0]), int(self.lat.e[i, 1])
            w = float(self._grad_scheme[i])
            sh = shift(diff, dx, dy)
            if dx:
                gx = gx + (w * dx) * sh
            if dy:
                gy = gy + (w * dy) * sh
        return gx, gy

    def _pert_fields(self, f_tot, rho_r, rho_b, rho):
        """u = m / rho (no force) and the Grunau tau(phi), phi with the
        outlet repair."""
        rho_safe = torch.where(rho > 0, rho, torch.ones_like(rho))
        phi = cg.phase_field(rho_r, rho_b) * self.fluid_mask
        if self._phi_repair:
            phi = self._repair_phi_rows(phi)
        mx, my = mac.momentum(self.lat, f_tot)
        tau = cg.tau_interp_grunau(phi, self.p.tau_r, self.p.tau_b,
                                   self.p.delta)
        return (mx / rho_safe, my / rho_safe), tau

    def _relax(self, f, feq, tau):
        """SRT, or MRT with s_7 = s_8 = 1/tau(phi), of one PDF stack."""
        if self.p.collision == "MRT":
            return col.mrt_variable_nu(f, feq, self.lat, self._mrt_s,
                                       1.0 / tau)
        return col.bgk_field_tau(f, feq, tau)

    def _step_perturbation(self, f_r, f_b):
        """One Perturbation step of the split state composed from ``ops/``:
        the plain version of the split kernel K4s (the jnp
        ``_step_perturbation``)."""
        lat, p = self.lat, self.p
        f_r, f_b = self._apply_inlet(f_r, f_b)
        f_r, f_b = self._apply_outlet(f_r, f_b)
        f_old = (f_r, f_b) if self.bcs.outlet == "convective_average" \
            else None
        rho_r = mac.density(f_r, 2)
        rho_b = mac.density(f_b, 2)
        u, tau = self._pert_fields(f_r + f_b, rho_r, rho_b, rho_r + rho_b)
        f_r = self._relax(f_r, eq.feq_rk_original(lat, rho_r, u,
                                                  self.const_cr), tau)
        f_b = self._relax(f_b, eq.feq_rk_original(lat, rho_b, u,
                                                  self.const_cb), tau)
        gx, gy = self._pert_gradient(rho_r, rho_b)
        f_r = f_r + cg.perturbation(gx, gy, p.a_kr, cg.B_CONSTANTS, lat)
        f_b = f_b + cg.perturbation(gx, gy, p.a_kb, cg.B_CONSTANTS, lat)
        f_r, f_b = cg.recolor_rk_original(f_r + f_b, rho_r, rho_b, gx, gy,
                                          p.beta, self.const_cr,
                                          self.const_cb, lat)
        return self._finish_split(f_r, f_b, f_old, u[1])

    def plain_step(self, state):
        """``_step_csf`` or ``_step_perturbation`` of the split state
        (f_r, f_b), on any device."""
        self.check_split()
        if self.p.variant == "CSF":
            return self._step_csf(*state)
        return self._step_perturbation(*state)

    def step(self, state):
        """One time step of the split state (f_r, f_b): the kernel when
        ``path`` is "kernel" (K6 for CSF, K4s for Perturbation; a CPU state
        takes the plain version), else the plain step."""
        if self.path == "plain":
            return self.plain_step(state)
        fn = csf_step_split if self.p.variant == "CSF" else pert_step_split
        return fn(tuple(state), self)

    def fields(self, f_r, f_b):
        """(rho_r, rho_b, phi, gx, gy, (ux, uy)) of a split state as it
        stands, boundary rows not applied, u = (m + F/2) / rho."""
        rho_r, rho_b, phi, gx, gy, fx, fy = self.color_force_fields(f_r, f_b)
        u = self._velocity(f_r + f_b, rho_r + rho_b, fx, fy)
        return rho_r, rho_b, phi, gx, gy, u

    def macro(self, state):
        """Diagnostics (rho_r, rho_b, phi, (ux, uy)) of a split state."""
        rho_r, rho_b, phi, _, _, u = self.fields(*state)
        return rho_r, rho_b, phi, u

    # -- compressed state (f_total, rho_r) ----------------------------------
    def pack_state(self, f_r, f_b):
        """(f_r, f_b) -> (10, ny, nx): the total PDF and the red density."""
        return torch.cat([f_r + f_b, mac.density(f_r, 2)[None]], dim=0)

    def pack_compressed_bf16(self, s):
        """(10, ny, nx) state -> the 11-plane bfloat16 state: deviations
        f_i - w_i*fl (9) and rho_r as hi = bf16(rho_r), lo =
        bf16(rho_r - hi), both rounded to nearest-even."""
        w = torch.as_tensor(self.lat.w, dtype=self.dtype,
                            device=s.device).reshape(-1, 1, 1)
        fdev = (s[:9] - w * self.fluid_mask[None]).to(torch.bfloat16)
        hi = s[9].to(torch.bfloat16)
        lo = (s[9] - hi.to(self.dtype)).to(torch.bfloat16)
        return torch.cat([fdev, hi[None], lo[None]], dim=0)

    def pack_state_bf16(self, f_r, f_b):
        """(f_r, f_b) -> the 11-plane bfloat16 state (see
        ``pack_compressed_bf16``)."""
        return self.pack_compressed_bf16(self.pack_state(f_r, f_b))

    def unpack_bf16(self, s):
        """11-plane bfloat16 state -> (10, ny, nx) state in ``dtype``."""
        w = torch.as_tensor(self.lat.w, dtype=self.dtype,
                            device=s.device).reshape(-1, 1, 1)
        f_tot = s[:9].to(self.dtype) + w * self.fluid_mask[None]
        rho_r = s[9].to(self.dtype) + s[10].to(self.dtype)
        return torch.cat([f_tot, rho_r[None]], dim=0)

    def rho_fields_c(self, s):
        rho = mac.density(s[:9], 2)
        rho_r = s[9]
        return rho_r, rho - rho_r, rho

    # -- boundary rows and fields -------------------------------------------
    def _apply_bcs_c(self, s):
        ny = self.geo.ny
        m = self._row_mask
        if self.bcs.inlet == "neumann":
            s = bc.total_velocity_inlet_top_c(
                s, self.bcs.inlet_velocity, ny - 2, m(ny - 2))
            s = bc.copy_row(s, ny - 1, ny - 2, m(ny - 1))
        elif self.bcs.inlet == "dirichlet":
            rho_t = self.bcs.inlet_density_r + self.bcs.inlet_density_b
            s = bc.zou_he_pressure_top_total_c(s, rho_t, ny - 2, m(ny - 2))
            s = bc.copy_row(s, ny - 1, ny - 2, m(ny - 1))
        if self.bcs.outlet == "convective":
            s = bc.copy_rows_from_above(s, (2, 1, 0), (m(2), m(1), m(0)))
        elif self.bcs.outlet == "dirichlet":
            rho_t = self.bcs.outlet_density_r + self.bcs.outlet_density_b
            s = bc.total_pressure_outlet_bottom_c(s, rho_t, 1, m(1))
            s = bc.copy_row(s, 0, 1, m(0))
        return s

    def _repair_phi_rows(self, phi):
        """phi[1] <- phi[2] and phi[0] <- phi[2] on fluid cells (the
        Dirichlet-outlet phi Neumann repair)."""
        src = phi[2]
        phi = phi.clone()
        phi[1] = torch.where(self._row_mask(1), src, phi[1])
        phi[0] = torch.where(self._row_mask(0), src, phi[0])
        return phi

    def color_force_fields_from_rho(self, rho_r, rho_b):
        """phi, wetted gradient and the CSF force (plus body force) from
        the colour densities: (phi, gx, gy, fx, fy)."""
        phi = cg.phase_field(rho_r, rho_b) * self.fluid_mask
        if self._phi_repair:
            phi = self._repair_phi_rows(phi)
        phi_ext = cg.solid_phi_extrapolate(phi, self.is_fluid, self.lat) \
            if self.has_wetting else phi
        gx, gy = cg.color_gradient(phi_ext, self.lat)
        if self.has_wetting:
            rot = (cg.rotate_gradient_on_wetting_xu if self.p.wetting_type == 1
                   else cg.rotate_gradient_on_wetting_akai)
            gx, gy = rot(gx, gy, self.nsx, self.nsy, self.cos_t, self.sin_t,
                         self.wet_fluid)
        fx, fy, _ = cg.csf_force(
            gx, gy, self.p.surface_tension, self.is_fluid,
            inward_normal=(self.p.wetting_type == 2), lat=self.lat)
        bfx, bfy = self.p.body_force
        if bfx or bfy:
            rho = rho_r + rho_b
            fx = fx + bfx * rho
            fy = fy + bfy * rho
        return phi, gx, gy, fx * self.fluid_mask, fy * self.fluid_mask

    # -- the step ------------------------------------------------------------
    def _velocity(self, f_tot, rho, fx, fy):
        """u = (m + F/2) / rho, rho guarded against 0."""
        rho_safe = torch.where(rho > 0, rho, torch.ones_like(rho))
        mx, my = mac.momentum(self.lat, f_tot)
        return (mx + 0.5 * fx) / rho_safe, (my + 0.5 * fy) / rho_safe

    def _collide(self, f_tot, feq, u, fx, fy, phi, rho_r, rho_b):
        """SRT or MRT collision of the total PDF with tau(phi) and the Guo
        source of the force (fx, fy)."""
        lat, p = self.lat, self.p
        tau = cg.tau_interp_csf(phi, rho_r, rho_b, p.tau_r, p.tau_b, p.delta,
                                p.tau_type)
        src = guo_source(lat, u, (fx, fy))
        if p.collision == "SRT":
            f_tot = col.bgk_field_tau(f_tot, feq, tau)
            return f_tot + (1.0 - 0.5 / tau)[None] * src
        inv_tau = 1.0 / tau
        f_tot = col.mrt_variable_nu(f_tot, feq, lat, self._mrt_s, inv_tau)
        return f_tot + col.mrt_force_transform_variable(
            src, lat, self._mrt_s, inv_tau)

    def _step_csf_c(self, s):
        """One step of the (10, ny, nx) state composed from ``ops/``: the
        plain version of the kernel."""
        lat, p = self.lat, self.p
        s = self._apply_bcs_c(s)
        rho_r, rho_b, rho = self.rho_fields_c(s)
        phi, gx, gy, fx, fy = self.color_force_fields_from_rho(rho_r, rho_b)
        f_tot = s[:9]
        u = self._velocity(f_tot, rho, fx, fy)
        feq = eq.feq_quadratic(lat, rho, u)
        f_tot = self._collide(f_tot, feq, u, fx, fy, phi, rho_r, rho_b)
        f_r_post, _ = cg.recolor_lkr(f_tot, rho_r, rho_b, gx, gy, p.beta, lat)
        fl = self.fluid_mask
        f_tot = stream(f_tot, lat, self.upwind_solid) * fl
        rho_r_new = mac.density(stream(f_r_post, lat, self.upwind_solid),
                                2) * fl
        return torch.cat([f_tot, rho_r_new[None]], dim=0)

    def _step_pert_c(self, s):
        """One Perturbation step of the (10, ny, nx) state composed from
        ``ops/``: the plain version of K4c/K4h (the jnp ``_step_pert_c``).
        The per-colour collision with a shared tau(phi) is linear in the
        PDFs, so the total PDF relaxes to the summed equilibria and takes
        the mean perturbation strength."""
        lat, p = self.lat, self.p
        s = self._apply_bcs_c(s)
        rho_r, rho_b, rho = self.rho_fields_c(s)
        f_tot = s[:9]
        u, tau = self._pert_fields(f_tot, rho_r, rho_b, rho)
        feq = eq.feq_rk_original(lat, rho_r, u, self.const_cr) + \
            eq.feq_rk_original(lat, rho_b, u, self.const_cb)
        f_tot = self._relax(f_tot, feq, tau)
        gx, gy = self._pert_gradient(rho_r, rho_b)
        f_tot = f_tot + cg.perturbation(gx, gy, p.a_kr + p.a_kb,
                                        cg.B_CONSTANTS, lat)
        f_r_post, _ = cg.recolor_rk_original(
            f_tot, rho_r, rho_b, gx, gy, p.beta, self.const_cr,
            self.const_cb, lat)
        fl = self.fluid_mask
        f_tot = stream(f_tot, lat, self.upwind_solid) * fl
        rho_r_new = mac.density(stream(f_r_post, lat, self.upwind_solid),
                                2) * fl
        return torch.cat([f_tot, rho_r_new[None]], dim=0)

    def check_compressed(self):
        """Raise for a boundary the compressed step has no form for: the
        averaged convective outlet and the modified periodic seam need the
        per-colour pre-step PDFs (NotImplementedError, as the JAX
        ``_step_impl_c``); the per-colour velocity inlet is refused
        (ValueError) where the JAX compressed step applies no inlet row at
        all (its ``_apply_bcs_c`` has no branch for it)."""
        if self.bcs.outlet in PLAIN_OUTLETS:
            raise NotImplementedError(
                f"{self.bcs.outlet} needs the split state (per-colour "
                "pre-step PDFs / seam colour swap)")
        if self.bcs.inlet == "neumann_per_color":
            raise ValueError(
                "neumann_per_color on the compressed state: the JAX "
                "compressed step (_apply_bcs_c) has no branch for it and "
                "silently applies no inlet row; run the split state (step)")

    def plain_step_c(self, s):
        """``_step_csf_c`` or ``_step_pert_c`` on either layout, on any
        device; a bf16 state is decoded to ``dtype``, stepped and encoded
        again."""
        self.check_compressed()
        fn = self._step_csf_c if self.p.variant == "CSF" \
            else self._step_pert_c
        if s.dtype == torch.bfloat16:
            return self.pack_compressed_bf16(fn(self.unpack_bf16(s)))
        return fn(s)

    def _step_impl_c(self, s):
        """The kernel on a CUDA state (K1/K2 for CSF, K4c/K4h for
        Perturbation), the plain step on a CPU one or with
        ``use_kernel=False``."""
        if not self.use_kernel:
            return self.plain_step_c(s)
        self.check_compressed()
        fn = csf_step_compressed if self.p.variant == "CSF" \
            else pert_step_compressed
        return fn(s, self)

    def step_c(self, s):
        """One time step of the compressed state (layout per ``storage``)."""
        return self._step_impl_c(s)

    def make_block_step(self, steps_per_call: int = 2,
                        rows_per_block: int | None = None,
                        compressed: bool = False, interpret: bool = False,
                        storage: str = "f32",
                        substep_unroll: int | None = None):
        """A step that advances ``steps_per_call`` = T time steps per call
        (the JAX ``make_block_step``), boundary rows rewritten before every
        sub-step: on a card one launch of K3 (``kernels/csf.py``: K3s on the
        split state (f_r, f_b), K3c on the compressed one with
        ``compressed``, K3h on the 11-plane bf16 state with ``storage="bf16"``,
        which is decoded once and encoded once a launch), or
        ``build.split_steps``'s launches for a T above one launch's limit;
        on the CPU T plain steps.  T = 1 gives ``step`` (or ``step_c`` for
        the model's own storage).

        Returns None where the JAX build function builds no kernel on
        grounds of physics or boundaries: an inlet outside periodic / neumann /
        dirichlet or an outlet outside periodic / convective / dirichlet
        (csf.py:274-278), and bf16 storage on the split layout (:243-245);
        None too with ``use_kernel=False``.  ``rows_per_block``,
        ``interpret`` and ``substep_unroll`` tune the TPU kernel's strips
        and are ignored; no shape is refused."""
        del rows_per_block, interpret, substep_unroll
        t = block_args(steps_per_call, storage)
        if self.bcs.inlet not in BLOCK_INLETS or \
                self.bcs.outlet not in BLOCK_OUTLETS or not self.use_kernel:
            return None
        if storage == "bf16" and not compressed:
            return None
        if storage == "bf16" and self.dtype != torch.float32:
            raise ValueError("storage='bf16' computes in float32")
        csf = self.p.variant == "CSF"
        if compressed:
            if t == 1 and storage == self.storage:
                return self.step_c
            fn = csf_block_compressed if csf else pert_block_compressed
            return t_step(fn, self, t)
        if t == 1:
            return self.step
        fn = csf_block_split if csf else pert_block_split
        return t_step(lambda state, m, t: fn(tuple(state), m, t), self, t)

    def fields_c(self, s):
        """(rho_r, rho_b, phi, gx, gy, (ux, uy)) of a compressed state
        (either layout) as it stands, boundary rows not applied, with
        u = (m + F/2) / rho (rho guarded)."""
        if s.dtype == torch.bfloat16:
            s = self.unpack_bf16(s)
        rho_r, rho_b, rho = self.rho_fields_c(s)
        phi, gx, gy, fx, fy = self.color_force_fields_from_rho(rho_r, rho_b)
        return rho_r, rho_b, phi, gx, gy, self._velocity(s[:9], rho, fx, fy)

    def macro_c(self, s):
        """Diagnostics (rho_r, rho_b, phi, (ux, uy)) from a compressed
        state (either layout)."""
        rho_r, rho_b, phi, _, _, u = self.fields_c(s)
        return rho_r, rho_b, phi, u
