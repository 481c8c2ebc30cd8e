"""Rothman-Keller colour-gradient two-phase flow, CSF variant, on the
compressed (f_total, rho_r) state (counterpart of
``openlbmpm_tpu/models/colorgradient.py``).

One step, in the reference's op order: boundary rows, phase field (with the
outlet phi repair), solid-phi extrapolation, isotropic gradient,
contact-angle rotation, CSF force, SRT or MRT collision on the total PDF
with the Guo source, LKR recolouring, pull streaming with half-way
bounce-back.  On a CUDA state the step is one call of the hand-written
kernel (``kernels/csf.py``); on the CPU it is the plain PyTorch composition
of ``ops/``.

Not yet ported (they raise NotImplementedError): the Perturbation variant,
the split (f_r, f_b) step, and the neumann_per_color, convective_average
and modified_periodic boundaries.
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
from ..kernels.csf import csf_step_compressed, geo_stack, kernel_params
from ..ops import boundaries as bc
from ..ops import collision as col
from ..ops import colorgrad as cg
from ..ops import equilibrium as eq
from ..ops import macroscopic as mac
from ..ops.forcing import guo_source
from ..ops.streaming import stream, upwind_solid_masks

__all__ = ["ColorGradientParams", "CGBoundaryConfig", "ColorGradientRK"]


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

    inlet:  periodic | neumann (total-momentum velocity) | dirichlet
            (total-PDF pressure at inlet_density_r + inlet_density_b)
    outlet: periodic | convective (copy trio) | dirichlet (total-PDF
            pressure at outlet_density_r + outlet_density_b)
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
    """Two-phase CSF colour-gradient solver on a dense masked D2Q9 grid.

    ``dtype`` is the arithmetic type (float32 or float64).  ``storage``
    picks the state layout ``step_c`` maps: "f32" the (10, ny, nx) state
    in ``dtype``, "bf16" the (11, ny, nx) bfloat16 state of
    ``pack_state_bf16`` (float32 arithmetic).  The geometry planes are
    buffers on ``device``.
    """

    def __init__(self, geometry: Geometry,
                 params: ColorGradientParams = ColorGradientParams(),
                 boundaries: CGBoundaryConfig = CGBoundaryConfig(),
                 dtype=torch.float32, device="cpu", storage: str = "f32"):
        super().__init__()
        if params.variant != "CSF":
            raise NotImplementedError(
                f"variant {params.variant!r}: only CSF is ported")
        if boundaries.inlet not in ("periodic", "neumann", "dirichlet"):
            raise NotImplementedError(f"inlet {boundaries.inlet!r}")
        if boundaries.outlet not in ("periodic", "convective", "dirichlet"):
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
        self._phi_repair = (boundaries.outlet == "dirichlet"
                            and boundaries.phi_outlet_repair)
        self.kernel_params = kernel_params(params, boundaries, geometry)

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
        f_r = eq.feq_quadratic(self.lat, rr, (zeros, zeros))
        f_b = eq.feq_quadratic(self.lat, rb, (zeros, zeros))
        return f_r * self.fluid_mask, f_b * self.fluid_mask

    # -- compressed state (f_total, rho_r) ----------------------------------
    def pack_state(self, f_r, f_b):
        """(f_r, f_b) -> (10, ny, nx): the total PDF and the red density."""
        return torch.cat([f_r + f_b, mac.density(f_r)[None]], dim=0)

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
        rho = mac.density(s[:9])
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
    def _step_csf_c(self, s):
        """One step of the (10, ny, nx) state composed from ``ops/``: the
        plain version of the kernel."""
        lat, p = self.lat, self.p
        s = self._apply_bcs_c(s)
        rho_r, rho_b, rho = self.rho_fields_c(s)
        phi, gx, gy, fx, fy = self.color_force_fields_from_rho(rho_r, rho_b)
        rho_safe = torch.where(rho > 0, rho, torch.ones_like(rho))
        f_tot = s[:9]
        mx, my = mac.momentum(lat, f_tot)
        ux = (mx + 0.5 * fx) / rho_safe
        uy = (my + 0.5 * fy) / rho_safe
        tau = cg.tau_interp_csf(phi, rho_r, rho_b, p.tau_r, p.tau_b, p.delta,
                                p.tau_type)
        feq = eq.feq_quadratic(lat, rho, (ux, uy))
        src = guo_source(lat, (ux, uy), (fx, fy))
        if p.collision == "SRT":
            f_tot = col.bgk_field_tau(f_tot, feq, tau)
            f_tot = f_tot + (1.0 - 0.5 / tau)[None] * src
        else:
            inv_tau = 1.0 / tau
            f_tot = col.mrt_variable_nu(f_tot, feq, lat, self._mrt_s, inv_tau)
            f_tot = f_tot + col.mrt_force_transform_variable(
                src, lat, self._mrt_s, inv_tau)
        f_r_post, _ = cg.recolor_lkr(f_tot, rho_r, rho_b, gx, gy, p.beta, lat)
        fl = self.fluid_mask
        f_tot = stream(f_tot, lat, self.upwind_solid) * fl
        rho_r_new = mac.density(stream(f_r_post, lat, self.upwind_solid)) * fl
        return torch.cat([f_tot, rho_r_new[None]], dim=0)

    def plain_step_c(self, s):
        """``_step_csf_c`` on either layout, on any device; a bf16 state is
        decoded to ``dtype``, stepped and encoded again."""
        if s.dtype == torch.bfloat16:
            return self.pack_compressed_bf16(
                self._step_csf_c(self.unpack_bf16(s)))
        return self._step_csf_c(s)

    def _step_impl_c(self, s):
        """The kernel on a CUDA state, the plain step on a CPU one."""
        return csf_step_compressed(s, self)

    def step_c(self, s):
        """One time step of the compressed state (layout per ``storage``)."""
        return self._step_impl_c(s)

    def macro_c(self, s):
        """Diagnostics (rho_r, rho_b, phi, (ux, uy)) from a compressed
        state (either layout)."""
        if s.dtype == torch.bfloat16:
            s = self.unpack_bf16(s)
        rho_r, rho_b, rho = self.rho_fields_c(s)
        phi, _, _, fx, fy = self.color_force_fields_from_rho(rho_r, rho_b)
        rho_safe = torch.where(rho > 0, rho, torch.ones_like(rho))
        mx, my = mac.momentum(self.lat, s[:9])
        return (rho_r, rho_b, phi,
                ((mx + 0.5 * fx) / rho_safe, (my + 0.5 * fy) / rho_safe))
