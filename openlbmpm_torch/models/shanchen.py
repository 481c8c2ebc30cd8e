"""Shan-Chen pseudopotential multicomponent flow, original SC and the
explicit-forcing scheme EFS (counterpart of
``openlbmpm_tpu/models/shanchen.py``).

State: f (K, 9, ny, nx), one D2Q9 PDF per fluid; with ``storage="bf16"``
the (K, 11, ny, nx) bfloat16 state of ``pack_state_bf16``.

* **SC**: inlet rows, common velocity u', interaction force (D2Q9-weight
  nearest-neighbour stencil plus the solid adhesion field), then per fluid
  one of three forcings: ``shift`` (BGK or MRT toward feq(u' + tau F /
  rho), the reference's production path), ``guo`` (Guo source at the
  barycentric velocity) or ``edm`` (exact difference at u'); pull
  streaming with half-way bounce-back (or the multi-fluid moving-wall link
  bounce-back), outlet rows, and with the Chang corrector BCs the Chang
  rows at the end of the step.
* **EFS** (Porter et al. 2012): the iso-4/8/10 difference-form force, the
  shared equilibrium velocity sum_k (m_k + F_k/2)/tau_k / sum_k rho_k/tau_k,
  and the transformed-PDF update f + (feq - f - f^F/2)/tau + f^F (SRT) or
  its moment-space MRT form.

The open-boundary rows sit ``d`` rows inside the domain, d = the force
stencil's reach (1, or 2 / 3 for EFS iso-8 / iso-10): the inlet row is
ny-1-d with d ghost copies above it, the Zou-He outlet row is d with d
ghost copies below it, and the convective outlet copies rows d+1 ... 0.

``model.path`` says which step runs on a CUDA state, decided here from the
configuration as the JAX model's ``_build_fused`` decides it: "kernel" (the
hand-written CUDA kernel ``csrc/sc2d.cuh``, through ``kernels/shanchen.py``)
for shift forcing with Zou-He or convective rows, "plain" (the composition
of ``ops/`` on the card) for guo/edm forcing, the moving wall, the Chang
BCs and the true convective outlet, which the JAX package also keeps off
its kernel.  A kernel that fails to build or launch raises; the plain step
is never taken in its place.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch
from torch import nn

from .._device import resolve_device, resolve_dtype
from ..geometry import Geometry
from ..kernels.shanchen import (fluid_table, geo_stack, kernel_params,
                                sc_block_step, sc_step)
from ..lattice import D2Q9
from ..ops import boundaries as bc
from ..ops import collision as col
from ..ops import equilibrium as eq
from ..ops import macroscopic as mac
from ..ops import shanchen as sc
from ..ops.forcing import efs_force_pdf, guo_source
from ..ops.streaming import stream, stream_moving_wall, upwind_solid_masks
from .base import kernel_block_step

__all__ = ["ShanChenParams", "SCBoundaryConfig", "ShanChenMCMP",
           "takes_kernel", "zero_pressure_target_error"]


@dataclasses.dataclass(frozen=True)
class ShanChenParams:
    """Same fields and defaults as the JAX package's ShanChenParams.

    g_matrix: (K, K) fluid-fluid coefficients G_ij (symmetric, zero
      diagonal); g_solid: (K,) fluid-solid coefficients; tau: (K,)
      relaxation times; pr_params: Peng-Robinson overrides as (name,
      value) pairs; forcing: shift | guo | edm (original SC only)."""
    g_matrix: tuple
    g_solid: tuple
    tau: tuple
    scheme: Literal["SC", "EFS"] = "SC"
    iso_order: int = 4                      # 4 | 8 | 10 (EFS only)
    collision: Literal["SRT", "MRT"] = "SRT"
    psi: Literal["rho", "PR"] = "rho"       # pseudopotential form
    body_force: tuple[float, float] = (0.0, 0.0)
    pr_params: tuple = ()
    forcing: Literal["shift", "guo", "edm"] = "shift"

    @property
    def num_fluids(self) -> int:
        return len(self.tau)


@dataclasses.dataclass(frozen=True)
class SCBoundaryConfig:
    """Same fields and defaults as the JAX package's SCBoundaryConfig.

    inlet:  periodic | zou_he_velocity | zou_he_pressure | chang_velocity
            | chang_pressure
    outlet: periodic | zou_he_pressure | convective | convective_true
            | chang_pressure
    The per-fluid tuples hold one value for every fluid or one per fluid
    (chang_pressure: their sum is the total target density)."""
    inlet: str = "periodic"
    outlet: str = "periodic"
    inlet_velocity: tuple = (0.0,)
    inlet_density: tuple = (1.0,)
    outlet_density: tuple = (1.0,)


INLETS = ("periodic", "zou_he_velocity", "zou_he_pressure", "chang_velocity",
          "chang_pressure")
OUTLETS = ("periodic", "zou_he_pressure", "convective", "convective_true",
           "chang_pressure")
# the rows the kernel applies (pallas/shanchen.py:153-156 takes these too)
KERNEL_INLETS = ("periodic", "zou_he_velocity", "zou_he_pressure")
KERNEL_OUTLETS = ("periodic", "zou_he_pressure", "convective")


def zero_pressure_target_error(bcs: SCBoundaryConfig, k: int) -> str | None:
    """Why a Zou-He pressure row with a zero per-fluid target is refused,
    or None when every target in use is nonzero."""
    zero = []
    if bcs.inlet == "zou_he_pressure":
        zero += [f"inlet_density[{i}]" for i in range(k)
                 if _per_fluid(bcs.inlet_density, k)[i] == 0]
    if bcs.outlet == "zou_he_pressure":
        zero += [f"outlet_density[{i}]" for i in range(k)
                 if _per_fluid(bcs.outlet_density, k)[i] == 0]
    if not zero:
        return None
    return (f"Zou-He pressure target {' and '.join(zero)} = 0 has no "
            "reference: the JAX jnp rows (ops/boundaries.py::"
            "zou_he_pressure_top/bottom) divide by it and write NaN, and "
            "the JAX Pallas kernel (pallas/shanchen.py, `rt = rho or 1.0`) "
            "divides by 1 instead, imposing a density of 1 on that fluid. "
            "Give every fluid a nonzero target density.")


def takes_kernel(params: ShanChenParams, bcs: SCBoundaryConfig,
                 moving_wall: bool, shape=None) -> bool:
    """Whether K8 runs the configuration on a card: what the JAX fused
    builder takes (shift forcing, Zou-He or convective rows, no moving
    wall, any number of fluids), on a domain of `shape` (ny, nx) of at
    least 8 x 3 (below 8 rows the JAX builder finds no strip of rows and
    returns None; the kernel's outlet rows need 8)."""
    return (not moving_wall and params.forcing == "shift"
            and bcs.inlet in KERNEL_INLETS and bcs.outlet in KERNEL_OUTLETS
            and (shape is None or (shape[0] >= 8 and shape[1] >= 3)))


def _per_fluid(values, k: int) -> tuple:
    v = tuple(float(x) for x in np.atleast_1d(np.asarray(values, np.float64)))
    if len(v) not in (1, k):
        raise ValueError(f"{len(v)} per-fluid values for {k} fluids")
    return v * k if len(v) == 1 else v


class ShanChenMCMP(nn.Module):
    """Multicomponent Shan-Chen flow on a dense masked D2Q9 grid.

    ``dtype`` is the arithmetic type (float32 or float64) and the type of
    the (K, 9, ny, nx) state; ``storage="bf16"`` steps the (K, 11, ny, nx)
    bfloat16 state in float32 arithmetic (kernel configurations only).
    ``moving_wall_mask`` (bool (ny, nx), a subset of the solid nodes) moves
    those walls at ``wall_velocity`` (link bounce-back with each fluid's
    own density).  Geometry planes live as buffers on ``device``.
    ``use_kernel=False`` (the JAX ``use_pallas=False``) runs the plain step
    on every device.
    """

    def __init__(self, geometry: Geometry, params: ShanChenParams,
                 boundaries: SCBoundaryConfig = SCBoundaryConfig(),
                 dtype=torch.float32, device="cuda", storage: str = "f32",
                 moving_wall_mask: np.ndarray | None = None,
                 wall_velocity: tuple[float, float] = (0.0, 0.0),
                 use_kernel: bool = True):
        super().__init__()
        p, b = params, boundaries
        k = p.num_fluids
        if p.scheme not in ("SC", "EFS") or p.collision not in ("SRT", "MRT") \
                or p.psi not in ("rho", "PR") or p.iso_order not in (4, 8, 10):
            raise ValueError("scheme SC | EFS, collision SRT | MRT, psi rho | "
                             "PR, iso_order 4 | 8 | 10")
        if p.forcing not in ("shift", "guo", "edm"):
            raise ValueError(f"forcing {p.forcing!r}: shift | guo | edm")
        if p.forcing != "shift" and p.scheme != "SC":
            raise ValueError("forcing='guo'/'edm' applies to the original-SC "
                             "scheme (EFS has its own explicit forcing)")
        if b.inlet not in INLETS or b.outlet not in OUTLETS:
            raise ValueError(f"inlet {b.inlet!r} / outlet {b.outlet!r}")
        self._chang = b.inlet.startswith("chang") or \
            b.outlet.startswith("chang")
        if self._chang and p.scheme != "SC":
            raise ValueError("Chang 2009 BCs require scheme='SC'")
        if np.asarray(p.g_matrix).shape != (k, k) or len(p.g_solid) != k:
            raise ValueError(f"g_matrix must be {k}x{k} and g_solid hold {k} "
                             "values")
        zero = zero_pressure_target_error(b, k)
        if zero is not None:
            raise ValueError(zero)
        if storage not in ("f32", "bf16"):
            raise ValueError(f"storage {storage!r}: f32 | bf16")
        dtype = resolve_dtype(dtype)
        if storage == "bf16" and dtype != torch.float32:
            raise ValueError("storage='bf16' computes in float32")
        dev = resolve_device(device)
        self.lat = D2Q9
        self.geo = geometry
        self.p = p
        self.bcs = b
        self.k = k
        self.dtype = dtype
        self.storage = storage
        self.tau = np.asarray(p.tau, np.float64)
        self.g_matrix = np.asarray(p.g_matrix, np.float64)
        self.g_solid = np.asarray(p.g_solid, np.float64)
        self.wall_velocity = (float(wall_velocity[0]), float(wall_velocity[1]))
        self._bc_depth = {4: 1, 8: 2, 10: 3}[p.iso_order] \
            if p.scheme == "EFS" else 1
        if p.collision == "MRT":
            self._mrt_s = [col.mrt_relaxation_d2q9_sc(t) for t in self.tau]

        def buf(name, a, dt=dtype):
            self.register_buffer(name, torch.as_tensor(a, dtype=dt,
                                                       device=dev))

        buf("fluid_mask", geometry.is_fluid)
        self.register_buffer("upwind_solid", torch.as_tensor(
            upwind_solid_masks(self.lat, geometry.is_solid), device=dev))
        moving = None
        if moving_wall_mask is not None and any(self.wall_velocity):
            mm = np.asarray(moving_wall_mask, bool)
            if not (mm <= geometry.is_solid).all():
                raise ValueError("moving_wall_mask must lie on solid voxels")
            moving = torch.as_tensor(upwind_solid_masks(self.lat, mm),
                                     device=dev)
        self.register_buffer("upwind_moving", moving)
        fields = sc.build_interaction_fields(geometry.is_solid,
                                             order=p.iso_order)
        for name in ("adhesion", "adhesion_st", "fluid_vec"):
            buf(name, getattr(fields, name))
        self.fields = sc.InteractionFields(fields.stencil, self.adhesion,
                                           self.adhesion_st, self.fluid_vec)
        # per-fluid constants as (K, 1, 1) columns, cast from float64
        buf("tau_k", self.tau.reshape(-1, 1, 1))
        buf("inv_tau_k", (1.0 / self.tau).reshape(-1, 1, 1))
        buf("inlet_velocity", np.reshape(_per_fluid(b.inlet_velocity, k),
                                         (-1, 1)))
        buf("inlet_density", np.reshape(_per_fluid(b.inlet_density, k),
                                        (-1, 1)))
        buf("outlet_density", np.reshape(_per_fluid(b.outlet_density, k),
                                         (-1, 1)))

        self.use_kernel = bool(use_kernel)
        fused = self.use_kernel and takes_kernel(p, b, moving is not None,
                                                 geometry.shape)
        if storage == "bf16" and not fused:
            raise ValueError("storage='bf16' is a kernel layout: this "
                             "configuration runs the plain step only")
        self.path = "kernel" if fused and dev.type == "cuda" else "plain"
        self.kernel_params = None
        self.register_buffer("kernel_table", None)
        if self.path == "kernel":
            self.kernel_params = kernel_params(p, b, geometry)
            buf("kernel_table", fluid_table(p, b), torch.float64)
            buf("geo_planes", geo_stack(geometry, p),
                torch.float32 if storage == "bf16" else dtype)

    @property
    def device(self) -> torch.device:
        return self.fluid_mask.device

    def _row_mask(self, r):
        return self.fluid_mask[r] > 0

    # -- initial conditions ----------------------------------------------
    def init_state_layers(self, rho_main, rho_background,
                          invading_rows: int = 10) -> torch.Tensor:
        """Fluid 0 at its main density on the top `invading_rows` rows, the
        other fluids at theirs below; each fluid at its background density
        elsewhere.  Returns f (K, 9, ny, nx) in ``dtype``."""
        ny, nx = self.geo.shape
        y = np.arange(ny).reshape(-1, 1)
        top = np.broadcast_to(y >= ny - invading_rows, (ny, nx))
        rho = np.empty((self.k, ny, nx), np.float64)
        for i in range(self.k):
            main_region = top if i == 0 else ~top
            rho[i] = np.where(main_region, rho_main[i], rho_background[i])
        return self._feq_init(rho * self.geo.is_fluid)

    def init_state_droplet(self, rho_main, rho_background, center=None,
                           radius: float = 16.0) -> torch.Tensor:
        """A disc of fluid 0 in a bath of the others."""
        ny, nx = self.geo.shape
        if center is None:
            center = (ny / 2.0, nx / 2.0)
        yy, xx = np.mgrid[0:ny, 0:nx]
        inside = (yy - center[0]) ** 2 + (xx - center[1]) ** 2 <= radius ** 2
        rho = np.empty((self.k, ny, nx), np.float64)
        for i in range(self.k):
            region = inside if i == 0 else ~inside
            rho[i] = np.where(region, rho_main[i], rho_background[i])
        return self._feq_init(rho * self.geo.is_fluid)

    def _feq_init(self, rho_k) -> torch.Tensor:
        rho = torch.as_tensor(rho_k, dtype=self.dtype, device=self.device)
        zeros = torch.zeros_like(rho)
        return eq.feq_quadratic(self.lat, rho, (zeros, zeros)) * \
            self.fluid_mask

    # -- bf16 storage ------------------------------------------------------
    def pack_state_bf16(self, f):
        """(K, 9, ny, nx) -> (K, 11, ny, nx) bfloat16: planes 0-8 the
        deviations f_i - w_i rho_k, planes 9 and 10 rho_k as a hi/lo pair,
        all rounded to nearest-even."""
        w = torch.as_tensor(self.lat.w, dtype=f.dtype,
                            device=f.device).reshape(1, 9, 1, 1)
        rho = torch.sum(f, dim=1)
        hi = rho.to(torch.bfloat16)
        lo = (rho - hi.to(f.dtype)).to(torch.bfloat16)
        dev = (f - w * rho[:, None]).to(torch.bfloat16)
        return torch.cat([dev, hi[:, None], lo[:, None]], dim=1)

    def unpack_bf16(self, s):
        """Inverse of ``pack_state_bf16`` (up to the deviations' rounding)."""
        rho = s[:, 9].to(self.dtype) + s[:, 10].to(self.dtype)
        w = torch.as_tensor(self.lat.w, dtype=self.dtype,
                            device=s.device).reshape(1, 9, 1, 1)
        return s[:, :9].to(self.dtype) + w * rho[:, None]

    # -- forces ------------------------------------------------------------
    def _psi(self, rho_k):
        if self.p.psi == "rho":
            return rho_k
        return sc.psi_peng_robinson(rho_k, **dict(self.p.pr_params)) * \
            self.fluid_mask

    def _force(self, rho_k):
        psi = self._psi(rho_k)
        force = sc.interaction_force_sc if self.p.scheme == "SC" \
            else sc.interaction_force_efs
        fx, fy = force(psi, self.g_matrix, self.g_solid, self.fields)
        bfx, bfy = self.p.body_force
        if bfx or bfy:
            fx = fx + bfx * rho_k
            fy = fy + bfy * rho_k
        return fx, fy

    def _mrt_each(self, f, target):
        return torch.stack([col.mrt(f[i], target[i], self.lat, self._mrt_s[i])
                            for i in range(self.k)])

    # -- original Shan-Chen step -------------------------------------------
    def _step_sc(self, f):
        """One original-SC step.  With the Chang BCs the corrector rows move
        to the end of the step, so that the step's input is the state the
        reference saves before its collision (``savePDFLastStep``)."""
        lat = self.lat
        if not self._chang:
            f = self._apply_inlet(f)
        f_old = f
        rho_k = mac.density(f, 2)
        rho_safe = torch.where(rho_k > 0, rho_k, torch.ones_like(rho_k))
        upx, upy = mac.sc_common_velocity(lat, f, rho_k, self.tau)
        fx, fy = self._force(rho_k)
        vy_out = None
        if self.bcs.outlet == "convective_true":
            # |v_y| of row 3, from the physical velocity
            my = mac.momentum(lat, f)[1]
            vy_out = torch.sum(my + 0.5 * fy, dim=0)[3] / \
                torch.sum(rho_safe, dim=0)[3]
        tau_q = self.tau_k[:, None]
        if self.p.forcing == "shift":
            ueq_x = upx[None] + self.tau_k * fx / rho_safe
            ueq_y = upy[None] + self.tau_k * fy / rho_safe
            feq = eq.feq_quadratic(lat, rho_k, (ueq_x, ueq_y))
            if self.p.collision == "MRT":
                f = self._mrt_each(f, feq)
            else:
                f = f - (f - feq) / tau_q
        elif self.p.forcing == "guo":
            mx, my = mac.momentum(lat, f)
            rho_tot = torch.sum(rho_k, dim=0)
            rho_tot = torch.where(rho_tot > 0, rho_tot,
                                  torch.ones_like(rho_tot))
            ux = (torch.sum(mx, dim=0) + 0.5 * torch.sum(fx, dim=0)) / rho_tot
            uy = (torch.sum(my, dim=0) + 0.5 * torch.sum(fy, dim=0)) / rho_tot
            ub = (ux.expand_as(rho_k), uy.expand_as(rho_k))
            feq = eq.feq_quadratic(lat, rho_k, ub)
            src = guo_source(lat, ub, (fx, fy))
            if self.p.collision == "MRT":
                f = torch.stack([
                    col.mrt(f[i], feq[i], lat, self._mrt_s[i]) +
                    col.mrt_force_transform(src[i], lat, self._mrt_s[i])
                    for i in range(self.k)])
            else:
                f = f - (f - feq) / tau_q + (1.0 - 0.5 / tau_q) * src
        else:   # edm: exact difference at the common velocity
            ub = (upx.expand_as(rho_k), upy.expand_as(rho_k))
            feq = eq.feq_quadratic(lat, rho_k, ub)
            dfeq = eq.feq_quadratic(
                lat, rho_k, (ub[0] + fx / rho_safe, ub[1] + fy / rho_safe)) - feq
            if self.p.collision == "MRT":
                f = self._mrt_each(f, feq) + dfeq
            else:
                f = f - (f - feq) / tau_q + dfeq
        f = self._stream(f, rho_k)
        f = self._apply_outlet(f, f_old, vy_out)
        if self._chang:
            f = self._apply_chang(f, f_old)
        return f

    # -- explicit forcing scheme step --------------------------------------
    def _step_efs(self, f):
        """One EFS step on the transformed PDF fbar = f - f^F/2."""
        lat = self.lat
        f = self._apply_inlet(f)
        rho_k = mac.density(f, 2)
        rho_safe = torch.where(rho_k > 0, rho_k, torch.ones_like(rho_k))
        fx, fy = self._force(rho_k)
        mx, my = mac.momentum(lat, f)
        itau = self.inv_tau_k
        den = torch.sum(rho_k * itau, dim=0)
        den = torch.where(den != 0, den, torch.ones_like(den))
        ueq_x = torch.sum((mx + 0.5 * fx) * itau, dim=0) / den
        ueq_y = torch.sum((my + 0.5 * fy) * itau, dim=0) / den
        u = (ueq_x.expand_as(rho_k), ueq_y.expand_as(rho_k))
        feq = eq.feq_quadratic(lat, rho_k, u)
        ff = efs_force_pdf(lat, feq, rho_safe, u, (fx, fy))
        if self.p.collision == "SRT":
            f = f + (feq - f - 0.5 * ff) / self.tau_k[:, None] + ff
        else:
            # mrt returns f - C(f - target); the increment is that minus f
            f = f + (self._mrt_each(f, feq - 0.5 * ff) - f) + ff
        f = self._stream(f, rho_k)
        return self._apply_outlet(f, None)

    def _stream(self, f, rho_k):
        """Pull streaming, masked to the fluid; moving-wall links gain the
        per-fluid wall-momentum term (collision conserves rho_k, so the
        pre-collision densities are exact here)."""
        if self.upwind_moving is not None:
            f = stream_moving_wall(f, self.lat, self.upwind_solid, rho_k,
                                   self.wall_velocity, self.upwind_moving)
        else:
            f = stream(f, self.lat, self.upwind_solid)
        return f * self.fluid_mask

    # -- boundary rows -----------------------------------------------------
    def _apply_inlet(self, f):
        """Inlet rewrite at row ny-1-d, then d ghost rows copy it."""
        ny, d = self.geo.ny, self._bc_depth
        row = ny - 1 - d
        m = self._row_mask
        if self.bcs.inlet == "zou_he_velocity":
            f, _ = bc.zou_he_velocity_top(f, self.inlet_velocity, row, m(row))
        elif self.bcs.inlet == "zou_he_pressure":
            f = bc.zou_he_pressure_top(f, self.inlet_density, row, m(row))
        else:
            return f
        for g in range(row + 1, ny):
            f = bc.copy_row(f, g, row, m(g))
        return f

    def _apply_outlet(self, f, f_old, vy_out=None):
        d = self._bc_depth
        m = self._row_mask
        if self.bcs.outlet == "zou_he_pressure":
            f = bc.zou_he_pressure_bottom(f, self.outlet_density, d, m(d))
            for g in range(d - 1, -1, -1):
                f = bc.copy_row(f, g, d, m(g))
        elif self.bcs.outlet == "convective":
            rows = tuple(range(d + 1, -1, -1))
            f = bc.copy_rows_from_above(f, rows, tuple(m(r) for r in rows))
        elif self.bcs.outlet == "convective_true" and f_old is not None:
            rows = tuple(range(d + 1, -1, -1))
            f = bc.convective_outlet_rows(f, f_old, vy_out, rows,
                                          tuple(m(r) for r in rows))
        return f

    def _apply_chang(self, f, f_old):
        """Chang et al. 2009 corrector rows and their ghost rows: velocity
        inlet at row ny-2 (ghost ny-1), pressure inlet and outlet at rows
        ny-2 and 1 with the total target split by the local density
        fraction (ghosts ny-1 and 0)."""
        ny = self.geo.ny
        row_in, row_out = ny - 2, 1
        m = self._row_mask
        if self.bcs.inlet == "chang_velocity":
            f = bc.chang_velocity_top(f, f_old, self.inlet_velocity, row_in,
                                      m(row_in))
            f = bc.copy_row(f, ny - 1, row_in, m(ny - 1))
        elif self.bcs.inlet == "chang_pressure":
            f = bc.chang_pressure_top(
                f, f_old, self._chang_rho_frac(f, row_in, "inlet"), row_in,
                m(row_in))
            f = bc.copy_row(f, ny - 1, row_in, m(ny - 1))
        if self.bcs.outlet == "chang_pressure":
            f = bc.chang_pressure_bottom(
                f, f_old, self._chang_rho_frac(f, row_out, "outlet"),
                row_out, m(row_out))
            f = bc.copy_row(f, 0, row_out, m(0))
        return f

    def _chang_rho_frac(self, f, row, side):
        """Per-fluid target rho_i / rho_tot * rho_spec on a boundary row,
        rho_spec the sum of the configured per-fluid densities."""
        rho_row = torch.sum(f[..., row, :], dim=-2)
        tot = torch.sum(rho_row, dim=0)
        tot = torch.where(tot != 0, tot, torch.ones_like(tot))
        spec = self.bcs.inlet_density if side == "inlet" \
            else self.bcs.outlet_density
        return rho_row / tot * float(np.sum(spec))

    # -- the step ----------------------------------------------------------
    def _step_impl(self, f):
        """The plain step of the (K, 9, ny, nx) state, composed from
        ``ops/``: the JAX model's jnp ``_step_impl``."""
        return self._step_sc(f) if self.p.scheme == "SC" \
            else self._step_efs(f)

    def plain_step(self, f):
        """``_step_impl`` on any device; a bf16 state is decoded to
        float32, stepped and encoded again, as the kernel does in its
        registers."""
        if self.storage == "bf16":
            return self.pack_state_bf16(self._step_impl(self.unpack_bf16(f)))
        return self._step_impl(f)

    def step(self, f):
        """One time step: K8 when ``path == "kernel"`` (a kernel
        configuration on a card), else the plain step."""
        if self.path == "kernel":
            return sc_step(f, self)
        return self.plain_step(f)

    def make_block_step(self, steps_per_call: int = 4,
                        rows_per_block: int | None = None,
                        interpret: bool = False, storage: str = "f32"):
        """A step that advances ``steps_per_call`` = T time steps per call
        (the JAX ``make_block_step``), the inlet rows rewritten before and
        the outlet rows after every sub-step: on a card one launch of K8-T
        (``kernels/shanchen.py::sc_block_step``; ``build.split_steps``'s
        launches above the largest window) on the (K, 9, ny, nx) state, or
        with ``storage="bf16"`` on the (K, 11, ny, nx) bfloat16 state
        (decoded once and encoded once a launch); on the CPU T plain
        steps.  T = 1 with the model's own storage gives ``step``.

        Returns None for a moving wall, for ``forcing`` other than "shift"
        (the JAX ``make_block_step``, shanchen.py:223-226), for row kinds
        the kernel does not take (pallas/shanchen.py:153-156) and below 8 x
        3 (``takes_kernel``), and with ``use_kernel=False``.
        ``rows_per_block`` and ``interpret`` tune the TPU kernel and are
        ignored."""
        del rows_per_block, interpret
        takes = self.use_kernel and takes_kernel(
            self.p, self.bcs, self.upwind_moving is not None, self.geo.shape)
        return kernel_block_step(self, steps_per_call, storage, takes,
                                 sc_block_step)

    # -- diagnostics -------------------------------------------------------
    def macro(self, f):
        """(rho_k, (ux, uy)): the fluid densities and the barycentric
        velocity (sum_k m_k + F_k/2) / rho_tot of a state as it stands."""
        if f.dtype == torch.bfloat16:
            f = self.unpack_bf16(f)
        rho_k = mac.density(f, 2)
        fx, fy = self._force(rho_k)
        rho_tot = torch.sum(rho_k, dim=0)
        rho_tot = torch.where(rho_tot > 0, rho_tot, torch.ones_like(rho_tot))
        mx, my = mac.momentum(self.lat, f)
        ux = torch.sum(mx + 0.5 * fx, dim=0) / rho_tot
        uy = torch.sum(my + 0.5 * fy, dim=0) / rho_tot
        return rho_k, (ux, uy)

    def pressure(self, rho_k):
        return mac.pressure_sc(rho_k, self.g_matrix)
