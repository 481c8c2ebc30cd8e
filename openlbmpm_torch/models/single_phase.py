"""Single-phase D2Q9 flow (counterpart of
``openlbmpm_tpu/models/single_phase.py``).

State: f (9, ny, nx); with ``storage="bf16"`` the (11, ny, nx) bfloat16
state of ``pack_state_bf16`` (the deviations f_i - w_i rho, then rho as a
hi/lo pair).  One step: rho and u = (m + F/2)/rho with the body force
F = g rho, SRT, TRT or MRT collision with the Guo source, pull streaming
with half-way bounce-back (or the moving-wall link bounce-back), masked to
the fluid, then the row boundary conditions: a Zou-He velocity or pressure
inlet on row ny-2 with its ghost copy on ny-1, and a Zou-He pressure outlet
on row 1 with its ghost copy on row 0, or the convective outlet (rows 2, 1,
0 each copy the row above).  An inlet or outlet kind outside these applies
no row, as in the JAX package.

``model.path`` says which step runs, decided in the constructor as the JAX
fused build function (``pallas/single.py::build_single_phase_fused_step``)
decides whether it returns a kernel: "kernel" (the hand-written CUDA kernel K7,
``csrc/single2d.cuh`` through ``kernels/single.py``) on a card for the
kernel's row kinds without a moving wall, else "plain" (the composition of
``ops/``).  A kernel that fails to build or launch raises; the plain step
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
from ..kernels.single import (kernel_params, single_block_step,
                              single_step)
from ..lattice import D2Q9
from ..ops import boundaries as bc
from ..ops import collision as col
from ..ops import equilibrium as eq
from ..ops import macroscopic as mac
from ..ops.forcing import guo_source
from ..ops.streaming import stream, stream_moving_wall, upwind_solid_masks
from .base import kernel_block_step

__all__ = ["BoundaryConfig", "SinglePhaseD2Q9", "takes_kernel",
           "KERNEL_INLETS", "KERNEL_OUTLETS"]

# the rows K7 applies (pallas/single.py:92-95 takes these and no others)
KERNEL_INLETS = ("periodic", "zou_he_velocity", "zou_he_pressure")
KERNEL_OUTLETS = ("periodic", "zou_he_pressure", "convective")


@dataclasses.dataclass(frozen=True)
class BoundaryConfig:
    """Same fields and defaults as the JAX package's BoundaryConfig.

    inlet:  periodic | zou_he_velocity | zou_he_pressure (row ny-2, ghost
            row ny-1)
    outlet: periodic | zou_he_pressure (row 1, ghost row 0) | convective
            (rows 2, 1, 0 copy the row above)"""
    inlet: str = "periodic"
    outlet: str = "periodic"
    inlet_velocity: float = 0.0       # v_y at the inlet (negative = inflow)
    inlet_density: float = 1.0
    outlet_density: float = 1.0


def takes_kernel(bcs: BoundaryConfig, moving_wall: bool) -> bool:
    """Whether K7 runs the configuration on a card: the row kinds the JAX
    fused build function takes, and no moving wall (its blocked step drops the
    moving wall, ROADMAP section 3)."""
    return (not moving_wall and bcs.inlet in KERNEL_INLETS
            and bcs.outlet in KERNEL_OUTLETS)


def _zero_target_error(bcs: BoundaryConfig) -> str | None:
    zero = [name for name, kind, v in (
        ("inlet_density", bcs.inlet, bcs.inlet_density),
        ("outlet_density", bcs.outlet, bcs.outlet_density))
        if kind == "zou_he_pressure" and v == 0]
    if not zero:
        return None
    return (f"Zou-He pressure target {' and '.join(zero)} = 0 has no "
            "reference: the JAX jnp rows (ops/boundaries.py::"
            "zou_he_pressure_top/bottom) divide by it and write NaN, and the "
            "JAX Pallas kernel (pallas/single.py:97-98, `or 1.0`) divides by "
            "1 instead, imposing a density of 1. Give a nonzero target.")


class SinglePhaseD2Q9(nn.Module):
    """Single-component D2Q9 flow on a dense masked grid: the JAX
    constructor's arguments plus ``device`` and ``storage``.

    ``dtype`` is the arithmetic type (float32 or float64) and the type of
    the (9, ny, nx) state; ``storage="bf16"`` steps the (11, ny, nx)
    bfloat16 state in float32 arithmetic (kernel configurations only).
    ``moving_wall_mask`` (bool (ny, nx), a subset of the solid nodes)
    moves those walls at ``wall_velocity`` (link bounce-back).
    ``use_kernel=False`` (the JAX ``use_pallas=False``) runs the plain step
    on every device."""

    def __init__(self, geometry: Geometry, tau: float = 1.0,
                 collision: Literal["SRT", "TRT", "MRT"] = "SRT",
                 body_force: tuple[float, float] = (0.0, 0.0),
                 boundaries: BoundaryConfig = BoundaryConfig(),
                 dtype=torch.float32, device="cuda", storage: str = "f32",
                 moving_wall_mask: np.ndarray | None = None,
                 wall_velocity: tuple[float, float] = (0.0, 0.0),
                 use_kernel: bool = True):
        super().__init__()
        if collision not in ("SRT", "TRT", "MRT"):
            raise ValueError(f"collision {collision!r}: SRT | TRT | MRT")
        zero = _zero_target_error(boundaries)
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
        self.tau = float(tau)
        self.collision = collision
        self.body_force = (float(body_force[0]), float(body_force[1]))
        self.bcs = boundaries
        self.dtype = dtype
        self.storage = storage
        self.wall_velocity = (float(wall_velocity[0]), float(wall_velocity[1]))
        if collision == "MRT":
            self._s_vec = col.mrt_relaxation_d2q9_sc(self.tau)
        self.register_buffer("fluid_mask", torch.as_tensor(
            geometry.is_fluid, dtype=dtype, device=dev))
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

        self.use_kernel = bool(use_kernel)
        fused = self.use_kernel and takes_kernel(boundaries, moving is not None)
        if storage == "bf16" and not fused:
            raise ValueError("storage='bf16' is a kernel layout: this "
                             "configuration runs the plain step only")
        self.path = "kernel" if fused and dev.type == "cuda" else "plain"
        self.kernel_params = None
        if self.path == "kernel":
            self.kernel_params = kernel_params(self)
            self.register_buffer("fluid_u8", torch.as_tensor(
                geometry.is_fluid, dtype=torch.uint8, device=dev))

    @property
    def device(self) -> torch.device:
        return self.fluid_mask.device

    @property
    def nu(self) -> float:
        """Kinematic viscosity (tau - 1/2)/3."""
        return (self.tau - 0.5) / 3.0

    # -- state ------------------------------------------------------------
    def init_state(self, rho0: float = 1.0, u0=(0.0, 0.0)) -> torch.Tensor:
        """Equilibrium at density rho0 and velocity u0 on the fluid."""
        ny, nx = self.geo.shape
        fl = self.fluid_mask
        full = [torch.full((ny, nx), v, dtype=self.dtype, device=self.device)
                * fl for v in (rho0, u0[0], u0[1])]
        return eq.feq_quadratic(self.lat, full[0], (full[1], full[2]))

    def _w_col(self, dtype, device):
        return torch.as_tensor(self.lat.w, dtype=dtype,
                               device=device).reshape(9, 1, 1)

    def pack_state_bf16(self, f):
        """(9, ny, nx) -> (11, ny, nx) bfloat16: planes 0-8 the deviations
        f_i - w_i rho, planes 9 and 10 rho as a hi/lo pair, all rounded to
        nearest-even."""
        rho = mac.density(f, 2)
        hi = rho.to(torch.bfloat16)
        lo = (rho - hi.to(f.dtype)).to(torch.bfloat16)
        dev = (f - self._w_col(f.dtype, f.device) * rho).to(torch.bfloat16)
        return torch.cat([dev, hi[None], lo[None]], dim=0)

    def unpack_bf16(self, s):
        """Inverse of ``pack_state_bf16`` (up to the deviations' rounding)."""
        rho = s[9].to(self.dtype) + s[10].to(self.dtype)
        return s[:9].to(self.dtype) + self._w_col(self.dtype, s.device) * rho

    # -- physics ----------------------------------------------------------
    def macro(self, f):
        """(rho, (ux, uy)) with the half-force velocity; a bf16 state is
        decoded first."""
        if f.dtype == torch.bfloat16:
            f = self.unpack_bf16(f)
        rho = mac.density(f, 2)
        force = None
        if any(self.body_force):
            force = (self.body_force[0] * rho, self.body_force[1] * rho)
        return rho, mac.velocity(self.lat, f, rho, force)

    def _collide(self, f):
        lat = self.lat
        rho = mac.density(f, 2)
        force = (self.body_force[0] * rho, self.body_force[1] * rho)
        u = mac.velocity(lat, f, rho, force)
        feq = eq.feq_quadratic(lat, rho, u)
        if self.collision == "SRT":
            f = col.bgk(f, feq, self.tau)
        elif self.collision == "TRT":
            f = col.trt(f, feq, lat, self.tau)
        else:
            f = col.mrt(f, feq, lat, self._s_vec)
        if any(self.body_force):
            src = guo_source(lat, u, force)
            if self.collision == "SRT":
                f = f + (1.0 - 0.5 / self.tau) * src
            elif self.collision == "TRT":
                f = f + col.trt_force_transform(src, lat, self.tau)
            else:
                f = f + col.mrt_force_transform(src, lat, self._s_vec)
        return f

    def _row_mask(self, r):
        return self.fluid_mask[r] > 0

    def _apply_bcs(self, f):
        ny = self.geo.ny
        b = self.bcs
        m = self._row_mask
        if b.inlet in ("zou_he_velocity", "zou_he_pressure"):
            if b.inlet == "zou_he_velocity":
                f, _ = bc.zou_he_velocity_top(f, b.inlet_velocity, ny - 2,
                                              m(ny - 2))
            else:
                f = bc.zou_he_pressure_top(f, b.inlet_density, ny - 2,
                                           m(ny - 2))
            f = bc.copy_row(f, ny - 1, ny - 2, m(ny - 1))
        if b.outlet == "zou_he_pressure":
            f = bc.zou_he_pressure_bottom(f, b.outlet_density, 1, m(1))
            f = bc.copy_row(f, 0, 1, m(0))
        elif b.outlet == "convective":
            f = bc.copy_rows_from_above(f, (2, 1, 0), (m(2), m(1), m(0)))
        return f

    def _step_impl(self, f):
        """The plain step of the (9, ny, nx) state, composed from ``ops/``:
        the JAX model's jnp ``_step_impl``."""
        rho = mac.density(f, 2) if self.upwind_moving is not None else None
        f = self._collide(f)
        if self.upwind_moving is not None:
            f = stream_moving_wall(f, self.lat, self.upwind_solid, rho,
                                   self.wall_velocity, self.upwind_moving)
        else:
            f = stream(f, self.lat, self.upwind_solid)
        return self._apply_bcs(f * self.fluid_mask)

    def plain_step(self, f):
        """``_step_impl`` on any device; a bf16 state is decoded to float32,
        stepped and encoded again, as the kernel does in its registers."""
        if self.storage == "bf16":
            return self.pack_state_bf16(self._step_impl(self.unpack_bf16(f)))
        return self._step_impl(f)

    def step(self, f):
        """One time step: K7 when ``path == "kernel"``, else the plain
        step."""
        if self.path == "kernel":
            return single_step(f, self)
        return self.plain_step(f)

    def make_block_step(self, steps_per_call: int = 4,
                        rows_per_block: int | None = None,
                        interpret: bool = False, storage: str = "f32"):
        """A step that advances ``steps_per_call`` = T time steps per call
        (the JAX ``make_block_step``), the boundary rows rewritten after
        every sub-step: on a card one launch of K7-T
        (``kernels/single.py::single_block_step``; ``build.split_steps``'s
        launches above the largest window) on the (9, ny, nx) state, or
        with ``storage="bf16"`` on the (11, ny, nx) bfloat16 state
        (``pack_state_bf16``, decoded once and encoded once a launch); on
        the CPU T plain steps.  T = 1 with the model's own storage gives
        ``step``.

        Returns None for a moving wall (the JAX blocked K7 has no moving
        wall), for row kinds outside K7's (``takes_kernel``) and with
        ``use_kernel=False``.  ``rows_per_block`` and ``interpret`` tune the
        TPU kernel and are ignored."""
        del rows_per_block, interpret
        takes = self.use_kernel and takes_kernel(
            self.bcs, self.upwind_moving is not None)
        return kernel_block_step(self, steps_per_call, storage, takes,
                                 single_block_step)
