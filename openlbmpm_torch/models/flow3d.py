"""D3Q19 flow: single-phase, Shan-Chen for K fluids and the Rothman-Keller
colour-gradient two-phase model (CSF variant), and D3Q7 tracer transport
confined to one of its phases (counterparts of ``SinglePhaseD3Q19``,
``ShanChenMCMP3D``, ``ColorGradientRK3D``, ``TransportD3Q7`` and
``TransportRK3D`` in ``openlbmpm_tpu/models/flow3d.py``).

Arrays are indexed [z, y, x]; e components are (x, y, z).

``SinglePhaseD3Q19`` (state (19, nz, ny, nx)) collides with SRT or TRT and
the Guo body force and pull-streams with half-way bounce-back, periodic on
every face; on a card ``step`` is K11 (``kernels/flow3d.py``) for SRT and
TRT.  ``ShanChenMCMP3D`` (state (K, 19, nz, ny, nx)) is the original
Shan-Chen scheme with psi = rho: the D3Q19-weight interaction force plus
the static adhesion field and the body force, the common velocity u' and
per fluid SRT toward feq(u' + tau_k F_k / rho_k); on a card ``step`` is
K10 for psi = "rho" and any number of fluids (above three the runtime-K
instance).  Both store 21 bfloat16 planes a fluid under ``storage="bf16"``
(kernel configurations only).  Their ``make_block_step`` gives T steps a
call: on a card one launch of K11-T / K10-T (``build.split_steps``'s
launches above a launch's limit), on the CPU T plain steps.
``path`` is decided in the constructor as the JAX build functions decide
whether they return a kernel; a kernel that fails to build or launch
raises.  Every model takes ``use_kernel=False`` (the JAX ``use_pallas=
False``): the plain step on every device, and no ``make_block_step``.

The colour-gradient flow runs along -z: the inlet is the top z slabs, the
outlet the bottom ones.  Two state layouts:

* split: the colour PDFs (f_r, f_b), each (19, nz, ny, nx) -- ``step``;
* compressed: (f_total, rho_r) as 20 planes, or 21 bfloat16 planes (the
  deviations f_i - w_i*fl, then rho_r as a hi/lo pair) -- ``step_c``.

One step: the z-face boundary slabs (NEBB velocity inlet at z = nz-2 with a
ghost copy to nz-1; a convective outlet copying z = 2, 1, 0 from above, or
the NEBB pressure outlet at z = 1 with a ghost copy to 0), then phase field,
solid-phi extrapolation, isotropic gradient, Akai contact-angle rotation,
CSF force, SRT collision of the total PDF with tau(phi) and the Guo source,
LKR recolouring and pull streaming with half-way bounce-back.  The split
step applies the slabs per colour (``_apply_inlet``/``_apply_outlet``); the
compressed one follows the JAX package's compressed kernel prologue
(``pallas/cg3d.py::_bc_prologue_c``), which moves rho_r by the slab's red
fraction of the change of the total PDF.  The two agree where a slab holds
one phase.

On a CUDA state a step is one call of the hand-written kernel
(``kernels/cg3d.py``); on the CPU it is the plain composition of ``ops/``.

The coupled model ``TransportRK3D`` advances (f_r, f_b, g) or (s, g), g the
(T, 7, nz, ny, nx) tracer PDFs in the arithmetic type (float32 under bf16
flow storage): the flow's boundary slabs, then the tracer on the post-slab,
pre-collision velocity and rho_r, then the flow's collision and streaming.
Its compressed step ``step_c`` is one kernel call on a card; its split
step ``step`` is the plain composition everywhere, as the JAX package has
no split coupled kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np
import torch
from torch import nn

from .._device import resolve_device, resolve_dtype
from ..geometry import Geometry
from ..kernels.cg3d import (cg3d_block_compressed, cg3d_block_split,
                            cg3d_step_compressed, cg3d_step_split,
                            coupled3d_step_compressed, geo_stack3,
                            kernel_params, tracer3d_params, tracer3d_table)
from ..kernels.flow3d import (geo_stack_sc3, sc3d_block_step, sc3d_params,
                              sc3d_step, sc3d_table, single3d_block_step,
                              single3d_params, single3d_step)
from ..lattice import D3Q7, D3Q19
from ..ops import collision as col
from ..ops import colorgrad as cg
from ..ops import equilibrium as eq
from ..ops import macroscopic as mac
from ..ops import transport as tr
from ..ops.common import shift
from ..ops.forcing import guo_source
from ..ops.streaming import stream, upwind_solid_masks
from .base import block_args, kernel_block_step, t_step
from .transport import _per_tracer

__all__ = ["SinglePhaseD3Q19", "ShanChenParams3D", "ShanChenMCMP3D",
           "ColorGradientParams3D", "CG3DBoundaryConfig", "ColorGradientRK3D",
           "TransportD3Q7", "TransportRK3D"]


def _pack_bf16(f, lat):
    """(..., 19, nz, ny, nx) -> (..., 21, ...) bfloat16: the deviations
    f_i - w_i rho and rho as a hi/lo pair, rounded to nearest-even."""
    rho = mac.density(f, 3)
    w = torch.as_tensor(lat.w, dtype=f.dtype, device=f.device).reshape(
        19, 1, 1, 1)
    hi = rho.to(torch.bfloat16)
    lo = (rho - hi.to(f.dtype)).to(torch.bfloat16)
    dev = (f - w * rho.unsqueeze(-4)).to(torch.bfloat16)
    return torch.cat([dev, hi.unsqueeze(-4), lo.unsqueeze(-4)], dim=-4)


def _unpack_bf16(s, lat, dtype):
    """Inverse of ``_pack_bf16`` in `dtype` (up to the deviations'
    rounding)."""
    rho = s[..., 19, :, :, :].to(dtype) + s[..., 20, :, :, :].to(dtype)
    w = torch.as_tensor(lat.w, dtype=dtype, device=s.device).reshape(
        19, 1, 1, 1)
    return s[..., :19, :, :, :].to(dtype) + w * rho.unsqueeze(-4)


def _check_storage(storage, dtype, fused):
    if storage not in ("f32", "bf16"):
        raise ValueError(f"storage {storage!r}: f32 | bf16")
    if storage == "bf16" and dtype != torch.float32:
        raise ValueError("storage='bf16' computes in float32")
    if storage == "bf16" and not fused:
        raise ValueError("storage='bf16' is a kernel layout: this "
                         "configuration runs the plain step only")


class SinglePhaseD3Q19(nn.Module):
    """Single-component D3Q19 flow on a dense masked grid: the JAX
    constructor's arguments (without ``use_pallas``) plus ``device`` and
    ``storage``.  ``collision`` other than "SRT" collides with TRT, as the
    JAX step does; K11 takes SRT and TRT ("MRT" runs the plain step, as the
    JAX build function returns no kernel for it)."""

    def __init__(self, geometry: Geometry, tau: float = 1.0,
                 collision: Literal["SRT", "TRT"] = "SRT",
                 body_force=(0.0, 0.0, 0.0), dtype=torch.float32,
                 device="cuda", storage: str = "f32",
                 use_kernel: bool = True):
        super().__init__()
        dtype = resolve_dtype(dtype)
        dev = resolve_device(device)
        self.use_kernel = bool(use_kernel)
        fused = self.use_kernel and collision in ("SRT", "TRT")
        _check_storage(storage, dtype, fused)
        self.lat = D3Q19
        self.geo = geometry
        self.tau = float(tau)
        self.collision = collision
        self.body_force = tuple(float(v) for v in body_force)
        self.dtype = dtype
        self.storage = storage
        self.register_buffer("fluid_mask", torch.as_tensor(
            geometry.is_fluid, dtype=dtype, device=dev))
        self.register_buffer("upwind_solid", torch.as_tensor(
            upwind_solid_masks(self.lat, geometry.is_solid), device=dev))
        self.path = "kernel" if fused and dev.type == "cuda" else "plain"
        self.kernel_params = None
        if self.path == "kernel":
            self.kernel_params = single3d_params(self)
            self.register_buffer("fluid_u8", torch.as_tensor(
                geometry.is_fluid, dtype=torch.uint8, device=dev))

    @property
    def device(self) -> torch.device:
        return self.fluid_mask.device

    @property
    def nu(self) -> float:
        return (self.tau - 0.5) / 3.0

    def init_state(self, rho0: float = 1.0):
        """Rest equilibrium at density rho0 on the fluid."""
        rho = torch.full(self.geo.shape, rho0, dtype=self.dtype,
                         device=self.device) * self.fluid_mask
        z = torch.zeros_like(rho)
        return eq.feq_quadratic(self.lat, rho, (z, z, z))

    def pack_state_bf16(self, f):
        """(19, nz, ny, nx) -> (21, nz, ny, nx) bfloat16."""
        return _pack_bf16(f, self.lat)

    def unpack_bf16(self, s):
        return _unpack_bf16(s, self.lat, self.dtype)

    def macro(self, f):
        """(rho, (ux, uy, uz)) with the half-force velocity; a bf16 state is
        decoded first."""
        if f.dtype == torch.bfloat16:
            f = self.unpack_bf16(f)
        rho = mac.density(f, 3)
        force = tuple(b * rho for b in self.body_force) \
            if any(self.body_force) else None
        return rho, mac.velocity(self.lat, f, rho, force)

    def collide(self, f):
        """The plain step's collision of a (19, ...) stack of cells (any
        spatial extent): SRT or TRT with the Guo source."""
        lat = self.lat
        rho = mac.density(f, 3)
        force = tuple(b * rho for b in self.body_force)
        u = mac.velocity(lat, f, rho, force)
        feq = eq.feq_quadratic(lat, rho, u)
        if self.collision == "SRT":
            f = col.bgk(f, feq, self.tau)
            if any(self.body_force):
                src = guo_source(lat, u, force)
                f = f + (1.0 - 0.5 / self.tau) * src
        else:
            f = col.trt(f, feq, lat, self.tau)
            if any(self.body_force):
                src = guo_source(lat, u, force)
                f = f + col.trt_force_transform(src, lat, self.tau)
        return f

    def _step_impl(self, f):
        """The plain step, composed from ``ops/``: the JAX model's jnp
        ``_step_impl``."""
        return stream(self.collide(f), self.lat, self.upwind_solid) * \
            self.fluid_mask

    def plain_step(self, f):
        """``_step_impl`` on any device; a bf16 state is decoded to float32,
        stepped and encoded again, as the kernel does in its registers."""
        if self.storage == "bf16":
            return self.pack_state_bf16(self._step_impl(self.unpack_bf16(f)))
        return self._step_impl(f)

    def step(self, f):
        """One time step: K11 when ``path == "kernel"``, else the plain
        step."""
        if self.path == "kernel":
            return single3d_step(f, self)
        return self.plain_step(f)

    def make_block_step(self, steps_per_call: int = 4,
                        slabs_per_block: int | None = None,
                        interpret: bool = False, storage: str = "f32"):
        """A step that advances ``steps_per_call`` = T time steps a call (the
        JAX ``make_block_step``): on a card one launch of K11-T
        (``kernels/flow3d.py::single3d_block_step``; ``build.split_steps``'s
        launches above a launch's limit) on the (19, nz, ny, nx) state, or
        with ``storage="bf16"`` on the (21, nz, ny, nx) bfloat16 state
        (decoded once and encoded once a launch); on the CPU T plain
        steps.  T = 1 with the model's own storage gives ``step``.

        Returns None for a collision outside SRT / TRT (single3d.py:58-59),
        so "MRT", which the step runs as TRT, has none, and with
        ``use_kernel=False``.  ``slabs_per_block`` and ``interpret`` tune
        the TPU kernel and are ignored."""
        del slabs_per_block, interpret
        return kernel_block_step(self, steps_per_call, storage,
                                 self.use_kernel and
                                 self.collision in ("SRT", "TRT"),
                                 single3d_block_step)


@dataclasses.dataclass(frozen=True)
class ShanChenParams3D:
    """Same fields and defaults as the JAX package's ShanChenParams3D."""
    g_matrix: tuple
    g_solid: tuple
    tau: tuple
    psi: Literal["rho", "PR"] = "rho"
    body_force: tuple = (0.0, 0.0, 0.0)

    @property
    def num_fluids(self) -> int:
        return len(self.tau)


class ShanChenMCMP3D(nn.Module):
    """Original-Shan-Chen multicomponent flow on D3Q19 (velocity-shift
    forcing).  State: f (K, 19, nz, ny, nx).  The force uses psi = rho
    whatever ``params.psi`` says, as the JAX model does; K10 takes
    psi = "rho" only (the JAX build function returns no kernel
    otherwise), and any number of fluids."""

    def __init__(self, geometry: Geometry, params: ShanChenParams3D,
                 dtype=torch.float32, device="cuda", storage: str = "f32",
                 use_kernel: bool = True):
        super().__init__()
        k = params.num_fluids
        if np.asarray(params.g_matrix).shape != (k, k) or \
                len(params.g_solid) != k:
            raise ValueError(f"g_matrix must be {k}x{k} and g_solid hold {k} "
                             "values")
        dtype = resolve_dtype(dtype)
        dev = resolve_device(device)
        self.use_kernel = bool(use_kernel)
        fused = self.use_kernel and params.psi == "rho"
        _check_storage(storage, dtype, fused)
        self.lat = D3Q19
        self.geo = geometry
        self.p = params
        self.k = k
        self.dtype = dtype
        self.storage = storage
        self.tau = np.asarray(params.tau, np.float64)
        self.g_matrix = np.asarray(params.g_matrix, np.float64)
        self.g_solid = np.asarray(params.g_solid, np.float64)
        self.register_buffer("fluid_mask", torch.as_tensor(
            geometry.is_fluid, dtype=dtype, device=dev))
        self.register_buffer("upwind_solid", torch.as_tensor(
            upwind_solid_masks(self.lat, geometry.is_solid), device=dev))
        # the static solid-adhesion field sum_i w_i e_i is_solid(x + e_i)
        self.register_buffer("adhesion", torch.as_tensor(
            geo_stack_sc3(geometry)[1:], dtype=dtype, device=dev))
        self.register_buffer("tau_k", torch.as_tensor(
            self.tau, dtype=dtype, device=dev).reshape(-1, 1, 1, 1))
        self.path = "kernel" if fused and dev.type == "cuda" else "plain"
        self.kernel_params = None
        self.register_buffer("kernel_table", None)
        if self.path == "kernel":
            self.kernel_params = sc3d_params(params, geometry)
            self.kernel_table = torch.as_tensor(
                sc3d_table(params), dtype=torch.float64, device=dev)
            self.register_buffer("fluid_u8", torch.as_tensor(
                geometry.is_fluid, dtype=torch.uint8, device=dev))

    @property
    def device(self) -> torch.device:
        return self.fluid_mask.device

    def init_state_droplet(self, rho_main, rho_background, center=None,
                           radius: float = 8.0):
        """A sphere of fluid 0 (its main density) in a bath of the others;
        each fluid at its background density elsewhere."""
        nz, ny, nx = self.geo.shape
        if center is None:
            center = (nz / 2.0, ny / 2.0, nx / 2.0)
        zz, yy, xx = np.mgrid[0:nz, 0:ny, 0:nx]
        inside = ((zz - center[0]) ** 2 + (yy - center[1]) ** 2 +
                  (xx - center[2]) ** 2) <= radius ** 2
        rho = np.empty((self.k, nz, ny, nx))
        for i in range(self.k):
            region = inside if i == 0 else ~inside
            rho[i] = np.where(region, rho_main[i], rho_background[i])
        rho *= self.geo.is_fluid
        rho_k = torch.as_tensor(rho, dtype=self.dtype, device=self.device)
        z = torch.zeros_like(rho_k)
        return eq.feq_quadratic(self.lat, rho_k, (z, z, z)) * self.fluid_mask

    def pack_state_bf16(self, f):
        """(K, 19, nz, ny, nx) -> (K, 21, nz, ny, nx) bfloat16, per fluid the
        deviations f_i - w_i rho_k and rho_k as a hi/lo pair."""
        return _pack_bf16(f, self.lat)

    def unpack_bf16(self, s):
        return _unpack_bf16(s, self.lat, self.dtype)

    def _force(self, rho_k):
        """F_k = -psi_k (sum_j G_kj sum_i w_i e_i psi_j(x + e_i) + G_ks adh)
        + g rho_k with psi = rho."""
        psi = rho_k
        grads = [torch.zeros_like(rho_k) for _ in range(3)]
        for i in range(1, 19):
            w = float(D3Q19.w[i])
            s = shift(psi, int(D3Q19.e[i, 0]), int(D3Q19.e[i, 1]),
                      int(D3Q19.e[i, 2]))
            for d in range(3):
                ed = int(D3Q19.e[i, d])
                if ed:
                    grads[d] = grads[d] + (w * ed) * s
        out = []
        for d in range(3):
            gv = torch.stack([sum((float(self.g_matrix[k, j]) * grads[d][j]
                                   for j in range(1, self.k)),
                                  float(self.g_matrix[k, 0]) * grads[d][0])
                              for k in range(self.k)])
            gs = torch.as_tensor(self.g_solid, dtype=rho_k.dtype,
                                 device=rho_k.device).reshape(-1, 1, 1, 1)
            out.append(-psi * (gv + gs * self.adhesion[d]) +
                       float(self.p.body_force[d]) * rho_k)
        return tuple(out)

    def _step_impl(self, f):
        """The plain step, composed from ``ops/``: the JAX model's jnp
        ``_step_impl``."""
        rho_k = mac.density(f, 3)
        rho_safe = torch.where(rho_k > 0, rho_k, torch.ones_like(rho_k))
        up = mac.sc_common_velocity(self.lat, f, rho_k, self.tau)
        force = self._force(rho_k)
        ueq = tuple(up[d][None] + self.tau_k * force[d] / rho_safe
                    for d in range(3))
        feq = eq.feq_quadratic(self.lat, rho_k, ueq)
        f = f - (f - feq) / self.tau_k[:, None]
        return stream(f, self.lat, self.upwind_solid) * self.fluid_mask

    def plain_step(self, f):
        """``_step_impl`` on any device; a bf16 state is decoded to float32,
        stepped and encoded again, as the kernel does in its registers."""
        if self.storage == "bf16":
            return self.pack_state_bf16(self._step_impl(self.unpack_bf16(f)))
        return self._step_impl(f)

    def step(self, f):
        """One time step: K10 when ``path == "kernel"``, else the plain
        step."""
        if self.path == "kernel":
            return sc3d_step(f, self)
        return self.plain_step(f)

    def make_block_step(self, steps_per_call: int = 2,
                        slabs_per_block: int | None = None,
                        interpret: bool = False, storage: str = "f32"):
        """A step that advances ``steps_per_call`` = T time steps a call (the
        JAX ``make_block_step``): on a card one launch of K10-T
        (``kernels/flow3d.py::sc3d_block_step``; ``build.split_steps``'s
        launches above a launch's limit) on the (K, 19, nz, ny, nx) state,
        or with ``storage="bf16"`` on the (K, 21, nz, ny, nx) bfloat16
        state (decoded once and encoded once a launch); on the CPU T plain
        steps.  T = 1 with the model's own storage gives ``step``.

        Returns None for psi other than "rho" (sc3d.py:106-107) and with
        ``use_kernel=False``.  ``slabs_per_block`` and ``interpret`` tune the
        TPU kernel and are ignored."""
        del slabs_per_block, interpret
        return kernel_block_step(self, steps_per_call, storage,
                                 self.use_kernel and self.p.psi == "rho",
                                 sc3d_block_step)

    def macro(self, f):
        """(rho_k, (ux, uy, uz)): the fluid densities and the barycentric
        velocity sum_k (m_k + F_k/2) / rho_tot; a bf16 state is decoded
        first."""
        if f.dtype == torch.bfloat16:
            f = self.unpack_bf16(f)
        rho_k = mac.density(f, 3)
        force = self._force(rho_k)
        rho = torch.sum(rho_k, dim=0)
        rho_s = torch.where(rho > 0, rho, torch.ones_like(rho))
        mom = mac.momentum(self.lat, f)
        return rho_k, tuple(torch.sum(mom[d] + 0.5 * force[d], dim=0) / rho_s
                            for d in range(3))

    def pressure(self, rho_k):
        return mac.pressure_sc(rho_k, self.g_matrix)


@dataclasses.dataclass(frozen=True)
class ColorGradientParams3D:
    """Same fields and defaults as the JAX package's ColorGradientParams3D."""
    tau_r: float = 1.0
    tau_b: float = 1.0
    surface_tension: float = 0.01
    contact_angle_deg: float = 90.0
    beta: float = 0.7
    delta: float = 0.98
    tau_type: int = 2
    body_force: tuple = (0.0, 0.0, 0.0)


# D3Q19 direction groups by e_z sign
_EZ_PLUS = (5, 11, 14, 15, 18)
_EZ_MINUS = (6, 12, 13, 16, 17)
_EZ_ZERO = (0, 1, 2, 3, 4, 7, 8, 9, 10)


@dataclasses.dataclass(frozen=True)
class CG3DBoundaryConfig:
    """Same fields and defaults as the JAX package's CG3DBoundaryConfig.

    inlet:  periodic | velocity (NEBB at v_z = inlet_velocity on the top
            slab nz-2, negative = inflow; ghost slab nz-1)
    outlet: periodic | dirichlet (NEBB at total rho = outlet_density on
            slab 1; ghost slab 0) | convective (slabs 2, 1, 0 copy the
            slab above)
    """
    inlet: str = "periodic"
    outlet: str = "periodic"
    inlet_velocity: float = 0.0
    outlet_density: float = 1.0


def _feq_vz(rho, vz):
    """D3Q19 equilibria at u = (0, 0, vz), a list over Q."""
    out = []
    for i in range(D3Q19.q):
        eu = float(D3Q19.e[i, 2]) * vz
        out.append(float(D3Q19.w[i]) * rho *
                   (1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * vz * vz))
    return out


def _nebb(ft, unknown, rho, vz):
    """NEBB values {i: feq_i + f_opp(i) - feq_opp(i)} of the unknown
    directions of a (19, ny, nx) slab of the total PDF."""
    feq = _feq_vz(rho, vz)
    return {i: feq[i] + (ft[int(D3Q19.opp[i])] - feq[int(D3Q19.opp[i])])
            for i in unknown}


def _inlet_rho(ft, vz):
    return (sum(ft[i] for i in _EZ_ZERO) + 2.0 * sum(ft[i] for i in _EZ_PLUS)
            ) / (1.0 + vz)


def _outlet_vz(ft, rho_t):
    return 1.0 - (sum(ft[i] for i in _EZ_ZERO) +
                  2.0 * sum(ft[i] for i in _EZ_MINUS)) / rho_t


def _safe(x):
    return torch.where(x != 0, x, torch.ones_like(x))


class ColorGradientRK3D(nn.Module):
    """Two-phase CSF colour-gradient solver on a dense masked D3Q19 grid
    (SRT with tau(phi), Akai wetting).

    ``dtype`` is the arithmetic type (float32 or float64) and the type of
    the split state (f_r, f_b).  ``storage`` picks the layout ``step_c``
    maps: "f32" the (20, nz, ny, nx) state in ``dtype``, "bf16" the 21-plane
    bfloat16 state of ``pack_state_bf16`` (float32 arithmetic).  The
    geometry planes (``geo_stack3``: code, n_s) live as buffers on
    ``device``, in float32 under bf16 storage.  ``path`` is "kernel" on a
    card and "plain" on the CPU or with ``use_kernel=False``: every
    configuration takes the kernel.
    """

    def __init__(self, geometry: Geometry, params: ColorGradientParams3D,
                 boundaries: CG3DBoundaryConfig = CG3DBoundaryConfig(),
                 dtype=torch.float32, device="cuda", storage: str = "f32",
                 use_kernel: bool = True):
        super().__init__()
        if boundaries.inlet not in ("periodic", "velocity"):
            raise ValueError(f"inlet {boundaries.inlet!r}: periodic | "
                             "velocity")
        if boundaries.outlet not in ("periodic", "dirichlet", "convective"):
            raise ValueError(f"outlet {boundaries.outlet!r}: periodic | "
                             "dirichlet | convective")
        if params.tau_type not in (1, 2):
            raise ValueError(f"unknown tau option {params.tau_type}")
        if storage not in ("f32", "bf16"):
            raise ValueError(f"storage {storage!r}: f32 | bf16")
        dtype = resolve_dtype(dtype)
        if storage == "bf16" and dtype != torch.float32:
            raise ValueError("storage='bf16' computes in float32")
        dev = resolve_device(device)
        self.lat = D3Q19
        self.geo = geometry
        self.p = params
        self.bcs = boundaries
        self.dtype = dtype
        self.storage = storage
        self.kernel_params = kernel_params(params, boundaries, geometry)
        self.has_wetting = bool(self.kernel_params.has_wetting)
        self.use_kernel = bool(use_kernel)
        self.path = "kernel" if self.use_kernel and dev.type == "cuda" \
            else "plain"
        # the red phase's contact angle; the Akai rotation constrains the
        # into-blue normal, so its cosine flips
        theta = math.radians(params.contact_angle_deg)
        self.cos_t, self.sin_t = -math.cos(theta), math.sin(theta)
        self.register_buffer("geo_planes",
                             geo_stack3(geometry, dev).to(dtype))
        self.register_buffer("fluid_mask", torch.as_tensor(
            geometry.is_fluid, dtype=dtype, device=dev))
        self.register_buffer("upwind_solid", torch.as_tensor(
            upwind_solid_masks(self.lat, geometry.is_solid), device=dev))

    @property
    def device(self) -> torch.device:
        return self.geo_planes.device

    @property
    def is_fluid(self):
        return self.geo_planes[0] > 0.5

    @property
    def wet_fluid(self):
        return self.geo_planes[0] > 1.5

    @property
    def ns(self):
        return tuple(self.geo_planes[1:4])

    # -- initial conditions ----------------------------------------------
    def init_state_droplet(self, rho_r=1.0, rho_b=1.0, center=None,
                           radius: float = 8.0, background: float = 0.0):
        """A red sphere in blue; returns (f_r, f_b)."""
        nz, ny, nx = self.geo.shape
        if center is None:
            center = (nz / 2.0, ny / 2.0, nx / 2.0)
        zz, yy, xx = np.mgrid[0:nz, 0:ny, 0:nx]
        inside = ((zz - center[0]) ** 2 + (yy - center[1]) ** 2 +
                  (xx - center[2]) ** 2) <= radius ** 2
        r = np.where(inside, rho_r, background) * self.geo.is_fluid
        b = np.where(inside, background, rho_b) * self.geo.is_fluid
        return self._feq_init(r, b)

    def init_state_layers(self, rho_r=1.0, rho_b=1.0, invading_slabs=8,
                          background: float = 0.0):
        """Red in the top `invading_slabs` z slabs, blue below; returns
        (f_r, f_b)."""
        nz = self.geo.shape[0]
        z = np.arange(nz).reshape(-1, 1, 1)
        top = np.broadcast_to(z >= nz - invading_slabs, self.geo.shape)
        r = np.where(top, rho_r, background) * self.geo.is_fluid
        b = np.where(top, background, rho_b) * self.geo.is_fluid
        return self._feq_init(r, b)

    def _feq_init(self, rho_r, rho_b):
        rr = torch.as_tensor(rho_r, dtype=self.dtype, device=self.device)
        rb = torch.as_tensor(rho_b, dtype=self.dtype, device=self.device)
        zeros = torch.zeros_like(rr)
        u0 = (zeros, zeros, zeros)
        f_r = eq.feq_quadratic(self.lat, rr, u0)
        f_b = eq.feq_quadratic(self.lat, rb, u0)
        return f_r * self.fluid_mask, f_b * self.fluid_mask

    # -- layouts ----------------------------------------------------------
    def _w_col(self, device):
        return torch.as_tensor(self.lat.w, dtype=self.dtype,
                               device=device).reshape(-1, 1, 1, 1)

    def pack_state(self, f_r, f_b):
        """(f_r, f_b) -> (20, nz, ny, nx): the total PDF and rho_r."""
        return torch.cat([f_r + f_b, mac.density(f_r, 3)[None]], dim=0)

    def pack_compressed_bf16(self, s):
        """(20, nz, ny, nx) state -> the 21-plane bfloat16 state: deviations
        f_i - w_i*fl (19) and rho_r as hi = bf16(rho_r), lo = bf16(rho_r -
        hi), both rounded to nearest-even."""
        fdev = (s[:19] - self._w_col(s.device) * self.fluid_mask[None]) \
            .to(torch.bfloat16)
        hi = s[19].to(torch.bfloat16)
        lo = (s[19] - hi.to(self.dtype)).to(torch.bfloat16)
        return torch.cat([fdev, hi[None], lo[None]], dim=0)

    def pack_state_bf16(self, f_r, f_b):
        """(f_r, f_b) -> the 21-plane bfloat16 state."""
        return self.pack_compressed_bf16(self.pack_state(f_r, f_b))

    def unpack_bf16(self, s):
        """21-plane bfloat16 state -> (20, nz, ny, nx) state in ``dtype``."""
        f_tot = s[:19].to(self.dtype) + \
            self._w_col(s.device) * self.fluid_mask[None]
        rho_r = s[19].to(self.dtype) + s[20].to(self.dtype)
        return torch.cat([f_tot, rho_r[None]], dim=0)

    # -- fields -----------------------------------------------------------
    def color_force_fields(self, f_r, f_b):
        """(rho_r, rho_b, phi, g, force) of the colour PDFs."""
        return self._fields_from_densities(mac.density(f_r, 3),
                                           mac.density(f_b, 3))

    def _fields_from_densities(self, rho_r, rho_b):
        fl = self.fluid_mask
        phi = cg.phase_field(rho_r, rho_b) * fl
        phi_ext = cg.solid_phi_extrapolate(phi, self.is_fluid, self.lat) \
            if self.has_wetting else phi
        g = cg.color_gradient(phi_ext, self.lat)
        if self.has_wetting:
            g = cg.rotate_gradient_on_wetting_akai_nd(
                g, self.ns, self.cos_t, self.sin_t, self.wet_fluid)
        force, _ = cg.csf_force_nd(g, self.p.surface_tension, self.is_fluid,
                                   inward_normal=True, lat=self.lat)
        if any(self.p.body_force):
            rho = rho_r + rho_b
            force = tuple(force[d] + float(self.p.body_force[d]) * rho
                          for d in range(3))
        force = tuple(c * fl for c in force)
        return rho_r, rho_b, phi, g, force

    def _velocity(self, f_tot, rho, force):
        rho_safe = torch.where(rho > 0, rho, torch.ones_like(rho))
        mom = mac.momentum(self.lat, f_tot)
        return tuple((mom[d] + 0.5 * force[d]) / rho_safe for d in range(3))

    def _collide(self, f_tot, rho_r, rho_b, phi, g, force):
        """Post-collision total PDF and its red part (LKR)."""
        p = self.p
        rho = rho_r + rho_b
        u = self._velocity(f_tot, rho, force)
        tau = cg.tau_interp_csf(phi, rho_r, rho_b, p.tau_r, p.tau_b, p.delta,
                                p.tau_type)
        feq = eq.feq_quadratic(self.lat, rho, u)
        src = guo_source(self.lat, u, force)
        f_tot = col.bgk_field_tau(f_tot, feq, tau)
        f_tot = f_tot + (1.0 - 0.5 / tau)[None] * src
        return f_tot, cg.recolor_lkr_nd(f_tot, rho_r, rho_b, g, p.beta,
                                        self.lat)

    # -- split state (f_r, f_b) -------------------------------------------
    def _slab_mask(self, z):
        return self.is_fluid[z]

    def _split_slab(self, f_r, f_b, z, new, ratio):
        """Set the directions of `new` on slab z's fluid cells, split by the
        pre-rewrite red fraction."""
        m = self._slab_mask(z)
        f_r, f_b = f_r.clone(), f_b.clone()
        for i, val in new.items():
            f_r[i, z] = torch.where(m, ratio * val, f_r[i, z])
            f_b[i, z] = torch.where(m, (1.0 - ratio) * val, f_b[i, z])
        return f_r, f_b

    def _copy_slab(self, states, dst, src):
        """states[k][:, dst] <- states[k][:, src] on dst's fluid cells."""
        m = self._slab_mask(dst)
        out = []
        for f in states:
            f = f.clone()
            f[:, dst] = torch.where(m, f[:, src], f[:, dst])
            out.append(f)
        return out

    def _apply_inlet(self, f_r, f_b):
        if self.bcs.inlet != "velocity":
            return f_r, f_b
        nz = self.geo.shape[0]
        z = nz - 2
        vz = self.bcs.inlet_velocity
        ft = f_r[:, z] + f_b[:, z]
        new = _nebb(ft, _EZ_MINUS, _inlet_rho(ft, vz), vz)
        ratio = mac.ordered_sum(f_r[:, z], 0) / _safe(mac.ordered_sum(ft, 0))
        f_r, f_b = self._split_slab(f_r, f_b, z, new, ratio)
        return tuple(self._copy_slab((f_r, f_b), nz - 1, z))

    def _apply_outlet(self, f_r, f_b):
        if self.bcs.outlet == "convective":
            for z in (2, 1, 0):
                f_r, f_b = self._copy_slab((f_r, f_b), z, z + 1)
            return f_r, f_b
        if self.bcs.outlet != "dirichlet":
            return f_r, f_b
        rho_t = self.bcs.outlet_density
        ft = f_r[:, 1] + f_b[:, 1]
        new = _nebb(ft, _EZ_PLUS, rho_t, _outlet_vz(ft, rho_t))
        ratio = mac.ordered_sum(f_r[:, 1], 0) / _safe(mac.ordered_sum(ft, 0))
        f_r, f_b = self._split_slab(f_r, f_b, 1, new, ratio)
        return tuple(self._copy_slab((f_r, f_b), 0, 1))

    def _physics(self, f_r, f_b):
        """Collide, recolour and stream post-BC colour PDFs."""
        rho_r, rho_b, phi, g, force = self.color_force_fields(f_r, f_b)
        _, (f_r, f_b) = self._collide(f_r + f_b, rho_r, rho_b, phi, g, force)
        fl = self.fluid_mask
        return (stream(f_r, self.lat, self.upwind_solid) * fl,
                stream(f_b, self.lat, self.upwind_solid) * fl)

    def plain_step(self, state):
        """One split step composed from ``ops/`` (the jnp ``_step_impl``
        with ``use_pallas=False``), on any device."""
        f_r, f_b = self._apply_inlet(*state)
        f_r, f_b = self._apply_outlet(f_r, f_b)
        return self._physics(f_r, f_b)

    def step(self, state):
        """One time step of the split state (f_r, f_b): the kernel on a
        CUDA state, the plain step on a CPU one or with
        ``use_kernel=False``."""
        if not self.use_kernel:
            return self.plain_step(tuple(state))
        return cg3d_step_split(tuple(state), self)

    def macro(self, state):
        """Diagnostics (rho_r, rho_b, phi, (ux, uy, uz)) of a split state,
        boundary slabs not applied."""
        f_r, f_b = state
        rho_r, rho_b, phi, _, force = self.color_force_fields(f_r, f_b)
        return rho_r, rho_b, phi, self._velocity(f_r + f_b, rho_r + rho_b,
                                                 force)

    # -- compressed state (f_total, rho_r) ----------------------------------
    def _apply_bcs_c(self, s):
        """The compressed boundary slabs on a (20, nz, ny, nx) state, as the
        JAX compressed kernel's prologue applies them: the unknown
        directions of the total PDF take their NEBB values, and rho_r moves
        by the slab's red fraction of the change."""
        return self._bc_slabs_c(s, lambda s, z: (s[:19, z], s[19, z]),
                                self._set_slab_c)

    @staticmethod
    def _set_slab_c(s, z, ft, rr):
        s = s.clone()
        s[:19, z] = ft
        s[19, z] = rr
        return s

    def _dec_slab(self, s, z):
        """Slab z of a 21-plane bfloat16 state decoded to float32."""
        w = self._w_col(s.device)[:, 0]
        return (s[:19, z].to(self.dtype) + w * self.fluid_mask[z],
                s[19, z].to(self.dtype) + s[20, z].to(self.dtype))

    def _enc_slab(self, s, z, ft, rr):
        w = self._w_col(s.device)[:, 0]
        s = s.clone()
        s[:19, z] = (ft - w * self.fluid_mask[z]).to(torch.bfloat16)
        hi = rr.to(torch.bfloat16)
        s[19, z] = hi
        s[20, z] = (rr - hi.to(self.dtype)).to(torch.bfloat16)
        return s

    def _bc_slabs_c(self, s, dec, enc):
        """The compressed boundary slabs through slab accessors: `dec(s, z)`
        reads slab z of `s` as (ft, rho_r), `enc(s, z, ft, rr)` writes it
        back (the bf16 state re-encodes each slab it
        rewrites, ``pallas/cg3d.py::_bc_prologue_c_bf16``)."""
        nz = self.geo.shape[0]
        bcs = self.bcs

        def rewrite(s, z, unknown, rho, vz):
            sl, rr = dec(s, z)
            new = _nebb(sl, unknown, rho(sl), vz(sl))
            ratio = rr / _safe(mac.ordered_sum(sl, 0))
            m = self._slab_mask(z)
            ft = sl.clone()
            dsum = 0.0
            for i, val in new.items():
                dsum = dsum + (val - sl[i])
                ft[i] = torch.where(m, val, sl[i])
            rr = torch.where(m, rr + ratio * dsum, rr)
            return enc(s, z, ft, rr), ft, rr

        def ghost(s, dst, ft, rr):
            m = self._slab_mask(dst)
            gt, gr = dec(s, dst)
            return enc(s, dst, torch.where(m, ft, gt), torch.where(m, rr, gr))

        if bcs.inlet == "velocity":
            vz = bcs.inlet_velocity
            s, ft, rr = rewrite(s, nz - 2, _EZ_MINUS,
                                lambda sl: _inlet_rho(sl, vz), lambda sl: vz)
            s = ghost(s, nz - 1, ft, rr)
        if bcs.outlet == "convective":
            for z in (2, 1, 0):
                s = ghost(s, z, *dec(s, z + 1))
        elif bcs.outlet == "dirichlet":
            rho_t = bcs.outlet_density
            s, _, _ = rewrite(s, 1, _EZ_PLUS, lambda sl: rho_t,
                              lambda sl: _outlet_vz(sl, rho_t))
            s = ghost(s, 0, *dec(s, 1))
        return s

    def _physics_c(self, s):
        """Collide, recolour and stream a post-BC (20, nz, ny, nx) state:
        rho_r' is the streamed sum of the recoloured red PDFs."""
        f_tot, rho_r = s[:19], s[19]
        rho_b = mac.density(f_tot, 3) - rho_r
        _, _, phi, g, force = self._fields_from_densities(rho_r, rho_b)
        post, (f_r_post, _) = self._collide(f_tot, rho_r, rho_b, phi, g,
                                            force)
        fl = self.fluid_mask
        f_tot = stream(post, self.lat, self.upwind_solid) * fl
        rho_r_new = mac.density(stream(f_r_post, self.lat,
                                       self.upwind_solid), 3) * fl
        return torch.cat([f_tot, rho_r_new[None]], dim=0)

    def _post_slabs_c(self, s):
        """A compressed state (either layout) after its boundary slabs, as a
        (20, nz, ny, nx) state in ``dtype``.  A bf16 state takes the slabs
        slab by slab in float32 and re-encodes them, then is decoded, as
        the kernel does in its registers."""
        if s.dtype == torch.bfloat16:
            return self.unpack_bf16(self._bc_slabs_c(s, self._dec_slab,
                                                     self._enc_slab))
        return self._apply_bcs_c(s)

    def _encode_like(self, out, s):
        """A stepped (20, nz, ny, nx) state in the layout of `s`."""
        return self.pack_compressed_bf16(out) \
            if s.dtype == torch.bfloat16 else out

    def plain_step_c(self, s):
        """One compressed step composed from ``ops/``, on any device: the
        boundary slabs (``_post_slabs_c``), collision and streaming, and
        under bf16 the encoding again."""
        return self._encode_like(self._physics_c(self._post_slabs_c(s)), s)

    def step_c(self, s):
        """One time step of the compressed state (layout per ``storage``):
        the kernel on a CUDA state, the plain step on a CPU one or with
        ``use_kernel=False``."""
        if not self.use_kernel:
            return self.plain_step_c(s)
        return cg3d_step_compressed(s, self)

    def make_block_step(self, steps_per_call: int = 2,
                        slabs_per_block: int | None = None,
                        interpret: bool = False, *, compressed: bool = False,
                        storage: str = "f32"):
        """A step that advances ``steps_per_call`` = T time steps a call (the
        JAX ``make_block_step``, which builds the split form): on a card one
        launch of K9-T (``build.split_steps``'s launches above a launch's
        limit), the boundary slabs applied before every sub-step --
        by default on the split state (f_r, f_b) (K9-Ts,
        ``kernels/cg3d.py::cg3d_block_split``), with ``compressed=True`` on
        the (20, nz, ny, nx) state (K9-Tc, ``cg3d_block_compressed``), and
        with ``storage="bf16"`` as well on the 21-plane bfloat16 state
        (K9-Th, decoded once and encoded once a launch); on the CPU T plain
        steps.  T = 1 with the model's own storage gives ``step`` /
        ``step_c``.

        Returns None where the JAX builder refuses on grounds of layout:
        bf16 on the split state (pallas/cg3d.py:196-197); the boundary kinds
        it refuses (:222-226) the constructor refuses already.  None too
        with ``use_kernel=False``.  ``slabs_per_block`` and ``interpret``
        tune the TPU kernel and are ignored."""
        del slabs_per_block, interpret
        t = block_args(steps_per_call, storage)
        if (storage == "bf16" and not compressed) or not self.use_kernel:
            return None
        if storage == "bf16" and self.dtype != torch.float32:
            raise ValueError("storage='bf16' computes in float32")
        if t == 1 and storage == self.storage:
            return self.step_c if compressed else self.step
        return t_step(cg3d_block_compressed if compressed else
                      cg3d_block_split, self, t)

    def macro_compressed(self, s):
        """``macro`` of a compressed state (either layout)."""
        if s.dtype == torch.bfloat16:
            s = self.unpack_bf16(s)
        f_tot, rho_r = s[:19], s[19]
        rho_b = mac.density(f_tot, 3) - rho_r
        _, _, phi, _, force = self._fields_from_densities(rho_r, rho_b)
        return rho_r, rho_b, phi, self._velocity(f_tot, rho_r + rho_b, force)


# ---------------------------------------------------------------------------
# D3Q7 transport
# ---------------------------------------------------------------------------

class TransportD3Q7(nn.Module):
    """Tracer transport on D3Q7 confined to one phase: per tracer the
    J-scheme equilibrium g_eq = C (J_i + e.u/2), J_0 = j0, J_i = (1 - j0)/6
    (D = (1 - j0)/3 (tau - 1/2)), SRT collision with the tracer's tau, pull
    streaming with half-way bounce-back, and with ``interface_mode=
    "bounceback"`` the hard interface bounce-back on rho_r < criteria.
    ``tau`` and ``j0`` hold one value per tracer, or one for all.  The
    upwind-solid masks and the fluid mask are buffers on ``device``."""

    def __init__(self, geometry: Geometry, num_tracers: int = 1, tau=(1.0,),
                 j0=(0.25,), criteria: float = 0.5,
                 interface_mode: str = "none", dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        if interface_mode not in ("none", "bounceback"):
            raise ValueError(f"interface_mode {interface_mode!r}: none | "
                             "bounceback")
        dev = resolve_device(device)
        self.lat = D3Q7
        self.geo = geometry
        self.dtype = resolve_dtype(dtype)
        self.num_tracers = int(num_tracers)
        self.tau = np.asarray(_per_tracer(tau, self.num_tracers, "tau"))
        j0 = np.asarray(_per_tracer(j0, self.num_tracers, "j0"))
        self.j_coeffs = np.zeros((self.num_tracers, 7))
        self.j_coeffs[:, 0] = j0
        self.j_coeffs[:, 1:] = ((1.0 - j0) / 6.0)[:, None]
        self.criteria = float(criteria)
        self.interface_mode = interface_mode
        self.register_buffer("fluid_mask", torch.as_tensor(
            geometry.is_fluid, dtype=self.dtype, device=dev))
        self.register_buffer("upwind_solid", torch.as_tensor(
            upwind_solid_masks(self.lat, geometry.is_solid), device=dev))

    @property
    def device(self) -> torch.device:
        return self.fluid_mask.device

    def init_state(self, conc0):
        """conc0 (T, nz, ny, nx) -> g (T, 7, nz, ny, nx) = conc0 J_i on
        fluid cells."""
        conc0 = torch.as_tensor(np.asarray(conc0), dtype=self.dtype,
                                device=self.device) * self.fluid_mask
        j = torch.as_tensor(self.j_coeffs, dtype=self.dtype,
                            device=self.device)[:, :, None, None, None]
        return conc0[:, None] * j

    def concentration(self, g):
        return mac.ordered_sum(g, 1)

    def diffusivity(self, t: int = 0) -> float:
        return float((1.0 - self.j_coeffs[t, 0]) / 3.0 *
                     (self.tau[t] - 0.5))

    def step(self, g, u=None, rho_r=None):
        """One tracer step on the velocity u = (ux, uy, uz) (zero if None);
        with a bounce-back interface and rho_r given, the hard interface
        repair on rho_r < criteria."""
        conc = self.concentration(g)
        if u is None:
            zeros = torch.zeros(self.geo.shape, dtype=g.dtype,
                                device=g.device)
            u = (zeros, zeros, zeros)
        geq = torch.stack([eq.feq_transport_j(self.lat, conc[t], u,
                                              self.j_coeffs[t])
                           for t in range(self.num_tracers)])
        tau = torch.as_tensor(self.tau, dtype=g.dtype,
                              device=g.device).reshape(-1, 1, 1, 1, 1)
        g = g - (g - geq) / tau
        g = stream(g, self.lat, self.upwind_solid) * self.fluid_mask
        if self.interface_mode == "bounceback" and rho_r is not None:
            g = tr.interface_bounce_back(g, rho_r < self.criteria, self.lat)
        return g


class TransportRK3D(nn.Module):
    """Coupled D3Q19 CSF flow + D3Q7 tracer transport: the JAX package's
    constructor arguments, plus ``device``, ``storage`` (the flow's; the
    tracer PDFs stay in ``dtype``) and ``use_kernel``.  ``flow`` is the
    ColorGradientRK3D, ``transport`` the TransportD3Q7.  ``path`` is the
    compressed step's: "kernel" on a card, "plain" on the CPU or with
    ``use_kernel=False``; the split step is plain everywhere."""

    def __init__(self, geometry: Geometry, flow_params: ColorGradientParams3D,
                 num_tracers: int = 1, tau=(1.0,), j0=(0.25,),
                 criteria: float = 0.5, interface_mode: str = "bounceback",
                 dtype=torch.float32, boundaries=None, device="cuda",
                 storage: str = "f32", use_kernel: bool = True):
        super().__init__()
        self.flow = ColorGradientRK3D(
            geometry, flow_params, boundaries or CG3DBoundaryConfig(),
            dtype=dtype, device=device, storage=storage,
            use_kernel=use_kernel)
        self.transport = TransportD3Q7(geometry, num_tracers, tau, j0,
                                       criteria, interface_mode,
                                       dtype=self.flow.dtype,
                                       device=self.flow.device)
        self.geo = geometry
        self.path = self.flow.path
        self.tracer_params = tracer3d_params(self.transport)
        self.register_buffer("tracer_table", torch.as_tensor(
            tracer3d_table(self.transport), dtype=self.flow.dtype,
            device=self.flow.device))

    @property
    def device(self) -> torch.device:
        return self.flow.device

    def init_state(self, flow_state, conc0):
        """(f_r, f_b) and conc0 (T, nz, ny, nx) -> (f_r, f_b, g)."""
        return (*flow_state, self.transport.init_state(conc0))

    def concentration(self, g):
        return self.transport.concentration(g)

    def pack(self, state):
        """(f_r, f_b, g) -> the compressed coupled state (s, g), s in the
        flow's ``storage`` layout."""
        f_r, f_b, g = state
        pack = self.flow.pack_state_bf16 if self.flow.storage == "bf16" \
            else self.flow.pack_state
        return pack(f_r, f_b), g

    def _tracer_step(self, g, f_tot, rho_r, rho_b):
        """The tracer step on the fields of post-slab colour densities and
        total PDF (the flow collides with the same u)."""
        flow = self.flow
        _, _, _, _, force = flow._fields_from_densities(rho_r, rho_b)
        u = flow._velocity(f_tot, rho_r + rho_b, force)
        return self.transport.step(g, u, rho_r)

    def plain_step(self, state):
        """One split step (f_r, f_b, g) composed from ``ops/`` (the jnp
        ``_step_impl``): the flow's inlet and outlet slabs, the tracer on
        the post-slab pre-collision u and rho_r, then the flow's physics."""
        f_r, f_b, g = state
        flow = self.flow
        f_r, f_b = flow._apply_inlet(f_r, f_b)
        f_r, f_b = flow._apply_outlet(f_r, f_b)
        g = self._tracer_step(g, f_r + f_b, mac.density(f_r, 3),
                              mac.density(f_b, 3))
        return (*flow._physics(f_r, f_b), g)

    def step(self, state):
        """One split step: the plain composition on any device (no split
        coupled kernel exists)."""
        return self.plain_step(state)

    def plain_step_c(self, state):
        """One compressed step (s, g) composed from ``ops/``, on any device:
        the plain version of the kernel.  The compressed boundary slabs (a
        bf16 state re-encodes them, then is decoded), the tracer on the u
        and rho_r of that post-slab state, then the flow's physics (encoded
        again under bf16)."""
        s, g = state
        flow = self.flow
        x = flow._post_slabs_c(s)
        f_tot, rho_r = x[:19], x[19]
        g = self._tracer_step(g, f_tot, rho_r, mac.density(f_tot, 3) - rho_r)
        return flow._encode_like(flow._physics_c(x), s), g

    def step_c(self, state):
        """One compressed coupled step of (s, g): the kernel on a CUDA
        state, the plain step on a CPU one or with ``use_kernel=False``."""
        s, g = state
        if not self.flow.use_kernel:
            return self.plain_step_c((s, g))
        return coupled3d_step_compressed(s, g, self)
