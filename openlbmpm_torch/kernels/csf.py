"""The compressed CSF colour-gradient step: CUDA kernel wrapper, plain
PyTorch version and launch count.

Counterpart of ``openlbmpm_tpu/pallas/csf.py::build_csf_fused_step`` in
``state_mode="compressed"`` at one step per call, for ``storage="f32"`` (K1)
and ``storage="bf16"`` (K2).  The kernel lives in ``csrc/csf2d.cu``.

States:
  * f32 / f64: (10, ny, nx) -- planes 0-8 the total PDF, plane 9 rho_r;
  * bf16: (11, ny, nx) bfloat16 -- the deviations f_i - w_i*fl, then rho_r
    as a hi/lo pair (hi = bf16(rho_r), lo = bf16(rho_r - hi)).

``csf_step_compressed(s, model)`` takes the plain version only for a tensor
on the CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..geometry import Geometry, solid_normals, wetting_masks
from ..lattice import D2Q9
from ..ops.colorgrad import contact_angle_terms
from . import build

__all__ = ["geo_stack", "CsfParams", "kernel_params", "launch_csf2d",
           "csf_step_compressed", "csf_step_compressed_reference",
           "compare_bf16_states"]


def geo_stack(geometry: Geometry) -> np.ndarray:
    """Static geometry planes the kernel reads: is_fluid, wet_fluid, nsx,
    nsy, den_inv, where den_inv is the reciprocal of the solid-phi
    extrapolation denominator sum_i w_i is_fluid(x + e_i) (0 where a node
    has no fluid neighbour)."""
    wet_fluid, _ = wetting_masks(geometry.is_solid)
    nsx, nsy = solid_normals(geometry.is_solid)
    fl = geometry.is_fluid.astype(np.float64)
    den = np.zeros_like(fl)
    for i in range(1, 9):
        dx, dy = int(D2Q9.e[i, 0]), int(D2Q9.e[i, 1])
        den += float(D2Q9.w[i]) * np.roll(fl, (-dy, -dx), axis=(0, 1))
    den_inv = np.where(den > 0, 1.0 / np.where(den > 0, den, 1.0), 0.0)
    return np.stack([fl, wet_fluid.astype(np.float64), nsx, nsy, den_inv])


class CsfParams(ctypes.Structure):
    """Mirror of ``struct CsfParams`` in csrc/csf2d.cu (same field order)."""
    _fields_ = [
        ("ny", ctypes.c_int), ("nx", ctypes.c_int),
        ("inlet", ctypes.c_int),         # 0 periodic, 1 neumann, 2 dirichlet
        ("outlet", ctypes.c_int),        # 0 periodic, 1 convective, 2 dirichlet
        ("phi_repair", ctypes.c_int),
        ("has_wetting", ctypes.c_int),
        ("wetting_type", ctypes.c_int),  # 1 Xu 2017, 2 Akai 2018
        ("tau_type", ctypes.c_int),
        ("mrt", ctypes.c_int),
        ("pad", ctypes.c_int),
        ("tau_r", ctypes.c_double), ("tau_b", ctypes.c_double),
        ("sigma", ctypes.c_double), ("beta", ctypes.c_double),
        ("delta", ctypes.c_double),
        ("cos_t", ctypes.c_double), ("sin_t", ctypes.c_double),
        ("bfx", ctypes.c_double), ("bfy", ctypes.c_double),
        ("inlet_velocity", ctypes.c_double),
        ("inlet_rho", ctypes.c_double), ("outlet_rho", ctypes.c_double),
    ]


_INLETS = {"periodic": 0, "neumann": 1, "dirichlet": 2}
_OUTLETS = {"periodic": 0, "convective": 1, "dirichlet": 2}
_STORAGE_CODE = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}


def kernel_params(params, bcs, geometry: Geometry) -> CsfParams:
    """The kernel's parameter block for a CSF model with these
    ColorGradientParams, CGBoundaryConfig and geometry; raises
    NotImplementedError for a configuration the kernel does not take."""
    p, b = params, bcs
    ny, nx = geometry.shape
    if p.variant != "CSF":
        raise NotImplementedError(f"kernel: variant {p.variant}")
    if b.inlet not in _INLETS or b.outlet not in _OUTLETS:
        raise NotImplementedError(f"kernel: BCs {b.inlet}/{b.outlet}")
    if p.wetting_type not in (1, 2) or p.tau_type not in (1, 2) or \
            p.collision not in ("SRT", "MRT"):
        raise NotImplementedError("kernel: wetting/tau/collision option")
    _, wet_solid = wetting_masks(geometry.is_solid)
    cos_t, sin_t = contact_angle_terms(p.contact_angle_deg, p.wetting_type)
    bfx, bfy = (float(v) for v in p.body_force)
    return CsfParams(
        ny=ny, nx=nx, inlet=_INLETS[b.inlet], outlet=_OUTLETS[b.outlet],
        phi_repair=int(b.outlet == "dirichlet" and b.phi_outlet_repair),
        has_wetting=int(wet_solid.any()),
        wetting_type=p.wetting_type, tau_type=p.tau_type,
        mrt=int(p.collision == "MRT"), pad=0,
        tau_r=p.tau_r, tau_b=p.tau_b, sigma=p.surface_tension, beta=p.beta,
        delta=p.delta, cos_t=cos_t, sin_t=sin_t, bfx=bfx, bfy=bfy,
        inlet_velocity=b.inlet_velocity,
        inlet_rho=b.inlet_density_r + b.inlet_density_b,
        outlet_rho=b.outlet_density_r + b.outlet_density_b)


_fn_cache: dict[str, ctypes._CFuncPtr] = {}


def _kernel_fn():
    if "step" not in _fn_cache:
        lib = build.load_library("csf2d")
        fn = lib.csf2d_step
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + \
            [ctypes.POINTER(CsfParams), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.csf2d_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn_cache["step"] = fn
        _fn_cache["error"] = err
    return _fn_cache["step"]


def launch_csf2d(s: torch.Tensor, params: CsfParams,
                 geo: torch.Tensor) -> torch.Tensor:
    """One kernel step of the CUDA state `s`: (10, ny, nx) in the type of
    the geometry planes `geo` (``geo_stack``, float32 or float64), or
    (11, ny, nx) bfloat16 with float32 planes.  Not counted as a launch."""
    ny, nx = params.ny, params.nx
    bf16 = s.dtype == torch.bfloat16
    want = torch.float32 if bf16 else s.dtype
    planes = 11 if bf16 else 10
    if s.dtype not in _STORAGE_CODE or tuple(s.shape) != (planes, ny, nx):
        raise ValueError(f"state {tuple(s.shape)} {s.dtype}; the kernel "
                         f"takes ({planes}, {ny}, {nx})")
    if geo.dtype != want or tuple(geo.shape) != (5, ny, nx):
        raise ValueError(f"state {s.dtype} needs {want} geometry planes "
                         f"(5, {ny}, {nx}), got {geo.dtype} "
                         f"{tuple(geo.shape)}")
    if ny < 8 or nx < 3:
        raise NotImplementedError(f"kernel: domain {ny}x{nx} below 8x3")
    if s.device != geo.device:
        raise ValueError(f"state on {s.device}, geometry on {geo.device}")
    s = s.contiguous()
    fn = _kernel_fn()
    phi = torch.empty((ny, nx), dtype=geo.dtype, device=s.device)
    nrm = torch.empty((4, ny, nx), dtype=geo.dtype, device=s.device)
    out = torch.empty_like(s)
    stream_ptr = torch.cuda.current_stream(s.device).cuda_stream
    with torch.cuda.device(s.device):
        code = fn(_STORAGE_CODE[s.dtype], s.data_ptr(), out.data_ptr(),
                  geo.data_ptr(), phi.data_ptr(), nrm.data_ptr(),
                  ctypes.byref(params), stream_ptr)
    if code != 0:
        msg = _fn_cache["error"](code).decode()
        raise RuntimeError(f"csf2d_step launch failed: {msg} ({code})")
    return out


def csf_step_compressed(s: torch.Tensor, model) -> torch.Tensor:
    """One compressed CSF step (BC rows included) for `model`, a
    ColorGradientRK.  CPU tensor: the plain version.  CUDA tensor: the
    kernel on the model's parameter block and geometry planes, or an
    error; never the plain version."""
    if s.device.type == "cpu":
        return csf_step_compressed_reference(s, model)
    if s.device.type != "cuda":
        raise ValueError(f"no csf kernel for device {s.device}")
    want = torch.bfloat16 if model.storage == "bf16" else model.dtype
    if s.dtype != want:
        raise ValueError(f"state {s.dtype}; the model takes {want}")
    out = launch_csf2d(s, model.kernel_params, model.geo_planes)
    csf_step_compressed.launches += 1
    return out


csf_step_compressed.launches = 0


def csf_step_compressed_reference(s: torch.Tensor, model) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the model's
    ``plain_step_c`` (``_step_csf_c`` composed from ``ops/``; a bf16 state
    is decoded to f32, stepped and encoded again, as the kernel does in
    its registers)."""
    return model.plain_step_c(s)


def compare_bf16_states(a: torch.Tensor, b: torch.Tensor,
                        where: torch.Tensor) -> dict:
    """Value-by-value gap between two 11-plane bfloat16 states on the cells
    `where` (bool (ny, nx)).

    excess: the largest |a - b| in units of max(one bf16 ulp of the larger
        magnitude, 2^-18), over planes 0-9 and over the lo plane of rho_r
        wherever the hi planes agree (a hi flip moves lo by a whole hi
        ulp).  The 2^-18 floor covers values that are small after
        cancellation, where f32 rounding of the O(1) operands (about 5e-7
        between two f32 implementations) exceeds their bf16 ulp.
    share: the share of values of magnitude >= 1e-4 that differ at all.
    hi_flips: cells whose hi plane of rho_r differs."""
    x, y = a[:, where].float(), b[:, where].float()
    mag = torch.maximum(x.abs(), y.abs())
    _, e = torch.frexp(mag)
    tol = torch.clamp_min(torch.ldexp(torch.ones_like(mag), e - 8), 2.0 ** -18)
    excess = (x - y).abs() / tol
    hi_same = x[9] == y[9]
    big = mag >= 1e-4
    return {
        "excess": float(torch.cat([excess[:10].flatten(),
                                   excess[10, hi_same]]).max()),
        "share": float((x != y)[big].double().mean()),
        "hi_flips": int((~hi_same).sum())}
