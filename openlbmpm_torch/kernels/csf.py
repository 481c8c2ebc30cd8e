"""The 2-D colour-gradient step: CUDA kernel wrappers, plain PyTorch
versions and launch counts.

Counterpart of ``openlbmpm_tpu/pallas/csf.py::build_csf_fused_step``.  One
step per call: the CSF variant with ``state_mode="compressed"`` and
``storage="f32"`` (K1) or ``storage="bf16"`` (K2), and ``state_mode="split"``
(K6), in ``csrc/csf2d.cu`` (device code in ``csrc/csf2d.cuh``); the
Perturbation variant (K4) in the same three layouts (K4c, K4h, K4s) in
``csrc/pert2d.cu`` (``csrc/pert2d.cuh``; the f64 instances in their own
library, ``csrc/pert2d_f64.cu``).  Each is one launch a step of a strip
march (``strip_kernel``, ``pert_strip_kernel``) that keeps phi, the normals
and the post-collision values in shared-memory rings; the libraries count
their launches (``kernel_launches``).  T > 1 steps per call
(``steps_per_call``, K3): both variants in the three layouts (K3c, K3h,
K3s) in ``csrc/csf2d_block_{f64,f32,bf16}.cu``, one library per storage
type: the row-march of ``csrc/march2d.cuh`` (one cooperative launch on the
plan of ``kernels/march2d.py::csf2d_march_plan`` or ``pert2d_march_plan``,
which the wrapper builds once a configuration).  A T-step call above one
launch's limit (``csf_block_max_steps``: the march plan's) runs as
``build.split_steps``'s launches.  The local form of K3 (K12a: one shard
of a y or (y, x) decomposed domain, both variants, compressed f32 and f64)
is ``csrc/csf2d_local_{f64,f32}.cu``, on the halo windows of
``csrc/csf2d_block.cuh``, and ``build_csf_sharded_step`` (the
counterpart of ``pallas/csf.py::build_csf_sharded_step``) drives it and
the coupled one (``kernels/transport.py``) over a mesh
(``openlbmpm_torch/parallel``).

States:
  * compressed f32 / f64: (10, ny, nx) -- planes 0-8 the total PDF, plane 9
    rho_r;
  * compressed bf16: (11, ny, nx) bfloat16 -- the deviations f_i - w_i*fl,
    then rho_r as a hi/lo pair (hi = bf16(rho_r), lo = bf16(rho_r - hi));
  * split f32 / f64: the pair (f_r, f_b) of (9, ny, nx) colour PDFs.

``csf_step_compressed(s, model)``, ``csf_step_split((f_r, f_b), model)``,
their Perturbation twins ``pert_step_compressed`` and ``pert_step_split``,
and the T-step ``csf_block_compressed(s, model, steps)``,
``csf_block_split``, ``pert_block_compressed`` and ``pert_block_split`` take
the plain version only for tensors on the CPU; for CUDA tensors they launch
the kernel or raise.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..geometry import Geometry, solid_normals, wetting_masks
from ..lattice import D2Q9
from ..ops.colorgrad import contact_angle_terms
from ..ops.equilibrium import rk_constants
from . import build, march2d, march3d

__all__ = ["geo_stack", "CsfParams", "kernel_params", "launch_csf2d",
           "launch_csf2d_split", "csf_step_compressed",
           "csf_step_compressed_reference", "csf_step_split",
           "csf_step_split_reference", "pert_step_compressed",
           "pert_step_compressed_reference", "pert_step_split",
           "pert_step_split_reference", "compare_bf16_states",
           "KERNELS", "kernel_launches",
           "BLOCK_LIBRARIES", "launch_csf2d_block", "launch_csf2d_block_split",
           "csf_block_tiling", "csf_block_max_steps", "csf_block_compressed",
           "csf_block_compressed_reference",
           "csf_block_split", "csf_block_split_reference",
           "pert_block_compressed", "pert_block_compressed_reference",
           "pert_block_split", "pert_block_split_reference",
           "LOCAL_LIBRARIES", "csf_local_frame", "launch_csf2d_local",
           "csf_local_step", "csf_local_step_reference",
           "build_csf_sharded_step"]


def geo_stack(geometry: Geometry) -> np.ndarray:
    """Static geometry planes the kernels read: is_fluid, wet_fluid, nsx,
    nsy, den_inv, where den_inv is the reciprocal of the solid-phi
    extrapolation denominator sum_i w_i is_fluid(x + e_i) (0 where a node
    has no fluid neighbour).  The one-step kernels sum that denominator
    themselves and divide by it, as the reference does; only the row-march
    and the local windows still multiply by den_inv."""
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
    """Mirror of ``struct CsfParams`` in csrc/csf2d.cuh (same field order)."""
    _fields_ = [
        ("ny", ctypes.c_int), ("nx", ctypes.c_int),
        # 0 periodic, 1 neumann, 2 dirichlet, 3 neumann_per_color (split)
        ("inlet", ctypes.c_int),
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
        ("inlet_rho_r", ctypes.c_double), ("inlet_rho_b", ctypes.c_double),
        # 0 CSF, 1 Perturbation: each library refuses the other's block
        ("variant", ctypes.c_int),
        ("pad2", ctypes.c_int),
        ("inlet_velocity_r", ctypes.c_double),
        ("inlet_velocity_b", ctypes.c_double),
        # Perturbation: solid colour difference, strengths, gradient
        # weights (axis, diagonal) and the C_i (rest, axis, diagonal)
        ("solid_phi", ctypes.c_double), ("a_kr", ctypes.c_double),
        ("a_kb", ctypes.c_double), ("grad_wa", ctypes.c_double),
        ("grad_wd", ctypes.c_double), ("c_r", ctypes.c_double * 3),
        ("c_b", ctypes.c_double * 3),
    ]


_INLETS = {"periodic": 0, "neumann": 1, "dirichlet": 2,
           "neumann_per_color": 3}
_VARIANTS = {"CSF": 0, "Perturbation": 1}
_OUTLETS = {"periodic": 0, "convective": 1, "dirichlet": 2}
# the kernels' state mode: compressed f64, f32, bf16; split f64, f32
_STORAGE_CODE = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}
_SPLIT_CODE = {torch.float64: 3, torch.float32: 4}


def kernel_params(params, bcs, geometry: Geometry) -> CsfParams:
    """The kernel's parameter block for a CSF or Perturbation model with
    these ColorGradientParams, CGBoundaryConfig and geometry; raises
    NotImplementedError for a configuration the kernels do not take."""
    p, b = params, bcs
    ny, nx = geometry.shape
    if p.variant not in _VARIANTS:
        raise NotImplementedError(f"kernel: variant {p.variant}")
    if b.inlet not in _INLETS or b.outlet not in _OUTLETS:
        raise NotImplementedError(f"kernel: BCs {b.inlet}/{b.outlet}")
    if p.wetting_type not in (1, 2) or p.tau_type not in (1, 2) or \
            p.collision not in ("SRT", "MRT"):
        raise NotImplementedError("kernel: wetting/tau/collision option")
    c_r, c_b = (rk_constants(a)[[0, 1, 5]] for a in (p.alpha_r, p.alpha_b))
    grad_w = (1 / 3, 1 / 12) if p.gradient_type == "Anisotropic" \
        else (1.0, 1.0)
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
        outlet_rho=b.outlet_density_r + b.outlet_density_b,
        inlet_rho_r=b.inlet_density_r, inlet_rho_b=b.inlet_density_b,
        variant=_VARIANTS[p.variant], pad2=0,
        inlet_velocity_r=b.inlet_velocity_r,
        inlet_velocity_b=b.inlet_velocity_b, solid_phi=p.solid_phi,
        a_kr=p.a_kr, a_kb=p.a_kb, grad_wa=grad_w[0], grad_wd=grad_w[1],
        c_r=(ctypes.c_double * 3)(*c_r), c_b=(ctypes.c_double * 3)(*c_b))


_fn_cache: dict[str, tuple] = {}
# each library's entry-point prefix and the pointer arguments of its
# <prefix>_step: (s, s2, out, out2, geo).  The f64 instances of the CSF and
# Perturbation steps are libraries of their own, built with -fmad=false,
# with csf2d's and pert2d's entry points.
_ENTRIES = {"csf2d": ("csf2d", 5), "csf2d_f64": ("csf2d", 5),
            "pert2d": ("pert2d", 5), "pert2d_f64": ("pert2d", 5)}
# the kernels the one-step 2-D colour-gradient libraries count, in the
# order of their <prefix>_kernel_launches (csrc/csf2d.cuh's g_csf_launches)
KERNELS = ("tracer_strip_kernel", "strip_kernel", "pert_strip_kernel")


def kernel_launches(lib: str) -> dict[str, int]:
    """Launches of each kernel of ``KERNELS`` by the library `lib` (csf2d,
    coupled2d, pert2d or their f64 libraries) since it was loaded, as the
    library counts them where it launches them."""
    prefix = lib.removesuffix("_f64")
    fn = getattr(build.load_library(lib), f"{prefix}_kernel_launches")
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = None
    out = (ctypes.c_longlong * len(KERNELS))()
    fn(out)
    return dict(zip(KERNELS, out))


def _kernel_fns(lib: str):
    """(<prefix>_step, <prefix>_error_string) of a library, built at first
    use."""
    if lib not in _fn_cache:
        so = build.load_library(lib)
        prefix, pointers = _ENTRIES[lib]
        fn = getattr(so, f"{prefix}_step")
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * pointers + \
            [ctypes.POINTER(CsfParams), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = getattr(so, f"{prefix}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn_cache[lib] = (fn, err)
    return _fn_cache[lib]


def _check_domain(params: CsfParams, geo: torch.Tensor, want, *tensors):
    ny, nx = params.ny, params.nx
    if geo.dtype != want or tuple(geo.shape) != (5, ny, nx):
        raise ValueError(f"state needs {want} geometry planes (5, {ny}, "
                         f"{nx}), got {geo.dtype} {tuple(geo.shape)}")
    if ny < 8 or nx < 3:
        raise NotImplementedError(f"kernel: domain {ny}x{nx} below 8x3")
    for t in tensors:
        if t.device != geo.device:
            raise ValueError(f"state on {t.device}, geometry on {geo.device}")


def _launch(mode: int, a, b, out_a, out_b, params: CsfParams,
            geo: torch.Tensor, lib: str = "csf2d"):
    """One <lib>_step call on the current stream of the state's card: the
    CSF step (csf2d) or the Perturbation step (pert2d); an f64 state runs
    the library's f64 instances (csf2d_f64, pert2d_f64)."""
    dev = a.device
    if a.dtype == torch.float64:
        lib = f"{lib}_f64"
    fn, err = _kernel_fns(lib)
    stream_ptr = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = fn(mode, a.data_ptr(), 0 if b is None else b.data_ptr(),
                  out_a.data_ptr(), 0 if out_b is None else out_b.data_ptr(),
                  geo.data_ptr(), ctypes.byref(params), stream_ptr)
    if code != 0:
        msg = err(code).decode()
        raise RuntimeError(f"{lib}_step launch failed: {msg} ({code})")


def launch_csf2d(s: torch.Tensor, params: CsfParams,
                 geo: torch.Tensor, lib: str = "csf2d") -> torch.Tensor:
    """One kernel step of the compressed CUDA state `s`: (10, ny, nx) in
    the type of the geometry planes `geo` (``geo_stack``, float32 or
    float64), or (11, ny, nx) bfloat16 with float32 planes.  `lib` is the
    variant's library: "csf2d" (K1, K2) or "pert2d" (K4c, K4h).  Not
    counted as a launch."""
    ny, nx = params.ny, params.nx
    bf16 = s.dtype == torch.bfloat16
    planes = 11 if bf16 else 10
    if s.dtype not in _STORAGE_CODE or tuple(s.shape) != (planes, ny, nx):
        raise ValueError(f"state {tuple(s.shape)} {s.dtype}; the kernel "
                         f"takes ({planes}, {ny}, {nx})")
    _check_domain(params, geo, torch.float32 if bf16 else s.dtype, s)
    s = s.contiguous()
    out = torch.empty_like(s)
    _launch(_STORAGE_CODE[s.dtype], s, None, out, None, params, geo, lib)
    return out


def launch_csf2d_split(f_r: torch.Tensor, f_b: torch.Tensor,
                       params: CsfParams, geo: torch.Tensor,
                       lib: str = "csf2d"):
    """One kernel step of the split CUDA state (f_r, f_b), each (9, ny, nx)
    in the type of the geometry planes (float32 or float64).  Returns
    (f_r', f_b').  `lib` is the variant's library: "csf2d" (K6) or
    "pert2d" (K4s).  Not counted as a launch."""
    ny, nx = params.ny, params.nx
    for t in (f_r, f_b):
        if t.dtype not in _SPLIT_CODE or tuple(t.shape) != (9, ny, nx) or \
                t.dtype != f_r.dtype:
            raise ValueError(f"split state {tuple(f_r.shape)} {f_r.dtype}, "
                             f"{tuple(f_b.shape)} {f_b.dtype}; the kernel "
                             f"takes two (9, {ny}, {nx}) float32 or float64")
    _check_domain(params, geo, f_r.dtype, f_r, f_b)
    f_r, f_b = f_r.contiguous(), f_b.contiguous()
    out_r, out_b = torch.empty_like(f_r), torch.empty_like(f_b)
    _launch(_SPLIT_CODE[f_r.dtype], f_r, f_b, out_r, out_b, params, geo, lib)
    return out_r, out_b


def _check_variant(model, variant: str):
    if model.p.variant != variant:
        raise ValueError(f"a {model.p.variant} model on the {variant} kernel")


def csf_step_compressed(s: torch.Tensor, model) -> torch.Tensor:
    """One compressed CSF step (BC rows included) for `model`, a
    ColorGradientRK.  CPU tensor: the plain version.  CUDA tensor: the
    kernel on the model's parameter block and geometry planes, or an
    error; never the plain version."""
    if s.device.type == "cpu":
        return csf_step_compressed_reference(s, model)
    if s.device.type != "cuda":
        raise ValueError(f"no csf kernel for device {s.device}")
    _check_compressed_state(s, model, "CSF")
    out = launch_csf2d(s, model.kernel_params, model.geo_planes)
    csf_step_compressed.launches += 1
    return out


csf_step_compressed.launches = 0


def _check_compressed_state(s, model, variant):
    _check_variant(model, variant)
    model.check_compressed()
    want = torch.bfloat16 if model.storage == "bf16" else model.dtype
    if s.dtype != want:
        raise ValueError(f"state {s.dtype}; the model takes {want}")


def csf_step_compressed_reference(s: torch.Tensor, model) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the model's
    ``plain_step_c`` (``_step_csf_c`` composed from ``ops/``; a bf16 state
    is decoded to f32, stepped and encoded again, as the kernel does in
    its registers)."""
    return model.plain_step_c(s)


def csf_step_split(state, model):
    """One split CSF step (f_r, f_b) -> (f_r', f_b') (BC rows included) for
    `model`, a ColorGradientRK.  CPU tensors: the plain version.  CUDA
    tensors: the kernel, or an error; never the plain version."""
    f_r, f_b = state
    if _on_cpu(f_r, f_b):
        return csf_step_split_reference(state, model)
    _check_split_state(f_r, f_b, model, "CSF")
    out = launch_csf2d_split(f_r, f_b, model.kernel_params, model.geo_planes)
    csf_step_split.launches += 1
    return out


csf_step_split.launches = 0


def _on_cpu(f_r, f_b) -> bool:
    """True for a CPU split state; raises for one on two devices or on a
    device with no kernel."""
    if f_r.device != f_b.device:
        raise ValueError(f"f_r on device {f_r.device}, f_b on {f_b.device}")
    if f_r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no csf kernel for device {f_r.device}")
    return f_r.device.type == "cpu"


def _check_split_state(f_r, f_b, model, variant):
    _check_variant(model, variant)
    if f_r.dtype != model.dtype or f_b.dtype != model.dtype:
        raise ValueError(f"split state {f_r.dtype}/{f_b.dtype}; the model "
                         f"takes {model.dtype}")
    if model.kernel_params is None:
        raise ValueError(f"outlet {model.bcs.outlet} has no kernel; the "
                         "model's path is plain")
    model.check_split()


def csf_step_split_reference(state, model):
    """Plain PyTorch version of the split kernel, on any device: the
    model's ``plain_step`` (``_step_csf`` composed from ``ops/``)."""
    return model.plain_step(state)


def pert_step_compressed(s: torch.Tensor, model) -> torch.Tensor:
    """One compressed Perturbation step (BC rows included) for `model`, a
    Perturbation ColorGradientRK.  CPU tensor: the plain version.  CUDA
    tensor: K4c (f32 / f64) or K4h (bf16), or an error; never the plain
    version."""
    if s.device.type == "cpu":
        return pert_step_compressed_reference(s, model)
    if s.device.type != "cuda":
        raise ValueError(f"no pert kernel for device {s.device}")
    _check_compressed_state(s, model, "Perturbation")
    out = launch_csf2d(s, model.kernel_params, model.geo_planes, "pert2d")
    pert_step_compressed.launches += 1
    return out


pert_step_compressed.launches = 0


def pert_step_compressed_reference(s: torch.Tensor, model) -> torch.Tensor:
    """Plain PyTorch version of K4c/K4h, on any device: the model's
    ``plain_step_c`` (``_step_pert_c`` composed from ``ops/``)."""
    return model.plain_step_c(s)


def pert_step_split(state, model):
    """One split Perturbation step (f_r, f_b) -> (f_r', f_b') (BC rows
    included) for `model`.  CPU tensors: the plain version.  CUDA tensors:
    K4s, or an error; never the plain version."""
    f_r, f_b = state
    if _on_cpu(f_r, f_b):
        return pert_step_split_reference(state, model)
    _check_split_state(f_r, f_b, model, "Perturbation")
    out = launch_csf2d_split(f_r, f_b, model.kernel_params,
                             model.geo_planes, "pert2d")
    pert_step_split.launches += 1
    return out


pert_step_split.launches = 0


def pert_step_split_reference(state, model):
    """Plain PyTorch version of K4s, on any device: the model's
    ``plain_step`` (``_step_perturbation`` composed from ``ops/``)."""
    return model.plain_step(state)


# -- T steps a launch (K3) ----------------------------------------------------

_BLOCK_LIBS = {torch.float64: "csf2d_block_f64",
               torch.float32: "csf2d_block_f32",
               torch.bfloat16: "csf2d_block_bf16"}
BLOCK_LIBRARIES = tuple(_BLOCK_LIBS.values())


def _march_args(params: CsfParams, dtype, split: bool):
    """(shape, compute item size, split, inlet, outlet, wetting, repair) of
    a K3 CSF march plan, or without `wetting` of a Perturbation plan."""
    args = ((params.ny, params.nx), 8 if dtype == torch.float64 else 4,
            bool(split), int(params.inlet != 0), int(params.outlet),
            bool(params.has_wetting), bool(params.phi_repair))
    return args if params.variant == 0 else args[:5] + args[6:]


def _stages_of(params: CsfParams, dtype, split: bool):
    """T -> (stages, arrays) of K3's march for `params` and a state of
    `dtype`, and the plan builder that takes the same arguments."""
    args = _march_args(params, dtype, split)
    if params.variant == 0:
        return (lambda t: march2d.csf2d_stages(args[0][0], t, *args[1:]),
                march2d.csf2d_march_plan)
    return (lambda t: march2d.pert2d_stages(args[0][0], t, *args[1:]),
            march2d.pert2d_march_plan)


def _march_plan(params: CsfParams, dtype, split: bool, steps: int,
                device="cuda"):
    """K3's plan for `params` (either variant) and a state of `dtype`, built
    once a process a configuration: (plan, its table on `device`)."""
    args = _march_args(params, dtype, split)
    key = ("csf2d", params.variant, steps, march2d.ROWS_PER_WAVE) + args
    make = _stages_of(params, dtype, split)[1]
    return march3d.device_plan(key, lambda: make(args[0], steps, *args[1:]),
                               device)


_march_limits: dict = {}


def csf_block_max_steps(dtype, split: bool, params: CsfParams) -> int:
    """The largest T one K3 launch takes for `params` and a state of `dtype`
    (the split layout if `split`): its march plan's, of either variant
    (``march2d.max_steps``)."""
    key = (params.variant,) + _march_args(params, dtype, split)
    if key not in _march_limits:
        _march_limits[key] = march2d.max_steps(
            _stages_of(params, dtype, split)[0])
    return _march_limits[key]


def csf_block_tiling(dtype, split: bool, params: CsfParams,
                     steps: int) -> dict:
    """How a K3 launch of `steps` steps covers the domain of `params` for a
    state of `dtype`: its march plan's fields (levels, lag, rows a wave,
    ring depths and bytes, waves, stages; "march": "rows") and its
    cooperative grid."""
    mode = (_SPLIT_CODE if split else _STORAGE_CODE)[dtype]
    plan, _ = _march_plan(params, dtype, split, steps)
    return plan.fields() | {"march": "rows", "grid": march3d.march_grid(
        _BLOCK_LIBS[dtype], "csf2d", 2, 5, CsfParams,
        10 * params.variant + mode)}


def _launch_block(mode, tensors, params: CsfParams, steps: int):
    """One K3 launch (the row-march of the variant of `params`) of `steps`
    steps on `tensors` (s, s2, out, out2, geo)."""
    lib = _BLOCK_LIBS[tensors[0].dtype]
    plan, table = _march_plan(params, tensors[0].dtype, mode >= 3, steps,
                              tensors[0].device)
    march3d.march_launch(lib, "csf2d", (mode, steps), tensors, plan, table,
                         params)


def launch_csf2d_block(s: torch.Tensor, params: CsfParams, geo: torch.Tensor,
                       steps: int) -> torch.Tensor:
    """`steps` kernel steps (one launch of the row-march, K3c or K3h) of the
    compressed CUDA state `s` (as ``launch_csf2d``), for the variant of
    `params`; a T above the launch's limit is refused.  Not counted as a
    launch."""
    ny, nx = params.ny, params.nx
    bf16 = s.dtype == torch.bfloat16
    planes = 11 if bf16 else 10
    if s.dtype not in _STORAGE_CODE or tuple(s.shape) != (planes, ny, nx):
        raise ValueError(f"state {tuple(s.shape)} {s.dtype}; the kernel "
                         f"takes ({planes}, {ny}, {nx})")
    _check_domain(params, geo, torch.float32 if bf16 else s.dtype, s)
    s = s.contiguous()
    out = torch.empty_like(s)
    _launch_block(_STORAGE_CODE[s.dtype], (s, None, out, None, geo), params,
                  steps)
    return out


def launch_csf2d_block_split(f_r: torch.Tensor, f_b: torch.Tensor,
                             params: CsfParams, geo: torch.Tensor, steps: int):
    """`steps` kernel steps (one launch, K3s) of the split CUDA state
    (f_r, f_b) (as ``launch_csf2d_split``).  Not counted as a launch."""
    ny, nx = params.ny, params.nx
    for t in (f_r, f_b):
        if t.dtype not in _SPLIT_CODE or tuple(t.shape) != (9, ny, nx) or \
                t.dtype != f_r.dtype:
            raise ValueError(f"split state {tuple(f_r.shape)} {f_r.dtype}, "
                             f"{tuple(f_b.shape)} {f_b.dtype}; the kernel "
                             f"takes two (9, {ny}, {nx}) float32 or float64")
    _check_domain(params, geo, f_r.dtype, f_r, f_b)
    f_r, f_b = f_r.contiguous(), f_b.contiguous()
    out_r, out_b = torch.empty_like(f_r), torch.empty_like(f_b)
    _launch_block(_SPLIT_CODE[f_r.dtype], (f_r, f_b, out_r, out_b, geo),
                  params, steps)
    return out_r, out_b


def _block_compressed(s, model, steps, variant, fn):
    build.check_steps(steps)
    if s.device.type != "cuda":
        raise ValueError(f"no csf kernel for device {s.device}")
    _check_variant(model, variant)
    model.check_compressed()
    if s.dtype not in (torch.bfloat16, model.dtype):
        raise ValueError(f"state {s.dtype}; the model takes {model.dtype} or "
                         "bfloat16")
    params = model.kernel_params
    for t in build.split_steps(steps, csf_block_max_steps(s.dtype, False,
                                                          params)):
        s = launch_csf2d_block(s, params, model.geo_planes, t)
        fn.launches += 1
    return s


def _block_split(state, model, steps, variant, fn):
    build.check_steps(steps)
    f_r, f_b = state
    _check_split_state(f_r, f_b, model, variant)
    params = model.kernel_params
    for t in build.split_steps(steps, csf_block_max_steps(f_r.dtype, True,
                                                          params)):
        f_r, f_b = launch_csf2d_block_split(f_r, f_b, params,
                                            model.geo_planes, t)
        fn.launches += 1
    return f_r, f_b


def _block_reference_compressed(s, model, steps, variant):
    """T plain compressed steps of the variant; a bf16 state is decoded
    once, stepped in ``model.dtype`` and encoded once, as K3h does."""
    build.check_steps(steps)
    _check_variant(model, variant)
    model.check_compressed()
    fn = model._step_csf_c if variant == "CSF" else model._step_pert_c
    x = model.unpack_bf16(s) if s.dtype == torch.bfloat16 else s
    for _ in range(steps):
        x = fn(x)
    return model.pack_compressed_bf16(x) if s.dtype == torch.bfloat16 else x


def _block_reference_split(state, model, steps, variant):
    build.check_steps(steps)
    _check_variant(model, variant)
    for _ in range(steps):
        state = model.plain_step(state)
    return state


def csf_block_compressed(s: torch.Tensor, model, steps: int) -> torch.Tensor:
    """`steps` compressed CSF steps of `s` for `model` (BC rows before each
    step).  CPU tensor: the plain version.  CUDA tensor: K3c (f32 / f64) or
    K3h (bf16), the row-march, one launch when T fits one
    (``csf_block_max_steps``), else ``build.split_steps``'s launches, each
    counted; or an error; never the plain version.  A bf16 state is decoded
    and encoded once a launch, so a chunked bf16 call equals the same
    chunks of plain calls."""
    if s.device.type == "cpu":
        return csf_block_compressed_reference(s, model, steps)
    return _block_compressed(s, model, steps, "CSF", csf_block_compressed)


csf_block_compressed.launches = 0


def csf_block_compressed_reference(s, model, steps: int):
    """Plain PyTorch version of K3c/K3h, on any device: `steps` plain
    compressed CSF steps (a bf16 state decoded once, encoded once)."""
    return _block_reference_compressed(s, model, steps, "CSF")


def csf_block_split(state, model, steps: int):
    """`steps` split CSF steps of (f_r, f_b) for `model`.  CPU tensors: the
    plain version.  CUDA tensors: K3s (the row-march), one launch when T fits
    one, else ``build.split_steps``'s launches, each counted; or an
    error."""
    if _on_cpu(*state):
        return csf_block_split_reference(state, model, steps)
    return _block_split(state, model, steps, "CSF", csf_block_split)


csf_block_split.launches = 0


def csf_block_split_reference(state, model, steps: int):
    """Plain PyTorch version of K3s, on any device: `steps` plain split CSF
    steps."""
    return _block_reference_split(state, model, steps, "CSF")


def pert_block_compressed(s: torch.Tensor, model, steps: int) -> torch.Tensor:
    """`steps` compressed Perturbation steps of `s` for `model`.  CPU
    tensor: the plain version.  CUDA tensor: K3c or K3h (the Perturbation
    instances of the row-march), one launch when T fits one
    (``csf_block_max_steps``), else ``build.split_steps``'s launches, each
    counted; or an error.  A bf16 state is decoded and encoded once a
    launch."""
    if s.device.type == "cpu":
        return pert_block_compressed_reference(s, model, steps)
    return _block_compressed(s, model, steps, "Perturbation",
                             pert_block_compressed)


pert_block_compressed.launches = 0


def pert_block_compressed_reference(s, model, steps: int):
    """Plain PyTorch version of the Perturbation K3c/K3h, on any device."""
    return _block_reference_compressed(s, model, steps, "Perturbation")


def pert_block_split(state, model, steps: int):
    """`steps` split Perturbation steps of (f_r, f_b) for `model`.  CPU
    tensors: the plain version.  CUDA tensors: K3s (the Perturbation
    instance of the row-march), one launch when T fits one, else
    ``build.split_steps``'s launches, each counted; or an error."""
    if _on_cpu(*state):
        return pert_block_split_reference(state, model, steps)
    return _block_split(state, model, steps, "Perturbation", pert_block_split)


pert_block_split.launches = 0


def pert_block_split_reference(state, model, steps: int):
    """Plain PyTorch version of the Perturbation K3s, on any device."""
    return _block_reference_split(state, model, steps, "Perturbation")


# -- the local form (K12a): one shard of a decomposed domain ----------------

_LOCAL_LIBS = {torch.float64: "csf2d_local_f64",
               torch.float32: "csf2d_local_f32"}
LOCAL_LIBRARIES = tuple(_LOCAL_LIBS.values())


def _local_fns(lib: str):
    """(step, scratch_bytes, shape, error_string) of a K12a library: ints
    (T, the LocalGrid), pointers (s, out, geo, scratch)."""
    return build.block_fns(lib, "csf2d_local", 8, 4, CsfParams)


def csf_local_frame(params: CsfParams, steps: int, x_axis: bool):
    """The frame (``parallel.mesh.Frame``) a K12a launch of `steps` steps
    reads for the parameter block `params` (global ny): K3's rings (CSF 4,
    Perturbation 2) a step, the inlet ghost's band 1 row below and the
    outlet's 3 rows above; `x_axis` for a mesh with an x axis."""
    from ..parallel.mesh import frame_of
    return frame_of(4 if params.variant == 0 else 2, steps,
                    1 if params.inlet else 0, 3 if params.outlet else 0,
                    params.ny, x_axis)


def _check_local(grid, planes, *pairs):
    """Raise unless each (tensor, planes, dtype) of `pairs` is a contiguous
    ``(planes, py, px)`` buffer of `grid` on the first tensor's card."""
    dev = pairs[0][0].device
    for t, n, want in pairs:
        shape = (*n, grid.py, grid.px) if isinstance(n, tuple) else \
            (n, grid.py, grid.px)
        if t.device != dev or t.device.type != "cuda" or \
                tuple(t.shape) != shape or t.dtype != want or \
                not t.is_contiguous():
            raise ValueError(f"local buffer {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}; the kernel takes a contiguous "
                             f"{shape} {want} on {dev}")


def launch_csf2d_local(s: torch.Tensor, out: torch.Tensor, params: CsfParams,
                       geo: torch.Tensor, grid, steps: int) -> torch.Tensor:
    """`steps` kernel steps (one launch of K12a, the variant of `params`) of
    the shard `grid` (``parallel.mesh.LocalGrid``): `s` its padded
    compressed (10, py, px) f32 or f64 buffer, frame filled, into the
    centre of `out`; `geo` its padded (5, py, px) geometry planes.  Not
    counted as a launch."""
    if s.dtype not in _LOCAL_LIBS:
        raise ValueError(f"state {s.dtype}; K12a takes float32 or float64")
    _check_local(grid, 10, (s, 10, s.dtype), (out, 10, s.dtype),
                 (geo, 5, s.dtype))
    lib = _LOCAL_LIBS[s.dtype]
    build.launch_block(lib, _local_fns(lib), grid.ints(steps), (s, out, geo),
                       params)
    return out


def csf_local_step(s: torch.Tensor, out: torch.Tensor, geo: torch.Tensor,
                   model, grid, steps: int) -> torch.Tensor:
    """`steps` compressed steps of one shard for `model`, a ColorGradientRK
    (CSF or Perturbation) of the global domain: `s` the shard's padded
    buffer (frame filled), the result written into the centre of `out`,
    which is returned; `geo` the shard's padded geometry planes.  CPU
    tensors: the plain version.  CUDA tensors: one launch of K12a, or an
    error; never the plain version."""
    if s.device.type == "cpu":
        grid.centre(out).copy_(csf_local_step_reference(s, model, grid,
                                                        steps))
        return out
    build.check_steps(steps)
    if s.device.type != "cuda":
        raise ValueError(f"no csf kernel for device {s.device}")
    model.check_compressed()
    if s.dtype != model.dtype:
        raise ValueError(f"state {s.dtype}; the model takes {model.dtype}")
    launch_csf2d_local(s, out, model.kernel_params, geo, grid, steps)
    csf_local_step.launches += 1
    return out


csf_local_step.launches = 0


def rest_state(model) -> torch.Tensor:
    """The compressed state at rest, rho = 1 and all blue, on the fluid
    cells of `model`'s domain: what the plain local versions put around a
    shard (any finite state serves; no centre cell reads it)."""
    fl = model.geo_planes[0]
    w = torch.as_tensor(D2Q9.w, dtype=fl.dtype, device=fl.device)
    return torch.cat([w[:, None, None] * fl, torch.zeros_like(fl)[None]])


def csf_local_step_reference(s: torch.Tensor, model, grid, steps: int):
    """Plain PyTorch version of K12a, on any device: the shard's padded
    buffer `s` embedded at its global rows and columns in the domain at
    rest (``parallel.mesh.embed_local``), `steps` plain compressed steps of
    the whole domain (``_step_csf_c`` or ``_step_pert_c``), and the centre
    taken back.  Exact wherever the frame covers the window's reach, which
    the step's frame does: a cell further away cannot reach the centre in
    `steps` steps.  Returns the centre (10, ny, nx) of the shard."""
    from ..parallel.mesh import embed_local, take_centre
    build.check_steps(steps)
    model.check_compressed()
    fn = model._step_csf_c if model.p.variant == "CSF" else model._step_pert_c
    x = embed_local(s, grid, rest_state(model))
    for _ in range(steps):
        x = fn(x)
    return take_centre(x, grid)


def tpu_halo_rows(steps: int, variant: str = "CSF",
                  transport: str | None = None) -> int:
    """The JAX sharded builder's halo depth H (``pallas/csf.py::_halo_rows``
    :58-70), which sets its x-axis refusal ``nx/px <= 2 H`` (:1992-2010);
    the port's frame is its own (``csf_local_frame``)."""
    per = (4 if variant == "CSF" else 2) + (transport == "bounceback")
    margin = 2 if (variant != "CSF" or transport is not None) else 0
    return (per * steps + margin + 7) // 8 * 8


def build_csf_sharded_step(geometry: Geometry, params, mesh,
                           dtype=torch.float32,
                           rows_per_block: int | None = None,
                           steps_per_call: int = 1, bc_config=None,
                           transport_params=None, interpret: bool = False,
                           state_mode: str = "compressed"):
    """The compressed CSF or Perturbation step (K12a) under a y- or (y, x)-
    decomposed `mesh` (``parallel.mesh.make_mesh``): the counterpart of
    ``pallas/csf.py::build_csf_sharded_step``.  `params` a
    ``ColorGradientParams``, `bc_config` a ``CGBoundaryConfig`` (None:
    periodic), `transport_params` a ``TransportParams`` for the coupled
    step (CSF flow only), all the port's.

    Returns a ``parallel.mesh.ShardedStep``: ``step(state)`` advances a
    sharded state ``step.shard(s)`` (or ``step.shard(s, g)`` with the
    tracer PDFs (NT, NQ, ny, nx)) by T = `steps_per_call` steps in place,
    ``step.gather(state)`` gives the global (10, ny, nx) state (and the
    tracer PDFs).  Per call the frames are exchanged, then each shard runs
    K12a (``csf_local_step``) or its coupled form (``kernels/transport.py::
    coupled_local_step``) on a card, its plain version on the CPU.
    ``conserve_mass`` and the redistribute exchange are global epilogues
    and not part of the step, as in the JAX builder (:1976-1980); its
    "y-decomposition only" for the coupled step is stale there and here:
    the (y, x) mesh runs it.

    Returns None where the JAX builder builds no step for a reason of the
    domain or the state: ny not divisible by the mesh's py or nx by its px;
    px > 1 with nx/px <= 2 H (H the JAX halo, ``tpu_halo_rows``); the split
    state, bfloat16 storage, a Perturbation flow with transport; and
    boundary kinds no kernel takes (csf.py:274-278).  The TPU strips'
    constraints (``rows_per_block``, R % H) do not apply here; the port
    refuses instead a shard shallower (or narrower) than the frame it
    sends, since the exchange is one hop: its frame is K3's window reach,
    ``csf_local_frame`` (deeper than H with boundary bands at T >= 2, e.g.
    CSF at T = 2 with an outlet needs 11 rows above, so ny/py = 8 is
    refused where the JAX builder runs).  ``rows_per_block`` and
    ``interpret`` are ignored."""
    del rows_per_block, interpret
    from .._device import resolve_dtype
    from ..models.colorgradient import (BLOCK_INLETS, BLOCK_OUTLETS,
                                        CGBoundaryConfig, ColorGradientRK)
    from ..parallel.mesh import ShardedStep, shard_domain
    from .transport import coupled_local_frame, coupled_local_step

    ny, nx = geometry.shape
    py, px = mesh.shape
    steps = int(steps_per_call)
    build.check_steps(steps)
    dtype = resolve_dtype(dtype)
    tp = transport_params
    if ny % py or nx % px or state_mode != "compressed" or \
            dtype == torch.bfloat16 or (tp is not None and
                                        params.variant != "CSF"):
        return None
    bcs = bc_config if bc_config is not None else CGBoundaryConfig()
    if bcs.inlet not in BLOCK_INLETS or bcs.outlet not in BLOCK_OUTLETS:
        return None
    tr_mode = None if tp is None else (
        "bounceback" if tp.interface_mode in ("bounceback", "redistribute")
        else tp.interface_mode)
    if px > 1 and nx // px <= 2 * tpu_halo_rows(steps, params.variant,
                                                 tr_mode):
        return None
    if tp is None:
        model = ColorGradientRK(geometry, params, bcs, dtype=dtype,
                                device=mesh.device)
        flow = model
        frame = csf_local_frame(model.kernel_params, steps, px > 1)
    else:
        from ..models.transport import TransportRK
        model = TransportRK(geometry, params, tp, bcs, dtype=dtype,
                            device=mesh.device)
        flow = model.flow
        frame = coupled_local_frame(model, steps, px > 1)
    if max(frame.lo, frame.hi) > ny // py or frame.x > nx // px:
        return None
    geo = dict(zip(mesh.local_ids(),
                   shard_domain(flow.geo_planes, mesh, frame)))

    if tp is None:
        def local(k, grid, ins, outs):
            csf_local_step(ins[0], outs[0], geo[k], model, grid, steps)
        dtypes = (dtype,)
    else:
        def local(k, grid, ins, outs):
            coupled_local_step(ins, outs, geo[k], model, grid, steps)
        dtypes = (dtype, dtype)
    step = ShardedStep(mesh, (ny, nx), frame, local, steps, dtypes)
    step.model = model
    return step


def compare_bf16_states(a: torch.Tensor, b: torch.Tensor,
                        where: torch.Tensor) -> dict:
    """Value-by-value gap between two bfloat16 states whose last two planes
    are rho_r's hi and lo halves (the 11-plane 2-D or 21-plane 3-D state),
    on the cells `where` (bool, the spatial shape).

    excess: the largest |a - b| in units of max(one bf16 ulp of the larger
        magnitude, 2^-18), over the PDF planes and hi, and over the lo plane
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
    hi = x.shape[0] - 2
    hi_same = x[hi] == y[hi]
    big = mag >= 1e-4
    return {
        "excess": float(torch.cat([excess[:hi + 1].flatten(),
                                   excess[hi + 1, hi_same]]).max()),
        "share": float((x != y)[big].double().mean()),
        "hi_flips": int((~hi_same).sum())}
