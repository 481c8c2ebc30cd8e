"""The single-phase D2Q9 step (K7): CUDA kernel wrapper, plain PyTorch
version and launch count.

Counterpart of
``openlbmpm_tpu/pallas/single.py::build_single_phase_fused_step`` at one
step per call on one device: SRT, TRT or MRT with the Guo body
force, the Zou-He velocity / pressure inlet and the Zou-He pressure /
convective outlet rows.  The kernels live in ``csrc/single2d.cuh``, one
library per storage type (``single2d_f64``, ``single2d_f32``,
``single2d_bf16``).

States: f (9, ny, nx) float32 / float64, or (11, ny, nx) bfloat16 (the
deviations f_i - w_i rho, then rho as a hi/lo pair).  The geometry is one
byte a cell (1 on fluid).

``single_step(f, model)`` takes the plain version only for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["LIBRARIES", "Single2dParams", "kernel_params", "launch_single2d",
           "single_step", "single_step_reference"]

_LIBS = {torch.float64: "single2d_f64", torch.float32: "single2d_f32",
         torch.bfloat16: "single2d_bf16"}
LIBRARIES = tuple(_LIBS.values())

_COLLISIONS = {"SRT": 0, "TRT": 1, "MRT": 2}
_INLETS = {"periodic": 0, "zou_he_velocity": 1, "zou_he_pressure": 2}
_OUTLETS = {"periodic": 0, "zou_he_pressure": 1, "convective": 2}


class Single2dParams(ctypes.Structure):
    """Mirror of ``struct Single2dParams`` in csrc/single2d.cuh (same field
    order)."""
    _fields_ = [
        ("ny", ctypes.c_int), ("nx", ctypes.c_int),
        ("collision", ctypes.c_int),   # 0 SRT, 1 TRT, 2 MRT
        ("force", ctypes.c_int),       # 1 with a body force
        ("inlet", ctypes.c_int),    # 0 periodic, 1 zou_he_velocity, 2 pressure
        ("outlet", ctypes.c_int),   # 0 periodic, 1 zou_he_pressure,
        #                             2 convective
        ("tau", ctypes.c_double),
        ("bfx", ctypes.c_double), ("bfy", ctypes.c_double),
        ("inlet_v", ctypes.c_double), ("inlet_rho", ctypes.c_double),
        ("outlet_rho", ctypes.c_double),
    ]


def kernel_params(model) -> Single2dParams:
    """The kernel's parameter block for a SinglePhaseD2Q9; raises
    NotImplementedError for a configuration the kernel does not take."""
    b = model.bcs
    ny, nx = model.geo.shape
    if b.inlet not in _INLETS or b.outlet not in _OUTLETS or \
            model.upwind_moving is not None:
        raise NotImplementedError(f"kernel: BCs {b.inlet}/{b.outlet}, moving "
                                  f"wall {model.upwind_moving is not None}")
    if ny < 8 or nx < 3:
        raise NotImplementedError(f"kernel: domain {ny}x{nx} below 8x3")
    bfx, bfy = model.body_force
    return Single2dParams(
        ny=ny, nx=nx, collision=_COLLISIONS[model.collision],
        force=int(bool(bfx or bfy)), inlet=_INLETS[b.inlet],
        outlet=_OUTLETS[b.outlet], tau=model.tau, bfx=bfx, bfy=bfy,
        inlet_v=float(b.inlet_velocity), inlet_rho=float(b.inlet_density),
        outlet_rho=float(b.outlet_density))


_fn_cache: dict[str, tuple] = {}


def _kernel_fn(lib_name: str):
    if lib_name not in _fn_cache:
        lib = build.load_library(lib_name)
        fn = lib.single2d_step
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.POINTER(Single2dParams),
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.single2d_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn_cache[lib_name] = (fn, err)
    return _fn_cache[lib_name]


def launch_single2d(f: torch.Tensor, params: Single2dParams,
                    fluid: torch.Tensor) -> torch.Tensor:
    """One kernel step of the CUDA state `f`: (9, ny, nx) float32 or
    float64, or (11, ny, nx) bfloat16; `fluid` the (ny, nx) uint8 mask.
    Not counted as a launch."""
    ny, nx = params.ny, params.nx
    planes = 11 if f.dtype == torch.bfloat16 else 9
    if f.dtype not in _LIBS or tuple(f.shape) != (planes, ny, nx):
        raise ValueError(f"state {tuple(f.shape)} {f.dtype}; the kernel takes "
                         f"({planes}, {ny}, {nx})")
    if fluid.dtype != torch.uint8 or tuple(fluid.shape) != (ny, nx):
        raise ValueError(f"fluid mask {fluid.dtype} {tuple(fluid.shape)}; the "
                         f"kernel takes uint8 ({ny}, {nx})")
    if f.device != fluid.device or f.device.type != "cuda":
        raise ValueError(f"state on {f.device}, mask on {fluid.device}")
    fn, err = _kernel_fn(_LIBS[f.dtype])
    f = f.contiguous()
    out = torch.empty_like(f)
    with torch.cuda.device(f.device):
        code = fn(f.data_ptr(), out.data_ptr(), fluid.data_ptr(),
                  ctypes.byref(params),
                  torch.cuda.current_stream(f.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"single2d_step launch failed: "
                           f"{err(code).decode()} ({code})")
    return out


def single_step(f: torch.Tensor, model) -> torch.Tensor:
    """One single-phase step (BC rows included) for `model`, a
    SinglePhaseD2Q9.  CPU tensor: the plain version.  CUDA tensor: the
    kernel on the model's parameter block and mask, or an error; never the
    plain version."""
    if f.device.type == "cpu":
        return single_step_reference(f, model)
    if f.device.type != "cuda":
        raise ValueError(f"no single-phase kernel for device {f.device}")
    if model.kernel_params is None:
        raise ValueError(f"no single-phase kernel for this configuration on "
                         f"{model.device} (path {model.path!r})")
    want = torch.bfloat16 if model.storage == "bf16" else model.dtype
    if f.dtype != want:
        raise ValueError(f"state {f.dtype}; the model takes {want}")
    out = launch_single2d(f, model.kernel_params, model.fluid_u8)
    single_step.launches += 1
    return out


single_step.launches = 0


def single_step_reference(f: torch.Tensor, model) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the model's
    ``plain_step`` (``_step_impl`` composed from ``ops/``; a bf16 state is
    decoded to float32, stepped and encoded again)."""
    return model.plain_step(f)
