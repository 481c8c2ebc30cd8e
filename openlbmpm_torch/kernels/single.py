"""The single-phase D2Q9 step (K7): CUDA kernel wrapper, plain PyTorch
version and launch count.

Counterpart of
``openlbmpm_tpu/pallas/single.py::build_single_phase_fused_step`` at one
step per call on one device: SRT, TRT or MRT with the Guo body
force, the Zou-He velocity / pressure inlet and the Zou-He pressure /
convective outlet rows.  The kernels live in ``csrc/single2d.cuh``, one
library per storage type (``single2d_f64``, ``single2d_f32``,
``single2d_bf16``).  With ``steps_per_call`` = T > 1 (K7-T, the boundary rows
rewritten after every sub-step): ``csrc/single2d_block.cuh``, libraries
``single2d_block_{f64,f32,bf16}``.

States: f (9, ny, nx) float32 / float64, or (11, ny, nx) bfloat16 (the
deviations f_i - w_i rho, then rho as a hi/lo pair).  The geometry is one
byte a cell (1 on fluid).

``single_step(f, model)`` and ``single_block_step(f, model, steps)`` take
the plain version only for a tensor on the CPU; for a CUDA tensor they
launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["LIBRARIES", "BLOCK_LIBRARIES", "Single2dParams", "kernel_params",
           "launch_single2d", "single_step", "single_step_reference",
           "launch_single2d_block", "single_block_step",
           "single_block_step_reference", "single_block_tiling"]

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


# -- T steps a launch (K7-T) -------------------------------------------------

_BLOCK_LIBS = {torch.float64: "single2d_block_f64",
               torch.float32: "single2d_block_f32",
               torch.bfloat16: "single2d_block_bf16"}
BLOCK_LIBRARIES = tuple(_BLOCK_LIBS.values())


def _block_fns(lib: str):
    """(step, scratch_bytes, shape, error_string) of a K7-T library: ints
    (T), pointers (f, out, fluid, scratch)."""
    return build.block_fns(lib, "single2d", 1, 4, Single2dParams)


def single_block_tiling(dtype, params: Single2dParams, steps: int) -> dict:
    """How a K7-T launch of `steps` steps tiles the domain of `params` for a
    state of `dtype` (``build.block_tiling``)."""
    lib = _BLOCK_LIBS[dtype]
    return build.block_tiling(lib, _block_fns(lib), (steps,), params)


def launch_single2d_block(f: torch.Tensor, params: Single2dParams,
                          fluid: torch.Tensor, steps: int) -> torch.Tensor:
    """`steps` kernel steps (one launch) of the CUDA state `f` (as
    ``launch_single2d``).  Not counted as a launch."""
    ny, nx = params.ny, params.nx
    planes = 11 if f.dtype == torch.bfloat16 else 9
    if f.dtype not in _BLOCK_LIBS or tuple(f.shape) != (planes, ny, nx):
        raise ValueError(f"state {tuple(f.shape)} {f.dtype}; the kernel takes "
                         f"({planes}, {ny}, {nx})")
    if fluid.dtype != torch.uint8 or tuple(fluid.shape) != (ny, nx):
        raise ValueError(f"fluid mask {fluid.dtype} {tuple(fluid.shape)}; the "
                         f"kernel takes uint8 ({ny}, {nx})")
    if f.device != fluid.device or f.device.type != "cuda":
        raise ValueError(f"state on {f.device}, mask on {fluid.device}")
    f = f.contiguous()
    out = torch.empty_like(f)
    lib = _BLOCK_LIBS[f.dtype]
    build.launch_block(lib, _block_fns(lib), (steps,), (f, out, fluid), params)
    return out


def single_block_step(f: torch.Tensor, model, steps: int) -> torch.Tensor:
    """`steps` single-phase steps (BC rows after each) for `model`, a
    SinglePhaseD2Q9: a (9, ny, nx) state in ``model.dtype`` or the
    (11, ny, nx) bfloat16 state (``pack_state_bf16``).  CPU tensor: the plain
    version.  CUDA tensor: one launch of K7-T, or an error; never the plain
    version."""
    if f.device.type == "cpu":
        return single_block_step_reference(f, model, steps)
    build.check_steps(steps)
    if f.device.type != "cuda":
        raise ValueError(f"no single-phase kernel for device {f.device}")
    if model.kernel_params is None:
        raise ValueError(f"no single-phase kernel for this configuration on "
                         f"{model.device} (path {model.path!r})")
    if f.dtype not in (model.dtype, torch.bfloat16) or (
            f.dtype == torch.bfloat16 and model.dtype != torch.float32):
        raise ValueError(f"state {f.dtype}; the model takes {model.dtype} or, "
                         "in float32 arithmetic, bfloat16")
    out = launch_single2d_block(f, model.kernel_params, model.fluid_u8, steps)
    single_block_step.launches += 1
    return out


single_block_step.launches = 0


def single_block_step_reference(f: torch.Tensor, model, steps: int):
    """Plain PyTorch version of K7-T, on any device: `steps` plain steps
    (``_step_impl``); a bf16 state is decoded once, stepped in float32 and
    encoded once, as the kernel does."""
    build.check_steps(steps)
    x = model.unpack_bf16(f) if f.dtype == torch.bfloat16 else f
    for _ in range(steps):
        x = model._step_impl(x)
    return model.pack_state_bf16(x) if f.dtype == torch.bfloat16 else x
