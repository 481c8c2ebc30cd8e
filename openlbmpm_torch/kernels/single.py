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
``single2d_block_{f64,f32,bf16}``.  The local form of K7-T (K12b: one
shard of a y-decomposed domain, f32 and f64) is ``single_local_step``,
``csrc/single2d_local_{f64,f32}.cu``, which ``build_single_sharded_step``
(the counterpart of ``pallas/single.py::build_single_sharded_step``)
drives over a mesh (``openlbmpm_torch/parallel``).

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
           "single_block_step_reference", "single_block_tiling",
           "single_block_max_steps",
           "LOCAL_LIBRARIES", "single_local_frame", "launch_single2d_local",
           "single_local_step", "single_local_step_reference",
           "build_single_sharded_step"]

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


def single_block_max_steps(dtype, params: Single2dParams) -> int:
    """The largest T one K7-T launch takes for `params` and a state of
    `dtype`: the library's window limit (``build.max_steps``)."""
    lib = _BLOCK_LIBS[dtype]
    return build.max_steps(lib, "single2d_block", (), params)


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
    version.  CUDA tensor: K7-T, one launch when T fits one
    (``single_block_max_steps``), else ``build.split_steps``'s launches of
    near-equal step counts, each counted; or an error; never the plain
    version.  A bf16 state is decoded and encoded once a launch, so a
    chunked bf16 call equals the same chunks of plain calls."""
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
    params = model.kernel_params
    for t in build.split_steps(steps, single_block_max_steps(f.dtype,
                                                             params)):
        f = launch_single2d_block(f, params, model.fluid_u8, t)
        single_block_step.launches += 1
    return f


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


# -- the local form (K12b): one shard of a y-decomposed domain --------------

_LOCAL_LIBS = {torch.float64: "single2d_local_f64",
               torch.float32: "single2d_local_f32"}
LOCAL_LIBRARIES = tuple(_LOCAL_LIBS.values())


def _local_fns(lib: str):
    """(step, scratch_bytes, shape, error_string) of a K12b library: ints
    (T, the LocalGrid), pointers (f, out, fluid, scratch)."""
    return build.block_fns(lib, "single2d_local", 8, 4, Single2dParams)


def single_local_frame(bcs, steps: int, ny: int):
    """The frame a K12b launch of `steps` steps reads for the boundary
    configuration `bcs` of a domain of `ny` rows: one ring a step, the
    inlet ghost's band 1 row below, the outlet's 3 (convective) or 1
    (Zou-He) rows above, as ``csrc/single2d_block.cuh::
    single_block_shape``.  No x frame: K12b decomposes y only."""
    from ..parallel.mesh import frame_of
    mhi = {"convective": 3, "zou_he_pressure": 1}.get(bcs.outlet, 0)
    return frame_of(1, steps, 0 if bcs.inlet == "periodic" else 1, mhi, ny,
                    False)


def launch_single2d_local(f: torch.Tensor, out: torch.Tensor,
                          params: Single2dParams, fluid: torch.Tensor, grid,
                          steps: int) -> torch.Tensor:
    """`steps` kernel steps (one launch of K12b) of the shard `grid`
    (``parallel.mesh.LocalGrid``): `f` its padded (9, py, px) f32 or f64
    buffer, frame filled, into the centre of `out`; `fluid` its padded
    uint8 mask (py, px).  Not counted as a launch."""
    from .csf import _check_local
    if f.dtype not in _LOCAL_LIBS:
        raise ValueError(f"state {f.dtype}; K12b takes float32 or float64")
    _check_local(grid, 9, (f, 9, f.dtype), (out, 9, f.dtype),
                 (fluid[None], 1, torch.uint8))
    lib = _LOCAL_LIBS[f.dtype]
    build.launch_block(lib, _local_fns(lib), grid.ints(steps),
                       (f, out, fluid), params)
    return out


def single_local_step(f: torch.Tensor, out: torch.Tensor,
                      fluid: torch.Tensor, model, grid,
                      steps: int) -> torch.Tensor:
    """`steps` single-phase steps of one shard for `model`, a
    SinglePhaseD2Q9 of the global domain: `f` the shard's padded buffer
    (frame filled), the result written into the centre of `out`, which is
    returned; `fluid` the shard's padded uint8 mask.  CPU tensors: the
    plain version.  CUDA tensors: one launch of K12b, or an error; never
    the plain version."""
    if f.device.type == "cpu":
        grid.centre(out).copy_(single_local_step_reference(f, model, grid,
                                                           steps))
        return out
    build.check_steps(steps)
    if f.device.type != "cuda":
        raise ValueError(f"no single-phase kernel for device {f.device}")
    if model.kernel_params is None:
        raise ValueError(f"no single-phase kernel for this configuration on "
                         f"{model.device} (path {model.path!r})")
    if f.dtype != model.dtype:
        raise ValueError(f"state {f.dtype}; the model takes {model.dtype}")
    launch_single2d_local(f, out, model.kernel_params, fluid, grid, steps)
    single_local_step.launches += 1
    return out


single_local_step.launches = 0


def single_local_step_reference(f: torch.Tensor, model, grid, steps: int):
    """Plain PyTorch version of K12b, on any device: the shard's padded
    buffer embedded at its global rows in the domain at rest (rho = 1;
    ``parallel.mesh.embed_local``), `steps` plain steps of the whole domain
    (``_step_impl``), and the centre (9, ny, nx) taken back."""
    from ..lattice import D2Q9
    from ..parallel.mesh import embed_local, take_centre
    build.check_steps(steps)
    fl = model.fluid_mask
    w = torch.as_tensor(D2Q9.w, dtype=fl.dtype, device=fl.device)
    x = embed_local(f, grid, w[:, None, None] * fl)
    for _ in range(steps):
        x = model._step_impl(x)
    return take_centre(x, grid)


def build_single_sharded_step(geometry, tau: float, collision: str,
                              body_force, mesh, bc_config=None,
                              dtype=torch.float32,
                              rows_per_block: int | None = None,
                              steps_per_call: int = 1,
                              interpret: bool = False):
    """The single-phase step (K12b) under a y-decomposed `mesh`
    (``parallel.mesh.make_mesh``): the counterpart of ``pallas/single.py::
    build_single_sharded_step``.  `bc_config` a ``BoundaryConfig`` (None:
    periodic).  Returns a ``parallel.mesh.ShardedStep`` (``shard(f)``,
    ``step(state)`` of T = `steps_per_call` steps in place,
    ``gather(state)`` the global (9, ny, nx) state): per call the frames
    are exchanged, then each shard runs K12b (``single_local_step``) on a
    card, its plain version on the CPU.

    Returns None where the JAX builder does: a mesh with an x axis larger
    than 1, ny not divisible by the mesh's py (single.py:477-481), and
    boundary kinds K7 does not take (``models/single_phase.py::
    takes_kernel``).  The TPU strips' constraints do not apply; the port
    refuses instead a shard shallower than the frame it sends
    (``single_local_frame``; the exchange is one hop).
    ``rows_per_block`` and ``interpret`` are ignored."""
    del rows_per_block, interpret
    from .._device import resolve_dtype
    from ..models.single_phase import (BoundaryConfig, SinglePhaseD2Q9,
                                       takes_kernel)
    from ..parallel.mesh import ShardedStep, shard_domain

    ny, nx = geometry.shape
    py, px = mesh.shape
    steps = int(steps_per_call)
    build.check_steps(steps)
    bcs = bc_config if bc_config is not None else BoundaryConfig()
    if px != 1 or ny % py or not takes_kernel(bcs, False):
        return None
    frame = single_local_frame(bcs, steps, ny)
    if max(frame.lo, frame.hi) > ny // py:
        return None
    dtype = resolve_dtype(dtype)
    model = SinglePhaseD2Q9(geometry, tau, collision, body_force, bcs,
                            dtype=dtype, device=mesh.device)
    fluid = dict(zip(mesh.local_ids(), shard_domain(
        torch.as_tensor(geometry.is_fluid, dtype=torch.uint8), mesh, frame)))

    def local(k, grid, ins, outs):
        single_local_step(ins[0], outs[0], fluid[k], model, grid, steps)

    step = ShardedStep(mesh, (ny, nx), frame, local, steps, (dtype,))
    step.model = model
    return step
