"""The D3Q19 single-phase step (K11) and Shan-Chen step (K10): CUDA kernel
wrappers, plain PyTorch versions and launch counts.

Counterparts, at one step per call on one device, of
``openlbmpm_tpu/pallas/single3d.py::build_single3d_fused_step`` (SRT or TRT
with the Guo body force) and ``openlbmpm_tpu/pallas/sc3d.py::
build_sc3d_fused_step`` (any number of fluids, psi = rho, the static
adhesion field, SRT toward the shifted-velocity equilibrium), both periodic
in x, y and z with walls from the mask.  The device code is
``csrc/flow3d.cuh``, built as one library per storage type (``flow3d_f64``,
``flow3d_f32``, ``flow3d_bf16``) and instantiated for K = 1 ... KMAX fluids
(K11 one launch a step, ``single_push_kernel`` in f32 / f64 storage and
``march_kernel`` in bf16; K10 one, ``sc_push_kernel``, in f32 / f64 storage
and two in bf16, ``rho_kernel`` and ``march_kernel``; the libraries count
them: ``kernel_launches``);
above KMAX, K10 and K10-T run the runtime-K instance ``csrc/sc3d_rt.cuh``
(library ``sc3d_rt``), which loops over the fluids and reads their values
from a device table (``sc3d_table``, the model's ``kernel_table``).

States: (19, nz, ny, nx) and (K, 19, nz, ny, nx) in float32 / float64, or
21 bfloat16 planes a fluid (the deviations f_i - w_i rho, then rho as a
hi/lo pair).  The geometry is one byte a cell (1 on fluid); K10 derives the
adhesion field from it.

``single3d_step(f, model)`` and ``sc3d_step(f, model)`` take the plain
version only for a tensor on the CPU; for a CUDA tensor they launch the
kernel or raise.

The T-step forms (K11-T, K10-T: ``steps_per_call`` = T > 1 of the same TPU
kernels) are ``single3d_block_step(f, model, steps)`` and
``sc3d_block_step(f, model, steps)``: one launch of
``csrc/flow3d_block_{f64,f32,bf16}.cu`` (``csrc/flow3d_block.cuh``) advances
T steps, a bf16 state decoded once and encoded once; a launch takes at
most ``MAX_BLOCK_STEPS`` (the mirror of ``csrc/flow3d_block.cuh::
kMaxSteps3``, which the libraries' ``flow3d_block_max_steps`` returns), and
a call of more steps runs as ``build.split_steps``'s launches of near-equal
step counts.  Both run the pipelined z-march of ``csrc/march3d.cuh``, K11-T
on the plan of ``kernels/march3d.py::single3d_march_plan``, K10-T on that of
``sc3d_march_plan``, which the wrapper builds once a shape and hands to the
kernel with a scratch buffer for its rings.

The local form of K10 (K12e: one shard of a z-decomposed domain, the
counterpart of ``pallas/sc3d.py::build_sc3d_sharded_step``) is
``csrc/flow3d_local_{f64,f32}.cu`` (``csrc/flow3d_local.cuh``): T one-step
launches of ``sc_push_kernel`` a call over slab ranges that shrink by two a
step;
``build_sc3d_sharded_step`` drives it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..geometry import Geometry
from ..lattice import D3Q19
from . import build
from . import march3d

__all__ = ["LIBRARIES", "KMAX", "RT_LIBRARY", "Flow3dParams", "KERNELS",
           "kernel_launches",
           "geo_stack_sc3", "single3d_params", "sc3d_params", "sc3d_table",
           "launch_single3d", "launch_sc3d",
           "single3d_step", "single3d_step_reference", "sc3d_step",
           "sc3d_step_reference", "BLOCK_LIBRARIES", "MAX_BLOCK_STEPS",
           "flow3d_block_max_steps",
           "flow3d_block_tiling", "launch_flow3d_block",
           "single3d_block_step", "single3d_block_step_reference",
           "sc3d_block_step", "sc3d_block_step_reference",
           "LOCAL_LIBRARIES", "sc3d_local_frame", "launch_sc3d_local",
           "sc3d_local_step", "sc3d_local_step_reference",
           "build_sc3d_sharded_step"]

KMAX = 3           # fluids K10's templates are instantiated for
RT_LIBRARY = "sc3d_rt"   # any number of fluids, f64 / f32 / bf16
_LIBS = {torch.float64: "flow3d_f64", torch.float32: "flow3d_f32",
         torch.bfloat16: "flow3d_bf16"}
LIBRARIES = tuple(_LIBS.values())

_D3 = ctypes.c_double * KMAX


class Flow3dParams(ctypes.Structure):
    """Mirror of ``struct Flow3dParams`` in csrc/flow3d.cuh (same field
    order).  The per-fluid arrays hold up to KMAX fluids' values (filler
    above KMAX fluids, whose values the runtime-K instance reads from
    ``sc3d_table``)."""
    _fields_ = [
        ("nz", ctypes.c_int), ("ny", ctypes.c_int), ("nx", ctypes.c_int),
        ("k", ctypes.c_int),
        ("collision", ctypes.c_int),   # single-phase: 0 SRT, 1 TRT
        ("force", ctypes.c_int),       # single-phase: 1 with a body force
        ("tau", _D3),
        ("g", _D3 * KMAX),
        ("gs", _D3),
        ("bf", ctypes.c_double * 3),
    ]


def geo_stack_sc3(geometry: Geometry) -> np.ndarray:
    """[is_fluid, adh_x, adh_y, adh_z] (float64): the static adhesion field
    sum_i w_i e_i is_solid(x + e_i) (``pallas/sc3d.py::geo_stack_sc3``,
    ``ShanChenMCMP3D.adhesion``), summed in the order the kernel sums it."""
    lat = D3Q19
    solid = geometry.is_solid.astype(np.float64)
    adh = [np.zeros_like(solid) for _ in range(3)]
    for i in range(1, lat.q):
        s = np.roll(np.roll(np.roll(solid, -int(lat.e[i, 2]), 0),
                            -int(lat.e[i, 1]), 1), -int(lat.e[i, 0]), 2)
        for d in range(3):
            ed = int(lat.e[i, d])
            if ed:
                adh[d] += float(lat.w[i]) * ed * s
    return np.stack([geometry.is_fluid.astype(np.float64), *adh])


def _check_domain(geometry: Geometry):
    nz, ny, nx = geometry.shape
    if nz < 3 or ny < 3 or nx < 3:
        raise NotImplementedError(f"kernel: domain {nz}x{ny}x{nx} below "
                                  "3x3x3")


def single3d_params(model) -> Flow3dParams:
    """K11's parameter block for a SinglePhaseD3Q19; raises
    NotImplementedError for a configuration it does not take (MRT, which
    the JAX build function refuses too)."""
    if model.collision not in ("SRT", "TRT"):
        raise NotImplementedError(f"kernel: collision {model.collision}")
    _check_domain(model.geo)
    nz, ny, nx = model.geo.shape
    return Flow3dParams(
        nz=nz, ny=ny, nx=nx, k=1, collision=int(model.collision == "TRT"),
        force=int(any(model.body_force)), tau=_D3(model.tau, 1.0, 1.0),
        bf=(ctypes.c_double * 3)(*model.body_force))


def sc3d_params(params, geometry: Geometry) -> Flow3dParams:
    """K10's parameter block for a ShanChenParams3D and geometry (any number
    of fluids: above KMAX their values travel in ``sc3d_table``); raises
    NotImplementedError for a configuration it does not take."""
    k = params.num_fluids
    if k < 1 or params.psi != "rho":
        raise NotImplementedError(f"kernel: {k} fluids, psi {params.psi} (it "
                                  "takes psi = rho)")
    _check_domain(geometry)
    nz, ny, nx = geometry.shape
    g = np.zeros((KMAX, KMAX))
    tau, gs = [1.0] * KMAX, [0.0] * KMAX
    if k <= KMAX:
        g[:k, :k] = np.asarray(params.g_matrix, np.float64)
        tau[:k] = [float(t) for t in params.tau]
        gs[:k] = [float(v) for v in params.g_solid]
    return Flow3dParams(
        nz=nz, ny=ny, nx=nx, k=k, collision=0, force=0, tau=_D3(*tau),
        g=(_D3 * KMAX)(*(_D3(*row) for row in g)), gs=_D3(*gs),
        bf=(ctypes.c_double * 3)(*(float(v) for v in params.body_force)))


def sc3d_table(params) -> np.ndarray:
    """The runtime-K instance's per-fluid table (float64, csrc/sc3d_rt.cuh::
    Sc3Table): tau, G_ks (K values each), then G (K x K, row-major)."""
    return np.concatenate([np.asarray(params.tau, np.float64),
                           np.asarray(params.g_solid, np.float64),
                           np.asarray(params.g_matrix, np.float64).ravel()])


_fn_cache: dict[str, tuple] = {}


def _kernel_fn(lib_name: str):
    if lib_name not in _fn_cache:
        lib = build.load_library(lib_name)
        single = lib.flow3d_single_step
        single.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.POINTER(Flow3dParams), ctypes.c_void_p]
        single.restype = ctypes.c_int
        sc = lib.flow3d_sc_step
        sc.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(Flow3dParams),
                                               ctypes.c_void_p]
        sc.restype = ctypes.c_int
        err = lib.flow3d_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn_cache[lib_name] = (single, sc, err)
    return _fn_cache[lib_name]


# the kernels of the flow3d libraries, in the order of flow3d_kernel_launches'
# counts: K11's in bf16 (and K10's second in bf16), K10's in f32 / f64
# storage, K10's first in bf16, K11's in f32 / f64 storage
KERNELS = ("march_kernel", "sc_push_kernel", "rho_kernel",
           "single_push_kernel")


def kernel_launches(lib_name: str) -> dict[str, int]:
    """Launches of each kernel of ``KERNELS`` by the library `lib_name`
    (flow3d_f64, flow3d_f32 or flow3d_bf16) since it was loaded, as the
    library counts them where it launches them."""
    fn = build.load_library(lib_name).flow3d_kernel_launches
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = None
    out = (ctypes.c_longlong * len(KERNELS))()
    fn(out)
    return dict(zip(KERNELS, out))


def _check(f: torch.Tensor, shape, fluid: torch.Tensor, params):
    if f.dtype not in _LIBS or tuple(f.shape) != shape:
        raise ValueError(f"state {tuple(f.shape)} {f.dtype}; the kernel takes "
                         f"{shape}")
    grid = (params.nz, params.ny, params.nx)
    if fluid.dtype != torch.uint8 or tuple(fluid.shape) != grid:
        raise ValueError(f"fluid mask {fluid.dtype} {tuple(fluid.shape)}; the "
                         f"kernel takes uint8 {grid}")
    if f.device != fluid.device or f.device.type != "cuda":
        raise ValueError(f"state on {f.device}, mask on {fluid.device}")


def _planes(f: torch.Tensor) -> int:
    return 21 if f.dtype == torch.bfloat16 else 19


def launch_single3d(f: torch.Tensor, params: Flow3dParams,
                    fluid: torch.Tensor) -> torch.Tensor:
    """One K11 step of the CUDA state `f`: (19, nz, ny, nx) float32 or
    float64, or (21, nz, ny, nx) bfloat16; `fluid` the (nz, ny, nx) uint8
    mask.  Not counted as a launch."""
    _check(f, (_planes(f), params.nz, params.ny, params.nx), fluid, params)
    single, _, err = _kernel_fn(_LIBS[f.dtype])
    f = f.contiguous()
    out = torch.empty_like(f)
    with torch.cuda.device(f.device):
        code = single(f.data_ptr(), out.data_ptr(), fluid.data_ptr(),
                      ctypes.byref(params),
                      torch.cuda.current_stream(f.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"flow3d_single_step launch failed: "
                           f"{err(code).decode()} ({code})")
    return out


def _launch_rt(f: torch.Tensor, params: Flow3dParams, fluid: torch.Tensor,
               table, steps: int) -> torch.Tensor:
    """`steps` steps of the runtime-K instance (one call) on `table`
    (``sc3d_table`` as a float64 tensor on the card)."""
    k = params.k
    if table is None or table.dtype != torch.float64 or \
            table.device != f.device or table.numel() != 2 * k + k * k:
        raise ValueError(f"{k} fluids need their float64 sc3d_table on "
                         f"{f.device}")
    return build.launch_runtime_k(RT_LIBRARY, "sc3d", Flow3dParams, f, fluid,
                                  table, params, steps)


def launch_sc3d(f: torch.Tensor, params: Flow3dParams, fluid: torch.Tensor,
                table: torch.Tensor | None = None) -> torch.Tensor:
    """One K10 step of the CUDA state `f`: (K, 19, nz, ny, nx) float32 or
    float64, or (K, 21, nz, ny, nx) bfloat16; `fluid` the (nz, ny, nx) uint8
    mask; above KMAX fluids the runtime-K instance on `table`.  Not counted
    as a launch."""
    grid = (params.nz, params.ny, params.nx)
    _check(f, (params.k, _planes(f), *grid), fluid, params)
    if params.k > KMAX:
        return _launch_rt(f, params, fluid, table, 1)
    _, sc, err = _kernel_fn(_LIBS[f.dtype])
    f = f.contiguous()
    out = torch.empty_like(f)
    # bf16 storage: the scratch of rho_kernel (f32 and f64 take none)
    rho = (torch.empty((params.k, *grid), dtype=torch.float32,
                       device=f.device) if f.dtype == torch.bfloat16 else None)
    with torch.cuda.device(f.device):
        code = sc(f.data_ptr(), out.data_ptr(), fluid.data_ptr(),
                  None if rho is None else rho.data_ptr(),
                  ctypes.byref(params),
                  torch.cuda.current_stream(f.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"flow3d_sc_step launch failed: "
                           f"{err(code).decode()} ({code})")
    return out


def _kernel_state(f: torch.Tensor, model, what: str):
    if f.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {f.device}")
    if model.kernel_params is None:
        raise ValueError(f"no {what} kernel for this configuration on "
                         f"{model.device} (path {model.path!r})")
    want = torch.bfloat16 if model.storage == "bf16" else model.dtype
    if f.dtype != want:
        raise ValueError(f"state {f.dtype}; the model takes {want}")


def single3d_step(f: torch.Tensor, model) -> torch.Tensor:
    """One D3Q19 single-phase step for `model`, a SinglePhaseD3Q19.  CPU
    tensor: the plain version.  CUDA tensor: K11, or an error; never the
    plain version."""
    if f.device.type == "cpu":
        return single3d_step_reference(f, model)
    _kernel_state(f, model, "D3Q19 single-phase")
    out = launch_single3d(f, model.kernel_params, model.fluid_u8)
    single3d_step.launches += 1
    return out


single3d_step.launches = 0


def single3d_step_reference(f: torch.Tensor, model) -> torch.Tensor:
    """Plain PyTorch version of K11, on any device: the model's
    ``plain_step``."""
    return model.plain_step(f)


def sc3d_step(f: torch.Tensor, model) -> torch.Tensor:
    """One D3Q19 Shan-Chen step for `model`, a ShanChenMCMP3D.  CPU tensor:
    the plain version.  CUDA tensor: K10, or an error; never the plain
    version."""
    if f.device.type == "cpu":
        return sc3d_step_reference(f, model)
    _kernel_state(f, model, "D3Q19 Shan-Chen")
    out = launch_sc3d(f, model.kernel_params, model.fluid_u8,
                      model.kernel_table)
    sc3d_step.launches += 1
    return out


sc3d_step.launches = 0


def sc3d_step_reference(f: torch.Tensor, model) -> torch.Tensor:
    """Plain PyTorch version of K10, on any device: the model's
    ``plain_step``."""
    return model.plain_step(f)


# -- T steps a launch (K11-T, K10-T) -----------------------------------------

_BLOCK_LIBS = {torch.float64: "flow3d_block_f64",
               torch.float32: "flow3d_block_f32",
               torch.bfloat16: "flow3d_block_bf16"}
BLOCK_LIBRARIES = tuple(_BLOCK_LIBS.values())
# the launchers' refusal, a mirror of csrc/flow3d_block.cuh::kMaxSteps3
# (K11-T, K10-T); the wrappers split a call by the library's own
# flow3d_block_max_steps
MAX_BLOCK_STEPS = 8
_KIND = {"single": 0, "sc": 1}
# the march library prefix of each kind
_PREFIX = {"single": "single3d", "sc": "sc3d"}


def _march_plan(kind: str, params: Flow3dParams, dtype, steps: int,
                device="cuda"):
    """K11-T's (`kind` "single") or K10-T's ("sc") plan for `params` and a
    state of `dtype` (its compute type's item size), built once a process a
    shape: (plan, its table on `device`)."""
    itemsize = 8 if dtype == torch.float64 else 4
    shape = (params.nz, params.ny, params.nx)
    if kind == "single":
        key = ("single3d", shape, steps, itemsize)
        make = lambda: march3d.single3d_march_plan(shape, steps, itemsize)
    else:
        key = ("sc3d", shape, params.k, steps, itemsize)
        make = lambda: march3d.sc3d_march_plan(shape, params.k, steps,
                                               itemsize)
    return march3d.device_plan(key, make, device)


def flow3d_block_tiling(dtype, kind: str, params: Flow3dParams,
                        steps: int) -> dict:
    """How a K11-T (`kind` "single") or K10-T ("sc") launch of `steps`
    steps covers the domain of `params` for a state of `dtype`: its march
    plan's levels, lag (slabs a level trails the one before), slabs a wave,
    bands, band rows and halo rows, ring slabs of level 0's arrays, scratch
    bytes, waves and stages, and the cooperative grid (blocks).  The
    runtime-K instance (above KMAX fluids) has no tiling."""
    if kind == "sc" and params.k > KMAX:
        raise ValueError(f"{params.k} fluids run the runtime-K instance, "
                         "which has no tiling")
    plan, _ = _march_plan(kind, params, dtype, steps)
    which = params.collision if kind == "single" else params.k
    return plan.fields() | {"grid": march3d.march_grid(
        _BLOCK_LIBS[dtype], _PREFIX[kind], 1, 3, Flow3dParams, which)}


def launch_flow3d_block(f: torch.Tensor, params: Flow3dParams,
                        fluid: torch.Tensor, kind: str, steps: int,
                        table: torch.Tensor | None = None) -> torch.Tensor:
    """`steps` kernel steps (one call) of the CUDA state `f`: K11-T (`kind`
    "single", as ``launch_single3d`` takes it: the z-march on
    ``single3d_march_plan``'s plan) or K10-T ("sc", as ``launch_sc3d``: the
    z-march on ``sc3d_march_plan``'s plan; above KMAX fluids the runtime-K
    instance on `table`, which runs the steps one after another in the
    compute type, decoding once and encoding once).  Not counted as a
    launch."""
    grid = (params.nz, params.ny, params.nx)
    lead = () if kind == "single" else (params.k,)
    _check(f, (*lead, _planes(f), *grid), fluid, params)
    build.check_steps(steps)
    if kind == "sc" and params.k > KMAX:
        return _launch_rt(f, params, fluid, table, steps)
    if steps > MAX_BLOCK_STEPS:
        raise ValueError(f"steps {steps}: the kernel takes at most "
                         f"{MAX_BLOCK_STEPS} a launch")
    f = f.contiguous()
    out = torch.empty_like(f)
    plan, table = _march_plan(kind, params, f.dtype, steps, f.device)
    march3d.march_launch(_BLOCK_LIBS[f.dtype], _PREFIX[kind], (steps,),
                         (f, out, fluid), plan, table, params)
    return out


def flow3d_block_max_steps(dtype, kind: str) -> int:
    """The largest T one K11-T (`kind` "single") or K10-T ("sc") launch
    takes for a state of `dtype`: the library's ``kMaxSteps3``
    (``build.max_steps``)."""
    return build.max_steps(_BLOCK_LIBS[dtype], "flow3d_block", (_KIND[kind],))


def _block_calls(f: torch.Tensor, model, kind: str, steps: int, fn):
    """`steps` steps of the CUDA state `f` as ``build.split_steps``'s
    launches of ``launch_flow3d_block``, each counted on `fn`; above KMAX
    fluids one call of the runtime-K instance."""
    params = model.kernel_params
    table = model.kernel_table if kind == "sc" else None
    if kind == "sc" and params.k > KMAX:
        chunks = [steps]
    else:
        chunks = build.split_steps(steps, flow3d_block_max_steps(f.dtype,
                                                                 kind))
    for t in chunks:
        f = launch_flow3d_block(f, params, model.fluid_u8, kind, t, table)
        fn.launches += 1
    return f


def _block_state(f: torch.Tensor, model, steps, what: str):
    build.check_steps(steps)
    if f.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {f.device}")
    if model.kernel_params is None:
        raise ValueError(f"no {what} kernel for this configuration on "
                         f"{model.device} (path {model.path!r})")
    if f.dtype not in (model.dtype, torch.bfloat16) or (
            f.dtype == torch.bfloat16 and model.dtype != torch.float32):
        raise ValueError(f"state {f.dtype}; the model takes {model.dtype} or, "
                         "in float32 arithmetic, bfloat16")


def _block_reference(f: torch.Tensor, model, steps: int) -> torch.Tensor:
    """`steps` plain steps (``_step_impl``); a bf16 state decoded once,
    stepped in float32 and encoded once, as the T-step kernels do."""
    build.check_steps(steps)
    bf16 = f.dtype == torch.bfloat16
    x = model.unpack_bf16(f) if bf16 else f
    for _ in range(steps):
        x = model._step_impl(x)
    return model.pack_state_bf16(x) if bf16 else x


def single3d_block_step(f: torch.Tensor, model, steps: int) -> torch.Tensor:
    """`steps` D3Q19 single-phase steps for `model`, a SinglePhaseD3Q19: a
    (19, nz, ny, nx) state in ``model.dtype`` or the (21, nz, ny, nx)
    bfloat16 state.  CPU tensor: the plain version.  CUDA tensor: K11-T,
    one launch when T fits one (``flow3d_block_max_steps``), else
    ``build.split_steps``'s launches, each counted; or an error; never the
    plain version.  A bf16 state is decoded and encoded once a launch, so a
    chunked bf16 call equals the same chunks of plain calls."""
    if f.device.type == "cpu":
        return single3d_block_step_reference(f, model, steps)
    _block_state(f, model, steps, "D3Q19 single-phase")
    return _block_calls(f, model, "single", steps, single3d_block_step)


single3d_block_step.launches = 0


def single3d_block_step_reference(f: torch.Tensor, model,
                                  steps: int) -> torch.Tensor:
    """Plain PyTorch version of K11-T, on any device: `steps` plain steps
    (a bf16 state decoded once and encoded once)."""
    return _block_reference(f, model, steps)


def sc3d_block_step(f: torch.Tensor, model, steps: int) -> torch.Tensor:
    """`steps` D3Q19 Shan-Chen steps for `model`, a ShanChenMCMP3D: a
    (K, 19, nz, ny, nx) state in ``model.dtype`` or the (K, 21, nz, ny, nx)
    bfloat16 state.  CPU tensor: the plain version.  CUDA tensor: K10-T,
    one launch when T fits one (``flow3d_block_max_steps``), else
    ``build.split_steps``'s launches, each counted (above KMAX fluids one
    call of the runtime-K instance); or an error; never the plain version.
    A bf16 state is decoded and encoded once a launch, so a chunked bf16
    call equals the same chunks of plain calls."""
    if f.device.type == "cpu":
        return sc3d_block_step_reference(f, model, steps)
    _block_state(f, model, steps, "D3Q19 Shan-Chen")
    return _block_calls(f, model, "sc", steps, sc3d_block_step)


sc3d_block_step.launches = 0


def sc3d_block_step_reference(f: torch.Tensor, model,
                              steps: int) -> torch.Tensor:
    """Plain PyTorch version of K10-T, on any device: `steps` plain steps
    (a bf16 state decoded once and encoded once)."""
    return _block_reference(f, model, steps)


# -- the local form (K12e): one shard of a z-decomposed domain ---------------

_LOCAL_LIBS = {torch.float64: "flow3d_local_f64",
               torch.float32: "flow3d_local_f32"}
LOCAL_LIBRARIES = tuple(_LOCAL_LIBS.values())
_local_cache: dict[str, tuple] = {}


def sc3d_local_frame(steps: int):
    """The frame (``parallel.mesh.Frame``) of a K12e shard at T = `steps`:
    2T slabs below and above (the interaction stencil and streaming, one
    slab each a step), no y frame."""
    from ..parallel.mesh import Frame
    build.check_steps(steps)
    return Frame(2 * steps, 2 * steps, 0)


def _local_fns(lib_name: str):
    """(step, scratch_bytes, error_string) of a K12e library."""
    if lib_name not in _local_cache:
        lib = build.load_library(lib_name)
        step = lib.flow3d_local_sc_step
        step.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [
            ctypes.POINTER(Flow3dParams), ctypes.c_void_p]
        step.restype = ctypes.c_int
        scratch = lib.flow3d_local_scratch_bytes
        scratch.argtypes = [ctypes.POINTER(Flow3dParams)]
        scratch.restype = ctypes.c_longlong
        err = lib.flow3d_local_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _local_cache[lib_name] = (step, scratch, err)
    return _local_cache[lib_name]


def launch_sc3d_local(f: torch.Tensor, out: torch.Tensor,
                      params: Flow3dParams, fluid: torch.Tensor, grid,
                      steps: int, table: torch.Tensor | None = None,
                      work: dict | None = None) -> None:
    """`steps` K10 steps (one call of K12e) of the shard `grid`
    (``parallel.mesh.LocalGrid`` of a 3-D domain, frame 2 `steps` slabs):
    its padded (K, 19, pz, ny, nx) f32 or f64 buffer `f`, frame filled, into
    the centre of `out`; `fluid` its padded uint8 mask; above KMAX fluids
    `table` the float64 ``sc3d_table`` on the card.  The scratch (above KMAX
    fluids the runtime-K passes' planes, and at T > 1 a second state buffer
    for the sub-steps) is kept in `work`
    (``build.work_buffer``).  Not counted as a launch."""
    build.check_steps(steps)
    if f.dtype not in _LOCAL_LIBS:
        raise ValueError(f"state {f.dtype}; K12e takes float32 or float64")
    if grid.fy != 2 * steps or grid.fx != 0:
        raise ValueError(f"frame {grid.fy} slabs, {grid.fx} rows; K12e at "
                         f"T = {steps} reads {2 * steps} slabs, no rows")
    p = Flow3dParams.from_buffer_copy(params)
    p.nz = grid.py
    shape = (p.k, 19, p.nz, p.ny, p.nx)
    for t in (f, out):
        if tuple(t.shape) != shape or t.dtype != f.dtype or \
                t.device != f.device or not t.is_contiguous():
            raise ValueError(f"local buffer {tuple(t.shape)} {t.dtype}; "
                             f"K12e takes a contiguous {shape} {f.dtype}")
    _check(f, shape, fluid, p)
    if p.k > KMAX and (table is None or table.dtype != torch.float64 or
                       table.device != f.device):
        raise ValueError(f"{p.k} fluids need their float64 sc3d_table on "
                         f"{f.device}")
    step, scratch_bytes, err = _local_fns(_LOCAL_LIBS[f.dtype])
    scratch = build.work_buffer(work, "scratch",
                                (scratch_bytes(ctypes.byref(p)),),
                                torch.uint8, f.device)
    tmp = None if steps == 1 else build.work_buffer(work, "tmp", shape,
                                                    f.dtype, f.device)
    with torch.cuda.device(f.device):
        code = step(steps, f.data_ptr(), out.data_ptr(),
                    0 if tmp is None else tmp.data_ptr(),
                    fluid.data_ptr(), scratch.data_ptr(),
                    0 if table is None else table.data_ptr(),
                    ctypes.byref(p),
                    torch.cuda.current_stream(f.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"flow3d_local_sc_step launch failed: "
                           f"{err(code).decode()} ({code})")


def sc3d_local_step(f: torch.Tensor, out: torch.Tensor, fluid: torch.Tensor,
                    model, grid, steps: int, work: dict | None = None):
    """`steps` D3Q19 Shan-Chen steps of one shard for `model`, a
    ShanChenMCMP3D of the global domain: `f` the shard's padded buffer
    (frame filled), the result written into the centre of `out`, which is
    returned; `fluid` the shard's padded uint8 mask; `work` a dict that
    keeps the kernel's scratch from call to call (None: allocated each
    call).  CPU tensors: the plain version.  CUDA tensors: one call of
    K12e (T one-step launches over shrinking slab ranges), or an error;
    never the plain version."""
    if f.device.type == "cpu":
        grid.centre(out).copy_(sc3d_local_step_reference(f, model, grid,
                                                         steps))
        return out
    if f.device.type != "cuda":
        raise ValueError(f"no sc3d kernel for device {f.device}")
    if model.kernel_params is None:
        raise ValueError(f"no sc3d kernel for this configuration on "
                         f"{model.device} (path {model.path!r})")
    if f.dtype != model.dtype or model.storage != "f32":
        raise ValueError(f"state {f.dtype}; the model takes {model.dtype} "
                         f"({model.storage} storage), K12e float32 or "
                         "float64")
    params = model.kernel_params
    table = None if params.k <= KMAX else model.kernel_table
    launch_sc3d_local(f, out, params, fluid, grid, steps, table, work)
    sc3d_local_step.launches += 1
    return out


sc3d_local_step.launches = 0


def sc3d_local_step_reference(f: torch.Tensor, model, grid, steps: int):
    """Plain version of K12e, on any device: the shard's padded buffer
    embedded at its global slabs in the domain (0 elsewhere), `steps` plain
    steps (``_step_impl``), the centre taken back.  Exact: the frame covers
    the `steps` steps' reach.  Returns the centre (K, 19, nz, ny, nx)."""
    from ..parallel.mesh import embed_local, take_centre
    build.check_steps(steps)
    x = embed_local(f, grid, f.new_zeros((*f.shape[:2], *model.geo.shape)))
    for _ in range(steps):
        x = model._step_impl(x)
    return take_centre(x, grid)


def build_sc3d_sharded_step(geometry: Geometry, params, mesh,
                            dtype=torch.float32, steps_per_call: int = 1):
    """The D3Q19 Shan-Chen step (K12e) under a z-decomposed `mesh`
    (``parallel.mesh.make_mesh`` with shape (P, 1): its y axis splits z):
    the counterpart of ``pallas/sc3d.py::build_sc3d_sharded_step``.
    `params` a ``ShanChenParams3D`` (any number of fluids).

    Returns a ``parallel.mesh.ShardedStep`` of T = `steps_per_call` steps a
    call: ``step(state)`` advances ``step.shard(f)`` ((K, 19, nz, ny, nx))
    in place, ``step.gather(state)`` gives the global state.  Per call one
    exchange of a 2T-slab frame, then each shard runs K12e
    (``sc3d_local_step``) on a card, its plain version on the CPU.

    Returns None where the JAX builder builds no step for a reason of the
    domain or the state: an x axis larger than 1; nz not divisible by the
    mesh's py; psi other than "rho"; bfloat16 storage.  The TPU strips'
    constraints (slabs a block, a halo H >= 2T dividing the strip and
    nz/py, the VMEM model) do not apply here; the port refuses instead a
    shard shallower than its frame (2T slabs) and a domain below 3x3x3,
    which no K10 takes."""
    from .._device import resolve_dtype
    from ..models.flow3d import ShanChenMCMP3D
    from ..parallel.mesh import ShardedStep, shard_domain

    nz, ny, nx = geometry.shape
    py, px = mesh.shape
    steps = int(steps_per_call)
    build.check_steps(steps)
    dtype = resolve_dtype(dtype)
    if px != 1 or nz % py or params.psi != "rho" or dtype == torch.bfloat16:
        return None
    frame = sc3d_local_frame(steps)
    if min(nz, ny, nx) < 3 or frame.lo > nz // py:
        return None
    model = ShanChenMCMP3D(geometry, params, dtype=dtype, device=mesh.device)
    fluid = dict(zip(mesh.local_ids(), shard_domain(
        torch.as_tensor(geometry.is_fluid, dtype=torch.uint8), mesh, frame,
        rank=3)))
    work = {k: {} for k in mesh.local_ids()}

    def local(k, grid, ins, outs):
        sc3d_local_step(ins[0], outs[0], fluid[k], model, grid, steps,
                        work[k])

    step = ShardedStep(mesh, (nz, ny, nx), frame, local, steps, (dtype,))
    step.model = model
    return step
