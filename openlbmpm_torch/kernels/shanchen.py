"""The Shan-Chen family's step (K8): CUDA kernel wrapper, plain PyTorch
version and launch count.

Counterpart of ``openlbmpm_tpu/pallas/shanchen.py::build_sc_fused_step`` at
one step per call on one device: original SC or EFS (iso-4/8/10), SRT or
MRT, psi = rho or Peng-Robinson, shift forcing, the Zou-He velocity /
pressure inlet and the Zou-He pressure / convective outlet, any number
of fluids K.  The kernels live in ``csrc/sc2d.cuh``, one library per
storage type (``sc2d_f64``, ``sc2d_f32``, ``sc2d_bf16``), instantiated for K
= 1 ... KMAX: in f32 / f64 one launch of the push (``sc_push_kernel``) a
step and, with an outlet, one of ``sc_outlet_kernel``; in bf16 one launch
of the pull (``collide_stream_kernel``); each library counts them
(``kernel_launches``).  With ``steps_per_call`` = T > 1 (K8-T:
the inlet rows before and the outlet rows after every sub-step): the
row-march of ``csrc/sc2d_march.cuh`` on the plan of
``kernels/march2d.py::sc2d_march_plan``, libraries
``sc2d_block_{f64,f32,bf16}``.  Above KMAX fluids both run the
runtime-K instance ``csrc/sc2d_rt.cuh`` (library ``sc2d_rt``), which loops
over the fluids and reads their values from a device table
(``fluid_table``, the model's ``kernel_table``).  The local form of K8-T
(K12c: one shard of a y-decomposed domain, f32 and f64, any K) is
``sc_local_step``, ``csrc/sc2d_local_{f64,f32}.cu`` (``csrc/
sc2d_local.cuh``), which ``build_sc_sharded_step`` (the counterpart of
``pallas/shanchen.py::build_sc_sharded_step``) drives over a mesh
(``openlbmpm_torch/parallel``).

States: f (K, 9, ny, nx) float32 / float64, or (K, 11, ny, nx) bfloat16
(per fluid the deviations f_i - w_i rho_k, then rho_k as a hi/lo pair).

``sc_step(f, model)``, ``sc_block_step(f, model, steps)`` and
``sc_local_step`` take the plain version only for a tensor on the CPU; for
a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import inspect

import numpy as np
import torch

from ..geometry import Geometry
from ..ops.shanchen import build_interaction_fields, psi_peng_robinson
from . import build, march2d, march3d

__all__ = ["KMAX", "LIBRARIES", "BLOCK_LIBRARIES", "RT_LIBRARY", "ScParams",
           "KERNELS", "kernel_launches",
           "geo_stack", "kernel_params", "fluid_table", "launch_sc2d",
           "sc_step", "sc_step_reference", "launch_sc2d_block",
           "sc_block_step", "sc_block_step_reference", "sc_block_tiling",
           "sc_block_max_steps",
           "LOCAL_LIBRARIES", "sc_local_frame", "launch_sc2d_local",
           "sc_local_step", "sc_local_step_reference",
           "build_sc_sharded_step"]

KMAX = 3           # fluids the template kernels are instantiated for
RT_LIBRARY = "sc2d_rt"   # any number of fluids, f64 / f32 / bf16
_LIBS = {torch.float64: "sc2d_f64", torch.float32: "sc2d_f32",
         torch.bfloat16: "sc2d_bf16"}
LIBRARIES = tuple(_LIBS.values())

_D3 = ctypes.c_double * KMAX


class ScParams(ctypes.Structure):
    """Mirror of ``struct ScParams`` in csrc/sc2d.cuh (same field order).
    The per-fluid arrays hold up to KMAX fluids' values (filler above KMAX
    fluids, whose values the runtime-K instance reads from
    ``fluid_table``)."""
    _fields_ = [
        ("ny", ctypes.c_int), ("nx", ctypes.c_int),
        ("k", ctypes.c_int),
        ("order", ctypes.c_int),    # 0 original SC, 4 | 8 | 10 EFS
        ("inlet", ctypes.c_int),    # 0 periodic, 1 zou_he_velocity, 2 pressure
        ("outlet", ctypes.c_int),   # 0 periodic, 1 zou_he_pressure, 2 convective
        ("depth", ctypes.c_int),
        ("mrt", ctypes.c_int),
        ("psi_pr", ctypes.c_int),
        ("pad", ctypes.c_int),
        ("tau", _D3), ("inv_tau", _D3),
        ("g", _D3 * KMAX),
        ("gs", _D3),
        ("inlet_v", _D3), ("inlet_rho", _D3), ("outlet_rho", _D3),
        ("bfx", ctypes.c_double), ("bfy", ctypes.c_double),
        ("pr_cr", ctypes.c_double), ("pr_t", ctypes.c_double),
        ("pr_aa", ctypes.c_double), ("pr_b", ctypes.c_double),
        ("pr_2b", ctypes.c_double), ("pr_bb", ctypes.c_double),
        ("pr_k2", ctypes.c_double),
    ]


_INLETS = {"periodic": 0, "zou_he_velocity": 1, "zou_he_pressure": 2}
_OUTLETS = {"periodic": 0, "zou_he_pressure": 1, "convective": 2}
# psi_peng_robinson's keyword defaults, overridden by ShanChenParams.pr_params
_PR_DEFAULTS = {name: arg.default for name, arg in
                inspect.signature(psi_peng_robinson).parameters.items()
                if arg.default is not inspect.Parameter.empty}


def geo_stack(geometry: Geometry, params) -> np.ndarray:
    """Static planes the kernel reads (float64): SC [is_fluid, adhesion_x,
    adhesion_y] with the D2Q9 weights; EFS [is_fluid, fluid_vec_x,
    fluid_vec_y, adhesion_st_x, adhesion_st_y] with the stencil's weights
    (``ops/shanchen.py::build_interaction_fields``)."""
    fields = build_interaction_fields(geometry.is_solid,
                                      order=params.iso_order)
    fl = geometry.is_fluid.astype(np.float64)[None]
    if params.scheme == "SC":
        return np.concatenate([fl, fields.adhesion])
    return np.concatenate([fl, fields.fluid_vec, fields.adhesion_st])


def _per_fluid(values, k):
    v = [float(x) for x in np.atleast_1d(np.asarray(values, np.float64))]
    return [v[i % len(v)] for i in range(k)]


def _fixed(values, fill=0.0):
    """The first KMAX of `values` for ScParams' arrays, padded with `fill`;
    all `fill` above KMAX fluids (the runtime-K instance's table holds
    them)."""
    v = list(values) if len(values) <= KMAX else []
    return _D3(*(v + [fill] * (KMAX - len(v))))


def fluid_table(params, bcs) -> np.ndarray:
    """The runtime-K instance's per-fluid table (float64, csrc/sc2d_rt.cuh::
    ScTable): tau, 1/tau, G_ks, inlet velocity, inlet density, outlet
    density (K values each), then G (K x K, row-major)."""
    k = params.num_fluids
    tau = _per_fluid(params.tau, k)
    rows = [tau, [1.0 / t for t in tau], _per_fluid(params.g_solid, k),
            _per_fluid(bcs.inlet_velocity, k),
            _per_fluid(bcs.inlet_density, k),
            _per_fluid(bcs.outlet_density, k)]
    return np.concatenate([np.asarray(rows, np.float64).ravel(),
                           np.asarray(params.g_matrix, np.float64).ravel()])


def _reach(params) -> int:
    """The interaction stencil's reach, which is also the depth d of the
    boundary rows: 1 for SC and EFS iso-4, 2 for iso-8, 3 for iso-10."""
    return {4: 1, 8: 2, 10: 3}[params.iso_order] \
        if params.scheme == "EFS" else 1


def kernel_params(params, bcs, geometry: Geometry) -> ScParams:
    """The kernel's parameter block for a ShanChenParams, SCBoundaryConfig
    and geometry (any number of fluids: above KMAX the per-fluid values
    travel in ``fluid_table``); raises NotImplementedError for a
    configuration the kernel does not take."""
    p, b = params, bcs
    k = p.num_fluids
    ny, nx = geometry.shape
    if k < 1:
        raise NotImplementedError(f"kernel: {k} fluids")
    if p.forcing != "shift" or b.inlet not in _INLETS or \
            b.outlet not in _OUTLETS:
        raise NotImplementedError(f"kernel: forcing {p.forcing}, BCs "
                                  f"{b.inlet}/{b.outlet}")
    if ny < 8 or nx < 3:
        raise NotImplementedError(f"kernel: domain {ny}x{nx} below 8x3")
    efs = p.scheme == "EFS"
    tau = _per_fluid(p.tau, k)
    g = np.zeros((KMAX, KMAX))
    if k <= KMAX:
        g[:k, :k] = np.asarray(p.g_matrix, np.float64)
    pr = _PR_DEFAULTS | dict(p.pr_params)
    bfx, bfy = (float(v) for v in p.body_force)
    return ScParams(
        ny=ny, nx=nx, k=k, order=p.iso_order if efs else 0,
        inlet=_INLETS[b.inlet], outlet=_OUTLETS[b.outlet],
        depth=_reach(p),
        mrt=int(p.collision == "MRT"), psi_pr=int(p.psi == "PR"), pad=0,
        tau=_fixed(tau, 1.0), inv_tau=_fixed([1.0 / t for t in tau], 1.0),
        g=(_D3 * KMAX)(*(_D3(*row) for row in g)),
        gs=_fixed(_per_fluid(p.g_solid, k)),
        inlet_v=_fixed(_per_fluid(b.inlet_velocity, k)),
        inlet_rho=_fixed(_per_fluid(b.inlet_density, k)),
        outlet_rho=_fixed(_per_fluid(b.outlet_density, k)),
        bfx=bfx, bfy=bfy,
        pr_cr=float(pr["const_r"]), pr_t=float(pr["temperature"]),
        pr_aa=float(pr["coeff_a"]) * float(pr["alpha"]),
        pr_b=float(pr["coeff_b"]), pr_2b=2.0 * float(pr["coeff_b"]),
        pr_bb=float(pr["coeff_b"]) * float(pr["coeff_b"]),
        pr_k2=2.0 / (float(pr["c0"]) * float(pr["g"])))


_fn_cache: dict[str, tuple] = {}
# the kernels of the sc2d libraries, in the order of sc2d_kernel_launches'
# counts
KERNELS = ("collide_stream_kernel", "sc_push_kernel", "sc_outlet_kernel")


def kernel_launches(lib_name: str) -> dict[str, int]:
    """Launches of each kernel of ``KERNELS`` by the library `lib_name`
    (sc2d_f64, sc2d_f32 or sc2d_bf16) since it was loaded, as the library
    counts them where it launches them."""
    fn = build.load_library(lib_name).sc2d_kernel_launches
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = None
    out = (ctypes.c_longlong * len(KERNELS))()
    fn(out)
    return dict(zip(KERNELS, out))


def _kernel_fn(lib_name: str):
    if lib_name not in _fn_cache:
        lib = build.load_library(lib_name)
        fn = lib.sc2d_step
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.POINTER(ScParams),
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.sc2d_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn_cache[lib_name] = (fn, err)
    return _fn_cache[lib_name]


def _check(f: torch.Tensor, params: ScParams, geo: torch.Tensor, table):
    k, ny, nx = params.k, params.ny, params.nx
    bf16 = f.dtype == torch.bfloat16
    planes = 11 if bf16 else 9
    if f.dtype not in _LIBS or tuple(f.shape) != (k, planes, ny, nx):
        raise ValueError(f"state {tuple(f.shape)} {f.dtype}; the kernel "
                         f"takes ({k}, {planes}, {ny}, {nx})")
    want = torch.float32 if bf16 else f.dtype
    n_geo = 3 if params.order == 0 else 5
    if geo.dtype != want or tuple(geo.shape) != (n_geo, ny, nx):
        raise ValueError(f"state needs {want} geometry planes ({n_geo}, {ny}, "
                         f"{nx}), got {geo.dtype} {tuple(geo.shape)}")
    if f.device != geo.device or f.device.type != "cuda":
        raise ValueError(f"state on {f.device}, geometry on {geo.device}")
    if k > KMAX and (table is None or table.dtype != torch.float64 or
                     table.device != f.device or
                     table.numel() != 6 * k + k * k):
        raise ValueError(f"{k} fluids need their float64 fluid_table on "
                         f"{f.device}")


def _launch_rt(f: torch.Tensor, params: ScParams, geo: torch.Tensor,
               table: torch.Tensor, steps: int) -> torch.Tensor:
    """`steps` steps of the runtime-K instance (one call)."""
    return build.launch_runtime_k(RT_LIBRARY, "sc2d", ScParams, f, geo, table,
                                  params, steps)


def launch_sc2d(f: torch.Tensor, params: ScParams, geo: torch.Tensor,
                table: torch.Tensor | None = None) -> torch.Tensor:
    """One kernel step of the CUDA state `f`: (K, 9, ny, nx) in the type of
    the geometry planes `geo` (``geo_stack``, float32 or float64), one
    launch of the push and, with an outlet, one of the outlet rows; or
    (K, 11, ny, nx) bfloat16 with float32 planes, one launch of the pull;
    above KMAX fluids the runtime-K instance on `table` (``fluid_table`` as
    a float64 tensor on the card).  Not counted as a launch."""
    _check(f, params, geo, table)
    if params.k > KMAX:
        return _launch_rt(f, params, geo, table, 1)
    fn, err = _kernel_fn(_LIBS[f.dtype])
    f = f.contiguous()
    out = torch.empty_like(f)
    with torch.cuda.device(f.device):
        code = fn(f.data_ptr(), out.data_ptr(), geo.data_ptr(),
                  ctypes.byref(params),
                  torch.cuda.current_stream(f.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"sc2d_step launch failed: {err(code).decode()} "
                           f"({code})")
    return out


def sc_step(f: torch.Tensor, model) -> torch.Tensor:
    """One Shan-Chen step (BC rows included) for `model`, a ShanChenMCMP.
    CPU tensor: the plain version.  CUDA tensor: the kernel on the model's
    parameter block and geometry planes, or an error; never the plain
    version."""
    if f.device.type == "cpu":
        return sc_step_reference(f, model)
    if f.device.type != "cuda":
        raise ValueError(f"no Shan-Chen kernel for device {f.device}")
    if model.kernel_params is None:
        raise ValueError(f"no Shan-Chen kernel for this configuration on "
                         f"{model.device} (path {model.path!r})")
    want = torch.bfloat16 if model.storage == "bf16" else model.dtype
    if f.dtype != want:
        raise ValueError(f"state {f.dtype}; the model takes {want}")
    out = launch_sc2d(f, model.kernel_params, model.geo_planes,
                      model.kernel_table)
    sc_step.launches += 1
    return out


sc_step.launches = 0


def sc_step_reference(f: torch.Tensor, model) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the model's
    ``plain_step`` (``_step_impl`` composed from ``ops/``; a bf16 state is
    decoded to float32, stepped and encoded again, as the kernel does in
    its registers)."""
    return model.plain_step(f)


# -- T steps a launch (K8-T) -------------------------------------------------

_BLOCK_LIBS = {torch.float64: "sc2d_block_f64",
               torch.float32: "sc2d_block_f32",
               torch.bfloat16: "sc2d_block_bf16"}
BLOCK_LIBRARIES = tuple(_BLOCK_LIBS.values())


def _march_args(params: ScParams, dtype):
    """(shape, compute item size, fluids, order, inlet, outlet) of K8-T's
    march plan for `params` and a state of `dtype`."""
    return ((params.ny, params.nx), 8 if dtype == torch.float64 else 4,
            params.k, params.order, int(params.inlet != 0),
            int(params.outlet))


def _march_plan(params: ScParams, dtype, steps: int, device="cuda"):
    """K8-T's plan for `params` and a state of `dtype`, built once a process
    a configuration: (plan, its table on `device`)."""
    args = _march_args(params, dtype)
    key = ("sc2d", steps, march2d.SC_ROWS_PER_WAVE) + args
    return march3d.device_plan(
        key, lambda: march2d.sc2d_march_plan(args[0], steps, *args[1:]),
        device)


def sc_block_tiling(dtype, params: ScParams, steps: int) -> dict:
    """How a K8-T launch of `steps` steps covers the domain of `params` for
    a state of `dtype`: its march plan's fields (levels, lag, rows a wave,
    ring depths and bytes, waves, stages; "march": "rows") and its
    cooperative grid; the runtime-K instance (above KMAX fluids) has no
    plan."""
    if params.k > KMAX:
        raise ValueError(f"{params.k} fluids run the runtime-K instance, "
                         "which has no plan")
    plan, _ = _march_plan(params, dtype, steps)
    return plan.fields() | {"march": "rows", "grid": march3d.march_grid(
        _BLOCK_LIBS[dtype], "sc2d", 1, 3, ScParams,
        100 * params.k + params.order)}


_march_limits: dict = {}


def sc_block_max_steps(dtype, params: ScParams) -> int:
    """The largest T one K8-T launch takes for `params` and a state of
    `dtype`: its march plan's (``march2d.max_steps``: the stages and rings
    the executor's tables hold)."""
    args = _march_args(params, dtype)
    if args not in _march_limits:
        _march_limits[args] = march2d.max_steps(
            lambda t: march2d.sc2d_stages(args[0][0], t, *args[1:]))
    return _march_limits[args]


def launch_sc2d_block(f: torch.Tensor, params: ScParams, geo: torch.Tensor,
                      steps: int,
                      table: torch.Tensor | None = None) -> torch.Tensor:
    """`steps` kernel steps (one cooperative launch of the row-march; a T
    above the launch's limit, ``sc_block_max_steps``, is refused) of the
    CUDA state `f` (as ``launch_sc2d``; above KMAX fluids the runtime-K
    instance, which runs the steps one after another in the compute type,
    decoding once and encoding once).  Not counted as a launch."""
    build.check_steps(steps)
    _check(f, params, geo, table)
    if params.k > KMAX:
        return _launch_rt(f, params, geo, table, steps)
    f = f.contiguous()
    out = torch.empty_like(f)
    plan, plan_t = _march_plan(params, f.dtype, steps, f.device)
    march3d.march_launch(_BLOCK_LIBS[f.dtype], "sc2d", (steps,),
                         (f, out, geo), plan, plan_t, params)
    return out


def sc_block_step(f: torch.Tensor, model, steps: int) -> torch.Tensor:
    """`steps` Shan-Chen steps (inlet rows before, outlet rows after each)
    for `model`, a ShanChenMCMP: a (K, 9, ny, nx) state in ``model.dtype``
    or the (K, 11, ny, nx) bfloat16 state (``pack_state_bf16``).  CPU
    tensor: the plain version.  CUDA tensor: K8-T, one launch when T fits
    one (``sc_block_max_steps``), else ``build.split_steps``'s launches of
    near-equal step counts, each counted; or an error; never the plain
    version.  A bf16 state is decoded and encoded once a launch, so a
    chunked bf16 call equals the same chunks of plain calls.  Above KMAX
    fluids the runtime-K instance takes any T in one call."""
    if f.device.type == "cpu":
        return sc_block_step_reference(f, model, steps)
    build.check_steps(steps)
    if f.device.type != "cuda":
        raise ValueError(f"no Shan-Chen kernel for device {f.device}")
    if model.kernel_params is None:
        raise ValueError(f"no Shan-Chen kernel for this configuration on "
                         f"{model.device} (path {model.path!r})")
    if f.dtype not in (model.dtype, torch.bfloat16) or (
            f.dtype == torch.bfloat16 and model.dtype != torch.float32):
        raise ValueError(f"state {f.dtype}; the model takes {model.dtype} or, "
                         "in float32 arithmetic, bfloat16")
    params = model.kernel_params
    chunks = [steps] if params.k > KMAX else build.split_steps(
        steps, sc_block_max_steps(f.dtype, params))
    for t in chunks:
        f = launch_sc2d_block(f, params, model.geo_planes, t,
                              model.kernel_table)
        sc_block_step.launches += 1
    return f


sc_block_step.launches = 0


def sc_block_step_reference(f: torch.Tensor, model, steps: int):
    """Plain PyTorch version of K8-T, on any device: `steps` plain steps
    (``_step_impl``); a bf16 state is decoded once, stepped in float32 and
    encoded once, as the kernel does."""
    build.check_steps(steps)
    x = model.unpack_bf16(f) if f.dtype == torch.bfloat16 else f
    for _ in range(steps):
        x = model._step_impl(x)
    return model.pack_state_bf16(x) if f.dtype == torch.bfloat16 else x


# -- the local form (K12c): one shard of a y-decomposed domain --------------

_LOCAL_LIBS = {torch.float64: "sc2d_local_f64",
               torch.float32: "sc2d_local_f32"}
LOCAL_LIBRARIES = tuple(_LOCAL_LIBS.values())
_local_rt_cache: dict[str, tuple] = {}


def _local_fns(lib: str):
    """(step, scratch_bytes, shape, error_string) of a K12c library's
    template instances (K <= KMAX): ints (T, the LocalGrid), pointers (f,
    out, geo, scratch)."""
    return build.block_fns(lib, "sc2d_local", 8, 4, ScParams)


def _local_rt_fns(lib: str):
    """(step, scratch_bytes) of a K12c library's runtime-K passes: ints (T,
    the LocalGrid), pointers (f, out, tmp, geo, scratch, table)."""
    if lib not in _local_rt_cache:
        so = build.load_library(lib)
        lead = [ctypes.c_int] * 8
        block = ctypes.POINTER(ScParams)
        step = so.sc2d_local_rt_step
        step.argtypes = lead + [ctypes.c_void_p] * 6 + [block,
                                                        ctypes.c_void_p]
        step.restype = ctypes.c_int
        scratch = so.sc2d_local_rt_scratch_bytes
        scratch.argtypes = lead + [block]
        scratch.restype = ctypes.c_longlong
        _local_rt_cache[lib] = (step, scratch)
    return _local_rt_cache[lib]


def sc_local_frame(params, bcs, steps: int, ny: int):
    """The frame a K12c call of `steps` steps reads for the ShanChenParams
    `params` and SCBoundaryConfig `bcs` of a domain of `ny` rows: reach + 1
    rings a step (psi's stencil, the collision's, streaming), the inlet
    ghosts' band d rows below, the outlet's d + 2 (convective) or d (Zou-He)
    rows above, as ``csrc/sc2d_block.cuh::sc_local_block_shape``.  No x
    frame: K12c decomposes y only."""
    from ..parallel.mesh import frame_of
    d = _reach(params)
    mhi = {"convective": d + 2, "zou_he_pressure": d}.get(bcs.outlet, 0)
    return frame_of(d + 1, steps, 0 if bcs.inlet == "periodic" else d, mhi,
                    ny, False)


def launch_sc2d_local(f: torch.Tensor, out: torch.Tensor, params: ScParams,
                      geo: torch.Tensor, grid, steps: int,
                      table: torch.Tensor | None = None,
                      work: dict | None = None) -> torch.Tensor:
    """`steps` kernel steps (one call of K12c) of the shard `grid`
    (``parallel.mesh.LocalGrid``): `f` its padded (K, 9, py, px) f32 or f64
    buffer, frame filled, into the centre of `out`; `geo` its padded
    geometry planes (``geo_stack``) in `f`'s type.  K <= KMAX: one launch of
    the template instance.  Above KMAX fluids the runtime-K passes on
    `table` (``fluid_table`` as a float64 tensor on the card), their
    scratch and at `steps` > 1 a second state buffer kept in `work`
    (``build.work_buffer``).  Not counted as a launch."""
    from .csf import _check_local
    if f.dtype not in _LOCAL_LIBS:
        raise ValueError(f"state {f.dtype}; K12c takes float32 or float64")
    k = params.k
    n_geo = 3 if params.order == 0 else 5
    _check_local(grid, (k, 9), (f, (k, 9), f.dtype), (out, (k, 9), f.dtype),
                 (geo, n_geo, f.dtype))
    lib = _LOCAL_LIBS[f.dtype]
    ints = grid.ints(steps)
    if k <= KMAX:
        build.launch_block(lib, _local_fns(lib), ints, (f, out, geo), params)
        return out
    if table is None or table.dtype != torch.float64 or \
            table.device != f.device or table.numel() != 6 * k + k * k:
        raise ValueError(f"{k} fluids need their float64 fluid_table on "
                         f"{f.device}")
    step, scratch_bytes = _local_rt_fns(lib)
    scratch = build.work_buffer(
        work, "scratch", (scratch_bytes(*ints, ctypes.byref(params)),),
        torch.uint8, f.device)
    tmp = None if steps == 1 else build.work_buffer(work, "tmp", f.shape,
                                                    f.dtype, f.device)
    with torch.cuda.device(f.device):
        code = step(*ints, f.data_ptr(), out.data_ptr(),
                    0 if tmp is None else tmp.data_ptr(), geo.data_ptr(),
                    scratch.data_ptr(), table.data_ptr(),
                    ctypes.byref(params),
                    torch.cuda.current_stream(f.device).cuda_stream)
    if code != 0:
        err = _local_fns(lib)[3]
        raise RuntimeError(f"sc2d_local_rt_step launch failed: "
                           f"{err(code).decode()} ({code})")
    return out


def sc_local_step(f: torch.Tensor, out: torch.Tensor, geo: torch.Tensor,
                  model, grid, steps: int,
                  work: dict | None = None) -> torch.Tensor:
    """`steps` Shan-Chen steps of one shard for `model`, a ShanChenMCMP of
    the global domain: `f` the shard's padded buffer (frame filled), the
    result written into the centre of `out`, which is returned; `geo` the
    shard's padded geometry planes; `work` a dict that keeps the runtime-K
    passes' scratch from call to call (None: allocated each call).  CPU
    tensors: the plain version.  CUDA tensors: one call of K12c (one launch
    up to KMAX fluids, T one-step passes above), or an error; never the
    plain version."""
    if f.device.type == "cpu":
        grid.centre(out).copy_(sc_local_step_reference(f, model, grid,
                                                       steps))
        return out
    build.check_steps(steps)
    if f.device.type != "cuda":
        raise ValueError(f"no Shan-Chen kernel for device {f.device}")
    if model.kernel_params is None:
        raise ValueError(f"no Shan-Chen kernel for this configuration on "
                         f"{model.device} (path {model.path!r})")
    if f.dtype != model.dtype or model.storage != "f32":
        raise ValueError(f"state {f.dtype}; the model takes {model.dtype} "
                         f"({model.storage} storage), K12c float32 or "
                         "float64")
    params = model.kernel_params
    launch_sc2d_local(f, out, params, geo, grid, steps,
                      None if params.k <= KMAX else model.kernel_table, work)
    sc_local_step.launches += 1
    return out


sc_local_step.launches = 0


def sc_local_step_reference(f: torch.Tensor, model, grid, steps: int):
    """Plain PyTorch version of K12c, on any device: the shard's padded
    buffer embedded at its global rows in the domain at rest (every fluid
    at rho = 1; ``parallel.mesh.embed_local``), `steps` plain steps of the
    whole domain (``_step_impl``), and the centre (K, 9, ny, nx) taken
    back.  Exact: the frame covers the steps' reach."""
    from ..lattice import D2Q9
    from ..parallel.mesh import embed_local, take_centre
    build.check_steps(steps)
    fl = model.fluid_mask
    w = torch.as_tensor(D2Q9.w, dtype=fl.dtype, device=fl.device)
    rest = (w[:, None, None] * fl).expand(f.shape[0], -1, -1, -1)
    x = embed_local(f, grid, rest)
    for _ in range(steps):
        x = model._step_impl(x)
    return take_centre(x, grid)


def build_sc_sharded_step(geometry: Geometry, params, mesh,
                          dtype=torch.float32,
                          rows_per_block: int | None = None,
                          steps_per_call: int = 1, bc_config=None,
                          interpret: bool = False):
    """The Shan-Chen / EFS step (K12c) under a y-decomposed `mesh`
    (``parallel.mesh.make_mesh`` with shape (P, 1)): the counterpart of
    ``pallas/shanchen.py::build_sc_sharded_step``.  `params` a
    ``ShanChenParams`` (any number of fluids), `bc_config` an
    ``SCBoundaryConfig`` (None: periodic).

    Returns a ``parallel.mesh.ShardedStep`` of T = `steps_per_call` steps a
    call: ``step(state)`` advances ``step.shard(f)`` ((K, 9, ny, nx)) in
    place, ``step.gather(state)`` gives the global state.  Per call one
    exchange of the frame (``sc_local_frame``), then each shard runs K12c
    (``sc_local_step``) on a card, its plain version on the CPU.  The
    geometry planes are static: they are sharded once here with the same
    frame (``step.geo``), where the JAX step exchanges their halo every
    call (shanchen.py:908); the results are the same.

    Returns None where the JAX builder builds no step for a reason of the
    domain or the state: a mesh with an x axis larger than 1, ny not
    divisible by the mesh's py (shanchen.py:875), bfloat16 (the JAX local
    kernel refuses bf16 storage, :122-123; the port's local kernels take
    f32 and f64), boundary kinds K8 does not take (:153-156,
    ``models/shanchen.py::takes_kernel``, which also refuses a forcing
    other than "shift" and a domain below 8 x 3).  The TPU strips'
    constraints (rows a block, R % H, the VMEM budget, :130-146) do not
    apply; the port refuses instead a shard shallower than the frame it
    sends (the exchange is one hop).  ``rows_per_block`` and ``interpret``
    are ignored."""
    del rows_per_block, interpret
    from .._device import resolve_dtype
    from ..models.shanchen import (SCBoundaryConfig, ShanChenMCMP,
                                   takes_kernel)
    from ..parallel.mesh import ShardedStep, shard_domain

    ny, nx = geometry.shape
    py, px = mesh.shape
    steps = int(steps_per_call)
    build.check_steps(steps)
    dtype = resolve_dtype(dtype)
    bcs = bc_config if bc_config is not None else SCBoundaryConfig()
    if px != 1 or ny % py or dtype == torch.bfloat16 or \
            not takes_kernel(params, bcs, False, (ny, nx)):
        return None
    frame = sc_local_frame(params, bcs, steps, ny)
    if max(frame.lo, frame.hi) > ny // py:
        return None
    model = ShanChenMCMP(geometry, params, bcs, dtype=dtype,
                         device=mesh.device)
    geo = dict(zip(mesh.local_ids(), shard_domain(
        geo_stack(geometry, params), mesh, frame, dtype=dtype)))
    work = {k: {} for k in mesh.local_ids()}

    def local(k, grid, ins, outs):
        sc_local_step(ins[0], outs[0], geo[k], model, grid, steps, work[k])

    step = ShardedStep(mesh, (ny, nx), frame, local, steps, (dtype,))
    step.model = model
    step.geo = geo
    return step
