"""The Shan-Chen family's step (K8): CUDA kernel wrapper, plain PyTorch
version and launch count.

Counterpart of ``openlbmpm_tpu/pallas/shanchen.py::build_sc_fused_step`` at
one step per call on one device: original SC or EFS (iso-4/8/10), SRT or
MRT, psi = rho or Peng-Robinson, shift forcing, the Zou-He velocity /
pressure inlet and the Zou-He pressure / convective outlet, any number
of fluids K.  The kernels live in ``csrc/sc2d.cuh``, one library per
storage type (``sc2d_f64``, ``sc2d_f32``, ``sc2d_bf16``), instantiated for K
= 1 ... KMAX.  With ``steps_per_call`` = T > 1 (K8-T: the inlet rows before
and the outlet rows after every sub-step): ``csrc/sc2d_block.cuh``,
libraries ``sc2d_block_{f64,f32,bf16}``.  Above KMAX fluids both run the
runtime-K instance ``csrc/sc2d_rt.cuh`` (library ``sc2d_rt``), which loops
over the fluids and reads their values from a device table
(``fluid_table``, the model's ``kernel_table``).

States: f (K, 9, ny, nx) float32 / float64, or (K, 11, ny, nx) bfloat16
(per fluid the deviations f_i - w_i rho_k, then rho_k as a hi/lo pair).

``sc_step(f, model)`` and ``sc_block_step(f, model, steps)`` take the plain
version only for a tensor on the CPU; for a CUDA tensor they launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes
import inspect

import numpy as np
import torch

from ..geometry import Geometry
from ..ops.shanchen import build_interaction_fields, psi_peng_robinson
from . import build

__all__ = ["KMAX", "LIBRARIES", "BLOCK_LIBRARIES", "RT_LIBRARY", "ScParams",
           "geo_stack", "kernel_params", "fluid_table", "launch_sc2d",
           "sc_step", "sc_step_reference", "launch_sc2d_block",
           "sc_block_step", "sc_block_step_reference", "sc_block_tiling"]

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
        depth={4: 1, 8: 2, 10: 3}[p.iso_order] if efs else 1,
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


def _kernel_fn(lib_name: str):
    if lib_name not in _fn_cache:
        lib = build.load_library(lib_name)
        fn = lib.sc2d_step
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ScParams),
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
    the geometry planes `geo` (``geo_stack``, float32 or float64), or
    (K, 11, ny, nx) bfloat16 with float32 planes; above KMAX fluids the
    runtime-K instance on `table` (``fluid_table`` as a float64 tensor on
    the card).  Not counted as a launch."""
    _check(f, params, geo, table)
    if params.k > KMAX:
        return _launch_rt(f, params, geo, table, 1)
    k, ny, nx = params.k, params.ny, params.nx
    want = torch.float32 if f.dtype == torch.bfloat16 else f.dtype
    fn, err = _kernel_fn(_LIBS[f.dtype])
    f = f.contiguous()
    out = torch.empty_like(f)
    psi = torch.empty((k, ny, nx), dtype=want, device=f.device)
    with torch.cuda.device(f.device):
        code = fn(f.data_ptr(), out.data_ptr(), geo.data_ptr(),
                  psi.data_ptr(), ctypes.byref(params),
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


def _block_fns(lib: str):
    """(step, scratch_bytes, shape, error_string) of a K8-T library: ints
    (T), pointers (f, out, geo, scratch)."""
    return build.block_fns(lib, "sc2d", 1, 4, ScParams)


def sc_block_tiling(dtype, params: ScParams, steps: int) -> dict:
    """How a K8-T launch of `steps` steps tiles the domain of `params` for a
    state of `dtype` (``build.block_tiling``); the runtime-K instance (above
    KMAX fluids) has no tiling."""
    if params.k > KMAX:
        raise ValueError(f"{params.k} fluids run the runtime-K instance, "
                         "which has no window tiling")
    lib = _BLOCK_LIBS[dtype]
    return build.block_tiling(lib, _block_fns(lib), (steps,), params)


def launch_sc2d_block(f: torch.Tensor, params: ScParams, geo: torch.Tensor,
                      steps: int,
                      table: torch.Tensor | None = None) -> torch.Tensor:
    """`steps` kernel steps (one call) of the CUDA state `f` (as
    ``launch_sc2d``; above KMAX fluids the runtime-K instance, which runs
    the steps one after another in the compute type, decoding once and
    encoding once).  Not counted as a launch."""
    build.check_steps(steps)
    _check(f, params, geo, table)
    if params.k > KMAX:
        return _launch_rt(f, params, geo, table, steps)
    f = f.contiguous()
    out = torch.empty_like(f)
    lib = _BLOCK_LIBS[f.dtype]
    build.launch_block(lib, _block_fns(lib), (steps,), (f, out, geo), params)
    return out


def sc_block_step(f: torch.Tensor, model, steps: int) -> torch.Tensor:
    """`steps` Shan-Chen steps (inlet rows before, outlet rows after each)
    for `model`, a ShanChenMCMP: a (K, 9, ny, nx) state in ``model.dtype``
    or the (K, 11, ny, nx) bfloat16 state (``pack_state_bf16``).  CPU
    tensor: the plain version.  CUDA tensor: one launch of K8-T, or an
    error; never the plain version."""
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
    out = launch_sc2d_block(f, model.kernel_params, model.geo_planes, steps,
                            model.kernel_table)
    sc_block_step.launches += 1
    return out


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
