"""The coupled CSF + tracer step: CUDA kernel wrappers, plain PyTorch
versions and launch counts.

Counterpart of ``openlbmpm_tpu/pallas/csf.py::build_csf_fused_step`` with
``transport_params`` at one step per call: ``state_mode="compressed"``
(K5c; an f64 or f32 flow state, or the 11-plane bf16 one) and
``state_mode="split"`` (K5s, with ``standalone`` transport).  The split
model's ``conserve_mass`` and ``redistribute`` repairs, which the JAX
package composes after its kernel as jnp ops, are PyTorch ops of
``TransportRK.repair``; the split wrappers hand them the pre-step velocity
and transport-domain mask.  The kernels live in ``csrc/coupled2d.cu``; the
flow half runs the same code as ``csrc/csf2d.cu`` (shared through
``csrc/csf2d.cuh``).

The compressed coupled state is ``(s, g)``: ``s`` as in ``kernels/csf.py``
and ``g`` (NT, NQ, ny, nx) tracer PDFs in the arithmetic type (float64 with
an f64 state, float32 with an f32 or bf16 one), NQ 5 (D2Q5) or 9 (D2Q9).
The split one is a ``TransportState`` (f_r, f_b, g, mass0).

``coupled_step_compressed(s, g, model)`` and ``coupled_step_split(state,
model)`` take the plain version only when the tensors lie on the CPU; for
CUDA tensors they launch the kernels or raise.

The T-step form (K5c-T, ``steps_per_call`` = T > 1 of the same TPU kernel)
is ``coupled_block_compressed((s, g), model, steps)`` and
``coupled_block_split(state, model, steps)``: one launch of
``csrc/coupled2d_block_{f64,f32,bf16}.cu`` (the row-march of
``csrc/march2d.cuh``, one cooperative launch on the plan of
``kernels/march2d.py::coupled2d_march_plan``) advances T coupled steps, a
bf16 flow state decoded once and encoded once; a call above one launch's
limit (``coupled_block_max_steps``, the plan's) runs as
``build.split_steps``'s launches.

The local form (K12a with transport: one shard of a y or (y, x)
decomposed domain, compressed f32 and f64 flow, D2Q5 and D2Q9 tracers) is
``coupled_local_step``, ``csrc/coupled2d_local_{f64,f32}.cu``, which
``kernels/csf.py::build_csf_sharded_step`` drives with ``transport_params``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build, march2d, march3d
from .csf import _SPLIT_CODE, _STORAGE_CODE, CsfParams

__all__ = ["TracerParams", "tracer_kernel_params", "tracer_table",
           "launch_coupled2d", "launch_coupled2d_split",
           "coupled_step_compressed", "coupled_step_compressed_reference",
           "coupled_step_split", "coupled_step_split_reference",
           "CoupledParams", "BLOCK_LIBRARIES", "coupled_block_params",
           "coupled_block_tiling", "coupled_block_max_steps",
           "launch_coupled2d_block",
           "launch_coupled2d_block_split", "coupled_block_compressed",
           "coupled_block_compressed_reference", "coupled_block_split",
           "coupled_block_split_reference", "LOCAL_LIBRARIES",
           "coupled_local_frame", "launch_coupled2d_local",
           "coupled_local_step", "coupled_local_step_reference"]


class TracerParams(ctypes.Structure):
    """Mirror of ``struct TracerParams`` in csrc/coupled2d.cu."""
    _fields_ = [
        ("nt", ctypes.c_int), ("nq", ctypes.c_int),
        ("mrt", ctypes.c_int), ("quadratic", ctypes.c_int),
        ("interface", ctypes.c_int),  # 0 none, 1 permeable, 2 bounceback
        ("inlet", ctypes.c_int),      # 0 none, 1 inamuro, 2 anti-bb, 3 zero
        ("outlet", ctypes.c_int),     # 0 none, 1 freeflow
        ("reaction", ctypes.c_int),
        ("standalone", ctypes.c_int),  # 1: tracer sub-step only
        ("pad", ctypes.c_int),
        ("criteria", ctypes.c_double), ("rate", ctypes.c_double),
    ]


# redistribute confines the tracer as bounceback does inside the kernel
_INTERFACE = {"none": 0, "permeable": 1, "bounceback": 2, "redistribute": 2}
_INLET = {"none": 0, "inamuro": 1, "anti_bounce_back": 2, "zero": 3}
_OUTLET = {"none": 0, "freeflow": 1}


def tracer_kernel_params(tp, standalone: bool = False) -> TracerParams:
    """The kernel's option block for a TransportParams (options already
    checked by the model)."""
    return TracerParams(
        nt=tp.num_tracers, nq=tp.scheme, mrt=int(tp.relaxation == "MRT"),
        quadratic=int(tp.mrt_equilibrium == "quadratic"),
        interface=_INTERFACE[tp.interface_mode], inlet=_INLET[tp.inlet],
        outlet=_OUTLET[tp.outlet], reaction=int(bool(tp.reaction_rate)),
        standalone=int(standalone), pad=0, criteria=tp.criteria,
        rate=tp.reaction_rate)


def tracer_table(model) -> np.ndarray:
    """(NT, 9 + NQ*NQ) per-tracer rows the kernel reads: tau, beta,
    stoich, inlet concentration, J_0..J_4, then the MRT update matrix U
    (row-major; zeros for SRT), from a TransportRK's expanded values."""
    nq = model.lat_tr.q
    rows = []
    for t in range(model.tp.num_tracers):
        u = model.mrt_update[t] if model.mrt_update is not None \
            else np.zeros((nq, nq))
        rows.append(np.concatenate([
            [model.tau_tr[t], model.beta[t], model.stoich[t],
             model.inlet_conc[t]], model.j_coeffs[t], u.reshape(-1)]))
    return np.stack(rows)


_fn_cache: dict[str, tuple] = {}


def _kernel_fns(lib: str):
    """(coupled2d_step, coupled2d_error_string) of `lib`, coupled2d or
    coupled2d_f64 (the f64 instances, built with -fmad=false), built at
    first use."""
    if lib not in _fn_cache:
        so = build.load_library(lib)
        fn = so.coupled2d_step
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + \
            [ctypes.POINTER(CsfParams), ctypes.POINTER(TracerParams),
             ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = so.coupled2d_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn_cache[lib] = (fn, err)
    return _fn_cache[lib]


def _check_tracers(g, params: CsfParams, tparams: TracerParams,
                   geo: torch.Tensor, table: torch.Tensor, *flow):
    ny, nx = params.ny, params.nx
    nt, nq = tparams.nt, tparams.nq
    want = geo.dtype
    if g.dtype != want or tuple(g.shape) != (nt, nq, ny, nx):
        raise ValueError(f"tracer PDFs {tuple(g.shape)} {g.dtype}; the "
                         f"kernel takes ({nt}, {nq}, {ny}, {nx}) {want}")
    if table.dtype != want or tuple(table.shape) != (nt, 9 + nq * nq):
        raise ValueError(f"tracer table {tuple(table.shape)} {table.dtype}")
    if tuple(geo.shape) != (5, ny, nx):
        raise ValueError(f"geometry planes {tuple(geo.shape)}")
    if ny < 8 or nx < 3:
        raise NotImplementedError(f"kernel: domain {ny}x{nx} below 8x3")
    if not all(t.device == g.device == geo.device == table.device
               for t in flow):
        raise ValueError(f"state on {flow[0].device}, tracers on {g.device}, "
                         f"geometry on {geo.device}, table on {table.device}")


def _launch(mode, a, b, g, params, tparams, geo, table, with_u=False,
            with_dom=False):
    """One coupled2d_step call on the current stream of the state's card:
    returns (a', b', g', u, dom), with b' None in the compressed layout, a',
    b' None with ``tparams.standalone``, u the pre-step velocity (2, ny, nx)
    if `with_u` (else None) and dom the pre-step domain mask (uint8) if
    `with_dom` (else None)."""
    ny, nx = params.ny, params.nx
    dev = g.device
    flow = not tparams.standalone
    fn, err = _kernel_fns("coupled2d_f64" if geo.dtype == torch.float64
                          else "coupled2d")
    dom = torch.empty((ny, nx), dtype=torch.uint8, device=dev) \
        if with_dom else None
    out_a = torch.empty_like(a) if flow else None
    out_b = torch.empty_like(b) if flow and b is not None else None
    out_g = torch.empty_like(g)
    u = torch.empty((2, ny, nx), dtype=geo.dtype, device=dev) \
        if with_u else None
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    stream_ptr = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = fn(mode, a.data_ptr(), ptr(b), ptr(out_a), ptr(out_b),
                  geo.data_ptr(), g.data_ptr(), out_g.data_ptr(), ptr(dom),
                  ptr(u), table.data_ptr(), ctypes.byref(params),
                  ctypes.byref(tparams), stream_ptr)
    if code != 0:
        msg = err(code).decode()
        raise RuntimeError(f"coupled2d_step launch failed: {msg} ({code})")
    return out_a, out_b, out_g, u, dom


def launch_coupled2d(s: torch.Tensor, g: torch.Tensor, params: CsfParams,
                     tparams: TracerParams, geo: torch.Tensor,
                     table: torch.Tensor):
    """One coupled kernel step of the compressed CUDA state (s, g): `s` as
    ``kernels/csf.py::launch_csf2d`` takes it, `g` (NT, NQ, ny, nx) and the
    per-tracer `table` in the geometry planes' type.  Not counted as a
    launch."""
    ny, nx = params.ny, params.nx
    bf16 = s.dtype == torch.bfloat16
    planes = 11 if bf16 else 10
    _check_tracers(g, params, tparams, geo, table, s)
    if s.dtype not in _STORAGE_CODE or tuple(s.shape) != (planes, ny, nx) \
            or geo.dtype != (torch.float32 if bf16 else s.dtype):
        raise ValueError(f"state {tuple(s.shape)} {s.dtype}; the kernel "
                         f"takes ({planes}, {ny}, {nx}) with {geo.dtype} "
                         "planes")
    if tparams.standalone:
        raise ValueError("standalone transport has no compressed form")
    s, g, table = s.contiguous(), g.contiguous(), table.contiguous()
    out_s, _, out_g, _, _ = _launch(_STORAGE_CODE[s.dtype], s, None, g,
                                    params, tparams, geo, table)
    return out_s, out_g


def launch_coupled2d_split(f_r: torch.Tensor, f_b: torch.Tensor,
                           g: torch.Tensor, params: CsfParams,
                           tparams: TracerParams, geo: torch.Tensor,
                           table: torch.Tensor, with_u: bool = False):
    """One coupled kernel step of the split CUDA state (f_r, f_b, g), the
    colour PDFs (9, ny, nx) and `g` in the geometry planes' type.  Returns
    (f_r', f_b', g', u, in_domain): with ``tparams.standalone`` the flow
    tensors come back as they are; u is the pre-step velocity (2, ny, nx)
    if `with_u`, else None; in_domain the pre-step mask rho_r < criteria
    (bool).  Not counted as a launch."""
    ny, nx = params.ny, params.nx
    _check_tracers(g, params, tparams, geo, table, f_r, f_b)
    for t in (f_r, f_b):
        if t.dtype != geo.dtype or tuple(t.shape) != (9, ny, nx):
            raise ValueError(f"split state {tuple(f_r.shape)} {f_r.dtype}, "
                             f"{tuple(f_b.shape)} {f_b.dtype}; the kernel "
                             f"takes two (9, {ny}, {nx}) {geo.dtype}")
    f_r, f_b = f_r.contiguous(), f_b.contiguous()
    g, table = g.contiguous(), table.contiguous()
    out_r, out_b, out_g, u, dom = _launch(_SPLIT_CODE[f_r.dtype], f_r, f_b,
                                          g, params, tparams, geo, table,
                                          with_u, with_dom=True)
    if tparams.standalone:
        out_r, out_b = f_r, f_b
    return out_r, out_b, out_g, u, dom.bool()


def coupled_step_compressed(s: torch.Tensor, g: torch.Tensor, model):
    """One coupled step (s, g) -> (s', g') for `model`, a TransportRK.
    CPU tensors: the plain version.  CUDA tensors: the kernels on the
    model's parameter blocks, geometry planes and tracer table, or an
    error; never the plain version."""
    if s.device != g.device:
        raise ValueError(f"state on device {s.device}, tracer PDFs on "
                         f"device {g.device}")
    if s.device.type == "cpu":
        return coupled_step_compressed_reference(s, g, model)
    if s.device.type != "cuda":
        raise ValueError(f"no coupled kernel for device {s.device}")
    flow = model.flow
    want = torch.bfloat16 if flow.storage == "bf16" else flow.dtype
    if s.dtype != want:
        raise ValueError(f"state {s.dtype}; the model takes {want}")
    out = launch_coupled2d(s, g, flow.kernel_params, model.tracer_params,
                           flow.geo_planes, model.tracer_table)
    coupled_step_compressed.launches += 1
    return out


coupled_step_compressed.launches = 0


def coupled_step_compressed_reference(s: torch.Tensor, g: torch.Tensor,
                                      model):
    """Plain PyTorch version of the kernels, on any device: the model's
    ``plain_step_c`` (the tracer sub-step on the pre-BC fields, then the
    flow's ``plain_step_c``)."""
    return model.plain_step_c((s, g))


def coupled_step_split(state, model, with_u: bool = False):
    """One split coupled step of `model`, a TransportRK, before its repairs:
    TransportState -> (f_r', f_b', g', u, in_domain), u and in_domain the
    pre-step velocity and transport-domain mask the repairs read
    (``TransportRK.repair``).  CPU tensors: the plain version (u always
    given).  CUDA tensors: the kernels, u only if `with_u`; or an error,
    never the plain version."""
    f_r, f_b, g, _ = state
    devices = {t.device for t in (f_r, f_b, g)}
    if len(devices) != 1:
        raise ValueError(f"split coupled state on devices {sorted(map(str, devices))}")
    dev = g.device
    if dev.type == "cpu":
        return coupled_step_split_reference(state, model)
    if dev.type != "cuda":
        raise ValueError(f"no coupled kernel for device {dev}")
    flow = model.flow
    if f_r.dtype != flow.dtype or f_b.dtype != flow.dtype:
        raise ValueError(f"split state {f_r.dtype}/{f_b.dtype}; the model "
                         f"takes {flow.dtype}")
    if not model.standalone:
        flow.check_split()
    out = launch_coupled2d_split(
        f_r, f_b, g, flow.kernel_params, model.tracer_params,
        flow.geo_planes, model.tracer_table, with_u)
    coupled_step_split.launches += 1
    return out


coupled_step_split.launches = 0


def coupled_step_split_reference(state, model):
    """Plain PyTorch version of the split coupled kernels, on any device:
    the model's ``plain_coupled`` (the tracer sub-step on the pre-BC
    fields, then the flow step)."""
    return model.plain_coupled(state)


# -- T steps a launch (K5c-T) ------------------------------------------------

class CoupledParams(ctypes.Structure):
    """Mirror of ``struct CoupledParams`` in csrc/coupled2d_block.cuh: the
    flow's and the tracers' parameter blocks of a T-step launch."""
    _fields_ = [("flow", CsfParams), ("tracer", TracerParams)]


_BLOCK_LIBS = {torch.float64: "coupled2d_block_f64",
               torch.float32: "coupled2d_block_f32",
               torch.bfloat16: "coupled2d_block_bf16"}
BLOCK_LIBRARIES = tuple(_BLOCK_LIBS.values())


def _march_args(params: CoupledParams, dtype, split: bool):
    """(shape, compute item size, split, inlet, outlet, wetting, repair,
    tracer slots): a K5c-T march plan's configuration."""
    f, t = params.flow, params.tracer
    return ((f.ny, f.nx), 8 if dtype == torch.float64 else 4, bool(split),
            int(f.inlet != 0), int(f.outlet), bool(f.has_wetting),
            bool(f.phi_repair), t.nt * t.nq)


def _march_plan(params: CoupledParams, dtype, split: bool, steps: int,
                device="cuda"):
    """K5c-T's plan for `params` and a flow state of `dtype`, built once a
    process a configuration: (plan, its table on `device`)."""
    args = _march_args(params, dtype, split)
    key = ("coupled2d", steps, march2d.ROWS_PER_WAVE) + args
    return march3d.device_plan(key, lambda: march2d.coupled2d_march_plan(
        args[0], steps, *args[1:]), device)


_march_limits: dict = {}


def coupled_block_max_steps(dtype, split: bool,
                            params: CoupledParams) -> int:
    """The largest T one K5c-T launch takes for `params` and a flow state of
    `dtype`: its march plan's (``march2d.max_steps``)."""
    args = _march_args(params, dtype, split)
    if args not in _march_limits:
        _march_limits[args] = march2d.max_steps(
            lambda t: march2d.coupled2d_stages(args[0][0], t, *args[1:]))
    return _march_limits[args]


def _launch_march(mode: int, tensors, params: CoupledParams, steps: int):
    """One K5c-T launch of `steps` steps on `tensors` (s, s2, out, out2,
    geo, g, g_out, table)."""
    lib = _BLOCK_LIBS[tensors[0].dtype]
    plan, table = _march_plan(params, tensors[0].dtype, mode >= 3, steps,
                              tensors[0].device)
    march3d.march_launch(lib, "coupled2d", (mode, steps), tensors, plan,
                         table, params)


def coupled_block_params(model) -> CoupledParams:
    """The T-step launch's parameter block of a TransportRK."""
    return CoupledParams(flow=model.flow.kernel_params,
                         tracer=model.tracer_params)


def coupled_block_tiling(dtype, split: bool, params: CoupledParams,
                         steps: int) -> dict:
    """How a K5c-T launch of `steps` steps covers the domain of `params` for
    a flow state of `dtype`: its march plan's fields (levels, lag, rows a
    wave, ring depths and bytes, waves, stages; "march": "rows") and its
    cooperative grid."""
    mode = (_SPLIT_CODE if split else _STORAGE_CODE)[dtype]
    plan, _ = _march_plan(params, dtype, split, steps)
    return plan.fields() | {"march": "rows", "grid": march3d.march_grid(
        _BLOCK_LIBS[dtype], "coupled2d", 2, 8, CoupledParams,
        10 * mode + params.tracer.nq)}


def launch_coupled2d_block(s: torch.Tensor, g: torch.Tensor,
                           params: CoupledParams, geo: torch.Tensor,
                           table: torch.Tensor, steps: int):
    """`steps` coupled kernel steps (one launch of the march) of the
    compressed CUDA state (s, g), as ``launch_coupled2d`` takes it.  Not
    counted as a launch."""
    ny, nx = params.flow.ny, params.flow.nx
    bf16 = s.dtype == torch.bfloat16
    planes = 11 if bf16 else 10
    _check_tracers(g, params.flow, params.tracer, geo, table, s)
    if s.dtype not in _STORAGE_CODE or tuple(s.shape) != (planes, ny, nx) \
            or geo.dtype != (torch.float32 if bf16 else s.dtype):
        raise ValueError(f"state {tuple(s.shape)} {s.dtype}; the kernel "
                         f"takes ({planes}, {ny}, {nx}) with {geo.dtype} "
                         "planes")
    if params.tracer.standalone:
        raise ValueError("standalone transport has no T-step form")
    s, g, table = s.contiguous(), g.contiguous(), table.contiguous()
    out_s, out_g = torch.empty_like(s), torch.empty_like(g)
    _launch_march(_STORAGE_CODE[s.dtype],
                  (s, None, out_s, None, geo, g, out_g, table), params, steps)
    return out_s, out_g


def launch_coupled2d_block_split(f_r: torch.Tensor, f_b: torch.Tensor,
                                 g: torch.Tensor, params: CoupledParams,
                                 geo: torch.Tensor, table: torch.Tensor,
                                 steps: int):
    """`steps` coupled kernel steps (one launch) of the split CUDA state
    (f_r, f_b, g), as ``launch_coupled2d_split`` takes it: (f_r', f_b', g').
    Not counted as a launch."""
    ny, nx = params.flow.ny, params.flow.nx
    _check_tracers(g, params.flow, params.tracer, geo, table, f_r, f_b)
    for t in (f_r, f_b):
        if t.dtype != geo.dtype or tuple(t.shape) != (9, ny, nx):
            raise ValueError(f"split state {tuple(f_r.shape)} {f_r.dtype}, "
                             f"{tuple(f_b.shape)} {f_b.dtype}; the kernel "
                             f"takes two (9, {ny}, {nx}) {geo.dtype}")
    if params.tracer.standalone:
        raise ValueError("standalone transport has no T-step form")
    f_r, f_b = f_r.contiguous(), f_b.contiguous()
    g, table = g.contiguous(), table.contiguous()
    out_r, out_b, out_g = (torch.empty_like(t) for t in (f_r, f_b, g))
    _launch_march(_SPLIT_CODE[f_r.dtype],
                  (f_r, f_b, out_r, out_b, geo, g, out_g, table), params,
                  steps)
    return out_r, out_b, out_g


def coupled_block_compressed(state, model, steps: int):
    """`steps` coupled steps of the compressed state (s, g) for `model`, a
    TransportRK: (s', g').  CPU tensors: the plain version.  CUDA tensors:
    K5c-T (an f32 / f64 flow state, or the 11-plane bf16 one in float32
    arithmetic), one launch of the march when T fits one
    (``coupled_block_max_steps``), else ``build.split_steps``'s launches,
    each counted; or an error; never the plain version.  A bf16 flow state
    is decoded and encoded once a launch, so a chunked bf16 call equals the
    same chunks of plain calls."""
    s, g = state
    if s.device != g.device:
        raise ValueError(f"state on device {s.device}, tracer PDFs on "
                         f"device {g.device}")
    if s.device.type == "cpu":
        return coupled_block_compressed_reference(state, model, steps)
    build.check_steps(steps)
    if s.device.type != "cuda":
        raise ValueError(f"no coupled kernel for device {s.device}")
    model._check_compressed()
    dt = model.flow.dtype
    if s.dtype not in (dt, torch.bfloat16) or (
            s.dtype == torch.bfloat16 and dt != torch.float32):
        raise ValueError(f"state {s.dtype}; the model takes {dt} or, in "
                         "float32 arithmetic, bfloat16")
    params = coupled_block_params(model)
    for t in build.split_steps(steps, coupled_block_max_steps(s.dtype, False,
                                                              params)):
        s, g = launch_coupled2d_block(s, g, params, model.flow.geo_planes,
                                      model.tracer_table, t)
        coupled_block_compressed.launches += 1
    return s, g


coupled_block_compressed.launches = 0


def coupled_block_compressed_reference(state, model, steps: int):
    """Plain PyTorch version of K5c-T, on any device: `steps` plain coupled
    steps (``TransportRK.plain_step_c``'s tracer sub-step on the pre-BC
    fields, then the flow's compressed step); a bf16 flow state is decoded
    once, stepped in float32 and encoded once, as the kernel does."""
    build.check_steps(steps)
    model._check_compressed()
    s, g = state
    flow = model.flow
    bf16 = s.dtype == torch.bfloat16
    x = flow.unpack_bf16(s) if bf16 else s
    for _ in range(steps):
        x, g = model.plain_step_c((x, g))
    return (flow.pack_compressed_bf16(x) if bf16 else x), g


def coupled_block_split(state, model, steps: int):
    """`steps` split coupled steps of the TransportState `state` for
    `model`: a TransportState (mass0 carried).  CPU tensors: the plain
    version.  CUDA tensors: K5c-T (the split instance of the march), one
    launch when T fits one, else ``build.split_steps``'s launches, each
    counted; or an error; never the plain version.  The repairs (conserve_mass,
    redistribute) have no T-step form (``make_block_step`` builds none)."""
    f_r, f_b, g, mass0 = state
    devices = {t.device for t in (f_r, f_b, g)}
    if len(devices) != 1:
        raise ValueError(f"split coupled state on devices "
                         f"{sorted(map(str, devices))}")
    if g.device.type == "cpu":
        return coupled_block_split_reference(state, model, steps)
    build.check_steps(steps)
    if g.device.type != "cuda":
        raise ValueError(f"no coupled kernel for device {g.device}")
    tp = model.tp
    if tp.conserve_mass or tp.interface_mode == "redistribute" or \
            model.standalone:
        raise ValueError("conserve_mass, interface_mode='redistribute' and "
                         "standalone transport have no T-step form")
    flow = model.flow
    if f_r.dtype != flow.dtype or f_b.dtype != flow.dtype:
        raise ValueError(f"split state {f_r.dtype}/{f_b.dtype}; the model "
                         f"takes {flow.dtype}")
    flow.check_split()
    params = coupled_block_params(model)
    for t in build.split_steps(steps, coupled_block_max_steps(f_r.dtype, True,
                                                              params)):
        f_r, f_b, g = launch_coupled2d_block_split(
            f_r, f_b, g, params, flow.geo_planes, model.tracer_table, t)
        coupled_block_split.launches += 1
    return type(state)(f_r, f_b, g, mass0)


coupled_block_split.launches = 0


def coupled_block_split_reference(state, model, steps: int):
    """Plain PyTorch version of the split K5c-T, on any device: `steps`
    plain split coupled steps (``TransportRK.plain_step``)."""
    build.check_steps(steps)
    for _ in range(steps):
        state = model.plain_step(state)
    return state


# -- the local form (K12a with transport) -------------------------------------

_LOCAL_LIBS = {torch.float64: "coupled2d_local_f64",
               torch.float32: "coupled2d_local_f32"}
LOCAL_LIBRARIES = tuple(_LOCAL_LIBS.values())


def _local_fns(lib: str):
    """(step, scratch_bytes, shape, error_string) of a coupled local library:
    ints (T, the LocalGrid), pointers (s, out, geo, g, g_out, table,
    scratch)."""
    return build.block_fns(lib, "coupled2d_local", 8, 7, CoupledParams)


def coupled_local_frame(model, steps: int, x_axis: bool):
    """The frame a coupled local launch of `steps` steps reads for `model`,
    a TransportRK: K3's 4 rings a step, and the band reaches of flow and
    tracer rows added up (the flow's inlet ghost 1 row and the tracer's
    anti-bounce-back or zero inlet 2 rows below; the flow's outlet 3 rows
    and the tracer's free-flow outlet 3 rows above), as
    ``csrc/coupled2d_block.cuh::coupled_block_shape``.  The TPU kernel's
    fifth ring for the bounce-back interface is not needed here."""
    from ..parallel.mesh import frame_of
    p, r = model.flow.kernel_params, model.tracer_params
    mlo = (1 if p.inlet else 0) + (2 if r.inlet in (2, 3) else 0)
    mhi = (3 if p.outlet else 0) + (3 if r.outlet else 0)
    return frame_of(4, steps, mlo, mhi, p.ny, x_axis)


def launch_coupled2d_local(ins, outs, params: CoupledParams,
                           geo: torch.Tensor, table: torch.Tensor, grid,
                           steps: int):
    """`steps` coupled kernel steps (one launch) of the shard `grid`
    (``parallel.mesh.LocalGrid``): `ins` its padded compressed flow buffer
    (10, py, px) and tracer PDFs (NT, NQ, py, px), f32 or f64, frames
    filled, into the centres of `outs`; `geo` its padded geometry planes,
    `table` the tracer table.  Not counted as a launch."""
    from .csf import _check_local
    (s, g), (out_s, out_g) = ins, outs
    if s.dtype not in _LOCAL_LIBS:
        raise ValueError(f"state {s.dtype}; the coupled local kernel takes "
                         "float32 or float64")
    nq = (params.tracer.nt, params.tracer.nq)
    _check_local(grid, 10, (s, 10, s.dtype), (out_s, 10, s.dtype),
                 (geo, 5, s.dtype), (g, nq, s.dtype), (out_g, nq, s.dtype))
    if table.dtype != s.dtype or table.device != s.device:
        raise ValueError(f"tracer table {table.dtype} on {table.device}")
    lib = _LOCAL_LIBS[s.dtype]
    build.launch_block(lib, _local_fns(lib), grid.ints(steps),
                       (s, out_s, geo, g, out_g, table.contiguous()), params)
    return outs


def coupled_local_step(ins, outs, geo: torch.Tensor, model, grid,
                       steps: int):
    """`steps` coupled steps of one shard for `model`, a TransportRK of the
    global domain: `ins` = (s, g) the shard's padded flow and tracer
    buffers (frames filled), the results written into the centres of
    `outs`, which are returned; `geo` the shard's padded geometry planes.
    The in-kernel part only, as the JAX sharded builder: ``conserve_mass``
    and the redistribute exchange are global epilogues (a redistribute
    interface confines as bounce-back does).  CPU tensors: the plain
    version.  CUDA tensors: one launch of the coupled local kernel, or an
    error; never the plain version."""
    s, g = ins
    if s.device.type == "cpu":
        cs, cg = coupled_local_step_reference(ins, model, grid, steps)
        grid.centre(outs[0]).copy_(cs)
        grid.centre(outs[1]).copy_(cg)
        return outs
    build.check_steps(steps)
    if s.device.type != "cuda":
        raise ValueError(f"no coupled kernel for device {s.device}")
    if s.dtype != model.dtype or g.dtype != model.dtype:
        raise ValueError(f"state {s.dtype} / {g.dtype}; the model takes "
                         f"{model.dtype}")
    if model.standalone:
        raise ValueError("standalone transport has no local form")
    launch_coupled2d_local(ins, outs, coupled_block_params(model), geo,
                           model.tracer_table, grid, steps)
    coupled_local_step.launches += 1
    return outs


coupled_local_step.launches = 0


def coupled_local_step_reference(ins, model, grid, steps: int):
    """Plain PyTorch version of the coupled local kernel, on any device: the
    shard's padded buffers embedded at their global rows and columns (the
    flow in the domain at rest, the tracers at 0; ``parallel.mesh.
    embed_local``), `steps` plain coupled steps of the whole domain (the
    tracer sub-step on the fields before the flow's boundary rows, then the
    flow's compressed step, as ``TransportRK.plain_step_c``, without the
    global epilogues), and the centres taken back: (s, g) of the shard."""
    from ..parallel.mesh import embed_local
    from .csf import rest_state
    build.check_steps(steps)
    s, g = ins
    flow = model.flow
    x = embed_local(s, grid, rest_state(flow))
    gg = embed_local(g, grid, torch.zeros(
        (*g.shape[:-2], *model.geo.shape), dtype=g.dtype, device=g.device))
    for _ in range(steps):
        rho_r, _, _, gx, gy, u = flow.fields_c(x)
        gg = model._transport_substep(gg, u, gx, gy, rho_r)
        x = flow.plain_step_c(x)
    rows = slice(grid.row0, grid.row0 + grid.ny)
    cols = slice(grid.col0, grid.col0 + grid.nx)
    return x[..., rows, cols], gg[..., rows, cols]
