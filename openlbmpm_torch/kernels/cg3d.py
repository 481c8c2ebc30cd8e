"""The D3Q19 CSF colour-gradient step (K9): CUDA kernel wrappers, plain
PyTorch versions and launch counts.

Counterpart of ``openlbmpm_tpu/pallas/cg3d.py::build_cg3d_fused_step`` at
one step per call: ``state_mode="compressed"`` with ``storage="f32"`` (K9c,
float32 or float64 state) and ``storage="bf16"`` (K9h), and
``state_mode="split"`` (K9s).  The device code is ``csrc/cg3d.cuh``, built
as one library per storage type (``cg3d_f64``, ``cg3d_f32``,
``cg3d_bf16``).

States:
  * compressed f32 / f64: (20, nz, ny, nx) -- planes 0-18 the total PDF,
    plane 19 rho_r;
  * compressed bf16: (21, nz, ny, nx) bfloat16 -- the deviations
    f_i - w_i*fl, then rho_r as a hi/lo pair;
  * split f32 / f64: the pair (f_r, f_b) of (19, nz, ny, nx) colour PDFs.

The geometry planes (``geo_stack3``) are float32 under bf16 storage: the
JAX kernel's bf16 instance keeps them, and with them the wetting normals,
in bf16 (a VMEM decision there), so the bf16 kernel here differs from its
plain version only by the state's rounding.

The coupled step (K9t, ``transport=`` with ``state_mode="compressed"``)
takes ``(s, g)``: ``s`` a compressed state as above and ``g``
(NT, 7, nz, ny, nx) D3Q7 tracer PDFs in the arithmetic type (float64 with
an f64 state, float32 with an f32 or bf16 one).

``cg3d_step_compressed(s, model)``, ``cg3d_step_split((f_r, f_b), model)``
and ``coupled3d_step_compressed(s, g, model)`` take the plain version only
for tensors on the CPU; for CUDA tensors they launch the kernel or raise.

The T-step forms (K9-T: ``steps_per_call`` = T > 1 of the same TPU kernel,
the boundary slabs applied inside the window before every sub-step) are
``cg3d_block_compressed(s, model, steps)`` (K9-Tc on f32 / f64, K9-Th on
the bf16 state, decoded once and encoded once) and
``cg3d_block_split((f_r, f_b), model, steps)`` (K9-Ts): one launch of
``csrc/cg3d_block_{f64,f32,bf16}.cu`` (``csrc/cg3d_block.cuh``) advances T
steps; T is at most ``MAX_BLOCK_STEPS``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..geometry import Geometry, wetting_masks_nd
from ..lattice import D3Q19
from . import build

__all__ = ["LIBRARIES", "Cg3dParams", "Tracer3dParams", "geo_stack3",
           "kernel_params", "tracer3d_params", "tracer3d_table",
           "launch_cg3d", "launch_cg3d_split", "launch_cg3d_coupled",
           "cg3d_step_compressed", "cg3d_step_compressed_reference",
           "cg3d_step_split", "cg3d_step_split_reference",
           "coupled3d_step_compressed", "coupled3d_step_compressed_reference",
           "BLOCK_LIBRARIES", "MAX_BLOCK_STEPS",
           "cg3d_block_tiling",
           "launch_cg3d_block", "cg3d_block_compressed",
           "cg3d_block_compressed_reference", "cg3d_block_split",
           "cg3d_block_split_reference"]

_LIBS = {torch.float64: "cg3d_f64", torch.float32: "cg3d_f32",
         torch.bfloat16: "cg3d_bf16"}
LIBRARIES = tuple(_LIBS.values())


def geo_stack3(geometry: Geometry, device="cpu") -> torch.Tensor:
    """Static geometry planes the kernel reads, (4, nz, ny, nx) float64 on
    `device`: [code, nsx, nsy, nsz] as ``pallas/cg3d.py::geo_stack3`` packs
    them (bit for bit: the same products and sums in the same order).
    code is 1 on plain fluid, 2 on wetting fluid and -den_inv on solid,
    where den_inv is the reciprocal of the solid-phi extrapolation
    denominator sum_i w_i is_fluid(x + e_i) (0 without fluid neighbours,
    else >= 1.5, so the thresholds 0.5 and 1.5 decode exactly).  The wetting
    mask (``geometry.wetting_masks_nd``), the solid normals
    (``solid_normals_nd``) and the denominator come from one pass over the
    18 neighbour shifts, on the device."""
    lat = D3Q19
    solid = torch.as_tensor(np.asarray(geometry.is_solid, bool),
                            device=device)
    fluid = ~solid
    fl = fluid.double()
    acc = [torch.zeros_like(fl) for _ in range(3)]
    den = torch.zeros_like(fl)
    any_solid = torch.zeros_like(solid)
    for i in range(1, lat.q):
        e = [int(c) for c in lat.e[i]]
        shifts, w = (-e[2], -e[1], -e[0]), float(lat.w[i])
        s = torch.roll(solid, shifts, (0, 1, 2))
        any_solid |= s
        for d in range(3):
            if e[d]:
                acc[d] += w * e[d] * s.double()
        den += w * torch.roll(fl, shifts, (0, 1, 2))
    norm = torch.sqrt(sum(c * c for c in acc))
    safe = norm > 0
    ns = [torch.where(safe, c / torch.where(safe, norm, 1.0), 0.0) * fluid
          for c in acc]
    den_inv = torch.where(den > 0, 1.0 / torch.where(den > 0, den, 1.0), 0.0)
    code = torch.where(fluid, 1.0 + (fluid & any_solid).double(), -den_inv)
    return torch.stack([code, *ns])


class Cg3dParams(ctypes.Structure):
    """Mirror of ``struct Cg3dParams`` in csrc/cg3d.cuh (same field order)."""
    _fields_ = [
        ("nz", ctypes.c_int), ("ny", ctypes.c_int), ("nx", ctypes.c_int),
        ("inlet", ctypes.c_int),         # 0 periodic, 1 velocity
        ("outlet", ctypes.c_int),   # 0 periodic, 1 convective, 2 dirichlet
        ("has_wetting", ctypes.c_int),
        ("tau_type", ctypes.c_int),
        ("pad", ctypes.c_int),
        ("tau_r", ctypes.c_double), ("tau_b", ctypes.c_double),
        ("sigma", ctypes.c_double), ("beta", ctypes.c_double),
        ("delta", ctypes.c_double),
        ("cos_t", ctypes.c_double), ("sin_t", ctypes.c_double),
        ("bfx", ctypes.c_double), ("bfy", ctypes.c_double),
        ("bfz", ctypes.c_double),
        ("inlet_vz", ctypes.c_double), ("outlet_rho", ctypes.c_double),
    ]


_INLETS = {"periodic": 0, "velocity": 1}
_OUTLETS = {"periodic": 0, "convective": 1, "dirichlet": 2}


def kernel_params(params, bcs, geometry: Geometry) -> Cg3dParams:
    """The kernel's parameter block for a ColorGradientParams3D,
    CG3DBoundaryConfig and geometry; raises NotImplementedError for a
    domain the kernel does not take."""
    p, b = params, bcs
    nz, ny, nx = geometry.shape
    if nz < 8 or ny < 2 or nx < 2:
        raise NotImplementedError(f"kernel: domain {nz}x{ny}x{nx} below "
                                  "8x2x2")
    _, wet_solid = wetting_masks_nd(geometry.is_solid, D3Q19)
    theta = math.radians(p.contact_angle_deg)
    bfx, bfy, bfz = (float(v) for v in p.body_force)
    return Cg3dParams(
        nz=nz, ny=ny, nx=nx, inlet=_INLETS[b.inlet],
        outlet=_OUTLETS[b.outlet], has_wetting=int(wet_solid.any()),
        tau_type=p.tau_type, pad=0,
        tau_r=p.tau_r, tau_b=p.tau_b, sigma=p.surface_tension, beta=p.beta,
        delta=p.delta, cos_t=-math.cos(theta), sin_t=math.sin(theta),
        bfx=bfx, bfy=bfy, bfz=bfz, inlet_vz=b.inlet_velocity,
        outlet_rho=b.outlet_density)


class Tracer3dParams(ctypes.Structure):
    """Mirror of ``struct Tracer3dParams`` in csrc/cg3d.cuh."""
    _fields_ = [
        ("nt", ctypes.c_int),
        ("interface", ctypes.c_int),     # 0 none, 1 bounceback
        ("criteria", ctypes.c_double),
    ]


def tracer3d_params(transport) -> Tracer3dParams:
    """The coupled kernel's tracer block for a TransportD3Q7."""
    return Tracer3dParams(nt=transport.num_tracers,
                          interface=int(transport.interface_mode ==
                                        "bounceback"),
                          criteria=transport.criteria)


def tracer3d_table(transport) -> np.ndarray:
    """(NT, 8) per-tracer rows the coupled kernel reads: tau, then
    J_0..J_6, from a TransportD3Q7."""
    return np.concatenate([np.asarray(transport.tau, np.float64)[:, None],
                           transport.j_coeffs], axis=1)


_fn_cache: dict[str, tuple] = {}


def _kernel_fn(lib_name: str):
    if lib_name not in _fn_cache:
        lib = build.load_library(lib_name)
        fn = lib.cg3d_step
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + \
            [ctypes.POINTER(Cg3dParams), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        coupled = lib.cg3d_coupled_step
        coupled.argtypes = [ctypes.c_void_p] * 11 + \
            [ctypes.POINTER(Cg3dParams), ctypes.POINTER(Tracer3dParams),
             ctypes.c_void_p]
        coupled.restype = ctypes.c_int
        err = lib.cg3d_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn_cache[lib_name] = (fn, err, coupled)
    return _fn_cache[lib_name]


def _launch(split: int, a, b, out_a, out_b, params: Cg3dParams,
            geo: torch.Tensor):
    """One cg3d_step call on the current stream of the state's card."""
    nz, ny, nx = params.nz, params.ny, params.nx
    dev = a.device
    fn, err, _ = _kernel_fn(_LIBS[a.dtype])
    phi = torch.empty((nz, ny, nx), dtype=geo.dtype, device=dev)
    nrm = torch.empty((7, nz, ny, nx), dtype=geo.dtype, device=dev)
    bc = None
    if params.inlet or params.outlet:
        planes = 2 * a.shape[0] if split else a.shape[0]
        bc = torch.empty((planes, 5, ny, nx), dtype=a.dtype, device=dev)
    with torch.cuda.device(dev):
        code = fn(split, a.data_ptr(), 0 if b is None else b.data_ptr(),
                  out_a.data_ptr(), 0 if out_b is None else out_b.data_ptr(),
                  geo.data_ptr(), phi.data_ptr(), nrm.data_ptr(),
                  0 if bc is None else bc.data_ptr(), ctypes.byref(params),
                  torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"cg3d_step launch failed: {err(code).decode()} "
                           f"({code})")


def _check_domain(params: Cg3dParams, geo: torch.Tensor, want, *tensors):
    shape = (4, params.nz, params.ny, params.nx)
    if geo.dtype != want or tuple(geo.shape) != shape:
        raise ValueError(f"state needs {want} geometry planes {shape}, got "
                         f"{geo.dtype} {tuple(geo.shape)}")
    for t in tensors:
        if t.device != geo.device or t.device.type != "cuda":
            raise ValueError(f"state on {t.device}, geometry on {geo.device}")


def _check_compressed(s: torch.Tensor, params: Cg3dParams,
                      geo: torch.Tensor, *tensors):
    shape = (params.nz, params.ny, params.nx)
    bf16 = s.dtype == torch.bfloat16
    planes = 21 if bf16 else 20
    if s.dtype not in _LIBS or tuple(s.shape) != (planes, *shape):
        raise ValueError(f"state {tuple(s.shape)} {s.dtype}; the kernel "
                         f"takes ({planes}, {', '.join(map(str, shape))})")
    _check_domain(params, geo, torch.float32 if bf16 else s.dtype, s,
                  *tensors)


def launch_cg3d(s: torch.Tensor, params: Cg3dParams,
                geo: torch.Tensor) -> torch.Tensor:
    """One kernel step of the compressed CUDA state `s`: (20, nz, ny, nx) in
    the type of the geometry planes `geo` (``geo_stack3``, float32 or
    float64), or (21, nz, ny, nx) bfloat16 with float32 planes.  Not
    counted as a launch."""
    _check_compressed(s, params, geo)
    s = s.contiguous()
    out = torch.empty_like(s)
    _launch(0, s, None, out, None, params, geo)
    return out


def launch_cg3d_split(f_r: torch.Tensor, f_b: torch.Tensor,
                      params: Cg3dParams, geo: torch.Tensor):
    """One kernel step of the split CUDA state (f_r, f_b), each
    (19, nz, ny, nx) in the type of the geometry planes (float32 or
    float64).  Returns (f_r', f_b').  Not counted as a launch."""
    shape = (19, params.nz, params.ny, params.nx)
    for t in (f_r, f_b):
        if t.dtype not in (torch.float32, torch.float64) or \
                tuple(t.shape) != shape or t.dtype != f_r.dtype:
            raise ValueError(f"split state {tuple(f_r.shape)} {f_r.dtype}, "
                             f"{tuple(f_b.shape)} {f_b.dtype}; the kernel "
                             f"takes two {shape} float32 or float64")
    _check_domain(params, geo, f_r.dtype, f_r, f_b)
    f_r, f_b = f_r.contiguous(), f_b.contiguous()
    out_r, out_b = torch.empty_like(f_r), torch.empty_like(f_b)
    _launch(1, f_r, f_b, out_r, out_b, params, geo)
    return out_r, out_b


def launch_cg3d_coupled(s: torch.Tensor, g: torch.Tensor,
                        params: Cg3dParams, tparams: Tracer3dParams,
                        geo: torch.Tensor, table: torch.Tensor):
    """One coupled kernel step (K9t) of the compressed CUDA state (s, g): `s`
    as ``launch_cg3d`` takes it, `g` (NT, 7, nz, ny, nx) and the per-tracer
    `table` (``tracer3d_table``) in the geometry planes' type.  Returns
    (s', g').  Not counted as a launch."""
    nz, ny, nx = params.nz, params.ny, params.nx
    nt = tparams.nt
    _check_compressed(s, params, geo, g, table)
    if g.dtype != geo.dtype or tuple(g.shape) != (nt, 7, nz, ny, nx):
        raise ValueError(f"tracer PDFs {tuple(g.shape)} {g.dtype}; the "
                         f"kernel takes ({nt}, 7, {nz}, {ny}, {nx}) "
                         f"{geo.dtype}")
    if table.dtype != geo.dtype or tuple(table.shape) != (nt, 8):
        raise ValueError(f"tracer table {tuple(table.shape)} {table.dtype}")
    s, g, table = s.contiguous(), g.contiguous(), table.contiguous()
    dev = s.device
    _, err, fn = _kernel_fn(_LIBS[s.dtype])
    phi = torch.empty((nz, ny, nx), dtype=geo.dtype, device=dev)
    nrm = torch.empty((7, nz, ny, nx), dtype=geo.dtype, device=dev)
    bc = torch.empty((s.shape[0], 5, ny, nx), dtype=s.dtype, device=dev) \
        if params.inlet or params.outlet else None
    g_post = torch.empty_like(g)
    flags = torch.empty((nz, ny, nx), dtype=torch.uint8, device=dev)
    out_s, out_g = torch.empty_like(s), torch.empty_like(g)
    with torch.cuda.device(dev):
        code = fn(s.data_ptr(), out_s.data_ptr(), geo.data_ptr(),
                  phi.data_ptr(), nrm.data_ptr(),
                  0 if bc is None else bc.data_ptr(), g.data_ptr(),
                  g_post.data_ptr(), out_g.data_ptr(), flags.data_ptr(),
                  table.data_ptr(), ctypes.byref(params),
                  ctypes.byref(tparams),
                  torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"cg3d_coupled_step launch failed: "
                           f"{err(code).decode()} ({code})")
    return out_s, out_g


def _check_model_device(t: torch.Tensor, model):
    if t.device.type != "cuda":
        raise ValueError(f"no cg3d kernel for device {t.device}")
    if model.path != "kernel":
        raise ValueError(f"the model runs the {model.path!r} step on "
                         f"{model.device}, the state is on {t.device}")


def cg3d_step_compressed(s: torch.Tensor, model) -> torch.Tensor:
    """One compressed D3Q19 CSF step (boundary slabs included) for `model`,
    a ColorGradientRK3D.  CPU tensor: the plain version.  CUDA tensor: the
    kernel on the model's parameter block and geometry planes, or an
    error; never the plain version."""
    if s.device.type == "cpu":
        return cg3d_step_compressed_reference(s, model)
    _check_model_device(s, model)
    want = torch.bfloat16 if model.storage == "bf16" else model.dtype
    if s.dtype != want:
        raise ValueError(f"state {s.dtype}; the model takes {want}")
    out = launch_cg3d(s, model.kernel_params, model.geo_planes)
    cg3d_step_compressed.launches += 1
    return out


cg3d_step_compressed.launches = 0


def cg3d_step_compressed_reference(s: torch.Tensor, model) -> torch.Tensor:
    """Plain PyTorch version of the compressed kernel, on any device: the
    model's ``plain_step_c``."""
    return model.plain_step_c(s)


def cg3d_step_split(state, model):
    """One split D3Q19 CSF step (f_r, f_b) -> (f_r', f_b') (boundary slabs
    included) for `model`, a ColorGradientRK3D.  CPU tensors: the plain
    version.  CUDA tensors: the kernel, or an error; never the plain
    version."""
    f_r, f_b = state
    if f_r.device != f_b.device:
        raise ValueError(f"f_r on device {f_r.device}, f_b on {f_b.device}")
    if f_r.device.type == "cpu":
        return cg3d_step_split_reference(state, model)
    _check_model_device(f_r, model)
    if f_r.dtype != model.dtype or f_b.dtype != model.dtype:
        raise ValueError(f"split state {f_r.dtype}/{f_b.dtype}; the model "
                         f"takes {model.dtype}")
    out = launch_cg3d_split(f_r, f_b, model.kernel_params, model.geo_planes)
    cg3d_step_split.launches += 1
    return out


cg3d_step_split.launches = 0


def cg3d_step_split_reference(state, model):
    """Plain PyTorch version of the split kernel, on any device: the
    model's ``plain_step``."""
    return model.plain_step(state)


def coupled3d_step_compressed(s: torch.Tensor, g: torch.Tensor, model):
    """One coupled D3Q19 CSF + D3Q7 tracer step (s, g) -> (s', g') for
    `model`, a TransportRK3D.  CPU tensors: the plain version.  CUDA
    tensors: the kernel on the model's parameter blocks, geometry planes
    and tracer table, or an error; never the plain version."""
    if s.device != g.device:
        raise ValueError(f"state on device {s.device}, tracer PDFs on "
                         f"device {g.device}")
    if s.device.type == "cpu":
        return coupled3d_step_compressed_reference(s, g, model)
    flow = model.flow
    _check_model_device(s, flow)
    want = torch.bfloat16 if flow.storage == "bf16" else flow.dtype
    if s.dtype != want or g.dtype != flow.dtype:
        raise ValueError(f"state {s.dtype}, tracers {g.dtype}; the model "
                         f"takes {want}, {flow.dtype}")
    out = launch_cg3d_coupled(s, g, flow.kernel_params, model.tracer_params,
                              flow.geo_planes, model.tracer_table)
    coupled3d_step_compressed.launches += 1
    return out


coupled3d_step_compressed.launches = 0


def coupled3d_step_compressed_reference(s: torch.Tensor, g: torch.Tensor,
                                        model):
    """Plain PyTorch version of the coupled kernel, on any device: the
    model's ``plain_step_c``."""
    return model.plain_step_c((s, g))


# -- T steps a launch (K9-T) -------------------------------------------------

_BLOCK_LIBS = {torch.float64: "cg3d_block_f64",
               torch.float32: "cg3d_block_f32",
               torch.bfloat16: "cg3d_block_bf16"}
BLOCK_LIBRARIES = tuple(_BLOCK_LIBS.values())
MAX_BLOCK_STEPS = 8    # csrc/block3d.cuh::kMaxSteps3
_BLOCK_TILING_KEYS = ("tx", "ty", "tz", "hx", "hzlo", "hzhi", "grid",
                      "window_bytes")


def _block_fns(lib: str):
    """(step, scratch_bytes, shape, error_string) of a K9-T library: ints
    (split, T), pointers (s, s2, out, out2, geo, scratch)."""
    return build.block_fns(lib, "cg3d", 2, 6, Cg3dParams)


def cg3d_block_tiling(dtype, split: bool, params: Cg3dParams,
                      steps: int) -> dict:
    """How a K9-T launch of `steps` steps tiles the domain of `params` for a
    state of `dtype` (the split layout if `split`): the brick (tx, ty, tz),
    the halo on each x and y side (hx) and below and above in z (hzlo,
    hzhi), the blocks launched and one window's bytes (the windows live in
    global scratch)."""
    lib = _BLOCK_LIBS[dtype]
    return build.block_tiling(lib, _block_fns(lib),
                              (int(split), steps), params,
                              _BLOCK_TILING_KEYS)


def launch_cg3d_block(state, params: Cg3dParams, geo: torch.Tensor,
                      steps: int):
    """`steps` kernel steps (one launch) of a CUDA state: the compressed
    tensor (as ``launch_cg3d`` takes it) or the split pair (f_r, f_b) (as
    ``launch_cg3d_split``).  Returns the state in
    the same form.  Not counted as a launch."""
    build.check_steps(steps)
    if steps > MAX_BLOCK_STEPS:
        raise ValueError(f"steps {steps}: the kernel takes at most "
                         f"{MAX_BLOCK_STEPS} a launch")
    split = not torch.is_tensor(state)
    if split:
        f_r, f_b = state
        shape = (19, params.nz, params.ny, params.nx)
        for t in (f_r, f_b):
            if t.dtype not in (torch.float32, torch.float64) or \
                    tuple(t.shape) != shape or t.dtype != f_r.dtype:
                raise ValueError(f"split state {tuple(f_r.shape)} "
                                 f"{f_r.dtype}, {tuple(f_b.shape)} "
                                 f"{f_b.dtype}; the kernel takes two {shape} "
                                 "float32 or float64")
        _check_domain(params, geo, f_r.dtype, f_r, f_b)
        a, b = f_r.contiguous(), f_b.contiguous()
        out = (torch.empty_like(a), torch.empty_like(b))
        tensors = (a, b, *out, geo)
    else:
        _check_compressed(state, params, geo)
        a = state.contiguous()
        out = torch.empty_like(a)
        tensors = (a, None, out, None, geo)
    lib = _BLOCK_LIBS[a.dtype]
    build.launch_block(lib, _block_fns(lib), (int(split), steps),
                       tensors, params)
    return out


def _block_model(t: torch.Tensor, model, steps):
    build.check_steps(steps)
    _check_model_device(t, model)


def cg3d_block_compressed(s: torch.Tensor, model, steps: int) -> torch.Tensor:
    """`steps` compressed D3Q19 CSF steps (boundary slabs before each) for
    `model`, a ColorGradientRK3D: the (20, nz, ny, nx) state in
    ``model.dtype`` or the 21-plane bfloat16 state.  CPU tensor: the plain
    version.  CUDA tensor: one launch of K9-Tc / K9-Th, or an error; never
    the plain version."""
    if s.device.type == "cpu":
        return cg3d_block_compressed_reference(s, model, steps)
    _block_model(s, model, steps)
    if s.dtype not in (model.dtype, torch.bfloat16) or (
            s.dtype == torch.bfloat16 and model.dtype != torch.float32):
        raise ValueError(f"state {s.dtype}; the model takes {model.dtype} or, "
                         "in float32 arithmetic, bfloat16")
    out = launch_cg3d_block(s, model.kernel_params, model.geo_planes, steps)
    cg3d_block_compressed.launches += 1
    return out


cg3d_block_compressed.launches = 0


def cg3d_block_compressed_reference(s: torch.Tensor, model,
                                    steps: int) -> torch.Tensor:
    """Plain PyTorch version of K9-Tc / K9-Th, on any device: `steps` plain
    compressed steps (``plain_step_c``); a bf16 state is decoded once,
    stepped in float32 (its boundary slabs on the float32 values, as the
    kernel applies them in its window) and encoded once."""
    build.check_steps(steps)
    bf16 = s.dtype == torch.bfloat16
    x = model.unpack_bf16(s) if bf16 else s
    for _ in range(steps):
        x = model.plain_step_c(x)
    return model.pack_compressed_bf16(x) if bf16 else x


def cg3d_block_split(state, model, steps: int):
    """`steps` split D3Q19 CSF steps (f_r, f_b) -> (f_r', f_b') (boundary
    slabs before each) for `model`, a ColorGradientRK3D.  CPU tensors: the
    plain version.  CUDA tensors: one launch of K9-Ts, or an error; never
    the plain version."""
    f_r, f_b = state
    if f_r.device != f_b.device:
        raise ValueError(f"f_r on device {f_r.device}, f_b on {f_b.device}")
    if f_r.device.type == "cpu":
        return cg3d_block_split_reference(state, model, steps)
    _block_model(f_r, model, steps)
    if f_r.dtype != model.dtype or f_b.dtype != model.dtype:
        raise ValueError(f"split state {f_r.dtype}/{f_b.dtype}; the model "
                         f"takes {model.dtype}")
    out = launch_cg3d_block((f_r, f_b), model.kernel_params,
                            model.geo_planes, steps)
    cg3d_block_split.launches += 1
    return out


cg3d_block_split.launches = 0


def cg3d_block_split_reference(state, model, steps: int):
    """Plain PyTorch version of K9-Ts, on any device: `steps` plain split
    steps (``plain_step``)."""
    build.check_steps(steps)
    state = tuple(state)
    for _ in range(steps):
        state = model.plain_step(state)
    return state
