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
A step is two launches, three with an inlet or outlet (``bc_kernel``,
``fields_kernel``: g and kappa into four planes, ``collide_stream``), the
coupled step too (its ``collide_stream`` collides and streams the tracers
with the flow; one more launch for each further group of tracers above
what a launch's shared memory holds: 16 in float32, 2 in float64);
``cg3d_fields(state, model)`` runs the first two alone, held to
``cg3d_fields_reference``.

The T-step forms (K9-T: ``steps_per_call`` = T > 1 of the same TPU kernel,
the boundary slabs applied inside the window before every sub-step) are
``cg3d_block_compressed(s, model, steps)`` (K9-Tc on f32 / f64, K9-Th on
the bf16 state, decoded once and encoded once) and
``cg3d_block_split((f_r, f_b), model, steps)`` (K9-Ts): one launch of
``csrc/cg3d_block_{f64,f32,bf16}.cu`` (``csrc/cg3d_block.cuh``: the
pipelined z-march of ``csrc/march3d.cuh`` on the plan of
``kernels/march3d.py::cg3d_march_plan``) advances T steps; a launch takes
at most ``MAX_BLOCK_STEPS`` (the mirror of ``csrc/cg3d_block.cuh::
kMaxSteps3``, which the libraries' ``cg3d_block_max_steps`` returns), and a
call of more steps runs as ``build.split_steps``'s launches of near-equal
step counts.

The local form (K12d: one shard of a z- or (z, y)-decomposed domain, the
counterpart of ``pallas/cg3d.py::build_cg3d_sharded_step``) is
``csrc/cg3d_local_{f64,f32}.cu`` (``csrc/cg3d_local.cuh``): the slab kernel
``cg3d_local_slabs`` before the exchange, then ``cg3d_local_step`` or
``coupled3d_local_step``; ``build_cg3d_sharded_step`` drives them.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..geometry import Geometry, wetting_masks_nd
from ..lattice import D3Q19
from ..parallel.mesh import embed_local, take_centre
from . import build
from . import march3d

__all__ = ["LIBRARIES", "Cg3dParams", "Tracer3dParams", "geo_stack3",
           "kernel_params", "tracer3d_params", "tracer3d_table",
           "FIELD_PLANES", "KERNELS", "kernel_launches", "launch_cg3d",
           "launch_cg3d_fields",
           "launch_cg3d_split", "launch_cg3d_coupled", "cg3d_fields",
           "cg3d_fields_reference",
           "cg3d_step_compressed", "cg3d_step_compressed_reference",
           "cg3d_step_split", "cg3d_step_split_reference",
           "coupled3d_step_compressed", "coupled3d_step_compressed_reference",
           "BLOCK_LIBRARIES", "MAX_BLOCK_STEPS",
           "cg3d_block_max_steps", "cg3d_block_tiling",
           "launch_cg3d_block", "cg3d_block_compressed",
           "cg3d_block_compressed_reference", "cg3d_block_split",
           "cg3d_block_split_reference", "LOCAL_LIBRARIES", "LOCAL_REACH",
           "Local3", "cg3d_local_frame", "launch_cg3d_local_slabs",
           "launch_cg3d_local", "cg3d_local_slabs",
           "cg3d_local_slabs_reference", "cg3d_local_step",
           "cg3d_local_step_reference", "coupled3d_local_step",
           "coupled3d_local_step_reference", "TPU_HALO_Y",
           "build_cg3d_sharded_step"]

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


# fields_kernel's output planes: g (3), kappa
FIELD_PLANES = 4

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
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + \
            [ctypes.POINTER(Cg3dParams), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fields = lib.cg3d_fields
        fields.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + \
            [ctypes.POINTER(Cg3dParams), ctypes.c_void_p]
        fields.restype = ctypes.c_int
        coupled = lib.cg3d_coupled_step
        coupled.argtypes = [ctypes.c_void_p] * 8 + \
            [ctypes.POINTER(Cg3dParams), ctypes.POINTER(Tracer3dParams),
             ctypes.c_void_p]
        coupled.restype = ctypes.c_int
        err = lib.cg3d_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn_cache[lib_name] = (fn, err, coupled, fields)
    return _fn_cache[lib_name]


# the kernels of a step, in the order of cg3d_kernel_launches' counts
KERNELS = ("bc_kernel", "fields_kernel", "collide_stream_kernel")


def kernel_launches(lib_name: str) -> dict[str, int]:
    """Launches of each kernel of ``KERNELS`` by the K9 library `lib_name`
    (cg3d_f64, cg3d_f32 or cg3d_bf16) since it was loaded, as the library
    counts them where it launches them."""
    fn = build.load_library(lib_name).cg3d_kernel_launches
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = None
    out = (ctypes.c_longlong * len(KERNELS))()
    fn(out)
    return dict(zip(KERNELS, out))


def _launch(split: int, a, b, out_a, out_b, params: Cg3dParams,
            geo: torch.Tensor) -> torch.Tensor:
    """One cg3d_step call on the current stream of the state's card, or
    with `out_a` None one cg3d_fields call; returns the fields' scratch
    (g and kappa, ``FIELD_PLANES`` planes)."""
    nz, ny, nx = params.nz, params.ny, params.nx
    dev = a.device
    fn, err, _, fields = _kernel_fn(_LIBS[a.dtype])
    fld = torch.empty((FIELD_PLANES, nz, ny, nx), dtype=geo.dtype, device=dev)
    bc = None
    if params.inlet or params.outlet:
        planes = 2 * a.shape[0] if split else a.shape[0]
        bc = torch.empty((planes, 5, ny, nx), dtype=a.dtype, device=dev)
    bptr = 0 if b is None else b.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if out_a is None:
            code = fields(split, a.data_ptr(), bptr, geo.data_ptr(),
                          fld.data_ptr(), 0 if bc is None else bc.data_ptr(),
                          ctypes.byref(params), stream)
        else:
            code = fn(split, a.data_ptr(), bptr, out_a.data_ptr(),
                      0 if out_b is None else out_b.data_ptr(),
                      geo.data_ptr(), fld.data_ptr(),
                      0 if bc is None else bc.data_ptr(),
                      ctypes.byref(params), stream)
    if code != 0:
        what = "cg3d_fields" if out_a is None else "cg3d_step"
        raise RuntimeError(f"{what} launch failed: {err(code).decode()} "
                           f"({code})")
    return fld


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


def launch_cg3d_fields(state, params: Cg3dParams,
                       geo: torch.Tensor) -> torch.Tensor:
    """The fields of one kernel step alone (the boundary slabs, then
    fields_kernel) of a CUDA state, compressed (as ``launch_cg3d`` takes
    it) or the split pair: (4, nz, ny, nx) in the geometry planes' type,
    g (rotated on wetting fluid cells) and kappa (0 off fluid).  Not
    counted as a launch."""
    if torch.is_tensor(state):
        _check_compressed(state, params, geo)
        return _launch(0, state.contiguous(), None, None, None, params, geo)
    f_r, f_b = state
    _check_split(f_r, f_b, params, geo)
    return _launch(1, f_r.contiguous(), f_b.contiguous(), None, None, params,
                   geo)


def _check_split(f_r, f_b, params: Cg3dParams, geo: torch.Tensor):
    shape = (19, params.nz, params.ny, params.nx)
    for t in (f_r, f_b):
        if t.dtype not in (torch.float32, torch.float64) or \
                tuple(t.shape) != shape or t.dtype != f_r.dtype:
            raise ValueError(f"split state {tuple(f_r.shape)} {f_r.dtype}, "
                             f"{tuple(f_b.shape)} {f_b.dtype}; the kernel "
                             f"takes two {shape} float32 or float64")
    _check_domain(params, geo, f_r.dtype, f_r, f_b)


def launch_cg3d_split(f_r: torch.Tensor, f_b: torch.Tensor,
                      params: Cg3dParams, geo: torch.Tensor):
    """One kernel step of the split CUDA state (f_r, f_b), each
    (19, nz, ny, nx) in the type of the geometry planes (float32 or
    float64).  Returns (f_r', f_b').  Not counted as a launch."""
    _check_split(f_r, f_b, params, geo)
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
    _, err, fn, _ = _kernel_fn(_LIBS[s.dtype])
    fld = torch.empty((FIELD_PLANES, nz, ny, nx), dtype=geo.dtype, device=dev)
    bc = torch.empty((s.shape[0], 5, ny, nx), dtype=s.dtype, device=dev) \
        if params.inlet or params.outlet else None
    out_s, out_g = torch.empty_like(s), torch.empty_like(g)
    with torch.cuda.device(dev):
        code = fn(s.data_ptr(), out_s.data_ptr(), geo.data_ptr(),
                  fld.data_ptr(), 0 if bc is None else bc.data_ptr(),
                  g.data_ptr(), out_g.data_ptr(),
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


def cg3d_fields(state, model) -> torch.Tensor:
    """The fields a D3Q19 CSF step collides with, for `model`: g (the
    gradient of the extended phase field, rotated on wetting fluid cells)
    and kappa (0 off fluid) of the compressed state or the split pair after
    its boundary slabs, (4, nz, ny, nx).  CPU tensors: the plain version.
    CUDA tensors: fields_kernel (after bc_kernel), or an error."""
    t = state if torch.is_tensor(state) else state[0]
    if t.device.type == "cpu":
        return cg3d_fields_reference(state, model)
    _check_model_device(t, model)
    out = launch_cg3d_fields(state, model.kernel_params, model.geo_planes)
    cg3d_fields.launches += 1
    return out


cg3d_fields.launches = 0


def cg3d_fields_reference(state, model) -> torch.Tensor:
    """Plain PyTorch version of fields_kernel, on any device: the model's
    boundary slabs, then phi, its extension onto solid cells, the isotropic
    gradient with the Akai rotation on wetting fluid cells
    (``_fields_from_densities``) and kappa of ``ops/colorgrad.csf_force_nd``
    (0 off fluid); (4, nz, ny, nx) in ``model.dtype``."""
    from ..ops import colorgrad as cg
    from ..ops import macroscopic as mac
    if torch.is_tensor(state):
        s = model._post_slabs_c(state)
        rho_r = s[19]
        rho_b = mac.density(s[:19], 3) - rho_r
    else:
        f_r, f_b = model._apply_outlet(*model._apply_inlet(*state))
        rho_r, rho_b = mac.density(f_r, 3), mac.density(f_b, 3)
    g = model._fields_from_densities(rho_r, rho_b)[3]
    _, kappa = cg.csf_force_nd(g, model.p.surface_tension, model.is_fluid,
                               inward_normal=True, lat=model.lat)
    return torch.stack([*g, torch.where(model.is_fluid, kappa, 0.0)])


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
# the launcher's refusal, a mirror of csrc/cg3d_block.cuh::kMaxSteps3; the
# wrappers split a call by the library's own cg3d_block_max_steps
MAX_BLOCK_STEPS = 8


def _march_plan(params: Cg3dParams, dtype, split: bool, steps: int,
                device="cuda"):
    """K9-T's plan for `params` and a state of `dtype` (its compute type's
    item size) in the split layout or not, built once a process a
    configuration: (plan, its table on `device`)."""
    itemsize = 8 if dtype == torch.float64 else 4
    shape = (params.nz, params.ny, params.nx)
    key = ("cg3d", shape, steps, itemsize, bool(split), params.inlet,
           params.outlet, bool(params.has_wetting))
    return march3d.device_plan(key, lambda: march3d.cg3d_march_plan(
        shape, steps, itemsize, bool(split), params.inlet, params.outlet,
        bool(params.has_wetting)), device)


def cg3d_block_tiling(dtype, split: bool, params: Cg3dParams,
                      steps: int) -> dict:
    """How a K9-T launch of `steps` steps covers the domain of `params` for
    a state of `dtype` (the split layout if `split`): its march plan's
    levels, lag (slabs a level trails the one before), slabs a wave, bands,
    band rows and halo rows, ring slabs of level 0's arrays, scratch bytes,
    waves and stages, and the cooperative grid (blocks)."""
    plan, _ = _march_plan(params, dtype, split, steps)
    return plan.fields() | {"grid": march3d.march_grid(
        _BLOCK_LIBS[dtype], "cg3d", 2, 5, Cg3dParams, int(split))}


def launch_cg3d_block(state, params: Cg3dParams, geo: torch.Tensor,
                      steps: int):
    """`steps` kernel steps (one launch: the z-march on ``cg3d_march_plan``'s
    plan) of a CUDA state: the compressed tensor (as ``launch_cg3d`` takes
    it) or the split pair (f_r, f_b) (as ``launch_cg3d_split``).  Returns
    the state in the same form.  Not counted as a launch."""
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
    plan, table = _march_plan(params, a.dtype, split, steps, a.device)
    march3d.march_launch(_BLOCK_LIBS[a.dtype], "cg3d", (int(split), steps),
                         tensors, plan, table, params)
    return out


def cg3d_block_max_steps(dtype, split: bool) -> int:
    """The largest T one K9-T launch takes for a state of `dtype` in the
    split layout or not: the library's ``kMaxSteps3``
    (``build.max_steps``)."""
    return build.max_steps(_BLOCK_LIBS[dtype], "cg3d_block", (int(split),))


def _block_model(t: torch.Tensor, model, steps):
    build.check_steps(steps)
    _check_model_device(t, model)


def _block_calls(state, model, steps: int, fn):
    """`steps` steps of a CUDA state as ``build.split_steps``'s launches of
    ``launch_cg3d_block``, each counted on `fn`."""
    split = not torch.is_tensor(state)
    dtype = state[0].dtype if split else state.dtype
    for t in build.split_steps(steps, cg3d_block_max_steps(dtype, split)):
        state = launch_cg3d_block(state, model.kernel_params,
                                  model.geo_planes, t)
        fn.launches += 1
    return state


def cg3d_block_compressed(s: torch.Tensor, model, steps: int) -> torch.Tensor:
    """`steps` compressed D3Q19 CSF steps (boundary slabs before each) for
    `model`, a ColorGradientRK3D: the (20, nz, ny, nx) state in
    ``model.dtype`` or the 21-plane bfloat16 state.  CPU tensor: the plain
    version.  CUDA tensor: K9-Tc / K9-Th, one launch when T fits one
    (``cg3d_block_max_steps``), else ``build.split_steps``'s launches, each
    counted; or an error; never the plain version.  A bf16 state is decoded
    and encoded once a launch, so a chunked bf16 call equals the same
    chunks of plain calls."""
    if s.device.type == "cpu":
        return cg3d_block_compressed_reference(s, model, steps)
    _block_model(s, model, steps)
    if s.dtype not in (model.dtype, torch.bfloat16) or (
            s.dtype == torch.bfloat16 and model.dtype != torch.float32):
        raise ValueError(f"state {s.dtype}; the model takes {model.dtype} or, "
                         "in float32 arithmetic, bfloat16")
    return _block_calls(s, model, steps, cg3d_block_compressed)


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
    plain version.  CUDA tensors: K9-Ts, one launch when T fits one, else
    ``build.split_steps``'s launches, each counted; or an error; never the
    plain version."""
    f_r, f_b = state
    if f_r.device != f_b.device:
        raise ValueError(f"f_r on device {f_r.device}, f_b on {f_b.device}")
    if f_r.device.type == "cpu":
        return cg3d_block_split_reference(state, model, steps)
    _block_model(f_r, model, steps)
    if f_r.dtype != model.dtype or f_b.dtype != model.dtype:
        raise ValueError(f"split state {f_r.dtype}/{f_b.dtype}; the model "
                         f"takes {model.dtype}")
    return _block_calls((f_r, f_b), model, steps, cg3d_block_split)


cg3d_block_split.launches = 0


def cg3d_block_split_reference(state, model, steps: int):
    """Plain PyTorch version of K9-Ts, on any device: `steps` plain split
    steps (``plain_step``)."""
    build.check_steps(steps)
    state = tuple(state)
    for _ in range(steps):
        state = model.plain_step(state)
    return state


# -- the local form (K12d): one shard of a z- or (z, y)-decomposed domain ----

_LOCAL_LIBS = {torch.float64: "cg3d_local_f64",
               torch.float32: "cg3d_local_f32"}
LOCAL_LIBRARIES = tuple(_LOCAL_LIBS.values())
LOCAL_REACH = 4    # csrc/cg3d_local.cuh::kReach: slabs (rows) a step reads


class Local3(ctypes.Structure):
    """Mirror of ``struct Local3`` in csrc/cg3d_local.cuh: a 3-D shard's
    centre (slabs, rows), its frame (slabs, rows on each side; 0: y not
    split), the global slab of its first centre slab and the global
    slabs."""
    _fields_ = [("nz", ctypes.c_int), ("ny", ctypes.c_int),
                ("fz", ctypes.c_int), ("fy", ctypes.c_int),
                ("z0", ctypes.c_int), ("gnz", ctypes.c_int)]


def cg3d_local_frame(y_axis: bool):
    """The frame (``parallel.mesh.Frame``) of a K12d shard: the step's
    reach in z, and in y on a mesh whose x axis splits y."""
    from ..parallel.mesh import Frame
    r = LOCAL_REACH
    return Frame(r, r, r if y_axis else 0)


def _local_args(params: Cg3dParams, grid, nz: int):
    """The local libraries' parameter block (the buffer's extents in nz
    and ny) and ``Local3`` of the shard `grid` (``parallel.mesh.LocalGrid``
    of a 3-D domain of `nz` global slabs)."""
    p = Cg3dParams.from_buffer_copy(params)
    p.nz, p.ny = grid.py, grid.px
    return p, Local3(grid.ny, grid.nx, grid.fy, grid.fx, grid.row0, nz)


_local_cache: dict[str, tuple] = {}


def _local_fns(lib_name: str):
    """(slabs, step, error_string) of a K12d library."""
    if lib_name not in _local_cache:
        lib = build.load_library(lib_name)
        slabs = lib.cg3d_local_slabs
        slabs.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.POINTER(Cg3dParams), ctypes.POINTER(Local3),
            ctypes.c_void_p]
        slabs.restype = ctypes.c_int
        step = lib.cg3d_local_step
        step.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.POINTER(Cg3dParams), ctypes.POINTER(Tracer3dParams),
            ctypes.POINTER(Local3), ctypes.c_void_p]
        step.restype = ctypes.c_int
        err = lib.cg3d_local_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _local_cache[lib_name] = (slabs, step, err)
    return _local_cache[lib_name]


def _check_local3(grid, want, *pairs):
    """Raise unless each (tensor, leading planes) of `pairs` is a contiguous
    ``(*planes, py, px, nx)`` buffer of `grid` in `want` on one card."""
    dev = pairs[0][0].device
    for t, lead in pairs:
        shape = (*lead, grid.py, grid.px, *grid.tail)
        if t.device != dev or t.device.type != "cuda" or \
                tuple(t.shape) != shape or t.dtype != want or \
                not t.is_contiguous():
            raise ValueError(f"local buffer {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}; the kernel takes a contiguous "
                             f"{shape} {want} on {dev}")


def _owns_slabs(flow, grid) -> bool:
    """Whether the shard `grid` holds a boundary slab of `flow`'s domain in
    its centre: the inlet's top two slabs, or the outlet's bottom ones."""
    nz = flow.geo.shape[0]
    return (flow.bcs.inlet != "periodic" and grid.row0 + grid.ny == nz) or \
        (flow.bcs.outlet != "periodic" and grid.row0 == 0)


def launch_cg3d_local_slabs(s: torch.Tensor, params: Cg3dParams,
                            geo: torch.Tensor, grid, nz: int) -> None:
    """The boundary slabs of the centre of the shard `grid`'s padded
    compressed (20, pz, py, nx) f32 or f64 buffer `s`, in place (global
    slabs of a domain of `nz`); `geo` its padded (4, pz, py, nx) geometry
    planes.  Not counted as a launch."""
    if s.dtype not in _LOCAL_LIBS:
        raise ValueError(f"state {s.dtype}; K12d takes float32 or float64")
    _check_local3(grid, s.dtype, (s, (20,)), (geo, (4,)))
    slabs, _, err = _local_fns(_LOCAL_LIBS[s.dtype])
    p, g = _local_args(params, grid, nz)
    with torch.cuda.device(s.device):
        code = slabs(s.data_ptr(), geo.data_ptr(), ctypes.byref(p),
                     ctypes.byref(g),
                     torch.cuda.current_stream(s.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"cg3d_local_slabs launch failed: "
                           f"{err(code).decode()} ({code})")


def launch_cg3d_local(s: torch.Tensor, out: torch.Tensor,
                      params: Cg3dParams, geo: torch.Tensor, grid, nz: int,
                      g: torch.Tensor | None = None,
                      g_out: torch.Tensor | None = None,
                      tparams: Tracer3dParams | None = None,
                      table: torch.Tensor | None = None,
                      work: dict | None = None) -> None:
    """One step of the shard `grid` (a domain of `nz` global slabs): its
    padded compressed buffer `s` (boundary slabs applied, frame filled) into
    the centre of `out`; with the tracer PDFs `g` (NT, 7, pz, py, nx), their
    step into the centre of `g_out` (`tparams`, `table` as
    ``launch_cg3d_coupled`` takes them).  The scratch (g and kappa) is kept
    in `work` (``build.work_buffer``).  Not counted as a launch."""
    if s.dtype not in _LOCAL_LIBS:
        raise ValueError(f"state {s.dtype}; K12d takes float32 or float64")
    _check_local3(grid, s.dtype, (s, (20,)), (out, (20,)), (geo, (4,)))
    nt = 0 if g is None else tparams.nt
    if g is not None:
        _check_local3(grid, s.dtype, (g, (nt, 7)), (g_out, (nt, 7)))
        if table.dtype != s.dtype or tuple(table.shape) != (nt, 8) or \
                table.device != s.device:
            raise ValueError(f"tracer table {tuple(table.shape)} "
                             f"{table.dtype} on {table.device}")
    _, step, err = _local_fns(_LOCAL_LIBS[s.dtype])
    p, lg = _local_args(params, grid, nz)
    dev = s.device
    planes = (grid.py, grid.px, *grid.tail)
    fld = build.work_buffer(work, "fld", (FIELD_PLANES, *planes), s.dtype,
                            dev)
    ptr = [0 if t is None else t.data_ptr() for t in (g, g_out, table)]
    with torch.cuda.device(dev):
        code = step(s.data_ptr(), out.data_ptr(), geo.data_ptr(),
                    fld.data_ptr(), *ptr, ctypes.byref(p),
                    ctypes.byref(tparams or Tracer3dParams()),
                    ctypes.byref(lg),
                    torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"cg3d_local_step launch failed: "
                           f"{err(code).decode()} ({code})")


def _check_local_state(s: torch.Tensor, flow):
    if s.device.type != "cuda":
        raise ValueError(f"no cg3d kernel for device {s.device}")
    if s.dtype != flow.dtype or flow.storage != "f32":
        raise ValueError(f"state {s.dtype}; the model takes {flow.dtype} "
                         f"({flow.storage} storage), K12d float32 or "
                         "float64")


def cg3d_local_slabs(s: torch.Tensor, geo: torch.Tensor, flow, grid):
    """The boundary slabs of `flow` (a ColorGradientRK3D of the global
    domain) in the centre of the shard `grid`'s padded compressed buffer
    `s`, in place, before the exchange; `geo` the shard's padded geometry
    planes.  A shard without a boundary slab in its centre launches
    nothing.  CPU tensors: the plain version.  CUDA tensors: one launch of
    K12d's slab kernel, or an error."""
    if not _owns_slabs(flow, grid):
        return s
    if s.device.type == "cpu":
        grid.centre(s).copy_(cg3d_local_slabs_reference(s, flow, grid))
        return s
    _check_local_state(s, flow)
    launch_cg3d_local_slabs(s, flow.kernel_params, geo, grid,
                            flow.geo.shape[0])
    cg3d_local_slabs.launches += 1
    return s


cg3d_local_slabs.launches = 0


def rest_state3(flow) -> torch.Tensor:
    """The compressed (20, nz, ny, nx) state at rest, rho = 1 and all blue,
    on the fluid cells of `flow`'s domain: what the plain local versions put
    around a shard (no centre cell reads it)."""
    fl = flow.fluid_mask
    return torch.cat([flow._w_col(fl.device).reshape(19, 1, 1, 1) * fl,
                      torch.zeros_like(fl)[None]])


def cg3d_local_slabs_reference(s: torch.Tensor, flow, grid):
    """Plain version of K12d's slab kernel, on any device: the shard's
    padded buffer embedded in the domain at rest, the model's boundary
    slabs (``_apply_bcs_c``), the centre taken back.  Returns the centre
    (20, nz, ny, nx) of the shard."""
    x = embed_local(s, grid, rest_state3(flow))
    return take_centre(flow._apply_bcs_c(x), grid)


def cg3d_local_step(s: torch.Tensor, out: torch.Tensor, geo: torch.Tensor,
                    flow, grid, work: dict | None = None) -> torch.Tensor:
    """One compressed step of one shard for `flow`, a ColorGradientRK3D of
    the global domain: `s` the shard's padded buffer (boundary slabs
    applied by ``cg3d_local_slabs``, frame filled), the result written into
    the centre of `out`, which is returned; `geo` the shard's padded
    geometry planes; `work` a dict that keeps the kernel's scratch from
    call to call (None: allocated each call).  CPU tensors: the plain
    version.  CUDA tensors: one launch of K12d, or an error; never the
    plain version."""
    if s.device.type == "cpu":
        grid.centre(out).copy_(cg3d_local_step_reference(s, flow, grid))
        return out
    _check_local_state(s, flow)
    launch_cg3d_local(s, out, flow.kernel_params, geo, grid,
                      flow.geo.shape[0], work=work)
    cg3d_local_step.launches += 1
    return out


cg3d_local_step.launches = 0


def cg3d_local_step_reference(s: torch.Tensor, flow, grid):
    """Plain version of K12d, on any device: the shard's padded buffer
    embedded at its global slabs and rows in the domain at rest, the
    model's physics (``_physics_c``: the boundary slabs are in the buffer
    already), the centre taken back.  Exact wherever the frame covers the
    step's reach, which it does.  Returns the centre (20, nz, ny, nx)."""
    x = embed_local(s, grid, rest_state3(flow))
    return take_centre(flow._physics_c(x), grid)


def coupled3d_local_step(ins, outs, geo: torch.Tensor, model, grid,
                         work: dict | None = None):
    """One coupled step of one shard for `model`, a TransportRK3D of the
    global domain: ``ins = (s, g)`` the shard's padded flow buffer
    (boundary slabs applied, frame filled) and tracer PDFs (NT, 7, pz, py,
    nx), the results written into the centres of ``outs``, which is
    returned; `work` as ``cg3d_local_step`` takes it.  CPU tensors: the
    plain version.  CUDA tensors: one launch of K12d with its tracer
    passes, or an error; never the plain version."""
    (s, g), (out, g_out) = ins, outs
    if s.device.type == "cpu":
        for o, r in zip(outs, coupled3d_local_step_reference(ins, model,
                                                              grid)):
            grid.centre(o).copy_(r)
        return outs
    flow = model.flow
    _check_local_state(s, flow)
    launch_cg3d_local(s, out, flow.kernel_params, geo, grid,
                      flow.geo.shape[0], g, g_out, model.tracer_params,
                      model.tracer_table, work)
    coupled3d_local_step.launches += 1
    return outs


coupled3d_local_step.launches = 0


def coupled3d_local_step_reference(ins, model, grid):
    """Plain version of K12d with tracers, on any device: both padded
    buffers embedded in the domain (the flow at rest, the tracers 0), the
    tracer step on the post-slab fields and the flow's physics, as
    ``TransportRK3D.plain_step_c`` after its slabs; the centres taken
    back."""
    from ..ops import macroscopic as mac
    s, g = ins
    flow = model.flow
    x = embed_local(s, grid, rest_state3(flow))
    nz, ny, nx = flow.geo.shape
    gg = embed_local(g, grid, g.new_zeros((*g.shape[:2], nz, ny, nx)))
    f_tot, rho_r = x[:19], x[19]
    gg = model._tracer_step(gg, f_tot, rho_r, mac.density(f_tot, 3) - rho_r)
    return take_centre(flow._physics_c(x), grid), take_centre(gg, grid)


# the JAX builder's y halo on a (z, y) mesh (pallas/cg3d.py:1419-1423): it
# refuses ny/px <= 2 of them
TPU_HALO_Y = 8


def build_cg3d_sharded_step(geometry: Geometry, params, mesh,
                            dtype=torch.float32, bc_config=None,
                            transport=None):
    """The compressed D3Q19 CSF step (K12d) under a z- or (z, y)-decomposed
    `mesh` (``parallel.mesh.make_mesh``: its y axis splits z, its x axis
    y): the counterpart of ``pallas/cg3d.py::build_cg3d_sharded_step``.
    `params` a ``ColorGradientParams3D``, `bc_config` a
    ``CG3DBoundaryConfig`` (None: periodic), `transport` a
    ``TransportD3Q7`` (z meshes only) for the coupled step, all the port's.

    Returns a ``parallel.mesh.ShardedStep`` of one step a call:
    ``step(state)`` advances ``step.shard(s)`` (or ``step.shard(s, g)``
    with the tracer PDFs (NT, 7, nz, ny, nx)) in place, ``step.gather``
    gives the global (20, nz, ny, nx) state (and the tracer PDFs).  Per
    call each shard holding a boundary slab rewrites it
    (``cg3d_local_slabs``), the frames are exchanged, then each shard runs
    K12d (``cg3d_local_step`` or ``coupled3d_local_step``) on a card, its
    plain version on the CPU.

    Returns None where the JAX builder builds no step for a reason of the
    domain or the state: nz not divisible by the mesh's py or ny by its px;
    transport with px > 1; px > 1 with ny/px <= 2 x 8 (its y halo,
    ``TPU_HALO_Y``); bfloat16 storage; boundary kinds or a tracer interface
    no kernel takes.  The TPU strips' constraints (slabs a block, a halo
    H >= 4 dividing the strip and nz/py, the VMEM model) do not apply
    here, so e.g. 6-slab shards run where the JAX builder refuses.  The
    port refuses instead a shard shallower (or narrower) than its frame
    (``cg3d_local_frame``, the step's reach 4; the JAX builder needs H >= 4
    slabs too) and a domain below 8x2x2, which no K9 takes."""
    from .._device import resolve_dtype
    from ..models.flow3d import (CG3DBoundaryConfig, ColorGradientRK3D,
                                 TransportRK3D)
    from ..parallel.mesh import ShardedStep, shard_domain

    nz, ny, nx = geometry.shape
    py, px = mesh.shape
    dtype = resolve_dtype(dtype)
    bcs = bc_config if bc_config is not None else CG3DBoundaryConfig()
    tr = transport
    if nz % py or ny % px or dtype == torch.bfloat16 or \
            (tr is not None and px > 1) or \
            (px > 1 and ny // px <= 2 * TPU_HALO_Y) or \
            bcs.inlet not in _INLETS or bcs.outlet not in _OUTLETS or \
            (tr is not None and tr.interface_mode not in ("none",
                                                          "bounceback")):
        return None
    frame = cg3d_local_frame(px > 1)
    if nz < 8 or ny < 2 or nx < 2 or frame.lo > nz // py or \
            frame.x > ny // px:
        return None
    if tr is None:
        model = flow = ColorGradientRK3D(geometry, params, bcs, dtype=dtype,
                                         device=mesh.device)
    else:
        model = TransportRK3D(
            geometry, params, tr.num_tracers, tuple(tr.tau),
            tuple(tr.j_coeffs[:, 0]), tr.criteria, tr.interface_mode,
            dtype=dtype, boundaries=bcs, device=mesh.device)
        flow = model.flow
    geo = dict(zip(mesh.local_ids(),
                   shard_domain(flow.geo_planes, mesh, frame, rank=3)))

    def prologue(k, grid, ins):
        cg3d_local_slabs(ins[0], geo[k], flow, grid)

    work = {k: {} for k in mesh.local_ids()}
    if tr is None:
        def local(k, grid, ins, outs):
            cg3d_local_step(ins[0], outs[0], geo[k], flow, grid, work[k])
        dtypes = (dtype,)
    else:
        def local(k, grid, ins, outs):
            coupled3d_local_step(ins, outs, geo[k], model, grid, work[k])
        dtypes = (dtype, dtype)
    has_slabs = bcs.inlet != "periodic" or bcs.outlet != "periodic"
    step = ShardedStep(mesh, (nz, ny, nx), frame, local, 1, dtypes,
                       prologue=prologue if has_slabs else None)
    step.model = model
    return step
