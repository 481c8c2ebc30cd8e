"""The compressed coupled CSF + tracer step: CUDA kernel wrapper, plain
PyTorch version and launch count.

Counterpart of ``openlbmpm_tpu/pallas/csf.py::build_csf_fused_step`` with
``transport_params`` in ``state_mode="compressed"`` at one step per call
(K5, compressed), for an f64 or f32 flow state and for the 11-plane bf16
flow state.  The kernels live in ``csrc/coupled2d.cu``; the flow half runs
the same code as ``csrc/csf2d.cu`` (shared through ``csrc/csf2d.cuh``).

The coupled state is ``(s, g)``: ``s`` as in ``kernels/csf.py`` and ``g``
(NT, NQ, ny, nx) tracer PDFs in the arithmetic type (float64 with an f64
state, float32 with an f32 or bf16 one), NQ 5 (D2Q5) or 9 (D2Q9).

``coupled_step_compressed(s, g, model)`` takes the plain version only when
both tensors lie on the CPU; for CUDA tensors it launches the kernels or
raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .csf import _STORAGE_CODE, CsfParams

__all__ = ["TracerParams", "tracer_kernel_params", "tracer_table",
           "launch_coupled2d", "coupled_step_compressed",
           "coupled_step_compressed_reference"]


class TracerParams(ctypes.Structure):
    """Mirror of ``struct TracerParams`` in csrc/coupled2d.cu."""
    _fields_ = [
        ("nt", ctypes.c_int), ("nq", ctypes.c_int),
        ("mrt", ctypes.c_int), ("quadratic", ctypes.c_int),
        ("interface", ctypes.c_int),  # 0 none, 1 permeable, 2 bounceback
        ("inlet", ctypes.c_int),      # 0 none, 1 inamuro, 2 anti-bb, 3 zero
        ("outlet", ctypes.c_int),     # 0 none, 1 freeflow
        ("reaction", ctypes.c_int),
        ("criteria", ctypes.c_double), ("rate", ctypes.c_double),
    ]


_INTERFACE = {"none": 0, "permeable": 1, "bounceback": 2}
_INLET = {"none": 0, "inamuro": 1, "anti_bounce_back": 2, "zero": 3}
_OUTLET = {"none": 0, "freeflow": 1}


def tracer_kernel_params(tp) -> TracerParams:
    """The kernel's option block for a TransportParams (options already
    checked by the model)."""
    return TracerParams(
        nt=tp.num_tracers, nq=tp.scheme, mrt=int(tp.relaxation == "MRT"),
        quadratic=int(tp.mrt_equilibrium == "quadratic"),
        interface=_INTERFACE[tp.interface_mode], inlet=_INLET[tp.inlet],
        outlet=_OUTLET[tp.outlet], reaction=int(bool(tp.reaction_rate)),
        criteria=tp.criteria, rate=tp.reaction_rate)


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


_fn_cache: dict[str, ctypes._CFuncPtr] = {}


def _kernel_fn():
    if "step" not in _fn_cache:
        lib = build.load_library("coupled2d")
        fn = lib.coupled2d_step
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + \
            [ctypes.POINTER(CsfParams), ctypes.POINTER(TracerParams),
             ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.coupled2d_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn_cache["step"] = fn
        _fn_cache["error"] = err
    return _fn_cache["step"]


def launch_coupled2d(s: torch.Tensor, g: torch.Tensor, params: CsfParams,
                     tparams: TracerParams, geo: torch.Tensor,
                     table: torch.Tensor):
    """One coupled kernel step of the CUDA state (s, g): `s` as
    ``kernels/csf.py::launch_csf2d`` takes it, `g` (NT, NQ, ny, nx) and the
    per-tracer `table` in the geometry planes' type.  Not counted as a
    launch."""
    ny, nx = params.ny, params.nx
    nt, nq = tparams.nt, tparams.nq
    want = geo.dtype
    if g.dtype != want or tuple(g.shape) != (nt, nq, ny, nx):
        raise ValueError(f"tracer PDFs {tuple(g.shape)} {g.dtype}; the "
                         f"kernel takes ({nt}, {nq}, {ny}, {nx}) {want}")
    if table.dtype != want or tuple(table.shape) != (nt, 9 + nq * nq):
        raise ValueError(f"tracer table {tuple(table.shape)} {table.dtype}")
    bf16 = s.dtype == torch.bfloat16
    planes = 11 if bf16 else 10
    if s.dtype not in _STORAGE_CODE or tuple(s.shape) != (planes, ny, nx) \
            or want != (torch.float32 if bf16 else s.dtype):
        raise ValueError(f"state {tuple(s.shape)} {s.dtype}; the kernel "
                         f"takes ({planes}, {ny}, {nx}) with {want} planes")
    if tuple(geo.shape) != (5, ny, nx):
        raise ValueError(f"geometry planes {tuple(geo.shape)}")
    if ny < 8 or nx < 3:
        raise NotImplementedError(f"kernel: domain {ny}x{nx} below 8x3")
    if not (s.device == g.device == geo.device == table.device):
        raise ValueError(f"state on {s.device}, tracers on {g.device}, "
                         f"geometry on {geo.device}, table on {table.device}")
    s, g, table = s.contiguous(), g.contiguous(), table.contiguous()
    fn = _kernel_fn()
    dev = s.device
    phi = torch.empty((ny, nx), dtype=want, device=dev)
    nrm = torch.empty((4, ny, nx), dtype=want, device=dev)
    g_post = torch.empty_like(g)
    dom = torch.empty((ny, nx), dtype=torch.uint8, device=dev)
    out_s = torch.empty_like(s)
    out_g = torch.empty_like(g)
    stream_ptr = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = fn(_STORAGE_CODE[s.dtype], s.data_ptr(), out_s.data_ptr(),
                  geo.data_ptr(), phi.data_ptr(), nrm.data_ptr(),
                  g.data_ptr(), g_post.data_ptr(), out_g.data_ptr(),
                  dom.data_ptr(), table.data_ptr(), ctypes.byref(params),
                  ctypes.byref(tparams), stream_ptr)
    if code != 0:
        msg = _fn_cache["error"](code).decode()
        raise RuntimeError(f"coupled2d_step launch failed: {msg} ({code})")
    return out_s, out_g


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
