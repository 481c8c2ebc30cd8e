"""Build the CUDA sources in ``openlbmpm_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, ``openlbmpm_torch/_build/lib<name>-<hash>.so``, which
``ctypes`` loads.  The hash covers every file in ``csrc/`` and the library's
compiler flags, so an edited source rebuilds and an unchanged one is
reused.  Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["load_library", "load_libraries", "build_seconds", "BUILD_DIR",
           "NVCC_FLAGS", "EXTRA_FLAGS", "LIBRARIES", "block_fns",
           "launch_block", "block_tiling", "check_steps", "split_steps",
           "max_steps", "launch_runtime_k", "work_buffer"]

# every library of csrc/: the CSF step, the coupled step and the
# Perturbation step (f32 and bf16; their f64 instances apart), and in three storage types each the
# Shan-Chen step, the D3Q19 CSF step, the single-phase D2Q9 step, the D3Q19
# single-phase and Shan-Chen steps; the T-step (temporally blocked)
# colour-gradient, Shan-Chen, single-phase D2Q9, coupled flow + tracer,
# D3Q19 single-phase and Shan-Chen and D3Q19 CSF steps; the 2-D and 3-D
# Shan-Chen steps for any number of fluids (all storage types in one
# library each); and the local forms of the colour-gradient, coupled,
# single-phase and Shan-Chen T-step kernels, of the D3Q19 CSF step and of
# the D3Q19 Shan-Chen step (one shard of a decomposed domain, f64 and f32)
LIBRARIES = ("csf2d", "csf2d_f64", "coupled2d", "coupled2d_f64", "pert2d",
             "pert2d_f64", "sc2d_f64",
             "sc2d_f32", "sc2d_bf16", "cg3d_f64", "cg3d_f32", "cg3d_bf16",
             "single2d_f64", "single2d_f32", "single2d_bf16", "flow3d_f64",
             "flow3d_f32", "flow3d_bf16", "csf2d_block_f64",
             "csf2d_block_f32", "csf2d_block_bf16", "sc2d_block_f64",
             "sc2d_block_f32", "sc2d_block_bf16", "single2d_block_f64",
             "single2d_block_f32", "single2d_block_bf16",
             "coupled2d_block_f64", "coupled2d_block_f32",
             "coupled2d_block_bf16", "flow3d_block_f64", "flow3d_block_f32",
             "flow3d_block_bf16", "cg3d_block_f64", "cg3d_block_f32",
             "cg3d_block_bf16", "sc2d_rt", "sc3d_rt", "csf2d_local_f64",
             "csf2d_local_f32", "coupled2d_local_f64", "coupled2d_local_f32",
             "single2d_local_f64", "single2d_local_f32", "cg3d_local_f64",
             "cg3d_local_f32", "flow3d_local_f64", "flow3d_local_f32",
             "sc2d_local_f64", "sc2d_local_f32")

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of single libraries: the f64 instances, which exist to check the
# kernels against the plain path, contract no a*b + c into an FMA, so their
# products and sums round as the plain path's do (a wetting rotation near
# its sin = 0 threshold turns a one-ulp difference into a visible one)
EXTRA_FLAGS = {name: ("-fmad=false",) for name in
               ("csf2d_f64", "coupled2d_f64", "cg3d_f64", "single2d_f64",
                "flow3d_f64", "pert2d_f64",
                "csf2d_block_f64", "sc2d_block_f64", "single2d_block_f64",
                "coupled2d_block_f64", "flow3d_block_f64",
                "cg3d_block_f64", "sc2d_rt", "sc3d_rt", "csf2d_local_f64",
                "coupled2d_local_f64", "single2d_local_f64", "cg3d_local_f64",
                "flow3d_local_f64", "sc2d_local_f64")}

_loaded: dict[str, ctypes.CDLL] = {}
# seconds spent compiling each library in this process (0.0 = reused)
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + EXTRA_FLAGS.get(name, ()))
                       .encode())
    for p in sorted(SRC_DIR.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and load it (cached per process).

    The compiler's output (ptxas register and spill counts) is kept beside
    the library as ``lib<name>-<hash>.log``."""
    if name in _loaded:
        return _loaded[name]
    src = SRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(src)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"lib{name}-{_digest(name)}.so"
    build_seconds[name] = 0.0
    if not so.exists():
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o",
               str(tmp), str(src)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds[name] = time.perf_counter() - t0
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _loaded[name] = lib
    return lib


# -- the T-step libraries ---------------------------------------------------
# Each of them exports <prefix>_block_step(ints..., pointers..., params,
# stream), <prefix>_block_scratch_bytes(ints..., params),
# <prefix>_block_shape(ints..., params, long long[8]) and
# <prefix>_block_error_string(code); the ints are the state mode where the
# family has several, then T.

_block_cache: dict[str, tuple] = {}
_TILING_KEYS = ("tx", "ty", "hx", "hlo", "hhi", "gmem", "grid", "window_bytes")


def block_fns(lib: str, prefix: str, ints: int, pointers: int, params_type):
    """(step, scratch_bytes, shape, error_string) of the T-step library
    `lib` (built at first use): its entry points take `ints` leading ints,
    the step `pointers` pointers (the last one the scratch), and a
    `params_type` block."""
    if lib not in _block_cache:
        so = load_library(lib)
        lead = [ctypes.c_int] * ints
        block = ctypes.POINTER(params_type)
        step = getattr(so, f"{prefix}_block_step")
        step.argtypes = lead + [ctypes.c_void_p] * pointers + \
            [block, ctypes.c_void_p]
        step.restype = ctypes.c_int
        scratch = getattr(so, f"{prefix}_block_scratch_bytes")
        scratch.argtypes = lead + [block]
        scratch.restype = ctypes.c_longlong
        shape = getattr(so, f"{prefix}_block_shape")
        shape.argtypes = lead + [block, ctypes.POINTER(ctypes.c_longlong)]
        shape.restype = ctypes.c_int
        err = getattr(so, f"{prefix}_block_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _block_cache[lib] = (step, scratch, shape, err)
    return _block_cache[lib]


def launch_block(lib: str, fns, ints, tensors, params) -> None:
    """One launch of a T-step library's step (`fns` from ``block_fns``) on
    the current stream of the first tensor's card: the `ints`, the
    `tensors`' pointers (None is a null pointer), then a global scratch of
    the size the library asks for (null when it asks for none), and the
    parameter block.  A failed launch raises."""
    import torch

    step, scratch_bytes, _, err = fns
    nbytes = scratch_bytes(*ints, ctypes.byref(params))
    if nbytes < 0:
        raise ValueError(f"{lib}: no instance for {tuple(ints)}")
    dev = next(t for t in tensors if t is not None).device
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes \
        else None
    ptrs = [0 if t is None else t.data_ptr() for t in (*tensors, scratch)]
    with torch.cuda.device(dev):
        code = step(*ints, *ptrs, ctypes.byref(params),
                    torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{lib} block step launch failed: "
                           f"{err(code).decode()} ({code})")


def block_tiling(lib: str, fns, ints, params) -> dict:
    """A 2-D window library's tiling of one launch, from its
    ``*_block_shape`` entry point (`fns` from ``block_fns``) called with
    `ints` and `params`: the tile (tx, ty), the halo (hx columns a side, hlo
    rows below, hhi above), whether the windows live in global scratch
    (gmem), the blocks launched and one window's bytes."""
    out = (ctypes.c_longlong * 8)()
    code = fns[2](*ints, ctypes.byref(params), out)
    if code != 0:
        raise ValueError(f"{lib}: no tiling for these arguments ({code})")
    return dict(zip(_TILING_KEYS, (int(v) for v in out)))


def check_steps(steps) -> None:
    """Raise unless `steps`, a T-step call's step count, is a positive
    int."""
    if not isinstance(steps, int) or steps < 1:
        raise ValueError(f"steps {steps!r}: a positive int")


def split_steps(steps: int, limit: int) -> list:
    """The step counts of the launches of a T-step call of `steps` steps
    when one launch takes at most `limit`: ceil(steps / limit) launches of
    near-equal counts (the larger first), whose sum is `steps`."""
    check_steps(steps)
    if not isinstance(limit, int) or limit < 1:
        raise ValueError(f"limit {limit!r}: a positive int")
    n = -(-steps // limit)
    q, r = divmod(steps, n)
    return [q + 1] * r + [q] * (n - r)


_max_cache: dict = {}


def max_steps(lib: str, prefix: str, ints, params=None) -> int:
    """The largest T one launch of the T-step library `lib` takes for the
    configuration of `ints` (the state mode or kind where the family has
    several) and the parameter block `params` (None: the entry point takes
    none), from its ``<prefix>_max_steps`` entry point: the code that sets
    the limit (a window that fits, or the launch's step cap)."""
    key = (lib, prefix, tuple(ints), None if params is None else
           (type(params).__name__, bytes(params)))
    if key not in _max_cache:
        fn = getattr(load_library(lib), f"{prefix}_max_steps")
        fn.argtypes = [ctypes.c_int] * len(ints) + (
            [] if params is None else [ctypes.POINTER(type(params))])
        fn.restype = ctypes.c_int
        args = list(ints) + ([] if params is None else [ctypes.byref(params)])
        t = int(fn(*args))
        if t < 1:
            raise ValueError(f"{lib}: no launch takes one step of this "
                             f"configuration ({t})")
        _max_cache[key] = t
    return _max_cache[key]


def work_buffer(work: dict | None, name: str, shape, dtype, device):
    """A launch's scratch tensor `name`: kept in the dict `work` (a caller's
    per-shard store) and reused while its shape, dtype and device stay, else
    allocated there; a fresh tensor when `work` is None."""
    import torch
    shape = tuple(int(v) for v in shape)
    t = None if work is None else work.get(name)
    if t is None or tuple(t.shape) != shape or t.dtype != dtype or \
            t.device != device:
        t = torch.empty(shape, dtype=dtype, device=device)
        if work is not None:
            work[name] = t
    return t


# -- the runtime-K Shan-Chen libraries -----------------------------------------
# sc2d_rt and sc3d_rt export <prefix>_rt_step(storage, T, f_in, f_out, aux,
# scratch, table, params, stream), <prefix>_rt_scratch_bytes(storage,
# params) and <prefix>_rt_error_string(code); storage 0 f64, 1 f32, 2 bf16.

_RT_STORAGE = {"torch.float64": 0, "torch.float32": 1, "torch.bfloat16": 2}
_rt_cache: dict[str, tuple] = {}


def launch_runtime_k(lib: str, prefix: str, params_type, f, aux, table,
                     params, steps: int):
    """`steps` steps (one call) of a runtime-K library `lib` on the CUDA
    state `f` (the step's checks done by the caller): `aux` the geometry
    planes or fluid mask, `table` the per-fluid float64 table on the card.
    Returns the new state; a failed launch raises."""
    import torch

    if lib not in _rt_cache:
        so = load_library(lib)
        block = ctypes.POINTER(params_type)
        step = getattr(so, f"{prefix}_rt_step")
        step.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + \
            [block, ctypes.c_void_p]
        step.restype = ctypes.c_int
        scratch = getattr(so, f"{prefix}_rt_scratch_bytes")
        scratch.argtypes = [ctypes.c_int, block]
        scratch.restype = ctypes.c_longlong
        err = getattr(so, f"{prefix}_rt_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _rt_cache[lib] = (step, scratch, err)
    step, scratch_bytes, err = _rt_cache[lib]
    check_steps(steps)
    code = _RT_STORAGE[str(f.dtype)]
    f = f.contiguous()
    out = torch.empty_like(f)
    scratch = torch.empty(scratch_bytes(code, ctypes.byref(params)),
                          dtype=torch.uint8, device=f.device)
    with torch.cuda.device(f.device):
        rc = step(code, steps, f.data_ptr(), out.data_ptr(), aux.data_ptr(),
                  scratch.data_ptr(), table.data_ptr(), ctypes.byref(params),
                  torch.cuda.current_stream(f.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{prefix}_rt_step launch failed: "
                           f"{err(rc).decode()} ({rc})")
    return out


def load_libraries(names=LIBRARIES) -> dict[str, ctypes.CDLL]:
    """``load_library`` for each name, the builds running side by side (one
    nvcc process per source)."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(load_library, names)))
