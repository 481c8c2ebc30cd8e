"""Build the CUDA sources in ``openlbmpm_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, ``openlbmpm_torch/_build/lib<name>-<hash>.so``, which
``ctypes`` loads.  The hash covers every file in ``csrc/`` and the compiler
flags, so an edited source rebuilds and an unchanged one is reused.  Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "build_seconds", "BUILD_DIR", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
    so = BUILD_DIR / f"lib{name}-{_digest()}.so"
    build_seconds[name] = 0.0
    if not so.exists():
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
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
