"""Explicit device and dtype resolution.

The port never picks a device behind the caller's back: a model runs on the
``device`` it is given, and ops run on the device of their input tensors.
Asking for CUDA on a machine without a card raises instead of quietly
falling back to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "resolve_dtype"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


def resolve_device(device: str | torch.device = "cpu") -> torch.device:
    """torch.device for `device`; raises if it names CUDA and no card exists."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False")
    return dev


def resolve_dtype(dtype: str | torch.dtype) -> torch.dtype:
    """torch dtype from a torch dtype or its name ("float32", ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPES[dtype]
