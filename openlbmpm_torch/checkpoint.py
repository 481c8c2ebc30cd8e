"""Checkpoint / resume and drainage-imbibition (D-I) cycles (counterpart of
``openlbmpm_tpu/checkpoint.py``).

Checkpoints are plain npz files with the JAX package's keys: the state's
leaves in order as ``leaf{i}`` (a tuple or NamedTuple of tensors, nested
tuples flattened depth first, as ``jax.tree_util.tree_flatten`` orders
them), ``__step__``, ``__fingerprint__`` and ``__treedef__``.  So a
checkpoint written by either package resumes in the other, bit for bit.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

__all__ = ["config_fingerprint", "save_checkpoint", "load_checkpoint",
           "di_cycle_swap", "di_cycle_swap_sc"]


def config_fingerprint(obj) -> str:
    """Stable hash of a (nested) params object for resume validation; the
    JAX package's hash of the same values."""
    def enc(o):
        if hasattr(o, "__dataclass_fields__"):
            return {k: enc(getattr(o, k)) for k in o.__dataclass_fields__}
        if isinstance(o, (list, tuple)):
            return [enc(v) for v in o]
        if isinstance(o, np.ndarray):
            return o.tolist()
        return o
    payload = json.dumps(enc(obj), sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _leaves(state) -> list:
    if isinstance(state, (tuple, list)):
        return [leaf for part in state for leaf in _leaves(part)]
    return [state]


def _structure(state) -> str:
    if isinstance(state, (tuple, list)):
        return "(" + ", ".join(_structure(p) for p in state) + ")"
    return "*"


def _rebuild(like, leaves):
    if isinstance(like, (tuple, list)):
        parts = [_rebuild(p, leaves) for p in like]
        if hasattr(like, "_fields"):
            return type(like)(*parts)
        return type(like)(parts)
    return leaves.pop(0)


def save_checkpoint(path: str, state, step: int, fingerprint: str = ""):
    """Write the state (a tensor, or tuples / NamedTuples of tensors) to
    npz, copying each leaf to the host."""
    payload = {f"leaf{i}": np.asarray(v.detach().cpu()) if torch.is_tensor(v)
               else np.asarray(v) for i, v in enumerate(_leaves(state))}
    payload["__step__"] = np.asarray(step)
    payload["__fingerprint__"] = np.asarray(fingerprint)
    payload["__treedef__"] = np.asarray(_structure(state))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **payload)


def load_checkpoint(path: str, like_state, fingerprint: str = ""):
    """Load a checkpoint into the structure of `like_state`, each leaf in
    the type and on the device of its counterpart there.

    Returns (state, step).  Raises ValueError when both sides carry a
    fingerprint and they differ (resuming with other physics)."""
    with np.load(path, allow_pickle=False) as z:
        saved_fp = str(z["__fingerprint__"])
        if fingerprint and saved_fp and saved_fp != fingerprint:
            raise ValueError(
                f"checkpoint fingerprint {saved_fp} != config {fingerprint}")
        leaves = []
        for i, ref in enumerate(_leaves(like_state)):
            arr = z[f"leaf{i}"]
            leaves.append(torch.as_tensor(arr).to(dtype=ref.dtype,
                                                  device=ref.device))
        step = int(z["__step__"])
    return _rebuild(like_state, leaves), step


def di_cycle_swap(f_r, f_b, buffer_rows: int, top: bool = True):
    """Swap the two fluids inside the buffer layers to reverse the
    displacement direction for the next drainage/imbibition cycle.

    f_r, f_b: colour PDFs (9, ny, nx); buffer_rows: buffer rows on the
    inlet side; top: the inlet is the top of the domain."""
    ny = f_r.shape[-2]
    sl = slice(ny - buffer_rows, ny) if top else slice(0, buffer_rows)
    new_r, new_b = f_r.clone(), f_b.clone()
    new_r[..., sl, :] = f_b[..., sl, :]
    new_b[..., sl, :] = f_r[..., sl, :]
    return new_r, new_b


def di_cycle_swap_sc(f, buffer_rows: int, top: bool = True):
    """The Shan-Chen D-I cycle swap: exchange fluids 0 and 1 inside the
    buffer rows of the stacked state f (K, 9, ny, nx)."""
    ny = f.shape[-2]
    sl = slice(ny - buffer_rows, ny) if top else slice(0, buffer_rows)
    out = f.clone()
    out[0, :, sl, :] = f[1, :, sl, :]
    out[1, :, sl, :] = f[0, :, sl, :]
    return out
