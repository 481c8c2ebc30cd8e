"""Pull streaming with half-way bounce-back (counterpart of
``openlbmpm_tpu/ops/streaming.py``):

    f_i'(x) = f_i(x - e_i)      if x - e_i is fluid
            = f_opp(i)(x)       if x - e_i is solid
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice import Lattice
from .common import pull

__all__ = ["upwind_solid_masks", "stream"]


def upwind_solid_masks(lat: Lattice, is_solid: np.ndarray) -> np.ndarray:
    """(Q, ny, nx) bool: is the upwind source x - e_i a solid node?"""
    is_solid = np.asarray(is_solid, dtype=bool)
    masks = [np.zeros_like(is_solid)]  # the rest population never bounces
    for i in range(1, lat.q):
        d = lat.e[i]
        masks.append(np.roll(is_solid, shift=(int(d[1]), int(d[0])),
                             axis=(0, 1)))
    return np.stack(masks)


def stream(f: torch.Tensor, lat: Lattice,
           upwind_solid: torch.Tensor) -> torch.Tensor:
    """Stream one (Q, ny, nx) PDF stack; values on solid nodes are not
    meaningful (callers mask them)."""
    outs = [f[0]]
    for i in range(1, lat.q):
        pulled = pull(f[i], int(lat.e[i, 0]), int(lat.e[i, 1]))
        outs.append(torch.where(upwind_solid[i], f[int(lat.opp[i])], pulled))
    return torch.stack(outs)
