"""K9-T on the split state on the CPU: ``ColorGradientRK3D.make_block_step(2)``
(T plain split steps, the boundary slabs before each) against the JAX
package's blocked Pallas kernel in interpret mode (``build_cg3d_fused_step``
with ``steps_per_call=2``, ``slabs_per_block=16``, ``state_mode="split"``)
with a velocity inlet and the NEBB pressure outlet, on the 16^3 box with
walls on the y faces of ``test_torch_block_cg3d.py``, at f64.  One JAX
build a file: it takes about 90 s on a CPU."""

import torch

from openlbmpm_torch.kernels import cg3d as K
from test_torch_block_cg3d import _gap, blocked_pair, run_pair

torch.set_num_threads(1)


def test_split_block_matches_pallas_blocked():
    """Two calls of ``make_block_step(2)`` against two calls of the JAX
    T = 2 kernel, whose window rewrites slab 1 and copies it to ghost slab
    0, and splits each new population by the slab's red fraction, before
    every sub-step: 1e-11 (measured 1.1e-16)."""
    _, blk, fused, x = blocked_pair("dirichlet", "split", torch.float64)
    got, want = run_pair(blk, fused, x)
    assert _gap(got, want) <= 1e-11
    assert K.cg3d_block_split.launches == 0
