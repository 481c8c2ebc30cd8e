"""K9-T on the compressed state in float32 on the CPU:
``ColorGradientRK3D.make_block_step(2, compressed=True)`` against the JAX
package's blocked Pallas kernel in interpret mode (``steps_per_call=2``,
``slabs_per_block=16``) with a velocity inlet and the NEBB pressure outlet,
on the 16^3 box of ``test_torch_block_cg3d.py``.  One JAX build a file: it
takes about 65 s on a CPU."""

import numpy as np
import torch

from test_torch_block_cg3d import _np, blocked_pair, run_pair

torch.set_num_threads(1)


def test_f32_block_tracks_pallas_blocked():
    """Two calls in float32.  The two sides differ by rounding: the Pallas
    kernel forms the normals with rsqrt and breaks the wetting rotation's
    ties on squared distances, the port follows the jnp formulas.  Off the
    slabs of the periodic seam and the boundary slabs (z = 0-2 and
    nz-4 ... nz-1, where the red inlet meets the blue outlet and the
    interface's normals amplify rounding) they agree to 1e-5 (measured
    1.1e-6); on the seam to 1e-3 (measured 2.5e-4)."""
    _, blk, fused, x = blocked_pair("dirichlet", "compressed", torch.float32)
    got, want = run_pair(blk, fused, x)
    d = np.abs(_np(got) - _np(want)).max(axis=0)
    assert np.isfinite(_np(got)).all()
    assert d[3:-4].max() <= 1e-5
    assert d.max() <= 1e-3
