"""The port's plain D3Q19 CSF steps (models/flow3d.py, kernels/cg3d.py)
against the JAX package's Pallas kernel ``pallas/cg3d.py`` in interpret
mode, on the CPU, at tests/test_pallas_cg3d.py's 16^3 setup (walls on the y
faces, velocity inlet):

* the plain compressed step against the compressed kernel (convective
  outlet, 2 f64 steps, 1e-11, as ``test_cg3d_compressed_matches_split``);
* the plain split step against the split kernel (Dirichlet outlet, 1e-11);
* the plain bf16 step against the bf16 kernel, within
  ``test_cg3d_bf16_storage_tracks_f32``'s bounds.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from openlbmpm_tpu import geometry as jgeo
from openlbmpm_tpu.models import flow3d as jf
from openlbmpm_tpu.pallas.cg3d import build_cg3d_fused_step
from openlbmpm_torch.convert import state_to_numpy
from openlbmpm_torch.geometry import from_solid_mask
from openlbmpm_torch.kernels import cg3d as K
from openlbmpm_torch.models.flow3d import (CG3DBoundaryConfig,
                                           ColorGradientParams3D,
                                           ColorGradientRK3D)

torch.set_num_threads(1)

CPU = "cpu"   # the port's models run on the card unless told otherwise


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _gap(a, b):
    return max(float(np.abs(_np(x) - _np(y)).max()) for x, y in zip(a, b))


def _bc_model(outlet, dtype=torch.float64, storage="f32"):
    """tests/test_pallas_cg3d.py's BC setup: 16^3 with walls on the y faces,
    velocity inlet, `outlet`."""
    solid = np.zeros((16, 16, 16), bool)
    solid[:, 0, :] = solid[:, -1, :] = True
    params = ColorGradientParams3D(surface_tension=0.01, tau_r=1.0, tau_b=0.8,
                                   contact_angle_deg=60.0)
    bcs = CG3DBoundaryConfig(inlet="velocity", outlet=outlet,
                             inlet_velocity=-1e-3)
    return ColorGradientRK3D(from_solid_mask(solid), params, bcs, dtype=dtype,
                             device=CPU, storage=storage)


def _pallas(m, dtype, **kw):
    p = jf.ColorGradientParams3D(**dataclasses.asdict(m.p))
    b = jf.CG3DBoundaryConfig(**dataclasses.asdict(m.bcs))
    step = build_cg3d_fused_step(jgeo.from_solid_mask(m.geo.is_solid), p,
                                 dtype, slabs_per_block=16, bc_config=b,
                                 interpret=True, **kw)
    assert step is not None
    return step


def test_compressed_plain_matches_pallas_compressed():
    """``step_c`` follows the compressed kernel's BC prologue and physics:
    2 f64 steps to 1e-11 (measured 2.2e-16)."""
    m = _bc_model("convective")
    fused = _pallas(m, jnp.float64, state_mode="compressed")
    s = m.pack_state(*m.init_state_layers(1.0, 1.0, invading_slabs=6))
    js = jnp.asarray(_np(s))
    for _ in range(2):
        s = K.cg3d_step_compressed(s, m)
        js = fused(js)
    assert _gap([s], [js]) <= 1e-11


def test_split_plain_matches_pallas_split():
    """``cg3d_step_split_reference`` against the split kernel with the NEBB
    pressure outlet: 2 f64 steps to 1e-11."""
    m = _bc_model("dirichlet")
    fused = _pallas(m, jnp.float64, state_mode="split")
    st = m.init_state_layers(1.0, 1.0, invading_slabs=6)
    js = tuple(jnp.asarray(_np(t)) for t in st)
    for _ in range(2):
        st = K.cg3d_step_split_reference(st, m)
        js = fused(*js)
    assert _gap(st, js) <= 1e-11


def test_bf16_plain_tracks_pallas_bf16():
    """The plain bf16 step against the Pallas bf16 kernel, 3 steps, within
    test_cg3d_bf16_storage_tracks_f32's bounds (planes 5e-3, rho_r 2e-2,
    red mass 1e-3).  It cannot be held tighter: the Pallas bf16 instance
    keeps its geometry planes, wall normals included, in bf16, the port
    in float32, so the Akai rotation differs by bf16 rounding of n_s
    (measured: 7.6e-6 after 2 steps)."""
    m = _bc_model("convective", dtype=torch.float32, storage="bf16")
    fused = _pallas(m, jnp.float32, state_mode="compressed", storage="bf16")
    h = m.pack_state_bf16(*m.init_state_layers(1.0, 1.0, invading_slabs=6))
    jh = jnp.asarray(state_to_numpy(h))
    for _ in range(3):
        h = K.cg3d_step_compressed(h, m)
        jh = fused(jh)
    assert h.dtype == torch.bfloat16 and tuple(h.shape) == (21, 16, 16, 16)
    got = m.unpack_bf16(h).numpy()
    want = np.asarray(jnp.concatenate(
        [jh[:19].astype(jnp.float32) + jnp.asarray(
            np.asarray(m.lat.w, np.float32).reshape(-1, 1, 1, 1) *
            m.geo.is_fluid[None]),
         (jh[19].astype(jnp.float32) + jh[20].astype(jnp.float32))[None]]))
    assert np.isfinite(got).all()
    assert np.abs(got[:19] - want[:19]).max() < 5e-3
    assert np.abs(got[19] - want[19]).max() < 2e-2
    assert abs(got[19].sum() - want[19].sum()) / want[19].sum() < 1e-3
