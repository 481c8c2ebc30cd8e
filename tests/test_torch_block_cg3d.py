"""Temporal blocking of the D3Q19 CSF step (K9-T) on the CPU.

* ``ColorGradientRK3D.make_block_step(2)`` of the port (on the CPU: T plain
  steps, the boundary slabs before each) against the JAX package's blocked
  Pallas kernel (``build_cg3d_fused_step`` with ``steps_per_call=2``,
  ``slabs_per_block=16`` and the boundary slabs inside its window) in
  interpret mode, two calls on tests/test_pallas_cg3d.py's 16^3 box with
  walls on the y faces and a velocity inlet: here the compressed state in
  f64 with the convective outlet (1e-11); the split state in f64 with the
  pressure outlet in ``test_torch_block_cg3d_split.py`` and the compressed
  state in f32 in ``test_torch_block_cg3d_f32.py`` (the JAX T = 2 kernel
  takes 55-175 s to build on a CPU, so each file builds one);
* a call is T plain steps, bit for bit;
* the bf16 form decodes once, steps in float32 and encodes once;
* ``make_block_step`` returns None exactly where the JAX builder builds no
  kernel on grounds of layout (bf16 on the split state), gives ``step`` /
  ``step_c`` at T = 1, ignores the TPU's slab knobs, and returns None with
  ``use_kernel=False``;
* the wrappers take the plain version for CPU tensors and count no launch.

The CUDA kernel is held to these plain versions on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phases 60-62.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openlbmpm_tpu import geometry as jgeo
from openlbmpm_tpu.models import flow3d as jf
from openlbmpm_tpu.pallas.cg3d import build_cg3d_fused_step
from openlbmpm_torch.geometry import from_solid_mask
from openlbmpm_torch.kernels import cg3d as K
from openlbmpm_torch.models.flow3d import (CG3DBoundaryConfig,
                                           ColorGradientParams3D,
                                           ColorGradientRK3D)

torch.set_num_threads(1)
CPU = "cpu"   # the port's models run on the card unless told otherwise
N = 16


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _gap(a, b):
    return max(float(np.abs(_np(x) - _np(y)).max()) for x, y in zip(a, b))


def _model(outlet, dtype=torch.float64, storage="f32", **kw):
    """tests/test_pallas_cg3d.py's BC setup: 16^3, walls on the y faces,
    velocity inlet, `outlet`."""
    solid = np.zeros((N,) * 3, bool)
    solid[:, 0, :] = solid[:, -1, :] = True
    params = ColorGradientParams3D(surface_tension=0.01, tau_r=1.0, tau_b=0.8,
                                   contact_angle_deg=60.0)
    bcs = CG3DBoundaryConfig(inlet="velocity", outlet=outlet,
                             inlet_velocity=-1e-3)
    return ColorGradientRK3D(from_solid_mask(solid), params, bcs, dtype=dtype,
                             device=CPU, storage=storage, **kw)


def _pallas(m, dtype, steps, **kw):
    p = jf.ColorGradientParams3D(**dataclasses.asdict(m.p))
    b = jf.CG3DBoundaryConfig(**dataclasses.asdict(m.bcs))
    return build_cg3d_fused_step(jgeo.from_solid_mask(m.geo.is_solid), p,
                                 dtype, slabs_per_block=16,
                                 steps_per_call=steps, bc_config=b,
                                 interpret=True, **kw)


def blocked_pair(outlet, layout, dtype):
    """The port's model, its ``make_block_step(2)`` and the JAX T = 2
    kernel of the same configuration, and the start (compressed or split,
    as the port and as numpy for JAX)."""
    m = _model(outlet, dtype)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    compressed = layout == "compressed"
    fused = _pallas(m, jdt, 2, state_mode=layout)
    assert fused is not None
    blk = m.make_block_step(2, compressed=compressed)
    assert blk.steps_per_call == 2
    st = m.init_state_layers(1.0, 1.0, invading_slabs=6)
    x = m.pack_state(*st) if compressed else st
    return m, blk, fused, x


def run_pair(blk, fused, x, calls=2):
    """`calls` calls of the port's T-step form and of the JAX kernel from
    the common start x; returns both results."""
    split = not torch.is_tensor(x)
    jx = tuple(jnp.asarray(_np(t)) for t in x) if split else \
        jnp.asarray(_np(x))
    for _ in range(calls):
        x = blk(x)
        jx = fused(*jx) if split else fused(jx)
    return x, jx


def test_compressed_block_matches_pallas_blocked():
    """Two calls of ``make_block_step(2, compressed=True)`` against two
    calls of the JAX T = 2 kernel (its window applies the velocity inlet
    and the convective cascade by global z before every sub-step) at f64:
    1e-11 (measured 2.2e-16)."""
    _, blk, fused, x = blocked_pair("convective", "compressed", torch.float64)
    got, want = run_pair(blk, fused, x)
    assert _gap([got], [want]) <= 1e-11
    assert K.cg3d_block_compressed.launches == 0


def test_block_step_is_t_plain_steps():
    """On the CPU a call is T plain steps: ``step_c`` / ``step`` T times,
    bit for bit, on the model's own T = 1 path."""
    m = _model("convective")
    st = m.init_state_layers(1.0, 1.0, invading_slabs=6)
    s = m.pack_state(*st)
    a, b = m.make_block_step(3, compressed=True)(s), s
    for _ in range(3):
        b = m.step_c(b)
    assert torch.equal(a, b)
    x, y = m.make_block_step(3)(st), st
    for _ in range(3):
        y = m.step(y)
    assert all(torch.equal(u, v) for u, v in zip(x, y))


def test_bf16_block_decodes_once():
    """The bf16 form: the 21-plane state decoded once, T float32 plain
    steps (the boundary slabs on the float32 values, as the kernel's
    window applies them) and one encoding; it differs from T one-step bf16
    calls, which round the state every step."""
    m = _model("convective", dtype=torch.float32, storage="bf16")
    h = m.pack_state_bf16(*m.init_state_layers(1.0, 1.0, invading_slabs=6))
    got = m.make_block_step(2, compressed=True, storage="bf16")(h)
    x = m.unpack_bf16(h)
    for _ in range(2):
        x = m.plain_step_c(x)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16),
                       m.pack_compressed_bf16(x).view(torch.int16))
    once = m.step_c(m.step_c(h))
    assert not torch.equal(got.view(torch.int16), once.view(torch.int16))


def test_block_step_returns_none_where_jax_does():
    """bf16 on the split layout: no form (pallas/cg3d.py:196-197), as the
    JAX builder; the compressed bf16 form exists on both sides.  T = 1
    gives the one-step methods; the slab knobs are ignored;
    ``use_kernel=False`` has no T-step form."""
    m = _model("dirichlet", dtype=torch.float32)
    assert m.make_block_step(2, storage="bf16") is None
    assert _pallas(m, jnp.float32, 2, state_mode="split",
                   storage="bf16") is None
    assert m.make_block_step(2, compressed=True, storage="bf16") is not None
    assert m.make_block_step(1) == m.step
    assert m.make_block_step(1, compressed=True) == m.step_c
    blk = m.make_block_step(4, slabs_per_block=3, interpret=True,
                            compressed=True)
    assert blk.steps_per_call == 4
    assert _model("dirichlet", use_kernel=False).make_block_step(2) is None
    with pytest.raises(ValueError):
        m.make_block_step(0)
    with pytest.raises(ValueError):
        _model("dirichlet").make_block_step(2, compressed=True,
                                            storage="bf16")


def test_block_wrappers_refuse_bad_steps():
    """``steps`` must be a positive int; the launcher refuses more than
    MAX_BLOCK_STEPS before it reaches a library."""
    m = _model("convective")
    s = m.pack_state(*m.init_state_layers(1.0, 1.0, invading_slabs=6))
    with pytest.raises(ValueError):
        K.cg3d_block_compressed(s, m, 0)
    with pytest.raises(ValueError):
        K.launch_cg3d_block(s, m.kernel_params, m.geo_planes,
                            K.MAX_BLOCK_STEPS + 1)
