"""Temporal blocking of the Shan-Chen step (K8-T), on the CPU.

``ShanChenMCMP.make_block_step`` of the port (on the CPU: T plain steps,
bf16 decoded once and encoded once) against the JAX package's blocked
Pallas kernel (``pallas/shanchen.py::build_sc_fused_step``) in interpret
mode at T = 2, on the cases of ``tests/test_pallas_sc.py:19-134`` taken
from ``chip_smoke.SC_CASES`` (32 x 24, side walls except the periodic
droplet): the periodic droplet with a body force, the velocity/convective
and pressure/pressure channel rows, EFS iso-8 MRT and three fluids, at f64
to 1e-12 over two calls, and the plain model of K8-T's row-march plan
(``kernels/march2d.py::sc2d_march_reference``, four rows a wave) over the
same two calls; the velocity/convective channel in bf16 storage
within the K8 bf16 bound; and ``make_block_step`` returning None exactly
where the JAX ``make_block_step`` does.  The CUDA kernel is held to these
plain versions by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import SC_CASES, WALL_VELOCITY, sc_rho0, sc_solid
from openlbmpm_tpu import geometry as geo
from openlbmpm_tpu.models import shanchen as js
from openlbmpm_tpu.pallas.shanchen import build_sc_fused_step
from openlbmpm_torch.convert import params_from_jax
from openlbmpm_torch.kernels import march2d as M2
from openlbmpm_torch.kernels.shanchen import sc_block_step
from openlbmpm_torch.models.shanchen import ShanChenMCMP

torch.set_num_threads(1)
CPU = "cpu"   # the port's models run on the card unless told otherwise


def _models(name, ny=32, nx=24, dtype=jnp.float64, storage="f32"):
    """(JAX model, port model, the common initial state) of a case."""
    p, b, init = SC_CASES[name]
    solid, moving = sc_solid(ny, nx, init)
    g = geo.from_solid_mask(solid)
    jp, jb = js.ShanChenParams(**p), js.SCBoundaryConfig(**b)
    mj = js.ShanChenMCMP(g, jp, jb, dtype=dtype, use_pallas=False,
                         moving_wall_mask=moving, wall_velocity=WALL_VELOCITY)
    mt = ShanChenMCMP(g, params_from_jax(jp), params_from_jax(jb),
                      dtype=torch.float64 if dtype == jnp.float64
                      else torch.float32, device=CPU, storage=storage,
                      moving_wall_mask=moving, wall_velocity=WALL_VELOCITY)
    f0 = np.asarray(mj._feq_init(jnp.asarray(
        sc_rho0(mj.k, ny, nx, init) * g.is_fluid, dtype)))
    return mj, mt, f0


def _jax_block(mj, dtype, **kw):
    rpb = 16 if mj.p.scheme == "EFS" and mj.p.iso_order > 4 else 8
    return build_sc_fused_step(mj.geo, mj.p, dtype, rows_per_block=rpb,
                               steps_per_call=2, bc_config=mj.bcs,
                               interpret=True, **kw)


@pytest.mark.parametrize("name", [
    "sc_srt_periodic_body_force", "sc_srt_velocity_convective",
    "sc_srt_pressure_pressure", "efs8_mrt_velocity_convective",
    "sc_three_fluids"])
def test_sc_block_matches_jax_kernel_f64(name):
    """Two calls of T = 2 against the JAX blocked kernel, to 1e-12: the
    port's T-step call on the CPU and the plain model of K8-T's plan."""
    mj, mt, f0 = _models(name)
    blk = mt.make_block_step(steps_per_call=2)
    assert blk.steps_per_call == 2
    jblk = _jax_block(mj, jnp.float64)
    plan = M2.sc2d_march_plan(mt.geo.shape, 2, 8, *M2.sc_codes(mt),
                              rows_per_wave=4)
    a, b = jnp.asarray(f0), torch.from_numpy(f0.copy())
    c = b
    for _ in range(2):
        a, b = jblk(a), blk(b)
        c = M2.sc2d_march_reference(c, mt, 2, plan)
    assert float(np.abs(b.numpy() - np.asarray(a)).max()) < 1e-12
    assert float(np.abs(c.numpy() - np.asarray(a)).max()) < 1e-12


def test_sc_bf16_block_matches_jax_kernel():
    """The velocity/convective channel in bf16 storage at T = 2 from a common
    bf16 state (packing bit for bit): decoded within the K8 bf16 bound of
    phase 17, 3e-3."""
    mj, mt, f0 = _models("sc_srt_velocity_convective", dtype=jnp.float32,
                         storage="bf16")
    jblk = _jax_block(mj, jnp.float32, storage="bf16")
    blk = mt.make_block_step(steps_per_call=2, storage="bf16")
    h = mj.pack_state_bf16(jnp.asarray(f0))
    ht = mt.pack_state_bf16(torch.from_numpy(f0.copy()))
    np.testing.assert_array_equal(ht.view(torch.int16).numpy(),
                                  np.asarray(h).view(np.int16))
    got = mt.unpack_bf16(blk(ht)).numpy()
    want = np.asarray(mj.unpack_bf16(jblk(h)))
    assert float(np.abs(got - want).max()) < 3e-3


def test_sc_make_block_step_refuses_as_jax():
    """None exactly where the JAX make_block_step returns None (moving
    wall, guo/edm forcing) or its build function does (Chang and
    true-convective rows): every case of SC_CASES; on CPU tensors the wrapper is its plain
    version and counts no launch."""
    for name in SC_CASES:
        mj, mt, _ = _models(name)
        # strips the JAX build function takes (a shape it refuses is TPU
        # machinery)
        rpb = 16 if mj.p.scheme == "EFS" and mj.p.iso_order > 4 else 8
        jb = mj.make_block_step(steps_per_call=2, rows_per_block=rpb,
                                interpret=True)
        pb = mt.make_block_step(steps_per_call=2)
        assert (jb is None) == (pb is None), name
    _, mt, f0 = _models("sc_three_fluids")
    f = torch.from_numpy(f0.copy())
    before = sc_block_step.launches
    assert torch.equal(sc_block_step(f, mt, 2),
                       mt.plain_step(mt.plain_step(f)))
    assert sc_block_step.launches == before
    assert mt.make_block_step(steps_per_call=1) == mt.step
