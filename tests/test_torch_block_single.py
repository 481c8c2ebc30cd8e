"""Temporal blocking of the single-phase D2Q9 step (K7-T), on the CPU.

``SinglePhaseD2Q9.make_block_step`` of the port (on the CPU: T plain steps,
bf16 decoded once and encoded once) against the JAX package's blocked
Pallas kernel (its ``make_block_step``, ``pallas/single.py``) in interpret
mode on the 32 x 24 channel of ``tests/test_single_phase.py:78-106`` with a
body force: SRT, TRT and MRT, each with the Zou-He rows at one of T = 2, 4
and the pressure inlet / convective outlet at the other, at f64 to 1e-12
over 4 steps; the Zou-He channel in bf16 storage at T = 2 within the K7
bf16 bound; and ``make_block_step`` returning None exactly where JAX builds
no kernel or the port's K7 takes none (the moving wall).  The CUDA kernel
is held to these plain versions by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openlbmpm_tpu import geometry as geo
from openlbmpm_tpu.models import single_phase as jsp
from openlbmpm_torch.convert import single_phase_args_from_jax
from openlbmpm_torch.kernels.single import single_block_step
from openlbmpm_torch.models.single_phase import SinglePhaseD2Q9

torch.set_num_threads(1)
CPU = "cpu"   # the port's models run on the card unless told otherwise
BCS = {
    "zou_he": dict(inlet="zou_he_velocity", outlet="zou_he_pressure",
                   inlet_velocity=-1e-3, outlet_density=1.0),
    "convective": dict(inlet="zou_he_pressure", outlet="convective",
                       inlet_density=1.02),
}


def _pair(collision, bc, dtype=jnp.float64, storage="f32", **kw):
    solid = np.zeros((32, 24), bool)
    solid[:, 0] = solid[:, -1] = True
    g = geo.from_solid_mask(solid)
    mj = jsp.SinglePhaseD2Q9(g, tau=0.8, collision=collision,
                             body_force=(1e-6, -2e-6),
                             boundaries=jsp.BoundaryConfig(**BCS[bc]),
                             dtype=dtype, **kw)
    mt = SinglePhaseD2Q9(g, **single_phase_args_from_jax(mj),
                         dtype=torch.float64 if dtype == jnp.float64
                         else torch.float32, device=CPU, storage=storage,
                         moving_wall_mask=kw.get("moving_wall_mask"))
    return mj, mt


def _start(m, seed=0):
    """A perturbed equilibrium on the fluid (numpy, f64)."""
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.97, 1.03, m.geo.shape)
    u = [rng.uniform(-0.02, 0.02, m.geo.shape) for _ in range(2)]
    from openlbmpm_tpu.lattice import D2Q9
    from openlbmpm_tpu.ops.equilibrium import feq_quadratic
    return np.asarray(feq_quadratic(D2Q9, jnp.asarray(rho), tuple(
        jnp.asarray(v) for v in u))) * m.geo.is_fluid


@pytest.mark.parametrize("collision,bc,t", [
    ("SRT", "zou_he", 2), ("SRT", "convective", 4), ("TRT", "zou_he", 4),
    ("TRT", "convective", 2), ("MRT", "zou_he", 2), ("MRT", "convective", 4)])
def test_single_block_matches_jax_kernel_f64(collision, bc, t):
    """4 steps in calls of T against the JAX blocked kernel, to 1e-12."""
    mj, mt = _pair(collision, bc)
    jblk = mj.make_block_step(steps_per_call=t, rows_per_block=16,
                              interpret=True)
    blk = mt.make_block_step(steps_per_call=t)
    assert blk.steps_per_call == t
    f = _start(mt)
    a, b = jnp.asarray(f), torch.from_numpy(f.copy())
    for _ in range(4 // t):
        a, b = jblk(a), blk(b)
    assert float(np.abs(b.numpy() - np.asarray(a)).max()) < 1e-12


def test_single_bf16_block_matches_jax_kernel():
    """The Zou-He channel, MRT, in bf16 storage at T = 2 from a common bf16
    state (packing bit for bit): decoded within the K7 bf16 bound of phase
    30, 3e-4."""
    mj, mt = _pair("MRT", "zou_he", dtype=jnp.float32, storage="bf16")
    jblk = mj.make_block_step(steps_per_call=2, rows_per_block=16,
                              interpret=True, storage="bf16")
    blk = mt.make_block_step(steps_per_call=2, storage="bf16")
    f = _start(mt, seed=3).astype(np.float32)
    h = mj.pack_state_bf16(jnp.asarray(f))
    ht = mt.pack_state_bf16(torch.from_numpy(f))
    np.testing.assert_array_equal(ht.view(torch.int16).numpy(),
                                  np.asarray(h).view(np.int16))
    got = mt.unpack_bf16(blk(ht)).numpy()
    want = np.asarray(mj.unpack_bf16(jblk(h)))
    assert float(np.abs(got - want).max()) < 3e-4


def test_single_make_block_step_refusals():
    """None for the moving wall (the JAX blocked K7 drops it, ROADMAP
    section 3) and for row kinds outside K7's; on CPU tensors the wrapper
    is its plain version and counts no launch; T = 1 gives ``step``."""
    moving = np.zeros((32, 24), bool)
    moving[:, 0] = True
    _, mt = _pair("SRT", "zou_he", moving_wall_mask=moving,
                  wall_velocity=(0.0, 0.01))
    assert mt.make_block_step(steps_per_call=2) is None
    _, mt = _pair("MRT", "convective")
    f = torch.from_numpy(_start(mt))
    before = single_block_step.launches
    want = f
    for _ in range(3):
        want = mt.plain_step(want)
    assert torch.equal(single_block_step(f, mt, 3), want)
    assert single_block_step.launches == before
    assert mt.make_block_step(steps_per_call=1) == mt.step
    with pytest.raises(ValueError):
        mt.make_block_step(steps_per_call=2, storage="f16")
