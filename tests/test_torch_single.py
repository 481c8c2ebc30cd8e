"""The port's single-phase D2Q9 slice against the JAX package, on the CPU.

* the new ops (``bgk``, ``trt``, ``trt_force_transform``, ``velocity``)
  against the jnp ops on random fields (1e-14);
* ``SinglePhaseD2Q9``'s plain step against the jitted jnp ``_step_impl``,
  20 f64 steps to 1e-12, for every collision (SRT, TRT, MRT) under every
  row pair (periodic, Zou-He velocity + pressure, Zou-He pressure +
  convective), with and without the body force, and the moving-wall
  cavity;
* the same step against the JAX fused kernel K7 in interpret mode at T=1
  (``make_block_step(steps_per_call=1, interpret=True)``), 1e-12, and in
  bf16 storage within one bf16 rounding of each stored value;
* ``pack_state_bf16`` bit for bit, ``load_basic`` field by field, the path
  rules and the refusals;
* the analytic Poiseuille profile through ``ShanChenMCMP`` with ``edm``
  forcing and MRT, JAX and port alike (ROADMAP section 1 item 2).
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import poiseuille_error
from openlbmpm_tpu import config as jconfig
from openlbmpm_tpu import geometry as geo
from openlbmpm_tpu.lattice import D2Q9, D3Q19
from openlbmpm_tpu.models import shanchen as js
from openlbmpm_tpu.models import single_phase as jsp
from openlbmpm_tpu.ops import collision as jcol
from openlbmpm_tpu.ops import equilibrium as jeq
from openlbmpm_tpu.ops import macroscopic as jmac
from openlbmpm_torch import config as tconfig
from openlbmpm_torch.convert import (params_from_jax,
                                     single_phase_args_from_jax,
                                     state_from_numpy)
from openlbmpm_torch.kernels.csf import compare_bf16_states
from openlbmpm_torch.kernels.single import single_step, single_step_reference
from openlbmpm_torch.models.shanchen import ShanChenMCMP
from openlbmpm_torch.models.single_phase import (BoundaryConfig,
                                                 SinglePhaseD2Q9,
                                                 takes_kernel)
from openlbmpm_torch.ops import collision as tcol
from openlbmpm_torch.ops import macroscopic as tmac

torch.set_num_threads(1)
CPU = "cpu"   # the port's models run on the card unless told otherwise

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASIC_INI = os.path.join(ROOT, "configs", "basicsetup.ini")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol):
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _close(g, w, atol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("lat", [D2Q9, D3Q19], ids=["D2Q9", "D3Q19"])
def test_new_ops_equal_jax(lat):
    rng = np.random.default_rng(1)
    shape = (lat.q, 6, 7) if lat.dim == 2 else (lat.q, 4, 5, 6)
    f, feq, src = rng.uniform(0.0, 0.2, (3, *shape))
    rho = rng.uniform(0.5, 1.5, shape[1:])
    rho[0, 0] = 0.0
    force = tuple(rng.uniform(-1e-3, 1e-3, (lat.dim, *shape[1:])))
    for tau in (0.7, 1.3):
        _close(tcol.bgk(_t(f), _t(feq), tau), jcol.bgk(f, feq, tau), 1e-14)
        _close(tcol.trt(_t(f), _t(feq), lat, tau),
               jcol.trt(jnp.asarray(f), jnp.asarray(feq), lat, tau), 1e-14)
        _close(tcol.trt_force_transform(_t(src), lat, tau),
               jcol.trt_force_transform(jnp.asarray(src), lat, tau), 1e-14)
    for frc in (None, force):
        _close(tmac.velocity(lat, _t(f), _t(rho),
                             None if frc is None else tuple(map(_t, frc))),
               jmac.velocity(lat, jnp.asarray(f), jnp.asarray(rho), frc),
               1e-14)


def _geometry(ny=32, nx=24, obstacle=True):
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    if obstacle:
        solid[ny // 2 - 2:ny // 2 + 2, nx // 3:nx // 3 + 3] = True
    return geo.from_solid_mask(solid)


BCS = {
    "periodic": jsp.BoundaryConfig(),
    "velocity_pressure": jsp.BoundaryConfig(
        inlet="zou_he_velocity", outlet="zou_he_pressure",
        inlet_velocity=-1e-3, outlet_density=1.0),
    "pressure_convective": jsp.BoundaryConfig(
        inlet="zou_he_pressure", outlet="convective", inlet_density=1.02),
}
FORCE = (1e-5, -2e-5)


def _start(m, seed=0):
    """A perturbed equilibrium on the fluid (numpy, f64): rho in
    [0.97, 1.03], |u| <= 0.02."""
    rng = np.random.default_rng(seed)
    shape = m.geo.shape
    rho = rng.uniform(0.97, 1.03, shape)
    u = tuple(jnp.asarray(rng.uniform(-0.02, 0.02, shape)) for _ in range(2))
    return np.asarray(jeq.feq_quadratic(D2Q9, jnp.asarray(rho), u)) * \
        m.geo.is_fluid


def _pair(collision, bc, force, dtype=jnp.float64, **kw):
    g = _geometry()
    mj = jsp.SinglePhaseD2Q9(g, tau=0.8, collision=collision,
                             body_force=FORCE if force else (0.0, 0.0),
                             boundaries=BCS[bc], dtype=dtype, **kw)
    tdt = torch.float64 if dtype == jnp.float64 else torch.float32
    mt = SinglePhaseD2Q9(g, **single_phase_args_from_jax(mj), dtype=tdt,
                         device=CPU, **{k: v for k, v in kw.items()
                                        if k == "moving_wall_mask"})
    return mj, mt


@pytest.mark.parametrize("force", [True, False], ids=["force", "no_force"])
@pytest.mark.parametrize("bc", sorted(BCS))
@pytest.mark.parametrize("collision", ["SRT", "TRT", "MRT"])
def test_plain_step_matches_jax_f64(collision, bc, force):
    """20 f64 steps of the port's step (the plain path on the CPU) against
    the jitted jnp step from a common perturbed start: 1e-12."""
    mj, mt = _pair(collision, bc, force)
    assert mt.path == "plain" and takes_kernel(mt.bcs, False)
    f0 = _start(mt)
    a, b = jnp.asarray(f0), _t(f0)
    jstep = jax.jit(mj._step_impl)
    for _ in range(20):
        a, b = jstep(a), mt.step(b)
    assert bool(torch.isfinite(b).all())
    _close(b, a, 1e-12)


def test_moving_wall_cavity_matches_jax_f64():
    """tests/test_single_phase.py's lid-driven cavity (top solid row moving
    at u = 0.1) at 24^2, 20 f64 steps: 1e-12; the model keeps the plain
    path (K7 has no moving wall)."""
    n = 24
    solid = np.zeros((n + 2, n + 2), bool)
    solid[0, :] = solid[-1, :] = solid[:, 0] = solid[:, -1] = True
    moving = np.zeros_like(solid)
    moving[-1, :] = True
    g = geo.from_solid_mask(solid)
    mj = jsp.SinglePhaseD2Q9(g, tau=0.68, moving_wall_mask=moving,
                             wall_velocity=(0.1, 0.0), dtype=jnp.float64)
    mt = SinglePhaseD2Q9(g, **single_phase_args_from_jax(mj),
                         moving_wall_mask=moving, dtype=torch.float64,
                         device=CPU)
    assert mt.upwind_moving is not None and not takes_kernel(mt.bcs, True)
    a, b = mj.init_state(1.0), mt.init_state(1.0)
    jstep = jax.jit(mj._step_impl)
    for _ in range(20):
        a, b = jstep(a), mt.step(b)
    _close(b, a, 1e-12)
    assert float(b[:, -2].abs().sum()) > 0


K7_CASES = [("SRT", "velocity_pressure", True), ("TRT", "periodic", True),
            ("MRT", "pressure_convective", True), ("MRT", "periodic", False),
            ("TRT", "velocity_pressure", False)]


@pytest.mark.parametrize("collision,bc,force", K7_CASES)
def test_plain_step_matches_jax_k7_interpret(collision, bc, force):
    """The kernel's plain version against the JAX fused kernel K7
    (``pallas/single.py`` in interpret mode, one step a call) over 4 f64
    steps from a common start: 1e-12 (the MRT source is folded into the
    relaxed moments there, added after the collision here)."""
    mj, mt = _pair(collision, bc, force)
    fused = jax.jit(mj.make_block_step(steps_per_call=1, interpret=True))
    f0 = _start(mt, seed=3)
    a, b = jnp.asarray(f0), _t(f0)
    for _ in range(4):
        a, b = fused(a), single_step_reference(b, mt)
    _close(b, a, 1e-12)


def test_bf16_storage_matches_k7_interpret():
    """The Zou-He velocity + pressure channel in bf16 storage: packing bit
    for bit against JAX, then one step of the plain bf16 version and of the
    JAX bf16 kernel (interpret) from a common bf16 state, both in f32
    arithmetic: every stored value within one bf16 ulp of the other and at
    most 1e-2 of them off at all (2.9e-3 measured: the kernel relaxes MRT
    in moment space, the plain path through the dense M^-1 S M, so their
    f32 results round apart more often than one formula's would)."""
    mj, _ = _pair("MRT", "velocity_pressure", True, dtype=jnp.float32)
    g = mj.geo
    mt = SinglePhaseD2Q9(g, **single_phase_args_from_jax(mj),
                         dtype=torch.float32, device=CPU, storage="bf16")
    bf = jax.jit(mj.make_block_step(steps_per_call=1, interpret=True,
                                    storage="bf16"))
    f = _start(mt, seed=5).astype(np.float32)
    h = np.asarray(mj.pack_state_bf16(jnp.asarray(f)))
    ht = mt.pack_state_bf16(_t(f))
    np.testing.assert_array_equal(ht.view(torch.int16).numpy(),
                                  h.view(np.int16))
    _close(mt.unpack_bf16(ht), mj.unpack_bf16(jnp.asarray(h)), 1e-7)
    want = state_from_numpy(np.asarray(bf(jnp.asarray(h))), CPU)
    got = single_step(ht, mt)
    assert got.dtype == torch.bfloat16 and got.shape == (11, *g.shape)
    r = compare_bf16_states(got, want, torch.from_numpy(g.is_fluid))
    assert r["excess"] <= 1.0 and r["share"] <= 1e-2, r


def test_pack_bf16_bit_for_bit_f64():
    """The f64 pack of a perturbed state equals JAX's bit for bit."""
    mj, mt = _pair("SRT", "periodic", False)
    f = _start(mt, seed=7)
    np.testing.assert_array_equal(
        mt.pack_state_bf16(_t(f)).view(torch.int16).numpy(),
        np.asarray(mj.pack_state_bf16(jnp.asarray(f))).view(np.int16))


def test_init_state_and_macro_match_jax():
    mj, mt = _pair("MRT", "periodic", True)
    a, b = mj.init_state(1.02, (0.01, -0.02)), mt.init_state(1.02,
                                                             (0.01, -0.02))
    _close(b, a, 1e-15)
    f = _start(mt, seed=2)
    _close(mt.macro(_t(f)), mj.macro(jnp.asarray(f)), 1e-14)
    assert mt.nu == mj.nu


def _basic_ini(tmp_path, edits):
    text = open(BASIC_INI).read()
    for old, new in edits.items():
        text, n = re.subn(rf"(?m)^{old}$", new, text)
        assert n == 1, old
    path = tmp_path / "basic.ini"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("edits", [
    {}, {"Type = .*": "Type = 'TRT'", "TimeInterval = .*": ""},
    {"Type = .*": "Type = 'Cumulant'", "gValue = .*": "gValue = 2.5e-6"}],
    ids=["shipped", "trt_default_interval", "unknown_collision"])
def test_load_basic_equals_jax(tmp_path, edits):
    path = _basic_ini(tmp_path, edits)
    got, want = tconfig.load_basic(path), jconfig.load_basic(path)
    assert got[0] == want[0] and got[1:3] == want[1:3]
    for a, b in zip(got[3:], want[3:]):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_paths_and_refusals():
    g = _geometry()
    m = SinglePhaseD2Q9(g, collision="MRT", boundaries=BoundaryConfig(
        inlet="zou_he_velocity", outlet="convective"), device=CPU)
    assert m.path == "plain" and m.kernel_params is None
    # the rows K7 takes, with a moving wall, and a kind outside them
    assert takes_kernel(m.bcs, False) and not takes_kernel(m.bcs, True)
    odd = BoundaryConfig(outlet="neumann")
    assert not takes_kernel(odd, False)
    with pytest.raises(ValueError, match="kernel layout"):
        SinglePhaseD2Q9(g, boundaries=odd, device=CPU, storage="bf16")
    with pytest.raises(ValueError, match="NaN"):
        SinglePhaseD2Q9(g, boundaries=BoundaryConfig(
            outlet="zou_he_pressure", outlet_density=0.0), device=CPU)
    with pytest.raises(ValueError, match="float32"):
        SinglePhaseD2Q9(g, dtype=torch.float64, device=CPU, storage="bf16")
    with pytest.raises(ValueError, match="collision"):
        SinglePhaseD2Q9(g, collision="BGK", device=CPU)
    # an outlet kind outside the row set applies no row, as in JAX
    mj = jsp.SinglePhaseD2Q9(g, boundaries=jsp.BoundaryConfig(
        outlet="neumann"), dtype=jnp.float64)
    mt = SinglePhaseD2Q9(g, **single_phase_args_from_jax(mj),
                         dtype=torch.float64, device=CPU)
    f = _start(mt, seed=4)
    _close(mt.step(_t(f)), jax.jit(mj._step_impl)(jnp.asarray(f)), 1e-12)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_sc_edm_mrt_poiseuille(package):
    """One fluid of ShanChenMCMP with edm forcing and MRT collision driven
    by a body force between two walls (tests/test_shanchen.py's
    _body_force_channel at 18 cells across): the profile within 2% of the
    analytic Poiseuille profile, the pair the JAX tests leave out."""
    nx, ny, fy, tau, steps = 18, 4, 1e-6, 1.0, 1500
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    g = geo.from_solid_mask(solid)
    p = js.ShanChenParams(g_matrix=((0.0,),), g_solid=(0.0,), tau=(tau,),
                          collision="MRT", body_force=(0.0, fy),
                          forcing="edm")
    if package == "jax":
        m = js.ShanChenMCMP(g, p, dtype=jnp.float64, use_pallas=False)
        f = m.init_state_layers((1.0,), (1.0,), invading_rows=0)
        step = jax.jit(lambda f: jax.lax.fori_loop(
            0, steps, lambda _, x: m._step_impl(x), f))
        _, (_, uy) = m.macro(step(f))
    else:
        m = ShanChenMCMP(g, params_from_jax(p), dtype=torch.float64,
                         device=CPU)
        f = m.init_state_layers((1.0,), (1.0,), invading_rows=0)
        for _ in range(steps):
            f = m.step(f)
        _, (_, uy) = m.macro(f)
    err = poiseuille_error(np.asarray(uy)[ny // 2], fy, (tau - 0.5) / 3.0)
    assert err < 0.02, err


def test_chip_faults_patches_one_k7_line():
    """chip_faults.py plants its K7 fault (the Guo source dropped from the
    MRT update of the f32 instance) by replacing one line of
    csrc/single2d.cuh, which must stay there exactly once; phase 31 (the
    Poiseuille profile, which MRT cannot reach without the source) must
    fail it."""
    import chip_faults
    header, line, fault, phases = chip_faults.CASES["K7 MRT f32"]
    with open(os.path.join(ROOT, "openlbmpm_torch", "csrc", header)) as f:
        assert f.read().count(line) == 1
    assert "sizeof(S) != 4" in fault and phases == ("31",)
