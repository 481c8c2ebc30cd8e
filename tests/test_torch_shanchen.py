"""The port's Shan-Chen family against the JAX package, on the CPU at f64.

* every new op against its jnp op on random fields (atol 1e-12);
* ``ShanChenMCMP.step`` against the jnp ``_step_impl``, jitted (to keep
  the file fast; the Shan-Chen step has no tie-break that XLA's
  reassociation could flip): 1e-12 for one step from a common state and
  1e-10 after 50 steps, in every case
  of ``chip_smoke.SC_CASES`` (SC SRT/MRT under periodic, Zou-He velocity /
  convective and Zou-He pressure rows, Peng-Robinson psi, three fluids, EFS
  iso-4/8/10 SRT/MRT, guo and edm forcing, the Chang rows, the true
  convective outlet, the moving wall); which cases take the kernel;
* the plain version of the kernel (``sc_step_reference``) against the JAX
  Pallas kernel in interpret mode: 1e-12 per step at f64, and in bf16
  storage within one bf16 rounding of each stored value (both compute in
  f32 there, so rounding to bf16 may fall either side);
* the golden file ``tests/golden/sc_mini.npz`` (1e-10);
* ``load_shanchen`` field by field, parameter conversion, bf16 packing,
  the zero-target refusal and the D-I swap.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (SC4_CASES, SC_CASES, SC_KERNEL_CASES, WALL_VELOCITY,
                        sc_rho0, sc_solid)
from openlbmpm_tpu import checkpoint as jck
from openlbmpm_tpu import config as jconfig
from openlbmpm_tpu import geometry as geo
from openlbmpm_tpu.lattice import D2Q9, ISO_STENCILS
from openlbmpm_tpu.models import shanchen as js
from openlbmpm_tpu.ops import boundaries as jbc
from openlbmpm_tpu.ops import collision as jcol
from openlbmpm_tpu.ops import equilibrium as jeq
from openlbmpm_tpu.ops import forcing as jforce
from openlbmpm_tpu.ops import macroscopic as jmac
from openlbmpm_tpu.ops import shanchen as jsc
from openlbmpm_tpu.ops import streaming as jst
from openlbmpm_tpu.pallas.shanchen import _sc_geo_stack, build_sc_fused_step
from openlbmpm_torch import checkpoint as tck
from openlbmpm_torch import config as tconfig
from openlbmpm_torch.convert import (params_from_jax, state_from_numpy,
                                     state_to_numpy)
from openlbmpm_torch.kernels.csf import compare_bf16_states
from openlbmpm_torch.kernels.shanchen import (KMAX, fluid_table, geo_stack,
                                              kernel_params, sc_block_step,
                                              sc_step, sc_step_reference)
from openlbmpm_torch.models.shanchen import (SCBoundaryConfig, ShanChenMCMP,
                                             ShanChenParams, takes_kernel)
from openlbmpm_torch.ops import boundaries as tbc
from openlbmpm_torch.ops import collision as tcol
from openlbmpm_torch.ops import equilibrium as teq
from openlbmpm_torch.ops import forcing as tforce
from openlbmpm_torch.ops import macroscopic as tmac
from openlbmpm_torch.ops import shanchen as tsc
from openlbmpm_torch.ops import streaming as tst

torch.set_num_threads(1)
CPU = "cpu"   # the port's models run on the card unless told otherwise

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, NY, NX = 2, 12, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=1e-12):
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _close(g, w, atol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


class Fields:
    """Random f64 inputs for both packages (numpy first)."""

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.f = rng.uniform(0.01, 0.2, (K, 9, NY, NX))
        self.f_old = rng.uniform(0.01, 0.2, (K, 9, NY, NX))
        self.rho = rng.uniform(0.02, 1.2, (K, NY, NX))
        self.rho[0, 0, :3] = 0.0
        self.ux, self.uy = rng.uniform(-0.05, 0.05, (2, K, NY, NX))
        self.fx, self.fy = rng.uniform(-1e-3, 1e-3, (2, K, NY, NX))
        solid = rng.random((NY, NX)) < 0.15
        solid[:, 0] = solid[:, -1] = True
        self.solid = solid
        self.psi = self.rho * ~solid
        self.g = np.array([[0.0, 3.6], [3.6, 0.0]])
        self.gs = np.array([-0.3, 0.4])
        self.tau = np.array([1.0, 0.7])
        self.mask = rng.random(NX) < 0.8
        self.vy_row = rng.uniform(-0.01, 0.01, NX)


F = Fields()


def test_psi_and_interaction_fields_equal_jax():
    rho = np.linspace(0.0, 0.3, 40).reshape(5, 8)
    _close(tsc.psi_identity(_t(rho)), jsc.psi_identity(jnp.asarray(rho)))
    _close(tsc.psi_peng_robinson(_t(rho)),
           jsc.psi_peng_robinson(jnp.asarray(rho)))
    kw = dict(temperature=0.05, coeff_b=3.0, c0=5.0)
    _close(tsc.psi_peng_robinson(_t(rho), **kw),
           jsc.psi_peng_robinson(jnp.asarray(rho), **kw))
    assert float(tsc.psi_peng_robinson(torch.zeros(1, dtype=torch.float64))) \
        == 0.0
    for order in (4, 8, 10):
        a = tsc.build_interaction_fields(F.solid, order)
        b = jsc.build_interaction_fields(F.solid, order)
        for name in ("adhesion", "adhesion_st", "fluid_vec"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("order", [0, 4, 8, 10])
def test_stencil_grad_and_forces_equal_jax(order):
    st = tsc.D2Q9_STENCIL if order == 0 else ISO_STENCILS[order]
    jst_ = jsc.IsoStencil(order=0, offsets=D2Q9.e[1:], weights=D2Q9.w[1:]) \
        if order == 0 else st
    _close(tsc.stencil_weighted_grad(_t(F.psi), st),
           jsc.stencil_weighted_grad(jnp.asarray(F.psi), jst_))
    if order == 0:
        fields = jsc.build_interaction_fields(F.solid, 4)
        _close(tsc.interaction_force_sc(_t(F.psi), F.g, F.gs, fields),
               jsc.interaction_force_sc(jnp.asarray(F.psi), F.g, F.gs, fields))
        return
    fields = jsc.build_interaction_fields(F.solid, order)
    _close(tsc.interaction_force_efs(_t(F.psi), F.g, F.gs, fields),
           jsc.interaction_force_efs(jnp.asarray(F.psi), F.g, F.gs, fields))


def test_macroscopic_collision_forcing_equal_jax():
    f, rho = _t(F.f), _t(F.rho)
    jf, jrho = jnp.asarray(F.f), jnp.asarray(F.rho)
    _close(tmac.sc_common_velocity(D2Q9, f, tmac.density(f, 2), F.tau),
           jmac.sc_common_velocity(D2Q9, jf, jmac.density(jf), F.tau))
    _close(tmac.pressure_sc(rho, F.g), jmac.pressure_sc(jrho, F.g))
    u = (_t(F.ux), _t(F.uy))
    ju = (jnp.asarray(F.ux), jnp.asarray(F.uy))
    feq = teq.feq_quadratic(D2Q9, rho, u)
    _close(feq, jeq.feq_quadratic(D2Q9, jrho, ju))
    force, jforce_ = (_t(F.fx), _t(F.fy)), (jnp.asarray(F.fx),
                                            jnp.asarray(F.fy))
    _close(tforce.guo_source(D2Q9, u, force),
           jforce.guo_source(D2Q9, ju, jforce_))
    _close(tforce.efs_force_pdf(D2Q9, feq, rho, u, force),
           jforce.efs_force_pdf(D2Q9, jnp.asarray(feq.numpy()), jrho, ju,
                                jforce_))
    s = tcol.mrt_relaxation_d2q9_sc(0.7)
    np.testing.assert_array_equal(s, jcol.mrt_relaxation_d2q9_sc(0.7))
    _close(tcol.mrt(f[0], _t(F.f_old[0]), D2Q9, s),
           jcol.mrt(jf[0], jnp.asarray(F.f_old[0]), D2Q9, s))
    _close(tcol.mrt_force_transform(f[1], D2Q9, s),
           jcol.mrt_force_transform(jf[1], D2Q9, s))


def test_boundary_rows_equal_jax():
    """The per-fluid rows on the (K, 9, ny, nx) stack, targets (K, 1)."""
    f, fo = _t(F.f), _t(F.f_old)
    jf, jfo = jnp.asarray(F.f), jnp.asarray(F.f_old)
    m, jm = torch.from_numpy(F.mask), jnp.asarray(F.mask)
    v = np.array([[-1e-3], [2e-3]])
    rt = np.array([[1.02], [0.03]])
    got, rho = tbc.zou_he_velocity_top(f, _t(v), NY - 2, m)
    want, jrho = jbc.zou_he_velocity_top(jf, jnp.asarray(v), NY - 2, jm)
    _close((got, rho), (want, jrho))
    _close(tbc.zou_he_pressure_top(f, _t(rt), NY - 3, m),
           jbc.zou_he_pressure_top(jf, jnp.asarray(rt), NY - 3, jm))
    _close(tbc.zou_he_pressure_bottom(f, _t(rt), 2, m),
           jbc.zou_he_pressure_bottom(jf, jnp.asarray(rt), 2, jm))
    _close(tbc.chang_velocity_top(f, fo, _t(v), NY - 2, m),
           jbc.chang_velocity_top(jf, jfo, jnp.asarray(v), NY - 2, jm))
    frac = F.f[:, :, 1, :].sum(1) * 0.9
    frac[0, :2] = 0.0
    _close(tbc.chang_pressure_top(f, fo, _t(frac), NY - 2, m),
           jbc.chang_pressure_top(jf, jfo, jnp.asarray(frac), NY - 2, jm))
    _close(tbc.chang_pressure_bottom(f, fo, _t(frac), 1, m),
           jbc.chang_pressure_bottom(jf, jfo, jnp.asarray(frac), 1, jm))
    rows = (3, 2, 1, 0)
    masks = tuple(m for _ in rows)
    _close(tbc.copy_rows_from_above(f, rows, masks),
           jbc.copy_rows_from_above(jf, rows, tuple(jm for _ in rows)))
    _close(tbc.convective_outlet_rows(f, fo, _t(F.vy_row), rows, masks),
           jbc.convective_outlet_rows(jf, jfo, jnp.asarray(F.vy_row), rows,
                                      tuple(jm for _ in rows)))


def test_stream_moving_wall_equals_jax():
    moving = F.solid & (np.arange(NX) > NX // 2)
    up = st = jst.upwind_solid_masks(D2Q9, F.solid)
    upm = jst.upwind_solid_masks(D2Q9, moving)
    for mv in (None, upm):
        _close(tst.stream_moving_wall(
            _t(F.f), D2Q9, torch.from_numpy(up), _t(F.rho), (0.05, -0.02),
            None if mv is None else torch.from_numpy(mv)),
            jst.stream_moving_wall(jnp.asarray(F.f), D2Q9, jnp.asarray(st),
                                   jnp.asarray(F.rho), (0.05, -0.02),
                                   None if mv is None else jnp.asarray(mv)))


# -- the model --------------------------------------------------------------

def _models(name, ny=32, nx=24, use_pallas=False, dtype=jnp.float64):
    """(JAX model, port model, the common f64 initial state) of a case of
    SC_CASES or SC4_CASES."""
    p, b, init = (SC_CASES | SC4_CASES)[name]
    solid, moving = sc_solid(ny, nx, init)
    g = geo.from_solid_mask(solid)
    jp, jb = js.ShanChenParams(**p), js.SCBoundaryConfig(**b)
    mj = js.ShanChenMCMP(g, jp, jb, dtype=dtype, use_pallas=use_pallas,
                         moving_wall_mask=moving, wall_velocity=WALL_VELOCITY)
    mt = ShanChenMCMP(g, params_from_jax(jp), params_from_jax(jb),
                      dtype=torch.float64, device=CPU,
                      moving_wall_mask=moving, wall_velocity=WALL_VELOCITY)
    f0 = np.asarray(mj._feq_init(jnp.asarray(
        sc_rho0(mj.k, ny, nx, init) * g.is_fluid, dtype)))
    return mj, mt, f0


@pytest.mark.parametrize("name", sorted(SC_CASES))
def test_step_matches_jax_step(name):
    """One step from a common state to 1e-12, then 50 steps of each
    package on its own to 1e-10.  The kernel cases take the kernel on a
    card, the others (which the JAX package too keeps on its jnp path) do
    not; on the CPU every case runs the plain step."""
    mj, mt, f0 = _models(name)
    assert takes_kernel(mt.p, mt.bcs, mt.upwind_moving is not None) == \
        (name in SC_KERNEL_CASES)
    assert mt.path == "plain"
    step = jax.jit(mj._step_impl)
    a, b = jnp.asarray(f0), _t(f0)
    _close(mt.step(b), step(a))
    for _ in range(50):
        a, b = step(a), mt.step(b)
    assert bool(torch.isfinite(b).all())
    _close(b, a, atol=1e-10)


def test_macro_and_pressure_match_jax():
    mj, mt, f0 = _models("sc_srt_velocity_convective")
    rho_j, u_j = mj.macro(jnp.asarray(f0))
    rho_t, u_t = mt.macro(_t(f0))
    _close((rho_t, *u_t), (rho_j, *u_j))
    _close(mt.pressure(rho_t), mj.pressure(rho_j))


@pytest.mark.parametrize("name", SC_KERNEL_CASES)
def test_plain_kernel_version_matches_pallas_interpret(name):
    """``sc_step_reference`` (on a CPU state: ``sc_step`` itself) against
    build_sc_fused_step in interpret mode, two steps from a common state
    at f64, 1e-12.  The kernel parameter block and geometry planes take
    the configuration."""
    mj, mt, f0 = _models(name)
    fused = build_sc_fused_step(mj.geo, mj.p, jnp.float64, rows_per_block=16,
                                bc_config=mj.bcs, interpret=True)
    assert fused is not None
    a, b = fused(jnp.asarray(f0)), sc_step_reference(_t(f0), mt)
    _close(b, a)
    _close(sc_step(b, mt), fused(a))
    kp = kernel_params(mt.p, mt.bcs, mt.geo)
    assert (kp.k, kp.depth) == (mt.k, mt._bc_depth)
    np.testing.assert_allclose(geo_stack(mt.geo, mt.p),
                               _sc_geo_stack(mj.geo, mj.p), rtol=0,
                               atol=1e-15)


@pytest.mark.parametrize("name", ["sc4_mrt_velocity_convective",
                                  "efs4_4f_velocity_pressure"])
def test_four_fluids_plain_matches_pallas_interpret(name):
    """Four fluids, which the kernel runs on its runtime-K instance: the
    plain version against build_sc_fused_step in interpret mode (which takes
    any number of fluids), two steps from a common state at f64, 1e-12.
    ``takes_kernel`` says kernel; ``kernel_params`` builds with k = 4 and
    the per-fluid arrays left to ``fluid_table``, which holds tau, 1/tau,
    G_s, the inlet and outlet targets and G."""
    mj, mt, f0 = _models(name)
    assert mt.k == 4 > KMAX
    fused = build_sc_fused_step(mj.geo, mj.p, jnp.float64, rows_per_block=16,
                                bc_config=mj.bcs, interpret=True)
    assert fused is not None
    a, b = fused(jnp.asarray(f0)), sc_step_reference(_t(f0), mt)
    _close(b, a)
    _close(sc_step(b, mt), fused(a))
    _close(sc_block_step(_t(f0), mt, 2), fused(a))
    assert takes_kernel(mt.p, mt.bcs, False, mt.geo.shape)
    kp = kernel_params(mt.p, mt.bcs, mt.geo)
    assert (kp.k, kp.depth) == (4, mt._bc_depth) and list(kp.tau) == [1.0] * 3
    tab = fluid_table(mt.p, mt.bcs)
    k = mt.k
    np.testing.assert_array_equal(tab[:k], mt.tau)
    np.testing.assert_array_equal(tab[k:2 * k], 1.0 / mt.tau)
    np.testing.assert_array_equal(tab[2 * k:3 * k], mt.g_solid)
    np.testing.assert_array_equal(
        tab[3 * k:6 * k].reshape(3, k), np.stack([
            mt.inlet_velocity[:, 0].numpy(), mt.inlet_density[:, 0].numpy(),
            mt.outlet_density[:, 0].numpy()]))
    np.testing.assert_array_equal(tab[6 * k:].reshape(k, k), mt.g_matrix)


def test_small_domain_runs_plain_as_jax():
    """Below 8 x 3 the JAX fused builder builds nothing (no strip of 8
    rows) and the JAX model runs jnp; ``takes_kernel`` says no for that
    shape, so the model's path is plain on every device and it has no
    T-step form; 8 x 3 takes the kernel."""
    p, b, _ = SC_CASES["sc_srt_periodic_body_force"]
    g = geo.from_solid_mask(np.zeros((6, 24), bool))
    jp, jb = js.ShanChenParams(**p), js.SCBoundaryConfig(**b)
    assert build_sc_fused_step(g, jp, jnp.float64, bc_config=jb,
                               interpret=True) is None
    mt = ShanChenMCMP(g, params_from_jax(jp), params_from_jax(jb),
                      dtype=torch.float64, device=CPU)
    assert not takes_kernel(mt.p, mt.bcs, False, g.shape)
    assert mt.path == "plain" and mt.make_block_step(2) is None
    assert takes_kernel(mt.p, mt.bcs, False, (8, 3))
    assert not takes_kernel(mt.p, mt.bcs, False, (8, 2))


def test_bf16_storage_matches_pallas_interpret():
    """test_pallas_sc.py's bf16 setup (Zou-He velocity inlet, convective
    outlet, walled 32^2): packing bit for bit, then one step of the plain
    bf16 version and of the Pallas bf16 kernel (interpret) from a common
    bf16 state, both in f32 arithmetic: every stored value within one bf16
    ulp of the other and at most 1e-3 of them off at all."""
    n = 32
    solid = np.zeros((n, n), bool)
    solid[:, 0] = solid[:, -1] = True
    jb = js.SCBoundaryConfig(inlet="zou_he_velocity", outlet="convective",
                             inlet_velocity=(-1e-3, 0.0),
                             outlet_density=(0.02, 1.0))
    jp = js.ShanChenParams(g_matrix=((0.0, 3.6), (3.6, 0.0)),
                           g_solid=(-0.3, 0.3), tau=(1.0, 1.0))
    g = geo.from_solid_mask(solid)
    mj = js.ShanChenMCMP(g, jp, jb, dtype=jnp.float32, use_pallas=False)
    mt = ShanChenMCMP(g, params_from_jax(jp), params_from_jax(jb),
                      dtype=torch.float32, device=CPU, storage="bf16")
    bf = mj.make_block_step(steps_per_call=1, rows_per_block=8,
                            interpret=True, storage="bf16")
    m32 = ShanChenMCMP(g, params_from_jax(jp), params_from_jax(jb),
                       dtype=torch.float32, device=CPU)
    f = m32.init_state_layers((1.0, 1.0), (0.02, 0.02), invading_rows=8)
    for _ in range(5):       # off the sharp initial layers
        f = m32.step(f)
    f = jnp.asarray(f.numpy())
    h = np.asarray(mj.pack_state_bf16(f))
    ht = mt.pack_state_bf16(_t(np.asarray(f)))
    np.testing.assert_array_equal(ht.view(torch.int16).numpy(),
                                  h.view(np.int16))
    _close(mt.unpack_bf16(ht), mj.unpack_bf16(jnp.asarray(h)), atol=1e-7)
    want = state_from_numpy(np.asarray(bf(jnp.asarray(h))), CPU)
    got = sc_step(ht, mt)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 11, n, n)
    fluid = torch.from_numpy(g.is_fluid)
    for k in range(2):
        r = compare_bf16_states(got[k], want[k], fluid)
        assert r["excess"] <= 1.0 and r["share"] <= 1e-3, r


def test_golden_sc_mini():
    """tests/test_golden.py::test_golden_sc_mini's setup through the port
    (1e-10 against the committed rho)."""
    solid = np.zeros((48, 24), bool)
    solid[:, 0] = solid[:, -1] = True
    p = ShanChenParams(g_matrix=((0.0, 3.6), (3.6, 0.0)),
                       g_solid=(-0.3, 0.3), tau=(1.0, 1.0))
    m = ShanChenMCMP(geo.from_solid_mask(solid), p, dtype=torch.float64,
                     device=CPU)
    f = m.init_state_droplet((1.0, 1.0), (0.02, 0.02), center=(24, 12),
                             radius=7.0)
    for _ in range(50):
        f = m.step(f)
    with np.load(os.path.join(ROOT, "tests", "golden", "sc_mini.npz")) as z:
        np.testing.assert_allclose(f.sum(1).numpy(), z["rho"], rtol=0,
                                   atol=1e-10)


def test_init_states_and_bf16_roundtrip_match_jax():
    mj, mt, _ = _models("sc_srt_velocity_convective")
    _close(mt.init_state_layers((1.0, 1.0), (0.02, 0.02), invading_rows=7),
           mj.init_state_layers((1.0, 1.0), (0.02, 0.02), invading_rows=7))
    _close(mt.init_state_droplet((1.0, 0.9), (0.02, 0.03), center=(9, 11),
                                 radius=5.0),
           mj.init_state_droplet((1.0, 0.9), (0.02, 0.03), center=(9, 11),
                                 radius=5.0))


def test_zero_pressure_target_refused():
    """A Zou-He pressure target of 0 has no reference (jnp: NaN; Pallas:
    divides by 1): the port refuses it in the constructor and names both;
    the JAX jnp step shows the NaN."""
    p = ShanChenParams(**SC_CASES["sc_srt_pressure_pressure"][0])
    g = geo.from_solid_mask(sc_solid(32, 24, "layers")[0])
    for b in (SCBoundaryConfig(inlet="zou_he_pressure",
                               inlet_density=(1.0, 0.0)),
              SCBoundaryConfig(outlet="zou_he_pressure",
                               outlet_density=(0.0,))):
        with pytest.raises(ValueError, match="NaN.*rho or 1.0"):
            ShanChenMCMP(g, p, b, dtype=torch.float64, device=CPU)
    jp = js.ShanChenParams(**SC_CASES["sc_srt_pressure_pressure"][0])
    mj = js.ShanChenMCMP(g, jp, js.SCBoundaryConfig(
        inlet="zou_he_pressure", inlet_density=(1.0, 0.0)),
        dtype=jnp.float64, use_pallas=False)
    f = mj.init_state_layers((1.0, 1.0), (0.02, 0.02), invading_rows=8)
    assert not bool(jnp.isfinite(mj._step_impl(f)).all())


def test_options_refused_and_cuda_default():
    p = ShanChenParams(**SC_CASES["sc_srt_periodic_body_force"][0])
    g = geo.from_solid_mask(sc_solid(32, 24, "layers")[0])
    with pytest.raises(ValueError, match="guo"):
        ShanChenMCMP(g, dataclasses.replace(p, scheme="EFS", forcing="guo"),
                     device=CPU)
    with pytest.raises(ValueError, match="Chang"):
        ShanChenMCMP(g, dataclasses.replace(p, scheme="EFS"),
                     SCBoundaryConfig(inlet="chang_velocity"), device=CPU)
    with pytest.raises(ValueError, match="kernel layout"):
        ShanChenMCMP(g, dataclasses.replace(p, forcing="edm"), device=CPU,
                     storage="bf16")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ShanChenMCMP(g, p)


def test_params_and_states_cross_from_jax():
    for name in SC_CASES:
        p, b, _ = SC_CASES[name]
        for cls_j, cls_t, kw in ((js.ShanChenParams, ShanChenParams, p),
                                 (js.SCBoundaryConfig, SCBoundaryConfig, b)):
            got = params_from_jax(cls_j(**kw))
            assert type(got) is cls_t
            assert dataclasses.asdict(got) == dataclasses.asdict(cls_j(**kw))
    pr = js.ShanChenParams(g_matrix=((-1.0,),), g_solid=(0.0,), tau=(1.0,),
                           psi="PR", pr_params=(("temperature", 0.05),))
    assert params_from_jax(pr).pr_params == (("temperature", 0.05),)
    rng = np.random.default_rng(3)
    f = rng.uniform(0, 0.2, (3, 9, 12, 10))
    back = state_to_numpy(state_from_numpy(f, CPU))
    np.testing.assert_array_equal(back, f)
    mj, mt, f0 = _models("sc_srt_velocity_convective")
    h = np.asarray(mj.pack_state_bf16(jnp.asarray(f0, jnp.float32)))
    hb = state_to_numpy(state_from_numpy(h, CPU))
    np.testing.assert_array_equal(hb.view(np.uint8), h.view(np.uint8))


def test_di_cycle_swap_sc_equals_jax():
    f = np.random.default_rng(5).uniform(0, 1, (3, 9, 12, 10))
    _close(tck.di_cycle_swap_sc(_t(f), buffer_rows=4),
           jck.di_cycle_swap_sc(jnp.asarray(f), buffer_rows=4), atol=0)
    _close(tck.di_cycle_swap_sc(_t(f), buffer_rows=3, top=False),
           jck.di_cycle_swap_sc(jnp.asarray(f), buffer_rows=3, top=False),
           atol=0)


def _sc_ini(tmp_path, edits, physics="shanchen2D.ini", phys_edits=None):
    """twophasesetup.ini (and a physics INI beside it) with the lines
    matching each regex key of `edits` replaced."""
    out = []
    for src, ed in (("twophasesetup.ini", edits),
                    (physics, phys_edits or {})):
        text = open(os.path.join(ROOT, "configs", src)).read()
        for old, new in ed.items():
            text, n = re.subn(rf"(?m)^{old}$", new, text)
            assert n == 1, old
        (tmp_path / src).write_text(text)
        out.append(str(tmp_path / src))
    return out


SC_INI_VARIANTS = {
    "shipped_sc": ({}, "shanchen2D.ini", {}),
    "shipped_efs": ({"InteractionType = .*": "InteractionType = 'EFS'"},
                    "efs2D.ini", {}),
    "efs_iso8_mrt": ({"InteractionType = .*": "InteractionType = 'EFS'",
                      "Type = .*": "Type = 'MRT'"}, "efs2D.ini",
                     {"ExplicitScheme = .*": "ExplicitScheme = 8"}),
    "chang_guo_pr_three": (
        {"NumberOfFluids = .*": "NumberOfFluids = 3"}, "shanchen2D.ini",
        {"BoundaryTypeOutlet = .*": "BoundaryTypeOutlet = 'Dirichlet'\n"
                                    "BoundaryMethod = 'Chang'",
         "potentialType = .*": "potentialType = 'PR'",
         "Option = .*": "Option = 'yes'",
         "numberTimeStep = .*": "numberTimeStep = 10000\n[ForceScheme]\n"
                                "ForcingMethod = 'Guo'"}),
}


@pytest.mark.parametrize("variant", sorted(SC_INI_VARIANTS))
def test_load_shanchen_equals_jax(tmp_path, variant):
    edits, physics, phys_edits = SC_INI_VARIANTS[variant]
    main, phys = _sc_ini(tmp_path, edits, physics, phys_edits)
    for args in ((main, phys), (main,)):
        got = tconfig.load_shanchen(*args)
        want = jconfig.load_shanchen(*args)
        for a, b in zip(got[:4], want[:4]):
            assert type(a).__name__ == type(b).__name__
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert got[4] == want[4]
        assert tck.config_fingerprint(got[0]) == \
            jck.config_fingerprint(want[0])


def test_load_shanchen_refuses_unknown_forcing(tmp_path):
    """The JAX reader falls back to 'shift' on an unknown ForcingMethod
    without a word; the port's reader raises."""
    main, phys = _sc_ini(tmp_path, {}, "shanchen2D.ini", {
        "numberTimeStep = .*": "numberTimeStep = 10\n[ForceScheme]\n"
                               "ForcingMethod = 'Exact'"})
    assert jconfig.load_shanchen(main, phys)[0].forcing == "shift"
    with pytest.raises(ValueError, match="ForcingMethod"):
        tconfig.load_shanchen(main, phys)
