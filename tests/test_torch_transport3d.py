"""The port's coupled 3-D flow + D3Q7 tracer transport (models/flow3d.py:
``TransportD3Q7``, ``TransportRK3D``; kernels/cg3d.py's coupled wrapper)
against the JAX package, on the CPU, at f64 unless said otherwise.

* the ops: the 3-D ``feq_transport_j`` against the jnp op (1e-12), the 3-D
  ``interface_bounce_back`` against the jnp six-axis loop of
  ``TransportD3Q7._step_impl`` on random masks (1e-15), the 2-D forms equal
  to the jnp ops;
* ``TransportD3Q7``: init_state, concentration, diffusivity; the flow-free
  and the (u, rho_r, bounce-back) steps against JAX's (1e-12 a step, 1e-10
  after 50); the Gaussian diffusivity and the confinement of
  tests/test_flow3d.py;
* ``TransportRK3D.plain_step`` against ``TransportRK3D._step_impl`` in every
  case of ``chip_smoke.CG3D_TRANSPORT_CASES`` at 16^3 (1e-12 a step, 1e-10
  after 50), and test_flow3d's coupled confinement and masses;
* ``plain_step_c`` against the Pallas coupled kernel in interpret mode at
  tests/test_pallas_sc3d.py's setup (2 steps, 1e-11), and its bf16 form
  against the Pallas bf16 coupled kernel within
  ``test_coupled3d_bf16_storage_tracks_f32``'s bounds;
* arguments and states crossing from JAX; the properties of the reference
  that ROADMAP section 3 records.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import CG3D_TRANSPORT_CASES, tracer_start, transport3d_case
from openlbmpm_tpu import geometry as jgeo
from openlbmpm_tpu.lattice import D2Q5 as JD2Q5
from openlbmpm_tpu.lattice import D3Q7 as JD3Q7
from openlbmpm_tpu.models import flow3d as jf
from openlbmpm_tpu.ops import common as jcommon
from openlbmpm_tpu.ops import equilibrium as jeq
from openlbmpm_tpu.ops import transport as jtr
from openlbmpm_tpu.pallas.cg3d import build_cg3d_fused_step
from openlbmpm_torch.convert import (state_from_numpy, state_to_numpy,
                                     transport3d_args_from_jax)
from openlbmpm_torch.geometry import from_solid_mask
from openlbmpm_torch.kernels import cg3d as K
from openlbmpm_torch.lattice import D2Q5, D3Q7
from openlbmpm_torch.models.flow3d import (CG3DBoundaryConfig,
                                           ColorGradientParams3D,
                                           TransportD3Q7, TransportRK3D)
from openlbmpm_torch.ops import equilibrium as teq
from openlbmpm_torch.ops import transport as ttr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

CPU = "cpu"   # the port's models run on the card unless told otherwise
SHAPE = (16, 16, 16)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _gap(a, b):
    return max(float(np.abs(_np(x) - _np(y)).max()) for x, y in zip(a, b))


def _jax_model(m, dtype=jnp.float64):
    """The JAX package's TransportRK3D on the port model's geometry,
    parameters and tracers (jnp steps)."""
    t = m.transport
    return jf.TransportRK3D(
        jgeo.from_solid_mask(m.geo.is_solid),
        jf.ColorGradientParams3D(**dataclasses.asdict(m.flow.p)),
        num_tracers=t.num_tracers, tau=tuple(t.tau),
        j0=tuple(t.j_coeffs[:, 0]), criteria=t.criteria,
        interface_mode=t.interface_mode, dtype=dtype,
        boundaries=jf.CG3DBoundaryConfig(**dataclasses.asdict(m.flow.bcs)))


def _jax_bounce_back(g, dom):
    """The hard interface loop of ``TransportD3Q7._step_impl`` (:730-741),
    in jnp, in place over the six axes."""
    lat = JD3Q7
    for i in range(1, 7):
        dx, dy, dz = (int(lat.e[i, d]) for d in range(3))
        opp = int(lat.opp[i])
        nbr_out = jnp.logical_and(dom, ~jcommon.shift(dom, dx, dy, dz))
        leaked = jcommon.shift(g[:, i], dx, dy, dz)
        g = g.at[:, opp].set(jnp.where(nbr_out[None], leaked, g[:, opp]))
        recv = jnp.logical_and(~dom, jcommon.shift(dom, -dx, -dy, -dz))
        g = g.at[:, i].set(jnp.where(recv[None], 0.0, g[:, i]))
    return g


# -- the ops -------------------------------------------------------------------

def test_feq_transport_j_3d_matches_jnp():
    rng = np.random.default_rng(0)
    conc = rng.uniform(0.0, 1.0, (2, 6, 5, 4))
    u = rng.uniform(-0.05, 0.05, (3, 2, 6, 5, 4))
    j = np.array([0.25] + [0.125] * 6)
    got = teq.feq_transport_j(D3Q7, torch.from_numpy(conc),
                              tuple(torch.from_numpy(c) for c in u), j)
    want = jeq.feq_transport_j(JD3Q7, jnp.asarray(conc),
                               tuple(jnp.asarray(c) for c in u), j)
    assert tuple(got.shape) == (2, 7, 6, 5, 4)
    assert _gap([got], [want]) <= 1e-12


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interface_bounce_back_3d_matches_the_jnp_loop(seed):
    """Random masks (isolated cells, wrap-around) on an uneven shape: the
    port's gather from the unrepaired PDFs equals the in-place loop."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.0, 1.0, (2, 7, 7, 6, 5))
    dom = rng.random((7, 6, 5)) < 0.5
    got = ttr.interface_bounce_back(torch.from_numpy(g),
                                    torch.from_numpy(dom), D3Q7)
    want = _jax_bounce_back(jnp.asarray(g), jnp.asarray(dom))
    assert _gap([got], [want]) <= 1e-15


def test_2d_forms_equal_the_jnp_ops():
    """The 2-D callers of the generalised ops see the jnp ops' values."""
    rng = np.random.default_rng(3)
    conc = rng.uniform(0.0, 1.0, (2, 9, 7))
    u = rng.uniform(-0.05, 0.05, (2, 2, 9, 7))
    j = np.array([1 / 3] + [1 / 6] * 4)
    got = teq.feq_transport_j(D2Q5, torch.from_numpy(conc[0]),
                              tuple(torch.from_numpy(c[0]) for c in u), j)
    want = jeq.feq_transport_j(JD2Q5, jnp.asarray(conc[0]),
                               tuple(jnp.asarray(c[0]) for c in u), j)
    assert tuple(got.shape) == (5, 9, 7) and _gap([got], [want]) <= 1e-15
    g = rng.uniform(0.0, 1.0, (2, 5, 9, 7))
    dom = rng.random((9, 7)) < 0.5
    got = ttr.interface_bounce_back(torch.from_numpy(g),
                                    torch.from_numpy(dom), D2Q5)
    want = jtr.interface_bounce_back(jnp.asarray(g), jnp.asarray(dom), JD2Q5)
    assert _gap([got], [want]) == 0.0


# -- TransportD3Q7 -------------------------------------------------------------

def _d3q7_pair(n=12, walls=True, **kw):
    solid = np.zeros((n, n, n), bool)
    if walls:
        solid[:, 0, :] = solid[:, -1, :] = True
    args = dict(num_tracers=2, tau=(1.0, 0.7), j0=(0.25, 0.4)) | kw
    return (TransportD3Q7(from_solid_mask(solid), dtype=torch.float64,
                          device=CPU, **args),
            jf.TransportD3Q7(jgeo.from_solid_mask(solid), dtype=jnp.float64,
                             **args))


def test_d3q7_init_concentration_diffusivity_equal_jax():
    m, jm = _d3q7_pair()
    conc0 = np.random.default_rng(4).uniform(0.0, 1.0, (2, 12, 12, 12))
    g, jg = m.init_state(conc0), jm.init_state(conc0)
    assert _gap([g], [jg]) == 0.0
    assert _gap([m.concentration(g)], [jm.concentration(jg)]) <= 1e-15
    assert [m.diffusivity(t) for t in (0, 1)] == \
        [jm.diffusivity(t) for t in (0, 1)]
    np.testing.assert_array_equal(m.j_coeffs, jm.j_coeffs)


@pytest.mark.parametrize("coupled", [False, True])
def test_d3q7_step_matches_jax(coupled):
    """Flow-free (u = 0), or on a fixed random u with a random rho_r and
    the bounce-back interface: 1e-12 a step, 1e-10 after 50."""
    m, jm = _d3q7_pair(interface_mode="bounceback" if coupled else "none")
    rng = np.random.default_rng(5)
    conc0 = rng.uniform(0.0, 1.0, (2, 12, 12, 12))
    g, jg = m.init_state(conc0), jm.init_state(conc0)
    u = rng.uniform(-0.02, 0.02, (3, 12, 12, 12))
    rho_r = rng.uniform(0.0, 1.0, (12, 12, 12))
    tu = tuple(torch.from_numpy(c) for c in u) if coupled else None
    ju = tuple(jnp.asarray(c) for c in u) if coupled else None
    tr_ = torch.from_numpy(rho_r) if coupled else None
    jr = jnp.asarray(rho_r) if coupled else None
    for k in range(50):
        g, jg = m.step(g, tu, tr_), jm.step(jg, ju, jr)
        if k == 0:
            assert _gap([g], [jg]) <= 1e-12
    assert _gap([g], [jg]) <= 1e-10


def test_d3q7_diffusion_gaussian():
    """tests/test_flow3d.py::test_d3q7_diffusion_gaussian on the port: the
    measured diffusivity within 3% of (1 - j0)/3 (tau - 1/2), the mass to
    1e-12."""
    n, steps = 40, 150
    m = TransportD3Q7(from_solid_mask(np.zeros((n, n, n), bool)),
                      num_tracers=1, tau=(1.0,), j0=(0.25,),
                      dtype=torch.float64, device=CPU)
    zz, yy, xx = np.mgrid[0:n, 0:n, 0:n].astype(float)
    c = n / 2.0
    conc0 = np.exp(-((zz - c) ** 2 + (yy - c) ** 2 + (xx - c) ** 2) / 8.0)
    g = m.init_state(conc0[None])

    def var(ci, ax):
        t = ci.sum()
        grid = (zz, yy, xx)[ax]
        m1 = (ci * grid).sum() / t
        return (ci * (grid - m1) ** 2).sum() / t
    for _ in range(steps):
        g = m.step(g)
    conc = m.concentration(g)[0].numpy()
    for ax in range(3):
        d_meas = (var(conc, ax) - var(conc0, ax)) / (2 * steps)
        assert abs(d_meas - m.diffusivity()) / m.diffusivity() < 0.03, ax
    assert abs(conc.sum() - conc0.sum()) / conc0.sum() < 1e-12


def test_d3q7_interface_confinement():
    """tests/test_flow3d.py::test_d3q7_interface_confinement on the port: no
    tracer leaks into rho_r > 0.5 in 100 steps, the mass to 1e-12."""
    n = 20
    m = TransportD3Q7(from_solid_mask(np.zeros((n, n, n), bool)),
                      interface_mode="bounceback", dtype=torch.float64,
                      device=CPU)
    conc0 = np.zeros((1, n, n, n))
    conc0[0, 2:8] = 1.0
    g = m.init_state(conc0)
    rho_r = torch.from_numpy((np.mgrid[0:n, 0:n, 0:n][0] >= n // 2) * 1.0)
    zeros = torch.zeros((n, n, n), dtype=torch.float64)
    total0 = float(m.concentration(g).sum())
    for _ in range(100):
        g = m.step(g, (zeros, zeros, zeros), rho_r)
    conc = m.concentration(g)[0]
    assert float(conc[rho_r > 0.5].sum()) / total0 < 1e-10
    assert abs(float(conc.sum()) - total0) / total0 < 1e-12


# -- TransportRK3D --------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CG3D_TRANSPORT_CASES))
def test_plain_step_matches_jax_step(name):
    """50 split steps at 16^3 against the jnp ``_step_impl``.  The grain
    pack is held to the un-jitted step, as in tests/test_torch_cg3d.py
    (the jitted and un-jitted JAX steps part there)."""
    m, st = transport3d_case(name, CPU, shape=SHAPE)
    jm = _jax_model(m)
    js = tuple(jnp.asarray(_np(t)) for t in st)
    eager = name == "grain_pack"
    for k in range(50):
        st = m.step(st)
        if eager:
            with jax.disable_jit():
                js = jm._step_impl(js)
        else:
            js = jm.step(js)
        if k == 0:
            assert _gap(st, js) <= 1e-12, name
    assert all(bool(torch.isfinite(t).all()) for t in st)
    assert _gap(st, js) <= 1e-10, name


def test_coupled_confinement_and_masses():
    """tests/test_flow3d.py::test_coupled_3d_flow_transport on the port: 100
    steps of the open box, no tracer in rho_r > 0.5 (< 1e-10), tracer and
    red mass to 1e-12."""
    m, st = transport3d_case("periodic_box", CPU, shape=(20,) * 3)
    total0 = float(m.concentration(st[2]).sum())
    m_r0 = float(st[0].sum())
    for _ in range(100):
        st = m.step(st)
    conc = m.concentration(st[2])[0]
    rho_r = st[0].sum(0)
    assert float(conc[rho_r > 0.5].sum()) / total0 < 1e-10
    assert abs(float(conc.sum()) - total0) / total0 < 1e-12
    assert abs(float(st[0].sum()) - m_r0) / m_r0 < 1e-12


def _pallas_model(dtype=torch.float64, storage="f32"):
    """tests/test_pallas_sc3d.py's coupled setup: 16^3, walls on the y faces,
    velocity inlet, convective outlet, one bounce-back tracer at 1 in slabs
    2-5, red in the top 6 slabs."""
    solid = np.zeros((16, 16, 16), bool)
    solid[:, 0, :] = solid[:, -1, :] = True
    m = TransportRK3D(
        from_solid_mask(solid), ColorGradientParams3D(
            surface_tension=0.01, tau_r=1.0, tau_b=0.8,
            contact_angle_deg=60.0),
        boundaries=CG3DBoundaryConfig(inlet="velocity", outlet="convective",
                                      inlet_velocity=-1e-3),
        dtype=dtype, device=CPU, storage=storage)
    conc0 = np.zeros((1, 16, 16, 16))
    conc0[0, 2:6] = 1.0
    return m, m.init_state(m.flow.init_state_layers(1.0, 1.0,
                                                    invading_slabs=6), conc0)


def _pallas_step(m, dtype, storage="f32"):
    jm = _jax_model(m, dtype)
    step = build_cg3d_fused_step(
        jm.geo, jm.flow.p, dtype, slabs_per_block=16, steps_per_call=1,
        bc_config=jm.flow.bcs, state_mode="compressed",
        transport=jm.transport, interpret=True, storage=storage)
    assert step is not None
    return step


def test_plain_step_c_matches_pallas_coupled():
    """2 f64 compressed steps through ``coupled3d_step_compressed`` (the
    plain version for CPU tensors) against the Pallas coupled kernel in
    interpret mode: flow and tracers to 1e-11."""
    m, st = _pallas_model()
    fused = _pallas_step(m, jnp.float64)
    x = m.pack(st)
    jx = tuple(jnp.asarray(_np(t)) for t in x)
    for _ in range(2):
        x = K.coupled3d_step_compressed(*x, m)
        jx = fused(*jx)
    assert _gap(x, jx) <= 1e-11


def test_bf16_plain_step_c_tracks_pallas_bf16():
    """The plain bf16 coupled step (21 bf16 flow planes, f32 tracers)
    against the Pallas bf16 coupled kernel, 3 steps, within
    test_coupled3d_bf16_storage_tracks_f32's bounds (planes 1e-2, rho_r
    2e-2, tracers 2e-2, tracer mass 1e-6 relative)."""
    m, st = _pallas_model(torch.float32, "bf16")
    fused = _pallas_step(m, jnp.float32, "bf16")
    x = m.pack(st)
    assert x[0].dtype == torch.bfloat16 and x[1].dtype == torch.float32
    jx = (jnp.asarray(state_to_numpy(x[0])), jnp.asarray(_np(x[1])))
    for _ in range(3):
        x = m.step_c(x)
        jx = fused(*jx)
    got = m.flow.unpack_bf16(x[0]).numpy()
    want = np.asarray(_jax_model(m, jnp.float32).flow.unpack_bf16(jx[0]))
    assert np.isfinite(got).all() and x[1].dtype == torch.float32
    assert np.abs(got[:19] - want[:19]).max() < 1e-2
    assert np.abs(got[19] - want[19]).max() < 2e-2
    assert np.abs(_np(x[1]) - np.asarray(jx[1])).max() < 2e-2
    mass, jmass = float(x[1].double().sum()), float(np.asarray(
        jx[1], np.float64).sum())
    assert abs(mass - jmass) / jmass < 1e-6


def test_step_c_and_plain_step_c_agree_with_split_on_one_phase_slabs():
    """Where the boundary slabs hold one phase (the layered start), one
    compressed coupled step equals one split step packed, flow and tracers
    (1e-12)."""
    m, st = transport3d_case("probe", CPU, shape=SHAPE)
    s, g = m.step_c(m.pack(st))
    f_r, f_b, g2 = m.step(st)
    assert _gap([s, g], [m.flow.pack_state(f_r, f_b), g2]) <= 1e-12


@pytest.mark.parametrize("background", [0.0, 0.3])
def test_compressed_and_split_coupled_steps_part_on_a_mixed_inlet(
        background):
    """The reference's compressed and split boundary slabs part where a slab
    holds both phases (ROADMAP section 3), and so do the coupled steps: one
    step from the state after five split steps of a red inlet region
    holding blue at 0.3 parts by > 1e-2 in the flow (measured 3.3e-2) and
    the tracer, which sees the post-slab velocity, by > 1e-6 (8.9e-6); with
    one phase by 3.9e-7 and 3.3e-8."""
    m, _ = transport3d_case("probe", CPU, shape=SHAPE)
    fs = m.flow.init_state_layers(1.0, 1.0, invading_slabs=6,
                                  background=background)
    st = m.init_state(fs, tracer_start("random", 1, SHAPE))
    for _ in range(5):
        st = m.step(st)
    s, g = m.step_c(m.pack(st))
    f_r, f_b, g2 = m.step(st)
    flow = float((s - m.flow.pack_state(f_r, f_b)).abs().max())
    tracer = float((g - g2).abs().max())
    if background:
        assert flow > 1e-2 and tracer > 1e-6
    else:
        assert flow < 1e-5 and tracer < 1e-7


def test_transport3d_args_and_states_cross_from_jax():
    """``convert.transport3d_args_from_jax`` rebuilds a JAX model's port
    twin; (f_r, f_b, g) and (s, g), bf16 flow planes included, cross both
    ways bit for bit."""
    solid = np.zeros((12, 10, 8), bool)
    solid[:, 0, :] = solid[:, -1, :] = True
    jm = jf.TransportRK3D(
        jgeo.from_solid_mask(solid), jf.ColorGradientParams3D(tau_b=0.8),
        num_tracers=2, tau=(1.0, 0.9), j0=(0.25, 0.3), criteria=0.4,
        interface_mode="none", dtype=jnp.float32,
        boundaries=jf.CG3DBoundaryConfig(inlet="velocity",
                                         outlet="dirichlet",
                                         inlet_velocity=-2e-3))
    args = transport3d_args_from_jax(jm)
    assert args["tau"] == (1.0, 0.9) and args["j0"] == (0.25, 0.3)
    assert (args["num_tracers"], args["criteria"],
            args["interface_mode"]) == (2, 0.4, "none")
    m = TransportRK3D(from_solid_mask(solid), device=CPU, **args)
    assert dataclasses.asdict(m.flow.p) == dataclasses.asdict(jm.flow.p)
    assert dataclasses.asdict(m.flow.bcs) == dataclasses.asdict(jm.flow.bcs)
    np.testing.assert_array_equal(m.transport.j_coeffs.astype(np.float32),
                                  jm.transport.j_coeffs.astype(np.float32))
    conc0 = np.random.default_rng(6).uniform(0.0, 1.0, (2, 12, 10, 8))
    js = jm.init_state(jm.flow.init_state_layers(1.0, 1.0, invading_slabs=3),
                       conc0)
    packed = (jm.flow.pack_state(js[0], js[1]), js[2])
    packed_bf16 = (jm.flow.pack_state_bf16(js[0], js[1]), js[2])
    for state in (js, packed, packed_bf16):
        arrays = tuple(np.asarray(a) for a in state)
        t = state_from_numpy(arrays, device=CPU)
        assert isinstance(t, tuple) and len(t) == len(arrays)
        for a, b in zip(arrays, state_to_numpy(t)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    mb = TransportRK3D(from_solid_mask(solid), device=CPU, storage="bf16",
                       **args)
    got, got_bf16 = (x.pack(state_from_numpy(tuple(np.asarray(a) for a in js),
                                             device=CPU)) for x in (m, mb))
    for a, b in ((got, packed), (got_bf16, packed_bf16)):
        for x, y in zip(state_to_numpy(a), (np.asarray(v) for v in b)):
            np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


def test_model_options_and_cuda_default():
    """The kernel's tracer block and table carry the model's numbers; other
    interface modes than none | bounceback are refused (the JAX coupled
    kernel takes no other); without a card the default device raises."""
    m, _ = transport3d_case("dirichlet_nt2", CPU, shape=(8, 6, 5))
    assert (m.tracer_params.nt, m.tracer_params.interface,
            m.tracer_params.criteria) == (2, 1, 0.5)
    np.testing.assert_array_equal(
        m.tracer_table.numpy(),
        [[1.0, 0.25] + [(1.0 - 0.25) / 6.0] * 6,
         [0.8, 0.4] + [(1.0 - 0.4) / 6.0] * 6])
    assert m.path == "plain"
    geo = from_solid_mask(np.zeros((8, 6, 5), bool))
    with pytest.raises(ValueError, match="interface_mode"):
        TransportRK3D(geo, ColorGradientParams3D(), device=CPU,
                      interface_mode="permeable")
    with pytest.raises(ValueError, match="tau"):
        TransportD3Q7(geo, num_tracers=2, tau=(1.0, 0.9, 0.8), device=CPU)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TransportRK3D(geo, ColorGradientParams3D())


def test_chip_faults_patches_one_tracer_line():
    """chip_faults.py plants its tracer fault by replacing one line of
    csrc/cg3d.cuh, which must stay there exactly once."""
    import chip_faults
    with open(os.path.join(ROOT, "openlbmpm_torch", "csrc", "cg3d.cuh")) as f:
        assert f.read().count(chip_faults.TRACER_LINE) == 1
    assert chip_faults.CASES["tracer f32"] == (
        "cg3d.cuh", chip_faults.TRACER_LINE,
        chip_faults.TRACER_FAULT.format(size=4), ("26",))


def test_chip_faults_patches_one_fused_tracer_line():
    """chip_faults.py plants the fused tracer's fault (the -z slot a thread
    writes between two slabs of its column given its own cell's flags for
    the upwind cell's, in the f32 instance) by replacing one line of
    collide_stream's body in csrc/cg3d.cuh, which must stay there exactly
    once; phase 26 must fail it."""
    import chip_faults
    header, line, fault, phases = chip_faults.CASES["tracer z pair f32"]
    with open(os.path.join(ROOT, "openlbmpm_torch", "csrc", header)) as f:
        text = f.read()
    assert header == "cg3d.cuh" and text.count(line) == 1
    assert "tracer_slot<S>(6, flo, fhi" in line
    assert "sizeof(S) == 4 ? flo : fhi" in fault and phases == ("26",)
