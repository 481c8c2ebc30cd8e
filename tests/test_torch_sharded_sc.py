"""2-D Shan-Chen domain decomposition (K12c) and the dry run's GSPMD line on
a ``LocalMesh`` on the CPU, at f64 to 1e-12, inputs from a numpy seed.

* ``kernels/shanchen.py::build_sc_sharded_step`` of the port (on the CPU
  each shard runs the local kernel's plain version) against the JAX
  package's ``build_sc_sharded_step`` in interpret mode on the 8-device CPU
  mesh (conftest): the two cases of ``tests/test_multichip.py:278-315``
  (original SC; EFS iso-8 MRT; 64x64, side walls, Zou-He velocity inlet,
  convective outlet, (4, 1), T = 2, two calls), and the same two over four
  steps against the JAX ``_step_sc`` / ``_step_efs``;
* against the jitted JAX ``_step_impl``: T = 1, a pressure / pressure
  case, a Peng-Robinson case and four fluids (the runtime-K local passes
  on a card) at T = 2;
* shards of 26 rows (the boundary bands cross the frames at offsets a
  power-of-two ny never gives), both outlets, T = 1 and 2, against the
  port's single-device plain step;
* the builder returns None exactly where the JAX builder does for a
  reason of the domain or the state, and the cases where only one of them
  builds (ROADMAP.md section 3) are listed;
* the GSPMD line (``parallel/dryrun.py::build_gspmd_step``): the port's
  x-sharded plain split step on (1, 4) at 32x64 against the JAX
  ``_step_impl`` jitted with the x shardings, and the frame ``GSPMD_X`` is
  the step's reach: one column less differs.

The CUDA local kernels are held to these plain versions on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phases 70-71.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import SC4_CASES, SC_CASES, sc_rho0, sc_solid
from openlbmpm_tpu import geometry as geo
from openlbmpm_tpu.models import colorgradient as jcg
from openlbmpm_tpu.models import shanchen as js
from openlbmpm_tpu.pallas.shanchen import \
    build_sc_sharded_step as jax_sc_sharded
from openlbmpm_tpu.parallel.mesh import domain_sharding
from openlbmpm_tpu.parallel.mesh import make_mesh as jax_mesh
from openlbmpm_torch.convert import params_from_jax
from openlbmpm_torch.kernels.shanchen import (build_sc_sharded_step,
                                              sc_local_frame)
from openlbmpm_torch.models.shanchen import ShanChenMCMP
from openlbmpm_torch.parallel import dryrun, make_mesh

torch.set_num_threads(1)
CPU = "cpu"   # the port's models and meshes run on the card unless told
TOL = 1e-12
SC2 = dict(g_matrix=((0.0, 3.6), (3.6, 0.0)), g_solid=(-0.3, 0.3),
           tau=(1.0, 1.0))
EFS8 = dict(g_matrix=((0.0, 0.2), (0.2, 0.0)), g_solid=(-0.14, 0.14),
            tau=(1.0, 0.8), scheme="EFS", iso_order=8, collision="MRT")
VCONV = dict(inlet="zou_he_velocity", outlet="convective",
             inlet_velocity=(-1e-3, 0.0))


def _walled(ny, nx):
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    return geo.from_solid_mask(solid)


def _local(shape):
    return make_mesh(shape=shape, kind="local", device=CPU)


def _noisy(f, fluid, seed):
    """`f` scaled by 1 + 1e-3 noise (a numpy seed), solid cells zero."""
    rng = np.random.default_rng(seed)
    return np.asarray(f) * (1 + 1e-3 * rng.standard_normal(f.shape)) * \
        np.asarray(fluid)


def _multichip_case(scheme, seed=1):
    """(geometry, JAX params, JAX bcs, JAX model, start) of the case of
    tests/test_multichip.py:278-315: 64x64, side walls, fluid 0 in the top
    12 rows, noise on top."""
    g = _walled(64, 64)
    jp = js.ShanChenParams(**(SC2 if scheme == "SC" else EFS8))
    jb = js.SCBoundaryConfig(**VCONV)
    mj = js.ShanChenMCMP(g, jp, jb, dtype=jnp.float64, use_pallas=False)
    f0 = mj.init_state_layers((1.0, 1.0), (0.02, 0.02), invading_rows=12)
    return g, jp, jb, mj, _noisy(f0, g.is_fluid, seed)


def _table_case(name, ny, nx, seed):
    """A case of chip_smoke.SC_CASES / SC4_CASES on ny x nx: (geometry, JAX
    params, JAX bcs, JAX model, noisy start)."""
    p, b, init = (SC_CASES | SC4_CASES)[name]
    solid, _ = sc_solid(ny, nx, init)
    g = geo.from_solid_mask(solid)
    jp, jb = js.ShanChenParams(**p), js.SCBoundaryConfig(**b)
    mj = js.ShanChenMCMP(g, jp, jb, dtype=jnp.float64, use_pallas=False)
    f0 = np.asarray(mj._feq_init(jnp.asarray(
        sc_rho0(mj.k, ny, nx, init) * g.is_fluid, jnp.float64)))
    return g, jp, jb, mj, _noisy(f0, g.is_fluid, seed)


def _port(g, jp, jb, shape, t, f0, calls):
    step = build_sc_sharded_step(g, params_from_jax(jp), _local(shape),
                                 torch.float64, steps_per_call=t,
                                 bc_config=params_from_jax(jb))
    assert step is not None
    state = step.shard(f0)
    for _ in range(calls):
        state = step(state)
    return step.gather(state).numpy()


def _jax_steps(fn, f0, steps):
    f = jnp.asarray(f0)
    for _ in range(steps):
        f = fn(f)
    return np.asarray(f)


def _gap(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("scheme", ["SC", "EFS"])
def test_sc_sharded_matches_jax_sharded(scheme):
    """The JAX test's case: T = 2, two calls, against the JAX sharded
    builder in interpret mode (its local Pallas kernel, ppermute halos,
    scalar-prefetched row offsets)."""
    g, jp, jb, _, f0 = _multichip_case(scheme)
    jm = jax_mesh(shape=(4, 1))
    jstep = jax_sc_sharded(g, jp, jm, jnp.float64, rows_per_block=16,
                           steps_per_call=2, bc_config=jb, interpret=True)
    assert jstep is not None
    f = jax.device_put(jnp.asarray(f0), jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec(None, None, "y", None)))
    f = np.asarray(_jax_steps(jax.jit(jstep), f, 2))
    assert _gap(_port(g, jp, jb, (4, 1), 2, f0, 2), f) <= TOL


@pytest.mark.parametrize("scheme", ["SC", "EFS"])
def test_sc_sharded_matches_jax_step(scheme):
    """The same case against four steps of the JAX jnp ``_step_sc`` /
    ``_step_efs`` (the JAX test's own reference)."""
    g, jp, jb, mj, f0 = _multichip_case(scheme, seed=2)
    stepper = mj._step_sc if scheme == "SC" else mj._step_efs
    ref = _jax_steps(jax.jit(stepper), f0, 4)
    assert _gap(_port(g, jp, jb, (4, 1), 2, f0, 2), ref) <= TOL


@pytest.mark.parametrize("name,t,calls", [
    ("sc_srt_velocity_convective", 1, 4),
    ("efs8_mrt_velocity_convective", 1, 4),
    ("sc_srt_pressure_pressure", 2, 2),
    ("efs10_srt_pressure_pressure", 2, 2),
    ("sc_peng_robinson_one_fluid", 2, 2),
    ("sc4_mrt_velocity_convective", 2, 2),
    ("efs4_4f_velocity_pressure", 2, 2)])
def test_sc_sharded_matches_jax_impl(name, t, calls):
    """(4, 1) at 64x64 against the jitted JAX ``_step_impl``: T = 1, the
    pressure / pressure rows, Peng-Robinson psi and four fluids."""
    g, jp, jb, mj, f0 = _table_case(name, 64, 64, seed=3)
    ref = _jax_steps(jax.jit(mj._step_impl), f0, t * calls)
    assert _gap(_port(g, jp, jb, (4, 1), t, f0, calls), ref) <= TOL


@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("name", ["sc_mrt_velocity_convective",
                                  "efs8_mrt_velocity_convective",
                                  "efs10_mrt_velocity_pressure"])
def test_shards_of_26_rows(name, t):
    """ny = 104 on 4 shards, both outlets, two calls: against the port's
    single-device plain step."""
    g, jp, jb, _, f0 = _table_case(name, 104, 48, seed=4)
    m = ShanChenMCMP(g, params_from_jax(jp), params_from_jax(jb),
                     dtype=torch.float64, device=CPU)
    ref = torch.from_numpy(f0)
    for _ in range(2 * t):
        ref = m.plain_step(ref)
    assert _gap(_port(g, jp, jb, (4, 1), t, f0, 2), ref.numpy()) <= TOL


def test_frame_is_k8t_reach():
    """The frame: (reach + 1) T rows, the inlet ghosts' d rows below, the
    outlet's d + 2 (convective) or d (Zou-He) above; more where a band
    recurs within the frame."""
    b = js.SCBoundaryConfig(**VCONV)
    p8 = params_from_jax(js.ShanChenParams(**EFS8))
    p1 = params_from_jax(js.ShanChenParams(**SC2))
    f = sc_local_frame(p8, b, 2, 64)
    assert (f.lo, f.hi, f.x) == (6 + 2, 6 + 4, 0)
    f = sc_local_frame(p1, dataclasses.replace(b, outlet="zou_he_pressure"),
                       3, 64)
    assert (f.lo, f.hi) == (6 + 1, 6 + 1)
    f = sc_local_frame(p1, js.SCBoundaryConfig(), 4, 64)
    assert (f.lo, f.hi) == (8, 8)
    # a frame of 8 + 3 rows above meets the band of a 10-row domain twice
    f = sc_local_frame(p1, b, 4, 10)
    assert f.hi == 8 + 2 * 3


def _refusal_cases():
    sc, efs8 = js.ShanChenParams(**SC2), js.ShanChenParams(**EFS8)
    efs10 = dataclasses.replace(efs8, iso_order=10)
    vc = js.SCBoundaryConfig(**VCONV)
    return {
        # name: (ny, nx, mesh, T, params, bcs, JAX dtype) -> (port, JAX)
        # the JAX reasons: both refuse
        "x axis": ((64, 64, (2, 2), 1, sc, vc, jnp.float64), (False, False)),
        "ny % py": ((60, 64, (8, 1), 1, sc, vc, jnp.float64),
                    (False, False)),
        "true convective outlet": ((64, 64, (4, 1), 1, sc, dataclasses.replace(
            vc, outlet="convective_true"), jnp.float64), (False, False)),
        "Chang inlet": ((64, 64, (4, 1), 1, sc, dataclasses.replace(
            vc, inlet="chang_velocity"), jnp.float64), (False, False)),
        "iso-10 T=3 on 16 rows": ((64, 64, (4, 1), 3, efs10, vc,
                                   jnp.float64), (False, False)),
        # both build
        "SC T=2": ((64, 64, (4, 1), 2, sc, vc, jnp.float64), (True, True)),
        "EFS iso-8 T=1 (8, 1)": ((128, 64, (8, 1), 1, efs8, vc, jnp.float64),
                                 (True, True)),
        "iso-10 T=2 on 16 rows": ((64, 64, (4, 1), 2, efs10, vc,
                                   jnp.float64), (True, True)),
        # the port builds where the TPU strips find no rows a block
        "shards of 12 rows": ((48, 64, (4, 1), 1, sc, vc, jnp.float64),
                              (True, False)),
        "iso-10 T=3 on 24 rows": ((96, 64, (4, 1), 3, efs10, vc,
                                   jnp.float64), (True, False)),
        # the JAX builder builds where the port refuses: bfloat16
        # arithmetic, and a forcing its kernel ignores
        "bfloat16": ((64, 64, (4, 1), 1, sc, vc, jnp.bfloat16),
                     (False, True)),
        "guo forcing": ((64, 64, (4, 1), 1, dataclasses.replace(
            sc, forcing="guo"), vc, jnp.float64), (False, True)),
    }


@pytest.mark.parametrize("name", list(_refusal_cases()))
def test_sc_sharded_refuses_as_jax(name):
    (ny, nx, shape, t, jp, jb, jdt), (port, jax_builds) = \
        _refusal_cases()[name]
    g = _walled(ny, nx)
    jstep = jax_sc_sharded(g, jp, jax_mesh(shape=shape), jdt,
                           steps_per_call=t, bc_config=jb, interpret=True)
    dt = torch.bfloat16 if jdt == jnp.bfloat16 else torch.float64
    step = build_sc_sharded_step(g, params_from_jax(jp), _local(shape), dt,
                                 steps_per_call=t,
                                 bc_config=params_from_jax(jb))
    assert (step is not None, jstep is not None) == (port, jax_builds)


def _gspmd_case(seed=6):
    """The JAX dry run's flagship flow (``__graft_entry__.py::
    _flagship_model``) at 32x64 in f64 and its noisy split start."""
    from __graft_entry__ import _flagship_model
    mj = _flagship_model(ny=32, nx=64, dtype=jnp.float64)
    st = mj.init_state_layers(1.0, 1.0, invading_rows=6)
    fl = mj.geo.is_fluid
    return mj, tuple(_noisy(a, fl, seed + i) for i, a in enumerate(st))


def _gspmd_port(mj, start, frame_x):
    step = dryrun.build_gspmd_step(mj.geo, params_from_jax(mj.p),
                                   params_from_jax(mj.bcs), _local((1, 4)),
                                   torch.float64, frame_x=frame_x)
    assert step is not None
    return tuple(a.numpy() for a in step.gather(step(step.shard(*start))))


def test_gspmd_line_matches_jax():
    """One step of the x-sharded plain split step against the JAX
    ``_step_impl`` jitted with x shardings on a 1 x 4 mesh (the JAX dry
    run's first line)."""
    mj, start = _gspmd_case()
    jm = jax_mesh(4)
    shard = domain_sharding(jm, 3)
    jstep = jax.jit(mj._step_impl, in_shardings=(shard, shard),
                    out_shardings=(shard, shard))
    ref = jstep(*(jax.device_put(jnp.asarray(a), shard) for a in start))
    out = _gspmd_port(mj, start, dryrun.GSPMD_X)
    assert max(_gap(a, b) for a, b in zip(out, ref)) <= TOL


@pytest.mark.parametrize("dx", [-1, 0, 3])
def test_gspmd_frame_is_the_reach(dx):
    """With ``GSPMD_X`` columns or more the sharded step equals the
    single-device plain step bit for bit; with one column less it
    differs."""
    mj, start = _gspmd_case(seed=9)
    out = _gspmd_port(mj, start, dryrun.GSPMD_X + dx)
    from openlbmpm_torch.models.colorgradient import ColorGradientRK
    m = ColorGradientRK(mj.geo, params_from_jax(mj.p),
                        params_from_jax(mj.bcs), dtype=torch.float64,
                        device=CPU, use_kernel=False)
    ref = m.plain_step(tuple(torch.from_numpy(a) for a in start))
    gap = max(_gap(a, b.numpy()) for a, b in zip(out, ref))
    assert (gap == 0.0) == (dx >= 0)
    assert dx >= 0 or gap > 1e-6
