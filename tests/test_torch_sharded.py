"""2-D domain decomposition (K12a, K12b) on a ``LocalMesh`` on the CPU.

* ``kernels/csf.py::build_csf_sharded_step`` of the port (on the CPU each
  shard runs the local kernels' plain versions) against the JAX package's
  ``build_csf_sharded_step`` in interpret mode on the 8-device CPU mesh
  (conftest), at f64 to 1e-12 over 4 steps: the CSF flagship channel of
  ``tests/test_multichip.py:162-240`` on a 4-shard y-mesh at T = 1 and 2
  and on a (2, 4) mesh at T = 1, the Perturbation variant on the y-mesh,
  and the dry run's coupled D2Q5 bounce-back case
  (``__graft_entry__.py:197-243``) on (4, 1) and (2, 2), flow and tracers;
* ``kernels/single.py::build_single_sharded_step`` on a 4-shard y-mesh at
  T = 2 with the Zou-He inlet and convective outlet of
  ``tests/test_multichip.py:354-385`` against the JAX sharded builder
  (interpret mode) and the JAX ``_step_impl``;
* 4 shards of 26 rows (ny not a power of two) against the single-device
  plain step;
* the builders return None exactly where the JAX builders do for a reason
  of the domain or the state, and give a step where they do;
* ``shard_domain`` then ``gather_domain`` is the identity, bit for bit, and
  ``ppermute`` rotates along each ring.

The CUDA local kernels are held to these plain versions on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phases 63-66.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openlbmpm_tpu import geometry as geo
from openlbmpm_tpu.models import colorgradient as jcg
from openlbmpm_tpu.models import single_phase as jsp
from openlbmpm_tpu.models import transport as jtr
from openlbmpm_tpu.pallas.csf import build_csf_sharded_step as jax_csf_sharded
from openlbmpm_tpu.pallas.single import \
    build_single_sharded_step as jax_single_sharded
from openlbmpm_tpu.parallel.mesh import make_mesh as jax_mesh
from openlbmpm_torch.convert import params_from_jax
from openlbmpm_torch.kernels.csf import build_csf_sharded_step
from openlbmpm_torch.kernels.single import build_single_sharded_step
from openlbmpm_torch.models.colorgradient import ColorGradientRK
from openlbmpm_torch.parallel import (Frame, gather_domain, make_mesh,
                                      ppermute, shard_domain)

torch.set_num_threads(1)
CPU = "cpu"   # the port's models and meshes run on the card unless told
TOL = 1e-12
CSF = dict(variant="CSF", collision="MRT", surface_tension=0.01, tau_type=2,
           wetting_type=2)
PERT = dict(variant="Perturbation", collision="MRT", surface_tension=0.005,
            a_kr=0.005, a_kb=0.003, alpha_r=4 / 9, alpha_b=4 / 9,
            solid_phi=0.5, tau_r=1.0, tau_b=0.8)
BCS = dict(inlet="neumann", outlet="dirichlet", inlet_velocity=-1e-4,
           outlet_density_r=0.0, outlet_density_b=1.0)
COUPLED_BCS = dict(BCS, inlet_velocity=-1e-3)
TRACER = dict(num_tracers=1, scheme=5, tau=(1.0,),
              interface_mode="bounceback")


def _walled(ny, nx):
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    return geo.from_solid_mask(solid)


def _local(shape):
    return make_mesh(shape=shape, kind="local", device=CPU)


def _run_port(step, arrays, calls):
    state = step.shard(*arrays)
    for _ in range(calls):
        state = step(state)
    out = step.gather(state)
    return out if isinstance(out, tuple) else (out,)


def _run_jax(step, arrays, mesh, calls, specs):
    xs = tuple(jax.device_put(jnp.asarray(a), jax.sharding.NamedSharding(
        mesh, s)) for a, s in zip(arrays, specs))
    jstep = jax.jit(step)
    for _ in range(calls):
        xs = jstep(*xs)
        xs = xs if isinstance(xs, tuple) else (xs,)
    return tuple(np.asarray(x) for x in xs)


def _gap(a, b):
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(a, b))


def _spec(ndim, px):
    p = jax.sharding.PartitionSpec
    lead = (None,) * (ndim - 2)
    return p(*lead, "y", "x" if px > 1 else None)


@pytest.mark.parametrize("variant,shape,ny,nx,t,rows", [
    ("CSF", (4, 1), 64, 64, 1, 8), ("CSF", (4, 1), 64, 64, 2, 8),
    ("CSF", (2, 4), 64, 256, 1, 16), ("Perturbation", (4, 1), 64, 64, 1, 8)])
def test_csf_sharded_matches_jax(variant, shape, ny, nx, t, rows):
    g = _walled(ny, nx)
    jp = jcg.ColorGradientParams(**(CSF if variant == "CSF" else PERT))
    jb = jcg.CGBoundaryConfig(**BCS)
    mj = jcg.ColorGradientRK(g, jp, jb, dtype=jnp.float64, use_pallas=False)
    s0 = np.asarray(mj.pack_state(*mj.init_state_layers(
        1.0, 1.0, invading_rows=12)))
    jm = jax_mesh(shape=shape)
    jstep = jax_csf_sharded(g, jp, jm, jnp.float64, rows_per_block=rows,
                            steps_per_call=t, bc_config=jb, interpret=True)
    assert jstep is not None
    ref = _run_jax(jstep, (s0,), jm, 4 // t, (_spec(3, shape[1]),))
    step = build_csf_sharded_step(g, params_from_jax(jp), _local(shape),
                                  torch.float64, steps_per_call=t,
                                  bc_config=params_from_jax(jb))
    assert step is not None
    out = _run_port(step, (s0,), 4 // t)
    assert _gap(out, ref) <= TOL


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_coupled_sharded_matches_jax(shape):
    ny = nx = 64
    g = _walled(ny, nx)
    jp = jcg.ColorGradientParams(**CSF)
    jb = jcg.CGBoundaryConfig(**COUPLED_BCS)
    tp = jtr.TransportParams(**TRACER)
    mj = jtr.TransportRK(g, jp, tp, jb, dtype=jnp.float64, use_pallas=False)
    conc0 = np.zeros((1, ny, nx))
    conc0[:, ny // 2:] = 1.0
    st0 = mj.init_state(mj.flow.init_state_layers(1.0, 1.0,
                                                  invading_rows=12), conc0)
    s0 = np.asarray(mj.flow.pack_state(st0.f_r, st0.f_b))
    g0 = np.asarray(st0.g)
    jm = jax_mesh(shape=shape)
    jstep = jax_csf_sharded(g, jp, jm, jnp.float64, rows_per_block=8,
                            steps_per_call=1, bc_config=jb,
                            transport_params=tp, interpret=True)
    assert jstep is not None
    ref = _run_jax(jstep, (s0, g0), jm, 4,
                   (_spec(3, shape[1]), _spec(4, shape[1])))
    step = build_csf_sharded_step(g, params_from_jax(jp), _local(shape),
                                  torch.float64, steps_per_call=1,
                                  bc_config=params_from_jax(jb),
                                  transport_params=params_from_jax(tp))
    assert step is not None
    out = _run_port(step, (s0, g0), 4)
    assert _gap(out[:1], ref[:1]) <= TOL
    assert _gap(out[1:], ref[1:]) <= TOL


def _single_models(ny=64, nx=64):
    g = _walled(ny, nx)
    bcs = jsp.BoundaryConfig(inlet="zou_he_velocity", outlet="convective",
                             inlet_velocity=-1e-3)
    mj = jsp.SinglePhaseD2Q9(g, tau=0.8, collision="MRT", boundaries=bcs,
                             dtype=jnp.float64)
    return g, bcs, mj


def test_single_sharded_matches_jax():
    g, bcs, mj = _single_models()
    f0 = np.asarray(mj.init_state())
    rng = np.random.default_rng(3)
    f0 = f0 * (1 + 1e-3 * rng.standard_normal(f0.shape)) * \
        np.asarray(g.is_fluid)
    ref = jnp.asarray(f0)
    for _ in range(4):
        ref = mj._step_impl(ref)
    jm = jax_mesh(shape=(4, 1))
    jstep = jax_single_sharded(g, 0.8, "MRT", (0.0, 0.0), jm, bc_config=bcs,
                               dtype=jnp.float64, rows_per_block=16,
                               steps_per_call=2, interpret=True)
    assert jstep is not None
    ref_sh = _run_jax(jstep, (f0,), jm, 2, (_spec(3, 1),))
    step = build_single_sharded_step(g, 0.8, "MRT", (0.0, 0.0),
                                     _local((4, 1)),
                                     bc_config=params_from_jax(bcs),
                                     dtype=torch.float64, steps_per_call=2)
    assert step is not None
    out = _run_port(step, (f0,), 2)
    assert _gap(out, (np.asarray(ref),)) <= TOL
    assert _gap(out, ref_sh) <= TOL


@pytest.mark.parametrize("variant,t", [("CSF", 1), ("CSF", 2),
                                       ("Perturbation", 2)])
def test_shards_of_26_rows(variant, t):
    """ny = 104 on 4 shards: the boundary bands cross the frames at offsets
    a power-of-two ny never gives; against the single-device plain step."""
    g = _walled(104, 48)
    jp = jcg.ColorGradientParams(**(CSF if variant == "CSF" else PERT))
    pp = params_from_jax(jp)
    bcs = params_from_jax(jcg.CGBoundaryConfig(
        inlet="dirichlet", outlet="convective", inlet_density_r=1.0005,
        inlet_density_b=2e-3))
    m = ColorGradientRK(g, pp, bcs, dtype=torch.float64, device=CPU)
    s0 = m.pack_state(*m.init_state_layers(1.0, 1.0, invading_rows=20))
    ref = s0
    for _ in range(2 * t):
        ref = m.plain_step_c(ref)
    step = build_csf_sharded_step(g, pp, _local((4, 1)), torch.float64,
                                  steps_per_call=t, bc_config=bcs)
    (out,) = _run_port(step, (s0,), 2)
    assert float((out - ref).abs().max()) <= TOL


def _csf_refusal_cases():
    jp, pert = jcg.ColorGradientParams(**CSF), jcg.ColorGradientParams(**PERT)
    tp = jtr.TransportParams(**TRACER)
    return {
        # (ny, nx, mesh shape, T, TPU rows per block, params, transport):
        # the JAX reasons
        "ny % py": (60, 64, (8, 1), 1, 8, jp, None),
        "nx % px": (64, 60, (2, 4), 1, 8, jp, None),
        "nx/px <= 2H": (64, 64, (2, 4), 1, 8, jp, None),
        "nx/px <= 2H at T=3": (64, 128, (2, 4), 3, 16, jp, None),
        "Perturbation with transport": (64, 64, (4, 1), 1, 8, pert, tp),
        # where both build a step
        "builds (4, 1)": (64, 64, (4, 1), 1, 8, jp, None),
        "builds (2, 4) T=2": (64, 128, (2, 4), 2, 8, jp, None),
        "builds coupled (2, 2)": (64, 64, (2, 2), 1, 8, jp, tp),
    }


@pytest.mark.parametrize("name", list(_csf_refusal_cases()))
def test_csf_sharded_refuses_as_jax(name):
    ny, nx, shape, t, rows, jp, tp = _csf_refusal_cases()[name]
    g = _walled(ny, nx)
    jb = jcg.CGBoundaryConfig(**BCS)
    jstep = jax_csf_sharded(g, jp, jax_mesh(shape=shape), jnp.float64,
                            rows_per_block=rows, steps_per_call=t,
                            bc_config=jb, transport_params=tp,
                            interpret=True)
    step = build_csf_sharded_step(
        g, params_from_jax(jp), _local(shape), torch.float64,
        steps_per_call=t, bc_config=params_from_jax(jb),
        transport_params=None if tp is None else params_from_jax(tp))
    assert (step is None) == (jstep is None)
    assert (step is None) == (not name.startswith("builds"))


@pytest.mark.parametrize("kw", [dict(state_mode="split"),
                                dict(dtype=torch.bfloat16)])
def test_csf_sharded_refuses_split_and_bf16(kw):
    """The JAX local kernel refuses the split state and bf16 storage
    (csf.py:238-245); its sharded builder never asks for them."""
    jp = jcg.ColorGradientParams(**CSF)
    args = dict(dtype=torch.float64) | kw
    assert build_csf_sharded_step(
        _walled(64, 64), params_from_jax(jp), _local((4, 1)),
        steps_per_call=1, bc_config=params_from_jax(
            jcg.CGBoundaryConfig(**BCS)), **args) is None


@pytest.mark.parametrize("shape,ny,builds", [((4, 1), 64, True),
                                             ((2, 2), 64, False),
                                             ((3, 1), 64, False)])
def test_single_sharded_refuses_as_jax(shape, ny, builds):
    g, bcs, _ = _single_models(ny=ny)
    jstep = jax_single_sharded(g, 0.8, "MRT", (0.0, 0.0),
                               jax_mesh(shape=shape), bc_config=bcs,
                               dtype=jnp.float64, rows_per_block=16,
                               steps_per_call=2, interpret=True)
    step = build_single_sharded_step(g, 0.8, "MRT", (0.0, 0.0),
                                     _local(shape),
                                     bc_config=params_from_jax(bcs),
                                     dtype=torch.float64, steps_per_call=2)
    assert (step is not None) == (jstep is not None) == builds


@pytest.mark.parametrize("shape,frame", [((4, 1), Frame(5, 7, 0)),
                                         ((2, 2), Frame(9, 11, 8)),
                                         ((1, 2), Frame(3, 4, 2))])
def test_shard_then_gather_is_identity(shape, frame):
    rng = np.random.default_rng(7)
    a = rng.standard_normal((3, 2, 48, 40))
    mesh = _local(shape)
    bufs = shard_domain(a, mesh, frame)
    py, px = shape
    assert bufs[0].shape == (3, 2, frame.lo + 48 // py + frame.hi,
                             40 // px + 2 * frame.x)
    back = gather_domain(mesh, bufs, frame, 48, 40)
    assert np.array_equal(back.numpy(), a)


def test_ppermute_rotates_each_ring():
    mesh = _local((2, 3))
    ids = [torch.tensor([float(k)]) for k in range(6)]
    got_x = ppermute(mesh, ids, "x", 1)
    got_y = ppermute(mesh, ids, "y", -1)
    # shard (iy, ix) receives from (iy, ix - 1) along x, (iy + 1, ix) along y
    assert [int(t) for t in got_x] == [2, 0, 1, 5, 3, 4]
    assert [int(t) for t in got_y] == [3, 4, 5, 0, 1, 2]
    assert all(a is not b for a, b in zip(got_x, ids))
