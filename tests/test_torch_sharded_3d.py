"""3-D domain decomposition (K12d, K12e) on a ``LocalMesh`` on the CPU.

* ``kernels/cg3d.py::build_cg3d_sharded_step`` of the port (on the CPU each
  shard runs the local kernels' plain versions) against the JAX package's
  ``build_cg3d_sharded_step`` in interpret mode on the 8-device CPU mesh
  (conftest), at f64 (the JAX builder runs at f64) to 1e-12, two calls:
  the z-mesh case of ``tests/test_multichip.py:242-279`` (32x16x16, y
  walls, velocity inlet, convective outlet, (4, 1)), the (z, y) case of
  :388-425 (16x64x16 on (2, 2)) and the coupled case of :518-554 (one D3Q7
  bounce-back tracer, periodic, (4, 1)); then the z-mesh case over 4 calls
  against the JAX single-device compressed step (``build_cg3d_fused_step``,
  interpret mode) and the coupled one against the JAX coupled step
  (``TransportRK3D.make_fused_step``), to 1e-12;
* ``kernels/flow3d.py::build_sc3d_sharded_step`` against the JAX
  ``build_sc3d_sharded_step`` (interpret mode) at the case of
  :323-352 (16^3, K = 2, (4, 1)) at T = 1 and 2, and K = 4 on (4, 1) at
  T = 2 against the JAX ``_step_impl``, to 1e-12;
* the builders return None exactly where the JAX builders do for a reason
  of the domain or the state, and build where they do; the port's own
  refusals (bfloat16, a domain below K9's 8x2x2) and the cases where the
  port runs and the JAX builder refuses (shards of 6 slabs: the TPU
  strips need a halo of 4 or 2T slabs dividing the shard) are listed;
* ``shard_domain`` then ``gather_domain`` is the identity in 3-D, bit for
  bit.

The CUDA local kernels are held to these plain versions on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phases 67-69.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openlbmpm_tpu import geometry as jgeo
from openlbmpm_tpu.models import flow3d as jf
from openlbmpm_tpu.pallas.cg3d import build_cg3d_fused_step
from openlbmpm_tpu.pallas.cg3d import \
    build_cg3d_sharded_step as jax_cg3d_sharded
from openlbmpm_tpu.pallas.sc3d import \
    build_sc3d_sharded_step as jax_sc3d_sharded
from openlbmpm_tpu.parallel.mesh import make_mesh as jax_mesh
from openlbmpm_torch.convert import params_from_jax
from openlbmpm_torch.kernels.cg3d import build_cg3d_sharded_step
from openlbmpm_torch.kernels.flow3d import build_sc3d_sharded_step
from openlbmpm_torch.models import flow3d as tf
from openlbmpm_torch.parallel import (Frame, gather_domain, make_mesh,
                                      shard_domain)

torch.set_num_threads(1)
CPU = "cpu"   # the port's models and meshes run on the card unless told
TOL = 1e-12
CG3D = dict(surface_tension=0.01, tau_r=1.0, tau_b=0.8,
            contact_angle_deg=60.0)
VCONV = dict(inlet="velocity", outlet="convective", inlet_velocity=-1e-3)
SC2 = dict(g_matrix=((0.0, 3.6), (3.6, 0.0)), g_solid=(-0.3, 0.3),
           tau=(1.0, 0.8), body_force=(0.0, 0.0, -1e-5))


def _walled(shape):
    solid = np.zeros(shape, bool)
    solid[:, 0, :] = solid[:, -1, :] = True
    return jgeo.from_solid_mask(solid)


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


def _spec(lead, py, px):
    p = jax.sharding.PartitionSpec
    return p(*(None,) * lead, "y" if py > 1 else None,
             "x" if px > 1 else None, None)


def _cg3d_start(shape, slabs=8):
    g = _walled(shape)
    jp, jb = jf.ColorGradientParams3D(**CG3D), jf.CG3DBoundaryConfig(**VCONV)
    mj = jf.ColorGradientRK3D(g, jp, jb, dtype=jnp.float64, use_pallas=False)
    return g, jp, jb, np.asarray(mj.pack_state(*mj.init_state_layers(
        1.0, 1.0, invading_slabs=slabs)))


@pytest.mark.parametrize("shape,mshape", [((32, 16, 16), (4, 1)),
                                          ((16, 64, 16), (2, 2))])
def test_cg3d_sharded_matches_jax(shape, mshape):
    g, jp, jb, s0 = _cg3d_start(shape)
    jm = jax_mesh(shape=mshape)
    jstep = jax_cg3d_sharded(g, jp, jm, jnp.float64, slabs_per_block=4,
                             bc_config=jb, interpret=True)
    assert jstep is not None
    ref = _run_jax(jstep, (s0,), jm, 2, (_spec(1, *mshape),))
    step = build_cg3d_sharded_step(g, params_from_jax(jp), _local(mshape),
                                   torch.float64,
                                   bc_config=params_from_jax(jb))
    assert step is not None
    assert _gap(_run_port(step, (s0,), 2), ref) <= TOL


def test_cg3d_sharded_matches_jax_compressed_step():
    """4 calls on the z-mesh against 4 steps of the JAX single-device
    compressed kernel (the JAX 3-D model's compressed step)."""
    g, jp, jb, s0 = _cg3d_start((32, 16, 16))
    fused = build_cg3d_fused_step(g, jp, jnp.float64, slabs_per_block=8,
                                  bc_config=jb, state_mode="compressed",
                                  interpret=True)
    ref = jnp.asarray(s0)
    for _ in range(4):
        ref = fused(ref)
    step = build_cg3d_sharded_step(g, params_from_jax(jp), _local((4, 1)),
                                   torch.float64,
                                   bc_config=params_from_jax(jb))
    assert _gap(_run_port(step, (s0,), 4), (np.asarray(ref),)) <= TOL


def _coupled_models(shape=(32, 16, 16)):
    g = _walled(shape)
    jp = jf.ColorGradientParams3D(**CG3D)
    mj = jf.TransportRK3D(g, jp, num_tracers=1, tau=(1.0,),
                          interface_mode="bounceback", dtype=jnp.float64)
    f_r, f_b = mj.flow.init_state_layers(1.0, 1.0, invading_slabs=8)
    conc0 = np.zeros((1, *shape))
    conc0[:, shape[0] // 2:] = 1.0
    s0 = np.asarray(mj.flow.pack_state(f_r, f_b))
    g0 = np.asarray(mj.transport.init_state(conc0))
    tr = tf.TransportD3Q7(g, 1, (1.0,), interface_mode="bounceback",
                          dtype=torch.float64, device=CPU)
    step = build_cg3d_sharded_step(g, params_from_jax(jp), _local((4, 1)),
                                   torch.float64,
                                   bc_config=params_from_jax(mj.flow.bcs),
                                   transport=tr)
    return g, jp, mj, s0, g0, step


def test_coupled3d_sharded_matches_jax():
    g, jp, mj, s0, g0, step = _coupled_models()
    jm = jax_mesh(shape=(4, 1))
    jstep = jax_cg3d_sharded(g, jp, jm, jnp.float64, slabs_per_block=4,
                             bc_config=mj.flow.bcs, transport=mj.transport,
                             interpret=True)
    assert jstep is not None and step is not None
    ref = _run_jax(jstep, (s0, g0), jm, 2,
                   (_spec(1, 4, 1), _spec(2, 4, 1)))
    out = _run_port(step, (s0, g0), 2)
    assert _gap(out[:1], ref[:1]) <= TOL
    assert _gap(out[1:], ref[1:]) <= TOL


def test_coupled3d_sharded_matches_jax_coupled_step():
    """4 calls against 4 steps of the JAX single-device coupled kernel."""
    _, _, mj, s0, g0, step = _coupled_models()
    single = mj.make_fused_step(slabs_per_block=8, interpret=True)
    a, ga = jnp.asarray(s0), jnp.asarray(g0)
    for _ in range(4):
        a, ga = single(a, ga)
    out = _run_port(step, (s0, g0), 4)
    assert _gap(out, (np.asarray(a), np.asarray(ga))) <= TOL


def _sc3d_models(k=2, shape=(16, 16, 16)):
    g = _walled(shape)
    if k == 2:
        jp = jf.ShanChenParams3D(**SC2)
    else:
        gm = np.full((4, 4), 1.2)
        np.fill_diagonal(gm, 0.0)
        jp = jf.ShanChenParams3D(g_matrix=tuple(map(tuple, gm)),
                                 g_solid=(-0.2, 0.1, 0.0, 0.2),
                                 tau=(1.0, 0.8, 0.9, 1.1),
                                 body_force=(0.0, 0.0, -1e-5))
    mj = jf.ShanChenMCMP3D(g, jp, dtype=jnp.float64, use_pallas=False)
    f0 = np.asarray(mj.init_state_droplet((1.0,) * k, (0.02,) * k,
                                          radius=5.0))
    return g, jp, mj, f0


@pytest.mark.parametrize("t", [1, 2])
def test_sc3d_sharded_matches_jax(t):
    g, jp, _, f0 = _sc3d_models()
    jm = jax_mesh(shape=(4, 1))
    jstep = jax_sc3d_sharded(g, jp, jm, jnp.float64, slabs_per_block=4,
                             steps_per_call=t, interpret=True)
    assert jstep is not None
    p = jax.sharding.PartitionSpec
    ref = _run_jax(jstep, (f0,), jm, 2, (p(None, None, "y", None, None),))
    step = build_sc3d_sharded_step(g, params_from_jax(jp), _local((4, 1)),
                                   torch.float64, steps_per_call=t)
    assert step is not None
    assert _gap(_run_port(step, (f0,), 2), ref) <= TOL


def test_sc3d_four_fluids_sharded_matches_jax_step():
    g, jp, mj, f0 = _sc3d_models(k=4)
    ref = jnp.asarray(f0)
    for _ in range(4):
        ref = mj._step_impl(ref)
    step = build_sc3d_sharded_step(g, params_from_jax(jp), _local((4, 1)),
                                   torch.float64, steps_per_call=2)
    assert _gap(_run_port(step, (f0,), 2), (np.asarray(ref),)) <= TOL


def _cg3d_refusal_cases():
    return {
        # (shape, mesh shape, boundary fields, with a tracer): the JAX
        # reasons
        "nz % py": ((30, 16, 16), (4, 1), VCONV, False),
        "ny % px": ((16, 66, 16), (2, 4), VCONV, False),
        "tracer with px > 1": ((16, 64, 16), (2, 2), {}, True),
        "ny/px <= 16": ((16, 32, 16), (2, 2), VCONV, False),
        "nz/py < 4": ((12, 16, 16), (4, 1), VCONV, False),
        "inlet kind": ((32, 16, 16), (4, 1), dict(inlet="pressure"), False),
        # where both build a step
        "builds (4, 1)": ((32, 16, 16), (4, 1), VCONV, False),
        "builds (2, 2)": ((16, 64, 16), (2, 2), VCONV, False),
        "builds 4-slab shards": ((16, 16, 16), (4, 1), VCONV, False),
        "builds coupled (4, 1)": ((32, 16, 16), (4, 1), {}, True),
    }


@pytest.mark.parametrize("name", list(_cg3d_refusal_cases()))
def test_cg3d_sharded_refuses_as_jax(name):
    shape, mshape, bkw, coupled = _cg3d_refusal_cases()[name]
    g = _walled(shape)
    jp, jb = jf.ColorGradientParams3D(**CG3D), jf.CG3DBoundaryConfig(**bkw)
    jtr, ttr = None, None
    if coupled:
        jtr = jf.TransportD3Q7(g, 1, (1.0,), interface_mode="bounceback")
        ttr = tf.TransportD3Q7(g, 1, (1.0,), interface_mode="bounceback",
                               dtype=torch.float64, device=CPU)
    jstep = jax_cg3d_sharded(g, jp, jax_mesh(shape=mshape), jnp.float64,
                             slabs_per_block=4, bc_config=jb, transport=jtr,
                             interpret=True)
    step = build_cg3d_sharded_step(g, params_from_jax(jp), _local(mshape),
                                   torch.float64,
                                   bc_config=params_from_jax(jb),
                                   transport=ttr)
    assert (step is None) == (jstep is None)
    assert (step is None) == (not name.startswith("builds"))


def _sc3d_refusal_cases():
    return {
        # (nz, mesh shape, T, params changes): the JAX reasons
        "x axis > 1": (16, (2, 2), 1, {}),
        "nz % py": (18, (4, 1), 1, {}),
        "psi": (16, (4, 1), 1, dict(psi="PR")),
        "nz/py < 2T": (16, (4, 1), 3, {}),
        # where both build a step
        "builds T=1": (16, (4, 1), 1, {}),
        "builds T=2": (16, (4, 1), 2, {}),
    }


@pytest.mark.parametrize("name", list(_sc3d_refusal_cases()))
def test_sc3d_sharded_refuses_as_jax(name):
    nz, mshape, t, change = _sc3d_refusal_cases()[name]
    g = _walled((nz, 16, 16))
    jp = jf.ShanChenParams3D(**SC2 | change)
    jstep = jax_sc3d_sharded(g, jp, jax_mesh(shape=mshape), jnp.float64,
                             steps_per_call=t, interpret=True)
    step = build_sc3d_sharded_step(g, params_from_jax(jp), _local(mshape),
                                   torch.float64, steps_per_call=t)
    assert (step is None) == (jstep is None)
    assert (step is None) == (not name.startswith("builds"))


def test_port_refusals_and_where_only_the_port_runs():
    """The port's own refusals (bfloat16 storage; K9's 8x2x2 least
    domain), and 6-slab shards, which the JAX builders refuse (no TPU
    strip with a 4-slab halo, or a 2T-slab one at T = 2, divides 6) and the
    port runs, equal to the single-device plain steps."""
    g, jp, jb, s0 = _cg3d_start((24, 16, 16), slabs=6)
    pp, pb = params_from_jax(jp), params_from_jax(jb)
    assert build_cg3d_sharded_step(g, pp, _local((4, 1)), torch.bfloat16,
                                   bc_config=pb) is None
    assert build_cg3d_sharded_step(_walled((4, 16, 16)), pp, _local((1, 1)),
                                   torch.float64, bc_config=pb) is None
    assert jax_cg3d_sharded(g, jp, jax_mesh(shape=(4, 1)), jnp.float64,
                            bc_config=jb, interpret=True) is None
    step = build_cg3d_sharded_step(g, pp, _local((4, 1)), torch.float64,
                                   bc_config=pb)
    m = tf.ColorGradientRK3D(g, pp, pb, dtype=torch.float64, device=CPU)
    ref = torch.as_tensor(np.array(s0))
    for _ in range(3):
        ref = m.plain_step_c(ref)
    assert _gap(_run_port(step, (s0,), 3), (ref,)) == 0.0

    gs = _walled((24, 16, 16))
    jp = jf.ShanChenParams3D(**SC2)
    assert jax_sc3d_sharded(gs, jp, jax_mesh(shape=(4, 1)), jnp.float64,
                            steps_per_call=2, interpret=True) is None
    assert build_sc3d_sharded_step(gs, params_from_jax(jp), _local((4, 1)),
                                   torch.bfloat16) is None
    step = build_sc3d_sharded_step(gs, params_from_jax(jp), _local((4, 1)),
                                   torch.float64, steps_per_call=2)
    m = step.model
    f0 = m.init_state_droplet((1.0, 1.0), (0.02, 0.02), radius=5.0)
    ref = f0
    for _ in range(4):
        ref = m.plain_step(ref)
    assert _gap(_run_port(step, (f0,), 2), (ref,)) == 0.0


@pytest.mark.parametrize("shape,frame", [((4, 1), Frame(4, 4, 0)),
                                         ((2, 2), Frame(4, 4, 4)),
                                         ((1, 2), Frame(2, 3, 5)),
                                         ((4, 1), Frame(8, 8, 0))])
def test_shard_then_gather_is_identity_3d(shape, frame):
    rng = np.random.default_rng(11)
    a = rng.standard_normal((2, 3, 32, 20, 6))
    mesh = _local(shape)
    bufs = shard_domain(a, mesh, frame, rank=3)
    py, px = shape
    assert bufs[0].shape == (2, 3, frame.lo + 32 // py + frame.hi,
                             20 // px + 2 * frame.x, 6)
    back = gather_domain(mesh, bufs, frame, 32, 20, 6)
    assert np.array_equal(back.numpy(), a)


def test_exchange_fills_3d_frames_as_shard_domain():
    """After the exchange, every padded buffer equals ``shard_domain`` of
    the global array: y frames first, then z slabs of the y-padded rows
    (the corners ride along)."""
    from openlbmpm_torch.parallel import exchange
    rng = np.random.default_rng(12)
    a = torch.as_tensor(rng.standard_normal((3, 16, 24, 5)))
    mesh, frame = _local((2, 2)), Frame(3, 4, 5)
    want = shard_domain(a, mesh, frame, rank=3)
    got = [w.clone() for w in want]
    for t in got:   # spoil every frame cell
        t[:, :frame.lo] = t[:, frame.lo + 8:] = np.nan
        t[:, :, :frame.x] = t[:, :, frame.x + 12:] = np.nan
    exchange(mesh, [(t,) for t in got], frame, 8, 12, 5)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("case,phase", [("K12d slab index", "67"),
                                        ("K12e rho short", "68")])
def test_chip_faults_plants_one_local_line(case, phase):
    """chip_faults.py plants K12d's boundary slab one buffer slab off its
    global index and K12e's rho range one slab short, each in the f64
    instance, by replacing one line that stays there exactly once; each
    must fail its f64 phase while the single-device kernels' phases pass."""
    import os

    import chip_faults
    header, line, fault, phases = chip_faults.CASES[case]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "openlbmpm_torch", "csrc", header)) as f:
        assert f.read().count(line) == 1
    assert fault != line and "sizeof(S) == 8" in fault
    assert phases == (phase,) and phase in chip_faults.ALL_PHASES
    assert set(chip_faults.MUST_PASS[case]) <= set(chip_faults.ALL_PHASES)
