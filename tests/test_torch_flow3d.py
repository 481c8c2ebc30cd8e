"""The port's D3Q19 single-phase and Shan-Chen models against the JAX
package, on the CPU at f64.

* ``SinglePhaseD3Q19``'s plain step against the jitted jnp ``_step_impl``
  (``use_pallas=False``), 20 steps to 1e-12: SRT and TRT, with and without
  the body force, walls on the y faces and an obstacle;
* ``ShanChenMCMP3D``'s plain step against the jitted jnp step, 20 steps to
  1e-12: two fluids periodic from the droplet start, two fluids with y
  walls, G_s = (-0.3, 0.3), tau = (1.0, 0.8) and a body force, three
  fluids;
* ``pack_state_bf16`` bit for bit (one and K fluids), the adhesion planes
  (``geo_stack_sc3``), ``load_basic3d`` and ``load_shanchen3d`` field by
  field, the macro fields, and the path rules.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openlbmpm_tpu import config as jconfig
from openlbmpm_tpu import geometry as geo
from openlbmpm_tpu.lattice import D3Q19
from openlbmpm_tpu.models import flow3d as jf
from openlbmpm_tpu.ops import equilibrium as jeq
from openlbmpm_tpu.pallas.sc3d import geo_stack_sc3 as jgeo_stack_sc3
from openlbmpm_torch import config as tconfig
from openlbmpm_torch.convert import params_from_jax, single_phase_args_from_jax
from openlbmpm_torch.kernels.flow3d import geo_stack_sc3
from openlbmpm_torch.models.flow3d import (ShanChenMCMP3D, ShanChenParams3D,
                                           SinglePhaseD3Q19)

torch.set_num_threads(1)
CPU = "cpu"   # the port's models run on the card unless told otherwise

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (10, 12, 16)       # (nz, ny, nx)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol):
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _close(g, w, atol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def _geometry(kind):
    solid = np.zeros(SHAPE, bool)
    if kind != "open":
        solid[:, 0, :] = solid[:, -1, :] = True
    if kind == "obstacle":
        solid[3:6, 4:7, 5:9] = True
    return geo.from_solid_mask(solid)


def _perturbed(shape, seed, k=None):
    """A perturbed equilibrium (numpy, f64): rho in [0.97, 1.03] (times
    the fluid's scale when k fluids), |u| <= 0.02."""
    rng = np.random.default_rng(seed)
    lead = () if k is None else (k,)
    rho = rng.uniform(0.97, 1.03, lead + shape)
    if k is not None:
        rho *= np.array([1.0, 0.3, 0.6, 0.45][:k]).reshape(-1, 1, 1, 1)
    u = tuple(jnp.asarray(rng.uniform(-0.02, 0.02, lead + shape))
              for _ in range(3))
    return np.asarray(jeq.feq_quadratic(D3Q19, jnp.asarray(rho), u))


@pytest.mark.parametrize("force", [True, False], ids=["force", "no_force"])
@pytest.mark.parametrize("collision", ["SRT", "TRT"])
def test_single3d_plain_step_matches_jax_f64(collision, force):
    g = _geometry("obstacle")
    mj = jf.SinglePhaseD3Q19(g, tau=0.8, collision=collision,
                             body_force=(2e-5, -1e-5, 3e-5) if force
                             else (0.0, 0.0, 0.0), dtype=jnp.float64,
                             use_pallas=False)
    mt = SinglePhaseD3Q19(g, **single_phase_args_from_jax(mj),
                          dtype=torch.float64, device=CPU)
    assert mt.path == "plain"
    f0 = _perturbed(SHAPE, 0) * g.is_fluid
    a, b = jnp.asarray(f0), _t(f0)
    jstep = jax.jit(mj._step_impl)
    for _ in range(20):
        a, b = jstep(a), mt.step(b)
    assert bool(torch.isfinite(b).all())
    _close(b, a, 1e-12)
    _close(mt.macro(b), mj.macro(a), 1e-12)


SC_CASES = {
    # tests/test_flow3d.py's separation setup: an open periodic box
    "k2_periodic": (dict(g_matrix=((0.0, 3.6), (3.6, 0.0)),
                         g_solid=(0.0, 0.0), tau=(1.0, 1.0)), "open",
                    "droplet"),
    # benchmarks/probe_sc3d.py's physics on walls with an obstacle
    "k2_walls_force": (dict(g_matrix=((0.0, 3.6), (3.6, 0.0)),
                            g_solid=(-0.3, 0.3), tau=(1.0, 0.8),
                            body_force=(1e-5, -2e-5, -1e-5)), "obstacle",
                       "droplet"),
    "k3": (dict(g_matrix=((0.0, 2.0, 1.0), (2.0, 0.0, 1.5),
                          (1.0, 1.5, 0.0)), g_solid=(0.1, -0.2, 0.0),
                tau=(1.0, 0.8, 1.2)), "walls", "random"),
}


def _sc_pair(name, dtype=jnp.float64):
    kw, kind, start = SC_CASES[name]
    g = _geometry(kind)
    p = jf.ShanChenParams3D(**kw)
    mj = jf.ShanChenMCMP3D(g, p, dtype=dtype, use_pallas=False)
    mt = ShanChenMCMP3D(g, params_from_jax(p), dtype=torch.float64
                        if dtype == jnp.float64 else torch.float32,
                        device=CPU)
    if start == "droplet":
        k = p.num_fluids
        f0 = np.asarray(mj.init_state_droplet((1.0,) * k, (0.02,) * k,
                                              radius=3.5))
        np.testing.assert_array_equal(
            mt.init_state_droplet((1.0,) * k, (0.02,) * k,
                                  radius=3.5).numpy(), f0)
    else:
        f0 = _perturbed(SHAPE, 1, p.num_fluids) * g.is_fluid
    return mj, mt, f0


@pytest.mark.parametrize("name", sorted(SC_CASES))
def test_sc3d_plain_step_matches_jax_f64(name):
    mj, mt, f0 = _sc_pair(name)
    assert mt.path == "plain"
    a, b = jnp.asarray(f0), _t(f0)
    jstep = jax.jit(mj._step_impl)
    for _ in range(20):
        a, b = jstep(a), mt.step(b)
    assert bool(torch.isfinite(b).all())
    _close(b, a, 1e-12)
    rho_t, u_t = mt.macro(b)
    rho_j, u_j = mj.macro(a)
    _close(rho_t, rho_j, 1e-12)
    _close(u_t, u_j, 1e-12)
    _close(mt.pressure(rho_t), mj.pressure(rho_j), 1e-12)


def test_sc3d_four_fluids_plain_matches_pallas_interpret():
    """Four fluids, which K10 runs on its runtime-K instance: the plain step
    against build_sc3d_fused_step in interpret mode (which takes any number
    of fluids) on a 16 x 8 x 8 box with y walls, two steps from a perturbed
    equilibrium at f64, 1e-12; ``sc3d_params`` builds with k = 4 and the
    per-fluid arrays left to ``sc3d_table``."""
    from chip_smoke import SC3D4_CASES
    from openlbmpm_torch.kernels.flow3d import sc3d_params, sc3d_table
    from openlbmpm_tpu.pallas.sc3d import build_sc3d_fused_step
    shape = (16, 8, 8)
    solid = np.zeros(shape, bool)
    solid[:, 0, :] = solid[:, -1, :] = True
    g = geo.from_solid_mask(solid)
    p = jf.ShanChenParams3D(**SC3D4_CASES["k4_walls_force"][0])
    mt = ShanChenMCMP3D(g, params_from_jax(p), dtype=torch.float64,
                        device=CPU)
    fused = build_sc3d_fused_step(g, p, jnp.float64, slabs_per_block=8,
                                  interpret=True)
    assert fused is not None and mt.k == 4
    f0 = _perturbed(shape, 4, 4) * g.is_fluid
    a, b = fused(jnp.asarray(f0)), mt.step(_t(f0))
    _close(b, a, 1e-12)
    _close(mt.step(b), fused(a), 1e-12)
    kp = sc3d_params(mt.p, mt.geo)
    assert kp.k == 4 and list(kp.tau) == [1.0] * 3
    np.testing.assert_array_equal(sc3d_table(mt.p), np.concatenate(
        [mt.tau, mt.g_solid, mt.g_matrix.ravel()]))
    assert mt.make_block_step(2) is not None


@pytest.mark.parametrize("kind", ["walls", "obstacle"])
def test_adhesion_planes_equal_jax(kind):
    g = _geometry(kind)
    np.testing.assert_array_equal(geo_stack_sc3(g), jgeo_stack_sc3(g))
    mj, mt, _ = _sc_pair("k2_walls_force")
    np.testing.assert_array_equal(mt.adhesion.numpy(),
                                  np.asarray(mj.adhesion))


def test_pack_bf16_bit_for_bit():
    """The bf16 packs of a one-fluid and a three-fluid f64 state equal
    JAX's bit for bit, and unpack agrees."""
    g = _geometry("walls")
    mj = jf.SinglePhaseD3Q19(g, dtype=jnp.float64, use_pallas=False)
    mt = SinglePhaseD3Q19(g, dtype=torch.float64, device=CPU)
    f = _perturbed(SHAPE, 2)
    h = mt.pack_state_bf16(_t(f))
    np.testing.assert_array_equal(
        h.view(torch.int16).numpy(),
        np.asarray(mj.pack_state_bf16(jnp.asarray(f))).view(np.int16))
    _close(mt.unpack_bf16(h), mj.unpack_bf16(mj.pack_state_bf16(
        jnp.asarray(f))), 1e-15)
    mj, mt, _ = _sc_pair("k3")
    f = _perturbed(SHAPE, 3, 3)
    h = mt.pack_state_bf16(_t(f))
    np.testing.assert_array_equal(
        h.view(torch.int16).numpy(),
        np.asarray(mj.pack_state_bf16(jnp.asarray(f))).view(np.int16))
    _close(mt.unpack_bf16(h), mj.unpack_bf16(mj.pack_state_bf16(
        jnp.asarray(f))), 1e-15)


def _ini(tmp_path, name, edits):
    text = open(os.path.join(ROOT, "configs", name)).read()
    for old, new in edits.items():
        text, n = re.subn(rf"(?m)^{old}$", new, text)
        assert n == 1, old
    path = tmp_path / name
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("edits", [
    {}, {"Type = .*": "Type = 'TRT'", "TimeInterval = .*": ""},
    {"Type = .*": "Type = 'MRT'", "gValue = .*": "gValue = 3e-6"}],
    ids=["shipped", "trt_default_interval", "mrt_falls_back"])
def test_load_basic3d_equals_jax(tmp_path, edits):
    path = _ini(tmp_path, "basic3d.ini", edits)
    got, want = tconfig.load_basic3d(path), jconfig.load_basic3d(path)
    assert got[:2] == want[:2]
    assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])


@pytest.mark.parametrize("edits", [
    {}, {"NumberOfFluids = .*": "NumberOfFluids = 3",
         "FluidsTau = .*": "FluidsTau = 1.0, 0.8, 0.9",
         "interactionFluid = .*": "interactionFluid = 3.6, 2.0",
         "interactionSolid = .*": "interactionSolid = -0.3, 0.3, 0.0",
         "Option = .*": "Option = 'yes'", "forceZG = .*": "forceZG = -1e-6"}],
    ids=["shipped", "three_fluids_body_force"])
def test_load_shanchen3d_equals_jax(tmp_path, edits):
    path = _ini(tmp_path, "shanchen3d.ini", edits)
    got, want = tconfig.load_shanchen3d(path), jconfig.load_shanchen3d(path)
    assert type(got[0]).__name__ == type(want[0]).__name__
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
    assert got[1] == want[1] and got[3] == want[3]
    assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])


def test_paths_and_refusals():
    g = _geometry("walls")
    m = SinglePhaseD3Q19(g, collision="MRT", device=CPU)
    assert m.path == "plain" and m.kernel_params is None
    with pytest.raises(ValueError, match="kernel layout"):
        SinglePhaseD3Q19(g, collision="MRT", device=CPU, storage="bf16")
    with pytest.raises(ValueError, match="float32"):
        SinglePhaseD3Q19(g, dtype=torch.float64, device=CPU, storage="bf16")
    two = dict(g_matrix=((0.0, 3.6), (3.6, 0.0)), g_solid=(0.0, 0.0),
               tau=(1.0, 1.0))
    assert ShanChenMCMP3D(g, ShanChenParams3D(**two), device=CPU).path == \
        "plain"
    with pytest.raises(ValueError, match="kernel layout"):
        ShanChenMCMP3D(g, ShanChenParams3D(**two, psi="PR"), device=CPU,
                       storage="bf16")
    four = dict(g_matrix=tuple(tuple(0.0 for _ in range(4))
                               for _ in range(4)),
                g_solid=(0.0,) * 4, tau=(1.0,) * 4)
    # four fluids take the kernel (the runtime-K instance), bf16 storage too
    m4 = ShanChenMCMP3D(g, ShanChenParams3D(**four), device=CPU,
                        storage="bf16")
    assert m4.storage == "bf16" and m4.make_block_step(2) is not None
    with pytest.raises(ValueError, match="kernel layout"):
        ShanChenMCMP3D(g, ShanChenParams3D(**four, psi="PR"), device=CPU,
                       storage="bf16")
    with pytest.raises(ValueError, match="g_matrix"):
        ShanChenMCMP3D(g, ShanChenParams3D(g_matrix=((0.0,),), g_solid=(0.0,),
                                           tau=(1.0, 1.0)), device=CPU)


def test_sc3d_psi_is_rho_whatever_psi_says():
    """The JAX force uses psi = rho whatever ``psi`` names (flow3d.py:243);
    the port's plain step does the same: psi="PR" steps as psi="rho"."""
    mj, mt, f0 = _sc_pair("k2_walls_force")
    mpr = ShanChenMCMP3D(mt.geo, dataclasses.replace(mt.p, psi="PR"),
                         dtype=torch.float64, device=CPU)
    _close(mpr.step(_t(f0)), mt.step(_t(f0)), 0.0)


def test_chip_faults_patches_one_k10_line():
    """chip_faults.py plants its K10 fault (the adhesion term dropped in the
    float-arithmetic instances) by replacing one line of csrc/flow3d.cuh,
    which must stay there exactly once; phase 37 must fail it."""
    import chip_faults
    header, line, fault, phases = chip_faults.CASES["K10 adh f32"]
    with open(os.path.join(ROOT, "openlbmpm_torch", "csrc", header)) as f:
        assert f.read().count(line) == 1
    assert "sizeof(C) == 4 ? 0.0 : adh[d]" in fault and phases == ("37",)


def test_chip_faults_patches_one_k10_push_line():
    """chip_faults.py plants its K10 push fault (a value bounced back from a
    solid neighbour pushed into the cell's slot i, not opp(i), in the f32
    instance) by replacing one line of sc_push_kernel in csrc/flow3d.cuh,
    which must stay there exactly once; phases 36 and 37 must fail it."""
    import chip_faults
    header, line, fault, phases = chip_faults.CASES["K10 push target f32"]
    with open(os.path.join(ROOT, "openlbmpm_torch", "csrc", header)) as f:
        text = f.read()
    assert header == "flow3d.cuh" and text.count(line) == 1
    assert "p[(opp(i) - i) * (ptrdiff_t)n] = post" in line
    assert "sizeof(S) == 4 ? i : opp(i)" in fault
    assert phases == ("36", "37")
    assert set(phases) <= set(chip_faults.ALL_PHASES)


def test_chip_faults_patches_one_k11_push_line():
    """chip_faults.py plants its K11 push fault (a value bounced back from a
    solid neighbour pushed into the cell's slot i, not opp(i), in the f64
    instance) by replacing one line of single_push_kernel in
    csrc/flow3d.cuh, which must stay there exactly once; phase 33 must fail
    it while phases 36 (K10's push) and 53 (K11-T) pass."""
    import chip_faults
    header, line, fault, phases = chip_faults.CASES["K11 push target f64"]
    with open(os.path.join(ROOT, "openlbmpm_torch", "csrc", header)) as f:
        text = f.read()
    assert header == "flow3d.cuh" and text.count(line) == 1
    assert text.index("single_push_kernel(") < text.index(line) < \
        text.index("launch_single_push(")
    assert "sizeof(S) == 8 ? i : opp(i)" in fault and phases == ("33",)
    assert set(chip_faults.MUST_PASS["K11 push target f64"]) == {"36", "53"}
    assert set(phases) <= set(chip_faults.ALL_PHASES)


def test_chip_smoke_names_the_flow3d_step_kernels():
    """chip_smoke.py's phase 39 holds each K11 and K10 step to one launch of
    each kernel in FLOW3D_STEP_KERNELS and none of the others, by the
    libraries' counts: every name there is one that the libraries count,
    and each storage type of K10 and K11 launches a kernel that the other
    does not (sc_push_kernel, single_push_kernel; rho_kernel,
    march_kernel)."""
    import chip_smoke
    from openlbmpm_torch.kernels import flow3d as kf
    names = chip_smoke.FLOW3D_STEP_KERNELS
    assert {k for v in names.values() for ks in v.values() for k in ks} <= \
        set(kf.KERNELS) and set(kf.KERNELS) == set(
            chip_smoke.FLOW3D_KERNELS)
    assert names["K10"]["f32"] == ("sc_push_kernel",)
    assert names["K10"]["bf16"] == ("rho_kernel", "march_kernel")
    assert names["K11"]["f32"] == ("single_push_kernel",)
    assert names["K11"]["bf16"] == ("march_kernel",)


def test_chip_ab_sass_family_names_built_libraries():
    """chip_ab.py's "sass" family compares the kernels of SASS_LIBS between
    two checkouts: each is a library of csrc/ (K9, K9t, K10, K11 and their
    local forms, K11-T and K10-T), and its turn is valid Python; a renamed
    kernel stands beside the one it replaces (K11's push beside the
    one-fluid march_kernel of its storage type and collision, K11-T's march
    beside the brick-window kernel)."""
    import chip_ab
    from openlbmpm_torch.kernels import build
    assert set(chip_ab.SASS_LIBS) <= set(build.LIBRARIES)
    assert {"cg3d_f32", "cg3d_local_f32", "flow3d_bf16",
            "flow3d_local_f32", "flow3d_block_f32"} <= set(chip_ab.SASS_LIBS)
    other = {"12march_kernelIfLi1ELi1EfEEvPKT_PKhPKT2_PS1_12Flow3dParams": 0,
             "12march_kernelIfLi1ELi2EfEEvPKT_PKhPKT2_PS1_12Flow3dParams": 0,
             "19flow3d_block_kernelI13__nv_bfloat16Li0ELi1EfEEvPKT_PKhPS2_":
             0, "17sc3d_march_kernelIfLi2EEEvPKT_PKhPS1_": 0}
    assert chip_ab.partner("18single_push_kernelIfLi1EEEvPKT_PKhPS1_",
                           other) == \
        "12march_kernelIfLi1ELi1EfEEvPKT_PKhPKT2_PS1_12Flow3dParams"
    assert chip_ab.partner(
        "21single3d_march_kernelI13__nv_bfloat16Li0EEEvPKT_PKhPS2_",
        other) == "19flow3d_block_kernelI13__nv_bfloat16Li0ELi1EfEEvPKT_PKhPS2_"
    assert chip_ab.partner("17sc3d_march_kernelIfLi2EEEvPKT_PKhPS1_",
                           other) == "17sc3d_march_kernelIfLi2EEEvPKT_PKhPS1_"
    assert chip_ab.partner("18single_push_kernelIdLi1EEEvPKT_", other) is None
    compile(chip_ab.TURN_SASS, "sass turn", "exec")
    assert chip_ab.TURNS["sass"] is chip_ab.TURN_SASS
