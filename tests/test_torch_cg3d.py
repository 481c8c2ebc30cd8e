"""The port's D3Q19 CSF colour-gradient model (models/flow3d.py) and its
kernel module (kernels/cg3d.py) against the JAX package, on the CPU.

* ``ColorGradientRK3D.step`` (the plain split step) against the jnp
  ``ColorGradientRK3D`` step (``use_pallas=False``) in every case of
  ``chip_smoke.CG3D_CASES`` at 16^3, f64: one step from a common state to
  1e-12, 50 steps to 1e-10;
* layouts, macros, geometry planes, parameters, states and the INI reader
  across packages.

The plain steps against the Pallas kernels in interpret mode are in
``tests/test_torch_cg3d_pallas.py``.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import CG3D_CASES, cg3d_case, grain_pack, pore_grains
from openlbmpm_tpu import checkpoint as jck
from openlbmpm_tpu import config as jconfig
from openlbmpm_tpu import geometry as jgeo
from openlbmpm_tpu.models import flow3d as jf
from openlbmpm_tpu.pallas.cg3d import geo_stack3 as jgeo_stack3
from openlbmpm_torch import checkpoint as tck
from openlbmpm_torch import config as tconfig
from openlbmpm_torch.convert import (params_from_jax, state_from_numpy,
                                     state_to_numpy)
from openlbmpm_torch.kernels import cg3d as K
from openlbmpm_torch.models.flow3d import (CG3DBoundaryConfig,
                                           ColorGradientParams3D,
                                           ColorGradientRK3D)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

CPU = "cpu"   # the port's models run on the card unless told otherwise
SHAPE = (16, 16, 16)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _gap(a, b):
    return max(float(np.abs(_np(x) - _np(y)).max()) for x, y in zip(a, b))


def _jax_model(m, dtype=jnp.float64):
    """The JAX package's ColorGradientRK3D on the port model's geometry and
    parameters (jnp step)."""
    p = jf.ColorGradientParams3D(**dataclasses.asdict(m.p))
    b = jf.CG3DBoundaryConfig(**dataclasses.asdict(m.bcs))
    return jf.ColorGradientRK3D(jgeo.from_solid_mask(m.geo.is_solid), p, b,
                                dtype=dtype, use_pallas=False)


@pytest.mark.parametrize("name", sorted(CG3D_CASES))
def test_split_step_matches_jax_step(name):
    """The grain pack is held to the un-jitted ``_step_impl``: on it the JAX
    package's jitted and un-jitted steps themselves part by 1e-9 within 50
    steps (the periodic z seam, where |g| = 1 meets noise gradients near
    the 1e-8 normal threshold, amplifies one-ulp differences; ROADMAP §3),
    while the port stays within 2.4e-12 of the un-jitted step."""
    m, st = cg3d_case(name, CPU, shape=SHAPE)
    jm = _jax_model(m)
    js = tuple(jnp.asarray(_np(t)) for t in st)
    eager = name == "grain_pack"
    for k in range(50):
        st = m.step(st)
        if eager:
            with jax.disable_jit():
                js = jm._step_impl(*js)
        else:
            js = jm.step(js)
        if k == 0:
            assert _gap(st, js) <= 1e-12, name
    assert all(bool(torch.isfinite(t).all()) for t in st)
    assert _gap(st, js) <= 1e-10, name


@pytest.mark.parametrize("background", [0.0, 0.3])
def test_compressed_and_split_slabs_part_on_a_mixed_inlet(background):
    """The compressed step moves rho_r by the inlet slab's red fraction of
    the NEBB change of the total PDF, the split step splits the new values
    by that fraction: the two agree where the slab holds one phase or its
    colour PDFs are proportional (the equilibrium start), and part where it
    is mixed (a red region holding blue at density 0.3; f64, 16^3, one step
    from the state after five split steps; ROADMAP section 3)."""
    m, _ = cg3d_case("velocity_convective", CPU, shape=SHAPE)
    st = m.init_state_layers(1.0, 1.0, invading_slabs=6,
                             background=background)
    first = (m.pack_state(*m.step(st)) - m.step_c(m.pack_state(*st)))
    assert float(first.abs().max()) <= 1e-12
    for _ in range(5):
        st = m.step(st)
    gap = float((m.pack_state(*m.step(st)) -
                 m.step_c(m.pack_state(*st))).abs().max())
    if background:
        assert gap > 1e-2
    else:
        assert gap < 1e-5


def test_layouts_equal_jax_bit_for_bit():
    """pack_state, pack_state_bf16 and unpack_bf16 (f32) give JAX's bits."""
    m, st = cg3d_case("velocity_convective", CPU, shape=SHAPE,
                      dtype=torch.float32)
    st = m.step(st)
    jm = _jax_model(m, jnp.float32)
    js = tuple(jnp.asarray(_np(t)) for t in st)
    pairs = [(m.pack_state(*st), jm.pack_state(*js)),
             (m.pack_state_bf16(*st), jm.pack_state_bf16(*js))]
    pairs.append((m.unpack_bf16(pairs[1][0]), jm.unpack_bf16(pairs[1][1])))
    for got, want in pairs:
        got, want = state_to_numpy(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("name", ["akai60_walls", "grain_pack"])
def test_macro_and_macro_compressed_equal_jax(name):
    m, st = cg3d_case(name, CPU, shape=SHAPE)
    st = m.step(st)
    jm = _jax_model(m)
    js = tuple(jnp.asarray(_np(t)) for t in st)
    for got, want in ((m.macro(st), jm.macro(js)),
                      (m.macro_compressed(m.pack_state(*st)),
                       jm.macro_compressed(jm.pack_state(*js)))):
        flat_g = [got[0], got[1], got[2], *got[3]]
        flat_w = [want[0], want[1], want[2], *want[3]]
        assert _gap(flat_g, flat_w) <= 1e-12


@pytest.mark.parametrize("name", ["droplet", "layers"])
def test_initial_states_equal_jax(name):
    m, _ = cg3d_case("akai60_walls", CPU, shape=SHAPE)
    jm = _jax_model(m)
    if name == "droplet":
        got = m.init_state_droplet(1.0, 0.9, radius=4.0, background=0.01)
        want = jm.init_state_droplet(1.0, 0.9, radius=4.0, background=0.01)
    else:
        got = m.init_state_layers(1.0, 0.9, invading_slabs=5)
        want = jm.init_state_layers(1.0, 0.9, invading_slabs=5)
    assert _gap(got, want) == 0.0


def test_geometry_planes_and_kernel_params():
    """geo_stack3 gives the Pallas kernel's planes bit for bit; the
    parameter block carries the model's numbers."""
    solid = grain_pack(24)
    from openlbmpm_torch.geometry import from_solid_mask
    g = from_solid_mask(solid)
    np.testing.assert_array_equal(K.geo_stack3(g).numpy(),
                                  jgeo_stack3(jgeo.from_solid_mask(solid)))
    p = ColorGradientParams3D(**CG3D_CASES["grain_pack"][0],
                              body_force=(1e-6, 2e-6, -3e-6))
    b = CG3DBoundaryConfig(inlet="velocity", outlet="dirichlet",
                           inlet_velocity=-2e-3, outlet_density=1.01)
    kp = K.kernel_params(p, b, g)
    assert (kp.nz, kp.ny, kp.nx, kp.inlet, kp.outlet, kp.has_wetting,
            kp.tau_type) == (24, 24, 24, 1, 2, 1, 2)
    assert (kp.bfx, kp.bfy, kp.bfz) == (1e-6, 2e-6, -3e-6)
    assert kp.cos_t == pytest.approx(-np.cos(np.radians(45.0)), abs=1e-15)
    assert (kp.inlet_vz, kp.outlet_rho) == (-2e-3, 1.01)
    with pytest.raises(NotImplementedError, match="domain"):
        K.kernel_params(p, b, from_solid_mask(np.zeros((6, 8, 8), bool)))


@pytest.mark.parametrize("seed", [0, 1])
def test_geometry_planes_of_random_solids(seed):
    """geo_stack3 equals the Pallas kernel's planes bit for bit on random
    solids (isolated solid cells, fluid cells without fluid neighbours,
    wrap-around) of an uneven shape."""
    from openlbmpm_torch.geometry import from_solid_mask
    solid = np.random.default_rng(seed).random((9, 7, 11)) < 0.45
    np.testing.assert_array_equal(
        K.geo_stack3(from_solid_mask(solid)).numpy(),
        jgeo_stack3(jgeo.from_solid_mask(solid)))


def test_chip_faults_patches_one_kernel_line():
    """chip_faults.py plants its faults by replacing one line of
    csrc/cg3d.cuh, which must stay there exactly once."""
    import chip_faults
    with open(os.path.join(ROOT, "openlbmpm_torch", "csrc", "cg3d.cuh")) as f:
        assert f.read().count(chip_faults.LINE) == 1
    k9 = {name: case for name, case in chip_faults.CASES.items()
          if case[1] == chip_faults.LINE}
    assert k9 == {name: ("cg3d.cuh", chip_faults.LINE,
                         chip_faults.FAULT.format(size=size), ("21",))
                  for name, size in (("f32", 4), ("bf16", 2))}


def test_grain_pack_equals_the_png_route(tmp_path):
    """chip_smoke's numpy grain pack is the cross-section that
    benchmarks/bench_cg3d.py writes as a PNG and reads back."""
    pytest.importorskip("matplotlib")
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    import bench_cg3d
    png = str(tmp_path / "pores.png")
    bench_cg3d.make_pore_png(png, n=128)
    solid2d = jgeo.load_structure_image(png, threshold=0.5)
    pad = [(0, max(128 - k, 0)) for k in solid2d.shape]
    solid2d = np.pad(solid2d, pad)[:128, :128]
    np.testing.assert_array_equal(pore_grains(128), solid2d)
    np.testing.assert_array_equal(
        grain_pack(128), jgeo.extrude_image_3d(solid2d, 128, buffer_slabs=8))
    assert 0.2 < float((~grain_pack(128)).mean()) < 0.9


def test_params_and_states_cross_from_jax():
    p = jf.ColorGradientParams3D(tau_r=1.1, body_force=(0.0, 1e-6, -2e-6))
    b = jf.CG3DBoundaryConfig(inlet="velocity", outlet="convective",
                              inlet_velocity=-2e-3)
    got_p, got_b = params_from_jax(p), params_from_jax(b)
    assert type(got_p) is ColorGradientParams3D
    assert type(got_b) is CG3DBoundaryConfig
    assert dataclasses.asdict(got_p) == dataclasses.asdict(p)
    assert dataclasses.asdict(got_b) == dataclasses.asdict(b)
    m, st = cg3d_case("velocity_convective", CPU, shape=SHAPE,
                      dtype=torch.float32)
    jm = _jax_model(m, jnp.float32)
    js = tuple(jnp.asarray(_np(t)) for t in st)
    for arr in (np.asarray(jm.pack_state(*js)),
                np.asarray(jm.pack_state_bf16(*js))):
        t = state_from_numpy(arr, device=CPU)
        assert t.dtype == (torch.bfloat16 if arr.shape[0] == 21
                           else torch.float32)
        back = state_to_numpy(t)
        np.testing.assert_array_equal(back.view(np.uint8), arr.view(np.uint8))


CG3D_INI = os.path.join(ROOT, "configs", "rk_csf3d.ini")


@pytest.mark.parametrize("variant", ["shipped", "convective", "freeflux",
                                     "periodic"])
def test_load_colorgradient3d_equals_jax(tmp_path, variant):
    text = open(CG3D_INI).read()
    if variant in ("convective", "freeflux"):
        text = text.replace("BoundaryTypeOutlet = 'Dirichlet'",
                            f"BoundaryTypeOutlet = '{variant.capitalize()}'"
                            "\nOutletDensity = 1.02")
    if variant == "periodic":
        text = text.replace("velocityZB = -1.0e-4", "velocityZB = 0.0")
    path = tmp_path / "cg3d.ini"
    path.write_text(text)
    got = tconfig.load_colorgradient3d(str(path))
    want = jconfig.load_colorgradient3d(str(path))
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
    assert got[1] == want[1]
    assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])
    extras_g, extras_w = dict(got[3]), dict(want[3])
    assert dataclasses.asdict(extras_g.pop("bcs")) == \
        dataclasses.asdict(extras_w.pop("bcs"))
    assert extras_g == extras_w
    for layout in ("split", "packed"):
        fp = {"params": dataclasses.asdict(got[0]), "state_layout": layout}
        assert tck.config_fingerprint(fp) == jck.config_fingerprint(
            {"params": dataclasses.asdict(want[0]), "state_layout": layout})


def test_model_refusals_and_cuda_default():
    from openlbmpm_torch.geometry import from_solid_mask
    g = from_solid_mask(np.zeros((8, 4, 4), bool))
    p = ColorGradientParams3D()
    with pytest.raises(ValueError, match="inlet"):
        ColorGradientRK3D(g, p, CG3DBoundaryConfig(inlet="pressure"),
                          device=CPU)
    with pytest.raises(ValueError, match="bf16"):
        ColorGradientRK3D(g, p, dtype=torch.float64, device=CPU,
                          storage="bf16")
    m = ColorGradientRK3D(g, p, device=CPU)
    assert m.path == "plain"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ColorGradientRK3D(g, p)
