"""The port's split (f_r, f_b) CSF step against the JAX package, on the CPU
at f64.

* the split boundary-row ops against their jnp ops on random fields
  (1e-12); a zero target density is refused;
* ``ColorGradientRK.step`` (plain) against the JAX model's un-jitted
  ``_step_impl``: 1e-12 for each of 4 steps along the JAX trajectory, SRT
  and MRT across the boundary combinations;
* ``tests/golden/csf_mini.npz`` reproduced to 1e-10 after 50 steps;
* one step against the JAX split path with its Pallas split kernel in
  interpret mode (1e-12);
* the compressed step equals the split step off the boundary rows;
* the CPU wrapper runs the plain version and counts nothing.

The CUDA kernel is checked on a card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openlbmpm_tpu import geometry as geo
from openlbmpm_tpu.models import colorgradient as jcg
from openlbmpm_tpu.ops import boundaries as jbc
from openlbmpm_torch.convert import params_from_jax
from openlbmpm_torch.kernels.csf import csf_step_split, csf_step_split_reference
from openlbmpm_torch.models.colorgradient import ColorGradientRK
from openlbmpm_torch.ops import boundaries as tbc

torch.set_num_threads(1)
CPU = "cpu"   # the port's models run on the card unless told otherwise

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "csf_mini.npz")
NY, NX = 12, 10


def _walled(ny, nx, obstacle=False):
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    if obstacle:
        solid[ny // 2 - 2:ny // 2 + 2, nx // 3:nx // 3 + 3] = True
    return geo.from_solid_mask(solid)


def _random_pdfs(seed):
    rng = np.random.default_rng(seed)
    f_r = rng.uniform(0.0, 0.2, (9, NY, NX))
    f_b = rng.uniform(0.0, 0.2, (9, NY, NX))
    f_r[:, 3, :2] = f_b[:, 3, :2] = 0.0          # an empty row piece
    mask = rng.random(NX) < 0.8
    return f_r, f_b, mask


@pytest.mark.parametrize("op,row", [
    ("total_velocity_inlet_top", NY - 2), ("total_velocity_inlet_top", 3),
    ("total_pressure_outlet_bottom", 1), ("total_pressure_outlet_bottom", 3),
    ("zou_he_pressure_top", NY - 2)])
def test_split_bc_op_matches_jnp_f64(op, row):
    """Tolerance 1e-12: the same formulas at f64 (the red fraction is read
    before the row is rewritten; rows with zero density take ratio 0)."""
    f_r, f_b, mask = _random_pdfs(row + len(op))
    if op == "zou_he_pressure_top":
        for f, rho_t in ((f_r, 1.02), (f_b, 0.03)):
            want = jbc.zou_he_pressure_top(jnp.asarray(f), rho_t, row,
                                           jnp.asarray(mask))
            got = tbc.zou_he_pressure_top(torch.from_numpy(f), rho_t, row,
                                          torch.from_numpy(mask))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-12)
        return
    arg = -0.01 if op == "total_velocity_inlet_top" else 1.01
    want = getattr(jbc, op)(jnp.asarray(f_r), jnp.asarray(f_b), arg, row,
                            jnp.asarray(mask))
    got = getattr(tbc, op)(torch.from_numpy(f_r), torch.from_numpy(f_b), arg,
                           row, torch.from_numpy(mask))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-12)


GOLDEN_PARAMS = jcg.ColorGradientParams(
    variant="CSF", collision="MRT", surface_tension=0.01, tau_r=1.0,
    tau_b=0.8, tau_type=2, wetting_type=2, contact_angle_deg=60.0)
GOLDEN_BCS = jcg.CGBoundaryConfig(
    inlet="neumann", outlet="dirichlet", inlet_velocity=-1e-4,
    outlet_density_r=0.0, outlet_density_b=1.0)
SRT = dataclasses.replace(GOLDEN_PARAMS, collision="SRT", tau_type=1,
                          tau_b=0.7, body_force=(1e-6, -1e-6))
DIR_CONV = jcg.CGBoundaryConfig(inlet="dirichlet", outlet="convective",
                                inlet_density_r=1.0005, inlet_density_b=2e-3)

# name -> (params, bcs, initial condition, obstacle)
STEP_CASES = {
    "mrt_neumann_dirichlet": (GOLDEN_PARAMS, GOLDEN_BCS, "layers", False),
    "srt_neumann_dirichlet": (SRT, GOLDEN_BCS, "layers", True),
    "mrt_dirichlet_convective": (GOLDEN_PARAMS, DIR_CONV, "layers", False),
    "srt_dirichlet_convective": (SRT, DIR_CONV, "layers", False),
    "mrt_neumann_convective": (
        GOLDEN_PARAMS, dataclasses.replace(GOLDEN_BCS, outlet="convective"),
        "layers", True),
    "srt_periodic_dirichlet_no_repair": (
        SRT, jcg.CGBoundaryConfig(outlet="dirichlet",
                                  phi_outlet_repair=False), "layers", False),
    "srt_periodic_droplet_xu": (
        dataclasses.replace(SRT, wetting_type=1, contact_angle_deg=75.0),
        jcg.CGBoundaryConfig(), "droplet", True),
}


def _models(params, bcs, ny=32, nx=20, obstacle=False, **jkw):
    g = _walled(ny, nx, obstacle)
    mj = jcg.ColorGradientRK(g, params, bcs, dtype=jnp.float64,
                             use_pallas=jkw.pop("use_pallas", False))
    mt = ColorGradientRK(g, params_from_jax(params), params_from_jax(bcs),
                         dtype=torch.float64, device=CPU)
    return mj, mt


def _init(m, kind):
    if kind == "layers":
        return m.init_state_layers(1.0, 1.0, invading_rows=m.geo.ny // 4)
    return m.init_state_droplet(1.0, 1.0, radius=6.0)


def _t(state):
    return tuple(torch.from_numpy(np.array(a)) for a in state)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_split_step_matches_jax_f64(case):
    """One step from the same state, four times along the JAX trajectory,
    to 1e-12 (un-jitted: XLA's fusion reassociates the f64 arithmetic)."""
    params, bcs, kind, obstacle = STEP_CASES[case]
    mj, mt = _models(params, bcs, obstacle=obstacle)
    sj = _init(mj, kind)
    for a, b in zip(_init(mt, kind), sj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    worst = 0.0
    for _ in range(4):
        st = mt.step(_t(sj))
        sj = mj._step_impl(*sj)
        worst = max(worst, *(float(np.abs(a.numpy() - np.asarray(b)).max())
                             for a, b in zip(st, sj)))
    assert worst < 1e-12


def test_golden_csf_mini_split_f64():
    """tests/test_golden.py::test_golden_csf_mini through the port's split
    step: 50 steps to the committed densities within 1e-10."""
    solid = np.zeros((48, 24), bool)
    solid[:, 0] = solid[:, -1] = True
    m = ColorGradientRK(geo.from_solid_mask(solid),
                        params_from_jax(GOLDEN_PARAMS),
                        params_from_jax(GOLDEN_BCS), dtype=torch.float64,
                        device=CPU)
    st = m.init_state_layers(1.0, 1.0, invading_rows=10)
    for _ in range(50):
        st = m.step(st)
    with np.load(GOLDEN) as z:
        np.testing.assert_allclose(st[0].sum(0).numpy(), z["rho_r"], rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(st[1].sum(0).numpy(), z["rho_b"], rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("case", ["mrt_neumann_dirichlet",
                                  "srt_dirichlet_convective"])
def test_split_step_matches_pallas_split_kernel_interpret_f64(case):
    """The JAX split step with its fused Pallas split kernel (the kernel
    the CUDA split kernel replaces), run in interpret mode: one step to
    1e-12 of the port's plain split step."""
    params, bcs, kind, obstacle = STEP_CASES[case]
    mj, mt = _models(params, bcs, ny=16, nx=16, obstacle=obstacle,
                     use_pallas="interpret")
    assert mj._fused is not None
    sj = _init(mj, kind)
    want = mj._step_impl(*sj)
    got = csf_step_split_reference(_t(sj), mt)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("case", ["mrt_neumann_dirichlet",
                                  "mrt_dirichlet_convective"])
def test_compressed_equals_split_off_bc_rows_f64(case):
    """One step of the compressed and the split step from the same state:
    the total PDF and rho_r agree to 1e-12 on every row the boundary rows
    cannot reach in one step (the phase-field stencils reach two rows, the
    streaming one more), and the two differ on the BC rows by design
    (DEVIATIONS.md, "Compressed (f_total, rho_r) state layout") when the
    per-colour inlet imposes what the total form cannot."""
    params, bcs, kind, obstacle = STEP_CASES[case]
    _, mt = _models(params, bcs)
    rng = np.random.default_rng(3)
    f_r, f_b = _init(mt, kind)
    noise = torch.from_numpy(rng.uniform(0.0, 1e-3, tuple(f_r.shape)))
    f_r, f_b = f_r + noise * mt.fluid_mask, f_b + noise * mt.fluid_mask
    a_r, a_b = mt.step((f_r, f_b))
    c = mt.step_c(mt.pack_state(f_r, f_b))
    split = mt.pack_state(a_r, a_b)
    ny = mt.geo.ny
    inner = slice(6, ny - 6)
    np.testing.assert_allclose(c[:, inner].numpy(), split[:, inner].numpy(),
                               rtol=0, atol=1e-12)
    if bcs.inlet == "dirichlet":
        assert float((c[:, ny - 3:] - split[:, ny - 3:]).abs().max()) > 1e-6


def test_zero_colour_density_inlet_refused():
    """A split Dirichlet inlet with a zero colour density is refused by the
    plain and the kernel path alike, with both JAX behaviours named; the
    compressed step (summed density) still runs."""
    bcs = dataclasses.replace(DIR_CONV, inlet_density_b=0.0)
    _, mt = _models(GOLDEN_PARAMS, bcs)
    st = mt.init_state_layers(1.0, 1.0, invading_rows=8)
    for fn in (mt.step, mt.plain_step, lambda s: csf_step_split(s, mt)):
        with pytest.raises(ValueError, match="NaN") as err:
            fn(st)
        assert "inject" in str(err.value) and "inlet_density_b = 0" in \
            str(err.value)
    assert bool(torch.isfinite(mt.step_c(mt.pack_state(*st))).all())
    with pytest.raises(ValueError, match="NaN"):
        tbc.zou_he_pressure_top(st[0], 0.0, mt.geo.ny - 2,
                                mt.is_fluid[mt.geo.ny - 2])


def test_zero_colour_density_jnp_reference_is_nan():
    """What the port refuses, on the jnp side: on a row where the colour
    is absent the jnp op divides 0 by 0 and writes NaN into f4, f7, f8."""
    f = np.zeros((9, NY, NX))
    mask = np.ones(NX, bool)
    out = np.asarray(jbc.zou_he_pressure_top(jnp.asarray(f), 0.0, NY - 2,
                                             jnp.asarray(mask)))
    assert np.isnan(out[[4, 7, 8], NY - 2]).all()
    assert not np.isnan(np.delete(out, NY - 2, axis=1)).any()


def test_zero_colour_density_pallas_split_kernel_injects_colour():
    """What the port refuses, on the Pallas side: the split kernel alone
    divides by 1 in place of the zero target and writes f4 = 2/3,
    f7 = f8 = 1/6 of the absent colour, so blue appears on inlet rows that
    held none (no NaN)."""
    from openlbmpm_tpu.pallas.csf import build_csf_fused_step
    bcs = dataclasses.replace(DIR_CONV, inlet_density_r=1.0,
                              inlet_density_b=0.0)
    mj, _ = _models(GOLDEN_PARAMS, bcs, ny=16, nx=16)
    f_r, f_b = _init(mj, "layers")
    assert float(jnp.abs(f_b[:, 12:]).max()) == 0.0
    kernel = build_csf_fused_step(mj.geo, mj.p, jnp.float64, bc_config=bcs,
                                  rows_per_block=8, interpret=True)
    out_b = np.asarray(kernel(f_r, f_b)[1])
    assert not np.isnan(out_b).any()
    assert out_b[:, 12:].sum() > 10.0


def test_macro_matches_jax_f64():
    mj, mt = _models(GOLDEN_PARAMS, GOLDEN_BCS)
    sj = _init(mj, "layers")
    for _ in range(3):
        sj = mj._step_impl(*sj)
    out_j = mj.macro(sj)
    out_t = mt.macro(_t(sj))
    for a, b in zip(list(out_j[:3]) + list(out_j[3]),
                    list(out_t[:3]) + list(out_t[3])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-12)


def test_split_wrapper_on_cpu_is_plain_and_uncounted():
    _, mt = _models(GOLDEN_PARAMS, GOLDEN_BCS)
    st = mt.init_state_layers(1.0, 1.0, invading_rows=8)
    before = csf_step_split.launches
    out = csf_step_split(st, mt)
    ref = csf_step_split_reference(st, mt)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert csf_step_split.launches == before
    with pytest.raises(ValueError, match="device"):
        csf_step_split((st[0], st[1].to("meta")), mt)
    with pytest.raises(ValueError, match="device"):
        csf_step_split((st[0].to("meta"), st[1].to("meta")), mt)
