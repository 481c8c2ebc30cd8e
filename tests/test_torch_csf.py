"""The port's compressed CSF model against the JAX package, on the CPU.

* ``ColorGradientRK.step_c`` of openlbmpm_torch against the JAX model's
  ``_step_impl_c`` (jnp path, f64): 1e-12 for one step from the same
  state, 1e-10 after 50 (20) steps of independent trajectories;
* ``macro_c`` against the JAX model's; the compressed step and coupled
  transport refuse what they have no form for.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openlbmpm_tpu import geometry as geo
from openlbmpm_tpu.models import colorgradient as jcg
from openlbmpm_torch.convert import params_from_jax
from openlbmpm_torch.models.colorgradient import ColorGradientRK

torch.set_num_threads(1)
CPU = "cpu"   # the port's models run on the card unless told otherwise


def _walled(ny, nx):
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    return geo.from_solid_mask(solid)


GOLDEN_PARAMS = jcg.ColorGradientParams(
    variant="CSF", collision="MRT", surface_tension=0.01, tau_r=1.0,
    tau_b=0.8, tau_type=2, wetting_type=2, contact_angle_deg=60.0)
GOLDEN_BCS = jcg.CGBoundaryConfig(
    inlet="neumann", outlet="dirichlet", inlet_velocity=-1e-4,
    outlet_density_r=0.0, outlet_density_b=1.0)

# name -> (params, bcs, initial condition, steps)
STEP_CASES = {
    # tests/test_golden.py's csf_mini setup on the compressed state
    "golden_mrt_neumann_dirichlet": (GOLDEN_PARAMS, GOLDEN_BCS, "layers", 50),
    "srt_periodic_droplet_xu": (
        jcg.ColorGradientParams(
            variant="CSF", collision="SRT", surface_tension=0.02, tau_r=1.0,
            tau_b=0.7, tau_type=1, wetting_type=1, contact_angle_deg=75.0,
            body_force=(0.0, -1e-6)),
        jcg.CGBoundaryConfig(), "droplet", 20),
    "mrt_dirichlet_convective": (
        dataclasses.replace(GOLDEN_PARAMS, tau_type=1, tau_b=1.2,
                            surface_tension=0.05),
        jcg.CGBoundaryConfig(inlet="dirichlet", outlet="convective",
                             inlet_density_r=1.0005, inlet_density_b=0.0),
        "layers", 20),
}


def _models(params, bcs, ny=48, nx=24):
    g = _walled(ny, nx)
    mj = jcg.ColorGradientRK(g, params, bcs, dtype=jnp.float64,
                             use_pallas=False)
    mt = ColorGradientRK(g, params_from_jax(params), params_from_jax(bcs),
                         dtype=torch.float64, device=CPU)
    return mj, mt


def _init(m, kind):
    if kind == "layers":
        return m.init_state_layers(1.0, 1.0, invading_rows=10)
    return m.init_state_droplet(1.0, 1.0, radius=7.0)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_matches_jax_f64(case):
    params, bcs, kind, steps = STEP_CASES[case]
    mj, mt = _models(params, bcs)
    sj = mj.pack_state(*_init(mj, kind))
    st = mt.pack_state(*_init(mt, kind))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    worst = 0.0
    for _ in range(steps):
        # un-jitted on purpose: XLA's fusion reassociates the f64 arithmetic,
        # and contact-line cells amplify that to ~1e-11 in one step
        one = mt.step_c(torch.from_numpy(np.array(sj)))
        sj = mj._step_impl_c(sj)
        st = mt.step_c(st)
        worst = max(worst, float(np.abs(one.numpy() - np.asarray(sj)).max()))
    assert worst < 1e-12
    assert bool(torch.isfinite(st).all())
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-10)


# name -> (parameter changes, boundary changes, what must raise)
REFUSALS = {
    "compressed_modified_periodic": ({}, {"outlet": "modified_periodic"},
                                     NotImplementedError),
    "compressed_convective_average": ({}, {"outlet": "convective_average"},
                                      NotImplementedError),
    "compressed_neumann_per_color": ({}, {"inlet": "neumann_per_color"},
                                     ValueError),
    "compressed_pert_neumann_per_color": (
        {"variant": "Perturbation"}, {"inlet": "neumann_per_color"},
        ValueError),
    "transport_perturbation": ({"variant": "Perturbation"}, {},
                               NotImplementedError),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals(case):
    """What the port refuses now that every colour-gradient option is
    ported: the compressed step refuses the boundaries that need the split
    state (NotImplementedError, as the JAX ``_step_impl_c``) and the
    per-colour velocity inlet (ValueError: the JAX compressed step applies
    no inlet row for it, see the next test), while the split step runs
    them; coupled transport refuses a Perturbation flow (its kernels are
    CSF-only)."""
    from openlbmpm_torch.models.transport import TransportRK
    change_p, change_b, exc = REFUSALS[case]
    p = params_from_jax(dataclasses.replace(GOLDEN_PARAMS, **change_p))
    b = params_from_jax(dataclasses.replace(GOLDEN_BCS, **change_b))
    g = _walled(16, 8)
    if case.startswith("transport"):
        with pytest.raises(exc, match="Perturbation"):
            TransportRK(g, p, boundaries=b, device=CPU)
        return
    m = ColorGradientRK(g, p, b, dtype=torch.float64, device=CPU)
    st = m.init_state_layers(1.0, 1.0, invading_rows=4)
    with pytest.raises(exc):
        m.step_c(m.pack_state(*st))
    with pytest.raises(exc):
        m.plain_step_c(m.pack_state(*st))
    out = m.step(st)
    assert all(bool(torch.isfinite(x).all()) for x in out)


def test_jax_compressed_step_applies_no_neumann_per_color_row():
    """Why the compressed step refuses neumann_per_color: the JAX
    ``_apply_bcs_c`` has no branch for it, so the JAX compressed step
    leaves rows ny-2 and ny-1 as they stand before the step (its result
    equals the step of a periodic-inlet model), while the split step
    rewrites them."""
    bcs = dataclasses.replace(GOLDEN_BCS, inlet="neumann_per_color",
                              inlet_velocity_r=-1e-3)
    g = _walled(16, 8)
    mj = jcg.ColorGradientRK(g, GOLDEN_PARAMS, bcs, dtype=jnp.float64,
                             use_pallas=False)
    mp = jcg.ColorGradientRK(g, GOLDEN_PARAMS,
                             dataclasses.replace(bcs, inlet="periodic"),
                             dtype=jnp.float64, use_pallas=False)
    st = mj.init_state_layers(1.0, 1.0, invading_rows=4)
    s = mj.pack_state(*st)
    np.testing.assert_array_equal(np.asarray(mj._apply_bcs_c(s)),
                                  np.asarray(s))
    np.testing.assert_array_equal(np.asarray(mj._step_impl_c(s)),
                                  np.asarray(mp._step_impl_c(s)))
    split = mj.pack_state(*mj._step_impl(*st))
    assert float(jnp.abs(split[:, 12:] - mp._step_impl_c(s)[:, 12:]).max()) \
        > 1e-6


def test_macro_c_matches_jax_f64():
    mj, mt = _models(GOLDEN_PARAMS, GOLDEN_BCS)
    s = mj.pack_state(*mj.init_state_layers(1.0, 1.0, invading_rows=10))
    for _ in range(3):
        s = mj._step_impl_c(s)
    out_j = mj.macro_c(s)
    out_t = mt.macro_c(torch.from_numpy(np.array(s)))
    flat_j = list(out_j[:3]) + list(out_j[3])
    flat_t = list(out_t[:3]) + list(out_t[3])
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("wetting_type", [1, 2])
def test_reference_rounding_sensitivity_by_wetting(wetting_type):
    """Why the CUDA kernel is held to plain at 1e-11 with Akai wetting but
    only to 1e-3 with Xu wetting (tests/test_torch_cuda.py): the JAX
    reference itself, started from a state moved by one ulp per value,
    departs by ~3e-4 under Xu (unit normals of rounding-noise gradients)
    and stays within rounding under Akai."""
    solid = np.zeros((72, 40), bool)
    solid[:, 0] = solid[:, -1] = True
    solid[33:39, 13:18] = True
    params = jcg.ColorGradientParams(
        variant="CSF", collision="SRT", surface_tension=0.01, tau_r=1.0,
        tau_b=0.7, tau_type=1, wetting_type=wetting_type,
        body_force=(1e-6, -1e-6))
    mj = jcg.ColorGradientRK(geo.from_solid_mask(solid), params,
                             jcg.CGBoundaryConfig(), dtype=jnp.float64,
                             use_pallas=False)
    a = mj.pack_state(*mj.init_state_layers(1.0, 1.0, invading_rows=14))
    sign = np.random.default_rng(0).choice([-1.0, 1.0], a.shape)
    b = a * (1 + jnp.asarray(sign) * 2.0 ** -52)
    for _ in range(2):
        a, b = mj._step_impl_c(a), mj._step_impl_c(b)
    gap = float(jnp.abs(a - b).max())
    if wetting_type == 1:
        assert gap > 1e-5
    else:
        assert gap < 1e-13
