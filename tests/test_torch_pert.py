"""The port's Perturbation variant and the colour-gradient boundaries it
brings against the JAX package, on the CPU at f64.

* ``ColorGradientRK.step`` (plain) against the JAX model's un-jitted
  ``_step_perturbation`` and ``step_c`` against ``_step_pert_c``, over the
  cases of ``chip_smoke.PERT_CASES`` (phase 40's): 1e-12 after each step
  from the JAX state, 1e-10 after 20 steps of independent trajectories;
* the same plain steps against the JAX model with its Pallas K4 (the
  kernel the CUDA K4 replaces) in interpret mode, split and compressed,
  one step to 1e-12;
* the neumann_per_color inlet, the convective_average outlet and the
  modified_periodic seam, with the CSF and the Perturbation variant,
  against the JAX split step (four steps to 1e-12);
* ``macro``/``macro_c`` (u with the CSF half-force, as JAX), the RK
  start, ``params_from_jax``, and the paths the model takes.

The CUDA kernel is held to these plain steps on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phases 40-41.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import PERT_CASES, pert_fields, pert_start
from openlbmpm_tpu import geometry as geo
from openlbmpm_tpu.models import colorgradient as jcg
from openlbmpm_torch.convert import params_from_jax
from openlbmpm_torch.kernels.csf import (
    pert_step_compressed, pert_step_compressed_reference, pert_step_split,
    pert_step_split_reference)
from openlbmpm_torch.models.colorgradient import ColorGradientRK

torch.set_num_threads(1)
CPU = "cpu"   # the port's models run on the card unless told otherwise


def _walled(ny, nx):
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    return geo.from_solid_mask(solid)


def _models(pf, bf, ny=48, nx=24, **jkw):
    """The JAX model (jnp path unless `use_pallas` is given) and the port's
    plain model of the parameter and boundary fields."""
    g = _walled(ny, nx)
    jp, jb = jcg.ColorGradientParams(**pf), jcg.CGBoundaryConfig(**bf)
    mj = jcg.ColorGradientRK(g, jp, jb, dtype=jnp.float64,
                             use_pallas=jkw.get("use_pallas", False))
    mt = ColorGradientRK(g, params_from_jax(jp), params_from_jax(jb),
                         dtype=torch.float64, device=CPU)
    return mj, mt


def _t(state):
    return tuple(torch.from_numpy(np.array(a)) for a in state)


def _gap(a, b):
    if isinstance(a, tuple):
        return max(_gap(x, y) for x, y in zip(a, b))
    return float(np.abs(a.numpy() - np.asarray(b)).max())


@pytest.mark.parametrize("case", sorted(PERT_CASES))
def test_split_step_matches_jax_f64(case):
    """step against the un-jitted ``_step_perturbation`` (XLA's fusion
    reassociates the f64 arithmetic): each step from the JAX state to
    1e-12, the independent trajectories to 1e-10."""
    mj, mt = _models(*pert_fields(case))
    _, _, kind, steps = PERT_CASES[case]
    sj = pert_start(mj, kind)
    st = pert_start(mt, kind)
    assert _gap(st, sj) == 0.0
    worst = 0.0
    for _ in range(steps):
        worst = max(worst, _gap(mt.step(_t(sj)), mj._step_impl(*sj)))
        sj = mj._step_impl(*sj)
        st = mt.step(st)
    assert worst < 1e-12
    assert all(bool(torch.isfinite(x).all()) for x in st)
    assert _gap(st, sj) < 1e-10


@pytest.mark.parametrize("case", sorted(c for c in PERT_CASES
                                        if "percolor" not in c))
def test_compressed_step_matches_jax_f64(case):
    """step_c against the un-jitted ``_step_pert_c``: 1e-12 a step, 1e-10
    over the trajectory."""
    mj, mt = _models(*pert_fields(case))
    _, _, kind, steps = PERT_CASES[case]
    sj = mj.pack_state(*pert_start(mj, kind))
    st = mt.pack_state(*pert_start(mt, kind))
    worst = 0.0
    for _ in range(steps):
        nxt = mj._step_impl_c(sj)
        worst = max(worst, _gap(mt.step_c(torch.from_numpy(np.array(sj))),
                                nxt))
        sj = nxt
        st = mt.step_c(st)
    assert worst < 1e-12
    assert bool(torch.isfinite(st).all())
    assert _gap(st, sj) < 1e-10


@pytest.mark.parametrize("layout", ["split", "compressed"])
def test_plain_steps_match_pallas_k4_interpret_f64(layout):
    """The JAX model with its fused Pallas K4 in interpret mode (T=1; the
    model applies the jnp BC rows first): one step to 1e-12 of the port's
    plain step, MRT with the Neumann inlet and Dirichlet outlet."""
    mj, mt = _models(*pert_fields("mrt_iso_neumann_dirichlet"), ny=16,
                     nx=16, use_pallas="interpret")
    st = pert_start(mj, "layers")
    if layout == "split":
        assert mj._fused is not None
        want = mj._step_impl(*st)
        got = pert_step_split_reference(_t(st), mt)
    else:
        assert mj._fused_c is not None
        s = mj.pack_state(*st)
        want = mj._step_impl_c(s)
        got = pert_step_compressed_reference(torch.from_numpy(np.array(s)),
                                             mt)
    assert _gap(got, want) < 1e-12


_CSF = dict(variant="CSF", collision="MRT", surface_tension=0.01,
            tau_b=0.8, tau_type=2, wetting_type=2)
BOUNDARY_CASES = {
    "percolor_convective_average": dict(
        inlet="neumann_per_color", outlet="convective_average",
        inlet_velocity_r=-1e-3, inlet_velocity_b=-2e-4),
    "neumann_modified_periodic": dict(inlet="neumann",
                                      outlet="modified_periodic",
                                      inlet_velocity=-1e-4),
    "periodic_modified_periodic": dict(outlet="modified_periodic"),
    "dirichlet_convective_average": dict(
        inlet="dirichlet", outlet="convective_average",
        inlet_density_r=1.0005, inlet_density_b=2e-3),
}


@pytest.mark.parametrize("variant", ["CSF", "Perturbation"])
@pytest.mark.parametrize("case", sorted(BOUNDARY_CASES))
def test_boundaries_match_jax_split_f64(case, variant):
    """The per-colour velocity inlet, the averaged convective outlet and
    the modified periodic seam on the split state, one step from the JAX
    state four times to 1e-12; the model's path is "plain" on every device
    for the last two, as the JAX package keeps them off its kernel."""
    pf = _CSF if variant == "CSF" else pert_fields(
        "mrt_iso_neumann_dirichlet")[0]
    mj, mt = _models(pf, BOUNDARY_CASES[case], ny=32, nx=20)
    assert mt.path == "plain"
    assert (mt.kernel_params is None) == (mt.bcs.outlet in (
        "convective_average", "modified_periodic"))
    sj = mj.init_state_layers(1.0, 1.0, invading_rows=8)
    worst = 0.0
    for _ in range(4):
        st = mt.step(_t(sj))
        sj = mj._step_impl(*sj)
        worst = max(worst, _gap(st, sj))
    assert worst < 1e-12


def test_boundaries_change_the_rows():
    """The seam swap and the averaged outlet are not no-ops: against the
    periodic and the plain convective outlet, one step moves the boundary
    rows by more than 1e-8."""
    pf = pert_fields("mrt_iso_neumann_dirichlet")[0]
    base = {}
    for outlet in ("periodic", "modified_periodic", "convective",
                   "convective_average"):
        _, mt = _models(pf, dict(inlet="neumann", outlet=outlet,
                                 inlet_velocity=-1e-3), ny=32, nx=20)
        st = mt.init_state_layers(1.0, 1.0, invading_rows=8)
        for _ in range(3):
            st = mt.step(st)
        base[outlet] = torch.cat(st)
    for a, b in (("periodic", "modified_periodic"),
                 ("convective", "convective_average")):
        assert float((base[a] - base[b]).abs().max()) > 1e-8


@pytest.mark.parametrize("layout", ["split", "compressed"])
def test_macro_matches_jax_f64(layout):
    """``macro``/``macro_c`` of a Perturbation model report u with the CSF
    half-force, as the JAX ones do (ROADMAP section 3)."""
    mj, mt = _models(*pert_fields("mrt_iso_neumann_dirichlet"))
    sj = mj.init_state_layers(1.0, 1.0, invading_rows=10)
    for _ in range(3):
        sj = mj._step_impl(*sj)
    if layout == "split":
        out_j, out_t = mj.macro(sj), mt.macro(_t(sj))
    else:
        s = mj.pack_state(*sj)
        out_j = mj.macro_c(s)
        out_t = mt.macro_c(torch.from_numpy(np.array(s)))
    for a, b in zip(list(out_j[:3]) + list(out_j[3]),
                    list(out_t[:3]) + list(out_t[3])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("kind", ["layers", "droplet"])
def test_rk_start_and_params_match_jax(kind):
    """The RK-original start (feq of the C_i at rest) and the converted
    parameters equal JAX's, at unequal alphas."""
    pf, bf = pert_fields("mrt_alpha_r_ne_alpha_b")
    mj, mt = _models(pf | {"gradient_type": "Anisotropic"}, bf)
    assert dataclasses.asdict(mt.p) == dataclasses.asdict(mj.p)
    assert dataclasses.asdict(mt.bcs) == dataclasses.asdict(mj.bcs)
    np.testing.assert_array_equal(mt.const_cb, mj.const_cb)
    np.testing.assert_array_equal(mt._grad_scheme, mj._grad_scheme)
    assert _gap(pert_start(mt, kind), pert_start(mj, kind)) == 0.0


def test_wrappers_on_cpu_are_plain_and_uncounted():
    """A CPU state takes the plain version and counts no launch; a CSF
    model is refused by the K4 wrappers on a card's tensors only, and a
    meta tensor has no kernel."""
    _, mt = _models(*pert_fields("mrt_iso_neumann_dirichlet"), ny=16, nx=8)
    st = mt.init_state_layers(1.0, 1.0, invading_rows=4)
    before = (pert_step_split.launches, pert_step_compressed.launches)
    for a, b in zip(pert_step_split(st, mt), pert_step_split_reference(st,
                                                                       mt)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    s = mt.pack_state(*st)
    np.testing.assert_array_equal(pert_step_compressed(s, mt).numpy(),
                                  pert_step_compressed_reference(s,
                                                                 mt).numpy())
    assert (pert_step_split.launches, pert_step_compressed.launches) == \
        before
    with pytest.raises(ValueError, match="device"):
        pert_step_split((st[0].to("meta"), st[1].to("meta")), mt)
    with pytest.raises(ValueError, match="device"):
        pert_step_compressed(s.to("meta"), mt)
