"""K9's fields (``kernels/cg3d.py::cg3d_fields_reference``: the plain
version of ``csrc/cg3d.cuh::fields_kernel``) against the JAX package's
colour-gradient operators, on the CPU.

A D3Q19 CSF step is two launches (three with an inlet or outlet):
``fields_kernel`` forms g, the isotropic gradient of the phase field
extended onto solid cells and Akai-rotated on wetting fluid cells, and the
curvature kappa of the unit inward normals (0 off fluid), and
``collide_stream`` reads them.  Here the plain version, from a state after
its boundary slabs, is held at f64 (<= 1e-12) to the JAX ops
``phase_field``, ``solid_phi_extrapolate``, ``color_gradient``,
``rotate_gradient_on_wetting_akai_nd`` and ``csf_force_nd``
(``openlbmpm_tpu/ops/colorgrad.py``) on the same densities: walls with
Akai wetting, the velocity inlet with the convective and the pressure
outlet, an open periodic droplet (no wetting) and the grain pack of
configuration 5, in the compressed and the split layout (the split
layout's boundary slabs by the JAX model's ``_apply_inlet`` /
``_apply_outlet``).  The kernel is held to this plain version on the card
by ``chip_smoke.py`` phase 20.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import cg3d_case
from openlbmpm_tpu import geometry as jgeo
from openlbmpm_tpu.lattice import D3Q19 as JD3Q19
from openlbmpm_tpu.models import flow3d as jf
from openlbmpm_tpu.ops import colorgrad as jcg
from openlbmpm_torch.kernels import cg3d as K
from openlbmpm_torch.ops import macroscopic as mac

torch.set_num_threads(1)

CPU = "cpu"   # the port's models run on the card unless told otherwise
SHAPE = (16, 18, 14)
TOL = 1e-12
CASES = ["akai60_walls", "velocity_convective", "velocity_dirichlet",
         "periodic_droplet", "grain_pack"]


def _jax_model(m):
    p = jf.ColorGradientParams3D(**dataclasses.asdict(m.p))
    b = jf.CG3DBoundaryConfig(**dataclasses.asdict(m.bcs))
    return jf.ColorGradientRK3D(jgeo.from_solid_mask(m.geo.is_solid), p, b,
                                dtype=jnp.float64, use_pallas=False)


def _state(name):
    """The case's model and its split state after two plain steps (so that
    the interface has moved off the layers' planes)."""
    m, st = cg3d_case(name, CPU, shape=(16,) * 3 if name == "grain_pack"
                      else SHAPE)
    for _ in range(2):
        st = m.step(st)
    return m, st


def _jax_fields(jm, rho_r, rho_b):
    """(gx, gy, gz, kappa) by the JAX ops from the densities."""
    fl = jm.fluid_mask
    phi = jcg.phase_field(rho_r, rho_b) * fl
    if jm.has_wetting:
        phi = jcg.solid_phi_extrapolate(phi, jm.is_fluid, JD3Q19)
    g = jcg.color_gradient(phi, JD3Q19)
    if jm.has_wetting:
        g = jcg.rotate_gradient_on_wetting_akai_nd(g, jm.ns, jm.cos_t,
                                                   jm.sin_t, jm.wet_fluid)
    _, kappa = jcg.csf_force_nd(g, jm.p.surface_tension, jm.is_fluid,
                                inward_normal=True, lat=JD3Q19)
    return np.stack([np.asarray(c) for c in g] +
                    [np.asarray(jnp.where(jm.is_fluid, kappa, 0.0))])


@pytest.mark.parametrize("split", [False, True], ids=["compressed", "split"])
@pytest.mark.parametrize("name", CASES)
def test_fields_reference_matches_jax_ops(name, split):
    m, st = _state(name)
    jm = _jax_model(m)
    if split:
        got = K.cg3d_fields_reference(st, m)
        f_r, f_b = (jnp.asarray(t.numpy()) for t in st)
        f_r, f_b = jm._apply_outlet(*jm._apply_inlet(f_r, f_b))
        rho_r, rho_b = (jnp.asarray(mac.density(torch.from_numpy(
            np.array(f)), 3).numpy()) for f in (f_r, f_b))
    else:
        s = m.pack_state(*st)
        got = K.cg3d_fields_reference(s, m)
        post = m._post_slabs_c(s)
        rho_r = post[19]
        rho_b = mac.density(post[:19], 3) - rho_r
        rho_r, rho_b = jnp.asarray(rho_r.numpy()), jnp.asarray(rho_b.numpy())
    want = _jax_fields(jm, rho_r, rho_b)
    assert got.shape == (K.FIELD_PLANES, *m.geo.shape)
    assert float(np.abs(got.numpy() - want).max()) <= TOL
    # kappa is 0 off fluid, and the case has an interface to measure
    assert bool((got[3][~m.is_fluid] == 0).all())
    assert float(got[3].abs().max()) > 1e-3


def test_fields_wrapper_takes_the_plain_version_on_the_cpu_only():
    """``cg3d_fields`` of CPU tensors is the plain version and counts no
    launch; the launcher refuses CPU tensors rather than falling back."""
    m, st = _state("velocity_convective")
    s = m.pack_state(*st)
    K.cg3d_fields.launches = 0
    assert torch.equal(K.cg3d_fields(s, m), K.cg3d_fields_reference(s, m))
    assert torch.equal(K.cg3d_fields(st, m), K.cg3d_fields_reference(st, m))
    assert K.cg3d_fields.launches == 0
    geo = K.geo_stack3(m.geo).to(torch.float64)
    with pytest.raises(ValueError):
        K.launch_cg3d_fields(s, m.kernel_params, geo)
    with pytest.raises(ValueError):
        K.launch_cg3d_fields(st, m.kernel_params, geo)


def test_fields_of_the_step_are_what_the_step_collides_with():
    """The compressed plain step equals the collision and streaming of the
    state after its boundary slabs with the force built from the fields:
    g and kappa of ``cg3d_fields_reference`` are the step's own."""
    m, st = _state("akai60_walls")
    s = m.pack_state(*st)
    fields = K.cg3d_fields_reference(s, m)
    _, _, _, g, force = m._fields_from_densities(
        s[19], mac.density(s[:19], 3) - s[19])
    for d in range(3):
        assert torch.equal(fields[d], g[d])
        want = -0.5 * m.p.surface_tension * fields[3] * g[d] * m.fluid_mask
        assert float((force[d] - want).abs().max()) <= TOL


@pytest.mark.parametrize("tag", ["up", "f_up", "cs_up", "f_zrun_fz",
                                 "skip_phase", "skip_extend", "skip_normal",
                                 "skip_curvature", "f_32x8", "s_32x16",
                                 "cs_b1", "t_skip_collide", "t_skip_stream",
                                 "t_b1"])
def test_chip_sweep_k9_variants_patch_cg3d_once(tag, tmp_path):
    """chip_sweep.py's k9 mode times fields_kernel and collide_stream on
    copies of csrc/ with cg3d.cuh changed: each text it replaces stays in
    the source exactly once, and the copy differs from the source."""
    import chip_sweep
    from openlbmpm_torch.kernels import build
    src = (build.SRC_DIR / "cg3d.cuh").read_text()
    if tag in chip_sweep.K9_EDITS:
        old, _ = chip_sweep.K9_EDITS[tag]
        assert src.count(old) == 1
        dest = chip_sweep._k9_source(tmp_path / tag, {},
                                     chip_sweep.K9_EDITS[tag])
    else:
        dest = chip_sweep._k9_source(tmp_path / tag,
                                     chip_sweep.K9_VARIANTS[tag])
    assert (dest / "cg3d.cuh").read_text() != src
