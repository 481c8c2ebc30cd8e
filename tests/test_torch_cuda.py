"""The CUDA kernels of openlbmpm_torch against their plain PyTorch versions.

Needs a CUDA card and nvcc; skips without a card.  This file imports no
JAX, so it also runs on a GPU machine without it, skipping the repository's
conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (BF16_BOUND, CG3D_CASES, CG3D_TRANSPORT_CASES,
                        COUPLED_CASES,
                        FLOW3D_BF16_SHARE, PERT_CASES, SC3D_CASES, SC_CASES,
                        SC_KERNEL_CASES, SINGLE3D_CASES, SINGLE_BF16_SHARE,
                        SINGLE_CASES, basic3d_model, bf16_one_step_3d,
                        bf16_ulp_check, cg3d_case, config1_model,
                        coupled_conc0, flagship_flow, flow_start,
                        pert_case, pert_start, probe_sc3d_model,
                        probe_sc3d_start, sc3d_case,
                        sc_case, sc_config, single3d_case, single_case,
                        split_cases, split_coupled_cases, transport3d_case)
from openlbmpm_torch.geometry import from_solid_mask
from openlbmpm_torch.kernels.cg3d import (
    cg3d_step_compressed, cg3d_step_compressed_reference, cg3d_step_split,
    cg3d_step_split_reference, coupled3d_step_compressed,
    coupled3d_step_compressed_reference)
from openlbmpm_torch.kernels.csf import (
    compare_bf16_states, csf_step_compressed, csf_step_compressed_reference,
    csf_step_split, csf_step_split_reference, pert_step_compressed,
    pert_step_compressed_reference, pert_step_split,
    pert_step_split_reference)
from openlbmpm_torch.kernels.flow3d import (sc3d_step, sc3d_step_reference,
                                            single3d_step,
                                            single3d_step_reference)
from openlbmpm_torch.kernels.shanchen import sc_step, sc_step_reference
from openlbmpm_torch.kernels.single import single_step, single_step_reference
from openlbmpm_torch.kernels.transport import (
    coupled_step_compressed, coupled_step_compressed_reference,
    coupled_step_split, coupled_step_split_reference)
from openlbmpm_torch.models.colorgradient import (
    CGBoundaryConfig, ColorGradientParams, ColorGradientRK)
from openlbmpm_torch.models.flow3d import (ShanChenMCMP3D, ShanChenParams3D,
                                           SinglePhaseD3Q19)
from openlbmpm_torch.models.single_phase import SinglePhaseD2Q9
from openlbmpm_torch.models.transport import TransportParams, TransportRK

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _geometry(ny, nx, obstacle=False):
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    if obstacle:
        solid[ny // 2 - 3:ny // 2 + 3, nx // 3:nx // 3 + 5] = True
    return from_solid_mask(solid)


MRT = ColorGradientParams(collision="MRT", surface_tension=0.01, tau_r=1.0,
                          tau_b=0.8, tau_type=2, wetting_type=2)
NEU_DIR = CGBoundaryConfig(inlet="neumann", outlet="dirichlet",
                           inlet_velocity=-1e-4)

# name -> (params, boundaries, obstacle); every case starts from red layers
# on top of blue, so contact lines sit on both walls
CASES = {
    "mrt_tau2_akai_neumann_dirichlet": (MRT, NEU_DIR, False),
    "mrt_matched_tau_obstacle": (
        dataclasses.replace(MRT, tau_b=1.0, surface_tension=0.1), NEU_DIR,
        True),
    "srt_tau1_periodic_body_force": (
        dataclasses.replace(MRT, collision="SRT", tau_type=1, tau_b=0.7,
                            body_force=(1e-6, -1e-6)),
        CGBoundaryConfig(), True),
    "mrt_tau1_dirichlet_convective_no_repair": (
        dataclasses.replace(MRT, tau_type=1, tau_b=1.2),
        CGBoundaryConfig(inlet="dirichlet", outlet="convective",
                         inlet_density_r=1.0005, inlet_density_b=0.0),
        False),
    "srt_dirichlet_outlet_repair_off": (
        dataclasses.replace(MRT, collision="SRT"),
        dataclasses.replace(NEU_DIR, phi_outlet_repair=False), False),
}


def _state(m, bf16=False):
    f = m.init_state_layers(1.0, 1.0, invading_rows=m.geo.ny // 5)
    return m.pack_state_bf16(*f) if bf16 else m.pack_state(*f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_f64(cuda, case):
    params, bcs, obstacle = CASES[case]
    m = ColorGradientRK(_geometry(72, 40, obstacle), params, bcs,
                        dtype=torch.float64, device=cuda)
    a = _state(m)
    b = a.clone()
    for _ in range(10):
        a = csf_step_compressed(a, m)
        b = csf_step_compressed_reference(b, m)
    torch.cuda.synchronize(cuda)
    assert bool(torch.isfinite(a).all())
    assert float((a - b).abs().max()) <= 1e-11


def test_kernel_xu_wetting_tracks_plain_f64(cuda):
    """Xu wetting (wetting_type 1) normalises every nonzero gradient: the
    bulk's ~1e-17 rounding-noise gradients get unit normals whose direction
    depends on summation order (and on FMA contraction), which moves the
    curvature of the interface cells beside them.  Two implementations
    cannot agree there to rounding, so this case is held to 1e-3 (9e-5
    measured on an H100 after 10 steps), and to at most 10x the gap the
    plain path itself opens when its start state is moved by one ulp per
    value.  Akai wetting, which drops gradients below 1e-8, is held to
    1e-11 above."""
    params = dataclasses.replace(MRT, collision="SRT", tau_type=1,
                                 wetting_type=1, tau_b=0.7,
                                 body_force=(1e-6, -1e-6))
    m = ColorGradientRK(_geometry(72, 40, True), params, CGBoundaryConfig(),
                        dtype=torch.float64, device=cuda)
    a = _state(m)
    b = a.clone()
    sign = torch.from_numpy(np.random.default_rng(0).choice(
        [-1.0, 1.0], tuple(a.shape))).to(cuda)
    c = a * (1 + sign * 2.0 ** -52)
    for _ in range(10):
        a = csf_step_compressed(a, m)
        b = csf_step_compressed_reference(b, m)
        c = csf_step_compressed_reference(c, m)
    assert bool(torch.isfinite(a).all())
    gap = float((a - b).abs().max())
    witness = float((c - b).abs().max())
    assert gap <= 1e-3
    assert gap <= 10 * witness


def _off_seam(ny, nx, steps, device):
    """Cells away from the inlet/outlet seam rows (0, 1, ny-2, ny-1) and
    from the corners where the seam meets the wetting walls: there f32
    wetting tie-breaks flip under 1-ulp differences (chip_smoke.py)."""
    c = steps + 2
    away = torch.ones((ny, nx), dtype=torch.bool, device=device)
    away[[0, 1, ny - 2, ny - 1], :] = False
    for ys in (slice(0, c), slice(ny - c, ny)):
        for xs in (slice(0, c), slice(nx - c, nx)):
            away[ys, xs] = False
    return away


def test_kernel_bf16_tracks_plain_bf16(cuda):
    """Five steps within ~10x the gap measured at the flagship size, then one
    step from a common state within one bf16 ulp per stored value (the
    rho_r lo plane wherever the hi plane agrees), with at most 1e-2 of the
    values off at all (2.8e-3 measured on an H100; rounding toward zero
    puts ~2e-1 off, test_torch_kernels.py)."""
    params, bcs, _ = CASES["mrt_matched_tau_obstacle"]
    m = ColorGradientRK(_geometry(96, 64, True), params, bcs,
                        dtype=torch.float32, device=cuda, storage="bf16")
    a = _state(m, bf16=True)
    b = a.clone()
    for _ in range(5):
        a = m.step_c(a)
        b = csf_step_compressed_reference(b, m)
    assert a.dtype == torch.bfloat16 and a.shape == (11, 96, 64)
    away = _off_seam(96, 64, 5, cuda)
    ua, ub = m.unpack_bf16(a), m.unpack_bf16(b)
    assert bool(torch.isfinite(ua).all())
    assert float((ua[:9] - ub[:9]).abs()[:, away].max()) <= 3e-4
    assert float((ua[9] - ub[9]).abs()[away].max()) <= 1e-4
    gap = compare_bf16_states(m.step_c(b), csf_step_compressed_reference(b, m),
                              away)
    assert gap["excess"] <= 1.0
    assert gap["share"] <= 1e-2


def test_step_counts_launches_and_checks_state(cuda):
    params, bcs, _ = CASES["mrt_tau2_akai_neumann_dirichlet"]
    m = ColorGradientRK(_geometry(32, 16), params, bcs, device=cuda)
    s = _state(m)
    before = csf_step_compressed.launches
    for _ in range(3):
        s = m.step_c(s)
    assert csf_step_compressed.launches == before + 3
    with pytest.raises(ValueError, match="state"):
        m.step_c(s.double())
    with pytest.raises(ValueError, match="state"):
        m.step_c(s[:9].contiguous())


def _coupled(case, ny, nx, device, dtype=torch.float64, storage="f32",
             obstacle=False):
    params, bcs = flagship_flow()
    m = TransportRK(_geometry(ny, nx, obstacle), params,
                    TransportParams(**COUPLED_CASES[case]), bcs,
                    dtype=dtype, device=device, storage=storage)
    st = m.init_state(m.flow.init_state_layers(1.0, 1.0, invading_rows=ny // 5),
                      coupled_conc0(m.tp.num_tracers, ny, nx))
    return m, m.pack(st)


@pytest.mark.parametrize("case", ["a", "b", "e"])
def test_coupled_kernel_matches_plain_f64(cuda, case):
    m, a = _coupled(case, 64, 48, cuda, obstacle=True)
    b = a
    for _ in range(10):
        a = coupled_step_compressed(*a, m)
        b = coupled_step_compressed_reference(*b, m)
    torch.cuda.synchronize(cuda)
    assert all(bool(torch.isfinite(x).all()) for x in a)
    assert float((a[0] - b[0]).abs().max()) <= 1e-11
    assert float((a[1] - b[1]).abs().max()) <= 1e-11


def test_coupled_kernel_bf16_tracks_plain_bf16(cuda):
    """Five coupled steps with bf16 flow storage, kernel against the plain
    path in the same storage: the flow planes off the inlet/outlet seam
    within the bounds of test_kernel_bf16_tracks_plain_bf16, and the f32
    tracer PDFs on the rows at least steps + 2 from the seam within 5e-5,
    about 10x the 4.0e-6 to 4.9e-6 measured on an H100.  The tracer
    carries the seam's f32 tie-break noise (~2e-3 on the seam rows, with
    an f32 flow state too) into the rows next to it by streaming, about a
    row a step."""
    steps, ny, nx = 5, 96, 64
    m, a = _coupled("a", ny, nx, cuda,
                    dtype=torch.float32, storage="bf16", obstacle=True)
    b = a
    for _ in range(steps):
        a = m.step_c(a)
        b = coupled_step_compressed_reference(*b, m)
    assert a[0].dtype == torch.bfloat16 and a[1].dtype == torch.float32
    away = _off_seam(ny, nx, steps, cuda)
    ua, ub = m.flow.unpack_bf16(a[0]), m.flow.unpack_bf16(b[0])
    assert bool(torch.isfinite(ua).all()) and bool(torch.isfinite(a[1]).all())
    assert float((ua[:9] - ub[:9]).abs()[:, away].max()) <= 3e-4
    assert float((ua[9] - ub[9]).abs()[away].max()) <= 1e-4
    c = steps + 2
    assert float((a[1] - b[1]).abs()[:, :, c:ny - c].max()) <= 5e-5


def test_coupled_step_counts_launches_and_refuses_device_mix(cuda):
    m, state = _coupled("f", 32, 16, cuda,
                        dtype=torch.float32)
    before = coupled_step_compressed.launches
    for _ in range(3):
        state = m.step_c(state)
    assert coupled_step_compressed.launches == before + 3
    s, g = state
    with pytest.raises(ValueError, match="device"):
        m.step_c((s, g.cpu()))
    with pytest.raises(ValueError, match="device"):
        m.step_c((s.cpu(), g))
    with pytest.raises(ValueError, match="tracer PDFs"):
        m.step_c((s, g.double()))
    assert coupled_step_compressed.launches == before + 3


# -- the split (f_r, f_b) layout ------------------------------------------

SPLIT = split_cases()


@pytest.mark.parametrize("case", sorted(SPLIT))
def test_split_kernel_matches_plain_f64(cuda, case):
    """The split CSF kernel against its plain version, 10 steps at f64 with
    an obstacle (contact lines on the walls and the obstacle): 1e-11
    (7.2e-16 measured on an H100 over 20 steps at 256x128)."""
    params, bcs = SPLIT[case]
    m = ColorGradientRK(_geometry(72, 40, True), params, bcs,
                        dtype=torch.float64, device=cuda)
    a = b = m.init_state_layers(1.0, 1.0, invading_rows=14)
    for _ in range(10):
        a = csf_step_split(a, m)
        b = csf_step_split_reference(b, m)
    torch.cuda.synchronize(cuda)
    assert all(bool(torch.isfinite(x).all()) for x in a)
    assert max(float((x - y).abs().max()) for x, y in zip(a, b)) <= 1e-11


def test_split_step_counts_launches_and_checks_state(cuda):
    params, bcs = SPLIT["mrt_neumann_dirichlet"]
    m = ColorGradientRK(_geometry(32, 16), params, bcs, device=cuda)
    st = m.init_state_layers(1.0, 1.0, invading_rows=6)
    before = csf_step_split.launches
    for _ in range(3):
        st = m.step(st)
    assert csf_step_split.launches == before + 3
    with pytest.raises(ValueError, match="split state"):
        m.step((st[0].double(), st[1].double()))
    with pytest.raises(ValueError, match="device"):
        m.step((st[0], st[1].cpu()))
    assert csf_step_split.launches == before + 3


def test_split_kernel_neumann_per_color_f64(cuda):
    """K6 with the per-colour Zou-He velocity inlet (inlet code 3), 10
    steps at f64 against its plain version: 1e-11."""
    params, bcs = SPLIT["mrt_dirichlet_convective"]
    bcs = dataclasses.replace(bcs, inlet="neumann_per_color",
                              inlet_velocity_r=-1e-3, inlet_velocity_b=-2e-4)
    m = ColorGradientRK(_geometry(72, 40, True), params, bcs,
                        dtype=torch.float64, device=cuda)
    a = b = m.init_state_layers(1.0, 1.0, invading_rows=14)
    for _ in range(10):
        a = csf_step_split(a, m)
        b = csf_step_split_reference(b, m)
    assert max(float((x - y).abs().max()) for x, y in zip(a, b)) <= 1e-11


# -- the Perturbation variant (K4) ------------------------------------------

@pytest.mark.parametrize("case", sorted(PERT_CASES))
def test_pert_kernel_matches_plain_f64(cuda, case):
    """K4s and (where the compressed layout takes the rows) K4c against
    their plain versions at f64 on a 72x40 channel, up to 10 steps: 1e-11,
    as chip_smoke.py phase 40 at 256x128."""
    m = pert_case(case, cuda, ny=72, nx=40)
    steps = min(10, PERT_CASES[case][3])
    st = pert_start(m, PERT_CASES[case][2])
    a = b = st
    for _ in range(steps):
        a = pert_step_split(a, m)
        b = pert_step_split_reference(b, m)
    torch.cuda.synchronize(cuda)
    assert all(bool(torch.isfinite(x).all()) for x in a)
    assert max(float((x - y).abs().max()) for x, y in zip(a, b)) <= 1e-11
    if m.bcs.inlet == "neumann_per_color":
        return
    a = b = m.pack_state(*st)
    for _ in range(steps):
        a = pert_step_compressed(a, m)
        b = pert_step_compressed_reference(b, m)
    assert bool(torch.isfinite(a).all())
    assert float((a - b).abs().max()) <= 1e-11


def test_pert_kernel_bf16_one_step_within_one_ulp(cuda):
    """K4h: five steps of kernel and plain path in bf16 storage, then one
    step of each from a common state within one bf16 ulp per stored value
    off the seam rows, with at most 1e-3 of the values off."""
    m = pert_case("mrt_iso_neumann_dirichlet", cuda, ny=96, nx=64,
                  dtype=torch.float32, storage="bf16")
    s = m.pack_state_bf16(*pert_start(m, "layers"))
    for _ in range(5):
        s = pert_step_compressed_reference(s, m)
    away = _off_seam(96, 64, 5, cuda)
    gap = compare_bf16_states(pert_step_compressed(s, m),
                              pert_step_compressed_reference(s, m), away)
    assert gap["excess"] <= 1.0
    assert gap["share"] <= 1e-3


def test_pert_paths_and_launches(cuda):
    """The model's step launches K4s (step) and K4c (step_c) once a call;
    the averaged convective outlet takes the plain step on the card and
    launches nothing."""
    m = pert_case("mrt_iso_neumann_dirichlet", cuda, ny=32, nx=16,
                  dtype=torch.float32)
    assert m.path == "kernel"
    st = pert_start(m, "layers")
    before = (pert_step_split.launches, pert_step_compressed.launches)
    st = m.step(m.step(st))
    m.step_c(m.pack_state(*st))
    assert (pert_step_split.launches, pert_step_compressed.launches) == \
        (before[0] + 2, before[1] + 1)
    plain = ColorGradientRK(m.geo, m.p, dataclasses.replace(
        m.bcs, outlet="convective_average"), device=cuda)
    assert plain.path == "plain" and plain.kernel_params is None
    out = plain.step(st)
    assert all(bool(torch.isfinite(x).all()) for x in out)
    assert (pert_step_split.launches, pert_step_compressed.launches) == \
        (before[0] + 2, before[1] + 1)


SPLIT_COUPLED = split_coupled_cases()


@pytest.mark.parametrize("case", ["a", "e", "conserve_mass", "redistribute",
                                  "standalone"])
def test_split_coupled_kernel_matches_plain_f64(cuda, case):
    """The split coupled step on the kernels (``TransportRK.step``: the
    kernels, then the repairs) against the plain split step, 10 steps at
    f64 with tracer mass on the BC rows: 1e-11 (4.0e-12 measured on an H100
    over 20 steps at 96x64, the largest with conserve_mass, whose values
    grow each step).  The pre-step velocity and domain mask the kernels
    hand the repairs match the plain version's (1e-11, and exactly)."""
    kw, tp = SPLIT_COUPLED[case]
    params, bcs = flagship_flow()
    m = TransportRK(_geometry(64, 48, True), params, TransportParams(**tp),
                    bcs, dtype=torch.float64, device=cuda, **kw)
    a = b = m.init_state(m.flow.init_state_layers(1.0, 1.0, 12),
                         coupled_conc0(m.tp.num_tracers, 64, 48))
    before = coupled_step_split.launches
    for _ in range(10):
        a = m.step(a)
        b = m.plain_step(b)
    torch.cuda.synchronize(cuda)
    assert coupled_step_split.launches == before + 10
    assert all(bool(torch.isfinite(x).all()) for x in a[:3])
    assert max(float((x - y).abs().max())
               for x, y in zip(a[:3], b[:3])) <= 1e-11
    out = coupled_step_split(a, m, with_u=True)
    ref = coupled_step_split_reference(a, m)
    assert max(float((x - y).abs().max())
               for x, y in zip(out[:4], ref[:4])) <= 1e-11
    assert out[4].dtype == torch.bool and torch.equal(out[4], ref[4])
    assert coupled_step_split(a, m)[3] is None


def test_golden_csf_mini_through_split_kernel(cuda):
    """tests/golden/csf_mini.npz through the split kernel at f64 (1e-10;
    1.25e-14 measured on an H100)."""
    from chip_smoke import phase_golden
    assert phase_golden(cuda) <= 1e-10


@pytest.mark.parametrize("case", SC_KERNEL_CASES)
def test_sc_kernel_matches_plain_f64(cuda, case):
    """K8 against its plain version, 10 steps at f64 on a 64x48 channel:
    1e-11 (at most 9.7e-16 measured on an H100 over 20 steps at 128x64)."""
    m, a = sc_case(case, cuda, 64, 48)
    assert m.path == "kernel"
    b = a
    before = sc_step.launches
    for _ in range(10):
        a = sc_step(a, m)
        b = sc_step_reference(b, m)
    torch.cuda.synchronize(cuda)
    assert sc_step.launches == before + 10
    assert bool(torch.isfinite(a).all())
    assert float((a - b).abs().max()) <= 1e-11


@pytest.mark.parametrize("case", [c for c in SC_CASES
                                  if c not in SC_KERNEL_CASES])
def test_sc_plain_cases_take_the_plain_step_on_the_card(cuda, case):
    """The configurations the JAX package keeps on its jnp path run the
    plain step on the card and launch nothing; sc_step refuses them."""
    m, a = sc_case(case, cuda, 64, 48)
    assert m.path == "plain" and m.kernel_params is None
    before = sc_step.launches
    b = m.step(a)
    assert sc_step.launches == before and b.is_cuda
    assert torch.equal(b, m.plain_step(a))
    with pytest.raises(ValueError, match="no Shan-Chen kernel"):
        sc_step(a, m)


def test_sc_kernel_bf16_one_step_within_one_ulp(cuda):
    """One K8 step and one plain step from a common bf16 state of config 2
    at 256^2 (after 20 plain steps): every stored value within one bf16
    ulp (``compare_bf16_states``)."""
    m, f = sc_config("config2", cuda, storage="bf16", n=256)
    s = m.pack_state_bf16(f)
    for _ in range(20):
        s = sc_step_reference(s, m)
    fluid = m.fluid_mask > 0
    for x, y in zip(sc_step(s, m), sc_step_reference(s, m)):
        assert compare_bf16_states(x, y, fluid)["excess"] <= 1.0


def test_sc_step_checks_state_and_counts(cuda):
    m, a = sc_case("sc_srt_velocity_convective", cuda, 32, 16)
    before = sc_step.launches
    with pytest.raises(ValueError, match="the model takes"):
        sc_step(a.float(), m)
    m.step(m.step(a))
    assert sc_step.launches == before + 2


@pytest.mark.parametrize("storage", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("case", ["sc_srt_periodic_body_force",
                                  "efs8_mrt_velocity_convective"])
def test_sc_kernel_launches_a_step(cuda, case, storage):
    """K8's library counts its kernels where it launches them: a step is one
    sc_push_kernel (and one sc_outlet_kernel with an outlet) in f32 and
    f64, one collide_stream_kernel in bf16, and sc_step counts one launch a
    step."""
    from chip_smoke import sc_want_kernels
    from openlbmpm_torch.kernels.shanchen import kernel_launches
    dtype = torch.float64 if storage == "f64" else torch.float32
    m, f = sc_case(case, cuda, 64, 48, dtype,
                   "bf16" if storage == "bf16" else "f32")
    x = m.pack_state_bf16(f) if storage == "bf16" else f
    lib = f"sc2d_{storage}"
    before, calls = kernel_launches(lib), sc_step.launches
    for _ in range(3):
        x = sc_step(x, m)
    torch.cuda.synchronize()
    after = kernel_launches(lib)
    want = sc_want_kernels(storage, m.bcs.outlet != "periodic")
    assert {k: after[k] - before[k] for k in after} == {
        k: 3 * (k in want) for k in after}
    assert sc_step.launches == calls + 3


@pytest.mark.parametrize("layout", ["f32", "bf16", "split", "f64"])
@pytest.mark.parametrize("variant", ["CSF", "Perturbation"])
def test_cg2d_kernel_launches_a_step(cuda, variant, layout):
    """The one-step 2-D colour-gradient libraries count their kernels where
    they launch them: K1 / K2 / K6 (csf2d, csf2d_f64) and K4c / K4h / K4s
    (pert2d, pert2d_f64) one strip march a step, the coupled K5c / K5s
    (coupled2d) two launches a step: the tracer's strip march and the
    flow's."""
    from chip_smoke import CG2D_STEP_KERNELS, pert_case
    from openlbmpm_torch.kernels.csf import kernel_launches
    dtype = torch.float64 if layout == "f64" else torch.float32
    storage = "bf16" if layout == "bf16" else "f32"
    if variant == "CSF":
        params, bcs = split_cases()["mrt_neumann_dirichlet"]
        m = ColorGradientRK(_geometry(72, 40), params, bcs, dtype=dtype,
                            device=cuda, storage=storage)
        lib = "csf2d_f64" if layout == "f64" else "csf2d"
        kern = csf_step_split if layout == "split" else csf_step_compressed
    else:
        m = pert_case("mrt_iso_neumann_dirichlet", cuda, 72, 40, dtype,
                      storage)
        lib = "pert2d_f64" if layout == "f64" else "pert2d"
        kern = pert_step_split if layout == "split" else pert_step_compressed
    st = m.init_state_layers(1.0, 1.0, invading_rows=14)
    x = st if layout == "split" else (
        m.pack_state_bf16(*st) if layout == "bf16" else m.pack_state(*st))
    before, calls = kernel_launches(lib), kern.launches
    for _ in range(3):
        x = kern(x, m)
    torch.cuda.synchronize()
    after = kernel_launches(lib)
    want = CG2D_STEP_KERNELS[lib.replace("_f64", "")]
    assert {k: after[k] - before[k] for k in after} == {
        k: 3 * (k in want) for k in after}
    assert kern.launches == calls + 3
    if variant == "CSF" and layout in ("f32", "split"):
        tm = TransportRK(_geometry(72, 40), params, TransportParams(
            num_tracers=1, scheme=5, tau=(1.0,), j0=(1 / 3,)), bcs,
            device=cuda)
        ts = tm.init_state(st, np.zeros((1, 72, 40)))
        if layout != "split":
            ts = tm.pack(ts)
        before = kernel_launches("coupled2d")
        for _ in range(3):
            ts = tm.step(ts) if layout == "split" else \
                coupled_step_compressed(*ts, tm)
        torch.cuda.synchronize()
        after = kernel_launches("coupled2d")
        assert {k: after[k] - before[k] for k in after} == {
            k: 3 * (k in CG2D_STEP_KERNELS["coupled2d"]) for k in after}


def test_golden_sc_mini_through_kernel(cuda):
    """tests/golden/sc_mini.npz through K8 at f64 (1e-10)."""
    from chip_smoke import phase_sc_golden
    assert phase_sc_golden(cuda) <= 1e-10


# -- the D3Q19 CSF step (K9) -------------------------------------------------

K9_SHAPE = (24, 20, 16)


@pytest.mark.parametrize("case", sorted(c for c in CG3D_CASES
                                        if c != "grain_pack"))
def test_cg3d_kernels_match_plain_f64(cuda, case):
    """K9c and K9s against their plain versions, 10 f64 steps (phase 20 of
    chip_smoke.py at a smaller size; the grain pack runs there)."""
    m, st = cg3d_case(case, cuda, shape=K9_SHAPE)
    a = b = m.pack_state(*st)
    x = y = st
    for _ in range(10):
        a, b = cg3d_step_compressed(a, m), cg3d_step_compressed_reference(b, m)
        x, y = cg3d_step_split(x, m), cg3d_step_split_reference(y, m)
    torch.cuda.synchronize(cuda)
    assert bool(torch.isfinite(a).all())
    assert float((a - b).abs().max()) <= 1e-11
    assert max(float((p - q).abs().max()) for p, q in zip(x, y)) <= 1e-11


def test_cg3d_bf16_one_step_within_one_ulp(cuda):
    m, st = cg3d_case("velocity_convective", cuda, shape=K9_SHAPE,
                      dtype=torch.float32, storage="bf16")
    h = m.pack_state_bf16(*st)
    for _ in range(3):
        h = cg3d_step_compressed_reference(h, m)
    away = torch.ones(m.geo.shape, dtype=torch.bool, device=cuda)
    away[:3] = away[K9_SHAPE[0] - 2:] = False
    assert bf16_one_step_3d(m, h, away)["excess"] <= 1.0


def test_cg3d_steps_count_launches_and_check_states(cuda):
    m, st = cg3d_case("velocity_dirichlet", cuda, shape=K9_SHAPE,
                      dtype=torch.float32)
    assert m.path == "kernel"
    cg3d_step_compressed.launches = cg3d_step_split.launches = 0
    s = m.step_c(m.pack_state(*st))
    st = m.step(st)
    assert (cg3d_step_compressed.launches, cg3d_step_split.launches) == (1, 1)
    with pytest.raises(ValueError, match="state"):
        m.step_c(s.double())
    with pytest.raises(ValueError, match="split state"):
        m.step(tuple(t.double() for t in st))
    assert cg3d_step_compressed.launches == 1



# -- the coupled D3Q19 CSF + D3Q7 tracer step (K9t) ---------------------------

@pytest.mark.parametrize("case", sorted(c for c in CG3D_TRANSPORT_CASES
                                        if c != "grain_pack"))
def test_coupled3d_kernel_matches_plain_f64(cuda, case):
    """K9t against its plain version, 10 f64 steps: flow state and tracer
    PDFs <= 1e-11 (phase 25 of chip_smoke.py at a smaller size; the grain
    pack runs there)."""
    m, st = transport3d_case(case, cuda, shape=K9_SHAPE)
    a = b = m.pack(st)
    for _ in range(10):
        a = coupled3d_step_compressed(*a, m)
        b = coupled3d_step_compressed_reference(*b, m)
    torch.cuda.synchronize(cuda)
    assert all(bool(torch.isfinite(t).all()) for t in a)
    assert max(float((p - q).abs().max()) for p, q in zip(a, b)) <= 1e-11


def test_coupled3d_kernel_bf16_tracks_plain_bf16(cuda):
    """K9t with bf16 flow storage and f32 tracers against its plain version,
    3 steps of the probe case: tracer PDFs within 3e-5 off the seam slabs,
    the tracer mass within 1e-6."""
    m, st = transport3d_case("probe", cuda, shape=K9_SHAPE,
                             dtype=torch.float32, storage="bf16")
    a = b = m.pack(st)
    assert a[0].dtype == torch.bfloat16 and a[1].dtype == torch.float32
    for _ in range(3):
        a = coupled3d_step_compressed(*a, m)
        b = coupled3d_step_compressed_reference(*b, m)
    away = torch.ones(m.geo.shape, dtype=torch.bool, device=cuda)
    away[:3] = away[K9_SHAPE[0] - 2:] = False
    gap = (a[1] - b[1]).abs().flatten(0, 1).amax(0)
    assert float(gap[away].max()) <= 3e-5
    ma, mb = float(a[1].double().sum()), float(b[1].double().sum())
    assert abs(ma - mb) <= 1e-6 * mb


def test_coupled3d_step_counts_launches_and_refuses_device_mix(cuda):
    m, st = transport3d_case("dirichlet_nt2", cuda, shape=K9_SHAPE,
                             dtype=torch.float32)
    assert m.path == "kernel"
    coupled3d_step_compressed.launches = 0
    s, g = m.step_c(m.pack(st))
    assert coupled3d_step_compressed.launches == 1
    assert tuple(g.shape) == (2, 7) + K9_SHAPE
    with pytest.raises(ValueError, match="device"):
        m.step_c((s, g.cpu()))
    with pytest.raises(ValueError, match="state"):
        m.step_c((s.double(), g))
    cpu_model, _ = transport3d_case("dirichlet_nt2", "cpu", shape=K9_SHAPE,
                                    dtype=torch.float32)
    with pytest.raises(ValueError, match="plain"):
        coupled3d_step_compressed(s, g, cpu_model)
    assert coupled3d_step_compressed.launches == 1


# -- single-phase D2Q9 (K7), D3Q19 single-phase (K11) and Shan-Chen (K10) ----

FLOW3D_SHAPE = (20, 14, 37)


def _run_pair(kernel, plain, m, f, steps=10):
    a = b = f
    for _ in range(steps):
        a, b = kernel(a, m), plain(b, m)
    torch.cuda.synchronize()
    return a, b


@pytest.mark.parametrize("case", sorted(SINGLE_CASES))
def test_single_kernel_matches_plain_f64(cuda, case):
    """K7 against its plain version, 10 f64 steps on a 72x40 channel with
    side walls, body force and the case's rows: <= 1e-11 (phase 29 at a
    smaller size)."""
    m = single_case(case, cuda, ny=72, nx=40)
    a, b = _run_pair(single_step, single_step_reference, m, flow_start(m))
    assert bool(torch.isfinite(a).all())
    assert float((a - b).abs().max()) <= 1e-11


def test_single_kernel_bf16_one_step_within_one_ulp(cuda):
    mh = config1_model(cuda, storage="bf16", nx=64, ny=96)
    h = mh.pack_state_bf16(flow_start(config1_model(cuda, nx=64, ny=96), 1))
    r = bf16_ulp_check(mh, h, single_step, mh.fluid_mask > 0,
                       SINGLE_BF16_SHARE, "K7")
    assert r["excess"] <= 1.0


def test_single_step_counts_launches_and_refuses(cuda):
    m = single_case("mrt_zou_he", cuda, ny=72, nx=40, dtype=torch.float32)
    assert m.path == "kernel"
    single_step.launches = 0
    f = m.step(flow_start(m))
    assert single_step.launches == 1 and f.shape == (9, 72, 40)
    with pytest.raises(ValueError, match="state"):
        m.step(f.double())
    moving = np.zeros(m.geo.shape, bool)
    moving[:, 0] = True
    mw = SinglePhaseD2Q9(m.geo, moving_wall_mask=moving,
                         wall_velocity=(0.0, 0.01), device=cuda)
    assert mw.path == "plain"
    with pytest.raises(ValueError, match="no single-phase kernel"):
        single_step(f, mw)
    assert single_step.launches == 1


@pytest.mark.parametrize("case", sorted(SINGLE3D_CASES))
def test_single3d_kernel_matches_plain_f64(cuda, case):
    """K11 against its plain version, 10 f64 steps: <= 1e-11."""
    m = single3d_case(case, cuda, shape=FLOW3D_SHAPE)
    a, b = _run_pair(single3d_step, single3d_step_reference, m,
                     flow_start(m))
    assert bool(torch.isfinite(a).all())
    assert float((a - b).abs().max()) <= 1e-11


@pytest.mark.parametrize("case", sorted(SC3D_CASES))
def test_sc3d_kernel_matches_plain_f64(cuda, case):
    """K10 against its plain version, 10 f64 steps: <= 1e-11."""
    m, f = sc3d_case(case, cuda, shape=FLOW3D_SHAPE)
    a, b = _run_pair(sc3d_step, sc3d_step_reference, m, f)
    assert bool(torch.isfinite(a).all())
    assert float((a - b).abs().max()) <= 1e-11


@pytest.mark.parametrize("tag", ["K11", "K10"])
def test_flow3d_bf16_one_step_within_one_ulp(cuda, tag):
    if tag == "K11":
        make, start, step = basic3d_model, lambda m: flow_start(m, 2), \
            single3d_step
    else:
        make, start, step = probe_sc3d_model, probe_sc3d_start, sc3d_step
    mh = make(cuda, n=32, storage="bf16")
    h = mh.pack_state_bf16(start(make(cuda, n=32)))
    for _ in range(2):
        h = step(h, mh)
    r = bf16_ulp_check(mh, h, step, mh.fluid_mask > 0, FLOW3D_BF16_SHARE, tag)
    assert r["excess"] <= 1.0


def test_flow3d_paths_and_launches(cuda):
    g = single3d_case("srt", cuda, shape=FLOW3D_SHAPE).geo
    assert SinglePhaseD3Q19(g, collision="MRT", device=cuda).path == "plain"
    two = dict(g_matrix=((0.0, 3.6), (3.6, 0.0)), g_solid=(0.0, 0.0),
               tau=(1.0, 1.0))
    assert ShanChenMCMP3D(g, ShanChenParams3D(**two, psi="PR"),
                          device=cuda).path == "plain"
    four = dict(g_matrix=tuple((0.0,) * 4 for _ in range(4)),
                g_solid=(0.0,) * 4, tau=(1.0,) * 4)
    # four fluids take the kernel too (the runtime-K instance)
    assert ShanChenMCMP3D(g, ShanChenParams3D(**four),
                          device=cuda).path == "kernel"
    m = ShanChenMCMP3D(g, ShanChenParams3D(**two), device=cuda)
    assert m.path == "kernel"
    sc3d_step.launches = 0
    f = m.step(m.init_state_droplet((1.0, 1.0), (0.02, 0.02), radius=4.0))
    assert sc3d_step.launches == 1 and f.shape == (2, 19, *FLOW3D_SHAPE)
    with pytest.raises(ValueError, match="state"):
        m.step(f.double())


# -- the T-step kernels: K3, K8-T, K7-T ---------------------------------------

def _block_calls(fn, x, m, t, calls=2):
    for _ in range(calls):
        x = fn(x, m, t)
    return x


def _gap(a, b):
    if isinstance(a, tuple):
        return max(_gap(x, y) for x, y in zip(a, b))
    return float((a.double() - b.double()).abs().max())


@pytest.mark.parametrize("t", [2, 3, 4])
@pytest.mark.parametrize("key", ["f32", "split"])
@pytest.mark.parametrize("variant", ["CSF", "Perturbation"])
@pytest.mark.parametrize("domain", ["periodic_96x64",
                                    "dirichlet_convective_100x72"])
def test_k3_matches_t_plain_steps_f64(cuda, domain, variant, key, t):
    """K3c / K3s at f64 against T plain steps, two calls (<= 1e-11)."""
    from chip_smoke import k3_case, k3_wrappers
    m, st = k3_case(domain, variant, cuda)
    kern, plain = k3_wrappers(variant, key)
    x = st if key == "split" else m.pack_state(*st)
    assert _gap(_block_calls(kern, x, m, t), _block_calls(plain, x, m, t)) \
        <= 1e-11


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("case", SC_KERNEL_CASES)
def test_k8t_matches_t_plain_steps_f64(cuda, case, t):
    from openlbmpm_torch.kernels.shanchen import (sc_block_step,
                                                  sc_block_step_reference)
    m, f = sc_case(case, cuda, ny=100, nx=64)
    assert _gap(_block_calls(sc_block_step, f, m, t),
                _block_calls(sc_block_step_reference, f, m, t)) <= 1e-11


@pytest.mark.parametrize("t", [2, 3, 4])
@pytest.mark.parametrize("case", sorted(SINGLE_CASES))
def test_k7t_matches_t_plain_steps_f64(cuda, case, t):
    from openlbmpm_torch.kernels.single import (single_block_step,
                                                single_block_step_reference)
    m = single_case(case, cuda, ny=100, nx=72)
    f = flow_start(m)
    assert _gap(_block_calls(single_block_step, f, m, t),
                _block_calls(single_block_step_reference, f, m, t)) <= 1e-11


def test_block_steps_count_one_launch_per_call_and_bf16(cuda):
    """One launch per call of T steps for each T-step wrapper; the bf16
    forms decode once and encode once a call, as their plain versions
    (within the T=1 bf16 bounds at a small size); make_block_step picks
    the wrapper of the layout and variant."""
    from openlbmpm_torch.kernels import csf as k
    from openlbmpm_torch.kernels.shanchen import sc_block_step
    from openlbmpm_torch.kernels.single import single_block_step
    from chip_smoke import k3_case
    m, st = k3_case("neumann_dirichlet_100x72", "CSF", cuda,
                    dtype=torch.float32)
    mb = ColorGradientRK(m.geo, m.p, m.bcs, device=cuda, storage="bf16")
    h = mb.pack_state_bf16(*st)
    blk = mb.make_block_step(steps_per_call=4, compressed=True,
                             storage="bf16")
    k.csf_block_compressed.launches = 0
    a = blk(h)
    assert k.csf_block_compressed.launches == 1 and a.dtype == torch.bfloat16
    b = k.csf_block_compressed_reference(h, mb, 4)
    away = torch.ones(m.geo.shape, dtype=torch.bool, device=cuda)
    away[[0, 1, -2, -1]] = False
    away[:, :8] = away[:, -8:] = False
    d = (mb.unpack_bf16(a) - mb.unpack_bf16(b)).abs()
    assert float(d[:9, away].max()) <= 3e-4 and float(d[9, away].max()) <= 1e-4
    k.csf_block_split.launches = 0
    m.make_block_step(steps_per_call=2)(st)
    assert k.csf_block_split.launches == 1
    ms, f = sc_case("sc_srt_velocity_convective", cuda, ny=100, nx=64,
                    dtype=torch.float32)
    sc_block_step.launches = 0
    ms.make_block_step(steps_per_call=3)(f)
    assert sc_block_step.launches == 1
    m7 = single_case("mrt_convective", cuda, ny=100, nx=72,
                     dtype=torch.float32)
    single_block_step.launches = 0
    m7.make_block_step(steps_per_call=4, storage="bf16")(
        m7.pack_state_bf16(flow_start(m7)))
    assert single_block_step.launches == 1
    with pytest.raises(ValueError):
        k.csf_block_split(st, m, 0)


# -- the T-step kernels: K5c-T, K11-T, K10-T ----------------------------------

@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("layout", ["f32", "split"])
@pytest.mark.parametrize("case", sorted(COUPLED_CASES))
def test_k5ct_matches_t_plain_steps_f64(cuda, case, layout, t):
    """K5c-T (compressed, split) at f64 against T plain coupled steps, two
    calls, on the 100 x 64 channel of chip_smoke phase 52 (<= 1e-11)."""
    from chip_smoke import coupled_block_case, k5ct_wrappers
    m, st = coupled_block_case(case, cuda)
    kern, plain = k5ct_wrappers(layout)
    x = st if layout == "split" else m.pack(st)
    assert _gap(tuple(_block_calls(kern, x, m, t)),
                tuple(_block_calls(plain, x, m, t))) <= 1e-11


@pytest.mark.parametrize("t", [2, 3, 4, 10])
@pytest.mark.parametrize("case", sorted(SINGLE3D_CASES))
def test_k11t_matches_t_plain_steps_f64(cuda, case, t):
    """K11-T's z-march at f64 against T plain steps, two calls (T = 10: two
    launches a call), <= 1e-11; each call counted once a launch."""
    from openlbmpm_torch.kernels import build
    from openlbmpm_torch.kernels.flow3d import (
        flow3d_block_max_steps, single3d_block_step,
        single3d_block_step_reference)
    m = single3d_case(case, cuda, shape=FLOW3D_SHAPE)
    f = flow_start(m)
    single3d_block_step.launches = 0
    got = _block_calls(single3d_block_step, f, m, t)
    assert single3d_block_step.launches == 2 * len(build.split_steps(
        t, flow3d_block_max_steps(torch.float64, "single")))
    assert _gap(got, _block_calls(single3d_block_step_reference, f, m,
                                  t)) <= 1e-11


@pytest.mark.parametrize("t", [2, 3, 4, 10])
def test_k11t_bf16_matches_t_plain_steps(cuda, t):
    """K11-T in bf16 storage (decoded once and encoded once a launch)
    against the same launches of plain steps, two calls on basic3d's
    physics at 32^3: decoded within phase 54's bound (BF16_BOUND["K11"])."""
    from openlbmpm_torch.kernels.flow3d import (single3d_block_step,
                                                single3d_block_step_reference)
    mh = basic3d_model(cuda, n=32, storage="bf16")
    h = mh.pack_state_bf16(flow_start(basic3d_model(cuda, n=32), seed=3))
    a = _block_calls(single3d_block_step, h, mh, t)
    b = _block_calls(single3d_block_step_reference, h, mh, t)
    assert a.dtype == torch.bfloat16
    assert _gap(mh.unpack_bf16(a), mh.unpack_bf16(b)) <= BF16_BOUND["K11"]


@pytest.mark.parametrize("case", sorted(SINGLE3D_CASES))
def test_single3d_step_launches_one_kernel_once(cuda, case):
    """A K11 step launches one kernel once, as the libraries count it:
    single_push_kernel in f64 and f32 storage, march_kernel in bf16."""
    from openlbmpm_torch.kernels import flow3d as kf
    for dtype, storage, lib, want in (
            (torch.float64, "f32", "flow3d_f64", "single_push_kernel"),
            (torch.float32, "f32", "flow3d_f32", "single_push_kernel"),
            (torch.float32, "bf16", "flow3d_bf16", "march_kernel")):
        m = single3d_case(case, cuda, shape=FLOW3D_SHAPE, dtype=dtype)
        if storage == "bf16":
            m = SinglePhaseD3Q19(m.geo, tau=m.tau, collision=m.collision,
                                 body_force=m.body_force, device=cuda,
                                 storage="bf16")
        f = flow_start(m)
        x = m.pack_state_bf16(f) if storage == "bf16" else f
        before = kf.kernel_launches(lib)
        for _ in range(3):
            x = single3d_step(x, m)
        after = kf.kernel_launches(lib)
        assert {k: after[k] - before[k] for k in kf.KERNELS} == {
            k: 3 * (k == want) for k in kf.KERNELS}


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("case", ["k1_walls_force", "k2_walls_force", "k3"])
def test_k10t_matches_t_plain_steps_f64(cuda, case, t):
    from chip_smoke import block_sc3d_case
    from openlbmpm_torch.kernels.flow3d import (sc3d_block_step,
                                                sc3d_block_step_reference)
    m, f = block_sc3d_case(case, cuda, shape=FLOW3D_SHAPE)
    assert _gap(_block_calls(sc3d_block_step, f, m, t),
                _block_calls(sc3d_block_step_reference, f, m, t)) <= 1e-11


def test_new_block_steps_count_one_launch_per_call(cuda):
    """One launch per call of T steps for K5c-T (compressed and split),
    K11-T and K10-T through ``make_block_step``; the bf16 forms decode once
    and encode once a call (within the T=1 bf16 bounds); a T beyond the 3-D
    kernels' largest runs as two launches (``build.split_steps``), which
    the launcher alone refuses."""
    from chip_smoke import coupled_block_case
    from openlbmpm_torch.kernels import flow3d as kf
    from openlbmpm_torch.kernels import transport as kt
    m, st = coupled_block_case("a", cuda, dtype=torch.float32)
    kt.coupled_block_compressed.launches = kt.coupled_block_split.launches = 0
    m.make_block_step(steps_per_call=4, compressed=True)(m.pack(st))
    m.make_block_step(steps_per_call=2)(st)
    assert (kt.coupled_block_compressed.launches,
            kt.coupled_block_split.launches) == (1, 1)
    m3 = single3d_case("trt_force", cuda, shape=FLOW3D_SHAPE,
                       dtype=torch.float32)
    f = flow_start(m3)
    kf.single3d_block_step.launches = 0
    h = m3.make_block_step(steps_per_call=4, storage="bf16")(
        m3.pack_state_bf16(f))
    assert kf.single3d_block_step.launches == 1 and h.dtype == torch.bfloat16
    ref = kf.single3d_block_step_reference(m3.pack_state_bf16(f), m3, 4)
    assert _gap(m3.unpack_bf16(h), m3.unpack_bf16(ref)) <= 1.5e-4
    kf.single3d_block_step.launches = 0
    t = kf.MAX_BLOCK_STEPS + 1
    got = kf.single3d_block_step(f, m3, t)
    assert kf.single3d_block_step.launches == 2
    assert _gap(got, kf.single3d_block_step_reference(f, m3, t)) <= 2e-5
    with pytest.raises(ValueError, match="at most"):
        kf.launch_flow3d_block(f, m3.kernel_params, m3.fluid_u8, "single", t)
    from chip_smoke import block_sc3d_case
    ms, fs = block_sc3d_case("k2_walls_force", cuda, shape=FLOW3D_SHAPE,
                             dtype=torch.float32)
    kf.sc3d_block_step.launches = 0
    ms.make_block_step(steps_per_call=2)(fs)
    assert kf.sc3d_block_step.launches == 1


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("layout", ["compressed", "split"])
@pytest.mark.parametrize("case", ["akai60_walls", "velocity_convective",
                                  "velocity_dirichlet", "grain_pack"])
def test_k9t_matches_t_plain_steps_f64(cuda, case, layout, t):
    """K9-T against T plain steps at f64, two calls, chip_smoke phase 60's
    cases (the grain pack at 32^3): <= 1e-11."""
    from openlbmpm_torch.kernels import cg3d as k9
    m, st = cg3d_case(case, cuda, shape=(32,) * 3 if case == "grain_pack"
                      else (48, 40, 32))
    if layout == "compressed":
        x0, kern, plain = (m.pack_state(*st), k9.cg3d_block_compressed,
                           k9.cg3d_block_compressed_reference)
    else:
        x0, kern, plain = st, k9.cg3d_block_split, k9.cg3d_block_split_reference
    a, b = x0, x0
    for _ in range(2):
        a, b = kern(a, m, t), plain(b, m, t)
    assert _gap(tuple(a) if layout == "split" else a,
                tuple(b) if layout == "split" else b) <= 1e-11


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("case", ["k1_walls_force", "k3",
                                  "velocity_convective compressed",
                                  "velocity_dirichlet split",
                                  "grain_pack compressed"])
def test_march_in_y_bands_matches_t_plain_steps_f64(cuda, case, t):
    """K10-T (K = 1, 3) and K9-T on a plan in three y-bands whose last
    overhangs ny (``chip_smoke.banded_march``, launched by
    ``chip_smoke.march_call``) against T plain steps at f64, two calls:
    <= 1e-11."""
    from chip_smoke import banded_march, block_sc3d_case, march_call
    from openlbmpm_torch.kernels import cg3d as k9
    from openlbmpm_torch.kernels import flow3d as kf
    name, *layout = case.split()
    if not layout:
        m, x0 = block_sc3d_case(name, cuda)
        plan, table = banded_march(m, t)
        plain = kf.sc3d_block_step_reference
    else:
        m, st = cg3d_case(name, cuda, shape=(32,) * 3 if name == "grain_pack"
                          else (48, 40, 32))
        split = layout[0] == "split"
        x0 = st if split else m.pack_state(*st)
        plan, table = banded_march(m, t, split)
        plain = (k9.cg3d_block_split_reference if split
                 else k9.cg3d_block_compressed_reference)
    a, b = x0, x0
    for _ in range(2):
        a, b = march_call(a, m, t, plan, table), plain(b, m, t)
    assert _gap(tuple(a) if layout == ["split"] else a,
                tuple(b) if layout == ["split"] else b) <= 1e-11


@pytest.mark.parametrize("t", [10, 16])
def test_row_march_splits_calls_past_its_limit(cuda, t):
    """K3c (the row-march) at T = 10 and 16 and K5c-Tc at T = 10 on the
    flagship's rows at f64: one call runs ``build.split_steps(T, limit)``
    launches, each counted, and equals T plain steps (<= 1e-11, as chip_smoke
    phase 72)."""
    from chip_smoke import coupled_block_case, k3_case
    from openlbmpm_torch.kernels import build
    from openlbmpm_torch.kernels import csf as k
    from openlbmpm_torch.kernels import transport as kt
    m, st = k3_case("neumann_dirichlet_100x72", "CSF", cuda)
    x0 = m.pack_state(*st)
    lim = k.csf_block_max_steps(torch.float64, False, m.kernel_params)
    k.csf_block_compressed.launches = 0
    got = k.csf_block_compressed(x0, m, t)
    assert k.csf_block_compressed.launches == len(build.split_steps(t, lim))
    assert _gap(got, k.csf_block_compressed_reference(x0, m, t)) <= 1e-11
    if t == 10:
        mt, s2 = coupled_block_case("a", cuda)
        y0 = mt.pack(s2)
        lim = kt.coupled_block_max_steps(torch.float64, False,
                                         kt.coupled_block_params(mt))
        kt.coupled_block_compressed.launches = 0
        got = kt.coupled_block_compressed(y0, mt, t)
        assert kt.coupled_block_compressed.launches == \
            len(build.split_steps(t, lim)) > 1
        want = kt.coupled_block_compressed_reference(y0, mt, t)
        assert max(_gap(a, b) for a, b in zip(got, want)) <= 1e-11


@pytest.mark.parametrize("t", [10, 16])
@pytest.mark.parametrize("case", ["sc_srt_velocity_convective",
                                  "sc_srt_periodic_body_force"])
def test_k8t_splits_calls_past_its_limit(cuda, case, t):
    """K8-T (the row-march) at T = 10 and 16 at f64 with the inlet and
    outlet rows (a launch takes 15) and periodic (16): one call runs
    ``build.split_steps(T, limit)`` launches, each counted, and equals T
    plain steps (<= 1e-11, as chip_smoke phase 72)."""
    from openlbmpm_torch.kernels import build
    from openlbmpm_torch.kernels import shanchen as ks
    m, f = sc_case(case, cuda, ny=100, nx=64)
    lim = ks.sc_block_max_steps(torch.float64, m.kernel_params)
    assert lim == (15 if m.bcs.outlet != "periodic" else 16)
    ks.sc_block_step.launches = 0
    got = ks.sc_block_step(f, m, t)
    assert ks.sc_block_step.launches == len(build.split_steps(t, lim))
    assert _gap(got, ks.sc_block_step_reference(f, m, t)) <= 1e-11


def test_k9t_counts_one_launch_per_call_and_bf16(cuda):
    """``make_block_step(T)`` launches K9-T once a call on the three
    layouts; the bf16 form decodes once and encodes once, within K9h's bf16
    bounds of its plain version; a T beyond the kernel's largest runs as two
    launches, which the launcher alone refuses."""
    from openlbmpm_torch.kernels import cg3d as k9
    m, st = cg3d_case("velocity_convective", cuda, dtype=torch.float32)
    mh, _ = cg3d_case("velocity_convective", cuda, dtype=torch.float32,
                      storage="bf16")
    k9.cg3d_block_compressed.launches = k9.cg3d_block_split.launches = 0
    m.make_block_step(4, compressed=True)(m.pack_state(*st))
    m.make_block_step(2)(st)
    h = mh.pack_state_bf16(*st)
    got = mh.make_block_step(2, compressed=True, storage="bf16")(h)
    assert (k9.cg3d_block_compressed.launches,
            k9.cg3d_block_split.launches) == (2, 1)
    ref = k9.cg3d_block_compressed_reference(h, mh, 2)
    d = (mh.unpack_bf16(got) - mh.unpack_bf16(ref)).abs()
    assert float(d[:19].max()) <= 3e-4 and float(d[19].max()) <= 1e-4
    k9.cg3d_block_compressed.launches = 0
    t = k9.MAX_BLOCK_STEPS + 1
    s0 = m.pack_state(*st)
    k9.cg3d_block_compressed(s0, m, t)
    assert k9.cg3d_block_compressed.launches == 2
    with pytest.raises(ValueError, match="at most"):
        k9.launch_cg3d_block(s0, m.kernel_params, m.geo_planes, t)


@pytest.mark.parametrize("case", ["sc4_srt_periodic_body_force",
                                  "sc4_mrt_velocity_convective",
                                  "sc4_srt_pressure_pressure",
                                  "efs4_4f_velocity_pressure",
                                  "efs10_4f_mrt_velocity_convective",
                                  "k4_walls_force", "k4_periodic"])
def test_four_fluids_match_plain_f64(cuda, case):
    """Four fluids on the runtime-K instances (K8 / K8-T on SC4_CASES, K10 /
    K10-T on SC3D4_CASES): path "kernel", 20 steps as T = 1 and as T = 4 a
    call against the plain step at f64, <= 1e-11."""
    from openlbmpm_torch.kernels import flow3d as kf
    from openlbmpm_torch.kernels import shanchen as ks
    if case.startswith("k4"):
        m, f = sc3d_case(case, cuda)
        one, blk, plain = kf.sc3d_step, kf.sc3d_block_step, \
            kf.sc3d_block_step_reference
    else:
        m, f = sc_case(case, cuda)
        one, blk, plain = ks.sc_step, ks.sc_block_step, \
            ks.sc_block_step_reference
    assert m.path == "kernel" and m.k == 4
    ref, a, b = f, f, f
    for _ in range(20):
        ref, a = plain(ref, m, 1), one(a, m)
    for _ in range(5):
        b = blk(b, m, 4)
    assert _gap(a, ref) <= 1e-11 and _gap(b, ref) <= 1e-11


def test_no_pallas_models_launch_nothing(cuda):
    """``use_kernel=False`` on a card: the plain step on the card's
    tensors, no kernel launched, no T-step form."""
    from chip_smoke import _launch_counters
    m, st = cg3d_case("velocity_convective", cuda, dtype=torch.float32)
    plain = type(m)(m.geo, m.p, m.bcs, dtype=torch.float32, device=cuda,
                    use_kernel=False)
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    x = plain.step(st)
    y = plain.step_c(plain.pack_state(*st))
    ms, f = sc_case("sc4_srt_periodic_body_force", cuda)
    sc_plain = type(ms)(ms.geo, ms.p, ms.bcs, dtype=torch.float64,
                        device=cuda, use_kernel=False)
    z = sc_plain.step(f)
    assert all(fn.launches == 0 for fn in counters.values())
    assert plain.path == sc_plain.path == "plain"
    assert plain.make_block_step(2) is None
    assert x[0].is_cuda and y.is_cuda and z.is_cuda


# -- the local kernels of the sharded steps (K12a, K12b) -------------------

def _local_run(step, x0, kernel, reference, aux):
    """One call's local kernels against their plain versions on the same
    exchanged padded buffers, shard by shard: the largest gap."""
    state = step.shard(*x0)
    step.exchange(state)
    gap = 0.0
    for k, g, ins, outs in zip(step.ids, step.grids, state.bufs,
                               state.spare):
        got = kernel(k, g, ins, outs)
        want = reference(g, ins)
        for a, b in zip(got, want):
            gap = max(gap, float((g.centre(a) - b).abs().max()))
    return gap


@pytest.mark.parametrize("t", [1, 2, 4])
@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
@pytest.mark.parametrize("variant", ["CSF", "Perturbation"])
def test_k12a_local_matches_plain_f64(cuda, variant, shape, t):
    from chip_smoke import _P_DIR_CONV, _noisy_layers, k12a_params, walled
    from openlbmpm_torch.kernels.csf import (build_csf_sharded_step,
                                             csf_local_step,
                                             csf_local_step_reference)
    from openlbmpm_torch.parallel import make_mesh, shard_domain
    mesh = make_mesh(shape=shape, kind="local", device=cuda)
    step = build_csf_sharded_step(walled(128, 128), k12a_params(variant),
                                  mesh, torch.float64, steps_per_call=t,
                                  bc_config=CGBoundaryConfig(**_P_DIR_CONV))
    m = step.model
    geo = shard_domain(m.geo_planes, mesh, step.frame)
    gap = _local_run(
        step, (_noisy_layers(m, 5),),
        lambda k, g, ins, outs: (csf_local_step(ins[0], outs[0], geo[k], m,
                                                g, t),),
        lambda g, ins: (csf_local_step_reference(ins[0], m, g, t),), geo)
    assert gap <= 1e-11


@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
@pytest.mark.parametrize("case", sorted(COUPLED_CASES))
def test_k12a_coupled_local_matches_plain_f64(cuda, case, shape, t):
    from chip_smoke import walled
    from openlbmpm_torch.kernels.csf import build_csf_sharded_step
    from openlbmpm_torch.kernels.transport import (
        coupled_local_step, coupled_local_step_reference)
    from openlbmpm_torch.parallel import make_mesh, shard_domain
    mesh = make_mesh(shape=shape, kind="local", device=cuda)
    params, bcs = flagship_flow()
    step = build_csf_sharded_step(
        walled(96, 96), params, mesh, torch.float64, steps_per_call=t,
        bc_config=bcs, transport_params=TransportParams(**COUPLED_CASES[case]))
    m = step.model
    geo = shard_domain(m.flow.geo_planes, mesh, step.frame)
    x0 = m.pack(m.init_state(
        m.flow.init_state_layers(1.0, 1.0, invading_rows=19),
        coupled_conc0(m.tp.num_tracers, 96, 96, 3)))
    gap = _local_run(
        step, x0, lambda k, g, ins, outs: coupled_local_step(
            ins, outs, geo[k], m, g, t),
        lambda g, ins: coupled_local_step_reference(ins, m, g, t), geo)
    assert gap <= 1e-11


@pytest.mark.parametrize("t", [1, 2, 3])
@pytest.mark.parametrize("case", ["srt_convective", "trt_zou_he",
                                  "mrt_zou_he", "mrt_periodic"])
def test_k12b_local_matches_plain_f64(cuda, case, t):
    from chip_smoke import walled
    from openlbmpm_torch.kernels.single import (build_single_sharded_step,
                                                single_local_step,
                                                single_local_step_reference)
    from openlbmpm_torch.models.single_phase import BoundaryConfig
    from openlbmpm_torch.parallel import make_mesh, shard_domain
    mesh = make_mesh(shape=(4, 1), kind="local", device=cuda)
    collision, bcs = SINGLE_CASES[case]
    g0 = walled(128, 64)
    step = build_single_sharded_step(g0, 0.8, collision, (1e-5, -2e-5), mesh,
                                     bc_config=BoundaryConfig(**bcs),
                                     dtype=torch.float64, steps_per_call=t)
    m = step.model
    fl = shard_domain(torch.as_tensor(g0.is_fluid, dtype=torch.uint8), mesh,
                      step.frame)
    gap = _local_run(
        step, (flow_start(m, seed=4),),
        lambda k, g, ins, outs: (single_local_step(ins[0], outs[0], fl[k], m,
                                                   g, t),),
        lambda g, ins: (single_local_step_reference(ins[0], m, g, t),), fl)
    assert gap <= 1e-11


def test_sharded_steps_count_one_local_launch_a_shard(cuda):
    from chip_smoke import _noisy_layers, flagship_flow, walled
    from openlbmpm_torch.kernels import csf as kc
    from openlbmpm_torch.parallel import make_mesh
    mesh = make_mesh(shape=(2, 2), kind="local", device=cuda)
    step = kc.build_csf_sharded_step(walled(128, 128), *flagship_flow()[:1],
                                     mesh, torch.float32, steps_per_call=2,
                                     bc_config=flagship_flow()[1])
    state = step.shard(_noisy_layers(step.model, 2))
    kc.csf_local_step.launches = 0
    for _ in range(3):
        state = step(state)
    assert kc.csf_local_step.launches == 3 * mesh.size


# -- the local kernels of the 3-D sharded steps (K12d, K12e) ---------------

@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
@pytest.mark.parametrize("case", ["velocity_convective", "velocity_dirichlet"])
def test_k12d_local_matches_plain_f64(cuda, case, shape):
    """The slab kernel and the local step against their plain versions,
    shard by shard, on one call's buffers."""
    from chip_smoke import CG3D_CASES, _noisy_slabs, cg3d_solid
    from openlbmpm_torch.kernels import cg3d as kg
    from openlbmpm_torch.models.flow3d import (CG3DBoundaryConfig,
                                               ColorGradientParams3D)
    from openlbmpm_torch.parallel import make_mesh, shard_domain
    p, b, kind, _ = CG3D_CASES[case]
    mesh = make_mesh(shape=shape, kind="local", device=cuda)
    step = kg.build_cg3d_sharded_step(
        from_solid_mask(cg3d_solid(kind, (32, 40, 32))),
        ColorGradientParams3D(**p), mesh, torch.float64,
        bc_config=CG3DBoundaryConfig(**b))
    m = step.model
    geo = shard_domain(m.geo_planes, mesh, step.frame, rank=3)
    state = step.shard(_noisy_slabs(m, 6, 8))
    gap = 0.0
    for k, g, ins in zip(step.ids, step.grids, state.bufs):
        want = kg.cg3d_local_slabs_reference(ins[0], m, g)
        kg.cg3d_local_slabs(ins[0], geo[k], m, g)
        gap = max(gap, float((g.centre(ins[0]) - want).abs().max()))
    step.exchange(state)
    for k, g, ins, outs in zip(step.ids, step.grids, state.bufs,
                               state.spare):
        got = kg.cg3d_local_step(ins[0], outs[0], geo[k], m, g)
        want = kg.cg3d_local_step_reference(ins[0], m, g)
        gap = max(gap, float((g.centre(got) - want).abs().max()))
    assert gap <= 1e-12


def test_k12d_coupled_local_matches_plain_f64(cuda):
    from chip_smoke import tracer3d_of, transport3d_case
    from openlbmpm_torch.kernels import cg3d as kg
    from openlbmpm_torch.parallel import make_mesh, shard_domain
    m0, st = transport3d_case("dirichlet_nt2", cuda)
    mesh = make_mesh(shape=(4, 1), kind="local", device=cuda)
    step = kg.build_cg3d_sharded_step(
        m0.geo, m0.flow.p, mesh, torch.float64, bc_config=m0.flow.bcs,
        transport=tracer3d_of(m0, cuda, torch.float64))
    m = step.model
    geo = shard_domain(m.flow.geo_planes, mesh, step.frame, rank=3)
    state = step.shard(*m.pack(st))
    for k, g, ins in zip(step.ids, step.grids, state.bufs):
        kg.cg3d_local_slabs(ins[0], geo[k], m.flow, g)
    step.exchange(state)
    gap = 0.0
    for k, g, ins, outs in zip(step.ids, step.grids, state.bufs,
                               state.spare):
        got = kg.coupled3d_local_step(ins, outs, geo[k], m, g)
        want = kg.coupled3d_local_step_reference(ins, m, g)
        gap = max(gap, *(float((g.centre(a) - b).abs().max())
                         for a, b in zip(got, want)))
    assert gap <= 1e-12


@pytest.mark.parametrize("t", [1, 2, 3])
@pytest.mark.parametrize("case", ["k2_walls_force", "k3", "k4_walls_force",
                                  "k1_obstacle", "k2_grains"])
def test_k12e_local_matches_plain_f64(cuda, case, t):
    from openlbmpm_torch.kernels import flow3d as kf
    from openlbmpm_torch.parallel import make_mesh, shard_domain
    m0, f0 = sc3d_case(case, cuda)
    mesh = make_mesh(shape=(4, 1), kind="local", device=cuda)
    step = kf.build_sc3d_sharded_step(m0.geo, m0.p, mesh, torch.float64,
                                      steps_per_call=t)
    m = step.model
    fl = shard_domain(torch.as_tensor(m0.geo.is_fluid, dtype=torch.uint8),
                      mesh, step.frame, rank=3)
    state = step.shard(f0)
    step.exchange(state)
    gap = 0.0
    for k, g, ins, outs in zip(step.ids, step.grids, state.bufs,
                               state.spare):
        got = kf.sc3d_local_step(ins[0], outs[0], fl[k], m, g, t)
        want = kf.sc3d_local_step_reference(ins[0], m, g, t)
        gap = max(gap, float((g.centre(got) - want).abs().max()))
    assert gap <= 1e-11


def test_3d_sharded_steps_count_one_local_launch_a_shard(cuda):
    from chip_smoke import _noisy_slabs, config5_model
    from openlbmpm_torch.kernels import cg3d as kg
    from openlbmpm_torch.kernels import flow3d as kf
    from openlbmpm_torch.parallel import make_mesh
    mesh = make_mesh(shape=(2, 2), kind="local", device=cuda)
    m0 = config5_model(cuda, n=64)
    step = kg.build_cg3d_sharded_step(m0.geo, m0.p, mesh, torch.float32,
                                      bc_config=m0.bcs)
    state = step.shard(_noisy_slabs(step.model, 2, 8))
    kg.cg3d_local_step.launches = kg.cg3d_local_slabs.launches = 0
    for _ in range(3):
        state = step(state)
    # every shard holds slabs of the outlet (bottom row) or the inlet (top)
    assert kg.cg3d_local_step.launches == kg.cg3d_local_slabs.launches == 12
    m1, f1 = sc3d_case("k2_walls_force", cuda, dtype=torch.float32)
    step = kf.build_sc3d_sharded_step(m1.geo, m1.p,
                                      make_mesh(shape=(4, 1), kind="local",
                                                device=cuda),
                                      torch.float32, steps_per_call=2)
    state = step.shard(f1)
    kf.sc3d_local_step.launches = 0
    for _ in range(3):
        state = step(state)
    assert kf.sc3d_local_step.launches == 12


# -- the local kernels of the sharded 2-D Shan-Chen step (K12c) -------------

@pytest.mark.parametrize("t", [1, 2, 3])
@pytest.mark.parametrize("case", ["sc_mrt_velocity_convective",
                                  "efs8_mrt_velocity_convective",
                                  "efs10_mrt_velocity_pressure",
                                  "sc_peng_robinson_one_fluid",
                                  "sc4_mrt_velocity_convective",
                                  "efs4_4f_velocity_pressure"])
def test_k12c_local_matches_plain_f64(cuda, case, t):
    """Each shard's local call (the template window up to three fluids,
    the runtime-K passes above) against its plain version on the same
    exchanged padded buffers; 104 rows on (4, 1), shards of 26."""
    from openlbmpm_torch.kernels import shanchen as ks
    from openlbmpm_torch.parallel import make_mesh
    m0, f0 = sc_case(case, cuda, 104, 48)
    mesh = make_mesh(shape=(4, 1), kind="local", device=cuda)
    step = ks.build_sc_sharded_step(m0.geo, m0.p, mesh, torch.float64,
                                    steps_per_call=t, bc_config=m0.bcs)
    m = step.model
    gap = _local_run(
        step, (f0,), lambda k, g, ins, outs: (ks.sc_local_step(
            ins[0], outs[0], step.geo[k], m, g, t),),
        lambda g, ins: (ks.sc_local_step_reference(ins[0], m, g, t),),
        step.geo)
    assert gap <= 1e-12


def test_sc_sharded_step_counts_one_local_call_a_shard(cuda):
    from openlbmpm_torch.kernels import shanchen as ks
    from openlbmpm_torch.parallel import make_mesh
    for case in ("sc_mrt_velocity_convective", "sc4_mrt_velocity_convective"):
        m0, f0 = sc_case(case, cuda, 128, 64, torch.float32)
        step = ks.build_sc_sharded_step(
            m0.geo, m0.p, make_mesh(shape=(4, 1), kind="local", device=cuda),
            torch.float32, steps_per_call=2, bc_config=m0.bcs)
        state = step.shard(f0)
        ks.sc_local_step.launches = 0
        for _ in range(3):
            state = step(state)
        assert ks.sc_local_step.launches == 12


@pytest.mark.parametrize("name", ["akai60_walls", "velocity_convective",
                                  "grain_pack"])
def test_cg3d_fields_kernel_matches_its_plain_version(cuda, name):
    """K9's fields_kernel (after bc_kernel): g and kappa of both layouts at
    f64 against ``cg3d_fields_reference`` (<= 1e-12, as chip_smoke phase
    20), one counted launch a call."""
    from openlbmpm_torch.kernels import cg3d as k9
    m, st = cg3d_case(name, cuda, shape=(16,) * 3 if name == "grain_pack"
                      else (24, 20, 16))
    for x in (m.pack_state(*st), st):
        k9.cg3d_fields.launches = 0
        got = k9.cg3d_fields(x, m)
        assert k9.cg3d_fields.launches == 1
        assert tuple(got.shape) == (k9.FIELD_PLANES, *m.geo.shape)
        assert float((got - k9.cg3d_fields_reference(x, m)).abs().max()) \
            <= 1e-12


@pytest.mark.parametrize("t", [2, 16])
def test_pert_row_march_matches_plain_steps(cuda, t):
    """The Perturbation K3 (the row-march) at f64 on the flagship's rows:
    compressed and split, one call of T steps as ``build.split_steps``'s
    launches (T = 16 past the limit of 15), equal to T plain steps
    (<= 1e-11, as chip_smoke phases 45 and 72)."""
    from chip_smoke import k3_case
    from openlbmpm_torch.kernels import build
    from openlbmpm_torch.kernels import csf as k
    m, st = k3_case("neumann_dirichlet_100x72", "Perturbation", cuda)
    for split in (False, True):
        x0 = st if split else m.pack_state(*st)
        kern = k.pert_block_split if split else k.pert_block_compressed
        plain = k.pert_block_split_reference if split else \
            k.pert_block_compressed_reference
        lim = k.csf_block_max_steps(torch.float64, split, m.kernel_params)
        kern.launches = 0
        got = kern(x0, m, t)
        assert kern.launches == len(build.split_steps(t, lim))
        assert _gap(got, plain(x0, m, t)) <= 1e-11


@pytest.mark.parametrize("name", ["periodic_droplet", "velocity_convective"])
def test_cg3d_step_launches_each_kernel_once(cuda, name):
    """A K9 step (f64, both layouts) launches fields_kernel and
    collide_stream once each, and bc_kernel once with boundary slabs and
    never without, as the library counts its launches."""
    from openlbmpm_torch.kernels import cg3d as k9
    m, st = cg3d_case(name, cuda, shape=(24, 20, 16))
    bc = 1 if name == "velocity_convective" else 0
    for x, step in ((m.pack_state(*st), k9.cg3d_step_compressed),
                    (st, k9.cg3d_step_split)):
        before = k9.kernel_launches("cg3d_f64")
        for _ in range(3):
            x = step(x, m)
        after = k9.kernel_launches("cg3d_f64")
        assert {k: after[k] - before[k] for k in k9.KERNELS} == {
            "bc_kernel": 3 * bc, "fields_kernel": 3,
            "collide_stream_kernel": 3}


# -- K10 (one push launch in f32 / f64, rho and march in bf16), K9t fused ----

@pytest.mark.parametrize("case", ["k1_obstacle", "k2_grains", "k3"])
def test_sc3d_bf16_kernel_one_step_within_one_ulp(cuda, case):
    """K10's bf16 instance (rho_kernel and march_kernel, K = 1, 2, 3)
    against the plain bf16 path, one step from a common bf16 state after two
    kernel steps: every stored value within one bf16 ulp, as phase 37 holds
    probe_sc3d."""
    _, f = sc3d_case(case, cuda, shape=FLOW3D_SHAPE, dtype=torch.float32)
    mh, _ = sc3d_case(case, cuda, shape=FLOW3D_SHAPE, dtype=torch.float32,
                      storage="bf16")
    h = mh.pack_state_bf16(f)
    for _ in range(2):
        h = sc3d_step(h, mh)
    r = bf16_ulp_check(mh, h, sc3d_step, mh.fluid_mask > 0, FLOW3D_BF16_SHARE,
                       "K10")
    assert r["excess"] <= 1.0


@pytest.mark.parametrize("case", ["k1_obstacle", "k2_grains", "k3"])
def test_sc3d_step_launches_one_kernel_once(cuda, case):
    """A K10 step launches each of its kernels once, as the libraries count
    them: sc_push_kernel in f64 and f32 storage, rho_kernel and
    march_kernel in bf16."""
    from openlbmpm_torch.kernels import flow3d as kf
    for dtype, storage, lib, want in (
            (torch.float64, "f32", "flow3d_f64", ("sc_push_kernel",)),
            (torch.float32, "f32", "flow3d_f32", ("sc_push_kernel",)),
            (torch.float32, "bf16", "flow3d_bf16",
             ("rho_kernel", "march_kernel"))):
        m, f = sc3d_case(case, cuda, shape=FLOW3D_SHAPE, dtype=dtype,
                         storage=storage)
        x = m.pack_state_bf16(f) if storage == "bf16" else f
        before = kf.kernel_launches(lib)
        for _ in range(3):
            x = sc3d_step(x, m)
        after = kf.kernel_launches(lib)
        assert {k: after[k] - before[k] for k in kf.KERNELS} == {
            k: 3 * (k in want) for k in kf.KERNELS}


# the largest decoded gap after five bf16 steps of K10 and its plain path
# on the cases below: 3.40e-4 on k3 (an NVIDIA H100, PERF.md), above
# phase 37's BF16_BOUND["K10"] = 3e-4 for probe_sc3d
K10_BF16_FIVE_STEP_BOUND = 4e-4


@pytest.mark.parametrize("case", ["k1_obstacle", "k2_grains", "k3"])
def test_sc3d_bf16_kernel_five_steps_decoded(cuda, case):
    """K10's bf16 instance against the plain bf16 path, five steps from
    one bf16 state: the decoded values within K10_BF16_FIVE_STEP_BOUND."""
    _, f = sc3d_case(case, cuda, shape=FLOW3D_SHAPE, dtype=torch.float32)
    mh, _ = sc3d_case(case, cuda, shape=FLOW3D_SHAPE, dtype=torch.float32,
                      storage="bf16")
    h = mh.pack_state_bf16(f)
    a, b = _run_pair(sc3d_step, sc3d_step_reference, mh, h, steps=5)
    gap = float((mh.unpack_bf16(a) - mh.unpack_bf16(b)).abs().max())
    print(f"K10 bf16 {case}, five steps: max decoded gap {gap:.3e}")
    assert gap <= K10_BF16_FIVE_STEP_BOUND


@pytest.mark.parametrize("case,want", [
    ("probe", (1, 1, 1)), ("periodic_box", (0, 1, 1)),
    ("dirichlet_nt2", (1, 1, 1)), ("dirichlet_nt3", (1, 1, 2))])
def test_coupled3d_step_launch_counts(cuda, case, want):
    """A K9t step (f64) launches bc_kernel with boundary slabs, then
    fields_kernel and collide_stream with the tracers fused: three launches,
    two when periodic; three tracers take a second collide_stream launch in
    f64, whose shared memory holds two a launch."""
    from openlbmpm_torch.kernels import cg3d as k9
    m, st = transport3d_case(case, cuda, shape=K9_SHAPE)
    x = m.pack(st)
    before = k9.kernel_launches("cg3d_f64")
    for _ in range(3):
        x = coupled3d_step_compressed(*x, m)
    after = k9.kernel_launches("cg3d_f64")
    assert tuple(after[k] - before[k] for k in k9.KERNELS) == tuple(
        3 * w for w in want)
