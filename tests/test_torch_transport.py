"""The port's coupled flow + tracer transport against the JAX package, on
the CPU at f64.

* every ported transport op and equilibrium against its jnp op (1e-12);
* ``TransportRK.step_c`` (plain) against the JAX model's ``_step_impl``
  (jnp path, split state, packed with ``flow.pack_state``): 1e-12 for each
  of 4 steps in every coupled case, 1e-10 after 50 steps;
* the kernel module's plain version against the Pallas kernel it replaces
  (compressed coupled step, T=1) in interpret mode (1e-12);
* the split ``TransportRK.step`` (plain) against the JAX ``_step_impl``:
  1e-12 for each of 4 steps in every coupled case and with
  ``conserve_mass``, the ``redistribute`` interface and ``standalone``
  transport (50-step trajectories: ``tests/test_torch_split_transport.py``);
* bf16 flow storage, conversion, refusals and the CPU wrappers.

The CUDA kernels are checked on a card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openlbmpm_tpu import geometry as geo
from openlbmpm_tpu.lattice import D2Q5, D2Q9
from openlbmpm_tpu.models import colorgradient as jcg
from openlbmpm_tpu.models import transport as jtr
from openlbmpm_tpu.ops import equilibrium as jeq
from openlbmpm_tpu.ops import streaming as jst
from openlbmpm_tpu.ops import transport as jops
from openlbmpm_torch.convert import (
    params_from_jax, state_from_numpy, state_to_numpy)
from openlbmpm_torch.kernels.transport import (
    coupled_step_compressed, coupled_step_compressed_reference,
    coupled_step_split, coupled_step_split_reference)
from openlbmpm_torch.models.transport import (
    TransportParams, TransportRK, TransportState)
from openlbmpm_torch.ops import equilibrium as teq
from openlbmpm_torch.ops import streaming as tst
from openlbmpm_torch.ops import transport as tops
from chip_smoke import (COUPLED_CASES, coupled_conc0, flagship_flow,
                        split_coupled_cases)

torch.set_num_threads(1)
CPU = "cpu"   # the port's models run on the card unless told otherwise

NY, NX = 10, 12
LATTICES = {"D2Q5": D2Q5, "D2Q9": D2Q9}


def J(a):
    return jnp.asarray(a)


def T(a):
    return torch.from_numpy(np.array(a))


class Fields:
    """Random f64 tracer inputs shared by both packages (numpy first)."""

    def __init__(self, lat, nt, seed=0):
        rng = np.random.default_rng(seed)
        q = lat.q
        self.g = rng.uniform(0.0, 0.3, (nt, q, NY, NX))
        self.geq = rng.uniform(0.0, 0.3, (nt, q, NY, NX))
        self.conc = self.g.sum(axis=1)
        self.ux, self.uy = rng.uniform(-0.05, 0.05, (2, NY, NX))
        self.gx, self.gy = rng.uniform(-0.2, 0.2, (2, NY, NX))
        self.gx[4, :3] = self.gy[4, :3] = 0.0            # |g| = 0 guard
        self.rho_r = rng.uniform(0.0, 1.0, (NY, NX))
        self.in_dom = self.rho_r < 0.5
        # the domain a step earlier: a front that moved by some cells
        self.in_dom_old = self.in_dom ^ (rng.random((NY, NX)) < 0.15)
        self.mass0 = rng.uniform(5.0, 20.0, nt)
        self.ux[2, :4] = 0.0                              # inactive cells
        self.value = np.where(self.in_dom, -1.0, 0.0)
        self.solid = rng.random((NY, NX)) < 0.2
        self.row_mask = rng.random(NX) < 0.8
        self.beta = tuple(rng.uniform(0.1, 0.6, nt))
        self.target = tuple(rng.uniform(0.2, 1.0, nt))
        self.diff = [tuple(rng.uniform(0.02, 0.15, nt)) for _ in range(2)] + \
            [tuple(rng.uniform(-0.02, 0.02, nt)) for _ in range(2)]
        self.j0 = tuple(rng.uniform(0.2, 0.4, nt))


def _op_cases():
    """name -> (lattices, tracer counts, fn(F, lat, nt) -> (jax, torch))."""
    both, d2q5 = ("D2Q5", "D2Q9"), ("D2Q5",)
    u = lambda F, w: (w(F.ux), w(F.uy))  # noqa: E731
    mrt = {"D2Q5": (jops.mrt_matrices_d2q5, tops.mrt_matrices_d2q5),
           "D2Q9": (jops.mrt_matrices_d2q9, tops.mrt_matrices_d2q9)}
    c = {}
    c["feq_transport_j"] = (d2q5, (1, 2), lambda F, lat, nt: (
        jeq.feq_transport_j(lat, J(F.conc), u(F, J),
                            jops.j_coefficients(F.j0[:1])[0]),
        teq.feq_transport_j(lat, T(F.conc), u(F, T),
                            tops.j_coefficients(F.j0[:1])[0])))
    for name in ("feq_transport_linear", "feq_transport_quadratic"):
        c[name] = (both, (1, 2), (lambda name: lambda F, lat, nt: (
            getattr(jeq, name)(lat, J(F.conc), u(F, J)),
            getattr(teq, name)(lat, T(F.conc), u(F, T))))(name))
    c["j_coefficients"] = (d2q5, (1, 2), lambda F, lat, nt: (
        jops.j_coefficients(F.j0), tops.j_coefficients(F.j0)))
    c["mrt_matrices"] = (both, (1, 2), lambda F, lat, nt: (
        mrt[lat.name][0](*F.diff), mrt[lat.name][1](*F.diff)))
    c["mrt_collide"] = (both, (1, 2), lambda F, lat, nt: (
        jops.mrt_collide(J(F.g), J(F.geq), mrt[lat.name][0](*F.diff)),
        tops.mrt_collide(T(F.g), T(F.geq), mrt[lat.name][0](*F.diff))))
    c["transport_domain_mask"] = (d2q5, (1,), lambda F, lat, nt: (
        jops.transport_domain_mask(J(F.rho_r), 0.5),
        tops.transport_domain_mask(T(F.rho_r), 0.5)))
    c["interface_partition"] = (both, (1, 2), lambda F, lat, nt: (
        jops.interface_partition(J(F.g), J(F.conc), J(F.gx), J(F.gy),
                                 J(F.value), F.beta, lat),
        tops.interface_partition(T(F.g), T(F.conc), T(F.gx), T(F.gy),
                                 T(F.value), F.beta, lat)))
    c["interface_bounce_back"] = (both, (1, 2), lambda F, lat, nt: (
        jops.interface_bounce_back(J(F.g), J(F.in_dom), lat),
        tops.interface_bounce_back(T(F.g), T(F.in_dom), lat)))
    c["bilinear_reaction"] = (both, (2, 3), lambda F, lat, nt: (
        jops.bilinear_reaction(J(F.g), J(F.conc), 0.07,
                               np.tile(lat.w, (nt, 1)), F.target),
        tops.bilinear_reaction(T(F.g), T(F.conc), 0.07,
                               np.tile(lat.w, (nt, 1)), F.target)))
    c["inamuro_inlet"] = (d2q5, (1, 2), lambda F, lat, nt: (
        jops.inamuro_inlet(J(F.g), F.target, NY - 1, J(F.row_mask)),
        tops.inamuro_inlet(T(F.g), F.target, NY - 1, T(F.row_mask))))
    c["anti_bounce_back_inlet"] = (d2q5, (1, 2), lambda F, lat, nt: (
        jops.anti_bounce_back_inlet(J(F.g), F.target, NY - 2,
                                    J(F.row_mask), float(lat.w[3])),
        tops.anti_bounce_back_inlet(T(F.g), F.target, NY - 2,
                                    T(F.row_mask), float(lat.w[3]))))
    c["zero_concentration_inlet"] = (both, (1, 2), lambda F, lat, nt: (
        jops.zero_concentration_inlet(J(F.g), NY - 2, J(F.row_mask)),
        tops.zero_concentration_inlet(T(F.g), NY - 2, T(F.row_mask))))
    masks = lambda F: (F.row_mask, ~F.row_mask, F.row_mask)  # noqa: E731
    c["free_flow_outlet"] = (both, (1, 2), lambda F, lat, nt: (
        jops.free_flow_outlet(J(F.g), (2, 1, 0), tuple(map(J, masks(F)))),
        tops.free_flow_outlet(T(F.g), (2, 1, 0), tuple(map(T, masks(F))))))
    c["stream_batched"] = (both, (1, 2), lambda F, lat, nt: (
        jst.stream(J(F.g), lat, J(jst.upwind_solid_masks(lat, F.solid))),
        tst.stream(T(F.g), lat, T(tst.upwind_solid_masks(lat, F.solid)))))
    c["redistribute_on_interface_motion"] = (both, (1, 2), lambda F, lat, nt: (
        jops.redistribute_on_interface_motion(
            J(F.g), J(F.in_dom), J(F.in_dom_old),
            np.tile(lat.w, (nt, 1)), lat),
        tops.redistribute_on_interface_motion(
            T(F.g), T(F.in_dom), T(F.in_dom_old),
            np.tile(lat.w, (nt, 1)), lat)))
    c["renormalize_concentration"] = (both, (1, 2), lambda F, lat, nt: (
        jops.renormalize_concentration(
            J(F.g), J(F.conc), J(F.mass0), J(F.in_dom), J(F.ux * F.ux),
            None, u(F, J), lat),
        tops.renormalize_concentration(
            T(F.g), T(F.conc), T(F.mass0), T(F.in_dom), T(F.ux * F.ux),
            None, u(F, T), lat)))
    c["upwind_solid_masks"] = (both, (1,), lambda F, lat, nt: (
        jst.upwind_solid_masks(lat, F.solid),
        tst.upwind_solid_masks(lat, F.solid)))
    return c


OP_CASES = _op_cases()
OP_PARAMS = [(name, lat, nt) for name, (lats, nts, _) in sorted(OP_CASES.items())
             for lat in lats for nt in nts]


@pytest.mark.parametrize("name,lat,nt", OP_PARAMS,
                         ids=[f"{n}-{la}-T{t}" for n, la, t in OP_PARAMS])
def test_transport_op_matches_jnp_f64(name, lat, nt):
    lattice = LATTICES[lat]
    F = Fields(lattice, nt, seed=OP_PARAMS.index((name, lat, nt)))
    out_j, out_t = OP_CASES[name][2](F, lattice, nt)
    if not isinstance(out_j, tuple):
        out_j, out_t = (out_j,), (out_t,)
    for a, b in zip(out_j, out_t):
        a = np.asarray(a)
        b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
        assert a.shape == b.shape
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b)
        else:
            assert b.dtype == np.float64
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)


def _walled(ny, nx):
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    return geo.from_solid_mask(solid)


# the flow half of every coupled case: config 4's (the flagship's) flow
FLOW, BCS = flagship_flow()
FLOW_J = jcg.ColorGradientParams(**dataclasses.asdict(FLOW))
BCS_J = jcg.CGBoundaryConfig(**dataclasses.asdict(BCS))


def _models(case, n=32, **tp_change):
    g = _walled(n, n)
    tpj = jtr.TransportParams(**COUPLED_CASES[case] | tp_change)
    mj = jtr.TransportRK(g, FLOW_J, tpj, BCS_J, dtype=jnp.float64,
                         use_pallas=False)
    mt = TransportRK(g, params_from_jax(FLOW_J), params_from_jax(tpj),
                     params_from_jax(BCS_J), dtype=torch.float64, device=CPU)
    return mj, mt


def _jax_state(mj, n=32):
    fs = mj.flow.init_state_layers(1.0, 1.0, invading_rows=n // 5)
    return mj.init_state(fs, coupled_conc0(mj.tp.num_tracers, n, n))


def _packed(mj, st):
    return (torch.from_numpy(np.array(mj.flow.pack_state(st.f_r, st.f_b))),
            torch.from_numpy(np.array(st.g)))


@pytest.mark.parametrize("case", sorted(COUPLED_CASES))
def test_coupled_step_matches_jax_f64(case):
    """One step from the same state, four times along the JAX trajectory
    (un-jitted: XLA's fusion reassociates the f64 arithmetic)."""
    mj, mt = _models(case)
    st = _jax_state(mj)
    worst = 0.0
    for _ in range(4):
        s, g = mt.step_c(_packed(mj, st))
        st = mj._step_impl(st)
        want_s, want_g = _packed(mj, st)
        worst = max(worst, float((s - want_s).abs().max()),
                    float((g - want_g).abs().max()))
    assert worst < 1e-12


def _jax_compressed_coupled_step(mj, s, g, mass0):
    """The JAX model's coupled step (``_step_impl``) with its flow half in
    the compressed form: the tracer sub-step on the fields of s before the
    boundary rows, then ``flow._step_impl_c`` (what the Pallas compressed
    coupled kernel computes)."""
    rho_r, rho_b, rho = mj.flow.rho_fields_c(s)
    _, gx, gy, fx, fy = mj.flow.color_force_fields_from_rho(rho_r, rho_b)
    rho_safe = jnp.where(rho > 0, rho, 1.0)
    mx = s[1] - s[3] + s[5] - s[6] - s[7] + s[8]
    my = s[2] - s[4] + s[5] + s[6] - s[7] - s[8]
    u = ((mx + 0.5 * fx) / rho_safe, (my + 0.5 * fy) / rho_safe)
    g = mj._transport_substep(g, mass0, u, gx, gy, rho_r)
    return mj.flow._step_impl_c(s), g


def test_coupled_trajectory_matches_jax_f64_50_steps():
    """50 steps at 1e-10 against the JAX coupled step with the compressed
    flow half.  The split JAX step is no reference this far: the periodic
    seam between the red inlet rows and the blue outlet rows is an
    interface, so after about ten steps the boundary rows stop being
    single-phase, and there the JAX package's own compressed and split
    flow steps part (DEVIATIONS.md, "Compressed (f_total, rho_r) state
    layout"; 8.5e-4 apart after 50 steps on this setup)."""
    mj, mt = _models("a")
    st = _jax_state(mj)
    s, g = _packed(mj, st)
    sj, gj = mj.flow.pack_state(st.f_r, st.f_b), st.g
    for _ in range(50):
        sj, gj = _jax_compressed_coupled_step(mj, sj, gj, st.mass0)
        s, g = mt.step_c((s, g))
    assert bool(torch.isfinite(s).all()) and bool(torch.isfinite(g).all())
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=0, atol=1e-10)


def test_reference_matches_pallas_interpret_f64():
    """The kernel module's plain version == the Pallas coupled kernel it
    replaces (compressed, T=1) run in interpret mode."""
    mj, mt = _models("a")
    fused = mj.make_block_step(steps_per_call=1, rows_per_block=8,
                               compressed=True, interpret=True)
    st = _jax_state(mj)
    s, g = mj.flow.pack_state(st.f_r, st.f_b), st.g
    ts, tg = _packed(mj, st)
    for _ in range(2):
        s, g = fused(s, g)
        ts, tg = coupled_step_compressed_reference(ts, tg, mt)
    np.testing.assert_allclose(ts.numpy(), np.asarray(s), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tg.numpy(), np.asarray(g), rtol=0, atol=1e-12)


@pytest.mark.parametrize("mode", ["permeable", "none"])
def test_tracer_mass_conserved_without_tracer_rows_f64(mode):
    """With no tracer inlet or outlet rows, no reaction and a permeable
    interface the scheme moves tracer mass and never makes or loses it.
    (A bounce-back interface drops what reaches the domain from outside
    it, by design.)"""
    _, mt = _models("a", interface_mode=mode,
                    inlet="none", outlet="none")
    n = 32
    st = mt.init_state(mt.flow.init_state_layers(1.0, 1.0, n // 5),
                       coupled_conc0(2, n, n))
    s, g = mt.pack(st)
    for _ in range(20):
        s, g = mt.step_c((s, g))
    mass = mt.concentration(g).sum(dim=(-2, -1))
    np.testing.assert_allclose(mass.numpy(), st.mass0.numpy(), rtol=1e-12)


def test_plain_bf16_flow_storage_tracks_f32():
    """bf16 flow storage: the tracer PDFs stay float32 and track the f32
    coupled step within the bounds of the JAX package's
    test_coupled_bf16_storage_tracks_f32."""
    tp = TransportParams(num_tracers=1, scheme=5, tau=(1.0,), j0=(1 / 3,),
                         interface_mode="permeable", beta_interface=(0.5,))
    n = 32
    m32, mbf = (TransportRK(_walled(n, n), params_from_jax(FLOW_J), tp,
                            params_from_jax(BCS_J), dtype=torch.float32,
                            storage=st, device=CPU) for st in ("f32", "bf16"))
    conc0 = np.zeros((1, n, n))
    conc0[0, 20:28, :] = 1.0
    st = m32.init_state(m32.flow.init_state_layers(1.0, 1.0, 10), conc0)
    s, g_s = m32.pack(st)
    h, g_h = mbf.pack(st)
    for _ in range(6):
        s, g_s = m32.step_c((s, g_s))
        h, g_h = mbf.step_c((h, g_h))
    assert h.dtype == torch.bfloat16 and h.shape == (11, n, n)
    assert g_h.dtype == torch.float32
    u = mbf.flow.unpack_bf16(h)
    assert bool(torch.isfinite(u).all())
    assert float((u[:9] - s[:9]).abs().max()) < 1e-2
    assert float((u[9] - s[9]).abs().max()) < 2e-2
    assert float((g_h - g_s).abs().max()) < 2e-2
    mass0 = float(st.g.double().sum())
    assert abs(float(g_h.double().sum()) - float(g_s.double().sum())) / \
        mass0 < 1e-6


@pytest.mark.parametrize("change", [
    {"variant": "Perturbation"},
    {"scheme": 9, "inlet": "inamuro"},
], ids=["perturbation", "d2q9_inlet"])
def test_unported_options_raise(change):
    change = dict(change)
    flow = dataclasses.replace(FLOW, **{
        k: change.pop(k) for k in list(change) if k == "variant"})
    tp = TransportParams(**COUPLED_CASES["a"] | change)
    with pytest.raises(NotImplementedError):
        TransportRK(_walled(16, 8), flow, tp, BCS, device=CPU)


SPLIT_CASES = split_coupled_cases()


def _split_models(case, n=32):
    kw, tp = SPLIT_CASES[case]
    g = _walled(n, n)
    tpj = jtr.TransportParams(**tp)
    mj = jtr.TransportRK(g, FLOW_J, tpj, BCS_J, dtype=jnp.float64,
                         use_pallas=False, **kw)
    mt = TransportRK(g, params_from_jax(FLOW_J), params_from_jax(tpj),
                     params_from_jax(BCS_J), dtype=torch.float64, device=CPU,
                     **kw)
    return mj, mt


def _split_t(st):
    return TransportState(*(torch.from_numpy(np.array(a)) for a in st))


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_coupled_step_matches_jax_f64(case):
    """The split ``TransportRK.step`` against the JAX ``_step_impl`` (jnp,
    un-jitted): one step from the same state, four times along the JAX
    trajectory, to 1e-12, tracer mass on the BC rows.  Covers the
    conserve_mass renormalisation, the redistribute repair and
    standalone transport."""
    mj, mt = _split_models(case)
    st = _jax_state(mj)
    worst = 0.0
    for _ in range(4):
        got = mt.step(_split_t(st))
        st = mj._step_impl(st)
        worst = max(worst, *(float(np.abs(a.numpy() - np.asarray(b)).max())
                             for a, b in zip(got[:3], st[:3])))
    assert worst < 1e-12
    if case == "standalone":
        np.testing.assert_array_equal(got.f_r.numpy(), np.asarray(st.f_r))


@pytest.mark.parametrize("case", ["conserve_mass", "redistribute",
                                  "standalone"])
def test_split_only_options_refused_by_compressed_step(case):
    """The JAX package has no compressed coupled form of these options
    (``TransportRK.make_block_step`` returns None): ``step_c`` refuses
    them, the split ``step`` runs them."""
    _, mt = _split_models(case, n=16)
    st = mt.init_state(mt.flow.init_state_layers(1.0, 1.0, 4),
                       coupled_conc0(mt.tp.num_tracers, 16, 16))
    with pytest.raises(ValueError, match="compressed"):
        mt.step_c(mt.pack(st))
    assert all(bool(torch.isfinite(x).all()) for x in mt.step(st)[:3])


def test_renormalize_concentration_adds_mass_as_the_reference_does():
    """``renormalize_concentration`` is ported as written: on the active
    domain nodes it adds conc * mass0 / total instead of rescaling the
    domain's tracer to mass0.  With tracer leaving through the BC rows the
    mass should return to mass0; instead it grows to 2.73 x mass0 in four
    steps (32x32, f64; 0.85 x mass0 without the repair), and the JAX step
    does the same to 1e-12 relative."""
    n = 32
    mj, mt = _split_models("conserve_mass", n=n)
    st = _jax_state(mj, n=n)
    mass0 = float(np.asarray(st.mass0).sum())
    t = _split_t(st)
    for _ in range(4):
        st = mj._step_impl(st)
        t = mt.step(t)
    mass_j = float(np.asarray(st.g).sum())
    mass_t = float(t.g.sum())
    assert abs(mass_t - mass_j) <= 1e-12 * mass_j
    assert mass_t > 2.5 * mass0


@pytest.mark.parametrize("case", ["conserve_mass", "redistribute"])
def test_plain_coupled_hands_repairs_the_jax_pre_step_fields(case):
    """The pre-step velocity and transport-domain mask that
    ``plain_coupled`` (and the kernels) hand ``TransportRK.repair`` equal
    the ones the JAX ``_step_impl`` computes from the same state: u to
    1e-12, the mask exactly."""
    mj, mt = _split_models(case, n=16)
    st = mj.init_state(mj.flow.init_state_layers(1.0, 1.0, 4),
                       coupled_conc0(mj.tp.num_tracers, 16, 16))
    rho_r, rho_b, _, _, _, fx, fy = mj.flow.color_force_fields(st.f_r,
                                                               st.f_b)
    rho = rho_r + rho_b
    rho_safe = jnp.where(rho > 0, rho, 1.0)
    mx, my = mj.flow.lat.e.T @ np.asarray(st.f_r + st.f_b).reshape(9, -1)
    want_u = np.stack([(mx.reshape(16, 16) + 0.5 * np.asarray(fx)),
                       (my.reshape(16, 16) + 0.5 * np.asarray(fy))]) / \
        np.asarray(rho_safe)
    want_dom, _ = jops.transport_domain_mask(rho_r, mj.tp.criteria)
    _, _, _, u, in_domain = mt.plain_coupled(_split_t(st))
    assert float(np.abs(u.numpy() - want_u).max()) < 1e-12
    np.testing.assert_array_equal(in_domain.numpy(), np.asarray(want_dom))


def test_split_wrapper_on_cpu_is_plain_and_uncounted():
    _, mt = _split_models("conserve_mass", n=16)
    st = mt.init_state(mt.flow.init_state_layers(1.0, 1.0, 4),
                       coupled_conc0(mt.tp.num_tracers, 16, 16))
    before = coupled_step_split.launches
    out = coupled_step_split(st, mt)
    ref = coupled_step_split_reference(st, mt)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert coupled_step_split.launches == before
    with pytest.raises(ValueError, match="devices"):
        coupled_step_split(st._replace(g=st.g.to("meta")), mt)


def test_convert_transport_params_and_states():
    for case in sorted(COUPLED_CASES):
        p = jtr.TransportParams(**COUPLED_CASES[case])
        q = params_from_jax(p)
        assert isinstance(q, TransportParams)
        assert dataclasses.asdict(q) == dataclasses.asdict(p)
    mj, mt = _models("a")
    st = _jax_state(mj)
    pair = (np.asarray(mj.flow.pack_state_bf16(st.f_r, st.f_b)),
            np.asarray(st.g))
    back = state_to_numpy(state_from_numpy(pair, CPU))
    for a, b in zip(pair, back):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    split = state_from_numpy(jtr.TransportState(
        *(np.asarray(a) for a in st)), CPU)
    assert isinstance(split, TransportState)
    s, g = mt.pack(split)
    want_s, want_g = _packed(mj, st)
    np.testing.assert_array_equal(s.numpy(), want_s.numpy())
    np.testing.assert_array_equal(g.numpy(), want_g.numpy())
    assert isinstance(state_to_numpy(split), TransportState)


def test_wrapper_on_cpu_is_plain_and_uncounted():
    mj, mt = _models("b")
    s, g = _packed(mj, _jax_state(mj))
    before = coupled_step_compressed.launches
    out = coupled_step_compressed(s, g, mt)
    ref = coupled_step_compressed_reference(s, g, mt)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert coupled_step_compressed.launches == before
    with pytest.raises(ValueError, match="device"):
        coupled_step_compressed(s, g.to("meta"), mt)
    with pytest.raises(ValueError, match="device"):
        coupled_step_compressed(s.to("meta"), g.to("meta"), mt)
