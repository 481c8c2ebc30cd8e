"""Each ported op of openlbmpm_torch.ops against its jnp op in
openlbmpm_tpu.ops, at f64 on the same random fields (atol 1e-12)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openlbmpm_tpu.geometry import solid_normals, wetting_masks
from openlbmpm_tpu.lattice import D2Q9
from openlbmpm_tpu.ops import boundaries as jbc
from openlbmpm_tpu.ops import collision as jcol
from openlbmpm_tpu.ops import colorgrad as jcg
from openlbmpm_tpu.ops import common as jcommon
from openlbmpm_tpu.ops import equilibrium as jeq
from openlbmpm_tpu.ops import forcing as jforce
from openlbmpm_tpu.ops import macroscopic as jmac
from openlbmpm_tpu.ops import streaming as jst
from openlbmpm_torch.ops import boundaries as tbc
from openlbmpm_torch.ops import collision as tcol
from openlbmpm_torch.ops import colorgrad as tcg
from openlbmpm_torch.ops import common as tcommon
from openlbmpm_torch.ops import equilibrium as teq
from openlbmpm_torch.ops import forcing as tforce
from openlbmpm_torch.ops import macroscopic as tmac
from openlbmpm_torch.ops import streaming as tst

torch.set_num_threads(1)

NY, NX = 12, 16
LAT = D2Q9


class Fields:
    """Random f64 inputs shared by both packages (numpy first)."""

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.f = rng.uniform(0.01, 0.2, (9, NY, NX))
        self.feq = rng.uniform(0.01, 0.2, (9, NY, NX))
        self.s = np.concatenate(
            [self.f, rng.uniform(0.0, 1.0, (1, NY, NX))], axis=0)
        self.rho = rng.uniform(0.5, 1.5, (NY, NX))
        self.rr = rng.uniform(0.0, 1.0, (NY, NX))
        self.rb = rng.uniform(0.0, 1.0, (NY, NX))
        self.rr[0, :3] = self.rb[0, :3] = 0.0   # both densities vanish
        self.ux, self.uy = rng.uniform(-0.05, 0.05, (2, NY, NX))
        self.fx, self.fy = rng.uniform(-1e-3, 1e-3, (2, NY, NX))
        self.tau = rng.uniform(0.6, 1.5, (NY, NX))
        self.phi = rng.uniform(-1.0, 1.0, (NY, NX))
        self.phi[3, 4:8] = 0.99    # |phi| > delta branches
        self.phi[4, 4:8] = -0.99
        self.gx, self.gy = rng.uniform(-0.2, 0.2, (2, NY, NX))
        self.gx[5, :2] = self.gy[5, :2] = 0.0   # zero-gradient guards
        solid = rng.random((NY, NX)) < 0.15
        solid[:, 0] = solid[:, -1] = True
        self.solid = solid
        self.fluid = ~solid
        self.nsx, self.nsy = solid_normals(solid)
        self.wet = wetting_masks(solid)[0].astype(bool)
        self.row_mask = rng.random(NX) < 0.8


def J(a):
    return jnp.asarray(a)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pairs(out_j, out_t):
    if not isinstance(out_j, tuple):
        out_j, out_t = (out_j,), (out_t,)
    return [(np.asarray(a), b.numpy() if torch.is_tensor(b) else np.asarray(b))
            for a, b in zip(out_j, out_t)]


def _cases():
    d = LAT
    c = {}
    c["shift"] = lambda F: (jcommon.shift(J(F.f), 1, -1),
                            tcommon.shift(T(F.f), 1, -1))
    c["pull"] = lambda F: (jcommon.pull(J(F.f), -1, 1),
                           tcommon.pull(T(F.f), -1, 1))
    c["density"] = lambda F: (jmac.density(J(F.f)), tmac.density(T(F.f)))
    c["momentum"] = lambda F: (jmac.momentum(d, J(F.f)),
                               tmac.momentum(d, T(F.f)))
    c["feq_quadratic"] = lambda F: (
        jeq.feq_quadratic(d, J(F.rho), (J(F.ux), J(F.uy))),
        teq.feq_quadratic(d, T(F.rho), (T(F.ux), T(F.uy))))
    c["guo_source"] = lambda F: (
        jforce.guo_source(d, (J(F.ux), J(F.uy)), (J(F.fx), J(F.fy)),
                          J(F.tau)),
        tforce.guo_source(d, (T(F.ux), T(F.uy)), (T(F.fx), T(F.fy)),
                          T(F.tau)))
    c["bgk_field_tau"] = lambda F: (
        jcol.bgk_field_tau(J(F.f), J(F.feq), J(F.tau)),
        tcol.bgk_field_tau(T(F.f), T(F.feq), T(F.tau)))
    s_rk = jcol.mrt_relaxation_d2q9_rk()
    c["mrt_variable_nu"] = lambda F: (
        jcol.mrt_variable_nu(J(F.f), J(F.feq), d, s_rk, 1.0 / J(F.tau)),
        tcol.mrt_variable_nu(T(F.f), T(F.feq), d, s_rk, 1.0 / T(F.tau)))
    c["mrt_force_transform_variable"] = lambda F: (
        jcol.mrt_force_transform_variable(J(F.f), d, s_rk, 1.0 / J(F.tau)),
        tcol.mrt_force_transform_variable(T(F.f), d, s_rk, 1.0 / T(F.tau)))
    c["mrt_relaxation_d2q9_rk"] = lambda F: (
        jcol.mrt_relaxation_d2q9_rk(0.8), tcol.mrt_relaxation_d2q9_rk(0.8))
    c["phase_field"] = lambda F: (jcg.phase_field(J(F.rr), J(F.rb)),
                                  tcg.phase_field(T(F.rr), T(F.rb)))
    c["solid_phi_extrapolate"] = lambda F: (
        jcg.solid_phi_extrapolate(J(F.phi * F.fluid), J(F.fluid)),
        tcg.solid_phi_extrapolate(T(F.phi * F.fluid), T(F.fluid)))
    c["color_gradient"] = lambda F: (jcg.color_gradient(J(F.phi)),
                                     tcg.color_gradient(T(F.phi)))
    for name, jf, tf, ct in (
            ("rotate_xu", jcg.rotate_gradient_on_wetting_xu,
             tcg.rotate_gradient_on_wetting_xu, 0.5),
            ("rotate_akai", jcg.rotate_gradient_on_wetting_akai,
             tcg.rotate_gradient_on_wetting_akai, -0.5)):
        c[name] = (lambda jf, tf, ct: lambda F: (
            jf(J(F.gx), J(F.gy), J(F.nsx), J(F.nsy), ct, 0.866, J(F.wet)),
            tf(T(F.gx), T(F.gy), T(F.nsx), T(F.nsy), ct, 0.866, T(F.wet))))(
                jf, tf, ct)
    for inward in (False, True):
        c[f"csf_force_inward_{inward}"] = (lambda inward: lambda F: (
            jcg.csf_force(J(F.gx), J(F.gy), 0.1, J(F.fluid), inward),
            tcg.csf_force(T(F.gx), T(F.gy), 0.1, T(F.fluid), inward)))(inward)
    for opt in (1, 2):
        c[f"tau_interp_csf_{opt}"] = (lambda opt: lambda F: (
            jcg.tau_interp_csf(J(F.phi), J(F.rr), J(F.rb), 1.0, 0.7, 0.98,
                               opt),
            tcg.tau_interp_csf(T(F.phi), T(F.rr), T(F.rb), 1.0, 0.7, 0.98,
                               opt)))(opt)
    c["recolor_lkr"] = lambda F: (
        jcg.recolor_lkr(J(F.f), J(F.rr), J(F.rb), J(F.gx), J(F.gy), 0.7),
        tcg.recolor_lkr(T(F.f), T(F.rr), T(F.rb), T(F.gx), T(F.gy), 0.7))
    c["upwind_solid_masks"] = lambda F: (
        jst.upwind_solid_masks(d, F.solid), tst.upwind_solid_masks(d, F.solid))
    us = lambda F: jst.upwind_solid_masks(d, F.solid)  # noqa: E731
    c["stream"] = lambda F: (jst.stream(J(F.f), d, J(us(F))),
                             tst.stream(T(F.f), d, T(us(F))))
    c["total_velocity_inlet_top_c"] = lambda F: (
        jbc.total_velocity_inlet_top_c(J(F.s), -1e-3, NY - 2, J(F.row_mask)),
        tbc.total_velocity_inlet_top_c(T(F.s), -1e-3, NY - 2, T(F.row_mask)))
    c["zou_he_pressure_top_total_c"] = lambda F: (
        jbc.zou_he_pressure_top_total_c(J(F.s), 1.02, NY - 2, J(F.row_mask)),
        tbc.zou_he_pressure_top_total_c(T(F.s), 1.02, NY - 2, T(F.row_mask)))
    c["total_pressure_outlet_bottom_c"] = lambda F: (
        jbc.total_pressure_outlet_bottom_c(J(F.s), 0.98, 1, J(F.row_mask)),
        tbc.total_pressure_outlet_bottom_c(T(F.s), 0.98, 1, T(F.row_mask)))
    c["copy_row"] = lambda F: (
        jbc.copy_row(J(F.s), NY - 1, NY - 2, J(F.row_mask)),
        tbc.copy_row(T(F.s), NY - 1, NY - 2, T(F.row_mask)))
    c["copy_rows_from_above"] = lambda F: (
        jbc.copy_rows_from_above(J(F.s), (2, 1, 0), (J(F.row_mask),) * 3),
        tbc.copy_rows_from_above(T(F.s), (2, 1, 0), (T(F.row_mask),) * 3))
    return c


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jnp_f64(name):
    F = Fields(seed=sorted(CASES).index(name))
    out_j, out_t = CASES[name](F)
    pairs = _pairs(out_j, out_t)
    assert pairs
    for a, b in pairs:
        assert a.shape == b.shape
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b)
        else:
            assert b.dtype == np.float64
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)
