"""The ops of openlbmpm_torch.ops on D3Q19 stacks (nz, ny, nx) against their
jnp ops in openlbmpm_tpu.ops, at f64 on the same random fields (atol
1e-12), as the 3-D colour-gradient model calls them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openlbmpm_tpu.geometry import solid_normals_nd, wetting_masks_nd
from openlbmpm_tpu.lattice import D3Q19
from openlbmpm_tpu.ops import collision as jcol
from openlbmpm_tpu.ops import colorgrad as jcg
from openlbmpm_tpu.ops import common as jcommon
from openlbmpm_tpu.ops import equilibrium as jeq
from openlbmpm_tpu.ops import forcing as jforce
from openlbmpm_tpu.ops import macroscopic as jmac
from openlbmpm_tpu.ops import streaming as jst
from openlbmpm_torch.ops import collision as tcol
from openlbmpm_torch.ops import colorgrad as tcg
from openlbmpm_torch.ops import common as tcommon
from openlbmpm_torch.ops import equilibrium as teq
from openlbmpm_torch.ops import forcing as tforce
from openlbmpm_torch.ops import macroscopic as tmac
from openlbmpm_torch.ops import streaming as tst

torch.set_num_threads(1)

NZ, NY, NX = 10, 8, 12
LAT = D3Q19
SHAPE = (NZ, NY, NX)


class Fields:
    """Random f64 inputs shared by both packages (numpy first)."""

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.f = rng.uniform(0.01, 0.2, (19,) + SHAPE)
        self.feq = rng.uniform(0.01, 0.2, (19,) + SHAPE)
        self.rho = rng.uniform(0.5, 1.5, SHAPE)
        self.rr = rng.uniform(0.0, 1.0, SHAPE)
        self.rb = rng.uniform(0.0, 1.0, SHAPE)
        self.rr[0, 0, :3] = self.rb[0, 0, :3] = 0.0   # both densities vanish
        self.u = tuple(rng.uniform(-0.05, 0.05, (3,) + SHAPE))
        self.force = tuple(rng.uniform(-1e-3, 1e-3, (3,) + SHAPE))
        self.tau = rng.uniform(0.6, 1.5, SHAPE)
        self.phi = rng.uniform(-1.0, 1.0, SHAPE)
        self.g = tuple(rng.uniform(-0.2, 0.2, (3,) + SHAPE))
        for c in self.g:
            c[5, 2, :2] = 0.0                        # zero-gradient guards
        solid = rng.random(SHAPE) < 0.15
        solid[:, 0, :] = solid[:, -1, :] = True
        self.solid = solid
        self.fluid = ~solid
        self.ns = solid_normals_nd(solid, LAT)
        self.wet = wetting_masks_nd(solid, LAT)[0].astype(bool)
        # a gradient along a wall normal: the rotation's sin = 0 guard
        k = tuple(np.argwhere(self.wet)[0])
        for d in range(3):
            self.g[d][k] = -0.1 * self.ns[d][k]


def J(a):
    if isinstance(a, tuple):
        return tuple(jnp.asarray(x) for x in a)
    return jnp.asarray(a)


def T(a):
    if isinstance(a, tuple):
        return tuple(T(x) for x in a)
    return torch.from_numpy(np.ascontiguousarray(a))


def _pairs(out_j, out_t):
    """Flatten nested tuples of results into (jax, torch) numpy pairs."""
    if isinstance(out_j, tuple):
        return [p for a, b in zip(out_j, out_t) for p in _pairs(a, b)]
    return [(np.asarray(out_j), out_t.numpy() if torch.is_tensor(out_t)
             else np.asarray(out_t))]


def _cases():
    d = LAT
    c = {}
    c["shift"] = lambda F: (jcommon.shift(J(F.f), 1, -1, 1),
                            tcommon.shift(T(F.f), 1, -1, 1))
    c["pull"] = lambda F: (jcommon.pull(J(F.f), -1, 0, 1),
                           tcommon.pull(T(F.f), -1, 0, 1))
    c["density"] = lambda F: (jmac.density(J(F.f), spatial_dim=3),
                              tmac.density(T(F.f), 3))
    c["momentum"] = lambda F: (jmac.momentum(d, J(F.f)),
                               tmac.momentum(d, T(F.f)))
    c["feq_quadratic"] = lambda F: (jeq.feq_quadratic(d, J(F.rho), J(F.u)),
                                    teq.feq_quadratic(d, T(F.rho), T(F.u)))
    c["guo_source"] = lambda F: (
        jforce.guo_source(d, J(F.u), J(F.force)),
        tforce.guo_source(d, T(F.u), T(F.force)))
    c["guo_source_prefactor"] = lambda F: (
        jforce.guo_source(d, J(F.u), J(F.force), J(F.tau)),
        tforce.guo_source(d, T(F.u), T(F.force), T(F.tau)))
    c["bgk_field_tau"] = lambda F: (
        jcol.bgk_field_tau(J(F.f), J(F.feq), J(F.tau)),
        tcol.bgk_field_tau(T(F.f), T(F.feq), T(F.tau)))
    c["upwind_solid_masks"] = lambda F: (
        jst.upwind_solid_masks(d, F.solid), tst.upwind_solid_masks(d, F.solid))
    us = lambda F: jst.upwind_solid_masks(d, F.solid)  # noqa: E731
    c["stream"] = lambda F: (jst.stream(J(F.f), d, J(us(F))),
                             tst.stream(T(F.f), d, T(us(F))))
    c["solid_phi_extrapolate"] = lambda F: (
        jcg.solid_phi_extrapolate(J(F.phi * F.fluid), J(F.fluid), d),
        tcg.solid_phi_extrapolate(T(F.phi * F.fluid), T(F.fluid), d))
    c["color_gradient"] = lambda F: (jcg.color_gradient(J(F.phi), d),
                                     tcg.color_gradient(T(F.phi), d))
    for inward in (False, True):
        c[f"csf_force_nd_inward_{inward}"] = (lambda inward: lambda F: (
            jcg.csf_force_nd(J(F.g), 0.05, J(F.fluid), inward, d),
            tcg.csf_force_nd(T(F.g), 0.05, T(F.fluid), inward, d)))(inward)
    c["rotate_gradient_on_wetting_akai_nd"] = lambda F: (
        jcg.rotate_gradient_on_wetting_akai_nd(J(F.g), J(F.ns), -0.5, 0.866,
                                               J(F.wet)),
        tcg.rotate_gradient_on_wetting_akai_nd(T(F.g), T(F.ns), -0.5, 0.866,
                                               T(F.wet)))
    c["recolor_lkr_nd"] = lambda F: (
        jcg.recolor_lkr_nd(J(F.f), J(F.rr), J(F.rb), J(F.g), 0.7, d),
        tcg.recolor_lkr_nd(T(F.f), T(F.rr), T(F.rb), T(F.g), 0.7, d))
    return c


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_3d_matches_jnp_f64(name):
    F = Fields(seed=sorted(CASES).index(name))
    pairs = _pairs(*CASES[name](F))
    assert pairs
    for a, b in pairs:
        assert a.shape == b.shape
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b)
        else:
            assert b.dtype == np.float64
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)


def test_2d_signatures_keep_their_axes():
    """The 2-D callers reduce and broadcast over the Q axis at -3 (a (9, ny,
    nx) stack); density has no default dimension, so no caller can sum a
    3-D stack over nz."""
    f = torch.rand(9, 5, 7, dtype=torch.float64)
    assert tmac.density(f, 2).shape == (5, 7)
    with pytest.raises(TypeError):
        tmac.density(f)
    assert tcommon.bcast_1d(np.arange(9), f).shape == (9, 1, 1)
    f3 = torch.rand(19, 4, 5, 7, dtype=torch.float64)
    assert tmac.density(f3, 3).shape == (4, 5, 7)
    assert tcommon.bcast_1d(np.arange(19), f3, 3).shape == (19, 1, 1, 1)
