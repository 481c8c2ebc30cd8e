"""K10's bf16 march collision (``sc_collide`` through ``collide_sc``,
csrc/flow3d.cuh) against the plain path, on the CPU at f64.

The collision forms the common velocity from each fluid's momenta in fluid
order, then each fluid's collision in turn (``sc_collide_fluid``), and
the march stores every post value into its shared-memory ring.
``collide_each`` repeats that order in numpy, cell-wise over the grid,
one fluid at a time (the order a collision that holds one fluid's
populations at a time keeps too), and the result, streamed by the JAX
package's ``stream``, is held to the JAX ``ShanChenMCMP3D._step_impl``
and the port's ``sc3d_step_reference`` at f64 on chip_smoke.py's
SC3D_CASES.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openlbmpm_tpu import geometry as jgeo
from openlbmpm_tpu.lattice import D3Q19 as JD3Q19
from openlbmpm_tpu.models.flow3d import ShanChenMCMP3D as JShanChen3D
from openlbmpm_tpu.models.flow3d import ShanChenParams3D as JParams3D
from openlbmpm_tpu.ops.streaming import stream, upwind_solid_masks
from openlbmpm_torch.kernels import build
from openlbmpm_torch.kernels.flow3d import sc3d_step_reference
from openlbmpm_torch.lattice import D3Q19

E = D3Q19.e.astype(int)
W = D3Q19.w.astype(np.float64)
Q = 19
SHAPE = (10, 9, 11)
SRC = (build.SRC_DIR / "flow3d.cuh").read_text()


def _shift(a, i):
    """a(x + e_i) on the (z, y, x) axes (periodic)."""
    return np.roll(a, (-E[i, 2], -E[i, 1], -E[i, 0]), axis=(-3, -2, -1))


def collide_each(f, solid, p):
    """The post-collision values of every fluid, in sc_collide's order
    (sc_sums, the common velocity fluid by fluid, sc_collide_fluid), at
    every cell; solid cells 0."""
    k_n = f.shape[0]
    fluid = ~solid
    rho = np.zeros((k_n,) + f.shape[2:])
    for k in range(k_n):             # rho_kernel: sumq in index order
        r = f[k, 0].copy()
        for i in range(1, Q):
            r = r + f[k, i]
        rho[k] = np.where(fluid, r, 0.0)
    # sc_sums: the interaction sums and the adhesion field, in i order
    gr = np.zeros((k_n, 3) + f.shape[2:])
    adh = np.zeros((3,) + f.shape[2:])
    for i in range(1, Q):
        nb_solid = _shift(solid, i)
        for d in range(3):
            e = E[i, d]
            if not e:
                continue
            adh[d] = adh[d] + np.where(nb_solid, W[i] * e, 0.0)
            for k in range(k_n):
                gr[k, d] = gr[k, d] + (W[i] * e) * _shift(rho[k], i)
    # the common velocity: one fluid's momenta at a time
    den = num = None
    for k in range(k_n):
        m = []
        for d in range(3):
            a = np.zeros(f.shape[2:])
            for i in range(1, Q):
                if E[i, d]:
                    a = a + float(E[i, d]) * f[k, i]
            m.append(a)
        it = 1.0 / p.tau[k]
        den = rho[k] * it if k == 0 else den + rho[k] * it
        num = [m[d] * it for d in range(3)] if k == 0 else \
            [num[d] + m[d] * it for d in range(3)]
    den = np.where(den != 0, den, 1.0)
    up = [num[d] / den for d in range(3)]
    # each fluid's collision (sc_collide_fluid_each's arithmetic)
    post = np.zeros_like(f)
    for k in range(k_n):
        rs = np.where(rho[k] > 0, rho[k], 1.0)
        tau = p.tau[k]
        u = []
        for d in range(3):
            gv = p.g_matrix[k][0] * gr[0, d]
            for j in range(1, k_n):
                gv = gv + p.g_matrix[k][j] * gr[j, d]
            force = -rho[k] * (gv + p.g_solid[k] * adh[d]) + \
                p.body_force[d] * rho[k]
            u.append(up[d] + tau * force / rs)
        uu = u[0] * u[0] + u[1] * u[1] + u[2] * u[2]
        for i in range(Q):
            eu = float(E[i, 0]) * u[0] + float(E[i, 1]) * u[1] + \
                float(E[i, 2]) * u[2]
            feq = W[i] * rho[k] * (1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * uu)
            post[k, i] = np.where(fluid, f[k, i] - (f[k, i] - feq) / tau, 0.0)
    return post


def _case(name):
    import chip_smoke
    m, f = chip_smoke.sc3d_case(name, "cpu", shape=SHAPE)
    return m, f, chip_smoke.SC3D_CASES[name][0]


@pytest.mark.parametrize("name", ["k2_periodic", "k2_walls_force", "k3",
                                  "k1_obstacle", "k2_grains"])
def test_collision_one_fluid_at_a_time_equals_plain_f64(name):
    """The collision one fluid at a time, streamed by the JAX pull, equals
    the JAX jnp step and the port's plain step at f64."""
    m, f, kw = _case(name)
    solid = np.asarray(m.geo.is_solid, bool)
    p = m.p
    f64 = f.double().numpy()
    post = collide_each(f64, solid, p)
    up = jnp.asarray(upwind_solid_masks(JD3Q19, solid))
    got = np.asarray(stream(jnp.asarray(post), JD3Q19, up)) * ~solid
    jm = JShanChen3D(jgeo.from_solid_mask(solid), JParams3D(**kw),
                     dtype=jnp.float64, use_pallas=False)
    want = np.asarray(jm._step_impl(jnp.asarray(f64)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-15)
    plain = sc3d_step_reference(f.double(), m).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=2e-15)


def test_march_collision_order_and_its_fault():
    """sc_collide, which march_kernel's Shan-Chen branch reaches through
    collide_sc, forms the common velocity over the fluids in order before
    any fluid's collision; chip_faults.py's K10 bf16 fault replaces its
    denominator's line, which stays there once, in the float instances:
    phase 37 must fail, phase 36 (the f32 and f64 push) pass."""
    import chip_faults
    body = SRC[SRC.index("__device__ __forceinline__ void sc_collide("):]
    body = body[:body.index("\n}\n")]
    assert body.index("den = k == 0 ?") < body.index("sc_collide_fluid(")
    march = SRC[SRC.index("march_kernel(const S* __restrict__ f"):]
    march = march[:march.index("\n}\n")]
    assert "collide_sc<S, K>(" in march
    header, line, fault, phases = chip_faults.CASES["K10 bf16 common velocity"]
    assert header == "flow3d.cuh" and SRC.count(line) == 1 and line in body
    assert "sizeof(C) == 4" in fault and phases == ("37",)
    assert chip_faults.MUST_PASS["K10 bf16 common velocity"] == ("36",)
