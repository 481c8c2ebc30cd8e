"""K8's push streaming and its outlet rows against the JAX package's pull
and jnp outlet rows, on the CPU at f64.

``sc_push_kernel`` (csrc/sc2d.cuh) steps the f32 and f64 Shan-Chen states
by push: a block of a 32 x 8 tile fills psi_k and the fluid flags of the
tile plus a ring of R cells (the stencil's reach: 1 for the original SC
and iso-4, 2 for iso-8, 3 for iso-10) with wrapped coordinates, then the
thread of fluid cell x forms its interaction sums from that ring and
writes post_i into slot i of x + e_i, or into slot opp(i) of x where
x + e_i is solid; a solid cell writes its own K x 9 zeros.  Then
``sc_outlet_kernel`` rewrites the outlet rows in place, one thread a
column: the Zou-He row d and its ghosts below it, or the convective rows
d + 1 ... 0, each copying the row above, on fluid cells.

``push_mirror`` repeats the push's walk in numpy (tiles, the ring's
wrapped coordinates, the stencil sums read from the ring, the placement)
and counts the writes of every slot; ``outlet_mirror`` repeats the outlet
launch.  Held against ``openlbmpm_tpu/ops/streaming.py::stream`` times the
fluid mask, ``ops/shanchen.py::stencil_weighted_grad`` and the JAX model's
jnp outlet rows (``ShanChenMCMP._apply_outlet``) on random values for K =
1, 2, 3 over random masks full of one-cell slivers and masks with solid
rows and columns on the periodic seams: equal value for value, every slot
written exactly once.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest

from openlbmpm_tpu import geometry as jgeo
from openlbmpm_tpu.lattice import D2Q9 as JD2Q9
from openlbmpm_tpu.lattice import ISO_STENCILS, IsoStencil
from openlbmpm_tpu.models import shanchen as js
from openlbmpm_tpu.ops.shanchen import stencil_weighted_grad
from openlbmpm_tpu.ops.streaming import stream, upwind_solid_masks
from openlbmpm_torch.kernels import build
from openlbmpm_torch.lattice import D2Q9


def _constant(name):
    """The integer constant `name` of csrc/sc2d.cuh."""
    src = (build.SRC_DIR / "sc2d.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


TX, TY = _constant("TX"), _constant("TY")
SHAPE = (21, 70)   # (ny, nx): three tile rows and three tile columns, the
#                    last of each partial
REACH = {0: 1, 4: 1, 8: 2, 10: 3}
# the original SC force's stencil: the D2Q9 weights on the nearest cells
SC_STENCIL = IsoStencil(0, [(int(e[0]), int(e[1])) for e in JD2Q9.e[1:]],
                        [float(w) for w in JD2Q9.w[1:]])


def _stencil(order):
    return SC_STENCIL if order == 0 else ISO_STENCILS[order]


def push_mirror(post, fluid, psi, order):
    """The push's walk over the tiles: (out, writes, sums) with out the
    written values (0 where none), writes how often each slot was written
    and sums (K, 2, ny, nx) the interaction sums each fluid cell forms
    from the tile's psi ring (0 elsewhere).  `post` (K, 9, ny, nx), `fluid`
    (ny, nx) bool, `psi` (K, ny, nx).  Each tile's cells at once, as the
    block's threads run."""
    k, _, ny, nx = post.shape
    r = REACH[order]
    st = _stencil(order)
    e, opp = D2Q9.e.astype(int), D2Q9.opp
    out = np.zeros_like(post)
    writes = np.zeros(post.shape, np.int64)
    sums = np.zeros((k, 2, ny, nx))
    for by in range(-(-ny // TY)):
        for bx in range(-(-nx // TX)):
            x0, y0 = bx * TX, by * TY
            # the ring: the tile and R cells a side, each cell wrapped as
            # the fill wraps it
            ys = [(y0 - r + h) % ny for h in range(TY + 2 * r)]
            xs = [(x0 - r + h) % nx for h in range(TX + 2 * r)]
            ring_fl = fluid[np.ix_(ys, xs)]
            ring_psi = psi[:, ys][:, :, xs]
            # the tile's threads inside the domain
            th, tw = min(TY, ny - y0), min(TX, nx - x0)
            y, x = np.mgrid[y0:y0 + th, x0:x0 + tw]

            def ring(a, dy, dx):   # the ring at each thread's cell + (dx, dy)
                return a[..., r + dy:r + dy + th, r + dx:r + dx + tw]
            own = ring(ring_fl, 0, 0)
            for (dx, dy), w in zip(st.offsets, st.weights):
                v = ring(ring_psi, dy, dx) * own
                sums[:, 0, y, x] += w * dx * v
                sums[:, 1, y, x] += w * dy * v
            sy, sx = y[~own], x[~own]          # solid cells: their own zeros
            out[:, :, sy, sx] = 0.0
            writes[:, :, sy, sx] += 1
            for i in range(9):
                ex, ey = e[i]
                to_nb = own & ring(ring_fl, ey, ex)
                back = own & ~to_nb
                ty, tx = (y[to_nb] + ey) % ny, (x[to_nb] + ex) % nx
                out[:, i, ty, tx] = post[:, i, y[to_nb], x[to_nb]]
                np.add.at(writes, (slice(None), i, ty, tx), 1)
                by_, bx_ = y[back], x[back]
                out[:, opp[i], by_, bx_] = post[:, i, by_, bx_]
                np.add.at(writes, (slice(None), opp[i], by_, bx_), 1)
    return out, writes, sums


def _zou_he_bottom(f, rho_t):
    """csrc/sc2d.cuh::outlet_zou_he of one fluid's nine values."""
    f = f.copy()
    rv = rho_t * (1.0 - (f[0] + f[1] + f[3] + 2.0 * (f[4] + f[7] + f[8]))
                  / rho_t)
    d31 = 0.5 * (f[3] - f[1])
    f[2] = f[4] + 2.0 / 3.0 * rv
    f[5] = f[7] + d31 + rv / 6.0
    f[6] = f[8] - d31 + rv / 6.0
    return f


def outlet_mirror(f, fluid, d, outlet, rho_out):
    """sc_outlet_kernel's rows, one column at a time, in place on a copy of
    f (K, 9, ny, nx): (rows, writes) with writes how often each cell was
    written; `outlet` 1 Zou-He pressure (rho_out a value a fluid), 2
    convective."""
    f = f.copy()
    writes = np.zeros(f.shape[2:], np.int64)
    for x in range(f.shape[3]):
        if outlet == 1:
            col = f[:, :, d, x].copy()
            if fluid[d, x]:
                col = np.stack([_zou_he_bottom(c, rho_out[k])
                                for k, c in enumerate(col)])
                f[:, :, d, x] = col
                writes[d, x] += 1
            for r in range(d - 1, -1, -1):
                if fluid[r, x]:
                    f[:, :, r, x] = col
                    writes[r, x] += 1
        else:
            for r in range(d + 1, -1, -1):
                if fluid[r, x]:
                    f[:, :, r, x] = f[:, :, r + 1, x]
                    writes[r, x] += 1
    return f, writes


def _solid(kind, seed):
    """(ny, nx) solid masks: random cells (one-cell slivers and isolated
    fluid cells) or rows and columns on the periodic seams with holes."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random(SHAPE) < 0.3
    solid = np.zeros(SHAPE, bool)
    solid[0] = solid[-1] = rng.random(SHAPE[1]) < 0.6
    solid[:, 0] |= rng.random(SHAPE[0]) < 0.5
    solid[:, -1] |= rng.random(SHAPE[0]) < 0.5
    return solid


def _jax_stream(post, solid):
    """ops/streaming.py::stream of each fluid, times the fluid mask."""
    up = upwind_solid_masks(JD2Q9, solid)
    fl = (~solid).astype(np.float64)
    return np.stack([np.asarray(stream(jnp.asarray(p), JD2Q9, up)) * fl
                     for p in post])


@pytest.mark.parametrize("order", [0, 4, 8, 10])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("kind", ["random", "seams"])
def test_push_equals_jax_stream_and_writes_each_slot_once(kind, k, order):
    """The push of K fluids places every value where the JAX pull takes it
    from, writing each slot once, and the ring holds the R cells a side
    that the interaction sums read."""
    solid = _solid(kind, seed=k + order)
    assert solid.any() and (~solid).any()
    rng = np.random.default_rng(10 * k + order)
    post = rng.uniform(-1.0, 1.0, (k, 9) + SHAPE)
    psi = rng.uniform(0.0, 1.0, (k,) + SHAPE) * ~solid
    out, writes, sums = push_mirror(post, ~solid, psi, order)
    assert writes.min() == 1 and writes.max() == 1
    np.testing.assert_array_equal(out, _jax_stream(post, solid))
    # one fluid at a time: the same shapes in every case (JAX compiles each
    # op once a shape)
    want = np.stack([np.stack([np.asarray(g) for g in stencil_weighted_grad(
        jnp.asarray(p), _stencil(order))]) for p in psi]) * ~solid
    np.testing.assert_allclose(sums, want, rtol=0, atol=1e-14)


def _jax_model(solid, k, outlet, depth_order):
    """A JAX ShanChenMCMP (jnp path) with an outlet of the kind (1 Zou-He
    pressure, 2 convective) and the boundary depth of the stencil order."""
    g = np.full((k, k), 0.5) - 0.5 * np.eye(k)
    p = js.ShanChenParams(g_matrix=tuple(map(tuple, g)), g_solid=(0.0,) * k,
                          tau=(1.0,) * k,
                          scheme="EFS" if depth_order else "SC",
                          iso_order=depth_order or 4)
    b = js.SCBoundaryConfig(
        inlet="zou_he_velocity",
        outlet="zou_he_pressure" if outlet == 1 else "convective",
        inlet_velocity=(-1e-3,) + (0.0,) * (k - 1),
        outlet_density=tuple(0.5 + 0.25 * i for i in range(k)))
    return js.ShanChenMCMP(jgeo.from_solid_mask(solid), p, b,
                           dtype=jnp.float64, use_pallas=False)


@pytest.mark.parametrize("order", [0, 8, 10])
@pytest.mark.parametrize("outlet", [1, 2], ids=["zou_he", "convective"])
@pytest.mark.parametrize("k", [1, 3])
def test_outlet_launch_equals_jax_outlet_rows(k, outlet, order):
    """The outlet launch after the push equals the JAX model's jnp outlet
    rows on the streamed state (f64, to 1e-15), and writes only fluid
    cells of rows 0 ... d (Zou-He) or 0 ... d + 1 (convective), each
    once."""
    solid = _solid("random", seed=20 + k + outlet)
    mj = _jax_model(solid, k, outlet, order)
    d = REACH[order]
    rng = np.random.default_rng(30 + k)
    post = rng.uniform(0.0, 0.2, (k, 9) + SHAPE)
    streamed, writes = push_mirror(post, ~solid,
                                   np.zeros((k,) + SHAPE), order)[:2]
    assert (writes == 1).all()
    got, rows = outlet_mirror(streamed, ~solid, d, outlet,
                              [float(v) for v in mj.bcs.outlet_density])
    want = np.asarray(mj._apply_outlet(jnp.asarray(streamed), None))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    top = d if outlet == 1 else d + 1
    assert rows.max() == 1 and not rows[top + 1:].any()
    assert (rows[:top + 1] == ~solid[:top + 1]).all()


@pytest.mark.parametrize("tag", ["p_b2", "p_b3", "p_skip_ring",
                                 "p_skip_push", "t_mb1", "t_mb2", "t_mb3",
                                 "t_mb4"])
def test_chip_sweep_k8_variants_patch_once(tag, tmp_path):
    """chip_sweep.py's k8 and k8t modes time K8 and K8-T on copies of csrc/
    with sc2d.cuh or sc2d_march.cuh changed: each text they replace stays
    in its source exactly once, and the copy differs from the source."""
    import chip_sweep
    name, (old, new) = (chip_sweep.K8_EDITS | chip_sweep.K8T_EDITS)[tag]
    src = (build.SRC_DIR / name).read_text()
    assert src.count(old) == 1 and old != new
    dest = chip_sweep._patched(build.SRC_DIR, tmp_path / tag,
                               {name: (old, new)})
    assert (dest / name).read_text() != src
