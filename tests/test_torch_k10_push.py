"""K10's and K11's push streaming against the JAX package's pull, on the
CPU at f64.

``sc_push_kernel`` (csrc/flow3d.cuh) streams the f32 and f64 Shan-Chen
states by push: the thread of fluid cell x writes post_i into slot i of
x + e_i, or into slot opp(i) of x where x + e_i is solid, and a solid cell
writes its own 19 zeros; its box form (K12e) collides the slabs
[a - 1, b + 1) and writes only [a, b).  ``push_mirror`` below repeats that
placement in numpy as the kernel walks its grid (32 x 8 tiles, a ring of
fluid flags one cell a side filled with wrapped coordinates, z-runs chosen
from the card's occupancy by csrc/occupancy.cuh's rule, at most
PUSH_ZMAX), and counts the writes of every slot.  ``single_push_kernel``
(K11 in f32 and f64) places the values of one fluid the same way, one
thread a cell over 32 x SPTY tiles and runs of SPZ slabs, its neighbours'
flags read from the mask with wrapped coordinates; ``single_push_mirror``
repeats that walk.  Held
against ``openlbmpm_tpu/ops/streaming.py::stream`` times the fluid mask on
random post-collision values (K = 1, 2, 3; K11) over random masks full of
one-cell slivers, grains that cross the periodic seams and solid planes on
the seams: equal value for value, every slot written exactly once, and the
box form writing exactly the slots of [a, b).
"""

import re

import numpy as np
import pytest

import jax.numpy as jnp
from chip_smoke import periodic_grains
from openlbmpm_tpu.lattice import D3Q19 as JD3Q19
from openlbmpm_tpu.ops.streaming import stream, upwind_solid_masks
from openlbmpm_torch.kernels import build
from openlbmpm_torch.lattice import D3Q19


def _constant(name):
    """The integer constant `name` of csrc/flow3d.cuh."""
    src = (build.SRC_DIR / "flow3d.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# csrc/flow3d.cuh: the push tile (TX x PTY) and the longest z-run (ZMAX);
# K11's tile (TX x SPTY) and slabs a thread (SPZ)
TX, PTY, ZMAX = 32, _constant("PTY"), _constant("PUSH_ZMAX")
SPTY, SPZ = _constant("SPTY"), _constant("SPZ")
SHAPE = (9, 11, 37)   # two tiles in x and in y, several z-runs
DEEP = (40, 11, 37)   # deeper than ZMAX slabs


def z_run(capacity, tiles, nz):
    """csrc/occupancy.cuh::z_run: the shortest run (4 to ZMAX slabs) whose
    grid of `tiles` tile columns `capacity` blocks hold at once."""
    runs = capacity // tiles if capacity >= 2 * tiles else 1
    return min(max(-(-nz // runs), 4), ZMAX)


def push_mirror(post, fluid, box=None, capacity=264):
    """The slots sc_push_kernel writes from the post-collision values `post`
    (K, 19, nz, ny, nx) over the bool mask `fluid`, as (out, writes): out
    the written values (0 where none), writes how often each slot was
    written.  `box` (a, b): the box form over the slabs [a, b)."""
    nz, ny, nx = fluid.shape
    e, opp = D3Q19.e.astype(int), D3Q19.opp
    out = np.zeros_like(post)
    writes = np.zeros(post.shape, np.int64)
    c0, c1 = (box[0] - 1, box[1] + 1) if box else (0, nz)

    def written(z):
        return box is None or box[0] <= z < box[1]

    gx, gy = -(-nx // TX), -(-ny // PTY)
    zrun = z_run(capacity, gx * gy, c1 - c0)
    for bz in range(-(-(c1 - c0) // zrun)):
        z0 = c0 + bz * zrun
        z1 = min(z0 + zrun, c1)
        for by in range(gy):
            for bx in range(gx):
                x0, y0 = bx * TX, by * PTY
                # the ring's flags: slabs z0 - 1 ... z1, the tile and one
                # cell a side, each cell wrapped as the ring fill wraps it
                ring = fluid[np.ix_(
                    [z % nz for z in range(z0 - 1, z1 + 1)],
                    [(y0 - 1 + h) % ny for h in range(PTY + 2)],
                    [(x0 - 1 + h) % nx for h in range(TX + 2)])]
                for z in range(z0, z1):
                    for ty in range(PTY):
                        for tx in range(TX):
                            x, y = x0 + tx, y0 + ty
                            if x >= nx or y >= ny:
                                continue
                            hz, hy, hx = z - z0 + 1, ty + 1, tx + 1
                            if not ring[hz, hy, hx]:
                                if written(z):
                                    out[:, :, z, y, x] = 0.0
                                    writes[:, :, z, y, x] += 1
                                continue
                            for i in range(19):
                                ex, ey, ez = e[i]
                                if ring[hz + ez, hy + ey, hx + ex]:
                                    if written(z + ez):
                                        t = (slice(None), i, (z + ez) % nz,
                                             (y + ey) % ny, (x + ex) % nx)
                                        out[t] = post[:, i, z, y, x]
                                        writes[t] += 1
                                elif written(z):
                                    out[:, opp[i], z, y, x] = post[:, i, z,
                                                                   y, x]
                                    writes[:, opp[i], z, y, x] += 1
    return out, writes


def single_push_mirror(post, fluid):
    """The slots single_push_kernel writes from the post-collision values
    `post` (1, 19, nz, ny, nx) of one fluid over the bool mask `fluid`, as
    (out, writes) of push_mirror."""
    nz, ny, nx = fluid.shape
    e, opp = D3Q19.e.astype(int), D3Q19.opp
    out = np.zeros_like(post)
    writes = np.zeros(post.shape, np.int64)
    for bz in range(-(-nz // SPZ)):
        for by in range(-(-ny // SPTY)):
            for bx in range(-(-nx // TX)):
                for t in range(TX * SPTY):
                    x, y = bx * TX + t % TX, by * SPTY + t // TX
                    if x >= nx or y >= ny:
                        continue
                    for z in range(bz * SPZ, min((bz + 1) * SPZ, nz)):
                        if not fluid[z, y, x]:
                            out[:, :, z, y, x] = 0.0
                            writes[:, :, z, y, x] += 1
                            continue
                        for i in range(19):
                            nb = ((z + e[i, 2]) % nz, (y + e[i, 1]) % ny,
                                  (x + e[i, 0]) % nx)
                            t_ = (slice(None), i) + nb if fluid[nb] else \
                                (slice(None), opp[i], z, y, x)
                            out[t_] = post[:, i, z, y, x]
                            writes[t_] += 1
    return out, writes


def _solid(kind, seed=0, shape=SHAPE):
    """The (nz, ny, nx) solid masks: random cells (one-cell slivers and
    isolated fluid cells), periodic grains across every seam, or solid
    bands on the z, y and x seams with holes."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random(shape) < 0.3
    if kind == "grains":
        return periodic_grains(shape, n_grains=6, seed=seed)
    solid = np.zeros(shape, bool)
    solid[0] = solid[-1] = rng.random(shape[1:]) < 0.6
    solid[:, 0] |= rng.random((shape[0], shape[2])) < 0.5
    solid[:, :, -1] |= rng.random(shape[:2]) < 0.5
    return solid


def _jax_stream(post, solid):
    """ops/streaming.py::stream of each fluid, times the fluid mask."""
    up = upwind_solid_masks(JD3Q19, solid)
    fl = (~solid).astype(np.float64)
    return np.stack([np.asarray(stream(jnp.asarray(p), JD3Q19, up)) * fl
                     for p in post])


@pytest.mark.parametrize("k", [1, 2, 3, "K11"])
@pytest.mark.parametrize("kind", ["random", "grains", "seams"])
def test_push_equals_jax_stream_and_writes_each_slot_once(kind, k):
    """K10's push of K fluids, or ("K11") K11's push of one fluid."""
    k11 = k == "K11"
    n = 1 if k11 else k
    solid = _solid(kind, seed=4 if k11 else k)
    assert solid.any() and (~solid).any()
    post = np.random.default_rng(10 + n).uniform(
        -1.0, 1.0, (n, 19) + SHAPE)
    out, writes = (single_push_mirror if k11 else push_mirror)(post, ~solid)
    assert writes.min() == 1 and writes.max() == 1
    np.testing.assert_array_equal(out, _jax_stream(post, solid))


@pytest.mark.parametrize("capacity", [4, 8, 264])
def test_push_covers_the_domain_at_every_z_run(capacity):
    """The z-run follows the card's occupancy (here 9, 5 and 4 slabs: one,
    two and 66 runs a tile column fit): every z-run leaves every slot
    written once."""
    solid = _solid("grains", seed=3)
    post = np.random.default_rng(4).uniform(-1.0, 1.0, (2, 19) + SHAPE)
    out, writes = push_mirror(post, ~solid, capacity=capacity)
    assert (writes == 1).all()
    np.testing.assert_array_equal(out, _jax_stream(post, solid))


@pytest.mark.parametrize("capacity,zrun", [(4, ZMAX), (8, ZMAX), (24, 7)])
def test_push_covers_a_deep_domain_where_the_z_run_is_capped(capacity, zrun):
    """On 40 slabs the z-run reaches its cap of ZMAX slabs (one and two
    runs a tile column fit), or not (six fit): every slot written once."""
    assert z_run(capacity, 4, DEEP[0]) == zrun
    solid = _solid("seams", seed=7, shape=DEEP)
    post = np.random.default_rng(8).uniform(-1.0, 1.0, (1, 19) + DEEP)
    out, writes = push_mirror(post, ~solid, capacity=capacity)
    assert (writes == 1).all()
    np.testing.assert_array_equal(out, _jax_stream(post, solid))


@pytest.mark.parametrize("box", [(2, 7), (3, 5), (2, 3)])
def test_push_box_writes_only_its_slabs(box):
    """The box form (K12e's sub-step over [a, b)) collides [a - 1, b + 1)
    and writes every slot of [a, b) once, and no other, with the values of
    the whole-domain push."""
    a, b = box
    solid = _solid("seams", seed=5)
    post = np.random.default_rng(6).uniform(-1.0, 1.0, (2, 19) + SHAPE)
    full, _ = push_mirror(post, ~solid)
    out, writes = push_mirror(post, ~solid, box=box)
    assert (writes[:, :, a:b] == 1).all()
    assert not writes[:, :, :a].any() and not writes[:, :, b:].any()
    np.testing.assert_array_equal(out[:, :, a:b], full[:, :, a:b])


@pytest.mark.parametrize("tag", ["p_b2", "p_b3", "p_b4", "p_z32",
                                 "p_zfixed", "p_fill1", "p_skip_fill",
                                 "p_skip_push"])
def test_chip_sweep_k10_variants_patch_flow3d_once(tag, tmp_path):
    """chip_sweep.py's k10 mode times K10 on copies of csrc/ with flow3d.cuh
    changed: each text it replaces stays in the source exactly once, and
    the copy differs from the source."""
    import chip_sweep
    from openlbmpm_torch.kernels import build
    src = (build.SRC_DIR / "flow3d.cuh").read_text()
    old, new = chip_sweep.K10_EDITS[tag]
    assert src.count(old) == 1 and old != new
    dest = chip_sweep._patched(build.SRC_DIR, tmp_path / tag,
                               {"flow3d.cuh": chip_sweep.K10_EDITS[tag]})
    assert (dest / "flow3d.cuh").read_text() != src


@pytest.mark.parametrize("tag", ["s_ty4", "s_ty16", "s_z2", "s_z4", "s_b1",
                                 "s_b3", "s_b4", "m_b2", "m_b3", "m_b4"])
def test_chip_sweep_k11_variants_patch_once(tag, tmp_path):
    """chip_sweep.py's k11 mode times K11's push on copies of csrc/ with
    flow3d.cuh changed and K11-T on copies with flow3d_block.cuh changed:
    each text it replaces stays in its source exactly once, and the copy
    differs from the source."""
    import chip_sweep
    name, edits = (("flow3d.cuh", chip_sweep.K11_PUSH_EDITS)
                   if tag.startswith("s_") else
                   ("flow3d_block.cuh", chip_sweep.K11_MARCH_EDITS))
    src = (build.SRC_DIR / name).read_text()
    old, new = edits[tag]
    assert src.count(old) == 1 and old != new
    dest = chip_sweep._patched(build.SRC_DIR, tmp_path / tag,
                               {name: edits[tag]})
    assert (dest / name).read_text() != src
