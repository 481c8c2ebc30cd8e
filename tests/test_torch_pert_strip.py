"""The strip march of K4c / K4h / K4s (``pert_strip_kernel``,
csrc/pert2d.cu) against the JAX package's Perturbation model, on the CPU
at f64.

A block owns TX columns of a run of RUN_H rows and steps down the run TY
rows at a time.  It keeps two rings of rows in shared memory, row r of the
domain in slot (r - y0 + 4) mod depth: d = rho_r - rho_b (``solid_phi`` on
solid cells), phi and the fluid flag (a 2-column halo, 3 rows ahead of the
output rows, so that the Dirichlet-outlet repair of rows 0 and 1 finds row
2's phi in the ring) with the state the d pass decoded for the collision
(a 1-column halo), and post with its red part and the fluid flag (1
column, 1 row ahead), and streams by pull.  The split layout pushes
instead: it forms d 2 rows ahead, collides the
step's own rows once and writes the red part and post - red of each
direction to slot i of x + e_i, or to slot opp(i) of x where x + e_i is
solid.

``pert_mirror`` repeats that walk in numpy (the blocks, the prologue above
each run, the rings' slots and the rows they carry from step to step, the
x halo with wrapped coordinates, the barriers between the stages, the
placement of every value) with stand-ins for the collision: random post
and red values a cell.  Held against the JAX model's
``ColorGradientRK._pert_gradient`` (the gradient of d each collided cell
forms from the ring), ``_repair_phi_rows`` of its phase field (the phi each
collided cell reads) and ``ops/streaming.py::stream`` with
``upwind_solid_masks`` (the streamed total and red parts), on shapes that
are no multiple of the tile or the run, on masks full of one-cell slivers
and on masks with solid rows and columns on the periodic seams: every
output slot is written once, every ring row is formed before it is read and
by no stage of the phase that reads it, and every fluid cell is collided:
once by the push, and by the pull once but for the one-column x halo of
each strip and the row above each run.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest

from openlbmpm_tpu import geometry as jgeo
from openlbmpm_tpu.lattice import D2Q9 as JD2Q9
from openlbmpm_tpu.models.colorgradient import (CGBoundaryConfig,
                                                ColorGradientParams,
                                                ColorGradientRK)
from openlbmpm_tpu.ops.streaming import stream, upwind_solid_masks
from openlbmpm_torch.kernels import build
from openlbmpm_torch.lattice import D2Q9


def _constant(name, src):
    """The int or bool constant `name` of csrc/`src`."""
    text = (build.SRC_DIR / src).read_text()
    v = re.search(rf"constexpr (?:int|bool) {name} = (\w+);", text).group(1)
    return {"true": True, "false": False}[v] if not v.isdigit() else int(v)


TX, TY, RUN_H = (_constant(k, "csf2d.cuh") for k in ("TX", "TY", "RUN_H"))
E = D2Q9.e.astype(int)
OPP = D2Q9.opp
SOLID_PHI = 0.5


class Phase:
    """The ring slots one phase (the code between two barriers) reads and
    writes: no slot may be both."""

    def __init__(self):
        self.reads, self.writes = set(), set()

    def check(self):
        both = self.reads & self.writes
        assert not both, f"ring slots read and written in one phase: {both}"


class Ring:
    """`planes` planes of `depth` rows of `width` cells; slot
    (r - y0 + 4) mod depth holds row r, and remembers it."""

    def __init__(self, name, y0, depth, width, planes):
        self.name, self.y0, self.depth = name, y0, depth
        self.val = np.full((planes, depth, width), np.nan)
        self.row = np.full(depth, -10 ** 9)
        self.phase = None

    def slot(self, r):
        return (r - self.y0 + 4) % self.depth

    def put(self, r, vals):
        s = self.slot(r)
        self.phase.writes.add((self.name, s))
        self.val[:, s] = vals
        self.row[s] = r

    def get(self, r):
        s = self.slot(r)
        self.phase.reads.add((self.name, s))
        assert self.row[s] == r, (f"{self.name} ring: row {r} read from a "
                                  f"slot that holds row {self.row[s]}")
        return self.val[:, s]


def pert_mirror(fluid, rho_r, rho_b, grad_w, repair, post, red, push,
                tx=TX, ty=TY, run_h=RUN_H):
    """The walk over the blocks: (out, writes, seen, collided).  out (2, 9,
    ny, nx): the pull's streamed total and red part (push: the red part and
    post - red); writes: how often each slot of the two outputs was
    written; seen (3, ny, nx): the gradient of d (2) and the phi each
    collided cell formed and read (checked equal wherever several blocks
    collide it); collided: how often each cell was collided.  `grad_w`:
    the gradient weights of the axis and diagonal neighbours; `post`,
    `red` (9, ny, nx) each cell's stand-in collision."""
    ny, nx = fluid.shape
    dw, qw = tx + 4, tx + 2
    d_all = np.where(fluid, rho_r - rho_b, SOLID_PHI)
    tot = rho_r + rho_b
    phi_all = np.where(fluid & (tot != 0), (rho_r - rho_b) /
                       np.where(tot != 0, tot, 1.0), 0.0)
    out = np.zeros((2, 9, ny, nx))
    writes = np.zeros((2, 9, ny, nx), np.int64)
    seen = np.full((3, ny, nx), np.nan)
    collided = np.zeros((ny, nx), np.int64)

    for by in range(-(-ny // run_h)):
        for bx in range(-(-nx // tx)):
            x0, y0 = bx * tx, by * run_h
            y1 = min(y0 + run_h, ny)
            # d, phi, the fluid flag and the state the collision reads
            # (here each cell's index), kept over the collision's columns
            dp = Ring("d", y0, ty + 3, dw, 4)
            po = Ring("post", y0, ty + 2, qw, 19)

            def form_d(r0, r1):
                cols = (x0 - 2 + np.arange(dw)) % nx
                kept = (np.arange(dw) >= 1) & (np.arange(dw) < tx + 3)
                for r in range(r0, r1):
                    y = r % ny
                    dp.put(r, [d_all[y, cols], phi_all[y, cols],
                               fluid[y, cols],
                               np.where(kept, y * nx + cols, np.nan)])

            def collide_row(r, lx):
                """Collide row r at the d ring's columns lx: the gradient
                and phi it forms, counted collisions."""
                x = (x0 - 2 + lx) % nx
                y = r % ny
                row = dp.get(r)
                fl = row[2][lx] > 0.5
                assert (row[3][lx] == y * nx + x).all()
                gx, gy = np.zeros(len(lx)), np.zeros(len(lx))
                for i in range(1, 9):
                    v = dp.get(r + E[i, 1])[0][lx + E[i, 0]]
                    w = grad_w[0] if i < 5 else grad_w[1]
                    if E[i, 0]:
                        gx = gx + (w * E[i, 0]) * v
                    if E[i, 1]:
                        gy = gy + (w * E[i, 1]) * v
                # Dirichlet-outlet repair: rows 1 and 0 read row 2's phi
                phi = dp.get(r + 2 - y if repair and y <= 1 else r)[1][lx]
                got = np.stack([gx, gy, phi])[:, fl]
                old = seen[:, y, x[fl]]
                known = ~np.isnan(old)
                assert (old[known] == got[known]).all()
                seen[:, y, x[fl]] = got
                np.add.at(collided, (y, x[fl]), 1)
                return x, y, fl

            qn = min(qw, nx - x0 + 2)

            def form_post(r0, r1):
                for r in range(r0, r1):
                    x, y, fl = collide_row(r, np.arange(qn) + 1)
                    v = np.full((19, qw), np.nan)
                    v[:9, :qn] = np.where(fl, post[:, y, x], 0.0)
                    v[9:18, :qn] = np.where(fl, red[:, y, x], 0.0)
                    v[18, :qn] = fl
                    po.put(r, v)

            def stream_rows(a):
                lx = np.arange(tx) + 1
                x = x0 + lx - 1
                keep = x < nx
                for r in range(a, min(a + ty, y1)):
                    rows = {dy: po.get(r + dy) for dy in (-1, 0, 1)}
                    own = rows[0][18][lx] > 0.5
                    for i in range(9):
                        src = rows[-E[i, 1]][:, lx - E[i, 0]]
                        back = ~(src[18] > 0.5)
                        j = np.where(back, OPP[i], i)
                        s = np.where(back, rows[0][:, lx], src)
                        o = np.where(own, s[j, np.arange(tx)], 0.0)
                        rd = np.where(own, s[9 + j, np.arange(tx)], 0.0)
                        out[0, i, r, x[keep]] = o[keep]
                        out[1, i, r, x[keep]] = rd[keep]
                        writes[:, i, r, x[keep]] += 1

            def push_rows(a):
                lx = np.arange(min(tx, nx - x0)) + 2
                for r in range(a, min(a + ty, y1)):
                    x, y, fl = collide_row(r, lx)
                    flags = {dy: dp.get(r + dy)[2] for dy in (-1, 0, 1)}
                    for c in np.flatnonzero(~fl):
                        out[:, :, y, x[c]] = 0.0
                        writes[:, :, y, x[c]] += 1
                    for c in np.flatnonzero(fl):
                        for i in range(9):
                            if i and flags[E[i, 1]][lx[c] + E[i, 0]] > 0.5:
                                at = (i, (y + E[i, 1]) % ny,
                                      (x[c] + E[i, 0]) % nx)
                            else:
                                at = (OPP[i] if i else 0, y, x[c])
                            out[(0, *at)] = red[i, y, x[c]]
                            out[(1, *at)] = post[i, y, x[c]] - red[i, y, x[c]]
                            writes[(slice(None), *at)] += 1

            def run(*stages):
                phase = Phase()
                dp.phase = po.phase = phase
                for fn, *args in stages:
                    fn(*args)
                phase.check()

            steps = range(y0, y1, ty)
            if push:
                run((form_d, y0 - 1, y0 + 2))
                for a in steps:
                    e = min(a + ty, y1)   # a last step may stop short
                    run((form_d, a + 2, e + 2))
                    run((push_rows, a))
            else:
                run((form_d, y0 - 2, y0 + 3))
                run((form_post, y0 - 1, y0 + 1))
                for a in steps:
                    # the stream of the step before and this step's d rows
                    # share a phase
                    e = min(a + ty, y1)
                    run((form_d, a + 3, e + 3),
                        *(((stream_rows, a - ty),) if a > y0 else ()))
                    run((form_post, a + 1, e + 1))
                run((stream_rows, steps[-1]))
    return out, writes, seen, collided


SHAPES = [(150, 70), (21, 70), (9, 40), (8, 3)]


def _solid(kind, shape, seed):
    """(ny, nx) solid masks: random cells (one-cell slivers and isolated
    fluid cells) or rows and columns on the periodic seams with holes."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        solid = rng.random(shape) < 0.3
    else:
        solid = np.zeros(shape, bool)
        solid[0] = solid[-1] = rng.random(shape[1]) < 0.6
        solid[:, 0] |= rng.random(shape[0]) < 0.5
        solid[:, -1] |= rng.random(shape[0]) < 0.5
    solid[shape[0] // 2, :] = False
    return solid


def _jax_model(solid, gradient_type, repair):
    """A JAX Perturbation model (jnp path) on the mask, with a Dirichlet
    outlet and its phi repair where `repair`."""
    p = ColorGradientParams(variant="Perturbation", solid_phi=SOLID_PHI,
                            gradient_type=gradient_type, alpha_r=4 / 9,
                            alpha_b=4 / 9)
    b = CGBoundaryConfig(inlet="neumann", outlet="dirichlet",
                         outlet_density_r=0.0, outlet_density_b=1.0) \
        if repair else CGBoundaryConfig()
    return ColorGradientRK(jgeo.from_solid_mask(solid), p, b,
                           dtype=jnp.float64, use_pallas=False)


def _pull_collisions(shape, tx=TX, run_h=RUN_H):
    """How often the pull collides each cell: once, twice on the two
    columns at each strip's left edge and on the two rows at each run's
    start, four times where both meet."""
    ny, nx = shape
    cols = np.zeros(nx, int)
    cols[np.concatenate([np.arange(0, nx, tx), np.arange(0, nx, tx) - 1])
         % nx] = 1
    rows = np.zeros(ny, int)
    rows[np.concatenate([np.arange(0, ny, run_h),
                         np.arange(0, ny, run_h) - 1]) % ny] = 1
    return (1 + rows)[:, None] * (1 + cols)[None, :]


def _check_walk(kind, shape, seed, push, gradient_type, repair, **knobs):
    solid = _solid(kind, shape, seed)
    fluid = ~solid
    rng = np.random.default_rng(seed + 100)
    rho_r = rng.uniform(0.0, 1.0, shape) * fluid
    rho_b = rng.uniform(0.0, 1.0, shape) * fluid
    rho_b[fluid & (rng.random(shape) < 0.1)] = 0.0   # some pure red
    rho_r[0, :2] = rho_b[0, :2] = 0.0                 # and empty cells
    post = rng.uniform(-1.0, 1.0, (9,) + shape)
    red = rng.uniform(-1.0, 1.0, (9,) + shape)
    mj = _jax_model(solid, gradient_type, repair)
    grad_w = (1 / 3, 1 / 12) if gradient_type == "Anisotropic" else (1.0, 1.0)
    out, writes, seen, collided = pert_mirror(
        fluid, rho_r, rho_b, grad_w, repair, post, red, push, **knobs)
    assert writes.min() == 1 and writes.max() == 1
    up = upwind_solid_masks(JD2Q9, solid)
    total, red_s = (np.asarray(stream(jnp.asarray(a), JD2Q9, up)) * fluid
                    for a in (post, red))
    if push:
        np.testing.assert_array_equal(out[0], red_s)
        np.testing.assert_array_equal(out[1], total - red_s)
    else:
        np.testing.assert_array_equal(out[0], total)
        np.testing.assert_array_equal(out[1], red_s)
    gx, gy = (np.asarray(g) for g in mj._pert_gradient(jnp.asarray(rho_r),
                                                       jnp.asarray(rho_b)))
    phi = np.asarray(mj._repair_phi_rows(mj.fluid_mask * (
        (jnp.asarray(rho_r) - jnp.asarray(rho_b)) / jnp.where(
            jnp.asarray(rho_r + rho_b) != 0, jnp.asarray(rho_r + rho_b),
            1.0)))) if repair else None
    np.testing.assert_allclose(seen[0][fluid], gx[fluid], rtol=0, atol=1e-14)
    np.testing.assert_allclose(seen[1][fluid], gy[fluid], rtol=0, atol=1e-14)
    if repair:
        np.testing.assert_allclose(seen[2][fluid], phi[fluid], rtol=0,
                                   atol=1e-15)
    assert not collided[solid].any()
    if push:
        assert (collided[fluid] == 1).all()
    else:
        want = _pull_collisions(shape, knobs.get("tx", TX),
                                knobs.get("run_h", RUN_H))
        assert (collided[fluid] == want[fluid]).all()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["random", "seams"])
def test_compressed_pull_walk_equals_jax(kind, shape):
    """K4c / K4h's pull: every output slot written once with the JAX
    pull's total and red part; each collided cell formed JAX's gradient of
    d and read the repaired phi; every fluid cell collided, once but for
    the strips' x halo and the row above each run."""
    _check_walk(kind, shape, seed=shape[0] + shape[1], push=False,
                gradient_type="Isotropic" if kind == "random"
                else "Anisotropic", repair=True)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["random", "seams"])
def test_split_walk_equals_jax(kind, shape):
    """K4s, by push: every output slot written
    once with the JAX pull's red part and post - red, every fluid cell
    collided exactly once."""
    _check_walk(kind, shape, seed=2 * shape[0] + shape[1], push=True,
                gradient_type="Anisotropic" if kind == "random"
                else "Isotropic", repair=kind == "seams")


@pytest.mark.parametrize("push", [False, True], ids=["pull", "push"])
@pytest.mark.parametrize("knobs", [dict(tx=32, ty=4, run_h=16),
                                   dict(tx=32, ty=16, run_h=48)],
                         ids=["ty4_h16", "ty16_h48"])
def test_walk_with_other_rows_a_step_and_runs(knobs, push):
    """The walk at other rows a step and run heights (the sweep's knobs):
    many runs, a last run and a last step cut short, the repair rows at a
    run's start."""
    _check_walk("random", (101, 45), seed=9, push=push,
                gradient_type="Isotropic", repair=True, **knobs)


def test_mirror_sees_a_row_read_before_it_is_formed():
    """The ring check fails a read of a row no stage has formed."""
    ring = Ring("d", 0, TY + 3, TX + 4, 4)
    ring.phase = Phase()
    ring.put(0, np.zeros((4, TX + 4)))
    with pytest.raises(AssertionError):
        ring.get(TY + 3)
