"""The strip march of K1 / K2 / K6 (``strip_kernel``, csrc/csf2d.cuh)
against the JAX package's ops, on the CPU at f64.

A block owns TX columns of a run of RUN_H rows and steps down the run TY
rows at a time.  It keeps three rings of rows in shared memory, row r of
the domain in slot (r - y0 + 4) mod depth: phi and the fluid flag (a
4-column halo, 4 rows ahead of the output rows) with the state the phi
pass decoded for the collision (a 1-column halo), the wetted gradient and
unit normal (2 columns, 2 rows ahead), and post, frac, A, B with the fluid
flag (1 column, 1 row ahead), and streams by pull.  The split layout
pushes instead: it forms phi 3 rows and the
normals 1 row ahead, collides the step's own rows once and writes the red
part and post - red of each direction to slot i of x + e_i, or to slot
opp(i) of x where x + e_i is solid; a step's push shares a phase (the code
between two barriers) with the next step's phi rows, and the phi ring then
holds 2 TY + 4 rows.

``strip_mirror`` repeats that walk in numpy: the blocks, the prologue
above each run, the rings' slots and the rows they carry from step to
step, the x halo with wrapped coordinates, the barriers between the
stages (a phase is what runs between two barriers) and the placement of
every value.  Stand-ins take the place of the cell bodies: a random phi a
cell (0 on solid cells, as the phase pass leaves it) and random post,
frac, A, B.  Held against ``ops/colorgrad.py::solid_phi_extrapolate`` and
``color_gradient`` (the gradient each normal row holds) and
``ops/streaming.py::stream`` with ``upwind_solid_masks`` (the streamed
total and red parts), on shapes that are no multiple of the tile or the
run, on masks full of one-cell slivers and on masks with solid rows and
columns on the periodic seams: every output slot is written once, every
ring row is formed before it is read and by no stage of the phase that
reads it, and every fluid cell is collided (once where the split layout
pushes).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest

from openlbmpm_tpu.lattice import D2Q9 as JD2Q9
from openlbmpm_tpu.ops.colorgrad import color_gradient, solid_phi_extrapolate
from openlbmpm_tpu.ops.streaming import stream, upwind_solid_masks
from openlbmpm_torch.kernels import build
from openlbmpm_torch.lattice import D2Q9

SRC = (build.SRC_DIR / "csf2d.cuh").read_text()


def _constant(name):
    """The int or bool constant `name` of csrc/csf2d.cuh."""
    v = re.search(rf"constexpr (?:int|bool) {name} = (\w+);", SRC).group(1)
    return {"true": True, "false": False}.get(v, None if not v.isdigit()
                                              else int(v))


TX, TY, RUN_H = _constant("TX"), _constant("TY"), _constant("RUN_H")
E = D2Q9.e.astype(int)
W = D2Q9.w.astype(np.float64)
OPP = D2Q9.opp


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
    (r - y0 + 4) mod depth holds row r.  Each slot remembers the row it
    holds, and each access is noted in the current phase."""

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


def strip_mirror(fluid, phi, post, wetting, push, tx=TX, ty=TY, run_h=RUN_H):
    """The strip march's walk over the blocks: (out, writes, grad, grad_at,
    collided).  out (2, 9, ny, nx): the pull's streamed total and red part
    (push: the red part and post - red); writes: how often each slot of
    each of the two outputs was written; grad (2, ny, nx): the gradient of
    every normal-ring cell (checked equal wherever several blocks form
    it); grad_at: the neighbours' gradients each collided cell read, as
    (cells, 8, 2) beside their global (y, x); collided: how often each cell
    was collided.  `post` (12, ny, nx): post (9), frac, A, B of each cell."""
    ny, nx = fluid.shape
    pw, nw, qw = tx + 8, tx + 4, tx + 2
    out = np.zeros((2, 9, ny, nx))
    writes = np.zeros((2, 9, ny, nx), np.int64)
    grad = np.full((2, ny, nx), np.nan)
    collided = np.zeros((ny, nx), np.int64)
    reads = []

    for by in range(-(-ny // run_h)):
        for bx in range(-(-nx // tx)):
            x0, y0 = bx * tx, by * run_h
            y1 = min(y0 + run_h, ny)
            # phi, the fluid flag and the state the collision reads (here
            # each cell's index), kept over the collision's columns
            ph = Ring("phi", y0, 2 * ty + 4 if push else ty + 4, pw, 3)
            nm = Ring("normal", y0, ty + 2, nw, 2)
            po = Ring("post", y0, ty + 2, qw, 13)

            def form_phi(r0, r1):
                cols = (x0 - 4 + np.arange(pw)) % nx
                kept = (np.arange(pw) >= 3) & (np.arange(pw) < tx + 5)
                for r in range(r0, r1):
                    y = r % ny
                    ph.put(r, [phi[y, cols], fluid[y, cols],
                               np.where(kept, y * nx + cols, np.nan)])

            def form_normal(r0, r1):
                cols = (x0 - 2 + np.arange(nw)) % nx
                for r in range(r0, r1):
                    reach = 2 if wetting else 1
                    rows = {dy: ph.get(r + dy) for dy in
                            range(-reach, reach + 1)}

                    def ext(dy, dx):   # phi extended, the ring's columns
                        c = np.arange(nw) + 2 + dx
                        p, f = rows[dy][0][c], rows[dy][1][c] > 0.5
                        if not wetting:
                            return p
                        num, den = np.zeros(nw), np.zeros(nw)
                        for i in range(1, 9):
                            nb = rows[dy + E[i, 1]]
                            num = num + W[i] * nb[0][c + E[i, 0]]
                            den = den + W[i] * nb[1][c + E[i, 0]]
                        ok = den > 0
                        return np.where(f, p, np.where(
                            ok, num / np.where(ok, den, 1.0), 0.0))
                    gx, gy = np.zeros(nw), np.zeros(nw)
                    for i in range(1, 9):
                        v = ext(E[i, 1], E[i, 0])
                        if E[i, 0]:
                            gx = gx + (W[i] * E[i, 0]) * v
                        if E[i, 1]:
                            gy = gy + (W[i] * E[i, 1]) * v
                    g = np.stack([3.0 * gx, 3.0 * gy])
                    y = r % ny
                    seen = ~np.isnan(grad[0, y, cols])
                    assert (grad[:, y, cols][:, seen] == g[:, seen]).all()
                    grad[:, y, cols] = g
                    nm.put(r, g)

            def collide_row(r, lx):
                """Collide row r at the normal ring's columns lx: the
                neighbours' gradients it reads, counted collisions."""
                x = (x0 - 2 + lx) % nx
                y = r % ny
                row = ph.get(r)
                fl = row[1][lx + 2] > 0.5
                # the state the phi pass kept is this cell's
                assert (row[2][lx + 2] == y * nx + x).all()
                nb = np.stack([nm.get(r + E[i, 1])[:, lx + E[i, 0]].T
                               for i in range(1, 9)], axis=1)
                reads.append((y, x[fl], nb[fl]))
                np.add.at(collided, (y, x[fl]), 1)
                return x, y, fl

            # a strip cut short by the domain's edge collides the columns
            # its pull reads (the others stay unset)
            qn = min(qw, nx - x0 + 2)

            def form_post(r0, r1):
                for r in range(r0, r1):
                    x, y, fl = collide_row(r, np.arange(qn) + 1)
                    v = np.full((13, qw), np.nan)
                    v[:12, :qn] = np.where(fl, post[:, y, x], 0.0)
                    v[12, :qn] = fl
                    po.put(r, v)

            def stream_rows(a):
                lx = np.arange(tx) + 1
                x = x0 + lx - 1
                keep = x < nx
                for r in range(a, min(a + ty, y1)):
                    rows = {dy: po.get(r + dy) for dy in (-1, 0, 1)}
                    own = rows[0][12][lx] > 0.5
                    red_sum = np.zeros(tx)
                    for i in range(9):
                        src = rows[-E[i, 1]][:, lx - E[i, 0]]
                        back = ~(src[12] > 0.5)
                        j = np.where(back, OPP[i], i)
                        s = np.where(back, rows[0][:, lx], src)
                        o = s[j, np.arange(tx)]
                        seg = W[j] * (E[j, 0] * s[10] + E[j, 1] * s[11])
                        red = s[9] * o + seg
                        o, red = np.where(own, o, 0.0), np.where(own, red, 0.0)
                        out[0, i, r, x[keep]] = o[keep]
                        out[1, i, r, x[keep]] = red[keep]
                        writes[:, i, r, x[keep]] += 1
                        red_sum = red_sum + red

            def push_rows(a):
                lx = np.arange(min(tx, nx - x0)) + 2
                for r in range(a, min(a + ty, y1)):
                    x, y, fl = collide_row(r, lx)
                    flags = {dy: ph.get(r + dy)[1] for dy in (-1, 0, 1)}
                    for c in np.flatnonzero(~fl):
                        out[:, :, y, x[c]] = 0.0
                        writes[:, :, y, x[c]] += 1
                    for c in np.flatnonzero(fl):
                        p = post[:, y, x[c]]
                        for i in range(9):
                            red = p[9] * p[i] + W[i] * (E[i, 0] * p[10] +
                                                       E[i, 1] * p[11])
                            if i and flags[E[i, 1]][lx[c] + 2 + E[i, 0]] > 0.5:
                                at = (i, (y + E[i, 1]) % ny,
                                      (x[c] + E[i, 0]) % nx)
                            else:
                                at = (OPP[i] if i else 0, y, x[c])
                            out[(0, *at)] = red
                            out[(1, *at)] = p[i] - red
                            writes[(slice(None), *at)] += 1

            def run(*stages):
                phase = Phase()
                for ring in (ph, nm, po):
                    ring.phase = phase
                for fn, *args in stages:
                    fn(*args)
                phase.check()

            steps = range(y0, y1, ty)
            if push:
                # the next step's phi rows share a phase with the push
                run((form_phi, y0 - 3, min(y0 + ty, y1) + 3))
                run((form_normal, y0 - 1, min(y0 + ty, y1) + 1))
                for a in steps:
                    # e: this step's last row + 1 (a last step may stop
                    # short), e2 the next step's
                    e, e2 = min(a + ty, y1), min(a + 2 * ty, y1)
                    run(*(((form_phi, e + 3, e2 + 3),) if e < y1 else ()),
                        (push_rows, a))
                    if e < y1:
                        run((form_normal, e + 1, e2 + 1))
            else:
                run((form_phi, y0 - 4, y0 + 4))
                run((form_normal, y0 - 2, y0 + 2))
                run((form_post, y0 - 1, y0 + 1))
                for a in steps:
                    # the stream of the step before and this step's phi
                    # rows share a phase
                    e = min(a + ty, y1)
                    run((form_phi, a + 4, e + 4),
                        *(((stream_rows, a - ty),) if a > y0 else ()))
                    run((form_normal, a + 2, e + 2))
                    run((form_post, a + 1, e + 1))
                run((stream_rows, steps[-1]))
    return out, writes, grad, reads, collided


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
    solid[shape[0] // 2, :] = False   # one fluid row at least
    return solid


def _inputs(kind, shape, seed):
    solid = _solid(kind, shape, seed)
    fluid = ~solid
    rng = np.random.default_rng(seed + 100)
    phi = rng.uniform(-1.0, 1.0, shape) * fluid
    post = rng.uniform(-1.0, 1.0, (12,) + shape)
    return solid, fluid, phi, post


def _jax_stream(f, solid):
    up = upwind_solid_masks(JD2Q9, solid)
    return np.asarray(stream(jnp.asarray(f), JD2Q9, up)) * ~solid


def _want(post, solid):
    """(total, red) streamed by the JAX pull: the red part of a cell's
    post-collision population j is frac post_j + w_j (e_jx A + e_jy B)."""
    red_post = np.stack([post[9] * post[j] + W[j] * (E[j, 0] * post[10] +
                                                     E[j, 1] * post[11])
                         for j in range(9)])
    return _jax_stream(post[:9], solid), _jax_stream(red_post, solid)


def _pull_collisions(shape, tx=TX, run_h=RUN_H):
    """How often the pull collides each cell: once, twice on the two
    columns at each strip's left edge (x0 - 1 and x0: its halo and its
    neighbour's) and on the two rows at each run's start, four times where
    both meet."""
    ny, nx = shape
    cols = np.zeros(nx, int)
    cols[np.concatenate([np.arange(0, nx, tx), np.arange(0, nx, tx) - 1])
         % nx] = 1
    rows = np.zeros(ny, int)
    rows[np.concatenate([np.arange(0, ny, run_h),
                         np.arange(0, ny, run_h) - 1]) % ny] = 1
    return (1 + rows)[:, None] * (1 + cols)[None, :]


def _check_walk(kind, shape, seed, push, wetting, **knobs):
    solid, fluid, phi, post = _inputs(kind, shape, seed)
    out, writes, grad, reads, collided = strip_mirror(
        fluid, phi, post, wetting, push, **knobs)
    assert writes.min() == 1 and writes.max() == 1
    total, red = _want(post, solid)
    if push:
        np.testing.assert_array_equal(out[0], red)
        np.testing.assert_array_equal(out[1], total - red)
    else:
        np.testing.assert_array_equal(out[0], total)
        np.testing.assert_array_equal(out[1], red)
    ext = solid_phi_extrapolate(jnp.asarray(phi), jnp.asarray(fluid)) \
        if wetting else jnp.asarray(phi)
    g = np.stack([np.asarray(c) for c in color_gradient(ext, JD2Q9)])
    formed = ~np.isnan(grad[0])
    np.testing.assert_allclose(grad[:, formed], g[:, formed], rtol=0,
                               atol=1e-14)
    # each collided cell read its eight neighbours' gradients
    for y, xs, nb in reads:
        for k, i in enumerate(range(1, 9)):
            want = g[:, (y + E[i, 1]) % shape[0], (xs + E[i, 0]) % shape[1]]
            np.testing.assert_allclose(nb[:, k].T, want, rtol=0, atol=1e-14)
    assert not collided[solid].any()
    if push:
        assert (collided[fluid] == 1).all()
    else:
        want = _pull_collisions(shape, knobs.get("tx", TX),
                                knobs.get("run_h", RUN_H))
        assert (collided[fluid] == want[fluid]).all()
    return collided, fluid


def test_mirror_sees_a_ring_too_shallow():
    """A ring that holds fewer rows than a walk forms before it reads the
    first of them (the pull's prologue forms TY + 4 normal rows, the ring
    holds TY + 2) fails the check: the first row is read from a slot a
    later row took."""
    ring = Ring("normal", 0, TY + 2, TX + 4, 2)
    ring.phase = Phase()
    for r in range(-2, TY + 2):
        ring.put(r, np.zeros((2, TX + 4)))
    with pytest.raises(AssertionError):
        ring.get(-2)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["random", "seams"])
def test_compressed_pull_walk_equals_jax_ops(kind, shape):
    """The compressed layouts' pull (K1, K2): every output slot written
    once, the streamed total and red parts equal the JAX pull's, the
    normal rings hold JAX's colour gradient of the extended phi, every ring
    row formed before it is read; each fluid cell collided once but for
    the one-column x halo of each strip and the row above each run."""
    collided, fluid = _check_walk(kind, shape, seed=shape[0] + shape[1],
                                  push=False, wetting=kind == "random")
    assert (collided[fluid] == _pull_collisions(shape)[fluid]).all()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["random", "seams"])
def test_split_walk_equals_jax_ops(kind, shape):
    """The split layout (K6), by push: every
    output slot written once with the JAX pull's red part and post - red;
    each fluid cell collided exactly once by the push."""
    _check_walk(kind, shape, seed=2 * shape[0] + shape[1], push=True,
                wetting=kind == "seams")


@pytest.mark.parametrize("push", [False, True], ids=["pull", "push"])
@pytest.mark.parametrize("knobs", [dict(tx=32, ty=4, run_h=16),
                                   dict(tx=32, ty=16, run_h=48),
                                   dict(tx=32, ty=8, run_h=64)],
                         ids=["ty4_h16", "ty16_h48", "ty8_h64"])
def test_walk_with_other_rows_a_step_and_runs(knobs, push):
    """The walk at other rows a step and run heights (the sweep's knobs):
    many runs, a last run and a last step cut short."""
    _check_walk("random", (101, 45), seed=7, push=push, wetting=True,
                **knobs)


@pytest.mark.parametrize("push", [False, True], ids=["pull", "push"])
@pytest.mark.parametrize("kind", ["random", "seams"])
def test_uniform_phi_leaves_no_gradient_beside_solids(kind, push):
    """phi 1 on every fluid cell: the extension onto the solid cells,
    num / den over the ring's fluid flags as the reference forms it, is 1
    exactly, so every gradient the normal rings hold is 0, as JAX's is.
    (num times the reciprocal of den parts from it by an ulp on some
    cells, and Xu wetting's |g| > 0 makes a unit normal of that.)"""
    solid = _solid(kind, (37, 70), 11)
    fluid = ~solid
    phi = fluid.astype(np.float64)
    post = np.zeros((12,) + solid.shape)
    _, _, grad, _, _ = strip_mirror(fluid, phi, post, True, push)
    g = np.stack([np.asarray(c) for c in color_gradient(
        solid_phi_extrapolate(jnp.asarray(phi), jnp.asarray(fluid)), JD2Q9)])
    formed = ~np.isnan(grad[0])
    assert formed.any() and not g.any()
    assert not grad[:, formed].any()
    den = sum(W[i] * np.roll(fluid.astype(float), (-E[i, 1], -E[i, 0]),
                             axis=(0, 1)) for i in range(1, 9))
    ok = solid & (den > 0)
    assert (den[ok] * (1.0 / den[ok]) != 1.0).any()


def test_kernels_extend_phi_as_num_over_den():
    """strip_kernel, the tracer's strip march (coupled2d.cu), the
    row-march's phi stage (march2d.cuh) and the local windows
    (csf2d_block.cuh) extend phi onto a solid cell as num / den, the fluid
    flags' weights summed in the loop that sums num, as the mirror and the
    reference do; none multiplies by the geometry's reciprocal plane."""
    assert SRC.count("return den > C(0) ? num / den : C(0);") == 1
    body = SRC[SRC.index("strip_kernel("):]
    body = body[:body.index("\n}\n")]
    assert "num / den" in body and "geo[4 * n" not in body
    tracer = (build.SRC_DIR / "coupled2d.cu").read_text()
    body = tracer[tracer.index("tracer_strip_kernel("):]
    body = body[:body.index("\n}\n")]
    assert "return den > C(0) ? num / den : C(0);" in body
    assert "geo[4 * n" not in body
    for name, line in (("march2d.cuh", "phi = den > C(0) ? num / den : C(0);"),
                       ("csf2d_block.cuh",
                        "PHI[c] = den > C(0) ? num / den : C(0);")):
        text = (build.SRC_DIR / name).read_text()
        assert text.count(line) == 1 and "geo[4 * n" not in text


def test_mirror_sees_a_missing_barrier():
    """The phase check fails a walk whose stream shares a phase with the
    next collision (a barrier dropped)."""
    solid, fluid, phi, post = _inputs("random", (40, 40), 3)
    ring = Ring("post", 0, TY + 2, TX + 2, 13)
    phase = Phase()
    ring.phase = phase
    ring.put(0, np.zeros((13, TX + 2)))
    ring.get(0)
    with pytest.raises(AssertionError):
        phase.check()


def test_library_launch_counts_name_the_strip_kernels():
    """chip_smoke.py's launches a step of the one-step 2-D colour-gradient
    libraries name kernels the libraries count (csf.KERNELS): K1 / K2 / K6
    one launch a step, K5c / K5s two (the tracer's strip march and the
    flow's), K4 one."""
    import chip_smoke
    from openlbmpm_torch.kernels import csf
    want = chip_smoke.CG2D_STEP_KERNELS
    assert {len(v) for v in want.values()} == {1, 2}
    assert set().union(*want.values()) <= set(csf.KERNELS)
    assert len(csf.KERNELS) == len(set(csf.KERNELS)) == 3
    for name in csf.KERNELS:
        src = "pert2d.cu" if name.startswith("pert") else \
            "coupled2d.cu" if name.startswith("tracer") else "csf2d.cuh"
        assert re.search(rf"\b{name}\b", (build.SRC_DIR / src).read_text())
    # each counts into its own slot of g_csf_launches[3]
    cuh = (build.SRC_DIR / "csf2d.cuh").read_text()
    assert "long long g_csf_launches[3];" in cuh
    for i, src in enumerate(("coupled2d.cu", "csf2d.cuh", "pert2d.cu")):
        assert f"++g_csf_launches[{i}];" in (build.SRC_DIR / src).read_text()


def _sweep_edits():
    import chip_sweep
    return chip_sweep.CG2D_EDITS


@pytest.mark.parametrize("tag", sorted(_sweep_edits()))
def test_chip_sweep_2dcg_variants_patch_once(tag, tmp_path):
    """chip_sweep.py's 2dcg mode times the strip marches on copies of csrc/
    with csf2d.cuh or pert2d.cu changed: each text it replaces stays in its
    source exactly once, and the copy differs from the sources."""
    import chip_sweep
    edits = chip_sweep.CG2D_EDITS[tag]
    assert edits
    for name, (old, new) in edits.items():
        assert (build.SRC_DIR / name).read_text().count(old) == 1
        assert old != new
    dest = chip_sweep._patched(build.SRC_DIR, tmp_path / tag, edits)
    assert all((dest / name).read_text() != (build.SRC_DIR / name).read_text()
               for name in edits)


@pytest.mark.parametrize("case, phase", [("K1 strip carry f64", "3"),
                                         ("K4 strip carry f64", "40")])
def test_chip_faults_plant_the_strip_carry_fault(case, phase):
    """chip_faults.py's strip faults replace one line of the strip march's
    pull, the same in csf2d.cuh and pert2d.cu, that stays there exactly
    once: the f64 step's first output rows read the row above them from a
    stale slot of the post ring, which must fail the f64 phase (3 for K1,
    40 for K4) while phase 45 (K3, both variants) passes."""
    import chip_faults
    header, line, fault, phases = chip_faults.CASES[case]
    assert (build.SRC_DIR / header).read_text().count(line) == 1
    assert fault != line and "sizeof(C) == 8" in fault
    assert phases == (phase,) and chip_faults.MUST_PASS[case] == ("45",)
    assert {phase, "45"} <= set(chip_faults.ALL_PHASES)


@pytest.mark.parametrize("case, fail, keep", [
    ("K3 num den_inv f64", ("45", "52"), ("3",)),
    ("K12 num den_inv f64", ("63",), ("45",))])
def test_chip_faults_plant_the_num_times_den_inv_faults(case, fail, keep):
    """chip_faults.py's num x den_inv faults put the reciprocal form of the
    solid-phi extension back into the row-march's phi stage (K3 CSF, K5c-T)
    or K12a's windows, in the f64 instances, on a line that stays there
    exactly once: the Xu porous cases of the phases named must fail it, the
    strip march's phase 3 (or the single-device K3's 45) pass."""
    import chip_faults
    header, line, fault, phases = chip_faults.CASES[case]
    assert (build.SRC_DIR / header).read_text().count(line) == 1
    assert "num / den" in line and "num * (C(1) / den)" in fault
    assert "sizeof(C) == 8" in fault
    assert phases == fail and chip_faults.MUST_PASS[case] == keep
    assert set(fail + keep) <= set(chip_faults.ALL_PHASES)
