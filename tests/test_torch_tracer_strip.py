"""The tracer's strip march of K5c / K5s (``tracer_strip_kernel``,
csrc/coupled2d.cu) against the JAX package's ops, on the CPU at f64.

A block owns TX columns of a run of RUN_H rows and steps down the run TY
rows at a time, as K1's ``strip_kernel`` does.  It keeps three rings of
rows in shared memory, row r of the domain in slot (r - y0 + 8) mod depth:
phi and the fluid flag (a 4-column halo, 4 rows ahead of the output rows)
with the fields the collision reads (rho, rho_r and the momenta of its
columns), the wetted gradient and unit normal (2 columns, 2 rows ahead),
and g_post with the fluid and transport-domain flags (1 column, 1 row
ahead).  Each output row pulls g from the post ring: the free-flow outlet
rows, half-way bounce-back, the hard interface bounce-back and the inlet
rows.  The zero and anti-bounce-back inlets read two rows behind, so a run
with those inlets forms one row more above it, and the last step of the
domain forms three rows more: its top row pulls from row 0, which the
free-flow outlet copies from rows 1-3.

``tracer_mirror`` repeats that walk in numpy: the blocks, the prologue
above each run, the rings' slots and the rows they carry from step to
step, the wrapped x halo, the barriers between the stages (a phase is what
runs between two barriers), the writes of g' and of the domain mask and
velocity, and the stream's reads, through the kernel's view of the post
ring.  Stand-ins take the place of the cell bodies: a random phi a cell (0
on solid cells), random g_post and transport-domain flags.  Held against
``ops/colorgrad.py::solid_phi_extrapolate`` and ``color_gradient`` (the
gradient each normal row holds) and, for the streamed tracers,
``ops/transport.py::free_flow_outlet``, ``ops/streaming.py::stream`` with
``upwind_solid_masks``, ``interface_bounce_back`` and the inlet rows
(``inamuro_inlet``, ``anti_bounce_back_inlet``,
``zero_concentration_inlet``), on shapes that are no multiple of the tile
or the run, on masks full of one-cell slivers and on masks with solids on
the seams: every output slot and every cell's domain mask written once,
every ring row formed before it is read and by no stage of the phase that
reads it.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest

from openlbmpm_tpu.lattice import D2Q5 as JD2Q5
from openlbmpm_tpu.lattice import D2Q9 as JD2Q9
from openlbmpm_tpu.ops import transport as jtr
from openlbmpm_tpu.ops.colorgrad import color_gradient, solid_phi_extrapolate
from openlbmpm_tpu.ops.streaming import stream, upwind_solid_masks
from openlbmpm_torch.kernels import build
from openlbmpm_torch.lattice import D2Q9

CUH = (build.SRC_DIR / "csf2d.cuh").read_text()
SRC = (build.SRC_DIR / "coupled2d.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CUH).group(1))


TX, TY, RUN_H = _constant("TX"), _constant("TY"), _constant("RUN_H")
# the rings' rows beyond TY (TracerRings in csrc/coupled2d.cu) and the
# slot offset of StripView
PR, NR, QR = (int(re.search(rf"{k} = TY \+ (\d+)", SRC).group(1))
              for k in ("PR", "NR", "QR"))
OFFSET = int(re.search(r"\(y - y0 \+ (\d+)\) % TracerRings", SRC).group(1))
E9 = D2Q9.e.astype(int)
W9 = D2Q9.w.astype(np.float64)
LATS = {5: JD2Q5, 9: JD2Q9}


class Phase:
    """The ring slots one phase reads and writes: no slot may be both."""

    def __init__(self):
        self.reads, self.writes = set(), set()

    def check(self):
        both = self.reads & self.writes
        assert not both, f"ring slots read and written in one phase: {both}"


class Ring:
    """`planes` planes of `depth` rows of `width` cells; slot
    (r - y0 + OFFSET) mod depth holds row r, and remembers which row it
    holds."""

    def __init__(self, name, y0, depth, width, planes):
        self.name, self.y0, self.depth = name, y0, depth
        self.val = np.full((planes, depth, width), np.nan)
        self.row = np.full(depth, -10 ** 9)
        self.phase = None

    def slot(self, r):
        return (r - self.y0 + OFFSET) % self.depth

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


def tracer_mirror(fluid, phi, gpost, dom, cin, opts, tx=TX, ty=TY,
                  run_h=RUN_H, depths=(PR, NR, QR), stale=False):
    """The tracer strip march's walk over the blocks: (out, writes, domw,
    grad, reads).  out (NG, ny, nx): g' of each slot; writes / domw: how
    often each output slot / each cell's domain mask was written; grad (2,
    ny, nx): the gradient of every normal-ring cell (equal wherever several
    blocks form it); reads: the neighbours' gradients each collided cell
    read.  `opts`: nq, inlet (0 none, 1 Inamuro, 2 anti-bounce-back, 3
    zero), outlet (1 free flow), interface (2 bounce-back), wetting.
    `stale`: the first output row of a step reads the row above it from
    the slot of the row two above."""
    ny, nx = fluid.shape
    nq = opts["nq"]
    ng = gpost.shape[0]
    nt = ng // nq
    lat = LATS[nq]
    dxs, dys = lat.e[:, 0].astype(int), lat.e[:, 1].astype(int)
    rev = lat.opp
    pr, nr, qr = (ty + d for d in depths)
    pw, nw, qw = tx + 8, tx + 4, tx + 2
    out = np.zeros((ng, ny, nx))
    writes = np.zeros((ng, ny, nx), np.int64)
    domw = np.zeros((ny, nx), np.int64)
    grad = np.full((2, ny, nx), np.nan)
    reads = []
    wetting = opts["wetting"]

    for by in range(-(-ny // run_h)):
        for bx in range(-(-nx // tx)):
            x0, y0 = bx * tx, by * run_h
            y1 = min(y0 + run_h, ny)
            ph = Ring("phi", y0, pr, pw, 3)
            nm = Ring("normal", y0, nr, nw, 2)
            po = Ring("post", y0, qr, qw, ng + 2)

            def form_phi(r0, r1):
                cols = (x0 - 4 + np.arange(pw)) % nx
                kept = (np.arange(pw) >= 3) & (np.arange(pw) < tx + 5)
                for r in range(r0, r1):
                    y = r % ny
                    ph.put(r, [phi[y, cols], fluid[y, cols],
                               np.where(kept, y * nx + cols, np.nan)])

            def form_normal(r0, r1):
                for r in range(r0, r1):
                    rows = {dy: ph.get(r + dy) for dy in range(-2, 3)} \
                        if wetting else {dy: ph.get(r + dy) for dy in
                                         (-1, 0, 1)}

                    def ext(dy, dx):
                        c = np.arange(nw) + 2 + dx
                        p, f = rows[dy][0][c], rows[dy][1][c] > 0.5
                        if not wetting:
                            return p
                        num, den = np.zeros(nw), np.zeros(nw)
                        for i in range(1, 9):
                            nb = rows[dy + E9[i, 1]]
                            num = num + W9[i] * nb[0][c + E9[i, 0]]
                            den = den + W9[i] * nb[1][c + E9[i, 0]]
                        ok = den > 0
                        return np.where(f, p, np.where(
                            ok, num / np.where(ok, den, 1.0), 0.0))
                    gx, gy = np.zeros(nw), np.zeros(nw)
                    for i in range(1, 9):
                        v = ext(E9[i, 1], E9[i, 0])
                        if E9[i, 0]:
                            gx = gx + (W9[i] * E9[i, 0]) * v
                        if E9[i, 1]:
                            gy = gy + (W9[i] * E9[i, 1]) * v
                    g = np.stack([3.0 * gx, 3.0 * gy])
                    y, cols = r % ny, (x0 - 2 + np.arange(nw)) % nx
                    seen = ~np.isnan(grad[0, y, cols])
                    assert (grad[:, y, cols][:, seen] == g[:, seen]).all()
                    grad[:, y, cols] = g
                    nm.put(r, g)

            qn = min(qw, nx - x0 + 2)

            def form_post(r0, r1):
                lx = np.arange(qn)
                for r in range(r0, r1):
                    x, y = (x0 - 1 + lx) % nx, r % ny
                    row = ph.get(r)
                    # the fields the phi pass kept are this cell's
                    assert (row[2][lx + 3] == y * nx + x).all()
                    nb = np.stack([nm.get(r + E9[i, 1])[:, lx + 1 + E9[i, 0]].T
                                   for i in range(1, 9)], axis=1)
                    own = nm.get(r)[:, lx + 1].T
                    reads.append((y, x, nb, own))
                    v = np.full((ng + 2, qw), np.nan)
                    v[:ng, :qn] = gpost[:, y, x]
                    v[ng, :qn] = row[1][lx + 3]
                    v[ng + 1, :qn] = dom[y, x]
                    po.put(r, v)
                    if y0 <= r < y1:
                        mine = (lx >= 1) & (lx <= tx) & (x0 + lx - 1 < nx)
                        domw[y, x[mine]] += 1

            def stream_rows(a):
                for r in range(a, min(a + ty, y1)):
                    for c in range(min(tx, nx - x0)):
                        lx = c + 1

                        def get(q, xx, yy):
                            if stale and r == a and yy == r - 1:
                                # the fault: the slot of the row two above,
                                # whatever it holds now
                                return po.val[q, po.slot(yy - 1), xx]
                            return po.get(yy)[q][xx]

                        def fl(xx, yy):
                            return 1.0 if get(ng, xx, yy) > 0.5 else 0.0

                        def post_at(q, xx, yy):
                            if opts["outlet"] == 1:
                                while yy % ny <= 2 and fl(xx, yy) > 0.5:
                                    yy += 1
                            return get(q, xx, yy)

                        def streamed(t, i, xx, yy):
                            f, q = fl(xx, yy), t * nq
                            if i == 0:
                                return post_at(q, xx, yy) * f
                            sx, sy = xx - dxs[i], yy - dys[i]
                            val = post_at(q + i, sx, sy) if fl(sx, sy) > 0.5 \
                                else post_at(q + rev[i], xx, yy)
                            return val * f

                        def repaired(t, i, xx, yy):
                            if opts["interface"] == 2 and i != 0:
                                sx, sy = xx - dxs[i], yy - dys[i]
                                d = get(ng + 1, xx, yy) > 0.5
                                ds = get(ng + 1, sx, sy) > 0.5
                                if d and not ds:
                                    return streamed(t, rev[i], sx, sy)
                                if not d and ds:
                                    return 0.0
                            return streamed(t, i, xx, yy)

                        fluid_c = fl(lx, r) > 0.5
                        g_row = r % ny
                        ys = r - 1 if (opts["inlet"] == 3 and
                                       g_row == ny - 2 and fluid_c) else r
                        top = g_row == ny - 1 and fluid_c
                        x = x0 + c
                        for t in range(nt):
                            o = [repaired(t, i, lx, ys) for i in range(nq)]
                            if opts["inlet"] == 1 and top:
                                o[4] = cin[t] - (o[0] + o[1] + o[2] + o[3])
                            elif opts["inlet"] == 2 and top:
                                o[4] = -repaired(t, 3, lx, r - 1) + \
                                    2.0 * (1.0 / 6.0) * cin[t]
                            out[t * nq:(t + 1) * nq, r, x] = o
                            writes[t * nq:(t + 1) * nq, r, x] += 1

            def run(*stages):
                phase = Phase()
                for ring in (ph, nm, po):
                    ring.phase = phase
                for fn, *args in stages:
                    fn(*args)
                phase.check()

            lo = 1 if opts["inlet"] >= 2 else 0
            steps = range(y0, y1, ty)
            run((form_phi, y0 - 4 - lo, y0 + 4))
            run((form_normal, y0 - 2 - lo, y0 + 2))
            run((form_post, y0 - 1 - lo, y0 + 1))
            for a in steps:
                e = min(a + ty, y1)
                more = 3 if e == ny and opts["outlet"] == 1 else 0
                run((form_phi, a + 4, e + 4 + more),
                    *(((stream_rows, a - ty),) if a > y0 else ()))
                run((form_normal, a + 2, e + 2 + more))
                run((form_post, a + 1, e + 1 + more))
            run((stream_rows, steps[-1]))
    return out, writes, domw, grad, reads


# (inlet, outlet, interface, nq): the Inamuro inlet with the free-flow
# outlet and a permeable interface; anti-bounce-back with a bounce-back
# interface; the zero inlet with the free-flow outlet and bounce-back;
# D2Q9 with bounce-back and no rows
OPTS = {"inamuro_freeflow": dict(inlet=1, outlet=1, interface=1, nq=5),
        "antibb_bounceback": dict(inlet=2, outlet=0, interface=2, nq=5),
        "zero_freeflow_bb": dict(inlet=3, outlet=1, interface=2, nq=5),
        "d2q9_bounceback": dict(inlet=0, outlet=0, interface=2, nq=9)}
SHAPES = [(101, 45), (37, 70), (34, 40), (8, 5)]


def _solid(kind, shape, seed):
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


def _inputs(kind, shape, seed, nq, nt=2):
    solid = _solid(kind, shape, seed)
    fluid = ~solid
    rng = np.random.default_rng(seed + 100)
    phi = rng.uniform(-1.0, 1.0, shape) * fluid
    gpost = rng.uniform(0.0, 1.0, (nt * nq,) + shape)
    dom = rng.random(shape) < 0.6
    cin = rng.uniform(0.5, 1.0, nt)
    return solid, fluid, phi, gpost, dom, cin


def _jax_tracer(gpost, solid, dom, cin, opts):
    """The reference's rows around the streaming of g_post
    (TransportRK._transport_substep after the collision)."""
    nq = opts["nq"]
    lat = LATS[nq]
    ny = solid.shape[0]
    fl = ~solid
    g = jnp.asarray(gpost.reshape(-1, nq, *solid.shape))
    m = {r: jnp.asarray(fl[r]) for r in (0, 1, 2, ny - 2, ny - 1)}
    if opts["outlet"] == 1:
        g = jtr.free_flow_outlet(g, (2, 1, 0), (m[2], m[1], m[0]))
    g = stream(g, lat, jnp.asarray(upwind_solid_masks(lat, solid))) * \
        jnp.asarray(fl, g.dtype)
    if opts["interface"] == 2:
        g = jtr.interface_bounce_back(g, jnp.asarray(dom), lat)
    if opts["inlet"] == 1:
        g = jtr.inamuro_inlet(g, cin, ny - 1, m[ny - 1])
    elif opts["inlet"] == 2:
        g = jtr.anti_bounce_back_inlet(g, cin, ny - 2, m[ny - 1],
                                       w3=float(lat.w[3]))
    elif opts["inlet"] == 3:
        g = jtr.zero_concentration_inlet(g, ny - 2, m[ny - 2])
    return np.asarray(g).reshape(gpost.shape)


def _check(kind, shape, name, seed, wetting=True, **knobs):
    opts = OPTS[name] | {"wetting": wetting}
    solid, fluid, phi, gpost, dom, cin = _inputs(kind, shape, seed,
                                                 opts["nq"])
    out, writes, domw, grad, reads = tracer_mirror(fluid, phi, gpost, dom,
                                                   cin, opts, **knobs)
    assert writes.min() == 1 and writes.max() == 1
    assert domw.min() == 1 and domw.max() == 1
    np.testing.assert_allclose(out, _jax_tracer(gpost, solid, dom, cin, opts),
                               rtol=0, atol=1e-15)
    ext = solid_phi_extrapolate(jnp.asarray(phi), jnp.asarray(fluid)) \
        if wetting else jnp.asarray(phi)
    g = np.stack([np.asarray(c) for c in color_gradient(ext, JD2Q9)])
    assert not np.isnan(grad).any()
    np.testing.assert_allclose(grad, g, rtol=0, atol=1e-14)
    for y, xs, nb, own in reads:
        np.testing.assert_allclose(own.T, g[:, y, xs], rtol=0, atol=1e-14)
        for k, i in enumerate(range(1, 9)):
            want = g[:, (y + E9[i, 1]) % shape[0], (xs + E9[i, 0]) % shape[1]]
            np.testing.assert_allclose(nb[:, k].T, want, rtol=0, atol=1e-14)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["random", "seams"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_tracer_walk_equals_jax_ops(name, kind, shape):
    """Every output slot and every cell's domain mask written once, g'
    equal to the JAX rows around the streaming of g_post, the normal rings
    holding JAX's colour gradient of the extended phi, each collision
    reading its own and its neighbours' gradients, every ring row formed
    before it is read and in no phase that reads it."""
    _check(kind, shape, name, seed=shape[0] + 3 * shape[1] + len(name))


@pytest.mark.parametrize("knobs", [dict(tx=32, ty=4, run_h=16),
                                   dict(tx=32, ty=16, run_h=48)],
                         ids=["ty4_h16", "ty16_h48"])
@pytest.mark.parametrize("name", ["zero_freeflow_bb", "antibb_bounceback"])
def test_tracer_walk_with_other_rows_a_step_and_runs(name, knobs):
    """The walk at other rows a step and run heights: many runs, a last run
    and a last step cut short (the rings' depths are TY plus the source's
    margins)."""
    _check("random", (101, 45), name, seed=7, **knobs)


def test_tracer_walk_without_wetting():
    """Without wetting the normals read phi 1 row around, not 2."""
    _check("seams", (37, 70), "inamuro_freeflow", seed=5, wetting=False)


@pytest.mark.parametrize("ring, depths", [
    ("post", (PR, NR, QR - 1)), ("normal", (PR, NR - 1, QR)),
    ("phi", (PR - 1, NR, QR))])
def test_mirror_sees_a_ring_too_shallow(ring, depths):
    """A ring one row shallower than the source's fails the walk: the last
    step of the domain, a whole one here (ny = 40), forms 3 rows more for
    the free-flow outlet and reads a row from a slot a later row took."""
    opts = OPTS["zero_freeflow_bb"] | {"wetting": True}
    solid, fluid, phi, gpost, dom, cin = _inputs("random", (40, 45), 3, 5)
    with pytest.raises(AssertionError, match=ring):
        tracer_mirror(fluid, phi, gpost, dom, cin, opts, depths=depths)


def test_mirror_sees_a_stale_carried_row():
    """chip_faults.py's K5c fault: a step's first output row reading the
    row above it, carried from the step before, from the slot of the row
    two above, parts from the JAX rows."""
    opts = OPTS["inamuro_freeflow"] | {"wetting": True}
    solid, fluid, phi, gpost, dom, cin = _inputs("random", (37, 45), 9, 5)
    out = tracer_mirror(fluid, phi, gpost, dom, cin, opts, stale=True)[0]
    assert np.abs(out - _jax_tracer(gpost, solid, dom, cin, opts)).max() > 0.1


def test_chip_faults_plant_the_tracer_strip_fault():
    """chip_faults.py's tracer strip fault replaces one line of
    StripView (csrc/coupled2d.cu) that stays there exactly once, in the f64
    instance: phase 6 or 11 must fail it, phase 52 (K5c-T) pass."""
    import chip_faults
    header, line, fault, phases = chip_faults.CASES["K5c strip carry f64"]
    assert header == "coupled2d.cu"
    assert (build.SRC_DIR / header).read_text().count(line) == 1
    assert fault != line and "sizeof(C) == 8" in fault
    assert set(phases) == {"6", "11"}
    assert chip_faults.MUST_PASS["K5c strip carry f64"] == ("52",)
    assert {"6", "11", "52"} <= set(chip_faults.ALL_PHASES)
