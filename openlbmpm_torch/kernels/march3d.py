"""The z-march of the 3-D T-step kernels K11-T, K10-T and K9-T: its plan,
which the wrappers hand to the kernels, and a plain PyTorch model that
executes the plan level by level and slab by slab.

One launch advances T time steps.  Level 0 is the input state and level s
the state after s steps.  The step is cut into stages (K11-T: collide at
level 0, then one stage a level that pulls the post-collision values of the
level before and collides them, then the last stream; K10-T: load,
collide, stream; K9-T: load, boundary slabs, the extrapolation of phi onto
solid cells, gradient and normal, curvature with the collision, stream),
each of which computes one z slab of its level from slabs of earlier stages
that lie within its reach.  A stage's output lives in a ring of slabs (one
array of the ring per quantity: the state, rho, phi, the post-collision
values, ...), and only level 0 is read from device memory and level T
written to it.

Schedule.  Stage k handles slab u at wave floor((u + d_k) / Z) (Z slabs a
wave), and the waves run one after another with a grid-wide barrier
between them.  A stage that reads an array up to zhi slabs above its own
slab waits d_k >= d_q + zhi + Z for every stage q that writes that array
before it (so what it reads was written in an earlier wave), and the ring
of an array holds max_c (d_c + zlo_c) - d_p + Z slabs (p its producer, c
the stages that read it zlo slabs below their own), so no slot is reused
while a reader still needs it.  A level therefore lags its predecessor by
the sum of its stages' reaches plus Z a stage.

The periodic seam in z.  Slab u is unwrapped: the march runs u from below
0 to above nz - 1, and u mod nz names the slab of the domain.  The last
stage covers 0 ... nz - 1; every earlier stage covers what its readers read
(each read's zlo below, zhi above), so level s starts (T - s) reaches below
slab 0 and ends as far above nz - 1, recomputing those slabs of the top and
of the bottom once more.  That recompute at the seam is the only one in z.
(Keeping each level's first slabs until the march comes back round to them
would avoid it, but the boundary slabs rewrite their state in place, and
two copies of a slab would both have to take the rewrite.)

The plane.  With one band the rings hold every row and x and y wrap inside
them.  With several y-bands (to keep the rings within a budget of device
memory), the bands run one after another; a band of R rows carries a halo of
H rows a side (the sum of the stages' y reaches), stage k works on its R
rows and e_k more a side (e_k the reach of the stages after it), and only
the band's own rows are written out.  The last band may overhang ny; its
overhanging rows wrap onto rows that band 0 wrote, with the same values.

The boundary slabs of K9-T (the NEBB inlet on slab nz - 2 and its ghost
nz - 1, the convective cascade 3 -> 2 -> 1 -> 0, or the NEBB pressure
outlet on slab 1 and its ghost 0) rewrite the level's state ring in place,
each column by one thread, when the march reaches the lowest slab a
rewrite touches (nz - 2, or 0): they read up to bhi slabs above it and
finalise up to tlo slabs above it, so they cover tlo slabs below the
stages that read the state after them.

``single3d_march_plan``, ``sc3d_march_plan`` and ``cg3d_march_plan`` build
a plan; ``Plan.tensor`` is what the kernel reads (``csrc/march3d.cuh``);
``single3d_march_reference``, ``sc3d_march_reference`` and
``cg3d_march_reference`` execute a plan on the CPU from rings of its
depth, every wave reading only what earlier waves wrote (a ring is full of
NaN until a stage writes it), with the plain path's operators for each
stage.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..lattice import D3Q19
from ..ops import colorgrad as cg
from ..ops import equilibrium as eq
from ..ops import macroscopic as mac
from ..ops.common import shift
from . import build

__all__ = ["LOAD", "COLLIDE", "STREAM", "BC", "EXTRAP", "NORMAL", "SCOLLIDE",
           "KIND_NAMES", "Read", "Stage", "Ring", "Plan", "build_plan",
           "single3d_march_plan", "sc3d_march_plan", "cg3d_march_plan",
           "RING_BUDGET", "MAX_HALO_SHARE", "SLABS_PER_WAVE",
           "single3d_march_reference",
           "sc3d_march_reference", "cg3d_march_reference"]

# stage kinds, as csrc/march3d.cuh numbers them
LOAD, COLLIDE, STREAM, BC, EXTRAP, NORMAL = range(6)
# the 2-D row-march's stages (kernels/march2d.py) take 6 ... 8 and 10, 11;
# K11-T's stream-and-collide stage is 9
SCOLLIDE = 9
KIND_NAMES = ("load", "collide", "stream", "bc", "extrap", "normal", "phi",
              "tcollide", "tstream", "scollide", "outlet", "store")
Q = 19
HEADER = 16          # int64 words before the stage table
STAGE_WORDS = 8      # kind, level, e, ring ids 0-3, spare
RING_WORDS = 4       # byte offset, planes, depth, item size
ALIGN = 256          # bytes each ring's start is aligned to
# the most stages and rings a plan may hold (csrc/march3d.cuh keeps their
# words in each block's shared memory)
MAX_STAGES, MAX_RINGS = 64, 48
# the rings' bytes the automatic band choice keeps a launch within, and the
# most band rows plus halo it accepts over the band's own rows.  Bands sized
# for the 50 MB L2 lost to one band at 128^3 on an H100 (the halo's
# recompute and the waves cost more than the rings' spill to HBM; PERF.md),
# so the budget is device memory's: bands cut only what would not fit it.
RING_BUDGET = 4 * 2 ** 30
MAX_HALO_SHARE = 1.5
# slabs a wave (Z): 8 was the fastest of 1, 2, 4 and 8 for K10-T and K9-T
# at 128^3 on an H100, and of 2, 4 and 8 for K11-T at T = 4, whose rings
# fit the 50 MB L2 at 4 slabs a wave and below (PERF.md)
SLABS_PER_WAVE = 8


@dataclasses.dataclass(frozen=True)
class Read:
    """A stage reads `array` from zlo slabs below to zhi above its own slab
    and ry rows on each side of its own rows."""
    array: str
    zlo: int = 0
    zhi: int = 0
    ry: int = 0


@dataclasses.dataclass
class Stage:
    """One stage of one level.  `writes` are arrays it produces (new slabs),
    `modifies` arrays it rewrites in place; `back` is how many slabs below
    its readers' reads an in-place writer must also cover (its rewrites
    reach that far above the slab that triggers them), and an in-place
    writer also waits for the stages before it that read the array's
    earlier values; `output` marks a stage that writes the launch's output
    (it covers the domain's slabs, as the last stage does); `rings` the arrays
    the kernel hands it, in the kernel's order ("" where it reads or writes
    device memory instead); `slabs` the domain slabs (mod nz) at which it
    has work, None for every slab (the boundary slabs' triggers).  The plan
    fills d (wave offset in slabs), lo and hi (the unwrapped slabs it covers)
    and e (rows beyond the band a side)."""
    kind: int
    level: int
    reads: tuple = ()
    writes: tuple = ()
    modifies: tuple = ()
    back: int = 0
    rings: tuple = ()
    slabs: tuple | None = None
    output: bool = False
    d: int = 0
    lo: int = 0
    hi: int = -1
    e: int = 0


@dataclasses.dataclass
class Ring:
    """One array's ring: planes x depth slabs x rows x nx values of
    itemsize bytes, at a byte offset of the scratch buffer."""
    name: str
    planes: int
    itemsize: int
    depth: int = 0
    offset: int = 0

    def nbytes(self, rows: int, nx: int) -> int:
        return self.planes * self.depth * rows * nx * self.itemsize


@dataclasses.dataclass
class Plan:
    """A launch's plan: the stages with their schedule, the rings, the
    bands and the waves (each a list of (stage index, slab) entries)."""
    family: str
    nz: int
    ny: int
    nx: int
    steps: int
    slabs_per_wave: int
    stages: list
    rings: list
    bands: int
    band_rows: int
    halo: int
    rows: int              # ring rows: band_rows + 2 halo, or ny
    waves: list
    budget: int = RING_BUDGET   # the ring bytes the bands aim at

    @property
    def scratch_bytes(self) -> int:
        end = 0
        for r in self.rings:
            end = max(end, r.offset + r.nbytes(self.rows, self.nx))
        return end

    @property
    def lag(self) -> int:
        """Slabs a level trails the one before it (0 at T = 1)."""
        d = [s.d for s in self.stages if s.kind in (COLLIDE, SCOLLIDE)]
        return d[1] - d[0] if len(d) > 1 else 0

    def stage_rows(self, st: Stage) -> int:
        return self.ny if self.bands == 1 else self.band_rows + 2 * st.e

    def fields(self) -> dict:
        """The plan's numbers a tiling helper reports."""
        return {"levels": self.steps, "lag": self.lag,
                "slabs_per_wave": self.slabs_per_wave, "bands": self.bands,
                "band_rows": self.band_rows, "halo": self.halo,
                "ring_slabs": {r.name: r.depth for r in self.rings
                               if r.name.endswith("0")},
                "scratch_bytes": self.scratch_bytes,
                "budget": self.budget,
                "fits": self.scratch_bytes <= self.budget,
                "waves": len(self.waves),
                "stages": len(self.stages)}

    def tensor(self) -> torch.Tensor:
        """The int64 table the kernel reads: a header, the stages (kind,
        level, e, four ring ids), the rings (byte offset, planes, depth,
        item size), the waves' first entries and their largest cell count,
        and the entries (stage, unwrapped slab, cells)."""
        ring_id = {r.name: i for i, r in enumerate(self.rings)}
        stages = []
        for st in self.stages:
            ids = [ring_id[n] if n else -1 for n in st.rings]
            ids += [-1] * (4 - len(ids))
            stages.append([st.kind, st.level, st.e, *ids, 0])
        rings = [[r.offset, r.planes, r.depth, r.itemsize]
                 for r in self.rings]
        ptr, items, entries = [0], [], []
        for wave in self.waves:
            most = 0
            for k, u in wave:
                cells = self.stage_rows(self.stages[k]) * self.nx
                entries.append([k, u, cells])
                most = max(most, cells)
            ptr.append(len(entries))
            items.append(most)
        header = [1, len(stages), len(rings), len(self.waves), len(entries),
                  self.bands, self.band_rows, self.rows, self.halo, self.nz,
                  self.ny, self.nx, self.steps, self.slabs_per_wave,
                  self.scratch_bytes, int(self.family == "cg")]
        words = header + [v for row in stages + rings for v in row] + ptr + \
            items + [v for row in entries for v in row]
        return torch.tensor(words, dtype=torch.int64)


def _writers(stages, upto: int, array: str):
    """Indices of the stages before `upto` that write or modify `array`."""
    return [q for q in range(upto)
            if array in stages[q].writes or array in stages[q].modifies]


def build_plan(family: str, stages: list, arrays: dict, shape, steps: int,
               slabs_per_wave: int, band_rows: int | None = None,
               budget: int = RING_BUDGET) -> Plan:
    """The schedule of a stage chain (module docstring): wave offsets,
    slab coverage, rows a side, ring depths, bands and waves.  `arrays`
    maps each array to (planes, item size).  `band_rows` None picks the
    bands: one if the rings fit `budget`, else the fewest bands whose rings
    fit it with their halo at most MAX_HALO_SHARE of the band's rows, else
    the most bands within that share."""
    nz, ny, nx = (int(v) for v in shape)
    z = int(slabs_per_wave)
    if z < 1:
        raise ValueError(f"slabs_per_wave {slabs_per_wave!r}: >= 1")
    n = len(stages)
    if n > MAX_STAGES or len(arrays) > MAX_RINGS:
        raise ValueError(f"{n} stages and {len(arrays)} rings: a plan holds "
                         f"at most {MAX_STAGES} and {MAX_RINGS}")
    # wave offsets, forward: after the writers of what a stage reads, and
    # an in-place writer after the earlier readers of what it rewrites (a
    # reader of slab v reads down to v - zlo, a rewrite triggered at u
    # reaches u + back)
    for c, st in enumerate(stages):
        st.d = 0
        for r in st.reads:
            for q in _writers(stages, c, r.array):
                st.d = max(st.d, stages[q].d + r.zhi + z)
        for a in st.modifies:
            for q in range(c):
                for r in stages[q].reads:
                    if r.array == a:
                        st.d = max(st.d, stages[q].d + r.zlo + st.back + z)
    # slab coverage and rows a side, backward from the output stages
    for c, st in enumerate(stages):
        if st.output or c == n - 1:
            st.lo, st.hi, st.e = 0, nz - 1, 0
        else:
            st.lo, st.hi, st.e = 10 ** 9, -10 ** 9, 0
    for c in range(n - 1, -1, -1):
        st = stages[c]
        if st.lo > st.hi:
            raise ValueError(f"stage {KIND_NAMES[st.kind]} of level "
                             f"{st.level} feeds nothing")
        for r in st.reads:
            for q in _writers(stages, c, r.array):
                w = stages[q]
                back = w.back if r.array in w.modifies else 0
                w.lo = min(w.lo, st.lo - r.zlo - back)
                w.hi = max(w.hi, st.hi + r.zhi)
                w.e = max(w.e, st.e + r.ry)
    # ring depths
    rings = []
    for name, (planes, itemsize) in arrays.items():
        p = _writers(stages, n, name)[0]
        depth = 0
        for c, st in enumerate(stages):
            for r in st.reads:
                if r.array == name and c != p:
                    depth = max(depth, st.d + r.zlo - stages[p].d + z)
        rings.append(Ring(name, planes, itemsize, depth))
    # bands
    halo = max(st.e for st in stages)

    def ring_bytes(rows):
        return sum(r.planes * r.depth * rows * nx * r.itemsize for r in rings)

    if band_rows is None:
        bands = 1
        if ring_bytes(ny) > budget:
            best = None
            for b in range(2, ny + 1):
                br = -(-ny // b)
                if br + 2 * halo > MAX_HALO_SHARE * br:
                    break
                best = b
                if ring_bytes(br + 2 * halo) <= budget:
                    break
            bands = best or 1
        band_rows = -(-ny // bands)
    else:
        band_rows = int(band_rows)
        if not 1 <= band_rows <= ny:
            raise ValueError(f"band_rows {band_rows}: 1 ... {ny}")
        bands = -(-ny // band_rows)
    if bands == 1:
        band_rows, halo = ny, 0
        for st in stages:
            st.e = 0
    rows = band_rows + 2 * halo if bands > 1 else ny
    off = 0
    for r in rings:
        r.offset = off
        off += -(-r.nbytes(rows, nx) // ALIGN) * ALIGN
    # waves
    first = min((st.lo + st.d) // z for st in stages)
    count = max((st.hi + st.d) // z for st in stages) - first + 1
    waves = [[] for _ in range(count)]
    for k, st in enumerate(stages):
        for u in range(st.lo, st.hi + 1):
            if st.slabs is None or u % nz in st.slabs:
                waves[(u + st.d) // z - first].append((k, u))
    return Plan(family, nz, ny, nx, steps, z, stages, rings, bands,
                band_rows, halo, rows, waves, budget)


def single3d_march_plan(shape, steps: int, itemsize: int,
                        slabs_per_wave: int = SLABS_PER_WAVE,
                        band_rows: int | None = None) -> Plan:
    """K11-T's plan for an (nz, ny, nx) domain and `steps` steps a launch in
    a compute type of `itemsize` bytes: T + 1 stages, one ring a level.
    collide (level 0: the input at the slab) -> post_0 (19 planes);
    scollide at level s = 1 ... T - 1 (post_{s-1} one slab and one row
    around: pull streaming with half-way bounce-back, then the collision of
    the pulled cell) -> post_s; stream (post_{T-1} one slab and row around)
    -> the output.  The fluid mask is static and read from device memory,
    so no ring carries it."""
    build.check_steps(steps)
    arrays = {f"post{s}": (Q, itemsize) for s in range(steps)}
    stages = [Stage(COLLIDE, 0, writes=("post0",), rings=("post0",))]
    for s in range(1, steps):
        stages.append(Stage(SCOLLIDE, s,
                            reads=(Read(f"post{s - 1}", 1, 1, 1),),
                            writes=(f"post{s}",),
                            rings=(f"post{s - 1}", f"post{s}")))
    stages.append(Stage(STREAM, steps - 1,
                        reads=(Read(f"post{steps - 1}", 1, 1, 1),),
                        rings=(f"post{steps - 1}",)))
    return build_plan("single", stages, arrays, shape, steps, slabs_per_wave,
                      band_rows)


def sc3d_march_plan(shape, fluids: int, steps: int, itemsize: int,
                    slabs_per_wave: int = SLABS_PER_WAVE,
                    band_rows: int | None = None) -> Plan:
    """K10-T's plan for an (nz, ny, nx) domain of `fluids` fluids and
    `steps` steps a launch in a compute type of `itemsize` bytes.  Level s:
    its state F_s (K x 19 planes) with rho_s (K planes) and the fluid bytes
    fl_s beside it; collide (F_s at its slab, rho_s and fl_s one slab and
    one row around: the interaction stencil) -> post_s (K x 19); stream
    (post_s one slab and row around) -> F_{s+1}, rho_{s+1}, fl_{s+1}, or the
    output.  Level 0's F is the input, which its collide stage reads; the
    load stage writes rho_0 and fl_0 from it."""
    build.check_steps(steps)
    k = int(fluids)
    arrays, stages = {}, []

    def level_arrays(s):
        arrays[f"F{s}"] = (k * Q, itemsize)
        arrays[f"rho{s}"] = (k, itemsize)
        arrays[f"fl{s}"] = (1, 1)

    level_arrays(0)
    del arrays["F0"]      # level 0's populations come from the input
    stages.append(Stage(LOAD, 0, writes=("rho0", "fl0"),
                        rings=("", "rho0", "fl0")))
    for s in range(steps):
        arrays[f"post{s}"] = (k * Q, itemsize)
        fs = f"F{s}" if s else ""
        stages.append(Stage(
            COLLIDE, s, reads=((Read(fs),) if fs else ()) +
            (Read(f"rho{s}", 1, 1, 1), Read(f"fl{s}", 1, 1, 1)),
            writes=(f"post{s}",),
            rings=(fs, f"rho{s}", f"fl{s}", f"post{s}")))
        out = () if s == steps - 1 else (f"F{s + 1}", f"rho{s + 1}",
                                         f"fl{s + 1}")
        if out:
            level_arrays(s + 1)
        stages.append(Stage(STREAM, s, reads=(Read(f"post{s}", 1, 1, 1),),
                            writes=out, rings=(f"post{s}", *out) if out
                            else (f"post{s}", "", "", "")))
    return build_plan("sc", stages, arrays, shape, steps, slabs_per_wave,
                      band_rows)


def cg3d_march_plan(shape, steps: int, itemsize: int, split: bool,
                    inlet: int, outlet: int, wetting: bool,
                    slabs_per_wave: int = SLABS_PER_WAVE,
                    band_rows: int | None = None) -> Plan:
    """K9-T's plan for an (nz, ny, nx) domain and `steps` steps a launch in
    a compute type of `itemsize` bytes; `split` the split layout (38 state
    planes, else 20), `inlet` 0 periodic / 1 velocity, `outlet` 0 periodic /
    1 convective / 2 pressure, `wetting` whether solid phi is extrapolated.
    Level s: its state st_s with phi_s beside it (both written by the load
    or the stream stage before); the boundary slabs in place on both
    (reading bhi slabs above a trigger, finalising tlo above it); the
    extrapolation of phi in place (phi one slab and row around); gradient
    and normal -> gn_s (g, n: 6 planes; phi one slab and row around);
    curvature (n one slab and row around) with the collision -> po_s (the
    post-collision PDF and the red part of each population: 38 planes);
    stream (po_s one slab and row around) -> st_{s+1} and phi_{s+1}, or the
    output."""
    build.check_steps(steps)
    nz = int(shape[0])
    ns = 2 * Q if split else Q + 1
    bhi = max(3 if outlet == 1 else 0, 1 if outlet == 2 else 0,
              1 if inlet == 1 else 0)
    tlo = max(2 if outlet == 1 else 0, 1 if outlet == 2 else 0,
              1 if inlet == 1 else 0)
    # the slabs at which the boundary stage's rewrites start
    triggers = ((nz - 2,) if inlet else ()) + ((0,) if outlet else ())
    arrays = {"st0": (ns, itemsize), "phi0": (1, itemsize)}
    stages = [Stage(LOAD, 0, writes=("st0", "phi0"), rings=("st0", "phi0"))]
    for s in range(steps):
        st, phi, gn, po = f"st{s}", f"phi{s}", f"gn{s}", f"po{s}"
        arrays[gn] = (6, itemsize)
        arrays[po] = (2 * Q, itemsize)
        if inlet or outlet:
            stages.append(Stage(
                BC, s, reads=(Read(st, 0, bhi, 0),), modifies=(st, phi),
                back=tlo, rings=(st, phi), slabs=triggers))
        if wetting:
            stages.append(Stage(EXTRAP, s, reads=(Read(phi, 1, 1, 1),),
                                modifies=(phi,), rings=(phi,)))
        stages.append(Stage(NORMAL, s, reads=(Read(phi, 1, 1, 1),),
                            writes=(gn,), rings=(phi, gn)))
        stages.append(Stage(COLLIDE, s, reads=(Read(gn, 1, 1, 1), Read(phi),
                                               Read(st)),
                            writes=(po,), rings=(st, phi, gn, po)))
        nxt = (f"st{s + 1}", f"phi{s + 1}") if s < steps - 1 else ()
        for a in nxt:
            arrays[a] = (ns if a.startswith("st") else 1, itemsize)
        stages.append(Stage(STREAM, s, reads=(Read(po, 1, 1, 1),),
                            writes=nxt, rings=(po, *nxt) if nxt
                            else (po, "", "")))
    return build_plan("cg", stages, arrays, shape, steps, slabs_per_wave,
                      band_rows)


# -- the plain model of the march ---------------------------------------------

class _Rings:
    """The rings of a plan as CPU tensors (planes, depth, rows, nx), full of
    NaN (bytes: 255) until written; writes of a wave are kept aside and
    applied after it, so a stage sees only what earlier waves wrote."""

    def __init__(self, plan: Plan, dtype):
        self.plan = plan
        self.t = {}
        for r in plan.rings:
            if r.itemsize == 1:
                self.t[r.name] = torch.full((r.planes, r.depth, plan.rows,
                                             plan.nx), 255, dtype=torch.uint8)
            else:
                self.t[r.name] = torch.full((r.planes, r.depth, plan.rows,
                                             plan.nx), float("nan"),
                                            dtype=dtype)
        self.pending = []

    def slot(self, name, u):
        return u % self.t[name].shape[1]

    def get(self, name, u, lr, dz=0, dy=0):
        """Array `name` at unwrapped slab u + dz, ring rows lr + dy (wrapped
        in the ring): (planes, len(lr), nx)."""
        t = self.t[name]
        return t[:, self.slot(name, u + dz)][:, (lr + dy) % self.plan.rows]

    def block(self, name, u, lr):
        """Slabs u - 1 ... u + 1 and rows lr - 1 ... lr + 1 of `name`:
        (planes, 3, len(lr) + 2, nx), for the plain stencils, whose
        periodic shifts are then exact on the centre."""
        rows = torch.cat([lr[:1] - 1, lr, lr[-1:] + 1])
        return torch.stack([self.get(name, u, rows, dz) for dz in (-1, 0, 1)],
                           dim=1)

    def put(self, name, u, lr, value, planes=None):
        self.pending.append((name, self.slot(name, u), lr, value, planes))

    def flush(self):
        for name, slot, lr, value, planes in self.pending:
            t = self.t[name]
            p = slice(None) if planes is None else planes
            t[p, slot, lr % self.plan.rows] = value.to(t.dtype)
        self.pending = []


def _run(plan: Plan, rings: _Rings, body):
    """Every band, every wave, every entry in the kernel's order:
    body(stage, u, lr, gy) with lr the stage's ring rows and gy their
    domain rows; a wave's writes land after the wave."""
    for band in range(plan.bands):
        y0 = band * plan.band_rows
        for wave in plan.waves:
            for k, u in wave:
                st = plan.stages[k]
                if plan.bands == 1:
                    lr = torch.arange(plan.ny)
                else:
                    lr = torch.arange(plan.halo - st.e,
                                      plan.halo + plan.band_rows + st.e)
                gy = (y0 - plan.halo + lr) % plan.ny if plan.bands > 1 \
                    else lr
                body(st, u, lr, gy)
            rings.flush()


def _centre(x):
    """The centre slab and rows of a (..., 3, rows + 2, nx) block, with a z
    axis of one kept."""
    return x[..., 1:2, 1:-1, :]


def _pulled(po, fluid, u, gy):
    """Pull streaming with half-way bounce-back of a block of post-collision
    values po (..., 19, 3, R + 2, nx) around unwrapped slab u and domain
    rows gy, on the bool mask `fluid`: the streamed values of the centre,
    (..., 19, 1, R, nx)."""
    nz, ny = fluid.shape[:2]
    rows = torch.cat([gy[:1] - 1, gy, gy[-1:] + 1]) % ny
    sol = torch.stack([~fluid[(u + dz) % nz][rows] for dz in (-1, 0, 1)])
    outs = [po[..., 0, :, :, :]]
    for i in range(1, Q):
        e = [int(c) for c in D3Q19.e[i]]
        pulled = torch.roll(po[..., i, :, :, :], (e[2], e[1], e[0]),
                            (-3, -2, -1))
        up_solid = torch.roll(sol, (e[2], e[1], e[0]), (-3, -2, -1))
        outs.append(torch.where(up_solid, po[..., int(D3Q19.opp[i]), :, :, :],
                                pulled))
    return _centre(torch.stack(outs, dim=-4))


def single3d_march_reference(f: torch.Tensor, model, steps: int,
                             plan: Plan | None = None) -> torch.Tensor:
    """`steps` steps of K11-T's march on the CPU for `model`, a
    SinglePhaseD3Q19 (SRT or TRT): the plan's stages, wave by wave and slab
    by slab, from rings of its depth, each stage through the plain step's
    operators (``SinglePhaseD3Q19.collide``, then pull streaming with
    half-way bounce-back).  A bf16 state is decoded once and encoded once,
    as the kernel does."""
    bf16 = f.dtype == torch.bfloat16
    x0 = model.unpack_bf16(f) if bf16 else f
    nz, ny, nx = x0.shape[-3:]
    if plan is None:
        plan = single3d_march_plan((nz, ny, nx), steps, x0.element_size())
    rings = _Rings(plan, x0.dtype)
    out = torch.full_like(x0, float("nan"))
    fluid = model.fluid_mask > 0

    def body(st, u, lr, gy):
        gz = u % nz
        fl_own = fluid[gz][gy][None]                      # (1, R, nx)
        s = st.level
        if st.kind == COLLIDE:
            v = x0[:, gz][:, gy][:, None]                 # (19, 1, R, nx)
        else:
            prev = s if st.kind == STREAM else s - 1
            v = _pulled(rings.block(f"post{prev}", u, lr), fluid, u, gy)
            v = torch.where(fl_own, v, 0.0)
            if st.kind == STREAM:   # its rows are the band's own (e = 0)
                out[:, gz, gy] = v[:, 0]
                return
        post = torch.where(fl_own, model.collide(v), 0.0)
        rings.put(f"post{s}", u, lr, post[:, 0])

    _run(plan, rings, body)
    return model.pack_state_bf16(out) if bf16 else out


def sc3d_march_reference(f: torch.Tensor, model, steps: int,
                         plan: Plan | None = None) -> torch.Tensor:
    """`steps` steps of K10-T's march on the CPU for `model`, a
    ShanChenMCMP3D with K <= 3 fluids: the plan's stages, wave by wave and
    slab by slab, from rings of its depth, each stage through the plain
    step's operators (``ShanChenMCMP3D._step_impl``: the density, the
    interaction force with the adhesion field, the common velocity and the
    SRT collision; then pull streaming with half-way bounce-back).  A bf16
    state is decoded once and encoded once, as the kernel does."""
    bf16 = f.dtype == torch.bfloat16
    x0 = model.unpack_bf16(f) if bf16 else f
    k = x0.shape[0]
    nz, ny, nx = x0.shape[-3:]
    if plan is None:
        plan = sc3d_march_plan((nz, ny, nx), k, steps, x0.element_size())
    rings = _Rings(plan, x0.dtype)
    out = torch.full_like(x0, float("nan"))
    lat = D3Q19
    fluid = model.fluid_mask > 0
    adh = model.adhesion
    gm = model.g_matrix
    gs = torch.as_tensor(model.g_solid, dtype=x0.dtype).reshape(-1, 1, 1, 1)
    tau_k = model.tau_k

    def body(st, u, lr, gy):
        gz = u % nz
        fl_own = fluid[gz][gy][None]                      # (1, R, nx)
        if st.kind == LOAD:
            fs = x0[:, :, gz][:, :, gy][:, :, None]       # (K, 19, 1, R, nx)
            rho = torch.where(fl_own, mac.density(fs, 3), 0.0)
            rings.put("rho0", u, lr, rho[:, 0])
            rings.put("fl0", u, lr, fl_own.to(torch.uint8))
        elif st.kind == COLLIDE:
            s = st.level
            fs = (rings.get(f"F{s}", u, lr) if s else
                  x0[:, :, gz][:, :, gy]).reshape(k, Q, 1, len(lr), nx)
            rho_b = rings.block(f"rho{s}", u, lr)         # (K, 3, R+2, nx)
            rho = _centre(rho_b)
            fl = rings.get(f"fl{s}", u, lr)[:, None] > 0  # (1, 1, R, nx)
            grads = [torch.zeros_like(rho_b) for _ in range(3)]
            for i in range(1, Q):
                w = float(lat.w[i])
                sh = shift(rho_b, *(int(c) for c in lat.e[i]))
                for d in range(3):
                    ed = int(lat.e[i, d])
                    if ed:
                        grads[d] = grads[d] + (w * ed) * sh
            grads = [_centre(g) for g in grads]
            a = adh[:, gz][:, gy][:, None]
            rho_safe = torch.where(rho > 0, rho, torch.ones_like(rho))
            up = mac.sc_common_velocity(lat, fs, rho, model.tau)
            ueq = []
            for d in range(3):
                gv = torch.stack([sum((float(gm[i, j]) * grads[d][j]
                                       for j in range(1, k)),
                                      float(gm[i, 0]) * grads[d][0])
                                  for i in range(k)])
                force = -rho * (gv + gs * a[d]) + \
                    float(model.p.body_force[d]) * rho
                ueq.append(up[d][None] + tau_k * force / rho_safe)
            feq = eq.feq_quadratic(lat, rho, ueq)
            post = fs - (fs - feq) / tau_k[:, None]
            post = torch.where(fl, post, 0.0)
            rings.put(f"post{s}", u, lr, post.reshape(k * Q, len(lr), nx))
        elif st.kind == STREAM:
            s = st.level
            po = rings.block(f"post{s}", u, lr).reshape(k, Q, 3, len(lr) + 2,
                                                        nx)
            o = _pulled(po, fluid, u, gy)                # (K, 19, 1, R, nx)
            o = torch.where(fl_own, o, 0.0)
            if s == steps - 1:    # its rows are the band's own (e = 0)
                out[:, :, gz, gy] = o[:, :, 0]
            else:
                rho = torch.where(fl_own, mac.density(o, 3), 0.0)
                rings.put(f"F{s + 1}", u, lr, o.reshape(k * Q, len(lr), nx))
                rings.put(f"rho{s + 1}", u, lr, rho[:, 0])
                rings.put(f"fl{s + 1}", u, lr, fl_own.to(torch.uint8))
        else:
            raise ValueError(f"K10-T has no stage {st.kind}")

    _run(plan, rings, body)
    return model.pack_state_bf16(out) if bf16 else out


_EZ = {sign: [i for i in range(Q) if int(D3Q19.e[i, 2]) == sign]
       for sign in (-1, 0, 1)}


def _feq_vz(rho, vz):
    return [float(D3Q19.w[i]) * rho * (1.0 + 3.0 * float(D3Q19.e[i, 2]) * vz
                                       + 4.5 * (float(D3Q19.e[i, 2]) * vz)
                                       ** 2 - 1.5 * vz * vz)
            for i in range(Q)]


def _nebb_cell(ft, inlet: bool, vz_in: float, rho_out: float):
    """NEBB values {i: ...} of the unknown directions of a slab's total PDF
    (a list over Q): the inlet at u = (0, 0, vz_in), the outlet at density
    rho_out (models/flow3d.py's ``_nebb``, ``_inlet_rho``,
    ``_outlet_vz``)."""
    s0 = sum(ft[i] for i in _EZ[0])
    if inlet:
        vz = vz_in
        rho = (s0 + 2.0 * sum(ft[i] for i in _EZ[1])) / (1.0 + vz)
        unknown = _EZ[-1]
    else:
        rho = rho_out
        vz = 1.0 - (s0 + 2.0 * sum(ft[i] for i in _EZ[-1])) / rho_out
        unknown = _EZ[1]
    feq = _feq_vz(rho, vz)
    opp = D3Q19.opp
    return {i: feq[i] + (ft[int(opp[i])] - feq[int(opp[i])])
            for i in unknown}


def _safe(x):
    return torch.where(x != 0, x, torch.ones_like(x))




def _rows_around(gy, ny):
    """Domain rows gy - 1 ... gy + 1 of a run of rows (for a stencil
    block)."""
    return torch.cat([gy[:1] - 1, gy, gy[-1:] + 1]) % ny


def cg3d_march_reference(state, model, steps: int, plan: Plan | None = None):
    """`steps` steps of K9-T's march on the CPU for `model`, a
    ColorGradientRK3D: the compressed state (20 planes, or the 21-plane
    bf16 state, decoded once and encoded once) or the split pair (f_r,
    f_b).  The plan's stages run wave by wave and slab by slab from rings of
    its depth, each through the plain path's operators
    (``ColorGradientRK3D``: the boundary slabs of ``_bc_slabs_c`` /
    ``_apply_inlet``, ``_apply_outlet``; phi, its extrapolation, the
    gradient, the Akai rotation, the CSF force and the collision; the
    recolouring terms (frac and the segregation amplitudes A, B, Cz) ride
    with the post-collision PDF to the stream stage, which forms each
    streamed population's red part at its source cell)."""
    split = not torch.is_tensor(state)
    bf16 = not split and state.dtype == torch.bfloat16
    if split:
        x0 = torch.cat(tuple(state))
    else:
        x0 = model.unpack_bf16(state) if bf16 else state
    nz, ny, nx = x0.shape[-3:]
    bcs = model.bcs
    inlet = int(bcs.inlet == "velocity")
    outlet = {"periodic": 0, "convective": 1, "dirichlet": 2}[bcs.outlet]
    if plan is None:
        plan = cg3d_march_plan((nz, ny, nx), steps, x0.element_size(), split,
                               inlet, outlet, bool(model.has_wetting))
    rings = _Rings(plan, x0.dtype)
    out = torch.full_like(x0, float("nan"))
    lat = D3Q19
    p = model.p
    fluid = model.is_fluid
    w = torch.as_tensor(np.asarray(lat.w), dtype=x0.dtype)
    e = torch.as_tensor(np.asarray(lat.e), dtype=x0.dtype)

    def totals(cells):
        """(f_total, rho_r, rho_b) of state planes (ns, 1, R, nx)."""
        if split:
            return (cells[:Q] + cells[Q:], mac.density(cells[:Q], 3),
                    mac.density(cells[Q:], 3))
        ft = cells[:Q]
        return ft, cells[Q], mac.density(ft, 3) - cells[Q]

    def rewrite(cells, m, is_inlet):
        """The NEBB rewrite of a slab's cells (ns, 1, R, nx) where m."""
        ft = cells[:Q] + cells[Q:] if split else cells[:Q]
        new = _nebb_cell(ft, is_inlet, bcs.inlet_velocity, bcs.outlet_density)
        c = cells.clone()
        if split:
            ratio = mac.ordered_sum(cells[:Q], 0) / _safe(
                mac.ordered_sum(ft, 0))
            for i, val in new.items():
                c[i] = torch.where(m, ratio * val, c[i])
                c[Q + i] = torch.where(m, (1.0 - ratio) * val, c[Q + i])
            return c
        rr = cells[Q]
        ratio = rr / _safe(mac.ordered_sum(ft, 0))
        dsum = 0.0
        for i, val in new.items():
            dsum = dsum + (val - ft[i])
            c[i] = torch.where(m, val, ft[i])
        c[Q] = torch.where(m, rr + ratio * dsum, rr)
        return c

    def fluid_block(u, gy):
        rows = _rows_around(gy, ny)
        return torch.stack([fluid[(u + dz) % nz][rows] for dz in (-1, 0, 1)])

    def phase(cells, m):
        """phi of state planes (ns, 1, R, nx) where m, 0 elsewhere."""
        _, rr, rb = totals(cells)
        return cg.phase_field(rr, rb) * m

    def body(st, u, lr, gy):
        gz = u % nz
        s = st.level
        fl_own = fluid[gz][gy][None]                     # (1, R, nx)
        if st.kind == LOAD:
            cells = x0[:, gz][:, gy]
            rings.put("st0", u, lr, cells)
            rings.put("phi0", u, lr, phase(cells[:, None], fl_own))
        elif st.kind == BC:
            name, pname = f"st{s}", f"phi{s}"

            def cells(dz):
                return rings.get(name, u, lr, dz)[:, None]

            def m(dz):
                return fluid[(u + dz) % nz][gy][None]

            def put(dz, new):
                """Slab u + dz's state and phi (the trigger rewrites only
                fluid cells, so phi of the others stays)."""
                rings.put(name, u + dz, lr, new[:, 0])
                rings.put(pname, u + dz, lr, phase(new, m(dz)))
            if inlet and gz == nz - 2:
                new = rewrite(cells(0), m(0), True)
                put(0, new)
                put(1, torch.where(m(1), new, cells(1)))
            if outlet == 1 and gz == 0:
                v = cells(3)
                for dz in (2, 1, 0):
                    v = torch.where(m(dz), v, cells(dz))
                    put(dz, v)
            elif outlet == 2 and gz == 0:
                new = rewrite(cells(1), m(1), False)
                put(1, new)
                put(0, torch.where(m(0), new, cells(0)))
        elif st.kind == EXTRAP:
            phi_b = rings.block(f"phi{s}", u, lr)[0]
            ext = cg.solid_phi_extrapolate(phi_b, fluid_block(u, gy), lat)
            rings.put(f"phi{s}", u, lr, _centre(ext))
        elif st.kind == NORMAL:
            phi_b = rings.block(f"phi{s}", u, lr)[0]
            g = tuple(_centre(c) for c in cg.color_gradient(phi_b, lat))
            if model.has_wetting:
                g = cg.rotate_gradient_on_wetting_akai_nd(
                    g, tuple(c[gz][gy][None] for c in model.ns), model.cos_t,
                    model.sin_t, model.wet_fluid[gz][gy][None])
            norm = torch.sqrt(sum(c * c for c in g))
            ok = norm > 1e-8
            nv = [torch.where(ok, -c / _safe(norm), 0.0) * fl_own for c in g]
            rings.put(f"gn{s}", u, lr, torch.cat([*g, *nv]))
        elif st.kind == COLLIDE:
            gn_b = rings.block(f"gn{s}", u, lr)
            force, _ = cg.csf_force_nd(tuple(gn_b[:3]), p.surface_tension,
                                       fluid_block(u, gy), inward_normal=True,
                                       lat=lat)
            g = tuple(_centre(c) for c in gn_b[:3])
            force = [_centre(c) for c in force]
            ft, rr, rb = totals(rings.get(f"st{s}", u, lr)[:, None])
            rho = rr + rb
            if any(p.body_force):
                force = [force[d] + float(p.body_force[d]) * rho
                         for d in range(3)]
            force = tuple(c * fl_own for c in force)
            phi = rings.get(f"phi{s}", u, lr)
            post, _ = model._collide(ft, rr, rb, phi, g, force)
            # the red part of each post-collision population: frac post_i
            # + w_i e_i . (A, B, Cz), (A, B, Cz) the segregation amplitudes
            frac = rr / _safe(rho)
            segc = p.beta * rr * rb / _safe(rho)
            norm = torch.sqrt(sum(c * c for c in g))
            ok = norm > 1e-8
            amp = [torch.where(ok, segc * c / _safe(norm), 0.0) for c in g]
            red = frac * post + (w[:, None, None, None] * (
                e[:, 0, None, None, None] * amp[0] +
                e[:, 1, None, None, None] * amp[1] +
                e[:, 2, None, None, None] * amp[2]))
            rings.put(f"po{s}", u, lr,
                      torch.where(fl_own, torch.cat([post, red]), 0.0)[:, 0])
        elif st.kind == STREAM:
            po = rings.block(f"po{s}", u, lr)           # (38, 3, R+2, nx)
            sol = ~fluid_block(u, gy)
            o, red = [], []
            for i in range(Q):
                ev = [int(c) for c in lat.e[i]]
                src = torch.roll(po, (ev[2], ev[1], ev[0]), (-3, -2, -1))
                up_solid = torch.roll(sol, (ev[2], ev[1], ev[0]),
                                      (-3, -2, -1))
                j = int(lat.opp[i])
                o.append(_centre(torch.where(up_solid, po[j], src[i]))[0])
                red.append(_centre(torch.where(up_solid, po[Q + j],
                                               src[Q + i]))[0])
            o = torch.where(fl_own, torch.stack(o), 0.0)
            red = torch.where(fl_own, torch.stack(red), 0.0)
            if split:
                new = torch.cat([red, o - red])
            else:
                new = torch.cat([o, mac.ordered_sum(red, 0)[None]])
            if s == steps - 1:    # its rows are the band's own (e = 0)
                out[:, gz, gy] = new
            else:
                rings.put(f"st{s + 1}", u, lr, new)
                rings.put(f"phi{s + 1}", u, lr,
                          phase(new[:, None], fl_own))
        else:
            raise ValueError(f"K9-T has no stage {st.kind}")

    _run(plan, rings, body)
    if split:
        return out[:Q], out[Q:]
    return model.pack_compressed_bf16(out) if bf16 else out


# -- launching a march kernel ---------------------------------------------------

_plans: dict = {}
_fns: dict = {}
# the library family whose error-string entry point a march library shares
_ERROR_PREFIX = {"single3d": "flow3d", "sc3d": "flow3d", "cg3d": "cg3d",
                 "csf2d": "csf2d", "coupled2d": "coupled2d", "sc2d": "sc2d"}


def device_plan(key, make, device):
    """(plan, its int64 table on `device`) for `key`, built by `make()` once
    a process."""
    k = (key, str(device))
    if k not in _plans:
        plan = make()
        _plans[k] = (plan, plan.tensor().to(device))
    return _plans[k]


def _march_fns(lib: str, prefix: str, ints: int, pointers: int,
               params_type=None):
    """(step, grid, error string) of a march library: the step takes `ints`
    ints, `pointers` tensors' pointers, the scratch and the plan, a
    `params_type` block and the stream."""
    import ctypes
    if (lib, prefix) not in _fns:   # K11-T and K10-T share a library
        so = build.load_library(lib)
        step = getattr(so, f"{prefix}_march_step")
        step.argtypes = [ctypes.c_int] * ints + \
            [ctypes.c_void_p] * (pointers + 2) + \
            [ctypes.POINTER(params_type), ctypes.c_void_p]
        step.restype = ctypes.c_int
        grid = getattr(so, f"{prefix}_march_grid")
        grid.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        grid.restype = ctypes.c_int
        err = getattr(so, f"{_ERROR_PREFIX[prefix]}_block_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fns[(lib, prefix)] = (step, grid, err)
    return _fns[(lib, prefix)]


def march_grid(lib: str, prefix: str, ints: int, pointers: int,
               params_type, which: int) -> int:
    """The cooperative grid (blocks) of a march library's kernel instance
    `which` (K11-T: the collision; K10-T: the fluids; K9-T: split; K3: the
    state mode; K5c-T: 10 state mode + NQ; K8-T: 100 K + order)."""
    import ctypes
    step, grid, err = _march_fns(lib, prefix, ints, pointers, params_type)
    out = ctypes.c_int(0)
    code = grid(which, ctypes.byref(out))
    if code != 0:
        raise RuntimeError(f"{prefix}_march_grid: {err(code).decode()} "
                           f"({code})")
    return int(out.value)


def march_launch(lib: str, prefix: str, ints, tensors, plan: Plan,
                 table: torch.Tensor, params) -> None:
    """One cooperative launch of a march library's step on the current
    stream of the first tensor's card: the `ints`, the `tensors`' pointers
    (None is a null pointer), a scratch buffer of the plan's ring bytes
    (``torch.empty``), the plan's table and the parameter block.  A failed
    launch raises."""
    import ctypes
    step, _, err = _march_fns(lib, prefix, len(ints), len(tensors),
                              type(params))
    dev = next(t for t in tensors if t is not None).device
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=dev)
    ptrs = [0 if t is None else t.data_ptr() for t in tensors]
    with torch.cuda.device(dev):
        code = step(*ints, *ptrs, scratch.data_ptr(), table.data_ptr(),
                    ctypes.byref(params),
                    torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{lib} march launch failed: {err(code).decode()} "
                           f"({code})")
