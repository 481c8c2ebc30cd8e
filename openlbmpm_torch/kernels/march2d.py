"""The row-march of the 2-D T-step kernels K3 (K3c, K3h, K3s, both
variants of the colour-gradient step), K5c-T (the coupled CSF flow + tracer
step) and K8-T (the Shan-Chen step): their plans, which the wrappers hand
to the kernels, and a plain PyTorch model that executes a plan wave by
wave.

The 2-D domain is the z-march's (``kernels/march3d.py``) with the rows in
the place of the slabs: ``build_plan`` schedules the stages on an (ny, 1, nx)
grid, so a "slab" is a row of nx cells, Z rows make a wave, rows wrap in x
inside a ring row, and the periodic y seam is recomputed by unwrapped rows
below 0 and above ny - 1.  The executor is ``csrc/march3d.cuh``'s; the
bodies are in ``csrc/march2d.cuh`` (K3, K5c-T) and ``csrc/sc2d_march.cuh``
(K8-T).

CSF level s (the state after s steps: st_s, 10 compressed or 18 split
planes):
  bc       with an inlet or outlet, at the trigger rows ny - 2 and 0 only:
           one thread a column rewrites st_s in place in the reference's
           order (inlet row ny - 2 and its ghost ny - 1; the Dirichlet
           outlet row 1 and its ghost 0, or the convective rows 2, 1, 0);
  phi      phi of st_s with the Dirichlet-outlet repair (fluid cells of rows
           0 and 1 take row 2's phi) and, with wetting walls, phi on solid
           cells from the fluid neighbours' -> phi_s;
  normal   phi_s one row and column around -> the wetted gradient and the
           unit normal: gn_s (4 planes);
  collide  gn_s around (the curvature), st_s and phi_s at the cell -> po_s:
           the post-collision PDF and the recolouring factors frac, A, B (12
           planes);
  stream   po_s around: pull streaming with half-way bounce-back, the red
           part of each streamed population, frac o + w_j e_j . (A, B), from
           its source cell -> st_{s+1}, or at the last level the output.
Level 0's st comes from a load stage that decodes the input.

Perturbation level s (``pert2d_stages``; bc and stream as CSF's):
  phi      d = rho_r - rho_b of st_s (solid_phi on solid cells) and phi with
           the Dirichlet-outlet repair -> dp_s (2 planes);
  collide  dp_s around (the gradient of d), st_s and phi at the cell -> po_s:
           the post-collision PDF and its red part (18 planes);
  stream   po_s around: pull streaming with half-way bounce-back of both ->
           st_{s+1}, or at the last level the output.

K5c-T level s runs before the flow's stages the tracer's, on the flow
state as it stands before the level's boundary rows (TransportRK's order):
phi and normal again on that state (phiA_s, gnA_s), then
  tcollide the tracers' collision, partition and reaction at the cell (u
           with the CSF force of gnA_s around) -> gp_s (NT NQ planes and the
           transport-domain plane);
  tstream  gp_s three rows below to five above: the free-flow outlet rows,
           streaming, the interface bounce-back and the inlet rows -> g_{s+1},
           or at the last level the output.
The boundary stage rewrites st_s in place after the tracer's stages have
read it (``build_plan``'s rule for in-place writers).  Level 0's tracers
come from the input, read at the cell by tcollide.

K8-T level s (``sc2d_stages``; st_s the K x 9 populations, psi_s (K
planes) psi_k of st_s, 0 on solid cells, written by the stage that writes
the state; d the stencil's reach R, which is also the depth of the
boundary rows; level 0's st and psi come from the load stage):
  bc       with an inlet, at the trigger row ny - 1 - d only: the Zou-He
           inlet row and its d ghost rows above, in place in st_s and
           psi_s;
  collide  psi_s R rows around (and R columns: x wraps inside the ring
           row), st_s at the cell -> po_s (K x 9 planes);
  stream   po_s one row around: pull streaming with half-way bounce-back
           -> st_{s+1} and psi_{s+1}, or at the last level without an
           outlet the output;
  outlet   with an outlet, at the trigger row 0 only: the Zou-He row d and
           its ghosts below (reading row d), or the convective rows d + 1
           ... 0 each copying the row above (reading row d + 2), in place in
           st_{s+1} and psi_{s+1} (the streamed state: the outlet rows
           follow the streaming);
  store    with an outlet, after the last level's outlet: st_T into the
           output (a bf16 output is encoded after the outlet rows).

``csf2d_march_plan``, ``pert2d_march_plan``, ``coupled2d_march_plan`` and
``sc2d_march_plan`` build a plan; ``csf2d_march_reference``,
``pert2d_march_reference``, ``coupled2d_march_reference`` and
``sc2d_march_reference`` execute one on
the CPU from rings of its depth (full of NaN until a stage writes them),
each wave's stages seeing only what earlier waves wrote: every stage
places the rows it declares it reads into an otherwise NaN domain and runs
the plain path's operators there, so a read the plan does not cover turns
into NaN.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import colorgrad as cg
from ..ops import equilibrium as eq
from ..ops import macroscopic as mac
from ..ops import shanchen as sc
from ..ops import transport as tr
from ..ops.common import pull, shift
from ..ops.forcing import efs_force_pdf
from ..ops.streaming import stream
from . import build
from . import march3d as m3
from .march3d import BC, COLLIDE, LOAD, NORMAL, STREAM, Read, Stage

__all__ = ["PHI", "TCOLLIDE", "TSTREAM", "OUTLET", "STORE", "ROWS_PER_WAVE",
           "SC_ROWS_PER_WAVE", "GN_PLANES", "PO_PLANES", "DP_PLANES",
           "PERT_PO_PLANES", "csf2d_stages", "csf2d_march_plan",
           "pert2d_stages", "pert2d_march_plan", "pert2d_march_reference",
           "coupled2d_stages", "coupled2d_march_plan", "max_steps",
           "csf2d_march_reference", "coupled2d_march_reference",
           "sc_reach", "sc_codes", "sc2d_stages", "sc2d_march_plan",
           "sc2d_march_reference"]

# stage kinds of the 2-D march beyond march3d's (csrc/march2d.cuh,
# csrc/sc2d_march.cuh)
PHI, TCOLLIDE, TSTREAM = 6, 7, 8
OUTLET, STORE = 10, 11
# rows a wave (Z): 96 was the fastest of 8-128 for K3c, K3h and K5c-Tc at
# 1024^2 on an H100; for K8-T 384 (64-256 slower, 512-1024 within 1%;
# chip_sweep.py k8t, PERF.md)
ROWS_PER_WAVE = 96
SC_ROWS_PER_WAVE = 384
GN_PLANES = 4      # gx, gy, the unit normal
PO_PLANES = 12     # post (9), frac, A, B
DP_PLANES = 2      # Perturbation: d = rho_r - rho_b, phi
PERT_PO_PLANES = 18   # Perturbation: post (9), its red part (9)
# the tracer stream's reach in rows of gp: its interface repair and
# anti-bounce-back inlet read three rows below, the free-flow outlet's row
# copies from the row two above up to row 3
TSTREAM_LO, TSTREAM_HI = 3, 5


def _bc_reach(inlet: int, outlet: int):
    """(rows above a trigger the boundary stage reads, rows above it it
    rewrites) for the inlet (0 periodic) and outlet (0 periodic, 1
    convective, 2 Dirichlet)."""
    bhi = max(3 if outlet == 1 else 0, 1 if outlet == 2 else 0,
              1 if inlet else 0)
    tlo = max(2 if outlet == 1 else 0, 1 if outlet == 2 else 0,
              1 if inlet else 0)
    return bhi, tlo


def _phi_reach(wetting: bool, repair: bool):
    """Rows below and above the cell that phi reads of the state: the
    solid cells' extrapolation reads the neighbours, the repair row 2 from
    rows 0 and 1."""
    zlo = 1 if wetting else 0
    zhi = max(1 if wetting else 0, (3 if wetting else 2) if repair else 0)
    return zlo, zhi


def _flow_level(stages, arrays, s, steps, ny, itemsize, ns, inlet, outlet,
                wetting, repair):
    """The CSF stages of level s (st_s written before)."""
    st, phi, gn, po = f"st{s}", f"phi{s}", f"gn{s}", f"po{s}"
    arrays[phi] = (1, itemsize)
    arrays[gn] = (GN_PLANES, itemsize)
    arrays[po] = (PO_PLANES, itemsize)
    if inlet or outlet:
        bhi, tlo = _bc_reach(inlet, outlet)
        triggers = ((ny - 2,) if inlet else ()) + ((0,) if outlet else ())
        stages.append(Stage(BC, s, reads=(Read(st, 0, bhi),),
                            modifies=(st,), back=tlo, rings=(st,),
                            slabs=triggers))
    zlo, zhi = _phi_reach(wetting, repair)
    stages.append(Stage(PHI, s, reads=(Read(st, zlo, zhi),), writes=(phi,),
                        rings=(st, phi)))
    stages.append(Stage(NORMAL, s, reads=(Read(phi, 1, 1),), writes=(gn,),
                        rings=(phi, gn)))
    stages.append(Stage(COLLIDE, s, reads=(Read(gn, 1, 1), Read(phi),
                                           Read(st)),
                        writes=(po,), rings=(st, phi, gn, po)))
    last = s == steps - 1
    nxt = () if last else (f"st{s + 1}",)
    if nxt:
        arrays[nxt[0]] = (ns, itemsize)
    stages.append(Stage(STREAM, s, reads=(Read(po, 1, 1),), writes=nxt,
                        rings=(po, *nxt) if nxt else (po, ""),
                        output=last))


def csf2d_stages(ny: int, steps: int, itemsize: int, split: bool,
                 inlet: int, outlet: int, wetting: bool, repair: bool):
    """(stages, arrays) of K3's CSF march: a load stage, then each level's
    (module docstring)."""
    build.check_steps(steps)
    ns = 18 if split else 10
    arrays = {"st0": (ns, itemsize)}
    stages = [Stage(LOAD, 0, writes=("st0",), rings=("st0",))]
    for s in range(steps):
        _flow_level(stages, arrays, s, steps, ny, itemsize, ns, inlet, outlet,
                    wetting, repair)
    return stages, arrays


def _pert_level(stages, arrays, s, steps, ny, itemsize, ns, inlet, outlet,
                repair):
    """The Perturbation stages of level s (st_s written before)."""
    st, dp, po = f"st{s}", f"dp{s}", f"po{s}"
    arrays[dp] = (DP_PLANES, itemsize)
    arrays[po] = (PERT_PO_PLANES, itemsize)
    if inlet or outlet:
        bhi, tlo = _bc_reach(inlet, outlet)
        triggers = ((ny - 2,) if inlet else ()) + ((0,) if outlet else ())
        stages.append(Stage(BC, s, reads=(Read(st, 0, bhi),),
                            modifies=(st,), back=tlo, rings=(st,),
                            slabs=triggers))
    stages.append(Stage(PHI, s, reads=(Read(st, 0, 2 if repair else 0),),
                        writes=(dp,), rings=(st, dp)))
    stages.append(Stage(COLLIDE, s, reads=(Read(dp, 1, 1), Read(st)),
                        writes=(po,), rings=(st, dp, po)))
    last = s == steps - 1
    nxt = () if last else (f"st{s + 1}",)
    if nxt:
        arrays[nxt[0]] = (ns, itemsize)
    stages.append(Stage(STREAM, s, reads=(Read(po, 1, 1),), writes=nxt,
                        rings=(po, *nxt) if nxt else (po, ""),
                        output=last))


def pert2d_stages(ny: int, steps: int, itemsize: int, split: bool,
                  inlet: int, outlet: int, repair: bool):
    """(stages, arrays) of K3's Perturbation march: a load stage, then each
    level's (module docstring)."""
    build.check_steps(steps)
    ns = 18 if split else 10
    arrays = {"st0": (ns, itemsize)}
    stages = [Stage(LOAD, 0, writes=("st0",), rings=("st0",))]
    for s in range(steps):
        _pert_level(stages, arrays, s, steps, ny, itemsize, ns, inlet, outlet,
                    repair)
    return stages, arrays


def coupled2d_stages(ny: int, steps: int, itemsize: int, split: bool,
                     inlet: int, outlet: int, wetting: bool, repair: bool,
                     tracers: int):
    """(stages, arrays) of K5c-T's march for `tracers` = NT NQ tracer
    slots: a load stage, then each level's tracer stages on the state before
    its boundary rows and its flow stages (module docstring)."""
    build.check_steps(steps)
    ns = 18 if split else 10
    arrays = {"st0": (ns, itemsize)}
    stages = [Stage(LOAD, 0, writes=("st0",), rings=("st0",))]
    zlo, zhi = _phi_reach(wetting, repair)
    for s in range(steps):
        st, pa, ga, gp = f"st{s}", f"phiA{s}", f"gnA{s}", f"gp{s}"
        gs = f"g{s}" if s else ""
        arrays[pa] = (1, itemsize)
        arrays[ga] = (GN_PLANES, itemsize)
        arrays[gp] = (tracers + 1, itemsize)
        stages.append(Stage(PHI, s, reads=(Read(st, zlo, zhi),),
                            writes=(pa,), rings=(st, pa)))
        stages.append(Stage(NORMAL, s, reads=(Read(pa, 1, 1),), writes=(ga,),
                            rings=(pa, ga)))
        stages.append(Stage(TCOLLIDE, s, reads=(Read(ga, 1, 1), Read(st)) +
                            ((Read(gs),) if gs else ()), writes=(gp,),
                            rings=(st, ga, gs, gp)))
        last = s == steps - 1
        gn = () if last else (f"g{s + 1}",)
        if gn:
            arrays[gn[0]] = (tracers, itemsize)
        stages.append(Stage(TSTREAM, s, reads=(Read(gp, TSTREAM_LO,
                                                     TSTREAM_HI),),
                            writes=gn, rings=(gp, *gn) if gn else (gp, ""),
                            output=last))
        _flow_level(stages, arrays, s, steps, ny, itemsize, ns, inlet, outlet,
                    wetting, repair)
    return stages, arrays


def sc_reach(order: int) -> int:
    """The Shan-Chen interaction stencil's reach R, which is also the depth
    d of the boundary rows: 1 for the original SC (order 0) and EFS iso-4,
    2 for iso-8, 3 for iso-10."""
    return {0: 1, 4: 1, 8: 2, 10: 3}[order]


def sc2d_stages(ny: int, steps: int, itemsize: int, fluids: int, order: int,
                inlet: int, outlet: int):
    """(stages, arrays) of K8-T's march for `fluids` fluids and the stencil
    `order` (0 original SC, 4 | 8 | 10 EFS): a load stage, then each
    level's (module docstring); `inlet` 0 periodic or a Zou-He inlet,
    `outlet` 0 periodic, 1 Zou-He pressure, 2 convective (ScParams'
    codes).  The stages that write a level's state write its psi too (the
    load and the stream stage, and the boundary stages the rows they
    rewrite), so no stage forms psi on its own."""
    build.check_steps(steps)
    d = sc_reach(order)
    k, ns = int(fluids), 9 * int(fluids)
    arrays = {"st0": (ns, itemsize), "psi0": (k, itemsize)}
    stages = [Stage(LOAD, 0, writes=("st0", "psi0"), rings=("st0", "psi0"))]
    # the outlet stage reads row d (Zou-He) or d + 2 (convective) above its
    # trigger and rewrites rows 0 ... d or 0 ... d + 1
    ohi, oback = (d, d) if outlet == 1 else (d + 2, d + 1)
    for s in range(steps):
        st, psi, po = f"st{s}", f"psi{s}", f"po{s}"
        arrays[po] = (ns, itemsize)
        if inlet:
            stages.append(Stage(BC, s, reads=(Read(st, 0, d),),
                                modifies=(st, psi), back=d, rings=(st, psi),
                                slabs=(ny - 1 - d,)))
        stages.append(Stage(COLLIDE, s, reads=(Read(psi, d, d), Read(st)),
                            writes=(po,), rings=(st, psi, po)))
        last = s == steps - 1
        nxt = (f"st{s + 1}",) if not last or outlet else ()
        if nxt:
            arrays[nxt[0]] = (ns, itemsize)
        if not last:
            nxt += (f"psi{s + 1}",)
            arrays[nxt[1]] = (k, itemsize)
        stages.append(Stage(STREAM, s, reads=(Read(po, 1, 1),), writes=nxt,
                            rings=(po, *nxt) if nxt else (po, ""),
                            output=not nxt))
        if outlet:
            stages.append(Stage(OUTLET, s, reads=(Read(nxt[0], 0, ohi),),
                                modifies=nxt, back=oback, rings=nxt,
                                slabs=(0,)))
    if outlet:
        stages.append(Stage(STORE, steps - 1, reads=(Read(f"st{steps}"),),
                            rings=(f"st{steps}",), output=True))
    return stages, arrays


def _plan(family, stages, arrays, shape, steps, rows_per_wave):
    ny, nx = (int(v) for v in shape)
    return m3.build_plan(family, stages, arrays, (ny, 1, nx), steps,
                         ROWS_PER_WAVE if rows_per_wave is None
                         else rows_per_wave)


def csf2d_march_plan(shape, steps: int, itemsize: int, split: bool,
                     inlet: int, outlet: int, wetting: bool, repair: bool,
                     rows_per_wave: int | None = None) -> m3.Plan:
    """K3's CSF plan for an (ny, nx) domain and `steps` steps a launch in a
    compute type of `itemsize` bytes: `split` the split layout, `inlet` 0
    periodic or a boundary, `outlet` 0 periodic / 1 convective / 2
    Dirichlet, `wetting` whether solid phi is extrapolated, `repair` the
    Dirichlet-outlet phi repair; `rows_per_wave` None: ROWS_PER_WAVE."""
    stages, arrays = csf2d_stages(int(shape[0]), steps, itemsize, split,
                                  inlet, outlet, wetting, repair)
    return _plan("csf2d", stages, arrays, shape, steps, rows_per_wave)


def pert2d_march_plan(shape, steps: int, itemsize: int, split: bool,
                      inlet: int, outlet: int, repair: bool,
                      rows_per_wave: int | None = None) -> m3.Plan:
    """K3's Perturbation plan: ``csf2d_march_plan``'s arguments without
    `wetting` (the variant has no wetting)."""
    stages, arrays = pert2d_stages(int(shape[0]), steps, itemsize, split,
                                   inlet, outlet, repair)
    return _plan("pert2d", stages, arrays, shape, steps, rows_per_wave)


def coupled2d_march_plan(shape, steps: int, itemsize: int, split: bool,
                         inlet: int, outlet: int, wetting: bool,
                         repair: bool, tracers: int,
                         rows_per_wave: int | None = None) -> m3.Plan:
    """K5c-T's plan: ``csf2d_march_plan``'s arguments and `tracers` = NT
    NQ tracer slots."""
    stages, arrays = coupled2d_stages(int(shape[0]), steps, itemsize, split,
                                      inlet, outlet, wetting, repair,
                                      tracers)
    return _plan("coupled2d", stages, arrays, shape, steps, rows_per_wave)


def sc2d_march_plan(shape, steps: int, itemsize: int, fluids: int,
                    order: int, inlet: int, outlet: int,
                    rows_per_wave: int | None = None) -> m3.Plan:
    """K8-T's plan for an (ny, nx) domain and `steps` steps a launch in a
    compute type of `itemsize` bytes (``sc2d_stages``' arguments);
    `rows_per_wave` None: SC_ROWS_PER_WAVE."""
    stages, arrays = sc2d_stages(int(shape[0]), steps, itemsize, fluids,
                                 order, inlet, outlet)
    return _plan("sc2d", stages, arrays, shape, steps, SC_ROWS_PER_WAVE
                 if rows_per_wave is None else rows_per_wave)


def max_steps(stages_of, limit: int = 64) -> int:
    """The largest T whose chain `stages_of(T)` -> (stages, arrays) fits a
    plan (``march3d.MAX_STAGES`` stages and ``MAX_RINGS`` rings, the
    executor's tables in shared memory): the most steps one launch of the
    march takes."""
    t = 0
    while t < limit:
        stages, arrays = stages_of(t + 1)
        if len(stages) > m3.MAX_STAGES or len(arrays) > m3.MAX_RINGS:
            break
        t += 1
    return t


# -- the plain model of the march ---------------------------------------------

class _Rows:
    """A plan's rings as CPU tensors (planes, depth, nx), full of NaN until
    written; a wave's writes are kept aside and land after the wave."""

    def __init__(self, plan: m3.Plan, dtype):
        self.t = {r.name: torch.full((r.planes, r.depth, plan.nx),
                                     float("nan"), dtype=dtype)
                  for r in plan.rings}
        self.pending = []

    def get(self, name, u):
        """Array `name` at unwrapped row u: (planes, nx)."""
        t = self.t[name]
        return t[:, u % t.shape[1]]

    def put(self, name, u, value):
        self.pending.append((name, u, value))

    def flush(self):
        for name, u, value in self.pending:
            t = self.t[name]
            t[:, u % t.shape[1]] = value.to(t.dtype)
        self.pending = []


def _run(plan: m3.Plan, rows: _Rows, body):
    """Every wave in order; within a wave each stage's rows together:
    body(stage, us) with us the stage's unwrapped rows of the wave; the
    wave's writes land after it."""
    for wave in plan.waves:
        by_stage = {}
        for k, u in wave:
            by_stage.setdefault(k, []).append(u)
        for k, us in by_stage.items():
            body(plan.stages[k], us)
        rows.flush()


def _domain(rows: _Rows, name, us, zlo, zhi, ny):
    """Array `name` at rows u - zlo ... u + zhi of each u in `us`, placed at
    their domain rows of an otherwise NaN (planes, ny, nx) tensor."""
    t = rows.t[name]
    out = torch.full((t.shape[0], ny, t.shape[2]), float("nan"),
                     dtype=t.dtype)
    for u in us:
        for v in range(u - zlo, u + zhi + 1):
            out[:, v % ny] = rows.get(name, v)
    return out


def _stage_reads(st, name):
    r = next(r for r in st.reads if r.array == name)
    return r.zlo, r.zhi


class _Flow:
    """The CSF stages' plain operators for a ColorGradientRK `m` on a
    layout: full-domain tensors in, the rows asked for out."""

    def __init__(self, m, split: bool):
        self.m, self.split = m, split
        self.lat = m.lat
        self.ny = m.geo.ny

    def rhos(self, x):
        if self.split:
            rr, rb = mac.density(x[:9], 2), mac.density(x[9:], 2)
            return x[:9] + x[9:], rr, rb, rr + rb
        rr, rb, rho = self.m.rho_fields_c(x)
        return x[:9], rr, rb, rho

    def bc(self, x):
        m = self.m
        if self.split:
            f_r, f_b = m._apply_inlet(x[:9], x[9:])
            f_r, f_b = m._apply_outlet(f_r, f_b)
            return torch.cat([f_r, f_b])
        return m._apply_bcs_c(x)

    def phi(self, x):
        m = self.m
        _, rr, rb, _ = self.rhos(x)
        phi = cg.phase_field(rr, rb) * m.fluid_mask
        if m._phi_repair:
            phi = m._repair_phi_rows(phi)
        if m.has_wetting:
            phi = cg.solid_phi_extrapolate(phi, m.is_fluid, self.lat)
        return phi

    def gradient(self, phi):
        m = self.m
        gx, gy = cg.color_gradient(phi, self.lat)
        if m.has_wetting:
            rot = (cg.rotate_gradient_on_wetting_xu if m.p.wetting_type == 1
                   else cg.rotate_gradient_on_wetting_akai)
            gx, gy = rot(gx, gy, m.nsx, m.nsy, m.cos_t, m.sin_t, m.wet_fluid)
        return gx, gy

    def force(self, gx, gy, rho):
        """The CSF force of the gradient (and the body force), on fluid
        cells."""
        m = self.m
        fx, fy, _ = cg.csf_force(gx, gy, m.p.surface_tension, m.is_fluid,
                                 inward_normal=(m.p.wetting_type == 2),
                                 lat=self.lat)
        bfx, bfy = m.p.body_force
        if bfx or bfy:
            fx = fx + bfx * rho
            fy = fy + bfy * rho
        return fx * m.fluid_mask, fy * m.fluid_mask

    def collide(self, x, phi, gx, gy):
        """The post-collision PDF and the recolouring factors frac, A, B
        (12 planes; 0 on solid cells)."""
        m = self.m
        f, rr, rb, rho = self.rhos(x)
        fx, fy = self.force(gx, gy, rho)
        u = m._velocity(f, rho, fx, fy)
        feq = eq.feq_quadratic(self.lat, rr, u) + \
            eq.feq_quadratic(self.lat, rb, u) if self.split else \
            eq.feq_quadratic(self.lat, rho, u)
        post = m._collide(f, feq, u, fx, fy, phi, rr, rb)
        tot = rr + rb
        tot_s = torch.where(tot != 0, tot, torch.ones_like(tot))
        frac = rr / tot_s
        segc = m.p.beta * rr * rb / tot_s
        norm = torch.sqrt(gx * gx + gy * gy)
        ok = norm > 1e-8
        norm_s = torch.where(ok, norm, torch.ones_like(norm))
        a = torch.where(ok, segc * (gx / norm_s), 0.0)
        b = torch.where(ok, segc * (gy / norm_s), 0.0)
        out = torch.cat([post, frac[None], a[None], b[None]])
        return torch.where(m.is_fluid, out, 0.0)

    def stream(self, po):
        """The streamed state (10 or 18 planes) of post and its red parts
        (the red part of population i from its source cell, or from the
        cell itself where the upwind cell is solid)."""
        m, lat = self.m, self.lat
        up = m.upwind_solid
        post, frac, a, b = po[:9], po[9], po[10], po[11]
        o = stream(post, lat, up)
        red = [frac * o[0]]
        for i in range(1, 9):
            e = [int(c) for c in lat.e[i]]
            j = int(lat.opp[i])

            def seg(k, fa, fb):
                return float(lat.w[k]) * (float(lat.e[k, 0]) * fa +
                                          float(lat.e[k, 1]) * fb)
            src = pull(frac, *e) * o[i] + seg(i, pull(a, *e), pull(b, *e))
            own = frac * o[i] + seg(j, a, b)
            red.append(torch.where(up[i], own, src))
        red = torch.stack(red)
        fl = m.fluid_mask
        if self.split:
            return torch.cat([red, o - red]) * fl
        return torch.cat([o, mac.density(red, 2)[None]]) * fl


def _trigger_rows(gz, ny, inlet, outlet):
    """Rows (offsets from the trigger) that a boundary trigger at domain
    row gz rewrites."""
    if inlet and gz == ny - 2:
        return (0, 1)
    if outlet == 1 and gz == 0:
        return (0, 1, 2)
    if outlet == 2 and gz == 0:
        return (0, 1)
    return ()


def _flow_body(fl: _Flow, rows: _Rows, st, us, ny, out, steps, codes):
    """One CSF stage of the flow at rows `us` (the plain model)."""
    s = st.level
    idx = torch.as_tensor([u % ny for u in us])
    name = st.rings[0]
    if st.kind == BC:
        x = _domain(rows, name, us, 0, _stage_reads(st, name)[1], ny)
        new = fl.bc(x)
        for u in us:
            for d in _trigger_rows(u % ny, ny, *codes):
                rows.put(name, u + d, new[:, (u + d) % ny])
    elif st.kind == PHI:
        zlo, zhi = _stage_reads(st, name)
        phi = fl.phi(_domain(rows, name, us, zlo, zhi, ny))
        for u in us:
            rows.put(st.rings[1], u, phi[None, u % ny])
    elif st.kind == NORMAL:
        gx, gy = fl.gradient(_domain(rows, name, us, 1, 1, ny)[0])
        for u in us:
            g = torch.stack([gx[u % ny], gy[u % ny]])
            rows.put(st.rings[1], u, torch.cat([g, torch.full_like(g, 0.0)]))
    elif st.kind == COLLIDE:
        x = _domain(rows, st.rings[0], us, 0, 0, ny)
        phi = _domain(rows, st.rings[1], us, 0, 0, ny)[0]
        gn = _domain(rows, st.rings[2], us, 1, 1, ny)
        po = fl.collide(x, phi, gn[0], gn[1])
        for u in us:
            rows.put(st.rings[3], u, po[:, u % ny])
    elif st.kind == STREAM:
        new = fl.stream(_domain(rows, st.rings[0], us, 1, 1, ny))
        if s == steps - 1:
            out[:, idx] = new[:, idx]
        else:
            for u in us:
                rows.put(st.rings[1], u, new[:, u % ny])
    else:
        raise ValueError(f"the CSF march has no stage {st.kind}")


def _codes(m):
    """(inlet, outlet) codes of a ColorGradientRK's boundaries."""
    inlet = int(m.bcs.inlet != "periodic")
    outlet = {"periodic": 0, "convective": 1, "dirichlet": 2}[m.bcs.outlet]
    return inlet, outlet


def csf2d_march_reference(state, model, steps: int,
                          plan: m3.Plan | None = None):
    """`steps` CSF steps of K3's row-march on the CPU for `model`, a
    ColorGradientRK: the compressed state (10 planes, or the 11-plane bf16
    state, decoded once and encoded once) or the split pair (f_r, f_b).
    The plan's stages run wave by wave from rings of its depth, each through
    the plain path's operators (module docstring)."""
    split = not torch.is_tensor(state)
    bf16 = not split and state.dtype == torch.bfloat16
    if split:
        x0 = torch.cat(tuple(state))
    else:
        x0 = model.unpack_bf16(state) if bf16 else state
    ny, nx = x0.shape[-2:]
    inlet, outlet = _codes(model)
    if plan is None:
        plan = csf2d_march_plan((ny, nx), steps, x0.element_size(), split,
                                inlet, outlet, bool(model.has_wetting),
                                bool(model._phi_repair))
    rows = _Rows(plan, x0.dtype)
    out = torch.full_like(x0, float("nan"))
    fl = _Flow(model, split)

    def body(st, us):
        if st.kind == LOAD:
            for u in us:
                rows.put("st0", u, x0[:, u % ny])
        else:
            _flow_body(fl, rows, st, us, ny, out, steps, (inlet, outlet))

    _run(plan, rows, body)
    if split:
        return out[:9], out[9:]
    return model.pack_compressed_bf16(out) if bf16 else out


class _Pert(_Flow):
    """The Perturbation stages' plain operators (``_step_pert_c`` /
    ``_step_perturbation`` cut at the march's stages)."""

    def dphi(self, x):
        """d = rho_r - rho_b (solid_phi on solid cells) and phi with the
        outlet repair: (2, ny, nx)."""
        m = self.m
        _, rr, rb, _ = self.rhos(x)
        fl = m.fluid_mask
        d = (rr - rb) * fl + m.p.solid_phi * (1.0 - fl)
        phi = cg.phase_field(rr, rb) * fl
        if m._phi_repair:
            phi = m._repair_phi_rows(phi)
        return torch.stack([d, phi])

    def pert_collide(self, x, dp):
        """The post-collision PDF and its red part (18 planes; 0 on solid
        cells)."""
        m, lat, p = self.m, self.lat, self.m.p
        f, rr, rb, rho = self.rhos(x)
        d, phi = dp[0], dp[1]
        gx = torch.zeros_like(d)
        gy = torch.zeros_like(d)
        for i in range(1, 9):
            dx, dy = int(lat.e[i, 0]), int(lat.e[i, 1])
            w = float(m._grad_scheme[i])
            sh = shift(d, dx, dy)
            if dx:
                gx = gx + (w * dx) * sh
            if dy:
                gy = gy + (w * dy) * sh
        rho_safe = torch.where(rho > 0, rho, torch.ones_like(rho))
        mx, my = mac.momentum(lat, f)
        u = (mx / rho_safe, my / rho_safe)
        tau = cg.tau_interp_grunau(phi, p.tau_r, p.tau_b, p.delta)
        if self.split:
            f_r = m._relax(x[:9], eq.feq_rk_original(lat, rr, u, m.const_cr),
                           tau)
            f_b = m._relax(x[9:], eq.feq_rk_original(lat, rb, u, m.const_cb),
                           tau)
            f_r = f_r + cg.perturbation(gx, gy, p.a_kr, cg.B_CONSTANTS, lat)
            f_b = f_b + cg.perturbation(gx, gy, p.a_kb, cg.B_CONSTANTS, lat)
            post = f_r + f_b
        else:
            feq = eq.feq_rk_original(lat, rr, u, m.const_cr) + \
                eq.feq_rk_original(lat, rb, u, m.const_cb)
            post = m._relax(f, feq, tau) + cg.perturbation(
                gx, gy, p.a_kr + p.a_kb, cg.B_CONSTANTS, lat)
        red, _ = cg.recolor_rk_original(post, rr, rb, gx, gy, p.beta,
                                        m.const_cr, m.const_cb, lat)
        return torch.where(m.is_fluid, torch.cat([post, red]), 0.0)

    def pert_stream(self, po):
        """The streamed state (10 or 18 planes) of post and its red part."""
        m, lat = self.m, self.lat
        o = stream(po[:9], lat, m.upwind_solid)
        red = stream(po[9:], lat, m.upwind_solid)
        fl = m.fluid_mask
        if self.split:
            return torch.cat([red, o - red]) * fl
        return torch.cat([o, mac.density(red, 2)[None]]) * fl


def _pert_body(fl: _Pert, rows: _Rows, st, us, ny, out, steps, codes):
    """One Perturbation stage at rows `us` (the plain model); the boundary
    stage is CSF's."""
    idx = torch.as_tensor([u % ny for u in us])
    if st.kind == BC:
        _flow_body(fl, rows, st, us, ny, out, steps, codes)
    elif st.kind == PHI:
        zlo, zhi = _stage_reads(st, st.rings[0])
        dp = fl.dphi(_domain(rows, st.rings[0], us, zlo, zhi, ny))
        for u in us:
            rows.put(st.rings[1], u, dp[:, u % ny])
    elif st.kind == COLLIDE:
        x = _domain(rows, st.rings[0], us, 0, 0, ny)
        dp = _domain(rows, st.rings[1], us, 1, 1, ny)
        po = fl.pert_collide(x, dp)
        for u in us:
            rows.put(st.rings[2], u, po[:, u % ny])
    elif st.kind == STREAM:
        new = fl.pert_stream(_domain(rows, st.rings[0], us, 1, 1, ny))
        if st.level == steps - 1:
            out[:, idx] = new[:, idx]
        else:
            for u in us:
                rows.put(st.rings[1], u, new[:, u % ny])
    else:
        raise ValueError(f"the Perturbation march has no stage {st.kind}")


def pert2d_march_reference(state, model, steps: int,
                           plan: m3.Plan | None = None):
    """`steps` Perturbation steps of K3's row-march on the CPU for `model`,
    a ColorGradientRK with ``variant="Perturbation"``: the compressed state
    (10 planes, or the 11-plane bf16 state, decoded once and encoded once)
    or the split pair (f_r, f_b), as ``csf2d_march_reference`` runs the
    CSF plan."""
    split = not torch.is_tensor(state)
    bf16 = not split and state.dtype == torch.bfloat16
    if split:
        x0 = torch.cat(tuple(state))
    else:
        x0 = model.unpack_bf16(state) if bf16 else state
    ny, nx = x0.shape[-2:]
    inlet, outlet = _codes(model)
    if plan is None:
        plan = pert2d_march_plan((ny, nx), steps, x0.element_size(), split,
                                 inlet, outlet, bool(model._phi_repair))
    rows = _Rows(plan, x0.dtype)
    out = torch.full_like(x0, float("nan"))
    fl = _Pert(model, split)

    def body(st, us):
        if st.kind == LOAD:
            for u in us:
                rows.put("st0", u, x0[:, u % ny])
        else:
            _pert_body(fl, rows, st, us, ny, out, steps, (inlet, outlet))

    _run(plan, rows, body)
    if split:
        return out[:9], out[9:]
    return model.pack_compressed_bf16(out) if bf16 else out


def _tracer_collide(model, g, x, gx, gy, fl: _Flow):
    """The tracers' collision, partition and reaction (TransportRK's
    ``_transport_substep`` up to its outlet rows) on full-domain tensors,
    with u and the transport domain of the flow state x; (g_post, in_dom)."""
    tp, lat = model.tp, model.lat_tr
    nt = tp.num_tracers
    f, rr, _, rho = fl.rhos(x)
    fx, fy = fl.force(gx, gy, rho)
    u = model.flow._velocity(f, rho, fx, fy)
    conc = model.concentration(g)
    in_dom, value = tr.transport_domain_mask(rr, tp.criteria)
    if tp.relaxation == "MRT":
        feq_fn = eq.feq_transport_quadratic \
            if tp.mrt_equilibrium == "quadratic" else eq.feq_transport_linear
        g = tr.mrt_collide(g, feq_fn(lat, conc, u), model.mrt_update)
    else:
        if tp.scheme == 5:
            geq = torch.stack([eq.feq_transport_j(lat, conc[t], u,
                                                  model.j_coeffs[t])
                               for t in range(nt)])
        else:
            geq = eq.feq_transport_linear(lat, conc, u)
        tau = torch.as_tensor(model.tau_tr, dtype=g.dtype).reshape(-1, 1, 1, 1)
        g = g - (g - geq) / tau
    if tp.interface_mode == "permeable" and any(model.beta):
        g = tr.interface_partition(g, conc, gx, gy, value, model.beta, lat)
    if tp.reaction_rate:
        g = tr.bilinear_reaction(
            g, conc, tp.reaction_rate,
            model.j_coeffs if tp.scheme == 5 else np.tile(lat.w, (nt, 1)),
            model.stoich)
    return g, in_dom


def _tracer_stream(model, g, in_dom):
    """The rest of ``_transport_substep``: the free-flow outlet rows,
    streaming, the interface bounce-back and the inlet rows."""
    tp, lat = model.tp, model.lat_tr
    m = model.flow._row_mask
    if tp.outlet == "freeflow":
        g = tr.free_flow_outlet(g, (2, 1, 0), (m(2), m(1), m(0)))
    g = stream(g, lat, model.upwind_solid_tr) * model.flow.fluid_mask
    if tp.interface_mode in ("bounceback", "redistribute"):
        g = tr.interface_bounce_back(g, in_dom, lat)
    ny = model.geo.ny
    if tp.inlet == "inamuro":
        g = tr.inamuro_inlet(g, model.inlet_conc, ny - 1, m(ny - 1))
    elif tp.inlet == "anti_bounce_back":
        g = tr.anti_bounce_back_inlet(g, model.inlet_conc, ny - 2, m(ny - 1),
                                      w3=float(lat.w[3]))
    elif tp.inlet == "zero":
        g = tr.zero_concentration_inlet(g, ny - 2, m(ny - 2))
    return g


def coupled2d_march_reference(state, model, steps: int,
                              plan: m3.Plan | None = None):
    """`steps` coupled steps of K5c-T's row-march on the CPU for `model`, a
    TransportRK: the compressed state (s, g) (a bf16 s decoded once and
    encoded once) or the split TransportState (f_r, f_b, g, mass0), which
    comes back as one.  The plan's stages run wave by wave from rings of
    its depth, each through the plain path's operators."""
    flow = model.flow
    split = len(state) == 4
    if split:
        x0, g0 = torch.cat(tuple(state[:2])), state[2]
    else:
        s, g0 = state
        bf16 = s.dtype == torch.bfloat16
        x0 = flow.unpack_bf16(s) if bf16 else s
    ny, nx = x0.shape[-2:]
    nt, nq = g0.shape[:2]
    inlet, outlet = _codes(flow)
    if plan is None:
        plan = coupled2d_march_plan((ny, nx), steps, x0.element_size(), split,
                                    inlet, outlet, bool(flow.has_wetting),
                                    bool(flow._phi_repair), nt * nq)
    rows = _Rows(plan, x0.dtype)
    out = torch.full_like(x0, float("nan"))
    g_out = torch.full_like(g0, float("nan"))
    fl = _Flow(flow, split)
    ng = nt * nq

    def body(st, us):
        s_ = st.level
        idx = torch.as_tensor([u % ny for u in us])
        if st.kind == LOAD:
            for u in us:
                rows.put("st0", u, x0[:, u % ny])
        elif st.kind == TCOLLIDE:
            x = _domain(rows, st.rings[0], us, 0, 0, ny)
            gn = _domain(rows, st.rings[1], us, 1, 1, ny)
            if st.rings[2]:
                g = _domain(rows, st.rings[2], us, 0, 0, ny).reshape(
                    nt, nq, ny, nx)
            else:
                g = torch.full_like(g0, float("nan"))
                g[:, :, idx] = g0[:, :, idx]
            gp, dom = _tracer_collide(model, g, x, gn[0], gn[1], fl)
            gp = torch.cat([gp.reshape(ng, ny, nx), dom[None].to(gp.dtype)])
            for u in us:
                rows.put(st.rings[3], u, gp[:, u % ny])
        elif st.kind == TSTREAM:
            gp = _domain(rows, st.rings[0], us, TSTREAM_LO, TSTREAM_HI, ny)
            g = _tracer_stream(model, gp[:ng].reshape(nt, nq, ny, nx),
                               gp[ng] > 0.5)
            if s_ == steps - 1:
                g_out[:, :, idx] = g[:, :, idx]
            else:
                g = g.reshape(ng, ny, nx)
                for u in us:
                    rows.put(st.rings[1], u, g[:, u % ny])
        else:
            _flow_body(fl, rows, st, us, ny, out, steps, (inlet, outlet))

    _run(plan, rows, body)
    if split:
        return type(state)(out[:9], out[9:], g_out, state[3])
    return (flow.pack_compressed_bf16(out) if bf16 else out), g_out


# -- K8-T -------------------------------------------------------------------

def sc_codes(model):
    """(fluids, order, inlet, outlet) of a ShanChenMCMP as K8-T's plan takes
    them (ScParams' codes: order 0 the original SC; outlet 1 Zou-He
    pressure, 2 convective)."""
    p, b = model.p, model.bcs
    order = p.iso_order if p.scheme == "EFS" else 0
    outlet = {"periodic": 0, "zou_he_pressure": 1, "convective": 2}[b.outlet]
    return model.k, order, int(b.inlet != "periodic"), outlet


class _ShanChen:
    """K8-T's stages' plain operators for a ShanChenMCMP `m` (shift forcing,
    no moving wall: the configurations K8-T takes), cut from ``_step_sc``
    and ``_step_efs``: full-domain tensors in, full-domain tensors out."""

    def __init__(self, m):
        self.m = m
        self.fluid = m.fluid_mask > 0

    def psi(self, x):
        """psi_k of the state x (K, 9, ny, nx), 0 on solid cells."""
        return torch.where(self.fluid, self.m._psi(mac.density(x, 2)), 0.0)

    def collide(self, x, psi):
        """The post-collision state of x with the interaction force of
        `psi` (and the body force), 0 on solid cells."""
        m, lat = self.m, self.m.lat
        rho_k = mac.density(x, 2)
        rho_safe = torch.where(rho_k > 0, rho_k, torch.ones_like(rho_k))
        force = sc.interaction_force_sc if m.p.scheme == "SC" \
            else sc.interaction_force_efs
        fx, fy = force(psi, m.g_matrix, m.g_solid, m.fields)
        bfx, bfy = m.p.body_force
        if bfx or bfy:
            fx = fx + bfx * rho_k
            fy = fy + bfy * rho_k
        if m.p.scheme == "SC":
            upx, upy = mac.sc_common_velocity(lat, x, rho_k, m.tau)
            ueq = (upx[None] + m.tau_k * fx / rho_safe,
                   upy[None] + m.tau_k * fy / rho_safe)
            feq = eq.feq_quadratic(lat, rho_k, ueq)
            post = m._mrt_each(x, feq) if m.p.collision == "MRT" else \
                x - (x - feq) / m.tau_k[:, None]
        else:
            mx, my = mac.momentum(lat, x)
            itau = m.inv_tau_k
            den = torch.sum(rho_k * itau, dim=0)
            den = torch.where(den != 0, den, torch.ones_like(den))
            u = (torch.sum((mx + 0.5 * fx) * itau, dim=0) / den,
                 torch.sum((my + 0.5 * fy) * itau, dim=0) / den)
            u = (u[0].expand_as(rho_k), u[1].expand_as(rho_k))
            feq = eq.feq_quadratic(lat, rho_k, u)
            ff = efs_force_pdf(lat, feq, rho_safe, u, (fx, fy))
            if m.p.collision == "SRT":
                post = x + (feq - x - 0.5 * ff) / m.tau_k[:, None] + ff
            else:
                post = x + (m._mrt_each(x, feq - 0.5 * ff) - x) + ff
        return torch.where(self.fluid, post, 0.0)

    def stream(self, po):
        """Pull streaming with half-way bounce-back, masked to the fluid."""
        return stream(po, self.m.lat, self.m.upwind_solid) * self.m.fluid_mask


def _sc_trigger_rows(gz, ny, d, inlet, outlet):
    """Rows (offsets from the trigger) that a boundary trigger of K8-T at
    domain row gz rewrites."""
    if inlet and gz == ny - 1 - d:
        return tuple(range(d + 1))
    if outlet and gz == 0:
        return tuple(range(d + 1 if outlet == 1 else d + 2))
    return ()


def sc2d_march_reference(f, model, steps: int, plan: m3.Plan | None = None):
    """`steps` Shan-Chen steps of K8-T's row-march on the CPU for `model`, a
    ShanChenMCMP the kernel takes: the (K, 9, ny, nx) state, or the (K, 11,
    ny, nx) bf16 state decoded once and encoded once.  The plan's stages run
    wave by wave from rings of its depth (module docstring), each through
    the plain step's operators (``_ShanChen``, ``_apply_inlet``,
    ``_apply_outlet``)."""
    bf16 = f.dtype == torch.bfloat16
    x0 = model.unpack_bf16(f) if bf16 else f
    k, ny, nx = x0.shape[0], x0.shape[-2], x0.shape[-1]
    fluids, order, inlet, outlet = sc_codes(model)
    d = sc_reach(order)
    if plan is None:
        plan = sc2d_march_plan((ny, nx), steps, x0.element_size(), fluids,
                               order, inlet, outlet)
    rows = _Rows(plan, x0.dtype)
    out = torch.full_like(x0, float("nan"))
    ops = _ShanChen(model)
    flat = x0.reshape(k * 9, ny, nx)

    def state(name, us, zlo=0, zhi=0):
        return _domain(rows, name, us, zlo, zhi, ny).reshape(k, 9, ny, nx)

    def put(name, us, value, offsets=(0,)):
        value = value.reshape(value.shape[0] * value.shape[1], ny, nx) \
            if value.dim() == 4 else value
        for u in us:
            for r in offsets:
                rows.put(name, u + r, value[:, (u + r) % ny])

    def body(st, us):
        idx = torch.as_tensor([u % ny for u in us])
        name = st.rings[0]
        # the psi ring of a load, bc, stream or outlet stage ("" for the
        # last level's stream and outlet)
        at = 2 if st.kind == STREAM else 1
        psi_ring = st.rings[at] if len(st.rings) > at else ""
        if st.kind == LOAD:
            for u in us:
                rows.put("st0", u, flat[:, u % ny])
            put(psi_ring, us, ops.psi(x0))
        elif st.kind in (BC, OUTLET):
            x = state(name, us, 0, _stage_reads(st, name)[1])
            new = model._apply_inlet(x) if st.kind == BC else \
                model._apply_outlet(x, None)
            for u in us:
                rows_of = _sc_trigger_rows(u % ny, ny, d, inlet, outlet)
                put(name, (u,), new, rows_of)
                if psi_ring:
                    put(psi_ring, (u,), ops.psi(new), rows_of)
        elif st.kind == COLLIDE:
            psi = _domain(rows, st.rings[1], us, d, d, ny)
            put(st.rings[2], us, ops.collide(state(name, us), psi))
        elif st.kind == STREAM:
            new = ops.stream(state(name, us, 1, 1))
            if st.rings[1]:
                put(st.rings[1], us, new)
                if psi_ring:
                    put(psi_ring, us, ops.psi(new))
            else:
                out[..., idx, :] = new[..., idx, :]
        elif st.kind == STORE:
            out[..., idx, :] = state(name, us)[..., idx, :]
        else:
            raise ValueError(f"K8-T has no stage {st.kind}")

    _run(plan, rows, body)
    return model.pack_state_bf16(out) if bf16 else out
