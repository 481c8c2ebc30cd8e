#!/usr/bin/env python3
"""Plant faults in the kernels and show that chip_smoke.py's phases, each
kernel against its plain path, fail them: the D3Q19 CSF kernel (K9) and its
coupled tracer step (K9t) under phase 21 (configuration 5 at 128^3) and
phase 26 (benchmarks/probe_coupled3d.py's configuration at 128^3), the
single-phase D2Q9 kernel (K7) under phase 31 (the analytic Poiseuille
profile), the D3Q19 Shan-Chen kernel (K10) under phases 36 and 37
(benchmarks/probe_sc3d.py's configuration) and the Perturbation kernel
(K4) under phase 41 (the pert flagship at 1024^2), and the D3Q19
single-phase push (K11) under phase 33 (its f64 cases), the 2-D
Shan-Chen push (K8) under phase 15 (its f64 cases), the strip marches of
the 2-D colour-gradient step (K1 / K2 / K6 under phase 3, K4 under phase
40, the tracer's of K5c / K5s under phases 6 and 11; the first output row
of a step reads the row above it, carried in the post ring from the step
before, from a stale slot, in the f64 pull) while phase 45 (K3, both
variants; 52, K5c-T, for the tracer's) passes; ten faults that
only the T-step kernels can show: the colour-gradient K3's row-march under
phase 48 (the flagships at 1024^2 in f32) and phase 45 (its f64 cases;
twice, once in the Perturbation variant's body),
the Shan-Chen K8-T under phase 46, the
single-phase K7-T under phase 47, the coupled K5c-T under phase 52, the
D3Q19 K11-T and K10-T under phase 53, the D3Q19 CSF K9-T under phase 60
(their f64 cases) and K10-T's launch limit under phase 72 (T-step calls
past a launch's limit), each while the T=1 phases of the same family (4
and 41, 40 and 41, 15, 29, 6 and 11, 33, 36, 20 and 21) or its T <= 4
phase pass;
and one in the runtime-K Shan-Chen instance under phase 58 (four fluids)
while phase 15 passes.

    python3 chip_faults.py [case ...]

With case names (or their first words, e.g. ``K3``), only those cases run,
after "none".

Run from the repository root on a machine with a CUDA card and nvcc.  Each
case copies ``openlbmpm_torch`` (without its build directory),
``chip_smoke.py`` and ``configs/`` into a temporary directory, changes one line of a
``csrc/`` source there, and runs its phases in a subprocess that builds the
copy's libraries and records every failed check (and any error) instead of
stopping at the first.  The K9 faults make fields_kernel write a zero
curvature, and so no CSF force, on wetting fluid cells only (the contact
lines, where phase 21 compares against the plain path's one-ulp twin) in
one storage type's one-step instance; the tracer
fault applies the hard interface bounce-back on the x and y axes only (the
tracer then leaks through the red phase across the periodic z seam) in the
f32 instance, and the fused tracer's fault gives the -z slot that the
colliding thread writes the flags of its own cell for its upwind cell's
(no bounce-back and no repair across that face) in the f32 instance; the
K7 fault drops the Guo source from the MRT update in the
f32 instance (the half-force stays in the relaxed moments); the K10 faults
drop the adhesion term, which only wall-adjacent cells carry, in the
float-arithmetic instances (f32 and bf16 storage: the shared collision
knows only its compute type), or push a post-collision value bounced back
from a solid neighbour into the cell's slot i instead of opp(i) in the f32
instance, or give the bf16 march's common velocity fluid 0's density for
every fluid in its denominator (phase 37 fails, 36 passes); the K11
fault does the same in K11's push, in the f64 instance,
and the K8 fault in K8's push (sc2d.cuh), in the f64 instance;
the K4 fault drops the 1/sqrt(2) of the diagonal recolouring
segment in the float-arithmetic instances (K4c f32, K4h, K4s f32; the
Perturbation K3 shares the line). The T-step faults: K3's row-march
rewrites the boundary rows of level 0 only (not before the later steps of
a call), in its f32 instances, or picks the inlet's trigger row by its
unwrapped row instead of the domain's (the copy of row ny - 2 recomputed
below the seam misses its rewrite), in its f64 instance, or (its
Perturbation stream) bounces a diagonal's red part back from the wrong
slot, in its f64 instance; K8-T's row-march forms the Zou-He outlet row d
from the values of row d + 1 (its outlet stage one row off), in its f64
instance; K7-T rewrites the rows after the first sub-step only, in its f64
instance; K5c-T's row-march maps the tracer stream's unwrapped rows to
global rows without the wrap (the tracer's inlet and outlet rows
recomputed across the seam are missed), K11-T's stream-and-collide stage
pulls from the slab above where it should pull from the slab below,
K10-T's z-march skips the slabs it recomputes below the
periodic seam (u < 0), and K9-T's march picks the inlet's boundary slabs
by its unwrapped slab instead of the domain's (the recomputed copy of slab
nz - 2 below the seam misses its rewrite), K10-T's library states a launch
limit of twice kMaxSteps3 (the wrapper then no longer splits a call of 10
or 16 steps, which the launcher refuses), each in its f64 instance, the
runtime-K K8 gives every fluid fluid 0's 1/tau in the common velocity, in
f64 arithmetic, the local form of K3 (K12a, the sharded colour-gradient
step) maps its window rows to global rows one row off, in its f64
instance, the local form of K9 (K12d, the sharded D3Q19 CSF step) writes
the boundary slabs one buffer slab off their global index, and the local
form of K10 (K12e, the sharded D3Q19 Shan-Chen step) collides, and so
forms rho, one slab short of a sub-step's reach below, and the local form of K8-T (K12c, the sharded
2-D Shan-Chen step) finds its inlet band one global row off, each in its
f64 instance:

  none           the sources as they are: phases 3, 4, 6, 11, 15, 20,
                 21, 26, 29, 31, 33, 36, 37, 40, 41, 45-48, 52, 53, 58,
                 60, 63, 67, 68, 70, 72 must pass;
  f32            cg3d.cuh, float32 storage (K9c f32, K9s f32): phase 21;
  bf16           cg3d.cuh, bfloat16 storage (K9h): phase 21;
  tracer f32     cg3d.cuh, float32 storage (K9t f32): phase 26;
  tracer z pair f32  cg3d.cuh, float32 storage (K9t f32): phase 26;
  K7 MRT f32     single2d.cuh, float32 storage: phase 31 must fail;
  K10 adh f32    flow3d.cuh, float arithmetic (f32, bf16): phase 37 must
                 fail;
  K10 push target f32  flow3d.cuh, float32 storage: phases 36 (its f32
                 part) and 37 must fail;
  K11 push target f64  flow3d.cuh, float64 storage: phase 33 must fail,
                 phases 36 (K10's push) and 53 (K11-T) pass;
  K8 push target f64  sc2d.cuh, float64 storage: phase 15 must fail,
                 phase 46 (K8-T) passes;
  K4 diag f32    pert2d.cuh, float arithmetic: phase 41 must fail;
  K3 bc once     march2d.cuh, float32 storage: phase 48 must fail,
                 phases 4 and 41 (K1, K4) pass;
  K3 march trigger   march2d.cuh, float64 storage: phase 45 must fail,
                 phases 4 and 41 (K1, K4) pass;
  K3 pert march  march2d.cuh, float64 storage: phase 45 must fail,
                 phases 40 and 41 (K4) pass;
  K8-T march outlet  sc2d_march.cuh, float64 storage: phase 46 must
                 fail, phase 15 (K8) passes;
  K7-T bc once   single2d_block.cuh, float64 storage: phase 47 must fail,
                 phase 29 (K7) passes;
  K5c-T window rows  march2d.cuh, float64 arithmetic: phase 52 must
                 fail, phases 6 and 11 (K5c, K5s) pass;
  K11-T march pull z flow3d_block.cuh, float64 storage: phase 53 must
                 fail, phase 33 (K11) passes;
  K10-T seam skipped flow3d_block.cuh, float64 storage: phase 53 must
                 fail, phase 36 (K10) passes;
  K9-T march z   cg3d_block.cuh, float64 storage: phase 60 must fail,
                 phases 20 and 21 (K9) pass;
  K10-T limit raise  flow3d_block.cuh, float64 storage: phase 72 must
                 fail, phase 53 (K11-T, K10-T at T <= 4) passes;
  K8 rt tau      sc2d_rt.cuh, float64 arithmetic: phase 58 must fail,
                 phase 15 (K8, K <= 3) passes;
  K12 row0       csf2d_block.cuh, the local instances, float64 storage:
                 phase 63 must fail, phase 45 (K3, the same kernel's
                 single-device instances) passes;
  K12d slab index    cg3d_local.cuh, float64 storage: phase 67 must fail,
                 phases 20 and 21 (K9) pass;
  K12e rho short flow3d.cuh (the box form), float64 storage: phase 68
                 must fail,
                 phase 36 (K10) passes;
  K12c inlet row sc2d_block.cuh, the local instances, float64 storage:
                 phase 70 must fail, phase 46 (K8-T, the same body's
                 single-device instances) passes;
  K1 strip carry f64  csf2d.cuh (strip_kernel's pull), float64 storage:
                 phase 3 must fail, phase 45 (K3) passes;
  K4 strip carry f64  pert2d.cu (pert_strip_kernel's pull), float64
                 storage: phase 40 must fail, phase 45 (the Perturbation
                 K3's march) passes;
  K5c strip carry f64  coupled2d.cu (tracer_strip_kernel's pull, the same
                 stale slot), float64 storage: phases 6 and 11 must fail,
                 phase 52 (K5c-T) passes;
  K10 bf16 common velocity  flow3d.cuh (sc_collide, the bf16 march's
                 collision), float arithmetic: fluid 0's density for every
                 fluid in the common velocity's denominator; phase 37 (its
                 bf16 part) must fail, phase 36 (K10's f64 and f32 push)
                 passes;
  K3 num den_inv f64  march2d.cuh (the row-march's phi stage), float64
                 storage: phi extended onto solids as num times the
                 reciprocal of den; phases 45 and 52 (their Xu porous
                 cases) must fail, phase 3 (K1, K6) passes;
  K12 num den_inv f64  csf2d_block.cuh (the windows of K12a), likewise:
                 phase 63 must fail, phase 45 passes.

Prints one line per case with the failed checks and the gaps, and exits 0
only when every case behaves as stated.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LINE = "    fld[3 * n + ((size_t)z * ny + y) * nx + x] = kappa;"
# sizeof(S): the storage type (8 f64, 4 f32, 2 bf16); a code > 1.5 is a
# wetting fluid cell
FAULT = ("    fld[3 * n + ((size_t)z * ny + y) * nx + x] = sizeof(S) == "
         "{size} && geo[((size_t)z * ny + y) * nx + x] > C(1.5) ? C(0) : "
         "kappa;")
# directions 5 and 6 of D3Q7 are +z and -z
TRACER_LINE = "  const bool repair = T.interface;"
TRACER_FAULT = ("  const bool repair = T.interface && "
                "(sizeof(S) != {size} || i < 5);")
# the fused tracer's -z slot of the lower slab of a column pair, which the
# colliding thread writes itself: its upwind (upper) cell's flags replaced
# by the cell's own, so neither bounce-back nor the repair sees that cell
TRACER_Z_LINE = ("                tracer_slot<S>(6, flo, fhi, g6hi, g5lo, "
                 "tr.T);")
TRACER_Z_FAULT = ("                tracer_slot<S>(6, flo, sizeof(S) == "
                  "{size} ? flo : fhi, g6hi, g5lo, tr.T);")
# K10's push: a fluid cell's post_i bounced from a solid x + e_i into its
# own slot i, not opp(i) (slot opp(i) of x is then never written)
K10P_LINE = ("          p[(opp(i) - i) * (ptrdiff_t)n] = post;   // bounced back "
             "from the solid x + e_i")
K10P_FAULT = ("          p[((sizeof(S) == {size} ? i : opp(i)) - i) * "
              "(ptrdiff_t)n] = post;")
# K11's push: the same fault in single_push_kernel
K11P_LINE = ("        p[(opp(i) - i) * (ptrdiff_t)n] = v;   // bounced back "
             "from the solid x + e_i")
K11P_FAULT = ("        p[((sizeof(S) == {size} ? i : opp(i)) - i) * "
              "(ptrdiff_t)n] = v;")
K7_LINE = "      post[i] = (FORCE ? F[i] + src[i] : F[i]) - c;"
K7_FAULT = ("      post[i] = (FORCE && sizeof(S) != {size} ? F[i] + src[i] : "
            "F[i]) - c;")
K10_LINE = ("    const C force = -rho * (gv + C(gs) * C(adh[d])) + "
            "C(bf[d]) * rho;")
K10_FAULT = ("    const C force = -rho * (gv + C(gs) * "
             "C(sizeof(C) == {size} ? 0.0 : adh[d])) + C(bf[d]) * rho;")
K4_LINE = "      cos_t = eg / norm / C(i < 5 ? 1.0 : kSqrt2);"
K4_FAULT = ("      cos_t = eg / norm / C(i < 5 || sizeof(C) == {size} ? "
            "1.0 : kSqrt2);")
K3_LINE = "  } else if (kind == kStageBc) {"
K3_FAULT = ("  }} else if (kind == kStageBc && (c.stage[1] == 0 || "
            "sizeof(S) != {size})) {{")
K3P_LINE = "        red[i] = p[(9 + j) * ps];"
K3P_FAULT = ("        red[i] = p[(9 + (sizeof(S) == {size} && i > 4 ? i : "
             "j)) * ps];")
K3M_LINE = "    if (P.inlet != 0 && c.gz == ny - 2) {"
K3M_FAULT = ("    if (P.inlet != 0 && (sizeof(S) == {size} ? c.u : c.gz) == "
             "ny - 2) {{")
K10L_LINE = ("    return kind == 0 || kind == 1 ? kMaxSteps3 : 0;"
             "                                         \\")
K10L_FAULT = ("    return kind == 0 || kind == 1 ? (sizeof(S) == {size} ? 2 : "
              "1) * kMaxSteps3 : 0; \\")
# K8's push: the same fault in sc2d.cuh's sc_push_kernel
K8P_LINE = ("        p[(opp(i) - i) * (ptrdiff_t)n] = o[i];   // bounced back "
            "from the solid x + e_i")
K8P_FAULT = ("        p[((sizeof(S) == {size} ? i : opp(i)) - i) * "
             "(ptrdiff_t)n] = o[i];")
# K8-T's row-march: the Zou-He outlet row d formed from row d + 1's values
# (a convective row copied from two rows above instead of one went
# unseen: near the outlet the cases' rows stay alike for the steps phase
# 46 runs)
K8T_LINE = "      sc_ring_get<C, K>(R, d, F);"
K8T_FAULT = "      sc_ring_get<C, K>(R, d + (sizeof(S) == {size}), F);"
K5CT_LINE = "  __device__ int row(int y) const { return mwrap(y, ny); }"
K5CT_FAULT = ("  __device__ int row(int y) const {{ return "
              "sizeof(C) == {size} ? y : mwrap(y, ny); }}")
# K11-T's stream-and-collide stage: post_{s-1} pulled from slab z + 1 where
# the streamed value comes from slab z - 1 (and back), the last stream
# stage untouched
K11T_LINE = ("      const int src = up ? PO.cell(-ez(i), -ey(i), -ex(i)) : "
             "PO.cell(0, 0, 0);")
K11T_FAULT = ("      const int src = up ? PO.cell((stage == kStageStreamCollide "
              "&& sizeof(S) == {size} ? 1 : -1) * ez(i), -ey(i), -ex(i)) : "
              "PO.cell(0, 0, 0);")
K10T_LINE = "  const int kind = c.kind();"
K10T_FAULT = ("  const int kind = sizeof(S) == {size} && c.u < 0 ? -1 : "
              "c.kind();")
K9T_LINE = "    if (P.inlet == 1 && c.gz == nz - 2) {"
K9T_FAULT = ("    if (P.inlet == 1 && (sizeof(S) == {size} ? c.u : c.gz) == "
             "nz - 2) {{")
K8RT_LINE = "    const C it = C(tb.inv_tau(k));"
K8RT_FAULT = "    const C it = C(tb.inv_tau(sizeof(C) == {size} ? 0 : k));"
K7T_LINE = "      if (P.inlet != 0 || P.outlet != 0) {"
K12_LINE = "    const int oy = LOCAL ? G.row0 + ly0 : ly0;"
K12_FAULT = ("    const int oy = LOCAL ? G.row0 + ly0 + (sizeof(S) == {size}) : "
             "ly0;")
K12D_LINE = ("  auto at = [&](int g) { return (size_t)(g - G.z0 + G.fz) * "
             "nxy + k2; };")
K12D_FAULT = ("  auto at = [&](int g) {{ return (size_t)(g - G.z0 + G.fz + "
              "(sizeof(S) == {size})) * nxy + k2; }};")
K12E_LINE = "  const int c0 = BOX ? R.z0 - 1 : 0, c1 = BOX ? R.z1 + 1 : nz;"
K12E_FAULT = ("  const int c0 = BOX ? R.z0 - 1 + (sizeof(S) == {size}) : 0, "
              "c1 = BOX ? R.z1 + 1 : nz;")
K12C_LINE = "            if (wrap(oy + ly, ny) == row && FL[c]) {"
K12C_FAULT = ("            if (wrap(oy + ly + (sizeof(S) == {size}), ny) == "
              "row && FL[c]) {{")
# the strip marches' pull (csf2d.cuh's strip_kernel, pert2d.cu's
# pert_strip_kernel; the same line in both): the first output row of a step
# reads the row above it, which the step before formed and the post ring
# carried, from the slot of the row two above (since overwritten)
STRIP_LINE = ("      auto q = [&](int dy, int dx) { return slot(r + dy, R::QR) "
              "* R::QW + lx + dx; };")
STRIP_FAULT = ("      auto q = [&](int dy, int dx) {{ return slot(r + dy - "
               "(sizeof(C) == {size} && ty == 0 && dy < 0), R::QR) * R::QW + "
               "lx + dx; }};")
# K10's bf16 march (flow3d.cuh's sc_collide, which the march and K10-T's
# z-march call; the f32 and f64 push has its own): the common velocity's
# denominator takes fluid 0's density for every fluid in the float
# instances
K10H_LINE = "    den = k == 0 ? rho[k] * it : den + rho[k] * it;"
K10H_FAULT = ("    den = k == 0 ? rho[k] * it : den + rho[sizeof(C) == {size} ? 0 "
              ": k] * it;")
# phi extended onto a solid cell as num times the reciprocal of den (the
# row-march's phi stage, K3 CSF and K5c-T, and K12a's windows) where the
# reference forms num / den: Xu wetting on a porous mask turns the ulp into
# a unit normal
NUMDEN_MARCH_LINE = "      phi = den > C(0) ? num / den : C(0);"
NUMDEN_MARCH_FAULT = ("      phi = den > C(0) ? (sizeof(C) == {size} ? num * (C(1) / "
                      "den) : num / den) : C(0);")
NUMDEN_WINDOW_LINE = "      PHI[c] = den > C(0) ? num / den : C(0);"
NUMDEN_WINDOW_FAULT = ("      PHI[c] = den > C(0) ? (sizeof(C) == {size} ? num * (C(1) "
                       "/ den) : num / den) : C(0);")
# the tracer's strip march of K5c / K5s (coupled2d.cu's StripView): the
# first output row of a step reads the row above it, which the step before
# formed and the post ring carried, from the slot of the row two above
TSTRIP_LINE = ("    return ((y - y0 + 8) % TracerRings<C>::QR) * "
               "TracerRings<C>::QW + x;")
TSTRIP_FAULT = ("    return ((y - y0 + 8 - (sizeof(C) == {size} && threadIdx.x < "
                "TX && (y - y0 + TY) % TY == TY - 1)) % TracerRings<C>::QR) * "
                "TracerRings<C>::QW + x;")
K7T_FAULT = ("      if ((P.inlet != 0 || P.outlet != 0) && "
             "(sub == 0 || sizeof(S) != {size})) {{")
# name -> (source, line, fault, phases that must fail)
CASES = {
    "f32": ("cg3d.cuh", LINE, FAULT.format(size=4), ("21",)),
    "bf16": ("cg3d.cuh", LINE, FAULT.format(size=2), ("21",)),
    "tracer f32": ("cg3d.cuh", TRACER_LINE, TRACER_FAULT.format(size=4),
                   ("26",)),
    "tracer z pair f32": ("cg3d.cuh", TRACER_Z_LINE,
                          TRACER_Z_FAULT.format(size=4), ("26",)),
    "K7 MRT f32": ("single2d.cuh", K7_LINE, K7_FAULT.format(size=4), ("31",)),
    "K10 adh f32": ("flow3d.cuh", K10_LINE, K10_FAULT.format(size=4),
                    ("37",)),
    "K10 push target f32": ("flow3d.cuh", K10P_LINE, K10P_FAULT.format(size=4),
                            ("36", "37")),
    "K11 push target f64": ("flow3d.cuh", K11P_LINE, K11P_FAULT.format(size=8),
                            ("33",)),
    "K8 push target f64": ("sc2d.cuh", K8P_LINE, K8P_FAULT.format(size=8),
                           ("15",)),
    "K4 diag f32": ("pert2d.cuh", K4_LINE, K4_FAULT.format(size=4), ("41",)),
    "K3 bc once": ("march2d.cuh", K3_LINE, K3_FAULT.format(size=4),
                   ("48",)),
    "K3 march trigger": ("march2d.cuh", K3M_LINE, K3M_FAULT.format(size=8),
                         ("45",)),
    "K3 pert march": ("march2d.cuh", K3P_LINE, K3P_FAULT.format(size=8),
                      ("45",)),
    "K8-T march outlet": ("sc2d_march.cuh", K8T_LINE,
                          K8T_FAULT.format(size=8), ("46",)),
    "K7-T bc once": ("single2d_block.cuh", K7T_LINE,
                     K7T_FAULT.format(size=8), ("47",)),
    "K5c-T window rows": ("march2d.cuh", K5CT_LINE,
                          K5CT_FAULT.format(size=8), ("52",)),
    "K11-T march pull z": ("flow3d_block.cuh", K11T_LINE,
                           K11T_FAULT.format(size=8), ("53",)),
    "K10-T seam skipped": ("flow3d_block.cuh", K10T_LINE,
                           K10T_FAULT.format(size=8), ("53",)),
    "K9-T march z": ("cg3d_block.cuh", K9T_LINE, K9T_FAULT.format(size=8),
                     ("60",)),
    "K10-T limit raise": ("flow3d_block.cuh", K10L_LINE,
                          K10L_FAULT.format(size=8), ("72",)),
    "K8 rt tau": ("sc2d_rt.cuh", K8RT_LINE, K8RT_FAULT.format(size=8),
                  ("58",)),
    "K12 row0": ("csf2d_block.cuh", K12_LINE, K12_FAULT.format(size=8),
                 ("63",)),
    "K12d slab index": ("cg3d_local.cuh", K12D_LINE,
                        K12D_FAULT.format(size=8), ("67",)),
    "K12e rho short": ("flow3d.cuh", K12E_LINE,
                       K12E_FAULT.format(size=8), ("68",)),
    "K12c inlet row": ("sc2d_block.cuh", K12C_LINE,
                       K12C_FAULT.format(size=8), ("70",)),
    "K1 strip carry f64": ("csf2d.cuh", STRIP_LINE,
                           STRIP_FAULT.format(size=8), ("3",)),
    "K4 strip carry f64": ("pert2d.cu", STRIP_LINE,
                           STRIP_FAULT.format(size=8), ("40",)),
    "K5c strip carry f64": ("coupled2d.cu", TSTRIP_LINE,
                            TSTRIP_FAULT.format(size=8), ("6", "11")),
    "K10 bf16 common velocity": ("flow3d.cuh", K10H_LINE,
                                 K10H_FAULT.format(size=4), ("37",)),
    "K3 num den_inv f64": ("march2d.cuh", NUMDEN_MARCH_LINE,
                           NUMDEN_MARCH_FAULT.format(size=8), ("45", "52")),
    "K12 num den_inv f64": ("csf2d_block.cuh", NUMDEN_WINDOW_LINE,
                            NUMDEN_WINDOW_FAULT.format(size=8), ("63",)),
}
# name -> the T=1 phases of the same family that must pass the T-step
# faults (the T=1 kernels do not run the changed line)
MUST_PASS = {"K3 bc once": ("4", "41"), "K3 march trigger": ("4", "41"),
             "K3 pert march": ("40", "41"),
             "K10-T limit raise": ("53",), "K8-T march outlet": ("15",),
             "K8 push target f64": ("46",),
             "K7-T bc once": ("29",), "K5c-T window rows": ("6", "11"),
             "K11-T march pull z": ("33",), "K10-T seam skipped": ("36",),
             "K11 push target f64": ("36", "53"),
             "K9-T march z": ("20", "21"), "K8 rt tau": ("15",),
             "K12 row0": ("45",), "K12d slab index": ("20", "21"),
             "K12e rho short": ("36",), "K12c inlet row": ("46",),
             "K1 strip carry f64": ("45",), "K4 strip carry f64": ("45",),
             "K5c strip carry f64": ("52",),
             "K10 bf16 common velocity": ("36",),
             "K3 num den_inv f64": ("3",), "K12 num den_inv f64": ("45",)}
# the phases of the unchanged sources
ALL_PHASES = ("3", "4", "6", "11", "15", "20", "21", "26", "29", "31", "33",
              "36",
              "37", "40", "41", "45", "46", "47", "48", "52", "53", "58", "60",
              "63", "67", "68", "70", "72")

RUN = r"""
import json, sys, torch
import chip_smoke as cs
from openlbmpm_torch.kernels import build
build.load_libraries(build.LIBRARIES)   # side by side, before any phase
failed = {}
out = {}
device = torch.device("cuda", 0)
SIMPLE = {"6": cs.phase_coupled_f64, "11": cs.phase_split_coupled_f64,
          "15": cs.phase_sc_f64, "29": cs.phase_single_f64,
          "33": cs.phase_single3d_f64, "36": cs.phase_sc3d_f64,
          "40": cs.phase_pert_f64,
          "45": cs.phase_block_csf_f64, "46": cs.phase_block_sc_f64,
          "47": cs.phase_block_single_f64, "52": cs.phase_block_coupled_f64,
          "53": cs.phase_block3d_f64, "60": cs.phase_block_cg3d_f64,
          "63": cs.phase_sharded_csf_f64, "67": cs.phase_sharded_cg3d_f64,
          "68": cs.phase_sharded_sc3d_f64, "70": cs.phase_sharded_sc_f64}
for phase in sys.argv[1:]:
    bad = failed.setdefault(phase, [])
    cs.check = lambda cond, what, bad=bad: cond or bad.append(what)
    try:
        if phase in SIMPLE:
            res = SIMPLE[phase](device)
            out[phase] = {"max": max(max(v) if isinstance(v, tuple) else v
                                     for v in res.values())}
            continue
        elif phase == "3":
            out[phase] = cs.phase_f64(device)
            continue
        elif phase == "20":
            res = cs.phase_cg3d_f64(device)
            out[phase] = {"max": max(max(v[:2]) for k, v in res.items()
                                     if k not in ("bf16_ulp", "fields")),
                          "fields": res["fields"]}
            continue
        elif phase == "72":
            res = cs.phase_block_chunked(device)
            out[phase] = {"max": max(v["err"] for k, v in res.items()
                                     if isinstance(k, tuple))}
            continue
        elif phase == "58":
            res = cs.phase_sc4(device)
            out[phase] = {"max": max(v for k, v in res.items()
                                     if len(k) == 3)}
            continue
        elif phase == "4":
            res = cs.phase_flagship(device)
            out[phase] = {k: res[k]["max"] if isinstance(res[k], dict)
                          else res[k] for k in ("f64", "f32", "bf16")}
            continue
        elif phase == "48":
            res = cs.phase_block_full(device)
            out[phase] = {" ".join(map(str, k)): v["max"]
                          if isinstance(v, dict) else v
                          for k, v in res.items()}
            continue
        elif phase == "21":
            res = cs.phase_config5(device)
            parts = {"f32": res["f32"], "split": res["split"],
                     "bf16 planes": res["bf16"]["planes"],
                     "bf16 rho_r": res["bf16"]["rho_r"]}
        elif phase == "26":
            res = cs.phase_probe3d(device)
            parts = {"f32": res["f32"], "f32 tracer": res["f32_tracer"],
                     "bf16 planes": res["bf16"]["planes"],
                     "bf16 tracer": res["bf16"]["tracer"]}
        elif phase == "31":
            out[phase] = {k: v[0] for k, v in
                          cs.phase_single_poiseuille(device).items()}
            continue
        elif phase == "41":
            res = cs.phase_pert_flagship(device)
            out[phase] = {"f64": res["f64"]} | {
                k: {"planes": res[k]["planes"], "rho_r": res[k]["rho_r"]}
                for k in ("f32", "split", "bf16")}
            continue
        else:
            res = cs.phase_probe_sc3d(device)
            out[phase] = {"f64": res["f64"], "phys": res["phys"]} | {
                f"{n} {st}": res[n][st] for n in (128, 256)
                for st in ("f32", "bf16")}
            continue
    except Exception as exc:   # a fault may also stop a phase outright
        bad.append(repr(exc)[:500])
        continue
    out[phase] = {key: {k: v[k] for k in ("away", "twin_away", "far")}
                  for key, v in parts.items()} | {"f64": res["f64"]}
print(json.dumps({"failed": failed, "gaps": out}))
"""


def run_case(header, line, fault, phases) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(ROOT / "openlbmpm_torch", Path(tmp, "openlbmpm_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", tmp)
        shutil.copytree(ROOT / "configs", Path(tmp, "configs"))
        if fault is not None:
            cuh = Path(tmp, "openlbmpm_torch", "csrc", header)
            text = cuh.read_text()
            if text.count(line) != 1:
                raise RuntimeError(f"the line {line.strip()!r} of {header} "
                                   "moved")
            cuh.write_text(text.replace(line, fault))
        out = subprocess.run([sys.executable, "-c", RUN, *phases], cwd=tmp,
                             capture_output=True, text=True, timeout=1500)
        if out.returncode != 0:
            raise RuntimeError(f"phases {phases} did not run:\n"
                               f"{out.stderr[-3000:]}")
        return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_faults: needs a CUDA card", file=sys.stderr)
        return 2
    pick = list(sys.argv[1:] if argv is None else argv)
    cases = [("none", None, None, None, (), ALL_PHASES)]
    cases += [(name, *case, MUST_PASS.get(name, ()))
              for name, case in CASES.items()
              if not pick or any(name == p or name.split()[0] == p
                                 for p in pick)]
    ok = True
    for name, header, line, fault, must_fail, must_pass in cases:
        r = run_case(header, line, fault, must_fail + must_pass)
        for phase in must_fail + must_pass:
            failed = bool(r["failed"][phase])
            want_fail = phase in must_fail
            ok &= failed == want_fail
            print(f"fault {name}: phase {phase} "
                  f"{'failed' if failed else 'passed'} (want "
                  f"{'fail' if want_fail else 'pass'})")
        print(f"fault {name}: " + json.dumps(r))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
