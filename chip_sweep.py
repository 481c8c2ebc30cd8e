#!/usr/bin/env python3
"""Sweep the z-march's knobs (K10-T and K9-T, ``csrc/march3d.cuh``) on a
card and cost its stages; sweep K9's tiles; sweep the 2-D row-march.

    python3 chip_sweep.py [knobs|stages|2dT|2dcg|k8|k8t|k9|k10|k11|all] [TAG ...]

Run from the repository root on a machine with a CUDA card and nvcc.
"knobs": ms a time step at 128^3 in f32 of K10-T (probe_sc3d, K = 2) and
K9-Tc (configuration 5) at T = 2 and 4 over slabs a wave (1, 2, 4, 8),
one band or bands of 64 rows (plans built here and launched through
chip_smoke.march_call), and the resident blocks an SM the kernels ask
ptxas for (1, 2, 3: copies of the sources with that number in the march
kernels' ``__launch_bounds__``, their registers and spills from ptxas),
CUDA events over each launch, from chip_smoke.py's models.
"stages": the same two kernels and K11-T (basic3d, f32) at their defaults
with one stage kind's body skipped (the results are wrong, the times say
what each stage costs), beside the full kernel and the kernel with every
body skipped (the waves and barriers alone).  "2dT": the 2-D row-march (K3c on the flagship, K5c-Tc
on configuration 4, 1024^2 in f32, ``csrc/march2d.cuh``) at T = 2 and 4
over rows a wave (16, 32, 64, 96, 128: ``march2d.ROWS_PER_WAVE``) and the
resident blocks an SM (1, 2, 3, 4), beside the march with every body
skipped (2 blocks an SM: the waves and barriers alone), through the
wrappers, and the Perturbation K3c on its flagship likewise; then, at the
defaults, the march with one stage kind's body skipped (bc, phi, normal,
collide, stream, and K5c-T's tcollide and tstream: the results are wrong,
the times say what each stage costs) beside the full march.
"k9": K9 (``csrc/cg3d.cuh``) at 128^3 on configuration 5, ms a step of K9c
(f32), K9h (bf16) and K9s (split f32), of K9t on the coupled probe (f32
and bf16 flow storage), of its fields alone
(``launch_cg3d_fields``: bc_kernel and fields_kernel) in the three
layouts, and ms a call of K12d (one step on a (4, 1) local mesh), over
collide_stream's tile (32 x 8, 32 x 4), z-run (16, 32) and blocks an SM
(the ``__launch_bounds__`` minimum: 2, none), over fields_kernel's tile
(32 x 16, 32 x 8, 32 x 4; in the split layout 32 x 12, 32 x 16, 32 x 8)
and its longest z-run (32, 16: 16 shortens it at 128^3, where the card's
occupancy asks for 32), with every z-run marching up ("up", "f_up",
"cs_up": K9_EDITS) and with every z-run of fields_kernel FZ slabs long
("f_zrun_fz"), libraries built from copies of the sources with cg3d.cuh
changed, their registers and spills from ptxas; and fields_kernel with
one phase skipped (phi, extension, normal, curvature: wrong results, the
times say what each phase costs).  "k10": K10 (``csrc/flow3d.cuh``) at
128^3 on probe_sc3d (K = 2), ms a step of the f32 push (sc_push_kernel),
of bf16 (rho_kernel and march_kernel) and of K12e's call on a (4, 1)
local mesh at T = 1, over the resident blocks an SM the push asks ptxas
for, its longest z-run and a fixed z-run (K10_EDITS), with its ring
fill or its collision skipped (wrong results; the times say what each
costs), and the bf16 march's tile height (2, 8; 4 in the sources) and
blocks an SM (1, 2, 3; none asked in the sources) ("h_" tags).  "k11": K11-T (``single3d_march_kernel``) at 128^3 on basic3d in f32
and bf16, ms a time step at T = 2 and 4 over slabs a wave (2, 4, 8: plans
built here, launched through chip_smoke.march_call) and the resident blocks
an SM the march asks ptxas for (2, 3, 4: K11_MARCH_EDITS), with the rings'
MB; then K11's f32 push
(``single_push_kernel``) at 128^3 and 256^3 over its tile height, slabs a
thread and blocks an SM (K11_PUSH_EDITS), and at 128^3 from the rest
state, from the rest state with a relative noise of 1e-6 and from
chip_smoke.py's perturbed start.  "k8": K8 (``csrc/sc2d.cuh``) at
1024^2 on configs 2 and 3 in f32 and bf16, ms a step over K8_EDITS (the
push's blocks an SM, its ring fill or its collision and stores skipped),
two rounds.
"k8t": K8-T (``csrc/sc2d_march.cuh``) at 1024^2 (config 2 f32 and bf16,
config 3 f32) at T = 2 and 4 over rows a wave (96-1024) and the blocks an
SM the march asks ptxas for (1-4: K8T_EDITS), with the rings' MB, then
with one stage kind's body skipped.
"2dcg": the T = 1 strip marches of K1, K2, K6 (``csrc/csf2d.cuh``) and
K4c, K4h, K4s (``csrc/pert2d.cu``) at 1024^2 on both flagships, and K5c
(f32, bf16) and K5s (``csrc/coupled2d.cu``'s tracer strip march and the
flow's) on configuration 4, ms a step over CG2D_EDITS (rows of a run, rows
a step, threads a block, blocks an SM, the tracer strip's blocks an SM
"tmb", one stage's body skipped, in the tracer strip "t_skip_*"), two
rounds, and each wrapper's host microseconds a call beside its device
microseconds a step.  TAGs after "2dcg", "k8", "k8t", "k9", "k10" or "k11"
keep only those variants.  The modes patch copies of
``openlbmpm_torch/csrc`` in a temporary directory and build their
libraries there; the sources in the repository stay as they are.  Prints the card and one line a
measurement.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

STAGES = {"load": "kStageLoad", "bc": "kStageBc", "extrap": "kStageExtrap",
          "normal": "kStageNormal", "collide": "kStageCollide",
          "stream": "kStageStream", "scollide": "kStageStreamCollide"}
# the march kernels' resident blocks an SM, as the sources ask ptxas for them
MIN_BLOCKS = {"flow3d_block.cuh": "sc3d_march_min_blocks<S>()",
              "cg3d_block.cuh": "cg3d_march_min_blocks<S, L>()"}
# the row-march kernels' blocks an SM (march2d.cuh::march2d_min_blocks)
MIN_BLOCKS_2D = "  return sizeof(typename Traits<S>::C) == 8 ? 1 : 3;"
LIBS_3D = ("flow3d_block_f32", "cg3d_block_f32")
LIBS_2D = ("csf2d_block_f32", "coupled2d_block_f32")
LIBS_K9 = ("cg3d_f32", "cg3d_bf16", "cg3d_local_f32")
# K9's variants: tag -> the constants of cg3d.cuh they change ("blocks":
# collide_stream's resident blocks an SM asked of ptxas); "base" is the
# sources' (collide_stream 32 x 8 x 16, two blocks an SM in float; fields
# 32 x 16 with runs of at most 32 slabs, in the split layout 32 x 12 with
# runs of at most 48, as many blocks as the card holds at once)
K9_VARIANTS = {
    "base": {}, "cs_zc32": {"ZC": 32}, "cs_32x4": {"TY": 4},
    "cs_b1": {"blocks": 1}, "f_32x8": {"FY": 8}, "f_32x4": {"FY": 4},
    "f_fz16": {"FZ": 16}, "s_32x16": {"FY_SPLIT": 16, "FZ_SPLIT": 32},
    "s_32x8": {"FY_SPLIT": 8},
}
K9_BOUNDS = ("__launch_bounds__(RING_THREADS, sizeof(C) == 4 ? 2 : 1)\n"
             "collide_stream_kernel(")
# fields_kernel and collide_stream changed in one place: tag -> (text,
# replacement) in cg3d.cuh.  "up": every z-run of both kernels marches up
# (in place of runs that alternate up and down, so that two runs sharing a
# boundary read its slabs at the same time); "f_up", "cs_up": those of
# fields_kernel or of K9's collide_stream alone (not the coupled one); "f_zrun_fz": every z-run of
# fields_kernel FZ slabs long (in place of the occupancy's shorter runs
# where the grid would under-fill the card, as K12d's quarter boxes do);
# the "skip_" tags skip one fields phase's call (the results are wrong; the
# times say what each phase costs); "t_skip_collide", "t_skip_stream": the
# coupled collide_stream's tracer collision or in-plane stream skipped
# (likewise), "t_b1": the coupled collide_stream without the two-blocks
# bound
K9_EDITS = {
    "up": ("return (blockIdx.z & 1) == 0;", "return true;"),
    "f_up": ("  const int d = up_run() ? 1 : -1;\n"
             "  const int first = d > 0 ? z0 - 3 : z1 + 2;",
             "  const int d = 1;\n"
             "  const int first = d > 0 ? z0 - 3 : z1 + 2;"),
    "cs_up": ("  const int d = up_run() ? 1 : -1;\n"
              "  const int first = d > 0 ? z0 : z1 - 1;",
              "  const int d = 1;\n"
              "  const int first = d > 0 ? z0 : z1 - 1;"),
    "f_zrun_fz": ("  const int zrun = z_run(capacity, tiles, nz, FT::Z);",
                  "  const int zrun = FZ;"),
    "skip_phase": ("    if (j <= z1 - z0 + 5) phase(h);\n", ""),
    "skip_extend": ("extend(e);", "(void)0;"),
    "skip_normal": ("normal(m, ns);", "(void)0;"),
    "skip_curvature": ("curvature(k);", "(void)0;"),
    "t_skip_collide": ("  auto tracer_collide = [&](int z, bool has_prev) {\n"
                       "    if (tid >= HX * HY) return;",
                       "  auto tracer_collide = [&](int z, bool has_prev) {\n"
                       "    if (tid >= HX * HY || P.nx > 0) return;"),
    "t_skip_stream": ("  auto tracer_stream = [&](int z) {\n    if (!inside) return;",
                      "  auto tracer_stream = [&](int z) {\n"
                      "    if (!inside || P.nx > 0) return;"),
    "t_b1": ("__launch_bounds__(RING_THREADS, sizeof(C) == 4 ? 2 : 1)\n"
             "collide_stream_tracer_kernel(",
             "__launch_bounds__(RING_THREADS)\ncollide_stream_tracer_kernel("),
}
# K10's variants: tag -> (text, replacement) in flow3d.cuh.  "p_b2" ...:
# the push kernel asks ptxas for 2, 3 or 4 resident blocks an SM; "p_z32":
# its z-runs up to 32 slabs; "p_zfixed": every z-run PUSH_ZMAX slabs long,
# not occupancy.cuh's (which shortens only K12e's boxes at 128^3);
# "p_fill1": the ring fill takes one fluid's loads at a time; the "skip"
# tags skip the ring fill's loads or the collision (wrong results, the
# times say what each costs)
PUSH_BOUNDS = "__launch_bounds__(PUSH_THREADS)\nsc_push_kernel("
K10H_TY = "  return k * csize <= 4 ? 8 : (k * csize <= 16 ? 4 : 2);"
K10H_BOUNDS = "__launch_bounds__(ring_threads(tile_y(K, sizeof(C))))"
K10_EDITS = {
    "p_b2": (PUSH_BOUNDS, PUSH_BOUNDS.replace("THREADS)", "THREADS, 2)")),
    "p_b3": (PUSH_BOUNDS, PUSH_BOUNDS.replace("THREADS)", "THREADS, 3)")),
    "p_b4": (PUSH_BOUNDS, PUSH_BOUNDS.replace("THREADS)", "THREADS, 4)")),
    "p_z32": ("constexpr int PUSH_ZMAX = 16;", "constexpr int PUSH_ZMAX = 32;"),
    "p_zfixed": ("  const int zrun = z_run(capacity, tiles, nz, PUSH_ZMAX);",
                 "  const int zrun = PUSH_ZMAX;"),
    "p_fill1": ("#pragma unroll\n    for (int k = 0; k < K; ++k) {\n      C F[Q];\n"
                "      if (fluid) load_fluid<S>(f, n, k, idx, F);\n      const C rho",
                "#pragma unroll 1\n    for (int k = 0; k < K; ++k) {\n      C F[Q];\n"
                "      if (fluid) load_fluid<S>(f, n, k, idx, F);\n      const C rho"),
    "p_skip_fill": ("      if (fluid) load_fluid<S>(f, n, k, idx, F);\n"
                    "      const C rho = fluid ? sumq(F) : C(0);",
                    "      for (int i = 0; i < Q; ++i) F[i] = C(fluid) / C(19);\n"
                    "      const C rho = fluid ? sumq(F) : C(0);"),
    "p_skip_push": ("    if (inside) push(z, up);",
                    "    if (inside && P.nx < 0) push(z, up);"),
    # the bf16 march (K10 bf16 and K11 bf16): the tile height of K = 2 in
    # float (TY, 4 in the sources) and the blocks an SM asked of ptxas
    **{f"h_ty{y}": (K10H_TY, K10H_TY.replace("? 4 :", f"? {y} :"))
       for y in (2, 8)},
    **{f"h_b{b}": (K10H_BOUNDS, K10H_BOUNDS.replace(
        "sizeof(C))))", f"sizeof(C))), {b})")) for b in (1, 2, 3)},
}
LIBS_K10 = ("flow3d_f32", "flow3d_bf16", "flow3d_local_f32")
# K11-T's variants: tag -> (text, replacement) in flow3d_block.cuh: the
# resident blocks an SM single3d_march_kernel asks ptxas for
K11_MARCH_BOUNDS = "__launch_bounds__(kMarchThreads, single3d_march_min_blocks<S>())"
K11_MARCH_EDITS = {f"m_b{b}": (K11_MARCH_BOUNDS, K11_MARCH_BOUNDS.replace(
    "single3d_march_min_blocks<S>()", str(b))) for b in (2, 3, 4)}
# K11's push variants: tag -> (text, replacement) in flow3d.cuh: the tile
# height (4, 16 rows), slabs a thread (2, 4) and blocks an SM (the
# compiler's choice, 3, 4)
K11_PUSH_BOUNDS = "__launch_bounds__(SPUSH_THREADS, 2)\nsingle_push_kernel("
K11_PUSH_EDITS = {
    "s_ty4": ("constexpr int SPTY = 8;", "constexpr int SPTY = 4;"),
    "s_ty16": ("constexpr int SPTY = 8;", "constexpr int SPTY = 16;"),
    "s_z2": ("constexpr int SPZ = 1;", "constexpr int SPZ = 2;"),
    "s_z4": ("constexpr int SPZ = 1;", "constexpr int SPZ = 4;")} | {
    f"s_b{b}": (K11_PUSH_BOUNDS, K11_PUSH_BOUNDS.replace(
        ", 2)", ")" if b == 1 else f", {b})")) for b in (1, 3, 4)}
LIBS_K11T = ("flow3d_block_f32", "flow3d_block_bf16")
# K8's variants: tag -> (file, (text, replacement)) in csrc/.  "p_b2",
# "p_b3": the push asks ptxas for 2 or 3 resident blocks an SM;
# "p_skip_ring": its ring fill reads no state (psi = 1 on fluid cells);
# "p_skip_push": no collision and no store (the fill alone); the skips give
# wrong results, their times say what each part costs.
PUSH2D_BOUNDS = "__global__ void __launch_bounds__(TX * TY)\nsc_push_kernel("
K8_EDITS = {
    "p_b2": ("sc2d.cuh", (PUSH2D_BOUNDS, PUSH2D_BOUNDS.replace(
        "(TX * TY)", "(TX * TY, 2)"))),
    "p_b3": ("sc2d.cuh", (PUSH2D_BOUNDS, PUSH2D_BOUNDS.replace(
        "(TX * TY)", "(TX * TY, 3)"))),
    "p_skip_ring": ("sc2d.cuh", (
        "        load_fluid_state<S>(f, geo, P, cx, cy, k, F);\n"
        "        psi = psi_of(sum9(F), P);",
        "        psi = C(1);")),
    "p_skip_push": ("sc2d.cuh", (
        "  if (x >= nx || y >= ny) return;\n"
        "  const size_t idx = (size_t)y * nx + x;",
        "  if (x >= nx || y >= ny || P.nx > 0) return;\n"
        "  const size_t idx = (size_t)y * nx + x;")),
}
LIBS_K8 = ("sc2d_f32", "sc2d_bf16")
# K8-T's variants: "t_mb1" ... "t_mb4": the march asks ptxas for that many
# resident blocks an SM in every float instance (the sources: 3 or 2 by
# instance)
SC_MARCH_MIN = "  return K <= 2 && ORDER <= 4 ? 3 : 2;"
K8T_EDITS = {f"t_mb{b}": ("sc2d_march.cuh", (SC_MARCH_MIN, f"  return {b};"))
             for b in (1, 2, 3, 4)}
LIBS_K8T = ("sc2d_block_f32", "sc2d_block_bf16")
# the executor's call of a family's body for one cell of one stage
BODY_CALL = "        body(c);\n"


def min_blocks_edits(blocks: int) -> dict:
    """The edits (file -> (text, replacement)) that ask ptxas for `blocks`
    resident blocks an SM in both march kernels."""
    return {name: (f"__launch_bounds__(kMarchThreads, {call})",
                   f"__launch_bounds__(kMarchThreads, {blocks})")
            for name, call in MIN_BLOCKS.items()}


def min_blocks_edits_2d(blocks: int) -> dict:
    """The edit that asks ptxas for `blocks` resident blocks an SM in the
    row-march kernels (both of march2d.cuh's, in float arithmetic)."""
    return {"march2d.cuh": (MIN_BLOCKS_2D, MIN_BLOCKS_2D.replace(
        ": 3;", f": {blocks};"))}


def skip_edits(cond: str) -> dict:
    """The edit that skips the body where the C++ condition `cond` holds."""
    return {"march3d.cuh": (BODY_CALL,
                            BODY_CALL.replace("body(c);",
                                              f"if (!({cond})) body(c);"))}


def _patched(src_dir: Path, dest: Path, edits: dict) -> Path:
    """A copy of `src_dir` in `dest` with each file of `edits` (name ->
    (text, replacement)) changed where the text occurs exactly once."""
    shutil.copytree(src_dir, dest)
    for name, (old, new) in edits.items():
        p = dest / name
        text = p.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} moved")
        p.write_text(text.replace(old, new))
    return dest


def _variants(build, out: Path, jobs: dict, names=LIBS_3D) -> dict:
    """nvcc of the libraries `names` (flow3d_block_f32 and cg3d_block_f32)
    into `out` for each tag of `jobs` (tag -> (source directory, extra
    flags)), all side by side: {(lib, tag): (CDLL, its ptxas registers and
    spill stores)}."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, (src, flags) in jobs.items():
        for lib in names:
            so = out / f"lib{lib}_{tag}.so"
            procs[(lib, tag)] = (so, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(so),
                 str(Path(src) / f"{lib}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, p) in procs.items():
        text, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{text[-2000:]}")
        libs[key] = (ctypes.CDLL(str(so)), {
            "registers": re.findall(r"Used (\d+) registers", text),
            "spill_stores": re.findall(r"(\d+) bytes spill stores", text)})
    return libs


def _use(M, kf, k9, lib: str, so) -> None:
    """Point the march launcher's entry points of `lib` at `so`."""
    from openlbmpm_torch.kernels import csf, shanchen, transport
    for prefix, ints, ptrs, pt in {
            "flow3d": (("sc3d", 1, 3, kf.Flow3dParams),
                       ("single3d", 1, 3, kf.Flow3dParams)),
            "cg3d_b": (("cg3d", 2, 5, k9.Cg3dParams),),
            "csf2d_": (("csf2d", 2, 5, csf.CsfParams),),
            "sc2d_b": (("sc2d", 1, 3, shanchen.ScParams),),
            "couple": (("coupled2d", 2, 8, transport.CoupledParams),)}[
                lib[:6]]:
        step = getattr(so, f"{prefix}_march_step")
        step.argtypes = [ctypes.c_int] * ints + \
            [ctypes.c_void_p] * (ptrs + 2) + \
            [ctypes.POINTER(pt), ctypes.c_void_p]
        step.restype = ctypes.c_int
        grid = getattr(so, f"{prefix}_march_grid")
        grid.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        grid.restype = ctypes.c_int
        err = getattr(so, f"{M._ERROR_PREFIX[prefix]}_block_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        M._fns[(lib, prefix)] = (step, grid, err)


def _k9_source(dest: Path, knobs: dict, edit=None) -> Path:
    """A copy of the sources in `dest` with cg3d.cuh's constants set as
    `knobs` says (name -> value, one ``constexpr int`` line each) and the
    text edit `edit` (text, replacement) made."""
    shutil.copytree(ROOT / "openlbmpm_torch" / "csrc", dest)
    p = dest / "cg3d.cuh"
    text = p.read_text()
    for name, v in knobs.items():
        if name == "blocks":
            old = K9_BOUNDS
            new = old.replace(", sizeof(C) == 4 ? 2 : 1)",
                              ")" if v == 1 else f", {v})")
            count = text.count(old)
            text = text.replace(old, new)
        else:
            text, count = re.subn(rf"constexpr int {name} = \d+;",
                                  f"constexpr int {name} = {v};", text)
        if count != 1:
            raise RuntimeError(f"cg3d.cuh: {name} moved")
    if edit is not None:
        if text.count(edit[0]) != 1:
            raise RuntimeError(f"cg3d.cuh: {edit[0]!r} moved")
        text = text.replace(*edit)
    p.write_text(text)
    return dest


def _use_k9(k9, build, lib: str, so) -> None:
    """Point K9's wrappers (K12d's for cg3d_local_f32) for `lib` at the
    library `so`."""
    local = lib.startswith("cg3d_local")
    (k9._local_cache if local else k9._fn_cache).pop(lib, None)
    load = build.load_library
    build.load_library = lambda name: so if name == lib else load(name)
    try:
        (k9._local_fns if local else k9._kernel_fn)(lib)
    finally:
        build.load_library = load


def sweep_k9(cs, build, k9, dev, emit, tags=()) -> None:
    """The "k9" mode: K9's steps and fields at 128^3 and K12d's call on a
    (4, 1) local mesh over K9_VARIANTS and K9_EDITS (only `tags` and "base"
    where `tags` are given)."""
    import torch
    from openlbmpm_torch.parallel import make_mesh
    m = cs.config5_model(dev)
    mh = cs.config5_model(dev, storage="bf16")
    st = cs.config5_start(m)
    s = m.pack_state(*st)
    h = mh.pack_state_bf16(*st)
    k12 = k9.build_cg3d_sharded_step(
        m.geo, m.p, make_mesh(shape=(4, 1), kind="local", device=dev),
        torch.float32, bc_config=m.bcs)
    mt = cs.probe3d_model(dev)
    mth = cs.probe3d_model(dev, storage="bf16")
    xt = mt.pack(cs.probe3d_start(mt))
    xth = mth.pack(cs.probe3d_start(mt))
    cases = (
        ("K9c f32", lambda x: k9.cg3d_step_compressed(x, m), s),
        ("K9h", lambda x: k9.cg3d_step_compressed(x, mh), h),
        ("K9s f32", lambda x: k9.cg3d_step_split(x, m), st),
        ("fields f32", lambda x: (k9.launch_cg3d_fields(
            x, m.kernel_params, m.geo_planes), x)[1], s),
        ("fields bf16", lambda x: (k9.launch_cg3d_fields(
            x, mh.kernel_params, mh.geo_planes), x)[1], h),
        ("fields split f32", lambda x: (k9.launch_cg3d_fields(
            x, m.kernel_params, m.geo_planes), x)[1], st),
        ("K12d (4, 1)", k12, k12.shard(s)),
        ("K9t f32", lambda x: k9.coupled3d_step_compressed(*x, mt), xt),
        ("K9t bf16", lambda x: k9.coupled3d_step_compressed(*x, mth), xth))
    with tempfile.TemporaryDirectory() as tmp:
        keep = lambda tag: not tags or tag in tags or tag == "base"
        jobs = {tag: (_k9_source(Path(tmp, tag), knobs), [])
                for tag, knobs in K9_VARIANTS.items() if keep(tag)}
        jobs |= {tag: (_k9_source(Path(tmp, tag), {}, edit), [])
                 for tag, edit in K9_EDITS.items() if keep(tag)}
        libs = _variants(build, Path(tmp, "lib"), jobs, LIBS_K9)
        for (lib, tag), (_, report) in sorted(libs.items()):
            emit(library=lib, variant=tag, **report)
        for tag in list(jobs) + ["base"]:
            for lib in LIBS_K9:
                _use_k9(k9, build, lib, libs[(lib, tag)][0])
            for label, fn, x in cases:
                emit(kernel=label, variant=tag, ms_a_step=cs._time_steps(
                    fn, x, 30, dev) * 1e3)
    k9._fn_cache.clear()


def _use_k10(kf, build, lib: str, so) -> None:
    """Point K10's wrappers (K12e's for flow3d_local_f32) for `lib` at the
    library `so`."""
    local = lib.startswith("flow3d_local")
    (kf._local_cache if local else kf._fn_cache).pop(lib, None)
    load = build.load_library
    build.load_library = lambda name: so if name == lib else load(name)
    try:
        (kf._local_fns if local else kf._kernel_fn)(lib)
    finally:
        build.load_library = load


def sweep_k10(cs, build, kf, dev, emit, tags=()) -> None:
    """The "k10" mode: K10's f32 push, its bf16 step and K12e's call at
    128^3 over K10_EDITS (only `tags` and "base" where `tags` are given)."""
    import torch
    from openlbmpm_torch.parallel import make_mesh
    m = cs.probe_sc3d_model(dev)
    mh = cs.probe_sc3d_model(dev, storage="bf16")
    f = cs.probe_sc3d_start(m)
    k12 = kf.build_sc3d_sharded_step(
        m.geo, m.p, make_mesh(shape=(4, 1), kind="local", device=dev),
        torch.float32, steps_per_call=1)
    cases = (("K10 f32", lambda x: kf.sc3d_step(x, m), f),
             ("K10 bf16", lambda x: kf.sc3d_step(x, mh),
              mh.pack_state_bf16(f)),
             ("K12e (4, 1) T=1", k12, k12.shard(f)))
    with tempfile.TemporaryDirectory() as tmp:
        keep = lambda tag: not tags or tag in tags
        jobs = {"base": (_patched(build.SRC_DIR, Path(tmp, "base"), {}), [])}
        jobs |= {tag: (_patched(build.SRC_DIR, Path(tmp, tag),
                                {"flow3d.cuh": edit}), [])
                 for tag, edit in K10_EDITS.items() if keep(tag)}
        libs = _variants(build, Path(tmp, "lib"), jobs, LIBS_K10)
        for (lib, tag), (_, report) in sorted(libs.items()):
            emit(library=lib, variant=tag, **report)
        for tag in jobs:
            for lib in LIBS_K10:
                _use_k10(kf, build, lib, libs[(lib, tag)][0])
            for label, fn, x in cases:
                emit(kernel=label, variant=tag, ms_a_step=cs._time_steps(
                    fn, x, 30, dev) * 1e3)
    kf._fn_cache.clear()
    kf._local_cache.clear()


def sweep_k11(cs, build, M, kf, k9, dev, emit, tags=()) -> None:
    """The "k11" mode: K11-T at 128^3 over slabs a wave and K11_MARCH_EDITS,
    and K11's f32 push at 128^3 and 256^3 over K11_PUSH_EDITS (only `tags`
    and "base" where `tags` are given)."""
    import torch
    keep = lambda tag: not tags or tag in tags
    shape = (128,) * 3
    m = cs.basic3d_model(dev)
    mh = cs.basic3d_model(dev, storage="bf16")
    f = cs.flow_start(m, seed=5)
    xs = {"f32": (m, f), "bf16": (mh, mh.pack_state_bf16(f))}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {"base": (_patched(build.SRC_DIR, Path(tmp, "base"), {}), [])}
        jobs |= {tag: (_patched(build.SRC_DIR, Path(tmp, tag),
                                {"flow3d_block.cuh": edit}), [])
                 for tag, edit in K11_MARCH_EDITS.items() if keep(tag)}
        libs = _variants(build, Path(tmp, "lib"), jobs, LIBS_K11T)
        pjobs = {"base": jobs["base"]}
        pjobs |= {tag: (_patched(build.SRC_DIR, Path(tmp, tag),
                                 {"flow3d.cuh": edit}), [])
                  for tag, edit in K11_PUSH_EDITS.items() if keep(tag)}
        plibs = _variants(build, Path(tmp, "plib"), pjobs, ("flow3d_f32",))
        for (lib, tag), (_, report) in sorted((libs | plibs).items()):
            emit(library=lib, variant=tag, **report)
        for tag in jobs:
            for lib in LIBS_K11T:
                _use(M, kf, k9, lib, libs[(lib, tag)][0])
            for t in (2, 4):
                for z in (2, 4, 8):
                    plan = M.single3d_march_plan(shape, t, 4, z)
                    table = plan.tensor().to(dev)
                    for st, (mm, x) in xs.items():
                        emit(kernel=f"K11-T {st}", T=t, variant=tag,
                             slabs_per_wave=z,
                             rings_mb=plan.scratch_bytes / 2 ** 20,
                             ms_a_step=cs._time_steps(
                                 lambda y: cs.march_call(y, mm, t, plan,
                                                         table),
                                 x, max(48 // t, 4), dev) / t * 1e3)
        M._fns.clear()
        big = cs.basic3d_model(dev, n=256)
        fb = cs.flow_start(big, seed=5)
        rest = m.init_state()
        # the rest state with a relative noise of 1e-6: no exact zeros in
        # the momenta and the relaxations' numerators
        noisy = rest * (1 + 1e-6 * torch.rand(rest.shape, device=dev,
                                              generator=torch.Generator(
                                                  device=dev).manual_seed(0)))
        for tag in pjobs:
            _use_k10(kf, build, "flow3d_f32", plibs[("flow3d_f32", tag)][0])
            for n, mm, x in ((128, m, f), (256, big, fb)):
                emit(kernel=f"K11 f32 {n}^3", variant=tag,
                     ms_a_step=cs._time_steps(
                         lambda y: kf.single3d_step(y, mm), x,
                         50 if n == 128 else 20, dev) * 1e3)
            if tag == "base":
                for start, x in (("rest", rest), ("rest + 1e-6 noise", noisy),
                                 ("perturbed", f)):
                    emit(kernel="K11 f32 128^3", variant=tag, start=start,
                         ms_a_step=cs._time_steps(
                             lambda y: kf.single3d_step(y, m), x, 50,
                             dev) * 1e3)
    kf._fn_cache.clear()


def _use_k8(lib: str, so) -> None:
    """Point K8's wrapper for `lib` at the library `so`."""
    from openlbmpm_torch.kernels import build, shanchen
    shanchen._fn_cache.pop(lib, None)
    load = build.load_library
    build.load_library = lambda name: so if name == lib else load(name)
    try:
        shanchen._kernel_fn(lib)
    finally:
        build.load_library = load


def sweep_k8(cs, build, dev, emit, tags=()) -> None:
    """The "k8" mode: K8 at 1024^2 on configs 2 and 3 in f32 and bf16
    storage over K8_EDITS (only `tags` and "base" where `tags` are given),
    ms a step."""
    from openlbmpm_torch.kernels import shanchen
    cases = []
    for name in ("config2", "config3"):
        for st in ("f32", "bf16"):
            m, f = cs.sc_config(name, dev, storage=st)
            cases.append((f"K8 {name} {st}", m,
                          m.pack_state_bf16(f) if st == "bf16" else f))
    keep = lambda tag: not tags or tag in tags
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {"base": (_patched(build.SRC_DIR, Path(tmp, "base"), {}), [])}
        jobs |= {tag: (_patched(build.SRC_DIR, Path(tmp, tag),
                                {name: edit}), [])
                 for tag, (name, edit) in K8_EDITS.items() if keep(tag)}
        libs = _variants(build, Path(tmp, "lib"), jobs, LIBS_K8)
        for (lib, tag), (_, report) in sorted(libs.items()):
            emit(library=lib, variant=tag, **report)
        for _ in range(2):   # two rounds, so that a drift shows
            for tag in jobs:
                for lib in LIBS_K8:
                    _use_k8(lib, libs[(lib, tag)][0])
                for label, m, x in cases:
                    emit(kernel=label, variant=tag, ms_a_step=cs._time_steps(
                        lambda y: shanchen.sc_step(y, m), x, 200, dev) * 1e3)
    shanchen._fn_cache.clear()


def sweep_k8t(cs, build, M, kf, k9, dev, emit,
              zs=(96, 192, 256, 384, 512, 768, 1024), tags=()) -> None:
    """The "k8t" mode: K8-T at 1024^2 (config 2 f32 and bf16, config 3
    f32) at T = 2 and 4 over rows a wave (``march2d.SC_ROWS_PER_WAVE``) and
    K8T_EDITS, with the rings' MB; then at the default rows a wave with one
    stage kind's body skipped (load, collide, stream, and every body: the
    waves and barriers alone; wrong results, the times say what each stage
    costs)."""
    import torch
    from openlbmpm_torch.kernels import march2d, shanchen
    cases = []
    for name, st in (("config2", "f32"), ("config2", "bf16"),
                     ("config3", "f32")):
        m, f = cs.sc_config(name, dev, storage=st)
        cases.append((f"K8-T {name} {st}", m,
                      m.pack_state_bf16(f) if st == "bf16" else f))
    keep = lambda tag: not tags or tag in tags
    z0 = march2d.SC_ROWS_PER_WAVE

    def time_all(**kw):
        for label, m, x in cases:
            for t in (2, 4):
                plan = shanchen._march_plan(m.kernel_params, x.dtype, t,
                                            dev)[0]
                ms = cs._time_steps(
                    lambda y: shanchen.sc_block_step(y, m, t), x,
                    max(48 // t, 6), dev) / t * 1e3
                emit(kernel=label, T=t, rows_per_wave=march2d.SC_ROWS_PER_WAVE,
                     rings_mb=plan.scratch_bytes / 2 ** 20, ms_a_step=ms, **kw)
            torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        jobs = {"base": (_patched(build.SRC_DIR, Path(tmp, "base"), {}), [])}
        jobs |= {tag: (_patched(build.SRC_DIR, Path(tmp, tag),
                                {name: edit}), [])
                 for tag, (name, edit) in K8T_EDITS.items() if keep(tag)}
        libs = _variants(build, Path(tmp, "lib"), jobs, LIBS_K8T)
        for (lib, tag), (_, report) in sorted(libs.items()):
            emit(library=lib, variant=tag, **report)
        for tag in jobs:
            for lib in LIBS_K8T:
                _use(M, kf, k9, lib, libs[(lib, tag)][0])
            for z in zs if tag == "base" else (z0,):
                march2d.SC_ROWS_PER_WAVE = z
                M._plans.clear()
                time_all(variant=tag)
    march2d.SC_ROWS_PER_WAVE = z0
    M._plans.clear()
    with tempfile.TemporaryDirectory() as tmp:
        kinds = {"full": None, "all": "true", "load": "c.kind() == 0",
                 "collide": "c.kind() == 1", "stream": "c.kind() == 2"}
        jobs = {name: (_patched(build.SRC_DIR, Path(tmp, name), skip_edits(
            cond) if cond else {}), []) for name, cond in kinds.items()}
        libs = _variants(build, Path(tmp, "lib"), jobs, LIBS_K8T)
        for name in jobs:
            for lib in LIBS_K8T:
                _use(M, kf, k9, lib, libs[(lib, name)][0])
            M._plans.clear()
            time_all(skipped=name)
    M._plans.clear()
    M._fns.clear()


# the 2-D colour-gradient strip marches' variants (K1 / K2 / K6,
# csf2d.cuh::strip_kernel; K4, pert2d.cu::pert_strip_kernel): tag -> edits
# {file: (text, replacement)}.  "h16" ... "h128": rows of a run (RUN_H);
# "ty4", "ty16": rows a step (TY; the threads a block follow it); "t256",
# "t288", "t320": threads a block (STRIP_THREADS and PERT_THREADS: 8, 9 or
# 10 warps; the sources' 10 and 9 take phi's 40 columns and d's 36 in one
# round); "mbCS": both kernels ask ptxas for C resident blocks an SM in
# the compressed float instances and S in the split push (the sources: 4
# and 3, Perturbation 4 and 4); "skip_phi", "skip_normal", "skip_collide":
# one stage's cell body skipped where P.nx > 0, so always (the results are
# wrong; the times say what each stage costs)
STRIP_H = "constexpr int RUN_H = 32;"
STRIP_TY = "constexpr int TY = 8;"
STRIP_NT = "constexpr int STRIP_THREADS = (TX + 8) * TY;"
PERT_NT = "constexpr int PERT_THREADS = (TX + 4) * TY;"
STRIP_MIN = "  return sizeof(C) == 8 ? 1 : (L == kSplit ? 3 : 4);"
PERT_MIN = "  return sizeof(C) == 8 ? 1 : 4;"
CG_COLLIDE = ("  auto collide = [&](int r, int lx, C post[9], C& frac, C& A, "
              "C& B) {\n")
PERT_COLLIDE = ("  auto collide = [&](int y, int r, int lx, C post[9], "
                "C red[9]) {\n")
CG_PHI = "      C phi = C(0);\n      if (fluid) {"
CG_NORMAL = ("      phi_gradient([&](int i) { return phi_ext(ex(i), ey(i)); }, "
             "gx, gy);")
PERT_D = "      if (fluid) {\n        Cell<C, L> c;"
_WARPS = {256: "TX * TY", 288: "(TX + 4) * TY", 320: "(TX + 8) * TY"}
CG2D_EDITS = {
    **{f"h{h}": {"csf2d.cuh": (STRIP_H, STRIP_H.replace("32", str(h)))}
       for h in (16, 64, 128)},
    **{f"ty{y}": {"csf2d.cuh": (STRIP_TY, STRIP_TY.replace("8", str(y)))}
       for y in (4, 16)},
    **{f"t{n}": {name: (old, new) for name, old, new in (
        ("csf2d.cuh", STRIP_NT, STRIP_NT.replace("(TX + 8) * TY", w)),
        ("pert2d.cu", PERT_NT, PERT_NT.replace("(TX + 4) * TY", w)))
        if old != new} for n, w in _WARPS.items()},
    **{f"mb{c}{s}": {name: (old, new) for name, old, new in (
        ("csf2d.cuh", STRIP_MIN, f"  return sizeof(C) == 8 ? 1 : "
         f"(L == kSplit ? {s} : {c});"),
        ("pert2d.cu", PERT_MIN, f"  return sizeof(C) == 8 ? 1 : "
         f"(L == kSplit ? {s} : {c});")) if old != new}
       for c, s in ((2, 2), (3, 3), (3, 4), (4, 3), (4, 4), (5, 4))},
    "skip_phi": {"csf2d.cuh": (CG_PHI, CG_PHI.replace(
                     "(fluid)", "(fluid && P.nx < 0)")),
                 "pert2d.cu": (PERT_D, PERT_D.replace(
                     "(fluid)", "(fluid && P.nx < 0)"))},
    "skip_normal": {"csf2d.cuh": (CG_NORMAL, "      if (P.nx > 0) gx = gy = "
                                  "C(0); else\n" + CG_NORMAL)},
    "skip_collide": {
        "csf2d.cuh": (CG_COLLIDE, CG_COLLIDE + "    if (P.nx > 0) {\n"
                      "      for (int i = 0; i < 9; ++i) post[i] = C(0);\n"
                      "      frac = A = B = C(0);\n      return;\n    }\n"),
        "pert2d.cu": (PERT_COLLIDE, PERT_COLLIDE + "    if (P.nx > 0) {\n"
                      "      for (int i = 0; i < 9; ++i) post[i] = red[i] = "
                      "C(0);\n      return;\n    }\n")},
}
LIBS_CG2D = ("csf2d", "pert2d", "coupled2d")
# the tracer strip march's resident blocks an SM (coupled2d.cu)
TSTRIP_MIN = "  return sizeof(C) == 8 ? 1 : 4;"
CG2D_EDITS |= {f"tmb{b}": {"coupled2d.cu": (TSTRIP_MIN, TSTRIP_MIN.replace(
    ": 4;", f": {b};"))} for b in (3, 5)}
# the tracer strip with one stage's work skipped (wrong results; the times
# say what each stage costs): the phi pass's state loads, the normals, the
# tracers' collision, the stream
T_PHI = "      if (fluid || kept) {"
T_NORMAL = ("      phi_gradient([&](int i) { return phi_ext(ex(i), ey(i)); }, "
            "gx, gy);")
T_COLLIDE = "      tracer_collide<C, NQ>("
T_STREAM = "    tracer_stream<C, NQ>(view, tab, T, ny, tx + 1, r,"
CG2D_EDITS |= {
    "t_skip_phi": {"coupled2d.cu": (T_PHI, T_PHI.replace(
        "(fluid || kept)", "((fluid || kept) && P.nx < 0)"))},
    "t_skip_normal": {"coupled2d.cu": (T_NORMAL, "      if (P.nx > 0) gx = gy "
                                       "= C(0); else\n" + T_NORMAL)},
    "t_skip_collide": {"coupled2d.cu": (T_COLLIDE,
                                        "      if (P.nx < 0) " + T_COLLIDE[6:])},
    "t_skip_stream": {"coupled2d.cu": (T_STREAM,
                                       "    if (P.nx < 0) " + T_STREAM[4:])}}


def _use_cg2d(lib: str, so) -> None:
    """Point the 2-D colour-gradient wrappers for `lib` at `so`."""
    from openlbmpm_torch.kernels import build, csf, transport
    mod = transport if lib == "coupled2d" else csf
    mod._fn_cache.pop(lib, None)
    load = build.load_library
    build.load_library = lambda name: so if name == lib else load(name)
    try:
        mod._kernel_fns(lib)
    finally:
        build.load_library = load


def sweep_cg2d(cs, build, dev, emit, tags=()) -> None:
    """The "2dcg" mode: K1, K2, K6 (the CSF flagship) and K4c, K4h, K4s
    (the Perturbation flagship) at 1024^2, ms a step over CG2D_EDITS (only
    `tags` and "base" where `tags` are given), two rounds; and at the
    sources' settings the wrapper's host microseconds a call (the host's
    clock over calls queued without a wait) beside its device
    microseconds a step."""
    import torch
    from openlbmpm_torch.kernels import csf
    cases = []
    for variant, make, labels in (
            ("CSF", cs.flagship_model, ("K1", "K2", "K6")),
            ("Perturbation", cs.pert_flagship_model, ("K4c", "K4h", "K4s"))):
        one_c = csf.csf_step_compressed if variant == "CSF" else \
            csf.pert_step_compressed
        one_s = csf.csf_step_split if variant == "CSF" else \
            csf.pert_step_split
        for label, storage in zip(labels, ("f32", "bf16", "split")):
            m = make(dev, "bf16" if storage == "bf16" else "f32")
            st = m.init_state_layers(1.0, 1.0, invading_rows=100)
            if storage == "split":
                cases.append((label, m, st, one_s))
            else:
                cases.append((label, m, m.pack_state_bf16(*st) if storage ==
                              "bf16" else m.pack_state(*st), one_c))
    for label, storage in (("K5c f32", "f32"), ("K5c bf16", "bf16"),
                           ("K5s", "split")):
        mt = cs.coupled_model(dev, "bf16" if storage == "bf16" else "f32",
                              cs.CONFIG4_TRACER)
        cst = cs.config4_state(mt)[0]
        if storage == "split":
            cases.append((label, mt, cst, lambda y, m: m.step(y)))
        else:
            cases.append((label, mt, mt.pack(cst),
                          lambda y, m: m.step_c(y)))
    for label, m, x, fn in cases:
        for _ in range(5):
            y = fn(x, m)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(50):
            y = fn(x, m)
        host = (time.perf_counter() - t0) / 50 * 1e6
        torch.cuda.synchronize(dev)
        emit(kernel=label, host_us_a_call=host, device_us_a_step=cs._time_steps(
            lambda y: fn(y, m), x, 300, dev) * 1e6)
    keep = lambda tag: not tags or tag in tags
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {tag: (_patched(build.SRC_DIR, Path(tmp, tag), edits), [])
                for tag, edits in {"base": {}, **CG2D_EDITS}.items()
                if tag == "base" or keep(tag)}
        libs = _variants(build, Path(tmp, "lib"), jobs, LIBS_CG2D)
        for (lib, tag), (_, report) in sorted(libs.items()):
            emit(library=lib, variant=tag, **report)
        for _ in range(2):   # two rounds, so that a drift shows
            for tag in jobs:
                for lib in LIBS_CG2D:
                    _use_cg2d(lib, libs[(lib, tag)][0])
                for label, m, x, fn in cases:
                    emit(kernel=label, variant=tag, ms_a_step=cs._time_steps(
                        lambda y: fn(y, m), x, 200, dev) * 1e3)
    csf._fn_cache.clear()


def sweep_2d(cs, build, M, kf, k9, dev, emit, zs=(16, 32, 64, 96, 128),
             blocks=(1, 2, 3, 4)) -> None:
    """The "2dT" mode: ms a time step of K3c (the flagship) and K5c-Tc
    (configuration 4) at 1024^2 in f32, T = 2 and 4, over rows a wave and
    resident blocks an SM, and with every body skipped."""
    import torch
    from openlbmpm_torch.kernels import csf, march2d, transport
    m = cs.flagship_model(dev, "f32")
    s = m.pack_state(*m.init_state_layers(1.0, 1.0, invading_rows=100))
    mp = cs.pert_flagship_model(dev, "f32")
    sp = mp.pack_state(*mp.init_state_layers(1.0, 1.0, invading_rows=100))
    mt = cs.coupled_model(dev, "f32", cs.CONFIG4_TRACER)
    st, _ = cs.config4_state(mt)
    x = mt.pack(st)
    cases = (("K3c f32", lambda y, t: csf.csf_block_compressed(y, m, t), s),
             ("K3c Pert f32", lambda y, t: csf.pert_block_compressed(
                 y, mp, t), sp),
             ("K5c-Tc f32", lambda y, t: transport.coupled_block_compressed(
                 y, mt, t), x))
    z0 = march2d.ROWS_PER_WAVE
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {f"mb{b}": (_patched(build.SRC_DIR, Path(tmp, f"mb{b}"),
                                    min_blocks_edits_2d(b)), [])
                for b in blocks}
        jobs["skip"] = (_patched(build.SRC_DIR, Path(tmp, "skip"),
                                 skip_edits("true")), [])
        libs = _variants(build, Path(tmp, "lib"), jobs, LIBS_2D)
        for (lib, tag), (_, report) in sorted(libs.items()):
            emit(library=lib, variant=tag, **report)
        for tag in jobs:
            for lib in LIBS_2D:
                _use(M, kf, k9, lib, libs[(lib, tag)][0])
            for z in zs:
                march2d.ROWS_PER_WAVE = z
                M._plans.clear()
                for label, fn, y in cases:
                    for t in (2, 4):
                        ms = cs._time_steps(lambda v: fn(v, t), y,
                                            max(48 // t, 6), dev) / t * 1e3
                        emit(kernel=label, T=t, variant=tag,
                             rows_per_wave=z, ms_a_step=ms)
                torch.cuda.empty_cache()
    march2d.ROWS_PER_WAVE = z0
    M._plans.clear()
    with tempfile.TemporaryDirectory() as tmp:
        kinds = {"full": None, "bc": 3, "phi": 6, "normal": 5, "collide": 1,
                 "stream": 2, "tcollide": 7, "tstream": 8}
        jobs = {name: (_patched(build.SRC_DIR, Path(tmp, name), skip_edits(
            f"c.kind() == {k}") if k is not None else {}), [])
                for name, k in kinds.items()}
        libs = _variants(build, Path(tmp, "lib"), jobs, LIBS_2D)
        for name in jobs:
            for lib in LIBS_2D:
                _use(M, kf, k9, lib, libs[(lib, name)][0])
            M._plans.clear()
            for label, fn, y in cases:
                if name.startswith("t") and label.startswith("K3"):
                    continue
                for t in (2, 4):
                    ms = cs._time_steps(lambda v: fn(v, t), y,
                                        max(48 // t, 6), dev) / t * 1e3
                    emit(kernel=label, T=t, skipped=name,
                         rows_per_wave=z0, ms_a_step=ms)
            torch.cuda.empty_cache()
    M._plans.clear()
    M._fns.clear()


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from openlbmpm_torch.kernels import build
    from openlbmpm_torch.kernels import cg3d as k9
    from openlbmpm_torch.kernels import flow3d as kf
    from openlbmpm_torch.kernels import march3d as M
    args = list(sys.argv[1:] if argv is None else argv) or ["all"]
    what = args[0]
    shape = (128,) * 3
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)

    def emit(**kw):
        print(json.dumps(kw), flush=True)

    if what in ("2dT", "2dcg", "k8", "k8t", "k9", "k10", "k11"):
        if what == "2dT":
            sweep_2d(cs, build, M, kf, k9, dev, emit)
        elif what == "2dcg":
            sweep_cg2d(cs, build, dev, emit, tuple(args[1:]))
        elif what == "k8":
            sweep_k8(cs, build, dev, emit, tuple(args[1:]))
        elif what == "k8t":
            sweep_k8t(cs, build, M, kf, k9, dev, emit, tags=tuple(args[1:]))
        elif what == "k9":
            sweep_k9(cs, build, k9, dev, emit, tuple(args[1:]))
        elif what == "k10":
            sweep_k10(cs, build, kf, dev, emit, tuple(args[1:]))
        else:
            sweep_k11(cs, build, M, kf, k9, dev, emit, tuple(args[1:]))
        print(json.dumps({"done": True,
                          "seconds": time.perf_counter() - t0}))
        return 0
    m = cs.probe_sc3d_model(dev)
    f = cs.probe_sc3d_start(m)
    mc = cs.config5_model(dev)
    s = mc.pack_state(*cs.config5_start(mc))

    pc = mc.kernel_params

    def k10(t, **kw):
        plan = M.sc3d_march_plan(shape, m.kernel_params.k, t, 4, **kw)
        table = plan.tensor().to(dev)
        return cs._time_steps(lambda y: cs.march_call(
            y, m, t, plan, table), f, max(24 // t, 4), dev) / t * 1e3

    mb = cs.basic3d_model(dev)
    fb = cs.flow_start(mb, seed=5)

    def k11t(t, **kw):
        plan = M.single3d_march_plan(shape, t, 4, **kw)
        table = plan.tensor().to(dev)
        return cs._time_steps(lambda y: cs.march_call(
            y, mb, t, plan, table), fb, max(48 // t, 4), dev) / t * 1e3

    def k9c(t, **kw):
        plan = M.cg3d_march_plan(shape, t, 4, False, pc.inlet, pc.outlet,
                                 bool(pc.has_wetting), **kw)
        table = plan.tensor().to(dev)
        return cs._time_steps(lambda y: cs.march_call(
            y, mc, t, plan, table), s, max(24 // t, 4), dev) / t * 1e3

    if what in ("knobs", "all"):
        with tempfile.TemporaryDirectory() as tmp:
            libs = _variants(build, Path(tmp, "lib"), {
                f"mb{b}": (_patched(build.SRC_DIR, Path(tmp, f"mb{b}"),
                                    min_blocks_edits(b)), [])
                for b in (1, 2, 3)})
            for (lib, tag), (_, report) in sorted(libs.items()):
                emit(library=lib, variant=tag, **report)
            for b in (1, 2, 3):
                for lib in ("flow3d_block_f32", "cg3d_block_f32"):
                    _use(M, kf, k9, lib, libs[(lib, f"mb{b}")][0])
                for t in (2, 4):
                    for rows in (128, 64):
                        for z in (1, 2, 4, 8):
                            kw = {"band_rows": rows, "slabs_per_wave": z}
                            emit(kernel="K10-T f32", T=t, min_blocks=b,
                                 **kw, ms_a_step=k10(t, **kw))
                            emit(kernel="K9-Tc f32", T=t, min_blocks=b,
                                 **kw, ms_a_step=k9c(t, **kw))
            M._fns.clear()
    if what in ("stages", "all"):
        with tempfile.TemporaryDirectory() as tmp:
            defines = {}
            for name, cond in [("none", None), ("all", "true")] + [
                    (k, f"c.kind() == {v}") for k, v in STAGES.items()]:
                defines[name] = _patched(build.SRC_DIR, Path(tmp, name),
                                         skip_edits(cond) if cond else {})
            libs = _variants(build, Path(tmp, "lib"),
                             {name: (src, []) for name, src in
                              defines.items()})
            for name in defines:
                for lib in ("flow3d_block_f32", "cg3d_block_f32"):
                    _use(M, kf, k9, lib, libs[(lib, name)][0])
                for t in (2, 4):
                    if name not in ("bc", "extrap", "normal", "scollide"):
                        emit(kernel="K10-T f32", T=t, skipped=name,
                             ms_a_step=k10(t))
                    if name in ("none", "all", "collide", "scollide",
                                "stream"):
                        emit(kernel="K11-T f32", T=t, skipped=name,
                             ms_a_step=k11t(t))
                    if name != "scollide":
                        emit(kernel="K9-Tc f32", T=t, skipped=name,
                             ms_a_step=k9c(t))
            M._fns.clear()
    if what == "all":
        sweep_2d(cs, build, M, kf, k9, dev, emit)
        sweep_k9(cs, build, k9, dev, emit)
    print(json.dumps({"done": True, "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
