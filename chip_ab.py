#!/usr/bin/env python3
"""Time the single-device kernels of this checkout against those of another
checkout of the repository, in turns on one card.

    python3 chip_ab.py OTHER_DIR[,OTHER_DIR...] [ROUNDS] [3d|2d|2dcg|3dT|2dT|k10h|bits|sass|sass2d]

Run from the repository root on a machine with a CUDA card and nvcc.
OTHER_DIR holds another checkout (e.g. the parent commit, unpacked with
``git archive`` into a directory that .gitignore lists).  Each turn is a
subprocess in one of the two checkouts, which builds that checkout's
libraries and times, with CUDA events, through ``chip_smoke.py``'s models
of that checkout: "3d" (the default) ms a step of K9c, K9h and K9s
(configuration 5; K9c at 256^3 too), K12d (the sharded K9 on configuration
5 over a (4, 1) local mesh, ms a call of one step), K9t (the coupled
probe, f32 and bf16 flow storage), K12d coupled (the sharded K9t on the
probe over (4, 1)), K11 (basic3d, f32 from the rest state and from
chip_smoke.py's perturbed start, bf16; f32 at 256^3 too), K10 (probe_sc3d,
f32 and bf16), K12e
(the sharded K10 on probe_sc3d over (4, 1), T = 1) and K10-T at T = 2 (ms a
time step), at 128^3 in f32 unless named;
"2d" ms a step of the Shan-Chen K8 and of K8-T at T = 2 and 4 (a
time step) on bench_all.py's configs 2 and 3 at 1024^2 in f32 and in bf16
storage, of K12c (the sharded K8-T over a (4, 1) local mesh, T = 4, a time
step) on both, of K8 with four fluids (the runtime-K instance) at 1024^2,
and of the other 2-D kernels a Shan-Chen change must leave as they are:
K3c (the CSF flagship) and K5c-Tc (configuration 4) at T = 4, K7 and K7-T
at T = 4 (configuration 1), all in f32; "3dT" ms a time step of the 3-D
T-step kernels at 128^3: K10-T (probe_sc3d) in f32 and bf16 and K9-Tc,
K9-Th and K9-Ts (configuration 5) at T = 2 and 4, and K11-T (basic3d) in
f32 and bf16 at T = 2 and 4; "2dT" ms a time step of the 2-D colour-gradient T-step kernels at
1024^2, the models of chip_smoke.py's phases 49 and 55: K3c, K3h and K3s
of both variants (the CSF flagship and the Perturbation flagship) and
K5c-Tc, K5c-Th and K5c-Ts (configuration 4) at T = 2 and 4; "2dcg" ms a
step of the 2-D colour-gradient kernels at T = 1 at 1024^2: K1 (f32), K2
(bf16) and K6 (split f32) on the CSF flagship, K4c, K4h and K4s on the
Perturbation flagship, K5c (f32 and bf16 flow storage) and K5s on
configuration 4; "bits" no
times but whether the two checkouts' kernels give the same bits: K8, K10,
K11, K9t, K1 / K2 / K6, K4c / K4h / K4s and K5c / K5s after 10 steps and
K8-T and K11-T after two calls of T = 4 on this checkout's cases
(chip_smoke.py's SC_KERNEL_CASES at 100 x 64, SC3D_CASES, SINGLE3D_CASES,
CG3D_TRANSPORT_CASES but the grain pack, split_cases and the first four of
PERT_CASES at 100 x 72, COUPLED_CASES at 100 x 64) in f64, f32 and bf16,
then K8, K8-T, K1 / K6, K4c / K4s and K5c / K5s in f64 and f32 and K10,
K11 and K11-T in f32 with both
checkouts' libraries built with -fmad=false, one line each with the
largest |difference| of those kernels between the checkouts (in float64;
bf16 as stored);
"sass" no times but each kernel of the 3-D one-step libraries and of the
3-D single-phase and Shan-Chen T-step libraries (SASS_LIBS) as cuobjdump
prints it from both checkouts' builds: its instructions (addresses and
encodings dropped) equal or not, their count and its registers in each (a
kernel this checkout renamed beside the one it replaces, RENAMED), one JSON
line a library; "sass2d" the same of the 2-D libraries of SASS2D_LIBS.
"k10h" ms a step of K10 in
bf16 storage (probe_sc3d, K = 2) at 128^3 and 256^3 and of K11 in bf16
at 128^3, with the registers ptxas gave each two-fluid bf16 kernel of
flow3d_bf16 (values, not times). The turns go
other, this, this, other (ROUNDS times, default 1), so that a drift of the
card's clock shows in both; with several other checkouts (timings only)
they go o1, o2, ..., this, this, ..., o2, o1.  Prints one JSON line a turn, then one with
each kernel's median over the turns of each checkout, and one with each
kernel's spread: the lowest and highest turn of each checkout, and whether
every turn of this checkout is below every turn of the other.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

TURN = r"""
import json, sys, torch
import chip_smoke as cs
from openlbmpm_torch.kernels import build, cg3d, flow3d
from openlbmpm_torch.parallel import make_mesh
build.load_libraries(("cg3d_f32", "cg3d_bf16", "cg3d_local_f32",
                      "flow3d_f32", "flow3d_bf16", "flow3d_local_f32",
                      "flow3d_block_f32"))
# "K11" from the rest state, as earlier turns timed it; "K11 start" from
# chip_smoke.py's perturbed start (phase 39's)
dev = torch.device("cuda", 0)
out = {}
m = cs.config5_model(dev)
mh = cs.config5_model(dev, storage="bf16")
st = cs.config5_start(m)
x = m.pack_state(*st)
out["K9c"] = cs._time_steps(lambda s: cg3d.cg3d_step_compressed(s, m), x, 50,
                            dev)
out["K9h"] = cs._time_steps(lambda s: cg3d.cg3d_step_compressed(s, mh),
                            mh.pack_state_bf16(*st), 50, dev)
out["K9s"] = cs._time_steps(lambda s: cg3d.cg3d_step_split(s, m), st, 50,
                            dev)
step = cg3d.build_cg3d_sharded_step(
    m.geo, m.p, make_mesh(shape=(4, 1), kind="local", device=dev),
    torch.float32, bc_config=m.bcs)
out["K12d (4, 1)"] = cs._time_steps(step, step.shard(x), 20, dev)
del st, x, step
m = cs.config5_model(dev, n=256)
x = m.pack_state(*cs.config5_start(m))
out["K9c 256^3"] = cs._time_steps(
    lambda s: cg3d.cg3d_step_compressed(s, m), x, 10, dev)
del x
m = cs.probe3d_model(dev)
st = cs.probe3d_start(m)
out["K9t"] = cs._time_steps(
    lambda s: cg3d.coupled3d_step_compressed(*s, m), m.pack(st), 50, dev)
mh = cs.probe3d_model(dev, storage="bf16")
out["K9t bf16"] = cs._time_steps(
    lambda s: cg3d.coupled3d_step_compressed(*s, mh), mh.pack(st), 50, dev)
step = cg3d.build_cg3d_sharded_step(
    m.geo, m.flow.p, make_mesh(shape=(4, 1), kind="local", device=dev),
    torch.float32, bc_config=m.flow.bcs, transport=cs.tracer3d_of(m, dev))
out["K12d coupled (4, 1)"] = cs._time_steps(step, step.shard(*m.pack(st)),
                                            20, dev)
del st, step
m = cs.basic3d_model(dev)
out["K11"] = cs._time_steps(lambda f: flow3d.single3d_step(f, m),
                            m.init_state(), 50, dev)
f = cs.flow_start(m, seed=5)
out["K11 start"] = cs._time_steps(lambda f: flow3d.single3d_step(f, m), f,
                                  50, dev)
mh = cs.basic3d_model(dev, storage="bf16")
out["K11 bf16"] = cs._time_steps(lambda f: flow3d.single3d_step(f, mh),
                                 mh.pack_state_bf16(f), 50, dev)
m = cs.basic3d_model(dev, n=256)
out["K11 256^3"] = cs._time_steps(lambda f: flow3d.single3d_step(f, m),
                                  cs.flow_start(m, seed=5), 20, dev)
del m, mh, f
torch.cuda.empty_cache()
m = cs.probe_sc3d_model(dev)
f = cs.probe_sc3d_start(m)
out["K10"] = cs._time_steps(lambda f: flow3d.sc3d_step(f, m), f, 50, dev)
mh = cs.probe_sc3d_model(dev, storage="bf16")
out["K10 bf16"] = cs._time_steps(lambda f: flow3d.sc3d_step(f, mh),
                                 mh.pack_state_bf16(f), 50, dev)
step = flow3d.build_sc3d_sharded_step(
    m.geo, m.p, make_mesh(shape=(4, 1), kind="local", device=dev),
    torch.float32, steps_per_call=1)
out["K12e (4, 1) T=1"] = cs._time_steps(step, step.shard(f), 20, dev)
out["K10-T T=2"] = cs._time_steps(
    lambda y: flow3d.sc3d_block_step(y, m, 2), f, 24, dev) / 2
print(json.dumps({k: v * 1e3 for k, v in out.items()}))
"""

TURN_2D = r"""
import json, sys, torch
import chip_smoke as cs
from openlbmpm_torch.kernels import build, csf, shanchen, single, transport
from openlbmpm_torch.parallel import make_mesh
build.load_libraries(("sc2d_f32", "sc2d_bf16", "sc2d_block_f32",
                      "sc2d_block_bf16", "sc2d_rt", "sc2d_local_f32",
                      "csf2d_block_f32", "coupled2d_block_f32",
                      "single2d_f32", "single2d_block_f32"))
dev = torch.device("cuda", 0)
out = {}
for name in ("config2", "config3"):
    for st in ("f32", "bf16"):
        m, f = cs.sc_config(name, dev, storage=st)
        x = m.pack_state_bf16(f) if st == "bf16" else f
        tag = "" if st == "f32" else " bf16"
        out[f"K8 {name}{tag}"] = cs._time_steps(
            lambda y: shanchen.sc_step(y, m), x, 200, dev)
        for t in (2, 4):
            out[f"K8-T T={t} {name}{tag}"] = cs._time_steps(
                lambda y: shanchen.sc_block_step(y, m, t), x, 100 // t,
                dev) / t
    m, f = cs.sc_config(name, dev)
    step = shanchen.build_sc_sharded_step(
        m.geo, m.p, make_mesh(shape=(4, 1), kind="local", device=dev),
        torch.float32, steps_per_call=4)
    out[f"K12c (4, 1) T=4 {name}"] = cs._time_steps(step, step.shard(f), 25,
                                                    dev) / 4
m, f = cs.sc_case("sc4_mrt_velocity_convective", dev, 1024, 1024,
                  torch.float32)
out["K8 K=4"] = cs._time_steps(lambda x: shanchen.sc_step(x, m), f, 100, dev)
# the other 2-D kernels, which this change must leave as they are
m = cs.flagship_model(dev, "f32")
s = m.pack_state(*m.init_state_layers(1.0, 1.0, invading_rows=100))
out["K3c T=4"] = cs._time_steps(
    lambda y: csf.csf_block_compressed(y, m, 4), s, 50, dev) / 4
mt = cs.coupled_model(dev, "f32", cs.CONFIG4_TRACER)
x = mt.pack(cs.config4_state(mt)[0])
out["K5c-Tc T=4"] = cs._time_steps(
    lambda y: transport.coupled_block_compressed(y, mt, 4), x, 25, dev) / 4
m = cs.config1_model(dev)
f = cs.flow_start(m)
out["K7"] = cs._time_steps(lambda y: single.single_step(y, m), f, 200, dev)
out["K7-T T=4"] = cs._time_steps(
    lambda y: single.single_block_step(y, m, 4), f, 50, dev) / 4
print(json.dumps({k: v * 1e3 for k, v in out.items()}))
"""
TURN_2DCG = r"""
import json, sys, torch
import chip_smoke as cs
from openlbmpm_torch.kernels import build, csf, transport
build.load_libraries(("csf2d", "coupled2d", "pert2d"))
dev = torch.device("cuda", 0)
out = {}
for variant, make, labels in (
        ("CSF", cs.flagship_model, ("K1", "K2", "K6")),
        ("Perturbation", cs.pert_flagship_model, ("K4c", "K4h", "K4s"))):
    one_c = csf.csf_step_compressed if variant == "CSF" else \
        csf.pert_step_compressed
    one_s = csf.csf_step_split if variant == "CSF" else csf.pert_step_split
    for label, storage in zip(labels, ("f32", "bf16", "split")):
        m = make(dev, "bf16" if storage == "bf16" else "f32")
        st = m.init_state_layers(1.0, 1.0, invading_rows=100)
        if storage == "split":
            x, fn = st, one_s
        else:
            x = m.pack_state_bf16(*st) if storage == "bf16" else \
                m.pack_state(*st)
            fn = one_c
        out[label] = cs._time_steps(lambda y: fn(y, m), x, 300, dev)
        del m, x, st
for label, storage in (("K5c f32", "f32"), ("K5c bf16", "bf16"),
                       ("K5s", "split")):
    mt = cs.coupled_model(dev, "bf16" if storage == "bf16" else "f32",
                          cs.CONFIG4_TRACER)
    cst = cs.config4_state(mt)[0]
    if storage == "split":
        out[label] = cs._time_steps(mt.step, cst, 150, dev)
    else:
        out[label] = cs._time_steps(
            lambda y: transport.coupled_step_compressed(*y, mt),
            mt.pack(cst), 150, dev)
    del mt, cst
print(json.dumps({k: v * 1e3 for k, v in out.items()}))
"""
TURN_3DT = r"""
import json, sys, torch
import chip_smoke as cs
from openlbmpm_torch.kernels import build, cg3d, flow3d
build.load_libraries(("flow3d_block_f32", "flow3d_block_bf16",
                      "cg3d_block_f32", "cg3d_block_bf16"))
dev = torch.device("cuda", 0)
out = {}
f = cs.probe_sc3d_start(cs.probe_sc3d_model(dev))
for st in ("f32", "bf16"):
    m = cs.probe_sc3d_model(dev, storage=st)
    x = m.pack_state_bf16(f) if st == "bf16" else f
    for t in (2, 4):
        out[f"K10-T {st} T={t}"] = cs._time_steps(
            lambda y: flow3d.sc3d_block_step(y, m, t), x, 48 // t, dev) / t
m = cs.config5_model(dev)
mh = cs.config5_model(dev, storage="bf16")
st = cs.config5_start(m)
s = m.pack_state(*st)
for key, mm, x, kern in (
        ("c", m, s, cg3d.cg3d_block_compressed),
        ("h", mh, mh.pack_compressed_bf16(s), cg3d.cg3d_block_compressed),
        ("s", m, st, cg3d.cg3d_block_split)):
    for t in (2, 4):
        out[f"K9-T{key} T={t}"] = cs._time_steps(
            lambda y: kern(y, mm, t), x, 24 // t, dev) / t
m = cs.basic3d_model(dev)
mh = cs.basic3d_model(dev, storage="bf16")
f = cs.flow_start(m, seed=5)
for key, mm, x in (("", m, f), (" bf16", mh, mh.pack_state_bf16(f))):
    for t in (2, 4):
        out[f"K11-T{key} T={t}"] = cs._time_steps(
            lambda y: flow3d.single3d_block_step(y, mm, t), x, 48 // t,
            dev) / t
print(json.dumps({k: v * 1e3 for k, v in out.items()}))
"""
TURN_2DT = r"""
import json, sys, torch
import chip_smoke as cs
from openlbmpm_torch.kernels import build
build.load_libraries(("csf2d_block_f32", "csf2d_block_bf16",
                      "coupled2d_block_f32", "coupled2d_block_bf16"))
dev = torch.device("cuda", 0)
out = {}
for (label, family, key, m, x, step1, kern, plain, cells,
     flops) in cs.block_speed_cases(dev):
    if family != "K3":
        continue
    for t in (2, 4):
        out[f"{label} T={t}"] = cs._time_steps(
            lambda y: kern(y, m, t), x, max(200 // t, 10), dev) / t
    del m, x
for (label, family, key, m, x, step1, kern, plain,
     cells) in cs.block3_speed_cases(dev):
    if family != "K5c-T":
        break
    for t in (2, 4):
        out[f"{label} T={t}"] = cs._time_steps(
            lambda y: kern(y, m, t), x, max(100 // t, 10), dev) / t
    del m, x
print(json.dumps({k: v * 1e3 for k, v in out.items()}))
"""
# "bits": the outputs of 10 steps of K10 (this checkout's SC3D_CASES), K11
# (its SINGLE3D_CASES), K9t (its CG3D_TRANSPORT_CASES but the grain pack),
# K8 (its SC_KERNEL_CASES at 100 x 64), K1 / K2 / K6 (its split_cases) and
# K4c / K4h / K4s (the first four PERT_CASES, both at 100 x 72) and of two
# calls of K11-T and K8-T at T = 4 in f64, f32 and bf16, a SHA-256 each,
# and of K10, K11, K11-T, K8, K8-T, K1 / K6 and K4c / K4s in f32 (K8, K8-T,
# K1 / K6 and K4c / K4s in f64 too) built with -fmad=false (no a * b + c
# contracted into an FMA), so that equal hashes show equal bits; the
# states but K9t's also go to a file, so that the two checkouts' largest
# difference is printed
TURN_BITS = r"""
import hashlib, importlib.util, json, sys, torch
spec = importlib.util.spec_from_file_location("cases", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from openlbmpm_torch.kernels import build, cg3d, csf, flow3d, shanchen
from openlbmpm_torch.models.colorgradient import (
    CGBoundaryConfig, ColorGradientParams, ColorGradientRK)
nofma = sys.argv[2] == "nofma"
if nofma:
    for lib in ("flow3d_f32", "flow3d_block_f32", "sc2d_f64", "sc2d_f32",
                "sc2d_block_f32", "csf2d", "pert2d", "coupled2d"):
        build.EXTRA_FLAGS[lib] = ("-fmad=false",)
from openlbmpm_torch.models.flow3d import SinglePhaseD3Q19
dev = torch.device("cuda", 0)
sha = lambda ts: hashlib.sha256(b"".join(
    t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()
    for t in ts)).hexdigest()[:16]
# the states to compare as float64 (bf16 as stored, converted exactly)
keep = lambda x: x.detach().double().cpu()
out, states = {}, {}
kinds = ((torch.float64, "f32"), (torch.float32, "f32"), (torch.float32, "bf16"))
if nofma:
    kinds = kinds[:2]
for dtype, storage in kinds:
    tag = "bf16" if storage == "bf16" else str(dtype)[6:]
    for name in cs.SC_KERNEL_CASES:
        m, f = cs.sc_case(name, dev, ny=100, nx=64, dtype=dtype,
                          storage=storage)
        x0 = m.pack_state_bf16(f) if storage == "bf16" else f
        for fam, fn, calls in (("K8", shanchen.sc_step, 10),
                               ("K8-T", lambda y, m: shanchen.
                                sc_block_step(y, m, 4), 2)):
            x = x0
            for _ in range(calls):
                x = fn(x, m)
            out[f"{fam} {tag} {name}"] = sha((x,))
            states[f"{fam} {tag} {name}"] = keep(x)
    # the 2-D colour-gradient steps: K1 / K2 / K6 on split_cases, K4c /
    # K4h / K4s on the first four Perturbation cases, 100 x 72
    cg_cases = [(name, p, b, csf.csf_step_compressed, csf.csf_step_split,
                 ("K1" if storage == "f32" else "K2", "K6"))
                for name, (p, b) in cs.split_cases().items()]
    for name in list(cs.PERT_CASES)[:4]:
        pf, bf = cs.pert_fields(name)
        cg_cases.append((name, ColorGradientParams(**pf),
                         CGBoundaryConfig(**bf), csf.pert_step_compressed,
                         csf.pert_step_split,
                         ("K4c" if storage == "f32" else "K4h", "K4s")))
    for name, p, b, one_c, one_s, fams in cg_cases:
        m = ColorGradientRK(cs.walled(100, 72), p, b, dtype=dtype,
                            device=dev, storage=storage)
        st = m.init_state_layers(1.0, 1.0, invading_rows=20)
        runs = []
        if b.inlet != "neumann_per_color":
            runs.append((fams[0], one_c, m.pack_state_bf16(*st)
                         if storage == "bf16" else m.pack_state(*st)))
        if storage != "bf16":
            runs.append((fams[1], one_s, st))
        for fam, fn, x in runs:
            for _ in range(10):
                x = fn(x, m)
            xs = x if isinstance(x, tuple) else (x,)
            out[f"{fam} {tag} {name}"] = sha(xs)
            states[f"{fam} {tag} {name}"] = torch.cat([keep(y) for y in xs])
    # the coupled 2-D steps: K5c (compressed) and K5s (split) on phase 6's
    # tracer cases, 100 x 64
    for name, tp in cs.COUPLED_CASES.items():
        m = cs.coupled_model(dev, storage, tp, dtype=dtype, ny=100, nx=64)
        st = m.init_state(m.flow.init_state_layers(1.0, 1.0, invading_rows=20),
                          cs.coupled_conc0(m.tp.num_tracers, 100, 64))
        runs = [("K5c", lambda y: m.step_c(y), m.pack(st))]
        if storage != "bf16":
            runs.append(("K5s", lambda y: m.step(y), st))
        for fam, fn, x in runs:
            for _ in range(10):
                x = fn(x)
            xs = tuple(x)[:3]
            out[f"{fam} {tag} {name}"] = sha(xs)
            states[f"{fam} {tag} {name}"] = torch.cat(
                [keep(y).flatten() for y in xs])
    if nofma and dtype == torch.float64:
        continue
    for name in cs.SC3D_CASES:
        m, f = cs.sc3d_case(name, dev, dtype=dtype, storage=storage)
        x = m.pack_state_bf16(f) if storage == "bf16" else f
        for _ in range(10):
            x = flow3d.sc3d_step(x, m)
        out[f"K10 {tag} {name}"] = sha((x,))
        states[f"K10 {tag} {name}"] = keep(x)
    for name, (collision, force) in cs.SINGLE3D_CASES.items():
        m = SinglePhaseD3Q19(cs._walls_y((48, 40, 32), obstacle=True),
                             tau=0.8, collision=collision, body_force=force,
                             dtype=dtype, device=dev, storage=storage)
        f = cs.flow_start(m, seed=len(name))
        x0 = m.pack_state_bf16(f) if storage == "bf16" else f
        for fam, fn, calls in (("K11", flow3d.single3d_step, 10),
                               ("K11-T", lambda y, m: flow3d.
                                single3d_block_step(y, m, 4), 2)):
            x = x0
            for _ in range(calls):
                x = fn(x, m)
            out[f"{fam} {tag} {name}"] = sha((x,))
            states[f"{fam} {tag} {name}"] = keep(x)
    if nofma:
        continue
    for name in cs.CG3D_TRANSPORT_CASES:
        if name == "grain_pack":
            continue
        m, st = cs.transport3d_case(name, dev, dtype=dtype, storage=storage)
        x = m.pack(st)
        for _ in range(10):
            x = cg3d.coupled3d_step_compressed(*x, m)
        out[f"K9t {tag} {name}"] = sha(x)
torch.save(states, sys.argv[3])
print(json.dumps(out))
"""
# "sass": the 3-D one-step libraries' kernels as cuobjdump prints them, by
# library and kernel (the anonymous namespace's file tag dropped from the
# name): the instructions without addresses and encodings, and registers
SASS_LIBS = ("cg3d_f64", "cg3d_f32", "cg3d_bf16", "cg3d_local_f64",
             "cg3d_local_f32", "flow3d_f64", "flow3d_f32", "flow3d_bf16",
             "flow3d_local_f64", "flow3d_local_f32", "flow3d_block_f64",
             "flow3d_block_f32", "flow3d_block_bf16")
# "sass2d": the 2-D libraries beside the Shan-Chen ones (K1/K2/K6, K5c/K5s,
# K4, K7, K3, K5c-T, K7-T, K12a-c) and K8's bf16 pull
SASS2D_LIBS = ("csf2d", "coupled2d", "pert2d", "single2d_f32",
               "single2d_bf16", "csf2d_block_f32", "csf2d_block_bf16",
               "coupled2d_block_f32", "single2d_block_f32",
               "single2d_block_bf16", "csf2d_local_f32", "sc2d_local_f32",
               "sc2d_local_f64", "sc2d_bf16")
# kernels this checkout renamed: (pattern of this checkout's name, the
# other's name it replaces, from the pattern's groups: the storage type
# and the collision): K11's push for march_kernel with one fluid, K11-T's
# march for the brick-window kernel, the 2-D colour-gradient strip marches
# for collide_stream_kernel (K1 / K2 / K6) and pert_kernel (K4)
RENAMED = ((r"^18single_push_kernelI(\w)Li(\d)EE",
            r"^12march_kernelI{0}Li{1}ELi1E"),
           (r"^21single3d_march_kernelI(\w+?)Li(\d)EE",
            r"^19flow3d_block_kernelI{0}Li{1}ELi1E"),
           (r"^12strip_kernelI(\w+?)Li(\d)E",
            r"^21collide_stream_kernelI{0}Li{1}E"),
           (r"^17pert_strip_kernelI(\w+?)Li(\d)E",
            r"^11pert_kernelI{0}Li{1}E"))
TURN_SASS = r"""
import json, re, subprocess, sys
from openlbmpm_torch.kernels import build
libs = sys.argv[1].split(",")
build.load_libraries(libs)
tool = build._nvcc().replace("nvcc", "cuobjdump")
out = {}
for lib in libs:
    so = str(build.BUILD_DIR / f"lib{lib}-{build._digest(lib)}.so")
    def key(name):
        # the anonymous namespace's tag is the first component, its
        # length the digits after _ZN
        m = re.match(r"_ZN(\d+)_GLOBAL__N_", name)
        return name[m.end(1) + int(m.group(1)):] if m else name
    code, fn = {}, None
    for ln in subprocess.run([tool, "-sass", so], capture_output=True,
                             text=True, check=True).stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = key(m.group(1))
            code[fn] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", ln)
        if fn and m:
            code[fn].append(m.group(1))
    regs = {key(m.group(1)): int(m.group(2)) for m in re.finditer(
        r"Function (\S+):\s*REG:(\d+)", subprocess.run(
            [tool, "-res-usage", so], capture_output=True, text=True,
            check=True).stdout)}
    out[lib] = {fn: [" ; ".join(c), len(c), regs.get(fn)]
                for fn, c in code.items()}
print(json.dumps(out))
"""
TURN_K10H = r"""
import json, re, torch
import chip_smoke as cs
from openlbmpm_torch.kernels import build, flow3d
build.load_libraries(("flow3d_bf16",))
dev = torch.device("cuda", 0)
out = {}
for n in (128, 256):
    m = cs.probe_sc3d_model(dev, n=n, storage="bf16")
    f = m.pack_state_bf16(cs.probe_sc3d_start(cs.probe_sc3d_model(dev, n=n)))
    out[f"K10 bf16 {n}"] = cs._time_steps(
        lambda y: flow3d.sc3d_step(y, m), f, 100 if n == 128 else 20, dev) * 1e3
    del m, f
    torch.cuda.empty_cache()
mb = cs.basic3d_model(dev, storage="bf16")
fb = mb.pack_state_bf16(cs.flow_start(cs.basic3d_model(dev), seed=5))
out["K11 bf16 128"] = cs._time_steps(
    lambda y: flow3d.single3d_step(y, mb), fb, 100, dev) * 1e3
# each two-fluid bf16 kernel's registers, from the build's ptxas report
log = (build.BUILD_DIR / f"libflow3d_bf16-{build._digest('flow3d_bf16')}.log")
for name, regs in re.findall(r"Compiling entry function '(\w+)'.*?Used (\d+) "
                             r"registers", log.read_text(), re.S):
    m = re.search(r"\d+(\w+?_kernel)I13__nv_bfloat16((?:Li\d+E)+)", name)
    if m and m.group(2).endswith("Li2E"):
        out[f"registers {m.group(1)}{m.group(2)}"] = int(regs)
print(json.dumps(out))
"""
TURNS = {"3d": TURN, "2d": TURN_2D, "2dcg": TURN_2DCG, "3dT": TURN_3DT,
         "2dT": TURN_2DT,
         "bits": TURN_BITS, "sass": TURN_SASS, "sass2d": TURN_SASS,
         "k10h": TURN_K10H}


def partner(fn: str, other: dict):
    """The other checkout's kernel that `fn` (a key of this checkout's
    SASS) stands beside: the same name, or the one a RENAMED entry names;
    None where there is none."""
    import re
    if fn in other:
        return fn
    for mine, theirs in RENAMED:
        m = re.match(mine, fn)
        if m:
            pat = theirs.format(*m.groups())
            return next((k for k in other if re.match(pat, k)), None)
    return None


def turn(where: Path, family: str = "3d", args=()) -> dict:
    res = subprocess.run([sys.executable, "-c", TURNS[family], *args],
                         cwd=where, capture_output=True, text=True,
                         timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"turn in {where} failed:\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(args[0]).resolve()
    rounds = int(args[1]) if len(args) > 1 else 1
    family = args[2] if len(args) > 2 else "3d"
    if family not in TURNS:
        print(__doc__, file=sys.stderr)
        return 2
    if family in ("sass", "sass2d"):
        libs = SASS_LIBS if family == "sass" else SASS2D_LIBS
        got = {name: turn(other if name == "other" else ROOT, family,
                          (",".join(libs),))
               for name in ("other", "this")}
        for lib in libs:
            this, that = got["this"][lib], got["other"][lib]
            pair = {fn: partner(fn, that) for fn in this}
            print(json.dumps({"library": lib, "kernels": {
                fn: {"identical": fn in that and that[fn][0] == code,
                     "instructions": [n, that[pair[fn]][1] if pair[fn]
                                      else None],
                     "registers": [regs, that[pair[fn]][2] if pair[fn]
                                   else None]} | (
                    {"replaces": pair[fn]} if pair[fn] != fn and pair[fn]
                    else {})
                for fn, (code, n, regs) in sorted(this.items())},
                "only_other": sorted(set(that) - set(this) -
                                     set(pair.values()))}), flush=True)
        return 0
    if family == "bits":
        import tempfile
        import torch
        cases = str(ROOT / "chip_smoke.py")
        with tempfile.TemporaryDirectory() as tmp:
            for mode in ("fma", "nofma"):
                got = {name: turn(other if name == "other" else ROOT, family,
                                  (cases, mode, f"{tmp}/{name}.pt"))
                       for name in ("other", "this")}
                a, b = (torch.load(f"{tmp}/{name}.pt")
                        for name in ("this", "other"))
                print(json.dumps({"build": mode, "equal": {
                    k: got["this"][k] == got["other"].get(k)
                    for k in got["this"]}, "max_abs_diff": {
                    k: float((a[k] - b[k]).abs().max()) for k in a
                    if k in b}}), flush=True)
        return 0
    # timings: one other checkout ("other"), or several, comma-separated
    # (each named by its directory), in turns around this one's
    dirs = {"other": other} if "," not in args[0] else {
        d: Path(d).resolve() for d in args[0].split(",")}
    others = list(dirs)
    times = {name: [] for name in others + ["this"]}
    for _ in range(rounds):
        for name in others + ["this", "this"] + others[::-1]:
            ms = turn(dirs.get(name, ROOT), family)
            times[name].append(ms)
            print(json.dumps({"checkout": name, "ms": ms}), flush=True)
    print(json.dumps({"median_ms": {
        name: {k: statistics.median(t[k] for t in ts) for k in ts[0]}
        for name, ts in times.items()}}))
    spread = {}
    for k in times["this"][0]:
        lo = {name: min(t[k] for t in ts) for name, ts in times.items()
              if k in ts[0]}
        hi = {name: max(t[k] for t in ts) for name, ts in times.items()
              if k in ts[0]}
        spread[k] = {"this": [lo["this"], hi["this"]]}
        for name in others:
            if k in times[name][0]:
                key = "this_below_every_other" if name == "other" else \
                    f"this_below_every_{name}"
                spread[k][name] = [lo[name], hi[name]]
                spread[k][key] = hi["this"] < lo[name]
    print(json.dumps({"spread_ms": spread}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
