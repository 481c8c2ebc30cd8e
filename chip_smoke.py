#!/usr/bin/env python3
"""Drive openlbmpm_torch's main path on one NVIDIA GPU and check its kernel.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA; JAX is not needed.  Phases:

  1. the card (name and power limit from nvidia-smi);
  2. build the CUDA kernels from ``openlbmpm_torch/csrc``;
  3. f64: kernel against the plain PyTorch step, 20 steps on a 256x128
     walled channel with a layered interface (contact lines on both walls),
     Neumann inlet, Dirichlet outlet, MRT; max |difference| <= 1e-11;
  4. the flagship configuration (1024^2, bench.py's parameters), 10 steps of
     kernel and plain path at f64 (<= 1e-11), in f32 (<= 3e-5 off the
     inlet/outlet seam rows and the corners where they meet the walls, and
     no further from f64 than the plain f32 path) and in bf16 storage
     (planes <= 3e-4 and rho_r <= 1e-4 off the seam, no further from f64
     than the plain bf16 path; then one more step of each from the same
     bf16 state, which must agree to 1 bf16 ulp per stored value, the lo
     half of rho_r wherever the hi half agrees, with at most 1e-3 of the
     values >= 1e-4 off at all, a check that a round-toward-zero or
     dropped-lo encoding of the plain result is shown to fail);
  5. the main path: ``run_chunked(model.step_c, ...)`` for 2000 bf16 steps
     with the NaN guard, the kernel's launch count checked, then MLUPS of
     kernel (f32, bf16) and plain path (f32, bf16), and each CUDA kernel's
     device time per launch from ``torch.profiler``.

Every phase prints one line and any failure exits non-zero.  The line
before the last is a JSON summary of the kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

FLAGSHIP_N = 1024
MAIN_STEPS = 2000


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def walled(ny, nx):
    from openlbmpm_torch import geometry
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    return geometry.from_solid_mask(solid)


def flagship_model(device, storage, dtype=torch.float32, n=FLAGSHIP_N):
    """bench.py's flagship: 1024^2 CSF MRT, Akai wetting, tau_type 2,
    Neumann inlet at v = -1e-4, Dirichlet outlet with the phi repair."""
    from openlbmpm_torch.models.colorgradient import (
        CGBoundaryConfig, ColorGradientParams, ColorGradientRK)
    params = ColorGradientParams(
        tau_r=1.0, tau_b=1.0, surface_tension=0.1, contact_angle_deg=60.0,
        beta=0.7, delta=0.98, tau_type=2, wetting_type=2, variant="CSF",
        collision="MRT")
    bcs = CGBoundaryConfig(inlet="neumann", outlet="dirichlet",
                           inlet_velocity=-1e-4, outlet_density_r=0.0,
                           outlet_density_b=1.0)
    return ColorGradientRK(walled(n, n), params, bcs, dtype=dtype,
                           device=device, storage=storage)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def phase_f64(device, ny=256, nx=128, steps=20, tol=1e-11):
    """Kernel vs plain at f64 on the golden setup scaled up."""
    from openlbmpm_torch.kernels.csf import (
        csf_step_compressed, csf_step_compressed_reference)
    from openlbmpm_torch.models.colorgradient import (
        CGBoundaryConfig, ColorGradientParams, ColorGradientRK)
    params = ColorGradientParams(
        variant="CSF", collision="MRT", surface_tension=0.01, tau_r=1.0,
        tau_b=0.8, tau_type=2, wetting_type=2, contact_angle_deg=60.0)
    bcs = CGBoundaryConfig(inlet="neumann", outlet="dirichlet",
                           inlet_velocity=-1e-4, outlet_density_r=0.0,
                           outlet_density_b=1.0)
    m = ColorGradientRK(walled(ny, nx), params, bcs, dtype=torch.float64,
                        device=device)
    a = m.pack_state(*m.init_state_layers(1.0, 1.0, invading_rows=ny // 5))
    b = a.clone()
    err = 0.0
    for _ in range(steps):
        a = csf_step_compressed(a, m)
        b = csf_step_compressed_reference(b, m)
        err = max(err, float((a - b).abs().max()))
    check(bool(torch.isfinite(a).all()), "f64 kernel state not finite")
    check(err <= tol, f"f64 kernel vs plain {err:.3e} > {tol:g}")
    return err


def phase_flagship(device, n=FLAGSHIP_N, steps=10):
    """Kernel vs plain at the flagship size: f64, f32 and bf16 storage, all
    from one f64 initial state.

    f32 and bf16 are held to the f64 plain run as well as to the plain
    run in their own storage.  On the boundary rows (0, 1, ny-2, ny-1: the
    periodic seam between the red inlet and the blue outlet is an
    interface) and at the four corners where that seam meets the wetting
    walls, wetting tie-breaks flip under 1-ulp differences, and there the
    plain f32 path is itself ~3e-3 away from f64.  So there the kernel is
    held to be no further from f64 than the plain path; elsewhere the two
    paths agree to 3e-5 (f32), and to about ten times their measured gap
    in bf16 storage.  One further bf16 step from a common state is held
    to one ulp of each stored value (off the seam), which a wrong
    rounding mode or a dropped lo plane of rho_r cannot meet."""
    from openlbmpm_torch.kernels.csf import (
        csf_step_compressed, csf_step_compressed_reference)

    def run(s, m, fn):
        for _ in range(steps):
            s = fn(s, m)
        return s

    res = {}
    m64 = flagship_model(device, "f32", dtype=torch.float64, n=n)
    s64 = m64.pack_state(*m64.init_state_layers(
        1.0, 1.0, invading_rows=100 * n // 1024))
    p64 = run(s64, m64, csf_step_compressed_reference)
    k64 = run(s64, m64, csf_step_compressed)
    res["f64"] = float((k64 - p64).abs().max())
    check(res["f64"] <= 1e-11, f"f64 kernel vs plain {res['f64']:.3e} > 1e-11")

    corner = steps + 2     # tie-break noise spreads about a cell per step
    away = torch.ones((n, n), dtype=torch.bool, device=device)
    away[[0, 1, n - 2, n - 1], :] = False
    for ys in (slice(0, corner), slice(n - corner, n)):
        for xs in (slice(0, corner), slice(n - corner, n)):
            away[ys, xs] = False
    seam = ~away
    seam[:, :corner] = False
    seam[:, n - corner:] = False
    # bounds off the seam rows and corners: (PDF planes, rho_r)
    bounds = {"f32": (3e-5, 3e-5), "bf16": (3e-4, 1e-4)}
    for storage in ("f32", "bf16"):
        m = flagship_model(device, storage, n=n)
        s0 = s64.float() if storage == "f32" \
            else m.pack_compressed_bf16(s64.float())
        a = run(s0, m, csf_step_compressed)
        b = run(s0, m, csf_step_compressed_reference)
        if storage == "bf16":
            res["ulp"] = bf16_one_step(m, b, away)
            a, b = m.unpack_bf16(a), m.unpack_bf16(b)
        check(bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all()),
              f"{storage}: state not finite")
        d = (a - b).abs()
        planes, rho_r = float(d[:9, away].max()), float(d[9, away].max())
        acc_k = float((a.double() - p64).abs().max())
        acc_p = float((b.double() - p64).abs().max())
        check(planes <= bounds[storage][0], f"{storage} planes |diff| off "
              f"the seam {planes:.3e} > {bounds[storage][0]:g}")
        check(rho_r <= bounds[storage][1], f"{storage} rho_r |diff| off "
              f"the seam {rho_r:.3e} > {bounds[storage][1]:g}")
        check(acc_k <= 1.5 * acc_p, f"{storage} kernel is {acc_k:.3e} from "
              f"f64, the plain path {acc_p:.3e}")
        tot_k, tot_p, tot_0 = (float(x[9].double().sum()) for x in (a, b, s64))
        drift = abs(tot_k - tot_p) / tot_p
        change = abs(tot_k - tot_0) / tot_0
        check(drift <= 1e-4, f"{storage}: total rho_r kernel vs plain {drift:.2e}")
        check(change <= 1e-4, f"{storage}: total rho_r change {change:.2e}")
        res[storage] = {
            "max": float(d.max()), "planes": planes, "rho_r": rho_r,
            "seam": float(d[:, seam].max()), "from_f64": (acc_k, acc_p),
            "mass": (drift, change)}
    return res


def _bf16_rz(x):
    """x rounded toward zero to bfloat16 (a wrong rounding mode)."""
    return (x.float().view(torch.int32) & ~0xFFFF).view(
        torch.float32).to(torch.bfloat16)


def bf16_one_step(m, s, away, max_share=1e-3):
    """Kernel and plain bf16 step from the common bf16 state `s`, held
    value by value off the seam to one bf16 ulp (``compare_bf16_states``)
    with at most `max_share` of the values of magnitude >= 1e-4 off at
    all.  Two faulty encodings of the plain path's own f32 result, one
    rounding toward zero and one dropping the lo plane of rho_r, must
    fail the same check."""
    from openlbmpm_torch.kernels.csf import (
        compare_bf16_states, csf_step_compressed, csf_step_compressed_reference)
    plain = csf_step_compressed_reference(s, m)
    r = compare_bf16_states(csf_step_compressed(s, m), plain, away)
    check(r["excess"] <= 1.0, f"bf16 one step: a value {r['excess']:.3g} "
          "ulp off the plain path")
    check(r["share"] <= max_share, f"bf16 one step: {r['share']:.2e} of the "
          f"values differ > {max_share:g}")
    x = m.plain_step_c(m.unpack_bf16(s))
    w = torch.as_tensor(m.lat.w, dtype=x.dtype, device=x.device)
    hi = _bf16_rz(x[9])
    rz = torch.cat([_bf16_rz(x[:9] - w.reshape(-1, 1, 1) * m.fluid_mask),
                    hi[None], _bf16_rz(x[9] - hi.float())[None]])
    no_lo = plain.clone()
    no_lo[10] = 0
    r["rz_share"] = compare_bf16_states(rz, plain, away)["share"]
    r["no_lo_excess"] = compare_bf16_states(no_lo, plain, away)["excess"]
    check(r["rz_share"] > max_share and r["no_lo_excess"] > 1.0,
          f"bf16 one-step check cannot see a rounding-toward-zero "
          f"({r['rz_share']:.2e}) or dropped-lo ({r['no_lo_excess']:.3g}) "
          "encoding")
    return r


def _time_steps(step, s, n, device):
    """Seconds per step over `n` steps after a warm-up, CUDA events."""
    for _ in range(5):
        s = step(s)
    torch.cuda.synchronize(device)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        s = step(s)
    t1.record()
    torch.cuda.synchronize(device)
    return t0.elapsed_time(t1) / 1e3 / n


def phase_main(device, n=FLAGSHIP_N, steps=MAIN_STEPS, kernel_steps=500,
               plain_steps=50):
    """The main path through the model's public step, then timings."""
    from openlbmpm_torch.kernels.csf import (
        csf_step_compressed, csf_step_compressed_reference)
    from openlbmpm_torch.models.base import RunMetrics, run_chunked
    m = flagship_model(device, "bf16", n=n)
    s = m.pack_state_bf16(*m.init_state_layers(1.0, 1.0,
                                               invading_rows=100 * n // 1024))
    meter = RunMetrics(n * n)
    csf_step_compressed.launches = 0
    s = run_chunked(m.step_c, s, num_steps=steps, io_interval=500,
                    metrics=meter, nan_guard=True)
    launches = csf_step_compressed.launches
    check(launches == steps, f"kernel launched {launches} times, want {steps}")
    u = m.unpack_bf16(s)
    check(bool(torch.isfinite(u).all()), "main path state not finite")
    check(tuple(s.shape) == (11, n, n) and s.dtype == torch.bfloat16,
          f"main path state {tuple(s.shape)} {s.dtype}")

    models = {st: flagship_model(device, st, n=n) for st in ("f32", "bf16")}
    states = {"f32": models["f32"].pack_state(*models["f32"].init_state_layers(
        1.0, 1.0, invading_rows=100 * n // 1024)), "bf16": s}
    runs = {}
    # plain, kernel, kernel, plain -- twice over, keeping the best of each
    order = [("plain", "f32"), ("kernel", "f32"), ("kernel", "bf16"),
             ("plain", "bf16")]
    for path, st in order + order[::-1]:
        mdl = models[st]
        if path == "kernel":
            fn, k = (lambda x, mdl=mdl: csf_step_compressed(x, mdl)), \
                kernel_steps
        else:
            fn, k = (lambda x, mdl=mdl: csf_step_compressed_reference(x, mdl)), \
                plain_steps
        sec = _time_steps(fn, states[st], k, device)
        runs[(path, st)] = min(runs.get((path, st), float("inf")), sec)
    return {"launches": launches, "run_mlups": meter.mlups, "sec": runs,
            "profile": kernel_profile(models, states)}


KERNELS = ("phase_kernel", "normal_kernel", "collide_stream_kernel")


def kernel_profile(models, states, steps=100):
    """Device microseconds per launch of each CUDA kernel over `steps`
    steps, from torch.profiler; None where the trace shows no device time
    for a kernel."""
    from torch.profiler import ProfilerActivity, profile
    from openlbmpm_torch.kernels.csf import launch_csf2d
    out = {}
    for st, m in models.items():
        s = states[st]
        for _ in range(5):
            s = launch_csf2d(s, m.kernel_params, m.geo_planes)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                s = launch_csf2d(s, m.kernel_params, m.geo_planes)
            torch.cuda.synchronize()
        for k in KERNELS:
            out[(st, k)] = None
            for ev in prof.key_averages():
                t = getattr(ev, "device_time_total",
                            getattr(ev, "cuda_time_total", 0.0))
                if k in ev.key and ev.count and t:
                    out[(st, k)] = t / ev.count
    return out


def phase4_line(res) -> str:
    line = [f"phase 4 flagship 1024^2, 10 steps: f64 max |diff| "
            f"{res['f64']:.3e} (<= 1e-11)"]
    for st, (bp, br) in (("f32", (3e-5, 3e-5)), ("bf16", (3e-4, 1e-4))):
        r = res[st]
        line.append(
            f"{st}: off the seam rows and corners planes {r['planes']:.3e} "
            f"(<= {bp:g}), rho_r {r['rho_r']:.3e} (<= {br:g}); seam rows "
            f"{r['seam']:.3e}, max {r['max']:.3e}; from f64 kernel "
            f"{r['from_f64'][0]:.3e} vs plain {r['from_f64'][1]:.3e} "
            f"(<= 1.5x); total rho_r kernel vs plain {r['mass'][0]:.2e}, "
            f"change {r['mass'][1]:.2e} (<= 1e-4)")
    u = res["ulp"]
    line.append(
        f"bf16 one more step from a common state, off the seam: largest gap "
        f"{u['excess']:.3g} ulp (<= 1), {u['share']:.3e} of values >= 1e-4 "
        f"differ (<= 1e-3), {u['hi_flips']} rho_r hi flips; the same check "
        f"on round-toward-zero {u['rz_share']:.3e} differ, on a dropped "
        f"rho_r lo plane {u['no_lo_excess']:.3g} ulp")
    return "; ".join(line)


def phase5_lines(main_res, card, t_build, n=FLAGSHIP_N):
    mlups = {k: n * n / v / 1e6 for k, v in main_res["sec"].items()}
    return [
        f"phase 5 main path: run_chunked(step_c) {MAIN_STEPS} bf16 steps, "
        f"{main_res['launches']} kernel launches, "
        f"{main_res['run_mlups']:.1f} MLUPS incl. host loop; [{card}]",
        f"phase 5 MLUPS {n}^2 [{card}]: kernel f32 "
        f"{mlups[('kernel', 'f32')]:.1f}, kernel bf16 "
        f"{mlups[('kernel', 'bf16')]:.1f}, plain f32 "
        f"{mlups[('plain', 'f32')]:.1f}, plain bf16 "
        f"{mlups[('plain', 'bf16')]:.1f}; build {t_build:.2f} s",
        f"phase 5 torch.profiler device us per launch {n}^2 [{card}]: " +
        ", ".join(f"{k} {st} " + ("not measured" if v is None else f"{v:.2f}")
                  for (st, k), v in main_res["profile"].items())]


def ptxas_summary(log: str) -> str:
    """'kernel<type>: registers, smem, spill stores' per entry function of
    an `nvcc -Xptxas -v` log."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            mangled = m.group(1)
            base = next((k for k in ("phase_kernel", "normal_kernel",
                                     "collide_stream_kernel")
                         if k in mangled), mangled)
            kind = ("bf16" if "bfloat16" in mangled else
                    "f64" if re.search(r"I[^E]*d", mangled.split(base)[-1])
                    else "f32")
            name, spill = f"{base}<{kind}>", "?"
        elif name and "spill stores" in ln:
            spill = ln.split(",")[1].strip()
        elif name and "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append(f"{name} {regs} regs, "
                       f"{smem.group(1) if smem else 0} B smem, {spill}")
            name = None
    return " | ".join(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from openlbmpm_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)

    card = card_line()
    print(card)
    print(f"phase 1 card: {name}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    build.load_library("csf2d")
    t_build = time.perf_counter() - t0
    logs = list(build.BUILD_DIR.glob("libcsf2d-*.log"))
    report = ptxas_summary(max(logs, key=lambda p: p.stat().st_mtime)
                           .read_text()) if logs else "no build log"
    print(f"phase 2 build: csf2d in {t_build:.2f} s (nvcc "
          f"{build.build_seconds.get('csf2d', 0.0):.2f} s); ptxas: {report}")

    err64 = phase_f64(device)
    print(f"phase 3 f64 kernel vs plain, 256x128, 20 steps: max |diff| "
          f"{err64:.3e} (<= 1e-11)")

    res = phase_flagship(device)
    print(phase4_line(res))

    main_res = phase_main(device)
    for ln in phase5_lines(main_res, card, t_build):
        print(ln)
    print(json.dumps({"kernels": [{
        "name": "csf_step_compressed",
        "route": "cuda",
        "source": "openlbmpm_torch/csrc/csf2d.cu",
        "replaces": "openlbmpm_tpu/pallas/csf.py:147",
        "launches": main_res["launches"],
        "max_abs_err": res["bf16"]["max"],
        "ms": main_res["sec"][("kernel", "bf16")] * 1e3,
        "plain_ms": main_res["sec"][("plain", "bf16")] * 1e3,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
