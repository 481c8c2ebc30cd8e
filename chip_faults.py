#!/usr/bin/env python3
"""Plant faults in the D3Q19 CSF kernel (K9) and its coupled tracer step
(K9t), and show that chip_smoke.py's phase 21 (configuration 5 at 128^3)
and phase 26 (benchmarks/probe_coupled3d.py's configuration at 128^3), each
kernel against its plain path, fail them.

    python3 chip_faults.py

Run from the repository root on a machine with a CUDA card and nvcc.  Each
case copies ``openlbmpm_torch`` (without its build directory) and
``chip_smoke.py`` into a temporary directory, changes one line of
``csrc/cg3d.cuh`` there, and runs its phases in a subprocess that builds the
copy's libraries and records every failed check instead of stopping at the
first.  The K9 faults drop the Guo source term on wetting fluid cells only
(the contact lines, where phase 21 compares against the plain path's
one-ulp twin) in one storage type's instance; the tracer fault applies the
hard interface bounce-back on the x and y axes only (the tracer then leaks
through the red phase across the periodic z seam) in the f32 instance:

  none        the sources as they are: phases 21 and 26 must pass;
  f32         float32 storage (K9c f32 and K9s f32): phase 21 must fail;
  bf16        bfloat16 storage (K9h): phase 21 must fail;
  tracer f32  float32 storage (K9t f32): phase 26 must fail.

Prints one line per case with the failed checks and the gaps off the seam,
and exits 0 only when every case behaves as stated.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LINE = "    post[i] = f[i] - (f[i] - feq) / tau + pref * src;"
# sizeof(S): the storage type (8 f64, 4 f32, 2 bf16); geo[k] > 1.5 is a
# wetting fluid cell
FAULT = ("    post[i] = f[i] - (f[i] - feq) / tau + "
         "(sizeof(S) == {size} && geo[k] > C(1.5) ? C(0) : pref) * src;")
CASES = {"none": None, "f32": 4, "bf16": 2}
# directions 5 and 6 of D3Q7 are +z and -z
TRACER_LINE = "      const bool repair = T.interface;"
TRACER_FAULT = ("      const bool repair = T.interface && "
                "(sizeof(S) != {size} || i < 5);")
TRACER_CASES = {"tracer f32": 4}

RUN = r"""
import json, sys, torch
import chip_smoke as cs
failed = {}
out = {}
device = torch.device("cuda", 0)
for phase in sys.argv[1:]:
    bad = failed.setdefault(phase, [])
    cs.check = lambda cond, what, bad=bad: cond or bad.append(what)
    if phase == "21":
        res = cs.phase_config5(device)
        parts = {"f32": res["f32"], "split": res["split"],
                 "bf16 planes": res["bf16"]["planes"],
                 "bf16 rho_r": res["bf16"]["rho_r"]}
    else:
        res = cs.phase_probe3d(device)
        parts = {"f32": res["f32"], "f32 tracer": res["f32_tracer"],
                 "bf16 planes": res["bf16"]["planes"],
                 "bf16 tracer": res["bf16"]["tracer"]}
    out[phase] = {key: {k: v[k] for k in ("away", "twin_away", "far")}
                  for key, v in parts.items()} | {"f64": res["f64"]}
print(json.dumps({"failed": failed, "gaps": out}))
"""


def run_case(line, fault, phases) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(ROOT / "openlbmpm_torch", Path(tmp, "openlbmpm_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", tmp)
        if fault is not None:
            cuh = Path(tmp, "openlbmpm_torch", "csrc", "cg3d.cuh")
            text = cuh.read_text()
            if text.count(line) != 1:
                raise RuntimeError(f"the line {line.strip()!r} of cg3d.cuh "
                                   "moved")
            cuh.write_text(text.replace(line, fault))
        out = subprocess.run([sys.executable, "-c", RUN, *phases], cwd=tmp,
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            raise RuntimeError(f"phases {phases} did not run:\n"
                               f"{out.stderr[-3000:]}")
        return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_faults: needs a CUDA card", file=sys.stderr)
        return 2
    cases = [("none", None, None, ("21", "26"))]
    cases += [(name, LINE, FAULT.format(size=size), ("21",))
              for name, size in CASES.items() if size is not None]
    cases += [(name, TRACER_LINE, TRACER_FAULT.format(size=size), ("26",))
              for name, size in TRACER_CASES.items()]
    ok = True
    for name, line, fault, phases in cases:
        r = run_case(line, fault, phases)
        want_fail = fault is not None
        for phase in phases:
            failed = bool(r["failed"][phase])
            ok &= failed == want_fail
            print(f"fault {name}: phase {phase} "
                  f"{'failed' if failed else 'passed'} (want "
                  f"{'fail' if want_fail else 'pass'})")
        print(f"fault {name}: " + json.dumps(r))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
