#!/usr/bin/env python3
"""Plant faults in the D3Q19 CSF kernel (K9) and show that chip_smoke.py's
phase 21 (configuration 5 at 128^3, kernel against plain path) fails them.

    python3 chip_faults.py

Run from the repository root on a machine with a CUDA card and nvcc.  Each
case copies ``openlbmpm_torch`` (without its build directory) and
``chip_smoke.py`` into a temporary directory, changes one line of
``csrc/cg3d.cuh`` there, and runs ``chip_smoke.phase_config5`` in a
subprocess that builds the copy's libraries and records every failed check
instead of stopping at the first.  The faults drop the Guo source term on
wetting fluid cells only (the contact lines, where phase 21 compares
against the plain path's one-ulp twin) in one storage type's instance:

  none  the source as it is: phase 21 must pass;
  f32   float32 storage (K9c f32 and K9s f32): phase 21 must fail;
  bf16  bfloat16 storage (K9h): phase 21 must fail.

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

RUN = r"""
import json, sys, torch
import chip_smoke as cs
failed = []
cs.check = lambda cond, what: cond or failed.append(what)
res = cs.phase_config5(torch.device("cuda", 0))
gaps = {k: res[k]["away"] for k in ("f32", "split")}
gaps |= {"bf16 " + k: res["bf16"][k]["away"] for k in ("planes", "rho_r")}
twin = {k: res[k]["twin_away"] for k in ("f32", "split")}
twin |= {"bf16 " + k: res["bf16"][k]["twin_away"] for k in ("planes", "rho_r")}
far = {k: res[k]["far"] for k in ("f32", "split")}
far |= {"bf16 " + k: res["bf16"][k]["far"] for k in ("planes", "rho_r")}
print(json.dumps({"failed": failed, "away": gaps, "twin_away": twin,
                  "far": far, "f64": res["f64"]}))
"""


def run_case(size) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(ROOT / "openlbmpm_torch", Path(tmp, "openlbmpm_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", tmp)
        if size is not None:
            cuh = Path(tmp, "openlbmpm_torch", "csrc", "cg3d.cuh")
            text = cuh.read_text()
            if text.count(LINE) != 1:
                raise RuntimeError("the collision line of cg3d.cuh moved")
            cuh.write_text(text.replace(LINE, FAULT.format(size=size)))
        out = subprocess.run([sys.executable, "-c", RUN], cwd=tmp,
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            raise RuntimeError(f"phase 21 did not run:\n{out.stderr[-3000:]}")
        return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_faults: needs a CUDA card", file=sys.stderr)
        return 2
    ok = True
    for name, size in CASES.items():
        r = run_case(size)
        want_fail = size is not None
        ok &= bool(r["failed"]) == want_fail
        print(f"fault {name}: phase 21 {'failed' if r['failed'] else 'passed'}"
              f" (want {'fail' if want_fail else 'pass'}); " + json.dumps(r))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
