"""2-D domain decomposition over a ``ProcessMesh``: four CPU ranks of a gloo
process group, spawned by ``openlbmpm_torch.parallel.dryrun.run_ranks``
(the worker lives in the port, so a child imports torch and the port,
never this module, JAX or conftest), rendezvous through a file, the group
and the join each with a deadline.

* K12a on a 4-shard y-mesh at T = 1 and K12a with transport on a (2, 2)
  mesh, both at 64 x 64 f64, K12d on a (2, 2) z*y mesh at 16 x 64 x 16
  f64, and K12c (the dry run's ``sc_y`` line) on a 4-shard y-mesh at 64 x
  64 f64, T = 2 (``dryrun.TEST_CASES``), 4 steps: the gathered state
  equals the ``LocalMesh`` result bit for bit, and the JAX package's
  compressed ``_step_impl_c`` / coupled step / 3-D compressed step (its
  Pallas kernel in interpret mode) / Shan-Chen ``_step_impl`` within 1e-12
  (the JAX side runs in this process);
* ``python -m openlbmpm_torch.parallel.dryrun --ranks 4 --device cpu``
  exits 0 and prints its lines.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openlbmpm_tpu.models import colorgradient as jcg
from openlbmpm_tpu.models import flow3d as jf
from openlbmpm_tpu.models import shanchen as js
from openlbmpm_tpu.models import transport as jtr
from openlbmpm_tpu.pallas.cg3d import build_cg3d_fused_step
from openlbmpm_torch.parallel import dryrun, make_mesh
from test_torch_transport import _jax_compressed_coupled_step

torch.set_num_threads(1)
CPU = "cpu"   # the port's meshes run on the card unless told otherwise
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 90.0


def _jax_reference(name, start):
    """The JAX single-device steps of a TEST_CASES case from the port's
    start arrays, 4 steps: ``_step_impl_c`` (CSF), the coupled step with
    its flow half compressed (``tests/test_torch_transport.py``), the 3-D
    compressed kernel in interpret mode, or the Shan-Chen jnp
    ``_step_impl``."""
    family, shape, _, _ = dryrun.TEST_CASES[name]
    g, kw, _ = dryrun.case_model(family, shape, torch.float64)
    if family == "sc":
        m = js.ShanChenMCMP(g, js.ShanChenParams(**vars(kw["params"])),
                            js.SCBoundaryConfig(**vars(kw["bc_config"])),
                            dtype=jnp.float64, use_pallas=False)
        f = jnp.asarray(start[0].numpy())
        for _ in range(4):
            f = m._step_impl(f)
        return (np.asarray(f),)
    if family == "cg3d":
        fused = build_cg3d_fused_step(
            g, jf.ColorGradientParams3D(**vars(kw["params"])), jnp.float64,
            slabs_per_block=8, bc_config=jf.CG3DBoundaryConfig(
                **vars(kw["bc_config"])), state_mode="compressed",
            interpret=True)
        s = jnp.asarray(start[0].numpy())
        for _ in range(4):
            s = fused(s)
        return (np.asarray(s),)
    flow = jcg.ColorGradientParams(**vars(kw["params"]))
    bcs = jcg.CGBoundaryConfig(**vars(kw["bc_config"]))
    s = jnp.asarray(start[0].numpy())
    if family == "csf":
        m = jcg.ColorGradientRK(g, flow, bcs, dtype=jnp.float64,
                                use_pallas=False)
        for _ in range(4):
            s = m._step_impl_c(s)
        return (np.asarray(s),)
    tp = jtr.TransportParams(**vars(kw["transport_params"]))
    m = jtr.TransportRK(g, flow, tp, bcs, dtype=jnp.float64,
                        use_pallas=False)
    gg = jnp.asarray(start[1].numpy())
    mass0 = jnp.sum(gg, axis=(1, 2, 3))
    for _ in range(4):
        s, gg = _jax_compressed_coupled_step(m, s, gg, mass0)
    return np.asarray(s), np.asarray(gg)


@pytest.mark.parametrize("name", list(dryrun.TEST_CASES))
def test_process_mesh_matches_local_and_jax(name, tmp_path):
    dryrun.run_ranks(4, "cpu", job=name, out_dir=str(tmp_path),
                     timeout_s=TIMEOUT)
    got = torch.load(tmp_path / f"{name}.pt")
    family, shape, mshape, steps = dryrun.TEST_CASES[name]
    local, start, _ = dryrun.run_case(
        family, shape, make_mesh(shape=mshape, kind="local", device=CPU),
        steps, torch.float64, calls=4 // steps, compare=False)
    for a, b in zip(got["out"], local):
        assert torch.equal(a, b)
    for a, b in zip(got["start"], start):
        assert torch.equal(a, b)
    ref = _jax_reference(name, start)
    for a, b in zip(local, ref):
        assert float(np.abs(a.numpy() - b).max()) <= 1e-12


def test_dryrun_over_gloo_ranks():
    out = subprocess.run(
        [sys.executable, "-m", "openlbmpm_torch.parallel.dryrun", "--ranks",
         "4", "--device", "cpu", "--timeout", str(TIMEOUT)],
        capture_output=True, text=True, timeout=TIMEOUT + 30, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == len(dryrun.CASES)
    assert all(ln.startswith("dryrun_multichip ") and
               "max |diff| vs one device 0.000e+00" in ln for ln in lines)
