"""Temporal blocking of the D3Q19 single-phase (K11-T) and Shan-Chen (K10-T)
steps and the CLI's ``--block`` for basic3d and sc3d, on the CPU.

* ``SinglePhaseD3Q19.make_block_step`` and ``ShanChenMCMP3D.
  make_block_step`` of the port (on the CPU: T plain steps) against the
  JAX package's blocked Pallas kernels (``build_single3d_fused_step`` and
  ``build_sc3d_fused_step`` with ``steps_per_call=2``, ``slabs_per_block=4``)
  in interpret mode, at f64 to 1e-12 over 4 steps on a 16 x 8 x 8 box
  with walls on the y faces and an obstacle: SRT and TRT with and without
  the body force; K = 1, 2 and 3 fluids, with the adhesion field and a body
  force;
* the bf16 state at T = 2 decoded once and encoded once, as JAX's;
* ``make_block_step`` returns None exactly where the JAX builders build no
  kernel (MRT; psi other than rho), and ignores their slab knobs;
* ``run --model basic3d|sc3d``: CPU runs stay unblocked, and a blocked run
  (``--block 4`` with blocking let through) writes the results, metrics
  and checkpoint of ``--block 1``.

The CUDA kernels are held to these plain versions on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phases 53-57.
"""

import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openlbmpm_tpu import geometry as geo
from openlbmpm_tpu.lattice import D3Q19
from openlbmpm_tpu.models import flow3d as jf
from openlbmpm_tpu.ops import equilibrium as jeq
from openlbmpm_tpu.pallas.sc3d import build_sc3d_fused_step
from openlbmpm_tpu.pallas.single3d import build_single3d_fused_step
from openlbmpm_torch import cli as tcli
from openlbmpm_torch.convert import params_from_jax, single_phase_args_from_jax
from openlbmpm_torch.kernels.flow3d import (sc3d_block_step,
                                            single3d_block_step)
from openlbmpm_torch.models.flow3d import ShanChenMCMP3D, SinglePhaseD3Q19
from test_torch_cli import _ini, _records, _results, _same_arrays
from test_torch_cli_flow import RUNS

torch.set_num_threads(1)
CPU = "cpu"   # the port's models run on the card unless told otherwise
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (16, 8, 8)         # (nz, ny, nx): the smallest the JAX builders take
SC = {
    1: dict(g_matrix=((0.0,),), g_solid=(-0.2,), tau=(0.9,),
            body_force=(0.0, 0.0, 2e-5)),
    2: dict(g_matrix=((0.0, 3.6), (3.6, 0.0)), g_solid=(-0.3, 0.3),
            tau=(1.0, 0.8), body_force=(1e-5, -2e-5, -1e-5)),
    3: dict(g_matrix=((0.0, 2.0, 1.0), (2.0, 0.0, 1.5), (1.0, 1.5, 0.0)),
            g_solid=(0.1, -0.2, 0.0), tau=(1.0, 0.8, 1.2),
            body_force=(0.0, 1e-5, 0.0)),
}


def _geometry():
    solid = np.zeros(SHAPE, bool)
    solid[:, 0, :] = solid[:, -1, :] = True
    solid[5:8, 3:5, 2:5] = True
    return geo.from_solid_mask(solid)


def _perturbed(seed, k=None):
    """A perturbed equilibrium on the fluid (numpy, f64)."""
    rng = np.random.default_rng(seed)
    lead = () if k is None else (k,)
    rho = rng.uniform(0.97, 1.03, lead + SHAPE)
    if k is not None:
        rho *= np.array([1.0, 0.3, 0.6][:k]).reshape(-1, 1, 1, 1)
    u = tuple(jnp.asarray(rng.uniform(-0.02, 0.02, lead + SHAPE))
              for _ in range(3))
    f = np.asarray(jeq.feq_quadratic(D3Q19, jnp.asarray(rho), u))
    return f * _geometry().is_fluid


def _single(collision, force, dtype=jnp.float64, storage="f32"):
    g = _geometry()
    mj = jf.SinglePhaseD3Q19(g, tau=0.8, collision=collision,
                             body_force=(2e-5, -1e-5, 3e-5) if force
                             else (0.0, 0.0, 0.0), dtype=dtype,
                             use_pallas=False)
    mt = SinglePhaseD3Q19(g, **single_phase_args_from_jax(mj),
                          dtype=torch.float64 if dtype == jnp.float64
                          else torch.float32, device=CPU)
    return mj, mt


def _sc(k, dtype=jnp.float64, **change):
    g = _geometry()
    p = jf.ShanChenParams3D(**SC[k] | change)
    mj = jf.ShanChenMCMP3D(g, p, dtype=dtype, use_pallas=False)
    mt = ShanChenMCMP3D(g, params_from_jax(p), dtype=torch.float64
                        if dtype == jnp.float64 else torch.float32,
                        device=CPU)
    return mj, mt


def _four_steps(jblk, blk, f):
    a, b = jnp.asarray(f), torch.from_numpy(f.copy())
    for _ in range(2):
        a, b = jblk(a), blk(b)
    assert bool(torch.isfinite(b).all())
    return float(np.abs(b.numpy() - np.asarray(a)).max())


@pytest.mark.parametrize("collision,force", [("SRT", False), ("SRT", True),
                                             ("TRT", False), ("TRT", True)])
def test_single3d_block_matches_jax_kernel_f64(collision, force):
    """4 steps in calls of T = 2 against the JAX blocked K11, to 1e-12."""
    mj, mt = _single(collision, force)
    jblk = build_single3d_fused_step(mj.geo, mj.tau, collision,
                                     mj.body_force, jnp.float64,
                                     slabs_per_block=4, steps_per_call=2,
                                     interpret=True)
    blk = mt.make_block_step(steps_per_call=2)
    assert blk.steps_per_call == 2
    assert _four_steps(jblk, blk, _perturbed(0)) < 1e-12


@pytest.mark.parametrize("k", [1, 2, 3])
def test_sc3d_block_matches_jax_kernel_f64(k):
    """4 steps in calls of T = 2 against the JAX blocked K10 (walls, an
    obstacle, the adhesion field and a body force), to 1e-12."""
    mj, mt = _sc(k)
    jblk = build_sc3d_fused_step(mj.geo, mj.p, jnp.float64,
                                 slabs_per_block=4, steps_per_call=2,
                                 interpret=True)
    blk = mt.make_block_step(steps_per_call=2)
    assert blk.steps_per_call == 2
    assert _four_steps(jblk, blk, _perturbed(k, k)) < 1e-12


def test_sc3d_bf16_block_matches_jax_kernel():
    """K = 2 in bf16 storage at T = 2 from a common bf16 state (packing bit
    for bit): one call decoded, held to the JAX blocked kernel within the
    T=1 K10 bf16 bound of phase 37, 3e-3 (the two f32 paths sum the
    interaction stencil in different orders)."""
    mj, mt = _sc(2, dtype=jnp.float32)
    jblk = build_sc3d_fused_step(mj.geo, mj.p, jnp.float32,
                                 slabs_per_block=4, steps_per_call=2,
                                 interpret=True, storage="bf16")
    blk = mt.make_block_step(steps_per_call=2, storage="bf16")
    f = _perturbed(5, 2).astype(np.float32)
    h = mj.pack_state_bf16(jnp.asarray(f))
    ht = mt.pack_state_bf16(torch.from_numpy(f))
    np.testing.assert_array_equal(ht.view(torch.int16).numpy(),
                                  np.asarray(h).view(np.int16))
    got = mt.unpack_bf16(blk(ht)).numpy()
    want = np.asarray(mj.unpack_bf16(jblk(h)))
    assert float(np.abs(got - want).max()) < 3e-3


def test_make_block_step_refuses_as_the_jax_builders():
    """None for MRT (single3d.py:58-59; the step runs it as TRT) and for
    psi other than rho (sc3d.py:106-107), as the JAX builders; the slab
    knobs that make the JAX builders refuse a shape (slabs_per_block not
    dividing nz) are ignored; T = 1 gives ``step``; on CPU tensors the
    wrappers are their plain versions and count no launch."""
    mj, mt = _single("MRT", False)
    assert build_single3d_fused_step(mj.geo, mj.tau, "MRT", mj.body_force,
                                     jnp.float64, slabs_per_block=4,
                                     steps_per_call=2) is None
    assert mt.make_block_step(steps_per_call=2) is None
    mj, mt = _sc(2, psi="PR")
    assert build_sc3d_fused_step(mj.geo, mj.p, jnp.float64,
                                 slabs_per_block=4, steps_per_call=2) is None
    assert mt.make_block_step(steps_per_call=2) is None
    mj, mt = _single("TRT", True)
    assert build_single3d_fused_step(mj.geo, mj.tau, "TRT", mj.body_force,
                                     jnp.float64, slabs_per_block=5,
                                     steps_per_call=2) is None
    blk = mt.make_block_step(steps_per_call=2, slabs_per_block=5)
    assert blk is not None and mt.make_block_step(1) == mt.step
    f = torch.from_numpy(_perturbed(2))
    before = single3d_block_step.launches
    want = f
    for _ in range(3):
        want = mt.plain_step(want)
    assert torch.equal(single3d_block_step(f, mt, 3), want)
    assert single3d_block_step.launches == before
    _, ms = _sc(1)
    fs = torch.from_numpy(_perturbed(3, 1))
    before = sc3d_block_step.launches
    assert torch.equal(sc3d_block_step(fs, ms, 2),
                       ms.plain_step(ms.plain_step(fs)))
    assert sc3d_block_step.launches == before
    with pytest.raises(ValueError):
        mt.make_block_step(steps_per_call=0)
    with pytest.raises(ValueError, match="float32"):
        mt.make_block_step(steps_per_call=2, storage="bf16")


def _run(argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert tcli.main(argv) == 0
    return out.getvalue()


@pytest.mark.parametrize("model", ["basic3d", "sc3d"])
def test_cli_blocked_run_equals_block_1(tmp_path, monkeypatch, model):
    """run --model basic3d|sc3d on tests/test_torch_cli_flow.py's cut INIs
    (outputs every 8 / 6 steps, 16 / 12 steps): on the CPU --block 4 runs
    unblocked with the JAX CLI's note; with blocking let through (T plain
    steps a call on the CPU) --block 4 (basic3d) or the default (sc3d: 4
    does not divide 6, so T = 2) writes the results, metrics and checkpoint
    of --block 1."""
    name, edits, basename, _, _ = RUNS[model]
    edits = edits | ({"TimeInterval = .*": "TimeInterval = 8",
                      "TimeLength = .*": "TimeLength = 16"}
                     if model == "basic3d" else
                     {"TimeInterval = .*": "TimeInterval = 6",
                      "numberTimeStep = .*": "numberTimeStep = 12"})
    ini = _ini(tmp_path, os.path.join(ROOT, "configs", name), name, edits)
    common = ["run", ini, "--model", model, "--device", "cpu", "--dtype",
              "f64"]
    text = _run(common + ["--block", "4", "--output", str(tmp_path / "c")])
    assert "one step a launch" in text
    assert "note: --block unsupported for this config" in text
    _run(common + ["--block", "1", "--output", str(tmp_path / "a")])
    monkeypatch.setattr(tcli, "_blocks_on", lambda m: True)
    block = "4" if model == "basic3d" else "0"
    text = _run(common + ["--block", block, "--output", str(tmp_path / "b")])
    assert ("4 steps a launch" if model == "basic3d" else
            "2 steps a launch") in text
    ra, rb = (_records(tmp_path / d / "metrics.jsonl") for d in "ab")
    assert [r["step"] for r in ra] == [r["step"] for r in rb]
    for x, y in zip(ra, rb):
        for key in x:
            if key not in ("mlups", "steps_per_s"):
                assert x[key] == pytest.approx(y[key], rel=1e-12,
                                               abs=1e-15), key
    _same_arrays(_results(tmp_path / "a", basename),
                 _results(tmp_path / "b", basename))
    ca, cb = (np.load(tmp_path / d / "checkpoint.npz") for d in "ab")
    assert sorted(ca.files) == sorted(cb.files)
    for key in ca.files:
        np.testing.assert_array_equal(ca[key], cb[key])
