"""Temporal blocking of the colour-gradient step (K3) and the CLI's
``--block``, on the CPU.

* ``ColorGradientRK.make_block_step`` of the port (on the CPU: T plain
  steps, bf16 decoded once and encoded once) against the JAX package's
  blocked Pallas kernel in interpret mode, on the 32 x 32 flagship channel
  of ``tests/test_pallas_csf.py`` (side walls, neumann inlet, Dirichlet
  outlet with the phi repair, MRT, Akai wetting): compressed f64 at T = 2
  and 4 to 1e-12, split f32 at T = 2 and 4 to the JAX tests' 3e-5, the
  Perturbation variant split and compressed at T = 2 (f64, 1e-12), and the
  bf16 compressed state at T = 2 within the K2 bounds;
* ``make_block_step`` returns None on exactly the JAX build function's
  refusals;
* ``cli._pick_block``: auto tries 4 then 2, an explicit non-divisor runs
  unblocked with a note, CPU runs stay unblocked, and a blocked run writes
  the results and metrics of ``--block 1`` (the callbacks' steps scaled
  back).

The CUDA kernels are held to these plain versions on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phases 45-47.
"""

import contextlib
import io
import json
import os
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import seam_masks
from openlbmpm_tpu import geometry as geo
from openlbmpm_tpu.models import colorgradient as jcg
from openlbmpm_tpu.pallas.csf import build_csf_fused_step
from openlbmpm_torch import cli as tcli
from openlbmpm_torch.convert import params_from_jax
from openlbmpm_torch.kernels.csf import (csf_block_compressed,
                                         csf_block_split)
from openlbmpm_torch.models.colorgradient import ColorGradientRK

torch.set_num_threads(1)
CPU = "cpu"   # the port's models run on the card unless told otherwise
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_BCS = dict(inlet="neumann", outlet="dirichlet", inlet_velocity=-1e-4,
                    outlet_density_r=0.0, outlet_density_b=1.0)
CSF = dict(variant="CSF", collision="MRT", surface_tension=0.01, tau_r=1.0,
           tau_b=0.8, tau_type=2, wetting_type=2)
PERT = dict(variant="Perturbation", collision="SRT", surface_tension=0.005,
            a_kr=0.005, a_kb=0.003, alpha_r=4 / 9, alpha_b=4 / 9,
            solid_phi=0.5, tau_r=1.0, tau_b=0.8)


def _models(pf, bf=FLAGSHIP_BCS, n=32, dtype=jnp.float64, storage="f32"):
    solid = np.zeros((n, n), bool)
    solid[:, 0] = solid[:, -1] = True
    g = geo.from_solid_mask(solid)
    jp, jb = jcg.ColorGradientParams(**pf), jcg.CGBoundaryConfig(**bf)
    mj = jcg.ColorGradientRK(g, jp, jb, dtype=dtype, use_pallas=False)
    mt = ColorGradientRK(g, params_from_jax(jp), params_from_jax(jb),
                         dtype=torch.float64 if dtype == jnp.float64
                         else torch.float32, device=CPU, storage=storage)
    return mj, mt


def _jax_block(mj, t, dtype, **kw):
    return build_csf_fused_step(mj.geo, mj.p, dtype,
                                rows_per_block=8 if t <= 2 else 16,
                                steps_per_call=t, bc_config=mj.bcs,
                                interpret=True, **kw)


def _t(a):
    return torch.from_numpy(np.array(a))


def _gap(a, b):
    return float(np.abs(np.asarray(a, np.float64) -
                        np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("t", [2, 4])
def test_compressed_block_matches_jax_kernel_f64(t):
    """K3c's plain version: two calls of T steps against the JAX blocked
    compressed kernel, to 1e-12 (measured ~1e-16)."""
    mj, mt = _models(CSF)
    blk = mt.make_block_step(steps_per_call=t, compressed=True)
    assert blk.steps_per_call == t
    jblk = _jax_block(mj, t, jnp.float64, state_mode="compressed")
    s = mj.pack_state(*mj.init_state_layers(1.0, 1.0, invading_rows=8))
    st = _t(s)
    for _ in range(2):
        s, st = jblk(s), blk(st)
    assert _gap(st, s) < 1e-12


@pytest.mark.parametrize("t", [2, 4])
def test_split_block_matches_jax_kernel_f32(t):
    """K3s's plain version in f32 against the JAX blocked split kernel
    (make_block_step) over 4 steps, to the JAX tests' 3e-5 (the TPU kernel
    reassociates its f32 algebra)."""
    mj, mt = _models(CSF, dtype=jnp.float32)
    jblk = mj.make_block_step(steps_per_call=t,
                              rows_per_block=8 if t <= 2 else 16,
                              interpret=True)
    blk = mt.make_block_step(steps_per_call=t)
    a, b = mj.init_state_layers(1.0, 1.0, invading_rows=8)
    st = (_t(a), _t(b))
    for _ in range(4 // t):
        a, b = jblk(a, b)
        st = blk(st)
    assert max(_gap(st[0], a), _gap(st[1], b)) < 3e-5


@pytest.mark.parametrize("compressed", [False, True],
                         ids=["split", "compressed"])
def test_perturbation_block_matches_jax_kernel_f64(compressed):
    """The Perturbation variant's K3 plain version at T = 2, two calls,
    against the JAX blocked kernel to 1e-12."""
    mj, mt = _models(PERT)
    blk = mt.make_block_step(steps_per_call=2, compressed=compressed)
    a, b = mj.init_state_layers(1.0, 1.0, invading_rows=8)
    if compressed:
        jblk = _jax_block(mj, 2, jnp.float64, state_mode="compressed")
        s = mj.pack_state(a, b)
        st = _t(s)
        for _ in range(2):
            s, st = jblk(s), blk(st)
        assert _gap(st, s) < 1e-12
    else:
        jblk = _jax_block(mj, 2, jnp.float64)
        st = (_t(a), _t(b))
        for _ in range(2):
            a, b = jblk(a, b)
            st = blk(st)
        assert max(_gap(st[0], a), _gap(st[1], b)) < 1e-12


def test_bf16_block_matches_jax_kernel():
    """K3h's plain version (decode once, two f32 steps, encode once) from a
    common bf16 state against the JAX bf16 blocked kernel at T = 2: the
    decoded planes within the K2 bounds off the seam rows and corners
    (``chip_smoke.seam_masks``, as phase 4 holds K2), 3e-4 on the PDF planes
    and 1e-4 on rho_r; the packing itself bit for bit.  On the seam rows
    the two f32 paths part by 2.4e-4 in rho_r with f32 storage too (the
    wetting tie-break amplifier, ROADMAP section 3; 2.36e-4 measured with
    bf16 storage), held there to 1e-3."""
    mj, mt = _models(CSF, dtype=jnp.float32, storage="bf16")
    jblk = _jax_block(mj, 2, jnp.float32, state_mode="compressed",
                      storage="bf16")
    blk = mt.make_block_step(steps_per_call=2, compressed=True,
                             storage="bf16")
    a, b = mj.init_state_layers(1.0, 1.0, invading_rows=8)
    h = mj.pack_state_bf16(a, b)
    ht = mt.pack_state_bf16(_t(a), _t(b))
    np.testing.assert_array_equal(ht.view(torch.int16).numpy(),
                                  np.asarray(h).view(np.int16))
    got = mt.unpack_bf16(blk(ht)).numpy()
    want = np.asarray(mj.unpack_bf16(jblk(h)))
    away = seam_masks(32, 32, 2, CPU).numpy()
    assert _gap(got[:9, away], want[:9, away]) < 3e-4
    assert _gap(got[9, away], want[9, away]) < 1e-4
    assert _gap(got[:, ~away], want[:, ~away]) < 1e-3


def test_wrappers_take_the_plain_version_on_the_cpu():
    """On CPU tensors the T-step wrappers are their plain versions and
    count no launch; a bad step count raises."""
    _, mt = _models(CSF)
    f_r, f_b = mt.init_state_layers(1.0, 1.0, invading_rows=8)
    before = csf_block_split.launches, csf_block_compressed.launches
    want = mt.plain_step(mt.plain_step((f_r, f_b)))
    got = csf_block_split((f_r, f_b), mt, 2)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    s = mt.pack_state(f_r, f_b)
    assert torch.equal(csf_block_compressed(s, mt, 3),
                       mt.plain_step_c(mt.plain_step_c(mt.plain_step_c(s))))
    assert (csf_block_split.launches, csf_block_compressed.launches) == before
    with pytest.raises(ValueError):
        csf_block_split((f_r, f_b), mt, 0)


@pytest.mark.parametrize("variant", ["CSF", "Perturbation"])
def test_make_block_step_refuses_as_the_jax_build_function(variant):
    """None exactly where build_csf_fused_step returns None on grounds of
    physics or boundaries (csf.py:243-245, :274-278), for both packages;
    T = 1 gives the model's own step."""
    pf = CSF if variant == "CSF" else PERT
    cases = [dict(inlet="neumann_per_color", inlet_velocity_r=-1e-4),
             dict(outlet="convective_average"),
             dict(outlet="modified_periodic"),
             dict(inlet="dirichlet", outlet="convective",
                  inlet_density_b=0.05), {}]
    for extra in cases:
        bf = FLAGSHIP_BCS | extra
        mj, mt = _models(pf, bf)
        for compressed in (False, True):
            jb = build_csf_fused_step(mj.geo, mj.p, jnp.float64,
                                      rows_per_block=8, steps_per_call=2,
                                      bc_config=mj.bcs, interpret=True,
                                      state_mode="compressed" if compressed
                                      else "split")
            pb = mt.make_block_step(steps_per_call=2, compressed=compressed)
            assert (jb is None) == (pb is None), (extra, compressed)
    mj, mt = _models(pf, dtype=jnp.float32)
    assert build_csf_fused_step(mj.geo, mj.p, jnp.float32, rows_per_block=8,
                                steps_per_call=2, bc_config=mj.bcs,
                                storage="bf16", interpret=True) is None
    assert mt.make_block_step(steps_per_call=2, storage="bf16") is None
    assert mt.make_block_step(steps_per_call=1) == mt.step
    assert mt.make_block_step(steps_per_call=1, compressed=True) == mt.step_c
    with pytest.raises(ValueError):
        mt.make_block_step(steps_per_call=0)


class _Model:
    """A stand-in model for _pick_block: records the T asked for."""

    def __init__(self, device="cuda", refuse=()):
        self.device = torch.device(device)
        self.asked = []
        self.refuse = refuse

    def make_block_step(self, steps_per_call, **kw):
        self.asked.append((steps_per_call, kw))
        return None if steps_per_call in self.refuse else f"T{steps_per_call}"


@pytest.mark.parametrize("block,io_interval,steps,want,asked,note", [
    (0, 100, 1000, 4, [4], False),      # auto: 4 first
    (0, 10, 1000, 2, [2], False),       # auto: 4 does not divide 10
    (0, 7, 1001, 1, [], False),         # auto: neither divides
    (4, 100, 1000, 4, [4], False),      # explicit
    (3, 100, 999, 1, [], True),         # explicit non-divisor: note
    (3, 99, 999, 3, [3], False),        # explicit T = 3
    (1, 100, 1000, 1, [], False),       # --block 1: unblocked
])
def test_pick_block_choices(block, io_interval, steps, want, asked, note):
    """_pick_block mirrors the JAX CLI's (cli.py:146-171) on a card."""
    m = _Model()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        blk, scale = tcli._pick_block(m, SimpleNamespace(block=block),
                                      io_interval, steps, compressed=True)
    assert scale == want and [t for t, _ in m.asked] == asked
    assert blk == (f"T{want}" if want > 1 else None)
    assert all(kw == {"compressed": True} for _, kw in m.asked)
    assert ("does not divide" in out.getvalue()) == note


def test_pick_block_falls_back_and_stays_unblocked_on_the_cpu():
    """Auto takes 2 where the model refuses 4; a CPU model is never
    blocked (the JAX CLI blocks only on its accelerator)."""
    m = _Model(refuse=(4,))
    assert tcli._pick_block(m, SimpleNamespace(block=0), 100, 1000) == \
        ("T2", 2)
    cpu = _Model(device="cpu")
    assert tcli._pick_block(cpu, SimpleNamespace(block=4), 100, 1000) == \
        (None, 1)
    assert cpu.asked == []


def _cg_ini(tmp_path):
    text = open(os.path.join(ROOT, "configs", "rk_csf2d.ini")).read()
    for old, new in {"xDomain = .*": "xDomain = 24",
                     "yDomain = .*": "yDomain = 40",
                     "TimeInterval = .*": "TimeInterval = 4"}.items():
        text, n = re.subn(rf"(?m)^{old}$", new, text)
        assert n == 1
    path = tmp_path / "cg.ini"
    path.write_text(text)
    return str(path)


def _run(argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert tcli.main(argv) == 0
    return out.getvalue()


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_cli_blocked_run_equals_block_1(tmp_path, monkeypatch):
    """run --model cg --block 4 with blocking let through on the CPU (the
    T-step function is then T plain steps): the same checkpoint and
    metrics.jsonl steps and physics as --block 1, the callbacks' steps
    scaled back; the run prints T.  Without the card --block 4 runs
    unblocked with the JAX CLI's note."""
    ini = _cg_ini(tmp_path)
    common = ["run", ini, "--model", "cg", "--device", "cpu", "--dtype",
              "f64", "--steps", "16"]
    plain = _run(common + ["--block", "4", "--output", str(tmp_path / "c")])
    assert "one step a launch" in plain
    assert "note: --block unsupported for this config" in plain
    _run(common + ["--block", "1", "--output", str(tmp_path / "a")])
    monkeypatch.setattr(tcli, "_blocks_on", lambda model: True)
    text = _run(common + ["--block", "4", "--output", str(tmp_path / "b")])
    assert "4 steps a launch" in text
    ma, mb = (_metrics(tmp_path / d / "metrics.jsonl") for d in "ab")
    assert [r["step"] for r in ma] == [r["step"] for r in mb] == \
        [0, 4, 8, 12, 16]
    for ra, rb in zip(ma, mb):
        for key in ra:
            if key not in ("mlups", "steps_per_s"):
                assert ra[key] == pytest.approx(rb[key], rel=1e-12,
                                                abs=1e-15), key
    ca, cb = (np.load(tmp_path / d / "checkpoint.npz") for d in "ab")
    assert sorted(ca.files) == sorted(cb.files)
    for key in ca.files:
        np.testing.assert_array_equal(ca[key], cb[key])


@pytest.mark.parametrize("case", ["K3 bc once", "K8-T march outlet",
                                  "K7-T bc once", "K4 diag f32",
                                  "K5c-T window rows", "K11-T march pull z",
                                  "K10-T seam skipped", "K9-T march z",
                                  "K8 rt tau", "K8 push target f64"])
def test_chip_faults_patches_one_line(case):
    """chip_faults.py plants its T-step faults (K3's row-march rewriting
    the boundary rows at level 0 only, K8-T's row-march forming the Zou-He
    outlet row from the row above it, K7-T's rows after the first sub-step
    only, K5c-T's row-march
    mapping the tracer's rows without the wrap, K11-T's stream-and-collide
    stage pulling from the slab above instead of below, K10-T's
    z-march skipping the slabs it recomputes below the periodic seam,
    K9-T's march picking the inlet slabs by its unwrapped slab), the
    runtime-K Shan-Chen fault (every fluid's common
    velocity weighted by fluid 0's 1/tau), the K4 fault, which moved with
    the Perturbation device code to csrc/pert2d.cuh, and K8's push fault (a
    value bounced into slot i, not opp(i)) by replacing one line that must
    stay there exactly once; each T-step or runtime-K fault is held against
    its phase while the family's T=1 phases must pass, and K8's push fault
    against phase 15 while K8-T's phase 46 must pass."""
    import chip_faults
    header, line, fault, phases = chip_faults.CASES[case]
    with open(os.path.join(ROOT, "openlbmpm_torch", "csrc", header)) as f:
        assert f.read().count(line) == 1
    assert fault != line and fault.startswith(line[:len(line) -
                                                  len(line.lstrip())])
    if case.startswith("K4"):
        assert phases == ("41",)
    elif case == "K8 push target f64":
        assert phases == ("15",) and chip_faults.MUST_PASS[case] == ("46",)
    else:
        assert set(phases) <= {"46", "47", "48", "52", "53", "58", "60"}
        assert chip_faults.MUST_PASS[case] and \
            set(chip_faults.MUST_PASS[case]) <= set(chip_faults.ALL_PHASES)
