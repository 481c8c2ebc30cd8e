"""Temporal blocking of the coupled CSF flow + tracer step (K5c-T) and the
CLI's ``--block`` for transport, on the CPU.

* ``TransportRK.make_block_step`` of the port (on the CPU: T plain coupled
  steps) against the JAX package's blocked Pallas kernel
  (``TransportRK.make_block_step(steps_per_call=2, rows_per_block=16)``:
  at T = 2 ``_halo_rows`` rounds the halo up to 16 rows) in interpret mode,
  at f64 to 1e-12 over 4 steps, on the 32 x 32 flagship channel (side
  walls, neumann inlet, Dirichlet outlet with the phi repair, MRT, Akai
  wetting) with tracer mass on the boundary rows: compressed and split, a
  permeable and a bounce-back interface, the Inamuro, anti-bounce-back and
  zero inlets with the free-flow outlet, D2Q5 MRT and D2Q9 tracers;
* ``make_block_step`` returns None case by case where the JAX build
  function and ``TransportRK.make_block_step`` build nothing;
* ``run --model transport``: CPU runs stay unblocked; with blocking let
  through, ``--block 4`` runs the packed (s, g) state and writes the
  tracer results and masses of ``--block 1`` (the split state).

The CUDA kernel is held to these plain versions on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phases 52 and 54-57.
"""

import contextlib
import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (COUPLED_CASES, coupled_conc0, flagship_flow,
                        seam_masks)
from openlbmpm_tpu import geometry as geo
from openlbmpm_tpu.models import colorgradient as jcg
from openlbmpm_tpu.models import transport as jtr
from openlbmpm_torch import cli as tcli
from openlbmpm_torch.convert import params_from_jax
from openlbmpm_torch.kernels.transport import (coupled_block_compressed,
                                               coupled_block_split)
from openlbmpm_torch.models.transport import TransportRK, TransportState
from test_torch_cli import TR_INI, _mini, _records, _results

torch.set_num_threads(1)
CPU = "cpu"   # the port's models run on the card unless told otherwise
N = 32
FLOW, BCS = flagship_flow()
FLOW_J = jcg.ColorGradientParams(**dataclasses.asdict(FLOW))
BCS_J = jcg.CGBoundaryConfig(**dataclasses.asdict(BCS))


def _models(case, dtype=jnp.float64, flow=FLOW_J, **tp_change):
    solid = np.zeros((N, N), bool)
    solid[:, 0] = solid[:, -1] = True
    g = geo.from_solid_mask(solid)
    tpj = jtr.TransportParams(**COUPLED_CASES[case] | tp_change)
    mj = jtr.TransportRK(g, flow, tpj, BCS_J, dtype=dtype, use_pallas=False)
    mt = TransportRK(g, params_from_jax(flow), params_from_jax(tpj),
                     params_from_jax(BCS_J), dtype=torch.float64
                     if dtype == jnp.float64 else torch.float32, device=CPU)
    return mj, mt


def _start(mj):
    fs = mj.flow.init_state_layers(1.0, 1.0, invading_rows=N // 5)
    return mj.init_state(fs, coupled_conc0(mj.tp.num_tracers, N, N))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("case,compressed", [
    ("a", True), ("b", False), ("d", True), ("e", False), ("f", True)])
def test_block_matches_jax_kernel_f64(case, compressed):
    """4 steps in calls of T = 2 against the JAX blocked coupled kernel, to
    1e-12: (a) permeable, Inamuro inlet, free-flow outlet, two tracers; (b)
    bounce-back interface, split; (d) D2Q5 MRT, anti-bounce-back inlet; (e)
    D2Q9 tracers, split; (f) the zero inlet with a bounce-back interface."""
    mj, mt = _models(case)
    jblk = mj.make_block_step(steps_per_call=2, rows_per_block=16,
                              compressed=compressed, interpret=True)
    blk = mt.make_block_step(steps_per_call=2, compressed=compressed)
    assert jblk is not None and blk.steps_per_call == 2
    st = _start(mj)
    if compressed:
        a = (mj.flow.pack_state(st.f_r, st.f_b), st.g)
        b = tuple(_t(x) for x in a)
    else:
        a = (st.f_r, st.f_b, st.g)
        b = TransportState(*(_t(x) for x in st))
    for _ in range(2):
        a = jblk(*a)
        b = blk(b)
    got = b if compressed else b[:3]
    worst = max(float(np.abs(x.numpy() - np.asarray(y)).max())
                for x, y in zip(got, a))
    assert all(bool(torch.isfinite(x).all()) for x in got)
    assert worst < 1e-12


def test_bf16_block_matches_jax_kernel():
    """Case (a) with the flow in bf16 storage at T = 2 from a common bf16
    state (packing bit for bit), one call, on tests/test_torch_block.py's
    bf16 flow (surface tension 0.01, tau_b 0.8): the decoded flow state held
    to the JAX blocked kernel within the K2 bounds off the seam rows and
    corners (``chip_smoke.seam_masks``, as that file holds K3h), 3e-4 on
    the PDF planes and 1e-4 on rho_r, 1e-3 on the seam rows; the f32
    tracers within 1e-4 on the rows at least 4 from the seam (the seam's
    tie-break noise streams one row a step, as phase 7 holds K5c).  With
    the flagship's surface tension 0.1 the two f32 paths already part by
    3.2e-4 in rho_r where the interface meets the walls, f32 storage alike
    (the wetting tie-break amplifier, ROADMAP section 3)."""
    mj, mt = _models("a", dtype=jnp.float32, flow=dataclasses.replace(
        FLOW_J, surface_tension=0.01, tau_b=0.8))
    jblk = mj.make_block_step(steps_per_call=2, rows_per_block=16,
                              compressed=True, interpret=True,
                              storage="bf16")
    blk = mt.make_block_step(steps_per_call=2, compressed=True,
                             storage="bf16")
    st = _start(mj)
    h = mj.flow.pack_state_bf16(st.f_r, st.f_b)
    ht = mt.flow.pack_state_bf16(_t(st.f_r), _t(st.f_b))
    np.testing.assert_array_equal(ht.view(torch.int16).numpy(),
                                  np.asarray(h).view(np.int16))
    hs, hg = jblk(h, st.g)
    ts, tg = blk((ht, _t(st.g)))
    got = mt.flow.unpack_bf16(ts).numpy()
    want = np.asarray(mj.flow.unpack_bf16(hs))
    away = seam_masks(N, N, 2, CPU).numpy()
    assert np.abs(got[:9, away] - want[:9, away]).max() < 3e-4
    assert np.abs(got[9, away] - want[9, away]).max() < 1e-4
    assert np.abs(got[:, ~away] - want[:, ~away]).max() < 1e-3
    rows = slice(4, N - 4)
    assert np.abs(tg.numpy()[..., rows, :] -
                  np.asarray(hg)[..., rows, :]).max() < 1e-4


def test_make_block_step_refuses_as_the_jax_build_function():
    """None case by case as JAX's ``make_block_step``
    (models/transport.py:150-167, pallas/csf.py:243-245): conserve_mass
    and redistribute beyond the split T = 1 form, bf16 storage on the split
    layout; the conserve_mass T = 1 form is marked ``needs_mass0`` in both;
    the strip knob that makes the JAX build refuse a shape (rows_per_block
    8, not a multiple of the 16-row halo) is ignored; standalone transport
    has no T-step form; on CPU tensors the wrappers are their plain
    versions and count no launch."""
    for change in ({"conserve_mass": True},
                   {"interface_mode": "redistribute"}):
        mj, mt = _models("b", **change)
        for t, compressed in ((2, False), (2, True), (1, True)):
            assert mj.make_block_step(steps_per_call=t, rows_per_block=16,
                                      compressed=compressed,
                                      interpret=True) is None
            assert mt.make_block_step(steps_per_call=t,
                                      compressed=compressed) is None
        jone = mj.make_block_step(steps_per_call=1, rows_per_block=16,
                                  interpret=True)
        one = mt.make_block_step(steps_per_call=1)
        assert jone is not None and one is not None
        assert getattr(jone, "needs_mass0", False) == \
            getattr(one, "needs_mass0", False) == ("conserve_mass" in change)
    mj, mt = _models("a")
    assert mj.make_block_step(steps_per_call=2, rows_per_block=16,
                              storage="bf16", interpret=True) is None
    assert mt.make_block_step(steps_per_call=2, storage="bf16") is None
    assert mj.make_block_step(steps_per_call=2, rows_per_block=8,
                              compressed=True, interpret=True) is None
    assert mt.make_block_step(steps_per_call=2, rows_per_block=8,
                              compressed=True) is not None
    assert mt.make_block_step(steps_per_call=1) == mt.step
    assert mt.make_block_step(steps_per_call=1, compressed=True) == mt.step_c
    standalone = TransportRK(mt.geo, FLOW, mt.tp, BCS, standalone=True,
                             dtype=torch.float64, device=CPU)
    with pytest.raises(ValueError, match="standalone"):
        standalone.make_block_step(steps_per_call=2)
    st = _start(mj)
    s = (_t(mj.flow.pack_state(st.f_r, st.f_b)), _t(st.g))
    before = coupled_block_compressed.launches, coupled_block_split.launches
    want = s
    for _ in range(3):
        want = mt.plain_step_c(want)
    got = coupled_block_compressed(s, mt, 3)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    split = TransportState(*(_t(x) for x in st))
    got = coupled_block_split(split, mt, 2)
    want = mt.plain_step(mt.plain_step(split))
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert (coupled_block_compressed.launches,
            coupled_block_split.launches) == before


def _run(argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert tcli.main(argv) == 0
    return out.getvalue()


def test_cli_blocked_run_matches_block_1(tmp_path, monkeypatch):
    """run --model transport (configs/transportsetup.ini on the 32 x 64
    flow INI, 16 f64 steps, output every 8): on the CPU --block 4 runs the
    split state unblocked with the JAX CLI's note; with blocking let
    through it runs the packed (s, g) state 4 steps a call, as the JAX CLI
    does, and writes the tracer fields and masses of --block 1 (the split
    state) at steps 0, 8 and 16: to 1e-12 up to step 8; at step 16 the
    compressed and split flow steps have parted where the seam interface
    reaches the inlet rows (ROADMAP section 3; 4.6e-6 in the concentration
    on row 81 of 84, 5.4e-9 of the tracer mass), so the fields are held to
    1e-5 and the masses to 1e-8 relative there."""
    ini = _mini(tmp_path, interval=8)
    common = ["run", TR_INI, "--model", "transport", "--physics-config", ini,
              "--device", "cpu", "--dtype", "f64", "--steps", "16"]
    text = _run(common + ["--block", "4", "--output", str(tmp_path / "c")])
    assert "split state, one step a launch" in text
    assert "note: --block unsupported for this config" in text
    _run(common + ["--block", "1", "--output", str(tmp_path / "a")])
    monkeypatch.setattr(tcli, "_blocks_on", lambda m: True)
    text = _run(common + ["--block", "4", "--output", str(tmp_path / "b")])
    assert "compressed state, 4 steps a launch" in text
    ra, rb = (_records(tmp_path / d / "metrics.jsonl") for d in "ab")
    assert [r["step"] for r in ra] == [r["step"] for r in rb] == [0, 8, 16]
    for x, y in zip(ra, rb):
        rel = 1e-12 if x["step"] <= 8 else 1e-8
        for key in x:
            if key not in ("mlups", "steps_per_s"):
                assert x[key] == pytest.approx(y[key], rel=rel,
                                               abs=1e-12), key
    got = _results(tmp_path / "b", "ConcentrationResults")
    want = _results(tmp_path / "a", "ConcentrationResults")
    assert sorted(got) == sorted(want) and len(got) == 3
    for key in got:
        atol = 1e-5 if key.endswith("in16") else 1e-12
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol)
