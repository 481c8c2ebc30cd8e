"""The port's product surface against the JAX package's, on the CPU.

* ``openlbmpm_torch.config`` returns dataclasses equal field by field to
  ``openlbmpm_tpu.config``'s, on the shipped INIs and on INIs that hit the
  reader's special cases; ``config_fingerprint`` is the same hash;
* checkpoints cross between the packages both ways, bit for bit, and a run
  resumes from the other package's checkpoint;
* ``python -m openlbmpm_torch run --model cg|transport|sc|cg3d|transport3d
  --device cpu --dtype f64`` against the JAX CLI's ``--no-pallas --dtype
  f64`` run (its steps un-jitted under ``jax.disable_jit``, as the port is
  held to the un-jitted JAX step): results and final checkpoint to 1e-12
  (cg3d, transport3d: 1e-10), the physics fields of metrics.jsonl to 1e-10;
* the metrics helpers, ``inspect``, the refusals and the notes.
"""

import contextlib
import dataclasses
import io
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openlbmpm_tpu import checkpoint as jck
from openlbmpm_tpu import cli as jcli
from openlbmpm_tpu import config as jconfig
from openlbmpm_tpu import metrics as jmetrics
from openlbmpm_tpu.models import transport as jtr
from openlbmpm_torch import checkpoint as tck
from openlbmpm_torch import cli as tcli
from openlbmpm_torch import config as tconfig
from openlbmpm_torch import metrics as tmetrics
from openlbmpm_torch.models.transport import TransportState

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CG_INI = os.path.join(ROOT, "configs", "rk_csf2d.ini")
TR_INI = os.path.join(ROOT, "configs", "transportsetup.ini")
SC_INI = os.path.join(ROOT, "configs", "twophasesetup.ini")
CG3D_INI = os.path.join(ROOT, "configs", "rk_csf3d.ini")


def _ini(tmp_path, src, name, edits):
    """`src` with each line matching a key of `edits` (a regex) replaced by
    its value."""
    text = open(src).read()
    for old, new in edits.items():
        text, n = re.subn(rf"(?m)^{old}$", new, text)
        assert n == 1, old
    path = tmp_path / name
    path.write_text(text)
    return str(path)


CG_VARIANTS = {
    "shipped": {},
    "dirilcht_convective": {
        "BoundaryTypeInlet = .*": "BoundaryTypeInlet = 'Dirilcht'",
        "BoundaryTypeOutlet = .*": "BoundaryTypeOutlet = 'Convective'",
        "densityBH = .*": "densityBH = 0.01"},
    "percolor_average_convective": {
        "BoundaryTypeOutlet = .*": "BoundaryTypeOutlet = 'AverageConvective'",
        "BoundaryTypeInlet = .*": "BoundaryTypeInlet = 'Neumann'\n"
                                  "VelocityType = 'PerColor'"},
    "no_repair_srt": {
        "BoundaryTypeOutlet = .*": "BoundaryTypeOutlet = 'Dirichlet'\n"
                                   "PhiOutletRepair = 'no'",
        "Type = 'MRT'": "Type = 'SRT'"},
    "perturbation": {
        "SurfaceTensionType = .*": "SurfaceTensionType = 'Perturbation'"},
    "perturbation_anisotropic_srt": {
        "SurfaceTensionType = .*": "SurfaceTensionType = 'Perturbation'",
        "Type = 'Isotropic'": "Type = 'Anisotropic'",
        "Type = 'MRT'": "Type = 'SRT'", "AkB = .*": "AkB = 0.0005",
        "SolidColorDiff = .*": "SolidColorDiff = 0.3"},
}


@pytest.mark.parametrize("variant", sorted(CG_VARIANTS))
def test_load_colorgradient_equals_jax(tmp_path, variant):
    path = _ini(tmp_path, CG_INI, "cg.ini", CG_VARIANTS[variant])
    got = tconfig.load_colorgradient(path)
    want = jconfig.load_colorgradient(path)
    for a, b in zip(got, want):
        assert type(a).__name__ == type(b).__name__
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert tck.config_fingerprint(got[0]) == jck.config_fingerprint(want[0])
    if variant == "no_repair_srt":
        assert not got[1].phi_outlet_repair and got[0].collision == "SRT"
    if variant == "percolor_average_convective":
        assert (got[1].inlet, got[1].outlet) == ("neumann_per_color",
                                                 "convective_average")
    if variant.startswith("perturbation"):
        assert got[0].variant == "Perturbation"
    if variant == "perturbation_anisotropic_srt":
        assert (got[0].gradient_type, got[0].collision, got[0].a_kb,
                got[0].solid_phi) == ("Anisotropic", "SRT", 0.0005, 0.3)


TR_VARIANTS = {
    "shipped": {},
    "mrt_reaction_two_tracers": {f"{k} = .*": f"{k} = {v}" for k, v in (
        ("NumberOfTracers", "2"), ("TransportTau", "1.0, 0.8"),
        ("DiffusionJ", "0.3, 0.25"), ("Type", "'MRT'"), ("Option", "'yes'"),
        ("ReactionRate", "0.05"), ("InletType", "'anti_bounce_back'"),
        ("InletConcentration", "1.0, 0.5"), ("BetaInterface", "0.4"))},
}


@pytest.mark.parametrize("variant", sorted(TR_VARIANTS))
def test_load_transport_equals_jax(tmp_path, variant):
    path = _ini(tmp_path, TR_INI, "tr.ini", TR_VARIANTS[variant])
    got = tconfig.load_transport(path)
    want = jconfig.load_transport(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tck.config_fingerprint(got) == jck.config_fingerprint(want)


def _split_state(seed, transport=False):
    rng = np.random.default_rng(seed)
    f_r, f_b = rng.uniform(0.0, 0.2, (2, 9, 12, 10))
    if not transport:
        return f_r, f_b
    return jtr.TransportState(f_r, f_b, rng.uniform(0, 1, (2, 5, 12, 10)),
                              rng.uniform(1, 9, 2))


@pytest.mark.parametrize("transport", [False, True], ids=["cg", "transport"])
def test_checkpoints_cross_both_ways_bit_for_bit(tmp_path, transport):
    state = _split_state(int(transport), transport)
    j_state = jtr.TransportState(*map(jnp.asarray, state)) if transport \
        else tuple(map(jnp.asarray, state))
    t_state = TransportState(*map(torch.from_numpy, state)) if transport \
        else tuple(map(torch.from_numpy, state))
    jck.save_checkpoint(str(tmp_path / "j.npz"), j_state, 17, "fp")
    tck.save_checkpoint(str(tmp_path / "t.npz"), t_state, 17, "fp")
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert set(zj.files) == set(zt.files)
    zeros = [torch.zeros_like(x) for x in t_state]
    like_t = TransportState(*zeros) if transport else tuple(zeros)
    got_t, step_t = tck.load_checkpoint(str(tmp_path / "j.npz"), like_t, "fp")
    got_j, step_j = jck.load_checkpoint(str(tmp_path / "t.npz"), j_state, "fp")
    assert step_t == step_j == 17 and type(got_t) is type(t_state)
    for a, b, c in zip(state, got_t, got_j):
        np.testing.assert_array_equal(b.numpy().view(np.uint8),
                                      np.asarray(a).view(np.uint8))
        np.testing.assert_array_equal(np.asarray(c).view(np.uint8),
                                      np.asarray(a).view(np.uint8))
    with pytest.raises(ValueError, match="fingerprint"):
        tck.load_checkpoint(str(tmp_path / "j.npz"), like_t, "other")


def test_di_cycle_swap_equals_jax():
    f_r, f_b = _split_state(2)
    want = jck.di_cycle_swap(f_r, f_b, buffer_rows=3)
    got = tck.di_cycle_swap(torch.from_numpy(f_r), torch.from_numpy(f_b),
                            buffer_rows=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_flow_diagnostics_and_steady_state_equal_jax():
    rng = np.random.default_rng(4)
    rho_r, rho_b, ux, uy, ux0, uy0 = rng.uniform(0, 1, (6, 12, 10))
    fl = rng.random((12, 10)) < 0.8
    want = jmetrics.flow_diagnostics(rho_r, rho_b, ux, uy, fl)
    got = tmetrics.flow_diagnostics(*map(torch.from_numpy,
                                         (rho_r, rho_b, ux, uy)), fl)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-15)
    assert tmetrics.steady_state_criterion(
        *map(torch.from_numpy, (ux, uy, ux0, uy0))) == pytest.approx(
        jmetrics.steady_state_criterion(ux, uy, ux0, uy0), rel=1e-12)


def _mini(tmp_path, n_x=32, n_y=64, interval=10, variant="CSF"):
    return _ini(tmp_path, CG_INI, "mini.ini", {
        "xDomain = .*": f"xDomain = {n_x}", "yDomain = .*": f"yDomain = {n_y}",
        "TimeInterval = .*": f"TimeInterval = {interval}",
        "SurfaceTensionType = .*": f"SurfaceTensionType = '{variant}'"})


def _jax_cli(argv):
    with jax.disable_jit(), contextlib.redirect_stdout(io.StringIO()):
        assert jcli.main(argv) == 0


def _torch_cli(argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert tcli.main(argv) == 0
    return out.getvalue()


def _records(path):
    with open(path) as fh:
        return [json.loads(ln) for ln in fh if ln.strip()]


def _same_records(a, b, atol=1e-10):
    """The physics fields of two metrics.jsonl files agree (the timings,
    mlups and steps_per_s, are the hosts' own)."""
    ra, rb = _records(a), _records(b)
    assert len(ra) == len(rb)
    for x, y in zip(ra, rb):
        keys = set(x) - {"mlups", "steps_per_s"}
        assert keys == set(y) - {"mlups", "steps_per_s"}
        for k in keys:
            if isinstance(x[k], float):
                assert abs(x[k] - y[k]) <= atol, (k, x[k], y[k])
            else:
                assert x[k] == y[k], k


def _same_arrays(a: dict, b: dict, atol=1e-12):
    assert set(a) == set(b)
    for k in a:
        if a[k].dtype.kind == "f":
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=atol)
        else:
            np.testing.assert_array_equal(b[k], a[k])


def _same_checkpoint(a, b):
    """Leaves to 1e-12, step and fingerprint equal.  ``__treedef__`` is
    each package's own description of the structure; no loader reads it."""
    with np.load(a) as za, np.load(b) as zb:
        _same_arrays({k: za[k] for k in za.files if k != "__treedef__"},
                     {k: zb[k] for k in zb.files if k != "__treedef__"})


def _results(out_dir, basename) -> dict:
    """Every dataset the ResultWriter wrote (HDF5 when h5py is importable,
    else one npz per output step)."""
    h5 = os.path.join(out_dir, basename + ".h5")
    if os.path.exists(h5):
        import h5py
        found = {}
        with h5py.File(h5, "r") as fh:
            fh.visititems(lambda k, v: found.__setitem__(k, np.asarray(v))
                          if hasattr(v, "shape") else None)
        return found
    found = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith(basename + "_") and name.endswith(".npz"):
            with np.load(os.path.join(out_dir, name)) as z:
                found.update({k: z[k] for k in z.files})
    return found


@pytest.mark.parametrize("variant", ["CSF", "Perturbation"])
def test_cli_cg_matches_jax_cli_f64(tmp_path, variant):
    """20 f64 steps of the 64x32 box (84x32 with the buffer layers) under
    the Neumann inlet and Dirichlet outlet, with the INI's CSF or, with
    SurfaceTensionType = 'Perturbation', its Perturbation parameters
    (alphas 4/9, A = 1e-4): the final checkpoint and the result files to
    1e-12, the physics of metrics.jsonl to 1e-10; the run prints its
    path."""
    ini = _mini(tmp_path, variant=variant)
    common = ["run", ini, "--model", "cg", "--dtype", "f64", "--steps", "20"]
    _jax_cli(common + ["--no-pallas", "--output", str(tmp_path / "j")])
    text = _torch_cli(common + ["--device", "cpu", "--output",
                                str(tmp_path / "t")])
    assert f"variant {variant}, boundaries neumann/dirichlet: the plain " \
        "step on cpu, split state" in text
    _same_checkpoint(tmp_path / "j" / "checkpoint.npz",
                     tmp_path / "t" / "checkpoint.npz")
    got = _results(tmp_path / "t", "SimulationResultsRK")
    assert len(got) == 3 * 6       # steps 0, 10, 20: rho_r, rho_b, u, PDFs
    _same_arrays(_results(tmp_path / "j", "SimulationResultsRK"), got)
    _same_records(tmp_path / "j" / "metrics.jsonl",
                  tmp_path / "t" / "metrics.jsonl")


def test_cli_transport_matches_jax_cli_f64(tmp_path):
    """20 f64 coupled steps (configs/transportsetup.ini on the 64x32 flow
    INI): the concentration files to 1e-12, tracer masses to 1e-10."""
    ini = _mini(tmp_path)
    common = ["run", TR_INI, "--model", "transport", "--physics-config", ini,
              "--dtype", "f64", "--steps", "20"]
    _jax_cli(common + ["--no-pallas", "--output", str(tmp_path / "j")])
    _torch_cli(common + ["--device", "cpu", "--output", str(tmp_path / "t")])
    got = _results(tmp_path / "t", "ConcentrationResults")
    assert len(got) == 3                       # steps 0, 10, 20
    _same_arrays(_results(tmp_path / "j", "ConcentrationResults"), got)
    _same_records(tmp_path / "j" / "metrics.jsonl",
                  tmp_path / "t" / "metrics.jsonl")
    assert _records(tmp_path / "t" / "metrics.jsonl")[-1]["tracer0_mass"] > 0


def test_cli_resumes_from_a_jax_checkpoint(tmp_path):
    """JAX runs 10 steps; the port resumes its checkpoint to step 20 and
    lands within 1e-12 of a port run of 20 steps straight."""
    ini = _mini(tmp_path)
    common = ["run", ini, "--model", "cg", "--dtype", "f64"]
    out = str(tmp_path / "resumed")
    _jax_cli(common + ["--no-pallas", "--steps", "10", "--output", out])
    text = _torch_cli(common + ["--device", "cpu", "--steps", "10",
                                "--resume", "--output", out])
    assert "resumed from step 10" in text
    _torch_cli(common + ["--device", "cpu", "--steps", "20", "--output",
                         str(tmp_path / "straight")])
    _same_checkpoint(tmp_path / "straight" / "checkpoint.npz",
                     os.path.join(out, "checkpoint.npz"))


@pytest.mark.parametrize("scheme", ["sc", "efs"])
def test_cli_sc_matches_jax_cli_f64(tmp_path, scheme):
    """twophasesetup.ini cut to 32x48 with shanchen2D.ini (Zou-He velocity
    inlet, convective outlet) or, as EFS, efs2D.ini (velocity inlet, Zou-He
    pressure outlet), 20 f64 steps: results and checkpoint to 1e-12, the
    physics of metrics.jsonl to 1e-10; the run prints the path it takes."""
    edits = {"xGrid = .*": "xGrid = 32", "yGrid = .*": "yGrid = 48"}
    physics = "shanchen2D.ini"
    if scheme == "efs":
        edits["InteractionType = .*"] = "InteractionType = 'EFS'"
        physics = "efs2D.ini"
    ini = _ini(tmp_path, SC_INI, "twophase.ini", edits)
    common = ["run", ini, "--model", "sc", "--physics-config",
              os.path.join(ROOT, "configs", physics), "--dtype", "f64",
              "--steps", "20"]
    _jax_cli(common + ["--no-pallas", "--output", str(tmp_path / "j")])
    text = _torch_cli(common + ["--device", "cpu", "--output",
                                str(tmp_path / "t")])
    assert f"scheme {scheme.upper()}" in text and "the plain step on cpu" \
        in text
    _same_checkpoint(tmp_path / "j" / "checkpoint.npz",
                     tmp_path / "t" / "checkpoint.npz")
    got = _results(tmp_path / "t", "SimulationResults")
    assert len(got) == 2 * 4       # steps 0 and 20: rho_0, rho_1, ux, uy
    _same_arrays(_results(tmp_path / "j", "SimulationResults"), got)
    _same_records(tmp_path / "j" / "metrics.jsonl",
                  tmp_path / "t" / "metrics.jsonl")


def _mini3d(tmp_path):
    """rk_csf3d.ini cut to 12x12x24, 10 steps, output every 5 (the JAX
    package's test_cli_run_cg3d_with_resume setup)."""
    return _ini(tmp_path, CG3D_INI, "small3d.ini", {
        "xDomain = .*": "xDomain = 12", "yDomain = .*": "yDomain = 12",
        "zDomain = .*": "zDomain = 24", "TimeSteps = .*": "TimeSteps = 10",
        "TimeInterval = .*": "TimeInterval = 5"})


def test_cli_cg3d_matches_jax_cli_f64(tmp_path):
    """10 f64 steps of the 12x12x24 box (NEBB velocity inlet, pressure
    outlet) on the split state: results and checkpoint to 1e-10, the
    physics of metrics.jsonl to 1e-10; the run prints its path."""
    ini = _mini3d(tmp_path)
    common = ["run", ini, "--model", "cg3d", "--dtype", "f64"]
    _jax_cli(common + ["--no-pallas", "--output", str(tmp_path / "j")])
    text = _torch_cli(common + ["--device", "cpu", "--output",
                                str(tmp_path / "t")])
    assert "velocity/dirichlet: the plain step on cpu, split state" in text
    with np.load(tmp_path / "j" / "checkpoint.npz") as zj, \
            np.load(tmp_path / "t" / "checkpoint.npz") as zt:
        _same_arrays({k: zj[k] for k in zj.files if k != "__treedef__"},
                     {k: zt[k] for k in zt.files if k != "__treedef__"},
                     atol=1e-10)
    got = _results(tmp_path / "t", "SimulationResultsRK3D")
    assert len(got) == 3 * 2       # steps 0, 5, 10: rho_r, rho_b
    _same_arrays(_results(tmp_path / "j", "SimulationResultsRK3D"), got,
                 atol=1e-10)
    _same_records(tmp_path / "j" / "metrics.jsonl",
                  tmp_path / "t" / "metrics.jsonl")


def test_cli_cg3d_resumes_from_a_jax_checkpoint(tmp_path):
    """JAX runs 5 steps; the port resumes its checkpoint for 5 more and
    lands within 1e-12 of a port run of 10 steps straight."""
    ini = _mini3d(tmp_path)
    common = ["run", ini, "--model", "cg3d", "--dtype", "f64"]
    out = str(tmp_path / "resumed")
    _jax_cli(common + ["--no-pallas", "--steps", "5", "--output", out])
    text = _torch_cli(common + ["--device", "cpu", "--steps", "5",
                                "--resume", "--output", out])
    assert "resumed from step 5" in text
    _torch_cli(common + ["--device", "cpu", "--steps", "10", "--output",
                         str(tmp_path / "straight")])
    _same_checkpoint(tmp_path / "straight" / "checkpoint.npz",
                     os.path.join(out, "checkpoint.npz"))


def test_cli_transport3d_matches_jax_cli_f64(tmp_path):
    """tests/test_product_surface.py's transport3d INIs (transportsetup.ini
    on rk_csf3d.ini cut to 12x12x16), 10 f64 steps on the split state: the
    concentration files and the tracer masses of metrics.jsonl to 1e-10;
    the run prints its path.  The tracer starts in the red slabs, outside
    its bounce-back domain, and its mass falls: 800 -> 602.39 -> 471.55 at
    steps 0, 5, 10 (ROADMAP section 3)."""
    flow = _ini(tmp_path, CG3D_INI, "flow3d.ini", {
        "xDomain = .*": "xDomain = 12", "yDomain = .*": "yDomain = 12",
        "zDomain = .*": "zDomain = 16", "TimeSteps = .*": "TimeSteps = 10",
        "TimeInterval = .*": "TimeInterval = 5"})
    common = ["run", TR_INI, "--model", "transport3d", "--physics-config",
              flow, "--dtype", "f64"]
    _jax_cli(common + ["--no-pallas", "--output", str(tmp_path / "j")])
    text = _torch_cli(common + ["--device", "cpu", "--output",
                                str(tmp_path / "t")])
    assert "interface bounceback: the plain step on cpu, split state" in text
    got = _results(tmp_path / "t", "ConcentrationResults3D")
    assert len(got) == 3 and all(v.shape == (16, 12, 12)
                                 for v in got.values())
    _same_arrays(_results(tmp_path / "j", "ConcentrationResults3D"), got,
                 atol=1e-10)
    _same_records(tmp_path / "j" / "metrics.jsonl",
                  tmp_path / "t" / "metrics.jsonl")
    masses = [r["tracer0_mass"] for r in
              _records(tmp_path / "t" / "metrics.jsonl")]
    assert abs(masses[0] - 8 * 10 * 10) < 1e-9 and \
        masses[2] < masses[1] < masses[0]


@pytest.mark.parametrize("layout", ["split", "packed"])
def test_cg3d_checkpoints_cross_both_ways_bit_for_bit(tmp_path, layout):
    """A 3-D state in either layout, saved by either package under the CLI's
    fingerprint, loads in the other bit for bit; the fingerprints of the
    INI's parameters with the layout are the same hash."""
    rng = np.random.default_rng(11)
    if layout == "split":
        state = tuple(rng.uniform(0.0, 0.2, (2, 19, 8, 6, 5)))
    else:
        state = rng.uniform(0.0, 0.2, (20, 8, 6, 5))
    fps = [ck.config_fingerprint({"params": dataclasses.asdict(
        cfg.load_colorgradient3d(CG3D_INI)[0]), "state_layout": layout})
        for ck, cfg in ((jck, jconfig), (tck, tconfig))]
    assert fps[0] == fps[1]
    as_j = tuple(map(jnp.asarray, state)) if layout == "split" \
        else jnp.asarray(state)
    as_t = tuple(map(torch.from_numpy, state)) if layout == "split" \
        else torch.from_numpy(state)
    jck.save_checkpoint(str(tmp_path / "j.npz"), as_j, 7, fps[0])
    tck.save_checkpoint(str(tmp_path / "t.npz"), as_t, 7, fps[1])
    like = tuple(torch.zeros_like(x) for x in as_t) if layout == "split" \
        else torch.zeros_like(as_t)
    got_t, step_t = tck.load_checkpoint(str(tmp_path / "j.npz"), like, fps[1])
    got_j, step_j = jck.load_checkpoint(str(tmp_path / "t.npz"), as_j, fps[0])
    assert step_t == step_j == 7
    for a, b, c in zip(*(x if layout == "split" else (x,)
                         for x in (state, got_t, got_j))):
        np.testing.assert_array_equal(b.numpy().view(np.uint8),
                                      np.asarray(a).view(np.uint8))
        np.testing.assert_array_equal(np.asarray(c).view(np.uint8),
                                      np.asarray(a).view(np.uint8))
    other = "packed" if layout == "split" else "split"
    with pytest.raises(ValueError, match="fingerprint"):
        tck.load_checkpoint(str(tmp_path / "j.npz"), like,
                            tck.config_fingerprint({"params": {},
                                                    "state_layout": other}))


def test_sc_checkpoint_crosses_both_ways(tmp_path):
    """A (K, 9, ny, nx) Shan-Chen state, saved by either package, loads in
    the other bit for bit."""
    f = np.random.default_rng(9).uniform(0.0, 0.2, (2, 9, 12, 10))
    jck.save_checkpoint(str(tmp_path / "j.npz"), jnp.asarray(f), 5, "fp")
    tck.save_checkpoint(str(tmp_path / "t.npz"), torch.from_numpy(f), 5, "fp")
    got_t, step_t = tck.load_checkpoint(str(tmp_path / "j.npz"),
                                        torch.zeros(f.shape,
                                                    dtype=torch.float64), "fp")
    got_j, step_j = jck.load_checkpoint(str(tmp_path / "t.npz"),
                                        jnp.zeros(f.shape), "fp")
    assert step_t == step_j == 5
    np.testing.assert_array_equal(got_t.numpy().view(np.uint8),
                                  f.view(np.uint8))
    np.testing.assert_array_equal(np.asarray(got_j).view(np.uint8),
                                  f.view(np.uint8))


@pytest.mark.parametrize("model,path", [("cg", CG_INI), ("transport", TR_INI),
                                        ("sc", SC_INI), ("cg3d", CG3D_INI),
                                        ("transport3d", TR_INI),
                                        ("cg", "perturbation")])
def test_inspect_prints_what_jax_prints(tmp_path, model, path):
    if path == "perturbation":
        path = _ini(tmp_path, CG_INI, "pert.ini", CG_VARIANTS["perturbation"])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert jcli.main(["inspect", path, "--model", model]) == 0
    assert _torch_cli(["inspect", path, "--model", model]) == out.getvalue()


def test_unported_model_exits_2(capsys):
    """Every model family of the JAX CLI is ported; a name outside them
    (the JAX CLI has none either) is refused with status 2."""
    assert set(tcli.MODELS) == {"cg", "cg3d", "sc", "sc3d", "transport",
                                "transport3d", "basic", "basic3d"}
    with pytest.raises(SystemExit) as exc:
        tcli.main(["run", CG_INI, "--model", "perturbation", "--device",
                   "cpu"])
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def _no_pallas_run(tmp_path, model):
    """(argv without --output, result basename) of a small run of
    `model`: the cut INIs of the tests above."""
    if model == "cg":
        return ["run", _mini(tmp_path), "--model", "cg", "--steps",
                "20"], "SimulationResultsRK"
    if model == "sc":
        ini = _ini(tmp_path, SC_INI, "twophase.ini",
                   {"xGrid = .*": "xGrid = 32", "yGrid = .*": "yGrid = 48"})
        return ["run", ini, "--model", "sc", "--physics-config",
                os.path.join(ROOT, "configs", "shanchen2D.ini"), "--steps",
                "20"], "SimulationResults"
    return ["run", _mini3d(tmp_path), "--model", model] + (
        ["--physics-config", _mini3d(tmp_path)] if model == "transport3d"
        else []), ("SimulationResultsRK3D" if model == "cg3d" else
                   "ConcentrationResults3D")


@pytest.mark.parametrize("model", ["cg", "sc", "cg3d", "transport3d"])
def test_no_pallas_run_equals_plain_run(tmp_path, model):
    """``--no-pallas`` is accepted (the JAX CLI's flag): every model is built
    with ``use_kernel=False`` and runs unblocked; on the CPU, where every
    model runs its plain step already, a run with the flag writes the
    results, metrics and checkpoint of the run without it, bit for bit, and
    its model line names the plain step."""
    argv, basename = _no_pallas_run(tmp_path, model)
    if model == "transport3d":
        argv[1] = TR_INI
    common = argv + ["--device", "cpu", "--dtype", "f64"]
    text = _torch_cli(common + ["--no-pallas", "--block", "4", "--output",
                                str(tmp_path / "np")])
    assert "the plain step on cpu" in text
    _torch_cli(common + ["--output", str(tmp_path / "k")])
    _same_arrays(_results(tmp_path / "k", basename),
                 _results(tmp_path / "np", basename), atol=0.0)
    _same_records(tmp_path / "k" / "metrics.jsonl",
                  tmp_path / "np" / "metrics.jsonl", atol=0.0)
    if model != "transport3d":     # the transport3d run writes none
        _same_checkpoint(tmp_path / "k" / "checkpoint.npz",
                         tmp_path / "np" / "checkpoint.npz")


def test_no_pallas_builds_every_model_without_its_kernel(tmp_path):
    """The eight models take ``use_kernel`` (the JAX ``use_pallas``): with
    False the path is "plain", there is no T-step form (TransportRK3D has
    none at all, as in JAX), and ``_pick_block`` runs unblocked even where
    ``--block`` asks for more."""
    import argparse

    from openlbmpm_torch import geometry as tgeo
    from openlbmpm_torch.models.colorgradient import ColorGradientRK
    from openlbmpm_torch.models.flow3d import (ColorGradientParams3D,
                                               ColorGradientRK3D,
                                               ShanChenMCMP3D,
                                               ShanChenParams3D,
                                               SinglePhaseD3Q19,
                                               TransportRK3D)
    from openlbmpm_torch.models.shanchen import ShanChenMCMP, ShanChenParams
    from openlbmpm_torch.models.single_phase import SinglePhaseD2Q9
    from openlbmpm_torch.models.transport import TransportRK
    g2 = tgeo.box_with_walls(12, 16)
    g3 = tgeo.from_solid_mask(np.zeros((16, 8, 8), bool))
    two = dict(g_matrix=((0.0, 3.6), (3.6, 0.0)), g_solid=(0.0, 0.0),
               tau=(1.0, 1.0))
    kw = dict(device="cpu", use_kernel=False)
    models = [ColorGradientRK(g2, **kw), TransportRK(g2, **kw),
              ShanChenMCMP(g2, ShanChenParams(**two), **kw),
              SinglePhaseD2Q9(g2, **kw),
              ColorGradientRK3D(g3, ColorGradientParams3D(), **kw),
              TransportRK3D(g3, ColorGradientParams3D(), **kw),
              ShanChenMCMP3D(g3, ShanChenParams3D(**two, body_force=(
                  0.0, 0.0, 0.0)), **kw),
              SinglePhaseD3Q19(g3, **kw)]
    args = argparse.Namespace(no_pallas=True, block=4)
    for m in models:
        flow = getattr(m, "flow", m)
        assert flow.path == "plain" and not flow.use_kernel
        if hasattr(type(m), "make_block_step"):
            assert m.make_block_step(2) is None
        assert tcli._pick_block(m, args, 8, 8) == (None, 1)


def test_block_note_and_cuda_without_card(tmp_path):
    ini = _mini(tmp_path, interval=2)
    text = _torch_cli(["run", ini, "--model", "cg", "--device", "cpu",
                       "--steps", "2", "--block", "4", "--output",
                       str(tmp_path / "o")])
    assert "running unblocked" in text
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["run", ini, "--model", "cg", "--steps", "2", "--output",
                   str(tmp_path / "c")])
