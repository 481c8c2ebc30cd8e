"""``python -m openlbmpm_torch run|inspect --model basic|basic3d|sc3d``
against the JAX CLI, on the CPU.

Each run takes a shipped INI cut to a small domain, runs the JAX CLI with
``--no-pallas --dtype f64`` (its steps jitted: the single-phase and
Shan-Chen steps have no tie-break that XLA's reassociation could flip) and
the port's with ``--device cpu --dtype f64``, and compares the result
files and the final checkpoint to 1e-12 and the physics fields of
metrics.jsonl to 1e-10, as tests/test_torch_cli.py does for the other
families.  ``inspect`` prints what the JAX CLI prints.
"""

import contextlib
import io
import os

import pytest

from openlbmpm_tpu import cli as jcli
from test_torch_cli import (_ini, _records, _results, _same_arrays,
                            _same_checkpoint, _same_records, _torch_cli)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")

# model -> (shipped INI, edits cutting it to size, result basename,
# result datasets per output step, the line the port prints)
RUNS = {
    "basic": ("basicsetup.ini", {
        "nx = .*": "nx = 20", "ny = .*": "ny = 32",
        "xDomain = .*": "xDomain = 1,18", "yDomain = .*": "yDomain = 0,31",
        "TimeLength = .*": "TimeLength = 20",
        "TimeInterval = .*": "TimeInterval = 10",
        "VelocityYLB = .*": "VelocityYLB = -0.01"},
        "SimulationResults", 3, "--model basic, MRT: the plain step on cpu"),
    "basic3d": ("basic3d.ini", {
        "nx = .*": "nx = 10", "ny = .*": "ny = 8", "nz = .*": "nz = 12",
        "TimeLength = .*": "TimeLength = 20",
        "TimeInterval = .*": "TimeInterval = 10", "Type = .*": "Type = 'TRT'",
        "gValue = .*": "gValue = -1e-4"},
        "SimulationResults3D", 1,
        "--model basic3d, TRT: the plain step on cpu"),
    "sc3d": ("shanchen3d.ini", {
        "xDomain = .*": "xDomain = 12", "yDomain = .*": "yDomain = 10",
        "zDomain = .*": "zDomain = 14",
        "numberTimeStep = .*": "numberTimeStep = 10",
        "TimeInterval = .*": "TimeInterval = 5",
        "DropletRadius = .*": "DropletRadius = 3.0",
        "Option = .*": "Option = 'yes'", "forceZG = .*": "forceZG = -1e-5"},
        "SimulationResultsSC3D", 2, "--model sc3d, 2 fluids: the plain step "
        "on cpu"),
}


def _jax_cli(argv):
    with contextlib.redirect_stdout(io.StringIO()):
        assert jcli.main(argv) == 0


@pytest.mark.parametrize("model", sorted(RUNS))
def test_cli_matches_jax_cli_f64(tmp_path, model):
    name, edits, basename, per_step, line = RUNS[model]
    ini = _ini(tmp_path, os.path.join(CONFIGS, name), name, edits)
    common = ["run", ini, "--model", model, "--dtype", "f64"]
    _jax_cli(common + ["--no-pallas", "--output", str(tmp_path / "j")])
    text = _torch_cli(common + ["--device", "cpu", "--output",
                                str(tmp_path / "t")])
    assert line in text
    _same_checkpoint(tmp_path / "j" / "checkpoint.npz",
                     tmp_path / "t" / "checkpoint.npz")
    got = _results(tmp_path / "t", basename)
    assert len(got) == 3 * per_step       # three output steps
    _same_arrays(_results(tmp_path / "j", basename), got)
    _same_records(tmp_path / "j" / "metrics.jsonl",
                  tmp_path / "t" / "metrics.jsonl")
    assert len(_records(tmp_path / "t" / "metrics.jsonl")) == 3


def test_cli_basic_resumes_from_a_jax_checkpoint(tmp_path):
    """JAX runs 10 steps of the cut basicsetup.ini; the port resumes its
    checkpoint to step 20 and lands within 1e-12 of a port run of 20 steps
    straight; --png writes the speed field."""
    name, edits = RUNS["basic"][:2]
    ini = _ini(tmp_path, os.path.join(CONFIGS, name), name, edits)
    common = ["run", ini, "--model", "basic", "--dtype", "f64"]
    out = str(tmp_path / "resumed")
    _jax_cli(common + ["--no-pallas", "--steps", "10", "--output", out])
    text = _torch_cli(common + ["--device", "cpu", "--steps", "10",
                                "--resume", "--png", "--output", out])
    assert "resumed from step 10" in text
    assert os.path.exists(os.path.join(out, "u_00000020.png"))
    _torch_cli(common + ["--device", "cpu", "--steps", "20", "--output",
                         str(tmp_path / "straight")])
    _same_checkpoint(tmp_path / "straight" / "checkpoint.npz",
                     os.path.join(out, "checkpoint.npz"))


@pytest.mark.parametrize("model,name", [("basic", "basicsetup.ini"),
                                        ("basic3d", "basic3d.ini"),
                                        ("sc3d", "shanchen3d.ini")])
def test_inspect_prints_what_jax_prints(model, name):
    path = os.path.join(CONFIGS, name)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert jcli.main(["inspect", path, "--model", model]) == 0
    assert _torch_cli(["inspect", path, "--model", model]) == out.getvalue()
