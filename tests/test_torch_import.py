"""openlbmpm_torch imports no JAX and builds nothing when imported.

Checked in a fresh interpreter, because tests/conftest.py has already
imported jax into this process."""

import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = (
    "import openlbmpm_torch, openlbmpm_torch.models, "
    "openlbmpm_torch.models.base, openlbmpm_torch.models.colorgradient, "
    "openlbmpm_torch.models.transport, openlbmpm_torch.kernels.csf, "
    "openlbmpm_torch.kernels.transport, openlbmpm_torch.kernels.build, "
    "openlbmpm_torch.convert, openlbmpm_torch.ops.boundaries, "
    "openlbmpm_torch.ops.collision, openlbmpm_torch.ops.colorgrad, "
    "openlbmpm_torch.ops.common, openlbmpm_torch.ops.equilibrium, "
    "openlbmpm_torch.ops.forcing, openlbmpm_torch.ops.macroscopic, "
    "openlbmpm_torch.ops.streaming, openlbmpm_torch.ops.transport, "
    "openlbmpm_torch.cli, openlbmpm_torch.config, "
    "openlbmpm_torch.checkpoint, openlbmpm_torch.metrics, "
    "openlbmpm_torch.io, sys; ")


def _run(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("check", [
    "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
    "if m.startswith('jax'))",
    "from openlbmpm_torch.kernels import build; "
    "assert not build._loaded and not build.build_seconds",
], ids=["no_jax", "no_build_at_import"])
def test_import_isolation(check):
    res = _run(_IMPORT_ALL + check)
    assert res.returncode == 0, res.stderr


def test_cli_runs_without_jax(tmp_path):
    """``python -m openlbmpm_torch inspect`` in a fresh interpreter that
    cannot import jax (a stub module that raises stands first on the
    path)."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text(
        "raise ImportError('jax is not available')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), ROOT])
    res = subprocess.run(
        [sys.executable, "-m", "openlbmpm_torch", "inspect",
         os.path.join(ROOT, "configs", "rk_csf2d.ini"), "--model", "cg"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert '"collision": "MRT"' in res.stdout


def test_cuda_device_without_card_raises():
    from openlbmpm_torch import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
