"""openlbmpm_torch imports no JAX and nothing of the JAX package, builds
nothing when imported, keeps tables equal to the JAX package's, and runs
on the card unless told otherwise.

The import checks run in a fresh interpreter, because tests/conftest.py has
already imported jax into this process."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from openlbmpm_tpu import geometry as jgeo
from openlbmpm_tpu import lattice as jlat
from openlbmpm_torch import geometry as tgeo
from openlbmpm_torch import lattice as tlat
from openlbmpm_torch.parallel import dryrun

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
    "openlbmpm_torch.io, openlbmpm_torch.lattice, openlbmpm_torch.geometry, "
    "openlbmpm_torch.models.shanchen, openlbmpm_torch.ops.shanchen, "
    "openlbmpm_torch.kernels.shanchen, openlbmpm_torch.models.flow3d, "
    "openlbmpm_torch.kernels.cg3d, openlbmpm_torch.models.single_phase, "
    "openlbmpm_torch.kernels.single, openlbmpm_torch.kernels.flow3d, "
    "openlbmpm_torch.parallel, openlbmpm_torch.parallel.mesh, "
    "openlbmpm_torch.parallel.dryrun, sys; ")


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
    "assert not [m for m in sys.modules if m.startswith('openlbmpm_tpu')], "
    "sorted(m for m in sys.modules if m.startswith('openlbmpm_tpu'))",
], ids=["no_jax", "no_build_at_import", "no_jax_package"])
def test_import_isolation(check):
    res = _run(_IMPORT_ALL + check)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("model,ini,want", [
    ("cg", "rk_csf2d.ini", '"collision": "MRT"'),
    ("sc", "twophasesetup.ini", '"scheme": "SC"'),
    ("cg3d", "rk_csf3d.ini", '"surface_tension": 0.005'),
    ("basic", "basicsetup.ini", '"collision": "MRT"'),
    ("sc3d", "shanchen3d.ini", '"psi": "rho"'),
])
def test_cli_runs_without_jax(tmp_path, model, ini, want):
    """``python -m openlbmpm_torch inspect`` in a fresh interpreter that can
    import neither jax nor the JAX package (stub packages that raise stand
    first on the path)."""
    for stub in ("jax", "openlbmpm_tpu"):
        (tmp_path / stub).mkdir()
        (tmp_path / stub / "__init__.py").write_text(
            f"raise ImportError('{stub} is not available')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), ROOT])
    res = subprocess.run(
        [sys.executable, "-m", "openlbmpm_torch", "inspect",
         os.path.join(ROOT, "configs", ini), "--model", model],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert want in res.stdout


def test_dryrun_runs_without_jax(tmp_path):
    """``python -m openlbmpm_torch.parallel.dryrun --in-process --device
    cpu`` in a fresh interpreter that can import neither jax nor the JAX
    package: the multi-device entry point stands alone, and so do the
    sharded builders and local steps its lines drive (the GSPMD line's
    x-sharded plain step, K12a-e)."""
    for stub in ("jax", "openlbmpm_tpu"):
        (tmp_path / stub).mkdir()
        (tmp_path / stub / "__init__.py").write_text(
            f"raise ImportError('{stub} is not available')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), ROOT])
    res = subprocess.run(
        [sys.executable, "-m", "openlbmpm_torch.parallel.dryrun",
         "--in-process", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("dryrun_multichip ") == len(dryrun.CASES) == 11


def test_2d_sc_sharded_step_imports_no_jax():
    """Building and calling the sharded 2-D Shan-Chen step (K12c: two
    fluids with Zou-He and convective rows at T = 2, four fluids at T = 1)
    and its local plain version, and the GSPMD line's x-sharded plain
    split step, on the CPU imports neither jax nor the JAX package."""
    code = (
        "import sys, numpy as np, torch; "
        "from openlbmpm_torch.geometry import from_solid_mask as fsm; "
        "from openlbmpm_torch.models import shanchen as sc; "
        "from openlbmpm_torch.kernels.shanchen import build_sc_sharded_step; "
        "from openlbmpm_torch.parallel import dryrun, make_mesh; "
        "solid = np.zeros((32, 12), bool); solid[:, 0] = True; "
        "g = fsm(solid); mesh = make_mesh(shape=(2, 1), kind='local', "
        "device='cpu'); "
        "p = sc.ShanChenParams(g_matrix=((0, 3.6), (3.6, 0)), "
        "g_solid=(0, 0), tau=(1, 1)); "
        "b = sc.SCBoundaryConfig(inlet='zou_he_velocity', "
        "outlet='convective', inlet_velocity=(-1e-3, 0)); "
        "st = build_sc_sharded_step(g, p, mesh, torch.float64, "
        "steps_per_call=2, bc_config=b); m = st.model; "
        "x = st.gather(st(st.shard(m.init_state_layers((1, 1), (.1, .1))))); "
        "g4 = tuple(tuple(0.0 if i == j else 3.6 for j in range(4)) "
        "for i in range(4)); "
        "p4 = sc.ShanChenParams(g_matrix=g4, g_solid=(0,) * 4, tau=(1,) * 4); "
        "st = build_sc_sharded_step(g, p4, mesh, torch.float64); "
        "m = st.model; x = st.gather(st(st.shard(m.init_state_layers("
        "(1,) * 4, (.1,) * 4)))); "
        "gg, kw, start = dryrun.case_model('gspmd', (32, 32), torch.float64); "
        "st = dryrun.build_gspmd_step(gg, kw['params'], kw['bc_config'], "
        "make_mesh(shape=(1, 2), kind='local', device='cpu'), "
        "torch.float64); x = st.gather(st(st.shard(*start))); "
        "assert not [k for k in sys.modules if k.startswith(('jax', "
        "'openlbmpm_tpu'))]")
    res = _run(code)
    assert res.returncode == 0, res.stderr


def test_3d_sharded_steps_import_no_jax():
    """Building and calling the 3-D sharded steps (K12d with and without a
    tracer, K12e) and their local plain versions on the CPU imports neither
    jax nor the JAX package (the builders import lazily)."""
    code = (
        "import sys, numpy as np, torch; "
        "from openlbmpm_torch.geometry import from_solid_mask as fsm; "
        "from openlbmpm_torch.models import flow3d as f3; "
        "from openlbmpm_torch.kernels.cg3d import build_cg3d_sharded_step; "
        "from openlbmpm_torch.kernels.flow3d import build_sc3d_sharded_step; "
        "from openlbmpm_torch.parallel import make_mesh; "
        "solid = np.zeros((16, 8, 8), bool); solid[:, 0] = True; "
        "g = fsm(solid); mesh = make_mesh(shape=(2, 1), kind='local', "
        "device='cpu'); "
        "b = f3.CG3DBoundaryConfig(inlet='velocity', outlet='convective'); "
        "st = build_cg3d_sharded_step(g, f3.ColorGradientParams3D(), mesh, "
        "torch.float64, bc_config=b); m = st.model; "
        "x = st.gather(st(st.shard(m.pack_state(*m.init_state_layers())))); "
        "tr = f3.TransportD3Q7(g, device='cpu', dtype=torch.float64); "
        "st = build_cg3d_sharded_step(g, f3.ColorGradientParams3D(), mesh, "
        "torch.float64, transport=tr); m = st.model; "
        "x = st.gather(st(st.shard(*m.pack(m.init_state("
        "m.flow.init_state_layers(), np.ones((1, 16, 8, 8))))))); "
        "p = f3.ShanChenParams3D(g_matrix=((0, 3.6), (3.6, 0)), "
        "g_solid=(0, 0), tau=(1, 1)); "
        "st = build_sc3d_sharded_step(g, p, mesh, torch.float64, "
        "steps_per_call=2); m = st.model; "
        "x = st.gather(st(st.shard(m.init_state_droplet((1, 1), (.1, .1), "
        "radius=3)))); "
        "assert not [k for k in sys.modules if k.startswith(('jax', "
        "'openlbmpm_tpu'))]")
    res = _run(code)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("name", ["D2Q9", "D2Q5", "D3Q19", "D3Q7"])
def test_lattice_tables_equal_jax(name):
    a, b = getattr(tlat, name), getattr(jlat, name)
    for field in ("e", "w", "opp"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert a.cs2 == b.cs2
    assert (a.M is None) == (b.M is None)
    if a.M is not None:
        np.testing.assert_array_equal(a.M, b.M)
        np.testing.assert_array_equal(a.M_inv, b.M_inv)


def test_iso_stencils_equal_jax():
    assert sorted(tlat.ISO_STENCILS) == sorted(jlat.ISO_STENCILS)
    for order, st in tlat.ISO_STENCILS.items():
        np.testing.assert_array_equal(st.offsets,
                                      jlat.ISO_STENCILS[order].offsets)
        np.testing.assert_array_equal(st.weights,
                                      jlat.ISO_STENCILS[order].weights)


def _masks():
    rng = np.random.default_rng(0)
    porous = rng.random((20, 16)) < 0.3
    ring = np.zeros((12, 12), bool)
    ring[3:9, 3:9] = True
    ring[5:7, 5:7] = False
    return {"porous": porous, "ring": ring,
            "channel": jgeo.open_channel(10, 24).is_solid}


@pytest.mark.parametrize("mask", ["porous", "ring", "channel"])
def test_geometry_builders_equal_jax(mask):
    solid = _masks()[mask]
    for fn, args in (("from_solid_mask", ()), ("solid_normals", ()),
                     ("wetting_masks", ()), ("add_buffer_layers", (3,)),
                     ("duplicate_domain", (2, 2))):
        a = getattr(tgeo, fn)(solid, *args)
        b = getattr(jgeo, fn)(solid, *args)
        if fn == "from_solid_mask":
            a, b = (a.is_solid, a.is_fluid), (b.is_solid, b.is_fluid)
        for x, y in zip(np.atleast_1d(a) if fn != "add_buffer_layers"
                        else [a], np.atleast_1d(b)
                        if fn != "add_buffer_layers" else [b]):
            np.testing.assert_array_equal(x, y)
    for fn, args in (("open_channel", (10, 24)), ("box_with_walls", (9, 14))):
        np.testing.assert_array_equal(getattr(tgeo, fn)(*args).is_solid,
                                      getattr(jgeo, fn)(*args).is_solid)


def test_cuda_device_without_card_raises():
    from openlbmpm_torch import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")


@pytest.mark.parametrize("entry", ["resolve_device", "state_from_numpy",
                                   "ColorGradientRK", "TransportRK",
                                   "ShanChenMCMP", "ColorGradientRK3D",
                                   "cli_cg3d", "SinglePhaseD2Q9",
                                   "SinglePhaseD3Q19", "ShanChenMCMP3D",
                                   "cli_basic"])
def test_entry_points_default_to_the_card(entry, tmp_path):
    """Built without ``device=``, each entry point asks for CUDA: here,
    with no card, it raises."""
    from openlbmpm_torch import resolve_device
    from openlbmpm_torch.convert import state_from_numpy
    from openlbmpm_torch import cli
    from openlbmpm_torch.models import (ColorGradientParams3D,
                                        ColorGradientRK, ColorGradientRK3D,
                                        ShanChenMCMP, ShanChenMCMP3D,
                                        ShanChenParams, ShanChenParams3D,
                                        SinglePhaseD2Q9, SinglePhaseD3Q19,
                                        TransportRK)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    geometry = tgeo.box_with_walls(8, 16)
    box3d = tgeo.from_solid_mask(np.zeros((8, 6, 6), bool))
    ini3d = os.path.join(ROOT, "configs", "rk_csf3d.ini")
    make = {
        "resolve_device": lambda: resolve_device(),
        "state_from_numpy": lambda: state_from_numpy(np.zeros((9, 4, 4))),
        "ColorGradientRK": lambda: ColorGradientRK(geometry),
        "TransportRK": lambda: TransportRK(geometry),
        "ShanChenMCMP": lambda: ShanChenMCMP(geometry, ShanChenParams(
            g_matrix=((0.0, 3.6), (3.6, 0.0)), g_solid=(0.0, 0.0),
            tau=(1.0, 1.0))),
        "ColorGradientRK3D": lambda: ColorGradientRK3D(
            box3d, ColorGradientParams3D()),
        "cli_cg3d": lambda: cli.main(["run", ini3d, "--model", "cg3d",
                                      "--steps", "1", "--output",
                                      str(tmp_path)]),
        "SinglePhaseD2Q9": lambda: SinglePhaseD2Q9(geometry),
        "SinglePhaseD3Q19": lambda: SinglePhaseD3Q19(box3d),
        "ShanChenMCMP3D": lambda: ShanChenMCMP3D(box3d, ShanChenParams3D(
            g_matrix=((0.0, 3.6), (3.6, 0.0)), g_solid=(0.0, 0.0),
            tau=(1.0, 1.0))),
        "cli_basic": lambda: cli.main([
            "run", os.path.join(ROOT, "configs", "basicsetup.ini"),
            "--model", "basic", "--steps", "1", "--output", str(tmp_path)]),
    }[entry]
    with pytest.raises(RuntimeError, match="cuda"):
        make()
