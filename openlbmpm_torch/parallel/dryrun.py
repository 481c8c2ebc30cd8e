"""The port's multi-device dry run: ``__graft_entry__.py::dryrun_multichip``
(:87-278) and two lines of the port's own.

    python -m openlbmpm_torch.parallel.dryrun --ranks N --device cpu|cuda
    python -m openlbmpm_torch.parallel.dryrun --in-process --device cuda

Runs, at the JAX dry run's shapes scaled by N (even, >= 2):

0. the GSPMD line (:87-105): the flagship's split step on a 1 x N x-mesh
   (``make_mesh(N)``'s default), global 32 x 16N, one step.  The port has
   no partitioner; its counterpart is the plain split step
   (``ColorGradientRK.plain_step``) sharded by hand (``build_gspmd_step``):
   each shard holds its columns and a frame of ``GSPMD_X`` columns a side,
   which the exchange fills, runs the plain step on its padded buffer and
   keeps the centre.  The line proves the exchange and the plain step's
   reach in x, not a kernel: no CUDA kernel runs in it;
1. the sharded colour-gradient step (K12a) on an (N, 1) y-mesh, the
   flagship flow at 16N x 128, T = 2;
2. K12a on a (y, x) mesh (max(2, N/4), N / that), the flagship flow at
   32 py x 64 px, T = 1;
3. the coupled flow + D2Q5 tracer step (K12a with transport, SRT,
   bounce-back interface) on an (N, 1) y-mesh, 16N x 64 (the JAX run's
   4-shard 64 x 64 at N = 4);
4. the same on a (2, N/2) mesh, 64 x 32 N/2 (its (2, 2) 64 x 64 at N = 4);
5. (the port's addition) the sharded single-phase step (K12b) on an
   (N, 1) y-mesh, 16N x 64, MRT, Zou-He inlet, convective outlet, T = 2;
6. the sharded D3Q19 CSF step (K12d) on an (N, 1) z-mesh, 8N x 16 x 16
   with y walls, velocity inlet and convective outlet (:150-177);
7. K12d on a (N/2, 2) z*y mesh, 4N x 64 x 16 (:179-200);
8. K12d with one D3Q7 bounce-back tracer on an (N, 1) z-mesh, 8N x 16 x 16,
   periodic, the tracer in the top half (:258-278);
9. (the port's addition) the sharded D3Q19 Shan-Chen step (K12e), two
   fluids, a droplet, on an (N, 1) z-mesh, 8N x 16 x 16, T = 2;
10. (the port's addition) the sharded 2-D Shan-Chen step (K12c), two
    fluids (G = 3.6, G_s = -0.3 / 0.3), side walls, a Zou-He velocity inlet
    and a convective outlet, fluid 0 in the top 12 rows, on an (N, 1)
    y-mesh, 16N x 64, T = 2 (tests/test_multichip.py:278-315 at N = 4).

Each prints one line in the JAX wording, checks that the state stays finite
and holds the gathered state against the port's single-device step (the
T-step kernel at the same T on a card, the plain step on the CPU): the line
gives the largest difference.  With ``--ranks N`` the shards are N
processes of a ``torch.distributed`` group (``ProcessMesh``: gloo on the
CPU, NCCL with one card a rank, so N cards), which this module spawns and
joins with a deadline; with ``--in-process`` all N shards run in this
process on one device (``LocalMesh``), which is what one card can prove.
The GSPMD line is held to the single-device plain split step on every
device.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch

__all__ = ["CASES", "GSPMD_X", "build_gspmd_step", "case_model", "run_case",
           "run_ranks", "main"]

# name -> (family, global shape from N, mesh shape from N, T)
CASES = {
    "gspmd": ("gspmd", lambda n: (32, 16 * n), lambda n: (1, n), 1),
    "y": ("csf", lambda n: (16 * n, 128), lambda n: (n, 1), 2),
    "yx": ("csf", lambda n: (32 * max(2, n // 4), 64 * (n // max(2, n // 4))),
           lambda n: (max(2, n // 4), n // max(2, n // 4)), 1),
    "coupled_y": ("coupled", lambda n: (16 * n, 64), lambda n: (n, 1), 1),
    "coupled_yx": ("coupled", lambda n: (64, 32 * (n // 2)),
                   lambda n: (2, n // 2), 1),
    "single_y": ("single", lambda n: (16 * n, 64), lambda n: (n, 1), 2),
    "z3": ("cg3d", lambda n: (8 * n, 16, 16), lambda n: (n, 1), 1),
    "zy3": ("cg3d", lambda n: (4 * n, 64, 16), lambda n: (n // 2, 2), 1),
    "coupled_z3": ("coupled3d", lambda n: (8 * n, 16, 16), lambda n: (n, 1),
                   1),
    "sc3d_z": ("sc3d", lambda n: (8 * n, 16, 16), lambda n: (n, 1), 2),
    "sc_y": ("sc", lambda n: (16 * n, 64), lambda n: (n, 1), 2),
}
# the cases of the tests at 64 x 64 f64 on 4 shards: T = 1 (the Shan-Chen
# case at T = 2)
TEST_CASES = {
    "csf_y_t1": ("csf", (64, 64), (4, 1), 1),
    "coupled_yx_t1": ("coupled", (64, 64), (2, 2), 1),
    "cg3d_zy_t1": ("cg3d", (16, 64, 16), (2, 2), 1),
    "sc_y_t2": ("sc", (64, 64), (4, 1), 2),
}


# the GSPMD line's x frame: the plain split step's reach in x at the
# flagship's configuration, the columns a step reads on each side of a cell
# (the colour gradient's stencil, then streaming).  Found by test:
# tests/test_torch_sharded_sc.py holds the sharded step with this frame to
# the single-device step bit for bit from a noisy state, and shows that one
# column less differs.
GSPMD_X = 2


def build_gspmd_step(geometry, params, bcs, mesh, dtype, frame_x=GSPMD_X):
    """The counterpart of the JAX dry run's GSPMD line (XLA's partitioner
    on the jitted ``_step_impl`` with x shardings, ``__graft_entry__.py:
    87-105``): the plain split step ``ColorGradientRK.plain_step`` sharded
    by hand over a (1, P) `mesh`.  Each shard holds its nx / P columns and a
    frame of `frame_x` columns a side (``parallel.mesh.Frame``), which the
    exchange fills once a step; it runs the plain step of a model of its
    padded columns of the geometry (built once here) on its padded buffers
    (f_r, f_b) and keeps the centre.  The step's row operations (the inlet
    and outlet rows) act column by column and nothing reduces over x, so
    the centre is exact where the frame covers the step's reach.  Returns
    a ``parallel.mesh.ShardedStep`` of one step a call (``step.model`` the
    single-device model), or None for a mesh with a y axis larger than 1
    or nx not divisible by P."""
    from ..geometry import from_solid_mask
    from ..models.colorgradient import ColorGradientRK
    from .mesh import Frame, ShardedStep
    ny, nx = geometry.shape
    py, px = mesh.shape
    if py != 1 or nx % px or frame_x > nx // px:
        return None
    nxl = nx // px
    models = {}
    for k in mesh.local_ids():
        cols = (np.arange(nxl + 2 * frame_x) + mesh.coords(k)[1] * nxl -
                frame_x) % nx
        models[k] = ColorGradientRK(from_solid_mask(geometry.is_solid[:, cols]),
                                    params, bcs, dtype=dtype,
                                    device=mesh.device, use_kernel=False)

    def local(k, grid, ins, outs):
        for o, x in zip(outs, models[k].plain_step(ins)):
            grid.centre(o).copy_(grid.centre(x))

    step = ShardedStep(mesh, (ny, nx), Frame(0, 0, frame_x), local, 1,
                       (dtype, dtype))
    step.model = ColorGradientRK(geometry, params, bcs, dtype=dtype,
                                 device=mesh.device, use_kernel=False)
    return step


def _walled(ny, nx):
    from ..geometry import from_solid_mask
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    return from_solid_mask(solid)


def _case3d(family, shape):
    """`case_model` of the 3-D families: the JAX dry run's 3-D flow
    (:153-166: y walls, sigma 0.01, tau 1.0 / 0.8, 60 degrees, velocity
    inlet v = -1e-3, convective outlet, red in the top 8 slabs) for
    "cg3d"; the same flow, periodic, with one D3Q7 bounce-back tracer at 1
    in the top half (:258-270) for "coupled3d"; and for "sc3d" two
    Shan-Chen fluids with y walls (G = 3.6, G_s = -0.3 / 0.3, tau 1.0 /
    0.8, g_z = -1e-5), a droplet of radius 5 (tests/test_multichip.py:
    323-352)."""
    from ..geometry import from_solid_mask
    from ..models import flow3d as f3
    solid = np.zeros(shape, bool)
    solid[:, 0, :] = solid[:, -1, :] = True
    g = from_solid_mask(solid)
    if family == "sc3d":
        p = f3.ShanChenParams3D(g_matrix=((0.0, 3.6), (3.6, 0.0)),
                                g_solid=(-0.3, 0.3), tau=(1.0, 0.8),
                                body_force=(0.0, 0.0, -1e-5))
        m = f3.ShanChenMCMP3D(g, p, dtype=torch.float64, device="cpu")
        return g, dict(params=p), (m.init_state_droplet(
            (1.0, 1.0), (0.02, 0.02), radius=5.0),)
    p = f3.ColorGradientParams3D(surface_tension=0.01, tau_r=1.0, tau_b=0.8,
                                 contact_angle_deg=60.0)
    if family == "cg3d":
        bcs = f3.CG3DBoundaryConfig(inlet="velocity", outlet="convective",
                                    inlet_velocity=-1e-3)
        m = f3.ColorGradientRK3D(g, p, bcs, dtype=torch.float64, device="cpu")
        return g, dict(params=p, bc_config=bcs), (m.pack_state(
            *m.init_state_layers(1.0, 1.0, invading_slabs=8)),)
    m = f3.TransportRK3D(g, p, num_tracers=1, tau=(1.0,),
                         interface_mode="bounceback", dtype=torch.float64,
                         device="cpu")
    conc0 = np.zeros((1, *shape))
    conc0[:, shape[0] // 2:] = 1.0
    s, gg = m.pack(m.init_state(m.flow.init_state_layers(
        1.0, 1.0, invading_slabs=8), conc0))
    return g, dict(params=p, bc_config=m.flow.bcs,
                   transport=m.transport), (s, gg)


def case_model(family: str, shape, dtype):
    """(geometry, builder keyword arguments, start arrays) of a family at a
    global shape: the JAX dry run's flagship flow (``__graft_entry__.py::
    _flagship_model``) for "csf" with red in the top 6 rows (the packed
    state) and for "gspmd" (the split state (f_r, f_b)), its coupled case
    (:197-243) for "coupled" (12 invading rows, the tracer in the top
    half), for "single" a walled channel at rest with a Zou-He inlet, for
    "sc" the Shan-Chen case of tests/test_multichip.py:278-315, and the
    3-D families of ``_case3d``.  The start is made in float64 and cast to
    `dtype`."""
    from ..models.colorgradient import (CGBoundaryConfig, ColorGradientParams,
                                        ColorGradientRK)
    if family in ("cg3d", "coupled3d", "sc3d"):
        g, kw, start = _case3d(family, shape)
        return g, kw, tuple(a.to(dtype) for a in start)
    ny, nx = shape
    g = _walled(ny, nx)
    if family == "sc":
        from ..models.shanchen import (SCBoundaryConfig, ShanChenMCMP,
                                       ShanChenParams)
        p = ShanChenParams(g_matrix=((0.0, 3.6), (3.6, 0.0)),
                           g_solid=(-0.3, 0.3), tau=(1.0, 1.0))
        bcs = SCBoundaryConfig(inlet="zou_he_velocity", outlet="convective",
                               inlet_velocity=(-1e-3, 0.0))
        m = ShanChenMCMP(g, p, bcs, dtype=torch.float64, device="cpu")
        return g, dict(params=p, bc_config=bcs), (m.init_state_layers(
            (1.0, 1.0), (0.02, 0.02), invading_rows=12).to(dtype),)
    if family == "single":
        from ..models.single_phase import BoundaryConfig, SinglePhaseD2Q9
        bcs = BoundaryConfig(inlet="zou_he_velocity", outlet="convective",
                             inlet_velocity=-1e-3)
        kw = dict(tau=0.8, collision="MRT", body_force=(0.0, 0.0),
                  bc_config=bcs)
        m = SinglePhaseD2Q9(g, 0.8, "MRT", boundaries=bcs,
                            dtype=torch.float64, device="cpu")
        return g, kw, (m.init_state().to(dtype),)
    if family in ("csf", "gspmd"):
        params = ColorGradientParams(
            tau_r=1.0, tau_b=1.0, surface_tension=0.1, contact_angle_deg=60.0,
            beta=0.7, delta=0.98, tau_type=2, wetting_type=2, variant="CSF",
            collision="MRT")
        bcs = CGBoundaryConfig(inlet="neumann", outlet="dirichlet",
                               inlet_velocity=-1e-4, outlet_density_r=0.0,
                               outlet_density_b=1.0)
        m = ColorGradientRK(g, params, bcs, dtype=torch.float64, device="cpu")
        st = m.init_state_layers(1.0, 1.0, invading_rows=6)
        if family == "gspmd":
            return g, dict(params=params, bc_config=bcs), tuple(
                a.to(dtype) for a in st)
        s = m.pack_state(*st)
        return g, dict(params=params, bc_config=bcs), (s.to(dtype),)
    from ..models.transport import TransportParams, TransportRK
    params = ColorGradientParams(variant="CSF", collision="MRT",
                                 surface_tension=0.01, tau_type=2,
                                 wetting_type=2)
    bcs = CGBoundaryConfig(inlet="neumann", outlet="dirichlet",
                           inlet_velocity=-1e-3, outlet_density_r=0.0,
                           outlet_density_b=1.0)
    tp = TransportParams(num_tracers=1, scheme=5, tau=(1.0,),
                         interface_mode="bounceback")
    m = TransportRK(g, params, tp, bcs, dtype=torch.float64, device="cpu")
    conc0 = np.zeros((1, ny, nx))
    conc0[:, ny // 2:] = 1.0
    st = m.init_state(m.flow.init_state_layers(1.0, 1.0, invading_rows=12),
                      conc0)
    s = m.flow.pack_state(st.f_r, st.f_b)
    return g, dict(params=params, bc_config=bcs, transport_params=tp), (
        s.to(dtype), st.g.to(dtype))


def _builder(family):
    from ..kernels.cg3d import build_cg3d_sharded_step
    from ..kernels.csf import build_csf_sharded_step
    from ..kernels.flow3d import build_sc3d_sharded_step
    from ..kernels.shanchen import build_sc_sharded_step
    from ..kernels.single import build_single_sharded_step
    if family == "gspmd":
        def build(g, mesh, dtype, steps, kw):
            return build_gspmd_step(g, kw["params"], kw["bc_config"], mesh,
                                    dtype)
    elif family == "sc":
        def build(g, mesh, dtype, steps, kw):
            return build_sc_sharded_step(g, kw["params"], mesh, dtype,
                                         steps_per_call=steps,
                                         bc_config=kw["bc_config"])
    elif family in ("cg3d", "coupled3d"):
        def build(g, mesh, dtype, steps, kw):
            return build_cg3d_sharded_step(g, kw["params"], mesh, dtype,
                                           bc_config=kw["bc_config"],
                                           transport=kw.get("transport"))
    elif family == "sc3d":
        def build(g, mesh, dtype, steps, kw):
            return build_sc3d_sharded_step(g, kw["params"], mesh, dtype,
                                           steps_per_call=steps)
    elif family == "single":
        def build(g, mesh, dtype, steps, kw):
            return build_single_sharded_step(
                g, kw["tau"], kw["collision"], kw["body_force"], mesh,
                bc_config=kw["bc_config"], dtype=dtype, steps_per_call=steps)
    else:
        def build(g, mesh, dtype, steps, kw):
            return build_csf_sharded_step(g, kw["params"], mesh, dtype,
                                          steps_per_call=steps, **{
                                              k: v for k, v in kw.items()
                                              if k != "params"})
    return build


def _one_device(step, start, calls):
    """`calls` calls of the single-device step that the shards' kernels
    are held to: the T-step kernel at the step's T on a card (the T-step
    wrappers at T = 1 too), the plain step on the CPU; for the GSPMD line
    the plain split step on every device."""
    from ..kernels import cg3d as kg
    from ..kernels import csf as kc
    from ..kernels import flow3d as kf
    from ..kernels import shanchen as ksc
    from ..kernels import single as ks
    from ..kernels import transport as kt
    from ..models import flow3d as f3
    from ..models.colorgradient import ColorGradientRK
    from ..models.shanchen import ShanChenMCMP
    m, t = step.model, step.steps_per_call
    dev = step.mesh.device
    x = tuple(a.to(dev) for a in start)
    for _ in range(calls):
        if isinstance(m, ColorGradientRK) and not m.use_kernel:
            x = tuple(m.plain_step(x))
        elif isinstance(m, ShanChenMCMP):
            x = (ksc.sc_block_step(x[0], m, t),)
        elif isinstance(m, f3.TransportRK3D):
            x = kg.coupled3d_step_compressed(*x, m)
        elif isinstance(m, f3.ColorGradientRK3D):
            x = (kg.cg3d_step_compressed(x[0], m),)
        elif isinstance(m, f3.ShanChenMCMP3D):
            x = (kf.sc3d_block_step(x[0], m, t),)
        elif hasattr(m, "tracer_table"):
            x = kt.coupled_block_compressed(x, m, t)
        elif hasattr(m, "geo_planes"):
            fn = kc.csf_block_compressed if m.p.variant == "CSF" else \
                kc.pert_block_compressed
            x = (fn(x[0], m, t),)
        else:
            x = (ks.single_block_step(x[0], m, t),)
    return x


def run_case(family, shape, mesh, steps, dtype, calls=1, compare=True):
    """Build the family's sharded step at `shape` on `mesh` with T =
    `steps`, run `calls` calls from ``case_model``'s start, and return
    (gathered arrays on the CPU, start arrays, the largest difference from
    the single-device step or None).  On a ``ProcessMesh`` every rank gets
    the gathered arrays."""
    g, kw, start = case_model(family, shape, dtype)
    step = _builder(family)(g, mesh, dtype, steps, kw)
    if step is None:
        raise RuntimeError(f"{family} at {shape} on mesh {mesh.shape}, "
                           f"T={steps}: no sharded step")
    state = step.shard(*start)
    for _ in range(calls):
        state = step(state)
    out = step.gather(state)
    out = (out,) if torch.is_tensor(out) else out
    diff = None
    if compare:
        ref = _one_device(step, start, calls)
        diff = max(float((a.double() - b.double()).abs().max())
                   for a, b in zip(out, ref))
    return tuple(a.cpu() for a in out), start, diff


def _line(name, shape, mesh_shape):
    py, px = mesh_shape
    if name == "gspmd":
        return (f"dryrun_multichip OK on {px} devices; global shape "
                f"{tuple(shape)}")
    if name == "sc_y":
        return ("dryrun_multichip 2D Shan-Chen fused+sharded OK on "
                f"{py}-shard y-mesh; global shape {tuple(shape)}")
    if name == "y":
        return (f"dryrun_multichip fused+sharded OK on {py}-shard y-mesh; "
                f"global shape {tuple(shape)}")
    if name == "yx":
        return (f"dryrun_multichip fused+sharded OK on ({py},{px}) y*x mesh; "
                f"global shape {tuple(shape)}")
    if name == "coupled_y":
        return f"dryrun_multichip 2D coupled fused+sharded OK on {py}-shard y-mesh"
    if name == "coupled_yx":
        return f"dryrun_multichip 2D coupled fused+sharded OK on ({py},{px}) y*x mesh"
    if name == "z3":
        return (f"dryrun_multichip 3D fused+sharded OK on {py}-shard z-mesh; "
                f"global shape {tuple(shape)}")
    if name == "zy3":
        return (f"dryrun_multichip 3D fused+sharded OK on ({py},{px}) z*y "
                f"mesh; global shape {tuple(shape)}")
    if name == "coupled_z3":
        return (f"dryrun_multichip 3D coupled fused+sharded OK on {py}-shard "
                "z-mesh")
    if name == "sc3d_z":
        return ("dryrun_multichip 3D Shan-Chen fused+sharded OK on "
                f"{py}-shard z-mesh; global shape {tuple(shape)}")
    return (f"dryrun_multichip single-phase fused+sharded OK on {py}-shard "
            f"y-mesh; global shape {tuple(shape)}")


# the largest difference from the single-device step that a line accepts
# (float32: the local kernels run the single-device kernels' arithmetic)
DRYRUN_BOUND = 1e-5


def _run_all(mesh_of, n, dtype, emit):
    for name, (family, shape_of, mshape_of, steps) in CASES.items():
        shape, mshape = shape_of(n), mshape_of(n)
        mesh = mesh_of(mshape)
        out, _, diff = run_case(family, shape, mesh, steps, dtype)
        if not all(bool(torch.isfinite(a).all()) for a in out):
            raise FloatingPointError(f"dryrun {name}: state not finite")
        if not diff <= DRYRUN_BOUND:
            raise AssertionError(f"dryrun {name}: sharded vs one device "
                                 f"{diff:.3e} > {DRYRUN_BOUND:g}")
        emit(f"{_line(name, shape, mshape)}; max |diff| vs one device "
             f"{diff:.3e} (T={steps}, {mesh!r})")


def _init_group(rank, world, init_file, device, timeout_s):
    import torch.distributed as dist
    backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))


def _rank_main(rank, world, init_file, device, job, out_dir, timeout_s):
    """One rank: init the process group, then `job` = "dryrun" (every case;
    rank 0 prints the lines) or a name of TEST_CASES (rank 0 saves the
    gathered arrays and the start to ``<out_dir>/<name>.pt``)."""
    import torch.distributed as dist
    from .mesh import make_mesh
    torch.set_num_threads(1)
    _init_group(rank, world, init_file, device, timeout_s)
    try:
        if job == "dryrun":
            _run_all(lambda shape: make_mesh(shape=shape, kind="process",
                                             device=device), world,
                     torch.float32,
                     lambda ln: rank == 0 and print(ln, flush=True))
        else:
            family, shape, mshape, steps = TEST_CASES[job]
            mesh = make_mesh(shape=mshape, kind="process", device=device)
            out, start, _ = run_case(family, shape, mesh, steps,
                                     torch.float64, calls=4 // steps,
                                     compare=False)
            if rank == 0:
                torch.save({"out": out, "start": start},
                           os.path.join(out_dir, f"{job}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, device: str, job: str = "dryrun",
              out_dir: str | None = None, timeout_s: float = 300.0) -> None:
    """Spawn `world` ranks running ``_rank_main`` (rendezvous through a
    file in a new temporary directory), join them within `timeout_s`
    seconds (killing them after), and raise if one failed."""
    import torch.multiprocessing as tmp
    with tempfile.TemporaryDirectory() as rdv:
        ctx = tmp.start_processes(
            _rank_main, args=(world, os.path.join(rdv, "store"), device, job,
                              out_dir or rdv, timeout_s),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.1, deadline -
                                           time.monotonic())):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{timeout_s:g} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m openlbmpm_torch.parallel.dryrun",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4,
                    help="shards (even, >= 2): processes of a process group, "
                         "or with --in-process shards in this process")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--in-process", action="store_true",
                    help="all shards in this process on one device "
                         "(LocalMesh)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds to wait for the ranks")
    args = ap.parse_args(argv)
    n = args.ranks
    if n < 2 or n % 2:
        ap.error("--ranks: an even number >= 2")
    if args.in_process:
        from .mesh import make_mesh
        _run_all(lambda shape: make_mesh(shape=shape, kind="local",
                                         device=args.device), n,
                 torch.float32, lambda ln: print(ln, flush=True))
    else:
        if args.device == "cuda" and n > torch.cuda.device_count():
            raise RuntimeError(f"{n} NCCL ranks on "
                               f"{torch.cuda.device_count()} card(s): NCCL "
                               "takes one rank a card; use --in-process")
        run_ranks(n, args.device, timeout_s=args.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
