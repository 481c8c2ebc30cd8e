"""Non-interactive CLI of the port: ``python -m openlbmpm_torch run <ini>``.

The same subcommands, flags and outputs as ``openlbmpm_tpu/cli.py`` for
every model family, plus ``--device`` (the JAX CLI's ``bench`` subcommand is
not ported):

  run        run a simulation from a legacy-dialect INI file
  inspect    parse a config and print the resolved typed parameters

``--model cg`` steps ``ColorGradientRK.step`` on the split (f_r, f_b) state
of a CSF or Perturbation INI (on a card, the split CSF kernel K6 or the
split Perturbation kernel K4s; the plain step for the averaged convective
outlet and the modified periodic seam, as the JAX package; the run prints
which); ``--model cg3d`` runs the D3Q19 CSF
model of an RKtwophasesetup3D.ini in a box with walls on the x and y faces:
on a card it packs the state and steps ``ColorGradientRK3D.step_c`` (the
compressed kernel), as the JAX CLI does on its accelerator, on the CPU the
split plain step, as the JAX CLI does off it (the checkpoint fingerprint
carries the layout, "packed" or "split"); ``--model transport`` steps the split
``TransportRK.step`` (the split coupled kernels), or on a card with
temporal blocking the packed (s, g) state; ``--model transport3d``
runs the coupled D3Q19 flow + D3Q7 tracer model of a transport INI and a
3-D flow INI (``--physics-config``): on a card it packs the state and steps
``TransportRK3D.step_c`` (the coupled kernel), on the CPU the split plain
step, as the JAX CLI does on and off its accelerator; ``--model sc`` steps
``ShanChenMCMP.step`` on the (K, 9, ny, nx) state of a twophasesetup.ini
and its physics INI (on a card, the Shan-Chen kernel, or the plain step
for the configurations the JAX package also keeps off its kernel; the run
prints which); ``--model basic`` steps ``SinglePhaseD2Q9.step`` on the
(9, ny, nx) state of a basicsetup.ini (on a card, K7), ``--model basic3d``
``SinglePhaseD3Q19.step`` in a box with walls on the x and y faces (K11),
and ``--model sc3d`` ``ShanChenMCMP3D.step`` on a droplet in that box
(K10); each prints the step it takes.  ``cg``, ``sc``, ``basic``,
``transport``, ``sc3d`` and ``basic3d`` advance T steps a launch on a card
(temporal blocking, ``--block``: the T-step kernels K3, K8-T, K7-T, K5c-T,
K10-T and K11-T through ``make_block_step``), as the JAX CLI does on its
accelerator; the run prints T.  Results, metrics and
checkpoints are written as the JAX CLI writes them, so a checkpoint of either package
resumes in the other.

``--device cuda`` (the default) runs on the first card and raises when
there is none; it never falls back to the CPU.  ``--device cpu`` runs the
plain PyTorch path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

MODELS = ("cg", "cg3d", "sc", "sc3d", "transport", "transport3d", "basic",
          "basic3d")


def _build_geometry(domain, geometry_kind: str = "box"):
    from . import geometry as geo
    if domain.use_image and domain.image_path:
        solid = geo.load_structure_image(domain.image_path)
        if domain.duplicate != (1, 1):
            solid = geo.duplicate_domain(solid, *domain.duplicate)
        if domain.buffer_layers:
            solid = geo.add_buffer_layers(solid, domain.buffer_layers)
        return geo.from_solid_mask(solid)
    if geometry_kind == "channel":
        return geo.open_channel(domain.nx, domain.ny)
    g = geo.box_with_walls(domain.nx, domain.ny)
    if domain.buffer_layers:
        return geo.from_solid_mask(
            geo.add_buffer_layers(g.is_solid, domain.buffer_layers,
                                  seal_sides=True))
    return g


def _setup(args):
    """(torch dtype, torch device) of the run; raises for a CUDA device
    without a card."""
    import torch

    from ._device import resolve_device
    dev = resolve_device(args.device)
    return (torch.float64 if args.dtype == "f64" else torch.float32), dev


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _note_block(args):
    # a run that goes unblocked although --block asked for more than one
    # step a launch: cg3d and transport3d (the JAX CLI blocks neither), or
    # no T-step kernel for this configuration of cg, sc, basic, transport,
    # sc3d or basic3d; the JAX CLI's note
    if args.block > 1:
        print("note: --block unsupported for this config; running unblocked")


def _blocks_on(model) -> bool:
    """Whether runs of `model` take T steps a launch: on a card."""
    return model.device.type == "cuda"


def _pick_block(model, args, io_interval, num_steps, **kw):
    """Resolve --block into (blocked step | None, step scale), as the JAX
    CLI's ``_pick_block``.

    ``--block N`` requests exactly N; 0 (the default) tries 4, then 2;
    ``--block 1`` and CPU runs stay unblocked (the JAX CLI blocks only on
    its accelerator), and so do ``--no-pallas`` runs, whose models
    (``use_kernel=False``) have no T-step form.  T must divide both the I/O interval and the step
    count, so callbacks land on true step boundaries; an explicit
    non-divisor runs unblocked with a note.  Extra keywords go to
    ``make_block_step``."""
    if args.block == 1 or not _blocks_on(model):
        return None, 1
    cands = [args.block] if args.block > 1 else [4, 2]
    for t in cands:
        if io_interval % t or num_steps % t:
            if args.block > 1:
                print(f"note: --block {t} does not divide the I/O "
                      f"interval ({io_interval}) and step count "
                      f"({num_steps}); running unblocked")
            continue
        blk = model.make_block_step(steps_per_call=t, **kw)
        if blk is not None:
            return blk, t
    return None, 1


def _blocked(model, args, run):
    """The step function and step scale of a run: the T-step kernel when
    ``_pick_block`` finds one, else ``model.step`` (with the JAX note for
    an explicit --block)."""
    blk, scale = _pick_block(model, args, run.io_interval, run.num_steps)
    if blk is not None:
        return blk, scale
    _note_block(args)
    return model.step, 1


def _steps_line(scale):
    return f"{scale} steps a launch" if scale > 1 else "one step a launch"


def _run_colorgradient(args):
    from .checkpoint import (config_fingerprint, di_cycle_swap,
                             load_checkpoint, save_checkpoint)
    from .config import load_colorgradient
    from .io import ResultWriter, save_png_field
    from .metrics import MetricsLogger, flow_diagnostics, steady_state_criterion
    from .models.base import run_chunked
    from .models.colorgradient import ColorGradientRK

    params, bcs, domain, run = load_colorgradient(args.config)
    if args.steps:
        run = dataclasses.replace(run, num_steps=args.steps)
    geometry = _build_geometry(domain)
    dtype, dev = _setup(args)
    model = ColorGradientRK(geometry, params, bcs, dtype=dtype, device=dev,
                            use_kernel=not args.no_pallas)
    step_fn, scale = _blocked(model, args, run)
    print(f"openlbmpm_torch: --model cg, variant {params.variant}, "
          f"boundaries {bcs.inlet}/{bcs.outlet}: the {model.path} step on "
          f"{dev}, split state, {_steps_line(scale)}")
    state = model.init_state_layers(
        1.0, 1.0, invading_rows=max(domain.buffer_layers, 10))
    fingerprint = config_fingerprint(params)
    start_step = 0
    ckpt_path = os.path.join(args.output, "checkpoint.npz")
    if args.resume and os.path.exists(ckpt_path):
        state, start_step = load_checkpoint(ckpt_path, state, fingerprint)
        print(f"resumed from step {start_step}")
        if run.is_cycle:
            state = di_cycle_swap(*state,
                                  buffer_rows=max(domain.buffer_layers, 10))
            print("D-I cycle: fluids swapped in the buffer layers")

    writer = ResultWriter(args.output, basename="SimulationResultsRK")
    logger = MetricsLogger(os.path.join(args.output, "metrics.jsonl"),
                           geometry.num_fluid_nodes, echo=True)
    ckpt_every = max(1, 10 * run.io_interval)
    prev_u = {"u": None}

    def callback(step, s):
        step = step * scale
        f_r, f_b = s
        rho_r, rho_b, phi, (ux, uy) = model.macro(s)
        writer.write_rk(start_step + step, _host(rho_r), _host(rho_b),
                        _host(ux), _host(uy), f_r=_host(f_r), f_b=_host(f_b))
        if args.png:
            save_png_field(
                os.path.join(args.output,
                             f"phi_{start_step + step:08d}.png"),
                _host(phi), title=f"phi @ {start_step + step}")
        d = flow_diagnostics(rho_r, rho_b, ux, uy, geometry.is_fluid)
        if prev_u["u"] is not None and step > 0:
            d["steady_criterion"] = steady_state_criterion(
                ux, uy, *prev_u["u"])
        prev_u["u"] = (ux, uy)
        rec = logger.log(start_step + step, **d)
        if step % ckpt_every == 0 or step >= run.num_steps:
            save_checkpoint(ckpt_path, s, start_step + step, fingerprint)
        if args.stop_at_breakthrough and d["breakthrough"]:
            print(f"breakthrough at step {rec['step']}")
            return True
        if args.stop_at_steady and d.get("steady_criterion") is not None \
                and d["steady_criterion"] < args.stop_at_steady:
            print(f"steady state at step {rec['step']} "
                  f"(criterion {d['steady_criterion']:.2e})")
            return True
        return False

    run_chunked(step_fn, state, num_steps=max(1, run.num_steps // scale),
                io_interval=max(1, run.io_interval // scale),
                callback=callback, nan_guard=True, profile_dir=args.profile)
    logger.close()
    return 0


def _box3d(dom):
    """3-D box geometry: solid walls on the x and y faces, open z."""
    from . import geometry as geo
    solid = np.zeros((dom["nz"], dom["ny"], dom["nx"]), bool)
    solid[:, :, 0] = solid[:, :, -1] = True
    solid[:, 0, :] = solid[:, -1, :] = True
    return geo.from_solid_mask(solid)


def _run_colorgradient3d(args):
    from .checkpoint import (config_fingerprint, load_checkpoint,
                             save_checkpoint)
    from .config import load_colorgradient3d
    from .io import ResultWriter
    from .metrics import MetricsLogger, flow_diagnostics
    from .models.base import run_chunked
    from .models.flow3d import ColorGradientRK3D

    params, dom, run, extras = load_colorgradient3d(args.config)
    if args.steps:
        run = dataclasses.replace(run, num_steps=args.steps)
    geometry = _box3d(dom)
    dtype, dev = _setup(args)
    model = ColorGradientRK3D(geometry, params, boundaries=extras["bcs"],
                              dtype=dtype, device=dev,
                              use_kernel=not args.no_pallas)
    state = model.init_state_layers(extras["rho_r"], extras["rho_b"],
                                    invading_slabs=max(8, dom["nz"] // 10))
    step_fn, macro_fn, layout = model.step, model.macro, "split"
    if model.path == "kernel":
        state = model.pack_state(*state)
        step_fn, macro_fn, layout = (model.step_c, model.macro_compressed,
                                     "packed")
    print(f"openlbmpm_torch: --model cg3d, boundaries {model.bcs.inlet}/"
          f"{model.bcs.outlet}: the {model.path} step on {dev}, "
          f"{layout} state")
    _note_block(args)
    writer = ResultWriter(args.output, basename="SimulationResultsRK3D")
    logger = MetricsLogger(os.path.join(args.output, "metrics.jsonl"),
                           geometry.num_fluid_nodes, echo=True)
    # the layout rides in the fingerprint, so a packed checkpoint does not
    # resume into a split run or the other way round
    fingerprint = config_fingerprint(
        {"params": dataclasses.asdict(params), "state_layout": layout})
    start_step = 0
    ckpt_path = os.path.join(args.output, "checkpoint.npz")
    if args.resume and os.path.exists(ckpt_path):
        state, start_step = load_checkpoint(ckpt_path, state, fingerprint)
        print(f"resumed from step {start_step}")
    ckpt_every = max(1, 10 * run.io_interval)
    fl2 = geometry.is_fluid.reshape(geometry.shape[0], -1)

    def callback(step, s):
        step = start_step + step
        rho_r, rho_b, _, u = macro_fn(s)
        writer.write(step, {
            f"FluidMacro/FluidDensityRin{step}": _host(rho_r),
            f"FluidMacro/FluidDensityBin{step}": _host(rho_b),
        })
        # the front along -z: the slabs as rows
        nz = rho_r.shape[0]
        logger.log(step, **flow_diagnostics(
            rho_r.reshape(nz, -1), rho_b.reshape(nz, -1),
            u[0].reshape(nz, -1), u[2].reshape(nz, -1), fl2))
        if (step - start_step) % ckpt_every == 0 or \
                step - start_step >= run.num_steps:
            save_checkpoint(ckpt_path, s, step, fingerprint)
        return False

    run_chunked(step_fn, state, num_steps=run.num_steps,
                io_interval=run.io_interval, callback=callback,
                nan_guard=True, profile_dir=args.profile)
    logger.close()
    return 0


def _run_transport(args):
    from .config import load_colorgradient, load_transport
    from .io import ResultWriter
    from .metrics import MetricsLogger
    from .models.base import run_chunked
    from .models.transport import TransportRK

    tparams = load_transport(args.config)
    flow_params, bcs, domain, run = load_colorgradient(
        args.physics_config or args.config)
    if args.steps:
        run = dataclasses.replace(run, num_steps=args.steps)
    geometry = _build_geometry(domain)
    dtype, dev = _setup(args)
    model = TransportRK(geometry, flow_params, tparams, bcs, dtype=dtype,
                        device=dev, use_kernel=not args.no_pallas)
    flow_state = model.flow.init_state_layers(
        1.0, 1.0, invading_rows=max(domain.buffer_layers, 10))
    ny, nx = geometry.shape
    conc0 = np.zeros((tparams.num_tracers, ny, nx))
    state = model.init_state(flow_state, conc0)
    writer = ResultWriter(args.output, basename="ConcentrationResults")
    logger = MetricsLogger(os.path.join(args.output, "metrics.jsonl"),
                           geometry.num_fluid_nodes, echo=True)
    # the compressed coupled T-step kernel, (s, g) -> (s', g'), as the JAX
    # CLI blocks (None with conserve_mass or redistribute)
    blk, scale = _pick_block(model, args, run.io_interval, run.num_steps,
                             compressed=True)
    if blk is not None:
        state = model.pack(state)
        step_fn, layout, get_g = blk, "compressed", lambda st: st[1]
    else:
        _note_block(args)
        step_fn, layout, get_g = model.step, "split", lambda st: st.g
    print(f"openlbmpm_torch: --model transport, interface "
          f"{tparams.interface_mode}: the {model.flow.path} step on {dev}, "
          f"{layout} state, {_steps_line(scale)}")

    def callback(step, s):
        step = step * scale
        conc = model.concentration(get_g(s))
        writer.write_transport(step, _host(conc))
        masses = {f"tracer{i}_mass": float(conc[i].sum())
                  for i in range(conc.shape[0])}
        logger.log(step, **masses)
        return False

    run_chunked(step_fn, state, num_steps=max(1, run.num_steps // scale),
                io_interval=max(1, run.io_interval // scale),
                callback=callback, profile_dir=args.profile)
    logger.close()
    return 0


def _run_transport3d(args):
    """The transport INI's tracers (bounce-back interface when its
    BetaInterface is 0) in the 3-D flow INI's box, red and the tracers at 1
    in the top max(8, nz // 10) slabs."""
    from .config import load_colorgradient3d, load_transport
    from .io import ResultWriter
    from .metrics import MetricsLogger
    from .models.base import run_chunked
    from .models.flow3d import TransportRK3D

    tparams = load_transport(args.config)
    flow_params, dom, run, extras = load_colorgradient3d(
        args.physics_config or args.config)
    geometry = _box3d(dom)
    dtype, dev = _setup(args)
    model = TransportRK3D(
        geometry, flow_params, num_tracers=tparams.num_tracers,
        tau=tparams.tau, j0=tparams.j0,
        interface_mode=("bounceback"
                        if tparams.beta_interface[0] == 0.0 else "none"),
        boundaries=extras["bcs"], dtype=dtype, device=dev,
        use_kernel=not args.no_pallas)
    top = max(8, dom["nz"] // 10)
    nz, ny, nx = geometry.shape
    conc0 = np.zeros((tparams.num_tracers, nz, ny, nx))
    conc0[:, nz - top:] = 1.0
    state = model.init_state(model.flow.init_state_layers(
        extras["rho_r"], extras["rho_b"], invading_slabs=top), conc0)
    if args.steps:
        run = dataclasses.replace(run, num_steps=args.steps)
    step_fn, layout = model.step, "split"
    if model.path == "kernel":
        state = model.pack(state)
        step_fn, layout = model.step_c, "packed"
    bcs = model.flow.bcs
    print(f"openlbmpm_torch: --model transport3d, boundaries {bcs.inlet}/"
          f"{bcs.outlet}, interface {model.transport.interface_mode}: the "
          f"{model.path} step on {dev}, {layout} state")
    _note_block(args)
    writer = ResultWriter(args.output, basename="ConcentrationResults3D")
    logger = MetricsLogger(os.path.join(args.output, "metrics.jsonl"),
                           model.geo.num_fluid_nodes, echo=True)

    def callback(step, s):
        conc = model.concentration(s[-1])
        writer.write_transport(step, _host(conc))
        logger.log(step, **{f"tracer{i}_mass": float(conc[i].sum())
                            for i in range(conc.shape[0])})
        return False

    run_chunked(step_fn, state, num_steps=run.num_steps,
                io_interval=run.io_interval, callback=callback,
                profile_dir=args.profile)
    logger.close()
    return 0


def _shanchen_setup(config, physics_config, dtype, device, use_kernel=True):
    """The model, initial state and run settings of ``run --model sc``:
    the open channel of the main INI with the physics INI's fluids and
    boundary rows, fluid 0 invading from the top."""
    from .config import load_shanchen
    from .models.shanchen import ShanChenMCMP

    params, bcs, domain, run, extras = load_shanchen(config, physics_config)
    geometry = _build_geometry(domain, geometry_kind="channel")
    model = ShanChenMCMP(geometry, params, bcs, dtype=dtype, device=device,
                         use_kernel=use_kernel)
    state = model.init_state_layers(
        extras.get("initial_densities", (1.0, 1.0)),
        extras.get("background_densities", (0.02, 0.02)))
    return model, state, run


def _run_shanchen(args):
    from .checkpoint import (config_fingerprint, di_cycle_swap_sc,
                             load_checkpoint, save_checkpoint)
    from .io import ResultWriter
    from .metrics import MetricsLogger, flow_diagnostics
    from .models.base import run_chunked

    dtype, dev = _setup(args)
    model, state, run = _shanchen_setup(args.config, args.physics_config,
                                        dtype, dev, not args.no_pallas)
    if args.steps:
        run = dataclasses.replace(run, num_steps=args.steps)
    params, bcs, geometry = model.p, model.bcs, model.geo
    step_fn, scale = _blocked(model, args, run)
    print(f"openlbmpm_torch: --model sc, scheme {params.scheme}, "
          f"{params.collision}, forcing {params.forcing}, boundaries "
          f"{bcs.inlet}/{bcs.outlet}: the {model.path} step on {dev}, "
          f"{_steps_line(scale)}")
    fingerprint = config_fingerprint(params)
    start_step = 0
    ckpt_path = os.path.join(args.output, "checkpoint.npz")
    if args.resume and os.path.exists(ckpt_path):
        state, start_step = load_checkpoint(ckpt_path, state, fingerprint)
        print(f"resumed from step {start_step}")
        if run.is_cycle:
            state = di_cycle_swap_sc(state, buffer_rows=10)
            print("D-I cycle: fluids swapped in the buffer layers")
    writer = ResultWriter(args.output, basename="SimulationResults")
    logger = MetricsLogger(os.path.join(args.output, "metrics.jsonl"),
                           geometry.num_fluid_nodes, echo=True)
    ckpt_every = max(1, 10 * run.io_interval)

    def callback(step, f):
        step = step * scale
        rho_k, (ux, uy) = model.macro(f)
        writer.write_sc(start_step + step, _host(rho_k), _host(ux), _host(uy))
        logger.log(start_step + step,
                   **flow_diagnostics(rho_k[0], rho_k[1], ux, uy,
                                      geometry.is_fluid))
        if step % ckpt_every == 0 or step >= run.num_steps:
            save_checkpoint(ckpt_path, f, start_step + step, fingerprint)
        return False

    run_chunked(step_fn, state, num_steps=max(1, run.num_steps // scale),
                io_interval=max(1, run.io_interval // scale),
                callback=callback, nan_guard=True, profile_dir=args.profile)
    logger.close()
    return 0


def _run_checkpointed(args, model, state, run, fingerprint, basename,
                      record, stepper):
    """The run loop of the single-phase and 3-D Shan-Chen families: resume,
    then every I/O step the result datasets and metrics of ``record(step,
    f) -> (datasets, metrics)`` and, every ten outputs and at the end, a
    checkpoint.  ``stepper``: (step function, steps a call) from
    ``_blocked``."""
    from .checkpoint import load_checkpoint, save_checkpoint
    from .io import ResultWriter
    from .metrics import MetricsLogger
    from .models.base import run_chunked
    start_step = 0
    ckpt_path = os.path.join(args.output, "checkpoint.npz")
    if args.resume and os.path.exists(ckpt_path):
        state, start_step = load_checkpoint(ckpt_path, state, fingerprint)
        print(f"resumed from step {start_step}")
    step_fn, scale = stepper
    writer = ResultWriter(args.output, basename=basename)
    logger = MetricsLogger(os.path.join(args.output, "metrics.jsonl"),
                           model.geo.num_fluid_nodes, echo=True)
    ckpt_every = max(1, 10 * run.io_interval)

    def callback(step, f):
        step = step * scale
        datasets, scalars = record(start_step + step, f)
        writer.write(start_step + step, datasets)
        logger.log(start_step + step, **scalars)
        if step % ckpt_every == 0 or step >= run.num_steps:
            save_checkpoint(ckpt_path, f, start_step + step, fingerprint)
        return False

    run_chunked(step_fn, state, num_steps=max(1, run.num_steps // scale),
                io_interval=max(1, run.io_interval // scale),
                callback=callback, nan_guard=True, profile_dir=args.profile)
    logger.close()
    return 0


def _speed(u):
    """|u| from its components."""
    acc = u[0] * u[0]
    for c in u[1:]:
        acc = acc + c * c
    return acc.sqrt()


def _mass_umax(rho, u) -> dict:
    return {"mass": float(rho.sum()), "umax": float(_speed(u).max())}


def _run_basic(args):
    """The single-phase D2Q9 channel of a basicsetup.ini: solid outside its
    FlowDomain extents, periodic rows, started at its initial velocity."""
    from . import geometry as geo
    from .checkpoint import config_fingerprint
    from .config import load_basic
    from .io import save_png_field
    from .models.single_phase import SinglePhaseD2Q9

    solver_kw, u0, (xext, yext), dom, run = load_basic(args.config)
    if args.steps:
        run = dataclasses.replace(run, num_steps=args.steps)
    solid = np.ones((dom.ny, dom.nx), bool)
    solid[yext[0]:yext[1] + 1, xext[0]:xext[1] + 1] = False
    dtype, dev = _setup(args)
    model = SinglePhaseD2Q9(geo.from_solid_mask(solid), dtype=dtype,
                            device=dev, use_kernel=not args.no_pallas,
                            **solver_kw)
    stepper = _blocked(model, args, run)
    print(f"openlbmpm_torch: --model basic, {model.collision}: the "
          f"{model.path} step on {dev}, {_steps_line(stepper[1])}")

    def record(step, f):
        rho, (ux, uy) = model.macro(f)
        if args.png:
            save_png_field(os.path.join(args.output, f"u_{step:08d}.png"),
                           _host(_speed((ux, uy))), title=f"|u| @ {step}")
        return ({f"FluidMacro/FluidDensityin{step}": _host(rho),
                 f"FluidVelocity/FluidVelocityXin{step}": _host(ux),
                 f"FluidVelocity/FluidVelocityYin{step}": _host(uy)},
                _mass_umax(rho, (ux, uy)))

    return _run_checkpointed(args, model, model.init_state(1.0, u0), run,
                             config_fingerprint(solver_kw),
                             "SimulationResults", record, stepper)


def _run_basic3d(args):
    """The D3Q19 single-phase flow of a basic3d.ini in a box with walls on
    the x and y faces, driven along z by its body force."""
    from .checkpoint import config_fingerprint
    from .config import load_basic3d
    from .models.flow3d import SinglePhaseD3Q19

    solver_kw, dom, run = load_basic3d(args.config)
    if args.steps:
        run = dataclasses.replace(run, num_steps=args.steps)
    dtype, dev = _setup(args)
    model = SinglePhaseD3Q19(_box3d(dom), dtype=dtype, device=dev,
                             use_kernel=not args.no_pallas, **solver_kw)
    stepper = _blocked(model, args, run)
    print(f"openlbmpm_torch: --model basic3d, {model.collision}: the "
          f"{model.path} step on {dev}, {_steps_line(stepper[1])}")

    def record(step, f):
        rho, u = model.macro(f)
        return ({f"FluidMacro/FluidDensityin{step}": _host(rho)},
                _mass_umax(rho, u))

    return _run_checkpointed(args, model, model.init_state(1.0), run,
                             config_fingerprint(solver_kw),
                             "SimulationResults3D", record, stepper)


def _shanchen3d_setup(config, dtype, device, use_kernel=True):
    """The model, initial state and run settings of ``run --model sc3d``:
    the INI's fluids in a box with walls on the x and y faces, fluid 0 a
    centred sphere of the INI's radius."""
    from .config import load_shanchen3d
    from .models.flow3d import ShanChenMCMP3D

    params, dom, run, extras = load_shanchen3d(config)
    model = ShanChenMCMP3D(_box3d(dom), params, dtype=dtype, device=device,
                           use_kernel=use_kernel)
    state = model.init_state_droplet(extras["initial_densities"],
                                     extras["background_densities"],
                                     radius=extras["radius"])
    return model, state, run


def _run_shanchen3d(args):
    from .checkpoint import config_fingerprint
    from .metrics import flow_diagnostics

    dtype, dev = _setup(args)
    model, state, run = _shanchen3d_setup(args.config, dtype, dev,
                                          not args.no_pallas)
    if args.steps:
        run = dataclasses.replace(run, num_steps=args.steps)
    stepper = _blocked(model, args, run)
    print(f"openlbmpm_torch: --model sc3d, {model.k} fluids: the "
          f"{model.path} step on {dev}, {_steps_line(stepper[1])}")
    fl2 = model.geo.is_fluid.reshape(model.geo.shape[0], -1)

    def record(step, f):
        rho_k, u = model.macro(f)
        nz = rho_k.shape[1]
        # the slabs as rows, as the JAX CLI reports them
        return ({f"FluidMacro/FluidDensity{k}in{step}": _host(rho_k[k])
                 for k in range(model.k)},
                flow_diagnostics(rho_k[0].reshape(nz, -1),
                                 rho_k[1].reshape(nz, -1),
                                 u[0].reshape(nz, -1), u[2].reshape(nz, -1),
                                 fl2))

    return _run_checkpointed(args, model, state, run,
                             config_fingerprint(model.p),
                             "SimulationResultsSC3D", record, stepper)


def _inspect(args):
    from .config import (load_basic, load_basic3d, load_colorgradient,
                         load_colorgradient3d, load_shanchen,
                         load_shanchen3d, load_transport)
    loaders = {"cg": lambda: load_colorgradient(args.config)[:2],
               "cg3d": lambda: (load_colorgradient3d(args.config)[0],),
               "sc": lambda: load_shanchen(args.config,
                                           args.physics_config)[:2],
               "sc3d": lambda: (load_shanchen3d(args.config)[0],),
               "transport": lambda: (load_transport(args.config),),
               "transport3d": lambda: (load_transport(args.config),),
               "basic": lambda: (load_basic(args.config)[0],),
               "basic3d": lambda: (load_basic3d(args.config)[0],)}
    for obj in loaders[args.model]():
        if dataclasses.is_dataclass(obj):
            obj = dataclasses.asdict(obj)
        print(json.dumps(obj, default=str, indent=2))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="openlbmpm-torch",
        description="Multicomponent/multiphase LBM for porous media, "
                    "PyTorch/CUDA port")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("config", help="legacy-dialect INI file")
        sp.add_argument("--model", choices=MODELS, default="cg",
                        help="model family")
        sp.add_argument("--physics-config", default=None,
                        help="secondary INI (SC physics / transport flow)")
        sp.add_argument("--steps", type=int, default=0,
                        help="override step count")
        sp.add_argument("--output", default="results")
        sp.add_argument("--dtype", choices=("f32", "f64"), default="f32")
        sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda: the hand-written kernels on the first "
                             "card (raises without one); cpu: the plain "
                             "PyTorch path")
        sp.add_argument("--png", action="store_true",
                        help="write PNG snapshots at the I/O cadence")
        sp.add_argument("--no-pallas", action="store_true",
                        help="run every model's plain PyTorch step, no "
                             "kernel (the JAX CLI's flag of the same name; "
                             "unblocked; cg3d and transport3d step the "
                             "split state)")
        sp.add_argument("--block", type=int, default=0,
                        help="time steps per kernel launch (temporal "
                             "blocking) of cg, sc, basic, transport, sc3d "
                             "and basic3d on the card: N runs exactly N, 0 "
                             "(default) tries 4 then 2, 1 runs unblocked; N "
                             "must divide the I/O interval and the step "
                             "count, or the run goes unblocked with a note.  "
                             "CPU runs, cg3d and transport3d run unblocked")
        sp.add_argument("--resume", action="store_true",
                        help="resume from <output>/checkpoint.npz")
        sp.add_argument("--stop-at-breakthrough", action="store_true")
        sp.add_argument("--stop-at-steady", type=float, default=0.0,
                        help="stop when the relative L2 velocity change "
                             "between outputs drops below this tolerance")
        sp.add_argument("--profile", default=None, metavar="DIR",
                        help="capture a torch.profiler trace of the second "
                             "chunk into DIR/trace.json")

    runp = sub.add_parser("run", help="run a simulation")
    common(runp)
    insp = sub.add_parser("inspect", help="print resolved parameters")
    common(insp)

    args = p.parse_args(argv)
    if args.cmd == "inspect":
        return _inspect(args)
    os.makedirs(args.output, exist_ok=True)
    return {"cg": _run_colorgradient, "cg3d": _run_colorgradient3d,
            "sc": _run_shanchen, "sc3d": _run_shanchen3d,
            "transport": _run_transport, "transport3d": _run_transport3d,
            "basic": _run_basic, "basic3d": _run_basic3d}[args.model](args)


if __name__ == "__main__":
    sys.exit(main())
