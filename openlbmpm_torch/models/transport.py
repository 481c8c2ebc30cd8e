"""Coupled CSF flow + phase-confined tracer transport (counterpart of
``openlbmpm_tpu/models/transport.py``), on two state layouts:

* split: ``TransportState(f_r, f_b, g, mass0)`` -- ``step``, the JAX
  model's ``_step_impl``, with the ``conserve_mass`` and ``redistribute``
  repairs and ``standalone`` transport (fixed flow fields);
* compressed: ``(s, g)`` with ``s`` the compressed flow state of
  ``ColorGradientRK`` (10 planes, or 11 bfloat16 planes with
  ``storage="bf16"``) -- ``step_c``.

``make_block_step`` gives the step of T time steps a call (the JAX
``make_block_step``): on a card one launch of K5c-T (``build.split_steps``'s
launches above a launch's limit), on the CPU T plain steps.

``g`` (T, Q, ny, nx) holds the tracer PDFs in the arithmetic type (float32
with bf16 flow storage).  As in ``_step_impl``, the tracer sub-step sees the
flow fields *before* the flow's boundary rows; then the flow takes its own
step.  On a CUDA state a step is one call of the hand-written kernel set
(``kernels/transport.py``); on the CPU it is the plain composition of
``ops/``.

Not yet ported (NotImplementedError): tracer inlet and outlet rows on D2Q9
(the JAX Pallas kernels take none either); a Perturbation flow, and the
flow boundaries neumann_per_color, convective_average and
modified_periodic (the coupled kernels are CSF-only; the JAX package runs
these couplings on its jnp path).
"""

from __future__ import annotations

import dataclasses
from typing import Literal, NamedTuple

import numpy as np
import torch
from torch import nn

from ..kernels.transport import (coupled_block_compressed, coupled_block_split,
                                  coupled_step_compressed, coupled_step_split,
                                  tracer_kernel_params, tracer_table)
from ..lattice import D2Q5, D2Q9
from ..ops import equilibrium as eq
from ..ops import macroscopic as mac
from ..ops import transport as tr
from ..ops.streaming import stream, upwind_solid_masks
from .base import block_args, t_step
from .colorgradient import (BLOCK_INLETS, BLOCK_OUTLETS, CGBoundaryConfig,
                            ColorGradientParams, ColorGradientRK)

__all__ = ["TransportParams", "TransportState", "TransportRK"]


class TransportState(NamedTuple):
    f_r: torch.Tensor
    f_b: torch.Tensor
    g: torch.Tensor          # tracer PDFs (T, Q, ny, nx)
    mass0: torch.Tensor      # (T,) initial tracer mass


@dataclasses.dataclass(frozen=True)
class TransportParams:
    """Same fields and defaults as the JAX package's TransportParams.
    Per-tracer tuples hold one value for every tracer or one per tracer."""
    num_tracers: int = 1
    scheme: int = 5                       # 5 (D2Q5) | 9 (D2Q9)
    tau: tuple = (1.0,)                   # per-tracer relaxation times
    j0: tuple = (0.25,)                   # J-scheme rest coefficients (D2Q5)
    relaxation: Literal["SRT", "MRT"] = "SRT"
    mrt_equilibrium: Literal["linear", "quadratic"] = "linear"
    # anisotropic diffusion tensor per tracer (MRT only)
    diff_x: tuple = (0.1,)
    diff_y: tuple = (0.1,)
    diff_xy: tuple = (0.0,)
    diff_yx: tuple = (0.0,)
    beta_interface: tuple = (0.0,)        # partition coefficient per tracer
    interface_mode: Literal["permeable", "bounceback", "redistribute",
                            "none"] = "permeable"
    reaction_rate: float = 0.0            # bilinear A + B -> C rate
    reaction_stoich: tuple = (-1.0, -1.0, 1.0)
    criteria: float = 0.5                 # rho_R threshold of the host phase
    inlet: Literal["none", "inamuro", "anti_bounce_back", "zero"] = "none"
    inlet_conc: tuple = (1.0,)
    outlet: Literal["none", "freeflow"] = "none"
    conserve_mass: bool = False           # renormalization repair op


def _per_tracer(values, nt: int, name: str) -> tuple:
    """`values` as one float per tracer (a single value is shared)."""
    v = tuple(float(x) for x in np.atleast_1d(np.asarray(values, np.float64)))
    if len(v) == 1:
        return v * nt
    if len(v) != nt:
        raise ValueError(f"{name}: {len(v)} values for {nt} tracers")
    return v


def _check_options(tp: TransportParams):
    if tp.interface_mode not in ("none", "permeable", "bounceback",
                                 "redistribute"):
        raise ValueError(f"interface_mode {tp.interface_mode!r}")
    if tp.scheme not in (5, 9) or tp.relaxation not in ("SRT", "MRT") or \
            tp.mrt_equilibrium not in ("linear", "quadratic"):
        raise ValueError("scheme 5 | 9, relaxation SRT | MRT, "
                         "mrt_equilibrium linear | quadratic")
    if tp.inlet not in ("none", "inamuro", "anti_bounce_back", "zero") or \
            tp.outlet not in ("none", "freeflow"):
        raise ValueError(f"tracer inlet {tp.inlet!r}, outlet {tp.outlet!r}")
    if tp.scheme == 9 and (tp.inlet != "none" or tp.outlet != "none"):
        raise NotImplementedError("D2Q9 tracers take no inlet or outlet rows")
    if tp.reaction_rate and tp.num_tracers < 2:
        raise ValueError("the bilinear reaction needs two tracers or more")


class TransportRK(nn.Module):
    """Coupled CSF flow + phase-confined tracer transport.

    ``flow`` is the ``ColorGradientRK`` of the flow half (``dtype``,
    ``device`` and ``storage`` as there).  With ``standalone`` the flow
    fields stay fixed and only the tracers advance.  The tracer's
    upwind-solid masks and its per-tracer table
    (``kernels/transport.py::tracer_table``) are buffers on ``device``.
    ``use_kernel=False`` (the JAX ``use_pallas=False``) runs the plain
    steps on every device.
    """

    def __init__(self, geometry, flow_params=ColorGradientParams(),
                 transport_params=TransportParams(),
                 boundaries=CGBoundaryConfig(), standalone: bool = False,
                 dtype=torch.float32, device="cuda", storage: str = "f32",
                 use_kernel: bool = True):
        super().__init__()
        tp = transport_params
        _check_options(tp)
        if flow_params.variant != "CSF":
            raise NotImplementedError(
                f"coupled transport on a {flow_params.variant} flow: the "
                "coupled kernels take the CSF flow step only")
        if boundaries.inlet == "neumann_per_color" or \
                boundaries.outlet in ("convective_average",
                                      "modified_periodic"):
            raise NotImplementedError(
                f"coupled transport with the {boundaries.inlet} inlet and "
                f"the {boundaries.outlet} outlet")
        self.flow = ColorGradientRK(geometry, flow_params, boundaries,
                                    dtype=dtype, device=device,
                                    storage=storage, use_kernel=use_kernel)
        self.geo = geometry
        self.tp = tp
        self.standalone = bool(standalone)
        self.dtype = self.flow.dtype
        self.lat_tr = D2Q5 if tp.scheme == 5 else D2Q9
        nt = tp.num_tracers
        self.tau_tr = _per_tracer(tp.tau, nt, "tau")
        self.beta = _per_tracer(tp.beta_interface, nt, "beta_interface")
        self.inlet_conc = _per_tracer(tp.inlet_conc, nt, "inlet_conc")
        self.stoich = _per_tracer(tp.reaction_stoich, nt, "reaction_stoich") \
            if tp.reaction_rate else (0.0,) * nt
        self.j_coeffs = tr.j_coefficients(_per_tracer(tp.j0, nt, "j0"))
        self.mrt_update = None
        if tp.relaxation == "MRT":
            build = tr.mrt_matrices_d2q5 if tp.scheme == 5 \
                else tr.mrt_matrices_d2q9
            self.mrt_update = build(
                *(_per_tracer(v, nt, n) for v, n in (
                    (tp.diff_x, "diff_x"), (tp.diff_y, "diff_y"),
                    (tp.diff_xy, "diff_xy"), (tp.diff_yx, "diff_yx"))))
        dev = self.flow.device
        self.register_buffer("upwind_solid_tr", torch.as_tensor(
            upwind_solid_masks(self.lat_tr, geometry.is_solid), device=dev))
        self.register_buffer("tracer_table", torch.as_tensor(
            tracer_table(self), dtype=self.dtype, device=dev))
        self.tracer_params = tracer_kernel_params(tp, self.standalone)

    @property
    def device(self) -> torch.device:
        return self.flow.device

    # -- state -----------------------------------------------------------------
    def init_state(self, flow_state, conc0) -> TransportState:
        """conc0: (T, ny, nx) initial concentrations; PDFs start at w_i C."""
        t = self.tp.num_tracers
        conc0 = torch.as_tensor(conc0, dtype=self.dtype,
                                device=self.device) * self.flow.fluid_mask
        if tuple(conc0.shape) != (t,) + self.geo.shape:
            raise ValueError(f"conc0 {tuple(conc0.shape)}; want "
                             f"{(t,) + self.geo.shape}")
        w = torch.as_tensor(self.lat_tr.w, dtype=self.dtype,
                            device=self.device).reshape(1, -1, 1, 1)
        g = conc0[:, None] * w
        mass0 = torch.sum(conc0, dim=(-2, -1))
        return TransportState(flow_state[0], flow_state[1], g, mass0)

    def pack(self, state: TransportState):
        """TransportState -> the coupled compressed state (s, g), with s in
        the flow's ``storage`` layout."""
        pack = self.flow.pack_state_bf16 if self.flow.storage == "bf16" \
            else self.flow.pack_state
        return pack(state.f_r, state.f_b), state.g

    def concentration(self, g):
        return torch.sum(g, dim=1)

    # -- the step ----------------------------------------------------------------
    def _transport_substep(self, g, u, gx, gy, rho_r):
        """Tracer collision, interface partition, reaction, free-flow
        outlet, streaming with bounce-back, hard interface bounce-back and
        inlet rows, from the flow fields u, (gx, gy), rho_r."""
        tp, lat = self.tp, self.lat_tr
        nt = tp.num_tracers
        conc = self.concentration(g)
        in_domain, value = tr.transport_domain_mask(rho_r, tp.criteria)

        if tp.relaxation == "MRT":
            feq_fn = eq.feq_transport_quadratic \
                if tp.mrt_equilibrium == "quadratic" \
                else eq.feq_transport_linear
            g = tr.mrt_collide(g, feq_fn(lat, conc, u), self.mrt_update)
        else:
            if tp.scheme == 5:
                geq = torch.stack([
                    eq.feq_transport_j(lat, conc[t], u, self.j_coeffs[t])
                    for t in range(nt)])
            else:
                geq = eq.feq_transport_linear(lat, conc, u)
            tau = torch.as_tensor(self.tau_tr, dtype=g.dtype,
                                  device=g.device).reshape(-1, 1, 1, 1)
            g = g - (g - geq) / tau

        if tp.interface_mode == "permeable" and any(self.beta):
            g = tr.interface_partition(g, conc, gx, gy, value, self.beta, lat)
        if tp.reaction_rate:
            g = tr.bilinear_reaction(
                g, conc, tp.reaction_rate,
                self.j_coeffs if tp.scheme == 5 else np.tile(lat.w, (nt, 1)),
                self.stoich)
        m = self.flow._row_mask
        if tp.outlet == "freeflow":
            g = tr.free_flow_outlet(g, (2, 1, 0), (m(2), m(1), m(0)))

        g = stream(g, lat, self.upwind_solid_tr) * self.flow.fluid_mask

        if tp.interface_mode in ("bounceback", "redistribute"):
            g = tr.interface_bounce_back(g, in_domain, lat)
        ny = self.geo.ny
        if tp.inlet == "inamuro":
            g = tr.inamuro_inlet(g, self.inlet_conc, ny - 1, m(ny - 1))
        elif tp.inlet == "anti_bounce_back":
            g = tr.anti_bounce_back_inlet(g, self.inlet_conc, ny - 2,
                                          m(ny - 1), w3=float(lat.w[3]))
        elif tp.inlet == "zero":
            g = tr.zero_concentration_inlet(g, ny - 2, m(ny - 2))
        return g

    def _check_compressed(self):
        """The options the JAX package has no compressed coupled form for
        (``TransportRK.make_block_step`` returns None) are refused."""
        tp = self.tp
        if tp.conserve_mass or tp.interface_mode == "redistribute" or \
                self.standalone:
            raise ValueError(
                "conserve_mass, interface_mode='redistribute' and standalone "
                "transport have no compressed coupled form; use step() on "
                "the split TransportState")

    def plain_step_c(self, state):
        """One coupled step of (s, g) composed from ``ops/``, on any device:
        the plain version of the kernel.  The tracer sees the fields of s
        before the flow's boundary rows; a bf16 s is decoded first."""
        self._check_compressed()
        s, g = state
        rho_r, _, _, gx, gy, u = self.flow.fields_c(s)
        g = self._transport_substep(g, u, gx, gy, rho_r)
        return self.flow.plain_step_c(s), g

    def step_c(self, state):
        """One coupled time step of (s, g): the kernel on a CUDA state, the
        plain step on a CPU one or with ``use_kernel=False``."""
        if not self.flow.use_kernel:
            return self.plain_step_c(state)
        self._check_compressed()
        s, g = state
        return coupled_step_compressed(s, g, self)

    # -- the split step ------------------------------------------------------
    def plain_coupled(self, state: TransportState):
        """The plain version of the split coupled kernels, composed from
        ``ops/`` on any device: the tracer sub-step on the fields before
        the flow's boundary rows, then the flow step (unless standalone).
        Returns (f_r', f_b', g', u, in_domain), u (2, ny, nx) and in_domain
        the pre-step velocity and transport-domain mask that ``repair``
        reads."""
        f_r, f_b, g, _ = state
        rho_r, _, _, gx, gy, u = self.flow.fields(f_r, f_b)
        g = self._transport_substep(g, u, gx, gy, rho_r)
        if not self.standalone:
            f_r, f_b = self.flow.plain_step((f_r, f_b))
        in_domain, _ = tr.transport_domain_mask(rho_r, self.tp.criteria)
        return f_r, f_b, g, torch.stack(u), in_domain

    def repair(self, out, mass0) -> TransportState:
        """The split step's repairs of a coupled step's output `out`
        (``plain_coupled``'s five tensors), in the JAX model's order: the
        conserve_mass renormalisation on the pre-step u and domain mask,
        then (unless standalone) the redistribution of the tracer of nodes
        the phase front crossed, from the domain masks before and after
        the flow step."""
        f_r, f_b, g, u, in_domain = out
        tp, lat = self.tp, self.lat_tr
        if tp.conserve_mass:
            g, _ = tr.renormalize_concentration(
                g, self.concentration(g), mass0, in_domain,
                u[0] * u[0] + u[1] * u[1], self.j_coeffs, u, lat)
        if tp.interface_mode == "redistribute" and not self.standalone:
            fl = self.flow.is_fluid
            in_new = tr.transport_domain_mask(
                mac.density(f_r, 2), tp.criteria)[0] & fl
            g = tr.redistribute_on_interface_motion(
                g, in_new, in_domain & fl, self.j_coeffs if tp.scheme == 5
                else np.tile(lat.w, (tp.num_tracers, 1)), lat)
        return TransportState(f_r, f_b, g, mass0)

    def plain_step(self, state: TransportState) -> TransportState:
        """One split coupled step composed from ``ops/`` (the jnp
        ``_step_impl``), on any device: ``plain_coupled``, then the
        repairs."""
        return self.repair(self.plain_coupled(state), state.mass0)

    def step(self, state: TransportState) -> TransportState:
        """One split coupled time step: the kernels on a CUDA state, the
        plain version on a CPU one or with ``use_kernel=False``, then the
        repairs as PyTorch ops."""
        if not self.flow.use_kernel:
            return self.plain_step(state)
        return self.repair(
            coupled_step_split(state, self, with_u=self.tp.conserve_mass),
            state.mass0)

    # -- T steps a call ------------------------------------------------------
    def make_block_step(self, steps_per_call: int = 2,
                        rows_per_block: int | None = None,
                        compressed: bool = False, interpret: bool = False,
                        storage: str = "f32"):
        """A coupled step of ``steps_per_call`` = T time steps a call (the
        JAX ``make_block_step``).  With ``compressed`` it maps ``(s, g) ->
        (s', g')``, s the flow's compressed state (``pack``; 11 bfloat16
        planes with ``storage="bf16"``, decoded once and encoded once a
        launch); else the split ``TransportState`` -> ``TransportState``.
        On a card one launch of K5c-T (``kernels/transport.py::
        coupled_block_compressed`` / ``coupled_block_split``; several,
        ``build.split_steps``, above a launch's limit), on the CPU T plain
        steps.  T = 1 gives ``step``, or ``step_c`` for the flow's
        own storage; with ``conserve_mass`` (T = 1, split) ``step`` marked
        ``needs_mass0``, as the JAX form that takes mass0.

        Returns None where the JAX build function builds nothing on grounds
        of physics or boundaries: flow rows outside the in-kernel set
        (csf.py:274-278), bf16 storage on the split layout (:243-245),
        ``conserve_mass`` or ``redistribute`` with T > 1 or ``compressed``
        (models/transport.py:150-167), and ``use_kernel=False``.  (A Perturbation flow, a tracer scheme
        other than D2Q5 / D2Q9 and tracer rows the kernel does not take,
        csf.py:206-221, are refused by the constructor already.)  Standalone
        transport has no T-step form here (ValueError): the JAX kernel would
        advance the flow.  ``rows_per_block`` and ``interpret`` tune the TPU
        kernel's strips and are ignored; no shape is refused."""
        del rows_per_block, interpret
        t = block_args(steps_per_call, storage)
        tp, flow = self.tp, self.flow
        if flow.bcs.inlet not in BLOCK_INLETS or \
                flow.bcs.outlet not in BLOCK_OUTLETS or not flow.use_kernel:
            return None
        if storage == "bf16" and not compressed:
            return None
        if (tp.conserve_mass or tp.interface_mode == "redistribute") and (
                t != 1 or compressed):
            return None
        if storage == "bf16" and self.dtype != torch.float32:
            raise ValueError("storage='bf16' computes in float32")
        if compressed:
            self._check_compressed()
            if t == 1 and storage == flow.storage:
                return self.step_c
            return t_step(coupled_block_compressed, self, t)
        if t == 1:
            if not tp.conserve_mass:
                return self.step

            def step_with_mass0(state):
                return self.step(state)

            step_with_mass0.needs_mass0 = True
            return step_with_mass0
        if self.standalone:
            raise ValueError("standalone transport has no T-step form")
        return t_step(coupled_block_split, self, t)
