"""The row-march of the 2-D T-step kernels (K3's CSF and Perturbation
variants, K5c-T and the Shan-Chen K8-T) and the splitting of T-step calls,
on the CPU.

The CUDA kernels (``csrc/march3d.cuh`` with ``csrc/march2d.cuh`` and
``csrc/sc2d_march.cuh``) execute a plan built by
``openlbmpm_torch/kernels/march2d.py``.  Here the same plans run through
their plain PyTorch model (``csf2d_march_reference``,
``pert2d_march_reference``, ``coupled2d_march_reference``,
``sc2d_march_reference``: wave by wave,
from rings of the plan's depth
that hold NaN until written, a wave seeing only what earlier waves wrote,
each stage on the rows it declares it reads), at f64:

* CSF compressed and split at T = 2, 3 and 4 on the flagship's rows (the
  neumann inlet, the Dirichlet outlet with the phi repair, Akai wetting
  walls), on the Dirichlet inlet with the convective outlet and on
  periodic rows, against T plain steps of the port (<= 1e-12), and the
  compressed case against the JAX package's jnp ``_step_impl_c`` T times
  at 64 x 48;
* the Perturbation variant, compressed and split, SRT and MRT, at T = 2, 3
  and 4 on the same rows against T plain steps (<= 1e-12), and against the
  JAX package's jnp ``_step_impl_c`` and ``_step_impl`` T times at 64 x 48;
  its plan's launch limit, and a plan with a lag a row short or the seam's
  rows left out fails the model;
* the coupled step with D2Q5 and D2Q9 tracers (the tracer rows, the
  bounce-back and permeable interfaces), compressed and split;
* the plan's schedule: the boundary stage's in-place rewrite waits for the
  tracer's reads of the state before it, the output stages cover the
  domain's rows once, and the plan limits give the largest T a launch
  takes;
* a plan with one level's lag a row short, or with the seam's rows left
  out, fails the model;
* K8-T's plan (the inlet rows, the collision, streaming, the outlet rows
  after it, psi formed with each state written, and the store of the last
  level's rewritten rows) on the
  SC_CASES rows at T = 2, 3 and 4, one and four rows a wave, against T
  plain steps (<= 1e-12): SC periodic with a body force, velocity /
  convective and pressure / pressure rows, EFS iso-8 MRT and iso-10, three
  fluids, Peng-Robinson; its launch limit; a bf16 state decoded once and
  encoded once; a plan with a level's collision a row short of its lag,
  the seam's rows left out or the outlet rows rewritten a wave early fails
  the model;
* ``build.split_steps``, the rule by which a T-step call above one
  launch's limit runs as several launches.

The kernels are held to the plain steps on a card by ``chip_smoke.py``
phases 45, 46, 48, 52, 54 and 72.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import PERT_BASE, sc_case
from openlbmpm_tpu import geometry as jgeo
from openlbmpm_tpu.models import colorgradient as jcg
from openlbmpm_torch.convert import params_from_jax
from openlbmpm_torch.geometry import from_solid_mask
from openlbmpm_torch.kernels import build
from openlbmpm_torch.kernels import csf as k
from openlbmpm_torch.kernels import march2d as M2
from openlbmpm_torch.kernels import march3d as M3
from openlbmpm_torch.kernels import shanchen as ksc
from openlbmpm_torch.kernels import transport as kt
from openlbmpm_torch.models.colorgradient import (CGBoundaryConfig,
                                                  ColorGradientParams,
                                                  ColorGradientRK)
from openlbmpm_torch.models.transport import TransportParams, TransportRK

torch.set_num_threads(1)
CPU = "cpu"   # the port's models run on the card unless told otherwise
TOL = 1e-12
FLAGSHIP = dict(inlet="neumann", outlet="dirichlet", inlet_velocity=-1e-4,
                outlet_density_r=0.0, outlet_density_b=1.0)
DIR_CONV = dict(inlet="dirichlet", outlet="convective", inlet_density_r=0.02,
                inlet_density_b=1.0)
BCS = {"flagship": FLAGSHIP, "dirichlet_convective": DIR_CONV,
       "periodic": {}}
CSF = dict(variant="CSF", collision="MRT", surface_tension=0.01, tau_r=1.0,
           tau_b=0.8, tau_type=2, wetting_type=2, contact_angle_deg=60.0)


def _walls(ny, nx):
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    solid[ny // 2 - 2:ny // 2 + 2, nx // 2 - 1:nx // 2 + 2] = True
    return solid


def _csf_model(rows, ny=40, nx=12):
    solid = _walls(ny, nx) if rows != "periodic" else np.zeros((ny, nx), bool)
    return ColorGradientRK(from_solid_mask(solid), ColorGradientParams(**CSF),
                           CGBoundaryConfig(**BCS[rows]), dtype=torch.float64,
                           device=CPU)


def _start(m, seed=3):
    """Layers with a little of the other colour mixed in at random, so that
    phi differs from cell to cell and no two rows are alike."""
    f_r, f_b = m.init_state_layers(1.0, 1.0, invading_rows=m.geo.ny // 4)
    g = torch.Generator().manual_seed(seed)
    fl = m.fluid_mask

    def rnd():
        return torch.rand(f_r.shape, generator=g, dtype=f_r.dtype)
    return ((f_r + 0.05 * rnd() * f_b) * fl,
            (f_b + 0.05 * rnd() * f_r) * fl)


def _gap(a, b):
    if isinstance(a, (tuple, list)):
        return max(_gap(x, y) for x, y in zip(a, b))
    return float((a.double() - b.double()).abs().max())


@pytest.mark.parametrize("rows", ["flagship", "dirichlet_convective",
                                  "periodic"])
@pytest.mark.parametrize("split", [False, True], ids=["compressed", "split"])
@pytest.mark.parametrize("t", [2, 3, 4])
def test_csf_march_model_matches_plain_steps(rows, split, t):
    """K3's CSF plan run by its model equals T plain steps at f64."""
    m = _csf_model(rows)
    st = _start(m)
    x0 = st if split else m.pack_state(*st)
    got = M2.csf2d_march_reference(x0, m, t)
    want = (k.csf_block_split_reference if split else
            k.csf_block_compressed_reference)(x0, m, t)
    assert _gap(got, want) <= TOL


def test_csf_march_model_matches_jax_steps():
    """The compressed plan's model at T = 3 on the flagship's 64 x 48
    channel against the JAX package's jnp step (``_step_impl_c``) three
    times, at f64."""
    solid = _walls(64, 48)
    g = jgeo.from_solid_mask(solid)
    jp = jcg.ColorGradientParams(**CSF)
    jb = jcg.CGBoundaryConfig(**FLAGSHIP)
    mj = jcg.ColorGradientRK(g, jp, jb, dtype=jnp.float64, use_pallas=False)
    mt = ColorGradientRK(from_solid_mask(solid), params_from_jax(jp),
                         params_from_jax(jb), dtype=torch.float64,
                         device=CPU)
    s = mj.pack_state(*mj.init_state_layers(1.0, 1.0, invading_rows=12))
    got = M2.csf2d_march_reference(torch.from_numpy(np.array(s)), mt, 3)
    for _ in range(3):
        s = mj._step_impl_c(s)
    assert float(np.abs(got.numpy() - np.asarray(s)).max()) <= TOL


def _pert_model(rows, collision="MRT", ny=40, nx=12):
    solid = _walls(ny, nx) if rows != "periodic" else np.zeros((ny, nx), bool)
    p = ColorGradientParams(**(PERT_BASE | dict(collision=collision)))
    return ColorGradientRK(from_solid_mask(solid), p,
                           CGBoundaryConfig(**BCS[rows]), dtype=torch.float64,
                           device=CPU)


@pytest.mark.parametrize("rows", ["flagship", "dirichlet_convective",
                                  "periodic"])
@pytest.mark.parametrize("split", [False, True], ids=["compressed", "split"])
@pytest.mark.parametrize("t", [2, 3, 4])
def test_pert_march_model_matches_plain_steps(rows, split, t):
    """K3's Perturbation plan run by its model equals T plain steps at f64
    (MRT; the Dirichlet outlet's phi repair on the flagship's rows)."""
    m = _pert_model(rows)
    st = _start(m)
    x0 = st if split else m.pack_state(*st)
    got = M2.pert2d_march_reference(x0, m, t)
    want = (k.pert_block_split_reference if split else
            k.pert_block_compressed_reference)(x0, m, t)
    assert _gap(got, want) <= TOL


@pytest.mark.parametrize("split", [False, True], ids=["compressed", "split"])
def test_pert_march_model_srt(split):
    """The SRT collision of the Perturbation plan's model at T = 3 on the
    Dirichlet inlet and convective outlet equals 3 plain steps."""
    m = _pert_model("dirichlet_convective", "SRT")
    st = _start(m)
    x0 = st if split else m.pack_state(*st)
    got = M2.pert2d_march_reference(x0, m, 3)
    want = (k.pert_block_split_reference if split else
            k.pert_block_compressed_reference)(x0, m, 3)
    assert _gap(got, want) <= TOL


@pytest.mark.parametrize("split", [False, True], ids=["compressed", "split"])
def test_pert_march_model_matches_jax_steps(split):
    """The Perturbation plan's model at T = 3 on the flagship's 64 x 48
    channel against the JAX package's jnp Perturbation step three times
    (``_step_impl_c`` compressed, ``_step_impl`` split), at f64."""
    solid = _walls(64, 48)
    g = jgeo.from_solid_mask(solid)
    jp = jcg.ColorGradientParams(**PERT_BASE)
    jb = jcg.CGBoundaryConfig(**FLAGSHIP)
    mj = jcg.ColorGradientRK(g, jp, jb, dtype=jnp.float64, use_pallas=False)
    mt = ColorGradientRK(from_solid_mask(solid), params_from_jax(jp),
                         params_from_jax(jb), dtype=torch.float64,
                         device=CPU)
    st = mj.init_state_layers(1.0, 1.0, invading_rows=12)
    if split:
        got = M2.pert2d_march_reference(
            tuple(torch.from_numpy(np.array(a)) for a in st), mt, 3)
        for _ in range(3):
            st = mj._step_impl(*st)
        want = st
    else:
        s = mj.pack_state(*st)
        got = (M2.pert2d_march_reference(torch.from_numpy(np.array(s)), mt,
                                         3),)
        for _ in range(3):
            s = mj._step_impl_c(s)
        want = (s,)
    assert max(float(np.abs(a.numpy() - np.asarray(b)).max())
               for a, b in zip(got, want)) <= TOL


def test_pert_plan_limit():
    """The Perturbation plan takes 4 stages and 3 rings a level with
    boundary rows (3 and 3 without): its launch limit is the largest T
    that fits the executor's tables, and a T above it fails to plan."""
    def pert(t, bc=True):
        return M2.pert2d_stages(64, t, 8, False, int(bc), 2 * int(bc), bc)

    for stages_of in (pert, lambda t: pert(t, False)):
        t = M2.max_steps(stages_of)
        st, ar = stages_of(t)
        assert len(st) <= M3.MAX_STAGES and len(ar) <= M3.MAX_RINGS
        st, ar = stages_of(t + 1)
        assert len(st) > M3.MAX_STAGES or len(ar) > M3.MAX_RINGS
    assert M2.max_steps(pert) == 15
    assert M2.max_steps(lambda t: pert(t, False)) == 16
    params = k.CsfParams(ny=64, nx=8, inlet=1, outlet=2, phi_repair=1,
                         variant=1)
    assert k.csf_block_max_steps(torch.float64, False, params) == 15
    with pytest.raises(ValueError):
        M2.pert2d_march_plan((64, 8), 16, 8, False, 1, 2, True)


@pytest.mark.parametrize("fault", ["lag", "seam"])
def test_pert_march_model_sees_schedule_faults(fault):
    """A Perturbation plan whose second level's collision trails one row
    too little, or whose first level's phi stage leaves out a row of the
    seam below 0, gives the model wrong or NaN values."""
    m = _pert_model("flagship" if fault == "lag" else "periodic")
    x0 = m.pack_state(*_start(m))
    want = k.pert_block_compressed_reference(x0, m, 2)
    plan = M2.pert2d_march_plan((40, 12), 2, 8, False, *M2._codes(m),
                                bool(m._phi_repair), rows_per_wave=1)
    if fault == "lag":
        c1 = next(s for s in plan.stages
                  if s.kind == M3.COLLIDE and s.level == 1)
        c1.d -= 1
    else:
        phi0 = next(s for s in plan.stages if s.kind == M2.PHI)
        phi0.lo += 1
    plan.waves = _rewave(plan)
    got = M2.pert2d_march_reference(x0, m, 2, plan)
    assert not _gap(got, want) <= TOL


TRACERS = {
    "d2q5_permeable": dict(num_tracers=2, scheme=5, tau=(1.0, 0.9),
                           j0=(1 / 3, 1 / 3), interface_mode="permeable",
                           beta_interface=(0.5, 0.2), inlet="inamuro",
                           inlet_conc=(1.0, 0.5), outlet="freeflow"),
    "d2q5_bounceback": dict(num_tracers=1, scheme=5, tau=(1.0,),
                            j0=(1 / 3,), interface_mode="bounceback",
                            inlet="zero", outlet="freeflow"),
    "d2q5_mrt_abb": dict(num_tracers=2, scheme=5, relaxation="MRT",
                         mrt_equilibrium="quadratic", diff_x=(0.1, 0.05),
                         diff_y=(0.08, 0.05), diff_xy=(0.02, 0.0),
                         diff_yx=(0.01, 0.0), interface_mode="permeable",
                         beta_interface=(0.3,), inlet="anti_bounce_back",
                         inlet_conc=(1.0, 0.2)),
    "d2q9_permeable": dict(num_tracers=2, scheme=9, tau=(1.0, 0.8),
                           interface_mode="permeable",
                           beta_interface=(0.5, 0.2), reaction_rate=0.05,
                           reaction_stoich=(-1.0, 1.0)),
}


def _coupled(name, rows="flagship", ny=40, nx=12):
    p = dataclasses.replace(ColorGradientParams(**CSF), contact_angle_deg=90.0)
    m = TransportRK(from_solid_mask(_walls(ny, nx)), p,
                    TransportParams(**TRACERS[name]),
                    CGBoundaryConfig(**BCS[rows]), dtype=torch.float64,
                    device=CPU)
    nt = m.tp.num_tracers
    gen = torch.Generator().manual_seed(len(name))
    conc = 0.1 + torch.rand((nt, ny, nx), generator=gen,
                            dtype=torch.float64)
    return m, m.init_state(_start(m.flow), conc)


@pytest.mark.parametrize("name,rows", [
    ("d2q5_permeable", "flagship"), ("d2q5_bounceback", "flagship"),
    ("d2q5_mrt_abb", "dirichlet_convective"),
    ("d2q9_permeable", "flagship")])
@pytest.mark.parametrize("split", [False, True], ids=["compressed", "split"])
def test_coupled_march_model_matches_plain_steps(name, rows, split):
    """K5c-T's plan run by its model equals T = 3 plain coupled steps at
    f64, flow state and tracers."""
    m, st = _coupled(name, rows)
    x0 = st if split else m.pack(st)
    got = M2.coupled2d_march_reference(x0, m, 3)
    want = (kt.coupled_block_split_reference if split else
            kt.coupled_block_compressed_reference)(x0, m, 3)
    assert _gap(tuple(got)[:3], tuple(want)[:3]) <= TOL


def test_plan_orders_in_place_rewrite_after_earlier_reads():
    """In K5c-T's plan the boundary stage rewrites the state only after the
    tracer's stages of the level have read it: its wave offset is at least
    each earlier reader's plus its read reach below, the rows the rewrite
    reaches and one wave; the output stages cover the rows 0 ... ny - 1."""
    plan = M2.coupled2d_march_plan((40, 12), 3, 8, False, 1, 2, True, True,
                                   10, rows_per_wave=4)
    z = plan.slabs_per_wave
    for c, st in enumerate(plan.stages):
        for a in st.modifies:
            for q in range(c):
                for r in plan.stages[q].reads:
                    if r.array == a:
                        assert st.d >= plan.stages[q].d + r.zlo + st.back + z
    outs = [st for st in plan.stages if st.output]
    assert [st.kind for st in outs] == [M2.TSTREAM, M3.STREAM]
    assert all((st.lo, st.hi) == (0, 39) for st in outs)
    seen = {}
    for wave in plan.waves:
        for kk, u in wave:
            seen[(kk, u)] = seen.get((kk, u), 0) + 1
    assert set(seen.values()) == {1}


def test_plan_limits_give_the_launch_limit():
    """``max_steps`` is the largest T whose stages and rings fit the
    executor's tables (CSF with boundary rows: 5 stages and 4 rings a
    level; K5c-T: 9 and 8), and a T above it fails to plan."""
    def csf(t):
        return M2.csf2d_stages(64, t, 8, False, 1, 2, True, True)

    def cpl(t):
        return M2.coupled2d_stages(64, t, 8, False, 1, 2, True, True, 10)

    for stages_of in (csf, cpl):
        t = M2.max_steps(stages_of)
        st, ar = stages_of(t)
        assert len(st) <= M3.MAX_STAGES and len(ar) <= M3.MAX_RINGS
        st, ar = stages_of(t + 1)
        assert len(st) > M3.MAX_STAGES or len(ar) > M3.MAX_RINGS
    assert M2.max_steps(csf) == 12 and M2.max_steps(cpl) == 6
    with pytest.raises(ValueError):
        M2.csf2d_march_plan((64, 8), 13, 8, False, 1, 2, True, True)


def _rewave(plan):
    z = plan.slabs_per_wave
    first = min((st.lo + st.d) // z for st in plan.stages)
    last = max((st.hi + st.d) // z for st in plan.stages)
    waves = [[] for _ in range(last - first + 1)]
    for kk, st in enumerate(plan.stages):
        for u in range(st.lo, st.hi + 1):
            if st.slabs is None or u % plan.nz in st.slabs:
                waves[(u + st.d) // z - first].append((kk, u))
    return waves


@pytest.mark.parametrize("fault", ["lag", "seam", "bc_war"])
def test_march_model_sees_schedule_faults(fault):
    """A plan whose second level's collision trails one row too little,
    whose first level's phi leaves out a row of the seam below 0, or (K5c-T)
    whose boundary stage rewrites the state one wave before the tracer's
    collision has read it, gives the model wrong or NaN values."""
    if fault == "bc_war":
        m, st = _coupled("d2q5_permeable")
        x0 = m.pack(st)
        want = kt.coupled_block_compressed_reference(x0, m, 2)
        plan = M2.coupled2d_march_plan((40, 12), 2, 8, False, 1, 2, True,
                                       True, 10, rows_per_wave=1)
        bc = next(s for s in plan.stages if s.kind == M3.BC)
        tc = next(s for s in plan.stages if s.kind == M2.TCOLLIDE)
        bc.d = tc.d
        plan.waves = _rewave(plan)
        got = M2.coupled2d_march_reference(x0, m, 2, plan)
        assert not _gap(tuple(got), tuple(want)) <= TOL
        return
    # periodic rows for the seam: the boundary stage's coverage (it acts
    # only at its triggers) would hide a row left out below it
    m = _csf_model("flagship" if fault == "lag" else "periodic")
    x0 = m.pack_state(*_start(m))
    want = k.csf_block_compressed_reference(x0, m, 2)
    plan = M2.csf2d_march_plan((40, 12), 2, 8, False, *M2._codes(m),
                               bool(m.has_wetting), bool(m._phi_repair),
                               rows_per_wave=1)
    if fault == "lag":
        c1 = next(s for s in plan.stages
                  if s.kind == M3.COLLIDE and s.level == 1)
        c1.d -= 1
    else:
        phi0 = next(s for s in plan.stages if s.kind == M2.PHI)
        phi0.lo += 1
    plan.waves = _rewave(plan)
    got = M2.csf2d_march_reference(x0, m, 2, plan)
    assert not _gap(got, want) <= TOL


def test_bf16_march_model_decodes_once():
    """A bf16 compressed state: decoded once, stepped in float32 by the
    plan's model, encoded once, as T plain steps in float32 between one
    decode and one encode."""
    m = ColorGradientRK(from_solid_mask(_walls(40, 12)),
                        ColorGradientParams(**CSF),
                        CGBoundaryConfig(**FLAGSHIP), dtype=torch.float32,
                        device=CPU, storage="bf16")
    h = m.pack_state_bf16(*_start(m))
    got = M2.csf2d_march_reference(h, m, 2)
    want = k.csf_block_compressed_reference(h, m, 2)
    assert got.dtype == torch.bfloat16
    d = (m.unpack_bf16(got) - m.unpack_bf16(want)).abs()
    assert float(d.max()) <= 1e-5


@pytest.mark.parametrize("steps,limit,want", [
    (4, 8, [4]), (8, 8, [8]), (10, 8, [5, 5]), (16, 8, [8, 8]),
    (17, 8, [6, 6, 5]), (10, 6, [5, 5]), (13, 6, [5, 4, 4]), (1, 1, [1]),
    (7, 1, [1] * 7)])
def test_split_steps(steps, limit, want):
    """A call of T steps above a launch's limit runs as ceil(T / limit)
    launches of near-equal counts, the larger first, summing to T."""
    got = build.split_steps(steps, limit)
    assert got == want
    assert sum(got) == steps and max(got) <= limit
    assert len(got) == -(-steps // limit) and max(got) - min(got) <= 1


@pytest.mark.parametrize("steps,limit", [(0, 8), (4, 0), (2.0, 8),
                                         (4, None)])
def test_split_steps_refuses(steps, limit):
    with pytest.raises(ValueError):
        build.split_steps(steps, limit)


def test_chunked_calls_equal_plain_steps_on_cpu():
    """On the CPU the T-step wrappers take their plain versions at any T
    (the splitting happens only where a kernel launches): T = 16 of K3 and
    K5c-T equal 16 plain steps, and a bf16 call decodes once."""
    m = _csf_model("flagship", ny=24, nx=10)
    x0 = m.pack_state(*_start(m))
    want = x0
    for _ in range(16):
        want = m.plain_step_c(want)
    assert _gap(k.csf_block_compressed(x0, m, 16), want) == 0.0
    mc, st = _coupled("d2q5_permeable", ny=24, nx=10)
    y0 = mc.pack(st)
    w = y0
    for _ in range(10):
        w = mc.plain_step_c(w)
    assert _gap(tuple(kt.coupled_block_compressed(y0, mc, 10)),
                tuple(w)) == 0.0


# -- K8-T ---------------------------------------------------------------------

SC_MARCH_CASES = ("sc_srt_periodic_body_force", "sc_srt_velocity_convective",
                  "sc_srt_pressure_pressure", "efs8_mrt_velocity_convective",
                  "efs10_srt_pressure_pressure", "sc_three_fluids",
                  "sc_peng_robinson_one_fluid")


def _sc_model(name, ny=40, nx=12, **kw):
    """A ShanChenMCMP of SC_CASES' `name` on the CPU and its start with a
    little noise, so that no two rows are alike."""
    m, f = sc_case(name, CPU, ny=ny, nx=nx, **kw)
    g = torch.Generator().manual_seed(len(name))
    noise = 1 + 0.01 * torch.rand(f.shape, generator=g, dtype=f.dtype)
    return m, f * noise


def _sc_plan(m, t, rows_per_wave=4):
    ny, nx = m.geo.shape
    return M2.sc2d_march_plan((ny, nx), t, 8, *M2.sc_codes(m),
                              rows_per_wave=rows_per_wave)


@pytest.mark.parametrize("rows_per_wave", [1, 4])
@pytest.mark.parametrize("t", [2, 3, 4])
@pytest.mark.parametrize("name", SC_MARCH_CASES)
def test_sc_march_model_matches_plain_steps(name, t, rows_per_wave):
    """K8-T's plan, one and four rows a wave, run by its model equals T
    plain steps at f64."""
    m, f = _sc_model(name)
    got = M2.sc2d_march_reference(f, m, t, _sc_plan(m, t, rows_per_wave))
    want = ksc.sc_block_step_reference(f, m, t)
    assert _gap(got, want) <= TOL


@pytest.mark.parametrize("fault", ["lag", "seam", "outlet"])
def test_sc_march_model_sees_schedule_faults(fault):
    """A K8-T plan whose second level's collision trails one row too
    little, whose load leaves out a row of the seam below 0, or whose last
    outlet stage runs in the wave before the one its read of the streamed
    rows asks for, gives the model wrong or NaN values."""
    m, f = _sc_model("sc_srt_periodic_body_force" if fault == "seam" else
                     "sc_srt_velocity_convective")
    want = ksc.sc_block_step_reference(f, m, 2)
    plan = _sc_plan(m, 2, rows_per_wave=1)
    if fault == "lag":
        st = next(s for s in plan.stages
                  if s.kind == M3.COLLIDE and s.level == 1)
        st.d -= 1
    elif fault == "seam":
        st = next(s for s in plan.stages if s.kind == M3.LOAD)
        st.lo += 1
    else:
        st = [s for s in plan.stages if s.kind == M2.OUTLET][-1]
        st.d -= 1
    plan.waves = _rewave(plan)
    got = M2.sc2d_march_reference(f, m, 2, plan)
    assert not _gap(got, want) <= TOL


def test_sc_plan_limit():
    """K8-T's plan takes 3 rings a level and 2 stages (periodic, or an
    inlet: one more stage), 4 (an inlet and an outlet) and the load and
    store stages: its launch limit is the largest T that fits the
    executor's tables (16 periodic or with an inlet, 15 with an outlet),
    ``sc_block_max_steps`` gives it, and a T above it fails to plan."""
    def sc(t, inlet, outlet):
        return M2.sc2d_stages(64, t, 8, 2, 8, inlet, outlet)

    for rows, want in (((0, 0), 16), ((1, 0), 16), ((1, 2), 15),
                       ((1, 1), 15)):
        t = M2.max_steps(lambda t: sc(t, *rows))
        assert t == want, rows
        st, ar = sc(t + 1, *rows)
        assert len(st) > M3.MAX_STAGES or len(ar) > M3.MAX_RINGS
    params = ksc.ScParams(ny=64, nx=8, k=2, order=8, inlet=1, outlet=2)
    assert ksc.sc_block_max_steps(torch.float64, params) == 15
    with pytest.raises(ValueError):
        M2.sc2d_march_plan((64, 8), 16, 8, 2, 8, 1, 2)


def test_sc_bf16_march_model_decodes_once():
    """A bf16 state: decoded once, stepped in float32 by K8-T's plan model,
    encoded once, as T plain steps in float32 between one decode and one
    encode (the outlet rows of the last step land before the encoding)."""
    m, f = _sc_model("sc_srt_velocity_convective", dtype=torch.float32,
                     storage="bf16")
    h = m.pack_state_bf16(f)
    got = M2.sc2d_march_reference(h, m, 3, _sc_plan(m, 3))
    want = ksc.sc_block_step_reference(h, m, 3)
    assert got.dtype == torch.bfloat16
    d = (m.unpack_bf16(got) - m.unpack_bf16(want)).abs()
    assert float(d.max()) <= 1e-6
