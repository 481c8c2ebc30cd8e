"""The z-march of the 3-D T-step kernels K11-T, K10-T and K9-T on the CPU.

The CUDA kernels (``csrc/march3d.cuh`` with ``flow3d_block.cuh`` and
``cg3d_block.cuh``) execute a plan built by
``openlbmpm_torch/kernels/march3d.py``.  Here the same plans run through
their plain PyTorch model (``single3d_march_reference``,
``sc3d_march_reference``, ``cg3d_march_reference``: wave by wave and slab
by slab, from rings of the
plan's depth that hold NaN until written, a wave seeing only what earlier
waves wrote), at f64 on domains small enough that the periodic z seam and
several y-bands (the last one overhanging ny) both occur:

* K11-T (SRT and TRT with the body force) in one band and in several,
  K10-T with K = 1, 2 and 3 fluids and K9-T compressed and split, periodic,
  with the velocity inlet and the convective outlet and with the velocity
  inlet and the pressure outlet, at T = 2, 3 and 4, against T plain steps
  of the port (<= 1e-12), which ``tests/test_torch_block_3d.py`` and
  ``tests/test_torch_block_cg3d*.py`` hold to the JAX T-step builders;
  K11-T and K10-T also directly against the JAX blocked kernels in
  interpret mode;
* the plan's schedule: every read of a stage follows the writes it needs
  by at least one wave, no ring slot is reused while a reader needs it,
  every (stage, slab) runs exactly once a band, the last stage covers the
  domain's slabs once, and the automatic bands keep the live rings within
  the budget the plan states;
* a bf16 state decoded once and encoded once;
* a plan with one level's lag a slab short, or with the seam's slabs left
  out, fails the model.

The kernels are held to the plain steps on a card by ``chip_smoke.py``
phases 53 and 60.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openlbmpm_tpu.pallas.sc3d import build_sc3d_fused_step
from openlbmpm_tpu.pallas.single3d import build_single3d_fused_step
from openlbmpm_torch.geometry import from_solid_mask
from openlbmpm_torch.kernels import march3d as M
from openlbmpm_torch.lattice import D3Q19
from openlbmpm_torch.models.flow3d import (CG3DBoundaryConfig,
                                           ColorGradientParams3D,
                                           ColorGradientRK3D, ShanChenMCMP3D,
                                           ShanChenParams3D, SinglePhaseD3Q19)
from openlbmpm_torch.ops import equilibrium as eq
from test_torch_block_3d import SC, _perturbed, _sc, _single

torch.set_num_threads(1)
CPU = "cpu"   # the port's models run on the card unless told otherwise
SHAPE = (12, 10, 6)    # (nz, ny, nx): the seam recomputes up to 24 slabs
BANDS = {2: None, 3: 4, 4: 3}   # band rows by T: one band, 3 bands, 4 bands
TOL = 1e-12
_OUTLETS = {"periodic": 0, "convective": 1, "dirichlet": 2}


def _solid():
    solid = np.zeros(SHAPE, bool)
    solid[:, 0, :] = True
    solid[5:7, 4:6, 2:4] = True
    return solid


def _sc_model(k):
    return ShanChenMCMP3D(from_solid_mask(_solid()), ShanChenParams3D(**SC[k]),
                          dtype=torch.float64, device=CPU)


def _sc_start(m, k, seed=0):
    rng = np.random.default_rng(seed + k)
    rho = torch.as_tensor(rng.uniform(0.9, 1.1, (k,) + SHAPE))
    rho = rho * torch.as_tensor([1.0, 0.3, 0.6][:k]).reshape(-1, 1, 1, 1)
    u = tuple(torch.as_tensor(rng.uniform(-0.02, 0.02, (k,) + SHAPE))
              for _ in range(3))
    return eq.feq_quadratic(D3Q19, rho, u) * m.fluid_mask


def _cg_model(inlet, outlet, dtype=torch.float64, storage="f32"):
    solid = _solid()
    solid[:, -1, :] = True
    p = ColorGradientParams3D(surface_tension=0.01, tau_r=1.0, tau_b=0.8,
                              contact_angle_deg=60.0,
                              body_force=(0.0, 1e-5, -2e-5))
    b = CG3DBoundaryConfig(inlet=inlet, outlet=outlet, inlet_velocity=-1e-3)
    return ColorGradientRK3D(from_solid_mask(solid), p, b, dtype=dtype,
                             device=CPU, storage=storage)


def _cg_start(m, seed=0):
    st = m.init_state_layers(1.0, 1.0, invading_slabs=4)
    rng = np.random.default_rng(seed)
    return tuple(x * (1 + 0.01 * torch.as_tensor(rng.standard_normal(
        x.shape), dtype=x.dtype)) * m.fluid_mask for x in st)


def _cg_plan(m, steps, split, band_rows=None, itemsize=8):
    return M.cg3d_march_plan(SHAPE, steps, itemsize, split,
                             int(m.bcs.inlet == "velocity"),
                             _OUTLETS[m.bcs.outlet], bool(m.has_wetting),
                             band_rows=band_rows)


def _plain(m, x, steps, split=None):
    for _ in range(steps):
        x = m._step_impl(x) if split is None else \
            (m.plain_step(x) if split else m.plain_step_c(x))
    return x


def _gap(a, b):
    if torch.is_tensor(a):
        a, b = (a,), (b,)
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("steps", [2, 3, 4])
def test_sc3d_march_equals_plain_steps(k, steps):
    """K10-T's march model, K fluids (walls, an obstacle, the adhesion
    field, a body force), T steps a call, one band at T = 2 and 3 or 4
    bands at T = 3 and 4: T plain steps to 1e-12 (measured 0)."""
    m = _sc_model(k)
    f = _sc_start(m, k)
    plan = M.sc3d_march_plan(SHAPE, k, steps, 8, band_rows=BANDS[steps])
    assert plan.bands == (1 if BANDS[steps] is None else
                          -(-SHAPE[1] // BANDS[steps]))
    got = M.sc3d_march_reference(f, m, steps, plan)
    assert bool(torch.isfinite(got).all())
    assert _gap(got, _plain(m, f, steps)) <= TOL


@pytest.mark.parametrize("layout", ["compressed", "split"])
@pytest.mark.parametrize("bc", [("periodic", "periodic"),
                                ("velocity", "convective"),
                                ("velocity", "dirichlet")],
                         ids=["periodic", "inlet-convective",
                              "inlet-pressure"])
@pytest.mark.parametrize("steps", [2, 3, 4])
def test_cg3d_march_equals_plain_steps(layout, bc, steps):
    """K9-T's march model on walls along y with an obstacle (wetting walls,
    a body force): the boundary slabs in place by global z, T steps a call,
    one band at T = 2, 4 bands of 3 rows at T = 3 and 3 of 4 at T = 4
    (whose last band overhangs ny): T plain steps to 1e-12 (measured
    2.2e-16)."""
    m = _cg_model(*bc)
    split = layout == "split"
    st = _cg_start(m)
    x = st if split else m.pack_state(*st)
    band_rows = {2: None, 3: 3, 4: 4}[steps]
    plan = _cg_plan(m, steps, split, band_rows)
    got = M.cg3d_march_reference(x, m, steps, plan)
    want = _plain(m, x, steps, split)
    assert all(bool(torch.isfinite(t).all()) for t in
               (got if split else (got,)))
    assert _gap(got, want) <= TOL


def _single_model(collision):
    return SinglePhaseD3Q19(from_solid_mask(_solid()), tau=0.8,
                            collision=collision,
                            body_force=(2e-5, -1e-5, 3e-5),
                            dtype=torch.float64, device=CPU)


@pytest.mark.parametrize("bands", ["one", "several"])
@pytest.mark.parametrize("collision", ["SRT", "TRT"])
@pytest.mark.parametrize("steps", [2, 3, 4])
def test_single3d_march_equals_plain_steps(steps, collision, bands):
    """K11-T's march model (walls, an obstacle, the Guo body force), T steps
    a call, in one band or in 3 or 4 bands whose last overhangs ny: T plain
    steps to 1e-12 (measured 0)."""
    m = _single_model(collision)
    f = _sc_start(m, 1)[0]
    rows = None if bands == "one" else {2: 4, 3: 4, 4: 3}[steps]
    plan = M.single3d_march_plan(SHAPE, steps, 8, band_rows=rows)
    assert plan.bands == 1 if rows is None else \
        plan.bands * plan.band_rows > SHAPE[1] and plan.bands > 2
    got = M.single3d_march_reference(f, m, steps, plan)
    assert bool(torch.isfinite(got).all())
    assert _gap(got, _plain(m, f, steps)) <= TOL


def test_single3d_march_matches_jax_kernel():
    """SRT with the body force on the 16 x 8 x 8 box of
    test_torch_block_3d.py: two calls of the march model at T = 2 (three
    y-bands) against two calls of the JAX blocked K11
    (``build_single3d_fused_step``, ``steps_per_call=2``) in interpret
    mode, to 1e-12."""
    mj, mt = _single("SRT", True)
    jblk = build_single3d_fused_step(mj.geo, mj.tau, "SRT", mj.body_force,
                                     jnp.float64, slabs_per_block=4,
                                     steps_per_call=2, interpret=True)
    f = _perturbed(3)
    a, b = jnp.asarray(f), torch.from_numpy(f.copy())
    plan = M.single3d_march_plan(f.shape[-3:], 2, 8, band_rows=3)
    for _ in range(2):
        a, b = jblk(a), M.single3d_march_reference(b, mt, 2, plan)
    assert float(np.abs(b.numpy() - np.asarray(a)).max()) <= TOL


def test_sc3d_march_matches_jax_kernel():
    """K = 2 on the 16 x 8 x 8 box of test_torch_block_3d.py: two calls of
    the march model at T = 2 against two calls of the JAX blocked K10
    (``build_sc3d_fused_step``, ``steps_per_call=2``) in interpret mode, to
    1e-12."""
    mj, mt = _sc(2)
    jblk = build_sc3d_fused_step(mj.geo, mj.p, jnp.float64,
                                 slabs_per_block=4, steps_per_call=2,
                                 interpret=True)
    f = _perturbed(2, 2)
    a, b = jnp.asarray(f), torch.from_numpy(f.copy())
    plan = M.sc3d_march_plan(f.shape[-3:], 2, 2, 8, band_rows=3)
    for _ in range(2):
        a, b = jblk(a), M.sc3d_march_reference(b, mt, 2, plan)
    assert float(np.abs(b.numpy() - np.asarray(a)).max()) <= TOL


def test_bf16_march_decodes_once():
    """The bf16 forms: the state decoded once, the levels in float32, one
    encoding, as the T-step kernels' plain versions do: K11-T (TRT with the
    body force), K10-T (K = 2) and K9-T compressed, every value within one
    bf16 ulp of them (the two sum a few terms in other orders in
    float32)."""
    g = from_solid_mask(_solid())
    ms = SinglePhaseD3Q19(g, tau=0.8, collision="TRT",
                          body_force=(2e-5, -1e-5, 3e-5),
                          dtype=torch.float32, device=CPU, storage="bf16")
    hs = ms.pack_state_bf16(_sc_start(ms, 1)[0].float())
    got = M.single3d_march_reference(hs, ms, 3)
    assert got.dtype == torch.bfloat16
    _within_one_ulp(got, ms.pack_state_bf16(_plain(ms, ms.unpack_bf16(hs),
                                                   3)))
    m = ShanChenMCMP3D(g, ShanChenParams3D(**SC[2]), dtype=torch.float32,
                       device=CPU, storage="bf16")
    h = m.pack_state_bf16(_sc_start(m, 2).float())
    got = M.sc3d_march_reference(h, m, 3)
    x = m.unpack_bf16(h)
    want = m.pack_state_bf16(_plain(m, x, 3))
    assert got.dtype == torch.bfloat16
    _within_one_ulp(got, want)
    mc = _cg_model("velocity", "convective", torch.float32, "bf16")
    hc = mc.pack_state_bf16(*_cg_start(mc))
    got = M.cg3d_march_reference(hc, mc, 2)
    want = mc.pack_compressed_bf16(_plain(mc, mc.unpack_bf16(hc), 2, False))
    assert got.dtype == torch.bfloat16
    _within_one_ulp(got, want)


def _within_one_ulp(a, b):
    ia = a.view(torch.int16).int()
    ib = b.view(torch.int16).int()
    assert int((ia - ib).abs().max()) <= 1


def _check_schedule(plan):
    """The plan's invariants (module docstring)."""
    z = plan.slabs_per_wave
    stages = plan.stages

    def wave(st, u):
        return (u + st.d) // z

    writers = {}
    for c, st in enumerate(stages):
        for r in st.reads:
            for q in writers.get(r.array, ()):
                w = stages[q]
                # what c reads was written in an earlier wave
                assert wave(w, st.lo + r.zhi) < wave(st, st.lo)
                assert st.d >= w.d + r.zhi + z
                # and covers what c reads
                back = w.back if r.array in w.modifies else 0
                assert w.lo <= st.lo - r.zlo - back
                assert w.hi >= st.hi + r.zhi
                # (one band: the rings wrap in y, no stage reaches beyond)
                assert plan.bands == 1 or w.e >= st.e + r.ry
        for a in st.writes + st.modifies:
            writers.setdefault(a, []).append(c)
    for ring in plan.rings:
        p = stages[writers[ring.name][0]]
        for st in stages:
            for r in st.reads:
                if r.array == ring.name and st is not p:
                    # the oldest slab a reader needs is still in its slot
                    assert ring.depth >= st.d + r.zlo - p.d + z
    seen = [(k, u) for w in plan.waves for k, u in w]
    assert len(seen) == len(set(seen)) == sum(
        sum(1 for u in range(st.lo, st.hi + 1)
            if st.slabs is None or u % plan.nz in st.slabs)
        for st in stages)
    assert (stages[-1].lo, stages[-1].hi, stages[-1].e) == (0, plan.nz - 1,
                                                           0)
    assert all(st.e <= plan.halo for st in stages)


@pytest.mark.parametrize("family,shape,steps,dtype", [
    ("single", (128, 128, 128), 2, "f32"),
    ("single", (128, 128, 128), 4, "f32"),
    ("single", (256, 256, 256), 8, "f64"),
    ("sc", (128, 128, 128), 2, "f32"), ("sc", (128, 128, 128), 4, "f32"),
    ("sc", (256, 256, 256), 4, "f64"),
    ("cg", (128, 128, 128), 2, "f32"), ("cg", (128, 128, 128), 4, "f32"),
    ("cg-split", (256, 256, 256), 4, "f32"), ("cg", (128, 128, 128), 8, "f64")])
def test_plan_schedule_and_budget(family, shape, steps, dtype):
    """The plans of the main paths' sizes keep the schedule's invariants,
    and their live rings fit the budget the plan states (``Plan.budget``,
    with the automatic bands; a plan whose bands could not bring them under
    it with a halo of at most MAX_HALO_SHARE of the band's rows would say
    so, ``fits`` False)."""
    itemsize = 8 if dtype == "f64" else 4
    if family == "single":
        plan = M.single3d_march_plan(shape, steps, itemsize)
    elif family == "sc":
        plan = M.sc3d_march_plan(shape, 2, steps, itemsize)
    else:
        plan = M.cg3d_march_plan(shape, steps, itemsize,
                                 family == "cg-split", 1, 1, True)
    _check_schedule(plan)
    fields = plan.fields()
    assert fields["levels"] == steps and fields["scratch_bytes"] == \
        plan.scratch_bytes
    assert fields["fits"] == (plan.scratch_bytes <= plan.budget)
    if plan.bands > 1:
        assert plan.rows <= M.MAX_HALO_SHARE * plan.band_rows
    if fields["fits"]:
        assert plan.scratch_bytes <= M.RING_BUDGET
    # slabs a level trails the last, Z slabs a wave: K11 one stage of 1 + Z
    # a level, its ring 2 Z + 2 slabs; K10 collide and stream 1 + Z each;
    # K9 with the inlet and the convective cascade 3 + Z, then extrap,
    # normal, collide and stream 1 + Z each
    z = M.SLABS_PER_WAVE
    assert plan.slabs_per_wave == z
    assert fields["lag"] == {"single": 1 + z, "sc": 2 + 2 * z}.get(
        family, 7 + 5 * z)
    if family == "single":
        assert len(plan.stages) == steps + 1 and \
            [st.kind for st in plan.stages] == \
            [M.COLLIDE] + [M.SCOLLIDE] * (steps - 1) + [M.STREAM]
        assert [r.depth for r in plan.rings] == [2 * z + 2] * steps
        assert fields["ring_slabs"] == {"post0": 2 * z + 2}
    assert fields["fits"]


def test_small_domain_schedule():
    """The invariants on the test domains, with 2 slabs a wave too."""
    for z in (1, 2):
        for steps in (1, 2, 4):
            for br in (None, 3, 4):
                _check_schedule(M.sc3d_march_plan(SHAPE, 2, steps, 8, z, br))
                single = M.single3d_march_plan(SHAPE, steps, 8, z, br)
                _check_schedule(single)
                assert single.lag == (1 + z if steps > 1 else 0)
                _check_schedule(M.cg3d_march_plan(SHAPE, steps, 8, True, 1,
                                                  2, True, z, br))


def test_march_model_sees_schedule_faults():
    """A plan whose second level trails the first one slab too little, or
    whose first level leaves out the seam's slabs below 0, gives the model
    wrong or NaN values: the model's snapshot of each wave and its NaN
    rings are what hold the kernels' schedule to T plain steps."""
    m = _sc_model(2)
    f = _sc_start(m, 2)
    want = _plain(m, f, 2)
    short = M.sc3d_march_plan(SHAPE, 2, 2, 8, slabs_per_wave=1)
    collide1 = next(k for k, st in enumerate(short.stages)
                    if st.kind == M.COLLIDE and st.level == 1)
    short.stages[collide1].d -= 1
    short.waves = _rewave(short)
    got = M.sc3d_march_reference(f, m, 2, short)
    assert not _gap(got, want) <= TOL
    seam = M.sc3d_march_plan(SHAPE, 2, 2, 8, slabs_per_wave=1)
    seam.stages[0].lo = 0
    seam.waves = _rewave(seam)
    got = M.sc3d_march_reference(f, m, 2, seam)
    assert not _gap(got, want) <= TOL


def _rewave(plan):
    """The waves of a plan after its stages' d, lo or hi changed."""
    z = plan.slabs_per_wave
    first = min((st.lo + st.d) // z for st in plan.stages)
    last = max((st.hi + st.d) // z for st in plan.stages)
    waves = [[] for _ in range(last - first + 1)]
    for k, st in enumerate(plan.stages):
        for u in range(st.lo, st.hi + 1):
            waves[(u + st.d) // z - first].append((k, u))
    return waves


def test_plan_table_and_refusals():
    """The table the kernel reads: its header, one stage row, ring row and
    entry per stage, ring and (stage, slab); each entry counts its stage's
    rows x nx cells and each wave the most of its entries'.  steps and
    slabs a wave below 1 and band rows outside 1 ... ny raise."""
    plan = M.cg3d_march_plan(SHAPE, 3, 8, False, 1, 1, True, band_rows=4)
    t = plan.tensor()
    h = t[:M.HEADER].tolist()
    ns, nr, nw, ne = h[1:5]
    assert (ns, nr, nw) == (len(plan.stages), len(plan.rings),
                            len(plan.waves))
    assert ne == sum(len(w) for w in plan.waves)
    assert h[5:12] == [plan.bands, plan.band_rows, plan.rows, plan.halo,
                       *SHAPE]
    assert len(t) == M.HEADER + M.STAGE_WORDS * ns + M.RING_WORDS * nr + \
        2 * nw + 1 + 3 * ne
    entries = t[-3 * ne:].reshape(ne, 3)
    ptr = t[M.HEADER + M.STAGE_WORDS * ns + M.RING_WORDS * nr:][:2 * nw + 1]
    for w in range(nw):
        rows = entries[ptr[w]:ptr[w + 1]]
        for k, u, cells in rows.tolist():
            assert (k, u) in plan.waves[w]
            assert cells == plan.stage_rows(plan.stages[k]) * SHAPE[2]
        assert int(ptr[nw + 1 + w]) == int(rows[:, 2].max())
    with pytest.raises(ValueError):
        M.sc3d_march_plan(SHAPE, 2, 0, 8)
    with pytest.raises(ValueError):
        M.sc3d_march_plan(SHAPE, 2, 2, 8, slabs_per_wave=0)
    with pytest.raises(ValueError):
        M.cg3d_march_plan(SHAPE, 2, 8, False, 0, 0, False,
                          band_rows=SHAPE[1] + 1)
    assert dataclasses.is_dataclass(plan)


@pytest.mark.parametrize("edits", ["blocks", "skip", "blocks2d"])
def test_chip_sweep_patches_one_line_a_source(edits):
    """chip_sweep.py times the march on copies of csrc/ with lines changed:
    each march kernel's ``__launch_bounds__`` (its blocks an SM), the row
    march's blocks an SM (``march2d_min_blocks``) or the executor's call of
    the body (a stage skipped).  Each line it changes stays in its source
    exactly once, and the change differs from it."""
    import chip_sweep
    from openlbmpm_torch.kernels import build
    changes = (chip_sweep.min_blocks_edits(1) if edits == "blocks"
               else chip_sweep.min_blocks_edits_2d(4) if edits == "blocks2d"
               else chip_sweep.skip_edits("c.kind() == kStageLoad"))
    assert changes
    for name, (old, new) in changes.items():
        assert (build.SRC_DIR / name).read_text().count(old) == 1
        assert new != old
