"""50-step trajectories of the port's split coupled step against the JAX
package's, on the CPU at f64.

The port's ``TransportRK.step`` (plain) runs 50 steps beside the JAX
``TransportRK._step_impl`` under ``jax.jit`` (un-jitted JAX takes 6-13 s
for 50 steps of one case).  Tolerance 1e-10: XLA's fusion reassociates the
f64 arithmetic, which leaves the trajectories 2e-16 to 2e-13 apart after
50 steps, and 2.1e-11 with conserve_mass, whose renormalisation adds about
the initial mass each step, so its values grow to about 50 times their
start.  Per-step agreement to 1e-12 against the un-jitted step is in
``tests/test_torch_transport.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openlbmpm_tpu import geometry as geo
from openlbmpm_tpu.models import colorgradient as jcg
from openlbmpm_tpu.models import transport as jtr
from openlbmpm_torch.convert import params_from_jax
from openlbmpm_torch.models.transport import TransportRK, TransportState
from chip_smoke import coupled_conc0, flagship_flow, split_coupled_cases

torch.set_num_threads(1)
CPU = "cpu"   # the port's models run on the card unless told otherwise

FLOW, BCS = flagship_flow()
FLOW_J = jcg.ColorGradientParams(**dataclasses.asdict(FLOW))
BCS_J = jcg.CGBoundaryConfig(**dataclasses.asdict(BCS))
CASES = split_coupled_cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_coupled_trajectory_matches_jax_f64_50_steps(case):
    kw, tp = CASES[case]
    n = 32
    solid = np.zeros((n, n), bool)
    solid[:, 0] = solid[:, -1] = True
    g = geo.from_solid_mask(solid)
    tpj = jtr.TransportParams(**tp)
    mj = jtr.TransportRK(g, FLOW_J, tpj, BCS_J, dtype=jnp.float64,
                         use_pallas=False, **kw)
    mt = TransportRK(g, params_from_jax(FLOW_J), params_from_jax(tpj),
                     params_from_jax(BCS_J), dtype=torch.float64, device=CPU,
                     **kw)
    sj = mj.init_state(mj.flow.init_state_layers(1.0, 1.0, n // 5),
                       coupled_conc0(tpj.num_tracers, n, n))
    st = TransportState(*(torch.from_numpy(np.array(a)) for a in sj))
    step = jax.jit(mj._step_impl)
    for _ in range(50):
        sj = step(sj)
        st = mt.step(st)
    assert all(bool(torch.isfinite(x).all()) for x in st[:3])
    for a, b in zip(st[:3], sj[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10)
