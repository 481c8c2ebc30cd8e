"""The kernel module ``openlbmpm_torch/kernels/csf.py`` on the CPU.

* its plain version, ``csf_step_compressed_reference``, against the Pallas
  kernel it replaces (``build_csf_fused_step``, compressed, in-kernel BC
  rows, T=1) in interpret mode at f64;
* ``geo_stack`` against the Pallas module's;
* the bf16 state: packing bit for bit against JAX, and the bf16 step as
  the f32 step between unpack and pack (what the CUDA kernel does in
  registers);
* the wrapper: a CPU tensor takes the plain version and is not counted as
  a launch.

The CUDA kernel itself is checked on a card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openlbmpm_tpu.models import colorgradient as jcg
from openlbmpm_tpu.pallas.csf import build_csf_fused_step
from openlbmpm_tpu.pallas.csf import geo_stack as jax_geo_stack
from openlbmpm_torch.convert import (
    params_from_jax, state_from_numpy, state_to_numpy)
from openlbmpm_torch.kernels.csf import (
    compare_bf16_states, csf_step_compressed, csf_step_compressed_reference,
    geo_stack)
from openlbmpm_torch.models.colorgradient import ColorGradientRK
from test_torch_csf import GOLDEN_BCS, GOLDEN_PARAMS, _models, _walled

torch.set_num_threads(1)


def test_reference_matches_pallas_interpret_f64():
    """The kernel's plain version == the Pallas kernel it replaces
    (compressed, in-kernel BC rows, T=1) run in interpret mode."""
    g = _walled(32, 32)
    mj = jcg.ColorGradientRK(g, GOLDEN_PARAMS, GOLDEN_BCS, dtype=jnp.float64,
                             use_pallas=False)
    pallas = build_csf_fused_step(g, GOLDEN_PARAMS, jnp.float64,
                                  rows_per_block=8, bc_config=GOLDEN_BCS,
                                  state_mode="compressed", interpret=True)
    mt = ColorGradientRK(g, params_from_jax(GOLDEN_PARAMS),
                         params_from_jax(GOLDEN_BCS), dtype=torch.float64)
    s = mj.pack_state(*mj.init_state_layers(1.0, 1.0, invading_rows=8))
    st = torch.from_numpy(np.array(s))
    for _ in range(2):
        s = pallas(s)
        st = csf_step_compressed_reference(st, mt)
    np.testing.assert_allclose(st.numpy(), np.asarray(s), rtol=0, atol=1e-12)


def test_geo_stack_matches_jax():
    g = _walled(16, 12)
    g.is_solid[5:8, 4:6] = True
    np.testing.assert_array_equal(geo_stack(g), jax_geo_stack(g))


def _bf16_models():
    g = _walled(32, 24)
    mj = jcg.ColorGradientRK(g, GOLDEN_PARAMS, GOLDEN_BCS, dtype=jnp.float32,
                             use_pallas=False)
    mt = ColorGradientRK(g, params_from_jax(GOLDEN_PARAMS),
                         params_from_jax(GOLDEN_BCS), dtype=torch.float32,
                         storage="bf16")
    rng = np.random.default_rng(7)
    f_r, f_b = (np.asarray(a) for a in mj.init_state_layers(
        1.0, 1.0, invading_rows=10))
    fl = g.is_fluid.astype(np.float32)
    f_r = (f_r + rng.uniform(0, 2e-3, f_r.shape) * fl).astype(np.float32)
    f_b = (f_b + rng.uniform(0, 2e-3, f_b.shape) * fl).astype(np.float32)
    return mj, mt, f_r, f_b


def test_pack_state_bf16_bitexact_and_roundtrip():
    mj, mt, f_r, f_b = _bf16_models()
    hj = state_to_numpy(state_from_numpy(
        np.asarray(mj.pack_state_bf16(jnp.asarray(f_r), jnp.asarray(f_b)))))
    ht = mt.pack_state_bf16(torch.from_numpy(f_r), torch.from_numpy(f_b))
    assert ht.dtype == torch.bfloat16 and ht.shape == (11, 32, 24)
    np.testing.assert_array_equal(ht.view(torch.int16).numpy(),
                                  hj.view(np.int16))
    s = mt.pack_state(torch.from_numpy(f_r), torch.from_numpy(f_b))
    rt = mt.unpack_bf16(ht)
    np.testing.assert_array_equal(
        rt.numpy(), np.asarray(mj.unpack_bf16(jnp.asarray(hj))))
    assert float((rt[:9] - s[:9]).abs().max()) < 2e-3
    assert float((rt[9] - s[9]).abs().max()) < 2e-5


def test_bf16_step_is_f32_step_between_pack_and_unpack():
    _, mt, f_r, f_b = _bf16_models()
    h = mt.pack_state_bf16(torch.from_numpy(f_r), torch.from_numpy(f_b))
    out = mt.step_c(h)
    assert out.dtype == torch.bfloat16 and out.shape == h.shape
    mt32 = ColorGradientRK(mt.geo, mt.p, mt.bcs, dtype=torch.float32)
    want = mt.pack_compressed_bf16(mt32.step_c(mt.unpack_bf16(h)))
    np.testing.assert_array_equal(out.view(torch.int16).numpy(),
                                  want.view(torch.int16).numpy())


def test_compare_bf16_states_sees_encoding_faults():
    """The one-step bf16 check of the CUDA kernel (chip_smoke.py,
    test_torch_cuda.py) passes the plain step's own encoding and fails a
    round-toward-zero encoding and a dropped lo plane of rho_r."""
    _, mt, f_r, f_b = _bf16_models()
    h = mt.pack_state_bf16(torch.from_numpy(f_r), torch.from_numpy(f_b))
    x = mt.plain_step_c(mt.unpack_bf16(h))
    good = mt.pack_compressed_bf16(x)

    def rz(v):
        return (v.view(torch.int32) & ~0xFFFF).view(torch.float32) \
            .to(torch.bfloat16)

    w = torch.as_tensor(mt.lat.w, dtype=x.dtype).reshape(-1, 1, 1)
    hi = rz(x[9])
    bad_round = torch.cat([rz(x[:9] - w * mt.fluid_mask), hi[None],
                           rz(x[9] - hi.float())[None]])
    no_lo = good.clone()
    no_lo[10] = 0
    everywhere = torch.ones(mt.geo.shape, dtype=torch.bool)
    same = compare_bf16_states(mt.step_c(h), good, everywhere)
    assert same == {"excess": 0.0, "share": 0.0, "hi_flips": 0}
    assert compare_bf16_states(bad_round, good, everywhere)["share"] > 1e-2
    assert compare_bf16_states(no_lo, good, everywhere)["excess"] > 10


def test_wrapper_on_cpu_is_plain_and_uncounted():
    _, mt = _models(GOLDEN_PARAMS, GOLDEN_BCS)
    s = mt.pack_state(*mt.init_state_layers(1.0, 1.0, invading_rows=10))
    before = csf_step_compressed.launches
    np.testing.assert_array_equal(csf_step_compressed(s, mt).numpy(),
                                  csf_step_compressed_reference(s, mt).numpy())
    assert csf_step_compressed.launches == before
    with pytest.raises(ValueError, match="device"):
        csf_step_compressed(s.to("meta"), mt)
