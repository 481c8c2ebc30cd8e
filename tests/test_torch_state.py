"""Parameters and states carried across from the JAX package
(``openlbmpm_torch/convert.py``), and the run loop
(``models/base.py::run_chunked``): callback contract, metrics, profiler
trace and NaN guard."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openlbmpm_torch.convert import (
    params_from_jax, state_from_numpy, state_to_numpy)
from openlbmpm_torch.models.base import RunMetrics, run_chunked
from test_torch_csf import GOLDEN_BCS, GOLDEN_PARAMS, _models

torch.set_num_threads(1)


def test_convert_roundtrip():
    for p in (GOLDEN_PARAMS, GOLDEN_BCS):
        q = params_from_jax(p)
        assert dataclasses.asdict(q) == dataclasses.asdict(p)
    with pytest.raises(TypeError):
        params_from_jax(object())
    mj, _ = _models(GOLDEN_PARAMS, GOLDEN_BCS)
    f_r, f_b = (np.asarray(a) for a in mj.init_state_layers(1.0, 1.0, 10))
    s10 = np.asarray(mj.pack_state(jnp.asarray(f_r), jnp.asarray(f_b)))
    s11 = np.asarray(mj.pack_state_bf16(jnp.asarray(f_r), jnp.asarray(f_b)))
    for arr in (s10, s11):
        t = state_from_numpy(arr, "cpu")
        back = state_to_numpy(t)
        assert back.dtype == arr.dtype and back.shape == arr.shape
        np.testing.assert_array_equal(back.view(np.uint8), arr.view(np.uint8))
    pair = state_from_numpy((f_r, f_b), "cpu", dtype="float32")
    assert isinstance(pair, tuple) and pair[0].dtype == torch.float32
    back = state_to_numpy(pair)
    np.testing.assert_array_equal(back[1], f_b.astype(np.float32))


def test_run_chunked_contract_and_nan_guard(tmp_path):
    _, mt = _models(GOLDEN_PARAMS, GOLDEN_BCS)
    s = mt.pack_state(*mt.init_state_layers(1.0, 1.0, invading_rows=10))
    seen = []
    meter = RunMetrics(48 * 24)

    def cb(step, state):
        seen.append(step)
        return step >= 6

    out = run_chunked(mt.step_c, s, num_steps=10, io_interval=3,
                      callback=cb, metrics=meter, nan_guard=True)
    assert seen == [0, 3, 6]
    assert meter.steps == 6 and meter.mlups > 0
    ref = s
    for _ in range(6):
        ref = mt.step_c(ref)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    run_chunked(mt.step_c, s, num_steps=4, io_interval=2,
                profile_dir=str(tmp_path))
    assert (tmp_path / "trace.json").stat().st_size > 0
    bad = s.clone()
    bad[3, 20, 5] = float("nan")
    with pytest.raises(FloatingPointError, match="steps 0 and 2"):
        run_chunked(mt.step_c, bad, num_steps=4, io_interval=2,
                    nan_guard=True)
