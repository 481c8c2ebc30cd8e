"""Shared model infrastructure: the chunked run loop (counterpart of
``openlbmpm_tpu/models/base.py``).

PyTorch runs eagerly, so a chunk is a plain Python loop of ``step_fn``
calls; the host waits for the device only at the end of each chunk (the
I/O cadence), where the callback, the NaN guard and the throughput meter
run.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable

import torch

__all__ = ["RunMetrics", "run_chunked", "block_args", "t_step",
           "kernel_block_step"]


class RunMetrics:
    """Throughput meter: wall clock, steps/s and MLUPS (million lattice-site
    updates per second over `active_sites`)."""

    def __init__(self, active_sites: int):
        self.active_sites = int(active_sites)
        self.steps = 0
        self.elapsed = 0.0

    def update(self, steps: int, seconds: float):
        self.steps += steps
        self.elapsed += seconds

    @property
    def mlups(self) -> float:
        if self.elapsed == 0:
            return 0.0
        return self.active_sites * self.steps / self.elapsed / 1e6

    @property
    def steps_per_s(self) -> float:
        return self.steps / self.elapsed if self.elapsed else 0.0


def _tensors(state):
    if torch.is_tensor(state):
        return [state]
    return [t for t in state if torch.is_tensor(t)]


def _synchronize(state):
    for dev in {t.device for t in _tensors(state) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def run_chunked(
    step_fn: Callable[[Any], Any],
    state: Any,
    num_steps: int,
    io_interval: int,
    callback: Callable[[int, Any], bool | None] | None = None,
    metrics: RunMetrics | None = None,
    profile_dir: str | None = None,
    nan_guard: bool = False,
):
    """Advance `state` (a tensor or a tuple of tensors) by `num_steps`,
    waiting for the device every `io_interval` steps.

    callback(step, state) runs at that cadence; returning True stops the
    run.  `metrics` accumulates the wall time of each chunk, measured up to
    a device synchronisation.  With `profile_dir`, the second chunk is
    traced with ``torch.profiler`` into ``<profile_dir>/trace.json``.
    `nan_guard` checks the state for non-finite values at the cadence and
    raises FloatingPointError with the step range.  Returns the final
    state.  (The JAX runner's `donate` argument has no counterpart: the
    steps here return new tensors and never overwrite their input.)
    """
    io_interval = max(1, min(io_interval, num_steps)) if num_steps else 1
    if callback is not None and callback(0, state):
        return state
    done = 0
    chunk_idx = 0
    while done < num_steps:
        n = min(io_interval, num_steps - done)
        prof = None
        if profile_dir is not None and chunk_idx == 1:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if any(t.is_cuda for t in _tensors(state)):
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        t0 = time.perf_counter()
        for _ in range(n):
            state = step_fn(state)
        _synchronize(state)
        dt = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        done += n
        chunk_idx += 1
        if nan_guard and not all(bool(torch.isfinite(t).all())
                                 for t in _tensors(state)
                                 if t.is_floating_point()):
            raise FloatingPointError(
                f"non-finite state between steps {done - n} and {done} "
                "(diverged run: check tau > 0.5, surface tension and "
                "inlet velocity)")
        if metrics is not None:
            metrics.update(n, dt)
        if callback is not None and callback(done, state):
            break
    return state


# -- T steps a call (the models' make_block_step) ----------------------------

def block_args(steps_per_call, storage: str) -> int:
    """The T of a ``make_block_step`` call, after checking its
    ``steps_per_call`` (>= 1) and ``storage`` (f32 | bf16)."""
    t = int(steps_per_call)
    if t < 1:
        raise ValueError(f"steps_per_call {steps_per_call!r}: >= 1")
    if storage not in ("f32", "bf16"):
        raise ValueError(f"storage {storage!r}: f32 | bf16")
    return t


def t_step(kernel, model, t: int):
    """``kernel(state, model, t)`` as a step function of `t` time steps a
    call (its ``steps_per_call``)."""
    def block_step(state):
        return kernel(state, model, t)

    block_step.steps_per_call = t
    return block_step


def kernel_block_step(model, steps_per_call, storage: str, takes: bool,
                      kernel):
    """``make_block_step`` of a model with one state tensor and a float32
    bf16 pack (Shan-Chen and single-phase, D2Q9 and D3Q19): None unless
    `takes` (the model's kernel rule), ``model.step`` for T = 1 in the
    model's own storage, else `kernel`'s T steps a call (``t_step``)."""
    t = block_args(steps_per_call, storage)
    if not takes:
        return None
    if storage == "bf16" and model.dtype != torch.float32:
        raise ValueError("storage='bf16' computes in float32")
    if t == 1 and storage == model.storage:
        return model.step
    return t_step(kernel, model, t)
