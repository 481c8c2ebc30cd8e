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

__all__ = ["RunMetrics", "run_chunked"]


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
