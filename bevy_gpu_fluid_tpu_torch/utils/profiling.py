"""Timing and throughput observability (port of
``bevy_gpu_fluid_tpu/utils/profiling.py``).

``StepTimer`` accumulates wall time and step counts around work that ends
in a device synchronisation: CUDA launches return before the card has run
them, so the timer synchronises the device of the result it is handed (a
no-op for CPU tensors) before it reads the clock.  ``trace`` records a
``torch.profiler`` trace (host and, where a card is present, device
activity) and writes it as a Chrome trace for kernel-level attribution.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time

import torch


def _devices(result) -> set:
    """The CUDA devices of every tensor in ``result`` (a tensor, a list,
    tuple or dict of them, or a dataclass holding them)."""
    if isinstance(result, torch.Tensor):
        return {result.device} if result.is_cuda else set()
    if dataclasses.is_dataclass(result) and not isinstance(result, type):
        result = [getattr(result, f.name) for f in dataclasses.fields(result)]
    elif isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        return set().union(*(_devices(r) for r in result)) if result \
            else set()
    return set()


def block_until_ready(result):
    """Wait until the devices holding ``result``'s tensors have finished
    all queued work (``jax.block_until_ready``'s counterpart); returns
    ``result``."""
    for dev in _devices(result):
        torch.cuda.synchronize(dev)
    return result


class StepTimer:
    """Accumulates wall time and step counts; reports steps/s and
    particle-steps/s (the bench metric, BASELINE.json)."""

    def __init__(self, n_particles: int):
        self.n = n_particles
        self.steps = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def measure(self, n_steps: int, result=None):
        """Time the ``with`` block as ``n_steps`` steps.  ``result`` (any
        tensor the block's work ends in, or a container of them) is
        synchronised before the clock stops; a block that leaves launches
        queued without naming their result times their enqueue only."""
        t0 = time.perf_counter()
        yield
        block_until_ready(result)
        self.seconds += time.perf_counter() - t0
        self.steps += n_steps

    def time_block(self, fn, *args):
        """Run fn(*args) -> result and add its time, the result's devices
        synchronised; the call counts no steps (add them to ``steps``)."""
        t0 = time.perf_counter()
        out = block_until_ready(fn(*args))
        self.seconds += time.perf_counter() - t0
        return out

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.seconds if self.seconds else 0.0

    @property
    def particle_steps_per_sec(self) -> float:
        return self.steps_per_sec * self.n

    def summary(self) -> str:
        return (f"{self.steps} steps in {self.seconds:.3f}s = "
                f"{self.steps_per_sec:.1f} steps/s, "
                f"{self.particle_steps_per_sec / 1e6:.2f}M particle-steps/s")


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` over the ``with`` block: host activity, and the
    card's where one is present.  On the way out the devices are
    synchronised and the trace is written to ``log_dir/trace.json``
    (default: ``bgf-torch-trace`` under the temporary directory), a Chrome
    trace (chrome://tracing, Perfetto).  Yields the profiler, whose
    ``key_averages()`` sums the time by operator and kernel."""
    from torch.profiler import ProfilerActivity, profile
    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "bgf-torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
