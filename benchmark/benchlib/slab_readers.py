"""The readers of the slab cell's own per-layer metrics: the program's halo
and rebin-exchange spans in the slab step (``parallel/shard_verlet.py``),
on the host's clock, the device time of what the halos launched, and the
step kernels' shares of their rooflines summed over the slabs.  Each
reads only in a traced run of a cell that reports
``particle_steps_per_s``; where the program has no such span (a program
from before them, or a cell that runs no slabs) it returns None."""

from __future__ import annotations

import numpy as np
import roofline
import torch

from . import readers, spans
from .trace import _kind

MOVES = "particle_steps_per_s"
HALO = "bgf.halo"
EXCHANGE = "bgf.rebin.exchange"


def launched_in(events, trace, name: str):
    """Device seconds of the operations whose launch lies in one of the
    ``name`` ranges of the window, over the profiler's raw ``events`` and
    the window's reduced ``trace``; None where no range or no such
    operation is found.  An operation is matched to the runtime call that
    launched it by the runtime's correlation id alone, as
    ``ceiling_readers.launched_in`` matches the rebin's: the CPU
    operators' ids share the same small numbers."""
    iv = np.array([(s, e) for n, s, e, *_ in trace.cpu if n == name],
                  dtype=np.int64).reshape(-1, 2)
    if not iv.size:
        return None
    cpu = torch.autograd.DeviceType.CPU
    runtime = {e.correlation_id(): e.start_ns() for e in events
               if e.device_type() == cpu and e.name().startswith("cu")}
    ns = [e.duration_ns() for e in events
          if e.device_type() != cpu and not e.name().startswith("bench.")
          and "annotation" not in _kind(e)
          and e.correlation_id() in runtime
          and bool(((iv[:, 0] <= runtime[e.correlation_id()])
                    & (runtime[e.correlation_id()] <= iv[:, 1])).any())]
    return 1e-9 * sum(ns) if ns else None


def halo_host_us(ctx):
    """Host microseconds a step inside the halo spans, less their syncs."""
    s = spans.host_seconds(ctx, MOVES, HALO, "steps", less_syncs=True)
    return None if s is None else 1e6 * s


def halo_device_us(ctx):
    """Device microseconds a step of the operations the halos launched."""
    seconds = ctx.window.get("halo_device_s")
    if ctx.trace is None or MOVES not in ctx.end_to_end or seconds is None \
            or not ctx.window.get("steps"):
        return None
    return 1e6 * seconds / ctx.window["steps"]


def exchange_host_us(ctx):
    """Host microseconds a rebin inside the rebin's exchange span."""
    s = spans.host_seconds(ctx, MOVES, EXCHANGE, "rebins")
    return None if s is None else 1e6 * s


def kernel_share(ctx, kernel: str):
    """% of its roofline a step kernel reaches in the slab step: the least
    time of one launch on the whole state (sampled along the window) over
    a step's device time of the kernel, which launches once a slab (its
    mean launch times the slabs)."""
    if ctx.trace is None or MOVES not in ctx.end_to_end \
            or "slabs" not in ctx.scene:
        return None
    pattern, work = readers.KERNELS[kernel]
    launches, mean_s = ctx.trace.kernel(pattern)
    if not launches:
        return None
    least = roofline.mean_work([work(n, p) for n, p in ctx.samples()])
    return roofline.share(least.least_s, mean_s * int(ctx.scene["slabs"]))
