"""The readers of the memory-ceiling cell's own per-layer metrics.  Each
reads only in a traced run of a cell that reports
``particle_steps_per_s.large`` and whose traffic reports the ceiling
posture among its counters (``planar_rebin``, ``refless_trigger`` and
``donate`` all chosen); elsewhere, and where it finds nothing to read, it
returns None."""

from __future__ import annotations

import numpy as np
import torch

import roofline
import roofline_ceiling

from .trace import _kind

MOVES = "particle_steps_per_s.large"
POSTURE = ("planar_rebin", "refless_trigger", "donate")
KERNELS = {"k2r": (r"\bforces_integrate_kernel<true\b", roofline_ceiling.k2r),
           "k6": (r"\bselect_kernel\b", roofline_ceiling.k6),
           "k7": (r"\bapply_code_kernel\b", roofline_ceiling.k7)}
REBIN = "bgf.rebin"


def ceiling(ctx) -> bool:
    """A traced run of a large-N step cell in the ceiling posture."""
    return (ctx.trace is not None and MOVES in ctx.end_to_end
            and all(ctx.window.get(k) for k in POSTURE))


def kernel_share(ctx, kernel: str):
    """% of its roofline a launch of ``kernel`` reaches: the least time on
    the states sampled around the window over its mean device time."""
    if not ceiling(ctx):
        return None
    pattern, work = KERNELS[kernel]
    launches, mean_s = ctx.trace.kernel(pattern)
    if not launches or not ctx.positions:
        return None
    least = roofline.mean_work([work(n, p) for n, p in ctx.samples()])
    return roofline.share(least.least_s, mean_s)


def rebin_device_ms(ctx):
    """Device ms a rebin of the operations launched inside the program's
    ``bgf.rebin`` spans, as ``drivers/continuous_steps.py`` matched them
    in the traced window's raw events (``launched_in``)."""
    if not ceiling(ctx):
        return None
    return ctx.window.get("rebin_device_ms")


def launched_in(events, trace):
    """Device ms per ``bgf.rebin`` range of the operations whose launch
    lies in one, over the profiler's raw ``events`` and the window's reduced
    ``trace``; None where no range or no such operation is found.  A
    device operation is matched to the runtime call that launched it
    (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) by the runtime's
    correlation id alone: ``Trace``'s launch map also takes the CPU
    operators' ids, which share the same small numbers, and put one K2 or
    K1 launch in every ceiling rebin (172 against 94 ms a rebin at 779M
    particles on an H100)."""
    iv = np.array([(s, e) for name, s, e, *_ in trace.cpu if name == REBIN],
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
    return 1e-6 * sum(ns) / iv.shape[0] if ns else None
