"""What the per-layer metrics' readers (``metrics/<name>.py``) share: each
reads its number in the cells that report the end-to-end metric it moves
(``moves``), from the trace, the program's counters or the states sampled
along the window, and returns None where it finds nothing to read."""

from __future__ import annotations

import roofline

KERNELS = {"k1": (r"\bdensity_kernel\b", roofline.k1),
           "k2": (r"\bforces_integrate_kernel\b", roofline.k2),
           "k8": (r"\bforces_kernel\b", roofline.k8)}
K4 = r"\bfield_(cell|tile)_kernel\b"


def _traced(ctx, moves: str) -> bool:
    return ctx.trace is not None and moves in ctx.end_to_end


def idle_share(ctx, moves: str):
    """% of the traced window in which no operation ran on the card."""
    if not _traced(ctx, moves):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def kernel_share(ctx, moves: str, kernel: str):
    """% of its roofline a step kernel reaches: the least time of a launch
    on the states sampled along the window over its mean device time."""
    if not _traced(ctx, moves):
        return None
    pattern, work = KERNELS[kernel]
    launches, mean_s = ctx.trace.kernel(pattern)
    if not launches:
        return None
    least = roofline.mean_work([work(n, p) for n, p in ctx.samples()])
    return roofline.share(least.least_s, mean_s)


def k4_share(ctx, moves: str):
    """% of its roofline K4 reaches on a checked frame's particles."""
    if not _traced(ctx, moves) or ctx.frame_positions is None:
        return None
    launches, mean_s = ctx.trace.kernel(K4)
    if not launches:
        return None
    x, y = ctx.frame_positions
    work = roofline.frame(x, y, ctx.scene, int(ctx.traffic["px_per_cell"]))
    return roofline.share(work.least_s, mean_s)


def raster_ms(ctx, moves: str):
    """Device ms a frame of the operations launched inside the span
    around ``Session.frame``."""
    frames = ctx.window.get("frames", 0)
    if not _traced(ctx, moves) or not frames:
        return None
    seconds = ctx.trace.under("bench.frame")
    return None if seconds is None else 1e3 * seconds / frames


def rebins_per_kstep(ctx, moves: str):
    """The Session's rebins (``rebin_count``) over the window per 1,000
    steps."""
    if not ctx.trace_on or moves not in ctx.end_to_end \
            or "rebins" not in ctx.window:
        return None
    return 1e3 * ctx.window["rebins"] / ctx.window["steps"]
