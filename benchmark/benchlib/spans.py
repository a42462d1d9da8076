"""The program's own spans in a traced window, and the per-layer metrics
that read them.

The program marks its host work with ``record_function`` ranges named
``bgf.*`` (``bevy_gpu_fluid_tpu_torch.utils.profiling.span``): a step, the
trigger read, a rebin and its counter reads, the eager binning and its
overflow read, the raster, the frame pump's copy and wait.  They land in
the benchmark's one profiler trace, on the clock of the device's
operations.  ``reduce`` sums them over the window's thread; a program that
has no such spans gives an empty reduction, and every reader here then
returns None.
"""

from __future__ import annotations

import functools

PREFIX = "bgf."
SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize",
         "cudaDeviceSynchronize")


@functools.lru_cache(maxsize=1)
def reduce(trace) -> dict:
    """For each ``bgf.*`` name, its ranges that lie inside the window:
    ``count``, ``seconds`` (their summed durations), ``syncs`` and
    ``sync_seconds`` (the runtime's synchronisation calls nested in them,
    at any depth).  ``"*"`` holds the synchronisation calls inside any
    ``bgf.*`` range, each counted once."""
    out: dict[str, dict] = {}
    every = {"syncs": 0, "sync_seconds": 0.0}
    open_: list = []          # (name, end) of the bgf.* ranges still open
    for name, start, end, *_ in trace.cpu:       # by start, outer first
        open_ = [r for r in open_ if r[1] > start]
        if name.startswith(PREFIX) and start >= trace.t0 \
                and end <= trace.t1:
            r = out.setdefault(name, {"count": 0, "seconds": 0.0,
                                      "syncs": 0, "sync_seconds": 0.0})
            r["count"] += 1
            r["seconds"] += (end - start) * 1e-9
            open_.append((name, end))
        elif name in SYNCS:
            inside = {n for n, e in open_ if e >= end}
            if not inside:
                continue
            s = (end - start) * 1e-9
            for r in [every, *(out[n] for n in inside)]:
                r["syncs"] += 1
                r["sync_seconds"] += s
    if out:
        out["*"] = every
    return out


def _found(ctx, moves: str, name: str, per: str):
    """(the span's reduction, the window's count of ``per``), or None
    unless the run was traced, its cell reports ``moves``, the span is in
    the window and ``per`` was counted there."""
    if ctx.trace is None or moves not in ctx.end_to_end \
            or not ctx.window.get(per):
        return None
    span = reduce(ctx.trace).get(name)
    return None if span is None else (span, ctx.window[per])


def host_seconds(ctx, moves: str, name: str, per: str,
                 less_syncs: bool = False):
    """Seconds of ``name``'s ranges per ``per`` (steps, rebins, frames) of
    the window; ``less_syncs`` leaves out the time its ranges spent in the
    runtime's synchronisation calls."""
    found = _found(ctx, moves, name, per)
    if found is None:
        return None
    span, count = found
    seconds = span["seconds"] - (span["sync_seconds"] if less_syncs else 0)
    return seconds / count


def syncs_per_kstep(ctx, moves: str):
    """The runtime's synchronisation calls inside the program's spans per
    1,000 steps of the window."""
    found = _found(ctx, moves, "bgf.step", "steps")
    if found is None:
        return None
    return 1e3 * reduce(ctx.trace)["*"]["syncs"] / found[1]
