"""One run of one cell: set-up, the measured window, the comparison, and
the result as the last line of standard output.

A cell's driver (``drivers/<name>.py``, named by its traffic) provides

- ``END_TO_END``: the end-to-end metrics it reports (a cell's
  ``metric_names`` may give one another name: the same quantity at
  another scale, held to its own bound);
- ``setup(ctx)``: builds the program's objects from the seeded inputs and
  warms up every shape the window uses; returns the driver's state;
- ``window(ctx, st, seconds, tracer)``: runs the traffic for ``seconds``
  (a traced run until ``tracer.done``, then ``tracer.stop``) and returns ``attempted``, ``failed``, ``seconds`` (the window's wall
  time), ``metrics`` (the end-to-end values) and its counters;
- ``finish(ctx, st)``: after the window and the memory reading, frees the
  program's state and fills ``ctx.numbers`` with the comparisons (and,
  traced, ``ctx.positions`` with states sampled along the window).

The per-layer metrics are the readers in ``metrics/``: each returns a
value, or None where it finds nothing to read.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

from . import catalog
from .trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "bevy_gpu_fluid_tpu")
UNITS = {"particle_steps_per_s": "particle-steps/s", "frames_per_s":
         "frames/s", "frame_ms_p95": "ms", "setup_s": "s"}


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock, from
    ``/proc`` (10 ms resolution); now where that is not readable."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return now


class Ctx:
    """What a driver and a metric reader see of the run."""

    def __init__(self, cell: dict, seed: int, device, trace: bool,
                 overrides: dict | None = None):
        self.cell = cell
        self.name = cell["name"]
        self.seed = seed
        self.device = device
        self.trace_on = trace
        self.scene = {**cell["config"], **(overrides or {})}
        self.traffic = {**cell["traffic"], **(overrides or {})}
        self.numbers: dict[str, float] = {}
        self.controls: tuple = (None,)  # None: the program; a dtype: the
        self.readings: dict = {}        # reference at it in its place
        self.check_s = 0.0
        self.window: dict = {}
        self.trace = None
        self.positions: list = []       # (x, y) of states along the window
        self.frame_positions = None     # (x, y) a checked frame rendered
        self.end_to_end: tuple = ()
        self._samples = None

    def log(self, msg: str) -> None:
        print(f"# {self.name}: {msg}", file=sys.stderr, flush=True)

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def checking(self):
        """Time spent judging during set-up, left out of ``setup_s``."""
        t0 = time.perf_counter()
        yield
        self.check_s += time.perf_counter() - t0

    def samples(self) -> list:
        """(n, interacting pairs) of each state sampled along the window,
        counted once."""
        import roofline
        if self._samples is None:
            h = float(self.scene["h"])
            self._samples = [(x.numel(), roofline.pairs_within(x, y, h))
                             for x, y in self.positions]
        return self._samples


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card(chips: int):
    """The first CUDA device, or None (with the reason on stderr) when the
    run cannot have the chips the cell asks for."""
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device (torch.cuda.is_available() is False): the "
              "benchmark runs on the card only", file=sys.stderr)
        return None
    if torch.cuda.device_count() < chips:
        print(f"the cell asks for {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return None
    return torch.device("cuda", 0)


def power_limit() -> float | None:
    """The card's power limit in W, as nvidia-smi reads it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def build_kernels() -> float:
    """Build (first run in a checkout) and load the program's kernel
    library; the build's seconds, 0 when it was there."""
    from bevy_gpu_fluid_tpu_torch.kernels import _build
    _, seconds, _ = _build.build()
    _build.load()
    return seconds


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def per_layer(ctx: Ctx, root=catalog.ROOT) -> dict:
    """Every metric reader's value where it finds something to read."""
    out = {}
    for name in catalog.names("metrics", ".py", root):
        mod = catalog.module("metrics", name, root)
        value = mod.read(ctx)
        if value is not None:
            out[name] = {"value": float(value), "unit": mod.UNIT}
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, each number beside its limit): every number of the cell
    there and within its limit."""
    checks = {k: {"value": numbers.get(k, math.nan), "limit": limits[k]}
              for k in limits}
    correct = all(not math.isnan(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    return correct, checks


def run(args: argparse.Namespace, *, device=None, overrides=None,
        root=catalog.ROOT, control=None) -> tuple[int, dict]:
    """One run of the cell; returns (exit code, result).  ``device`` None
    asks for the card and fails without one; the tests pass a CPU device
    and ``overrides`` (smaller sizes) through this seam.  ``control`` (a
    key of ``checks.CONTROLS``) judges the reference at that precision in
    the program's place instead of the program's outputs."""
    t_start = process_start()
    cell = catalog.cell(args.workload, root)
    if device is None:
        device = card(int(cell["spec"]["chips"]))
        if device is None:
            return 3, {}
    import torch
    ctx = Ctx(cell, args.seed, device, bool(args.trace), overrides)
    if control is not None:
        ctx.controls = (None, control)
    drv = catalog.module("drivers", ctx.traffic["driver"], root)
    names = cell["spec"].get("metric_names", {})
    ctx.end_to_end = tuple(names.get(k, k) for k in drv.END_TO_END)
    if device.type == "cuda":
        ctx.log(f"kernel library built in {build_kernels():.3f} s (0: "
                f"already built)")
    st = drv.setup(ctx)
    ctx.sync()
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        ctx.log(f"set-up's memory peak {setup_peak} bytes; the window's is "
                f"reported")
        torch.cuda.reset_peak_memory_stats(device)
    tracer = Tracer(ctx.trace_on, int(ctx.traffic["trace_episodes"]))
    setup_s = time.perf_counter() - t_start - ctx.check_s
    tracer.start()
    win = drv.window(ctx, st, args.seconds, tracer)
    ctx.window = win
    ctx.trace = tracer.trace
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    t_check = time.perf_counter()
    drv.finish(ctx, st)
    del st
    if control is not None:
        ctx.numbers.update(ctx.readings[control])
    ctx.log(f"the comparison took {time.perf_counter() - t_check:.3f} s")
    if ctx.trace_on:
        metrics = per_layer(ctx, root)
    else:
        metrics = {names.get(k, k): {"value": v, "unit": UNITS[k]}
                   for k, v in win["metrics"].items()}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    correct, checks = judge(ctx.numbers, cell["spec"]["limits"])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": 1, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit()
    result = {"correct": correct, "attempted": int(win["attempted"]),
              "failed": int(win["failed"]), "metrics": metrics,
              "device": dev}
    if ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = checks
    ctx.log(f"window {win['seconds']:.3f} s, {win['attempted']} attempted, "
            f"{win['failed']} failed, setup {setup_s:.3f} s (checks during "
            f"set-up {ctx.check_s:.3f} s), counters "
            f"{ {k: v for k, v in win.items() if k != 'metrics'} }")
    # last, once every reader and the trace's reduction have run
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 4, {}
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0, result


def main(argv=None, **seam) -> int:
    rc, result = run(parse(argv), **seam)
    if rc == 0:
        print(json.dumps(result), flush=True)
    return rc
