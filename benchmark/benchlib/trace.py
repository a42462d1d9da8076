"""The benchmark's spans and the device trace of a ``--trace 1`` run.

Spans are ``torch.profiler.record_function`` ranges named ``bench.*``
around the benchmark's calls into the program; with tracing off they cost
nothing.  ``Tracer`` runs the profiler over a traced run's window, which
ends after its first few episodes, and reduces its events: the union of
the device's operations (busy time), each operation's launch matched to
the span the host was in (by the runtime call's correlation id), and the
idle gaps named by what the host was doing when each began.
"""

from __future__ import annotations

import contextlib
import re

import numpy as np
import torch

WINDOW_SPAN = "bench.traced"


class Tracer:
    """Spans, and the profiler over the window's ``episodes`` when on."""

    def __init__(self, on: bool, episodes: int):
        self.on = on
        self.episodes = episodes
        self.prof = None
        self.trace = None
        self._span = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def start(self) -> None:
        """Start the profiler before the window, so that its own start-up
        stays out of it."""
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def begin(self, episode: int) -> None:
        """Open the traced window's span at the window's first episode."""
        if self.prof is not None and episode == 0:
            self._span = torch.profiler.record_function(WINDOW_SPAN)
            self._span.__enter__()

    def done(self, episodes: int) -> bool:
        """Whether a traced window has run its episodes: it reports no
        end-to-end metric, so it ends there."""
        return self.on and episodes >= self.episodes

    def stop(self, sync) -> None:
        """Stop the profiler at the window's end and reduce its events."""
        if self.prof is None:
            return
        sync()
        self._span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.trace = Trace(self.prof.profiler.kineto_results.events())
        self.prof = None


def _kind(e) -> str:
    try:
        return str(e.activity_type()).lower()
    except (AttributeError, RuntimeError):
        return ""


class Trace:
    """The reduced events of one traced window."""

    def __init__(self, events):
        cpu, dev = [], []
        for e in events:
            rec = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() == torch.autograd.DeviceType.CPU:
                cpu.append((*rec, e.correlation_id(), e.start_thread_id()))
            elif not e.name().startswith("bench.") \
                    and "annotation" not in _kind(e):
                dev.append((*rec, e.correlation_id(),
                            e.linked_correlation_id()))
        win = [c for c in cpu if c[0] == WINDOW_SPAN]
        if not win:
            raise RuntimeError("the traced window's span is missing")
        self.t0, self.t1, _, self.thread = win[0][1:]
        self.window_s = (self.t1 - self.t0) * 1e-9
        self.cpu = sorted((c for c in cpu if c[4] == self.thread
                           and c[2] > self.t0 and c[1] < self.t1),
                          key=lambda c: (c[1], -c[2]))
        launch = {c[3]: c[1] for c in cpu if c[3]}
        self.ops = []          # (name, start, end, host launch time)
        for name, s, e, corr, linked in dev:
            s, e = max(s, self.t0), min(e, self.t1)
            if e > s:
                self.ops.append((name, s, e,
                                 launch.get(corr, launch.get(linked))))
        self.spans = [c for c in self.cpu if c[0].startswith("bench.")]
        self._busy = self._union()

    def _union(self) -> list[tuple[int, int]]:
        out: list[list[int]] = []
        for _, s, e, _ in sorted(self.ops, key=lambda o: o[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(iv) for iv in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy) * 1e-9

    def kernel(self, pattern: str) -> tuple[int, float]:
        """(launches, mean device seconds a launch) of the operations whose
        name matches ``pattern``."""
        rx = re.compile(pattern)
        d = [e - s for name, s, e, _ in self.ops if rx.search(name)]
        return len(d), (sum(d) / len(d) * 1e-9 if d else 0.0)

    def under(self, span: str) -> float | None:
        """Device seconds of the operations launched inside ``span``; None
        where none was."""
        iv = np.array([(s, e) for name, s, e, *_ in self.spans
                       if name == span], dtype=np.int64).reshape(-1, 2)
        found = [e - s for _, s, e, at in self.ops
                 if at is not None and iv.size
                 and bool(((iv[:, 0] <= at) & (at <= iv[:, 1])).any())]
        return sum(found) * 1e-9 if found else None

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        summed by what the host was doing when each gap began (the
        innermost benchmark span / the innermost host operation)."""
        by_op: dict[str, float] = {}
        for name, s, e, _ in self.ops:
            by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-9
        gaps = []
        prev = self.t0
        for s, e in self._busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        by_host: dict[str, float] = {}
        stack: list = []
        i = 0
        for s, e in gaps:
            while i < len(self.cpu) and self.cpu[i][1] <= s:
                stack.append(self.cpu[i])
                i += 1
            stack = [c for c in stack if c[2] >= s]
            span = next((c[0] for c in reversed(stack)
                         if c[0].startswith("bench.")
                         and c[0] != WINDOW_SPAN), "bench")
            op = next((c[0] for c in reversed(stack)
                       if not c[0].startswith("bench.")), "python")
            key = f"{span} / {op}"
            by_host[key] = by_host.get(key, 0.0) + (e - s) * 1e-9

        def ranked(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                    [:top]]
        return dict(device_ops=ranked(by_op), idle_gaps=ranked(by_host))
