"""Pipelined frame consumption: one frame in flight (port of
``bevy_gpu_fluid_tpu/render/pump.py``).

A naive frame loop serializes: reading frame k back to the host waits for
its compute and its copy before frame k+1 is even enqueued.
``FramePump.push(img_k)`` instead starts frame k's hand-off and returns
frame k-1, whose copy ran while frame k was enqueued and computed.  The
consumer sees every frame exactly once, one push late; ``flush`` drains
the last one.

* ``pull=True``: a CUDA frame is copied ``non_blocking`` into a fresh
  pinned host buffer and a CUDA event is recorded behind the copy; the next
  push waits on that event and returns the buffer as a numpy array.  Every
  frame gets its own buffer, so no array handed out is ever overwritten by
  a later copy.
* ``pull=False``: the device tensor itself comes back one frame late,
  after the event recorded behind its producer has completed (the
  on-device streaming shape, e.g. feeding a device-side encoder).

CPU tensors and numpy arrays pass through (as numpy with ``pull=True``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import span


class FramePump:
    """Double-buffered frame consumption (one frame of latency)."""

    def __init__(self, pull: bool = True):
        self.pull = pull
        self._pending = None   # (frame or host buffer, CUDA event or None)

    def _start(self, img):
        with span("bgf.pump.copy"):
            if not (isinstance(img, torch.Tensor) and img.is_cuda):
                return img, None
            if self.pull:
                buf = torch.empty(img.shape, dtype=img.dtype,
                                  pin_memory=True)
                buf.copy_(img, non_blocking=True)
                img = buf
            event = torch.cuda.Event()
            event.record()
            return img, event

    def _finish(self, pending):
        with span("bgf.pump.wait"):
            img, event = pending
            if event is not None:
                event.synchronize()
            if not self.pull:
                return img
            return img.numpy() if isinstance(img, torch.Tensor) \
                else np.asarray(img)

    def push(self, img):
        """Submit frame k; returns frame k-1 fully materialized (or None on
        the first call)."""
        prev, self._pending = self._pending, self._start(img)
        return None if prev is None else self._finish(prev)

    def flush(self):
        """Drain the in-flight frame (call once after the last push)."""
        prev, self._pending = self._pending, None
        return None if prev is None else self._finish(prev)
