"""Native (C++) runtime components, built on demand with the system g++
(port of ``bevy_gpu_fluid_tpu/native``).

``FrameSink``: an asynchronous frame-streaming pipeline (ring buffer +
writer thread, ``framesink.cpp``) that persists finished RGB frames as PPM
files off the frame loop's critical path.  A push never blocks: when the
ring is full the frame is dropped and counted.

One ``g++ -O3 -shared -fPIC -pthread -std=c++17`` builds the library into
``bevy_gpu_fluid_tpu_torch/_build/framesink-<source hash>/`` on first use
(the card's host has g++: it is nvcc's host compiler); it is loaded with
``ctypes``.  A failed build raises: there is no fallback writer.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

_HERE = Path(__file__).resolve().parent
SRC = _HERE / "framesink.cpp"
BUILD_DIR = _HERE.parent / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]


def build() -> Path:
    """Compile the library if this source has no build yet; return its
    path.  Binaries are never committed: the first use on a host builds
    for that host."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    out = BUILD_DIR / f"framesink-{h.hexdigest()[:16]}" / "libframesink.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    r = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed ({r.returncode}) building {SRC}:\n"
                           f"{r.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed and load the library (once per process)."""
    lib = ctypes.CDLL(str(build()))
    lib.fs_create.restype = ctypes.c_void_p
    lib.fs_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int]
    lib.fs_push.restype = ctypes.c_int
    lib.fs_push.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                            ctypes.c_long]
    for name in ("fs_pending", "fs_dropped", "fs_written"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_void_p]
    for name in ("fs_flush", "fs_destroy"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p]
    return lib


class FrameSink:
    """Asynchronous PPM frame writer: ``frame_%06d.ppm`` in ``out_dir``,
    numbered by push.

    >>> sink = FrameSink(out_dir, width=512, height=256)
    >>> sink.push(rgb8)        # numpy or CPU uint8 [H, W, 3]; returns at once
    >>> sink.close()           # drains the queue
    """

    def __init__(self, out_dir: str, width: int, height: int,
                 slots: int = 8):
        os.makedirs(out_dir, exist_ok=True)
        self._lib = load()
        self._h = self._lib.fs_create(os.fsencode(out_dir), width, height,
                                      slots)
        self.width, self.height = width, height
        self._frame = 0
        self._final = None  # (written, dropped) after close

    def push(self, rgb8) -> bool:
        """Queue one [H, W, 3] uint8 frame (a numpy array or a CPU tensor);
        False if the ring was full and the frame was dropped (the caller is
        never blocked).  A CUDA tensor is refused: bring it to the host
        with ``render.pump.FramePump(pull=True)``, which overlaps the copy
        with the next frame."""
        if self._h is None:
            raise ValueError("FrameSink.push after close")
        if isinstance(rgb8, torch.Tensor):
            if rgb8.device.type != "cpu":
                raise ValueError(
                    f"FrameSink.push: frame on {rgb8.device}; pull it to the "
                    f"host first (render.pump.FramePump(pull=True))")
            rgb8 = rgb8.numpy()
        arr = np.ascontiguousarray(rgb8)
        if arr.dtype != np.uint8 or arr.shape != (self.height, self.width, 3):
            raise ValueError(f"FrameSink.push: want uint8 "
                             f"{(self.height, self.width, 3)}, got "
                             f"{arr.dtype} {arr.shape}")
        ok = self._lib.fs_push(
            self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._frame)
        self._frame += 1
        return ok == 0

    @property
    def pending(self) -> int:
        return self._lib.fs_pending(self._h) if self._h else 0

    @property
    def dropped(self) -> int:
        return self._final[1] if self._final else self._lib.fs_dropped(self._h)

    @property
    def written(self) -> int:
        return self._final[0] if self._final else self._lib.fs_written(self._h)

    def flush(self) -> None:
        """Block until every queued frame is written."""
        if self._h:
            self._lib.fs_flush(self._h)

    def close(self) -> None:
        """Drain the queue, stop the writer thread and keep the final
        counts."""
        if self._h:
            self._lib.fs_flush(self._h)
            self._final = (self._lib.fs_written(self._h),
                           self._lib.fs_dropped(self._h))
            self._lib.fs_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
