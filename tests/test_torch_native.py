"""The port's native FrameSink (its own copy of the C++ ring buffer +
writer thread, built with g++ into the port's build directory): the JAX
package's FrameSink cases on it, its PPM files bytewise the JAX sink's for
the same frames, and its refusals.  Exact comparisons throughout: the sink
copies bytes."""

import glob
import os

import numpy as np
import pytest
import torch

from bevy_gpu_fluid_tpu.native import FrameSink as JaxFrameSink

import bevy_gpu_fluid_tpu_torch
from bevy_gpu_fluid_tpu_torch import native
from bevy_gpu_fluid_tpu_torch.native import FrameSink


def _read_ppm(path):
    with open(path, "rb") as f:
        assert f.readline().strip() == b"P6"
        w, h = map(int, f.readline().split())
        f.readline()
        return np.frombuffer(f.read(), np.uint8).reshape(h, w, 3)


def test_framesink_roundtrip(tmp_path):
    out = str(tmp_path)
    frames = [np.full((32, 64, 3), i * 7 % 256, np.uint8) for i in range(20)]
    with FrameSink(out, width=64, height=32, slots=4) as sink:
        for f in frames:
            while not sink.push(f):   # ring full -> wait-and-retry in test
                pass
        sink.flush()
        assert sink.written == 20

    files = sorted(glob.glob(os.path.join(out, "frame_*.ppm")))
    assert len(files) == 20
    for i, path in enumerate(files):
        np.testing.assert_array_equal(_read_ppm(path), frames[i])


def test_framesink_never_blocks(tmp_path):
    # pushes beyond ring capacity return False instead of blocking
    sink = FrameSink(str(tmp_path), width=2048, height=2048, slots=2)
    f = np.zeros((2048, 2048, 3), np.uint8)
    results = [sink.push(f) for _ in range(50)]
    assert any(results)
    sink.close()
    assert sink.written + sink.dropped == 50
    assert sink.written >= 2


def test_ppm_files_bytewise_the_jax_sink(tmp_path):
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (17, 29, 3), dtype=np.uint8)
              for _ in range(5)]
    for name, cls in (("jax", JaxFrameSink), ("port", FrameSink)):
        with cls(str(tmp_path / name), width=29, height=17) as sink:
            for f in frames:
                while not sink.push(f):
                    pass
    jax_files = sorted(os.listdir(tmp_path / "jax"))
    assert jax_files == sorted(os.listdir(tmp_path / "port"))
    assert len(jax_files) == 5
    for name in jax_files:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())


def test_cpu_tensor_accepted_and_bad_frames_refused(tmp_path):
    img = torch.arange(4 * 6 * 3, dtype=torch.uint8).reshape(4, 6, 3)
    with FrameSink(str(tmp_path), width=6, height=4) as sink:
        assert sink.push(img)
        with pytest.raises(ValueError, match="want uint8"):
            sink.push(np.zeros((4, 6, 3), np.float32))
        with pytest.raises(ValueError, match="want uint8"):
            sink.push(np.zeros((6, 4, 3), np.uint8))
        with pytest.raises(ValueError, match="FramePump"):
            sink.push(img.to("meta"))
    np.testing.assert_array_equal(
        _read_ppm(str(tmp_path / "frame_000000.ppm")), img.numpy())
    with pytest.raises(ValueError, match="after close"):
        sink.push(img)


def test_build_goes_to_the_port_build_dir():
    lib = native.build()
    pkg = os.path.dirname(bevy_gpu_fluid_tpu_torch.__file__)
    assert str(lib).startswith(os.path.join(pkg, "_build") + os.sep)
    assert lib.exists()
