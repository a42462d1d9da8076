"""The port's entry points on the CPU: the demos against the JAX demos'
frames, the interactive server (self-drive and one HTTP round trip on an
ephemeral port), the sharded demo, ``entry()`` and the slab dry run, and
the small public functions the port adds beside them against their JAX
counterparts.

Tolerances: the demos' frames match the JAX demos' at the same arguments
within one level on at least 99% of the pixels (the splat of float32
positions that differ by FP contraction and summation order can move a
stamp edge by a pixel); ``cell_ids`` and ``sort_field`` bitwise;
``integrate``/``apply_boundaries`` within 1e-6 absolute.
"""

import json
import os
import runpy
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gpu_fluid_tpu as bgf
from bevy_gpu_fluid_tpu.core.params import GridSpec2D as JGrid
from bevy_gpu_fluid_tpu.models import reference as jref
from bevy_gpu_fluid_tpu.ops import binning as jbin

from bevy_gpu_fluid_tpu_torch.examples import (demo, interactive,
                                               sharded_demo, spin)
from bevy_gpu_fluid_tpu_torch.models import reference as tref
from bevy_gpu_fluid_tpu_torch.ops import binning as tbin
from bevy_gpu_fluid_tpu_torch.parallel import shard
from bevy_gpu_fluid_tpu_torch.render.png import decode_png
from bevy_gpu_fluid_tpu_torch.utils import convert

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read_ppm(path):
    with open(path, "rb") as f:
        assert f.readline().strip() == b"P6"
        w, h = map(int, f.readline().split())
        f.readline()
        return np.frombuffer(f.read(), np.uint8).reshape(h, w, 3)


def _run_jax_example(name: str, argv: list) -> None:
    """The JAX package's examples/<name>.py as a script, with the
    compilation cache setting it makes restored afterwards."""
    import sys
    cache = jax.config.jax_compilation_cache_dir
    old = sys.argv
    sys.argv = [name, *argv]
    try:
        runpy.run_path(os.path.join(ROOT, "examples", f"{name}.py"),
                       run_name="__main__")
    finally:
        sys.argv = old
        jax.config.update("jax_compilation_cache_dir", cache)


def _frames_close(port_dir, jax_dir, count):
    for i in range(count):
        name = f"frame_{i:06d}.ppm"
        a = _read_ppm(os.path.join(port_dir, name)).astype(np.int16)
        b = _read_ppm(os.path.join(jax_dir, name)).astype(np.int16)
        assert a.shape == b.shape
        assert a.any(), f"{name}: black"
        within = (np.abs(a - b) <= 1).all(axis=-1).mean()
        assert within >= 0.99, (name, within)


def test_demo_frames_match_the_jax_demo(tmp_path):
    args = ["--n", "256", "--frames", "3", "--substeps", "8", "--cpu",
            "--width", "256"]
    r = demo.run(demo.parse_args(args + ["--out", str(tmp_path / "port")]))
    assert r["written"] == 3 and r["dropped"] == 0 and r["device"] == "cpu"
    assert r["fps"] > 0
    _run_jax_example("demo", args + ["--out", str(tmp_path / "jax")])
    _frames_close(tmp_path / "port", tmp_path / "jax", 3)


def test_demo_python_sink_writes_the_same_frames(tmp_path):
    args = ["--n", "64", "--frames", "2", "--substeps", "2", "--cpu",
            "--width", "128", "--solver", "golden"]
    for sink in ("native", "python"):
        r = demo.run(demo.parse_args(args + ["--sink", sink, "--out",
                                             str(tmp_path / sink)]))
        assert r["written"] == 2
    for i in range(2):
        name = f"frame_{i:06d}.ppm"
        assert ((tmp_path / "native" / name).read_bytes()
                == (tmp_path / "python" / name).read_bytes())


def test_spin_frames_match_the_jax_spin(tmp_path):
    r = spin.run(spin.parse_args(["--frames", "3", "--cpu", "--out",
                                  str(tmp_path / "port")]))
    assert r["written"] == 3 and r["dropped"] == 0
    _run_jax_example("spin", ["--frames", "3", "--cpu", "--out",
                              str(tmp_path / "jax")])
    _frames_close(tmp_path / "port", tmp_path / "jax", 3)


@pytest.fixture
def app():
    """A fresh Session-backed app at rest, its first frame published (the
    pump hands a frame out one dispatch late)."""
    a = interactive.InteractiveApp(n=400, substeps=2, session=True,
                                   device="cpu")
    a._run_one_frame()
    a._run_one_frame()
    return a


def test_interactive_selfdrive(app):
    assert interactive.selfdrive(app, 8) == 0
    assert app.sim.overflow == 0
    # the frames that carried impulses were logged as they published
    assert app.kicks and all(k["latency_s"] > 0 for k in app.kicks)
    assert any(k["vmax_after"] > k["vmax_before"] for k in app.kicks)


def test_interactive_http_round_trip(app):
    srv = interactive.make_server(app, 0)              # ephemeral port
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{port}"
        page = urllib.request.urlopen(f"{url}/").read().decode()
        assert "pointermove" in page and "Space" in page
        png = urllib.request.urlopen(f"{url}/frame.png").read()
        np.testing.assert_array_equal(decode_png(png), app.latest_frame())
        stats = json.loads(urllib.request.urlopen(f"{url}/stats").read())
        assert stats["n"] == 400 and stats["overflow"] == 0
        v0 = float(interactive.particle_state(app).vx.abs().max())
        spec = app.sim.spec
        body = {"px": spec.width * 0.3, "py": spec.height * 0.8, "dx": 6,
                "dy": 0}
        req = urllib.request.Request(f"{url}/impulse", method="POST",
                                     data=json.dumps(body).encode())
        assert urllib.request.urlopen(req).status == 200
        mode = app.mode
        req = urllib.request.Request(f"{url}/toggle", method="POST", data=b"")
        urllib.request.urlopen(req)
        assert app.mode != mode
        app._run_one_frame()
        app._run_one_frame()
        assert float(interactive.particle_state(app).vx.abs().max()) > v0
        stats = json.loads(urllib.request.urlopen(f"{url}/stats").read())
        assert stats["impulse_ms"] is not None and stats["frames"] >= 2
        assert stats["step"] == app.sim.session.sim.step
    finally:
        srv.shutdown()
        srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def test_interactive_loop_thread_starts_and_stops():
    a = interactive.InteractiveApp(n=64, substeps=1, raster_width=64,
                                   device="cpu")
    a.start()
    try:
        assert a.latest_png() is not None
    finally:
        a.stop()
    assert not a._thread.is_alive()


def test_sharded_demo_on_two_cpu_slabs(tmp_path):
    r = sharded_demo.run(sharded_demo.parse_args(
        ["--devices", "2", "--frames", "3", "--cpu", "--out",
         str(tmp_path)]))
    assert r["restore_bitwise"] and r["identity_exact"]
    assert sum(r["alive"]) == r["n"] == 640
    assert (tmp_path / "frame_0002.ppm").exists()


def test_entry_and_dryrun_multichip_on_the_cpu():
    from bevy_gpu_fluid_tpu_torch import entry
    fn, args = entry.entry("cpu")
    out = fn(*args)
    assert out.step == 1 and out.n == 1024
    assert bool(out.x.isfinite().all())
    line = entry.dryrun_multichip(2, device="cpu")
    assert line.startswith("dryrun_multichip(2) on cpu: ok")


JGRID = JGrid.from_bounds(h=0.045, x_min=-1.0, x_max=3.0, y_min=-1.0,
                          y_max=3.0, cap=8)


def _xy(n=2000, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.5, 3.5, n).astype(np.float32),
            rng.uniform(-1.5, 3.5, n).astype(np.float32))


def test_cell_ids_and_sort_field_bitwise_the_jax_ones():
    x, y = _xy()
    g = convert.grid_from(JGRID)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_array_equal(tbin.cell_ids(tx, ty, g).numpy(),
                                  np.asarray(jbin.cell_ids(x, y, JGRID)))
    origin = (np.float32(-0.7), np.float32(-0.3))
    np.testing.assert_array_equal(
        tbin.cell_ids(tx, ty, g, origin).numpy(),
        np.asarray(jbin.cell_ids(x, y, JGRID, origin)))
    bj = jbin.bin_particles(jnp.asarray(x), jnp.asarray(y), JGRID)
    b = tbin.bin_particles(tx, ty, g)
    np.testing.assert_array_equal(b.perm.numpy(), np.asarray(bj.perm))
    v = np.arange(x.shape[0], dtype=np.float32) * 0.5
    np.testing.assert_array_equal(
        tbin.sort_field(b, torch.from_numpy(v)).numpy(),
        np.asarray(jbin.sort_field(bj, jnp.asarray(v))))


def test_integrate_and_apply_boundaries_match_the_jax_ones():
    rng = np.random.default_rng(1)
    n = 300
    f = {k: rng.normal(0, 2, n).astype(np.float32)
         for k in ("x", "y", "vx", "vy", "ax", "ay", "rho", "p")}
    sj = bgf.FluidState(**{k: jnp.asarray(v) for k, v in f.items()},
                        step=jnp.int32(0))
    st = convert.state_from(jax.tree_util.tree_map(np.asarray, sj), "cpu")
    cfg_j = bgf.IntegrateConfig.create(x_min=-1.0, x_max=1.5, bounce=-0.5)
    cfg_t = convert.cfg_from(cfg_j)
    for jf, tf in ((jref.integrate, tref.integrate),
                   (jref.apply_boundaries, tref.apply_boundaries)):
        a, b = jf(sj, cfg_j), tf(st, cfg_t)
        for k in ("x", "y", "vx", "vy"):
            np.testing.assert_allclose(getattr(b, k).numpy(),
                                       np.asarray(getattr(a, k)), rtol=0,
                                       atol=1e-6, err_msg=k)
    walls = tref.apply_boundaries(tref.integrate(st, cfg_t), cfg_t)
    assert bool((walls.x >= -1.0).all() & (walls.x <= 1.5).all()
                & (walls.y >= 0.0).all())


def test_make_mesh_takes_cards_or_cpu_entries():
    mesh = shard.make_mesh(3, device="cpu")
    assert [d.type for d in mesh.devices] == ["cpu"] * 3
    if torch.cuda.device_count() < 64:
        with pytest.raises(ValueError, match="SlabMesh"):
            shard.make_mesh(64)
