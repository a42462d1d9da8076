"""The port's bench (``bevy_gpu_fluid_tpu_torch/tools/bench.py``, the
repo's ``bench.py`` on the card) on the CPU, where its kernels run their
PyTorch twins.

(a) The bench's verlet protocol against the JAX package's Session: the
bench's scene (the dam break at skin 1.75, cap 8) at 1,024 particles,
through the port's ``bench_case`` and, in this file, through the same
protocol on ``bevy_gpu_fluid_tpu.models.verlet_solver.Session`` (warm-up,
snapshot, short run, restore, long run; the root ``bench.py`` is not
imported).  Warm-up and window are 24 steps each, so that the window
[48, 72] holds a rebin (the bins age out at step 64; the flow starts from
rest, so no particle outruns half the skin that early).  Tolerances: the
window's rebins, the overflow and the grid exactly; the final state per
particle, keyed by index, within the Session gate of
``tests/test_torch_session.py`` (x, y 1e-5 absolute, v 1e-4 absolute, rho
1e-5 relative).  The protocol's own accounting (every step and rebin it
ran: the launch counts the card is held to) is counted exactly through
wrappers around the step and the rebin.

(b) The snapshot premise of the differential window: from one snapshot,
two runs of the same steps (a rebin among them) are bitwise equal in every
tensor and host counter, and the snapshot is bitwise what it was before;
the same for the eager solver's FluidState.  (c) The postures that break
the premise are refused.  (d) ``main`` prints last bench.py's JSON line:
its four keys, its metric name, ``value`` rounded to 0.1 and
``vs_baseline`` = the rate / 1e7 rounded to 4 places, hence within 5e-5
(+ the value's rounding) of value / 1e7.  (e) The other modes print their
lines (``bench_fps`` at 2 substeps and ``FPS_BATCH`` = 2 frames: at 16 x
32 the twins take minutes here).  (f) Without a card the bench raises unless
given ``--cpu``.
"""

import copy
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

import bevy_gpu_fluid_tpu as bgf
from bevy_gpu_fluid_tpu.models import verlet_solver as jvs

from bevy_gpu_fluid_tpu_torch import tools
from bevy_gpu_fluid_tpu_torch.models import cuda_solver, grid_solver
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as tvs
from bevy_gpu_fluid_tpu_torch.ops import reslot as treslot
from bevy_gpu_fluid_tpu_torch.tools import bench
from bevy_gpu_fluid_tpu_torch.utils import convert

torch.set_num_threads(1)

N = 1_024
SKIN = 1.75
WARM = 24
STEPS = 24


def _jax_scene(n: int):
    """bench.py's verlet scene in the JAX package: state, params, cfg,
    grid."""
    side = math.isqrt(n)
    extent = side * 0.04
    return (bgf.init_grid(side, side, 0.04), bgf.FluidParams.demo(),
            bgf.IntegrateConfig.create(x_min=-1.0, x_max=extent + 1.0),
            jvs.default_grid(0.045, -1.0, extent + 1.0,
                             y_max=extent * 1.1 + 1.0, cap=8,
                             skin_factor=SKIN))


def _counting(fn, counts: dict, key: str):
    def wrapped(*a, **kw):
        counts[key] += 1
        return fn(*a, **kw)
    return wrapped


@pytest.fixture(scope="module")
def protocol():
    """The port's bench_case (its steps and rebins counted) and the JAX
    Session through the same protocol."""
    counts = {"steps": 0, "rebins": 0}
    make_reslot = treslot.make_reslot
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_solver, "mono_step_cuda",
                   _counting(cuda_solver.mono_step_cuda, counts, "steps"))
        mp.setattr(treslot, "make_reslot", lambda grid: _counting(
            make_reslot(grid), counts, "rebins"))
        got = bench.bench_case(N, STEPS, warmup_steps=WARM, skin=SKIN,
                               device="cpu")

    sess = jvs.Session(*_jax_scene(N))
    sess.run(WARM)
    snap = sess.sim
    sess.run(STEPS)
    short = int(sess.sim.rebin_count)
    sess.sim = snap
    sess.run(2 * STEPS, chunk=STEPS)   # the short run's program, twice
    want = {"rebins": int(sess.sim.rebin_count) - short,
            "overflow": sess.overflow,
            "grid": sess.grid,
            "state": jax.tree_util.tree_map(np.asarray, sess.state())}
    return got, want, counts


def test_bench_case_window_matches_jax(protocol):
    got, want, _ = protocol
    assert got["rebins"] == want["rebins"] >= 1
    assert got["overflow"] == want["overflow"] == 0
    assert got["grid"] == convert.grid_from(want["grid"])
    assert got["grid"].n_row_blocks < cuda_solver.MONO_MAX_BLOCKS   # K5
    assert got["n"] == N and got["steps"] == STEPS and got["finite"]
    assert got["seconds"] == got["t_long"] - got["t_short"]
    assert got["rate"] == N * STEPS / got["seconds"]
    assert got["ms_per_step"] == got["seconds"] / STEPS * 1e3


def test_bench_case_state_matches_jax(protocol):
    got, want, _ = protocol
    g, w = got["state"], want["state"]
    assert g.step == int(w.step) == WARM + 2 * STEPS
    np.testing.assert_allclose(g.x.numpy(), w.x, rtol=0, atol=1e-5)
    np.testing.assert_allclose(g.y.numpy(), w.y, rtol=0, atol=1e-5)
    np.testing.assert_allclose(g.vx.numpy(), w.vx, rtol=0, atol=1e-4)
    np.testing.assert_allclose(g.vy.numpy(), w.vy, rtol=0, atol=1e-4)
    np.testing.assert_allclose(g.rho.numpy(), w.rho, rtol=1e-5, atol=0)


def test_bench_case_counts_what_it_ran(protocol):
    """``steps_run`` and ``rebins_run`` are every step and rebin the
    protocol ran: warm-up + 4 runs of each length (the first use and the
    best of 3)."""
    got, _, counts = protocol
    assert got["steps_run"] == WARM + 4 * 3 * STEPS == counts["steps"]
    assert got["rebins_run"] == counts["rebins"] >= 4 * got["rebins"]


def _bits(v):
    if isinstance(v, torch.Tensor) and v.dtype == torch.float32:
        return v.view(torch.int32)
    return v


def _same(a, b) -> bool:
    """Every field of two dataclasses bitwise equal (tensors by their
    bits, host values by ==)."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            if not (x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))):
                return False
        elif x != y:
            return False
    return True


def test_session_snapshot_premise():
    """From one snapshot at step 56, two 10-step runs (the age rebin at
    step 65 among them) are bitwise equal, and the snapshot is unchanged."""
    sc = tools.dam_break(N, "cpu", SKIN)
    sess = tvs.Session(sc.state, sc.params, sc.cfg, sc.grid, device="cpu")
    bench.check_posture(sess)
    sess.run(56)
    snap = sess.sim
    before = copy.deepcopy(snap)
    sess.run(10)
    first = sess.sim
    sess.sim = snap
    sess.run(10)
    assert first.rebin_count == snap.rebin_count + 1
    assert _same(first, sess.sim)
    assert _same(snap, before)


def test_eager_snapshot_premise():
    sc = tools.dam_break(256, "cpu", SKIN)
    grid = grid_solver.default_grid(0.045, -1.0, sc.extent + 1.0,
                                    y_max=sc.extent * 1.1 + 1.0)
    snap = cuda_solver.multi_step(sc.state, sc.params, sc.cfg, grid, 3)[0]
    before = copy.deepcopy(snap)
    a, da = cuda_solver.multi_step(snap, sc.params, sc.cfg, grid, 3)
    b, db = cuda_solver.multi_step(snap, sc.params, sc.cfg, grid, 3)
    assert _same(a, b) and da == db
    assert _same(snap, before)


@pytest.mark.parametrize("knob", sorted(bench.SNAPSHOT_BREAKERS))
def test_posture_that_breaks_the_snapshot_is_refused(knob):
    sc = tools.dam_break(256, "cpu", SKIN)
    sess = tvs.Session(sc.state, sc.params, sc.cfg, sc.grid, device="cpu",
                       **{knob: True})
    with pytest.raises(RuntimeError, match=knob):
        bench.check_posture(sess)


@pytest.mark.parametrize("solver", ["verlet", "pallas"])
def test_main_prints_bench_json_line(solver, capsys):
    argv = ["--cpu", "--n", "1024", "--steps", "5", "--warmup-steps", "10"]
    assert bench.main(argv + ["--solver", solver]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "particle_steps_per_sec_per_chip_1k"
    assert line["unit"] == "particle-steps/s"
    value, vs = line["value"], line["vs_baseline"]
    assert value == round(value, 1) and vs == round(vs, 4)
    assert abs(vs - value / 1e7) <= 5e-5 + 5e-9
    assert f"# n=1024 solver={solver} steps=5 (window [15, 20])" in err


def test_bench_fps_prints_its_line(capsys, monkeypatch):
    monkeypatch.setattr(bench, "FPS_BATCH", 2)
    rows = bench.bench_fps(plan=(256,), seconds=0.2, substeps=2,
                           device="cpu")
    err = capsys.readouterr().err
    assert "# fps: 256 particles x 2 substeps/frame" in err
    (row,) = rows
    assert row["n"] == 256 and row["overflow"] == 0
    assert all(row[k] > 0 for k in ("splat_device", "splat_pulled",
                                    "field_batched_device",
                                    "field_batched_pulled"))
    # every field frame is a batch of 2 and every frame 2 steps
    assert row["field_frames"] % 2 == 0 and row["steps"] % 2 == 0


def test_bench_frames_prints_its_line(capsys):
    r = bench.bench_frames(n=1024, seconds=0.2, device="cpu")
    err = capsys.readouterr().err
    assert "# config4: 1024 particles x 16 substeps + " in err
    assert r["lost"] == 0 and r["finite"] and r["frames"] >= 1
    assert r["steps"] == 16 * r["frames_run"]


def test_bench_golden_step_prints_its_line(capsys):
    r = bench.bench_golden_step(side=10, device="cpu")
    assert "# golden step: 100 particles " in capsys.readouterr().err
    assert r["n"] == 100 and r["ms_per_step"] > 0


def test_bench_needs_the_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: main([]) would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
