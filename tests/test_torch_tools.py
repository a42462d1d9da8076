"""The port's chip tools (``bevy_gpu_fluid_tpu_torch/tools/``) at small
sizes on the CPU, where every kernel wrapper runs its PyTorch twin.

Each tool runs once: its function returns its summary and prints the
reference tool's JSON line, which must parse with the reference's keys.
Asserted are the gates that hold at any horizon (overflow 0, nothing lost
or dropped, finite, the identity exact, the restore bitwise); the pool's
settle (max |v| < 1 after 20,000 steps) and the dry run's three rebins and
populated slabs need the full sizes, which ``chip_smoke.py`` phase 19 runs
on the card.  The D = 8 dry run is also held against one ``Session`` on
the same scene and the same step path (K1 + K2: the mono kernel switched
off) per particle, |dx| <= 1e-5 and |dv| <= 1e-4.  Without a card, every
tool fails on its default device instead of running on the CPU.
"""

import json
import math
import time

import pytest
import torch

import bevy_gpu_fluid_tpu_torch as bt
from bevy_gpu_fluid_tpu_torch.models import cuda_solver
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as tvs
from bevy_gpu_fluid_tpu_torch.tools import (bench_aot, bench_mono_ab,
                                            bench_scale, bench_sharded,
                                            dryrun_d8, validate_longrun)

torch.set_num_threads(1)


def _json(capsys) -> dict:
    """The last JSON line the tool printed."""
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    return json.loads(lines[-1])


def test_pool(capsys):
    out = validate_longrun.pool(rows=4, cols=64, steps=200, block=100,
                                device="cpu")
    line = _json(capsys)
    assert line["metric"] == "pool_longrun"
    assert {"n", "steps", "overflow", "finite", "max_v", "rebins", "wall_s",
            "launches", "ok"} <= set(line)
    assert out["n"] == 256 and out["steps"] == 200
    assert out["overflow"] == out["lost"] == 0 and out["finite"]
    assert out["rebins"] >= 2
    assert out["grid"] == [40, 8, 128]
    assert out["n_row_blocks"] < cuda_solver.MONO_MAX_BLOCKS   # K5's grid


def test_restore_bitwise(capsys):
    out = validate_longrun.restore_check(side=12, steps=30, device="cpu")
    assert _json(capsys)["metric"] == "restore_bitwise"
    assert out["ok"] and out["mismatch"] is None and out["step"] == 60


def test_restore_check_sees_a_difference():
    a = tvs.init_dense(bt.init_grid(6, 6, 0.04, "cpu"),
                       tvs.default_grid(0.045, -1.0, 2.5, y_max=1.0))
    b = tvs.DenseSim(**{**a.__dict__, "vxd": a.vxd.clone()})
    assert validate_longrun.sims_bitwise(a, b) is None
    b.vxd[b.vxd == 0] = -0.0                # +0 and -0: another bit pattern
    assert validate_longrun.sims_bitwise(a, b) == "vxd"
    b = tvs.DenseSim(**{**a.__dict__, "rebin_count": a.rebin_count + 1})
    assert validate_longrun.sims_bitwise(a, b) == "rebin_count"


def test_dryrun_d8_matches_one_session(capsys, monkeypatch):
    """D = 8 slabs of the smallest dry-run scene with the fused slab step
    (K1 + K2 per slab) against one Session on K1 + K2."""
    n, steps = 1024, 30
    out = dryrun_d8.dryrun(n, steps, devices=8, fused=True, device="cpu")
    line = _json(capsys)
    assert line["metric"] == "dryrun_D8_steps"
    assert {"n", "steps", "rebins", "alive", "overflow", "dropped",
            "identity_exact", "finite", "in_box", "per_device_alive",
            "wall_s", "ok"} <= set(line)
    assert out["alive"] == n and out["overflow"] == out["dropped"] == 0
    assert out["lost"] == 0 and out["identity_exact"]
    assert out["finite"] and out["in_box"] and out["rebins"] >= 2
    assert len(out["per_device_alive"]) == 8

    state, params, cfg, spec = dryrun_d8.scene(n, 8, "cpu")
    extent = math.isqrt(n) * 0.04
    grid = tvs.default_grid(0.045, -1.0, extent + 1.0,
                            y_max=extent * 1.1 + 1.0)
    g = spec.local_grid
    assert (grid.origin_x, grid.origin_y, grid.cell_size, grid.ny) == (
        spec.global_x0, g.origin_y, g.cell_size, g.ny)
    monkeypatch.setattr(cuda_solver, "MONO_MAX_BLOCKS", 0)
    sess = tvs.Session(state, params, cfg, grid, device="cpu")
    sess.run(steps)
    want, got = sess.state(), out["state"]
    assert sess.overflow == 0
    dx = max(float((got.x - want.x).abs().max()),
             float((got.y - want.y).abs().max()))
    dv = max(float((got.vx - want.vx).abs().max()),
             float((got.vy - want.vy).abs().max()))
    assert dx <= 1e-5 and dv <= 1e-4, (dx, dv)


@pytest.mark.parametrize("mono", [1, 0])
def test_bench_mono_ab(mono, capsys, monkeypatch):
    calls = {"mono_step_cuda": [], "forces_integrate_cuda": []}
    for name, seen in calls.items():
        real = getattr(cuda_solver, name)
        monkeypatch.setattr(cuda_solver, name,
                            lambda *a, _r=real, _s=seen, **kw:
                            _s.append(1) or _r(*a, **kw))
    rc = bench_mono_ab.main(["--cpu", "1024", str(mono), "--warmup", "2",
                             "--steps", "2"])
    line = _json(capsys)
    assert rc == 0 and line["mono"] == mono and line["n"] == 1024
    assert {"n_row_blocks", "per_step_ms", "rate_M", "overflow"} <= set(line)
    assert cuda_solver.MONO_MAX_BLOCKS == 12            # restored
    assert bool(calls["mono_step_cuda"]) == bool(mono)
    assert bool(calls["forces_integrate_cuda"]) != bool(mono)


@pytest.mark.parametrize("argv", [[], ["--bisect", "3"]])
def test_bench_scale(argv, capsys):
    rc = bench_scale.main(["--cpu", "--n", "2500", "--steps", "4",
                           "--warmup-steps", "4", "--reps", "2"] + argv)
    line = _json(capsys)
    assert rc == 0 and line["ok"]
    if argv:
        assert line["metric"] == "bisect"
    else:
        assert line["metric"] == "scale_psteps_per_sec_0M"
        assert line["unit"] == "particle-steps/s" and line["value"] > 0
        assert line["overflow"] == 0
        assert line["peak_plane_footprints"] is None      # not on a card


@pytest.mark.parametrize("argv", [["--frames", "--frames-seconds", "0.2"],
                                  ["--scale", "--gen", "--chunk", "3",
                                   "--reps", "1"]])
def test_bench_sharded(argv, capsys):
    rc = bench_sharded.main(["--cpu", "--n", "2500", "--steps", "3",
                             "--warmup-steps", "3"] + argv)
    line = _json(capsys)
    assert rc == 0 and line["ok"] and line["value"] > 0
    assert line["alive"] == 2500 and line["identity_exact"]
    if "--scale" in argv:
        assert line["metric"] == "sharded_scale_psteps_per_sec_0M_D1"
    else:
        assert line["metric"] == "sharded_verlet_psteps_per_sec_D1"
        assert line["frames_overflow"] == 0 and line["frame_ms"] > 0


def test_bench_aot(capsys, monkeypatch):
    """The orchestrator with every phase but the last in this process (the
    children's imports cost seconds each) and the last load in a fresh
    process, as the tool runs each, on one thread as this one (the CPU
    twins' sums follow the thread count)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    loads = []

    def run_phase(phase, n, steps, work, cpu):
        if phase == "load":
            loads.append(phase)
            if len(loads) == 2:             # the last phase
                return bench_aot.fresh_process(phase, n, steps, work, cpu)
        t0 = time.perf_counter()
        res = bench_aot.PHASES[phase](n, steps, work, torch.device("cpu"))
        return dict(res, process_wall_s=time.perf_counter() - t0)

    out = bench_aot.cold_starts(1024, 3, "cpu", run_phase)
    line = _json(capsys)
    assert out["ok"] and line["metric"] == "aot_cold_start"
    assert {"trace_cold_start_s", "aot_cold_start_s", "aot_first_ever_s",
            "speedup", "artifact_mb", "first_build_s"} <= set(line)
    assert line["probes_equal"]


@pytest.mark.parametrize("tool, argv", [
    (validate_longrun, ["--restore"]),
    (dryrun_d8, []),
    (bench_mono_ab, ["1024", "1"]),
    (bench_scale, []),
    (bench_sharded, []),
    (bench_aot, []),
])
def test_no_card_no_fallback(tool, argv, monkeypatch):
    """Without a card a tool raises on its default device; it never
    carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
