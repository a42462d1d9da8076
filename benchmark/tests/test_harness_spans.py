"""The readers of the program's spans (``benchlib/spans.py`` and its six
metrics), on a traced run of each cell on the CPU through ``harness.run``'s
seam: each metric reads a number in the cells it lists and nowhere else;
the CPU has no runtime synchronisation call, so the sync count reads 0;
the spans counted in the window are the window's steps, rebins and
frames, exactly; a program without the spans leaves the six metrics out
and the run whole."""

import contextlib
import json

import harness_support as hs
import pytest

from benchlib import harness, spans

SPEC = json.loads((hs.CHECKOUT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NEW = {"step_host_us", "trigger_wait_us", "host_syncs_per_kstep",
       "rebin_host_us", "raster_host_ms_per_frame", "pump_wait_ms_per_frame"}
# the Session's bins age out every 8 steps, so each small window rebins
OVERRIDES = {"max_age": 8}


def _run(cell: str, monkeypatch):
    """(exit code, result, the run's Ctx) of a small traced run."""
    seen = {}
    per_layer = harness.per_layer

    def keep(ctx, root):
        seen["ctx"] = ctx
        return per_layer(ctx, root)

    monkeypatch.setattr(harness, "per_layer", keep)
    seam = hs.seam(cell)
    seam["overrides"] = {**seam["overrides"], **OVERRIDES}
    rc, r = harness.run(harness.parse(hs.argv(cell, trace=1)), **seam)
    return rc, r, seen.get("ctx")


@pytest.fixture(scope="module")
def traced():
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for cell in CELLS:
            runs[cell] = _run(cell, mp)
    return runs


def test_the_six_metrics_are_declared():
    declared = {m["name"]: m for m in SPEC["per_layer"]}
    assert NEW <= set(declared)
    for name in NEW:
        assert declared[name]["source"] == "device_trace"


@pytest.mark.parametrize("cell", CELLS)
def test_each_metric_reads_in_its_cells_alone(cell, traced):
    rc, r, _ = traced[cell]
    assert rc == 0 and r["correct"], r.get("checks")
    listed = {m["name"] for m in SPEC["per_layer"]
              if m["name"] in NEW and cell in m["workloads"]}
    assert listed == NEW & set(r["metrics"])
    for name in listed:
        assert r["metrics"][name]["value"] >= 0.0, name


@pytest.mark.parametrize("cell", ["dam1m-step", "dam1m-eager"])
def test_no_runtime_sync_on_the_cpu(cell, traced):
    assert traced[cell][1]["metrics"]["host_syncs_per_kstep"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_spans_count_the_window(cell, traced):
    _, _, ctx = traced[cell]
    got = spans.reduce(ctx.trace)
    win = ctx.window
    assert got["bgf.step"]["count"] == win["steps"]
    if "rebins" in win:
        assert win["rebins"] >= 1
        assert got["bgf.rebin"]["count"] == win["rebins"]
        assert got["bgf.read.rebin_counts"]["count"] == win["rebins"]
    else:
        assert got["bgf.binning"]["count"] == win["steps"]
        assert got["bgf.read.overflow"]["count"] == win["steps"]
    if "frames" in win:
        assert got["bgf.raster"]["count"] == win["frames"]
    else:
        assert "bgf.raster" not in got
    assert got["*"]["syncs"] == 0


def test_a_program_without_spans_reads_none(monkeypatch):
    """A program from before the spans has no ``bgf.*`` range: the run
    stays whole and the six metrics stay out of its line."""
    from bevy_gpu_fluid_tpu_torch.models import grid_solver, verlet_solver
    from bevy_gpu_fluid_tpu_torch.ops import binning
    from bevy_gpu_fluid_tpu_torch.render import pump, raster
    for mod in (verlet_solver, grid_solver, binning, raster, pump):
        monkeypatch.setattr(mod, "span",
                            lambda name: contextlib.nullcontext())
    for cell in ("dam1m-step", "dam1m-frames"):
        rc, r, _ = _run(cell, monkeypatch)
        assert rc == 0 and r["correct"]
        assert not NEW & set(r["metrics"])
        assert r["metrics"]
