"""Each cell's driver on a small dam break on the CPU, through
``harness.run``'s seam (the kernels' PyTorch twins): the result's keys,
its metrics, ``correct``; the faults a cell can have turn ``correct``
false; the controls, the reference at bfloat16 in the program's place,
turn it false; a module of JAX loaded at any point of a run, the readers
included, leaves no result."""

import json
import shutil
import sys

import harness_support as hs
import pytest
import torch

from benchlib import catalog, checks, harness

SPEC = json.loads((hs.CHECKOUT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _expected(cell: str, kind: str) -> set:
    return {m["name"] for m in SPEC[kind]
            if cell in m.get("workloads", CELLS)}


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run(cell):
    rc, r = hs.run_cell(cell)
    assert rc == 0
    assert list(r) == KEYS + ["checks"]
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == _expected(cell, "end_to_end")
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert r["device"]["platform"] == "cpu" and r["device"]["count"] == 1
    limits = catalog.load("workloads", cell)["limits"]
    assert set(r["checks"]) == set(limits)
    for k, c in r["checks"].items():
        assert c["limit"] == limits[k] and c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run(cell):
    rc, r = hs.run_cell(cell, trace=1)
    assert rc == 0 and r["correct"]
    assert list(r) == KEYS + ["breakdown", "checks"]
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU no operation runs on a device: the readers of device
    # kernels find nothing, the counters and the idle share read
    got = set(r["metrics"])
    assert got <= _expected(cell, "per_layer")
    idle = [m for m in got if m.startswith("device_idle_share")]
    assert len(idle) == 1 and r["metrics"][idle[0]]["value"] == 100.0


def _break(monkeypatch, what: str):
    """Break the timed path under the harness (a fault the cell can
    have)."""
    from bevy_gpu_fluid_tpu_torch.models import cuda_solver, grid_solver
    from bevy_gpu_fluid_tpu_torch.render import raster
    k2 = cuda_solver.forces_integrate_cuda
    k1 = cuda_solver.density_cuda
    k8 = cuda_solver.forces_cuda

    def unchanged(xd, yd, vxd, vyd, *a, **kw):
        return xd, yd, vxd, vyd, torch.zeros((), device=xd.device)

    def half_density(xd, yd, params, grid, occ, out=None):
        keep = torch.arange(xd.shape[1], device=xd.device) % 2 == 0
        far = torch.full_like(xd, 1e9)
        return k1(torch.where(keep[None, :, None], xd, far),
                  torch.where(keep[None, :, None], yd, far), params, grid,
                  occ, out=out)

    def altered(*a, **kw):
        x, y, vx, vy, d = k2(*a, **kw)
        live = torch.nonzero(x.reshape(-1) < 1e8)[0]
        x.reshape(-1)[live] += 1e-3
        return x, y, vx, vy, d

    def no_forces(*a, **kw):
        ax, ay = k8(*a, **kw)
        return torch.zeros_like(ax), torch.zeros_like(ay)

    field = raster.field_frame

    def swapped(*a, **kw):
        return field(*a, **kw).flip(-1)

    patches = {"unchanged": ("forces_integrate_cuda", unchanged),
               "half": ("density_cuda", half_density),
               "altered": ("forces_integrate_cuda", altered),
               "no_forces": ("forces_cuda", no_forces)}
    eager_step = grid_solver.step_with_diag

    def eager_unchanged(state, *a, **kw):
        return state, eager_step(state, *a, **kw)[1]

    if what == "frame":
        monkeypatch.setattr(raster, "field_frame", swapped)
    elif what == "eager_unchanged":
        monkeypatch.setattr(grid_solver, "step_with_diag", eager_unchanged)
    else:
        name, fn = patches[what]
        monkeypatch.setattr(cuda_solver, name, fn)


FAULTS = [("dam1m-step", "unchanged"), ("dam1m-step", "half"),
          ("dam1m-step", "altered"), ("dam96m-step", "altered"),
          ("dam1m-frames", "frame"), ("dam1m-frames", "unchanged"),
          ("dam1m-eager", "half"), ("dam1m-eager", "no_forces"),
          ("dam1m-eager", "eager_unchanged")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    _break(monkeypatch, fault)
    rc, r = hs.run_cell(cell)
    assert rc == 0
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", ["dam1m-step", "dam1m-frames",
                                  "dam1m-eager"])
def test_the_control_fails_a_limit(cell):
    import control
    got = control.readings(cell, hs.SEED, torch.device("cpu"),
                           hs.small(cell))
    limits = catalog.load("workloads", cell)["limits"]
    assert got["program"]["correct"]
    assert all(got["program"][k] <= v for k, v in limits.items())
    for name in checks.CONTROLS:
        assert not got[name]["correct"], name
        assert any(got[name][k] > v for k, v in limits.items()), name


@pytest.mark.parametrize("control", list(checks.CONTROLS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_control_in_the_programs_place_is_not_correct(cell, control):
    rc, r = hs.run_cell(cell, control=control)
    assert rc == 0
    assert not r["correct"], r["checks"]
    assert r["failed"] == 0


def test_a_reader_that_loads_jax_leaves_no_result(tmp_path, capsys,
                                                   monkeypatch):
    root = tmp_path / "benchmark"
    shutil.copytree(hs.BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    (root / "metrics" / "zz_loads_jax.py").write_text(
        'import sys\n\nUNIT = "%"\n\n\ndef read(ctx):\n'
        f'    sys.path.insert(0, {str(stub)!r})\n'
        '    import jax  # noqa: F401\n'
        '    return None\n')
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.setattr(sys, "path", list(sys.path))
    try:
        rc = harness.main(hs.argv("dam1m-step", trace=1),
                          **hs.seam("dam1m-step", root))
    finally:
        sys.modules.pop("jax", None)
    out = capsys.readouterr()
    assert rc == 4
    assert out.out == ""
    assert "['jax']" in out.err
