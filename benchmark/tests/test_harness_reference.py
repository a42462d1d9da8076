"""The benchmark's plain reference against the port's own PyTorch twins on
a small scene (the golden all-pairs step, the Session's step, the field
frame), the comparisons' exact parts, and the roofline's counts against
hand counts."""

import math

import harness_support as hs
import pytest
import torch

import roofline
from benchlib import checks, dense, scene
from reference import raster, sph

SC = dict(hs.SMALL, side=12, spacing=0.04, jitter=0.0004, h=0.045,
          rho_0=1000.0, k=3.0, mu=0.2, m=1.6, dt=0.0005, bounce=-3.0,
          floor_y=0.0, x_min=-1.0, x_max=1.48, y_max=8.0, skin=1.75, cap=8,
          max_age=64)


def _port_scene():
    import bevy_gpu_fluid_tpu_torch as bt
    from bevy_gpu_fluid_tpu_torch.core.state import FluidState
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver
    inp = scene.dam_break(SC, 7, "cpu")
    z = torch.zeros_like(inp["x"])
    state = FluidState(x=inp["x"], y=inp["y"], vx=inp["vx"], vy=inp["vy"],
                       ax=z, ay=z, rho=z, p=z)
    params = bt.FluidParams.create(SC["h"], SC["rho_0"], SC["k"], SC["mu"],
                                   SC["m"])
    cfg = bt.IntegrateConfig.create(dt=SC["dt"], x_min=SC["x_min"],
                                    x_max=SC["x_max"], bounce=SC["bounce"],
                                    floor_y=SC["floor_y"])
    grid = verlet_solver.default_grid(SC["h"], SC["x_min"], SC["x_max"],
                                      y_max=SC["y_max"], cap=SC["cap"],
                                      skin_factor=SC["skin"])
    return inp, state, params, cfg, grid


def test_seeded_inputs():
    a = scene.dam_break(SC, 2**31 + 5, "cpu")
    b = scene.dam_break(SC, 2**31 + 5, "cpu")
    c = scene.dam_break(SC, 2**31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["x"], c["x"])
    lattice = torch.arange(SC["side"] ** 2) % SC["side"] * 0.04
    assert float((a["x"] - lattice).abs().max()) <= 0.0004 + 1e-6


def test_reference_step_matches_the_golden_model():
    from bevy_gpu_fluid_tpu_torch.models import reference as golden
    inp, state, params, cfg, _ = _port_scene()
    for _ in range(30):                    # some motion and compression
        state = golden.step(state, params, cfg)
    want = golden.step(state, params, cfg)
    got = sph.step(state.x, state.y, state.vx, state.vy, SC)
    rho = golden.density_pressure(state, params).rho
    assert float(((got["rho"] - rho.double()) / rho.double()).abs().max()) \
        < 1e-6
    for k in ("x", "y", "vx", "vy"):
        assert float((got[k] - getattr(want, k).double()).abs().max()) \
            < 1e-5, k


def test_reference_judges_the_session_step():
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver
    inp, state, params, cfg, grid = _port_scene()
    sess = verlet_solver.Session(state, params, cfg, grid, device="cpu")
    start = dense.view(sess.sim, grid, sess.n)
    assert checks.start_faults(start, inp, SC) == 0
    sess.run(40)
    pre = sess.sim
    sess.run(1)
    nums = checks.step_numbers(dense.view(pre, grid, sess.n),
                               dense.view(sess.sim, grid, sess.n), SC)
    assert nums["structure"] == 0
    assert nums["rho_rel"] < 1e-6 and nums["vel_abs"] < 1e-5
    assert nums["pos_abs"] < 1e-6


def test_reference_frame_matches_the_field_twin():
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver
    _, state, params, cfg, grid = _port_scene()
    sess = verlet_solver.Session(state, params, cfg, grid, device="cpu")
    sess.run(20)
    img = sess.frame(2)
    x, y = dense.positions(sess.sim)
    ref = raster.frame(x, y, SC, 2)
    assert ref.shape == img.shape
    assert int((ref.int() - img.int()).abs().max()) <= 1
    assert checks.frame_numbers(x, y, img, SC, 2)["frame_off"] == 0.0


def test_structure_faults_are_counted():
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver
    _, state, params, cfg, grid = _port_scene()
    sess = verlet_solver.Session(state, params, cfg, grid, device="cpu")
    sess.run(5)
    a = dense.view(sess.sim, grid, sess.n)
    sess.run(1)
    b = dense.view(sess.sim, grid, sess.n)
    assert checks.structure_faults(a, b, SC) == 0
    moved = dict(b, cx=b["cx"].clone())
    moved["cx"][0] += 1                       # a slot moved without a rebin
    assert checks.structure_faults(a, moved, SC) == 1
    twice = dict(b, seen=b["seen"].clone())
    twice["seen"][3] = 2                      # a particle held twice
    assert checks.structure_faults(a, twice, SC) == 1


def test_pairs_and_work_by_hand():
    h = 0.045
    x = torch.tensor([0.0, 0.03, 0.5, 0.5])
    y = torch.tensor([0.0, 0.0, 0.0, 0.044])
    # each particle with itself, (0, 1) both ways, (2, 3) both ways
    assert roofline.pairs_within(x, y, h) == 4 + 2 + 2
    w = roofline.k1(4, 8)
    assert (w.bytes, w.ops) == (48, 80)
    w = roofline.k2(4, 8)
    assert (w.bytes, w.ops) == (176, 29 * 4 + 23 * 4)
    w = roofline.k8(4, 8)
    assert (w.bytes, w.ops) == (112, 29 * 4 + 3 * 4)
    assert roofline.Work(3.35e12, 0).least_s == pytest.approx(1.0)
    assert roofline.Work(0, 67e12).least_s == pytest.approx(1.0)
    assert roofline.share(1.0, 4.0) == 25.0


def test_frame_work_by_hand():
    sc = dict(SC, x_min=0.0, x_max=0.15, y_max=0.15)
    g = raster.grid_geometry(sc)
    x = torch.tensor([0.05])
    y = torch.tensor([0.05])
    w = roofline.frame(x, y, sc, 1)
    pixels = g["nx"] * g["ny"]
    cx = [g["ox"] + (i + 0.5) * g["cell"] for i in range(g["nx"])]
    cy = [g["oy"] + (j + 0.5) * g["cell"] for j in range(g["ny"])]
    taps = sum(1 for a in cx for b in cy
               if (a - 0.05) ** 2 + (b - 0.05) ** 2 < 0.045 ** 2)
    assert w.bytes == 8 + 4 * pixels
    assert w.ops == 10 * taps and taps >= 1


def test_reference_density_of_one_particle():
    one = torch.tensor([0.3])
    rho = sph.density(one, one, SC)
    h = SC["h"]
    assert float(rho[0]) == pytest.approx(
        SC["m"] * 4 / (math.pi * h ** 8) * h ** 6, rel=1e-12)
