"""The port's frame path against the JAX package on the CPU: the mono step
(K5), the field raster (K4), the splat raster, the Session's frame methods
and kick, the FramePump and the Simulation facade.

Inputs come from numpy seeds and the lattice builders, on small grids, and
go to both packages (the port gets them through ``utils/convert.py``).  The
JAX side runs as its own tests run it: Pallas kernels in interpret mode
(tests/test_mono.py, tests/test_field_raster.py).  The port's wrappers run
their PyTorch twins, which is what a wrapper does with a CPU tensor.

Tolerances:
* K5 twin vs ``mono_step_pallas`` on EVERY slot (dead slots included: both
  sum the FAR-FAR pairs inside the widened density bound): rho 1e-6
  relative, positions 1e-6 and velocities 1e-5 absolute, disp2 1e-6
  relative; K5 twin vs the K1 + K2 twins at tests/test_mono.py's bars;
* K4 twin vs ``field_density_pallas``: 1e-5 relative on wet pixels (the
  same sum order, FP contraction in XLA:CPU the only difference);
* uint8 frames: +-1 (a float lands on a rounding boundary);
* the mono-grid Session: integer counters and slot assignment exact,
  particles at tests/test_torch_session.py's bars.
The one deliberate difference from the reference is the splat's handling
of stamp pixels left of or below the image (ROADMAP queue 3, S5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gpu_fluid_tpu as bgf
from bevy_gpu_fluid_tpu.interact import impulse as jimpulse
from bevy_gpu_fluid_tpu.models import pallas_solver as jps
from bevy_gpu_fluid_tpu.models import reference as jgolden
from bevy_gpu_fluid_tpu.models import verlet_solver as jvs
from bevy_gpu_fluid_tpu.render import raster as jraster

import bevy_gpu_fluid_tpu_torch as bt
from bevy_gpu_fluid_tpu_torch.interact import impulse as timpulse
from bevy_gpu_fluid_tpu_torch.models import cuda_solver
from bevy_gpu_fluid_tpu_torch.models import reference as tgolden
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as tvs
from bevy_gpu_fluid_tpu_torch.render import raster as traster
from bevy_gpu_fluid_tpu_torch.render.pump import FramePump
from bevy_gpu_fluid_tpu_torch.utils import convert

torch.set_num_threads(1)

PARAMS_J = bgf.FluidParams.demo()
CFG_J = bgf.IntegrateConfig.create(x_min=-1.0, x_max=2.5)
# tests/test_mono.py's grid: 7 row blocks, so the flagship step runs mono
VGRID = jvs.default_grid(0.045, -1.0, 2.5, y_max=3.0)
PARAMS = convert.params_from(PARAMS_J)
CFG = convert.cfg_from(CFG_J)
GRID = convert.grid_from(VGRID)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _launches():
    return (cuda_solver.density_cuda.launches,
            cuda_solver.forces_integrate_cuda.launches,
            cuda_solver.mono_step_cuda.launches,
            traster.field_density_cuda.launches)


def _assert_rgb8_close(got, want):
    """uint8 frames equal up to +-1 on a small share of pixels."""
    got = np.asarray(got)
    assert got.dtype == np.uint8 and got.shape == want.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert int(d.max()) <= 1 and float((d > 0).mean()) < 1e-2


# ----------------------------------------------------------------- K5 mono

@pytest.fixture(scope="module", params=["centre", "top"])
def mono_scene(request):
    """tests/test_mono.py's two scenes (the block in the middle of the grid,
    and pushed against the top so the last interior blocks and the clamped
    neighbour bounds carry occupancy), with velocities from a numpy seed;
    the port's DenseSim and the interpret-mode ``mono_step_pallas``
    outputs."""
    state = bgf.init_grid(24, 24, 0.04)
    if request.param == "top":
        state = dataclasses.replace(state, y=state.y + (3.0 - 0.04 * 26))
    v = np.random.default_rng(11).uniform(-1, 1, (2, state.n))
    state = state.replace(vx=jnp.asarray(v[0], jnp.float32),
                          vy=jnp.asarray(v[1], jnp.float32))
    sim = jvs.init_dense(state, VGRID)
    want = jps.mono_step_pallas(sim.xd, sim.yd, sim.vxd, sim.vyd, sim.ref_xd,
                                sim.ref_yd, PARAMS_J, CFG_J, VGRID,
                                interpret=True, occ=sim.occ)
    return convert.dense_sim_from(_np(sim), "cpu"), _np(want)


def test_mono_twin_matches_pallas(mono_scene):
    s, (wx, wy, wvx, wvy, wrho, wd) = mono_scene
    before = _launches()
    got = cuda_solver.mono_step_cuda(s.xd, s.yd, s.vxd, s.vyd, s.ref_xd,
                                     s.ref_yd, PARAMS, CFG, GRID, s.occ)
    assert _launches() == before          # CPU: the twin, not a launch
    x, y, vx, vy, rho, disp2 = (t.numpy() for t in got)
    np.testing.assert_allclose(rho, wrho, rtol=1e-6, atol=0)
    np.testing.assert_allclose(x, wx, rtol=0, atol=1e-6)
    np.testing.assert_allclose(y, wy, rtol=0, atol=1e-6)
    np.testing.assert_allclose(vx, wvx, rtol=0, atol=1e-5)
    np.testing.assert_allclose(vy, wvy, rtol=0, atol=1e-5)
    assert float(wd) > 0 and abs(float(disp2) - float(wd)) <= 1e-6 * wd
    # the widened density bound shows on dead slots: rho there is not K1's
    rho1 = cuda_solver.density_cuda(s.xd, s.yd, PARAMS, GRID, s.occ).numpy()
    dead = s.xd.numpy() >= 5e8
    assert (rho[dead] != rho1[dead]).any()
    tb = VGRID.row_block
    assert (rho[:tb] == 0).all() and (x[-tb:] == 1e9).all()


def test_mono_twin_matches_two_kernel_twins(mono_scene):
    """At tests/test_mono.py's bars: live-slot rho exact, positions 1e-9,
    velocities 5e-7, disp2 1e-12."""
    s, _ = mono_scene
    xm, ym, vxm, vym, rhom, dm = cuda_solver.mono_step_torch(
        s.xd, s.yd, s.vxd, s.vyd, s.ref_xd, s.ref_yd, PARAMS, CFG, GRID,
        s.occ)
    rho = cuda_solver.density_torch(s.xd, s.yd, PARAMS, GRID, s.occ)
    x2, y2, vx2, vy2, d2 = cuda_solver.forces_integrate_torch(
        s.xd, s.yd, s.vxd, s.vyd, rho, s.ref_xd, s.ref_yd, PARAMS, CFG, GRID,
        s.occ)
    live = s.xd < 5e8
    assert torch.equal(rhom[live], rho[live])
    for a, b, tol in ((xm, x2, 1e-9), (ym, y2, 1e-9), (vxm, vx2, 5e-7),
                      (vym, vy2, 5e-7)):
        assert float((a - b).abs().max()) <= tol
    assert abs(float(dm) - float(d2)) <= 1e-12


def test_mono_bounds_match_pallas_rule():
    """kmax_d widens kmax_f by the neighbouring blocks' outermost shifts,
    clamped at the grid edge (pallas_solver.py:725-731)."""
    occ = torch.tensor([[1, 2, 3, 4], [5, 1, 1, 1], [2, 7, 1, 6]],
                       dtype=torch.int32)
    grid = dataclasses.replace(GRID, ny=4 * GRID.row_block - 2)
    assert grid.n_row_blocks == 4
    kd, kf = cuda_solver.mono_bounds(occ, grid)
    assert kf.tolist() == [5, 7, 3, 6]
    assert kd.tolist() == [7, 7, 6, 6]


# ----------------------------------------------------------------- K4 field

@pytest.fixture(scope="module")
def field_planes():
    """A jittered 20x20 block (numpy seed) binned by the JAX package."""
    rng = np.random.default_rng(21)
    base = bgf.init_grid(20, 20, 0.04)
    x = (np.asarray(base.x) + rng.uniform(-0.01, 0.01, base.n))
    y = (np.asarray(base.y) + 0.02 + rng.uniform(-0.01, 0.01, base.n))
    state = bgf.from_positions(np.stack([x, y], 1).astype(np.float32))
    sim = jvs.init_dense(state, VGRID)
    return sim, convert.dense_sim_from(_np(sim), "cpu")


@pytest.mark.parametrize("P", [2, 3])
def test_field_twin_matches_pallas(field_planes, P):
    sim_j, s = field_planes
    origin = None if P == 3 else (VGRID.origin_x + 0.013,
                                  VGRID.origin_y - 0.021)
    want = np.asarray(jraster.field_density_pallas(
        sim_j.xd, sim_j.yd, PARAMS_J, VGRID, px_per_cell=P, interpret=True,
        origin=origin))
    before = _launches()
    got = traster.field_density_cuda(s.xd, s.yd, PARAMS, GRID, P,
                                     origin=origin).numpy()
    assert _launches() == before
    assert got.shape == want.shape == (VGRID.ny * P, VGRID.nx * P)
    wet = want > 0.05 * float(PARAMS.rho_0)
    assert wet.sum() > 200 and not wet.all()
    rel = np.abs(got - want)[wet] / want[wet]
    assert rel.max() <= 1e-5, rel.max()
    np.testing.assert_allclose(got[~wet], want[~wet], rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("mode", ["density", "const"])
def test_field_frame_matches_jax(field_planes, mode):
    sim_j, s = field_planes
    want = np.asarray(jraster.field_frame(sim_j.xd, sim_j.yd, PARAMS_J,
                                          VGRID, 2, mode))
    got = traster.field_frame(s.xd, s.yd, PARAMS, GRID, 2, mode)
    _assert_rgb8_close(got.numpy(), want)
    assert (want.sum(-1) > 0).any()
    render = traster.field_render(s.xd, s.yd, PARAMS, GRID, 2, mode)
    assert render.shape == (VGRID.ny * 2, VGRID.nx * 2, 3)
    assert torch.equal(traster.to_rgb8(render), got)


@pytest.mark.parametrize("which", ["field", "mono"])
def test_new_wrappers_reject_bad_inputs(which, field_planes):
    """The K4 and K5 wrappers check dtype and device and never fall back."""
    _, s = field_planes
    call = {
        "field": lambda xd: traster.field_density_cuda(xd, s.yd, PARAMS,
                                                       GRID),
        "mono": lambda xd: cuda_solver.mono_step_cuda(
            xd, s.yd, s.vxd, s.vyd, s.ref_xd, s.ref_yd, PARAMS, CFG, GRID,
            s.occ),
    }[which]
    with pytest.raises(ValueError):
        call(s.xd.double())
    with pytest.raises(ValueError):
        call(s.xd.to("meta"))


# ----------------------------------------------------- the mono-grid Session

@pytest.fixture(scope="module")
def frame_runs():
    """The kicked 24x24 block on the 7-row-block grid through both
    Sessions: 40 steps (the JAX side steps on interpret-mode mono), then
    run_frame(8), kick, run_frames(2, 8) and frame('const')."""
    state = bgf.init_grid(24, 24, 0.04)
    state = state.replace(vx=jnp.full((state.n,), 2.0))
    sj = jvs.Session(state, PARAMS_J, CFG_J, VGRID)
    st = tvs.Session(convert.state_from(_np(state), "cpu"), PARAMS, CFG,
                     GRID, device="cpu")
    before = _launches()
    sj.run(40)
    st.run(40)
    at40 = (_np(sj.sim), _np(sj.state()), st.sim, st.state())
    frames = []
    for sess, to in ((sj, np.asarray), (st, lambda t: t.numpy())):
        a = to(sess.run_frame(8))
        sess.kick(0.3, 0.2, 0.8, 0.6)
        kicked = sess.state()
        b = to(sess.run_frames(2, 8))
        c = to(sess.frame(mode="const"))
        frames.append((a, _np(kicked) if sess is sj else kicked, b, c))
    return sj, st, at40, frames, before


def test_mono_session_counters_match_jax(frame_runs):
    _, _, (simj, _, sim, _), _, _ = frame_runs
    assert sim.rebin_count == int(simj.rebin_count) >= 3
    assert sim.step == int(simj.step) == 40
    assert (sim.overflow, sim.lost, sim.readmitted) == \
        (int(simj.overflow), int(simj.lost), int(simj.readmitted))
    np.testing.assert_array_equal(sim.idx_d.numpy(), simj.idx_d)
    np.testing.assert_array_equal(sim.occ.numpy(), simj.occ)


def test_mono_session_particles_match_jax(frame_runs):
    _, _, (_, want, _, got), _, before = frame_runs
    assert got.step == 40
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.y.numpy(), want.y, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.vx.numpy(), want.vx, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.vy.numpy(), want.vy, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.rho.numpy(), want.rho, rtol=1e-5, atol=0)
    assert _launches() == before          # twins only on the CPU


def test_frame_methods_match_jax(frame_runs):
    """run_frame, kick, run_frames and frame against the JAX Session's: the
    same frames to +-1, the same kicked velocities, and after 64 steps the
    same particles at the Session bars."""
    sj, st, _, ((ja, jk, jb, jc), (ta, tk, tb, tc)), _ = frame_runs
    assert ta.shape == (VGRID.ny * 2, VGRID.nx * 2, 3)
    assert tb.shape == (2,) + ta.shape
    for got, want in ((ta, ja), (tb, jb), (tc, jc)):
        _assert_rgb8_close(got, want)
    assert (ta.sum(-1) > 0).any() and (tc[..., 1] == 255).any()
    np.testing.assert_allclose(tk.vx.numpy(), jk.vx, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tk.vy.numpy(), jk.vy, rtol=0, atol=1e-4)
    assert float(tk.vx.max()) >= 8.0      # impulse 10 x dir 0.8
    assert st.sim.step == int(sj.sim.step) == 64
    want, got = _np(sj.state()), st.state()
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.vy.numpy(), want.vy, rtol=0, atol=1e-4)


def test_run_frames_is_sequential_run_frame():
    """run_frames(3, 4) walks the same trajectory as three run_frame(4)
    calls, bitwise on the state planes and the frames."""
    state = bt.init_grid(12, 12, 0.04, "cpu")
    state = state.replace(vx=torch.full((state.n,), 1.5))
    a = tvs.Session(state, PARAMS, CFG, GRID, device="cpu")
    b = tvs.Session(state, PARAMS, CFG, GRID, device="cpu")
    imgs = a.run_frames(3, substeps=4)
    seq = torch.stack([b.run_frame(substeps=4) for _ in range(3)])
    assert imgs.dtype == torch.uint8 and torch.equal(imgs, seq)
    for f in ("xd", "yd", "vxd", "vyd", "rho_d", "idx_d"):
        assert torch.equal(getattr(a.sim, f), getattr(b.sim, f)), f
    assert a.sim.step == 12 and a.sim.rebin_count == b.sim.rebin_count


def test_session_reset_reseeds():
    state = bt.init_grid(12, 12, 0.04, "cpu")
    sess = tvs.Session(state, PARAMS, CFG, GRID, device="cpu")
    sess.run(6)
    sess.reset(state.replace(step=3))
    fresh = tvs.init_dense(state, GRID)
    assert sess.sim.step == 3 and sess.sim.rebin_count == 1
    assert torch.equal(sess.sim.xd, fresh.xd)
    with pytest.raises(ValueError):
        sess.reset(bt.init_grid(3, 3, 0.04, "cpu"))


# ----------------------------------------------------------------- splat

def _splat_scene():
    """A jittered 12x12 block (numpy seed) with golden densities, kept at
    least S/2 + 1 pixels inside the 128 x 128 raster of [-0.5, 1.5]^2."""
    rng = np.random.default_rng(31)
    base = bgf.init_grid(12, 12, 0.04)
    x = np.asarray(base.x) + 0.2 + rng.uniform(-0.01, 0.01, base.n)
    y = np.asarray(base.y) + 0.2 + rng.uniform(-0.01, 0.01, base.n)
    sj = bgf.from_positions(np.stack([x, y], 1).astype(np.float32))
    return jgolden.density_pressure(sj, PARAMS_J)


def test_splat_matches_jax():
    sj = _splat_scene()
    st = convert.state_from(_np(sj), "cpu")
    spec_j = jraster.RasterSpec.fit(-0.5, 1.5, -0.5, 1.5, width=128)
    spec = traster.RasterSpec.fit(-0.5, 1.5, -0.5, 1.5, width=128)
    assert dataclasses.asdict(spec) == dataclasses.asdict(spec_j)
    for mode in ("density", "const"):
        want = np.asarray(jraster.render(sj, PARAMS_J, spec_j, mode))
        got = traster.render(st, PARAMS, spec, mode)
        assert got.shape == (spec.height, spec.width, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        _assert_rgb8_close(traster.to_rgb8(got).numpy(),
                           np.asarray(jraster.to_rgb8(jnp.asarray(want))))
    t = np.linspace(0, 1, 9, dtype=np.float32)
    np.testing.assert_allclose(
        traster.density_color(torch.from_numpy(t)).numpy(),
        np.asarray(jraster.density_color(jnp.asarray(t))), atol=1e-6)


def test_splat_drops_negative_stamp_pixels():
    """S5: a particle at the bottom-left corner of a 64 x 64 raster.  The
    reference's drop-mode scatter wraps the stamp's negative rows and
    columns to the top and right edges; the port drops them."""
    spec = traster.RasterSpec(x0=0.0, y0=0.0, scale=64.0, height=64,
                              width=64)
    pos = np.array([[0.002, 0.002]], np.float32)
    sj = jgolden.density_pressure(bgf.from_positions(pos), PARAMS_J)
    st = convert.state_from(_np(sj), "cpu")
    cyan = torch.tensor([[0.0, 1.0, 1.0]])
    got = traster.splat(st, PARAMS, spec, cyan).numpy().sum(-1)
    want = np.asarray(jraster.splat(sj, PARAMS_J, jraster.RasterSpec(
        0.0, 0.0, 64.0, 64, 64), jnp.asarray(cyan.numpy()))).sum(-1)
    half = spec.stamp // 2
    assert got[0, 0] > 0 and want[0, 0] > 0
    assert (got[half + 1:] == 0).all() and (got[:, half + 1:] == 0).all()
    assert want[63].any() and want[:, 63].any()     # the reference's wrap
    np.testing.assert_allclose(got[:half + 1, :half + 1] > 0,
                               want[:half + 1, :half + 1] > 0)


# ----------------------------------------------------------------- impulse

def test_impulse_matches_jax():
    rng = np.random.default_rng(41)
    pos = rng.uniform(0, 1, (200, 2)).astype(np.float32)
    v = rng.uniform(-1, 1, (2, 200)).astype(np.float32)
    sj = bgf.from_positions(pos).replace(vx=jnp.asarray(v[0]),
                                         vy=jnp.asarray(v[1]))
    st = convert.state_from(_np(sj), "cpu")
    want = jimpulse.apply_impulse(sj, 0.5, 0.4, 0.3, -0.7)
    got = timpulse.apply_impulse(st, 0.5, 0.4, 0.3, -0.7)
    hit = np.asarray(want.vx) != v[0]
    assert 0 < hit.sum() < 200
    np.testing.assert_array_equal(got.vx.numpy(), np.asarray(want.vx))
    np.testing.assert_array_equal(got.vy.numpy(), np.asarray(want.vy))
    assert torch.equal(got.x, st.x)


# ----------------------------------------------------------------- pump

@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_pump_order_and_completeness(kind):
    pump = FramePump(pull=True)
    frames = [np.full((2, 2), i, np.uint8) for i in range(5)]
    if kind == "tensor":
        frames = [torch.from_numpy(f) for f in frames]
    out = [pump.push(f) for f in frames]
    assert out[0] is None
    got = [o for o in out if o is not None] + [pump.flush()]
    assert len(got) == len(frames)
    for i, g in enumerate(got):
        assert isinstance(g, np.ndarray) and int(g[0, 0]) == i
    assert pump.flush() is None


def test_pump_device_mode():
    pump = FramePump(pull=False)
    assert pump.push(torch.zeros(2)) is None
    b = pump.push(torch.ones(2))
    assert isinstance(b, torch.Tensor) and float(b[0]) == 0.0
    assert float(pump.flush()[0]) == 1.0 and pump.flush() is None


# ----------------------------------------------------------------- facade

def test_simulation_verlet_facade():
    """The resident verlet facade: the same trajectory as a hand-held
    Session, run() returns None, lazy state, kick, the state setter, and
    frames in the splat and field modes."""
    sim = bt.Simulation.dam_break(n=256, device="cpu")
    sess = tvs.Session(bt.init_grid(16, 16, 0.04, "cpu"), PARAMS,
                       bt.IntegrateConfig.create(),
                       tvs.default_grid(0.045, -5.0, 3.0, y_max=4.0),
                       device="cpu")
    assert sim.run(30) is None
    sim.run(20)
    sess.run(50)
    a, b = sim.state, sess.state()
    assert torch.equal(a.x, b.x) and torch.equal(a.vx, b.vx)
    assert a.step == 50 and sim.overflow == 0
    assert sim.state is a                        # cached until a change

    img = sim.frame()
    assert img.dtype == torch.uint8 and img.shape == (sim.spec.height, 512, 3)
    assert (img.sum(-1) > 30).any()
    const = sim.frame("const").numpy()
    lit = const.sum(-1) > 0
    assert lit.any() and (const[lit][:, 1] == const[lit][:, 2]).all()
    field = sim.frame("field")
    assert field.shape == (sim.grid.ny * 2, sim.grid.nx * 2, 3)
    assert torch.equal(field, sess.frame())
    assert sim.frame("field_const").shape == field.shape

    sim.kick(0.3, 0.3, dir_x=1.0, dir_y=0.0)
    assert float(sim.state.vx.max()) >= 10.0
    frames = sim.run_frames(2, substeps=4, mode="field")
    assert frames.shape == (2,) + field.shape and sim.state.step == 58
    splats = sim.run_frames(2, substeps=2)
    assert splats.shape == (2, sim.spec.height, 512, 3)
    assert sim.run_frame(2).shape == img.shape and sim.state.step == 64

    sim.state = bt.init_grid(16, 16, 0.04, "cpu")   # re-seeds the session
    assert sim.state.step == 0 and sim._session.sim.rebin_count == 1
    sim.run(5)
    assert bool(torch.isfinite(sim.state.x).all())


def test_simulation_golden_facade():
    sim = bt.Simulation.dam_break(n=64, solver="golden", device="cpu")
    assert sim._session is None
    start = sim.state
    assert sim.run(3) is None
    want = tgolden.multi_step(start, sim.params, sim.cfg, 3)
    assert torch.equal(sim.state.x, want.x) and sim.state.step == 3
    field = sim.frame("field")
    assert field.shape == (sim.grid.ny * 2, sim.grid.nx * 2, 3)
    assert (field.sum(-1) > 0).any()
    assert sim.frame("field_const").shape == field.shape   # cached binning
    imgs = sim.run_frames(2, substeps=2)
    assert imgs.shape == (2, sim.spec.height, 512, 3) and sim.state.step == 7
    sim.kick(0.1, 0.1, 1.0, 0.0)
    assert float(sim.state.vx.max()) >= 10.0
    assert sim.overflow == 0


def test_simulation_pool_builder():
    sim = bt.Simulation.pool(n=2000, device="cpu")
    assert sim.state.n == 11 * 181 and float(sim.cfg.bounce) == -0.5
    assert sim.grid.n_row_blocks < cuda_solver.MONO_MAX_BLOCKS
    sim.run(2)
    assert sim.overflow == 0


def test_simulation_unported_options_raise():
    state = bt.init_grid(4, 4, 0.04, "cpu")
    grid = tvs.default_grid(0.045, -5.0, 3.0, y_max=4.0)
    for solver in ("pallas", "xla"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            bt.Simulation(state, PARAMS, CFG, grid, solver=solver,
                          device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bt.Simulation(state, PARAMS, CFG, grid, validate_every=5,
                      device="cpu")
    sim = bt.Simulation(state, PARAMS, CFG, grid, device="cpu")
    for call in (sim.validate, lambda: sim.save("x"), lambda: sim.load("x")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    with pytest.raises(ValueError):
        bt.Simulation(state, PARAMS, CFG, grid, solver="nope", device="cpu")


def test_entry_points_default_to_the_gpu():
    """Session and Simulation put their state on the GPU unless asked for
    the CPU: here, with no GPU, the default fails instead of falling back."""
    import inspect
    for fn in (tvs.Session.__init__, bt.Simulation.__init__,
               bt.Simulation.dam_break, bt.Simulation.pool):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            bt.Simulation.dam_break(n=16)

