"""The port's flagship Session end to end on the CPU: against the JAX
Session per particle, through the overflow recovery cycle, and against the
golden models at the reference parity bars.

The JAX Session runs as on any CPU: Pallas density and fused forces in
interpret mode, the rebin through ``reslot_xla``.  The port's Session runs
its kernel wrappers on CPU tensors, i.e. the kernels' PyTorch twins.

Tolerances of the Session gate (40 steps, several rebins): positions 1e-5
absolute, velocities 1e-4 absolute, density 1e-5 relative — the same pair
sums in the same order, with FP contraction the only difference, amplified
over 40 steps; the integer counters (rebins, overflow, lost, readmitted)
and the final slot assignment are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gpu_fluid_tpu as bgf
from bevy_gpu_fluid_tpu.models import reference as jgolden
from bevy_gpu_fluid_tpu.models import verlet_solver as jvs

import bevy_gpu_fluid_tpu_torch as bt
from bevy_gpu_fluid_tpu_torch.models import reference as tgolden
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as tvs
from bevy_gpu_fluid_tpu_torch.ops.binning import FAR
from bevy_gpu_fluid_tpu_torch.utils import convert

torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _slice_scene():
    """A 24x24 lattice kicked to vx=+2 on a 12-row-block grid (so the JAX
    side runs density + fused forces, not the mono kernel): the JAX state,
    params, cfg and grid."""
    params = bgf.FluidParams.demo()
    cfg = bgf.IntegrateConfig.create(x_min=-1.0, x_max=2.5)
    grid = jvs.default_grid(0.045, -1.0, 2.5, y_max=6.0)
    assert grid.n_row_blocks == 12
    state = bgf.init_grid(24, 24, 0.04)
    return state.replace(vx=jnp.full((state.n,), 2.0)), params, cfg, grid


def _port_session(state, params, cfg, grid):
    return tvs.Session(convert.state_from(_np(state), "cpu"),
                       convert.params_from(params), convert.cfg_from(cfg),
                       convert.grid_from(grid), device="cpu")


@pytest.fixture(scope="module")
def slice_runs():
    """The slice scene, 40 steps through both Sessions."""
    scene = _slice_scene()
    sj = jvs.Session(*scene)
    sj.run(40)
    st = _port_session(*scene)
    st.run(40)
    return sj, st


def test_session_counters_match_jax(slice_runs):
    sj, st = slice_runs
    assert st.sim.rebin_count == int(sj.sim.rebin_count) >= 3
    assert st.sim.step == int(sj.sim.step) == 40
    assert st.sim.overflow == int(sj.sim.overflow)
    assert st.sim.lost == int(sj.sim.lost) == 0
    assert st.readmitted == sj.readmitted
    assert st.suspended == sj.suspended
    np.testing.assert_array_equal(st.sim.idx_d.numpy(),
                                  np.asarray(sj.sim.idx_d))
    np.testing.assert_array_equal(st.sim.occ.numpy(), np.asarray(sj.sim.occ))


def test_session_particles_match_jax(slice_runs):
    sj, st = slice_runs
    want = _np(sj.state())
    got = st.state()
    assert got.step == 40
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.y.numpy(), want.y, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.vx.numpy(), want.vx, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.vy.numpy(), want.vy, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.rho.numpy(), want.rho, rtol=1e-5, atol=0)
    # the kick carried the block right: the step really moved it
    assert float(got.x.mean()) > float(np.asarray(
        bgf.init_grid(24, 24, 0.04).x).mean()) + 0.03


def test_step_from_jax_dense_sim_matches(slice_runs):
    """Stepping on from the JAX Session's own dense state: one more rebin-
    checked step in each package agrees (the port's DenseSim built from the
    JAX leaves by utils/convert)."""
    sj, st = slice_runs
    sim = convert.dense_sim_from(_np(sj.sim), "cpu")
    stepf = tvs.make_step(st.params, st.cfg, st.grid, n=st.n)
    got = stepf(sim)
    want = jax.jit(jvs.make_step(sj.params, sj.cfg, sj.grid, n=sj.n))(
        sj.sim)
    np.testing.assert_allclose(got.xd.numpy(), np.asarray(want.xd), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got.idx_d.numpy(), np.asarray(want.idx_d))
    assert got.age == int(want.age) and got.step == int(want.step)


@pytest.mark.parametrize("chunk", [7, 64])
def test_session_run_chunks_bitwise_one_run(slice_runs, chunk):
    """``run(40, chunk=k)``, the reference's API: sequential calls of at
    most k steps give ``run(40)``'s DenseSim bit for bit, so the JAX
    Session's counters and slot assignment too."""
    sj, st = slice_runs
    sc = _port_session(*_slice_scene())
    with pytest.raises(ValueError):
        sc.run(4, chunk=0)
    assert sc.sim.step == 0
    sc.run(40, chunk=chunk)
    for f in dataclasses.fields(tvs.DenseSim):
        a, b = getattr(sc.sim, f.name), getattr(st.sim, f.name)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), f.name
    assert sc.sim.rebin_count == int(sj.sim.rebin_count) >= 3
    np.testing.assert_array_equal(sc.sim.idx_d.numpy(),
                                  np.asarray(sj.sim.idx_d))


@pytest.mark.parametrize("solver", ["verlet", "xla"])
def test_simulation_overflow_setter_matches_jax(solver):
    """``Simulation.overflow`` can be set; on the verlet engine it reads
    the larger of the set value and the Session's count, as the
    reference's does (9 particles in one cell at cap 8: the Session counts
    one drop at init)."""
    params = bgf.FluidParams.demo()
    cfg = bgf.IntegrateConfig.create(x_min=-1.0, x_max=2.5, bounce=-0.5)
    grid = jvs.default_grid(0.045, -1.0, 2.5, y_max=3.0)
    if solver == "xla":
        grid = bgf.GridSpec2D.from_bounds(h=0.045, x_min=-1.0, x_max=2.5,
                                          y_min=0.0, y_max=3.0)
    state = bgf.init_grid(3, 3, 0.004)
    sj = bgf.Simulation(state, params, cfg, grid, solver=solver)
    st = bt.Simulation(convert.state_from(_np(state), "cpu"),
                       convert.params_from(params), convert.cfg_from(cfg),
                       convert.grid_from(grid), solver=solver, device="cpu")
    start = 1 if solver == "verlet" else 0
    assert st.overflow == sj.overflow == start
    for v in (5, 0):
        sj.overflow = v
        st.overflow = v
        assert st.overflow == sj.overflow == max(v, start)


@pytest.fixture(scope="module")
def recovery_runs():
    """The tests/test_overflow.py recovery scene (9 particles in one cell
    at cap 8, bounce -0.5) through both Sessions: 60 violent steps."""
    params = bgf.FluidParams.demo()
    cfg = bgf.IntegrateConfig.create(x_min=-1.0, x_max=2.5, bounce=-0.5)
    grid = jvs.default_grid(0.045, -1.0, 2.5, y_max=3.0)
    state = bgf.init_grid(3, 3, 0.004)
    sj = jvs.Session(state, params, cfg, grid)
    sj.run(60)
    st = tvs.Session(bt.init_grid(3, 3, 0.004, "cpu"),
                     convert.params_from(params), convert.cfg_from(cfg),
                     convert.grid_from(grid), device="cpu")
    init = (st.overflow, st.suspended, st.state())
    st.run(60)
    return sj, st, init


def test_recovery_suspends_counts_and_readmits(recovery_runs):
    """On the port: one particle spills at init, rebins fire as the cluster
    blasts apart, and the spilled particle re-admits; ids across the idx
    planes and the spill buffer stay exactly {0..n-1}."""
    _, sess, (overflow0, suspended0, s0) = recovery_runs
    assert overflow0 == 1 and suspended0 == 1
    assert bool(torch.isfinite(s0.x).all() & (s0.x < FAR * 0.5).all())
    assert sess.readmitted >= 1
    ids = torch.cat([sess.sim.idx_d.reshape(-1), sess.sim.sidx])
    ids = torch.sort(ids).values[-sess.n:]
    assert torch.equal(ids, torch.arange(sess.n, dtype=torch.int32))
    out = sess.state()
    assert bool((out.x < FAR * 0.5).all() & torch.isfinite(out.vx).all())
    assert float((out.x[8] - s0.x[8]).abs() + (out.y[8] - s0.y[8]).abs()) > 0


def test_recovery_matches_jax(recovery_runs):
    """Both Sessions through the recovery scene: identical counters, slot
    assignment and spill buffer."""
    sj, st, _ = recovery_runs
    assert st.sim.rebin_count == int(sj.sim.rebin_count)
    assert (st.overflow, st.readmitted, st.suspended) == \
        (sj.overflow, sj.readmitted, sj.suspended)
    np.testing.assert_array_equal(st.sim.idx_d.numpy(),
                                  np.asarray(sj.sim.idx_d))
    np.testing.assert_array_equal(st.sim.sidx.numpy(), np.asarray(sj.sim.sidx))


def test_recovery_off_counts_losses_as_far():
    """recovery=False: drops are counted, the spill buffer stays empty and
    nothing re-admits; every loss surfaces as FAR."""
    params = bt.FluidParams.demo()
    cfg = bt.IntegrateConfig.create(x_min=-1.0, x_max=2.5, bounce=-0.5)
    grid = tvs.default_grid(0.045, -1.0, 2.5, y_max=3.0)
    sess = tvs.Session(bt.init_grid(3, 3, 0.004, "cpu"), params, cfg, grid,
                       device="cpu", recovery=False)
    assert sess.sim.overflow == 1 and sess.suspended == 0
    sess.run(20)
    assert sess.overflow >= 1 and sess.suspended == 0
    assert sess.readmitted == 0
    x = sess.state().x
    assert int((x >= FAR * 0.5).sum()) == sess.overflow


def test_golden_matches_jax_golden():
    """Port golden vs JAX golden, 5 steps of a jittered, moving block:
    the same all-pairs sums in another summation order."""
    rng = np.random.default_rng(5)
    base = bgf.init_grid(16, 16, 0.04)
    n = base.n
    x = (np.asarray(base.x) + rng.uniform(-0.01, 0.01, n)).astype(np.float32)
    y = (np.asarray(base.y) + rng.uniform(0.0, 0.01, n)).astype(np.float32)
    v = rng.uniform(-1, 1, (2, n)).astype(np.float32)
    sj = bgf.from_positions(np.stack([x, y], 1)).replace(
        vx=jnp.asarray(v[0]), vy=jnp.asarray(v[1]))
    params, cfg = bgf.FluidParams.demo(), bgf.IntegrateConfig.create()
    want = _np(jax.jit(lambda s: jgolden.multi_step(s, params, cfg, 5))(sj))
    got = tgolden.multi_step(convert.state_from(_np(sj), "cpu"),
                             convert.params_from(params),
                             convert.cfg_from(cfg), 5)
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.y.numpy(), want.y, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.vx.numpy(), want.vx, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.vy.numpy(), want.vy, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.rho.numpy(), want.rho, rtol=1e-5)
    np.testing.assert_allclose(got.ax.numpy(), want.ax, rtol=1e-4, atol=1e-2)
    assert got.step == 5


def test_session_parity_bars_vs_golden():
    """The port Session against the port golden model on the reference's
    5,041-particle scene, 10 steps, at the tests/test_parity.py bars."""
    state, params = bt.demo_block_5k("cpu")
    cfg = bt.IntegrateConfig.create()
    grid = tvs.default_grid(0.045, -5.0, 3.0, y_max=4.0)
    g = tgolden.multi_step(state, params, cfg, 10)
    sess = tvs.Session(state, params, cfg, grid, device="cpu")
    sess.run(10)
    a = sess.state()
    assert sess.overflow == 0
    assert float(((a.rho - g.rho).abs() / g.rho).max()) <= 0.003
    assert float((a.p - g.p).abs().max()) <= 30.0
    dx = max(float((a.x - g.x).abs().max()), float((a.y - g.y).abs().max()))
    dv = max(float((a.vx - g.vx).abs().max()),
             float((a.vy - g.vy).abs().max()))
    assert dx <= 0.000518 and dv <= 0.245602
