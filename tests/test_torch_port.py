"""The PyTorch port (bevy_gpu_fluid_tpu_torch) against the JAX package,
piece by piece, on the CPU.

Inputs are made once, from a numpy seed, and given to both packages (the
port gets them through ``utils/convert.py``).  The JAX side runs as its own
tests run it: Pallas kernels in interpret mode, the reslot through
``reslot_xla``.  The port runs its kernels' PyTorch twins, which is what a
kernel wrapper does with a CPU tensor.

Tolerances:
* integer outputs (slot assignment, idx planes, counts, occupancy bounds,
  counters) and the sort/reslot float planes, which only move values:
  exact;
* K1 density: 1e-5 relative — same (kj, dx, dy) sum order, so only FP
  contraction in XLA:CPU can separate the two;
* K2 positions 1e-6 absolute, velocities 1e-4 of the plane's max |v|,
  disp2 1e-4 relative — one step of the same pair sum, with EOS, rsqrt and
  Euler rounding in between.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gpu_fluid_tpu as bgf
from bevy_gpu_fluid_tpu.models import pallas_solver as jps
from bevy_gpu_fluid_tpu.models import verlet_solver as jvs
from bevy_gpu_fluid_tpu.ops import reslot as jreslot
from bevy_gpu_fluid_tpu.ops.binning import bin_particles as jbin
from bevy_gpu_fluid_tpu.ops.binning import to_dense as jto_dense

import bevy_gpu_fluid_tpu_torch as bt
from bevy_gpu_fluid_tpu_torch.models import cuda_solver
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as tvs
from bevy_gpu_fluid_tpu_torch.ops import reslot as treslot
from bevy_gpu_fluid_tpu_torch.utils import convert

torch.set_num_threads(1)

PARAMS_J = bgf.FluidParams.demo()
CFG_J = bgf.IntegrateConfig.create(x_min=-1.0, x_max=2.5, bounce=-0.5)
GRID = jvs.default_grid(0.045, -1.0, 2.5, y_max=3.0)
PARAMS = convert.params_from(PARAMS_J)
CFG = convert.cfg_from(CFG_J)
GRID_T = convert.grid_from(GRID)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def jittered_state(seed=0, side=24, jitter=0.012, vmax=1.5):
    """A 24x24 lattice at 0.04 spacing, jittered and given random
    velocities from a numpy seed (float32), as a JAX FluidState."""
    rng = np.random.default_rng(seed)
    base = np.asarray(bgf.init_grid(side, side, 0.04).x), \
        np.asarray(bgf.init_grid(side, side, 0.04).y)
    n = side * side
    x = (base[0] + rng.uniform(-jitter, jitter, n)).astype(np.float32)
    y = (base[1] + 0.02 + rng.uniform(-jitter, jitter, n)).astype(np.float32)
    vx = rng.uniform(-vmax, vmax, n).astype(np.float32)
    vy = rng.uniform(-vmax, vmax, n).astype(np.float32)
    return bgf.from_positions(np.stack([x, y], 1)).replace(
        vx=jnp.asarray(vx), vy=jnp.asarray(vy))


@pytest.fixture(scope="module")
def dense_pair():
    """The same dense sim in both packages (JAX init_dense of the jittered
    scene), with K1's interpret-mode output."""
    sim_j = jvs.init_dense(jittered_state(), GRID)
    rho_j = jps.density_pallas(sim_j.xd, sim_j.yd, PARAMS_J, GRID,
                               interpret=True, occ=sim_j.occ)
    return sim_j, convert.dense_sim_from(_np(sim_j), "cpu"), rho_j


# --------------------------------------------------------------- geometry

@pytest.mark.parametrize("args", [
    (0.045, -1.0, 2.5, 3.0, 8, 1.5),      # the test scenes
    (0.045, -1.0, 2.5, 6.0, 8, 1.5),      # the slice scene: 12 row blocks
    (0.045, -1.0, 41.0, 45.0, 8, 1.5),    # the 1M bench scene
    (0.045, -1.0, 401.0, 45.0, 8, 1.5),   # wide: 4-row blocks
    (0.045, -5.0, 3.0, 4.0, 4, 1.75),
])
def test_default_grid_geometry_matches(args):
    h, x0, x1, ymax, cap, skin = args
    gj = jvs.default_grid(h, x0, x1, y_max=ymax, cap=cap, skin_factor=skin)
    gt = tvs.default_grid(h, x0, x1, y_max=ymax, cap=cap, skin_factor=skin)
    assert dataclasses.asdict(gt) == dataclasses.asdict(gj)
    for prop in ("num_cells", "nx_pad", "n_row_blocks", "row0", "ny_pad"):
        assert getattr(gt, prop) == getattr(gj, prop), prop


def test_bench_grid_shape():
    g = tvs.default_grid(0.045, -1.0, 41.0, y_max=45.0)
    assert (g.ny_pad, g.cap, g.nx_pad) == (696, 8, 640)


def test_init_grid_and_params_bitwise():
    sj = bgf.init_grid(37, 23, 0.04)
    st = bt.init_grid(37, 23, 0.04, "cpu")
    np.testing.assert_array_equal(st.x.numpy(), np.asarray(sj.x))
    np.testing.assert_array_equal(st.y.numpy(), np.asarray(sj.y))
    assert st.x.dtype == torch.float32 and st.n == sj.n
    p = bt.FluidParams.demo()
    for f in ("h", "rho_0", "k", "mu", "m"):
        assert p.__dict__[f] == np.asarray(getattr(PARAMS_J, f))
    sj5, _ = bgf.demo_block_5k()
    st5, _ = bt.demo_block_5k("cpu")
    np.testing.assert_array_equal(st5.x.numpy(), np.asarray(sj5.x))


def test_self_density_and_constants_match():
    from bevy_gpu_fluid_tpu.ops.kernels import self_density as jself
    from bevy_gpu_fluid_tpu_torch.ops.kernels import self_density
    assert self_density(PARAMS) == np.float32(jself(PARAMS_J))
    assert tvs._skin(PARAMS, GRID_T) == np.float32(
        jvs._skin(PARAMS_J, GRID))


# --------------------------------------------------------------- binning

def test_init_dense_matches():
    """Sort-based init with a crowded cell (so the spill buffer fills):
    every plane, the occupancy bounds, the spill buffer and the overflow
    count equal the JAX package's."""
    sj = jittered_state(seed=1)
    crowd = bgf.init_grid(3, 4, 0.004)
    sj = sj.replace(**{f: jnp.concatenate([getattr(sj, f),
                                           getattr(crowd, f) + 0.3])
                       for f in ("x", "y", "vx", "vy")})
    want = _np(jvs.init_dense(sj, GRID))
    got = tvs.init_dense(convert.state_from(_np(sj), "cpu"), GRID_T)
    for f in ("xd", "yd", "vxd", "vyd", "idx_d", "occ",
              "sx", "sy", "svx", "svy", "sidx"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f), err_msg=f)
    assert got.overflow == int(want.overflow) >= 4
    assert got.suspended == int(jnp.sum(want.sidx >= 0)) >= 4
    assert got.rebin_count == 1 and got.idx_d.dtype == torch.int32


def test_block_kmax3_matches(dense_pair):
    sim_j, sim_t, _ = dense_pair
    np.testing.assert_array_equal(
        treslot.block_kmax3(sim_t.xd, GRID_T).numpy(),
        np.asarray(jreslot.block_kmax3(sim_j.xd, GRID)))


# --------------------------------------------------------------- K1 / K2

def test_density_twin_matches_pallas(dense_pair):
    sim_j, sim_t, rho_j = dense_pair
    rho = cuda_solver.density_cuda(sim_t.xd, sim_t.yd, PARAMS, GRID_T,
                                   sim_t.occ)
    want = np.asarray(rho_j)
    live = sim_t.xd.numpy() < 5e8
    assert live.sum() > 500
    rel = np.abs(rho.numpy() - want)[live] / want[live]
    assert rel.max() <= 1e-5, rel.max()
    tb = GRID.row_block
    assert (rho[:tb] == 0).all() and (rho[-tb:] == 0).all()


def test_forces_integrate_twin_matches_pallas(dense_pair):
    sim_j, sim_t, rho_j = dense_pair
    # reference positions one skin-fraction away, so disp2 is not trivial
    rng = np.random.default_rng(3)
    shift = rng.uniform(-0.005, 0.005, sim_t.xd.shape).astype(np.float32)
    live = np.asarray(sim_j.xd) < 5e8
    refx = np.where(live, np.asarray(sim_j.xd) + shift, np.asarray(sim_j.xd))
    want = jps.forces_integrate_pallas(
        sim_j.xd, sim_j.yd, sim_j.vxd, sim_j.vyd, rho_j, jnp.asarray(refx),
        sim_j.ref_yd, PARAMS_J, CFG_J, GRID, interpret=True, occ=sim_j.occ)
    got = cuda_solver.forces_integrate_cuda(
        sim_t.xd, sim_t.yd, sim_t.vxd, sim_t.vyd, _t(rho_j), _t(refx),
        sim_t.ref_yd, PARAMS, CFG, GRID_T, sim_t.occ)
    wx, wy, wvx, wvy, wd = (np.asarray(a) for a in want)
    np.testing.assert_allclose(got[0].numpy(), wx, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), wy, rtol=0, atol=1e-6)
    vscale = max(np.abs(wvx).max(), np.abs(wvy).max())
    assert vscale > 0.5
    np.testing.assert_allclose(got[2].numpy(), wvx, rtol=0,
                               atol=1e-4 * vscale)
    np.testing.assert_allclose(got[3].numpy(), wvy, rtol=0,
                               atol=1e-4 * vscale)
    assert wd > 0 and abs(float(got[4]) - wd) <= 1e-4 * wd
    # ghost blocks carry the empty fills
    tb = GRID.row_block
    assert (got[0][:tb] == 1e9).all() and (got[2][-tb:] == 0).all()


# --------------------------------------------------------------- K3

def test_reslot_twin_matches_reslot_xla_crowded():
    """Particles of a 3x3 cell neighbourhood all move into one cell (so
    its count exceeds cap) and the rest move by less than the skin: all
    six reslot outputs equal reslot_xla's exactly."""
    sj = jittered_state(seed=2)
    rng = np.random.default_rng(4)
    x0, y0 = np.asarray(sj.x), np.asarray(sj.y)
    skin_half = (GRID.cell_size - 0.045) * 0.5
    x2 = x0 + rng.uniform(-1, 1, x0.shape) * skin_half * 0.95
    y2 = np.maximum(y0 + rng.uniform(-1, 1, y0.shape) * skin_half * 0.95, 0)
    px, py = 0.5, 0.5
    near = (np.abs(x0 - px) < 1.5 * GRID.cell_size) \
        & (np.abs(y0 - py) < 1.5 * GRID.cell_size)
    x2[near] = px + rng.uniform(0, 0.3, near.sum()) * GRID.cell_size
    y2[near] = py + rng.uniform(0, 0.3, near.sum()) * GRID.cell_size
    x2, y2 = x2.astype(np.float32), y2.astype(np.float32)
    b = jbin(sj.x, sj.y, GRID, with_csr=False)
    planes = [jto_dense(b, jnp.asarray(x2), fill=1e9),
              jto_dense(b, jnp.asarray(y2), fill=1e9),
              jto_dense(b, sj.vx), jto_dense(b, sj.vy),
              jto_dense(b, jnp.arange(sj.n, dtype=jnp.int32), fill=-1)]
    want = jreslot.reslot_xla(*planes, GRID)
    got = treslot.reslot_cuda(*(_t(p) for p in planes), GRID_T)
    for name, g, w in zip(("x", "y", "vx", "vy", "idx", "cnt"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[4].dtype == torch.int32 and got[5].dtype == torch.int32
    assert int(got[5].max()) > GRID.cap


# --------------------------------------------------------------- wrappers

@pytest.mark.parametrize("which", ["density", "forces", "reslot"])
def test_wrappers_reject_bad_inputs(which, dense_pair):
    """A wrapper checks dtype and device and never falls back: a plane of
    the wrong dtype, or a tensor on a device that is neither the CPU nor a
    GPU, raises."""
    _, s, _ = dense_pair
    call = {
        "density": lambda xd: cuda_solver.density_cuda(
            xd, s.yd, PARAMS, GRID_T, s.occ),
        "forces": lambda xd: cuda_solver.forces_integrate_cuda(
            xd, s.yd, s.vxd, s.vyd, s.rho_d, s.ref_xd, s.ref_yd, PARAMS,
            CFG, GRID_T, s.occ),
        "reslot": lambda xd: treslot.reslot_cuda(
            xd, s.yd, s.vxd, s.vyd, s.idx_d, GRID_T),
    }[which]
    with pytest.raises(ValueError):
        call(s.xd.double())
    with pytest.raises(ValueError):
        call(s.xd.to("meta"))
    counts = (cuda_solver.density_cuda.launches,
              cuda_solver.forces_integrate_cuda.launches,
              treslot.reslot_cuda.launches)
    call(s.xd)          # CPU: the twin, not a launch
    assert counts == (cuda_solver.density_cuda.launches,
                      cuda_solver.forces_integrate_cuda.launches,
                      treslot.reslot_cuda.launches)


# --------------------------------------------------------------- package

def test_port_imports_no_jax():
    code = ("import sys, bevy_gpu_fluid_tpu_torch, "
            "bevy_gpu_fluid_tpu_torch.models.verlet_solver, "
            "bevy_gpu_fluid_tpu_torch.models.reference, "
            "bevy_gpu_fluid_tpu_torch.models.grid_solver, "
            "bevy_gpu_fluid_tpu_torch.models.cuda_solver, "
            "bevy_gpu_fluid_tpu_torch.ops.reslot, "
            "bevy_gpu_fluid_tpu_torch.utils.validator, "
            "bevy_gpu_fluid_tpu_torch.utils.convert, "
            "bevy_gpu_fluid_tpu_torch.utils.checkpoint, "
            "bevy_gpu_fluid_tpu_torch.render.raster, "
            "bevy_gpu_fluid_tpu_torch.render.pump, "
            "bevy_gpu_fluid_tpu_torch.interact.impulse, "
            "bevy_gpu_fluid_tpu_torch.core.simulation, "
            "bevy_gpu_fluid_tpu_torch.parallel.sharded_session, "
            "bevy_gpu_fluid_tpu_torch.parallel.shard_verlet, "
            "bevy_gpu_fluid_tpu_torch.parallel.shard_render, "
            # the entry and tooling surface
            "bevy_gpu_fluid_tpu_torch.entry, "
            "bevy_gpu_fluid_tpu_torch.utils.aot, "
            "bevy_gpu_fluid_tpu_torch.utils.profiling, "
            "bevy_gpu_fluid_tpu_torch.kernels.ops, "
            "bevy_gpu_fluid_tpu_torch.native, "
            "bevy_gpu_fluid_tpu_torch.render.png, "
            "bevy_gpu_fluid_tpu_torch.examples.demo, "
            "bevy_gpu_fluid_tpu_torch.examples.spin, "
            "bevy_gpu_fluid_tpu_torch.examples.interactive, "
            "bevy_gpu_fluid_tpu_torch.examples.sharded_demo; "
            # the very-large-N slab postures, driven: they import lazily
            "import torch, bevy_gpu_fluid_tpu_torch as bt; "
            "torch.set_num_threads(1); "
            "from bevy_gpu_fluid_tpu_torch.parallel import shard; "
            "from bevy_gpu_fluid_tpu_torch.parallel.mesh import SlabMesh; "
            "from bevy_gpu_fluid_tpu_torch.parallel.sharded_session import "
            "ShardedSession; "
            "spec = shard.ShardSpec.build(h=0.0675, x_min=-1.0, x_max=2.5, "
            "y_max=3.0, n_devices=2, capacity=512); "
            "s = ShardedSession.from_generator(bt.lattice_gen(12, 0.04, "
            "'cpu'), 144, bt.FluidParams.demo(), bt.IntegrateConfig.create("
            "x_min=-1.0, x_max=2.5), spec, SlabMesh(['cpu'] * 2), "
            "refless_trigger=True, planar_rebin=True, segmented=True, "
            "fused=False); s.run(2); "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'bevy_gpu_fluid_tpu.')) "
            "or m == 'bevy_gpu_fluid_tpu' or m == 'PIL' "
            "or m.startswith('PIL.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_dense_sim_convert_roundtrip(dense_pair):
    sim_j, sim_t, _ = dense_pair
    assert sim_t.xd.dtype == torch.float32 and sim_t.idx_d.dtype == torch.int32
    assert sim_t.occ.dtype == torch.int32
    assert isinstance(sim_t.age, int) and sim_t.rebin_count == 1
    np.testing.assert_array_equal(sim_t.idx_d.numpy(), np.asarray(sim_j.idx_d))


def test_gather_slots_and_state_builders_match(dense_pair):
    """gather_slots reads the same per-particle values as the JAX
    package's (overflowed particles get the fallback); from_positions and
    make_state build the same scenes."""
    from bevy_gpu_fluid_tpu.ops.binning import gather_slots as jgather
    from bevy_gpu_fluid_tpu_torch.ops.binning import (bin_particles,
                                                      gather_slots)
    sj = jittered_state(seed=6)
    bj = jbin(sj.x, sj.y, GRID, with_csr=False)
    fields = [jto_dense(bj, sj.x, fill=1e9), jto_dense(bj, sj.vy)]
    want = jgather(GRID, bj.cx, bj.cy, bj.rank, fields, [-1.0, 7.0])
    st = convert.state_from(_np(sj), "cpu")
    b = bin_particles(st.x, st.y, GRID_T)
    for name in ("cx", "cy", "rank"):
        np.testing.assert_array_equal(getattr(b, name).numpy(),
                                      np.asarray(getattr(bj, name)))
    got = gather_slots(GRID_T, b.cx, b.cy, b.rank,
                       [_t(f) for f in fields], [-1.0, 7.0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pos = np.random.default_rng(7).uniform(0, 1, (50, 2)).astype(np.float32)
    a, b2 = bt.from_positions(pos, "cpu"), bgf.from_positions(pos)
    np.testing.assert_array_equal(a.y.numpy(), np.asarray(b2.y))
    assert float(a.vx.abs().sum()) == 0 and a.step == 0
    (ms, mp), (js, jp) = bt.make_state(1000, "cpu"), bgf.make_state(1000)
    np.testing.assert_array_equal(ms.x.numpy(), np.asarray(js.x))
    assert mp == PARAMS


def test_multi_step_matches_session():
    """multi_step (fresh binning, run, extract) computes exactly what a
    Session split across run() calls does."""
    state = bt.init_grid(12, 12, 0.04, "cpu")
    state = state.replace(vx=torch.full((state.n,), 1.5))
    out, dropped, rebins = tvs.multi_step(state, PARAMS, CFG, GRID_T, 24)
    sess = tvs.Session(state, PARAMS, CFG, GRID_T, device="cpu")
    sess.run(10)
    sess.run(14)
    got = sess.state()
    assert dropped == sess.overflow == 0
    assert rebins == sess.sim.rebin_count >= 2
    assert out.step == got.step == 24
    for f in ("x", "y", "vx", "vy", "rho", "p"):
        assert torch.equal(getattr(out, f), getattr(got, f)), f
