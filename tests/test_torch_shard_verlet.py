"""The port's deferred rebinning on slabs (``parallel/shard_verlet.py``) and
its kernel variants against the JAX package on the CPU.

The JAX side runs as its own tests run it: ``make_sharded_verlet_step``
fused (Pallas density and fused forces in interpret mode, the reslot
through ``reslot_xla``) under ``shard_map`` on the 8 virtual CPU devices;
the variants as the Pallas kernels in interpret mode.  The port runs one
process over ``SlabMesh(["cpu"] * D)``, its wrappers on CPU tensors (the
kernels' twins).

Tolerances: every integer (idx planes, occ, counts, codes, alive,
overflow, dropped, lost, readmitted, rebins, the spill's indices) exact;
K3 and K6 with a slab's clip and origin bitwise the interpret-mode
kernels; K2 with its lane window within 1e-6 on positions, 1e-5 of max
|v| on velocities and 1e-5 relative on its max (one pass: FP contraction
apart, the same sums); particles after 25 steps by idx at the Session
gate's tolerances (positions 1e-5, velocities 1e-4, rho 1e-5 relative);
the port's D = 4 against its D = 2 at the reference's identity bars
(``tests/test_shard_identity.py``: positions 1e-6, velocities 1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gpu_fluid_tpu as bgf
from bevy_gpu_fluid_tpu.core.params import GridSpec2D as JGrid
from bevy_gpu_fluid_tpu.core.state import from_positions
from bevy_gpu_fluid_tpu.models import pallas_solver as jps
from bevy_gpu_fluid_tpu.ops import reslot as jreslot
from bevy_gpu_fluid_tpu.parallel import shard as jsh
from bevy_gpu_fluid_tpu.parallel import shard_verlet as jsv

from bevy_gpu_fluid_tpu_torch.models import cuda_solver
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as tvs
from bevy_gpu_fluid_tpu_torch.ops import reslot
from bevy_gpu_fluid_tpu_torch.ops.binning import FAR
from bevy_gpu_fluid_tpu_torch.parallel import shard as tsh
from bevy_gpu_fluid_tpu_torch.parallel import shard_verlet as tsv
from bevy_gpu_fluid_tpu_torch.parallel.mesh import SlabMesh
from bevy_gpu_fluid_tpu_torch.utils import convert

torch.set_num_threads(1)

PARAMS_J = bgf.FluidParams.demo()
CFG_J = bgf.IntegrateConfig.create(x_min=-1.0, x_max=2.5)
PARAMS = convert.params_from(PARAMS_J)
CFG = convert.cfg_from(CFG_J)
STEPS = 25


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _four_slab_state():
    state = bgf.init_grid(80, 8, 0.04)
    return state.replace(x=state.x - 0.98, vx=jnp.full((state.n,), 4.0))


def _run_jax(spec_j, state_j, steps, **kw):
    init_fn, step_fn = jsv.make_sharded_verlet_step(
        kw.pop("params", PARAMS_J), kw.pop("cfg", CFG_J), spec_j,
        jsh.make_mesh(spec_j.n_devices), fused=True, interpret=True, **kw)
    sim = init_fn(jsh.shard_state(state_j, spec_j))
    for _ in range(steps):
        sim = step_fn(sim)
        jax.block_until_ready(sim.xd)    # one multi-device run in flight
    return sim


def _run_port(spec_t, state_j, steps, **kw):
    mesh = SlabMesh(["cpu"] * spec_t.n_devices)
    steps_fn = tsv.make_sharded_verlet_step(
        kw.pop("params", PARAMS), kw.pop("cfg", CFG), spec_t, mesh,
        fused=True, **kw)
    sim = steps_fn.init(tsh.shard_state(convert.state_from(_np(state_j),
                                                           "cpu"),
                                        spec_t, mesh))
    for _ in range(steps):
        sim = steps_fn.step(sim)
    return sim, steps_fn


def _integers_match(got, want):
    """Every integer of a port ShardedDenseSim equals the JAX one's."""
    want = _np(want)
    D = got.n_slabs
    for name in ("idx_d", "occ", "sidx"):
        for d in range(D):
            np.testing.assert_array_equal(getattr(got, name)[d].numpy(),
                                          getattr(want, name)[d], name)
    for name in ("alive", "overflow", "lost", "dropped", "readmitted"):
        assert getattr(got, name) == list(getattr(want, name)), name
    assert got.rebin_count == int(want.rebin_count.max())
    assert got.age == int(want.age.max())
    assert got.step == int(want.step)


def _particles_match(got, want, spec_t, spec_j, n, tol=(1e-5, 1e-4)):
    a = tsv.extract_fluid_state(got, spec_t, PARAMS, n)
    b = _np(jsv.extract_fluid_state(want, spec_j, PARAMS_J, n))
    np.testing.assert_allclose(a.x.numpy(), b.x, rtol=0, atol=tol[0])
    np.testing.assert_allclose(a.y.numpy(), b.y, rtol=0, atol=tol[0])
    np.testing.assert_allclose(a.vx.numpy(), b.vx, rtol=0, atol=tol[1])
    np.testing.assert_allclose(a.vy.numpy(), b.vy, rtol=0, atol=tol[1])
    np.testing.assert_allclose(a.rho.numpy(), b.rho, rtol=1e-5)


@pytest.fixture(scope="module")
def d4():
    """The four-slab scene, STEPS steps at D = 4 through both packages
    (recovery armed), and at D = 2 through the port."""
    state_j = _four_slab_state()
    n = state_j.n
    spec_j = jsh.ShardSpec.build(h=0.045 * 1.5, x_min=-1.0, x_max=2.5,
                                 y_max=3.0, n_devices=4, capacity=1024)
    spec_t = convert.spec_from(spec_j)
    sim_j = _run_jax(spec_j, state_j, STEPS, n=n)
    sim_t, steps_t = _run_port(spec_t, state_j, STEPS, n=n)
    spec2 = convert.spec_from(jsh.ShardSpec.build(
        h=0.045 * 1.5, x_min=-1.0, x_max=2.5, y_max=3.0, n_devices=2,
        capacity=4096))
    sim2, _ = _run_port(spec2, state_j, STEPS, n=n)
    return dict(state_j=state_j, n=n, spec_j=spec_j, spec_t=spec_t,
                sim_j=sim_j, sim_t=sim_t, steps_t=steps_t, spec2=spec2,
                sim2=sim2)


def test_sharded_run_integers_match_jax(d4):
    """Slot assignment, bounds and every counter, after migration across
    every slab boundary and several collective rebins."""
    _integers_match(d4["sim_t"], d4["sim_j"])
    assert d4["sim_t"].rebin_count >= 3
    assert sum(d4["sim_t"].alive) == d4["n"]


def test_sharded_run_particles_match_jax(d4):
    _particles_match(d4["sim_t"], d4["sim_j"], d4["spec_t"], d4["spec_j"],
                     d4["n"])


def test_extract_state_matches_jax(d4):
    """The per-slab particle view (live real slots, then the spill,
    compacted): slots' owners exact, fields at the Session gate's
    tolerances."""
    want = _np(jsv.extract_state(d4["sim_j"], d4["spec_j"], PARAMS_J))
    got = tsv.extract_state(d4["sim_t"], d4["spec_t"], PARAMS)
    assert got.step == int(want.step) == STEPS
    for d in range(4):
        np.testing.assert_array_equal(got.idx[d].numpy(), want.idx[d])
        np.testing.assert_array_equal(got.alive[d].numpy(), want.alive[d])
        for f, tol in (("x", 1e-5), ("y", 1e-5), ("vx", 1e-4),
                       ("vy", 1e-4)):
            np.testing.assert_allclose(getattr(got, f)[d].numpy(),
                                       getattr(want, f)[d], rtol=0,
                                       atol=tol, err_msg=f)
        np.testing.assert_allclose(got.rho[d].numpy(), want.rho[d],
                                   rtol=1e-5)


def test_init_and_occ_match_jax(d4):
    """The slabs' init (binning on each slab's origin, the spill of its
    drops) and the neighbour-maxed slot bounds, exactly."""
    state_j = d4["state_j"]
    init_j, _ = jsv.make_sharded_verlet_step(
        PARAMS_J, CFG_J, d4["spec_j"], jsh.make_mesh(4), fused=True,
        interpret=True, n=d4["n"])
    want = _np(init_j(jsh.shard_state(state_j, d4["spec_j"])))
    mesh = SlabMesh(["cpu"] * 4)
    got = d4["steps_t"].init(tsh.shard_state(
        convert.state_from(_np(state_j), "cpu"), d4["spec_t"], mesh))
    _integers_match(got, want)
    for name in ("xd", "yd", "vxd", "vyd"):
        for d in range(4):
            np.testing.assert_array_equal(getattr(got, name)[d].numpy(),
                                          getattr(want, name)[d], name)
    # occ is each slab's block_kmax3 maxed with both neighbours'
    own = [reslot.block_kmax3(x, d4["spec_t"].local_grid) for x in got.xd]
    for d in range(4):
        near = [own[e] for e in (d - 1, d, d + 1) if 0 <= e < 4]
        assert torch.equal(got.occ[d], torch.stack(near).amax(dim=0))


def test_d4_matches_d2_per_particle(d4):
    """The decomposition is invisible to the physics: the port's D = 4 and
    D = 2 runs agree per particle at the reference's identity bars."""
    n = d4["n"]
    a = tsv.extract_fluid_state(d4["sim_t"], d4["spec_t"], PARAMS, n)
    b = tsv.extract_fluid_state(d4["sim2"], d4["spec2"], PARAMS, n)
    assert max(float((a.x - b.x).abs().max()),
               float((a.y - b.y).abs().max())) <= 1e-6
    assert max(float((a.vx - b.vx).abs().max()),
               float((a.vy - b.vy).abs().max())) <= 1e-4


def test_rebin_zeroes_disp2(d4):
    """S1: a collective rebin zeroes every slab's disp2 (the reference
    keeps the stale value); the pure step writes it anew."""
    steps_t, sim = d4["steps_t"], d4["sim_t"]
    after = steps_t.rebin(sim)
    assert all(float(v) == 0.0 for v in after.disp2)
    assert after.age == 0 and after.rebin_count == sim.rebin_count + 1
    stepped = steps_t.pure_step(after)
    assert any(float(v) > 0.0 for v in stepped.disp2)


def test_planar_rebin_bitwise_fused(d4):
    """The planar sharded rebin (K6 + 5 x K7 with the clip and origin)
    gives the fused run bit for bit."""
    planar, _ = _run_port(d4["spec_t"], d4["state_j"], STEPS, n=d4["n"],
                          planar=True)
    fused = d4["sim_t"]
    for f in dataclasses.fields(fused):
        a, b = getattr(fused, f.name), getattr(planar, f.name)
        if isinstance(a, list) and isinstance(a[0], torch.Tensor):
            assert all(torch.equal(u, v) for u, v in zip(a, b)), f.name
        else:
            assert a == b, f.name


# (slab step options, the Session's): the default posture, the planar
# rebin, and the memory ceiling's (refless trigger, planar rebin that
# consumes owned planes)
POSTURES = {
    "default": ({}, {}),
    "planar": (dict(planar=True), dict(planar_rebin=True)),
    "ceiling": (dict(refless=True, planar=True, donate=True),
                dict(refless_trigger=True, planar_rebin=True, donate=True)),
}


@pytest.mark.parametrize("posture", list(POSTURES))
def test_one_slab_is_the_single_card_session(d4, posture):
    """D = 1: the plain clip, no halo, no merge; in each posture the
    slab's planes, disp2 and counters are bitwise the single-card
    Session's on the same grid (12 row blocks, so the Session steps on
    K1 + K2 too, not K5)."""
    slab_kw, sess_kw = POSTURES[posture]
    state_j = d4["state_j"]
    spec1 = tsh.ShardSpec.build(h=0.045 * 1.5, x_min=-1.0, x_max=2.5,
                                y_max=6.0, n_devices=1, capacity=1024)
    assert spec1.local_grid.n_row_blocks >= cuda_solver.MONO_MAX_BLOCKS
    sim1, _ = _run_port(spec1, state_j, STEPS, n=d4["n"], **slab_kw)
    sess = tvs.Session(convert.state_from(_np(state_j), "cpu"), PARAMS, CFG,
                       spec1.local_grid, device="cpu", **sess_kw)
    sess.run(STEPS)
    for name in ("xd", "yd", "vxd", "vyd", "rho_d", "idx_d", "occ",
                 "disp2"):
        assert torch.equal(getattr(sim1, name)[0],
                           getattr(sess.sim, name)), name
    assert sim1.rebin_count == sess.sim.rebin_count >= 3
    assert (sim1.overflow[0], sim1.lost[0]) == (sess.sim.overflow,
                                                sess.sim.lost)


# ---- the kernel variants against the interpret-mode Pallas kernels -------

def _rebin_planes(d4, d, seed):
    """Slab d's planes of the JAX run as its rebin gives them to the
    reslot (ghost x and idx cleared), every live x nudged by up to 0.05 of
    a 0.0675 cell so that particles cross into the capture columns."""
    sim = _np(d4["sim_j"])
    nxl = d4["spec_t"].nx_local
    xd = sim.xd[d].copy()
    idx = sim.idx_d[d].copy()
    for lane in (0, nxl + 1):
        xd[:, :, lane] = FAR
        idx[:, :, lane] = -1
    rng = np.random.default_rng(seed)
    live = xd < FAR * 0.5
    xd = np.where(live, xd + rng.uniform(-0.05, 0.05, xd.shape)
                  .astype(np.float32), xd).astype(np.float32)
    return xd, sim.yd[d].copy(), sim.vxd[d].copy(), sim.vyd[d].copy(), idx


@pytest.mark.parametrize("d", [0, 2])
def test_reslot_clip_origin_matches_jax_kernel(d4, d):
    """K3's twin with a slab's clip [-1, nx_local] and world origin
    against ``reslot_pallas`` (interpret mode) with the same: all six
    outputs exact, particles captured in the ghost columns."""
    planes = _rebin_planes(d4, d, seed=d)
    spec_j, spec_t = d4["spec_j"], d4["spec_t"]
    nxl = spec_t.nx_local
    ox, oy = tsh.slab_origin(spec_t, d)
    want = jreslot.reslot_pallas(*map(jnp.asarray, planes),
                                 spec_j.local_grid, interpret=True,
                                 clip_lo=-1, clip_hi=nxl,
                                 origin=(jnp.float32(ox), jnp.float32(oy)))
    got = reslot.reslot_torch(*map(torch.from_numpy, planes),
                              spec_t.local_grid, -1, nxl, (ox, oy))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    captured = sum(int((got[0][:, :, lane] < FAR * 0.5).sum())
                   for lane in (0, nxl + 1))
    assert captured > 0


@pytest.mark.parametrize("code_dtype", [torch.int32, torch.int8])
def test_select_clip_origin_matches_jax_kernel(d4, code_dtype):
    """K6's twin with the clip and origin against ``select_pallas``
    (interpret mode): codes and counts exact, and routing the planes
    through them gives K3's twin with the same clip bit for bit."""
    d = 1
    planes = _rebin_planes(d4, d, seed=7)
    spec_j, spec_t = d4["spec_j"], d4["spec_t"]
    nxl = spec_t.nx_local
    ox, oy = tsh.slab_origin(spec_t, d)
    xd, yd = torch.from_numpy(planes[0]), torch.from_numpy(planes[1])
    occ = reslot.block_kmax3(xd, spec_t.local_grid)
    want = jreslot.select_pallas(jnp.asarray(planes[0]),
                                 jnp.asarray(planes[1]), spec_j.local_grid,
                                 interpret=True, clip_lo=-1, clip_hi=nxl,
                                 origin=(jnp.float32(ox), jnp.float32(oy)),
                                 occ=jnp.asarray(occ.numpy()))
    code, cnt = reslot.select_torch(xd, yd, spec_t.local_grid, occ,
                                    code_dtype, -1, nxl, (ox, oy))
    np.testing.assert_array_equal(code.to(torch.int32).numpy(),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want[1]))
    tplanes = [torch.from_numpy(p) for p in planes]
    planar = reslot.reslot_planar(*tplanes, spec_t.local_grid, code_dtype,
                                  -1, nxl, (ox, oy))
    fused = reslot.reslot_cuda(*tplanes, spec_t.local_grid, -1, nxl,
                               (ox, oy))
    for a, b in zip(planar, fused):
        assert torch.equal(a, b)


def test_forces_integrate_disp_lanes_matches_jax_kernel(d4):
    """K2's twin with a slab's lane window against
    ``forces_integrate_pallas(disp_lanes=...)`` (interpret mode) on the
    planes the slab's step gives K2 (after the halo fill and K1): the
    window keeps the ghost copies out of the max (without it both read
    the ghosts' FAR references)."""
    sim_t, spec_j, spec_t = d4["sim_t"], d4["spec_j"], d4["spec_t"]
    d, nxl, g = 1, spec_t.nx_local, spec_t.local_grid
    mesh = SlabMesh(["cpu"] * 4)
    halo = tsh.fill_ghost_cols_multi(
        mesh, list(zip(sim_t.xd, sim_t.yd, sim_t.vxd, sim_t.vyd)), nxl,
        (FAR, FAR, 0.0, 0.0))[d]
    occ = sim_t.occ[d]
    rho = cuda_solver.density_torch(halo[0], halo[1], PARAMS, g, occ)
    refs = (sim_t.ref_xd[d], sim_t.ref_yd[d])
    lanes = (1, nxl + 1)
    got = cuda_solver.forces_integrate_torch(*halo, rho, *refs, PARAMS, CFG,
                                             g, occ, disp_lanes=lanes)
    jargs = [jnp.asarray(t.numpy()) for t in (*halo, rho, *refs)]
    want = jps.forces_integrate_pallas(*jargs, PARAMS_J, CFG_J,
                                       spec_j.local_grid, interpret=True,
                                       occ=jnp.asarray(occ.numpy()),
                                       disp_lanes=lanes)
    want = _np(want)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
    vscale = float(np.abs(want[2]).max())
    for a, b in zip(got[2:4], want[2:4]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * vscale)
    assert 0 < float(want[4]) < 1e-3
    np.testing.assert_allclose(float(got[4]), float(want[4]), rtol=1e-5)
    full = cuda_solver.forces_integrate_torch(*halo, rho, *refs, PARAMS, CFG,
                                              g, occ)
    assert float(full[4]) > 1e6     # the ghost copies against FAR refs


# ---- recovery and the edge fold --------------------------------------------

def _recovery_state():
    """tests/test_shard_recovery.py's scene: 9 coincident particles in one
    cell of slab 0 (cap 8), an inert block on slab 1."""
    cx, cy = np.meshgrid(np.arange(3) * 0.004 + 0.2,
                         np.arange(3) * 0.004 + 0.05)
    bx, by = np.meshgrid(np.arange(4) * 0.06 + 1.5,
                         np.arange(2) * 0.06 + 0.03)
    pos = np.concatenate([np.stack([cx.ravel(), cy.ravel()], -1),
                          np.stack([bx.ravel(), by.ravel()], -1)])
    return from_positions(jnp.asarray(pos, jnp.float32))


def test_recovery_with_a_spill_matches_jax():
    """A drop at the init spills on slab 0, the crowd blasts apart, rebins
    fire and it re-admits: counters, spill buffers and slots exactly the
    reference's; every particle resident or suspended, each index once."""
    cfg_j = bgf.IntegrateConfig.create(x_min=-1.0, x_max=2.5, bounce=-0.5)
    state_j = _recovery_state()
    n = state_j.n
    spec_j = jsh.ShardSpec.build(h=0.045 * 1.5, x_min=-1.0, x_max=2.5,
                                 y_max=3.0, n_devices=2, capacity=512)
    spec_t = convert.spec_from(spec_j)
    mesh = SlabMesh(["cpu"] * 2)
    steps_t = tsv.make_sharded_verlet_step(PARAMS, convert.cfg_from(cfg_j),
                                           spec_t, mesh, n=n, fused=True)
    sim0 = steps_t.init(tsh.shard_state(convert.state_from(
        _np(state_j), "cpu"), spec_t, mesh))
    assert sim0.overflow == [1, 0] and sim0.suspended == 1
    want = _run_jax(spec_j, state_j, 30, n=n, cfg=cfg_j)
    got, _ = _run_port(spec_t, state_j, 30, n=n,
                       cfg=convert.cfg_from(cfg_j))
    _integers_match(got, want)
    assert sum(got.readmitted) >= 1
    ids = torch.cat([a.reshape(-1) for a in got.idx_d] + got.sidx)
    ids = torch.sort(ids[ids >= 0]).values
    assert torch.equal(ids, torch.arange(n, dtype=torch.int32))
    fs = tsv.extract_fluid_state(got, spec_t, PARAMS, n)
    assert bool((fs.x < FAR * 0.5).all() & torch.isfinite(fs.vx).all())


def test_recovery_off_counts_drops():
    """Without ``n`` the spill stays empty: the init's drop is counted,
    never suspended, and surfaces as FAR."""
    state_j = _recovery_state()
    spec_t = convert.spec_from(jsh.ShardSpec.build(
        h=0.045 * 1.5, x_min=-1.0, x_max=2.5, y_max=3.0, n_devices=2,
        capacity=512))
    sim, _ = _run_port(spec_t, state_j, 5)
    assert sim.suspended == 0 and sum(sim.readmitted) == 0
    fs = tsv.extract_fluid_state(sim, spec_t, PARAMS, state_j.n)
    n_far = int((fs.x > FAR * 0.5).sum())
    assert n_far == sum(sim.overflow) + sum(sim.lost) + \
        sum(sim.dropped) >= 1


def test_edge_fold_matches_jax():
    """tests/test_shard_edge_fold.py's scene: a zero-right-pad
    decomposition where the right wall sits on the last slab's edge, so a
    particle clamped to x_max cells one past the slab at every rebin and
    the edge fold returns it; a sentinel sits exactly at x_max.  The
    port's run keeps every particle (the sentinel at x_max exactly) and
    matches the reference's integers."""
    cell = 0.0625
    params_j = bgf.FluidParams.create(h=cell / 1.5, rho_0=1000.0, k=3.0,
                                      mu=0.2, m=1.6)
    cfg_j = bgf.IntegrateConfig.create(x_min=-0.875, x_max=1.0, bounce=-0.5)
    g = JGrid(origin_x=-1.0, origin_y=-2 * cell, cell_size=cell, nx=8,
              ny=32, cap=8)
    spec_j = jsh.ShardSpec(n_devices=4, nx_local=8, local_grid=g,
                           global_x0=-1.0, capacity=512, mig_cap=64)
    bx, by = np.meshgrid(0.90 + 0.04 * np.arange(5),
                         0.40 + 0.04 * np.arange(4))
    pos = np.stack([np.concatenate([bx.ravel(), [1.0]]),
                    np.concatenate([by.ravel(), [1.25]])], axis=-1)
    state_j = from_positions(jnp.asarray(pos, jnp.float32))
    n = state_j.n
    state_j = state_j.replace(
        vx=jnp.concatenate([jnp.full((n - 1,), 5.0), jnp.zeros((1,))]))
    kw = dict(max_age=6)
    want = _run_jax(spec_j, state_j, 30, params=params_j, cfg=cfg_j, **kw)
    spec_t = convert.spec_from(spec_j)
    got, _ = _run_port(spec_t, state_j, 30,
                       params=convert.params_from(params_j),
                       cfg=convert.cfg_from(cfg_j), **kw)
    _integers_match(got, want)
    assert sum(got.alive) == n and got.rebin_count >= 3
    assert sum(got.dropped) == sum(got.lost) == 0
    fs = tsv.extract_fluid_state(got, spec_t, convert.params_from(params_j),
                                 n)
    assert float(fs.x[n - 1]) == 1.0


def test_merge_col_matches_the_running_append():
    """The edge merge against the reference's slot-by-slot append
    (``shard_verlet.merge_col``, a running count per cell), written out
    here: random captures into cells of every fill, full ones included,
    so that some arrivals drop."""
    rng = np.random.default_rng(3)
    R, cap, C, lane = 40, 8, 6, 1
    base = torch.from_numpy(rng.integers(0, cap + 3, R)).to(torch.int32)
    planes = [torch.from_numpy(rng.standard_normal((R, cap, C))
                               .astype(np.float32)) for _ in range(4)]
    planes.append(torch.from_numpy(rng.integers(0, 999, (R, cap, C))
                                   .astype(np.int32)))
    live = torch.from_numpy(rng.random((R, cap)) < 0.4)
    src = [torch.where(live, torch.from_numpy(
        rng.standard_normal((R, cap)).astype(np.float32)), FAR)]
    src += [torch.from_numpy(rng.standard_normal((R, cap))
                             .astype(np.float32)) for _ in range(3)]
    src.append(torch.where(live, torch.from_numpy(
        rng.integers(0, 999, (R, cap)).astype(np.int32)), -1))
    want = [p.clone() for p in planes]
    cols = [p[:, :, lane].clone() for p in want]
    acc = torch.clamp_max(base, cap).to(torch.int64)
    kio = torch.arange(cap)[None, :]
    wmask = []
    for k in range(cap):
        live_k = src[0][:, k] < FAR * 0.5
        oh = torch.where(live_k, acc, -1)[:, None] == kio
        cols = [torch.where(oh, s[:, k][:, None], c)
                for s, c in zip(src, cols)]
        wmask.append(live_k & (acc >= cap))
        acc = acc + live_k
    for p, c in zip(want, cols):
        p[:, :, lane] = c
    got = [p.clone() for p in planes]
    mask = tsv.merge_col(got, lane, src, base, cap)
    assert torch.equal(mask, torch.stack(wmask, dim=-1))
    assert int(mask.sum()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
