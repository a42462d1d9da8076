"""The port's memory-ceiling path on the CPU, against the JAX package and
against its own default posture: the chunked and generator inits, K2's
refless epilogue (through its twin), the refless Session, owned planes
(K1 writing into the dead rho plane), the segmented driver and the
automatic postures.

The JAX side runs as its own tests run it: Pallas in interpret mode, the
rebin through ``reslot_xla``; the port runs its kernels' PyTorch twins.

Tolerances: the inits, ``integrate_into``, K1's ``out=``, the segmented
driver and donation are bitwise (they only move or re-home values); K2
refless against JAX's interpret-mode kernel as the ref-based K2 test of
test_torch_port.py (positions 1e-6, velocities 1e-4 of the plane's max |v|,
the displacement 1e-4 relative); the refless Session against JAX's as the
port's Session gate (positions 1e-5, velocities 1e-4, density 1e-5
relative; rebins, overflow, lost and the slot assignment exact); refless
against ref-based as the reference's own posture test (|dx| <= 5e-5,
refless rebins >= ref-based).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gpu_fluid_tpu as bgf
from bevy_gpu_fluid_tpu.models import pallas_solver as jps
from bevy_gpu_fluid_tpu.models import verlet_solver as jvs

import bevy_gpu_fluid_tpu_torch as bt
from bevy_gpu_fluid_tpu_torch.models import cuda_solver
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as tvs
from bevy_gpu_fluid_tpu_torch.ops import reslot
from bevy_gpu_fluid_tpu_torch.utils import convert

torch.set_num_threads(1)

PARAMS_J = bgf.FluidParams.demo()
CFG_J = bgf.IntegrateConfig.create(x_min=-1.0, x_max=2.5)
GRID_J = jvs.default_grid(0.045, -1.0, 2.5, y_max=3.0)      # 7 row blocks
SLICE_J = jvs.default_grid(0.045, -1.0, 2.5, y_max=6.0)     # 12: K1 + K2
PARAMS = convert.params_from(PARAMS_J)
CFG = convert.cfg_from(CFG_J)
GRID = convert.grid_from(GRID_J)
SLICE = convert.grid_from(SLICE_J)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _sims_bitwise(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, torch.Tensor):
            assert va.dtype == vb.dtype and torch.equal(va, vb), f.name
        else:
            assert va == vb, f.name


def _sim_matches_jax(st, sj):
    """A port DenseSim bitwise a JAX one (what an init gives both)."""
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        w = np.asarray(getattr(sj, f.name))
        if isinstance(v, torch.Tensor):
            np.testing.assert_array_equal(v.numpy(), w, err_msg=f.name)
        else:
            assert v == int(w), f.name


def _kicked(side=24, vx=2.0):
    """A side x side lattice kicked to ``vx`` (a rebin every 11 steps at
    vx = 2, every 6 at vx = 4)."""
    s = bgf.init_grid(side, side, 0.04)
    return s.replace(vx=jnp.full((s.n,), vx))


def _port_state(state_j):
    return convert.state_from(_np(state_j), "cpu")


# ------------------------------------------------------------------ inits

def _crowded_state():
    """A 24x24 block plus 9 particles in one cell at cap 8 (one drop),
    the JAX package's chunked-init scene."""
    a = bgf.init_grid(24, 24, 0.04)
    b = bgf.init_grid(3, 3, 0.004)
    cat = lambda f, off=0.0: jnp.concatenate([getattr(a, f),
                                              getattr(b, f) + off])
    return a.replace(x=cat("x", 1.7), y=cat("y", 0.9), vx=cat("vx"),
                     vy=cat("vy"), ax=cat("ax"), ay=cat("ay"),
                     rho=cat("rho"), p=cat("p"))


@pytest.fixture(scope="module")
def crowded():
    sj = _crowded_state()
    st = _port_state(sj)
    want = tvs.init_dense(st, GRID)
    assert want.overflow >= 1 and want.suspended >= 1
    return sj, st, want


@pytest.mark.parametrize("K", [1, 7])       # 7: 585 % 7 != 0
def test_init_dense_chunked_bitwise_init_dense(crowded, K):
    sj, st, want = crowded
    got = tvs.init_dense_chunked(st, GRID, n_chunks=K)
    _sims_bitwise(want, got)
    _sim_matches_jax(got, jvs.init_dense_chunked(sj, GRID_J, n_chunks=K))


def test_init_dense_chunked_recovery_off(crowded):
    _, st, _ = crowded
    want = tvs.init_dense(st, GRID, collect_spill=False)
    got = tvs.init_dense_chunked(st, GRID, n_chunks=4, collect_spill=False)
    assert got.suspended == 0
    _sims_bitwise(want, got)


@pytest.mark.parametrize("K", [1, 7])       # 7: 576 % 7 != 0
def test_init_dense_gen_bitwise_init_dense(K):
    st = bt.init_grid(24, 24, 0.04, "cpu")
    got = tvs.init_dense_gen(bt.lattice_gen(24, 0.04, "cpu"), st.n, GRID,
                             n_chunks=K, device="cpu")
    _sims_bitwise(tvs.init_dense(st, GRID), got)
    _sim_matches_jax(got, jvs.init_dense_gen(bgf.lattice_gen(24, 0.04),
                                             st.n, GRID_J, n_chunks=K))


def test_lattice_gen_is_init_grid():
    st = bt.init_grid(37, 23, 0.04, "cpu")
    x, y, vx, vy = bt.lattice_gen(37, 0.04, "cpu")(torch.arange(st.n))
    for got, want in ((x, st.x), (y, st.y), (vx, st.vx), (vy, st.vy)):
        assert got.dtype == torch.float32 and torch.equal(got, want)


def test_session_from_generator_matches_state_session():
    st = bt.init_grid(24, 24, 0.04, "cpu")
    a = tvs.Session(st, PARAMS, CFG, GRID, device="cpu")
    b = tvs.Session.from_generator(bt.lattice_gen(24, 0.04, "cpu"), st.n,
                                   PARAMS, CFG, GRID, device="cpu",
                                   init_chunks=3)
    assert b.donate and not b.refless_trigger and not b.planar_rebin
    a.run(20)
    b.run(20)
    _sims_bitwise(a.sim, b.sim)


# ------------------------------------------------ K1 out=, integrate_into

@pytest.fixture(scope="module")
def moved():
    """The kicked 24x24 block on the 12-row-block grid after 12 steps."""
    sess = tvs.Session(_port_state(_kicked()), PARAMS, CFG, SLICE,
                       device="cpu")
    sess.run(12)
    return sess.sim


def test_density_out_bitwise_new_plane(moved):
    s = moved
    want = cuda_solver.density_cuda(s.xd, s.yd, PARAMS, SLICE, s.occ)
    out = torch.full_like(s.xd, float("nan"))
    got = cuda_solver.density_cuda(s.xd, s.yd, PARAMS, SLICE, s.occ,
                                   out=out)
    assert got is out and torch.equal(got, want)


@pytest.mark.parametrize("refless", [False, True])
def test_integrate_into_bitwise_integrate(moved, monkeypatch, refless):
    s = moved
    rng = np.random.default_rng(1)
    ax = _t(rng.normal(0, 50, s.xd.shape).astype(np.float32))
    ay = _t(rng.normal(0, 50, s.xd.shape).astype(np.float32))
    refs = (s.xd, s.yd) if refless else (s.ref_xd, s.ref_yd)
    want = cuda_solver.integrate(s.xd, s.yd, s.vxd, s.vyd, ax, ay, *refs,
                                 CFG)
    monkeypatch.setattr(reslot, "SLAB_MIN", 0)    # slabs even at this size:
    monkeypatch.setattr(reslot, "SLABS", 5)       # 23 rows, a ragged last
    got = cuda_solver.integrate_into(s.xd, s.yd, s.vxd, s.vyd, ax.clone(),
                                     ay.clone(), s.ref_xd, s.ref_yd, CFG,
                                     refless=refless)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_rebin_counts_in_slabs_bitwise(moved, monkeypatch):
    """The rebin's live-slot count and slot-loop bounds taken in row slabs
    (planes of more than ``reslot.SLAB_MIN`` elements, the ceiling's) are
    one pass's, and so is a ceiling-posture run that rebins."""
    s = moved
    count, occ = int((s.xd < 5e8).sum()), reslot.block_kmax3(s.xd, SLICE)
    kw = dict(device="cpu", refless_trigger=True, planar_rebin=True,
              donate=True)
    one = tvs.Session(_port_state(_kicked()), PARAMS, CFG, SLICE, **kw)
    one.run(16)
    monkeypatch.setattr(reslot, "SLAB_MIN", 0)    # slabs even at this size:
    monkeypatch.setattr(reslot, "SLABS", 5)       # 23 rows, a ragged last
    assert int(tvs.live_slots(s.xd)) == count
    assert torch.equal(reslot.block_kmax3(s.xd, SLICE), occ)
    slabs = tvs.Session(_port_state(_kicked()), PARAMS, CFG, SLICE, **kw)
    slabs.run(16)
    assert slabs.sim.rebin_count >= 2
    _sims_bitwise(one.sim, slabs.sim)


# ----------------------------------------------------------- K2 refless

def test_forces_integrate_refless_twin_matches_pallas():
    """K2's refless twin against the JAX interpret-mode kernel with
    ``refless=True`` on a moving scene's planes, on 4-row blocks (the wide
    grids' row block, which the memory-ceiling grids take; the refless
    Session gate below runs 8-row blocks)."""
    gj = dataclasses.replace(SLICE_J, row_block=4)
    sj = jvs.init_dense(_kicked(), gj)
    rho_j = jps.density_pallas(sj.xd, sj.yd, PARAMS_J, gj, interpret=True,
                               occ=sj.occ)
    want = jps.forces_integrate_pallas(
        sj.xd, sj.yd, sj.vxd, sj.vyd, rho_j, sj.xd, sj.yd, PARAMS_J, CFG_J,
        gj, interpret=True, occ=sj.occ, refless=True)
    st = convert.dense_sim_from(_np(sj), "cpu")
    ph = torch.zeros((1, 1, 1))
    got = cuda_solver.forces_integrate_cuda(
        st.xd, st.yd, st.vxd, st.vyd, _t(rho_j), ph, ph, PARAMS, CFG,
        convert.grid_from(gj), st.occ, refless=True)
    wx, wy, wvx, wvy, wd = (np.asarray(a) for a in want)
    np.testing.assert_allclose(got[0].numpy(), wx, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), wy, rtol=0, atol=1e-6)
    vscale = max(np.abs(wvx).max(), np.abs(wvy).max())
    np.testing.assert_allclose(got[2].numpy(), wvx, rtol=0,
                               atol=1e-4 * vscale)
    np.testing.assert_allclose(got[3].numpy(), wvy, rtol=0,
                               atol=1e-4 * vscale)
    assert wd > 0 and abs(float(got[4]) - wd) <= 1e-4 * wd
    # the displacement is the step's own largest move
    live = st.xd < 5e8
    dx, dy = got[0] - st.xd, got[1] - st.yd
    move = (dx * dx + dy * dy)[live].max()
    assert torch.equal(got[4], move)


def test_forces_integrate_refless_takes_no_reference(moved):
    s = moved
    rho = cuda_solver.density_cuda(s.xd, s.yd, PARAMS, SLICE, s.occ)
    a = cuda_solver.forces_integrate_cuda(
        s.xd, s.yd, s.vxd, s.vyd, rho, None, None, PARAMS, CFG, SLICE,
        s.occ, refless=True)
    b = cuda_solver.forces_integrate_cuda(
        s.xd, s.yd, s.vxd, s.vyd, rho, s.xd, s.yd, PARAMS, CFG, SLICE,
        s.occ)
    for g, w in zip(a, b):          # ref = the old positions: the same
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        cuda_solver.forces_integrate_cuda(
            s.xd, s.yd, s.vxd, s.vyd, rho, torch.zeros((1, 1, 1)),
            torch.zeros((1, 1, 1)), PARAMS, CFG, SLICE, s.occ)


# ----------------------------------------------------- refless Session

@pytest.fixture(scope="module")
def refless_runs():
    """The 24x24 block kicked to vx = 3, 30 steps: JAX refless, port
    refless, port ref-based; the slice grid (12 row blocks: K1 + K2 on
    both sides)."""
    sj = jvs.Session(_kicked(vx=3.0), PARAMS_J, CFG_J, SLICE_J,
                     refless_trigger=True)
    sj.run(30)
    st = tvs.Session(_port_state(_kicked(vx=3.0)), PARAMS, CFG, SLICE,
                     device="cpu", refless_trigger=True)
    st.run(30)
    ref = tvs.Session(_port_state(_kicked(vx=3.0)), PARAMS, CFG, SLICE,
                      device="cpu")
    ref.run(30)
    return sj, st, ref


def test_refless_session_counters_match_jax(refless_runs):
    sj, st, _ = refless_runs
    assert st.refless_trigger and tuple(st.sim.ref_xd.shape) == (1, 1, 1)
    assert st.sim.rebin_count == int(sj.sim.rebin_count) >= 3
    assert st.sim.step == int(sj.sim.step) == 30
    assert st.sim.overflow == int(sj.sim.overflow)
    assert st.sim.lost == int(sj.sim.lost) == 0
    assert st.sim.age == int(sj.sim.age)
    np.testing.assert_array_equal(st.sim.idx_d.numpy(),
                                  np.asarray(sj.sim.idx_d))
    np.testing.assert_array_equal(st.sim.occ.numpy(), np.asarray(sj.sim.occ))


def test_refless_session_particles_match_jax(refless_runs):
    sj, st, _ = refless_runs
    a, b = sj.state(), st.state()
    np.testing.assert_allclose(b.x.numpy(), np.asarray(a.x), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(b.y.numpy(), np.asarray(a.y), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(b.vx.numpy(), np.asarray(a.vx), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(b.vy.numpy(), np.asarray(a.vy), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(b.rho.numpy(), np.asarray(a.rho), rtol=1e-5)
    assert abs(float(st.sim.disp2) - float(sj.sim.disp2)) <= \
        1e-4 * float(sj.sim.disp2)


def test_refless_against_ref_based(refless_runs):
    _, st, ref = refless_runs
    assert st.sim.rebin_count >= ref.sim.rebin_count
    assert st.overflow == ref.overflow == 0
    np.testing.assert_allclose(st.state().x.numpy(), ref.state().x.numpy(),
                               rtol=0, atol=5e-5)


def test_refless_never_steps_on_mono(monkeypatch):
    """On a 7-row-block grid the default posture runs K5; refless runs the
    fused K1 + K2 pair instead (the reference pairs refless with no mono),
    and reads no reference plane."""
    calls = []
    for name in ("mono_step_cuda", "forces_integrate_cuda"):
        fn = getattr(cuda_solver, name)
        monkeypatch.setattr(cuda_solver, name, lambda *a, _f=fn, _n=name,
                            **k: calls.append(_n) or _f(*a, **k))
    sim = tvs.init_dense(_port_state(_kicked(12)), GRID)
    for refless, want in ((False, "mono_step_cuda"),
                          (True, "forces_integrate_cuda")):
        calls.clear()
        pure_step, _, _ = tvs.make_step_parts(PARAMS, CFG, GRID,
                                              refless=refless)
        if refless:
            sim = dataclasses.replace(sim, ref_xd=None, ref_yd=None)
        out = pure_step(sim)
        assert calls == [want] and out.step == 1 and float(out.disp2) > 0


@pytest.mark.parametrize("posture", ["refless", "ref-based"])
def test_donated_session_bitwise_snapshot_safe(posture):
    """donate=True (K1 into the dead rho plane) walks the same trajectory
    bit for bit as the snapshot-safe default, refless or not."""
    refless = posture == "refless"
    st = _port_state(_kicked())
    a = tvs.Session(st, PARAMS, CFG, SLICE, device="cpu",
                    refless_trigger=refless)
    b = tvs.Session(st, PARAMS, CFG, SLICE, device="cpu",
                    refless_trigger=refless, donate=True, init_chunks=5)
    a.run(16)
    rho0 = b.sim.rho_d
    b.run(16)
    assert b.sim.rho_d is rho0          # every step wrote into one plane
    _sims_bitwise(a.sim, b.sim)


# ----------------------------------------------------- segmented driver

_POSTURES = {"fused": {}, "chunked": {},
             "stencils": dict(stencils=cuda_solver.make_stencils(SLICE)),
             "refless-planar-donate": dict(refless_trigger=True,
                                           planar_rebin=True, donate=True)}


@pytest.fixture(scope="module")
def standard_runs():
    """The standard driver's 13 + 7 steps of the fast 16x16 block, per
    posture (computed once per posture)."""
    runs = {}

    def get(case):
        key = "fused" if case == "chunked" else case
        if key not in runs:
            a = tvs.Session(_port_state(_kicked(16, vx=4.0)), PARAMS, CFG,
                            SLICE, device="cpu", **_POSTURES[key])
            a.run(13)
            a.run(7)
            runs[key] = a
        return runs[key]
    return get


@pytest.mark.parametrize("case", list(_POSTURES))
def test_segmented_bitwise_standard(standard_runs, case):
    """Session(segmented=True) walks the standard driver's trajectory bit
    for bit, across run() calls and segment bounds below the rebin
    cadence."""
    a = standard_runs(case)
    b = tvs.Session(_port_state(_kicked(16, vx=4.0)), PARAMS, CFG, SLICE,
                    device="cpu", segmented=True, **_POSTURES[case])
    assert b.segmented
    chunk = 4 if case == "chunked" else None
    b.run(13, chunk=chunk)
    b.run(7, chunk=chunk)
    assert a.sim.rebin_count == b.sim.rebin_count >= 3
    _sims_bitwise(a.sim, b.sim)


def test_step_until_stops_on_the_trigger(moved):
    pure_step, rebin, need = tvs.make_step_parts(PARAMS, CFG, SLICE,
                                                 n=576)
    sim, done, pending = tvs.step_until(moved, 100, pure_step, need)
    assert pending and 0 <= done < 64 and need(sim)
    sim2, done2, pending2 = tvs.step_until(sim, 5, pure_step, need)
    assert done2 == 0 and pending2 and sim2 is sim
    sim3, done3, pending3 = tvs.step_until(rebin(sim), 2, pure_step, need)
    assert done3 == 2 and sim3.step == sim.step + 2


# --------------------------------------------------- automatic postures

def _bench_grid(n):
    """The grid ``tools/bench_scale.py`` builds for n particles."""
    side = int(np.sqrt(n))
    extent = side * 0.04
    return tvs.default_grid(0.045, -1.0, extent + 1.0,
                            y_max=extent * 1.1 + 1.0, skin_factor=1.75)


H100_BYTES = 85_000_000_000     # an 80 GB card's total, as mem_get_info


@pytest.mark.parametrize("fn", [tvs.planar_rebin_default,
                                tvs.refless_trigger_default,
                                tvs.segmented_run_default])
def test_postures_off_at_1m(fn):
    for g in (_bench_grid(1_000_000),
              tvs.default_grid(0.045, -1.0, 41.0, y_max=45.0)):
        assert not fn(g, total_bytes=H100_BYTES)
    assert not fn(_bench_grid(1_000_000 * 1000), device="cpu")


def _first_unfit(footprints):
    """The first bench grid (n growing 5% at a time) whose ``footprints``
    planes do not fit the card."""
    usable = H100_BYTES - tvs.RESERVE_BYTES
    n = 4_000_000
    while footprints * 4 * np.prod(_bench_grid(n).plane_shape) <= usable:
        n = int(n * 1.05)
    return _bench_grid(n)


def test_postures_on_past_their_walls():
    """Past the default posture's measured wall the planar rebin engages
    and the trigger stays ref-based; past the ref-based planar posture's,
    the refless trigger engages too; the ceiling posture still fits
    there; the segmented driver never engages (it peaks as high as the
    standard one)."""
    g = _first_unfit(tvs.FOOTPRINTS["default"])
    assert tvs.planar_rebin_default(g, total_bytes=H100_BYTES)
    assert not tvs.refless_trigger_default(g, total_bytes=H100_BYTES)
    g = _first_unfit(tvs.FOOTPRINTS["planar"])
    assert tvs.planar_rebin_default(g, total_bytes=H100_BYTES)
    assert tvs.refless_trigger_default(g, total_bytes=H100_BYTES)
    assert not tvs.segmented_run_default(g, total_bytes=H100_BYTES)
    usable = H100_BYTES - tvs.RESERVE_BYTES
    assert tvs.FOOTPRINTS["ceiling"] * 4 * np.prod(g.plane_shape) <= usable
    # the same grid on a card four times larger: the default posture again
    assert not tvs.refless_trigger_default(g, total_bytes=4 * H100_BYTES)
    assert not tvs.planar_rebin_default(g, total_bytes=4 * H100_BYTES)
