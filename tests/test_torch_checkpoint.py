"""The port's checkpoints (utils/checkpoint.py, ``Session.save/restore``,
``Simulation.save/load``) on the CPU: bitwise continuation, the legacy
formats, the solver-knob fingerprint, the tile kernels' premise on load,
and artifacts crossing between the port and the JAX package both ways.

The JAX side runs as its own tests run it (Pallas in interpret mode); the
port runs its kernels' PyTorch twins.  A port restore continues its own
run bit for bit.  Across packages the integer counters and the slot
assignment are exact and the floats agree within the Session gate's
tolerances (positions 1e-5, velocities 1e-4 absolute, density 1e-5
relative): the two packages differ by FP contraction only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gpu_fluid_tpu as bgf
from bevy_gpu_fluid_tpu.models import verlet_solver as jvs
from bevy_gpu_fluid_tpu.utils import checkpoint as jckpt

import bevy_gpu_fluid_tpu_torch as bt
from bevy_gpu_fluid_tpu_torch.models import cuda_solver
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as tvs
from bevy_gpu_fluid_tpu_torch.utils import checkpoint, convert

torch.set_num_threads(1)

PARAMS_J = bgf.FluidParams.demo()
CFG_J = bgf.IntegrateConfig.create(x_min=-1.0, x_max=2.5)
GRID_J = jvs.default_grid(0.045, -1.0, 2.5, y_max=6.0)   # 12 row blocks
PARAMS = convert.params_from(PARAMS_J)
CFG = convert.cfg_from(CFG_J)
GRID = convert.grid_from(GRID_J)


def _kicked_j():
    """A 16x16 lattice kicked to vx = +4: a rebin every ~6 steps."""
    s = bgf.init_grid(16, 16, 0.04)
    return s.replace(vx=jnp.full((s.n,), 4.0))


def _kicked():
    return convert.state_from(jax.tree_util.tree_map(np.asarray,
                                                     _kicked_j()), "cpu")


def _sims_bitwise(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, torch.Tensor):
            assert va.dtype == vb.dtype and torch.equal(va, vb), f.name
        else:
            assert va == vb, f.name


def _close_to_jax(st, sj):
    """A port Session against a JAX one: counters and slots exact, the
    particles within the Session gate's tolerances."""
    for f in ("rebin_count", "step", "overflow", "lost", "age",
              "readmitted"):
        assert getattr(st.sim, f) == int(getattr(sj.sim, f)), f
    np.testing.assert_array_equal(st.sim.idx_d.numpy(),
                                  np.asarray(sj.sim.idx_d))
    a, b = sj.state(), st.state()
    for f, tol in (("x", 1e-5), ("y", 1e-5), ("vx", 1e-4), ("vy", 1e-4)):
        np.testing.assert_allclose(getattr(b, f).numpy(),
                                   np.asarray(getattr(a, f)), rtol=0,
                                   atol=tol, err_msg=f)
    np.testing.assert_allclose(b.rho.numpy(), np.asarray(a.rho), rtol=1e-5)


def _session(**kw):
    return tvs.Session(_kicked(), PARAMS, CFG, GRID, device="cpu", **kw)


# ------------------------------------------------------------ port only

@pytest.mark.parametrize("posture", ["default", "refless"])
def test_session_restore_continues_bitwise(tmp_path, posture):
    """10 steps + save + restore + 10 steps == 20 uninterrupted steps, bit
    for bit (every DenseSim field, the counters, the skin references)."""
    kw = {"refless_trigger": True} if posture == "refless" else {}
    path = str(tmp_path / "sess")
    a = _session(**kw)
    a.run(10)
    a.save(path)
    a.run(10)
    b = tvs.Session.restore(path, device="cpu", **kw)
    assert b.n == a.n and b.sim.step == 10
    assert b.refless_trigger == (posture == "refless")
    b.run(10)
    assert a.sim.rebin_count >= 3
    _sims_bitwise(a.sim, b.sim)


def test_session_restore_rebuilds_physics(tmp_path):
    """A restore steps with the SAVED params and cfg."""
    params = bt.FluidParams.create(h=0.045, rho_0=1000.0, k=5.0, mu=0.3,
                                   m=1.6)
    cfg = bt.IntegrateConfig.create(x_min=-1.0, x_max=2.5, bounce=-0.5)
    a = tvs.Session(_kicked(), params, cfg, GRID, device="cpu")
    a.kick(0.3, 0.3, 1.0, 0.0, impulse=5.0)
    a.run(4)
    path = str(tmp_path / "phys")
    a.save(path)
    b = tvs.Session.restore(path, device="cpu")
    assert b.params == params and b.cfg == cfg and b.grid == GRID
    a.run(4)
    b.run(4)
    _sims_bitwise(a.sim, b.sim)


def _strip_keys(path, drop):
    """Rewrite an .npz without the given keys (an artifact of an older
    format)."""
    z = np.load(path + ".npz")
    kept = {k: z[k] for k in z.files if k not in drop}
    np.savez(path + ".npz", **kept)


LEGACY_KEYS = ("sim.occ", "sim.disp2", "sim.sx", "sim.sy", "sim.svx",
               "sim.svy", "sim.sidx", "sim.readmitted")


def test_load_dense_legacy_format_continues_bitwise(tmp_path):
    """An artifact without spill buffers, occ and disp2 loads: occ and
    disp2 recomputed exactly from the planes, the spill buffer empty, and
    the run continues bitwise."""
    sess = _session()
    sess.run(8)
    path = str(tmp_path / "legacy")
    sess.save(path)
    _strip_keys(path, LEGACY_KEYS)
    sim, grid, params, cfg, n = checkpoint.load_dense(path, "cpu")
    assert torch.equal(sim.occ, sess.sim.occ)
    assert torch.equal(sim.disp2, sess.sim.disp2)
    assert sim.suspended == 0 and sim.readmitted == 0
    stepf = tvs.make_step(params, cfg, grid, n=n)
    a, b = sess.sim, sim
    for _ in range(8):
        a, b = stepf(a), stepf(b)
    for f in ("xd", "yd", "vxd", "vyd", "idx_d", "rebin_count"):
        va, vb = getattr(a, f), getattr(b, f)
        assert (torch.equal(va, vb) if isinstance(va, torch.Tensor)
                else va == vb), f


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A default-posture artifact after 2 steps."""
    path = str(tmp_path_factory.mktemp("fp") / "fp")
    sess = _session()
    sess.run(2)
    sess.save(path)
    return path


@pytest.mark.parametrize("knob, match", [
    (dict(max_age=32), "max_age"),
    (dict(recovery=False), "recovery"),
    (dict(stencils="k1k8"), "solver"),
    (dict(refless_trigger=True), "refless"),
    (dict(code_dtype=torch.int8), "code_dtype"),
])
def test_restore_rejects_mismatched_knobs(saved, knob, match):
    if knob.get("stencils") == "k1k8":
        knob = dict(stencils=cuda_solver.make_stencils(GRID))
    with pytest.raises(ValueError, match=match):
        tvs.Session.restore(saved, device="cpu", **knob)


def test_restore_matching_and_legacy_knobs(saved, tmp_path):
    b = tvs.Session.restore(saved, device="cpu", planar_rebin=True,
                            segmented=True, donate=True)
    assert b.sim.step == 2 and b.planar_rebin and b.segmented
    fp = checkpoint.load_fingerprint(saved)
    assert fp == {"solver": "fused-pallas", "reslot": "default",
                  "max_age": 64, "recovery": True, "refless": False,
                  "code_dtype": "int32"}
    # an artifact without a fingerprint is accepted unchecked
    path = str(tmp_path / "nofp")
    z = np.load(saved + ".npz")
    np.savez(path + ".npz", **{k: z[k] for k in z.files
                               if not k.startswith("meta.fp.")})
    assert checkpoint.load_fingerprint(path) is None
    c = tvs.Session.restore(path, device="cpu", max_age=32)
    assert c.sim.step == 2


def test_check_fingerprint_unit():
    checkpoint.check_fingerprint(None, {"solver": "x"}, "t")
    checkpoint.check_fingerprint({"solver": "fused-pallas"},
                                 {"solver": "fused-pallas", "new": 1}, "t")
    with pytest.raises(ValueError, match="recovery"):
        checkpoint.check_fingerprint({"recovery": True},
                                     {"recovery": False}, "t")
    assert tvs._session_fingerprint(None, 64, True, False, torch.int32) != \
        tvs._session_fingerprint(None, 64, True, True, torch.int32)


def test_refless_restore_fingerprint(tmp_path):
    """A refless artifact restores under the refless trigger (placeholder
    references); restoring it ref-based, or with the trigger left to the
    CPU's default (ref-based), raises."""
    b = _session(refless_trigger=True)
    b.run(5)
    path = str(tmp_path / "refless")
    b.save(path)
    c = tvs.Session.restore(path, device="cpu", refless_trigger=True)
    assert c.refless_trigger and tuple(c.sim.ref_xd.shape) == (1, 1, 1)
    for trigger in (False, None):
        with pytest.raises(ValueError, match="refless"):
            tvs.Session.restore(path, device="cpu", refless_trigger=trigger)


def _break_prefix(sim):
    """Swap a cell's last live slot with the dead slot after it."""
    live = sim.xd < 5e8
    r, k, c = [int(v) for v in torch.nonzero(
        live[:, :-1] & ~live[:, 1:])[0]]
    for plane in (sim.xd, sim.yd, sim.vxd, sim.vyd, sim.idx_d):
        plane[r, k], plane[r, k + 1] = plane[r, k + 1].clone(), \
            plane[r, k].clone()


def _break_dead(sim):
    """Give one dead slot a velocity."""
    r, k, c = [int(v) for v in torch.nonzero(sim.xd >= 5e8)[0]]
    sim.vxd[r, k, c] = 1.0


def _break_occ(sim):
    """Lower the slot bound of the fullest row block."""
    sim.occ[:, int(sim.occ.amax(dim=0).argmax())] -= 1


@pytest.mark.parametrize("breaker, match", [
    (_break_prefix, "prefix"), (_break_dead, "dead slot"),
    (_break_occ, "occ")])
def test_load_dense_rejects_broken_tile_premise(tmp_path, breaker, match):
    """load_dense writes planes the tile kernels read, so it refuses an
    artifact whose planes break their premise."""
    sess = _session()
    sess.run(3)
    sim = dataclasses.replace(sess.sim, **{
        f.name: getattr(sess.sim, f.name).clone()
        for f in dataclasses.fields(sess.sim)
        if isinstance(getattr(sess.sim, f.name), torch.Tensor)})
    breaker(sim)
    path = str(tmp_path / "broken")
    checkpoint.save_dense(path, sim, GRID, PARAMS, CFG, sess.n)
    with pytest.raises(ValueError, match=match):
        checkpoint.load_dense(path, "cpu")


# ------------------------------------------------- across the packages

@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """10 steps in each package, saved; each artifact restored in the
    OTHER package and run 10 more; each original run continued 10 more."""
    d = tmp_path_factory.mktemp("cross")
    j_path, t_path = str(d / "jax"), str(d / "port")
    sj = jvs.Session(_kicked_j(), PARAMS_J, CFG_J, GRID_J)
    sj.run(10)
    sj.save(j_path)
    sj.run(10)
    st = _session()
    st.run(10)
    st.save(t_path)
    st.run(10)
    from_j = tvs.Session.restore(j_path, device="cpu")
    from_j.run(10)
    from_t = jvs.Session.restore(t_path)
    from_t.run(10)
    return sj, st, from_j, from_t


def test_jax_artifact_continues_in_the_port(cross):
    sj, _, from_j, _ = cross
    assert from_j.sim.rebin_count >= 3
    _close_to_jax(from_j, sj)


def test_port_artifact_continues_in_jax(cross):
    _, st, _, from_t = cross
    _close_to_jax(st, from_t)


def test_fluid_state_checkpoint_crosses_both_ways(tmp_path):
    sj = _kicked_j().replace(step=jnp.int32(7))
    jckpt.save(str(tmp_path / "j"), sj, PARAMS_J, CFG_J)
    st, params, cfg = checkpoint.load(str(tmp_path / "j"), "cpu")
    assert st.step == 7 and params == PARAMS and cfg == CFG
    for f in ("x", "y", "vx", "vy", "rho"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)))
    checkpoint.save(str(tmp_path / "t"), st, PARAMS, CFG)
    back, pj, cj = jckpt.load(str(tmp_path / "t"))
    assert int(back.step) == 7 and float(pj.k) == float(PARAMS_J.k)
    np.testing.assert_array_equal(np.asarray(back.x), np.asarray(sj.x))


# ------------------------------------------------------------ Simulation

def test_simulation_save_load_round_trip(tmp_path):
    """Simulation.save/load round-trips the state; the artifact's physics
    replaces the loading Simulation's, which rebuilds its Session."""
    params = bt.FluidParams.create(h=0.045, rho_0=1000.0, k=4.0, mu=0.2,
                                   m=1.6)
    grid = tvs.default_grid(0.045, -5.0, 3.0, y_max=4.0)
    a = bt.Simulation(bt.init_grid(16, 16, 0.04, "cpu"), params,
                      bt.IntegrateConfig.create(bounce=-0.5), grid,
                      device="cpu")
    a.run(3)
    path = str(tmp_path / "simck")
    a.save(path)
    b = bt.Simulation.dam_break(n=256, device="cpu")
    b.load(path)
    assert b.params == a.params and b.cfg == a.cfg
    sa, sb = a.state, b.state
    assert sb.step == sa.step == 3
    for f in ("x", "y", "vx", "vy"):
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f
    b.run(3)
    assert b.state.step == 6 and b.overflow == 0
