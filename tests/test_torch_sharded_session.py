"""The port's ``ShardedSession`` (``parallel/sharded_session.py``,
``parallel/shard_render.py``, ``utils/checkpoint.save_sharded`` /
``load_sharded``) against the JAX package's on the CPU: the run, frames,
kick, the validator and checkpoints that cross between the packages.

The scene is ``tests/test_sharded_session.py``'s ``sess2``: a 24 x 6 block
straddling the boundary of two slabs, kicked right at 3.0, 12 steps (a
collective rebin or two).  The JAX ``ShardedSession`` runs at its default
(fused, Pallas in interpret mode) on the 8 virtual CPU devices; the port's
over ``SlabMesh(["cpu"] * 2)``.

Tolerances: integers exact; particles by idx at the Session gate's
tolerances (positions 1e-5, velocities 1e-4, rho 1e-5 relative); frames
within one u8 count on 99% of the pixels (the reference's own gate of a
sharded frame against a single-chip one; K4's twin and the interpret-mode
kernel round the last bit differently); a kick on identical planes exact
(elementwise float32); a port restore of a port artifact bitwise.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gpu_fluid_tpu as bgf
from bevy_gpu_fluid_tpu.parallel import shard as jsh
from bevy_gpu_fluid_tpu.parallel.sharded_session import \
    ShardedSession as JSession

from bevy_gpu_fluid_tpu_torch.ops.binning import (FAR, bin_particles,
                                                  to_dense)
from bevy_gpu_fluid_tpu_torch.parallel.mesh import SlabMesh
from bevy_gpu_fluid_tpu_torch.parallel.sharded_session import ShardedSession
from bevy_gpu_fluid_tpu_torch.render import raster
from bevy_gpu_fluid_tpu_torch.utils import checkpoint, convert, validator

torch.set_num_threads(1)

PARAMS_J = bgf.FluidParams.demo()
CFG_J = bgf.IntegrateConfig.create(x_min=-1.0, x_max=2.5)
PARAMS = convert.params_from(PARAMS_J)
CFG = convert.cfg_from(CFG_J)
STEPS = 12
MORE = 6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mesh():
    return SlabMesh(["cpu"] * 2)


def _scene():
    spec = jsh.ShardSpec.build(h=0.045 * 1.5, x_min=-1.0, x_max=2.5,
                               y_max=3.0, n_devices=2, capacity=1024)
    state = bgf.init_grid(24, 6, 0.04)
    return spec, state.replace(x=state.x + 0.3, vx=jnp.full((state.n,), 3.0))


def _port(spec, state):
    return ShardedSession(convert.state_from(_np(state), "cpu"), PARAMS, CFG,
                          convert.spec_from(spec), _mesh())


@pytest.fixture(scope="module")
def sess2():
    """Both packages' sessions after STEPS steps (read only: tests that
    step or kick make their own)."""
    spec, state = _scene()
    sj = JSession(state, PARAMS_J, CFG_J, spec)
    sj.run(STEPS)
    st = _port(spec, state)
    st.run(STEPS)
    return sj, st, state


def _particles_match(a, b):
    b = _np(b)
    np.testing.assert_allclose(a.x.numpy(), b.x, rtol=0, atol=1e-5)
    np.testing.assert_allclose(a.y.numpy(), b.y, rtol=0, atol=1e-5)
    np.testing.assert_allclose(a.vx.numpy(), b.vx, rtol=0, atol=1e-4)
    np.testing.assert_allclose(a.vy.numpy(), b.vy, rtol=0, atol=1e-4)
    np.testing.assert_allclose(a.rho.numpy(), b.rho, rtol=1e-5)


def _counters_match(st, sj):
    assert st.alive == sj.alive
    assert (st.overflow, st.dropped, st.lost, st.readmitted,
            st.suspended) == (sj.overflow, sj.dropped, sj.lost,
                              sj.readmitted, sj.suspended)
    assert st.rebin_count == sj.rebin_count and st.step == sj.step
    for d in range(2):
        np.testing.assert_array_equal(st.sim.idx_d[d].numpy(),
                                      np.asarray(sj.sim.idx_d)[d])


def _sims_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, list) and isinstance(x[0], torch.Tensor):
            assert all(torch.equal(u, v) for u, v in zip(x, y)), f.name
        else:
            assert x == y, f.name


def test_run_matches_jax(sess2):
    sj, st, state = sess2
    _counters_match(st, sj)
    assert sum(st.alive) == state.n and st.rebin_count >= 2
    assert st.overflow == st.dropped == st.lost == 0


def test_state_is_original_order_and_matches_jax(sess2):
    sj, st, state = sess2
    out = st.state()
    _particles_match(out, sj.state())
    ids = torch.sort(torch.cat([a.reshape(-1) for a in st.sim.idx_d])).values
    assert torch.equal(ids[ids >= 0], torch.arange(state.n, dtype=torch.int32))
    assert float(out.x.mean()) > float(np.asarray(state.x).mean()) + 0.01


@pytest.mark.parametrize("mode", ["density", "const"])
def test_frame_matches_jax_and_single_card(sess2, mode):
    """The frame across both slabs: as wide as both slabs, wet on both
    sides of the seam, within one count of the reference's sharded frame
    and of the single-card frame of the same particles on the grid both
    slabs cover."""
    sj, st, _ = sess2
    img = st.frame(mode=mode)
    want = np.array(sj.frame(mode=mode))
    assert img.dtype == torch.uint8 and tuple(img.shape) == want.shape
    assert img.shape[1] == 2 * st.spec.nx_local * 2
    fs = st.state()
    gg = st.spec.global_grid()
    b = bin_particles(fs.x, fs.y, gg)
    one = raster.field_frame(to_dense(b, fs.x, FAR), to_dense(b, fs.y, FAR),
                             PARAMS, gg, mode=mode)
    for other in (torch.from_numpy(want), one):
        diff = (img.int() - other.int()).abs()
        assert int(diff.max()) <= 1
        assert float((diff == 0).float().mean()) >= 0.99
    wet = img.int().sum(-1) > 10
    half = img.shape[1] // 2
    assert bool(wet[:, half - 1].any() and wet[:, half].any())


def test_run_frame_steps_then_renders():
    spec, state = _scene()
    a, b = _port(spec, state), _port(spec, state)
    frames = a.run_frames(2, substeps=3)
    for i in range(2):
        assert torch.equal(frames[i], b.run_frame(substeps=3))
    assert a.step == b.step == 6


def test_kick_matches_jax_on_the_same_planes(sess2):
    """The drag impulse on identical planes (the JAX session's, carried
    into the port by ``convert.sharded_sim_from``): the velocity planes
    bit for bit the reference's kick, and only particles in range move."""
    sj, _, state = sess2
    spec = sj.spec
    st = ShardedSession(None, PARAMS, CFG, convert.spec_from(spec), _mesh(),
                        _sim=convert.sharded_sim_from(_np(sj.sim), _mesh()),
                        _n=state.n)
    before = st.state()
    cx = float(spec.global_x0 + spec.slab_width)
    cy = float(before.y.median())
    kj = JSession(None, PARAMS_J, CFG_J, spec, _sim=sj.sim, _n=state.n)
    kj.kick(cx, cy, 0.0, 1.0)
    st.kick(cx, cy, 0.0, 1.0)
    for d in range(2):
        np.testing.assert_array_equal(st.sim.vxd[d].numpy(),
                                      np.asarray(kj.sim.vxd)[d])
        np.testing.assert_array_equal(st.sim.vyd[d].numpy(),
                                      np.asarray(kj.sim.vyd)[d])
    after = st.state()
    d2 = (before.x - cx) ** 2 + (before.y - cy) ** 2
    changed = (after.vy - before.vy).abs() > 1e-9
    inside = d2 < 0.04
    assert bool(changed[inside].all()) and not bool(changed[~inside].any())
    assert int(inside.sum()) > 0


def test_validate_passes_like_jax(sess2):
    """The in-engine validator over both slabs holds at its tolerances, as
    the reference's does on its run; the two reports agree within the
    golden sums' rounding (1e-3 of the 1% tolerance)."""
    sj, st, _ = sess2
    got, want = st.validate(), sj.validate()
    for r in (got, want):
        assert r.rho_max_rel <= validator.REL_TOL
        assert r.acc_max_abs <= validator.ACC_ABS_TOL \
            or r.acc_max_rel <= validator.REL_TOL
    assert abs(got.rho_max_rel - want.rho_max_rel) <= 1e-5


def test_save_restore_continues_bitwise(sess2, tmp_path):
    _, st, _ = sess2
    path = os.fspath(tmp_path / "slabs")
    st.save(path)
    back = ShardedSession.restore(path, _mesh())
    assert back.n == st.n and back.step == st.step
    _sims_equal(back.sim, st.sim)
    a = ShardedSession(None, PARAMS, CFG, st.spec, _mesh(), _sim=st.sim,
                       _n=st.n)
    a.run(MORE)
    back.run(MORE)
    _sims_equal(back.sim, a.sim)
    with pytest.raises(ValueError, match="recovery"):
        ShardedSession.restore(path, _mesh(), recover=False)
    with pytest.raises(ValueError, match="slabs"):
        ShardedSession.restore(path, SlabMesh(["cpu"] * 4))


def test_save_restore_records_max_age(tmp_path):
    """A session whose bins age out every 4 steps saves its age limit: a
    restore with it continues bitwise, one without it is refused."""
    spec, state = _scene()
    st = ShardedSession(convert.state_from(_np(state), "cpu"), PARAMS, CFG,
                        convert.spec_from(spec), _mesh(), max_age=4)
    ages = []
    for _ in range(STEPS):
        ages.append(st.sim.age)
        st.run(1)
    assert max(ages) == 4 and st.rebin_count >= STEPS // 5
    path = os.fspath(tmp_path / "slabs_age4")
    st.save(path)
    with pytest.raises(ValueError, match="max_age"):
        ShardedSession.restore(path, _mesh())
    back = ShardedSession.restore(path, _mesh(), max_age=4)
    a = ShardedSession(None, PARAMS, CFG, st.spec, _mesh(), _sim=st.sim,
                       _n=st.n, max_age=4)
    a.run(MORE)
    back.run(MORE)
    _sims_equal(back.sim, a.sim)


def test_jax_artifact_continues_in_the_port(sess2, tmp_path):
    """A JAX ``save_sharded`` artifact restores in the port (slot
    structure, counters, spill) and continues where the JAX session
    does."""
    sj, _, state = sess2
    path = os.fspath(tmp_path / "jax_slabs")
    sj.save(path)
    st = ShardedSession.restore(path, _mesh())
    for name in ("xd", "yd", "vxd", "vyd", "idx_d", "occ", "ref_xd"):
        for d in range(2):
            np.testing.assert_array_equal(getattr(st.sim, name)[d].numpy(),
                                          np.asarray(getattr(sj.sim,
                                                             name))[d])
    jj = JSession.restore(path)
    jj.run(MORE)
    st.run(MORE)
    _counters_match(st, jj)
    _particles_match(st.state(), jj.state())


def test_port_artifact_continues_in_jax(sess2, tmp_path):
    """The reverse: a port artifact restores in the JAX package, which
    continues where the port does."""
    _, st, _ = sess2
    path = os.fspath(tmp_path / "port_slabs")
    st.save(path)
    jj = JSession.restore(path)
    for d in range(2):
        np.testing.assert_array_equal(np.asarray(jj.sim.idx_d)[d],
                                      st.sim.idx_d[d].numpy())
    a = ShardedSession.restore(path, _mesh())
    jj.run(MORE)
    a.run(MORE)
    _counters_match(a, jj)
    _particles_match(a.state(), jj.state())


def test_load_sharded_checks_the_tile_premise(sess2, tmp_path):
    """An artifact whose planes break the tile kernels' premise (a live
    slot after a dead one; an occ below a neighbour's cells) is refused."""
    _, st, _ = sess2
    path = os.fspath(tmp_path / "good")
    st.save(path)
    with np.load(path + ".npz") as z:
        arrays = {k: np.array(z[k]) for k in z.files}
    xd = arrays["sim.xd"]
    d, r, c = np.argwhere(xd[:, :, 0, :] < FAR * 0.5)[0]
    bad = dict(arrays)
    bad["sim.xd"] = xd.copy()
    bad["sim.xd"][d, r, 0, c] = FAR           # slot 1 stays live
    np.savez(os.fspath(tmp_path / "gap.npz"), **bad)
    with pytest.raises(ValueError, match="prefix"):
        checkpoint.load_sharded(os.fspath(tmp_path / "gap"), _mesh())
    low = dict(arrays)
    low["sim.occ"] = np.zeros_like(arrays["sim.occ"])
    np.savez(os.fspath(tmp_path / "low.npz"), **low)
    with pytest.raises(ValueError, match="bound"):
        checkpoint.load_sharded(os.fspath(tmp_path / "low"), _mesh())


def test_default_mesh_is_the_card():
    """Without a mesh the session puts its slabs on the CUDA card; the CPU
    is used only when asked for."""
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in SlabMesh(n=2).devices)
    else:
        spec, state = _scene()
        with pytest.raises((AssertionError, RuntimeError)):
            ShardedSession(convert.state_from(_np(state), "cpu"), PARAMS,
                           CFG, convert.spec_from(spec))
