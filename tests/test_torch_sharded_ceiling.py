"""The port's very-large-N slab postures (``parallel/shard_verlet.py``,
``parallel/sharded_session.py``) against the JAX package on the CPU: the
refless trigger, the segmented driver, the chunked and generator inits,
the unfused step, the eager slab step's ``stencils=``, owned planes with
the in-place halo, and refless checkpoints crossing between the packages.

The scene is ``tests/test_sharded_session.py``'s ``sess2``: a 24 x 6 block
straddling the boundary of two slabs, kicked right at 3.0.  The JAX
``ShardedSession`` runs on the 8 virtual CPU devices (fused: Pallas in
interpret mode; ``fused=False``: its XLA stencils), the port's over
``SlabMesh(["cpu"] * 2)`` on the kernels' twins.

Tolerances: integers exact (rebin counts, idx planes, alive, overflow,
dropped, lost, readmitted); particles by idx at the Session gate's
tolerances (positions 1e-5, velocities 1e-4, rho 1e-5 relative); the
refless trigger's summed bound 1e-4 relative; the refless trigger
against the ref-based one at the reference test's 5e-5 / 5e-3; the
inits, the segmented driver, owned planes and restores of port artifacts
bitwise.
"""

import dataclasses
import inspect
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

from bevy_gpu_fluid_tpu_torch import from_positions
from bevy_gpu_fluid_tpu_torch.models import cuda_solver, grid_solver
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as tvs
from bevy_gpu_fluid_tpu_torch.ops import reslot
from bevy_gpu_fluid_tpu_torch.parallel import shard as tsh
from bevy_gpu_fluid_tpu_torch.parallel import shard_verlet as tsv
from bevy_gpu_fluid_tpu_torch.parallel.mesh import SlabMesh
from bevy_gpu_fluid_tpu_torch.parallel.sharded_session import ShardedSession
from bevy_gpu_fluid_tpu_torch.utils import convert

torch.set_num_threads(1)

PARAMS_J = bgf.FluidParams.demo()
CFG_J = bgf.IntegrateConfig.create(x_min=-1.0, x_max=2.5)
PARAMS = convert.params_from(PARAMS_J)
CFG = convert.cfg_from(CFG_J)
STEPS = 12
MORE = 6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mesh(D=2):
    return SlabMesh(["cpu"] * D)


def _scene():
    spec = jsh.ShardSpec.build(h=0.045 * 1.5, x_min=-1.0, x_max=2.5,
                               y_max=3.0, n_devices=2, capacity=1024)
    state = bgf.init_grid(24, 6, 0.04)
    return spec, state.replace(x=state.x + 0.3, vx=jnp.full((state.n,), 3.0))


def _gen(gi):
    """The scene's generator: init_grid(24, 6, 0.04) shifted x + 0.3 (in
    float32, as the state's), vx = 3.0."""
    x = (gi % 24).to(torch.float32) * torch.tensor(0.04) \
        + torch.tensor(0.3)
    y = torch.div(gi, 24, rounding_mode="floor").to(torch.float32) \
        * torch.tensor(0.04)
    return x, y, torch.full_like(x, 3.0), torch.zeros_like(x)


def _port(spec, state, **kw):
    return ShardedSession(convert.state_from(_np(state), "cpu"), PARAMS, CFG,
                          convert.spec_from(spec), _mesh(), **kw)


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def refless_pair(scene):
    """Both packages' refless sessions after STEPS steps, and the port's
    ref-based one (read only)."""
    spec, state = scene
    sj = JSession(state, PARAMS_J, CFG_J, spec, refless_trigger=True)
    sj.run(STEPS)
    st = _port(spec, state, refless_trigger=True)
    st.run(STEPS)
    ref = _port(spec, state)
    ref.run(STEPS)
    return sj, st, ref


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


def _sims_equal(a, b, ghost_nxl=None):
    """Every field of two ShardedDenseSims bitwise; given ``ghost_nxl``,
    the reference planes but for their ghost columns 0 and ghost_nxl + 1
    (nothing reads them)."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, list) and isinstance(x[0], torch.Tensor):
            if ghost_nxl is not None and f.name in ("ref_xd", "ref_yd"):
                lanes = torch.tensor([c for c in range(x[0].shape[2])
                                      if c not in (0, ghost_nxl + 1)])
                x = [t.index_select(2, lanes) for t in x]
                y = [t.index_select(2, lanes) for t in y]
            assert all(u.dtype == v.dtype and torch.equal(u, v)
                       for u, v in zip(x, y)), f.name
        else:
            assert x == y, f.name


def _ids_once(sess):
    ids = torch.cat([a[:, :, 1:sess.spec.nx_local + 1].reshape(-1)
                     for a in sess.sim.idx_d] + list(sess.sim.sidx))
    ids = torch.sort(ids[ids >= 0]).values
    return torch.equal(ids, torch.arange(sess.n, dtype=ids.dtype))


def test_constructor_takes_the_reference_knobs():
    """Every knob of the reference's constructor but the TPU-only
    ``interpret``; ``restore`` takes the trigger and the step's kind."""
    want = set(inspect.signature(JSession.__init__).parameters) \
        - {"interpret"}
    got = set(inspect.signature(ShardedSession.__init__).parameters)
    assert want <= got, want - got
    assert {"fused", "stencils", "refless_trigger", "donate",
            "segmented"} <= set(inspect.signature(
                ShardedSession.restore).parameters)


def test_refless_trigger_matches_jax(refless_pair):
    """The refless sessions: placeholders for the reference planes, the
    same rebins, slots and counters as the JAX refless session, the
    particles by idx at the Session gate's tolerances."""
    sj, st, _ = refless_pair
    assert [tuple(r.shape) for r in st.sim.ref_xd] == [(1, 1, 1)] * 2
    assert np.asarray(sj.sim.ref_xd).shape == (2, 1, 1, 1)
    _counters_match(st, sj)
    assert st.rebin_count >= 2 and st._fingerprint["refless"] is True
    _particles_match(st.state(), sj.state())
    np.testing.assert_allclose(
        np.stack([d.numpy() for d in st.sim.disp2]),
        np.asarray(sj.sim.disp2), rtol=1e-4)


def test_refless_against_ref_based(refless_pair):
    """The reference's own gate: the summed bound rebins at least as often
    as the ref-based trigger, loses nothing, keeps every idx once, and
    the particles agree within 5e-5 (positions) and 5e-3 (velocities)."""
    _, st, ref = refless_pair
    assert st.rebin_count >= ref.rebin_count
    assert st.overflow == ref.overflow == 0 and st.lost == 0
    assert _ids_once(st)
    a, b = st.state(), ref.state()
    assert float((a.x - b.x).abs().max()) <= 5e-5
    assert float((a.vx - b.vx).abs().max()) <= 5e-3


@pytest.mark.parametrize("trigger", ["ref-based", "refless"])
def test_segmented_bitwise_standard(scene, trigger):
    """``segmented=True`` (with owned planes and the planar rebin) walks
    the standard run's trajectory bit for bit across ``chunk=`` bounds,
    rebins included.  Ref-based, it is the progress test of the rebin's
    zeroed ``disp2``: every segment ends and the run rebins."""
    spec, state = scene
    refless = trigger == "refless"
    a = _port(spec, state, refless_trigger=refless)
    a.run(24)
    b = _port(spec, state, refless_trigger=refless, planar_rebin=True,
              donate=True, segmented=True)
    b.run(14)
    b.run(10, chunk=6)
    assert b.rebin_count == a.rebin_count > 2 and b.step == 24
    _sims_equal(a.sim, b.sim, None if refless else a.spec.nx_local)


def test_chunked_and_generator_inits_bitwise(scene):
    """``init_chunks=K`` and ``from_generator`` give the sort-based init's
    slabs bit for bit (every plane, spill, counter), and the generator
    init the JAX package's ``from_generator`` planes."""
    spec, state = scene
    a = _port(spec, state)
    for K in (1, 3, 7):
        _sims_equal(a.sim, _port(spec, state, init_chunks=K).sim)
    g = ShardedSession.from_generator(_gen, state.n, PARAMS, CFG,
                                      convert.spec_from(spec), _mesh(),
                                      init_chunks=3, donate=False)
    _sims_equal(a.sim, g.sim)
    j = JSession.from_generator(
        lambda gi: (
            (gi % 24).astype(jnp.float32) * jnp.float32(0.04)
            + jnp.float32(0.3),
            (gi // 24).astype(jnp.float32) * jnp.float32(0.04),
            jnp.full(gi.shape, 3.0, jnp.float32),
            jnp.zeros(gi.shape, jnp.float32)),
        state.n, PARAMS_J, CFG_J, spec, init_chunks=3, donate=False)
    js = _np(j.sim)
    for name in ("xd", "yd", "vxd", "vyd", "idx_d", "occ", "sidx"):
        for d in range(2):
            np.testing.assert_array_equal(getattr(g.sim, name)[d].numpy(),
                                          getattr(js, name)[d], name)
    assert g.sim.alive == [int(v) for v in js.alive]
    assert g.sim.overflow == [int(v) for v in js.overflow]
    # the generator's run is the state's run
    a.run(STEPS)
    g.run(STEPS)
    _sims_equal(a.sim, g.sim)


def test_generator_init_owned_and_refless(scene):
    """The very-large-N defaults of ``from_generator`` (``donate=True``)
    with the refless trigger: bitwise the state-built refless session's
    run."""
    spec, state = scene
    a = _port(spec, state, refless_trigger=True)
    g = ShardedSession.from_generator(_gen, state.n, PARAMS, CFG,
                                      convert.spec_from(spec), _mesh(),
                                      refless_trigger=True, planar_rebin=True)
    assert g.donate
    assert [tuple(r.shape) for r in g.sim.ref_xd] == [(1, 1, 1)] * 2
    a.run(STEPS)
    g.run(STEPS)
    _sims_equal(a.sim, g.sim)


@pytest.fixture(scope="module")
def unfused_pair(scene):
    spec, state = scene
    sj = JSession(state, PARAMS_J, CFG_J, spec, fused=False)
    sj.run(STEPS)
    st = _port(spec, state, fused=False)
    st.run(STEPS)
    return sj, st


def test_unfused_xla_stencils_match_jax(unfused_pair):
    """``fused=False`` with no stencils: the plain XLA pair, as the
    reference's ``fused=False`` session; its fingerprint's kind."""
    sj, st = unfused_pair
    _counters_match(st, sj)
    assert st.rebin_count >= 2
    _particles_match(st.state(), sj.state())
    assert st._fingerprint["solver"] == sj._fingerprint["solver"] \
        == "xla-stencils"


def test_unfused_k1_k8_against_fused(scene):
    """``fused=False`` on ``cuda_solver.make_stencils`` (K1 + K8; their
    twins here) against the fused step: the same rebins and slots, the
    particles at the Session gate's tolerances; K1 writes into the dead
    rho plane when the planes are owned, bit for bit."""
    spec, state = scene
    g = convert.grid_from(spec.local_grid)
    a = _port(spec, state)
    a.run(STEPS)
    kw = dict(fused=False, stencils=cuda_solver.make_stencils(g))
    b = _port(spec, state, **kw)
    b.run(STEPS)
    assert b._fingerprint["solver"] == "custom-stencils"
    assert b.rebin_count == a.rebin_count
    for d in range(2):
        assert torch.equal(a.sim.idx_d[d], b.sim.idx_d[d])
    sa, sb = a.state(), b.state()
    assert float((sa.x - sb.x).abs().max()) <= 1e-5
    assert float((sa.vx - sb.vx).abs().max()) <= 1e-4
    assert float(((sa.rho - sb.rho) / sb.rho).abs().max()) <= 1e-5
    c = _port(spec, state, donate=True, **kw)
    c.run(STEPS)
    _sims_equal(b.sim, c.sim, b.spec.nx_local)


def test_eager_step_takes_stencils(scene):
    """``shard.make_sharded_step(stencils=XLA_STENCILS)`` against the
    reference's eager slab step on its default (XLA) stencils: slot
    owners, migrations and counters exact, particles at the eager gate's
    tolerances."""
    spec_j = jsh.ShardSpec.build(h=0.045, x_min=-1.0, x_max=2.5, y_max=3.0,
                                 n_devices=2, capacity=1024)
    spec_t = convert.spec_from(spec_j)
    # the scene shifted so a lattice column sits 0.004 left of the slab
    # seam: it crosses within the steps below
    _, state_j = scene
    seam = float(spec_j.global_x0 + spec_j.slab_width)
    xs = np.asarray(state_j.x)
    state_j = state_j.replace(
        x=state_j.x + np.float32(seam - 0.004 - xs[xs < seam].max()))
    step_j = jsh.make_sharded_step(PARAMS_J, CFG_J, spec_j, jsh.make_mesh(2))
    sj = jsh.shard_state(state_j, spec_j)
    step_t = tsh.make_sharded_step(PARAMS, CFG, spec_t, _mesh(),
                                   stencils=grid_solver.XLA_STENCILS)
    st = tsh.shard_state(convert.state_from(_np(state_j), "cpu"), spec_t,
                         _mesh())
    alive0 = [int(a.sum()) for a in st.alive]
    for _ in range(8):
        sj, dj = step_j(sj)
        jax.block_until_ready(sj.x)
        st, dt = step_t(st)
    sj, dj = _np(sj), _np(dj)
    for d in range(2):
        np.testing.assert_array_equal(st.idx[d].numpy(), sj.idx[d])
    assert dt.alive_count == list(dj.alive_count.reshape(-1)) != alive0
    assert dt.dropped == list(dj.dropped.reshape(-1)) == [0, 0]
    assert dt.overflow == list(dj.overflow.reshape(-1))
    n = state_j.n
    got = tsh.to_fluid_state(st, n)
    want = _np(jsh.to_fluid_state(jsh.ShardedState(**{
        k: jnp.asarray(getattr(sj, k)) for k in
        ("x", "y", "vx", "vy", "rho", "p", "idx", "alive", "step")}), n))
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.vx.numpy(), want.vx, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.rho.numpy(), want.rho, rtol=1e-5)


def test_inplace_halo_bitwise_copying(scene):
    """The halo written in place into owned planes gives the copying
    halo's planes (and leaves the copying path's inputs as they were);
    owned sessions run bitwise the copying ones, refless in every field,
    ref-based but for the reference planes' ghost columns, which the
    in-place halo writes through their alias and nothing reads."""
    spec, state = scene
    st = _port(spec, state)
    st.run(STEPS)
    fields = [tuple(p.clone() for p in f) for f in
              zip(st.sim.xd, st.sim.yd, st.sim.vxd, st.sim.vyd)]
    before = [tuple(p.clone() for p in f) for f in fields]
    fills = (1e9, 1e9, 0.0, 0.0)
    nxl = st.spec.nx_local
    copied = tsh.fill_ghost_cols_multi(_mesh(), fields, nxl, fills)
    for f, b in zip(fields, before):
        assert all(torch.equal(u, v) for u, v in zip(f, b))
    inplace = tsh.fill_ghost_cols_multi(_mesh(), fields, nxl, fills,
                                        inplace=True)
    for c, i, f in zip(copied, inplace, fields):
        assert all(torch.equal(u, v) and v is w
                   for u, v, w in zip(c, i, f))
    for refless in (True, False):
        a = _port(spec, state, refless_trigger=refless)
        b = _port(spec, state, refless_trigger=refless, donate=True)
        a.run(STEPS)
        b.run(STEPS)
        assert a.rebin_count >= 2
        _sims_equal(a.sim, b.sim, None if refless else a.spec.nx_local)


@pytest.mark.parametrize("refless", [False, True])
def test_owned_planar_rebin_with_recovery_bitwise(refless):
    """The owned planar rebin (``donate=True``: the ghost columns cleared
    in place, the losses read off the code before the applies consume the
    old planes) with a spill to collect and re-admit
    (``tests/test_shard_recovery.py``'s scene: 9 particles in one cell of
    cap 8) against the copying fused rebin: every field bitwise, counters
    and spill buffers included."""
    cx, cy = np.meshgrid(np.arange(3) * 0.004 + 0.2,
                         np.arange(3) * 0.004 + 0.05)
    bx, by = np.meshgrid(np.arange(4) * 0.06 + 1.5,
                         np.arange(2) * 0.06 + 0.03)
    pos = np.concatenate([np.stack([cx.ravel(), cy.ravel()], -1),
                          np.stack([bx.ravel(), by.ravel()], -1)])
    state = from_positions(torch.from_numpy(pos.astype(np.float32)), "cpu")
    spec = tsh.ShardSpec.build(h=0.045 * 1.5, x_min=-1.0, x_max=2.5,
                               y_max=3.0, n_devices=2, capacity=512)
    cfg = convert.cfg_from(bgf.IntegrateConfig.create(x_min=-1.0, x_max=2.5,
                                                      bounce=-0.5))
    sims = []
    for kw in (dict(planar=False), dict(planar=True, donate=True)):
        steps = tsv.make_sharded_verlet_step(PARAMS, cfg, spec, _mesh(),
                                             n=state.n, refless=refless,
                                             fused=True, **kw)
        sim = steps.init(tsh.shard_state(state, spec, _mesh()))
        for _ in range(30):
            sim = steps.step(sim)
        sims.append(sim)
    a, b = sims
    assert sum(a.readmitted) >= 1 and a.overflow == [1, 0]
    _sims_equal(a, b, None if refless else spec.nx_local)


def test_rebin_counts_in_slabs_bitwise(scene, monkeypatch):
    """The slab step's live-slot counts and slot bounds taken in row slabs
    (planes of more than ``reslot.SLAB_MIN`` elements, the ceiling's): a
    D = 2 ceiling-posture session (refless trigger, owned planes, the
    planar rebin consuming them) runs bitwise the one that counts each
    plane in one pass."""
    spec, state = scene
    kw = dict(refless_trigger=True, planar_rebin=True, donate=True)
    one = _port(spec, state, **kw)
    one.run(STEPS + MORE)
    monkeypatch.setattr(reslot, "SLAB_MIN", 0)    # slabs even at this size,
    monkeypatch.setattr(reslot, "SLABS", 5)       # a ragged last one
    slabs = _port(spec, state, **kw)
    assert reslot.slab_rows(slabs.sim.xd[0].shape) < \
        slabs.sim.xd[0].shape[0]
    slabs.run(STEPS + MORE)
    assert slabs.rebin_count >= 3
    _sims_equal(one.sim, slabs.sim)


@pytest.mark.parametrize("wrapper, fail_at", [("select_cuda", 1),
                                              ("apply_code_cuda", 1),
                                              ("select_cuda", 2),
                                              ("apply_code_cuda", 3)])
def test_owned_planar_rebin_failure_leaves_session_usable_or_says_so(
        scene, monkeypatch, wrapper, fail_at):
    """An owned planar rebin that fails on slab 0 before any input plane
    was consumed (its K6, or its first K7) hands the planes back: the
    session goes on bitwise the run that never failed.  A failure after
    that (slab 1's K6: slab 0's planes are gone; slab 0's third K7)
    raises RuntimeError naming the loss."""
    spec, state = scene
    ok = _port(spec, state, planar_rebin=True, donate=True)
    s = _port(spec, state, planar_rebin=True, donate=True)
    steps = 0
    while not s._steps.need(s.sim):
        s.run(1)
        steps += 1
    real, calls = getattr(tsv.reslot_ops, wrapper), []

    def failing(*args):
        calls.append(1)
        if len(calls) == fail_at:
            raise MemoryError("no room for the plane")
        return real(*args)
    monkeypatch.setattr(tsv.reslot_ops, wrapper, failing)
    if (wrapper, fail_at) in (("select_cuda", 2), ("apply_code_cuda", 3)):
        with pytest.raises(RuntimeError, match="consuming input planes"):
            s.run(1)
        return
    with pytest.raises(MemoryError):
        s.run(1)
    monkeypatch.setattr(tsv.reslot_ops, wrapper, real)
    assert all(p is not None for p in s.sim.xd) and s.step == steps
    s.run(STEPS)
    ok.run(steps + STEPS)
    assert ok.rebin_count >= 2
    _sims_equal(ok.sim, s.sim, spec.nx_local)


def test_copying_posture_keeps_snapshots(scene):
    """Without ``donate`` a ShardedDenseSim kept from ``sess.sim`` stays a
    valid snapshot through steps and rebins (planar ones included): the
    run resumed from it is the uninterrupted run."""
    spec, state = scene
    s = _port(spec, state, planar_rebin=True)
    s.run(4)
    snap = s.sim
    copy = dataclasses.replace(snap, **{
        f.name: [t.clone() for t in getattr(snap, f.name)]
        for f in dataclasses.fields(snap)
        if isinstance(getattr(snap, f.name), list)
        and isinstance(getattr(snap, f.name)[0], torch.Tensor)})
    s.run(STEPS)
    assert s.rebin_count > snap.rebin_count
    _sims_equal(snap, copy)


def test_refless_checkpoints_cross_packages(refless_pair, tmp_path):
    """A port refless artifact restores in the JAX package and a JAX one
    in the port ([D, 1, 1, 1] placeholders both ways); each continues
    where the other does; a port restore of a port artifact continues
    bitwise, under owned planes and the segmented driver too; a restore
    under the ref-based trigger is refused."""
    sj, st, _ = refless_pair
    ppath = os.fspath(tmp_path / "port_refless")
    st.save(ppath)
    with np.load(ppath + ".npz") as z:
        assert z["sim.ref_xd"].shape == (2, 1, 1, 1)
    jj = JSession.restore(ppath, refless_trigger=True)
    a = ShardedSession.restore(ppath, _mesh(), refless_trigger=True)
    _sims_equal(a.sim, st.sim)
    b = ShardedSession.restore(ppath, _mesh(), refless_trigger=True,
                               donate=True, segmented=True,
                               planar_rebin=True)
    jj.run(MORE)
    a.run(MORE)
    b.run(MORE, chunk=4)
    _counters_match(a, jj)
    _particles_match(a.state(), jj.state())
    _sims_equal(a.sim, b.sim)
    with pytest.raises(ValueError, match="refless"):
        ShardedSession.restore(ppath, _mesh(), refless_trigger=False)
    with pytest.raises(ValueError, match="solver"):
        ShardedSession.restore(ppath, _mesh(), refless_trigger=True,
                               fused=False)
    jpath = os.fspath(tmp_path / "jax_refless")
    sj.save(jpath)
    c = ShardedSession.restore(jpath, _mesh(), refless_trigger=True)
    assert [tuple(r.shape) for r in c.sim.ref_xd] == [(1, 1, 1)] * 2
    jk = JSession.restore(jpath, refless_trigger=True)
    jk.run(MORE)
    c.run(MORE)
    _counters_match(c, jk)
    _particles_match(c.state(), jk.state())


def test_posture_defaults_split_the_card(monkeypatch):
    """The automatic postures give each slab an equal part of its card:
    two slabs on one card decide as one Session would on half of it, a
    slab alone on its card on all of it, less the copying halo's planes
    unless the step owns its planes; off the GPU nothing is automatic."""
    g = tvs.default_grid(0.045, -1.0, 800.0, y_max=880.0)
    plane = 4 * g.ny_pad * g.cap * g.nx_pad
    total = int(14 * plane + tvs.RESERVE_BYTES)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (total, total))
    one_card = SlabMesh(["cuda:0", "cuda:0"])
    two_cards = SlabMesh(["cuda:0", "cuda:1"])
    copy = int(tsv.HALO_COPY_FOOTPRINTS * plane)
    for single in (tvs.planar_rebin_default, tvs.refless_trigger_default,
                   tvs.segmented_run_default):
        for donate, less in ((True, 0), (False, copy)):
            fn = lambda mesh: tsv.slab_default(single, g, mesh, donate)
            assert fn(one_card) == single(g, total_bytes=total // 2 - less)
            assert fn(two_cards) == single(g, total_bytes=total - less)
            assert fn(_mesh()) is False
    # 14 planes: a lone slab that owns its planes fits the ref-based
    # planar posture (13); copying (13 + 4) or two on the card, it needs
    # the refless one
    refless = lambda mesh, donate: tsv.slab_default(
        tvs.refless_trigger_default, g, mesh, donate)
    assert not refless(two_cards, True)
    assert refless(two_cards, False)
    assert refless(one_card, True)
    assert tsv.slab_default(tvs.planar_rebin_default, g, two_cards, True)
