"""The port's slab decomposition (``parallel/mesh.py``, ``parallel/shard.py``)
against the JAX package's on the CPU: the spec, the partition of a state
into slabs, the ghost-column halo and the eager slab step with migration.

The JAX side runs as its own tests run it, on the 8 virtual CPU devices
of ``tests/conftest.py``: ``shard_map`` over ``shard.make_mesh(D)``, the
Pallas stencils in interpret mode.  The port runs one process over a
``SlabMesh(["cpu"] * D)``, its kernel wrappers on CPU tensors (the
kernels' twins).

Tolerances: the spec, the partition, the halo and every integer of the
eager step (idx, alive, the diagnostics) exact; after 25 eager steps
positions 1e-6 absolute, velocities 1e-4 absolute, rho 1e-5 relative, p
0.01 absolute (the eager Session gate's tolerances, ``test_torch_eager.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gpu_fluid_tpu as bgf
from bevy_gpu_fluid_tpu.models import pallas_solver as jps
from bevy_gpu_fluid_tpu.parallel import shard as jsh

from bevy_gpu_fluid_tpu_torch.ops.binning import FAR
from bevy_gpu_fluid_tpu_torch.parallel import shard as tsh
from bevy_gpu_fluid_tpu_torch.parallel.mesh import SlabMesh
from bevy_gpu_fluid_tpu_torch.utils import convert

torch.set_num_threads(1)

PARAMS_J = bgf.FluidParams.demo()
CFG_J = bgf.IntegrateConfig.create(x_min=-1.0, x_max=2.5)
PARAMS = convert.params_from(PARAMS_J)
CFG = convert.cfg_from(CFG_J)
EAGER_STEPS = 25


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def four_slab_state():
    """The 80 x 8 scene of ``tests/conftest.py`` (x in [-0.98, 2.18],
    kicked right at 4.0: it spans every slab and crosses every interior
    boundary)."""
    state = bgf.init_grid(80, 8, 0.04)
    return state.replace(x=state.x - 0.98, vx=jnp.full((state.n,), 4.0))


def _specs(D, h=0.045 * 1.5, capacity=1024):
    spec = jsh.ShardSpec.build(h=h, x_min=-1.0, x_max=2.5, y_max=3.0,
                               n_devices=D, capacity=capacity)
    return spec, convert.spec_from(spec)


def _mesh(D):
    return SlabMesh(["cpu"] * D)


@pytest.mark.parametrize("D", [2, 4])
def test_spec_and_slab_origins_match_jax(D):
    spec_j, spec_t = _specs(D)
    want = tsh.ShardSpec.build(h=0.045 * 1.5, x_min=-1.0, x_max=2.5,
                               y_max=3.0, n_devices=D, capacity=1024)
    assert want == spec_t
    for d in range(D):
        # the reference's traced origin: global_x0 + f32(d) * slab_width
        ox = spec_j.global_x0 + jnp.float32(d) * spec_j.slab_width
        assert np.float32(ox) == tsh.slab_origin(spec_t, d)[0]
    assert spec_t.global_grid().nx == D * spec_t.nx_local


@pytest.mark.parametrize("D", [2, 4])
def test_shard_state_matches_jax(D):
    """The partition (slab of each particle, original order within a
    slab, dead slots FAR/0/-1) exactly, and ``convert.sharded_state_from``
    carries JAX's into the same slabs; ``to_fluid_state`` inverts it and
    ``unshard_state`` gives the reference's slab order."""
    spec_j, spec_t = _specs(D)
    state_j = four_slab_state()
    want = _np(jsh.shard_state(state_j, spec_j))
    got = tsh.shard_state(convert.state_from(_np(state_j), "cpu"), spec_t,
                          _mesh(D))
    for name in ("x", "y", "vx", "vy", "rho", "p", "idx", "alive"):
        for d in range(D):
            np.testing.assert_array_equal(getattr(got, name)[d].numpy(),
                                          getattr(want, name)[d], name)
    carried = convert.sharded_state_from(want, _mesh(D))
    assert carried.step == got.step
    for name in ("x", "y", "vx", "vy", "rho", "p", "idx", "alive"):
        for d in range(D):
            assert torch.equal(getattr(carried, name)[d],
                               getattr(got, name)[d]), name
    back = tsh.to_fluid_state(got, state_j.n)
    np.testing.assert_array_equal(back.x.numpy(), np.asarray(state_j.x))
    np.testing.assert_array_equal(back.vx.numpy(), np.asarray(state_j.vx))
    flat = _np(jsh.unshard_state(jsh.shard_state(state_j, spec_j)))
    np.testing.assert_array_equal(tsh.unshard_state(got).x.numpy(), flat.x)


def test_shard_state_refuses_over_capacity():
    _, spec_t = _specs(2, capacity=100)
    state = convert.state_from(_np(four_slab_state()), "cpu")
    with pytest.raises(ValueError, match="capacity"):
        tsh.shard_state(state, spec_t, _mesh(2))


def test_fill_ghost_cols_matches_jax():
    """The halo on four slabs of random planes: each slab's ghost columns
    hold its neighbours' real edge columns, the outer ones the fill, bit
    for bit the reference's ``_fill_ghost_cols_multi`` under
    ``shard_map``; the inputs are left as they were."""
    from jax.sharding import PartitionSpec as P
    D = 4
    spec_j, spec_t = _specs(D)
    g = spec_t.local_grid
    nxl = spec_t.nx_local
    rng = np.random.default_rng(5)
    planes = [rng.standard_normal((D,) + g.plane_shape).astype(np.float32)
              for _ in range(3)]
    fills = (FAR, 0.0, -2.5)

    def local(a, b, c):
        out = jsh._fill_ghost_cols_multi(
            [t.reshape(t.shape[1:]) for t in (a, b, c)], nxl, D, fills)
        return tuple(t.reshape((1,) + t.shape) for t in out)
    want = jax.shard_map(local, mesh=jsh.make_mesh(D),
                         in_specs=(P(jsh.AXIS),) * 3,
                         out_specs=(P(jsh.AXIS),) * 3,
                         check_vma=False)(*planes)
    fields = [tuple(torch.from_numpy(p[d].copy()) for p in planes)
              for d in range(D)]
    got = tsh.fill_ghost_cols_multi(_mesh(D), fields, nxl, fills)
    for d in range(D):
        for i in range(3):
            np.testing.assert_array_equal(got[d][i].numpy(),
                                          np.asarray(want[i])[d])
            np.testing.assert_array_equal(fields[d][i].numpy(),
                                          planes[i][d])


def test_mesh_collectives():
    """shift_fwd/shift_bwd (the edge slab receives the fill), max/min over
    slabs on every slab, and any in one read."""
    mesh = _mesh(3)
    xs = [torch.full((2,), float(d)) for d in range(3)]
    assert [t.tolist() for t in mesh.shift_fwd(xs, -1.0)] == \
        [[-1.0, -1.0], [0.0, 0.0], [1.0, 1.0]]
    assert [t.tolist() for t in mesh.shift_bwd(xs, 9.0)] == \
        [[1.0, 1.0], [2.0, 2.0], [9.0, 9.0]]
    assert [float(t[0]) for t in mesh.max(xs)] == [2.0] * 3
    assert [float(t[0]) for t in mesh.min(xs)] == [0.0] * 3
    assert mesh.any([x > 1.5 for x in xs])
    assert not mesh.any([x > 2.5 for x in xs])
    assert SlabMesh(["cpu", "cpu"]).n == 2
    with pytest.raises(ValueError):
        SlabMesh()


@pytest.fixture(scope="module")
def eager_runs():
    """EAGER_STEPS eager slab steps of the four-slab scene at D = 4 in
    both packages: the JAX step on its Pallas stencils (interpret mode),
    the port's on K1 + K8 (their twins here), on the eager grid (cells of
    h)."""
    D = 4
    spec_j, spec_t = _specs(D, h=0.045)
    state_j = four_slab_state()
    step_j = jsh.make_sharded_step(
        PARAMS_J, CFG_J, spec_j, jsh.make_mesh(D),
        stencils=jps.make_stencils(spec_j.local_grid, interpret=True))
    sj = jsh.shard_state(state_j, spec_j)
    mesh = _mesh(D)
    step_t = tsh.make_sharded_step(PARAMS, CFG, spec_t, mesh)
    st = tsh.shard_state(convert.state_from(_np(state_j), "cpu"), spec_t,
                         mesh)
    alive0 = [int(a.sum()) for a in st.alive]
    for _ in range(EAGER_STEPS):
        sj, dj = step_j(sj)
        jax.block_until_ready(sj.x)
        st, dt = step_t(st)
    return _np(sj), _np(dj), st, dt, alive0, state_j.n


def test_eager_sharded_step_integers_match_jax(eager_runs):
    sj, dj, st, dt, alive0, _ = eager_runs
    D = len(st.x)
    for d in range(D):
        np.testing.assert_array_equal(st.idx[d].numpy(), sj.idx[d])
        np.testing.assert_array_equal(st.alive[d].numpy(), sj.alive[d])
    assert dt.alive_count == list(dj.alive_count.reshape(-1))
    assert dt.dropped == list(dj.dropped.reshape(-1)) == [0] * D
    assert dt.overflow == list(dj.overflow.reshape(-1))
    assert st.step == int(sj.step) == EAGER_STEPS
    # particles migrated between slabs
    assert dt.alive_count != alive0
    assert sum(dt.alive_count) == sum(alive0)


def test_eager_sharded_step_particles_match_jax(eager_runs):
    sj, _, st, _, _, n = eager_runs
    want = jsh.to_fluid_state(jsh.ShardedState(**{
        k: jnp.asarray(getattr(sj, k)) for k in
        ("x", "y", "vx", "vy", "rho", "p", "idx", "alive", "step")}), n)
    got = tsh.to_fluid_state(st, n)
    want = _np(want)
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.y.numpy(), want.y, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.vx.numpy(), want.vx, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.vy.numpy(), want.vy, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.rho.numpy(), want.rho, rtol=1e-5)
    np.testing.assert_allclose(got.p.numpy(), want.p, rtol=0, atol=1e-2)
    assert float(got.x.mean()) > float(np.asarray(four_slab_state().x)
                                       .mean()) + 0.03
