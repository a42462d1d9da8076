"""The port's planar rebin (K6 select, K7 apply, ``taken_mask``,
``reslot_planar`` and the planar Session) against the JAX package and the
fused rebin, on the CPU.

The scene is the perturbed one of tests/test_planar.py (a 20 x 20 lattice
binned, then every particle moved by up to 0.95 of half the skin; the
payload planes carry +-particle numbers), with its random numbers from a
numpy seed.  The JAX side runs its Pallas kernels in interpret mode, as its
own tests run them; the port runs its kernel wrappers on CPU tensors, i.e.
the twins.

Every comparison here is exact: the planar rebin only routes values, and
its result must be the fused rebin's bit for bit (the reason the posture
exists is peak memory, not another answer).  Positions of the Sessions
against the JAX Session: 1e-5 absolute, velocities 1e-4, as in
tests/test_torch_session.py (the same pair sums, FP contraction aside).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gpu_fluid_tpu as bgf
from bevy_gpu_fluid_tpu.models import verlet_solver as jvs
from bevy_gpu_fluid_tpu.ops import reslot as jreslot
from bevy_gpu_fluid_tpu.ops.binning import bin_particles, to_dense

import bevy_gpu_fluid_tpu_torch as bt
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as tvs
from bevy_gpu_fluid_tpu_torch.ops import reslot
from bevy_gpu_fluid_tpu_torch.utils import convert

torch.set_num_threads(1)

PARAMS_J = bgf.FluidParams.demo()
CFG_J = bgf.IntegrateConfig.create(x_min=-1.0, x_max=2.5, bounce=-0.5)
GRIDS = {tb: dataclasses.replace(
    jvs.default_grid(0.045, -1.0, 2.5, y_max=3.0), row_block=tb)
    for tb in (8, 4)}
GRID = GRIDS[8]
PARAMS = convert.params_from(PARAMS_J)
CFG = convert.cfg_from(CFG_J)
CODES = {"int32": torch.int32, "int8": torch.int8}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _perturbed(grid, seed=7):
    """(xd, yd, vxd, vyd, idx_d) as JAX planes: tests/test_planar.py's
    _make_perturbed with numpy random numbers."""
    state = bgf.init_grid(20, 20, 0.04)
    n = state.n
    d = np.random.default_rng(seed).uniform(-1.0, 1.0, (2, n)) \
        .astype(np.float32)
    skin_half = (grid.cell_size - 0.045) * 0.5
    x2 = state.x + d[0] * skin_half * 0.95
    y2 = jnp.maximum(state.y + d[1] * skin_half * 0.95, 0.0)
    b = bin_particles(state.x, state.y, grid, with_csr=False)
    return (to_dense(b, x2, fill=1e9), to_dense(b, y2, fill=1e9),
            to_dense(b, jnp.arange(n, dtype=jnp.float32)),
            to_dense(b, -jnp.arange(n, dtype=jnp.float32)),
            jvs.init_dense(state, grid).idx_d)


@pytest.fixture(scope="module")
def scenes():
    """Per row block: the JAX planes, the port's copies, the occupancy
    bounds and JAX's interpret-mode select (code, counts)."""
    out = {}
    for tb, grid in GRIDS.items():
        planes = _perturbed(grid)
        occ = jreslot.block_kmax3(planes[0], grid)
        code, cnt = jreslot.select_pallas(planes[0], planes[1], grid,
                                          interpret=True, occ=occ)
        out[tb] = (planes, [_t(p) for p in planes], occ, code, cnt)
    return out


@pytest.mark.parametrize("tb", [8, 4])
@pytest.mark.parametrize("code_name", ["int32", "int8"])
def test_select_twin_matches_pallas(tb, code_name, scenes):
    _, (xd, yd, *_), occ, code_j, cnt_j = scenes[tb]
    grid = convert.grid_from(GRIDS[tb])
    code, cnt = reslot.select_cuda(xd, yd, grid, _t(occ), CODES[code_name])
    assert code.dtype == CODES[code_name] and cnt.dtype == torch.int32
    np.testing.assert_array_equal(code.to(torch.int32).numpy(),
                                  np.asarray(code_j))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    assert int((code >= 0).sum()) == int(cnt.clamp_max(grid.cap).sum()) > 300
    # occ is optional: computed from the planes when not given
    assert torch.equal(reslot.select_cuda(xd, yd, grid,
                                          code_dtype=CODES[code_name])[0],
                       code)


@pytest.mark.parametrize("payload", ["xd", "idx_d"])
@pytest.mark.parametrize("code_name", ["int32", "int8"])
@pytest.mark.parametrize("tb", [8, 4])
def test_apply_twin_matches_pallas(payload, code_name, tb, scenes):
    planes_j, planes, occ, code_j, _ = scenes[tb]
    i, fill = {"xd": (0, 1e9), "idx_d": (4, -1)}[payload]
    want = jreslot.apply_code_pallas(planes_j[i], code_j, occ, GRIDS[tb],
                                     fill, interpret=True)
    got = reslot.apply_code_cuda(planes[i], _t(code_j).to(CODES[code_name]),
                                 _t(occ), convert.grid_from(GRIDS[tb]), fill)
    assert got.dtype == planes[i].dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_taken_mask_matches_jax(scenes, monkeypatch):
    """Per source slot: routed by the code or not, as JAX's taken_mask,
    decoded in one pass or in row slabs (a ragged last one); and every
    live slot the fused rebin keeps is taken."""
    _, planes, _, code_j, _ = scenes[8]
    want = np.asarray(jreslot.taken_mask(code_j, GRID.cap))
    for slab_min in (reslot.SLAB_MIN, 0):       # one pass; 16 row slabs
        monkeypatch.setattr(reslot, "SLAB_MIN", slab_min)
        for dtype in CODES.values():
            got = reslot.taken_mask(_t(code_j).to(dtype), GRID.cap)
            np.testing.assert_array_equal(got.numpy(), want)
    post = reslot.reslot_torch(*planes, convert.grid_from(GRID))[4]
    kept = torch.isin(planes[4], post[post >= 0]) & (planes[4] >= 0)
    assert torch.equal(got & (planes[4] >= 0), kept)


@pytest.mark.parametrize("tb", [8, 4])
@pytest.mark.parametrize("code_name", ["int32", "int8"])
def test_reslot_planar_bitwise_reslot(tb, code_name, scenes):
    """K6 + five K7 reproduce K3's six outputs bit for bit."""
    _, planes, *_ = scenes[tb]
    grid = convert.grid_from(GRIDS[tb])
    fused = reslot.reslot_cuda(*planes, grid)
    planar = reslot.reslot_planar(*planes, grid, code_dtype=CODES[code_name])
    for name, a, b in zip(("xd", "yd", "vxd", "vyd", "idx", "cnt"), fused,
                          planar):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_planar_wrappers_check_and_count(scenes):
    """The code type is an argument, checked; a wrapper raises on a plane
    it does not take, and on CPU tensors runs its twin without counting."""
    _, (xd, yd, vxd, *_), occ, code_j, _ = scenes[8]
    grid = convert.grid_from(GRID)
    before = (reslot.select_cuda.launches, reslot.apply_code_cuda.launches)
    with pytest.raises(ValueError, match="code_dtype"):
        reslot.select_cuda(xd, yd, grid, code_dtype=torch.int16)
    with pytest.raises(ValueError, match="code_dtype"):
        tvs.make_step_parts(PARAMS, CFG, grid, planar=True,
                            code_dtype=torch.float32)
    with pytest.raises(ValueError):
        reslot.apply_code_cuda(vxd.double(), _t(code_j), _t(occ), grid, 0.0)
    with pytest.raises(ValueError):
        reslot.apply_code_cuda(vxd, _t(code_j).to(torch.int16), _t(occ),
                               grid, 0.0)
    reslot.reslot_planar(*scenes[8][1], grid)
    assert before == (reslot.select_cuda.launches,
                      reslot.apply_code_cuda.launches)


@pytest.mark.parametrize("cap, ok", [(14, True), (15, False)])
def test_int8_code_needs_cap_14_or_less(cap, ok):
    """Codes reach 9 * cap - 1: int8 holds them up to cap 14 and is refused
    beyond (a wrapped code would read as an empty slot and drop its
    particle); int32 takes any cap."""
    grid = dataclasses.replace(convert.grid_from(GRID), cap=cap)
    xd = torch.full(grid.plane_shape, 1e9)
    reslot.select_cuda(xd, xd, grid, code_dtype=torch.int32)
    if ok:
        code, _ = reslot.select_cuda(xd, xd, grid, code_dtype=torch.int8)
        assert code.dtype == torch.int8
        tvs.make_step_parts(PARAMS, CFG, grid, planar=True,
                            code_dtype=torch.int8)
        return
    with pytest.raises(ValueError, match="cannot hold code 134"):
        reslot.select_cuda(xd, xd, grid, code_dtype=torch.int8)
    with pytest.raises(ValueError, match="cannot hold"):
        reslot.select_torch(xd, xd, grid, code_dtype=torch.int8)
    with pytest.raises(ValueError, match="cannot hold"):
        tvs.make_step_parts(PARAMS, CFG, grid, planar=True,
                            code_dtype=torch.int8)


# --------------------------------------------------------------- Sessions

def _session_pair(state_j, steps):
    """The JAX planar Session and the port's fused and planar Sessions
    (planar with int8 codes: the code type changes nothing) after
    ``steps`` steps from the same state."""
    sj = jvs.Session(state_j, PARAMS_J, CFG_J, GRID, planar_rebin=True)
    sj.run(steps)
    st = convert.state_from(_np(state_j), "cpu")
    grid = convert.grid_from(GRID)
    fused = tvs.Session(st, PARAMS, CFG, grid, device="cpu")
    planar = tvs.Session(st, PARAMS, CFG, grid, device="cpu",
                         planar_rebin=True, code_dtype=torch.int8)
    fused.run(steps)
    planar.run(steps)
    return sj, fused, planar


@pytest.fixture(scope="module", params=["normal", "recovery"])
def session_runs(request):
    """normal: the 20 x 20 block kicked to vx = +2, rebins fire, overflow
    0.  recovery: 9 particles in one cell at cap 8 (the drop -> suspend ->
    readmit cycle of tests/test_planar.py)."""
    if request.param == "normal":
        block = bgf.init_grid(20, 20, 0.04)
        block = block.replace(vx=jnp.full((block.n,), 2.0))
        return request.param, _session_pair(block, 30)
    return request.param, _session_pair(bgf.init_grid(3, 3, 0.004), 60)


def test_planar_session_bitwise_fused(session_runs):
    name, (_, fused, planar) = session_runs
    assert planar.planar_rebin and not fused.planar_rebin
    for f in dataclasses.fields(tvs.DenseSim):
        a, b = getattr(fused.sim, f.name), getattr(planar.sim, f.name)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), f.name
    assert fused.sim.rebin_count >= 3
    if name == "recovery":
        assert fused.sim.overflow >= 1 and fused.readmitted >= 1


def test_planar_session_matches_jax(session_runs):
    _, (sj, _, planar) = session_runs
    assert planar.sim.rebin_count == int(sj.sim.rebin_count)
    assert (planar.overflow, planar.readmitted, planar.suspended) == \
        (sj.overflow, sj.readmitted, sj.suspended)
    np.testing.assert_array_equal(planar.sim.idx_d.numpy(),
                                  np.asarray(sj.sim.idx_d))
    np.testing.assert_array_equal(planar.sim.sidx.numpy(),
                                  np.asarray(sj.sim.sidx))
    want, got = _np(sj.state()), planar.state()
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.y.numpy(), want.y, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.vx.numpy(), want.vx, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.vy.numpy(), want.vy, rtol=0, atol=1e-4)


def test_planar_rebin_takes_its_input():
    """The planar rebin owns the planes it is given: the input DenseSim's
    plane fields are released (None), its outputs are fresh, and the
    result equals the fused rebin's on a copy."""
    grid = convert.grid_from(GRID)
    state = bt.init_grid(12, 12, 0.04, "cpu")
    state = state.replace(vx=torch.full((state.n,), 3.0))
    _, rebin_f, _ = tvs.make_step_parts(PARAMS, CFG, grid, n=state.n)
    _, rebin_p, _ = tvs.make_step_parts(PARAMS, CFG, grid, n=state.n,
                                        planar=True)
    sim = tvs.init_dense(state, grid)
    want = rebin_f(dataclasses.replace(sim))
    got = rebin_p(sim)
    for f in ("xd", "yd", "vxd", "vyd", "idx_d", "ref_xd", "ref_yd"):
        assert getattr(sim, f) is None, f
    for f in dataclasses.fields(tvs.DenseSim):
        a, b = getattr(want, f.name), getattr(got, f.name)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), f.name


@pytest.mark.parametrize("wrapper, fail_at", [("select_cuda", 1),
                                              ("apply_code_cuda", 1),
                                              ("apply_code_cuda", 3)])
def test_planar_rebin_failure_leaves_session_usable_or_says_so(
        monkeypatch, wrapper, fail_at):
    """A rebin that fails before any input plane was consumed (in the
    select or the first apply) hands the planes back: the Session goes on
    and matches a fused Session bit for bit.  A failure after that raises
    RuntimeError naming the loss."""
    grid = convert.grid_from(GRID)
    state = bt.init_grid(12, 12, 0.04, "cpu")
    state = state.replace(vx=torch.full((state.n,), 3.0))
    fused = tvs.Session(state, PARAMS, CFG, grid, device="cpu")
    planar = tvs.Session(state, PARAMS, CFG, grid, device="cpu",
                         planar_rebin=True)
    steps = 0
    while not planar._need(planar.sim):
        planar.run(1)
        steps += 1
    real, calls = getattr(reslot, wrapper), []

    def failing(*args):
        calls.append(1)
        if len(calls) == fail_at:
            raise MemoryError("no room for the plane")
        return real(*args)
    monkeypatch.setattr(reslot, wrapper, failing)
    if fail_at > 1:
        with pytest.raises(RuntimeError, match="consuming input planes"):
            planar.run(1)
        return
    with pytest.raises(MemoryError):
        planar.run(1)
    monkeypatch.setattr(reslot, wrapper, real)
    assert planar.sim.xd is not None and planar.sim.age > 0
    planar.run(10)
    fused.run(steps + 10)
    for f in dataclasses.fields(tvs.DenseSim):
        a, b = getattr(fused.sim, f.name), getattr(planar.sim, f.name)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), f.name
