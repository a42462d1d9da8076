"""The reference's kernel experiments (the repo's ``tools/exp_*.py``)
against the port's twins of T1-T4 (``models/exp_kernels.py``) and the
port's tools (``bevy_gpu_fluid_tpu_torch/tools/exp_*.py``), on the CPU.

The scene is the tools' 40 x 40 dam break (cells 1.75 h), its velocities
jittered from a numpy seed, after 30 port Session steps; its planes go to
both packages as numpy arrays, rho from K1's twin, the rebin references
jittered from the seed so the displacement max is not trivial.  The JAX
side runs each tool's Pallas kernel in interpret mode, as the JAX
package's own tests run its kernels: ``exp_tlayout`` picks interpret mode
off the TPU itself, ``exp_dbuf`` and ``exp_forces`` hard-code
``interpret=False``, so their tests substitute a ``pl.pallas_call`` that
sets it.  Importing a reference tool points JAX's compilation cache at the
tool's own directory; the module puts back the setting it found.

T1's and T3's TMA layouts (``dbuf_plan``, ``forces_t_plan``: the mirror
of what their C entry points lay out) are pinned on every plane shape the
repo runs against TMA's rules and the SM they are built for, and so is the
walk tile of T2 and T4 (``walk_plan``: its tiles, its 16-byte chunks, its
shared memory, its counts 16-byte aligned at every cap); its items
(``walk_items``) are held on four of the premise scenes of
tests/test_torch_stencil_tiles.py, the edges scene and the tools' scene:
they cover every live slot once and no dead one.  The edges scene
(``torch_scenes.edges_scene``, shared with the card tests) is checked for
the premises its card tests rely on, and the twins against the reference
kernels on it.

Tolerances, and why (the production counterparts' gates):
* T1 against ``make_dbuf``: x, y 1e-6 absolute, vx, vy 1e-4 of max |v|,
  the displacement max 1e-4 relative (K2's twin against
  ``forces_integrate_pallas``: one step of the same arithmetic);
* T2 against ``density_t``: 1e-5 relative on live slots (K1's);
* T3 against ``forces_t`` and T4 against ``make_forces``, every variant:
  1e-5 of the plane's max |a| (K8's), on the interior row blocks, which
  are all the TPU kernels write.
"""

import dataclasses
import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gpu_fluid_tpu as bgf
from bevy_gpu_fluid_tpu.models import verlet_solver as jvs

from bevy_gpu_fluid_tpu_torch import tools
from bevy_gpu_fluid_tpu_torch.models import cuda_solver
from bevy_gpu_fluid_tpu_torch.models import exp_kernels as ek
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as tvs
from bevy_gpu_fluid_tpu_torch.tools import exp_dbuf, exp_forces, exp_tlayout
from bevy_gpu_fluid_tpu_torch.ops.binning import FAR
from bevy_gpu_fluid_tpu_torch.ops.reslot import row_kmax
from torch_scenes import EDGES_GRID, edges_scene, tile_scenes

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N = 1600          # 40 x 40
STEPS = 30
SKIN = 1.75


def _reference_tool(name):
    """The repo's ``tools/<name>.py`` as a module, JAX's compilation cache
    directory put back as the tool's import found it."""
    cache_dir = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return mod


ref_dbuf = _reference_tool("exp_dbuf")
ref_forces = _reference_tool("exp_forces")
ref_tlayout = _reference_tool("exp_tlayout")


@pytest.fixture
def interpret(monkeypatch):
    """``pl.pallas_call`` in interpret mode for the tools that hard-code
    ``interpret=False``."""
    from jax.experimental import pallas as pl
    call = pl.pallas_call

    def forced(*args, **kw):
        kw["interpret"] = True
        return call(*args, **kw)
    monkeypatch.setattr(pl, "pallas_call", forced)


@pytest.fixture(scope="module")
def scene():
    """The port's sim, Scene and rho, and the JAX grid, params and
    cfg."""
    rng = np.random.default_rng(12)
    sc = tools.dam_break(N, "cpu", SKIN)
    st = sc.state
    state = st.replace(
        vx=torch.from_numpy(rng.normal(0, 0.5, st.n).astype(np.float32)),
        vy=torch.from_numpy(rng.normal(0, 0.5, st.n).astype(np.float32)))
    sess = tvs.Session(state, sc.params, sc.cfg, sc.grid, device="cpu")
    sess.run(STEPS)
    sim = sess.sim
    live = sim.xd < 5e8
    shift = torch.from_numpy(
        rng.uniform(-0.004, 0.004, (2, *sim.xd.shape)).astype(np.float32))
    sim.ref_xd = torch.where(live, sim.xd + shift[0], sim.xd)
    sim.ref_yd = torch.where(live, sim.yd + shift[1], sim.yd)
    rho = cuda_solver.density_cuda(sim.xd, sim.yd, sc.params, sc.grid,
                                   sim.occ)
    extent = sc.extent
    jgrid = jvs.default_grid(0.045, -1.0, extent + 1.0,
                             y_max=extent * 1.1 + 1.0, cap=8,
                             skin_factor=SKIN)
    assert (jgrid.ny_pad, jgrid.cap, jgrid.nx_pad) == sc.grid.plane_shape
    assert jgrid.row_block == sc.grid.row_block
    assert int(live.sum()) == N
    return dict(sim=sim, sc=sc, rho=rho, jgrid=jgrid,
                jparams=bgf.FluidParams.demo(),
                jcfg=bgf.IntegrateConfig.create(x_min=-1.0,
                                                x_max=extent + 1.0))


def _j(t):
    return jnp.asarray(t.numpy())


def _interior(a, tb, axis=0):
    a = np.asarray(a)
    return a[tb:-tb] if axis == 0 else a[:, tb:-tb]


# ------------------------------------------------------------- T1

def test_dbuf_twin_matches_reference(scene, interpret):
    sim, sc, rho = scene["sim"], scene["sc"], scene["rho"]
    planes = (sim.xd, sim.yd, sim.vxd, sim.vyd, rho, sim.ref_xd, sim.ref_yd)
    fn = ref_dbuf.make_dbuf(scene["jgrid"], scene["jcfg"], scene["jparams"])
    want = fn(*(_j(p) for p in planes), _j(sim.occ))
    got = ek.forces_integrate_dbuf_torch(*planes, sc.params, sc.cfg, sc.grid,
                                         sim.occ)
    tb = sc.grid.row_block
    for i in range(2):
        np.testing.assert_allclose(_interior(got[i], tb),
                                   _interior(want[i], tb), rtol=0,
                                   atol=1e-6)
    vscale = max(np.abs(_interior(want[i], tb)).max() for i in (2, 3))
    assert vscale > 0.5
    for i in (2, 3):
        np.testing.assert_allclose(_interior(got[i], tb),
                                   _interior(want[i], tb), rtol=0,
                                   atol=1e-4 * vscale)
    wd = float(jnp.max(want[4]))
    assert wd > 0 and abs(float(got[4]) - wd) <= 1e-4 * wd
    # the twin is K2's, and the wrapper's CPU path is the twin
    k2 = cuda_solver.forces_integrate_cuda(*planes, sc.params, sc.cfg,
                                           sc.grid, sim.occ)
    wrapped = ek.forces_integrate_dbuf_cuda(*planes, sc.params, sc.cfg,
                                            sc.grid, sim.occ)
    for a, b, c in zip(got, k2, wrapped):
        assert torch.equal(a, b) and torch.equal(a, c)


# ------------------------------------------------------------- T2, T3

@pytest.fixture(scope="module")
def slot_major(scene):
    sim, sc = scene["sim"], scene["sc"]
    xt, yt = ek.to_slot_major(sim.xd), ek.to_slot_major(sim.yd)
    occ_t = ek.block_kmax3_t(xt, sc.grid)
    assert torch.equal(occ_t, sim.occ)
    return xt, yt, occ_t


def test_density_t_twin_matches_reference(scene, slot_major):
    sim, sc = scene["sim"], scene["sc"]
    xt, yt, occ_t = slot_major
    want = np.asarray(ref_tlayout.density_t(_j(xt), _j(yt), scene["jparams"],
                                            scene["jgrid"]))
    got = ek.density_t_cuda(xt, yt, sc.params, sc.grid, occ_t)
    tb = sc.grid.row_block
    live = _interior(xt.numpy() < 5e8, tb, axis=1)
    np.testing.assert_allclose(_interior(got, tb, axis=1)[live],
                               _interior(want, tb, axis=1)[live], rtol=1e-5)
    # bitwise K1's twin after movedim, ghost blocks 0 included
    assert torch.equal(ek.from_slot_major(got), scene["rho"])


def test_forces_t_twin_matches_reference(scene, slot_major):
    sim, sc = scene["sim"], scene["sc"]
    xt, yt, occ_t = slot_major
    vxt, vyt = ek.to_slot_major(sim.vxd), ek.to_slot_major(sim.vyd)
    rhot = ek.to_slot_major(scene["rho"])
    want = ref_tlayout.forces_t(_j(xt), _j(yt), _j(vxt), _j(vyt), _j(rhot),
                                scene["jparams"], scene["jgrid"])
    got = ek.forces_t_cuda(xt, yt, vxt, vyt, rhot, sc.params, sc.grid,
                           occ_t)
    tb = sc.grid.row_block
    w = [_interior(a, tb, axis=1) for a in want]
    scale = max(np.abs(a).max() for a in w)
    assert scale > 1.0
    for g, a in zip(got, w):
        np.testing.assert_allclose(_interior(g, tb, axis=1), a, rtol=0,
                                   atol=1e-5 * scale)
    # K8's function: within the same gate of K8's twin
    k8 = cuda_solver.forces_torch(sim.xd, sim.yd, sim.vxd, sim.vyd,
                                  scene["rho"], sc.params, sc.grid, sim.occ)
    for g, a in zip(got, k8):
        np.testing.assert_allclose(ek.from_slot_major(g).numpy(), a.numpy(),
                                   rtol=0, atol=1e-5 * scale)


# ------------------------------------------------------------- T4

@pytest.mark.parametrize("variant", ek.VARIANTS)
def test_forces_variant_twin_matches_reference(scene, interpret, variant):
    sim, sc, rho = scene["sim"], scene["sc"], scene["rho"]
    planes = (sim.xd, sim.yd, sim.vxd, sim.vyd, rho)
    want = ref_forces.make_forces(scene["jgrid"], variant)(
        *(_j(p) for p in planes), scene["jparams"])
    got = ek.forces_variant_cuda(*planes, sc.params, sc.grid, sim.occ,
                                 variant)
    tb = sc.grid.row_block
    w = [_interior(a, tb) for a in want]
    scale = max(np.abs(a).max() for a in w)
    assert np.isfinite(scale) and scale > 1.0
    for g, a in zip(got, w):
        np.testing.assert_allclose(_interior(g, tb), a, rtol=0,
                                   atol=1e-5 * scale)


def test_forces_variants_agree_as_designed(scene):
    """v0 is K8's twin and v3 v2's, bit for bit; v1 and v2 within K8's
    gate of v0; v0nr is not K8's function."""
    sim, sc, rho = scene["sim"], scene["sc"], scene["rho"]
    args = (sim.xd, sim.yd, sim.vxd, sim.vyd, rho, sc.params, sc.grid,
            sim.occ)
    a = {v: ek.forces_variant_torch(*args, v) for v in ek.VARIANTS}
    k8 = cuda_solver.forces_torch(*args)
    assert all(torch.equal(u, w) for u, w in zip(a["v0"], k8))
    assert all(torch.equal(u, w) for u, w in zip(a["v3"], a["v2"]))
    scale = float(torch.maximum(k8[0].abs().max(), k8[1].abs().max()))
    for v in ("v1", "v2"):
        assert max(float((u - w).abs().max())
                   for u, w in zip(a[v], k8)) <= 1e-5 * scale
    assert max(float((u - w).abs().max())
               for u, w in zip(a["v0nr"], k8)) > 1e-3 * scale
    with pytest.raises(ValueError):
        ek.forces_variant_cuda(*args, "v4")


def test_wrappers_check_planes_and_count_only_launches(scene, slot_major):
    sim, sc, rho = scene["sim"], scene["sc"], scene["rho"]
    xt, yt, occ_t = slot_major
    with pytest.raises(ValueError):       # dense planes where slot-major
        ek.density_t_cuda(sim.xd, sim.yd, sc.params, sc.grid, occ_t)
    with pytest.raises(ValueError):
        ek.forces_variant_cuda(sim.xd.double(), sim.yd, sim.vxd, sim.vyd,
                               rho, sc.params, sc.grid, sim.occ, "v1")
    before = tools.launch_counts()
    ek.density_t_cuda(xt, yt, sc.params, sc.grid, occ_t)
    ek.forces_variant_cuda(sim.xd, sim.yd, sim.vxd, sim.vyd, rho, sc.params,
                           sc.grid, sim.occ, "v3")
    assert set(tools.launches_since(before).values()) == {0}   # twins
    assert {"forces_integrate_dbuf", "density_t", "forces_t",
            *(f"forces_variant_{v}" for v in ek.VARIANTS)} \
        <= set(before)


# ------------------------------------------------------------- T1, T3 plans

def _shape(n, skin):
    return tools.dam_break(n, "cpu", skin, state=False).grid.plane_shape


# Every plane shape the repo runs T1 and T3 on, or a production
# counterpart of theirs: the tools' 1M scenes (T1/T4 at skin 1.75, T2/T3 at
# 1.5), bench_scale's 96M at both skins, the memory ceiling, the bench's
# sweep (10k, 100k), a D = 2 slab, the card tests' two scenes.
PLANE_SHAPES = {
    "1m_skin1.5": ((696, 8, 640), lambda: _shape(1_000_000, 1.5)),
    "1m_skin1.75": ((600, 8, 640), lambda: _shape(1_000_000, 1.75)),
    "96m_skin1.75": (None, lambda: _shape(96_000_000, 1.75)),
    "96m_skin1.5": (None, lambda: _shape(96_000_000, 1.5)),
    "ceiling": ((15628, 8, 14336), None),
    "10k": ((96, 8, 128), lambda: _shape(10_000, 1.75)),
    "100k": ((216, 8, 256), lambda: _shape(100_000, 1.75)),
    "slab_d2": ((696, 8, 384), None),
    "moving": (None, lambda: tvs.default_grid(0.045, -1.0, 2.5,
                                              y_max=6.0).plane_shape),
    "edges": ((42, 8, 128), lambda: EDGES_GRID.plane_shape),
}


PLANS = {"dbuf": ek.dbuf_plan, "forces_t": ek.forces_t_plan}


@pytest.mark.parametrize("shape_name", list(PLANE_SHAPES))
@pytest.mark.parametrize("kernel", list(PLANS))
def test_tma_plan_on_every_plane_shape(kernel, shape_name):
    """Each kernel's layout: TMA's rules (strides multiples of 16 bytes,
    box extents <= 256, the inner box 128 bytes), the tensor's dims and
    strides for the layout, the stage's bytes, and a stage that fits the
    blocks per SM the kernel is built for (shared memory and warps; T1
    keeps at least 24 warps resident)."""
    want, made = PLANE_SHAPES[shape_name]
    shape = tuple(made()) if made else want
    assert want is None or shape == want
    ny_pad, cap, nx_pad = shape
    plan = PLANS[kernel](shape)
    assert ek.tma_rules(plan) == []
    assert all(s % 16 == 0 for s in plan.strides)
    boxes = [plan.box, plan.ref_box] if kernel == "dbuf" else [plan.box]
    for box in boxes:
        assert all(1 <= b <= 256 for b in box) and box[0] * 4 == 128
    win = (plan.rows + 2) * cap * 32 * 4
    if kernel == "dbuf":
        assert plan.dims == (nx_pad, cap, ny_pad)
        assert plan.strides == (4 * nx_pad, 4 * cap * nx_pad)
        assert plan.box == (32, 1, plan.rows + 2)
        assert plan.ref_box == (32, 1, plan.rows)
        assert plan.stage_bytes == 5 * win + 2 * plan.rows * cap * 128
        assert plan.resident_warps >= 24
    else:
        assert plan.dims == (nx_pad, ny_pad, cap)
        assert plan.strides == (4 * nx_pad, 4 * ny_pad * nx_pad)
        assert plan.box == (32, plan.rows + 2, 1)
        assert plan.ref_box == (0, 0, 0)
        assert plan.stage_bytes == 5 * win
    # the stage, and the packed window (24 bytes a slot) after it
    assert plan.smem_bytes >= plan.stage_bytes + 6 * win
    assert plan.smem_bytes <= ek.BLOCK_SMEM
    assert plan.blocks_per_sm * (plan.smem_bytes + ek.SMEM_RESERVED) \
        <= ek.SM_SMEM
    assert plan.resident_warps <= ek.SM_WARPS
    assert plan.stage_bytes <= ek.TX_MAX


@pytest.mark.parametrize("kernel", list(PLANS))
def test_tma_plan_stages_what_the_slots_need(kernel):
    """A box per field and slot stages kmax slot layers of every field,
    nothing at kmax 0, and all of them fit the stage; the rules refuse a
    box past TMA's extents, strides off 16 bytes, a stage past one
    barrier phase and blocks past an SM's shared memory."""
    shape = (696, 8, 640)
    plan = PLANS[kernel](shape)
    rows = plan.rows
    per_slot = 5 * (rows + 2) * 128 + (2 * rows * 128 if kernel == "dbuf"
                                       else 0)
    for kmax in range(9):
        assert plan.tile_bytes(kmax) == kmax * per_slot
    assert plan.tile_bytes(8) == plan.stage_bytes
    for bad in (dict(box=(32, 1, 300)), dict(box=(16, 1, 4)),
                dict(strides=(4 * 641, 4 * 8 * 640)),
                dict(stage_bytes=ek.TX_MAX + 1), dict(blocks_per_sm=16)):
        assert ek.tma_rules(dataclasses.replace(plan, **bad))


def test_tma_wrappers_refuse_offset_views(scene, slot_major):
    """A plane that starts off TMA's 16-byte alignment (an offset view),
    and a plane that is not contiguous, are refused before any launch."""
    sim, sc, rho = scene["sim"], scene["sc"], scene["rho"]
    planes = [sim.xd, sim.yd, sim.vxd, sim.vyd, rho, sim.ref_xd, sim.ref_yd]
    flat = torch.empty(sim.xd.numel() + 1, dtype=torch.float32)
    shifted = flat[1:].view(sim.xd.shape)
    shifted.copy_(sim.xd)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        ek.forces_integrate_dbuf_cuda(shifted, *planes[1:], sc.params,
                                      sc.cfg, sc.grid, sim.occ)
    xt, yt, occ_t = slot_major
    vxt, vyt = ek.to_slot_major(sim.vxd), ek.to_slot_major(sim.vyd)
    rhot = ek.to_slot_major(rho)
    flat_t = torch.empty(xt.numel() + 1, dtype=torch.float32)
    shifted_t = flat_t[1:].view(xt.shape)
    shifted_t.copy_(xt)
    with pytest.raises(ValueError, match="aligned"):
        ek.forces_t_cuda(shifted_t, yt, vxt, vyt, rhot, sc.params, sc.grid,
                         occ_t)
    with pytest.raises(ValueError):    # not contiguous
        ek.forces_t_cuda(xt.transpose(1, 2).contiguous().transpose(1, 2),
                         yt, vxt, vyt, rhot, sc.params, sc.grid, occ_t)


@pytest.fixture(scope="module")
def edges():
    return edges_scene("cpu")


def test_edges_scene_premises(edges):
    """What the card tests of T1 and T3 on this scene rely on: a row block
    whose slot bound is cap, live particles in column 1 beside the ghost
    column 0 (and in the last tile, which is short: nx_pad 128 is no
    multiple of 30), FAR in every ghost column (what the TMA kernels patch
    the columns past the plane's edge to), live slots a prefix of each
    cell, dead slots FAR with v = 0, occ bounding every cell."""
    sim, grid, _ = edges
    assert grid.nx_pad % 30 != 0 and grid.row_block % 2 and \
        grid.row_block % 4
    assert int(sim.occ.max()) == grid.cap
    live = sim.xd < 5e8
    assert bool(live[:, :, 1].any())
    assert int(live[:, 0].sum(dim=0).nonzero().max()) >= \
        grid.nx_pad - grid.nx_pad % 30
    for col in (0, grid.nx + 1, grid.nx_pad - 1):
        assert bool((sim.xd[:, :, col] == FAR).all())
    prefix = live.cummin(dim=1).values
    assert torch.equal(prefix, live)
    dead = ~live
    assert bool((sim.vxd[dead] == 0).all() & (sim.vyd[dead] == 0).all())
    assert bool((sim.xd[dead] >= 5e8).all() & (sim.yd[dead] >= 5e8).all())
    counts = live.sum(dim=1)                       # [ny_pad, nx_pad]
    kmax = torch.repeat_interleave(sim.occ.amax(dim=0), grid.row_block)
    tb = grid.row_block
    assert bool((counts[tb:tb + kmax.numel()] <= kmax[:, None]).all())


@pytest.mark.parametrize("kernel", ["dbuf", "forces_t"])
def test_twins_match_reference_on_edges_scene(edges, interpret, kernel):
    """T1's and T3's twins against the reference's kernels on the edges
    scene, at the gates of the module docstring."""
    sim, grid, cfg = edges
    params = tools.dam_break(4, "cpu").params
    rho = cuda_solver.density_cuda(sim.xd, sim.yd, params, grid, sim.occ)
    jgrid = bgf.GridSpec2D(grid.origin_x, grid.origin_y, grid.cell_size,
                           grid.nx, grid.ny, grid.cap, grid.row_block)
    jparams = bgf.FluidParams.demo()
    tb = grid.row_block
    if kernel == "dbuf":
        planes = (sim.xd, sim.yd, sim.vxd, sim.vyd, rho, sim.ref_xd,
                  sim.ref_yd)
        jcfg = bgf.IntegrateConfig.create(x_min=float(cfg.x_min),
                                          x_max=float(cfg.x_max))
        want = ref_dbuf.make_dbuf(jgrid, jcfg, jparams)(
            *(_j(p) for p in planes), _j(sim.occ))
        got = ek.forces_integrate_dbuf_cuda(*planes, params, cfg, grid,
                                            sim.occ)
        for i in range(2):
            np.testing.assert_allclose(_interior(got[i], tb),
                                       _interior(want[i], tb), rtol=0,
                                       atol=1e-6)
        vscale = max(np.abs(_interior(want[i], tb)).max() for i in (2, 3))
        for i in (2, 3):
            np.testing.assert_allclose(_interior(got[i], tb),
                                       _interior(want[i], tb), rtol=0,
                                       atol=1e-4 * vscale)
        wd = float(jnp.max(want[4]))
        assert wd > 0 and abs(float(got[4]) - wd) <= 1e-4 * wd
    else:
        xt, yt, vxt, vyt, rhot = (ek.to_slot_major(p) for p in
                                  (sim.xd, sim.yd, sim.vxd, sim.vyd, rho))
        want = ref_tlayout.forces_t(_j(xt), _j(yt), _j(vxt), _j(vyt),
                                    _j(rhot), jparams, jgrid)
        got = ek.forces_t_cuda(xt, yt, vxt, vyt, rhot, params, grid,
                               ek.block_kmax3_t(xt, grid))
        w = [_interior(a, tb, axis=1) for a in want]
        scale = max(np.abs(a).max() for a in w)
        assert scale > 1.0
        for g, a in zip(got, w):
            np.testing.assert_allclose(_interior(g, tb, axis=1), a, rtol=0,
                                       atol=1e-5 * scale)


# -------------------------------------------------------- T2, T4 walk tile

def test_walk_items_list_slot_pairs_in_row_slot_column_order():
    cnt = [[3, 0, 2], [1, 4, 0]]
    assert ek.walk_items(cnt, 4) == [
        (0, 0, 0, True), (0, 2, 0, True), (0, 0, 2, False),
        (1, 0, 0, False), (1, 1, 0, True), (1, 1, 2, True)]
    assert ek.walk_items(cnt, 4, slots=1) == [
        (0, 0, 0, False), (0, 2, 0, False), (0, 0, 1, False),
        (0, 2, 1, False), (0, 0, 2, False), (1, 0, 0, False),
        (1, 1, 0, False), (1, 1, 1, False), (1, 1, 2, False),
        (1, 1, 3, False)]


WALK_SCENES = ("init", "need", "readmitted", "mono", "edges", "tools")


@pytest.fixture(scope="module")
def walk_scenes(scene, edges):
    """name -> (sim, grid): four premise scenes, the edges scene (cells at
    cap beside the wrapped ghost column, a short last tile, odd row
    block) and the tools' scene."""
    out = {k: v[:2] for k, v in
           tile_scenes(("init", "need", "readmitted", "mono")).items()}
    out["edges"] = edges[:2]
    out["tools"] = (scene["sim"], scene["sc"].grid)
    return out


def _counts(sim, grid):
    """Each cell's live slots below its row's bound, [ny_pad, nx_pad]."""
    live = (sim.xd < 0.5 * FAR).sum(dim=1)
    return torch.minimum(live, row_kmax(sim.occ, grid)[:, 0])


def _tiles(grid):
    """(rows, cols) of each walk tile's interior cells."""
    tb = grid.row_block
    plan = ek.walk_plan(grid.plane_shape, "density_t")
    for rb in range(1, grid.n_row_blocks + 1):
        for r0 in range(0, tb, plan.rows):
            rows = range(rb * tb + r0, rb * tb + min(r0 + plan.rows, tb))
            for col0, cols in plan.tile_cols:
                yield rows, range(col0, col0 + cols)


@pytest.mark.parametrize("name", WALK_SCENES)
def test_walk_items_cover_every_live_slot_once(walk_scenes, name):
    """Over the walk tiles, the items (cell, s, two) list every live slot
    exactly once and no dead one: s is live, s + 1 is live iff ``two``
    (a cell of odd count leaves its last item one slot)."""
    sim, grid = walk_scenes[name]
    n = _counts(sim, grid)
    kmax = row_kmax(sim.occ, grid)[:, 0, 0]
    seen = torch.zeros(grid.plane_shape, dtype=torch.int64)
    odd = 0
    for rows, cols in _tiles(grid):
        cnt = [[int(n[r, c]) for c in cols] for r in rows]
        for i, j, s, two in ek.walk_items(cnt, int(kmax[rows[0]])):
            r, c = rows[i], cols[j]
            assert s % 2 == 0 and s < cnt[i][j]
            assert two == (s + 1 < cnt[i][j])
            seen[r, s, c] += 1
            if two:
                seen[r, s + 1, c] += 1
            odd += not two
    live = sim.xd < 0.5 * FAR
    assert torch.equal(seen, live.to(torch.int64))
    # the tools' lattice fills its cells evenly; the others hold odd cells
    assert odd > 0 or name == "tools"


@pytest.mark.parametrize("shape_name", list(PLANE_SHAPES))
@pytest.mark.parametrize("kernel", list(ek.WALK_KERNELS))
def test_walk_plan_on_every_plane_shape(kernel, shape_name):
    """The walk tile on every plane shape the repo runs: its tiles cover
    every column from 1 on exactly once (column 0, a ghost column, is the
    first tile's lane 31), every window row starts on a 16-byte boundary
    of the plane in both layouts and its chunks lie all inside the plane or
    all past it, and the window, the counts and the items fit the block's
    shared memory with blocks to spare."""
    want, made = PLANE_SHAPES[shape_name]
    shape = tuple(made()) if made else want
    ny_pad, cap, nx_pad = shape
    plan = ek.walk_plan(shape, kernel)
    covered = np.zeros(nx_pad, int)
    for col0, cols in plan.tile_cols:
        assert 0 < cols <= ek.RING_COLS
        covered[col0:col0 + cols] += 1
        # the window's first column and its row strides in both layouts
        assert (4 * (col0 - 1)) % 16 == 0
        assert all(s % 16 == 0 for s in (4 * nx_pad, 4 * cap * nx_pad,
                                         4 * ny_pad * nx_pad))
        for q in range(ek.WIN_COLS // 4):     # chunks all in or all out
            c = col0 - 1 + 4 * q
            assert (c + 3 < nx_pad) == (c < nx_pad)
    assert covered[0] == 0 and (covered[1:] == 1).all()
    assert plan.threads // 32 >= 4
    threads, slot_bytes = ek.WALK_KERNELS[kernel]
    layer = ek.WALK_LAYER
    assert layer == 32 * plan.stride + 1 and layer % 2   # odd: no conflicts
    assert plan.window_bytes == (layer * cap + cap % 2) * slot_bytes
    assert plan.window_bytes % 16 == 0     # the counts' int4 stores
    assert plan.stride >= plan.rows + 2 and plan.stride % 2 == 1
    assert plan.window_index(1, 0, 0) == layer
    assert plan.window_index(0, 1, 0) == plan.stride
    assert plan.smem_bytes >= plan.window_bytes + (plan.rows + 2) * 32 * 4
    assert plan.smem_bytes <= ek.BLOCK_SMEM
    assert plan.items * 2 >= plan.rows * ek.RING_COLS * -(-cap // 2) * 2
    assert plan.blocks_per_sm >= (12 if kernel == "density_t" else 5)


@pytest.mark.parametrize("cap", [1, 2, 3, 7, 8, 9, 31, 63])
@pytest.mark.parametrize("kernel", list(ek.WALK_KERNELS))
def test_walk_plan_aligns_the_counts_at_every_cap(kernel, cap):
    """The counts follow the window and are stored as int4s: they start
    16-byte aligned at an odd cap too (an odd slot layer of 225 slots of 8
    or 24 bytes would leave them 8 bytes off), and the items and their
    count after them 4-byte aligned."""
    try:
        plan = ek.walk_plan((96, cap, 128), kernel)
    except ValueError:     # T4's window past a block's shared memory
        assert kernel == "forces_variant" and cap == 63
        return
    slot_bytes = ek.WALK_KERNELS[kernel][1]
    assert plan.window_bytes >= ek.WALK_LAYER * cap * slot_bytes
    assert plan.window_bytes % 16 == 0
    dead_rho = plan.rows * ek.WIN_COLS * 4 if kernel == "density_t" else 0
    items_at = plan.window_bytes + (plan.rows + 2) * ek.WIN_COLS * 4 \
        + dead_rho
    assert items_at % 4 == 0 and (items_at + 2 * plan.items) % 4 == 0
    assert plan.smem_bytes == items_at + 2 * plan.items + 4


def test_walk_plan_refuses_what_the_kernel_does_not_take():
    """A cap past the items' slot field, nx_pad off the 16-byte chunks,
    and a window past a block's shared memory are refused."""
    ek.walk_plan((96, ek.WALK_MAX_CAP, 128), "density_t")
    for shape, kernel in (((96, ek.WALK_MAX_CAP + 1, 128), "density_t"),
                          ((96, 8, 126), "forces_variant"),
                          ((96, ek.WALK_MAX_CAP, 128), "forces_variant")):
        with pytest.raises(ValueError):
            ek.walk_plan(shape, kernel)


def test_walk_wrappers_refuse_offset_views(scene, slot_major):
    """T2's and T4's 16-byte chunks: a plane that starts off a 16-byte
    boundary (an offset view), or is not contiguous, is refused before
    any launch."""
    sim, sc, rho = scene["sim"], scene["sc"], scene["rho"]
    xt, yt, occ_t = slot_major
    flat = torch.empty(xt.numel() + 1, dtype=torch.float32)
    shifted = flat[1:].view(xt.shape)
    shifted.copy_(xt)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        ek.density_t_cuda(xt, shifted, sc.params, sc.grid, occ_t)
    flat = torch.empty(sim.xd.numel() + 1, dtype=torch.float32)
    shifted = flat[1:].view(sim.xd.shape)
    shifted.copy_(sim.vxd)
    with pytest.raises(ValueError, match="aligned"):
        ek.forces_variant_cuda(sim.xd, sim.yd, shifted, sim.vyd, rho,
                               sc.params, sc.grid, sim.occ, "v0")
    with pytest.raises(ValueError):    # not contiguous
        ek.forces_variant_cuda(sim.xd.transpose(0, 2).contiguous()
                               .transpose(0, 2), sim.yd, sim.vxd, sim.vyd,
                               rho, sc.params, sc.grid, sim.occ, "v2")


# ------------------------------------------------------------- the tools

def _lines(capsys):
    return capsys.readouterr().out.splitlines()


def test_exp_forces_main(capsys):
    assert exp_forces.main(["--cpu", "--n", str(N), "--iters", "1",
                            "--steps", str(STEPS)]) == 0
    lines = _lines(capsys)
    for v in ek.VARIANTS:
        assert any(ln.startswith(f"pass0 {v} ") for ln in lines)
        assert any(ln.startswith(f"pass1 {v} ") for ln in lines)
        assert any(ln.startswith(f"{v:6s} best ") for ln in lines)
    for v in ("v1", "v2", "v3"):
        assert any(ln.startswith(f"{v} vs v0 interior max abs diff: ")
                   for ln in lines)
    out = json.loads(lines[-1])
    assert out["ok"] and out["n"] == N and out["device"] == "cpu"
    assert out["diff_vs_v0"]["v3"] == out["diff_vs_v0"]["v2"]


def test_exp_tlayout_main(capsys):
    assert exp_tlayout.main(["--cpu", "--n", str(N), "--iters", "1"]) == 0
    lines = _lines(capsys)
    for prefix in ("# max |rho_t - rho_cur| = ",
                   "density current [rows,cap,nx]: ",
                   "density transposed [cap,rows,nx]: ",
                   "forces current [rows,cap,nx]: ",
                   "forces transposed [cap,rows,nx]: "):
        assert any(ln.startswith(prefix) for ln in lines), prefix
    out = json.loads(lines[-1])
    assert out["ok"] and out["rho_max_abs_diff"] == 0.0


def test_exp_dbuf_main(capsys):
    assert exp_dbuf.main(["--cpu", "--n", str(N), "--iters", "1",
                          "--steps", str(STEPS)]) == 0
    lines = _lines(capsys)
    assert any(ln.startswith("production fused : ") for ln in lines)
    assert any(ln.startswith("double-buffered  : ") for ln in lines)
    for i in range(4):
        assert f"out[{i}] interior max abs diff: 0.000e+00" in lines
    out = json.loads(lines[-1])
    assert out["ok"] and out["planes_equal"]


@pytest.mark.parametrize("tool", [exp_forces, exp_tlayout, exp_dbuf])
def test_exp_tools_need_the_card_by_default(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--n", str(N)])


def test_reference_tools_leave_the_cache_setting():
    assert jax.config.jax_compilation_cache_dir == os.path.expanduser(
        "~/.jax_cache_cpu")
