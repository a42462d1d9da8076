"""The port's CUDA kernels on the card, against their PyTorch twins.

These tests need an NVIDIA Hopper GPU and ``nvcc`` (the kernels are built
for sm_90a on first use); without a GPU they skip.  They import no JAX, so
they run on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: K3 (reslot), K6 (select) and K7 (apply) bitwise; K1 1e-5
relative on every slot, dead ones included; K2 and K5 positions 1e-5
absolute, velocities 1e-4 of the plane's max |v|, disp2 1e-4 relative, and
K2's dead slots bitwise (x, y unchanged, zero velocity); K5 rho 1e-5
relative on live slots and every output of its dead slots bitwise; K4
1e-5 relative on wet pixels; K8 1e-5 of the plane's max |a| per slot and
its dead slots bitwise (+0); K2 refless bitwise K2 with the old positions
as the reference (and within K2's tolerances of its twin), K1 with
``out=`` bitwise without it.  The kernel experiments (T1-T4) at their
production counterparts' gates against their twins: T1 as K2 and bitwise
K2, T2 as K1 and bitwise K1 after ``movedim``, T3 and T4 as K8 (T1's and
T3's TMA layouts and T2's and T4's walk tile as ``exp_kernels`` mirrors
them), T4's v0 bitwise K8 and v3 bitwise v2, T3 and T4's v1 and v2 within
K8's gate of K8, T4's dead slots +0 on scenes with odd and full cells and
at an odd cap.
The kernels contract multiply-adds into FMAs and use the hardware rsqrt;
the twins round every operation.  The planar
Session is bitwise the fused one (both rebins route the same values); the
generator init, the segmented driver and a restored Session are bitwise
what they replace.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import bevy_gpu_fluid_tpu_torch as bt
from bevy_gpu_fluid_tpu_torch.kernels import _build
from bevy_gpu_fluid_tpu_torch.models import cuda_solver
from bevy_gpu_fluid_tpu_torch.models import exp_kernels as ek
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs
from bevy_gpu_fluid_tpu_torch.ops import reslot
from bevy_gpu_fluid_tpu_torch.ops.binning import (FAR, bin_particles, cell_ids,
                                                  stable_order, to_dense)
from bevy_gpu_fluid_tpu_torch.render import raster
from bevy_gpu_fluid_tpu_torch.render.pump import FramePump

pytestmark = pytest.mark.cuda

PARAMS = bt.FluidParams.demo()
CFG = bt.IntegrateConfig.create(x_min=-1.0, x_max=2.5)
GRID = vs.default_grid(0.045, -1.0, 2.5, y_max=6.0)
MONO_GRID = vs.default_grid(0.045, -1.0, 2.5, y_max=3.0)   # 7 row blocks


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA-only")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def moving_sim(cuda):
    """The kicked 24x24 block after 25 steps on the card (a rebin or two
    in), and its particle count."""
    state = bt.init_grid(24, 24, 0.04, cuda)
    state = state.replace(vx=torch.full((state.n,), 2.0, device=cuda))
    sess = vs.Session(state, PARAMS, CFG, GRID, device=cuda)
    sess.run(25)
    return sess.sim


def _csrc(name):
    return (Path(cuda_solver.__file__).parents[1] / "csrc" / name).read_text()


def _tile_shape():
    """(rows, cols) of the K1/K2/K8 tile, kTileRows and kTileCols of
    csrc/bgf_common.cuh."""
    text = _csrc("bgf_common.cuh")
    return tuple(int(re.search(rf"{name} = (\d+);", text).group(1))
                 for name in ("kTileRows", "kTileCols"))


def _mono_tile_shape():
    """(rows, cols) of K5's tile (MonoTile of csrc/mono_step.cu)."""
    text = _csrc("mono_step.cu")
    return (int(re.search(r"kMonoRows = (\d+);", text).group(1)),
            int(re.search(r"HaloTile<kMonoRows, (\d+), 2>", text).group(1)))


def _density_matches(s, grid):
    """K1 against its twin on every slot (dead slots carry coeff x the
    FAR candidates' h^6 terms; ghost blocks 0); returns K1's rho."""
    got = cuda_solver.density_cuda(s.xd, s.yd, PARAMS, grid, s.occ)
    want = cuda_solver.density_torch(s.xd, s.yd, PARAMS, grid, s.occ)
    rel = (got - want).abs() / want.abs().clamp_min(1e-30)
    assert float(rel.max()) <= 1e-5
    tb = grid.row_block
    assert bool((got[:tb] == 0).all() & (got[-tb:] == 0).all())
    assert float(got[s.xd >= FAR * 0.5].max()) > 0
    return got


def _forces_integrate_matches(s, grid, cfg, rho):
    """K2 against its twin at the stated tolerances, and its dead slots
    bitwise: x and y as they were, zero velocity."""
    args = (s.xd, s.yd, s.vxd, s.vyd, rho, s.ref_xd, s.ref_yd, PARAMS, cfg,
            grid, s.occ)
    got = cuda_solver.forces_integrate_cuda(*args)
    want = cuda_solver.forces_integrate_torch(*args)
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max()) <= 1e-5
    vscale = float(torch.maximum(want[2].abs().max(), want[3].abs().max()))
    for g, w in zip(got[2:4], want[2:4]):
        assert float((g - w).abs().max()) <= 1e-4 * vscale
    assert float(want[4]) > 0
    assert abs(float(got[4]) - float(want[4])) <= 1e-4 * float(want[4])
    dead = s.xd >= FAR * 0.5
    assert torch.equal(got[0][dead], s.xd[dead])
    assert torch.equal(got[1][dead], s.yd[dead])
    assert bool((got[2][dead] == 0).all() & (got[3][dead] == 0).all())


def _bits(t):
    return t.contiguous().view(torch.int32)


def _forces_matches(xd, yd, vxd, vyd, rho, grid, occ):
    """K8 against its twin: 1e-5 of max |a| per slot, and the dead slots
    (ghost blocks included) bitwise +0."""
    args = (xd, yd, vxd, vyd, rho, PARAMS, grid, occ)
    before = cuda_solver.forces_cuda.launches
    got = cuda_solver.forces_cuda(*args)
    assert cuda_solver.forces_cuda.launches == before + 1
    want = cuda_solver.forces_torch(*args)
    scale = float(torch.maximum(want[0].abs().max(), want[1].abs().max()))
    assert scale > 10.0
    dead = xd >= FAR * 0.5
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * scale
        assert bool((_bits(g[dead]) == 0).all())
        assert torch.equal(_bits(g[dead]), _bits(w[dead]))


def _mono_matches(s, grid, cfg):
    """K5 against its twin: positions 1e-5, velocities 1e-4 of max |v|,
    rho 1e-5 relative on live slots, disp2 1e-4 relative; every output of
    the dead slots (ghost blocks included) bitwise."""
    args = (s.xd, s.yd, s.vxd, s.vyd, s.ref_xd, s.ref_yd, PARAMS, cfg, grid,
            s.occ)
    got = cuda_solver.mono_step_cuda(*args)
    want = cuda_solver.mono_step_torch(*args)
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max()) <= 1e-5
    vscale = float(torch.maximum(want[2].abs().max(), want[3].abs().max()))
    for g, w in zip(got[2:4], want[2:4]):
        assert float((g - w).abs().max()) <= 1e-4 * vscale
    live = s.xd < FAR * 0.5
    rho_g, rho_w = got[4], want[4]
    assert float(((rho_g - rho_w).abs() / rho_w)[live].max()) <= 1e-5
    for g, w in zip(got[:5], want[:5]):
        assert torch.equal(_bits(g[~live]), _bits(w[~live]))
    assert float(rho_w[~live].max()) > 0      # dead rho from the counts
    assert float(want[5]) > 0
    assert abs(float(got[5]) - float(want[5])) <= 1e-4 * float(want[5])


def test_density_kernel_matches_twin(moving_sim):
    _density_matches(moving_sim, GRID)


def test_forces_integrate_kernel_matches_twin(moving_sim):
    s = moving_sim
    rho = cuda_solver.density_cuda(s.xd, s.yd, PARAMS, GRID, s.occ)
    _forces_integrate_matches(s, GRID, CFG, rho)


@pytest.fixture(scope="module")
def crowded(cuda):
    """A grid that ends inside a tile (nx_pad and row_block not multiples
    of the K1/K2/K8 tile nor of K5's), on a crowd that fills cells to cap
    in the last real columns, after 3 steps: the wrapped ring and the
    short tiles carry live cells.  Returns (sim, grid, cfg)."""
    rows, cols = _tile_shape()
    mono_rows, mono_cols = _mono_tile_shape()
    grid = bt.GridSpec2D(origin_x=-0.135, origin_y=-0.135, cell_size=0.0675,
                         nx=126, ny=22, cap=8, row_block=7)
    assert grid.nx_pad % cols != 0 and grid.row_block % rows != 0
    assert grid.nx_pad % mono_cols != 0 and grid.row_block % mono_rows != 0
    cfg = bt.IntegrateConfig.create(x_min=-0.135, x_max=8.3)
    rng = np.random.default_rng(5)
    state = bt.init_grid(50, 30, 0.04, cuda)
    pos = [torch.from_numpy(rng.uniform(lo, hi, state.n).astype(np.float32))
           .to(cuda) for lo, hi in ((7.45, 8.3), (0.0, 1.0))]
    state = state.replace(x=pos[0], y=pos[1])
    sess = vs.Session(state, PARAMS, cfg, grid, device=cuda)
    assert sess.overflow > 0                   # more than cap in some cells
    sess.run(3)
    s = sess.sim
    assert int(s.occ.max()) == grid.cap
    live_cols = (s.xd < FAR * 0.5).any(dim=0).any(dim=0).nonzero()
    assert int(live_cols.max()) >= grid.nx_pad - grid.nx_pad % cols
    assert int(live_cols.max()) >= grid.nx_pad - grid.nx_pad % mono_cols
    return s, grid, cfg


def test_tiled_kernels_on_ragged_crowded_grid(crowded):
    """K1 and K2 where the grid ends inside a tile, on cap-full cells in
    the ragged last column tile and in short row tiles."""
    s, grid, cfg = crowded
    rho = _density_matches(s, grid)
    _forces_integrate_matches(s, grid, cfg, rho)


def test_forces_kernel_on_ragged_crowded_grid(crowded):
    s, grid, _ = crowded
    rho = cuda_solver.density_cuda(s.xd, s.yd, PARAMS, grid, s.occ)
    _forces_matches(s.xd, s.yd, s.vxd, s.vyd, rho, grid, s.occ)


def test_mono_kernel_on_ragged_crowded_grid(crowded):
    _mono_matches(*crowded)


def _field_matches(s, grid, P):
    """K4 against its twin: 1e-5 relative on wet pixels, 1e-3 absolute on
    the rest; one launch."""
    before = raster.field_density_cuda.launches
    got = raster.field_density_cuda(s.xd, s.yd, PARAMS, grid, P)
    assert raster.field_density_cuda.launches == before + 1
    want = raster.field_density(s.xd, s.yd, PARAMS, grid, P)
    assert got.shape == want.shape == (grid.ny * P, grid.nx * P)
    wet = want > 0.05 * float(PARAMS.rho_0)
    assert int(wet.sum()) > 100
    assert float(((got - want).abs() / want)[wet].max()) <= 1e-5
    assert float((got - want)[~wet].abs().max()) <= 1e-3


def _select_matches(s, grid, code_dtype):
    """K6 against its twin bitwise, on the sim's own occ as the planar
    rebin passes it; one launch."""
    before = reslot.select_cuda.launches
    code, cnt = reslot.select_cuda(s.xd, s.yd, grid, s.occ, code_dtype)
    assert reslot.select_cuda.launches == before + 1
    want_code, want_cnt = reslot.select_torch(s.xd, s.yd, grid, s.occ,
                                              code_dtype)
    assert code.dtype == code_dtype and torch.equal(code, want_code)
    assert torch.equal(cnt, want_cnt) and int(cnt.sum()) > 0


def test_field_kernel_on_ragged_crowded_grid(crowded):
    s, grid, _ = crowded
    for P in (2, 5):
        _field_matches(s, grid, P)


@pytest.mark.parametrize("code_dtype", [torch.int32, torch.int8])
def test_select_kernel_on_ragged_crowded_grid(crowded, code_dtype):
    s, grid, _ = crowded
    _select_matches(s, grid, code_dtype)


@pytest.fixture(scope="module")
def readmitted(cuda):
    """The recovery scene's planes right after the rebin that re-admits a
    spilled particle (the re-admit writes it at the cell's next rank), and
    its cfg."""
    cfg = bt.IntegrateConfig.create(x_min=-1.0, x_max=2.5, bounce=-0.5)
    sess = vs.Session(bt.init_grid(3, 3, 0.004, cuda), PARAMS, cfg,
                      MONO_GRID, device=cuda)
    sim = sess.sim
    for _ in range(60):
        if sess._need(sim):
            before = sim.readmitted
            sim = sess._rebin(sim)
            if sim.readmitted > before:
                break
        sim = sess._pure_step(sim)
    assert sim.readmitted >= 1
    return sim, cfg


def test_tiled_kernels_on_readmitted_planes(readmitted):
    """K1 and K2 on the planes right after a re-admission."""
    sim, cfg = readmitted
    rho = _density_matches(sim, MONO_GRID)
    _forces_integrate_matches(sim, MONO_GRID, cfg, rho)


@pytest.mark.parametrize("code_dtype", [torch.int32, torch.int8])
def test_select_kernel_on_readmitted_planes(readmitted, code_dtype):
    _select_matches(readmitted[0], MONO_GRID, code_dtype)


def test_reslot_kernel_bitwise_twin(moving_sim):
    s = moving_sim
    rng = np.random.default_rng(0)
    shift = torch.from_numpy(rng.uniform(-0.01, 0.01, s.xd.shape)
                             .astype(np.float32)).to(s.xd.device)
    live = s.xd < 5e8
    xd = torch.where(live, s.xd + shift, s.xd)
    planes = (xd, s.yd, s.vxd, s.vyd, s.idx_d)
    got = reslot.reslot_cuda(*planes, GRID)
    want = reslot.reslot_torch(*planes, GRID)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_session_on_card_matches_cpu_twins(cuda):
    """The whole slice: 40 steps on the card vs the same Session on the CPU
    (twins), per particle, with identical rebin schedule and counters."""
    def run(device):
        state = bt.init_grid(24, 24, 0.04, device)
        state = state.replace(vx=torch.full((state.n,), 2.0, device=device))
        sess = vs.Session(state, PARAMS, CFG, GRID, device=device)
        sess.run(40)
        return sess
    a, b = run(cuda), run("cpu")
    assert a.sim.rebin_count == b.sim.rebin_count >= 3
    assert (a.overflow, a.readmitted) == (b.overflow, b.readmitted)
    assert torch.equal(a.sim.idx_d.cpu(), b.sim.idx_d)
    sa, sb = a.state(), b.state()
    assert float((sa.x.cpu() - sb.x).abs().max()) <= 1e-5
    assert float((sa.vy.cpu() - sb.vy).abs().max()) <= 1e-4
    assert float(((sa.rho.cpu() - sb.rho) / sb.rho).abs().max()) <= 1e-5


def test_launch_counters_count_kernel_launches(cuda):
    state = bt.init_grid(16, 16, 0.04, cuda)
    sess = vs.Session(state, PARAMS, CFG, GRID, device=cuda)
    before = (cuda_solver.density_cuda.launches,
              cuda_solver.forces_integrate_cuda.launches,
              reslot.reslot_cuda.launches)
    rebins = sess.sim.rebin_count
    sess.run(7)
    assert cuda_solver.density_cuda.launches - before[0] == 7
    assert cuda_solver.forces_integrate_cuda.launches - before[1] == 7
    assert reslot.reslot_cuda.launches - before[2] == \
        sess.sim.rebin_count - rebins


@pytest.fixture(scope="module")
def mono_sim(cuda):
    """The kicked 24x24 block after 25 steps on a 7-row-block grid, where
    the Session steps on K5."""
    assert MONO_GRID.n_row_blocks < cuda_solver.MONO_MAX_BLOCKS
    state = bt.init_grid(24, 24, 0.04, cuda)
    state = state.replace(vx=torch.full((state.n,), 2.0, device=cuda))
    sess = vs.Session(state, PARAMS, CFG, MONO_GRID, device=cuda)
    sess.run(25)
    return sess.sim


@pytest.mark.parametrize("P", [1, 2, 3, 4, 5])
def test_field_kernel_matches_twin(moving_sim, P):
    _field_matches(moving_sim, GRID, P)


def test_mono_kernel_matches_twin(mono_sim):
    _mono_matches(mono_sim, MONO_GRID, CFG)


@pytest.mark.parametrize("n", [10_000, 5_041, 1_024])
def test_mono_kernel_on_fps_grids(cuda, n):
    """K5 against its twin on the three grids of bench.py --fps after 30
    steps of their dam break (which the Session steps on K5)."""
    side = int(round(n ** 0.5))
    ext = side * 0.04
    cfg = bt.IntegrateConfig.create(x_min=-1.0, x_max=ext + 1.0)
    grid = vs.default_grid(0.045, -1.0, ext + 1.0, y_max=ext * 1.1 + 1.0)
    assert grid.n_row_blocks < cuda_solver.MONO_MAX_BLOCKS
    sess = vs.Session(bt.init_grid(side, side, 0.04, cuda), PARAMS, cfg,
                      grid, device=cuda)
    before = cuda_solver.mono_step_cuda.launches
    sess.run(30)
    assert cuda_solver.mono_step_cuda.launches - before == 30
    _mono_matches(sess.sim, grid, cfg)


def test_mono_kernel_matches_two_kernels_on_live_slots(mono_sim):
    s = mono_sim
    xm, ym, vxm, vym, rhom, dm = cuda_solver.mono_step_cuda(
        s.xd, s.yd, s.vxd, s.vyd, s.ref_xd, s.ref_yd, PARAMS, CFG, MONO_GRID,
        s.occ)
    rho = cuda_solver.density_cuda(s.xd, s.yd, PARAMS, MONO_GRID, s.occ)
    x2, y2, vx2, vy2, d2 = cuda_solver.forces_integrate_cuda(
        s.xd, s.yd, s.vxd, s.vyd, rho, s.ref_xd, s.ref_yd, PARAMS, CFG,
        MONO_GRID, s.occ)
    live = s.xd < 5e8
    assert float(((rhom - rho).abs() / rho)[live].max()) <= 1e-6
    for a, b in ((xm, x2), (ym, y2)):
        assert float((a - b).abs().max()) <= 1e-6
    for a, b in ((vxm, vx2), (vym, vy2)):
        assert float((a - b).abs().max()) <= 1e-4
    assert abs(float(dm) - float(d2)) <= 1e-4 * float(d2)


def test_mono_session_on_card_matches_cpu_twins(cuda):
    """A mono-grid Session: 40 steps on the card (K5, K3) vs the CPU
    twins, with identical rebin schedule, counters and slot assignment."""
    def run(device):
        state = bt.init_grid(24, 24, 0.04, device)
        state = state.replace(vx=torch.full((state.n,), 2.0, device=device))
        sess = vs.Session(state, PARAMS, CFG, MONO_GRID, device=device)
        sess.run(40)
        return sess
    a, b = run(cuda), run("cpu")
    assert a.sim.rebin_count == b.sim.rebin_count >= 3
    assert (a.overflow, a.readmitted) == (b.overflow, b.readmitted)
    assert torch.equal(a.sim.idx_d.cpu(), b.sim.idx_d)
    sa, sb = a.state(), b.state()
    assert float((sa.x.cpu() - sb.x).abs().max()) <= 1e-5
    assert float((sa.vy.cpu() - sb.vy).abs().max()) <= 1e-4
    assert float(((sa.rho.cpu() - sb.rho) / sb.rho).abs().max()) <= 1e-5


def test_mono_and_field_launch_counters(cuda):
    """On a mono grid every step launches K5 once and K1/K2 never; every
    field frame launches K4 once; twins launch nothing."""
    state = bt.init_grid(16, 16, 0.04, cuda)
    sess = vs.Session(state, PARAMS, CFG, MONO_GRID, device=cuda)
    before = (cuda_solver.density_cuda.launches,
              cuda_solver.forces_integrate_cuda.launches,
              cuda_solver.mono_step_cuda.launches,
              raster.field_density_cuda.launches)
    imgs = sess.run_frames(3, substeps=4)
    assert imgs.shape == (3, MONO_GRID.ny * 2, MONO_GRID.nx * 2, 3)
    assert cuda_solver.density_cuda.launches == before[0]
    assert cuda_solver.forces_integrate_cuda.launches == before[1]
    assert cuda_solver.mono_step_cuda.launches - before[2] == 12
    assert raster.field_density_cuda.launches - before[3] == 3
    s = sess.sim
    cpu = [t.cpu() for t in (s.xd, s.yd)]
    raster.field_density_cuda(*cpu, PARAMS, MONO_GRID)
    assert raster.field_density_cuda.launches - before[3] == 3


def test_frame_pump_on_card(cuda):
    """pull=True hands out host arrays equal to the frames, every frame
    once, none overwritten by a later copy; pull=False the device tensors."""
    frames = [torch.full((64, 48, 3), i, dtype=torch.uint8, device=cuda)
              for i in range(5)]
    for pull in (True, False):
        pump = FramePump(pull=pull)
        got = [pump.push(f) for f in frames]
        got = [g for g in got if g is not None] + [pump.flush()]
        assert len(got) == 5 and pump.flush() is None
        for i, g in enumerate(got):
            if pull:
                assert isinstance(g, np.ndarray) and (g == i).all()
            else:
                assert g.is_cuda and bool((g == i).all())


def test_forces_kernel_matches_twin(moving_sim):
    s = moving_sim
    rho = cuda_solver.density_cuda(s.xd, s.yd, PARAMS, GRID, s.occ)
    _forces_matches(s.xd, s.yd, s.vxd, s.vyd, rho, GRID, s.occ)


def test_forces_kernel_on_eager_planes(cuda):
    """K8 on the planes the eager step bins (cells of h, 8 rows a block)
    from a state 10 steps into the kicked block's flight."""
    grid = bt.GridSpec2D.from_bounds(h=0.045, x_min=-1.0, x_max=2.5,
                                     y_min=0.0, y_max=3.0)
    state = bt.init_grid(24, 24, 0.04, cuda)
    state = state.replace(vx=torch.full((state.n,), 2.0, device=cuda))
    state = cuda_solver.multi_step(state, PARAMS, CFG, grid, 10)[0]
    b = bin_particles(state.x, state.y, grid)
    xd, yd, vxd, vyd = (to_dense(b, v, f) for v, f in (
        (state.x, FAR), (state.y, FAR), (state.vx, 0.0), (state.vy, 0.0)))
    occ = reslot.block_kmax3(xd, grid)
    rho = cuda_solver.density_cuda(xd, yd, PARAMS, grid, occ)
    _forces_matches(xd, yd, vxd, vyd, rho, grid, occ)


def test_stable_order_on_card_bitwise_cpu_without_scan(cuda):
    """``stable_order`` of a jittered 1M lattice's cell ids on the card is
    the CPU's bit for bit, and its trace holds no scan kernel (PyTorch's
    1-D ``cummax`` runs in one block)."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator().manual_seed(19)
    side = 1000
    i = torch.arange(side * side)
    jit = (torch.rand((2, side * side), generator=gen) - 0.5) * 8e-4
    x = ((i % side) * 0.04 + jit[0]).float()
    y = ((i // side) * 0.04 + 0.02 + jit[1]).float()
    grid = vs.default_grid(0.045, -1.0, 41.0, y_max=45.0)
    cid = cell_ids(x, y, grid)
    want = stable_order(cid)
    cid_d = cid.to(cuda)
    stable_order(cid_d)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = stable_order(cid_d)
        torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kernels, "the profiler saw no device work"
    assert not [k for k in kernels
                if "scan_innermost_dim_with_indices" in k], kernels


@pytest.fixture(scope="module")
def rebin_planes(moving_sim):
    """The moving sim's planes with positions shifted by up to 0.01 (so
    the rebin moves particles between cells), and their slot bounds."""
    s = moving_sim
    rng = np.random.default_rng(1)
    shift = torch.from_numpy(rng.uniform(-0.01, 0.01, s.xd.shape)
                             .astype(np.float32)).to(s.xd.device)
    live = s.xd < 5e8
    xd = torch.where(live, s.xd + shift, s.xd)
    planes = (xd, s.yd, s.vxd, s.vyd, s.idx_d)
    return planes, reslot.block_kmax3(xd, GRID)


@pytest.mark.parametrize("code_dtype", [torch.int32, torch.int8])
def test_select_and_apply_kernels_bitwise_twins(rebin_planes, code_dtype):
    planes, occ = rebin_planes
    code, cnt = reslot.select_cuda(planes[0], planes[1], GRID, occ,
                                   code_dtype)
    want_code, want_cnt = reslot.select_torch(planes[0], planes[1], GRID,
                                              occ, code_dtype)
    assert code.dtype == code_dtype and torch.equal(code, want_code)
    assert torch.equal(cnt, want_cnt)
    for plane, fill in zip(planes, (1e9, 1e9, 0.0, 0.0, -1)):
        got = reslot.apply_code_cuda(plane, code, occ, GRID, fill)
        want = reslot.apply_code_torch(plane, code, occ, GRID, fill)
        assert got.dtype == plane.dtype and torch.equal(got, want)
    fused = reslot.reslot_cuda(*planes, GRID)
    for a, b in zip(fused, reslot.reslot_planar(*planes, GRID,
                                                code_dtype=code_dtype)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("code_dtype", [torch.int32, torch.int8])
def test_apply_code_out_bitwise_fresh_on_card(rebin_planes, code_dtype):
    """K7 writing into a given plane (``out=``) is bitwise its fresh-output
    call over a garbage plane, float32 and int32 payloads; an ``out`` that
    overlaps the payload is refused."""
    planes, occ = rebin_planes
    code, _ = reslot.select_cuda(planes[0], planes[1], GRID, occ,
                                 code_dtype)
    before = reslot.apply_code_cuda.launches_out
    for plane, fill in zip(planes, (1e9, 1e9, 0.0, 0.0, -1)):
        fresh = reslot.apply_code_cuda(plane, code, occ, GRID, fill)
        out = torch.full_like(plane, 7)
        got = reslot.apply_code_cuda(plane, code, occ, GRID, fill, out=out)
        assert got is out and torch.equal(got.view(torch.int32),
                                          fresh.view(torch.int32))
    assert reslot.apply_code_cuda.launches_out == before + 5
    with pytest.raises(ValueError):
        reslot.apply_code_cuda(planes[0], code, occ, GRID, 1e9,
                               out=planes[0])


def test_planar_session_bitwise_fused_on_card(cuda):
    """Fused and planar Sessions over several rebins on the card: every
    DenseSim field equal; K6 once and K7 five times per planar rebin, K3
    never on the planar Session."""
    def run(**kw):
        state = bt.init_grid(24, 24, 0.04, cuda)
        state = state.replace(vx=torch.full((state.n,), 2.0, device=cuda))
        sess = vs.Session(state, PARAMS, CFG, GRID, device=cuda, **kw)
        counts = (reslot.reslot_cuda.launches, reslot.select_cuda.launches,
                  reslot.apply_code_cuda.launches)
        sess.run(40)
        return sess, [b - a for a, b in zip(counts, (
            reslot.reslot_cuda.launches, reslot.select_cuda.launches,
            reslot.apply_code_cuda.launches))]
    (a, ca), (b, cb) = run(), run(planar_rebin=True)
    rebins = a.sim.rebin_count - 1
    assert rebins >= 3 and ca == [rebins, 0, 0] and cb == [0, rebins,
                                                             5 * rebins]
    for f in dataclasses.fields(vs.DenseSim):
        x, y = getattr(a.sim, f.name), getattr(b.sim, f.name)
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y), f.name


def test_eager_pallas_step_on_card_matches_cpu_twins(cuda):
    """Four eager steps on K1 + K8 (launched once per step) against the
    same steps on the CPU twins."""
    grid = bt.GridSpec2D.from_bounds(h=0.045, x_min=-1.0, x_max=2.5,
                                     y_min=0.0, y_max=3.0)
    before = (cuda_solver.density_cuda.launches,
              cuda_solver.forces_cuda.launches)
    out = []
    for device in (cuda, "cpu"):
        state = bt.init_grid(16, 16, 0.04, device)
        out.append(cuda_solver.multi_step(state, PARAMS, CFG, grid, 4)[0])
    assert (cuda_solver.density_cuda.launches - before[0],
            cuda_solver.forces_cuda.launches - before[1]) == (4, 4)
    a, b = out
    assert float((a.x.cpu() - b.x).abs().max()) <= 1e-5
    assert float((a.vy.cpu() - b.vy).abs().max()) <= 1e-4
    assert float(((a.rho.cpu() - b.rho) / b.rho).abs().max()) <= 1e-5


def test_eager_step_on_card_syncs_once(cuda):
    """One eager step on K1 + K8 of a scene with a crowded cell makes one
    host sync, the overflow read: the scatters and gathers take the
    binning's flat slot index, no boolean mask.  The binning's four planes
    equal the CPU's bitwise, dropped particles' writes included."""
    import warnings
    grid = bt.GridSpec2D.from_bounds(h=0.045, x_min=-1.0, x_max=2.5,
                                     y_min=0.0, y_max=3.0)
    lattice = bt.init_grid(16, 16, 0.04, "cpu")
    crowd = bt.init_grid(3, 4, 0.004, "cpu")
    state = lattice.replace(**{
        f: torch.cat([getattr(lattice, f), getattr(crowd, f) + 0.5])
        for f in ("x", "y", "vx", "vy", "ax", "ay", "rho", "p")})
    state = state.replace(vx=torch.linspace(-1.0, 1.0, state.n),
                          vy=torch.linspace(0.5, -0.5, state.n))
    on_card = state.to(cuda)
    cuda_solver.step_with_diag(on_card, PARAMS, CFG, grid)     # builds
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, diag = cuda_solver.step_with_diag(on_card, PARAMS, CFG, grid)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == 1, syncs
    planes, overflow = [], []
    for s in (on_card, state):
        b = bin_particles(s.x, s.y, grid)
        overflow.append(b.overflow)
        planes.append([to_dense(b, v, fill).cpu() for v, fill in (
            (s.x, FAR), (s.y, FAR), (s.vx, 0.0), (s.vy, 0.0))])
    assert diag.overflow == overflow[0] == overflow[1] > 0
    for a, b in zip(*planes):
        assert torch.equal(_bits(a), _bits(b))


def test_unfused_session_on_card_matches_cpu_twins(cuda):
    """The unfused Session (K1 + K8 + torch integrate) on the card against
    the same Session on the CPU twins; K1 and K8 once per step, K2 never."""
    def run(device):
        state = bt.init_grid(24, 24, 0.04, device)
        state = state.replace(vx=torch.full((state.n,), 2.0, device=device))
        sess = vs.Session(state, PARAMS, CFG, GRID, device=device,
                          stencils=cuda_solver.make_stencils(GRID))
        sess.run(40)
        return sess

    def counts():
        return (cuda_solver.density_cuda.launches,
                cuda_solver.forces_cuda.launches,
                cuda_solver.forces_integrate_cuda.launches)
    before = counts()
    a = run(cuda)
    assert [y - x for x, y in zip(before, counts())] == [40, 40, 0]
    b = run("cpu")
    assert a.sim.rebin_count == b.sim.rebin_count >= 3
    assert (a.overflow, a.readmitted) == (b.overflow, b.readmitted)
    assert torch.equal(a.sim.idx_d.cpu(), b.sim.idx_d)
    sa, sb = a.state(), b.state()
    assert float((sa.x.cpu() - sb.x).abs().max()) <= 1e-5
    assert float((sa.vy.cpu() - sb.vy).abs().max()) <= 1e-4
    assert float(((sa.rho.cpu() - sb.rho) / sb.rho).abs().max()) <= 1e-5


# ---- the memory-ceiling path: K2 refless, K1 out=, the generator init,
# the segmented driver, donation and checkpoints on the card

def _k2_refless_matches(s, grid, rho):
    """K2 refless: its outputs bit for bit K2's with the old positions as
    the reference (the same pair arithmetic), its displacement max bit for
    bit the max over its own outputs (rounded term by term), and within
    the ref-based tolerances of its twin."""
    args = (s.xd, s.yd, s.vxd, s.vyd, rho)
    before = cuda_solver.forces_integrate_cuda.launches_refless
    got = cuda_solver.forces_integrate_cuda(*args, None, None, PARAMS, CFG,
                                            grid, s.occ, refless=True)
    assert cuda_solver.forces_integrate_cuda.launches_refless == before + 1
    ref = cuda_solver.forces_integrate_cuda(*args, s.xd, s.yd, PARAMS, CFG,
                                            grid, s.occ)
    for g, r in zip(got, ref):
        assert torch.equal(_bits(g), _bits(r))
    live = s.xd < FAR * 0.5
    dx, dy = got[0] - s.xd, got[1] - s.yd
    assert torch.equal(got[4], (dx * dx + dy * dy)[live].max())
    want = cuda_solver.forces_integrate_torch(
        *args, None, None, PARAMS, CFG, grid, s.occ, refless=True)
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max()) <= 1e-5
    vscale = float(torch.maximum(want[2].abs().max(), want[3].abs().max()))
    for g, w in zip(got[2:4], want[2:4]):
        assert float((g - w).abs().max()) <= 1e-4 * vscale
    assert float(want[4]) > 0
    assert abs(float(got[4]) - float(want[4])) <= 1e-4 * float(want[4])


def test_forces_integrate_holds_five_blocks_per_sm(cuda):
    """K2, both triggers, is built for five blocks per SM (its kMinBlocks):
    the card holds five at cap 8 (the shared memory allows five), with no
    spill."""
    for name in ("forces_integrate", "forces_integrate_refless"):
        occ = _build.occupancy(name, 8)
        assert occ["blocks_per_sm"] == 5, (name, occ)
        assert occ["registers"] <= 48 and occ["local_bytes"] == 0, occ


def test_forces_integrate_refless_kernel(moving_sim):
    s = moving_sim
    rho = cuda_solver.density_cuda(s.xd, s.yd, PARAMS, GRID, s.occ)
    _k2_refless_matches(s, GRID, rho)


def test_forces_integrate_refless_on_four_row_blocks(cuda):
    grid = dataclasses.replace(GRID, row_block=4)
    state = bt.init_grid(24, 24, 0.04, cuda)
    state = state.replace(vx=torch.full((state.n,), 2.0, device=cuda))
    sess = vs.Session(state, PARAMS, CFG, grid, device=cuda,
                      refless_trigger=True)
    sess.run(15)
    s = sess.sim
    _k2_refless_matches(s, grid, cuda_solver.density_cuda(
        s.xd, s.yd, PARAMS, grid, s.occ))


def test_density_out_bitwise(moving_sim):
    s = moving_sim
    want = cuda_solver.density_cuda(s.xd, s.yd, PARAMS, GRID, s.occ)
    out = torch.full_like(s.xd, float("nan"))
    got = cuda_solver.density_cuda(s.xd, s.yd, PARAMS, GRID, s.occ, out=out)
    assert got is out and torch.equal(_bits(got), _bits(want))


def test_generator_init_bitwise_on_card(cuda):
    state = bt.init_grid(40, 30, 0.04, cuda)
    want = vs.init_dense(state, GRID)
    for got in (vs.init_dense_gen(bt.lattice_gen(40, 0.04, cuda), state.n,
                                  GRID, 7, device=cuda),
                vs.init_dense_chunked(state, GRID, 5)):
        for f in dataclasses.fields(want):
            a, b = getattr(want, f.name), getattr(got, f.name)
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b), f.name


@pytest.mark.parametrize("posture", ["default", "refless-planar-donate"])
def test_segmented_bitwise_standard_on_card(cuda, posture):
    kw = (dict(refless_trigger=True, planar_rebin=True, donate=True)
          if posture != "default" else {})

    def session(segmented):
        state = bt.init_grid(24, 24, 0.04, cuda)
        state = state.replace(vx=torch.full((state.n,), 3.0, device=cuda))
        return vs.Session(state, PARAMS, CFG, GRID, device=cuda,
                          segmented=segmented, **kw)
    a = session(False)
    a.run(33)
    for chunk in (None, 5):
        b = session(True)
        b.run(33, chunk=chunk)
        assert a.sim.rebin_count == b.sim.rebin_count >= 3
        for f in dataclasses.fields(a.sim):
            x, y = getattr(a.sim, f.name), getattr(b.sim, f.name)
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                    else x == y), f.name


@pytest.mark.parametrize("posture", ["default", "refless"])
def test_save_restore_bitwise_on_card(cuda, tmp_path, posture):
    kw = {"refless_trigger": True} if posture == "refless" else {}
    state = bt.init_grid(24, 24, 0.04, cuda)
    state = state.replace(vx=torch.full((state.n,), 2.0, device=cuda))
    a = vs.Session(state, PARAMS, CFG, GRID, device=cuda, **kw)
    a.run(20)
    path = str(tmp_path / "card")
    a.save(path)
    a.run(20)
    b = vs.Session.restore(path, device=cuda, **kw)
    b.run(20)
    for f in dataclasses.fields(a.sim):
        x, y = getattr(a.sim, f.name), getattr(b.sim, f.name)
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y), f.name
    other = {} if kw else {"refless_trigger": True}
    with pytest.raises(ValueError, match="refless"):
        vs.Session.restore(path, device=cuda, **other)


# ---- the slab decomposition: K2's lane window, K3/K6 clip + origin --------

def _sharded(device, D=2, steps=25, **kw):
    """The 80 x 8 four-slab scene (kicked right across every slab
    boundary) as a ShardedSession of D slabs on ``device``, after
    ``steps``."""
    from bevy_gpu_fluid_tpu_torch.parallel import shard
    from bevy_gpu_fluid_tpu_torch.parallel.mesh import SlabMesh
    from bevy_gpu_fluid_tpu_torch.parallel.sharded_session import \
        ShardedSession
    spec = shard.ShardSpec.build(h=0.045 * 1.5, x_min=-1.0, x_max=2.5,
                                 y_max=3.0, n_devices=D, capacity=4096)
    state = bt.init_grid(80, 8, 0.04, device)
    state = state.replace(x=state.x - 0.98,
                          vx=torch.full((state.n,), 4.0, device=device))
    sess = ShardedSession(state, PARAMS, CFG, spec,
                          SlabMesh([device] * D), **kw)
    sess.run(steps)
    return sess


def test_eager_sharded_step_on_card_matches_cpu_twins(cuda):
    """25 eager slab steps at D = 2 (``shard.make_sharded_step``: K1 + K8
    per slab, the halos, migration packing) on the card against the same
    steps on the CPU twins: slot owners and migrations exact, particles at
    the eager step's tolerances; K1 and K8 once per slab and step."""
    from bevy_gpu_fluid_tpu_torch.parallel import shard
    from bevy_gpu_fluid_tpu_torch.parallel.mesh import SlabMesh
    spec = shard.ShardSpec.build(h=0.045, x_min=-1.0, x_max=2.5, y_max=3.0,
                                 n_devices=2, capacity=4096)
    before = (cuda_solver.density_cuda.launches,
              cuda_solver.forces_cuda.launches)
    out = []
    for device in (cuda, "cpu"):
        state = bt.init_grid(80, 8, 0.04, device)
        state = state.replace(x=state.x - 0.98,
                              vx=torch.full((state.n,), 4.0, device=device))
        mesh = SlabMesh([device] * 2)
        step = shard.make_sharded_step(PARAMS, CFG, spec, mesh)
        st = shard.shard_state(state, spec, mesh)
        alive0 = [int(a.sum()) for a in st.alive]
        for _ in range(25):
            st, diag = step(st)
        out.append((st, diag, alive0, state.n))
    assert (cuda_solver.density_cuda.launches - before[0],
            cuda_solver.forces_cuda.launches - before[1]) == (50, 50)
    (a, da, alive0, n), (b, db, _, _) = out
    assert da.alive_count == db.alive_count != alive0
    assert da.dropped == db.dropped == [0, 0]
    assert da.overflow == db.overflow
    for d in range(2):
        assert torch.equal(a.idx[d].cpu(), b.idx[d])
        assert torch.equal(a.alive[d].cpu(), b.alive[d])
    fa, fb = shard.to_fluid_state(a, n), shard.to_fluid_state(b, n)
    assert float((fa.x.cpu() - fb.x).abs().max()) <= 1e-5
    assert float((fa.vx.cpu() - fb.vx).abs().max()) <= 1e-4
    assert float(((fa.rho.cpu() - fb.rho) / fb.rho).abs().max()) <= 1e-5


@pytest.fixture(scope="module")
def sharded_card(cuda):
    return _sharded(cuda)


def test_forces_integrate_disp_lanes(sharded_card):
    """K2 with a slab's lane window: its planes bitwise K2's without it,
    its max bitwise the max over its own outputs in the window (rounded
    term by term), and within K2's tolerances of its twin."""
    sess = sharded_card
    nxl, g = sess.spec.nx_local, sess.spec.local_grid
    for d in range(2):
        s = sess.sim.slab(d)
        xd, yd, vxd, vyd = (s[k].clone() for k in ("xd", "yd", "vxd", "vyd"))
        rho = cuda_solver.density_cuda(xd, yd, PARAMS, g, s["occ"])
        args = (xd, yd, vxd, vyd, rho, s["ref_xd"], s["ref_yd"], PARAMS,
                CFG, g, s["occ"])
        lanes = (1, nxl + 1)
        got = cuda_solver.forces_integrate_cuda(*args, disp_lanes=lanes)
        full = cuda_solver.forces_integrate_cuda(*args)
        for a, b in zip(got[:4], full[:4]):
            assert torch.equal(_bits(a), _bits(b))
        live = (xd < 5e8)[:, :, 1:nxl + 1]
        dx = (got[0] - s["ref_xd"])[:, :, 1:nxl + 1]
        dy = (got[1] - s["ref_yd"])[:, :, 1:nxl + 1]
        want_max = torch.where(live, dx * dx + dy * dy, 0.0).amax()
        assert torch.equal(_bits(got[4]), _bits(want_max))
        twin = cuda_solver.forces_integrate_torch(*args, disp_lanes=lanes)
        assert float((got[0] - twin[0]).abs().max()) <= 1e-5
        assert abs(float(got[4]) - float(twin[4])) <= 1e-4 * float(twin[4])


@pytest.mark.parametrize("code_dtype", [torch.int32, torch.int8])
def test_reslot_and_select_clip_origin_bitwise(sharded_card, code_dtype):
    """K3 and K6 with a slab's clip [-1, nx_local] and world origin on its
    planes (ghost x and idx cleared, as the collective rebin does, then
    nudged so particles cross into the capture columns): bitwise their
    twins, and the planar rebin bitwise K3."""
    from bevy_gpu_fluid_tpu_torch.parallel import shard
    sess = sharded_card
    nxl, g = sess.spec.nx_local, sess.spec.local_grid
    rng = np.random.default_rng(1)
    for d in range(2):
        s = sess.sim.slab(d)
        xd = s["xd"].clone()
        xd[:, :, 0] = FAR
        xd[:, :, nxl + 1] = FAR
        idx = s["idx_d"].clone()
        idx[:, :, 0] = -1
        idx[:, :, nxl + 1] = -1
        live = xd < 5e8
        shift = torch.from_numpy(rng.uniform(-0.05, 0.05, xd.shape)
                                 .astype(np.float32)).to(xd.device)
        xd = torch.where(live, xd + shift, xd)
        planes = (xd, s["yd"], s["vxd"], s["vyd"], idx)
        cell = dict(clip_lo=-1, clip_hi=nxl,
                    origin=shard.slab_origin(sess.spec, d))
        got = reslot.reslot_cuda(*planes, g, **cell)
        want = reslot.reslot_torch(*planes, g, **cell)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        captured = int((got[0][:, :, 0] < 5e8).sum()
                       + (got[0][:, :, nxl + 1] < 5e8).sum())
        assert captured > 0
        occ = reslot.block_kmax3(xd, g)
        code = reslot.select_cuda(xd, s["yd"], g, occ, code_dtype, **cell)
        tcode = reslot.select_torch(xd, s["yd"], g, occ, code_dtype, **cell)
        assert torch.equal(code[0], tcode[0])
        assert torch.equal(code[1], tcode[1])
        planar = reslot.reslot_planar(*planes, g, code_dtype, **cell)
        for a, b in zip(planar, got):
            assert torch.equal(a, b)


def test_sharded_session_on_card_matches_cpu_twins(cuda, sharded_card):
    """A D=2 ShardedSession on the card against the same run on the CPU
    (the kernels' twins): counters and slot assignment exact, particles by
    idx at the Session gate's tolerances."""
    a, b = sharded_card, _sharded("cpu")
    assert a.rebin_count == b.rebin_count >= 3
    assert (a.alive, a.overflow, a.dropped, a.lost) == \
        (b.alive, b.overflow, b.dropped, b.lost) == \
        (a.alive, 0, 0, 0)
    for d in range(2):
        assert torch.equal(a.sim.idx_d[d].cpu(), b.sim.idx_d[d])
    sa, sb = a.state(), b.state()
    assert float((sa.x.cpu() - sb.x).abs().max()) <= 1e-5
    assert float((sa.vx.cpu() - sb.vx).abs().max()) <= 1e-4
    assert float(((sa.rho.cpu() - sb.rho) / sb.rho).abs().max()) <= 1e-5


def test_sharded_planar_bitwise_fused_on_card(cuda, sharded_card):
    """The planar sharded rebin (K6 + 5 x K7, clip and origin) gives the
    fused sharded run bit for bit; the launch counters say which ran."""
    before = (reslot.reslot_cuda.launches, reslot.select_cuda.launches,
              reslot.apply_code_cuda.launches)
    b = _sharded(cuda, planar_rebin=True)
    assert reslot.reslot_cuda.launches == before[0]
    rebins = b.rebin_count - 1
    assert reslot.select_cuda.launches - before[1] == 2 * rebins
    assert reslot.apply_code_cuda.launches - before[2] == 10 * rebins
    a = sharded_card
    for f in dataclasses.fields(a.sim):
        x, y = getattr(a.sim, f.name), getattr(b.sim, f.name)
        if isinstance(x, list) and isinstance(x[0], torch.Tensor):
            assert all(torch.equal(u, v) for u, v in zip(x, y)), f.name
        else:
            assert x == y, f.name


# ---- the sharded very-large-N postures -----------------------------------

def test_forces_integrate_refless_with_disp_lanes(sharded_card):
    """K2 refless with a slab's lane window (the sharded refless trigger's
    launch): its planes bitwise the refless K2's over every lane, its max
    bitwise the max of its own moves in the window (from the old
    positions), and within K2's tolerances of its twin; its own
    counter."""
    sess = sharded_card
    nxl, g = sess.spec.nx_local, sess.spec.local_grid
    for d in range(2):
        s = sess.sim.slab(d)
        xd, yd, vxd, vyd = (s[k].clone() for k in ("xd", "yd", "vxd", "vyd"))
        rho = cuda_solver.density_cuda(xd, yd, PARAMS, g, s["occ"])
        args = (xd, yd, vxd, vyd, rho, None, None, PARAMS, CFG, g, s["occ"])
        lanes = (1, nxl + 1)
        before = cuda_solver.forces_integrate_cuda.launches_refless_lanes
        got = cuda_solver.forces_integrate_cuda(*args, refless=True,
                                                disp_lanes=lanes)
        assert (cuda_solver.forces_integrate_cuda.launches_refless_lanes
                == before + 1)
        full = cuda_solver.forces_integrate_cuda(*args, refless=True)
        for a, b in zip(got[:4], full[:4]):
            assert torch.equal(_bits(a), _bits(b))
        live = (xd < 5e8)[:, :, 1:nxl + 1]
        dx = (got[0] - xd)[:, :, 1:nxl + 1]
        dy = (got[1] - yd)[:, :, 1:nxl + 1]
        want_max = torch.where(live, dx * dx + dy * dy, 0.0).amax()
        assert torch.equal(_bits(got[4]), _bits(want_max))
        twin = cuda_solver.forces_integrate_torch(*args, refless=True,
                                                  disp_lanes=lanes)
        assert float((got[0] - twin[0]).abs().max()) <= 1e-5
        vmax = float(twin[2].abs().max())
        assert float((got[2] - twin[2]).abs().max()) <= 1e-4 * vmax
        assert abs(float(got[4]) - float(twin[4])) <= 1e-4 * float(twin[4])


@pytest.mark.parametrize("posture", ["ceiling", "unfused"])
def test_sharded_postures_on_card_match_cpu_twins(cuda, posture):
    """The D = 2 memory-ceiling posture (generator init, refless trigger,
    planar rebin consuming owned planes, the in-place halo, K1 into the
    dead rho, the segmented driver) and the unfused K1 + K8 step on the
    card against the same runs on the CPU: counters and slots exact,
    particles at the Session gate's tolerances."""
    from bevy_gpu_fluid_tpu_torch.parallel import shard
    from bevy_gpu_fluid_tpu_torch.parallel.mesh import SlabMesh
    from bevy_gpu_fluid_tpu_torch.parallel.sharded_session import \
        ShardedSession
    spec = shard.ShardSpec.build(h=0.045 * 1.5, x_min=-1.0, x_max=2.5,
                                 y_max=3.0, n_devices=2, capacity=4096)
    out = []
    for device in (cuda, "cpu"):
        mesh = SlabMesh([device] * 2)
        if posture == "ceiling":
            lattice = bt.lattice_gen(80, 0.04, device)

            def gen(gi):     # the 80 x 8 block, kicked right across the seam
                x, y, vx, vy = lattice(gi)
                return x - 0.98, y, vx + 4.0, vy
            sess = ShardedSession.from_generator(
                gen, 80 * 8, PARAMS, CFG, spec, mesh, refless_trigger=True,
                planar_rebin=True, segmented=True)
        else:
            state = bt.init_grid(80, 8, 0.04, device)
            state = state.replace(x=state.x - 0.98, vx=torch.full(
                (state.n,), 4.0, device=device))
            sess = ShardedSession(
                state, PARAMS, CFG, spec, mesh, fused=False,
                stencils=cuda_solver.make_stencils(spec.local_grid),
                donate=True)
        sess.run(30, chunk=12)
        out.append(sess)
    a, b = out
    assert a.rebin_count == b.rebin_count >= 2
    assert (a.alive, a.overflow, a.dropped, a.lost) == \
        (b.alive, b.overflow, b.dropped, b.lost) == (a.alive, 0, 0, 0)
    for d in range(2):
        assert torch.equal(a.sim.idx_d[d].cpu(), b.sim.idx_d[d])
    sa, sb = a.state(), b.state()
    assert float((sa.x.cpu() - sb.x).abs().max()) <= 1e-5
    assert float((sa.vx.cpu() - sb.vx).abs().max()) <= 1e-4
    assert float(((sa.rho.cpu() - sb.rho) / sb.rho).abs().max()) <= 1e-5


# ---- the entry and tooling surface on the card ----------------------------

def test_framesink_fed_by_the_pump_from_the_card(cuda, tmp_path):
    """Field frames of a Session on the card, pulled by FramePump into the
    native sink: every file is the frame bit for bit; a CUDA frame pushed
    directly is refused."""
    from bevy_gpu_fluid_tpu_torch.native import FrameSink
    sess = vs.Session(bt.init_grid(24, 24, 0.04, cuda), PARAMS, CFG, GRID,
                      device=cuda)
    pump = FramePump(pull=True)
    frames = []
    img = sess.run_frame(4)
    with FrameSink(str(tmp_path), width=img.shape[1],
                   height=img.shape[0]) as sink:
        with pytest.raises(ValueError, match="FramePump"):
            sink.push(img)
        for i in range(5):
            out = pump.push(img if i == 0 else sess.run_frame(4))
            if out is not None:
                frames.append(out)
                while not sink.push(out):
                    pass
        frames.append(pump.flush())
        while not sink.push(frames[-1]):
            pass
    assert sink.written == 5 and sink.dropped == 0
    for i, f in enumerate(frames):
        data = (tmp_path / f"frame_{i:06d}.ppm").read_bytes()
        assert data.endswith(f.tobytes()) and f.any()


def test_aot_round_trip_bitwise_on_card(cuda, tmp_path):
    """A Session's artifact exported on the card and loaded: bitwise the
    live run (K1 + K2 and K3 through their operators, a rebin inside)."""
    import dataclasses as dc
    from bevy_gpu_fluid_tpu_torch.utils import aot
    state = bt.init_grid(24, 24, 0.04, cuda)
    state = state.replace(vx=torch.full((state.n,), 4.0, device=cuda))
    sess = vs.Session(state, PARAMS, CFG, GRID, device=cuda)
    sim0 = sess.sim
    path = str(tmp_path / "run.bgfexp")
    aot.export_session_run(sess, 12, path)
    k3 = reslot.reslot_cuda.launches
    out = aot.load_exported(path, out_like=sim0)(sim0)
    assert reslot.reslot_cuda.launches - k3 == out.rebin_count - 1 >= 1
    sess.run(12)
    for f in dc.fields(out):
        a, b = getattr(out, f.name), getattr(sess.sim, f.name)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), f.name


def test_interactive_selfdrive_on_card(cuda):
    from bevy_gpu_fluid_tpu_torch.examples import interactive
    app = interactive.InteractiveApp(n=4096, substeps=4, session=True,
                                     device=cuda)
    app._run_one_frame()
    k4 = raster.field_density_cuda.launches
    assert interactive.selfdrive(app, 12) == 0
    assert raster.field_density_cuda.launches - k4 == 12
    assert app.kicks and app.sim.overflow == 0


# ---------------------------------------------------------------------------
# The kernel experiments (models/exp_kernels.py) on the kicked block, on
# the crowded ragged grid and on the grid crowded at both edges
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def edges(cuda):
    """torch_scenes.edges_scene on the card: a row block at kmax = cap,
    live particles in column 1 beside the ghost column whose neighbour the
    first tile's window reaches through the wrap, and a short last tile
    (tests/test_torch_exp.py checks these premises on the CPU)."""
    from torch_scenes import edges_scene
    return edges_scene(cuda)


@pytest.fixture(params=["moving", "crowded", "edges"])
def exp_scene(request):
    """(sim, grid, cfg, rho): the kicked block's planes, the crowded ragged
    grid's or the edges scene's, and K1's density of them."""
    if request.param == "moving":
        s, grid, cfg = request.getfixturevalue("moving_sim"), GRID, CFG
    else:
        s, grid, cfg = request.getfixturevalue(request.param)
    return s, grid, cfg, cuda_solver.density_cuda(s.xd, s.yd, PARAMS, grid,
                                                  s.occ)


def _accel_gate(got, want, xd):
    """K8's gate: 1e-5 of max |a| per slot, dead slots (ghost blocks
    included) bitwise +0."""
    scale = float(torch.maximum(want[0].abs().max(), want[1].abs().max()))
    assert scale > 10.0
    dead = xd >= FAR * 0.5
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * scale
        assert bool((_bits(g[dead]) == 0).all())
        assert torch.equal(_bits(g[dead]), _bits(w[dead]))
    return scale


def test_dbuf_kernel_bitwise_k2(exp_scene):
    s, grid, cfg, rho = exp_scene
    args = (s.xd, s.yd, s.vxd, s.vyd, rho, s.ref_xd, s.ref_yd, PARAMS, cfg,
            grid, s.occ)
    before = ek.forces_integrate_dbuf_cuda.launches
    got = ek.forces_integrate_dbuf_cuda(*args)
    assert ek.forces_integrate_dbuf_cuda.launches == before + 1
    k2 = cuda_solver.forces_integrate_cuda(*args)
    for g, w in zip(got, k2):
        assert torch.equal(_bits(g), _bits(w))
    # T1's twin is K2's, so K2's gate against it is T1's
    _forces_integrate_matches(s, grid, cfg, rho)


def test_dbuf_kernel_persistent_grid(cuda):
    """T1's grid is its blocks per SM x SMs, and the card holds them."""
    plan = ek.dbuf_plan((696, 8, 640))
    occ = ek.plan_occupancy(plan)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert occ["blocks_per_sm"] >= plan.blocks_per_sm
    assert ek.dbuf_grid(8) == plan.blocks_per_sm * sms


@pytest.mark.parametrize("kernel", ["dbuf", "forces_t"])
def test_tma_plan_matches_the_kernel(cuda, kernel):
    """The layout ``exp_kernels`` mirrors is the C side's: its dynamic
    shared memory, at least its blocks per SM on the card, no spill."""
    plan_of = ek.dbuf_plan if kernel == "dbuf" else ek.forces_t_plan
    plan = plan_of((696, 8, 640))
    occ = ek.plan_occupancy(plan)
    assert occ["dynamic_smem"] == plan.smem_bytes
    assert occ["blocks_per_sm"] >= plan.blocks_per_sm
    assert occ["resident_warps"] >= plan.resident_warps
    assert occ["local_bytes"] == 0


def test_density_t_kernel_bitwise_k1(exp_scene):
    s, grid, _, rho = exp_scene
    xt, yt = ek.to_slot_major(s.xd), ek.to_slot_major(s.yd)
    occ_t = ek.block_kmax3_t(xt, grid)
    before = ek.density_t_cuda.launches
    got = ek.density_t_cuda(xt, yt, PARAMS, grid, occ_t)
    assert ek.density_t_cuda.launches == before + 1
    assert torch.equal(_bits(ek.from_slot_major(got)), _bits(rho))
    want = ek.density_t_torch(xt, yt, PARAMS, grid, occ_t)
    assert float(((got - want).abs() / want.abs().clamp_min(1e-30)).max()) \
        <= 1e-5


def test_forces_t_kernel_matches_twin_and_k8(exp_scene):
    s, grid, _, rho = exp_scene
    xt, yt, vxt, vyt, rhot = (ek.to_slot_major(p) for p in
                              (s.xd, s.yd, s.vxd, s.vyd, rho))
    args = (xt, yt, vxt, vyt, rhot, PARAMS, grid, ek.block_kmax3_t(xt, grid))
    before = ek.forces_t_cuda.launches
    got = ek.forces_t_cuda(*args)
    assert ek.forces_t_cuda.launches == before + 1
    _accel_gate(got, ek.forces_t_torch(*args), xt)
    k8 = cuda_solver.forces_cuda(s.xd, s.yd, s.vxd, s.vyd, rho, PARAMS, grid,
                                 s.occ)
    _accel_gate([ek.from_slot_major(a) for a in got], k8, s.xd)


@pytest.mark.parametrize("variant", ek.VARIANTS)
def test_forces_variant_kernel_matches_twin(exp_scene, variant):
    s, grid, _, rho = exp_scene
    args = (s.xd, s.yd, s.vxd, s.vyd, rho, PARAMS, grid, s.occ)
    name = f"launches_{variant}"
    before = getattr(ek.forces_variant_cuda, name)
    got = ek.forces_variant_cuda(*args, variant)
    assert getattr(ek.forces_variant_cuda, name) == before + 1
    _accel_gate(got, ek.forces_variant_torch(*args, variant), s.xd)
    k8 = cuda_solver.forces_cuda(*args)
    if variant == "v0":
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, k8))
    elif variant == "v3":
        v2 = ek.forces_variant_cuda(*args, "v2")
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, v2))
    if variant != "v0nr":
        _accel_gate(got, k8, s.xd)


@pytest.mark.parametrize("kernel", list(ek.WALK_KERNELS))
def test_walk_plan_matches_the_kernel(cuda, kernel):
    """The walk tile ``exp_kernels.walk_plan`` mirrors is the C side's:
    its dynamic shared memory, no spill, blocks per SM up to what its
    shared memory allows (T4: every variant)."""
    plan = ek.walk_plan((696, 8, 640), kernel)
    variants = ([(i,) for i in range(len(ek.VARIANTS))]
                if kernel == "forces_variant" else [()])
    for v in variants:
        occ = _build.occupancy(kernel, 8, *v)
        assert occ["dynamic_smem"] == plan.smem_bytes
        assert occ["local_bytes"] == 0
        assert 1 <= occ["blocks_per_sm"] <= plan.blocks_per_sm


def _walk_kernels_check(s, grid, rho):
    """T2 bitwise K1 (``rho``) after ``movedim``; every T4 variant's dead
    slots +0, v0 bitwise K8, v3 bitwise v2."""
    xt, yt = ek.to_slot_major(s.xd), ek.to_slot_major(s.yd)
    got = ek.density_t_cuda(xt, yt, PARAMS, grid, ek.block_kmax3_t(xt, grid))
    assert torch.equal(_bits(ek.from_slot_major(got)), _bits(rho))
    args = (s.xd, s.yd, s.vxd, s.vyd, rho, PARAMS, grid, s.occ)
    a = {v: ek.forces_variant_cuda(*args, v) for v in ek.VARIANTS}
    dead = s.xd >= FAR * 0.5
    for v in ek.VARIANTS:
        assert all(bool((_bits(g[dead]) == 0).all()) for g in a[v])
    k8 = cuda_solver.forces_cuda(*args)
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(a["v0"], k8))
    assert all(torch.equal(_bits(g), _bits(w))
               for g, w in zip(a["v3"], a["v2"]))


def test_walk_kernels_on_odd_and_full_cells(exp_scene):
    """T2 and T4 where cells hold odd counts (a thread's second slot dead)
    and cells at cap."""
    s, grid, _, rho = exp_scene
    counts = (s.xd < FAR * 0.5).sum(dim=1)
    assert bool((counts % 2 == 1).any()) and bool((counts >= 2).any())
    _walk_kernels_check(s, grid, rho)


def test_walk_kernels_at_an_odd_cap(edges):
    """T2 and T4 at cap 7 (the edges scene's planes cut to their first 7
    slot layers, live prefixes still): an odd number of slot layers, where
    the counts after the window must still start 16-byte aligned, with
    cells at cap."""
    sim, grid, _ = edges
    g7 = dataclasses.replace(grid, cap=7)
    cut = {f: getattr(sim, f)[:, :7].contiguous()
           for f in ("xd", "yd", "vxd", "vyd")}
    occ = reslot.block_kmax3(cut["xd"], g7)
    s7 = dataclasses.replace(sim, occ=occ, **cut)
    assert int((cut["xd"] < FAR * 0.5).sum(dim=1).max()) == 7
    rho = cuda_solver.density_cuda(s7.xd, s7.yd, PARAMS, g7, occ)
    _walk_kernels_check(s7, g7, rho)


@pytest.mark.parametrize("n", [10_000, 100_000])
def test_bench_case_launches_on_card(cuda, n):
    """The port's bench (tools/bench.py) at its --sweep sizes, a short
    window: 10k steps on K5 (one launch a step, K1/K2 never), 100k on K1
    and K2 (one launch each a step, K3 one a rebin, K5 never); the window
    finite and overflow 0."""
    from bevy_gpu_fluid_tpu_torch import tools
    from bevy_gpu_fluid_tpu_torch.tools import bench
    before = tools.launch_counts()
    r = bench.bench_case(n, 20, warmup_steps=40, skin=1.75, device=cuda)
    ran = tools.launches_since(before)
    mono = n == 10_000
    assert ran["mono_step"] == (r["steps_run"] if mono else 0)
    assert ran["density"] == ran["forces_integrate"] == \
        (0 if mono else r["steps_run"])
    assert ran["reslot"] == r["rebins_run"]
    assert ran["forces"] == 0 and r["finite"] and r["overflow"] == 0
