"""The port's CUDA kernels on the card, against their PyTorch twins.

These tests need an NVIDIA Hopper GPU and ``nvcc`` (the kernels are built
for sm_90a on first use); without a GPU they skip.  They import no JAX, so
they run on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: K3 (reslot) bitwise; K1 1e-5 relative on live slots; K2 and
K5 positions 1e-5 absolute, velocities 1e-4 of the plane's max |v|, disp2
1e-4 relative; K5 rho 1e-5 relative on every slot; K4 1e-5 relative on wet
pixels.  The kernels contract multiply-adds into FMAs and use the hardware
rsqrt; the twins round every operation.
"""

import numpy as np
import pytest
import torch

import bevy_gpu_fluid_tpu_torch as bt
from bevy_gpu_fluid_tpu_torch.models import cuda_solver
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs
from bevy_gpu_fluid_tpu_torch.ops import reslot
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


def test_density_kernel_matches_twin(moving_sim):
    s = moving_sim
    got = cuda_solver.density_cuda(s.xd, s.yd, PARAMS, GRID, s.occ)
    want = cuda_solver.density_torch(s.xd, s.yd, PARAMS, GRID, s.occ)
    live = s.xd < 5e8
    rel = ((got - want).abs() / want.abs().clamp_min(1e-30))[live]
    assert float(rel.max()) <= 1e-5
    tb = GRID.row_block
    assert bool((got[:tb] == 0).all() & (got[-tb:] == 0).all())


def test_forces_integrate_kernel_matches_twin(moving_sim):
    s = moving_sim
    rho = cuda_solver.density_cuda(s.xd, s.yd, PARAMS, GRID, s.occ)
    args = (s.xd, s.yd, s.vxd, s.vyd, rho, s.ref_xd, s.ref_yd, PARAMS, CFG,
            GRID, s.occ)
    got = cuda_solver.forces_integrate_cuda(*args)
    want = cuda_solver.forces_integrate_torch(*args)
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max()) <= 1e-5
    vscale = float(torch.maximum(want[2].abs().max(), want[3].abs().max()))
    for g, w in zip(got[2:4], want[2:4]):
        assert float((g - w).abs().max()) <= 1e-4 * vscale
    assert float(want[4]) > 0
    assert abs(float(got[4]) - float(want[4])) <= 1e-4 * float(want[4])


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


@pytest.mark.parametrize("P", [2, 3])
def test_field_kernel_matches_twin(moving_sim, P):
    s = moving_sim
    got = raster.field_density_cuda(s.xd, s.yd, PARAMS, GRID, P)
    want = raster.field_density(s.xd, s.yd, PARAMS, GRID, P)
    assert got.shape == want.shape == (GRID.ny * P, GRID.nx * P)
    wet = want > 0.05 * float(PARAMS.rho_0)
    assert int(wet.sum()) > 100
    assert float(((got - want).abs() / want)[wet].max()) <= 1e-5
    assert float((got - want)[~wet].abs().max()) <= 1e-3


def test_mono_kernel_matches_twin(mono_sim):
    s = mono_sim
    args = (s.xd, s.yd, s.vxd, s.vyd, s.ref_xd, s.ref_yd, PARAMS, CFG,
            MONO_GRID, s.occ)
    got = cuda_solver.mono_step_cuda(*args)
    want = cuda_solver.mono_step_torch(*args)
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max()) <= 1e-5
    vscale = float(torch.maximum(want[2].abs().max(), want[3].abs().max()))
    for g, w in zip(got[2:4], want[2:4]):
        assert float((g - w).abs().max()) <= 1e-4 * vscale
    rho_g, rho_w = got[4], want[4]
    pos = rho_w > 0
    assert bool((rho_g[~pos] == 0).all())
    assert float(((rho_g - rho_w).abs() / rho_w)[pos].max()) <= 1e-5
    assert float(want[5]) > 0
    assert abs(float(got[5]) - float(want[5])) <= 1e-4 * float(want[5])


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
