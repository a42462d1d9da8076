"""The premises of the tiled K1 (density), K2 (forces + integrate), K8
(forces alone), K5 (mono step), K4 (field raster) and K6 (select) kernels,
pinned on their PyTorch twins on the CPU (no GPU, no JAX).

The kernels stage a tile of cells in shared memory, read each cell's live
count off its slots and spend no work on what is exactly zero.  That is
right only if:

* the live slots of every cell form a prefix of its cap slots, and every
  dead slot holds FAR in x and y, and ``occ`` bounds every cell — after
  the binning, the fused and the planar rebin, a drop -> suspend ->
  readmit cycle of the recovery, and on the planes a rebin receives (the
  DenseSim at a step where the trigger fires);
* skipping the candidates past a neighbour's count changes no live output
  of any twin by a single bit (their terms are exactly +-0), no field
  pixel, and no select code or count (a slot past its cell's count matches
  no target); a pixel whose 3x3 cells hold no particle is exactly +0;
* a dead slot's density is coeff x (h^6 added n times), n the FAR
  candidates among its 3x3 cells below the slot bound (the row block's for
  K1, K5's kmax_d for K5), so the kernel can write it from the counts
  alone;
* a dead slot's K8 accelerations are exactly +0, and K5 leaves a dead
  slot's x and y as they were with velocity +0.

The scenes are small (``torch_scenes.tile_scenes``, shared with
tests/test_torch_exp.py): the kicked 24 x 24 block of
tests/test_torch_cuda.py (on the 12-row-block grid, and on a 7-row-block
grid where the Session steps on K5) and the recovery scene of
tests/test_torch_session.py (9 particles in one cell at cap 8), each of
the two also stepped on to where the rebin trigger fires.  Every comparison is exact, on the float
bits (``.view(torch.int32)``, which tells -0 from +0).
"""

import numpy as np
import pytest
import torch

from bevy_gpu_fluid_tpu_torch.models import cuda_solver
from bevy_gpu_fluid_tpu_torch.ops import reslot
from bevy_gpu_fluid_tpu_torch.ops.binning import FAR
from bevy_gpu_fluid_tpu_torch.ops.reslot import block_kmax3, row_kmax, taps
from bevy_gpu_fluid_tpu_torch.render import raster
from torch_scenes import PARAMS, TILE_SCENES as SCENES, tile_scenes

torch.set_num_threads(1)

@pytest.fixture(scope="module")
def scenes():
    """name -> (DenseSim, grid, cfg): the planes each premise is held on."""
    return tile_scenes()


def _live(sim):
    return sim.xd < FAR * 0.5


def _occ(sim, grid):
    """The slot bounds the kernels get (the sim's own after a rebin)."""
    return block_kmax3(sim.xd, grid)


@pytest.mark.parametrize("name", SCENES)
def test_live_slots_are_a_prefix_and_dead_slots_far(scenes, name):
    sim, _, _ = scenes[name]
    live = _live(sim)
    assert int(live.sum()) > 0
    # slot k live => slot k - 1 live, in every cell
    assert not bool((live[:, 1:] & ~live[:, :-1]).any())
    assert bool((sim.xd[~live] == FAR).all() & (sim.yd[~live] == FAR).all())
    assert torch.equal(sim.occ, _occ(sim, scenes[name][1]))
    # occ bounds every cell of the three rows each row block reads
    grid = scenes[name][1]
    kmax = row_kmax(sim.occ, grid)[:, 0]                  # [ny_pad, 1]
    count = live.sum(dim=1)                               # [ny_pad, nx_pad]
    tb = grid.row_block
    for dy in (-1, 0, 1):
        nb = torch.roll(count, -dy, 0)
        assert bool((nb[tb:-tb] <= kmax[tb:-tb]).all())


def _masked_density(xd, yd, grid, occ):
    """The K1 twin with the FAR candidates skipped, not added as +0."""
    h2, coeff = cuda_solver._density_consts(PARAMS)
    kmax = row_kmax(occ, grid)
    rho = torch.zeros_like(xd)
    live = (xd < FAR * 0.5).float()
    for kj in range(int(kmax.max())):
        for rx, ry, rl in taps((xd, yd, live), kj):
            ddx = xd - rx
            ddy = yd - ry
            d = torch.clamp_min(float(h2) - (ddx * ddx + ddy * ddy), 0.0)
            rho = torch.where((kj < kmax) & (rl > 0), rho + d * d * d, rho)
    return rho * float(coeff)


def _masked_forces(xd, yd, vxd, vyd, rho_d, grid, occ):
    """The K2 twin's accelerations with the FAR candidates skipped."""
    c = cuda_solver._forces_consts(PARAMS)
    h, m_half, spiky_c, visc_mc = (float(c[k]) for k in
                                   ("h", "m_half", "spiky_c", "visc_mc"))
    p, ir = cuda_solver._eos(rho_d, PARAMS)
    kmax = row_kmax(occ, grid)
    live = (xd < FAR * 0.5).float()
    ax = torch.zeros_like(xd)
    ay = torch.zeros_like(xd)
    for kj in range(int(kmax.max())):
        for rx, ry, rvx, rvy, rp, ri, rl in taps(
                (xd, yd, vxd, vyd, p, ir, live), kj):
            on = (kj < kmax) & (rl > 0)
            ddx = xd - rx
            ddy = yd - ry
            r2 = ddx * ddx + ddy * ddy
            inv_r = torch.rsqrt(r2 + float(cuda_solver.EPS2))
            hr = torch.clamp_min(h - r2 * inv_r, 0.0)
            fac_p = m_half * (p + rp) * ri * (spiky_c * hr * hr * inv_r)
            fac_v = visc_mc * ri * hr
            ax = torch.where(on, ax + (fac_p * ddx + fac_v * (rvx - vxd)), ax)
            ay = torch.where(on, ay + (fac_p * ddy + fac_v * (rvy - vyd)), ay)
    return ax, ay


@pytest.mark.parametrize("name", SCENES)
def test_density_twin_unchanged_without_far_candidates(scenes, name):
    sim, grid, _ = scenes[name]
    occ = _occ(sim, grid)
    want = cuda_solver.density_torch(sim.xd, sim.yd, PARAMS, grid, occ)
    got = _masked_density(sim.xd, sim.yd, grid, occ)
    live = _live(sim)
    assert float(want[live].min()) > 0
    assert torch.equal(got[live], want[live])


@pytest.mark.parametrize("name", SCENES)
def test_forces_integrate_twin_unchanged_without_far_candidates(scenes, name):
    sim, grid, cfg = scenes[name]
    occ = _occ(sim, grid)
    rho = cuda_solver.density_torch(sim.xd, sim.yd, PARAMS, grid, occ)
    want = cuda_solver.forces_integrate_torch(
        sim.xd, sim.yd, sim.vxd, sim.vyd, rho, sim.ref_xd, sim.ref_yd,
        PARAMS, cfg, grid, occ)
    ax, ay = _masked_forces(sim.xd, sim.yd, sim.vxd, sim.vyd, rho, grid, occ)
    got = cuda_solver.integrate(sim.xd, sim.yd, sim.vxd, sim.vyd, ax, ay,
                                sim.ref_xd, sim.ref_yd, cfg)
    tb = grid.row_block
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g[tb:-tb], w[tb:-tb])      # the twin's ghost fills
    assert torch.equal(got[4], want[4])
    assert float(ax.abs().max()) > 10.0
    # a dead slot's outputs: x, y as they were, zero velocity
    dead = ~_live(sim)
    assert torch.equal(want[0][dead], sim.xd[dead])
    assert torch.equal(want[1][dead], sim.yd[dead])
    assert bool((want[2][dead] == 0).all() & (want[3][dead] == 0).all())


def _added(h6: np.float32, n_max: int) -> np.ndarray:
    """table[n] = h6 added n times in float32, left to right, from +0."""
    table = np.zeros(n_max + 1, dtype=np.float32)
    for n in range(1, n_max + 1):
        table[n] = table[n - 1] + h6
    return table


@pytest.mark.parametrize("name", SCENES)
def test_density_twin_dead_slots_from_counts(scenes, name):
    sim, grid, _ = scenes[name]
    occ = _occ(sim, grid)
    rho = cuda_solver.density_torch(sim.xd, sim.yd, PARAMS, grid, occ)
    h2, coeff = cuda_solver._density_consts(PARAMS)
    kmax = row_kmax(occ, grid)[:, 0]                      # [ny_pad, 1]
    count = _live(sim).sum(dim=1)                         # [ny_pad, nx_pad]
    n = torch.zeros_like(count)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            nb = torch.roll(count, (-dy, -dx), (0, 1))
            n += kmax - torch.minimum(nb, kmax)
    table = torch.from_numpy(_added(np.float32(h2) * np.float32(h2)
                                    * np.float32(h2), 9 * grid.cap))
    want = table[n] * np.float32(coeff)
    dead = ~_live(sim)
    got = rho.masked_fill(~dead, 0.0)
    expect = want[:, None, :].expand_as(rho).masked_fill(~dead, 0.0)
    assert torch.equal(got, expect)
    assert float(rho[dead].max()) > 0            # FAR candidates were there


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("name", SCENES)
def test_forces_twin_unchanged_without_far_candidates(scenes, name):
    sim, grid, _ = scenes[name]
    occ = _occ(sim, grid)
    rho = cuda_solver.density_torch(sim.xd, sim.yd, PARAMS, grid, occ)
    want = cuda_solver.forces_torch(sim.xd, sim.yd, sim.vxd, sim.vyd, rho,
                                    PARAMS, grid, occ)
    got = _masked_forces(sim.xd, sim.yd, sim.vxd, sim.vyd, rho, grid, occ)
    live = _live(sim)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g[live]), _bits(w[live]))
    assert float(want[0][live].abs().max()) > 10.0


@pytest.mark.parametrize("name", SCENES)
def test_forces_twin_dead_slots_exactly_plus_zero(scenes, name):
    """K8 writes +0 to dead slots and ghost blocks without their taps."""
    sim, grid, _ = scenes[name]
    occ = _occ(sim, grid)
    rho = cuda_solver.density_torch(sim.xd, sim.yd, PARAMS, grid, occ)
    ax, ay = cuda_solver.forces_torch(sim.xd, sim.yd, sim.vxd, sim.vyd, rho,
                                      PARAMS, grid, occ)
    dead = ~_live(sim)
    assert bool((sim.vxd[dead] == 0).all() & (sim.vyd[dead] == 0).all())
    for a in (ax, ay):
        assert bool((_bits(a[dead]) == 0).all())


def _mono(sim, grid, cfg):
    return cuda_solver.mono_step_torch(sim.xd, sim.yd, sim.vxd, sim.vyd,
                                       sim.ref_xd, sim.ref_yd, PARAMS, cfg,
                                       grid, _occ(sim, grid))


@pytest.mark.parametrize("name", SCENES)
def test_mono_twin_unchanged_without_far_candidates(scenes, name):
    """K5's live outputs are the FAR-masked density -> forces -> integrate
    chain bit for bit; its dead slots keep x, y and get velocity +0."""
    sim, grid, cfg = scenes[name]
    occ = _occ(sim, grid)
    want = _mono(sim, grid, cfg)
    rho = _masked_density(sim.xd, sim.yd, grid, occ)
    ax, ay = _masked_forces(sim.xd, sim.yd, sim.vxd, sim.vyd, rho, grid, occ)
    got = cuda_solver.integrate(sim.xd, sim.yd, sim.vxd, sim.vyd, ax, ay,
                                sim.ref_xd, sim.ref_yd, cfg)
    live = _live(sim)
    for g, w in zip((*got[:4], rho), want[:5]):
        assert torch.equal(_bits(g[live]), _bits(w[live]))
    assert torch.equal(_bits(got[4]), _bits(want[5]))
    assert float(want[5]) > 0
    dead = ~live
    assert torch.equal(_bits(want[0][dead]), _bits(sim.xd[dead]))
    assert torch.equal(_bits(want[1][dead]), _bits(sim.yd[dead]))
    for v in want[2:4]:
        assert bool((_bits(v[dead]) == 0).all())


@pytest.mark.parametrize("name", SCENES)
def test_mono_twin_dead_rho_from_counts(scenes, name):
    """A dead slot's K5 rho is coeff x (h^6 added n times), n = the sum
    over its 3x3 cells of kmax_d - the cell's live count; 0 on the ghost
    blocks."""
    sim, grid, cfg = scenes[name]
    rho = _mono(sim, grid, cfg)[4]
    h2, coeff = cuda_solver._density_consts(PARAMS)
    tb, nb = grid.row_block, grid.n_row_blocks
    kmax_d = cuda_solver.mono_bounds(_occ(sim, grid), grid)[0]
    kd = torch.zeros(grid.ny_pad, dtype=torch.int64)
    kd[tb:tb + nb * tb] = kmax_d.repeat_interleave(tb)
    kd = kd[:, None]                                      # [ny_pad, 1]
    count = _live(sim).sum(dim=1)                         # [ny_pad, nx_pad]
    n = torch.zeros_like(count)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            nb_count = torch.roll(count, (-dy, -dx), (0, 1))
            assert bool((nb_count[tb:-tb] <= kd[tb:-tb]).all())
            n += kd - nb_count
    table = torch.from_numpy(_added(np.float32(h2) * np.float32(h2)
                                    * np.float32(h2), 9 * grid.cap))
    want = table[n[tb:-tb]] * np.float32(coeff)
    dead = ~_live(sim)[tb:-tb]
    got = rho[tb:-tb].masked_fill(~dead, 0.0)
    expect = want[:, None, :].expand_as(got).masked_fill(~dead, 0.0)
    assert torch.equal(_bits(got), _bits(expect))
    assert float(rho[tb:-tb][dead].max()) > 0
    assert bool((_bits(rho[:tb]) == 0).all() & (_bits(rho[-tb:]) == 0).all())


def _bounded_counts(sim, grid, occ):
    """Each cell's live count below its row's slot bound (the tile kernels'
    staged count: the live prefix under kmax), int64 [ny_pad, nx_pad]."""
    live = _live(sim).to(torch.int64)
    prefix = torch.cumprod(live, dim=1).sum(dim=1)
    return torch.minimum(prefix, row_kmax(occ, grid)[:, 0])


def _largest_of_nine(count):
    """Per cell, the largest count of its 3x3 cells (columns wrap, as the
    taps do)."""
    out = torch.zeros_like(count)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            out = torch.maximum(out, torch.roll(count, (-dy, -dx), (0, 1)))
    return out


@pytest.mark.parametrize("code_dtype", [torch.int32, torch.int8])
@pytest.mark.parametrize("name", SCENES)
def test_select_twin_unchanged_at_each_targets_largest_count(scenes, name,
                                                             code_dtype):
    """K6's tiled scan: each target stops at the largest count of its 9
    cells and compares the candidates' clipped cells with its own; the
    codes and counts are select_torch's (the sim's own occ, as the planar
    rebin passes it)."""
    sim, grid, _ = scenes[name]
    occ = sim.occ
    want_code, want_cnt = reslot.select_torch(sim.xd, sim.yd, grid, occ,
                                              code_dtype)
    tgt_cx, tgt_cy, kiota = reslot._targets(grid, sim.xd.device)
    ccx, ccy = reslot._cell_of(sim.xd, sim.yd, grid, _live(sim))
    stop = _largest_of_nine(_bounded_counts(sim, grid, occ))[:, None, :]
    code = torch.full(sim.xd.shape, -1, dtype=torch.int32)
    cnt = torch.zeros_like(stop)
    for kj in range(int(stop.max())):
        views = taps((ccx, ccy), kj)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                cx, cy = next(views)
                match = (cx == tgt_cx) & (cy == tgt_cy) & (kj < stop)
                code = torch.where(match & (cnt == kiota),
                                   reslot.code_of(kj, dx, dy), code)
                cnt = cnt + match
    assert torch.equal(code.to(code_dtype), want_code)
    assert torch.equal(cnt[:, 0, :].to(torch.int32), want_cnt)
    assert 0 < int(want_cnt.sum()) <= int(_live(sim).sum())


def _masked_field(sim, grid, P):
    """The K4 twin with the FAR candidates skipped, not added as +0."""
    h2, coeff = cuda_solver._density_consts(PARAMS)
    px, py = raster._pixel_coords(grid, P, None, sim.xd.device)
    kmax = row_kmax(block_kmax3(sim.xd, grid), grid)
    live = _live(sim).float()
    rho = torch.zeros(torch.broadcast_shapes(px.shape, py.shape))
    for kj in range(int(kmax.max())):
        for rx, ry, rl in taps((sim.xd, sim.yd, live), kj):
            ddx = px - rx
            ddy = py - ry
            d = torch.clamp_min(float(h2) - (ddx * ddx + ddy * ddy), 0.0)
            rho = torch.where((kj < kmax) & (rl > 0), rho + d * d * d, rho)
    real = (rho * float(coeff))[grid.row0:grid.row0 + grid.ny, :,
                                1:1 + grid.nx]
    return real.reshape(grid.ny, P, P, grid.nx).permute(0, 1, 3, 2).reshape(
        grid.ny * P, grid.nx * P)


@pytest.mark.parametrize("P", [2, 5])
@pytest.mark.parametrize("name", SCENES)
def test_field_twin_unchanged_without_far_taps(scenes, name, P):
    """K4's tiled pixels: the FAR taps skipped give the twin's field bit
    for bit, and every pixel of a cell whose 3x3 cells hold no particle
    is exactly +0 (the kernel writes it with no taps)."""
    sim, grid, _ = scenes[name]
    want = raster.field_density(sim.xd, sim.yd, PARAMS, grid, P)
    got = _masked_field(sim, grid, P)
    assert torch.equal(_bits(got), _bits(want))
    near = torch.zeros(grid.ny_pad, grid.nx_pad, dtype=torch.int64)
    count = _live(sim).sum(dim=1)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            near += torch.roll(count, (-dy, -dx), (0, 1))
    empty = (near[grid.row0:grid.row0 + grid.ny, 1:1 + grid.nx] == 0)
    empty = empty.repeat_interleave(P, 0).repeat_interleave(P, 1)
    assert bool(empty.any()) and not bool(empty.all())
    assert bool((_bits(want[empty]) == 0).all())
    assert float(want[~empty].max()) > 0
