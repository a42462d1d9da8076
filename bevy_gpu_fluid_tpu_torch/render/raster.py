"""On-device rasterization: particles -> RGB frames (port of
``bevy_gpu_fluid_tpu/render/raster.py``).

Two rasters, as the reference package:

* the per-particle SPLAT (``splat``/``render``): each particle scatter-adds
  a Poly6-weighted S x S pixel stamp at its position, in const (cyan) or
  density colour (the blue -> cyan -> yellow -> red ramp over per-frame
  min/max normalised rho).  Torch scatter-adds (``index_add_``), no kernel;
  good to ~100k particles.  Stamp pixels outside the image are DROPPED,
  negative rows and columns included: the reference's ``mode="drop"``
  scatter first wraps negative indices to the opposite edge (ROADMAP
  queue 3, S5), which the port does not copy.  On the card the float
  atomics of ``index_add_`` make the sums nondeterministic at ulp level
  from run to run, so uint8 frames agree to +-1.
* the density FIELD (``field_density*``/``field_render``/``field_frame``):
  the SPH density sampled at P x P pixel centres per cell straight from
  the dense slot planes, any N.  ``field_density_cuda`` is the wrapper of
  kernel K4 (``csrc/field.cu``), which replaces the TPU kernel
  ``_field_kernel`` / ``field_density_pallas`` (raster.py:220, :279);
  ``field_density`` is its plain PyTorch twin, in the Pallas kernel's form.

Channel math stays planar (one [H, W] plane per colour) and stacks once at
the end, as the reference does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import FluidParams, GridSpec2D
from ..core.state import FluidState
from ..kernels import _build
from ..models.cuda_solver import _density_consts, _row_kmax, density_sum
from ..ops.kernels import w_poly6
from ..ops.reslot import block_kmax3, taps

CYAN = (0.0, 1.0, 1.0)
_f32 = np.float32
_MAX_KERNEL_P = 4   # K4 is compiled for 1..4 subpixels per cell side


@dataclasses.dataclass(frozen=True)
class RasterSpec:
    """Static raster description: world window [x0, x0 + w/scale] x [y0,
    ...] rendered to a height x width image at ``scale`` px/world-unit."""

    x0: float
    y0: float
    scale: float
    height: int
    width: int
    stamp: int = 9  # splat stamp size in px (odd)

    @staticmethod
    def fit(x_min: float, x_max: float, y_min: float, y_max: float,
            width: int = 512, stamp: int = 9) -> "RasterSpec":
        scale = width / (x_max - x_min)
        height = int(round((y_max - y_min) * scale))
        return RasterSpec(x0=x_min, y0=y_min, scale=scale, height=height,
                          width=width, stamp=stamp)


def _colormap_planes(t: torch.Tensor):
    """Blue -> cyan -> yellow -> red ramp over t in [0, 1] as separate (r,
    g, b) planes."""
    t = torch.clamp(t, 0.0, 1.0)
    u1 = t * 2.0
    u2 = (t - 0.5) / 0.25
    u3 = (t - 0.75) / 0.25
    lo, mid = t < 0.5, t < 0.75
    r = torch.where(lo, 0.0, torch.where(mid, u2, 1.0))
    g = torch.where(lo, u1, torch.where(mid, 1.0, 1.0 - u3))
    b = torch.where(lo, 1.0, torch.where(mid, 1.0 - u2, 0.0))
    return r, g, b


def density_color(t: torch.Tensor) -> torch.Tensor:
    """Colormap of t in [0, 1]; t: [...]; returns [..., 3]."""
    return torch.stack(_colormap_planes(t), dim=-1)


def particle_colors(state: FluidState, mode: str = "density"):
    """[N, 3] colours: 'density' normalises rho per frame, 'const' is plain
    cyan."""
    if mode == "const":
        return torch.tensor(CYAN, dtype=torch.float32,
                            device=state.device).expand(state.n, 3)
    lo = state.rho.min()
    hi = state.rho.max()
    inv = torch.where(hi > lo, 1.0 / (hi - lo), 0.0)
    return density_color((state.rho - lo) * inv)


def splat(state: FluidState, params: FluidParams, spec: RasterSpec,
          colors: torch.Tensor) -> torch.Tensor:
    """Rasterize to a float [H, W, 3] image (origin bottom-left): each
    particle deposits W_poly6(r^2)-weighted colour over an S x S stamp, and
    the image is colour-sum / weight-sum per pixel, faded to black where the
    weight is small.  Stamp pixels outside [0, H) x [0, W) are dropped."""
    s = spec.stamp
    H, W = spec.height, spec.width
    x0, y0, scale = float(_f32(spec.x0)), float(_f32(spec.y0)), \
        float(_f32(spec.scale))
    dev = state.device
    x, y = state.x, state.y
    oi = torch.arange(s, dtype=torch.int32, device=dev) - s // 2
    # clamp before the integer conversion: a FAR particle lands far outside
    # the image (and is dropped) instead of overflowing int32
    big = float(1 << 24)
    ci = torch.clamp(torch.floor((x - x0) * scale), -big, big).to(torch.int32)
    cj = torch.clamp(torch.floor((y - y0) * scale), -big, big).to(torch.int32)
    cols = ci[:, None] + oi[None, :]                       # [N, S]
    rows = cj[:, None] + oi[None, :]
    dx = (cols.to(torch.float32) + 0.5) / scale + x0 - x[:, None]
    dy = (rows.to(torch.float32) + 0.5) / scale + y0 - y[:, None]
    r2 = dx[:, :, None] * dx[:, :, None] + dy[:, None, :] * dy[:, None, :]
    w = w_poly6(r2, params.h)                               # [N, Sx, Sy]
    rows_b = rows[:, None, :].expand(r2.shape)
    cols_b = cols[:, :, None].expand(r2.shape)
    keep = (rows_b >= 0) & (rows_b < H) & (cols_b >= 0) & (cols_b < W)
    flat = (rows_b.to(torch.int64) * W + cols_b)[keep]
    wk = w[keep]
    wsum = torch.zeros(H * W, dtype=torch.float32, device=dev)
    wsum.index_add_(0, flat, wk)
    ck = (w[..., None] * colors[:, None, None, :])[keep]
    csum = torch.zeros((H * W, 3), dtype=torch.float32, device=dev)
    csum.index_add_(0, flat, ck)
    img = csum / torch.clamp_min(wsum, 1e-12)[:, None]
    alpha = torch.clamp(wsum / (0.25 * wsum.max() + 1e-12), 0.0, 1.0)
    return (img * alpha[:, None]).reshape(H, W, 3)


def render(state: FluidState, params: FluidParams, spec: RasterSpec,
           mode: str = "density") -> torch.Tensor:
    """Full frame: colours + splat -> float image [H, W, 3] in [0, 1]."""
    return splat(state, params, spec, particle_colors(state, mode))


def _quantize(p: torch.Tensor) -> torch.Tensor:
    """One float plane in [0, 1] -> uint8, flipped so row 0 is the top."""
    return torch.clamp(p * 255.0 + 0.5, 0, 255).to(torch.uint8).flip(0)


def to_rgb8(img: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] float -> uint8, flipped so row 0 is the TOP of the frame
    (world y up)."""
    return _quantize(img)


# ---------------------------------------------------------------------------
# Field raster (K4)
# ---------------------------------------------------------------------------

def _origin(grid: GridSpec2D, origin):
    """World origin of the pixel lattice as float32 scalars."""
    ox, oy = (grid.origin_x, grid.origin_y) if origin is None else origin
    return _f32(ox), _f32(oy)


def _pixel_coords(grid: GridSpec2D, P: int, origin, device):
    """Pixel-centre world coordinates in the Pallas kernel's layout and
    arithmetic (raster.py:249-253), each operation rounded to float32:
    px [1, P^2, nx_pad] = (ox + (lane - 1) * cs) + (sub % P + 0.5) *
    (cs / P), py [ny_pad, P^2, 1] likewise from the real cell row, with
    cs / P taken in double and rounded once."""
    ox, oy = _origin(grid, origin)
    cs = _f32(grid.cell_size)
    csp = _f32(grid.cell_size / P)
    sub = np.arange(P * P)
    lane = np.arange(grid.nx_pad, dtype=np.float32) - _f32(1.0)
    rowc = (np.arange(grid.ny_pad) - grid.row0).astype(np.float32)
    offx = ((sub % P).astype(np.float32) + _f32(0.5)) * csp
    offy = ((sub // P).astype(np.float32) + _f32(0.5)) * csp
    px = (ox + lane * cs)[None, None, :] + offx[None, :, None]
    py = (oy + rowc * cs)[:, None, None] + offy[None, :, None]
    return (torch.from_numpy(px).to(device), torch.from_numpy(py).to(device))


def field_density(xd, yd, params: FluidParams, grid: GridSpec2D,
                  px_per_cell: int = 2, origin=None) -> torch.Tensor:
    """Plain PyTorch twin of kernel K4: the SPH density field at the P x P
    subpixel centres of every real cell, float32 [ny*P, nx*P] in world
    orientation (row 0 = bottom).  Written in the Pallas kernel's form: a
    [ny_pad, P^2, nx_pad] field summed kj outer, then dx, then dy, under the
    per-row-block bound ``block_kmax3(xd)``, then the real window is cut
    and its subpixels interleaved."""
    P = px_per_cell
    h2, coeff = _density_consts(params)
    px, py = _pixel_coords(grid, P, origin, xd.device)
    kmax = _row_kmax(block_kmax3(xd, grid), grid)
    rho = density_sum(px, py, h2, kmax, lambda kj: taps((xd, yd), kj),
                      int(kmax.max())) * float(coeff)
    ny, nx = grid.ny, grid.nx
    real = rho[grid.row0:grid.row0 + ny, :, 1:1 + nx]
    # subpixel s = sy*P + sx  ->  img[y*P + sy, x*P + sx]
    return real.reshape(ny, P, P, nx).permute(0, 1, 3, 2).reshape(
        ny * P, nx * P)


def field_density_cuda(xd, yd, params: FluidParams, grid: GridSpec2D,
                       px_per_cell: int = 2, origin=None) -> torch.Tensor:
    """The density field (kernel K4); same contract as ``field_density``.
    ``origin`` overrides the grid's world origin (a slab's origin, for a
    sharded renderer).  The slot-loop bounds are computed from ``xd``, as
    the reference does.  The kernel takes 1 to 4 subpixels per cell side."""
    dev = _build.check_planes(grid, xd=xd, yd=yd)
    P = px_per_cell
    if dev.type == "cpu":
        return field_density(xd, yd, params, grid, P, origin)
    if not 1 <= P <= _MAX_KERNEL_P:
        raise ValueError(f"px_per_cell={P}: kernel K4 takes 1..{_MAX_KERNEL_P}")
    ox, oy = _origin(grid, origin)
    h2, coeff = _density_consts(params)
    occ = block_kmax3(xd, grid)
    out = torch.empty((grid.ny * P, grid.nx * P), dtype=torch.float32,
                      device=dev)
    _build.launch(
        "bgf_field", dev, xd.data_ptr(), yd.data_ptr(), occ.data_ptr(),
        out.data_ptr(), grid.ny_pad, grid.cap, grid.nx_pad, grid.row_block,
        grid.n_row_blocks, grid.row0, grid.nx, grid.ny, P, float(ox),
        float(oy), float(_f32(grid.cell_size)),
        float(_f32(grid.cell_size / P)), float(h2), float(coeff))
    field_density_cuda.launches += 1
    return out


field_density_cuda.launches = 0


def _field_planes(xd, yd, params: FluidParams, grid: GridSpec2D,
                  px_per_cell: int, mode: str, rho_lo, rho_hi):
    """Planar (r, g, b) float field frame, row 0 = bottom: wet pixels (rho
    above 5% of rho_0) coloured, the rest black."""
    rho = field_density_cuda(xd, yd, params, grid, px_per_cell)
    wet = rho > float(_f32(0.05) * params.rho_0)
    if mode == "const":
        return [torch.where(wet, c, 0.0) for c in CYAN]
    lo = torch.where(wet, rho, torch.inf).min() if rho_lo is None \
        else torch.tensor(rho_lo, dtype=torch.float32, device=rho.device)
    hi = rho.max() if rho_hi is None \
        else torch.tensor(rho_hi, dtype=torch.float32, device=rho.device)
    inv = torch.where(hi > lo, 1.0 / (hi - lo), 0.0)
    return [torch.where(wet, p, 0.0)
            for p in _colormap_planes((rho - lo) * inv)]


def field_render(xd, yd, params: FluidParams, grid: GridSpec2D,
                 px_per_cell: int = 2, mode: str = "density",
                 rho_lo: float | None = None,
                 rho_hi: float | None = None) -> torch.Tensor:
    """Density-field frame: float [ny*P, nx*P, 3] in [0, 1], row 0 =
    bottom.  The colour bounds default to the frame's own min over wet
    pixels and max."""
    return torch.stack(_field_planes(xd, yd, params, grid, px_per_cell, mode,
                                     rho_lo, rho_hi), dim=-1)


def field_frame(xd, yd, params: FluidParams, grid: GridSpec2D,
                px_per_cell: int = 2, mode: str = "density",
                rho_lo: float | None = None,
                rho_hi: float | None = None) -> torch.Tensor:
    """Finished uint8 frame [ny*P, nx*P, 3] (row 0 = TOP) straight from the
    dense slot planes; quantization and the row flip run per plane."""
    planes = _field_planes(xd, yd, params, grid, px_per_cell, mode, rho_lo,
                           rho_hi)
    return torch.stack([_quantize(p) for p in planes], dim=-1)
