"""Build and load the hand-written CUDA kernels under ``csrc/``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all of
them started together, to an object for ``sm_90a`` (Hopper), without fast
math; one more ``nvcc`` links the objects into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu   # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o libbgf_kernels.so *.o

The library goes to ``bevy_gpu_fluid_tpu_torch/_build/<source hash>/``, so
an edit to any source builds anew and an unchanged tree reuses the last
build.  It is loaded with ``ctypes``: every pointer and the stream are
``c_void_p``, every size ``c_int``, every physics constant ``c_float``.
T1 and T3 (``csrc/exp_dbuf.cu``, ``csrc/exp_tlayout.cu``) copy by TMA
boxes (``csrc/bgf_tma.cuh``): their entry points encode the tensor maps
with the driver's ``cuTensorMapEncodeTiled``, which they reach through
the runtime's ``cudaGetDriverEntryPoint`` (``...ByVersion`` from CUDA
12.5), so the library still links no ``-lcuda``; a refused map returns
``100000`` + the ``CUresult`` of ``cuTensorMapEncodeTiled``.  T2 and T4
stage their windows in aligned 16-byte chunks and walk their taps two
slots a thread (``csrc/bgf_walk.cuh``).
Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` raises if that is not 0.  The kernel
wrappers share ``check_planes`` (device, dtype, shape and contiguity of
their dense-plane arguments) and ``launch``.

Nothing here runs at import time: the library is built by the first
``load()`` (or an explicit ``build()``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libbgf_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C signature of every entry point (argument order of the csrc functions).
SIGNATURES = {
    # x, y, occ, rho | ny_pad, cap, nx_pad, tb, nb | h2, coeff | stream
    "bgf_density": [_P] * 4 + [_I] * 5 + [_F] * 2 + [_P],
    # x, y, vx, vy, rho, ref_x, ref_y, occ, ox, oy, ovx, ovy, disp
    # | ny_pad, cap, nx_pad, tb, nb, refless, disp_lo, disp_hi
    # | h, m_half, spiky_c, visc_mc, rho0, k, dt, x_min, x_max, bounce,
    #   floor_y | stream
    "bgf_forces_integrate": [_P] * 13 + [_I] * 8 + [_F] * 11 + [_P],
    # x, y, vx, vy, idx, occ, ox, oy, ovx, ovy, oidx, cnt
    # | ny_pad, cap, nx_pad, tb, nb, row0, clip_lo, clip_hi, ny
    # | origin_x, origin_y, inv | stream
    "bgf_reslot": [_P] * 12 + [_I] * 9 + [_F] * 3 + [_P],
    # x, y, occ, out | ny_pad, cap, nx_pad, tb, nb, row0, nx, ny, P
    # | origin_x, origin_y, cell_size, cell_size / P, h2, coeff | stream
    "bgf_field": [_P] * 4 + [_I] * 9 + [_F] * 6 + [_P],
    # x, y, vx, vy, ref_x, ref_y, occ, ox, oy, ovx, ovy, orho, disp
    # | ny_pad, cap, nx_pad, tb, nb
    # | h, h2, coeff, m_half, spiky_c, visc_mc, rho0, k, dt, x_min, x_max,
    #   bounce, floor_y | stream
    "bgf_mono_step": [_P] * 13 + [_I] * 5 + [_F] * 13 + [_P],
    # x, y, vx, vy, rho, occ, ax, ay | ny_pad, cap, nx_pad, tb, nb
    # | h, m_half, spiky_c, visc_mc, rho0, k | stream
    "bgf_forces": [_P] * 8 + [_I] * 5 + [_F] * 6 + [_P],
    # x, y, occ, code, cnt | ny_pad, cap, nx_pad, tb, nb, row0, clip_lo,
    # clip_hi, ny, code_bytes | origin_x, origin_y, inv | stream
    "bgf_select": [_P] * 5 + [_I] * 10 + [_F] * 3 + [_P],
    # payload, code, occ, out | ny_pad, cap, nx_pad, tb, nb, code_bytes,
    # fill_bits | stream
    "bgf_apply_code": [_P] * 4 + [_I] * 7 + [_P],
    # ny_pad, nx_pad, tb | stream: an empty kernel on K5's launch shape
    "bgf_mono_floor": [_I] * 3 + [_P],
    # the kernel experiments (T1-T4): bgf_density's and bgf_forces's
    # arguments on slot-major planes; K8's with a variant (and C1); K2's
    # ref-based ones
    "bgf_density_t": [_P] * 4 + [_I] * 5 + [_F] * 2 + [_P],
    "bgf_forces_t": [_P] * 8 + [_I] * 5 + [_F] * 6 + [_P],
    # x, y, vx, vy, rho, occ, ax, ay | ny_pad, cap, nx_pad, tb, nb, variant
    # | h, m_half, spiky_c, visc_mc, c1, rho0, k | stream
    "bgf_forces_variant": [_P] * 8 + [_I] * 6 + [_F] * 7 + [_P],
    "bgf_forces_integrate_dbuf": [_P] * 13 + [_I] * 5 + [_F] * 11 + [_P],
    # cap, out int32[5] (no stream: a query, not a launch)
    "bgf_density_occupancy": [_I, _P],
    "bgf_forces_integrate_occupancy": [_I, _P],
    "bgf_forces_integrate_refless_occupancy": [_I, _P],
    "bgf_forces_occupancy": [_I, _P],
    "bgf_mono_step_occupancy": [_I, _P],
    "bgf_field_occupancy": [_I, _P],
    "bgf_select_occupancy": [_I, _P],
    "bgf_density_t_occupancy": [_I, _P],
    "bgf_forces_t_occupancy": [_I, _P],
    "bgf_forces_integrate_dbuf_occupancy": [_I, _P],
    # cap, variant, out int32[5]
    "bgf_forces_variant_occupancy": [_I, _I, _P],
    # cap, out int32[1]: the persistent grid T1 launches
    "bgf_forces_integrate_dbuf_grid": [_I, _P],
}


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands as parallel processes; return their joined output,
    or raise with it if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return log


def build() -> tuple[Path, float, str]:
    """Compile the library if this source hash has no build yet: one nvcc
    per source in parallel, then the link.  Returns (library path, build
    seconds (0.0 when reused), compiler log)."""
    out = BUILD_DIR / source_hash() / LIB_NAME
    log_path = out.with_name("build.log")
    if out.exists():
        return out, 0.0, log_path.read_text() if log_path.exists() else ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    cu = sorted(SRC_DIR.glob("*.cu"))
    objs = [out.with_name(f"{p.stem}.{tag}.o") for p in cu]
    tmp = out.with_name(f"{LIB_NAME}.{tag}.tmp")
    t0 = time.perf_counter()
    log = _run_all([[nvcc(), *NVCC_FLAGS, "-I", str(SRC_DIR), "-c", "-o",
                     str(o), str(p)] for p, o in zip(cu, objs)])
    log += _run_all([[nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                      *(str(o) for o in objs)]])
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink()
    log_path.write_text(log)
    os.replace(tmp, out)
    return out, seconds, log


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_planes(grid, occ=None, dtypes=None, shape=None,
                 **planes) -> torch.device:
    """Validate a wrapper's dense planes (contiguous ``grid.plane_shape``,
    or ``shape`` when given, float32 except ``idx_d`` int32 and what
    ``dtypes`` allows per name, all on one CPU or CUDA device) and the
    optional slot-loop bounds ``occ`` (int32 [3, n_row_blocks]).  Returns
    the device; raises ValueError on anything a kernel does not take."""
    dtypes = dtypes or {}
    shape = tuple(grid.plane_shape if shape is None else shape)
    want = {name: (dtypes.get(name, torch.int32 if name == "idx_d"
                              else torch.float32), shape)
            for name in planes}
    if occ is not None:
        planes["occ"] = occ
        want["occ"] = (torch.int32, (3, grid.n_row_blocks))
    dev = next(iter(planes.values())).device
    for name, t in planes.items():
        dtype, shape = want[name]
        ok_dtype = t.dtype in dtype if isinstance(dtype, tuple) \
            else t.dtype == dtype
        if (t.device != dev or not ok_dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: want contiguous {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def occupancy(name: str, cap: int, *args: int) -> dict:
    """What the tiled kernel ``name`` ("density", "forces_integrate",
    "forces_integrate_refless", "forces", "mono_step", "field" (K4's
    halo-tile kernel, P > 4), "select" (int32 codes), or the experiments'
    "density_t", "forces_t", "forces_integrate_dbuf" and "forces_variant"
    (``args``: the variant's number)) takes per block at slot capacity
    ``cap``, from the CUDA runtime: registers per thread, static and
    dynamic shared memory bytes, the blocks per SM they allow and the local
    (spill) bytes per thread."""
    out = (ctypes.c_int * 5)()
    rc = getattr(load(), f"bgf_{name}_occupancy")(cap, *args, out)
    if rc != 0:
        raise RuntimeError(f"bgf_{name}_occupancy: CUDA error {rc}")
    return dict(zip(("registers", "static_smem", "dynamic_smem",
                     "blocks_per_sm", "local_bytes"), out))


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s current stream (passed
    as the last argument); raise on a nonzero CUDA error code."""
    with torch.cuda.device(device):
        rc = getattr(load(), name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
