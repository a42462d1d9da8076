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
    # | ny_pad, cap, nx_pad, tb, nb
    # | h, m_half, spiky_c, visc_mc, rho0, k, dt, x_min, x_max, bounce,
    #   floor_y | stream
    "bgf_forces_integrate": [_P] * 13 + [_I] * 5 + [_F] * 11 + [_P],
    # x, y, vx, vy, idx, occ, ox, oy, ovx, ovy, oidx, cnt
    # | ny_pad, cap, nx_pad, tb, nb, row0, nx, ny | origin_x, origin_y, inv
    # | stream
    "bgf_reslot": [_P] * 12 + [_I] * 8 + [_F] * 3 + [_P],
    # x, y, occ, out | ny_pad, cap, nx_pad, tb, nb, row0, nx, ny, P
    # | origin_x, origin_y, cell_size, cell_size / P, h2, coeff | stream
    "bgf_field": [_P] * 4 + [_I] * 9 + [_F] * 6 + [_P],
    # x, y, vx, vy, ref_x, ref_y, occ, ox, oy, ovx, ovy, orho, disp
    # | ny_pad, cap, nx_pad, tb, nb
    # | h, h2, coeff, m_half, spiky_c, visc_mc, rho0, k, dt, x_min, x_max,
    #   bounce, floor_y | stream
    "bgf_mono_step": [_P] * 13 + [_I] * 5 + [_F] * 13 + [_P],
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


def check_planes(grid, occ=None, **planes) -> torch.device:
    """Validate a wrapper's dense planes (contiguous ``grid.plane_shape``,
    float32 except ``idx_d`` int32, all on one CPU or CUDA device) and the
    optional slot-loop bounds ``occ`` (int32 [3, n_row_blocks]).  Returns
    the device; raises ValueError on anything a kernel does not take."""
    want = {name: (torch.int32 if name == "idx_d" else torch.float32,
                   grid.plane_shape) for name in planes}
    if occ is not None:
        planes["occ"] = occ
        want["occ"] = (torch.int32, (3, grid.n_row_blocks))
    dev = next(iter(planes.values())).device
    for name, t in planes.items():
        dtype, shape = want[name]
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: want contiguous {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s current stream (passed
    as the last argument); raise on a nonzero CUDA error code."""
    with torch.cuda.device(device):
        rc = getattr(load(), name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
