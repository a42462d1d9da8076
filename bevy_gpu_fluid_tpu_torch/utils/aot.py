"""Ahead-of-time export of the step for serving (port of
``bevy_gpu_fluid_tpu/utils/aot.py``), over ``torch.export``.

What the reference saves, eager PyTorch does not pay: the JAX package
exports its traced programs because every fresh process would retrace the
step for minutes before its first dispatch.  PyTorch runs eagerly and never
retraces; the port's cold start is the kernel build (``kernels/_build.py``,
seconds, cached by source hash) and the scene's init.  What an artifact
gives here is a step that runs WITHOUT the Python that built it: the
graph, its constants (the physics and the grid) and the posture, in one
file that a worker loads and calls.

What cannot be one exported graph: the step loop reads the rebin trigger
(``disp2``) and the rebin's counters on the host, so n steps with their
rebins are no single graph.  An artifact therefore holds the pieces with
the kernels, each traced through the kernels as ``torch.library``
operators (``kernels/ops.py``: the operator on a CUDA tensor launches the
hand-written kernel, on a CPU tensor runs its twin):

* a Session's artifact: its PURE STEP (K1 + K2, or K5 on small grids; the
  refless trigger's sum) and its RESLOT (K3);
* a ShardedSession's: its slab pure step (the ghost-column halo, K1 and K2
  with the lane window on every slab).  Its collective rebin is NOT
  exported: the capture exchange between slabs, the edge merge and the
  recovery read counters on the host between their kernels.

``load_exported`` returns a callable that drives the loaded pieces with the
port's own trigger and rebin, rebuilt from the parameters the artifact
records, exactly as ``verlet_solver.run_segmented`` drives ``pure_step``,
``need`` and ``rebin``; so a call is bitwise the live Session's run from
the same snapshot, and stateless (the snapshot it is given is not
changed).  Postures whose kernels write in place or consume their inputs
(``donate=True``, ``planar_rebin=True``) and the unfused step (its
stencil pair is no operator) are refused, by name.

The file is a zip: ``meta.json`` (the kind, the step count, the physics,
the grid or slab spec, the posture, the torch version) and one
``torch.export.save`` program per piece (``<piece>.pt2``).
"""

from __future__ import annotations

import dataclasses
import io
import json
import types
import zipfile

import torch

from ..kernels import ops

FORMAT = "bgf-torch-aot/1"
_STEP_IN = ("xd", "yd", "vxd", "vyd", "rho_d", "ref_xd", "ref_yd", "occ",
            "disp2")
_STEP_OUT = ("xd", "yd", "vxd", "vyd", "rho_d", "disp2")
_SPEC = ("n_devices", "nx_local", "global_x0", "capacity", "mig_cap")


class _Fn(torch.nn.Module):
    """A function of tensors as the module ``torch.export`` traces; the
    outputs are always a tuple."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        out = self.fn(*args)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _export(fn, example_args) -> torch.export.ExportedProgram:
    """Trace ``fn`` at the shapes, types and devices of ``example_args``.
    The trace takes fresh tensors of those shapes: aliased examples (a
    sim's reference planes ARE its position planes after a rebin) would
    trace as one input, and the artifact would keep no example values."""
    ep = torch.export.export(_Fn(fn), tuple(torch.empty_like(a)
                                            for a in example_args))
    ep._example_inputs = None
    return ep


def _write(path: str, meta: dict, programs: dict) -> None:
    meta = dict(meta, format=FORMAT, torch=torch.__version__,
                programs=sorted(programs))
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        for name, ep in programs.items():
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            z.writestr(f"{name}.pt2", buf.getvalue())


def _read(path: str):
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("format") != FORMAT:
            raise ValueError(f"{path}: not a {FORMAT} artifact "
                             f"({meta.get('format')!r})")
        programs = {name: torch.export.load(io.BytesIO(
            z.read(f"{name}.pt2"))) for name in meta["programs"]}
    return meta, programs


def exported_bytes(fn, *example_args) -> bytes:
    """Trace ``fn`` (tensors -> a tensor or a tuple of tensors) at
    ``example_args`` and serialize it as an artifact of kind "fn"."""
    buf = io.BytesIO()
    _write(buf, {"kind": "fn"}, {"fn": _export(fn, example_args)})
    return buf.getvalue()


def save_exported(path: str, fn, *example_args) -> None:
    """``exported_bytes`` to a file."""
    with open(path, "wb") as f:
        f.write(exported_bytes(fn, *example_args))


def _refuse(what: str, **postures) -> None:
    why = {"donate": "its kernels write into the planes they are given",
           "planar_rebin": "its rebin consumes the planes it is given, so "
                           "a call would not be stateless",
           "stencils": "the unfused step's stencil pair is no operator"}
    for name, on in postures.items():
        if on:
            raise ValueError(f"{what}: the export does not take "
                             f"{name}=... ({why[name]})")


def export_session_run(sess, n_steps: int, path: str) -> None:
    """Export a ``verlet_solver.Session``'s run of ``n_steps``: its pure
    step and its reslot as graphs, its trigger and rebin as the recorded
    parameters.  A worker restores the resident state
    (``Session.restore`` or ``checkpoint.load_dense``), loads the artifact
    with ``load_exported(path, out_like=sess.sim)`` and calls it with the
    DenseSim: n steps, bitwise the live ``sess.run(n_steps)``."""
    from ..models.verlet_solver import DenseSim, make_step_parts
    fp = sess._fingerprint
    _refuse("export_session_run", donate=sess.donate,
            planar_rebin=sess.planar_rebin,
            stencils=fp["solver"] != "fused-pallas")
    n = sess.n if sess._recovery else None
    grid = sess.grid
    pure, _, _ = make_step_parts(sess.params, sess.cfg, grid, fp["max_age"],
                                 n, refless=sess.refless_trigger,
                                 kernels=ops)
    blank = {f.name: None for f in dataclasses.fields(DenseSim)
             if f.default is dataclasses.MISSING}

    def step(*planes):
        out = pure(DenseSim(**dict(blank, **dict(zip(_STEP_IN, planes)))))
        return tuple(getattr(out, k) for k in _STEP_OUT)

    sim = sess.sim
    programs = {
        "step": _export(step, [getattr(sim, k) for k in _STEP_IN]),
        "reslot": _export(lambda *p: ops.reslot_cuda(*p, grid),
                          [sim.xd, sim.yd, sim.vxd, sim.vyd, sim.idx_d])}
    _write(path, {"kind": "session", "n_steps": n_steps,
                  "params": ops.pack_params(sess.params),
                  "cfg": ops.pack_cfg(sess.cfg), "grid": ops.pack_grid(grid),
                  "max_age": fp["max_age"], "n": n,
                  "refless": sess.refless_trigger}, programs)


def export_sharded_run(sess, n_steps: int, path: str) -> None:
    """Export a ``ShardedSession``'s run of ``n_steps``: its slab pure step
    as one graph over every slab's planes (the halo, K1 and K2 per slab;
    on one card the mesh's shifts are tensor ops of the graph), its trigger
    and collective rebin as the recorded parameters: they read counters on
    the host between kernels, so the rebin stays Python (see the module
    docstring).  Load with ``load_exported(path, out_like=sess.sim)`` and
    call with a ``ShardedDenseSim`` whose slabs lie on the devices of the
    mesh to run on."""
    from ..parallel.shard_verlet import (ShardedDenseSim,
                                         make_sharded_verlet_step)
    fp = sess._fingerprint
    _refuse("export_sharded_run", donate=sess.donate,
            planar_rebin=sess.planar_rebin,
            stencils=fp["solver"] != "fused-pallas")
    spec = sess.spec
    D = spec.n_devices
    n = sess.n if fp["recovery"] else None
    steps = make_sharded_verlet_step(sess.params, sess.cfg, spec, sess.mesh,
                                     n=n, planar=False,
                                     refless=sess.refless_trigger,
                                     kernels=ops)
    blank = {f.name: None for f in dataclasses.fields(ShardedDenseSim)
             if f.default is dataclasses.MISSING}

    def step(*flat):
        lists = {k: list(flat[i * D:(i + 1) * D])
                 for i, k in enumerate(_STEP_IN)}
        out = steps.pure_step(ShardedDenseSim(**dict(blank, **lists)))
        return tuple(t for k in _STEP_OUT for t in getattr(out, k))

    sim = sess.sim
    program = _export(step, [t for k in _STEP_IN for t in getattr(sim, k)])
    _write(path, {"kind": "sharded", "n_steps": n_steps,
                  "params": ops.pack_params(sess.params),
                  "cfg": ops.pack_cfg(sess.cfg),
                  "grid": ops.pack_grid(spec.local_grid),
                  "spec": {k: getattr(spec, k) for k in _SPEC},
                  "n": n, "refless": sess.refless_trigger},
           {"step": program})


def _session_parts(meta: dict, modules: dict):
    """(pure_step, rebin, need) of a Session's artifact: the loaded pure
    step and reslot under the port's trigger and rebin, rebuilt from the
    record."""
    from ..models.verlet_solver import make_step_parts
    step_mod, reslot_mod = modules["step"], modules["reslot"]
    loaded = types.SimpleNamespace(
        reslot_cuda=lambda xd, yd, vxd, vyd, idx_d, grid: reslot_mod(
            xd, yd, vxd, vyd, idx_d))
    _, rebin, need = make_step_parts(
        ops.params_of(meta["params"]), ops.cfg_of(meta["cfg"]),
        ops.grid_of(meta["grid"]), meta["max_age"], meta["n"],
        refless=meta["refless"], kernels=loaded)

    def pure(sim):
        out = step_mod(*(getattr(sim, k) for k in _STEP_IN))
        return dataclasses.replace(sim, **dict(zip(_STEP_OUT, out)),
                                   age=sim.age + 1, step=sim.step + 1)
    return pure, rebin, need


def _sharded_parts(meta: dict, modules: dict, sim):
    """The same over the slabs, on the mesh of ``sim``'s devices."""
    from ..parallel.mesh import SlabMesh
    from ..parallel.shard import ShardSpec
    from ..parallel.shard_verlet import make_sharded_verlet_step
    spec = ShardSpec(local_grid=ops.grid_of(meta["grid"]), **meta["spec"])
    D = spec.n_devices
    mesh = SlabMesh([x.device for x in sim.xd])
    steps = make_sharded_verlet_step(
        ops.params_of(meta["params"]), ops.cfg_of(meta["cfg"]), spec, mesh,
        n=meta["n"], planar=False, refless=meta["refless"])
    step_mod = modules["step"]

    def pure(sim):
        out = step_mod(*(t for k in _STEP_IN for t in getattr(sim, k)))
        lists = {k: list(out[i * D:(i + 1) * D])
                 for i, k in enumerate(_STEP_OUT)}
        return dataclasses.replace(sim, **lists, age=sim.age + 1,
                                   step=sim.step + 1)
    return pure, steps.rebin, steps.need


def load_exported(path: str, out_like=None):
    """Load an artifact into a callable, the kernels' operators registered
    first.  A "fn" artifact's callable takes the exported tensors and
    returns the tuple of outputs.  A Session's or ShardedSession's takes the
    resident sim (``DenseSim`` or ``ShardedDenseSim``) and runs the
    recorded step count: it returns the new sim when ``out_like`` is given
    (any sim of that type: the template), else the tuple of its fields in
    declaration order (the reference's flat leaves).  ``call.meta`` holds
    the record."""
    meta, programs = _read(path)
    modules = {name: ep.module() for name, ep in programs.items()}
    kind = meta["kind"]
    if kind == "fn":
        def call(*args):
            return tuple(modules["fn"](*args))
    elif kind in ("session", "sharded"):
        parts = _session_parts(meta, modules) if kind == "session" else None

        def call(sim):
            pure, rebin, need = parts or _sharded_parts(meta, modules, sim)
            for _ in range(meta["n_steps"]):
                if need(sim):
                    sim = rebin(sim)
                sim = pure(sim)
            if out_like is not None:
                return sim
            return tuple(getattr(sim, f.name)
                         for f in dataclasses.fields(sim))
    else:
        raise ValueError(f"{path}: unknown artifact kind {kind!r}")
    call.meta = meta
    return call
