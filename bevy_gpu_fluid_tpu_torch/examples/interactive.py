"""Live interactive demo: a dam break you drag, served over HTTP (port of
``examples/interactive.py``).

The frame loop steps and rasterizes on the card; finished frames stream to
a browser as PNG over plain HTTP (standard library only), and pointer drags
come back as world-space impulses applied between frames.  Space toggles
the colour view.

    python -m bevy_gpu_fluid_tpu_torch.examples.interactive --n 5041 --port 8787
    # open http://localhost:8787: drag to push the fluid, Space to toggle
    python -m bevy_gpu_fluid_tpu_torch.examples.interactive --session --n 1000000
    python -m bevy_gpu_fluid_tpu_torch.examples.interactive --sharded 2 --cpu

The HTTP surface: ``GET /`` (the page), ``GET /frame.png`` (the latest
finished frame), ``GET /stats`` (JSON), ``POST /impulse`` ({px, py, dx,
dy} in canvas pixels) and ``POST /toggle``.  The frame loop never waits on
a client: requests read the latest finished frame under a lock, and its
PNG is encoded once, on the first request that wants it, outside the
frame loop's lock.

Headless check (no browser): ``--selfdrive 40`` injects a scripted drag
along the same screen-coordinate path a browser would POST, and exits
nonzero if the fluid failed to respond.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import torch

PAGE = """<!doctype html>
<html><head><title>bevy_gpu_fluid_tpu_torch</title><style>
 body { background: #111; color: #ccc; font: 13px monospace; margin: 1em; }
 canvas { border: 1px solid #444; image-rendering: pixelated; cursor: crosshair; }
</style></head><body>
<div>drag = impulse &nbsp; | &nbsp; Space = view toggle &nbsp; | &nbsp;
 <span id="s">connecting...</span></div>
<canvas id="c"></canvas>
<script>
const c = document.getElementById('c'), ctx = c.getContext('2d');
let last = null, drag = false;
function post(path, body) {
  fetch(path, {method: 'POST', body: JSON.stringify(body || {})});
}
c.addEventListener('pointerdown', e => { drag = true; last = [e.offsetX, e.offsetY]; });
window.addEventListener('pointerup', () => { drag = false; last = null; });
c.addEventListener('pointermove', e => {
  if (!drag || !last) return;
  const dx = e.offsetX - last[0], dy = e.offsetY - last[1];
  if (dx === 0 && dy === 0) return;
  post('/impulse', {px: e.offsetX, py: e.offsetY, dx: dx, dy: dy});
  last = [e.offsetX, e.offsetY];
});
window.addEventListener('keydown', e => {
  if (e.code === 'Space') { e.preventDefault(); post('/toggle'); }
});
async function loop() {
  try {
    const r = await fetch('/frame.png?' + Date.now());
    const blob = await r.blob();
    const img = await createImageBitmap(blob);
    c.width = img.width; c.height = img.height;
    ctx.drawImage(img, 0, 0);
    const st = await (await fetch('/stats')).json();
    document.getElementById('s').textContent =
      st.n + ' particles | step ' + st.step + ' | ' + st.fps.toFixed(1) +
      ' FPS | view: ' + st.mode + ' | overflow: ' + st.overflow;
  } catch (e) {}
  requestAnimationFrame(loop);
}
loop();
</script></body></html>"""


@dataclasses.dataclass(frozen=True)
class RasterSpec:
    """Screen geometry of a frame: world origin + scale (the fields of
    ``render.raster.RasterSpec`` the pointer mapping needs)."""
    x0: float
    y0: float
    scale: float
    height: int
    width: int


def _scene(n: int, device):
    """The large-N scene: a sqrt(n)-square block at spacing 0.04 in a box
    one unit wider than it each side; (state, params, cfg, extent)."""
    import bevy_gpu_fluid_tpu_torch as bt
    side = int(math.isqrt(n))
    extent = side * 0.04
    return (bt.init_grid(side, side, 0.04, device), bt.FluidParams.demo(),
            bt.IntegrateConfig.create(x_min=-1.0, x_max=extent + 1.0), extent)


class _SessionSim:
    """The Simulation surface the app uses, over a resident
    ``verlet_solver.Session``: for large scenes (100k-16M particles) the
    dense state stays on the device, frames come from the field raster
    (K4), drag impulses apply to the dense planes.  The frame is (ny*P) x
    (nx*P) px aligned to the binning grid."""

    def __init__(self, n: int, px_per_cell: int = 2, device="cuda"):
        from bevy_gpu_fluid_tpu_torch.models import verlet_solver
        state, params, self.cfg, extent = _scene(n, device)
        grid = verlet_solver.default_grid(0.045, -1.0, extent + 1.0,
                                          y_max=extent * 1.1 + 1.0, cap=8)
        self._sess = verlet_solver.Session(state, params, self.cfg, grid,
                                           device=device)
        self._ppc = px_per_cell
        P, g = px_per_cell, grid
        self.spec = RasterSpec(x0=g.origin_x, y0=g.origin_y,
                               scale=P / g.cell_size, height=g.ny * P,
                               width=g.nx * P)

    @property
    def session(self):
        return self._sess

    @property
    def state(self):
        # stats only (n, step): never materializes the particle state
        return SimpleNamespace(n=self._sess.n, step=self._sess.sim.step)

    def particle_state(self):
        return self._sess.state()

    def max_abs_vx(self):
        return self._sess.sim.vxd.abs().amax()

    @property
    def overflow(self):
        return self._sess.overflow

    def kick(self, x, y, ux, uy):
        self._sess.kick(x, y, ux, uy)

    def run_frame(self, substeps, mode):
        return self._sess.run_frame(substeps, px_per_cell=self._ppc,
                                    mode="const" if mode == "const"
                                    else "density")


class _ShardedSim:
    """The same surface over a ``ShardedSession``: D x-slabs (all on the
    card, or D CPU entries), frames joined from per-slab raster strips,
    drag impulses on every slab."""

    def __init__(self, n: int, devices: int, px_per_cell: int = 2,
                 device="cuda"):
        from bevy_gpu_fluid_tpu_torch.parallel import shard
        from bevy_gpu_fluid_tpu_torch.parallel.mesh import SlabMesh
        from bevy_gpu_fluid_tpu_torch.parallel.sharded_session import \
            ShardedSession
        state, params, self.cfg, extent = _scene(n, device)
        sspec = shard.ShardSpec.build(h=0.045 * 1.5, x_min=-1.0,
                                      x_max=extent + 1.0,
                                      y_max=extent * 1.1 + 1.0,
                                      n_devices=devices,
                                      capacity=max(1024, state.n))
        mesh = (SlabMesh(["cpu"] * devices) if str(device) == "cpu"
                else SlabMesh(n=devices))
        self._sess = ShardedSession(state, params, self.cfg, sspec, mesh)
        self._ppc = px_per_cell
        P, g = px_per_cell, sspec.local_grid
        self.spec = RasterSpec(x0=sspec.global_x0, y0=g.origin_y,
                               scale=P / g.cell_size, height=g.ny * P,
                               width=devices * sspec.nx_local * P)

    @property
    def session(self):
        return self._sess

    @property
    def state(self):
        return SimpleNamespace(n=self._sess.n, step=self._sess.sim.step)

    def particle_state(self):
        return self._sess.state()

    def max_abs_vx(self):
        vxd = self._sess.sim.vxd
        return torch.stack([v.abs().amax().to(vxd[0].device)
                            for v in vxd]).amax()

    @property
    def overflow(self):
        return self._sess.overflow

    def kick(self, x, y, ux, uy):
        self._sess.kick(x, y, ux, uy)

    def run_frame(self, substeps, mode):
        return self._sess.run_frame(substeps, px_per_cell=self._ppc,
                                    mode="const" if mode == "const"
                                    else "density")


def _max_abs_vx(sim):
    """Largest |vx| of the engine's particles, a 0-dim tensor on its
    device."""
    if hasattr(sim, "max_abs_vx"):
        return sim.max_abs_vx()
    return sim.state.vx.abs().amax()


def _to_host(t):
    """``t`` copied to the host behind the work queued so far, without
    waiting for it (a pinned buffer; read it once an event recorded later
    has completed).  CPU tensors as they are."""
    if not t.is_cuda:
        return t
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return buf.copy_(t, non_blocking=True)


class InteractiveApp:
    """Frame loop + frame buffer + input queue, UI-agnostic.

    The HTTP layer (or a test, or the self-drive script) talks to this
    object only through ``latest_png``/``latest_frame``/``pointer_drag``/
    ``toggle_view``/``stats``: the surface a native window would use.
    ``device`` is the card unless the caller asks for ``"cpu"``.

    Each impulse is stamped when it arrives.  The frame whose dispatch
    applied it takes max |vx| before the kick and after its substeps on
    the device, copied to the host behind the frame (no sync), and once
    that frame is published the record lands in ``kicks``: the latency
    from the first impulse's arrival to the publish, and both speeds."""

    def __init__(self, n: int = 5041, substeps: int = 16,
                 raster_width: int = 512, solver: str = "verlet",
                 session: bool = False, sharded: int = 0, device="cuda"):
        from bevy_gpu_fluid_tpu_torch import Simulation
        from bevy_gpu_fluid_tpu_torch.render.pump import FramePump

        if sharded:
            self.sim = _ShardedSim(n, devices=sharded, device=device)
        elif session:
            self.sim = _SessionSim(n, device=device)
        else:
            self.sim = Simulation.dam_break(n=n, solver=solver,
                                            raster_width=raster_width,
                                            device=device)
        self.substeps = substeps
        st = self.sim.state         # here, before any frame loop runs
        self.n, self.step = int(st.n), int(st.step)   # step: dispatched
        self.mode = "density"       # the reference's default DensityColor
        self._impulses: list[tuple] = []
        self._lock = threading.Lock()       # frame, png, impulse queue
        self._png_lock = threading.Lock()   # one encode at a time
        self._frame: np.ndarray | None = None
        self._png: bytes | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._inflight_kick: dict | None = None
        self.kicks: collections.deque = collections.deque(maxlen=1024)
        self.encode_s = 0.0                 # the last PNG encode
        self.fps = 0.0
        self.frames = 0
        self._pump = FramePump(pull=True)

    # ---- input (screen space, as a browser or window delivers it) -------
    def pointer_drag(self, px: float, py: float, dx: float, dy: float):
        """Pointer moved (dx, dy) canvas px while pressed at (px, py).
        Converts to world coordinates (canvas row 0 = top) and queues an
        impulse with the reference's semantics: vel += IMPULSE * the
        normalized drag direction within r^2 < INTERACTION_AREA."""
        spec = self.sim.spec
        wx = spec.x0 + px / spec.scale
        wy = spec.y0 + (spec.height - py) / spec.scale
        norm = math.hypot(dx, dy)
        if norm == 0.0:
            return
        with self._lock:
            self._impulses.append((wx, wy, dx / norm, -dy / norm,
                                   time.perf_counter()))

    def toggle_view(self):
        """Space key: const <-> density colour."""
        self.mode = "const" if self.mode == "density" else "density"

    # ---- output -----------------------------------------------------------
    def latest_frame(self) -> np.ndarray | None:
        with self._lock:
            return self._frame

    def latest_png(self) -> bytes | None:
        """PNG bytes of the latest frame, encoded on the first request for
        that frame (``render.png``) outside the frame lock."""
        from bevy_gpu_fluid_tpu_torch.render.png import encode_png
        with self._png_lock:
            with self._lock:
                frame, png = self._frame, self._png
            if frame is None or png is not None:
                return png
            t0 = time.perf_counter()
            png = encode_png(frame)
            self.encode_s = time.perf_counter() - t0
            with self._lock:
                if self._frame is frame:
                    self._png = png
            return png

    def stats(self) -> dict:
        """Counters the frame loop keeps (no read of the engine's state
        from a request thread)."""
        last = self.kicks[-1] if self.kicks else None
        return {"n": self.n, "step": self.step,
                "fps": self.fps, "frames": self.frames, "mode": self.mode,
                "overflow": self.sim.overflow,
                "impulse_ms": None if last is None
                else last["latency_s"] * 1e3}

    # ---- loop ---------------------------------------------------------------
    def _run_one_frame(self):
        # pipelined: publish frame k-1 while frame k's dispatch and copy are
        # in flight (render.pump.FramePump): one frame of latency
        with self._lock:
            pending, self._impulses = self._impulses, []
        kick = None
        if pending:
            before = _max_abs_vx(self.sim)
            for wx, wy, ux, uy, _ in pending:
                self.sim.kick(wx, wy, ux, uy)
            kick = {"t_first": min(p[4] for p in pending),
                    "impulses": len(pending), "before": before}
        frame = self.sim.run_frame(self.substeps, self.mode)
        self.step += self.substeps
        if kick is not None:    # copied before the pump records its event
            kick["speeds"] = _to_host(torch.stack(
                [kick.pop("before"), _max_abs_vx(self.sim)]))
        img = self._pump.push(frame)
        published, self._inflight_kick = self._inflight_kick, kick
        if img is not None:             # None only while priming the pipe
            with self._lock:
                self._frame = img
                self._png = None
            self.frames += 1
            if published is not None:
                before, after = published.pop("speeds").tolist()
                published.update(
                    vmax_before=before, vmax_after=after,
                    latency_s=time.perf_counter() - published.pop("t_first"))
                self.kicks.append(published)

    def _loop(self):
        t0, n0 = time.perf_counter(), self.frames
        while not self._stop.is_set():
            self._run_one_frame()
            now = time.perf_counter()
            if now - t0 >= 1.0:
                self.fps = (self.frames - n0) / (now - t0)
                t0, n0 = now, self.frames

    def start(self):
        self._run_one_frame()           # prime the frame pipe
        self._run_one_frame()           # the first frame lands before serving
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                raise RuntimeError("InteractiveApp: frame loop did not stop")


def make_server(app: InteractiveApp, port: int) -> ThreadingHTTPServer:
    """The HTTP surface on 127.0.0.1:``port`` (0: an ephemeral port, read
    it from ``server_address``); call ``serve_forever`` to run it."""
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/frame.png"):
                png = app.latest_png()
                if png is None:
                    self._send(503, "text/plain", b"no frame yet")
                else:
                    self._send(200, "image/png", png)
            elif self.path.startswith("/stats"):
                self._send(200, "application/json",
                           json.dumps(app.stats()).encode())
            else:
                self._send(200, "text/html", PAGE.encode())

        def do_POST(self):
            ln = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(ln) if ln else b"{}"
            try:
                body = json.loads(raw or b"{}")
            except json.JSONDecodeError:
                body = {}
            if self.path.startswith("/impulse"):
                app.pointer_drag(float(body.get("px", 0)),
                                 float(body.get("py", 0)),
                                 float(body.get("dx", 0)),
                                 float(body.get("dy", 0)))
            elif self.path.startswith("/toggle"):
                app.toggle_view()
            self._send(200, "application/json", b"{}")

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def particle_state(app: InteractiveApp):
    """The engine's per-particle FluidState (materialized on demand)."""
    s = app.sim
    return s.particle_state() if hasattr(s, "particle_state") else s.state


def selfdrive(app: InteractiveApp, frames: int) -> int:
    """Headless exercise of the input path a browser drives: a rightward
    drag across the lower part of the canvas, then a view toggle.  Returns
    0 iff the fluid responded (its largest |vx| grew) and stayed finite."""
    spec = app.sim.spec
    v0 = float(particle_state(app).vx.abs().max())
    for i in range(frames):
        if i % 4 == 0:  # drag a path through the fluid block
            px = spec.width * (0.3 + 0.3 * (i / max(frames, 1)))
            py = spec.height * 0.8
            app.pointer_drag(px, py, 6.0, 0.0)
        if i == frames // 2:
            app.toggle_view()
        app._run_one_frame()
    s = particle_state(app)
    ok = (bool(s.x.isfinite().all()) and float(s.vx.abs().max()) > v0
          and app.latest_png() is not None)
    print(f"selfdrive: {frames} frames, step={int(s.step)} "
          f"mode={app.mode} overflow={app.sim.overflow} ok={ok}")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=5041)
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--substeps", type=int, default=16)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--solver", default="verlet")
    ap.add_argument("--session", action="store_true",
                    help="Session-backed large-N mode: resident dense "
                         "state + field raster + dense impulses "
                         "(for 100k-16M particles)")
    ap.add_argument("--sharded", type=int, default=0, metavar="D",
                    help="slab mode: the scene in D x-slabs "
                         "(ShardedSession; D slabs on the card, or D CPU "
                         "entries with --cpu)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU; the default is the CUDA card")
    ap.add_argument("--selfdrive", type=int, default=0, metavar="FRAMES",
                    help="no server: scripted drag + toggle, then exit")
    args = ap.parse_args(argv)

    app = InteractiveApp(n=args.n, substeps=args.substeps,
                         raster_width=args.width, solver=args.solver,
                         session=args.session, sharded=args.sharded,
                         device="cpu" if args.cpu else "cuda")
    if args.selfdrive:
        app._run_one_frame()
        return selfdrive(app, args.selfdrive)

    app.start()
    srv = make_server(app, args.port)
    print(f"serving http://localhost:{srv.server_address[1]} "
          f"({args.n} particles x {args.substeps} substeps/frame)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        app.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
