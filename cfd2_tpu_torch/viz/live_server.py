"""Live web viewer: watch and steer a running simulation.

Port of ``cfd2_tpu.viz.live_server``: the solver thread steps the port's
:class:`..app.driver.Simulation`, and frames take their fields to the host
under the thread's step lock.

The interactive half of the reference's egui application contract
(src/ui/app.rs:567-948): a background solver thread steps the simulation
continuously (adaptive dt, like the reference's Run loop at app.rs:867-948)
while an HTTP server serves a page that re-renders the current field and
accepts control commands mid-run.  Control parity with the reference's side
panel (app.rs:573-836): run/pause, Reset, field switching, convection scheme,
time scheme (Euler/BDF2), preconditioner, fluid presets with live Re display,
inlet velocity, dt / adaptive-CFL target, alpha_u / alpha_p, and a mesh
wireframe toggle (polygon path); frames carry a colorbar legend.

Scheme/preconditioner/time-scheme switches change the solver config, which
the next step reads (the analogue of the reference rebuilding pipelines on
Init/Reset; here nothing is recompiled).

Zero external dependencies: http.server + a long-poll JS page.  Field frames
are rendered on demand from the *live* solver state (the analogue of the
reference renderer binding the solver's state buffer zero-copy,
cfd_renderer.rs:60-324 — here the snapshot is pulled once per frame request).
On structured meshes the renderer takes the device-order state and rasterizes
O(pixels) (viz/renderer.py grid path), so watching a 1M-cell run works.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>cfd2_tpu live</title><style>
body { font-family: sans-serif; margin: 1em; background: #111; color: #eee; }
img { max-width: 100%%; border: 1px solid #444; }
button, select, input { margin: 0 .2em; padding: .25em .6em; }
#stats { font-family: monospace; white-space: pre; margin: .6em 0; }
.row { margin: .3em 0; }
label { margin-left: .6em; }
</style></head><body>
<h3>cfd2_tpu — live simulation</h3>
<div class="row">
<button onclick="ctl('pause')">Pause</button>
<button onclick="ctl('resume')">Run</button>
<button onclick="ctl('reset')">Reset</button>
<select id="field" onchange="ctl('field='+this.value)">
<option>mag</option><option>u</option><option>v</option><option>p</option>
<option>d_p</option></select>
<label>wireframe <input type="checkbox"
 onchange="ctl('wireframe='+(this.checked?1:0))"></label>
</div>
<div class="row">
<label>scheme <select onchange="ctl('scheme='+this.value)">
<option value="0">Upwind</option><option value="1">2nd-order upwind</option>
<option value="2">QUICK</option></select></label>
<label>time <select onchange="ctl('time_scheme='+this.value)">
<option value="0">Euler</option><option value="1">BDF2</option></select></label>
<label>precond <select onchange="ctl('precond='+this.value)">
<option value="0">Jacobi</option><option value="1" selected>AMG</option>
<option value="2">Block-Jacobi</option></select></label>
<label>fluid <select onchange="ctl('fluid='+this.value)">
<option>Custom</option><option>Water</option><option>Air</option>
<option>Alcohol</option><option>Kerosene</option><option>Mercury</option>
</select></label>
</div>
<div class="row">
<label>inlet <input id="inlet" size="4" value="%(inlet)s"
 onchange="ctl('inlet='+this.value)"></label>
<label>alpha_u <input size="4" value="0.7"
 onchange="ctl('alpha_u='+this.value)"></label>
<label>alpha_p <input size="4" value="1.0"
 onchange="ctl('alpha_p='+this.value)"></label>
<label>CFL <input size="4" value="0.5"
 onchange="ctl('cfl='+this.value)"></label>
<label>dt <input size="7" onchange="ctl('dt='+this.value)"></label>
<label>adaptive <input type="checkbox" checked
 onchange="ctl('adaptive='+(this.checked?1:0))"></label>
</div>
<div class="row">
<label>geometry <select onchange="ctl('geometry='+this.value)">
<option>channel</option><option>backstep</option><option>rect</option>
</select></label>
<label>mesh <select onchange="ctl('mesh_type='+this.value)">
<option>cutcell</option><option>delaunay</option><option>voronoi</option>
</select></label>
<label>cell size <input size="6" onchange="ctl('cell='+this.value)"></label>
<span style="color:#888">(applied on Reset — rebuilds the mesh)</span>
</div>
<div id="stats">connecting...</div>
<img id="frame" src="/frame.png">
<script>
function ctl(q) { fetch('/control?' + q); }
async function tick() {
  try {
    const r = await fetch('/status'); const s = await r.json();
    document.getElementById('stats').textContent =
      `step ${s.step}  t=${s.time.toFixed(4)}  dt=${s.dt.toExponential(2)}` +
      `  outer=${s.outer_iters}  max|u|=${s.max_vel.toFixed(3)}` +
      (s.cd == null ? '' :
       `  Cd=${s.cd.toFixed(3)} Cl=${s.cl.toFixed(3)}`) +
      `  Re=${s.re.toFixed(0)}  ${s.cells} cells` +
      `  ${s.paused ? 'PAUSED' : (s.should_stop ? 'STOPPED' :
         (s.busy ? 'stepping/compiling' : 'running'))}`;
    if (!s.paused && !s.should_stop)
      document.getElementById('frame').src = '/frame.png?ts=' + Date.now();
  } catch (e) {}
  setTimeout(tick, 700);
}
tick();
</script></body></html>"""


class LiveSolverThread(threading.Thread):
    """Steps the solver until stopped; pausable; publishes step stats and
    exposes the reference's full mid-run control surface."""

    def __init__(self, sim, max_steps: int = 0):
        super().__init__(daemon=True)
        self.sim = sim
        self.max_steps = max_steps
        self.lock = threading.Lock()
        self.running = threading.Event()
        self.running.set()
        self.shutdown = False
        self.busy = False
        self.step_i = 0
        self.stats = {"step": 0, "time": 0.0, "dt": 0.0, "outer_iters": 0,
                      "max_vel": 0.0, "should_stop": False}
        self.pending_build: dict = {}
        self.on_rebuild = None        # set by LiveServer: swaps the renderer

    def run(self):
        while not self.shutdown:
            s = self.sim.solver      # re-read: Reset may have rebuilt it
            if not self.running.is_set():
                time.sleep(0.05)
                continue
            if self.max_steps and self.step_i >= self.max_steps:
                break
            with self.lock:
                s = self.sim.solver  # may have been swapped before the lock
                self.busy = True
                max_vel = float(s.max_velocity_device())
                if self.sim.adaptive:
                    s.set_dt(self.sim.controller.next_dt(
                        float(s.params.dt), max_vel))
                s.step()
                self.busy = False
                self.step_i += 1
                forces = self.sim.force_coefficients()
                self.stats = {
                    "step": self.step_i,
                    "time": float(s.state.time),
                    "dt": float(s.params.dt),
                    "outer_iters": int(s.state.outer_iters),
                    "max_vel": max_vel,
                    "should_stop": bool(s.should_stop),
                    "cd": forces[0] if forces else None,
                    "cl": forces[1] if forces else None,
                }
            if s.should_stop:
                break
            # Python's locks are not fair: without a pause between steps
            # this thread takes the lock straight back, and a snapshot or a
            # control waiting on it starves.
            time.sleep(0.001)

    # --- control surface (reference setters, solver.rs:36-95 +
    #     panel widgets, app.rs:573-836) ---
    def pause(self):
        self.running.clear()

    def resume(self):
        self.running.set()

    def set_inlet(self, v: float):
        with self.lock:
            self.sim.inlet_velocity = v
            self.sim.solver.set_inlet_velocity(v)

    def set_alpha_u(self, a: float):
        with self.lock:
            self.sim.solver.set_alpha_u(a)

    def set_alpha_p(self, a: float):
        with self.lock:
            self.sim.solver.set_alpha_p(a)

    def set_dt(self, dt: float):
        with self.lock:
            self.sim.solver.set_dt(dt)

    def set_cfl(self, c: float):
        with self.lock:
            self.sim.controller.target_cfl = c

    def set_adaptive(self, on: bool):
        with self.lock:
            self.sim.adaptive = on

    def set_scheme(self, v: int):
        with self.lock:
            self.sim.solver.set_scheme(v)

    def set_time_scheme(self, v: int):
        with self.lock:
            self.sim.solver.set_time_scheme(v)

    def set_precond(self, v: int):
        with self.lock:
            self.sim.solver.set_precond_type(v)

    def set_fluid(self, name: str):
        from ..app.fluids import Fluid
        f = Fluid.by_name(name)
        with self.lock:
            self.sim.fluid = f
            self.sim.solver.set_density(f.density)
            self.sim.solver.set_viscosity(f.viscosity)

    def set_build_param(self, **kw):
        """Queue a geometry / mesh-type / cell-size change; applied by the
        next Reset (the reference's panel edits take effect on Init/Reset
        too, app.rs:301-393)."""
        with self.lock:
            self.pending_build.update(kw)

    def reset(self):
        """Reference Init/Reset (app.rs:301-393): when geometry, mesh type,
        or cell size changed in the panel, rebuild the mesh + solver from
        the new selection (build_mesh, app.rs:395-482); otherwise fresh
        fields on the same mesh.  The rebuild is surfaced as busy."""
        from ..runtime.state import initial_state
        sim = self.sim
        with self.lock:
            pend, self.pending_build = self.pending_build, {}
            if pend:
                self.busy = True
                try:
                    sim.rebuild(**pend)
                finally:
                    self.busy = False
                if self.on_rebuild is not None:
                    self.on_rebuild()
            else:
                u0 = np.zeros((sim.mesh.num_cells, 2))
                u0[sim.mesh.cell_cx < sim.cell_size * 2, 0] = \
                    sim.inlet_velocity
                sim.solver.state = initial_state(sim.solver.mesh, u0=u0)
                sim.solver.set_dt(sim.dt0)
            self.step_i = 0
            self.stats = dict(self.stats, step=0, time=0.0,
                              should_stop=False)

    def status(self):
        """Latest step stats — lock-free (must not block on a stepping or
        compiling solver; dict replacement is atomic under the GIL)."""
        return dict(self.stats, paused=not self.running.is_set(),
                    busy=self.busy, re=self.sim.reynolds,
                    cells=self.sim.mesh.num_cells)

    def snapshot(self, dev_order: bool = False):
        """Host copies of the live fields (consistent under the step lock).
        ``dev_order``: raw device-layout arrays (the grid render path)."""
        s = self.sim.solver
        with self.lock:
            if dev_order:
                fields = {"u": s.state.u.cpu().numpy(),
                          "p": s.state.p.cpu().numpy(),
                          "d_p": s.state.d_p.cpu().numpy()}
            else:
                fields = {"u": s.get_u(), "p": s.get_p(), "d_p": s.get_d_p()}
            return (type("S", (), fields)(),
                    dict(self.stats, paused=not self.running.is_set()))


def make_handler(worker: LiveSolverThread, inlet: float):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):            # quiet
            pass

        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            if url.path == "/":
                self._send(200, "text/html",
                           (_PAGE % {"inlet": inlet}).encode())
            elif url.path == "/status":
                self._send(200, "application/json",
                           json.dumps(worker.status()).encode())
            elif url.path == "/frame.png":
                field = q.get("field", [self.server.field])[0]
                renderer = self.server.renderer   # swapped on mesh rebuild
                state, _ = worker.snapshot(dev_order=renderer.grid is not None)
                fig = renderer.render(state, mode=field,
                                      show_mesh=self.server.wireframe)
                buf = io.BytesIO()
                fig.savefig(buf, format="png", bbox_inches="tight")
                import matplotlib.pyplot as plt
                plt.close(fig)
                self._send(200, "image/png", buf.getvalue())
            elif url.path == "/control":
                if "field" in q:
                    self.server.field = q["field"][0]
                if "wireframe" in q:
                    self.server.wireframe = q["wireframe"][0] == "1"
                if "inlet" in q:
                    worker.set_inlet(float(q["inlet"][0]))
                if "alpha_u" in q:
                    worker.set_alpha_u(float(q["alpha_u"][0]))
                if "alpha_p" in q:
                    worker.set_alpha_p(float(q["alpha_p"][0]))
                if "dt" in q:
                    worker.set_dt(float(q["dt"][0]))
                if "cfl" in q:
                    worker.set_cfl(float(q["cfl"][0]))
                if "adaptive" in q:
                    worker.set_adaptive(q["adaptive"][0] == "1")
                if "scheme" in q:
                    worker.set_scheme(int(q["scheme"][0]))
                if "time_scheme" in q:
                    worker.set_time_scheme(int(q["time_scheme"][0]))
                if "precond" in q:
                    worker.set_precond(int(q["precond"][0]))
                if "fluid" in q:
                    worker.set_fluid(q["fluid"][0])
                # Mesh-construction panel state: queued, applied on Reset
                # (reference Init/Reset rebuild, app.rs:301-393).
                if "geometry" in q:
                    worker.set_build_param(geometry=q["geometry"][0])
                if "mesh_type" in q:
                    worker.set_build_param(mesh_type=q["mesh_type"][0])
                if "cell" in q:
                    worker.set_build_param(cell_size=float(q["cell"][0]))
                if "max_cell" in q:
                    worker.set_build_param(
                        max_cell_size=float(q["max_cell"][0]))
                cmd = (url.query or "").split("=")[0]
                if cmd == "pause" or "pause" in q:
                    worker.pause()
                elif cmd == "resume" or "resume" in q:
                    worker.resume()
                elif cmd == "reset" or "reset" in q:
                    worker.reset()
                self._send(200, "application/json", b'{"ok": true}')
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


class LiveServer:
    """Serve a live view of ``sim`` (an app.driver.Simulation)."""

    def __init__(self, sim, host: str = "127.0.0.1", port: int = 8787,
                 max_steps: int = 0):
        from .renderer import FieldRenderer
        self.worker = LiveSolverThread(sim, max_steps=max_steps)
        handler = make_handler(self.worker, sim.inlet_velocity)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.field = "mag"
        self.httpd.wireframe = False
        self.httpd.renderer = FieldRenderer(sim.mesh,
                                            device_mesh=sim.solver.mesh)
        # Reset-with-rebuild swaps in a renderer for the new mesh.
        self.worker.on_rebuild = lambda: setattr(
            self.httpd, "renderer",
            FieldRenderer(sim.mesh, device_mesh=sim.solver.mesh))
        self.host, self.port = self.httpd.server_address

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def start(self):
        self.worker.start()
        self._srv = threading.Thread(target=self.httpd.serve_forever,
                                     daemon=True)
        self._srv.start()
        return self

    def stop(self, timeout: float = 60.0):
        """Stop serving and wait (up to ``timeout`` s) for the solver
        thread to finish its step: a thread still stepping when the
        interpreter exits would take the process down with it."""
        self.worker.shutdown = True
        self.worker.resume()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self.worker.is_alive():
            self.worker.join(timeout)

    def serve_until_done(self):
        """Block until the solver thread finishes (max_steps/should_stop)."""
        try:
            while self.worker.is_alive():
                self.worker.join(timeout=0.5)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()
