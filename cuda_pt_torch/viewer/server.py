"""Interactive web viewer with online accumulation and scene hot reload
(port of cuda_pt_tpu/viewer/server.py; the reference's imgui / GLFW /
OpenGL viewer, app/viewer.cu and src/viewer_impl/imgui_utils.cu).

A background thread accumulates 1-spp passes into the Renderer's film (one
frame = one spp); each frame is the film's sRGB export (core/film.to_srgb
with the viewer's tonemap) as a PNG (utils/image.encode_png, no PIL),
which the page polls. The settings panel posts JSON updates that edit the
scene tables, the depth caps, the ToF window, the renderer family, the
sampler or the camera.

Hot reload reaches the kernel: every edit of the tables, md, the family or
the sampler calls Renderer._reroute, which re-decides the route and
rebuilds the kernel routes' pack from the edited scene, so an edited
emitter, material or medium shows in the next pass on K2 / K5 too, and a
ToF window or a BSDF type outside the kernel's families moves the
Renderer to the composed route (info()["traversal"] says which). Under an
explicit traversal="fused" an edit that leaves the kernel's envelope
raises ValueError and the server answers 400, the Renderer unchanged.
(The reference's fused pack is built once and goes stale under its hot
reload.)

Edits never write into a tensor a pass may be reading: a table edit
clones the table, sets the row and swaps the reference under the state's
lock; the render thread runs each pass on a shallow copy of the Renderer
taken under that lock, and keeps the pass only if no edit came in
meanwhile.

Endpoints: GET / (the page), /frame.png, /info, /scene; POST /update.
Entry: python -m cuda_pt_torch.viewer --xml scene.xml [--port 8000].
"""

from __future__ import annotations

import copy
import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..api import Renderer
from ..core import camera as cam_mod
from ..core import film as film_mod
from ..core import qmc
from ..core.config import RendererType
from ..utils.image import encode_png

_PAGE = """<!DOCTYPE html>
<html><head><title>cuda_pt_torch viewer</title><style>
body{background:#111;color:#ddd;font-family:monospace;display:flex;gap:16px;padding:12px}
canvas{image-rendering:pixelated;border:1px solid #444}
#panel{width:330px} input{width:70px;background:#222;color:#ddd;border:1px solid #555}
.row{margin:4px 0} h3{margin:8px 0 4px;color:#8cf} #stats{color:#8f8;white-space:pre}
</style></head><body>
<div><canvas id="c" width="512" height="512" tabindex="0"></canvas>
<div id="stats"></div></div>
<div id="panel">
<h3>Renderer</h3>
<select onchange="post({kind:'renderer', value:this.value})">
<option value="pt">megakernel PT</option><option value="wfpt">wavefront PT</option>
<option value="vpt">volumetric PT</option><option value="lt">light tracer</option>
<option value="depth">depth</option><option value="bvh-cost">BVH cost</option>
</select>
<div class=row><label><input type="checkbox" style="width:auto"
 onchange="post({kind:'denoise', value:this.checked})"> denoise (à-trous)</label></div>
<div class=row><label><input type="checkbox" style="width:auto"
 onchange="post({kind:'sampler', value:this.checked ? 'sobol' : 'pcg'})"> Sobol sampler (QMC)</label></div>
<div class=row><label><input type="checkbox" style="width:auto"
 onchange="post({kind:'tonemap', value:this.checked ? 'aces' : 'gamma'})"> ACES filmic tonemap</label></div>
<h3>Camera (WASD+RF move, drag rotate)</h3>
<h3>Depth caps</h3><div id="depths"></div>
<h3>ToF window</h3>
<div class=row>min <input id="tofmin" value="0">
 max <input id="tofmax" value="0">
 <button onclick="post({kind:'tof',
   min_time: parseFloat(document.getElementById('tofmin').value),
   max_time: parseFloat(document.getElementById('tofmax').value)})">
 apply</button></div>
<h3>Emitters</h3><div id="emitters"></div>
<h3>Materials</h3><div id="materials"></div>
<h3>Media</h3><div id="media"></div>
</div>
<script>
const c = document.getElementById('c'), ctx = c.getContext('2d');
const img = new Image();
let drag = null;
function tick(){ img.src = '/frame.png?' + Date.now(); }
img.onload = () => { ctx.imageSmoothingEnabled = false;
  ctx.drawImage(img, 0, 0, c.width, c.height); setTimeout(tick, 120); };
img.onerror = () => setTimeout(tick, 500);
tick();
setInterval(async () => {
  const r = await fetch('/info'); const j = await r.json();
  document.getElementById('stats').textContent =
    `spp ${j.spp}  ${j.ms_per_pass.toFixed(0)} ms/pass  var ${j.variance.toExponential(2)}`;
}, 700);
function post(o){ fetch('/update', {method:'POST', body: JSON.stringify(o)}); }
const keymap = {w:[0,0,1], s:[0,0,-1], a:[-1,0,0], d:[1,0,0], r:[0,1,0], f:[0,-1,0]};
c.addEventListener('keydown', e => { const m = keymap[e.key];
  if (m) post({kind:'camera_move', delta:m.map(v=>v*0.1)}); });
c.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', e => { if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1]; drag = [e.clientX, e.clientY];
  post({kind:'camera_rotate', yaw: dx*0.004, pitch: dy*0.004}); });
async function buildPanel(){
  const j = await (await fetch('/scene')).json();
  const em = document.getElementById('emitters');
  j.emitters.forEach((e,i) => { if (i===0) return;
    em.insertAdjacentHTML('beforeend',
      `<div class=row>#${i} scale <input value="${e.scaler}"
        onchange="post({kind:'emitter',id:${i},field:'scaler',value:parseFloat(this.value)})"></div>`); });
  const mt = document.getElementById('materials');
  j.bsdfs.forEach((b,i) => mt.insertAdjacentHTML('beforeend',
    `<div class=row>#${i} t${b.btype} kd <input value="${b.k_d}"
      onchange="post({kind:'bsdf',id:${i},field:'k_d',value:this.value.split(',').map(parseFloat)})"></div>`));
  const md = document.getElementById('media');
  j.media.forEach((m,i) => { if (m.mtype < 0) return;
    md.insertAdjacentHTML('beforeend',
      `<div class=row>#${i} scale <input value="${m.scale}"
        onchange="post({kind:'medium',id:${i},field:'scale',value:parseFloat(this.value)})"></div>`); });
  const dp = document.getElementById('depths');
  for (const f of ['max_depth','max_diffuse','max_specular','max_transmit',
                   'max_volume'])
    dp.insertAdjacentHTML('beforeend',
      `<div class=row>${f} <input value="${j.md[f]}"
        onchange="post({kind:'max_depth',field:'${f}',value:parseInt(this.value)})"></div>`);
  document.getElementById('tofmin').value = j.md.min_time;
  document.getElementById('tofmax').value = j.md.max_time;
}
buildPanel();
</script></body></html>"""

DEPTH_FIELDS = ("max_depth", "max_diffuse", "max_specular", "max_transmit", "max_volume")
# update kinds whose edit the route must see (Renderer._reroute)
_REROUTE = ("renderer", "sampler", "emitter", "bsdf", "medium", "max_depth", "tof")


def _set_row(table, field: str, i: int, value):
    """A copy of table with row i of field set to value (the field's tensor
    cloned: a pass in flight keeps the old one)."""
    col = getattr(table, field).clone()
    col[i] = torch.as_tensor(value, dtype=col.dtype, device=col.device)
    return dataclasses.replace(table, **{field: col})


def frame_pixels(mean: torch.Tensor, gamma: bool, tonemap: str) -> np.ndarray:
    """The frame of a linear image: its sRGB export as uint8 (H, W, 3)."""
    srgb = film_mod.to_srgb(mean, gamma=gamma, tonemap=tonemap)
    return (srgb * 255.0 + 0.5).to(torch.uint8).cpu().numpy()


class ViewerState:
    """The viewer's Renderer, its render thread and the settings the page
    edits."""

    def __init__(self, renderer: Renderer):
        self.renderer = renderer
        self.lock = threading.Lock()
        self.dirty = False
        self.stop = threading.Event()
        self.png = b""
        # bumps each time an edit restarts accumulation (tests observe it
        # instead of racing the spp counter)
        self.generation = 0
        self.denoise_on = False
        self.tonemap = "gamma"
        self.colormap = "viridis"
        # the first pass after the last film reset: (generation, image)
        self.first_pass = None
        self.error = None  # what stopped the render thread, if anything
        self.thread = None

    def start(self):
        """Start the render thread (again after a stop)."""
        self.stop.clear()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _loop(self):
        while not self.stop.is_set():
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 - reported by /info, the thread ends
                self.error = f"{type(e).__name__}: {e}"
                self.stop.set()

    def step(self):
        """One pass: consume an edit (film reset, generation bump), render a
        pass on a snapshot of the Renderer, keep it if no edit came in
        meanwhile, and encode the frame."""
        r = self.renderer
        with self.lock:
            if self.dirty:
                r.reset_out_buffer()
                self.dirty = False
                self.generation += 1
            snap, gen = copy.copy(r), self.generation
        img = snap.render_raw()  # 1 spp accumulated (render_online)
        if self.denoise_on:
            lin = torch.as_tensor(snap.denoise(aov_spp=1), device=snap.device)
        else:
            lin = snap.film.mean
        png = encode_png(frame_pixels(lin, snap.config.gamma, self.tonemap))
        with self.lock:
            if self.dirty or gen != self.generation:
                return  # an edit arrived during the pass: drop it
            r.film = snap.film
            if snap.film.count == 1:
                self.first_pass = (gen, img)
            self.png = png

    # ---- hot reload (called from the HTTP handlers) ----------------------
    def update(self, msg: dict):
        """Apply one edit of the page; ValueError (the Renderer as it was)
        where the route cannot take it."""
        r = self.renderer
        kind = msg.get("kind")
        with self.lock:
            saved = (r.scene, r.md, r.rtype, r.sampler, r.fused, r._pack)
            try:
                self._apply(r, kind, msg)
                if kind in _REROUTE:
                    r._reroute()
            except Exception:
                r.scene, r.md, r.rtype, r.sampler, r.fused, r._pack = saved
                raise
            self.dirty = True

    def _apply(self, r: Renderer, kind: str, msg: dict):
        if kind == "renderer":  # switch the family live
            r.rtype = RendererType(msg["value"])
        elif kind == "denoise":
            self.denoise_on = bool(msg["value"])
        elif kind == "tonemap":
            self.tonemap = str(msg["value"])
        elif kind == "sampler":
            # the two samplers draw different sequences: accumulation restarts
            qmc.check_sampler(str(msg["value"]))
            r.sampler = str(msg["value"])
        elif kind == "camera_move":
            r.camera = cam_mod.move(r.camera, msg["delta"])
        elif kind == "camera_rotate":
            r.camera = cam_mod.rotate(r.camera, msg.get("yaw", 0.0), msg.get("pitch", 0.0))
        elif kind in ("emitter", "bsdf", "medium"):
            name = {"emitter": "emitters", "bsdf": "bsdfs", "medium": "media"}[kind]
            table = _set_row(getattr(r.scene, name), msg["field"], int(msg["id"]),
                             msg["value"])
            extra = {}
            if kind == "bsdf" and msg["field"] == "btype":  # the families present
                extra["present_bsdfs"] = tuple(sorted(set(int(x) for x in table.btype.tolist())))
            r.scene = dataclasses.replace(r.scene, **{name: table}, **extra)
        elif kind == "max_depth":
            # per-renderer depth caps (reference imgui_utils.cu:604-700)
            field = msg["field"]
            if field not in DEPTH_FIELDS:
                raise ValueError(f"max_depth field {field!r} is not one of {DEPTH_FIELDS}")
            r.md = dataclasses.replace(r.md, **{field: int(msg["value"])})
        elif kind == "tof":
            # ToF window in path-length units (reference imgui_utils.cu:701-760);
            # max_time 0 disables it
            r.md = dataclasses.replace(
                r.md, min_time=float(msg.get("min_time", r.md.min_time)),
                max_time=float(msg.get("max_time", r.md.max_time)))
        elif kind == "colormap":  # the depth / BVH-cost views' colormap
            self.colormap = str(msg["value"])

    def scene_json(self) -> dict:
        s = self.renderer.scene
        md = self.renderer.md
        return {
            "md": {k: float(getattr(md, k)) for k in (*DEPTH_FIELDS, "min_time", "max_time")},
            "colormap": self.colormap,
            "emitters": [{"etype": int(t), "scaler": float(sc)}
                         for t, sc in zip(s.emitters.etype.tolist(), s.emitters.scaler.tolist())],
            "bsdfs": [{"btype": int(t), "k_d": ",".join(f"{x:.3f}" for x in kd)}
                      for t, kd in zip(s.bsdfs.btype.tolist(), s.bsdfs.k_d.tolist())],
            "media": [{"mtype": int(t), "scale": float(sc)}
                      for t, sc in zip(s.media.mtype.tolist(), s.media.scale.tolist())],
        }


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                self._send(200, _PAGE.encode(), "text/html")
            elif path == "/frame.png":
                png = state.png
                if not png:
                    self._send(503, b"{}")
                else:
                    self._send(200, png, "image/png")
            elif path == "/info":
                r = state.renderer
                body = json.dumps({
                    "spp": r.counter(),
                    "ms_per_pass": r.avg_frame_time(),
                    "variance": float(np.mean(r.variance())) if r.counter() > 1 else 0.0,
                    "generation": state.generation,
                    "error": state.error,
                    **r.info(),
                }).encode()
                self._send(200, body)
            elif path == "/scene":
                self._send(200, json.dumps(state.scene_json()).encode())
            else:
                self._send(404, b"{}")

        def do_POST(self):
            if self.path != "/update":
                self._send(404, b"{}")
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                state.update(json.loads(self.rfile.read(n) or b"{}"))
            except (ValueError, NotImplementedError, KeyError, IndexError, TypeError,
                    AttributeError) as e:
                self._send(400, json.dumps({"error": str(e)}).encode())
                return
            self._send(200, b"{}")

    return Handler


def serve(source, port: int = 8000, host: str = "127.0.0.1", **renderer_kw):
    """Start the viewer on source (an XML path or a ParsedScene); serves
    until interrupted."""
    renderer = Renderer(source, **renderer_kw)
    state = ViewerState(renderer)
    state.start()
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
    print(f"[VIEWER] http://{host}:{httpd.server_address[1]}  scene={renderer.info()}",
          flush=True)
    try:
        httpd.serve_forever()
    finally:
        state.stop.set()
        httpd.server_close()
    return httpd
