"""Built-in browser viewer: an interactive viewer app with no dependencies
beyond PIL.

Port of ``feature3dgs_tpu/viewer/web.py``. A threaded HTTP server renders
frames with the render path the SIBR bridge uses (``render/renderer.py`` +
``render/modes.py:net_image``) and serves a single-page orbit viewer to
any browser; no SIBR build, no GL, works over SSH port-forwarding.

Endpoints:
  GET /                  one-page viewer app (embedded HTML/JS)
  GET /info              scene metadata JSON (gaussian count, modes, ...)
  GET /render?...        one rendered frame as PNG; orbit-camera params
                         az/el/r/cx/cy/cz, image size w/h, render mode
                         (index into render.modes.RENDER_ITEMS), Gaussian
                         scaling modifier

Camera conventions match data/cameras.py (COLMAP: x right, y down,
z forward); the orbit parametrization uses a world-up estimated from the
training cameras when available. A frame is rendered and post-processed
on the render's device under one lock (one CUDA stream, several HTTP
threads), and its uint8 image is the one copy to the host before PIL
encodes the PNG.
"""
from __future__ import annotations

import io
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from feature3dgs_tpu_torch.data.cameras import Camera
from feature3dgs_tpu_torch.render.modes import (RENDER_ITEMS, net_image,
                                                to_uint8)


def _orthonormal_frame(up: np.ndarray):
    """(a, b, up) right-handed-ish frame with `up` as the pole axis."""
    up = up / (np.linalg.norm(up) + 1e-12)
    probe = np.array([0.0, 0.0, 1.0])
    if abs(float(np.dot(up, probe))) > 0.9:
        probe = np.array([1.0, 0.0, 0.0])
    a = np.cross(up, probe)
    a /= np.linalg.norm(a) + 1e-12
    b = np.cross(up, a)
    return a, b, up


def orbit_camera(center: np.ndarray, radius: float, az: float, el: float,
                 width: int, height: int, fovy: float,
                 up: np.ndarray) -> Camera:
    """Camera on the (az, el) sphere around `center`, looking at it.

    az/el in radians; el > 0 moves toward +up. Conventions follow
    data/cameras.py: R is camera-to-world rotation (x right, y down,
    z forward), T is world-to-camera translation."""
    a, b, u = _orthonormal_frame(np.asarray(up, np.float64))
    offset = (math.cos(el) * math.cos(az) * a
              + math.cos(el) * math.sin(az) * b
              + math.sin(el) * u)
    pos = np.asarray(center, np.float64) + radius * offset
    z = -offset                                   # forward: camera -> center
    y0 = -u                                       # world down
    x = np.cross(y0, z)
    n = np.linalg.norm(x)
    if n < 1e-8:                                  # looking along the pole
        x = a
    else:
        x /= n
    y = np.cross(z, x)
    r_c2w = np.stack([x, y, z], axis=1)
    t = -r_c2w.T @ pos
    fovx = 2 * math.atan(math.tan(fovy / 2) * width / height)
    return Camera(uid=0, colmap_id=0, R=r_c2w.astype(np.float64),
                  T=t.astype(np.float64), fovx=fovx, fovy=fovy,
                  image=None, image_name="web", semantic_feature=None,
                  width=width, height=height)


def estimate_up(cameras_json: list | None) -> np.ndarray:
    """World-up = mean camera up (-R[:,1] of c2w) over the training
    cameras; falls back to COLMAP's usual y-down."""
    if cameras_json:
        ups = []
        for entry in cameras_json:
            r = np.asarray(entry["rotation"], np.float64)
            ups.append(-r[:, 1])
        m = np.mean(ups, axis=0)
        if np.linalg.norm(m) > 1e-6:
            return m / np.linalg.norm(m)
    return np.array([0.0, -1.0, 0.0])


class WebViewer:
    """Threaded HTTP viewer around a loaded Gaussian model.

    ``render_fn(cam: Camera, scaling_modifier: float) -> dict`` returns the
    render package as tensors on the render device (color [H,W,3], feature
    [H,W,F], depth [H,W]), the contract the SIBR bridge uses, so
    cli/web_view.py and an in-training hook share one code path."""

    def __init__(self, render_fn, *, center, radius, up=None,
                 n_gaussians: int = 0, feature_dim: int = 0,
                 source: str = "", host: str = "127.0.0.1", port: int = 8090):
        self.render_fn = render_fn
        self.center0 = np.asarray(center, np.float64)
        self.radius0 = float(radius)
        self.up = (np.asarray(up, np.float64) if up is not None
                   else np.array([0.0, -1.0, 0.0]))
        self.meta = {"n_gaussians": int(n_gaussians),
                     "feature_dim": int(feature_dim),
                     "modes": list(RENDER_ITEMS), "source": source,
                     "center": [float(v) for v in self.center0],
                     "radius": self.radius0,
                     "up": [float(v) for v in self.up]}
        self._lock = threading.Lock()
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def do_GET(self):
                try:
                    viewer._handle(self)
                except (ConnectionError, BrokenPipeError):
                    pass

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self._thread = None

    # -- server lifecycle ---------------------------------------------------
    def serve_background(self):
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self.server.serve_forever()

    def close(self):
        self.server.shutdown()
        self.server.server_close()

    # -- request handling ---------------------------------------------------
    def _handle(self, req: BaseHTTPRequestHandler):
        parsed = urlparse(req.path)
        if parsed.path == "/":
            body = _PAGE.encode()
            req.send_response(200)
            req.send_header("Content-Type", "text/html; charset=utf-8")
            req.send_header("Content-Length", str(len(body)))
            req.end_headers()
            req.wfile.write(body)
        elif parsed.path == "/info":
            body = json.dumps(self.meta).encode()
            req.send_response(200)
            req.send_header("Content-Type", "application/json")
            req.send_header("Content-Length", str(len(body)))
            req.end_headers()
            req.wfile.write(body)
        elif parsed.path == "/render":
            q = {k: v[0] for k, v in parse_qs(parsed.query).items()}
            png, ms = self._render_png(q)
            req.send_response(200)
            req.send_header("Content-Type", "image/png")
            req.send_header("Content-Length", str(len(png)))
            req.send_header("X-Render-Ms", f"{ms:.1f}")
            req.end_headers()
            req.wfile.write(png)
        else:
            req.send_response(404)
            req.end_headers()

    def camera(self, q: dict) -> tuple[Camera, int, float]:
        """(orbit camera, render mode, scaling modifier) of a /render
        query, with the JAX viewer's defaults and clamps."""
        az = float(q.get("az", 0.0))
        el = float(q.get("el", 0.2))
        r = float(q.get("r", self.radius0))
        center = np.array([float(q.get("cx", self.center0[0])),
                           float(q.get("cy", self.center0[1])),
                           float(q.get("cz", self.center0[2]))])
        w = max(16, min(int(q.get("w", 800)), 4096))
        h = max(16, min(int(q.get("h", 600)), 4096))
        mode = max(0, min(int(q.get("mode", 0)), len(RENDER_ITEMS) - 1))
        scaling = float(q.get("scaling", 1.0))
        fovy = math.radians(float(q.get("fovy", 50.0)))
        return orbit_camera(center, r, az, el, w, h, fovy, self.up), mode, \
            scaling

    def _render_png(self, q: dict) -> tuple[bytes, float]:
        cam, mode, scaling = self.camera(q)
        t0 = time.perf_counter()
        # render and post-process on the render device under the lock,
        # then one copy of the uint8 frame to the host
        with self._lock:
            pkg = self.render_fn(cam, scaling)
            proj = torch.from_numpy(np.asarray(cam.full_proj)).to(
                pkg["color"].device)
            arr = to_uint8(net_image(pkg, RENDER_ITEMS, mode, proj)
                           ).cpu().numpy()
        ms = (time.perf_counter() - t0) * 1000.0
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return buf.getvalue(), ms


_PAGE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>feature3dgs_tpu viewer</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:13px system-ui,sans-serif;
      overflow:hidden}
 #bar{position:fixed;top:0;left:0;right:0;display:flex;gap:12px;
      align-items:center;padding:8px 12px;background:#000a;z-index:2}
 #view{position:absolute;inset:0;display:flex;align-items:center;
       justify-content:center}
 img{max-width:100vw;max-height:100vh;image-rendering:auto;cursor:grab}
 select,input{background:#222;color:#ddd;border:1px solid #444;
              border-radius:4px;padding:2px 6px}
 #stats{margin-left:auto;opacity:.8}
</style></head><body>
<div id="bar">
 <b>feature3dgs_tpu</b>
 <label>mode <select id="mode"></select></label>
 <label>size <select id="size">
   <option>400x300</option><option selected>800x600</option>
   <option>1200x900</option><option>1600x1200</option></select></label>
 <label>scale <input id="scaling" type="range" min="0.05" max="1.5"
   step="0.05" value="1" style="width:90px"></label>
 <span id="stats"></span>
</div>
<div id="view"><img id="frame" draggable="false"></div>
<script>
let az=0.6, el=0.25, r=1, cx=0, cy=0, cz=0, up=[0,-1,0], busy=false,
    dirty=true, meta=null;
const img=document.getElementById('frame'),
      modeSel=document.getElementById('mode'),
      sizeSel=document.getElementById('size'),
      scaling=document.getElementById('scaling'),
      stats=document.getElementById('stats');
fetch('/info').then(r=>r.json()).then(m=>{meta=m;
  r=m.radius*1.2; [cx,cy,cz]=m.center; up=m.up;
  m.modes.forEach((n,i)=>{const o=document.createElement('option');
    o.value=i;o.textContent=n;modeSel.appendChild(o);});
  stats.textContent=m.n_gaussians.toLocaleString()+' gaussians';
  dirty=true;});
function frame(){
  if(!dirty||busy||!meta){requestAnimationFrame(frame);return;}
  dirty=false;busy=true;
  const [w,h]=sizeSel.value.split('x');
  const t0=performance.now();
  fetch(`/render?az=${az}&el=${el}&r=${r}&cx=${cx}&cy=${cy}&cz=${cz}`+
        `&w=${w}&h=${h}&mode=${modeSel.value}&scaling=${scaling.value}`)
   .then(resp=>{const ms=resp.headers.get('X-Render-Ms');
     stats.textContent=meta.n_gaussians.toLocaleString()+
       ` gaussians · render ${(+ms).toFixed(0)} ms · rtt `+
       `${(performance.now()-t0).toFixed(0)} ms`;
     return resp.blob();})
   .then(b=>{const u=URL.createObjectURL(b);
     img.onload=()=>URL.revokeObjectURL(u);img.src=u;busy=false;})
   .catch(()=>{busy=false;});
  requestAnimationFrame(frame);}
requestAnimationFrame(frame);
let drag=null;
img.addEventListener('pointerdown',e=>{drag={x:e.clientX,y:e.clientY,
  pan:e.shiftKey||e.button===2};img.setPointerCapture(e.pointerId);});
img.addEventListener('pointermove',e=>{if(!drag)return;
  const dx=e.clientX-drag.x, dy=e.clientY-drag.y;
  drag.x=e.clientX;drag.y=e.clientY;
  if(drag.pan){ // pan center in the camera plane
    const s=r*0.0015;
    // camera right/up from orbit frame (approx): rotate unit vectors
    const ca=Math.cos(az),sa=Math.sin(az),ce=Math.cos(el),se=Math.sin(el);
    // frame: a,b horizontal (from up), here approximate world-space pan
    cx+=(-sa*dx*s)+(ca*se*dy*s); cz+=(ca*dx*s)+(sa*se*dy*s);
    cy+=-up[1]*ce*dy*s;
  } else { az+=dx*0.005; el=Math.min(1.5,Math.max(-1.5,el+dy*0.005)); }
  dirty=true;});
img.addEventListener('pointerup',()=>{drag=null;});
img.addEventListener('contextmenu',e=>e.preventDefault());
document.getElementById('view').addEventListener('wheel',e=>{
  e.preventDefault();r*=Math.pow(1.1,e.deltaY>0?1:-1);dirty=true;},
  {passive:false});
[modeSel,sizeSel].forEach(x=>x.addEventListener('change',()=>dirty=true));
scaling.addEventListener('input',()=>dirty=true);
</script></body></html>
"""
