"""Interactive volume viewer, the JAX package's ``viewer/webapp.py`` on
PyTorch: a WebGL2 raymarcher served over HTTP with the volumes it shows.

The reference ships HNanoViewer, a GLFW/ImGui/OpenGL app that loads a .vdb,
bakes it to a dense 3D texture and raymarches it in a fragment shader with
a mouse-orbit camera and a performance panel
(``reference/HNanoViewer/src/HNanoViewer.cpp:106-362``,
``HNanoViewer/shaders/fragment_shader.frag:13-60``,
``HNanoViewer/src/OpenVDBLoader.cpp:19-86``). Here the bake runs on the
device (``core/convert.tiles_to_dense``) and the front end is the JAX
package's page, character for character: front-to-back alpha over 256
steps, orbit and zoom, density / step / emission sliders, a render-time
overlay, and in live mode "Step" / "Play", which step the simulation on the
server (``live_source``: the port's plume or fire model on the card) and
stream the volume again.

Usage:
  python -m hnanosolver_tpu_torch.cli view out/frame_0120.npz
  python -m hnanosolver_tpu_torch.cli view --live plume --port 8642
then open http://localhost:8642/ (``--port 0`` takes a free port, which
``serve`` prints).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

import numpy as np

Volumes = Dict[str, np.ndarray]  # field name -> dense [Nx,Ny,Nz] f32 on the host


class VolumeSource:
    """A (possibly steppable) provider of dense volumes."""

    def __init__(self, volumes: Volumes, stepper: Optional[Callable[[int], Volumes]] = None):
        self.volumes = volumes
        self.stepper = stepper
        self.frame = 0
        self.step_ms = 0.0
        self._lock = threading.Lock()

    @property
    def live(self) -> bool:
        return self.stepper is not None

    def step(self, n: int = 1) -> None:
        """``n`` frames of the stepper; ``step_ms`` is the host clock a
        frame, the bake to the host (which waits for the device) included."""
        with self._lock:
            t0 = time.perf_counter()
            self.volumes = self.stepper(n)
            self.step_ms = (time.perf_counter() - t0) * 1e3 / max(n, 1)
            self.frame += n

    def meta(self) -> dict:
        with self._lock:
            fields = {name: {"dims": list(d.shape), "vmax": float(max(d.max(), 1e-12))}
                      for name, d in self.volumes.items()}
            return {"fields": fields, "frame": self.frame, "live": self.live,
                    "step_ms": round(self.step_ms, 2)}

    def payload(self, field: str) -> bytes:
        """u8-quantized volume, texImage3D order (depth, height, width)."""
        with self._lock:
            d = self.volumes[field]
            vmax = max(float(d.max()), 1e-12)
            q = np.clip(d / vmax * 255.0, 0, 255).astype(np.uint8)
            return np.ascontiguousarray(np.transpose(q, (2, 1, 0))).tobytes()


def _bake(topo, state, shape, origin=(0, 0, 0)) -> Volumes:
    """density (+ flame, if present) densified over the view box on the
    topology's device, then moved to the host."""
    from hnanosolver_tpu_torch.core.convert import tiles_to_dense

    names = ["density"] + (["flame"] if "flame" in state.scalars else [])
    return {k: tiles_to_dense(topo, state.scalar_blocks(k), shape, origin).cpu().numpy()
            for k in names}


def state_source(topo, state, shape, origin=(0, 0, 0)) -> VolumeSource:
    """Bake density (+ flame, if present) from a FieldState."""
    return VolumeSource(_bake(topo, state, shape, origin))


def live_source(scenario: str, shape=(256, 256, 256), params=None, cfg=None,
                device=None) -> VolumeSource:
    """A steppable plume or fire simulation on ``device`` (default: the
    card) as a volume source. ``fire`` runs the fire model (the burner disk,
    its combustion defaults and keep tiles), as the ``fire`` subcommand
    does. The capacity is the JAX package's: the dense tile count of the
    view box, clipped to [512, 8192], so that growth inside it keeps the
    capacity."""
    from hnanosolver_tpu_torch.config import SolverParams
    from hnanosolver_tpu_torch.core.activation import expand_for_state
    from hnanosolver_tpu_torch.models import plume as P

    s = float(min(shape))  # the emitter scales with the view box
    cap = int(np.clip(np.prod(np.asarray(shape) // 8), 512, 8192))
    if scenario == "fire":
        from hnanosolver_tpu_torch.models import fire as F

        params = params or F.default_params()
        if cfg is None:
            cfg = F.FireConfig(center=(s / 2, s / 16, s / 2), radius=s / 9)
        topo0, state0 = F.initial(cfg, capacity=cap, device=device)
        box = {"topo": topo0, "state": state0}
        step_fn = F.fire_step
        keep = F.burner_tiles(cfg)
    else:
        params = params or SolverParams()
        if cfg is None:
            cfg = P.PlumeConfig(center=(s / 2, s / 8, s / 2), radius=s / 10)
        box = {"topo": P.initial_topology(cfg, capacity=cap, device=device)}
        box["state"] = P.initial_state(box["topo"])
        step_fn = P.plume_step
        keep = P.emitter_tiles(cfg, pad=1)

    def stepper(n: int) -> Volumes:
        for _ in range(n):
            box["state"] = step_fn(box["topo"], box["state"], params, cfg)
            box["topo"], box["state"] = expand_for_state(
                box["topo"], box["state"], threshold=cfg.occupancy_threshold,
                radius=cfg.dilate_radius, keep_tiles=keep, padding=cfg.padding)
        return _bake(box["topo"], box["state"], shape)

    return VolumeSource(_bake(box["topo"], box["state"], shape), stepper)


def file_source(path: str, shape=None, device=None) -> VolumeSource:
    """A .npz checkpoint (loaded on ``device``, default: the card), .nvdb or
    .vdb file as a static volume (the OpenVDBLoader::loadVDB analog). A
    vector grid shows its magnitude."""
    from hnanosolver_tpu_torch.core import coords as C

    if path.endswith(".npz"):
        from hnanosolver_tpu_torch.io.state import load_npz

        topo, state, _, _ = load_npz(path, device=device)
        if shape is None:
            org = topo.origins[1:topo.n_active + 1].cpu().numpy()
            shape = tuple(int(x) for x in (org.max(axis=0) + 1) * C.LEAF)
        return state_source(topo, state, shape)
    if path.endswith(".nvdb"):
        from hnanosolver_tpu_torch.io.nvdb import read_nvdb

        name, _vs, origins, values, _masks = read_nvdb(path)
        origins = np.asarray(origins)  # already tile coords
        if values.ndim == 5:  # [n,8,8,8,3] vector grid -> magnitude
            values = np.linalg.norm(values, axis=-1)
    elif path.endswith(".vdb"):
        from hnanosolver_tpu_torch.io.vdb import read_vdb

        g = read_vdb(path)[0]
        name, origins, values = g["name"], g["origins"], g["values"]
        origins = np.asarray(origins) // C.LEAF  # voxel -> tile coords
        if values.ndim == 3:  # [3,N,512] vector grid -> magnitude
            values = np.linalg.norm(values, axis=0)
    else:
        raise ValueError(f"unsupported volume file: {path}")
    lo = origins.min(axis=0)
    hi = origins.max(axis=0) + 1
    dims = tuple(int(x) * C.LEAF for x in (hi - lo))
    dense = np.zeros(dims, np.float32)
    blocks = values.reshape(-1, C.LEAF, C.LEAF, C.LEAF)
    for (tx, ty, tz), b in zip(origins - lo, blocks):
        dense[tx * C.LEAF:(tx + 1) * C.LEAF, ty * C.LEAF:(ty + 1) * C.LEAF,
              tz * C.LEAF:(tz + 1) * C.LEAF] = b
    return VolumeSource({name or "density": dense})


# ---------------------------------------------------------------------------
# The front end: the JAX package's WebGL2 (TEXTURE_3D) raymarcher page.
# ---------------------------------------------------------------------------

PAGE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>hnanosolver-tpu viewer</title>
<style>
  body { margin:0; background:#101014; color:#cfd2d6; font:13px monospace; overflow:hidden }
  #hud { position:fixed; top:10px; left:10px; background:#1a1c22cc; padding:10px 14px;
         border-radius:6px; min-width:230px }
  #hud div { margin:3px 0 }
  input[type=range] { width:120px; vertical-align:middle }
  button { background:#2a2d36; color:#cfd2d6; border:1px solid #444; border-radius:4px;
           padding:2px 10px; margin-right:6px; cursor:pointer }
  canvas { display:block }
</style></head>
<body>
<canvas id="gl"></canvas>
<div id="hud">
  <div><b>hnanosolver-tpu viewer</b></div>
  <div id="perf">render: - ms (- fps)</div>
  <div id="sim"></div>
  <div>density <input id="dscale" type="range" min="0.1" max="12" step="0.1" value="4">
       <span id="dscale_v">4.0</span></div>
  <div>steps <input id="steps" type="range" min="32" max="512" step="32" value="256">
       <span id="steps_v">256</span></div>
  <div>emission <input id="emit" type="range" min="0" max="8" step="0.1" value="2">
       <span id="emit_v">2.0</span></div>
  <div id="livectl" style="display:none">
    <button id="bstep">Step</button><button id="bplay">Play</button>
    <span id="frame"></span>
  </div>
  <div style="opacity:.55">drag: orbit &middot; wheel: zoom</div>
</div>
<script>
const canvas = document.getElementById('gl');
const gl = canvas.getContext('webgl2');
if (!gl) document.body.innerHTML = 'WebGL2 required';

const VS = `#version 300 es
in vec2 aPos; out vec2 vUV;
void main(){ vUV = aPos; gl_Position = vec4(aPos, 0.0, 1.0); }`;

const FS = `#version 300 es
precision highp float; precision highp sampler3D;
in vec2 vUV; out vec4 frag;
uniform sampler3D uDen; uniform sampler3D uEmit;
uniform vec3 uCam, uRight, uUp, uFwd;
uniform float uAspect, uDScale, uEScale; uniform int uSteps; uniform int uHasEmit;
void main(){
  vec3 dir = normalize(uFwd + vUV.x*uAspect*uRight + vUV.y*uUp);
  // slab intersection with the unit box [0,1]^3
  vec3 inv = 1.0/dir;
  vec3 t0 = (vec3(0.0)-uCam)*inv, t1 = (vec3(1.0)-uCam)*inv;
  vec3 tsm = min(t0,t1), tlg = max(t0,t1);
  float tmin = max(max(tsm.x,tsm.y), max(tsm.z,0.0));
  float tmax = min(min(tlg.x,tlg.y), tlg.z);
  vec3 col = vec3(0.0); float a = 0.0;
  if (tmin < tmax) {
    float dt = 1.732/float(uSteps);
    float t = tmin;
    for (int i=0; i<512; ++i) {
      if (i >= uSteps || t >= tmax || a >= 0.95) break;
      vec3 p = uCam + t*dir;
      float d = texture(uDen, p).r * uDScale * dt;
      float da = clamp(d, 0.0, 1.0) * (1.0-a);
      vec3 c = vec3(0.85);
      if (uHasEmit == 1) {
        float e = texture(uEmit, p).r * uEScale;
        c += vec3(1.6, 0.55, 0.12) * e;
      }
      col += c*da; a += da; t += dt;
    }
  }
  vec3 bg = mix(vec3(0.05,0.05,0.07), vec3(0.10,0.10,0.13), 0.5*(vUV.y+1.0));
  frag = vec4(col + bg*(1.0-a), 1.0);
}`;

function shader(type, src){ const s = gl.createShader(type); gl.shaderSource(s, src);
  gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS)) throw gl.getShaderInfoLog(s);
  return s; }
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog); gl.useProgram(prog);
const quad = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, quad);
gl.bufferData(gl.ARRAY_BUFFER, new Float32Array([-1,-1, 3,-1, -1,3]), gl.STATIC_DRAW);
const loc = gl.getAttribLocation(prog, 'aPos');
gl.enableVertexAttribArray(loc); gl.vertexAttribPointer(loc, 2, gl.FLOAT, false, 0, 0);
const U = n => gl.getUniformLocation(prog, n);

function makeTex(unit){ const t = gl.createTexture();
  gl.activeTexture(gl.TEXTURE0+unit); gl.bindTexture(gl.TEXTURE_3D, t);
  for (const [k,v] of [[gl.TEXTURE_MIN_FILTER, gl.LINEAR],[gl.TEXTURE_MAG_FILTER, gl.LINEAR],
      [gl.TEXTURE_WRAP_S, gl.CLAMP_TO_EDGE],[gl.TEXTURE_WRAP_T, gl.CLAMP_TO_EDGE],
      [gl.TEXTURE_WRAP_R, gl.CLAMP_TO_EDGE]]) gl.texParameteri(gl.TEXTURE_3D, k, v);
  return t; }
const denTex = makeTex(0), emitTex = makeTex(1);
let hasEmit = 0, meta = null;

async function loadField(name, unit, tex){
  const dims = meta.fields[name].dims;
  const buf = await (await fetch('/volume?field='+name)).arrayBuffer();
  gl.activeTexture(gl.TEXTURE0+unit); gl.bindTexture(gl.TEXTURE_3D, tex);
  gl.pixelStorei(gl.UNPACK_ALIGNMENT, 1);
  gl.texImage3D(gl.TEXTURE_3D, 0, gl.R8, dims[0], dims[1], dims[2], 0,
                gl.RED, gl.UNSIGNED_BYTE, new Uint8Array(buf));
}
async function refresh(){
  meta = await (await fetch('/meta')).json();
  await loadField('density', 0, denTex);
  hasEmit = meta.fields.flame ? 1 : 0;
  if (hasEmit) await loadField('flame', 1, emitTex);
  document.getElementById('livectl').style.display = meta.live ? 'block' : 'none';
  document.getElementById('frame').textContent = 'frame ' + meta.frame;
  if (meta.live) document.getElementById('sim').textContent =
      'sim step: ' + meta.step_ms + ' ms';
  draw();
}

let az = 0.7, el = 0.35, dist = 2.4;
function draw(){
  canvas.width = innerWidth; canvas.height = innerHeight;
  gl.viewport(0, 0, canvas.width, canvas.height);
  const c = [0.5,0.5,0.5];
  const cam = [c[0]+dist*Math.cos(el)*Math.cos(az), c[1]+dist*Math.sin(el),
               c[2]+dist*Math.cos(el)*Math.sin(az)];
  let fwd = [c[0]-cam[0], c[1]-cam[1], c[2]-cam[2]];
  const fl = Math.hypot(...fwd); fwd = fwd.map(x=>x/fl);
  let right = [ -Math.sin(az), 0, Math.cos(az) ];
  let up = [ fwd[1]*right[2]-fwd[2]*right[1], fwd[2]*right[0]-fwd[0]*right[2],
             fwd[0]*right[1]-fwd[1]*right[0] ];
  const t0 = performance.now();
  gl.uniform3fv(U('uCam'), cam); gl.uniform3fv(U('uFwd'), fwd.map(x=>x*1.2));
  gl.uniform3fv(U('uRight'), right); gl.uniform3fv(U('uUp'), up);
  gl.uniform1f(U('uAspect'), canvas.width/canvas.height);
  gl.uniform1f(U('uDScale'), +dscale.value);
  gl.uniform1f(U('uEScale'), +emit.value);
  gl.uniform1i(U('uSteps'), +steps.value);
  gl.uniform1i(U('uHasEmit'), hasEmit);
  gl.uniform1i(U('uDen'), 0); gl.uniform1i(U('uEmit'), 1);
  gl.drawArrays(gl.TRIANGLES, 0, 3);
  gl.finish();
  const ms = performance.now() - t0;
  document.getElementById('perf').textContent =
    'render: ' + ms.toFixed(1) + ' ms (' + (1000/Math.max(ms,0.01)).toFixed(0) + ' fps)';
}

let drag = null;
canvas.onmousedown = e => drag = [e.clientX, e.clientY];
window.onmouseup = () => drag = null;
window.onmousemove = e => { if (!drag) return;
  az += (e.clientX - drag[0]) * 0.008; el += (e.clientY - drag[1]) * 0.008;
  el = Math.max(-1.5, Math.min(1.5, el)); drag = [e.clientX, e.clientY]; draw(); };
canvas.onwheel = e => { dist *= Math.exp(e.deltaY * 0.001);
  dist = Math.max(0.4, Math.min(8, dist)); draw(); e.preventDefault(); };
for (const id of ['dscale','steps','emit'])
  document.getElementById(id).oninput = () => {
    document.getElementById(id+'_v').textContent = (+document.getElementById(id).value).toFixed(1);
    draw(); };
window.onresize = draw;

let playing = false;
document.getElementById('bstep').onclick = async () => {
  await fetch('/step?n=1'); await refresh(); };
document.getElementById('bplay').onclick = async function(){
  playing = !playing; this.textContent = playing ? 'Pause' : 'Play';
  while (playing) { await fetch('/step?n=1'); await refresh(); } };

refresh();
</script></body></html>
"""


class _Handler(BaseHTTPRequestHandler):
    source: VolumeSource = None  # set by serve()

    def log_message(self, *a):  # quiet
        pass

    def _send(self, code, ctype, body: bytes):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server API)
        from urllib.parse import parse_qs, urlparse

        url = urlparse(self.path)
        if url.path == "/":
            self._send(200, "text/html", PAGE.encode())
        elif url.path == "/meta":
            self._send(200, "application/json", json.dumps(self.source.meta()).encode())
        elif url.path == "/volume":
            field = parse_qs(url.query).get("field", ["density"])[0]
            if field not in self.source.volumes:
                self._send(404, "text/plain", b"no such field")
            else:
                self._send(200, "application/octet-stream", self.source.payload(field))
        elif url.path == "/step" and self.source.live:
            n = int(parse_qs(url.query).get("n", ["1"])[0])
            self.source.step(max(1, min(n, 24)))
            self._send(200, "application/json",
                       json.dumps({"frame": self.source.frame}).encode())
        else:
            self._send(404, "text/plain", b"not found")


def serve(source: VolumeSource, port: int = 8642, block: bool = True
          ) -> Tuple[ThreadingHTTPServer, threading.Thread]:
    """Start the viewer server on 127.0.0.1 (``port`` 0: a free port, read
    back from ``httpd.server_address[1]``) and print its address. With
    ``block`` it serves until interrupted; else the caller shuts ``httpd``
    down."""
    handler = type("Handler", (_Handler,), {"source": source})
    httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    print(f"viewer: http://localhost:{httpd.server_address[1]}/ "
          f"({'live' if source.live else 'static'})", flush=True)
    if block:
        try:
            thread.join()
        except KeyboardInterrupt:
            httpd.shutdown()
    return httpd, thread
