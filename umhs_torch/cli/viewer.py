"""`umhs-torch-viewer`: a minimal interactive viewer, the ns-viewer surface
(port of umhs_tpu/cli/viewer.py).

The reference relies on nerfstudio's websocket viewer. This is a
dependency-free equivalent: a small HTTP server and an HTML orbit UI. The
browser asks for frames with orbit camera parameters; each request renders
one view through the trained model on the device (one request, one render)
and returns a PNG written by data/png.py. Output layers are the render
CLI's names (rgb, depth, accumulation, seg_pred, wv_i, abundances_i,
residual_i). GET / is the page, /outputs the layer names, /render?theta=
&phi=&radius=&fov=&output= a frame; a render error returns 500 with its
message.

Usage:
    python -m umhs_torch.cli.viewer --load-config outputs/<exp>/umhsnerf/config.yml \\
        [--port 7007] [--resolution 128] [--device cpu]

--port 0 binds a free port (make_server's caller reads it from
server.server_address).
"""

from __future__ import annotations

import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np

from . import load_trained, parse_options, split_device

_PAGE = """<!doctype html>
<html><head><title>umhs viewer</title><style>
body{background:#111;color:#ddd;font-family:monospace;margin:0;display:flex}
#panel{padding:12px;width:230px}#img{flex:1;display:flex;align-items:center;justify-content:center}
img{image-rendering:pixelated;max-width:95%;max-height:95vh}
label{display:block;margin-top:8px}select,input{width:100%}
</style></head><body>
<div id=panel>
<h3>umhs_torch viewer</h3>
<label>output <select id=output></select></label>
<label>theta <input type=range id=theta min=0 max=6.283 step=0.05 value=0.8></label>
<label>phi <input type=range id=phi min=-1.4 max=1.4 step=0.05 value=0.5></label>
<label>radius <input type=range id=radius min=0.3 max=3 step=0.05 value=1.0></label>
<label>fov <input type=range id=fov min=20 max=90 step=1 value=50></label>
<div id=status></div>
</div>
<div id=img><img id=frame></div>
<script>
let busy=false, dirty=true;
async function init(){
  const outs = await (await fetch('/outputs')).json();
  const sel = document.getElementById('output');
  for (const o of outs){const e=document.createElement('option');e.textContent=o;sel.appendChild(e);}
  sel.onchange=()=>{dirty=true}; tick();
}
for (const id of ['theta','phi','radius','fov'])
  document.getElementById(id).oninput=()=>{dirty=true};
async function tick(){
  if (dirty && !busy){
    busy=true; dirty=false;
    const q = new URLSearchParams();
    for (const id of ['theta','phi','radius','fov']) q.set(id, document.getElementById(id).value);
    q.set('output', document.getElementById('output').value || 'rgb');
    const t0 = performance.now();
    const r = await fetch('/render?'+q);
    const blob = await r.blob();
    document.getElementById('frame').src = URL.createObjectURL(blob);
    document.getElementById('status').textContent = `${(performance.now()-t0).toFixed(0)} ms`;
    busy=false;
  }
  setTimeout(tick, 60);
}
init();
</script></body></html>"""


class ViewerState:
    """The trainer and the view resolution; renders an orbit camera view."""

    def __init__(self, trainer, resolution: int = 128):
        self.trainer = trainer
        self.resolution = resolution
        self.lock = threading.Lock()

    def output_names(self):
        names = ["rgb", "depth", "accumulation"]
        config = self.trainer.model.config
        if "spectral" in config.method:
            bands = len(self.trainer.model.wavelengths)
            k = self.trainer.model.num_classes
            names += ["seg_pred"]
            names += [f"abundances_{i}" for i in range(k)]
            names += [f"wv_{i}" for i in range(0, bands, max(1, bands // 8))]
            if config.pred_specular:
                names += [f"residual_{i}" for i in range(0, bands, max(1, bands // 4))]
        return names

    def orbit_camera(self, theta: float, phi: float, radius: float, fov: float):
        """The view's camera: at `radius` from the origin, looking at it."""
        from ..data.synthetic import _look_at
        from .render import camera_dict

        h = w = self.resolution
        eye = radius * np.array(
            [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), np.sin(phi)])
        c2w = _look_at(eye, np.zeros(3))[:3]
        focal = 0.5 * h / np.tan(0.5 * np.deg2rad(fov))
        return camera_dict(c2w, focal, h, w, self.trainer.device)

    def render_view(self, theta: float, phi: float, radius: float, fov: float,
                    output: str = "rgb") -> np.ndarray:
        from .render import render_outputs, select_output

        cam = self.orbit_camera(theta, phi, radius, fov)
        with self.lock:
            outputs = render_outputs(self.trainer, cam, self.resolution, self.resolution)
        img = select_output(outputs, output)
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def make_handler(state: ViewerState):
    from ..data.png import png_bytes

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="text/html"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                self._send(200, _PAGE.encode())
            elif url.path == "/outputs":
                self._send(200, json.dumps(state.output_names()).encode(), "application/json")
            elif url.path == "/render":
                q = {k: v[0] for k, v in parse_qs(url.query).items()}
                try:
                    img = state.render_view(
                        float(q.get("theta", 0.8)),
                        float(q.get("phi", 0.5)),
                        float(q.get("radius", 1.0)),
                        float(q.get("fov", 50.0)),
                        q.get("output", "rgb"),
                    )
                    self._send(200, png_bytes(img), "image/png")
                except Exception as e:  # the server keeps serving; the UI shows why
                    self._send(500, f"render error: {e}".encode(), "text/plain")
            else:
                self._send(404, b"not found", "text/plain")

    return Handler


def make_server(argv=None, device="cuda") -> ThreadingHTTPServer:
    """The viewer's HTTP server for argv, bound but not yet serving; its
    ViewerState is `server.state`."""
    argv = list(sys.argv[1:] if argv is None else argv)
    argv, dev = split_device(argv, device)
    opts = parse_options(argv, "umhs-viewer")
    if "load_config" not in opts:
        raise ValueError("[umhs-viewer] --load-config is required")
    _, trainer = load_trained(Path(opts["load_config"]), dev)
    state = ViewerState(trainer, resolution=int(opts.get("resolution", 128)))
    server = ThreadingHTTPServer(("0.0.0.0", int(opts.get("port", 7007))), make_handler(state))
    server.state = state
    return server


def main(argv=None, device="cuda") -> None:
    server = make_server(argv, device)
    port = server.server_address[1]
    names = server.state.output_names()
    print(f"[umhs-viewer] serving on http://localhost:{port} "
          f"(outputs: {', '.join(names[:6])}, ...)")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
