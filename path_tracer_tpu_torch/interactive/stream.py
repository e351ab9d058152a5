"""HTTP live view: the stand-in for the reference's winit window
(main.rs:141-224, state.rs:557-586); port of
``path_tracer_tpu/interactive/stream.py``.

Serves the interactive session as a ``multipart/x-mixed-replace`` stream
any browser shows, with camera input over HTTP:

* ``GET /``            minimal HTML page: the stream + key/mouse capture
* ``GET /stream``      MJPEG: each part the next progressively accumulated
                       (or TAA-reprojected) frame, a JPEG at quality 88
* ``GET /key?k=w&dt=`` WASD camera move (`InteractiveRenderer.key`)
* ``GET /mouse?dx=&dy=&dt=`` look around (`InteractiveRenderer.mouse`)
* ``GET /resize?w=&h=`` surface resize (`InteractiveRenderer.resize`)
* ``GET /frame.png``   the current frame as PNG

The stream's parts are JPEG at quality 88 (``Content-Type: image/jpeg``),
as the JAX package sends them: the port's encoder (`utils.imageio`) writes
the file Pillow writes for the same pixels (the card's machine has no
Pillow). Each frame is quantized to uint8 on the device
(`InteractiveRenderer.display(as_uint8=True)`), as a swapchain takes it,
and encoded from those bytes; ``/frame.png`` encodes them as PNG.

The render loop runs in the request thread that holds ``/stream`` (one
renderer, one lock: input events only change the host camera, which the
next frame picks up, as in the reference's event loop).

Usage: python -m path_tracer_tpu_torch.interactive.stream --scene cornell_specular
       [--width 1024 --height 576] [--port 8642] [--device cuda]
"""

from __future__ import annotations

import argparse
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from path_tracer_tpu_torch.utils.imageio import encode_jpeg, encode_png

STREAM_QUALITY = 88  # the JAX package's MJPEG quality

_PAGE = b"""<!doctype html><html><body style="margin:0;background:#111">
<img id="v" src="/stream" style="display:block;margin:auto">
<script>
const q=(u)=>fetch(u).catch(()=>{});
window.addEventListener('keydown',e=>{
  if('wasd'.includes(e.key)) q('/key?k='+e.key+'&dt=0.000006');
});
let drag=false;
const v=document.getElementById('v');
v.addEventListener('mousedown',()=>drag=true);
window.addEventListener('mouseup',()=>drag=false);
window.addEventListener('mousemove',e=>{
  if(drag) q('/mouse?dx='+(e.movementX*2e-5)+'&dy='+(e.movementY*2e-5)+'&dt=0.0167');
});
</script></body></html>"""


def _frame(renderer) -> np.ndarray:
    return np.ascontiguousarray(renderer.display(as_uint8=True))


def make_server(renderer, host: str = "127.0.0.1", port: int = 8642,
                max_frames: int | None = None) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server around an `InteractiveRenderer`.
    ``max_frames`` bounds the stream's length (tests)."""
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _ok(self, ctype: str, body: bytes):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            q = parse_qs(u.query)

            def f(name, default=0.0):
                return float(q.get(name, [default])[0])

            if u.path == "/":
                self._ok("text/html", _PAGE)
            elif u.path == "/key":
                with lock:
                    renderer.key(q.get("k", ["w"])[0], f("dt", 1e-6))
                self._ok("text/plain", b"ok")
            elif u.path == "/mouse":
                with lock:
                    renderer.mouse(f("dx"), f("dy"), f("dt", 1.0 / 60.0))
                self._ok("text/plain", b"ok")
            elif u.path == "/resize":
                with lock:
                    renderer.resize(int(f("w", renderer.width)), int(f("h", renderer.height)))
                self._ok("text/plain", b"ok")
            elif u.path == "/frame.png":
                with lock:
                    png = encode_png(_frame(renderer))
                self._ok("image/png", png)
            elif u.path == "/stream":
                self.send_response(200)
                self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                n = 0
                while max_frames is None or n < max_frames:
                    with lock:
                        renderer.frame()
                        jpg = encode_jpeg(_frame(renderer), STREAM_QUALITY)
                    try:
                        self.wfile.write(b"--frame\r\nContent-Type: image/jpeg\r\n"
                                         + f"Content-Length: {len(jpg)}\r\n\r\n".encode())
                        self.wfile.write(jpg)
                        self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        return
                    n += 1
            else:
                self.send_response(404)
                self.end_headers()

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    ap = argparse.ArgumentParser(description="HTTP live view of an interactive session")
    ap.add_argument("--scene", default="cornell_specular")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=576)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8642)
    ap.add_argument("--max-bounces", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from path_tracer_tpu_torch import scenes
    from path_tracer_tpu_torch.interactive.session import InteractiveRenderer

    scene_host, cam = getattr(scenes, args.scene)(aspect=args.width / args.height)
    r = InteractiveRenderer(scene_host, cam, args.width, args.height,
                            max_bounces=args.max_bounces, device=args.device)
    srv = make_server(r, args.host, args.port)
    print(f"live view: http://{args.host}:{args.port}/  (WASD + drag to look)")
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
