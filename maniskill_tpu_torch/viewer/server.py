"""HTTP/MJPEG viewer server (counterpart of maniskill_tpu/viewer/server.py).

Standard library only, with the port's own JPEG encoder (``viewer/jpeg.py``):
a ThreadingHTTPServer streams the latest frame as multipart/x-mixed-replace
JPEG on ``/stream``, serves the page on ``/``, the status JSON on
``/api/status``, and collects browser input events (``POST /api/event``:
keys, click-drag, wheel) into a thread-safe queue that the simulation loop
drains once per step. The server never touches the env or a device tensor;
the sim loop stays in charge.

Usage (see examples/teleoperation/interactive_panda.py --browser):

    viewer = BrowserViewer(port=8400)
    while True:
        for ev in viewer.poll_events():
            ...  # map to actions
        env.step(action)
        viewer.push_frame(env.render()[0])
        viewer.set_status({"step": t, "success": bool(...)})
"""
from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .jpeg import encode_jpeg

_PAGE = """<!DOCTYPE html>
<html><head><title>maniskill_tpu_torch viewer</title><style>
body { background: #111; color: #ddd; font: 13px monospace; margin: 0; }
#wrap { display: flex; flex-direction: column; align-items: center; }
#frame { margin-top: 8px; border: 1px solid #333; cursor: crosshair;
         image-rendering: pixelated; max-width: 95vw; }
#status { white-space: pre; margin: 6px; color: #8c8; }
#help { color: #777; margin: 4px; }
</style></head><body><div id="wrap">
<img id="frame" src="/stream" draggable="false">
<div id="status"></div>
<div id="help">keys: w/s=&plusmn;x a/d=&plusmn;y r/f=&plusmn;z q/e=yaw g=gripper
 x=reset &mdash; drag=move in camera plane, wheel=z</div>
</div><script>
function send(ev) {
  fetch('/api/event', {method: 'POST', body: JSON.stringify(ev)});
}
document.addEventListener('keydown', (e) => {
  if (e.repeat) { send({type: 'key', key: e.key}); return; }
  send({type: 'key', key: e.key});
});
const img = document.getElementById('frame');
let drag = null;
img.addEventListener('mousedown', (e) => { drag = [e.clientX, e.clientY]; });
document.addEventListener('mouseup', () => { drag = null; });
document.addEventListener('mousemove', (e) => {
  if (!drag) return;
  const dx = (e.clientX - drag[0]) / img.clientWidth;
  const dy = (e.clientY - drag[1]) / img.clientHeight;
  drag = [e.clientX, e.clientY];
  send({type: 'drag', dx: dx, dy: dy});
});
img.addEventListener('wheel', (e) => {
  e.preventDefault();
  send({type: 'wheel', dz: Math.sign(e.deltaY)});
}, {passive: false});
setInterval(async () => {
  const r = await fetch('/api/status');
  document.getElementById('status').textContent = await r.text();
}, 500);
</script></body></html>
"""


class _State:
    """Shared between the HTTP handler threads and the sim loop."""

    def __init__(self):
        self.frame_jpeg: bytes | None = None
        self.frame_id = 0
        self.cond = threading.Condition()
        self.events: "queue.Queue[dict]" = queue.Queue(maxsize=512)
        self.status = "{}"
        self.closed = False  # set by close(): open streams end


class _Handler(BaseHTTPRequestHandler):
    state: _State  # set by BrowserViewer

    def log_message(self, *a):  # quiet
        pass

    def _send(self, body: bytes, content_type: str):
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/" or self.path.startswith("/index"):
            self._send(_PAGE.encode(), "text/html")
        elif self.path == "/stream":
            self.send_response(200)
            self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=f")
            self.end_headers()
            last = -1
            try:
                while True:
                    with self.state.cond:
                        self.state.cond.wait_for(lambda: self.state.frame_id != last or self.state.closed,
                                                 timeout=5.0)
                        if self.state.closed:
                            return
                        jpeg, last = self.state.frame_jpeg, self.state.frame_id
                    if jpeg is None:
                        continue
                    self.wfile.write(b"--f\r\nContent-Type: image/jpeg\r\n")
                    self.wfile.write(f"Content-Length: {len(jpeg)}\r\n\r\n".encode())
                    self.wfile.write(jpeg)
                    self.wfile.write(b"\r\n")
            except (BrokenPipeError, ConnectionResetError):
                return
        elif self.path == "/api/status":
            self._send(self.state.status.encode(), "application/json")
        else:
            self.send_error(404)

    def do_POST(self):
        if self.path == "/api/event":
            n = int(self.headers.get("Content-Length", 0))
            try:
                self.state.events.put_nowait(json.loads(self.rfile.read(n)))
            except (json.JSONDecodeError, queue.Full):
                pass
            self.send_response(204)
            self.end_headers()
        else:
            self.send_error(404)


class BrowserViewer:
    """MJPEG viewer and teleoperation event sink on a background thread.

    The sim loop calls :meth:`push_frame` with an (H, W, 3) image and
    :meth:`poll_events` once per step; browsers at ``http://host:port`` see
    the stream live and their input arrives as event dicts:
    ``{"type": "key", "key": "w"}``, ``{"type": "drag", "dx": .., "dy": ..}``,
    ``{"type": "wheel", "dz": +-1}``. ``port=0`` takes a free port
    (``viewer.port`` says which).
    """

    def __init__(self, port: int = 8400, host: str = "0.0.0.0", quality: int = 85):
        self.state = _State()
        self.quality = quality
        handler = type("Handler", (_Handler,), {"state": self.state})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def push_frame(self, rgb):
        """Publish one frame: an (H, W, 3) uint8 array, or floats in [0, 1];
        a tensor is read back to the host first."""
        if hasattr(rgb, "cpu"):
            rgb = rgb.cpu().numpy()
        rgb = np.asarray(rgb)
        if rgb.dtype != np.uint8:
            rgb = np.clip(rgb * 255, 0, 255).astype(np.uint8)
        jpeg = encode_jpeg(rgb, self.quality)
        with self.state.cond:
            self.state.frame_jpeg = jpeg
            self.state.frame_id += 1
            self.state.cond.notify_all()

    def poll_events(self) -> list[dict]:
        out = []
        while True:
            try:
                out.append(self.state.events.get_nowait())
            except queue.Empty:
                return out

    def set_status(self, status: dict):
        self.state.status = json.dumps(status, default=str)

    def close(self):
        with self.state.cond:
            self.state.closed = True
            self.state.cond.notify_all()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)
