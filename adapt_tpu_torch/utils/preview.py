"""Live incremental preview over HTTP (copy of adapt_tpu/utils/preview.py;
reference render.py:129-152).

The reference shows progress in a taichi GUI window; a GPU host has no
display server either, so the headless equivalent is a tiny in-process HTTP
viewer: an auto-refreshing page serving the latest progressive frame.
stdlib-only (http.server + a daemon thread); PNG encoding via PIL.

Usage:
    srv = PreviewServer(port=8000)      # port=0 picks a free port
    ...
    srv.update(img_hw3_float, spp=n)    # each progressive iteration
    srv.stop()
"""
from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = b"""<!doctype html>
<html><head><title>adapt_tpu live preview</title>
<style>body{background:#111;color:#ddd;font-family:monospace;
text-align:center}img{image-rendering:pixelated;max-width:95vw;
max-height:85vh;border:1px solid #444}</style></head>
<body><h3 id="s">adapt_tpu</h3><img id="v" src="/frame.png">
<script>
async function tick(){
  try{
    const r = await fetch('/status'); const j = await r.json();
    document.getElementById('s').textContent =
      `${j.name} - ${j.spp} spp - ${j.w}x${j.h}`;
    document.getElementById('v').src = '/frame.png?' + j.version;
  }catch(e){}
  setTimeout(tick, 1000);
}
tick();
</script></body></html>
"""


class PreviewServer:
    def __init__(self, port: int = 0, name: str = "render",
                 host: str = "127.0.0.1", page: bytes | None = None,
                 routes: dict | None = None):
        """host defaults to loopback (the printed URL is localhost; the
        frames are unauthenticated — bind wider only deliberately, e.g.
        host='0.0.0.0' via ADAPT_PREVIEW_HOST).

        page: override the root HTML page. routes: {path_prefix:
        callable(path) -> (bytes, content_type)} extra GET handlers —
        scene_viz builds its interactive flythrough on these."""
        import os
        host = os.environ.get("ADAPT_PREVIEW_HOST", host)
        page = page or _PAGE
        routes = dict(routes or {})
        self._lock = threading.Lock()
        self._png = b""
        self._meta = {"spp": 0, "w": 0, "h": 0, "version": 0,
                      "name": name}
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    with outer._lock:
                        data = outer._png
                    if not data:
                        # no frame published yet — tell clients to retry
                        # instead of handing them a 200 with an empty body
                        self.send_response(503)
                        self.send_header("Retry-After", "1")
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Cache-Control", "no-store")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path.startswith("/status"):
                    with outer._lock:
                        data = json.dumps(outer._meta).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:
                    data, ctype = page, "text/html"
                    for prefix, fn in routes.items():
                        if self.path.startswith(prefix):
                            data, ctype = fn(self.path)
                            break
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Cache-Control", "no-store")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)

            def log_message(self, *a):      # quiet
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        self._last = 0.0

    def due(self, min_interval: float = 0.5) -> bool:
        """True if an update() now would publish (not be throttled).
        Callers should check BEFORE materializing the frame: rdr.image()
        forces a device->host sync, which would otherwise stall the
        dispatch-ahead pipeline every iteration just to drop the frame."""
        return time.monotonic() - self._last >= min_interval

    def update(self, img, spp: int, min_interval: float = 0.5):
        """Publish a (h, w, 3) float frame; throttled to min_interval s."""
        now = time.monotonic()
        if now - self._last < min_interval:
            return
        self._last = now
        import numpy as np
        from PIL import Image
        a = np.asarray(img)
        a = np.clip(a, 0.0, 1.0)
        buf = io.BytesIO()
        Image.fromarray((a * 255).astype(np.uint8)).save(buf, format="PNG")
        with self._lock:
            self._png = buf.getvalue()
            self._meta.update(spp=int(spp), h=int(a.shape[0]),
                              w=int(a.shape[1]))
            self._meta["version"] += 1

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
