"""HTTP serving with cross-request micro-batching in front of
:class:`SRInferenceEngine`.

The port of ``fast_srgan_tpu/serving.py``. Requests land in a queue; one
worker thread (:class:`MicroBatcher`) owns the engine, blocks for the first
request, gives stragglers ``max_wait_ms`` to join, and runs up to
``max_batch`` images as one ``engine.upscale_images`` call, which batches
same-shape images together (same-bucket ones, with the engine's
``bucket``). :func:`make_server` puts a stdlib HTTP daemon in front:

  POST /upscale   body: an image (PNG, JPEG) -> image/png (lossless)
  GET  /healthz   {"status": "ok"}
  GET  /stats     the batcher's counters and the uptime

400 for a body that is not an image, 404 for another path, 413 for a body
over ``max_body_bytes``, 500 for an engine error. The server CLI is
``python -m fast_srgan_torch.serve``.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np


class _Pending:
    __slots__ = ("image", "done", "result", "error")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.done = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None


class MicroBatcher:
    """Coalesce concurrent ``submit`` calls into engine batches."""

    def __init__(
        self,
        engine,
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        request_timeout: float = 600.0,
    ):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.request_timeout = request_timeout
        self.queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "errors": 0}
        self._stop = threading.Event()
        # serializes enqueue against close(): a submit() that passed the
        # _stop check cannot enqueue after close() drained the queue
        self._submit_lock = threading.Lock()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, image: np.ndarray, timeout: Optional[float] = None) -> np.ndarray:
        """Upscale one uint8 HWC image; blocks until its batch is done."""
        timeout = self.request_timeout if timeout is None else timeout
        item = _Pending(image)
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("batcher is shutting down")
            self.queue.put(item)
        if not item.done.wait(timeout):
            raise TimeoutError("upscale timed out")
        if item.error is not None:
            raise item.error
        return item.result  # type: ignore[return-value]

    def close(self) -> None:
        """Stop the worker; fail any request still queued behind it."""
        with self._submit_lock:
            self._stop.set()
            self.queue.put(None)
        self._thread.join(timeout=30)
        while True:
            try:
                item = self.queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item.error = RuntimeError("batcher shut down")
                item.done.set()

    def _worker(self) -> None:
        while not self._stop.is_set():
            first = self.queue.get()
            if first is None:
                return
            batch: List[_Pending] = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self.queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._stop.set()
                    break
                batch.append(nxt)
            try:
                outs = self.engine.upscale_images(
                    [it.image for it in batch], batch_size=self.max_batch
                )
                if len(outs) != len(batch):
                    raise RuntimeError(
                        f"engine returned {len(outs)} outputs for {len(batch)} images"
                    )
                for it, out in zip(batch, outs):
                    it.result = out
            except Exception as e:  # surface to every waiter of the batch
                self.stats["errors"] += 1
                for it in batch:
                    it.error = e
            finally:
                self.stats["requests"] += len(batch)
                self.stats["batches"] += 1
                for it in batch:
                    it.done.set()


def make_server(
    engine,
    host: str = "127.0.0.1",
    port: int = 8000,
    max_batch: int = 8,
    max_wait_ms: float = 5.0,
    max_body_bytes: int = 64 * 1024 * 1024,
) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; its :class:`MicroBatcher` is
    ``server.batcher``. Start with ``server.serve_forever()``; stop with
    ``server.shutdown()``, then ``server.batcher.close()``."""
    from PIL import Image

    batcher = MicroBatcher(engine, max_batch=max_batch, max_wait_ms=max_wait_ms)
    started = time.time()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet: the counters are at /stats
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok"})
            elif self.path == "/stats":
                self._json(200, dict(batcher.stats, uptime_s=round(time.time() - started, 1)))
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/upscale":
                self._json(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length > max_body_bytes:
                    self._json(413, {"error": f"body over {max_body_bytes} bytes"})
                    return
                raw = self.rfile.read(length)
                with Image.open(io.BytesIO(raw)) as im:
                    img = np.asarray(im.convert("RGB"))
            except Exception as e:  # any undecodable body is the client's fault
                self._json(400, {"error": f"bad image: {e}"})
                return
            try:
                out = batcher.submit(img)
            except Exception as e:  # the engine's or the batcher's failure
                self._json(500, {"error": str(e)})
                return
            buf = io.BytesIO()
            Image.fromarray(np.ascontiguousarray(out)).save(buf, format="PNG")
            body = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer((host, port), Handler)
    server.batcher = batcher  # type: ignore[attr-defined]
    return server
