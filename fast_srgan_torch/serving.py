"""Cross-request micro-batching in front of :class:`SRInferenceEngine`.

The port of ``fast_srgan_tpu/serving.py:MicroBatcher`` (the HTTP front end,
``make_server``, is not ported yet). Requests land in a queue; one worker
thread owns the engine, blocks for the first request, gives stragglers
``max_wait_ms`` to join, and runs up to ``max_batch`` images as one
``engine.upscale_images`` call, which batches same-shape images together.
"""

from __future__ import annotations

import queue
import threading
import time
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
