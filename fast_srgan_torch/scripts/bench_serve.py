"""The HTTP serving layer end to end on the port: concurrent clients, one
device.

    python -m fast_srgan_torch.scripts.bench_serve [--device cuda]
    CONCURRENCY=16 REQUESTS=8 SHAPE=90x160,180x320,270x480 MAX_BATCH=8 \\
        MAX_WAIT_MS=5 INT8=0   (environment)

The counterpart of ``scripts/bench_serve.py``. It starts the port's server
(``serving.make_server``) in-process on an ephemeral port in front of the
pretrained 4x engine (bf16, or ``INT8=1`` the int8 ``ups`` tier; bucket
32, as ``python -m fast_srgan_torch.serve`` runs it). ``CONCURRENCY``
client threads each post ``REQUESTS`` PNG-encoded LR frames (one noise
frame a shape, seed 0), rotating through the ``SHAPE`` list. Prints one
JSON object:

  * ``p50_ms``, ``p90_ms``, ``p99_ms``: request latency on the host clock,
    client to client: PNG decode, the micro-batch wait, the device forward,
    PNG encode and HTTP both ways;
  * ``value`` (requests/s) across the load phase; ``errors``, and
    ``replies_200`` of ``requests``;
  * ``batch_fill``: requests a device batch during the load, from
    ``/stats``;
  * ``new_batch_shapes``: the (batch, padded height, padded width) input
    shapes the engine first ran during the load phase
    (``engine.batch_shapes``); 0 means warm-up covered the traffic. On
    the card the first run of a shape pays cuDNN's choice of algorithms
    for its convs and the IN kernels' plan; it is the counterpart of the
    JAX script's ``cold_compiles`` (jit-cache misses).

Warm-up is the server's start-up ladder (``serve.py``: one
``upscale_images`` call of a blank frame a shape), run at every batch size
the micro-batcher can form (1 to ``MAX_BATCH``), then one request a shape
whose reply must decode at 4x the shape.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from fast_srgan_torch.infer import load_generator_params, resolve_default_checkpoint
from fast_srgan_torch.inference import SRInferenceEngine
from fast_srgan_torch.scripts.measure import emit, script_device
from fast_srgan_torch.serve import warm_shapes
from fast_srgan_torch.serving import make_server


def _png(frame: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="PNG")
    return buf.getvalue()


def main(argv=None) -> dict:
    from PIL import Image

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = script_device(args.device)
    concurrency = int(os.environ.get("CONCURRENCY", "16"))
    n_requests = int(os.environ.get("REQUESTS", "8"))  # per client
    shapes = warm_shapes(os.environ.get("SHAPE", "180x320"))
    max_batch = int(os.environ.get("MAX_BATCH", "8"))
    max_wait_ms = float(os.environ.get("MAX_WAIT_MS", "5"))
    int8 = os.environ.get("INT8", "0") == "1"

    engine = SRInferenceEngine(load_generator_params(resolve_default_checkpoint()),
                               dtype=torch.bfloat16, device=device, bucket=32, quantize=int8)
    scale = engine.SCALE
    for h, w in shapes:
        for b in range(1, max_batch + 1):
            engine.upscale_images([np.zeros((h, w, 3), np.uint8)] * b, batch_size=max_batch)
    server = make_server(engine, port=0, max_batch=max_batch, max_wait_ms=max_wait_ms)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"

    rng = np.random.default_rng(0)
    bodies = [_png(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) for h, w in shapes]

    def post(body: bytes) -> bytes:
        req = urllib.request.Request(f"{base}/upscale", data=body,
                                     headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.read()

    def stats() -> dict:
        with urllib.request.urlopen(f"{base}/stats", timeout=60) as resp:
            return json.loads(resp.read())

    try:
        for (h, w), body in zip(shapes, bodies):
            size = Image.open(io.BytesIO(post(body))).size
            if size != (scale * w, scale * h):
                raise SystemExit(f"reply of {size} for a {h}x{w} request")
        shapes_before = set(engine.batch_shapes)
        lock = threading.Lock()
        latencies: list = []
        errors: list = []

        def client(cid: int) -> None:
            for i in range(n_requests):
                body = bodies[(cid + i) % len(bodies)]
                t0 = time.perf_counter()
                try:
                    post(body)
                except (urllib.error.URLError, OSError) as e:  # a non-200 reply too
                    with lock:
                        errors.append(repr(e))
                    continue
                dt = time.perf_counter() - t0
                with lock:
                    latencies.append(dt)

        stats0 = stats()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(concurrency)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = time.perf_counter() - t0
        stats1 = stats()
    finally:
        server.shutdown()
        server.batcher.close()
        thread.join(timeout=30)

    total = len(latencies)
    lat_ms = np.sort(np.asarray(latencies)) * 1e3 if total else np.zeros(1)
    d_req = stats1["requests"] - stats0["requests"]
    d_batches = max(1, stats1["batches"] - stats0["batches"])
    tag = "_".join(f"{h}x{w}" for h, w in shapes)
    return emit({
        "metric": f"serve_rps_{tag}_c{concurrency}",
        "value": round(total / elapsed, 2),
        "unit": "req/s",
        "mode": "int8_ups" if int8 else "bf16",
        "new_batch_shapes": len(engine.batch_shapes - shapes_before),
        "p50_ms": round(float(lat_ms[total // 2 if total else 0]), 2),
        "p90_ms": round(float(lat_ms[int(total * 0.9) if total else 0]), 2),
        "p99_ms": round(float(lat_ms[min(total - 1, int(total * 0.99)) if total else 0]), 2),
        "batch_fill": round(d_req / d_batches, 2),
        "max_batch": max_batch,
        "max_wait_ms": max_wait_ms,
        "requests": concurrency * n_requests,
        "replies_200": total,
        "errors": len(errors),
        "first_error": errors[0] if errors else None,
    }, device)


if __name__ == "__main__":
    main()
