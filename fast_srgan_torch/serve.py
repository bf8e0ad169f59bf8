"""Batched HTTP super-resolution server on the PyTorch port.

    python -m fast_srgan_torch.serve [--host 127.0.0.1] [--port 8000]
        [--checkpoint X.npz|X.pt] [--config F] [--bucket 32] [--max_batch 8]
        [--max_wait_ms 5]
        [--fp32] [--int8 [--calib_dir DIR]] [--warm H1xW1,...|none]
        [--device cuda]

    curl -s --data-binary @input.png http://127.0.0.1:8000/upscale > out.png
    curl -s http://127.0.0.1:8000/healthz

Concurrent requests are micro-batched onto the device
(:class:`~fast_srgan_torch.serving.MicroBatcher`). Shape bucketing is on by
default, so requests of different sizes share one batch, exactly (the
masked forward). ``--int8`` serves the int8 ``ups`` tier, calibrated on
``--calib_dir``'s images when given, else on the synthetic batch.

``--config`` (default ``configs/config.yaml``, which may be absent; a file
given on the command line must exist) is read as the JAX server reads it.
The checkpoint sets the architecture, and the config's ``kernels:`` section
reaches no engine option: the port always runs its kernels on the card
(``infer``'s docstring says why).

Before it accepts traffic the server runs one request of each ``--warm``
shape, so no live request pays the first use of a shape: on the card, the
kernels' nvcc build (once a process) and cuDNN's choice of algorithm for
each conv shape.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Tuple

import numpy as np
import torch

from fast_srgan_torch import quant
from fast_srgan_torch.config import load_config
from fast_srgan_torch.infer import (
    DEFAULT_CONFIG,
    image_names,
    load_generator_params,
    resolve_default_checkpoint,
)
from fast_srgan_torch.inference import SRInferenceEngine, load_image
from fast_srgan_torch.serving import make_server

#: The warm ladder: common 16:9 streaming input sizes, 90p to 540p.
DEFAULT_WARM = "90x160,180x320,270x480,360x640,540x960"


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser("Fast-SRGAN HTTP server (PyTorch)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", default=8000, type=int)
    parser.add_argument(
        "--checkpoint", default=None,
        help="a .npz or .pt generator (default: the first of infer.DEFAULT_CHECKPOINTS"
        " that exists)",
    )
    parser.add_argument(
        "--config", default=DEFAULT_CONFIG,
        help="config file (the default may be absent; a file given must exist); the"
        " architecture comes from the checkpoint",
    )
    parser.add_argument(
        "--bucket", default=32, type=int,
        help="shape-bucket granularity in LR pixels (exact; 0: each request size as it is)",
    )
    parser.add_argument("--max_batch", default=8, type=int)
    parser.add_argument(
        "--max_wait_ms", default=5.0, type=float,
        help="how long a request waits for batch-mates before it runs",
    )
    parser.add_argument("--fp32", action="store_true", help="fp32 compute (default bf16)")
    parser.add_argument(
        "--int8", action="store_true",
        help="int8 PTQ tier (ups-only), bucketed exactly like the float tier",
    )
    parser.add_argument(
        "--calib_dir", default=None,
        help="images to calibrate the int8 activation scales on (--int8 only;"
        " default: the synthetic calibration batch)",
    )
    parser.add_argument(
        "--warm", default=DEFAULT_WARM,
        help="comma-separated HxW LR shapes to run once before accepting"
        " traffic, or 'none'",
    )
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def warm_shapes(spec: str) -> List[Tuple[int, int]]:
    """``"90x160,180x320"`` -> [(90, 160), (180, 320)]; ``"none"`` -> []."""
    if spec.strip().lower() == "none":
        return []
    shapes = []
    for item in spec.split(","):
        h, w = (int(v) for v in item.strip().lower().split("x"))
        shapes.append((h, w))
    return shapes


def build_server(args: argparse.Namespace):
    """The engine the flags ask for, warmed, behind a built (not started)
    server."""
    ckpt = args.checkpoint or resolve_default_checkpoint()
    try:
        load_config(args.config, required=args.config != DEFAULT_CONFIG)
    except FileNotFoundError as e:
        raise SystemExit(f"--config: {e}") from None
    params = load_generator_params(ckpt)
    calib = None
    if args.int8 and args.calib_dir:
        batch = quant.calibration_batch_from_images(
            load_image(os.path.join(args.calib_dir, n)) for n in image_names(args.calib_dir)
        )
        if batch is None:
            raise SystemExit(f"--calib_dir {args.calib_dir}: no usable image of >= 32x32")
        calib = [batch]
    engine = SRInferenceEngine(
        params,
        dtype=torch.float32 if args.fp32 else torch.bfloat16,
        device=args.device,
        bucket=args.bucket,
        quantize=args.int8,
        calib_batches=calib,
    )
    for h, w in warm_shapes(args.warm):
        print(f"warming {h}x{w} ...", flush=True)
        engine.upscale_images([np.zeros((h, w, 3), np.uint8)], batch_size=args.max_batch)
    return make_server(engine, host=args.host, port=args.port,
                       max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)


def main(argv=None) -> None:
    args = parse_args(argv)
    server = build_server(args)
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port} (bucket={args.bucket},"
          f" max_batch={args.max_batch}{', int8' if args.int8 else ''},"
          f" device={server.batcher.engine.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.batcher.close()


if __name__ == "__main__":
    main()
