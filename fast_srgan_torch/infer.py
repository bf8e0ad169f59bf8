"""Upscale a directory of images with the PyTorch port.

    python -m fast_srgan_torch.infer --image_dir D --output_dir O
        [--checkpoint X.npz] [--batch_size N] [--fp32] [--device cuda]

Loads the generator from a native ``.npz`` checkpoint (default
``models/generator_pretrained.npz``), reads png/jpg/jpeg files
case-insensitively, upscales each at its own resolution, and writes the
result under the same name in the output directory.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from fast_srgan_torch.checkpoints.npz_io import load_npz_params
from fast_srgan_torch.inference import SRInferenceEngine

DEFAULT_CHECKPOINT = "models/generator_pretrained.npz"
IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg")


def upscale_directory(
    engine: SRInferenceEngine, image_dir: str, output_dir: str, batch_size: int
) -> int:
    """Upscale every image of ``image_dir`` into ``output_dir``; returns
    the number of images written."""
    from PIL import Image

    names = sorted(
        f for f in os.listdir(image_dir) if f.lower().endswith(IMAGE_EXTENSIONS)
    )
    os.makedirs(output_dir, exist_ok=True)
    paths = [os.path.join(image_dir, n) for n in names]
    for i, out in engine.upscale_files(paths, batch_size=batch_size):
        Image.fromarray(np.ascontiguousarray(out)).save(
            os.path.join(output_dir, names[i])
        )
    return len(names)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("Fast-SRGAN image super-resolution (PyTorch)")
    parser.add_argument("--image_dir", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--checkpoint", default=DEFAULT_CHECKPOINT)
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--fp32", action="store_true", help="fp32 compute (default bf16)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if not os.path.exists(args.checkpoint):
        raise SystemExit(f"checkpoint not found: {args.checkpoint!r}")
    engine = SRInferenceEngine(
        load_npz_params(args.checkpoint),
        dtype=torch.float32 if args.fp32 else torch.bfloat16,
        device=args.device,
    )
    t0 = time.perf_counter()
    n = upscale_directory(engine, args.image_dir, args.output_dir, args.batch_size)
    dt = time.perf_counter() - t0
    print(f"Done: {n} images in {dt:.2f}s on {engine.device}")


if __name__ == "__main__":
    main()
