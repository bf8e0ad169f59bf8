"""Upscale a directory of images with the PyTorch port.

    python -m fast_srgan_torch.infer --image_dir D --output_dir O
        [--checkpoint X.npz] [--batch_size N] [--fp32] [--int8] [--device cuda]

Loads the generator from a native ``.npz`` checkpoint (default
``models/generator_pretrained.npz``), reads png/jpg/jpeg files
case-insensitively, upscales each at its own resolution, and writes the
result under the same name in the output directory.

``--int8`` serves the int8 PTQ tier (``quant.py``, ups-only): the int8
activation scales are calibrated on center crops of the first images (up
to 8 of at least 32x32), or on the synthetic batch when none is usable.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from fast_srgan_torch import quant
from fast_srgan_torch.checkpoints.npz_io import load_npz_params
from fast_srgan_torch.inference import SRInferenceEngine, load_image

DEFAULT_CHECKPOINT = "models/generator_pretrained.npz"
IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg")


def image_names(image_dir: str):
    return sorted(
        f for f in os.listdir(image_dir) if f.lower().endswith(IMAGE_EXTENSIONS)
    )


def upscale_directory(
    engine: SRInferenceEngine, image_dir: str, output_dir: str, batch_size: int
) -> int:
    """Upscale every image of ``image_dir`` into ``output_dir``; returns
    the number of images written."""
    from PIL import Image

    names = image_names(image_dir)
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
    parser.add_argument(
        "--int8", action="store_true",
        help="int8 PTQ tier (ups-only), calibrated on the input images",
    )
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if not os.path.exists(args.checkpoint):
        raise SystemExit(f"checkpoint not found: {args.checkpoint!r}")
    calib = None
    if args.int8:
        paths = (os.path.join(args.image_dir, n) for n in image_names(args.image_dir))
        batch = quant.calibration_batch_from_images(load_image(p) for p in paths)
        if batch is None:
            print("int8: no input image of >= 32x32 RGB; calibrating on the synthetic batch")
        else:
            calib = [batch]
            print(
                f"int8: calibrating on {batch.shape[0]} center crop(s) of"
                f" {batch.shape[1]}x{batch.shape[2]} from the input images"
            )
    engine = SRInferenceEngine(
        load_npz_params(args.checkpoint),
        dtype=torch.float32 if args.fp32 else torch.bfloat16,
        device=args.device,
        quantize=args.int8,
        calib_batches=calib,
    )
    t0 = time.perf_counter()
    n = upscale_directory(engine, args.image_dir, args.output_dir, args.batch_size)
    dt = time.perf_counter() - t0
    print(f"Done: {n} images in {dt:.2f}s on {engine.device}")


if __name__ == "__main__":
    main()
