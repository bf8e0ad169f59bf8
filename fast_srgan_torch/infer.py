"""Upscale a directory of images, or video files, with the PyTorch port.

    python -m fast_srgan_torch.infer --image_dir D --output_dir O
        [--checkpoint X.npz|X.pt] [--batch_size N] [--bucket N] [--fp32] [--int8]
        [--device cuda]
    python -m fast_srgan_torch.infer --video IN.mp4 [IN2.mp4 ...]
        (--video_out OUT.mp4 | --output_dir O) [--int8] [--device cuda]

Loads the generator from a native ``.npz`` checkpoint (default
``models/generator_pretrained.npz``) or a ``.pt`` generator state_dict
(the reference's, or the port trainer's ``generator_epoch_N.pt``:
``checkpoints.convert.load_generator_params``), reads png/jpg/jpeg files
case-insensitively, upscales each at its own resolution, and writes the
result under the same name in the output directory.

``--bucket N`` (default: the config's ``inference.bucket``, 0) zero-pads
each image to multiples of N LR pixels so mixed sizes share batches; exact
(the masked forward). ``--video`` streams one or more files of one frame
size through the engine (``video.py``); several share device batches.

``--int8`` serves the int8 PTQ tier (``quant.py``, ups-only): the int8
activation scales are calibrated on center crops of the first images (up
to 8 of at least 32x32), or on the synthetic batch when none is usable; for
video, on the first decoded frames of the streams.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from fast_srgan_torch import quant
from fast_srgan_torch.checkpoints.convert import load_generator_params
from fast_srgan_torch.config import default_config
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


def _upscale_videos(engine, parser, args) -> None:
    from fast_srgan_torch.video import upscale_video, upscale_videos

    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
    if len(args.video) == 1:
        out_path = args.video_out or os.path.join(
            args.output_dir, os.path.basename(args.video[0])
        )
        stats = upscale_video(engine, args.video[0], out_path, batch_size=args.batch_size)
        print(f"Done: {stats['frames']} frames in {stats['seconds']:.2f}s"
              f" ({stats['frames'] / max(stats['seconds'], 1e-9):.1f} fps) -> {out_path}")
        return
    if args.video_out is not None:
        parser.error("--video_out is for a single video; use --output_dir with several")
    if not args.output_dir:
        parser.error("several --video files need --output_dir")
    outs = [os.path.join(args.output_dir, os.path.basename(v)) for v in args.video]
    stats = upscale_videos(engine, args.video, outs, batch_size=args.batch_size)
    fps = stats["frames"] / max(stats["seconds"], 1e-9)
    print(f"Done: {len(args.video)} streams, {stats['frames']} frames"
          f" ({stats['per_stream']}) in {stats['seconds']:.2f}s ({fps:.1f} fps aggregate)"
          f" -> {args.output_dir}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("Fast-SRGAN image super-resolution (PyTorch)")
    parser.add_argument("--image_dir", default=None)
    parser.add_argument("--output_dir", default=None)
    parser.add_argument(
        "--video", default=None, nargs="+",
        help="upscale video file(s) of one frame size instead of an image directory",
    )
    parser.add_argument(
        "--video_out", default=None,
        help="output video path (default: <output_dir>/<video basename>)",
    )
    parser.add_argument("--checkpoint", default=DEFAULT_CHECKPOINT)
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument(
        "--bucket", default=None, type=int,
        help="zero-pad LR inputs to multiples of this so mixed sizes share batches;"
        " exact via the masked forward (default: the config's inference.bucket)",
    )
    parser.add_argument("--fp32", action="store_true", help="fp32 compute (default bf16)")
    parser.add_argument(
        "--int8", action="store_true",
        help="int8 PTQ tier (ups-only), calibrated on the input images or frames",
    )
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.video is None and (args.image_dir is None or args.output_dir is None):
        parser.error("--image_dir and --output_dir are required (or use --video)")
    if args.video is not None:
        if args.bucket:
            parser.error("--video does not take --bucket (a stream's frames share one size)")
        if args.video_out is None and args.output_dir is None:
            parser.error("--video needs --video_out or --output_dir")
    bucket = default_config()["inference"]["bucket"] if args.bucket is None else args.bucket
    if not os.path.exists(args.checkpoint):
        raise SystemExit(f"checkpoint not found: {args.checkpoint!r}")
    calib = None
    if args.int8 and args.video is None:
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
        load_generator_params(args.checkpoint),
        dtype=torch.float32 if args.fp32 else torch.bfloat16,
        device=args.device,
        bucket=bucket,
        quantize=args.int8,
        calib_batches=calib,
    )
    if args.video is not None:
        _upscale_videos(engine, parser, args)
        return
    t0 = time.perf_counter()
    n = upscale_directory(engine, args.image_dir, args.output_dir, args.batch_size)
    dt = time.perf_counter() - t0
    print(f"Done: {n} images in {dt:.2f}s on {engine.device}")


if __name__ == "__main__":
    main()
