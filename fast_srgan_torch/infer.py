"""Upscale a directory of images, or video files, with the PyTorch port.

    python -m fast_srgan_torch.infer --image_dir D --output_dir O
        [--checkpoint X.npz|X.pt] [--config F] [--batch_size N] [--bucket N | --tile N]
        [--fp32] [--int8] [--device cuda]
    python -m fast_srgan_torch.infer --video IN.mp4 [IN2.mp4 ...]
        (--video_out OUT.mp4 | --output_dir O) [--int8] [--device cuda]

Loads the generator from a native ``.npz`` checkpoint or a ``.pt``
generator state_dict (the reference's, or the port trainer's
``generator_epoch_N.pt``: ``checkpoints.convert.load_generator_params``);
without ``--checkpoint``, the first of ``DEFAULT_CHECKPOINTS`` that exists.
The checkpoint sets the architecture. It reads png/jpg/jpeg files
case-insensitively, upscales each at its own resolution, and writes the
result under the same name in the output directory.

``--config`` (default ``configs/config.yaml``, which may be absent; a file
given on the command line must exist) supplies the defaults of
``--batch_size``, ``--tile`` and ``--bucket`` (its ``inference:``
section; a flag given wins). Its ``kernels:`` section has nothing for the
engine: the JAX engine's ``use_pallas`` picks kernels the port always
runs on the card, and ``fused_upsample`` is a training option (the
engine's LR-domain tail has no upsample stage to fuse).

``--bucket N`` (default: the config's ``inference.bucket``, 0) zero-pads
each image to multiples of N LR pixels so mixed sizes share batches; exact
(the masked forward). ``--video`` streams one or more files of one frame
size through the engine (``video.py``); several share device batches.

``--tile N`` (default: the config's ``inference.tile``, 0) shards each
image's width across the first N cards (``parallel/spatial.py``: halo
exchange, instance-norm statistics over the whole frame; exact), one image
at a time; the width must divide by N. ``--device cpu`` has one device, so
N is 1 there. It excludes ``--bucket``, and ``--video`` takes neither.

``--int8`` serves the int8 PTQ tier (``quant.py``, ups-only): the int8
activation scales are calibrated on center crops of the first images (up
to 8 of at least 32x32), or on the synthetic batch when none is usable; for
video, on the first decoded frames of the streams. With ``--tile`` the
width-sharded int8 forward runs, on scales calibrated alike.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from fast_srgan_torch import quant
from fast_srgan_torch.checkpoints import convert
from fast_srgan_torch.config import load_config
from fast_srgan_torch.inference import SRInferenceEngine, arch_from_params, load_image
from fast_srgan_torch.parallel.mesh import Mesh, make_mesh

#: The no-flag checkpoint search, in order: the JAX package's ``infer.py``
#: list without its last entry, an absolute path outside the checkout,
#: where the port reads nothing.
DEFAULT_CHECKPOINTS = (
    "models/generator_pretrained.npz",
    "models/model.pt",
)
DEFAULT_CONFIG = "configs/config.yaml"
IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg")


def resolve_default_checkpoint() -> str:
    """The first entry of ``DEFAULT_CHECKPOINTS`` that exists (relative to
    the working directory), or SystemExit: the no-flag checkpoint policy of
    every CLI whose ``--checkpoint`` is optional."""
    ckpt = next((c for c in DEFAULT_CHECKPOINTS if os.path.exists(c)), None)
    if ckpt is None:
        raise SystemExit(
            "No checkpoint found; pass --checkpoint (searched: "
            + ", ".join(DEFAULT_CHECKPOINTS) + ")"
        )
    return ckpt


def load_generator_params(path: str):
    """Generator params (numpy tree) from a native ``.npz`` or a ``.pt``
    generator state_dict; SystemExit for a missing file."""
    try:
        return convert.load_generator_params(path)
    except FileNotFoundError as e:
        raise SystemExit(str(e)) from None


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


def tile_mesh(n: int, device: str) -> Mesh:
    """``--tile n``'s 1-D ``sp`` mesh: the first n cards, or the CPU (one
    device: n must be 1)."""
    if torch.device(device).type == "cpu":
        if n != 1:
            raise ValueError(f"requested {n} devices, have 1 (--device cpu)")
        return Mesh(["cpu"], ("sp",))
    return make_mesh(n, axis_name="sp")


def upscale_directory_tiled(
    params, image_dir: str, output_dir: str, mesh: Mesh, dtype: torch.dtype,
    act_scales=None,
) -> int:
    """Upscale every image of ``image_dir`` one at a time, width-sharded
    across ``mesh`` (int8 ``ups`` where ``act_scales`` are given); returns
    the number of images written."""
    from PIL import Image

    from fast_srgan_torch.parallel.spatial import tiled_quant_upscale_u8, tiled_upscale_u8

    names = image_names(image_dir)
    os.makedirs(output_dir, exist_ok=True)
    for name in names:
        image = load_image(os.path.join(image_dir, name))
        if act_scales is None:
            out = tiled_upscale_u8(params, image, mesh, dtype)
        else:
            out = tiled_quant_upscale_u8(params, act_scales, image, mesh, dtype)
        Image.fromarray(out).save(os.path.join(output_dir, name))
    return len(names)


def _upscale_videos(engine, parser, args, batch_size: int) -> None:
    from fast_srgan_torch.video import upscale_video, upscale_videos

    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
    if len(args.video) == 1:
        out_path = args.video_out or os.path.join(
            args.output_dir, os.path.basename(args.video[0])
        )
        stats = upscale_video(engine, args.video[0], out_path, batch_size=batch_size)
        print(f"Done: {stats['frames']} frames in {stats['seconds']:.2f}s"
              f" ({stats['frames'] / max(stats['seconds'], 1e-9):.1f} fps) -> {out_path}")
        return
    if args.video_out is not None:
        parser.error("--video_out is for a single video; use --output_dir with several")
    if not args.output_dir:
        parser.error("several --video files need --output_dir")
    outs = [os.path.join(args.output_dir, os.path.basename(v)) for v in args.video]
    stats = upscale_videos(engine, args.video, outs, batch_size=batch_size)
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
    parser.add_argument(
        "--checkpoint", default=None,
        help="a .npz or .pt generator (default: the first of DEFAULT_CHECKPOINTS that exists)",
    )
    parser.add_argument(
        "--config", default=DEFAULT_CONFIG,
        help="config file whose inference: section sets the defaults of --batch_size, --tile"
        " and --bucket (must exist when given)",
    )
    # None defaults: resolved from the config's inference: section (a flag wins)
    parser.add_argument("--batch_size", default=None, type=int)
    parser.add_argument(
        "--bucket", default=None, type=int,
        help="zero-pad LR inputs to multiples of this so mixed sizes share batches;"
        " exact via the masked forward (default: the config's inference.bucket)",
    )
    parser.add_argument(
        "--tile", default=None, type=int,
        help="shard each image's width across N devices (exact halo tiling, instance-norm"
        " statistics over the whole frame; the width must divide by N; default: the"
        " config's inference.tile)",
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
        if args.tile:
            parser.error("--video does not take --tile (a stream runs whole frames)")
        if args.video_out is None and args.output_dir is None:
            parser.error("--video needs --video_out or --output_dir")
    ckpt = args.checkpoint or resolve_default_checkpoint()
    try:
        config = load_config(args.config, required=args.config != DEFAULT_CONFIG)
    except FileNotFoundError as e:
        parser.error(str(e))
    params = load_generator_params(ckpt)
    arch = arch_from_params(params)
    cfg_arch = {
        "n_filters": config.generator.n_filters,
        "n_layers": config.generator.n_layers,
        "scale_factor": config.data.scale_factor,
    }
    if arch != cfg_arch:
        print(f"checkpoint architecture {arch} (overrides config {cfg_arch})")

    def flag(name):
        value = getattr(args, name)
        return config.inference[name] if value is None else value

    tile, bucket, batch_size = flag("tile"), flag("bucket"), flag("batch_size")
    if args.video is not None:  # a config's tile or bucket is for directories
        bucket, tile = 0, 0
    if tile and bucket:
        parser.error("--tile and --bucket exclude each other: tiling runs whole frames across"
                     " devices, bucketing batches padded frames on one")
    if tile < 0:
        parser.error(f"--tile must be >= 0, got {tile}")
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
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    if tile:
        mesh = tile_mesh(tile, args.device)
        scales = None
        if args.int8:
            plan = quant.prepare_generator(params, None, torch.float32, mesh.devices[0])
            scales = quant.calibrate_scales(plan, calib or [quant.default_calibration_batch()])
        t0 = time.perf_counter()
        n = upscale_directory_tiled(params, args.image_dir, args.output_dir, mesh, dtype, scales)
        dt = time.perf_counter() - t0
        print(f"Done: {n} images in {dt:.2f}s, each tiled across {tile} device(s) of {mesh}")
        return
    engine = SRInferenceEngine(
        params,
        dtype=dtype,
        device=args.device,
        bucket=bucket,
        quantize=args.int8,
        calib_batches=calib,
    )
    if args.video is not None:
        _upscale_videos(engine, parser, args, batch_size)
        return
    t0 = time.perf_counter()
    n = upscale_directory(engine, args.image_dir, args.output_dir, batch_size)
    dt = time.perf_counter() - t0
    print(f"Done: {n} images in {dt:.2f}s on {engine.device}")


if __name__ == "__main__":
    main()
