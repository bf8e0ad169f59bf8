"""PSNR/SSIM of a checkpoint over an image directory, on the port.

The counterpart of ``scripts/evaluate.py``, the standard SR protocol on
whole images: HR ground truth -> bicubic-antialias downsample by the scale
(``ops/resize.py``, the training degradation) -> the canonical generator
forward -> PSNR/SSIM against the ground truth on [0, 1] images
(``metrics/psnr_ssim.py``).

    python -m fast_srgan_torch.scripts.evaluate --image_dir DIV2K_valid_HR
        [--checkpoint models/generator_pretrained.npz | X.pt] [--crop 192]
        [--fp32] [--y_channel] [--shave N] [--n_filters F --n_layers L]
        [--device cuda]

Images are center-cropped to a multiple of the scale (or to ``--crop``,
floored to one) so LR synthesis is exact. ``--y_channel`` takes the
metrics on the matlab-convention BT.601 luma with a shaved border
(``--shave``, default the scale there, else 0): the SR literature's
benchmark protocol. Prints one line an image and an aggregate line (PSNR
over all measured values, mean SSIM) in the JAX script's format.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, List

import torch


def crop_to_scale(img, scale: int, crop: int = 0):
    """The center crop the protocol measures: ``crop`` (floored to a multiple
    of the scale, at most the short side), else the largest multiple of the
    scale in each dimension."""
    h, w = img.shape[:2]
    if crop:
        ch = cw = (min(crop, min(h, w)) // scale) * scale
    else:
        ch, cw = (h // scale) * scale, (w // scale) * scale
    top, left = (h - ch) // 2, (w - cw) // 2
    return img[top:top + ch, left:left + cw]


def evaluate_image(model, hr_u8, scale: int, y_channel: bool, shave: int) -> tuple:
    """(sse, measured values, SSIM) of one HR uint8 HWC image, whose sides
    are multiples of ``scale``, through ``model`` on its device."""
    from fast_srgan_torch.metrics.psnr_ssim import luma_bt601, ssim_per_image
    from fast_srgan_torch.ops.resize import resize_bicubic

    dtype = model.neck[0].weight.dtype
    device = model.neck[0].weight.device
    hr = torch.tensor(hr_u8, device=device)[None].permute(0, 3, 1, 2).float()
    h, w = hr.shape[2], hr.shape[3]
    lr = resize_bicubic(hr, h // scale, w // scale) / 127.5 - 1.0
    sr01 = ((model(lr.to(dtype)) + 1.0) / 2.0).clamp(0.0, 1.0)
    hr01 = hr / 255.0
    if y_channel:
        sr01, hr01 = luma_bt601(sr01), luma_bt601(hr01)
    if shave:
        sr01 = sr01[:, :, shave:-shave, shave:-shave]
        hr01 = hr01[:, :, shave:-shave, shave:-shave]
    diff = sr01 - hr01
    sse = float((diff * diff).sum())
    return sse, diff.numel(), float(ssim_per_image(sr01, hr01)[0])


def main(argv=None) -> Dict[str, Any]:
    """Evaluate and print; returns {"images": [(name, psnr, ssim)],
    "psnr": aggregate, "ssim": mean}."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--image_dir", required=True)
    parser.add_argument("--checkpoint", default="models/generator_pretrained.npz")
    parser.add_argument("--crop", type=int, default=0,
                        help="center-crop HR to this size (0 = full image)")
    parser.add_argument("--fp32", action="store_true", help="fp32 compute (default bf16)")
    parser.add_argument("--y_channel", action="store_true",
                        help="metrics on matlab-convention BT.601 luma instead of RGB")
    parser.add_argument("--shave", type=int, default=None,
                        help="border pixels cropped before the metrics (default: 0, or"
                        " the scale with --y_channel)")
    parser.add_argument("--n_filters", type=int, default=None,
                        help="override the architecture read from the checkpoint")
    parser.add_argument("--n_layers", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from fast_srgan_torch.checkpoints.convert import (
        load_generator_params,
        state_dict_from_jax_params,
    )
    from fast_srgan_torch.inference import arch_from_params
    from fast_srgan_torch.metrics.psnr_ssim import psnr_from_accumulator
    from fast_srgan_torch.models.generator import Generator
    from fast_srgan_torch.ops.precision import fp32_precision
    from fast_srgan_torch.utils.images import list_image_files, load_image_u8

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no card is present; pass --device cpu")
    try:
        params = load_generator_params(args.checkpoint)
    except FileNotFoundError as e:
        raise SystemExit(str(e)) from None
    arch = arch_from_params(params)
    scale = arch["scale_factor"]
    model = Generator(
        n_filters=arch["n_filters"] if args.n_filters is None else args.n_filters,
        n_layers=arch["n_layers"] if args.n_layers is None else args.n_layers,
        scale_factor=scale,
    )
    model.load_state_dict(state_dict_from_jax_params(params))
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    model = model.to(device=device, dtype=dtype, memory_format=torch.channels_last).eval()
    shave = args.shave if args.shave is not None else (scale if args.y_channel else 0)
    names = list_image_files(args.image_dir)
    if not names:
        raise SystemExit(f"no images in {args.image_dir}")
    rows: List[tuple] = []
    sse_total = n_total = ssim_total = 0.0
    with torch.inference_mode(), fp32_precision(args.fp32, device):
        for name in names:
            crop = crop_to_scale(load_image_u8(os.path.join(args.image_dir, name)), scale,
                                 args.crop)
            sse, n, ssim = evaluate_image(model, crop, scale, args.y_channel, shave)
            psnr = psnr_from_accumulator(sse, float(n))
            print(f"{name:<28} PSNR {psnr:6.2f} dB   SSIM {ssim:.4f}", flush=True)
            rows.append((name, psnr, ssim))
            sse_total += sse
            n_total += n
            ssim_total += ssim
    psnr = psnr_from_accumulator(sse_total, n_total)
    ssim = ssim_total / len(names)
    print("-" * 56)
    print(f"{'aggregate':<28} PSNR {psnr:6.2f} dB   SSIM {ssim:.4f}   ({len(names)} images)",
          flush=True)
    return {"images": rows, "psnr": psnr, "ssim": ssim}


if __name__ == "__main__":
    main()
