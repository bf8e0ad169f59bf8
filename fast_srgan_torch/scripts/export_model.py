"""Export a checkpoint as ``torch.export`` deployment artifacts, and check them.

The counterpart of ``scripts/export_model.py`` (``fast_srgan_torch/export.py``
says what an artifact is):

    python -m fast_srgan_torch.scripts.export_model --output DIR
        [--checkpoint models/generator_pretrained.npz | X.pt]
        [--shape 1x180x320] [--shape 8x180x320] [--fp32] [--no-lr-tail]
        [--int8 [--calib_dir DIR]] [--device cuda] [--no-check]

Each ``--shape`` is BxHxW of the LR input. ``--device`` takes the place of
the JAX script's ``--platforms``: a program is exported where it runs (the
card unless ``cpu`` is asked for). ``--int8`` holds the int8 ``ups`` tier,
its activation scales calibrated here on up to 8 of ``--calib_dir``'s
images (center crops), else on the synthetic batch.

The check (default on) loads every artifact back and holds it, on random
uint8 inputs, (1) bitwise against the in-process module it was exported
from (serialization), and (2) within 2 uint8 counts of the live
``SRInferenceEngine`` on the same weights and scales (one forward at the
artifact's batch), printing the max difference and the share of pixels
that differ.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

#: the gate of the artifact against the live engine, in uint8 counts
ENGINE_TOL = 2


def parse_shape(spec: str):
    b, h, w = (int(v) for v in spec.lower().split("x"))
    return b, h, w


def calibration_batches(calib_dir: Optional[str]) -> Optional[List[np.ndarray]]:
    """[one batch of center crops] of up to 8 of the directory's images, or
    None (the synthetic batch) without a directory or a usable image."""
    from fast_srgan_torch import quant
    from fast_srgan_torch.utils.images import list_image_files, load_image_u8

    if not calib_dir:
        return None
    names = list_image_files(calib_dir)[:8]
    batch = quant.calibration_batch_from_images(
        load_image_u8(os.path.join(calib_dir, n)) for n in names
    )
    return None if batch is None else [batch]


def check_artifacts(out_dir: str, module, params: Dict[str, Any], args) -> Dict[tuple, dict]:
    """Both parts of the check for every artifact of ``out_dir``; raises
    SystemExit on a failure. Returns {(b, h, w): {"max_diff", "share_differ"}}."""
    from fast_srgan_torch.export import load_exported_dir
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.ops.precision import fp32_precision

    loaded = load_exported_dir(out_dir)
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    engine = SRInferenceEngine(
        params, dtype=dtype, device=args.device, lr_tail=not args.no_lr_tail,
        quantize=args.int8, act_scales=module.act_scales if args.int8 else None,
    )
    rng = np.random.default_rng(0)
    results = {}
    for (b, h, w), call in loaded["forwards"].items():
        x = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
        xt = torch.from_numpy(x).to(module.device)
        got = call(x).cpu().numpy()
        with torch.no_grad(), fp32_precision(args.fp32, module.device):
            want = module(xt).cpu().numpy()
        if not np.array_equal(got, want):
            raise SystemExit(
                f"self-check FAILED for {b}x{h}x{w}: the loaded artifact differs from the"
                " module it was exported from (serialization)"
            )
        served = engine.forward_u8(xt).cpu().numpy()
        diff = np.abs(got.astype(np.int16) - served.astype(np.int16))
        dmax, frac = int(diff.max()), float(np.mean(diff > 0))
        if dmax > ENGINE_TOL:
            raise SystemExit(
                f"self-check FAILED for {b}x{h}x{w}: artifact vs live SRInferenceEngine max"
                f" |diff| = {dmax} uint8 counts ({frac:.4%} of values differ) > {ENGINE_TOL}"
            )
        print(f"  check {b}x{h}x{w}: loaded == exported module bitwise; vs live engine max"
              f" |diff| {dmax} count(s), {frac:.4%} of values differ ({got.shape} uint8)",
              flush=True)
        results[(b, h, w)] = {"max_diff": dmax, "share_differ": frac}
    return results


def main(argv=None) -> Dict[str, Any]:
    """Export, save and (unless --no-check) check. Returns the manifest's
    path, the manifest, each shape's export and load seconds, and the
    check's results."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", default=None,
                    help=".npz or .pt generator (default models/generator_pretrained.npz)")
    ap.add_argument("--output", required=True)
    ap.add_argument("--shape", action="append", default=[],
                    help="BxHxW LR input shape, repeatable (default 1x180x320)")
    ap.add_argument("--fp32", action="store_true", help="fp32 compute (default bf16)")
    ap.add_argument("--no-lr-tail", action="store_true", help="the canonical tail")
    ap.add_argument("--int8", action="store_true",
                    help="hold the int8 ups tier, activation scales calibrated here")
    ap.add_argument("--calib_dir", default=None,
                    help="images to calibrate the int8 activation scales on (--int8 only)")
    ap.add_argument("--device", default="cuda", help="where the artifact runs: cuda or cpu")
    ap.add_argument("--no-check", action="store_true")
    args = ap.parse_args(argv)

    from fast_srgan_torch.export import build_forward_u8, export_shape, save_exported_dir
    from fast_srgan_torch.infer import load_generator_params, resolve_default_checkpoint

    ckpt = args.checkpoint or resolve_default_checkpoint()
    params = load_generator_params(ckpt)
    shapes = [parse_shape(s) for s in args.shape or ["1x180x320"]]
    calib = calibration_batches(args.calib_dir) if args.int8 else None
    if args.int8:
        print("int8: calibrating on " + ("the synthetic batch" if calib is None else
              f"{calib[0].shape[0]} crop(s) of {calib[0].shape[1]}x{calib[0].shape[2]}"
              f" from {args.calib_dir}"), flush=True)
    module = build_forward_u8(params, bf16=not args.fp32, lr_tail=not args.no_lr_tail,
                              quantize=args.int8, calib_batches=calib, device=args.device)
    print(f"checkpoint {ckpt}: {module.arch}, form {module.form}, {module.dtype},"
          f" device {module.device}", flush=True)
    entries, export_s = [], {}
    for b, h, w in shapes:
        t0 = time.perf_counter()
        entries.append(((b, h, w), export_shape(module, b, h, w)))
        export_s[(b, h, w)] = time.perf_counter() - t0
    manifest_path = save_exported_dir(
        args.output, entries, arch=module.arch, bf16=not args.fp32,
        lr_tail=not args.no_lr_tail, quantize=args.int8, device=str(module.device),
    )
    with open(manifest_path) as f:
        manifest = json.load(f)
    load_s = {}
    for e in manifest["entries"]:
        shape = (e["batch"], e["height"], e["width"])
        t0 = time.perf_counter()
        torch.export.load(os.path.join(args.output, e["file"]))
        load_s[shape] = time.perf_counter() - t0
        print(f"  {'x'.join(map(str, shape))}: {e['bytes']} bytes, export"
              f" {export_s[shape]:.2f} s, load {load_s[shape]:.2f} s", flush=True)
    print(f"wrote {manifest_path}", flush=True)
    check = None
    if not args.no_check:
        check = check_artifacts(args.output, module, params, args)
        print("self-check OK", flush=True)
    return {"manifest_path": manifest_path, "manifest": manifest, "export_s": export_s,
            "load_s": load_s, "check": check, "module": module}


if __name__ == "__main__":
    main()
