"""The int8 tier's fidelity against fp32 and its speed against bf16, per
quantization arm, on the port.

    python -m fast_srgan_torch.scripts.eval_int8 [--checkpoint X.npz|X.pt]
        [--batch 96[,B2,...]] [--shape 180x320] [--scale {2,4,8}] [--iters 8]
        [--glue {bfloat16,float32}] [--hybrids] [--arms bf16,int8,...]
        [--calib_ab DIR|synthetic] [--psnr_percentiles P,P,...] [--device cuda]

The counterpart of ``scripts/eval_int8.py``. Prints one JSON object:

  * quality: PSNR of each int8 arm against the fp32 forward of the same
    executor, in the uint8 output domain (clipped, not truncated), on the
    synthetic natural-statistics frames ``quant.default_calibration_batch``
    (4 x 96x160, or 2 x 48x80 at 8x, seed 7), fp32 glue, TF32 off; the
    activation scales calibrated on those frames;
  * speed: ms a batch and frames/s of each arm at ``--shape``, uint8 frames
    staged on the device: ``bf16`` is the production bf16 forward (the
    engine's LR-domain tail), each int8 arm ``quant.sr_quant_forward`` in
    ``--glue``, both through the engine's uint8 normalization. Best of
    three runs of ``--iters`` back-to-back calls, timed with CUDA events
    (no checksum barrier: that protocol was for a remote TPU).

Arms (``--arms``; default bf16, int8 and int8_tail_only, + int8_trunk_only
with ``--hybrids``): ``int8`` quantizes every conv (``quant.MODES`` full),
``int8_tail_only`` the upsampling stages and head (tail),
``int8_trunk_only`` neck, stems and bottleneck (trunk), ``int8_ups_only``
the upsampling stages (ups, the production tier), ``int8_head_only`` the
head conv alone. A batch that runs out of device memory is recorded as
``{"oom": true}`` in its row, one a kernel's grid refuses as
``{"unsupported": ...}``; the sweep goes on. Each timed cell also holds the
three runs' ms (``ms_runs``: their range is the run-to-run spread) and the
peak device memory (``peak_bytes``).

``--scale 2`` or ``8`` adapts the 4x checkpoint (the reference ships only
4x weights): 2x drops ``upsampling_1``, 8x clones it as ``upsampling_2``;
every stage is F -> 4F, so the weights transplant exactly.
``--psnr_percentiles`` adds the ``ups`` arm's PSNR under other activation
percentiles; ``--calib_ab`` compares the ``ups`` arm calibrated on the
synthetic batch against calibrated on the evaluated frames (a directory,
or a procedural panning clip).
"""

from __future__ import annotations

import argparse
import gc
import os
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from fast_srgan_torch import quant
from fast_srgan_torch.infer import (
    image_names,
    load_generator_params,
    resolve_default_checkpoint,
)
from fast_srgan_torch.inference import SRInferenceEngine, load_image, sr_forward_u8
from fast_srgan_torch.ops.precision import cudnn_without_tf32
from fast_srgan_torch.scripts.measure import (
    emit,
    peak_memory,
    reset_peak_memory,
    runs_ms,
    script_device,
)


def _head_only(name: str) -> bool:
    return name == "head_conv"


#: Each int8 arm: its ``quant.MODES`` mode, or the predicate it quantizes.
ARMS: Dict[str, Any] = {
    "int8": "full",
    "int8_tail_only": "tail",
    "int8_trunk_only": "trunk",
    "int8_ups_only": "ups",
    "int8_head_only": _head_only,
}


def adapt_scale(params: Dict[str, Any], scale: int) -> Dict[str, Any]:
    """The generator tree at ``scale``: unchanged when it is already that
    scale; a 4x tree adapted (2x: ``upsampling_1`` dropped; 8x:
    ``upsampling_1`` cloned as ``upsampling_2``). SystemExit otherwise."""
    bare = dict(params["params"] if "params" in params else params)
    n_up = sum(1 for k in bare if str(k).startswith("upsampling_"))
    if scale == 2**n_up:
        return params
    if n_up != 2:
        raise SystemExit(
            f"--scale {scale} asked but the checkpoint is {2 ** n_up}x and only 4x"
            " checkpoints can be stage-adapted; pass a matching checkpoint"
        )
    if scale == 2:
        bare.pop("upsampling_1")
    else:
        bare["upsampling_2"] = bare["upsampling_1"]
    return {"params": bare}


def quality_batch(scale: int) -> np.ndarray:
    """The frames PSNR is measured on ([-1, 1] NHWC): 4 x 96x160, or at 8x
    (whose 2x-resolution tail costs ~10x the 4x one) 2 x 48x80; seed 7."""
    if scale == 8:
        return quant.default_calibration_batch(h=48, w=80, n=2, seed=7)
    return quant.default_calibration_batch(h=96, w=160, n=4, seed=7)


def _u8(y: torch.Tensor) -> np.ndarray:
    return np.clip((y.float().cpu().numpy() + 1) * 127.5, 0, 255)


def psnr_u8(ref: torch.Tensor, out: torch.Tensor) -> float:
    """PSNR of ``out`` against ``ref`` (generator outputs in [-1, 1]) in the
    uint8 domain, clipped to [0, 255] and not truncated (the JAX script's)."""
    mse = float(np.mean((_u8(ref) - _u8(out)) ** 2))
    return float(10 * np.log10(255.0**2 / max(mse, 1e-12)))


class Quality:
    """The fp32 reference and the int8 arms on one batch of frames, fp32
    glue, TF32 off, on ``device``."""

    def __init__(self, params, frames: np.ndarray, device: torch.device,
                 percentile: Optional[float] = quant.DEFAULT_PERCENTILE):
        self.params, self.device = params, device
        self.float_plan = quant.prepare_generator(params, None, torch.float32, device)
        self.x = torch.from_numpy(np.ascontiguousarray(frames)).to(device).permute(0, 3, 1, 2)
        self.scales = self.calibrate([frames], percentile)
        with torch.inference_mode(), cudnn_without_tf32():
            self.ref = quant.sr_float_forward(self.float_plan, self.x)
        self._plans: Dict[str, quant.PreparedGenerator] = {}

    def calibrate(self, batches: Iterable[np.ndarray],
                  percentile: Optional[float] = quant.DEFAULT_PERCENTILE):
        return quant.calibrate_scales(self.float_plan, batches, percentile=percentile)

    def plan(self, arm: str) -> quant.PreparedGenerator:
        if arm not in self._plans:
            self._plans[arm] = quant.prepare_generator(
                self.params, ARMS[arm], torch.float32, self.device)
        return self._plans[arm]

    def psnr(self, arm: str, scales=None, x=None, ref=None) -> float:
        """PSNR of ``arm`` against fp32 (default: on the quality frames at
        their own scales)."""
        with torch.inference_mode(), cudnn_without_tf32():
            out = quant.sr_quant_forward(
                self.plan(arm), self.scales if scales is None else scales,
                self.x if x is None else x)
        return psnr_u8(self.ref if ref is None else ref, out)


def synthetic_clip(h: int, w: int) -> list:
    """A procedural "clip": 8 frames of a window panning over one
    natural-statistics master image, plus sensor noise (seed 42)."""
    rng = np.random.default_rng(42)
    yy, xx = np.mgrid[0:h + 64, 0:w + 64].astype(np.float32)
    master = (110 + 70 * np.sin(yy / 37) * np.cos(xx / 53)
              + 40 * np.sign(np.sin(yy / 9 + xx / 17))
              + 12 * rng.standard_normal(yy.shape))
    master = np.clip(master, 0, 255)
    frames = []
    for t in range(8):
        win = master[4 * t:4 * t + h, 8 * t:8 * t + w]
        f = np.stack([np.clip(win + 6 * rng.standard_normal(win.shape), 0, 255)
                      for _ in range(3)], -1)
        frames.append(f.astype(np.uint8))
    return frames


def calib_ab(quality: Quality, source: str, h: int, w: int) -> dict:
    """PSNR of the ``ups`` arm on ``source``'s frames, calibrated on the
    synthetic batch against calibrated on the frames themselves."""
    if source == "synthetic":
        frames = synthetic_clip(h, w)
    else:
        frames = [load_image(os.path.join(source, n)) for n in image_names(source)[:8]]
    xe = quant.calibration_batch_from_images(frames, max_h=h, max_w=w)
    if xe is None:
        raise SystemExit(f"--calib_ab: no usable frames in {source}")
    x = torch.from_numpy(xe).to(quality.device).permute(0, 3, 1, 2)
    with torch.inference_mode(), cudnn_without_tf32():
        ref = quant.sr_float_forward(quality.float_plan, x)
    ab = {
        "synthetic_batch": round(quality.psnr("int8_ups_only", x=x, ref=ref), 2),
        "real_frames": round(quality.psnr("int8_ups_only", quality.calibrate([xe]), x, ref), 2),
    }
    ab["delta_db"] = round(ab["real_frames"] - ab["synthetic_batch"], 2)
    return ab


def time_arm(forward_u8: Callable[[torch.Tensor], torch.Tensor], b: int, h: int, w: int,
             iters: int, device: torch.device, rng: np.random.Generator) -> dict:
    """ms a batch (the best of three runs of ``iters`` calls) and frames/s of
    ``forward_u8`` at [b, h, w, 3] uint8 frames staged on the device, with
    each run's ms and the peak device memory (null on the CPU);
    ``{"oom": true}`` when the device runs out of memory (the staging
    included), ``{"unsupported": why}`` when a kernel's grid refuses a
    tensor this large."""
    try:
        reset_peak_memory(device)
        x = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(device)
        runs = runs_ms(lambda: forward_u8(x), iters, device)
    except RuntimeError as e:  # torch.cuda.OutOfMemoryError, or cuDNN's workspace
        if not isinstance(e, torch.cuda.OutOfMemoryError) and "out of memory" not in str(e):
            raise
        gc.collect()
        torch.cuda.empty_cache()
        return {"oom": True}
    except ValueError as e:
        if "unsupported size" not in str(e):
            raise
        return {"unsupported": str(e)}
    ms = min(runs)
    return {"ms": round(ms, 3), "fps": round(b / ms * 1e3, 1),
            "ms_runs": [round(r, 3) for r in runs], "peak_bytes": peak_memory(device)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", default=None,
                   help="a .npz or .pt generator (default: infer.DEFAULT_CHECKPOINTS' first)")
    p.add_argument("--batch", default="96",
                   help="comma-separated batch sizes to time; out-of-memory arms are recorded")
    p.add_argument("--shape", default="180x320")
    p.add_argument("--scale", type=int, default=4, choices=[2, 4, 8],
                   help="2x/8x adapt the 4x checkpoint's stages (see the module docstring)")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--glue", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--hybrids", action="store_true", help="also time int8_trunk_only")
    p.add_argument("--arms", default=None,
                   help="comma-separated arms to run (bf16," + ",".join(ARMS) + ")")
    p.add_argument("--calib_ab", default=None,
                   help="a directory of frames, or 'synthetic': the ups arm's PSNR calibrated"
                   " on the synthetic batch against on those frames")
    p.add_argument("--psnr_percentiles", default=None,
                   help="comma-separated activation percentiles for the ups arm's PSNR")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = script_device(args.device)
    h, w = (int(v) for v in args.shape.split("x"))
    ckpt = args.checkpoint or resolve_default_checkpoint()
    params = adapt_scale(load_generator_params(ckpt), args.scale)
    if args.arms:
        wanted = args.arms.split(",")
        unknown = set(wanted) - set(ARMS) - {"bf16"}
        if unknown:
            p.error(f"unknown arms {sorted(unknown)}")
    else:
        wanted = ["bf16", "int8", "int8_tail_only"] + (["int8_trunk_only"] if args.hybrids else [])

    # --- quality (fp32 vs int8, uint8 output domain) -------------------------
    quality = Quality(params, quality_batch(args.scale), device)
    psnr = quality.psnr("int8")
    psnr_tail = quality.psnr("int8_tail_only")
    known = {"int8": psnr, "int8_tail_only": psnr_tail}
    psnr_by_arm = {arm: round(known[arm] if arm in known else quality.psnr(arm), 2)
                   for arm in ARMS if arm in wanted}
    psnr_percentile = None
    if args.psnr_percentiles:
        psnr_percentile = {
            "default": round(quality.psnr("int8_ups_only"), 2),
            "maxabs": round(quality.psnr("int8_ups_only", quality.calibrate(
                [quality_batch(args.scale)], None)), 2),
        }
        for q in args.psnr_percentiles.split(","):
            psnr_percentile[q] = round(quality.psnr("int8_ups_only", quality.calibrate(
                [quality_batch(args.scale)], float(q))), 2)
    ab = calib_ab(quality, args.calib_ab, h, w) if args.calib_ab else None
    scales = quality.scales
    del quality
    gc.collect()

    # --- speed: bf16 LR-tail (production) vs each int8 arm -------------------
    glue = torch.bfloat16 if args.glue == "bfloat16" else torch.float32
    forwards: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {}
    if "bf16" in wanted:
        forwards["bf16"] = SRInferenceEngine(params, dtype=torch.bfloat16, device=device).forward_u8
    for arm in ARMS:
        if arm in wanted:
            plan = quant.prepare_generator(params, ARMS[arm], glue, device)

            def forward(x_u8, plan=plan):
                with torch.inference_mode():
                    return sr_forward_u8(lambda t: quant.sr_quant_forward(plan, scales, t), x_u8)

            forwards[arm] = forward
    rng = np.random.default_rng(0)
    arms = {}
    for b in (int(v) for v in args.batch.split(",")):
        arms[b] = {name: time_arm(fn, b, h, w, args.iters, device, rng)
                   for name, fn in forwards.items()}
        print(f"# batch {b}: {arms[b]}", flush=True)

    def best(name):
        return max((row[name]["fps"] for row in arms.values() if "fps" in row.get(name, {})),
                   default=None)

    fb = best("bf16")
    fi = max((f for arm in ARMS if (f := best(arm)) is not None), default=None)
    return emit({
        "checkpoint": ckpt,
        "scale": args.scale,
        "shape": args.shape,
        "glue": args.glue,
        "psnr_int8_vs_fp32_u8_db": round(psnr, 2),
        "psnr_int8_tail_only_vs_fp32_u8_db": round(psnr_tail, 2),
        "psnr_by_arm": psnr_by_arm,
        "psnr_percentile": psnr_percentile,
        "calib_ab": ab,
        "arms": arms,
        "best_fps_bf16": fb,
        "best_fps_int8": fi,
        "speedup_int8_over_bf16": round(fi / fb, 3) if fb and fi else None,
    }, device)


if __name__ == "__main__":
    main()
