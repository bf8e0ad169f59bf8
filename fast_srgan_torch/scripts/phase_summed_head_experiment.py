"""The 4x head's two forms, phase-summed against concat, on the port: ms a
batch, the largest batch before the device runs out of memory, peak memory,
and how far apart the two forms' outputs are.

    python -m fast_srgan_torch.scripts.phase_summed_head_experiment
        [--checkpoint X.npz|X.pt] [--shape 180x320] [--batches 1,8,32]
        [--arms bf16,int8] [--iters 8] [--exact_shape 2x24x32]
        [--calib_shape 96x160] [--skip_exactness] [--device cuda]

The counterpart of ``scripts/phase_summed_head_experiment.py``. The 4x
LR-domain tail's head either runs as one dense conv over the [B, 16F, H, W]
concat of the four stage-2 phases (``concat``) or as four partial convs, one
a phase, summed in fp32 (``summed``: the concat never exists). Both are the
same function (``ops/lr_tail.py``); which is faster at which batch and
frame size is what ``ops/lr_tail.py:CONCAT_HEAD_MIN_PIXELS`` is set from.

Arms (``--arms``), each in both forms:

  * ``bf16``: the engine's bf16 forward (``Generator.trunk``, then
    ``lr_tail(..., head=form)``), through the engine's uint8 normalization;
  * ``int8``: the int8 ``ups`` tier (``quant.sr_quant_forward``, bf16 glue,
    activation scales calibrated on ``quant.default_calibration_batch`` at
    ``--calib_shape``): ``summed`` is the plan as prepared, ``concat`` the
    same plan without its head's four parts, whose tail then runs the dense
    head over the 16F concat (the form calibration runs).

For each batch of ``--batches`` at ``--shape``, each ``{arm}_{form}`` cell
holds ms a batch (the best of three runs of ``--iters`` calls, CUDA events
on the card), frames/s, each run's ms and the peak device memory; a batch
that runs the device out of memory is ``{"oom": true}``, and ``max_batch``
is each cell's largest batch that ran. ``exactness`` (on ``--exact_shape``
frames, seed 0): for each arm, the largest |summed - concat| of the fp32
forward (the float forward in fp32, TF32 off; the int8 plan in fp32 glue)
and, in the arm's own dtype, the uint8 outputs' largest difference in
counts and the number of values that differ. Prints one JSON line last, with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from fast_srgan_torch import quant
from fast_srgan_torch.infer import load_generator_params, resolve_default_checkpoint
from fast_srgan_torch.inference import SRInferenceEngine, sr_forward_u8
from fast_srgan_torch.ops.lr_tail import lr_tail
from fast_srgan_torch.ops.precision import fp32_precision
from fast_srgan_torch.scripts.eval_int8 import time_arm
from fast_srgan_torch.scripts.measure import emit, script_device

ARMS = ("bf16", "int8")
FORMS = ("summed", "concat")
Forward = Callable[[torch.Tensor], torch.Tensor]


def float_model(params: Dict[str, Any], dtype: torch.dtype, device: Any) -> Tuple[Any, dict]:
    """The float engine's 4x generator and its prepared LR tail, in ``dtype``
    on ``device``; SystemExit for another scale."""
    engine = SRInferenceEngine(params, dtype=dtype, device=device)
    if engine.SCALE != 4:
        raise SystemExit(f"the head forms are the 4x tail's; the checkpoint is {engine.SCALE}x")
    return engine.model, engine._tail


def head_forward(model, tail: dict, head: str) -> Forward:
    """[B, 3, H, W] in [-1, 1] -> the generator's [B, 3, 4H, 4W] fp32, the
    head in form ``head``."""
    return lambda x: lr_tail(model.trunk(x), tail, head=head)


def concat_head(plan: quant.PreparedGenerator) -> quant.PreparedGenerator:
    """``plan`` with its float 4x head in the concat form: without the four
    per-phase parts, quant's tail runs one head conv over the 16F concat."""
    head = {k: v for k, v in plan.layers["head"].items() if k != "parts"}
    return dataclasses.replace(plan, layers={**plan.layers, "head": head})


def int8_forwards(params, glue: torch.dtype, device, scales) -> Dict[str, Forward]:
    """The int8 ``ups`` forward in each head form."""
    plan = quant.prepare_generator(params, "ups", glue, device)
    plans = {"summed": plan, "concat": concat_head(plan)}
    return {form: (lambda x, p=p: quant.sr_quant_forward(p, scales, x))
            for form, p in plans.items()}


def u8(forward: Forward) -> Forward:
    """``forward`` through the engine's uint8 normalization, no autograd."""
    def run(x_u8: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return sr_forward_u8(forward, x_u8)
    return run


def _shape(spec: str) -> Tuple[int, ...]:
    return tuple(int(v) for v in spec.split("x"))


def exactness(params, arms, device, shape: Tuple[int, int, int], scales) -> dict:
    """Summed against concat on ``shape`` ([B, H, W]) frames, seed 0: fp32
    max-abs of the generator's output, and uint8 counts in each arm's own
    dtype."""
    b, h, w = shape
    frames = np.random.default_rng(0).integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    x_u8 = torch.from_numpy(frames).to(device)
    x = x_u8.permute(0, 3, 1, 2).float() / 127.5 - 1.0
    out = {}
    for arm in arms:
        if arm == "bf16":
            f32 = {form: head_forward(*float_model(params, torch.float32, device), form)
                   for form in FORMS}
            model, tail = float_model(params, torch.bfloat16, device)
            served = {form: head_forward(model, tail, form) for form in FORMS}
        else:
            f32 = int8_forwards(params, torch.float32, device, scales)
            served = int8_forwards(params, torch.bfloat16, device, scales)
        with torch.inference_mode(), fp32_precision(True, device):
            y = {form: fn(x) for form, fn in f32.items()}
        q = {form: u8(fn)(x_u8).to(torch.int16) for form, fn in served.items()}
        diff = (q["summed"] - q["concat"]).abs()
        out[arm] = {
            "fp32_max_abs": float((y["summed"] - y["concat"]).abs().max()),
            "u8_max_counts": int(diff.max()),
            "u8_differing": int((diff > 0).sum()),
            "u8_values": diff.numel(),
        }
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", default=None,
                   help="a .npz or .pt 4x generator (default: infer.DEFAULT_CHECKPOINTS' first)")
    p.add_argument("--shape", default="180x320", help="LR frame HxW of the timed batches")
    p.add_argument("--batches", default="1,8,32",
                   help="comma-separated batch sizes; out-of-memory cells are recorded")
    p.add_argument("--arms", default=",".join(ARMS), help="comma-separated: bf16, int8")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--exact_shape", default="2x24x32", help="BxHxW of the exactness frames")
    p.add_argument("--calib_shape", default="96x160",
                   help="HxW of the int8 arm's synthetic calibration frames")
    p.add_argument("--skip_exactness", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = script_device(args.device)
    arms = args.arms.split(",")
    if set(arms) - set(ARMS):
        p.error(f"unknown arms {sorted(set(arms) - set(ARMS))}")
    h, w = _shape(args.shape)
    ckpt = args.checkpoint or resolve_default_checkpoint()
    params = load_generator_params(ckpt)

    scales = None
    if "int8" in arms:
        ch, cw = _shape(args.calib_shape)
        fp32_plan = quant.prepare_generator(params, None, torch.float32, device)
        scales = quant.calibrate_scales(fp32_plan, [quant.default_calibration_batch(h=ch, w=cw)])
        del fp32_plan

    result: Dict[str, Any] = {"checkpoint": ckpt, "shape": args.shape}
    if not args.skip_exactness:
        result["exactness"] = exactness(params, arms, device, _shape(args.exact_shape), scales)
        print(f"# exactness: {result['exactness']}", flush=True)
        gc.collect()

    forwards: Dict[str, Forward] = {}
    if "bf16" in arms:
        model, tail = float_model(params, torch.bfloat16, device)
        forwards.update({f"bf16_{form}": u8(head_forward(model, tail, form)) for form in FORMS})
    if "int8" in arms:
        forwards.update({f"int8_{form}": u8(fn) for form, fn in
                         int8_forwards(params, torch.bfloat16, device, scales).items()})
    rng = np.random.default_rng(0)
    rows: Dict[int, Dict[str, dict]] = {}
    for b in (int(v) for v in args.batches.split(",")):
        rows[b] = {name: time_arm(fn, b, h, w, args.iters, device, rng)
                   for name, fn in forwards.items()}
        print(f"# batch {b}: {rows[b]}", flush=True)
    result["arms"] = rows
    result["max_batch"] = {name: max((b for b, row in rows.items() if "fps" in row[name]),
                                     default=None)
                           for name in forwards}
    return emit(result, device)


if __name__ == "__main__":
    main()
