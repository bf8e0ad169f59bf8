"""FLOPs, peak memory and an optional torch.profiler trace of one generator
forward or one training step, on the port.

    python -m fast_srgan_torch.scripts.profile_model                  # forward
    python -m fast_srgan_torch.scripts.profile_model --step gan [--vgg]
    python -m fast_srgan_torch.scripts.profile_model --shape 16x540x960 --trace runs/prof
        [--fp32] [--lr_tail | --int8] [--fused] [--device cuda]

The counterpart of ``scripts/profile_model.py``. ``--step forward`` runs
the pretrained 4x generator (``infer.DEFAULT_CHECKPOINTS``' first) on a
zero [B, 3, H, W] batch, bf16 (``--fp32``: fp32, TF32 off): the canonical
tail (``--fused``: each stage the fused upsample kernel), the LR-domain
tail (``--lr_tail``), or the int8 ``ups`` tier (``--int8``, calibrated on
``quant.default_calibration_batch(h=96, w=160)``). ``--step pretrain`` or
``gan`` runs one training step of ``train.steps.build_bundle`` on zero
uint8 HR crops, ``--shape`` B x H x W with H = W a multiple of 4 (bf16
autocast unless ``--fp32``; ``--vgg``: the VGG19 content loss with
fixed-seed weights, else the pixel loss; ``--fused``:
``kernels.fused_upsample``).

One warm-up call, then one call under
``torch.utils.flop_counter.FlopCounterMode``: FLOPs by op (a conv
2 * KH * KW * Cin * Cout an output pixel). The port's conv-shaped kernel
ops register their formulas with the counter
(``fast_srgan.int8_conv``, ``int8_conv_phases``, ``fused_upsample``); the
memory-bound ones (the instance-norm family, ``quantize_act``,
``pixel_shuffle_phase_major``) count 0, as do elementwise ops. Peak
memory is ``torch.cuda.max_memory_allocated`` over that call. ``--trace
DIR`` writes a torch.profiler trace (CPU and CUDA activity) of one more
call as ``DIR/trace.json`` (chrome://tracing, Perfetto). XLA's byte count
and "optimal seconds" (its cost model) have no counterpart here and are
left out. Prints the numbers, then one JSON object.
"""

from __future__ import annotations

import argparse
import os

import torch
from torch.utils.flop_counter import FlopCounterMode

from fast_srgan_torch.scripts.measure import emit, script_device, synchronize


def forward_fn(args, b: int, h: int, w: int, device: torch.device, dtype: torch.dtype):
    from fast_srgan_torch import quant
    from fast_srgan_torch.checkpoints.convert import state_dict_from_jax_params
    from fast_srgan_torch.infer import load_generator_params, resolve_default_checkpoint
    from fast_srgan_torch.inference import arch_from_params
    from fast_srgan_torch.models.generator import Generator
    from fast_srgan_torch.ops.lr_tail import generator_apply_lr_tail, prepare_lr_tail

    params = load_generator_params(resolve_default_checkpoint())
    x = torch.zeros((b, 3, h, w), device=device).contiguous(memory_format=torch.channels_last)
    if args.int8:
        scales = quant.calibrate_scales(
            quant.prepare_generator(params, None, torch.float32, device),
            [quant.default_calibration_batch(h=96, w=160)])
        plan = quant.prepare_generator(params, "ups", dtype, device)
        return lambda: quant.sr_quant_forward(plan, scales, x)
    model = Generator(**arch_from_params(params), fused_upsample=args.fused)
    model.load_state_dict(state_dict_from_jax_params(params))
    tail = prepare_lr_tail(model, dtype, device) if args.lr_tail else None
    model = model.to(device=device, dtype=dtype, memory_format=torch.channels_last).eval()
    if tail is not None:
        return lambda: generator_apply_lr_tail(model, tail, x)
    return lambda: model(x)


def step_fn(args, b: int, h: int, w: int, device: torch.device):
    from fast_srgan_torch.config import default_config
    from fast_srgan_torch.train.steps import build_bundle

    if h != w or h % 4:
        raise SystemExit(f"--step {args.step} needs square HR crops divisible by 4, got {h}x{w}")
    config = default_config(
        training={"bf16": not args.fp32, "vgg_weights": "init" if args.vgg else "pixel"},
        data={"lr_image_size": h // 4, "scale_factor": 4},
        kernels={"fused_upsample": args.fused},
    )
    bundle = build_bundle(config, device, torch.Generator().manual_seed(0))
    batch = torch.zeros((b, h, w, 3), dtype=torch.uint8, device=device)
    if args.step == "pretrain":
        return lambda: bundle.pretrain_step(batch)
    return lambda: bundle.gan_step(batch)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--step", choices=["forward", "gan", "pretrain"], default="forward")
    ap.add_argument("--shape", default="16x180x320", help="BxHxW input (HR crops for a step)")
    ap.add_argument("--trace", default=None, help="directory for a torch.profiler trace")
    ap.add_argument("--fp32", action="store_true")
    tail = ap.add_mutually_exclusive_group()
    tail.add_argument("--lr_tail", action="store_true", help="forward: the LR-domain tail")
    tail.add_argument("--int8", action="store_true", help="forward: the int8 ups tier")
    ap.add_argument("--fused", action="store_true",
                    help="the fused upsample kernel for each canonical-tail stage")
    ap.add_argument("--vgg", action="store_true",
                    help="--step gan: the VGG19 content loss (fixed-seed weights)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = script_device(args.device)
    b, h, w = (int(v) for v in args.shape.split("x"))
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    if args.step == "forward":
        fn = forward_fn(args, b, h, w, device, dtype)
        grad = torch.inference_mode()
    else:
        fn = step_fn(args, b, h, w, device)
        grad = torch.enable_grad()
    precision = torch.backends.cudnn.flags(enabled=True, allow_tf32=not args.fp32)
    with grad, precision:
        fn()
        synchronize(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        with FlopCounterMode(display=False) as counter:
            fn()
        synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        trace = None
        if args.trace:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities) as prof:
                fn()
                synchronize(device)
            os.makedirs(args.trace, exist_ok=True)
            trace = os.path.join(args.trace, "trace.json")
            prof.export_chrome_trace(trace)
    flops = counter.get_total_flops()
    by_op = {str(op): n for op, n in sorted(counter.get_flop_counts()["Global"].items(),
                                            key=lambda kv: -kv[1])}
    form = ("int8 ups" if args.int8 else "LR-domain tail" if args.lr_tail
            else "fused canonical" if args.fused else "canonical")
    print(f"program        : {args.step} @ {args.shape} {str(dtype)[6:]}"
          f"{' ' + form if args.step == 'forward' else ''}")
    print(f"flops          : {flops / 1e9:.3f} GFLOP")
    for op, n in by_op.items():
        print(f"  {op:26s}: {n / 1e9:.3f} GFLOP")
    if peak is not None:
        print(f"peak memory    : {peak / 2**20:.1f} MiB")
    if trace:
        print(f"trace written  : {trace}")
    return emit({
        "step": args.step,
        "shape": args.shape,
        "dtype": str(dtype)[6:],
        "form": form if args.step == "forward" else None,
        "flops": flops,
        "flops_by_op": by_op,
        "peak_memory_bytes": peak,
        "uncounted_ops": ["fast_srgan.instance_norm_prelu", "fast_srgan.instance_norm_add",
                          "fast_srgan.quantize_act", "fast_srgan.pixel_shuffle_phase_major"],
        "trace": trace,
    }, device)


if __name__ == "__main__":
    main()
