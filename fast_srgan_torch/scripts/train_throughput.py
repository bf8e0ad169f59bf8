"""Training step times on the port: the pretrain step and the full GAN step
(D update, then G update) at the reference's training shape.

    python -m fast_srgan_torch.scripts.train_throughput [--device cuda]
    STEPS=50 BATCH=24 VGG=pixel ACCUM=1 SHARED=1 REMAT_VGG=0 VGG_CONCAT=0 \\
        FUSED=0,1   (environment)

The counterpart of ``scripts/train_throughput.py``: the reference
configuration (64/8 4x generator, 64-filter discriminator, batch 24 of
96x96 uint8 crops, bf16 autocast) through
``train.steps.build_bundle`` with its step options from the environment:
``VGG`` the content loss (``pixel``, ``init`` for VGG19 with fixed-seed
weights, or a torchvision ``.pth``), ``ACCUM`` ``training.grad_accum``,
``SHARED`` ``training.gan_shared_forward``, ``REMAT_VGG`` and
``VGG_CONCAT`` their options, and ``FUSED`` the upsample arms to run, a
comma list of 0 (conv + the shuffle kernel) and 1 (the fused upsample
kernel, ``kernels.fused_upsample``). Crops are 4 batches of noise staged
on the device (seed 0), taken in turn.

Each arm builds its bundle (weights from seed 0), takes 3 steps of each
kind, then times ``STEPS`` steps of each: host ms a step, each step ended
by a synchronize (``train.profile_steps.host_ms_per_call``). Prints one
JSON object with both kinds' ms a step, steps/s and crops/s for each arm.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from fast_srgan_torch.config import default_config
from fast_srgan_torch.scripts.measure import emit, script_device
from fast_srgan_torch.train.profile_steps import host_ms_per_call
from fast_srgan_torch.train.steps import build_bundle


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = script_device(args.device)
    steps = int(os.environ.get("STEPS", "50"))
    batch = int(os.environ.get("BATCH", "24"))
    vgg = os.environ.get("VGG", "pixel")
    accum = int(os.environ.get("ACCUM", "1"))
    shared = os.environ.get("SHARED", "1") != "0"
    remat_vgg = os.environ.get("REMAT_VGG", "0") == "1"
    vgg_concat = os.environ.get("VGG_CONCAT", "0") == "1"
    fused_arms = [{"0": False, "1": True}[v] for v in os.environ.get("FUSED", "0,1").split(",")]

    training = {"bf16": True, "batch_size": batch, "vgg_weights": vgg, "grad_accum": accum,
                "gan_shared_forward": shared, "remat_vgg": remat_vgg, "vgg_concat": vgg_concat}
    hr = None
    rng = np.random.default_rng(0)
    arms = []
    for fused in fused_arms:
        config = default_config(training=training, kernels={"fused_upsample": fused})
        hr = config.data.lr_image_size * config.data.scale_factor
        bundle = build_bundle(config, device, torch.Generator().manual_seed(0))
        staged = [torch.from_numpy(rng.integers(0, 256, (batch, hr, hr, 3), dtype=np.uint8))
                  .to(device) for _ in range(4)]
        turn = iter(range(10**9))
        kinds = {
            "pretrain": lambda: bundle.pretrain_step(staged[next(turn) % 4]),
            "gan": lambda: bundle.gan_step(staged[next(turn) % 4]),
        }
        row = {"fused": fused}
        for kind, fn in kinds.items():
            for _ in range(3):
                fn()
            ms = host_ms_per_call(fn, steps, device)
            row.update({f"{kind}_ms": round(ms, 3), f"{kind}_steps_per_s": round(1000 / ms, 2),
                        f"{kind}_crops_per_s": round(batch * 1000 / ms, 1)})
        arms.append(row)
        print(f"# {row}", flush=True)
        del bundle, staged
    return emit({
        "batch": batch,
        "hr_crop": hr,
        "steps": steps,
        "content_loss": "pixel" if vgg == "pixel" else "vgg",
        "variant": {"shared": shared, "remat_vgg": remat_vgg, "vgg_concat": vgg_concat,
                    "accum": accum},
        "arms": arms,
    }, device)


if __name__ == "__main__":
    main()
