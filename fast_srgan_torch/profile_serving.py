"""Read, from a torch.profiler trace, where a serving forward's device time
goes: the bf16 engine against the int8 tier, on one CUDA card.

    python -m fast_srgan_torch.profile_serving [--batch 8] [--forwards 30]
        [--profiled 5] [--order BQQB] [--out FILE]

The pretrained 4x generator on a batch of 180x320 uint8 frames staged on
the card (uniform noise from ``--seed``), one engine per letter of
``--order`` (B: bf16; Q: int8 ``ups`` with bf16 glue, calibrated on the
batch). For each, after warm-up: ``host_ms`` per ``forward_u8`` over
``--forwards`` calls each ended by a synchronize, then ``--profiled``
forwards under torch.profiler (device activity only) and from that window
alone the wall and busy ms, the idle share, the kernels per forward and the
kernels with the most device time (``train.profile_steps.profile_kind``).

Prints one JSON line per arm and writes all of them, with the card's name
and power limit, to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from fast_srgan_torch.checkpoints.npz_io import load_npz_params
from fast_srgan_torch.inference import SRInferenceEngine
from fast_srgan_torch.train.profile_steps import host_ms_per_call, profile_kind

CHECKPOINT = "models/generator_pretrained.npz"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--forwards", type=int, default=30)
    ap.add_argument("--profiled", type=int, default=5)
    ap.add_argument("--order", default="BQQB")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=CHECKPOINT)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    params = load_npz_params(args.checkpoint)
    rng = np.random.default_rng(args.seed)
    frames = rng.integers(0, 256, (args.batch, 180, 320, 3), dtype=np.uint8)
    x = torch.from_numpy(frames).to("cuda")
    budget = args.batch * 180 * 320
    engines = {
        "B": SRInferenceEngine(params, device="cuda", pixel_budget=budget),
        "Q": SRInferenceEngine(params, device="cuda", pixel_budget=budget,
                               quantize=True, calib_batches=[frames]),
    }
    records = []
    for arm in args.order:
        engine = engines[arm]

        def forward():
            engine.forward_u8(x)

        for _ in range(3):
            forward()
        rec = {"arm": {"B": "bf16", "Q": "int8 ups"}[arm], "batch": args.batch,
               "host_ms": host_ms_per_call(forward, args.forwards),
               **profile_kind(forward, args.profiled, top=20)}
        records.append(rec)
        print(json.dumps({k: v for k, v in rec.items() if k != "top_ms_per_step"}),
              flush=True)
    print(card, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "args": vars(args), "records": records}, f, indent=1)


if __name__ == "__main__":
    main()
