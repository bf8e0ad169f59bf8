"""Read, from a torch.profiler trace, where a serving forward's device time
goes: the bf16 engine against the int8 tier and the bucketed (masked)
forward, on one CUDA card.

    python -m fast_srgan_torch.profile_serving [--batch 8] [--forwards 30]
        [--profiled 5] [--order BQMMQB] [--out FILE]

The pretrained 4x generator on a batch of 180x320 uint8 frames staged on
the card (uniform noise from ``--seed``), one engine per letter of
``--order`` (B: bf16; Q: int8 ``ups`` with bf16 glue, calibrated on the
batch; M: bf16 with ``bucket=32``, the frames zero-padded to 192x320 and run
through ``forward_u8_masked``, as the server runs them). For each, after
warm-up: ``host_ms`` per forward over
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
    ap.add_argument("--order", default="BQMMQB")
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
    padded = torch.zeros((args.batch, 192, 320, 3), dtype=torch.uint8, device="cuda")
    padded[:, :180] = x
    valid = [torch.full((args.batch,), v, dtype=torch.int32, device="cuda") for v in (180, 320)]
    budget = args.batch * 192 * 320
    engines = {
        "B": SRInferenceEngine(params, device="cuda", pixel_budget=budget),
        "Q": SRInferenceEngine(params, device="cuda", pixel_budget=budget,
                               quantize=True, calib_batches=[frames]),
        "M": SRInferenceEngine(params, device="cuda", pixel_budget=budget, bucket=32),
    }
    names = {"B": "bf16", "Q": "int8 ups", "M": "bf16 bucket=32 (192x320 masked)"}
    records = []
    for arm in args.order:
        engine = engines[arm]

        def forward():
            if arm == "M":
                engine.forward_u8_masked(padded, *valid)
            else:
                engine.forward_u8(x)

        for _ in range(3):
            forward()
        rec = {"arm": names[arm], "batch": args.batch,
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
