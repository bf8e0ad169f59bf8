"""Readings the SwinIR cell's limit of ``correct`` is set from, on the card at
the cell's own size (the benchmark's own runs never run this). Every arm
runs the cell through the harness (``run_cell``): its window, its driver
and its comparison against the cell's limits, so each line says whether
the run came out correct.

    python3 benchmark/control_swinir.py --workload swinir-x4-video-bf16 \\
        --seeds 1,2,3 --seconds 3 [--arm program|control:fp8|fault:<name>|all] [--out FILE]

  * ``program``: the cell's runs as they are: the lower readings;
  * ``control:fp8``: the program with each Swin layer's output, the
    residual stream, rounded to ``float8_e4m3fn`` and back: the precision
    below the configuration's bf16;
  * ``fault:<name>``: the timed path broken underneath (the workload's ``faults``):
    ``no_shift_mask`` (the shifted layers' masks built without the shift
    mask), ``no_rel_bias`` (every layer's relative-position bias zero) and
    ``altered`` (one frame of each batch inverted where the engine
    produces it, in the forward that ``stream`` captures).

Prints one JSON line a seed and arm: ``correct``, each check's reading,
and the output's spread in counts and share clipped.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Dict, List

import torch

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import compare  # noqa: E402
from benchmark.control import patched  # noqa: E402
from benchmark.harness import load_json, load_module, run_cell  # noqa: E402


def _no_shift_mask(old):
    def shift_mask(*args, **kwargs):
        return torch.zeros_like(old(*args, **kwargs))
    return shift_mask


def _no_rel_bias(old):
    def relative_position_bias(table, window):
        return torch.zeros_like(old(table, window))
    return relative_position_bias


def _fp8_layers(old):
    """Each Swin layer's output rounded to float8_e4m3fn and back."""
    def forward(self, x, mask):
        return old(self, x, mask).to(torch.float8_e4m3fn).to(x.dtype)
    return forward


def _altered(old):
    """The forward's uint8 output with its first frame inverted."""
    def forward_u8(self, x_u8):
        out = old(self, x_u8).clone()
        out[0] = 255 - out[0]
        return out
    return forward_u8


def arm_patches(arm: str) -> list:
    """(object, attribute, make) of each patch that puts ``arm`` in the
    program's place."""
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.models import swinir

    return {
        "program": [],
        "control:fp8": [(swinir.SwinLayer, "forward", _fp8_layers)],
        "fault:no_shift_mask": [(swinir, "shift_mask", _no_shift_mask)],
        "fault:no_rel_bias": [(swinir, "relative_position_bias", _no_rel_bias)],
        "fault:altered": [(SRInferenceEngine, "_forward_u8", _altered)],
    }[arm]


def arms(name: str) -> List[str]:
    """Every arm a cell's limit is held against: its controls and faults."""
    cell = load_json("workloads", name)
    return ([f"control:{c['kind']}" for c in cell["controls"]]
            + [f"fault:{f}" for f in cell["faults"]])


def reading(name: str, seed: int, seconds: float, arm: str, device: str = "cuda",
            overrides=None) -> Dict:
    """One run of ``arm`` through the harness's own comparison: its result
    object, with the driver's counters beside it under ``counters``."""
    counters: Dict = {}

    def keep(old):
        def run(cell):
            outcome = old(cell)
            counters.update(outcome["counters"])
            return outcome
        return run

    driver = load_module("drivers", load_json("workloads", name)["driver"])
    with contextlib.ExitStack() as stack:
        for obj, attr, make in arm_patches(arm) + [(driver, "run", keep)]:
            stack.enter_context(patched(obj, attr, make))
        result = run_cell(name, seed, seconds, False, device, overrides=overrides)
    return dict(result, counters=counters)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--arm", default="all", help="program, control:<kind>, fault:<name> or all")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card: the readings are taken on the card", file=sys.stderr)
        return 2
    chosen = ["program"] + arms(args.workload) if args.arm == "all" else [args.arm]
    for arm in chosen:
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            try:
                result = reading(args.workload, seed, args.seconds, arm)
                c = result["counters"]
                line = {"workload": args.workload, "arm": arm, "seed": seed,
                        "correct": result["correct"],
                        "readings": {k: v["value"] for k, v in result["checks"].items()},
                        "out_std_counts": c.get("out_std_counts"),
                        "out_clipped_pct": c.get("out_clipped_pct"),
                        "frames_per_s": result["metrics"].get("frames_per_s", {}).get("value"),
                        "s": time.perf_counter() - t}
            except Exception as e:  # a control that crashes gives no reading
                line = {"workload": args.workload, "arm": arm, "seed": seed, "error": repr(e)}
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
            compare.free("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
