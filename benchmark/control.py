"""Readings the limits of ``correct`` are set from, on the card at each
cell's own size (the benchmark's own runs never run this). Every arm runs
the cell through the harness (``run_cell``): its window, its driver and
its comparison against the cell's limits, so each line says whether the
run came out correct.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 3 \\
        --arm program|control:<kind>|fault:<name> [--numbers off6_pct,...] [--out FILE]

  * ``program``: the cell's runs as they are: the lower readings;
  * ``control:<kind>``: one of the cell's ``controls``, in the program's
    place at the nearest precision below the configuration's:
      - ``program_path``: the program with its own lower-precision path
        switched on (the entry's ``config`` keys, e.g. an int8 tier);
      - ``reference_int4``: the plain reference in the engine's place, the
        configuration's int8 convs computed in int4 (weights per output
        channel, activations per tensor at the 99.99th percentile of |x|
        over the calibration frames);
  * ``fault:<name>``: the cell's timed path broken underneath
    (:data:`FAULTS`): an answer altered where the engine produces it.

``--numbers`` reads more of the driver's numbers beside the cell's own.
Prints one JSON line a seed: the arm, the seed, ``correct`` and each
number's reading.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import sys
import time
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import compare  # noqa: E402
from benchmark.compare import MISSING  # noqa: E402
from benchmark.harness import load_json, load_module, run_cell  # noqa: E402
from benchmark.reference.generator import fp32_exact, upscale_u8, weights_from_tree  # noqa: E402


def int4_hook(act_scales: Dict[str, torch.Tensor], only: Callable[[str], bool]):
    """Symmetric int4 fake quantization of the convs ``only`` admits:
    weights per output channel, activations at their calibrated scale."""
    def hook(name, x, w, conv):
        if not only(name):
            return conv(x, w)
        s = act_scales[name]
        xq = torch.clamp(torch.round(x * (7.0 / s)), -8, 7) * (s / 7.0)
        sw = w.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-30)
        wq = torch.round(w * (7.0 / sw)) * (sw / 7.0)
        return conv(xq, wq)
    return hook


def calibrate(w, frames_u8: torch.Tensor, only: Callable[[str], bool], q: float = 99.99):
    """The q-th percentile of |x| at each admitted conv's input over the
    fp32 reference's forward of the frames."""
    seen: Dict[str, list] = {}

    def hook(name, x, wt, conv):
        if only(name):
            seen.setdefault(name, []).append(x.detach().abs().flatten())
        return conv(x, wt)

    upscale_u8(w, frames_u8, hook)
    out = {}
    for name, parts in seen.items():
        flat = torch.cat(parts)
        k = max(1, int(round(flat.numel() * (1 - q / 100.0))))
        out[name] = torch.topk(flat, k).values[-1]
    return out


def ups(name: str) -> bool:
    return name.startswith("upsampling.")


class Int4ReferenceEngine:
    """The plain reference in the engine's place in the stream driver: its
    ``ups`` convs in int4 (scales from the first ``calibration_frames``
    frames, as the program calibrates), everything else fp32."""

    def __init__(self, tree, config, device, frames):
        self.device = device
        self.w = weights_from_tree(tree, device)
        calib = torch.from_numpy(frames[:config["calibration_frames"]]).to(device)
        with torch.no_grad(), fp32_exact():
            self.hook = int4_hook(calibrate(self.w, calib, ups), ups)

    def stream(self, frames, batch_size: int = 8):
        it = iter(frames)
        while True:
            batch = list(itertools.islice(it, batch_size))
            if not batch:
                return
            x = torch.from_numpy(np.stack(batch)).to(self.device)
            yield from upscale_u8(self.w, x, self.hook).cpu().numpy()


def _int4_engine(old):
    def make_engine(tree, config, device, frames):
        return Int4ReferenceEngine(tree, config, device, frames)
    return make_engine


@contextlib.contextmanager
def patched(obj, attr: str, make: Callable) -> Iterator[None]:
    old = getattr(obj, attr)
    setattr(obj, attr, make(old))
    try:
        yield
    finally:
        setattr(obj, attr, old)


def _altered(old):
    """The engine's uint8 output with one frame of each batch inverted."""
    def forward_u8(self, x_u8):
        out = old(self, x_u8).clone()
        out[0] = 255 - out[0]
        return out
    return forward_u8


def fault_patches(name: str):
    """The patches that plant fault ``name`` in the program."""
    from fast_srgan_torch.inference import SRInferenceEngine

    return {"altered": [(SRInferenceEngine, "forward_u8", _altered)]}[name]


#: the faults each driver's cells can have
FAULTS = {"stream": ("altered",)}


def control_patches(name: str, control: Dict) -> Tuple[list, Dict]:
    """(patches, overrides) that put control ``control`` in the program's
    place in cell ``name``'s run."""
    if control["kind"] == "program_path":
        return [], {"config": control["config"]}
    if control["kind"] == "reference_int4":
        return [(load_module("drivers", load_json("workloads", name)["driver"]), "make_engine",
                 _int4_engine)], {}
    raise ValueError(f"unknown control kind {control['kind']!r}")


def reading(name: str, seed: int, seconds: float, arm: str, device: str = "cuda",
            overrides=None, numbers=()) -> Dict:
    """One run of ``arm`` (see the module's docstring) through the
    harness's own comparison: the result object, ``correct`` and each
    check's value beside its limit. ``numbers`` reads those numbers of the
    driver's besides the cell's own, at the limit MISSING."""
    overrides = {k: dict(v) for k, v in (overrides or {}).items()}
    if numbers:
        limits = {**{k: MISSING for k in numbers}, **load_json("workloads", name)["limits"]}
        overrides["workload"] = {**overrides.get("workload", {}), "limits": limits}
    patches = []
    if arm.startswith("fault:"):
        patches = fault_patches(arm.split(":", 1)[1])
    elif arm.startswith("control:"):
        kind = arm.split(":", 1)[1]
        controls = [c for c in load_json("workloads", name)["controls"] if c["kind"] == kind]
        if not controls:
            raise ValueError(f"cell {name} has no control {kind!r}")
        patches, more = control_patches(name, controls[0])
        for key, values in more.items():
            overrides[key] = {**values, **overrides.get(key, {})}
    elif arm != "program":
        raise ValueError(f"unknown arm {arm!r}")
    with contextlib.ExitStack() as stack:
        for obj, attr, make in patches:
            stack.enter_context(patched(obj, attr, make))
        return run_cell(name, seed, seconds, False, device, overrides=overrides)


def arms(name: str) -> List[str]:
    """Every arm a cell's limits are held against: its controls and faults."""
    cell = load_json("workloads", name)
    return ([f"control:{c['kind']}" for c in cell["controls"]]
            + [f"fault:{f}" for f in FAULTS[cell["driver"]]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--arm", default="program")
    ap.add_argument("--numbers", default="", help="comma-separated numbers to read besides the cell's")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card: the readings are taken on the card", file=sys.stderr)
        return 2
    load_json("workloads", args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        try:
            result = reading(args.workload, seed, args.seconds, args.arm, "cuda", None,
                             [n for n in args.numbers.split(",") if n])
            line = {"workload": args.workload, "arm": args.arm, "seed": seed,
                    "correct": result["correct"],
                    "readings": {k: c["value"] for k, c in result["checks"].items()},
                    "s": time.perf_counter() - t}
        except Exception as e:  # a control that crashes gives no reading
            line = {"workload": args.workload, "arm": args.arm, "seed": seed,
                    "error": repr(e)}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        compare.free("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
