"""Video through ``SRInferenceEngine.stream``: a closed loop over a cycled set
of distinct structured frames, each output frame taken by the caller as it
comes (the ``infer --video`` path without the codec).

Window: frames handed to the caller from its opening to the first frame
past ``--seconds``, over that time, reported under the cell's
``rate_metric`` (``frames_per_s`` where it names none). Check: for each
distinct input frame, its last output in the window against the plain
reference's upscale of it (fp32, TF32 off), in uint8 counts over all of
them (``compare.CountError``).
"""

from __future__ import annotations

import itertools
import os
import sys
import time

import numpy as np
import torch

from benchmark import compare, flops, inputs, weights
from benchmark.harness import ROOT
from benchmark.reference.generator import upscale_u8, weights_from_tree


def make_engine(tree, config, device, frames: np.ndarray):
    from fast_srgan_torch import quant
    from fast_srgan_torch.inference import SRInferenceEngine

    kw = {}
    if config.get("quantize"):
        # video.calibration_frames' rule: the stream's first frames
        kw = {"quantize": config["quantize"], "calib_batches": [
            quant.calibration_batch_from_images(list(frames[:config["calibration_frames"]]))]}
    return SRInferenceEngine(tree, dtype=getattr(torch, config["dtype"]), device=device,
                             lr_tail=config.get("lr_tail", True), **kw)


def run(cell):
    mix, config, device = cell.traffic, cell.config, cell.device
    with cell.spans("setup.inputs"):
        tree = weights.load_npz_tree(os.path.join(ROOT, config["weights"]))
        frames = inputs.frames(mix, cell.seed, device)
    n_distinct, bs = len(frames), mix["batch"]
    with cell.spans("setup.engine"):
        engine = make_engine(tree, config, device, frames)
    with cell.spans("setup.warm"):
        warm = itertools.islice(itertools.cycle(frames), cell.workload["warm_batches"] * bs)
        for _ in engine.stream(warm, batch_size=bs):
            pass
        if device != "cpu":
            torch.cuda.synchronize()

    last = {}
    n = 0
    stream = engine.stream(itertools.cycle(frames), batch_size=bs)
    t0 = cell.begin()
    deadline = t0 + cell.seconds
    while True:
        with cell.spans("stream"):
            out = next(stream)
        last[n % n_distinct] = out
        n += 1
        if n % bs == 0:
            cell.tick()
            if time.perf_counter() >= deadline:
                break
    t1 = time.perf_counter()
    cell.end()
    stream.close()
    print("frames by quarter of the window: " + cell.spans.quarters("stream", t0, t1),
          file=sys.stderr)
    peak = compare.memory_peak(device)
    del engine, stream
    compare.free(device)

    ref_w = weights_from_tree(tree, device)
    err = compare.CountError()
    keys = sorted(last)
    for i in range(0, len(keys), bs):
        block = keys[i:i + bs]
        ref = upscale_u8(ref_w, torch.from_numpy(frames[block]).to(device))
        for j, k in enumerate(block):
            err.add(last[k], ref[j])
    h, w = frames.shape[1:3]
    int8_ups = config.get("quantize") == "ups"
    return {
        "attempted": n, "failed": 0,
        "e2e": {cell.workload.get("rate_metric", "frames_per_s"): n / (t1 - t0)},
        "counters": {"frames": n, "window_s": t1 - t0 - cell.paused(), "batch": bs, "frame_hw": (h, w),
                     "frame_least_s": flops.generator_least_seconds(h, w, int8_ups=int8_ups)},
        "checks": err.readings(cell.workload["limits"]),
        "memory_peak_bytes": peak,
    }
