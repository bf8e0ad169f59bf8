"""MambaIR video through ``SRInferenceEngine.stream``: the ``stream_hat``
driver's closed loop over a cycled set of distinct structured frames, with
the engine built from a MambaIR state_dict drawn from the seed
(``reference/mambair.py``'s ``seeded_state_dict``, the configuration's
``assumed`` rule) and held to the plain MambaIR reference.

Window: frames handed to the caller from its opening to the first frame
past ``--seconds``, over that time (``frames_per_s``). Check: for each
distinct input frame, its last output in the window against the
reference's upscale of it (fp32, TF32 off, in blocks of REFERENCE_BLOCK
frames), in uint8 counts over all of them (``compare.CountError``).
Counters: the window's frames, the canonical forward's least time a frame
(``flops_mambair.least_seconds``), the rise of the model's ``prepares`` over
the window and one eager ``upscale_batch`` of the cell's frames after it
(the eager batch is what shows a cache that misses, since a replay would
not), the SS2Ds a forward of that eager batch (``mambair.ss2d.calls``, one
``selective_scan`` launch each: what a graph replays), and the output's
spread in counts and share clipped at 0 or 255 (the seeded weights' rule
wants at least 20 counts and at most 2%).
"""

from __future__ import annotations

import itertools
import sys
import time

import numpy as np
import torch

from benchmark import compare, flops_mambair, inputs
from benchmark.reference.mambair import seeded_state_dict, upscale_u8

#: frames the reference computes at once: the scan's two-level form walks
#: every chunk of every frame of a block together, so larger blocks launch
#: fewer, larger operations (16 frames: ~25 GB at 180 x 320)
REFERENCE_BLOCK = 16


def make_engine(state_dict, config, device):
    from fast_srgan_torch.inference import SRInferenceEngine

    return SRInferenceEngine(state_dict, dtype=getattr(torch, config["dtype"]), device=device,
                             lr_tail=config.get("lr_tail", True))


def _ss2d_calls() -> int:
    from fast_srgan_torch.models.mambair import ss2d

    return ss2d.calls


def run(cell):
    mix, config, device = cell.traffic, cell.config, cell.device
    arch = flops_mambair.arch_of(config)
    with cell.spans("setup.inputs"):
        state_dict = seeded_state_dict(arch, cell.seed)
        frames = inputs.frames(mix, cell.seed, device)
    n_distinct, bs = len(frames), mix["batch"]
    with cell.spans("setup.engine"):
        engine = make_engine(state_dict, config, device)
    with cell.spans("setup.warm"):
        warm = itertools.islice(itertools.cycle(frames), cell.workload["warm_batches"] * bs)
        for _ in engine.stream(warm, batch_size=bs):
            pass
        if device != "cpu":
            torch.cuda.synchronize()

    model = engine.model
    prepares = model.prepares
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
    calls, forwards = _ss2d_calls(), engine.forward_calls
    engine.upscale_batch(frames[:bs])
    prepares = model.prepares - prepares
    scans_a_forward = (_ss2d_calls() - calls) / (engine.forward_calls - forwards)
    del engine, model, stream
    compare.free(device)

    ref_w = {k: v.to(device) for k, v in state_dict.items()}
    err = compare.CountError()
    keys = sorted(last)
    t_ref = time.perf_counter()
    for i in range(0, len(keys), REFERENCE_BLOCK):
        block = keys[i:i + REFERENCE_BLOCK]
        ref = upscale_u8(ref_w, arch, torch.from_numpy(frames[block]).to(device))
        for j, k in enumerate(block):
            err.add(last[k], ref[j])
        del ref
    print(f"reference: {len(keys)} frames in {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    served = np.stack([last[k] for k in keys]).astype(np.float32)
    h, w = frames.shape[1:3]
    return {
        "attempted": n, "failed": 0,
        "e2e": {"frames_per_s": n / (t1 - t0)},
        "counters": {"frames": n, "window_s": t1 - t0 - cell.paused(), "batch": bs,
                     "frame_hw": (h, w), "arch": arch,
                     "frame_least_s": flops_mambair.least_seconds(arch, h, w),
                     "prepares": prepares,
                     "scan_launches_a_forward": scans_a_forward,
                     "out_std_counts": float(served.std()),
                     "out_clipped_pct": 100.0 * float(((served == 0) | (served == 255)).mean())},
        "checks": err.readings(cell.workload["limits"]),
        "memory_peak_bytes": peak,
    }
