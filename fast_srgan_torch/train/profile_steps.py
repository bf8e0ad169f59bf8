"""Time the training steps on one CUDA card and read, from a torch.profiler
trace, where a step's time goes.

    python -m fast_srgan_torch.train.profile_steps [--steps 30] [--profiled 5]
        [--order FUUF] [--out FILE]
    python -m fast_srgan_torch.train.profile_steps --feed [--steps 40] [--out FILE]

The reference configuration (64/8 4x generator, 64-filter discriminator,
VGG19 features with fixed-seed weights, batch 24 of 96x96 uint8 crops,
bf16 autocast), once per letter of ``--order`` (F: fused upsample kernel,
U: conv + shuffle kernel). Each arm builds its bundle, warms up, and then,
for each step kind (pretrain, GAN), in the same run:

  * ``host_ms``: host ms per step over ``--steps`` steps, each ended by a
    synchronize, without the profiler;
  * then ``--profiled`` steps under torch.profiler, and from that window
    alone: ``wall_ms`` (host clock around it, per step), ``busy_ms`` (the
    union of the CUDA kernels' intervals, per step), ``idle_share`` =
    1 - busy/wall, the kernels per step and the kernels with the most device
    time. Only device activity is traced, so the host runs nearly as it
    does unprofiled; what overhead remains is inside that wall time.

Prints one JSON line per arm and step kind, and writes all of them, with
the card's name and power limit, to ``--out``.

``--feed`` times, instead, what the trainer adds around the steps (fused
arm): ms a step over ``--steps`` steps ended by one synchronize, in turns,
with the batch already on the card, with a host batch through the
trainer's ``PinnedFeed``, and with a ``PrefetchLoader`` of 16 or 1 crop
threads running beside the steps, with and without the feed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from fast_srgan_torch.config import default_config
from fast_srgan_torch.data.pipeline import CropSampler, PrefetchLoader
from fast_srgan_torch.train.steps import build_bundle
from fast_srgan_torch.train.trainer import PinnedFeed


def reference_config(fused: bool):
    return default_config(
        kernels={"use_pallas": True, "fused_upsample": fused},
        training={"vgg_weights": "init"},
    )


def host_ms_per_call(fn, n: int, device="cuda") -> float:
    """Host ms a call of ``fn()`` over ``n`` calls, each ended by a
    synchronize of ``device`` (none on the CPU, whose calls return done)."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        sync()
    return 1000 * (time.perf_counter() - t0) / n


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profile_kind(fn, n: int, top: int = 12) -> dict:
    torch.cuda.synchronize()
    # device activity only: recording every host op would slow the host,
    # which is the bottleneck being measured
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1000 * (time.perf_counter() - t0) / n
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = _busy_us((e.time_range.start, e.time_range.end) for e in kernels) / 1000 / n
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "wall_ms": wall_ms,
        "busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / wall_ms,
        "kernels_per_step": len(kernels) / n,
        "top_ms_per_step": [[k[:100], v / 1000 / n] for k, v in heavy],
    }


def feed_records(bundle, batch, steps: int) -> list:
    """The ``--feed`` arms for each step kind, in turns: one round, then the
    same arms in reverse order (a drift of the host's speed over the run
    then weighs on every arm alike). An arm is (crop threads, pinned feed):
    (0, False) is the bare step on a batch already on the card; (0, True)
    feeds one host batch through ``PinnedFeed`` each step; (n, False) takes
    each batch from a settled loader of n threads but steps on the card's
    batch; (n, True) is the trainer's path."""
    feed = PinnedFeed(torch.device("cuda"))
    host_batch = batch.cpu().numpy()
    records = []
    with tempfile.TemporaryDirectory() as root:
        rng = np.random.default_rng(0)
        paths = []
        for i in range(16):
            paths.append(os.path.join(root, f"{i}.npy"))
            np.save(paths[-1], rng.integers(0, 256, (256, 256, 3), dtype=np.uint8))
        arms = [(0, False), (0, True), (16, False), (16, True), (1, True)]
        for kind in ("pretrain", "gan"):
            fn = bundle.pretrain_step if kind == "pretrain" else bundle.gan_step
            for turn in range(2):
                for workers, fed in arms if turn == 0 else arms[::-1]:
                    it = None
                    if workers:
                        loader = PrefetchLoader(CropSampler(paths, 24, 4, seed=1), 24,
                                                10 * steps, workers=workers)
                        it = loader.iter_from(0)
                        next(it)
                        time.sleep(1.0)  # the lead window fills, the threads rest
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(steps):
                        host = next(it) if it is not None else host_batch
                        fn(feed(host) if fed else batch)
                    torch.cuda.synchronize()
                    rec = {"kind": kind, "threads": workers, "pinned_feed": fed,
                           "ms": 1000 * (time.perf_counter() - t0) / steps}
                    if it is not None:
                        it.close()
                    records.append(rec)
                    print(json.dumps(rec), flush=True)
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--profiled", type=int, default=5)
    ap.add_argument("--order", default="FUUF")
    ap.add_argument("--seed", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--feed", action="store_true",
                    help="time the trainer's loader and H2D around the steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_steps needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    rng = np.random.default_rng(args.seed)
    batch = torch.from_numpy(rng.integers(0, 256, (24, 96, 96, 3), dtype=np.uint8))
    batch = batch.to("cuda")
    records = []
    if args.feed:
        bundle = build_bundle(reference_config(True), "cuda", torch.Generator().manual_seed(0))
        for _ in range(3):
            bundle.pretrain_step(batch)
            bundle.gan_step(batch)
        records = feed_records(bundle, batch, args.steps)
    for arm in "" if args.feed else args.order:
        fused = {"F": True, "U": False}[arm]
        bundle = build_bundle(reference_config(fused), "cuda", torch.Generator().manual_seed(0))
        steps = {
            "pretrain": lambda: bundle.pretrain_step(batch),
            "gan": lambda: bundle.gan_step(batch),
        }
        for fn in steps.values():
            for _ in range(3):
                fn()
        for kind, fn in steps.items():
            host_ms = host_ms_per_call(fn, args.steps)
            rec = {"fused": fused, "kind": kind, "host_ms": host_ms,
                   **profile_kind(fn, args.profiled)}
            records.append(rec)
            print(json.dumps({k: v for k, v in rec.items() if k != "top_ms_per_step"}),
                  flush=True)
    print(card, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "args": vars(args), "records": records}, f, indent=1)


if __name__ == "__main__":
    main()
