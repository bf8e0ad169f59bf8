#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: build, check, serve, time.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card, nvcc (PATH,
$CUDA_HOME or /usr/local/cuda) and no network. Phases, each printing its
own line; any failure exits non-zero and prints no result:

  1. device: the card's name and nvidia-smi's name and power limit;
  2. build: the CUDA kernels from fast_srgan_torch/csrc with nvcc;
  3. kernel: the fused instance norm + PReLU against its plain PyTorch
     version on the card, at the serving path's shape and a ragged one,
     in bf16 and fp32, and on a near-constant input; both timed;
  4. serving: the pretrained 4x generator (models/generator_pretrained.npz,
     bf16) answers 12 requests from 4 threads through the micro-batcher;
     the kernel's launch count must be n_layers x the generator forwards;
  5. fidelity: the card's fp32 engine against the CPU fp32 engine, and the
     card's bf16 replies against its fp32 ones (PSNR);
  6. throughput: 180x320 -> 720p bf16 frames/s over 200 frames staged on
     the card (an indicative number, not a benchmark).

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(REPO, "models", "generator_pretrained.npz")
KERNEL_SOURCE = "fast_srgan_torch/csrc/instance_norm.cu"
KERNEL_REPLACES = "fast_srgan_tpu/kernels/instance_norm.py:50"

FP32_TOL = 2e-5
BF16_TOL = 2e-2
PSNR_MIN_DB = 40.0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def make_frame(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A smooth procedural uint8 HWC frame (sinusoids plus mild noise)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        for _ in range(4):
            fy, fx = rng.uniform(0.5, 6.0, 2) / np.array([h, w])
            img[..., c] += rng.uniform(10, 30) * np.sin(
                2 * np.pi * (fy * yy + fx * xx) + rng.uniform(0, 2 * np.pi)
            )
    img += 127.5 + rng.normal(0.0, 3.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of fn() on the card, by CUDA events."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0**2 / mse))


def phase_device() -> tuple:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(
        f"[1 device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda},"
        f" {torch.cuda.device_count()} device(s)"
    )
    print(card, flush=True)
    return kind, card


def phase_build() -> None:
    from fast_srgan_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    info = [
        line.strip() for line in (_build.build_log or "").splitlines()
        if "registers" in line or "spill" in line
    ]
    print(
        f"[2 build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
        f"{time.perf_counter() - t0:.1f} s; ptxas: {' | '.join(info)}",
        flush=True,
    )


def phase_kernel() -> dict:
    from fast_srgan_torch.kernels.instance_norm import (
        instance_norm_prelu,
        instance_norm_prelu_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    alpha = torch.tensor([0.173], device=dev)

    def activation(shape, dtype, dist):
        b, c = shape[0], shape[1]
        # per-channel scale and shift, so the statistics matter
        scale = torch.rand((1, c, 1, 1), device=dev, generator=gen) * 1.5 + 0.5
        shift = torch.rand((1, c, 1, 1), device=dev, generator=gen) * 4 - 2
        if dist == "uniform":
            z = torch.rand(shape, device=dev, generator=gen) * 2 - 1
        else:
            z = torch.randn(shape, device=dev, generator=gen)
        x = (z * scale + shift).to(dtype)
        return x.contiguous(memory_format=torch.channels_last)

    # bf16 draws are uniform: after the norm |y| < 1.8, where 2e-2 is more
    # than one bf16 ulp. Normal draws at 29M elements put thousands of values
    # above 4, where a one-ulp flip from summation order alone is 0.031.
    cases = [
        ("serving bf16", (8, 64, 180, 320), torch.bfloat16, "uniform", BF16_TOL),
        ("serving fp32", (8, 64, 180, 320), torch.float32, "normal", FP32_TOL),
        ("ragged bf16", (1, 64, 37, 53), torch.bfloat16, "uniform", BF16_TOL),
        ("ragged fp32", (1, 64, 37, 53), torch.float32, "normal", FP32_TOL),
    ]
    row = None
    for name, shape, dtype, dist, tol in cases:
        x = activation(shape, dtype, dist)
        got = instance_norm_prelu(x, alpha)
        want = instance_norm_prelu_reference(x, alpha)
        torch.cuda.synchronize()
        check(got.dtype == dtype and got.shape == x.shape, f"{name}: bad output")
        check(got.is_contiguous(memory_format=torch.channels_last), f"{name}: layout")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        ms = plain_ms = None
        if shape[0] == 8:
            # plain, kernel, kernel, plain
            p1 = cuda_ms(lambda: instance_norm_prelu_reference(x, alpha), 20)
            k1 = cuda_ms(lambda: instance_norm_prelu(x, alpha), 20)
            k2 = cuda_ms(lambda: instance_norm_prelu(x, alpha), 20)
            p2 = cuda_ms(lambda: instance_norm_prelu_reference(x, alpha), 20)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        print(
            f"[3 kernel] {name} {list(shape)}: max_abs_err {err:.3e} (tol {tol:g})"
            + (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms" if ms else ""),
            flush=True,
        )
        check(err <= tol, f"{name}: max_abs_err {err} > {tol}")
        if name == "serving bf16":
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    # The clamp case: a near-constant input makes the one-pass variance
    # cancel in fp32 (it can come out negative); the output must stay finite.
    # The statistic is ill-conditioned here, so the two versions' outputs
    # are compared for finiteness only, as the JAX package's test does.
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.full((2, 64, 37, 53), 40.0, device=dev)
        x = (x + 1e-4 * torch.randn(x.shape, device=dev, generator=gen)).to(dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        got = instance_norm_prelu(x, alpha)
        want = instance_norm_prelu_reference(x, alpha)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())
        print(f"[3 kernel] near-constant {dtype}: finite {finite}", flush=True)
        check(finite, f"near-constant {dtype}: non-finite output")
    return row


def phase_serving(params, frames) -> tuple:
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.kernels.instance_norm import instance_norm_prelu
    from fast_srgan_torch.serving import MicroBatcher

    engine = SRInferenceEngine(params, device="cuda", dtype=torch.bfloat16)
    replies = [None] * len(frames)
    errors = []

    def client(k: int) -> None:
        try:
            for i in range(k, len(frames), 4):
                replies[i] = batcher.submit(frames[i], timeout=600)
        except Exception as e:  # reported by the main thread
            errors.append(repr(e))

    batcher = MicroBatcher(engine, max_batch=8, max_wait_ms=20)
    instance_norm_prelu.launches = 0
    engine.forward_calls = 0
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    seconds = time.perf_counter() - t0
    launches = instance_norm_prelu.launches
    forwards = engine.forward_calls
    batcher.close()
    check(not any(t.is_alive() for t in threads), "a client thread hung")
    check(not errors, f"requests failed: {errors}")
    for frame, out in zip(frames, replies):
        h, w = frame.shape[:2]
        check(
            out is not None and out.dtype == np.uint8
            and out.shape == (4 * h, 4 * w, 3),
            f"bad reply for a {h}x{w} request",
        )
    n_layers = engine.model.n_layers
    print(
        f"[4 serving] {len(frames)} requests in {batcher.stats['batches']} batches"
        f" ({seconds:.2f} s incl. first-call setup); {forwards} generator forwards;"
        f" instance_norm_prelu launches {launches} (want {n_layers} x {forwards})",
        flush=True,
    )
    check(forwards > 0 and launches == n_layers * forwards, "launch count mismatch")
    return engine, replies, launches


def phase_fidelity(params, frames, replies) -> None:
    from fast_srgan_torch.inference import SRInferenceEngine

    rng = np.random.default_rng(1)
    small = make_frame(rng, 64, 96)
    card32 = SRInferenceEngine(params, device="cuda", dtype=torch.float32)
    cpu32 = SRInferenceEngine(params, device="cpu", dtype=torch.float32)
    a = card32.upscale_images([small])[0].astype(np.int16)
    b = cpu32.upscale_images([small])[0].astype(np.int16)
    diff = int(np.abs(a - b).max())
    equal = float(np.mean(a == b))
    print(
        f"[5 fidelity] card fp32 vs CPU fp32 at 64x96: max {diff} count(s),"
        f" {100 * equal:.3f}% equal",
        flush=True,
    )
    check(diff <= 1, f"card fp32 vs CPU fp32 differ by {diff} counts")

    big = [i for i, f in enumerate(frames) if f.shape[:2] == (180, 320)]
    ref = card32.upscale_images([frames[i] for i in big])
    values = [psnr(replies[i], r) for i, r in zip(big, ref)]
    print(
        f"[5 fidelity] card bf16 vs card fp32 at 180x320: PSNR min"
        f" {min(values):.2f} dB, mean {np.mean(values):.2f} dB",
        flush=True,
    )
    check(min(values) >= PSNR_MIN_DB, f"bf16 PSNR {min(values):.2f} < {PSNR_MIN_DB}")


def phase_throughput(engine, frames, card: str) -> None:
    base = [f for f in frames if f.shape[:2] == (180, 320)]
    staged = torch.from_numpy(np.stack([base[i % len(base)] for i in range(200)]))
    staged = staged.to("cuda")
    bs = engine.effective_batch_size(180, 320, 8)
    n = (200 // bs) * bs
    batches = [staged[i:i + bs] for i in range(0, n, bs)]
    for x in batches[:2]:
        engine.forward_u8(x)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for x in batches:
        out = engine.forward_u8(x)
    end.record()
    torch.cuda.synchronize()
    check(out.shape == (bs, 720, 1280, 3), "throughput output shape")
    ms = start.elapsed_time(end)
    print(
        f"[6 throughput] 180x320 -> 720p bf16, batch {bs}: {n} frames in"
        f" {ms:.1f} ms = {1000 * n / ms:.1f} frames/s ({card}; indicative)",
        flush=True,
    )


def main() -> None:
    kind, card = phase_device()
    phase_build()
    row = phase_kernel()

    from fast_srgan_torch.checkpoints.npz_io import load_npz_params

    params = load_npz_params(CHECKPOINT)
    rng = np.random.default_rng(0)
    frames = [make_frame(rng, 180, 320) for _ in range(8)]
    frames += [make_frame(rng, 90, 160) for _ in range(4)]
    order = rng.permutation(len(frames))
    frames = [frames[i] for i in order]

    engine, replies, launches = phase_serving(params, frames)
    phase_fidelity(params, frames, replies)
    phase_throughput(engine, frames, card)

    check("jax" not in sys.modules, "jax was imported")
    check(
        not any(m.startswith("fast_srgan_tpu") for m in sys.modules),
        "the JAX package was imported",
    )
    print(json.dumps({"kernels": [{
        "name": "instance_norm_prelu",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        **row,
    }]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
