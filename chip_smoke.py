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
     the card (an indicative number, not a benchmark);
  7. kernel: the fused conv + bias + PixelShuffle + PReLU upsample against
     its plain version, bf16 and fp32, at the two training stages, the
     serving stage 1 and a ragged shape; timed at the large shapes; its
     gradients through the autograd Function against the plain ones;
  8. kernel: the phase-major pixel shuffle, bitwise against its plain
     version, timed; and the unfused upsample stage as the generator runs
     it (phase-major conv + the shuffle kernel + PReLU) against conv +
     F.pixel_shuffle + PReLU in torch channel order, forward and
     forward+backward, at the training stages and serving stage 1;
  9. training: the reference configuration (64/8 4x generator, 64-filter
     discriminator, VGG19 with fixed-seed weights, batch 24 of 96x96 crops,
     bf16 autocast): 20 pretrain steps (the loss must fall) and 10 GAN steps
     (finite metrics), once with the fused upsample and once unfused (conv +
     the shuffle kernel); exact launch counts; ms per step and peak memory;
     and one fp32 pretrain step from the same state with the kernels on the
     card against the plain path on the CPU, losses within 1e-5.

Phases 7 and 8 run right after phase 3, phase 9 last.

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
UPSAMPLE_SOURCE = "fast_srgan_torch/csrc/fused_upsample.cu"
UPSAMPLE_REPLACES = "fast_srgan_tpu/kernels/fused_upsample.py:255"
SHUFFLE_SOURCE = "fast_srgan_torch/csrc/pixel_shuffle.cu"
SHUFFLE_REPLACES = "fast_srgan_tpu/kernels/pixel_shuffle.py:64"

FP32_TOL = 2e-5
BF16_TOL = 2e-2
PSNR_MIN_DB = 40.0
# Fused upsample: fp32 with TF32 off; bf16 with |y| < 4, where 3e-2 is 1.5
# bf16 ulps (the plain version rounds after the conv and after the bias).
UPSAMPLE_FP32_TOL = 5e-5
UPSAMPLE_BF16_TOL = 3e-2
GRAD_RTOL = 1e-5
PARITY_RTOL = 1e-5
PRETRAIN_STEPS, GAN_STEPS = 20, 10


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
    """Mean device milliseconds per call of fn(), by CUDA events around
    replays of a CUDA graph of one call: the host's dispatch (the wrappers'
    Python, ctypes) is left out, so a small kernel is not timed as the host
    that launches it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _timed_pair(kernel, plain, iters: int = 20) -> tuple:
    """(kernel ms, plain ms), measured plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


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
            ms, plain_ms = _timed_pair(
                lambda: instance_norm_prelu(x, alpha),
                lambda: instance_norm_prelu_reference(x, alpha),
            )
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


def _no_tf32():
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def phase_upsample_kernel() -> dict:
    from fast_srgan_torch.kernels.fused_upsample import (
        fused_upsample,
        fused_upsample_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)

    def args(shape, dtype):
        # x uniform in [-1, 1], weights of std 0.04: |y| < 4 at every shape
        x = (torch.rand(shape, device=dev, generator=gen) * 2 - 1).to(dtype)
        w = torch.randn((256, 64, 3, 3), device=dev, generator=gen) * 0.04
        b = (torch.rand(256, device=dev, generator=gen) - 0.5) * 0.2
        a = torch.tensor([0.173], device=dev)
        return x.contiguous(memory_format=torch.channels_last), w, b, a

    row = None
    for label, shape, timed in [
        ("train stage 1", (24, 64, 24, 24), False),
        ("train stage 2", (24, 64, 48, 48), True),
        ("serving stage 1", (8, 64, 180, 320), True),
        ("ragged", (1, 64, 37, 53), False),
    ]:
        for dtype, tol in ((torch.bfloat16, UPSAMPLE_BF16_TOL),
                           (torch.float32, UPSAMPLE_FP32_TOL)):
            a = args(shape, dtype)
            with _no_tf32():
                got = fused_upsample(*a)
                want = fused_upsample_reference(*a)
                torch.cuda.synchronize()
                b, _, h, w = shape
                check(got.dtype == dtype and got.shape == (b, 64, 2 * h, 2 * w),
                      f"upsample {label}: bad output")
                check(got.is_contiguous(memory_format=torch.channels_last),
                      f"upsample {label}: layout")
                check(bool(torch.isfinite(got).all()), f"upsample {label}: non-finite")
                err = (got.float() - want.float()).abs().max().item()
                ms = plain_ms = None
                if timed:
                    ms, plain_ms = _timed_pair(
                        lambda: fused_upsample(*a), lambda: fused_upsample_reference(*a)
                    )
            name = "bf16" if dtype == torch.bfloat16 else "fp32"
            print(
                f"[7 kernel] fused upsample {label} {name} {list(shape)}: max_abs_err"
                f" {err:.3e} (tol {tol:g})"
                + (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms" if ms else ""),
                flush=True,
            )
            check(err <= tol, f"upsample {label} {name}: max_abs_err {err} > {tol}")
            if label == "train stage 2" and dtype == torch.bfloat16:
                row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    # gradients through the Function against the plain composition's (fp32)
    base = args((2, 64, 24, 24), torch.float32)
    g = torch.randn((2, 64, 48, 48), device=dev, generator=gen)
    grads = []
    for op in (fused_upsample, fused_upsample_reference):
        leaves = [t.detach().clone().requires_grad_(True) for t in base]
        with _no_tf32():
            op(*leaves).backward(g.contiguous(memory_format=torch.channels_last))
        grads.append([t.grad for t in leaves])
    rel = max(
        ((k - p).abs().max() / p.abs().max()).item() for k, p in zip(*grads)
    )
    print(f"[7 kernel] fused upsample gradients vs plain: max rel {rel:.3e}"
          f" (rtol {GRAD_RTOL:g})", flush=True)
    check(rel <= GRAD_RTOL, f"upsample gradients differ: {rel}")
    return row


def phase_shuffle_kernel() -> dict:
    from fast_srgan_torch.kernels.pixel_shuffle import (
        pixel_shuffle_phase_major,
        pixel_shuffle_phase_major_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    row = None
    for shape in ((24, 256, 48, 48), (1, 64, 37, 53)):
        x = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        got = pixel_shuffle_phase_major(x)
        want = pixel_shuffle_phase_major_reference(x)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        ms = plain_ms = None
        if shape[0] == 24:
            ms, plain_ms = _timed_pair(
                lambda: pixel_shuffle_phase_major(x),
                lambda: pixel_shuffle_phase_major_reference(x),
            )
            row = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
                   "ms": ms, "plain_ms": plain_ms}
        print(
            f"[8 kernel] pixel shuffle bf16 {list(shape)}: bitwise equal {equal}"
            + (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms" if ms else ""),
            flush=True,
        )
        check(equal, f"pixel shuffle {list(shape)} differs from its plain version")
    _unfused_stage_forms()
    return row


def _unfused_stage_forms() -> None:
    """The unfused upsample stage as the generator runs it against conv +
    F.pixel_shuffle + PReLU in torch channel order, on one block's weights:
    forward and forward+backward at the training stages (fp32 parameters,
    bf16 autocast) and forward at serving stage 1 (bf16 parameters)."""
    import torch.nn.functional as F

    from fast_srgan_torch.models.generator import UpSamplingBlock, prelu

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    torch.manual_seed(5)
    for label, shape, train in [
        ("train stage 1", (24, 64, 24, 24), True),
        ("train stage 2", (24, 64, 48, 48), True),
        ("serving stage 1", (8, 64, 180, 320), False),
    ]:
        block = UpSamplingBlock(64).to(dev, memory_format=torch.channels_last)
        if not train:
            block = block.to(torch.bfloat16)
        x = (torch.rand(shape, device=dev, generator=gen) * 2 - 1).to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last).requires_grad_(train)
        leaves = [x, *block.parameters()]

        def torch_order(x):
            return prelu(F.pixel_shuffle(block.conv(x), 2), block.relu.weight)

        def run(form, backward):
            with torch.autocast("cuda", torch.bfloat16, enabled=train, cache_enabled=False):
                y = form(x)
            if not backward:
                return y
            g = torch.ones_like(y)
            return torch.autograd.grad(y, leaves, g)

        with torch.no_grad():
            err = (run(block, False).float() - run(torch_order, False).float()).abs().max()
        check(err.item() <= UPSAMPLE_BF16_TOL, f"unfused {label}: forms differ by {err}")
        line = f"[8 stage] unfused upsample {label} {list(shape)} bf16:"
        for backward in (False, True) if train else (False,):
            ms, plain_ms = _timed_pair(lambda: run(block, backward),
                                       lambda: run(torch_order, backward))
            line += (f" {'fwd+bwd' if backward else 'fwd'} {ms:.4f} ms vs"
                     f" {plain_ms:.4f} ms;")
        print(f"{line} (phase-major conv + shuffle kernel vs conv + F.pixel_shuffle;"
              f" max_abs_err {err.item():.3e})", flush=True)


def _train_config(fused: bool, bf16: bool = True):
    from fast_srgan_torch.config import default_config

    # kernels.use_pallas=true is the reference config's value; the port
    # takes each kernel or its plain version by the tensor's device
    return default_config(
        kernels={"use_pallas": True, "fused_upsample": fused},
        training={"vgg_weights": "init", "bf16": bf16},
    )


def _run_training_arm(fused: bool, batch: torch.Tensor, card: str) -> list:
    """20 pretrain + 10 GAN steps; returns the launches of the three kernels."""
    from fast_srgan_torch.kernels.fused_upsample import fused_upsample
    from fast_srgan_torch.kernels.instance_norm import instance_norm_prelu
    from fast_srgan_torch.kernels.pixel_shuffle import pixel_shuffle_phase_major
    from fast_srgan_torch.train.steps import build_bundle

    bundle = build_bundle(_train_config(fused), "cuda", torch.Generator().manual_seed(0))
    counters = (instance_norm_prelu, fused_upsample, pixel_shuffle_phase_major)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in counters:
        f.launches = 0
    losses, step_s = [], {"pretrain": [], "gan": []}
    for _ in range(PRETRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(bundle.pretrain_step(batch))
        torch.cuda.synchronize()
        step_s["pretrain"].append(time.perf_counter() - t0)
    metrics = []
    for _ in range(GAN_STEPS):
        t0 = time.perf_counter()
        metrics.append(bundle.gan_step(batch))
        torch.cuda.synchronize()
        step_s["gan"].append(time.perf_counter() - t0)
    launches = [f.launches for f in counters]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in losses]
    steps = PRETRAIN_STEPS + GAN_STEPS
    want = [8 * steps, 2 * steps, 0] if fused else [8 * steps, 0, 2 * steps]
    # after warm-up: the last half of each step kind
    ms = {k: 1000 * float(np.mean(v[len(v) // 2:])) for k, v in step_s.items()}
    arm = "fused" if fused else "unfused"
    print(
        f"[9 training] {arm} upsample: pretrain loss {losses[0]:.5f} -> {losses[-1]:.5f};"
        f" {ms['pretrain']:.2f} ms/pretrain step, {ms['gan']:.2f} ms/GAN step"
        f" (mean of the last half); peak {peak_gib:.2f} GiB; launches IN+PReLU"
        f" {launches[0]}, fused upsample {launches[1]}, pixel shuffle {launches[2]}"
        f" (want {want}); {card}",
        flush=True,
    )
    last = {k: float(v) for k, v in metrics[-1].items()}
    print(f"[9 training] {arm} last GAN metrics: {json.dumps(last)}", flush=True)
    check(losses[-1] < losses[0], f"{arm}: pretrain loss did not fall: {losses}")
    check(
        all(np.isfinite(float(v)) for m in metrics for v in m.values()),
        f"{arm}: non-finite GAN metrics",
    )
    check(launches == want, f"{arm}: launches {launches} != {want}")
    return launches


def phase_training(card: str) -> tuple:
    from fast_srgan_torch.train.steps import build_bundle

    rng = np.random.default_rng(4)
    crops = np.stack([make_frame(rng, 96, 96) for _ in range(24)])
    batch = torch.from_numpy(crops).to("cuda")
    fused = _run_training_arm(True, batch, card)
    unfused = _run_training_arm(False, batch, card)

    # fp32, TF32 off: one pretrain step from the same state (the same seed
    # draws the same weights), with the kernels (IN+PReLU, fused upsample)
    # on the card against the plain path, which the wrappers take on the CPU
    from fast_srgan_torch.kernels.fused_upsample import fused_upsample
    from fast_srgan_torch.kernels.instance_norm import instance_norm_prelu

    values = []
    with _no_tf32():
        for device in ("cuda", "cpu"):
            bundle = build_bundle(
                _train_config(True, bf16=False), device, torch.Generator().manual_seed(0)
            )
            instance_norm_prelu.launches = fused_upsample.launches = 0
            values.append(float(bundle.pretrain_step(batch.to(device))))
            got = [instance_norm_prelu.launches, fused_upsample.launches]
            want = [8, 2] if device == "cuda" else [0, 0]
            check(got == want, f"fp32 parity launches on {device}: {got} != {want}")
    rel = abs(values[0] - values[1]) / abs(values[1])
    print(
        f"[9 training] fp32 pretrain loss, kernels on the card {values[0]:.8f} vs"
        f" plain on the CPU {values[1]:.8f}: rel {rel:.3e} (tol {PARITY_RTOL:g})",
        flush=True,
    )
    check(rel <= PARITY_RTOL, f"fp32 kernels vs plain loss: rel {rel}")
    return fused, unfused


def main() -> None:
    kind, card = phase_device()
    phase_build()
    row = phase_kernel()
    up_row = phase_upsample_kernel()
    shuffle_row = phase_shuffle_kernel()

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
    fused, unfused = phase_training(card)

    check("jax" not in sys.modules, "jax was imported")
    check(
        not any(m.startswith("fast_srgan_tpu") for m in sys.modules),
        "the JAX package was imported",
    )
    # launches: IN+PReLU from the serving path (phase 4), the fused upsample
    # from the fused training arm, the shuffle from the unfused arm (phase 9)
    print(json.dumps({"kernels": [
        {"name": "instance_norm_prelu", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": KERNEL_REPLACES, "launches": launches, **row},
        {"name": "fused_upsample", "route": "cuda", "source": UPSAMPLE_SOURCE,
         "replaces": UPSAMPLE_REPLACES, "launches": fused[1], **up_row},
        {"name": "pixel_shuffle_phase_major", "route": "cuda",
         "source": SHUFFLE_SOURCE, "replaces": SHUFFLE_REPLACES,
         "launches": unfused[2], **shuffle_row},
    ]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
