#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: build, check, serve, time.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card, nvcc (PATH,
$CUDA_HOME or /usr/local/cuda) and no network. Phases, each printing its
own line; any failure exits non-zero and prints no result:

  1. device: the card's name and nvidia-smi's name and power limit;
  2. build: the CUDA kernels from fast_srgan_torch/csrc with nvcc;
  3. kernel: the instance-norm family's two epilogues (IN + PReLU, IN +
     residual add) against their plain PyTorch versions on the card, at the
     serving path's shape (bf16: the resident form; fp32: two launches), a
     ragged one and a 540x960 frame (two launches), and on near-constant
     inputs in both forms; timed at the serving shape and the 540x960 frame
     beside F.instance_norm as a yardstick;
  4. serving: the pretrained 4x generator (models/generator_pretrained.npz,
     bf16) answers 12 requests from 4 threads through the micro-batcher;
     the launch counts must be n_layers (IN+PReLU) and n_layers + 1
     (IN+add) x the generator forwards;
  5. fidelity: the card's fp32 engine against the CPU fp32 engine, and the
     card's bf16 replies against its fp32 ones (PSNR);
  6. throughput: 180x320 -> 720p bf16 frames/s over 200 frames staged on
     the card (an indicative number, not a benchmark);
  7. kernel: the fused conv + bias + PixelShuffle + PReLU upsample (its
     ptxas line first) against its plain version, and its pre-activation
     form (the backward's z) against conv + bias + shuffle, bf16 and fp32,
     at the two training stages, the serving stage 1, a ragged shape and
     C = 16; timed in bf16 and fp32 at the three large shapes, with TFLOP/s
     and share of bound, beside a bf16 cuDNN conv + bias alone at the same
     shape as the yardstick; its gradients through the autograd Function
     against the plain ones, in fp32 and in bf16 under autocast;
  8. kernel: the phase-major pixel shuffle, bitwise against its plain
     version, timed; and the upsample stage as the generator runs it:
     unfused (phase-major conv + the shuffle kernel + PReLU) against conv +
     F.pixel_shuffle + PReLU in torch channel order, and the fused block,
     forward and forward+backward, at the training stages and serving
     stage 1;
  9. training: the reference configuration (64/8 4x generator, 64-filter
     discriminator, VGG19 with fixed-seed weights, batch 24 of 96x96 crops,
     bf16 autocast): 20 pretrain steps (the loss must fall) and 10 GAN steps
     (finite metrics), once with the fused upsample and once unfused (conv +
     the shuffle kernel); exact launch counts (the fused upsample's
     backward launches among them); ms per step and peak memory;
     and one fp32 pretrain step from the same state with the kernels on the
     card against the plain path on the CPU, losses within 1e-5;
 10. int8: the activation-quantize and s8 x s8 -> s32 conv kernels, bitwise
     against their plain versions in bf16 and fp32 glue: stage 1 with and
     without the next conv's quantize in its epilogue, the four stage-2
     phases in one launch, a single phase, ragged shapes and the narrow
     widths (Cin 16, Cout 12 and 48); the fused stage 1 and the four-phase
     launch timed beside the bf16 cuDNN convs the float tier runs, with
     TOP/s and share of bound; the int8 engine (pretrained 4x, ups mode,
     bf16 glue, calibrated on the frames) answers the frames with exact
     launch counts (two s8 launches, one quantize and 8 + 9 IN a forward);
     every mode in both glue dtypes on the PSNR bar's own input (2x48x64,
     tests/test_quant.py), at least its bar against the card's fp32, and
     against the CPU port on the same scales (the bounded-flip contract for
     ups in fp32 glue); int8 against bf16 frames/s at batch 8, 16 and 32
     (indicative);
 11. bucketed and streaming serving: the masked forms of both IN epilogues
     (a zero-padded batch, statistics over each sample's valid region)
     against their plain versions in bf16 and fp32, in the resident form
     (8 x 192x320 with valid sizes 180x320, 192x320, 150x300, 33x47) and
     the two launches (544x960 holding 540x960), padding exactly 0 (PReLU)
     or equal to skip (add), timed beside the unmasked kernel at the same
     padded shape; the pretrained 4x engine with bucket=32 answers 12
     mixed-size requests from 4 threads through the micro-batcher (exact
     masked launch counts, no unmasked IN), fp32 bucketed within 1 count
     of fp32 unbucketed, bf16 bucketed >= 40 dB against it, the canonical
     tail bucketed (the shuffle kernel) within 1 count; masked int8 `ups`
     on the unbucketed engine's scales (the bounded-flip contract in fp32
     glue, >= 33 dB in bf16 glue, two s8 launches and one quantize a
     forward); `stream` over 200 host frames of 180x320, bf16 and int8,
     bitwise equal to `upscale_batch`, its host-to-host frames/s beside
     phase 6's staged number, and bucketed against unbucketed frames/s at
     180x320 (padded to 192x320) (indicative).

 12. trainer: ``python -m fast_srgan_torch.train`` in-process on the card
     (its ``main``) at the reference widths (64/8 4x G, 64-filter D, VGG19
     with fixed-seed weights, bf16, the fused upsample, batch 24 of 96x96
     crops) on 16 PNGs of 256x256 written from a seed: 20 pretrain + 10 GAN
     steps, checkpoints every 10, logs every 5, the .pt export. Checks: the
     native crop loader ran; metrics.jsonl holds the reference's tags,
     finite PSNR and SSIM in [-1, 1]; the pretrain loss falls; the four
     exports load strictly into the port's modules and torch AdamW; exact
     launch counts with validation and panel forwards. A second launch with
     training.iterations=15 resumes at step 10 and runs 5 GAN steps (rows
     and launches). Then every training option on through build_bundle (5 +
     5 steps, exact launches with remat's recomputed blocks), and fp32
     parity (TF32 off) of one pretrain and one GAN step with grad_clip,
     ema_decay, cosine, grad_accum=2 and remat, kernels on the card against
     the plain versions on the CPU: losses and EMA within 1e-5. Prints ms a
     step through the trainer beside phase 9's bare steps, and ms a
     validation pass (indicative).
 13. export and the checkpoint tools: ``python -m
     fast_srgan_torch.scripts.export_model`` (in-process, with its check)
     exports the pretrained 4x generator as torch.export artifacts: bf16 LR
     tail at 8x180x320 and 1x540x960 (the IN family's two-launch form), fp32
     at 1x180x320, int8 ups in bf16 glue at 8x180x320 calibrated on the
     smoke's frames, bf16 canonical tail at 1x90x160; and one fused
     UpSamplingBlock at training stage 2. Each loaded artifact: its bytes,
     export and load seconds; fast_srgan.* op nodes in its graph; the exact
     launches a call (8 IN+PReLU and 9 IN+add; int8 adds 2 s8 and 1
     quantize; the canonical tail 2 shuffles; the fused stage 1); within 1
     uint8 count of the live engine in fp32, 2 in bf16 and int8 (the
     script's check), the fused stage bitwise against the eager block. The
     bf16 and int8 artifacts' frames/s at batch 8 beside phase 6's and
     phase 10's engines, in turns (indicative). The host µs an IN+PReLU and
     a quantize call take through the op, through the autograd.Function
     around it, and without the op (indicative). Then the tools on the card:
     ``evaluate --fp32`` on 4 of phase 12's PNGs against the same CLI on
     the CPU (aggregate PSNR within 0.01 dB, SSIM within 1e-4), and in bf16;
     ``convert_checkpoint`` npz -> pt -> npz bitwise; ``interp_checkpoints``
     of the pretrained .npz and its .pt at alpha 0.5 bitwise equal to it;
     ``infer --checkpoint`` phase 12's ``generator_epoch_15.pt`` on 2 images,
     equal to an engine built from the same file.

 14. width-sharded serving (``fast_srgan_torch/parallel``), on 4 shards of
     the one card (a repeated device: the halo and statistics exchange of
     several cards, for correctness; the times are the cost of the halos
     and split norms on one card, not a scaling number): the split form of
     the IN family (statistics, then normalize with every shard's partials)
     against its plain versions at [1,64,540,240] a shard in bf16 and fp32
     (2e-2 / 3e-2 / 2e-5), the statistics bitwise equal on every shard,
     timed; the s8 conv's halo form bitwise against its plain version
     (stage 1 with and without the quantize, a trunk conv, the four
     phases) at a [1,Cin,540,242] shard, timed; the pretrained 4x
     generator on a 4K frame (540x960 -> 2160x3840): bf16 >= 40 dB against
     the one-device fp32 engine with exact split-form launch counts (the
     main path), fp32 (TF32 off) within 1 count of it, int8 ups in fp32
     glue in the bounded-flip contract against the one-device int8 engine
     (halo-form launch counts), bf16 glue >= 33 dB; ms a 4K frame sharded
     against one device (indicative); a 2-D ("data", "sp") 2x2 mesh at
     batch 2, the canonical tail, 2x and 8x generators at depth 2, each
     within 1 count of its one-device fp32 forward; the data-parallel
     engine on [cuda:0, cuda:0] at batch 8 (fp32, bf16, int8): bitwise
     equal to one device on the same slices, within 1 count at batch 8;
     ``infer --tile 1`` (fp32, and ``--int8``) on two PNGs against the
     engine.

Phases 7 and 8 run right after phase 3, phase 10 after phase 6, phase 11
after phase 10, phase 14 after phase 11, phase 9 and then 12 and 13 last.

The line before the last is a JSON object describing each kernel (its
bound: the larger of its bytes over 3.35 TB/s and its operations over the
peak rate of their type); the last line is {"ok": true, "device": {...}}.
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
# the JAX package's `instance_norm_nhwc(y) + x` (models/generator.py:115),
# which XLA lowered on the TPU
ADD_REPLACES = "fast_srgan_tpu/ops/norm.py:32"
# the JAX package's `instance_norm_masked_nhwc` (the bucketed forward's 17
# norms), which XLA lowered on the TPU
MASKED_REPLACES = "fast_srgan_tpu/ops/norm.py:43"
UPSAMPLE_SOURCE = "fast_srgan_torch/csrc/fused_upsample.cu"
UPSAMPLE_REPLACES = "fast_srgan_tpu/kernels/fused_upsample.py:255"
SHUFFLE_SOURCE = "fast_srgan_torch/csrc/pixel_shuffle.cu"
SHUFFLE_REPLACES = "fast_srgan_tpu/kernels/pixel_shuffle.py:64"
INT8_CONV_SOURCE = "fast_srgan_torch/csrc/int8_conv.cu"
INT8_CONV_REPLACES = "fast_srgan_tpu/quant.py:216"
QUANTIZE_SOURCE = "fast_srgan_torch/csrc/quantize.cu"
QUANTIZE_REPLACES = "fast_srgan_tpu/quant.py:184"

FP32_TOL = 2e-5
BF16_TOL = 2e-2
# IN + residual add in bf16 with |skip| <= 1: one ulp of the normalized value
# in [1, 2) plus one of the sum in [2, 4) (the plain version rounds twice)
ADD_BF16_TOL = 3e-2
PSNR_MIN_DB = 40.0
# Fused upsample: fp32 with TF32 off; bf16 with |y| < 4, where 3e-2 is 1.5
# bf16 ulps (the plain version rounds after the conv and after the bias).
UPSAMPLE_FP32_TOL = 5e-5
UPSAMPLE_BF16_TOL = 3e-2
GRAD_RTOL = 1e-5
PARITY_RTOL = 1e-5
PRETRAIN_STEPS, GAN_STEPS = 20, 10
# phase 12's trainer run: pretrain and GAN steps
TRAINER_STEPS = (20, 10)
# int8 against fp32, uint8 PSNR on tests/test_quant.py's input (the
# synthetic batch 2x48x64, seed 3): ups is its bar, full its full-int8 bar;
# tail (fewer int8 layers than full, no trunk ones) takes ups's, trunk
# full's. The smoke's own frames are held to the lowest of them.
INT8_PSNR_MIN_DB = {"ups": 37.0, "tail": 37.0, "full": 33.0, "trunk": 33.0}
SWEEP_BATCHES = (8, 16, 32)
# H100 SXM peaks (NVIDIA's data sheet, dense): the bound of a kernel is the
# larger of its bytes over HBM_BPS and its operations over the peak rate.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
FP32_FLOPS = 67e12  # outside the tensor cores


def bound(nbytes: float, ops: float, peak: float) -> dict:
    """bound_ms and bound_by of a kernel that moves nbytes and does ops."""
    by_bytes, by_ops = 1e3 * nbytes / HBM_BPS, 1e3 * ops / peak
    if by_bytes >= by_ops:
        return {"bound_ms": by_bytes, "bound_by": "bytes"}
    return {"bound_ms": by_ops, "bound_by": "operations"}


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


def events_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of fn(), by CUDA events around
    back-to-back calls (no graph): for library calls that are long beside
    their launch."""
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


def _timed_pair(kernel, plain, iters: int = 20, plain_iters: int = 0) -> tuple:
    """(kernel ms, plain ms), measured plain, kernel, kernel, plain."""
    plain_iters = plain_iters or iters
    p1 = cuda_ms(plain, plain_iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, plain_iters)
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


def _ptxas_lines(name: str) -> list:
    """ptxas -v's lines for the kernels whose mangled name holds ``name``."""
    from fast_srgan_torch.kernels import _build

    lines, kernel = [], None
    for line in (_build.build_log or "").splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if name in line else None
        elif kernel and ("registers" in line or "spill" in line or "C75" in line
                         or "warning" in line):
            lines.append(f"{kernel}: {line.strip()}")
    return lines


def phase_build() -> None:
    from fast_srgan_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    print(f"[2 build] nvcc {' '.join(_build.NVCC_FLAGS)}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    # ptxas -v, one line a kernel: its name, registers and spills
    for line in _ptxas_lines(""):
        print(f"[2 build] ptxas {line}", flush=True)


def phase_kernel() -> dict:
    """Both epilogues of the instance-norm family, in both its forms, against
    their plain versions. Returns each epilogue's row of the kernels line."""
    import torch.nn.functional as F

    from fast_srgan_torch.kernels.instance_norm import (
        EPS,
        instance_norm_add,
        instance_norm_add_reference,
        instance_norm_prelu,
        instance_norm_prelu_reference,
        plan,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    alpha = torch.tensor([0.173], device=dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

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

    # (kernel, plain version, F.instance_norm yardstick, bf16 bar, bytes and
    # fp32 operations an element: sums, normalize, then the PReLU, or the
    # rounding and the add with skip's read)
    forms = {
        "instance_norm_prelu": (
            lambda x, s: instance_norm_prelu(x, alpha),
            lambda x, s: instance_norm_prelu_reference(x, alpha),
            lambda x, s: F.prelu(F.instance_norm(x, eps=EPS), alpha.to(x.dtype)),
            BF16_TOL, 2, 6,
        ),
        "instance_norm_add": (
            instance_norm_add, instance_norm_add_reference,
            lambda x, s: F.instance_norm(x, eps=EPS) + s,
            ADD_BF16_TOL, 3, 7,
        ),
    }
    # bf16 draws are uniform: after the norm |y| < 1.8, where 2e-2 is more
    # than one bf16 ulp, and with |skip| <= 1 the sum stays below 4. Normal
    # draws at 29M elements put thousands of values above 4, where a one-ulp
    # flip from summation order alone is 0.031. The serving shape takes the
    # resident form in bf16 and the two launches in fp32; the 540x960 frame
    # takes the two launches.
    cases = [
        ("serving bf16", (8, 64, 180, 320), torch.bfloat16, "uniform", True),
        ("serving fp32", (8, 64, 180, 320), torch.float32, "normal", True),
        ("ragged bf16", (1, 64, 37, 53), torch.bfloat16, "uniform", False),
        ("ragged fp32", (1, 64, 37, 53), torch.float32, "normal", False),
        ("540x960 bf16", (1, 64, 540, 960), torch.bfloat16, "uniform", True),
    ]
    rows = {name: {} for name in forms}
    taken = set()
    for case, shape, dtype, dist, timed in cases:
        found = plan(shape, torch.finfo(dtype).bits // 8, n_sms)
        form = "two launches" if found is None else "resident %s" % (found,)
        taken.add(found is None)
        x = activation(shape, dtype, dist)
        if dist == "uniform":
            skip = (torch.rand(shape, device=dev, generator=gen) * 2 - 1).to(dtype)
        else:
            skip = torch.randn(shape, device=dev, generator=gen).to(dtype)
        skip = skip.contiguous(memory_format=torch.channels_last)
        for name, (kernel, plain, yardstick, bf16_tol, per_elem, ops) in forms.items():
            tol = bf16_tol if dtype == torch.bfloat16 else FP32_TOL
            got = kernel(x, skip)
            want = plain(x, skip)
            torch.cuda.synchronize()
            label = f"{name} {case}"
            check(got.dtype == dtype and got.shape == x.shape, f"{label}: bad output")
            check(got.is_contiguous(memory_format=torch.channels_last), f"{label}: layout")
            check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            line = (f"[3 kernel] {label} {list(shape)} ({form}): max_abs_err {err:.3e}"
                    f" (tol {tol:g})")
            if timed:
                ms, plain_ms = _timed_pair(lambda: kernel(x, skip), lambda: plain(x, skip))
                yard_ms = cuda_ms(lambda: yardstick(x, skip), 20)
                bnd = bound(per_elem * x.numel() * x.element_size(), ops * x.numel(),
                            FP32_FLOPS)
                line += (f"; kernel {ms:.4f} ms, {100 * bnd['bound_ms'] / ms:.1f}% of its"
                         f" {bnd['bound_ms']:.4f} ms bound ({bnd['bound_by']}); plain"
                         f" {plain_ms:.4f} ms; F.instance_norm yardstick {yard_ms:.4f} ms")
                if case == "serving bf16":
                    # no one PyTorch call is this function: library_ms is
                    # null, F.instance_norm (two-pass variance) a yardstick
                    rows[name].update({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                       "library_ms": None, **bnd,
                                       "f_instance_norm_ms": yard_ms})
                elif case == "540x960 bf16":
                    rows[name].update({"two_launch_ms": ms, "two_launch_plain_ms": plain_ms,
                                       "two_launch_bound_ms": bnd["bound_ms"],
                                       "two_launch_f_instance_norm_ms": yard_ms})
            print(line, flush=True)
            check(err <= tol, f"{label}: max_abs_err {err} > {tol}")
    check(taken == {False, True}, "phase 3 did not run both forms")

    # The clamp case: a near-constant input makes the one-pass variance
    # cancel in fp32 (it can come out negative); the output must stay finite.
    # The statistic is ill-conditioned here, so the two versions' outputs
    # are compared for finiteness only, as the JAX package's test does.
    for shape in ((2, 64, 37, 53), (1, 64, 540, 960)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.full(shape, 40.0, device=dev)
            x = (x + 1e-4 * torch.randn(x.shape, device=dev, generator=gen)).to(dtype)
            x = x.contiguous(memory_format=torch.channels_last)
            skip = torch.ones_like(x)
            finite = True
            for kernel, plain, *_ in forms.values():
                got = kernel(x, skip)
                want = plain(x, skip)
                torch.cuda.synchronize()
                finite &= bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())
            print(f"[3 kernel] near-constant {list(shape)} {dtype}, both epilogues:"
                  f" finite {finite}", flush=True)
            check(finite, f"near-constant {list(shape)} {dtype}: non-finite output")
    return rows


def phase_serving(params, frames) -> tuple:
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.kernels.instance_norm import instance_norm_add, instance_norm_prelu
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
    instance_norm_prelu.launches = instance_norm_add.launches = 0
    engine.forward_calls = 0
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    seconds = time.perf_counter() - t0
    launches = [instance_norm_prelu.launches, instance_norm_add.launches]
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
    # n_layers norms feed a PReLU; the stem's other n_layers and the
    # bottleneck's are followed by a residual add
    want = [n_layers * forwards, (n_layers + 1) * forwards]
    print(
        f"[4 serving] {len(frames)} requests in {batcher.stats['batches']} batches"
        f" ({seconds:.2f} s incl. first-call setup); {forwards} generator forwards;"
        f" launches instance_norm_prelu {launches[0]}, instance_norm_add {launches[1]}"
        f" (want {want})",
        flush=True,
    )
    check(forwards > 0 and launches == want, "launch count mismatch")
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


def _stage_frames(frames) -> torch.Tensor:
    """200 uint8 180x320 frames on the card, cycling the 180x320 ones."""
    base = [f for f in frames if f.shape[:2] == (180, 320)]
    staged = torch.from_numpy(np.stack([base[i % len(base)] for i in range(200)]))
    return staged.to("cuda")


def _frames_per_s(forward, staged: torch.Tensor, bs: int) -> tuple:
    """(frames, ms) of forward(batch) over the staged frames in batches of
    bs, after two warm-up batches, CUDA events around the timed loop."""
    n = (len(staged) // bs) * bs
    batches = [staged[i:i + bs] for i in range(0, n, bs)]
    for x in batches[:2]:
        forward(x)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for x in batches:
        out = forward(x)
    end.record()
    torch.cuda.synchronize()
    check(out.shape == (bs, 720, 1280, 3), "throughput output shape")
    return n, start.elapsed_time(end)


def phase_throughput(engine, frames, card: str) -> float:
    bs = engine.effective_batch_size(180, 320, 8)
    n, ms = _frames_per_s(engine.forward_u8, _stage_frames(frames), bs)
    print(
        f"[6 throughput] 180x320 -> 720p bf16, batch {bs}: {n} frames in"
        f" {ms:.1f} ms = {1000 * n / ms:.1f} frames/s ({card}; indicative)",
        flush=True,
    )
    return 1000 * n / ms


def _no_tf32():
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def _int8_conv_args(gen, b, cin, h, w, k, dtype, cout=256):
    """Random int8 activations and weights, a per-channel weight scale, an
    activation scale, a bias and a slope, as stage 1 and the phases run."""
    from fast_srgan_torch.kernels.int8_conv import pack_int8_weight

    dev = torch.device("cuda")
    q = torch.randint(-127, 128, (k, k, cin, cout), device=dev, generator=gen)
    xq = torch.randint(-127, 128, (b, h, w, cin), device=dev, generator=gen)
    weight = pack_int8_weight(q.to(torch.int8).cpu(), dev)
    wscale = torch.rand(cout, device=dev, generator=gen) * 1e-2 + 1e-3
    bias = (torch.rand(cout, device=dev, generator=gen) - 0.5).to(dtype)
    alpha = torch.tensor([0.173], device=dev).to(dtype)
    scale = torch.tensor(2.3, device=dev)
    return xq.to(torch.int8).permute(0, 3, 1, 2), weight, wscale, scale, bias, alpha


def _int8_phases_args(gen, b, cin, h, w, dtype):
    """The four 2x2 phase kernels of a random 3x3 stage-2 kernel, prepared as
    the executor prepares them, and an int8 input with 4x its channels."""
    from fast_srgan_torch.kernels.int8_conv import pack_int8_phases, pack_int8_weight
    from fast_srgan_torch.ops.lr_tail import _phase_kernels_2x

    dev = torch.device("cuda")
    k = torch.randint(-127, 128, (3, 3, cin // 4, 256), device=dev, generator=gen)
    phases = pack_int8_phases([
        (pq, pack_int8_weight(kp, dev))
        for pq, kp in _phase_kernels_2x(k.to(torch.int8).cpu()).items()
    ])
    xq = torch.randint(-127, 128, (b, h, w, cin), device=dev, generator=gen)
    wscale = torch.rand(256, device=dev, generator=gen) * 1e-2 + 1e-3
    bias = (torch.rand(256, device=dev, generator=gen) - 0.5).to(dtype)
    alpha = torch.tensor([0.173], device=dev).to(dtype)
    return (xq.to(torch.int8).permute(0, 3, 1, 2), phases, wscale,
            torch.tensor(2.3, device=dev), bias, alpha, dtype)


def _rate(label, ms, ops, bnd) -> str:
    return (f"{label} {ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s,"
            f" {100 * bnd['bound_ms'] / ms:.1f}% of its {bnd['bound_ms']:.4f} ms bound)")


def phase_int8_kernels(card: str) -> tuple:
    import torch.nn.functional as F

    from fast_srgan_torch.kernels.int8_conv import (
        int8_conv,
        int8_conv_phases,
        int8_conv_phases_reference,
        int8_conv_reference,
    )
    from fast_srgan_torch.kernels.quantize import quantize_act, quantize_act_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    quant_row = conv_row = None
    for label, shape in (("stage-2 input", (8, 256, 180, 320)), ("ragged", (3, 3, 37, 53))):
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, device=dev, generator=gen) * 2).to(dtype)
            x = x.contiguous(memory_format=torch.channels_last)
            s = torch.tensor(3.7, device=dev)
            got = quantize_act(x, s)
            want = quantize_act_reference(x, s)
            torch.cuda.synchronize()
            equal = torch.equal(got, want) and got.stride() == x.stride()
            ms = plain_ms = None
            if shape[0] == 8 and dtype == torch.bfloat16:
                ms, plain_ms = _timed_pair(lambda: quantize_act(x, s),
                                           lambda: quantize_act_reference(x, s))
                # yardstick, not the same function: torch.quantize_per_tensor
                # takes fp32 only, computes round(x / (s / 127)) where the
                # kernel computes round(x * (127 / s)), and clamps to
                # [-128, 127] where the kernel clamps to [-127, 127]
                x32 = x.float()
                yard_ms = events_ms(
                    lambda: torch.quantize_per_tensor(x32, 3.7 / 127, 0, torch.qint8), 20)
                del x32
                quant_row = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
                             "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                             "quantize_per_tensor_fp32_ms": yard_ms,
                             **bound(x.numel() * (x.element_size() + 1), 0, INT8_OPS)}
            print(
                f"[10 kernel] quantize {label} {dtype} {list(shape)}: bitwise equal {equal}"
                + (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; yardstick"
                   f" torch.quantize_per_tensor on the fp32 copy {yard_ms:.4f} ms" if ms else ""),
                flush=True,
            )
            check(equal, f"quantize {label} {dtype} differs from its plain version")

    # single convs: (label, B, Cin, H, W, k, padding, Cout, fused quantize)
    s_next = torch.tensor(5.1, device=dev)
    cases = [("stage 1", 8, 64, 180, 320, 3, (1, 1), 256, False),
             ("stage 1 + quantize", 8, 64, 180, 320, 3, (1, 1), 256, True),
             ("ragged stage 1", 3, 64, 37, 53, 3, (1, 1), 256, False),
             ("ragged stage 1 + quantize", 3, 64, 37, 53, 3, (1, 1), 256, True),
             ("ragged phase (1,1) alone", 3, 256, 37, 53, 2, (0, 0), 256, False),
             ("neck Cin 16", 2, 16, 37, 53, 3, (1, 1), 64, True),
             ("trunk", 2, 64, 37, 53, 3, (1, 1), 64, True),
             ("2x head Cout 12", 2, 256, 37, 53, 3, (1, 1), 12, False),
             ("4x head Cout 48", 2, 1024, 37, 53, 3, (1, 1), 48, False)]
    times = {}
    for label, b, cin, h, w, k, pad, cout, fused in cases:
        for dtype in (torch.bfloat16, torch.float32):
            xq, weight, ws, s, bias, alpha = _int8_conv_args(gen, b, cin, h, w, k, dtype, cout)
            args = (xq, weight, ws, s, pad, bias, alpha, dtype, s_next if fused else None)
            got = int8_conv(*args)
            want = int8_conv_reference(*args)
            torch.cuda.synchronize()
            equal = torch.equal(got, want)
            check(got.is_contiguous(memory_format=torch.channels_last), f"{label}: layout")
            print(f"[10 kernel] int8 conv {label} {dtype} [{b},{cin},{h},{w}] -> {cout},"
                  f" {k}x{k} pad {pad}: bitwise equal {equal}", flush=True)
            check(equal, f"int8 conv {label} {dtype} differs from its plain version")
            if b == 8 and dtype == torch.bfloat16:
                ops = 2 * b * h * w * cin * k * k * cout
                nbytes = xq.numel() + weight.packed.numel() + got.numel() * got.element_size()
                times[label] = (*_timed_pair(lambda: int8_conv(*args),
                                             lambda: int8_conv_reference(*args), 20, 3),
                                ops, bound(nbytes, ops, INT8_OPS))

    # the four phases in one launch
    for label, b, cin, h, w in (("phases", 8, 256, 180, 320), ("ragged phases", 3, 256, 37, 53)):
        for dtype in (torch.bfloat16, torch.float32):
            args = _int8_phases_args(gen, b, cin, h, w, dtype)
            got = int8_conv_phases(*args)
            want = int8_conv_phases_reference(*args)
            torch.cuda.synchronize()
            equal = all(torch.equal(a, c) for a, c in zip(got, want))
            check(all(a.is_contiguous(memory_format=torch.channels_last) for a in got),
                  f"{label}: layout")
            print(f"[10 kernel] int8 conv, four phases in one launch, {dtype} [{b},{cin},{h},{w}]"
                  f" -> 4 x 256, 2x2: bitwise equal {equal}", flush=True)
            check(equal, f"int8 {label} {dtype} differs from its plain version")
            if b == 8 and dtype == torch.bfloat16:
                ops = 4 * 2 * b * h * w * cin * 4 * 256
                nbytes = (args[0].numel() + args[1].tiled.numel()
                          + sum(a.numel() * a.element_size() for a in got))
                err = max((a.float() - c.float()).abs().max().item() for a, c in zip(got, want))
                times["phases"] = (*_timed_pair(lambda: int8_conv_phases(*args),
                                                lambda: int8_conv_phases_reference(*args), 20, 2),
                                   ops, bound(nbytes, ops, INT8_OPS))

    # the bf16 cuDNN convs (+ bias) the float tier runs at these shapes
    # (ops/lr_tail.py: 3x3 pad 1; 2x2 valid on the one-padded input), the
    # yardstick: they are not the same function, and the port never calls
    # them in the int8 tier
    bias = (torch.rand(256, device=dev, generator=gen) - 0.5).to(torch.bfloat16)
    x1 = torch.randn((8, 64, 180, 320), device=dev, generator=gen).to(torch.bfloat16)
    x1 = x1.contiguous(memory_format=torch.channels_last)
    w1 = (torch.randn((256, 64, 3, 3), device=dev, generator=gen) * 0.05).to(torch.bfloat16)
    w1 = w1.contiguous(memory_format=torch.channels_last)
    x2 = torch.randn((8, 256, 182, 322), device=dev, generator=gen).to(torch.bfloat16)
    x2 = x2.contiguous(memory_format=torch.channels_last)
    w2 = [(torch.randn((256, 256, 2, 2), device=dev, generator=gen) * 0.05)
          .to(torch.bfloat16).contiguous(memory_format=torch.channels_last) for _ in range(4)]
    cudnn = {
        "stage 1": cuda_ms(lambda: F.conv2d(x1, w1, bias, padding=1), 20),
        "phases": cuda_ms(lambda: [F.conv2d(x2, wp, bias) for wp in w2], 20),
    }
    for label, (ms, plain_ms, ops, bnd) in times.items():
        yard = cudnn.get("phases" if label == "phases" else "stage 1")
        print(f"[10 time] int8 conv {label} bf16, batch 8 of 180x320: "
              + _rate("kernel", ms, ops, bnd)
              + f"; plain (float64) {plain_ms:.4f} ms; bf16 cuDNN conv + bias {yard:.4f} ms"
              + f" ({card})", flush=True)
    ms, plain_ms, ops, bnd = times["phases"]
    check(ms < cudnn["phases"],
          f"four-phase launch {ms:.4f} ms not faster than four cuDNN convs {cudnn['phases']:.4f}")
    conv_row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": None,
                "cudnn_bf16_ms": cudnn["phases"],
                "stage1_quantize_ms": times["stage 1 + quantize"][0],
                "stage1_quantize_bound_ms": times["stage 1 + quantize"][3]["bound_ms"]}
    return conv_row, quant_row


def _u8_compare(a: np.ndarray, b: np.ndarray) -> tuple:
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 1).mean()), psnr(a, b)


def phase_int8_engine(params, frames) -> list:
    """The int8 engine on the card: the main path's launches and fidelity,
    then every mode on the fidelity bar's own input, against the card's fp32
    and against the CPU port. Returns the launches of (int8 conv, the four
    phases, quantize)."""
    from fast_srgan_torch import quant
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.kernels.instance_norm import instance_norm_add, instance_norm_prelu
    from fast_srgan_torch.kernels.int8_conv import int8_conv, int8_conv_phases
    from fast_srgan_torch.kernels.quantize import quantize_act

    calib = np.stack([f for f in frames if f.shape[:2] == (180, 320)])
    engine = SRInferenceEngine(params, device="cuda", dtype=torch.bfloat16,
                               quantize=True, calib_batches=[calib])
    counters = (int8_conv, int8_conv_phases, quantize_act, instance_norm_prelu,
                instance_norm_add)
    for f in counters:
        f.launches = 0
    engine.forward_calls = 0
    replies = engine.upscale_images(frames)
    launches = [f.launches for f in counters]
    forwards = engine.forward_calls
    # a 4x forward: stage 1 (quantizing stage 2's input in its epilogue) and
    # the four phases in one launch, so 2 s8 launches, and 1 quantize
    n_layers = engine.model.n_layers
    want = [forwards, forwards, forwards, n_layers * forwards, (n_layers + 1) * forwards]
    print(
        f"[10 int8] ups bf16 engine: {len(frames)} frames in {forwards} forwards; launches"
        f" s8 conv {launches[0] + launches[1]} (stage 1 {launches[0]}, four phases"
        f" {launches[1]}), quantize {launches[2]}, IN+PReLU {launches[3]}, IN+add"
        f" {launches[4]} (want {want})",
        flush=True,
    )
    check(forwards > 0 and launches == want, "int8 launch count mismatch")
    card32 = SRInferenceEngine(params, device="cuda", dtype=torch.float32)
    values = [psnr(a, b) for a, b in zip(replies, card32.upscale_images(frames))]
    floor = min(INT8_PSNR_MIN_DB.values())
    print(f"[10 int8] ups bf16 vs card fp32 on these frames, calibrated on them: PSNR min"
          f" {min(values):.2f} dB, mean {np.mean(values):.2f} dB (floor {floor})", flush=True)
    check(min(values) >= floor, f"int8 ups PSNR {min(values):.2f} on the smoke's frames")

    # the float bf16 engine, card against CPU: the scale of bf16's own spread
    rng = np.random.default_rng(7)
    small = np.stack([make_frame(rng, 64, 96) for _ in range(2)])
    a = SRInferenceEngine(params, device="cuda").upscale_batch(small)
    b = SRInferenceEngine(params, device="cpu").upscale_batch(small)
    mx, frac, db = _u8_compare(a, b)
    print(f"[10 int8] float bf16 engine, card vs CPU at 64x96: max {mx}, >1: {100 * frac:.2f}%,"
          f" PSNR {db:.2f} dB", flush=True)

    # every mode on the bar's own input (tests/test_quant.py
    # TestPretrainedBound: the synthetic batch 2x48x64, seed 3, calibrated on
    # itself), against the card's fp32 and the CPU port on the same scales
    x = ((quant.default_calibration_batch(h=48, w=64, n=2, seed=3) + 1) * 127.5)
    x = np.clip(x, 0, 255).astype(np.uint8)
    ref32 = card32.upscale_batch(x)
    for mode in ("ups", "tail", "full", "trunk"):
        for dtype in (torch.float32, torch.bfloat16):
            card_e = SRInferenceEngine(params, device="cuda", dtype=dtype, quantize=mode,
                                       calib_batches=[x])
            cpu_e = SRInferenceEngine(params, device="cpu", dtype=dtype, quantize=mode,
                                      act_scales={k: v.cpu() for k, v in card_e.act_scales.items()})
            a = card_e.upscale_batch(x)
            mx, frac, db = _u8_compare(a, cpu_e.upscale_batch(x))
            fid = psnr(a, ref32)
            name = "fp32" if dtype == torch.float32 else "bf16"
            print(f"[10 int8] {mode} {name} glue, 2x48x64: vs card fp32 {fid:.2f} dB (bar"
                  f" {INT8_PSNR_MIN_DB[mode]}); card vs CPU port max {mx}, >1:"
                  f" {100 * frac:.2f}%, PSNR {db:.2f} dB", flush=True)
            check(fid >= INT8_PSNR_MIN_DB[mode], f"int8 {mode} {name}: PSNR {fid:.2f}")
            if mode == "ups" and dtype == torch.float32:
                check(mx <= 3 and frac < 0.02, "int8 ups fp32: card vs CPU off the contract")
    return launches[:3]


def phase_int8_throughput(params, frames, card: str) -> None:
    from fast_srgan_torch.inference import SRInferenceEngine

    staged = _stage_frames(frames)
    calib = np.stack([f for f in frames if f.shape[:2] == (180, 320)])
    budget = max(SWEEP_BATCHES) * 180 * 320
    engines = {
        "bf16": SRInferenceEngine(params, device="cuda", pixel_budget=budget),
        "int8": SRInferenceEngine(params, device="cuda", pixel_budget=budget,
                                  quantize=True, calib_batches=[calib]),
    }
    for bs in SWEEP_BATCHES:
        fps = {"bf16": [], "int8": []}
        for name in ("bf16", "int8", "int8", "bf16"):
            torch.cuda.reset_peak_memory_stats()
            n, ms = _frames_per_s(engines[name].forward_u8, staged, bs)
            fps[name].append(1000 * n / ms)
        peak = torch.cuda.max_memory_allocated() / 2**30
        b, q = np.mean(fps["bf16"]), np.mean(fps["int8"])
        print(
            f"[10 throughput] 180x320 -> 720p, batch {bs}: bf16 {b:.1f} frames/s"
            f" ({fps['bf16'][0]:.1f}, {fps['bf16'][1]:.1f}); int8 ups {q:.1f}"
            f" ({fps['int8'][0]:.1f}, {fps['int8'][1]:.1f}); int8/bf16 {q / b:.3f};"
            f" peak {peak:.2f} GiB ({card}; indicative)",
            flush=True,
        )


def phase_upsample_kernel(card: str) -> dict:
    import torch.nn.functional as F

    from fast_srgan_torch.kernels.fused_upsample import (
        _launch,
        fused_upsample,
        fused_upsample_reference,
        launch_prepared,
        prepare,
        upsample_preact_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    for line in _ptxas_lines("fused_upsample"):
        print(f"[7 kernel] ptxas {line}", flush=True)

    def args(shape, dtype, c4=256):
        # x uniform in [-1, 1], weights of std 0.04: |y| < 4 at every shape
        x = (torch.rand(shape, device=dev, generator=gen) * 2 - 1).to(dtype)
        w = torch.randn((c4, 64, 3, 3), device=dev, generator=gen) * 0.04
        b = (torch.rand(c4, device=dev, generator=gen) - 0.5) * 0.2
        a = torch.tensor([0.173], device=dev)
        return x.contiguous(memory_format=torch.channels_last), w, b, a

    row = {}
    for label, shape, c4, timed in [
        ("train stage 1", (24, 64, 24, 24), 256, True),
        ("train stage 2", (24, 64, 48, 48), 256, True),
        ("serving stage 1", (8, 64, 180, 320), 256, True),
        ("ragged", (1, 64, 37, 53), 256, False),
        ("C=16", (3, 64, 37, 53), 64, False),
    ]:
        for dtype, tol in ((torch.bfloat16, UPSAMPLE_BF16_TOL),
                           (torch.float32, UPSAMPLE_FP32_TOL)):
            a = args(shape, dtype, c4)
            with _no_tf32():
                got = fused_upsample(*a)
                want = fused_upsample_reference(*a)
                z = _launch(*a, prelu=False)
                z_want = upsample_preact_reference(*a[:3])
                torch.cuda.synchronize()
                b, _, h, w = shape
                check(got.dtype == dtype and got.shape == (b, c4 // 4, 2 * h, 2 * w),
                      f"upsample {label}: bad output")
                check(got.is_contiguous(memory_format=torch.channels_last),
                      f"upsample {label}: layout")
                check(bool(torch.isfinite(got).all()), f"upsample {label}: non-finite")
                err = (got.float() - want.float()).abs().max().item()
                z_err = (z.float() - z_want.float()).abs().max().item()
                line = (f"[7 kernel] fused upsample {label} {'bf16' if dtype == torch.bfloat16 else 'fp32'}"
                        f" {list(shape)} -> 4C={c4}: max_abs_err {err:.3e}, pre-activation form"
                        f" {z_err:.3e} (tol {tol:g})")
                if timed:
                    # the kernel alone on prepared parameters, and the call
                    # (prepare's gather and casts + the kernel) as training
                    # makes it every step
                    params = prepare(*a[1:], dtype)
                    ms, plain_ms = _timed_pair(
                        lambda: launch_prepared(a[0], params), lambda: fused_upsample_reference(*a)
                    )
                    call_ms = cuda_ms(lambda: fused_upsample(*a), 20)
                    flops = 2 * b * h * w * 64 * 9 * c4
                    nbytes = sum(t.numel() * t.element_size() for t in (*a, got))
                    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
                    bnd = bound(nbytes, flops, peak)
                    line += (f"; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s,"
                             f" {100 * bnd['bound_ms'] / ms:.1f}% of its {bnd['bound_ms']:.4f} ms"
                             f" bound ({bnd['bound_by']})); the call with its parameter"
                             f" gather {call_ms:.4f} ms; plain {plain_ms:.4f} ms")
                    if dtype == torch.bfloat16:
                        # the yardstick: a bf16 cuDNN conv + bias alone at the
                        # same shape (not the same function: no shuffle, no PReLU)
                        wy = a[1].to(dtype).contiguous(memory_format=torch.channels_last)
                        by = a[2].to(dtype)
                        yard = cuda_ms(lambda: F.conv2d(a[0], wy, by, padding=1), 20)
                        line += f"; bf16 cuDNN conv + bias {yard:.4f} ms ({card})"
                        key = {"train stage 1": "stage1", "train stage 2": "",
                               "serving stage 1": "serving"}[label]
                        pre = key + "_" if key else ""
                        row.update({f"{pre}ms": ms, f"{pre}plain_ms": plain_ms,
                                    f"{pre}call_ms": call_ms, f"{pre}cudnn_bf16_ms": yard})
                        if key:
                            row[f"{pre}bound_ms"] = bnd["bound_ms"]
                        else:
                            row.update({"max_abs_err": err, "library_ms": None, **bnd})
            print(line, flush=True)
            check(err <= tol, f"upsample {label}: max_abs_err {err} > {tol}")
            check(z_err <= tol, f"upsample {label} pre-activation: max_abs_err {z_err} > {tol}")

    # Gradients through the Function against the plain composition's. fp32:
    # rtol 1e-5 of each one's max-abs. bf16 x with fp32 parameters under
    # autocast, as training runs it: the plain version rounds z twice, the
    # kernel once, so near z = 0 their signs differ and so do dz's there;
    # both are held to the fp32 gradients of the same inputs, the kernel's
    # error within 1.25x the plain version's plus one bf16 ulp (4e-3) of
    # each one's max-abs.
    def grads(op, base, g, autocast):
        leaves = [t.detach().clone().requires_grad_(True) for t in base]
        with _no_tf32(), torch.autocast("cuda", torch.bfloat16, enabled=autocast):
            y = op(*leaves)
        with _no_tf32():
            y.backward(g)
        return [t.grad.float() for t in leaves]

    def rel(got, want):
        return [((k - p).abs().max() / p.abs().max()).item() for k, p in zip(got, want)]

    base = args((2, 64, 24, 24), torch.float32)
    g = torch.randn((2, 64, 48, 48), device=dev, generator=gen)
    g = g.contiguous(memory_format=torch.channels_last)
    r = rel(grads(fused_upsample, base, g, False), grads(fused_upsample_reference, base, g, False))
    print(f"[7 kernel] fused upsample gradients vs plain, fp32: max rel (dx, dW, db, dalpha)"
          f" {', '.join(f'{v:.3e}' for v in r)} (rtol {GRAD_RTOL:g})", flush=True)
    check(max(r) <= GRAD_RTOL, f"upsample gradients fp32 differ: {r}")

    base = args((4, 64, 24, 24), torch.bfloat16)
    g = torch.randn((4, 64, 48, 48), device=dev, generator=gen).to(torch.bfloat16)
    g = g.contiguous(memory_format=torch.channels_last)
    truth = grads(fused_upsample_reference, [base[0].float(), *base[1:]], g.float(), False)
    kernel = grads(fused_upsample, base, g, True)
    plain = grads(fused_upsample_reference, base, g, True)
    rk, rp = rel(kernel, truth), rel(plain, truth)
    print(f"[7 kernel] fused upsample gradients, bf16 under autocast, against fp32 ones: max"
          f" rel (dx, dW, db, dalpha) kernel {', '.join(f'{v:.3e}' for v in rk)}; plain"
          f" {', '.join(f'{v:.3e}' for v in rp)}; kernel vs plain"
          f" {', '.join(f'{v:.3e}' for v in rel(kernel, plain))}", flush=True)
    check(all(k <= 1.25 * p + 4e-3 for k, p in zip(rk, rp)),
          f"upsample bf16 gradients: kernel {rk} against plain {rp}")
    return row


def phase_shuffle_kernel() -> tuple:
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
            b, c4, h, w = shape

            def library():  # the one strided copy (NCHW-contiguous output)
                return x.view(b, 2, 2, c4 // 4, h, w).permute(0, 3, 4, 1, 5, 2).reshape(
                    b, c4 // 4, 2 * h, 2 * w)

            check(torch.equal(library(), got), "the strided-copy shuffle differs from the kernel")
            ms, plain_ms = _timed_pair(
                lambda: pixel_shuffle_phase_major(x),
                lambda: pixel_shuffle_phase_major_reference(x),
            )
            library_ms = cuda_ms(library, 20)
            row = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   **bound(2 * x.numel() * x.element_size(), 0, BF16_FLOPS)}
        print(
            f"[8 kernel] pixel shuffle bf16 {list(shape)}: bitwise equal {equal}"
            + (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, the strided copy"
               f" x.view(B,2,2,C,H,W).permute(0,3,4,1,5,2).reshape(B,C,2H,2W)"
               f" {library_ms:.4f} ms" if ms else ""),
            flush=True,
        )
        check(equal, f"pixel shuffle {list(shape)} differs from its plain version")
    return row, _unfused_stage_forms()


def _unfused_stage_forms() -> dict:
    """The upsample stage as the generator runs it, on one block's weights:
    unfused (phase-major conv + the shuffle kernel + PReLU) against conv +
    F.pixel_shuffle + PReLU in torch channel order, and the fused block (the
    kernel, its wrapper's per-call weight gather included) beside it.
    Forward and forward+backward at the training stages (fp32 parameters,
    bf16 autocast), forward at serving stage 1 (bf16 parameters). Returns
    {label: {form: ms}}."""
    import torch.nn.functional as F

    from fast_srgan_torch.models.generator import UpSamplingBlock, prelu

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    torch.manual_seed(5)
    times = {}
    for label, shape, train in [
        ("train stage 1", (24, 64, 24, 24), True),
        ("train stage 2", (24, 64, 48, 48), True),
        ("serving stage 1", (8, 64, 180, 320), False),
    ]:
        block = UpSamplingBlock(64).to(dev, memory_format=torch.channels_last)
        fused = UpSamplingBlock(64, fused=True).to(dev, memory_format=torch.channels_last)
        fused.load_state_dict(block.state_dict())
        if not train:
            block, fused = block.to(torch.bfloat16), fused.to(torch.bfloat16)
        x = (torch.rand(shape, device=dev, generator=gen) * 2 - 1).to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last).requires_grad_(train)

        def torch_order(x):
            return prelu(F.pixel_shuffle(block.conv(x), 2), block.relu.weight)

        def run(form, backward, params):
            with torch.autocast("cuda", torch.bfloat16, enabled=train, cache_enabled=False):
                y = form(x)
            if not backward:
                return y
            g = torch.ones_like(y)
            return torch.autograd.grad(y, [x, *params], g)

        with torch.no_grad():
            ref = run(torch_order, False, ()).float()
            err = (run(block, False, ()).float() - ref).abs().max().item()
            err_fused = (run(fused, False, ()).float() - ref).abs().max().item()
        check(err <= UPSAMPLE_BF16_TOL, f"unfused {label}: forms differ by {err}")
        check(err_fused <= UPSAMPLE_BF16_TOL, f"fused block {label}: differs by {err_fused}")
        line = f"[8 stage] upsample stage {label} {list(shape)} bf16:"
        times[label] = {}
        for backward in (False, True) if train else (False,):
            kind = "fwd+bwd" if backward else "fwd"
            ms, plain_ms = _timed_pair(lambda: run(block, backward, list(block.parameters())),
                                       lambda: run(torch_order, backward,
                                                   list(block.parameters())))
            fused_ms = cuda_ms(lambda: run(fused, backward, list(fused.parameters())), 20)
            times[label].update({f"unfused {kind}": ms, f"fused {kind}": fused_ms})
            line += (f" {kind}: unfused {ms:.4f} ms vs torch order {plain_ms:.4f} ms,"
                     f" fused block {fused_ms:.4f} ms;")
        print(f"{line} (unfused: phase-major conv + shuffle kernel; max_abs_err unfused"
              f" {err:.3e}, fused {err_fused:.3e})", flush=True)
    return times


def _train_config(fused: bool, bf16: bool = True):
    from fast_srgan_torch.config import default_config

    # kernels.use_pallas=true is the reference config's value; the port
    # takes each kernel or its plain version by the tensor's device
    return default_config(
        kernels={"use_pallas": True, "fused_upsample": fused},
        training={"vgg_weights": "init", "bf16": bf16},
    )


def _run_training_arm(fused: bool, batch: torch.Tensor, card: str) -> tuple:
    """20 pretrain + 10 GAN steps; returns the launches of the four kernels
    and then the fused upsample's backward (pre-activation) launches, and
    the ms a step of each kind."""
    from fast_srgan_torch.kernels.fused_upsample import fused_upsample
    from fast_srgan_torch.kernels.instance_norm import instance_norm_add, instance_norm_prelu
    from fast_srgan_torch.kernels.pixel_shuffle import pixel_shuffle_phase_major
    from fast_srgan_torch.train.steps import build_bundle

    bundle = build_bundle(_train_config(fused), "cuda", torch.Generator().manual_seed(0))
    counters = (instance_norm_prelu, instance_norm_add, fused_upsample,
                pixel_shuffle_phase_major)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in counters:
        f.launches = 0
    fused_upsample.backward_launches = 0
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
    launches = [f.launches for f in counters] + [fused_upsample.backward_launches]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in losses]
    steps = PRETRAIN_STEPS + GAN_STEPS
    # one generator forward and one backward into it a step: 8 + 9 norms,
    # two upsample stages, each fused stage's pre-activation recomputed once
    want = [8 * steps, 9 * steps] + ([2 * steps, 0, 2 * steps] if fused else [0, 2 * steps, 0])
    # after warm-up: the last half of each step kind
    ms = {k: 1000 * float(np.mean(v[len(v) // 2:])) for k, v in step_s.items()}
    arm = "fused" if fused else "unfused"
    print(
        f"[9 training] {arm} upsample: pretrain loss {losses[0]:.5f} -> {losses[-1]:.5f};"
        f" {ms['pretrain']:.2f} ms/pretrain step, {ms['gan']:.2f} ms/GAN step"
        f" (mean of the last half); peak {peak_gib:.2f} GiB; launches IN+PReLU"
        f" {launches[0]}, IN+add {launches[1]}, fused upsample {launches[2]}, pixel"
        f" shuffle {launches[3]}, fused upsample backward {launches[4]} (want {want}); {card}",
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
    return launches, ms


def phase_training(card: str) -> tuple:
    from fast_srgan_torch.train.steps import build_bundle

    rng = np.random.default_rng(4)
    crops = np.stack([make_frame(rng, 96, 96) for _ in range(24)])
    batch = torch.from_numpy(crops).to("cuda")
    fused, fused_ms = _run_training_arm(True, batch, card)
    unfused, _ = _run_training_arm(False, batch, card)

    # fp32, TF32 off: one pretrain step from the same state (the same seed
    # draws the same weights), with the kernels (IN+PReLU, IN+add, fused
    # upsample) on the card against the plain path, which the wrappers take
    # on the CPU
    from fast_srgan_torch.kernels.fused_upsample import fused_upsample
    from fast_srgan_torch.kernels.instance_norm import instance_norm_add, instance_norm_prelu

    values = []
    with _no_tf32():
        for device in ("cuda", "cpu"):
            bundle = build_bundle(
                _train_config(True, bf16=False), device, torch.Generator().manual_seed(0)
            )
            counters = (instance_norm_prelu, instance_norm_add, fused_upsample)
            for f in counters:
                f.launches = 0
            fused_upsample.backward_launches = 0
            values.append(float(bundle.pretrain_step(batch.to(device))))
            got = [f.launches for f in counters] + [fused_upsample.backward_launches]
            want = [8, 9, 2, 2] if device == "cuda" else [0, 0, 0, 0]
            check(got == want, f"fp32 parity launches on {device}: {got} != {want}")
    rel = abs(values[0] - values[1]) / abs(values[1])
    print(
        f"[9 training] fp32 pretrain loss, kernels on the card {values[0]:.8f} vs"
        f" plain on the CPU {values[1]:.8f}: rel {rel:.3e} (tol {PARITY_RTOL:g})",
        flush=True,
    )
    check(rel <= PARITY_RTOL, f"fp32 kernels vs plain loss: rel {rel}")
    return fused, unfused, fused_ms


def _fused_counts(n_layers: int, forwards: int, backwards: int, recomputed: int = 0) -> dict:
    """Launches of the fused-upsample generator: n_layers IN+PReLU, n_layers
    + 1 IN+add and two upsample stages a forward; two pre-activation
    launches a backward; with remat, n_layers of each IN again for each
    forward whose blocks the backward recomputes. No other kernel."""
    counts = dict.fromkeys(_counters(), 0)
    counts.update({"in_prelu": n_layers * (forwards + recomputed),
                   "in_add": (n_layers + 1) * forwards + n_layers * recomputed,
                   "upsample": 2 * forwards, "upsample_backward": 2 * backwards})
    return counts


def _trainer_args(root: str, iterations: int) -> list:
    """The CLI's overrides for phase 12: the reference widths (64/8 4x G,
    64-filter D, batch 24 of 96x96 crops, bf16) from configs/config.yaml,
    VGG19 with fixed-seed weights, the fused upsample."""
    return ["--device", "cuda", f"hydra.run.dir={root}/run",
            f"data.image_dir={root}/images", f"data.numpy_dir={root}/npy",
            "experiment.name=smoke", "training.vgg_weights=init",
            "kernels.use_pallas=true", "kernels.fused_upsample=true",
            f"training.pretrain_iterations={TRAINER_STEPS[0]}",
            f"training.iterations={iterations}", "training.checkpoint_iter=10",
            "training.log_iter=5", "training.export_pt=true"]


def _metric_rows(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _ms_between_logs(rows: list, tag: str, spans) -> float:
    """ms a step between the log rows of ``tag`` at the ends of each span
    (first, last]: each row is written after its loss was read back, so an
    interval holds exactly its steps, loader and host included."""
    at = {r["step"]: r["time"] for r in rows if r["tag"] == tag}
    return float(np.mean([1000 * (at[b] - at[a]) / (b - a) for a, b in spans]))


def phase_trainer(card: str, bare_ms: dict) -> dict:
    """12: python -m fast_srgan_torch.train in-process on the card, then a
    resumed launch; the options arm and fp32 parity through build_bundle.
    Returns the trainer run's launches."""
    import shutil

    from fast_srgan_torch.models.discriminator import Discriminator
    from fast_srgan_torch.models.generator import Generator
    from fast_srgan_torch.train.__main__ import main as train_main
    from fast_srgan_torch.utils.images import save_image_u8

    root = os.path.join(REPO, ".chip_tmp", "trainer")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "images"))
    rng = np.random.default_rng(12)
    n_images = 16
    for i in range(n_images):
        save_image_u8(os.path.join(root, "images", f"{i:04d}.png"), make_frame(rng, 256, 256))
    cwd = os.getcwd()
    _zero_counts()
    try:
        t0 = time.perf_counter()
        trainer, sampler = train_main(_trainer_args(root, TRAINER_STEPS[1]))
        wall_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    counts = _read_counts()
    n_layers = trainer.config.generator.n_layers
    batch = trainer.config.training.batch_size
    steps = sum(TRAINER_STEPS)
    # validation: pretrain at steps 0, 10, 20 and GAN at 0, 10, each
    # ceil(16 / 24) batches; panels at pretrain 10, 20 and GAN 10
    val_forwards = 5 * -(-n_images // batch)
    want = _fused_counts(n_layers, steps + val_forwards + 3, steps)
    run_dir = os.path.join(root, "run", "runs", "smoke")
    rows = _metric_rows(os.path.join(run_dir, "metrics.jsonl"))
    tags = {r["tag"] for r in rows}
    need = {"Pretrain/Generator/Loss", "Pretrain/PSNR", "Pretrain/SSIM",
            "Loss/Discriminator/Real", "Loss/Discriminator/Fake",
            "Loss/Generator/Adversarial", "Loss/Generator/Content", "GAN/PSNR", "GAN/SSIM"}
    psnrs = [r["value"] for r in rows if r["tag"].endswith("/PSNR")]
    ssims = [r["value"] for r in rows if r["tag"].endswith("/SSIM")]
    losses = [r["value"] for r in rows if r["tag"] == "Pretrain/Generator/Loss"]
    # steps 6..10 of each phase: no validation, no checkpoint before them;
    # pretrain steps 16..20 follow the step-10 checkpoint, whose write runs
    # in the background beside them
    ms = {"pretrain": _ms_between_logs(rows, "Pretrain/Generator/Loss", [(5, 10)]),
          "gan": _ms_between_logs(rows, "Loss/Generator/Content", [(5, 10)])}
    after_ckpt_ms = _ms_between_logs(rows, "Pretrain/Generator/Loss", [(15, 20)])
    val_ms = 1000 * float(np.mean(trainer.validate_seconds[1:]))
    print(f"[12 trainer] python -m fast_srgan_torch.train, {TRAINER_STEPS[0]} pretrain +"
          f" {TRAINER_STEPS[1]} GAN steps of batch {batch} (64/8 4x G, 64-filter D, VGG init,"
          f" bf16, fused upsample) on {n_images} PNGs of 256x256: {wall_s:.1f} s; crop loader"
          f" {sampler.backend}; pretrain loss {losses[0]:.5f} -> {losses[-1]:.5f}; PSNR"
          f" {psnrs[0]:.2f} -> {psnrs[-1]:.2f} dB, SSIM {ssims[0]:.4f} -> {ssims[-1]:.4f};"
          f" launches {counts} (want {want})", flush=True)
    print(f"[12 trainer] ms a step through the trainer (loader, H2D, logging included),"
          f" steps 6..10: pretrain {ms['pretrain']:.2f}, GAN {ms['gan']:.2f} (pretrain"
          f" steps 16..20, beside the step-10 checkpoint's write: {after_ckpt_ms:.2f});"
          f" phase 9's bare steps"
          f" (fused arm): pretrain {bare_ms['pretrain']:.2f}, GAN {bare_ms['gan']:.2f};"
          f" trainer/bare {ms['pretrain'] / bare_ms['pretrain']:.3f},"
          f" {ms['gan'] / bare_ms['gan']:.3f}; a validation pass ({n_images} images)"
          f" {val_ms:.2f} ms ({card}; indicative)", flush=True)
    check(sampler.backend == "native", f"the crop loader ran {sampler.backend}, not native")
    check(need <= tags, f"metrics.jsonl lacks {sorted(need - tags)}")
    check(all(np.isfinite(psnrs)), f"PSNR not finite: {psnrs}")
    check(all(-1.0 <= v <= 1.0 for v in ssims), f"SSIM outside [-1, 1]: {ssims}")
    check(losses[-1] < losses[0], f"the pretrain loss did not fall: {losses}")
    check(counts == want, f"trainer launches {counts} != {want}")

    # the reference-format export loads strictly into the port's modules
    step = TRAINER_STEPS[1]
    cfg = trainer.config
    g = Generator(n_filters=cfg.generator.n_filters, n_layers=n_layers,
                  scale_factor=cfg.data.scale_factor)
    d = Discriminator(n_filters=cfg.discriminator.n_filters)
    for model, name in ((g, "generator"), (d, "discriminator")):
        path = os.path.join(run_dir, f"{name}_epoch_{step}.pt")
        model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True), strict=True)
        opt = torch.optim.AdamW(model.parameters(), lr=1.0)
        opt.load_state_dict(torch.load(os.path.join(run_dir, f"{name}_optim_epoch_{step}.pt"),
                                       map_location="cpu", weights_only=True))
        taken = int(opt.state_dict()["state"][0]["step"])
        check(taken == step + (TRAINER_STEPS[0] if name == "generator" else 0),
              f"{name} optimizer exported at {taken} updates")

    # a second launch with a larger budget resumes at step 10: 5 GAN steps
    _zero_counts()
    try:
        train_main(_trainer_args(root, 15))
    finally:
        os.chdir(cwd)
    resumed = _read_counts()
    new = _metric_rows(os.path.join(run_dir, "metrics.jsonl"))[len(rows):]
    logged = {(r["tag"], r["step"]) for r in new}
    # one validation at the resume point, 5 steps, the end-of-phase snapshot
    want_resumed = _fused_counts(n_layers, 5 + -(-n_images // batch), 5)
    print(f"[12 trainer] resumed with training.iterations=15: rows {sorted(logged)};"
          f" launches {resumed} (want {want_resumed})", flush=True)
    check(("GAN/PSNR", 10) in logged and ("Loss/Generator/Content", 15) in logged
          and not any(t.startswith("Pretrain/") for t, _ in logged),
          "the resumed launch did not run GAN steps 11..15 only")
    check(resumed == want_resumed, f"resumed launches {resumed} != {want_resumed}")
    check(os.path.exists(os.path.join(run_dir, "generator_epoch_15.pt")), "no step-15 export")
    _trainer_options_arm(card)
    _trainer_fp32_parity()
    # phase 13 reads the images and the step-15 export, then removes root
    return counts


#: every training option the port took from the JAX package, as one config
TRAINING_OPTIONS = {"ema_decay": 0.999, "grad_clip": 1.0, "lr_schedule": "cosine",
                    "grad_accum": 2, "augment": True, "remat": True, "remat_vgg": True,
                    "vgg_concat": True}


def _trainer_options_arm(card: str) -> None:
    """12b: every option on through build_bundle, 5 pretrain + 5 GAN steps
    (accumulation takes the recompute GAN form); exact launches, remat's
    recomputed block forwards included."""
    from fast_srgan_torch.config import default_config
    from fast_srgan_torch.train.steps import build_bundle

    config = default_config(kernels={"use_pallas": True, "fused_upsample": True},
                            training={"vgg_weights": "init", **TRAINING_OPTIONS})
    bundle = build_bundle(config, "cuda", torch.Generator().manual_seed(0))
    rng = np.random.default_rng(13)
    batch = torch.from_numpy(np.stack([make_frame(rng, 96, 96) for _ in range(24)])).cuda()
    _zero_counts()
    losses = [bundle.pretrain_step(batch) for _ in range(5)]
    metrics = [bundle.gan_step(batch) for _ in range(5)]
    counts = _read_counts()
    k, n = TRAINING_OPTIONS["grad_accum"], config.generator.n_layers
    # a micro-batch: pretrain fwd + bwd (blocks recomputed); GAN a detached
    # forward for D, then fwd + bwd (blocks recomputed) for G
    want = _fused_counts(n, 5 * k * 3, 5 * k * 2, recomputed=5 * k * 2)
    values = [float(v) for v in losses] + [float(v) for m in metrics for v in m.values()]
    print(f"[12 options] {json.dumps(TRAINING_OPTIONS)}: pretrain loss"
          f" {float(losses[0]):.5f} -> {float(losses[-1]):.5f}; last GAN metrics"
          f" {json.dumps({k: round(float(v), 5) for k, v in metrics[-1].items()})};"
          f" launches {counts} (want {want}); {card}", flush=True)
    check(all(np.isfinite(values)), "options arm: non-finite metrics")
    check(counts == want, f"options arm launches {counts} != {want}")


def _trainer_fp32_parity() -> None:
    """12c: fp32, TF32 off, one pretrain and one GAN step (explicit noise)
    with grad_clip, ema_decay, cosine, grad_accum=2 and remat, from the same
    state: the kernels on the card against the plain versions on the CPU.

    The discriminator's LR is 0 here. AdamW's first step moves each weight
    by about lr*sign(g), so where a gradient is near 0 the two devices step
    it apart by up to 2*lr; the G losses are taken against the updated D and
    would carry that (2.6e-5 rel at lr 1e-4 on an H100), which says nothing
    of the kernels. The EMA is held over the whole model (the largest
    difference over the largest |value|): zero-initialized biases carry only
    those steps, scaled by 1 - d."""
    from fast_srgan_torch.config import default_config
    from fast_srgan_torch.train.steps import build_bundle

    opts = {k: TRAINING_OPTIONS[k]
            for k in ("grad_clip", "ema_decay", "lr_schedule", "grad_accum", "remat")}
    config = default_config(kernels={"fused_upsample": True},
                            training={"vgg_weights": "init", "bf16": False,
                                      "discriminator_lr": 0.0, **opts})
    rng = np.random.default_rng(14)
    batch = torch.from_numpy(np.stack([make_frame(rng, 96, 96) for _ in range(24)]))
    out = {}
    with _no_tf32():
        for device in ("cuda", "cpu"):
            bundle = build_bundle(config, device, torch.Generator().manual_seed(0))
            with torch.no_grad():
                probe = torch.zeros((1, 3, 96, 96), device=device)
                shape = (24,) + tuple(bundle.discriminator(probe).shape[1:])
            gen = torch.Generator().manual_seed(15)
            noise = [torch.rand(shape, generator=gen) for _ in range(3)]
            x = batch.to(device)
            _zero_counts()
            loss = float(bundle.pretrain_step(x))
            metrics = {k: float(v) for k, v in bundle.gan_step(x, noise=noise).items()}
            ema = [p.detach().cpu() for p in bundle.g_ema.parameters()]
            out[device] = (loss, metrics, ema)
            # k micro-batches a step: pretrain fwd + bwd; GAN a detached
            # forward and fwd + bwd; each backward recomputes the blocks
            k = opts["grad_accum"]
            want = _fused_counts(config.generator.n_layers, 3 * k, 2 * k, recomputed=2 * k)
            if device == "cpu":
                want = dict.fromkeys(want, 0)
            got = _read_counts()
            check(got == want, f"fp32 parity launches on {device}: {got} != {want}")
    (l_c, m_c, e_c), (l_p, m_p, e_p) = out["cuda"], out["cpu"]
    rels = {"pretrain": abs(l_c - l_p) / abs(l_p)}
    rels.update({k: abs(m_c[k] - m_p[k]) / max(abs(m_p[k]), 1e-12) for k in m_p})
    ema_rel = (max(float((a - b).abs().max()) for a, b in zip(e_c, e_p))
               / max(float(b.abs().max()) for b in e_p))
    print(f"[12 parity] fp32 {json.dumps(opts)}: card kernels vs CPU plain, loss rel"
          f" {json.dumps({k: f'{v:.2e}' for k, v in rels.items()})}; EMA parameters max rel"
          f" {ema_rel:.2e} (tol {PARITY_RTOL:g})", flush=True)
    check(max(rels.values()) <= PARITY_RTOL, f"fp32 trainer parity: {rels}")
    check(ema_rel <= PARITY_RTOL, f"fp32 EMA parity: {ema_rel}")


def _valid_hw(sizes) -> tuple:
    dev = torch.device("cuda")
    return (torch.tensor([h for h, _ in sizes], dtype=torch.int32, device=dev),
            torch.tensor([w for _, w in sizes], dtype=torch.int32, device=dev))


def phase_masked_kernel(card: str) -> dict:
    """11a: the masked forms of both epilogues against their plain versions,
    timed beside the unmasked kernel at the same padded shape. Returns each
    masked form's row of the kernels line."""
    from fast_srgan_torch.kernels.instance_norm import (
        instance_norm_add,
        instance_norm_add_reference,
        instance_norm_prelu,
        instance_norm_prelu_reference,
        plan,
    )
    from fast_srgan_torch.ops.norm import valid_mask

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    alpha = torch.tensor([0.173], device=dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    forms = {
        "instance_norm_prelu_masked": (instance_norm_prelu, instance_norm_prelu_reference,
                                       BF16_TOL, 0),
        "instance_norm_add_masked": (instance_norm_add, instance_norm_add_reference,
                                     ADD_BF16_TOL, 1),
    }
    cases = [
        ("serving bucket", (8, 64, 192, 320),
         [(180, 320), (192, 320), (150, 300), (33, 47)] * 2),
        ("540x960 bucket", (1, 64, 544, 960), [(540, 960)]),
    ]
    rows = {name: {} for name in forms}
    for case, shape, sizes in cases:
        valid = _valid_hw(sizes)
        pad = (valid_mask(shape[2], shape[3], *valid)[0] == 0).expand(shape)
        n_valid = sum(h * w for h, w in sizes)
        for dtype in (torch.bfloat16, torch.float32):
            found = plan(shape, torch.finfo(dtype).bits // 8, n_sms)
            form = "two launches" if found is None else "resident %s" % (found,)
            # uniform per-channel draws, nonzero in the padding too (a conv's
            # bias smears into it): the kernel must leave them out
            scale = torch.rand((1, shape[1], 1, 1), device=dev, generator=gen) * 1.5 + 0.5
            shift = torch.rand((1, shape[1], 1, 1), device=dev, generator=gen) * 4 - 2
            x = ((torch.rand(shape, device=dev, generator=gen) * 2 - 1) * scale + shift)
            x = x.to(dtype).contiguous(memory_format=torch.channels_last)
            skip = (torch.rand(shape, device=dev, generator=gen) * 2 - 1).to(dtype)
            skip = skip.contiguous(memory_format=torch.channels_last)
            for name, (fn, plain, bf16_tol, extra_reads) in forms.items():
                other = skip if extra_reads else alpha
                tol = bf16_tol if dtype == torch.bfloat16 else FP32_TOL
                got = fn(x, other, valid)
                want = plain(x, other, valid)
                torch.cuda.synchronize()
                label = f"{name} {case} {'bf16' if dtype == torch.bfloat16 else 'fp32'}"
                check(got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last),
                      f"{label}: bad output")
                check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
                err = (got.float() - want.float()).abs().max().item()
                padding = (torch.equal(got[pad], other[pad]) if extra_reads
                           else bool(torch.all(got[pad] == 0)))
                line = (f"[11 kernel] {label} {list(shape)} ({form}): max_abs_err {err:.3e}"
                        f" (tol {tol:g}); padding {'= skip' if extra_reads else '= 0'}"
                        f" {padding}")
                if dtype == torch.bfloat16:
                    ms, plain_ms = _timed_pair(lambda: fn(x, other, valid),
                                               lambda: plain(x, other, valid))
                    unmasked_ms = cuda_ms(lambda: fn(x, other), 20)
                    # least bytes: x at the valid pixels, out everywhere (0 or
                    # skip at the padding), skip everywhere
                    size = x.element_size() * shape[1]
                    nbytes = (n_valid + (1 + extra_reads) * x.numel() // shape[1]) * size
                    bnd = bound(nbytes, 7 * n_valid * shape[1], FP32_FLOPS)
                    line += (f"; kernel {ms:.4f} ms, {100 * bnd['bound_ms'] / ms:.1f}% of its"
                             f" {bnd['bound_ms']:.4f} ms bound ({bnd['bound_by']}); unmasked"
                             f" kernel at the padded shape {unmasked_ms:.4f} ms; plain"
                             f" {plain_ms:.4f} ms ({card})")
                    if case == "serving bucket":
                        rows[name].update({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                           "library_ms": None, **bnd,
                                           "unmasked_ms": unmasked_ms})
                    else:
                        rows[name].update({"two_launch_ms": ms, "two_launch_plain_ms": plain_ms,
                                           "two_launch_bound_ms": bnd["bound_ms"],
                                           "two_launch_unmasked_ms": unmasked_ms})
                print(line, flush=True)
                check(err <= tol, f"{label}: max_abs_err {err} > {tol}")
                check(padding, f"{label}: the padding is not {'skip' if extra_reads else '0'}")
    return rows


BUCKET_SIZES = ((90, 160), (100, 170), (180, 320), (175, 310))


def _counters():
    from fast_srgan_torch.kernels.fused_upsample import fused_upsample
    from fast_srgan_torch.kernels.instance_norm import instance_norm_add, instance_norm_prelu
    from fast_srgan_torch.kernels.int8_conv import int8_conv, int8_conv_phases
    from fast_srgan_torch.kernels.pixel_shuffle import pixel_shuffle_phase_major
    from fast_srgan_torch.kernels.quantize import quantize_act

    from fast_srgan_torch.kernels.instance_norm import (
        instance_norm_add_from_stats,
        instance_norm_prelu_from_stats,
        instance_norm_stats,
    )

    return {"in_prelu": (instance_norm_prelu, "launches"),
            "in_add": (instance_norm_add, "launches"),
            "in_prelu_masked": (instance_norm_prelu, "masked_launches"),
            "in_add_masked": (instance_norm_add, "masked_launches"),
            "in_stats": (instance_norm_stats, "launches"),
            "in_prelu_split": (instance_norm_prelu_from_stats, "launches"),
            "in_add_split": (instance_norm_add_from_stats, "launches"),
            "s8_stage1": (int8_conv, "launches"), "s8_phases": (int8_conv_phases, "launches"),
            "s8_halo": (int8_conv, "halo_launches"),
            "s8_phases_halo": (int8_conv_phases, "halo_launches"),
            "quantize": (quantize_act, "launches"),
            "shuffle": (pixel_shuffle_phase_major, "launches"),
            "upsample": (fused_upsample, "launches"),
            "upsample_backward": (fused_upsample, "backward_launches")}


def _zero_counts() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def _read_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


def _bucketed_counts(forwards: int, n_layers: int, int8: bool = False, shuffle: int = 0) -> dict:
    """A bucketed 4x forward's launches: n_layers masked IN+PReLU, n_layers +
    1 masked IN+add, no unmasked IN; int8 ups adds stage 1 (with stage 2's
    quantize), the four-phase launch and one quantize."""
    counts = dict.fromkeys(_counters(), 0)
    counts.update({"in_prelu_masked": n_layers * forwards,
                   "in_add_masked": (n_layers + 1) * forwards,
                   "s8_stage1": forwards if int8 else 0, "s8_phases": forwards if int8 else 0,
                   "quantize": forwards if int8 else 0, "shuffle": shuffle * forwards})
    return counts


def phase_bucketed_engine(params) -> dict:
    """11b: the bucket=32 engine behind the micro-batcher (the server's
    default path), then its fidelity. Returns the main path's launches."""
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.serving import MicroBatcher

    rng = np.random.default_rng(11)
    requests = [make_frame(rng, h, w) for _ in range(3) for h, w in BUCKET_SIZES]
    engine = SRInferenceEngine(params, device="cuda", dtype=torch.bfloat16, bucket=32)
    engine.upscale_images(requests[:4])  # first use of each bucket shape
    replies = [None] * len(requests)
    errors = []

    def client(k: int) -> None:
        try:
            for i in range(k, len(requests), 4):
                replies[i] = batcher.submit(requests[i], timeout=600)
        except Exception as e:  # reported by the main thread
            errors.append(repr(e))

    batcher = MicroBatcher(engine, max_batch=8, max_wait_ms=20)
    _zero_counts()
    engine.forward_calls = 0
    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    main_counts, forwards = _read_counts(), engine.forward_calls
    batcher.close()
    check(not any(t.is_alive() for t in threads), "a client thread hung")
    check(not errors, f"requests failed: {errors}")
    for frame, out in zip(requests, replies):
        h, w = frame.shape[:2]
        check(out is not None and out.dtype == np.uint8 and out.shape == (4 * h, 4 * w, 3),
              f"bad bucketed reply for a {h}x{w} request")
    want = _bucketed_counts(forwards, engine.model.n_layers)
    print(f"[11 bucketed] bf16 bucket=32: {len(requests)} requests of {BUCKET_SIZES} in"
          f" {batcher.stats['batches']} batches, {forwards} forwards; launches {main_counts}"
          f" (want {want})", flush=True)
    check(forwards > 0 and main_counts == want, "bucketed launch count mismatch")

    exact32 = SRInferenceEngine(params, device="cuda", dtype=torch.float32)
    ref = exact32.upscale_images(requests)
    for label, kw in (("fp32 bucketed", {}), ("fp32 bucketed, canonical tail", {"lr_tail": False})):
        eng = SRInferenceEngine(params, device="cuda", dtype=torch.float32, bucket=32, **kw)
        _zero_counts()
        eng.forward_calls = 0
        outs = eng.upscale_images(requests)
        counts, forwards = _read_counts(), eng.forward_calls
        diffs = [np.abs(a.astype(np.int16) - b.astype(np.int16)) for a, b in zip(outs, ref)]
        mx = max(int(d.max()) for d in diffs)
        equal = float(np.mean(np.concatenate([(d == 0).ravel() for d in diffs])))
        # the canonical tail's two stages run the shuffle kernel
        want = _bucketed_counts(forwards, eng.model.n_layers, shuffle=2 if kw else 0)
        print(f"[11 bucketed] {label} vs fp32 unbucketed: max {mx} count(s), {100 * equal:.3f}%"
              f" equal; launches {counts} (want {want})", flush=True)
        # the canonical tail differs from the LR tail of the reference by
        # reassociation: it is held to the count only
        check(mx <= 1 and (bool(kw) or equal >= 0.999), f"{label}: {mx} counts, {equal} equal")
        check(counts == want, f"{label}: launch count mismatch")
    values = [psnr(a, b) for a, b in zip(replies, ref)]
    print(f"[11 bucketed] bf16 bucketed replies vs fp32 unbucketed: PSNR min {min(values):.2f}"
          f" dB, mean {np.mean(values):.2f} dB", flush=True)
    check(min(values) >= PSNR_MIN_DB, f"bucketed bf16 PSNR {min(values):.2f} < {PSNR_MIN_DB}")
    return main_counts


def phase_masked_int8(params, frames) -> None:
    """11c: int8 ups with bucket=32 on the unbucketed engine's scales.

    End to end the bucketed trunk runs at another shape than the unbucketed
    one, so its fp32 sums differ by reassociation and a value near a
    rounding boundary quantizes one step apart: rare pixels inside the
    valid region, not at its edge, move by a few counts, more than the
    contract's 3 on an H100 at these sizes (the card against the CPU on
    one program moves alike). So end to end the fp32-glue run is held to
    the contract's share
    (under 2% of values off by more than 1), and the masking itself is held
    exactly: the masked int8 tail on the zero-padded unbucketed trunk output
    against the unbucketed tail, within 1 count (the int8 convs are exact;
    only the float head reassociates)."""
    import torch.nn.functional as F

    from fast_srgan_torch import quant
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.ops.norm import valid_mask

    rng = np.random.default_rng(12)
    requests = [make_frame(rng, h, w) for h, w in BUCKET_SIZES for _ in range(2)]
    calib = np.stack([f for f in frames if f.shape[:2] == (180, 320)])
    exact = SRInferenceEngine(params, device="cuda", dtype=torch.float32, quantize=True,
                              calib_batches=[calib])
    ref = exact.upscale_images(requests)
    ref32 = SRInferenceEngine(params, device="cuda", dtype=torch.float32).upscale_images(requests)
    for dtype in (torch.float32, torch.bfloat16):
        eng = SRInferenceEngine(params, device="cuda", dtype=dtype, quantize=True, bucket=32,
                                act_scales=exact.act_scales)
        _zero_counts()
        eng.forward_calls = 0
        outs = eng.upscale_images(requests)
        counts, forwards = _read_counts(), eng.forward_calls
        want = _bucketed_counts(forwards, eng.model.n_layers, int8=True)
        name = "fp32" if dtype == torch.float32 else "bf16"
        line = f"[11 int8] ups {name} glue, bucket=32, {len(requests)} requests, {forwards} forwards:"
        if dtype == torch.float32:
            d = [np.abs(a.astype(np.int16) - b.astype(np.int16)) for a, b in zip(outs, ref)]
            mx = max(int(x.max()) for x in d)
            frac = float(np.mean(np.concatenate([(x > 1).ravel() for x in d])))
            print(f"{line} vs unbucketed int8 max {mx}, >1: {100 * frac:.3f}%; launches {counts}"
                  f" (want {want})", flush=True)
            check(frac < 0.02, "masked int8 ups fp32: over 2% of values off by more than 1")
            # the tail alone, on one trunk output: 180x320 zero-padded to 192x320
            batch = np.stack([r for r in requests if r.shape[:2] == (180, 320)])
            x = torch.from_numpy(batch).cuda().permute(0, 3, 1, 2).float() / 127.5 - 1.0
            vh = torch.full((len(batch),), 180, dtype=torch.int32, device="cuda")
            vw = torch.full((len(batch),), 320, dtype=torch.int32, device="cuda")
            ex = quant._Exec(eng.act_scales, None, dtype)
            with torch.inference_mode(), _no_tf32():
                y = eng._plan.trunk(x)
                yp = F.pad(y, (0, 0, 0, 12)).contiguous(memory_format=torch.channels_last)
                mask = valid_mask(192, 320, vh, vw)[0]
                tails = [quant._tail_4x(eng._plan.layers, ex, yp, mask=mask)[:, :, :720],
                         quant._tail_4x(eng._plan.layers, ex, y)]
            a, b = (((t + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy() for t in tails)
            tail_mx = int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
            print(f"[11 int8] masked int8 tail on the zero-padded trunk output vs the unbucketed"
                  f" tail, fp32 glue, {len(batch)} x 180x320 in 192x320: max {tail_mx} count(s)",
                  flush=True)
            check(tail_mx <= 1, f"masked int8 tail: {tail_mx} counts")
        else:
            values = [psnr(a, b) for a, b in zip(outs, ref32)]
            print(f"{line} vs card fp32 unbucketed PSNR min {min(values):.2f} dB, mean"
                  f" {np.mean(values):.2f} dB (floor {min(INT8_PSNR_MIN_DB.values())});"
                  f" launches {counts} (want {want})", flush=True)
            check(min(values) >= min(INT8_PSNR_MIN_DB.values()),
                  f"masked int8 bf16 PSNR {min(values):.2f}")
        check(forwards > 0 and counts == want, f"masked int8 {name}: launch count mismatch")


def _stream_fps(engine, host_frames, bs: int) -> float:
    """Frames/s host to host of engine.stream over host_frames, each output
    dropped as it arrives (as a video writer does: keeping 200 outputs
    page-faults 553 MB of new arrays, which times the host's allocator),
    after a warm-up stream of two batches."""
    for _ in engine.stream(host_frames[:2 * bs], batch_size=bs):
        pass
    torch.cuda.synchronize()
    n = 0
    t0 = time.perf_counter()
    for _ in engine.stream(iter(host_frames), batch_size=bs):
        n += 1
    seconds = time.perf_counter() - t0
    check(n == len(host_frames), f"stream yielded {n} of {len(host_frames)} frames")
    return n / seconds


def phase_stream(params, frames, staged_fps: float, card: str) -> None:
    """11d: stream over 200 host frames, bf16 and int8 ups, against
    upscale_batch; then bucketed against unbucketed forwards on the card."""
    from fast_srgan_torch.inference import SRInferenceEngine

    base = [f for f in frames if f.shape[:2] == (180, 320)]
    host = [base[i % len(base)] for i in range(200)]
    bs = 8
    engines = {
        "bf16": SRInferenceEngine(params, device="cuda"),
        "int8 ups": SRInferenceEngine(params, device="cuda", quantize=True,
                                      calib_batches=[np.stack(base)]),
    }
    for name, engine in engines.items():
        fps = _stream_fps(engine, host, bs)
        outs = engine.stream(iter(host), batch_size=bs)
        equal = all(np.array_equal(next(outs), frame)
                    for i in range(0, 200, bs)
                    for frame in engine.upscale_batch(np.stack(host[i:i + bs])))
        equal = equal and next(outs, None) is None
        print(f"[11 stream] {name} 180x320 -> 720p, batch {bs}, 200 host frames: {fps:.1f}"
              f" frames/s host to host (phase 6, bf16 staged on the card: {staged_fps:.1f});"
              f" bitwise equal to upscale_batch {equal} ({card}; indicative)", flush=True)
        check(equal, f"stream {name} differs from upscale_batch")

    # bucketed against unbucketed, frames staged on the card: 180x320 runs
    # padded to 192x320 through the masked forward
    engine = SRInferenceEngine(params, device="cuda", bucket=32)
    staged = _stage_frames(frames)
    padded = torch.zeros((200, 192, 320, 3), dtype=torch.uint8, device="cuda")
    padded[:, :180] = staged
    vh = torch.full((bs,), 180, dtype=torch.int32, device="cuda")
    vw = torch.full((bs,), 320, dtype=torch.int32, device="cuda")
    batches = [padded[i:i + bs] for i in range(0, 200, bs)]
    fps = {"unbucketed": [], "bucketed": []}
    for arm in ("unbucketed", "bucketed", "bucketed", "unbucketed"):
        if arm == "unbucketed":
            n, ms = _frames_per_s(engine.forward_u8, staged, bs)
        else:
            for x in batches[:2]:
                engine.forward_u8_masked(x, vh, vw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for x in batches:
                out = engine.forward_u8_masked(x, vh, vw)
            end.record()
            torch.cuda.synchronize()
            check(out.shape == (bs, 768, 1280, 3), "bucketed output shape")
            n, ms = 200, start.elapsed_time(end)
        fps[arm].append(1000 * n / ms)
    u, b = np.mean(fps["unbucketed"]), np.mean(fps["bucketed"])
    print(f"[11 stream] 180x320 staged on the card, batch {bs}: unbucketed {u:.1f} frames/s"
          f" ({fps['unbucketed'][0]:.1f}, {fps['unbucketed'][1]:.1f}); bucketed (192x320,"
          f" masked) {b:.1f} ({fps['bucketed'][0]:.1f}, {fps['bucketed'][1]:.1f});"
          f" bucketed/unbucketed {b / u:.3f} ({card}; indicative)", flush=True)


#: each launch counter's op in an exported graph
COUNTER_OPS = {"in_prelu": "instance_norm_prelu", "in_add": "instance_norm_add",
               "s8_stage1": "int8_conv", "s8_phases": "int8_conv_phases",
               "quantize": "quantize_act", "shuffle": "pixel_shuffle_phase_major",
               "upsample": "fused_upsample"}
#: phase 13's artifacts: export_model flags, the form, and the most uint8
#: counts the loaded artifact may differ from the live engine (fp32 is the
#: engine's own program, bitwise expected; bf16 and int8 the JAX script's gate)
EXPORTS = {
    "bf16": (["--shape", "8x180x320", "--shape", "1x540x960"], "lr_tail", 2),
    "fp32": (["--fp32", "--shape", "1x180x320"], "lr_tail", 1),
    "int8": (["--int8", "--shape", "8x180x320"], "int8", 2),
    "canonical": (["--no-lr-tail", "--shape", "1x90x160"], "canonical", 2),
}


def _export_counts(form: str, n_layers: int) -> dict:
    """A loaded artifact's launches a call: n_layers IN+PReLU and n_layers +
    1 IN+add; the int8 tier's stage 1, four-phase launch and quantize; the
    canonical tail's two shuffles."""
    counts = dict.fromkeys(_counters(), 0)
    counts.update({"in_prelu": n_layers, "in_add": n_layers + 1})
    if form == "int8":
        counts.update({"s8_stage1": 1, "s8_phases": 1, "quantize": 1})
    if form == "canonical":
        counts["shuffle"] = 2
    return counts


def _graph_ops(module) -> dict:
    """{op: nodes} of the fast_srgan ops in a loaded program's graph."""
    ops = {}
    for node in module.graph.nodes:
        name = str(node.target)
        if name.startswith("fast_srgan."):
            op = name.split(".")[1]
            ops[op] = ops.get(op, 0) + 1
    return ops


def _ops_of(counts: dict) -> dict:
    return {COUNTER_OPS[k]: v for k, v in counts.items() if v}


def phase_export(params, frames, engine, card: str) -> dict:
    """13a: the export CLI's four artifacts and a fused stage, loaded and
    held to the engine, their op nodes and launches, and frames/s beside
    the engines. Returns the launches of the artifacts' checked calls
    (``total``; ``two_launch``: the 540x960 call's)."""
    import shutil

    from fast_srgan_torch.export import load_exported_dir
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.models.generator import UpSamplingBlock
    from fast_srgan_torch.scripts import export_model
    from fast_srgan_torch.utils.images import save_image_u8

    root = os.path.join(REPO, ".chip_tmp", "export")
    shutil.rmtree(root, ignore_errors=True)
    calib_dir = os.path.join(root, "calib")
    os.makedirs(calib_dir)
    base = [f for f in frames if f.shape[:2] == (180, 320)]
    for i, frame in enumerate(base):  # phase 10's calibration frames, as PNGs
        save_image_u8(os.path.join(calib_dir, f"{i:02d}.png"), frame)
    n_layers = engine.model.n_layers
    rng = np.random.default_rng(13)
    total = dict.fromkeys(_counters(), 0)
    two_launch, calls = None, {}
    for name, (flags, form, tol) in EXPORTS.items():
        out = os.path.join(root, name)
        if form == "int8":
            flags = [*flags, "--calib_dir", calib_dir]
        res = export_model.main(["--checkpoint", CHECKPOINT, "--output", out, *flags])
        art = load_exported_dir(out)
        want = _export_counts(form, n_layers)
        for e in res["manifest"]["entries"]:
            shape = (e["batch"], e["height"], e["width"])
            call = art["forwards"][shape]
            calls[(name, shape)] = call
            x = torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).cuda()
            call(x)  # first use of the shape
            torch.cuda.synchronize()
            _zero_counts()
            y = call(x)
            torch.cuda.synchronize()
            counts = _read_counts()
            ops = _graph_ops(call.module)
            dmax = res["check"][shape]["max_diff"]
            share = res["check"][shape]["share_differ"]
            label = f"{name} {'x'.join(map(str, shape))}"
            print(f"[13 export] {label} ({form}): {e['bytes']} bytes, export"
                  f" {res['export_s'][shape]:.2f} s, load {res['load_s'][shape]:.2f} s; vs live"
                  f" engine max {dmax} count(s) (tol {tol}), {100 * share:.4f}% differ; graph"
                  f" ops {ops}; launches a call {counts} (want {want})", flush=True)
            check(y.dtype == torch.uint8 and tuple(y.shape) == (shape[0], 4 * shape[1],
                                                                 4 * shape[2], 3),
                  f"{label}: bad output {y.dtype} {tuple(y.shape)}")
            check(dmax <= tol, f"{label}: {dmax} counts from the live engine")
            check(ops == _ops_of(want), f"{label}: graph ops {ops} != {_ops_of(want)}")
            check(counts == want, f"{label}: launches {counts} != {want}")
            for k in total:
                total[k] += counts[k]
            if shape == (1, 540, 960):
                two_launch = counts
        if form == "int8":
            scales = res["module"].act_scales

    # one fused upsample stage (training stage 2), bitwise against the eager block
    gen = torch.Generator(device="cuda").manual_seed(13)
    torch.manual_seed(13)
    block = UpSamplingBlock(64, fused=True).to("cuda", torch.bfloat16,
                                               memory_format=torch.channels_last).eval()
    x = torch.randn((24, 64, 48, 48), device="cuda", generator=gen).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    t0 = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(block, (x,))
    program.example_inputs = None  # as export_shape: the file holds no input
    export_s = time.perf_counter() - t0
    path = os.path.join(root, "fused_stage.pt2")
    torch.export.save(program, path)
    t0 = time.perf_counter()
    module = torch.export.load(path).module()
    load_s = time.perf_counter() - t0
    with torch.no_grad():
        want_y = block(x)
    _zero_counts()
    with torch.inference_mode():
        got_y = module(x)
    torch.cuda.synchronize()
    counts = _read_counts()
    want = dict.fromkeys(_counters(), 0)
    want["upsample"] = 1
    ops = _graph_ops(module)
    equal = torch.equal(got_y, want_y)
    print(f"[13 export] fused UpSamplingBlock bf16 [24,64,48,48]: {os.path.getsize(path)} bytes,"
          f" export {export_s:.2f} s, load {load_s:.2f} s; bitwise equal to the eager block"
          f" {equal}; graph ops {ops}; launches a call {counts}", flush=True)
    check(equal, "fused stage artifact differs from the eager block")
    check(ops == _ops_of(want) and counts == want, "fused stage artifact: ops or launches")
    total["upsample"] += counts["upsample"]

    # frames/s at batch 8: the engines of phases 6 and 10 against the
    # artifacts, in turns
    staged = _stage_frames(frames)
    int8_engine = SRInferenceEngine(params, device="cuda", quantize=True,
                                    calib_batches=[np.stack(base)])
    same = all(torch.equal(scales[k], int8_engine.act_scales[k]) for k in scales)
    # the CLI calibrates on the PNGs normalized to [-1, 1] by numpy, the
    # engine on the uint8 frames normalized on the card: not the same bits
    print(f"[13 export] int8 artifact's activation scales equal to a phase-10 engine's:"
          f" {same} ({ {k: round(float(v), 6) for k, v in scales.items()} } against"
          f" { {k: round(float(int8_engine.act_scales[k]), 6) for k in scales} })", flush=True)
    for tier, eng in (("bf16", engine), ("int8", int8_engine)):
        call = calls[(tier, (8, 180, 320))]
        fps = {"engine": [], "artifact": []}
        for arm in ("engine", "artifact", "artifact", "engine"):
            forward = eng.forward_u8 if arm == "engine" else call
            n, ms = _frames_per_s(forward, staged, 8)
            fps[arm].append(1000 * n / ms)
        e, a = np.mean(fps["engine"]), np.mean(fps["artifact"])
        print(f"[13 export] 180x320 -> 720p {tier}, batch 8: engine {e:.1f} frames/s"
              f" ({fps['engine'][0]:.1f}, {fps['engine'][1]:.1f}); artifact {a:.1f}"
              f" ({fps['artifact'][0]:.1f}, {fps['artifact'][1]:.1f}); artifact/engine"
              f" {a / e:.3f} ({card}; indicative)", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return {"total": total, "two_launch": two_launch}


def _host_us(fn, n: int = 400) -> float:
    """Host µs a call of fn(): the enqueue loop between two syncs, timed
    without the final one (the kernels here take less than a launch)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return us


def phase_dispatch(card: str) -> dict:
    """13c: what the torch.library op adds to a kernel call on the card's
    host: the wrappers as the engine calls them (the op, no gradient), the
    autograd.Function around the op (the training path), and each op's
    CUDA implementation called directly (the checks and the launch alone,
    as a wrapper ran them before the ops). Arms in turns, then reversed;
    medians."""
    from fast_srgan_torch.kernels import instance_norm as inm
    from fast_srgan_torch.kernels import quantize as qm

    x = torch.randn((1, 64, 16, 16), device="cuda").to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    alpha = torch.full((1,), 0.2, device="cuda")
    scale = torch.tensor(2.0, device="cuda")
    arms = {
        "in_prelu_op": lambda: inm.instance_norm_prelu(x, alpha),
        "in_prelu_function": lambda: inm.InstanceNormPReLUFunction.apply(x, alpha, None),
        "in_prelu_direct": lambda: inm._prelu_cuda(x, alpha),
        "quantize_op": lambda: qm.quantize_act(x, scale),
        "quantize_direct": lambda: qm._launch(x, scale),
    }
    times = {k: [] for k in arms}
    with torch.no_grad():
        for order in (list(arms), list(reversed(arms))) * 3:
            for k in order:
                times[k].append(_host_us(arms[k]))
    us = {k: float(np.median(v)) for k, v in times.items()}
    print(f"[13 dispatch] host µs a call, bf16 [1,64,16,16], medians of 6: IN+PReLU wrapper"
          f" (op) {us['in_prelu_op']:.2f}, autograd.Function around the op"
          f" {us['in_prelu_function']:.2f}, checks + launch without the op"
          f" {us['in_prelu_direct']:.2f}; quantize wrapper (op) {us['quantize_op']:.2f},"
          f" launch without the op {us['quantize_direct']:.2f} ({card})", flush=True)
    return us


def phase_tools() -> None:
    """13b: evaluate, convert_checkpoint, interp_checkpoints and infer
    --checkpoint on the card, on phase 12's images and step-15 export."""
    import shutil

    from fast_srgan_torch import infer
    from fast_srgan_torch.checkpoints.convert import load_generator_params
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.scripts import convert_checkpoint, evaluate, interp_checkpoints
    from fast_srgan_torch.utils.images import list_image_files, load_image_u8

    trainer_root = os.path.join(REPO, ".chip_tmp", "trainer")
    images = os.path.join(trainer_root, "images")
    pt = os.path.join(trainer_root, "run", "runs", "smoke", "generator_epoch_15.pt")
    root = os.path.join(REPO, ".chip_tmp", "tools")
    shutil.rmtree(root, ignore_errors=True)
    names = list_image_files(images)
    for sub, take in (("eval", names[:4]), ("infer_in", names[:2])):
        os.makedirs(os.path.join(root, sub))
        for n in take:
            shutil.copy(os.path.join(images, n), os.path.join(root, sub, n))

    four = os.path.join(root, "eval")
    card32 = evaluate.main(["--image_dir", four, "--fp32"])
    cpu32 = evaluate.main(["--image_dir", four, "--fp32", "--device", "cpu"])
    bf16 = evaluate.main(["--image_dir", four])
    dpsnr, dssim = abs(card32["psnr"] - cpu32["psnr"]), abs(card32["ssim"] - cpu32["ssim"])
    print(f"[13 tools] evaluate --fp32 on 4 of phase 12's PNGs: card PSNR {card32['psnr']:.4f}"
          f" dB, SSIM {card32['ssim']:.6f}; CPU {cpu32['psnr']:.4f} dB, {cpu32['ssim']:.6f};"
          f" |diff| {dpsnr:.2e} dB (tol 0.01), {dssim:.2e} (tol 1e-4); bf16 on the card"
          f" {bf16['psnr']:.4f} dB, SSIM {bf16['ssim']:.6f}", flush=True)
    check(dpsnr <= 0.01 and dssim <= 1e-4, "evaluate: card fp32 vs CPU fp32")

    pt_out, npz_out = os.path.join(root, "g.pt"), os.path.join(root, "g.npz")
    convert_checkpoint.main([CHECKPOINT, pt_out])
    convert_checkpoint.main([pt_out, npz_out])
    blend = os.path.join(root, "blend.npz")
    interp_checkpoints.main([CHECKPOINT, pt_out, "--alpha", "0.5", "-o", blend])
    with np.load(CHECKPOINT) as a, np.load(npz_out) as b, np.load(blend) as c:
        round_trip = sorted(a.files) == sorted(b.files) and all(
            np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a.files)
        blended = sorted(a.files) == sorted(c.files) and all(
            np.array_equal(a[k], c[k]) for k in a.files)
    print(f"[13 tools] convert_checkpoint npz -> pt -> npz bitwise {round_trip};"
          f" interp_checkpoints of the .npz and its .pt at alpha 0.5 bitwise equal to it"
          f" {blended}", flush=True)
    check(round_trip and blended, "convert_checkpoint / interp_checkpoints not bitwise")

    src, out = os.path.join(root, "infer_in"), os.path.join(root, "infer_out")
    infer.main(["--image_dir", src, "--output_dir", out, "--checkpoint", pt])
    ins = [load_image_u8(os.path.join(src, n)) for n in names[:2]]
    want = SRInferenceEngine(load_generator_params(pt), device="cuda").upscale_images(ins)
    got = [load_image_u8(os.path.join(out, n)) for n in names[:2]]
    equal = all(g.shape == (4 * i.shape[0], 4 * i.shape[1], 3) and np.array_equal(g, w)
                for g, w, i in zip(got, want, ins))
    print(f"[13 tools] infer --checkpoint {os.path.relpath(pt, REPO)} on 2 images:"
          f" {[g.shape for g in got]}, equal to an engine built from the same .pt {equal}",
          flush=True)
    check(equal, "infer --checkpoint .pt differs from the engine")
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(trainer_root, ignore_errors=True)


# --- phase 14: width-sharded serving ----------------------------------------

#: the 4K frame (540x960 LR) and the shards it is cut into on the one card
TILE_FRAME = (540, 960)
TILE_SHARDS = 4
SPLIT_REPLACES = "fast_srgan_tpu/parallel/spatial.py:241"
HALO_REPLACES = "fast_srgan_tpu/parallel/spatial.py:427"


def _tile_mesh(rows: int = 0):
    """TILE_SHARDS shards of cuda:0 on an "sp" axis; with rows, a 2-D
    ("data", "sp") grid of it."""
    from fast_srgan_torch.parallel.mesh import Mesh

    dev = torch.device("cuda", 0)
    if rows:
        return Mesh([[dev] * (TILE_SHARDS // rows)] * rows, ("data", "sp"))
    return Mesh([dev] * TILE_SHARDS, ("sp",))


def phase_split_in(card: str) -> dict:
    """14a: the split form of the IN family on a 540x960 frame cut into 4
    width shards of [1,64,540,240]: each shard's statistics kernel against
    the plain sums, each normalize kernel against its plain version on the
    same joined partials and the whole frame's plain norm; every shard's
    statistics bitwise the same (shard 0 normalized with each shard's copy
    of the joined partials). Timed a shard. Returns the three ops' rows."""
    from fast_srgan_torch.kernels.instance_norm import (
        instance_norm_add_from_stats,
        instance_norm_add_from_stats_reference,
        instance_norm_add_reference,
        instance_norm_prelu_from_stats,
        instance_norm_prelu_from_stats_reference,
        instance_norm_prelu_reference,
        instance_norm_stats,
        instance_norm_stats_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    alpha = torch.tensor([0.173], device=dev)
    h, w = TILE_FRAME
    count = h * w
    rows = {"instance_norm_stats": {}, "instance_norm_prelu_from_stats": {},
            "instance_norm_add_from_stats": {}}
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        shape = (1, 64, h, w)
        scale = torch.rand((1, 64, 1, 1), device=dev, generator=gen) * 1.5 + 0.5
        shift = torch.rand((1, 64, 1, 1), device=dev, generator=gen) * 4 - 2
        frame = ((torch.rand(shape, device=dev, generator=gen) * 2 - 1) * scale + shift)
        frame = frame.to(dtype).contiguous(memory_format=torch.channels_last)
        skip = (torch.rand(shape, device=dev, generator=gen) * 2 - 1).to(dtype)
        skip = skip.contiguous(memory_format=torch.channels_last)
        xs = [t.contiguous(memory_format=torch.channels_last) for t in frame.chunk(TILE_SHARDS, 3)]
        ss = [t.contiguous(memory_format=torch.channels_last) for t in skip.chunk(TILE_SHARDS, 3)]
        parts = [instance_norm_stats(x) for x in xs]
        plain_parts = [instance_norm_stats_reference(x) for x in xs]
        stats_err = max((p - q).abs().max().item() for p, q in zip(parts, plain_parts))
        stats_rel = stats_err / max(q.abs().max().item() for q in plain_parts)
        joined = [torch.cat([p.clone() for p in parts], dim=1) for _ in xs]  # a copy a shard
        pre = [instance_norm_prelu_from_stats(x, alpha, j, count) for x, j in zip(xs, joined)]
        add = [instance_norm_add_from_stats(x, k, j, count) for x, k, j in zip(xs, ss, joined)]
        torch.cuda.synchronize()
        err_pre = max((a.float() - instance_norm_prelu_from_stats_reference(x, alpha, j, count)
                       .float()).abs().max().item() for a, x, j in zip(pre, xs, joined))
        err_add = max((a.float() - instance_norm_add_from_stats_reference(x, k, j, count)
                       .float()).abs().max().item() for a, x, k, j in zip(add, xs, ss, joined))
        whole_pre = (torch.cat(pre, 3).float()
                     - instance_norm_prelu_reference(frame, alpha).float()).abs().max().item()
        whole_add = (torch.cat(add, 3).float()
                     - instance_norm_add_reference(frame, skip).float()).abs().max().item()
        same = all(torch.equal(instance_norm_prelu_from_stats(xs[0], alpha, j, count), pre[0])
                   and torch.equal(instance_norm_add_from_stats(xs[0], ss[0], j, count), add[0])
                   for j in joined)
        tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        add_tol = ADD_BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        line = (f"[14 kernel] split IN {name}, {TILE_SHARDS} shards of {[1, 64, h, w // TILE_SHARDS]}"
                f" ({parts[0].shape[1]} partials a shard): stats max_abs_err {stats_err:.3e}"
                f" (rel {stats_rel:.2e}, tol 1e-5); IN+PReLU {err_pre:.3e} (tol {tol:g}), whole"
                f" frame {whole_pre:.3e}; IN+add {err_add:.3e} (tol {add_tol:g}), whole frame"
                f" {whole_add:.3e}; statistics bitwise equal on every shard {same}")
        if dtype == torch.bfloat16:
            x0, k0, j0 = xs[0], ss[0], joined[0]
            xb = x0.numel() * x0.element_size()
            jb = j0.numel() * 4
            timed = {
                "instance_norm_stats": (
                    lambda: instance_norm_stats(x0), lambda: instance_norm_stats_reference(x0),
                    bound(xb + parts[0].numel() * 4, 3 * x0.numel(), FP32_FLOPS), stats_err),
                "instance_norm_prelu_from_stats": (
                    lambda: instance_norm_prelu_from_stats(x0, alpha, j0, count),
                    lambda: instance_norm_prelu_from_stats_reference(x0, alpha, j0, count),
                    bound(2 * xb + jb, 4 * x0.numel(), FP32_FLOPS), err_pre),
                "instance_norm_add_from_stats": (
                    lambda: instance_norm_add_from_stats(x0, k0, j0, count),
                    lambda: instance_norm_add_from_stats_reference(x0, k0, j0, count),
                    bound(3 * xb + jb, 4 * x0.numel(), FP32_FLOPS), err_add),
            }
            for op, (kernel, plain, bnd, err) in timed.items():
                ms, plain_ms = _timed_pair(kernel, plain)
                rows[op].update({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 "library_ms": None, **bnd,
                                 "shape": [1, 64, h, w // TILE_SHARDS]})
                line += (f"; {op} {ms:.4f} ms, {100 * bnd['bound_ms'] / ms:.1f}% of its"
                         f" {bnd['bound_ms']:.4f} ms bound ({bnd['bound_by']}), plain"
                         f" {plain_ms:.4f} ms")
            line += f" ({card})"
        print(line, flush=True)
        check(stats_rel <= 1e-5, f"split IN {name}: statistics off by {stats_rel:.2e}")
        check(err_pre <= tol and whole_pre <= tol, f"split IN+PReLU {name}: {err_pre}, {whole_pre}")
        check(err_add <= add_tol and whole_add <= add_tol,
              f"split IN+add {name}: {err_add}, {whole_add}")
        check(same, f"split IN {name}: the shards' statistics differ")
    return rows


def phase_halo_kernels(card: str) -> dict:
    """14b: the s8 conv's halo form, bitwise against its plain version, at
    the sharded 4K path's shapes (a [1,Cin,540,242] halo-extended shard):
    stage 1 with stage 2's quantize and without, a 64-channel trunk conv,
    and the four phases in one launch; stage 1 + quantize and the phases
    timed in bf16. Returns the kernels line's row."""
    from fast_srgan_torch.kernels.int8_conv import (
        int8_conv,
        int8_conv_phases,
        int8_conv_phases_reference,
        int8_conv_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    h, w = TILE_FRAME[0], TILE_FRAME[1] // TILE_SHARDS + 2
    s_next = torch.tensor(5.1, device=dev)
    row = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        for label, cin, cout, fused in (("stage 1 + quantize", 64, 256, True),
                                        ("stage 1", 64, 256, False), ("trunk", 64, 64, True)):
            xq, weight, ws, s, bias, alpha = _int8_conv_args(gen, 1, cin, h, w, 3, dtype, cout)
            args = (xq, weight, ws, s, (1, 0, 0), bias, alpha, dtype, s_next if fused else None)
            got = int8_conv(*args)
            want = int8_conv_reference(*args)
            torch.cuda.synchronize()
            equal = torch.equal(got, want) and got.shape[3] == w - 2
            print(f"[14 kernel] int8 conv halo form {label} {name} [1,{cin},{h},{w}] -> {cout},"
                  f" 3x3 pad (1, 0, 0): bitwise equal {equal}", flush=True)
            check(equal, f"int8 halo {label} {name} differs from its plain version")
            if label == "stage 1 + quantize" and dtype == torch.bfloat16:
                ops = 2 * h * (w - 2) * cin * 9 * cout
                nbytes = xq.numel() + weight.packed.numel() + got.numel()
                ms, plain_ms = _timed_pair(lambda: int8_conv(*args),
                                           lambda: int8_conv_reference(*args), 20, 3)
                bnd = bound(nbytes, ops, INT8_OPS)
                row.update({"stage1_quantize_ms": ms, "stage1_quantize_plain_ms": plain_ms,
                            "stage1_quantize_bound_ms": bnd["bound_ms"]})
                print(f"[14 time] int8 conv halo stage 1 + quantize bf16: "
                      + _rate("kernel", ms, ops, bnd) + f"; plain (float64) {plain_ms:.4f} ms"
                      f" ({card})", flush=True)
        args = _int8_phases_args(gen, 1, 256, h, w, dtype)
        got = int8_conv_phases(*args, padding=(0, 0))
        want = int8_conv_phases_reference(*args, padding=(0, 0))
        torch.cuda.synchronize()
        equal = all(torch.equal(a, c) and a.shape[3] == w - 2 for a, c in zip(got, want))
        print(f"[14 kernel] int8 conv four phases halo form {name} [1,256,{h},{w}] -> 4 x 256,"
              f" padding (0, 0): bitwise equal {equal}", flush=True)
        check(equal, f"int8 halo phases {name} differ from their plain version")
        if dtype == torch.bfloat16:
            ops = 4 * 2 * h * (w - 2) * 256 * 4 * 256
            nbytes = (args[0].numel() + args[1].tiled.numel()
                      + sum(a.numel() * a.element_size() for a in got))
            ms, plain_ms = _timed_pair(lambda: int8_conv_phases(*args, padding=(0, 0)),
                                       lambda: int8_conv_phases_reference(*args, padding=(0, 0)),
                                       20, 2)
            bnd = bound(nbytes, ops, INT8_OPS)
            row.update({"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **bnd,
                        "library_ms": None, "shape": [1, 256, h, w]})
            print(f"[14 time] int8 conv four phases halo form bf16: "
                  + _rate("kernel", ms, ops, bnd) + f"; plain (float64) {plain_ms:.4f} ms"
                  f" ({card})", flush=True)
    return row


def _split_counts(forwards: int, n_layers: int, shards: int, int8: bool = False) -> dict:
    """A width-sharded 4x forward's launches: every norm's statistics on
    each shard, n_layers IN+PReLU and n_layers + 1 IN+add a shard in the
    split form, no other IN; int8 ups adds a shard's stage 1 (with stage
    2's quantize) and four phases, both in the halo form, and the quantize
    of stage 1's input."""
    counts = dict.fromkeys(_counters(), 0)
    k = forwards * shards
    counts.update({"in_stats": (2 * n_layers + 1) * k, "in_prelu_split": n_layers * k,
                   "in_add_split": (n_layers + 1) * k})
    if int8:
        counts.update({"s8_halo": k, "s8_phases_halo": k, "quantize": k})
    return counts


def _nchw_input(frames_u8: np.ndarray) -> torch.Tensor:
    x = torch.from_numpy(np.ascontiguousarray(frames_u8)).cuda()
    return x.permute(0, 3, 1, 2).to(torch.float32) / 127.5 - 1.0


def _u8_out(y: torch.Tensor) -> np.ndarray:
    return ((y + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()


def phase_tiled(params, frames, card: str) -> dict:
    """14c: the width-sharded forward of a 4K frame (540x960 -> 2160x3840),
    the pretrained 4x generator on 4 shards of the card: bf16 is the main
    path (counts zeroed before, read after), then fp32 against the
    one-device fp32 engine, int8 ups in fp32 and bf16 glue; ms a 4K frame
    sharded against one device, in turns. Returns the main path's counts,
    the int8 run's, and the times."""
    from fast_srgan_torch import quant
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.parallel.spatial import build_tiled_forward, build_tiled_quant_forward

    mesh = _tile_mesh()
    frame = make_frame(np.random.default_rng(14), *TILE_FRAME)
    x = _nchw_input(frame[None])
    one32 = SRInferenceEngine(params, device="cuda", dtype=torch.float32)
    one16 = SRInferenceEngine(params, device="cuda", dtype=torch.bfloat16)
    ref32 = one32.upscale_batch(frame[None])[0]
    ref16 = one16.upscale_batch(frame[None])[0]
    n_layers = one16.model.n_layers

    tiled16 = build_tiled_forward(mesh, dtype=torch.bfloat16)
    tiled16(params, x)  # first call: weights on the card, cuDNN's choices
    torch.cuda.synchronize()
    _zero_counts()
    y16 = tiled16(params, x)
    torch.cuda.synchronize()
    counts = _read_counts()
    want = _split_counts(1, n_layers, TILE_SHARDS)
    got16 = _u8_out(y16)[0]
    check(got16.shape == (4 * TILE_FRAME[0], 4 * TILE_FRAME[1], 3), "tiled 4K output shape")
    mx16, _, _ = _u8_compare(got16, ref16)
    db16 = psnr(got16, ref32)
    print(f"[14 tiled] 4K bf16, {TILE_SHARDS} shards of cuda:0: PSNR {db16:.2f} dB against the"
          f" one-device fp32 engine (floor {PSNR_MIN_DB}); max {mx16} count(s) from the"
          f" one-device bf16 engine; launches {counts} (want {want})", flush=True)
    check(db16 >= PSNR_MIN_DB, f"tiled bf16 PSNR {db16:.2f}")
    check(counts == want, "tiled bf16 launch count mismatch")

    got32 = _u8_out(build_tiled_forward(mesh, dtype=torch.float32)(params, x))[0]
    mx32, frac32, _ = _u8_compare(got32, ref32)
    print(f"[14 tiled] 4K fp32 (TF32 off): max {mx32} count(s) from the one-device fp32 engine,"
          f" {100 * np.mean(got32 == ref32):.4f}% equal", flush=True)
    check(mx32 <= 1, f"tiled fp32: {mx32} counts from the one-device engine")

    calib = np.stack([f for f in frames if f.shape[:2] == (180, 320)])
    q32 = SRInferenceEngine(params, device="cuda", dtype=torch.float32, quantize=True,
                            calib_batches=[calib])
    refq = q32.upscale_batch(frame[None])[0]
    forward = build_tiled_quant_forward(mesh, glue_dtype=torch.float32)
    forward(params, q32.act_scales, x)
    torch.cuda.synchronize()
    _zero_counts()
    yq = forward(params, q32.act_scales, x)
    torch.cuda.synchronize()
    q_counts = _read_counts()
    q_want = _split_counts(1, n_layers, TILE_SHARDS, int8=True)
    mxq, fracq, _ = _u8_compare(_u8_out(yq)[0], refq)
    print(f"[14 tiled] 4K int8 ups, fp32 glue: max {mxq} count(s) from the one-device int8"
          f" engine on the same scales, >1: {100 * fracq:.4f}% (share bar < 2%);"
          f" launches {q_counts} (want {q_want})", flush=True)
    check(q_counts == q_want, "tiled int8 launch count mismatch")
    # End to end the sharded fp32 trunk differs from the one-device one by
    # reassociation (cuDNN takes other algorithms for a 242-wide shard than
    # for the 960-wide frame), and a value on a rounding boundary of stage
    # 1's input quantizes one step apart: rare pixels move by more than the
    # contract's 3 counts, as phase 11c's bucketed trunk does. So end to
    # end the run is held to the contract's share, and the sharding of the
    # int8 tail itself exactly: the sharded tail (halo-form s8 launches) on
    # the one-device trunk output against the one-device tail, within 1
    # count (the int8 convs are exact; only the float head reassociates).
    from fast_srgan_torch.kernels.quantize import quantize_act
    from fast_srgan_torch.parallel import spatial

    model, _ = forward.replicas(params)[mesh.devices[0]]
    lays = [forward.replicas(params)[mesh.devices[0]][1].layers] * TILE_SHARDS
    scales = q32.act_scales
    with torch.inference_mode(), _no_tf32():
        y1 = q32._plan.trunk(x)
        xs = [t.contiguous(memory_format=torch.channels_last) for t in x.chunk(TILE_SHARDS, 3)]
        y4 = torch.cat(spatial.generator_forward(
            [model] * TILE_SHARDS, xs, spatial.halo_conv, spatial.dist_norm_prelu,
            spatial.dist_norm_add, lambda v: v), dim=3)
        flips = int((quantize_act(y1, scales["up0"]) != quantize_act(
            y4.contiguous(memory_format=torch.channels_last), scales["up0"])).sum())
        trunk_err = (y1 - y4).abs().max().item()
        ex = quant._Exec(scales, None, torch.float32)
        shards = [t.contiguous(memory_format=torch.channels_last) for t in y1.chunk(TILE_SHARDS, 3)]
        tail4 = torch.cat(spatial._q_tail_4x([ex] * TILE_SHARDS, lays, shards), dim=3)
        tail1 = quant._tail_4x(q32._plan.layers, ex, y1)
    tail_mx, _, _ = _u8_compare(_u8_out(tail4)[0], _u8_out(tail1)[0])
    print(f"[14 tiled] 4K int8 ups, fp32 glue: trunk sharded vs one device max_abs"
          f" {trunk_err:.3e}, {flips} of {y1.numel()} int8 values of stage 1's input one step"
          f" apart; the sharded int8 tail on the one-device trunk output: max {tail_mx}"
          f" count(s) from the one-device tail", flush=True)
    check(fracq < 0.02, "tiled int8 fp32 glue: over 2% of values off by more than 1")
    check(tail_mx <= 1, f"sharded int8 tail: {tail_mx} counts")
    gotq16 = _u8_out(build_tiled_quant_forward(mesh, glue_dtype=torch.bfloat16)(
        params, q32.act_scales, x))[0]
    dbq = psnr(gotq16, ref32)
    print(f"[14 tiled] 4K int8 ups, bf16 glue: PSNR {dbq:.2f} dB against the one-device fp32"
          f" engine (floor {min(INT8_PSNR_MIN_DB.values())})", flush=True)
    check(dbq >= min(INT8_PSNR_MIN_DB.values()), f"tiled int8 bf16 PSNR {dbq:.2f}")

    # ms a 4K frame, bf16, the float forward alone: one device, sharded, in turns
    arms = {"one device": lambda: one16._apply(x), "sharded": lambda: tiled16(params, x)}
    ms = {k: [] for k in arms}
    with torch.inference_mode():
        for k in ("one device", "sharded", "sharded", "one device"):
            ms[k].append(events_ms(arms[k], 10))
    one_ms, tiled_ms = np.mean(ms["one device"]), np.mean(ms["sharded"])
    print(f"[14 time] 4K bf16 forward: {TILE_SHARDS} shards of one card {tiled_ms:.2f} ms a frame"
          f" ({ms['sharded'][0]:.2f}, {ms['sharded'][1]:.2f}), one device {one_ms:.2f} ms"
          f" ({ms['one device'][0]:.2f}, {ms['one device'][1]:.2f}); sharded/one device"
          f" {tiled_ms / one_ms:.3f} (the halos' and split norms' cost on one card, not a"
          f" scaling number; {card}; indicative)", flush=True)
    return {"counts": counts, "int8_counts": q_counts, "tiled_ms": tiled_ms, "one_ms": one_ms}


def _random_params(scale: int, seed: int, n_layers: int = 2) -> dict:
    """A 64-filter generator param tree of the given scale and depth, with
    torch's default init from a seed."""
    from fast_srgan_torch.checkpoints.convert import params_from_state_dict
    from fast_srgan_torch.models.generator import Generator

    torch.manual_seed(seed)
    return params_from_state_dict(Generator(64, n_layers, scale).state_dict())


def phase_tiled_meshes(params, frames) -> None:
    """14d: a 2-D ("data", "sp") mesh of 2 x 2 at batch 2 of 180x320, the
    canonical tail, and 2x and 8x generators at depth 2, each against its
    one-device forward in fp32: at most 1 count."""
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.parallel.spatial import build_tiled_forward

    batch = np.stack([f for f in frames if f.shape[:2] == (180, 320)][:2])
    x = _nchw_input(batch)
    cases = [("2-D mesh 2x2, 4x pretrained, batch 2", params, _tile_mesh(rows=2), True),
             ("canonical tail, 4x pretrained", params, _tile_mesh(), False),
             ("2x, depth 2", _random_params(2, 21), _tile_mesh(), True),
             ("8x, depth 2", _random_params(8, 22), _tile_mesh(), True)]
    for label, p, mesh, lr_tail in cases:
        want = SRInferenceEngine(p, device="cuda", dtype=torch.float32,
                                 lr_tail=lr_tail).upscale_batch(batch)
        got = _u8_out(build_tiled_forward(mesh, dtype=torch.float32, lr_tail=lr_tail)(p, x))
        mx, _, _ = _u8_compare(got, want)
        print(f"[14 tiled] {label}, fp32, {list(batch.shape)} -> {list(got.shape)}: max {mx}"
              f" count(s) from its one-device fp32 forward", flush=True)
        check(got.shape == want.shape and mx <= 1, f"tiled {label}: {mx} counts")


def phase_mesh_engine(params, frames) -> None:
    """14e: the data-parallel engine on [cuda:0, cuda:0] at batch 8 of
    180x320 (slices of 4): bitwise equal to the one-device engine on the
    same slices, and within 1 count of it at batch 8; fp32, bf16, int8."""
    from fast_srgan_torch.inference import SRInferenceEngine

    batch = np.stack([f for f in frames if f.shape[:2] == (180, 320)][:8])
    for label, kw in (("fp32", {"dtype": torch.float32}), ("bf16", {}),
                      ("int8 ups", {"quantize": True, "calib_batches": [batch]})):
        one = SRInferenceEngine(params, device="cuda", **kw)
        if "quantize" in kw:
            kw = {"quantize": True, "act_scales": one.act_scales}
        two = SRInferenceEngine(params, mesh=["cuda:0", "cuda:0"], **kw)
        eff = two.effective_batch_size(180, 320, 8)
        got = two.upscale_batch(batch)
        sliced = np.concatenate([one.upscale_batch(batch[:4]), one.upscale_batch(batch[4:])])
        whole = one.upscale_batch(batch)
        mx, frac, _ = _u8_compare(got, whole)
        exact = np.array_equal(got, sliced)
        print(f"[14 mesh engine] {label}, mesh [cuda:0, cuda:0], batch {eff} of 180x320: bitwise"
              f" equal to one device on the same slices {exact}; max {mx} count(s) from one"
              f" device at batch 8, >1: {100 * frac:.4f}%", flush=True)
        check(eff == 8 and exact, f"mesh engine {label} differs from its slices")
        check(mx <= 1, f"mesh engine {label}: {mx} counts from one device at batch 8")


def phase_infer_tile(params, frames) -> None:
    """14f: ``python -m fast_srgan_torch.infer --tile 1`` (fp32, and int8
    ups in fp32 glue) in-process on two PNGs, against the one-device
    engine on the same calibration: fp32 within 1 count, int8 in the
    bounded-flip contract."""
    import shutil

    from PIL import Image

    from fast_srgan_torch import infer, quant
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.utils.images import load_image_u8

    root = os.path.join(REPO, ".chip_tmp", "tile")
    shutil.rmtree(root, ignore_errors=True)
    src = os.path.join(root, "in")
    os.makedirs(src)
    images = [f for f in frames if f.shape[:2] == (180, 320)][:2]
    for i, im in enumerate(images):
        Image.fromarray(im).save(os.path.join(src, f"f{i}.png"))
    for int8 in (False, True):
        out = os.path.join(root, "int8" if int8 else "fp32")
        infer.main(["--image_dir", src, "--output_dir", out, "--checkpoint", CHECKPOINT,
                    "--tile", "1", "--fp32"] + (["--int8"] if int8 else []))
        calib = [quant.calibration_batch_from_images(images)] if int8 else None
        want = SRInferenceEngine(params, device="cuda", dtype=torch.float32, quantize=int8,
                                 calib_batches=calib).upscale_images(images)
        got = [load_image_u8(os.path.join(out, f"f{i}.png")) for i in range(len(images))]
        stats = [_u8_compare(g, w) for g, w in zip(got, want)]
        mx, frac = max(s[0] for s in stats), max(s[1] for s in stats)
        label = "--tile 1 --int8 --fp32" if int8 else "--tile 1 --fp32"
        print(f"[14 infer] {label} on 2 PNGs of 180x320: {[g.shape for g in got]}; max {mx}"
              f" count(s) from the one-device engine, >1: {100 * frac:.4f}%", flush=True)
        check(mx <= (3 if int8 else 1) and frac < 0.02, f"infer {label}: {mx} counts")
    shutil.rmtree(root, ignore_errors=True)


def main() -> None:
    kind, card = phase_device()
    phase_build()
    in_rows = phase_kernel()
    up_row = phase_upsample_kernel(card)
    shuffle_row, stage_ms = phase_shuffle_kernel()

    from fast_srgan_torch.checkpoints.npz_io import load_npz_params

    params = load_npz_params(CHECKPOINT)
    rng = np.random.default_rng(0)
    frames = [make_frame(rng, 180, 320) for _ in range(8)]
    frames += [make_frame(rng, 90, 160) for _ in range(4)]
    order = rng.permutation(len(frames))
    frames = [frames[i] for i in order]

    engine, replies, launches = phase_serving(params, frames)
    phase_fidelity(params, frames, replies)
    staged_fps = phase_throughput(engine, frames, card)
    conv_row, quant_row = phase_int8_kernels(card)
    int8_launches = phase_int8_engine(params, frames)
    phase_int8_throughput(params, frames, card)
    masked_rows = phase_masked_kernel(card)
    bucketed = phase_bucketed_engine(params)
    phase_masked_int8(params, frames)
    phase_stream(params, frames, staged_fps, card)
    split_rows = phase_split_in(card)
    halo_row = phase_halo_kernels(card)
    tiled = phase_tiled(params, frames, card)
    phase_tiled_meshes(params, frames)
    phase_mesh_engine(params, frames)
    phase_infer_tile(params, frames)
    fused, unfused, bare_ms = phase_training(card)
    trainer = phase_trainer(card, bare_ms)
    exported = phase_export(params, frames, engine, card)
    phase_dispatch(card)
    phase_tools()
    art = exported["total"]

    check("jax" not in sys.modules, "jax was imported")
    check(
        not any(m.startswith("fast_srgan_tpu") for m in sys.modules),
        "the JAX package was imported",
    )
    # launches: IN+PReLU and IN+add from the serving path (phase 4), the s8
    # conv (stage 1 and the four-phase launch) and the quantize from the int8
    # engine (phase 10), the fused upsample from the fused training arm, the
    # shuffle from the unfused arm (phase 9), the masked IN forms from the
    # bucketed server path (phase 11); trainer_launches are phase 12's
    # trainer run (training, validation and panels); artifact_launches are
    # phase 13's checked calls of the loaded artifacts (the IN rows'
    # two_launch_artifact_launches the 540x960 artifact's one call). The IN
    # rows' times are the serving shape's (resident form), two_launch_* the
    # 540x960 frame's; the s8 conv's are the four-phase launch's. library_ms
    # is null where no one PyTorch call computes the kernel's function
    # (f_instance_norm_ms and cudnn_bf16_ms are yardsticks only). op is the
    # torch.library op each wrapper calls. The split IN rows' launches are
    # phase 14's bf16 4K tiled forward (int8_launches its int8 one), the s8
    # halo form's the int8 one; their times are a shard's
    two = exported["two_launch"]
    split = tiled["counts"]
    split_q = tiled["int8_counts"]
    print(f"[14 tiled] 4K bf16 ms a frame: {TILE_SHARDS} shards of one card {tiled['tiled_ms']:.2f},"
          f" one device {tiled['one_ms']:.2f}; split-form launches {split}; int8 {split_q}",
          flush=True)
    print(json.dumps({"kernels": [
        {"name": "instance_norm_prelu", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": KERNEL_REPLACES, "op": "torch.ops.fast_srgan.instance_norm_prelu",
         "launches": launches[0], "trainer_launches": trainer["in_prelu"],
         "artifact_launches": art["in_prelu"], "two_launch_artifact_launches": two["in_prelu"],
         **in_rows["instance_norm_prelu"]},
        {"name": "instance_norm_add", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": ADD_REPLACES, "op": "torch.ops.fast_srgan.instance_norm_add",
         "launches": launches[1], "trainer_launches": trainer["in_add"],
         "artifact_launches": art["in_add"], "two_launch_artifact_launches": two["in_add"],
         **in_rows["instance_norm_add"]},
        {"name": "fused_upsample", "route": "cuda", "source": UPSAMPLE_SOURCE,
         "replaces": UPSAMPLE_REPLACES, "op": "torch.ops.fast_srgan.fused_upsample",
         "launches": fused[2], "backward_launches": fused[4],
         "trainer_launches": trainer["upsample"],
         "trainer_backward_launches": trainer["upsample_backward"],
         "artifact_launches": art["upsample"],
         **up_row, "stage_ms": stage_ms["train stage 2"]},
        {"name": "pixel_shuffle_phase_major", "route": "cuda",
         "source": SHUFFLE_SOURCE, "replaces": SHUFFLE_REPLACES,
         "op": "torch.ops.fast_srgan.pixel_shuffle_phase_major",
         "launches": unfused[3], "artifact_launches": art["shuffle"], **shuffle_row},
        {"name": "int8_conv", "route": "cuda", "source": INT8_CONV_SOURCE,
         "replaces": INT8_CONV_REPLACES,
         "op": "torch.ops.fast_srgan.int8_conv, torch.ops.fast_srgan.int8_conv_phases",
         "launches": int8_launches[0] + int8_launches[1],
         "launches_stage1": int8_launches[0], "launches_phases": int8_launches[1],
         "artifact_launches": art["s8_stage1"] + art["s8_phases"], **conv_row},
        {"name": "quantize_act", "route": "cuda", "source": QUANTIZE_SOURCE,
         "replaces": QUANTIZE_REPLACES, "op": "torch.ops.fast_srgan.quantize_act",
         "launches": int8_launches[2], "artifact_launches": art["quantize"], **quant_row},
        {"name": "instance_norm_prelu_masked", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": MASKED_REPLACES, "op": "torch.ops.fast_srgan.instance_norm_prelu",
         "launches": bucketed["in_prelu_masked"], **masked_rows["instance_norm_prelu_masked"]},
        {"name": "instance_norm_add_masked", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": MASKED_REPLACES, "op": "torch.ops.fast_srgan.instance_norm_add",
         "launches": bucketed["in_add_masked"], **masked_rows["instance_norm_add_masked"]},
        {"name": "instance_norm_stats", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": SPLIT_REPLACES, "op": "torch.ops.fast_srgan.instance_norm_stats",
         "launches": split["in_stats"], "int8_launches": split_q["in_stats"],
         **split_rows["instance_norm_stats"]},
        {"name": "instance_norm_prelu_from_stats", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": SPLIT_REPLACES,
         "op": "torch.ops.fast_srgan.instance_norm_prelu_from_stats",
         "launches": split["in_prelu_split"], "int8_launches": split_q["in_prelu_split"],
         **split_rows["instance_norm_prelu_from_stats"]},
        {"name": "instance_norm_add_from_stats", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": SPLIT_REPLACES, "op": "torch.ops.fast_srgan.instance_norm_add_from_stats",
         "launches": split["in_add_split"], "int8_launches": split_q["in_add_split"],
         **split_rows["instance_norm_add_from_stats"]},
        {"name": "int8_conv_halo", "route": "cuda", "source": INT8_CONV_SOURCE,
         "replaces": HALO_REPLACES,
         "op": "torch.ops.fast_srgan.int8_conv (padding (1, 0, 0)),"
               " torch.ops.fast_srgan.int8_conv_phases (padding (0, 0))",
         "launches": split_q["s8_halo"] + split_q["s8_phases_halo"],
         "launches_stage1": split_q["s8_halo"], "launches_phases": split_q["s8_phases_halo"],
         **halo_row},
    ]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
